"""Snappy compression — block format (gossip) and framed format (req/resp).

The reference's wire stack compresses gossip payloads with raw-block snappy
and req/resp chunks with framed snappy (rpc/codec/, `ssz_snappy`;
Cargo.toml:104 pulls the `snap` crate).  No snappy library ships in this
image, so this is a from-scratch implementation of the public format spec:

* decompress: full tag support (literals, 1/2/4-byte-offset copies).
* compress: greedy hash-table matcher emitting literals + copy tags —
  real compression (SSZ states/blocks are highly repetitive), not just
  literal passthrough.
* framed format: stream identifier, compressed/uncompressed chunks with
  masked CRC32-C (the Castagnoli polynomial, implemented here too).

Interops with any spec-conforming snappy (round-trip tested both ways in
tests/test_network.py — including against reference-format fixtures built
from the format spec's worked examples).
"""

from __future__ import annotations

import struct

MAX_BLOCK = 65536  # framed-format max uncompressed chunk


class SnappyError(ValueError):
    pass


# ---------------------------------------------------------------------------
# varint
# ---------------------------------------------------------------------------


def _write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise SnappyError("varint overflow")


# ---------------------------------------------------------------------------
# block format
# ---------------------------------------------------------------------------


def compress_block(data: bytes) -> bytes:
    """Greedy hash-match compressor (4-byte matches, 64KB window)."""
    out = bytearray(_write_uvarint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[int, int] = {}
    i = 0
    lit_start = 0

    def emit_literal(start: int, end: int):
        length = end - start
        while length > 0:
            run = min(length, 60)  # keep the 1-byte tag form for simplicity
            if run < 60:
                out.append((run - 1) << 2)
            else:
                out.append(60 << 2)
                out.append(run - 1)
            out.extend(data[start : start + run])
            start += run
            length -= run

    def emit_copy(offset: int, length: int):
        while length > 0:
            if 4 <= length <= 11 and offset < 2048:
                out.append(
                    0b01 | ((length - 4) << 2) | ((offset >> 8) << 5)
                )
                out.append(offset & 0xFF)
                length = 0
            else:
                run = min(length, 64)
                if run < 4:  # too short for a copy tag: emit as literal
                    break
                out.append(0b10 | ((run - 1) << 2))
                out.extend(struct.pack("<H", offset))
                length -= run
        return length

    while i + 4 <= n:
        key = int.from_bytes(data[i : i + 4], "little")
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand : cand + 4] == data[i : i + 4]:
            # extend the match
            m = 4
            while i + m < n and data[cand + m] == data[i + m] and m < 64:
                m += 1
            emit_literal(lit_start, i)
            left = emit_copy(i - cand, m)
            i += m - left
            lit_start = i
        else:
            i += 1
    emit_literal(lit_start, n)
    return bytes(out)


def decompress_block(data: bytes) -> bytes:
    want, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0b00:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 0b01:  # copy, 1-byte offset
            length = ((tag >> 2) & 0b111) + 4
            if pos >= n:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 0b10:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy2")
            offset = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy4")
            offset = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("invalid copy offset")
        for _ in range(length):  # may overlap: byte-by-byte
            out.append(out[-offset])
    if len(out) != want:
        raise SnappyError(f"length mismatch: header {want}, got {len(out)}")
    return bytes(out)


# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli), masked per the framing spec
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# framed format
# ---------------------------------------------------------------------------

STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"


def compress_framed(data: bytes) -> bytes:
    out = bytearray(STREAM_IDENTIFIER)
    for i in range(0, max(len(data), 1), MAX_BLOCK):
        chunk = data[i : i + MAX_BLOCK]
        crc = _masked_crc(chunk)
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            body = struct.pack("<I", crc) + comp
            out += b"\x00" + struct.pack("<I", len(body))[:3] + body
        else:
            body = struct.pack("<I", crc) + chunk
            out += b"\x01" + struct.pack("<I", len(body))[:3] + body
    return bytes(out)


def decompress_framed_prefix(data: bytes, want: int) -> tuple[bytes, int]:
    """Decompress until ``want`` output bytes, returning (output, bytes
    CONSUMED from data) — the incremental reader for back-to-back
    ssz_snappy response chunks sharing one stream."""
    pos, out = 0, bytearray()
    seen_header = False
    data_frames = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise SnappyError("truncated chunk header")
        ctype = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + length]
        if len(body) != length:
            raise SnappyError("truncated chunk body")
        pos += 4 + length
        if ctype == 0xFF:
            if body != STREAM_IDENTIFIER[4:]:
                raise SnappyError("bad stream identifier")
            seen_header = True
            continue
        if not seen_header:
            raise SnappyError("chunk before stream identifier")
        if ctype in (0x00, 0x01):
            if len(body) < 4:
                raise SnappyError("chunk body shorter than its CRC")
            crc = struct.unpack("<I", body[:4])[0]
            chunk = decompress_block(body[4:]) if ctype == 0x00 else body[4:]
            if _masked_crc(chunk) != crc:
                raise SnappyError("chunk CRC mismatch")
            out += chunk
            data_frames += 1
            if len(out) >= want and data_frames >= 1:
                # Payload complete.  Consume any CONTIGUOUS trailing
                # skippable frames (types 0x80-0xFE incl. padding) that
                # still belong to THIS snappy stream — other spec-legal
                # encoders may emit them, and leaving them unconsumed
                # would make the next coded chunk's parse start inside a
                # padding frame (ADVICE r3).
                while pos + 4 <= len(data) and 0x80 <= data[pos] <= 0xFE:
                    skip_len = int.from_bytes(data[pos + 1 : pos + 4], "little")
                    if pos + 4 + skip_len > len(data):
                        break  # truncated padding: leave for the caller
                    pos += 4 + skip_len
                break
        elif 0x80 <= ctype <= 0xFE:  # skippable (0xFE = padding)
            continue
        else:
            raise SnappyError(f"unskippable unknown chunk type {ctype:#x}")
    if len(out) < want:
        raise SnappyError(f"stream ended at {len(out)}/{want} bytes")
    return bytes(out[:want]), pos


def decompress_framed(data: bytes) -> bytes:
    pos, out = 0, bytearray()
    seen_header = False
    while pos < len(data):
        if pos + 4 > len(data):
            raise SnappyError("truncated chunk header")
        ctype = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + length > len(data):
            raise SnappyError("truncated chunk body")
        body = data[pos : pos + length]
        pos += length
        if ctype == 0xFF:  # stream identifier
            if body != STREAM_IDENTIFIER[4:]:
                raise SnappyError("bad stream identifier")
            seen_header = True
            continue
        if not seen_header:
            raise SnappyError("chunk before stream identifier")
        if ctype in (0x00, 0x01) and len(body) < 4:
            raise SnappyError("chunk body shorter than its CRC")
        if ctype == 0x00:  # compressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = decompress_block(body[4:])
        elif ctype == 0x01:  # uncompressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = body[4:]
        elif 0x80 <= ctype <= 0xFD:  # skippable
            continue
        else:
            raise SnappyError(f"unskippable unknown chunk type {ctype:#x}")
        if _masked_crc(chunk) != crc:
            raise SnappyError("chunk CRC mismatch")
        out += chunk
    return bytes(out)
