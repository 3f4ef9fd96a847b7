"""Checksummed WAL framing for the slabdb log + the independent verifier.

The C++ engine (native/slabdb.cpp) is the writer and replayer of record;
this module is the *independent* Python reader of the same format: the same
CRC32-C (Castagnoli) the snappy framing uses — reused from
network/snappy.py, not re-derived — over the same record layout, with zero
code shared with the engine.  Three consumers:

* ``lighthouse-tpu db verify`` — offline integrity scan (per-column record
  counts, CRC failures, what recovery would keep/drop) without ever
  touching the engine;
* the corrupt-record test fixtures (tests/test_store.py), which use
  ``scan_file`` record offsets to place byte-flips and truncations;
* the ``torn-write`` fault injection (store/kv.py), which appends a
  deliberately truncated ``encode_record`` frame — exactly what a SIGKILL
  mid-``fwrite`` leaves behind.

Record layout (v2, magic "SLB2" on disk)::

    tag u8 | klen u32 | vlen u32 | crc u32 | key | value

``crc`` is CRC32-C over the first 9 header bytes + key + value.  Legacy v1
logs (magic 0x534c4142, no CRC) are recognized and scanned structurally;
the engine migrates them to v2 on first open.

``scan_file``'s kept/dropped/truncated numbers intentionally mirror the
engine's replay semantics (truncate to the last valid prefix; count lost
frames by a bounds-only forward walk), so tests can assert the engine's
``RecoveryReport`` against this module's independent prediction.
"""

from __future__ import annotations

import os
import struct
from dataclasses import asdict, dataclass

from ..network.snappy import crc32c

MAGIC_V1 = (0x534C4142).to_bytes(4, "little")  # legacy, no per-record CRC
MAGIC_V2 = (0x32424C53).to_bytes(4, "little")  # b"SLB2": CRC32-C framed
TAG_PUT = 1
TAG_DEL = 2
_HDR = struct.Struct("<BIII")
HEADER_SIZE = _HDR.size  # 13
_HDR_V1_SIZE = 9
MAX_KLEN = 1 << 20
MAX_VLEN = 1 << 30


def encode_record(tag: int, key: bytes, value: bytes = b"") -> bytes:
    """Frame one record exactly as the engine writes it (pinned against the
    engine's on-disk bytes in tests/test_store.py)."""
    head = struct.pack("<BII", tag, len(key), len(value))
    crc = crc32c(head + key + value)
    return head + struct.pack("<I", crc) + key + value


@dataclass
class RecoveryReport:
    """What opening the log did to a damaged tail (slab_recovery_* ABI)."""

    records_kept: int = 0       # records applied from the valid prefix
    records_dropped: int = 0    # record frames lost past the valid prefix
    bytes_truncated: int = 0    # bytes cut from the tail
    tail_torn: bool = False     # a torn/corrupt tail was truncated
    crc_mismatch: bool = False  # the cut happened at a CRC failure (bit rot)
    migrated: bool = False      # a v1 (no-CRC) log was rewritten as v2

    @property
    def clean(self) -> bool:
        return not self.tail_torn

    def as_dict(self) -> dict:
        return asdict(self)


def scan_file(path: str, keep_records: bool = True) -> dict:
    """Scan a slab log without the engine, verifying every CRC.

    Returns a dict with ``format`` ("v2"/"v1"/"empty"/"unknown"),
    ``records_kept`` / ``records_dropped`` / ``bytes_truncated`` /
    ``valid_prefix_bytes`` / ``stop_reason`` / ``crc_failures``,
    ``per_column`` counts ({column: {"puts", "dels", "live"}}), and — when
    ``keep_records`` — a ``records`` list of
    ``{"offset", "tag", "key", "vlen"}`` for fixture placement.
    """
    from .kv import DBColumn  # local import: kv imports this module

    colname = {c.value: c.name for c in DBColumn}
    size = os.path.getsize(path)
    out: dict = {
        "path": path,
        "file_bytes": size,
        "format": "unknown",
        "records_kept": 0,
        "records_dropped": 0,
        "bytes_truncated": 0,
        "valid_prefix_bytes": min(size, 4),
        "stop_reason": None,
        "crc_failures": 0,
        "per_column": {},
        "records": [] if keep_records else None,
    }
    with open(path, "rb") as f:
        magic = f.read(4)
        if not magic:
            out["format"] = "empty"
            return out
        if magic == MAGIC_V2:
            v2, hdr_size = True, HEADER_SIZE
        elif magic == MAGIC_V1:
            v2, hdr_size = False, _HDR_V1_SIZE
        else:
            out["stop_reason"] = "bad-magic"
            return out
        out["format"] = "v2" if v2 else "v1"

        per_column: dict[str, dict[str, int]] = {}
        live: dict[bytes, str] = {}
        pos = 4
        while True:
            hdr = f.read(hdr_size)
            if len(hdr) < hdr_size:
                if hdr:
                    out["stop_reason"] = "torn-header"
                break
            if v2:
                tag, klen, vlen, crc = _HDR.unpack(hdr)
            else:
                tag, klen, vlen = struct.unpack("<BII", hdr)
                crc = None
            if (
                tag not in (TAG_PUT, TAG_DEL)
                or klen > MAX_KLEN
                or vlen > MAX_VLEN
                or (v2 and tag == TAG_DEL and vlen != 0)
            ):
                out["stop_reason"] = "corrupt-header"
                break
            body = klen + (vlen if tag == TAG_PUT else 0)
            if pos + hdr_size + body > size:
                out["stop_reason"] = "torn-write"
                break
            key = f.read(klen)
            val = f.read(vlen) if tag == TAG_PUT else b""
            if v2 and crc32c(hdr[:_HDR_V1_SIZE] + key + val) != crc:
                out["crc_failures"] += 1
                out["stop_reason"] = "crc-mismatch"
                break
            col = colname.get(key[:1], "?" + key[:1].hex())
            stats = per_column.setdefault(
                col, {"puts": 0, "dels": 0, "live": 0}
            )
            if tag == TAG_PUT:
                stats["puts"] += 1
                live[key] = col
            else:
                stats["dels"] += 1
                live.pop(key, None)
            if keep_records:
                out["records"].append(
                    {"offset": pos, "tag": tag, "key": key, "vlen": vlen}
                )
            out["records_kept"] += 1
            pos += hdr_size + body

        out["valid_prefix_bytes"] = pos
        for col in live.values():
            per_column[col]["live"] += 1
        out["per_column"] = per_column

        if pos < size and out["stop_reason"]:
            out["bytes_truncated"] = size - pos
            # mirror the engine's count_lost: bounds-only forward walk; a
            # frame whose header survived but whose payload runs past EOF
            # counts as one lost record
            f.seek(pos)
            q = pos
            while True:
                hdr = f.read(hdr_size)
                if len(hdr) < hdr_size:
                    break
                if v2:
                    tag, klen, vlen, _ = _HDR.unpack(hdr)
                else:
                    tag, klen, vlen = struct.unpack("<BII", hdr)
                if tag not in (TAG_PUT, TAG_DEL) or klen > MAX_KLEN or vlen > MAX_VLEN:
                    break
                body = klen + (vlen if tag == TAG_PUT else 0)
                out["records_dropped"] += 1
                if q + hdr_size + body > size:
                    break
                f.seek(body, 1)
                q += hdr_size + body
    return out


def verify_file(path: str) -> dict:
    """`lighthouse-tpu db verify` payload: the offline scan minus the raw
    per-record list, plus a recovery-report-shaped summary."""
    scan = scan_file(path, keep_records=False)
    scan.pop("records")
    scan["recovery"] = RecoveryReport(
        records_kept=scan["records_kept"],
        records_dropped=scan["records_dropped"],
        bytes_truncated=scan["bytes_truncated"],
        tail_torn=scan["stop_reason"] is not None,
        crc_mismatch=scan["stop_reason"] == "crc-mismatch",
    ).as_dict()
    scan["ok"] = scan["stop_reason"] is None and scan["format"] in ("v2", "v1", "empty")
    return scan
