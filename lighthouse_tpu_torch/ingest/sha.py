"""Batched SHA-256 + RFC 9380 expand_message_xmd across a message batch.

The port's copy of the JAX package's ``ingest/sha.py`` (numpy only; what it
computes is unchanged).  Two changes to how: the round function takes
fewer numpy calls, and messages of different lengths expand in one lockstep
run, a lane whose blocks are done keeping its state, instead of one run
per length (each run costs about as much at one lane as at hundreds).

The scalar marshal path calls hashlib once per message (~10 compression
blocks each for the G2 hash-to-field draw).  Here the whole batch runs in
lockstep: every SHA-256 round is one numpy op over a ``(B,)`` uint32 lane
per working variable, so the Python interpreter executes a *constant*
number of statements per batch instead of per set.  Messages are laid
out by length (a lane runs as many blocks as its message needs); there
is no per-message Python in the compression loop.

Two structural savings over naive per-message hashing:

* the 64-byte ``z_pad`` prefix of the ``b_0`` input is all zeros, so the
  state after its first block is a constant — precomputed once at import
  (``_ZPAD_MIDSTATE``) and used as the initial state, saving one
  compression per message;
* the ``b_1..b_ell`` chain is sequential per message but independent
  *across* messages, so each chain step is one batched compression over
  all B lanes.

Outputs are bit-exact with ``hashlib.sha256`` /
``hash_to_curve.expand_message_xmd`` — asserted by the differential
suite (tests/test_torch_ingest.py) on every shape the engine marshals.
"""

from __future__ import annotations

import numpy as np

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_HASH_BLOCK = 64  # SHA-256 block size, == hash_to_curve._HASH_BLOCK


_U = [np.uint32(n) for n in range(33)]  # shift counts, made once


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> _U[n]) | (x << _U[32 - n])


def _compress(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """One SHA-256 compression over B lanes.

    ``state``: (8, B) uint32; ``block``: (16, B) uint32 big-endian words.
    uint32 arithmetic wraps mod 2^32, exactly the SHA-256 word semantics.
    Every numpy call costs about as much at a few lanes as at hundreds, so
    Ch and Maj take their three- and four-operation forms and K[i] + w[i]
    is one call for all rounds.
    """
    w = np.empty((64,) + block.shape[1:], dtype=np.uint32)
    w[:16] = block
    for i in range(16, 64):
        x = w[i - 15]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> _U[3])
        y = w[i - 2]
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> _U[10])
        w[i] = w[i - 16] + s0 + w[i - 7] + s1
    w += _K[:, None]  # K[i] + w[i], wrapped
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        t1 = h + S1 + (g ^ (e & (f ^ g))) + w[i]  # Ch(e, f, g) = g ^ (e & (f ^ g))
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        t2 = S0 + ((a & (b | c)) | (b & c))  # Maj(a, b, c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return state + np.stack([a, b, c, d, e, f, g, h])


def _words_be(buf: np.ndarray) -> np.ndarray:
    """(B, 64k) uint8 -> (B, k, 16) uint32 big-endian block words."""
    B, total = buf.shape
    w = buf.reshape(B, total // 4, 4).astype(np.uint32)
    return ((w[..., 0] << 24) | (w[..., 1] << 16)
            | (w[..., 2] << 8) | w[..., 3]).reshape(B, total // 64, 16)


def _pad(groups: dict, B: int, length_offset: int):
    """SHA-256 padding of B messages given by length, ``groups`` = {L: (lane
    indices, (k, L) uint8 rows)}: -> ((B, 64 * kmax) uint8 buffer, (B,) block
    counts).  The padding length field covers ``length_offset + L`` bits."""
    nblocks = np.zeros(B, dtype=np.int64)
    kmax = max((L + 9 + _HASH_BLOCK - 1) // _HASH_BLOCK for L in groups)
    buf = np.zeros((B, kmax * _HASH_BLOCK), dtype=np.uint8)
    for L, (idx, rows) in groups.items():
        nb = (L + 9 + _HASH_BLOCK - 1) // _HASH_BLOCK
        end = nb * _HASH_BLOCK
        buf[idx, :L] = rows
        buf[idx, L] = 0x80
        buf[idx, end - 8:end] = np.frombuffer(
            ((length_offset + L) * 8).to_bytes(8, "big"), dtype=np.uint8)
        nblocks[idx] = nb
    return buf, nblocks


def _sha256_padded(buf: np.ndarray, nblocks: np.ndarray, init_state: np.ndarray) -> np.ndarray:
    """Digests of padded lanes of different block counts in one lockstep run:
    a lane whose blocks are done keeps its state.  -> (B, 32) uint8."""
    B = buf.shape[0]
    words = _words_be(buf)
    state = np.broadcast_to(init_state[:, None], (8, B)).copy()
    shortest = int(nblocks.min())
    for blk in range(words.shape[1]):
        new = _compress(state, np.ascontiguousarray(words[:, blk].T))
        state = new if blk < shortest else np.where(blk < nblocks, new, state)
    # big-endian digest bytes
    st = np.ascontiguousarray(state.T).astype(">u4")
    return st.view(np.uint8).reshape(B, 32)


def sha256_batch(
    data: np.ndarray,
    init_state: np.ndarray | None = None,
    length_offset: int = 0,
) -> np.ndarray:
    """SHA-256 of B equal-length messages: (B, L) uint8 -> (B, 32) uint8.

    ``init_state``/``length_offset`` resume from a midstate: the state
    after ``length_offset`` bytes already compressed (a multiple of 64);
    the padding length field covers ``length_offset + L`` bits total.
    """
    B, L = data.shape
    buf, nblocks = _pad({L: (np.arange(B), data)}, B, length_offset)
    return _sha256_padded(buf, nblocks, _H0 if init_state is None else init_state)


def _zpad_midstate() -> np.ndarray:
    """SHA-256 state after compressing one all-zero 64-byte block (the
    RFC 9380 z_pad prefix of every b_0 input)."""
    st = _H0[:, None].copy()
    return _compress(st, np.zeros((16, 1), dtype=np.uint32))[:, 0]


_ZPAD_MIDSTATE = _zpad_midstate()


def _expand_lanes(groups: dict, B: int, dst: bytes, len_in_bytes: int) -> np.ndarray:
    """RFC 9380 §5.3.1 for B messages of any lengths in one lockstep run,
    ``groups`` = {m: (lane indices, (k, m) uint8 rows)} -> (B, len_in_bytes)."""
    import hashlib

    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = np.frombuffer(dst + bytes([len(dst)]), dtype=np.uint8)

    # b0 = H(z_pad + msg + l_i_b + 0x00 + dst_prime); the z_pad block is
    # the precomputed midstate, so only the tail is compressed here.
    tails = {}
    for m, (idx, rows) in groups.items():
        tail = np.zeros((len(idx), m + 3 + len(dst_prime)), dtype=np.uint8)
        tail[:, :m] = rows
        tail[:, m] = (len_in_bytes >> 8) & 0xFF
        tail[:, m + 1] = len_in_bytes & 0xFF
        tail[:, m + 3:] = dst_prime
        tails[tail.shape[1]] = (idx, tail)
    b0 = _sha256_padded(*_pad(tails, B, _HASH_BLOCK), _ZPAD_MIDSTATE)

    # b_i = H((b0 xor b_{i-1}) + i + dst_prime), b_1 uses b_0 directly —
    # sequential in i, batched over all B lanes per step.
    bi_in = np.zeros((B, 32 + 1 + len(dst_prime)), dtype=np.uint8)
    bi_in[:, 33:] = dst_prime
    out = np.empty((B, 32 * ell), dtype=np.uint8)
    prev = np.zeros((B, 32), dtype=np.uint8)
    for i in range(1, ell + 1):
        bi_in[:, :32] = b0 if i == 1 else b0 ^ prev
        bi_in[:, 32] = i
        prev = sha256_batch(bi_in)
        out[:, 32 * (i - 1):32 * i] = prev
    return out[:, :len_in_bytes]


def expand_message_xmd_batch(
    msgs_arr: np.ndarray, dst: bytes, len_in_bytes: int
) -> np.ndarray:
    """RFC 9380 §5.3.1 for B same-length messages at once.

    ``msgs_arr``: (B, m) uint8.  Returns (B, len_in_bytes) uint8,
    bit-exact with ``expand_message_xmd`` per row.
    """
    B, m = msgs_arr.shape
    return _expand_lanes({m: (np.arange(B), msgs_arr)}, B, dst, len_in_bytes)


def hash_to_field_fp2_batch(msgs: list[bytes], count: int,
                            dst: bytes | None = None) -> list[list]:
    """Batched RFC 9380 §5.2 hash_to_field (m=2, L=64) over a message list.

    Messages of every length expand in one lockstep run (grouped by length
    only to lay out their padded blocks); results come back in input order
    as ``[[Fp2]*count]*B`` — the same values ``hash_to_field_fp2(msg,
    count)`` yields per message.  The final 64-byte draw -> int mod P step
    is a C-level bigint comprehension (sub-microsecond per coordinate), not
    per-set marshal work.
    """
    from ..crypto.bls import params
    from ..crypto.bls.fields import Fp2

    if not msgs:
        return []
    if dst is None:
        dst = params.DST
    len_in_bytes = count * 2 * 64
    by_len: dict[int, list[int]] = {}
    for j, msg in enumerate(msgs):
        by_len.setdefault(len(msg), []).append(j)
    groups = {}
    for m, idxs in by_len.items():
        rows = np.frombuffer(b"".join(msgs[j] for j in idxs), dtype=np.uint8).reshape(
            len(idxs), m)
        groups[m] = (np.array(idxs), rows)
    expanded = _expand_lanes(groups, len(msgs), dst, len_in_bytes)
    uniform = [row.tobytes() for row in expanded]
    P = params.P
    out = []
    for u in uniform:
        elems = []
        for i in range(count):
            off = 128 * i
            elems.append(Fp2(
                int.from_bytes(u[off:off + 64], "big") % P,
                int.from_bytes(u[off + 64:off + 128], "big") % P,
            ))
        out.append(elems)
    return out
