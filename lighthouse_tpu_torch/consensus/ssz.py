"""SSZ (SimpleSerialize): serialization + Merkleization for consensus types.

The capability twin of the reference's `ethereum_ssz` + `tree_hash` crates
(consumed throughout the reference's consensus/types; e.g. containers derive
`Encode`/`Decode`/`TreeHash` in consensus/types/src/beacon_block.rs). This is
a fresh implementation from the SSZ spec, organized for a TPU-first stack:

* Type descriptors are plain Python objects (`U64`, `Vector(elem, n)`,
  `SSZList(elem, limit)`, `Container` subclasses) so static preset sizes —
  the `EthSpec` type-level integers of consensus/types/src/eth_spec.rs:52 —
  become ordinary constructor arguments chosen once per preset, and every
  batch shape derived from them is static for XLA.
* Merkleization hashes all chunk pairs of a tree level in ONE numpy-batched
  SHA-256 pass (`_sha256_pairs`), so hashing a 1M-entry balances list is a
  handful of wide passes rather than 2M Python hash calls. The same layout
  feeds the future device-side tree-hash kernel.

Wire/Merkle rules implemented from the consensus-specs SSZ document:
little-endian basic types, fixed/variable-part serialization with 4-byte
offsets, 32-byte chunk packing, zero-padded power-of-two virtual trees, and
length mix-in for lists/bitlists.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Sequence

import numpy as np

BYTES_PER_CHUNK = 32
OFFSET_BYTES = 4
ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# Precomputed zero-subtree hashes: _zero_hashes[d] = root of an all-zero
# virtual tree of depth d (2^d chunks).
_zero_hashes: list[bytes] = [ZERO_CHUNK]
while len(_zero_hashes) < 64:
    h = hashlib.sha256(_zero_hashes[-1] + _zero_hashes[-1]).digest()
    _zero_hashes.append(h)


class _CacheBudget:
    """Approximate byte accounting for the registry-scale caches.

    Two buckets feed the ``ssz_cache_bytes`` gauge:

    * ``used_bytes`` — the shared evictable caches (the content-keyed
      big-uint root cache, the SSZList registry root caches, and the
      active-indices caches in committees.py).  ``trim`` bounds them:
      oldest-first eviction while a cache is over its entry cap OR the
      global byte budget, so a 1M-validator soak cannot accrete
      multi-GB key material (each packed-balances key alone is ~8 MB
      at mainnet registry scale).
    * ``memo_bytes`` — per-frozen-container ``_ser_memo``/``_root_memo``
      bytes.  Memos are 1:1 with immutable objects and die with them,
      so they are gauged but never evicted and never counted against
      the eviction budget (evicting them would just re-pay the root).

    Counter updates are unlocked: readers race only against the
    approximation, and every writer path already runs under the
    per-node import flow.
    """

    def __init__(self, limit_bytes: int = 256 * 1024 * 1024):
        self.limit_bytes = limit_bytes
        self.used_bytes = 0
        self.memo_bytes = 0

    def _publish(self):
        from ..utils import metrics as M

        M.SSZ_CACHE_BYTES.set(float(self.used_bytes + self.memo_bytes))

    def charge(self, nbytes: int) -> None:
        self.used_bytes += int(nbytes)
        self._publish()

    def charge_memo(self, nbytes: int) -> None:
        self.memo_bytes += int(nbytes)
        self._publish()

    def release(self, nbytes: int) -> None:
        self.used_bytes = max(0, self.used_bytes - int(nbytes))
        self._publish()

    def trim(self, cache: dict, cost, cap: int) -> None:
        """Evict oldest entries while ``cache`` is over its entry cap or
        the global byte budget; ``cost(key, value)`` prices an entry the
        same way its insert charged it."""
        evicted = 0
        while cache and (len(cache) > cap or self.used_bytes > self.limit_bytes):
            key = next(iter(cache))
            val = cache.pop(key)
            self.release(cost(key, val))
            evicted += 1
        if evicted:
            from ..utils import metrics as M

            M.SSZ_CACHE_EVICTIONS.inc(evicted)


CACHE_BUDGET = _CacheBudget()


def set_cache_budget(limit_bytes: int) -> None:
    """Rebind the evictable-cache byte budget (soak scenarios tighten it)."""
    CACHE_BUDGET.limit_bytes = int(limit_bytes)


def _sha256_pairs(data: np.ndarray) -> np.ndarray:
    """Hash rows of a (k, 64) uint8 array -> (k, 32) uint8 array.

    One Python-level loop per level, but hashlib releases the GIL per call
    and the loop body is just a memoryview slice; replaced by the native
    batch hasher (lighthouse_tpu/ops) when available.
    """
    from ..ops import sha256_many  # local import: ops may lazy-load native code

    return sha256_many(data)


def _merkleize_chunks(chunks: bytes, limit_chunks: int | None = None) -> bytes:
    """Merkle root of the chunk sequence, zero-padded to the virtual tree of
    ``limit_chunks`` (or to the next power of two of the count)."""
    count = len(chunks) // BYTES_PER_CHUNK
    if limit_chunks is None:
        limit_chunks = max(count, 1)
    if count > limit_chunks:
        raise ValueError(f"{count} chunks exceeds limit {limit_chunks}")
    depth = max(limit_chunks - 1, 0).bit_length()
    if count == 0:
        return _zero_hashes[depth]
    arr = np.frombuffer(chunks, dtype=np.uint8).reshape(count, BYTES_PER_CHUNK)
    for level in range(depth):
        n = arr.shape[0]
        if n % 2 == 1:
            # odd: the sibling is the zero-subtree of this level
            zrow = np.frombuffer(_zero_hashes[level], dtype=np.uint8)
            arr = np.vstack([arr, zrow[None, :]])
            n += 1
        arr = _sha256_pairs(arr.reshape(n // 2, 2 * BYTES_PER_CHUNK))
    return arr.tobytes()


def _mix_in_length(root: bytes, length: int) -> bytes:
    return hashlib.sha256(root + length.to_bytes(32, "little")).digest()


def _pack_bytes(data: bytes) -> bytes:
    """Right-pad serialized basic values to a whole number of chunks."""
    rem = len(data) % BYTES_PER_CHUNK
    if rem:
        data += b"\x00" * (BYTES_PER_CHUNK - rem)
    return data


class SSZType:
    """Base descriptor. Subclasses implement the SSZ quartet."""

    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        """Serialized size if fixed; OFFSET_BYTES worth of offset otherwise."""
        raise NotImplementedError

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError

    def copy_value(self, value):
        """Independent copy of ``value`` with deepcopy semantics.  Basic
        types return the (immutable) value itself; collections rebuild the
        outer list; containers recurse field-wise.  The fallback is a true
        deepcopy so exotic value shapes stay correct."""
        import copy as _copy

        return _copy.deepcopy(value)


class UintN(SSZType):
    def __init__(self, bits: int):
        assert bits in (8, 16, 32, 64, 128, 256)
        self.bits = bits
        self.nbytes = bits // 8

    def __repr__(self):
        return f"uint{self.bits}"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.nbytes

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.nbytes, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.nbytes:
            raise ValueError(f"uint{self.bits}: got {len(data)} bytes")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return _pack_bytes(self.serialize(value))

    def default(self) -> int:
        return 0

    def copy_value(self, value):
        return value


class Boolean(SSZType):
    def __repr__(self):
        return "boolean"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean byte")

    def hash_tree_root(self, value) -> bytes:
        return _pack_bytes(self.serialize(value))

    def default(self) -> bool:
        return False

    def copy_value(self, value):
        return value


U8, U16, U32, U64, U128, U256 = (UintN(b) for b in (8, 16, 32, 64, 128, 256))
BOOLEAN = Boolean()


class ByteVector(SSZType):
    """bytesN — fixed-length opaque bytes (Root, Signature, Pubkey, ...)."""

    def __init__(self, length: int):
        self.length = length

    def __repr__(self):
        return f"ByteVector[{self.length}]"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return self.length

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)}")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(data)}")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        return _merkleize_chunks(_pack_bytes(self.serialize(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length

    def copy_value(self, value):
        return value


class ByteList(SSZType):
    """Variable bytes with a max length (e.g. transactions, extra_data)."""

    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"ByteList[{self.limit}]"

    def is_fixed_size(self):
        return False

    def fixed_size(self):
        return OFFSET_BYTES

    def serialize(self, value: bytes) -> bytes:
        value = bytes(value)
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return value

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(data)

    def hash_tree_root(self, value) -> bytes:
        value = bytes(value)
        limit_chunks = (self.limit + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        root = _merkleize_chunks(_pack_bytes(value), max(limit_chunks, 1))
        return _mix_in_length(root, len(value))

    def default(self) -> bytes:
        return b""

    def copy_value(self, value):
        return value


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        assert length > 0
        self.elem = elem
        self.length = length

    def __repr__(self):
        return f"Vector[{self.elem!r}, {self.length}]"

    def is_fixed_size(self):
        return self.elem.is_fixed_size()

    def fixed_size(self):
        if self.is_fixed_size():
            return self.elem.fixed_size() * self.length
        return OFFSET_BYTES

    def serialize(self, value: Sequence) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Vector length {len(value)} != {self.length}")
        return _serialize_sequence(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_sequence(self.elem, data)
        if len(out) != self.length:
            raise ValueError("Vector length mismatch")
        return out

    def hash_tree_root(self, value) -> bytes:
        return _sequence_root(self.elem, value, None)

    def default(self):
        return [self.elem.default() for _ in range(self.length)]

    def copy_value(self, value):
        return _copy_sequence(self.elem, value)


class SSZList(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def __repr__(self):
        return f"List[{self.elem!r}, {self.limit}]"

    def is_fixed_size(self):
        return False

    def fixed_size(self):
        return OFFSET_BYTES

    def serialize(self, value: Sequence) -> bytes:
        if len(value) > self.limit:
            raise ValueError("List over limit")
        return _serialize_sequence(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_sequence(self.elem, data)
        if len(out) > self.limit:
            raise ValueError("List over limit")
        return out

    def hash_tree_root(self, value) -> bytes:
        root = self._registry_root(value)
        if root is None:
            root = _sequence_root(self.elem, value, self.limit)
        return _mix_in_length(root, len(value))

    def _registry_root(self, values) -> bytes | None:
        """Registry-scale root cache (cheap-node path).

        Sound because every state-list mutation in this package is
        replace-style — a NEW list object is bound to the field; elements
        are never assigned in place (and frozen validators enforce their
        own immutability).  Two levels:

        * by outer-list identity — O(1) repeat roots of the same state.
          The cache pins the list (strong ref) and re-checks ``is`` + len,
          so a recycled id or an in-place append can never serve stale.
        * for freezable-container elements, by element-identity tuple —
          shared across state *copies*, which rebuild the outer list but
          share the frozen elements.  Engaged only when every element is
          frozen; the snapshot pins the elements.

        Only engages at registry scale (len >= 4096) where re-Merkleizing
        dominates; small lists take the plain path untouched.
        """
        n = len(values)
        if n < 4096:
            return None
        cls = getattr(self.elem, "cls", None)
        if cls is not None:
            if not getattr(cls, "_freezable", False):
                return None
        elif not isinstance(self.elem, UintN):
            return None
        by_id = self.__dict__.setdefault("_root_by_id", {})
        hit = by_id.get(id(values))
        if hit is not None and hit[1] is values and len(hit[1]) == n:
            return hit[0]
        if cls is not None:
            by_elems = self.__dict__.setdefault("_root_by_elems", {})
            key = tuple(map(id, values))
            hit2 = by_elems.get(key)
            if hit2 is not None:
                root = hit2[0]
            elif all(v.__dict__.get("_frozen") for v in values):
                root = _sequence_root(self.elem, values, self.limit)
                CACHE_BUDGET.charge(n * 16 + 96)
                by_elems[key] = (root, list(values))
                CACHE_BUDGET.trim(
                    by_elems, lambda k, v: len(k) * 16 + 96, 4
                )
            else:
                return None
        else:
            root = _sequence_root(self.elem, values, self.limit)
        CACHE_BUDGET.charge(n * 8 + 96)
        by_id[id(values)] = (root, values)
        CACHE_BUDGET.trim(by_id, lambda k, v: len(v[1]) * 8 + 96, 8)
        return root

    def default(self):
        return []

    def copy_value(self, value):
        return _copy_sequence(self.elem, value)


class Bitvector(SSZType):
    def __init__(self, length: int):
        assert length > 0
        self.length = length

    def __repr__(self):
        return f"Bitvector[{self.length}]"

    def is_fixed_size(self):
        return True

    def fixed_size(self):
        return (self.length + 7) // 8

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError("Bitvector length mismatch")
        return _bits_to_bytes(value)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size():
            raise ValueError("Bitvector size mismatch")
        bits = _bytes_to_bits(data)[: self.length]
        if any(_bytes_to_bits(data)[self.length :]):
            raise ValueError("Bitvector: padding bits set")
        return bits

    def hash_tree_root(self, value) -> bytes:
        limit_chunks = (self.length + 255) // 256
        return _merkleize_chunks(_pack_bytes(self.serialize(value)), limit_chunks)

    def default(self):
        return [False] * self.length

    def copy_value(self, value):
        return list(value)


class Bitlist(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def __repr__(self):
        return f"Bitlist[{self.limit}]"

    def is_fixed_size(self):
        return False

    def fixed_size(self):
        return OFFSET_BYTES

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError("Bitlist over limit")
        # delimiter bit marks the length
        bits = list(value) + [True]
        return _bits_to_bytes(bits)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("Bitlist: empty")
        bits = _bytes_to_bits(data)
        # strip trailing zeros then the delimiter
        while bits and not bits[-1]:
            bits.pop()
        if not bits:
            raise ValueError("Bitlist: missing delimiter")
        bits.pop()
        if len(bits) > self.limit:
            raise ValueError("Bitlist over limit")
        # the delimiter must live in the final byte of the encoding
        if len(bits) // 8 != len(data) - 1:
            raise ValueError("Bitlist: delimiter not in final byte")
        return bits

    def hash_tree_root(self, value) -> bytes:
        limit_chunks = (self.limit + 255) // 256
        root = _merkleize_chunks(_pack_bytes(_bits_to_bytes(value)), limit_chunks)
        return _mix_in_length(root, len(value))

    def default(self):
        return []

    def copy_value(self, value):
        return list(value)


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _bytes_to_bits(data: bytes) -> list[bool]:
    return [bool((byte >> i) & 1) for byte in data for i in range(8)]


def _copy_sequence(elem: SSZType, values: Sequence) -> list:
    if isinstance(elem, (UintN, Boolean, ByteVector, ByteList)):
        return list(values)  # immutable elements: fresh outer list only
    return [elem.copy_value(v) for v in values]


def _serialize_sequence(elem: SSZType, values: Sequence) -> bytes:
    if elem.is_fixed_size():
        if isinstance(elem, UintN) and len(values) > 256:
            return _pack_uints(elem, values)
        return b"".join(elem.serialize(v) for v in values)
    parts = [elem.serialize(v) for v in values]
    offset = OFFSET_BYTES * len(parts)
    head, body = bytearray(), bytearray()
    for p in parts:
        head += struct.pack("<I", offset)
        body += p
        offset += len(p)
    return bytes(head + body)


def _deserialize_sequence(elem: SSZType, data: bytes) -> list:
    if elem.is_fixed_size():
        size = elem.fixed_size()
        if size == 0 or len(data) % size:
            raise ValueError("sequence size mismatch")
        return [
            elem.deserialize(data[i : i + size]) for i in range(0, len(data), size)
        ]
    if not data:
        return []
    first = struct.unpack_from("<I", data, 0)[0]
    if first % OFFSET_BYTES or first > len(data):
        raise ValueError("bad first offset")
    count = first // OFFSET_BYTES
    offsets = [struct.unpack_from("<I", data, OFFSET_BYTES * i)[0] for i in range(count)]
    offsets.append(len(data))
    out = []
    for a, b in zip(offsets, offsets[1:]):
        if b < a:
            raise ValueError("offsets not monotonic")
        out.append(elem.deserialize(data[a:b]))
    return out


def _pack_uints(elem: "UintN", values: Sequence) -> bytes:
    """Serialize a uint sequence in one numpy pass (the balances /
    participation / inactivity lists are 100k+ entries at registry scale;
    a per-element ``int.to_bytes`` loop dominates the state root there)."""
    dtype = f"<u{elem.nbytes}"
    try:
        return np.asarray(values, dtype=dtype).tobytes()
    except (OverflowError, TypeError, ValueError):
        # odd value types (or out-of-range ints caught late): exact path
        return b"".join(elem.serialize(v) for v in values)


def _sequence_root(elem: SSZType, values: Sequence, limit: int | None) -> bytes:
    if isinstance(elem, UintN) or isinstance(elem, Boolean):
        if isinstance(elem, UintN) and len(values) > 256:
            raw = _pack_uints(elem, values)
            if len(values) >= 4096:
                # registry-scale uint lists (balances, participation,
                # inactivity): every node in a multi-node scenario imports
                # the same block and re-roots identical content — key the
                # Merkle pass by the packed bytes so one compute serves
                # the whole mesh.  Keyed on (limit, content); elem is the
                # shared UintN singleton, so the cache spans fields.
                cache = elem.__dict__.setdefault("_big_root_cache", {})
                key = (limit, raw)
                hit = cache.get(key)
                if hit is not None:
                    return hit
                root = _uint_sequence_root(elem, raw, limit)
                CACHE_BUDGET.charge(len(raw) + 96)
                cache[key] = root
                CACHE_BUDGET.trim(
                    cache, lambda k, v: len(k[1]) + 96, 8
                )
                return root
        else:
            raw = b"".join(elem.serialize(v) for v in values)
        return _uint_sequence_root(elem, raw, limit)
    chunks = b"".join(elem.hash_tree_root(v) for v in values)
    return _merkleize_chunks(chunks, limit if limit is not None else None)


def _uint_sequence_root(elem: SSZType, raw: bytes, limit: int | None) -> bytes:
    data = _pack_bytes(raw)
    per_chunk = BYTES_PER_CHUNK // elem.fixed_size()
    limit_chunks = (
        None if limit is None else (limit + per_chunk - 1) // per_chunk
    )
    return _merkleize_chunks(data, limit_chunks)


class _ContainerMeta(type):
    """Collects ``fields`` declarations (name -> SSZType instance) from the
    class body annotations-style dict and builds accessors."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: dict[str, SSZType] = {}
        for base in reversed(bases):
            fields.update(getattr(base, "_fields", {}))
        fields.update(ns.get("fields", {}))
        cls._fields = fields
        return cls


class Container(SSZType, metaclass=_ContainerMeta):
    """SSZ container; subclass with ``fields = {"slot": U64, ...}``.

    Instances hold values as attributes; the class doubles as its own type
    descriptor (classmethod-style quartet wrapped by SSZType methods).
    """

    fields: dict[str, SSZType] = {}

    # Classes that opt into the freeze/copy-on-write protocol (instances
    # carry a ``_frozen`` marker in __dict__) set this True; the registry
    # root cache and fast copy path key off it.
    _freezable = False

    def __init__(self, **kwargs):
        for fname, ftype in self._fields.items():
            if fname in kwargs:
                setattr(self, fname, kwargs.pop(fname))
            else:
                setattr(self, fname, ftype.default())
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    # --- instance conveniences -------------------------------------------
    def encode(self) -> bytes:
        return type(self).serialize_value(self)

    def root(self) -> bytes:
        return type(self).hash_tree_root_value(self)

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f) == getattr(other, f) for f in self._fields
        )

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._fields)
        return f"{type(self).__name__}({inner})"

    # --- SSZType quartet (class-level, value passed in) -------------------
    @classmethod
    def is_fixed_size_cls(cls) -> bool:
        return all(t.is_fixed_size() for t in cls._fields.values())

    @classmethod
    def fixed_size_cls(cls) -> int:
        if cls.is_fixed_size_cls():
            return sum(t.fixed_size() for t in cls._fields.values())
        return OFFSET_BYTES

    @classmethod
    def serialize_value(cls, value) -> bytes:
        head, body = bytearray(), bytearray()
        fixed_len = sum(
            t.fixed_size() if t.is_fixed_size() else OFFSET_BYTES
            for t in cls._fields.values()
        )
        offset = fixed_len
        tails = []
        for fname, ftype in cls._fields.items():
            v = getattr(value, fname)
            if ftype.is_fixed_size():
                head += ftype.serialize(v)
            else:
                head += struct.pack("<I", offset)
                t = ftype.serialize(v)
                tails.append(t)
                offset += len(t)
        for t in tails:
            body += t
        return bytes(head + body)

    @classmethod
    def deserialize_value(cls, data: bytes):
        pos = 0
        values: dict[str, Any] = {}
        offsets: list[tuple[str, SSZType, int]] = []
        for fname, ftype in cls._fields.items():
            if ftype.is_fixed_size():
                size = ftype.fixed_size()
                values[fname] = ftype.deserialize(data[pos : pos + size])
                pos += size
            else:
                off = struct.unpack_from("<I", data, pos)[0]
                offsets.append((fname, ftype, off))
                pos += OFFSET_BYTES
        bounds = [o for (_, _, o) in offsets] + [len(data)]
        for (fname, ftype, off), end in zip(offsets, bounds[1:]):
            if end < off or off > len(data):
                raise ValueError("container offsets invalid")
            values[fname] = ftype.deserialize(data[off:end])
        return cls(**values)

    @classmethod
    def hash_tree_root_value(cls, value) -> bytes:
        chunks = b"".join(
            t.hash_tree_root(getattr(value, f)) for f, t in cls._fields.items()
        )
        return _merkleize_chunks(chunks)

    @classmethod
    def copy_value_of(cls, value):
        """Type-driven structural copy: fresh instance, each field copied per
        its SSZ type.  Equivalent to deepcopy for SSZ-shaped data (all state
        mutation in this package is attribute/replace-style), but skips the
        deepcopy memo walk — the difference between seconds and milliseconds
        on registry-scale states."""
        new = cls.__new__(cls)
        d = new.__dict__
        src = value.__dict__
        for fname, ftype in cls._fields.items():
            d[fname] = ftype.copy_value(src[fname])
        return new

    # --- SSZType interface (container used as a field type) ---------------
    def is_fixed_size(self):  # pragma: no cover - shadowed by classmethods
        raise TypeError("use the class, not an instance, as a field type")


class _ContainerField(SSZType):
    """Adapter: lets a Container CLASS be used directly as a field type."""

    def __init__(self, cls):
        self.cls = cls

    def __repr__(self):
        return self.cls.__name__

    def is_fixed_size(self):
        return self.cls.is_fixed_size_cls()

    def fixed_size(self):
        return self.cls.fixed_size_cls()

    def serialize(self, value):
        d = value.__dict__
        memo = d.get("_ser_memo")
        if memo is not None:
            return memo
        out = self.cls.serialize_value(value)
        if d.get("_frozen"):
            d["_ser_memo"] = out  # frozen => immutable => bytes never stale
            CACHE_BUDGET.charge_memo(len(out) + 64)
        return out

    def deserialize(self, data):
        return self.cls.deserialize_value(data)

    def hash_tree_root(self, value):
        d = value.__dict__
        memo = d.get("_root_memo")
        if memo is not None:
            return memo
        root = self.cls.hash_tree_root_value(value)
        if d.get("_frozen"):
            d["_root_memo"] = root  # frozen => immutable => memo never stale
            CACHE_BUDGET.charge_memo(96)
        return root

    def default(self):
        return self.cls()

    def copy_value(self, value):
        if value.__dict__.get("_frozen"):
            return value  # frozen containers are immutable: share, don't copy
        return type(value).copy_value_of(value)


def F(container_cls) -> _ContainerField:
    """Wrap a Container class for use as a field/element type."""
    return _ContainerField(container_cls)


def serialize(type_or_cls, value) -> bytes:
    if isinstance(type_or_cls, type) and issubclass(type_or_cls, Container):
        return type_or_cls.serialize_value(value)
    return type_or_cls.serialize(value)


def deserialize(type_or_cls, data: bytes):
    if isinstance(type_or_cls, type) and issubclass(type_or_cls, Container):
        return type_or_cls.deserialize_value(data)
    return type_or_cls.deserialize(data)


def hash_tree_root(type_or_cls, value=None) -> bytes:
    """hash_tree_root(ContainerInstance) or hash_tree_root(type, value)."""
    if value is None and isinstance(type_or_cls, Container):
        return type(type_or_cls).hash_tree_root_value(type_or_cls)
    if isinstance(type_or_cls, type) and issubclass(type_or_cls, Container):
        return type_or_cls.hash_tree_root_value(value)
    return type_or_cls.hash_tree_root(value)
