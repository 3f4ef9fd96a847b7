"""Canary corpus: precomputed known-answer signature sets.

The port's copy of the JAX package's ``integrity/corpus.py``; for the same
``(seed, epoch)`` it makes byte-identical keys, messages and signatures.
The corpus is a literal registry (``CANARY_CORPUS``): every entry is an
``(entry_id, kind, message)`` row with a unique id and a kind drawn from
``valid``/``invalid``, and the corpus mixes both kinds — a canary suite
that can only catch one lie direction would let the other through.

``CanaryCorpus`` materialises the registry into real
:class:`~..crypto.bls.api.SignatureSet` objects for a given epoch.  Keys
and messages are salted with ``(seed, epoch)`` so the corpus rotates
every epoch — a device cannot learn the canaries.  Every generated entry
is checked through the scalar oracle (``cpu_backend``) once per
``(seed, epoch)`` and cached process-wide; a corpus whose oracle verdict
disagrees with its declared kind raises immediately at generation time.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

from ..crypto.bls import api as _bls_api

# ---------------------------------------------------------------------------
# Literal registries
# ---------------------------------------------------------------------------

#: Default number of canary sets dispatched alongside every real batch.
DEFAULT_K = 2

#: ``(entry_id, kind, message)`` rows.  ``kind`` is ``valid`` (signature
#: verifies) or ``invalid`` (signature was produced over a tampered
#: message, so verification must fail).  Ids are unique and both kinds
#: are represented.
CANARY_CORPUS = (
    ("valid-a", "valid", "lighthouse-tpu canary valid a"),
    ("valid-b", "valid", "lighthouse-tpu canary valid b"),
    ("invalid-sig", "invalid", "lighthouse-tpu canary tampered signature"),
    ("invalid-msg", "invalid", "lighthouse-tpu canary tampered message"),
)

#: Silent chaos kinds this layer is built to catch; each is armable in
#: utils/faults.py (``_KINDS``).
REQUIRED_CHAOS_KINDS = ("silent-flip", "silent-stuck-true")


@dataclass(frozen=True)
class CanaryEntry:
    """One materialised canary: a single-set batch with a known verdict."""

    entry_id: str
    expected: bool
    sets: tuple


_ENTRY_CACHE: dict[tuple[int, int], tuple[CanaryEntry, ...]] = {}
_CACHE_LOCK = threading.Lock()


def _derive_sk(seed: int, epoch: int, idx: int) -> "_bls_api.SecretKey":
    digest = hashlib.sha256(
        f"lighthouse-tpu-canary|{seed}|{epoch}|{idx}".encode()
    ).digest()
    # Reduce into the valid scalar range [1, R).
    from ..crypto.bls import params

    return _bls_api.SecretKey(1 + int.from_bytes(digest, "big") % (params.R - 1))


def _materialise(seed: int, epoch: int, oracle_check: bool) -> tuple[CanaryEntry, ...]:
    oracle = _bls_api.cpu_backend()
    entries = []
    for idx, (entry_id, kind, message) in enumerate(CANARY_CORPUS):
        sk = _derive_sk(seed, epoch, idx)
        msg = f"{message}|seed={seed}|epoch={epoch}".encode()
        if kind == "valid":
            sig = sk.sign(msg)
            expected = True
        else:
            # Sign a tampered message but claim the original: the
            # pairing must reject, whatever the device says.
            sig = sk.sign(msg + b"|tampered")
            expected = False
        s = _bls_api.SignatureSet(sig, [sk.public_key()], msg)
        if oracle_check and bool(oracle.verify_signature_sets([s])) != expected:
            raise RuntimeError(
                f"canary corpus integrity violated: entry {entry_id!r} "
                f"(epoch {epoch}) disagrees with the scalar oracle"
            )
        entries.append(CanaryEntry(entry_id, expected, (s,)))
    return tuple(entries)


class CanaryCorpus:
    """Epoch-rotated view over the literal ``CANARY_CORPUS`` registry.

    ``batches(k)`` returns ``k`` known-answer single-set batches as
    ``(sets, expected)`` pairs, invalid-first: the safety-critical lie
    (``False -> True``) is probed before anything else, so even ``k=1``
    catches a stuck-true or flipping device.
    """

    def __init__(self, seed: int = 0, oracle_check: bool = True):
        self.seed = int(seed)
        self.oracle_check = bool(oracle_check)
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def rotate(self, epoch: int) -> None:
        """Advance the corpus to ``epoch`` (regenerates keys + messages)."""
        self._epoch = int(epoch)

    def entries(self, epoch: int | None = None) -> tuple[CanaryEntry, ...]:
        ep = self._epoch if epoch is None else int(epoch)
        key = (self.seed, ep)
        with _CACHE_LOCK:
            cached = _ENTRY_CACHE.get(key)
        if cached is not None:
            return cached
        made = _materialise(self.seed, ep, self.oracle_check)
        with _CACHE_LOCK:
            return _ENTRY_CACHE.setdefault(key, made)

    def batches(self, k: int = DEFAULT_K) -> list[tuple[list, bool]]:
        """``k`` known-answer batches for the current epoch, invalid-first."""
        entries = self.entries()
        invalid = [e for e in entries if not e.expected]
        valid = [e for e in entries if e.expected]
        # Rotate which concrete entries lead so successive epochs probe
        # different corpus rows even at small k.
        off = self._epoch
        ordered = []
        for i in range(max(0, int(k))):
            pool = invalid if i % 2 == 0 and invalid else valid or invalid
            ordered.append(pool[(off + i // 2) % len(pool)])
        return [(list(e.sets), e.expected) for e in ordered]
