"""Boot-time known-answer selfcheck.

The port's counterpart of the JAX package's ``integrity/selfcheck.py``: the
canary corpus through every verify program the active backend holds, the
boot-time twin of the runtime canary layer, pairing with prewarm (prewarm
builds the keys, the selfcheck proves each still tells the truth before the
process serves a verdict).  Any mismatch is a failure the caller acts on.

The programs are ``TorchBackend._programs``, keyed ``(B, device_h2c, mxu,
chains, wsm)`` for a batch verify, ``("agg", n, mxu, chains, wsm)`` for an
aggregate verify and ``("epoch", B, positions, mxu, chains, wsm)`` for the
epoch batch.  Each verify key is replayed as it is — its own batch size
and its own arm (``TorchBackend.dispatch`` under ``fp.pinned_arm``), the
canary tiled across its columns — so no key is built and no key is left
out.
The aggregate and epoch keys take other operands than a signature set; they
are listed in ``SelfcheckReport.skipped`` and not run.  (The reference reads
a ``_kernels`` table and takes the ``n`` of an ``("agg", n)`` key for a
verify batch size, which checks a verify key, and on first use builds one,
instead of the aggregate program it found.)
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..crypto.bls import api as _bls_api
from ..obs.tracer import TRACER
from .corpus import CanaryCorpus

log = logging.getLogger(__name__)


@dataclass
class SelfcheckReport:
    """Outcome of one known-answer sweep."""

    checked: int = 0
    batch_sizes: tuple = ()
    keys: tuple = ()  # the verify keys run, each under its own arm
    skipped: tuple = ()  # program keys held but not run (aggregate, epoch)
    mismatches: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


def _is_verify_key(key) -> bool:
    return isinstance(key, tuple) and len(key) == 5 and isinstance(key[0], int)


def installed_keys(backend) -> tuple[list, list]:
    """(verify keys, other keys) of the programs ``backend`` holds."""
    programs = getattr(backend, "_programs", None) or {}
    keys = list(programs)
    verify = sorted((k for k in keys if _is_verify_key(k)), key=lambda k: (k[0], k[1:]))
    other = sorted((k for k in keys if not _is_verify_key(k)), key=str)
    return verify, other


def _batch_at(backend, sets: list, B: int):
    """The canary ``sets`` marshalled as a batch of padded size ``B``: one
    marshal, tiled across the columns where the backend can
    (``TorchBackend.tile_batch``), else the reference's tiling of the sets."""
    tile = getattr(backend, "tile_batch", None)
    if tile is not None:
        mb = backend.marshal_sets(list(sets))
        return mb if getattr(mb, "invalid", False) else tile(mb, B)
    return backend.marshal_sets(list(sets) * B)


def run_selfcheck(backend=None, *, corpus=None, epoch: int = 0) -> SelfcheckReport:
    """Verify every canary entry on the backend's own batch path and on each
    verify program key it holds (the active backend by default)."""
    be = backend if backend is not None else _bls_api.get_backend()
    cc = corpus if corpus is not None else CanaryCorpus()
    cc.rotate(epoch)
    report = SelfcheckReport()
    with TRACER.span("integrity.selfcheck", backend=getattr(be, "name", "?")):
        entries = cc.entries()
        # the backend's own batch path first: whatever the backend, a canary
        # must round-trip through verify_signature_sets correctly
        for e in entries:
            got = bool(be.verify_signature_sets(list(e.sets)))
            report.checked += 1
            if got != e.expected:
                report.mismatches.append(
                    f"scalar path: canary {e.entry_id!r} expected {e.expected}, got {got}")
        keys, other = installed_keys(be)
        report.keys = tuple(keys)
        report.skipped = tuple(other)
        report.batch_sizes = tuple(sorted({k[0] for k in keys}))
        if getattr(be, "marshal_sets", None) is None or not keys:
            return report
        from ..crypto.bls.torch_backend import fp as F

        for key in keys:
            B, _h2c, mxu, chains, wsm = key
            for e in entries:
                mb = _batch_at(be, e.sets, B)
                report.checked += 1
                if getattr(mb, "invalid", False):
                    if e.expected:
                        report.mismatches.append(
                            f"kernel B={B} {key}: canary {e.entry_id!r} rejected at marshal "
                            "time but expected valid")
                    continue
                with F.pinned_arm(chains, wsm, mxu):
                    got = bool(be.resolve(be.dispatch(mb)))
                if got != e.expected:
                    report.mismatches.append(
                        f"kernel B={B} {key}: canary {e.entry_id!r} expected {e.expected}, "
                        f"got {got}")
    for line in report.mismatches:
        log.error("selfcheck mismatch: %s", line)
    return report
