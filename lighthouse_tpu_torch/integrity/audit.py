"""Cross-arm audit sampler.

The port's counterpart of the JAX package's ``integrity/audit.py``: a second
opinion on verdicts the pipeline already accepted.  A sampled fraction of
batches is re-verified on an *independent* implementation and the per-set
verdict vectors are byte-compared.  Independence comes from the autotuner's
``ARM_TABLE`` (torch_backend/autotune.py) — a batch verified under the
``vpu15`` arm (kernel 1, the 15-bit plane) is audited under ``mxu13``
(kernel 7 and the 13-bit Miller steps) — with the scalar CPU oracle as the
unconditional floor when no device arm is available (or the arm itself
fails).  Any disagreement is a silent-data-corruption event; the guard, not
the auditor, decides what to do about it.

Where the reference flips the arm's process-wide toggle around
``verify_signature_sets`` (audit.py:83-97), the port runs the batch through
the other arm's program key: ``TorchBackend.dispatch`` under
``fp.pinned_arm``, which holds the arm on this thread only, so a dispatch
running at the same time on another thread — a pod shard, the serve pump —
keeps its own arm.  On the card the first audit under an arm builds that arm's key
for the batch's padded size (tens of seconds; build it before traffic).

Per-set attribution on an AND-reduced backend reuses
``verify_with_bisection`` so the reference vector has the same shape and
semantics as the pipeline's own verdicts.
"""

from __future__ import annotations

import logging
import random

from ..beacon.processor import verify_with_bisection
from ..obs.tracer import TRACER

log = logging.getLogger(__name__)

# an arm's fp routing toggle -> its place in (chains, wsm, mxu)
_TOGGLE_SLOT = {"set_chains": 0, "set_wsm": 1, "set_mxu": 2}


def arm_gates(arm_id: str, batch: int) -> tuple:
    """(chains, wsm, mxu) for a verify of padded ``batch`` under the
    autotuner arm ``arm_id``: the gates in force for that batch, with the
    arm's toggle held at the arm's value."""
    from ..crypto.bls.torch_backend import autotune
    from ..crypto.bls.torch_backend import fp as F

    arm = autotune.arm_by_id(arm_id)
    if arm is None:
        raise KeyError(f"unknown arm {arm_id!r}")
    gates = [F.chains_active(), F.wsm_fused_active(), F.mxu_for_batch(batch)]
    gates[_TOGGLE_SLOT[arm.toggle]] = bool(arm.value)
    return tuple(gates)


def arm_verify(backend, sets, arm_id: str) -> bool:
    """The batch conjunction of ``sets`` through ``backend``'s program key
    of arm ``arm_id``: the marshal, then the replay of that key, pinned.
    Fires ``bls.device_verify`` as ``verify_signature_sets`` does."""
    from ..crypto.bls.torch_backend import fp as F
    from ..utils import faults

    faults.fire("bls.device_verify")
    mb = backend.marshal_sets(list(sets))
    if getattr(mb, "invalid", False):
        return False
    with F.pinned_arm(*arm_gates(arm_id, mb.B)):
        return bool(backend.resolve(backend.dispatch(mb)))


class CrossArmAuditor:
    """Sampled re-verification of accepted batches on an independent arm.

    Parameters
    ----------
    cpu_verify:
        ``sets -> bool`` scalar-oracle conjunction; the audit floor.
    backend:
        Optional device backend used for arm audits (needs ``marshal_sets``,
        ``dispatch`` and ``resolve``: ``TorchBackend``).
    arms:
        Tuple of autotuner arm ids (e.g. ``("vpu15", "mxu13")``) to rotate
        through, first to last.  Empty means CPU-floor only.
    fraction:
        Probability a given accepted batch is audited.  ``1.0`` audits
        everything; ``0.0`` disables.
    """

    def __init__(self, cpu_verify, *, backend=None, arms=(), fraction=0.0, rng=None):
        self.cpu_verify = cpu_verify
        self.backend = backend
        self.arms = tuple(arms)
        self.fraction = float(fraction)
        self.rng = rng or random.Random(0x5DC0)
        self._arm_rr = 0

    def maybe_audit(self, sets) -> tuple[list[bool], str] | None:
        """Sample this batch; return ``(reference_verdicts, mode)`` or None."""
        if self.fraction <= 0.0:
            return None
        if self.fraction < 1.0 and self.rng.random() >= self.fraction:
            return None
        with TRACER.span("integrity.audit", n=len(sets)) as sp:
            ref, mode = self.reference_verdicts(sets)
            sp.add(mode=mode)
            return ref, mode

    def reference_verdicts(self, sets) -> tuple[list[bool], str]:
        """Independent per-set verdicts: device arm first, CPU floor last."""
        sets = list(sets)
        if self.backend is not None and self.arms:
            try:
                return self._arm_verdicts(sets)
            except Exception:
                log.warning("cross-arm audit fell back to the CPU oracle floor", exc_info=True)
        out = verify_with_bisection(lambda ss: bool(self.cpu_verify(list(ss))), sets)
        return list(out.verdicts), "cpu"

    def _arm_verdicts(self, sets) -> tuple[list[bool], str]:
        arm_id = self.arms[self._arm_rr % len(self.arms)]
        self._arm_rr += 1
        out = verify_with_bisection(lambda ss: arm_verify(self.backend, ss, arm_id), sets)
        return list(out.verdicts), arm_id
