"""Per-device kernel autotuner: measured arm x batch-shape plans.

Port of jax_backend/autotune.py.  The backend has two proven Montgomery
product arms — the 26 x 15-bit plane (kernel 1, ``mont_kernel``) and the
31 x 13-bit plane on the tensor cores (kernel 7, ``mxu_kernel``) — and
without a plan the serving path picks one by ``LIGHTHOUSE_TPU_MXU`` or
``fp.set_mxu``.  The tuner turns that guess into a measurement:

1. **Arm registry** (``ARM_TABLE``): arm id -> limb plane, ``fp`` routing
   toggle, toggle value, and the RANGE_REPORT.json program whose clearance
   the arm requires.  The same literal as the reference's.  The chain and
   WSM gates are not rows: the reference's table has none, and the plan
   routes only the product plane.
2. **Legality gate** (``proven_arms``): an arm may enter trials only if its
   proof program is range-proven (``contracts_ok``) in the repository's
   RANGE_REPORT.json at zero range-family waivers in the analyzer's
   waivers.toml; both are read as data files.  Unproven arms never run.
3. **Trial harness** (``trial``): the arm's routed ``mont_mul`` at ``batch``
   lanes on identical operands for every arm.  On the card it is timed with
   CUDA events around a run of back-to-back launches queued while the card
   sleeps, since one launch of either kernel (about 5-6 microseconds at
   4,096 lanes on an H100) is shorter than a host timer's launch and
   synchronize overhead; with an injected ``timer`` (the CPU tests) it is a
   host timing of one call, best of ``iters``.
4. **Plan** (``tune`` / ``tune_and_store``): per batch shape, the winning arm
   and its trial timings, keyed by the device's name, the torch and CUDA
   versions and ``_build.source_hash()`` (the kernel sources whose times the
   plan holds: the counterpart of the reference's jax version), persisted in
   the AOT store's signed manifest (``AotStore.write_plan``).  ``prewarm``
   installs the plan before it builds any key (``install_plan`` ->
   ``fp.install_mxu_plan``), so the arm is resolved when a key is made:
   nothing is tried online and no batch pays for the routing.

Override precedence (``fp.mxu_enabled``): ``fp.set_mxu`` > the
``LIGHTHOUSE_TPU_MXU`` env flag > the installed plan > off.
"""

from __future__ import annotations

import fnmatch
import functools
import json
import logging
import time
import tomllib
from dataclasses import dataclass

import torch

from ....utils import device_kind
from . import _build

log = logging.getLogger("lighthouse_tpu_torch.autotune")

# ---------------------------------------------------------------------------
# Arm registry.  Pure literal, the reference's: (arm id, LimbSpec name in the
# reference's limbs.py, fp routing toggle, toggle value, RANGE_REPORT.json
# program the arm's legality rides on; "" marks an arm that may never enter
# trials).
# ---------------------------------------------------------------------------

ARM_TABLE = (
    ("vpu15", "SPEC15", "set_mxu", False, "pallas_mont_mul"),
    ("mxu13", "SPEC13", "set_mxu", True, "mxu_mont_mul"),
)

PLAN_SCHEMA = 1

# Default batch-shape ladders (the reference's TPU_SHAPES and CPU_SHAPES):
# the padded sizes the serving path dispatches on the card (the headline
# ladder), two cheap shapes on the CPU.
CARD_SHAPES = (512, 4096, 8192)
CPU_SHAPES = (64, 128)

TRIAL_LAUNCHES = 50  # back-to-back launches per timed window on the card
_SLEEP_CYCLES = 50_000_000  # ~25 ms at 1980 MHz: the card waits while the host queues


@dataclass(frozen=True)
class Arm:
    """One kernel arm: a routed limb plane plus its range-proof bond."""

    arm: str      # registry id ("vpu15", "mxu13", ...)
    spec: str     # LimbSpec name in the reference's limbs.py
    toggle: str   # fp.py routing setter read when a program is made
    value: bool   # what the toggle must hold while this arm runs
    proof: str    # RANGE_REPORT.json program name; "" = unproven


ARMS: tuple[Arm, ...] = tuple(Arm(*row) for row in ARM_TABLE)


def arm_by_id(arm_id: str) -> Arm | None:
    for a in ARMS:
        if a.arm == arm_id:
            return a
    return None


# ---------------------------------------------------------------------------
# Legality: range-proven at zero waivers.
# ---------------------------------------------------------------------------

_REPO_ROOT = _build.PKG_ROOT.parent
RANGE_REPORT_PATH = str(_REPO_ROOT / "RANGE_REPORT.json")
WAIVERS_PATH = str(_REPO_ROOT / "lighthouse_tpu" / "analysis" / "waivers.toml")

_RANGE_RULES = ("range-overflow", "range-contract", "range-lfp", "range-report")


def _range_waiver_count(waivers_path: str) -> int:
    """Number of range-family waivers on file (``[[waiver]]`` tables whose
    ``rule`` pattern matches a range rule).  Any > 0 voids every arm's
    clearance: "proven at zero waivers" is the legality bar.  A file that
    does not parse raises ValueError."""
    try:
        with open(waivers_path, "rb") as f:
            doc = tomllib.load(f)
    except FileNotFoundError:
        return 0
    waivers = doc.get("waiver", [])
    if not isinstance(waivers, list):
        raise ValueError(f"{waivers_path}: 'waiver' is not an array of tables")
    return sum(1 for w in waivers
               if isinstance(w, dict) and isinstance(w.get("rule"), str)
               and any(fnmatch.fnmatchcase(rule, w["rule"]) for rule in _RANGE_RULES))


def proven_arms(report_path: str = RANGE_REPORT_PATH,
                waivers_path: str = WAIVERS_PATH) -> tuple[Arm, ...]:
    """The arms legal to tune: proof program present in RANGE_REPORT.json
    with ``contracts_ok`` true, and zero range-family waivers on file (a
    waivers file that does not parse proves nothing).  An arm with no proof
    program (``proof == ""``) is never legal."""
    try:
        with open(report_path, encoding="utf-8") as f:
            programs = json.load(f).get("programs", {})
        if _range_waiver_count(waivers_path):
            return ()
    except (OSError, ValueError):
        return ()
    out = []
    for arm in ARMS:
        if not arm.proof:
            continue
        prog = programs.get(arm.proof)
        if isinstance(prog, dict) and prog.get("contracts_ok") is True:
            out.append(arm)
    return tuple(out)


# ---------------------------------------------------------------------------
# Trial harness
# ---------------------------------------------------------------------------


def trial(arm: Arm, batch: int, *, iters: int = 3, timer=None) -> float:
    """Best-of-``iters`` seconds for one routed Montgomery product
    (``mont_kernel.mont_mul`` or ``mxu_kernel.mont_mul_mxu``, as the arm's
    toggle routes it) at ``batch`` lanes.  Identical seeded operands (quasi
    limbs in [0, 2^15)) for every arm, so timings compare across the
    registry.  With ``timer`` (a clock in seconds) each window is one call,
    synchronized on the card; without, on the card, each window is
    TRIAL_LAUNCHES back-to-back launches between two CUDA events, queued
    while the card sleeps, divided by TRIAL_LAUNCHES.  On the CPU (where no
    card is visible) the wrappers run their plain versions.  The arm's
    toggle is held around the warm-up and the windows and restored
    exactly."""
    import numpy as np

    from ....obs.tracer import TRACER
    from . import fp as F
    from . import mont_kernel as MK
    from . import mxu_kernel as X

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rng = np.random.default_rng(0xA17)
    a, b = (torch.as_tensor(rng.integers(0, 1 << 15, size=(F.N, batch), dtype=np.int32),
                            device=device) for _ in range(2))
    cuda = device.type == "cuda"
    if timer is None and not cuda:
        timer = time.perf_counter
    setter = getattr(F, arm.toggle)
    prev = setter(arm.value)
    try:
        def call():
            return (X.mont_mul_mxu if F.mxu_active() else MK.mont_mul)(a, b)

        call()  # builds and loads the kernel outside the timed windows
        if cuda:
            torch.cuda.synchronize(device)
        best = float("inf")
        with TRACER.span("autotune.trial", arm=arm.arm, batch=batch):
            for _ in range(max(1, iters)):
                if timer is not None:
                    t0 = timer()
                    call()
                    if cuda:
                        torch.cuda.synchronize(device)
                    best = min(best, timer() - t0)
                    continue
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_SLEEP_CYCLES)
                start.record()
                for _ in range(TRIAL_LAUNCHES):
                    call()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3 / TRIAL_LAUNCHES)
    finally:
        setter(prev)
    return best


# ---------------------------------------------------------------------------
# The tuner: trials -> plan -> persist/install.
# ---------------------------------------------------------------------------


def default_shapes() -> tuple[int, ...]:
    return CARD_SHAPES if torch.cuda.is_available() else CPU_SHAPES


def _identity() -> dict:
    """What a plan binds to: the device, the torch and CUDA versions and the
    kernel sources."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device_kind": device_kind(), "source_hash": _build.source_hash()}


def tune(shapes=None, *, arms=None, measure=None, iters: int = 3, timer=None,
         kernel: str = "_verify_kernel") -> dict:
    """Run timed trials of every legal arm across the batch-shape ladder and
    return the winning plan (not yet persisted — see ``tune_and_store``).
    ``measure(arm, batch) -> seconds`` is injectable for deterministic tests;
    the default is ``trial`` with the given ``iters`` and ``timer``.  Arms
    passed explicitly are still filtered through the legality gate: an
    unproven arm never enters trials."""
    legal = proven_arms()
    if arms is not None:
        allowed = {a.arm for a in legal}
        legal = tuple(a for a in arms if a.arm in allowed and a.proof)
    if not legal:
        raise ValueError("no range-proven arms to tune over")
    if shapes is None:
        shapes = default_shapes()
    if measure is None:
        measure = functools.partial(trial, iters=iters, timer=timer)
    plan: dict = {"schema": PLAN_SCHEMA, **_identity(), "shapes": {}}
    for batch in shapes:
        trials = {arm.arm: float(measure(arm, int(batch))) for arm in legal}
        winner = min(trials, key=lambda k: (trials[k], k))
        plan["shapes"][str(int(batch))] = {
            "arm": winner,
            "kernel": kernel,
            "trials_ms": {k: round(v * 1e3, 6) for k, v in trials.items()},
        }
        log.info("autotune trial: batch=%d winner=%s trials_ms=%s", int(batch), winner,
                 plan["shapes"][str(int(batch))]["trials_ms"])
    return plan


def tune_and_store(store, **tune_kw) -> dict:
    """Tune, persist the plan into ``store``'s signed manifest, and install
    it in-process.  The next ``prewarm`` against the same store (same
    device, versions and kernel sources) installs it again with no trial."""
    plan = tune(**tune_kw)
    store.write_plan(plan)
    install_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# Plan install: resolve the plan into fp's per-shape routing map.
# ---------------------------------------------------------------------------


def plan_current(plan: dict) -> bool:
    """A plan binds only on the exact device, torch and CUDA versions and
    kernel sources it was measured on; anything else behaves cold."""
    return (isinstance(plan, dict) and plan.get("schema") == PLAN_SCHEMA
            and all(plan.get(k) == v for k, v in _identity().items())
            and isinstance(plan.get("shapes"), dict))


def install_plan(plan: dict) -> int:
    """Install a tuned plan into ``fp``'s routing map.  Returns the number
    of shapes installed (0 = stale or invalid plan, nothing installed, boot
    behaves cold).  The largest tuned shape's arm also becomes the ``"*"``
    default, so programs of other sizes follow the headline arm."""
    from . import fp as F

    if not plan_current(plan):
        return 0
    shapes: dict = {}
    for key, entry in plan["shapes"].items():
        try:
            batch = int(key)
        except (TypeError, ValueError):
            continue
        arm = arm_by_id(entry.get("arm", "")) if isinstance(entry, dict) else None
        if arm is None or arm.toggle != "set_mxu" or not arm.proof:
            continue
        shapes[batch] = bool(arm.value)
    if not shapes:
        return 0
    shapes["*"] = shapes[max(k for k in shapes if isinstance(k, int))]
    F.install_mxu_plan(shapes)
    log.info("autotune plan installed: shapes=%d device_kind=%s", len(shapes) - 1,
             plan.get("device_kind"))
    return len(shapes) - 1


def clear_plan() -> None:
    """Drop any installed plan (``fp`` falls back to env/default)."""
    from . import fp as F

    F.install_mxu_plan(None)
