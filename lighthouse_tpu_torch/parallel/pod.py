"""Pod-scale verification service: per-shard fault domains over a mesh of seats.

Port of the JAX package's ``parallel/pod.py``.  :class:`PodVerifier`
data-parallel-shards a marshalled signature batch across the mesh's seats
(parallel/mesh.py: one process drives every seat) and keeps the
never-drop-a-batch contract of the single-device ladder while any subset
of the mesh fails underneath it.  Each shard is its own fault domain —
one hung or dying device costs retries and (past a threshold) its mesh
seat, never the batch:

* **sharded program first** — when the backend exposes its raw
  kernel (``local_verify_fn``), the batch runs as ONE rule-partitioned
  program (:mod:`.partition`): the operand tree is placed on the seats
  by its rule table, each seat verifies its batch columns (through the
  backend's keyed program for the seat's batch, ``seat_program``, where
  the backend has it: a CUDA graph on the card), and the per-seat
  verdicts gather into a ``(width,)`` verdict vector on the lead seat — no
  per-shard thread, and a slot-mode batch (``mb.slots``) reads its
  pubkey operand from the mesh-partitioned registry mirror instead of
  carrying it from the host.  A False verdict condemns only that shard's set
  range, so the ladder re-verifies a 1/width slice instead of the whole
  batch.  Any failure of the program (device loss, compile trouble, a
  hang past the sharded deadline) falls back to the per-device
  coordinator below, which still owns health scoring and re-shard.
* **shard planner** — contiguous trailing-axis slices of the marshalled
  batch, one per device.  The mesh width is always a power of two
  (8→4→2→1), so with the backend's power-of-two padded batches every
  shard width is itself a power of two and the per-width programs stay
  inside the existing ≤6-program dispatch budget.
* **per-shard dispatch** — one thread per shard runs the width-sized
  program of its seat's backend (``backend.for_device(seat)``) on its
  slice, under the seat's ``seat_context``; the coordinator enforces a
  per-shard timeout (a hung device leaks its daemon thread, as a hung
  device call would) and retries failed shards with exponential backoff
  on the same seat.  Seats that share a backend share its programs: the
  program's replay lock keeps their concurrent dispatches apart.
* **device health** — consecutive-failure scoring per device
  (:class:`DeviceHealth`, the PeerManager idiom): a device that keeps
  failing is excluded, the batch re-shards onto the surviving mesh, and
  an excluded device is re-armed after a later probe shard succeeds.
* **degradation ladder** — pod → reduced mesh → the single-device
  verifier (``resilient``: anything with ``verify_batch``, ``breaker``
  and ``journal``, injected; ``beacon.processor.ResilientVerifier``) →
  CPU.  The pod shares the resilient verifier's breaker (mesh exhaustion
  is a breaker failure; a completed round is a success), and its
  ``verify_batch`` never raises.

Correctness: the pod only ever short-circuits the all-valid case.  A
completed round whose conjunction is True returns all-True verdicts —
identical to the single-device oracle, because every shard's padding
columns are valid duplicates (the backend marshal contract).  Any shard
verdict of False, any marshal failure, and any mesh exhaustion hand the
*original* sets to ``resilient.verify_batch`` for the unchanged
bisection/CPU ladder, so per-set verdicts are byte-identical to the
oracle under every injected fault.  (A device lying True-for-False is
outside the model, exactly as on the single-device path.)

Chaos: ``pod.dispatch`` fires inside each shard attempt (``shard-drop``
kills the shard, ``device-hang:<s>`` hangs it past the timeout) and
``pod.gather`` fires on the verdict coming back
(``corrupt-shard-result`` inverts it).  Everything runs on the CPU over a
mesh of CPU seats (``make_mesh(8, device="cpu")``).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..beacon.processor import BatchOutcome
from ..obs.tracer import TRACER
from ..utils import metrics as M
from . import mesh as _mesh

log = logging.getLogger("lighthouse_tpu_torch.parallel.pod")


# ---------------------------------------------------------------------------
# Shard planning
# ---------------------------------------------------------------------------


def mesh_width(n_devices: int) -> int:
    """Largest power-of-two mesh that fits on ``n_devices`` (0 when none
    survive) — the 8→4→2→1 degradation ladder's rung selector."""
    if n_devices < 1:
        return 0
    w = 1
    while w * 2 <= n_devices:
        w *= 2
    return w


@dataclass(frozen=True)
class ShardPlan:
    """Contiguous [a, b) ranges over the batch axis, one per shard."""

    shards: int
    bounds: tuple[tuple[int, int], ...]


def plan_shards(total: int, shards: int) -> ShardPlan:
    """Split [0, total) into ``shards`` contiguous near-even ranges.

    With the backend's power-of-two padded batch and a power-of-two mesh
    the ranges are exactly even (and themselves power-of-two wide, which
    is what keeps the per-width program count bounded); ragged totals
    only occur in list-sharding mode, where width is unconstrained.
    Ranges may be empty when ``shards > total`` — callers skip those.
    """
    base, extra = divmod(total, shards)
    bounds = []
    a = 0
    for i in range(shards):
        b = a + base + (1 if i < extra else 0)
        bounds.append((a, b))
        a = b
    return ShardPlan(shards=shards, bounds=tuple(bounds))


def _slice_tree(x, a: int, b: int):
    """Slice the trailing axis of a marshalled-operand tree: LFp-shaped
    leaves (``.limbs``/``.bound``), bare arrays, and nested tuples — the
    same shape contract as the backend's batch slicer, kept local so the
    pod layer does not import the field stack."""
    if hasattr(x, "limbs"):
        return type(x)(x.limbs[..., a:b], x.bound)
    if hasattr(x, "shape"):
        return x[..., a:b]
    if isinstance(x, (tuple, list)):
        return type(x)(_slice_tree(e, a, b) for e in x)
    return x


# ---------------------------------------------------------------------------
# Device health: consecutive-failure scoring, exclusion, probe re-arm
# ---------------------------------------------------------------------------


class DeviceHealth:
    """Per-device consecutive-failure scores (the PeerManager idiom).

    ``exclusion_threshold`` consecutive shard failures pull a device out
    of the mesh; after ``probe_after`` subsequent batches the device
    becomes probe-eligible and a successful probe shard re-arms it.  The
    cooldown is counted in verify_batch calls, not wall time, so tests
    are deterministic without sleeping.
    """

    def __init__(self, n_devices: int, exclusion_threshold: int = 2,
                 probe_after: int = 2):
        self.exclusion_threshold = max(1, exclusion_threshold)
        self.probe_after = max(1, probe_after)
        self._lock = threading.Lock()
        self._failures = [0] * n_devices
        self._excluded: dict[int, int] = {}  # device index -> cooldown left

    def healthy(self) -> list[int]:
        with self._lock:
            return [i for i in range(len(self._failures))
                    if i not in self._excluded]

    def excluded(self) -> list[int]:
        with self._lock:
            return sorted(self._excluded)

    def record_success(self, dev: int) -> None:
        with self._lock:
            self._failures[dev] = 0

    def record_failure(self, dev: int) -> bool:
        """Score one shard failure; True when it crossed the threshold
        and the device was excluded just now."""
        with self._lock:
            if dev in self._excluded:
                return False
            self._failures[dev] += 1
            if self._failures[dev] >= self.exclusion_threshold:
                self._excluded[dev] = self.probe_after
                return True
            return False

    def exclude(self, dev: int) -> bool:
        """Force-exclude (retry budget exhausted); True when newly
        excluded."""
        with self._lock:
            if dev in self._excluded:
                return False
            self._excluded[dev] = self.probe_after
            return True

    def tick(self) -> None:
        """One verify_batch elapsed: age every exclusion cooldown."""
        with self._lock:
            for dev in self._excluded:
                if self._excluded[dev] > 0:
                    self._excluded[dev] -= 1

    def probe_ready(self) -> list[int]:
        with self._lock:
            return sorted(d for d, cd in self._excluded.items() if cd <= 0)

    def defer_probe(self, dev: int) -> None:
        """Failed probe: restart the cooldown."""
        with self._lock:
            if dev in self._excluded:
                self._excluded[dev] = self.probe_after

    def rearm(self, dev: int) -> None:
        with self._lock:
            self._excluded.pop(dev, None)
            self._failures[dev] = 0


# ---------------------------------------------------------------------------
# PodVerifier
# ---------------------------------------------------------------------------


@dataclass
class _PodJob:
    """One batch prepared for sharding: the original sets plus (backend
    mode) the marshalled batch whose trailing axis is the shard axis."""

    sets: list
    mb: Any = None
    total: int = 0


class PodVerifier:
    """Data-parallel batch verification over an N-device mesh with
    per-shard fault domains and the full degradation ladder underneath.

    Two dispatch modes share one coordinator:

    * **backend mode** — ``marshal(sets)`` produces a
      ``MarshalledBatch``; each shard slices the operand tree and runs the
      width-sized program of its seat's backend on it.  This is the
      serving configuration.
    * **list mode** — ``shard_verify(sub_sets) -> bool`` is called per
      shard on a contiguous sublist.  The scenario harness and the CPU
      chaos tests ride this one: same planner, same fault domains, same
      ladder, no kernel compiles.

    Drop-in for every ``verify_batch`` consumer and for a pipelined
    verifier's ``resilient`` slot — ``breaker`` and ``journal`` pass
    through to the wrapped verifier.
    """

    def __init__(
        self,
        resilient,
        backend=None,
        marshal: Callable[[list], Any] | None = None,
        shard_verify: Callable[[list], bool] | None = None,
        devices: list | None = None,
        shard_timeout: float = 2.0,
        max_shard_retries: int = 2,
        backoff_base: float = 0.02,
        exclusion_threshold: int = 2,
        probe_after: int = 2,
        max_rounds: int = 6,
        injector=None,
        sharded: bool = True,
        sharded_marshal: Callable[[list], Any] | None = None,
        registry_provider: Callable | None = None,
        sharded_timeout: float | None = None,
    ):
        if backend is None and shard_verify is None:
            raise ValueError(
                "PodVerifier needs a backend (device mode) or a "
                "shard_verify callable (list mode)"
            )
        self.resilient = resilient
        self.backend = backend
        self.marshal = (
            marshal if marshal is not None
            else getattr(backend, "marshal_sets", None)
        )
        self.shard_verify = shard_verify
        # sharded-program fast path (parallel/partition.py): on unless
        # disabled, engaged only when the backend exposes its raw
        # kernel.  sharded_marshal may defer the pubkey operand to the
        # partitioned registry (mb.slots); registry_provider maps a
        # mesh to that sharded mirror.
        self.sharded = sharded
        self.sharded_marshal = sharded_marshal
        self.registry_provider = registry_provider
        self.sharded_timeout = (
            sharded_timeout if sharded_timeout is not None
            else 4.0 * shard_timeout
        )
        self._sharded_programs: dict = {}
        self.shard_timeout = shard_timeout
        self.max_shard_retries = max(0, max_shard_retries)
        self.backoff_base = backoff_base
        self.exclusion_threshold = exclusion_threshold
        self.probe_after = probe_after
        self.max_rounds = max(1, max_rounds)
        if injector is None:
            from ..utils import faults as _faults

            injector = _faults.INJECTOR
        self.injector = injector
        self._devices = list(devices) if devices is not None else None
        self.health: DeviceHealth | None = None
        self._health_lock = threading.Lock()
        #: an attached integrity guard (the reference's
        #: ``integrity/guard.py``, wired by ``guard.attach_pod``): supplies
        #: canary batches for per-seat probes and receives readmission
        #: notifications
        self.integrity = None

    # -- drop-in ladder surface (PipelinedVerifier's resilient slot) -------

    @property
    def breaker(self):
        return self.resilient.breaker

    @property
    def journal(self):
        return self.resilient.journal

    @classmethod
    def maybe_build(cls, resilient, backend=None, marshal=None, **kw):
        """A :class:`PodVerifier` over every visible CUDA device when two or
        more are visible and the backend exposes the shard surface, else
        None.  Never raises — pod wiring is strictly opportunistic."""
        try:
            if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
                return None
            devices = list(_mesh.make_mesh().seats)
            if backend is None or not hasattr(backend, "_program"):
                return None
            if marshal is None:
                marshal = getattr(backend, "marshal_sets", None)
            if marshal is None:
                return None
            return cls(resilient, backend=backend, marshal=marshal,
                       devices=devices, **kw)
        except Exception as exc:  # noqa: BLE001 — opportunistic wiring
            log.warning("pod wiring unavailable: %s", exc)
            return None

    def devices(self) -> list:
        """The seats (every visible CUDA device unless given)."""
        if self._devices is None:
            self._devices = list(_mesh.make_mesh().seats)
        return self._devices

    def warm_compile(self, batch_sizes, widths=None) -> list:
        """Build, before the pod takes traffic, the seat programs that
        batches of ``batch_sizes`` sets run at each mesh width of ``widths``
        (default: every rung of the ladder, the mesh's width halved down to
        1), on the backend of every seat's device.  A key's first build
        takes tens of seconds on the card, far past ``shard_timeout`` and
        ``sharded_timeout``: met inside a deadline, it times the shard out
        and the healthy seat is excluded.  Returns the ``(device, seat
        batch)`` pairs built or found built; list mode, and a backend
        without ``warm_compile``, warm nothing."""
        backend = self.backend
        if self.shard_verify is not None or not hasattr(backend, "warm_compile"):
            return []
        if widths is None:
            widths, w = [], mesh_width(len(self.devices()))
            while w >= 1:
                widths.append(w)
                w //= 2
        pad = getattr(backend, "_padded_size", lambda n: n)
        warmed = []
        for n in batch_sizes:
            total = pad(n)
            for width in widths:
                sizes = {b - a for a, b in plan_shards(total, width).bounds if b > a}
                for device in dict.fromkeys(self.devices()):
                    seat_backend = (backend.for_device(device)
                                    if hasattr(backend, "for_device") else backend)
                    for size in sorted(sizes):
                        if (device, size) in warmed:
                            continue
                        with _mesh.seat_context(device):
                            if seat_backend.warm_compile(size):
                                warmed.append((device, size))
        return warmed

    # -- entry point (registered in DEFAULT_NEVER_RAISE) -------------------

    def verify_batch(self, sets: list) -> BatchOutcome:
        sets = list(sets)
        if not sets:
            return BatchOutcome(verdicts=[], device_calls=0)
        try:
            with M.VERIFY_BATCH_LATENCY.timer(), TRACER.span(
                    "verify.batch", sets=len(sets)):
                return self._pod_verify(sets)
        except Exception as exc:  # noqa: BLE001 — never-raise backstop
            # The pod coordinator already absorbs shard faults and the
            # ladder below it absorbs device faults; this catches a bug
            # in the coordinator itself.  Fail closed, same contract as
            # the single-device ladder.
            log.error("pod verify_batch backstop caught %s: %s",
                      type(exc).__name__, exc)
            return BatchOutcome(verdicts=[False] * len(sets), device_calls=0)

    # -- coordinator --------------------------------------------------------

    def _ensure_health(self) -> DeviceHealth:
        with self._health_lock:
            if self.health is None:
                self.health = DeviceHealth(
                    len(self.devices()),
                    exclusion_threshold=self.exclusion_threshold,
                    probe_after=self.probe_after,
                )
            return self.health

    def _ladder(self, sets: list) -> BatchOutcome:
        M.POD_FALLBACKS.inc()
        return self.resilient.verify_batch(sets)

    # -- integrity surface (the reference's integrity/guard.py) ------------

    def healthy_devices(self) -> list[int]:
        """Device indices currently in the mesh (guard attribution sweep)."""
        return list(self._ensure_health().healthy())

    def quarantine(self, dev: int) -> bool:
        """Force ``dev`` out of the mesh on an integrity strike.  True
        when this call newly excluded it.  Readmission goes through the
        canary-only probe in :meth:`_probe_excluded` like any exclusion."""
        if self._ensure_health().exclude(dev):
            M.POD_EXCLUSIONS.inc()
            return True
        return False

    def device_canary_probe(self, dev: int) -> bool:
        """Canary-only probe batch on one device: every known-answer
        verdict must match.  Used for SDC attribution (naming the lying
        device) and as the readmission gate for quarantined devices.
        Requires an attached guard; raises propagate to the caller's
        probe fault domain."""
        guard = self.integrity
        if guard is None:
            return True
        for canary_sets, expected in guard.canary_batches():
            job = self._prepare_canary(canary_sets)
            if job is None:
                return False
            got = self._run_shard(job, dev, 0, job.total)
            if bool(got) != expected:
                return False
        return True

    def _prepare_canary(self, canary_sets: list) -> _PodJob | None:
        if self.shard_verify is not None:
            return _PodJob(sets=list(canary_sets), total=len(canary_sets))
        return self._prepare_plain(list(canary_sets))

    def _pod_verify(self, sets: list) -> BatchOutcome:
        health = self._ensure_health()
        health.tick()
        # one breaker gate per batch, shared with the single-device path:
        # while OPEN the whole pod stands down (the ladder routes to CPU),
        # and the half-open probe batch is admitted here exactly once
        if not self.resilient.breaker.allow_device():
            return self._ladder(sets)
        job = self._prepare(sets)
        if job is None:
            return self._ladder(sets)
        outcome = self._try_sharded(job, sets, health)
        if outcome is not None:
            return outcome
        if job.mb is not None and getattr(job.mb, "slots", None) is not None:
            # a slot-mode batch has no host pubkey operand, so the
            # per-device coordinator below cannot slice it: re-marshal
            # through the standard path before taking the threaded road
            job = self._prepare_plain(sets)
            if job is None:
                return self._ladder(sets)
        for round_no in range(1, self.max_rounds + 1):
            healthy = health.healthy()
            width = mesh_width(len(healthy))
            if width < 1:
                break
            M.POD_ACTIVE_SHARDS.set(width)
            with TRACER.span("pod.dispatch", shards=width,
                             sets=len(sets), round=round_no):
                ok = self._run_round(job, healthy[:width], health)
            if ok is None:
                # the round lost shards past their retry budget:
                # re-shard the batch onto the surviving mesh
                M.POD_RESHARDS.inc()
                TRACER.instant("pod.reshard", round=round_no,
                               survivors=len(health.healthy()))
                continue
            self.resilient.breaker.record_success()
            if ok:
                self.resilient.journal.append(("pod", len(sets)))
                self._probe_excluded(job, health)
                return BatchOutcome(
                    verdicts=[True] * len(sets), device_calls=width
                )
            # some shard's conjunction is False: the single-device ladder
            # re-verifies the ORIGINAL sets with bisection attribution,
            # keeping per-set verdicts byte-identical to the oracle
            return self._ladder(sets)
        # surviving mesh exhausted — that is a backend-level failure.
        # Still probe cooled-down devices here: with the WHOLE mesh
        # excluded no round can ever succeed, so without this probe the
        # pod would stay pinned to the ladder forever.
        self.resilient.breaker.record_failure()
        M.POD_ACTIVE_SHARDS.set(0)
        self._probe_excluded(job, health)
        return self._ladder(sets)

    def _prepare(self, sets: list) -> _PodJob | None:
        try:
            if self.shard_verify is not None:
                return _PodJob(sets=sets, total=len(sets))
            marshal = self.marshal
            if self._sharded_enabled() and self.sharded_marshal is not None:
                marshal = self.sharded_marshal
            mb = marshal(sets)
            if mb is None or getattr(mb, "invalid", False):
                return None
            return _PodJob(sets=sets, mb=mb, total=int(mb.B))
        except Exception as exc:  # noqa: BLE001 — marshal is a ladder rung
            log.warning("pod marshal failed, taking the ladder: %s", exc)
            return None

    def _prepare_plain(self, sets: list) -> _PodJob | None:
        """Standard-marshal re-prepare for the threaded coordinator."""
        try:
            mb = self.marshal(sets)
            if mb is None or getattr(mb, "invalid", False):
                return None
            return _PodJob(sets=sets, mb=mb, total=int(mb.B))
        except Exception as exc:  # noqa: BLE001 — marshal is a ladder rung
            log.warning("pod re-marshal failed, taking the ladder: %s", exc)
            return None

    # -- the sharded-program fast path (parallel/partition.py) --------------

    def _sharded_enabled(self) -> bool:
        return (self.sharded and self.shard_verify is None
                and self.backend is not None
                and hasattr(self.backend, "local_verify_fn"))

    def _sharded_program(self, key: tuple):
        # every program built here (full pod, post-exclusion re-shard)
        # stages through ShardedVerifyProgram over the seats in ``key``:
        # the backend's keyed seat programs where it has them (a CUDA graph
        # per seat batch on the card), else its raw kernel run eagerly
        prog = self._sharded_programs.get(key)
        if prog is None:
            from .partition import ShardedVerifyProgram

            mesh = _mesh.Mesh(tuple(self.devices()[i] for i in key))
            pk_wrap = getattr(self.backend, "registry_pk_wrap", None)
            if hasattr(self.backend, "seat_program"):
                prog = ShardedVerifyProgram(mesh, seat_program=self.backend.seat_program,
                                            pk_wrap=pk_wrap)
            else:
                prog = ShardedVerifyProgram(mesh, self.backend.local_verify_fn(),
                                            pk_wrap=pk_wrap)
            self._sharded_programs[key] = prog
        return prog

    def _run_sharded(self, program, mb):
        self.injector.fire("pod.dispatch")
        if getattr(mb, "slots", None) is not None:
            if self.registry_provider is None:
                raise RuntimeError(
                    "slot-mode batch without a registry provider")
            registry = self.registry_provider(program.mesh)
            return program.verdict_vector_registry(
                registry, mb.slots, mb.args)
        return program.verdict_vector(mb.args)

    def _try_sharded(self, job: _PodJob, sets: list,
                     health: DeviceHealth) -> BatchOutcome | None:
        """One rule-partitioned SPMD dispatch over the healthy mesh.
        Returns the outcome, or None to fall back to the per-device
        coordinator (program raised, timed out, or mesh too small).
        The program call runs on a daemon worker under
        ``sharded_timeout`` so a hung device costs this path its turn,
        never the batch — the same leak-a-thread economics as a hung
        per-device shard."""
        if not self._sharded_enabled() or job.mb is None:
            return None
        healthy = health.healthy()
        width = mesh_width(len(healthy))
        if width < 2:
            return None
        key = tuple(healthy[:width])
        result: dict = {}

        def run() -> None:
            try:
                program = self._sharded_program(key)
                result["verdicts"] = self._run_sharded(program, job.mb)
                result["bounds"] = program.shard_bounds(job.total)
            except Exception as exc:  # noqa: BLE001 — program fault domain
                result["error"] = exc

        M.POD_ACTIVE_SHARDS.set(width)
        with TRACER.span("pod.dispatch", shards=width, sets=len(sets),
                         round=0, sharded=True):
            worker = threading.Thread(target=run, daemon=True,
                                      name="pod-sharded")
            worker.start()
            worker.join(self.sharded_timeout)
        if "verdicts" not in result:
            err = result.get("error")
            log.warning(
                "pod sharded program %s; falling back to per-device "
                "dispatch: %s",
                "failed" if err is not None else "timed out", err)
            return None
        try:
            verdicts = [
                bool(self.injector.fire("pod.gather", bool(v)))
                for v in result["verdicts"]
            ]
        except Exception as exc:  # noqa: BLE001 — chaos gather domain
            log.warning("pod sharded gather failed: %s", exc)
            return None
        self.resilient.breaker.record_success()
        n = len(sets)
        if all(verdicts):
            self.resilient.journal.append(("pod", n))
            self._probe_excluded(job, health)
            return BatchOutcome(verdicts=[True] * n, device_calls=width)
        # Partial fallback: a shard verdict covers exactly its column
        # range, so only failing shards' sets need the single-device
        # bisection ladder — 1/width of the batch per bad shard instead
        # of all of it.  Padding columns are duplicates of set 0, so a
        # padding-only failing shard implicates set 0 (whose own shard
        # fails too; adding it is belt and braces, never wrong).
        suspect: set[int] = set()
        for sid, ok in enumerate(verdicts):
            if ok:
                continue
            a, b = result["bounds"][sid]
            idxs = range(a, min(b, n))
            if not idxs:
                suspect.add(0)
            suspect.update(idxs)
        order = sorted(suspect)
        sub = self._ladder([sets[i] for i in order])
        merged = [True] * n
        for j, i in enumerate(order):
            merged[i] = bool(sub.verdicts[j])
        return BatchOutcome(verdicts=merged,
                            device_calls=width + sub.device_calls)

    def _run_round(self, job: _PodJob, device_indices: list[int],
                   health: DeviceHealth) -> bool | None:
        """One dispatch round on a fixed mesh.  True/False: every shard
        resolved and this is the conjunction.  None: the round failed
        (device newly excluded or retries exhausted) — re-shard."""
        plan = plan_shards(job.total, len(device_indices))
        pending = [
            (sid, dev, a, b)
            for sid, (dev, (a, b)) in enumerate(
                zip(device_indices, plan.bounds))
            if b > a
        ]
        verdicts: dict[int, bool] = {}
        for attempt in range(self.max_shard_retries + 1):
            if attempt:
                M.POD_RETRIES.inc(len(pending))
                time.sleep(self.backoff_base * (2 ** (attempt - 1)))
            results = self._attempt(job, pending)
            still, dead = [], False
            for sid, dev, a, b in pending:
                res = results.get(sid)
                if res is None:  # shard raised or timed out
                    if health.record_failure(dev):
                        M.POD_EXCLUSIONS.inc()
                        dead = True
                    still.append((sid, dev, a, b))
                else:
                    health.record_success(dev)
                    verdicts[sid] = bool(res)
            pending = still
            if dead:
                return None  # a device left the mesh: re-plan, don't retry
            if not pending:
                return all(verdicts.values()) if verdicts else True
        # retries exhausted with shards outstanding: pull their devices
        # from the mesh so the next round shrinks instead of repeating
        for _sid, dev, _a, _b in pending:
            if health.exclude(dev):
                M.POD_EXCLUSIONS.inc()
        return None

    def _attempt(self, job: _PodJob, pending: list) -> dict[int, bool]:
        """Run every pending shard concurrently, one thread per shard,
        under one wall-clock deadline.  A shard that raises or outlives
        the deadline simply has no entry in the result map; its thread
        is a daemon and leaks if truly hung — the same cost as a hung
        device call, paid per shard instead of per batch."""
        results: dict[int, bool] = {}
        lock = threading.Lock()

        def run(sid: int, dev: int, a: int, b: int) -> None:
            try:
                ok = self._run_shard(job, dev, a, b)
            except Exception as exc:  # noqa: BLE001 — shard fault domain
                log.warning("pod shard %d (device %d, [%d:%d)) failed: %s",
                            sid, dev, a, b, exc)
                return
            with lock:
                results[sid] = ok

        threads = [
            threading.Thread(target=run, args=jb, daemon=True,
                             name=f"pod-shard-{jb[0]}")
            for jb in pending
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.shard_timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with lock:
            return dict(results)

    def _run_shard(self, job: _PodJob, dev: int, a: int, b: int) -> bool:
        self.injector.fire("pod.dispatch")
        if self.shard_verify is not None:
            ok = bool(self.shard_verify(job.sets[a:b]))
        else:
            ok = self._run_device_shard(job.mb, dev, a, b)
        return bool(self.injector.fire("pod.gather", ok))

    def _run_device_shard(self, mb, dev: int, a: int, b: int) -> bool:
        device = self.devices()[dev]
        args = tuple(_slice_tree(x, a, b) for x in mb.args)
        backend = self.backend
        if hasattr(backend, "for_device"):
            backend = backend.for_device(device)
        with _mesh.seat_context(device):
            ready = getattr(mb, "ready", None)
            if ready is not None:
                # operands gathered on a card at marshal time: this seat's
                # stream waits for the gather
                torch.cuda.current_stream(device).wait_event(ready)
            handle = backend._program(b - a)(*args)
            resolve = getattr(backend, "resolve", None)
            return bool(resolve(handle)) if resolve is not None else bool(handle)

    def _probe_excluded(self, job: _PodJob, health: DeviceHealth) -> None:
        """After a healthy round: one probe shard per cooled-down
        excluded device; success re-arms it into the mesh.  Probe
        failures only restart the cooldown — they never affect the
        batch's verdict (the caller already has it)."""
        ready = health.probe_ready()
        if not ready:
            return
        width = max(1, job.total // mesh_width(len(self.devices())))
        for dev in ready:
            try:
                if self.integrity is not None:
                    # readmission requires the canary-only probe: the
                    # device must produce *correct* known-answer verdicts,
                    # not merely survive a dispatch
                    if not self.device_canary_probe(dev):
                        log.info("pod canary probe on device %d failed", dev)
                        health.defer_probe(dev)
                        continue
                else:
                    self._run_shard(job, dev, 0, min(job.total, width))
            except Exception as exc:  # noqa: BLE001 — probe fault domain
                log.info("pod probe on device %d failed: %s", dev, exc)
                health.defer_probe(dev)
                continue
            health.rearm(dev)
            M.POD_REARMS.inc()
            if self.integrity is not None:
                self.integrity.readmit(dev)
            log.info("pod device %d re-armed after probe", dev)
