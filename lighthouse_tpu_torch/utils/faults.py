"""FaultInjector: named sites where tests and operators inject failures.

The port's own copy of the part of the JAX package's ``utils/faults.py``
that its sites need.  A site is a string; code on a hot path calls
``fire(site)`` there (or ``fire(site, payload)`` where a verdict passes),
which is a no-op (one dict lookup) unless a fault is armed at the site.
The port's sites:

  ``bls.device_verify``  the head of ``TorchBackend.verify_signature_sets``,
                         before the marshal: device errors, hung devices
  ``ingest.marshal``     the head of ``IngestEngine.marshal_sets`` and
                         ``marshal_for_mesh`` (ingest/engine.py): a failed
                         vectorized marshal, which degrades to the scalar one
  ``pod.dispatch``       ``PodVerifier``'s per-shard dispatch and its sharded
                         program's dispatch (parallel/pod.py): shard loss,
                         hung seats mid-batch
  ``pod.gather``         ``PodVerifier``'s per-shard verdict on its way back,
                         fired with the verdict as payload: corrupted results
  ``processor.enqueue``  ``BeaconProcessor.try_send`` (beacon/processor.py),
                         read with ``check``: a forced queue overflow
  ``processor.verify``   the device call of ``ResilientVerifier`` and every
                         dispatch of ``PipelinedVerifier``: device errors
  ``serve.submit``       ``VerifyService`` ingress, fired with the submission
                         payload (serve/service.py): slow or garbage clients
  ``serve.dispatch``     ``VerifyService``'s device-batch dispatch: an
                         infrastructure failure under a full batch
  ``executor.task.<name>``
                         each (re)start of a supervised task
                         (utils/executor.py)
  ``store.open``         ``SlabStore`` open (store/kv.py): disk gone at start
  ``store.put``          each ``SlabStore`` append: I/O errors and torn writes
  ``store.flush``        ``SlabStore`` fsync: a failed durability point
  ``sync.request``       ``SyncManager``'s decoded chunk list (beacon/sync.py)
  ``gossip.route``       each delivery of the simulator's gossip mesh
                         (beacon/simulator.py): lossy or bit-flipping hops

Fault kinds:

* ``error``        raise :class:`DeviceFault` (an infrastructure failure,
                   not a signature verdict)
* ``crash``        raise :class:`InjectedCrash` (task death)
* ``slow``, ``stall``, ``device-hang``
                   sleep ``delay`` seconds, then pass
* ``shard-drop``   raise :class:`DeviceFault`: the seat behind this shard went
                   away mid-batch
* ``corrupt-shard-result``
                   apply ``mutate`` to the payload, by default inverting a
                   shard verdict; the spec argument ``:stuck-true`` selects
                   the targeted ``False -> True`` lie instead
* ``silent-stuck-true``
                   force a boolean verdict payload to True (anything else
                   passes untouched); it never raises
* ``silent-flip``  invert a boolean verdict payload (anything else passes
                   untouched); it never raises.  Only a site that carries
                   its verdict as payload can be lied through:
                   ``pod.gather`` does, ``bls.device_verify`` fires before
                   the marshal with no payload (as in the reference), so
                   there the kind passes every verdict untouched
* ``slow-client``  sleep ``delay`` seconds, then pass: a client dribbling
                   its submission in
* ``malformed-request``
                   apply ``mutate`` to the payload, by default stripping the
                   ``sets`` field of a submission dict (any other payload
                   becomes None): a client sending garbage
* ``overflow``     ``check(site)`` reports the site saturated; ``fire`` is a
                   no-op for it
* ``corrupt``      apply ``mutate`` to the payload (unchanged without one)
* ``io-error``     raise :class:`StorageFault` (an ``OSError``): the disk
                   failed the operation
* ``torn-write``   raise :class:`TornWrite` carrying ``fraction``: the site
                   appends only that share of the framed record, then fails
* ``drop``         raise :class:`NetworkFault`: the request or response
                   vanishes on the wire
* ``corrupt-chunk``, ``wrong-blocks``, ``extra-blocks``
                   a req/resp chunk list with one byte flipped mid-payload of
                   its last chunk, reversed, or with its last chunk twice

``times=N`` disarms a site after N firings; ``probability`` gates each
firing on a draw from the injector's own stream (``FaultInjector(seed=N)``
makes two identically armed injectors fire the same sequence).  Every
firing is counted in ``injected`` and logged in order in ``fired`` as
``(site, kind)``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable


class FaultError(RuntimeError):
    """Base class of every injected infrastructure failure."""


class DeviceFault(FaultError):
    """Injected device failure (the card went away mid-batch)."""


class InjectedCrash(FaultError):
    """Injected task death."""


class StorageFault(FaultError, OSError):
    """Injected storage I/O failure (also an OSError so generic disk-error
    handlers catch it)."""


class TornWrite(FaultError):
    """Injected torn write: the armed site must append only ``fraction`` of
    the framed record — exactly what a SIGKILL mid-``fwrite`` leaves on
    disk — and then fail the operation as a crash would."""

    def __init__(self, msg: str = "injected torn write", fraction: float = 0.5):
        super().__init__(msg)
        self.fraction = fraction


class NetworkFault(FaultError):
    """Injected network loss: the request or response never arrives."""


def _stuck_true(ok):
    """The targeted ``False -> True`` verdict lie (the wrong accept)."""
    return True if isinstance(ok, bool) else ok


def _silent_flip(ok):
    """Invert a boolean verdict payload; anything else passes through."""
    return (not ok) if isinstance(ok, bool) else ok


def _flip_mid_byte(b: bytes) -> bytes:
    if not b:
        return b
    mid = len(b) // 2
    return b[:mid] + bytes([b[mid] ^ 0xFF]) + b[mid + 1:]


def _corrupt_last_chunk(chunks):
    chunks = list(chunks)
    if chunks:
        last = chunks[-1]
        if isinstance(last, tuple):
            code, payload = last
            chunks[-1] = (code, _flip_mid_byte(payload))
        else:
            chunks[-1] = _flip_mid_byte(last)
    return chunks


def _malform_submission(payload):
    """Strip the ``sets`` field of a submission dict; any other payload
    shape becomes None."""
    if isinstance(payload, dict):
        bad = dict(payload)
        bad.pop("sets", None)
        return bad
    return None


_RAISING = {"error": DeviceFault, "crash": InjectedCrash, "shard-drop": DeviceFault,
            "io-error": StorageFault, "drop": NetworkFault}
_DELAYS = ("slow", "stall", "device-hang", "slow-client")
# kind -> its default payload mutator
_MUTATING = {"corrupt-shard-result": lambda ok: not ok, "silent-stuck-true": _stuck_true,
             "silent-flip": _silent_flip, "malformed-request": _malform_submission,
             "corrupt": lambda payload: payload, "corrupt-chunk": _corrupt_last_chunk,
             "wrong-blocks": lambda chunks: list(reversed(list(chunks))),
             "extra-blocks": lambda chunks: list(chunks) + list(chunks)[-1:]}
_CHECKED = ("overflow",)  # read by check(site); fire passes them
_KINDS = (*_RAISING, *_DELAYS, *_MUTATING, *_CHECKED, "torn-write")


@dataclass
class Fault:
    kind: str
    delay: float = 0.0
    mutate: Callable[[Any], Any] | None = None
    remaining: int | None = None  # None = until disarmed
    probability: float = 1.0
    fraction: float = 0.5  # torn-write: share of the record that hits disk


class FaultInjector:
    """Thread-safe switchboard of armed faults, keyed by site."""

    def __init__(self, seed: int | None = None):
        self._armed: dict[str, Fault] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed).random if seed is not None else random.random
        self.seed = seed
        self.injected = 0
        #: every firing, in order, as (site, kind)
        self.fired: list[tuple[str, str]] = []

    def arm(self, site: str, kind: str = "error", *, delay: float = 0.0,
            mutate: Callable[[Any], Any] | None = None, times: int | None = None,
            probability: float = 1.0, fraction: float = 0.5) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; have {_KINDS}")
        with self._lock:
            self._armed[site] = Fault(kind=kind, delay=delay, mutate=mutate, remaining=times,
                                      probability=probability, fraction=fraction)

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site, or every site when ``site`` is None."""
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._armed.pop(site, None)

    def armed(self, site: str) -> bool:
        with self._lock:
            return site in self._armed

    def arm_from_spec(self, spec: str) -> None:
        """Arm from a command-line spec ``site=kind[:arg][xN]``, for
        example ``bls.device_verify=errorx3``, ``bls.device_verify=slow:0.5``,
        ``pod.dispatch=shard-dropx1``,
        ``pod.gather=corrupt-shard-result:stuck-true`` or
        ``store.put=torn-write:0.4x1`` (the argument of ``torn-write`` is
        the share of the record that reaches the disk)."""
        site, _, rest = spec.partition("=")
        if not site or not rest:
            raise ValueError(f"bad fault spec {spec!r}; want site=kind[:arg][xN]")
        times = None
        head, _, n = rest.rpartition("x")
        if head and n.isdigit():
            rest, times = head, int(n)
        kind, _, arg = rest.partition(":")
        kind = kind.strip()
        delay = float(arg) if arg and kind in _DELAYS else 0.0
        fraction = float(arg) if arg and kind == "torn-write" else 0.5
        mutate = _stuck_true if kind == "corrupt-shard-result" and arg == "stuck-true" else None
        self.arm(site.strip(), kind, delay=delay, mutate=mutate, times=times, fraction=fraction)

    def _take(self, site: str) -> Fault | None:
        with self._lock:
            f = self._armed.get(site)
            if f is None:
                return None
            if f.probability < 1.0 and self._rng() >= f.probability:
                return None
            if f.remaining is not None:
                f.remaining -= 1
                if f.remaining <= 0:
                    del self._armed[site]
            self.injected += 1
            self.fired.append((site, f.kind))
            return f

    def fired_sequence(self) -> tuple[tuple[str, str], ...]:
        """Every firing so far, in order: the same across runs with the same
        seed and the same arming."""
        with self._lock:
            return tuple(self.fired)

    def fire(self, site: str, payload: Any = None) -> Any:
        """Apply the fault armed at ``site`` (raise, sleep or mutate) and
        return the payload; an unarmed site returns it untouched."""
        f = self._take(site)
        if f is None:
            return payload
        if f.kind in _DELAYS:
            time.sleep(f.delay)
            return payload
        if f.kind in _MUTATING:
            return (f.mutate or _MUTATING[f.kind])(payload)
        if f.kind in _CHECKED:
            return payload
        if f.kind == "torn-write":
            raise TornWrite(fraction=f.fraction)
        raise _RAISING[f.kind](f"injected {f.kind} at {site}")

    def maybe_fire(self, site: str, payload: Any = None) -> Any:
        """Never-raise variant of :meth:`fire`: delay and mutation kinds
        still apply, a raising kind is absorbed and the payload returned."""
        try:
            return self.fire(site, payload)
        except Exception:
            return payload

    def check(self, site: str) -> bool:
        """Non-raising peek for saturation sites: True when an ``overflow``
        fault fires at ``site`` (the site then behaves as if its resource
        were exhausted).  A bounded arm counts down as in ``fire``."""
        with self._lock:
            f = self._armed.get(site)
            if f is None or f.kind not in _CHECKED:
                return False
        return self._take(site) is not None


# The process-wide injector every site of the port fires through.
INJECTOR = FaultInjector()

arm = INJECTOR.arm
disarm = INJECTOR.disarm
fire = INJECTOR.fire
maybe_fire = INJECTOR.maybe_fire
arm_from_spec = INJECTOR.arm_from_spec
