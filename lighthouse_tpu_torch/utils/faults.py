"""FaultInjector: named sites where tests and operators inject failures.

The port's own copy of the part of the JAX package's ``utils/faults.py``
that its sites need.  A site is a string; code on a hot path calls
``fire(site)`` there, which is a no-op (one dict lookup) unless a fault is
armed at the site.  The port's sites:

  ``bls.device_verify``  the head of ``TorchBackend.verify_signature_sets``,
                         before the marshal: device errors, hung devices
  ``ingest.marshal``     the head of ``IngestEngine.marshal_sets`` and
                         ``marshal_for_mesh`` (ingest/engine.py): a failed
                         vectorized marshal, which degrades to the scalar one

Fault kinds:

* ``error``        raise :class:`DeviceFault` (an infrastructure failure,
                   not a signature verdict)
* ``crash``        raise :class:`InjectedCrash` (task death)
* ``slow``, ``stall``, ``device-hang``
                   sleep ``delay`` seconds, then pass

``times=N`` disarms a site after N firings; every firing is counted in
``injected`` and logged in order in ``fired`` as ``(site, kind)``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any


class FaultError(RuntimeError):
    """Base class of every injected infrastructure failure."""


class DeviceFault(FaultError):
    """Injected device failure (the card went away mid-batch)."""


class InjectedCrash(FaultError):
    """Injected task death."""


_RAISING = {"error": DeviceFault, "crash": InjectedCrash}
_DELAYS = ("slow", "stall", "device-hang")
_KINDS = (*_RAISING, *_DELAYS)


@dataclass
class Fault:
    kind: str
    delay: float = 0.0
    remaining: int | None = None  # None = until disarmed


class FaultInjector:
    """Thread-safe switchboard of armed faults, keyed by site."""

    def __init__(self):
        self._armed: dict[str, Fault] = {}
        self._lock = threading.Lock()
        self.injected = 0
        #: every firing, in order, as (site, kind)
        self.fired: list[tuple[str, str]] = []

    def arm(self, site: str, kind: str = "error", *, delay: float = 0.0,
            times: int | None = None) -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; have {_KINDS}")
        with self._lock:
            self._armed[site] = Fault(kind=kind, delay=delay, remaining=times)

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
        """Arm from a command-line spec ``site=kind[:delay][xN]``, for
        example ``bls.device_verify=errorx3`` or
        ``bls.device_verify=slow:0.5``."""
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
        self.arm(site.strip(), kind, delay=delay, times=times)

    def _take(self, site: str) -> Fault | None:
        with self._lock:
            f = self._armed.get(site)
            if f is None:
                return None
            if f.remaining is not None:
                f.remaining -= 1
                if f.remaining <= 0:
                    del self._armed[site]
            self.injected += 1
            self.fired.append((site, f.kind))
            return f

    def fire(self, site: str, payload: Any = None) -> Any:
        """Apply the fault armed at ``site`` (raise or sleep) and return the
        payload; an unarmed site returns it untouched."""
        f = self._take(site)
        if f is None:
            return payload
        if f.kind in _DELAYS:
            time.sleep(f.delay)
            return payload
        raise _RAISING[f.kind](f"injected {f.kind} at {site}")


# The process-wide injector every site of the port fires through.
INJECTOR = FaultInjector()

arm = INJECTOR.arm
disarm = INJECTOR.disarm
fire = INJECTOR.fire
arm_from_spec = INJECTOR.arm_from_spec
