"""Per-device trust scoring (the port's copy of the JAX package's
``integrity/trust.py``).

Canary mismatches and audit disagreements are *strikes* against the
device(s) that produced the verdict.  Strikes are cheap to record and
never raise; crossing ``strike_threshold`` is the quarantine decision
the :class:`~.guard.IntegrityGuard` wires into ``PodVerifier``'s health
exclusion.  Trust is restored only by an explicit ``clear`` — i.e. the
device passed a canary-only readmission probe — never by time alone.
"""

from __future__ import annotations

import threading


class TrustScore:
    """Strike counter with a quarantine threshold, keyed by device."""

    def __init__(self, strike_threshold: int = 2):
        if strike_threshold < 1:
            raise ValueError("strike_threshold must be >= 1")
        self.strike_threshold = int(strike_threshold)
        self._strikes: dict = {}
        self._quarantined: set = set()
        self._lock = threading.Lock()

    def strike(self, dev, reason: str = "") -> bool:
        """Record one strike; True when ``dev`` just crossed the threshold."""
        with self._lock:
            n = self._strikes.get(dev, 0) + 1
            self._strikes[dev] = n
            if n >= self.strike_threshold and dev not in self._quarantined:
                self._quarantined.add(dev)
                return True
            return False

    def clear(self, dev) -> None:
        """Forget strikes for ``dev`` (it passed a readmission probe)."""
        with self._lock:
            self._strikes.pop(dev, None)
            self._quarantined.discard(dev)

    def score(self, dev) -> int:
        with self._lock:
            return self._strikes.get(dev, 0)

    def quarantined(self, dev) -> bool:
        with self._lock:
            return dev in self._quarantined

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._strikes)
