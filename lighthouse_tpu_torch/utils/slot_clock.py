"""Slot clocks — twin of common/slot_clock (SystemTimeSlotClock +
ManualSlotClock for tests; trait surface at common/slot_clock/src/lib.rs)."""

from __future__ import annotations

import time


class SlotClock:
    """genesis-anchored slot arithmetic + the slot-phase deadlines the
    batching layer flushes against (attestation: 1/3 slot, aggregate: 2/3 —
    BASELINE.md timing budget)."""

    def __init__(self, genesis_time: float, seconds_per_slot: int):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot

    def now(self) -> float:
        raise NotImplementedError

    def current_slot(self) -> int:
        t = self.now()
        if t < self.genesis_time:
            return 0
        return int((t - self.genesis_time) // self.seconds_per_slot)

    def start_of(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        return max(0.0, self.now() - self.start_of(self.current_slot()))

    def attestation_deadline(self, slot: int | None = None) -> float:
        s = self.current_slot() if slot is None else slot
        return self.start_of(s) + self.seconds_per_slot / 3

    def aggregate_deadline(self, slot: int | None = None) -> float:
        s = self.current_slot() if slot is None else slot
        return self.start_of(s) + 2 * self.seconds_per_slot / 3

    def duration_to_next_slot(self) -> float:
        return self.start_of(self.current_slot() + 1) - self.now()


class SystemTimeSlotClock(SlotClock):
    def now(self) -> float:
        return time.time()


class SlotTimer:
    """Per-slot tick service — twin of beacon_node/timer (src/lib.rs, 34
    LoC there: a task that fires a fork-choice update each slot).  Polls
    the clock on a short interval so it works with ManualSlotClock in
    tests and SystemTimeSlotClock in a node; fires ``on_slot(slot)`` once
    per new slot, in its own thread."""

    def __init__(self, clock: SlotClock, on_slot, poll_interval: float = 0.05):
        import threading

        self.clock = clock
        self.on_slot = on_slot
        self.poll_interval = poll_interval
        self._last_fired: int | None = None
        self._running = False
        self._thread = threading.Thread(
            target=self._loop, name="slot-timer", daemon=True
        )

    def start(self) -> None:
        self._running = True
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        import logging
        import time as _time

        log = logging.getLogger("slot_timer")
        while self._running:
            slot = self.clock.current_slot()
            if self._last_fired is None or slot > self._last_fired:
                self._last_fired = slot
                try:
                    self.on_slot(slot)
                except Exception:  # noqa: BLE001 — a bad tick must not
                    # kill the timer (task_executor isolation), but a
                    # silently dead proposer is worse than a noisy one
                    log.exception("on_slot(%d) failed", slot)
            _time.sleep(self.poll_interval)


class ManualSlotClock(SlotClock):
    """Test clock advanced by hand (the reference's TestingSlotClock)."""

    def __init__(self, genesis_time: float = 0.0, seconds_per_slot: int = 12):
        super().__init__(genesis_time, seconds_per_slot)
        self._now = genesis_time

    def now(self) -> float:
        return self._now

    def set_slot(self, slot: int) -> None:
        self._now = self.start_of(slot)

    def advance(self, seconds: float) -> None:
        self._now += seconds
