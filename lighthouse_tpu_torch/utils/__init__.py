"""Host-side utilities of the port: the supervised task executor, the fault
injector, structured logging, the metrics, the slot clocks and the device
identity (the JAX package's ``utils/__init__.py``, with ``device_kind``
asking PyTorch)."""

from .executor import ShutdownReason, TaskExecutor  # noqa: F401
from .faults import (  # noqa: F401
    INJECTOR,
    DeviceFault,
    FaultError,
    FaultInjector,
    InjectedCrash,
    StorageFault,
    TornWrite,
)
from .logging import get_logger, log_with  # noqa: F401
from .metrics import Counter, Gauge, Histogram, render  # noqa: F401
from .slot_clock import ManualSlotClock, SlotClock, SystemTimeSlotClock  # noqa: F401


def device_kind() -> str:
    """The device identity that boot rows and tuned kernel plans join on
    (lighthouse_tpu/utils/__init__.py:device_kind): the CUDA card's name when
    one is visible, ``"cpu"`` otherwise, and ``"host"`` when PyTorch cannot be
    asked.  Never raises: history writers call it and must not take a
    process down."""
    try:
        import torch

        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name())
        return "cpu"
    except Exception:  # noqa: BLE001 — the identity probe is best-effort
        return "host"
