"""Host-side utilities of the port (the fault injector, the metrics, the
device identity)."""


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
