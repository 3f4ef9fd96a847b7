"""The port's fault injector (lighthouse_tpu_torch/utils/faults.py), the
``bls.device_verify`` hook at the head of TorchBackend.verify_signature_sets,
and the api's free functions, against the JAX package's (no device run)."""

import time

import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.utils import faults as jfaults  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.utils import faults  # noqa: E402
from lighthouse_tpu_torch.utils.faults import (  # noqa: E402
    DeviceFault, FaultInjector, InjectedCrash)


@pytest.fixture(autouse=True)
def _clean_injectors():
    """No armed fault leaks into or out of a test, in either package."""
    faults.INJECTOR.disarm()
    jfaults.INJECTOR.disarm()
    yield
    faults.INJECTOR.disarm()
    jfaults.INJECTOR.disarm()


# -- the injector: the cases of tests/test_faults.py on the port's copy -----


def test_unarmed_site_is_noop():
    inj = FaultInjector()
    assert inj.fire("bls.device_verify", payload=41) == 41
    assert inj.injected == 0 and inj.fired == []


def test_error_fault_raises():
    inj = FaultInjector()
    inj.arm("bls.device_verify", "error")
    with pytest.raises(DeviceFault):
        inj.fire("bls.device_verify")
    assert inj.injected == 1 and inj.fired == [("bls.device_verify", "error")]


def test_bounded_arm_auto_disarms():
    inj = FaultInjector()
    inj.arm("s", "error", times=2)
    for _ in range(2):
        with pytest.raises(DeviceFault):
            inj.fire("s")
    assert not inj.armed("s")
    inj.fire("s")  # third firing: disarmed, no raise
    assert inj.injected == 2


def test_crash_kind_and_unknown_kind():
    inj = FaultInjector()
    inj.arm("task", "crash")
    with pytest.raises(InjectedCrash):
        inj.fire("task")
    with pytest.raises(ValueError):
        inj.arm("s", "meltdown")


@pytest.mark.parametrize("kind", ["slow", "stall", "device-hang"])
def test_delay_kinds_sleep_then_pass(kind):
    inj = FaultInjector()
    inj.arm_from_spec(f"s={kind}:0.02x1")
    t0 = time.monotonic()
    assert inj.fire("s", payload=7) == 7
    assert time.monotonic() - t0 >= 0.015
    assert not inj.armed("s")


def test_arm_from_spec_as_the_reference():
    for inj in (FaultInjector(), jfaults.FaultInjector()):
        inj.arm_from_spec("bls.device_verify=errorx3")
        f = inj._armed["bls.device_verify"]
        assert f.kind == "error" and f.remaining == 3
        inj.arm_from_spec("x=slow:0.25")
        f = inj._armed["x"]
        assert f.kind == "slow" and f.delay == 0.25 and f.remaining is None
        with pytest.raises(ValueError):
            inj.arm_from_spec("nonsense")
        inj.disarm()
        assert not inj.armed("x") and not inj.armed("bls.device_verify")


# -- the hook ---------------------------------------------------------------


def _sets(api):
    sk = api.SecretKey(4242)
    msg = b"\x42" * 32
    return [api.SignatureSet(sk.sign(msg), [sk.public_key()], msg)]


def test_armed_device_verify_raises_before_the_marshal(monkeypatch):
    from lighthouse_tpu.crypto.bls.jax_backend.backend import JaxBackend

    for bk, inj, api, exc in ((TB.TorchBackend(device="cpu"), faults, tapi, DeviceFault),
                              (JaxBackend(min_batch=8), jfaults, japi, jfaults.DeviceFault)):
        marshalled = []
        monkeypatch.setattr(bk, "marshal_sets", lambda sets, weights=None: marshalled.append(1))
        inj.arm_from_spec("bls.device_verify=errorx1")
        with pytest.raises(exc):
            bk.verify_signature_sets(_sets(api))
        assert marshalled == [] and not inj.INJECTOR.armed("bls.device_verify")
    assert faults.INJECTOR.fired[-1] == ("bls.device_verify", "error")


def test_unarmed_hook_passes_to_the_marshal():
    bk = TB.TorchBackend(device="cpu")
    assert bk.verify_signature_sets([]) is False  # refused on the host, no program
    assert bk.builds == {}


# -- the api's free functions, routed to the active backend -----------------


class _Stub:
    name = "stub"

    def __init__(self):
        self.calls = []

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args):
            self.calls.append((method, args))
            return True

        return call


@pytest.mark.parametrize("api", [tapi, japi], ids=["port", "reference"])
def test_free_functions_route_to_the_active_backend(monkeypatch, api):
    stub = _Stub()
    monkeypatch.setattr(api, "_BACKENDS", {"stub": stub})
    monkeypatch.setattr(api, "_ACTIVE", [None])
    api.set_backend("stub")
    pk, msg, sig = object(), b"m", api.Signature.infinity()
    assert api.verify(pk, msg, sig) is True
    assert api.aggregate_verify([pk], [msg], sig) is True
    assert api.fast_aggregate_verify([pk], msg, sig) is True
    assert api.eth_fast_aggregate_verify([pk], msg, sig) is True
    assert api.verify_signature_sets(["s"]) is True
    assert [m for m, _ in stub.calls] == ["verify", "aggregate_verify", "fast_aggregate_verify",
                                          "fast_aggregate_verify", "verify_signature_sets"]
    assert stub.calls[1][1] == ([pk], [msg], sig)
    # the spec's special case: an infinity signature over no pubkeys, no backend call
    stub.calls.clear()
    assert api.eth_fast_aggregate_verify([], msg, sig) is True
    assert stub.calls == []
