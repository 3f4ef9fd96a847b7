"""TorchBackend.aggregate_verify and _aggregate_verify_kernel
(torch_backend/backend.py) against the JAX package.

* aggregate_verify on the CPU (the plain versions) at n = 3, padded to the
  4-lane program, on the EF vectors' valid and swapped-messages cases,
  each against the JAX package's pure-Python oracle;
* the host refusals, with no device run;
* slow: the padding mask (n = 3 unpadded, padded and unmasked), the whole
  EF sweep of the verify-family handlers through TorchBackend(device="cpu"),
  and the program against the JAX package's jitted _aggregate_verify_kernel
  on the same operands.
"""

import json
import os
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import points as P  # noqa: E402

VECTORS = os.path.join(os.path.dirname(__file__), "vectors", "bls")


def _case(handler, name):
    with open(os.path.join(VECTORS, handler, "small", name, "data.yaml")) as fh:
        return json.load(fh)


def _h2b(s):
    return bytes.fromhex(s[2:])


def _agg_args(api, data):
    inp = data["input"]
    pks = [api.PublicKey.from_bytes(_h2b(p)) for p in inp["pubkeys"]]
    return pks, [_h2b(m) for m in inp["messages"]], api.Signature.from_bytes(_h2b(inp["signature"]))


@pytest.fixture(scope="module")
def cpu_backend():
    return TB.TorchBackend(device="cpu", min_batch=4)


@pytest.mark.parametrize("case", ["aggregate_verify_valid", "aggregate_verify_swapped_messages"])
def test_aggregate_verify_matches_the_oracle(cpu_backend, case):
    data = _case("aggregate_verify", case)
    want = japi.PythonBackend().aggregate_verify(*_agg_args(japi, data))
    assert want is data["output"]
    assert cpu_backend.aggregate_verify(*_agg_args(tapi, data)) is want
    # three messages run in the four-lane program
    assert ("agg", 4, False, False, False) in cpu_backend.builds


def test_aggregate_verify_refuses_on_the_host_as_the_reference():
    """No pubkeys, a length mismatch, an infinity signature, an infinity key:
    False in both packages, before any program is made."""
    from lighthouse_tpu.crypto.bls.jax_backend.backend import JaxBackend

    bk = TB.TorchBackend(device="cpu", min_batch=4)
    ref = JaxBackend(min_batch=4, device_h2c=False)
    data = _case("aggregate_verify", "aggregate_verify_na_pubkeys_and_infinity_signature")
    assert data["output"] is False
    pks, msgs, sig = _agg_args(tapi, data)
    assert bk.aggregate_verify(pks, msgs, sig) is False
    assert ref.aggregate_verify(*_agg_args(japi, data)) is False
    good = _agg_args(tapi, _case("aggregate_verify", "aggregate_verify_valid"))
    jgood = _agg_args(japi, _case("aggregate_verify", "aggregate_verify_valid"))
    for port_args, jax_args in (
            ((good[0], good[1][:2], good[2]), (jgood[0], jgood[1][:2], jgood[2])),
            ((good[0], good[1], tapi.Signature.infinity()),
             (jgood[0], jgood[1], japi.Signature.infinity())),
            (([SimpleNamespace(point=None)] + good[0][1:], good[1], good[2]),
             ([SimpleNamespace(point=None)] + jgood[0][1:], jgood[1], jgood[2]))):
        assert bk.aggregate_verify(*port_args) is False
        assert ref.aggregate_verify(*jax_args) is False
    assert bk.builds == {} and ref._kernels == {}


# -- slow: the mask, the EF sweep, the program against JAX's -----------------


def _operands(data, size):
    """The port's program operands for an EF case padded to ``size`` lanes."""
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2

    pks, msgs, sig = _agg_args(tapi, data)
    n = len(pks)
    pk_pts = [pk.point for pk in pks] + [pks[0].point] * (size - n)
    h_pts = [hash_to_g2(m) for m in msgs]
    h_pts += [h_pts[0]] * (size - n)
    cpu = torch.device("cpu")
    return (P.g1_encode(pk_pts, cpu), P.g2_encode(h_pts, cpu), P.g2_encode([sig.point], cpu),
            torch.arange(size) >= n)


@pytest.mark.slow
def test_padding_lanes_are_masked():
    """n = 3 unpadded (no mask) and padded to 4 (masked) both accept; the
    padded operands without the mask count pair 0 twice and reject."""
    data = _case("aggregate_verify", "aggregate_verify_valid")
    with torch.inference_mode():
        pk, h, sig, _ = _operands(data, 3)
        assert bool(TB._aggregate_verify_kernel(pk, h, sig))
        pk, h, sig, pad = _operands(data, 4)
        assert pad.tolist() == [False, False, False, True]
        assert bool(TB._aggregate_verify_kernel(pk, h, sig, pad))
        assert not bool(TB._aggregate_verify_kernel(pk, h, sig))


_SWEEP = ["verify", "fast_aggregate_verify", "aggregate_verify", "batch_verify"]


def _sweep_cases():
    return [pytest.param(h, name, id=f"{h}/{name}") for h in _SWEEP
            for name in sorted(os.listdir(os.path.join(VECTORS, h, "small")))]


@pytest.mark.slow
@pytest.mark.parametrize("handler,name", _sweep_cases())
def test_ef_vectors_through_the_port(handler, name):
    """The EF sweep of tests/test_ef_bls_vectors.py through
    TorchBackend(device="cpu"), parsed with the port's api."""
    data = _case(handler, name)
    inp, want = data["input"], bool(data["output"])
    bk = TB.TorchBackend(device="cpu", min_batch=4)
    try:
        if handler == "verify":
            got = bk.verify(tapi.PublicKey.from_bytes(_h2b(inp["pubkey"])), _h2b(inp["message"]),
                            tapi.Signature.from_bytes(_h2b(inp["signature"])))
        elif handler == "fast_aggregate_verify":
            got = bk.fast_aggregate_verify(
                [tapi.PublicKey.from_bytes(_h2b(p)) for p in inp["pubkeys"]],
                _h2b(inp["message"]), tapi.Signature.from_bytes(_h2b(inp["signature"])))
        elif handler == "aggregate_verify":
            got = bk.aggregate_verify(*_agg_args(tapi, data))
        else:
            got = bk.verify_signature_sets([
                tapi.SignatureSet(tapi.Signature.from_bytes(_h2b(s["signature"])),
                                  [tapi.PublicKey.from_bytes(_h2b(p)) for p in s["pubkeys"]],
                                  _h2b(s["message"])) for s in inp["sets"]])
    except Exception:
        got = False
    assert got is want


@pytest.mark.slow
@pytest.mark.parametrize("case", ["aggregate_verify_valid", "aggregate_verify_swapped_messages"])
def test_program_matches_jax_aggregate_verify_kernel(case):
    """JAX's jitted _aggregate_verify_kernel and the port's program on the
    same operands (the JAX package's, carried over with
    convert.operands_from_jax)."""
    from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2 as jh2g
    from lighthouse_tpu.crypto.bls.jax_backend import backend as JB
    from lighthouse_tpu.crypto.bls.jax_backend import points as JP
    from lighthouse_tpu_torch.crypto.bls.torch_backend import convert

    data = _case("aggregate_verify", case)
    pks, msgs, sig = _agg_args(japi, data)
    jargs = (JP.g1_encode([pk.point for pk in pks]), JP.g2_encode([jh2g(m) for m in msgs]),
             JP.g2_encode([sig.point]))
    want = bool(jax.jit(JB._aggregate_verify_kernel)(*jargs))
    assert want is data["output"]
    with torch.inference_mode():
        got = bool(TB._aggregate_verify_kernel(*convert.operands_from_jax(jargs, "cpu")))
    assert got is want
