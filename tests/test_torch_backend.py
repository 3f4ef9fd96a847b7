"""TorchBackend (torch_backend/backend.py) against the JAX package.

* marshal_sets gives the JAX package's operands leaf for leaf (both
  device_h2c settings, weights pinned), and convert.operands_from_jax
  carries the JAX operands over to the same tensors;
* verify_signature_sets verdicts at B=8 equal the JAX package's pure-Python
  oracle on the edge corpora (run on the CPU through the plain versions;
  the one-invalid corpus through the default device_h2c program);
* the whole device program against JAX's jitted _verify_kernel_h2c: the
  Fp12 value before the final exponentiation and the verdict (slow: the
  JAX CPU compile takes minutes).
"""

import random

import numpy as np
import pytest
import torch

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend.backend import JaxBackend  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import convert  # noqa: E402


def _sets(api, spec):
    """Build the same signature sets in either package from a seeded spec:
    (secret keys, message, signing secret key or None for infinity,
    negate-second-key flag)."""
    out = []
    for sks, msg, signer, negate in spec:
        keys = [api.SecretKey(k).public_key() for k in sks]
        if negate:
            x, y = keys[0].point
            keys[1] = api.PublicKey((x, -y))
        sig = (api.Signature.infinity() if signer is None
               else api.SecretKey(signer).sign(msg))
        out.append(api.SignatureSet(sig, keys, msg))
    return out


def _spec(corpus: str):
    rng = random.Random(corpus)
    spec = []
    for i in range(4):
        sk = rng.randrange(2, 10**12)
        spec.append(([sk], rng.randbytes(32), sk, False))
    multi = [rng.randrange(2, 10**12) for _ in range(3)]
    spec.append((multi, b"\x11" * 32, sum(multi), False))
    if corpus == "one_invalid":
        sks, msg, signer, neg = spec[2]
        spec[2] = (sks, msg, signer + 1, neg)  # signed under another key
    elif corpus == "infinity_signature":
        sks, msg, _, neg = spec[1]
        spec[1] = (sks, msg, None, neg)
    elif corpus == "aggregate_to_infinity":
        sk = spec[3][0][0]
        spec[3] = ([sk, sk], spec[3][1], sk, True)
    return spec


def _jax_leaves(args):
    if hasattr(args, "limbs"):
        return [(np.asarray(args.limbs).astype(np.int64).tolist(), float(args.bound))]
    if isinstance(args, tuple):
        return [leaf for a in args for leaf in _jax_leaves(a)]
    return [np.asarray(args).astype(np.int64).tolist()]


def _port_leaves(args):
    tree = convert.operands_to_numpy(args)

    def walk(x):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], float):
            return [(x[0].tolist(), x[1])]
        if isinstance(x, tuple):
            return [leaf for c in x for leaf in walk(c)]
        return [x.tolist()]

    return walk(tree)


@pytest.mark.parametrize("device_h2c", [False, True])
def test_marshal_matches_jax_leaf_by_leaf(device_h2c):
    spec = _spec("valid")
    weights = [random.Random(7).getrandbits(64) | 1 for _ in spec]
    jmb = JaxBackend(min_batch=8, device_h2c=device_h2c).marshal_sets(
        _sets(japi, spec), weights=weights)
    tmb = TB.TorchBackend(device="cpu", min_batch=8, device_h2c=device_h2c).marshal_sets(
        _sets(tapi, spec), weights=weights)
    assert (tmb.n, tmb.B, tmb.invalid) == (jmb.n, jmb.B, jmb.invalid) == (5, 8, False)
    assert _port_leaves(tmb.args) == _jax_leaves(jmb.args)
    carried = convert.operands_from_jax(jmb.args, "cpu")
    assert _port_leaves(carried) == _jax_leaves(jmb.args)


_CORPORA = ["valid", "one_invalid", "infinity_signature", "aggregate_to_infinity"]


@pytest.fixture(scope="module")
def cpu_backend():
    return TB.TorchBackend(device="cpu", min_batch=8, device_h2c=False)


@pytest.mark.parametrize("corpus", _CORPORA)
def test_verdicts_match_oracle(cpu_backend, corpus):
    """The rejecting corpus runs the card's default program (the map to G2
    on the device); the valid one the host-hashed program, whose device_h2c
    twin the slow whole-slice test runs.  The edge corpora stop on the host."""
    spec = _spec(corpus)
    want = japi.cpu_backend().verify_signature_sets(_sets(japi, spec))
    assert want is (corpus == "valid")
    backend = (TB.TorchBackend(device="cpu", min_batch=8) if corpus == "one_invalid"
               else cpu_backend)
    assert backend.device_h2c is (corpus == "one_invalid")
    assert backend.verify_signature_sets(_sets(tapi, spec)) is want


def test_infinity_key_is_refused_as_in_jax():
    """An infinity public key never reaches a batch: both packages refuse
    it when it is built or decoded (the corpus the reference names
    "infinity key"; its aggregate twin is aggregate_to_infinity above)."""
    infinity = bytes([0xC0]) + bytes(47)
    for api in (japi, tapi):
        with pytest.raises(api.BlsError):
            api.PublicKey(None)
        with pytest.raises(ValueError):
            api.PublicKey.from_bytes(infinity)


def test_non_subgroup_signature_fails_on_the_device_path(cpu_backend):
    from lighthouse_tpu_torch.crypto.bls import params
    from lighthouse_tpu_torch.crypto.bls.curve import B2, Fp2, g2_subgroup_check

    rng = random.Random(12)
    while True:
        x = Fp2(rng.randrange(params.P), rng.randrange(params.P))
        y = (x.square() * x + B2).sqrt()
        if y is not None and not g2_subgroup_check((x, y)):
            break
    good = _sets(tapi, _spec("valid"))
    bad = tapi.SignatureSet(tapi.Signature((x, y)), good[0].signing_keys, good[0].message)
    TB.reset_launch_counts()
    assert cpu_backend.verify_signature_sets(good[1:] + [bad]) is False
    counts = TB.launch_counts()
    assert {"mont_mul", "miller_step_dbl", "miller_step_add", "fp_chain", "fp2_chain",
            "wsm_step_g1", "wsm_step_g2", "mont_mul_mxu", "miller_step_dbl_mxu",
            "miller_step_add_mxu", "fp_chain_mxu", "fp2_chain_mxu"} == set(counts)
    assert set(counts.values()) == {0}


def test_host_rejections_need_no_device(cpu_backend):
    assert cpu_backend.verify_signature_sets([]) is False
    assert cpu_backend.fast_aggregate_verify([], b"\x00" * 32, None) is False
    good = _sets(tapi, _spec("valid"))[0]
    empty = tapi.SignatureSet(good.signature, [], good.message)
    assert cpu_backend.marshal_sets([good, empty]).invalid


def test_padded_size_and_weight_bits():
    be = TB.TorchBackend(device="cpu")
    assert [be._padded_size(n) for n in (1, 8, 9, 4096)] == [8, 8, 16, 4096]
    w = [1, (1 << 64) - 1, 0x8000000000000001]
    bits = TB._pack_wbits(w)
    assert bits.shape == (64, 3) and bits.dtype == torch.int32
    for j, v in enumerate(w):
        assert int("".join(str(int(b)) for b in bits[:, j]), 2) == v


def test_cuda_backend_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tapi, "_BACKENDS", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.set_backend("torch")


def test_registry_names_its_backends(monkeypatch):
    monkeypatch.setattr(tapi, "_BACKENDS", {})
    monkeypatch.setattr(tapi, "_ACTIVE", [])
    with pytest.raises(tapi.BlsError):
        tapi.get_backend()
    with pytest.raises(KeyError):
        tapi.set_backend("python")
    tapi.register_backend(TB.TorchBackend(device="cpu"))
    tapi.set_backend("torch")
    assert tapi.get_backend().name == "torch"


@pytest.mark.slow
def test_whole_slice_matches_jax_verify_kernel_h2c(monkeypatch):
    """JAX's jitted _verify_kernel_h2c at B=8 against the port on the
    operands carried over from the JAX marshal: the GT product before the
    final exponentiation (canonical Fp12 values) and the verdict."""
    from lighthouse_tpu.crypto.bls.jax_backend import backend as JB
    from lighthouse_tpu.crypto.bls.jax_backend import pairing as JPR
    from lighthouse_tpu.crypto.bls.jax_backend import tower as JT
    from lighthouse_tpu_torch.crypto.bls.torch_backend import pairing as TPR
    from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as TT

    spec = _spec("valid")
    weights = [random.Random(8).getrandbits(64) | 1 for _ in spec]
    jmb = JaxBackend(min_batch=8, device_h2c=True).marshal_sets(
        _sets(japi, spec), weights=weights)

    seen = {}

    def spy(module, key):
        orig = module.gt_product

        def gt_product(f):
            seen[key] = orig(f)
            return seen[key]

        monkeypatch.setattr(module, "gt_product", gt_product)

    spy(JPR, "jax")
    spy(TPR, "port")

    def program(*args):
        return JB._verify_kernel_h2c(*args), seen["jax"]

    j_ok, j_gt = jax.jit(program)(*jmb.args)
    t_ok = TB._verify_kernel_h2c(*convert.operands_from_jax(jmb.args, "cpu"))
    def key(v):
        return [(c.c0, c.c1) for h in (v.c0, v.c1) for c in (h.c0, h.c1, h.c2)]

    assert [key(v) for v in TT.fp12_decode(seen["port"])] == [
        key(v) for v in JT.fp12_decode(j_gt)]
    assert bool(t_ok) == bool(j_ok) is True
