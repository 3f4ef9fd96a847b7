"""The port's CUDA kernels against their plain versions, on a card.

Imports no jax, so it runs on the card's machine, where there is none.
Without a card it skips.  The repository's tests/conftest.py imports jax,
so on a machine without jax run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It covers all twelve entry points (mont_mul and miller_step_dbl in every
form: mont_kernel.FORMS, and kernel 2's group form): mont_mul, miller_step_dbl,
miller_step_add, fp_chain, fp2_chain, wsm_step_g1 and wsm_step_g2, and the
MXU variants (kernel 7 mont_mul_mxu, the Miller steps and both chains on
the 13-bit plane), each at a ragged width, byte for byte.  chip_smoke.py
runs the same checks at the path's own widths and operands.
"""

import random

import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.torch_backend import chain_kernel as CK
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.crypto.bls.torch_backend import h2c
from lighthouse_tpu_torch.crypto.bls.torch_backend import miller_kernel as ML
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK
from lighthouse_tpu_torch.crypto.bls.torch_backend import mxu_kernel as X
from lighthouse_tpu_torch.crypto.bls.torch_backend import wsm_kernel as W


def _rand_planes(rng, planes, n, k=2):
    return torch.stack([torch.as_tensor(F.ints_to_limbs(
        [rng.randrange(k * F.P_INT) for _ in range(n)])) for _ in range(planes)])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(23)
    n = 257
    dev = torch.device("cuda")

    def planes(k, bound=2):
        return _rand_planes(rng, k, n, bound).to(dev)

    def flags():
        return torch.tensor([[rng.randrange(2) for _ in range(n)]], dtype=torch.int32,
                            device=dev)

    def same(got, ref):
        return all(torch.equal(g, r) for g, r in zip(got, ref))

    f, t, q = planes(12), planes(6), planes(4)
    xp, yp = planes(1)[0], planes(1)[0]
    bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32, device=dev)
    assert torch.equal(MK.mont_mul(xp, yp), MK.mont_mul_plain(xp, yp))
    assert same(ML.miller_step_dbl(f, t, xp, yp), ML.miller_step_dbl_plain(f, t, xp, yp))
    assert same(ML.miller_step_add(f, t, q, xp, yp, bit),
                ML.miller_step_add_plain(f, t, q, xp, yp, bit))
    lazy = planes(1, 4)[0]
    for base in (xp, lazy):
        assert torch.equal(CK.pow_chain(base, F.P_INT - 2), CK.pow_chain_plain(base, F.P_INT - 2))
    assert same(CK.fp2_pow_chain(xp, yp, h2c.SQRT_EXP_BITS),
                CK.fp2_pow_chain_plain(xp, yp, h2c.SQRT_EXP_BITS))
    for nc, kern, plain in ((1, W.wsm_step_g1, W.wsm_step_g1_plain),
                            (2, W.wsm_step_g2, W.wsm_step_g2_plain)):
        args = (planes(3 * nc), flags(), planes(2 * nc), flags(), flags())
        assert same(kern(*args), plain(*args))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_mxu_kernels_match_plain_versions():
    """The MXU variants: every call is warp-cooperative, so the ragged
    widths (1, 33, 257 lanes) also check the kept-alive tail threads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(29)
    dev = torch.device("cuda")

    def same(got, ref):
        return all(torch.equal(g, r) for g, r in zip(got, ref))

    for n in (1, 33, 257):
        def planes(k, bound=2):
            return _rand_planes(rng, k, n, bound).to(dev)

        xp, yp = planes(1)[0], planes(1)[0]
        q = torch.full((F.N, n), F.QMAX, dtype=torch.int32, device=dev)
        for a, b in ((xp, yp), (q, q)):
            assert torch.equal(X.mont_mul_mxu(a, b), X.mont_mul_mxu_plain(a, b))
        f, t, qq = planes(12), planes(6), planes(4)
        bit = torch.tensor([rng.randrange(2) for _ in range(n)], dtype=torch.int32, device=dev)
        assert same(ML.miller_step_dbl(f, t, xp, yp, mxu=True),
                    ML.miller_step_dbl_plain(f, t, xp, yp, mxu=True))
        assert same(ML.miller_step_add(f, t, qq, xp, yp, bit, mxu=True),
                    ML.miller_step_add_plain(f, t, qq, xp, yp, bit, mxu=True))
        lazy = planes(1, 4)[0]
        for base in (xp, lazy):
            assert torch.equal(CK.pow_chain(base, F.P_INT - 2, mxu=True),
                               CK.pow_chain_plain(base, F.P_INT - 2, mxu=True))
        assert same(CK.fp2_pow_chain(xp, yp, h2c.SQRT_EXP_BITS, mxu=True),
                    CK.fp2_pow_chain_plain(xp, yp, h2c.SQRT_EXP_BITS, mxu=True))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_group_forms_match_plain_versions():
    """Every form of kernel 1 (mont_kernel.FORMS) and kernel 2's group
    form, at widths that leave ragged tails in their blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(31)
    dev = torch.device("cuda")
    n = 257
    f, t = _rand_planes(rng, 12, n).to(dev), _rand_planes(rng, 6, n).to(dev)
    xp, yp = _rand_planes(rng, 1, n)[0].to(dev), _rand_planes(rng, 1, n)[0].to(dev)
    q = torch.full((F.N, n), F.QMAX, dtype=torch.int32, device=dev)
    for form in MK.FORMS:
        g, lanes = form
        for w in sorted({1, 2, max(g - 1, 1), g + 1, lanes - 1, lanes + 1, 31, 33, n}):
            for a, b in ((xp, yp), (q, q)):
                a, b = a[:, :w].contiguous(), b[:, :w].contiguous()
                assert torch.equal(MK.mont_mul(a, b, form=form), MK.mont_mul_plain(a, b)), (form, w)
    for w in (1, ML.DBL_GROUP + 1, n):
        args = (f[..., :w].contiguous(), t[..., :w].contiguous(), xp[:, :w].contiguous(),
                yp[:, :w].contiguous())
        got = ML.miller_step_dbl(*args, mxu=False)
        ref = ML.miller_step_dbl_plain(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, ref)), w
    torch.cuda.synchronize()
