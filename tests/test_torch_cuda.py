"""The port's CUDA kernels against their plain versions, on a card.

Imports no jax, so it runs on the card's machine, where there is none.
Without a card it skips.  The repository's tests/conftest.py imports jax,
so on a machine without jax run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It covers all twelve entry points (mont_mul in every form of
mont_kernel.FORMS, the Miller steps in their group forms: kernels 2, 3 and
2m, the Fp chain in every form of chain_kernel.FP_FORMS and the Fp2 chain
in its one): mont_mul, miller_step_dbl, miller_step_add, fp_chain,
fp2_chain, wsm_step_g1 and wsm_step_g2, and the
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
    """Every form of kernel 1 (mont_kernel.FORMS) and the group forms of the
    Miller steps (kernels 2, 3 with random bits, and 2m), at widths that
    leave ragged tails in their blocks, and the steps also at the Miller
    loop's 4,097 lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(31)
    dev = torch.device("cuda")
    n, wide = 257, 4097
    f, t = _rand_planes(rng, 12, wide).to(dev), _rand_planes(rng, 6, wide).to(dev)
    qq = _rand_planes(rng, 4, wide).to(dev)
    xp, yp = _rand_planes(rng, 1, wide)[0].to(dev), _rand_planes(rng, 1, wide)[0].to(dev)
    bit = torch.tensor([rng.randrange(2) for _ in range(wide)], dtype=torch.int32, device=dev)
    q = torch.full((F.N, n), F.QMAX, dtype=torch.int32, device=dev)
    for form in MK.FORMS:
        g, lanes = form
        for w in sorted({1, 2, max(g - 1, 1), g + 1, lanes - 1, lanes + 1, 31, 33, n}):
            for a, b in ((xp[:, :n], yp[:, :n]), (q, q)):
                a, b = a[:, :w].contiguous(), b[:, :w].contiguous()
                assert torch.equal(MK.mont_mul(a, b, form=form), MK.mont_mul_plain(a, b)), (form, w)

    def cut(w, *planes):
        return tuple(x[..., :w].contiguous() for x in planes)

    steps = [("dbl", ML.DBL_GROUP, lambda *a: ML.miller_step_dbl(*a, mxu=False),
              ML.miller_step_dbl_plain, (f, t, xp, yp)),
             ("dbl_mxu", ML.DBL_MXU_GROUP, lambda *a: ML.miller_step_dbl(*a, mxu=True),
              lambda *a: ML.miller_step_dbl_plain(*a, mxu=True), (f, t, xp, yp)),
             ("add", ML.ADD_GROUP, lambda *a: ML.miller_step_add(*a, mxu=False),
              ML.miller_step_add_plain, (f, t, qq, xp, yp, bit))]
    for name, g, kern, plain, planes in steps:
        for w in (1, g + 1, n, wide):
            args = cut(w, *planes)
            got, ref = kern(*args), plain(*args)
            assert all(torch.equal(x, y) for x, y in zip(got, ref)), (name, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_group_chains_match_plain_versions():
    """The 15-bit chains in the group form (kernel 4 in every form of
    chain_kernel.FP_FORMS, kernel 5 in FP2_FORM) at 1, 2, G + 1, 257 and
    4,097 lanes: the p-2 chain on strict and lazy (bound 4) bases, the
    (p^2+7)/16 chain on reduced elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(37)
    dev = torch.device("cuda")
    wide = 4097
    strict = _rand_planes(rng, 2, wide, 1).to(dev)
    lazy = _rand_planes(rng, 1, wide, 4)[0].to(dev)
    e = F.P_INT - 2
    for w in (1, 2, CK.FP2_FORM[0] + 1, 257, wide):
        x, y, z = (t[:, :w].contiguous() for t in (strict[0], strict[1], lazy))
        for form in CK.FP_FORMS:
            for base in (x, z):
                assert torch.equal(CK.pow_chain(base, e, mxu=False, form=form),
                                   CK.pow_chain_plain(base, e)), (form, w)
        got = CK.fp2_pow_chain(x, y, h2c.SQRT_EXP_BITS, mxu=False)
        ref = CK.fp2_pow_chain_plain(x, y, h2c.SQRT_EXP_BITS)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), w
    torch.cuda.synchronize()
