"""The port's CUDA kernels against their plain versions, on a card.

Imports no jax, so it runs on the card's machine, where there is none.
Without a card it skips.  The repository's tests/conftest.py imports jax,
so on a machine without jax run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It covers all twelve entry points (mont_mul in every form of
mont_kernel.FORMS and mont_mul_mxu in every form of mxu_kernel.FORMS, the
Miller steps in their group forms: kernels 2, 3, 2m and 3m, the Fp chain in
every form of chain_kernel.FP_FORMS, and the Fp2 chain and both MXU chains
in their one form each): mont_mul, miller_step_dbl, miller_step_add, fp_chain,
fp2_chain, wsm_step_g1 and wsm_step_g2, and the
MXU variants (kernel 7 mont_mul_mxu, the Miller steps and both chains on
the 13-bit plane), each at a ragged width, byte for byte; kernel 6 in each
curve's form (wsm_kernel.FORMS) also at 1, 33, 257 and 4,097 lanes.
chip_smoke.py runs the same checks at the path's own widths and operands.

The captured program (torch_backend/program.py) is held against the eager
one at B = 8 under each arm, on the edge corpora of
tests/test_torch_backend.py (built here from the same seeded specs), and
the aggregate-verify and epoch graphs against their eager programs at small
sizes under each arm.  The ingest engine's registry gather on the card
equals host assembly (and dispatches through the B = 8 graph), and the epoch
balance pipeline on the card equals its CPU run.  Warm boot (aot.py): a
key captured into an AOT store is prewarmed by a fresh backend from its
operand skeleton and replays the same verdicts.  The mesh (parallel/): two
threads dispatching through one key on their own streams keep their own
verdicts (the replay lock), a ShardedVerifyProgram on a 2-seat mesh of one
card matches the single-device verdicts, and the partitioned registry's
gather equals the host take.  The front door (beacon/processor.py,
integrity/, serve/): the guarded stack at B = 8 gives the truth on a batch
with one bad set, every batch on the device rung; the cross-arm audit under
mxu13 runs its arm pinned while a second thread dispatches the default
arm's key.
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
    widths (1, 33, 257 lanes) also check the kept-alive tail threads;
    kernels 7 (both forms) and 4m (group forms in blocks of 32 lanes) also
    at 4,097."""
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
            want = X.mont_mul_mxu_plain(a, b)
            for form in X.FORMS:
                assert torch.equal(X.mont_mul_mxu(a, b, form=form), want), (form, n)
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
    wide = 4097
    x, y, z = _rand_planes(rng, 3, wide).to(dev)
    q = torch.full((F.N, wide), F.QMAX, dtype=torch.int32, device=dev)
    for a, b in ((x, y), (q, q), (z, z)):
        want = X.mont_mul_mxu_plain(a, b)
        for form in X.FORMS:
            assert torch.equal(X.mont_mul_mxu(a, b, form=form), want), form
    for base in (x, _rand_planes(rng, 1, wide, 4)[0].to(dev)):
        assert torch.equal(CK.pow_chain(base, F.P_INT - 2, mxu=True),
                           CK.pow_chain_plain(base, F.P_INT - 2, mxu=True))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_group_forms_match_plain_versions():
    """Every form of kernel 1 (mont_kernel.FORMS) and the group forms of the
    Miller steps (kernels 2, 3 and 3m with random bits, and 2m), at widths
    that leave ragged tails in their blocks, and the steps also at the
    Miller loop's 4,097 lanes."""
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
              ML.miller_step_add_plain, (f, t, qq, xp, yp, bit)),
             ("add_mxu", ML.ADD_MXU_GROUP, lambda *a: ML.miller_step_add(*a, mxu=True),
              lambda *a: ML.miller_step_add_plain(*a, mxu=True), (f, t, qq, xp, yp, bit))]
    for name, g, kern, plain, planes in steps:
        for w in (1, g + 1, n, wide):
            args = cut(w, *planes)
            got, ref = kern(*args), plain(*args)
            assert all(torch.equal(x, y) for x, y in zip(got, ref)), (name, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_group_chains_match_plain_versions():
    """The chains in the group form (kernel 4 in every form of
    chain_kernel.FP_FORMS, kernel 5 in FP2_FORM) at 1, 2, G + 1, 257 and
    4,097 lanes: the p-2 chain on strict and lazy (bound 4) bases, the
    (p^2+7)/16 chain on reduced elements; kernel 5m (FP2_MXU_FORM, blocks of
    32 lanes) at 1, G + 1, 33 and 4,097 lanes."""
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
    for w in (1, CK.FP2_MXU_FORM[0] + 1, 33, wide):
        x, y = (t[:, :w].contiguous() for t in (strict[0], strict[1]))
        got = CK.fp2_pow_chain(x, y, h2c.SQRT_EXP_BITS, mxu=True)
        ref = CK.fp2_pow_chain_plain(x, y, h2c.SQRT_EXP_BITS, mxu=True)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), ("mxu", w)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wsm_forms_match_plain_versions():
    """Kernel 6 in each curve's form (G2 the group form in blocks of 32
    lanes, G1 the cooperative form in blocks of 8) at 1, 33, 257 and 4,097
    lanes: ragged tails in every block size, random flags on every side."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    rng = random.Random(41)
    dev = torch.device("cuda")
    wide = 4097

    def flags():
        return torch.tensor([[rng.randrange(2) for _ in range(wide)]], dtype=torch.int32,
                            device=dev)

    for nc, kern, plain in ((1, W.wsm_step_g1, W.wsm_step_g1_plain),
                            (2, W.wsm_step_g2, W.wsm_step_g2_plain)):
        operands = (_rand_planes(rng, 3 * nc, wide).to(dev), flags(),
                    _rand_planes(rng, 2 * nc, wide).to(dev), flags(), flags())
        for w in (1, 33, 257, wide):
            args = tuple(x[..., :w].contiguous() for x in operands)
            got, ref = kern(*args), plain(*args)
            assert all(torch.equal(g, r) for g, r in zip(got, ref)), (nc, w)
    torch.cuda.synchronize()


def _graph_corpora():
    """The seeded corpora of tests/test_torch_backend.py, in the port's api,
    and a signature on the curve outside the subgroup."""
    from lighthouse_tpu_torch.crypto.bls import api, params
    from lighthouse_tpu_torch.crypto.bls.curve import B2, Fp2, g2_subgroup_check

    def spec(corpus):
        rng = random.Random(corpus)
        out = []
        for _ in range(4):
            sk = rng.randrange(2, 10**12)
            out.append(([sk], rng.randbytes(32), sk, False))
        multi = [rng.randrange(2, 10**12) for _ in range(3)]
        out.append((multi, b"\x11" * 32, sum(multi), False))
        if corpus == "one_invalid":
            sks, msg, signer, neg = out[2]
            out[2] = (sks, msg, signer + 1, neg)
        elif corpus == "infinity_signature":
            sks, msg, _, neg = out[1]
            out[1] = (sks, msg, None, neg)
        elif corpus == "aggregate_to_infinity":
            sk = out[3][0][0]
            out[3] = ([sk, sk], out[3][1], sk, True)
        return out

    def sets(corpus):
        built = []
        for sks, msg, signer, negate in spec(corpus):
            keys = [api.SecretKey(k).public_key() for k in sks]
            if negate:
                x, y = keys[0].point
                keys[1] = api.PublicKey((x, -y))
            sig = (api.Signature.infinity() if signer is None
                   else api.SecretKey(signer).sign(msg))
            built.append(api.SignatureSet(sig, keys, msg))
        return built

    corpora = {c: sets(c) for c in ("valid", "one_invalid", "infinity_signature",
                                    "aggregate_to_infinity")}
    rng = random.Random(12)
    while True:
        x = Fp2(rng.randrange(params.P), rng.randrange(params.P))
        y = (x.square() * x + B2).sqrt()
        if y is not None and not g2_subgroup_check((x, y)):
            break
    good = corpora["valid"]
    corpora["non_subgroup"] = good[1:] + [
        api.SignatureSet(api.Signature((x, y)), good[0].signing_keys, good[0].message)]
    return corpora


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["default", "arm", "mxu"])
def test_cuda_graph_verdicts_match_eager(arm, monkeypatch):
    """At B = 8: one build of the key, replays whose refreshed inputs flip
    the verdict (valid, one invalid, valid), no launch counted on a replay,
    and the eager program's verdicts on the same marshalled batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB

    monkeypatch.setattr(F, "_CHAINS_MODE", arm != "default")
    monkeypatch.setattr(F, "_WSM_MODE", arm != "default")
    monkeypatch.setattr(F, "_MXU_MODE", arm == "mxu")
    bk = TB.TorchBackend(device="cuda", min_batch=8)
    assert bk.warm_compile(8)
    (key,) = bk.builds
    assert key == (8, True, arm == "mxu", arm != "default", arm != "default")
    assert bk.builds[key]["nodes"]["kernel"] > 0
    corpora = _graph_corpora()
    order = ["valid", "one_invalid", "valid", "infinity_signature", "aggregate_to_infinity",
             "non_subgroup"]
    mbs = {c: bk.marshal_sets(sets) for c, sets in corpora.items()}
    TB.reset_launch_counts()
    handles = [bk.dispatch(mbs[c]) for c in order]  # all in flight before the first resolve
    graph = [bk.resolve(h) for h in handles]
    assert set(TB.launch_counts().values()) == {0}
    assert list(bk.builds) == [key]
    assert graph == [True, False, True, False, False, False]

    def eager(mb):
        if mb.invalid:
            return False
        with torch.inference_mode():
            return bool(bk.local_verify_fn()(*TB._to_device(mb.args, bk.device)))

    assert [eager(mbs[c]) for c in order] == graph


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["default", "arm", "mxu"])
def test_cuda_aggregate_and_epoch_graphs_match_eager(arm, monkeypatch):
    """The aggregate-verify graph (three messages in the four-lane key) and
    the epoch graph (B = 4, positions = 4): valid and corrupted inputs
    dispatched in turn, one build per key, no launch counted on a replay,
    and the eager programs' verdicts on the same operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls import api, params
    from lighthouse_tpu_torch.crypto.bls.curve import Fp2, from_jacobian, jac_add, to_jacobian
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.crypto.bls.torch_backend import points as P

    monkeypatch.setattr(F, "_CHAINS_MODE", arm != "default")
    monkeypatch.setattr(F, "_WSM_MODE", arm != "default")
    monkeypatch.setattr(F, "_MXU_MODE", arm == "mxu")
    bk = TB.TorchBackend(device="cuda", min_batch=4)
    cpu = torch.device("cpu")

    def eager(fn, *args):
        with torch.inference_mode():
            return bool(fn(*TB._to_device(args, bk.device)))

    # aggregate verify: n = 3 in the 4-lane graph
    sks = [api.SecretKey(7000 + i) for i in range(3)]
    msgs = [bytes([i + 1]) * 32 for i in range(3)]
    acc = to_jacobian(None, Fp2)
    for sk, m in zip(sks, msgs):
        acc = jac_add(acc, to_jacobian(sk.sign(m).point, Fp2), Fp2)
    sig = api.Signature(from_jacobian(acc, Fp2))
    pks = [sk.public_key() for sk in sks]
    TB.reset_launch_counts()
    assert bk.aggregate_verify(pks, msgs, sig) is True
    built = TB.launch_counts()
    assert bk.aggregate_verify(pks, [msgs[1], msgs[0], msgs[2]], sig) is False
    assert bk.aggregate_verify(pks, [msgs[0], msgs[0], msgs[2]], sig) is False
    (key,) = bk.builds
    assert key == ("agg", 4, arm == "mxu", arm != "default", arm != "default")
    assert TB.launch_counts() == built and bk.builds[key]["nodes"]["kernel"] > 0
    for order, want in (((0, 1, 2), True), ((1, 0, 2), False)):
        h = [hash_to_g2(msgs[i]) for i in order]
        args = (P.g1_encode([pk.point for pk in pks] + [pks[0].point], cpu),
                P.g2_encode(h + h[:1], cpu), P.g2_encode([sig.point], cpu),
                torch.tensor([False, False, False, True]))
        assert eager(TB._aggregate_verify_kernel, *args) is want

    # the epoch batch: B = 4 committees of 3, positions = 4
    committees, sigs, hs = [], [], []
    for s in range(4):
        members = [(s * 7 + j * 3) % 8 for j in range(3)]
        committees.append([api.SecretKey(1000 + m).public_key().point for m in members])
        msg = s.to_bytes(8, "big") * 4
        sigs.append(api.SecretKey(sum(1000 + m for m in members) % params.R).sign(msg).point)
        hs.append(hash_to_g2(msg))
    bad = [list(c) for c in committees]
    bad[2][1] = api.SecretKey(31337).public_key().point
    tail = (P.g2_encode(sigs, cpu), P.g2_encode(hs, cpu),
            TB._pack_wbits([0x9E3779B97F4A7C15 ^ (i * 0x2545F4914F6CDD1D) or 1
                            for i in range(4)]))
    batches = [(*TB.encode_committee_pubkeys(c, 4), *tail) for c in (committees, bad, committees)]
    prog = bk.epoch_program(4, 4)
    prog(*batches[0])  # the build
    TB.reset_launch_counts()
    handles = [prog(*args) for args in batches]  # all in flight before the first resolve
    graph = [bk.resolve(h) for h in handles]
    assert graph == [True, False, True]
    assert set(TB.launch_counts().values()) == {0}
    assert len(bk.builds) == 2 and bk.epoch_program(4, 4) is prog
    assert [eager(lambda *a: TB._epoch_verify_kernel(*a, 4), *args)
            for args in batches] == graph


@pytest.mark.cuda
def test_cuda_prewarm_builds_the_stored_keys_from_their_skeletons(tmp_path, monkeypatch):
    """Warm boot at B = 8 under the mxu plane with chains and WSM off (the
    combination a tuned plan picks; chip_smoke's program phase does not run
    it): a backend with an AOT store attached builds the verify key from
    traffic, a fresh backend prewarms it from the store (one build from zeros
    of the skeleton's shapes), and its replays give True, False, True with
    no launch counted and no key built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls.torch_backend import aot
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB

    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", True)
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    first = TB.TorchBackend(device="cuda", min_batch=8)
    first.attach_aot_store(store)
    corpora = _graph_corpora()
    mbs = {c: first.marshal_sets(corpora[c]) for c in ("valid", "one_invalid")}
    assert first.verify_marshalled(mbs["valid"]) is True
    key = (8, True, True, False, False)
    assert list(first.builds) == [key]
    (meta,) = store.entries().values()
    assert meta["cache_key"] == list(key) and meta["device"] == torch.cuda.get_device_name()

    bk = TB.TorchBackend(device="cuda", min_batch=8)
    report = aot.prewarm(bk, store)
    assert len(report.loaded) == 1 and not report.rejected and not report.stale
    rec = report.builds[report.loaded[0]]
    assert rec["capture_s"] > 0 and rec["instantiate_device_bytes"] >= 0
    assert bk.builds[key]["launches"] == first.builds[key]["launches"]
    TB.reset_launch_counts()
    handles = [bk.dispatch(mbs[c]) for c in ("valid", "one_invalid", "valid")]
    assert [bk.resolve(h) for h in handles] == [True, False, True]
    assert set(TB.launch_counts().values()) == {0} and list(bk.builds) == [key]


class _Registry:
    """ValidatorPubkeyCache stand-in: index -> PublicKey."""

    def __init__(self, keys):
        self._keys = list(keys)

    def __len__(self):
        return len(self._keys)

    def get(self, i):
        return self._keys[i]


@pytest.mark.cuda
def test_cuda_registry_gather_matches_host_assembly():
    """The ingest engine's all-registry batch on the card: the pubkey
    operand gathered on the card (marshalled on a side stream, the batch
    carrying the gather's event) equals host assembly and the scalar
    marshal byte for byte, and dispatch through the B = 8 graph gives True,
    and False with one signature swapped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.ingest import IngestEngine
    from lighthouse_tpu_torch.utils import metrics as M

    sks = [api.SecretKey(5000 + 7 * i) for i in range(40)]
    keys = [sk.public_key() for sk in sks]
    slots = [37, 2, 19, 0, 25, 11]
    sets = [api.SignatureSet(sks[i].sign(b"reg %d" % i), [keys[i]], b"reg %d" % i)
            for i in slots]
    bad = list(sets)
    bad[3] = api.SignatureSet(sks[5].sign(b"other"), [keys[slots[3]]], sets[3].message)
    bk = TB.TorchBackend(device="cuda", min_batch=8)
    dev = IngestEngine(bk, pubkey_cache=_Registry(keys))
    host = IngestEngine(bk, pubkey_cache=_Registry(keys), device_gather=False)
    ws = [3 + i for i in range(len(sets))]
    f0 = M.INGEST_FALLBACKS.value()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        mb = dev.marshal_sets(sets, ws)
    want = host.marshal_sets(sets, ws)
    scalar = bk.marshal_sets(sets, ws)
    assert M.INGEST_FALLBACKS.value() == f0
    assert isinstance(mb.ready, torch.cuda.Event)
    pk = mb.args[0]
    assert all(c.limbs.device.type == "cuda" and c.bound == 1.0 for c in pk)
    torch.cuda.current_stream().wait_event(mb.ready)
    for a, b, c in zip(pk, want.args[0], scalar.args[0]):
        assert torch.equal(a.limbs.cpu(), b.limbs) and torch.equal(b.limbs, c.limbs)
    assert dev.cache.device_bytes() == 2 * F.N * 4 * 40
    TB.reset_launch_counts()
    assert bk.resolve(bk.dispatch(mb)) is True  # builds the key, then replays
    with torch.cuda.stream(side):
        mb_bad = dev.marshal_sets(bad)
    assert bk.resolve(bk.dispatch(mb_bad)) is False
    assert len(bk.builds) == 1 and M.INGEST_FALLBACKS.value() == f0


@pytest.mark.cuda
def test_cuda_epoch_pipeline_matches_cpu():
    """The epoch balance pipeline on the card equals its CPU run exactly, at
    4,097 validators, finalizing and leaking."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    import numpy as np

    from lighthouse_tpu_torch.consensus.state_processing import arrays as PA
    from lighthouse_tpu_torch.consensus.state_processing import per_epoch_torch as PT

    rng = np.random.default_rng(29)
    n = 4097
    va = PA.ValidatorArrays(
        effective_balance=rng.integers(16, 33, n).astype(np.int64) * 10**9,
        slashed=rng.random(n) < 0.05,
        activation_eligibility_epoch=np.zeros(n, np.int64),
        activation_epoch=np.where(rng.random(n) < 0.02, PA.FAR, 0).astype(np.int64),
        exit_epoch=np.where(rng.random(n) < 0.02, 90, PA.FAR).astype(np.int64),
        withdrawable_epoch=np.where(rng.random(n) < 0.5, 100 + 4096, PA.FAR).astype(np.int64),
        balances=rng.integers(15 * 10**9, 34 * 10**9, n).astype(np.int64),
    )
    flags, scores = rng.integers(0, 8, n), rng.integers(0, 200, n)
    for finalized in (98, 50):
        args = (va, flags, scores, 100, 99, finalized, 512 * 10**9, PT.MAINNET)
        kw = dict(multiplier=PT.BELLATRIX_SLASHING_MULTIPLIER,
                  inactivity_quotient=PT.BELLATRIX_INACTIVITY_QUOTIENT)
        card = PT.epoch_balance_pipeline(*args, **kw)  # the card by default
        cpu = PT.epoch_balance_pipeline(*args, **kw, device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(card, cpu))


def _mesh_sets(n, bad=()):
    """n single-signer sets under distinct keys; the sets at ``bad`` carry a
    signature of another message."""
    from lighthouse_tpu_torch.crypto.bls import api

    sks = [api.SecretKey(7100 + 13 * i) for i in range(n)]
    sets = []
    for i, sk in enumerate(sks):
        msg = b"mesh %d" % i
        sig = sk.sign(b"other" if i in bad else msg)
        sets.append(api.SignatureSet(sig, [sk.public_key()], msg))
    return sets


@pytest.mark.cuda
def test_cuda_two_threads_through_one_key_keep_their_verdicts():
    """The replay lock (program.GraphPool.lock): two threads, each on its own
    stream, dispatch 20 alternating valid and bad B = 8 batches through the
    same key, all in flight before the first resolve; every verdict is the
    batch's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    import threading

    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB

    bk = TB.TorchBackend(device="cuda", min_batch=8)
    good, bad = bk.marshal_sets(_mesh_sets(8)), bk.marshal_sets(_mesh_sets(8, bad=(5,)))
    assert bk.resolve(bk.dispatch(good)) is True  # builds the key
    results, errors = {}, []

    def run(tid):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                order = [(i + tid) % 2 == 0 for i in range(20)]
                handles = [bk.dispatch(good if ok else bad) for ok in order]
                results[tid] = ([bk.resolve(h) for h in handles], order)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and len(results) == 2
    for got, want in results.values():
        assert got == want
    assert len(bk.builds) == 1


@pytest.mark.cuda
def test_cuda_sharded_program_on_two_seats_matches_single_device():
    """ShardedVerifyProgram over a 2-seat mesh on one card at B = 16: both
    seats share the backend and its B = 8 key; the verdict vector is
    [True, True] on a valid batch and [True, False] with set 10 bad, and its
    conjunction equals the single-device verdict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.parallel import make_mesh
    from lighthouse_tpu_torch.parallel.partition import ShardedVerifyProgram

    bk = TB.TorchBackend(device="cuda", min_batch=8)
    mesh = make_mesh(2, device="cuda:0")
    assert bk.for_device(mesh.seats[0]) is bk and bk.for_device(mesh.seats[1]) is bk
    prog = ShardedVerifyProgram(mesh, seat_program=bk.seat_program, pk_wrap=bk.registry_pk_wrap)
    for bad, want in (((), [True, True]), ((10,), [True, False])):
        mb = bk.marshal_sets(_mesh_sets(16, bad=bad))
        assert list(prog.verdict_vector(mb.args)) == want
        assert bk.verify_marshalled(mb) is all(want)
    assert sorted(k[0] for k in bk.builds) == [8, 16]


@pytest.mark.cuda
def test_cuda_sharded_registry_gather_is_byte_equal_to_host_take():
    """The partitioned registry on a 2-seat mesh of one card: each seat holds
    half the mirror's bytes, and the seats' gathered pubkey planes equal the
    host take of the slots, column for column."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    import numpy as np

    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.ingest import PubkeyLimbCache
    from lighthouse_tpu_torch.parallel import make_mesh
    from lighthouse_tpu_torch.parallel import partition as PP

    keys = [api.SecretKey(5000 + 7 * i).public_key() for i in range(40)]
    cache = PubkeyLimbCache(device="cuda")
    cache.sync_registry(_Registry(keys))
    mesh = make_mesh(2, device="cuda:0")
    reg_x, reg_y = cache.registry_device_sharded(mesh)
    assert all(x.nbytes + y.nbytes == cache.device_bytes() // 2 for x, y in zip(reg_x, reg_y))
    slots = torch.as_tensor([37, 2, 19, 0, 25, 11, 39, 20], dtype=torch.int64)
    xs, ys = PP._registry_gather(reg_x, reg_y, [slots.cuda()] * 2, mesh)
    hx, hy = cache.registry_columns(slots.numpy())
    got_x = np.concatenate([x.cpu().numpy() for x in xs], axis=1)
    got_y = np.concatenate([y.cpu().numpy() for y in ys], axis=1)
    assert np.array_equal(got_x, hx) and np.array_equal(got_y, hy)


def _serve_sets(n, bad=()):
    from lighthouse_tpu_torch.crypto.bls import api

    out = []
    for i in range(n):
        sk = api.SecretKey(7000 + 11 * i)
        msg = bytes([i % 251, 3]) * 16
        sig = sk.sign(b"another message" if i in bad else msg)
        out.append(api.SignatureSet(sig, [sk.public_key()], msg))
    return out


@pytest.mark.cuda
def test_cuda_guarded_stack_at_b8_matches_the_truth(monkeypatch):
    """build_verify_stack over TorchBackend on the card (integrity auto: the
    guard, k = 2): an 8-set batch with set 5 bad comes back with set 5
    False and the rest True, every batch on the device rung (the canaries
    included), no canary mismatch, the breaker closed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.integrity import IntegrityGuard
    from lighthouse_tpu_torch.serve.stack import build_verify_stack

    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", False)
    bk = TB.TorchBackend(device="cuda", min_batch=8)
    monkeypatch.setattr(api, "_BACKENDS", {**api._BACKENDS, "torch": bk})
    monkeypatch.setattr(api, "_ACTIVE", [])
    api.set_backend("torch")
    assert bk.warm_compile(8)  # the canaries' key, before traffic
    stack = build_verify_stack()
    assert isinstance(stack.integrity, IntegrityGuard) and stack.pod is None
    out = stack.verifier.verify_batch(_serve_sets(8, bad=(5,)))
    assert out.verdicts == [i != 5 for i in range(8)]
    assert stack.integrity.stats()["distrusted"] == 0
    assert stack.resilient.journal and all(k == "device" for k, _ in stack.resilient.journal)
    assert stack.breaker.is_closed
    assert list(bk.builds) == [(8, True, False, False, False)]


@pytest.mark.cuda
def test_cuda_audit_runs_its_arm_pinned_while_another_thread_dispatches(monkeypatch):
    """The cross-arm audit under mxu13 on one thread builds and replays the
    mxu13 key (B = 8) while a second thread dispatches the default arm's key
    on its own stream: the second thread's key never changes arm, every
    verdict is right, and the process-wide gates stay on the default arm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check there)")
    import threading

    from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
    from lighthouse_tpu_torch.integrity import CrossArmAuditor

    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", False)
    bk = TB.TorchBackend(device="cuda", min_batch=8)
    good, bad = _serve_sets(8), _serve_sets(8, bad=(2,))
    mbs = [bk.marshal_sets(good), bk.marshal_sets(bad)]
    assert bk.resolve(bk.dispatch(mbs[0])) is True  # the default key, built
    auditor = CrossArmAuditor(lambda s: True, backend=bk, arms=("mxu13",), fraction=1.0)
    done, seen, errors, audited = threading.Event(), [], [], {}

    def audit():
        try:
            audited["good"] = auditor.maybe_audit(good)
            audited["bad"] = auditor.maybe_audit(bad)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)
        finally:
            done.set()

    def dispatcher():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                while not done.is_set() or len(seen) < 4:
                    i = len(seen) % 2
                    seen.append((bk._arm(8), bk.resolve(bk.dispatch(mbs[i])), i == 0))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=audit), threading.Thread(target=dispatcher)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors
    assert audited["good"] == ([True] * 8, "mxu13")
    assert audited["bad"] == ([i != 2 for i in range(8)], "mxu13")
    assert all(arm == (False, False, False) and got is want for arm, got, want in seen)
    assert not F.mxu_active()
    assert set(bk.builds) == {(8, True, False, False, False), (8, True, True, False, False)}
