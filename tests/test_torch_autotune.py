"""The port's per-device kernel autotuner (torch_backend/autotune.py) against
jax_backend/autotune.py: twins of the 14 tests of tests/test_autotune.py.

They pin the plan's lifecycle on the CPU with a stubbed ``measure`` or an
injected timer: legality (range-proven at zero waivers), the winner per
shape, persistence in the AOT store's signed manifest, a cold restart that
installs the plan with no trial and builds the plan's key, stale and
tampered plans behaving cold, and the override precedence (``set_mxu`` >
``LIGHTHOUSE_TPU_MXU`` > plan > off).  The real trial harness runs once on
the plain kernels at 64 lanes.  The device programs are stubbed (as in
tests/test_torch_program.py), so no real verify runs.  The CUDA-event trial
on the card is run by chip_smoke.py's boot phase.
"""

import json

import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls.jax_backend import autotune as JT  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import fp as JF  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import _build  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import aot, autotune  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import program as PG  # noqa: E402
from lighthouse_tpu_torch.utils import device_kind  # noqa: E402
from lighthouse_tpu_torch.utils.metrics import JIT_COMPILE_SECONDS  # noqa: E402

VPU, MXU = autotune.ARMS  # ("vpu15", ...), ("mxu13", ...)


@pytest.fixture(autouse=True)
def _clean_routing(monkeypatch):
    """Every test starts and ends with no override, no env flag and no
    installed plan, in both packages: the routing state is process-global."""
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    prev = F.set_mxu(None)
    F.install_mxu_plan(None)
    jprev = JF.set_mxu(None)
    JF.install_mxu_plan(None)
    yield
    F.set_mxu(prev)
    F.install_mxu_plan(None)
    JF.set_mxu(jprev)
    JF.install_mxu_plan(None)


@pytest.fixture
def stub(monkeypatch):
    """The verify programs replaced by recorders of the arm they run under."""
    calls = []
    for name in ("_verify_kernel_h2c", "_verify_kernel"):
        def program(*args):
            calls.append(F.mxu_active())
            return torch.ones((1,), dtype=torch.bool)

        program.__name__ = name
        monkeypatch.setattr(TB, name, program)
    return calls


def _measure_by_shape(winners: dict):
    """Stub ``measure(arm, batch) -> seconds``: the arm named in
    ``winners[batch]`` gets 1ms, every other arm 2ms."""
    def measure(arm, batch):
        return 0.001 if winners[batch] == arm.arm else 0.002

    return measure


# ---------------------------------------------------------------------------
# Selection: measured winner per shape, deterministic under a stub
# ---------------------------------------------------------------------------


def test_tune_selects_measured_winner_per_shape():
    plan = autotune.tune(shapes=(64, 128),
                         measure=_measure_by_shape({64: "vpu15", 128: "mxu13"}))
    assert plan["schema"] == autotune.PLAN_SCHEMA
    assert plan["torch"] == torch.__version__ and plan["cuda"] == torch.version.cuda
    assert plan["device_kind"] == device_kind() == "cpu"
    assert plan["source_hash"] == _build.source_hash()
    assert plan["shapes"]["64"]["arm"] == "vpu15"
    assert plan["shapes"]["128"]["arm"] == "mxu13"
    # every legal arm was trialled at every shape, timings on record
    for entry in plan["shapes"].values():
        assert set(entry["trials_ms"]) == {"vpu15", "mxu13"}
        assert entry["kernel"] == "_verify_kernel"


def test_tune_is_deterministic_under_equal_timings():
    # exact ties break lexicographically, not by dict order
    p1 = autotune.tune(shapes=(64,), measure=lambda a, b: 0.001)
    p2 = autotune.tune(shapes=(64,), measure=lambda a, b: 0.001)
    assert p1["shapes"] == p2["shapes"]
    assert p1["shapes"]["64"]["arm"] == "mxu13"  # min lexicographic id


def test_install_plan_routes_per_shape_with_largest_as_default():
    plan = autotune.tune(shapes=(8, 64), measure=_measure_by_shape({8: "vpu15", 64: "mxu13"}))
    assert autotune.install_plan(plan) == 2
    assert F.mxu_for_batch(8) is False
    assert F.mxu_for_batch(64) is True
    # off-ladder shapes follow the largest tuned shape's arm
    assert F.mxu_for_batch(4096) is True
    assert F.mxu_enabled() is True
    autotune.clear_plan()
    assert F.mxu_for_batch(64) is False


# ---------------------------------------------------------------------------
# Legality: unproven arms never enter trials
# ---------------------------------------------------------------------------


def test_unproven_arm_never_enters_trials():
    ghost = autotune.Arm("ghost9", "SPEC15", "set_mxu", False, "")
    ran = []

    def measure(arm, batch):
        ran.append(arm.arm)
        return 0.001

    plan = autotune.tune(shapes=(64,), arms=[ghost, MXU], measure=measure)
    assert "ghost9" not in ran
    assert set(plan["shapes"]["64"]["trials_ms"]) == {"mxu13"}
    # nothing legal at all -> refuse to tune rather than guess
    with pytest.raises(ValueError):
        autotune.tune(shapes=(64,), arms=[ghost], measure=measure)


def test_unregistered_arm_filtered_even_with_proof_claim():
    # an arm not in the proven set (unknown proof program) is excluded
    rogue = autotune.Arm("rogue1", "SPEC15", "set_mxu", True, "no_such_prog")
    with pytest.raises(ValueError):
        autotune.tune(shapes=(64,), arms=[rogue], measure=lambda a, b: 0.001)


def test_proven_arms_require_contracts_ok_at_zero_waivers(tmp_path):
    report = tmp_path / "range.json"
    waivers = tmp_path / "waivers.toml"
    report.write_text(json.dumps({"programs": {
        "pallas_mont_mul": {"contracts_ok": True},
        "mxu_mont_mul": {"contracts_ok": False},
    }}))
    got = autotune.proven_arms(str(report), str(waivers))
    assert [a.arm for a in got] == ["vpu15"]
    # one range-family waiver voids every arm's clearance
    waivers.write_text('[[waiver]]\nrule = "range-overflow"\npath = "*"\nreason = "test"\n')
    assert autotune.proven_arms(str(report), str(waivers)) == ()
    # so does a pattern that matches a range rule
    waivers.write_text('[[waiver]]\nrule = "range-*"\npath = "*"\nreason = "test"\n')
    assert autotune.proven_arms(str(report), str(waivers)) == ()
    # a non-range waiver does not
    waivers.write_text('[[waiver]]\nrule = "lock-discipline"\npath = "*"\nreason = "test"\n')
    assert [a.arm for a in autotune.proven_arms(str(report), str(waivers))] == ["vpu15"]
    # a waivers file that does not parse proves nothing
    waivers.write_text('[[waiver]\nrule = \n')
    assert autotune.proven_arms(str(report), str(waivers)) == ()


def test_live_registry_arms_are_all_proven():
    # the shipped ARM_TABLE must be fully legal against the shipped
    # RANGE_REPORT.json and waivers.toml — a regression here means tuning
    # silently shrinks to a subset; the reference's gate agrees
    assert autotune.ARM_TABLE == JT.ARM_TABLE
    proven = {a.arm for a in autotune.proven_arms()}
    assert proven == {a.arm for a in autotune.ARMS} == {a.arm for a in JT.proven_arms()}


# ---------------------------------------------------------------------------
# Persistence: signed plan table, round trip through a cold restart
# ---------------------------------------------------------------------------


def _serve(bk, B):
    """One verify of a padded batch of ``B`` (one signed set, tiled)."""
    sk = tapi.SecretKey(11)
    msg = b"autotune"
    mb = bk.marshal_sets([tapi.SignatureSet(sk.sign(msg), [sk.public_key()], msg)],
                         weights=[3])
    reps = B // mb.B
    mb.args = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), reps), mb.args)
    mb.B = B
    return bk.verify_marshalled(mb)


def test_plan_round_trip_cold_restart_zero_builds(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    plan = autotune.tune_and_store(store, shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    assert store.plan() == plan  # byte round trip through the manifest
    assert F.mxu_for_batch(8) is True  # tune_and_store installs too
    # a serving node under the plan captures the plan's key
    first = TB.TorchBackend(device="cpu", min_batch=8)
    first.attach_aot_store(store)
    assert _serve(first, 8) is True
    key = (8, True, True, False, False)
    assert list(first.builds) == [key] and stub == [True]

    # "cold restart": routing state wiped, fresh backend, prewarm
    autotune.clear_plan()
    backend = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(backend, store)
    assert report.plan_shapes == 1
    assert F.mxu_for_batch(8) is True  # plan reinstalled before the entries
    assert report.loaded and list(backend.builds) == [key]
    prog = backend._programs[key]
    assert backend.builds[key]["aot"] is True
    # the dispatcher resolves the plan to the built key: the same object, no
    # second build, the first batch served by it under the plan's arm
    builds0 = JIT_COMPILE_SECONDS.count()
    assert backend._program(8) is prog
    assert _serve(backend, 8) is True and stub[-1] is True
    assert JIT_COMPILE_SECONDS.count() == builds0


@pytest.mark.parametrize("field,value", [("torch", "0.0.0"), ("cuda", "0.0"),
                                         ("device_kind", "NVIDIA H9999"),
                                         ("source_hash", "0000000000000000"),
                                         ("schema", autotune.PLAN_SCHEMA + 1)])
def test_stale_plan_on_version_device_or_source_bump_behaves_cold(tmp_path, field, value):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    plan = autotune.tune(shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    stale = dict(plan, **{field: value})
    store.write_plan(stale)
    assert store.plan() == stale  # signed fine — just not for us
    assert autotune.install_plan(stale) == 0
    report = aot.prewarm(TB.TorchBackend(device="cpu", min_batch=8), store)
    assert report.plan_shapes == 0
    assert F.mxu_for_batch(8) is False  # cold default


def test_tampered_plan_rejected_by_manifest_signature(tmp_path):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    autotune.tune_and_store(store, shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    # hand-edit the plan WITHOUT re-signing: flip the winning arm
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    doc["plan"]["shapes"]["8"]["arm"] = "vpu15"
    with open(store.manifest_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)

    autotune.clear_plan()
    assert store.plan() == {}
    report = aot.prewarm(TB.TorchBackend(device="cpu", min_batch=8), store)
    assert report.plan_shapes == 0
    assert F.mxu_for_batch(8) is False  # tampered == cold, never vpu-vs-mxu roulette


def test_capture_preserves_plan_but_never_resigns_a_tampered_one(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    plan = autotune.tune(shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    store.write_plan(plan)
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    bk.attach_aot_store(store)
    # a capture (entries rewrite) keeps the verified plan riding along
    assert _serve(bk, 8) is True
    assert store.plan() == plan
    # but once tampered, the next capture drops it instead of re-signing
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    doc["plan"]["torch"] = "9.9.9"
    with open(store.manifest_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    assert _serve(bk, 16) is True
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    assert "plan" not in doc
    assert len(doc["entries"]) == 2


# ---------------------------------------------------------------------------
# Override precedence: set_mxu > env flag > plan
# ---------------------------------------------------------------------------


def test_env_flag_override_beats_plan(monkeypatch):
    plan = autotune.tune(shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    autotune.install_plan(plan)
    assert F.mxu_for_batch(8) is True
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "0")
    assert F.mxu_for_batch(8) is False  # operator forces one arm everywhere
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "1")
    assert F.mxu_for_batch(4096) is True
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU")
    assert F.mxu_for_batch(8) is True  # plan resumes, never latched out


def test_set_mxu_override_beats_env_and_plan(monkeypatch):
    plan = autotune.tune(shapes=(8,), measure=_measure_by_shape({8: "mxu13"}))
    autotune.install_plan(plan)
    monkeypatch.setenv("LIGHTHOUSE_TPU_MXU", "1")
    prev = F.set_mxu(False)
    try:
        assert F.mxu_for_batch(8) is False
    finally:
        F.set_mxu(prev)
    assert F.mxu_for_batch(8) is True


# ---------------------------------------------------------------------------
# The real trial harness, once, with an injected deterministic timer
# ---------------------------------------------------------------------------


def test_trial_harness_runs_real_kernel_with_injected_timer(monkeypatch):
    from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK
    from lighthouse_tpu_torch.crypto.bls.torch_backend import mxu_kernel as X

    routed = []
    for mod, name in ((MK, "mont_mul"), (X, "mont_mul_mxu")):
        def spy(a, b, *rest, _fn=getattr(mod, name), _name=name):
            routed.append((_name, a.shape[-1]))
            return _fn(a, b, *rest)

        monkeypatch.setattr(mod, name, spy)
    for arm, name in ((VPU, "mont_mul"), (MXU, "mont_mul_mxu")):
        ticks = iter(range(1000))
        del routed[:]
        best = autotune.trial(arm, 64, iters=2, timer=lambda: float(next(ticks)))
        # counter timer: every measured window is exactly one tick
        assert best == 1.0
        # the arm's routed product ran on the plain kernel at 64 lanes:
        # a warm-up call and one per window
        assert routed == [(name, 64)] * 3
        # the pinned toggle was restored
        assert F.mxu_enabled() is False


# ---------------------------------------------------------------------------
# Cross-check: the same timings route every shape the same in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("winners", [{64: "vpu15", 128: "mxu13"}, {64: "mxu13", 128: "vpu15"},
                                     {64: "mxu13", 128: "mxu13"}])
def test_reference_and_port_plans_route_every_shape_the_same(winners):
    measure = _measure_by_shape(winners)
    jplan = JT.tune(shapes=tuple(winners), measure=measure)
    tplan = autotune.tune(shapes=tuple(winners), measure=measure)
    assert {k: v["arm"] for k, v in jplan["shapes"].items()} == \
        {k: v["arm"] for k, v in tplan["shapes"].items()}
    assert JT.install_plan(jplan) == autotune.install_plan(tplan) == len(winners)
    for batch in (8, 64, 100, 128, 4096, 8192):
        assert JF.mxu_for_batch(batch) == F.mxu_for_batch(batch), batch
