"""Warm boot of the port (torch_backend/aot.py and TorchBackend's store seams)
against jax_backend/aot.py: twins of tests/test_prewarm.py, with the same
lifecycle — capture on a key's first build, signed manifest, cold-restart
prewarm, integrity rejection, version invalidation, prewarm beside serving.

The port's store keeps each program's operand skeleton, not the program (a
CUDA graph cannot be written to disk), so a prewarm builds each current key
once from zeros of its skeleton's shapes, and the serving path then builds
nothing.  On the CPU a key's program is the eager one and its first call is
its build (``program.EagerProgram``, timed into ``JIT_COMPILE_SECONDS``); the
device programs are stubbed here, as in tests/test_torch_program.py, so no
real verify runs.  The build from a skeleton on the card is checked by
chip_smoke.py's boot phase and tests/test_torch_cuda.py.
"""

import inspect
import json
import sys
import threading

import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls.jax_backend import aot as JA  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import aot  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import program as PG  # noqa: E402
from lighthouse_tpu_torch.utils.metrics import (  # noqa: E402
    AOT_CACHE_HITS,
    AOT_CACHE_MISSES,
    AOT_CACHE_REJECTS,
    JIT_COMPILE_SECONDS,
)

PROGRAMS = ("_verify_kernel_h2c", "_verify_kernel", "_aggregate_verify_kernel")


@pytest.fixture
def stub(monkeypatch):
    """The arm gates off, no plan and no env flag; the three device programs
    replaced by recorders of (name, operands) whose verdict is True."""
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", None)
    monkeypatch.setattr(F, "_MXU_PLAN", None)
    calls = []
    for name in PROGRAMS:
        def program(*args, _name=name):
            calls.append((_name, args))
            return torch.ones((1,), dtype=torch.bool)

        program.__name__ = name
        monkeypatch.setattr(TB, name, program)
    return calls


def _sets(n, msg=b"warm boot"):
    sks = [tapi.SecretKey(300 + i) for i in range(n)]
    return [tapi.SignatureSet(sk.sign(msg), [sk.public_key()], msg) for sk in sks]


def _batch(bk, B):
    """A padded batch of B sets: one signed set marshalled and tiled (every
    operand is batch-last)."""
    mb = bk.marshal_sets(_sets(1), weights=[5])
    reps = B // mb.B
    args = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), reps), mb.args)
    return TB.MarshalledBatch(B, B, bk.device_h2c, args)


def _stage(store, sizes=(8, 16)):
    """Serve one batch of each size through a backend with the store
    attached: each key's first build records it, as on a serving node."""
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    bk.attach_aot_store(store)
    for B in sizes:
        assert bk.verify_marshalled(_batch(bk, B)) is True
    return bk


def _rewrite_entries(store, mutate) -> None:
    """Apply ``mutate(entries)`` and re-sign: a legitimate writer (an older
    process, say), not tampering."""
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    mutate(doc["entries"])
    doc["signature"] = aot.manifest_signature(doc["entries"])
    with open(store.manifest_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def _zero_operands(args) -> bool:
    return all(not bool(t.any()) for t, _ in PG._leaves(args))


# ---------------------------------------------------------------------------
# Populate -> cold restart -> prewarm; the serving path builds nothing
# ---------------------------------------------------------------------------


def test_populate_then_cold_restart_prewarm_zero_builds(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    first = _stage(store, sizes=(8, 16))
    entries = store.entries()
    assert len(entries) == 2
    for fp_hex, meta in entries.items():
        assert meta["kernel"] == "_verify_kernel_h2c"
        assert meta["torch"] == torch.__version__ and meta["cuda"] == torch.version.cuda
        assert meta["device"] == "cpu" and meta["size"] > 0
        assert first.builds[tuple(meta["cache_key"])]["fingerprint"] == fp_hex

    # "cold restart": a fresh backend prewarms from the store, one build per entry
    hits0, builds0 = AOT_CACHE_HITS.value(), JIT_COMPILE_SECONDS.count()
    del stub[:]
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(bk, store)
    assert sorted(report.loaded) == sorted(entries)
    assert not report.rejected and not report.stale and not report.compiled
    assert AOT_CACHE_HITS.value() == hits0 + 2
    assert JIT_COMPILE_SECONDS.count() == builds0 + 2
    assert sorted(report.builds) == sorted(entries)
    assert all(rec["build_s"] >= 0 for rec in report.builds.values())
    # each build ran the program once, on zeros of the key's shapes
    assert [name for name, _ in stub] == ["_verify_kernel_h2c"] * 2
    assert sorted(args[-1].shape[-1] for _, args in stub) == [8, 16]
    assert all(_zero_operands(args) for _, args in stub)
    # the acceptance criterion: no build on the serving path, first batch included
    served = JIT_COMPILE_SECONDS.count()
    for B in (8, 16):
        prog = bk._program(B)
        assert prog.built and bk.builds[prog.key]["aot"] is True
        assert bk.verify_marshalled(_batch(bk, B)) is True
    assert JIT_COMPILE_SECONDS.count() == served and len(bk.builds) == 2
    assert store.entries() == entries  # a prewarmed key is not captured again


def test_capture_is_never_raise(tmp_path, stub):
    # a call object without .fingerprint/.device cannot be recorded; capture
    # must swallow it (a failed capture costs a build, not a serving error)
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    assert store.capture(object(), (8, True, False, False, False), (torch.zeros(3),)) is False
    assert store.entries() == {}
    # nor does a store that cannot be written fail the batch whose build it records
    (tmp_path / "a_file").write_text("")
    broken = aot.AotStore(str(tmp_path / "a_file" / "aot_cache"))
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    bk.attach_aot_store(broken)
    assert bk.verify_marshalled(_batch(bk, 8)) is True
    assert broken.entries() == {}


# ---------------------------------------------------------------------------
# Integrity: byte flip, parse failure, truncation, tamper -> reject, not raise
# ---------------------------------------------------------------------------


def test_byte_flipped_skeleton_rejected_not_raised(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    (fp_hex, meta), = store.entries().items()
    blob = tmp_path / "aot_cache" / meta["blob"]
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))

    rejects0 = AOT_CACHE_REJECTS.value()
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(bk, store, compile_misses=False)
    assert report.loaded == []
    assert report.rejected == [fp_hex]
    assert AOT_CACHE_REJECTS.value() > rejects0
    assert bk.builds == {}


def test_skeleton_that_does_not_parse_rejected_not_raised(tmp_path, stub):
    # the hash matches (a legitimate writer re-signed it), the content is no skeleton
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    (fp_hex, meta), = store.entries().items()
    bad = b'[{"bound":1.0,"dtype":"torch.float64","shape":[26,8]}]'
    (tmp_path / "aot_cache" / meta["blob"]).write_bytes(bad)

    def resign(entries):
        entries[fp_hex]["sha256"] = aot.hashlib.sha256(bad).hexdigest()
        entries[fp_hex]["size"] = len(bad)

    _rewrite_entries(store, resign)
    rejects0 = AOT_CACHE_REJECTS.value()
    assert store.load(fp_hex) is None
    assert AOT_CACHE_REJECTS.value() == rejects0 + 1
    with pytest.raises(ValueError):
        aot.parse_skeleton(bad)


def test_rejected_verify_entry_is_rebuilt_with_compile_misses(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    (fp_hex, meta), = store.entries().items()
    (tmp_path / "aot_cache" / meta["blob"]).write_bytes(b"[]")
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    bk.attach_aot_store(store)
    report = aot.prewarm(bk, store, compile_misses=True)
    assert report.rejected == [fp_hex] and report.compiled == [fp_hex]
    assert list(bk.builds) == [(8, True, False, False, False)]
    assert store.load(fp_hex) is not None  # the rebuild captured it again: healed


def test_truncated_manifest_reads_as_cold_store(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    with open(store.manifest_path, "w", encoding="utf-8") as f:
        f.write('{"schema": 1, "entries": {"aa')
    rejects0 = AOT_CACHE_REJECTS.value()
    assert store.entries() == {}
    assert AOT_CACHE_REJECTS.value() == rejects0 + 1


def test_tampered_entries_fail_signature_as_a_unit(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8, 16))
    # hand-edit WITHOUT re-signing: the whole table is rejected
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    next(iter(doc["entries"].values()))["size"] += 1
    with open(store.manifest_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    assert store.entries() == {}


def test_missing_entry_counts_a_miss(tmp_path):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    misses0 = AOT_CACHE_MISSES.value()
    assert store.load("no-such-fingerprint") is None
    assert AOT_CACHE_MISSES.value() == misses0 + 1


def test_entry_under_another_fingerprint_rejected_not_raised(tmp_path, stub):
    # a re-signed entry whose fingerprint is not its key's program's here
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    (fp_hex, _), = store.entries().items()
    _rewrite_entries(store, lambda e: e.update({"0123456789ab": e.pop(fp_hex)}))
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(bk, store)
    assert report.rejected == ["0123456789ab"] and bk.builds == {}
    skel = aot.parse_skeleton(aot.skeleton(_batch(bk, 8).args))
    with pytest.raises(ValueError):
        bk.install_program((8, True, False, False, False), "0123456789ab", skel)


def test_failed_build_of_a_current_entry_raises(tmp_path, stub, monkeypatch):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))

    def broken(*args):
        raise RuntimeError("capture failed")

    broken.__name__ = "_verify_kernel_h2c"
    monkeypatch.setattr(TB, "_verify_kernel_h2c", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        aot.prewarm(TB.TorchBackend(device="cpu", min_batch=8), store)


# ---------------------------------------------------------------------------
# Version, device and arm -> stale skip (the upgrade story)
# ---------------------------------------------------------------------------


def test_torch_version_bump_invalidates_entries(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8, 16))

    def bump(entries):
        for meta in entries.values():
            meta["torch"] = "0.0.0"

    _rewrite_entries(store, bump)
    misses0 = AOT_CACHE_MISSES.value()
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(bk, store)
    assert report.loaded == [] and report.rejected == []
    assert len(report.stale) == 2
    assert AOT_CACHE_MISSES.value() == misses0 + 2
    assert bk.builds == {}


@pytest.mark.parametrize("change", ["cuda", "device", "device_h2c", "chains", "wsm", "mxu",
                                    "epoch_key"])
def test_entry_for_another_device_or_arm_is_stale(tmp_path, stub, change):
    """The port's key holds all five gates, so an entry built under another
    chain, WSM or mxu setting than the one in force is stale, as is one of
    another CUDA version, device or h2c mode, or of a program the store does
    not capture."""
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8,))
    if change in ("cuda", "device"):
        _rewrite_entries(store, lambda e: [m.update({change: "other"}) for m in e.values()])
    elif change == "epoch_key":
        _rewrite_entries(store, lambda e: [m.update(kernel="_epoch_verify_kernel",
                                                    cache_key=["epoch", 8, 4, False, False, False])
                                           for m in e.values()])
    elif change != "device_h2c":
        {"chains": F.set_chains, "wsm": F.set_wsm, "mxu": F.set_mxu}[change](True)
    bk = TB.TorchBackend(device="cpu", min_batch=8, device_h2c=change != "device_h2c")
    report = aot.prewarm(bk, store)
    assert len(report.stale) == 1 and report.loaded == [] and bk.builds == {}


def test_aggregate_key_captured_and_prewarmed_epoch_key_not_captured(tmp_path, stub):
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    bk.attach_aot_store(store)
    sets = _sets(3)
    assert bk.aggregate_verify([s.signing_keys[0] for s in sets], [b"a", b"b", b"c"],
                               sets[0].signature) is True
    # the epoch program is not in AOT_KERNELS: no capture hook, as in the reference
    assert bk.epoch_program(8, 4).on_build is None
    (meta,) = store.entries().values()
    assert meta["kernel"] == "_aggregate_verify_kernel"
    assert meta["cache_key"] == ["agg", 4, False, False, False]
    fresh = TB.TorchBackend(device="cpu", min_batch=8)
    report = aot.prewarm(fresh, store)
    assert len(report.loaded) == 1 and list(fresh.builds) == [("agg", 4, False, False, False)]
    name, args = stub[-1]
    assert name == "_aggregate_verify_kernel" and args[-1].dtype == torch.bool


# ---------------------------------------------------------------------------
# Prewarm beside serving: every dispatch answers
# ---------------------------------------------------------------------------


def test_prewarm_concurrent_with_dispatch_answers_every_batch(tmp_path, stub):
    """One backend serves through its built key on the main thread while a
    prewarm builds three more keys into it on another: every dispatch
    answers, and the report is whole.  (On the CPU: on the card a capture
    must not overlap other work of the process, so prewarm runs before
    traffic there.)"""
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(16, 32, 64))
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    mb = _batch(bk, 8)
    assert bk.verify_marshalled(mb) is True
    reports = []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=lambda: reports.append(aot.prewarm(bk, store)))
        t.start()
        served = 0
        while t.is_alive() or served < 32:
            assert bk.verify_marshalled(mb) is True
            served += 1
            if served >= 4096:  # liveness backstop, never expected
                break
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not t.is_alive()
    (report,) = reports
    assert len(report.loaded) == 3 and not report.rejected and not report.stale
    assert sorted(k[0] for k in bk.builds) == [8, 16, 32, 64]


# ---------------------------------------------------------------------------
# Cross-checks against the reference
# ---------------------------------------------------------------------------


def test_manifest_is_the_references(tmp_path, stub):
    """The same constants and signature algorithm: the reference's store
    verifies the port's manifest and plan as its own."""
    assert (aot.MANIFEST_SCHEMA, aot.MANIFEST_DOMAIN, aot.AOT_KERNELS) == (
        JA.MANIFEST_SCHEMA, JA.MANIFEST_DOMAIN, JA.AOT_KERNELS)
    store = aot.AotStore(str(tmp_path / "aot_cache"))
    _stage(store, sizes=(8, 16))
    store.write_plan({"schema": 1, "shapes": {"8": {"arm": "mxu13"}}})
    with open(store.manifest_path, encoding="utf-8") as f:
        doc = json.load(f)
    assert set(doc) == {"schema", "entries", "signature", "plan", "plan_signature"}
    for table, sig in ((doc["entries"], doc["signature"]), (doc["plan"], doc["plan_signature"])):
        assert aot.manifest_signature(table) == JA.manifest_signature(table) == sig
    ref = JA.AotStore(store.root)
    assert ref.entries() == store.entries() and ref.plan() == store.plan() == doc["plan"]


@pytest.mark.parametrize("program", ["verify_h2c", "verify", "aggregate"])
def test_skeleton_rebuilds_the_marshalled_operands(program):
    """A stored skeleton rebuilds the operands with the structure, shapes,
    dtypes and bounds that marshal_sets (or marshal_aggregate) gives."""
    bk = TB.TorchBackend(device="cpu", min_batch=8, device_h2c=program == "verify_h2c")
    sets = _sets(3)
    if program == "aggregate":
        _, args = bk.marshal_aggregate([s.signing_keys[0] for s in sets], [b"a", b"b", b"c"],
                                       sets[0].signature)
    else:
        args = bk.marshal_sets(sets).args
    rebuilt = aot.operands(aot.parse_skeleton(aot.skeleton(args)), "cpu")

    def shape_of(tree):
        if isinstance(tree, F.LFp):
            return ("LFp", tuple(tree.limbs.shape), tree.limbs.dtype, tree.bound)
        if isinstance(tree, torch.Tensor):
            return ("tensor", tuple(tree.shape), tree.dtype)
        return tuple(shape_of(c) for c in tree)

    assert shape_of(rebuilt) == shape_of(args)
    assert _zero_operands(rebuilt)
    assert aot.skeleton(rebuilt) == aot.skeleton(args)


def test_record_boot_row_takes_an_explicit_path(tmp_path):
    assert inspect.signature(aot.record_boot_row).parameters["path"].default is \
        inspect.Parameter.empty
    path = tmp_path / "boot.jsonl"
    aot.record_boot_row({"loaded": 2, "seconds": 1.5}, str(path))
    aot.record_boot_row({"loaded": 0}, str(tmp_path / "no_dir" / "boot.jsonl"))  # never raises
    (row,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert row["kind"] == "boot" and row["device_kind"] == "cpu" and row["loaded"] == 2
