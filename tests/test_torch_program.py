"""The compiled-program layer of TorchBackend (torch_backend/program.py and
backend.py's _program, warm_compile, dispatch, local_verify_fn and
verify_marshalled) against jax_backend/backend.py's _kernel, warm_compile,
program_fingerprint, local_verify_fn and verify_marshalled.

On the CPU the program is the eager one, so these tests stub it where a real
verify is not the point; the captured graph is tested on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls.jax_backend import backend as JB  # noqa: E402
from lighthouse_tpu.crypto.bls.jax_backend import fp as JF  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import program as PG  # noqa: E402


@pytest.fixture
def gates(monkeypatch):
    """The port's three arm gates, off, and restored after the test."""
    monkeypatch.setattr(F, "_CHAINS_MODE", False)
    monkeypatch.setattr(F, "_WSM_MODE", False)
    monkeypatch.setattr(F, "_MXU_MODE", False)
    monkeypatch.setattr(F, "_MXU_PLAN", None)


@pytest.fixture
def stub(monkeypatch, gates):
    """Both device programs replaced by a recorder of their operands and of
    the arm in force while they run; the verdict is True."""
    calls = []
    for name in ("_verify_kernel_h2c", "_verify_kernel"):
        def program(*args):
            calls.append({"args": args, "arm": (F.chains_active(), F.wsm_fused_active(),
                                                F.mxu_active())})
            return torch.ones((1,), dtype=torch.bool)

        program.__name__ = name
        monkeypatch.setattr(TB, name, program)
    return calls


@pytest.mark.parametrize("B", [0, 4, 12, 24])
def test_warm_compile_refuses_what_the_reference_refuses(stub, B):
    """Below min_batch or not a power of two: False before any build."""
    assert JB.JaxBackend(min_batch=8).warm_compile(B) is False
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    assert bk.warm_compile(B) is False
    assert bk.builds == {} and stub == []


@pytest.mark.parametrize("B", [8, 16])
def test_warm_compile_builds_the_key_from_the_tiled_probe(stub, B):
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    assert bk.warm_compile(B) is True
    assert list(bk.builds) == [(B, True, False, False, False)]
    (call,) = stub
    pk_x, wbits = call["args"][0][0].limbs, call["args"][-1]
    assert pk_x.shape == (F.N, B) and wbits.shape == (64, B)
    assert torch.equal(pk_x, pk_x[:, :1].expand(F.N, B))  # one probe set, tiled
    assert torch.equal(wbits[:-1].sum(0), torch.zeros(B, dtype=wbits.dtype))  # weight 1
    assert call["arm"] == (False, False, False)
    assert bk.warm_compile(B) is True and len(bk.builds) == 1  # the key is reused


def _flip(gate):
    {"chains": F.set_chains, "wsm": F.set_wsm, "mxu": F.set_mxu}[gate](True)


@pytest.mark.parametrize("gate", ["chains", "wsm", "mxu"])
def test_each_arm_gate_gives_a_new_key_and_fingerprint(stub, gate):
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    first = bk._program(8)
    assert bk._program(8) is first and len(bk.builds) == 1
    _flip(gate)
    second = bk._program(8)
    assert second is not first and len(bk.builds) == 2
    (k0, r0), (k1, r1) = bk.builds.items()
    assert k0[:2] == k1[:2] == (8, True) and k0 != k1
    assert r0["fingerprint"] != r1["fingerprint"]
    # the program runs under its key's arm, whatever the gates say later
    F.set_chains(False), F.set_wsm(False), F.set_mxu(False)
    second(*bk.marshal_sets(_signed_sets(1), weights=[3]).args)
    assert stub[-1]["arm"] == (gate == "chains", gate == "wsm", gate == "mxu")
    assert (F.chains_active(), F.wsm_fused_active(), F.mxu_active()) == (False,) * 3


def test_the_reference_key_misses_chains_and_wsm(monkeypatch, gates):
    """A finding about the reference, pinned so that the port does not
    repeat it: JaxBackend._kernel keys its executables on (B, device_h2c,
    mxu) only, while fp.chains_active() and fp.wsm_fused_active() are read
    when the program is traced, so flipping set_chains or set_wsm after a
    key is built reuses the other arm's executable.  The port's key holds
    both (test above)."""
    monkeypatch.setattr(JF, "_CHAINS_MODE", False)
    monkeypatch.setattr(JF, "_WSM_MODE", False)
    monkeypatch.setattr(JB, "traced_jit", lambda fn, fp_hex, **kw: object())
    jb = JB.JaxBackend(min_batch=8, device_h2c=False)
    first = jb._kernel(8)
    JF.set_chains(True)
    JF.set_wsm(True)
    assert jb._kernel(8) is first and list(jb._kernels) == [(8, False, False)]


def test_program_fingerprint_is_stable_and_tells_keys_apart():
    base = dict(B=8, device_h2c=True, mxu=False, chains=False, wsm=False)
    fp = PG.program_fingerprint("_verify_kernel_h2c", "cpu", **base)
    assert len(fp) == 12 and int(fp, 16) >= 0
    assert fp == PG.program_fingerprint("_verify_kernel_h2c", "cpu", **base)
    others = [PG.program_fingerprint("_verify_kernel_h2c", "cpu", **{**base, k: v})
              for k, v in (("B", 16), ("device_h2c", False), ("mxu", True), ("chains", True),
                           ("wsm", True))]
    assert len({fp, *others}) == 6


def _signed_sets(n):
    sks = [tapi.SecretKey(1000 + i) for i in range(n)]
    msg = b"\x42" * 32
    return [tapi.SignatureSet(sk.sign(msg), [sk.public_key()], msg) for sk in sks]


@pytest.mark.parametrize("device_h2c", [False, True])
def test_local_verify_fn_and_verify_marshalled_as_in_the_reference(stub, device_h2c):
    jb = JB.JaxBackend(min_batch=8, device_h2c=device_h2c)
    bk = TB.TorchBackend(device="cpu", min_batch=8, device_h2c=device_h2c)
    assert bk.local_verify_fn().__name__ == jb.local_verify_fn().__name__
    assert bk.local_verify_fn() is (TB._verify_kernel_h2c if device_h2c else TB._verify_kernel)
    # an invalid batch is False on the host, in both, without a program
    assert jb.verify_marshalled(jb.marshal_sets([])) is False
    assert bk.verify_marshalled(bk.marshal_sets([])) is False
    assert bk.builds == {} and stub == []
    # a valid batch goes through the key's program
    assert bk.verify_marshalled(bk.marshal_sets(_signed_sets(2))) is True
    assert len(stub) == 1 and list(bk.builds) == [(8, device_h2c, False, False, False)]


def test_upload_refuses_a_copy_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        F.upload(torch.zeros((F.N, 1), dtype=F.DTYPE), "cuda")
    assert torch.equal(F.upload(torch.ones(3), "cpu"), torch.ones(3))


def test_static_inputs_take_only_the_captured_operands():
    static = (F.LFp(torch.zeros((F.N, 8), dtype=F.DTYPE), 1.0), torch.zeros((64, 8)))
    for bad in ((F.LFp(torch.zeros((F.N, 8), dtype=F.DTYPE), 2.0), torch.zeros((64, 8))),
                (F.LFp(torch.zeros((F.N, 16), dtype=F.DTYPE), 1.0), torch.zeros((64, 8))),
                (F.LFp(torch.zeros((F.N, 8), dtype=F.DTYPE), 1.0),),
                (F.LFp(torch.zeros((F.N, 8), dtype=F.DTYPE), 1.0),
                 torch.zeros((64, 8), dtype=F.DTYPE))):
        with pytest.raises(ValueError, match="program"):
            PG._copy_into(static, bad)


_NEW_KEYS = {"agg": lambda bk: bk._agg_program(4), "epoch": lambda bk: bk.epoch_program(4, 8)}


@pytest.mark.parametrize("program", sorted(_NEW_KEYS))
@pytest.mark.parametrize("gate", ["chains", "wsm", "mxu"])
def test_new_programs_key_on_the_arm_gates(gates, program, gate):
    """The aggregate and epoch keys hold the three gates after their name and
    static sizes, and each key gets its own fingerprint; the verify key
    stays (B, device_h2c, mxu, chains, wsm).  Making a key runs nothing."""
    bk = TB.TorchBackend(device="cpu", min_batch=4)
    make = _NEW_KEYS[program]
    first = make(bk)
    assert make(bk) is first
    bk._program(4)
    _flip(gate)
    assert make(bk) is not first
    arms = [(False, False, False), (gate == "mxu", gate == "chains", gate == "wsm")]
    sizes = (4,) if program == "agg" else (4, 8)
    assert list(bk.builds) == [(program, *sizes, *arms[0]), (4, True, False, False, False),
                               (program, *sizes, *arms[1])]
    fps = [rec["fingerprint"] for rec in bk.builds.values()]
    assert len(set(fps)) == 3


def test_the_program_names_tell_the_keys_apart(gates):
    bk = TB.TorchBackend(device="cpu", min_batch=4)
    bk._agg_program(4), bk.epoch_program(4, 4), bk.epoch_program(4, 8), bk._program(4)
    bk._agg_program(8)
    assert len({rec["fingerprint"] for rec in bk.builds.values()}) == 5
    with pytest.raises(ValueError, match="power of two"):
        bk.epoch_program(4, 12)


def test_registry_seams_as_in_the_reference():
    limbs = torch.arange(F.N * 3, dtype=F.DTYPE).reshape(F.N, 3)
    x, y = TB.TorchBackend.registry_pk_wrap(limbs, limbs + 1)
    jx, jy = JB.JaxBackend.registry_pk_wrap(limbs.numpy(), limbs.numpy() + 1)
    assert (x.bound, y.bound) == (float(jx.bound), float(jy.bound)) == (1.0, 1.0)
    assert x.limbs is limbs and torch.equal(y.limbs, limbs + 1)
    assert TB.MarshalledBatch(0, 0, True).slots is None
    assert JB.MarshalledBatch(0, 0, True).slots is None


class _FakeEvent:
    def record(self, stream=None):
        pass


class _FakeStream:
    def __init__(self, log, pool):
        self.log, self.pool = log, pool

    def wait_event(self, event):
        self.log.append(("wait_event", self.pool.lock.locked()))


def _fake_captured(monkeypatch, log):
    """A CapturedProgram on the CPU with the card's calls faked: its graph
    replay computes static_out = 3 * static_in + 1, reading the static input
    and writing the output at two moments, as a replay on the card does."""
    import threading
    import time
    import types

    pool = types.SimpleNamespace(device=torch.device("cpu"), last_replay=None,
                                 lock=threading.Lock())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream(log, pool))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: log.append(("synchronize", pool.lock.locked())))
    prog = PG.CapturedProgram(None, ("k",), (False, False, False), pool, {}, lambda: {})
    prog.static_in = (torch.zeros(4, dtype=torch.int64),)
    prog.static_out = torch.zeros(4, dtype=torch.int64)

    class Graph:
        def replay(self):
            log.append(("replay", pool.lock.locked()))
            seen = prog.static_in[0].clone()
            time.sleep(0.0005)
            prog.static_out.copy_(3 * seen + 1)

    prog.graph = Graph()
    real_copy = PG._copy_into

    def copy_into(static, host):
        log.append(("copy_into", pool.lock.locked()))
        real_copy(static, host)

    monkeypatch.setattr(PG, "_copy_into", copy_into)
    return prog, pool


def test_replays_enqueue_under_the_pool_lock_and_sync_nothing(monkeypatch):
    """A dispatch waits on the last replay, copies its operands in, replays
    and copies the output out all under its pool's lock, and makes no host
    sync; the output never aliases the static output."""
    log = []
    prog, pool = _fake_captured(monkeypatch, log)
    out = prog._run((torch.arange(4),))
    assert torch.equal(out, 3 * torch.arange(4) + 1) and out is not prog.static_out
    out2 = prog._run((torch.ones(4, dtype=torch.int64),))
    assert torch.equal(out, 3 * torch.arange(4) + 1) and torch.equal(out2, torch.full((4,), 4))
    assert [e for e, _ in log] == ["copy_into", "replay", "wait_event", "copy_into", "replay"]
    assert all(held for _, held in log)
    assert not pool.lock.locked() and pool.last_replay is not None


def test_concurrent_dispatches_through_one_key_keep_their_operands(monkeypatch):
    """Threads dispatching through the same key, more threads than cores
    and a short switch interval: each gets the output of its own operands
    (without the lock, one thread's copy lands between another's copy and
    replay)."""
    import os
    import sys
    import threading

    log = []
    prog, _ = _fake_captured(monkeypatch, log)
    n_threads = max(4, 2 * (os.cpu_count() or 1))
    results, errors = {t: [] for t in range(n_threads)}, []

    def run(tid):
        try:
            for i in range(30):
                v = torch.full((4,), 1000 * tid + i, dtype=torch.int64)
                results[tid].append((v, prog._run((v,))))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for pairs in results.values():
        assert len(pairs) == 30
        assert all(torch.equal(out, 3 * v + 1) for v, out in pairs)


def test_a_build_holds_the_pool_lock(monkeypatch):
    """_build orders itself against replays through the same lock."""
    log = []
    prog, pool = _fake_captured(monkeypatch, log)
    monkeypatch.setattr(PG.CapturedProgram, "_build_locked",
                        lambda self, host: log.append(("build", pool.lock.locked())))
    prog._build((torch.zeros(4, dtype=torch.int64),))
    assert log == [("build", True)] and not pool.lock.locked()


def test_for_device_gives_one_backend_per_device():
    """for_device: the backend itself on its own device, else one sibling
    per device with its min_batch and device_h2c; seat_program is the
    sibling's keyed program for the seat's batch."""
    bk = TB.TorchBackend(device="cpu", min_batch=4, device_h2c=False)
    assert bk.for_device("cpu") is bk and bk.for_device(torch.device("cpu")) is bk
    assert bk.seat_program("cpu", 8) is bk._program(8)
    sib = bk.for_device("meta")
    assert sib is not bk and bk.for_device("meta") is sib
    assert (sib.min_batch, sib.device_h2c, sib.device) == (4, False, torch.device("meta"))
    assert sib._programs == {} and sib.seat_program("meta", 8) is sib._program(8)
    assert bk.seat_program("meta", 8) is sib._program(8)


def test_a_bare_cuda_backend_keeps_the_card_current_when_made(monkeypatch):
    """TorchBackend("cuda") holds the card current at its making, with its
    index: a seat on cuda:1, whose seat_context makes cuda:1 current, gets
    the cuda:1 sibling from for_device, never the cuda:0 backend."""
    current = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    bk = TB.TorchBackend()
    assert bk.device == torch.device("cuda", 0)
    current[0] = 1
    sib = bk.for_device(torch.device("cuda", 1))
    assert sib is not bk and sib.device == torch.device("cuda", 1)
    assert bk.for_device("cuda") is sib and bk.for_device("cuda:0") is bk


def test_a_seat_runs_the_arm_of_its_own_batch(monkeypatch):
    """The seat program's key is resolved for the seat's batch B / width
    (fp.mxu_for_batch of that B).  The reference's sharded program traces
    its unpinned local_verify_fn under the global gate instead: with a plan
    that puts 4 lanes on mxu13 and 8 on vpu15 (no default), an 8-set batch
    on two seats runs the mxu key at B = 4 per seat here, and the 15-bit
    plane in the reference.  Both compute the same function."""
    bk = TB.TorchBackend(device="cpu", min_batch=4)
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    plan = {4: True, 8: False}
    monkeypatch.setattr(F, "_MXU_MODE", None)
    monkeypatch.setattr(F, "_MXU_PLAN", plan)
    assert bk.seat_program("cpu", 4).key == (4, True, True, False, False)
    assert bk._program(8).key == (8, True, False, False, False)
    # the reference's sharded program reads the global gate, off under it
    monkeypatch.setattr(JF, "_MXU_MODE", None)
    monkeypatch.setattr(JF, "_MXU_PLAN", plan)
    assert JF.mxu_enabled() is False and JF.mxu_for_batch(4) is True
