"""The port's device boot (``lighthouse_tpu_torch/cli.py`` ``device_boot``) and
the verify service booting through it (``python -m lighthouse_tpu_torch.serve
--datadir --tune --prewarm --selfcheck``): twins of the reference's ``bn``
selfcheck tests (tests/test_cli.py:90, :100) and of its boot order
(lighthouse_tpu/cli.py:264-345).

On the CPU the entry point's card check is faked and the active engine is
the python oracle, a backend stuck at True, or ``TorchBackend(device="cpu")``
with its device programs stubbed (as in tests/test_torch_aot.py).  The
service and its HTTP edge are replaced by recorders, so a test sees what was
made, and in which order, and no socket opens.  On the card the same boot
is chip_smoke.py's serve phase (g).
"""

import functools
import json
import os

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch import cli  # noqa: E402
from lighthouse_tpu_torch import serve as SV  # noqa: E402
from lighthouse_tpu_torch import integrity  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import _build  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import aot, autotune  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import program as PG  # noqa: E402
from lighthouse_tpu_torch.serve import __main__ as serve_main  # noqa: E402


@pytest.fixture
def boot(monkeypatch):
    """A clean registry and arm, the build root and plan restored after, the
    card check faked, and recorders in place of the service, its HTTP edge,
    the selfcheck and prewarm.  Returns the list of events, in order."""
    events = []
    monkeypatch.setattr(tapi, "_ACTIVE", [])
    monkeypatch.setattr(tapi, "_BACKENDS", dict(tapi._BACKENDS))
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("LIGHTHOUSE_TPU_MXU", raising=False)
    for name in ("_CHAINS_MODE", "_WSM_MODE", "_MXU_MODE", "_MXU_PLAN"):
        monkeypatch.setattr(F, name, None if name.startswith("_MXU") else False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    class Service:
        @classmethod
        def standalone(cls, **kw):
            events.append("service")
            return cls()

        def start(self, interval=None):
            return self

        def stop(self):
            events.append("service.stop")

    class Server:
        def __init__(self, service, port=0):
            events.append("server")
            self.port = 0

        def start(self):
            return self

        def stop(self):
            events.append("server.stop")

    monkeypatch.setattr(SV, "VerifyService", Service)
    monkeypatch.setattr(SV, "ServeApiServer", Server)
    real_selfcheck, real_prewarm = integrity.run_selfcheck, aot.prewarm

    def selfcheck(*a, **kw):
        events.append("selfcheck")
        return real_selfcheck(*a, **kw)

    def prewarm(*a, **kw):
        events.append("prewarm")
        return real_prewarm(*a, **kw)

    monkeypatch.setattr(integrity, "run_selfcheck", selfcheck)
    monkeypatch.setattr(aot, "prewarm", prewarm)
    return events


def _oracle_as_torch(monkeypatch):
    real = tapi.set_backend
    monkeypatch.setattr(tapi, "set_backend", lambda name: real("python"))


def _serve(*flags):
    return serve_main.main(["--port", "0", "--run-secs", "0", *flags])


def test_selfcheck_passes_and_the_service_boots(boot, monkeypatch):
    """An honest backend passes the known-answer sweep; then, and only then,
    the service and its listener are made."""
    _oracle_as_torch(monkeypatch)
    assert _serve("--selfcheck") == 0
    assert boot == ["selfcheck", "service", "server", "server.stop", "service.stop"]


def test_selfcheck_mismatch_refuses_boot_before_any_listener(boot, monkeypatch):
    """A backend that lies about the invalid canaries fails the boot with a
    non-zero exit, and no service or listener is ever made."""
    class StuckTrueBackend:
        name = "stuck-true-stub"

        def verify_signature_sets(self, sets):
            return True

    monkeypatch.setattr(tapi, "set_backend", lambda name: None)
    # the selfcheck resolves the active backend at call time; the canary
    # generator's oracle uses cpu_backend() and stays honest
    monkeypatch.setattr(tapi, "get_backend", lambda: StuckTrueBackend())
    logged = []
    monkeypatch.setattr(cli, "log_with", lambda log, level, msg, **f: logged.append(msg))
    assert _serve("--selfcheck") == 1
    assert boot == ["selfcheck"]
    assert "Selfcheck mismatch" in logged
    assert logged[-1] == "Integrity selfcheck FAILED; refusing to boot"


def test_prewarm_or_tune_without_datadir_skips_with_the_warning(boot, monkeypatch):
    _oracle_as_torch(monkeypatch)
    logged = []
    monkeypatch.setattr(cli, "log_with", lambda log, level, msg, **f: logged.append(msg))
    assert _serve("--prewarm", "--tune") == 0
    assert logged == ["--prewarm/--tune needs --datadir (the store lives under it); skipping"]
    assert boot == ["service", "server", "server.stop", "service.stop"]


def test_datadir_with_an_engine_without_the_seam_warns(boot, monkeypatch, tmp_path):
    _oracle_as_torch(monkeypatch)
    logged = []
    monkeypatch.setattr(cli, "log_with", lambda log, level, msg, **f: logged.append((msg, f)))
    assert _serve("--datadir", str(tmp_path), "--prewarm") == 0
    assert logged[0] == ("Kernel compile cache enabled",
                         {"path": str(tmp_path / cli.KERNEL_CACHE)})
    assert logged[1] == ("--prewarm/--tune: active BLS backend has no AOT seam",
                         {"backend": "python"})
    assert _build.BUILD_ROOT == (tmp_path / cli.KERNEL_CACHE).resolve()


@pytest.fixture
def stub_programs(monkeypatch):
    """The three device programs replaced by recorders whose verdict is True
    (tests/test_torch_aot.py's stub)."""
    calls = []
    for name in ("_verify_kernel_h2c", "_verify_kernel", "_aggregate_verify_kernel"):
        def program(*args, _name=name):
            calls.append(_name)
            return torch.ones((1,), dtype=torch.bool)

        program.__name__ = name
        monkeypatch.setattr(TB, name, program)
    return calls


def _torch_on_cpu():
    bk = TB.TorchBackend(device="cpu", min_batch=8)
    tapi._BACKENDS["torch"] = bk
    return bk


def _stage_store(datadir, sizes=(8,)):
    """A store under ``<datadir>/aot_cache`` holding the keys of ``sizes``,
    captured by an earlier process's first builds."""
    store = aot.AotStore(os.path.join(datadir, cli.AOT_CACHE))
    first = TB.TorchBackend(device="cpu", min_batch=8)
    first.attach_aot_store(store)
    sk = tapi.SecretKey(301)
    msg = b"boot twin"
    mb = first.marshal_sets([tapi.SignatureSet(sk.sign(msg), [sk.public_key()], msg)],
                            weights=[5])
    for B in sizes:
        args = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), B // mb.B),
                               mb.args)
        assert first.verify_marshalled(TB.MarshalledBatch(B, B, True, args)) is True
    assert len(store.entries()) == len(sizes)
    return store


def test_a_stored_key_is_built_before_the_listener(boot, monkeypatch, tmp_path,
                                                   stub_programs):
    """``--datadir --prewarm``: the store's 8-set key is built from its
    skeleton before the service exists, the boot row says so (no nvcc), and
    the service's first batch of that size builds nothing."""
    _stage_store(str(tmp_path))
    del stub_programs[:]
    bk = _torch_on_cpu()
    assert _serve("--datadir", str(tmp_path), "--prewarm") == 0
    assert boot == ["prewarm", "service", "server", "server.stop", "service.stop"]
    assert list(bk.builds) == [(8, True, False, False, False)]
    assert bk.builds[(8, True, False, False, False)]["aot"] is True
    assert stub_programs == ["_verify_kernel_h2c"]  # the build, from zeros
    assert bk._aot_store is not None and bk._aot_store.root == str(tmp_path / cli.AOT_CACHE)
    with open(tmp_path / cli.BOOT_HISTORY, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["kind"], r["phase"], r["loaded"], r["rejected"], r["nvcc_runs"]) for r in rows] \
        == [("boot", "prewarm", 1, 0, 0)]
    sk = tapi.SecretKey(302)
    s = tapi.SignatureSet(sk.sign(b"m"), [sk.public_key()], b"m")
    assert bk.verify_signature_sets([s]) is True and len(bk.builds) == 1


def test_tune_stores_and_installs_a_plan_before_prewarm(boot, monkeypatch, tmp_path,
                                                        stub_programs):
    """``--tune`` (one shape, its trials timed by an injected clock: the
    mxu13 arm the faster) writes the plan into the store's signed manifest
    and installs it; prewarm then installs it again from the store."""
    clock = {"vpu15": 0.002, "mxu13": 0.001}
    monkeypatch.setattr(autotune, "tune_and_store", functools.partial(
        autotune.tune_and_store, shapes=(8,), measure=lambda arm, batch: clock[arm.arm]))
    _torch_on_cpu()
    logged = []
    monkeypatch.setattr(cli, "log_with", lambda log, level, msg, **f: logged.append((msg, f)))
    assert _serve("--datadir", str(tmp_path), "--tune", "--prewarm") == 0
    plan = aot.AotStore(str(tmp_path / cli.AOT_CACHE)).plan()
    assert plan and {b: e["arm"] for b, e in plan["shapes"].items()} == {"8": "mxu13"}
    assert F._MXU_PLAN is not None
    msgs = [m for m, _ in logged]
    assert msgs[:3] == ["Kernel compile cache enabled", "Kernel autotune done",
                        "Prewarm boot phase done"]
    assert logged[2][1]["plan_shapes"] == 1 and logged[2][1]["nvcc_runs"] == 0
    assert boot == ["prewarm", "service", "server", "server.stop", "service.stop"]


def test_a_failed_tune_is_logged_and_the_boot_goes_on(boot, monkeypatch, tmp_path):
    def broken(store, **kw):
        raise RuntimeError("no trial ran")

    monkeypatch.setattr(autotune, "tune_and_store", broken)
    _torch_on_cpu()
    logged = []
    monkeypatch.setattr(cli, "log_with", lambda log, level, msg, **f: logged.append((msg, f)))
    assert _serve("--datadir", str(tmp_path), "--tune") == 0
    assert ("Kernel autotune failed", {"error": "no trial ran"}) in logged
    assert boot == ["service", "server", "server.stop", "service.stop"]


def test_without_a_card_the_entry_point_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _serve("--selfcheck")
