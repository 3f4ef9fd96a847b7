"""Source identity of the node layers the port copies from the JAX package.

Every pure-Python module of the scenario engine's import closure that the
port did not already have is copied into ``lighthouse_tpu_torch`` (ROADMAP,
"Copies"): only its imports are rewritten.  The copies import relatively, so
most are byte-identical; the rewrite below turns an absolute
``lighthouse_tpu`` import (or a module name handed to ``__import__``) into the
port's.  Every other difference is a device seam, listed here by file and
line (``difflib`` opcodes: tag, reference lines [i1, i2), port lines [j1,
j2), 0-based), and the names a copy needs from the port's own shared modules
(``utils/``, ``obs/tracer.py``) are held against the reference's.  Nothing
here runs a copy: it costs no time on the clock.
"""

import ast
import difflib
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "lighthouse_tpu")
PORT = os.path.join(ROOT, "lighthouse_tpu_torch")

COPIED = (
    "beacon/blobs.py",
    "beacon/builder.py",
    "beacon/chain.py",
    "beacon/checkpoint_sync.py",
    "beacon/eth1.py",
    "beacon/events.py",
    "beacon/execution.py",
    "beacon/harness.py",
    "beacon/naive_pool.py",
    "beacon/op_pool.py",
    "beacon/simulator.py",
    "beacon/sync.py",
    "beacon/sync_committee.py",
    "beacon/validator_monitor.py",
    "consensus/committees.py",
    "consensus/containers.py",
    "consensus/fork_choice/__init__.py",
    "consensus/fork_choice/fork_choice.py",
    "consensus/fork_choice/proto_array.py",
    "consensus/light_client.py",
    "consensus/merkle.py",
    "consensus/shuffle.py",
    "consensus/spec.py",
    "consensus/ssz.py",
    "consensus/state_processing/arrays.py",
    "consensus/state_processing/block_signature_verifier.py",
    "consensus/state_processing/forks.py",
    "consensus/state_processing/per_block.py",
    "consensus/state_processing/per_epoch.py",
    "consensus/state_processing/per_epoch_phase0.py",
    "consensus/state_processing/per_slot.py",
    "consensus/state_processing/signature_sets.py",
    "consensus/state_processing/upgrades.py",
    "consensus/testing.py",
    "crypto/kzg/__init__.py",
    "crypto/kzg/fr.py",
    "crypto/kzg/kzg.py",
    "native/__init__.py",
    "native/slabdb.cpp",
    "network/__init__.py",
    "network/api.py",
    "network/gossip.py",
    "network/peer_manager.py",
    "network/rpc.py",
    "network/snappy.py",
    "network/topics.py",
    "obs/http.py",
    "obs/report.py",
    "ops/__init__.py",
    "ops/sha256.py",
    "slasher/__init__.py",
    "slasher/slasher.py",
    "slasher/store.py",
    "store/__init__.py",
    "store/hot_cold.py",
    "store/kv.py",
    "store/wal.py",
    "utils/executor.py",
    "utils/monitoring.py",
    "utils/slot_clock.py",
    "validator/__init__.py",
    "validator/client.py",
    "validator/slashing_protection.py",
)

# file -> the difflib opcodes of its deliberate differences, each named
SEAMS = {
    # the device branch of process_epoch_altair runs per_epoch_torch's
    # pipeline on the card (the reference imports per_epoch_jax at :98-99);
    # the route is one function, device_pipeline(), so that a test can point
    # it at the CPU
    "consensus/state_processing/per_epoch.py": [
        ("insert", 72, 72, 72, 80),     # def device_pipeline(): per_epoch_torch
        ("replace", 76, 80, 84, 88),    # the docstring names the card's pipeline
        ("replace", 98, 99, 106, 107),  # epoch_balance_pipeline = device_pipeline()
    ],
    # libslabdb.so is built into the git-ignored native/_build/ (the
    # reference builds it beside its source), through a temporary file
    # renamed into place
    "native/__init__.py": [
        ("replace", 5, 6, 5, 6),    # the docstring names _build/
        ("insert", 16, 16, 16, 17),  # _BUILD
        ("replace", 30, 31, 31, 32),  # so = <_BUILD>/lib<name>.so
        ("insert", 32, 32, 33, 35),  # make _BUILD; the temporary output
        ("replace", 34, 35, 37, 38),  # g++ -o <tmp>
        ("insert", 41, 41, 44, 45),  # rename the temporary into place
    ],
    # docstrings that named a path outside the repo, a change number, or the
    # reference's copy of slabdb.cpp
    "consensus/ssz.py": [
        ("replace", 3, 4, 3, 4),    # "the reference's consensus/types"
    ],
    "store/kv.py": [
        ("replace", 5, 6, 5, 6),    # lighthouse_tpu_torch/native/slabdb.cpp
        ("replace", 7, 8, 7, 8),    # "Crash-safety surface:"
    ],
    "validator/slashing_protection.py": [
        ("replace", 9, 10, 9, 10),  # "Crash-safety:"
    ],
}

# the scenario engine's closure that is not copied: the port has its own
# module of that name (the device layers and the shared modules the copies
# import), or the module waits for a later item
PORT_OWN = (
    "__init__.py", "beacon/__init__.py", "beacon/processor.py", "consensus/__init__.py",
    "consensus/state_processing/__init__.py", "crypto/__init__.py", "obs/__init__.py",
    "obs/tracer.py", "utils/__init__.py", "utils/faults.py", "utils/logging.py",
    "utils/metrics.py",
)
NOT_YET = ("scenario/", "analysis/", "crypto/bls/", "ingest/", "integrity/", "parallel/",
           "serve/", "consensus/state_processing/per_epoch_jax.py")


def rewrite_imports(text: str) -> str:
    """The reference's text with its imports of the JAX package pointed at
    the port: absolute ``from``/``import`` statements and module names
    given to ``__import__``."""
    text = re.sub(r"(?m)^(\s*(?:from|import)\s+)lighthouse_tpu\b", r"\1lighthouse_tpu_torch", text)
    return text.replace('"lighthouse_tpu.', '"lighthouse_tpu_torch.')


def _read(root, rel):
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return f.read()


def _opcodes(rel):
    ref = rewrite_imports(_read(REF, rel)).splitlines()
    port = _read(PORT, rel).splitlines()
    return [op for op in difflib.SequenceMatcher(None, ref, port, autojunk=False).get_opcodes()
            if op[0] != "equal"]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_its_reference_up_to_imports_and_named_seams(rel):
    assert _opcodes(rel) == SEAMS.get(rel, [])


def test_the_seams_route_to_the_card():
    port = _read(PORT, "consensus/state_processing/per_epoch.py").splitlines()
    assert port[106].strip() == "epoch_balance_pipeline = device_pipeline()"
    assert "from .per_epoch_torch import epoch_balance_pipeline" in "\n".join(port[72:80])
    assert "per_epoch_jax" not in _read(PORT, "consensus/state_processing/per_epoch.py").replace(
        "(per_epoch_jax)", "")
    native = _read(PORT, "native/__init__.py")
    assert '_BUILD = os.path.join(_DIR, "_build")' in native
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        assert "lighthouse_tpu_torch/native/_build/" in f.read().split()


def test_every_bls_call_site_of_the_copies_goes_through_the_ports_api():
    """A copy verifies only through ``crypto/bls/api.py`` (relative imports
    resolve to the port's, whose active engine is ``TorchBackend`` after
    ``set_backend("torch")``); besides it, a copy reads only the host
    oracle's curve arithmetic and pairing check (KZG), and imports no
    backend module."""
    seen = set()
    for rel in COPIED:
        if not rel.endswith(".py"):
            continue
        tree = ast.parse(_read(PORT, rel))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and "bls" in node.module:
                assert node.level > 0 and "backend" not in node.module, (rel, node.module)
                module = node.module.split(".")[-1]
                if module == "bls":
                    assert all(a.name == "api" for a in node.names), (rel, node.module)
                    module = "api"
                assert module in ("api", "curve", "fields", "params", "pairing"), (rel, node.module)
                if module == "api":
                    seen.add(rel)
    assert {"beacon/chain.py", "beacon/harness.py", "beacon/naive_pool.py", "beacon/sync.py",
            "beacon/sync_committee.py", "beacon/blobs.py", "beacon/builder.py",
            "consensus/testing.py", "consensus/light_client.py",
            "consensus/state_processing/block_signature_verifier.py",
            "consensus/state_processing/signature_sets.py",
            "consensus/state_processing/per_epoch.py", "network/api.py",
            "validator/client.py"} <= seen


def _closure():
    """The reference's modules reachable from scenario/*.py by imports,
    lazy ones included (relative paths under the package)."""
    def path_of(mod):
        p = os.path.join(ROOT, *mod.split("."))
        if os.path.isdir(p):
            return os.path.join(p, "__init__.py")
        return p + ".py" if os.path.exists(p + ".py") else None

    start = ["lighthouse_tpu.scenario." + f[:-3] for f in os.listdir(os.path.join(REF, "scenario"))
             if f.endswith(".py") and f != "__init__.py"]
    seen, stack = set(), list(start)
    while stack:
        mod = stack.pop()
        f = path_of(mod)
        if f is None or mod in seen:
            continue
        seen.add(mod)
        parts = mod.split(".")
        stack += [".".join(parts[:i]) for i in range(1, len(parts))]
        for node in ast.walk(ast.parse(open(f, encoding="utf-8").read())):
            if isinstance(node, ast.Import):
                stack += [a.name for a in node.names if a.name.startswith("lighthouse_tpu")]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = parts if f.endswith("__init__.py") else parts[:-1]
                    base = base[:len(base) - (node.level - 1)]
                    target = ".".join(base + ([node.module] if node.module else []))
                else:
                    target = node.module or ""
                if target.startswith("lighthouse_tpu"):
                    stack.append(target)
                    stack += [f"{target}.{a.name}" for a in node.names]
    return {os.path.relpath(path_of(m), REF) for m in seen}


def test_the_copies_cover_the_scenario_engines_closure():
    closure = _closure()
    assert "beacon/chain.py" in closure and "scenario/engine.py" in closure
    wanted = sorted(r for r in closure
                    if not r.startswith(NOT_YET) and r not in PORT_OWN)
    copied_py = sorted(r for r in COPIED if r.endswith(".py"))
    assert wanted == copied_py
    for rel in PORT_OWN:
        assert os.path.exists(os.path.join(PORT, rel)), rel


# -- the names the copies take from the port's shared modules ----------------


def _copy_trees():
    for rel in COPIED:
        if rel.endswith(".py"):
            yield rel, ast.parse(_read(PORT, rel))


def _metric_names_used():
    names = set()
    for _, tree in _copy_trees():
        aliases = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.endswith("utils"):
                aliases |= {a.asname or a.name for a in node.names if a.name == "metrics"}
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.endswith("utils.metrics"):
                names |= {a.name for a in node.names}
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                    and node.value.id in aliases:
                names.add(node.attr)
    return sorted(names)


def test_every_metric_a_copy_writes_is_the_references():
    from lighthouse_tpu.utils import metrics as JM
    from lighthouse_tpu_torch.utils import metrics as TM

    used = _metric_names_used()
    assert "BLOCK_IMPORT_LATENCY" in used and "SYNC_BATCHES_INVALID" in used
    for name in used:
        jm, tm = getattr(JM, name), getattr(TM, name)
        if callable(jm) and not hasattr(jm, "kind"):
            assert inspect.getsource(tm) == inspect.getsource(jm), name
            continue
        assert (tm.name, tm.kind, tuple(tm.label_names)) == \
            (jm.name, jm.kind, tuple(jm.label_names)), name
        assert getattr(tm, "buckets", None) == getattr(jm, "buckets", None), name


def test_every_span_and_fault_site_of_the_copies_is_registered():
    from lighthouse_tpu_torch.obs.tracer import SPANS

    spans, sites = set(), set()
    for _, tree in _copy_trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.args and isinstance(node.args[0], ast.Constant):
                if node.func.attr in ("span", "instant"):
                    spans.add(node.args[0].value)
                elif node.func.attr in ("fire", "maybe_fire", "check"):
                    sites.add(node.args[0].value)
    assert spans == {"block.import", "sync.batch"}
    assert spans <= set(SPANS)
    assert sites == {"store.open", "store.put", "store.flush", "sync.request", "gossip.route"}
    from lighthouse_tpu_torch.utils import faults

    for site in sites | {"executor.task."}:
        assert site in faults.__doc__, site


def test_the_fault_kinds_and_errors_the_copies_raise_are_the_references():
    from lighthouse_tpu.utils import faults as JF
    from lighthouse_tpu_torch.utils import faults as TF

    assert set(TF._KINDS) == set(JF._KINDS)
    assert issubclass(TF.StorageFault, OSError) and issubclass(TF.StorageFault, TF.FaultError)
    for spec, payload in (("s=io-errorx1", None), ("s=torn-write:0.25x1", None),
                          ("s=dropx1", None), ("s=corrupt-chunkx1", [b"abcd", b"wxyz"]),
                          ("s=wrong-blocksx1", [1, 2, 3]), ("s=extra-blocksx1", [1, 2]),
                          ("s=corruptx1", 7)):
        outs = []
        for mod in (JF, TF):
            inj = mod.FaultInjector()
            inj.arm_from_spec(spec)
            try:
                outs.append(("ok", inj.fire("s", payload)))
            except mod.FaultError as exc:
                outs.append((type(exc).__name__, getattr(exc, "fraction", None)))
            assert not inj.armed("s")
        assert outs[0] == outs[1], spec
    inj = TF.FaultInjector()
    inj.arm("s", "io-error")
    assert inj.maybe_fire("s", 3) == 3 and inj.injected == 1


def test_the_names_a_copy_imports_from_utils_exist():
    import lighthouse_tpu.utils as JU
    import lighthouse_tpu_torch.utils as TU

    wanted = set()
    for _, tree in _copy_trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level and node.module == "utils":
                wanted |= {a.name for a in node.names}
    assert {"Counter", "ManualSlotClock", "get_logger", "log_with", "render"} <= wanted
    for name in wanted:
        assert hasattr(TU, name), name
        assert hasattr(JU, name), name
