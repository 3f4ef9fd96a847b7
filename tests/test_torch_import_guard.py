"""The port stands alone: in a fresh interpreter that refuses to import jax
and the JAX package, every module of lighthouse_tpu_torch and chip_smoke.py
still import."""

import os
import subprocess
import sys

_GUARD = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "lighthouse_tpu"):
            raise ImportError(f"the port must not import {name}")
        return None

assert not any(m.split(".")[0] in ("jax", "lighthouse_tpu") for m in sys.modules)
sys.meta_path.insert(0, Refuse())
import lighthouse_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lighthouse_tpu_torch.__path__,
                                               "lighthouse_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for kernel in ("mont_kernel", "miller_kernel", "chain_kernel", "wsm_kernel", "mxu_kernel"):
    assert f"lighthouse_tpu_torch.crypto.bls.torch_backend.{kernel}" in names, kernel
for module in ("ingest.sha", "ingest.pool", "ingest.cache", "ingest.engine",
               "consensus.state_processing.arrays", "consensus.state_processing.per_epoch_torch",
               "utils.metrics", "obs.tracer", "crypto.bls.torch_backend.aot",
               "crypto.bls.torch_backend.autotune", "parallel.mesh", "parallel.partition",
               "parallel.pod", "crypto.bls.torch_backend.multichip", "crypto.bls.pairing",
               "utils.logging", "beacon.processor", "integrity.corpus", "integrity.trust",
               "integrity.audit", "integrity.guard", "integrity.selfcheck", "serve.admission",
               "serve.batcher", "serve.service", "serve.stack", "serve.http", "serve.__main__"):
    assert f"lighthouse_tpu_torch.{module}" in names, module
# the node layers (the JAX package's copies) and the device boot
for module in ("cli", "beacon.blobs", "beacon.builder", "beacon.chain", "beacon.checkpoint_sync",
               "beacon.eth1", "beacon.events", "beacon.execution", "beacon.harness",
               "beacon.naive_pool", "beacon.op_pool", "beacon.simulator", "beacon.sync",
               "beacon.sync_committee", "beacon.validator_monitor", "consensus.committees",
               "consensus.containers", "consensus.fork_choice",
               "consensus.fork_choice.fork_choice", "consensus.fork_choice.proto_array",
               "consensus.light_client", "consensus.merkle", "consensus.shuffle",
               "consensus.spec", "consensus.ssz",
               "consensus.state_processing.block_signature_verifier",
               "consensus.state_processing.forks", "consensus.state_processing.per_block",
               "consensus.state_processing.per_epoch",
               "consensus.state_processing.per_epoch_phase0",
               "consensus.state_processing.per_slot", "consensus.state_processing.signature_sets",
               "consensus.state_processing.upgrades", "consensus.testing", "crypto.kzg",
               "crypto.kzg.fr", "crypto.kzg.kzg", "native", "network", "network.api",
               "network.gossip", "network.peer_manager", "network.rpc", "network.snappy",
               "network.topics", "obs.http", "obs.report", "ops", "ops.sha256", "slasher",
               "slasher.slasher", "slasher.store", "store", "store.hot_cold", "store.kv",
               "store.wal", "utils.executor", "utils.monitoring", "utils.slot_clock", "validator",
               "validator.client", "validator.slashing_protection"):
    assert f"lighthouse_tpu_torch.{module}" in names, module
from lighthouse_tpu_torch.utils import device_kind
assert isinstance(device_kind(), str) and device_kind() != "host"
# the tuner's legality gate reads the JAX package's waivers as a data file
from lighthouse_tpu_torch.crypto.bls.torch_backend import autotune
assert autotune.proven_arms(), "the gate read no proof"
assert not any(m.split(".")[0] in ("jax", "jaxlib", "lighthouse_tpu") for m in sys.modules)
import chip_smoke
assert callable(chip_smoke.main)
print(len(names), "modules")
"""


def test_port_imports_without_jax_or_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert int(proc.stdout.split()[0]) >= 118


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the script exits non-zero and prints no result line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import torch, sys; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['chip_smoke.py']; import chip_smoke; sys.exit(chip_smoke.main())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
