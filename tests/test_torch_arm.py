"""The chain-and-WSM arm of batch verification, end to end on the CPU.

TorchBackend(device="cpu").verify_signature_sets at B=8 with the map to G2
on the device, under the arm (chains and fused scalar muls on): the
verdicts on a valid and a one-invalid corpus equal the JAX package's
pure-Python oracle's (tests/test_torch_backend.py holds the default arm to
the oracle on the same kinds of corpora), and the path goes through the
arm's wrappers as often as it will launch their kernels on a card: 12 Fp
chains, 4 Fp2 chains and 64 WSM steps per curve.  Also the gates' default
and environment names.
"""

import random

import pytest
import torch

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import chain_kernel as CK  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import wsm_kernel as W  # noqa: E402


def _sets(api, corpus: str):
    """Five signed sets (one of three signers on one message) from a seeded
    spec; in "one_invalid" the third is signed under another key."""
    rng = random.Random(f"arm-{corpus}")
    spec = []
    for _ in range(4):
        sk = rng.randrange(2, 10**12)
        spec.append(([sk], rng.randbytes(32), sk))
    multi = [rng.randrange(2, 10**12) for _ in range(3)]
    spec.append((multi, b"\x22" * 32, sum(multi)))
    if corpus == "one_invalid":
        sks, msg, signer = spec[2]
        spec[2] = (sks, msg, signer + 1)
    return [api.SignatureSet(api.SecretKey(signer).sign(msg),
                             [api.SecretKey(k).public_key() for k in sks], msg)
            for sks, msg, signer in spec]


@pytest.fixture
def arm_on():
    F.set_chains(True)
    F.set_wsm(True)
    yield
    F.set_chains(False)
    F.set_wsm(False)


@pytest.mark.parametrize("corpus", ["valid", "one_invalid"])
def test_arm_verdicts_match_oracle(arm_on, monkeypatch, corpus):
    want = japi.cpu_backend().verify_signature_sets(_sets(japi, corpus))
    assert want is (corpus == "valid")
    calls = {}

    def spy(module, attr, key):
        orig = getattr(module, attr)

        def wrapped(*args):
            calls[key] = calls.get(key, 0) + 1
            return orig(*args)

        monkeypatch.setattr(module, attr, wrapped)

    spy(CK, "pow_chain", "fp_chain")
    spy(CK, "fp2_pow_chain", "fp2_chain")
    spy(W, "wsm_step_g1", "wsm_step_g1")
    spy(W, "wsm_step_g2", "wsm_step_g2")
    backend = TB.TorchBackend(device="cpu", min_batch=8)
    assert backend.device_h2c
    assert backend.verify_signature_sets(_sets(tapi, corpus)) is want
    assert calls == {"fp_chain": 12, "fp2_chain": 4, "wsm_step_g1": 64, "wsm_step_g2": 64}


def test_gates_default_off_and_read_the_reference_env_names(monkeypatch):
    for mode, env, enabled, active in (
            ("_CHAINS_MODE", "LIGHTHOUSE_TPU_CHAINS", F.chains_enabled, F.chains_active),
            ("_WSM_MODE", "LIGHTHOUSE_TPU_WSM", F.wsm_enabled, F.wsm_fused_active)):
        monkeypatch.setattr(F, mode, None)
        monkeypatch.delenv(env, raising=False)
        assert enabled() is False and active() is False
        monkeypatch.setattr(F, mode, None)
        monkeypatch.setenv(env, "1")
        assert enabled() is True and active() is True
    monkeypatch.setattr(F, "_CHAINS_MODE", None)
    monkeypatch.setattr(F, "_WSM_MODE", None)
    F.set_chains(False)
    F.set_wsm(False)
    assert not (F.chains_active() or F.wsm_fused_active())
