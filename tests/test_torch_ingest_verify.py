"""One verdict through the port's whole ingest path, on the CPU.

An all-registry batch of eight single-signer sets goes through the port's
``IngestEngine`` with the device gather (here on the CPU: the registry's
mirror and its ``index_select`` are CPU tensors), then ``TorchBackend.dispatch``
and ``resolve`` on the default arm, through the plain versions of the
kernels.  The verdict equals the JAX package's pure-Python oracle.  The
gather runs in the marshal: once the batch is marshalled, the cache is
made to refuse every gather, and dispatch does not notice.  (One verify
through the plain versions takes about 16 s on one core.)
"""

import pytest
import torch

# the plain versions run many small ops: one intra-op thread per process
torch.set_num_threads(1)

pytest.importorskip("jax")

from torch_ingest_corpus import FakeRegistry  # noqa: E402

from lighthouse_tpu.crypto.bls import api as japi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls import api as tapi  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F  # noqa: E402
from lighthouse_tpu_torch.crypto.bls.torch_backend.backend import TorchBackend  # noqa: E402
from lighthouse_tpu_torch.ingest import IngestEngine  # noqa: E402
from lighthouse_tpu_torch.utils import metrics as M  # noqa: E402

SECRETS = [7000 + 13 * i for i in range(12)]  # the registry: 12 validators
SIGNERS = [11, 3, 0, 7, 5, 9, 2, 10]  # the slots that sign, scattered


def _sets(api):
    keys = [api.SecretKey(s).public_key() for s in SECRETS]
    sets = [api.SignatureSet(api.SecretKey(SECRETS[i]).sign(b"slot %d" % i), [keys[i]],
                             b"slot %d" % i) for i in SIGNERS]
    return keys, sets


def test_registry_batch_verdict_through_the_engine_matches_the_oracle():
    want = japi.cpu_backend().verify_signature_sets(_sets(japi)[1])
    assert want is True
    backend = TorchBackend(device="cpu", min_batch=8, device_h2c=False)
    keys, sets = _sets(tapi)
    eng = IngestEngine(backend, pubkey_cache=FakeRegistry(keys), device_gather=True)
    f0 = M.INGEST_FALLBACKS.value()
    mb = eng.marshal_sets(sets)
    assert M.INGEST_FALLBACKS.value() == f0 and not mb.invalid and mb.B == 8
    assert mb.slots is None and mb.ready is None  # a CPU gather needs no event
    pk_x = mb.args[0][0].limbs
    mirror_x, _ = eng.cache.registry_device()
    assert torch.equal(pk_x, mirror_x[:, SIGNERS])  # the gathered operand

    def refuse(*_):
        raise AssertionError("a registry gather after the marshal")

    eng.cache.gather_device = eng.cache.registry_device = refuse
    with F.pinned_arm(False, False, False):  # the default arm
        assert backend._arm(8) == (False, False, False)
        assert backend.resolve(backend.dispatch(mb)) is want
