"""Shared set-up of the node-layer twins (tests/test_torch_{block_signatures,
epoch_device,sync,sync_committee,simulator,node_differential}.py): the port's
BLS registry has no active engine until ``set_backend`` names one, where the
JAX package's starts on its python oracle; the twins run the copies over the
port's oracle, as the reference tests run theirs."""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def port_oracle(monkeypatch):
    """The port's python oracle active for one test, the registry restored
    after."""
    from lighthouse_tpu_torch.crypto.bls import api as tapi

    monkeypatch.setattr(tapi, "_ACTIVE", [])
    tapi.set_backend("python")
    return tapi


def test_port_oracle_is_the_active_engine_and_verifies(port_oracle):
    """Under the fixture the copies' calls through the port's ``api`` reach
    the python oracle: a signed set verifies, a wrong message does not."""
    assert port_oracle.get_backend() is port_oracle.cpu_backend()
    sk = port_oracle.SecretKey(7)
    msg = b"\x42" * 32
    sig = sk.sign(msg)
    assert port_oracle.verify(sk.public_key(), msg, sig)
    assert not port_oracle.verify(sk.public_key(), b"\x43" * 32, sig)
