"""Shared corpus and comparisons of the port's ingest tests
(tests/test_torch_ingest*.py).

Key identity is ``id()``, so every key is made twice, once per package, from
the same secret integer, and no object crosses between the packages.  A
corpus is a seeded spec, (key indices, message) per set, built in either
package by ``make_sets``.
"""

import numpy as np
import torch

from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.crypto.bls.jax_backend.backend import JaxBackend
from lighthouse_tpu.ingest import IngestEngine as JaxIngestEngine
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.crypto.bls.torch_backend.backend import TorchBackend
from lighthouse_tpu_torch.ingest import IngestEngine

# Marshal never checks a signature, so one signed point serves every set.
N_KEYS = 24
SECRETS = [1000 + i for i in range(N_KEYS)]


class Keys:
    """One package's keys and shared signature, made from SECRETS."""

    def __init__(self, api):
        self.api = api
        self.pks = [api.SecretKey(s).public_key() for s in SECRETS]
        self.sig = api.SecretKey(SECRETS[0]).sign(b"ingest-shared")


PORT, REF = Keys(tapi), Keys(japi)


def port_backend(device_h2c=True):
    return TorchBackend(device="cpu", min_batch=8, device_h2c=device_h2c)


def rand_spec(rng, n: int, multi: bool = False) -> list:
    """Seeded corpus spec: (key indices, message) per set."""
    spec = []
    for i in range(n):
        if multi and i % 3 == 0:
            keys = [int(j) for j in rng.integers(0, N_KEYS, int(rng.integers(2, 7)))]
        else:
            keys = [int(rng.integers(0, N_KEYS))]
        spec.append((keys, rng.integers(0, 256, int(rng.integers(0, 97)),
                                        dtype=np.uint8).tobytes()))
    return spec


def make_sets(keys: Keys, spec) -> list:
    return [keys.api.SignatureSet(keys.sig, [keys.pks[i] for i in idx], msg)
            for idx, msg in spec]


def draw_weights(rng, n: int) -> list[int]:
    return [int(x) for x in rng.integers(1, 2**63, n)]


def port_leaves(args) -> list:
    """(int32 numpy array, bound) per leaf of a port operand tree."""
    if isinstance(args, F.LFp):
        return [(args.limbs.cpu().numpy(), args.bound)]
    if isinstance(args, torch.Tensor):
        return [(args.cpu().numpy(), None)]
    return [leaf for a in args for leaf in port_leaves(a)]


def jax_leaves(args) -> list:
    if hasattr(args, "limbs"):
        return [(np.asarray(args.limbs), float(args.bound))]
    if isinstance(args, tuple):
        return [leaf for a in args for leaf in jax_leaves(a)]
    return [(np.asarray(args), None)]


def assert_mb_equal(a, b, tag=""):
    """Two port batches, byte for byte (dtype, shape, bytes and bound)."""
    assert (a.n, a.B, a.invalid, a.device_h2c) == (b.n, b.B, b.invalid, b.device_h2c), tag
    if a.invalid:
        return
    fa, fb = port_leaves(a.args), port_leaves(b.args)
    assert len(fa) == len(fb), tag
    for j, ((x, bx), (y, by)) in enumerate(zip(fa, fb)):
        assert x.dtype == y.dtype and x.shape == y.shape and bx == by, (tag, j)
        assert x.tobytes() == y.tobytes(), (tag, j)


def assert_mb_matches_jax(p, r, tag=""):
    """A port batch against a JAX batch, leaf for leaf (values and bounds)."""
    assert (p.n, p.B, p.invalid, p.device_h2c) == (r.n, r.B, r.invalid, r.device_h2c), tag
    if p.invalid:
        return
    fp_, fr = port_leaves(p.args), jax_leaves(r.args)
    assert len(fp_) == len(fr), tag
    for j, ((x, bx), (y, by)) in enumerate(zip(fp_, fr)):
        assert x.shape == y.shape and bx == by, (tag, j)
        assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), (tag, j)


class FakeRegistry:
    """ValidatorPubkeyCache stand-in: index -> PublicKey."""

    def __init__(self, keys):
        self._keys = list(keys)

    def __len__(self):
        return len(self._keys)

    def get(self, i):
        return self._keys[i]

    def append(self, pk):
        self._keys.append(pk)


def engines(device_h2c=True, registry=None, **kw):
    """(port scalar backend, port engine, JAX backend, JAX engine), the
    registries (slices of each package's keys) given as index ranges."""
    pb, jb = port_backend(device_h2c), JaxBackend(min_batch=8, device_h2c=device_h2c)
    preg = jreg = None
    if registry is not None:
        preg = FakeRegistry(PORT.pks[i] for i in registry)
        jreg = FakeRegistry(REF.pks[i] for i in registry)
    jkw = {k: v for k, v in kw.items() if k != "device_gather"}
    return (pb, IngestEngine(pb, pubkey_cache=preg, **kw),
            jb, JaxIngestEngine(jb, pubkey_cache=jreg, device_gather=False, **jkw))
