"""Range probes for the port's two square cores: the counterparts of the
reference's interpret-mode range traces (analysis/range_lint.py
``_build_pallas_mont_sqr`` and ``_build_mxu_mont_sqr``), and for the two
products that the tuner's arms rest on (autotune.ARM_TABLE's proof programs
``pallas_mont_mul`` and ``mxu_mont_mul``): kernel 1's plain version
``mont_kernel.mont_mul_plain`` and kernel 7's ``mxu_kernel.mont_mul_mxu_plain``.

The port's plain triangle square (``mont_kernel.mont_sqr_plain``, the twin of
``pallas_fp._mont_sqr_core``) and its 13-bit product of a value with itself
(``mxu_kernel.mont_mul_mxu_plain(a, a)``, the twin of ``mont_core_mxu(a,
a)``) run on the random-quasi and all-QMAX corpora of tests/test_range_probe.py
(the products on two operands, drawn one after the other as
tests/test_range_probe.py draws them) with ``fp.range_probe`` open, which
records every intermediate's maximum.
The widest must stay within RANGE_REPORT.json's ``max_any_log2`` for the
same program (both rounded to two decimals, as the report is), and the
outputs within its ``out_caps``.  Reads the report file; imports nothing of
the JAX package.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

# The plain versions run many small ops: one intra-op thread per process, so
# test processes side by side (pytest-xdist) do not oversubscribe the cores.
torch.set_num_threads(1)

from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
from lighthouse_tpu_torch.crypto.bls.torch_backend import mont_kernel as MK
from lighthouse_tpu_torch.crypto.bls.torch_backend import mxu_kernel as X

REPORT = json.loads((Path(__file__).resolve().parents[1] / "RANGE_REPORT.json").read_text())
T = 128
SEED = 0xB15


def _corpora():
    """tests/test_range_probe.py's inputs: random quasi limbs in [0, QMAX]
    and every limb at QMAX, (26, 128)."""
    rng = np.random.default_rng(SEED)
    return {"random_quasi": rng.integers(0, F.QMAX + 1, size=(F.N, T), dtype=np.uint32),
            "all_qmax": np.full((F.N, T), F.QMAX, dtype=np.uint32)}


def _log2(v: int) -> float:
    return round(math.log2(v), 2) if v > 0 else 0.0


@pytest.mark.parametrize("program,square", [
    ("pallas_mont_sqr", MK.mont_sqr_plain),
    ("mxu_mont_sqr", lambda a: X.mont_mul_mxu_plain(a, a)),
])
def test_widest_intermediate_within_the_static_bound(program, square):
    rep = REPORT["programs"][program]
    for name, limbs in _corpora().items():
        a = torch.as_tensor(limbs.astype(np.int32))
        with F.range_probe() as widest:
            out = square(a)
        assert widest, "the probe recorded nothing"
        print(f"{program} {name}: widest intermediate 2^{math.log2(max(widest)):.4f}, "
              f"static bound 2^{rep['max_any_log2']}")
        assert _log2(max(widest)) <= rep["max_any_log2"], (name, max(widest))
        assert int(out.max()) <= rep["out_caps"][0], name
        assert int(out.min()) >= 0


def _pair_corpora():
    """The same two corpora with two operands each, as tests/test_range_probe.py
    feeds the products: two random quasi draws, and both at QMAX."""
    rng = np.random.default_rng(SEED)
    return {"random_quasi": tuple(rng.integers(0, F.QMAX + 1, size=(F.N, T), dtype=np.uint32)
                                  for _ in range(2)),
            "all_qmax": (np.full((F.N, T), F.QMAX, dtype=np.uint32),) * 2}


@pytest.mark.parametrize("program,product", [
    ("pallas_mont_mul", MK.mont_mul_plain),
    ("mxu_mont_mul", X.mont_mul_mxu_plain),
])
def test_product_widest_intermediate_within_the_static_bound(program, product):
    """The arms' proof programs: the port's arm legality rests on probes of
    the port's own kernels, not only on the reference's report."""
    rep = REPORT["programs"][program]
    assert rep["contracts_ok"] is True
    for name, (x, y) in _pair_corpora().items():
        a, b = (torch.as_tensor(v.astype(np.int32)) for v in (x, y))
        with F.range_probe() as widest:
            out = product(a, b)
        assert widest, "the probe recorded nothing"
        print(f"{program} {name}: widest intermediate 2^{math.log2(max(widest)):.4f}, "
              f"static bound 2^{rep['max_any_log2']}")
        assert _log2(max(widest)) <= rep["max_any_log2"], (name, max(widest))
        assert int(out.max()) <= rep["out_caps"][0], name
        assert int(out.min()) >= 0
