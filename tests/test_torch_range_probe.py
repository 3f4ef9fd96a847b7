"""Range probes for the port's two square cores: the counterparts of the
reference's interpret-mode range traces (analysis/range_lint.py
``_build_pallas_mont_sqr`` and ``_build_mxu_mont_sqr``).

The port's plain triangle square (``mont_kernel.mont_sqr_plain``, the twin of
``pallas_fp._mont_sqr_core``) and its 13-bit product of a value with itself
(``mxu_kernel.mont_mul_mxu_plain(a, a)``, the twin of ``mont_core_mxu(a,
a)``) run on the random-quasi and all-QMAX corpora of tests/test_range_probe.py
with ``fp.range_probe`` open, which records every intermediate's maximum.
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
