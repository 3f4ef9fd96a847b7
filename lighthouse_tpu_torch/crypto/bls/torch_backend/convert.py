"""Carry operands and constant tables across from the JAX package.

The port's counterpart of loading a model's weights: the JAX package's
marshalled operands (``MarshalledBatch.args``) become the port's LFp trees,
and the port's re-derived constant tables are laid side by side with the
JAX package's.  Nothing here imports jax or the JAX package: callers pass
the objects in (duck-typed: anything with ``.limbs`` and ``.bound`` is a
field element, ``np.asarray`` reads its limbs).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp as F


def operands_from_jax(args, device):
    """A JAX operand tree (nested tuples of LFp-like leaves and plain
    arrays) -> the port's tree on ``device``: LFp with int32 limbs and the
    same bound, plain arrays as int32 tensors."""
    if hasattr(args, "limbs") and hasattr(args, "bound"):
        limbs = np.asarray(args.limbs).astype(np.int32)
        return F.LFp(torch.as_tensor(limbs).to(device), float(args.bound))
    if isinstance(args, tuple):
        return tuple(operands_from_jax(a, device) for a in args)
    return torch.as_tensor(np.asarray(args).astype(np.int32)).to(device)


def registry_from_jax(x_cols, y_cols) -> tuple:
    """The JAX cache's registry columns (numpy uint32 (26, n) planes, as
    ``PubkeyLimbCache.registry_columns`` returns them) -> the port's int32
    planes (``fp.DTYPE``), value for value: canonical limbs are below 2^15."""
    out = []
    for cols in (x_cols, y_cols):
        arr = np.asarray(cols)
        if arr.ndim != 2 or arr.shape[0] != F.N:
            raise ValueError(f"registry columns must be ({F.N}, n), not {arr.shape}")
        if arr.size and int(arr.max()) > F.MASK:
            raise ValueError("registry columns hold a limb above 15 bits")
        out.append(np.ascontiguousarray(arr.astype(np.int32)))
    return tuple(out)


def operands_to_numpy(args):
    """The port's operand tree -> nested tuples of (int64 limbs, bound)
    leaves and int64 arrays, for comparison with the JAX package's."""
    if isinstance(args, F.LFp):
        return (args.limbs.cpu().numpy().astype(np.int64), args.bound)
    if isinstance(args, tuple):
        return tuple(operands_to_numpy(a) for a in args)
    return args.cpu().numpy().astype(np.int64)


def _fp2_limbs(v) -> np.ndarray:
    """An oracle Fp2 constant -> (2, 26) Montgomery limbs."""
    return np.stack([F.int_to_limbs(c * F.R_INT % F.P_INT) for c in (v.c0, v.c1)])


def _lfp_tree_limbs(tree) -> np.ndarray:
    if hasattr(tree, "limbs"):
        return np.asarray(tree.limbs.cpu() if isinstance(tree.limbs, torch.Tensor)
                          else tree.limbs).astype(np.int64).reshape(F.N, -1)
    return np.concatenate([_lfp_tree_limbs(c) for c in tree], axis=-1)


def _tables(fp, fields, endo, h2c, neg_gen, bias) -> dict:
    out = {
        "P": fp.int_to_limbs(fp.P_INT),
        "PPRIME": fp.int_to_limbs(fp.PPRIME_INT),
        "R1": fp.int_to_limbs(fp.R1_INT),
        "R2": fp.int_to_limbs(fp.R2_INT),
        "PSI_CX": _fp2_limbs(endo.PSI_CX),
        "PSI_CY": _fp2_limbs(endo.PSI_CY),
        "NEG_GEN": _lfp_tree_limbs(neg_gen),
        "H2C_C1": _fp2_limbs(h2c._C1),
        "H2C_C2": _fp2_limbs(h2c._C2),
        "H2C_C3": _fp2_limbs(h2c._C3),
        "H2C_NEG_B_OVER_A": _fp2_limbs(h2c._NEG_B_OVER_A),
        "H2C_B_OVER_ZA": _fp2_limbs(h2c._B_OVER_ZA),
        "H2C_SQRT_EXP": np.array([int(b) for b in bin(h2c.SQRT_EXP)[2:]]),
    }
    for k, v in bias.items():
        out[f"BIAS_{k}"] = v
    for i in range(1, 6):
        out[f"FROB_GAMMA_{i}"] = _fp2_limbs(fields.FROB_GAMMA[i])
    for name in ("_ISO_X_NUM", "_ISO_X_DEN", "_ISO_Y_NUM", "_ISO_Y_DEN"):
        out["H2C" + name] = np.stack([_fp2_limbs(c) for c in getattr(h2c, name)])
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


def port_constants() -> dict:
    """Every constant table the port re-derives, by name, as int64 arrays."""
    from .. import endo, fields
    from . import backend, h2c

    return _tables(F, fields, endo, h2c, backend._neg_gen_const("cpu"), F.BIAS_NP)


def constants_from_jax(fp, fields, endo, h2c, backend) -> dict:
    """The same tables read from the JAX package's modules (passed in:
    ``jax_backend.fp``, ``fields``, ``endo``, ``jax_backend.h2c``,
    ``jax_backend.backend``), for comparison with ``port_constants()``."""
    return _tables(fp, fields, endo, h2c, backend._neg_gen_const(), fp._BIAS_NP)
