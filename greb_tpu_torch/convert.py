"""Carry values across from the JAX package.

``params_from_numpy``, ``forcing_from_numpy`` and ``mxu_from_numpy`` take
the leaves of ``greb_tpu``'s ``PhysicsParams`` / ``ClimForcing`` /
``MxuConst`` / ``MxuMembers`` as numpy arrays (the caller does the
``np.asarray`` on the JAX side) and return this package's objects, so both
packages compute the same thing.  Nothing here imports
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import PhysicsParams
from .forcing import ClimForcing, forcing_from_arrays
from .ops import fastcirc2 as fc2

F32 = np.float32


def params_from_numpy(leaves: Dict[str, np.ndarray]) -> PhysicsParams:
    """{field: array} of a JAX-side PhysicsParams -> PhysicsParams."""
    names = [f.name for f in dataclasses.fields(PhysicsParams)]
    missing = set(names) - set(leaves)
    if missing:
        raise KeyError(f"params_from_numpy: missing {sorted(missing)}")
    return PhysicsParams(**{
        n: np.asarray(leaves[n], F32) if n == "p_emi" else F32(leaves[n])
        for n in names})


def forcing_from_numpy(leaves: Dict[str, np.ndarray], device) -> ClimForcing:
    """{field: array} of a JAX-side ClimForcing -> ClimForcing on device."""
    missing = set(ClimForcing.__dataclass_fields__) - set(leaves)
    if missing:
        raise KeyError(f"forcing_from_numpy: missing {sorted(missing)}")
    return forcing_from_arrays(leaves, device)


def mxu_from_numpy(leaves: Dict[str, np.ndarray], precision: str,
                   mode: str = None, device="cpu"):
    """{"zd_mat", "shift1h": array} of a JAX-side matmul circulation's
    constants -> fastcirc2.MxuMembers at ``precision`` ("bf16_3x",
    "highest"), or with ``mode`` ("stacked") fastcirc2.MxuConst
    (``precision`` "high", "highest"), on ``device``."""
    missing = {"zd_mat", "shift1h"} - set(leaves)
    if missing:
        raise KeyError(f"mxu_from_numpy: missing {sorted(missing)}")
    t = {k: torch.as_tensor(np.array(leaves[k], F32), device=device)
         for k in ("zd_mat", "shift1h")}
    if mode is None:
        if precision not in fc2.MEMBER_PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of "
                             f"{fc2.MEMBER_PRECISIONS}")
        return fc2.MxuMembers(precision=precision, **t)
    if precision not in fc2.MXU_PRECISIONS or mode not in fc2.MXU_MODES:
        raise ValueError(f"precision {precision!r} / mode {mode!r}: one of "
                         f"{fc2.MXU_PRECISIONS} / {fc2.MXU_MODES}")
    return fc2.MxuConst(precision=precision, mode=mode, **t)
