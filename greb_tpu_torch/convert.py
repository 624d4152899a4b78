"""Carry values across from the JAX package.

``params_from_numpy`` and ``forcing_from_numpy`` take the leaves of
``greb_tpu``'s ``PhysicsParams`` / ``ClimForcing`` as numpy arrays (the
caller does the ``np.asarray`` on the JAX side) and return this package's
objects, so both packages compute the same thing.  Nothing here imports
JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .config import PhysicsParams
from .forcing import ClimForcing, forcing_from_arrays

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
