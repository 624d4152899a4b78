"""Perturbed-physics members (``greb_tpu.parallel.ensemble``, the pieces
the member pack needs).

The reference runs an ensemble as separate processes, one per member
(``ens_id``, src/greb.f90:153, 1064-1068).  Here members are a list of
``PhysicsParams`` that the member-batched year kernels
(``ops/cuda/multiyear.py``) pack into one (M, 1, 42) table.  Forcing, grid
and the folded circulation stay shared, so a member may not perturb the
transport operator (``TRANSPORT_PARAM_KEYS``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..config import PhysicsParams

F32 = np.float32

# Params whose perturbation changes the circulation operator itself: the
# shared fold is built from the base params (kappa scales the stencils;
# z_air/z_vapor set the wz topography weights baked into the coefficients;
# pi sets the grid metrics).
TRANSPORT_PARAM_KEYS = frozenset({"kappa", "z_air", "z_vapor", "pi"})


def fastcirc_shareable(perturb_keys) -> bool:
    """True if one folded circulation can serve all members perturbed over
    ``perturb_keys``."""
    return not (set(perturb_keys) & TRANSPORT_PARAM_KEYS)


def perturbed_params(base: PhysicsParams, perturb: Dict[str, Sequence[float]]
                     ) -> List[PhysicsParams]:
    """One ``PhysicsParams`` per member: ``base`` with member i's value for
    each key of ``perturb`` (each an (n_members,) sequence)."""
    n = len(next(iter(perturb.values())))
    return [base.replace(**{k: F32(v[i]) for k, v in perturb.items()})
            for i in range(n)]
