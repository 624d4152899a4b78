"""Perturbed-physics ensembles (``greb_tpu.parallel.ensemble``).

The reference runs an ensemble as separate processes, one per member
(``ens_id``, src/greb.f90:153, 1064-1068).  Here members are a list of
``PhysicsParams`` that the member-batched year kernels
(``ops/cuda/multiyear.py``) pack into one (M, 1, 42) table.  Forcing, grid
and the folded circulation stay shared, so a member may not perturb the
transport operator (``TRANSPORT_PARAM_KEYS``).

The JAX module's names map onto the port so:

- ``stack_params`` -> ``ops/cuda/multiyear.pack_member_params``: the
  members' params as one (M, 1, N_PPACK) table with their heat capacities;
- ``make_ensemble_runners`` and ``make_batched_ensemble_runners`` -> the
  member kernels' wrappers ``multiyear.fluxcorr_years`` (a spin-up year)
  and ``multiyear.scenario_years`` (a block of scenario years), which take
  the members as an array axis (state (5, M, Y, X)) on the card and on the
  CPU alike;
- ``batched_model_data`` and ``ensemble_data`` -> the member pack: each
  member's derived constants that differ from the base's are its heat
  capacities, which the pack carries, so neither needs a counterpart;
- ``ensemble_initial_state`` -> ``ensemble_initial_state`` below.

``GREB.run_members`` chains them, and the CLI's ``--ensemble`` runs
through it (``__main__.run_ensemble``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import PhysicsParams
from ..forcing import ClimForcing, build_derived, initial_state

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


def ensemble_initial_state(members: Sequence[PhysicsParams],
                           forcing: ClimForcing) -> torch.Tensor:
    """Each member's initial state from its own params, as the member
    kernels' (5, M, Y, X) state (fields in ``ModelState.FIELDS`` order) on
    the forcing's device."""
    return torch.stack([
        initial_state(p, forcing, build_derived(p, forcing)).stack()
        for p in members], dim=1)
