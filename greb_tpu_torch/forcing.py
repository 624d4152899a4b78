"""Forcing climatologies, derived constants and model state, as dataclasses
of float32 tensors (``greb_tpu.forcing``; reference src/greb.f90:108-216).

- ``ClimForcing``: the raw (nstep_yr, y, x) climatologies.
- ``Derived``: topography weights, z_ocean, Toclim and the heat capacities
  (numpy float32 scalars, as in the JAX package).
- ``ModelState``: the prognostic state carried from step to step.
- ``Corrections``: the flux-correction tables learned in the spin-up.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .config import Experiment, Numerics, PhysicsParams

F32 = np.float32


@dataclass
class ClimForcing:
    z_topo: torch.Tensor     # (y,x)
    glacier: torch.Tensor    # (y,x)
    tclim: torch.Tensor      # (t,y,x)
    uclim: torch.Tensor
    vclim: torch.Tensor
    qclim: torch.Tensor
    mldclim: torch.Tensor
    swetclim: torch.Tensor
    cldclim: torch.Tensor
    sw_solar: torch.Tensor   # (t,y)

    @property
    def nstep_yr(self) -> int:
        return self.tclim.shape[0]


@dataclass
class Derived:
    """Derived program constants (reference src/greb.f90:176-216, 1088-1094)."""
    wz_air: torch.Tensor     # exp(-z_topo/z_air)
    wz_vapor: torch.Tensor   # exp(-z_topo/z_vapor)
    z_ocean: torch.Tensor    # 3 * annual max of mld
    toclim: torch.Tensor     # deep-ocean climatology (time-constant field)
    cap_ocean: np.float32    # heat capacity of 1 m ocean [J/K/m^2]
    cap_land: np.float32
    cap_air: np.float32


@dataclass
class ModelState:
    """Prognostic state (src/greb.f90:268,472-492)."""
    ts: torch.Tensor
    ta: torch.Tensor
    to: torch.Tensor
    q: torch.Tensor
    cap_surf: torch.Tensor

    FIELDS = ("ts", "ta", "to", "q", "cap_surf")

    def stack(self) -> torch.Tensor:
        """(5, y, x) in FIELDS order — the year kernels' state layout."""
        return torch.stack([getattr(self, k) for k in self.FIELDS])

    @classmethod
    def unstack(cls, s5: torch.Tensor) -> "ModelState":
        return cls(*s5.unbind(0))

    def replace(self, **kw) -> "ModelState":
        return dataclasses.replace(self, **kw)


@dataclass
class Corrections:
    """Per-ityr flux-correction tables (src/greb.f90:344-355)."""
    tf: torch.Tensor   # (t,y,x)  [W/m^2]
    tof: torch.Tensor  # (t,y,x)  [K/step]
    qf: torch.Tensor   # (t,y,x)  [kg/kg/step]

    @classmethod
    def zeros(cls, nstep_yr: int, ydim: int, xdim: int,
              device=None) -> "Corrections":
        z = torch.zeros((nstep_yr, ydim, xdim), dtype=torch.float32,
                        device=device)
        return cls(tf=z, tof=z, qf=z)


def forcing_from_arrays(arrs: Dict[str, np.ndarray], device) -> ClimForcing:
    """Contiguous float32 tensors on ``device`` (the kernels take row-major
    fields; a regridded array's strides are not)."""
    return ClimForcing(**{
        k: torch.tensor(np.ascontiguousarray(arrs[k], F32), device=device)
        for k in ClimForcing.__dataclass_fields__ if k in arrs})


def load_forcing(input_dir: str, num: Numerics, device=None) -> ClimForcing:
    """Load a reference-format input directory (src/greb.f90:1018-1027,
    1073-1085) onto ``device`` (None means CUDA)."""
    from .io.binio import read_records
    from .io.synthetic import INPUT_FILES

    device = resolve_device(device)
    y, x, t = num.ydim, num.xdim, num.nstep_yr
    arrs: Dict[str, np.ndarray] = {}
    for key, fname in INPUT_FILES.items():
        path = os.path.join(input_dir, fname)
        if key in ("z_topo", "glacier"):
            arrs[key] = read_records(path, (y, x), records=[1])[0]
        elif key == "sw_solar":
            arrs[key] = read_records(path, (t, y), records=[1])[0]
        else:
            arrs[key] = read_records(path, (y, x), count=t)
    return forcing_from_arrays(arrs, device)


def synthetic_forcing(num: Numerics, device=None) -> ClimForcing:
    """The deterministic synthetic climatology on ``device`` (None means
    CUDA)."""
    from .io.synthetic import make_synthetic_forcing
    return forcing_from_arrays(
        make_synthetic_forcing(num.xdim, num.ydim, num.nstep_yr, num.ndays_yr),
        resolve_device(device))


def apply_experiment(forcing: ClimForcing, params: PhysicsParams,
                     exp: Experiment) -> ClimForcing:
    """Static field overrides of the legacy log_exp switchboard
    (src/greb.original.model.f90:162-166): flat topography, constant cloud
    and vapour climatologies, a mixed layer of d_ocean everywhere."""
    out = forcing
    if exp.flat_topo:
        z = out.z_topo
        out = dataclasses.replace(
            out, z_topo=torch.where(z > 1.0, torch.ones_like(z), z))
    if exp.const_cloud:
        out = dataclasses.replace(
            out, cldclim=torch.full_like(out.cldclim, F32(0.7)))
    if exp.const_vapor:
        out = dataclasses.replace(
            out, qclim=torch.full_like(out.qclim, F32(0.0052)))
    if exp.no_deep_ocean_mld:
        out = dataclasses.replace(
            out, mldclim=torch.full_like(out.mldclim, params.d_ocean))
    return out


def build_derived(params: PhysicsParams, forcing: ClimForcing) -> Derived:
    from .ops.pointwise import div
    z_topo = forcing.z_topo
    wz_air = torch.exp(div(-z_topo, params.z_air))
    wz_vapor = torch.exp(div(-z_topo, params.z_vapor))
    z_ocean = 3.0 * forcing.mldclim.amax(dim=0)
    # Toclim: annual min of Tclim, floored at -1.7 C (src/greb.f90:1088-1094)
    toclim = forcing.tclim.amin(dim=0)
    toclim = torch.where(toclim - 273.15 < -1.7,
                         torch.full_like(toclim, -1.7 + 273.15), toclim)
    cap_ocean = params.cp_ocean * params.rho_ocean
    cap_land = params.cp_land * params.rho_land * params.d_land
    cap_air = params.cp_air * params.rho_air * params.d_air
    return Derived(wz_air=wz_air, wz_vapor=wz_vapor, z_ocean=z_ocean,
                   toclim=toclim, cap_ocean=cap_ocean, cap_land=cap_land,
                   cap_air=cap_air)


def initial_state(params: PhysicsParams, forcing: ClimForcing,
                  derived: Derived) -> ModelState:
    """Initial prognostic state (src/greb.f90:190-197)."""
    ts = forcing.tclim[-1].clone()
    q = forcing.qclim[-1].clone()
    to = derived.toclim.clone()
    cap_surf = torch.where(forcing.z_topo > 0.0,
                           torch.full_like(ts, float(derived.cap_land)),
                           derived.cap_ocean * forcing.mldclim[0])
    return ModelState(ts=ts, ta=ts.clone(), to=to, q=q, cap_surf=cap_surf)
