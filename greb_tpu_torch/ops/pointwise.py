"""Pointwise (per-gridpoint) physics (``greb_tpu.ops.pointwise``).

Pure float32 functions of state slices, forcing slices and params; each
names the reference subroutine it reproduces.  The float32 operation order
follows the JAX package, and the CUDA step body (csrc/year_kernel.cu)
repeats it.  The legacy ``log_exp`` overrides sit behind ``exp`` exactly as
in the JAX package (the default ``Experiment()`` is the modern variant).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Experiment, PhysicsParams
from ..forcing import Derived

F32 = np.float32

# the linearised vapour feedback's coefficient 0.022 / (0.15 * 24) (legacy
# log_exp 11, greb.original.model.f90:430), rounded once to float32 as the
# JAX package's weak-typed Python float is
LINEAR_VAPOR_LW_C = F32(0.022 / (0.15 * 24.0))


def div(a: torch.Tensor, s) -> torch.Tensor:
    """a / s for a scalar s, as true float32 division on every device.
    PyTorch's CUDA division by a host scalar multiplies by the reciprocal
    instead (one ulp off); the JAX package and the year kernels divide.  A
    tensor s (a parameter of each member, (M, 1, 1)) divides as it is."""
    if isinstance(s, torch.Tensor):
        return a / s
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


class SWResult(NamedTuple):
    sw: torch.Tensor
    albedo: torch.Tensor


def shortwave(ts, cld_t, sw_solar_t, z_topo, glacier,
              p: PhysicsParams, exp: Experiment = Experiment()) -> SWResult:
    """SW radiation with temperature-dependent ice/snow albedo.
    Reference: SWradiation, src/greb.f90:367-403.  ``sw_solar_t`` is the
    per-latitude insolation, (..., y) or (..., y, 1)."""
    a_atmos = cld_t * p.a_cloud
    land = z_topo >= 0.0

    def ramp(t1, t2):
        r = p.a_no_ice + p.da_ice * (1.0 - div(ts - t1, t2 - t1))
        return torch.where(ts <= t1, p.a_no_ice + p.da_ice,
                           torch.where(ts >= t2, p.a_no_ice, r))

    a_surf = torch.where(land, ramp(p.Tl_ice1, p.Tl_ice2),
                         ramp(p.To_ice1, p.To_ice2))
    a_surf = torch.where(glacier > 0.5, p.a_no_ice + p.da_ice, a_surf)
    if exp.fixed_albedo:  # legacy log_exp <= 5 (greb.original.model.f90:394)
        a_surf = torch.zeros_like(a_surf) + p.a_no_ice
    albedo = a_surf + a_atmos - a_surf * a_atmos
    col = (sw_solar_t if sw_solar_t.ndim and sw_solar_t.shape[-1] == 1
           else sw_solar_t[..., :, None])
    sw = col * (1.0 - albedo)
    return SWResult(sw=sw, albedo=albedo)


class LWResult(NamedTuple):
    lw_surf: torch.Tensor
    lwair_up: torch.Tensor
    lwair_down: torch.Tensor
    em: torch.Tensor


def _pow4(t):
    """t**4 as (t*t)*(t*t), the JAX package's integer_pow expansion."""
    t2 = t * t
    return t2 * t2


def longwave(ts, ta, q, co2, cld_t, tclim_t, qclim_t, wz_air,
             p: PhysicsParams, exp: Experiment = Experiment()) -> LWResult:
    """Empirical log-law greenhouse scheme.
    Reference: LWradiation, src/greb.f90:407-434; dTrad = -0.16*Tclim - 5
    (src/greb.f90:176) from the climatology slice."""
    pe = p.p_emi
    e_co2 = wz_air * co2
    e_vapor = wz_air * p.r_qviwv * q
    if exp.linear_vapor_lw:  # legacy log_exp == 11 (:423)
        e_vapor = wz_air * p.r_qviwv * qclim_t
    e_cloud = cld_t
    em = (pe[3] * torch.log(pe[0] * e_co2 + pe[1] * e_vapor + pe[2]) + pe[6]
          + pe[4] * torch.log(pe[0] * e_co2 + pe[2])
          + pe[5] * torch.log(pe[1] * e_vapor + pe[2]))
    em = div(pe[7] - e_cloud, pe[8]) * (em - pe[9]) + pe[9]
    if exp.linear_vapor_lw:  # legacy log_exp == 11 (:430)
        em = em + (LINEAR_VAPOR_LW_C * p.r_qviwv) * (q - qclim_t)

    dtrad_t = F32(-0.16) * tclim_t - 5.0
    lw_surf = -p.sig * _pow4(ts)
    lwair_down = -em * p.sig * _pow4(ta + dtrad_t)
    return LWResult(lw_surf=lw_surf, lwair_up=lwair_down,
                    lwair_down=lwair_down, em=em)


def sensible_heat(ts, ta, p: PhysicsParams) -> torch.Tensor:
    """Q_sens = ct_sens*(Ta - Ts).  Reference: src/greb.f90:295."""
    return p.ct_sens * (ta - ts)


class HydroResult(NamedTuple):
    q_lat: torch.Tensor
    q_lat_air: torch.Tensor
    dq_eva: torch.Tensor
    dq_rain: torch.Tensor


def hydrology(ts, q, u_t, v_t, swet_t, z_topo, wz_air,
              p: PhysicsParams, exp: Experiment = Experiment()) -> HydroResult:
    """Bulk hydrological cycle (evaporation / rain / latent heat).
    Reference: hydro, src/greb.f90:438-469."""
    if exp.hydro_off:  # legacy log_exp <= 6, 13, 15 (:453)
        zero = torch.zeros_like(ts)
        return HydroResult(zero, zero, zero, zero)
    abswind = torch.sqrt(u_t * u_t + v_t * v_t)
    abswind = torch.where(z_topo > 0.0, torch.sqrt(abswind * abswind + 4.0),
                          abswind)
    abswind = torch.where(z_topo < 0.0, torch.sqrt(abswind * abswind + 9.0),
                          abswind)
    # Magnus-type saturation humidity, topo-scaled (:457-458)
    tc = ts - 273.15
    qs = 3.75e-3 * torch.exp(17.08085 * tc / (tc + 234.175))
    qs = qs * wz_air
    q_lat = (q - qs) * abswind * p.cq_latent * p.rho_air * p.ce * swet_t
    dq_eva = div(div(-q_lat, p.cq_latent), p.r_qviwv)
    dq_rain = p.cq_rain * q
    q_lat_air = -dq_rain * p.cq_latent * p.r_qviwv
    return HydroResult(q_lat=q_lat, q_lat_air=q_lat_air,
                       dq_eva=dq_eva, dq_rain=dq_rain)


def seaice_capacity(ts, cap_surf_prev, mld_t, z_topo, glacier,
                    d: Derived, p: PhysicsParams,
                    exp: Experiment = Experiment()) -> torch.Tensor:
    """State-dependent surface heat capacity (sea-ice proxy).
    Reference: seaice, src/greb.f90:472-492.  Land points keep their
    previous value (the Fortran `where` never touches them)."""
    cap_open = d.cap_ocean * mld_t
    if exp.simple_seaice:  # legacy log_exp <= 5 (greb.original.model.f90:492-496)
        cap = torch.where(z_topo > 0.0, d.cap_land, cap_open)
        # z_topo == 0 keeps the previous value (the reference's where-pair)
        cap = torch.where(z_topo == 0.0, cap_surf_prev, cap)
    else:
        ramp = d.cap_land + div(cap_open - d.cap_land, p.To_ice2 - p.To_ice1) * (ts - p.To_ice1)
        cap_ocean_pts = torch.where(ts <= p.To_ice1, d.cap_land,
                                    torch.where(ts >= p.To_ice2, cap_open, ramp))
        cap = torch.where(z_topo < 0.0, cap_ocean_pts, cap_surf_prev)
    return torch.where(glacier > 0.5, d.cap_land, cap)


class DeepOceanResult(NamedTuple):
    dt_ocean: torch.Tensor  # surface-layer increment [K]
    dto: torch.Tensor       # deep-layer increment [K]


def deep_ocean(ts, to, mld_t, mld_tm1, z_topo, dt, d: Derived,
               p: PhysicsParams,
               exp: Experiment = Experiment()) -> DeepOceanResult:
    """Two-layer deep-ocean heat uptake.
    Reference: deep_ocean, src/greb.f90:495-525.  Entrainment/detrainment is
    ocean-masked; the turbulent-exchange terms apply everywhere, as in the
    reference."""
    zero = torch.zeros_like(ts)
    if exp.deep_ocean_off:  # legacy :514-515
        return DeepOceanResult(zero, zero)
    dmld = mld_t - mld_tm1
    ocean_warm = (z_topo < 0.0) & (ts >= p.To_ice2)
    depth_below = d.z_ocean - mld_t
    safe_below = torch.where(depth_below != 0.0, depth_below, 1.0)
    safe_mld = torch.where(mld_t != 0.0, mld_t, 1.0)

    dto = torch.where(ocean_warm & (dmld < 0.0),
                      -dmld / safe_below * (ts - to), zero)
    dt_ocean = torch.where(ocean_warm & (dmld > 0.0),
                           dmld / safe_mld * (to - ts), zero)
    dto = p.c_effmix * dto
    dt_ocean = p.c_effmix * dt_ocean

    tx = (torch.maximum(ts, p.To_ice2) if isinstance(p.To_ice2, torch.Tensor)
          else torch.clamp(ts, min=float(p.To_ice2)))
    dto = dto + dt * p.co_turb * (tx - to) / (d.cap_ocean * safe_below)
    dt_ocean = dt_ocean + dt * p.co_turb * (to - tx) / (d.cap_ocean * safe_mld)
    return DeepOceanResult(dt_ocean=dt_ocean, dto=dto)
