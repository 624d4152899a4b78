"""Model core: tendencies, the time step, and the eager year runners
(``greb_tpu.model.core``; reference src/greb.f90:161-364).

One 12-hour step is a function ``(state, step_forcing) -> (state,
outputs)``; a year is a Python loop over the 730 steps.  These eager year
runners are the plain PyTorch versions of the two CUDA year kernels
(ops/cuda/year_kernel.py), which run the same step body on the card.  The
legacy ``log_exp`` switchboard reaches every function through ``exp``, as
in the JAX package.  Ta and q move by one of three transports
(``transport``): the coefficient-folded circulation (ops/fastcirc2.py),
the strict term-by-term stencils (ops/stencils.py: the strict circulation,
and legacy log_exp 7, 8, 16) or none (log_exp <= 4).
Monthly means are one (12, nstep) x (nstep, 5*y*x) product outside the
year, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Experiment, Numerics, PhysicsParams
from ..forcing import ClimForcing, Corrections, Derived, ModelState
from ..ops import fastcirc2 as fc2
from ..ops import pointwise as pw
from ..ops import stencils as stc

F32 = np.float32

# the fold: (plan, const), or with a third element that picks the matmul
# circulation (fastcirc2.MxuMembers, MxuConst) or the member kernels' plain
# twin of it (fastcirc2.MxuTwin)
Fold = Tuple


# ---------------------------------------------------------------------------
# Per-step forcing slices
# ---------------------------------------------------------------------------
@dataclass
class StepForcing:
    tclim: torch.Tensor     # (t,y,x)
    qclim: torch.Tensor
    swet: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mld: torch.Tensor
    mld_prev: torch.Tensor  # mld at ityr-1 (wrapped; src/greb.f90:507-508)
    cld: torch.Tensor
    sw_solar: torch.Tensor  # (t,y)

    def at(self, t: int) -> "StepForcing":
        return StepForcing(**{f.name: getattr(self, f.name)[t]
                              for f in dataclasses.fields(self)})


def step_forcing_from_clim(f: ClimForcing) -> StepForcing:
    return StepForcing(
        tclim=f.tclim, qclim=f.qclim, swet=f.swetclim, u=f.uclim, v=f.vclim,
        mld=f.mldclim, mld_prev=torch.roll(f.mldclim, 1, dims=0),
        cld=f.cldclim, sw_solar=f.sw_solar,
    )


class StepOutputs(NamedTuple):
    """Per-step fields accumulated into monthly/annual means."""
    ts: torch.Tensor
    ta: torch.Tensor
    to: torch.Tensor
    q: torch.Tensor
    albedo: torch.Tensor
    # annual console diagnostics extras (src/greb.f90:944-947)
    sw: torch.Tensor
    lw_surf: torch.Tensor
    q_lat: torch.Tensor
    q_sens: torch.Tensor


# the 5 output variables the reference writes (src/greb.f90:978-982)
N_OUT = 5


class Tendencies(NamedTuple):
    sw: torch.Tensor
    albedo: torch.Tensor
    lw_surf: torch.Tensor
    lwair_up: torch.Tensor
    lwair_down: torch.Tensor
    em: torch.Tensor
    q_sens: torch.Tensor
    q_lat: torch.Tensor
    q_lat_air: torch.Tensor
    dq_eva: torch.Tensor
    dq_rain: torch.Tensor
    dta_crcl: torch.Tensor
    dq_crcl: torch.Tensor
    dt_ocean: torch.Tensor
    dto: torch.Tensor


@dataclass
class ModelData:
    """Everything time-constant the step needs; ``st`` and ``sf`` are the
    strict stencils' constants."""
    params: PhysicsParams
    derived: Derived
    z_topo: torch.Tensor
    glacier: torch.Tensor
    st: Optional[stc.StencilStatic] = None
    sf: Optional[stc.StencilFields] = None


def transport(exp: Experiment, folded: bool) -> str:
    """What moves Ta and q: "none" (legacy log_exp <= 4), "strict" (the
    term-by-term stencils: legacy log_exp 7, 8, 16, or no fold) or "fold"
    (the coefficient-folded circulation), as the JAX package's
    compute_tendencies decides it (``folded``: a fold is given)."""
    if exp.circulation_off:
        return "none"
    if exp.vapor_circulation_off or exp.vapor_diffusion_only or not folded:
        return "strict"
    return "fold"


def compute_tendencies(state: ModelState, fx: StepForcing, co2,
                       md: ModelData, num: Numerics, fold: Optional[Fold],
                       exp: Experiment = Experiment(),
                       extend=fc2.extend_lat_zero) -> Tendencies:
    """Reference: tendencies, src/greb.f90:277-308, with the circulation
    of (Ta, q) by ``transport``: the fold, the strict stencils (Ta only
    under log_exp 7 and 16; under 8 q by diffusion alone) or none.
    ``extend(x, 2)``: the meridional halo rows, zeros past the poles or a
    latitude shard's neighbour rows (parallel/halo.py)."""
    p, d = md.params, md.derived
    swr = pw.shortwave(state.ts, fx.cld, fx.sw_solar, md.z_topo, md.glacier,
                       p, exp)
    lwr = pw.longwave(state.ts, state.ta, state.q, co2, fx.cld, fx.tclim,
                      fx.qclim, d.wz_air, p, exp)
    q_sens = pw.sensible_heat(state.ts, state.ta, p)
    hyd = pw.hydrology(state.ts, state.q, fx.u, fx.v, fx.swet, md.z_topo,
                       d.wz_air, p, exp)

    mode = transport(exp, fold is not None)
    if mode == "none":
        dta_crcl = dq_crcl = torch.zeros_like(state.ta)
    elif mode == "fold":
        # a third element of the fold tuple picks the circulation, as in
        # greb_tpu's core: the member-batched matmul form (MxuMembers), the
        # matmul form (MxuConst), the member kernels' twin (MxuTwin)
        plan, const = fold[0], fold[1]
        mxu = fold[2] if len(fold) > 2 else None
        x2 = torch.stack([state.ta, state.q], dim=-3)
        cf_t = fc2.step_coeffs(fx.u, fx.v, const, plan)
        nsub = num.nsub_crcl
        if isinstance(mxu, fc2.MxuMembers):
            dx2 = fc2.mxu_members_circulation(x2, cf_t, const, mxu, plan,
                                              nsub)
        elif isinstance(mxu, fc2.MxuConst):
            dx2 = fc2.mxu_circulation(x2, cf_t, const, mxu, plan, nsub)
        else:
            prec = mxu.precision if isinstance(mxu, fc2.MxuTwin) \
                else "highest"
            dx2 = fc2.circulation(x2, cf_t, const, plan, nsub, extend, prec)
        dta_crcl, dq_crcl = dx2[..., 0, :, :], dx2[..., 1, :, :]
    else:
        # wind sign splits (src/greb.f90:203-216)
        circ = functools.partial(
            stc.circulation, u_m=torch.clamp(fx.u, min=0.0),
            u_p=torch.clamp(fx.u, max=0.0), v_m=torch.clamp(fx.v, min=0.0),
            v_p=torch.clamp(fx.v, max=0.0), st=md.st, sf=md.sf,
            kappa=p.kappa, nsub=num.nsub_crcl, extend=extend)
        if exp.vapor_circulation_off:              # legacy log_exp 7, 16
            dta_crcl = circ(state.ta, d.wz_air)
            dq_crcl = torch.zeros_like(state.q)
        elif exp.vapor_diffusion_only:             # legacy log_exp 8
            dta_crcl = circ(state.ta, d.wz_air)
            dq_crcl = circ(state.q, d.wz_vapor, include_advection=False)
        else:
            # (Ta, q) batched along a leading axis: one circulation
            x2 = torch.stack([state.ta, state.q], dim=-3)
            wz2 = torch.stack([d.wz_air, d.wz_vapor], dim=-3)
            dx2 = circ(x2, wz2)
            dta_crcl, dq_crcl = dx2[..., 0, :, :], dx2[..., 1, :, :]

    doc = pw.deep_ocean(state.ts, state.to, fx.mld, fx.mld_prev, md.z_topo,
                        F32(num.dt), d, p, exp)
    return Tendencies(sw=swr.sw, albedo=swr.albedo, lw_surf=lwr.lw_surf,
                      lwair_up=lwr.lwair_up, lwair_down=lwr.lwair_down,
                      em=lwr.em, q_sens=q_sens, q_lat=hyd.q_lat,
                      q_lat_air=hyd.q_lat_air, dq_eva=hyd.dq_eva,
                      dq_rain=hyd.dq_rain, dta_crcl=dta_crcl,
                      dq_crcl=dq_crcl, dt_ocean=doc.dt_ocean, dto=doc.dto)


# ---------------------------------------------------------------------------
# Scenario step (reference: time_loop, src/greb.f90:239-274)
# ---------------------------------------------------------------------------
def scenario_step(state: ModelState, fx: StepForcing, corr_t, co2,
                  md: ModelData, num: Numerics, fold: Fold,
                  exp: Experiment = Experiment(), extend=fc2.extend_lat_zero
                  ) -> Tuple[ModelState, StepOutputs]:
    if exp.sst_plus_one:  # legacy exp 14-16 (greb.original.model.f90:225-226)
        state = state.replace(ts=torch.where(md.z_topo < 0.0,
                                             fx.tclim + 1.0, state.ts))
    ten = compute_tendencies(state, fx, co2, md, num, fold, exp, extend)
    tf_t, tof_t, qf_t = corr_t
    dt = F32(num.dt)

    ts0 = state.ts + ten.dt_ocean + dt * (
        ten.sw + ten.lw_surf - ten.lwair_down + ten.q_lat + ten.q_sens
        + tf_t) / state.cap_surf
    ta0 = state.ta + ten.dta_crcl + pw.div(dt * (
        ten.lwair_up + ten.lwair_down - ten.em * ten.lw_surf + ten.q_lat_air
        - ten.q_sens), md.derived.cap_air)
    to0 = state.to + ten.dto + tof_t
    dq = dt * (ten.dq_eva + ten.dq_rain) + ten.dq_crcl + qf_t
    dq = torch.where(dq <= -state.q, F32(-0.9) * state.q, dq)  # positivity (:265)
    q0 = state.q + dq
    cap = pw.seaice_capacity(ts0, state.cap_surf, fx.mld, md.z_topo,
                             md.glacier, md.derived, md.params, exp)
    new_state = ModelState(ts=ts0, ta=ta0, to=to0, q=q0, cap_surf=cap)
    out = StepOutputs(ts=ts0, ta=ta0, to=to0, q=q0, albedo=ten.albedo,
                      sw=ten.sw, lw_surf=ten.lw_surf, q_lat=ten.q_lat,
                      q_sens=ten.q_sens)
    return new_state, out


# ---------------------------------------------------------------------------
# Flux-correction step (reference: qflux_correction, src/greb.f90:311-364)
# ---------------------------------------------------------------------------
def fluxcorr_step(state: ModelState, fx: StepForcing, co2, md: ModelData,
                  num: Numerics, fold: Fold, exp: Experiment = Experiment(),
                  extend=fc2.extend_lat_zero):
    ten = compute_tendencies(state, fx, co2, md, num, fold, exp, extend)
    dt = F32(num.dt)
    cap = state.cap_surf
    dts = dt * (ten.sw + ten.lw_surf - ten.lwair_down + ten.q_lat
                + ten.q_sens) / cap
    ts0_raw = state.ts + dts + ten.dt_ocean
    tf = pw.div((fx.tclim - ts0_raw) * cap, dt)            # [W/m^2] (:344-345)
    ts0 = state.ts + dts + ten.dt_ocean + tf * dt / cap

    dta = pw.div(dt * (ten.lwair_up + ten.lwair_down - ten.em * ten.lw_surf
                       + ten.q_lat_air - ten.q_sens), md.derived.cap_air)
    ta0 = state.ta + dta + ten.dta_crcl

    to0_raw = state.to + ten.dto
    tof = md.derived.toclim - to0_raw                      # [K/step] (:349)
    to0 = state.to + ten.dto + tof

    dq = dt * (ten.dq_eva + ten.dq_rain)
    q0_raw = state.q + dq + ten.dq_crcl
    qf = fx.qclim - q0_raw                                 # (:353)
    q0 = state.q + dq + ten.dq_crcl + qf

    cap_new = pw.seaice_capacity(ts0, cap, fx.mld, md.z_topo, md.glacier,
                                 md.derived, md.params, exp)
    new_state = ModelState(ts=ts0, ta=ta0, to=to0, q=q0, cap_surf=cap_new)
    return new_state, (tf, tof, qf)


# ---------------------------------------------------------------------------
# Eager year runners (the plain versions of the CUDA year kernels)
# ---------------------------------------------------------------------------
def run_year_fluxcorr(state: ModelState, sfx: StepForcing, co2,
                      md: ModelData, num: Numerics, fold: Fold,
                      exp: Experiment = Experiment(),
                      extend=fc2.extend_lat_zero):
    """One spin-up year; returns the end state and the nstep-slot
    correction tables (each year overwrites them; src/greb.f90:325-362).
    ``extend``: the meridional halo (``compute_tendencies``)."""
    nstep = sfx.tclim.shape[0]
    tabs = torch.empty((3, nstep) + tuple(state.ts.shape),
                       dtype=torch.float32, device=state.ts.device)
    for t in range(nstep):
        state, corr_t = fluxcorr_step(state, sfx.at(t), co2, md, num, fold,
                                      exp, extend)
        for i in range(3):
            tabs[i, t] = corr_t[i]
    return state, Corrections(tf=tabs[0], tof=tabs[1], qf=tabs[2])


def run_year_scenario(state: ModelState, sfx: StepForcing, corr: Corrections,
                      co2, md: ModelData, num: Numerics, fold: Fold,
                      exp: Experiment = Experiment(),
                      extend=fc2.extend_lat_zero):
    """One scenario year.  Returns (state, outs (nstep, 5, y, x) — the 5
    written variables per step — and asum (9, y, x), the annual sums of
    all StepOutputs fields in sequential float32, src/greb.f90:944-948).
    ``extend``: the meridional halo (``compute_tendencies``)."""
    nstep = sfx.tclim.shape[0]
    shape = tuple(state.ts.shape)
    dev = state.ts.device
    outs = torch.empty((nstep, N_OUT) + shape, dtype=torch.float32, device=dev)
    asum = torch.zeros((len(StepOutputs._fields),) + shape,
                       dtype=torch.float32, device=dev)
    for t in range(nstep):
        corr_t = (corr.tf[t], corr.tof[t], corr.qf[t])
        state, out = scenario_step(state, sfx.at(t), corr_t, co2, md, num,
                                   fold, exp, extend)
        outs[t] = torch.stack(out[:N_OUT])
        asum += torch.stack(out)
    return state, outs, asum


def monthly_means(month_mat: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
    """(12, nstep) @ (nstep, 5*y*x) -> (12, 5, y, x), in full float32 (the
    package switches TF32 off).  Reference: src/greb.f90:962-987."""
    nstep = outs.shape[0]
    return torch.matmul(month_mat, outs.reshape(nstep, -1)).reshape(
        (month_mat.shape[0],) + tuple(outs.shape[1:]))


class YearDiag(NamedTuple):
    """Annual console diagnostics (src/greb.f90:948-957)."""
    global_mean_ts: torch.Tensor  # scalar [K]
    point_ts: torch.Tensor        # Tsurf at (ipx, ipy) [K]
    mean_fields: StepOutputs      # annual means of all step outputs
    ft_mean: Optional[torch.Tensor] = None
    fq_mean: Optional[torch.Tensor] = None


def annual_means(asum: torch.Tensor, num: Numerics) -> StepOutputs:
    return StepOutputs(*pw.div(asum, F32(num.nstep_yr)).unbind(0))


def correction_annual_means(corr: Corrections):
    """Annual means of the TF/qF tables (ftmn/fqmn, src/greb.f90:945-947)."""
    return corr.tf.mean(dim=-3), corr.qf.mean(dim=-3)


def year_diag(mean_fields: StepOutputs, num: Numerics) -> YearDiag:
    """Console diagnostics from the annual-mean fields (reference
    src/greb.f90:948-957; unweighted global mean)."""
    gm = mean_fields.ts.mean(dim=(-2, -1))
    pt = mean_fields.ts[..., num.ipy - 1, num.ipx - 1]
    return YearDiag(global_mean_ts=gm, point_ts=pt, mean_fields=mean_fields)


def co2_series_for_run(num: Numerics, exp: Experiment,
                       co2_ppm_series: np.ndarray) -> np.ndarray:
    """Per-year CO2 of the scenario phase.

    Modern variant: the namelist series (src/greb.f90:918-926).  Legacy
    variant: constant 680, CO2_ctrl under SST+1, or the A1B ramp for
    log_exp 12/13 (src/greb.original.model.f90:939-953)."""
    if not exp.active:
        return np.asarray(co2_ppm_series, F32)[: num.time_scnr]
    if exp.sst_plus_one:
        return np.full(num.time_scnr, exp.co2_ctrl, F32)
    if exp.a1b_co2:
        y = (num.year0 + np.arange(num.time_scnr)).astype(F32)
        co2 = np.full(num.time_scnr, 680.0, F32)
        co2 = np.where(y <= 2000, F32(310.0) + F32(60.0 / 50.0) * (y - 1950),
                       co2)
        co2 = np.where((y > 2000) & (y <= 2050),
                       F32(370.0) + F32(150.0 / 50.0) * (y - 2000), co2)
        co2 = np.where((y > 2050) & (y <= 2100),
                       F32(520.0) + F32(180.0 / 50.0) * (y - 2050), co2)
        return co2.astype(F32)
    return np.full(num.time_scnr, 680.0, F32)
