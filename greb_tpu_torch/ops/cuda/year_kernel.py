"""The fused year kernels: wrappers, plain versions and launch counters.

``fluxcorr_year`` replaces ``greb_tpu/ops/pallas/year_kernel.py``
``build_fluxcorr_year`` (:353) and ``scenario_year`` replaces
``build_scenario_year`` (:231).  On a CUDA tensor each wrapper launches
its kernel from ``csrc/year_kernel.cu`` (one thread block runs the whole
year with the state resident in shared memory) or raises; on a CPU tensor
it runs its plain PyTorch version, ``*_plain``, the eager loop over
``core.fluxcorr_step`` / ``core.scenario_step``.  Nothing falls back from
the card to the plain version.

Bound on the card: one block uses one of 132 SMs, and each substep rereads
~0.9 MB of coefficient planes and composites from L2, so a launch is bound
by one SM's L2 bandwidth (see the source note and PERF.md).  ``year_work``
gives the bytes and operations of a year, for the whole-card bound.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from ...config import Numerics
from ...forcing import Corrections, ModelState
from ...model import core
from .. import fastcirc2 as fc2

F32 = np.float32

# shared memory a block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232448
N_SUM = len(core.StepOutputs._fields)


@dataclass
class YearData:
    """Everything constant across the year calls of a run; ``cache`` keeps
    the member wrappers' copies of constants (month maps on the device,
    the member pack on the host), made once per run."""
    md: core.ModelData
    sfx: core.StepForcing
    fold: core.Fold
    num: Numerics
    cache: Dict = field(default_factory=dict, repr=False)


def smem_bytes(plan: fc2.FastPlan) -> int:
    """Dynamic shared memory of one launch: the 5-field state, two buffers
    of the 2 transported fields, and 3 slabs of the composite rows (the
    layout of csrc/year_kernel.cu run_year)."""
    yx = plan.ydim * plan.xdim
    kx = (plan.comp_kt + plan.comp_kb) * plan.xdim
    return 4 * (5 * yx + 4 * yx + 6 * kx)


def check_supported(plan: fc2.FastPlan) -> None:
    """Raise for what the kernels do not run: explicit segment iterations,
    packed composites, sequential zonal splitting (all refined-grid plans;
    ROADMAP Queue 1 item 10), and grids whose state does not fit one block's
    shared memory."""
    if plan.diff_segs or plan.adv_segs:
        raise NotImplementedError(
            f"year kernels: explicit polar segments (diff_segs="
            f"{plan.diff_segs}, adv_segs={plan.adv_segs}) come with the "
            f"refined-grid slice (ROADMAP Queue 1 item 10)")
    if plan.comp_mode not in ("dense", "none") or plan.seq_zonal:
        raise NotImplementedError(
            f"year kernels: comp_mode={plan.comp_mode!r} / seq_zonal="
            f"{plan.seq_zonal} come with the refined-grid slice (ROADMAP "
            f"Queue 1 item 10)")
    need = smem_bytes(plan)
    if need > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"year kernels: a {plan.xdim}x{plan.ydim} state needs {need} B of "
            f"shared memory, over one block's {MAX_SMEM_BYTES} B (multi-block "
            f"years: ROADMAP Queue 1 item 10)")


def year_work(plan: fc2.FastPlan, num: Numerics, scenario: bool):
    """(bytes, operations) one year must move and compute at least: each
    input read once and each output written once; operations counted from
    the step body's source (adds, multiplies, divides, compares,
    transcendentals each 1)."""
    yx, t = plan.ydim * plan.xdim, num.nstep_yr
    kk = plan.comp_kt + plan.comp_kb
    words = (5 * yx                      # state in
             + 8 * t * yx + t * plan.ydim  # forcing, insolation
             + 5 * yx                    # z_topo, glacier, wz_air, z_ocean, toclim
             + (7 + 8 + 9 + 1) * 2 * yx  # fold planes
             + 2 * kk * plan.xdim ** 2   # composites
             + 5 * yx                    # state out
             + 3 * t * yx)               # corrections in (scenario) / out
    if scenario:
        words += 5 * t * yx + N_SUM * yx  # outs, annual sums
    per_substep = (2 * yx * (2 * 13 + 2 + 9 + 4)       # zonal x2, clamps,
                   + 2 * kk * plan.xdim * (2 * plan.xdim + 4))  # merid, combine
    per_step = (num.nsub_crcl * per_substep
                + 2 * yx * 21                          # step coefficients
                + yx * (125 + (9 if scenario else 0)))  # physics, update, sums
    return 4 * words, t * per_step


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def fluxcorr_year_plain(state: ModelState, co2,
                        yd: YearData) -> Tuple[ModelState, Corrections]:
    return core.run_year_fluxcorr(state, yd.sfx, F32(co2), yd.md, yd.num,
                                  yd.fold)


def scenario_year_plain(state: ModelState, corr: Corrections, co2,
                        yd: YearData):
    return core.run_year_scenario(state, yd.sfx, corr, F32(co2), yd.md,
                                  yd.num, yd.fold)


# ---------------------------------------------------------------------------
# kernel binding (csrc/year_kernel.cu, extern "C")
# ---------------------------------------------------------------------------
_PARAM_NAMES = ("sig", "rho_air", "ct_sens", "da_ice", "a_no_ice", "a_cloud",
                "Tl_ice1", "Tl_ice2", "To_ice1", "To_ice2", "co_turb", "ce",
                "cq_latent", "cq_rain", "r_qviwv", "c_effmix")
_PTR_NAMES = ("tclim", "qclim", "swet", "u", "v", "mld", "mld_prev", "cld",
              "sw_solar", "z_topo", "glacier", "wz_air", "z_ocean", "toclim",
              "zd", "zam", "mer", "wz", "pcomp", "tf", "tof", "qf", "outs",
              "asum", "monthly", "mon", "mon_w", "co2_years", "ppack",
              "state_in", "state_out", "cf")
_INT_NAMES = ("Y", "X", "T", "nsub", "bt", "bb", "ktc", "kbc", "M", "n_years",
              "nmon", "corr_step", "n_pack")


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_float) for n in _PARAM_NAMES]
                + [("p_emi", ctypes.c_float * 10)]
                + [(n, ctypes.c_float) for n in
                   ("cap_ocean", "cap_land", "cap_air", "dt", "co2")])


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_NAMES]
                + [(n, ctypes.c_int) for n in _INT_NAMES])


class _PackCols(ctypes.Structure):
    """Columns of the member pack holding each kernel parameter
    (csrc/year_kernel.cu PackCols)."""
    _fields_ = [(n, ctypes.c_int) for n in
                _PARAM_NAMES + ("p_emi", "cap_ocean", "cap_land", "cap_air")]


def _lib():
    from . import build
    lib = build.load("year_kernel")
    for fn in (lib.greb_fluxcorr_year, lib.greb_scenario_year):
        fn.argtypes = [_Args, _Params, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.greb_fluxcorr_years, lib.greb_scenario_years):
        fn.argtypes = [_Args, _Params, _PackCols, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_error_string.argtypes = [ctypes.c_int]
    lib.greb_error_string.restype = ctypes.c_char_p
    return lib


def _params(yd: YearData, co2) -> _Params:
    p, d = yd.md.params, yd.md.derived
    out = _Params(**{n: float(getattr(p, n)) for n in _PARAM_NAMES})
    out.p_emi[:] = [float(v) for v in np.asarray(p.p_emi, F32)]
    out.cap_ocean, out.cap_land = float(d.cap_ocean), float(d.cap_land)
    out.cap_air, out.dt, out.co2 = float(d.cap_air), float(yd.num.dt), float(F32(co2))
    return out


def _args(yd: YearData, state5: torch.Tensor, ints=None, **extra) -> _Args:
    """Pointers of every tensor the kernel reads or writes, after checking
    device, dtype, shape and contiguity.  ``extra`` maps a field to
    ``(tensor, shape)`` or ``(tensor, shape, dtype)`` (float32 unless
    given; shape None skips the shape check); ``ints`` overrides the
    single-run sizes (M=1, one year, corrections step by step)."""
    plan, const = yd.fold
    check_supported(plan)
    num, sfx, md = yd.num, yd.sfx, yd.md
    Y, X, T = plan.ydim, plan.xdim, num.nstep_yr
    K = plan.comp_kt + plan.comp_kb
    dev = state5.device
    t = dict(
        tclim=(sfx.tclim, (T, Y, X)), qclim=(sfx.qclim, (T, Y, X)),
        swet=(sfx.swet, (T, Y, X)), u=(sfx.u, (T, Y, X)),
        v=(sfx.v, (T, Y, X)), mld=(sfx.mld, (T, Y, X)),
        mld_prev=(sfx.mld_prev, (T, Y, X)), cld=(sfx.cld, (T, Y, X)),
        sw_solar=(sfx.sw_solar, (T, Y)),
        z_topo=(md.z_topo, (Y, X)), glacier=(md.glacier, (Y, X)),
        wz_air=(md.derived.wz_air, (Y, X)),
        z_ocean=(md.derived.z_ocean, (Y, X)),
        toclim=(md.derived.toclim, (Y, X)),
        zd=(const.zd, (7, 2, Y, X)), zam=(const.zam, (8, 2, Y, X)),
        mer=(const.mer, (9, 2, Y, X)), wz=(const.wz, (2, Y, X)),
        pcomp=(const.pcomp, (2, K, X, X) if K else None),
        state_in=(state5, (5, Y, X)))
    t.update(extra)
    ptrs = {}
    for name, (ten, shape, *dtype) in t.items():
        want = dtype[0] if dtype else torch.float32
        if ten.device != dev or ten.dtype != want:
            raise ValueError(f"{name}: want {want} on {dev}, got "
                             f"{ten.dtype} on {ten.device}")
        if shape is not None and tuple(ten.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(ten.shape)}")
        if not ten.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        ptrs[name] = ten.data_ptr()
    sizes = dict(Y=Y, X=X, T=T, nsub=num.nsub_crcl, bt=plan.bt, bb=plan.bb,
                 ktc=plan.comp_kt, kbc=plan.comp_kb, M=1, n_years=1,
                 nmon=len(num.jday_mon), corr_step=Y * X, n_pack=0)
    sizes.update(ints or {})
    return _Args(**ptrs, **sizes)


def _launch(fn_name: str, args: _Args, params: _Params, dev: torch.device,
            *extra) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(args, params, *extra, stream)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.greb_error_string(err).decode()}")


def _scratch(yd: YearData, dev: torch.device, members: int = 1) -> torch.Tensor:
    """The per-step coefficient scratch (M, 12, 2, Y, X): za 7, mc 4, c0m 1,
    one slice per member (block)."""
    plan = yd.fold[0]
    return torch.empty((members, 12, 2, plan.ydim, plan.xdim),
                       dtype=torch.float32, device=dev)


def _check_device(state: ModelState) -> torch.device:
    dev = state.ts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"year kernels run on cuda (or plain on cpu), "
                         f"not {dev}")
    return dev


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def fluxcorr_year(state: ModelState, co2,
                  yd: YearData) -> Tuple[ModelState, Corrections]:
    """One spin-up year: (end state, correction tables)."""
    dev = _check_device(state)
    if dev.type == "cpu":
        return fluxcorr_year_plain(state, co2, yd)
    T, (Y, X) = yd.num.nstep_yr, tuple(state.ts.shape)
    state5 = state.stack()
    state_out = torch.empty_like(state5)
    tabs = torch.empty((3, T, Y, X), dtype=torch.float32, device=dev)
    cf = _scratch(yd, dev)
    args = _args(yd, state5, state_out=(state_out, None), cf=(cf, None),
                 tf=(tabs[0], None), tof=(tabs[1], None), qf=(tabs[2], None))
    _launch("greb_fluxcorr_year", args, _params(yd, co2), dev)
    fluxcorr_year.launches += 1
    return ModelState.unstack(state_out), Corrections(*tabs.unbind(0))


def scenario_year(state: ModelState, corr: Corrections, co2, yd: YearData):
    """One scenario year: (end state, outs (T, 5, Y, X), asum (9, Y, X))."""
    dev = _check_device(state)
    if dev.type == "cpu":
        return scenario_year_plain(state, corr, co2, yd)
    T, (Y, X) = yd.num.nstep_yr, tuple(state.ts.shape)
    state5 = state.stack()
    state_out = torch.empty_like(state5)
    outs = torch.empty((T, core.N_OUT, Y, X), dtype=torch.float32, device=dev)
    asum = torch.empty((N_SUM, Y, X), dtype=torch.float32, device=dev)
    cf = _scratch(yd, dev)
    args = _args(yd, state5, state_out=(state_out, None), cf=(cf, None),
                 tf=(corr.tf, (T, Y, X)), tof=(corr.tof, (T, Y, X)),
                 qf=(corr.qf, (T, Y, X)), outs=(outs, None),
                 asum=(asum, None))
    _launch("greb_scenario_year", args, _params(yd, co2), dev)
    scenario_year.launches += 1
    return ModelState.unstack(state_out), outs, asum


fluxcorr_year.launches = 0
scenario_year.launches = 0
