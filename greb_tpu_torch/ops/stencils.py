"""Finite-difference stencil operators: diffusion, advection, circulation
(``greb_tpu.ops.stencils``; reference subroutines ``diffusion``
(src/greb.f90:556-723), ``advection`` (:726-915) and ``circulation``
(:528-553)).

The strict term-by-term transport, as the plain PyTorch version of the
year kernels' strict mode (csrc/year_kernel.cu ``strict_value``,
``strict_substep``).  Fields are (..., R, X) [lat, lon]; lon stencils read
periodic taps (views of one copy of the row wrapped by 3 columns), lat
stencils static slices of a zero-halo extended array.  The polar
sub-cycles (:651-718, :838-911) have data-independent iteration counts
(grid.PolarSchedule), so a sub-cycle is a loop over the largest count
with per-row 0/1 iteration masks: a row that is done, or not polar, adds
a zero increment.  Zero halos reproduce
the reference's one-sided pole forms, and two static row masks place the
asymmetric "/3" of the advection boundary forms (:764-795).  The index
quirk at src/greb.f90:881 (polar advection, j=xdim-2 reads jp2=xdim-1) is
reproduced behind ``quirk_jp2``.

Every float32 operation follows the JAX expression's order, and division
by a constant is true division (``pointwise.div``): the kernel repeats
these operations and must equal this version bit for bit on the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..grid import Grid
from .pointwise import div

F32 = np.float32
Extend = Callable[[torch.Tensor, int], torch.Tensor]


def extend_lat_zero(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-fill lat halos: (..., R, X) -> (..., R+2*width, X).  Zero halos
    reproduce the reference's one-sided pole forms exactly (dropped
    neighbour terms carry a wz factor of 0)."""
    return torch.nn.functional.pad(x, (0, 0, width, width))


# ---------------------------------------------------------------------------
# Per-row constants
# ---------------------------------------------------------------------------
@dataclass
class StencilFields:
    dxlat2: torch.Tensor       # (R,1) dxlat**2 [m^2]
    diff_dtdff2: torch.Tensor  # (R,1) polar diffusion sub-step [s] (0 if unused)
    diff_itm: torch.Tensor     # (Id,R,1) 0/1 diffusion sub-cycle iteration masks
    adv_ccx2: torch.Tensor     # (R,1) polar advection coefficient
    adv_itm: torch.Tensor      # (Ia,R,1) 0/1 advection iteration masks
    ccx_adv: torch.Tensor      # (R,1) dt_crcl/dxlat/2
    polar: torch.Tensor        # (R,1) bool: the row uses the sub-cycled branch
    row_mfull: torch.Tensor    # (R,1) bool: advection dTy's v_m part not /3 (row 1)
    row_pfull: torch.Tensor    # (R,1) bool: its v_p part not /3 (row ydim-2)


@dataclass(frozen=True)
class StencilStatic:
    xdim: int
    dyy: float              # f32 meridional grid length [m]
    dt_crcl: float
    diff_max_iter: int
    adv_max_iter: int
    quirk_jp2: bool = True  # src/greb.f90:881 index quirk
    # Polar rows form two contiguous bands; when compact_polar is set, the
    # sub-cycled branch runs only on those bands (rows [0, polar_top) and
    # [R - polar_bot, R)), else on the full field under the row masks.
    polar_top: int = 0
    polar_bot: int = 0
    compact_polar: bool = True
    # Extension grids: zonal advection reads the zonally-diffused state
    # (sequential splitting, ops/fastcirc2.FastPlan.seq_zonal); grids
    # inside the reference's envelope keep the additive form (:546-550).
    seq_zonal: bool = False


def make_stencil_arrays(grid: Grid, quirk_jp2: bool = True, device="cpu"):
    """(StencilStatic, StencilFields on ``device``) from the grid metrics."""
    R = grid.ydim
    col = lambda a: np.asarray(a, F32).reshape(R, 1)
    dsched, asched = grid.diff_sched, grid.adv_sched

    def iter_masks(time2: np.ndarray, max_iter: int) -> np.ndarray:
        if max_iter == 0:
            return np.zeros((1, R, 1), F32)
        return np.stack([(time2 > i).astype(F32).reshape(R, 1)
                         for i in range(max_iter)])

    t = lambda a: torch.as_tensor(a, device=device)
    sf = StencilFields(
        dxlat2=t(col(grid.dxlat.astype(F32) ** 2)),
        diff_dtdff2=t(col(dsched.dtdff2)),
        diff_itm=t(iter_masks(dsched.time2, dsched.max_iter)),
        adv_ccx2=t(col(asched.ccx2)),
        adv_itm=t(iter_masks(asched.time2, asched.max_iter)),
        ccx_adv=t(col(grid.ccx_adv)),
        polar=t(col(grid.polar_rows).astype(bool)),
        row_mfull=t(col(np.arange(R) == 1).astype(bool)),
        row_pfull=t(col(np.arange(R) == R - 2).astype(bool)),
    )
    polar = np.asarray(grid.polar_rows, bool)
    kt = int(np.argmin(polar)) if not polar.all() else R
    kb = int(np.argmin(polar[::-1])) if not polar.all() else 0
    contiguous = bool(
        polar.all() or
        (polar[:kt].all() and polar[R - kb:].all()
         and not polar[kt:R - kb].any()))
    st = StencilStatic(
        xdim=grid.xdim, dyy=float(F32(grid.dyy)), dt_crcl=float(grid.dt_crcl),
        diff_max_iter=dsched.max_iter, adv_max_iter=asched.max_iter,
        quirk_jp2=quirk_jp2,
        polar_top=kt if contiguous else 0,
        polar_bot=kb if contiguous else 0,
        compact_polar=contiguous,
        seq_zonal=bool(grid.extension_mode),
    )
    return st, sf


def diffusion_ccy(st: StencilStatic, kappa) -> np.float32:
    """kappa * dt_crcl / dyy**2 in float32, left to right (:582)."""
    dyy = F32(st.dyy)
    return F32(kappa) * F32(st.dt_crcl) / (dyy * dyy)


def advection_ccy(st: StencilStatic) -> np.float32:
    """dt_crcl / dyy / 2 in float64, rounded once to float32 (:753)."""
    return F32(st.dt_crcl / st.dyy / 2.0)


def sub_cycles(st: StencilStatic, sf: StencilFields):
    """(diffusion, advection) sub-cycle iterations of each row, (R,) int32:
    the row's count where it takes the sub-cycled branch, -1 where it takes
    the vectorised one (not polar, or no polar iterations at all)."""
    out = []
    for itm, max_iter in ((sf.diff_itm, st.diff_max_iter),
                          (sf.adv_itm, st.adv_max_iter)):
        n = itm.sum(dim=0).reshape(-1).to(torch.int32)
        sub = sf.polar.reshape(-1) if max_iter > 0 else torch.zeros_like(
            n, dtype=torch.bool)
        out.append(torch.where(sub, n, torch.full_like(n, -1)))
    return tuple(out)


# ---------------------------------------------------------------------------
# lon shifts
# ---------------------------------------------------------------------------
class LonShifts(NamedTuple):
    """x rolled by -3..+3 along lon.  m1 = value at j-1 (roll +1), etc."""
    c: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    m3: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    p2q: torch.Tensor  # p2 with the src/greb.f90:881 quirk applied


def _taps7(x: torch.Tensor) -> torch.Tensor:
    """(..., R, X) -> (..., R, 7, X): the taps j-3..j+3 of every column, a
    view of one copy of x wrapped by 3 columns each side."""
    X = x.shape[-1]
    xp = torch.cat([x[..., -3:], x, x[..., :3]], dim=-1)
    return xp.unfold(-1, X, 1)


def lon_shifts(x: torch.Tensor, xdim: int, quirk: bool) -> LonShifts:
    """The 7 periodic taps of every column, views of ``_taps7`` (one copy
    of x where six rolls would make six)."""
    t = _taps7(x)
    r = lambda s: t[..., 3 - s, :]    # = torch.roll(x, s, -1)
    p1, p2 = r(-1), r(-2)
    if quirk:
        cols = torch.arange(xdim, device=x.device)
        p2q = torch.where(cols == xdim - 3, p1, p2)   # Fortran j = xdim-2
    else:
        p2q = p2
    return LonShifts(c=x, m1=r(1), m2=r(2), m3=r(3), p1=p1, p2=p2, p3=r(-3),
                     p2q=p2q)


class WzPack(NamedTuple):
    """Topography weights: lon shifts + lat-extended slices (width 2)."""
    lon: LonShifts
    km1: torch.Tensor
    km2: torch.Tensor
    kp1: torch.Tensor
    kp2: torch.Tensor


def make_wz_pack(wz: torch.Tensor, st: StencilStatic,
                 extend: Extend = extend_lat_zero) -> WzPack:
    wze = extend(wz, 2)
    return WzPack(
        lon=lon_shifts(wz, st.xdim, st.quirk_jp2),
        km1=wze[..., 1:-3, :], km2=wze[..., :-4, :],
        kp1=wze[..., 3:-1, :], kp2=wze[..., 4:, :],
    )


# ---------------------------------------------------------------------------
# zonal stencil kernels (shared by main + polar branches)
# ---------------------------------------------------------------------------
# _diff7 (src/greb.f90:617-626, weights 10/4/1 over neighbour differences)
# as a table over the 7 taps k = 0..6, columns j-3..j+3: five pairs of
# terms w[W] * (t[A] - t[B]), the pair sums scaled by 10, 4, 4, 1, 1 and
# added in order:
#   10 * (w.m1 * (t.m1 - t.c)  + w.p1 * (t.p1 - t.c))
#  + 4 * (w.m2 * (t.m2 - t.m1) + w.m1 * (t.c - t.m1))
#  + 4 * (w.p1 * (t.c - t.p1)  + w.p2 * (t.p2 - t.p1))
#  + 1 * (w.m3 * (t.m3 - t.m2) + w.m2 * (t.m1 - t.m2))
#  + 1 * (w.p2 * (t.p1 - t.p2) + w.p3 * (t.p3 - t.p2))
# Every element takes these float32 operations in this order, as the
# kernel's diff7 does; gathered along a tap axis they are 13 tensor
# operations where one per term would be 38.
_D7_A = (2, 4, 1, 3, 3, 5, 0, 2, 4, 6)
_D7_B = (3, 3, 2, 2, 4, 4, 1, 1, 5, 5)
_D7_W = (2, 4, 1, 2, 4, 5, 0, 1, 5, 6)
_D7_SCALE = (10.0, 4.0, 4.0, 1.0, 1.0)


@functools.lru_cache(maxsize=None)
def _d7_table(device: torch.device):
    """The _D7 tap indices (A then B, and W) and the pair weights, on
    ``device``."""
    idx = lambda v: torch.tensor(v, dtype=torch.long, device=device)
    return (idx(_D7_A + _D7_B), idx(_D7_W),
            torch.tensor(_D7_SCALE, dtype=torch.float32,
                         device=device).reshape(5, 1))


def _diff7_weights(w: torch.Tensor) -> torch.Tensor:
    """The wz factor of each of _diff7's ten terms: (..., R, 10, X)."""
    return _taps7(w).index_select(-2, _d7_table(w.device)[1])


def _diff7(x: torch.Tensor, w10: torch.Tensor, cc) -> torch.Tensor:
    """Smoothed 3rd-order 7-point diffusion stencil of x (the _D7 table);
    w10 from _diff7_weights of its wz, cc the row's coefficient."""
    iab, _, scale = _d7_table(x.device)
    t = _taps7(x).index_select(-2, iab)
    terms = w10 * (t[..., :10, :] - t[..., 10:, :])
    pairs = (terms[..., 0::2, :] + terms[..., 1::2, :]) * scale
    s = pairs[..., 0, :] + pairs[..., 1, :]
    for k in (2, 3, 4):
        s = s + pairs[..., k, :]
    return div(cc * s, 20.0)


def _adv_upwind2(t: LonShifts, w: LonShifts, u_m, u_p, cc) -> torch.Tensor:
    """2-point upwind zonal advection (src/greb.f90:814-820)."""
    return div(cc * (
        -u_m * (w.m1 * (t.c - t.m1) + w.m2 * (t.c - t.m2))
        + u_p * (w.p1 * (t.c - t.p1) + w.p2 * (t.c - t.p2))), 3.0)


def _adv_smooth3(t: LonShifts, w: LonShifts, u_m, u_p, cc,
                 quirk: bool) -> torch.Tensor:
    """Smoothed 10/4/1 3-point upwind used in the polar sub-cycle
    (src/greb.f90:842-906), incl. the jp2 quirk at j=xdim-2 (:881)."""
    tp2 = t.p2q if quirk else t.p2
    wp2 = w.p2q if quirk else w.p2
    return div(cc * (
        -u_m * (10.0 * w.m1 * (t.c - t.m1)
                + 4.0 * w.m2 * (t.m1 - t.m2)
                + 1.0 * w.m3 * (t.m2 - t.m3))
        + u_p * (10.0 * w.p1 * (t.c - t.p1)
                 + 4.0 * wp2 * (t.p1 - tp2)
                 + 1.0 * w.p3 * (tp2 - t.p3))), 20.0)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
def _subcycle(x0: torch.Tensor, itm: torch.Tensor, max_iter: int,
              step_fn) -> torch.Tensor:
    """Masked clamped iteration: t1h += clamp(step_fn(t1h)) * itm[i]
    (the product by a 0/1 mask is exact, so one fused multiply-add rounds
    as the multiply and the add do)."""
    t1h = x0
    for i in range(max_iter):
        d = step_fn(t1h)
        d = torch.where(d <= -t1h, -0.9 * t1h, d)  # clamp (:715, :907)
        t1h = torch.addcmul(t1h, d, itm[i])
    return t1h


def _bands(a: torch.Tensor, st: StencilStatic, R: int) -> torch.Tensor:
    """The rows of the two polar bands of ``a`` stacked along lat (-2), top
    band first: the zonal stencils are row-local, so one sub-cycle serves
    both bands."""
    return torch.cat([a[..., :st.polar_top, :],
                      a[..., R - st.polar_bot:, :]], dim=-2)


def _rows(w: LonShifts, sl: slice) -> LonShifts:
    """The rows ``sl`` (lat, -2) of every tap."""
    return LonShifts(*[a[..., sl, :] for a in w])


def _unband(mid: torch.Tensor, bands: torch.Tensor,
            st: StencilStatic) -> torch.Tensor:
    """[top band, mid rows, bottom band] along lat, from the stacked bands."""
    return torch.cat([bands[..., :st.polar_top, :], mid,
                      bands[..., st.polar_top:, :]], dim=-2)


def _cdiv(s, t: torch.Tensor) -> torch.Tensor:
    """s / t for a scalar s, as true float32 division (PyTorch computes a
    scalar over a tensor as t.reciprocal() * s)."""
    return torch.full_like(t, s) / t


def diffusion(x: torch.Tensor, wz: torch.Tensor, pack: WzPack,
              st: StencilStatic, sf: StencilFields, kappa,
              extend: Extend = extend_lat_zero, split: bool = False):
    """dX_diffuse = wz * (dTx + dTy); reference src/greb.f90:556-723.
    ``split=True`` returns the raw (dtx, dty) pair instead (the sequential
    extension-mode substep applies wz to each part separately)."""
    xe = extend(x, 2)
    x_km1, x_kp1 = xe[..., 1:-3, :], xe[..., 3:-1, :]
    kd = F32(kappa) * F32(st.dt_crcl)
    ccy = diffusion_ccy(st, kappa)
    dty = ccy * (pack.km1 * (x_km1 - x) + pack.kp1 * (x_kp1 - x))

    if st.diff_max_iter > 0 and st.compact_polar:
        # zonal stencils are row-local: the vectorised 7-point form only on
        # the non-polar mid band, the sub-cycled form only on the two polar
        # bands, stacked (their vectorised result would be discarded)
        R = x.shape[-2]
        mid = slice(st.polar_top, R - st.polar_bot)
        dtx = _diff7(x[..., mid, :], _diff7_weights(wz[..., mid, :]),
                     _cdiv(kd, sf.dxlat2[mid]))
        xb = _bands(x, st, R)
        wb = _diff7_weights(_bands(wz, st, R))
        ccx2 = (F32(kappa) * _bands(sf.diff_dtdff2, st, R)) / _bands(
            sf.dxlat2, st, R)
        t1h = _subcycle(xb, _bands(sf.diff_itm, st, R), st.diff_max_iter,
                        lambda t: _diff7(t, wb, ccx2))
        dtx = _unband(dtx, t1h - xb, st)
    else:
        w10 = _diff7_weights(wz)
        dtx = _diff7(x, w10, _cdiv(kd, sf.dxlat2))
        if st.diff_max_iter > 0:  # masked full-field form
            ccx2 = (F32(kappa) * sf.diff_dtdff2) / sf.dxlat2
            t1h = _subcycle(x, sf.diff_itm, st.diff_max_iter,
                            lambda t: _diff7(t, w10, ccx2))
            dtx = torch.where(sf.polar, t1h - x, dtx)

    if split:
        return dtx, dty
    return wz * (dtx + dty)


def advection(x: torch.Tensor, pack: WzPack, u_m, u_p, v_m, v_p,
              st: StencilStatic, sf: StencilFields,
              extend: Extend = extend_lat_zero,
              x_zonal: torch.Tensor = None) -> torch.Tensor:
    """dX_advec = dTx + dTy; reference src/greb.f90:726-915.

    ``x_zonal`` (sequential extension-mode substep) supplies a different
    state for the ZONAL part (the zonally-diffused field); the meridional
    part always reads ``x``."""
    xz = x if x_zonal is None else x_zonal
    xe = extend(x, 2)
    x_km1, x_km2 = xe[..., 1:-3, :], xe[..., :-4, :]
    x_kp1, x_kp2 = xe[..., 3:-1, :], xe[..., 4:, :]

    # meridional upwind; zero halos nullify out-of-domain terms, masks place
    # the asymmetric /3 of the boundary forms (:756-795)
    t_km1 = pack.km1 * (x - x_km1)
    t_km2 = pack.km2 * (x - x_km2)
    t_kp1 = pack.kp1 * (x - x_kp1)
    t_kp2 = pack.kp2 * (x - x_kp2)
    s_m = v_m * (t_km1 + t_km2)
    s_p = v_p * (t_kp1 + t_kp2)
    ccy = advection_ccy(st)
    dty = ccy * (-torch.where(sf.row_mfull, s_m, div(s_m, 3.0))
                 + torch.where(sf.row_pfull, s_p, div(s_p, 3.0)))

    if st.adv_max_iter > 0 and st.compact_polar:
        R = x.shape[-2]
        mid = slice(st.polar_top, R - st.polar_bot)
        tsm = lon_shifts(xz[..., mid, :], st.xdim, quirk=False)
        dtx = _adv_upwind2(tsm, _rows(pack.lon, mid), u_m[..., mid, :],
                           u_p[..., mid, :], sf.ccx_adv[mid])
        xb = _bands(xz, st, R)
        wb = lon_shifts(_bands(pack.lon.c, st, R), st.xdim,
                        quirk=st.quirk_jp2)
        ub_m, ub_p = _bands(u_m, st, R), _bands(u_p, st, R)
        cc2 = _bands(sf.adv_ccx2, st, R)
        t1h = _subcycle(
            xb, _bands(sf.adv_itm, st, R), st.adv_max_iter,
            lambda t: _adv_smooth3(
                lon_shifts(t, st.xdim, quirk=st.quirk_jp2), wb,
                ub_m, ub_p, cc2, st.quirk_jp2))
        dtx = _unband(dtx, t1h - xb, st)
    else:
        ts = lon_shifts(xz, st.xdim, quirk=False)
        dtx = _adv_upwind2(ts, pack.lon, u_m, u_p, sf.ccx_adv)

    if st.adv_max_iter > 0 and not st.compact_polar:
        t1h = _subcycle(
            xz, sf.adv_itm, st.adv_max_iter,
            lambda t: _adv_smooth3(
                lon_shifts(t, st.xdim, quirk=st.quirk_jp2), pack.lon,
                u_m, u_p, sf.adv_ccx2, st.quirk_jp2))
        dtx = torch.where(sf.polar, t1h - xz, dtx)

    return dtx + dty


def circulation(x: torch.Tensor, wz: torch.Tensor, u_m, u_p, v_m, v_p,
                st: StencilStatic, sf: StencilFields, kappa, nsub: int,
                extend: Extend = extend_lat_zero,
                include_advection: bool = True) -> torch.Tensor:
    """Sub-cycled diffusion+advection increment over one model step.
    Reference: circulation, src/greb.f90:528-553 (nsub = dt/dt_crcl = 24).
    ``include_advection=False`` reproduces legacy log_exp==8 (vapor
    diffusion-only, greb.original.model.f90:560-565)."""
    pack = make_wz_pack(wz, st, extend)

    def substep(xc):
        if st.seq_zonal:
            # extension grids: zonal advection reads the zonally-diffused
            # state; the meridional terms stay additive from xc
            dtx, dty = diffusion(xc, wz, pack, st, sf, kappa, extend,
                                 split=True)
            xz = xc + wz * dtx
            if include_advection:
                dxa = advection(xc, pack, u_m, u_p, v_m, v_p, st, sf, extend,
                                x_zonal=xz)
                return xz + wz * dty + dxa
            return xz + wz * dty
        dxd = diffusion(xc, wz, pack, st, sf, kappa, extend)
        if include_advection:
            dxa = advection(xc, pack, u_m, u_p, v_m, v_p, st, sf, extend)
            return xc + dxd + dxa
        return xc + dxd

    xc = x
    for _ in range(nsub):
        xc = substep(xc)
    return xc - x
