"""Host-side construction of the coefficient-folded circulation, shared with
the uniform fold in ``fastcirc2`` (``greb_tpu.ops.fastcirc``).

The circulation operator is linear in the transported field (reference
src/greb.f90:556-915), so each substep folds into per-cell coefficient
fields applied to lon/lat shifts of the field.  The polar rows sub-cycle;
their iteration counts are static (``grid.PolarSchedule``), so the rows
that iterate k times form prefixes/suffixes of the two polar bands.  Rows
that iterate many times collapse into precomputed composite operators
(I + C)^n.  This module holds the static plan, the NumPy functions that
build the composites, and the two small torch helpers the explicit row
iterations use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..grid import Grid

F32 = np.float32
F64 = np.float64

# lon shift order used by all packed 7-coefficient arrays
# (index: 0=m3, 1=m2, 2=m1, 3=centre, 4=p1, 5=p2, 6=p3)
_LON_IDX_SHIFT = ((0, 3), (1, 2), (2, 1), (4, -1), (5, -2), (6, -3))

# rows whose diffusion sub-cycle exceeds this iterate via the SVD-truncated
# composite; below it, explicit iteration is cheaper and exact
LOWRANK_N = 8
# singular values below this fraction of the largest are truncated
LOWRANK_TOL = 3e-7


@dataclass(frozen=True)
class FastPlan:
    """Static structure of the fold (python ints/tuples only)."""
    ydim: int
    xdim: int
    bt: int                      # top polar band rows [0, bt)
    bb: int                      # bottom polar band rows [Y-bb, Y)
    # extra iteration segments after the level-0 band iteration:
    # (rows_from_top_of_band, rows_from_bottom_of_band, n_iterations)
    diff_segs: Tuple[Tuple[int, int, int], ...]
    adv_segs: Tuple[Tuple[int, int, int], ...]
    # "dense" exact composites, "lowrank" SVD-truncated (refined grids; the
    # uniform fold turns them into "packed"), or "none"
    comp_mode: str = "none"
    comp_kt: int = 0             # composite rows: top-band prefix
    comp_kb: int = 0             # composite rows: bottom-band suffix
    # extension grids: zonal advection reads the zonally-diffused state
    seq_zonal: bool = False

    @property
    def diff_composite(self) -> bool:
        return self.comp_mode != "none" and (self.comp_kt + self.comp_kb) > 0

    @property
    def nband(self) -> int:
        return self.bt + self.bb


def composite_mats(pdc64: np.ndarray, n_extra: np.ndarray, ktc: int, kbc: int,
                   F: int, B: int, X: int):
    """Float64 composite operators (I + C_row)^n_extra for the ktc
    top-prefix + kbc bottom-suffix band rows.  Returns (rows_fb, {(f, b):
    (X, X) float64}); out[j] = sum_i t[i] * P[i, j]."""
    rows_fb = ([(f, b) for f in range(F) for b in range(ktc)]
               + [(f, b) for f in range(F) for b in range(B - kbc, B)])
    jout = np.arange(X)
    pc64 = {}
    for f, b in rows_fb:
        C = np.zeros((X, X))
        C[jout, jout] += pdc64[3, f, b]
        for i, s in _LON_IDX_SHIFT:
            C[(jout - s) % X, jout] += pdc64[i, f, b]
        pc64[(f, b)] = np.linalg.matrix_power(
            np.eye(X) + C, int(n_extra[b]))
    return rows_fb, pc64


def build_composites(pdc64: np.ndarray, n_extra: np.ndarray, plan: FastPlan,
                     F: int, B: int, X: int) -> np.ndarray:
    """Dense composites (F, K, X, X) float32 of the polar diffusion row
    operator for the comp_kt + comp_kb composite rows.  pdc64: (7, F, B, X)
    float64 row coefficients (no outer wz)."""
    if plan.comp_mode != "dense":
        raise ValueError(f"build_composites builds dense composites only, "
                         f"not {plan.comp_mode!r}")
    ktc, kbc = plan.comp_kt, plan.comp_kb
    K = ktc + kbc
    rows_fb, pc64 = composite_mats(pdc64, n_extra, ktc, kbc, F, B, X)
    pcomp = np.zeros((F, K, X, X))
    for f, b in rows_fb:
        k = b if b < ktc else K - (B - b)
        pcomp[f, k] = pc64[(f, b)]
    return pcomp.astype(F32)


def _segments(time2_band_top: np.ndarray, time2_band_bot: np.ndarray,
              off_t: int = 0, off_b: int = 0):
    """Extra-iteration segments after the uniform level-0 iteration: rows
    with time2=k iterate k-1 more times; time2 is monotone toward each pole,
    so the iterating rows form a prefix of the top band / suffix of the
    bottom band (shifted inward past the composite rows by off_t/off_b)."""
    top = time2_band_top[off_t:]
    bot = time2_band_bot[:len(time2_band_bot) - off_b]
    vals = sorted(set(np.concatenate([top, bot]).tolist()))
    segs = []
    prev = 1
    for v in vals:
        if v <= 1:
            continue
        kt = int((top >= v).sum())
        kb = int((bot >= v).sum())
        if not ((top[:kt] >= v).all() and (top[kt:] < v).all()
                and (bot[len(bot) - kb:] >= v).all()):
            raise ValueError("polar sub-cycle counts are not monotone")
        segs.append((kt, kb, int(v - prev)))
        prev = v
    return tuple(segs)


def make_plan(grid: Grid) -> FastPlan:
    polar = np.asarray(grid.polar_rows, bool)
    R = grid.ydim
    if polar.all():
        # refined grids: the whole field is "polar"; split into hemispheres
        bt = R // 2
        bb = R - bt
    elif polar.any():
        bt = int(np.argmin(polar))
        bb = int(np.argmin(polar[::-1]))
        ok = (polar[:bt].all() and polar[R - bb:].all()
              and not polar[bt:R - bb].any())
        if not ok:
            raise ValueError("fast path requires contiguous polar bands")
    else:
        bt = bb = 0
    d2, a2 = grid.diff_sched.time2, grid.adv_sched.time2
    top = slice(0, bt)
    bot = slice(R - bb, R)

    # composites: dense while all n>1 rows fit in 4 MiB, else SVD-truncated
    # for the huge-n rows only (moderate-n rows iterate explicitly)
    if bt + bb == 0 or not (np.concatenate([d2[top], d2[bot]]) > 1).any():
        mode, thr = "none", 1
    else:
        k_all = int((d2[top] > 1).sum()) + int((d2[bot] > 1).sum())
        if 2 * k_all * grid.xdim * grid.xdim * 4 <= 4 * 2 ** 20:
            mode, thr = "dense", 1
        else:
            mode, thr = "lowrank", LOWRANK_N
    comp_kt = int((d2[top] > thr).sum()) if mode != "none" else 0
    comp_kb = int((d2[bot] > thr).sum()) if mode != "none" else 0
    return FastPlan(
        ydim=R, xdim=grid.xdim, bt=bt, bb=bb,
        diff_segs=(_segments(d2[top], d2[bot], comp_kt, comp_kb)
                   if bt + bb else ()),
        adv_segs=_segments(a2[top], a2[bot]) if bt + bb else (),
        comp_mode=mode, comp_kt=comp_kt, comp_kb=comp_kb,
        seq_zonal=bool(grid.extension_mode),
    )


def _np_lon_shifts(a: np.ndarray):
    """dict name -> a rolled so that m1[j] = a[j-1], p1[j] = a[j+1]."""
    r = lambda s: np.roll(a, s, axis=-1)
    return {"m3": r(3), "m2": r(2), "m1": r(1), "c": a,
            "p1": r(-1), "p2": r(-2), "p3": r(-3)}


def _np_lat_shift(a: np.ndarray, s: int) -> np.ndarray:
    """Zero-halo lat shift: result[..., k, :] = a[..., k+s, :] (0 outside)."""
    out = np.zeros_like(a)
    if s > 0:
        out[..., :-s, :] = a[..., s:, :]
    elif s < 0:
        out[..., -s:, :] = a[..., :s, :]
    else:
        out = a.copy()
    return out


# ---------------------------------------------------------------------------
# torch helpers of the explicit row iterations
# ---------------------------------------------------------------------------
def _apply7(t: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_s coef[s]*roll(t, s) over [m3,m2,m1,c,p1,p2,p3], in sequence."""
    d = coef[3] * t
    for i, s in _LON_IDX_SHIFT:
        d = d + coef[i] * torch.roll(t, s, dims=-1)
    return d


def _clamped(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Positivity clamp of the polar sub-cycles (src/greb.f90:715, :907)."""
    return torch.where(d <= -t, F32(-0.9) * t, d)


def _iterate(seg: torch.Tensor, cseg: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        seg = seg + _clamped(_apply7(seg, cseg), seg)
    return seg
