"""Grid refinement: interpolate a forcing dataset onto a finer (or coarser)
lat-lon grid (``greb_tpu.regrid``).

The reference is hard-wired to 96x48 (src/greb.f90:36); every grid metric
is a function of (xdim, ydim) (grid.make_grid), so a refined-grid run
(384x192, 768x384) needs only the climatologies resampled.  Bilinear
interpolation on cell centres, periodic in longitude, clamped at the
poles; the glacier mask stays nearest-neighbour (it is 0/1), and
topography keeps the reference's ocean marker (-0.1 m).

NumPy on the host, as in the JAX package, with one difference: a field
that is not floating point is blended as its float32 copy.  The JAX
package casts the weights to the input's dtype, which for an integer
field rounds every weight to 0 or 1 (corner sampling); for float inputs
the two agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .config import Numerics
from .forcing import ClimForcing, forcing_from_arrays

F32 = np.float32


def _centers(n: int, span: float, start: float) -> np.ndarray:
    d = span / n
    return (start + d / 2 + d * np.arange(n)).astype(np.float64)


def _lon_weights(x_src: int, x_dst: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Periodic linear interpolation indices/weights along longitude."""
    src = _centers(x_src, 360.0, 0.0)
    dst = _centers(x_dst, 360.0, 0.0)
    d = 360.0 / x_src
    # position in source-cell units, shifted so src[0] is at 0
    pos = (dst - src[0]) / d
    i0 = np.floor(pos).astype(int)
    w1 = (pos - i0).astype(np.float64)
    j0 = i0 % x_src
    j1 = (i0 + 1) % x_src
    return j0, j1, w1


def _lat_weights(y_src: int, y_dst: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clamped linear interpolation indices/weights along latitude."""
    src = _centers(y_src, 180.0, -90.0)
    dst = _centers(y_dst, 180.0, -90.0)
    i0 = np.searchsorted(src, dst) - 1
    i0 = np.clip(i0, 0, y_src - 2)
    w1 = (dst - src[i0]) / (src[i0 + 1] - src[i0])
    w1 = np.clip(w1, 0.0, 1.0)   # clamp beyond the outermost centres
    return i0, i0 + 1, w1


def regrid_field(a: np.ndarray, x_dst: int, y_dst: int,
                 nearest: bool = False) -> np.ndarray:
    """Bilinear (or nearest) resample of (..., y, x) onto
    (..., y_dst, x_dst), float32."""
    a = np.asarray(a)
    y_src, x_src = a.shape[-2], a.shape[-1]
    if (y_src, x_src) == (y_dst, x_dst):
        return a.astype(F32)
    jx0, jx1, wx = _lon_weights(x_src, x_dst)
    jy0, jy1, wy = _lat_weights(y_src, y_dst)
    if nearest:
        jx = np.where(wx < 0.5, jx0, jx1)
        jy = np.where(wy < 0.5, jy0, jy1)
        return a[..., jy[:, None], jx[None, :]].astype(F32)
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(F32)
    # blend in the source's float dtype: float64 weights would promote the
    # (t, y, x) temporaries of a float32 field to float64
    wy_ = wy.astype(a.dtype)[:, None]
    wx_ = wx.astype(a.dtype)[None, :]
    # ((1 - wy) ((1 - wx) a00 + wx a01) + wy ((1 - wx) a10 + wx a11)): the
    # longitude blend on the source rows first, then its rows jy0 and jy1
    # (the same operations on the same values as blending the four
    # corners, at the source's row count)
    ax = (1 - wx_) * a[..., jx0] + wx_ * a[..., jx1]
    out = ax[..., jy0, :]
    out *= 1 - wy_
    below = ax[..., jy1, :]
    below *= wy_
    out += below
    return out.astype(F32, copy=False)


def coarsen_field(a: np.ndarray, x_dst: int, y_dst: int) -> np.ndarray:
    """Area-weighted box average of (..., y, x) onto a coarser grid whose
    dims divide the source dims (cell-centre grids nest exactly when the
    refinement factor is an integer).  Weights are cos(lat) of the fine
    rows, i.e. spherical cell area: the operator for comparing a
    refined-grid solution with a coarse-grid one."""
    a = np.asarray(a, np.float64)
    y_src, x_src = a.shape[-2], a.shape[-1]
    fy, fx = y_src // y_dst, x_src // x_dst
    if fy * y_dst != y_src or fx * x_dst != x_src:
        raise ValueError(f"{y_src}x{x_src} does not coarsen onto "
                         f"{y_dst}x{x_dst}")
    lat = _centers(y_src, 180.0, -90.0)
    w = np.cos(np.deg2rad(lat)).reshape(y_dst, fy)
    blocks = a.reshape(a.shape[:-2] + (y_dst, fy, x_dst, fx))
    num = (blocks * w[:, :, None, None]).sum(axis=(-3, -1))
    den = w.sum(axis=1)[:, None] * fx
    return (num / den).astype(F32)


def regrid_solar(sw: np.ndarray, y_dst: int) -> np.ndarray:
    """(t, y) insolation: linear in latitude only."""
    sw = np.asarray(sw)
    y_src = sw.shape[-1]
    if y_src == y_dst:
        return sw.astype(F32)
    jy0, jy1, wy = _lat_weights(y_src, y_dst)
    out = (1 - wy) * sw[..., jy0] + wy * sw[..., jy1]
    return out.astype(F32)


def regrid_forcing_arrays(arrs: dict, num: Numerics) -> dict:
    """Resample a raw forcing dict onto num's grid."""
    x, y = num.xdim, num.ydim
    out = {}
    for k, a in arrs.items():
        if k == "sw_solar":
            out[k] = regrid_solar(a, y)
        elif k == "glacier":
            out[k] = regrid_field(a, x, y, nearest=True)
        elif k == "z_topo":
            z = regrid_field(a, x, y)
            # keep the reference's flat-ocean marker: interpolation between
            # land and the -0.1 m ocean otherwise invents shelves
            out[k] = np.where(z < 0.0, F32(-0.1), z).astype(F32)
        else:
            out[k] = regrid_field(a, x, y)
    return out


def regrid_forcing(forcing: ClimForcing, num: Numerics,
                   device=None) -> ClimForcing:
    """``forcing`` resampled onto num's grid, on ``device`` (default: the
    forcing's own)."""
    arrs = {k: getattr(forcing, k).cpu().numpy()
            for k in ClimForcing.__dataclass_fields__}
    if device is None:
        device = forcing.tclim.device
    return forcing_from_arrays(regrid_forcing_arrays(arrs, num), device)
