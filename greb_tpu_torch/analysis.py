"""Output analysis — the Python equivalent of the reference's R layer
(``greb_tpu.analysis``; NumPy on the host).

Mirrors R/functions.R and the two analysis scripts:

- ``read_greb``       : structured reader over the 5-variable monthly output
                        stream (R/functions.R:34-81), returning either raw
                        arrays or tidy (time, lat, lon, value) records.
- ``wrap_lon``        : 0..360 <-> -180..180 conversion (R/functions.R:89-106).
- ``cell_lonlat``     : cell-centre coordinates (R/functions.R:46-51).
- ``global_mean_series`` / ``area_weighted_mean``: warming curves
                        (README.md:26-44; plain mean matches the R scripts,
                        area weighting is the physically-correct extra).
- ``arctic_september_albedo``: the README's Arctic albedo maps
                        (R/analyse_output_fields.R:20-30).
- ``land_sea_mask`` / ``monthly_wind_means``: input-field analyses
                        (R/analyse_input_fields.R:5-44).

Fields may come as numpy arrays or as the port's tensors (a model's
forcing lives on its device): ``_host`` brings either to a host array.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .io.binio import read_output

F32 = np.float32

VARS = ("tsurf", "tair", "tocean", "vapour", "albedo")


def _host(x) -> np.ndarray:
    """A host numpy array of ``x``: a tensor on any device (also one that
    requires grad) is detached and copied to the host; anything else goes
    through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cell_lonlat(nlon: int = 96, nlat: int = 48) -> Tuple[np.ndarray, np.ndarray]:
    """Cell-centre longitudes (0..360) and latitudes (-90..90),
    reproducing R/functions.R:46-51."""
    dlon, dlat = 360.0 / nlon, 180.0 / nlat
    lon = np.arange(dlon / 2, 360.0, dlon, dtype=F32)
    lat = np.arange(-90 + dlat / 2, 90.0, dlat, dtype=F32)
    return lon, lat


def wrap_lon(lon, to: str = "180") -> np.ndarray:
    """Convert longitudes between [0, 360) and [-180, 180)
    (R/functions.R:89-106)."""
    lon = np.asarray(_host(lon), dtype=np.float64)
    if to == "180":
        return ((lon + 180.0) % 360.0) - 180.0
    if to == "360":
        return lon % 360.0
    raise ValueError("to must be '180' or '360'")


def read_greb(path: str, varname: str = "tsurf", nlon: int = 96,
              nlat: int = 48, months: Optional[Sequence[int]] = None,
              tidy: bool = False):
    """Read one variable from a GREB output file.

    Returns (months_index, data (t, nlat, nlon)) or, with ``tidy=True``, a
    dict of flat arrays {time, lon, lat, value} like the R data frame
    (R/functions.R:74-80).  ``months``: 0-based record-month indices.
    """
    ivar = VARS.index(varname)
    all_rec = read_output(path, nlon, nlat)       # (t, 5, nlat, nlon)
    nt = all_rec.shape[0]
    sel = np.arange(nt) if months is None else np.asarray(list(months))
    data = all_rec[sel, ivar]
    if not tidy:
        return sel, data
    lon, lat = cell_lonlat(nlon, nlat)
    LON, LAT = np.meshgrid(lon, lat)
    t = np.repeat(sel, nlat * nlon)
    return dict(time=t, lon=np.tile(LON.ravel(), len(sel)),
                lat=np.tile(LAT.ravel(), len(sel)),
                value=data.reshape(len(sel), -1).ravel())


def area_weights(nlat: int = 48) -> np.ndarray:
    """cos(lat) weights for physically-correct global means."""
    _, lat = cell_lonlat(96, nlat)
    w = np.cos(np.deg2rad(lat))
    return (w / w.sum()).astype(F32)


def area_weighted_mean(field) -> np.ndarray:
    """Mean over the trailing (lat, lon) axes with cos(lat) weights."""
    field = _host(field)
    w = area_weights(field.shape[-2])
    return (field.mean(axis=-1) * w).sum(axis=-1)


def global_mean_series(path: str, varname: str = "tsurf", nlon: int = 96,
                       nlat: int = 48, annual: bool = True,
                       weighted: bool = False, celsius: bool = True):
    """Global-mean time series of an output variable (README.md:37-44).
    ``weighted=False`` reproduces the R plain mean."""
    _, data = read_greb(path, varname, nlon, nlat)
    gm = (area_weighted_mean(data) if weighted
          else data.mean(axis=(-2, -1)))
    if varname in ("tsurf", "tair", "tocean") and celsius:
        gm = gm - 273.15
    if annual:
        nyr = len(gm) // 12
        gm = gm[: nyr * 12].reshape(nyr, 12).mean(axis=1)
    return gm


def arctic_september_albedo(path: str, years: Sequence[int], nlon: int = 96,
                            nlat: int = 48, lat_min: float = 50.0
                            ) -> Dict[int, np.ndarray]:
    """September albedo north of ``lat_min`` for the given 0-based years
    (R/analyse_output_fields.R:8-30)."""
    _, lat = cell_lonlat(nlon, nlat)
    rows = lat >= lat_min
    out = {}
    for y in years:
        _, alb = read_greb(path, "albedo", nlon, nlat, months=[y * 12 + 8])
        out[y] = alb[0][rows]
    return out


def land_sea_mask(z_topo) -> np.ndarray:
    """Boolean land mask from topography (R/analyse_input_fields.R:5-13;
    reference convention: ocean = -0.1 m)."""
    return _host(z_topo) >= 0.0


def monthly_wind_means(uclim, vclim, jday_mon: Sequence[int], ndt_days: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Monthly-mean wind fields from the 730-step climatologies
    (R/analyse_input_fields.R:24-44)."""
    u = _host(uclim)
    v = _host(vclim)
    out_u, out_v, t0 = [], [], 0
    for nd in jday_mon:
        n = nd * ndt_days
        out_u.append(u[t0:t0 + n].mean(axis=0))
        out_v.append(v[t0:t0 + n].mean(axis=0))
        t0 += n
    return np.stack(out_u), np.stack(out_v)
