"""Deterministic synthetic climatology generator.

The reference repo ships only three small static inputs (topography,
solar.radiation, glacier.masks); the seven 13.5 MB climatology blobs are
missing (.MISSING_LARGE_BLOBS). This module generates physically plausible,
annually periodic, fully deterministic (formula-based, no RNG) climatologies
with the same shapes, units and ranges, so the whole framework is testable
and benchmarkable without the original data archive.  Real archives in the
reference binary format load through ``greb_tpu_torch.forcing.load_forcing``.

Field contract (reference src/greb.f90:14-27):
  z_topo   (y,x)    topography [m], <0 = ocean
  glacier  (y,x)    glacier mask (>0.5 = glacier)
  tclim    (t,y,x)  surface temperature climatology [K]
  uclim    (t,y,x)  zonal wind [m/s]
  vclim    (t,y,x)  meridional wind [m/s]
  qclim    (t,y,x)  atmospheric humidity [kg/kg]
  mldclim  (t,y,x)  ocean mixed-layer depth [m]  (>0 everywhere)
  swetclim (t,y,x)  soil wetness [0-1]
  cldclim  (t,y,x)  cloud cover [0-1]
  sw_solar (t,y)    24h-mean insolation [W/m^2]
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

F32 = np.float32


def _grid(xdim: int, ydim: int):
    dlon = 360.0 / xdim
    dlat = 180.0 / ydim
    lon = dlon * np.arange(1, xdim + 1) - dlon / 2.0          # 1.875..358
    lat = dlat * np.arange(1, ydim + 1) - dlat / 2.0 - 90.0   # -88.1..88.1
    return lon.astype(np.float64), lat.astype(np.float64)


def solar_radiation(ydim: int, nstep_yr: int, ndays_yr: int = 365,
                    s0: float = 1365.0) -> np.ndarray:
    """(nstep_yr, ydim) 24h-mean TOA insolation from the standard daily-mean
    formula  S = S0/pi * (h0 sinφ sinδ + cosφ cosδ sin h0)."""
    _, lat = _grid(1, ydim)
    phi = np.deg2rad(lat)[None, :]
    steps_per_day = nstep_yr // ndays_yr
    day = (np.arange(nstep_yr) // steps_per_day)[:, None]  # 0..364
    dec = np.deg2rad(23.44) * -np.cos(2 * np.pi * (day + 10.0) / ndays_yr)
    cos_h0 = np.clip(-np.tan(phi) * np.tan(dec), -1.0, 1.0)
    h0 = np.arccos(cos_h0)
    s = s0 / np.pi * (h0 * np.sin(phi) * np.sin(dec)
                      + np.cos(phi) * np.cos(dec) * np.sin(h0))
    return np.maximum(s, 0.0).astype(F32)


def topography(xdim: int, ydim: int) -> np.ndarray:
    """Idealised continents: smooth bumps on an ocean planet.

    Convention matches the reference input data exactly: ocean points are a
    flat -0.1 m (NOT bathymetry) — the topography weights
    wz = exp(-z_topo/z_scale) must stay <= ~1 or the reference's explicit
    stencils (faithfully reproduced here) go unstable."""
    lon, lat = _grid(xdim, ydim)
    LON, LAT = np.meshgrid(lon, lat)

    def bump(lon0, lat0, slon, slat, h):
        dl = (LON - lon0 + 180.0) % 360.0 - 180.0
        return h * np.exp(-((dl / slon) ** 2 + ((LAT - lat0) / slat) ** 2))

    b = np.zeros((ydim, xdim))
    b += bump(20, 10, 30, 35, 5200.0)     # "Africa/Eurasia" blob
    b += bump(90, 40, 45, 22, 6500.0)     # "Asia" with high interior
    b += bump(280, 45, 28, 25, 5200.0)    # "North America"
    b += bump(300, -20, 18, 25, 4800.0)   # "South America"
    b += bump(135, -25, 18, 14, 4400.0)   # "Australia"
    b += bump(0, -90, 400, 22, 7000.0)    # "Antarctica" (zonal cap)
    z = np.where(b > 4000.0, np.maximum(b - 4000.0, 1.0), -0.1)
    return z.astype(F32)


def glacier_mask(z_topo: np.ndarray) -> np.ndarray:
    ydim, xdim = z_topo.shape
    _, lat = _grid(xdim, ydim)
    g = ((z_topo > 0.0) & (np.abs(lat)[:, None] > 75.0)).astype(F32)
    return g


def make_synthetic_forcing(xdim: int = 96, ydim: int = 48, nstep_yr: int = 730,
                           ndays_yr: int = 365) -> Dict[str, np.ndarray]:
    lon, lat = _grid(xdim, ydim)
    LON, LAT = np.meshgrid(lon, lat)
    t = np.arange(nstep_yr)[:, None, None] / float(nstep_yr)   # 0..1 through year
    season = np.cos(2 * np.pi * (t - 181.0 / 365.0))            # +1 at NH midsummer

    z_topo = topography(xdim, ydim)
    glacier = glacier_mask(z_topo)
    ocean = (z_topo < 0.0)
    land = ~ocean

    # surface temperature: meridional profile + seasonal cycle + lapse rate
    t_eq, t_pole = 300.0, 242.0
    base = t_pole + (t_eq - t_pole) * np.cos(np.deg2rad(LAT)) ** 1.5
    amp = (2.0 + 18.0 * np.abs(np.sin(np.deg2rad(LAT)))) * np.where(land, 1.0, 0.4)
    lapse = np.where(land, -6.5e-3 * np.maximum(z_topo, 0.0), 0.0)
    tclim = base[None] + amp[None] * season * np.sign(LAT)[None] + lapse[None]
    tclim = tclim + 1.5 * np.sin(np.deg2rad(2 * LON))[None]     # small zonal wave
    tclim = np.maximum(tclim, 210.0)

    # humidity: 70% of saturation (Magnus form used by the model), topo-scaled
    tc = tclim - 273.15
    qsat = 3.75e-3 * np.exp(17.08085 * tc / (tc + 234.175))
    qclim = 0.7 * qsat * np.exp(-np.maximum(z_topo, 0.0)[None] / 5000.0)
    qclim = np.clip(qclim, 1e-6, 0.025)

    # winds: easterlies in the tropics, westerly jets in mid-latitudes
    phi = np.deg2rad(LAT)[None]
    uclim = (-6.0 * np.cos(3 * phi) + 8.0 * np.exp(-((np.abs(LAT)[None] - 45.0) / 12.0) ** 2)
             * np.sign(np.cos(phi)))
    uclim = uclim + 1.0 * season * np.sin(phi)
    vclim = 2.0 * np.sin(2 * phi) * np.cos(np.deg2rad(LON))[None] + 0.5 * season

    # mixed-layer depth: deeper in winter hemisphere; positive over land too
    # (the reference applies its deep-ocean mixing unconditionally, so land
    # values must be usable; real data carries fill values there).
    winter = -season * np.sign(LAT)[None]
    mld_ocean = 60.0 + 40.0 * winter + 20.0 * np.abs(np.sin(phi))
    mldclim = np.where(ocean[None], mld_ocean, 50.0)
    mldclim = np.maximum(mldclim, 10.0)

    # soil wetness: ocean 1, land 0.2..0.9 by latitude band
    swet_land = 0.3 + 0.4 * np.cos(np.deg2rad(LAT))[None] ** 2
    swetclim = np.where(ocean[None], 1.0, swet_land) * np.ones_like(tclim)

    # cloud cover
    cldclim = (0.55 + 0.15 * np.sin(phi) ** 2 + 0.05 * season
               + 0.05 * np.cos(np.deg2rad(3 * LON))[None])
    cldclim = np.clip(cldclim, 0.05, 0.95) * np.ones_like(tclim)

    return dict(
        z_topo=z_topo, glacier=glacier,
        tclim=tclim.astype(F32), uclim=uclim.astype(F32),
        vclim=(vclim * np.ones_like(tclim)).astype(F32),
        qclim=qclim.astype(F32), mldclim=mldclim.astype(F32),
        swetclim=swetclim.astype(F32), cldclim=cldclim.astype(F32),
        sw_solar=solar_radiation(ydim, nstep_yr, ndays_yr),
    )


# file names used by the reference input directory (src/greb.f90:1018-1027)
INPUT_FILES = {
    "tclim": "tsurf", "qclim": "vapor", "z_topo": "topography",
    "swetclim": "soil.moisture", "sw_solar": "solar.radiation",
    "uclim": "zonal.wind", "vclim": "meridional.wind",
    "mldclim": "ocean.mld", "cldclim": "cloud.cover", "glacier": "glacier.masks",
}


def write_forcing_dir(forcing: Dict[str, np.ndarray], path: str) -> None:
    """Write a forcing dict as a reference-format input directory."""
    from .binio import write_records
    os.makedirs(path, exist_ok=True)
    for key, fname in INPUT_FILES.items():
        arr = forcing[key]
        full = os.path.join(path, fname)
        if arr.ndim == 2:      # static (y,x) single record
            write_records(full, arr[None])
        elif key == "sw_solar":  # one record of (nstep_yr, ydim)
            write_records(full, arr.reshape(1, *arr.shape))
        else:                  # (t,y,x): one record per step
            write_records(full, arr)
