"""Figure layer — the Python equivalent of the reference's R plots
(``greb_tpu.plots``).

Mirrors the figures reproduced in the reference README (README.md:26-56)
and the two R analysis scripts:

- ``warming_curve``          : global-mean Tsurf time series under the CO2
                               scenario (README.md:33-44).
- ``albedo_map``             : September Arctic albedo maps, early vs late
                               scenario (R/analyse_output_fields.R:8-30).
- ``anomaly_map``            : Tsurf change map (diverging, not in R but the
                               canonical 2xCO2 figure).
- ``land_sea_mask_plot`` /
  ``wind_quiver``            : input-field analyses
                               (R/analyse_input_fields.R:5-44).

Encoding rules: magnitude fields use one perceptually-uniform sequential
colormap (``cividis``, CVD-designed); signed change uses a diverging map
with a neutral midpoint (``RdBu_r``); single-series lines carry no legend
(the title names them) and grids stay recessive.  All functions return the
matplotlib Figure so callers can save or embed; none call ``show()``.

matplotlib is imported on first use (``_mpl``), so importing the package
does not load it.  Fields may be numpy arrays or the port's tensors on any
device (a run's diagnostics and a model's forcing live on its device):
every array goes through ``analysis._host``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .analysis import _host, cell_lonlat

_SEQ = "cividis"      # sequential: one perceptually-uniform ramp, CVD-safe
_DIV = "RdBu_r"       # diverging: two hues + neutral midpoint
_INK = "#1f2430"      # primary ink for the single-series line
_GRID = "#d5d9e0"     # recessive grid


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _style_axes(ax):
    ax.grid(True, color=_GRID, linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def warming_curve(global_mean_ts: Sequence[float],
                  years: Optional[Sequence[int]] = None,
                  co2_ppm: Optional[float] = None):
    """Annual global-mean Tsurf [degC] under the scenario
    (reference README.md:33-44; data from YearDiag.global_mean_ts)."""
    plt = _mpl()
    ts = np.asarray(_host(global_mean_ts), np.float64)
    ts = np.where(ts > 150.0, ts - 273.15, ts)  # accept K or degC
    x = _host(years) if years is not None else np.arange(1, len(ts) + 1)
    fig, ax = plt.subplots(figsize=(7, 3.4), dpi=120)
    ax.plot(x, ts, color=_INK, linewidth=2.0, zorder=3)
    ax.set_xlabel("scenario year" if years is None else "year")
    ax.set_ylabel("global-mean Tsurf [°C]")
    title = "Global-mean surface temperature"
    if co2_ppm is not None:
        title += f" (CO₂ = {co2_ppm:.0f} ppm)"
    ax.set_title(title, loc="left")
    _style_axes(ax)
    fig.tight_layout()
    return fig


def _map_axes(ax, lon, lat, field, cmap, vmin=None, vmax=None):
    im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax,
                       shading="auto")
    ax.set_xlabel("longitude [°E]")
    ax.set_ylabel("latitude [°N]")
    return im


def add_coastline(ax, z_topo: np.ndarray, color: str = "#333333",
                  linewidth: float = 0.7):
    """Coastline overlay for the map figures (the reference caches a
    Natural Earth coastline for this, R/functions.R:113-118
    ``save_ne_coast``).  No external datasets exist in this environment,
    so the coastline is the z_topo >= 0 land-sea boundary of the model's
    OWN topography — the contour the model physics actually sees, drawn
    at the grid's resolution."""
    z = _host(z_topo)
    lon, lat = cell_lonlat(z.shape[1], z.shape[0])
    ax.contour(lon, lat, (z >= 0).astype(float), levels=[0.5],
               colors=color, linewidths=linewidth, zorder=4)


def albedo_map(albedo: np.ndarray, title: str = "September albedo",
               arctic_only: bool = True, nlon: int = None, nlat: int = None,
               z_topo: np.ndarray = None):
    """Albedo map, optionally restricted to the Arctic (lat >= 60 N) like
    R/analyse_output_fields.R:20-30.  ``albedo``: (lat, lon) with lat
    ordered south->north (model layout)."""
    plt = _mpl()
    albedo = _host(albedo)
    nlat_, nlon_ = albedo.shape
    lon, lat = cell_lonlat(nlon or nlon_, nlat or nlat_)
    fig, ax = plt.subplots(figsize=(7, 3.6), dpi=120)
    if arctic_only:
        sel = lat >= 60.0
        im = _map_axes(ax, lon, lat[sel], albedo[sel], _SEQ, 0.0, 1.0)
    else:
        im = _map_axes(ax, lon, lat, albedo, _SEQ, 0.0, 1.0)
    if z_topo is not None:
        add_coastline(ax, z_topo)
        if arctic_only:
            ax.set_ylim(60.0, lat.max())
    fig.colorbar(im, ax=ax, label="albedo")
    ax.set_title(title, loc="left")
    fig.tight_layout()
    return fig


def anomaly_map(delta: np.ndarray, title: str = "ΔTsurf [K]",
                unit: str = "K", z_topo: np.ndarray = None):
    """Signed change map (e.g. late-minus-early Tsurf): diverging colormap
    with the neutral midpoint pinned at zero."""
    plt = _mpl()
    delta = _host(delta)
    lon, lat = cell_lonlat(delta.shape[1], delta.shape[0])
    lim = float(np.nanmax(np.abs(delta))) or 1.0
    fig, ax = plt.subplots(figsize=(7, 3.6), dpi=120)
    im = _map_axes(ax, lon, lat, delta, _DIV, -lim, lim)
    if z_topo is not None:
        add_coastline(ax, z_topo)
    fig.colorbar(im, ax=ax, label=unit)
    ax.set_title(title, loc="left")
    fig.tight_layout()
    return fig


def land_sea_mask_plot(z_topo: np.ndarray):
    """Land/sea mask from topography (R/analyse_input_fields.R:5-14)."""
    plt = _mpl()
    z = _host(z_topo)
    lon, lat = cell_lonlat(z.shape[1], z.shape[0])
    fig, ax = plt.subplots(figsize=(7, 3.6), dpi=120)
    im = _map_axes(ax, lon, lat, (z >= 0).astype(float), "Greys", 0.0, 1.3)
    ax.set_title("Land–sea mask (z_topo ≥ 0)", loc="left")
    fig.tight_layout()
    return fig


def wind_quiver(u: np.ndarray, v: np.ndarray, stride: int = 3,
                title: str = "Wind field"):
    """Quiver plot of one forcing step's winds
    (R/analyse_input_fields.R:16-44)."""
    plt = _mpl()
    u = _host(u)
    v = _host(v)
    lon, lat = cell_lonlat(u.shape[1], u.shape[0])
    LO, LA = np.meshgrid(lon[::stride], lat[::stride])
    fig, ax = plt.subplots(figsize=(7, 3.6), dpi=120)
    ax.quiver(LO, LA, u[::stride, ::stride], v[::stride, ::stride],
              color=_INK, width=0.0016)
    ax.set_xlabel("longitude [°E]")
    ax.set_ylabel("latitude [°N]")
    ax.set_title(title, loc="left")
    _style_axes(ax)
    fig.tight_layout()
    return fig


def save_all(prefix: str, monthly: np.ndarray,
             diags: Optional[Sequence] = None,
             forcing=None) -> list:
    """Render the reference README's figure set from a scenario run.

    monthly: (years, 12, 5, lat, lon) as returned by GREB.run_scenario.
    Writes <prefix>_<name>.png files; returns the paths."""
    monthly = _host(monthly)
    paths = []

    def _save(fig, name):
        p = f"{prefix}_{name}.png"
        fig.savefig(p)
        _mpl().close(fig)
        paths.append(p)

    if diags:
        gm = [float(_host(d.global_mean_ts)) for d in diags]
        _save(warming_curve(gm), "warming")
    years = monthly.shape[0]
    zt = _host(forcing.z_topo) if forcing is not None else None
    _save(albedo_map(monthly[0, 8, 4], "September albedo, year 1",
                     z_topo=zt), "albedo_y1")
    _save(albedo_map(monthly[-1, 8, 4], f"September albedo, year {years}",
                     z_topo=zt), "albedo_yN")
    _save(anomaly_map(monthly[-1, :, 0].mean(0) - monthly[0, :, 0].mean(0),
                      "ΔTsurf, last minus first year [K]", z_topo=zt),
          "dtsurf")
    if forcing is not None:
        _save(land_sea_mask_plot(zt), "mask")
        _save(wind_quiver(_host(forcing.uclim[0]),
                          _host(forcing.vclim[0]),
                          title="Wind field, step 0"), "wind")
    return paths
