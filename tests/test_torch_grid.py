"""The port's grid.py across grids: counterparts of
tests/test_extension_stability.py and tests/test_xgrid_consistency.py.

* ``make_grid`` gives greb_tpu's metrics and sub-cycle schedules exactly
  at every grid either package runs (96x48, 48x24 at dt_crcl 21600,
  192x96, 384x192, 768x384 at dt_crcl 450 and 600, and 384x192 with a
  wind-aware jet), and ``joint_symbol_max`` greb_tpu's value.
* The extension-mode stability criteria, computed with the port's
  functions as tests/test_extension_stability.py computes them with
  greb_tpu's: the sequential joint symbol contracts at 384x192 and
  768x384 (design winds and a jet), the additive one does not at
  384x192's deepest row, and make_grid refuses what amplifies.
* Cross-grid climate (tests/test_xgrid_consistency.py): the port at
  192x96, coarse-averaged to 96x48, reproduces its 96x48 climate (the last
  of 2 scenario years at 680 ppm after a spin-up, on a 20-step calendar,
  both from the 96x48 synthetic forcing, regridded for 192x96) within
  that file's bounds: global mean Ts 0.1 K, pattern RMS 1.2 K outside the
  sea-ice zone and 5.0 K inside it (measured here: 0.038, 0.74, 3.99);
  and ``coarsen_field``'s properties.
"""
import numpy as np
import pytest
import torch

from greb_tpu.grid import joint_symbol_max as j_joint_symbol_max
from greb_tpu.grid import make_grid as j_make_grid

from greb_tpu_torch.config import Diagnostics, GrebConfig, Numerics
from greb_tpu_torch.forcing import ModelState, forcing_from_arrays
from greb_tpu_torch.grid import joint_symbol_max, make_grid
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.regrid import coarsen_field, regrid_forcing_arrays

torch.set_num_threads(1)

F32 = np.float32
TX = np.linspace(0.0, np.pi, 513)

_JET = np.full(192, 8.0)
_JET[60:130] = 18.0
# (xdim, ydim, dt_crcl, make_grid keywords)
GRIDS = {
    "96x48": (96, 48, 1800, {}),
    "48x24-dt6h": (48, 24, 21600, {}),
    "192x96": (192, 96, 1800, {}),
    "384x192": (384, 192, 1800, {}),
    "384x192-jet": (384, 192, 1800, dict(max_wind=18.0, u_rowmax=_JET)),
    "768x384-dt450": (768, 384, 450, {}),
    "768x384-dt600": (768, 384, 600, {}),
}


@pytest.mark.parametrize("key", list(GRIDS))
def test_make_grid_matches_greb_tpu(key):
    xd, yd, dt, kw = GRIDS[key]
    g, jg = make_grid(xd, yd, dt, **kw), j_make_grid(xd, yd, dt, **kw)
    for name in ("xdim", "ydim", "dlon", "dlat", "dt_crcl", "dyy",
                 "ccy_diff", "ccy_adv", "extension_mode"):
        assert getattr(g, name) == getattr(jg, name), name
    for name in ("lat", "dxlat", "ccx_diff", "ccx_adv", "polar_rows"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name),
                                      err_msg=name)
    for sched in ("diff_sched", "adv_sched"):
        s, js = getattr(g, sched), getattr(jg, sched)
        assert s.max_iter == js.max_iter, sched
        for name in ("time2", "dtdff2", "ccx2"):
            np.testing.assert_array_equal(getattr(s, name), getattr(js, name),
                                          err_msg=f"{sched}.{name}")


def test_joint_symbol_max_matches_greb_tpu():
    rng = np.random.default_rng(11)
    for _ in range(20):
        cz, ca = rng.uniform(0.01, 0.2, 2)
        nd, na = rng.integers(1, 200), rng.integers(1, 30)
        u, ccy, cav = rng.uniform(1, 18), rng.uniform(0, 0.1), \
            rng.uniform(0, 0.1)
        args = (float(cz), int(nd), float(ca), int(na), float(u), float(ccy),
                float(cav))
        assert joint_symbol_max(*args) == j_joint_symbol_max(*args)


def _ga(tx):
    e = lambda s: np.exp(-1j * s * tx)
    return (e(3) + 3.0 * e(2) + 6.0 * e(1) - 10.0) / 20.0


def _gz(tx):
    return (6.0 * np.cos(tx) + 4.0 * np.cos(2 * tx) + 2.0 * np.cos(3 * tx)
            - 12.0) / 20.0


def _rows_max(g, u_row, v_bound=15.0):
    """Worst per-row sequential joint symbol of a built grid."""
    cav = float(g.dt_crcl) / g.dyy / 2.0 * v_bound
    worst = 0.0
    for k in np.nonzero(np.asarray(g.polar_rows))[0]:
        worst = max(worst, joint_symbol_max(
            float(g.diff_sched.ccx2[k]), int(g.diff_sched.time2[k]),
            float(g.adv_sched.ccx2[k]), int(g.adv_sched.time2[k]),
            float(u_row[k]), float(g.ccy_diff), cav))
    return worst


@pytest.mark.parametrize("key", ("384x192", "384x192-jet", "768x384-dt450",
                                 "768x384-dt600"))
def test_sequential_symbol_contracts(key):
    xd, yd, dt, kw = GRIDS[key]
    g = make_grid(xd, yd, dt, **kw)
    assert g.extension_mode
    u_row = kw.get("u_rowmax", np.full(yd, 13.0))
    if "u_rowmax" in kw:
        # per-iteration Courant number 2*ccx2*u bounded by 0.8 at each
        # row's own wind
        ca, pol = np.asarray(g.adv_sched.ccx2, np.float64), g.polar_rows
        assert (2.0 * ca[pol] * u_row[pol] <= 0.8 + 1e-6).all()
    m = _rows_max(g, u_row)
    assert m <= 1.0 + 1e-6, f"max |lambda| = {m}"


def test_additive_model_amplifies_where_sequential_contracts():
    g = make_grid(384, 192, 1800)
    cz, nd = float(g.diff_sched.ccx2[0]), int(g.diff_sched.time2[0])
    ca, na = float(g.adv_sched.ccx2[0]), int(g.adv_sched.time2[0])
    assert nd > 1000 and na > 10
    dz = (1.0 + cz * _gz(TX)) ** nd - 1.0
    da = (1.0 + ca * 10.0 * _ga(TX)) ** na - 1.0
    additive = np.abs(1.0 + dz + da - 4.0 * float(g.ccy_diff)).max()
    assert additive > 1.5, additive
    seq = joint_symbol_max(cz, nd, ca, na, 10.0, float(g.ccy_diff), 0.05)
    assert seq <= 1.0 + 1e-6, seq
    assert np.abs(da).max() > 1.2


@pytest.mark.parametrize("xd, yd, dt", ((768, 384, 1800), (768, 384, 900),
                                        (384, 192, 2600)))
def test_make_grid_refuses_past_budget(xd, yd, dt):
    with pytest.raises(ValueError, match="dt_crcl"):
        make_grid(xd, yd, dt)


def test_192x96_is_inside_the_reference_envelope():
    """192x96 keeps the reference's schedule rules (no extension cap), with
    every row sub-cycled and ~129 diffusion iterations at the poles."""
    g = make_grid(192, 96, 1800)
    assert not g.extension_mode and g.polar_rows.all()
    assert int(g.diff_sched.time2.max()) == 129


NDAYS, JDAY, YEARS = 10, (6, 4), 2


def _annual_ts(xd, yd):
    """The last scenario year's annual-mean Ts at 680 ppm after a
    flux-corrected spin-up, from the initial state with the spin-up's
    cap_surf (greb_tpu's run_scenario(cap_surf=...)); and the model."""
    num = Numerics(xdim=xd, ydim=yd, ndays_yr=NDAYS, jday_mon=JDAY,
                   time_flux=1, time_scnr=YEARS)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True,
                        diagnostics=Diagnostics(console=False)),
             forcing=forcing_from_arrays(regrid_forcing_arrays(arrs, num),
                                         "cpu"),
             verbose=False, device="cpu")
    st, corr = m.flux_correction()
    s0 = m.initial_state()
    start = ModelState(ts=s0.ts, ta=s0.ta, to=s0.to, q=s0.q,
                       cap_surf=st.cap_surf)
    _, monthly, _ = m.run_scenario(corr, state=start, years=YEARS,
                                   co2_series=np.full(YEARS, 680.0, F32))
    w = np.asarray(JDAY, np.float64)
    w /= w.sum()
    return (np.asarray(monthly)[-1, :, 0] * w[:, None, None]).sum(axis=0), m


def test_192x96_same_climate_as_96x48():
    ts_c, m_c = _annual_ts(96, 48)
    ts_f, _ = _annual_ts(192, 96)
    d = coarsen_field(ts_f, 96, 48) - ts_c
    lat = -90.0 + 180.0 / 48 * (np.arange(48) + 0.5)
    aw = np.cos(np.deg2rad(lat))[:, None] * np.ones((48, 96))
    aw /= aw.sum()
    gm = float((d * aw).sum())
    assert abs(gm) <= 0.1, f"global-mean Ts differs by {gm:+.3f} K"
    tclim_ann = m_c.forcing.tclim.numpy().mean(axis=0)
    ocean = m_c.forcing.z_topo.numpy() <= 0
    ice_zone = ocean & (tclim_ann > 250.0) & (tclim_ann < 278.0)
    w_out = aw * ~ice_zone
    rms_out = float(np.sqrt((d * d * w_out).sum() / w_out.sum()))
    assert rms_out <= 1.2, f"non-ice-zone Ts pattern RMS {rms_out:.3f} K"
    w_ice = aw * ice_zone
    rms_ice = float(np.sqrt((d * d * w_ice).sum() / w_ice.sum()))
    assert rms_ice <= 5.0, f"ice-zone Ts pattern RMS {rms_ice:.3f} K"


def test_coarsen_field_properties():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((192, 384)).astype(F32)
    out = coarsen_field(a, 96, 48)
    assert out.shape == (48, 96)
    np.testing.assert_allclose(coarsen_field(np.full((192, 384), 2.5, F32),
                                             96, 48), 2.5, rtol=1e-6)

    def gmean(f):
        la = -90.0 + 180.0 / f.shape[0] * (np.arange(f.shape[0]) + 0.5)
        w = np.cos(np.deg2rad(la))[:, None] * np.ones_like(f)
        return float((f * w / w.sum()).sum())

    assert abs(gmean(out) - gmean(a)) < 1e-6
    np.testing.assert_array_equal(coarsen_field(a, 384, 192), a)
