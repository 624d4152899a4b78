"""The plain versions of the CUDA year kernels against the JAX package's
year runners on the same forcing.

* Against the Pallas year kernels (``build_fluxcorr_year`` /
  ``build_scenario_year``, interpret mode, the folded circulation): the
  tiny calendar of tests/test_pallas.py:19 (one day, 2 steps, 2 substeps)
  and that file's tolerances.  Its plan has dense composites and an
  explicit advection segment.
* Against the XLA year runners on a 10-day calendar at 48x24 (tiny
  calendars are unstable in the scenario phase): both phases and the
  monthly means, tolerances stated per check.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import Corrections as JCorrections
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops.pallas import year_kernel as jyk

from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.forcing import Corrections
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import year_kernel as yk

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

PALLAS_NUM = dict(xdim=48, ydim=24, ndays_yr=1, jday_mon=(1,),
                  dt_crcl=6 * 3600, time_flux=1, time_scnr=1)
TEN_DAY = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
               time_scnr=1)


def _pair(kw):
    jm = JGREB(JConfig(numerics=JNumerics(**kw), fast_circulation=True),
               verbose=False)
    leaves = {k: np.asarray(getattr(jm.forcing, k))
              for k in jm.forcing.__dataclass_fields__}
    m = GREB(GrebConfig(numerics=Numerics(**kw), fast_circulation=True),
             forcing=forcing_from_numpy(leaves, "cpu"), verbose=False,
             device="cpu")
    return jm, m


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def pallas_pair():
    return _pair(PALLAS_NUM)


@pytest.fixture(scope="module")
def ten_day_pair():
    return _pair(TEN_DAY)


def test_fluxcorr_plain_matches_pallas_kernel(pallas_pair):
    jm, m = pallas_pair
    num = jm.num
    run = jyk.build_fluxcorr_year(jm.md, jm.st, jm._sf_np, num, jm.exp,
                                  interpret=True,
                                  fastcirc=jm.fastcirc_tables())
    fpack, sw = jyk.pack_forcing(jm.sfx)
    cpack = jyk.pack_const(jm.md)
    co2 = 340.0
    sp, corrpack = run(jm.initial_state(), fpack, sw, cpack,
                       jnp.float32(co2), *jm._pallas_fast_args())
    s, corr = yk.fluxcorr_year_plain(m.initial_state(), co2, m.year_data)

    np.testing.assert_allclose(_np(s.ts), _np(sp.ts), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(_np(corr.tf), _np(corrpack[:, 0]),
                               rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(_np(corr.qf), _np(corrpack[:, 2]),
                               rtol=2e-5, atol=1e-7)


def test_scenario_plain_matches_pallas_kernel(pallas_pair):
    jm, m = pallas_pair
    num = jm.num
    run = jyk.build_scenario_year(jm.md, jm.st, jm._sf_np, num, jm.exp,
                                  interpret=True,
                                  fastcirc=jm.fastcirc_tables())
    fpack, sw = jyk.pack_forcing(jm.sfx)
    cpack = jyk.pack_const(jm.md)
    jc = JCorrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    corrpack = jnp.stack([jc.tf, jc.tof, jc.qf], axis=1)
    co2 = 680.0
    sp, outs_p, asum_p = run(jm.initial_state(), fpack, sw, cpack, corrpack,
                             jnp.float32(co2), *jm._pallas_fast_args())
    corr = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    s, outs, asum = yk.scenario_year_plain(m.initial_state(), corr, co2,
                                           m.year_data)

    for name in ("ts", "ta", "to", "q", "cap_surf"):
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   _np(getattr(sp, name)), rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    mon = core.monthly_means(m.month_mat, outs)
    mon_p = jnp.einsum("mt,tvyx->mvyx", jm.month_mat, outs_p[:, :5])
    np.testing.assert_allclose(_np(mon), _np(mon_p), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(_np(asum), _np(asum_p), rtol=1e-4, atol=1e-2)


def test_year_runners_match_xla_on_ten_day_calendar(ten_day_pair):
    """Spin-up year then scenario year through the XLA runners and the
    port's plain runners.  Tolerances: the state at rtol 1e-5 / atol 1e-3
    K (temperatures) and 3e-6 (q, the golden year's bound,
    tests/test_golden_year.py:29: a cell or so per year lands on the other
    side of a clamp); the correction tables at atol 0.5 W/m^2 (tf, whose
    scale here is ~1e3) and 1e-8 (qf); cap_surf at rtol 1e-3 (on the
    sea-ice ramp it moves ~5e7 J/K/m^2 per K of Ts, so Ts agreeing to 1e-4 K
    is 5e3 in cap_surf); monthly means as the state.  The
    10-day calendar's steps jump half a season between steps, which
    amplifies float32 grouping differences."""
    jm, m = ten_day_pair
    _, fcdata = jm._fastcirc_split()
    js, jcorr = jm._year_fluxcorr()(jm.initial_state(), jm.sfx,
                                    jnp.float32(298.0), jm.md, fcdata)
    s, corr = yk.fluxcorr_year_plain(m.initial_state(), 298.0, m.year_data)
    tol = dict(ts=(1e-5, 1e-3), ta=(1e-5, 1e-3), to=(1e-5, 1e-3),
               q=(1e-5, 3e-6), cap_surf=(1e-3, 0.0))
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   _np(getattr(js, name)), rtol=rtol,
                                   atol=atol, err_msg=f"fc {name}")
    np.testing.assert_allclose(_np(corr.tf), _np(jcorr.tf), rtol=1e-5,
                               atol=0.5)
    np.testing.assert_allclose(_np(corr.qf), _np(jcorr.qf), rtol=1e-5,
                               atol=1e-8)

    js2, jmon, jmean = jm._year_scenario(True)(js, jm.sfx, jcorr,
                                               jnp.float32(680.0), jm.md,
                                               fcdata)
    s2, outs, asum = yk.scenario_year_plain(s, corr, 680.0, m.year_data)
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(_np(getattr(s2, name)),
                                   _np(getattr(js2, name)), rtol=rtol,
                                   atol=atol, err_msg=f"scnr {name}")
    mon = _np(core.monthly_means(m.month_mat, outs))
    for v, name in enumerate(("ts", "ta", "to", "q")):
        np.testing.assert_allclose(mon[:, v], _np(jmon)[:, v],
                                   rtol=tol[name][0], atol=tol[name][1],
                                   err_msg=f"monthly {name}")
    mean = core.annual_means(asum, m.num)
    np.testing.assert_allclose(_np(mean.ts), _np(jmean.ts), rtol=1e-5,
                               atol=1e-3)
