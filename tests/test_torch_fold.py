"""The port's coefficient-folded circulation against ``greb_tpu.ops``.

* ``make_plan`` and ``build_const`` are float64 NumPy builds: given the
  same wz fields, the plan and every constant plane match exactly.
* ``step_coeffs``, ``substep`` and ``circulation`` (the plain version the
  CUDA year kernels are held against) match ``fastcirc2`` at 96x48 (dense
  pole composites, no explicit segments), at 48x24 with
  dt_crcl=21600 (composites plus an explicit advection segment) and at
  192x96 (dense 192x192 composites at five rows a pole, advection
  segments, additive splitting) and at 256x128 (packed composites at
  three rows a pole, diffusion and advection segments, additive
  splitting); one substep matches at the 384x192
  extension grid (packed composites, segments, sequential zonal
  splitting).  Same
  constants, same state and winds on both sides.  Tolerance, on the
  increment: rtol 1e-5, and atol 1e-6 of the field's magnitude.  The
  increment is (x + dx) - x, so its rounding is a few ulps of x (one ulp of
  Ta at 250 K is 1.5e-5 K), not of dx; the two libraries group the float32
  multiply-adds differently, which moves x + dx by 1-4 ulps.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops import fastcirc as jfc
from greb_tpu.ops import fastcirc2 as jfc2

from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.ops import fastcirc as fc
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops import stencils as stc

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only: the composites then build slower
    threadpool_limits = None

GRIDS = {
    "96x48": dict(),
    "48x24-dt6h": dict(xdim=48, ydim=24, ndays_yr=1, jday_mon=(1,),
                       dt_crcl=6 * 3600),
    "192x96": dict(xdim=192, ydim=96, ndays_yr=1, jday_mon=(1,),
                   dt_crcl=1800),
    "256x128": dict(xdim=256, ydim=128, ndays_yr=1, jday_mon=(1,),
                    dt_crcl=1800),
}


@pytest.fixture(scope="module", params=list(GRIDS), ids=list(GRIDS))
def fold(request):
    num = JNumerics(**GRIDS[request.param])
    jm = JGREB(JConfig(numerics=num, fast_circulation=True), verbose=False)
    wz_air = np.asarray(jm.derived.wz_air)
    wz_vapor = np.asarray(jm.derived.wz_vapor)
    jplan, jconst = jm.fastcirc_tables()
    grid = make_grid(num.xdim, num.ydim, num.dt_crcl,
                     kappa=float(jm.params.kappa), pi=float(jm.params.pi))
    st, _ = stc.make_stencil_arrays(grid)
    plan, const = fc2.build_const(wz_air, wz_vapor, grid, st,
                                  kappa=float(jm.params.kappa), device="cpu")
    return dict(jm=jm, jplan=jplan, jconst=jconst, grid=grid, plan=plan,
                const=const, num=num)


def test_make_plan_matches(fold):
    assert (dataclasses.asdict(fc.make_plan(fold["grid"]))
            == dataclasses.asdict(jfc.make_plan(fold["jm"].grid)))
    assert dataclasses.asdict(fold["plan"]) == dataclasses.asdict(fold["jplan"])


def test_grid_schedules_match(fold):
    g, jg = fold["grid"], fold["jm"].grid
    for k in ("lat", "dxlat", "ccx_diff", "ccx_adv", "polar_rows"):
        np.testing.assert_array_equal(getattr(g, k), getattr(jg, k), err_msg=k)
    for s in ("diff_sched", "adv_sched"):
        for k in ("time2", "dtdff2", "ccx2"):
            np.testing.assert_array_equal(getattr(getattr(g, s), k),
                                          getattr(getattr(jg, s), k))


def test_build_const_exact(fold):
    const, jconst = fold["const"], fold["jconst"]
    for k in ("zd", "zam", "mer", "wz", "band", "pcomp"):
        np.testing.assert_array_equal(getattr(const, k).numpy(),
                                      np.asarray(getattr(jconst, k)),
                                      err_msg=k)


def _inputs(fold, ityr):
    jm = fold["jm"]
    s = jm.initial_state()
    x2 = np.stack([np.asarray(s.ta), np.asarray(s.q)])
    u = np.array(jm.sfx.u[ityr])
    v = np.array(jm.sfx.v[ityr])
    jcf = jfc2.step_coeffs(jnp.asarray(u), jnp.asarray(v), fold["jconst"],
                           fold["jplan"])
    cf = fc2.step_coeffs(torch.as_tensor(u), torch.as_tensor(v),
                         fold["const"], fold["plan"])
    return x2, jcf, cf


def _close_increment(x2, got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    for f in range(want.shape[-3]):
        scale = float(np.abs(x2[f]).max())
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f"{name}[{f}]")


def test_step_coeffs(fold):
    _, jcf, cf = _inputs(fold, 0)
    for k in ("za", "mc", "c0m"):
        np.testing.assert_array_equal(getattr(cf, k).numpy(),
                                      np.asarray(getattr(jcf, k)), err_msg=k)


@pytest.mark.parametrize("ityr", [0, 1])
def test_substep(fold, ityr):
    x2, jcf, cf = _inputs(fold, ityr % fold["num"].nstep_yr)
    want = jfc2.substep(jnp.asarray(x2), jcf, fold["jconst"],
                        fold["jplan"]) - x2
    got = fc2.substep(torch.as_tensor(x2), cf, fold["const"],
                      fold["plan"]) - torch.as_tensor(x2)
    _close_increment(x2, got, want, "substep")


def test_circulation(fold):
    """All nsub substeps.  With packed composites (256x128) their rows,
    whose sums the port takes in the kernels' blocked order and greb_tpu
    as XLA's dot of the packed factors, part by up to ~6 ulps of the field
    a substep (one substep: 1.8e-4 K of ~300 K) and 4.4e-4 K after 24: they
    are held at 2e-6 of the field, every other row at the tolerance
    above."""
    nsub = fold["num"].nsub_crcl
    plan = fold["plan"]
    x2, jcf, cf = _inputs(fold, fold["num"].nstep_yr - 1)
    want = np.array(jfc2.circulation(jnp.asarray(x2), jcf, fold["jconst"],
                                     fold["jplan"], nsub))
    got = fc2.circulation(torch.as_tensor(x2), cf, fold["const"], plan,
                          nsub).numpy().copy()
    if plan.comp_mode == "packed":
        comp = np.r_[np.arange(plan.comp_kt),
                     np.arange(plan.ydim - plan.comp_kb, plan.ydim)]
        for f in range(want.shape[-3]):
            scale = float(np.abs(x2[f]).max())
            np.testing.assert_allclose(
                got[f][comp], want[f][comp], rtol=1e-5, atol=2e-6 * scale,
                err_msg=f"circulation[{f}] composite rows")
        got[..., comp, :] = want[..., comp, :]
    _close_increment(x2, got, want, "circulation")


def test_refined_grid_fold_matches():
    """384x192 is an extension grid: sequential zonal splitting, packed SVD
    composites and explicit diffusion/advection segments.  Plan and
    constants exact (the SVD is the same NumPy call); one substep at the
    tolerance above."""
    num = JNumerics(xdim=384, ydim=192, ndays_yr=2, jday_mon=(2,))
    # the 384x384 composite powers and SVDs on one BLAS thread: under -n 6
    # eight spinning BLAS threads per worker took 50x longer
    with (threadpool_limits(1) if threadpool_limits
          else contextlib.nullcontext()):
        jm = JGREB(JConfig(numerics=num, fast_circulation=True),
                   verbose=False)
        jplan, jconst = jm.fastcirc_tables()
        uabs = np.abs(np.asarray(jm.forcing.uclim))
        grid = make_grid(num.xdim, num.ydim, num.dt_crcl,
                         kappa=float(jm.params.kappa), pi=float(jm.params.pi),
                         max_wind=float(uabs.max()),
                         u_rowmax=uabs.max(axis=(0, 2)))
        plan, const = fc2.build_const(np.asarray(jm.derived.wz_air),
                                      np.asarray(jm.derived.wz_vapor), grid,
                                      stc.make_stencil_arrays(grid)[0],
                                      kappa=float(jm.params.kappa),
                                      device="cpu")
    assert plan.seq_zonal and plan.comp_mode == "packed"
    assert plan.diff_segs and plan.adv_segs
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    for k in ("zd", "zam", "mer", "wz", "band", "pcu", "pcw", "pmask"):
        np.testing.assert_array_equal(getattr(const, k).numpy(),
                                      np.asarray(getattr(jconst, k)),
                                      err_msg=k)
    fold = dict(jm=jm, jplan=jplan, jconst=jconst, plan=plan, const=const)
    x2, jcf, cf = _inputs(fold, 1)
    # one compiled program: op-by-op JAX at this grid costs ~7x more
    jax_substep = jax.jit(lambda x, c, k: jfc2.substep(x, c, k, jplan))
    want = np.asarray(jax_substep(jnp.asarray(x2), jcf, jconst)) - x2
    got = fc2.substep(torch.as_tensor(x2), cf, const, plan) - torch.as_tensor(x2)
    _close_increment(x2, got, want, "substep")
