"""Refined grids: the port's K1/K2 at 384x192 (an extension-mode plan)
against ``greb_tpu``, the refined layout, the refusals and the long-run
route.

* K1 and K2 through the port's wrappers on CPU tensors (their plain
  versions, which the refined CUDA instantiation is held to bit for bit on
  the card) against the JAX package's XLA years (``GREB._year_fluxcorr``,
  ``GREB._year_scenario(True)``, as tests/test_pallas_refined.py:94 calls
  them) on the 4-step calendar of that file, from forcing regridded from
  the 96x48 synthetic forcing: K1 from the initial state at 340 ppm; K2
  from the initial state with zero corrections at 680 ppm (on this calendar
  a scenario year from the spin-up's end state with its corrections is not
  finite in either package).  Tolerances: the golden ones for the state
  (tests/test_golden_year.py:29: temperatures 2e-2 K, q 3e-6); cap_surf at
  rtol 1e-3 (on the sea-ice ramp it moves ~5e7 J/K/m^2 per K of Ts); the
  correction tables at the differences measured here, ~10x under each
  bound: tf 0.5 W/m^2 (scale ~1e3), tof 1e-5 K, qf 1e-6.  Every compared
  array is checked finite too (assert_allclose counts NaN equal to NaN).
* ``refined_layout`` and the wrappers' and driver's refusals, which need no
  card.
* ``year_work`` at 96x48 (unchanged) and at 384x192 (packed composites at
  their ranks, the segments), each reckoned by hand.
* The long-run route at 384x192: ``run_long`` with ``driver_year_runner``
  (one year a K2 call) writes the per-year path's year; a member-kernel
  block (``years_per_call=2``) raises.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import Corrections as JCorrections
from greb_tpu.forcing import forcing_from_arrays as jforcing_from_arrays
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.regrid import regrid_forcing_arrays as jregrid_forcing_arrays

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections, forcing_from_arrays
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core, longrun
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.regrid import regrid_forcing_arrays

torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only: the composites then build slower
    threadpool_limits = None

# tests/test_pallas_refined.py:37: 4 steps x 24 substeps reach every
# schedule branch of the extension-mode fold
GRID = dict(xdim=384, ydim=192, dt_crcl=1800, ndays_yr=2, jday_mon=(2,),
            time_flux=1, time_scnr=1)
TOL = dict(ts=(0, 2e-2), ta=(0, 2e-2), to=(0, 2e-2), q=(0, 3e-6),
           cap_surf=(1e-3, 0))
TOL_CORR = dict(tf=0.5, tof=1e-5, qf=1e-6)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol, atol, name):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), f"{name}: port not finite"
    assert np.isfinite(want).all(), f"{name}: greb_tpu not finite"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _limits():
    # the 384x384 composite powers and SVDs on one BLAS thread (under -n 6
    # spinning BLAS threads made them 50x slower)
    return threadpool_limits(1) if threadpool_limits \
        else contextlib.nullcontext()


@pytest.fixture(scope="module")
def pair():
    arrs = make_synthetic_forcing(96, 48, 4, GRID["ndays_yr"])
    num, jnum = Numerics(**GRID), JNumerics(**GRID)
    with _limits():
        jm = JGREB(JConfig(numerics=jnum, fast_circulation=True),
                   forcing=jforcing_from_arrays(
                       jregrid_forcing_arrays(arrs, jnum)), verbose=False)
        m = GREB(GrebConfig(numerics=num),
                 forcing=forcing_from_arrays(regrid_forcing_arrays(arrs, num),
                                             "cpu"),
                 verbose=False, device="cpu")
    return jm, m


@pytest.fixture(scope="module")
def k2_port(pair):
    """The port's K2 year from the initial state with zero corrections at
    680 ppm: (state, outs, annual sums)."""
    _, m = pair
    num = m.num
    zero = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    return yk.scenario_year(m.initial_state(), zero, 680.0, m.year_data)


def test_refined_plan_is_an_extension_mode_fold(pair):
    jm, m = pair
    plan = m.fold[0]
    assert plan.seq_zonal and plan.comp_mode == "packed"
    assert plan.diff_segs and plan.adv_segs
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jm.fastcirc_tables()[0])
    assert yk.is_refined(plan) and m.year_data.flags == 0
    yk.check_supported(plan, yk.REFINED_KINDS)


def test_k1_refined_matches_xla(pair):
    jm, m = pair
    _, fcdata = jm._fastcirc_split()
    js, jcorr = jm._year_fluxcorr()(jm.initial_state(), jm.sfx,
                                    jnp.float32(340.0), jm.md, fcdata)
    s, corr = yk.fluxcorr_year(m.initial_state(), 340.0, m.year_data)
    for name, (rtol, atol) in TOL.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K1 {name}")
    for name, atol in TOL_CORR.items():
        _close(getattr(corr, name), getattr(jcorr, name), 0, atol,
               f"K1 {name}")


def test_k2_refined_matches_xla(pair, k2_port):
    jm, m = pair
    num = jm.num
    _, fcdata = jm._fastcirc_split()
    jzero = JCorrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    js, jmon, _ = jm._year_scenario(True)(jm.initial_state(), jm.sfx, jzero,
                                          jnp.float32(680.0), jm.md, fcdata)
    s, outs, asum = k2_port
    for name, (rtol, atol) in TOL.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K2 {name}")
    mon = core.monthly_means(m.month_mat, outs)
    for v, name in enumerate(("ts", "ta", "to", "q")):
        _close(mon[:, v], np.asarray(jmon)[:, v], 0, TOL[name][1],
               f"K2 monthly {name}")
    assert np.isfinite(_np(asum)).all()
    # the annual sums are the per-step outputs' sums
    _close(asum[:5], outs.sum(0), 1e-5, 0, "K2 annual sums")


def test_refined_layout_fits_16_blocks(pair):
    plan = pair[1].fold[0]
    for kind in yk.REFINED_KINDS:
        lay = yk.refined_layout(plan, 16, kind)
        # 12 rows of 384 columns a block; the (Ta, q) double buffer with its
        # halo rows, wz, xa; the scratch for the 9 rows of a diffusion
        # segment in blocks 1 and 14 (two buffers), the 7 composite rows'
        # t1 and z (blocks 0, 15) and 2 advection rows (blocks 0, 15)
        assert (lay.rows, lay.comp_rows, lay.threads) == (12, 7, 1024)
        assert dict(lay.parts) == dict(
            transported=4 * 2 * 2 * 16 * 384, wz=4 * 2 * 12 * 384,
            xa=4 * 2 * 12 * 384, scratch=4 * 2 * 2 * 9 * 384,
            comp_index=4 * 16)
        assert lay.nbytes == 227392 <= yk.MAX_SMEM_BYTES
    assert yk.block_layout(plan, 16, "scenario") == \
        yk.refined_layout(plan, 16, "scenario")
    assert yk.offered_sizes("scenario", plan) == yk.REFINED_CLUSTER_SIZES


@pytest.mark.parametrize("blocks", (8, 12))
def test_refined_layout_refuses_smaller_clusters(pair, blocks):
    plan = pair[1].fold[0]
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.refined_layout(plan, blocks, "fluxcorr")
    m = pair[1]
    state = m.initial_state()
    with pytest.raises(ValueError, match=r"clusters of \(16,\)"):
        yk.fluxcorr_year(state, 340.0, m.year_data, cluster=blocks)


def test_refined_layout_refuses_768x384_and_dense_plans(pair):
    plan = pair[1].fold[0]
    # 768x384 at dt_crcl=450: 24 rows a block, the double buffer alone
    # 2*2*28*768*4 = 344,064 B
    wide = dataclasses.replace(plan, ydim=384, xdim=768)
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.refined_layout(wide, 16, "scenario")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3d"):
        yk.check_supported(wide, yk.REFINED_KINDS)
    # 192x96: dense composites (comp_kt=5, 192x192 matrices)
    dense = dataclasses.replace(plan, ydim=96, xdim=192, comp_mode="dense",
                                comp_kt=5, comp_kb=5)
    with pytest.raises(ValueError, match="packed"):
        yk.refined_layout(dense, 16, "scenario")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3e"):
        yk.check_plan(dense, "scenario")
    with pytest.raises(ValueError, match="refined instantiation runs"):
        yk.refined_layout(plan, 16, "scenario_years")


@pytest.mark.parametrize("kind", ("fluxcorr", "scenario"))
def test_refined_plan_refuses_legacy_and_strict_words(pair, kind):
    plan = pair[1].fold[0]
    flags = yk.experiment_flags(Experiment(11))
    assert flags
    with pytest.raises(NotImplementedError, match="Queue 1 item 3f"):
        yk.check_plan(plan, kind, flags)
    strict = yk.StrictPlan(192, 384, seq_zonal=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3f"):
        yk.check_plan(strict, kind, yk.experiment_flags(Experiment(), True))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3f"):
        yk.check_supported(plan, (kind,), flags)


def test_member_kernels_refuse_a_refined_plan(pair):
    """K3/K4 raise at an extension-mode plan, on CPU tensors too, and
    check_supported for the member kinds; so do the driver's member paths,
    before any launch."""
    m = pair[1]
    plan, yd, num = m.fold[0], m.year_data, m.num
    for kind in ("scenario_years",):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
            yk.check_plan(plan, kind)
        with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
            yk.check_supported(plan, (kind,))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        yk.check_supported(plan)     # every kind, K3 among them
    s5 = m.initial_state().stack()[:, None]
    pp = my.pack_member_params([m.params])
    cp = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        my.scenario_years(s5, pp, cp, [680.0], yd)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        my.fluxcorr_years(s5, pp, 340.0, yd)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        m.run_members([m.params], years=1)
    zero = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        m.run_scenario(zero, years=2, co2_series=np.full(2, 680.0),
                       years_per_call=2)


def test_year_work_96x48_is_unchanged():
    """The dense plan's count, reckoned by hand from the 96x48 plan (the
    formula before packed plans were counted)."""
    plan = fc2_plan_96x48()
    num = Numerics()
    yx, t, X, kk = 48 * 96, 730, 96, 2
    words = (5 * yx + 8 * t * yx + t * 48 + 5 * yx + 25 * 2 * yx
             + 2 * kk * X * X + 5 * yx + 3 * t * yx)
    sub = 2 * yx * 41 + 2 * kk * X * (2 * X + 4)
    step = 24 * sub + 2 * yx * 21 + yx * 125
    assert yk.year_work(plan, num, False) == (4 * words, t * step)
    step_s = 24 * sub + 2 * yx * 21 + yx * 134
    assert yk.year_work(plan, num, True) == (
        4 * (words + 5 * t * yx + 9 * yx), t * step_s)


def fc2_plan_96x48():
    from greb_tpu_torch.ops import fastcirc2 as fc2
    return fc2.FastPlan(ydim=48, xdim=96, bt=10, bb=10, diff_segs=(),
                        adv_segs=(), comp_mode="dense", comp_kt=1, comp_kb=1)


def test_year_work_384x192_counts_ranks_and_segments(pair):
    m = pair[1]
    plan, const = m.fold
    _, ranks = yk.packed_ranks(const)
    rtot = int(ranks.sum())
    assert len(ranks) == 28 and rtot == const.pcu.shape[1]
    num = Numerics(xdim=384, ydim=192, dt_crcl=1800)   # the full calendar
    yx, t, X = 192 * 384, 730, 384
    # diffusion segments: rows (kt + kb) x 2 fields x X cells, each
    # iteration 15 operations (the 7-point sum in sequence, the clamp's
    # compare, the add), 2 to enter and leave; advection the same
    segs = plan.diff_segs + plan.adv_segs
    assert segs == ((14, 14, 1), (7, 7, 1), (5, 5, 1), (3, 3, 1), (2, 2, 1),
                    (1, 1, 2), (2, 2, 1), (1, 1, 3))
    seg_ops = 2 * X * (28 * 17 + 14 * 17 + 10 * 17 + 6 * 17 + 4 * 17
                       + 2 * 32 + 4 * 17 + 2 * 47)
    # z = t1 U (X terms, 2 operations each, r columns) and t2 = z W (r
    # terms, X columns) for each of the 28 rows; clamp and combine 4 a cell
    comp_ops = 4 * X * rtot + 28 * X * 4
    sub = 2 * yx * 41 + comp_ops + seg_ops
    words = (5 * yx + 8 * t * yx + t * 192 + 5 * yx + 25 * 2 * yx
             + (2 * X * rtot + 2 * 28) + 5 * yx + 3 * t * yx)
    assert yk.year_work(plan, num, False, ranks) == (
        4 * words, t * (24 * sub + 2 * yx * 21 + yx * 125))
    with pytest.raises(ValueError, match="ranks"):
        yk.year_work(plan, num, False)


def test_long_run_route_at_384x192(pair, k2_port, tmp_path):
    """run_long + driver_year_runner (years_per_call=1, so K2 a year): one
    scenario year from the initial state with zero corrections writes the
    per-year path's monthly means; a member-kernel block raises before it
    writes anything."""
    m = pair[1]
    num = m.num
    zero = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    out = str(tmp_path / "long")
    run = longrun.driver_year_runner(m, out)
    try:
        state, _, start = longrun.run_long(
            1, m.initial_state(), zero, np.full(1, 680.0, np.float32), run)
    finally:
        run.close()
    assert start == 0
    s, outs, _ = k2_port
    for name in ("ts", "ta", "to", "q", "cap_surf"):
        got = _np(getattr(state, name))
        assert np.isfinite(got).all(), name
        np.testing.assert_array_equal(got, _np(getattr(s, name)), name)
    want = _np(core.monthly_means(m.month_mat, outs))
    back = read_output(out, num.xdim, num.ydim)
    assert np.isfinite(back).all()
    np.testing.assert_array_equal(back, want.reshape(back.shape))
    blocks = longrun.driver_year_runner(m, str(tmp_path / "blocks"),
                                        years_per_call=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3c"):
        longrun.run_long(2, m.initial_state(), zero,
                         np.full(2, 680.0, np.float32), blocks,
                         chunk_years=2)
    blocks.close()


def test_packed_composites_work_on_their_ranks(pair):
    """The plain packed composites (each row on its own rank's columns,
    which the refined kernel repeats) equal the masked full product
    ((T U_all) * mask) W_all in _row_dot's order, bit for bit, on a
    perturbed state."""
    from greb_tpu_torch.ops import fastcirc as v1
    from greb_tpu_torch.ops import fastcirc2 as fc2
    m = pair[1]
    plan, const = m.fold
    s0 = m.initial_state()
    rng = np.random.default_rng(1)
    x = torch.stack([s0.ta, s0.q])
    x = x * torch.as_tensor(rng.uniform(0.9, 1.1, x.shape).astype(np.float32))
    dd = x * torch.as_tensor(rng.normal(0, 0.01, x.shape).astype(np.float32))
    Y, ktc, kbc = plan.ydim, plan.comp_kt, plan.comp_kb
    slab = lambda a: torch.cat([a[:, :ktc], a[:, Y - kbc:]], dim=1)
    t1 = slab(x) + slab(dd)
    z = fc2._row_dot(t1.reshape(-1, plan.xdim), const.pcu) * const.pmask
    t2 = fc2._row_dot(z, const.pcw).reshape(t1.shape)
    want = (t1 + v1._clamped(t2 - t1, t1)) - slab(x)
    got = slab(fc2._packed_comp(x, dd, const, plan))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(_np(got), _np(want))
    # the rows between the composites keep dd
    np.testing.assert_array_equal(
        _np(fc2._packed_comp(x, dd, const, plan)[:, ktc:Y - kbc]),
        _np(dd[:, ktc:Y - kbc]))
