"""Refined grids: the port's four kernels at 384x192 (an extension-mode
plan) against ``greb_tpu``, the refined layout, the refusals and the
paths through them.

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
* The member kernels K4 and K3 the same way (``TOL``, ``TOL_CORR``), at
  M=2 with members that differ in ct_sens, each member against
  ``greb_tpu``'s XLA year under its own params (the fold built once): K4
  from the initial state at 340 ppm; K3 two years from the initial state
  at 680 ppm with zero tables, a table per member and one shared table,
  monthly means included.  After K3's two free-running years cap_surf is
  held at rtol 5e-3 (``TOL_YEARS``): one cell on the sea-ice ramp differs
  by 2.2e-3 relative, about 2e-4 K of Ts at the ramp's ~5e7 J/K/m^2 per
  K.  At M=1 with the base params K4 equals K1 and K3 equals K2 (state,
  annual sums) bit for bit.
* ``refined_layout`` and the wrappers' and driver's refusals of what stays
  queued (768x384, cluster sizes other than 16) and of a plan make_plan
  never builds (sequential splitting with dense composites), which need
  no card; the real 192x96 plan (dense composites, additive splitting) is
  accepted, and so are the legacy and strict words (ROADMAP Queue 1 item
  3f, closed), each routed to its refined kernel.
* ``year_work`` and ``years_work`` at 96x48 (unchanged) and at 384x192
  (packed composites at their ranks, the segments), reckoned by hand.
* The paths at 384x192: ``run_long`` with ``driver_year_runner``, one year
  a K2 call and in K3 blocks (``years_per_call=2``, which is
  ``run_scenario(years_per_call=2)``), from the initial state with zero
  corrections; and on a 10-step calendar (two months; the 4-step one runs
  away in a scenario after a spin-up) ``run_members`` (K4 spin-ups, then
  K3) and the CLI's ``run_ensemble --shared-spinup`` (K1, then K3) with a
  base member and a perturbed one, the base member against the per-year
  path (K1, K2) at the golden tolerances.
"""
import contextlib
import copy
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

from greb_tpu_torch import __main__ as cli
from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import (Corrections, ModelState,
                                    forcing_from_arrays)
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core, longrun
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc as fc
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens
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
# K3's state after two years (see the docstring)
TOL_YEARS = dict(TOL, cap_surf=(5e-3, 0))
# the members of the member-kernel tests: ct_sens -2% and +2% (the JAX
# CLI's default sweep ends)
CT_SENS = (22.05, 22.95)
# the 10-step calendar of the member paths (two months)
MONTHS = dict(GRID, ndays_yr=5, jday_mon=(3, 2))


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


def _refined(grid):
    """The port's GREB at ``grid`` on the CPU, on the 96x48 synthetic
    forcing of its calendar regridded."""
    num = Numerics(**grid)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    with _limits():
        return GREB(GrebConfig(numerics=num, fast_circulation=True),
                    forcing=forcing_from_arrays(
                        regrid_forcing_arrays(arrs, num), "cpu"),
                    verbose=False, device="cpu")


@pytest.fixture(scope="module")
def pair():
    arrs = make_synthetic_forcing(96, 48, 4, GRID["ndays_yr"])
    jnum = JNumerics(**GRID)
    with _limits():
        jm = JGREB(JConfig(numerics=jnum, fast_circulation=True),
                   forcing=jforcing_from_arrays(
                       jregrid_forcing_arrays(arrs, jnum)), verbose=False)
    return jm, _refined(GRID)


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
    yk.check_supported(plan)


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
    for kind in yk.KINDS:
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
    assert all(yk.offered_sizes(kind, plan) == yk.REFINED_CLUSTER_SIZES
               for kind in yk.KINDS)


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
    # 768x384: 24 rows a block on one 16-block cluster, the double buffer
    # alone 2*2*28*768*4 = 344,064 B; the grid runs in the wide form, on
    # 6 clusters of 16 blocks (4 rows a block; tests/test_torch_grid768.py
    # holds the real 768x384 plan)
    wide = dataclasses.replace(plan, ydim=384, xdim=768)
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.refined_layout(wide, 16, "scenario")
    yk.check_supported(wide)
    assert yk.refined_groups(wide) == 6
    assert yk.block_layout(wide, 16, "scenario") == \
        yk.refined_layout(wide, 16, "scenario", 6)
    # 192x96 (dense composites at comp_kt=5, 192x192 matrices, additive
    # splitting, advection segments) runs in the refined instantiation
    real = fc.make_plan(make_grid(192, 96, 1800))
    assert real.comp_mode == "dense" and not real.seq_zonal
    for kind in yk.KINDS:
        yk.check_plan(real, kind)
        assert yk.refined_layout(real, 16, kind).nbytes == 64560
    yk.check_supported(real)
    # dense composites with sequential splitting, which make_plan never
    # builds, are refused
    dense = dataclasses.replace(plan, ydim=96, xdim=192, comp_mode="dense",
                                comp_kt=5, comp_kb=5)
    with pytest.raises(ValueError, match="packed"):
        yk.refined_layout(dense, 16, "scenario")
    with pytest.raises(ValueError, match="make_plan does not build"):
        yk.check_plan(dense, "scenario")
    with pytest.raises(ValueError, match="one of"):
        yk.refined_layout(plan, 16, "members")


@pytest.mark.parametrize("kind", ("fluxcorr", "scenario"))
def test_refined_plan_refuses_legacy_and_strict_words(pair, kind):
    """Refused until ROADMAP Queue 1 item 3f: a legacy fold word and the
    strict transport at 384x192 are accepted and routed to the refined
    instantiation's legacy variant and its strict form."""
    plan = pair[1].fold[0]
    flags = yk.experiment_flags(Experiment(11))
    assert flags
    yk.check_plan(plan, kind, flags)
    yk.check_supported(plan, (kind,), flags)
    strict = yk.StrictPlan(192, 384, seq_zonal=True)
    strict_flags = yk.experiment_flags(Experiment(), True)
    yk.check_plan(strict, kind, strict_flags)
    yk.check_supported(strict, (kind,), strict_flags)
    kernel = "fluxcorr_year" if kind == "fluxcorr" else "scenario_year"
    assert yk.refined_entry(kernel, plan, flags) == \
        kernel + "_refined_legacy"
    assert yk.refined_entry(kernel, plan, 0) == kernel + "_refined"
    assert yk.refined_entry(kernel, strict, strict_flags) == \
        kernel + "_strict_refined"
    with pytest.raises(ValueError, match="no refined kernel"):
        yk.refined_entry(kernel, plan, strict_flags)


REFUSALS = ("legacy word", "strict word", "dense composites", "768x384",
            "cluster=1", "cluster=12")


@pytest.mark.parametrize("case", REFUSALS)
def test_member_kernels_refuse_a_refined_plan(pair, case):
    """What stays queued at an extension-mode plan raises in K4 and K3
    before any launch, on CPU tensors too: a grid the refined layout does
    not hold (3d, in ``check_supported``, which GREB runs on the card
    before any year; 768x384 runs since in the wide form, which a card
    that cannot hold all of a member's clusters at once refuses), and a
    cluster size other than REFINED_CLUSTER_SIZES; dense composites with
    sequential splitting,
    which make_plan never builds, raise ValueError.  The legacy and strict
    words, refused until ROADMAP Queue 1 item 3f, are accepted: the legacy
    fold word's K4 and K3 run (their plain versions here; K4 at M=1 is K1
    bit for bit) and route to the ``*_refined_legacy`` kernels, the strict
    word passes every check of the wrappers and GREB's member paths and
    routes to ``*_strict_refined`` (its plain year at 384x192 is minutes on
    the CPU)."""
    m = pair[1]
    plan, const = m.fold
    yd, num = m.year_data, m.num
    if case == "768x384":
        wide = dataclasses.replace(plan, ydim=384, xdim=768)
        for kind in my.KINDS:
            yk.check_supported(wide, (kind,))
        for kernel in ("fluxcorr_years", "scenario_years"):
            assert yk.refined_entry(kernel, wide, 0) == kernel + "_wide"
        with pytest.raises(RuntimeError, match="runs 5 at once"):
            yk.check_resident(yk.refined_groups(wide), 5)
        return
    s5 = m.initial_state().stack()[:, None]
    pp = my.pack_member_params([m.params])
    cp = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim))
    if case.endswith("word"):
        if case == "legacy word":
            yd = dataclasses.replace(yd, exp=Experiment(11), cache={})
            suffix = "_refined_legacy"
        else:
            yd = dataclasses.replace(yd, fold=None, cache={})
            suffix = "_strict_refined"
        assert yd.flags != 0
        for kind in my.KINDS:
            yk.check_plan(yd.plan, kind, yd.flags)
            assert my._check(s5, pp, yd, kind) == 1
        for kernel in ("fluxcorr_years", "scenario_years"):
            assert yk.refined_entry(kernel, yd.plan, yd.flags) == \
                kernel + suffix
        model = copy.copy(m)
        model.year_data = yd
        model._check_member_kernels()
        if case == "legacy word":
            s4, c4 = my.fluxcorr_years(s5, pp, 340.0, yd)
            s1, c1 = yk.fluxcorr_year(m.initial_state(), 340.0, yd)
            assert torch.equal(s4[:, 0], s1.stack())
            assert torch.equal(c4[0, :, 0], c1.tf)
            s3, mon, asum = my.scenario_years(s5, pp, cp, [680.0], yd)
            assert tuple(mon.shape) == (1, 1, 5, num.ydim, num.xdim)
            assert np.isfinite(_np(asum)).all()
        return
    kw, err, match = {}, NotImplementedError, None
    if case == "dense composites":
        dense = dataclasses.replace(plan, comp_mode="dense")
        yd = dataclasses.replace(yd, fold=(dense, const), cache={})
        err, match = ValueError, "make_plan does not build"
    else:
        kw = dict(cluster=int(case.split("=")[1]))
        err, match = ValueError, r"clusters of \(16,\)"
    with pytest.raises(err, match=match):
        my.fluxcorr_years(s5, pp, 340.0, yd, **kw)
    with pytest.raises(err, match=match):
        my.scenario_years(s5, pp, cp, [680.0], yd, **kw)


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


def test_years_work_384x192_counts_ranks_and_segments(pair):
    """The member kernels' work at 384x192: the shared inputs with the
    packed composites at their ranks, each member's state, pack, tables,
    monthly means and annual sums; operations K1's or K2's (the segments'
    iterations included) per member and year, K3's with the monthly
    means' multiply and add.  96x48's dense composites are unchanged."""
    m = pair[1]
    plan, const = m.fold
    _, ranks = yk.packed_ranks(const)
    num = Numerics(xdim=384, ydim=192, dt_crcl=1800)   # the full calendar
    yx, t, X = 192 * 384, 730, 384
    shared = (8 * t * yx + t * 192 + 5 * yx + 25 * 2 * yx
              + 2 * X * int(ranks.sum()) + 2 * 28)
    member = 10 * yx + my.N_PPACK
    assert my.years_work(plan, num, 1, 2, "fluxcorr", ranks=ranks) == (
        4 * (shared + 2 * member + 2 * 3 * t * yx),
        2 * yk.year_work(plan, num, False, ranks)[1])
    k3 = yk.year_work(plan, num, True, ranks)[1] + 10 * t * yx
    assert my.years_work(plan, num, 3, 2, "scenario", shared_corr=True,
                         ranks=ranks) == (
        4 * (shared + 2 * member + 3 * 3 * t * yx + 3 + 2 * t
             + 2 * 3 * (12 * 5 + 9) * yx), 6 * k3)
    with pytest.raises(ValueError, match="ranks"):
        my.years_work(plan, num, 1, 1, "fluxcorr")
    dense = fc2_plan_96x48()
    assert yk.composite_words(dense) == 2 * 2 * 96 * 96


def test_long_run_route_at_384x192(pair, k2_port, tmp_path):
    """run_long + driver_year_runner from the initial state with zero
    corrections at 680 ppm: one year a K2 call writes the per-year path's
    year; K3 blocks of 2 years (``run_scenario(years_per_call=2)``) end
    in the per-year path's state bit for bit (the plain versions run the
    same steps) and write its monthly means at the golden tolerances."""
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
    for name in ModelState.FIELDS:
        got = _np(getattr(state, name))
        assert np.isfinite(got).all(), name
        np.testing.assert_array_equal(got, _np(getattr(s, name)), name)
    want = _np(core.monthly_means(m.month_mat, outs))
    back = read_output(out, num.xdim, num.ydim)
    assert np.isfinite(back).all()
    np.testing.assert_array_equal(back, want.reshape(back.shape))
    # two years, per year and in one K3 block
    co2 = np.full(2, 680.0, np.float32)
    s_year, mon_year, _ = m.run_scenario(zero, state=m.initial_state(),
                                         years=2, co2_series=co2)
    blocks = longrun.driver_year_runner(m, str(tmp_path / "blocks"),
                                        years_per_call=2)
    try:
        s_block, _, _ = longrun.run_long(2, m.initial_state(), zero, co2,
                                         blocks, chunk_years=2)
    finally:
        blocks.close()
    for name in ModelState.FIELDS:
        got = _np(getattr(s_block, name))
        assert np.isfinite(got).all(), name
        np.testing.assert_array_equal(got, _np(getattr(s_year, name)), name)
    back = read_output(str(tmp_path / "blocks"), num.xdim, num.ydim)
    _months_close(back.reshape(mon_year.shape), mon_year, "K3 blocks")


def _months_close(got, want, tag):
    """Monthly means (..., 5, y, x) at the golden tolerances."""
    for v, (name, atol) in enumerate((("ts", 2e-2), ("ta", 2e-2),
                                      ("to", 2e-2), ("q", 3e-6),
                                      ("albedo", 5e-4))):
        _close(_np(got)[..., v, :, :], _np(want)[..., v, :, :], 0, atol,
               f"{tag} monthly {name}")


# ---------------------------------------------------------------------------
# the member kernels K4 and K3 at 384x192
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def members(pair):
    """(the port's members, greb_tpu's ModelData of each): the base params
    with ct_sens CT_SENS[i]."""
    jm, m = pair
    port = ens.perturbed_params(m.params,
                                {"ct_sens": np.float32(CT_SENS)})
    jmd = [jm.md.replace(params=jm.params.replace(ct_sens=jnp.float32(v)))
           for v in CT_SENS]
    return port, jmd


def test_k4_refined_members_match_xla(pair, members):
    jm, m = pair
    port, jmd = members
    _, fcdata = jm._fastcirc_split()
    s5 = ens.ensemble_initial_state(port, m.forcing)
    s, corr = my.fluxcorr_years(s5, my.pack_member_params(port), 340.0,
                                m.year_data)
    assert tuple(corr.shape) == (2, m.num.nstep_yr, 3, 192, 384)
    for i, md in enumerate(jmd):
        js, jcorr = jm._year_fluxcorr()(jm.initial_state(), jm.sfx,
                                        jnp.float32(340.0), md, fcdata)
        for k, (name, (rtol, atol)) in enumerate(TOL.items()):
            _close(s[k, i], getattr(js, name), rtol, atol,
                   f"K4 member {i} {name}")
        for k, (name, atol) in enumerate(TOL_CORR.items()):
            _close(corr[i, :, k], getattr(jcorr, name), 0, atol,
                   f"K4 member {i} {name}")
    assert not torch.equal(corr[0], corr[1])


@pytest.fixture(scope="module")
def k3_xla(pair, members):
    """greb_tpu's two XLA scenario years of each member from the initial
    state at 680 ppm, for a table per member and for one shared table:
    {mode: (tables, [(state, monthly (2 * nmon, 5, y, x))] per member)}."""
    jm, m = pair
    _, jmd = members
    _, fcdata = jm._fastcirc_split()
    shape = (m.num.nstep_yr, 3, m.num.ydim, m.num.xdim)
    tables = {"per member": np.zeros((2,) + shape, np.float32),
              "shared": np.zeros((1,) + shape, np.float32)}
    got = {}
    for mode, tab in tables.items():
        runs = []
        for i, md in enumerate(jmd):
            t = tab[i % len(tab)]
            corr = JCorrections(tf=jnp.asarray(t[:, 0]),
                                tof=jnp.asarray(t[:, 1]),
                                qf=jnp.asarray(t[:, 2]))
            js, mons = jm.initial_state(), []
            for _ in range(2):
                js, jmon, _ = jm._year_scenario(True)(
                    js, jm.sfx, corr, jnp.float32(680.0), md, fcdata)
                mons.append(np.asarray(jmon))
            runs.append((js, np.concatenate(mons)))
        got[mode] = (tab, runs)
    return got


@pytest.mark.parametrize("mode", ("per member", "shared"))
def test_k3_refined_members_match_xla(pair, members, k3_xla, mode):
    jm, m = pair
    port, _ = members
    tab, runs = k3_xla[mode]
    s5 = ens.ensemble_initial_state(port, m.forcing)
    s, mon, asum = my.scenario_years(s5, my.pack_member_params(port),
                                     torch.as_tensor(tab), [680.0, 680.0],
                                     m.year_data)
    nmon = len(m.num.jday_mon)
    assert tuple(mon.shape) == (2, 2 * nmon, 5, 192, 384)
    assert tuple(asum.shape) == (2, 2, 9, 192, 384)
    assert np.isfinite(_np(asum)).all()
    for i, (js, jmon) in enumerate(runs):
        for k, (name, (rtol, atol)) in enumerate(TOL_YEARS.items()):
            _close(s[k, i], getattr(js, name), rtol, atol,
                   f"K3 {mode} member {i} {name}")
        for v, name in enumerate(("ts", "ta", "to", "q")):
            _close(mon[i, :, v], jmon[:, v], 0, TOL[name][1],
                   f"K3 {mode} member {i} monthly {name}")
    assert not torch.equal(mon[0], mon[1])


def test_member_kernels_at_m1_equal_single_run(pair, k2_port):
    """K4 at M=1 with the base params is K1's year bit for bit, and K3's
    one year K2's (state, annual sums): the plain versions run the same
    steps, as the refined instantiations run the same body."""
    m = pair[1]
    yd = m.year_data
    s0 = m.initial_state()
    pp = my.pack_member_params([m.params])
    s4, c4 = my.fluxcorr_years(s0.stack()[:, None], pp, 340.0, yd)
    s1, c1 = yk.fluxcorr_year(s0, 340.0, yd)
    np.testing.assert_array_equal(_np(s4[:, 0]), _np(s1.stack()))
    for k, name in enumerate(("tf", "tof", "qf")):
        np.testing.assert_array_equal(_np(c4[0, :, k]),
                                      _np(getattr(c1, name)), name)
    num = m.num
    zero = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim))
    s3, _, a3 = my.scenario_years(s0.stack()[:, None], pp, zero, [680.0], yd)
    s2, _, a2 = k2_port
    assert np.isfinite(_np(s3)).all()
    np.testing.assert_array_equal(_np(s3[:, 0]), _np(s2.stack()))
    np.testing.assert_array_equal(_np(a3[0, 0]), _np(a2))


@pytest.fixture(scope="module")
def months_model():
    """The 10-step calendar's model and the per-year path of its base
    params: the spin-up (K1), the scenario year from its end state (K2)
    and from the initial state with its cap_surf (the shared spin-up's
    start), at the CLI's CO2."""
    m = _refined(MONTHS)
    num = m.num
    co2 = m.cfg.co2.series(num.time_scnr)
    s_fc, corr = m.flux_correction()
    _, mon_chain, _ = m.run_scenario(corr, state=s_fc, co2_series=co2)
    start = ModelState(**{n: getattr(m.initial_state(), n)
                          for n in ModelState.FIELDS[:4]},
                       cap_surf=s_fc.cap_surf)
    _, mon_shared, _ = m.run_scenario(corr, state=start, co2_series=co2)
    return m, corr, mon_chain, mon_shared


def test_run_members_at_384x192(months_model):
    """run_members with per-member spin-ups (K4, then K3 from its end
    state): the base member's tables equal K1's, its months the per-year
    path's at the golden tolerances; the perturbed member differs."""
    m, corr, mon_chain, _ = months_model
    num = m.num
    port = ens.perturbed_params(m.params,
                                {"ct_sens": np.float32([22.5, 22.95])})
    s5, corrpack, mon, asum = m.run_members(
        port, co2_series=m.cfg.co2.series(num.time_scnr))
    assert mon.shape == (2, len(num.jday_mon), 5, 192, 384)
    assert np.isfinite(_np(s5)).all() and np.isfinite(asum).all()
    np.testing.assert_array_equal(_np(corrpack[0, :, 0]), _np(corr.tf))
    _months_close(mon[0], mon_chain.reshape(mon[0].shape), "run_members")
    assert not np.array_equal(mon[0], mon[1])


def test_run_ensemble_shared_spinup_at_384x192(months_model, tmp_path):
    """The CLI's --ensemble 2 --shared-spinup (K1, then K3 reading its one
    table): the base member's file is the per-year path's year from the
    initial state with the spin-up's cap_surf, at the golden tolerances."""
    m, _, _, mon_shared = months_model
    num = m.num
    out = str(tmp_path / "member")
    args = cli.build_parser().parse_args(
        ["--ensemble", "2", "--perturb", "ct_sens=22.5:22.95",
         "--shared-spinup", "--quiet"])
    cli.run_ensemble(m, out, args)
    files = [read_output(f"{out}_{i:03d}", num.xdim, num.ydim)
             for i in (1, 2)]
    _months_close(files[0], mon_shared.reshape(files[0].shape),
                  "--shared-spinup")
    assert np.isfinite(files[1]).all()
    assert not np.array_equal(files[0], files[1])


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
