"""768x384 at dt_crcl=450 (the repository's BASELINE config 5): the port's
plan, its wide form's layout and refusals, and its plain years against
``greb_tpu``.

On the card the four kernels run this grid in the refined instantiation's
wide form (``*_wide``, ``*_wide_legacy``): one run or member spread over
``year_kernel.refined_groups(plan)`` = 6 clusters of 16 blocks, 4 rows of
768 columns a block, the halo rows across the clusters' edges exchanged
at a grid barrier.  What needs no card is held here, on forcing regridded
from the 96x48 synthetic forcing on a 2-step calendar (96 substeps a
step):

* the port's plan and packed composite ranks equal ``greb_tpu``'s
  ``make_plan`` / ``build_const`` on the same forcing;
* the wide layout's bytes reckoned by hand (196,656 B a block at G = 6 for
  every kind), G the smallest that fits, and the refusal of a launch whose
  clusters the card cannot hold at once (``check_resident``);
* the strict transport and the no-transport words (the library default,
  ``--strict-circulation``, log_exp 4 and 16) routed before any launch to
  the sequential strict form's wide variant (``*_strict_wide``);
* K1 and K2 through the port's wrappers on CPU tensors (the plain
  versions the wide kernels are held to bit for bit on the card) against
  ``greb_tpu``'s XLA years (``_pallas_viable`` is False at this grid):
  K1 from the initial state at 340 ppm, K2 from the initial state with
  zero corrections at 680 ppm, at ``tests/test_torch_refined.py``'s
  tolerances, every array checked finite (``assert_allclose`` counts NaN
  equal to NaN); and ``greb_tpu``'s XLA K2 from its K1's end with K1's
  tables going non-finite on this calendar, as the port's does;
* K4 = K1 and K3 = K2 at M=1 with the base params on the plain path;
* ``year_work`` and ``years_work`` at 768x384 reckoned by hand.

A plain year here is ~20 s on one CPU thread and building each package's
fold ~20 s, so the module builds one pair of models, runs each year once,
and runs the independent parts side by side on threads of their own (each
PyTorch or XLA call releases the GIL): ``greb_tpu``'s fold and XLA years
on one, while the port builds its fold, then the port's four plain years
(K1, K2, K4, K3) on one each.
"""
import concurrent.futures
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

from greb_tpu_torch import __main__ as cli
from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections, forcing_from_arrays
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.regrid import regrid_forcing_arrays

torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only: the composites then build slower
    threadpool_limits = None

# config 5's grid and substep (tools/run_config5.py) on a 2-step calendar
GRID = dict(xdim=768, ydim=384, dt_crcl=450, ndays_yr=1, jday_mon=(1,),
            time_flux=1, time_scnr=1)
# tests/test_torch_refined.py's tolerances: the golden ones for the state
# (tests/test_golden_year.py:29), cap_surf relative, the correction tables
TOL = dict(ts=(0, 2e-2), ta=(0, 2e-2), to=(0, 2e-2), q=(0, 3e-6),
           cap_surf=(1e-3, 0))
TOL_CORR = dict(tf=0.5, tof=1e-5, qf=1e-6)
TOL_YEARS = dict(TOL, cap_surf=(5e-3, 0))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol, atol, name):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), f"{name}: port not finite"
    assert np.isfinite(want).all(), f"{name}: greb_tpu not finite"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _limits():
    # the 768x768 composite powers and SVDs on one BLAS thread (under -n 6
    # spinning BLAS threads made them 50x slower)
    return threadpool_limits(1) if threadpool_limits \
        else contextlib.nullcontext()


def _xla_years(arrs):
    """greb_tpu's model with its fold, its XLA K1 year from the initial
    state at 340 ppm and its K2 year from the initial state with zero
    corrections at 680 ppm (as tests/test_pallas_refined.py:94 calls
    them)."""
    jnum = JNumerics(**GRID)
    jm = JGREB(JConfig(numerics=jnum, fast_circulation=True),
               forcing=jforcing_from_arrays(
                   jregrid_forcing_arrays(arrs, jnum)), verbose=False)
    _, fcdata = jm._fastcirc_split()
    k1 = jm._year_fluxcorr()(jm.initial_state(), jm.sfx, jnp.float32(340.0),
                             jm.md, fcdata)
    jzero = JCorrections.zeros(jnum.nstep_yr, jnum.ydim, jnum.xdim)
    k2 = jm._year_scenario(True)(jm.initial_state(), jm.sfx, jzero,
                                 jnp.float32(680.0), jm.md, fcdata)
    return jm, k1, k2


def _port_years(m):
    """The port's plain years through its wrappers on CPU tensors, each a
    callable: K1 (340 ppm) and K4 at M=1 with the base params from the
    initial state, K2 and K3 at M=1 from it with zero corrections (680
    ppm)."""
    yd, num = m.year_data, m.num
    s0 = m.initial_state()
    s5 = s0.stack()[:, None]
    pp = my.pack_member_params([m.params])
    zero = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    zero5 = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim))
    return dict(
        k1=lambda: yk.fluxcorr_year(s0, 340.0, yd),
        k2=lambda: yk.scenario_year(s0, zero, 680.0, yd),
        k4=lambda: my.fluxcorr_years(s5, pp, 340.0, yd),
        k3=lambda: my.scenario_years(s5, pp, zero5, [680.0], yd))


@pytest.fixture(scope="module")
def runs():
    """The port's model, and futures of greb_tpu's model and XLA years
    (``_xla_years``, started first) and of the port's four plain years
    (``_port_years``), each on a thread of its own; all on the same
    regridded forcing, every BLAS on one thread."""
    num = Numerics(**GRID)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    with _limits(), concurrent.futures.ThreadPoolExecutor(5) as pool:
        xla = pool.submit(_xla_years, arrs)
        m = GREB(GrebConfig(numerics=num, fast_circulation=True),
                 forcing=forcing_from_arrays(regrid_forcing_arrays(arrs, num),
                                             "cpu"),
                 verbose=False, device="cpu")
        years = {k: pool.submit(fn) for k, fn in _port_years(m).items()}
        yield m, xla, years


@pytest.fixture(scope="module")
def pair(runs):
    """(greb_tpu's model, the port's)."""
    return runs[1].result()[0], runs[0]


@pytest.fixture(scope="module")
def k1_port(runs):
    """The port's K1 year from the initial state at 340 ppm."""
    return runs[2]["k1"].result()


@pytest.fixture(scope="module")
def k2_port(runs):
    """The port's K2 year from the initial state with zero corrections at
    680 ppm: (state, outs, annual sums)."""
    return runs[2]["k2"].result()


def test_plan_and_ranks_match_greb_tpu(pair):
    jm, m = pair
    plan, const = m.fold
    jplan, jconst = jm.fastcirc_tables()
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert plan.seq_zonal and plan.comp_mode == "packed"
    assert (plan.comp_kt, plan.comp_kb) == (14, 14)
    assert plan.diff_segs == ((27, 27, 1), (15, 15, 1), (10, 10, 1),
                              (6, 6, 1), (4, 4, 1), (3, 3, 1), (1, 1, 1))
    assert plan.adv_segs == ((2, 2, 1), (1, 1, 3))
    np.testing.assert_array_equal(_np(const.pmask), np.asarray(jconst.pmask))
    offs, ranks = yk.packed_ranks(const)
    jranks = (np.asarray(jconst.pmask) != 0).sum(axis=1)
    np.testing.assert_array_equal(ranks, jranks)
    assert len(ranks) == 56 and (int(ranks.min()), int(ranks.max()),
                                 int(ranks.sum())) == (11, 768, 12886)
    assert tuple(const.pcu.shape) == (768, 12886) == \
        tuple(np.asarray(jconst.pcu).shape)
    assert m.year_data.flags == 0 and yk.is_refined(plan)


def test_wide_layout_bytes_and_groups(runs):
    """6 clusters of 16 blocks, 4 rows of 768 columns a block: the (Ta, q)
    double buffer with 2 halo rows each side (2 x 2 x 8 x 768 words), wz
    and xa (2 x 4 x 768 each), the scratch for 4 rows of both fields in
    two buffers (2 x 2 x 4 x 768: blocks 0-3 hold the 14 composite rows,
    blocks 3-10 the diffusion segments), the composite index (2 x 4 + 1
    words, rounded up to 12); 1 to 5 clusters do not fit."""
    plan = runs[0].fold[0]
    assert yk.refined_groups(plan) == 6
    for g in range(1, 6):
        with pytest.raises(ValueError):
            yk.refined_layout(plan, 16, "scenario", g)
    for kind in yk.KINDS:
        lay = yk.refined_layout(plan, 16, kind, 6)
        assert (lay.blocks, lay.groups, lay.rows, lay.comp_rows,
                lay.threads) == (16, 6, 4, 4, 1024)
        assert dict(lay.parts) == dict(
            transported=4 * 2 * 2 * 8 * 768, wz=4 * 2 * 4 * 768,
            xa=4 * 2 * 4 * 768, scratch=4 * 2 * 2 * 4 * 768,
            comp_index=4 * 12)
        assert lay.nbytes == 196656 <= yk.MAX_SMEM_BYTES
        assert yk.block_layout(plan, 16, kind) == lay
        yk.check_plan(plan, kind)
    yk.check_supported(plan)
    with pytest.raises(ValueError, match="1..8"):
        yk.refined_layout(plan, 16, "scenario", 9)
    # every kernel runs the wide form, modern and legacy
    legacy = yk.experiment_flags(Experiment(11))
    for kernel in ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                   "scenario_years"):
        assert yk.refined_entry(kernel, plan, 0) == kernel + "_wide"
        assert yk.refined_entry(kernel, plan, legacy) == \
            kernel + "_wide_legacy"
    assert yk._refined_struct(plan).groups == 6


@pytest.mark.parametrize("capacity,members,per_launch", (
    (7, 1, 1), (7, 3, 1), (12, 3, 2), (48, 5, 5), (6, 2, 1)))
def test_wide_launch_takes_the_resident_members(capacity, members,
                                                per_launch):
    assert yk.check_resident(6, capacity, members) == per_launch


@pytest.mark.parametrize("capacity", (0, 1, 5))
def test_wide_launch_refuses_clusters_that_are_not_resident(capacity):
    """A grid barrier over clusters that are not all resident never ends:
    the launch is refused before it starts, naming the capacity found."""
    with pytest.raises(RuntimeError, match=f"runs {capacity} at once"):
        yk.check_resident(6, capacity)


STRICT_WORDS = ("library default", "--strict-circulation", "log_exp 4",
                "log_exp 16")


@pytest.mark.parametrize("word", STRICT_WORDS)
def test_strict_words_refused_naming_3h(runs, word):
    """(Named for the refusal it replaced.)  The strict transport and the
    no-transport words at 768x384, which raised naming ROADMAP Queue 1
    item 3h until the sequential strict form had its wide variant, route
    to that form before any launch: GREB builds no fold, the plan is the
    grid's ``StrictPlan`` (under the strict transport with every row's
    sub-cycle counts: the pole row 6,612 diffusion rounds a substep;
    without transport a step is the state update alone), the checks GREB
    runs on the card pass, all four kernels pick ``*_strict_wide`` (in
    csrc/strict_wide_kernel.cu's library) on 6 clusters of 16 blocks
    (``strict_wide_layout``, the spread sub-cycle's groups of 16 blocks
    of 48 columns), and the member kernels take one member a launch on a
    card that runs 7 such clusters at once.  The plain member years at
    this grid (6,612 rounds over the grid a substep) are the card's to
    check (chip_smoke.py step 23)."""
    m = runs[0]
    if word == "library default":
        cfg = GrebConfig(numerics=m.num)
    elif word == "--strict-circulation":
        args = cli.build_parser().parse_args(["--strict-circulation"])
        cfg = GrebConfig(numerics=m.num,
                         fast_circulation=not args.strict_circulation)
    else:
        cfg = GrebConfig(numerics=m.num, fast_circulation=True,
                         experiment=Experiment(int(word.split()[1])))
    strict = GREB(cfg, forcing=m.forcing, verbose=False, device="cpu")
    yd = strict.year_data
    assert strict.fold is None and yd.transport in ("strict", "none")
    plan = yd.plan
    assert isinstance(plan, yk.StrictPlan) and plan.seq_zonal
    if yd.transport == "strict":
        assert plan.sub_cycles[0][:4] == (6612, 734, 265, 135)
    yk.check_supported(plan, flags=yd.flags)
    assert yk.refined_groups(plan) == 6
    assert yk._refined_struct(plan).groups == 6
    assert yk.spread_layout(plan, 16, 6, yk.spread_rounds(plan, 16, 6)) \
        == (16, 48)
    for kernel in ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                   "scenario_years"):
        assert yk.refined_entry(kernel, plan, yd.flags) == \
            kernel + "_strict_wide"
        # launched from csrc/strict_wide_kernel.cu's library
        assert yk.refined_launcher("greb_" + kernel, plan) == \
            "greb_" + kernel + "_strict_wide"
    for kind in yk.KINDS:
        lay = yk.block_layout(plan, 16, kind)
        assert (lay.groups, lay.rows, lay.nbytes) == (6, 4, 196704)
        yd.cache[("wide capacity", kind)] = 7
    assert my._member_launches(yd, "fluxcorr", 2) == [(0, 1), (1, 2)]


def test_xla_scenario_after_its_spinup_is_not_finite(runs):
    """Why K2 starts from the initial state with zero corrections here and
    in the card checks on this 2-step calendar: ``greb_tpu``'s own XLA K2
    year from its K1's end state with K1's tables at 680 ppm does not stay
    finite (ts and q overflow at a few hundred cells), as the port's does
    not.  A property of the model on a 2-step calendar, not of the port."""
    jm, (js, jcorr), _ = runs[1].result()
    _, fcdata = jm._fastcirc_split()
    s, mon, _ = jm._year_scenario(True)(js, jm.sfx, jcorr, jnp.float32(680.0),
                                        jm.md, fcdata)
    assert all(np.isfinite(np.asarray(getattr(js, k))).all()
               for k in ("ts", "ta", "to", "q", "cap_surf"))
    assert not np.isfinite(np.asarray(s.ts)).all()
    assert not np.isfinite(np.asarray(mon)).all()


def test_k1_matches_xla(runs, k1_port):
    _, (js, jcorr), _ = runs[1].result()
    s, corr = k1_port
    for name, (rtol, atol) in TOL.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K1 {name}")
    for name, atol in TOL_CORR.items():
        _close(getattr(corr, name), getattr(jcorr, name), 0, atol,
               f"K1 {name}")


def test_k2_matches_xla(runs, k2_port):
    m = runs[0]
    _, _, (js, jmon, _) = runs[1].result()
    s, outs, asum = k2_port
    for name, (rtol, atol) in TOL_YEARS.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K2 {name}")
    from greb_tpu_torch.model import core
    mon = core.monthly_means(m.month_mat, outs)
    for v, name in enumerate(("ts", "ta", "to", "q")):
        _close(mon[:, v], np.asarray(jmon)[:, v], 0, TOL[name][1],
               f"K2 monthly {name}")
    assert np.isfinite(_np(asum)).all()
    _close(asum[:5], outs.sum(0), 1e-5, 0, "K2 annual sums")


def test_member_kernels_at_m1_equal_single_run(runs, k1_port, k2_port):
    """K4 at M=1 with the base params is K1's year bit for bit, and K3's
    one year K2's (state, annual sums): the plain versions run the same
    steps, as the wide kernels run the same body."""
    s4, c4 = runs[2]["k4"].result()
    s3, mon, a3 = runs[2]["k3"].result()
    s1, c1 = k1_port
    assert np.isfinite(_np(s4)).all() and np.isfinite(_np(c4)).all()
    np.testing.assert_array_equal(_np(s4[:, 0]), _np(s1.stack()))
    for k, name in enumerate(("tf", "tof", "qf")):
        np.testing.assert_array_equal(_np(c4[0, :, k]),
                                      _np(getattr(c1, name)), name)
    s2, _, a2 = k2_port
    assert tuple(mon.shape) == (1, 1, 5, 384, 768)
    assert np.isfinite(_np(s3)).all() and np.isfinite(_np(a3)).all()
    np.testing.assert_array_equal(_np(s3[:, 0]), _np(s2.stack()))
    np.testing.assert_array_equal(_np(a3[0, 0]), _np(a2))


def test_year_work_768x384_by_hand(runs):
    """K1/K2's year and K3/K4's launch at 768x384 on the full calendar:
    the packed composites' 56 rows at their ranks (Rtot 12,886), counted
    once a year as every input is (a substep reads U_all and W_all, 79 MB
    together, again: more than the L2 holds, but the bound counts what
    the year must move), and each segment's iterations."""
    plan, const = runs[0].fold
    _, ranks = yk.packed_ranks(const)
    rtot = int(ranks.sum())
    num = Numerics(xdim=768, ydim=384, dt_crcl=450)   # the full calendar
    assert num.nsub_crcl == 96
    yx, t, X = 384 * 768, 730, 768
    seg_ops = 2 * X * ((54 + 30 + 20 + 12 + 8 + 6 + 2) * 17   # diffusion
                       + 4 * 17 + 2 * 47)                      # advection
    comp_ops = 4 * X * rtot + 56 * X * 4
    sub = 2 * yx * 41 + comp_ops + seg_ops
    words = (5 * yx + 8 * t * yx + t * 384 + 5 * yx + 25 * 2 * yx
             + (2 * X * rtot + 2 * 56) + 5 * yx + 3 * t * yx)
    assert 4 * (2 * X * rtot) == 79_171_584    # U_all and W_all
    flux = yk.year_work(plan, num, False, ranks)
    assert flux == (4 * words, t * (96 * sub + 2 * yx * 21 + yx * 125))
    assert yk.year_work(plan, num, True, ranks) == (
        4 * (words + 5 * t * yx + 9 * yx),
        t * (96 * sub + 2 * yx * 21 + yx * 134))
    shared = (8 * t * yx + t * 384 + 5 * yx + 25 * 2 * yx
              + 2 * X * rtot + 2 * 56)
    member = 10 * yx + my.N_PPACK
    assert my.years_work(plan, num, 1, 1, "fluxcorr", ranks=ranks) == (
        4 * (shared + member + 3 * t * yx), flux[1])
    k3 = yk.year_work(plan, num, True, ranks)[1] + 10 * t * yx
    assert my.years_work(plan, num, 2, 1, "scenario", ranks=ranks) == (
        4 * (shared + member + 2 * 3 * t * yx + 2 + 2 * t
             + 2 * (12 * 5 + 9) * yx), 2 * k3)
