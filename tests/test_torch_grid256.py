"""256x128 and the grids between 192x96 and 384x192 in the port, on the CPU.

At dt_crcl=1800 the grids 224x112, 256x128, 288x144, 320x160 and 352x176
lie inside the reference's envelope (additive zonal splitting, no
seq_zonal), with packed SVD pole composites and explicit polar diffusion
and advection segments; greb_tpu runs the first three through its Pallas
kernels (``GREB._pallas_viable``).  On the card all four kernels run them
in the refined instantiation's additive packed form, and the strict
transport, whose K3 block the cluster body does not hold there, in its
strict additive form (csrc/band_kernel.cu, ``year_kernel.is_refined``);
these tests hold their plain versions and their routing.  Inputs are the
96x48 synthetic forcing of tests/test_torch_grid192.py's 20-step calendar
(two months) regridded by the port's regrid.py, the same arrays for the
port and greb_tpu (on its XLA path, ``JAX_PLATFORMS=cpu``).

* One strict substep and the strict diffusion and advection at 256x128
  against greb_tpu's stencils on seeded fields (tests/test_torch_stencils.py's
  Case) at tests/test_torch_stencils.py's tolerance for the port against
  greb_tpu: rtol 1e-5, atol 1e-6 of the field.  The fold's substep at 256x128 is in
  tests/test_torch_fold.py's GRIDS.
* The plain K1 and K2 years, and the plain K4 and K3 at M=2 (ct_sens 22.05
  and 22.95; K3 over two years with a table per member), against
  greb_tpu's XLA years (``GREB._year_fluxcorr``, ``_year_scenario(True)``),
  each member under its own params.  The spin-up at the golden tolerances
  (tests/test_golden_year.py:29: temperatures 2e-2 K, q 3e-6), cap_surf at
  rtol 1e-3, the tables at tf 0.5 W/m^2, tof 1e-5 K, qf 1e-6
  (tests/test_torch_grid192.py's).  The scenario years run free from the
  spin-up's end on 18-day steps, and the two frameworks' float32 rounding
  grows at a few sea-ice ramp cells, so they are held at ``TOL_YEARS``,
  tests/test_torch_grid192.py's: temperatures and albedo at the golden
  tolerances, q 3e-5 and cap_surf rtol 2e-2; K3's Ts at three sea-ice
  ramp cells of the two members at 1e-1 (``RAMP_CELLS``: one ulp of
  greb_tpu's own Ts there moves its own years as far).
* What the TPU kernels run: greb_tpu's ``_pallas_viable`` is True at
  224x112, 256x128 and 288x144 for the fold and the strict transport,
  False at 320x160.
* What the port runs, without a card: ``check_supported`` admits every
  kind under the fold, a legacy fold word (log_exp 11), the strict
  circulation and the no-transport word (log_exp 4) at all five grids;
  the routing to the two forms and their entries; the two layouts' bytes,
  reckoned here by hand as csrc/year_kernel.cu reckons them
  (``refined_parts``, ``strict_refined_parts``); ``year_work``'s count of
  the packed ranks and the segments with additive splitting; the member
  wrappers' 16-block clusters.
* Sharding: the plain sharded runners on 4 shards (the pole shards hold
  the packed composite rows and the segments) bitwise equal to the plain
  unsharded years; what a mesh of CUDA devices runs here, without a card:
  the slab kernels' additive packed form for the pole shards' fold and
  the strict additive form for the strict transport, whose layouts are
  reckoned by hand, accepted before any launch; the strict transport at
  768x384 refused, naming ROADMAP Queue 1 item 3j.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import forcing_from_arrays as jforcing_from_arrays
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops import stencils as jst

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections, forcing_from_arrays
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc as fc
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops import stencils as st
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import slab
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens
from greb_tpu_torch.parallel import sharded as sh
from greb_tpu_torch.regrid import regrid_forcing_arrays
from tests.test_torch_stencils import KAPPA, Case

# One intra-op thread, one BLAS thread: more only contend with the other
# test workers.
torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only
    threadpool_limits = None

F32 = np.float32
# tests/test_torch_grid192.py's 20-step calendar at 256x128
CALENDAR = dict(dt_crcl=1800, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
                time_scnr=1)
NUM = dict(xdim=256, ydim=128, **CALENDAR)
TOL = dict(ts=(0, 2e-2), ta=(0, 2e-2), to=(0, 2e-2), q=(0, 3e-6),
           cap_surf=(1e-3, 0))
TOL_CORR = dict(tf=0.5, tof=1e-5, qf=1e-6)
TOL_YEARS = dict(TOL, q=(0, 3e-5), cap_surf=(2e-2, 0))
# the monthly means of the scenario years: Ts, Ta, To, q, albedo
TOL_MONTHLY = (2e-2, 2e-2, 2e-2, 3e-5, 5e-4)
CT_SENS = (22.05, 22.95)
# each member's sea-ice ramp cells (row, column), where the port's and
# greb_tpu's two scenario years part by more than 2e-2 K in Ts (2.27e-2 to
# 7.14e-2, monthly or at the end), as one ulp of greb_tpu's own Ts there
# (up: 1, down: -1) parts its years from themselves
# (``test_ramp_cells_are_rounding``), and the Ts tolerance there
RAMP_CELLS = {22.05: {(25, 139): 1}, 22.95: {(27, 68): -1, (27, 169): -1}}
TOL_RAMP_TS = 1e-1
# the band's grids (xdim, ydim)
BAND = ((224, 112), (256, 128), (288, 144), (320, 160), (352, 176))
KERNELS = ("fluxcorr_year", "scenario_year", "fluxcorr_years",
           "scenario_years")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol, atol, name):
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all(), f"{name}: port not finite"
    assert np.isfinite(want).all(), f"{name}: reference not finite"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _limits():
    return threadpool_limits(1) if threadpool_limits \
        else contextlib.nullcontext()


def _arrays(xdim, ydim):
    """The 96x48 synthetic forcing of the calendar, regridded."""
    num = Numerics(xdim=xdim, ydim=ydim, **CALENDAR)
    return regrid_forcing_arrays(
        make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num)


def _plan(xdim, ydim):
    """The fold's plan as the port's fold build leaves it (make_plan's
    "lowrank" composites packed, fastcirc2.build_const)."""
    plan = fc.make_plan(make_grid(xdim, ydim, 1800))
    assert plan.comp_mode == "lowrank" and not plan.seq_zonal
    return dataclasses.replace(plan, comp_mode="packed")


@pytest.fixture(scope="module")
def arrs():
    return _arrays(256, 128)


@pytest.fixture(scope="module")
def fold_pair(arrs):
    with _limits():
        jm = JGREB(JConfig(numerics=JNumerics(**NUM), fast_circulation=True),
                   forcing=jforcing_from_arrays(arrs), verbose=False)
        m = GREB(GrebConfig(numerics=Numerics(**NUM), fast_circulation=True),
                 forcing=forcing_from_arrays(arrs, "cpu"), verbose=False,
                 device="cpu")
    return jm, m


def test_plan_is_the_additive_packed_form(fold_pair):
    jm, m = fold_pair
    plan = m.fold[0]
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jm.fastcirc_tables()[0])
    assert plan == _plan(256, 128)
    assert (plan.comp_kt, plan.comp_kb) == (3, 3)
    assert plan.diff_segs == ((5, 5, 1), (3, 3, 1), (2, 2, 2), (1, 1, 3))
    assert plan.adv_segs == ((3, 3, 1), (2, 2, 1), (1, 1, 6))
    assert yk.is_refined(plan) and m.year_data.flags == 0
    assert yk.refined_form(plan) == "additive_packed"
    _, ranks = yk.packed_ranks(m.fold[1])
    assert len(ranks) == 12 and int(ranks.sum()) == m.fold[1].pcu.shape[1]


# ---------------------------------------------------------------------------
# the strict stencils at 256x128
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def case():
    return Case(256, 128, steps=(0,))


@pytest.mark.parametrize("field", ["ta", "q"])
def test_strict_diffusion_and_advection(case, field):
    """rtol 1e-5, atol 1e-6 of the field (tests/test_torch_stencils.py):
    the two packages group the float32 operations apart, and a tendency
    of ~10 K a step differs by up to 2.8e-5 K at a few cells."""
    assert not case.st.seq_zonal and case.st.compact_polar
    x, wz = case.x[field], case.wz[field]
    jpack = jst.make_wz_pack(jnp.asarray(wz), case.jst, jst.extend_lat_zero)
    tw = torch.as_tensor(wz)
    pack = st.make_wz_pack(tw, case.st)
    want = jst.diffusion(jnp.asarray(x), jnp.asarray(wz), jpack, case.jst,
                         case.jsf, KAPPA)
    got = st.diffusion(torch.as_tensor(x), tw, pack, case.st, case.sf, KAPPA)
    atol = 1e-6 * float(np.abs(x).max())
    _close(got, want, 1e-5, atol, f"diffusion[{field}]")
    want = jst.advection(jnp.asarray(x), jpack, *case.jwinds(0), case.jst,
                         case.jsf)
    got = st.advection(torch.as_tensor(x), pack, *case.pwinds(0), case.st,
                       case.sf)
    _close(got, want, 1e-5, atol, f"advection[{field}]")


def test_strict_substep(case):
    """One substep of the strict circulation, (Ta, q) batched: rtol 1e-5,
    atol 1e-6 of the field (tests/test_torch_stencils.py)."""
    x2 = np.stack([case.x["ta"], case.x["q"]])
    wz2 = np.stack([case.wz["ta"], case.wz["q"]])
    want = np.asarray(jst.circulation(jnp.asarray(x2), jnp.asarray(wz2),
                                      *case.jwinds(0), case.jst, case.jsf,
                                      KAPPA, 1))
    got = st.circulation(torch.as_tensor(x2), torch.as_tensor(wz2),
                         *case.pwinds(0), case.st, case.sf, KAPPA, 1)
    for i, field in enumerate(("ta", "q")):
        _close(got[i], want[i], 1e-5, 1e-6 * float(np.abs(x2[i]).max()),
               f"substep[{field}]")


# ---------------------------------------------------------------------------
# the plain years against greb_tpu's XLA years
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xla_years(fold_pair):
    """greb_tpu's XLA years at 256x128 under the base params and under each
    of ``CT_SENS``: the spin-up at 340 ppm from the initial state, then two
    scenario years at 680 ppm from its end state with its tables."""
    jm, _ = fold_pair
    _, fcdata = jm._fastcirc_split()
    mds = {None: jm.md}
    mds.update({v: jm.md.replace(params=jm.params.replace(
        ct_sens=jnp.float32(v))) for v in CT_SENS})
    got = {}
    for key, md in mds.items():
        s1, c1 = jm._year_fluxcorr()(jm.initial_state(), jm.sfx,
                                     jnp.float32(340.0), md, fcdata)
        s, mons = s1, []
        for _ in range(2):
            s, mon, _ = jm._year_scenario(True)(s, jm.sfx, c1,
                                                jnp.float32(680.0), md,
                                                fcdata)
            mons.append(np.asarray(mon))
        got[key] = dict(spinup=(s1, c1), state=s, monthly=mons)
    return got


def test_k1_k2_plain_match_xla(fold_pair, xla_years):
    from greb_tpu_torch.model import core
    _, m = fold_pair
    want = xla_years[None]
    s, corr = yk.fluxcorr_year(m.initial_state(), 340.0, m.year_data)
    js, jcorr = want["spinup"]
    for name, (rtol, atol) in TOL.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K1 {name}")
    for name, atol in TOL_CORR.items():
        _close(getattr(corr, name), getattr(jcorr, name), 0, atol,
               f"K1 {name}")
    s2, outs, asum = yk.scenario_year(s, corr, 680.0, m.year_data)
    s2x, _, _ = yk.scenario_year(s2, corr, 680.0, m.year_data)
    for name, (rtol, atol) in TOL_YEARS.items():
        _close(getattr(s2x, name), getattr(want["state"], name), rtol, atol,
               f"K2 twice {name}")
    mon = core.monthly_means(m.month_mat, outs)
    for v, atol in enumerate(TOL_MONTHLY):
        _close(mon[:, v], want["monthly"][0][:, v], 0, atol,
               f"K2 monthly {v}")
    _close(asum[:5], outs.sum(0), 1e-5, 0, "K2 annual sums")


def test_k4_k3_plain_members_match_xla(fold_pair, xla_years):
    """K4 at M=2 from the members' initial states, then K3 at M=2 over two
    years from K4's end with K4's tables, each member against greb_tpu's
    years under its params."""
    _, m = fold_pair
    members = ens.perturbed_params(m.params,
                                   {"ct_sens": np.float32(CT_SENS)})
    pp = my.pack_member_params(members)
    s4, c4 = my.fluxcorr_years(ens.ensemble_initial_state(members, m.forcing),
                               pp, 340.0, m.year_data)
    assert tuple(c4.shape) == (2, 20, 3, 128, 256)
    s3, mon, asum = my.scenario_years(s4, pp, c4, [680.0, 680.0],
                                      m.year_data)
    assert tuple(mon.shape) == (2, 4, 5, 128, 256)
    assert np.isfinite(_np(asum)).all()
    for i, v in enumerate(CT_SENS):
        want = xla_years[v]
        js, jcorr = want["spinup"]
        for k, (name, (rtol, atol)) in enumerate(TOL.items()):
            _close(s4[k, i], getattr(js, name), rtol, atol,
                   f"K4 member {i} {name}")
        for k, (name, atol) in enumerate(TOL_CORR.items()):
            _close(c4[i, :, k], getattr(jcorr, name), 0, atol,
                   f"K4 member {i} {name}")
        jmon = np.concatenate(want["monthly"])
        got_s, got_m = _np(s3[:, i]).copy(), _np(mon[i]).copy()
        want_s = np.stack([np.asarray(getattr(want["state"], name))
                           for name in TOL_YEARS])
        for cell in RAMP_CELLS[v]:
            for got, ref, at in ((got_s, want_s, (0,) + cell),
                                 (got_m, jmon, (slice(None), 0) + cell)):
                _close(got[at], ref[at], 0, TOL_RAMP_TS,
                       f"K3 member {i} Ts at ramp cell {cell}")
                got[at] = ref[at]
        for k, (name, (rtol, atol)) in enumerate(TOL_YEARS.items()):
            _close(got_s[k], want_s[k], rtol, atol, f"K3 member {i} {name}")
        for v_, atol in enumerate(TOL_MONTHLY):
            _close(got_m[:, v_], jmon[:, v_], 0, atol,
                   f"K3 member {i} monthly {v_}")
    assert not torch.equal(mon[0], mon[1])


def test_ramp_cells_are_rounding(fold_pair, xla_years):
    """greb_tpu alone: a member's two scenario years from its spin-up, and
    the same with Ts at one of its ramp cells moved one ulp at the
    spin-up's end, part there by more than 1e-2 K in a monthly Ts or the
    end state's, the order of the port's difference from greb_tpu there
    (measured: one ulp moves (25, 139) by 2.32e-2 K and (27, 68) by
    7.14e-2, the port's very differences, and (27, 169) by 1.83e-2 where
    the port differs by 2.27e-2)."""
    jm, _ = fold_pair
    _, fcdata = jm._fastcirc_split()
    for v, cells in RAMP_CELLS.items():
        md = jm.md.replace(params=jm.params.replace(ct_sens=jnp.float32(v)))
        s1, c1 = xla_years[v]["spinup"]
        for cell, way in cells.items():
            ts = np.array(s1.ts)
            ts[cell] = np.nextafter(ts[cell], np.float32(way * np.inf))
            s, mons = s1.replace(ts=jnp.asarray(ts)), []
            for _ in range(2):
                s, mon, _ = jm._year_scenario(True)(s, jm.sfx, c1,
                                                    jnp.float32(680.0), md,
                                                    fcdata)
                mons.append(np.asarray(mon))
            at = (slice(None), 0) + cell
            moved = max(np.abs(np.concatenate(mons)[at] - np.concatenate(
                xla_years[v]["monthly"])[at]).max(),
                abs(float(s.ts[cell]) - float(xla_years[v]["state"].ts[cell])))
            assert moved > 1e-2, (v, cell)


# ---------------------------------------------------------------------------
# which of the band's grids the TPU kernels run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fast", (True, False), ids=("fold", "strict"))
@pytest.mark.parametrize("grid, viable", [((224, 112), True),
                                          ((256, 128), True),
                                          ((288, 144), True),
                                          ((320, 160), False)],
                         ids=lambda g: "x".join(map(str, g))
                         if isinstance(g, tuple) else str(g))
def test_greb_tpu_runs_its_pallas_kernels(grid, viable, fast):
    """greb_tpu's own gate (greb_tpu/model/driver.py ``_pallas_viable``):
    its fused year kernels run 224x112 to 288x144 under the fold and the
    strict transport; 320x160 falls back to XLA.  The port runs all of
    them on the card."""
    num = JNumerics(xdim=grid[0], ydim=grid[1], **CALENDAR)
    with _limits():
        jm = JGREB(JConfig(numerics=num, fast_circulation=fast),
                   forcing=jforcing_from_arrays(_arrays(*grid)),
                   verbose=False)
        assert jm._pallas_viable() is viable


# ---------------------------------------------------------------------------
# what the wrappers run at the band's grids (no card, no JAX)
# ---------------------------------------------------------------------------
STRICT_FLAGS = yk.experiment_flags(Experiment(), True)
LEGACY_FLAGS = yk.experiment_flags(Experiment(11))
NONE_FLAGS = yk.experiment_flags(Experiment(4))


@pytest.mark.parametrize("grid", BAND, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_kind_runs_every_word(grid):
    """The fold, a legacy fold word, the strict circulation and the
    no-transport word: every kind accepts them (no NotImplementedError, no
    ValueError), the fold in the additive packed form, the strict
    transport and no transport in the strict additive form, each kernel's
    entries named as the launchers pick them."""
    plan, strict = _plan(*grid), yk.StrictPlan(grid[1], grid[0])
    for p, flags in ((plan, 0), (plan, LEGACY_FLAGS), (strict, STRICT_FLAGS),
                     (strict, NONE_FLAGS)):
        yk.check_supported(p, flags=flags)
        for kind in yk.KINDS:
            yk.check_plan(p, kind, flags)
            assert yk.offered_sizes(kind, p) == yk.REFINED_CLUSTER_SIZES
        assert yk.is_refined(p)
    assert yk.refined_form(plan) == "additive_packed"
    assert yk.refined_form(strict) == "strict_additive"
    for kernel in KERNELS:
        assert yk.refined_entry(kernel, plan, 0) == kernel + "_additive_packed"
        assert yk.refined_entry(kernel, plan, LEGACY_FLAGS) == \
            kernel + "_additive_packed_legacy"
        for flags in (STRICT_FLAGS, NONE_FLAGS):
            assert yk.refined_entry(kernel, strict, flags) == \
                kernel + "_strict_additive"
        assert yk.refined_launcher("greb_" + kernel, plan) == \
            "greb_" + kernel + "_band"
        with pytest.raises(ValueError, match="no refined kernel"):
            yk.refined_entry(kernel, plan, STRICT_FLAGS)


def test_the_cluster_body_keeps_192x96_and_96x48():
    """Where the cluster body holds the strict transport's K3 (192x96 and
    below), all four kernels keep it, as before the strict additive form."""
    for ydim, xdim in ((96, 192), (48, 96)):
        strict = yk.StrictPlan(ydim, xdim)
        assert not yk.is_refined(strict)
        yk.check_supported(strict, flags=STRICT_FLAGS)
        for kind in yk.KINDS:
            assert yk.block_layout(strict, 16, kind) == yk.cluster_layout(
                strict, 16, kind)
    # at 224x112 the cluster body would hold K1 and K2 but not K3
    strict = yk.StrictPlan(112, 224)
    yk.cluster_layout(strict, 16, "scenario")
    with pytest.raises(ValueError, match="241248 B"):
        yk.cluster_layout(strict, 16, "scenario_years")


# the blocks' rows (R), the most composite rows a block holds (kmax) and
# the most rows of one scratch user a block holds (diffusion segments,
# composites, advection segments: at these grids blocks 0 and 15)
LAYOUT = {(224, 112): (7, 3, 3), (256, 128): (8, 3, 5), (288, 144): (9, 4, 5),
          (320, 160): (10, 5, 5), (352, 176): (11, 6, 6)}
TOTALS = {(224, 112): (75296, 84448), (256, 128): (102432, 106752),
          (288, 144): (124464, 131616), (320, 160): (148528, 159040),
          (352, 176): (180288, 189024)}


@pytest.mark.parametrize("grid", BAND, ids=lambda g: f"{g[0]}x{g[1]}")
def test_layout_bytes(grid):
    """The two forms' blocks on 16 blocks, by hand as the kernel reckons
    them: the additive packed form (refined_parts) holds the (Ta, q) double
    buffer with 2 halo rows each side, wz and dd of its rows, a scratch of
    two buffers of both fields of its largest scratch user (t1 and z of the
    composite rows: z at most X a row) and the composite slots' rank sums
    (2 kmax + 1 words, to 4); the strict additive form
    (strict_refined_parts) the double buffer, wz of both fields with the
    halo rows, the sub-cycles' two buffers of both fields of its rows, and 8
    words a row (4 coefficients, 2 counts, 2 orders)."""
    X, Y = grid
    R, kmax, rows = LAYOUT[grid]
    f = 4
    want = dict(transported=f * 2 * 2 * (R + 4) * X, wz=f * 2 * R * X,
                xa=f * 2 * R * X, scratch=f * 2 * 2 * rows * X,
                comp_index=f * (-(-(2 * kmax + 1) // 4) * 4))
    want_strict = dict(transported=f * 2 * 2 * (R + 4) * X,
                       wz=f * 2 * (R + 4) * X, xz=0,
                       subcycle=f * 2 * 2 * R * X,
                       rowc=f * (-(-8 * R // 4) * 4))
    plan, strict = _plan(X, Y), yk.StrictPlan(Y, X)
    for kind in yk.KINDS:
        lay = yk.refined_layout(plan, 16, kind)
        assert (lay.rows, lay.comp_rows, lay.threads) == (R, kmax, 1024)
        assert dict(lay.parts) == want
        assert yk.block_layout(plan, 16, kind) == lay
        s_lay = yk.strict_refined_layout(strict, 16, kind)
        assert dict(s_lay.parts) == want_strict
        assert yk.block_layout(strict, 16, kind) == s_lay
        assert (lay.nbytes, s_lay.nbytes) == TOTALS[grid]
        assert s_lay.nbytes <= yk.MAX_SMEM_BYTES


def test_year_work_counts_ranks_and_segments_with_additive_splitting(
        fold_pair):
    """year_work at 256x128 by hand: the additive combine's 4 operations a
    cell (as at 96x48), the packed composites at their ranks (z = t1 U and
    t2 = z W, 2 X r each, and 4 a cell of the 6 rows' clamp and combine
    for 2 fields), each segment's rows, iterations and edges."""
    _, m = fold_pair
    plan, const = m.fold
    _, ranks = yk.packed_ranks(const)
    rtot = int(ranks.sum())
    num = Numerics(xdim=256, ydim=128, dt_crcl=1800)   # the full calendar
    yx, t, X = 128 * 256, 730, 256
    comp_ops = 4 * X * rtot + 2 * 6 * X * 4
    seg_ops = sum(2 * (kt + kb) * X * (it * 15 + 2)
                  for kt, kb, it in plan.diff_segs + plan.adv_segs)
    assert seg_ops == 2 * X * (10 * 17 + 6 * 17 + 4 * 32 + 2 * 47
                               + 6 * 17 + 4 * 17 + 2 * 92)
    sub = 2 * yx * 41 + comp_ops + seg_ops
    words = (5 * yx + 8 * t * yx + t * 128 + 5 * yx + 25 * 2 * yx
             + 2 * X * rtot + 2 * 12 + 5 * yx + 3 * t * yx)
    step = 24 * sub + 2 * yx * 21 + yx * 125
    assert yk.year_work(plan, num, False, ranks) == (4 * words, t * step)


@pytest.mark.parametrize("members", (1, 8, 65))
def test_member_wrappers_launch_16_blocks(fold_pair, members):
    """The fold and the strict transport: one member a 16-block cluster at
    every member count (K3's one-block body holds neither)."""
    _, m = fold_pair
    strict = dataclasses.replace(m.year_data, fold=None, cache={})
    for yd in (m.year_data, strict):
        assert yk.is_refined(yd.plan)
        for kind in my.KINDS:
            assert my._default_cluster_on(yd, kind, members) == 16
    with pytest.raises(ValueError, match=r"clusters of \(16,\)"):
        yk._check_cluster(1, "scenario_years", m.fold[0])


def test_slab_kernels_refuse_additive_packed_plans(fold_pair):
    """What the slab kernels refused here until they had the additive
    packed form (ROADMAP Queue 1 item 5c) they now take, and what stays
    refused, before any launch (no card needed).  On 4 shards the pole
    shards' fold plans (3 packed composite rows and the segments each) run
    in the additive packed form, the middle shards' (no composite row) in
    the additive one, each shard's block reckoned by hand as
    csrc/slab_kernel.cu slab_parts reckons it; the strict transport's
    global plan runs in the strict additive form; both pass
    ``slab.check_slab``.  The strict transport at 768x384 raises naming
    ROADMAP Queue 1 item 3j."""
    _, m = fold_pair
    splan, _ = fc2.build_sharded(None, None, m.grid, m.st, 0, 4, fold=m.fold)
    slab.check_slab(splan.plan, Experiment())
    slab.check_slab(splan.plan, Experiment(11))
    forms = [slab.slab_form(p) for p in splan.plans]
    assert forms == ["additive_packed", "additive", "additive",
                     "additive_packed"]
    for plan in splan.plans:
        R, X = 2, 256
        n = slab.slab_blocks(plan)
        assert n == plan.ydim // R
        ktc, kbc = plan.comp_kt, plan.comp_kb
        dkt = max((s[0] for s in plan.diff_segs), default=0)
        dkb = max((s[1] for s in plan.diff_segs), default=0)
        akt = max((s[0] for s in plan.adv_segs), default=0)
        akb = max((s[1] for s in plan.adv_segs), default=0)
        Y = plan.ydim
        bands = ((0, ktc, Y - kbc, Y),
                 (ktc, ktc + dkt, Y - kbc - dkb, Y - kbc),
                 (0, akt, Y - akb, Y))
        most = [max(len(set(range(b * R, (b + 1) * R))
                        & (set(range(a0, a1)) | set(range(c0, c1))))
                    for b in range(n)) for a0, a1, c0, c1 in bands]
        want = dict(transported=0, wz=4 * 2 * R * X, xa=4 * 2 * R * X,
                    scratch=4 * 2 * 2 * max(most) * X,
                    comp_index=4 * (-(-(2 * most[0] + 1) // 4) * 4))
        assert slab.slab_layout(plan, n) == want
    strict = yk.StrictPlan(128, 256)
    assert slab.slab_form(strict) == "strict_additive"
    slab.check_slab(strict, Experiment())
    assert slab.slab_layout(yk.StrictPlan(32, 256), 16, "strict_additive") \
        == dict(transported=0, wz=4 * 2 * 6 * 256, winds=0,
                subcycle=4 * 2 * 2 * 2 * 256, rowc=4 * 16)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3j"):
        slab.check_slab(yk.StrictPlan(384, 768, seq_zonal=True),
                        Experiment())


def test_sharded_plain_years_equal_unsharded():
    """The plain sharded runners on 4 shards (each shard's plain step in a
    thread, the halo rows exchanged a substep) against the plain unsharded
    spin-up (340 ppm) and scenario year (680 ppm) on a 2-step calendar,
    both from the initial state, the scenario with zero tables (a scenario
    after a spin-up with its tables leaves finite values on no calendar
    this short): states, tables and monthly means bit for bit, the fold cut
    into each shard's rows (``fastcirc2.build_sharded``) and each composite
    row and segment on its pole shard."""
    num = Numerics(xdim=256, ydim=128, dt_crcl=1800, ndays_yr=1,
                   jday_mon=(1,), time_flux=1, time_scnr=1)
    arrs = regrid_forcing_arrays(make_synthetic_forcing(96, 48, 2, 1), num)
    with _limits():
        m = GREB(GrebConfig(numerics=num, fast_circulation=True),
                 forcing=forcing_from_arrays(arrs, "cpu"), verbose=False,
                 device="cpu")
    assert m.fold[0].comp_mode == "packed" and not m.fold[0].seq_zonal
    s0, zero = m.initial_state(), Corrections.zeros(2, 128, 256)
    s1, c1 = core.run_year_fluxcorr(s0, m.sfx, F32(340.0), m.md, num, m.fold)
    s2, outs, _ = core.run_year_scenario(s0, m.sfx, zero, F32(680.0), m.md,
                                         num, m.fold)
    mesh = sh.make_mesh(1, 4, ["cpu"])
    splan, sconst = fc2.build_sharded(None, None, m.grid, m.st, 0, 4,
                                      fold=m.fold)
    fcc = sh.shard_fastcirc(mesh, sconst)
    flux, scnr = sh.make_sharded_year_runners(mesh, m.st, num, m.exp,
                                              m.month_mat, fast_plan=splan)
    st_s, sfx_s, c0_s, md_s = sh.shard_inputs(mesh, False, s0, m.sfx, None,
                                              m.md)
    g1, gc = flux(st_s, sfx_s, F32(340.0), md_s, fcc)
    g2, gmon, _ = scnr(st_s, sfx_s, c0_s, F32(680.0), md_s, fcc)
    g1, gc, g2, gmon = g1.gather(), gc.gather(), g2.gather(), gmon.gather()
    for name in ("ts", "ta", "to", "q", "cap_surf"):
        for got, want in ((g1, s1), (g2, s2)):
            torch.testing.assert_close(getattr(got, name),
                                       getattr(want, name), rtol=0, atol=0,
                                       msg=name)
    for name in ("tf", "tof", "qf"):
        torch.testing.assert_close(getattr(gc, name), getattr(c1, name),
                                   rtol=0, atol=0, msg=name)
    torch.testing.assert_close(gmon, core.monthly_means(m.month_mat, outs),
                               rtol=0, atol=0)
    assert torch.isfinite(g2.ts).all() and torch.isfinite(gmon).all()
