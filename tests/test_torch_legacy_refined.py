"""The legacy switchboard's fold words and the strict transport at the
refined grids (384x192 and 192x96, dt_crcl=1800), on the CPU: the port's
plain versions against ``greb_tpu``, and the kernels' routing of every
word there.

On the card the fold words with switches (log_exp 5, 6, 9, 11, 13-15) run
in the refined instantiation's legacy variant in both its forms
(``*_refined_legacy``, ``*_additive_legacy``), and the strict transport at
384x192 (the strict circulation, log_exp 7, 8, 16, and the no-transport
words of log_exp 0-4, which there have no fold either) in its strict form
(``*_strict_refined``); tests/test_torch_cuda.py and chip_smoke.py hold
those kernels to these plain versions bit for bit.  Here:

* one scenario step and one spin-up step of the port (``core``) under
  log_exp 5, 11 and 15, which together set every fold-word bit, at 192x96
  and 384x192, from a state drawn with numpy from a seed, against
  greb_tpu's at tests/test_torch_legacy.py's step tolerances (rtol 1e-5;
  atol 1e-3 K, q 1e-7, qf 1e-7; cap_surf rtol 1e-3; albedo atol 2e-4),
  tf at tests/test_torch_grid192.py's table tolerance, 0.5 W/m^2: tf =
  (tclim - ts0) cap / dt, and one float32 ulp of ts0 (3.05e-5 K at 273 K)
  is 0.15 W/m^2 at an ocean cell's cap/dt of ~5e3 (measured here: 0.148
  at one cell of 18,432 at 192x96 under log_exp 5, and at 384x192 under
  11, where the two packages' pointwise physics round one ulp apart);
* the plain K1 and K2 years at 192x96 under log_exp 11 against
  greb_tpu's XLA years (``GREB._year_fluxcorr``,
  ``GREB._year_scenario(True)``) at tests/test_torch_grid192.py's
  tolerances (the spin-up at the golden ones, ``TOL``; the free-running
  scenario years at ``TOL_YEARS``);
* one step under the no-transport word (log_exp 4) at 384x192 against
  greb_tpu (no circulation, so it is cheap);
* the routing at 384x192: ``check_plan`` and ``check_supported`` accept the
  strict ``StrictPlan`` under each strict and no-transport word,
  ``offered_sizes`` is (16,), the member wrappers launch 16 blocks at
  every M, and K3's one-block body still refuses the strict transport
  (ROADMAP Queue 2 item 4); the strict form's layout and ``year_work``
  worked out by hand.

Whole-step parity under the strict transport at 384x192 stays out of
these tests: its plain step runs 1652 rounds of the diffusion sub-cycle
at each pole row in each of its 24 substeps, minutes on one CPU thread.
Its substep is held to greb_tpu in tests/test_torch_stencils.py (one
substep at 384x192, with sequential splitting and the deep sub-cycles).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greb_tpu.config import Experiment as JExperiment
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import ModelState as JState
from greb_tpu.forcing import forcing_from_arrays as jforcing_from_arrays
from greb_tpu.model import core as jcore
from greb_tpu.model.driver import GREB as JGREB

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import ModelState, forcing_from_arrays
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops import stencils as stc
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.regrid import regrid_forcing_arrays

# One intra-op thread, one BLAS thread: more only contend with the other
# test workers.
torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only
    threadpool_limits = None

# tests/test_torch_grid192.py's 20-step calendar of two months, 24
# substeps a step, at both refined grids
NUM = {192: dict(xdim=192, ydim=96, dt_crcl=1800, ndays_yr=10,
                 jday_mon=(6, 4), time_flux=1, time_scnr=1)}
NUM[384] = dict(NUM[192], xdim=384, ydim=192)
# log_exp 5 (flags 0x17), 11 (0x30), 15 (0x54): every fold-word bit
FOLD_WORDS = (5, 11, 15)
STEP_TOL = dict(ts=1e-3, ta=1e-3, to=1e-3, q=1e-7)
# tests/test_torch_grid192.py's year tolerances
TOL = dict(ts=(0, 2e-2), ta=(0, 2e-2), to=(0, 2e-2), q=(0, 3e-6),
           cap_surf=(1e-3, 0))
TOL_CORR = dict(tf=0.5, tof=1e-5, qf=1e-6)
TOL_YEARS = dict(TOL, q=(0, 3e-5), cap_surf=(2e-2, 0))
TOL_MONTHLY = (2e-2, 2e-2, 2e-2, 3e-5, 5e-4)
SEED = 20240611


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


@pytest.fixture(scope="module")
def arrs():
    """The 96x48 synthetic forcing of the calendar, regridded to each
    refined grid."""
    out = {}
    for x, kw in NUM.items():
        num = Numerics(**kw)
        out[x] = regrid_forcing_arrays(
            make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num)
    return out


def _pair(arrs, x, log_exp, fast=True):
    """greb_tpu's GREB and the port's at grid ``x`` on the same regridded
    forcing, with the switchboard at ``log_exp``."""
    with _limits():
        jm = JGREB(JConfig(numerics=JNumerics(**NUM[x]),
                           experiment=JExperiment(log_exp=log_exp),
                           fast_circulation=fast),
                   forcing=jforcing_from_arrays(arrs[x]), verbose=False)
        m = GREB(GrebConfig(numerics=Numerics(**NUM[x]),
                            experiment=Experiment(log_exp),
                            fast_circulation=fast),
                 forcing=forcing_from_arrays(arrs[x], "cpu"), verbose=False,
                 device="cpu")
    return jm, m


def _seeded_state(m):
    """The initial state with seeded perturbations wide enough to cross
    the albedo and sea-ice ramps (tests/test_torch_legacy.py's)."""
    rng = np.random.default_rng(SEED)
    s = m.initial_state()
    shape = tuple(s.ts.shape)
    return dict(
        ts=_np(s.ts) + rng.uniform(-4.0, 4.0, shape).astype(np.float32),
        ta=_np(s.ta) + rng.uniform(-4.0, 4.0, shape).astype(np.float32),
        to=_np(s.to) + rng.uniform(-1.0, 1.0, shape).astype(np.float32),
        q=_np(s.q) * rng.uniform(0.8, 1.2, shape).astype(np.float32),
        cap_surf=_np(s.cap_surf))


def _fastcirc(jm):
    plan, data = jm._fastcirc_split()
    return None if plan is None else (plan, data[0])


def _steps(jm, m, t=3):
    """One scenario step (zero corrections, 680 ppm) and one spin-up step
    (CO2_ctrl) of both packages from the seeded state at step t:
    ((port state, port outputs, port tables), (greb_tpu's, likewise))."""
    st = _seeded_state(m)
    fx = jax.tree.map(lambda a: a[t], jm.sfx)
    zero = np.zeros_like(st["ts"])
    jstate = JState(**{k: jnp.asarray(v) for k, v in st.items()})
    state = ModelState(**{k: torch.as_tensor(v) for k, v in st.items()})
    co2 = np.float32(m.exp.co2_ctrl)
    with _limits():
        js, jout = jcore.scenario_step(
            jstate, fx, (jnp.asarray(zero),) * 3, jnp.float32(680.0), jm.md,
            jm.st, jm.num, jm.exp, fastcirc=_fastcirc(jm))
        jf, jtab = jcore.fluxcorr_step(jstate, fx, jnp.float32(co2), jm.md,
                                       jm.st, jm.num, jm.exp,
                                       fastcirc=_fastcirc(jm))
        s, out = core.scenario_step(state, m.sfx.at(t),
                                    (torch.as_tensor(zero),) * 3,
                                    np.float32(680.0), m.md, m.num, m.fold,
                                    m.exp)
        f, tab = core.fluxcorr_step(state, m.sfx.at(t), co2, m.md, m.num,
                                    m.fold, m.exp)
    return (s, out, f, tab), (js, jout, jf, jtab)


def _hold_steps(got, want):
    (s, out, f, tab), (js, jout, jf, jtab) = got, want
    for label, a, b in (("scenario", s, js), ("spin-up", f, jf)):
        for name, atol in STEP_TOL.items():
            _close(getattr(a, name), getattr(b, name), 1e-5, atol,
                   f"{label} {name}")
        _close(a.cap_surf, b.cap_surf, 1e-3, 0, f"{label} cap_surf")
    _close(out.albedo, jout.albedo, 1e-5, 2e-4, "albedo")
    _close(tab[0], jtab[0], 1e-5, TOL_CORR["tf"], "tf")
    _close(tab[2], jtab[2], 1e-5, 1e-7, "qf")


@pytest.mark.parametrize("x", (192, 384))
@pytest.mark.parametrize("log_exp", FOLD_WORDS)
def test_fold_word_steps_match_greb_tpu(arrs, x, log_exp):
    jm, m = _pair(arrs, x, log_exp)
    yd = m.year_data
    assert yd.transport == "fold" and yk.is_refined(yd.plan)
    assert yd.flags == yk.experiment_flags(Experiment(log_exp)) != 0
    _hold_steps(*_steps(jm, m))


def test_fold_words_set_every_bit():
    word = 0
    for e in FOLD_WORDS:
        word |= yk.experiment_flags(Experiment(e))
    fold_bits = [n for n in yk.FLAGS if n not in (
        "circulation_off", "strict_transport", "vapor_circulation_off",
        "vapor_diffusion_only")]
    assert word == sum(1 << yk.FLAGS.index(n) for n in fold_bits) == 0x77


def test_no_transport_step_matches_greb_tpu_at_384(arrs):
    jm, m = _pair(arrs, 384, 4)
    yd = m.year_data
    assert yd.transport == "none" and yd.flags == 0x1f
    assert yd.plan == yk.StrictPlan(192, 384, seq_zonal=True)
    _hold_steps(*_steps(jm, m))


def test_k1_k2_plain_match_xla_under_log_exp_11(arrs):
    """The plain K1 year from the initial state at CO2_ctrl, then two
    scenario years at 680 ppm from its end with its tables, against
    greb_tpu's XLA years at 192x96 under log_exp 11."""
    jm, m = _pair(arrs, 192, 11)
    _, fcdata = jm._fastcirc_split()
    co2 = np.float32(m.exp.co2_ctrl)
    with _limits():
        js, jcorr = jm._year_fluxcorr()(jm.initial_state(), jm.sfx,
                                        jnp.float32(co2), jm.md, fcdata)
        j2, jmon, _ = jm._year_scenario(True)(js, jm.sfx, jcorr,
                                              jnp.float32(680.0), jm.md,
                                              fcdata)
        j3, _, _ = jm._year_scenario(True)(j2, jm.sfx, jcorr,
                                           jnp.float32(680.0), jm.md, fcdata)
        s, corr = yk.fluxcorr_year(m.initial_state(), co2, m.year_data)
        s2, outs, asum = yk.scenario_year(s, corr, 680.0, m.year_data)
        s3, _, _ = yk.scenario_year(s2, corr, 680.0, m.year_data)
    for name, (rtol, atol) in TOL.items():
        _close(getattr(s, name), getattr(js, name), rtol, atol, f"K1 {name}")
    for name, atol in TOL_CORR.items():
        _close(getattr(corr, name), getattr(jcorr, name), 0, atol,
               f"K1 {name}")
    for name, (rtol, atol) in TOL_YEARS.items():
        _close(getattr(s3, name), getattr(j3, name), rtol, atol,
               f"K2 twice {name}")
    mon = core.monthly_means(m.month_mat, outs)
    for v, atol in enumerate(TOL_MONTHLY):
        _close(mon[:, v], np.asarray(jmon)[:, v], 0, atol, f"K2 monthly {v}")
    _close(asum[:5], outs.sum(0), 1e-5, 0, "K2 annual sums")


# ---------------------------------------------------------------------------
# routing at 384x192 (no card, no JAX)
# ---------------------------------------------------------------------------
STRICT = yk.StrictPlan(192, 384, seq_zonal=True)
# the strict circulation, log_exp 7, 8, 16, and the no-transport word
STRICT_WORDS = (0x80, 0x190, 0x290, 0x1d0, 0x1f)


@pytest.mark.parametrize("flags", STRICT_WORDS)
def test_strict_plan_is_accepted_for_every_kind(flags):
    assert yk.is_refined(STRICT) and yk.refined_form(STRICT) == "strict"
    yk.check_supported(STRICT, flags=flags)
    for kind in yk.KINDS:
        yk.check_plan(STRICT, kind, flags)
        assert yk.offered_sizes(kind, STRICT) == (16,)
        assert yk.block_layout(STRICT, 16, kind) == \
            yk.strict_refined_layout(STRICT, 16, kind)
    assert yk._refined_struct(STRICT).form == yk.REFINED_FORMS.index(
        "strict")


def test_strict_refined_layout_bytes():
    """12 rows of 384 columns a block on 16 blocks: the (Ta, q) double
    buffer with its 2 halo rows each side (2 x 2 x 16 x 384 words), wz of
    both fields with the same halo rows (2 x 16 x 384), no xz, the
    sub-cycles' two (2, 12, 384) buffers, 6 words of constants a row (72,
    a multiple of 4)."""
    for kind in yk.KINDS:
        lay = yk.strict_refined_layout(STRICT, 16, kind)
        assert (lay.rows, lay.comp_rows, lay.threads) == (12, 0, 1024)
        assert dict(lay.parts) == dict(transported=98304, wz=49152, xz=0,
                                       subcycle=73728, rowc=288)
        assert lay.nbytes == 221472 <= yk.MAX_SMEM_BYTES
        assert yk.refined_layout(STRICT, 16, kind) == lay
    # 8 and 12 blocks do not fit; 768x384 does not either, and runs in
    # the strict form's wide variant on 6 clusters
    for blocks in (8, 12):
        with pytest.raises(ValueError, match="over 232448 B"):
            yk.strict_refined_layout(STRICT, blocks, "scenario")
    wide = yk.StrictPlan(384, 768, seq_zonal=True)
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.strict_refined_layout(wide, 16, "scenario")
    yk.check_supported(wide, flags=0x80)
    assert yk.refined_groups(wide) == 6
    assert yk.refined_entry("scenario_year", wide, 0x80) == \
        "scenario_year_strict_wide"


def test_strict_plan_with_unsubcycled_rows_is_refused():
    rows = tuple([1] * 191 + [-1])
    plan = yk.StrictPlan(192, 384, seq_zonal=True, sub_cycles=(rows, rows))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3d"):
        yk.check_plan(plan, "scenario", 0x80)


@pytest.fixture(scope="module")
def strict_model(arrs):
    with _limits():
        return GREB(GrebConfig(numerics=Numerics(**NUM[384]),
                               fast_circulation=False),
                    forcing=forcing_from_arrays(arrs[384], "cpu"),
                    verbose=False, device="cpu")


def test_strict_model_plan_carries_its_sub_cycles(strict_model):
    yd = strict_model.year_data
    assert yd.transport == "strict" and yd.flags == 0x80
    assert yd.plan == STRICT          # the counts are not compared
    nd, na = yd.plan.sub_cycles
    assert (nd, na) == tuple(tuple(c.tolist()) for c in stc.sub_cycles(
        strict_model.st, strict_model.sf))
    # every row sub-cycles both; the advection's counts follow the
    # forcing's row winds (grid.make_grid's u_rowmax)
    assert nd[:6] == (1652, 184, 67, 34, 21, 14) and nd == nd[::-1]
    assert na[:3] == (5, 2, 1) and na == na[::-1]
    assert min(nd) == min(na) == 1


def test_forced_strict_run_at_384(strict_model):
    """``year_kernel._forced``, which the card's checks use to hold one
    strict run against another: a ``YearData`` of the same run whose plan
    forces 2 clusters a run (the strict wide form, ``*_strict_wide`` from
    csrc/strict_wide_kernel.cu) or 4 rounds between the spread's exchanges
    (the one-cluster form's), the run's own plan and cache untouched, and a
    force the layout does not hold refused."""
    yd = strict_model.year_data
    own = yd.plan
    two = yk._forced(yd, groups=2)
    assert (two.md, two.sfx, two.num, two.exp) == \
        (yd.md, yd.sfx, yd.num, yd.exp)
    assert two.transport == "strict" and two.flags == yd.flags
    assert two.plan == dataclasses.replace(own, _groups=2)
    assert two.plan.sub_cycles == own.sub_cycles
    assert yk.refined_groups(two.plan) == 2 and yk.is_strict_wide(two.plan)
    assert yk.refined_launcher("greb_scenario_years", two.plan) == \
        "greb_scenario_years_strict_wide"
    g = yk._refined_struct(two.plan)
    assert (g.groups, g.spread_k) == (2, 8)
    four = yk._forced(yd, rounds=4)
    g = yk._refined_struct(four.plan)
    assert (g.groups, g.spread_k) == (1, 4)
    assert yk.refined_entry("scenario_year", four.plan, yd.flags) == \
        "scenario_year_strict_refined"
    assert yd.plan is own and yk._refined_struct(own).spread_k == 8
    with pytest.raises(ValueError, match="do not fit"):
        yk._forced(yd, groups=2, rounds=9)


def test_strict_year_work_at_384(strict_model):
    """year_work of the strict form, worked out from the per-row counts:
    a (field, cell) of a row with diffusion count n and advection count a
    takes 35 + 41 n + 33 a operations a substep (STRICT_OPS with one add
    more for sequential splitting), both fields move and advect; 24
    substeps, 20 steps, plus the step body's 125 (+ 9 sums) a cell."""
    m = strict_model
    yd, num = m.year_data, m.num
    nd, na = yd.plan.sub_cycles
    X, Y, T = 384, 192, 20
    per_sub = 2 * X * sum(35 + 41 * n + 33 * a for n, a in zip(nd, na))
    for scen in (False, True):
        nbytes, ops = yk.year_work(yd.plan, num, scen, flags=yd.flags)
        assert ops == T * (24 * per_sub + X * Y * (125 + 9 * scen))
        words = (5 + 8 * T + 6 + 5 + 3 * T + (5 * T + 9) * scen) * X * Y \
            + T * Y + 6 * Y
        assert nbytes == 4 * words
    # log_exp 8: q diffuses only; 16: q does not move; 4: no transport
    q_diff = 2 * X * sum(11 + 41 * n for n in nd) // 2
    ops8 = yk.year_work(yd.plan, num, False, flags=0x290)[1]
    assert ops8 == T * (24 * (per_sub // 2 + q_diff) + X * Y * 125)
    ops16 = yk.year_work(yd.plan, num, False, flags=0x1d0)[1]
    assert ops16 == T * (24 * per_sub // 2 + X * Y * 125)
    assert yk.year_work(yd.plan, num, False, flags=0x1f)[1] == \
        T * X * Y * 125


@pytest.mark.parametrize("members", (1, 8, 65))
def test_member_wrappers_launch_16_blocks(strict_model, members):
    yd = strict_model.year_data
    for kind in my.KINDS:
        assert my._default_cluster_on(yd, kind, members) == 16


def test_one_block_body_still_refuses_the_strict_transport(strict_model):
    m = strict_model
    num = m.num
    s5 = m.initial_state().stack()[:, None]
    pp = my.pack_member_params([m.params])
    cp = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim))
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        my.scenario_years(s5, pp, cp, [680.0], m.year_data, cluster=1)
