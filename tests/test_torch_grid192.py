"""192x96 in the port, on the CPU: against the NumPy oracle and greb_tpu.

At dt_crcl=1800 the 192x96 fold has additive zonal splitting (as 96x48),
explicit polar advection segments ((2, 2, 1), (1, 1, 3)) and dense pole
composites at comp_kt = comp_kb = 5, whose 192x192 matrices the cluster
body cannot hold: on the card all four kernels run it in the refined
instantiation's additive form (``year_kernel.is_refined``), whose plain
versions these tests hold.  Every check runs on the 96x48 synthetic
forcing of a 20-step calendar (two months) regridded by the port's
regrid.py, the same arrays for the port, greb_tpu (on its XLA path,
``JAX_PLATFORMS=cpu``) and the oracle.  (On a 10-step calendar the second
scenario year after a spin-up is not finite at 192x96.)

* One scenario step of the port, under the strict stencils and under the
  fold, against the NumPy oracle (tests/oracle/greb_oracle.py) at
  tests/test_oracle_refined.py's tolerances (ts, ta 2e-3 K, to 1e-3 K, q
  1e-7 and rtol 1e-4, cap_surf 1 J/K/m^2 and rtol 1e-5); the strict step
  against greb_tpu's at tests/test_torch_legacy.py's step tolerances
  (rtol 1e-5; 1e-3 K, q 1e-7; cap_surf rtol 1e-3).
* The plain K1 and K2 years, and the plain K4 and K3 at M=2 (ct_sens
  22.05 and 22.95; K3 two years, a table per member and one shared),
  against greb_tpu's XLA years (``GREB._year_fluxcorr``,
  ``GREB._year_scenario(True)``, as tests/test_torch_refined.py calls
  them), each member under its own params, which is what greb_tpu's
  ``run_ensemble`` computes for it.  The spin-up at the golden tolerances
  (tests/test_golden_year.py:29: temperatures 2e-2 K, q 3e-6), cap_surf
  at rtol 1e-3, the tables at tf 0.5 W/m^2, tof 1e-5 K, qf 1e-6.  The
  scenario years run free from the spin-up's end, and a step of this
  calendar is 18 days: the two frameworks' float32 rounding grows at a
  few sea-ice ramp cells, so they are held at ``TOL_YEARS``: temperatures
  and albedo at the golden tolerances, q 3e-5 and cap_surf rtol 2e-2.
  Measured here, the largest differences: monthly Ts 1.8e-2 K, q 5.5e-6
  (base params) and 1.05e-5 (ct_sens 22.95, one cell), albedo 2.3e-4;
  cap_surf 8.9e-3 relative after two years (one cell).
* ``GREB.run`` end to end (1 + 1 years), its output file read back.
* What the wrappers run and refuse at 192x96 (no card needed): every kind
  accepts the plan, a legacy fold word routes to the additive form's
  legacy variant (refused until ROADMAP Queue 1 item 3f), the refined
  layout's bytes, the member wrappers' size at every M.
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
from greb_tpu.forcing import forcing_from_arrays as jforcing_from_arrays
from greb_tpu.model import core as jcore
from greb_tpu.model.driver import GREB as JGREB

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import ModelState, forcing_from_arrays
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc as fc
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens
from greb_tpu_torch.regrid import regrid_forcing_arrays
from tests.oracle.greb_oracle import GrebOracle, OracleParams

# One intra-op thread, one BLAS thread: more only contend with the other
# test workers.
torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:         # speed only
    threadpool_limits = None

# a 20-step calendar of two months at 192x96, 24 substeps a step
NUM = dict(xdim=192, ydim=96, dt_crcl=1800, ndays_yr=10, jday_mon=(6, 4),
           time_flux=1, time_scnr=1)
TOL = dict(ts=(0, 2e-2), ta=(0, 2e-2), to=(0, 2e-2), q=(0, 3e-6),
           cap_surf=(1e-3, 0))
TOL_CORR = dict(tf=0.5, tof=1e-5, qf=1e-6)
TOL_YEARS = dict(TOL, q=(0, 3e-5), cap_surf=(2e-2, 0))
# the monthly means of the scenario years: Ts, Ta, To, q, albedo
TOL_MONTHLY = (2e-2, 2e-2, 2e-2, 3e-5, 5e-4)
CT_SENS = (22.05, 22.95)


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
    """The 96x48 synthetic forcing of the calendar, regridded to 192x96."""
    num = Numerics(**NUM)
    return regrid_forcing_arrays(
        make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num)


def _port(arrs, fast):
    with _limits():
        return GREB(GrebConfig(numerics=Numerics(**NUM),
                               fast_circulation=fast),
                    forcing=forcing_from_arrays(arrs, "cpu"), verbose=False,
                    device="cpu")


def _jax(arrs, fast):
    with _limits():
        return JGREB(JConfig(numerics=JNumerics(**NUM),
                             fast_circulation=fast),
                     forcing=jforcing_from_arrays(arrs), verbose=False)


@pytest.fixture(scope="module")
def fold_pair(arrs):
    return _jax(arrs, True), _port(arrs, True)


@pytest.fixture(scope="module")
def strict_port(arrs):
    return _port(arrs, False)


@pytest.fixture(scope="module")
def oracle_step(arrs):
    """The oracle's first scenario step at 340 ppm from its initial state
    with zero corrections: (new state, cap_surf)."""
    o = GrebOracle(arrs, OracleParams(), xdim=192, ydim=96)
    new, _ = o.scenario_step(o.initial_state(), 340.0, 0,
                             o.zero_corrections())
    return new, o.cap_surf.copy()


def _first_step(m):
    zero = torch.zeros((96, 192))
    return core.scenario_step(m.initial_state(), m.sfx.at(0), (zero,) * 3,
                              np.float32(340.0), m.md, m.num, m.fold, m.exp)


def test_plan_is_the_additive_form(fold_pair):
    jm, m = fold_pair
    plan = m.fold[0]
    assert plan == fc.make_plan(make_grid(192, 96, 1800))
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jm.fastcirc_tables()[0])
    assert not plan.seq_zonal and plan.comp_mode == "dense"
    assert (plan.comp_kt, plan.comp_kb, plan.diff_segs) == (5, 5, ())
    assert plan.adv_segs == ((2, 2, 1), (1, 1, 3))
    assert yk.is_refined(plan) and m.year_data.flags == 0
    assert tuple(m.fold[1].pcomp.shape) == (2, 10, 192, 192)


@pytest.mark.parametrize("fast", (False, True), ids=("strict", "fold"))
def test_scenario_step_matches_oracle(fold_pair, strict_port, oracle_step,
                                      fast):
    """The port's step (the strict stencils, the fold's plain version)
    against the oracle, all rows, the deep polar bands included."""
    m = fold_pair[1] if fast else strict_port
    new_o, cap_o = oracle_step
    s, _ = _first_step(m)
    _close(s.ts, new_o["ts"], 1e-5, 2e-3, "ts")
    _close(s.ta, new_o["ta"], 1e-5, 2e-3, "ta")
    _close(s.to, new_o["to"], 1e-5, 1e-3, "to")
    _close(s.q, new_o["q"], 1e-4, 1e-7, "q")
    _close(s.cap_surf, cap_o, 1e-5, 1.0, "cap_surf")


def test_strict_step_matches_greb_tpu(arrs, strict_port):
    jm, m = _jax(arrs, False), strict_port
    s, out = _first_step(m)
    zero = jnp.zeros((96, 192))
    js, jout = jcore.scenario_step(
        jm.initial_state(), jax.tree.map(lambda a: a[0], jm.sfx),
        (zero,) * 3, jnp.float32(340.0), jm.md, jm.st, jm.num, jm.exp)
    for name in ("ts", "ta", "to"):
        _close(getattr(s, name), getattr(js, name), 1e-5, 1e-3, name)
    _close(s.q, js.q, 1e-5, 1e-7, "q")
    _close(s.cap_surf, js.cap_surf, 1e-3, 0, "cap_surf")
    _close(out.albedo, jout.albedo, 1e-5, 2e-4, "albedo")


@pytest.fixture(scope="module")
def xla_years(fold_pair):
    """greb_tpu's XLA years at 192x96, each under the params of one of
    ``CT_SENS`` and under the base params: the spin-up at 340 ppm from the
    initial state, then two scenario years at 680 ppm from its end state
    with its tables."""
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


@pytest.fixture(scope="module")
def k4_port(fold_pair):
    """The plain K4 at M=2 from the members' initial states at 340 ppm:
    (pack, state5, tables)."""
    _, m = fold_pair
    members = ens.perturbed_params(m.params,
                                   {"ct_sens": np.float32(CT_SENS)})
    pp = my.pack_member_params(members)
    s4, c4 = my.fluxcorr_years(ens.ensemble_initial_state(members, m.forcing),
                               pp, 340.0, m.year_data)
    return pp, s4, c4


def test_k4_plain_members_match_xla(xla_years, k4_port):
    _, s4, c4 = k4_port
    assert tuple(c4.shape) == (2, 20, 3, 96, 192)
    for i, v in enumerate(CT_SENS):
        js, jcorr = xla_years[v]["spinup"]
        for k, (name, (rtol, atol)) in enumerate(TOL.items()):
            _close(s4[k, i], getattr(js, name), rtol, atol,
                   f"K4 member {i} {name}")
        for k, (name, atol) in enumerate(TOL_CORR.items()):
            _close(c4[i, :, k], getattr(jcorr, name), 0, atol,
                   f"K4 member {i} {name}")
    assert not torch.equal(c4[0], c4[1])


@pytest.mark.parametrize("tables", ("per member", "shared"))
def test_k3_plain_members_match_xla(fold_pair, xla_years, k4_port, tables):
    """K3 at M=2 over two years from K4's end: a table per member (K4's),
    or one shared table (member 0's, so member 0 alone runs greb_tpu's
    years)."""
    _, m = fold_pair
    pp, s4, c4 = k4_port
    tab = c4 if tables == "per member" else c4[:1]
    s3, mon, asum = my.scenario_years(s4, pp, tab, [680.0, 680.0],
                                      m.year_data)
    assert tuple(mon.shape) == (2, 4, 5, 96, 192)
    assert np.isfinite(_np(asum)).all()
    for i in range(2 if tables == "per member" else 1):
        want = xla_years[CT_SENS[i]]
        for k, (name, (rtol, atol)) in enumerate(TOL_YEARS.items()):
            _close(s3[k, i], getattr(want["state"], name), rtol, atol,
                   f"K3 member {i} {name}")
        jmon = np.concatenate(want["monthly"])
        for v, atol in enumerate(TOL_MONTHLY):
            _close(mon[i, :, v], jmon[:, v], 0, atol,
                   f"K3 member {i} monthly {v}")
    assert not torch.equal(mon[0], mon[1])


def test_greb_run_writes_its_output(fold_pair, tmp_path):
    _, m = fold_pair
    out = str(tmp_path / "scenario")
    state, corr, monthly, diags = m.run(output_path=out)
    assert monthly.shape == (1, 2, 5, 96, 192)
    assert np.isfinite(monthly).all() and len(diags) == 1
    assert all(bool(torch.isfinite(getattr(state, n)).all())
               for n in ModelState.FIELDS)
    back = read_output(out, 192, 96)
    np.testing.assert_array_equal(back, monthly.reshape(-1, 5, 96, 192))


# ---------------------------------------------------------------------------
# what the wrappers run at 192x96 (no card, no JAX)
# ---------------------------------------------------------------------------
PLAN = fc.make_plan(make_grid(192, 96, 1800))


def test_every_kind_runs_the_plan():
    yk.check_supported(PLAN)
    for kind in yk.KINDS:
        yk.check_plan(PLAN, kind)
        assert yk.offered_sizes(kind, PLAN) == yk.REFINED_CLUSTER_SIZES
    # the strict transport at 192x96 runs in the cluster body
    strict = yk.StrictPlan(96, 192)
    assert not yk.is_refined(strict)
    yk.check_supported(strict, flags=yk.experiment_flags(Experiment(), True))


@pytest.mark.parametrize("log_exp", (11, 13, 15))
def test_a_legacy_word_is_refused(log_exp):
    """Refused until ROADMAP Queue 1 item 3f: a legacy fold word at 192x96
    is accepted by every kind and routed to the additive form's legacy
    variant (``*_additive_legacy``)."""
    flags = yk.experiment_flags(Experiment(log_exp))
    assert flags
    for kind in yk.KINDS:
        yk.check_plan(PLAN, kind, flags)
    yk.check_supported(PLAN, flags=flags)
    for kernel in ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                   "scenario_years"):
        assert yk.refined_entry(kernel, PLAN, flags) == \
            kernel + "_additive_legacy"
        assert yk.refined_entry(kernel, PLAN, 0) == kernel + "_additive"


def test_refined_layout_bytes():
    """6 rows of 192 columns a block on 16 blocks: the (Ta, q) double
    buffer with its halo rows, wz, dd, and a scratch for the 5 composite
    rows' t1 (blocks 0 and 15: 2 fields) or two buffers of the 2
    advection segment rows; the packed index is unused (48 B)."""
    for kind in yk.KINDS:
        lay = yk.refined_layout(PLAN, 16, kind)
        assert (lay.rows, lay.comp_rows, lay.threads) == (6, 5, 1024)
        assert dict(lay.parts) == dict(
            transported=30720, wz=9216, xa=9216, scratch=15360,
            comp_index=48)
        assert lay.nbytes == 64560
        assert yk.block_layout(PLAN, 16, kind) == lay
    # the one-block body cannot hold a 192x96 member
    assert yk.smem_bytes(PLAN) == 709632
    with pytest.raises(NotImplementedError, match="709632 B"):
        yk.check_block_fit(PLAN)


@pytest.mark.parametrize("members", (1, 8, 65))
def test_member_wrappers_launch_16_blocks(fold_pair, members):
    _, m = fold_pair
    for kind in my.KINDS:
        assert my._default_cluster_on(m.year_data, kind, members) == 16
    with pytest.raises(ValueError, match=r"clusters of \(16,\)"):
        yk._check_cluster(1, "scenario_years", PLAN)
