"""The member-batched multi-year kernels' plain versions against the JAX
package's Pallas kernels (interpret mode) and against the single-year path.

* ``pack_member_params`` equals ``greb_tpu``'s bitwise.
* K3 (``scenario_years_plain``) and K4 (``fluxcorr_years_plain``) against
  ``build_scenario_years`` / ``build_fluxcorr_years`` in interpret mode on
  the tiny calendar of tests/test_pallas.py:19 (48x24, one day, 2 steps, 2
  substeps), M=2 members with perturbed ct_sens, for the JAX kernel's
  members-per-block ``mb`` of 1 and 2 (the port has no ``mb``: members do
  not interact).  Tolerances are tests/test_pallas.py's.
* K3 at M=1 against K2 run year by year, on a 10-day calendar.
* K3 with one correction table that every member reads (1, T, 3, Y, X):
  bitwise equal to the same table copied M times, and against the Pallas
  kernel given those copies (interpret mode, tests/test_pallas.py's
  tolerances).
* The wrappers refuse members that perturb the transport, plans the
  kernels do not run, and a table pack of any leading size but M or 1.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.config import PhysicsParams as JParams
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops.pallas import multiyear as jmy
from greb_tpu.ops.pallas import year_kernel as jyk
from greb_tpu.parallel import ensemble as jens

from greb_tpu_torch.config import GrebConfig, Numerics, PhysicsParams
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

PALLAS_NUM = dict(xdim=48, ydim=24, ndays_yr=1, jday_mon=(1,),
                  dt_crcl=6 * 3600, time_flux=1, time_scnr=1)
TEN_DAY = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
               time_scnr=1)
# the JAX CLI's default sweep (greb_tpu/__main__.py:60): ct_sens +-2%
CT_SENS = np.linspace(22.05, 22.95, 2).astype(np.float32)
CO2_YEARS = np.asarray([560.0, 680.0], np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def pallas_pair():
    jm = JGREB(JConfig(numerics=JNumerics(**PALLAS_NUM),
                       fast_circulation=True), verbose=False)
    leaves = {k: np.asarray(getattr(jm.forcing, k))
              for k in jm.forcing.__dataclass_fields__}
    m = GREB(GrebConfig(numerics=Numerics(**PALLAS_NUM),
                        fast_circulation=True),
             forcing=forcing_from_numpy(leaves, "cpu"), verbose=False,
             device="cpu")
    s = jm.initial_state()
    s5 = jnp.stack([s.ts, s.ta, s.to, s.q, s.cap_surf])[:, None]
    state5 = jnp.concatenate([s5] * len(CT_SENS), axis=1)
    ppack = jmy.pack_member_params(
        jens.perturbed_params(jm.params, {"ct_sens": CT_SENS}))
    fpack, sw = jyk.pack_forcing(jm.sfx)
    cpack = jyk.pack_const(jm.md)
    return jm, m, (state5, ppack, fpack, sw, cpack)


def test_pack_member_params_matches_greb_tpu_bitwise():
    perturb = {"ct_sens": np.asarray([21.0, 22.5, 23.9], np.float32),
               "da_ice": np.asarray([0.2, 0.25, 0.31], np.float32)}
    want = jmy.pack_member_params(
        jens.perturbed_params(JParams.default(), perturb))
    got = my.pack_member_params(
        ens.perturbed_params(PhysicsParams.default(), perturb))
    assert my.N_PPACK == jmy.N_PPACK == 42
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and back: each row rebuilds the member's params and capacities
    p, caps = my.member_params(got[2, 0].numpy())
    assert float(p.ct_sens) == np.float32(23.9)
    assert float(p.da_ice) == np.float32(0.31)
    assert caps[2] == np.asarray(want)[2, 0, 41]


@pytest.mark.parametrize("mb", [1, 2])
def test_fluxcorr_years_plain_matches_pallas_kernel(pallas_pair, mb):
    """K4 at M=2, tolerances of tests/test_pallas.py:67-74."""
    jm, m, (state5, ppack, fpack, sw, cpack) = pallas_pair
    run = jmy.build_fluxcorr_years(jm.md, jm.st, jm._sf_np, jm.num, jm.exp,
                                   n_members=2, mb=mb, interpret=True,
                                   fastcirc=jm.fastcirc_tables())
    s_j, corr_j = run(state5, ppack, fpack, sw, cpack, jnp.float32(340.0),
                      *jm._pallas_fast_args())
    s, corr = my.fluxcorr_years_plain(
        torch.as_tensor(np.array(state5)),
        torch.as_tensor(np.array(ppack)), 340.0, m.year_data)
    assert tuple(corr.shape) == tuple(corr_j.shape)
    np.testing.assert_allclose(_np(s[0]), _np(s_j[0]), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(_np(corr[:, :, 0]), _np(corr_j[:, :, 0]),
                               rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(_np(corr[:, :, 2]), _np(corr_j[:, :, 2]),
                               rtol=2e-5, atol=1e-7)
    # the members differ: ct_sens reaches the state
    assert not np.array_equal(_np(s[1, 0]), _np(s[1, 1]))


@pytest.mark.parametrize("mb", [1, 2])
def test_scenario_years_plain_matches_pallas_kernel(pallas_pair, mb):
    """K3 at M=2 over 2 years at CO2 560 and 680; tolerances of
    tests/test_pallas.py: state (:110-113), annual sums (:119-122),
    monthly means (:130).  The correction tables are made from a seed,
    different for each member and small: the spin-up's own tables make
    this 2-step calendar run away in the scenario."""
    jm, m, (state5, ppack, fpack, sw, cpack) = pallas_pair
    rng = np.random.default_rng(2)
    shape = (2, jm.num.nstep_yr, 1, 24, 48)
    corrpack = np.concatenate([
        rng.normal(0.0, 2.0, shape),       # tf [W/m^2]
        rng.normal(0.0, 1e-3, shape),      # tof [K/step]
        rng.normal(0.0, 1e-7, shape)],     # qf [kg/kg/step]
        axis=2).astype(np.float32)
    run = jmy.build_scenario_years(jm.md, jm.st, jm._sf_np, jm.num, jm.exp,
                                   n_years=2, n_members=2, mb=mb,
                                   interpret=True,
                                   fastcirc=jm.fastcirc_tables())
    s_j, mon_j, asum_j = run(state5, ppack, fpack, sw, cpack,
                             jnp.asarray(corrpack), jnp.asarray(CO2_YEARS),
                             *jm._pallas_fast_args())
    s, mon, asum = my.scenario_years_plain(
        torch.as_tensor(np.array(state5)), torch.as_tensor(np.array(ppack)),
        torch.as_tensor(corrpack), CO2_YEARS, m.year_data)
    for i, name in enumerate(("ts", "ta", "to", "q")):
        np.testing.assert_allclose(_np(s[i]), _np(s_j[i]), rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    # cap_surf follows Ts along the sea-ice ramp at ~5e7 J/K/m^2 per K, so
    # Ts within 1e-4 K is cap_surf within rtol 1e-3 (as
    # tests/test_torch_year.py:130); a cell or two sits on the ramp
    np.testing.assert_allclose(_np(s[4]), _np(s_j[4]), rtol=1e-3,
                               err_msg="cap_surf")
    assert tuple(mon.shape) == tuple(mon_j.shape) == (2, 2, 5, 24, 48)
    assert tuple(asum.shape) == tuple(asum_j.shape) == (2, 2, 9, 24, 48)
    np.testing.assert_allclose(_np(asum), _np(asum_j), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(mon), _np(mon_j), rtol=2e-6, atol=1e-4)
    assert np.isfinite(_np(s)).all()
    assert not np.array_equal(_np(s[0, 0]), _np(s[0, 1]))


def _seeded_corrpack(num, members, seed=2):
    """Correction tables (members, T, 3, 24, 48) from a seed, small: the
    spin-up's own tables make the 2-step calendar run away in the
    scenario."""
    rng = np.random.default_rng(seed)
    shape = (members, num.nstep_yr, 1, 24, 48)
    return np.concatenate([
        rng.normal(0.0, 2.0, shape),       # tf [W/m^2]
        rng.normal(0.0, 1e-3, shape),      # tof [K/step]
        rng.normal(0.0, 1e-7, shape)],     # qf [kg/kg/step]
        axis=2).astype(np.float32)


@pytest.mark.parametrize("mb", [1, 2])
def test_scenario_years_plain_shared_table_matches_pallas_kernel(
        pallas_pair, mb):
    """K3's plain version with one table (1, T, 3, Y, X) for both members
    against the Pallas kernel given that table twice (the JAX CLI's
    --shared-spinup broadcasts a member axis of 1), at the tolerances of
    test_scenario_years_plain_matches_pallas_kernel."""
    jm, m, (state5, ppack, fpack, sw, cpack) = pallas_pair
    shared = _seeded_corrpack(jm.num, 1)
    run = jmy.build_scenario_years(jm.md, jm.st, jm._sf_np, jm.num, jm.exp,
                                   n_years=2, n_members=2, mb=mb,
                                   interpret=True,
                                   fastcirc=jm.fastcirc_tables())
    s_j, mon_j, asum_j = run(state5, ppack, fpack, sw, cpack,
                             jnp.asarray(np.repeat(shared, 2, axis=0)),
                             jnp.asarray(CO2_YEARS), *jm._pallas_fast_args())
    s, mon, asum = my.scenario_years_plain(
        torch.as_tensor(np.array(state5)), torch.as_tensor(np.array(ppack)),
        torch.as_tensor(shared), CO2_YEARS, m.year_data)
    for i, name in enumerate(("ts", "ta", "to", "q")):
        np.testing.assert_allclose(_np(s[i]), _np(s_j[i]), rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(_np(s[4]), _np(s_j[4]), rtol=1e-3,
                               err_msg="cap_surf")
    np.testing.assert_allclose(_np(asum), _np(asum_j), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(mon), _np(mon_j), rtol=2e-6, atol=1e-4)
    assert np.isfinite(_np(s)).all()
    assert not np.array_equal(_np(s[0, 0]), _np(s[0, 1]))


@pytest.fixture(scope="module")
def ten_day_model():
    return GREB(GrebConfig(numerics=Numerics(**TEN_DAY),
                           fast_circulation=True),
                verbose=False, device="cpu")


def test_scenario_years_plain_matches_per_year_path(ten_day_model):
    """K3 at M=1 over 2 years against K2 run twice, from a spin-up year.
    The two share one step body and one parameter set (the pack's caps
    equal the derived ones), so the state and the annual sums are equal
    bit for bit (stricter than tests/test_torch_year.py:130's tolerances);
    the monthly means, which K3 adds up step by step and K2's path forms as
    one product, are held at the golden tolerances
    (tests/test_golden_year.py:29)."""
    m = ten_day_model
    yd = m.year_data
    s0, corr = yk.fluxcorr_year_plain(m.initial_state(), 298.0, yd)
    months, sums = [], []
    s = s0
    for co2 in CO2_YEARS:
        s, outs, a = yk.scenario_year_plain(s, corr, co2, yd)
        months.append(core.monthly_means(m.month_mat, outs))
        sums.append(a)
    ppack, corrpack = m._multiyear_args(corr)
    s5, mon, asum = my.scenario_years_plain(s0.stack()[:, None], ppack,
                                            corrpack, CO2_YEARS, yd)
    np.testing.assert_array_equal(_np(s5[:, 0]), _np(s.stack()))
    np.testing.assert_array_equal(_np(asum[0]), _np(torch.stack(sums)))
    mon = _np(mon[0]).reshape(2, 2, 5, 24, 48)
    want = _np(torch.stack(months))
    for v, atol in enumerate((2e-2, 2e-2, 2e-2, 3e-6, 5e-4)):
        np.testing.assert_allclose(mon[:, :, v], want[:, :, v], rtol=0,
                                   atol=atol, err_msg=f"monthly {v}")


def test_wrappers_refuse_transport_members_and_refused_plans(
        ten_day_model, pallas_pair):
    m = ten_day_model
    s5 = m.initial_state().stack()[:, None].repeat(1, 2, 1, 1)
    for key in sorted(ens.TRANSPORT_PARAM_KEYS):
        assert not ens.fastcirc_shareable([key, "ct_sens"])
        base = getattr(m.params, key)
        members = ens.perturbed_params(m.params,
                                       {key: [base, base * np.float32(1.1)]})
        with pytest.raises(ValueError, match="transport"):
            my.fluxcorr_years(s5, my.pack_member_params(members), 298.0,
                              m.year_data)
    assert ens.fastcirc_shareable(["ct_sens"])
    # the tiny calendar's plan has an explicit advection segment, which
    # the kernels do not run (the refined-grid slice)
    _, mp, _ = pallas_pair
    s5p = mp.initial_state().stack()[:, None]
    with pytest.raises(NotImplementedError, match="segments"):
        my.scenario_years(s5p, my.pack_member_params([mp.params]),
                          torch.zeros((1, 2, 3, 24, 48)), CO2_YEARS,
                          mp.year_data)


def test_run_members_chains_spin_up_and_scenario_blocks(ten_day_model):
    """The member chain at M=2 (one member with the base params): its
    base member equals the single-run path's spin-up and multi-year
    scenario bit for bit; the perturbed member differs."""
    m = ten_day_model
    members = ens.perturbed_params(m.params, {"ct_sens": [22.5, 22.95]})
    co2 = np.full(3, 680.0, np.float32)
    s5, corrpack, mon, asum = m.run_members(members, years=3,
                                            years_per_call=2, co2_series=co2)
    assert mon.shape == (2, 3 * 2, 5, 24, 48)
    assert asum.shape == (2, 3, 9, 24, 48)
    s_fc, corr = m.flux_correction()
    state, monthly, _ = m.run_scenario(corr, state=s_fc, years=3,
                                       co2_series=co2, years_per_call=2)
    np.testing.assert_array_equal(_np(corrpack[0, :, 0]), _np(corr.tf))
    np.testing.assert_array_equal(mon[0], monthly.reshape(6, 5, 24, 48))
    np.testing.assert_array_equal(_np(s5[0, 0]), _np(state.ts))
    assert not np.array_equal(mon[0], mon[1])


def test_years_work_counts_members_and_years(ten_day_model):
    """The bound's work: K4 at M=1 is K1 plus the pack row; K3's operations
    are K2's plus the monthly means' multiply-add, per member and year; the
    bytes grow with members and years by their per-member parts only."""
    m = ten_day_model
    plan, num = m.fold[0], m.num
    yx, t = plan.ydim * plan.xdim, num.nstep_yr
    b1, o1 = yk.year_work(plan, num, False)
    b4, o4 = my.years_work(plan, num, 1, 1, "fluxcorr")
    assert (b4, o4) == (b1 + 4 * my.N_PPACK, o1)
    _, o2 = yk.year_work(plan, num, True)
    b3, o3 = my.years_work(plan, num, 1, 1, "scenario")
    assert o3 == o2 + 10 * t * yx
    b3x, o3x = my.years_work(plan, num, 3, 2, "scenario")
    assert o3x == 6 * o3
    nmon = len(num.jday_mon)
    per_member_year = 4 * (3 * t * yx + (nmon * core.N_OUT + yk.N_SUM) * yx)
    per_member = 4 * (10 * yx + my.N_PPACK)
    assert b3x - b3 == 5 * per_member_year + per_member + 4 * 2
    with pytest.raises(ValueError):
        my.years_work(plan, num, 2, 1, "fluxcorr")


def _three_members(m):
    members = ens.perturbed_params(m.params,
                                   {"ct_sens": [22.05, 22.5, 22.95]})
    s0, corr = yk.fluxcorr_year_plain(m.initial_state(), 298.0, m.year_data)
    shared = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
    return (my.pack_member_params(members), s0.stack()[:, None].repeat(
        1, 3, 1, 1), shared)


def test_scenario_years_plain_shared_table_equals_copies(ten_day_model):
    """K3's plain version with one table (1, T, 3, Y, X) that all 3 members
    read is bitwise equal to it with the table copied to each member, over
    2 years from a spin-up year."""
    m = ten_day_model
    ppack, s5, shared = _three_members(m)
    copies = shared.expand(3, -1, -1, -1, -1).contiguous()
    got = my.scenario_years(s5, ppack, shared, CO2_YEARS, m.year_data)
    want = my.scenario_years_plain(s5, ppack, copies, CO2_YEARS, m.year_data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert not np.array_equal(_np(got[1][0]), _np(got[1][2]))


def test_scenario_years_refuses_other_table_counts(ten_day_model):
    """The wrapper takes a table per member or one for all: a leading size
    1 < k < M, or tables of another shape, raise before any step runs."""
    m = ten_day_model
    ppack, s5, shared = _three_members(m)
    for bad in (shared.expand(2, -1, -1, -1, -1).contiguous(), shared[0],
                shared[:, :-1]):
        with pytest.raises(ValueError, match="corrpack"):
            my.scenario_years(s5, ppack, bad, CO2_YEARS, m.year_data)
        with pytest.raises(ValueError, match="corrpack"):
            my.scenario_years_plain(s5, ppack, bad, CO2_YEARS, m.year_data)


def test_years_work_counts_a_shared_table_once(ten_day_model):
    """K3's bound with one shared table reads it once a year, not once a
    member and year; K4 always writes a table per member."""
    m = ten_day_model
    plan, num = m.fold[0], m.num
    table = 4 * 3 * num.nstep_yr * plan.ydim * plan.xdim
    b, o = my.years_work(plan, num, 2, 5, "scenario")
    bs, os_ = my.years_work(plan, num, 2, 5, "scenario", shared_corr=True)
    assert (b - bs, o) == (2 * 4 * table, os_)
    with pytest.raises(ValueError):
        my.years_work(plan, num, 1, 5, "fluxcorr", shared_corr=True)


def test_run_members_streams_blocks_from_given_tables(ten_day_model):
    """run_members with given corrections and member states runs no
    spin-up; ``on_block`` takes each K3 block as it drains (nothing is
    collected); the blocks equal a collected run of one block with the
    table given as a (T, 3, Y, X) tensor; the base member equals the
    single-run multi-year scenario from the same state bit for bit."""
    m = ten_day_model
    members = ens.perturbed_params(m.params, {"ct_sens": [22.5, 22.95]})
    _, corr = m.flux_correction()
    s5 = ens.ensemble_initial_state(members, m.forcing)
    co2 = np.full(3, 680.0, np.float32)
    n4 = my.fluxcorr_years.launches
    blocks = []
    s_a, cp_a, mon_a, asum_a = m.run_members(
        members, years=3, years_per_call=2, co2_series=co2, corr=corr,
        state5=s5, on_block=lambda done, mon, asum: blocks.append(
            (done, _np(mon).copy(), _np(asum).copy())))
    assert my.fluxcorr_years.launches == n4
    assert mon_a is None and asum_a is None
    assert [b[0] for b in blocks] == [0, 2]
    assert tuple(cp_a.shape) == (1, m.num.nstep_yr, 3, 24, 48)
    s_b, _, mon_b, asum_b = m.run_members(
        members, years=3, years_per_call=3, co2_series=co2,
        corr=torch.stack([corr.tf, corr.tof, corr.qf], dim=1), state5=s5)
    np.testing.assert_array_equal(
        np.concatenate([b[1] for b in blocks], axis=1), mon_b)
    np.testing.assert_array_equal(
        np.concatenate([b[2] for b in blocks], axis=1), asum_b)
    np.testing.assert_array_equal(_np(s_a), _np(s_b))
    _, monthly, _ = m.run_scenario(corr, state=m.initial_state(), years=3,
                                   co2_series=co2, years_per_call=2)
    np.testing.assert_array_equal(mon_b[0], monthly.reshape(6, 5, 24, 48))
    assert not np.array_equal(mon_b[0], mon_b[1])
