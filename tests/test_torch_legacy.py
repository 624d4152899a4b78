"""The legacy ``log_exp`` switchboard of the port against ``greb_tpu``.

The original variant switches processes on one by one through ``log_exp``
(reference src/greb.original.model.f90:60,162-166,394,423,453,492-496,
514-515,553-565).  On the CPU the port's plain versions run the same
branches as the JAX package, on the same inputs:

* the ``Experiment`` flags and CO2_ctrl, for every ``log_exp``;
* ``apply_experiment``'s static field overrides, bitwise;
* one scenario step and one spin-up step at 48x24 for the presets of
  tests/test_legacy.py that the port runs, from a state drawn with numpy
  from a seed (tolerances of tests/test_torch_endtoend.py:85-89);
* the scenario CO2 series, bitwise;
* the CLI's ``run_legacy`` end to end at log_exp 13, both output files,
  and the control file's mixed layout;
* the Pallas scenario kernel (interpret mode) at log_exp 15 against the
  port's plain ``scenario_year``;
* the modes that transport with the strict stencils (log_exp 7, 8, 16 and
  the strict circulation): a spin-up and a scenario year against
  greb_tpu, the four kernel wrappers' plain versions (K2 = K3 and K1 = K4
  at M=1), and K3's one-block body, which refuses them;
* the CLI's ``--legacy``, which reads log_exp and time_ctrl from the
  namelist as greb_tpu does.

The kernels themselves run these modes on the card only
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greb_tpu.__main__ import run_legacy as j_run_legacy
from greb_tpu.config import CO2Params as JCO2
from greb_tpu.config import Diagnostics as JDiag
from greb_tpu.config import Experiment as JExperiment
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.config import PhysicsParams as JParams
from greb_tpu.forcing import ModelState as JState
from greb_tpu.forcing import apply_experiment as j_apply_experiment
from greb_tpu.forcing import forcing_from_arrays as j_forcing
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model import core as jcore
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops.pallas import year_kernel as jpk

from greb_tpu_torch.__main__ import run_legacy
from greb_tpu_torch.config import (CO2Params, Diagnostics, Experiment,
                                   GrebConfig, Numerics, PhysicsParams)
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.forcing import Corrections, ModelState, apply_experiment
from greb_tpu_torch.io.binio import read_output, read_records
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

TEN_DAY = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4))
# tests/test_pallas.py:19: one day, 2 steps, 2 substeps
PALLAS_NUM = dict(xdim=48, ydim=24, ndays_yr=1, jday_mon=(1,),
                  dt_crcl=6 * 3600, time_flux=1, time_scnr=1)
# tests/test_legacy.py's presets without the strict-transport ones (7, 8),
# and the other switches the port runs
PRESETS = (1, 4, 5, 6, 9, 11, 13, 14, 15)
FLAG_NAMES = ("active", "flat_topo", "const_cloud", "const_vapor",
              "no_deep_ocean_mld", "fixed_albedo", "simple_seaice",
              "hydro_off", "circulation_off", "vapor_circulation_off",
              "vapor_diffusion_only", "deep_ocean_off", "linear_vapor_lw",
              "a1b_co2", "sst_plus_one", "co2_ctrl")
SEED = 20240611


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _raw(num_kw):
    n = Numerics(**{k: num_kw[k] for k in ("xdim", "ydim", "ndays_yr",
                                           "jday_mon")})
    return make_synthetic_forcing(n.xdim, n.ydim, n.nstep_yr, n.ndays_yr)


def _pair(log_exp, num_kw, **cfg_kw):
    """greb_tpu's GREB (folded circulation unless ``cfg_kw`` says
    otherwise) and the port's, on the same synthetic forcing, with the
    switchboard at ``log_exp``; ``cfg_kw`` maps a config field to its
    (greb_tpu, port) values."""
    raw = _raw(num_kw)
    jkw = dict(fast_circulation=True)
    jkw.update({k: v[0] for k, v in cfg_kw.items()})
    jm = JGREB(JConfig(numerics=JNumerics(**num_kw),
                       experiment=JExperiment(log_exp=log_exp), **jkw),
               forcing=j_forcing(raw), verbose=False)
    kw = dict(fast_circulation=True)
    kw.update({k: v[1] for k, v in cfg_kw.items()})
    m = GREB(GrebConfig(numerics=Numerics(**num_kw),
                        experiment=Experiment(log_exp=log_exp), **kw),
             forcing=forcing_from_numpy(raw, "cpu"), verbose=False,
             device="cpu")
    return jm, m


def _seeded_state(m):
    """The initial state with seeded perturbations wide enough to cross
    the albedo and sea-ice ramps, as numpy arrays."""
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


@pytest.fixture(scope="module")
def presets():
    return {e: _pair(e, TEN_DAY) for e in PRESETS}


@pytest.mark.parametrize("log_exp", [None] + list(range(17)))
def test_experiment_flags_match_greb_tpu(log_exp):
    ours, theirs = Experiment(log_exp=log_exp), JExperiment(log_exp=log_exp)
    for name in FLAG_NAMES:
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("log_exp", [1, 2, 3, 9])
def test_apply_experiment_matches_greb_tpu(log_exp):
    """The static overrides, bitwise, on the 10-day synthetic forcing."""
    raw = _raw(TEN_DAY)
    want = j_apply_experiment(j_forcing(raw), JParams.default(),
                              JExperiment(log_exp=log_exp))
    got = apply_experiment(forcing_from_numpy(raw, "cpu"),
                           PhysicsParams.default(), Experiment(log_exp))
    for k in got.__dataclass_fields__:
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)


def _step_tolerances():
    # tests/test_torch_endtoend.py:85-89: rtol 1e-5; atol 1e-3 K, 1e-7 q,
    # 1e-2 W/m^2 tf; cap_surf rtol 1e-3 (tests/test_torch_year.py: on the
    # sea-ice ramp it moves ~5e7 J/K/m^2 per K of Ts); albedo atol 2e-4
    # (tests/test_torch_endtoend.py:80)
    return dict(ts=1e-3, ta=1e-3, to=1e-3, q=1e-7)


@pytest.mark.parametrize("log_exp", PRESETS)
def test_scenario_step_matches_greb_tpu(presets, log_exp):
    jm, m = presets[log_exp]
    st = _seeded_state(m)
    t, co2 = 3, np.float32(680.0)
    fx = jax.tree.map(lambda a: a[t], jm.sfx)
    zero = np.zeros_like(st["ts"])
    js, jout = jcore.scenario_step(
        JState(**{k: jnp.asarray(v) for k, v in st.items()}), fx,
        (jnp.asarray(zero),) * 3, jnp.float32(co2), jm.md, jm.st, jm.num,
        jm.exp, fastcirc=_fastcirc(jm))
    s, out = core.scenario_step(
        ModelState(**{k: torch.as_tensor(v) for k, v in st.items()}),
        m.sfx.at(t), (torch.as_tensor(zero),) * 3, co2, m.md, m.num, m.fold,
        m.exp)
    for name, atol in _step_tolerances().items():
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   np.asarray(getattr(js, name)), rtol=1e-5,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(_np(s.cap_surf), np.asarray(js.cap_surf),
                               rtol=1e-3, err_msg="cap_surf")
    np.testing.assert_allclose(_np(out.albedo), np.asarray(jout.albedo),
                               rtol=1e-5, atol=2e-4, err_msg="albedo")


@pytest.mark.parametrize("log_exp", PRESETS)
def test_fluxcorr_step_matches_greb_tpu(presets, log_exp):
    jm, m = presets[log_exp]
    st = _seeded_state(m)
    t = 3
    co2 = np.float32(Experiment(log_exp).co2_ctrl)
    fx = jax.tree.map(lambda a: a[t], jm.sfx)
    js, (jtf, _, jqf) = jcore.fluxcorr_step(
        JState(**{k: jnp.asarray(v) for k, v in st.items()}), fx,
        jnp.float32(co2), jm.md, jm.st, jm.num, jm.exp,
        fastcirc=_fastcirc(jm))
    s, (tf, _, qf) = core.fluxcorr_step(
        ModelState(**{k: torch.as_tensor(v) for k, v in st.items()}),
        m.sfx.at(t), co2, m.md, m.num, m.fold, m.exp)
    for name, atol in _step_tolerances().items():
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   np.asarray(getattr(js, name)), rtol=1e-5,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(_np(tf), np.asarray(jtf), rtol=1e-5,
                               atol=1e-2, err_msg="tf")
    np.testing.assert_allclose(_np(qf), np.asarray(jqf), rtol=1e-5,
                               atol=1e-7, err_msg="qf")


def test_circulation_off_has_no_transport(presets):
    """log_exp <= 4: no increments of Ta or q (greb.original:553-559)."""
    _, m = presets[4]
    ten = core.compute_tendencies(m.initial_state(), m.sfx.at(0),
                                  np.float32(340.0), m.md, m.num, m.fold,
                                  m.exp)
    assert float(ten.dta_crcl.abs().max()) == 0.0
    assert float(ten.dq_crcl.abs().max()) == 0.0


@pytest.mark.parametrize("log_exp", [12, 13, 14, 15])
def test_co2_series_matches_greb_tpu(log_exp):
    """tests/test_legacy.py:104-117's run: year0 1950, 160 years."""
    series = np.full(160, 680.0, np.float32)
    got = core.co2_series_for_run(Numerics(time_scnr=160, year0=1950),
                                  Experiment(log_exp), series)
    want = jcore.co2_series_for_run(JNumerics(time_scnr=160, year0=1950),
                                    JExperiment(log_exp), series)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_run_legacy_matches_greb_tpu(tmp_path):
    """The CLI's legacy workflow at log_exp 13 (A1B CO2, no hydrology) on
    the calendar of tests/test_endtoend.py:137-138.  Both files agree with
    greb_tpu's at tests/test_torch_endtoend.py:80's tolerances per
    variable (the control file's TF_correct tail at the tf tolerance of
    tests/test_torch_year.py, rtol 1e-5 / atol 0.5 W/m^2); the control file
    has the mixed layout: its head is the port's own control run's monthly
    means, its tail the port's own spin-up tf, both bitwise."""
    kw = dict(TEN_DAY, time_flux=1, time_ctrl=1, time_scnr=1)
    jm, m = _pair(13, kw, co2=(JCO2(co2_ppm=(680.0,)),
                               CO2Params(co2_ppm=(680.0,))),
                  diagnostics=(JDiag(console=False),
                               Diagnostics(console=False)))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    j_run_legacy(jm, str(tmp_path / "jax" / "scenario"), quiet=True)
    run_legacy(m, str(tmp_path / "torch" / "scenario"))

    atols = (5e-3, 5e-3, 5e-3, 2e-6, 2e-4)
    got = read_output(str(tmp_path / "torch" / "scenario"), 48, 24)
    want = read_output(str(tmp_path / "jax" / "scenario"), 48, 24)
    assert got.shape == want.shape == (2, 5, 24, 48)
    for v, atol in enumerate(atols):
        np.testing.assert_allclose(got[:, v], want[:, v], rtol=0, atol=atol,
                                   err_msg=f"scenario variable {v}")

    num = m.num
    nrec = len(num.jday_mon) * 5 * num.time_ctrl
    ctl = read_records(str(tmp_path / "torch" / "control"), (24, 48))
    jctl = read_records(str(tmp_path / "jax" / "control"), (24, 48))
    assert ctl.shape == jctl.shape == (num.nstep_yr, 24, 48)
    head, jhead = ctl[:nrec].reshape(-1, 5, 24, 48), \
        jctl[:nrec].reshape(-1, 5, 24, 48)
    for v, atol in enumerate(atols):
        np.testing.assert_allclose(head[:, v], jhead[:, v], rtol=0,
                                   atol=atol, err_msg=f"control variable {v}")
    np.testing.assert_allclose(ctl[nrec:], jctl[nrec:], rtol=1e-5, atol=0.5,
                               err_msg="TF_correct tail")

    state_fc, corr = m.flux_correction()
    tf = corr.tf.numpy()
    np.testing.assert_array_equal(ctl[nrec:], tf[nrec:])
    _, monthly, _ = m.run_scenario(
        corr, years=num.time_ctrl, state=state_fc,
        co2_series=np.full(num.time_ctrl, m.exp.co2_ctrl, np.float32))
    np.testing.assert_array_equal(ctl[:nrec], monthly.reshape(-1, 24, 48))
    assert not np.array_equal(ctl[:nrec], tf[:nrec])


def test_scenario_plain_matches_pallas_kernel_at_log_exp_15():
    """build_scenario_year with exp=Experiment(log_exp=15) (SST + 1, no
    hydrology, no deep ocean), interpret mode, as tests/test_pallas.py runs
    it, against the port's plain scenario year; tolerances of
    tests/test_torch_year.py's Pallas comparison, and for cap_surf its
    rtol 1e-3 (two cells sit on the sea-ice ramp here, where cap_surf
    moves ~4e7 J/K/m^2 per K of Ts)."""
    jm, m = _pair(15, PALLAS_NUM)
    num = jm.num
    run = jpk.build_scenario_year(jm.md, jm.st, jm._sf_np, num, jm.exp,
                                  interpret=True,
                                  fastcirc=jm.fastcirc_tables())
    fpack, sw = jpk.pack_forcing(jm.sfx)
    cpack = jpk.pack_const(jm.md)
    corrpack = jnp.zeros((num.nstep_yr, 3, num.ydim, num.xdim), jnp.float32)
    co2 = 340.0
    sp, outs_p, asum_p = run(jm.initial_state(), fpack, sw, cpack, corrpack,
                             jnp.float32(co2), *jm._pallas_fast_args())
    corr = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    s, outs, asum = yk.scenario_year_plain(m.initial_state(), corr, co2,
                                           m.year_data)
    for name in ("ts", "ta", "to", "q"):
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   _np(getattr(sp, name)), rtol=2e-6,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(_np(s.cap_surf), _np(sp.cap_surf), rtol=1e-3,
                               err_msg="cap_surf")
    np.testing.assert_allclose(_np(outs), _np(outs_p[:, :5]), rtol=2e-6,
                               atol=1e-4)
    np.testing.assert_allclose(_np(asum), _np(asum_p), rtol=1e-4, atol=1e-2)


# the modes that transport with the strict stencils: (log_exp, the fold
# asked for), the strict circulation the modern variant without it
STRICT_MODES = [(7, True), (8, True), (16, True), (None, False)]
# monthly-mean atols of test_run_legacy_matches_greb_tpu (ts, ta, to, q,
# albedo), also for the end states
YEAR_ATOLS = dict(ts=5e-3, ta=5e-3, to=5e-3, q=2e-6)


@pytest.mark.parametrize("log_exp,fast", STRICT_MODES,
                         ids=["log_exp7", "log_exp8", "log_exp16", "strict"])
def test_strict_transport_modes_raise_on_the_cpu(log_exp, fast):
    """The strict transport against greb_tpu (its jitted path at
    fastcirc=None): a spin-up year, then a scenario year at 680 ppm from
    its end, on the 10-day calendar.  End states, the tf table and the
    monthly means at the tolerances of test_run_legacy_matches_greb_tpu
    (tf rtol 1e-5 / atol 0.5 W/m^2); neither side builds a fold."""
    jm, m = _pair(log_exp, dict(TEN_DAY, time_flux=1),
                  fast_circulation=(fast, fast))
    assert jm.fastcirc_tables() is None and m.fold is None
    assert m.year_data.transport == "strict"
    js, jc = jm.flux_correction()
    s, c = m.flux_correction()
    for name, atol in YEAR_ATOLS.items():
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=atol, err_msg=f"spin-up {name}")
    np.testing.assert_allclose(_np(c.tf), np.asarray(jc.tf), rtol=1e-5,
                               atol=0.5, err_msg="tf")
    co2 = np.full(1, 680.0, np.float32)
    _, jmon, _ = jm.run_scenario(jc, state=js, years=1, co2_series=co2)
    s2, mon, _ = m.run_scenario(c, state=s, years=1, co2_series=co2)
    jmon = np.asarray(jmon)
    for v, atol in enumerate((5e-3, 5e-3, 5e-3, 2e-6, 2e-4)):
        np.testing.assert_allclose(mon[:, :, v], jmon[:, :, v], rtol=0,
                                   atol=atol, err_msg=f"monthly variable {v}")


@pytest.fixture(scope="module")
def strict_models():
    return {e: GREB(GrebConfig(numerics=Numerics(**TEN_DAY),
                               experiment=Experiment(e),
                               fast_circulation=True),
                    verbose=False, device="cpu") for e in (7, 8, 16)}


@pytest.mark.parametrize("log_exp", [7, 8, 16])
def test_kernel_wrappers_refuse_strict_transport_modes(strict_models,
                                                       log_exp):
    """All four kernel wrappers run these modes on CPU tensors through
    their plain versions, which are the eager year runners; at M=1 with
    the base params the member wrappers equal the single-run ones bit for
    bit (K1 = K4: state and tables; K2 = K3: state and annual sums)."""
    m = strict_models[log_exp]
    yd, co2 = m.year_data, np.float32(m.exp.co2_ctrl)
    s0 = m.initial_state()
    s1, c1 = yk.fluxcorr_year(s0, co2, yd)
    want = core.run_year_fluxcorr(s0, m.sfx, co2, m.md, m.num, None, m.exp)
    assert torch.equal(s1.stack(), want[0].stack())
    pp = my.pack_member_params([m.params])
    s4, c4 = my.fluxcorr_years(s0.stack()[:, None], pp, co2, yd)
    assert torch.equal(s1.stack(), s4[:, 0])
    for i, name in enumerate(("tf", "tof", "qf")):
        assert torch.equal(getattr(c1, name), c4[0, :, i]), name
    s2, _, a2 = yk.scenario_year(s1, c1, 680.0, yd)
    s3, _, a3 = my.scenario_years(s1.stack()[:, None], pp, c4, [680.0], yd)
    assert torch.equal(s2.stack(), s3[:, 0])
    assert torch.equal(a2, a3[0, 0])
    assert bool(torch.isfinite(s2.stack()).all())


def test_one_block_body_refuses_the_strict_transport(strict_models):
    """K3's one-block body (cluster=1) does not run the strict transport:
    it raises before anything runs, on CPU tensors too, naming its ROADMAP
    item; the clusters run it."""
    m = strict_models[16]
    s5 = m.initial_state().stack()[:, None]
    pp = my.pack_member_params([m.params])
    cp = torch.zeros((1, m.num.nstep_yr, 3, m.num.ydim, m.num.xdim))
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        my.scenario_years(s5, pp, cp, [680.0], m.year_data, cluster=1)
    assert my.default_cluster("scenario_years", 10_000, 7,
                              strict=True) == yk.DEFAULT_CLUSTER
    assert my.default_cluster("scenario_years", 10_000, 7) == 1


def test_flags_word():
    """One bit per switch of the step body, 0 for the modern variant and
    for the modes whose step body is the modern one (10, 12); the strict
    transport's bit comes from the year's transport, with the vapour
    bits of log_exp 7, 8, 16."""
    for e in (None, 10, 12):
        assert yk.experiment_flags(Experiment(e)) == 0
    bit = {name: 1 << i for i, name in enumerate(yk.FLAGS)}
    assert yk.experiment_flags(Experiment(None), strict=True) == bit[
        "strict_transport"]
    assert yk.experiment_flags(Experiment(8), strict=True) == (
        bit["deep_ocean_off"] | bit["strict_transport"]
        | bit["vapor_diffusion_only"])
    assert yk.experiment_flags(Experiment(4)) == (
        bit["fixed_albedo"] | bit["simple_seaice"] | bit["hydro_off"]
        | bit["circulation_off"] | bit["deep_ocean_off"])
    assert yk.experiment_flags(Experiment(11)) == (
        bit["deep_ocean_off"] | bit["linear_vapor_lw"])
    assert yk.experiment_flags(Experiment(15)) == (
        bit["hydro_off"] | bit["deep_ocean_off"] | bit["sst_plus_one"])


def test_cli_legacy_reads_the_namelist_and_runs_run_legacy(tmp_path,
                                                           monkeypatch):
    """``--legacy`` takes log_exp from the namelist's &physics group and
    time_ctrl from &numerics, as greb_tpu's config_from_namelist does, and
    hands the model to run_legacy (the model is a stand-in here: the full
    96x48 calendar is the card's work)."""
    import greb_tpu_torch.__main__ as cli
    import greb_tpu_torch.model.driver as driver
    from greb_tpu.config import config_from_namelist as j_config
    from greb_tpu_torch.io.namelist import write_namelist

    path = str(tmp_path / "namelist_original")
    write_namelist({"numerics": {"time_flux": 3, "time_ctrl": 2,
                                 "time_scnr": 5},
                    "physics": {"log_exp": 13}}, path)
    seen = {}

    class Model:
        def __init__(self, cfg, **kw):
            self.cfg, self.kw = cfg, kw

    monkeypatch.setattr(driver, "GREB", Model)
    monkeypatch.setattr(cli, "run_legacy",
                        lambda model, out: seen.update(model=model, out=out))
    out = str(tmp_path / "out" / "scenario")
    assert cli.main([path, "--legacy", "--synthetic", "--device", "cpu",
                     "--output", out, "--quiet"]) == 0
    cfg, jcfg = seen["model"].cfg, j_config(path)[0]
    assert seen["out"] == out
    assert cfg.experiment.log_exp == jcfg.experiment.log_exp == 13
    assert (cfg.numerics.time_flux, cfg.numerics.time_ctrl,
            cfg.numerics.time_scnr) == (jcfg.numerics.time_flux,
                                        jcfg.numerics.time_ctrl,
                                        jcfg.numerics.time_scnr) == (3, 2, 5)
