"""The port's matmul ("MXU") circulation and the member kernels' plain
twin of it, against ``greb_tpu``'s (``greb_tpu/ops/fastcirc2.py`` build_mxu
:490, adv_matrix :512, mxu_circulation :691, MxuMembers :749, _dot_b :764,
mxu_members_circulation :782) and its ensemble path, on the CPU.

At 96x48, the smallest grid whose plan the member-batched form covers (no
segments, dense composites, additive splitting; each test asserts it
first): the constants bitwise, _dot_b at both precisions, the circulation
forms on the random fields of tests/test_mxu.py:187-190, the twin of the
member kernels (``fastcirc2.circulation`` at a precision, reached through
``MxuTwin``) against greb_tpu's member form, the member-batched plain K4
then K3 against greb_tpu's batched runners given its ``MxuMembers``
(greb_tpu/model/core.py:154), and the CLI's ``run_ensemble`` against
greb_tpu's on a 20-step calendar.  "highest" holds at the golden
tolerances (tests/test_golden_year.py:29); "high" is the bf16_3x split in
the port and exact float32 in greb_tpu on XLA:CPU, so it holds at the
golden tolerances of greb_tpu's own bf16_3x and at the HIGH budget of
tests/test_mxu.py:71 as far as greb_tpu's own bf16_3x does (see
test_cli_run_ensemble_vs_greb_tpu).  The largest differences measured:

    form (max |diff|)                               highest    bf16_3x
    mxu_members_circulation vs greb_tpu's            0          0
    mxu_circulation (stacked) vs greb_tpu's          0          -
    members form vs greb_tpu's mxu_circulation       0          2.3e-2
    twin substep vs mxu_members_circulation          1.5e-4     1.5e-4
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greb_tpu.__main__ import run_ensemble as j_run_ensemble
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import forcing_from_arrays as j_forcing
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops import fastcirc2 as jfc2
from greb_tpu.parallel import ensemble as jens

from greb_tpu_torch import __main__ as cli
from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy, mxu_from_numpy
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.parallel import ensemble as ens

torch.set_num_threads(1)

# the 20-step calendar of the member chains (tests/test_torch_ensemble.py's;
# on a 10-step one greb_tpu's own matmul and fold years differ by 2.4e-5 in
# q, past the golden 3e-6)
NUM = dict(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
M = 3
PERTURB = "ct_sens=21.0:24.0"
# the golden tolerances (tests/test_golden_year.py:29): Ts, Ta, To, q, albedo
TOLS = (2e-2, 2e-2, 2e-2, 3e-6, 5e-4)
# the HIGH budget (tests/test_mxu.py:71, on the CPU): end-state Ts [K],
# monthly RMS
HIGH_TS = 5e-2
HIGH_RMS = 5e-3


def _assert_covered(plan):
    assert plan.diff_segs == () and plan.adv_segs == ()
    assert plan.comp_mode == "dense" and not plan.seq_zonal
    assert plan.comp_kt == plan.comp_kb == 1
    assert fc2.members_covered(plan)


@pytest.fixture(scope="module")
def pair():
    """greb_tpu's GREB and the port's at 96x48 on the same synthetic
    forcing, the fold built, on NUM's calendar."""
    n = Numerics(**NUM)
    raw = make_synthetic_forcing(n.xdim, n.ydim, n.nstep_yr, n.ndays_yr)
    jm = JGREB(JConfig(numerics=JNumerics(**NUM), fast_circulation=True),
               forcing=j_forcing(raw), verbose=False)
    m = GREB(GrebConfig(numerics=n, fast_circulation=True),
             forcing=forcing_from_numpy(raw, "cpu"), verbose=False,
             device="cpu")
    _assert_covered(m.fold[0])
    return jm, m


@pytest.fixture(scope="module")
def fields(pair):
    """greb_tpu's fold, a step's coefficients and the random member batch
    of tests/test_mxu.py:187-190 (MB=4, seed 7), and the same fold and
    coefficients carried into the port's types, so both packages' forms
    read the same values."""
    jm, m = pair
    jplan, (jconst,) = jm._fastcirc_split()
    plan = m.fold[0]
    rng = np.random.default_rng(7)
    x2 = (280.0 + 10 * rng.standard_normal((4, 2, 48, 96))).astype(np.float32)
    jcf = jfc2.step_coeffs(jnp.asarray(jm.forcing.uclim[0]),
                           jnp.asarray(jm.forcing.vclim[0]), jconst, jplan)
    t = lambda a: torch.from_numpy(np.array(a))
    const = fc2.Fast2Const(**{k: t(getattr(jconst, k)) for k in (
        "zd", "zam", "mer", "wz", "band", "pcomp", "pcu", "pcw", "pmask")})
    cf = fc2.Fast2Coeffs(za=t(jcf.za), mc=t(jcf.mc), c0m=t(jcf.c0m))
    return dict(jplan=jplan, jconst=jconst, jcf=jcf, plan=plan, const=const,
                cf=cf, x2=x2)


def _members(jmm):
    return mxu_from_numpy({"zd_mat": np.asarray(jmm.zd_mat),
                           "shift1h": np.asarray(jmm.shift1h)},
                          jmm.precision)


def test_build_mxu_and_adv_matrix_bitwise(fields):
    """build_mxu's matrices (mode "stacked") and a step's advection matrix
    are greb_tpu's bit for bit."""
    f = fields
    _assert_covered(f["plan"])
    j = jfc2.build_mxu(f["jconst"], f["jplan"], "highest", "stacked")
    p = fc2.build_mxu(f["const"], f["plan"], "highest", "stacked")
    np.testing.assert_array_equal(p.zd_mat.numpy(), np.asarray(j.zd_mat))
    np.testing.assert_array_equal(p.shift1h.numpy(), np.asarray(j.shift1h))
    np.testing.assert_array_equal(
        fc2.adv_matrix(f["cf"].za, p).numpy(),
        np.asarray(jfc2.adv_matrix(f["jcf"].za, j)))


@pytest.mark.parametrize("prec", ["bf16_3x", "highest"])
def test_dot_b(prec, fields):
    """_dot_b on random (B, M, X) @ (B, X, 2X) within 1e-6 of greb_tpu's
    largest value."""
    _assert_covered(fields["plan"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 4, 96)).astype(np.float32)
    w = rng.standard_normal((96, 96, 192)).astype(np.float32)
    want = np.asarray(jfc2._dot_b(jnp.asarray(x), jnp.asarray(w), prec))
    got = fc2._dot_b(torch.from_numpy(x), torch.from_numpy(w), prec).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_mxu_circulation_stacked_highest(fields):
    """mxu_circulation (stacked, highest) over 24 substeps against
    greb_tpu's within 2e-4."""
    f = fields
    _assert_covered(f["plan"])
    want = np.asarray(jfc2.mxu_circulation(
        jnp.asarray(f["x2"]), f["jcf"], f["jconst"],
        jfc2.build_mxu(f["jconst"], f["jplan"], "highest", "stacked"),
        f["jplan"], 24, unroll=True))
    jmxu = jfc2.build_mxu(f["jconst"], f["jplan"], "highest", "stacked")
    mxu = mxu_from_numpy({"zd_mat": np.asarray(jmxu.zd_mat),
                          "shift1h": np.asarray(jmxu.shift1h)}, "highest",
                         mode="stacked")
    assert isinstance(mxu, fc2.MxuConst) and mxu.mode == "stacked"
    got = fc2.mxu_circulation(torch.from_numpy(f["x2"]), f["cf"], f["const"],
                              mxu, f["plan"], 24)
    assert np.abs(got.numpy() - want).max() <= 2e-4


@pytest.mark.parametrize("prec", ["bf16_3x", "highest"])
def test_mxu_members_circulation(prec, fields):
    """mxu_members_circulation (MB=4, 24 substeps) against greb_tpu's at the
    same precision within 2e-4, and against greb_tpu's mxu_circulation at
    highest within 2e-4 (highest) or 5e-2 (bf16_3x, tests/test_mxu.py:
    200-208)."""
    f = fields
    _assert_covered(f["plan"])
    jmm = jfc2.build_mxu_members(f["jconst"], f["jplan"], prec)
    want = np.asarray(jfc2.mxu_members_circulation(
        jnp.asarray(f["x2"]), f["jcf"], f["jconst"], jmm, f["jplan"], 24,
        unroll=True))
    mm = _members(jmm)
    assert mm.precision == prec
    np.testing.assert_array_equal(
        mm.zd_mat.numpy(),
        fc2.build_mxu_members(f["const"], f["plan"], prec).zd_mat.numpy())
    got = fc2.mxu_members_circulation(torch.from_numpy(f["x2"]), f["cf"],
                                      f["const"], mm, f["plan"], 24).numpy()
    assert np.abs(got - want).max() <= 2e-4
    ref = np.asarray(jfc2.mxu_circulation(
        jnp.asarray(f["x2"]), f["jcf"], f["jconst"],
        jfc2.build_mxu(f["jconst"], f["jplan"], "highest", "stacked"),
        f["jplan"], 24, unroll=True))
    assert np.abs(got - ref).max() <= (2e-4 if prec == "highest" else 5e-2)


@pytest.mark.parametrize("prec", ["bf16_3x", "highest"])
def test_twin_substep_vs_members_form(prec, fields):
    """One substep of the member kernels' twin (the fold's 7-term sums, at
    bf16_3x split as _dot_b splits) against mxu_members_circulation within
    2e-4; at highest the twin is the exact fold, bit for bit."""
    f = fields
    _assert_covered(f["plan"])
    x = torch.from_numpy(f["x2"])
    mm = fc2.build_mxu_members(f["const"], f["plan"], prec)
    want = fc2.mxu_members_circulation(x, f["cf"], f["const"], mm,
                                       f["plan"], 1)
    got = fc2.circulation(x, f["cf"], f["const"], f["plan"], 1,
                          precision=prec)
    assert float((got - want).abs().max()) <= 2e-4
    exact = fc2.circulation(x, f["cf"], f["const"], f["plan"], 1)
    assert torch.equal(got, exact) == (prec == "highest")


def _jax_batched(jm, prec, sweep, cli=False):
    """greb_tpu's batched runners (parallel/ensemble.py:104) with its
    member-batched matmul circulation (``cli``: the stacked matmul
    circulation at the CLI's ``prec``, as its run_ensemble builds it,
    greb_tpu/__main__.py:182): a spin-up year at co2_flux, then a scenario
    year at the namelist's first CO2."""
    plan, (const,) = jm._fastcirc_split()
    fcdata = (const, jfc2.build_mxu(const, plan, precision=prec,
                                    mode="stacked") if cli else
              jfc2.build_mxu_members(const, plan, prec))
    pb = jens.perturbed_params(jm.params, {"ct_sens": sweep})
    md_b = jens.batched_model_data(pb, jm.forcing, jm.sf)
    state = jens.ensemble_initial_state(
        pb, jm.forcing, jens.ensemble_data(pb, jm.forcing, jm.sf))
    flux_b, scnr_b = jens.make_batched_ensemble_runners(
        jm.st, jm.num, jm.exp, jm.month_mat, fast_plan=plan)
    state, corr = flux_b(state, jm.sfx, jnp.float32(jm.cfg.co2.co2_flux),
                         md_b, fcdata)
    co2 = jm.cfg.co2.series(1)
    state, monthly, _ = scnr_b(state, jm.sfx, corr, jnp.float32(co2[0]),
                               md_b, fcdata)
    return np.asarray(state.ts), np.asarray(monthly), co2


@pytest.mark.parametrize("prec", ["bf16_3x", "highest"])
def test_member_chain_vs_greb_tpu_batched(prec, pair):
    """The member-batched plain K4 then K3 (M=3: the twin, on the CPU)
    against greb_tpu's batched runners given its MxuMembers, at the
    golden tolerances; the plain K4 at highest is the exact fold's per
    member, bit for bit."""
    jm, m = pair
    _assert_covered(m.fold[0])
    sweep = np.linspace(21.0, 24.0, M).astype(np.float32)
    want_ts, want_mon, co2 = _jax_batched(jm, prec, sweep)
    members = ens.perturbed_params(m.params, {"ct_sens": sweep})
    pp = my.pack_member_params(members)
    s5 = ens.ensemble_initial_state(members, m.forcing)
    mxu, yd = m.members_mxu(prec), m.year_data
    co2f = np.float32(m.cfg.co2.co2_flux)
    s5, corr = my.fluxcorr_years(s5, pp, co2f, yd, mxu=mxu)
    if prec == "highest":
        exact = my.fluxcorr_years(ens.ensemble_initial_state(
            members, m.forcing), pp, co2f, yd)
        assert torch.equal(s5, exact[0]) and torch.equal(corr, exact[1])
    s5, mon, _ = my.scenario_years(s5, pp, corr, co2[:1], yd, mxu=mxu)
    np.testing.assert_allclose(s5[0].numpy(), want_ts, rtol=0, atol=TOLS[0])
    for v, tol in enumerate(TOLS):
        np.testing.assert_allclose(mon[:, :, v].numpy(), want_mon[:, :, v],
                                   rtol=0, atol=tol, err_msg=f"var {v}")


def _args(**kw):
    a = dict(ensemble=M, perturb=PERTURB, mxu_precision="high", quiet=True,
             shared_spinup=False)
    a.update(kw)
    return argparse.Namespace(**a)


def _files(out, n):
    return np.stack([read_output(f"{out}_{i:03d}", n.xdim, n.ydim)
                     for i in range(1, M + 1)])


@pytest.mark.parametrize("prec", ["high", "highest"])
def test_cli_run_ensemble_vs_greb_tpu(prec, pair, tmp_path, capsys):
    """The CLI's run_ensemble at 96x48 runs the matmul circulation (its
    stderr line says so) and writes each member's file.  At highest the
    files are within the golden tolerances of greb_tpu's run_ensemble.  At
    high the port runs bf16_3x, greb_tpu's CLI exact float32 (XLA:CPU's
    HIGH): the files are within the golden tolerances of greb_tpu's own
    bf16_3x member form (its batched runners given MxuMembers), their
    monthly RMS from greb_tpu's CLI within the HIGH budget (5e-3), the
    end-state Ts of the same run (run_members as run_ensemble calls it)
    within the budget's 5e-2 K of greb_tpu's CLI computation, and their
    largest monthly difference from it no larger than greb_tpu's own
    bf16_3x run's (0.058 against 0.062 K on this calendar: over the
    budget's 5e-2 on both sides, ROADMAP Queue 3)."""
    jm, m = pair
    _assert_covered(m.fold[0])
    args = _args(mxu_precision=prec, quiet=False)
    j_run_ensemble(jm, str(tmp_path / "jax"), args)
    cli.run_ensemble(m, str(tmp_path / "port"), args)
    assert ("member-batched matmul, "
            + cli.MXU_PRECISION[prec]) in capsys.readouterr().err
    n = Numerics(**NUM)
    got, want = _files(tmp_path / "port", n), _files(tmp_path / "jax", n)
    assert got.shape == want.shape == (M, 2, 5, n.ydim, n.xdim)
    assert np.isfinite(got).all() and not np.array_equal(got[0], got[-1])
    ref = want
    if prec == "high":
        _, ref, _ = _jax_batched(
            jm, "bf16_3x", np.linspace(21.0, 24.0, M).astype(np.float32))
        d = np.abs(got.astype(np.float64) - want)
        assert np.sqrt((d ** 2).mean()) < HIGH_RMS
        assert d.max() <= np.abs(ref.astype(np.float64) - want).max()
        sweep = np.linspace(21.0, 24.0, M).astype(np.float32)
        j_ts, _, co2 = _jax_batched(jm, "high", sweep, cli=True)
        s5 = m.run_members(ens.perturbed_params(m.params,
                                                {"ct_sens": sweep}),
                           years=1, co2_series=co2,
                           spinup_co2=m.cfg.co2.co2_flux,
                           mxu=m.members_mxu("bf16_3x"))[0]
        assert np.abs(s5[0].numpy().astype(np.float64) - j_ts).max() \
            < HIGH_TS
    for v, tol in enumerate(TOLS):
        np.testing.assert_allclose(got[:, :, v], ref[:, :, v], rtol=0,
                                   atol=tol, err_msg=f"var {v}")


def test_cli_at_48x24_runs_the_exact_fold(tmp_path, capsys):
    """48x24's plan has no composite rows, which the member form refuses:
    the CLI runs the exact fold there and says so."""
    n = Numerics(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4),
                 time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=n, fast_circulation=True), device="cpu",
             verbose=False)
    assert m.fold[0].comp_mode == "none"
    assert not fc2.members_covered(m.fold[0])
    assert m.members_mxu("bf16_3x") is None
    cli.run_ensemble(m, str(tmp_path / "ens"), _args(quiet=False))
    assert "exact float32 fold (the matmul circulation does not run this " \
        "plan)" in capsys.readouterr().err


def test_cli_highest_routes_by_members(pair, tmp_path, capsys,
                                       monkeypatch):
    """At highest the member kernels compute the exact fold's bits, so from
    MXU_HIGHEST_PER_MEMBER_M members the CLI runs the per-member kernels
    and says so; the files are the same bit for bit either way."""
    jm, m = pair
    _assert_covered(m.fold[0])
    n = Numerics(**NUM)
    files = {}
    for limit, line in ((M + 1, "member-batched matmul, highest"),
                        (M, "exact float32 fold (the matmul circulation's "
                            "bits at highest")):
        monkeypatch.setattr(cli, "MXU_HIGHEST_PER_MEMBER_M", limit)
        out = tmp_path / f"limit{limit}"
        cli.run_ensemble(m, str(out), _args(mxu_precision="highest",
                                            quiet=False))
        assert line in capsys.readouterr().err
        files[limit] = _files(out, n)
    np.testing.assert_array_equal(files[M], files[M + 1])


def test_refusals_before_any_launch(fields):
    """Modes "pair" and "fused" (not ported), a plan with sequential zonal
    splitting and a plan with segments raise NotImplementedError naming
    their ROADMAP items, before anything runs; so does a member kernel
    given such a plan or an mb no layout holds."""
    import dataclasses
    f = fields
    plan, const = f["plan"], f["const"]
    _assert_covered(plan)
    for mode in ("pair", "fused"):
        with pytest.raises(NotImplementedError, match="Not to port"):
            fc2.build_mxu(const, plan, mode=mode)
    mxu = fc2.build_mxu(const, plan, "highest")
    seq = dataclasses.replace(plan, seq_zonal=True)
    with pytest.raises(NotImplementedError, match="item 4b"):
        fc2.mxu_circulation(torch.from_numpy(f["x2"]), f["cf"], const, mxu,
                            seq, 1)
    mm = fc2.build_mxu_members(const, plan, "bf16_3x")
    for bad in (seq, dataclasses.replace(plan, diff_segs=((1, 1, 2),)),
                dataclasses.replace(plan, adv_segs=((1, 1, 2),)),
                dataclasses.replace(plan, comp_mode="none", comp_kt=0,
                                    comp_kb=0)):
        assert not fc2.members_covered(bad)
        with pytest.raises(NotImplementedError, match="item 4b"):
            fc2.mxu_members_circulation(torch.from_numpy(f["x2"]), f["cf"],
                                        const, mm, bad, 1)
    with pytest.raises(ValueError):
        fc2.build_mxu_members(const, plan, "high")


def test_member_layouts_and_mb(pair):
    """members_layout at 96x48: K3 holds mb=2 (208,384 B a block), K4 mb=4
    (232,448 B, the whole block), the wrappers' mb (default_mb); more
    raises, as a cluster size other than 16 given to a wrapper does (on
    the CPU too, before anything runs)."""
    jm, m = pair
    plan = m.fold[0]
    _assert_covered(plan)
    assert my.default_mb(plan, "scenario_years") == 2
    assert my.default_mb(plan, "fluxcorr") == 4
    assert my.members_layout(plan, 2, "scenario_years").nbytes == 208384
    lay = my.members_layout(plan, 4, "fluxcorr")
    assert lay.nbytes == 232448 and lay.threads == 576
    shared = dict(lay.parts)
    assert (shared["coeffs"], shared["zd"], shared["wz"],
            shared["pcomp"]) == (27648, 16128, 2304, 73728)
    for mb, kind in ((3, "scenario_years"), (5, "fluxcorr"),
                     (0, "fluxcorr")):
        with pytest.raises(ValueError):
            my.members_layout(plan, mb, kind)
    pp = my.pack_member_params([m.params] * 2)
    s5 = ens.ensemble_initial_state([m.params] * 2, m.forcing)
    with pytest.raises(ValueError, match="shared memory"):
        my.members_layout(plan, 3, "scenario_years")
    with pytest.raises(ValueError, match="clusters of 16"):
        my.fluxcorr_years(s5, pp, 280.0, m.year_data, cluster=8,
                          mxu=m.members_mxu("bf16_3x"))
    # the bound counts the split's operations
    w_hi = my.years_work(plan, m.num, 1, 65, "scenario", precision="highest")
    w_lo = my.years_work(plan, m.num, 1, 65, "scenario",
                         precision="bf16_3x")
    assert w_hi == my.years_work(plan, m.num, 1, 65, "scenario")
    assert w_lo[0] == w_hi[0] and w_lo[1] > w_hi[1]
    # its dense realisation: three bfloat16 products (96, M, 96) @ (96, 96,
    # 192) a substep, the exact row dots' float32 work taken out
    nb, f32, bf16 = my.years_work_dense(plan, m.num, 1, 65, "scenario")
    assert nb == w_hi[0] and f32 < w_hi[1]
    assert bf16 == (65 * m.num.nstep_yr * m.num.nsub_crcl
                    * 3 * 2 * 96 * 96 * 192)


def test_twin_scenario_batch_is_the_per_member_plain(pair):
    """The twin steps the members as one batch: at highest its K3 years
    are the exact fold's per-member plain years bit for bit, with a table
    per member and with one shared table."""
    jm, m = pair
    _assert_covered(m.fold[0])
    yd = m.year_data
    members = ens.perturbed_params(
        m.params, {"ct_sens": np.linspace(21.0, 24.0, 2).astype(np.float32)})
    pp = my.pack_member_params(members)
    s5 = ens.ensemble_initial_state(members, m.forcing)
    s5, corr = my.fluxcorr_years_plain(s5, pp, 280.0, yd)
    co2 = np.asarray([560.0, 680.0], np.float32)
    for tabs in (corr, corr[:1]):
        got = my.scenario_years_plain(s5, pp, tabs, co2, yd,
                                      m.members_mxu("highest"))
        want = my.scenario_years_plain(s5, pp, tabs, co2, yd)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
