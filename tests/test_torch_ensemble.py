"""The ensemble path of the port, ``python -m greb_tpu_torch --ensemble``,
against ``greb_tpu``'s (``greb_tpu/__main__.py`` ``run_ensemble``).

On the CPU at 48x24 on a 10-day calendar (tests/test_endtoend.py:169),
one spin-up year and two scenario years, M=3 members over ``--perturb
ct_sens=21.0:24.0``, both packages on the same synthetic forcing: each
member's output file of the port's ``run_ensemble`` (the member kernels'
plain versions) against greb_tpu's (its batched XLA runners), per-member
spin-up and ``--shared-spinup``, ``--mxu-precision`` high and highest,
``--strict-circulation`` and legacy log_exp 13 (A1B, whose spin-up CO2
is co2_flux and scenario CO2 the namelist series in both packages), at
the golden tolerances (tests/test_golden_year.py:29): temperatures 2e-2 K,
q 3e-6, albedo 5e-4.  The largest differences measured (max |diff| over
the three members' files; Ts, Ta, To [K], q, albedo):

    per-member, high and highest  4.1e-3  1.7e-3  5.2e-4  9.4e-7  4.8e-5
    shared spin-up                4.6e-3  1.7e-3  1.8e-4  4.6e-7  3.4e-5
    strict circulation            3.1e-4  9.2e-5  9.2e-5  3.6e-8  9.5e-6
    log_exp 13                    1.1e-2  3.2e-3  2.1e-4  1.9e-9  3.9e-4

(a free-running year amplifies the two frameworks' float32 rounding near
the sea-ice and albedo ramps; the two --mxu-precision values gave the
same maxima).  Also: the console lines, the ``SystemExit`` cases,
the four flags against ``greb_tpu.__main__.build_parser()``, the CLI's
dispatch order, and ``ensemble_initial_state`` bitwise.
"""
import argparse
import contextlib
import io

import numpy as np
import pytest
import torch

from greb_tpu.__main__ import build_parser as j_build_parser
from greb_tpu.__main__ import run_ensemble as j_run_ensemble
from greb_tpu.config import Experiment as JExperiment
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import forcing_from_arrays as j_forcing
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.parallel import ensemble as jens

from greb_tpu_torch import __main__ as cli
from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.parallel import ensemble as ens

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

NUM = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
           time_scnr=2)
M = 3
PERTURB = "ct_sens=21.0:24.0"
# the golden tolerances (tests/test_golden_year.py:29) of the 5 output
# variables: Ts, Ta, To [K], q [kg/kg], albedo
TOLS = (2e-2, 2e-2, 2e-2, 3e-6, 5e-4)
# mode: (log_exp, fast circulation, shared spin-up, --mxu-precision).
# greb_tpu's run_ensemble raises under the strict circulation (its batched
# runners broadcast the (M, 1, 1) params against the strict stencils'
# (M, 2, y, x) fields), so that mode is held to greb_tpu's single run of
# each member (``_jax_members``), which is what run_ensemble computes
CASES = {
    "per-member high": (None, True, False, "high"),
    "per-member highest": (None, True, False, "highest"),
    "shared spin-up": (None, True, True, "high"),
    "strict circulation": (None, False, False, "high"),
    "log_exp 13": (13, True, False, "high"),
}


def _pair(log_exp=None, fast=True):
    """greb_tpu's GREB and the port's on the same synthetic forcing, as
    each package's CLI builds them (the circulation folded unless
    ``fast`` is False)."""
    n = Numerics(**NUM)
    raw = make_synthetic_forcing(n.xdim, n.ydim, n.nstep_yr, n.ndays_yr)
    jm = JGREB(JConfig(numerics=JNumerics(**NUM),
                       experiment=JExperiment(log_exp=log_exp),
                       fast_circulation=fast),
               forcing=j_forcing(raw), verbose=False)
    m = GREB(GrebConfig(numerics=n, experiment=Experiment(log_exp=log_exp),
                        fast_circulation=fast),
             forcing=forcing_from_numpy(raw, "cpu"), verbose=False,
             device="cpu")
    return jm, m


def _jax_members(jm, out):
    """greb_tpu's single run of each member (its own params: the spin-up
    at co2_flux, then the scenario from its end state at the namelist
    series), into run_ensemble's files."""
    sweep = np.linspace(21.0, 24.0, M).astype(np.float32)
    for i, p in enumerate(jens.perturbed_params(jm.params,
                                                {"ct_sens": sweep}).ct_sens):
        mi = JGREB(jm.cfg, params=jm.params.replace(ct_sens=p),
                   forcing=jm.forcing, verbose=False)
        s, corr = mi.flux_correction(co2=jm.cfg.co2.co2_flux)
        mi.run_scenario(corr, state=s, output_path=f"{out}_{i + 1:03d}",
                        co2_series=jm.cfg.co2.series(jm.num.time_scnr))


def _args(**kw):
    a = dict(ensemble=M, perturb=PERTURB, mxu_precision="high", quiet=True,
             shared_spinup=False)
    a.update(kw)
    return argparse.Namespace(**a)


def _files(out):
    n = Numerics(**NUM)
    return [read_output(f"{out}_{i:03d}", n.xdim, n.ydim)
            for i in range(1, M + 1)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_ensemble_matches_greb_tpu(case, tmp_path):
    """Each member's file of the port's run_ensemble against greb_tpu's, at
    the golden tolerances; the members differ."""
    log_exp, fast, shared, prec = CASES[case]
    jm, m = _pair(log_exp, fast)
    args = _args(shared_spinup=shared, mxu_precision=prec)
    if fast:
        j_run_ensemble(jm, str(tmp_path / "jax"), args)
    else:
        _jax_members(jm, str(tmp_path / "jax"))
    cli.run_ensemble(m, str(tmp_path / "port"), args)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    n = Numerics(**NUM)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (n.time_scnr * 2, 5, n.ydim, n.xdim)
        assert np.isfinite(g).all()
        for v, tol in enumerate(TOLS):
            np.testing.assert_allclose(g[:, v], w[:, v], rtol=0, atol=tol,
                                       err_msg=f"member {i + 1} var {v}")
    assert not np.array_equal(got[0], got[-1])


def test_console_lines_match_greb_tpu(tmp_path):
    """The header is greb_tpu's line character for character; each year's
    line has its year and CO2, and the members' range of the global-mean
    Ts within the golden tolerance."""
    jm, m = _pair()
    outs = []
    for run, model, tag in ((j_run_ensemble, jm, "jax"),
                            (cli.run_ensemble, m, "port")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(model, str(tmp_path / tag), _args(quiet=False))
        outs.append(buf.getvalue().splitlines())
    j_lines, p_lines = outs
    assert len(p_lines) == len(j_lines) == 1 + NUM["time_scnr"]
    assert p_lines[0] == j_lines[0]
    assert p_lines[0].startswith("% ENSEMBLE RUN; members = 3 perturb ct_sens")
    for pl, jl in zip(p_lines[1:], j_lines[1:]):
        pt, jt = pl.split(), jl.split()
        assert pt[:3] + pt[4:5] + pt[6:] == jt[:3] + jt[4:5] + jt[6:]
        for k in (3, 5):
            assert abs(float(pt[k].strip("[]")) - float(jt[k].strip("[]"))) \
                <= TOLS[0]


@pytest.mark.parametrize("perturb", ["ct_sens", "ct_sens=a:b",
                                     "no_such_param=1:2", "kappa=7e5:9e5",
                                     "z_air=7000:9000"])
def test_bad_perturb_raises_as_greb_tpu(perturb, tmp_path):
    """A bad spec, an unknown parameter and a transport parameter raise
    SystemExit with greb_tpu's message, before anything runs."""
    jm, m = _pair()
    msgs = []
    for run, model in ((j_run_ensemble, jm), (cli.run_ensemble, m)):
        with pytest.raises(SystemExit) as exc:
            run(model, str(tmp_path / "ens"), _args(perturb=perturb))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert any(w in msgs[1] for w in ("perturb", "unknown physics parameter",
                                      "transport"))


@pytest.mark.parametrize("flag", ["--ensemble", "--perturb",
                                  "--shared-spinup", "--mxu-precision"])
def test_flags_match_greb_tpu(flag):
    """The four ensemble flags have greb_tpu's names, kinds, types,
    defaults, choices and metavars."""
    def action(parser):
        return next(a for a in parser._actions if flag in a.option_strings)
    j, p = action(j_build_parser()), action(cli.build_parser())
    for attr in ("dest", "default", "choices", "type", "nargs", "const",
                 "metavar", "required"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert type(p) is type(j)
    assert vars(cli.build_parser().parse_args([]))[j.dest] == \
        vars(j_build_parser().parse_args([]))[j.dest]


def test_cli_dispatches_ensemble_before_legacy_and_checkpoints(
        monkeypatch, tmp_path):
    """greb_tpu's order: --ensemble wins over --legacy and
    --checkpoint-dir."""
    called = []
    monkeypatch.setattr(cli, "run_ensemble",
                        lambda model, out, args: called.append(
                            ("ensemble", out, args.ensemble)))
    monkeypatch.setattr(cli, "run_legacy",
                        lambda *a, **k: called.append(("legacy",)))
    monkeypatch.setattr(cli, "run_checkpointed",
                        lambda *a, **k: called.append(("checkpoints",)))
    out = str(tmp_path / "out" / "ens")
    rc = cli.main(["--ensemble", "2", "--legacy", "--checkpoint-dir",
                   str(tmp_path / "ck"), "--synthetic", "--device", "cpu",
                   "--output", out, "--quiet"])
    assert rc == 0 and called == [("ensemble", out, 2)]


def test_ensemble_initial_state_matches_greb_tpu_bitwise():
    jm, m = _pair()
    sweep = {"ct_sens": np.linspace(21.0, 24.0, M).astype(np.float32),
             "da_ice": np.linspace(0.2, 0.3, M).astype(np.float32)}
    pb = jens.perturbed_params(jm.params, sweep)
    js = jens.ensemble_initial_state(
        pb, jm.forcing, jens.ensemble_data(pb, jm.forcing, jm.sf))
    got = ens.ensemble_initial_state(ens.perturbed_params(m.params, sweep),
                                     m.forcing)
    assert tuple(got.shape) == (5, M, 24, 48)
    for i, name in enumerate(("ts", "ta", "to", "q", "cap_surf")):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(getattr(js, name)))
