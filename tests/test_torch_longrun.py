"""The port's long runs: chunks, checkpoints and a bit-exact resume, on the
CPU at 48x24 with a 10-day calendar (tiny calendars run away in the
scenario phase).

* ``run_long``'s chunks and checkpoint cadence (tests/test_config5.py:75).
* A run stopped after its output went past the last checkpoint resumes
  bit-exactly in state, and its output file equals the uninterrupted run's
  byte for byte (tests/test_config5.py:95, :263), through the per-year
  kernel's and the multi-year kernel's plain versions.
* ``run_long`` against ``greb_tpu``'s over 4 years.
* Checkpoints cross between the packages both ways.
* The CLI: ``--checkpoint-dir`` with a run stopped between two checkpoints,
  then ``--resume``, leaves the same output file as an uninterrupted run.
  (``greb_tpu``'s CLI reopens its output with ``append=True`` on resume,
  greb_tpu/__main__.py:266-267, and would write the years after the
  checkpoint twice.)
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.io import checkpoint as jck
from greb_tpu.model import longrun as jlongrun
from greb_tpu.model.driver import GREB as JGREB

from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.forcing import Corrections, ModelState
from greb_tpu_torch.io import checkpoint as ck
from greb_tpu_torch.io.binio import read_output
from greb_tpu_torch.model import driver, longrun
from greb_tpu_torch.model.driver import GREB

# The fields are small: one intra-op thread.  More threads only contend
# with the other test workers (measured ~7x slower under -n 6).
torch.set_num_threads(1)

SMALL = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
             time_scnr=6)
CO2 = np.full(6, 680.0, np.float32)


@pytest.fixture(scope="module")
def jax_model():
    return JGREB(JConfig(numerics=JNumerics(**SMALL), fast_circulation=True),
                 verbose=False)


@pytest.fixture(scope="module")
def model(jax_model):
    leaves = {k: np.asarray(getattr(jax_model.forcing, k))
              for k in jax_model.forcing.__dataclass_fields__}
    return GREB(GrebConfig(numerics=Numerics(**SMALL), fast_circulation=True),
                forcing=forcing_from_numpy(leaves, "cpu"), verbose=False,
                device="cpu")


@pytest.fixture(scope="module")
def spun_up(model):
    return model.flux_correction()


class Stopped(Exception):
    """Stands for a crash between two checkpoints."""


def _state(v: float) -> ModelState:
    return ModelState(*(torch.full((2, 2), v) for _ in ModelState.FIELDS))


def test_run_long_chunks_and_checkpoints(tmp_path):
    """1000 years in 50-year chunks; then 100 years in chunks of 7 with a
    checkpoint every 10 years: only chunk ends on the cadence (70) and the
    last one (100) are saved, and retention keeps the newest ``keep``."""
    calls = []

    def fake_runner(state, corr, co2_chunk):
        calls.append(len(co2_chunk))
        return ModelState(*(getattr(state, k) + len(co2_chunk)
                            for k in ModelState.FIELDS)), None

    corr = Corrections.zeros(3, 2, 2)
    co2 = np.full(1000, 680.0, np.float32)
    state, _, start = longrun.run_long(1000, _state(0.0), corr, co2,
                                       fake_runner, chunk_years=50)
    assert start == 0 and float(state.ts[0, 0]) == 1000.0
    assert calls == [50] * 20

    calls.clear()
    ckpt = ck.Checkpointer(str(tmp_path / "ck"), every_years=10, keep=1)
    chunks = []
    longrun.run_long(100, _state(0.0), corr, co2, fake_runner,
                     checkpointer=ckpt, chunk_years=7,
                     on_chunk=lambda done, _: chunks.append(done))
    assert calls == [7] * 14 + [2]
    assert chunks[-1] == 100
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_000100"]
    ckpt2 = ck.Checkpointer(str(tmp_path / "ck2"), every_years=10, keep=3)
    longrun.run_long(100, _state(0.0), corr, co2, fake_runner,
                     checkpointer=ckpt2, chunk_years=7)
    assert sorted(os.listdir(tmp_path / "ck2")) == ["ckpt_000070",
                                                    "ckpt_000100"]
    s, _, cursor = ckpt2.restore()
    assert cursor == ck.RunCursor("scenario", 100, 680.0)
    assert float(s.ts[0, 0]) == 100.0
    # a resume with nothing left to run returns the checkpoint's state
    s, _, start = longrun.run_long(100, _state(-1.0), corr, co2,
                                   fake_runner, checkpointer=ckpt2)
    assert start == 100 and float(s.ts[0, 0]) == 100.0


@pytest.mark.parametrize("years_per_call", [1, 3])
def test_resume_is_bitexact_and_output_continues(model, spun_up, tmp_path,
                                                 years_per_call):
    """6 years in chunks of 3 with a checkpoint after each.  The first run
    stops after writing years 4-6 but before their checkpoint; a fresh
    runner resumes from year 3, from a deliberately wrong start state.  The
    final state is bitwise the uninterrupted run's, and the output file is
    equal byte for byte: years 4-6 are written once."""
    state_fc, corr = spun_up
    ref = str(tmp_path / "ref")
    s_ref, _, _ = longrun.run_long(
        6, state_fc, corr, CO2,
        longrun.driver_year_runner(model, ref, years_per_call),
        chunk_years=3)

    out, ckdir = str(tmp_path / "out"), str(tmp_path / "ck")
    first = longrun.driver_year_runner(model, out, years_per_call)
    chunks = []

    def stopped(state, corr_, co2_chunk):
        result = first(state, corr_, co2_chunk)
        chunks.append(len(co2_chunk))
        if len(chunks) == 2:
            raise Stopped("stopped after writing years 4-6")
        return result

    with pytest.raises(Stopped):
        longrun.run_long(6, state_fc, corr, CO2, stopped,
                         checkpointer=ck.Checkpointer(ckdir, every_years=3),
                         chunk_years=3)
    first.close()
    assert os.path.getsize(out) == os.path.getsize(ref)   # 6 years written
    assert ck.Checkpointer(ckdir).latest_step() == 3

    wrong = ModelState(*(torch.zeros_like(getattr(state_fc, k))
                         for k in ModelState.FIELDS))
    second = longrun.driver_year_runner(model, out, years_per_call)
    s_res, _, start = longrun.run_long(
        6, wrong, corr, CO2, second,
        checkpointer=ck.Checkpointer(ckdir, every_years=3), chunk_years=3)
    second.close()
    assert start == 3
    for name in ModelState.FIELDS:
        assert torch.equal(getattr(s_res, name), getattr(s_ref, name)), name
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_run_long_matches_greb_tpu(jax_model, model, spun_up, tmp_path):
    """Spin-up year, then 4 scenario years in chunks of 2 through both
    packages' run_long and driver_year_runner (greb_tpu on its XLA path).
    Tolerances of tests/test_torch_year.py:130: the state at rtol 1e-5 with
    atol 1e-3 K / 3e-6 (q), cap_surf at rtol 1e-3; the output file's
    monthly means as the state."""
    j_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    js_fc, jcorr = jax_model.flux_correction()
    js, _, _ = jlongrun.run_long(
        4, js_fc, jcorr, CO2, jlongrun.driver_year_runner(jax_model, j_out),
        chunk_years=2)
    state_fc, corr = spun_up
    runner = longrun.driver_year_runner(model, out)
    s, _, _ = longrun.run_long(4, state_fc, corr, CO2, runner, chunk_years=2)
    runner.close()
    tol = dict(ts=(1e-5, 1e-3), ta=(1e-5, 1e-3), to=(1e-5, 1e-3),
               q=(1e-5, 3e-6), cap_surf=(1e-3, 0.0))
    for name, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    got, want = read_output(out, 48, 24), read_output(j_out, 48, 24)
    assert got.shape == want.shape == (4 * 2, 5, 24, 48)
    for v, name in enumerate(("ts", "ta", "to", "q")):
        rtol, atol = tol[name]
        np.testing.assert_allclose(got[:, v], want[:, v], rtol=rtol,
                                   atol=atol, err_msg=f"monthly {name}")


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint written by greb_tpu's save_checkpoint loads in the port
    (also through its Checkpointer), and the port's loads in greb_tpu's
    load_checkpoint: equal arrays and cursor."""
    import jax.numpy as jnp
    from greb_tpu.forcing import Corrections as JCorrections
    from greb_tpu.forcing import ModelState as JModelState

    rng = np.random.default_rng(7)
    arrs = {k: rng.normal(size=(20, 24, 48) if k in ("tf", "tof", "qf")
                          else (24, 48)).astype(np.float32)
            for k in ModelState.FIELDS + ("tf", "tof", "qf")}
    cursor = ck.RunCursor("scenario", 7, 560.0)

    jdir = str(tmp_path / "j" / "ckpt_000007")
    jck.save_checkpoint(
        jdir, JModelState(**{k: jnp.asarray(arrs[k])
                             for k in ModelState.FIELDS}),
        JCorrections(**{k: jnp.asarray(arrs[k]) for k in ("tf", "tof", "qf")}),
        jck.RunCursor("scenario", 7, 560.0))
    for s, c, cur in (ck.load_checkpoint(jdir),
                      ck.Checkpointer(str(tmp_path / "j")).restore()):
        assert cur == cursor
        for k in ModelState.FIELDS:
            np.testing.assert_array_equal(getattr(s, k).numpy(), arrs[k])
        for k in ("tf", "tof", "qf"):
            np.testing.assert_array_equal(getattr(c, k).numpy(), arrs[k])

    pdir = str(tmp_path / "p")
    ckpt = ck.Checkpointer(pdir)
    ckpt.save(7, ModelState(**{k: torch.as_tensor(arrs[k])
                               for k in ModelState.FIELDS}),
              Corrections(**{k: torch.as_tensor(arrs[k])
                             for k in ("tf", "tof", "qf")}), cursor)
    ckpt.wait_until_finished()
    assert os.listdir(pdir) == ["ckpt_000007"]
    js, jc, jcur = jck.load_checkpoint(os.path.join(pdir, "ckpt_000007"))
    assert (jcur.phase, jcur.year_index, jcur.co2) == ("scenario", 7, 560.0)
    for k in ModelState.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), arrs[k])
    for k in ("tf", "tof", "qf"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, k)), arrs[k])


def test_cli_resume_between_checkpoints_writes_each_year_once(
        monkeypatch, tmp_path):
    """``python -m greb_tpu_torch --device cpu --checkpoint-dir D`` at
    48x24 (1 spin-up + 5 scenario years, a checkpoint every 2): the first
    run stops in its second chunk after writing years 3-4, before their
    checkpoint; ``--resume`` then continues from year 2.  The output file
    equals an uninterrupted run's."""
    from greb_tpu_torch import __main__ as cli

    real_greb = driver.GREB
    small = dict(SMALL, time_scnr=5)

    def small_greb(cfg, **kw):
        return real_greb(dataclasses.replace(
            cfg, numerics=dataclasses.replace(cfg.numerics, **small)), **kw)

    monkeypatch.setattr(driver, "GREB", small_greb)
    monkeypatch.chdir(tmp_path)

    def argv(out, ckdir, *more):
        return ["--synthetic", "--device", "cpu", "--quiet", "--output", out,
                "--checkpoint-dir", ckdir, "--checkpoint-every", "2", *more]

    assert cli.main(argv("ref/scenario", "ck_ref")) == 0

    real_runner = longrun.driver_year_runner

    def stopping_runner(model, **kw):
        runner, n = real_runner(model, **kw), []

        def run_years(state, corr, co2_chunk):
            result = runner(state, corr, co2_chunk)
            n.append(1)
            if len(n) == 2:
                raise Stopped("stopped after writing years 3-4")
            return result

        run_years.on_resume, run_years.close = runner.on_resume, runner.close
        return run_years

    monkeypatch.setattr(longrun, "driver_year_runner", stopping_runner)
    with pytest.raises(Stopped):
        cli.main(argv("out/scenario", "ck"))
    assert os.path.getsize("out/scenario") == 4 * 2 * 5 * 24 * 48 * 4
    assert sorted(os.listdir("ck")) == ["ckpt_000002"]

    monkeypatch.setattr(longrun, "driver_year_runner", real_runner)
    assert cli.main(argv("out/scenario", "ck", "--resume")) == 0
    assert sorted(os.listdir("ck")) == ["ckpt_000002", "ckpt_000004",
                                        "ckpt_000005"]
    with open("out/scenario", "rb") as f, open("ref/scenario", "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize("out/scenario") == 5 * 2 * 5 * 24 * 48 * 4
