"""The port's figure layer (greb_tpu_torch/plots.py) against greb_tpu's.

* Every figure function, given the port's tensors (ones that require
  grad, which ``np.asarray`` refuses), draws the PNG that greb_tpu's draws
  from the same values as numpy arrays, byte for byte.
* ``save_all`` writes the same figure names as ``greb_tpu.plots.save_all``
  for the same inputs, byte-equal, also with its monthly means, diagnostics
  and forcing all given as such tensors.
* The CLI's ``--plots PREFIX`` writes the figure set after a run, after a
  checkpointed run (the output file read back) and after an ensemble (its
  first member's file), driven as tests/test_torch_longrun.py drives the
  CLI: 48x24 on a 12-month calendar of one day a month (save_all draws
  September).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

from greb_tpu import plots as jplots  # noqa: E402
from greb_tpu.forcing import forcing_from_arrays as jforcing  # noqa: E402
from greb_tpu.model.core import YearDiag as JYearDiag  # noqa: E402

from greb_tpu_torch import plots  # noqa: E402
from greb_tpu_torch.forcing import ClimForcing, forcing_from_arrays  # noqa: E402
from greb_tpu_torch.io.binio import read_output  # noqa: E402
from greb_tpu_torch.io.synthetic import make_synthetic_forcing  # noqa: E402
from greb_tpu_torch.model import core, driver  # noqa: E402

torch.set_num_threads(1)

FIGURES = ["warming", "albedo_y1", "albedo_yN", "dtsurf", "mask", "wind"]


def _fake_monthly(years=3, nlat=24, nlon=48):
    rng = np.random.default_rng(0)
    m = rng.normal(size=(years, 12, 5, nlat, nlon)).astype(np.float32)
    m[:, :, 0] += 288.0          # tsurf [K]
    m[:, :, 4] = np.clip(0.2 + 0.1 * m[:, :, 4], 0, 1)  # albedo
    return m


def _grad(a):
    """A tensor that ``np.asarray`` refuses: it requires grad."""
    t = torch.tensor(np.asarray(a, np.float32), requires_grad=True)
    with pytest.raises(RuntimeError):
        np.asarray(t)
    return t


@pytest.fixture(scope="module")
def forcing_np():
    return make_synthetic_forcing(48, 24, 20, 10)


def _png(fig, path):
    fig.savefig(path)
    mpl.pyplot.close(fig)
    with open(path, "rb") as f:
        return f.read()


def _cases(f):
    rng = np.random.default_rng(1)
    alb = rng.random((24, 48)).astype(np.float32)
    delta = rng.standard_normal((24, 48)).astype(np.float32)
    return {
        "warming_curve": ((np.array([288.1, 288.5, 289.0], np.float32),),
                          dict(co2_ppm=680.0)),
        "albedo_map": ((alb,), dict(z_topo=f["z_topo"])),
        "anomaly_map": ((delta,), dict(z_topo=f["z_topo"])),
        "land_sea_mask_plot": ((f["z_topo"],), {}),
        "wind_quiver": ((f["uclim"][0], f["vclim"][0]), {}),
    }


@pytest.mark.parametrize("name", ["warming_curve", "albedo_map",
                                  "anomaly_map", "land_sea_mask_plot",
                                  "wind_quiver", "add_coastline"])
def test_each_figure_from_tensors_equals_greb_tpu(tmp_path, forcing_np, name):
    if name == "add_coastline":
        figs = []
        for mod, z in ((jplots, forcing_np["z_topo"]),
                       (plots, _grad(forcing_np["z_topo"]))):
            fig, ax = mod._mpl().subplots()
            mod.add_coastline(ax, z)
            figs.append(fig)
    else:
        args, kw = _cases(forcing_np)[name]
        figs = [getattr(jplots, name)(*args, **kw),
                getattr(plots, name)(*[_grad(a) for a in args],
                                     **{k: _grad(v) for k, v in kw.items()
                                        if k == "z_topo"},
                                     **{k: v for k, v in kw.items()
                                        if k != "z_topo"})]
    a, b = (_png(fig, tmp_path / f"{i}.png") for i, fig in enumerate(figs))
    assert len(a) > 2000 and a == b


def _diags(gm, make):
    return [make(global_mean_ts=v, point_ts=v, mean_fields=None) for v in gm]


def test_save_all_equals_greb_tpu(tmp_path, forcing_np):
    monthly = _fake_monthly()
    gm = list(np.float32([288.1, 288.4, 288.9]))
    want = jplots.save_all(str(tmp_path / "j"), monthly,
                           diags=_diags(gm, JYearDiag),
                           forcing=jforcing(forcing_np))
    # numpy monthly means, the port's CPU forcing and diagnostics
    got = plots.save_all(str(tmp_path / "t"), monthly,
                         diags=_diags([torch.tensor(v) for v in gm],
                                      core.YearDiag),
                         forcing=forcing_from_arrays(forcing_np, "cpu"))
    # ... and everything as tensors np.asarray refuses
    grad = plots.save_all(
        str(tmp_path / "g"), _grad(monthly),
        diags=_diags([_grad(v) for v in gm], core.YearDiag),
        forcing=ClimForcing(**{k: _grad(v) for k, v in forcing_np.items()}))
    names = [os.path.basename(p) for p in want]
    assert names == [f"j_{n}.png" for n in FIGURES]
    assert [os.path.basename(p) for p in got] == [f"t_{n}.png"
                                                  for n in FIGURES]
    assert [os.path.basename(p) for p in grad] == [f"g_{n}.png"
                                                   for n in FIGURES]
    for a, b, c in zip(want, got, grad):
        with open(a, "rb") as f, open(b, "rb") as g, open(c, "rb") as h:
            pa = f.read()
            assert len(pa) > 2000 and pa == g.read() == h.read(), b


def test_save_all_without_diags_or_forcing(tmp_path):
    monthly = _fake_monthly(years=2)
    want = jplots.save_all(str(tmp_path / "j"), monthly)
    got = plots.save_all(str(tmp_path / "t"), _grad(monthly))
    assert [os.path.basename(p)[2:] for p in got] == \
        [os.path.basename(p)[2:] for p in want] == \
        ["albedo_y1.png", "albedo_yN.png", "dtsurf.png"]


SMALL = dict(xdim=48, ydim=24, ndays_yr=12, jday_mon=(1,) * 12, time_flux=1,
             time_scnr=2)


@pytest.mark.parametrize("mode", ["run", "checkpointed", "ensemble"])
def test_cli_plots(monkeypatch, tmp_path, mode):
    """``python -m greb_tpu_torch --device cpu --plots PREFIX``: the figure
    set greb_tpu's CLI writes, after each kind of run."""
    from greb_tpu_torch import __main__ as cli

    real_greb = driver.GREB

    def small_greb(cfg, **kw):
        return real_greb(dataclasses.replace(
            cfg, numerics=dataclasses.replace(cfg.numerics, **SMALL)), **kw)

    monkeypatch.setattr(driver, "GREB", small_greb)
    monkeypatch.chdir(tmp_path)
    more = {"run": [], "checkpointed": ["--checkpoint-dir", "ck"],
            "ensemble": ["--ensemble", "2"]}[mode]
    os.makedirs("fig")
    assert cli.main(["--synthetic", "--device", "cpu", "--quiet",
                     "--output", "out/scenario", "--plots", "fig/run",
                     *more]) == 0
    # only the per-year run returns its yearly diagnostics: the others
    # draw no warming curve, as in greb_tpu
    want = FIGURES if mode == "run" else FIGURES[1:]
    out = "out/scenario_001" if mode == "ensemble" else "out/scenario"
    back = read_output(out, SMALL["xdim"], SMALL["ydim"])
    assert back.shape[0] == 12 * SMALL["time_scnr"]
    assert np.isfinite(back).all()
    assert sorted(os.listdir("fig")) == sorted(f"run_{n}.png" for n in want)
    for n in want:
        assert os.path.getsize(f"fig/run_{n}.png") > 2000
