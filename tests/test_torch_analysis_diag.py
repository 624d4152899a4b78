"""The port's analysis layer and diagnostics against greb_tpu's
(tests/test_analysis_diag.py is greb_tpu's own).

* ``analysis``: every function on one output file the port's
  ``OutputWriter`` writes (seeded numpy months), equal to
  ``greb_tpu.analysis`` on the same file bit for bit; the input-field
  analyses also take the port's tensors.
* ``diag.profiling``: ``phase_timer`` / ``PhaseStats`` arithmetic,
  ``RunMetrics``' JSONL byte-equal to greb_tpu's, ``check_finite``'s
  message equal to greb_tpu's for the same values (a ``ModelState`` with
  NaN and Inf planted, and nests of dicts, lists and NamedTuples),
  ``run_scenario`` under ``check_finite_every`` raising greb_tpu's
  message in the same run (48x24, 10-day calendar, a NaN CO2 in the
  second scenario year), and ``trace`` writing a trace file.
* ``diag.memory``: with one shard equal to greb_tpu's report field by
  field at 96x48 .. 768x384 and 1 or 65 members; with 2 and 4 shards the
  lines that differ named (the port's sharded fold keeps each shard's own
  composite rows, greb_tpu budgets its slot layout), and the port's
  composites equal to what its cut fold holds; ``fits`` with explicit
  bytes; ``N_COEF_PLANES`` against the port's ``build_const``.
"""
import dataclasses
import glob
import json
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from greb_tpu import analysis as janalysis
from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.diag import memory as jmemory
from greb_tpu.diag import profiling as jprofiling
from greb_tpu.forcing import Corrections as JCorrections
from greb_tpu.forcing import ModelState as JModelState
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops import fastcirc2 as jfc2

from greb_tpu_torch import analysis
from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.convert import forcing_from_numpy
from greb_tpu_torch.diag import memory, profiling
from greb_tpu_torch.forcing import Corrections, ModelState
from greb_tpu_torch.io.binio import OutputWriter
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc2 as fc2

torch.set_num_threads(1)
F32 = np.float32


@pytest.fixture(scope="module")
def output_file(tmp_path_factory):
    """A 2-year 96x48 output stream the port's writer writes."""
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("out") / "scenario")
    months = rng.uniform(250, 300, size=(24, 5, 48, 96)).astype(F32)
    months[:, 4] = rng.uniform(0.1, 0.8, size=(24, 48, 96))  # albedo
    with OutputWriter(path, 96, 48) as w:
        w.write_months(months)
    return path, months


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


FILE_CALLS = {
    "read_greb": [dict(varname=v) for v in analysis.VARS]
    + [dict(varname="albedo", months=[3, 17]),
       dict(varname="tsurf", months=[0, 5], tidy=True)],
    "global_mean_series": [
        dict(varname=v, annual=a, weighted=w, celsius=c)
        for v in ("tsurf", "vapour") for a in (True, False)
        for w in (True, False) for c in (True, False)],
    "arctic_september_albedo": [dict(years=[0, 1]),
                                dict(years=[1], lat_min=60.0)],
}


@pytest.mark.parametrize("name", sorted(FILE_CALLS))
def test_file_analyses_equal_greb_tpu(output_file, name):
    path, months = output_file
    for kw in FILE_CALLS[name]:
        _equal(getattr(analysis, name)(path, **kw),
               getattr(janalysis, name)(path, **kw))
    if name == "read_greb":
        _, data = analysis.read_greb(path, "tocean")
        np.testing.assert_array_equal(data, months[:, 2])


def test_grid_analyses_equal_greb_tpu(output_file):
    _, months = output_file
    for args in ((), (96, 48), (48, 24), (768, 384)):
        _equal(analysis.cell_lonlat(*args), janalysis.cell_lonlat(*args))
    for n in (24, 48, 384):
        _equal(analysis.area_weights(n), janalysis.area_weights(n))
    field = months[:, 0]
    _equal(analysis.area_weighted_mean(field),
           janalysis.area_weighted_mean(field))
    _equal(analysis.area_weighted_mean(torch.tensor(field)),
           janalysis.area_weighted_mean(field))
    lon = np.array([0.0, 90.0, 180.0, 270.0, 359.0, 3.75])
    for to in ("180", "360"):
        _equal(analysis.wrap_lon(lon, to), janalysis.wrap_lon(lon, to))
        _equal(analysis.wrap_lon(torch.tensor(lon), to),
               janalysis.wrap_lon(lon, to))
    with pytest.raises(ValueError):
        analysis.wrap_lon(lon, "90")


def test_input_field_analyses_take_tensors():
    rng = np.random.default_rng(2)
    z = (rng.standard_normal((24, 48)) * 1000.0).astype(F32)
    u = rng.standard_normal((20, 24, 48)).astype(F32)
    v = rng.standard_normal((20, 24, 48)).astype(F32)
    want = janalysis.land_sea_mask(z)
    _equal(analysis.land_sea_mask(z), want)
    _equal(analysis.land_sea_mask(torch.tensor(z, requires_grad=True)), want)
    want = janalysis.monthly_wind_means(u, v, (6, 4), 2)
    _equal(analysis.monthly_wind_means(u, v, (6, 4), 2), want)
    _equal(analysis.monthly_wind_means(torch.tensor(u), torch.tensor(v),
                                       (6, 4), 2), want)


# --- diag.profiling ----------------------------------------------------------
def test_phase_timer_and_stats(capsys, monkeypatch):
    num = Numerics()
    with profiling.phase_timer("x", sim_years=2, num=num) as t:
        pass
    assert t.stats.wall_s >= 0
    assert t.stats.grid_points == 96 * 48 and t.stats.steps_per_year == 730
    for mod in (profiling, jprofiling):
        s = mod.PhaseStats("y", wall_s=2.0, sim_years=4, grid_points=10,
                           steps_per_year=100)
        assert (s.sim_yr_per_s, s.point_steps_per_s) == (2.0, 2000.0)
        assert mod.PhaseStats("z", wall_s=0.0).sim_yr_per_s == 0.0
    # the printed line, greb_tpu's, on a clock that reads 0 s, then 2 s
    lines = []
    for mod, n in ((profiling, num), (jprofiling, JNumerics())):
        clock = iter([0.0, 2.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        with mod.phase_timer("scenario", sim_years=5, num=n, verbose=True):
            pass
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] == (
        "% [scenario] 2.00s | 2.50 sim-yr/s | 8.410e+06 point-steps/s\n")


def test_run_metrics_jsonl_equals_greb_tpu(tmp_path):
    paths = []
    for mod, f in ((profiling, torch.tensor), (jprofiling, jnp.float32)):
        m = mod.RunMetrics()
        m.log_year(1941, f(680.0), f(288.5), 0.25, extra_field=1)
        m.log_year(1942, 680, 288.7, np.float32(0.24))
        p = str(tmp_path / f"{mod.__name__}.jsonl")
        m.save(p)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    back = profiling.RunMetrics.load(paths[0])
    assert back.records == jprofiling.RunMetrics.load(paths[1]).records
    assert back.records[0]["extra_field"] == 1


def _planted():
    a = np.random.default_rng(4).uniform(250, 300, (5, 2, 3)).astype(F32)
    a[0] = np.nan
    a[3, 1, 2] = np.inf
    a[4, 0, 0] = -np.inf
    return a


def _message(fn, tree, **kw):
    with pytest.raises(FloatingPointError) as e:
        fn(tree, **kw)
    return str(e.value)


def test_check_finite_model_state_equals_greb_tpu():
    a = _planted()
    ours = _message(profiling.check_finite,
                    ModelState(*[torch.tensor(x) for x in a]),
                    name="state@yr3")
    theirs = _message(jprofiling.check_finite,
                      JModelState(*[jnp.asarray(x) for x in a]),
                      name="state@yr3")
    assert ours == theirs
    assert ours.startswith("state@yr3.ts: 6 non-finite; state@yr3.q: 1")
    profiling.check_finite(ModelState(*[torch.ones(2, 3)] * 5))


class _Pair(NamedTuple):
    first: object
    second: object = None


@pytest.mark.parametrize("make", ["dict", "nested"])
def test_check_finite_nests_equal_greb_tpu(make):
    a = _planted()

    def tree(f):
        if make == "dict":
            return {"b": f(a[3]), "a": f(np.ones(4, F32)), "c": f(a[0])}
        return [f(a[1]), (_Pair(f(a[4]), None), {"k": _Pair(f(a[0]))}),
                1.5, np.float32(np.nan)]

    ours = _message(profiling.check_finite, tree(torch.tensor))
    assert ours == _message(jprofiling.check_finite, tree(jnp.asarray))
    assert "non-finite" in ours


SMALL = dict(xdim=48, ydim=24, ndays_yr=10, jday_mon=(6, 4), time_flux=1,
             time_scnr=3)


@pytest.fixture(scope="module")
def models():
    jm = JGREB(JConfig(numerics=JNumerics(**SMALL), fast_circulation=True,
                       check_finite_every=1), verbose=False)
    leaves = {k: np.asarray(getattr(jm.forcing, k))
              for k in jm.forcing.__dataclass_fields__}
    m = GREB(GrebConfig(numerics=Numerics(**SMALL), fast_circulation=True,
                        check_finite_every=1),
             forcing=forcing_from_numpy(leaves, "cpu"), verbose=False,
             device="cpu")
    return jm, m


@pytest.mark.parametrize("every,collect", [(1, True), (2, False)])
def test_check_finite_every_raises_like_greb_tpu(models, every, collect):
    """A NaN CO2 in the second scenario year: the check after that year
    (every year, or every second, with or without monthly means) raises
    greb_tpu's message, naming year 2 and the fields."""
    jm, m = models
    co2 = np.array([680.0, np.nan, 680.0], F32)
    z = (m.num.nstep_yr, m.num.ydim, m.num.xdim)
    msgs = []
    for model, corr in ((m, Corrections.zeros(*z)), (jm, JCorrections.zeros(*z))):
        model.cfg = dataclasses.replace(model.cfg, check_finite_every=every)
        msgs.append(_message(model.run_scenario, corr, years=3,
                             co2_series=co2, collect_monthly=collect))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("state@yr2.ts: 1152 non-finite")


def test_check_finite_every_off_by_default(models):
    _, m = models
    cfg = m.cfg
    try:
        m.cfg = dataclasses.replace(cfg, check_finite_every=0)
        assert GrebConfig().check_finite_every == 0
        state, _, _ = m.run_scenario(
            Corrections.zeros(m.num.nstep_yr, 24, 48), years=2,
            co2_series=np.array([680.0, np.nan], F32), collect_monthly=False)
        assert not bool(torch.isfinite(state.ts).any())
    finally:
        m.cfg = cfg


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with profiling.trace(str(tmp_path / "none")):
                pass


# --- diag.memory -------------------------------------------------------------
GRIDS = [(96, 48, 1800), (192, 96, 1800), (384, 192, 1800), (768, 384, 450)]


@pytest.mark.parametrize("members", [1, 65])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_memory_report_one_shard_equals_greb_tpu(grid, members):
    x, y, dtc = grid
    ours = memory.memory_report(Numerics(xdim=x, ydim=y, dt_crcl=dtc),
                                members)
    theirs = jmemory.memory_report(JNumerics(xdim=x, ydim=y, dt_crcl=dtc),
                                   members)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert memory.format_report(ours) == jmemory.format_report(theirs)
    assert ours.per_shard_total == ours.total


@pytest.fixture(scope="module")
def fold96():
    m = GREB(GrebConfig(fast_circulation=True), verbose=False, device="cpu")
    return m.fold


@pytest.mark.parametrize("n_shards", [2, 4])
def test_memory_report_sharded_names_what_differs(fold96, n_shards):
    """greb_tpu budgets its per-shard slot layout (every shard a block of
    the most composite rows any shard holds, and the advection level
    masks); the port cuts its unsharded fold into row ranges (ROADMAP,
    'Not to port'), so only the pole shards hold composites, their own
    rows', and there are no level masks.  Those lines, the total and the
    largest shard differ; every other field equals greb_tpu's."""
    num = Numerics()
    ours = memory.memory_report(num, 1, n_shards)
    theirs = jmemory.memory_report(JNumerics(), 1, n_shards)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert {k for k in a if a[k] != b[k]} == {"total", "per_shard_total",
                                              "detail"}
    ref_only = {"sharded dense composites (pcomp)",
                "advection level masks (amask)"}
    assert set(b["detail"]) - set(a["detail"]) == ref_only
    assert set(a["detail"]) - set(b["detail"]) == {
        "sharded composites (each shard's rows)"}
    for k in set(a["detail"]) & set(b["detail"]):
        assert a["detail"][k] == b["detail"][k], k
    # what the port's cut fold holds: the pole shards' dense composites
    splan, sconst = fc2.shard_fold(*fold96, n_shards)
    held = [c.pcomp.numel() * 4 if p.comp_kt + p.comp_kb else 0
            for p, c in zip(splan.plans, sconst.shards)]
    comps = ours.detail["sharded composites (each shard's rows)"]
    assert held[0] and held[-1] and comps == sum(held)
    base = ours.total - comps
    assert ours.per_shard_total == base // n_shards + max(held)
    assert theirs.total - b["detail"]["sharded dense composites (pcomp)"] \
        - b["detail"]["advection level masks (amask)"] == base


def test_memory_report_shards_the_port_cannot_cut():
    rep = memory.memory_report(Numerics(), 1, 5)
    assert "48 rows must split evenly" in rep.infeasible_reason
    assert "cannot build" in memory.format_report(rep)


def test_fits_with_explicit_bytes():
    rep = memory.memory_report(Numerics(xdim=768, ydim=384, dt_crcl=450))
    need = rep.per_shard_total / 0.75
    assert rep.fits(hbm_bytes=int(need) + 1)
    assert not rep.fits(hbm_bytes=int(need) - 1)
    assert rep.fits(hbm_bytes=rep.per_shard_total, headroom=1.0)
    theirs = jmemory.memory_report(JNumerics(xdim=768, ydim=384,
                                             dt_crcl=450))
    for hbm in (2 ** 33, 2 ** 34, 2 ** 36):
        assert rep.fits(hbm_bytes=hbm) == theirs.fits(hbm_bytes=hbm)
    with pytest.raises(ValueError, match="not a card"):
        rep.fits(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rep.fits()


def test_n_coef_planes_is_what_build_const_makes(fold96):
    _, const = fold96
    planes = (const.zd.shape[0] + const.zam.shape[0] + const.mer.shape[0]
              + 1)                                   # wz: one plane a field
    assert fc2.N_COEF_PLANES == planes == jfc2.N_COEF_PLANES
    assert const.wz.shape == (2, 48, 96)
    held = sum(t.numel() * 4 for t in (const.zd, const.zam, const.mer,
                                       const.wz))
    assert held == memory.memory_report(Numerics()).fastcirc
