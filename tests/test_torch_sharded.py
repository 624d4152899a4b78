"""Latitude x member sharding in the port, on the CPU (parallel/sharded.py,
parallel/halo.py, ops/fastcirc2.py build_sharded, model/longrun.py
sharded_year_runner, io/checkpoint.py).

The port's fold of a shard is the unsharded fold cut into its rows, and
every zonal part of a substep is row-local, so given its 2 halo rows a
substep a shard does the unsharded fold's arithmetic row for row:

* the port against itself, bit for bit (max |diff| 0): the plain sharded
  spin-up and scenario years (each shard's plain step in a thread of its
  own, the halo exchange among the threads) against the plain unsharded
  ones, in state, corrections and monthly means: 96x48 on 2 and 4
  shards, 128x64 on 8 (advection segments, composite rows on two
  shards), 2 members x 4 shards (ct_sens 22.5 and 22.6, each against its
  own unsharded run), and the strict stencils' masked full-field form at
  32x16 on 4 shards against the unsharded masked form; a sharded run
  stopped after a scenario year, checkpointed (rows gathered to the
  host), restored onto the mesh and resumed equals the uninterrupted
  sharded run (greb_tpu tests/test_config5.py:153, there strict at 96x48,
  here strict at 32x16);
* the port against greb_tpu's sharded runners on the 8-virtual-device
  mesh of the repository's conftest, at those tests' own tolerances:
  tests/test_sharded_fast.py:63 (96x48 on 4), :79 (greb_tpu's lowrank
  composites, held against the port's dense rows), :105 (128x64 on 8),
  :125 (2 members x 4 shards) and tests/test_sharded.py:28 (strict 32x16
  on 4).  Where greb_tpu's test holds its flux-corrected Ts exactly
  against its own unsharded run, the port's is held at the golden-year
  tolerance (tests/test_golden_year.py:29, 2e-2 K): two frameworks round
  the correction in their own order;
* the strict stencils' masked full-field form, which the plain sharded
  runners run, bitwise equal to their compact form, which the unsharded
  strict kernels are held to, at 96x48 (unsharded, 20 steps): so the slab
  kernels' strict years are held against the unsharded strict kernels;
* the plain sharded runners under the legacy words against greb_tpu's:
  log_exp 11 (the fold with switches) at 96x48 at
  tests/test_sharded_fast.py:63's tolerances, log_exp 8 (the strict
  transport, q by diffusion alone) and 2 (no transport) at 32x16 at
  tests/test_sharded.py:28's;
* the slab kernels' share of the strict transport, without a card: each
  shard's sub-cycle counts, row coefficients, wz with the neighbour
  shards' halo rows and one-sided advection rows are the global rows'
  (``slab.cut_strict``, ``slab.wz_halo``), and the strict forms' block
  layouts reckoned by hand;
* what a mesh of CUDA devices runs, checked before anything runs (no card
  needed): the fold's modern word, the strict transport (the library
  default) and every legacy word are accepted (``slab.check_slab``); the
  strict transport and the no-transport words at 768x384 raise
  NotImplementedError naming ROADMAP Queue 1 item 3j; shards that do not
  divide the rows, or leave a shard under 2 rows, raise ValueError.

Inputs are the 96x48 synthetic forcing (regridded for 128x64) on a
20-step calendar, the same numpy arrays for both packages.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greb_tpu.config import GrebConfig as JConfig
from greb_tpu.config import Numerics as JNumerics
from greb_tpu.forcing import Corrections as JCorrections
from greb_tpu.forcing import forcing_from_arrays as jforcing_from_arrays
from greb_tpu.model import core as jcore
from greb_tpu.model.driver import GREB as JGREB
from greb_tpu.ops import fastcirc2 as jfc2
from greb_tpu.parallel import ensemble as jens
from greb_tpu.parallel.sharded import make_mesh as jmake_mesh
from greb_tpu.parallel.sharded import make_sharded_year_runners as jrunners
from greb_tpu.parallel.sharded import shard_fastcirc as jshard_fastcirc
from greb_tpu.parallel.sharded import shard_inputs as jshard_inputs

from greb_tpu.config import Experiment as JExperiment

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import ModelState, forcing_from_arrays
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.io.checkpoint import Checkpointer
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core, longrun
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops import stencils as stc
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import slab
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens
from greb_tpu_torch.parallel import halo
from greb_tpu_torch.parallel import sharded as sh
from greb_tpu_torch.regrid import regrid_forcing_arrays

torch.set_num_threads(1)

F32 = np.float32
CO2 = F32(680.0)
SHORT = dict(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
NUM96 = Numerics(**SHORT)
NUM128 = Numerics(xdim=128, ydim=64, **SHORT)
NUM32 = Numerics(xdim=32, ydim=16, **SHORT)
CT_SENS = F32(22.5) + F32(0.1) * np.arange(2, dtype=F32)
# the golden year's temperature tolerance (tests/test_golden_year.py:29)
TOL_T = 2e-2
# the 128x64 sea-ice cell where one ulp grows past 5e-2 K in a scenario
# year (row, column)
RAMP_CELL_128 = (12, 101)
FIELDS = ("ts", "ta", "to", "q", "cap_surf")

_cache = {}


def _arrays(num):
    key = ("arrays", num.xdim, num.ydim)
    if key not in _cache:
        a = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
        if (num.xdim, num.ydim) != (96, 48):
            a = regrid_forcing_arrays(a, num)
        _cache[key] = a
    return _cache[key]


def _port(num, fast=True, log_exp=None):
    key = ("port", num, fast, log_exp)
    if key not in _cache:
        _cache[key] = GREB(GrebConfig(numerics=num, fast_circulation=fast,
                                      experiment=Experiment(log_exp)),
                           forcing=forcing_from_arrays(_arrays(num), "cpu"),
                           device="cpu", verbose=False)
    return _cache[key]


def _jax(num, fast=True, log_exp=None):
    jnum = JNumerics(**{f.name: getattr(num, f.name)
                        for f in dataclasses.fields(num)})
    return JGREB(JConfig(numerics=jnum, fast_circulation=fast,
                         experiment=JExperiment(log_exp)),
                 forcing=jforcing_from_arrays(_arrays(num)), verbose=False)


def _masked(m):
    """The model data with the strict stencils' masked full-field form."""
    return dataclasses.replace(
        m.md, st=dataclasses.replace(m.st, compact_polar=False))


def _unsharded(num, fast=True, ct_sens=None, compact=False):
    """The plain unsharded spin-up and scenario year: (state after each,
    corrections, monthly means); without the fold the strict stencils'
    masked full-field form, or their compact form (``compact``)."""
    key = ("unsharded", num, fast, ct_sens, compact)
    if key not in _cache:
        m = _port(num, fast)
        md = m.md if fast or compact else _masked(m)
        s0 = m.initial_state()
        if ct_sens is not None:
            p = m.params.replace(ct_sens=F32(ct_sens))
            row = my.pack_member_params([p])[0, 0].numpy()
            md = sh._member_md(sh.ShardModel(md, torch.as_tensor(row)[None,
                                                                      None]),
                               0)
            s0 = ModelState.unstack(
                ens.ensemble_initial_state([p], m.forcing)[:, 0])
        s1, c1 = core.run_year_fluxcorr(s0, m.sfx, CO2, md, num, m.fold)
        s2, outs, _ = core.run_year_scenario(s1, m.sfx, c1, CO2, md, num,
                                             m.fold)
        _cache[key] = (s1, c1, s2, core.monthly_means(m.month_mat, outs))
    return _cache[key]


def _sharded(num, n_y, fast=True, n_ens=1, members=None, log_exp=None):
    """The plain sharded spin-up and scenario year on an (n_ens, n_y) CPU
    mesh under the word ``log_exp``, gathered: (state after each,
    corrections, monthly means)."""
    key = ("sharded", num, n_y, fast, n_ens, members is not None, log_exp)
    if key in _cache:
        return _cache[key]
    m = _port(num, fast, log_exp)
    mesh = sh.make_mesh(n_ens, n_y, ["cpu"])
    splan = fcc = None
    if m.fold is not None:
        splan, sconst = fc2.build_sharded(None, None, m.grid, m.st, 0, n_y,
                                          fold=m.fold)
        fcc = sh.shard_fastcirc(mesh, sconst)
    batched = members is not None
    state, ppack, corr = m.initial_state(), None, None
    if batched:
        state = ens.ensemble_initial_state(members, m.forcing)
        ppack = my.pack_member_params(members)
    flux, scnr = sh.make_sharded_year_runners(mesh, m.st, num, m.exp,
                                              m.month_mat, batched=batched,
                                              fast_plan=splan)
    st_s, sfx_s, _, md_s = sh.shard_inputs(mesh, batched, state, m.sfx,
                                           corr, m.md, ppack)
    s1, c1 = flux(st_s, sfx_s, CO2, md_s, fcc)
    s2, mon, _ = scnr(s1, sfx_s, c1, CO2, md_s, fcc)
    _cache[key] = (s1.gather(), c1.gather(), s2.gather(), mon.gather())
    return _cache[key]


def _members(m):
    return ens.perturbed_params(m.params, {"ct_sens": CT_SENS})


def _assert_bitwise(got, want, member=None):
    gs1, gc1, gs2, gmon = got
    ws1, wc1, ws2, wmon = want
    sel = (lambda a: a[member]) if member is not None else (lambda a: a)
    for f in FIELDS:
        for g, w in ((gs1, ws1), (gs2, ws2)):
            torch.testing.assert_close(sel(getattr(g, f)), getattr(w, f),
                                       rtol=0, atol=0, msg=f)
    for f in ("tf", "tof", "qf"):
        torch.testing.assert_close(sel(getattr(gc1, f)), getattr(wc1, f),
                                   rtol=0, atol=0, msg=f)
    torch.testing.assert_close(sel(gmon), wmon, rtol=0, atol=0)
    assert torch.isfinite(sel(gs2.ts)).all()


# ---------------------------------------------------------------------------
# the port against itself, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num, n_y", [(NUM96, 2), (NUM96, 4), (NUM128, 8)],
                         ids=["96x48-y2", "96x48-y4", "128x64-y8"])
def test_sharded_equals_unsharded(num, n_y):
    splan, _ = fc2.build_sharded(None, None, _port(num).grid, None, 0, n_y,
                                 fold=_port(num).fold)
    assert splan.rloc == num.ydim // n_y
    _assert_bitwise(_sharded(num, n_y), _unsharded(num))


def test_shard_plans_cut_the_global_plan():
    """128x64 on 8 shards: the composite rows and advection segments of
    each pole lie in its outer shard, the band rows spill into the next;
    every shard's plan adds up to the global one."""
    m = _port(NUM128)
    splan, sconst = fc2.build_sharded(None, None, m.grid, m.st, 0, 8,
                                      fold=m.fold)
    p = splan.plan
    assert sum(q.bt for q in splan.plans) == p.bt
    assert sum(q.bb for q in splan.plans) == p.bb
    assert sum(q.comp_kt + q.comp_kb for q in splan.plans) == (
        p.comp_kt + p.comp_kb)
    assert splan.plans[0].adv_segs and splan.plans[-1].adv_segs
    assert [q.comp_mode for q in splan.plans[1:-1]] == ["none"] * 6
    assert sconst.shards[0].pcomp.shape[1] == p.comp_kt
    geo = fc2.sharded_geometry(m.grid, 8, p)
    assert geo.rloc == splan.rloc == 8
    assert geo.kct == tuple(q.comp_kt for q in splan.plans)
    assert geo.kcb == tuple(q.comp_kb for q in splan.plans)
    assert geo.K == max(p.comp_kt, p.comp_kb)


def test_members_on_ens_rows():
    """2 members (ct_sens 22.5, 22.6) on the ens rows x 4 shards: each
    member's rows equal its own unsharded run."""
    m = _port(NUM96)
    got = _sharded(NUM96, 4, n_ens=2, members=_members(m))
    for i, c in enumerate(CT_SENS):
        _assert_bitwise(got, _unsharded(NUM96, ct_sens=c), member=i)


def test_strict_masked_form_32x16():
    _assert_bitwise(_sharded(NUM32, 4, fast=False),
                    _unsharded(NUM32, fast=False))


def test_strict_masked_form_equals_compact_96x48():
    """The strict stencils' masked full-field form (every row sub-cycled to
    the deepest count, a row adding 0 past its own under its 0/1 masks),
    which the plain sharded runners run, against their compact form (the
    polar bands alone), which the unsharded strict kernels are held to,
    unsharded at 96x48 on 20 steps: state, tables and monthly means bit for
    bit."""
    assert _port(NUM96, fast=False).st.compact_polar
    _assert_bitwise(_unsharded(NUM96, fast=False),
                    _unsharded(NUM96, fast=False, compact=True))


def test_halo_exchange_threads():
    """Three shards' rows swapped among three threads: each gets its
    neighbours' edge rows, zeros past the poles."""
    from concurrent.futures import ThreadPoolExecutor
    ex = halo.HaloExchange(3)
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(12, 5)
    parts = x.split(4)
    with ThreadPoolExecutor(3) as pool:
        got = list(pool.map(
            lambda i: halo.halo_exchange_lat(parts[i], 2, ex, i), range(3)))
    full = torch.nn.functional.pad(x, (0, 0, 2, 2))
    for i, g in enumerate(got):
        torch.testing.assert_close(g, full[4 * i:4 * i + 8], rtol=0, atol=0)


def test_sharded_checkpoint_resume(tmp_path):
    """greb_tpu tests/test_config5.py:153 in the port (there strict at
    96x48, here strict at 32x16 for time): a run on 4 shards through
    ``run_long`` over ``sharded_year_runner``, a
    checkpoint after each scenario year (the rows gathered to the host);
    a run stopped after year 1 and resumed from its checkpoint onto the
    mesh equals the uninterrupted one bit for bit, and so do the months
    each streamed (``on_year``)."""
    num = dataclasses.replace(NUM32, time_scnr=2)
    m = _port(num, fast=False)
    mesh = sh.make_mesh(1, 4, ["cpu"])
    flux, scnr = sh.make_sharded_year_runners(mesh, m.st, num, m.exp,
                                              m.month_mat)
    st_s, sfx_s, _, md_s = sh.shard_inputs(mesh, False, m.initial_state(),
                                           m.sfx, None, m.md)
    s1, corr_s = flux(st_s, sfx_s, CO2, md_s)
    co2 = np.full(2, CO2, F32)

    def place(shard):
        return lambda v: v if isinstance(v, sh.Sharded) else shard(mesh, v)

    def runner(months):
        return longrun.sharded_year_runner(
            mesh, scnr, sfx_s, md_s, shard_state=place(sh.shard_state),
            on_year=months.append, shard_corr=place(sh.shard_corr))

    whole = []
    s_ref, _, _ = longrun.run_long(2, s1, corr_s, co2, runner(whole),
                                   chunk_years=1, device="cpu")
    first, rest = [], []
    ck = Checkpointer(str(tmp_path / "ck"), every_years=1)
    longrun.run_long(1, s1, corr_s, co2, runner(first), checkpointer=ck,
                     chunk_years=1, device="cpu")
    assert ck.latest_step() == 1
    # a fresh start: nothing but the checkpoint and the mesh
    s_res, c_res, start = longrun.run_long(
        2, None, None, co2, runner(rest), checkpointer=ck, chunk_years=1,
        device="cpu")
    assert start == 1 and len(whole) == 2 and len(rest) == 1
    s_on, c_on, cur = ck.restore_sharded(mesh, step=1)
    assert cur.year_index == 1 and sorted(s_on) == mesh.local()
    torch.testing.assert_close(c_on.gather().tf, corr_s.gather().tf,
                               rtol=0, atol=0)
    got, want = s_res.gather(), s_ref.gather()
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0, msg=f)
    for a, b in zip(first + rest, whole):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(whole[-1]).all()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
NUM768 = Numerics(xdim=768, ydim=384, dt_crcl=450, ndays_yr=1,
                  jday_mon=(1,), time_flux=1, time_scnr=1)


def test_cuda_mesh_refuses_before_any_launch():
    """No card is needed: the check comes first.  The strict transport (the
    library default, no fold) and the no-transport and strict legacy words
    at 768x384 raise naming ROADMAP Queue 1 item 3j: the year kernels run
    the strict form there on 6 clusters, and a shard's strict block does
    not fit (``slab.SLAB_ITEMS["strict_wide"]``)."""
    st, _ = stc.make_stencil_arrays(make_grid(768, 384, 450))
    assert st.seq_zonal
    mesh = sh.Mesh([[torch.device("cuda", 0)] * 4])
    for log_exp in (None, 4, 7, 8, 16):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3j"):
            sh.make_sharded_year_runners(mesh, st, NUM768,
                                         Experiment(log_exp),
                                         torch.zeros(1, 2))


def test_cuda_mesh_accepts_every_word():
    """What the slab kernels run passes the check made before any launch
    (no card needed): at 96x48, with the fold's shard plan and without it,
    the modern word, the strict transport and every legacy log_exp word,
    on the global plan ``slab.global_plan`` gives (the fold's where it
    moves Ta and q, else the StrictPlan), in both kinds; and the strict
    transport's plans of 224x112 to 384x192 in their forms."""
    m = _port(NUM96)
    splan, _ = fc2.build_sharded(None, None, m.grid, m.st, 0, 2, fold=m.fold)
    for log_exp in (None,) + tuple(range(17)):
        exp = Experiment(log_exp)
        for sp in (splan, None):
            plan = slab.global_plan(sp, exp, NUM96, m.st.seq_zonal)
            fold = core.transport(exp, sp is not None) == "fold"
            assert (plan is sp.plan) if fold else (
                plan == yk.StrictPlan(48, 96))
            for kind in ("fluxcorr", "scenario"):
                slab.check_slab(plan, exp, kind)
    for plan, form in ((yk.StrictPlan(48, 96), "strict_cluster"),
                       (yk.StrictPlan(96, 192), "strict_cluster"),
                       (yk.StrictPlan(112, 224), "strict_additive"),
                       (yk.StrictPlan(176, 352), "strict_additive"),
                       (yk.StrictPlan(192, 384, seq_zonal=True), "strict")):
        assert slab.slab_form(plan) == form
        slab.check_slab(plan, Experiment())
        slab.check_slab(plan, Experiment(4))
    assert slab.slab_form(splan.plans[0]) == "additive"


@pytest.mark.parametrize("n_y", [5, 32])
def test_shards_must_divide_the_rows(n_y):
    m = _port(NUM96)
    with pytest.raises(ValueError, match="latitude shards"):
        fc2.build_sharded(None, None, m.grid, m.st, 0, n_y, fold=m.fold)
    with pytest.raises(ValueError):
        sh.shard_inputs(sh.make_mesh(1, n_y, ["cpu"]), False,
                        m.initial_state(), m.sfx, None, m.md)


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert sh.make_mesh(1, 2).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            sh.make_mesh(1, 2)
    mesh = sh.make_mesh(2, 3, ["cpu"])
    assert mesh.shape == {"ens": 2, "y": 3} and len(mesh.local()) == 6


# ---------------------------------------------------------------------------
# the slab kernels' share of the strict transport, without a card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_y", [2, 4])
def test_strict_constants_cut_the_global_rows(n_y):
    """Each shard's strict constants as the slab kernels take them
    (``slab.SlabRunner``'s shards on a CPU mesh, made without a launch)
    are the global rows': its plan is ``cut_strict`` of the global plan
    (each row's sub-cycle counts the global row's), the rows' constants
    (dxlat^2, the diffusion sub-step, the two advection coefficients) and
    counts the global year data's rows, wz the global wz of Ta and q with
    the neighbour shards' HALO rows each side and zeros past the poles, and
    the one-sided advection rows at global rows 1 and Y-2 the stencils'
    row_mfull, row_pfull."""
    m = _port(NUM96, fast=False)
    gplan, sf = m.year_data.plan, m.md.sf
    assert gplan.sub_cycles is not None and not gplan.seq_zonal
    cpu = torch.device("cpu")
    want, _ = yk._strict_args(m.year_data, cpu)
    wz = torch.nn.functional.pad(torch.stack(
        [m.md.derived.wz_air, m.md.derived.wz_vapor]), (0, 0, 2, 2))
    mesh = sh.make_mesh(1, n_y, ["cpu"])
    runner = slab.SlabRunner(mesh, None, NUM96, m.exp, gplan)
    _, sfx_s, _, md_s = sh.shard_inputs(mesh, False, m.initial_state(),
                                        m.sfx, None, m.md)
    runner._setup(sfx_s, md_s, None)
    R = NUM96.ydim // n_y
    for k, s in runner.shards.items():
        lo, hi = k[1] * R, (k[1] + 1) * R
        assert s.yd.plan == slab.cut_strict(gplan, lo, hi)
        assert s.yd.plan.sub_cycles == tuple(c[lo:hi]
                                             for c in gplan.sub_cycles)
        got, _ = yk._strict_args(s.yd, cpu)
        for name in ("st_rows", "st_n"):
            assert torch.equal(got[name][0], want[name][0][:, lo:hi]), name
        assert torch.equal(s.wz, wz[:, lo:hi + 4])
        # the kernel's one-sided rows: r == 1, r == Yg - 2 of its global
        # rows r = row0 + local row
        r = np.arange(s.slab.row0, s.slab.row0 + R)
        assert np.array_equal(r == 1, sf.row_mfull[lo:hi, 0].numpy())
        assert np.array_equal(r == s.slab.Yg - 2,
                              sf.row_pfull[lo:hi, 0].numpy())
        assert (s.form, s.nf, s.entry("substep"), s.entry("finish")) == (
            "strict_cluster", 2, "slab_strict<strict_cluster>",
            "slab_finish<legacy>")


@pytest.mark.parametrize("form", slab.STRICT_FORMS)
@pytest.mark.parametrize("rows, blocks, X", [(24, 12, 96), (48, 8, 384)])
def test_strict_slab_layout_by_hand(form, rows, blocks, X):
    """A strict slab block's shared memory, reckoned as
    csrc/slab_kernel.cu slab_strict_parts reckons it: wz of both fields
    with 2 halo rows each side, the step's winds in the cluster body's form
    alone, its four (2, R, X) sub-cycle planes (the refined forms' two),
    and 6 words a row of constants (the additive form's 8), rounded up to
    4 words; no transported buffers (global); the fewest rows a block that
    fit."""
    R = rows // blocks
    plan = yk.StrictPlan(rows, X)
    cl = form == "strict_cluster"
    want = dict(transported=0, wz=4 * 2 * (R + 4) * X,
                winds=4 * 2 * R * X if cl else 0,
                subcycle=4 * (4 if cl else 2) * 2 * R * X,
                rowc=4 * (-(-(8 if form == "strict_additive" else 6) * R
                            // 4) * 4))
    assert slab.slab_layout(plan, blocks, form) == want
    assert slab.slab_blocks(plan, form) == rows // 2
    with pytest.raises(ValueError, match="at least 2 rows"):
        slab.slab_layout(plan, rows, form)


# ---------------------------------------------------------------------------
# the port against greb_tpu's sharded runners
# ---------------------------------------------------------------------------
def _jax_sharded(num, n_y, fast=True, batched=False, log_exp=None,
                 **build_kw):
    """greb_tpu's sharded spin-up and scenario year, as
    tests/test_sharded_fast.py's _run_pair and test_sharded.py run them."""
    m = _jax(num, fast, log_exp)
    state0, md = m.initial_state(), m.md
    corr0 = JCorrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    mesh = jmake_mesh(n_ens=2 if batched else 1, n_y=n_y)
    if batched:
        pb = jens.perturbed_params(m.params, {"ct_sens": CT_SENS})
        md = jens.ensemble_data(pb, m.forcing, m.sf)
        state0 = jens.ensemble_initial_state(pb, m.forcing, md)
        corr0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                             corr0)
    args = ()
    kw = {}
    if m.fastcirc_tables() is not None:
        splan, sconst = jfc2.build_sharded(
            np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
            m.grid, m.st, kappa=float(m.params.kappa), n_shards=n_y,
            **build_kw)
        args, kw = (jshard_fastcirc(mesh, sconst),), dict(fast_plan=splan)
    flux, scnr = jrunners(mesh, m.st, num, m.exp, m.month_mat,
                          batched=batched, **kw)
    st_s, sfx_s, _, md_s = jshard_inputs(mesh, batched, state0, m.sfx,
                                         corr0, md)
    s1, c1 = flux(st_s, sfx_s, jnp.float32(CO2), md_s, *args)
    s2, mon, _ = scnr(s1, sfx_s, c1, jnp.float32(CO2), md_s, *args)
    return s1, c1, s2, mon


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("case", ["dense", "lowrank"])
def test_vs_greb_tpu_96x48(case):
    """tests/test_sharded_fast.py:63 and :79: monthly means and the
    scenario's Ts at 2e-2 K, the spin-up's tf at 1 W/m^2."""
    kw = dict(comp_dense_max_bytes=0) if case == "lowrank" else {}
    js1, jc1, js2, jmon = _jax_sharded(NUM96, 4, **kw)
    ps1, pc1, ps2, pmon = _sharded(NUM96, 4)
    np.testing.assert_allclose(_np(ps1.ts), np.asarray(js1.ts), rtol=0,
                               atol=TOL_T)
    if case == "dense":
        np.testing.assert_allclose(_np(pc1.tf), np.asarray(jc1.tf), rtol=0,
                                   atol=1.0)
    np.testing.assert_allclose(_np(pmon), np.asarray(jmon), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(_np(ps2.ts), np.asarray(js2.ts), rtol=0,
                               atol=2e-2)


def test_vs_greb_tpu_128x64():
    """tests/test_sharded_fast.py:105 holds greb_tpu's sharded run against
    its unsharded one at 5e-2 (its sharded plan composites every
    extra-iteration row, its unsharded one iterates the segments, as the
    port's sharded and unsharded runs both do).  The port's sharded run
    is held against both of greb_tpu's runs, with the spin-up's Ts at the
    golden 2e-2 K and the scenario at 5e-2 at every cell but one: at the
    sea-ice cell RAMP_CELL_128 the port's run (sharded or not: they are
    bitwise equal) and greb_tpu's unsharded run differ by 0.109 K in the
    year's last Ts and 5.49e-2 in a monthly mean, held at 2e-1.  That is
    rounding, not a fault: one ulp of Ts there moves greb_tpu's own year
    as far (``test_128x64_ramp_cell_is_rounding``)."""
    m = _jax(NUM128)
    _, fcdata = m._fastcirc_split()
    s0 = m.initial_state()
    ju1, juc = m._year_fluxcorr()(s0, m.sfx, jnp.float32(CO2), m.md, fcdata)
    ju2, jumon, _ = m._year_scenario()(ju1, m.sfx, juc, jnp.float32(CO2),
                                       m.md, fcdata)
    js1, _, js2, jmon = _jax_sharded(NUM128, 8)
    ps1, _, ps2, pmon = _sharded(NUM128, 8)
    cell = (Ellipsis,) + RAMP_CELL_128
    for w1, wmon, w2 in ((ju1, jumon, ju2), (js1, jmon, js2)):
        np.testing.assert_allclose(_np(ps1.ts), np.asarray(w1.ts), rtol=0,
                                   atol=TOL_T)
        for got, want in ((_np(pmon), np.asarray(wmon)),
                          (_np(ps2.ts), np.asarray(w2.ts))):
            np.testing.assert_allclose(got[cell], want[cell], rtol=0,
                                       atol=2e-1)
            got, want = got.copy(), want.copy()
            got[cell] = want[cell]
            np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_128x64_ramp_cell_is_rounding():
    """greb_tpu alone: its scenario year from its own spin-up, step by
    step, and the same year with Ts at RAMP_CELL_128 moved one ulp up
    after step 2.  The cell's sea-ice capacity drops to ~5e6 J/K/m^2 at
    step 5 and jumps back up the ice ramp at step 16, so the ulp grows to
    ~5e-3 K at step 6 and ~0.1 K at the year's end, as the port's run and
    greb_tpu's differ there (their steps from one state agree to an ulp)."""
    m = _jax(NUM128)
    plan, fcdata = m._fastcirc_split()
    fcirc = (plan,) + tuple(fcdata)
    flux = jax.jit(lambda s, fx: jcore.fluxcorr_step(
        s, fx, jnp.float32(CO2), m.md, m.st, m.num, m.exp, fastcirc=fcirc))
    scnr = jax.jit(lambda s, fx, c: jcore.scenario_step(
        s, fx, c, jnp.float32(CO2), m.md, m.st, m.num, m.exp,
        fastcirc=fcirc))
    at = lambda t: jax.tree.map(lambda a: a[t], m.sfx)
    s, corr = m.initial_state(), []
    for t in range(NUM128.nstep_yr):
        s, c = flux(s, at(t))
        corr.append(c)
    ends = []
    for bump in (False, True):
        x = s
        for t in range(NUM128.nstep_yr):
            x, _ = scnr(x, at(t), corr[t])
            if bump and t == 2:
                ts = np.array(x.ts)
                ts[RAMP_CELL_128] = np.nextafter(ts[RAMP_CELL_128],
                                                 F32(np.inf))
                x = x.replace(ts=jnp.asarray(ts))
        ends.append(np.asarray(x.ts))
    assert np.isfinite(ends[1]).all()
    assert abs(ends[1][RAMP_CELL_128] - ends[0][RAMP_CELL_128]) > 5e-2


def test_vs_greb_tpu_members():
    """tests/test_sharded_fast.py:125: 2 members x 4 shards, 2e-2."""
    _, _, js2, jmon = _jax_sharded(NUM96, 4, batched=True)
    m = _port(NUM96)
    _, _, ps2, pmon = _sharded(NUM96, 4, n_ens=2, members=_members(m))
    np.testing.assert_allclose(_np(pmon), np.asarray(jmon), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(_np(ps2.ts), np.asarray(js2.ts), rtol=0,
                               atol=2e-2)


def test_vs_greb_tpu_strict_32x16():
    """tests/test_sharded.py:28: the strict masked stencils on 4 shards;
    ts rtol 1e-5 atol 1e-3, tf rtol 1e-4 atol 2, monthly rtol 1e-5
    atol 2e-3, q rtol 1e-4 atol 1e-7 (greb_tpu spins up at 298 ppm there,
    the port's runs at 680: both packages here at 680)."""
    js1, jc1, js2, jmon = _jax_sharded(NUM32, 4, fast=False)
    ps1, pc1, ps2, pmon = _sharded(NUM32, 4, fast=False)
    np.testing.assert_allclose(_np(ps1.ts), np.asarray(js1.ts), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(_np(pc1.tf), np.asarray(jc1.tf), rtol=1e-4,
                               atol=2.0)
    np.testing.assert_allclose(_np(pmon), np.asarray(jmon), rtol=1e-5,
                               atol=2e-3)
    np.testing.assert_allclose(_np(ps2.q), np.asarray(js2.q), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("log_exp", [11, 8, 2])
def test_vs_greb_tpu_legacy_words(log_exp):
    """The plain sharded runners under a legacy word on 4 shards against
    greb_tpu's on the 8-virtual-device mesh.  log_exp 11 (the fold with the
    linearised vapour feedback) at 96x48 at tests/test_sharded_fast.py:63's
    tolerances, as ``test_vs_greb_tpu_96x48``: monthly means and the
    scenario's Ts 2e-2 K, the spin-up's Ts at the golden 2e-2 K and its tf
    1 W/m^2.  log_exp 8 (the strict transport, q by diffusion alone) and 2
    (no transport) at 32x16 at tests/test_sharded.py:28's, as
    ``test_vs_greb_tpu_strict_32x16``: ts rtol 1e-5 atol 1e-3, tf rtol 1e-4
    atol 2, monthly rtol 1e-5 atol 2e-3, q rtol 1e-4 atol 1e-7."""
    fold = log_exp == 11
    num = NUM96 if fold else NUM32
    js1, jc1, js2, jmon = _jax_sharded(num, 4, fast=fold, log_exp=log_exp)
    ps1, pc1, ps2, pmon = _sharded(num, 4, fast=fold, log_exp=log_exp)
    assert _port(num, fold, log_exp).fold is not None or not fold
    if fold:
        tol = dict(ts1=(0, TOL_T), tf=(0, 1.0), mon=(0, 2e-2),
                   ts2=(0, 2e-2))
    else:
        tol = dict(ts1=(1e-5, 1e-3), tf=(1e-4, 2.0), mon=(1e-5, 2e-3),
                   q2=(1e-4, 1e-7))
    pairs = dict(ts1=(ps1.ts, js1.ts), tf=(pc1.tf, jc1.tf), mon=(pmon, jmon),
                 ts2=(ps2.ts, js2.ts), q2=(ps2.q, js2.q))
    for name, (rtol, atol) in tol.items():
        got, want = pairs[name]
        assert np.isfinite(_np(got)).all(), name
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                                   atol=atol, err_msg=name)
