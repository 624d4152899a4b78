"""The CUDA year kernels against their plain PyTorch versions, on the card:
the single-run kernels (spin-up and scenario year) and the member-batched
ones (spin-up years of M members, multi-year scenario blocks, at M=2), on
a thread-block cluster of each offered size; K3 also with one correction
table that every member reads (an ensemble's shared spin-up).

A CUDA kernel has no CPU mode, so these tests need a card and skip
without one.  They import no JAX; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest files set JAX up).  The
grid is the main path's 96x48, with dense pole composites and 24
substeps, on a 10-day calendar; ``chip_smoke.py`` runs the full calendar.
Every kernel must equal its plain version bit for bit (max |diff| = 0),
and at M=1 with the base params the member kernels must equal the
single-run kernels (K3 = K2, K4 = K1): they run the same cluster body and
per-cell device functions.  The same holds under the legacy ``log_exp``
switchboard: K1 and K2 for every log_exp, K3/K4 against K2/K1 under 11
and 15, and under the strict transport (the strict circulation, log_exp
7, 8, 16: the kernels' strict instantiation), whose shared-memory layout
the kernel reckons as ``cluster_layout`` does at every offered size.  At
the refined 384x192 grid (an extension-mode plan, on forcing regridded
from the 96x48 synthetic forcing, the 4-step calendar) the four kernels'
refined instantiation equals its plain version (K4 and K3 at M=2 with
members that differ, K3 over two years with a table per member and with
one shared table), K4 = K1 and K3 = K2 at M=1, and the kernel reckons its
block as ``refined_layout`` does.  There K1 and K2 also equal their plain
versions under the legacy fold words 5, 11 and 15 (the refined legacy
variant) and under the strict circulation and the no-transport word
(the refined instantiation's strict form, whose block the kernel reckons
as ``strict_refined_layout`` does); the launchers pick the kernel that
``refined_entry`` names for every word in every form.  At 768x384 (config
5's grid at dt_crcl=450, a 2-step calendar) the four kernels' wide form
(``*_wide``, ``*_wide_legacy``: one run or member on 6 clusters of 16
blocks, a grid barrier each substep) equals its plain version: K1, K2
from the initial state with zero corrections, modern and under log_exp
11; K4 and K3 at M=2 (one member a launch), K3 with a table per member and
one shared; K4 = K1 and K3 = K2 at M=1; and the kernel reckons its block as
``refined_layout`` does on 6 clusters.  At 256x128 (a 2-step calendar)
the entries of csrc/band_kernel.cu equal their plain versions: the fold's
additive packed form, modern and under log_exp 11, and the strict
additive form (the strict circulation), K1, K2, K4 and K3 at M=2, K4 = K1
and K3 = K2 at M=1; the kernel reckons both forms' blocks as Python does at
every grid from 224x112 to 352x176, and its launchers pick the entries
``refined_entry`` names.  Latitude sharding on the card: the slab
kernels (csrc/slab_kernel.cu) on 2 and 4 shards of the card equal K1 ->
K2 (the fold at 96x48, and 256x128's additive packed form on 4 shards;
the strict transport, log_exp 8, 11 and 2 at 96x48 on 2 shards), K4 -> K3
at M=2 and the plain sharded version, and the kernel reckons each form's
block as ``slab.slab_layout`` does.
"""
import dataclasses

import numpy as np
import pytest
import torch

from greb_tpu_torch.config import Experiment, GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections, forcing_from_arrays
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.io.synthetic import make_synthetic_forcing
from greb_tpu_torch.model import core
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc as fc
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk
from greb_tpu_torch.parallel import ensemble as ens
from greb_tpu_torch.regrid import regrid_forcing_arrays

pytestmark = pytest.mark.cuda

NUM = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    return GREB(GrebConfig(numerics=NUM, fast_circulation=True), verbose=False,
                device="cuda")


def _equal(a, b, name):
    diff = float((a - b).abs().max())
    assert diff == 0.0, f"{name}: max |diff| {diff}"


@pytest.mark.parametrize("cluster", yk.CLUSTER_SIZES["fluxcorr"])
def test_fluxcorr_year_kernel_matches_plain(model, cluster):
    s0 = model.initial_state()
    n0 = yk.fluxcorr_year.launches
    s_k, c_k = yk.fluxcorr_year(s0, 298.0, model.year_data, cluster=cluster)
    assert yk.fluxcorr_year.launches == n0 + 1
    s_p, c_p = yk.fluxcorr_year_plain(s0, 298.0, model.year_data)
    _equal(s_k.stack(), s_p.stack(), "state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c_k, name), getattr(c_p, name), name)


@pytest.mark.parametrize("cluster", yk.CLUSTER_SIZES["scenario"])
def test_scenario_year_kernel_matches_plain(model, cluster):
    s0, corr = yk.fluxcorr_year_plain(model.initial_state(), 298.0,
                                      model.year_data)
    n0 = yk.scenario_year.launches
    s_k, o_k, a_k = yk.scenario_year(s0, corr, 680.0, model.year_data,
                                     cluster=cluster)
    assert yk.scenario_year.launches == n0 + 1
    s_p, o_p, a_p = yk.scenario_year_plain(s0, corr, 680.0, model.year_data)
    _equal(s_k.stack(), s_p.stack(), "state")
    _equal(o_k, o_p, "outs")
    _equal(a_k, a_p, "annual sums")


@pytest.mark.parametrize("cluster", yk.offered_sizes("scenario_years"))
def test_scenario_year_on_a_cluster_equals_the_member_kernel(model, cluster):
    """K2 against K3 at M=1 with the base params for the same year: the
    per-cell device functions are shared, so state, annual sums and
    monthly means agree bit for bit."""
    yd = model.year_data
    s0, corr = yk.fluxcorr_year_plain(model.initial_state(), 298.0, yd)
    s_2, o_2, a_2 = yk.scenario_year(s0, corr, 680.0, yd)
    ppack = my.pack_member_params([model.params], "cuda")
    corrpack = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
    s_3, m_3, a_3 = my.scenario_years(s0.stack()[:, None], ppack, corrpack,
                                      np.asarray([680.0], np.float32), yd,
                                      cluster=cluster)
    _equal(s_2.stack(), s_3[:, 0], "state")
    _equal(a_2, a_3[0, 0], "annual sums")
    # K3 sums w * fields step by step, as monthly_means' plain loop does
    _, m_p, _ = my.scenario_years_plain(s0.stack()[:, None], ppack, corrpack,
                                        np.asarray([680.0], np.float32), yd)
    _equal(m_3, m_p, "monthly means")


@pytest.mark.parametrize("cluster", yk.offered_sizes("fluxcorr"))
def test_fluxcorr_year_on_a_cluster_equals_the_member_kernel(model, cluster):
    """K1 against K4 at M=1 with the base params: the base member's pack
    reproduces the model's params, so state and all three correction
    tables agree bit for bit."""
    yd = model.year_data
    s0 = model.initial_state()
    s_1, c_1 = yk.fluxcorr_year(s0, 298.0, yd)
    ppack = my.pack_member_params([model.params], "cuda")
    s_4, c_4 = my.fluxcorr_years(s0.stack()[:, None], ppack, 298.0, yd,
                                 cluster=cluster)
    _equal(s_1.stack(), s_4[:, 0], "state")
    for i, name in enumerate(("tf", "tof", "qf")):
        _equal(getattr(c_1, name), c_4[0, :, i], name)


def test_kernel_rejects_an_unoffered_cluster(model):
    with pytest.raises(ValueError, match="clusters of"):
        yk.fluxcorr_year(model.initial_state(), 298.0, model.year_data,
                         cluster=2)


def test_kernel_rejects_what_it_does_not_run(model):
    s0 = model.initial_state()
    with pytest.raises(ValueError, match="float32"):
        bad = s0.replace(ts=s0.ts.double())
        yk.fluxcorr_year(bad, 298.0, model.year_data)


@pytest.mark.parametrize("cluster", sorted(set(
    yk.offered_sizes("fluxcorr") + yk.offered_sizes("scenario_years"))))
def test_member_kernels_match_plain(model, cluster):
    """K4 then K3 (2 years, CO2 560 and 680) at M=2 members, ct_sens +-2%,
    on ``cluster`` blocks a member, each bitwise equal to its plain version
    on the same inputs; a kernel refuses a size it does not offer."""
    yd = model.year_data
    members = ens.perturbed_params(model.params,
                                   {"ct_sens": [22.05, 22.95]})
    ppack = my.pack_member_params(members, "cuda")
    s5 = model.initial_state().stack()[:, None].repeat(1, 2, 1, 1)
    n4, n3 = my.fluxcorr_years.launches, my.scenario_years.launches
    s_p, c_p = my.fluxcorr_years_plain(s5, ppack, 298.0, yd)
    if cluster in yk.offered_sizes("fluxcorr"):
        s_k, c_k = my.fluxcorr_years(s5, ppack, 298.0, yd, cluster=cluster)
        assert my.fluxcorr_years.launches == n4 + 1
        _equal(s_k, s_p, "K4 state")
        _equal(c_k, c_p, "K4 tables")
        assert not torch.equal(s_k[:, 0], s_k[:, 1]), "members do not differ"
    else:
        with pytest.raises(ValueError, match="clusters of"):
            my.fluxcorr_years(s5, ppack, 298.0, yd, cluster=cluster)

    co2 = np.asarray([560.0, 680.0], np.float32)
    if cluster not in yk.offered_sizes("scenario_years"):
        with pytest.raises(ValueError, match="clusters of"):
            my.scenario_years(s_p, ppack, c_p, co2, yd, cluster=cluster)
        return
    s3_k, m_k, a_k = my.scenario_years(s_p, ppack, c_p, co2, yd,
                                       cluster=cluster)
    assert my.scenario_years.launches == n3 + 1
    s3_p, m_p, a_p = my.scenario_years_plain(s_p, ppack, c_p, co2, yd)
    _equal(s3_k, s3_p, "K3 state")
    _equal(m_k, m_p, "K3 monthly means")
    _equal(a_k, a_p, "K3 annual sums")
    assert not torch.equal(m_k[0], m_k[1]), "members do not differ"


@pytest.mark.parametrize("cluster", yk.offered_sizes("scenario_years"))
def test_scenario_years_kernel_reads_one_shared_table(model, cluster):
    """K3 at M=3 (ct_sens -2%, base, +2%) over 2 years with one correction
    table (1, T, 3, Y, X) that every member reads: bitwise equal to its
    plain version and to the kernel given the table copied M times."""
    yd = model.year_data
    members = ens.perturbed_params(model.params,
                                   {"ct_sens": [22.05, 22.5, 22.95]})
    ppack = my.pack_member_params(members, "cuda")
    s0, corr = yk.fluxcorr_year_plain(model.initial_state(), 298.0, yd)
    s5 = s0.stack()[:, None].repeat(1, 3, 1, 1)
    shared = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
    copies = shared.expand(3, -1, -1, -1, -1).contiguous()
    co2 = np.asarray([560.0, 680.0], np.float32)
    n3 = my.scenario_years.launches
    got = my.scenario_years(s5, ppack, shared, co2, yd, cluster=cluster)
    assert my.scenario_years.launches == n3 + 1
    want = my.scenario_years(s5, ppack, copies, co2, yd, cluster=cluster)
    plain = my.scenario_years_plain(s5, ppack, shared, co2, yd)
    for name, g, w, p in zip(("state", "monthly means", "annual sums"),
                             got, want, plain):
        _equal(g, w, f"K3 shared vs copied table, {name}")
        _equal(g, p, f"K3 shared table vs plain, {name}")
    assert not torch.equal(got[1][0], got[1][2]), "members do not differ"


# the legacy log_exp values whose transport is the folded circulation or
# none; 7, 8 and 16 transport with the strict stencils (STRICT_MODES)
LEGACY_EXPS = (0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 14, 15)
# the strict transport: log_exp 7, 8, 16 and the strict circulation (None)
STRICT_MODES = (7, 8, 16, None)


def _legacy_model(log_exp, fast_circulation=True):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    return GREB(GrebConfig(numerics=NUM, experiment=Experiment(log_exp),
                           fast_circulation=fast_circulation),
                verbose=False, device="cuda")


@pytest.mark.parametrize("log_exp", LEGACY_EXPS)
def test_legacy_year_kernels_match_plain(log_exp):
    """K1 then K2 under the legacy switchboard, each bitwise equal to its
    plain version on the same inputs: the spin-up at CO2_ctrl, the scenario
    year at 680 ppm from the spin-up's end."""
    m = _legacy_model(log_exp)
    yd, co2 = m.year_data, m.exp.co2_ctrl
    s0 = m.initial_state()
    s_k, c_k = yk.fluxcorr_year(s0, co2, yd)
    s_p, c_p = yk.fluxcorr_year_plain(s0, co2, yd)
    _equal(s_k.stack(), s_p.stack(), "K1 state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c_k, name), getattr(c_p, name), f"K1 {name}")
    s2_k, o_k, a_k = yk.scenario_year(s_p, c_p, 680.0, yd)
    s2_p, o_p, a_p = yk.scenario_year_plain(s_p, c_p, 680.0, yd)
    _equal(s2_k.stack(), s2_p.stack(), "K2 state")
    _equal(o_k, o_p, "K2 outs")
    _equal(a_k, a_p, "K2 annual sums")


@pytest.mark.parametrize("log_exp", (11, 15))
def test_legacy_member_kernels_equal_the_single_run_kernels(log_exp):
    """K2 = K3 and K1 = K4 at M=1 under the switchboard, at every size the
    member kernels offer: the flags word reaches them through the member
    params unchanged."""
    m = _legacy_model(log_exp)
    yd, co2 = m.year_data, m.exp.co2_ctrl
    s0 = m.initial_state()
    ppack = my.pack_member_params([m.params], "cuda")
    s_1, c_1 = yk.fluxcorr_year(s0, co2, yd)
    for cluster in yk.offered_sizes("fluxcorr"):
        s_4, c_4 = my.fluxcorr_years(s0.stack()[:, None], ppack, co2, yd,
                                     cluster=cluster)
        _equal(s_1.stack(), s_4[:, 0], f"K4 C={cluster} state")
        for i, name in enumerate(("tf", "tof", "qf")):
            _equal(getattr(c_1, name), c_4[0, :, i], f"K4 C={cluster} {name}")
    s_2, _, a_2 = yk.scenario_year(s_1, c_1, 680.0, yd)
    corrpack = torch.stack([c_1.tf, c_1.tof, c_1.qf], dim=1)[None]
    for cluster in yk.offered_sizes("scenario_years"):
        s_3, _, a_3 = my.scenario_years(s_1.stack()[:, None], ppack, corrpack,
                                        np.asarray([680.0], np.float32), yd,
                                        cluster=cluster)
        _equal(s_2.stack(), s_3[:, 0], f"K3 C={cluster} state")
        _equal(a_2, a_3[0, 0], f"K3 C={cluster} annual sums")


@pytest.mark.parametrize("log_exp", STRICT_MODES,
                         ids=["log_exp7", "log_exp8", "log_exp16", "strict"])
def test_strict_year_kernels_match_plain(log_exp):
    """K1 then K2 under the strict transport (the strict instantiation),
    each bitwise equal to its plain version on the same inputs, at every
    offered size."""
    m = _legacy_model(log_exp, fast_circulation=log_exp is not None)
    yd = m.year_data
    assert yd.transport == "strict" and m.fold is None
    co2 = m.exp.co2_ctrl if m.exp.active else 298.0
    s0 = m.initial_state()
    s_p, c_p = yk.fluxcorr_year_plain(s0, co2, yd)
    s2_p, o_p, a_p = yk.scenario_year_plain(s_p, c_p, 680.0, yd)
    for cluster in yk.CLUSTER_SIZES["fluxcorr"]:
        s_k, c_k = yk.fluxcorr_year(s0, co2, yd, cluster=cluster)
        _equal(s_k.stack(), s_p.stack(), f"K1 C={cluster} state")
        for name in ("tf", "tof", "qf"):
            _equal(getattr(c_k, name), getattr(c_p, name),
                   f"K1 C={cluster} {name}")
        s2_k, o_k, a_k = yk.scenario_year(s_p, c_p, 680.0, yd,
                                          cluster=cluster)
        _equal(s2_k.stack(), s2_p.stack(), f"K2 C={cluster} state")
        _equal(o_k, o_p, f"K2 C={cluster} outs")
        _equal(a_k, a_p, f"K2 C={cluster} annual sums")


@pytest.mark.parametrize("kind,cluster", [
    (kind, c) for kind in yk.KINDS for c in yk.CLUSTER_SIZES[kind]])
def test_strict_cluster_layout_matches_the_kernel(kind, cluster):
    """The strict instantiation's layout (``StrictPlan``): the kernel's
    own reckoning equals ``cluster_layout``, part for part."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layout is the built kernel's")
    plan = yk.StrictPlan(NUM.ydim, NUM.xdim)
    lay = yk.cluster_layout(plan, cluster, kind)
    parts, threads = yk.kernel_cluster_layout(plan, cluster, kind)
    assert parts == dict(lay.parts) and threads == lay.threads
    assert yk.cluster_capacity(plan, cluster, kind) >= 1


def test_kernel_refuses_an_unknown_flag(model, monkeypatch):
    """A flags word with a bit the kernels do not know raises in the
    wrapper (the launcher's GREB_ERR_FLAGS); nothing runs."""
    monkeypatch.setattr(yk, "experiment_flags",
                        lambda exp, strict=False: 1 << len(yk.FLAGS))
    n0 = yk.fluxcorr_year.launches
    with pytest.raises(RuntimeError, match="do not know"):
        yk.fluxcorr_year(model.initial_state(), 298.0, model.year_data)
    assert yk.fluxcorr_year.launches == n0


REFINED = Numerics(xdim=384, ydim=192, dt_crcl=1800, ndays_yr=2,
                   jday_mon=(2,), time_flux=1, time_scnr=1)


@pytest.fixture(scope="module")
def refined_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    arrs = regrid_forcing_arrays(make_synthetic_forcing(
        96, 48, REFINED.nstep_yr, REFINED.ndays_yr), REFINED)
    return GREB(GrebConfig(numerics=REFINED, fast_circulation=True),
                forcing=forcing_from_arrays(arrs, "cuda"), verbose=False,
                device="cuda")


def test_refined_year_kernels_match_plain(refined_model):
    """K1 from the initial state at 340 ppm, K2 from it with zero
    corrections at 680 ppm (finite on this calendar), bit for bit."""
    m = refined_model
    yd, s0 = m.year_data, m.initial_state()
    n1, n2 = yk.fluxcorr_year.launches, yk.scenario_year.launches
    s_k, c_k = yk.fluxcorr_year(s0, 340.0, yd)
    s_p, c_p = yk.fluxcorr_year_plain(s0, 340.0, yd)
    _equal(s_k.stack(), s_p.stack(), "K1 state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c_k, name), getattr(c_p, name), f"K1 {name}")
    zero = Corrections.zeros(REFINED.nstep_yr, REFINED.ydim, REFINED.xdim,
                             device="cuda")
    s_k, o_k, a_k = yk.scenario_year(s0, zero, 680.0, yd)
    s_p, o_p, a_p = yk.scenario_year_plain(s0, zero, 680.0, yd)
    assert torch.isfinite(s_k.stack()).all() and torch.isfinite(o_k).all()
    _equal(s_k.stack(), s_p.stack(), "K2 state")
    _equal(o_k, o_p, "K2 outs")
    _equal(a_k, a_p, "K2 annual sums")
    assert (yk.fluxcorr_year.launches, yk.scenario_year.launches) == (
        n1 + 1, n2 + 1)


@pytest.mark.parametrize("kind", yk.KINDS)
def test_refined_layout_matches_the_kernel(refined_model, kind):
    plan = refined_model.fold[0]
    lay = yk.refined_layout(plan, yk.DEFAULT_CLUSTER, kind)
    parts, threads = yk.kernel_cluster_layout(plan, yk.DEFAULT_CLUSTER, kind)
    assert parts == dict(lay.parts) and threads == lay.threads
    assert yk.cluster_capacity(plan, yk.DEFAULT_CLUSTER, kind) >= 1


@pytest.mark.parametrize("shared", (False, True))
def test_refined_member_kernels_match_plain(refined_model, shared):
    """K4 at M=2 (ct_sens 22.05, 22.95) from the initial state at 340 ppm;
    K3 at M=2 over two years from the initial state at 680 ppm with zero
    tables, a table per member or one shared (finite on this calendar);
    both bit for bit, and at M=1 with the base params equal to K1 and K2."""
    m = refined_model
    yd, s0 = m.year_data, m.initial_state()
    members = ens.perturbed_params(m.params, {"ct_sens": [22.05, 22.95]})
    pp = my.pack_member_params(members, "cuda")
    s5 = ens.ensemble_initial_state(members, m.forcing)
    n4, n3 = my.fluxcorr_years.launches, my.scenario_years.launches
    s_k, c_k = my.fluxcorr_years(s5, pp, 340.0, yd)
    s_p, c_p = my.fluxcorr_years_plain(s5, pp, 340.0, yd)
    assert not torch.equal(c_k[0], c_k[1])
    _equal(s_k, s_p, "K4 state")
    _equal(c_k, c_p, "K4 tables")
    shape = (REFINED.nstep_yr, 3, REFINED.ydim, REFINED.xdim)
    tab = torch.zeros((1 if shared else 2,) + shape, device="cuda")
    co2 = np.full(2, 680.0, np.float32)
    got = my.scenario_years(s5, pp, tab, co2, yd)
    want = my.scenario_years_plain(s5, pp, tab, co2, yd)
    assert torch.isfinite(got[1]).all() and not torch.equal(got[1][0],
                                                             got[1][1])
    for name, k, p in zip(("state", "monthly means", "annual sums"), got,
                          want):
        _equal(k, p, f"K3 {name}")
    assert (my.fluxcorr_years.launches, my.scenario_years.launches) == (
        n4 + 1, n3 + 1)
    base = my.pack_member_params([m.params], "cuda")
    s4, c4 = my.fluxcorr_years(s0.stack()[:, None], base, 340.0, yd)
    s1, c1 = yk.fluxcorr_year(s0, 340.0, yd)
    _equal(s4[:, 0], s1.stack(), "K4 = K1 state")
    _equal(c4[0], torch.stack([c1.tf, c1.tof, c1.qf], dim=1), "K4 = K1")
    s3, _, a3 = my.scenario_years(s0.stack()[:, None], base, tab[:1], co2[:1],
                                  yd)
    zero = Corrections.zeros(REFINED.nstep_yr, REFINED.ydim, REFINED.xdim,
                             device="cuda")
    s2, _, a2 = yk.scenario_year(s0, zero, 680.0, yd)
    _equal(s3[:, 0], s2.stack(), "K3 = K2 state")
    _equal(a3[0, 0], a2, "K3 = K2 annual sums")


@pytest.mark.parametrize("log_exp", (5, 11, 15))
def test_refined_legacy_year_kernels_match_plain(log_exp):
    """K1 and K2 of the refined legacy variant at 384x192 (K2 from the
    initial state with zero corrections), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    _refined_pair_matches_plain(Experiment(log_exp), True)


@pytest.mark.parametrize("log_exp", (None, 4),
                         ids=("strict circulation", "log_exp 4"))
def test_strict_refined_year_kernels_match_plain(log_exp):
    """K1 and K2 of the refined instantiation's strict form at 384x192:
    the strict circulation, and the no-transport word, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    _refined_pair_matches_plain(Experiment(log_exp), log_exp is not None)


def _refined_pair_matches_plain(exp, fast):
    arrs = regrid_forcing_arrays(make_synthetic_forcing(
        96, 48, REFINED.nstep_yr, REFINED.ndays_yr), REFINED)
    m = GREB(GrebConfig(numerics=REFINED, experiment=exp,
                        fast_circulation=fast),
             forcing=forcing_from_arrays(arrs, "cuda"), verbose=False,
             device="cuda")
    yd, s0 = m.year_data, m.initial_state()
    assert yk.is_refined(yd.plan) and yd.flags
    co2 = np.float32(exp.co2_ctrl if exp.active else 340.0)
    s_k, c_k = yk.fluxcorr_year(s0, co2, yd)
    s_p, c_p = yk.fluxcorr_year_plain(s0, co2, yd)
    _equal(s_k.stack(), s_p.stack(), "K1 state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c_k, name), getattr(c_p, name), f"K1 {name}")
    zero = Corrections.zeros(REFINED.nstep_yr, REFINED.ydim, REFINED.xdim,
                             device="cuda")
    s_k, o_k, a_k = yk.scenario_year(s0, zero, 680.0, yd)
    s_p, o_p, a_p = yk.scenario_year_plain(s0, zero, 680.0, yd)
    assert torch.isfinite(s_k.stack()).all()
    _equal(s_k.stack(), s_p.stack(), "K2 state")
    _equal(o_k, o_p, "K2 outs")
    _equal(a_k, a_p, "K2 annual sums")


@pytest.mark.parametrize("kind", yk.KINDS)
def test_strict_refined_layout_matches_the_kernel(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layout is the built kernel's")
    plan = yk.StrictPlan(REFINED.ydim, REFINED.xdim, seq_zonal=True)
    lay = yk.strict_refined_layout(plan, yk.DEFAULT_CLUSTER, kind)
    parts, threads = yk.kernel_cluster_layout(plan, yk.DEFAULT_CLUSTER, kind)
    assert parts == dict(lay.parts) and threads == lay.threads
    assert yk.cluster_capacity(plan, yk.DEFAULT_CLUSTER, kind) >= 1


def test_refined_launchers_pick_the_named_kernel(refined_model):
    """For every log_exp word (and the strict circulation's) in each form,
    the launchers' pick (csrc/refined_kernel.cu refined_pick) is the kernel
    ``refined_entry`` names, or none where it raises."""
    lib = yk._refined_lib()
    plans = (refined_model.fold[0], fc.make_plan(make_grid(192, 96, 1800)),
             yk.StrictPlan(REFINED.ydim, REFINED.xdim, seq_zonal=True),
             dataclasses.replace(refined_model.fold[0], ydim=384, xdim=768))
    words = {yk.experiment_flags(Experiment(e), e in (7, 8, 16))
             for e in range(17)} | {0, yk.experiment_flags(Experiment(),
                                                           True)}
    for plan in plans:
        form = yk.REFINED_FORMS.index(yk.refined_form(plan))
        groups = yk._refined_struct(plan).groups
        for flags in words:
            got = lib.greb_refined_pick(flags, form, groups)
            try:
                want = yk.REFINED_SUFFIXES.index(yk.refined_entry(
                    "fluxcorr_year", plan, flags)[len("fluxcorr_year"):])
            except ValueError:
                want = -1
            assert got == want, (plan, hex(flags))


GRID768 = Numerics(xdim=768, ydim=384, dt_crcl=450, ndays_yr=1,
                   jday_mon=(1,), time_flux=1, time_scnr=1)


def _grid768(log_exp=None):
    arrs = regrid_forcing_arrays(make_synthetic_forcing(
        96, 48, GRID768.nstep_yr, GRID768.ndays_yr), GRID768)
    return GREB(GrebConfig(numerics=GRID768, fast_circulation=True,
                           experiment=Experiment(log_exp)),
                forcing=forcing_from_arrays(arrs, "cuda"), verbose=False,
                device="cuda")


@pytest.fixture(scope="module")
def grid768_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    return _grid768()


@pytest.mark.parametrize("log_exp", (None, 11), ids=("modern", "log_exp 11"))
def test_wide_year_kernels_match_plain(grid768_model, log_exp):
    """K1 (``fluxcorr_year_wide``, ``_wide_legacy``) from the initial
    state, K2 from it with zero corrections (finite on this calendar), bit
    for bit; the launchers pick the entries ``refined_entry`` names."""
    m = grid768_model if log_exp is None else _grid768(log_exp)
    yd, s0 = m.year_data, m.initial_state()
    assert yk.refined_groups(yd.plan) == 6
    suffix = "_wide" if log_exp is None else "_wide_legacy"
    lib = yk._refined_lib()
    for kernel in ("fluxcorr_year", "scenario_year"):
        assert yk.refined_entry(kernel, yd.plan, yd.flags) == kernel + suffix
        got = lib.greb_refined_pick(yd.flags, 0, 6)
        assert yk.REFINED_SUFFIXES[got] == suffix
    co2 = np.float32(m.exp.co2_ctrl if m.exp.active else 340.0)
    n1 = yk.fluxcorr_year.launches
    s_k, c_k = yk.fluxcorr_year(s0, co2, yd)
    s_p, c_p = yk.fluxcorr_year_plain(s0, co2, yd)
    assert yk.fluxcorr_year.launches == n1 + 1
    _equal(s_k.stack(), s_p.stack(), "K1 state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c_k, name), getattr(c_p, name), f"K1 {name}")
    zero = Corrections.zeros(GRID768.nstep_yr, GRID768.ydim, GRID768.xdim,
                             device="cuda")
    s_k, o_k, a_k = yk.scenario_year(s0, zero, 680.0, yd)
    s_p, o_p, a_p = yk.scenario_year_plain(s0, zero, 680.0, yd)
    assert torch.isfinite(s_k.stack()).all() and torch.isfinite(o_k).all()
    _equal(s_k.stack(), s_p.stack(), "K2 state")
    _equal(o_k, o_p, "K2 outs")
    _equal(a_k, a_p, "K2 annual sums")


@pytest.mark.parametrize("kind", yk.KINDS)
def test_wide_layout_matches_the_kernel(grid768_model, kind):
    plan = grid768_model.fold[0]
    lay = yk.block_layout(plan, yk.DEFAULT_CLUSTER, kind)
    assert lay.groups == 6 and lay.nbytes == 196656
    parts, threads = yk.kernel_cluster_layout(plan, yk.DEFAULT_CLUSTER, kind)
    assert parts == dict(lay.parts) and threads == lay.threads
    assert yk.cluster_capacity(plan, yk.DEFAULT_CLUSTER, kind) >= 6


@pytest.mark.parametrize("shared", (False, True))
def test_wide_member_kernels_match_plain(grid768_model, shared):
    """K4 at M=2 (ct_sens 22.05, 22.95) from the initial state at 340 ppm
    and K3 at M=2 over two years from the initial state at 680 ppm with
    zero tables (a table per member or one shared), one launch a member on
    a card that runs fewer than 12 clusters at once; both bit for bit, and
    at M=1 with the base params equal to K1 and K2."""
    m = grid768_model
    yd, s0 = m.year_data, m.initial_state()
    members = ens.perturbed_params(m.params, {"ct_sens": [22.05, 22.95]})
    pp = my.pack_member_params(members, "cuda")
    s5 = ens.ensemble_initial_state(members, m.forcing)
    per = yk.check_resident(6, yk.cluster_capacity(yd.plan, 16, "fluxcorr"),
                            2)
    n4, n3 = my.fluxcorr_years.launches, my.scenario_years.launches
    s_k, c_k = my.fluxcorr_years(s5, pp, 340.0, yd)
    s_p, c_p = my.fluxcorr_years_plain(s5, pp, 340.0, yd)
    assert my.fluxcorr_years.launches == n4 + -(-2 // per)
    assert not torch.equal(c_k[0], c_k[1])
    _equal(s_k, s_p, "K4 state")
    _equal(c_k, c_p, "K4 tables")
    shape = (GRID768.nstep_yr, 3, GRID768.ydim, GRID768.xdim)
    tab = torch.zeros((1 if shared else 2,) + shape, device="cuda")
    co2 = np.full(2, 680.0, np.float32)
    got = my.scenario_years(s5, pp, tab, co2, yd)
    want = my.scenario_years_plain(s5, pp, tab, co2, yd)
    assert torch.isfinite(got[1]).all() and not torch.equal(got[1][0],
                                                             got[1][1])
    for name, k, p in zip(("state", "monthly means", "annual sums"), got,
                          want):
        _equal(k, p, f"K3 {name}")
    base = my.pack_member_params([m.params], "cuda")
    s4, c4 = my.fluxcorr_years(s0.stack()[:, None], base, 340.0, yd)
    s1, c1 = yk.fluxcorr_year(s0, 340.0, yd)
    _equal(s4[:, 0], s1.stack(), "K4 = K1 state")
    _equal(c4[0], torch.stack([c1.tf, c1.tof, c1.qf], dim=1), "K4 = K1")
    s3, _, a3 = my.scenario_years(s0.stack()[:, None], base, tab[:1], co2[:1],
                                  yd)
    zero = Corrections.zeros(GRID768.nstep_yr, GRID768.ydim, GRID768.xdim,
                             device="cuda")
    s2, _, a2 = yk.scenario_year(s0, zero, 680.0, yd)
    _equal(s3[:, 0], s2.stack(), "K3 = K2 state")
    _equal(a3[0, 0], a2, "K3 = K2 annual sums")


# ---------------------------------------------------------------------------
# the grids between 192x96 and 384x192: csrc/band_kernel.cu's additive
# packed and strict additive forms, at 256x128
# ---------------------------------------------------------------------------
BAND = Numerics(xdim=256, ydim=128, dt_crcl=1800, ndays_yr=1, jday_mon=(1,),
                time_flux=1, time_scnr=1)


def _band(log_exp=None, fast=True):
    arrs = regrid_forcing_arrays(make_synthetic_forcing(
        96, 48, BAND.nstep_yr, BAND.ndays_yr), BAND)
    return GREB(GrebConfig(numerics=BAND, fast_circulation=fast,
                           experiment=Experiment(log_exp)),
                forcing=forcing_from_arrays(arrs, "cuda"), verbose=False,
                device="cuda")


@pytest.mark.parametrize("case", ("fold", "log_exp 11", "strict"))
def test_band_kernels_match_plain(case):
    """K1 from the initial state and K2 from it with zero corrections (the
    2-step calendar), K4 at M=2 and K3 at M=2 over two years from the
    members' initial states with zero tables, bit for bit in each of the
    three new entry sets; K4 = K1 and K3 = K2 at M=1; the launchers pick
    the entries ``refined_entry`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the year kernels have no CPU mode")
    m = _band(11 if case == "log_exp 11" else None, case != "strict")
    yd, s0 = m.year_data, m.initial_state()
    suffix = dict(fold="_additive_packed", strict="_strict_additive").get(
        case, "_additive_packed_legacy")
    for kernel in ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                   "scenario_years"):
        assert yk.refined_entry(kernel, yd.plan, yd.flags) == kernel + suffix
        assert yk.kernel_entry(kernel, yd.plan, yd.flags) == kernel + suffix
    s1, c1 = yk.fluxcorr_year(s0, 340.0, yd)
    s_p, c_p = yk.fluxcorr_year_plain(s0, 340.0, yd)
    _equal(s1.stack(), s_p.stack(), "K1 state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(c1, name), getattr(c_p, name), f"K1 {name}")
    zero = Corrections.zeros(BAND.nstep_yr, BAND.ydim, BAND.xdim,
                             device="cuda")
    s2, o2, a2 = yk.scenario_year(s0, zero, 680.0, yd)
    s_p, o_p, a_p = yk.scenario_year_plain(s0, zero, 680.0, yd)
    assert torch.isfinite(s2.stack()).all()
    _equal(s2.stack(), s_p.stack(), "K2 state")
    _equal(o2, o_p, "K2 outs")
    _equal(a2, a_p, "K2 annual sums")
    members = ens.perturbed_params(m.params, {"ct_sens": [22.05, 22.95]})
    pp = my.pack_member_params(members, "cuda")
    s5 = ens.ensemble_initial_state(members, m.forcing)
    s4, c4 = my.fluxcorr_years(s5, pp, 340.0, yd)
    s4p, c4p = my.fluxcorr_years_plain(s5, pp, 340.0, yd)
    assert not torch.equal(c4[0], c4[1])
    _equal(s4, s4p, "K4 state")
    _equal(c4, c4p, "K4 tables")
    tab = torch.zeros((2, BAND.nstep_yr, 3, BAND.ydim, BAND.xdim),
                      device="cuda")
    co2 = np.full(2, 680.0, np.float32)
    got = my.scenario_years(s5, pp, tab, co2, yd)
    want = my.scenario_years_plain(s5, pp, tab, co2, yd)
    for name, k, p in zip(("state", "monthly means", "annual sums"), got,
                          want):
        _equal(k, p, f"K3 {name}")
    base = my.pack_member_params([m.params], "cuda")
    s41, c41 = my.fluxcorr_years(s0.stack()[:, None], base, 340.0, yd)
    _equal(s41[:, 0], s1.stack(), "K4 = K1 state")
    _equal(c41[0], torch.stack([c1.tf, c1.tof, c1.qf], dim=1), "K4 = K1")
    s31, _, a31 = my.scenario_years(s0.stack()[:, None], base, tab[:1],
                                    co2[:1], yd)
    _equal(s31[:, 0], s2.stack(), "K3 = K2 state")
    _equal(a31[0, 0], a2, "K3 = K2 annual sums")


@pytest.mark.parametrize("kind", yk.KINDS)
def test_band_layouts_match_the_kernel(kind):
    """The additive packed form's block (refined_layout) and the strict
    additive form's (strict_refined_layout) at each grid of the band, as
    the kernel reckons them, and a capacity of at least one cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layout is the built kernel's")
    for xdim, ydim in ((224, 112), (256, 128), (288, 144), (320, 160),
                       (352, 176)):
        plan = dataclasses.replace(fc.make_plan(make_grid(xdim, ydim, 1800)),
                                   comp_mode="packed")
        for p in (plan, yk.StrictPlan(ydim, xdim)):
            lay = yk.block_layout(p, yk.DEFAULT_CLUSTER, kind)
            parts, threads = yk.kernel_cluster_layout(p, yk.DEFAULT_CLUSTER,
                                                      kind)
            assert parts == dict(lay.parts) and threads == lay.threads
            assert yk.cluster_capacity(p, yk.DEFAULT_CLUSTER, kind) >= 1


def test_band_launchers_pick_the_named_kernel():
    """For every log_exp word (and the strict circulation's) in the two
    forms, the launchers' pick (csrc/band_kernel.cu band_pick) is the
    entry ``refined_entry`` names, or none where it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pick is the built library's")
    plans = (dataclasses.replace(fc.make_plan(make_grid(256, 128, 1800)),
                                 comp_mode="packed"),
             yk.StrictPlan(128, 256))
    words = {yk.experiment_flags(Experiment(e), e in (7, 8, 16))
             for e in range(17)} | {0, yk.experiment_flags(Experiment(),
                                                           True)}
    for plan in plans:
        for flags in words:
            try:
                want = yk.refined_entry("fluxcorr_year", plan, flags)
            except ValueError:
                want = None
            try:
                got = yk.kernel_entry("fluxcorr_year", plan, flags)
            except ValueError:
                got = None
            assert got == want, (plan, hex(flags))


# ---------------------------------------------------------------------------
# latitude x member sharding: the slab kernels (csrc/slab_kernel.cu)
# ---------------------------------------------------------------------------
def _sharded_years(model, n_y, plain=False, members=None, n_ens=1):
    """The sharded spin-up and scenario year of ``model`` on an
    (n_ens, n_y) mesh of shards sharing the card, in the slab kernels (or
    the plain sharded runners), gathered: (state after each, corrections,
    monthly means, launches of slab_start, slab_substep, slab_finish)."""
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import slab
    from greb_tpu_torch.parallel import sharded as sh
    mesh = sh.make_mesh(n_ens, n_y)
    splan = fcc = None
    if model.fold is not None:
        splan, sconst = fc2.build_sharded(None, None, model.grid, model.st,
                                          0, n_y, fold=model.fold)
        fcc = sh.shard_fastcirc(mesh, sconst)
    make = sh.make_plain_year_runners if plain else \
        sh.make_sharded_year_runners
    batched = members is not None
    flux, scnr = make(mesh, model.st, model.num, model.exp,
                      model.month_mat, batched=batched, fast_plan=splan)
    state, ppack = model.initial_state(), None
    if batched:
        state = ens.ensemble_initial_state(members, model.forcing)
        ppack = my.pack_member_params(members, "cuda")
    st_s, sfx_s, _, md_s = sh.shard_inputs(mesh, batched, state, model.sfx,
                                           None, model.md, ppack)
    n0 = (slab.start.launches, slab.substep.launches, slab.finish.launches)
    s1, c1 = flux(st_s, sfx_s, 680.0, md_s, fcc)
    s2, mon, _ = scnr(s1, sfx_s, c1, 680.0, md_s, fcc)
    n1 = (slab.start.launches, slab.substep.launches, slab.finish.launches)
    return (s1.gather(), c1.gather(), s2.gather(), mon.gather(),
            tuple(b - a for a, b in zip(n0, n1)))


def _slab_against_unsharded(model, n_y, launches):
    """K1 -> K2 of ``model`` on the card against the slab kernels on n_y
    shards of the card: state, corrections and the monthly means (taken a
    shard's rows at a time on both sides) bit for bit, finite, with
    ``launches`` (start, substep, finish) a shard a step."""
    yd = model.year_data
    s1, c1 = yk.fluxcorr_year(model.initial_state(), 680.0, yd)
    s2, outs, _ = yk.scenario_year(s1, c1, 680.0, yd)
    g1, gc, g2, gmon, n = _sharded_years(model, n_y)
    T = model.num.nstep_yr
    assert n == tuple(2 * T * n_y * k for k in launches)
    _equal(g1.stack().cpu(), s1.stack().cpu(), "spin-up state")
    _equal(g2.stack().cpu(), s2.stack().cpu(), "scenario state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(gc, name).cpu(), getattr(c1, name).cpu(), name)
    R = model.num.ydim // n_y
    mon = torch.cat([core.monthly_means(model.month_mat,
                                        outs[..., i * R:(i + 1) * R, :])
                     for i in range(n_y)], dim=-2)
    _equal(gmon.cpu(), mon.cpu(), "monthly")
    assert torch.isfinite(g2.stack()).all() and torch.isfinite(gmon).all()


@pytest.mark.parametrize("log_exp", (None, 8, 11, 2))
def test_slab_words_equal_the_unsharded_kernels(log_exp):
    """The strict transport (the library default, ``GrebConfig()``: the
    slab kernels' cluster-body strict form) and the legacy words 8 (strict,
    q by diffusion alone), 11 (the fold with switches) and 2 (no
    transport: a step is slab_finish alone) at 96x48 on 2 shards of the
    card against K1 -> K2 in the same word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the slab kernels have no CPU mode")
    m = GREB(GrebConfig(numerics=NUM, experiment=Experiment(log_exp),
                        **({} if log_exp is None else
                           dict(fast_circulation=True))),
             verbose=False, device="cuda")
    nsub = 0 if log_exp == 2 else NUM.nsub_crcl
    _slab_against_unsharded(m, 2, (int(nsub > 0), nsub, 1))


def test_slab_packed_fold_equals_the_unsharded_kernels():
    """256x128 (additive splitting with packed composites) on 4 shards of
    the card against K1 -> K2 (the additive packed form), on 20 steps of
    forcing regridded from the 96x48 synthetic forcing: the pole shards
    run the slab kernels' additive packed form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the slab kernels have no CPU mode")
    num = Numerics(xdim=256, ydim=128, dt_crcl=1800, ndays_yr=10,
                   jday_mon=(6, 4), time_flux=1, time_scnr=1)
    arrs = regrid_forcing_arrays(
        make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True),
             forcing=forcing_from_arrays(arrs, "cuda"), verbose=False,
             device="cuda")
    assert yk.refined_form(m.fold[0]) == "additive_packed"
    _slab_against_unsharded(m, 4, (1, num.nsub_crcl, 1))


@pytest.mark.parametrize("n_y", (2, 4))
def test_slab_years_equal_the_unsharded_kernels(model, n_y):
    """K1 -> K2 on the card against the slab kernels on n_y shards of the
    same card: state, corrections and monthly means bit for bit; each
    shard launches 2 + nsub kernels a step."""
    yd = model.year_data
    s1, c1 = yk.fluxcorr_year(model.initial_state(), 680.0, yd)
    s2, outs, _ = yk.scenario_year(s1, c1, 680.0, yd)
    g1, gc, g2, gmon, n = _sharded_years(model, n_y)
    T, nsub = NUM.nstep_yr, NUM.nsub_crcl
    assert n == (2 * T * n_y, 2 * T * n_y * nsub, 2 * T * n_y)
    _equal(g1.stack().cpu(), s1.stack().cpu(), "spin-up state")
    _equal(g2.stack().cpu(), s2.stack().cpu(), "scenario state")
    for name in ("tf", "tof", "qf"):
        _equal(getattr(gc, name).cpu(), getattr(c1, name).cpu(), name)
    # a sharded run takes the monthly means one product a shard's rows:
    # cuBLAS picks a product's reduction order by its shape
    R = NUM.ydim // n_y
    mon = torch.cat([core.monthly_means(model.month_mat,
                                        outs[..., i * R:(i + 1) * R, :])
                     for i in range(n_y)], dim=-2)
    _equal(gmon.cpu(), mon.cpu(), "monthly")
    assert torch.isfinite(g2.ts).all()


def test_slab_years_equal_the_plain_sharded_version(model):
    got = _sharded_years(model, 4)
    want = _sharded_years(model, 4, plain=True)
    assert want[4] == (0, 0, 0)
    for a, b, name in zip(got[:4], want[:4], ("spin-up", "corrections",
                                               "scenario", "monthly")):
        for f in dataclasses.fields(a) if dataclasses.is_dataclass(a) else ():
            _equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu(),
                   f"{name} {f.name}")
        if not dataclasses.is_dataclass(a):
            _equal(a.cpu(), b.cpu(), name)


def test_slab_members_equal_the_member_kernels(model):
    """2 members (ct_sens 22.05, 22.95) on the ens rows x 2 shards against
    K4 -> K3 at M=2: state and corrections bit for bit."""
    members = ens.perturbed_params(model.params,
                                   {"ct_sens": np.float32([22.05, 22.95])})
    yd = model.year_data
    s5 = ens.ensemble_initial_state(members, model.forcing)
    ppack = my.pack_member_params(members, "cuda")
    k4, corr = my.fluxcorr_years(s5, ppack, 680.0, yd)
    k3, _, _ = my.scenario_years(k4, ppack, corr, np.float32([680.0]), yd)
    g1, gc, g2, _, _ = _sharded_years(model, 2, members=members, n_ens=2)
    _equal(g1.stack().cpu(), k4.cpu(), "spin-up state")
    _equal(g2.stack().cpu(), k3.cpu(), "scenario state")
    for i, name in enumerate(("tf", "tof", "qf")):
        _equal(getattr(gc, name).cpu(), corr[:, :, i].cpu(), name)


def test_slab_layout_matches_the_kernel(model):
    """The kernel reckons each shard's slab block as ``slab_layout`` does:
    the fold's at 96x48 on 4 shards, and each strict form's."""
    from greb_tpu_torch.ops import fastcirc2 as fc2
    from greb_tpu_torch.ops.cuda import slab
    splan, _ = fc2.build_sharded(None, None, model.grid, model.st, 0, 4,
                                 fold=model.fold)
    for plan in splan.plans:
        n = slab.slab_blocks(plan)
        assert slab.kernel_slab_layout(plan, n) == slab.slab_layout(plan, n)
    for form, plan in (("strict_cluster", yk.StrictPlan(24, 96)),
                       ("strict_additive", yk.StrictPlan(32, 256)),
                       ("strict", yk.StrictPlan(48, 384, seq_zonal=True))):
        n = slab.slab_blocks(plan, form)
        assert slab.kernel_slab_layout(plan, n, form) == slab.slab_layout(
            plan, n, form)
