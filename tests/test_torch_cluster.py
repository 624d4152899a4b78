"""The cluster layout of the year kernels, on the CPU, for each of the
three kinds: a spin-up year (K1 ``fluxcorr_year``, K4 ``fluxcorr_years``),
a scenario year (K2 ``scenario_year``) and blocks of scenario years with
monthly means (K3 ``scenario_years``).

On the card each run (member) runs on a thread-block cluster: each block
owns ``Y / C`` latitude rows and keeps their state, transported fields
(with +-2 halo rows), coefficient planes, pole composites, annual sums and
(K3) the month's means in its own shared memory.  ``cluster_layout`` is
that reckoning in Python; the kernel carries the same one
(``greb_cluster_layout``), which ``chip_smoke.py`` holds against it on the
card.  Here: every offered cluster size fits the main path's 96x48 grid
for its kind, K3 does not fit 8 blocks, the parts add up, and the layout
raises where the rows do not split evenly, where a block would hold fewer
rows than the halo depth, where a row's length is not a multiple of 4, and
where a block would need more than 232,448 B.  The wrappers refuse a
cluster size they do not offer, also on the CPU.
"""
import dataclasses

import pytest
import torch

from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops.cuda import multiyear as my
from greb_tpu_torch.ops.cuda import year_kernel as yk

torch.set_num_threads(1)

# the 96x48 plan of the main path (GREB's default grid)
PLAN = fc2.FastPlan(ydim=48, xdim=96, bt=10, bb=10, diff_segs=(),
                    adv_segs=(), comp_mode="dense", comp_kt=1, comp_kb=1)
# every kind with each cluster size it offers
OFFERED = [(kind, c) for kind in yk.KINDS for c in yk.CLUSTER_SIZES[kind]]


def test_main_path_plan_is_the_default_grid():
    m = GREB(GrebConfig(numerics=Numerics(ndays_yr=10, jday_mon=(6, 4),
                                          time_flux=1, time_scnr=1),
                        fast_circulation=True),
             verbose=False, device="cpu")
    assert m.fold[0] == PLAN
    yk.check_supported(m.fold[0])


@pytest.mark.parametrize("kind,blocks", OFFERED)
def test_offered_clusters_fit_96x48(kind, blocks):
    lay = yk.cluster_layout(PLAN, blocks, kind)
    assert lay.blocks == blocks
    assert lay.rows == 48 // blocks >= yk.HALO
    assert lay.comp_rows == 1     # one pole row in the first/last block
    assert lay.nbytes <= yk.MAX_SMEM_BYTES
    # one (field, cell) per thread up to the block's 1024 threads
    assert lay.threads == min(1024, 2 * lay.rows * 96)
    assert lay.threads % 32 == 0


@pytest.mark.parametrize("kind,blocks", OFFERED)
def test_layout_parts_add_up(kind, blocks):
    lay = yk.cluster_layout(PLAN, blocks, kind)
    parts = dict(lay.parts)
    assert tuple(parts) == yk.CLUSTER_PARTS
    assert sum(parts.values()) == lay.nbytes
    R, X = lay.rows, 96
    plane = 4 * R * X
    assert parts["state"] == 5 * plane
    assert parts["transported"] == 2 * 2 * 4 * (R + 2 * yk.HALO) * X
    assert parts["coeffs"] == 12 * 2 * plane
    assert parts["zd"] == 7 * 2 * plane
    assert parts["wz"] == 2 * plane
    # the scenario kinds add up the 9 annual sums, K3 the month's 5 means
    assert parts["asum"] == (0 if kind == "fluxcorr" else yk.N_SUM * plane)
    assert parts["monthly"] == (5 * plane if kind == "scenario_years" else 0)
    assert parts["pcomp"] == 2 * 4 * X * X           # one pole row, 2 fields
    assert parts["comp_rows"] == 3 * 2 * 4 * X
    assert parts["comp_partials"] == 2 * 4 * (X // fc2.COMP_BLOCK) * X
    # K1/K4 and K2 differ by the sums, K2 and K3 by the month's means
    flux = yk.cluster_layout(PLAN, blocks, "fluxcorr")
    assert lay.nbytes - flux.nbytes == (
        {"fluxcorr": 0, "scenario": yk.N_SUM, "scenario_years": yk.N_SUM + 5}
        [kind] * plane)


@pytest.mark.parametrize("kind,blocks", OFFERED)
def test_strict_layout_has_no_fold(kind, blocks):
    """The strict instantiation's block (``StrictPlan``): the state, the
    transported fields and wz with HALO rows each side, the sums, the
    step's winds, 8 words a row and the 4 sub-cycle planes of 2 fields;
    none of the fold's planes or composites, so it fits every offered
    size in less than the fold's block."""
    lay = yk.cluster_layout(yk.StrictPlan(48, 96), blocks, kind)
    parts = dict(lay.parts)
    assert tuple(parts) == yk.CLUSTER_PARTS
    assert sum(parts.values()) == lay.nbytes
    R, X = lay.rows, 96
    plane, halo = 4 * R * X, 4 * (R + 2 * yk.HALO) * X
    assert parts["state"] == 5 * plane
    assert parts["transported"] == 2 * 2 * halo
    assert parts["wz"] == 2 * halo
    assert parts["winds"] == 2 * plane
    assert parts["rowc"] == 4 * 8 * R
    assert parts["subcycle"] == 4 * 2 * plane
    for name in ("coeffs", "zd", "pcomp", "comp_rows", "comp_partials"):
        assert parts[name] == 0, name
    assert lay.comp_rows == 0 and lay.threads == min(1024, 2 * R * X)
    assert lay.nbytes < yk.cluster_layout(PLAN, blocks, kind).nbytes


@pytest.mark.parametrize("kind,at_8,planes", (("fluxcorr", 204288, 195072),
                                              ("scenario", 225024, 215808)))
def test_layout_at_8_blocks_is_the_tightest(kind, at_8, planes):
    """At 8 blocks (6 rows each) the scenario kernel's block with a pole
    row holds ~216 KB of planes and composites, ~225 KB with the partial
    row sums (the spin-up kernel ~204 KB); more blocks need less a
    block."""
    sizes = [yk.cluster_layout(PLAN, c, kind).nbytes
             for c in yk.CLUSTER_SIZES[kind]]
    assert sizes == sorted(sizes, reverse=True)
    assert sizes[0] == at_8
    assert sizes[0] - 4 * 2 * 12 * 96 == planes


@pytest.mark.parametrize("blocks,nbytes", ((12, 180480 + 7680),
                                           (16, 158208 + 5760)))
def test_scenario_years_fits_12_and_16_blocks(blocks, nbytes):
    """K3 is K2's layout plus the month's 5 means of the block's rows: at
    12 blocks 4 rows (7,680 B), at 16 blocks 3 rows (5,760 B)."""
    assert yk.cluster_layout(PLAN, blocks, "scenario").nbytes + \
        5 * 4 * (48 // blocks) * 96 == nbytes
    assert yk.cluster_layout(PLAN, blocks, "scenario_years").nbytes == nbytes


def test_scenario_years_does_not_fit_8_blocks():
    # K2's 225,024 B at 8 blocks plus 6 rows of the month's means, 11,520 B
    with pytest.raises(ValueError, match="needs 236544 B .* over 232448 B"):
        yk.cluster_layout(PLAN, 8, "scenario_years")
    assert 8 not in yk.CLUSTER_SIZES["scenario_years"]


def test_layout_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind 'members'"):
        yk.cluster_layout(PLAN, 16, "members")


@pytest.mark.parametrize("kind", yk.KINDS)
@pytest.mark.parametrize("blocks", (5, 7, 9, 10, 11))
def test_layout_rejects_uneven_split(blocks, kind):
    with pytest.raises(ValueError, match="do not split evenly"):
        yk.cluster_layout(PLAN, blocks, kind)


@pytest.mark.parametrize("kind", yk.KINDS)
@pytest.mark.parametrize("blocks", (0, 17, 24, 48))
def test_layout_rejects_sizes_past_the_card(blocks, kind):
    # clusters hold 1..16 blocks on Hopper
    with pytest.raises(ValueError, match="split evenly over 1..16"):
        yk.cluster_layout(PLAN, blocks, kind)


@pytest.mark.parametrize("kind", yk.KINDS)
def test_layout_rejects_blocks_under_the_halo_depth(kind):
    # 16 rows over 16 blocks: one row a block, the halo reaches 2
    plan = dataclasses.replace(PLAN, ydim=16, bt=4, bb=4)
    with pytest.raises(ValueError, match="halo depth"):
        yk.cluster_layout(plan, 16, kind)
    assert yk.cluster_layout(plan, 8, kind).rows == 2


@pytest.mark.parametrize("kind", yk.KINDS)
@pytest.mark.parametrize("blocks", (1, 2, 3, 4, 6))
def test_layout_rejects_blocks_over_shared_memory(blocks, kind):
    # 8 or more rows a block at 96x48 need more than 227 KB
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.cluster_layout(PLAN, blocks, kind)


@pytest.mark.parametrize("kind", yk.KINDS)
def test_layout_rejects_a_wide_grid(kind):
    # 384x192 on 16 blocks: 12 rows of 384 columns a block
    plan = dataclasses.replace(PLAN, ydim=192, xdim=384)
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.cluster_layout(plan, 16, kind)


@pytest.mark.parametrize("kind", yk.KINDS)
def test_layout_rejects_a_row_not_a_multiple_of_4(kind):
    # the composite partial sums load 4 columns (16 bytes) at a time
    plan = dataclasses.replace(PLAN, xdim=98)
    with pytest.raises(ValueError, match="not a multiple of 4"):
        yk.cluster_layout(plan, 16, kind)


@pytest.mark.parametrize("kind", yk.KINDS)
def test_default_cluster_is_offered(kind):
    assert yk.DEFAULT_CLUSTER in yk.CLUSTER_SIZES[kind]
    assert max(yk.CLUSTER_SIZES[kind]) <= yk.MAX_CLUSTER


def test_wrappers_refuse_a_cluster_size_they_do_not_offer():
    m = GREB(GrebConfig(numerics=Numerics(xdim=48, ydim=24, ndays_yr=10,
                                          jday_mon=(6, 4), time_flux=1,
                                          time_scnr=1),
                        fast_circulation=True),
             verbose=False, device="cpu")
    s0 = m.initial_state()
    with pytest.raises(ValueError, match="clusters of"):
        yk.fluxcorr_year(s0, 298.0, m.year_data, cluster=4)
    corr = Corrections.zeros(m.num.nstep_yr, 24, 48)
    with pytest.raises(ValueError, match="clusters of"):
        yk.scenario_year(s0, corr, 680.0, m.year_data, cluster=32)


@pytest.mark.parametrize("kind,cluster", (("fluxcorr", 1), ("fluxcorr", 4),
                                          ("fluxcorr", 24),
                                          ("scenario_years", 8),
                                          ("scenario_years", 2)))
def test_member_wrappers_refuse_a_cluster_size_they_do_not_offer(kind,
                                                                 cluster):
    m = GREB(GrebConfig(numerics=Numerics(xdim=48, ydim=24, ndays_yr=10,
                                          jday_mon=(6, 4), time_flux=1,
                                          time_scnr=1),
                        fast_circulation=True),
             verbose=False, device="cpu")
    s5 = m.initial_state().stack()[:, None]
    ppack = my.pack_member_params([m.params])
    with pytest.raises(ValueError, match="clusters of"):
        if kind == "fluxcorr":
            my.fluxcorr_years(s5, ppack, 298.0, m.year_data, cluster=cluster)
        else:
            corr = torch.zeros((1, m.num.nstep_yr, 3, 24, 48))
            my.scenario_years(s5, ppack, corr, [680.0], m.year_data,
                              cluster=cluster)


@pytest.mark.parametrize("kind,members,cluster", (
    ("scenario_years", 1, 16), ("scenario_years", 49, 16),
    ("scenario_years", 50, 1), ("scenario_years", 132, 1),
    ("fluxcorr", 3, 16), ("fluxcorr", 7, 16), ("fluxcorr", 8, 8),
    ("fluxcorr", 132, 8)))
def test_member_default_cluster_follows_the_member_count(kind, members,
                                                         cluster):
    """16-block clusters while their waves are faster, then one block a
    member (K3) or 8-block clusters (K4): the crossovers measured in
    chip_smoke.py's member scaling on an H100, which runs 7 clusters of 16
    blocks at once."""
    assert my.default_cluster(kind, members, 7) == cluster
    assert all(my.default_cluster(kind, m, 7) in yk.offered_sizes(kind)
               for m in range(1, 257))


@pytest.mark.parametrize("kind,waves,beyond", (("fluxcorr", 1, 8),
                                               ("scenario_years", 7, 1)))
@pytest.mark.parametrize("capacity", (1, 4, 7, 9))
def test_member_default_cluster_follows_the_cards_capacity(kind, waves,
                                                           beyond, capacity):
    """The switch sits at a number of waves of 16-block clusters, so a card
    that runs more or fewer of them at once moves it."""
    last = waves * capacity
    assert my.default_cluster(kind, last, capacity) == yk.DEFAULT_CLUSTER
    assert my.default_cluster(kind, last + 1, capacity) == beyond


@pytest.mark.parametrize("kind", yk.KINDS)
def test_one_block_body_is_offered_by_k3_alone(kind):
    sizes = yk.offered_sizes(kind)
    assert (1 in sizes) == (kind == "scenario_years")
    assert sizes[-len(yk.CLUSTER_SIZES[kind]):] == yk.CLUSTER_SIZES[kind]
