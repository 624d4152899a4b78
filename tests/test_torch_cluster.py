"""The cluster layout of the single-run year kernels (K1 ``fluxcorr_year``,
K2 ``scenario_year``), on the CPU.

On the card one year runs on a thread-block cluster: each block owns
``Y / C`` latitude rows and keeps their state, transported fields (with
+-2 halo rows), coefficient planes and pole composites in its own shared
memory.  ``cluster_layout`` is that reckoning in Python; the kernel carries
the same one (``greb_cluster_layout``), which ``chip_smoke.py`` holds
against it on the card.  Here: every offered cluster size fits the main
path's 96x48 grid, the parts add up, and the layout raises where the rows
do not split evenly, where a block would hold fewer rows than the halo
depth, where a row's length is not a multiple of 4, and where a block
would need more than 232,448 B.  The wrappers
refuse a cluster size they do not offer, also on the CPU.
"""
import dataclasses

import pytest
import torch

from greb_tpu_torch.config import GrebConfig, Numerics
from greb_tpu_torch.forcing import Corrections
from greb_tpu_torch.model.driver import GREB
from greb_tpu_torch.ops import fastcirc2 as fc2
from greb_tpu_torch.ops.cuda import year_kernel as yk

torch.set_num_threads(1)

# the 96x48 plan of the main path (GREB's default grid)
PLAN = fc2.FastPlan(ydim=48, xdim=96, bt=10, bb=10, diff_segs=(),
                    adv_segs=(), comp_mode="dense", comp_kt=1, comp_kb=1)


def test_main_path_plan_is_the_default_grid():
    m = GREB(GrebConfig(numerics=Numerics(ndays_yr=10, jday_mon=(6, 4),
                                          time_flux=1, time_scnr=1)),
             verbose=False, device="cpu")
    assert m.fold[0] == PLAN
    yk.check_supported(m.fold[0])


@pytest.mark.parametrize("blocks", yk.CLUSTER_SIZES)
def test_offered_clusters_fit_96x48(blocks):
    for scenario in (True, False):
        lay = yk.cluster_layout(PLAN, blocks, scenario)
        assert lay.blocks == blocks
        assert lay.rows == 48 // blocks >= yk.HALO
        assert lay.comp_rows == 1     # one pole row in the first/last block
        assert lay.nbytes <= yk.MAX_SMEM_BYTES
        # one (field, cell) per thread up to the block's 1024 threads
        assert lay.threads == min(1024, 2 * lay.rows * 96)
        assert lay.threads % 32 == 0


@pytest.mark.parametrize("blocks", yk.CLUSTER_SIZES)
def test_layout_parts_add_up(blocks):
    lay = yk.cluster_layout(PLAN, blocks)
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
    assert parts["asum"] == yk.N_SUM * plane
    assert parts["pcomp"] == 2 * 4 * X * X           # one pole row, 2 fields
    assert parts["comp_rows"] == 3 * 2 * 4 * X
    assert parts["comp_partials"] == 2 * 4 * (X // fc2.COMP_BLOCK) * X
    # the spin-up kernel keeps no annual sums
    flux = yk.cluster_layout(PLAN, blocks, scenario=False)
    assert dict(flux.parts)["asum"] == 0
    assert lay.nbytes - flux.nbytes == yk.N_SUM * plane


def test_layout_at_8_blocks_is_the_tightest():
    """At 8 blocks (6 rows each) the scenario kernel's block with a pole
    row holds ~216 KB of planes and composites, ~225 KB with the partial
    row sums; more blocks need less a block."""
    sizes = [yk.cluster_layout(PLAN, c).nbytes for c in yk.CLUSTER_SIZES]
    assert sizes == sorted(sizes, reverse=True)
    assert sizes[0] == 225024
    assert sizes[0] - 4 * 2 * 12 * 96 == 215808


@pytest.mark.parametrize("blocks", (5, 7, 9, 10, 11))
def test_layout_rejects_uneven_split(blocks):
    with pytest.raises(ValueError, match="do not split evenly"):
        yk.cluster_layout(PLAN, blocks)


@pytest.mark.parametrize("blocks", (0, 17, 24, 48))
def test_layout_rejects_sizes_past_the_card(blocks):
    # clusters hold 1..16 blocks on Hopper
    with pytest.raises(ValueError, match="split evenly over 1..16"):
        yk.cluster_layout(PLAN, blocks)


def test_layout_rejects_blocks_under_the_halo_depth():
    # 16 rows over 16 blocks: one row a block, the halo reaches 2
    plan = dataclasses.replace(PLAN, ydim=16, bt=4, bb=4)
    with pytest.raises(ValueError, match="halo depth"):
        yk.cluster_layout(plan, 16)
    assert yk.cluster_layout(plan, 8).rows == 2


@pytest.mark.parametrize("blocks", (1, 2, 3, 4, 6))
def test_layout_rejects_blocks_over_shared_memory(blocks):
    # 8 or more rows a block at 96x48 need more than 227 KB
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.cluster_layout(PLAN, blocks)


def test_layout_rejects_a_wide_grid():
    # 384x192 on 16 blocks: 12 rows of 384 columns a block
    plan = dataclasses.replace(PLAN, ydim=192, xdim=384)
    with pytest.raises(ValueError, match="over 232448 B"):
        yk.cluster_layout(plan, 16)


def test_layout_rejects_a_row_not_a_multiple_of_4():
    # the composite partial sums load 4 columns (16 bytes) at a time
    plan = dataclasses.replace(PLAN, xdim=98)
    with pytest.raises(ValueError, match="not a multiple of 4"):
        yk.cluster_layout(plan, 16)


def test_default_cluster_is_offered():
    assert yk.DEFAULT_CLUSTER in yk.CLUSTER_SIZES
    assert max(yk.CLUSTER_SIZES) <= yk.MAX_CLUSTER


def test_wrappers_refuse_a_cluster_size_they_do_not_offer():
    m = GREB(GrebConfig(numerics=Numerics(xdim=48, ydim=24, ndays_yr=10,
                                          jday_mon=(6, 4), time_flux=1,
                                          time_scnr=1)),
             verbose=False, device="cpu")
    s0 = m.initial_state()
    with pytest.raises(ValueError, match="clusters of"):
        yk.fluxcorr_year(s0, 298.0, m.year_data, cluster=4)
    corr = Corrections.zeros(m.num.nstep_yr, 24, 48)
    with pytest.raises(ValueError, match="clusters of"):
        yk.scenario_year(s0, corr, 680.0, m.year_data, cluster=32)
