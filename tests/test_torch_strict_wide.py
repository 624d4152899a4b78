"""The sequential strict form's spread pole sub-cycle and its wide variant
(greb_tpu_torch/csrc/year_kernel.cu ``spread_cycle``, ``*_strict_wide``),
on the CPU:

* a plain-PyTorch model of the spread schedule, which the kernel runs on
  the card: a pole block's rows cut into H column chunks of W columns,
  each chunk with 3k more columns each side, k rounds on a chunk between
  two exchanges of its owned columns, rows leaving at their counts; held
  bitwise against the port's ``stencils._subcycle`` of the pole rows (the
  plain version the kernel is held to) at 384x192's counts (1,652, 184,
  67, ...; one cluster, 8 blocks a pole) and for 300 rounds at 768x384's
  (6,612, 734, 265, 135; 16 blocks a pole), for several k, so that the
  chunks that wrap at column 0 and the rounds past a row's count are
  covered;
* ``spread_layout`` and ``strict_wide_layout`` reckoned by hand: the wide
  form's bytes a block and its 6 clusters at 768x384, the forced 2-cluster
  run at 384x192, and what does not fit;
* the port's sub-cycle schedules at 768x384 and 384x192 (each row's
  diffusion and advection counts, sub-step lengths and coefficients)
  equal to ``greb_tpu``'s.

No whole plain strict substep at 768x384 is held against ``greb_tpu``'s
``stencils.circulation`` here: its 6,612 rounds run over the whole grid
(every row takes the sub-cycled form at an extension-mode grid), and one
substep of the port's alone took 236 s on one CPU thread, past the 60 s
such a test may take.  The card holds the kernels to that plain version
(chip_smoke.py step 23).
"""
import dataclasses

import numpy as np
import pytest
import torch

from greb_tpu.grid import make_grid as jmake_grid

from greb_tpu_torch.config import GrebConfig
from greb_tpu_torch.grid import make_grid
from greb_tpu_torch.ops import stencils as stc
from greb_tpu_torch.ops.cuda import year_kernel as yk

torch.set_num_threads(1)
F32 = np.float32


def _pole_rows(X, Y, dt_crcl, R, seed, rounds=None):
    """The top pole block's R rows at a grid's real counts (at most
    ``rounds``), their coefficients as the plain version forms them, and
    (Ta, q)-like values and wz from a seed: (x (2, R, X), wz (2, R, X),
    cc (R, 1), counts (R,))."""
    grid = make_grid(X, Y, dt_crcl)
    st, sf = stc.make_stencil_arrays(grid)
    kappa = F32(GrebConfig().physics_defaults().kappa)
    cc = (kappa * sf.diff_dtdff2[:R]) / sf.dxlat2[:R]
    counts = grid.diff_sched.time2[:R].astype(np.int64)
    if rounds is not None:
        counts = np.minimum(counts, rounds)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.stack([
        rng.uniform(230.0, 300.0, (R, X)),
        rng.uniform(1e-4, 2e-2, (R, X))]).astype(F32))
    wz = torch.from_numpy(rng.uniform(0.2, 1.0, (2, R, X)).astype(F32))
    return x, wz, cc, counts


def _plain(x, wz, cc, counts):
    """``stencils._subcycle`` of the rows, each to its count (the masked
    full-field form's iteration masks)."""
    n = int(counts.max())
    itm = torch.from_numpy(
        (np.arange(n)[:, None] < counts[None, :]).astype(F32))[..., None]
    w10 = stc._diff7_weights(wz)
    return stc._subcycle(x, itm, n, lambda t: stc._diff7(t, w10, cc))


def _spread(x, wz, cc, counts, H, k, halo=None):
    """The kernel's spread schedule: H blocks of W = X / H columns, each
    with its columns and ``halo`` (3k) more each side (periodic); epoch e
    runs the rounds [e k, (e + 1) k) of the rows still within their counts
    on each chunk, the valid columns shrinking by 3 a round (the 7-point
    stencil's reach), then each block keeps its own W columns, which its
    neighbours read as their halos in the next epoch.  Every cell's round
    is the kernel's: x0 + clamp(_diff7), a row past its count unchanged."""
    X = x.shape[-1]
    W, K3 = X // H, 3 * k if halo is None else halo
    L = W + 2 * K3
    cols = (torch.arange(H)[:, None] * W - K3 + torch.arange(L)[None, :]) % X
    w10 = stc._diff7_weights(wz[..., cols])        # (2, R, H, 10, L)
    cc = cc[..., None]                             # (R, 1, 1)
    pub = x.clone()
    n = torch.from_numpy(counts)[:, None, None]    # (R, 1, 1)
    for e in range(-(-int(counts.max()) // k)):
        t = pub[..., cols]                         # (2, R, H, L)
        for q in range(k):
            d = stc._diff7(t, w10, cc)
            d = torch.where(d <= -t, -0.9 * t, d)
            live = torch.zeros(L, dtype=torch.bool)
            live[3 * (q + 1):L - 3 * (q + 1)] = True
            t = torch.where(live & (e * k + q < n), t + d, t)
        pub = t[..., K3:K3 + W].reshape(pub.shape)
    return pub


@pytest.mark.parametrize("k", (8, 3))
def test_spread_schedule_equals_subcycle_384x192(k):
    """The top pole block's 12 rows at 384x192 (counts 1,652 down to 4),
    spread over 8 blocks of 48 columns (half the cluster), bitwise equal
    to the plain sub-cycle; the 768 columns of the two fields' rows past
    their counts keep their values."""
    x, wz, cc, counts = _pole_rows(384, 192, 1800, 12, seed=19)
    assert tuple(counts[:4]) == (1652, 184, 67, 34) and counts[-1] == 4
    assert yk.spread_layout(yk.StrictPlan(192, 384, seq_zonal=True), 16,
                            rounds=k) == (8, 48)
    want = _plain(x, wz, cc, counts)
    got = _spread(x, wz, cc, counts, 8, k)
    assert torch.isfinite(want).all() and not torch.equal(want, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", (16, 5))
def test_spread_schedule_equals_subcycle_768x384(k):
    """The top pole block's 4 rows at 768x384 (counts 6,612, 734, 265,
    135), 300 rounds of them (rows 3 and 4 leave at 265 and 135), spread
    over the pole cluster's 16 blocks of 48 columns: bitwise equal."""
    x, wz, cc, counts = _pole_rows(768, 384, 450, 4, seed=23)
    assert tuple(make_grid(768, 384, 450).diff_sched.time2[:4]) == \
        (6612, 734, 265, 135)
    x, wz, cc, counts = _pole_rows(768, 384, 450, 4, seed=23, rounds=300)
    assert tuple(counts) == (300, 300, 265, 135)
    want = _plain(x, wz, cc, counts)
    got = _spread(x, wz, cc, counts, 16, k)
    assert torch.equal(got, want)


def test_spread_schedule_with_a_short_halo_differs():
    """The model is not vacuous: a halo one column short of 3k (the
    stencil reads 3 columns a round) changes the result."""
    x, wz, cc, counts = _pole_rows(384, 192, 1800, 2, seed=5, rounds=40)
    want = _plain(x, wz, cc, counts)
    assert torch.equal(_spread(x, wz, cc, counts, 8, 4), want)
    assert not torch.equal(_spread(x, wz, cc, counts, 8, 4, halo=11), want)


def test_strict_wide_layout_by_hand():
    """768x384 on 6 clusters of 16 blocks, 4 rows of 768 columns a block:
    the (Ta, q) double buffer with 2 halo rows each side (4 x 2 x 2 x 8 x
    768 B), wz of both fields with the same halo rows (4 x 2 x 8 x 768),
    no xz, the sub-cycles' two (2, 4, 768) buffers, 6 words of constants
    a row (24); 1 to 5 clusters do not fit (5 does not split 384 rows into
    blocks of 16); the spread: 16 blocks of 48 columns a pole, its 8 lines'
    scratch (2 x 4 x (3 x 48 + 30 x 16) words at 16 rounds between
    exchanges, the most the kernel takes; a run takes SPREAD_ROUNDS, 12)
    inside the second sub-cycle buffer (2 x 4 x 768)."""
    plan = yk.StrictPlan(384, 768, seq_zonal=True)
    assert yk.refined_groups(plan) == 6
    for g in range(1, 6):
        with pytest.raises(ValueError):
            yk.refined_layout(plan, 16, "scenario", g)
    for kind in yk.KINDS:
        lay = yk.strict_wide_layout(plan, 16, kind, 6)
        assert (lay.blocks, lay.groups, lay.rows, lay.threads) == \
            (16, 6, 4, 1024)
        assert dict(lay.parts) == dict(
            transported=4 * 2 * 2 * 8 * 768, wz=4 * 2 * 8 * 768, xz=0,
            subcycle=4 * 2 * 2 * 4 * 768, rowc=4 * 24)
        assert lay.nbytes == 196704 <= yk.MAX_SMEM_BYTES
        assert yk.block_layout(plan, 16, kind) == lay
        yk.check_plan(plan, kind, 0x80)
    assert yk.spread_rounds(plan, 16, 6) == yk.SPREAD_ROUNDS == 12
    assert yk.spread_layout(plan, 16, 6, 16) == (16, 48)
    assert 2 * 4 * (3 * 48 + 30 * 16) <= 2 * 4 * 768
    with pytest.raises(ValueError, match="2..8"):
        yk.strict_wide_layout(plan, 16, "scenario", 9)


def test_forced_two_cluster_strict_form_at_384x192():
    """384x192 fits one cluster (the strict refined form, both poles'
    spread groups its two halves, 8 blocks of 48 columns); a caller may
    force the wide variant on 2 clusters (the plan's private ``_groups``,
    ``year_kernel._forced``): 6 rows of 384 a block, each pole's rows
    spread over its own cluster's 16 blocks of 24 columns, k at most 8 (W
    at least 3k); and fewer rounds between exchanges (``_rounds``)."""
    plan = yk.StrictPlan(192, 384, seq_zonal=True)
    assert yk.refined_groups(plan) == 1
    assert yk.refined_entry("scenario_year", plan, 0x80) == \
        "scenario_year_strict_refined"
    assert yk.spread_rounds(plan) == 8
    assert yk.spread_layout(plan, 16, rounds=8) == (8, 48)
    with pytest.raises(ValueError, match="do not fit"):
        # 16 rounds: the scratch, 2 x 12 x (3 x 48 + 30 x 16) words, past
        # the second sub-cycle buffer's 2 x 12 x 384
        yk.spread_layout(plan, 16, rounds=16)
    two = dataclasses.replace(plan, _groups=2)
    assert yk.refined_groups(two) == 2 and two != plan
    lay = yk.block_layout(two, 16, "scenario_years")
    assert (lay.groups, lay.rows) == (2, 6)
    assert dict(lay.parts) == dict(
        transported=4 * 2 * 2 * 10 * 384, wz=4 * 2 * 10 * 384, xz=0,
        subcycle=4 * 2 * 2 * 6 * 384, rowc=4 * 36)
    assert lay.nbytes == 129168
    assert yk.spread_rounds(two, 16, 2) == 8
    assert yk.spread_layout(two, 16, 2, 8) == (16, 24)
    for kernel in ("fluxcorr_year", "scenario_year", "fluxcorr_years",
                   "scenario_years"):
        assert yk.refined_entry(kernel, two, 0x80) == kernel + "_strict_wide"
    assert yk._refined_struct(two).groups == 2
    assert yk._refined_struct(two).spread_k == 8
    assert yk.is_strict_wide(two) and not yk.is_strict_wide(plan)
    assert yk.refined_launcher("greb_scenario_year", two) == \
        "greb_scenario_year_strict_wide"
    assert yk.refined_launcher("greb_scenario_year", plan) == \
        "greb_scenario_year_refined"
    four = dataclasses.replace(two, _rounds=4)
    assert yk.spread_rounds(four, 16, 2) == 4
    assert yk._refined_struct(four).spread_k == 4
    with pytest.raises(ValueError, match="do not fit"):
        yk.spread_rounds(dataclasses.replace(two, _rounds=9), 16, 2)
    # what the spread does not take: k past SPREAD_KMAX, or past W / 3
    # (192 columns on 8 blocks: 24 a block)
    with pytest.raises(ValueError, match="rounds between"):
        yk.spread_layout(plan, 16, rounds=yk.SPREAD_KMAX + 1)
    with pytest.raises(ValueError, match="do not fit"):
        yk.spread_layout(yk.StrictPlan(192, 192, seq_zonal=True), 16,
                         rounds=9)
    # ... or counts that do not fall away from a pole
    nd = list(make_grid(384, 192, 1800).diff_sched.time2)
    nd[3], nd[4] = nd[4], nd[3]
    rising = dataclasses.replace(plan, sub_cycles=(tuple(nd), tuple(nd)))
    with pytest.raises(ValueError, match="fall away"):
        yk.spread_layout(rising, 16)


@pytest.mark.parametrize("grid", ((768, 384, 450), (384, 192, 1800)))
def test_subcycle_schedules_equal_greb_tpu(grid):
    """Each row's diffusion and advection sub-cycle counts (time2),
    sub-step lengths and coefficients at 768x384 (the pole row 6,612
    diffusion rounds a substep, 27 advection) and 384x192 (1,652) are
    greb_tpu's."""
    mine, ref = make_grid(*grid), jmake_grid(*grid)
    for name in ("diff_sched", "adv_sched"):
        a, b = getattr(mine, name), getattr(ref, name)
        for f in ("time2", "dtdff2", "ccx2"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
        assert a.max_iter == b.max_iter
    pole = 6612 if grid[0] == 768 else 1652
    assert mine.diff_sched.time2[0] == mine.diff_sched.time2[-1] == pole
    assert mine.adv_sched.time2[0] == 27
