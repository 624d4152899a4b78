"""The fused year kernels: wrappers, plain versions and launch counters.

``fluxcorr_year`` replaces ``greb_tpu/ops/pallas/year_kernel.py``
``build_fluxcorr_year`` (:353) and ``scenario_year`` replaces
``build_scenario_year`` (:231).  On a CUDA tensor each wrapper launches
its kernel from ``csrc/year_kernel.cu`` or raises; on a CPU tensor it runs
its plain PyTorch version, ``*_plain``, the eager loop over
``core.fluxcorr_step`` / ``core.scenario_step``.  Nothing falls back from
the card to the plain version.

On the card one year runs on a thread-block cluster of ``cluster`` blocks
(one of ``CLUSTER_SIZES``; ``DEFAULT_CLUSTER`` was the fastest in
``chip_smoke.py``'s sweep); the member kernels of ``multiyear.py`` run the
same cluster body, one member a cluster.  Each block owns ``Y / cluster``
latitude rows and keeps everything its rows read every substep in its own
shared memory for the whole year (``cluster_layout``): the state, the
transported fields with +-2 halo rows pushed in by its neighbours through
distributed shared memory, the step's coefficient planes, the fold's
diffusion planes and the pole composites of the rows it holds.  A substep
reads nothing from global memory and ends at one cluster barrier, so it is
bound by the latency of its load chain and the barrier (see the source
note and PERF.md).  A cluster the card cannot schedule raises; no other
size is taken.
``year_work`` gives the bytes and operations of a year, for the
whole-card bound.

The legacy ``log_exp`` switchboard (``YearData.exp``) and the transport
(``YearData.transport``) reach every kernel as one flags word in the
physics parameters (``experiment_flags``, bits ``FLAGS``).  A zero word
launches the kernel's modern instantiation, compiled without the branches;
a word with the fold and any switch the legacy one, whose step body
branches on it uniformly; a word with the strict transport (the strict
circulation, legacy log_exp 7, 8, 16) or no transport (log_exp <= 4) the
strict one, which moves Ta and q with the term-by-term stencils
(ops/stencils.py) or not at all, and has no fold in its shared memory
(``StrictPlan``).

A fold the cluster body does not hold (``is_refined``: explicit polar
segment iterations, packed composites, or dense ones too large for a
block) launches each kernel's refined instantiation (csrc/year_kernel.cu
``run_refined``; the member kernels of multiyear.py one member a 16-block
cluster), modern or legacy (suffix ``_legacy``), in one of three forms: an
extension-mode plan (384x192 at dt_crcl=1800: sequential zonal
splitting, packed pole composites, segments; ``*_refined``), a plan with
additive splitting and dense composites (192x96 at dt_crcl=1800:
advection segments and five 192x192 composite rows at each pole;
``*_additive``), or a plan with additive splitting and packed composites
(224x112 to 352x176 at dt_crcl=1800: ``*_additive_packed``, the
additive form with the sequential form's packed composite rows).  A
sequential plan whose rows one 16-block cluster cannot hold (768x384 at dt_crcl=450) runs in the wide form
(``*_wide``, ``*_wide_legacy``): one run or member spread over
``refined_groups(plan)`` clusters of 16 blocks (6 at 768x384), the halo
rows across the clusters' edges exchanged in global memory at a grid
barrier, launched only where the card runs all of a launch's clusters at
once (``check_resident``; K3 and K4 launch that many members at a time).
Its block keeps in shared memory only what a substep reads many times: the (Ta, q) double buffer with its halo rows, wz, the
zonally diffused state xa (or dd) and a scratch for the segment
iterations and composite rows (``refined_layout``); the state, the annual
sums, K3's monthly means, the step's coefficient planes (a global scratch
a member), the zd planes and the packed factors or dense composite
matrices stay in global memory and L2.  The strict transport (and no
transport) at an extension-mode grid runs in the refined instantiation's
third form (``*_strict_refined``, a ``StrictPlan`` with ``seq_zonal``):
the strict stencils with sequential zonal splitting, both polar
sub-cycles in every row, its block's shared memory the double buffer, wz
with halo rows and one sub-cycle scratch (``strict_refined_layout``),
the pole blocks' rows' diffusion sub-cycle spread over half the cluster
each (``spread_layout``); at 768x384, where one cluster does not hold it,
on 6 clusters (``*_strict_wide``, ``strict_wide_layout``: the fold's wide
form's halo exchange, each pole's rows spread over its own cluster);
where the cluster body does not hold the strict transport's K3 (224x112 to
352x176), all four kernels run the fifth form (``*_strict_additive``), the
cluster body's strict arithmetic on the same layout.  The two forms of
224x112 to 352x176 (``BAND_FORMS``) build in a library of their own,
csrc/band_kernel.cu (``refined_launcher``).
Grids that these layouts do not hold raise NotImplementedError
(``check_plan``, ``check_supported``), naming their ROADMAP item.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...config import Experiment, Numerics
from ...forcing import Corrections, ModelState
from ...model import core
from .. import fastcirc2 as fc2
from .. import stencils as stc

F32 = np.float32

# shared memory a block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232448
N_SUM = len(core.StepOutputs._fields)

# the kernels' kinds (csrc/year_kernel.cu enum Kind): a spin-up year (K1
# fluxcorr_year, K4 fluxcorr_years), a scenario year with per-step outputs
# (K2 scenario_year) and blocks of scenario years with monthly means (K3
# scenario_years)
KINDS = ("fluxcorr", "scenario", "scenario_years")
# blocks per cluster each kind launches with at 96x48 (12 and 16 are above
# the portable 8; K3's block with a pole row needs 236,544 B at 8, over
# MAX_SMEM_BYTES); the meridional stencil reaches HALO rows
CLUSTER_SIZES = {"fluxcorr": (8, 12, 16), "scenario": (8, 12, 16),
                 "scenario_years": (12, 16)}
# kinds that also offer cluster=1, the one-block body (csrc/year_kernel.cu
# run_years: one thread block a member, the coefficient planes in a global
# scratch): K3 only
ONE_BLOCK_KINDS = ("scenario_years",)
MAX_CLUSTER = 16
HALO = 2
# the fastest size in chip_smoke.py's sweep of scenario_year at 96x48 on an
# H100 (700 W): 44.7 ms a year at 16 blocks, 47.7 at 12, 57.0 at 8
DEFAULT_CLUSTER = 16
# threads a block may have (csrc/year_kernel.cu NT)
MAX_THREADS = 1024
# parts of a cluster block's shared memory, in the kernel's layout order;
# the fold's parts (coeffs, zd, pcomp, comp_*) and the strict transport's
# (winds, rowc, subcycle) are 0 in the other's layout
CLUSTER_PARTS = ("state", "transported", "coeffs", "zd", "wz", "asum",
                 "monthly", "pcomp", "comp_rows", "comp_partials", "winds",
                 "rowc", "subcycle")
# the bits of the flags word (csrc/year_kernel.cu enum Flag), each an
# Experiment property but strict_transport (``YearData.transport``); a
# launcher refuses a word with a bit it does not know, and the vapour bits
# without the strict one (GREB_ERR_FLAGS)
FLAGS = ("fixed_albedo", "simple_seaice", "hydro_off", "circulation_off",
         "deep_ocean_off", "linear_vapor_lw", "sst_plus_one",
         "strict_transport", "vapor_circulation_off", "vapor_diffusion_only")
# where K3's one-block body under the strict transport is queued
STRICT_ONE_BLOCK_ITEM = "ROADMAP Queue 2 item 4"

# the refined instantiation (``is_refined``, every kind): the cluster size
# it launches with (12 rows of 384 columns a block at 384x192; 8 and 12
# blocks need more than MAX_SMEM_BYTES), the parts of its block's shared
# memory in the kernel's layout order (csrc/year_kernel.cu enum
# RefinedPart; the strict form's names for the same slots: no xz, which
# waits in the next buffer's own rows, the sub-cycles' two buffers, the
# rows' constants), and the most segments of either kind it takes
REFINED_CLUSTER_SIZES = (16,)
# the most clusters one run of the wide form spans (csrc/year_kernel.cu
# MAX_GROUPS: 132 SMs hold 8 clusters of 16 blocks)
MAX_GROUPS = 8
REFINED_PARTS = ("transported", "wz", "xa", "scratch", "comp_index")
STRICT_REFINED_PARTS = ("transported", "wz", "xz", "subcycle", "rowc")
MAX_SEGS = 8
# the forms of the refined instantiation (csrc/year_kernel.cu enum
# RefinedForm): the fold with sequential splitting and packed composites,
# the fold with additive splitting and dense composites, the strict
# transport with sequential splitting, the fold with additive splitting and
# packed composites (224x112 to 352x176), the strict transport with
# additive splitting where the cluster body does not hold it
REFINED_FORMS = ("sequential", "additive", "strict", "additive_packed",
                 "strict_additive")
# where what the refined instantiation does not run is queued
REFINED_ITEMS = dict(
    layout="ROADMAP Queue 1 item 3d")    # grids its layout does not hold
# the sequential strict form's spread pole sub-cycle (csrc/year_kernel.cu
# spread_cycle): the most rounds between two exchanges of a line's edge
# columns (a run takes the most its layout holds, ``spread_rounds``; 12,
# the fastest of 4, 8, 12 and 16 at 768x384 on an H100, PERF.md §6), the
# most the kernel takes (SPREAD_KMAX) and the most rows of a block
# (SPREAD_MAXR)
SPREAD_ROUNDS = 12
SPREAD_KMAX = 16
SPREAD_MAXR = 32


def experiment_flags(exp: Experiment, strict: bool = False) -> int:
    """The kernels' flags word of ``exp`` (0 for the modern variant), with
    the strict-transport bit where ``strict``."""
    on = lambda name: strict if name == "strict_transport" else getattr(
        exp, name)
    return sum(1 << i for i, name in enumerate(FLAGS) if on(name))


@dataclass(frozen=True)
class StrictPlan:
    """The layout plan of a year without the fold, the strict transport or
    none: the grid's size and no fold (no composite rows).  ``seq_zonal``
    marks an extension-mode grid, which the refined instantiation's strict
    form runs (sequential zonal splitting, every row sub-cycled);
    ``sub_cycles``, where known, the (diffusion, advection) sub-cycles of
    each row (``stencils.sub_cycles``; -1: the row takes the vectorised
    form), which ``year_work`` counts.  ``_groups`` and ``_rounds`` (0:
    the run's own) force the clusters a run of the sequential strict form
    spans and the spread sub-cycle's rounds between exchanges, for checks
    that hold one such run against another (``_forced``)."""
    ydim: int
    xdim: int
    seq_zonal: bool = False
    bt: int = 0
    bb: int = 0
    comp_kt: int = 0
    comp_kb: int = 0
    sub_cycles: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = field(
        default=None, repr=False, compare=False)
    _groups: int = field(default=0, repr=False)
    _rounds: int = field(default=0, repr=False)


@dataclass
class YearData:
    """Everything constant across the year calls of a run, with the legacy
    switchboard ``exp``; ``cache`` keeps the member wrappers' copies of
    constants (month maps on the device, the member pack on the host), made
    once per run."""
    md: core.ModelData
    sfx: core.StepForcing
    fold: Optional[core.Fold]
    num: Numerics
    exp: Experiment = field(default_factory=Experiment)
    cache: Dict = field(default_factory=dict, repr=False)

    @property
    def transport(self) -> str:
        """"fold", "strict" or "none" (``core.transport``)."""
        return core.transport(self.exp, self.fold is not None)

    @property
    def flags(self) -> int:
        """The kernels' flags word of this run (``experiment_flags``)."""
        return experiment_flags(self.exp, self.transport == "strict")

    @property
    def plan(self):
        """The fold's plan, or the ``StrictPlan`` of a year without the
        fold (under the strict transport with each row's sub-cycles; made
        once per run)."""
        if self.transport == "fold":
            return self.fold[0]
        key = ("plan", self.transport)
        if key not in self.cache:
            st = self.md.st
            counts = None
            if self.transport == "strict":
                counts = tuple(tuple(int(n) for n in c.cpu())
                               for c in stc.sub_cycles(st, self.md.sf))
            self.cache[key] = StrictPlan(
                self.num.ydim, self.num.xdim,
                seq_zonal=bool(st and st.seq_zonal), sub_cycles=counts)
        return self.cache[key]


@dataclass(frozen=True)
class ClusterLayout:
    """One block's share of a member's years on a cluster: its latitude
    rows, the most pole composite rows any block holds, its threads, the
    bytes of each part of its shared memory (``CLUSTER_PARTS`` order), and
    the clusters of ``blocks`` blocks a member spans (``groups``: the
    refined instantiation's wide form, else 1)."""
    blocks: int
    rows: int
    comp_rows: int
    threads: int
    parts: Tuple[Tuple[str, int], ...]
    groups: int = 1

    @property
    def nbytes(self) -> int:
        return sum(b for _, b in self.parts)


def _comp_rows_in(r0: int, r1: int, plan: fc2.FastPlan) -> int:
    """Composite rows among rows [r0, r1): the top comp_kt and the bottom
    comp_kb."""
    top = min(r1, plan.comp_kt) - r0
    bot = r1 - max(r0, plan.ydim - plan.comp_kb)
    return max(top, 0) + max(bot, 0)


def cluster_layout(plan, blocks: int, kind: str) -> ClusterLayout:
    """The shared memory of each block of a ``blocks``-block cluster that
    runs a kernel of ``kind`` (one of KINDS; csrc/year_kernel.cu
    ``cluster_parts``, the same reckoning).  With a fold's plan: the
    5-field state of its rows, two buffers of the 2 transported fields with
    HALO rows each side, the step's 12 coefficient planes, the 7
    zonal-diffusion planes and wz for 2 fields, the 9 annual sums (the
    scenario kinds), the month's 5 means (``scenario_years``), the (2, X, X)
    composite matrices, their t1/da/dy rows and their partial row sums for
    each pole row a block holds.  With a ``StrictPlan`` (the strict
    instantiation): the state, the two buffers, wz of 2 fields with HALO
    rows each side, the sums and means, the step's winds u and v, 8 words
    of constants a row and the polar sub-cycles' 4 planes of 2 fields
    (diffusion and advection, two buffers each).
    Raises ValueError where the rows do not split evenly, a block would
    hold fewer rows than the halo depth, the row length is not a multiple
    of 4 (the composite sums load 16 bytes at a time), or a block needs
    more than MAX_SMEM_BYTES."""
    lay = _cluster_parts(plan, blocks, kind)
    if lay.nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{kind}: a cluster of {blocks} blocks at "
                         f"{plan.xdim}x{plan.ydim} needs {lay.nbytes} B of "
                         f"shared memory a block, over {MAX_SMEM_BYTES} B")
    return lay


def _cluster_parts(plan, blocks: int, kind: str) -> ClusterLayout:
    """``cluster_layout`` without its check against MAX_SMEM_BYTES."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    Y, X = plan.ydim, plan.xdim
    if X % 4:
        raise ValueError(f"cluster kernels: {X} columns, not a multiple of 4")
    if not 1 <= blocks <= MAX_CLUSTER or Y % blocks:
        raise ValueError(f"a cluster of {blocks} blocks: {Y} latitude rows "
                         f"do not split evenly over 1..{MAX_CLUSTER} blocks")
    R = Y // blocks
    if R < HALO:
        raise ValueError(f"a cluster of {blocks} blocks gives {R} row(s) per "
                         f"block, under the meridional halo depth {HALO}")
    words = dict.fromkeys(CLUSTER_PARTS, 0)
    words.update(state=5 * R * X, transported=2 * 2 * (R + 2 * HALO) * X,
                 asum=N_SUM * R * X if kind != "fluxcorr" else 0,
                 monthly=core.N_OUT * R * X if kind == "scenario_years" else 0)
    if isinstance(plan, StrictPlan):
        kmax = 0
        words.update(wz=2 * (R + 2 * HALO) * X, winds=2 * R * X, rowc=8 * R,
                     subcycle=4 * 2 * R * X)
    else:
        kmax = max(_comp_rows_in(b * R, (b + 1) * R, plan)
                   for b in range(blocks))
        nb = -(-X // fc2.COMP_BLOCK)
        words.update(coeffs=12 * 2 * R * X, zd=7 * 2 * R * X, wz=2 * R * X,
                     pcomp=2 * kmax * X * X, comp_rows=3 * 2 * kmax * X,
                     comp_partials=2 * kmax * nb * X)
    lay = ClusterLayout(
        blocks=blocks, rows=R, comp_rows=kmax,
        threads=min(MAX_THREADS, -(-2 * R * X // 32) * 32),
        parts=tuple((n, 4 * words[n]) for n in CLUSTER_PARTS))
    return lay


def _rows_in(r0: int, r1: int, a: int, b: int) -> int:
    """Rows of [r0, r1) in [a, b)."""
    return max(0, min(r1, b) - max(r0, a))


def _reach(segs) -> Tuple[int, int]:
    """The rows from each pole that any of ``segs`` (kt, kb, iters)
    reaches: segments are nested, so their union is (max kt, max kb)."""
    return (max((s[0] for s in segs), default=0),
            max((s[1] for s in segs), default=0))


def refined_layout(plan, blocks: int, kind: str,
                   groups: int = 1) -> ClusterLayout:
    """The shared memory of each block of a ``blocks``-block cluster that
    runs the refined instantiation of ``kind`` (one of KINDS; the same for
    each) on a fold of one of its forms, sequential zonal splitting with
    packed composites or additive splitting with dense or packed ones
    (csrc/year_kernel.cu ``refined_parts``, the same reckoning), one run
    on ``groups`` such clusters (more than 1: the wide form, sequential
    splitting only, the rows split over groups * blocks blocks): two
    buffers of the 2 transported fields with HALO rows each side, wz of its
    rows, their zonally diffused state xa (first their zonal diffusion dd;
    additive: dd alone), a scratch and the composite rows' index (packed;
    unused with dense composites).
    The scratch holds, one after the other in a substep, the diffusion
    segments' two buffers (2 fields of the block's rows in any diffusion
    segment), the composites' t1 rows (packed: and z, at most X a row;
    each 2 fields of its composite rows) and the advection segments' two
    buffers (their da waits in the next (Ta, q) buffer's own rows).  What
    the refined instantiation keeps in global memory (state, annual sums,
    K3's monthly means, the step's coefficient planes, zd, the packed
    factors or the dense composite matrices) is not part of it.
    Raises ValueError where ``cluster_layout`` does, where the row length is
    not a multiple of fastcirc2.COMP_BLOCK (the composite sums take whole
    blocks of a row), for a plan of neither form, for more than MAX_SEGS
    segments, for ``groups`` outside 1..MAX_GROUPS or above 1 with
    additive splitting, and where a block needs more than MAX_SMEM_BYTES.
    A ``StrictPlan``: ``strict_refined_layout`` on one cluster,
    ``strict_wide_layout`` on more."""
    if isinstance(plan, StrictPlan):
        if groups == 1:
            return strict_refined_layout(plan, blocks, kind)
        return strict_wide_layout(plan, blocks, kind, groups)
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    form = ("packed",) if plan.seq_zonal else ("dense", "none", "packed")
    if (isinstance(plan, StrictPlan) or not is_refined(plan)
            or plan.comp_mode not in form):
        raise ValueError(f"the refined layout holds sequential splitting "
                         f"with packed composites or additive splitting "
                         f"with dense or packed ones, not {plan}")
    if max(len(plan.diff_segs), len(plan.adv_segs)) > MAX_SEGS:
        raise ValueError(f"more than {MAX_SEGS} segments: {plan}")
    if not 1 <= groups <= MAX_GROUPS or (groups > 1 and not plan.seq_zonal):
        raise ValueError(f"{groups} clusters a run: the wide form takes "
                         f"1..{MAX_GROUPS}, with sequential splitting")
    Y, X = plan.ydim, plan.xdim
    if X % fc2.COMP_BLOCK:
        raise ValueError(f"refined kernels: {X} columns, not a multiple of "
                         f"{fc2.COMP_BLOCK}")
    if not 1 <= blocks <= MAX_CLUSTER or Y % (blocks * groups):
        raise ValueError(f"{groups} cluster(s) of {blocks} blocks: {Y} "
                         f"latitude rows do not split evenly over them")
    n = blocks * groups      # the run's blocks
    R = Y // n
    if R < HALO:
        raise ValueError(f"{groups} cluster(s) of {blocks} blocks give {R} "
                         f"row(s) per block, under the meridional halo depth "
                         f"{HALO}")
    ktc, kbc = plan.comp_kt, plan.comp_kb
    (dkt, dkb), (akt, akb) = _reach(plan.diff_segs), _reach(plan.adv_segs)

    def most(a0, a1, b0, b1):
        return max(_rows_in(b * R, (b + 1) * R, a0, a1)
                   + _rows_in(b * R, (b + 1) * R, b0, b1)
                   for b in range(n))

    kmax = most(0, ktc, Y - kbc, Y)
    nsd = most(ktc, ktc + dkt, Y - kbc - dkb, Y - kbc)
    nsa = most(0, akt, Y - akb, Y)
    words = dict(transported=2 * 2 * (R + 2 * HALO) * X, wz=2 * R * X,
                 xa=2 * R * X,
                 scratch=2 * 2 * max(nsd, kmax, nsa) * X,
                 comp_index=-(-(2 * kmax + 1) // 4) * 4)
    lay = ClusterLayout(
        blocks=blocks, rows=R, comp_rows=kmax,
        threads=min(MAX_THREADS, -(-2 * R * X // 32) * 32),
        parts=tuple((p, 4 * words[p]) for p in REFINED_PARTS), groups=groups)
    if lay.nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"refined {kind}: {groups} cluster(s) of {blocks} "
                         f"blocks at {X}x{Y} need {lay.nbytes} B of shared "
                         f"memory a block, over {MAX_SMEM_BYTES} B")
    return lay


def refined_groups(plan, blocks: int = REFINED_CLUSTER_SIZES[0]) -> int:
    """The clusters of ``blocks`` blocks that one run (or member) of
    ``plan`` spans in the refined instantiation: 1 where one cluster holds
    it, else, for sequential splitting (the fold's or the strict
    transport's), the smallest G in 2..MAX_GROUPS whose wide layout
    (``refined_layout(plan, blocks, kind, G)``, the same for every kind)
    fits; a ``StrictPlan``'s forced ``_groups`` where it sets one (its
    layout checked).  Raises ValueError where none does (the card's
    capacity is ``check_resident``'s)."""
    if isinstance(plan, StrictPlan) and plan._groups:
        refined_layout(plan, blocks, KINDS[0], plan._groups)
        return plan._groups
    try:
        refined_layout(plan, blocks, KINDS[0])
        return 1
    except ValueError as e:
        if not plan.seq_zonal:
            raise
        first = e
    for g in range(2, MAX_GROUPS + 1):
        try:
            refined_layout(plan, blocks, KINDS[0], g)
            return g
        except ValueError:
            continue
    raise ValueError(f"no run of 1..{MAX_GROUPS} clusters of {blocks} "
                     f"blocks holds {plan.xdim}x{plan.ydim}: {first}")


def check_resident(groups: int, capacity: int, members: int = 1) -> int:
    """How many members (at most ``members``) one launch of the wide form
    takes, each on ``groups`` clusters, where the card runs ``capacity``
    such clusters at once (``cluster_capacity``): its grid barrier waits
    for every block of the launch, so all of a launch's clusters must be
    resident together, never in waves.  Raises RuntimeError where not even
    one member's fit, naming the capacity found."""
    if capacity < groups:
        raise RuntimeError(
            f"the wide form spans {groups} clusters of 16 blocks a run, and "
            f"the card runs {capacity} at once: its grid barrier would "
            f"never end, so nothing is launched")
    return max(1, min(members, capacity // groups))


def spread_layout(plan, blocks: int, groups: int = 1,
                  rounds: Optional[int] = None) -> Tuple[int, int]:
    """(H, W): the blocks of each pole's group in the sequential strict
    form's spread sub-cycle (csrc/year_kernel.cu ``spread_fits``, the same
    reckoning) on ``groups`` clusters of ``blocks`` blocks, and the columns
    each owns, ``rounds`` (default SPREAD_ROUNDS) rounds between exchanges.
    One cluster holds both poles' groups, its two halves; a wide run's
    first and last clusters are the poles' groups.  A block keeps each of
    the pole block's 2R lines (a row of a field, a warp at least each) on
    its W columns and 3k more each side in its second sub-cycle buffer,
    with wz and two slots of 3k columns a side: 2R (3W + 30k) words; the
    lines still running are a prefix of them, so the pole block's counts
    (``plan.sub_cycles``, where known) must fall away from the pole.
    Raises ValueError where it does not fit."""
    k = SPREAD_ROUNDS if rounds is None else rounds
    Y, X = plan.ydim, plan.xdim
    H = blocks if groups > 1 else blocks // 2
    if not 1 <= k <= SPREAD_KMAX:
        raise ValueError(f"spread sub-cycle: {k} rounds between exchanges, "
                         f"not in 1..{SPREAD_KMAX}")
    if (H < 2 or (groups == 1 and blocks % 2) or X % H
            or Y % (blocks * groups)):
        raise ValueError(f"spread sub-cycle: {X} columns or {Y} rows do not "
                         f"split over {groups} cluster(s) of {blocks} blocks")
    R, W = Y // (blocks * groups), X // H
    if plan.sub_cycles is not None:
        # the lines still running are a prefix of the pole block's: the
        # counts fall away from each pole
        nd = plan.sub_cycles[0]
        for rows in (nd[:R], nd[::-1][:R]):
            if any(b > a for a, b in zip(rows, rows[1:])):
                raise ValueError(f"spread sub-cycle: the pole block's "
                                 f"diffusion counts {tuple(rows)} do not "
                                 f"fall away from the pole")
    lanes = min(MAX_THREADS, -(-2 * R * X // 32) * 32)
    if R < HALO or R > SPREAD_MAXR or W < 3 * k or 2 * R * 32 > lanes \
            or 2 * R * (3 * W + 30 * k) > 2 * R * X:
        raise ValueError(f"spread sub-cycle: {2 * R} lines of {W} columns a "
                         f"block and {k} rounds between exchanges do not fit "
                         f"{groups} cluster(s) of {blocks} blocks at {X}x{Y}")
    return H, W


def spread_rounds(plan, blocks: int = REFINED_CLUSTER_SIZES[0],
                  groups: int = 1) -> int:
    """The rounds between the spread sub-cycle's exchanges that a run of
    ``plan`` takes: the most, up to SPREAD_ROUNDS, that ``spread_layout``
    holds (768x384: 12; 384x192: 8, on one cluster or two); a
    ``StrictPlan``'s forced ``_rounds`` where it sets one (its layout
    checked).  Raises ValueError where not even one does."""
    if getattr(plan, "_rounds", 0):
        spread_layout(plan, blocks, groups, plan._rounds)
        return plan._rounds
    for k in range(SPREAD_ROUNDS, 1, -1):
        try:
            spread_layout(plan, blocks, groups, k)
            return k
        except ValueError:
            continue
    spread_layout(plan, blocks, groups, 1)
    return 1


def _forced(yd: YearData, groups: int = 0, rounds: int = 0) -> YearData:
    """A ``YearData`` of ``yd``'s run under the strict transport whose
    plan forces the sequential strict form onto ``groups`` clusters a run
    and the spread sub-cycle to ``rounds`` rounds between exchanges (0:
    the run's own), both checked against the layouts; for checks that hold
    such a run against the run's own.  Its cache starts empty."""
    plan = dataclasses.replace(yd.plan, _groups=groups, _rounds=rounds)
    spread_rounds(plan, groups=refined_groups(plan))
    out = YearData(md=yd.md, sfx=yd.sfx, fold=yd.fold, num=yd.num,
                   exp=yd.exp)
    out.cache[("plan", yd.transport)] = plan
    return out


def strict_wide_layout(plan: StrictPlan, blocks: int, kind: str,
                       groups: int) -> ClusterLayout:
    """The shared memory of each block of the sequential strict form's wide
    variant (``*_strict_wide``): one run on ``groups`` clusters of
    ``blocks`` blocks (2..MAX_GROUPS), its rows split over groups * blocks
    blocks, each block ``strict_refined_layout``'s parts for its rows
    (csrc/year_kernel.cu ``strict_refined_parts`` on 16 G blocks), the halo
    rows across the clusters' edges through global memory at a grid
    barrier, as the fold's wide form (``refined_layout`` with ``groups``).
    Raises ValueError where ``strict_refined_layout`` does, for a plan with
    additive splitting, for ``groups`` outside 2..MAX_GROUPS and where the
    spread sub-cycle does not fit (``spread_rounds``)."""
    if not plan.seq_zonal:
        raise ValueError(f"the strict wide form runs sequential splitting, "
                         f"not {plan}")
    if not 2 <= groups <= MAX_GROUPS:
        raise ValueError(f"{groups} clusters a run: the wide form takes "
                         f"2..{MAX_GROUPS}")
    if not 1 <= blocks <= MAX_CLUSTER or plan.ydim % (blocks * groups):
        raise ValueError(f"{groups} clusters of {blocks} blocks: "
                         f"{plan.ydim} latitude rows do not split evenly "
                         f"over them")
    lay = strict_refined_layout(plan, blocks * groups, kind,
                                max_blocks=MAX_CLUSTER * MAX_GROUPS,
                                spread=False)
    spread_rounds(plan, blocks, groups)
    return dataclasses.replace(lay, blocks=blocks, groups=groups)


def strict_refined_layout(plan: StrictPlan, blocks: int, kind: str,
                          max_blocks: int = MAX_CLUSTER,
                          spread: bool = True) -> ClusterLayout:
    """The shared memory of each block of a ``blocks``-block cluster that
    runs one of the refined instantiation's strict forms of ``kind`` (one
    of KINDS; the same for each): sequential splitting at an
    extension-mode grid (``plan.seq_zonal``), else additive splitting
    (csrc/year_kernel.cu ``strict_refined_parts``, the same reckoning;
    ``STRICT_REFINED_PARTS`` order): two buffers of the 2 transported
    fields with HALO rows each side, wz of both fields with HALO rows each
    side, no xz (the sequential form's xz and the additive form's finished
    diffusion sub-cycle wait in the next buffer's own rows), the polar
    sub-cycles' two buffers of 2 fields (the diffusion's, then the
    advection's) and 6 words a row (the two sub-cycle coefficients and
    counts, the rows in order of each count; additive splitting 8, with
    the coefficients of the rows without a sub-cycle).  The state, the
    annual sums, K3's monthly means and the step's winds stay in global
    memory.  Raises ValueError where the rows do not
    split evenly, a block would hold fewer rows than the halo depth, the
    row length is not a multiple of 4, a block needs more than
    MAX_SMEM_BYTES, or (sequential splitting, ``spread``) the spread
    sub-cycle does not fit (``spread_rounds``).  ``max_blocks``: the
    blocks of a run (``strict_wide_layout``'s 16 G)."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    Y, X = plan.ydim, plan.xdim
    if X % 4:
        raise ValueError(f"strict refined kernels: {X} columns, not a "
                         f"multiple of 4")
    if not 1 <= blocks <= max_blocks or Y % blocks:
        raise ValueError(f"a cluster of {blocks} blocks: {Y} latitude rows "
                         f"do not split evenly over 1..{max_blocks} blocks")
    R = Y // blocks
    if R < HALO:
        raise ValueError(f"a cluster of {blocks} blocks gives {R} row(s) per "
                         f"block, under the meridional halo depth {HALO}")
    words = dict(transported=2 * 2 * (R + 2 * HALO) * X,
                 wz=2 * (R + 2 * HALO) * X, xz=0, subcycle=2 * 2 * R * X,
                 rowc=-(-(6 if plan.seq_zonal else 8) * R // 4) * 4)
    lay = ClusterLayout(
        blocks=blocks, rows=R, comp_rows=0,
        threads=min(MAX_THREADS, -(-2 * R * X // 32) * 32),
        parts=tuple((n, 4 * words[n]) for n in STRICT_REFINED_PARTS))
    if lay.nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"strict refined {kind}: a cluster of {blocks} "
                         f"blocks at {X}x{Y} needs {lay.nbytes} B of shared "
                         f"memory a block, over {MAX_SMEM_BYTES} B")
    if plan.seq_zonal and spread:
        spread_rounds(plan, blocks)
    return lay


def is_refined(plan) -> bool:
    """A plan the kernels run in their refined instantiation, which reads
    the state and its planes from L2, and not in the cluster body: a fold
    with sequential zonal splitting (an extension-mode grid), explicit
    polar segments, packed composites, or dense composites of which one
    pole row's two (X, X) matrices alone exceed a block's shared memory
    (192x96); the ``StrictPlan`` of an extension-mode grid (the strict
    form); a ``StrictPlan`` whose rows a cluster of DEFAULT_CLUSTER blocks
    of the cluster body splits but whose block there does not hold the
    largest kind, K3 (the strict additive form: from 224x112 to 352x176,
    for all four kernels, as one grid's kernels run one instantiation;
    where K1 alone would fit the cluster body, its pole block would
    sub-cycle all its rows to the block's deepest count, and the strict
    additive form runs each row to its own: PERF.md §6)."""
    if isinstance(plan, StrictPlan):
        if plan.seq_zonal:
            return True
        try:
            lay = _cluster_parts(plan, DEFAULT_CLUSTER, KINDS[-1])
        except ValueError:
            return False
        return lay.nbytes > MAX_SMEM_BYTES
    return bool(plan.seq_zonal or plan.diff_segs or plan.adv_segs
                or plan.comp_mode == "packed"
                or (plan.diff_composite
                    and 2 * 4 * plan.xdim ** 2 > MAX_SMEM_BYTES))


def block_layout(plan, blocks: int, kind: str) -> ClusterLayout:
    """The layout of the instantiation that runs ``plan``:
    ``refined_layout`` for a fold of the refined instantiation
    (``is_refined``; on ``refined_groups`` clusters), else
    ``cluster_layout``."""
    if is_refined(plan):
        return refined_layout(plan, blocks, kind,
                              refined_groups(plan, blocks))
    return cluster_layout(plan, blocks, kind)


def smem_bytes(plan) -> int:
    """Dynamic shared memory of a block of K3's one-block body
    (``scenario_years`` at cluster=1): the 5-field state, two buffers of
    the 2 transported fields, and 3 slabs of the composite rows (the
    layout of csrc/year_kernel.cu run_years)."""
    yx = plan.ydim * plan.xdim
    kx = (plan.comp_kt + plan.comp_kb) * plan.xdim
    return 4 * (5 * yx + 4 * yx + 6 * kx)


def check_plan(plan, kind: str, flags: int = 0) -> None:
    """Raise NotImplementedError for what the kernel of ``kind`` (one of
    KINDS; "fluxcorr" and "scenario_years" are also the member kernels K4
    and K3) does not run with the flags word ``flags`` (every word runs;
    ``flags`` names the word in the message).  A fold of the refined
    instantiation (``is_refined``: 192x96 to 384x192, 768x384) runs in one
    of its forms: sequential zonal splitting with packed composites, or
    additive splitting with dense or packed ones (sequential with dense
    composites, which ``make_plan`` never builds, raises ValueError), at a
    size ``refined_layout`` holds on REFINED_CLUSTER_SIZES, sequential
    splitting also on several such clusters (the wide form,
    ``refined_groups``; else REFINED_ITEMS["layout"]).  A ``StrictPlan``
    of the refined instantiation (``is_refined``) runs in a strict form:
    at an extension-mode grid where every row takes both polar sub-cycles
    (as at every extension-mode grid the reference's polar criterion
    gives; else REFINED_ITEMS["layout"]) with sequential splitting, on one
    cluster of REFINED_CLUSTER_SIZES (``strict_refined_layout``) or, as
    at 768x384, on several (the wide form, ``refined_groups``), else with
    additive splitting on one (else REFINED_ITEMS["layout"]).  The
    cluster body runs every other fold and the strict transport at any
    other grid (``check_supported`` checks its fit)."""
    if isinstance(plan, StrictPlan):
        if not is_refined(plan):
            return
        try:
            refined_groups(plan, REFINED_CLUSTER_SIZES[0])
        except ValueError as e:
            raise NotImplementedError(
                f"{kind}: the strict transport or no transport (flags "
                f"{flags:#x}) at {plan.xdim}x{plan.ydim}: no strict form of "
                f"the refined instantiation holds this grid: {e} "
                f"({REFINED_ITEMS['layout']})") from None
        if (plan.seq_zonal and plan.sub_cycles is not None
                and min(map(min, plan.sub_cycles)) < 0):
            raise NotImplementedError(
                f"{kind}: the strict transport (flags {flags:#x}) at an "
                f"extension-mode grid with rows outside the polar "
                f"sub-cycles ({REFINED_ITEMS['layout']})")
        return
    if plan.seq_zonal and plan.comp_mode != "packed":
        raise ValueError(f"year kernels: sequential zonal splitting with "
                         f"comp_mode={plan.comp_mode!r}, a plan make_plan "
                         f"does not build")
    if not is_refined(plan):
        return
    try:
        refined_groups(plan, REFINED_CLUSTER_SIZES[0])
    except ValueError as e:
        raise NotImplementedError(
            f"{kind}: the refined instantiation, which runs the folds with "
            f"sequential splitting, explicit polar segments (here "
            f"{plan.diff_segs}, {plan.adv_segs}) or large composites, does "
            f"not hold this one: {e} ({REFINED_ITEMS['layout']})") from None


def check_supported(plan, kinds: Tuple[str, ...] = KINDS,
                    flags: int = 0) -> None:
    """Raise for what the kernels of ``kinds`` do not run: the plans,
    words and refined layouts of ``check_plan``, and grids that a cluster
    of DEFAULT_CLUSTER blocks of the cluster body does not hold
    (``cluster_layout``)."""
    for kind in kinds:
        check_plan(plan, kind, flags)
        if not is_refined(plan):
            cluster_layout(plan, DEFAULT_CLUSTER, kind)


def check_block_fit(plan) -> None:
    """Raise where one member's state does not fit one block's shared
    memory (K3's one-block body)."""
    need = smem_bytes(plan)
    if need > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"one block a member: a {plan.xdim}x{plan.ydim} state needs "
            f"{need} B of shared memory, over one block's {MAX_SMEM_BYTES} B")


def packed_ranks(const: fc2.Fast2Const) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, ranks) in Rtot of the packed composite rows f*K + k
    (``fastcirc2.PackedIndex``): row i's factors are
    U_all[:, off:off+r] and W_all[off:off+r, :]."""
    if const.pidx is None:
        raise ValueError("not a packed fold: no composite ranks")
    return const.pidx.offs, const.pidx.ranks


# float32 operations of one (field, cell) of one explicit segment
# iteration (fastcirc._iterate: the 7-point sum in sequence 13, the clamp's
# compare 1, the add 1), and of entering and leaving a segment (t1 = x +
# d, then d = t1 - x)
SEG_ITER_OPS = 15
SEG_EDGE_OPS = 2


def composite_words(plan: fc2.FastPlan,
                    ranks: Optional[np.ndarray] = None) -> int:
    """float32 words of the pole composites a year reads once: one (X, X)
    matrix a dense row; packed (``ranks``, ``packed_ranks``, required),
    U_all and W_all at their ranks and each row's offset and rank."""
    if plan.comp_mode == "packed":
        if ranks is None:
            raise ValueError("packed composites: the work needs their ranks "
                             "(packed_ranks)")
        return 2 * plan.xdim * int(np.sum(ranks)) + 2 * len(ranks)
    return 2 * (plan.comp_kt + plan.comp_kb) * plan.xdim ** 2


def year_work(plan, num: Numerics, scenario: bool,
              ranks: Optional[np.ndarray] = None, flags: int = 0):
    """(bytes, operations) one year must move and compute at least: each
    input read once and each output written once; operations counted from
    the step body's source (adds, multiplies, divides, compares,
    transcendentals each 1).  Dense composites count one (X, X) matrix a
    pole row; packed ones (``ranks``, ``packed_ranks``, required) count
    U_all and W_all at their ranks (and each row's offset and rank) and
    their two products at the rows' ranks, z = t1 U (2 X r a row) and
    t2 = z W (2 X r); the explicit segments count each row's iterations.
    With sequential zonal splitting (extension-mode plans) the combine's 4
    operations a cell are xa = x + wz dd (2) and xa + da + dy (2).  A
    ``StrictPlan`` counts the strict transport under the flags word
    ``flags`` (``strict_work``)."""
    if isinstance(plan, StrictPlan):
        return strict_work(plan, num, scenario, flags)
    yx, t, X = plan.ydim * plan.xdim, num.nstep_yr, plan.xdim
    kk = plan.comp_kt + plan.comp_kb
    comp_words = composite_words(plan, ranks)
    if plan.comp_mode == "packed":
        comp_ops = 4 * X * int(np.sum(ranks)) + 2 * kk * X * 4
    else:
        comp_ops = 2 * kk * X * (2 * X + 4)
    seg_ops = sum(2 * (kt + kb) * X * (iters * SEG_ITER_OPS + SEG_EDGE_OPS)
                  for kt, kb, iters in plan.diff_segs + plan.adv_segs)
    words = (5 * yx                      # state in
             + 8 * t * yx + t * plan.ydim  # forcing, insolation
             + 5 * yx                    # z_topo, glacier, wz_air, z_ocean, toclim
             + (7 + 8 + 9 + 1) * 2 * yx  # fold planes
             + comp_words                # composites
             + 5 * yx                    # state out
             + 3 * t * yx)               # corrections in (scenario) / out
    if scenario:
        words += 5 * t * yx + N_SUM * yx  # outs, annual sums
    per_substep = (2 * yx * (2 * 13 + 2 + 9 + 4)     # zonal x2, clamps,
                   + comp_ops + seg_ops)             # merid, combine
    per_step = (num.nsub_crcl * per_substep
                + 2 * yx * 21                          # step coefficients
                + yx * (125 + (9 if scenario else 0)))  # physics, update, sums
    return 4 * words, t * per_step


# float32 operations of one (field, cell) of a strict substep, counted from
# csrc/year_kernel.cu strict_value / strict_substep (additive splitting)
# and strict_seq_substep (sequential) as year_work counts: diffusion
# (meridional 6, the 7-point stencil 36, wz * (dtx + dty) 2; sequential:
# xz = x + wz * dtx 2 and xz + wz * dty 2), advection (wind splits 4,
# meridional 17, the 2-point upwind 16, dtx + dty 1), the combine 2 (1
# without advection; sequential: the one add of dxa); a sub-cycled row
# swaps the zonal stencil for t1h - x (1) plus each of its iterations
# (diffusion 41, advection 33: the stencil, the clamp, the add)
STRICT_OPS = dict(diff=44, diff7=36, adv=38, upwind2=16, combine=2,
                  diff_iter=41, adv_iter=33)


def strict_work(plan: StrictPlan, num: Numerics, scenario: bool,
                flags: int = 0):
    """(bytes, operations) one year of the strict transport (or none) must
    move and compute at least under the flags word ``flags``, counted as
    ``year_work``: the polar sub-cycles count each row's own iterations
    (``plan.sub_cycles``: what this grid needs, not the block's largest
    count), and a field moves only as the switchboard says (none under
    circulation_off; q not under log_exp 7, 16; by diffusion alone under
    8).  With sequential zonal splitting (``plan.seq_zonal``) a moving
    (field, cell) takes one add more than with additive splitting."""
    on = lambda name: bool(flags >> FLAGS.index(name) & 1)
    Y, X, t = plan.ydim, plan.xdim, num.nstep_yr
    yx = Y * X
    words = (5 * yx + 8 * t * yx + t * Y       # state in, forcing, insolation
             + 5 * yx + 5 * yx + 3 * t * yx)   # constant fields, state out,
                                               # corrections
    if not on("circulation_off"):
        words += yx + 6 * Y                    # wz_vapor, the rows' constants
    if scenario:
        words += 5 * t * yx + N_SUM * yx
    per_step = yx * (125 + (9 if scenario else 0))
    if not on("circulation_off"):
        per_step += num.nsub_crcl * strict_substep_ops(plan, flags)
    return 4 * words, t * per_step


def strict_substep_ops(plan: StrictPlan, flags: int = 0) -> int:
    """float32 operations of one strict substep of every row of ``plan``
    under the flags word ``flags`` (``strict_work``'s count): each row's
    own sub-cycle iterations (``plan.sub_cycles``), the fields that move
    and advect as the switchboard says."""
    on = lambda name: bool(flags >> FLAGS.index(name) & 1)
    if plan.sub_cycles is None:
        raise ValueError("the strict transport's work needs each row's "
                         "sub-cycles (StrictPlan.sub_cycles)")
    nd, na = plan.sub_cycles
    o, seq = STRICT_OPS, int(plan.seq_zonal)

    def field_ops(advect: bool) -> int:
        ops = 0
        for r in range(plan.ydim):
            ops += o["diff"] + o["combine"] + seq - (0 if advect else 1)
            if nd[r] >= 0:
                ops += 1 - o["diff7"] + o["diff_iter"] * nd[r]
            if advect:
                ops += o["adv"]
                if na[r] >= 0:
                    ops += 1 - o["upwind2"] + o["adv_iter"] * na[r]
        return ops * plan.xdim

    ops = field_ops(True)
    if not on("vapor_circulation_off"):
        ops += field_ops(not on("vapor_diffusion_only"))
    return ops



# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def fluxcorr_year_plain(state: ModelState, co2,
                        yd: YearData) -> Tuple[ModelState, Corrections]:
    return core.run_year_fluxcorr(state, yd.sfx, F32(co2), yd.md, yd.num,
                                  yd.fold, yd.exp)


def scenario_year_plain(state: ModelState, corr: Corrections, co2,
                        yd: YearData):
    return core.run_year_scenario(state, yd.sfx, corr, F32(co2), yd.md,
                                  yd.num, yd.fold, yd.exp)


# ---------------------------------------------------------------------------
# kernel binding (csrc/year_kernel.cu, extern "C")
# ---------------------------------------------------------------------------
_PARAM_NAMES = ("sig", "rho_air", "ct_sens", "da_ice", "a_no_ice", "a_cloud",
                "Tl_ice1", "Tl_ice2", "To_ice1", "To_ice2", "co_turb", "ce",
                "cq_latent", "cq_rain", "r_qviwv", "c_effmix")
_PTR_NAMES = ("tclim", "qclim", "swet", "u", "v", "mld", "mld_prev", "cld",
              "sw_solar", "z_topo", "glacier", "wz_air", "z_ocean", "toclim",
              "zd", "zam", "mer", "wz", "pcomp", "tf", "tof", "qf", "outs",
              "asum", "monthly", "mon", "mon_w", "co2_years", "ppack",
              "state_in", "state_out", "cf", "st_wz", "st_rows", "st_n")
_INT_NAMES = ("Y", "X", "T", "nsub", "bt", "bb", "ktc", "kbc", "M", "n_years",
              "nmon", "corr_step", "corr_shared", "n_pack", "quirk")
# the strict transport's scalars: kappa, kappa * dt_crcl, and the
# meridional coefficients of diffusion and advection
_STRICT_NAMES = ("st_kappa", "st_kdt", "st_ccy_d", "st_ccy_a")


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_float) for n in _PARAM_NAMES]
                + [("p_emi", ctypes.c_float * 10)]
                + [(n, ctypes.c_float) for n in
                   ("cap_ocean", "cap_land", "cap_air", "dt", "co2")]
                + [("flags", ctypes.c_int)])


class _Args(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_NAMES]
                + [(n, ctypes.c_int) for n in _INT_NAMES]
                + [(n, ctypes.c_float) for n in _STRICT_NAMES])


class _Refined(ctypes.Structure):
    """The refined instantiation's arguments (csrc/year_kernel.cu
    RefinedArgs): the packed factors, each composite row's offset and rank
    in Rtot, the segment tables, (kt, kb, iters) each, the plan's form (an
    index of REFINED_FORMS), and the wide form's clusters a run
    (``refined_groups``) and halo slots, and the sequential strict form's
    rounds between the spread sub-cycle's exchanges."""
    _fields_ = ([(n, ctypes.c_void_p)
                 for n in ("pcu", "pcw", "comp_off", "comp_rank")]
                + [(n, ctypes.c_int) for n in ("rtot", "n_dseg", "n_aseg")]
                + [(n, ctypes.c_int * (3 * MAX_SEGS))
                   for n in ("dseg", "aseg")]
                + [("form", ctypes.c_int), ("groups", ctypes.c_int),
                   ("ghalo", ctypes.c_void_p), ("spread_k", ctypes.c_int)])


# the refined kernels' entry suffixes in the order the launchers number
# them (csrc/year_kernel.cu REFINED_TABLE, refined_pick)
REFINED_SUFFIXES = ("_refined", "_additive", "_refined_legacy",
                    "_additive_legacy", "_strict_refined", "_wide",
                    "_wide_legacy")
# the refined forms whose entries build in csrc/band_kernel.cu, a library
# of its own beside csrc/year_kernel.cu's (the two compile at once): the
# grids between 192x96 and 384x192; their launchers (greb_*_band) number
# the entries in the order of BAND_SUFFIXES (band_pick)
BAND_FORMS = ("additive_packed", "strict_additive")
BAND_SUFFIXES = ("_additive_packed", "_additive_packed_legacy",
                 "_strict_additive")
# the sequential strict form on several clusters a run (768x384), whose
# entries build in csrc/strict_wide_kernel.cu, a library of its own; its
# launchers (greb_*_strict_wide) run the one entry of STRICT_WIDE_SUFFIXES
STRICT_WIDE_SUFFIXES = ("_strict_wide",)


def refined_entry(kernel: str, plan, flags: int) -> str:
    """The entry function that the refined launcher of ``kernel`` (one of
    "fluxcorr_year", "scenario_year", "fluxcorr_years", "scenario_years")
    runs for ``plan`` under the flags word ``flags`` (csrc/year_kernel.cu
    refined_pick): the fold's forms modern at word 0, legacy at any other
    word with the fold, the sequential one on several clusters a run
    (``refined_groups`` above 1) in the wide form; the strict forms for the
    strict transport or none, the sequential one on several clusters in
    its wide form.  Raises ValueError for a word that no refined kernel
    runs in the plan's form."""
    bit = lambda name: bool(flags >> FLAGS.index(name) & 1)
    strict, off = bit("strict_transport"), bit("circulation_off")
    vapor = bit("vapor_circulation_off") or bit("vapor_diffusion_only")
    form = refined_form(plan)
    strict_form = isinstance(plan, StrictPlan)
    if (flags >> len(FLAGS) or (strict and off) or (vapor and not strict)
            or strict_form != (strict or off)):
        raise ValueError(f"{kernel}: no refined kernel runs flags "
                         f"{flags:#x} in the {form} form")
    if strict_form:
        suffix = "_strict_refined" if form == "strict" else "_strict_additive"
        if form == "strict" and refined_groups(plan) > 1:
            suffix = "_strict_wide"
    elif refined_groups(plan) > 1:
        suffix = "_wide"
    else:
        suffix = dict(sequential="_refined").get(form, "_" + form)
    return kernel + suffix + ("_legacy" if flags and not strict_form else "")


def kernel_entry(kernel: str, plan, flags: int) -> str:
    """The entry function that the refined launcher of ``kernel`` picks for
    ``plan`` under the flags word ``flags``, asked of the built library
    (csrc/year_kernel.cu refined_pick, csrc/band_kernel.cu band_pick for
    BAND_FORMS, csrc/strict_wide_kernel.cu for ``is_strict_wide``), which
    ``refined_entry`` mirrors.  Raises ValueError where the launcher runs
    none."""
    g = _refined_struct(plan)
    if refined_form(plan) in BAND_FORMS:
        got = _band_lib().greb_band_pick(flags, g.form, g.groups)
        suffixes = BAND_SUFFIXES
    elif is_strict_wide(plan):
        got = _strict_wide_lib().greb_strict_wide_pick(flags, g.form,
                                                       g.groups)
        suffixes = STRICT_WIDE_SUFFIXES
    else:
        got = _refined_lib().greb_refined_pick(flags, g.form, g.groups)
        suffixes = REFINED_SUFFIXES
    if got < 0:
        raise ValueError(f"{kernel}: the launcher runs no kernel for flags "
                         f"{flags:#x} in the {refined_form(plan)} form")
    return kernel + suffixes[got]


def refined_launcher(fn_name: str, plan) -> str:
    """The launcher of the refined instantiation of ``fn_name`` (a
    launcher of the cluster body, e.g. "greb_fluxcorr_year") for
    ``plan``: csrc/band_kernel.cu's for BAND_FORMS,
    csrc/strict_wide_kernel.cu's for the strict form on several clusters
    (``is_strict_wide``), else csrc/year_kernel.cu's."""
    if refined_form(plan) in BAND_FORMS:
        return fn_name + "_band"
    return fn_name + ("_strict_wide" if is_strict_wide(plan) else "_refined")


def is_strict_wide(plan) -> bool:
    """Whether ``plan`` runs in the sequential strict form on several
    clusters a run (``*_strict_wide``, csrc/strict_wide_kernel.cu)."""
    return (isinstance(plan, StrictPlan) and plan.seq_zonal
            and is_refined(plan) and refined_groups(plan) > 1)


def refined_form(plan) -> str:
    """The form of the refined instantiation that runs ``plan`` (one of
    REFINED_FORMS)."""
    if isinstance(plan, StrictPlan):
        return "strict" if plan.seq_zonal else "strict_additive"
    if plan.seq_zonal:
        return "sequential"
    return "additive_packed" if plan.comp_mode == "packed" else "additive"


def _refined_struct(plan, **ptrs) -> _Refined:
    """``_Refined`` of ``plan``'s segment tables, form and clusters a run
    (``refined_groups``; the sequential strict form's ``spread_rounds``),
    with ``ptrs``."""
    if isinstance(plan, StrictPlan):
        if refined_form(plan) != "strict":
            return _Refined(form=REFINED_FORMS.index("strict_additive"),
                            groups=1, **ptrs)
        groups = refined_groups(plan)
        return _Refined(form=REFINED_FORMS.index("strict"), groups=groups,
                        spread_k=spread_rounds(plan, groups=groups), **ptrs)
    g = _Refined(n_dseg=len(plan.diff_segs), n_aseg=len(plan.adv_segs),
                 form=REFINED_FORMS.index(refined_form(plan)),
                 groups=refined_groups(plan), **ptrs)
    for name, segs in (("dseg", plan.diff_segs), ("aseg", plan.adv_segs)):
        flat = [int(v) for seg in segs for v in seg]
        getattr(g, name)[:len(flat)] = flat
    return g


class _PackCols(ctypes.Structure):
    """Columns of the member pack holding each kernel parameter
    (csrc/year_kernel.cu PackCols)."""
    _fields_ = [(n, ctypes.c_int) for n in
                _PARAM_NAMES + ("p_emi", "cap_ocean", "cap_land", "cap_air")]


def _lib():
    from . import build
    lib = build.load("year_kernel")
    for fn in (lib.greb_fluxcorr_year, lib.greb_scenario_year):
        fn.argtypes = [_Args, _Params, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.greb_fluxcorr_years, lib.greb_scenario_years):
        fn.argtypes = [_Args, _Params, _PackCols, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_cluster_layout.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.greb_cluster_layout.restype = ctypes.c_longlong
    lib.greb_cluster_capacity.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.greb_cluster_capacity.restype = ctypes.c_int
    lib.greb_cluster_threads.argtypes = [ctypes.c_int] * 3
    lib.greb_cluster_threads.restype = ctypes.c_int
    lib.greb_error_string.argtypes = [ctypes.c_int]
    lib.greb_error_string.restype = ctypes.c_char_p
    return lib


def _refined_lib():
    """csrc/refined_kernel.cu's library (the refined instantiation's
    entries, ``refined_launcher``), built on first use."""
    from . import build
    lib = build.load("refined_kernel")
    for fn in (lib.greb_fluxcorr_year_refined,
               lib.greb_scenario_year_refined):
        fn.argtypes = [_Args, _Params, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.greb_fluxcorr_years_refined,
               lib.greb_scenario_years_refined):
        fn.argtypes = [_Args, _Params, _PackCols, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_refined_layout.argtypes = [ctypes.c_int] * 5 + [
        _Refined, ctypes.POINTER(ctypes.c_longlong)]
    lib.greb_refined_layout.restype = ctypes.c_longlong
    lib.greb_refined_capacity.argtypes = [ctypes.c_int] * 6 + [
        _Refined, ctypes.POINTER(ctypes.c_int)]
    lib.greb_refined_capacity.restype = ctypes.c_int
    lib.greb_refined_pick.argtypes = [ctypes.c_int] * 3
    lib.greb_refined_pick.restype = ctypes.c_int
    return lib


def _band_lib():
    """csrc/band_kernel.cu's library (BAND_FORMS), built on first use."""
    from . import build
    lib = build.load("band_kernel")
    for fn in (lib.greb_fluxcorr_year_band, lib.greb_scenario_year_band):
        fn.argtypes = [_Args, _Params, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.greb_fluxcorr_years_band, lib.greb_scenario_years_band):
        fn.argtypes = [_Args, _Params, _PackCols, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_band_capacity.argtypes = [ctypes.c_int] * 6 + [
        _Refined, ctypes.POINTER(ctypes.c_int)]
    lib.greb_band_capacity.restype = ctypes.c_int
    lib.greb_band_pick.argtypes = [ctypes.c_int] * 3
    lib.greb_band_pick.restype = ctypes.c_int
    return lib


def _strict_wide_lib():
    """csrc/strict_wide_kernel.cu's library (``is_strict_wide``), built on
    first use."""
    from . import build
    lib = build.load("strict_wide_kernel")
    for fn in (lib.greb_fluxcorr_year_strict_wide,
               lib.greb_scenario_year_strict_wide):
        fn.argtypes = [_Args, _Params, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.greb_fluxcorr_years_strict_wide,
               lib.greb_scenario_years_strict_wide):
        fn.argtypes = [_Args, _Params, _PackCols, _Refined, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_strict_wide_capacity.argtypes = [ctypes.c_int] * 4 + [
        _Refined, ctypes.POINTER(ctypes.c_int)]
    lib.greb_strict_wide_capacity.restype = ctypes.c_int
    lib.greb_strict_wide_pick.argtypes = [ctypes.c_int] * 3
    lib.greb_strict_wide_pick.restype = ctypes.c_int
    return lib


def _members_lib():
    """csrc/members_kernel.cu's library (the member kernels' matmul
    circulation, ops/cuda/multiyear.py), built on first use."""
    from . import build
    lib = build.load("members_kernel")
    for fn in (lib.greb_fluxcorr_years_mxu, lib.greb_scenario_years_mxu):
        fn.argtypes = [_Args, _Params, _PackCols] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.greb_members_layout.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.greb_members_layout.restype = ctypes.c_longlong
    lib.greb_members_capacity.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.greb_members_capacity.restype = ctypes.c_int
    lib.greb_members_threads.argtypes = [ctypes.c_int] * 3
    lib.greb_members_threads.restype = ctypes.c_int
    lib.greb_members_pick.argtypes = [ctypes.c_int] * 2
    lib.greb_members_pick.restype = ctypes.c_int
    return lib


def kernel_cluster_layout(plan, blocks: int, kind: str):
    """The kernel's own reckoning of a cluster block (csrc/year_kernel.cu
    ``greb_cluster_layout``, built on first use): ({part: bytes}, threads),
    for holding against ``cluster_layout`` (a ``StrictPlan``: the strict
    instantiation's layout; a fold of the refined instantiation: its
    layout, ``greb_refined_layout``, against ``refined_layout``, on
    ``refined_groups`` clusters of ``blocks``)."""
    lib = _lib()
    if is_refined(plan):
        names = (STRICT_REFINED_PARTS if isinstance(plan, StrictPlan)
                 else REFINED_PARTS)
        parts = (ctypes.c_longlong * len(names))()
        g = _refined_struct(plan)
        total = _refined_lib().greb_refined_layout(plan.ydim, plan.xdim, plan.comp_kt,
                                        plan.comp_kb, blocks, g, parts)
        if total <= 0:
            raise ValueError(f"the kernel has no refined layout for {blocks} "
                             f"blocks")
        return (dict(zip(names, parts)),
                lib.greb_cluster_threads(plan.ydim, plan.xdim,
                                         blocks * g.groups))
    parts = (ctypes.c_longlong * len(CLUSTER_PARTS))()
    total = lib.greb_cluster_layout(plan.ydim, plan.xdim, plan.comp_kt,
                                    plan.comp_kb, blocks, KINDS.index(kind),
                                    isinstance(plan, StrictPlan), parts)
    if total <= 0:
        raise ValueError(f"the kernel has no layout for {blocks} blocks")
    return (dict(zip(CLUSTER_PARTS, parts)),
            lib.greb_cluster_threads(plan.ydim, plan.xdim, blocks))


def cluster_capacity(plan, blocks: int, kind: str) -> int:
    """How many clusters of ``blocks`` blocks of the kernel of ``kind`` the
    card runs at once (``cudaOccupancyMaxActiveClusters``; a
    ``StrictPlan``: of the strict instantiation; a fold of the refined
    one: of that one, the wide form's for a plan it runs); members beyond
    it run in waves (the wide form's never: ``check_resident``).  Raises
    where the card runs none."""
    lib = _lib()
    n = ctypes.c_int()
    if is_strict_wide(plan):
        err = _strict_wide_lib().greb_strict_wide_capacity(
            plan.ydim, plan.xdim, blocks, KINDS.index(kind),
            _refined_struct(plan), ctypes.byref(n))
    elif is_refined(plan):
        capacity = (_band_lib().greb_band_capacity
                    if refined_form(plan) in BAND_FORMS
                    else _refined_lib().greb_refined_capacity)
        err = capacity(plan.ydim, plan.xdim, plan.comp_kt, plan.comp_kb,
                       blocks, KINDS.index(kind), _refined_struct(plan),
                       ctypes.byref(n))
    if is_refined(plan):
        if err:
            raise RuntimeError(f"refined cluster capacity at {blocks} "
                               f"blocks: {lib.greb_error_string(err).decode()}")
        return n.value
    err = lib.greb_cluster_capacity(plan.ydim, plan.xdim, plan.comp_kt,
                                    plan.comp_kb, blocks, KINDS.index(kind),
                                    isinstance(plan, StrictPlan),
                                    ctypes.byref(n))
    if err:
        raise RuntimeError(f"cluster capacity, {kind} at {blocks} blocks: "
                           f"{lib.greb_error_string(err).decode()}")
    return n.value


def _params(yd: YearData, co2) -> _Params:
    p, d = yd.md.params, yd.md.derived
    out = _Params(**{n: float(getattr(p, n)) for n in _PARAM_NAMES})
    out.p_emi[:] = [float(v) for v in np.asarray(p.p_emi, F32)]
    out.cap_ocean, out.cap_land = float(d.cap_ocean), float(d.cap_land)
    out.cap_air, out.dt, out.co2 = float(d.cap_air), float(yd.num.dt), float(F32(co2))
    out.flags = yd.flags
    return out


def _strict_args(yd: YearData, dev: torch.device):
    """The strict transport's tensors on ``dev`` (wz of Ta and q, the rows'
    dxlat**2, diffusion sub-step, polar and plain advection coefficients,
    their sub-cycle counts, ``stencils.sub_cycles``), made once per run, and
    its scalars, computed as the plain version computes them."""
    md, key = yd.md, ("strict", str(dev))
    st, sf, kappa = md.st, md.sf, md.params.kappa
    if key not in yd.cache:
        rows = torch.stack([sf.dxlat2, sf.diff_dtdff2, sf.adv_ccx2,
                            sf.ccx_adv]).reshape(4, -1)
        yd.cache[key] = dict(
            st_wz=(torch.stack([md.derived.wz_air, md.derived.wz_vapor]
                               ).to(dev).contiguous(), None),
            st_rows=(rows.to(dev).contiguous(), None),
            st_n=(torch.stack(stc.sub_cycles(st, sf)).to(dev).contiguous(),
                  None, torch.int32))
    scalars = dict(st_kappa=float(F32(kappa)),
                   st_kdt=float(F32(kappa) * F32(st.dt_crcl)),
                   st_ccy_d=float(stc.diffusion_ccy(st, kappa)),
                   st_ccy_a=float(stc.advection_ccy(st)),
                   quirk=int(st.quirk_jp2))
    return yd.cache[key], scalars


def _args(yd: YearData, state5: torch.Tensor, ints=None, **extra) -> _Args:
    """Pointers of every tensor the kernel reads or writes, after checking
    device, dtype, shape and contiguity.  ``extra`` maps a field to
    ``(tensor, shape)`` or ``(tensor, shape, dtype)`` (float32 unless
    given; shape None skips the shape check); ``ints`` overrides the
    single-run sizes (M=1, one year, corrections step by step).  The fold's
    planes go in under the fold (the dense composites; packed ones go in
    ``_refined_args``), the strict stencils' constants under the strict
    transport, neither without transport.  The caller has checked the plan
    (``check_plan``)."""
    plan = yd.plan
    num, sfx, md = yd.num, yd.sfx, yd.md
    Y, X, T = plan.ydim, plan.xdim, num.nstep_yr
    K = plan.comp_kt + plan.comp_kb
    dev = state5.device
    t = dict(
        tclim=(sfx.tclim, (T, Y, X)), qclim=(sfx.qclim, (T, Y, X)),
        swet=(sfx.swet, (T, Y, X)), u=(sfx.u, (T, Y, X)),
        v=(sfx.v, (T, Y, X)), mld=(sfx.mld, (T, Y, X)),
        mld_prev=(sfx.mld_prev, (T, Y, X)), cld=(sfx.cld, (T, Y, X)),
        sw_solar=(sfx.sw_solar, (T, Y)),
        z_topo=(md.z_topo, (Y, X)), glacier=(md.glacier, (Y, X)),
        wz_air=(md.derived.wz_air, (Y, X)),
        z_ocean=(md.derived.z_ocean, (Y, X)),
        toclim=(md.derived.toclim, (Y, X)),
        state_in=(state5, (5, Y, X)))
    scalars = {}
    if yd.transport == "fold":
        const = yd.fold[1]
        t.update(zd=(const.zd, (7, 2, Y, X)), zam=(const.zam, (8, 2, Y, X)),
                 mer=(const.mer, (9, 2, Y, X)), wz=(const.wz, (2, Y, X)))
        if plan.comp_mode != "packed":
            t.update(pcomp=(const.pcomp, (2, K, X, X) if K else None))
    elif yd.transport == "strict":
        tensors, scalars = _strict_args(yd, dev)
        t.update(tensors)
    t.update(extra)
    ptrs = {}
    for name, (ten, shape, *dtype) in t.items():
        want = dtype[0] if dtype else torch.float32
        if ten.device != dev or ten.dtype != want:
            raise ValueError(f"{name}: want {want} on {dev}, got "
                             f"{ten.dtype} on {ten.device}")
        if shape is not None and tuple(ten.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(ten.shape)}")
        if not ten.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        ptrs[name] = ten.data_ptr()
    sizes = dict(Y=Y, X=X, T=T, nsub=num.nsub_crcl, bt=plan.bt, bb=plan.bb,
                 ktc=plan.comp_kt, kbc=plan.comp_kb, M=1, n_years=1,
                 nmon=len(num.jday_mon), corr_step=Y * X, corr_shared=0,
                 n_pack=0)
    sizes.update(scalars)
    sizes.update(ints or {})
    return _Args(**ptrs, **sizes)


def _refined_args(yd: YearData, dev: torch.device) -> _Refined:
    """The refined instantiation's arguments: the packed factors U_all
    (X, Rtot) and W_all (Rtot, X), each composite row's offset and rank
    (int32 on ``dev``, made once per run; none for dense composites, which
    go in ``_args``, nor for the strict form), the plan's segments and its
    form."""
    if yd.fold is None:
        return _refined_struct(yd.plan)
    plan, const = yd.fold
    if plan.comp_mode != "packed":
        return _refined_struct(plan)
    key = ("refined", str(dev))
    if key not in yd.cache:
        offs, ranks = packed_ranks(const)
        yd.cache[key] = tuple(torch.as_tensor(a, dtype=torch.int32,
                                              device=dev)
                              for a in (offs, ranks))
    offs, ranks = yd.cache[key]
    X, rtot, rows = plan.xdim, const.pmask.shape[1], const.pmask.shape[0]
    t = dict(pcu=(const.pcu, (X, rtot), torch.float32),
             pcw=(const.pcw, (rtot, X), torch.float32),
             comp_off=(offs, (rows,), torch.int32),
             comp_rank=(ranks, (rows,), torch.int32))
    for name, (ten, shape, dtype) in t.items():
        if ten.device != dev or ten.dtype != dtype \
                or tuple(ten.shape) != shape or not ten.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                             f"{dev}, got {ten.dtype} {tuple(ten.shape)} on "
                             f"{ten.device}")
    return _refined_struct(plan, rtot=rtot,
                           **{n: ten.data_ptr() for n, (ten, _, _) in
                              t.items()})


def wide_capacity(yd: YearData, kind: str) -> int:
    """``cluster_capacity`` of the wide kernel of ``kind`` on this card,
    asked once per run."""
    key = ("wide capacity", kind)
    if key not in yd.cache:
        yd.cache[key] = cluster_capacity(yd.plan, REFINED_CLUSTER_SIZES[0],
                                         kind)
    return yd.cache[key]


def _wide_args(g: _Refined, members: int, X: int, dev: torch.device):
    """The wide form's halo slots for a launch of ``members`` members into
    ``g``, (members, 2, groups - 1, 2, 2, HALO, X); returns the tensor,
    which must outlive the launch's enqueue."""
    ghalo = torch.empty((members, 2, g.groups - 1, 2, 2, HALO, X),
                        dtype=torch.float32, device=dev)
    g.ghalo = ghalo.data_ptr()
    return ghalo


def _launch_year(fn_name: str, yd: YearData, state5: torch.Tensor,
                 params: _Params, cluster: int, **extra) -> None:
    """Launch K1 or K2 (``fn_name``) on the instantiation of the plan: the
    refined one for a plan it runs (``is_refined``), the fold's forms with
    a global scratch for the step's coefficient planes (12, 2, Y, X); the
    wide form after ``check_resident`` with its halo slots."""
    dev = state5.device
    if not is_refined(yd.plan):
        _launch(fn_name, _args(yd, state5, **extra), params, dev,
                ctypes.c_int(cluster))
        return
    Y, X = state5.shape[1:]
    if yd.fold is not None:
        extra["cf"] = (torch.empty((12, 2, Y, X), dtype=torch.float32,
                                   device=dev), None)
    g = _refined_args(yd, dev)
    scratch = ()
    if g.groups > 1:
        kind = "fluxcorr" if fn_name == "greb_fluxcorr_year" else "scenario"
        check_resident(g.groups, wide_capacity(yd, kind))
        scratch = _wide_args(g, 1, X, dev)
    _launch(refined_launcher(fn_name, yd.plan), _args(yd, state5, **extra),
            params, dev, g, ctypes.c_int(cluster))
    del scratch     # held through the enqueue: g has only their pointers


def _launch(fn_name: str, args: _Args, params: _Params, dev: torch.device,
            *extra) -> None:
    lib = _lib()
    own = {"_refined": _refined_lib, "_band": _band_lib,
           "_strict_wide": _strict_wide_lib, "_mxu": _members_lib}
    fn = getattr(next((load() for end, load in own.items()
                       if fn_name.endswith(end)), lib), fn_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(args, params, *extra, stream)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.greb_error_string(err).decode()}")


def _check_device(state: ModelState) -> torch.device:
    dev = state.ts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"year kernels run on cuda (or plain on cpu), "
                         f"not {dev}")
    return dev


def offered_sizes(kind: str, plan=None) -> Tuple[int, ...]:
    """The ``cluster=`` sizes a kernel of ``kind`` launches with: its
    CLUSTER_SIZES, and 1 for the ONE_BLOCK_KINDS; for a ``plan`` of the
    refined instantiation REFINED_CLUSTER_SIZES."""
    if plan is not None and is_refined(plan):
        return REFINED_CLUSTER_SIZES
    return (1,) * (kind in ONE_BLOCK_KINDS) + CLUSTER_SIZES[kind]


def _check_cluster(cluster: int, kind: str, plan=None) -> None:
    if cluster not in offered_sizes(kind, plan):
        raise ValueError(f"cluster={cluster}: {kind} launches on clusters of "
                         f"{offered_sizes(kind, plan)} blocks")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def fluxcorr_year(state: ModelState, co2, yd: YearData,
                  cluster: int = DEFAULT_CLUSTER
                  ) -> Tuple[ModelState, Corrections]:
    """One spin-up year: (end state, correction tables).  On the card the
    year runs on a cluster of ``cluster`` blocks (in the refined
    instantiation for a fold it runs, ``is_refined``)."""
    _check_cluster(cluster, "fluxcorr", yd.plan)
    dev = _check_device(state)
    if dev.type == "cpu":
        return fluxcorr_year_plain(state, co2, yd)
    check_plan(yd.plan, "fluxcorr", yd.flags)
    params = _params(yd, co2)
    block_layout(yd.plan, cluster, "fluxcorr")
    T, (Y, X) = yd.num.nstep_yr, tuple(state.ts.shape)
    state5 = state.stack()
    state_out = torch.empty_like(state5)
    tabs = torch.empty((3, T, Y, X), dtype=torch.float32, device=dev)
    _launch_year("greb_fluxcorr_year", yd, state5, params, cluster,
                 state_out=(state_out, None), tf=(tabs[0], None),
                 tof=(tabs[1], None), qf=(tabs[2], None))
    fluxcorr_year.launches += 1
    return ModelState.unstack(state_out), Corrections(*tabs.unbind(0))


def scenario_year(state: ModelState, corr: Corrections, co2, yd: YearData,
                  cluster: int = DEFAULT_CLUSTER):
    """One scenario year: (end state, outs (T, 5, Y, X), asum (9, Y, X)).
    On the card the year runs on a cluster of ``cluster`` blocks (in the
    refined instantiation for a fold it runs, ``is_refined``)."""
    _check_cluster(cluster, "scenario", yd.plan)
    dev = _check_device(state)
    if dev.type == "cpu":
        return scenario_year_plain(state, corr, co2, yd)
    check_plan(yd.plan, "scenario", yd.flags)
    params = _params(yd, co2)
    block_layout(yd.plan, cluster, "scenario")
    T, (Y, X) = yd.num.nstep_yr, tuple(state.ts.shape)
    state5 = state.stack()
    state_out = torch.empty_like(state5)
    outs = torch.empty((T, core.N_OUT, Y, X), dtype=torch.float32, device=dev)
    asum = torch.empty((N_SUM, Y, X), dtype=torch.float32, device=dev)
    _launch_year("greb_scenario_year", yd, state5, params, cluster,
                 state_out=(state_out, None), tf=(corr.tf, (T, Y, X)),
                 tof=(corr.tof, (T, Y, X)), qf=(corr.qf, (T, Y, X)),
                 outs=(outs, None), asum=(asum, None))
    scenario_year.launches += 1
    return ModelState.unstack(state_out), outs, asum


fluxcorr_year.launches = 0
scenario_year.launches = 0
