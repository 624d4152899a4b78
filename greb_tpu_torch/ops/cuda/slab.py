"""The slab kernels (csrc/slab_kernel.cu): wrappers, and the runner of a
latitude-sharded year on the card.

A shard's step is ``slab_start``, ``nsub`` launches of ``slab_substep``
and ``slab_finish``, with the halo exchange (parallel/halo.py) after the
start and after each substep; under no transport (legacy log_exp <= 4) it
is ``slab_finish`` alone.  Under the fold the kernels take each shard's own
rows of the fold (ops/fastcirc2.py ``build_sharded``: its plan's bands,
composite rows and segments are its share of the global plan's) and run
the year kernels' device functions on them, in the form of the shard's
plan: additive splitting with dense composites (96x48, 192x96) or packed
ones (224x112 to 352x176), or sequential splitting (384x192, 768x384).
Under the strict transport they take each shard's rows of the strict
constants (``cut_strict``: each row's sub-cycle counts and coefficients,
wz with the neighbour shards' halo rows, cut once) and run the year
kernels' strict substep of the global grid's form (``slab_form``): the
cluster body's, the sequential one (384x192) or the additive one (224x112
to 352x176).  The legacy ``log_exp`` words reach ``slab_finish`` as the
flags word, as they reach the year kernels.  So a sharded year equals the
unsharded kernels' bit for bit.  ``SlabRunner`` keeps each shard's state,
transported buffers, coefficient scratch, corrections and outputs on its
card across the steps; where every shard the process holds is on one card
and the mesh spans one process, it captures a step (every shard's
launches and the halo copies) as one CUDA graph and replays it for every
step of every year (the step's index and the year's CO2 are read from
device memory).

What the slab kernels do not run raises before any launch
(``check_slab``): what the year kernels do not run, and the strict
transport and no transport where the year kernels run the sequential
strict form's wide variant (768x384: ``SLAB_ITEMS["strict_wide"]``).
The plain version of a slab step is the plain sharded runner over the
plain step with the halo hook (parallel/sharded.py); only the tests and
``chip_smoke.py`` hold the kernels against it.

Launch counts: ``start.launches``, ``substep.launches``,
``finish.launches`` (plain ints), one for each kernel launched, eager or
replayed from a captured step, and the same by entry in
``<wrapper>.entries`` (``SlabShard.entry``: "slab_start",
"slab_start_strict", "slab_substep<FORM>" of the fold's forms,
"slab_strict<FORM>" of the strict transport's, "slab_finish",
"slab_finish<legacy>"); ``SlabRunner.halo_copies`` counts
the exchange's copies within the process.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...config import Experiment, Numerics
from ...model import core
from .. import fastcirc2 as fc2
from .. import stencils as stc
from . import multiyear as my
from . import year_kernel as yk

F32 = np.float32
HALO = yk.HALO
# kernel kinds of slab_finish (csrc/year_kernel.cu enum Kind)
FINISH_KINDS = {"fluxcorr": 0, "scenario": 1}
# the forms of a slab substep, numbered as the kernel numbers them
# (RefinedArgs::form: the refined forms, then csrc/slab_kernel.cu
# S_STRICT_CLUSTER, the cluster body's strict substep); those of the
# strict transport
SLAB_FORMS = yk.REFINED_FORMS + ("strict_cluster",)
STRICT_FORMS = ("strict", "strict_additive", "strict_cluster")
# parts of a strict slab block's shared memory, in the kernel's order
# (csrc/slab_kernel.cu slab_strict_parts)
SLAB_STRICT_PARTS = ("transported", "wz", "winds", "subcycle", "rowc")
class _Slab(ctypes.Structure):
    """csrc/slab_kernel.cu SlabArgs."""
    _fields_ = [("xg", ctypes.c_void_p), ("halo_in", ctypes.c_void_p),
                ("edge_out", ctypes.c_void_p), ("step", ctypes.c_void_p),
                ("co2", ctypes.c_void_p), ("nblk", ctypes.c_int),
                ("row0", ctypes.c_int), ("Yg", ctypes.c_int)]


def _lib():
    from . import build
    lib = build.load("slab_kernel")
    lib.greb_slab_start.argtypes = [yk._Args, _Slab, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.greb_slab_substep.argtypes = [yk._Args, yk._Refined, _Slab,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.greb_slab_finish.argtypes = [yk._Args, yk._Params, yk._PackCols,
                                     _Slab, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.greb_slab_start, lib.greb_slab_substep,
               lib.greb_slab_finish):
        fn.restype = ctypes.c_int
    lib.greb_slab_layout.argtypes = [ctypes.c_int] * 5 + [
        yk._Refined, ctypes.POINTER(ctypes.c_longlong)]
    lib.greb_slab_layout.restype = ctypes.c_longlong
    lib.greb_slab_threads.argtypes = [ctypes.c_int] * 2
    lib.greb_slab_threads.restype = ctypes.c_int
    lib.greb_slab_error_string.argtypes = [ctypes.c_int]
    lib.greb_slab_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# what the slab kernels run, checked before any launch
# ---------------------------------------------------------------------------
def global_plan(splan: Optional[fc2.ShardPlan], exp: Experiment,
                num: Numerics, seq_zonal: bool):
    """The global plan of a sharded run: the fold's (``splan.plan``) where
    the fold moves Ta and q (``core.transport``), else the ``StrictPlan``
    of the grid (``seq_zonal``: an extension-mode grid's strict stencils)
    under the strict transport or none."""
    if core.transport(exp, splan is not None) == "fold":
        return splan.plan
    return yk.StrictPlan(num.ydim, num.xdim, seq_zonal=seq_zonal)


# where what the slab kernels do not run is queued
SLAB_ITEMS = dict(
    # the strict transport and the no-transport words where the year
    # kernels run the strict form on several clusters (768x384): a shard's
    # strict block there (a cluster holding 96 rows, ~258 KB a block) does
    # not fit
    strict_wide="ROADMAP Queue 1 item 3j")


def check_slab(plan, exp: Experiment, kind: str = "fluxcorr") -> None:
    """Raise NotImplementedError for what the slab kernels do not run, before
    any launch: what ``year_kernel.check_plan`` refuses for the global plan
    ``plan`` (``global_plan``) under ``exp``'s flags word, since a shard
    runs the year kernels' form of the grid (a fold no refined layout
    holds: ``REFINED_ITEMS["layout"]``), and the strict transport and no
    transport where the year kernels run the sequential strict form on
    several clusters (768x384, ``year_kernel.refined_groups``:
    ``SLAB_ITEMS["strict_wide"]``)."""
    transport = core.transport(exp, not isinstance(plan, yk.StrictPlan))
    flags = yk.experiment_flags(exp, transport == "strict")
    yk.check_plan(plan, kind, flags)
    if (isinstance(plan, yk.StrictPlan) and yk.is_refined(plan)
            and plan.seq_zonal and yk.refined_groups(plan) > 1):
        raise NotImplementedError(
            f"{kind}: the strict transport or no transport (flags "
            f"{flags:#x}) at {plan.xdim}x{plan.ydim} on a CUDA mesh: the "
            f"year kernels run it on {yk.refined_groups(plan)} clusters, "
            f"and a shard's strict block does not fit "
            f"({SLAB_ITEMS['strict_wide']})")


def slab_form(plan) -> str:
    """The form (one of SLAB_FORMS) of the slab substep: for a shard's fold
    plan (``fastcirc2.cut_plan``) its splitting and composites; for the
    global ``StrictPlan`` the year kernels' strict form of the grid
    (``year_kernel.refined_form`` where the refined instantiation runs it,
    else the cluster body's, "strict_cluster")."""
    if isinstance(plan, yk.StrictPlan):
        return yk.refined_form(plan) if yk.is_refined(plan) else \
            "strict_cluster"
    if plan.seq_zonal:
        return "sequential"
    return "additive_packed" if plan.comp_mode == "packed" else "additive"


def cut_strict(plan: yk.StrictPlan, lo: int, hi: int) -> yk.StrictPlan:
    """Rows [lo, hi) of the global strict plan, as ``fastcirc2.cut_plan``
    cuts the fold: the shard's rows, the grid's columns and splitting, and
    each row's sub-cycle counts (where the global plan knows them) the
    global rows'."""
    counts = plan.sub_cycles
    return dataclasses.replace(
        plan, ydim=hi - lo,
        sub_cycles=None if counts is None else
        tuple(tuple(c[lo:hi]) for c in counts))


def wz_halo(md: core.ModelData, lo: int, hi: int,
            device=None) -> torch.Tensor:
    """wz of Ta and q on the global rows [lo - HALO, hi + HALO), zero past
    the poles, (2, hi - lo + 2 HALO, X): a shard's wz for the strict
    transport with its neighbour shards' halo rows (static: cut once from
    the global ``md``, never exchanged)."""
    wz = torch.stack([md.derived.wz_air, md.derived.wz_vapor])
    return torch.nn.functional.pad(wz, (0, 0, HALO, HALO))[
        :, lo:hi + 2 * HALO].contiguous().to(device)


def slab_layout(plan, blocks: int,
                form: Optional[str] = None) -> Dict[str, int]:
    """Bytes of each part of a slab substep block's shared memory for a
    shard's ``plan`` on ``blocks`` blocks.  The fold (``form`` None: the
    plan's, ``slab_form``): the refined layout's parts
    (``year_kernel.refined_layout``, the same reckoning,
    csrc/slab_kernel.cu ``slab_parts``) with the transported buffers in
    global memory.  The strict forms (``form`` in STRICT_FORMS, the global
    plan's; ``plan`` the shard's ``StrictPlan``, csrc/slab_kernel.cu
    ``slab_strict_parts``, SLAB_STRICT_PARTS): wz of both fields with HALO
    rows each side, the step's winds (the cluster body's form), the
    sub-cycles' scratch (four (2, R, X) planes in the cluster body's form,
    two in the refined ones) and the rows' constants (6 words a row, 8 in
    the additive form).  Raises ValueError where the blocks do not split the
    rows into blocks of at least HALO rows, the row length is not a
    multiple of COMP_BLOCK (the fold; 4 the strict forms), a segment table
    exceeds MAX_SEGS or a block needs more than MAX_SMEM_BYTES."""
    Y, X = plan.ydim, plan.xdim
    if blocks < 1 or Y % blocks or Y // blocks < HALO:
        raise ValueError(f"{blocks} slab blocks: {Y} rows do not split into "
                         f"blocks of at least {HALO} rows")
    R = Y // blocks
    form = form or slab_form(plan)
    if form in STRICT_FORMS:
        if X % 4:
            raise ValueError(f"strict slab kernels: {X} columns, not a "
                             f"multiple of 4")
        cl = form == "strict_cluster"
        words = dict(transported=0, wz=2 * (R + 2 * HALO) * X,
                     winds=2 * R * X if cl else 0,
                     subcycle=(4 if cl else 2) * 2 * R * X,
                     rowc=-(-(8 if form == "strict_additive" else 6) * R
                            // 4) * 4)
        parts = {p: 4 * words[p] for p in SLAB_STRICT_PARTS}
    else:
        if X % fc2.COMP_BLOCK:
            raise ValueError(f"slab kernels: {X} columns, not a multiple of "
                             f"{fc2.COMP_BLOCK}")
        if max(len(plan.diff_segs), len(plan.adv_segs)) > yk.MAX_SEGS:
            raise ValueError(f"more than {yk.MAX_SEGS} segments: {plan}")
        ktc, kbc = plan.comp_kt, plan.comp_kb
        (dkt, dkb), (akt, akb) = yk._reach(plan.diff_segs), yk._reach(
            plan.adv_segs)

        def most(a0, a1, b0, b1):
            return max(yk._rows_in(b * R, (b + 1) * R, a0, a1)
                       + yk._rows_in(b * R, (b + 1) * R, b0, b1)
                       for b in range(blocks))

        kmax = most(0, ktc, Y - kbc, Y)
        rows = max(kmax, most(ktc, ktc + dkt, Y - kbc - dkb, Y - kbc),
                   most(0, akt, Y - akb, Y))
        words = dict(transported=0, wz=2 * R * X, xa=2 * R * X,
                     scratch=2 * 2 * rows * X,
                     comp_index=-(-(2 * kmax + 1) // 4) * 4)
        parts = {p: 4 * words[p] for p in yk.REFINED_PARTS}
    if sum(parts.values()) > yk.MAX_SMEM_BYTES:
        raise ValueError(f"a slab block of {R} rows of {X} needs "
                         f"{sum(parts.values())} B of shared memory, over "
                         f"{yk.MAX_SMEM_BYTES} B")
    return parts


def slab_blocks(plan, form: Optional[str] = None) -> int:
    """The blocks a member's shard rows split into: blocks of the fewest
    rows (at least HALO) whose layout fits (``slab_layout`` of ``form``;
    "none", no transport: any split, the finish has no layout)."""
    Y = plan.ydim
    for R in range(HALO, Y + 1):
        if Y % R:
            continue
        if form == "none":
            return Y // R
        try:
            slab_layout(plan, Y // R, form)
            return Y // R
        except ValueError:
            continue
    raise ValueError(f"no slab layout holds a shard of {Y} rows of "
                     f"{plan.xdim}")


def kernel_slab_layout(plan, blocks: int,
                       form: Optional[str] = None) -> Dict[str, int]:
    """The kernel's own reckoning of ``slab_layout`` (greb_slab_layout),
    for holding against it."""
    lib = _lib()
    form = form or slab_form(plan)
    names = SLAB_STRICT_PARTS if form in STRICT_FORMS else yk.REFINED_PARTS
    parts = (ctypes.c_longlong * len(names))()
    ktc, kbc = ((0, 0) if isinstance(plan, yk.StrictPlan)
                else (plan.comp_kt, plan.comp_kb))
    total = lib.greb_slab_layout(plan.ydim, plan.xdim, ktc, kbc, blocks,
                                 _refined(plan, form), parts)
    if total <= 0:
        raise ValueError(f"the kernel has no slab layout for {blocks} blocks")
    return dict(zip(names, parts))


def _refined(plan, form: str, **ptrs) -> yk._Refined:
    """A shard's RefinedArgs: the substep's form, one run a cluster (no wide
    form) and, for a fold, its segment tables."""
    g = yk._Refined(form=SLAB_FORMS.index(form), groups=1, **ptrs)
    if form in STRICT_FORMS:
        return g
    g.n_dseg, g.n_aseg = len(plan.diff_segs), len(plan.adv_segs)
    for name, segs in (("dseg", plan.diff_segs), ("aseg", plan.adv_segs)):
        flat = [int(v) for seg in segs for v in seg]
        getattr(g, name)[:len(flat)] = flat
    return g


# ---------------------------------------------------------------------------
# one shard's buffers and its launches
# ---------------------------------------------------------------------------
@dataclass
class SlabShard:
    """One local shard's data and buffers on its card: ``yd`` its rows'
    model, forcing and fold (None under the strict transport or none: its
    plan the shard's ``StrictPlan``, ``cut_strict``), ``members`` its
    members (a member pack ``ppack``, else the base params), ``form`` the
    substep's (SLAB_FORMS; "none" under no transport), ``row0`` its first
    row of the global grid's ``ydim``, ``wz`` its strict wz with halo rows
    (``wz_halo``), the state (5, M, Y, X), the transported buffers, edge
    and halo rows, the coefficient scratch (the fold), the correction
    tables (K1's out, K2's in), K2's outputs and sums, and the launch
    arguments."""
    yd: yk.YearData
    ppack: Optional[torch.Tensor]
    members: int
    step: torch.Tensor
    co2: torch.Tensor
    form: str
    row0: int = 0
    ydim: int = 0
    wz: Optional[torch.Tensor] = None
    bufs: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __post_init__(self):
        plan = self.yd.plan
        Y, X, T = plan.ydim, plan.xdim, self.yd.num.nstep_yr
        M, dev = self.members, self.step.device
        self.nblk = slab_blocks(plan, self.form)
        R = Y // self.nblk
        f32 = dict(dtype=torch.float32, device=dev)
        b = self.bufs
        b["state"] = torch.zeros((5, M, Y, X), **f32)
        b["xg"] = torch.zeros((M, self.nblk, 2, 2, R + 2 * HALO, X), **f32)
        b["halo_in"] = torch.zeros((2, M, 2, HALO, X), **f32)
        b["edge_out"] = torch.zeros((2, M, 2, HALO, X), **f32)
        b["corr"] = torch.zeros((3, M, T, Y, X), **f32)
        b["outs"] = torch.empty((M, T, core.N_OUT, Y, X), **f32)
        b["asum"] = torch.empty((M, yk.N_SUM, Y, X), **f32)
        extra = dict(state_in=(b["state"], None),
                     state_out=(b["state"], None),
                     tf=(b["corr"][0], None), tof=(b["corr"][1], None),
                     qf=(b["corr"][2], None), outs=(b["outs"], None),
                     asum=(b["asum"], None))
        if self.yd.transport == "fold":
            b["cf"] = torch.empty((M, 12, 2, Y, X), **f32)
            extra["cf"] = (b["cf"], None)
        elif self.yd.transport == "strict":
            extra["st_wz"] = (self.wz, (2, Y + 2 * HALO, X))
        ints = dict(M=M, corr_step=Y * X)
        if self.ppack is not None:
            extra["ppack"] = (self.ppack, (M, 1, my.N_PPACK))
            ints["n_pack"] = my.N_PPACK
        self.args = yk._args(self.yd, b["state"], ints=ints, **extra)
        ptrs = {}
        if self.yd.transport == "fold" and plan.comp_mode == "packed":
            const = self.yd.fold[1]
            offs, ranks = yk.packed_ranks(const)
            self._index = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                           for a in (offs, ranks)]
            ptrs = dict(pcu=const.pcu.data_ptr(), pcw=const.pcw.data_ptr(),
                        comp_off=self._index[0].data_ptr(),
                        comp_rank=self._index[1].data_ptr(),
                        rtot=int(const.pcu.shape[1]))
        if self.form != "none":
            self.refined = _refined(plan, self.form, **ptrs)
        self.slab = _Slab(xg=b["xg"].data_ptr(),
                          halo_in=b["halo_in"].data_ptr(),
                          edge_out=b["edge_out"].data_ptr(),
                          step=self.step.data_ptr(),
                          co2=self.co2.data_ptr(), nblk=self.nblk,
                          row0=self.row0, Yg=self.ydim)
        self.params = yk._params(self.yd, 0.0)
        self.nxt = 2 * (R + 2 * HALO) * X   # buffer 1's offset
        # the step start's moving fields: 0 the fold's start
        self.nf = (0 if self.form not in STRICT_FORMS
                   else 1 if self.yd.exp.vapor_circulation_off else 2)

    @property
    def device(self) -> torch.device:
        return self.step.device

    def entry(self, wrapper: str) -> str:
        """The kernel entry that ``wrapper`` ("start", "substep",
        "finish") launches on this shard: the fold's step start or the
        strict one, the substep of the shard's form, the finish modern
        (flags 0) or with the switches."""
        if wrapper == "start":
            return "slab_start_strict" if self.nf else "slab_start"
        if wrapper == "substep":
            kernel = "slab_strict" if self.form in STRICT_FORMS else \
                "slab_substep"
            return f"{kernel}<{self.form}>"
        return "slab_finish<legacy>" if self.params.flags else "slab_finish"


def _count(wrapper, shard: SlabShard, n: int = 1) -> None:
    """``n`` launches of ``wrapper`` on ``shard``, by entry too."""
    wrapper.launches += n
    e = shard.entry(wrapper.__name__)
    wrapper.entries[e] = wrapper.entries.get(e, 0) + n


def _run(fn_name: str, shard: SlabShard, *args) -> None:
    lib = _lib()
    dev = shard.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.greb_slab_error_string(err).decode()}")


def start(shard: SlabShard, count: bool = True) -> None:
    """Launch slab_start (or, under the strict transport,
    slab_start_strict) on ``shard`` (``count``: a launch, not a
    capture)."""
    _run("greb_slab_start", shard, shard.args, shard.slab,
         ctypes.c_int(shard.nf))
    if count:
        _count(start, shard)


def substep(shard: SlabShard, cur: int, count: bool = True) -> None:
    """Launch slab_substep (the fold) or slab_strict on ``shard``, reading
    the buffer at ``cur``."""
    _run("greb_slab_substep", shard, shard.args, shard.refined, shard.slab,
         ctypes.c_int(cur), ctypes.c_int(shard.params.flags))
    if count:
        _count(substep, shard)


def finish(shard: SlabShard, kind: str, cur: int, count: bool = True) -> None:
    """Launch slab_finish of ``kind`` ("fluxcorr" or "scenario") on
    ``shard``, from the buffer at ``cur``."""
    _run("greb_slab_finish", shard, shard.args, shard.params,
         my._pack_cols(), shard.slab, ctypes.c_int(FINISH_KINDS[kind]),
         ctypes.c_int(shard.ppack is not None), ctypes.c_int(cur))
    if count:
        _count(finish, shard)


def reset_counts() -> None:
    """Every slab launch count to 0."""
    for fn in (start, substep, finish):
        fn.launches, fn.entries = 0, {}


reset_counts()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
class SlabRunner:
    """Sharded years on the card for the local shards of ``mesh``
    (parallel/sharded.py ``Mesh``) under ``splan`` (``ShardPlan``; None:
    no fold) and ``exp``'s word: the fold's, else the strict transport or
    none on the global ``StrictPlan`` ``plan`` (``global_plan``).  ``year``
    takes each shard's state, forcing, model data and fold and returns
    each shard's state and K1's corrections or K2's outputs and sums.
    ``graphs``: a step is captured as one CUDA graph where the mesh spans
    one process and one card (a graph holds no exchange across processes);
    else every launch and copy is eager."""

    def __init__(self, mesh, splan: Optional[fc2.ShardPlan], num: Numerics,
                 exp: Experiment, plan=None):
        self.mesh, self.splan, self.num, self.exp = mesh, splan, num, exp
        self.transport = core.transport(exp, splan is not None)
        self.plan = splan.plan if self.transport == "fold" else plan
        if not isinstance(self.plan, (fc2.FastPlan, yk.StrictPlan)):
            raise ValueError(f"the {self.transport} transport on a mesh: "
                             f"give the global StrictPlan (global_plan)")
        self.circ = self.transport != "none"
        devs = {mesh.devices[k] for k in mesh.local()}
        self.graphs = len(devs) == 1 and mesh.single_process()
        self.shards: Dict[Tuple[int, int], SlabShard] = {}
        self._inputs = None
        self._graph: Dict[str, torch.cuda.CUDAGraph] = {}
        self._counters = {str(d): (torch.zeros(1, dtype=torch.int32,
                                               device=d),
                                   torch.zeros(1, dtype=torch.float32,
                                               device=d)) for d in devs}
        self.halo_copies = 0

    def _year_data(self, k, sfx_s, md_s, fcconst) -> yk.YearData:
        """Shard k's YearData: its rows' fold, or its rows of the global
        strict plan (``cut_strict``, each row's sub-cycles its model
        data's)."""
        if self.transport == "fold":
            return yk.YearData(md=md_s[k].md, sfx=sfx_s[k],
                               fold=(self.splan.plans[k[1]], fcconst[k]),
                               num=self.num, exp=self.exp)
        yd = yk.YearData(md=md_s[k].md, sfx=sfx_s[k], fold=None,
                         num=self.num, exp=self.exp)
        R = self.num.ydim // self.mesh.n_y
        plan = cut_strict(self.plan, k[1] * R, (k[1] + 1) * R)
        if self.transport == "strict":
            md = md_s[k].md
            counts = tuple(tuple(int(n) for n in c.cpu())
                           for c in stc.sub_cycles(md.st, md.sf))
            if plan.sub_cycles not in (None, counts):
                raise ValueError(f"shard {k}: its model data's sub-cycles "
                                 f"{counts} are not the global plan's rows "
                                 f"{plan.sub_cycles}")
            plan = dataclasses.replace(plan, sub_cycles=counts)
        yd.cache[("plan", self.transport)] = plan
        return yd

    def _setup(self, sfx_s, md_s, fcconst) -> None:
        """Each local shard's SlabShard, made again (and its graphs
        captured again) where the inputs are other objects than the last
        call's."""
        key = (id(sfx_s), id(md_s), id(fcconst))
        if self._inputs == key:
            return
        self._inputs, self._graph = key, {}
        R = self.num.ydim // self.mesh.n_y
        for k in self.mesh.local():
            dev = self.mesh.devices[k]
            step, co2 = self._counters[str(dev)]
            yd = self._year_data(k, sfx_s, md_s, fcconst)
            form = ("none" if not self.circ else
                    slab_form(yd.plan if self.transport == "fold"
                              else self.plan))
            wz = md_s[k].wz_halo if self.transport == "strict" else None
            if self.transport == "strict" and wz is None:
                raise ValueError(f"shard {k}: no wz halo rows (shard_inputs "
                                 f"cuts them)")
            pp = md_s[k].ppack
            self.shards[k] = SlabShard(yd=yd, ppack=pp,
                                       members=1 if pp is None else
                                       pp.shape[0], step=step, co2=co2,
                                       form=form, row0=k[1] * R,
                                       ydim=self.num.ydim, wz=wz)

    def _exchange(self, count: bool) -> None:
        for e in range(self.mesh.n_ens):
            keys = [k for k in self.shards if k[0] == e]
            if not keys:
                continue
            n = self.mesh.exchange(e).edges(
                {k[1]: self.shards[k].bufs["edge_out"] for k in keys},
                {k[1]: self.shards[k].bufs["halo_in"] for k in keys})
            self.halo_copies += n * count

    def _nsub(self) -> int:
        """Substeps a step: none without transport."""
        return self.num.nsub_crcl if self.circ else 0

    def _step(self, kind: str, count: bool = True) -> None:
        """One step of every local shard: start, exchange, nsub substeps
        each followed by an exchange (none of them without transport),
        finish, then the step index on."""
        nsub = self._nsub()
        if self.circ:
            for s in self.shards.values():
                start(s, count)
            self._exchange(count)
        for i in range(nsub):   # buffer i % 2 -> the other
            for s in self.shards.values():
                substep(s, i % 2 * s.nxt, count)
            self._exchange(count)
        for s in self.shards.values():
            finish(s, kind, nsub % 2 * s.nxt, count)
        for step, _ in self._counters.values():
            step.add_(1)

    def _replay(self, kind: str) -> None:
        if kind not in self._graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, capture_error_mode="relaxed"):
                self._step(kind, count=False)
            self._graph[kind] = (g, self.halo_copies)
        g, _ = self._graph[kind]
        g.replay()
        for s in self.shards.values():
            if self.circ:
                _count(start, s)
                _count(substep, s, self._nsub())
            _count(finish, s)
        self.halo_copies += self._copies_a_step()

    def _copies_a_step(self) -> int:
        if not self.circ:
            return 0
        per = sum((k[1] > 0) + (k[1] < self.mesh.n_y - 1)
                  for k in self.shards)
        return per * (self.num.nsub_crcl + 1)
    def year(self, kind: str, state_s, sfx_s, md_s, fcconst, co2,
             corr_s=None):
        """One year of ``kind`` ("fluxcorr" or "scenario") on every local
        shard.  ``state_s[k]``: shard k's (5, M, Y, X) state; ``md_s[k]``
        its model data and members' pack (parallel/sharded.py
        ``ShardModel``; no pack: one run, the base params); ``corr_s[k]``
        (scenario): its (3, M, T, Y, X) tables.  Returns {k: (state,
        corr (3, M, T, Y, X))} for "fluxcorr", {k: (state, outs
        (M, T, 5, Y, X), asum (M, 9, Y, X))} for "scenario"."""
        self._setup(sfx_s, md_s, fcconst)
        for k, s in self.shards.items():
            s.bufs["state"].copy_(state_s[k])
            if kind == "scenario":
                s.bufs["corr"].copy_(corr_s[k])
        for step, c in self._counters.values():
            step.zero_()
            c.fill_(float(F32(co2)))
        for _ in range(self.num.nstep_yr):
            if self.graphs:
                self._replay(kind)
            else:
                self._step(kind)
        out = {}
        for k, s in self.shards.items():
            b = s.bufs
            out[k] = ((b["state"].clone(), b["corr"].clone())
                      if kind == "fluxcorr" else
                      (b["state"].clone(), b["outs"].clone(),
                       b["asum"].clone()))
        return out


def slab_work(plan, num: Numerics, entry: str, scenario: bool = False,
              ranks: Optional[np.ndarray] = None,
              flags: int = 0) -> Tuple[int, int]:
    """(bytes, operations) one launch of ``entry`` ("slab_start",
    "slab_substep", "slab_finish") on one member of a shard of ``plan``
    must move and compute at least, counted as ``year_work`` counts a
    year's: each input read once and each output written once, the edge
    and halo rows (2 sides, 2 fields, HALO rows) included; ``scenario``: a
    scenario step's finish (outputs and annual sums); ``ranks``: a packed
    plan's composite ranks.  A shard's ``StrictPlan`` (``cut_strict``, its
    rows' sub-cycles): the strict transport under the flags word
    ``flags``, its start the moving fields alone (no operations), its
    substep ``year_kernel.strict_substep_ops`` of its rows with wz's halo
    rows, the winds and the rows' constants read once."""
    yx, X = plan.ydim * plan.xdim, plan.xdim
    edge = 2 * 2 * HALO * X
    strict = isinstance(plan, yk.StrictPlan)
    nf = 1 if flags >> yk.FLAGS.index("vapor_circulation_off") & 1 else 2
    if entry == "slab_start":
        if strict:
            return 4 * (2 * nf * yx + edge), 0
        words = 2 * yx + 17 * 2 * yx + 2 * yx + 2 * yx + 12 * 2 * yx + edge
        return 4 * words, 2 * yx * 21
    if entry == "slab_substep" and strict:
        words = (nf * yx + edge + nf * (plan.ydim + 2 * HALO) * X + 2 * yx
                 + 6 * plan.ydim + nf * yx + edge)
        return 4 * words, yk.strict_substep_ops(plan, flags)
    if entry == "slab_substep":
        kk = plan.comp_kt + plan.comp_kb
        if plan.comp_mode == "packed":
            comp_ops = 4 * X * int(np.sum(ranks)) + 2 * kk * X * 4
        elif plan.comp_mode == "dense":
            comp_ops = 2 * kk * X * (2 * X + 4)
        else:
            comp_ops = 0
        seg_ops = sum(2 * (kt + kb) * X * (it * yk.SEG_ITER_OPS
                                            + yk.SEG_EDGE_OPS)
                      for kt, kb, it in plan.diff_segs + plan.adv_segs)
        comp_words = (yk.composite_words(plan, ranks)
                      if plan.comp_mode != "none" else 0)
        words = (2 * yx + edge + (7 + 12 + 1) * 2 * yx + comp_words
                 + 2 * yx + edge)
        return 4 * words, 2 * yx * (2 * 13 + 2 + 9 + 4) + comp_ops + seg_ops
    if entry == "slab_finish":
        words = (5 * yx + 2 * yx + 8 * yx + plan.ydim + 5 * yx + 5 * yx
                 + 3 * yx + (5 * yx + yk.N_SUM * yx if scenario else 0))
        return 4 * words, yx * (125 + (9 if scenario else 0))
    raise ValueError(f"no slab entry {entry!r}")
