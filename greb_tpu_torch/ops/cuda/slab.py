"""The slab kernels (csrc/slab_kernel.cu): wrappers, and the runner of a
latitude-sharded year on the card.

A shard's step is ``slab_start``, ``nsub`` launches of ``slab_substep`` and
``slab_finish``, with the halo exchange (parallel/halo.py) after the start
and after each substep.  The kernels take each shard's own rows of the fold
(ops/fastcirc2.py ``build_sharded``: its plan's bands, composite rows and
segments are its share of the global plan's) and run the year kernels'
device functions on them, so a sharded year equals the unsharded kernels'
bit for bit.  ``SlabRunner`` keeps each shard's state, transported
buffers, coefficient scratch, corrections and outputs on its card across
the steps; where every shard the process holds is on one card and the mesh
spans one process, it captures a step (every shard's launches and the halo
copies) as one CUDA graph and replays it for every step of every year (the
step's index and the year's CO2 are read from device memory).

Only the fold's modern word runs here, in the additive form with dense
composites or the sequential form with packed composites: the strict
transport, no transport and the legacy ``log_exp`` words raise
``NotImplementedError`` naming ``ITEM_5B``, and additive splitting with
packed composites (224x112 to 352x176) naming ``ITEM_5C``, before any
launch.  The plain
version of a slab step is the plain sharded runner over the plain step
with the halo hook (parallel/sharded.py); only the tests and
``chip_smoke.py`` hold the kernels against it.

Launch counts: ``start.launches``, ``substep.launches``,
``finish.launches`` (plain ints), one for each kernel launched, eager or
replayed from a captured step; ``SlabRunner.halo_copies`` counts the
exchange's copies within the process.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...config import Experiment, Numerics
from ...model import core
from .. import fastcirc2 as fc2
from . import multiyear as my
from . import year_kernel as yk

F32 = np.float32
HALO = yk.HALO
ITEM_5B = "ROADMAP Queue 1 item 5b"
# where the slab kernels' additive form with packed composites is queued
ITEM_5C = "ROADMAP Queue 1 item 5c"
# kernel kinds of slab_finish (csrc/year_kernel.cu enum Kind)
FINISH_KINDS = {"fluxcorr": 0, "scenario": 1}


class _Slab(ctypes.Structure):
    """csrc/slab_kernel.cu SlabArgs."""
    _fields_ = [("xg", ctypes.c_void_p), ("halo_in", ctypes.c_void_p),
                ("edge_out", ctypes.c_void_p), ("step", ctypes.c_void_p),
                ("co2", ctypes.c_void_p), ("nblk", ctypes.c_int)]


def _lib():
    from . import build
    lib = build.load("slab_kernel")
    lib.greb_slab_start.argtypes = [yk._Args, _Slab, ctypes.c_void_p]
    lib.greb_slab_substep.argtypes = [yk._Args, yk._Refined, _Slab,
                                      ctypes.c_int, ctypes.c_void_p]
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
def check_slab(plan, exp: Experiment, kind: str = "fluxcorr") -> None:
    """Raise NotImplementedError for what the slab kernels do not run: no
    fold (``plan`` None: the strict transport or none) and the legacy words
    (naming ITEM_5B); additive splitting with packed composites, whose
    composite rows slab_substep's additive form would compute as dense ones
    (naming ITEM_5C); then the year kernels' own check of the global plan
    (``year_kernel.check_plan``)."""
    flags = yk.experiment_flags(exp, plan is None)
    if plan is None or flags:
        raise NotImplementedError(
            f"a mesh of CUDA devices runs the fold's modern word in the "
            f"slab kernels; the strict transport, no transport and the "
            f"legacy log_exp words (flags {flags:#x}) do not run there "
            f"({ITEM_5B})")
    if not plan.seq_zonal and plan.comp_mode == "packed":
        raise NotImplementedError(
            f"a mesh of CUDA devices: the slab kernels' additive form "
            f"computes dense composites, not the packed ones of "
            f"{plan.xdim}x{plan.ydim} ({ITEM_5C})")
    yk.check_plan(plan, kind, 0)


def slab_layout(plan: fc2.FastPlan, blocks: int) -> Dict[str, int]:
    """Bytes of each part of a slab_substep block's shared memory for a
    shard's ``plan`` (``fastcirc2.cut_plan``) on ``blocks`` blocks: the
    refined layout's parts (``year_kernel.refined_layout``, the same
    reckoning, csrc/slab_kernel.cu ``slab_parts``) with the transported
    buffers in global memory.  Raises ValueError where the blocks do not
    split the rows into blocks of at least HALO rows, the row length is not
    a multiple of COMP_BLOCK, a segment table exceeds MAX_SEGS or a block
    needs more than MAX_SMEM_BYTES."""
    Y, X = plan.ydim, plan.xdim
    if blocks < 1 or Y % blocks or Y // blocks < HALO:
        raise ValueError(f"{blocks} slab blocks: {Y} rows do not split into "
                         f"blocks of at least {HALO} rows")
    if X % fc2.COMP_BLOCK:
        raise ValueError(f"slab kernels: {X} columns, not a multiple of "
                         f"{fc2.COMP_BLOCK}")
    if max(len(plan.diff_segs), len(plan.adv_segs)) > yk.MAX_SEGS:
        raise ValueError(f"more than {yk.MAX_SEGS} segments: {plan}")
    R = Y // blocks
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


def slab_blocks(plan: fc2.FastPlan) -> int:
    """The blocks a member's shard rows split into: blocks of the fewest
    rows (at least HALO) whose layout fits."""
    Y = plan.ydim
    for R in range(HALO, Y + 1):
        if Y % R:
            continue
        try:
            slab_layout(plan, Y // R)
            return Y // R
        except ValueError:
            continue
    raise ValueError(f"no slab layout holds a shard of {Y} rows of "
                     f"{plan.xdim}")


def kernel_slab_layout(plan: fc2.FastPlan, blocks: int) -> Dict[str, int]:
    """The kernel's own reckoning of ``slab_layout`` (greb_slab_layout),
    for holding against it."""
    lib = _lib()
    parts = (ctypes.c_longlong * len(yk.REFINED_PARTS))()
    total = lib.greb_slab_layout(plan.ydim, plan.xdim, plan.comp_kt,
                                 plan.comp_kb, blocks, _refined(plan), parts)
    if total <= 0:
        raise ValueError(f"the kernel has no slab layout for {blocks} blocks")
    return dict(zip(yk.REFINED_PARTS, parts))


def _refined(plan: fc2.FastPlan, **ptrs) -> yk._Refined:
    """A shard's RefinedArgs: its segment tables and the form of its
    splitting, one run a cluster (no wide form)."""
    g = yk._Refined(n_dseg=len(plan.diff_segs), n_aseg=len(plan.adv_segs),
                    form=yk.REFINED_FORMS.index(
                        "sequential" if plan.seq_zonal else "additive"),
                    groups=1, **ptrs)
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
    model, forcing and fold, ``members`` its members (a member pack
    ``ppack``, else the base params), the state (5, M, Y, X), the
    transported buffers, edge and halo rows, the coefficient scratch, the
    correction tables (K1's out, K2's in), K2's outputs and sums, and the
    launch arguments."""
    yd: yk.YearData
    ppack: Optional[torch.Tensor]
    members: int
    step: torch.Tensor
    co2: torch.Tensor
    bufs: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __post_init__(self):
        plan = self.yd.plan
        Y, X, T = plan.ydim, plan.xdim, self.yd.num.nstep_yr
        M, dev = self.members, self.step.device
        self.nblk = slab_blocks(plan)
        R = Y // self.nblk
        f32 = dict(dtype=torch.float32, device=dev)
        b = self.bufs
        b["state"] = torch.zeros((5, M, Y, X), **f32)
        b["xg"] = torch.zeros((M, self.nblk, 2, 2, R + 2 * HALO, X), **f32)
        b["halo_in"] = torch.zeros((2, M, 2, HALO, X), **f32)
        b["edge_out"] = torch.zeros((2, M, 2, HALO, X), **f32)
        b["cf"] = torch.empty((M, 12, 2, Y, X), **f32)
        b["corr"] = torch.zeros((3, M, T, Y, X), **f32)
        b["outs"] = torch.empty((M, T, core.N_OUT, Y, X), **f32)
        b["asum"] = torch.empty((M, yk.N_SUM, Y, X), **f32)
        extra = dict(state_in=(b["state"], None),
                     state_out=(b["state"], None), cf=(b["cf"], None),
                     tf=(b["corr"][0], None), tof=(b["corr"][1], None),
                     qf=(b["corr"][2], None), outs=(b["outs"], None),
                     asum=(b["asum"], None))
        ints = dict(M=M, corr_step=Y * X)
        if self.ppack is not None:
            extra["ppack"] = (self.ppack, (M, 1, my.N_PPACK))
            ints["n_pack"] = my.N_PPACK
        self.args = yk._args(self.yd, b["state"], ints=ints, **extra)
        const = self.yd.fold[1]
        ptrs = {}
        if plan.comp_mode == "packed":
            offs, ranks = yk.packed_ranks(const)
            self._index = [torch.as_tensor(a, dtype=torch.int32, device=dev)
                           for a in (offs, ranks)]
            ptrs = dict(pcu=const.pcu.data_ptr(), pcw=const.pcw.data_ptr(),
                        comp_off=self._index[0].data_ptr(),
                        comp_rank=self._index[1].data_ptr(),
                        rtot=int(const.pcu.shape[1]))
        self.refined = _refined(plan, **ptrs)
        self.slab = _Slab(xg=b["xg"].data_ptr(),
                          halo_in=b["halo_in"].data_ptr(),
                          edge_out=b["edge_out"].data_ptr(),
                          step=self.step.data_ptr(),
                          co2=self.co2.data_ptr(), nblk=self.nblk)
        self.params = yk._params(self.yd, 0.0)
        self.nxt = 2 * (R + 2 * HALO) * X   # buffer 1's offset

    @property
    def device(self) -> torch.device:
        return self.step.device


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
    """Launch slab_start on ``shard`` (``count``: a launch, not a
    capture)."""
    _run("greb_slab_start", shard, shard.args, shard.slab)
    start.launches += count


def substep(shard: SlabShard, cur: int, count: bool = True) -> None:
    """Launch slab_substep on ``shard``, reading the buffer at ``cur``."""
    _run("greb_slab_substep", shard, shard.args, shard.refined, shard.slab,
         ctypes.c_int(cur))
    substep.launches += count


def finish(shard: SlabShard, kind: str, cur: int, count: bool = True) -> None:
    """Launch slab_finish of ``kind`` ("fluxcorr" or "scenario") on
    ``shard``, from the buffer at ``cur``."""
    _run("greb_slab_finish", shard, shard.args, shard.params,
         my._pack_cols(), shard.slab, ctypes.c_int(FINISH_KINDS[kind]),
         ctypes.c_int(shard.ppack is not None), ctypes.c_int(cur))
    finish.launches += count


start.launches = substep.launches = finish.launches = 0


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
class SlabRunner:
    """Sharded years on the card for the local shards of ``mesh``
    (parallel/sharded.py ``Mesh``) under ``splan`` (``ShardPlan``).
    ``year`` takes each shard's state, forcing, model data and fold and
    returns each shard's state and K1's corrections or K2's outputs and
    sums.  ``graphs``: a step is captured as one CUDA graph where the mesh
    spans one process and one card (a graph holds no exchange across
    processes); else every launch and copy is eager."""

    def __init__(self, mesh, splan: fc2.ShardPlan, num: Numerics,
                 exp: Experiment):
        self.mesh, self.splan, self.num, self.exp = mesh, splan, num, exp
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

    def _setup(self, sfx_s, md_s, fcconst) -> None:
        """Each local shard's SlabShard, made again (and its graphs
        captured again) where the inputs are other objects than the last
        call's."""
        key = (id(sfx_s), id(md_s), id(fcconst))
        if self._inputs == key:
            return
        self._inputs, self._graph = key, {}
        for k in self.mesh.local():
            dev = self.mesh.devices[k]
            step, co2 = self._counters[str(dev)]
            yd = yk.YearData(md=md_s[k].md, sfx=sfx_s[k],
                             fold=(self.splan.plans[k[1]], fcconst[k]),
                             num=self.num, exp=self.exp)
            pp = md_s[k].ppack
            self.shards[k] = SlabShard(yd=yd, ppack=pp,
                                       members=1 if pp is None else
                                       pp.shape[0], step=step, co2=co2)

    def _exchange(self, count: bool) -> None:
        for e in range(self.mesh.n_ens):
            keys = [k for k in self.shards if k[0] == e]
            if not keys:
                continue
            n = self.mesh.exchange(e).edges(
                {k[1]: self.shards[k].bufs["edge_out"] for k in keys},
                {k[1]: self.shards[k].bufs["halo_in"] for k in keys})
            self.halo_copies += n * count

    def _step(self, kind: str, count: bool = True) -> None:
        """One step of every local shard: start, exchange, nsub substeps
        each followed by an exchange, finish, then the step index on."""
        for s in self.shards.values():
            start(s, count)
        self._exchange(count)
        nsub = self.num.nsub_crcl
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
        n = len(self.shards)
        start.launches += n
        substep.launches += n * self.num.nsub_crcl
        finish.launches += n
        self.halo_copies += self._copies_a_step()

    def _copies_a_step(self) -> int:
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


def slab_work(plan: fc2.FastPlan, num: Numerics, entry: str,
              scenario: bool = False,
              ranks: Optional[np.ndarray] = None) -> Tuple[int, int]:
    """(bytes, operations) one launch of ``entry`` ("slab_start",
    "slab_substep", "slab_finish") on one member of a shard of ``plan``
    must move and compute at least, counted as ``year_work`` counts a
    year's: each input read once and each output written once, the edge
    and halo rows (2 sides, 2 fields, HALO rows) included; ``scenario``: a
    scenario step's finish (outputs and annual sums); ``ranks``: a packed
    plan's composite ranks."""
    yx, X = plan.ydim * plan.xdim, plan.xdim
    edge = 2 * 2 * HALO * X
    if entry == "slab_start":
        words = 2 * yx + 17 * 2 * yx + 2 * yx + 2 * yx + 12 * 2 * yx + edge
        return 4 * words, 2 * yx * 21
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
