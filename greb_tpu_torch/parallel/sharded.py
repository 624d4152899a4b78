"""Latitude x member sharding (``greb_tpu.parallel.sharded``).

A mesh is an (ens, y) grid of devices: members split over its ``ens`` rows
(``batched=True``; pure data parallelism, no exchange between rows), the
latitude rows over its ``y`` columns, whose shards exchange 2 halo rows
each way a circulation substep (parallel/halo.py).  Longitude stays whole
in a shard: the polar sub-cycles iterate along a row.  A device may appear
more than once: several shards can share one card (or the CPU).

What the JAX module's names are here:

- ``make_mesh(n_ens, n_y, devices)``: a ``Mesh``, an (n_ens, n_y) grid of
  ``torch.device``s (default: the cards, in turn);
- ``shard_inputs`` / ``shard_fastcirc``: each shard's rows (and members)
  of the state, forcing, corrections, model data and fold, on its device,
  as ``Sharded`` dicts keyed by (ens row, y shard); ``Sharded.gather``
  joins them again;
- ``make_sharded_year_runners``: (fluxcorr year, scenario year) over the
  mesh.  On CUDA devices the years run in the slab kernels
  (ops/cuda/slab.py) under every word; what the year kernels do not run
  (the strict transport and no transport at 768x384) raises
  NotImplementedError naming its ROADMAP item before any launch.  On the
  CPU they run the plain step (model/core.py) of each shard in a thread of
  its own, with ``extend`` the halo exchange among the threads: the plain
  version the kernels are held against.

The fold of a shard is the unsharded fold cut into its rows
(``fastcirc2.build_sharded``), so a sharded year equals the unsharded one
bit for bit, in the plain version and in the kernels.  Without a fold
(``fast_plan=None``, or a word that takes the strict transport) the plain
version runs the strict stencils in their masked full-field form
(``StencilStatic.compact_polar=False``), whose per-row masks shard with
the rows and equal the compact form row for row; the slab kernels run the
year kernels' strict substep on each shard's rows of the strict constants
(``slab.cut_strict``, and wz with its neighbours' halo rows,
``ShardModel.wz_halo``).
"""
from __future__ import annotations

import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Experiment, Numerics
from ..forcing import Corrections, ModelState
from ..model import core
from ..ops import fastcirc2 as fc2
from ..ops import stencils as stc
from ..ops.cuda import multiyear as my
from ..ops.cuda import slab
from .halo import HaloExchange, make_sharded_extend

F32 = np.float32
Key = Tuple[int, int]
# the interpreter's thread switch interval [s] while the plain runners'
# shard threads run
SWITCH_INTERVAL = 1e-5


class Mesh:
    """An (n_ens, n_y) grid of devices; ``ranks[e][y]`` is the process
    that holds shard (e, y) (all this one's unless the mesh spans
    processes, parallel/multihost.py), ``group`` their process group."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 ranks: Optional[Sequence[Sequence[int]]] = None,
                 group=None):
        self.devices = {(e, y): torch.device(d)
                        for e, row in enumerate(devices)
                        for y, d in enumerate(row)}
        self.n_ens, self.n_y = len(devices), len(devices[0])
        from .halo import _rank
        self.rank = _rank(group)
        self.ranks = ({k: self.rank for k in self.devices} if ranks is None
                      else {(e, y): int(r) for e, row in enumerate(ranks)
                            for y, r in enumerate(row)})
        self.group = group
        self._exchanges: Dict[int, HaloExchange] = {}
        types = {d.type for d in self.devices.values()}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's devices are all CUDA or all CPU, "
                             f"not {sorted(types)}")

    @property
    def shape(self) -> Dict[str, int]:
        return {"ens": self.n_ens, "y": self.n_y}

    @property
    def is_cuda(self) -> bool:
        return next(iter(self.devices.values())).type == "cuda"

    def local(self) -> List[Key]:
        """The shards this process holds, in (ens row, y shard) order."""
        return sorted(k for k, r in self.ranks.items() if r == self.rank)

    def single_process(self) -> bool:
        return len(set(self.ranks.values())) == 1

    def exchange(self, e: int) -> HaloExchange:
        """The halo exchange of ens row ``e`` (made once)."""
        if e not in self._exchanges:
            self._exchanges[e] = HaloExchange(
                self.n_y, [self.ranks[(e, y)] for y in range(self.n_y)],
                group=self.group, tag=2 * self.n_y * e)
        return self._exchanges[e]


def make_mesh(n_ens: int = 1, n_y: int = 1, devices=None) -> Mesh:
    """An (n_ens, n_y) mesh over ``devices`` in row order, taken in turn
    where there are fewer than n_ens * n_y (shards then share a device);
    by default the process's cards (``resolve_device``: raises without
    one)."""
    if devices is None:
        from .. import resolve_device
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_ens * n_y
    devs = [devices[i % len(devices)] for i in range(n)]
    return Mesh([devs[e * n_y:(e + 1) * n_y] for e in range(n_ens)])


# ---------------------------------------------------------------------------
# sharded values
# ---------------------------------------------------------------------------
class Sharded(dict):
    """Per-shard values keyed by (ens row, y shard), the shards this
    process holds: ModelStates, Corrections, StepOutputs or tensors whose
    last two axes are (rows, columns) (``y_axis``: another axis of rows, as
    a (t, y) array's) and, where ``batched``, whose first axis is the ens
    row's members."""

    def __init__(self, mesh: Mesh, parts: Dict[Key, object],
                 batched: bool = False, y_axis: int = -2):
        super().__init__(parts)
        self.mesh, self.batched, self.y_axis = mesh, batched, y_axis

    def gather(self):
        """The whole value on the host: the y shards joined along the rows,
        the ens rows along the members (one ens row where not batched).
        Across processes every process gathers every shard (a collective:
        every process calls it)."""
        parts = {k: _to_cpu(v) for k, v in self.items()}
        if not self.mesh.single_process():
            import torch.distributed as dist
            got = [None] * dist.get_world_size(self.mesh.group)
            dist.all_gather_object(got, parts, group=self.mesh.group)
            parts = {k: v for p in got for k, v in p.items()}
        rows = range(self.mesh.n_ens if self.batched else 1)
        return _join([_join([parts[(e, y)] for y in range(self.mesh.n_y)],
                            self.y_axis) for e in rows], 0)


def _to_cpu(v):
    if isinstance(v, (ModelState, Corrections)):
        return type(v)(*[getattr(v, f.name).cpu()
                         for f in dataclasses.fields(v)])
    if isinstance(v, core.StepOutputs):
        return core.StepOutputs(*[a.cpu() for a in v])
    return v.cpu()


def _join(vals: list, dim: int):
    """Concatenate like values along ``dim``."""
    v0 = vals[0]
    if len(vals) == 1:
        return v0
    if isinstance(v0, (ModelState, Corrections)):
        return type(v0)(*[torch.cat([getattr(v, f.name) for v in vals], dim)
                          for f in dataclasses.fields(v0)])
    if isinstance(v0, core.StepOutputs):
        return core.StepOutputs(*[torch.cat(a, dim) for a in zip(*vals)])
    return torch.cat(vals, dim)


@dataclasses.dataclass
class ShardModel:
    """One shard's model data: its rows of ``md`` (the strict stencils'
    per-row constants too), where batched its members' pack
    (multiyear.pack_member_params, (M, 1, N_PPACK)), and wz of Ta and q
    with the neighbour shards' HALO rows each side (``slab.wz_halo``, the
    slab kernels' strict transport)."""
    md: core.ModelData
    ppack: Optional[torch.Tensor] = None
    wz_halo: Optional[torch.Tensor] = None


def _rows(a: torch.Tensor, lo: int, hi: int, dev) -> torch.Tensor:
    return a[..., lo:hi, :].contiguous().to(dev)


def _cut_md(md: core.ModelData, lo: int, hi: int, dev) -> core.ModelData:
    d = md.derived
    derived = dataclasses.replace(
        d, wz_air=_rows(d.wz_air, lo, hi, dev),
        wz_vapor=_rows(d.wz_vapor, lo, hi, dev),
        z_ocean=_rows(d.z_ocean, lo, hi, dev),
        toclim=_rows(d.toclim, lo, hi, dev))
    sf = None
    if md.sf is not None:
        sf = stc.StencilFields(**{
            f.name: _rows(getattr(md.sf, f.name), lo, hi, dev)
            for f in dataclasses.fields(md.sf)})
    return dataclasses.replace(md, derived=derived,
                               z_topo=_rows(md.z_topo, lo, hi, dev),
                               glacier=_rows(md.glacier, lo, hi, dev), sf=sf)


def _cut_sfx(sfx: core.StepForcing, lo: int, hi: int, dev):
    return core.StepForcing(**{
        f.name: (_rows(getattr(sfx, f.name), lo, hi, dev)
                 if f.name != "sw_solar" else
                 sfx.sw_solar[:, lo:hi].contiguous().to(dev))
        for f in dataclasses.fields(sfx)})


def _cut(v, lo: int, hi: int, m0: int, m1: int, batched: bool, dev):
    """Rows [lo, hi) (and members [m0, m1)) of a ModelState or
    Corrections."""
    return type(v)(*[(getattr(v, f.name)[m0:m1] if batched
                      else getattr(v, f.name))[..., lo:hi, :]
                     .contiguous().to(dev)
                     for f in dataclasses.fields(v)])


def _split(mesh: Mesh, v, batched: bool) -> Sharded:
    """Each local shard's rows (and, where batched, its ens row's members)
    of a ModelState or Corrections, on its device."""
    Y = getattr(v, dataclasses.fields(v)[0].name).shape[-2]
    R = fc2._check_shards(Y, mesh.n_y)
    M = getattr(v, dataclasses.fields(v)[0].name).shape[0] if batched else 1
    if M % mesh.n_ens:
        raise ValueError(f"{M} members do not split evenly over "
                         f"{mesh.n_ens} ens rows")
    Me = M // mesh.n_ens
    return Sharded(mesh, {
        k: _cut(v, k[1] * R, (k[1] + 1) * R, k[0] * Me, (k[0] + 1) * Me,
                batched, mesh.devices[k]) for k in mesh.local()}, batched)


def shard_state(mesh: Mesh, state, batched: bool = False) -> Sharded:
    """A ModelState (batched: of (M, Y, X) fields, or a (5, M, Y, X)
    tensor) as each local shard's rows on its device."""
    if isinstance(state, torch.Tensor):
        state = ModelState.unstack(state)
    return _split(mesh, state, batched)


def shard_corr(mesh: Mesh, corr: Corrections,
               batched: bool = False) -> Sharded:
    """Correction tables ((T, Y, X), batched (M, T, Y, X)) as each local
    shard's rows on its device."""
    return _split(mesh, corr, batched)


def shard_inputs(mesh: Mesh, batched: bool, state, sfx: core.StepForcing,
                 corr: Optional[Corrections], md: core.ModelData,
                 ppack: Optional[torch.Tensor] = None):
    """Each local shard's rows of the inputs on its device: (state_s,
    sfx_s, corr_s, md_s), ``Sharded`` dicts.  Where ``batched``, ``state``
    is a ModelState of (M, Y, X) fields or a (5, M, Y, X) tensor,
    ``corr`` (M, T, Y, X) tables (None: zeros) and ``ppack`` the members'
    (M, 1, N_PPACK) pack; member group e goes to ens row e.  Otherwise
    every ens row gets the one run.  The forcing and the model data are
    shared by a y shard's rows, one copy a device."""
    if isinstance(state, torch.Tensor):
        state = ModelState.unstack(state)
    Y = state.ts.shape[-2]
    R = fc2._check_shards(Y, mesh.n_y)
    M = state.ts.shape[0] if batched else 1
    if batched and (M % mesh.n_ens or ppack is None
                    or tuple(ppack.shape) != (M, 1, my.N_PPACK)):
        raise ValueError(f"batched: {M} members must split evenly over "
                         f"{mesh.n_ens} ens rows, with a ({M}, 1, "
                         f"{my.N_PPACK}) member pack")
    Me = M // mesh.n_ens
    if corr is None:
        T = sfx.tclim.shape[0]
        z = torch.zeros(((M,) if batched else ()) + (T,) + tuple(
            state.ts.shape[-2:]), dtype=torch.float32)
        corr = Corrections(z, z, z)
    sf, mds = {}, {}
    shared: Dict = {}
    for k in mesh.local():
        e, y = k
        dev = mesh.devices[k]
        lo, hi = y * R, (y + 1) * R
        m0, m1 = e * Me, (e + 1) * Me
        sk = (y, str(dev))
        if sk not in shared:
            shared[sk] = (_cut_sfx(sfx, lo, hi, dev),
                          _cut_md(md, lo, hi, dev),
                          slab.wz_halo(md, lo, hi, dev))
        sf[k] = shared[sk][0]
        mds[k] = ShardModel(shared[sk][1], ppack[m0:m1].to(dev)
                            if batched else None, shared[sk][2])
    return (shard_state(mesh, state, batched), Sharded(mesh, sf),
            shard_corr(mesh, corr, batched), Sharded(mesh, mds))


def shard_fastcirc(mesh: Mesh, sconst: fc2.Fast2ShardConst) -> Sharded:
    """Each local shard's rows of the fold (``build_sharded``) on its
    device, one copy a y shard and device, shared by its ens rows (the
    members share the fold, as ``ensemble.fastcirc_shareable`` requires)."""
    out, seen = {}, {}
    for k in mesh.local():
        dev = mesh.devices[k]
        sk = (k[1], str(dev))
        if sk not in seen:
            c = sconst.shards[k[1]]
            seen[sk] = dataclasses.replace(
                c, **{f.name: getattr(c, f.name).to(dev)
                      for f in dataclasses.fields(c)
                      if isinstance(getattr(c, f.name), torch.Tensor)},
                pidx=(fc2.packed_index(c.pmask.cpu().numpy(), dev)
                      if c.pidx is not None else None))
        out[k] = seen[sk]
    return Sharded(mesh, out)


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------
def _member_md(sm: ShardModel, m: int) -> core.ModelData:
    """Member m's model data: the shard's rows with the pack's params and
    heat capacities (multiyear._member_data)."""
    if sm.ppack is None:
        return sm.md
    p, (cap_ocean, cap_land, cap_air) = my.member_params(
        sm.ppack[m, 0].cpu().numpy())
    derived = dataclasses.replace(sm.md.derived, cap_ocean=cap_ocean,
                                  cap_land=cap_land, cap_air=cap_air)
    return dataclasses.replace(sm.md, params=p, derived=derived)


def _members(v, batched: bool) -> List:
    """A shard's ModelState or Corrections as one per member."""
    if not batched:
        return [v]
    n = getattr(v, dataclasses.fields(v)[0].name).shape[0]
    return [type(v)(*[getattr(v, f.name)[m] for f in dataclasses.fields(v)])
            for m in range(n)]


def _stack(vals: List, batched: bool):
    if not batched:
        return vals[0]
    v0 = vals[0]
    if isinstance(v0, torch.Tensor):
        return torch.stack(vals)
    if isinstance(v0, tuple):
        return type(v0)(*[torch.stack(a) for a in zip(*vals)])
    return type(v0)(*[torch.stack([getattr(v, f.name) for v in vals])
                      for f in dataclasses.fields(v0)])


def _threads(mesh: Mesh, fn, keys: List[Key]) -> Dict[Key, object]:
    """fn(k) for every local shard k, each in a thread of its own on the
    caller's CUDA stream of its device; a thread that raises releases the
    others from their exchanges, and the first error is raised."""
    for e in range(mesh.n_ens):   # made here, not racing in the threads
        mesh.exchange(e)
    streams = {}
    if mesh.is_cuda:
        for k in keys:
            d = mesh.devices[k]
            streams[k] = torch.cuda.current_stream(d)

    def run(k):
        try:
            if k in streams:
                with torch.cuda.device(mesh.devices[k]), \
                        torch.cuda.stream(streams[k]):
                    return fn(k)
            return fn(k)
        except BaseException:
            for e in range(mesh.n_ens):
                mesh.exchange(e).abort()
            raise

    if len(keys) == 1:
        return {keys[0]: run(keys[0])}
    # a thread released at an exchange waits for the interpreter's switch
    # interval (5 ms by default) before it runs: each substep's two
    # barriers would cost that much
    interval = sys.getswitchinterval()
    sys.setswitchinterval(SWITCH_INTERVAL)
    try:
        return _pool(keys, run, mesh)
    finally:
        sys.setswitchinterval(interval)


def _pool(keys: List[Key], run, mesh: Mesh) -> Dict[Key, object]:
    with ThreadPoolExecutor(max_workers=len(keys)) as pool:
        futs = {k: pool.submit(run, k) for k in keys}
        out, err = {}, None
        for k, f in futs.items():
            try:
                out[k] = f.result()
            except BaseException as exc:    # the first error, not a barrier's
                if err is None or isinstance(err, threading.BrokenBarrierError):
                    err = exc
        if err is not None:
            for e in range(mesh.n_ens):
                mesh._exchanges.pop(e, None)
            raise err
    return out


def make_sharded_year_runners(mesh: Mesh, st: stc.StencilStatic,
                              num: Numerics, exp: Experiment,
                              month_mat: torch.Tensor,
                              batched: bool = False,
                              fast_plan: Optional[fc2.ShardPlan] = None):
    """(fluxcorr_year, scenario_year) over ``mesh``:

    ``flux(state_s, sfx_s, co2, md_s, fcconst=None) -> (state_s, corr_s)``,
    ``scnr(state_s, sfx_s, corr_s, co2, md_s, fcconst=None) -> (state_s,
    monthly_s, meanf_s)``, on ``shard_inputs``' dicts (``fcconst``:
    ``shard_fastcirc``'s, with ``fast_plan`` the ``ShardPlan`` of
    ``fastcirc2.build_sharded``; without it the strict stencils run, masked
    full-field).  ``monthly_s[k]`` (12, 5, R, X), ``meanf_s[k]`` the annual
    means (``core.StepOutputs``), each with a leading member axis where
    ``batched``.  On a mesh of CUDA devices the years run in the slab
    kernels (``slab.SlabRunner``, the runners' ``runner``) under the fold,
    the strict transport or none, as ``exp`` and ``fast_plan`` say
    (``core.transport``); what they do not run raises
    NotImplementedError naming its ROADMAP item, before any launch
    (``slab.check_slab``)."""
    if mesh.is_cuda:
        plan = slab.global_plan(fast_plan, exp, num, st.seq_zonal)
        for kind in ("fluxcorr", "scenario"):
            slab.check_slab(plan, exp, kind)
        runner = slab.SlabRunner(mesh, fast_plan, num, exp, plan)
        return _slab_runners(mesh, runner, num, month_mat, batched)
    return make_plain_year_runners(mesh, st, num, exp, month_mat, batched,
                                   fast_plan)


def make_plain_year_runners(mesh: Mesh, st: stc.StencilStatic,
                            num: Numerics, exp: Experiment,
                            month_mat: torch.Tensor, batched: bool = False,
                            fast_plan: Optional[fc2.ShardPlan] = None):
    """The plain version of ``make_sharded_year_runners``' runners, on a
    mesh of any devices: each local shard's years through the plain step
    (``core.run_year_fluxcorr`` / ``run_year_scenario``, member after
    member) in a thread of its own, ``extend`` the halo exchange among the
    threads of its ens row (``halo.make_sharded_extend``).  On the CPU the
    runners are these; on the card only the tests and chip_smoke.py call
    them, to hold the slab kernels against them."""
    st = dataclasses.replace(st, compact_polar=False)

    def fold(k, fcconst):
        return (None if fast_plan is None
                else (fast_plan.plans[k[1]], fcconst[k]))

    def data(k, md_s):
        sm = md_s[k]
        return dataclasses.replace(sm, md=dataclasses.replace(sm.md, st=st))

    def flux(state_s, sfx_s, co2, md_s, fcconst=None):
        co2 = F32(co2)

        def one(k):
            ext = make_sharded_extend(mesh.exchange(k[0]), k[1])
            sm = data(k, md_s)
            outs = [core.run_year_fluxcorr(s, sfx_s[k], co2, _member_md(sm, m),
                                           num, fold(k, fcconst), exp, ext)
                    for m, s in enumerate(_members(state_s[k], batched))]
            return (_stack([o[0] for o in outs], batched),
                    _stack([o[1] for o in outs], batched))

        res = _threads(mesh, one, mesh.local())
        return (Sharded(mesh, {k: v[0] for k, v in res.items()}, batched),
                Sharded(mesh, {k: v[1] for k, v in res.items()}, batched))

    def scnr(state_s, sfx_s, corr_s, co2, md_s, fcconst=None):
        co2 = F32(co2)

        def one(k):
            ext = make_sharded_extend(mesh.exchange(k[0]), k[1])
            sm = data(k, md_s)
            res = []
            for m, (s, c) in enumerate(zip(_members(state_s[k], batched),
                                           _members(corr_s[k], batched))):
                s, outs, asum = core.run_year_scenario(
                    s, sfx_s[k], c, co2, _member_md(sm, m), num,
                    fold(k, fcconst), exp, ext)
                mm = month_mat.to(outs.device)
                res.append((s, core.monthly_means(mm, outs),
                            core.annual_means(asum, num)))
            return tuple(_stack([r[i] for r in res], batched)
                         for i in range(3))

        res = _threads(mesh, one, mesh.local())
        return tuple(Sharded(mesh, {k: v[i] for k, v in res.items()},
                             batched) for i in range(3))

    return flux, scnr


def _slab_runners(mesh: Mesh, runner, num: Numerics,
                  month_mat: torch.Tensor, batched: bool):
    """The runners' contract over ``slab.SlabRunner``: each shard's state
    as the kernels' (5, M, R, X), and back."""

    def state5(state_s):
        return {k: v.stack().reshape((5, -1) + tuple(v.ts.shape[-2:]))
                for k, v in state_s.items()}

    def unstate(s5):
        return ModelState.unstack(s5 if batched else s5[:, 0])

    def corr3(corr_s):
        return {k: torch.stack([c.tf, c.tof, c.qf]).reshape(
            (3, -1) + tuple(c.tf.shape[-3:])) for k, c in corr_s.items()}

    def flux(state_s, sfx_s, co2, md_s, fcconst=None):
        res = runner.year("fluxcorr", state5(state_s), sfx_s, md_s, fcconst,
                          co2)
        corr = {}
        for k, (_, c) in res.items():
            c = c if batched else c[:, 0]
            corr[k] = Corrections(c[0], c[1], c[2])
        return (Sharded(mesh, {k: unstate(v[0]) for k, v in res.items()},
                        batched), Sharded(mesh, corr, batched))

    def scnr(state_s, sfx_s, corr_s, co2, md_s, fcconst=None):
        res = runner.year("scenario", state5(state_s), sfx_s, md_s, fcconst,
                          co2, corr_s=corr3(corr_s))
        st, mon, mean = {}, {}, {}
        for k, (s5, outs, asum) in res.items():
            mm = month_mat.to(outs.device)
            mons = [core.monthly_means(mm, o) for o in outs]
            means = [core.annual_means(a, num) for a in asum]
            st[k] = unstate(s5)
            mon[k] = _stack(mons, True) if batched else mons[0]
            mean[k] = (core.StepOutputs(*[torch.stack(a) for a in
                                          zip(*means)])
                       if batched else means[0])
        return (Sharded(mesh, st, batched), Sharded(mesh, mon, batched),
                Sharded(mesh, mean, batched))

    flux.runner = scnr.runner = runner
    return flux, scnr
