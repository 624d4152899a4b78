"""The member-batched multi-year kernels: wrappers, plain versions and
launch counters.

``fluxcorr_years`` replaces ``greb_tpu/ops/pallas/multiyear.py``
``build_fluxcorr_years`` (:253): one spin-up year for each of M members,
each with its own physics parameters.  ``scenario_years`` replaces
``build_scenario_years`` (:107): ``n_years`` scenario years for each
member, CO2 from a table per year, with the monthly means (weight
1/steps-in-month) and the 9 annual sums added up inside the kernel.  Both
run the cluster body of ``csrc/year_kernel.cu`` that the single-run
kernels run: one member per thread-block cluster of ``cluster`` blocks,
each block with its rows' state, coefficient planes, diffusion planes, pole
composites, annual sums and (K3) the month's means in its own shared
memory; M clusters beyond the card's capacity run in waves.  For
``scenario_years`` ``cluster=1`` is the one-block body instead: one thread
block per member, the state in shared memory and the coefficient planes in
a per-member global scratch.  By default each wrapper picks the size by
the member count (``default_cluster``).  For a plan of the refined
instantiation (``year_kernel.is_refined``: the folds from 192x96 to
384x192, modern and legacy, and the strict transport from 224x112 to
384x192) both launch it (csrc/year_kernel.cu ``run_refined``,
``year_kernel.refined_layout``) on 16-block clusters at every member
count, under the fold each member with its own global scratch for the
step's coefficient planes (M, 12, 2, Y, X); K3 adds up the monthly means
and annual sums in global memory.  A plan of the wide form (768x384:
``year_kernel.refined_groups`` clusters a member) launches
floor(capacity / groups) members at a time, one launch after another
(``year_kernel.check_resident``: its grid barrier needs every cluster of
a launch resident, so members never run in waves there).  On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version, ``*_plain``, which loops over the members and steps
through ``core.fluxcorr_step`` / ``core.scenario_step`` in the kernel's
order of accumulation.  The legacy
switchboard reaches both through ``YearData.exp``, as in the single-run
kernels.

Layouts are the JAX package's: state (5, M, Y, X), member pack
(M, 1, N_PPACK), corrections (M, T, 3, Y, X), monthly means
(M, 12 * n_years, 5, Y, X), annual sums (M, n_years, 9, Y, X).
``scenario_years`` also takes one correction table (1, T, 3, Y, X) that
every member reads (an ensemble's shared spin-up; the JAX CLI broadcasts a
member axis of 1): the kernel's member stride of the tables is then 0.
The fold and the strict stencils' constants are built once from the base
parameters, so the members may not differ from them in a transport
parameter (``parallel.ensemble.TRANSPORT_PARAM_KEYS``).  K3's one-block
body does not run the strict transport (``cluster=1`` raises).
The TPU kernel's members-per-block ``mb`` has no counterpart: a member
fills a cluster's shared memory, and members do not interact.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...config import Numerics, PhysicsParams
from ...forcing import ModelState
from ...grid import month_average_matrix
from ...model import core
from ...parallel.ensemble import TRANSPORT_PARAM_KEYS
from . import year_kernel as yk

F32 = np.float32

# member pack columns: the 29 scalar PhysicsParams fields in declaration
# order, the 10 p_emi entries, then the 3 heat capacities (cap_ocean,
# cap_land, cap_air)
_SCALAR_FIELDS = tuple(f.name for f in dataclasses.fields(PhysicsParams)
                       if f.name != "p_emi")
N_PPACK = len(_SCALAR_FIELDS) + 10 + 3
_COL_P_EMI = len(_SCALAR_FIELDS)
_COL_CAPS = _COL_P_EMI + 10


def pack_member_params(members: Sequence[PhysicsParams],
                       device="cpu") -> torch.Tensor:
    """Per-member params -> (M, 1, N_PPACK) float32 table."""
    rows = []
    for p in members:
        caps = (p.cp_ocean * p.rho_ocean, p.cp_land * p.rho_land * p.d_land,
                p.cp_air * p.rho_air * p.d_air)
        rows.append(np.concatenate([
            np.asarray([getattr(p, f) for f in _SCALAR_FIELDS], F32),
            np.asarray(p.p_emi, F32).reshape(10), np.asarray(caps, F32)]))
    return torch.as_tensor(np.stack(rows)[:, None, :], device=device)


def member_params(row: np.ndarray) -> Tuple[PhysicsParams, Tuple]:
    """One (N_PPACK,) pack row -> (PhysicsParams, (cap_ocean, cap_land,
    cap_air))."""
    row = np.asarray(row, F32)
    p = PhysicsParams(**{f: row[i] for i, f in enumerate(_SCALAR_FIELDS)},
                      p_emi=row[_COL_P_EMI:_COL_CAPS].copy())
    return p, tuple(row[_COL_CAPS:_COL_CAPS + 3])


# the member kernels' kinds (year_kernel.KINDS); the sizes each offers are
# year_kernel.offered_sizes(kind)
KINDS = ("fluxcorr", "scenario_years")
# The size each kernel launches with by default: DEFAULT_CLUSTER while the
# members fill at most ``waves`` waves of DEFAULT_CLUSTER-block clusters,
# the other size beyond.  The waves were measured in chip_smoke.py's member
# scaling (one year) on an H100 80GB HBM3 at 700 W, which runs 7 clusters
# of 16 blocks at once (year_kernel.cluster_capacity), 15 of 8, and 132
# one-block members: K4 at M=7 (1 wave) took 45.0 ms at C=16 against 57.9
# at C=8, at M=8 88.0 against 57.8 (at M=132 835.4 against 511.9); K3 at
# M=49 (7 waves) took 325.0 ms on 16-block clusters against 354.0 on one
# block a member, at M=56 371.6 against 359.0 (at M=132 868.4 against
# 606.7).
_BEYOND_WAVES = {"fluxcorr": (1, 8), "scenario_years": (7, 1)}


def default_cluster(kind: str, members: int, capacity: int,
                    strict: bool = False) -> int:
    """The cluster size ``kind``'s wrapper launches ``members`` members
    with by default, on a card that runs ``capacity`` clusters of
    DEFAULT_CLUSTER blocks at once (``_BEYOND_WAVES``).  Under the strict
    transport (``strict``) K3's one-block body is not offered, so K3 stays
    on DEFAULT_CLUSTER-block clusters at every member count."""
    waves, beyond = _BEYOND_WAVES[kind]
    if members <= waves * capacity or (strict and beyond == 1):
        return yk.DEFAULT_CLUSTER
    return beyond


def _default_cluster_on(yd: yk.YearData, kind: str, members: int) -> int:
    """``default_cluster`` on this card, its capacity asked once per run;
    for a plan of the refined instantiation its one size at every member
    count (K3's one-block body cannot hold such a member: ``smem_bytes``
    is 709,632 B at 192x96, and it does not run the strict transport)."""
    if yk.is_refined(yd.plan):
        return yk.REFINED_CLUSTER_SIZES[0]
    key = ("capacity", kind, yd.transport)
    if key not in yd.cache:
        yd.cache[key] = yk.cluster_capacity(yd.plan, yk.DEFAULT_CLUSTER,
                                            kind)
    return default_cluster(kind, members, yd.cache[key],
                           yd.transport == "strict")


def _pack_cols() -> yk._PackCols:
    col = {f: i for i, f in enumerate(_SCALAR_FIELDS)}
    return yk._PackCols(**{n: col[n] for n in yk._PARAM_NAMES},
                        p_emi=_COL_P_EMI, cap_ocean=_COL_CAPS,
                        cap_land=_COL_CAPS + 1, cap_air=_COL_CAPS + 2)


def month_maps(num: Numerics) -> Tuple[np.ndarray, np.ndarray]:
    """(month index (T,) int32, weight 1/steps-in-month (T,) float32) of
    every step of the year (multiyear.py ``_month_maps`` at one step per
    block: here the kernel loops over every step itself)."""
    mm = month_average_matrix(num.jday_mon, num.ndt_days)      # (12, T)
    return mm.argmax(axis=0).astype(np.int32), mm.max(axis=0).astype(F32)


def _maps_on(yd: yk.YearData, dev: torch.device):
    """The month maps on ``dev``, copied there once per run: a copy from
    pageable host memory would wait for the block in flight."""
    key = ("month maps", str(dev))
    if key not in yd.cache:
        mon, w = month_maps(yd.num)
        yd.cache[key] = (torch.as_tensor(mon, device=dev),
                         torch.as_tensor(w, device=dev))
    return yd.cache[key]


def years_work(plan, num: Numerics, n_years: int, members: int,
               kind: str, shared_corr: bool = False,
               ranks: Optional[np.ndarray] = None, flags: int = 0):
    """(bytes, operations) a launch of ``kind`` ("fluxcorr": K4, one year;
    "scenario": K3) must move and compute at least for ``members`` members
    over ``n_years`` years, counted as ``year_kernel.year_work`` (packed
    composites at their ``ranks``, required for a packed plan, and the
    explicit segments' iterations; a ``StrictPlan`` the strict transport
    under ``flags``, each row's sub-cycles at its own count): the shared
    inputs (forcing, constants, fold or the stencils' constants) read
    once, each member's state, pack, monthly means and annual sums once.
    The correction tables count once
    per member and year: a year streams them step by step, and from one
    year to the next 40 MB a member (at 96x48) cannot stay on chip.  K3's
    shared table (``shared_corr``) counts once a year: members that step
    together could all read one step's slice from L2."""
    scen = kind == "scenario"
    if not scen and (n_years != 1 or shared_corr):
        raise ValueError("a spin-up launch runs one year and writes a "
                         "table per member")
    yx, t = plan.ydim * plan.xdim, num.nstep_yr
    nmon = len(num.jday_mon)
    if isinstance(plan, yk.StrictPlan):
        # the constant fields, wz_vapor and the rows' constants: the
        # single year's words less its state, forcing and tables
        shared = (yk.year_work(plan, num, False, flags=flags)[0] // 4
                  - 10 * yx - 8 * t * yx - t * plan.ydim - 3 * t * yx)
    else:
        shared = (5 * yx                         # constant fields
                  + (7 + 8 + 9 + 1) * 2 * yx     # fold planes
                  + yk.composite_words(plan, ranks))   # composites
    words = (8 * t * yx + t * plan.ydim          # forcing, insolation
             + shared
             + members * (10 * yx + N_PPACK)     # state in and out, pack
             + (1 if shared_corr else members)   # corrections in / out
             * n_years * 3 * t * yx)
    if scen:
        words += (n_years + 2 * t                # CO2 table, month maps
                  + members * n_years * (nmon * core.N_OUT + yk.N_SUM) * yx)
    # per year and member: the single-year step body (with the annual sums
    # for a scenario year), plus a multiply and an add for each of the 5
    # monthly means
    ops = yk.year_work(plan, num, scen, ranks, flags)[1] + (
        t * yx * 10 if scen else 0)
    return 4 * words, members * n_years * ops


# ---------------------------------------------------------------------------
# checks shared by both wrappers
# ---------------------------------------------------------------------------
def _pack_np(ppack: torch.Tensor, yd: yk.YearData) -> np.ndarray:
    """The pack's host copy, kept for the last pack object seen: a driver
    reuses one pack across its blocks, so the card syncs for it once."""
    hit = yd.cache.get("pack")
    if hit is None or hit[0] is not ppack:   # identity: holds a reference
        hit = yd.cache["pack"] = (ppack, ppack.detach().cpu().numpy())
    return hit[1]


def _check(state5: torch.Tensor, ppack: torch.Tensor, yd: yk.YearData,
           kind: str) -> int:
    """Raise for what the kernel of ``kind`` does not run (on CPU tensors
    too); return the member count."""
    yk.check_plan(yd.plan, kind, yd.flags)
    if state5.device.type not in ("cpu", "cuda"):
        raise ValueError(f"year kernels run on cuda (or plain on cpu), "
                         f"not {state5.device}")
    M = state5.shape[1]
    if tuple(ppack.shape) != (M, 1, N_PPACK):
        raise ValueError(f"ppack: want shape {(M, 1, N_PPACK)}, got "
                         f"{tuple(ppack.shape)}")
    base = yd.md.params
    rows = _pack_np(ppack, yd)[:, 0]
    for k in sorted(TRANSPORT_PARAM_KEYS):
        i = _SCALAR_FIELDS.index(k)
        if not (rows[:, i] == F32(getattr(base, k))).all():
            raise ValueError(
                f"members differ from the base params in {k!r}, a transport "
                f"parameter: the fold and the stencils' constants are built "
                f"once, from the base params")
    return M


def _shared_table(corrpack: torch.Tensor, state5: torch.Tensor,
                  yd: yk.YearData) -> bool:
    """Whether K3's corrections are one table that every member reads
    (1, T, 3, Y, X), not a table per member (M, T, 3, Y, X).  Raises for
    any other shape."""
    M, Y, X = state5.shape[1:]
    T = yd.num.nstep_yr
    k = corrpack.shape[0] if corrpack.dim() == 5 else -1
    if k not in (1, M) or tuple(corrpack.shape[1:]) != (T, 3, Y, X):
        raise ValueError(f"corrpack: want shape {(M, T, 3, Y, X)} (a table "
                         f"per member) or {(1, T, 3, Y, X)} (one shared "
                         f"table), got {tuple(corrpack.shape)}")
    return k == 1


def _member_data(row: np.ndarray, yd: yk.YearData) -> core.ModelData:
    """The model data of one member: its params and the pack's caps."""
    p, (cap_ocean, cap_land, cap_air) = member_params(row)
    derived = dataclasses.replace(yd.md.derived, cap_ocean=cap_ocean,
                                  cap_land=cap_land, cap_air=cap_air)
    return dataclasses.replace(yd.md, params=p, derived=derived)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def fluxcorr_years_plain(state5: torch.Tensor, ppack: torch.Tensor, co2,
                         yd: yk.YearData):
    """One spin-up year per member: (state5 (5, M, Y, X), corr
    (M, T, 3, Y, X))."""
    rows = _pack_np(ppack, yd)[:, 0]
    out, corrs = torch.empty_like(state5), []
    for m, row in enumerate(rows):
        s, c = core.run_year_fluxcorr(ModelState.unstack(state5[:, m]),
                                      yd.sfx, F32(co2), _member_data(row, yd),
                                      yd.num, yd.fold, yd.exp)
        out[:, m] = s.stack()
        corrs.append(torch.stack([c.tf, c.tof, c.qf], dim=1))
    return out, torch.stack(corrs)


def scenario_years_plain(state5: torch.Tensor, ppack: torch.Tensor,
                         corrpack: torch.Tensor, co2_years, yd: yk.YearData):
    """``n_years`` scenario years per member: (state5, monthly
    (M, 12 * n_years, 5, Y, X), asum (M, n_years, 9, Y, X)).  Monthly
    means add w * fields step by step from 0 at each month's first step,
    and the annual sums add the 9 outputs from 0 at each year's start, as
    the kernel does.  A (1, T, 3, Y, X) ``corrpack`` is every member's."""
    num, dev = yd.num, state5.device
    shared = _shared_table(corrpack, state5, yd)
    co2s = np.asarray(torch.as_tensor(co2_years).cpu(), F32).reshape(-1)
    M, ny, nmon = state5.shape[1], len(co2s), len(num.jday_mon)
    mon_idx, _ = month_maps(num)
    _, w = _maps_on(yd, dev)
    shape = tuple(state5.shape[2:])
    out = torch.empty_like(state5)
    monthly = torch.empty((M, ny * nmon, core.N_OUT) + shape,
                          dtype=torch.float32, device=dev)
    asum = torch.empty((M, ny, yk.N_SUM) + shape, dtype=torch.float32,
                       device=dev)
    for m, row in enumerate(_pack_np(ppack, yd)[:, 0]):
        md = _member_data(row, yd)
        state = ModelState.unstack(state5[:, m])
        corr = corrpack[0 if shared else m]
        for y, co2 in enumerate(co2s):
            acc = torch.zeros((yk.N_SUM,) + shape, dtype=torch.float32,
                              device=dev)
            for t in range(num.nstep_yr):
                state, o = core.scenario_step(
                    state, yd.sfx.at(t), tuple(corr[t].unbind(0)), co2, md,
                    num, yd.fold, yd.exp)
                slot = monthly[m, y * nmon + mon_idx[t]]
                if t == 0 or mon_idx[t - 1] != mon_idx[t]:
                    slot.zero_()
                slot.copy_(slot + w[t] * torch.stack(o[:core.N_OUT]))
                acc += torch.stack(o)
            asum[m, y] = acc
        out[:, m] = state.stack()
    return out, monthly, asum


def _launch_members(fn_name: str, yd: yk.YearData, args: yk._Args,
                    params: yk._Params, dev: torch.device,
                    cluster: int) -> None:
    """Launch K4 or K3 (``fn_name``) on ``cluster``-block clusters for
    ``args.M`` members: the refined instantiation for a plan it runs
    (``is_refined``; the wide form with its halo slots)."""
    extra, scratch = (), ()
    if yk.is_refined(yd.plan):
        fn_name = yk.refined_launcher(fn_name, yd.plan)
        g = yk._refined_args(yd, dev)
        if g.groups > 1:
            scratch = yk._wide_args(g, args.M, args.X, dev)
        extra = (g,)
    yk._launch(fn_name, args, params, dev, _pack_cols(), *extra,
               ctypes.c_int(cluster))
    del scratch     # held through the enqueue: g has only their pointers


def _member_launches(yd: yk.YearData, kind: str, M: int):
    """The member ranges [m0, m1) that the launches of ``kind`` take: all
    M members in one launch, or for the wide form as many as the card runs
    at once (``year_kernel.check_resident``, which refuses where not even
    one fits), one launch after another."""
    if not yk.is_refined(yd.plan):
        return [(0, M)]
    groups = yk.refined_groups(yd.plan)
    if groups == 1:
        return [(0, M)]
    k = yk.check_resident(groups, yk.wide_capacity(yd, kind), M)
    return [(m0, min(M, m0 + k)) for m0 in range(0, M, k)]


def _member_slice(state5: torch.Tensor, state_out: torch.Tensor, m0: int,
                  m1: int):
    """(input, output) state of members [m0, m1) for one launch: the
    whole tensors for all members, else a contiguous copy of their input
    and an output that the caller copies back into ``state_out``."""
    if (m0, m1) == (0, state5.shape[1]):
        return state5, state_out
    s_in = state5[:, m0:m1].contiguous()
    return s_in, torch.empty_like(s_in)


def _coeff_scratch(M: int, Y: int, X: int, dev: torch.device):
    """The step's coefficient planes of each member (M, 12, 2, Y, X), za 7,
    mc 4, c0m 1, in global memory: K3's one-block body and the refined
    instantiation."""
    return (torch.empty((M, 12, 2, Y, X), dtype=torch.float32, device=dev),
            None)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def fluxcorr_years(state5: torch.Tensor, ppack: torch.Tensor, co2,
                   yd: yk.YearData, cluster: Optional[int] = None):
    """One spin-up year for each member: (state5 (5, M, Y, X), corr
    (M, T, 3, Y, X)).  On the card each member runs on a cluster of
    ``cluster`` blocks (default: ``default_cluster``)."""
    M = _check(state5, ppack, yd, "fluxcorr")
    if cluster is not None:
        yk._check_cluster(cluster, "fluxcorr", yd.plan)
    dev = state5.device
    if dev.type == "cpu":
        return fluxcorr_years_plain(state5, ppack, co2, yd)
    params = yk._params(yd, co2)
    if cluster is None:
        cluster = _default_cluster_on(yd, "fluxcorr", M)
    yk.block_layout(yd.plan, cluster, "fluxcorr")
    T, Y, X = yd.num.nstep_yr, state5.shape[2], state5.shape[3]
    state_out = torch.empty_like(state5)
    corr = torch.empty((M, T, 3, Y, X), dtype=torch.float32, device=dev)
    for m0, m1 in _member_launches(yd, "fluxcorr", M):
        n = m1 - m0
        s_in, s_out = _member_slice(state5, state_out, m0, m1)
        scratch = {}
        if yk.is_refined(yd.plan) and yd.fold is not None:
            scratch["cf"] = _coeff_scratch(n, Y, X, dev)
        args = yk._args(
            yd, s_in, ints=dict(M=n, corr_step=3 * Y * X, n_pack=N_PPACK),
            state_in=(s_in, (5, n, Y, X)), state_out=(s_out, None),
            tf=(corr[m0:m1], None), ppack=(ppack[m0:m1], (n, 1, N_PPACK)),
            **scratch)
        args.tof = args.tf + 4 * Y * X
        args.qf = args.tf + 8 * Y * X
        # dt and CO2 from the host; the pack overrides the physics per
        # member
        _launch_members("greb_fluxcorr_years", yd, args, params, dev,
                        cluster)
        fluxcorr_years.launches += 1
        if s_out is not state_out:
            state_out[:, m0:m1] = s_out
    return state_out, corr


def scenario_years(state5: torch.Tensor, ppack: torch.Tensor,
                   corrpack: torch.Tensor, co2_years, yd: yk.YearData,
                   cluster: Optional[int] = None):
    """``n_years`` scenario years for each member, one CO2 value per year
    (an array, or a float32 tensor on the state's device): (state5,
    monthly (M, 12 * n_years, 5, Y, X), asum (M, n_years, 9, Y, X)).
    ``corrpack`` is a table per member (M, T, 3, Y, X) or one table for all
    (1, T, 3, Y, X).  On the card each member runs on a cluster of
    ``cluster`` blocks, or with ``cluster=1`` on one block (default:
    ``default_cluster``)."""
    M = _check(state5, ppack, yd, "scenario_years")
    shared = _shared_table(corrpack, state5, yd)
    if cluster is not None:
        if cluster == 1 and yd.transport == "strict":
            raise NotImplementedError(
                f"scenario_years: the one-block body (cluster=1) does not "
                f"run the strict transport ({yk.STRICT_ONE_BLOCK_ITEM})")
        yk._check_cluster(cluster, "scenario_years", yd.plan)
    dev = state5.device
    if dev.type == "cpu":
        return scenario_years_plain(state5, ppack, corrpack, co2_years, yd)
    params = yk._params(yd, 0.0)    # each year's CO2 comes from the table
    if cluster is None:
        cluster = _default_cluster_on(yd, "scenario_years", M)
    num = yd.num
    T, Y, X, nmon = num.nstep_yr, state5.shape[2], state5.shape[3], \
        len(num.jday_mon)
    scratch = {}
    if cluster == 1:
        yk.check_block_fit(yd.plan)
    else:
        yk.block_layout(yd.plan, cluster, "scenario_years")
    co2t = torch.as_tensor(co2_years, dtype=torch.float32, device=dev)
    ny = co2t.numel()
    state_out = torch.empty_like(state5)
    monthly = torch.empty((M, ny * nmon, core.N_OUT, Y, X),
                          dtype=torch.float32, device=dev)
    asum = torch.empty((M, ny, yk.N_SUM, Y, X), dtype=torch.float32,
                       device=dev)
    mon, w = _maps_on(yd, dev)
    for m0, m1 in _member_launches(yd, "scenario_years", M):
        n = m1 - m0
        s_in, s_out = _member_slice(state5, state_out, m0, m1)
        if cluster == 1 or (yk.is_refined(yd.plan) and yd.fold is not None):
            scratch["cf"] = _coeff_scratch(n, Y, X, dev)
        args = yk._args(
            yd, s_in,
            ints=dict(M=n, n_years=ny, corr_step=3 * Y * X,
                      corr_shared=int(shared), n_pack=N_PPACK),
            state_in=(s_in, (5, n, Y, X)), state_out=(s_out, None),
            tf=(corrpack if shared else corrpack[m0:m1], None),
            ppack=(ppack[m0:m1], (n, 1, N_PPACK)), co2_years=(co2t, (ny,)),
            mon=(mon, (T,), torch.int32), mon_w=(w, (T,)),
            monthly=(monthly[m0:m1], None), asum=(asum[m0:m1], None),
            **scratch)
        args.tof = args.tf + 4 * Y * X
        args.qf = args.tf + 8 * Y * X
        # the pack overrides the physics per member
        _launch_members("greb_scenario_years", yd, args, params, dev,
                        cluster)
        scenario_years.launches += 1
        if s_out is not state_out:
            state_out[:, m0:m1] = s_out
    return state_out, monthly, asum


fluxcorr_years.launches = 0
scenario_years.launches = 0
