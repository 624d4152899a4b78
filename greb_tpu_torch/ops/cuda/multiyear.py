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
Given ``mxu`` (a ``fastcirc2.MxuMembers``), both wrappers run the TPU
kernels' member-batched matmul circulation instead (greb_tpu's
``mxu_members_circulation`` in K3/K4, its ``mb`` members a kernel
instance): ``fluxcorr_years_mxu`` and ``scenario_years_mxu`` launch
csrc/members_kernel.cu, ``mb`` members on one 16-block cluster
(``members_layout``; the most that fit, ``default_mb``), at
the precision of ``mxu`` ("bf16_3x" or "highest"), for the plans it runs
(``fastcirc2.members_covered``: no segments, dense composites, additive
splitting; NotImplementedError naming ``fastcirc2.MXU_PLAN_ITEM`` for the
others, before any launch).  Their plain version is the twin of that
circulation in the kernel's order (``fastcirc2.MxuTwin``), through
``*_plain(..., mxu=...)``.

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
from ...ops import fastcirc2 as fc2
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


# float32 operations of the bf16_3x split (csrc/members_kernel.cu zonal):
# for each (field, cell, member) and substep, the 7 taps split (a round, a
# subtract, a round: 3 each) and each zonal apply's three 7-term sums (13
# each) and their two adds, against 13 for an exact apply; for each
# (field, cell) and substep the 14 coefficients split (3 each), once for
# the batch
BF16_TAPS_OPS = 7 * 3
BF16_APPLY_OPS = 3 * 13 + 2
BF16_COEF_OPS = 14 * 3


def years_work(plan, num: Numerics, n_years: int, members: int,
               kind: str, shared_corr: bool = False,
               ranks: Optional[np.ndarray] = None, flags: int = 0,
               precision: Optional[str] = None):
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
    together could all read one step's slice from L2.  ``precision``
    ("bf16_3x", "highest") counts the member-batched matmul circulation
    (the member kernels given ``mxu``): at "highest" the fold's operations,
    at "bf16_3x" the split's (BF16_*_OPS)."""
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
    batch = 0
    if precision == "bf16_3x":
        sub = t * num.nsub_crcl * 2 * yx
        ops += sub * (BF16_TAPS_OPS + 2 * (BF16_APPLY_OPS - 13))
        batch = n_years * sub * BF16_COEF_OPS
    return 4 * words, members * n_years * ops + batch


def years_work_dense(plan, num: Numerics, n_years: int, members: int,
                     kind: str, shared_corr: bool = False):
    """(bytes, float32 operations, bfloat16 operations) of a launch of
    ``kind`` in the matmul circulation at "bf16_3x" realised as greb_tpu's
    ``_dot_b`` writes it: each substep's row dot three dense bfloat16
    products (F*Y, M, X) @ (F*Y, X, 2X) on tensor cores (2 * 3 * F*Y * X *
    2X operations a member), the rest in float32: the step body less the
    fold's exact row dots (2 applies of 13 operations a field, cell and
    substep), plus each member's split of x (3) and the sum of the three
    products (2 a column, 4), and once a step for the batch the split of
    the dense (X, 2X) row matrices (3 an entry).  Bytes as ``years_work``.
    The bound of the bf16_3x form is the lesser of this realisation's and
    ``years_work(..., precision="bf16_3x")``'s."""
    nbytes, ops = years_work(plan, num, n_years, members, kind, shared_corr,
                             precision="highest")
    F, Y, X, t = 2, plan.ydim, plan.xdim, num.nstep_yr
    sub = members * n_years * t * num.nsub_crcl * F * Y * X
    f32 = (ops + sub * (3 + 4 - 2 * 13)
           + n_years * t * F * Y * X * 2 * X * 3)
    return nbytes, f32, sub * 2 * 3 * 2 * X


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
def _plain_fold(yd: yk.YearData, mxu):
    """The fold tuple of the plain versions: the run's, or with ``mxu``
    (an MxuMembers) the member kernels' matmul circulation in their own
    order (``fastcirc2.MxuTwin``), made once per run and precision."""
    if mxu is None:
        return yd.fold
    key = ("twin fold", mxu.precision)
    if key not in yd.cache:
        yd.cache[key] = tuple(yd.fold[:2]) + (fc2.MxuTwin(mxu.precision),)
    return yd.cache[key]


def _batched_member_data(ppack: torch.Tensor,
                         yd: yk.YearData) -> core.ModelData:
    """The model data of all M members at once, for the plain twin of the
    matmul circulation's member kernels, which steps the members as one
    batch: each physics parameter and heat capacity a (M, 1, 1) float32
    tensor on the pack's device (p_emi (10, M, 1, 1)), made once per run
    and pack."""
    hit = yd.cache.get("batched md")
    if hit is not None and hit[0] is ppack:
        return hit[1]
    col = lambda i: ppack[:, 0, i].reshape(-1, 1, 1).contiguous()
    p = PhysicsParams(**{f: col(i) for i, f in enumerate(_SCALAR_FIELDS)},
                      p_emi=torch.stack([col(_COL_P_EMI + k)
                                         for k in range(10)]))
    derived = dataclasses.replace(yd.md.derived, cap_ocean=col(_COL_CAPS),
                                  cap_land=col(_COL_CAPS + 1),
                                  cap_air=col(_COL_CAPS + 2))
    md = dataclasses.replace(yd.md, params=p, derived=derived)
    yd.cache["batched md"] = (ppack, md)
    return md


def _twin_fluxcorr(state5: torch.Tensor, ppack: torch.Tensor, co2,
                   yd: yk.YearData, mxu):
    """fluxcorr_years_plain's twin of the matmul circulation: the M members
    as one batch (each member's arithmetic is the per-member step's)."""
    s, c = core.run_year_fluxcorr(ModelState.unstack(state5), yd.sfx,
                                  F32(co2), _batched_member_data(ppack, yd),
                                  yd.num, _plain_fold(yd, mxu), yd.exp)
    corr = torch.stack([c.tf, c.tof, c.qf], dim=2)       # (T, M, 3, Y, X)
    return s.stack(), corr.transpose(0, 1).contiguous()


def _twin_scenario(state5: torch.Tensor, ppack: torch.Tensor,
                   corrpack: torch.Tensor, co2s: np.ndarray,
                   yd: yk.YearData, mxu):
    """scenario_years_plain's twin of the matmul circulation: the M members
    as one batch, the monthly means and annual sums added as the per-member
    loop adds them."""
    num, dev = yd.num, state5.device
    M, ny, nmon = state5.shape[1], len(co2s), len(num.jday_mon)
    mon_idx, _ = month_maps(num)
    _, w = _maps_on(yd, dev)
    shape = tuple(state5.shape[2:])
    md, fold = _batched_member_data(ppack, yd), _plain_fold(yd, mxu)
    monthly = torch.empty((M, ny * nmon, core.N_OUT) + shape,
                          dtype=torch.float32, device=dev)
    asum = torch.empty((M, ny, yk.N_SUM) + shape, dtype=torch.float32,
                       device=dev)
    state = ModelState.unstack(state5)
    for y, co2 in enumerate(co2s):
        acc = torch.zeros((M, yk.N_SUM) + shape, dtype=torch.float32,
                          device=dev)
        for t in range(num.nstep_yr):
            state, o = core.scenario_step(
                state, yd.sfx.at(t), tuple(corrpack[:, t].unbind(1)), co2,
                md, num, fold, yd.exp)
            slot = monthly[:, y * nmon + mon_idx[t]]
            if t == 0 or mon_idx[t - 1] != mon_idx[t]:
                slot.zero_()
            slot.copy_(slot + w[t] * torch.stack(o[:core.N_OUT], dim=1))
            acc += torch.stack(o, dim=1)
        asum[:, y] = acc
    return state.stack(), monthly, asum


def fluxcorr_years_plain(state5: torch.Tensor, ppack: torch.Tensor, co2,
                         yd: yk.YearData, mxu=None):
    """One spin-up year per member: (state5 (5, M, Y, X), corr
    (M, T, 3, Y, X)); with ``mxu`` the member kernels' matmul circulation
    at its precision, all members as one batch (``_twin_fluxcorr``)."""
    if mxu is not None:
        return _twin_fluxcorr(state5, ppack, co2, yd, mxu)
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
                         corrpack: torch.Tensor, co2_years, yd: yk.YearData,
                         mxu=None):
    """``n_years`` scenario years per member: (state5, monthly
    (M, 12 * n_years, 5, Y, X), asum (M, n_years, 9, Y, X)).  Monthly
    means add w * fields step by step from 0 at each month's first step,
    and the annual sums add the 9 outputs from 0 at each year's start, as
    the kernel does.  A (1, T, 3, Y, X) ``corrpack`` is every member's.
    With ``mxu`` the member kernels' matmul circulation at its precision,
    all members as one batch (``_twin_scenario``)."""
    num, dev = yd.num, state5.device
    shared = _shared_table(corrpack, state5, yd)
    co2s = np.asarray(torch.as_tensor(co2_years).cpu(), F32).reshape(-1)
    if mxu is not None:
        return _twin_scenario(state5, ppack, corrpack, co2s, yd, mxu)
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
                   yd: yk.YearData, cluster: Optional[int] = None,
                   mxu: Optional[fc2.MxuMembers] = None):
    """One spin-up year for each member: (state5 (5, M, Y, X), corr
    (M, T, 3, Y, X)).  On the card each member runs on a cluster of
    ``cluster`` blocks (default: ``default_cluster``); given ``mxu``, the
    member-batched matmul circulation (``fluxcorr_years_mxu``)."""
    if mxu is not None:
        _check_members_cluster(cluster)
        return fluxcorr_years_mxu(state5, ppack, co2, yd, mxu)
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
                   cluster: Optional[int] = None,
                   mxu: Optional[fc2.MxuMembers] = None):
    """``n_years`` scenario years for each member, one CO2 value per year
    (an array, or a float32 tensor on the state's device): (state5,
    monthly (M, 12 * n_years, 5, Y, X), asum (M, n_years, 9, Y, X)).
    ``corrpack`` is a table per member (M, T, 3, Y, X) or one table for all
    (1, T, 3, Y, X).  On the card each member runs on a cluster of
    ``cluster`` blocks, or with ``cluster=1`` on one block (default:
    ``default_cluster``); given ``mxu``, the member-batched matmul
    circulation (``scenario_years_mxu``)."""
    if mxu is not None:
        _check_members_cluster(cluster)
        return scenario_years_mxu(state5, ppack, corrpack, co2_years, yd,
                                  mxu)
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


# ---------------------------------------------------------------------------
# the member-batched matmul circulation (csrc/members_kernel.cu)
# ---------------------------------------------------------------------------
# the cluster size of the member kernels' matmul circulation; the most
# members a cluster (csrc/members_kernel.cu MAX_MB); the parts of a block's
# shared memory in the kernel's layout order (MemberPart): shared by the
# batch, then each member's; the most threads a block (MEMBER_NT)
MEMBERS_CLUSTER = 16
MAX_MB = 8
MEMBER_PARTS = ("coeffs", "zd", "wz", "pcomp", "params", "state",
                "transported", "asum", "monthly", "comp_rows",
                "comp_partials")
MEMBER_THREADS = 640
# bytes of the kernel's GrebParams, a member's physics (rounded to 16)
_PARAMS_BYTES = 128
_KIND_CODE = {"fluxcorr": 0, "scenario_years": 2}   # enum Kind
_PREC_CODE = {"highest": 0, "bf16_3x": 1}            # enum MxuPrecision


def members_layout(plan, mb: int, kind: str,
                   blocks: int = MEMBERS_CLUSTER) -> yk.ClusterLayout:
    """The shared memory of each block of a ``blocks``-block cluster that
    runs ``mb`` members of the member kernel of ``kind`` ("fluxcorr": K4,
    "scenario_years": K3) in the matmul circulation (csrc/members_kernel.cu
    ``members_parts``, the same reckoning): once for the batch, the step's
    12 coefficient planes, the 7 zd planes, wz and the composite matrices of
    the pole rows a block holds (``year_kernel.cluster_layout``'s parts);
    for each member its physics, state, (Ta, q) double buffer with halo
    rows, (K3) annual sums and month's means, composite rows and partial
    sums.  ``threads``: one per (field, cell) of the block's rows, at most
    MEMBER_THREADS.  Raises ValueError where ``mb`` is outside
    1..MAX_MB, the cluster body has no layout (``cluster_layout``'s
    checks) or a block needs more than MAX_SMEM_BYTES."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: one of {KINDS}")
    if not 1 <= mb <= MAX_MB:
        raise ValueError(f"mb={mb}: the member kernels run 1..{MAX_MB} "
                         f"members a cluster")
    one = dict(yk._cluster_parts(plan, blocks, kind).parts)
    per = ("state", "transported", "asum", "monthly", "comp_rows",
           "comp_partials")
    nbytes = dict(coeffs=one["coeffs"], zd=one["zd"], wz=one["wz"],
                  pcomp=one["pcomp"], params=mb * _PARAMS_BYTES,
                  **{n: mb * one[n] for n in per})
    R, X = plan.ydim // blocks, plan.xdim
    lay = yk.ClusterLayout(
        blocks=blocks, rows=R, comp_rows=one["pcomp"] // (8 * X * X),
        threads=min(MEMBER_THREADS, -(-2 * R * X // 32) * 32),
        parts=tuple((n, nbytes[n]) for n in MEMBER_PARTS))
    if lay.nbytes > yk.MAX_SMEM_BYTES:
        raise ValueError(f"{kind}: {mb} members a cluster of {blocks} "
                         f"blocks at {plan.xdim}x{plan.ydim} need "
                         f"{lay.nbytes} B of shared memory a block, over "
                         f"{yk.MAX_SMEM_BYTES} B")
    return lay


def default_mb(plan, kind: str) -> int:
    """The most members a cluster that ``members_layout`` holds (96x48: K3
    2, K4 4); ValueError where not even one fits."""
    for mb in range(MAX_MB, 0, -1):
        try:
            members_layout(plan, mb, kind)
            return mb
        except ValueError:
            continue
    raise ValueError(f"{kind}: not one member of the matmul circulation "
                     f"fits a block at {plan.xdim}x{plan.ydim}")


def kernel_members_layout(plan, mb: int, kind: str):
    """The kernel's own reckoning of a member block (csrc/members_kernel.cu
    ``greb_members_layout``, built on first use): ({part: bytes}, threads),
    for holding against ``members_layout``."""
    lib = yk._members_lib()
    parts = (ctypes.c_longlong * len(MEMBER_PARTS))()
    total = lib.greb_members_layout(plan.ydim, plan.xdim, plan.comp_kt,
                                    plan.comp_kb, MEMBERS_CLUSTER,
                                    _KIND_CODE[kind], mb, parts)
    if total <= 0:
        raise ValueError(f"the kernel has no member layout for mb={mb}")
    return (dict(zip(MEMBER_PARTS, parts)),
            lib.greb_members_threads(plan.ydim, plan.xdim, MEMBERS_CLUSTER))


def members_capacity(plan, mb: int, kind: str) -> int:
    """How many clusters of the member kernel of ``kind`` with ``mb``
    members the card runs at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = yk._members_lib()
    n = ctypes.c_int()
    err = lib.greb_members_capacity(plan.ydim, plan.xdim, plan.comp_kt,
                                    plan.comp_kb, MEMBERS_CLUSTER,
                                    _KIND_CODE[kind], mb, ctypes.byref(n))
    if err:
        raise RuntimeError(f"member cluster capacity, {kind}, mb={mb}: "
                           f"{yk._lib().greb_error_string(err).decode()}")
    return n.value


def _check_members_cluster(cluster: Optional[int]) -> None:
    if cluster not in (None, MEMBERS_CLUSTER):
        raise ValueError(f"cluster={cluster}: the matmul circulation's "
                         f"member kernels launch on clusters of "
                         f"{MEMBERS_CLUSTER} blocks")


def _check_mxu(mxu: fc2.MxuMembers, yd: yk.YearData, kind: str) -> int:
    """Raise for what the member kernels of the matmul circulation do not
    run (on CPU tensors too): a plan ``fastcirc2.members_covered`` refuses
    or the refined instantiation runs (NotImplementedError, MXU_PLAN_ITEM),
    a precision other than MEMBER_PRECISIONS, matrices that are not the
    run's fold densified (``fastcirc2.build_mxu``; compared once per run
    and object), a plan where not one member fits a block.  Returns the
    members a cluster, ``default_mb``."""
    yk.check_plan(yd.plan, kind, yd.flags)
    if yd.transport != "fold":
        raise NotImplementedError(
            f"the matmul circulation moves Ta and q with the fold, not the "
            f"{yd.transport} transport ({fc2.MXU_PLAN_ITEM})")
    fc2.check_members_plan(yd.plan)
    if yk.is_refined(yd.plan):
        raise NotImplementedError(
            f"the matmul circulation's member kernels run the cluster "
            f"body's plans, not the refined instantiation's "
            f"({fc2.MXU_PLAN_ITEM})")
    if mxu.precision not in fc2.MEMBER_PRECISIONS:
        raise ValueError(f"mxu precision {mxu.precision!r}: one of "
                         f"{fc2.MEMBER_PRECISIONS}")
    key = ("mxu", id(mxu))
    if key not in yd.cache:
        want = fc2.build_mxu(yd.fold[1], yd.plan, "highest")
        dev = mxu.zd_mat.device
        if not (torch.equal(mxu.zd_mat, want.zd_mat.to(dev))
                and torch.equal(mxu.shift1h, want.shift1h.to(dev))):
            raise ValueError("mxu: its matrices are not this run's fold "
                             "densified (fastcirc2.build_mxu_members)")
        yd.cache[key] = mxu        # holds it: no id is reused
    return default_mb(yd.plan, kind)


def _launch_mxu(fn_name: str, yd: yk.YearData, args: yk._Args,
                params: yk._Params, dev: torch.device, mxu: fc2.MxuMembers,
                mb: int) -> None:
    yk._launch(fn_name, args, params, dev, _pack_cols(),
               ctypes.c_int(_PREC_CODE[mxu.precision]),
               ctypes.c_int(mb), ctypes.c_int(MEMBERS_CLUSTER))


def fluxcorr_years_mxu(state5: torch.Tensor, ppack: torch.Tensor, co2,
                       yd: yk.YearData, mxu: fc2.MxuMembers):
    """``fluxcorr_years`` in the member-batched matmul circulation at
    ``mxu.precision``: on the card ceil(M / mb) clusters of
    MEMBERS_CLUSTER blocks, mb = ``default_mb`` members each (the last
    cluster runs M mod mb members where mb does not divide M), in waves
    past the card's capacity; on a CPU tensor the plain twin."""
    M = _check(state5, ppack, yd, "fluxcorr")
    mb = _check_mxu(mxu, yd, "fluxcorr")
    dev = state5.device
    if dev.type == "cpu":
        return fluxcorr_years_plain(state5, ppack, co2, yd, mxu)
    params = yk._params(yd, co2)
    T, Y, X = yd.num.nstep_yr, state5.shape[2], state5.shape[3]
    state_out = torch.empty_like(state5)
    corr = torch.empty((M, T, 3, Y, X), dtype=torch.float32, device=dev)
    args = yk._args(
        yd, state5, ints=dict(M=M, corr_step=3 * Y * X, n_pack=N_PPACK),
        state_in=(state5, (5, M, Y, X)), state_out=(state_out, None),
        tf=(corr, None), ppack=(ppack, (M, 1, N_PPACK)))
    args.tof = args.tf + 4 * Y * X
    args.qf = args.tf + 8 * Y * X
    _launch_mxu("greb_fluxcorr_years_mxu", yd, args, params, dev, mxu, mb)
    fluxcorr_years_mxu.launches += 1
    return state_out, corr


def scenario_years_mxu(state5: torch.Tensor, ppack: torch.Tensor,
                       corrpack: torch.Tensor, co2_years, yd: yk.YearData,
                       mxu: fc2.MxuMembers):
    """``scenario_years`` in the member-batched matmul circulation at
    ``mxu.precision``: on the card ceil(M / mb) clusters of
    MEMBERS_CLUSTER blocks, mb = ``default_mb`` members each (the last
    cluster runs M mod mb members where mb does not divide M), in waves
    past the card's capacity; on a CPU tensor the plain twin."""
    M = _check(state5, ppack, yd, "scenario_years")
    shared = _shared_table(corrpack, state5, yd)
    mb = _check_mxu(mxu, yd, "scenario_years")
    dev = state5.device
    if dev.type == "cpu":
        return scenario_years_plain(state5, ppack, corrpack, co2_years, yd,
                                    mxu)
    params = yk._params(yd, 0.0)    # each year's CO2 comes from the table
    num = yd.num
    T, Y, X, nmon = num.nstep_yr, state5.shape[2], state5.shape[3], \
        len(num.jday_mon)
    co2t = torch.as_tensor(co2_years, dtype=torch.float32, device=dev)
    ny = co2t.numel()
    state_out = torch.empty_like(state5)
    monthly = torch.empty((M, ny * nmon, core.N_OUT, Y, X),
                          dtype=torch.float32, device=dev)
    asum = torch.empty((M, ny, yk.N_SUM, Y, X), dtype=torch.float32,
                       device=dev)
    mon, w = _maps_on(yd, dev)
    args = yk._args(
        yd, state5,
        ints=dict(M=M, n_years=ny, corr_step=3 * Y * X,
                  corr_shared=int(shared), n_pack=N_PPACK),
        state_in=(state5, (5, M, Y, X)), state_out=(state_out, None),
        tf=(corrpack, None), ppack=(ppack, (M, 1, N_PPACK)),
        co2_years=(co2t, (ny,)), mon=(mon, (T,), torch.int32),
        mon_w=(w, (T,)), monthly=(monthly, None), asum=(asum, None))
    args.tof = args.tf + 4 * Y * X
    args.qf = args.tf + 8 * Y * X
    _launch_mxu("greb_scenario_years_mxu", yd, args, params, dev, mxu, mb)
    scenario_years_mxu.launches += 1
    return state_out, monthly, asum


fluxcorr_years.launches = 0
scenario_years.launches = 0
fluxcorr_years_mxu.launches = 0
scenario_years_mxu.launches = 0
