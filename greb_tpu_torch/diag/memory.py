"""Device / host memory accounting for run planning
(``greb_tpu.diag.memory``; BASELINE config 5).

The reference simply allocates everything statically (13 forcing fields at
96x48x730 ~= 175 MB, SURVEY §6); at 768x384 the same layout is ~11 GB and
must be budgeted against one card's memory or sharded along latitude
(parallel/sharded.py cuts each shard's rows).  This module computes those
budgets from the Numerics so tests and callers can check a configuration
fits before building it.

With one shard the report equals greb_tpu's field by field.  With
``n_shards > 1`` it reports what the port's sharded fold holds, which is
not greb_tpu's per-shard slot layout (ROADMAP, "Not to port"): each shard
keeps the composites of its own composite rows only (``fastcirc2.cut_const``
of the unsharded fold), so the pole shards hold them and the others none,
and there are no advection level masks (the cut plans carry the polar
segments).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..config import Numerics

_B = 4  # float32 everywhere on the state/forcing path


@dataclass(frozen=True)
class MemoryReport:
    """All sizes in bytes; ``per_shard_total`` is the largest shard's."""
    forcing: int            # 7x(t,y,x) + sw_solar (t,y) + 2 static (y,x)
    wind_splits: int        # uclim_m/p, vclim_m/p equivalents (built on the
    #                         fly per step here — 0 resident; the reference
    #                         keeps all four, src/greb.f90:109-120)
    corrections: int        # 3x(t,y,x)
    state: int              # 5x(y,x) per member
    fastcirc: int           # zd/zam/mer/wz coefficient fields (2 transported)
    monthly_out: int        # (12,5,y,x) accumulators per member
    total: int
    per_shard_total: int
    n_members: int
    n_shards: int
    detail: Dict[str, int] = field(default_factory=dict)
    # non-empty when the configuration cannot build at all (the
    # extension-mode CFL check rejects dt_crcl, or the rows do not split
    # into n_shards shards): the report still carries the grid-independent
    # budgets so planning callers can see them
    infeasible_reason: str = ""

    def fits(self, hbm_bytes: Optional[int] = None, headroom: float = 0.75,
             device=None) -> bool:
        """Whether the largest shard's resident set fits in ``hbm_bytes``
        with ``headroom``.  ``hbm_bytes`` None: the memory of the card
        ``device`` (None means CUDA; raises without a card).  The headroom
        is greb_tpu's assumption for scratch, temporaries and output
        staging, not a number measured on the card."""
        if hbm_bytes is None:
            dev = resolve_device(device)
            if dev.type != "cuda":
                raise ValueError(f"fits: {dev} is not a card; pass "
                                 f"hbm_bytes")
            hbm_bytes = torch.cuda.get_device_properties(dev).total_memory
        return self.per_shard_total <= hbm_bytes * headroom


def _fmt(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def _shard_composites(num: Numerics, n_shards: int):
    """(bytes of each shard's composites, why the grid cannot build or
    "").  A shard holds its composite rows' dense (F, k, X, X) matrices or,
    packed, their SVD factors, budgeted at the full rank X a row (the rank
    is data-dependent) plus each row's alignment to COMP_BLOCK columns."""
    from ..grid import make_grid
    from ..ops import fastcirc2 as fc2

    x, F = num.xdim, 2
    try:
        geo = fc2.sharded_geometry(make_grid(x, num.ydim, num.dt_crcl),
                                   n_shards)
    except ValueError as e:
        return [0] * n_shards, str(e)
    out = []
    for k in (t + b for t, b in zip(geo.kct, geo.kcb)):
        if geo.comp_mode == "dense":
            out.append(F * k * x * x * _B)
        elif geo.comp_mode == "lowrank":
            cols = F * k * (x + fc2.COMP_BLOCK - 1)
            out.append((2 * x + F * k) * cols * _B)   # pcu, pcw, pmask
        else:
            out.append(0)
    return out, ""


def memory_report(num: Numerics, n_members: int = 1,
                  n_shards: int = 1) -> MemoryReport:
    """Resident-array accounting for a run shape.

    Everything time-indexed shards along latitude ('y'); members multiply
    only the per-member state/outputs (forcing and coefficients are shared
    across members on a card, parallel/ensemble.py).  When ``n_shards > 1``
    each shard's composites (``_shard_composites``, from
    ``fastcirc2.sharded_geometry``) are added, and ``per_shard_total`` is
    the largest shard's: its even share of the rest plus its composites.
    """
    from ..ops import fastcirc2 as fc2

    t, y, x = num.nstep_yr, num.ydim, num.xdim
    cell = y * x * _B
    forcing = 7 * t * cell + t * y * _B + 2 * cell
    corrections = 3 * t * cell
    state = n_members * 5 * cell
    # fastcirc2.Fast2Const coefficient planes, derived from the fold itself
    fastcirc = fc2.N_COEF_PLANES * 2 * cell
    monthly = n_members * 12 * 5 * cell
    base = forcing + corrections + state + fastcirc + monthly
    comps, infeasible = [0], ""
    if n_shards > 1:
        comps, infeasible = _shard_composites(num, n_shards)
    composites = sum(comps)
    total = base + composites
    per_shard = base // max(n_shards, 1) + max(comps)
    detail = {
        "one (t,y,x) field": t * cell,
        "forcing (7 clim + solar + 2 static)": forcing,
        "corrections (3x730-slot tables)": corrections,
        f"state (5 fields x {n_members} members)": state,
        "fastcirc coefficient fields": fastcirc,
        "monthly-mean outputs": monthly,
    }
    if composites:
        detail["sharded composites (each shard's rows)"] = composites
    return MemoryReport(forcing=forcing, wind_splits=0,
                        corrections=corrections, state=state,
                        fastcirc=fastcirc, monthly_out=monthly, total=total,
                        per_shard_total=per_shard, n_members=n_members,
                        n_shards=n_shards, detail=detail,
                        infeasible_reason=infeasible)


def format_report(rep: MemoryReport) -> str:
    lines = [f"memory report ({rep.n_members} members, "
             f"{rep.n_shards} latitude shards):"]
    for k, v in rep.detail.items():
        lines.append(f"  {k:40s} {_fmt(v)}")
    lines.append(f"  {'TOTAL (global)':40s} {_fmt(rep.total)}")
    lines.append(f"  {'per shard':40s} {_fmt(rep.per_shard_total)}")
    if rep.infeasible_reason:
        lines.append(f"  NOTE: configuration cannot build "
                     f"(composite block omitted): {rep.infeasible_reason}")
    return "\n".join(lines)
