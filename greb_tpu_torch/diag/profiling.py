"""Tracing / profiling / runtime-health subsystem
(``greb_tpu.diag.profiling``).

The reference has no observability beyond an unused gprof flag and three
timer variables (Makefile:10, src/greb.f90:126; SURVEY §5).  Here:

- ``phase_timer``   : wall-clock per-phase timing with derived throughput
                      (sim-yr/s, grid-point-steps/s).
- ``trace``         : context manager around ``torch.profiler`` writing a
                      TensorBoard-loadable trace (CPU activities, and the
                      card's when the device is CUDA).
- ``check_finite``  : runtime NaN/Inf detection over a nest of dataclasses,
                      NamedTuples, dicts, lists, tuples and tensors (the
                      equivalent of the reference debug build's
                      ``-ffpe-trap``), raising with the offending leaf
                      names as greb_tpu names them.
- ``RunMetrics``    : accumulates per-year scalars (global-mean Ts, CO2,
                      wall time) and serializes to JSONL for dashboards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclass
class PhaseStats:
    name: str
    wall_s: float
    sim_years: int = 0
    grid_points: int = 0
    steps_per_year: int = 0

    @property
    def sim_yr_per_s(self) -> float:
        return self.sim_years / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def point_steps_per_s(self) -> float:
        return (self.grid_points * self.steps_per_year * self.sim_years
                / self.wall_s) if self.wall_s > 0 else 0.0


class phase_timer(contextlib.AbstractContextManager):
    """with phase_timer("scenario", sim_years=50, num=num) as t: ...
    -> t.stats has throughput numbers after the block.  The wall clock is
    the host's: synchronize the card inside the block to time its work."""

    def __init__(self, name: str, sim_years: int = 0, num=None,
                 verbose: bool = False):
        self.name = name
        self.sim_years = sim_years
        self.num = num
        self.verbose = verbose
        self.stats: Optional[PhaseStats] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        gp = (self.num.xdim * self.num.ydim) if self.num else 0
        spy = self.num.nstep_yr if self.num else 0
        self.stats = PhaseStats(self.name, wall, self.sim_years, gp, spy)
        if self.verbose:
            s = self.stats
            print(f"% [{s.name}] {s.wall_s:.2f}s"
                  + (f" | {s.sim_yr_per_s:.2f} sim-yr/s"
                     f" | {s.point_steps_per_s:.3e} point-steps/s"
                     if s.sim_years else ""))
        return False


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """A ``torch.profiler`` trace of the block, written to ``log_dir`` by
    ``tensorboard_trace_handler`` (view with TensorBoard).  ``device``:
    None means CUDA (raises without a card); a CUDA device adds the card's
    activities to the host's."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _leaves(tree, path: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) of every leaf of ``tree``, each path as
    ``jax.tree_util.keystr`` spells greb_tpu's: ``.name`` for a dataclass
    field or a NamedTuple member, ``['key']`` for a dict key (keys in
    sorted order), ``[i]`` for a list or tuple item; None is no leaf."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{k}", getattr(tree, k)) for k in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    return [leaf for k, v in items for leaf in _leaves(v, path + k)]


def check_finite(tree, name: str = "state") -> None:
    """Raise FloatingPointError naming every non-finite leaf, in greb_tpu's
    words (``state@yr3.ts: 6 non-finite``).  The runtime analog of the
    reference debug build's FPE traps (Makefile:10).  A tensor leaf counts
    its non-finite values where it lives, one reduction a leaf, and the
    counts reach the host in one copy a device."""
    leaves = _leaves(tree)
    counts: Dict[str, int] = {}
    on_device: Dict[torch.device, List[Tuple[str, torch.Tensor]]] = {}
    for path, leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            bad = (~torch.isfinite(leaf.detach())).sum()
            on_device.setdefault(leaf.device, []).append((path, bad))
        else:
            counts[path] = int((~np.isfinite(np.asarray(leaf))).sum())
    for pairs in on_device.values():
        host = torch.stack([c for _, c in pairs]).tolist()
        counts.update((p, n) for (p, _), n in zip(pairs, host))
    bad = [f"{name}{p}: {counts[p]} non-finite"
           for p, _ in leaves if counts[p]]
    if bad:
        raise FloatingPointError("; ".join(bad))


@dataclass
class RunMetrics:
    """Per-year scalar metrics, serializable to JSONL."""
    records: List[Dict] = field(default_factory=list)

    def log_year(self, year: int, co2: float, global_mean_ts: float,
                 wall_s: float, **extra) -> None:
        rec = dict(year=year, co2=float(co2),
                   global_mean_ts=float(global_mean_ts),
                   wall_s=float(wall_s), **extra)
        self.records.append(rec)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    @classmethod
    def load(cls, path: str) -> "RunMetrics":
        with open(path) as f:
            return cls(records=[json.loads(line) for line in f if line.strip()])
