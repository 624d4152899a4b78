"""Checkpoint and resume (``greb_tpu.io.checkpoint``).

The reference has no checkpoints: its state lives in Fortran module arrays,
so a crash loses the run.  A checkpoint here holds everything a bit-exact
restart of the scenario phase needs:

  - the prognostic ``ModelState`` (ts, ta, to, q, cap_surf);
  - the ``Corrections`` tables learned in the spin-up;
  - a ``RunCursor``: (phase, year_index, co2).

On disk it is the JAX package's npz layout: ``ckpt_{step:06d}/state.npz``
with the arrays ``ts ta to q cap_surf tf tof qf`` and ``cursor.json``, so
a checkpoint written by either package loads in the other.  The
``Checkpointer`` commits each save atomically (a temporary directory, then
``os.replace``) on a background thread, and keeps the newest ``keep``
checkpoints, as the JAX package's default orbax path does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..forcing import Corrections, ModelState

_PREFIX = "ckpt_"


@dataclass
class RunCursor:
    phase: str = "scenario"     # "flux" | "control" | "scenario"
    year_index: int = 0
    co2: float = 680.0


def _host(a) -> np.ndarray:
    """A host copy that later in-place changes of ``a`` do not reach."""
    return np.array(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _write(path: str, arrays: Dict[str, np.ndarray],
           cursor: RunCursor) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "cursor.json"), "w") as f:
        json.dump({"phase": cursor.phase, "year_index": cursor.year_index,
                   "co2": cursor.co2}, f)


def _arrays(state: ModelState, corr_np: Dict[str, np.ndarray]):
    out = {k: _host(getattr(state, k)) for k in ModelState.FIELDS}
    out.update(corr_np)
    return out


def _gathered(v):
    """A sharded value (parallel/sharded.py ``Sharded``: the rows of a
    mesh's shards) as the whole value on the host; anything else as it
    is."""
    return v.gather() if hasattr(v, "gather") else v


def _corr_np(corr: Corrections) -> Dict[str, np.ndarray]:
    return {k: _host(getattr(corr, k)) for k in ("tf", "tof", "qf")}


def save_checkpoint(path: str, state: ModelState, corr: Corrections,
                    cursor: RunCursor) -> None:
    """Write one checkpoint directory (not atomic; see Checkpointer)."""
    _write(path, _arrays(state, _corr_np(corr)), cursor)


def load_checkpoint(path: str, device="cpu"
                    ) -> Tuple[ModelState, Corrections, RunCursor]:
    with np.load(os.path.join(path, "state.npz")) as z:
        t = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    state = ModelState(**{k: t[k] for k in ModelState.FIELDS})
    corr = Corrections(tf=t["tf"], tof=t["tof"], qf=t["qf"])
    with open(os.path.join(path, "cursor.json")) as f:
        cursor = RunCursor(**json.load(f))
    return state, corr, cursor


class Checkpointer:
    """Periodic checkpoints with retention.

    ``save`` snapshots to the host at once, so the caller may go on
    changing the state; the file write runs on a background thread and is
    committed by renaming a finished temporary directory, so a crash in
    the middle of a write leaves the previous checkpoints whole.  Call
    ``wait_until_finished`` before the process ends (``run_long`` does).
    """

    def __init__(self, directory: str, every_years: int = 10, keep: int = 3):
        self.dir = directory
        self.every = max(1, every_years)
        self.keep = keep
        # the correction tables are constant across the scenario phase
        # (learned once in the spin-up), so their 40 MB device-to-host copy
        # (at 96x48) is made once per tables object
        self._corr_ref = None
        self._corr_np = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, year_index: int, state: ModelState,
                   corr: Corrections, cursor: RunCursor) -> bool:
        if (year_index + 1) % self.every != 0:
            return False
        self.save(year_index, state, corr, cursor)
        return True

    def save(self, step: int, state: ModelState, corr: Corrections,
             cursor: RunCursor) -> None:
        if corr is not self._corr_ref:   # identity, not id(): holds a ref
            self._corr_np = _corr_np(_gathered(corr))
            self._corr_ref = corr
        arrays = _arrays(_gathered(state), self._corr_np)
        self.wait_until_finished()
        self._thread = threading.Thread(
            target=self._commit, args=(step, arrays, cursor), daemon=False)
        self._thread.start()

    def _commit(self, step: int, arrays, cursor: RunCursor) -> None:
        try:
            final = os.path.join(self.dir, f"{_PREFIX}{step:06d}")
            tmp = os.path.join(self.dir, f".tmp-{step:06d}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            _write(tmp, arrays, cursor)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self._steps()[:-self.keep] if self.keep > 0 else ():
                shutil.rmtree(os.path.join(self.dir, f"{_PREFIX}{old:06d}"),
                              ignore_errors=True)
        except BaseException as e:       # surfaced by wait_until_finished
            self._error = e

    def wait_until_finished(self) -> None:
        """Block until the last save is committed; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _steps(self):
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d[len(_PREFIX):]) for d in os.listdir(self.dir)
                      if d.startswith(_PREFIX) and d[len(_PREFIX):].isdigit())

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_sharded(self, mesh, step: Optional[int] = None,
                        batched: bool = False):
        """``restore`` onto a mesh (parallel/sharded.py): (state, corr) as
        each local shard's rows on its device, and the cursor."""
        from ..parallel import sharded
        state, corr, cursor = self.restore(step)
        return (sharded.shard_state(mesh, state, batched),
                sharded.shard_corr(mesh, corr, batched), cursor)

    def restore(self, step: Optional[int] = None, device="cpu"
                ) -> Tuple[ModelState, Corrections, RunCursor]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return load_checkpoint(
            os.path.join(self.dir, f"{_PREFIX}{step:06d}"), device=device)
