"""Chunked long runs with checkpoints (``greb_tpu.model.longrun``).

The reference cannot restart: its state lives in Fortran module arrays and
its binary output keeps monthly means only (src/greb.f90:978-982), so a
crash loses the whole run.  Here a long scenario runs in chunks of years;
after a chunk the prognostic state, the correction tables and a cursor go
to the ``Checkpointer``, and a fresh process resumes bit-exactly from the
last checkpoint: the year runners are deterministic and the checkpoint
holds their whole carry.

The chunk body is pluggable; ``driver_year_runner`` runs it through
``GREB.run_scenario`` (per-year kernel, or the multi-year kernel with
``years_per_call > 1``) and writes the output stream.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..forcing import Corrections, ModelState
from ..io.checkpoint import Checkpointer, RunCursor

F32 = np.float32

# run_years(state, corr, co2_chunk: np.ndarray) -> (state, monthly | None)
YearRunner = Callable[[ModelState, Corrections, np.ndarray],
                      Tuple[ModelState, Optional[np.ndarray]]]


def run_long(total_years: int, state: Optional[ModelState],
             corr: Optional[Corrections], co2_series: np.ndarray,
             run_years: YearRunner,
             checkpointer: Optional[Checkpointer] = None,
             chunk_years: int = 50, resume: bool = True,
             on_chunk: Optional[Callable[[int, Optional[np.ndarray]], None]]
             = None, device=None) -> Tuple[ModelState, Corrections, int]:
    """Run ``total_years`` in chunks, with a checkpoint at every chunk end
    that falls on the checkpointer's cadence and at the last one.

    With ``resume`` and a checkpoint on disk, the run starts from it (onto
    ``device``, by default that of ``state``) and ``state`` / ``corr`` may
    be None.  Returns ``(state, corr, start_year)``, where ``start_year`` is
    the year the loop started from (0, or the resumed cursor)."""
    co2_series = np.asarray(co2_series, F32)
    if len(co2_series) < total_years:
        raise ValueError(f"co2 series has {len(co2_series)} years, the run "
                         f"{total_years}")
    start = 0
    if resume and checkpointer is not None:
        last = checkpointer.latest_step()
        if last is not None:
            dev = device if device is not None else state.ts.device
            state, corr, cursor = checkpointer.restore(last, device=dev)
            start = int(cursor.year_index)
    if state is None or corr is None:
        raise ValueError("run_long: no state to start from (no checkpoint "
                         "to resume)")
    # resume-aware runners (driver_year_runner with an output file) place
    # their side effects at the start year: a resumed process neither loses
    # nor repeats the months written before the crash
    on_resume = getattr(run_years, "on_resume", None)
    if on_resume is not None:
        on_resume(start)
    done = start
    try:
        while done < total_years:
            n = min(chunk_years, total_years - done)
            state, monthly = run_years(state, corr, co2_series[done:done + n])
            done += n
            if on_chunk is not None:
                on_chunk(done, monthly)
            if checkpointer is not None and (
                    done == total_years or done % checkpointer.every == 0):
                checkpointer.save(done, state, corr, RunCursor(
                    phase="scenario", year_index=done,
                    co2=float(co2_series[done - 1])))
    finally:
        if checkpointer is not None:
            # the last save is durable, also when a chunk raised
            checkpointer.wait_until_finished()
    return state, corr, start


def driver_year_runner(model, output_path: Optional[str] = None,
                       years_per_call: int = 1,
                       collect_monthly: bool = False) -> YearRunner:
    """A ``run_years`` chunk body over ``GREB.run_scenario``.  The output
    records continue across chunks and across a crash and resume: the
    writer opens on first use at the record of the (possibly resumed)
    start year, keeps the records before it and drops any after it, so
    the months a crashed run wrote past its last checkpoint are written
    once, not twice."""
    box = {"writer": None, "year": 0}
    months_per_year = len(model.num.jday_mon)

    def _writer():
        if output_path and box["writer"] is None:
            from ..io.binio import OutputWriter
            box["writer"] = OutputWriter(
                output_path, model.num.xdim, model.num.ydim,
                start_record=box["year"] * months_per_year
                * OutputWriter.NVAR)
        return box["writer"]

    def run_years(state, corr, co2_chunk):
        state, monthly, _ = model.run_scenario(
            corr, state=state, years=len(co2_chunk), co2_series=co2_chunk,
            collect_monthly=collect_monthly or bool(output_path),
            years_per_call=years_per_call, first_year=box["year"])
        w = _writer()
        if w is not None:
            for m in monthly:
                w.write_months(m)
            w.flush()   # on disk before the chunk's checkpoint
        box["year"] += len(co2_chunk)
        return state, monthly

    def on_resume(start_year: int) -> None:
        box["year"] = int(start_year)

    def close() -> None:
        if box["writer"] is not None:
            box["writer"].close()
            box["writer"] = None

    run_years.on_resume = on_resume
    run_years.close = close
    return run_years


def sharded_year_runner(mesh, scnr_sh, sfx_s, md_s, fcconst=None,
                        shard_state: Optional[Callable] = None,
                        on_year: Optional[Callable[[np.ndarray], None]]
                        = None,
                        shard_corr: Optional[Callable] = None) -> YearRunner:
    """A chunk body over a sharded scenario-year runner
    (parallel/sharded.py ``make_sharded_year_runners``): one call a year,
    the state carried on the mesh.  ``shard_state`` (state -> sharded
    state) is applied once a chunk, so a host state restored from a
    checkpoint lands back on the mesh (``run_long`` saves a sharded state
    by gathering its rows, io/checkpoint.py); ``shard_corr`` does the same
    for the correction tables.

    ``on_year(monthly)`` takes each year's (months, 5, Y, X) array (the
    rows gathered to the host) as it comes and the chunk returns
    ``monthly=None``: the host never holds more than one year (at 768x384
    a 50-year chunk would otherwise stage ~3.4 GB).  Without it the chunk
    returns its years stacked, (years, months, 5, Y, X)."""
    def run_years(state, corr, co2_chunk):
        if shard_state is not None:
            state = shard_state(state)
        if shard_corr is not None:
            corr = shard_corr(corr)
        months = []
        for co2 in np.asarray(co2_chunk, F32):
            args = (state, sfx_s, corr, co2, md_s)
            if fcconst is not None:
                args += (fcconst,)
            state, monthly, _ = scnr_sh(*args)
            monthly = monthly.gather().numpy()
            if on_year is not None:
                on_year(monthly)
            else:
                months.append(monthly)
        return state, (np.stack(months) if months else None)

    return run_years
