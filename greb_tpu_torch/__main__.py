"""CLI entry point: ``python -m greb_tpu_torch [namelist] [options]``.

The PyTorch/CUDA counterpart of ``python -m greb_tpu`` and of the
reference's ``./greb [namelist]`` (PROGRAM greb_run, src/greb.f90:996-1098):
the positional argument is a Fortran namelist path (default ``namelist``),
inputs come from ``--input-dir`` in the reference's binary format (or are
synthesized with ``--synthetic``), and the output is the reference's
5-variable monthly-mean record stream.  It runs on the card (``--device
cuda``, the default) through the fused CUDA year kernels.

``--checkpoint-dir D`` runs the scenario in chunks of ``--checkpoint-every``
years with a checkpoint after each (the reference has none); ``--resume``
continues from the newest checkpoint in D, with the output stream placed
at the checkpoint's record.

``--ensemble M`` runs M perturbed-physics members batched on the card
(the reference runs one process per member, ``ens_id``, src/greb.f90:
1064-1068): ``--perturb P=LO:HI`` sweeps one physics parameter linearly
across the members, each member spins up under its own params (or, with
``--shared-spinup``, all read the base params' tables) and writes its
monthly records to ``<output>_<i>``; the members' circulation is the
member-batched matmul form at ``--mxu-precision`` where it runs the plan,
as greb_tpu's ensemble.

``--legacy`` runs the original variant's experiment workflow for the
namelist's ``log_exp`` (src/greb.original.model.f90:199-231): the spin-up,
the TF_correct dump to ``<output dir>/control``, the control phase
(``time_ctrl`` years, rewinding that file) and the scenario, for every
``log_exp`` 0-16; under 7, 8 and 16 the kernels move Ta (and under 8 q)
with the strict term-by-term stencils.  ``--strict-circulation`` moves Ta
and q with those stencils instead of the coefficient-folded circulation.

``--plots PREFIX`` writes the reference README's figure set after the run
(plots.save_all) as ``PREFIX_*.png``: from the run's monthly means and
yearly diagnostics, or, after the ensemble, legacy and checkpointed runs,
from the output file read back (the ensemble's first member's,
``<output>_001``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m greb_tpu_torch",
        description="GREB climate model in PyTorch with CUDA year kernels")
    p.add_argument("namelist", nargs="?", default="namelist",
                   help="namelist path (default: ./namelist, like ./greb)")
    p.add_argument("--input-dir", default=None,
                   help="directory with reference-format binary inputs; "
                        "omit to use the deterministic synthetic climatology")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic forcing even if --input-dir is set")
    p.add_argument("--output", default=None,
                   help="override diagnostics_par output_file")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for compatibility with python -m greb_tpu; "
                        "on the card the fused kernels always run")
    p.add_argument("--legacy", action="store_true",
                   help="legacy experiment workflow for the namelist's "
                        "log_exp (0-16): spin-up, TF_correct dump and "
                        "control phase into <output dir>/control, scenario")
    p.add_argument("--strict-circulation", action="store_true",
                   help="move Ta and q with the strict term-by-term "
                        "stencils instead of the coefficient-folded "
                        "circulation (the reference's own operator)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint the scenario into this directory")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="years between checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--plots", default=None, metavar="PREFIX",
                   help="after the run, write the reference README's figure "
                        "set (warming curve, Arctic albedo, dTsurf, inputs) "
                        "as PREFIX_*.png")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="run an M-member perturbed-physics ensemble batched "
                        "on one card (the reference runs one process per "
                        "member via ens_id, src/greb.f90:1064-1068); each "
                        "member's monthly records go to output_file_<i>")
    p.add_argument("--perturb", default="ct_sens=22.05:22.95",
                   metavar="PARAM=LO:HI",
                   help="ensemble perturbation: PhysicsParams field swept "
                        "linearly across members (default ct_sens, +-2%%)")
    p.add_argument("--shared-spinup", action="store_true",
                   help="ensemble mode: one base-params flux-correction "
                        "spin-up whose tables every member reads, instead "
                        "of per-member spin-ups (per-member tables take "
                        "40 MB a member at 96x48)")
    p.add_argument("--mxu-precision", choices=("high", "highest"),
                   default="high",
                   help="ensemble mode: precision of the member-batched "
                        "matmul circulation, as python -m greb_tpu: 'high' "
                        "(the 3-pass bfloat16 split, ~2^-21 relative error "
                        "a product) or 'highest' (exact float32, the exact "
                        f"fold's bits; from {MXU_HIGHEST_PER_MEMBER_M} "
                        "members the per-member "
                        "kernels run it); plans it does not run (48x24, "
                        "the refined grids, the strict circulation) take "
                        "the exact fold")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .config import GrebConfig, config_from_namelist
    from .model.driver import GREB

    if os.path.exists(args.namelist):
        cfg, params = config_from_namelist(args.namelist)
    else:
        if args.namelist != "namelist":
            print(f"namelist not found: {args.namelist}", file=sys.stderr)
            return 2
        cfg, params = GrebConfig(), None   # reference also runs w/o namelist
    if args.output:
        cfg = dataclasses.replace(
            cfg, diagnostics=dataclasses.replace(cfg.diagnostics,
                                                 output_file=args.output))
    cfg = dataclasses.replace(cfg,
                              fast_circulation=not args.strict_circulation)

    input_dir = None if args.synthetic else args.input_dir
    model = GREB(cfg, params=params, input_dir=input_dir,
                 verbose=not args.quiet, device=args.device)

    out_path = cfg.diagnostics.output_file_full
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    monthly = diags = None
    if args.ensemble > 0:
        run_ensemble(model, out_path, args)
    elif args.legacy:
        run_legacy(model, out_path)
    elif args.checkpoint_dir:
        run_checkpointed(model, out_path, args)
    else:
        _, _, monthly, diags = model.run(output_path=out_path)
    if not args.quiet:
        print(f"% total wall time {time.perf_counter() - t0:.2f}s")
    if args.plots:
        num = model.num
        if monthly is None:
            from .io.binio import read_output
            # greb_tpu reads <output> here, which its ensemble never writes
            path = f"{out_path}_001" if args.ensemble > 0 else out_path
            monthly = read_output(path, num.xdim, num.ydim).reshape(
                (-1, len(num.jday_mon), 5, num.ydim, num.xdim))
        from . import plots as figs
        paths = figs.save_all(args.plots, monthly, diags=diags,
                              forcing=model.forcing)
        if not args.quiet:
            print("% figures: " + " ".join(paths))
    return 0


# the most bytes of monthly means a block of ensemble years holds on the
# card and, twice, in pinned host memory: the block is as many years as fit,
# at most ENSEMBLE_BLOCK_YEARS
ENSEMBLE_BLOCK_BYTES = 1 << 30
ENSEMBLE_BLOCK_YEARS = 10


def ensemble_block_years(members: int, num) -> int:
    """The years of one K3 block of an ensemble of ``members`` members."""
    year = members * len(num.jday_mon) * 5 * num.ydim * num.xdim * 4
    return max(1, min(ENSEMBLE_BLOCK_YEARS, ENSEMBLE_BLOCK_BYTES // year))


# --mxu-precision -> the member kernels' precision (greb_tpu's "high" is
# XLA's Precision.HIGH, documented as the 3-pass bfloat16 split)
MXU_PRECISION = {"high": "bf16_3x", "highest": "highest"}
# At "highest" the member kernels of the matmul circulation compute the
# per-member kernels' bits (each row product's 7 terms in the fold's
# order), so the ensemble runs the faster of the two.  On an H100 the
# member kernels' K3 year is the faster at 112 members, the per-member
# kernels' at 128 (chip_smoke.py step 25; PERF.md section 6); from 113
# the member kernels need a ninth wave of the 7 clusters the card runs at
# once (2 members a cluster)
MXU_HIGHEST_PER_MEMBER_M = 113


def run_ensemble(model, out_path: str, args) -> None:
    """M-member perturbed-physics ensemble (``greb_tpu.__main__
    .run_ensemble``, with its semantics): ``args.perturb`` "P=LO:HI" gives
    member i the value ``np.linspace(LO, HI, M)[i]`` of parameter P, in
    float32.  Each member spins up ``time_flux`` years under its own params
    at ``co2_flux`` (the member spin-up kernel, K4) and starts the scenario
    from its end state; with ``args.shared_spinup`` the model's own
    spin-up (``flux_correction``, K1) gives one table set that every member
    reads, and the members start the scenario from their initial states
    with the spin-up end's cap_surf, as greb_tpu does.  The scenario runs
    at ``cfg.co2.series(time_scnr)`` through the multi-year kernel (K3) in
    blocks (``ENSEMBLE_BLOCK_BYTES``); each block's months go to member
    i's file ``<out_path>_<i+1:03d>`` as the block drains, each file
    opened for the block and closed after it, so M is not bounded by the
    open-file limit.  One console line a year: CO2 and the members'
    range of the global-mean annual-mean Ts.

    Where the member-batched matmul circulation runs the model's plan
    (``GREB.members_mxu``: the fold without segments, with dense
    composites and additive splitting, as at 96x48), K4 and K3 run it at
    ``args.mxu_precision`` (MXU_PRECISION), as greb_tpu's ensemble runs its
    matmul circulation; at "highest" from MXU_HIGHEST_PER_MEMBER_M members
    on, and elsewhere, the exact float32 fold, one member a cluster or
    block.  A line on stderr says which.
    Raises SystemExit for a bad ``--perturb``, and NotImplementedError
    (before any launch) where the member kernels do not run the model's
    plan."""
    import numpy as np

    from .io.binio import OutputWriter
    from .model import core
    from .parallel import ensemble as ens

    M = args.ensemble
    name, _, rng = args.perturb.partition("=")
    lo, _, hi = rng.partition(":")
    try:
        sweep = np.linspace(float(lo), float(hi), M).astype(np.float32)
    except ValueError:
        raise SystemExit(f"bad --perturb spec: {args.perturb!r} "
                         f"(want PARAM=LO:HI)")
    if not hasattr(model.params, name):
        raise SystemExit(f"unknown physics parameter: {name!r}")
    if not ens.fastcirc_shareable([name]):
        raise SystemExit(f"{name!r} perturbs the transport operator; "
                         f"batched ensembles share the folded circulation "
                         f"tables (see parallel.ensemble)")
    precision = MXU_PRECISION[args.mxu_precision]
    mxu = model.members_mxu(precision)
    why = "the matmul circulation does not run this plan"
    if mxu is not None and precision == "highest" \
            and M >= MXU_HIGHEST_PER_MEMBER_M:
        mxu = None
        why = (f"the matmul circulation's bits at highest, faster from "
               f"{MXU_HIGHEST_PER_MEMBER_M} members")
    model._check_member_kernels(mxu)
    if not args.quiet:
        print(f"% ENSEMBLE RUN; members = {M} perturb {name} in "
              f"[{sweep[0]}, {sweep[-1]}] mxu={args.mxu_precision}")
        # on stderr: stdout's lines are greb_tpu's, character for character
        print("% circulation: " + (
            f"member-batched matmul, {precision}" if mxu is not None else
            f"exact float32 fold ({why})"), file=sys.stderr)
    members = ens.perturbed_params(model.params, {name: sweep})
    num = model.num
    nmon = len(num.jday_mon)
    co2_series = model.cfg.co2.series(num.time_scnr)

    def write(done, monthly, asum):
        recs = done * nmon * OutputWriter.NVAR
        for i in range(M):
            with OutputWriter(f"{out_path}_{i + 1:03d}", num.xdim, num.ydim,
                              start_record=recs) as w:
                w.write_months(monthly[i].numpy())
        if args.quiet:
            return
        for iy in range(asum.shape[1]):
            ts = core.annual_means(asum[:, iy].transpose(0, 1), num).ts
            gm = ts.numpy().mean(axis=(1, 2)) - 273.15
            print(f" {num.year0 + done + iy + 1} "
                  f"{float(co2_series[done + iy]):10.4f} members "
                  f"[{gm.min():.4f} .. {gm.max():.4f}] degC")

    run = dict(years=num.time_scnr, co2_series=co2_series, on_block=write,
               years_per_call=ensemble_block_years(M, num), mxu=mxu)
    if getattr(args, "shared_spinup", False):
        state_fc, corr = model.flux_correction()
        state5 = ens.ensemble_initial_state(members, model.forcing)
        state5[4] = state_fc.cap_surf
        model.run_members(members, corr=corr, state5=state5, **run)
    else:
        model.run_members(members, spinup_co2=model.cfg.co2.co2_flux, **run)


def run_legacy(model, out_path: str) -> None:
    """The legacy workflow (src/greb.original.model.f90:199-231): spin-up,
    the nstep_yr TF_correct records dumped to ``<out dir>/control``, the
    control phase when ``time_ctrl > 0`` (overwriting that file from its
    first record and keeping its tail), then the scenario.  Both phases
    start from the spin-up end state: the reference re-initialises from
    Ts_ini etc. (:210, :219), which qflux_correction mutated in place
    (:201)."""
    from .io.binio import write_records

    state_fc, corr = model.flux_correction()
    base = os.path.dirname(out_path) or "."
    os.makedirs(base, exist_ok=True)
    control_path = os.path.join(base, "control")
    write_records(control_path, corr.tf.cpu().numpy())
    if model.num.time_ctrl > 0:
        model.run_control(corr, state_fc=state_fc, output_path=control_path)
    model.run_scenario(corr, state=state_fc, output_path=out_path)


def run_checkpointed(model, out_path: str, args) -> None:
    """Spin-up (unless resuming), then the scenario in chunks of
    ``--checkpoint-every`` years through ``longrun.run_long``, one
    per-year kernel call a year, with a checkpoint after each chunk.  A
    resume continues from the newest checkpoint, and the output stream
    continues at the checkpoint's record: months written after it by the
    interrupted run are written again once, not appended twice."""
    from .io.checkpoint import Checkpointer
    from .model import longrun

    num = model.num
    ck = Checkpointer(args.checkpoint_dir, every_years=args.checkpoint_every)
    resume = args.resume and ck.latest_step() is not None
    if resume:
        state = corr = None          # run_long restores both
    else:
        state, corr = model.flux_correction()
    run_years = longrun.driver_year_runner(model, output_path=out_path)
    try:
        _, _, start = longrun.run_long(
            num.time_scnr, state, corr, model.cfg.co2.series(num.time_scnr),
            run_years, checkpointer=ck, chunk_years=args.checkpoint_every,
            resume=resume, device=model.device)
    finally:
        run_years.close()
    if not args.quiet:
        print(f"% scenario years {start}..{num.time_scnr} run; checkpoints "
              f"in {args.checkpoint_dir}")


if __name__ == "__main__":
    sys.exit(main())
