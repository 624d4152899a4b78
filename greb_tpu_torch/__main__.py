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

``--legacy`` runs the original variant's experiment workflow for the
namelist's ``log_exp`` (src/greb.original.model.f90:199-231): the spin-up,
the TF_correct dump to ``<output dir>/control``, the control phase
(``time_ctrl`` years, rewinding that file) and the scenario, for every
``log_exp`` 0-16; under 7, 8 and 16 the kernels move Ta (and under 8 q)
with the strict term-by-term stencils.  ``--strict-circulation`` moves Ta
and q with those stencils instead of the coefficient-folded circulation.
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
    if args.legacy:
        run_legacy(model, out_path)
    elif args.checkpoint_dir:
        run_checkpointed(model, out_path, args)
    else:
        model.run(output_path=out_path)
    if not args.quiet:
        print(f"% total wall time {time.perf_counter() - t0:.2f}s")
    return 0


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
