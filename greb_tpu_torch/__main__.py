"""CLI entry point: ``python -m greb_tpu_torch [namelist] [options]``.

The PyTorch/CUDA counterpart of ``python -m greb_tpu`` and of the
reference's ``./greb [namelist]`` (PROGRAM greb_run, src/greb.f90:996-1098):
the positional argument is a Fortran namelist path (default ``namelist``),
inputs come from ``--input-dir`` in the reference's binary format (or are
synthesized with ``--synthetic``), and the output is the reference's
5-variable monthly-mean record stream.  It runs on the card (``--device
cuda``, the default) through the fused CUDA year kernels.
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
    p.add_argument("--strict-circulation", action="store_true",
                   help="strict term-by-term stencils (not ported yet)")
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
    model.run(output_path=out_path)
    if not args.quiet:
        print(f"% total wall time {time.perf_counter() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
