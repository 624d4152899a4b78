#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (greb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from greb_tpu_torch/csrc/ (nvcc, sm_90a) into
   greb_tpu_torch/_build/ and prints the build time;
3. holds the spin-up year kernel (fluxcorr_year) against its plain PyTorch
   version on the card: one year at 96x48, 730 steps, 24 substeps;
4. holds the scenario year kernel (scenario_year) against its plain
   version the same way;
   then times the scenario kernel at one substep per step, which splits a
   launch into substep time and per-step time;
5. drives the main path, GREB.run: 3 spin-up years and 10 scenario years at
   96x48 through both kernels, with launch counts, finiteness, the output
   file read back, and the warming under 680 ppm checked;
6. prints one JSON line per kernel set ({"kernels": [...]}) and, last,
   {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero and prints no ok line.
It needs a CUDA card and the repository's greb_tpu_torch package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Year-level tolerances of tests/test_golden_year.py (kernel vs plain):
# monthly means and the spin-up end state (:29, :61-67)
TOL_T = 2e-2          # temperatures [K]
TOL_Q = 3e-6          # q [kg/kg]
TOL_ALBEDO = 5e-4
RTOL_CAP = 1e-5       # cap_surf at the spin-up end, relative
TOL_TF_MEAN = 1.0     # tf annual mean [W/m^2]
TOL_QF_MEAN = 1e-7    # qf annual mean [kg/kg/step]
# ... and the free-running scenario end state (:83-87)
TOL_T_END = 3e-2
TOL_Q_END = 5e-6
# annual-mean fluxes (sw, lw_surf, q_lat, q_sens): 2e-2 K of Ts or Ta moves
# a surface flux by at most ~0.15 W/m^2 (4 sigma T^3 at 300 K), so 0.5
TOL_FLUX_MEAN = 0.5

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def _check(label, got, limit):
    ok = got <= limit
    print(f"  {label:<28s} {got:.3e}  (limit {limit:.1e})"
          f"{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {got} > {limit}")
    return got


def _max_abs(a, b):
    return float((a - b).abs().max())


def _time_ms(fn, repeats):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, out


def _bound(plan, num, scenario):
    from greb_tpu_torch.ops.cuda import year_kernel as yk
    nbytes, ops = yk.year_work(plan, num, scenario)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare_state(tag, s_k, s_p, tol_t, tol_q):
    errs = []
    for name in ("ts", "ta", "to"):
        errs.append(_check(f"{tag} state {name} [K]", _max_abs(
            getattr(s_k, name), getattr(s_p, name)), tol_t))
    _check(f"{tag} state q", _max_abs(s_k.q, s_p.q), tol_q)
    return max(errs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from greb_tpu_torch.config import Diagnostics, GrebConfig, Numerics
    from greb_tpu_torch.io.binio import read_output
    from greb_tpu_torch.model import core
    from greb_tpu_torch.model.driver import GREB
    from greb_tpu_torch.ops.cuda import build
    from greb_tpu_torch.ops.cuda import year_kernel as yk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k}.cu {v:.1f} s' for k, v in built.items()) or 'cached'})")
    with open(os.path.join(build.BUILD_DIR, "year_kernel.ptxas.txt")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        out_path = os.path.join(tmp, "scenario")
        num = Numerics(time_flux=3, time_scnr=10)
        cfg = GrebConfig(numerics=num,
                         diagnostics=Diagnostics(output_file=out_path))
        model = GREB(cfg, device="cuda")
        yd, plan = model.year_data, model.fold[0]
        print(f"96x48: {num.nstep_yr} steps/yr, {num.nsub_crcl} substeps, "
              f"plan {plan}")

        # -- K1: spin-up year kernel vs its plain version --------------------
        s0 = model.initial_state()
        co2f = np.float32(cfg.co2.co2_flux)
        (s_k, c_k) = yk.fluxcorr_year(s0, co2f, yd)        # first launch
        ms_k1, (s_k, c_k) = _time_ms(lambda: yk.fluxcorr_year(s0, co2f, yd), 2)
        plain_k1, (s_p, c_p) = _time_ms(
            lambda: yk.fluxcorr_year_plain(s0, co2f, yd), 1)
        print(f"K1 fluxcorr_year: kernel {ms_k1:.2f} ms/launch, plain "
              f"{plain_k1:.1f} ms/year")
        err_k1 = _compare_state("K1", s_k, s_p, TOL_T, TOL_Q)
        _check("K1 state cap_surf (rel)", float(
            ((s_k.cap_surf - s_p.cap_surf).abs() / s_p.cap_surf).max()),
            RTOL_CAP)
        _check("K1 tf annual mean [W/m^2]",
               _max_abs(c_k.tf.mean(0), c_p.tf.mean(0)), TOL_TF_MEAN)
        _check("K1 qf annual mean", _max_abs(c_k.qf.mean(0), c_p.qf.mean(0)),
               TOL_QF_MEAN)
        print(f"  K1 per-step tables max |diff|: tf "
              f"{_max_abs(c_k.tf, c_p.tf):.3e} tof {_max_abs(c_k.tof, c_p.tof):.3e} "
              f"qf {_max_abs(c_k.qf, c_p.qf):.3e}")

        # -- K2: scenario year kernel vs its plain version -------------------
        co2s = np.float32(680.0)
        s_k2, o_k, a_k = yk.scenario_year(s_p, c_p, co2s, yd)
        ms_k2, (s_k2, o_k, a_k) = _time_ms(
            lambda: yk.scenario_year(s_p, c_p, co2s, yd), 2)
        plain_k2, (s_p2, o_p, a_p) = _time_ms(
            lambda: yk.scenario_year_plain(s_p, c_p, co2s, yd), 1)
        print(f"K2 scenario_year: kernel {ms_k2:.2f} ms/launch, plain "
              f"{plain_k2:.1f} ms/year")
        err_k2 = _compare_state("K2", s_k2, s_p2, TOL_T_END, TOL_Q_END)
        # a free-running Ts moves cap_surf along the sea-ice ramp, at most
        # (cap_ocean*max(mld) - cap_land)/(To_ice2 - To_ice1) per K
        p, d = model.params, model.derived
        slope = (float(d.cap_ocean) * float(model.forcing.mldclim.max())
                 - float(d.cap_land)) / float(p.To_ice2 - p.To_ice1)
        _check("K2 state cap_surf [J/K/m^2]",
               _max_abs(s_k2.cap_surf, s_p2.cap_surf), slope * TOL_T_END)
        m_k = core.monthly_means(model.month_mat, o_k)
        m_p = core.monthly_means(model.month_mat, o_p)
        for v, (name, tol) in enumerate((("ts", TOL_T), ("ta", TOL_T),
                                         ("to", TOL_T), ("q", TOL_Q),
                                         ("albedo", TOL_ALBEDO))):
            _check(f"K2 monthly {name}", _max_abs(m_k[:, v], m_p[:, v]), tol)
        mean_k = core.annual_means(a_k, num)
        mean_p = core.annual_means(a_p, num)
        for name in core.StepOutputs._fields:
            tol = {"q": TOL_Q, "albedo": TOL_ALBEDO}.get(
                name, TOL_T if name in ("ts", "ta", "to") else TOL_FLUX_MEAN)
            _check(f"K2 annual mean {name}", _max_abs(
                getattr(mean_k, name), getattr(mean_p, name)), tol)

        # -- where a launch's time goes: the same scenario year with one
        #    substep per step splits substep time from per-step time
        one = yk.YearData(md=yd.md, sfx=yd.sfx, fold=yd.fold,
                          num=dataclasses.replace(num, dt_crcl=num.dt))
        ms_one, _ = _time_ms(lambda: yk.scenario_year(s_p, c_p, co2s, one), 2)
        us_sub = (ms_k2 - ms_one) * 1e3 / (num.nstep_yr * (num.nsub_crcl - 1))
        print(f"K2 split: {ms_one:.2f} ms/launch at 1 substep/step -> "
              f"{us_sub:.3f} us per substep, "
              f"{ms_one * 1e3 / num.nstep_yr - us_sub:.3f} us per step "
              f"outside the substeps")

        # -- the main path: GREB.run, 3 spin-up + 10 scenario years ----------
        yk.fluxcorr_year.launches = 0
        yk.scenario_year.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, corr, monthly, diags = model.run(output_path=out_path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fluxcorr_year": yk.fluxcorr_year.launches,
                    "scenario_year": yk.scenario_year.launches}
        years = num.time_flux + num.time_scnr
        print(f"main path: {years} sim-years in {wall:.3f} s = "
              f"{years / wall:.3f} sim-yr/s; launches {launches}")
        if launches != {"fluxcorr_year": num.time_flux,
                        "scenario_year": num.time_scnr}:
            raise AssertionError(f"launch counts {launches}")
        for name in ("ts", "ta", "to", "q", "cap_surf"):
            if not bool(torch.isfinite(getattr(state, name)).all()):
                raise AssertionError(f"state {name} not finite")
        for name in ("tf", "tof", "qf"):
            if not bool(torch.isfinite(getattr(corr, name)).all()):
                raise AssertionError(f"corr {name} not finite")
        if monthly.shape != (num.time_scnr, 12, 5, num.ydim, num.xdim) \
                or not np.isfinite(monthly).all():
            raise AssertionError(f"monthly means {monthly.shape} not finite")
        back = read_output(out_path, num.xdim, num.ydim)
        if not np.array_equal(back, monthly.reshape(-1, 5, num.ydim,
                                                    num.xdim)):
            raise AssertionError("output file does not read back")
        gm = [float(d.global_mean_ts) for d in diags]
        print(f"  global mean Ts [K] by scenario year: "
              f"{' '.join(f'{g:.4f}' for g in gm)}")
        if not gm[-1] > gm[0]:
            raise AssertionError(f"no warming under 680 ppm: {gm}")

    kernels = []
    for name, line, ms, plain_ms, err, scen in (
            ("fluxcorr_year", 353, ms_k1, plain_k1, err_k1, False),
            ("scenario_year", 231, ms_k2, plain_k2, err_k2, True)):
        bound_ms, bound_by = _bound(plan, num, scen)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "greb_tpu_torch/csrc/year_kernel.cu",
            "replaces": f"greb_tpu/ops/pallas/year_kernel.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
