"""Model driver: ``GREB`` with the spin-up and the scenario phases
(``greb_tpu.model.driver``; reference PROGRAM greb_run + greb_model,
src/greb.f90:161-236, 996-1098).

Each phase calls one year at a time: on the card through the fused CUDA
year kernels (ops/cuda/year_kernel.py), on the CPU through their plain
PyTorch versions.  Monthly means are one (12, nstep) product outside the
kernel; the scenario writes them to the reference's direct-access binary
stream and prints one console line per year.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GrebConfig, PhysicsParams
from ..forcing import (ClimForcing, Corrections, ModelState, build_derived,
                       initial_state, load_forcing, synthetic_forcing)
from ..grid import make_grid, month_average_matrix
from ..ops import fastcirc2 as fc2
from ..ops import stencils as stc
from ..ops.cuda import year_kernel as yk
from . import core

F32 = np.float32


class GREB:
    """A configured GREB model bound to a forcing dataset and a device."""

    def __init__(self, cfg: GrebConfig, params: Optional[PhysicsParams] = None,
                 forcing: Optional[ClimForcing] = None,
                 input_dir: Optional[str] = None, verbose: bool = True,
                 device=None):
        if cfg.experiment.active:
            raise NotImplementedError(
                f"legacy log_exp={cfg.experiment.log_exp}: the legacy "
                f"switchboard comes with ROADMAP Queue 1 item 8")
        if not cfg.fast_circulation:
            raise NotImplementedError(
                "strict circulation: the strict stencils come with ROADMAP "
                "Queue 1 item 8")
        if cfg.fastcirc_version != 2:
            raise NotImplementedError(
                f"fastcirc_version={cfg.fastcirc_version}: the port runs the "
                f"uniform fold (v2) only; the banded v1 fold is not ported "
                f"(ROADMAP Queue 1, 'Not to port')")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num = cfg.numerics
        self.params = params if params is not None else PhysicsParams.default()
        self.verbose = verbose and cfg.diagnostics.console

        if forcing is None:
            forcing = (load_forcing(input_dir, self.num, self.device)
                       if input_dir else
                       synthetic_forcing(self.num, self.device))
        self.forcing = forcing

        uabs = forcing.uclim.abs().cpu().numpy()
        self.grid = make_grid(self.num.xdim, self.num.ydim, self.num.dt_crcl,
                              kappa=float(self.params.kappa),
                              pi=float(self.params.pi),
                              max_wind=float(uabs.max()),
                              u_rowmax=uabs.max(axis=(0, 2)))
        self.st = stc.make_stencil_static(self.grid)
        self.derived = build_derived(self.params, forcing)
        self.md = core.ModelData(params=self.params, derived=self.derived,
                                 z_topo=forcing.z_topo, glacier=forcing.glacier)
        self.sfx = core.step_forcing_from_clim(forcing)
        self.fold = fc2.build_const(
            self.derived.wz_air.cpu().numpy(),
            self.derived.wz_vapor.cpu().numpy(),
            self.grid, self.st, kappa=float(self.params.kappa),
            device=self.device)
        if self.device.type == "cuda":
            # the kernels' shared-memory fit and plan support, checked
            # before any year runs
            yk.check_supported(self.fold[0])
        self.year_data = yk.YearData(md=self.md, sfx=self.sfx,
                                     fold=self.fold, num=self.num)
        self.month_mat = torch.as_tensor(
            month_average_matrix(self.num.jday_mon, self.num.ndt_days),
            device=self.device)

    # -- phases ---------------------------------------------------------------
    def initial_state(self) -> ModelState:
        return initial_state(self.params, self.forcing, self.derived)

    def flux_correction(self, state: Optional[ModelState] = None,
                        co2: Optional[float] = None
                        ) -> Tuple[ModelState, Corrections]:
        """Spin-up phase learning the nstep-slot correction tables
        (reference src/greb.f90:311-364).  Returns the end-of-phase state
        (whose cap_surf carries into the scenario) and the tables."""
        num = self.num
        state = state if state is not None else self.initial_state()
        co2v = F32(co2 if co2 is not None else self.cfg.co2.co2_flux)
        if self.verbose:
            print(f"% FLUX CORRECTION RUN; years = {num.time_flux} "
                  f"co2 = {float(co2v)}")
        corr = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim,
                                 device=self.device)
        for _ in range(num.time_flux):
            state, corr = yk.fluxcorr_year(state, co2v, self.year_data)
        return state, corr

    def run_scenario(self, corr: Corrections,
                     state: Optional[ModelState] = None,
                     years: Optional[int] = None,
                     co2_series: Optional[np.ndarray] = None,
                     output_path: Optional[str] = None):
        """Scenario phase (reference src/greb.f90:223-234), one year per
        kernel call.  Returns (state, monthly (years,12,5,y,x), diag list)."""
        num = self.num
        years = years if years is not None else num.time_scnr
        if co2_series is None:
            co2_series = core.co2_series_for_run(
                num, self.cfg.co2.series(num.time_scnr))
        co2_series = np.asarray(co2_series, F32)
        if len(co2_series) < years:
            raise ValueError(f"co2 series has {len(co2_series)} years, "
                             f"the run {years}")

        if state is None:
            state = self.initial_state()

        writer = None
        if output_path:
            from ..io.binio import OutputWriter
            writer = OutputWriter(output_path, num.xdim, num.ydim)
        if self.verbose:
            print(f"% MODEL RUN; years = {years}")
            print("console output: year, co2, global avg temp, "
                  "avg temp for ipx/ipy")
        monthly_all, diags = [], []
        ft_mean, fq_mean = core.correction_annual_means(corr)
        year = num.year0
        try:
            for iy in range(years):
                co2 = co2_series[iy]
                state, outs, asum = yk.scenario_year(state, corr, co2,
                                                     self.year_data)
                monthly_np = core.monthly_means(self.month_mat,
                                                outs).cpu().numpy()
                monthly_all.append(monthly_np)
                if writer:
                    writer.write_months(monthly_np)
                diag = core.year_diag(core.annual_means(asum, num),
                                      num)._replace(ft_mean=ft_mean,
                                                    fq_mean=fq_mean)
                diags.append(diag)
                if self.verbose:
                    print(f" {year + 1} {float(co2):10.4f} "
                          f"{float(diag.global_mean_ts) - 273.15:12.6f} "
                          f"{float(diag.point_ts) - 273.15:12.6f}")
                year += 1
        finally:
            if writer:
                writer.close()
        monthly_arr = np.stack(monthly_all) if monthly_all else None
        return state, monthly_arr, diags

    # -- the reference's full default workload --------------------------------
    def run(self, output_path: Optional[str] = None):
        """Full reference workload: flux correction then scenario
        (greb_model, src/greb.f90:161-236)."""
        t0 = time.perf_counter()
        state_fc, corr = self.flux_correction()
        out_path = output_path if output_path is not None else (
            self.cfg.diagnostics.output_file_full or None)
        # the scenario continues from the spin-up end state (the reference's
        # module arrays persist across phases, src/greb.f90:219-234)
        state, monthly, diags = self.run_scenario(
            corr, state=state_fc, output_path=out_path)
        if self.verbose:
            dt = time.perf_counter() - t0
            tot = self.num.time_flux + self.num.time_scnr
            print(f"% done: {tot} sim-years in {dt:.2f}s "
                  f"({tot / dt:.1f} sim-yr/s)")
        return state, corr, monthly, diags
