"""Model driver: ``GREB`` with the spin-up and the scenario phases
(``greb_tpu.model.driver``; reference PROGRAM greb_run + greb_model,
src/greb.f90:161-236, 996-1098).

Each phase calls one year at a time: on the card through the fused CUDA
year kernels (ops/cuda/year_kernel.py), on the CPU through their plain
PyTorch versions.  Monthly means are one (12, nstep) product outside the
kernel; the scenario writes them to the reference's direct-access binary
stream and prints one console line per year.  ``run_scenario(...,
years_per_call=n)`` instead runs blocks of n years through the multi-year
kernel (ops/cuda/multiyear.py), which adds up the monthly means itself;
``run_members`` chains the member-batched spin-up and scenario kernels.

The legacy ``log_exp`` switchboard (``cfg.experiment``) runs in every
kernel: ``apply_experiment`` sets the static field overrides, the spin-up
and control phases run at the experiment's CO2_ctrl, the scenario's CO2
follows ``core.co2_series_for_run``, and ``run_control`` is the original
variant's control phase (reference src/greb.original.model.f90:199-231).
Ta and q move by the coefficient-folded circulation where the JAX package
builds its fold, else by the strict stencils (``cfg.fast_circulation``
False, legacy log_exp 7, 8, 16) or not at all (log_exp <= 4):
``core.transport``; every kernel runs all three.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GrebConfig, PhysicsParams, config_from_namelist
from ..diag.profiling import check_finite
from ..forcing import (ClimForcing, Corrections, ModelState,
                       apply_experiment, build_derived, initial_state,
                       load_forcing, synthetic_forcing)
from ..grid import make_grid, month_average_matrix
from ..ops import fastcirc2 as fc2
from ..ops import stencils as stc
from ..ops.cuda import multiyear as my
from ..ops.cuda import year_kernel as yk
from ..parallel import ensemble as ens
from . import core

F32 = np.float32


class GREB:
    """A configured GREB model bound to a forcing dataset and a device."""

    def __init__(self, cfg: GrebConfig, params: Optional[PhysicsParams] = None,
                 forcing: Optional[ClimForcing] = None,
                 input_dir: Optional[str] = None, verbose: bool = True,
                 device=None):
        if cfg.fastcirc_version != 2:
            raise NotImplementedError(
                f"fastcirc_version={cfg.fastcirc_version}: the port runs the "
                f"uniform fold (v2) only; the banded v1 fold is not ported "
                f"(ROADMAP Queue 1, 'Not to port')")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num = cfg.numerics
        self.exp = cfg.experiment
        self.params = params if params is not None else PhysicsParams.default()
        self.verbose = verbose and cfg.diagnostics.console

        if forcing is None:
            forcing = (load_forcing(input_dir, self.num, self.device)
                       if input_dir else
                       synthetic_forcing(self.num, self.device))
        forcing = apply_experiment(forcing, self.params, self.exp)
        self.forcing = forcing

        uabs = forcing.uclim.abs().cpu().numpy()
        self.grid = make_grid(self.num.xdim, self.num.ydim, self.num.dt_crcl,
                              kappa=float(self.params.kappa),
                              pi=float(self.params.pi),
                              max_wind=float(uabs.max()),
                              u_rowmax=uabs.max(axis=(0, 2)))
        self.st, self.sf = stc.make_stencil_arrays(
            self.grid, cfg.fidelity_jp2_quirk, self.device)
        self.derived = build_derived(self.params, forcing)
        self.md = core.ModelData(params=self.params, derived=self.derived,
                                 z_topo=forcing.z_topo, glacier=forcing.glacier,
                                 st=self.st, sf=self.sf)
        self.sfx = core.step_forcing_from_clim(forcing)
        # the fold only where the JAX package builds it (its
        # fastcirc_tables): not for the strict circulation, nor where the
        # legacy switchboard replaces the transport
        self.fold = None
        if core.transport(self.exp, cfg.fast_circulation) == "fold":
            self.fold = fc2.build_const(
                self.derived.wz_air.cpu().numpy(),
                self.derived.wz_vapor.cpu().numpy(),
                self.grid, self.st, kappa=float(self.params.kappa),
                device=self.device)
        self.year_data = yk.YearData(md=self.md, sfx=self.sfx,
                                     fold=self.fold, num=self.num,
                                     exp=self.exp)
        if self.device.type == "cuda":
            # the kernels' shared-memory fit and plan support, checked
            # before any year runs
            yk.check_supported(self.year_data.plan,
                               flags=self.year_data.flags)
        self.month_mat = torch.as_tensor(
            month_average_matrix(self.num.jday_mon, self.num.ndt_days),
            device=self.device)
        self._ppack = None   # the base params' member pack, made on first use

    @classmethod
    def from_namelist(cls, path: str, **kw) -> "GREB":
        """A model of the namelist's config and physics; ``kw`` (the
        forcing, ``device``, ...) go to the constructor."""
        cfg, params = config_from_namelist(path)
        return cls(cfg, params=params, **kw)

    def _check_member_kernels(self, mxu=None) -> None:
        """Raise before any launch where the member kernels (K3, K4) do not
        run this model's plan and flags word (``year_kernel.check_plan``),
        on any device; with ``mxu`` (a ``fastcirc2.MxuMembers``) where their
        matmul circulation does not (``multiyear._check_mxu``: the plan
        ``fastcirc2.members_covered``, the matrices)."""
        yd = self.year_data
        for kind in my.KINDS:
            yk.check_plan(yd.plan, kind, yd.flags)
            if mxu is not None:
                my._check_mxu(mxu, yd, kind)

    def members_mxu(self, precision: str):
        """The member kernels' matmul circulation at ``precision``
        ("bf16_3x", "highest") for this model's fold, or None where it does
        not run the plan (``fastcirc2.members_covered``; the strict
        transport and no transport have no fold; the refined
        instantiation's plans)."""
        yd = self.year_data
        if (yd.transport != "fold" or not fc2.members_covered(yd.plan)
                or yk.is_refined(yd.plan)):
            return None
        return fc2.build_mxu_members(self.fold[1], yd.plan, precision)

    def _multiyear_args(self, corr: Corrections):
        """(member pack (1, 1, N_PPACK), corrections (1, T, 3, Y, X)) of the
        multi-year kernel at M=1."""
        if self._ppack is None:
            self._ppack = my.pack_member_params([self.params], self.device)
        corrpack = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
        return self._ppack, corrpack

    # -- phases ---------------------------------------------------------------
    def initial_state(self) -> ModelState:
        return initial_state(self.params, self.forcing, self.derived)

    def _spinup_co2(self) -> np.float32:
        """The spin-up's CO2: CO2_ctrl under the legacy switchboard
        (greb.original.model.f90:178-179), else the namelist's co2_flux."""
        return F32(self.exp.co2_ctrl if self.exp.active
                   else self.cfg.co2.co2_flux)

    def _co2_series(self) -> np.ndarray:
        num = self.num
        return core.co2_series_for_run(num, self.exp,
                                       self.cfg.co2.series(num.time_scnr))

    def flux_correction(self, state: Optional[ModelState] = None,
                        co2: Optional[float] = None
                        ) -> Tuple[ModelState, Corrections]:
        """Spin-up phase learning the nstep-slot correction tables
        (reference src/greb.f90:311-364).  Returns the end-of-phase state
        (whose cap_surf carries into the scenario) and the tables."""
        num = self.num
        state = state if state is not None else self.initial_state()
        co2v = F32(co2) if co2 is not None else self._spinup_co2()
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
                     output_path: Optional[str] = None,
                     collect_monthly: bool = True,
                     years_per_call: int = 1,
                     first_year: int = 0,
                     output_start_record: Optional[int] = None,
                     output_truncate: bool = True):
        """Scenario phase (reference src/greb.f90:223-234).

        One year per kernel call, or with ``years_per_call > 1`` blocks of
        that many years per call of the multi-year kernel.  Both paths print
        the console line of a year from the kernel's annual sums over
        nstep_yr, so they print the same numbers; their monthly means differ
        by float32 rounding (summed step by step in the multi-year kernel,
        one product after the per-year kernel).  ``collect_monthly=False``
        skips the per-year path's monthly means, diagnostics and console
        lines (the multi-year path always collects them).  ``first_year``
        numbers the console lines of a run continued in chunks.
        ``output_start_record`` / ``output_truncate`` place the output
        stream (io/binio.OutputWriter; ``run_control`` overwrites the
        control file from its first record and keeps its tail).  With
        ``cfg.check_finite_every`` N > 0 the per-year path checks the state
        after every N-th year (diag/profiling.check_finite, named
        ``state@yr<year>``), with or without monthly means.

        Returns (state, monthly (years,12,5,y,x) | None, diag list)."""
        num = self.num
        years = years if years is not None else num.time_scnr
        if co2_series is None:
            co2_series = self._co2_series()
        co2_series = np.asarray(co2_series, F32)
        if len(co2_series) < years:
            raise ValueError(f"co2 series has {len(co2_series)} years, "
                             f"the run {years}")

        if years_per_call > 1:
            self._check_member_kernels()
        if state is None:
            state = self.initial_state()

        writer = None
        if output_path:
            from ..io.binio import OutputWriter
            writer = OutputWriter(output_path, num.xdim, num.ydim,
                                  start_record=output_start_record,
                                  truncate=output_truncate)
        try:
            if years_per_call > 1:
                return self._run_scenario_multiyear(
                    corr, state, years, co2_series, writer, years_per_call,
                    first_year)
            if self.verbose:
                print(f"% MODEL RUN; years = {years}")
                print("console output: year, co2, global avg temp, "
                      "avg temp for ipx/ipy")
            monthly_all, diags = [], []
            ft_mean, fq_mean = core.correction_annual_means(corr)
            every = self.cfg.check_finite_every
            for iy in range(years):
                co2 = co2_series[iy]
                state, outs, asum = yk.scenario_year(state, corr, co2,
                                                     self.year_data)
                if every and (iy + 1) % every == 0:
                    check_finite(state, name=f"state@yr{iy + 1}")
                if not collect_monthly:
                    continue
                monthly_np = core.monthly_means(self.month_mat,
                                                outs).cpu().numpy()
                monthly_all.append(monthly_np)
                if writer:
                    writer.write_months(monthly_np)
                diags.append(self._year_line(first_year + iy, co2,
                                             asum.cpu(), ft_mean, fq_mean))
        finally:
            if writer:
                writer.close()
        monthly_arr = np.stack(monthly_all) if monthly_all else None
        return state, monthly_arr, diags

    def _year_line(self, iy: int, co2, asum: torch.Tensor, ft_mean,
                   fq_mean) -> core.YearDiag:
        """A year's diagnostics from its annual sums (on the host, for both
        scenario paths), and its console line."""
        num = self.num
        diag = core.year_diag(core.annual_means(asum, num), num)._replace(
            ft_mean=ft_mean, fq_mean=fq_mean)
        if self.verbose:
            print(f" {num.year0 + iy + 1} {float(co2):10.4f} "
                  f"{float(diag.global_mean_ts) - 273.15:12.6f} "
                  f"{float(diag.point_ts) - 273.15:12.6f}")
        return diag

    def _run_scenario_multiyear(self, corr, state, years, co2_series,
                                writer, years_per_call, first_year):
        """Scenario phase in blocks of ``years_per_call`` years, one call of
        the multi-year kernel each (see run_scenario), through
        ``_member_blocks`` at M=1.  ``check_finite_every`` is not checked
        here: greb_tpu's multi-year path does not check it either."""
        num = self.num
        nmon = len(num.jday_mon)
        shape = (num.ydim, num.xdim)
        ppack, corrpack = self._multiyear_args(corr)
        ft_mean, fq_mean = core.correction_annual_means(corr)
        if self.verbose:
            print(f"% MODEL RUN; years = {years} "
                  f"(fused blocks of {years_per_call})")
            print("console output: year, co2, global avg temp, "
                  "avg temp for ipx/ipy")
        monthly_all, diags = [], []

        def sink(done, mon, asum):
            ny = asum.shape[1]
            mon_np = mon[0].numpy().reshape(
                (ny, nmon, core.N_OUT) + shape).copy()
            for iy in range(ny):
                monthly_all.append(mon_np[iy])
                if writer:
                    writer.write_months(mon_np[iy])
                diags.append(self._year_line(
                    first_year + done + iy, co2_series[done + iy],
                    asum[0, iy].clone(), ft_mean, fq_mean))

        state5 = self._member_blocks(state.stack()[:, None], ppack, corrpack,
                                     co2_series[:years], years_per_call, sink)
        final = ModelState.unstack(state5[:, 0])
        return final, np.stack(monthly_all), diags

    def _member_blocks(self, state5: torch.Tensor, ppack: torch.Tensor,
                       corrpack: torch.Tensor, co2_series: np.ndarray,
                       years_per_call: int, sink,
                       mxu=None) -> torch.Tensor:
        """``len(co2_series)`` scenario years of the multi-year kernel (K3)
        for the members of ``state5`` (5, M, y, x), in blocks of
        ``years_per_call`` years; returns the end state.  ``sink(done,
        monthly, asum)`` takes each block as it drains: ``done`` years
        before it, its monthly means (M, ny * 12, 5, y, x) and annual sums
        (M, ny, 9, y, x) as host tensors, which on the card are pinned
        buffers reused two blocks later (copy what must outlive the call).
        ``mxu``: K3's matmul circulation (``run_members``).

        Dispatch, then drain: block N's monthly means and sums go to pinned
        host buffers by copies queued behind it on the stream, an event
        marks them, and block N+1 is launched before the host waits on that
        event to hand N to the sink.  So the host's file writes overlap the
        card's next block."""
        num = self.num
        nmon = len(num.jday_mon)
        years, M = len(co2_series), state5.shape[1]
        shape = (num.ydim, num.xdim)
        cuda = self.device.type == "cuda"
        co2_dev = torch.as_tensor(np.asarray(co2_series, F32),
                                  device=self.device)
        if cuda and years:
            ypc = min(years_per_call, years)
            host = [(torch.empty((M, ypc * nmon, core.N_OUT) + shape,
                                 pin_memory=True),
                     torch.empty((M, ypc, yk.N_SUM) + shape, pin_memory=True))
                    for _ in range(2)]

        def drain(block):
            done, ny, mon, asum, event = block
            if event is not None:
                event.synchronize()
            sink(done, mon[:, :ny * nmon], asum[:, :ny])

        pending, done, k = None, 0, 0
        while done < years:
            ny = min(years_per_call, years - done)
            state5, monthly, asum = my.scenario_years(
                state5, ppack, corrpack, co2_dev[done:done + ny],
                self.year_data, mxu=mxu)
            event = None
            if cuda:
                h_mon, h_asum = host[k % 2]
                h_mon[:, :ny * nmon].copy_(monthly, non_blocking=True)
                h_asum[:, :ny].copy_(asum, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                monthly, asum = h_mon, h_asum
            if pending is not None:
                drain(pending)
            pending = (done, ny, monthly, asum, event)
            done += ny
            k += 1
        if pending is not None:
            drain(pending)
        return state5

    def run_members(self, members: Sequence[PhysicsParams],
                    years: Optional[int] = None, years_per_call: int = 10,
                    co2_series: Optional[np.ndarray] = None,
                    corr=None, state5: Optional[torch.Tensor] = None,
                    spinup_co2: Optional[float] = None, on_block=None,
                    mxu=None):
        """Member-batched chain, the ensemble path: a spin-up, then
        ``years`` scenario years in blocks of ``years_per_call`` through the
        multi-year kernel (K3).  The members share forcing and fold, so they
        may not differ from the model's params in a transport parameter.

        The members start from ``state5`` (5, M, y, x), by default their
        own initial states (``parallel.ensemble.ensemble_initial_state``).
        With ``corr`` None, ``time_flux`` years of the member spin-up kernel
        (K4) at ``spinup_co2`` (default: the spin-up's CO2,
        ``_spinup_co2``) give each member its own correction tables under
        its own params, and the scenario starts from the spin-up's end
        state.  Else no spin-up runs: ``corr`` is the tables K3 reads, the
        model's ``Corrections`` or a (T, 3, y, x) tensor (one table every
        member reads) or a (M or 1, T, 3, y, x) pack, and the scenario
        starts from ``state5``.

        ``on_block(done, monthly, asum)`` takes each K3 block as it drains
        (see ``_member_blocks``), so a long run of many members keeps one
        block on the host; then nothing is collected.

        ``mxu`` (a ``fastcirc2.MxuMembers``, ``members_mxu``): K4 and K3 run
        the member-batched matmul circulation at its precision, the most
        members a cluster that fit (``multiyear.default_mb``); checked
        before any launch (``_check_member_kernels``).  None: the exact
        fold, one member a cluster or block.

        Returns (state5 (5, M, y, x), the corrections K3 read (M or 1, T,
        3, y, x), and without ``on_block`` the monthly means (M, years*12,
        5, y, x) and annual sums (M, years, 9, y, x) as host numpy arrays,
        with it None, None)."""
        num, yd = self.num, self.year_data
        self._check_member_kernels(mxu)
        years = years if years is not None else num.time_scnr
        if co2_series is None:
            co2_series = self._co2_series()
        co2_series = np.asarray(co2_series, F32)[:years]
        ppack = my.pack_member_params(members, self.device)
        if state5 is None:
            state5 = ens.ensemble_initial_state(members, self.forcing)
        if isinstance(corr, Corrections):
            corrpack = torch.stack([corr.tf, corr.tof, corr.qf], dim=1)[None]
        elif corr is not None:
            corrpack = corr[None] if corr.dim() == 4 else corr
        else:
            co2 = self._spinup_co2() if spinup_co2 is None else F32(spinup_co2)
            corrpack = torch.zeros((1, num.nstep_yr, 3, num.ydim, num.xdim),
                                   dtype=torch.float32, device=self.device)
            for _ in range(num.time_flux):
                state5, corrpack = my.fluxcorr_years(state5, ppack, co2, yd,
                                                     mxu=mxu)
        monthly, asums = [], []

        def collect(done, mon, asum):
            monthly.append(mon.numpy().copy())
            asums.append(asum.numpy().copy())

        state5 = self._member_blocks(state5, ppack, corrpack, co2_series,
                                     years_per_call, on_block or collect,
                                     mxu)
        if on_block is not None or not years:
            return state5, corrpack, None, None
        return (state5, corrpack, np.concatenate(monthly, axis=1),
                np.concatenate(asums, axis=1))

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

    def run_control(self, corr: Corrections,
                    state_fc: Optional[ModelState] = None,
                    output_path: Optional[str] = None):
        """The legacy variant's control phase: ``time_ctrl`` years at
        CO2_ctrl from the spin-up end state (greb.original.model.f90:208-215;
        qflux_correction mutated Ts_ini in place at :201).

        The reference rewinds the control unit to record 1 (irec=0 at :211)
        after the nstep_yr-record TF_correct dump (:204-206) without
        truncating it: the control run's monthly records overwrite the
        dump's head, and its tail survives."""
        num = self.num
        co2 = np.full(max(num.time_ctrl, 1), self.exp.co2_ctrl, F32)
        return self.run_scenario(corr, years=num.time_ctrl, co2_series=co2,
                                 output_path=output_path, state=state_fc,
                                 output_start_record=0,
                                 output_truncate=False)
