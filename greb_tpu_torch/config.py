"""Configuration: the reference namelist groups as plain dataclasses.

Mirrors ``greb_tpu.config`` (reference src/greb.f90:32-158):

- ``Numerics``     : grid, calendar and run lengths (python ints).
- ``PhysicsParams``: a dataclass of numpy float32 scalars plus the (10,)
                     ``p_emi`` fit.  Scalar arithmetic between two params
                     stays in float32, as in the JAX package.
- ``Diagnostics``  : output file naming.
- ``CO2Params``    : CO2 pathway (flux-correction level + scenario series).
- ``Experiment``   : the legacy ``log_exp`` switchboard of the original
                     variant (reference src/greb.original.model.f90), with
                     the same derived flags as ``greb_tpu.config``: every
                     ``log_exp`` 0-16 and the modern variant
                     (``log_exp=None``); 7, 8 and 16 transport Ta (and
                     under 8 q) with the strict stencils.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

F32 = np.float32


@dataclass(frozen=True)
class Numerics:
    xdim: int = 96                 # number of longitudes
    ydim: int = 48                 # number of latitudes
    ndays_yr: int = 365            # days per year
    dt: int = 12 * 3600            # model time step [s]
    dt_crcl: int = 1800            # circulation time step [s]
    jday_mon: Tuple[int, ...] = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
    ireal: int = 4                 # record word length [bytes]

    time_flux: int = 0             # flux-correction phase length [yr]
    time_ctrl: int = 0             # control phase length [yr] (legacy variant)
    time_scnr: int = 0             # scenario phase length [yr]
    ipx: int = 1                   # diagnostic point, x (1-based, as Fortran)
    ipy: int = 1                   # diagnostic point, y (1-based)
    year0: int = 1940              # scenario start year

    @property
    def ndt_days(self) -> int:
        return 24 * 3600 // self.dt

    @property
    def nstep_yr(self) -> int:
        return self.ndays_yr * self.ndt_days

    @property
    def dlon(self) -> float:
        return 360.0 / self.xdim

    @property
    def dlat(self) -> float:
        return 180.0 / self.ydim

    @property
    def nsub_crcl(self) -> int:
        """Circulation substeps per model step (reference src/greb.f90:543)."""
        return max(1, int(round(float(self.dt) / self.dt_crcl)))

    def validate(self) -> "Numerics":
        if not (self.xdim >= 8 and self.ydim >= 6):
            raise ValueError("grid too small for stencils")
        if sum(self.jday_mon) != self.ndays_yr:
            raise ValueError("jday_mon must sum to ndays_yr")
        if 24 * 3600 % self.dt:
            raise ValueError("dt must divide a day")
        return self


@dataclass(frozen=True)
class PhysicsParams:
    """Reference defaults: src/greb.f90:68-101 (as greb_tpu.config)."""
    pi: np.float32
    sig: np.float32
    rho_ocean: np.float32
    rho_land: np.float32
    rho_air: np.float32
    cp_ocean: np.float32
    cp_land: np.float32
    cp_air: np.float32
    eps: np.float32
    d_ocean: np.float32
    d_land: np.float32
    d_air: np.float32
    ct_sens: np.float32
    da_ice: np.float32
    a_no_ice: np.float32
    a_cloud: np.float32
    Tl_ice1: np.float32
    Tl_ice2: np.float32
    To_ice1: np.float32
    To_ice2: np.float32
    co_turb: np.float32
    kappa: np.float32
    ce: np.float32
    cq_latent: np.float32
    cq_rain: np.float32
    z_air: np.float32
    z_vapor: np.float32
    r_qviwv: np.float32
    c_effmix: np.float32
    p_emi: np.ndarray      # (10,) float32 emissivity fit parameters

    @classmethod
    def default(cls) -> "PhysicsParams":
        f = F32
        return cls(
            pi=f(3.1416), sig=f(5.6704e-8), rho_ocean=f(999.1),
            rho_land=f(2600.0), rho_air=f(1.2), cp_ocean=f(4186.0),
            cp_land=f(926.222), cp_air=f(1005.0), eps=f(1.0),
            d_ocean=f(50.0), d_land=f(2.0), d_air=f(5000.0),
            ct_sens=f(22.5), da_ice=f(0.25), a_no_ice=f(0.1),
            a_cloud=f(0.35), Tl_ice1=f(273.15 - 10.0), Tl_ice2=f(273.15),
            To_ice1=f(273.15 - 7.0), To_ice2=f(273.15 - 1.7),
            co_turb=f(5.0), kappa=f(8e5), ce=f(2e-3), cq_latent=f(2.257e6),
            cq_rain=f(F32(-0.1) / F32(24.0) / F32(3600.0)),
            z_air=f(8400.0), z_vapor=f(5000.0), r_qviwv=f(2.6736e3),
            c_effmix=f(0.5),
            p_emi=np.asarray(
                [9.0721, 106.7252, 61.5562, 0.0179, 0.0028,
                 0.0570, 0.3462, 2.3406, 0.7032, 1.0662], dtype=F32),
        )

    def replace(self, **kw) -> "PhysicsParams":
        return dataclasses.replace(
            self, **{k: F32(v) if np.isscalar(v) else np.asarray(v, F32)
                     for k, v in kw.items()})


@dataclass(frozen=True)
class Diagnostics:
    output_file: str = "output/scenario"
    ens_id: str = ""
    console: bool = True      # print annual means like the reference
    store_monthly: bool = True   # greb_tpu's field; neither package reads it

    @property
    def output_file_full(self) -> str:
        return self.output_file if not self.ens_id else f"{self.output_file}_{self.ens_id}"


@dataclass(frozen=True)
class CO2Params:
    co2_flux: float = 298.0          # level during the flux-correction phase
    co2_ppm: Tuple[float, ...] = ()  # scenario series (one value per year)

    def series(self, time_scnr: int) -> np.ndarray:
        """Pad the annual series per the reference semantics
        (src/greb.f90:1053-1061): empty -> constant 680; negatives replaced
        by the last positive value."""
        out = np.full((max(time_scnr, 1),), -1.0, dtype=F32)
        vals = np.asarray(self.co2_ppm, dtype=F32)
        out[: min(len(vals), len(out))] = vals[: len(out)]
        if len(out) and out[0] < 0:
            out[0] = 680.0
        for i in range(1, len(out)):
            if out[i] < 0:
                out[i:] = out[i - 1]
                break
        return out


@dataclass(frozen=True)
class Experiment:
    """Legacy experiment switchboard (reference src/greb.original.model.f90);
    ``log_exp`` changes which processes run, so it is fixed per run."""
    log_exp: Optional[int] = None    # None => modernized variant (no switches)

    @property
    def active(self) -> bool:
        return self.log_exp is not None

    @property
    def flat_topo(self) -> bool:            # :162
        return self.active and self.log_exp == 1

    @property
    def const_cloud(self) -> bool:          # :163
        return self.active and self.log_exp <= 2

    @property
    def const_vapor(self) -> bool:          # :164
        return self.active and self.log_exp <= 3

    @property
    def no_deep_ocean_mld(self) -> bool:    # :165-166 (mldclim = d_ocean)
        return self.active and (self.log_exp <= 9 or self.log_exp == 11)

    @property
    def fixed_albedo(self) -> bool:         # :394
        return self.active and self.log_exp <= 5

    @property
    def simple_seaice(self) -> bool:        # :492-496
        return self.active and self.log_exp <= 5

    @property
    def hydro_off(self) -> bool:            # :453
        return self.active and (self.log_exp <= 6 or self.log_exp in (13, 15))

    @property
    def circulation_off(self) -> bool:      # :553
        return self.active and self.log_exp <= 4

    @property
    def vapor_circulation_off(self) -> bool:  # :554-555 (exp 7 and 16)
        return self.active and self.log_exp in (7, 16)

    @property
    def vapor_diffusion_only(self) -> bool:  # :560
        return self.active and self.log_exp == 8

    @property
    def deep_ocean_off(self) -> bool:       # :514-515
        return self.active and (self.log_exp <= 9 or self.log_exp == 11
                                or 14 <= self.log_exp <= 16)

    @property
    def linear_vapor_lw(self) -> bool:      # :423,430
        return self.active and self.log_exp == 11

    @property
    def a1b_co2(self) -> bool:              # :179, :946
        return self.active and self.log_exp in (12, 13)

    @property
    def sst_plus_one(self) -> bool:         # :225-226 (exp 14-16)
        return self.active and 14 <= self.log_exp <= 16

    @property
    def co2_ctrl(self) -> float:            # :178-179
        return 298.0 if self.a1b_co2 else 340.0


@dataclass(frozen=True)
class GrebConfig:
    numerics: Numerics = field(default_factory=Numerics)
    diagnostics: Diagnostics = field(default_factory=Diagnostics)
    co2: CO2Params = field(default_factory=CO2Params)
    experiment: Experiment = field(default_factory=Experiment)
    # greb_tpu's two XLA/Pallas switches (unroll_circulation, use_pallas),
    # accepted so a config of either package builds in the other, and
    # without effect here: every path of the port runs the hand-written
    # kernels on the card (their plain versions on the CPU), whatever
    # these say
    unroll_circulation: bool = False
    # the reference debug build's FPE traps (Makefile:10): check the state
    # for NaN/Inf after every N-th year of the per-year scenario loop and
    # raise FloatingPointError naming the fields (diag/profiling.py
    # check_finite); 0 = off
    check_finite_every: int = 0
    use_pallas: bool = False
    # True: the coefficient-folded circulation (ops/fastcirc2.py), which
    # the CLI runs unless --strict-circulation; False: the strict
    # term-by-term stencils (ops/stencils.py).  The default is greb_tpu's.
    fast_circulation: bool = False
    fastcirc_version: int = 2
    fidelity_jp2_quirk: bool = True   # reproduce src/greb.f90:881 index quirk

    def physics_defaults(self) -> PhysicsParams:
        return PhysicsParams.default()


def config_from_namelist(path: str) -> Tuple[GrebConfig, PhysicsParams]:
    """Build (GrebConfig, PhysicsParams) from a Fortran namelist file,
    mirroring PROGRAM greb_run (src/greb.f90:1042-1068)."""
    from .io.namelist import read_namelist

    groups = read_namelist(path)
    phys = dict(groups.get("physics_par", {}))
    num = dict(groups.get("numerics_par", {}))
    diag = dict(groups.get("diagnostics_par", {}))
    co2 = dict(groups.get("co2_par", {}))
    legacy_num = dict(groups.get("numerics", {}))
    legacy_phys = dict(groups.get("physics", {}))

    numerics = Numerics(
        time_flux=int(num.get("time_flux", legacy_num.get("time_flux", 0))),
        time_ctrl=int(legacy_num.get("time_ctrl", 0)),
        time_scnr=int(num.get("time_scnr", legacy_num.get("time_scnr", 0))),
        ipx=int(num.get("ipx", 1)),
        ipy=int(num.get("ipy", 1)),
        year0=int(num.get("year0", 1940)),
    ).validate()

    diagnostics = Diagnostics(
        output_file=str(diag.get("output_file", "output/scenario")),
        ens_id=str(diag.get("ens_id", "")),
    )

    co2_ppm = co2.get("co2_ppm", ())
    if np.isscalar(co2_ppm):
        co2_ppm = (float(co2_ppm),)
    co2_params = CO2Params(
        co2_flux=float(co2.get("co2_flux", 298.0)),
        co2_ppm=tuple(float(v) for v in co2_ppm),
    )

    experiment = Experiment(
        log_exp=int(legacy_phys["log_exp"]) if "log_exp" in legacy_phys else None)

    params = PhysicsParams.default()
    known = {f.name for f in dataclasses.fields(PhysicsParams)}
    overrides = {k: v for k, v in phys.items() if k in known}
    if overrides:
        params = params.replace(**overrides)

    cfg = GrebConfig(numerics=numerics, diagnostics=diagnostics,
                     co2=co2_params, experiment=experiment)
    return cfg, params
