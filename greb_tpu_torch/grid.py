"""Grid metrics and static CFL sub-cycling schedules.

All metrics reproduce the reference float32 arithmetic exactly
(reference src/greb.f90:578-582 for diffusion, :749-753 for advection):

    deg   = 2*pi*6.371e6/360          (pi = params.pi = 3.1416)
    lat   = dlat*k - dlat/2 - 90       (k = 1..ydim)
    dxlat = dlon*deg*cos(2*pi/360*lat)
    ccy_diff = kappa*dt_crcl/dyy**2 ;  ccx_diff(k) = kappa*dt_crcl/dxlat(k)**2
    ccy_adv  = dt_crcl/dyy/2        ;  ccx_adv(k)  = dt_crcl/dxlat(k)/2

Rows with ``dxlat <= 2.5e5`` m take the sub-cycled "polar" branch; the
iteration counts are pure functions of the grid + kappa + dt_crcl and are
therefore computed HERE, at trace time, with Fortran integer semantics
(nint = round-half-away-from-zero, integer division truncation;
reference src/greb.f90:651-654 and :838-840).  That removes all
data-dependent control flow from the compiled step — the polar loops
become statically-unrolled (or fori_loop) masked updates.

Grids finer than the reference's envelope — where some row's integer
sub-step ``dt_crcl/dd`` truncates to zero (the reference would divide by
zero, src/greb.f90:652-653) — switch to EXTENSION MODE: fractional
sub-steps with budget-derived per-iteration CFL caps, chosen so the
joint Fourier symbol of the split substep (zonal + advective +
meridional increments added from the same state) has modulus <= 1 for
EVERY sub-cycle depth n — including the deep polar rows whose n-iterated
zonal diffusion leaves no damping mass at the worst mode (see the
criteria in the extension branch below).  Because the meridional pass is
never sub-cycled (reference structure, src/greb.f90:585-590), extension
grids additionally require ``kappa*dt_crcl/dyy^2 <= ~0.146`` — enforced
with a clear error telling the user to lower dt_crcl (450 s at 768x384),
which is a reference namelist parameter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

F32 = np.float32


def _fortran_nint(x: float) -> int:
    """Fortran NINT: round half away from zero."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


@dataclass(frozen=True)
class PolarSchedule:
    """Static per-row sub-cycling schedule for one stencil op."""
    time2: np.ndarray    # (ydim,) int32 — iterations per row (0 = not sub-cycled)
    dtdff2: np.ndarray   # (ydim,) float32 — per-row sub-step length [s]
    ccx2: np.ndarray     # (ydim,) float32 — per-row coefficient
    max_iter: int        # max(time2)

    def active_mask(self, it: int) -> np.ndarray:
        """(ydim,) bool — rows still iterating at inner iteration ``it``."""
        return (self.time2 > it)


@dataclass(frozen=True)
class Grid:
    xdim: int
    ydim: int
    dlon: float
    dlat: float
    dt_crcl: int
    # float32 metrics (Fortran parity)
    lat: np.ndarray        # (ydim,) latitude of row centres [deg]
    dxlat: np.ndarray      # (ydim,) zonal grid length [m]
    dyy: float             # meridional grid length [m]
    ccy_diff: float
    ccx_diff: np.ndarray   # (ydim,)
    ccy_adv: float
    ccx_adv: np.ndarray    # (ydim,)
    polar_rows: np.ndarray  # (ydim,) bool — dxlat <= 2.5e5 (sub-cycled branch)
    diff_sched: PolarSchedule
    adv_sched: PolarSchedule
    extension_mode: bool = False  # capped schedules beyond the reference's
    #                               envelope (some row's integer sub-step
    #                               truncates to zero, src/greb.f90:652-653)


def joint_symbol_max(cz, nd, ca, na, u, ccy, cav,
                     n_tx: int = 257, n_ty: int = 65):
    """max over (tx, ty) of |A(tx)*D(tx) + M(ty)| — the joint Fourier
    amplification of one SEQUENTIAL-SPLIT extension substep on one row
    (uniform wz = 1, the worst case; one-sided wind u):

        D = (1 + cz*gz)^nd     zonal diffusion, nd sub-cycles
        A = (1 + ca*u*ga)^na   zonal advection on the DIFFUSED state
        M = ccy*gm + cav*gav   meridional (diffusion + advection), additive

    The sequential product A*D is the load-bearing part: the ADDITIVE form
    (reference structure, src/greb.f90:546-550) is NOT a contraction at
    deep-subcycled rows — the iterated advective increment (1+s)^na - 1
    rotates to modulus ~1.5 before upwind dissipation kills it, while the
    deep diffusion annihilates exactly those modes in the product (decay
    exponent ~ 17.6*kappa/(dt_crcl*u^2) at the pi/2-rotation mode).  See
    tests/test_extension_stability.py."""
    tx = np.linspace(0.0, np.pi, n_tx)
    ty = np.linspace(0.0, np.pi, n_ty)
    gz = (6 * np.cos(tx) + 4 * np.cos(2 * tx) + 2 * np.cos(3 * tx)
          - 12.0) / 20.0
    ez = lambda s: np.exp(-1j * s * tx)
    ga = (ez(3) + 3 * ez(2) + 6 * ez(1) - 10.0) / 20.0
    ey = lambda s: np.exp(-1j * s * ty)
    m_sym = ccy * (2 * np.cos(ty) - 2.0) + cav * (ey(2) + ey(1) - 2.0)
    d_sym = (1.0 + cz * gz) ** nd
    a_sym = (1.0 + ca * u * ga) ** na
    return float(np.abs((a_sym * d_sym)[:, None] + m_sym[None, :]).max())


def make_grid(xdim: int, ydim: int, dt_crcl: int,
              kappa: float = 8e5, pi: float = 3.1416,
              max_wind: float | None = None,
              u_rowmax: np.ndarray | None = None) -> Grid:
    """Build grid metrics with reference float32 arithmetic.

    kappa and pi must be CONCRETE here (they set static iteration counts);
    perturbing them per-ensemble keeps the base schedule (documented
    deviation — the coefficients themselves still follow the traced values
    inside the ops).

    ``max_wind`` (m/s) bounds the forcing's |u| for the EXTENSION-MODE
    stability budget (the reference-envelope schedules assume 10 m/s by
    construction, src/greb.f90:838, and are not affected).  When the actual
    climatological winds exceed the 13 m/s design bound, the advective
    amplification budget CA_MAX grows with them and the meridional-CFL
    check below tightens accordingly — without this, winds above 13 m/s
    silently violate the deep-row contraction criterion 0.35*Ca + 4*ccy
    <= 1.  Callers that know the forcing (model
    build) must pass ``np.abs(uclim).max()``.

    ``u_rowmax`` ((ydim,), m/s) — the forcing's PER-ROW annual max |u|.
    When given, EXTENSION-MODE advective sub-cycle counts are derived from
    each row's actual wind bound instead of the 10 m/s design wind
    (src/greb.f90:838): dda_k = ceil(dt_crcl*u_k/(dxlat_k*ADV_CFL)), which
    caps the per-iteration advective Courant number at ADV_CFL (0.8)
    EXACTLY — the winds are a prescribed climatology, so the row max is a
    true bound.  Two wins: (a) the amplification budget's CA_MAX becomes
    ADV_CFL by construction (uniform 13 m/s winds measured rho=1.707
    under the design-wind schedule in the JAX package — wind-aware counts
    remove that failure mode entirely), and (b) rows with weak polar winds
    iterate far less (26 -> ~7 extra iterations/substep at 384x192 with
    the synthetic climatology), which is the dominant schedule cost.
    Counts are monotonized toward each pole (cummax per hemisphere) so the
    iterating rows keep the prefix/suffix structure the folded plans
    require; monotonization only ever DEEPENS a row's count (safe).
    """
    pi = F32(pi)
    kappa = F32(kappa)
    dlon = F32(360.0) / F32(xdim)
    dlat = F32(180.0) / F32(ydim)
    deg = F32(2.0) * pi * F32(6.371e6) / F32(360.0)
    dyy = dlat * deg
    ilat = np.arange(1, ydim + 1, dtype=F32)
    lat = dlat * ilat - dlat / F32(2.0) - F32(90.0)
    dxlat = dlon * deg * np.cos(F32(2.0) * pi / F32(360.0) * lat, dtype=F32)

    dtc = F32(dt_crcl)
    ccy_diff = kappa * dtc / (dyy * dyy)
    ccx_diff = (kappa * dtc / (dxlat * dxlat)).astype(F32)
    ccy_adv = dtc / dyy / F32(2.0)
    ccx_adv = (dtc / dxlat / F32(2.0)).astype(F32)

    polar = dxlat <= F32(2.5e5)

    # --- diffusion sub-cycle schedule (src/greb.f90:651-654) --------------
    # Reference rule first; if ANY row's integer sub-step truncates to zero
    # (dd > dt_crcl — where the reference itself would divide by zero),
    # the grid is beyond the reference's envelope and BOTH schedules are
    # rebuilt with the capped EXTENSION rule below.
    def ref_diff(k):
        # dd = max(1, nint(dt_crcl/(1.*dxlat**2/kappa)))
        return max(1, _fortran_nint(
            float(dtc / (F32(1.0) * dxlat[k] * dxlat[k] / kappa))))

    def ref_adv(k):
        # dd = max(1, nint(dt_crcl/(dxlat/10.0/1.)))
        return max(1, _fortran_nint(
            float(dtc / (dxlat[k] / F32(10.0) / F32(1.0)))))

    extension = any(
        polar[k] and (int(dt_crcl) // ref_diff(k) < 1
                      or int(dt_crcl) // ref_adv(k) < 1)
        for k in range(ydim))

    if extension:
        # EXTENSION MODE — new numerical ground, designed for stability
        # rather than reproduction (the reference cannot run such grids).
        # The substep adds three increments computed from the same state
        # (zonal, advective, meridional), so their amplification budgets
        # ADD at the joint worst Fourier mode.  TWO criteria govern it
        # (gz(pi) = -16/20, ga(pi) = -14/40, gm(pi) = -2 each side):
        #
        # 1. DEEP-SUBCYCLED rows: the n-iterated zonal diffusion factor
        #    (1 + cz*gz)^n collapses to ~0 at the worst zonal mode for
        #    n >= ~3, so it contributes NO stabilizing mass there — the
        #    advective + meridional terms must be a contraction ON THEIR
        #    OWN:  0.35*Ca + 4*ccy <= 1 - margin.  (At
        #    dt_crcl=900/768x384 this sum is 1.52 and the composite band
        #    blew up within ~150 substeps even though every single-apply
        #    budget held.)  With the advective CFL capped at 0.8 per
        #    iteration at the 10 m/s design wind (real winds ~13 m/s ->
        #    Ca <= 1.04, 0.35*Ca <= 0.37), this requires ccy <= 0.14 —
        #    enforced below via dt_crcl, a reference namelist parameter
        #    (the meridional pass is never sub-cycled; reference
        #    structure, src/greb.f90:585-590).
        # 2. SINGLE-APPLY rows:  0.8*cz + 0.35*Ca + 4*ccy <= 1.95, giving
        #    the zonal cap  cz_cap = (1.95 - 0.37 - 4*ccy)/0.8, clipped
        #    to [0.4, 1.2].
        #
        # Verified numerically over (theta_x, theta_y) for n in 1..5000 at
        # the operating points 384x192/dt_crcl=1800 and 768x384/dt_crcl=450
        # (both ccy = 0.133): max |lambda| <= 1 with ~0.07 deep-row margin.
        U_DESIGN = 10.0          # reference's assumed wind (src/greb.f90:838)
        ADV_CFL = 0.8            # per-iteration advective CFL at U_DESIGN
        if u_rowmax is not None:
            # wind-aware schedule: per-row counts from the forcing's true
            # row bounds -> per-iteration Courant <= ADV_CFL everywhere,
            # so the budget's advective amplification is ADV_CFL exactly
            u_row = np.abs(np.asarray(u_rowmax, np.float64)).reshape(-1)
            if u_row.shape[0] != ydim:
                raise ValueError(
                    f"u_rowmax has {u_row.shape[0]} rows, grid has {ydim}")
            u_row = np.maximum(u_row, 1e-6)
            CA_MAX = ADV_CFL
            wind_bound = float(u_row.max())
        else:
            # budget wind: the advective sub-cycle count keeps the
            # per-iteration CFL at ADV_CFL only for winds <= U_DESIGN; real
            # winds scale it linearly, so the amplification budget must use
            # the actual forcing bound (>= the 13 m/s synthetic-wind design
            # point for backward compatibility when the caller can't know it)
            wind_bound = max(13.0, float(max_wind)) if max_wind is not None \
                else 13.0
            CA_MAX = wind_bound / U_DESIGN * ADV_CFL
            u_row = np.full(ydim, U_DESIGN)
        # The enforced stability gate is the NUMERICAL per-row joint-symbol
        # check below (it provably subsumes the old analytic CCY_MAX gate:
        # when deep rows annihilate the zonal product A*D, the meridional
        # term must contract alone, i.e. |ccy*gm + cav*gav| <= 1 — the
        # check refuses 768x384 at dt_crcl=900/1800 and admits 450-600).
        # CCY_MAX survives only to shape the zonal per-iteration cap.
        CCY_MAX = (1.0 - 0.05 - 0.35 * CA_MAX) / 4.0     # 0.146 at 13 m/s
        CZ_CAP = float(np.clip(
            (1.95 - 0.35 * CA_MAX - 4.0 * float(ccy_diff)) / 0.8, 0.4, 1.2))

        t2d = np.zeros(ydim, np.int32)
        s2d = np.zeros(ydim, F32)
        c2d = np.zeros(ydim, F32)
        t2a = np.zeros(ydim, np.int32)
        s2a = np.zeros(ydim, F32)
        c2a = np.zeros(ydim, F32)
        dda_raw = np.zeros(ydim, np.int64)
        for k in range(ydim):
            if not polar[k]:
                continue
            xnum = float(dtc) * float(kappa) / float(dxlat[k]) ** 2
            dd = max(1, int(np.ceil(xnum / CZ_CAP)))
            sub = dtc / F32(dd)
            t2d[k] = dd
            s2d[k] = F32(sub)
            c2d[k] = kappa * F32(sub) / (dxlat[k] * dxlat[k])
            dda_raw[k] = max(1, int(np.ceil(
                float(dtc) * float(u_row[k]) / (float(dxlat[k]) * ADV_CFL))))
        # monotonize the advective counts toward each pole (cummax per
        # hemisphere over the polar rows) so iterating rows stay a
        # prefix/suffix — the static structure the folded plans require.
        # Deepening a count only lowers its per-iteration Courant: safe.
        half = ydim // 2
        run = 0
        for k in range(half - 1, -1, -1):
            if polar[k]:
                run = max(run, int(dda_raw[k]))
                dda_raw[k] = run
        run = 0
        for k in range(half, ydim):
            if polar[k]:
                run = max(run, int(dda_raw[k]))
                dda_raw[k] = run
        for k in range(ydim):
            if not polar[k]:
                continue
            dda = int(dda_raw[k])
            suba = dtc / F32(dda)
            t2a[k] = dda
            s2a[k] = F32(suba)
            c2a[k] = F32(suba) / dxlat[k] / F32(2.0)
        # --- numerical joint-symbol verification (the enforced criterion) --
        # Extension substeps use SEQUENTIAL zonal splitting (advection on
        # the diffused state; ops/fastcirc.FastPlan.seq_zonal), whose joint
        # symbol A*D + M is computed here per row at the row's wind bound.
        # Exceeding 1 means the linearized substep amplifies some mode —
        # refuse rather than integrate garbage (the r2/r3 blow-ups were
        # exactly such modes; tests/test_extension_stability.py).
        cav = float(dtc) / float(dyy) / 2.0 * 15.0     # meridional wind bound
        worst, worst_k = 0.0, -1
        for k in range(ydim):
            if not polar[k]:
                continue
            lam = joint_symbol_max(float(c2d[k]), int(t2d[k]),
                                   float(c2a[k]), int(t2a[k]),
                                   float(u_row[k]) if u_rowmax is not None
                                   else wind_bound,
                                   float(ccy_diff), cav)
            if lam > worst:
                worst, worst_k = lam, k
        if worst > 1.0 + 1e-6:
            raise ValueError(
                f"grid {xdim}x{ydim} dt_crcl={dt_crcl}: extension substep "
                f"amplifies (max |lambda| = {worst:.3f} at row {worst_k}, "
                f"wind bound {wind_bound:.1f} m/s) — reduce dt_crcl or the "
                f"forcing winds (see grid.joint_symbol_max)")

        diff_sched = PolarSchedule(time2=t2d, dtdff2=s2d, ccx2=c2d,
                                   max_iter=int(t2d.max(initial=0)))
        adv_sched = PolarSchedule(time2=t2a, dtdff2=s2a, ccx2=c2a,
                                  max_iter=int(t2a.max(initial=0)))
        return Grid(
            xdim=xdim, ydim=ydim, dlon=float(dlon), dlat=float(dlat),
            dt_crcl=dt_crcl, lat=lat, dxlat=dxlat, dyy=float(dyy),
            ccy_diff=float(ccy_diff), ccx_diff=ccx_diff,
            ccy_adv=float(ccy_adv), ccx_adv=ccx_adv,
            polar_rows=polar, diff_sched=diff_sched, adv_sched=adv_sched,
            extension_mode=True,
        )

    t2d = np.zeros(ydim, np.int32)
    s2d = np.zeros(ydim, F32)
    c2d = np.zeros(ydim, F32)
    for k in range(ydim):
        if not polar[k]:
            continue
        dd = ref_diff(k)
        dtdff2 = int(dt_crcl) // dd                # Fortran integer division
        time2 = max(1, _fortran_nint(float(dtc) / float(dtdff2)))
        t2d[k] = time2
        s2d[k] = F32(dtdff2)
        c2d[k] = kappa * F32(dtdff2) / (dxlat[k] * dxlat[k])
    diff_sched = PolarSchedule(time2=t2d, dtdff2=s2d, ccx2=c2d,
                               max_iter=int(t2d.max(initial=0)))

    # --- advection sub-cycle schedule (src/greb.f90:838-840) --------------
    t2a = np.zeros(ydim, np.int32)
    s2a = np.zeros(ydim, F32)
    c2a = np.zeros(ydim, F32)
    for k in range(ydim):
        if not polar[k]:
            continue
        dd = ref_adv(k)
        dtdff2 = int(dt_crcl) // dd
        time2 = max(1, _fortran_nint(float(dtc) / float(dtdff2)))
        t2a[k] = time2
        s2a[k] = F32(dtdff2)
        c2a[k] = F32(dtdff2) / dxlat[k] / F32(2.0)
    adv_sched = PolarSchedule(time2=t2a, dtdff2=s2a, ccx2=c2a,
                              max_iter=int(t2a.max(initial=0)))

    return Grid(
        xdim=xdim, ydim=ydim, dlon=float(dlon), dlat=float(dlat),
        dt_crcl=dt_crcl, lat=lat, dxlat=dxlat, dyy=float(dyy),
        ccy_diff=float(ccy_diff), ccx_diff=ccx_diff,
        ccy_adv=float(ccy_adv), ccx_adv=ccx_adv,
        polar_rows=polar, diff_sched=diff_sched, adv_sched=adv_sched,
    )


def month_average_matrix(jday_mon: Tuple[int, ...], ndt_days: int) -> np.ndarray:
    """(12, nstep_yr) float32 matrix M with M[m,t] = 1/steps_in_month(m) for
    steps t falling in month m, else 0.  ``monthly = einsum('mt,t...->m...')``
    reproduces the reference monthly means (src/greb.f90:973-982) as a single
    MXU matmul instead of 60 scalar-triggered flushes."""
    nstep = sum(jday_mon) * ndt_days
    out = np.zeros((len(jday_mon), nstep), F32)
    t = 0
    for m, nd in enumerate(jday_mon):
        n = nd * ndt_days
        out[m, t:t + n] = F32(1.0) / F32(n)
        t += n
    assert t == nstep
    return out
