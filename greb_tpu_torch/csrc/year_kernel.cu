// Fused GREB year kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of greb_tpu/ops/pallas/:
//   fluxcorr_year  <- year_kernel.py build_fluxcorr_year (:353): one spin-up
//                     year; writes each step's (tf, tof, qf) correction slice.
//   scenario_year  <- year_kernel.py build_scenario_year (:231): one scenario
//                     year; writes the 5 output fields of every step and the
//                     sequential float32 annual sums of all 9 step outputs.
//   fluxcorr_years <- multiyear.py build_fluxcorr_years (:253): fluxcorr_year
//                     for M members, each with its own physics parameters.
//   scenario_years <- multiyear.py build_scenario_years (:107): n_years
//                     scenario years for M members, CO2 from a table per
//                     year; monthly means (weight 1/steps-in-month) and the 9
//                     annual sums add up in the kernel, with no per-step
//                     outputs.  Each member reads its own correction
//                     table, or all read one shared table (corr_shared:
//                     an ensemble's shared spin-up, which the JAX CLI
//                     broadcasts as a member axis of 1).
// All four run the same per-cell __device__ functions, so they round alike:
// the pointwise physics and state update (ops/pointwise.py, core.*_step),
// the fold's per-step coefficients (ops/fastcirc2.py step_coeffs) and the
// nsub circulation substeps (fastcirc2.substep): the 7-point zonal
// diffusion, the band clamp, the dense pole composite rows, the 7-point
// zonal advection, the band clamp, the merged 5-point meridional step and
// the combine.
//
// All four run on one cluster body (run_cluster), one member per
// thread-block cluster: the single-run kernels are one member with the
// host's physics; the member kernels launch M clusters, cluster m reading
// row m of the member pack and its own slice of every global buffer, and
// scenario_years loops over n_years inside the kernel.  One member's years
// are spread over a cluster of C blocks (C = 8, 12 or 16, a launch
// argument; 12 and 16 are above the portable 8; scenario_years 12 or 16:
// its block with a pole row does not fit 8).  Block b owns the
// R = Y/C latitude rows [b*R, (b+1)*R) and keeps in its own shared memory,
// for the whole year, everything those rows read every substep: the 5-field
// state, a double buffer of the two transported fields with +-2 halo rows,
// the step's 12 coefficient planes (built at each step start from the
// fold's zam/mer planes and the step's wind), the 7 zonal-diffusion planes,
// wz, the two 96x96 composite matrices of any pole row it holds, (scenario
// kernels) the 9 annual sums, written out once at each year's end, and
// (scenario_years) the month's 5 means, written out once at each month's
// end.  The state stays in shared memory from one year to the next.  No
// coefficient is read from global memory inside the substep loop.  The
// meridional 5-point stencil reads 2 rows beyond the block: every block
// pushes the first and last 2 rows of each buffer it writes into its
// neighbours' halo slots through distributed shared memory, as it writes
// them, so a substep reads only its own shared memory.  With the double
// buffer one cluster.sync() per substep is enough: no block writes a
// buffer until every block has finished reading it.  One more follows each
// step start (its pushed (Ta, q) rows), one precedes the first remote write
// (every block's shared memory is live) and one the exit (no block leaves
// while another may still write into it).  The zonal stencils, band clamps
// and composite rows are row-local: the composite row sum needs only its
// block's __syncthreads(), and is split into partial sums of COMP_BLOCK
// terms, 4 columns a thread, then summed in the same order.
//
// What bounds the cluster kernel: latency, not bandwidth.  A substep is one
// (field, cell) a thread at C=16: ~31 shared-memory loads (11 taps, 19
// coefficients, wz) and ~60 float32 operations, then, in the two blocks
// that hold a pole row, the composite row sums, which every other block
// waits for at the cluster barrier, and the barrier itself.  On an H100
// (700 W, chip_smoke.py) a substep at C=16 takes ~2.3 us: ~1.3 us without
// the pole composites, and ~0.76 us of it the barrier, whose release (the
// pushed halo rows must be visible) compiles to a GPU-scope memory barrier
// (a relaxed barrier costs ~0.1 us, but orders nothing).  The sweep over C
// reads ~3.0 us a substep at C=8 (two cells for some threads), ~2.5 at
// C=12 and ~2.3 at C=16, with no block reading beyond its own shared
// memory at any C.  The step outside the substeps (its start, the physics
// reading the step's forcing from global memory) is ~5 us.  The whole-card
// bound (PERF.md) counts operations and is far lower: one run on 16 SMs
// does not fill 132.  M members run as many clusters at once as the card
// schedules (cudaOccupancyMaxActiveClusters), the rest in waves.
//
// The one-block body of scenario_years (run_years, C = 1): one thread
// block of NT threads per member (blockIdx.x), looping over n_years x T
// model steps, with the 5-field state (90 KiB at 96x48) and a (Ta, q)
// double buffer (2 x 36 KiB) in dynamic shared memory.  The fold's planes,
// each step's forcing and a per-member coefficient scratch (written each
// step start) are read from global memory / L2, so a member is bound by one
// SM's reads from L2; the monthly means and annual sums are
// read-modified-written in global memory every step.  A member's year takes
// ~7x a cluster's, but 132 members run at once, one an SM, where the card
// runs 7 clusters of 12 or 16 blocks at once: past ~50 members it gives
// more member-years a second (PERF.md; ops/cuda/multiyear.py
// default_cluster).
//
// Numerics.  Built without --use_fast_math and with --fmad=false, so every
// float32 operation rounds as in the plain PyTorch version and in the JAX
// package: expf/logf/sqrtf, ts**4 as (t*t)*(t*t), the same association of
// every sum (the 7-point sums as the JAX balanced tree), true division.
// The composite row sums follow the plain version's blocked order
// (fastcirc2._row_dot), which differs from the JAX package's library dot.
//
// The legacy log_exp switchboard (reference src/greb.original.model.f90;
// greb_tpu/config.py Experiment) and the transport come in
// GrebParams::flags, one bit per switch of the step body (enum Flag;
// ops/cuda/year_kernel.py FLAGS):
// fixed albedo, the simple sea-ice capacity, no hydrology, no deep-ocean
// exchange and the linearised vapour feedback in the pointwise physics,
// SST = Tclim + 1 over the ocean at the start of a scenario step, no
// circulation (no substeps; the step takes Ta and q uncirculated), and
// the strict transport with its two vapour switches.  Each branch repeats
// the plain version's float32 operations.  Every kernel has three
// instantiations: LEGACY = false, the modern variant, compiles without the
// branches (flags 0); LEGACY = true moves Ta and q with the fold and
// branches on the flags word, which is the same for every thread of a
// launch; and the strict one (below) runs the strict transport or none,
// with the same branches.  The launchers pick one by the word and refuse a
// word with a bit they do not know or a combination none runs.
//
// The refined instantiation (run_refined; all four kernels) runs the folds
// whose planes a cluster block cannot hold, reading them from L2:
// extension-mode grids (384x192, suffix _refined) and 192x96's additive
// form (suffix _additive), each modern and legacy (suffix _legacy); and
// the strict transport at an extension-mode grid (suffix _strict_refined);
// see its section below; its entries build in refined_kernel.cu.  The
// forms of the grids between 192x96 and 384x192 (additive splitting with
// packed composites, and the strict transport where the cluster body does
// not hold it) are this file's device code too; their entries build in
// band_kernel.cu.  The member kernels' matmul circulation (mb members a
// cluster) builds in members_kernel.cu on the cluster body's functions.
//
// The strict transport.  Where the JAX package builds no fold (its
// GREB.fastcirc_tables() is None: --strict-circulation, and legacy
// log_exp 7, 8, 16), the four Pallas builders trace core.compute_tendencies
// at fastcirc=None, and every kernel runs the term-by-term stencils of
// ops/stencils.py circulation in its body: Ta and q, or under log_exp 7
// and 16 Ta alone, under 8 Ta plus q by diffusion alone.  Here that is the
// third instantiation of each kernel, run_cluster<KIND, true, true> (suffix
// _strict), picked by the STRICT_TRANSPORT bit of the flags word; it also
// runs the words without transport (CIRCULATION_OFF), since neither has a
// fold.  Its block keeps no fold planes and no pole composites: the state,
// the same double buffer of (Ta, q) with pushed +-2 halo rows, wz of both
// fields with +-2 zero halo rows past the poles, the step's winds, the
// rows' constants and a scratch of four (2, R, X) planes for the polar
// sub-cycles.  A substep (strict_substep) computes each (field, cell) of a
// row without a polar sub-cycle at once (strict_value: the 7-point zonal
// diffusion and 3-point meridional diffusion, weighted by wz, and the
// 2-point zonal and 5-point meridional upwind advection, in the plain
// version's float32 order); the sub-cycled rows (at 96x48 rows 0-9 and
// 38-47: diffusion 8 iterations on rows 0 and 47, 1 on the others;
// advection 1) iterate both clamped sub-cycles from the substep's state in
// the scratch, block-uniformly to the block's largest count with a
// __syncthreads() between iterations, a row adding 0 past its own count as
// the plain version's masks do, and are finished after them.  What bounds
// a strict substep: its ~26 shared-memory loads a cell (taps and wz taps
// of 5 rows), then the pole blocks' sub-cycle iterations (8 dependent
// rounds of a 7-point stencil and a barrier), which every other block
// waits for at the cluster barrier, and that barrier.  The design keeps
// every read in shared memory and the exchange to one cluster barrier a
// substep, as the fold does; the pole blocks' serial iterations are left
// as they are (ROADMAP Queue 2: a strict year runs ~3.5x the fold's).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NT 1024
#define COMP_BLOCK 8      // = fastcirc2.COMP_BLOCK
#define N_SUM 9           // annual sums: the 9 StepOutputs fields
#define N_OUT 5           // written fields: ts, ta, to, q, albedo
#define HALO 2            // meridional stencil reach, rows
#define MAX_CLUSTER 16    // largest (non-portable) cluster on Hopper
#define MAX_SMEM 232448   // shared memory one block may use (227 KB)

// error codes of the launchers beside cudaError_t's (which are >= 0)
#define GREB_ERR_LAYOUT (-1)      // C does not split the grid, or too big
#define GREB_ERR_NO_CLUSTER (-2)  // no cluster of this shape fits the card
#define GREB_ERR_FLAGS (-3)       // a flags word the kernel does not run
#define GREB_ERR_RESIDENT (-4)    // the wide form's clusters not all resident

struct GrebParams {
  float sig, rho_air, ct_sens, da_ice, a_no_ice, a_cloud;
  float Tl_ice1, Tl_ice2, To_ice1, To_ice2;
  float co_turb, ce, cq_latent, cq_rain, r_qviwv, c_effmix;
  float p_emi[10];
  float cap_ocean, cap_land, cap_air;
  float dt;    // model step [s]
  float co2;   // this year's CO2 [ppm]
  int flags;   // the legacy switchboard (enum Flag); 0: the modern variant
};

// The bits of GrebParams::flags (ops/cuda/year_kernel.py FLAGS).
enum Flag {
  FIXED_ALBEDO = 1,      // log_exp <= 5: surface albedo a_no_ice
  SIMPLE_SEAICE = 2,     // log_exp <= 5: no sea-ice ramp
  HYDRO_OFF = 4,         // log_exp <= 6, 13, 15: no hydrological cycle
  CIRCULATION_OFF = 8,   // log_exp <= 4: no transport of Ta and q
  DEEP_OCEAN_OFF = 16,   // log_exp <= 9, 11, 14-16: no deep-ocean exchange
  LINEAR_VAPOR_LW = 32,  // log_exp 11: linearised vapour feedback
  SST_PLUS_ONE = 64,     // log_exp 14-16: ocean Ts = Tclim + 1 (scenario)
  STRICT_TRANSPORT = 128,        // the strict stencils move Ta and q:
                                 // --strict-circulation, log_exp 7, 8, 16
  VAPOR_CIRCULATION_OFF = 256,   // log_exp 7, 16: q does not move
  VAPOR_DIFFUSION_ONLY = 512,    // log_exp 8: q moves by diffusion alone
  KNOWN_FLAGS = 1023
};

// The linearised vapour feedback's coefficient (greb.original.model.f90:
// 430), rounded once to float32 (ops/pointwise.py LINEAR_VAPOR_LW_C).
#define LINEAR_VAPOR_LW_C ((float)(0.022 / (0.15 * 24.0)))

// Switch f is on: never in the modern instantiation, which compiles
// without the branch.
template <bool LEGACY>
__device__ __forceinline__ bool on(const GrebParams& p, int f) {
  return LEGACY && (p.flags & f) != 0;
}

struct YearArgs {
  // forcing: (T, Y, X) each, sw_solar (T, Y)
  const float *tclim, *qclim, *swet, *u, *v, *mld, *mld_prev, *cld, *sw_solar;
  // constant fields (Y, X)
  const float *z_topo, *glacier, *wz_air, *z_ocean, *toclim;
  // fold constants
  const float *zd;     // (7, 2, Y, X)
  const float *zam;    // (8, 2, Y, X)
  const float *mer;    // (9, 2, Y, X)
  const float *wz;     // (2, Y, X)
  const float *pcomp;  // (2, K, X, X), K = ktc + kbc
  // correction tables: step t of member m at (m*T + t)*corr_step, or at
  // t*corr_step for every member where corr_shared is set (K3 only: one
  // table that every member reads, an ensemble's shared spin-up); read by
  // the scenario kernels, written by the spin-up kernels
  float *tf, *tof, *qf;
  float *outs;         // scenario_year: (T, 5, Y, X)
  float *asum;         // scenario_year: (9, Y, X); scenario_years:
                       // (M, n_years, 9, Y, X)
  float *monthly;      // scenario_years: (M, n_years*nmon, 5, Y, X)
  const int *mon;      // scenario_years: (T,) month of each step
  const float *mon_w;  // scenario_years: (T,) weight 1/steps-in-month
  const float *co2_years;  // scenario_years: (n_years,) CO2 [ppm]
  const float *ppack;  // member kernels: (M, n_pack) physics parameters
  const float *state_in;  // (5, M, Y, X): ts, ta, to, q, cap_surf
  float *state_out;       // (5, M, Y, X)
  float *cf;              // one-block body's scratch (M, 12, 2, Y, X):
                          // za 7, mc 4, c0m 1
  // the strict stencils' constants (ops/stencils.py)
  const float* st_wz;     // (2, Y, X) wz_air, wz_vapor
  const float* st_rows;   // (4, Y) dxlat^2, diffusion sub-step dtdff2,
                          // polar advection coefficient, dt_crcl/dxlat/2
  const int* st_n;        // (2, Y) diffusion, advection sub-cycles of each
                          // row; -1: the row takes the vectorised form
  int Y, X, T, nsub, bt, bb, ktc, kbc;
  int M, n_years, nmon, corr_step, corr_shared, n_pack;
  int quirk;              // the src/greb.f90:881 jp2 quirk
  // kappa, kappa * dt_crcl, the meridional coefficients of diffusion
  // (kappa * dt_crcl / dyy^2) and advection (dt_crcl / dyy / 2)
  float st_kappa, st_kdt, st_ccy_d, st_ccy_a;
};

// Columns of the member pack (multiyear.pack_member_params) that hold each
// GrebParams field; p_emi is 10 consecutive columns.
struct PackCols {
  int sig, rho_air, ct_sens, da_ice, a_no_ice, a_cloud;
  int Tl_ice1, Tl_ice2, To_ice1, To_ice2;
  int co_turb, ce, cq_latent, cq_rain, r_qviwv, c_effmix;
  int p_emi, cap_ocean, cap_land, cap_air;
};

enum Kind { FLUX, SCEN, SCEN_YEARS };

// ---------------------------------------------------------------------------
// per-cell arithmetic, shared by every kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ float clamp_neg(float d, float x) {
  // positivity clamp of the polar sub-cycles (src/greb.f90:715, :907)
  return d <= -x ? -0.9f * x : d;
}

__device__ __forceinline__ float tree7(float c, float m3, float m2, float m1,
                                       float p1, float p2, float p3) {
  // the JAX package's balanced 7-term sum (fastcirc2._apply7_rolled)
  return ((c + m3) + (m2 + m1)) + ((p1 + p2) + p3);
}

__device__ __forceinline__ float pow4(float t) {
  const float t2 = t * t;
  return t2 * t2;
}

struct Tend {
  float sw, albedo, lw_surf, lwair, em, q_sens, q_lat, q_lat_air;
  float dq_eva, dq_rain, dt_ocean, dto;
};

// Pointwise tendencies of one cell (ops/pointwise.py; reference
// src/greb.f90:277-308, 367-525), with the legacy switches of LEGACY.
template <bool LEGACY>
__device__ Tend tendencies(const GrebParams& p, float ts, float ta, float to,
                           float q, float tclim, float qclim, float swet,
                           float u, float v, float mld, float mld_prev,
                           float cld, float swsol, float z_topo,
                           float glacier, float wz_air, float z_ocean) {
  Tend o;
  // shortwave (src/greb.f90:367-403)
  const float a_atmos = cld * p.a_cloud;
  const bool land = z_topo >= 0.f;
  const float t1 = land ? p.Tl_ice1 : p.To_ice1;
  const float t2 = land ? p.Tl_ice2 : p.To_ice2;
  const float a_ice = p.a_no_ice + p.da_ice;
  const float ramp = p.a_no_ice + p.da_ice * (1.f - (ts - t1) / (t2 - t1));
  float a_surf = ts <= t1 ? a_ice : (ts >= t2 ? p.a_no_ice : ramp);
  if (glacier > 0.5f) a_surf = a_ice;
  if (on<LEGACY>(p, FIXED_ALBEDO)) a_surf = p.a_no_ice;
  o.albedo = (a_surf + a_atmos) - a_surf * a_atmos;
  o.sw = swsol * (1.f - o.albedo);

  // longwave (src/greb.f90:407-434)
  const float* pe = p.p_emi;
  const float e_co2 = wz_air * p.co2;
  const bool lin = on<LEGACY>(p, LINEAR_VAPOR_LW);
  const float e_vapor = (wz_air * p.r_qviwv) * (lin ? qclim : q);
  const float a0 = pe[0] * e_co2;
  const float a1 = pe[1] * e_vapor;
  float em = pe[3] * logf((a0 + a1) + pe[2]) + pe[6];
  em = em + pe[4] * logf(a0 + pe[2]);
  em = em + pe[5] * logf(a1 + pe[2]);
  em = ((pe[7] - cld) / pe[8]) * (em - pe[9]) + pe[9];
  if (lin) em = em + (LINEAR_VAPOR_LW_C * p.r_qviwv) * (q - qclim);
  o.em = em;
  const float dtrad = -0.16f * tclim - 5.f;
  o.lw_surf = (-p.sig) * pow4(ts);
  o.lwair = ((-em) * p.sig) * pow4(ta + dtrad);

  // sensible heat (src/greb.f90:295)
  o.q_sens = p.ct_sens * (ta - ts);

  // hydrology (src/greb.f90:438-469)
  if (on<LEGACY>(p, HYDRO_OFF)) {
    o.q_lat = 0.f;
    o.dq_eva = 0.f;
    o.dq_rain = 0.f;
    o.q_lat_air = 0.f;
  } else {
    float wind = sqrtf(u * u + v * v);
    if (z_topo > 0.f) wind = sqrtf(wind * wind + 4.f);
    if (z_topo < 0.f) wind = sqrtf(wind * wind + 9.f);
    const float tc = ts - 273.15f;
    float qs = 3.75e-3f * expf((17.08085f * tc) / (tc + 234.175f));
    qs = qs * wz_air;
    o.q_lat = (((((q - qs) * wind) * p.cq_latent) * p.rho_air) * p.ce) * swet;
    o.dq_eva = ((-o.q_lat) / p.cq_latent) / p.r_qviwv;
    o.dq_rain = p.cq_rain * q;
    o.q_lat_air = ((-o.dq_rain) * p.cq_latent) * p.r_qviwv;
  }

  // deep ocean (src/greb.f90:495-525)
  if (on<LEGACY>(p, DEEP_OCEAN_OFF)) {
    o.dto = 0.f;
    o.dt_ocean = 0.f;
    return o;
  }
  const float dmld = mld - mld_prev;
  const bool ocean_warm = (z_topo < 0.f) && (ts >= p.To_ice2);
  const float below = z_ocean - mld;
  const float safe_below = below != 0.f ? below : 1.f;
  const float safe_mld = mld != 0.f ? mld : 1.f;
  float dto = (ocean_warm && dmld < 0.f) ? ((-dmld) / safe_below) * (ts - to) : 0.f;
  float dt_ocean = (ocean_warm && dmld > 0.f) ? (dmld / safe_mld) * (to - ts) : 0.f;
  dto = p.c_effmix * dto;
  dt_ocean = p.c_effmix * dt_ocean;
  const float tx = ts < p.To_ice2 ? p.To_ice2 : ts;   // max, NaN-propagating
  const float dtc = p.dt * p.co_turb;
  o.dto = dto + (dtc * (tx - to)) / (p.cap_ocean * safe_below);
  o.dt_ocean = dt_ocean + (dtc * (to - tx)) / (p.cap_ocean * safe_mld);
  return o;
}

// Sea-ice heat capacity (src/greb.f90:472-492; the legacy simple form,
// greb.original.model.f90:492-496, keeps the previous value at z_topo 0).
template <bool LEGACY>
__device__ __forceinline__ float seaice(const GrebParams& p, float ts0,
                                        float cap_prev, float mld,
                                        float z_topo, float glacier) {
  const float cap_open = p.cap_ocean * mld;
  if (on<LEGACY>(p, SIMPLE_SEAICE)) {
    float cap = z_topo > 0.f ? p.cap_land : cap_open;
    cap = z_topo == 0.f ? cap_prev : cap;
    return glacier > 0.5f ? p.cap_land : cap;
  }
  const float ramp = p.cap_land + ((cap_open - p.cap_land) / (p.To_ice2 - p.To_ice1))
                     * (ts0 - p.To_ice1);
  const float oc = ts0 <= p.To_ice1 ? p.cap_land : (ts0 >= p.To_ice2 ? cap_open : ramp);
  const float cap = z_topo < 0.f ? oc : cap_prev;
  return glacier > 0.5f ? p.cap_land : cap;
}

// One cell's state update at step t (core.scenario_step, src/greb.f90:
// 239-274; core.fluxcorr_step, :311-364).  s holds the cell's ts, ta, to,
// q, cap_surf and becomes its new state; ta_c, q_c are the circulated Ta
// and q.  A scenario step reads this step's corrections at tf[cp],
// tof[cp], qf[cp] and returns the 9 step outputs in vals; a spin-up step
// writes its corrections there.  Under SST_PLUS_ONE a scenario step first
// sets an ocean cell's ts to tclim + 1 (core.scenario_step).
template <int KIND, bool LEGACY>
__device__ __forceinline__ void update_cell(const YearArgs& a,
                                            const GrebParams& p, int t,
                                            int pix, float s[5], float ta_c,
                                            float q_c, float* tf_m,
                                            float* tof_m, float* qf_m,
                                            size_t cp, float vals[N_SUM]) {
  const size_t tp = (size_t)t * a.Y * a.X + pix;
  float ts = s[0];
  const float ta = s[1], to = s[2], q = s[3], cap = s[4];
  const float mld = a.mld[tp];
  const float z_topo = a.z_topo[pix], glacier = a.glacier[pix];
  if (KIND != FLUX && on<LEGACY>(p, SST_PLUS_ONE) && z_topo < 0.f)
    ts = a.tclim[tp] + 1.f;
  const Tend e = tendencies<LEGACY>(
      p, ts, ta, to, q, a.tclim[tp], LEGACY ? a.qclim[tp] : 0.f, a.swet[tp],
      a.u[tp], a.v[tp], mld, a.mld_prev[tp], a.cld[tp],
      a.sw_solar[(size_t)t * a.Y + pix / a.X], z_topo, glacier,
      a.wz_air[pix], a.z_ocean[pix]);
  const float dta_crcl = ta_c - ta;
  const float dq_crcl = q_c - q;
  const float dt = p.dt;
  const float air = ((e.lwair + e.lwair) - e.em * e.lw_surf + e.q_lat_air) - e.q_sens;
  float ts0, ta0, to0, q0;
  if (KIND != FLUX) {
    // scenario step (core.scenario_step; src/greb.f90:239-274)
    const float tf = tf_m[cp], tof = tof_m[cp], qf = qf_m[cp];
    ts0 = (ts + e.dt_ocean)
          + (dt * (((((e.sw + e.lw_surf) - e.lwair) + e.q_lat) + e.q_sens) + tf)) / cap;
    ta0 = (ta + dta_crcl) + (dt * air) / p.cap_air;
    to0 = (to + e.dto) + tof;
    float dq = ((dt * (e.dq_eva + e.dq_rain)) + dq_crcl) + qf;
    dq = dq <= -q ? -0.9f * q : dq;               // positivity (:265)
    q0 = q + dq;
    vals[0] = ts0; vals[1] = ta0; vals[2] = to0; vals[3] = q0;
    vals[4] = e.albedo; vals[5] = e.sw; vals[6] = e.lw_surf;
    vals[7] = e.q_lat; vals[8] = e.q_sens;
  } else {
    // flux-correction step (core.fluxcorr_step; src/greb.f90:311-364)
    const float dts = (dt * ((((e.sw + e.lw_surf) - e.lwair) + e.q_lat) + e.q_sens)) / cap;
    const float ts0_raw = (ts + dts) + e.dt_ocean;
    const float tf = ((a.tclim[tp] - ts0_raw) * cap) / dt;
    ts0 = ((ts + dts) + e.dt_ocean) + (tf * dt) / cap;
    ta0 = (ta + (dt * air) / p.cap_air) + dta_crcl;
    const float tof = a.toclim[pix] - (to + e.dto);
    to0 = (to + e.dto) + tof;
    const float dq = dt * (e.dq_eva + e.dq_rain);
    const float qf = a.qclim[tp] - ((q + dq) + dq_crcl);
    q0 = ((q + dq) + dq_crcl) + qf;
    tf_m[cp] = tf;
    tof_m[cp] = tof;
    qf_m[cp] = qf;
  }
  s[0] = ts0;
  s[1] = ta0;
  s[2] = to0;
  s[3] = q0;
  s[4] = seaice<LEGACY>(p, ts0, cap, mld, z_topo, glacier);
}

// This step's 12 coefficients of one (field, cell) (fastcirc2.step_coeffs;
// sign splits per src/greb.f90:203-216): the fold's zam (8) and mer (9)
// planes at stride zs, out at stride cs as za 0..6, mc 7..10, c0m 11.
__device__ __forceinline__ void step_coeffs(const float* zam, const float* mer,
                                            int zs, float u, float v,
                                            float* cf, int cs) {
  const float um = u > 0.f ? u : 0.f, up = u < 0.f ? u : 0.f;
  const float vm = v > 0.f ? v : 0.f, vp = v < 0.f ? v : 0.f;
  cf[0 * cs] = zam[0 * zs] * um;
  cf[1 * cs] = zam[1 * zs] * um;
  cf[2 * cs] = zam[2 * zs] * um;
  cf[3 * cs] = zam[3 * zs] * um + zam[4 * zs] * up;
  cf[4 * cs] = zam[5 * zs] * up;
  cf[5 * cs] = zam[6 * zs] * up;
  cf[6 * cs] = zam[7 * zs] * up;
  cf[7 * cs] = mer[3 * zs] * vm;
  cf[8 * cs] = mer[0 * zs] + mer[4 * zs] * vm;
  cf[9 * cs] = mer[1 * zs] + mer[5 * zs] * vp;
  cf[10 * cs] = mer[6 * zs] * vp;
  cf[11 * cs] = (mer[2 * zs] + mer[7 * zs] * vm) + mer[8 * zs] * vp;
}

// The stencil inputs of one (field, cell).
struct Taps {
  float x0, xm3, xm2, xm1, xp1, xp2, xp3;  // its row, columns j-3..j+3
  float km2, km1, kp1, kp2;                // rows r-2, r-1, r+1, r+2
};

// The 7 zonal taps of column j of a periodic row.
__device__ __forceinline__ void zonal_taps(const float* row, int j, int X,
                                           Taps& t) {
  t.x0 = row[j];
  t.xm3 = row[j >= 3 ? j - 3 : j - 3 + X];
  t.xm2 = row[j >= 2 ? j - 2 : j - 2 + X];
  t.xm1 = row[j >= 1 ? j - 1 : j - 1 + X];
  t.xp1 = row[j + 1 < X ? j + 1 : j + 1 - X];
  t.xp2 = row[j + 2 < X ? j + 2 : j + 2 - X];
  t.xp3 = row[j + 3 < X ? j + 3 : j + 3 - X];
}

// The substep's increments of one (field, cell) (fastcirc2.substep): zonal
// diffusion dd and zonal advection da, each clamped on the band rows, and
// the merged meridional step dy.  Coefficient plane s of the cell is
// zd[s * zs] (7 planes) and cf[s * cs] (12: za 0..6, mc 7..10, c0m 11).
__device__ __forceinline__ void increments(const float* zd, int zs,
                                           const float* cf, int cs,
                                           const Taps& t, bool band,
                                           float& dd, float& da, float& dy) {
  dd = tree7(zd[3 * zs] * t.x0, zd[0] * t.xm3, zd[zs] * t.xm2,
             zd[2 * zs] * t.xm1, zd[4 * zs] * t.xp1, zd[5 * zs] * t.xp2,
             zd[6 * zs] * t.xp3);
  if (band) dd = clamp_neg(dd, t.x0);
  da = tree7(cf[3 * cs] * t.x0, cf[0] * t.xm3, cf[cs] * t.xm2,
             cf[2 * cs] * t.xm1, cf[4 * cs] * t.xp1, cf[5 * cs] * t.xp2,
             cf[6 * cs] * t.xp3);
  if (band) da = clamp_neg(da, t.x0);
  dy = cf[11 * cs] * t.x0;
  dy = dy + cf[7 * cs] * t.km2;
  dy = dy + cf[8 * cs] * t.km1;
  dy = dy + cf[9 * cs] * t.kp1;
  dy = dy + cf[10 * cs] * t.kp2;
}

// The new value of a cell that no composite row covers.
__device__ __forceinline__ float combine(float x0, float wz, float dd,
                                         float da, float dy) {
  return ((x0 + wz * dd) + da) + dy;
}

// Partial sums of a composite row (fastcirc2._row_dot) for W adjacent
// columns: s[w] = t1row[i] * pc[i*X + w] over the COMP_BLOCK consecutive i
// from b, in sequence (zeros past X); the row sum adds the partials of
// b = 0, COMP_BLOCK, ... in sequence.  Both widths do the same operations
// on each column.  W = 1 (the member kernels, pc in global memory) keeps
// the load inside the guard, which lets the compiler start a partial's
// loads ahead; W = 4 (the cluster kernels, pc in shared memory, 16-byte
// aligned) loads four columns at once, a quarter of the shared-memory
// loads.
template <int W>
__device__ __forceinline__ void comp_partial(const float* t1row,
                                             const float* pc, int b, int X,
                                             float s[W]) {
  if constexpr (W == 1) {
    s[0] = t1row[b] * pc[(size_t)b * X];
    for (int i = b + 1; i < b + COMP_BLOCK; ++i)
      s[0] = s[0] + (i < X ? t1row[i] * pc[(size_t)i * X] : 0.f);
  } else {
    static_assert(W == 4, "one or four columns");
    float4 p = *reinterpret_cast<const float4*>(pc + (size_t)b * X);
    float t = t1row[b];
    s[0] = t * p.x; s[1] = t * p.y; s[2] = t * p.z; s[3] = t * p.w;
    for (int i = b + 1; i < b + COMP_BLOCK; ++i) {
      t = i < X ? t1row[i] : 0.f;
      if (i < X) p = *reinterpret_cast<const float4*>(pc + (size_t)i * X);
      s[0] = s[0] + (i < X ? t * p.x : 0.f);
      s[1] = s[1] + (i < X ? t * p.y : 0.f);
      s[2] = s[2] + (i < X ? t * p.z : 0.f);
      s[3] = s[3] + (i < X ? t * p.w : 0.f);
    }
  }
}

// The new value of a composite cell: the composite t2 clamped once
// against t1 (fastcirc2._extra_diffusion), then combined.
__device__ __forceinline__ float comp_combine(float t1, float t2, float x0,
                                              float wz, float da, float dy) {
  t1 = t1 + clamp_neg(t2 - t1, t1);
  return ((x0 + wz * (t1 - x0)) + da) + dy;
}

// ---------------------------------------------------------------------------
// scenario_years' one-block body: one block per member
// ---------------------------------------------------------------------------
static size_t smem_bytes(const YearArgs& a) {
  const size_t yx = (size_t)a.Y * a.X;
  const size_t kx = (size_t)(a.ktc + a.kbc) * a.X;
  return sizeof(float) * (5 * yx + 4 * yx + 6 * kx);
}

// One circulation substep of both transported fields of the whole grid,
// xa -> xb, in one block.
__device__ void substep(const YearArgs& a, const float* cf_m, const float* xa,
                        float* xb, float* s_t1, float* s_da, float* s_dy) {
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int ktc = a.ktc, kbc = a.kbc, K = ktc + kbc;
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    const int f = c / YX;
    const int pix = c - f * YX;
    const int r = pix / X;
    const int j = pix - r * X;
    const float* xf = xa + f * YX;
    Taps tp;
    zonal_taps(xf + r * X, j, X, tp);
    // zero halo beyond the poles
    tp.km2 = r >= 2 ? xf[(r - 2) * X + j] : 0.f;
    tp.km1 = r >= 1 ? xf[(r - 1) * X + j] : 0.f;
    tp.kp1 = r + 1 < Y ? xf[(r + 1) * X + j] : 0.f;
    tp.kp2 = r + 2 < Y ? xf[(r + 2) * X + j] : 0.f;
    float dd, da, dy;
    increments(a.zd + c, P, cf_m + c, P, tp, r < a.bt || r >= Y - a.bb,
               dd, da, dy);
    int k = -1;
    if (r < ktc) k = r;
    else if (r >= Y - kbc) k = ktc + (r - (Y - kbc));
    if (k >= 0) {
      // composite row: finished below, once the whole row's t1 is known
      const int o = (f * K + k) * X + j;
      s_t1[o] = tp.x0 + dd;
      s_da[o] = da;
      s_dy[o] = dy;
    } else {
      xb[c] = combine(tp.x0, a.wz[c], dd, da, dy);
    }
  }
  if (K == 0) return;
  __syncthreads();
  // dense pole composites: t2[j] = sum_i t1[i] * pcomp[f, k, i, j]
  for (int o = threadIdx.x; o < 2 * K * X; o += blockDim.x) {
    const int fk = o / X;
    const int j = o - fk * X;
    const int f = fk / K;
    const int k = fk - f * K;
    const int r = k < ktc ? k : Y - kbc + (k - ktc);
    const float* t1row = s_t1 + fk * X;
    const float* pc = a.pcomp + (size_t)fk * X * X + j;
    float t2, s;
    comp_partial<1>(t1row, pc, 0, X, &t2);
    for (int b = COMP_BLOCK; b < X; b += COMP_BLOCK) {
      comp_partial<1>(t1row, pc, b, X, &s);
      t2 = t2 + s;
    }
    const int c = f * YX + r * X + j;
    xb[c] = comp_combine(t1row[j], t2, xa[c], a.wz[c], s_da[o], s_dy[o]);
  }
}

// The physics of member m: the pack's row m, by field name; dt and CO2
// come from the host's p.
__device__ GrebParams member_params(GrebParams p, const YearArgs& a,
                                    const PackCols& c, int m) {
  const float* r = a.ppack + (size_t)m * a.n_pack;
  p.sig = r[c.sig];           p.rho_air = r[c.rho_air];
  p.ct_sens = r[c.ct_sens];   p.da_ice = r[c.da_ice];
  p.a_no_ice = r[c.a_no_ice]; p.a_cloud = r[c.a_cloud];
  p.Tl_ice1 = r[c.Tl_ice1];   p.Tl_ice2 = r[c.Tl_ice2];
  p.To_ice1 = r[c.To_ice1];   p.To_ice2 = r[c.To_ice2];
  p.co_turb = r[c.co_turb];   p.ce = r[c.ce];
  p.cq_latent = r[c.cq_latent]; p.cq_rain = r[c.cq_rain];
  p.r_qviwv = r[c.r_qviwv];   p.c_effmix = r[c.c_effmix];
  for (int k = 0; k < 10; ++k) p.p_emi[k] = r[c.p_emi + k];
  p.cap_ocean = r[c.cap_ocean];
  p.cap_land = r[c.cap_land];
  p.cap_air = r[c.cap_air];
  return p;
}

// The n_years scenario years of member m = blockIdx.x with monthly means
// (scenario_years at C = 1): a loop over n_years x T model steps in one
// block.  Under CIRCULATION_OFF a step skips the coefficients and the
// substeps and takes Ta and q from the state.
template <bool LEGACY>
__device__ void run_years(const YearArgs& a, GrebParams p) {
  extern __shared__ float smem[];
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int KX = (a.ktc + a.kbc) * X;
  float* s_state = smem;             // (5, Y, X)
  float* s_xa = s_state + 5 * YX;    // (2, Y, X) transported fields
  float* s_xb = s_xa + P;            // (2, Y, X) double buffer
  float* s_t1 = s_xb + P;            // (2, K, X) composite rows
  float* s_da = s_t1 + 2 * KX;
  float* s_dy = s_da + 2 * KX;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = blockIdx.x;
  // this member's slice of every buffer: field f of the state at f*MYX
  const size_t MYX = (size_t)a.M * YX;
  const float* state_in = a.state_in + (size_t)m * YX;
  float* state_out = a.state_out + (size_t)m * YX;
  float* cf = a.cf + (size_t)m * 12 * P;
  // member m's table at m * T * corr_step, a shared one (corr_shared) at
  // 0: the select stays outside the product, where it costs no spills (a
  // select of the member inside the product spills more)
  const size_t corr_m = a.corr_shared ? 0 : (size_t)m * a.T * a.corr_step;
  float* tf_m = a.tf + corr_m;
  float* tof_m = a.tof + corr_m;
  float* qf_m = a.qf + corr_m;

  for (int i = tid; i < 5 * YX; i += nt)
    s_state[i] = state_in[(i / YX) * MYX + i % YX];
  __syncthreads();
  const bool circ = !on<LEGACY>(p, CIRCULATION_OFF);

  for (int y = 0; y < a.n_years; ++y) {
    p.co2 = a.co2_years[y];
    const size_t my = (size_t)m * a.n_years + y;
    float* asum = a.asum + my * N_SUM * YX;
    float* mon_y = a.monthly + my * a.nmon * N_OUT * YX;
    for (int t = 0; t < a.T; ++t) {
      const size_t tyx = (size_t)t * YX;
      float* xa = s_xa;
      float* xb = s_xb;
      if (circ) {
        // -- step start: copy (Ta, q) and assemble this step's
        //    coefficients into the thread-private scratch
        for (int c = tid; c < P; c += nt) {
          const int f = c / YX;
          const int pix = c - f * YX;
          s_xa[c] = s_state[(f == 0 ? 1 : 3) * YX + pix];
          step_coeffs(a.zam + c, a.mer + c, P, a.u[tyx + pix],
                      a.v[tyx + pix], cf + c, P);
        }
        __syncthreads();

        // -- circulation: nsub substeps, ping-ponging the two buffers
        for (int s = 0; s < a.nsub; ++s) {
          substep(a, cf, xa, xb, s_t1, s_da, s_dy);
          __syncthreads();
          float* tmp = xa; xa = xb; xb = tmp;
        }
      }

      // this step's month slot, zeroed at the month's first step
      const int mo = a.mon[t];
      const bool mstart = t == 0 || a.mon[t - 1] != mo;
      const float w = a.mon_w[t];

      // -- pointwise physics and the state update of every cell
      for (int pix = tid; pix < YX; pix += nt) {
        float s[5];
        for (int k = 0; k < 5; ++k) s[k] = s_state[k * YX + pix];
        float vals[N_SUM];
        update_cell<SCEN_YEARS, LEGACY>(
            a, p, t, pix, s, circ ? xa[pix] : s[1], circ ? xa[YX + pix] : s[3],
            tf_m, tof_m, qf_m, (size_t)t * a.corr_step + pix, vals);
        // monthly means and annual sums in sequence, from 0 at the month's
        // / year's first step
        float* mp = mon_y + (size_t)mo * N_OUT * YX + pix;
        for (int k = 0; k < N_OUT; ++k)
          mp[k * YX] = (mstart ? 0.f : mp[k * YX]) + w * vals[k];
        for (int k = 0; k < N_SUM; ++k)
          asum[k * YX + pix] = (t == 0 ? 0.f : asum[k * YX + pix]) + vals[k];
        for (int k = 0; k < 5; ++k) s_state[k * YX + pix] = s[k];
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < 5 * YX; i += nt)
    state_out[(i / YX) * MYX + i % YX] = s_state[i];
}

// ---------------------------------------------------------------------------
// cluster kernels: each member's years on a cluster of C blocks
// ---------------------------------------------------------------------------
// Parts of a cluster block's shared memory, in layout order
// (ops/cuda/year_kernel.py CLUSTER_PARTS).
enum ClusterPart { P_STATE, P_XBUF, P_COEFFS, P_ZD, P_WZ, P_ASUM, P_MONTHLY,
                   P_PCOMP, P_COMP_ROWS, P_COMP_PARTS, P_WINDS, P_ROWC, P_SUB,
                   N_PARTS };

// Composite rows among the rows [r0, r1): the top ktc and bottom kbc rows.
__host__ __device__ inline int comp_rows_in(int r0, int r1, int Y, int ktc,
                                            int kbc) {
  const int top = (r1 < ktc ? r1 : ktc) - r0;
  const int bot = r1 - (r0 > Y - kbc ? r0 : Y - kbc);
  return (top > 0 ? top : 0) + (bot > 0 ? bot : 0);
}

// Bytes of each part of a cluster block's shared memory for a Y x X grid
// on C blocks for a kernel of `kind` (SCEN, SCEN_YEARS: with the annual
// sums; SCEN_YEARS: with the month's means), and their total; 0 where C
// does not split the rows into blocks of at least HALO rows, or X is not a
// multiple of 4 (the composite sums load 16 bytes at a time; every part is
// then a multiple of 16 bytes).  With the fold: its coefficient, zd and wz
// planes and the pole composites; `strict` (the strict instantiation): wz
// with HALO rows, the step's winds, the rows' constants and the polar
// sub-cycles' scratch instead.  The same reckoning as
// ops/cuda/year_kernel.py cluster_layout.
__host__ __device__ inline long long cluster_parts(int Y, int X, int ktc,
                                                   int kbc, int C, int kind,
                                                   bool strict,
                                                   long long* parts) {
  if (C < 1 || C > MAX_CLUSTER || Y % C != 0 || Y / C < HALO || X % 4 != 0)
    return 0;
  const long long R = Y / C, RX = R * X, f = sizeof(float);
  long long kmax = 0;
  for (int b = 0; b < C && !strict; ++b) {
    const int k = comp_rows_in(b * R, (b + 1) * R, Y, ktc, kbc);
    kmax = k > kmax ? k : kmax;
  }
  const long long nb = (X + COMP_BLOCK - 1) / COMP_BLOCK;
  parts[P_STATE] = f * 5 * RX;
  parts[P_XBUF] = f * 2 * 2 * (R + 2 * HALO) * X;
  parts[P_COEFFS] = strict ? 0 : f * 12 * 2 * RX;
  parts[P_ZD] = strict ? 0 : f * 7 * 2 * RX;
  parts[P_WZ] = strict ? f * 2 * (R + 2 * HALO) * X : f * 2 * RX;
  parts[P_ASUM] = kind != FLUX ? f * N_SUM * RX : 0;
  parts[P_MONTHLY] = kind == SCEN_YEARS ? f * N_OUT * RX : 0;
  parts[P_PCOMP] = f * 2 * kmax * X * X;
  parts[P_COMP_ROWS] = f * 3 * 2 * kmax * X;
  parts[P_COMP_PARTS] = f * 2 * kmax * nb * X;
  parts[P_WINDS] = strict ? f * 2 * RX : 0;
  parts[P_ROWC] = strict ? f * 8 * R : 0;
  parts[P_SUB] = strict ? f * 4 * 2 * RX : 0;
  long long total = 0;
  for (int k = 0; k < N_PARTS; ++k) total += parts[k];
  return total;
}

// Threads of a cluster block: one per (field, cell) of its rows, at most NT.
__host__ __device__ inline int cluster_threads(int R, int X) {
  const int n = (2 * R * X + 31) / 32 * 32;
  return n < NT ? n : NT;
}

// n / d as one multiply-high, m = ceil(2^32 / d): exact for 0 <= n with
// n * d <= 2^32, which the substep's indices keep (n < 2 * R * X cells or
// 2 * kmax * nb * X / 4 partial sums, far below 2^32 / d for a layout that
// fits 227 KB).  A runtime integer division costs a substep ~1 us here.
struct Div {
  unsigned m;
  __device__ explicit Div(int d) : m(d > 1 ? 0xffffffffu / (unsigned)d + 1u : 0u) {}
  __device__ __forceinline__ int operator()(int n) const {
    return m ? (int)__umulhi((unsigned)n, m) : n;
  }
};

// A block's two transported buffers, (2, R + 2*HALO, X) each with the
// block's rows at buffer rows HALO..HALO+R-1, and the same buffers of its
// neighbours (the same offsets in every block; null past the poles).
struct Bufs {
  float* mine;
  float* up;   // block rank-1: rows above
  float* dn;   // block rank+1: rows below
  int R, X;

  __device__ __forceinline__ int field() const { return (R + 2 * HALO) * X; }

  // v at field f, local row i, column j of the buffer at offset off: into
  // this block's buffer and into the halo slot of each neighbour that reads
  // that row.
  __device__ __forceinline__ void put(int off, int f, int i, int j,
                                      float v) const {
    const int o = off + f * field() + j;
    mine[o + (i + HALO) * X] = v;
    if (up != nullptr && i < HALO) up[o + (R + HALO + i) * X] = v;
    if (dn != nullptr && i >= R - HALO) dn[o + (i - R + HALO) * X] = v;
  }
};

// The member of this block: its cluster's index in the grid.
__device__ __forceinline__ int member_index() {
  return (int)(blockIdx.x / cg::this_cluster().num_blocks());
}

// ---------------------------------------------------------------------------
// the strict transport: the term-by-term stencils (ops/stencils.py)
// ---------------------------------------------------------------------------
// stencils._diff7 of one cell: t the field's taps, w those of its wz.
__device__ __forceinline__ float diff7(const Taps& t, const Taps& w,
                                       float cc) {
  float s = 10.f * (w.xm1 * (t.xm1 - t.x0) + w.xp1 * (t.xp1 - t.x0));
  s = s + 4.f * (w.xm2 * (t.xm2 - t.xm1) + w.xm1 * (t.x0 - t.xm1));
  s = s + 4.f * (w.xp1 * (t.x0 - t.xp1) + w.xp2 * (t.xp2 - t.xp1));
  s = s + 1.f * (w.xm3 * (t.xm3 - t.xm2) + w.xm2 * (t.xm1 - t.xm2));
  s = s + 1.f * (w.xp2 * (t.xp1 - t.xp2) + w.xp3 * (t.xp3 - t.xp2));
  return (cc * s) / 20.f;
}

// stencils._adv_upwind2: the 2-point upwind zonal advection.
__device__ __forceinline__ float upwind2(const Taps& t, const Taps& w,
                                         float um, float up, float cc) {
  const float a = w.xm1 * (t.x0 - t.xm1) + w.xm2 * (t.x0 - t.xm2);
  const float b = w.xp1 * (t.x0 - t.xp1) + w.xp2 * (t.x0 - t.xp2);
  return (cc * ((-um) * a + up * b)) / 3.f;
}

// stencils._adv_smooth3: the polar sub-cycle's 10/4/1 upwind; tp2, wp2
// are the j+2 taps with the jp2 quirk applied.
__device__ __forceinline__ float smooth3(const Taps& t, const Taps& w,
                                         float tp2, float wp2, float um,
                                         float up, float cc) {
  const float a = ((10.f * w.xm1) * (t.x0 - t.xm1)
                   + (4.f * w.xm2) * (t.xm1 - t.xm2))
                  + (1.f * w.xm3) * (t.xm2 - t.xm3);
  const float b = ((10.f * w.xp1) * (t.x0 - t.xp1)
                   + (4.f * wp2) * (t.xp1 - tp2))
                  + (1.f * w.xp3) * (tp2 - t.xp3);
  return (cc * ((-um) * a + up * b)) / 20.f;
}

// The strict transport's per-block constants and scratch in shared memory.
struct Strict {
  const float* wz;  // (2, R + 2*HALO, X) wz of Ta and q, zero past the poles
  const float* uv;  // (2, R, X) this step's u, v
  const float* ccx;   // (R,) kappa*dt_crcl/dxlat^2: 7-point diffusion
  const float* ccx2;  // (R,) kappa*dtdff2/dxlat^2: its polar sub-cycle
  const float* cax;   // (R,) dt_crcl/dxlat/2: 2-point upwind advection
  const float* cax2;  // (R,) polar advection coefficient
  const int* nd;      // (R,) diffusion sub-cycles; -1: vectorised form
  const int* na;      // (R,) advection sub-cycles; -1: vectorised form
  float* sub;   // (4, 2, R, X): the diffusion sub-cycle's two buffers,
                // then the advection sub-cycle's
  float ccy_d, ccy_a;
  int nf;       // fields that move: 2, or 1 (Ta) under VAPOR_CIRCULATION_OFF
  bool q_adv;   // q advects (not under VAPOR_DIFFUSION_ONLY)
  bool quirk;   // the jp2 quirk (src/greb.f90:881)
  bool has_sub;  // the block holds a sub-cycled row
  int nit;       // the largest sub-cycle count among the block's rows
};

// The new value of one (field, cell) after a strict substep
// (stencils.circulation's substep, additive form): x and w point at the
// cell's row of the field and of its wz, HALO rows each side (zero past
// the poles); td / ta at its row of the finished diffusion / advection
// sub-cycle where the row is sub-cycled, else null; mfull / pfull: the
// advection's v_m / v_p part is not divided by 3 (global rows 1, Y-2).
__device__ __forceinline__ float strict_value(
    const float* x, const float* w, int j, int X, float cc_d, float cc_a,
    float ccy_d, float ccy_a, bool adv, float u, float v, bool mfull,
    bool pfull, const float* td, const float* ta) {
  Taps t, tw;
  zonal_taps(x, j, X, t);
  zonal_taps(w, j, X, tw);
  const float km1 = x[j - X], kp1 = x[j + X];
  const float wm1 = w[j - X], wp1 = w[j + X];
  // diffusion: wz * (dTx + dTy)
  const float dty = ccy_d * (wm1 * (km1 - t.x0) + wp1 * (kp1 - t.x0));
  const float dtx = td != nullptr ? td[j] - t.x0 : diff7(t, tw, cc_d);
  const float dxd = tw.x0 * (dtx + dty);
  if (!adv) return t.x0 + dxd;
  // advection: dTx + dTy, meridional upwind over 2 rows each side
  const float um = u > 0.f ? u : 0.f, up = u < 0.f ? u : 0.f;
  const float vm = v > 0.f ? v : 0.f, vp = v < 0.f ? v : 0.f;
  const float km2 = x[j - 2 * X], kp2 = x[j + 2 * X];
  const float s_m = vm * (wm1 * (t.x0 - km1) + w[j - 2 * X] * (t.x0 - km2));
  const float s_p = vp * (wp1 * (t.x0 - kp1) + w[j + 2 * X] * (t.x0 - kp2));
  const float dya = ccy_a * ((-(mfull ? s_m : s_m / 3.f))
                             + (pfull ? s_p : s_p / 3.f));
  const float dxa = ta != nullptr ? ta[j] - t.x0 : upwind2(t, tw, um, up, cc_a);
  return (t.x0 + dxd) + (dxa + dya);
}

// One strict substep of this block's rows, buffer xa (the block's rows at
// buffer row HALO) -> buffer nxt: the (field, cell)s of rows without a
// polar sub-cycle at once; then, where the block holds sub-cycled rows
// (block-uniform), st.nit iterations of both sub-cycles over the scratch,
// each from the substep's state, a row adding 0 past its own count, with
// a __syncthreads() between iterations; then those rows' cells.
__device__ void strict_substep(const Strict& st, const Bufs& bufs,
                               const float* xa, int nxt, int r0, int Y) {
  const int R = bufs.R, X = bufs.X, RX = R * X, P = 2 * RX;
  const int BX = bufs.field(), WX = (R + 2 * HALO) * X;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    const bool adv = f == 0 || st.q_adv;
    const bool sd = st.nd[i] >= 0, sa = adv && st.na[i] >= 0;
    const float* x = xa + f * BX + (i + HALO) * X;
    if (sd) st.sub[l] = x[j];
    if (sa) st.sub[2 * P + l] = x[j];
    if (sd || sa) continue;
    const int r = r0 + i;
    bufs.put(nxt, f, i, j,
             strict_value(x, st.wz + f * WX + (i + HALO) * X, j, X,
                          st.ccx[i], st.cax[i], st.ccy_d, st.ccy_a, adv,
                          st.uv[li], st.uv[RX + li], r == 1, r == Y - 2,
                          nullptr, nullptr));
  }
  if (!st.has_sub) return;
  for (int it = 0; it < st.nit; ++it) {
    __syncthreads();
    const int rd = it & 1;   // read buffer; the other is written
    for (int l = tid; l < st.nf * RX; l += nt) {
      const int f = by_rx(l), li = l - f * RX;
      const int i = by_x(li), j = li - i * X;
      const bool adv = f == 0 || st.q_adv;
      if (st.nd[i] < 0 && !(adv && st.na[i] >= 0)) continue;
      const int row = f * RX + i * X;
      Taps w;
      zonal_taps(st.wz + f * WX + (i + HALO) * X, j, X, w);
      if (st.nd[i] >= 0) {
        Taps t;
        zonal_taps(st.sub + rd * P + row, j, X, t);
        const float d = clamp_neg(diff7(t, w, st.ccx2[i]), t.x0);
        st.sub[(1 - rd) * P + l] = t.x0 + d * (it < st.nd[i] ? 1.f : 0.f);
      }
      if (adv && st.na[i] >= 0) {
        Taps t;
        zonal_taps(st.sub + (2 + rd) * P + row, j, X, t);
        const bool q = st.quirk && j == X - 3;
        const float u = st.uv[li];
        const float um = u > 0.f ? u : 0.f, up = u < 0.f ? u : 0.f;
        const float d = clamp_neg(
            smooth3(t, w, q ? t.xp1 : t.xp2, q ? w.xp1 : w.xp2, um, up,
                    st.cax2[i]), t.x0);
        st.sub[(3 - rd) * P + l] = t.x0 + d * (it < st.na[i] ? 1.f : 0.f);
      }
    }
  }
  __syncthreads();
  const int fin = st.nit & 1;   // the buffer the last iteration wrote
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    const bool adv = f == 0 || st.q_adv;
    const bool sd = st.nd[i] >= 0, sa = adv && st.na[i] >= 0;
    if (!sd && !sa) continue;
    const int r = r0 + i, row = f * RX + i * X;
    bufs.put(nxt, f, i, j,
             strict_value(xa + f * BX + (i + HALO) * X,
                          st.wz + f * WX + (i + HALO) * X, j, X, st.ccx[i],
                          st.cax[i], st.ccy_d, st.ccy_a, adv, st.uv[li],
                          st.uv[RX + li], r == 1, r == Y - 2,
                          sd ? st.sub + fin * P + row : nullptr,
                          sa ? st.sub + (2 + fin) * P + row : nullptr));
  }
}

// The years of member m = member_index(), this block's rows: FLUX a
// spin-up year (fluxcorr_year, fluxcorr_years), SCEN a scenario year with
// per-step outputs and annual sums (scenario_year, one member),
// SCEN_YEARS n_years scenario years with monthly means and annual sums
// (scenario_years).  The state stays in shared memory from one year to
// the next; the annual sums restart from 0 at each year's first step and
// go out at its last, the month's means restart at each month's first step
// and go out at its last.  STRICT = false moves Ta and q with the fold
// (LEGACY: with the switches of the flags word); STRICT = true (with
// LEGACY) is the strict instantiation: no fold in its shared memory, Ta and
// q moved by the strict stencils (strict_substep; q per the vapour bits),
// or under CIRCULATION_OFF not at all: a step then skips the substeps and
// their barriers and takes Ta and q from the state.
template <int KIND, bool LEGACY, bool STRICT>
__device__ void run_cluster(const YearArgs& a, GrebParams p) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = member_index();
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int R = Y / C, RX = R * X, r0 = rank * R;
  const int ktc = a.ktc, kbc = a.kbc, K = ktc + kbc;
  long long parts[N_PARTS];
  cluster_parts(Y, X, ktc, kbc, C, KIND, STRICT, parts);
  const int nb = (X + COMP_BLOCK - 1) / COMP_BLOCK;
  const int kmax = (int)(parts[P_PCOMP] / (sizeof(float) * 2 * X * X));
  float* sp[N_PARTS];
  sp[0] = smem;
  for (int k = 1; k < N_PARTS; ++k)
    sp[k] = sp[k - 1] + parts[k - 1] / sizeof(float);
  float* s_state = sp[P_STATE];   // (5, R, X)
  float* s_cf = sp[P_COEFFS];     // (12, 2, R, X)
  float* s_zd = sp[P_ZD];         // (7, 2, R, X)
  float* s_wz = sp[P_WZ];         // (2, R, X); STRICT (2, R + 2*HALO, X)
  float* s_asum = sp[P_ASUM];     // (9, R, X), SCEN and SCEN_YEARS
  float* s_mon = sp[P_MONTHLY];   // (5, R, X), SCEN_YEARS: the month's means
  float* s_pc = sp[P_PCOMP];      // (2, kmax, X, X): slot q of field f
  float* s_t1 = sp[P_COMP_ROWS];  // (2, kmax, X) each: t1, da, dy
  float* s_da = s_t1 + 2 * kmax * X;
  float* s_dy = s_da + 2 * kmax * X;
  float* s_part = sp[P_COMP_PARTS];  // (2, kmax, nb, X) partial row sums
  Bufs bufs{sp[P_XBUF], nullptr, nullptr, R, X};
  const int BX = bufs.field();
  const int NXT = 2 * BX;  // offset of the second buffer
  // this block's composite rows: local rows [0, ntop) at the top pole and
  // [bot0, R) at the bottom pole, slots q = 0, 1, ... in row order
  const int ntop = comp_rows_in(r0, r0 + R, Y, ktc, 0);
  const int kb = comp_rows_in(r0, r0 + R, Y, ktc, kbc);
  const int bot0 = R - (kb - ntop);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int X4 = X / 4;   // the partial sums run 4 columns a thread
  const Div by_rx(RX), by_x(X), by_x4(X4), by_nbx4(nb * X4), by_kb(kb);
  // this member's slice of every buffer it reads or writes, from this
  // block's first row: field f of the state at f * M * YX, step t of its
  // corrections at corr_m + t * corr_step: member m's table starts at
  // m * T * corr_step, a shared table (corr_shared, K3 only) at 0.  Tested
  // for K3 alone, so the other kinds keep the plain product (a test in
  // every kind spills more in K2)
  const size_t MYX = (size_t)a.M * YX;
  const size_t row0 = (size_t)m * YX + r0 * X;
  const size_t corr_m =
      (size_t)(KIND == SCEN_YEARS && a.corr_shared ? 0 : m) * a.T *
      a.corr_step;
  float* tf_m = a.tf + corr_m;
  float* tof_m = a.tof + corr_m;
  float* qf_m = a.qf + corr_m;

  for (int i = tid; i < 5 * RX; i += nt)
    s_state[i] = a.state_in[row0 + (size_t)(i / RX) * MYX + i % RX];
  // Ta and q move: always with the fold, in the strict instantiation
  // unless CIRCULATION_OFF (whose launch has no stencil constants)
  const bool circ = !STRICT || !on<LEGACY>(p, CIRCULATION_OFF);
  Strict st;
  if (STRICT && circ) {
    // wz of Ta and q with HALO rows each side, zero past the poles (as
    // stencils.extend_lat_zero), and the rows' constants (stencils.py)
    const int WX = (R + 2 * HALO) * X;
    for (int i = tid; i < 2 * WX; i += nt) {
      const int f = i / WX, h = i - f * WX, r = r0 - HALO + h / X;
      s_wz[i] = r >= 0 && r < Y ? a.st_wz[(size_t)f * YX + r * X + h % X]
                                : 0.f;
    }
    float* rc = sp[P_ROWC];
    int* rn = reinterpret_cast<int*>(rc + 4 * R);
    for (int i = tid; i < R; i += nt) {
      const float* rows = a.st_rows + r0 + i;   // (4, Y), this row
      rc[i] = a.st_kdt / rows[0];
      rc[R + i] = (a.st_kappa * rows[Y]) / rows[0];
      rc[2 * R + i] = rows[3 * Y];
      rc[3 * R + i] = rows[2 * Y];
      rn[i] = a.st_n[r0 + i];
      rn[R + i] = a.st_n[Y + r0 + i];
    }
    __syncthreads();
    st.wz = s_wz;
    st.uv = sp[P_WINDS];
    st.ccx = rc;
    st.ccx2 = rc + R;
    st.cax = rc + 2 * R;
    st.cax2 = rc + 3 * R;
    st.nd = rn;
    st.na = rn + R;
    st.sub = sp[P_SUB];
    st.ccy_d = a.st_ccy_d;
    st.ccy_a = a.st_ccy_a;
    st.nf = on<LEGACY>(p, VAPOR_CIRCULATION_OFF) ? 1 : 2;
    st.q_adv = !on<LEGACY>(p, VAPOR_DIFFUSION_ONLY);
    st.quirk = a.quirk != 0;
    st.has_sub = false;
    st.nit = 0;
    for (int i = 0; i < R; ++i) {
      const int n = rn[i] > rn[R + i] ? rn[i] : rn[R + i];
      st.has_sub = st.has_sub || n >= 0;
      st.nit = n > st.nit ? n : st.nit;
    }
  }
  if (!STRICT) {
    for (int i = tid; i < 7 * 2 * RX; i += nt)
      s_zd[i] = a.zd[(size_t)(i / RX) * YX + r0 * X + i % RX];
    for (int i = tid; i < 2 * RX; i += nt)
      s_wz[i] = a.wz[(size_t)(i / RX) * YX + r0 * X + i % RX];
  }
  // halo rows start at zero: those past the poles stay so
  for (int i = tid; i < 2 * 2 * 2 * HALO * X; i += nt) {
    const int fb = i / (2 * HALO * X);          // buffer*2 + field
    const int h = i - fb * 2 * HALO * X;
    const int row = h < HALO * X ? h / X : R + h / X;
    bufs.mine[fb * BX + row * X + h % X] = 0.f;
  }
  for (int i = tid; i < 2 * kb * X * X && !STRICT; i += nt) {
    const int fq = i / (X * X);
    const int f = fq / kb, q = fq - f * kb;
    const int r = q < ntop ? r0 + q : r0 + bot0 + (q - ntop);
    const int k = r < ktc ? r : ktc + (r - (Y - kbc));
    s_pc[(size_t)(f * kmax + q) * X * X + i % (X * X)] =
        a.pcomp[(size_t)(f * K + k) * X * X + i % (X * X)];
  }
  // every block's shared memory is live before any remote write
  cluster.sync();
  if (rank > 0) bufs.up = cluster.map_shared_rank(bufs.mine, rank - 1);
  if (rank < C - 1) bufs.dn = cluster.map_shared_rank(bufs.mine, rank + 1);

  // step t of year y; each year's CO2 from the table (SCEN_YEARS)
  const int n_years = KIND == SCEN_YEARS ? a.n_years : 1;
  const int nf = STRICT && circ ? st.nf : 2;   // the fields that move
  for (int yt = 0; yt < n_years * a.T; ++yt) {
    const int y = yt / a.T, t = yt - y * a.T;
    if (KIND == SCEN_YEARS && t == 0) p.co2 = a.co2_years[y];
    const size_t tyx = (size_t)t * YX;
    int cur = 0;
    if (STRICT && circ) {
      // -- step start: the moving fields into buffer 0, pushed to the
      //    neighbours' halos, and this step's winds into shared memory
      for (int l = tid; l < nf * RX; l += nt) {
        const int f = by_rx(l), li = l - f * RX;
        const int i = by_x(li), j = li - i * X;
        bufs.put(0, f, i, j, s_state[(f == 0 ? 1 : 3) * RX + li]);
      }
      float* uv = sp[P_WINDS];
      for (int li = tid; li < RX; li += nt) {
        uv[li] = a.u[tyx + r0 * X + li];
        uv[RX + li] = a.v[tyx + r0 * X + li];
      }
      cluster.sync();
      // -- circulation: nsub strict substeps, buffer cur -> nxt
      for (int s = 0; s < a.nsub; ++s) {
        const int nxt = NXT - cur;
        strict_substep(st, bufs, bufs.mine + cur, nxt, r0, Y);
        // every block's rows and halos of buffer nxt are written, and no
        // block reads buffer cur any more
        cluster.sync();
        cur = nxt;
      }
    }
    if (!STRICT) {
      // -- step start: (Ta, q) into buffer 0, pushed to the neighbours'
      //    halos, and this step's coefficients into shared memory
      for (int l = tid; l < 2 * RX; l += nt) {
        const int f = by_rx(l), li = l - f * RX;
        const int i = by_x(li), j = li - i * X;
        const int c = f * YX + r0 * X + li;
        bufs.put(0, f, i, j, s_state[(f == 0 ? 1 : 3) * RX + li]);
        step_coeffs(a.zam + c, a.mer + c, P, a.u[tyx + r0 * X + li],
                    a.v[tyx + r0 * X + li], s_cf + l, 2 * RX);
      }
      cluster.sync();

      // -- circulation: nsub substeps, buffer cur -> nxt
      for (int s = 0; s < a.nsub; ++s) {
        const float* xa = bufs.mine + cur;
        const int nxt = NXT - cur;
        for (int l = tid; l < 2 * RX; l += nt) {
          const int f = by_rx(l), li = l - f * RX;
          const int i = by_x(li), j = li - i * X;
          const int r = r0 + i;
          const float* row = xa + f * BX + (i + HALO) * X;
          Taps tp;
          zonal_taps(row, j, X, tp);
          tp.km2 = row[j - 2 * X];
          tp.km1 = row[j - X];
          tp.kp1 = row[j + X];
          tp.kp2 = row[j + 2 * X];
          float dd, da, dy;
          increments(s_zd + l, 2 * RX, s_cf + l, 2 * RX, tp,
                     r < a.bt || r >= Y - a.bb, dd, da, dy);
          const int q = i < ntop ? i : (i >= bot0 ? ntop + (i - bot0) : -1);
          if (q >= 0) {
            // composite row: finished below, once the whole row's t1 is known
            const int o = (f * kmax + q) * X + j;
            s_t1[o] = tp.x0 + dd;
            s_da[o] = da;
            s_dy[o] = dy;
          } else {
            bufs.put(nxt, f, i, j, combine(tp.x0, s_wz[l], dd, da, dy));
          }
        }
        if (kb) {   // block-uniform: only the blocks that hold a pole row
          __syncthreads();
          // dense pole composites t2[j] = sum_i t1[i] * pcomp[f, k, i, j]:
          // the partial sums of COMP_BLOCK terms, 4 columns a thread, then
          // their sum in order
          for (int o = tid; o < 2 * kb * nb * X4; o += nt) {
            const int fq = by_nbx4(o), rest = o - fq * nb * X4;
            const int b = by_x4(rest), j = 4 * (rest - b * X4);
            const int f = by_kb(fq);
            const int sl = f * kmax + (fq - f * kb);
            float ps[4];
            comp_partial<4>(s_t1 + sl * X, s_pc + (size_t)sl * X * X + j,
                            b * COMP_BLOCK, X, ps);
            *reinterpret_cast<float4*>(s_part + (sl * nb + b) * X + j) =
                make_float4(ps[0], ps[1], ps[2], ps[3]);
          }
          __syncthreads();
          for (int o = tid; o < 2 * kb * X; o += nt) {
            const int fq = by_x(o), j = o - fq * X;
            const int f = by_kb(fq), q = fq - f * kb;
            const int sl = f * kmax + q;
            const float* part = s_part + sl * nb * X + j;
            float t2 = part[0];
            for (int b = 1; b < nb; ++b) t2 = t2 + part[b * X];
            const int i = q < ntop ? q : bot0 + (q - ntop);
            const int so = sl * X + j;
            bufs.put(nxt, f, i, j,
                     comp_combine(s_t1[so], t2, xa[f * BX + (i + HALO) * X + j],
                                  s_wz[f * RX + i * X + j], s_da[so], s_dy[so]));
          }
        }
        // every block's rows and halos of buffer nxt are written, and no
        // block reads buffer cur any more
        cluster.sync();
        cur = nxt;
      }
    }

    // this year's annual sums (m, y) and, SCEN_YEARS, this step's month:
    // its slot is set at the month's first step and goes out at its last
    const bool last = t == a.T - 1;
    const size_t my = (size_t)m * n_years + y;
    float* asum = KIND == FLUX ? nullptr : a.asum + my * N_SUM * YX + r0 * X;
    float* mon = nullptr;
    bool mstart = false, mend = false;
    float w = 0.f;
    if (KIND == SCEN_YEARS) {
      const int mo = a.mon[t];
      mstart = t == 0 || a.mon[t - 1] != mo;
      mend = last || a.mon[t + 1] != mo;
      w = a.mon_w[t];
      mon = a.monthly + (my * a.nmon + mo) * N_OUT * YX + r0 * X;
    }

    // -- pointwise physics and the state update of this block's cells
    const float* xc = bufs.mine + cur + HALO * X;   // circulated, row 0
    for (int li = tid; li < RX; li += nt) {
      const int pix = r0 * X + li;
      float s[5];
      for (int k = 0; k < 5; ++k) s[k] = s_state[k * RX + li];
      float vals[N_SUM];
      update_cell<KIND, LEGACY>(a, p, t, pix, s, circ ? xc[li] : s[1],
                                circ && nf == 2 ? xc[BX + li] : s[3], tf_m,
                                tof_m, qf_m, (size_t)t * a.corr_step + pix,
                                vals);
      if (KIND == SCEN) {   // one member
        float* out = a.outs + (size_t)t * N_OUT * YX + pix;
        for (int k = 0; k < N_OUT; ++k) out[k * YX] = vals[k];
      }
      if (KIND != FLUX) {
        // annual sums in sequence, from 0 at the year's first step
        for (int k = 0; k < N_SUM; ++k) {
          const float v = (t == 0 ? 0.f : s_asum[k * RX + li]) + vals[k];
          s_asum[k * RX + li] = v;
          if (last) asum[k * YX + li] = v;
        }
      }
      if (KIND == SCEN_YEARS) {
        // monthly means: w * fields in sequence, from 0 at the month's
        // first step
        for (int k = 0; k < N_OUT; ++k) {
          const float v = (mstart ? 0.f : s_mon[k * RX + li]) + w * vals[k];
          s_mon[k * RX + li] = v;
          if (mend) mon[k * YX + li] = v;
        }
      }
      for (int k = 0; k < 5; ++k) s_state[k * RX + li] = s[k];
    }
    __syncthreads();
  }
  for (int i = tid; i < 5 * RX; i += nt)
    a.state_out[row0 + (size_t)(i / RX) * MYX + i % RX] = s_state[i];
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// the refined instantiation: the four kernels at an extension-mode grid
// ---------------------------------------------------------------------------
// At 384x192 (dt_crcl 1800 s: 24 substeps a step) the fold runs with
// sequential zonal splitting (zonal advection reads the zonally diffused
// state xa = x + wz*dd), explicit polar segment iterations of both zonal
// sub-cycles, and packed SVD pole composites: for composite row (f, k) of
// rank r, t2 = (t1 U_all[:, off:off+r]) W_all[off:off+r, :]
// (fastcirc2.substep, _extra_diffusion, _extra_advection, _packed_comp).
// A block of a 16-block cluster owns 12 rows of 384 columns, 4.5x the
// cells of a 96x48 block, and the cluster body's planes no longer fit its
// shared memory.  This instantiation keeps there only what a substep reads
// from its neighbours' cells: the (Ta, q) double buffer with +-2 halo rows
// (pushed as in run_cluster), wz, xa (first dd) and a scratch that the
// diffusion segments, the composite rows and the advection segments use in
// turn (refined_parts).  What a cell reads once a substep stays in global
// memory and L2: the zd planes, this step's 12 coefficient planes (written
// at each step start into a per-run scratch, a.cf, as run_years does), the
// packed factors (U_all and W_all, 4.8 MB each at 384x192), the 5-field
// state (a.state_out, read and written once a step) and the annual sums
// (read-modified-written each step): ~30 MB in all, within the 50 MB L2.
// Every phase of a substep is row-local (the segments, the composites and
// the sequential splitting are zonal), so a substep still ends at one
// cluster.sync(); the blocks that hold segment or composite rows run them
// block-uniformly, a __syncthreads() between phases and iterations, as
// strict_substep does (at 384x192 the diffusion segments reach rows 7-20
// and 171-184, in blocks 0, 1, 14 and 15; the composites rows 0-6 and
// 185-191, in blocks 0 and 15).  A composite row works on its own columns
// [off, off + r) of Rtot alone: the plain version's masked product holds
// exact zeros elsewhere, and its blocked sums of COMP_BLOCK terms (aligned
// to 0 in Rtot) do not change by adding them, so the kernel sums the same
// blocks over the row's columns only, ~1/28 of the plain version's
// products.  What bounds it: the two pole blocks' composite rows, one SM
// each (block 0 reads ~6.5 MB of factors a substep at 384x192, block 15
// ~3.2 MB), which every block waits for at the cluster barrier.  On an
// H100 (700 W, chip_smoke.py's probes) a substep takes ~132 us: ~75 us of
// it the composite rows, ~25 us the segments; the composite loops take
// whole blocks of terms without guards and load t1 16 bytes at a time,
// since their first form was bound by its instruction count.  Spreading
// the composite rows over the cluster is a later redesign (ROADMAP Queue
// 2, redesign e).
//
// The additive form (R_ADDITIVE, suffix _additive: 192x96 at dt_crcl 1800 s,
// 24 substeps a step) runs the fold of a grid inside the reference's
// envelope whose pole composites the cluster body cannot hold: additive
// zonal splitting (the advection reads x, as at 96x48), explicit polar
// advection segments ((2, 2, 1), (1, 1, 3): rows 0-1 and 94-95) and dense
// composites, t2 = t1 pcomp[f, k] over 192x192 matrices at five rows a pole
// (one row's two matrices alone are 294,912 B, over a block's 232,448)
// (fastcirc2.substep without seq_zonal, _extra_advection, the dense
// composite rows of _extra_diffusion).  A block of a 16-block cluster owns
// 6 rows of 192 columns; its shared memory is refined_parts' (64,560 B at
// 192x96: dd takes xa's place, the composites' t1 and the advection
// segments use the scratch in turn).  A substep (additive_substep) computes
// dd, da and dy of every cell from the same taps as the cluster body
// (increments) and writes the cells of rows in no segment and no composite
// at once; blocks 0 and 15, which hold all five composite rows and every
// advection segment row, then run the segments (seg_iterate, from x) and
// the composites (dense_comp: one column a thread, its 192 terms read from
// L2 in _row_dot's blocked order, summed as the plain version sums them)
// and write those rows last.  What bounds it: the two pole blocks' dense
// composites, each reading 2 x 5 x 192 x 192 x 4 B = 1.47 MB of matrices
// from L2 a substep on one SM (2.9 MB for both poles, resident in the 50
// MB L2), which every block waits for at the cluster barrier.  On an H100
// (700 W, chip_smoke.py) a 192x96 K2 year takes ~392 ms, ~22 us a
// substep, ~230x the year's bound (1.675 ms by operations).  Spreading
// the composite columns over the cluster's 16 blocks is a later redesign
// (ROADMAP Queue 2, redesign g).
//
// The legacy switchboard in both forms (LEGACY, suffix _legacy: the words
// of log_exp 5, 6, 9, 11, 13-15, which keep the fold): the fold moves Ta
// and q as in the modern variant, and the state update branches on the
// flags word (update_cell<KIND, true>); the substeps do not change.
//
// The strict transport at an extension-mode grid (R_STRICT, suffix
// _strict_refined, with the switches: --strict-circulation, log_exp 7, 8,
// 16, and the no-transport words of log_exp 0-4, which at 384x192 have no
// fold either): stencils.circulation's substep with sequential zonal
// splitting (seq_zonal), in the plain version's float32 order.  Every row
// of such a grid takes both polar sub-cycles (at 384x192 diffusion 1652,
// 184, 67, 34, ... iterations from each pole, 1 at the equator; advection
// 1 to 27 at the pole rows, by the forcing's row winds), and the zonal
// advection and its sub-cycle start from
// the zonally diffused state xz = x + wz*dtx, while both meridional terms
// read x: so a substep (strict_seq_substep) runs the diffusion sub-cycle to
// each row's count, forms xz, runs the advection sub-cycle from xz, then
// writes xz + wz*dty + (dtx_a + dty_a).  The block's shared memory
// (strict_refined_parts, 221,472 B at 384x192) keeps what a substep reads
// many times: the (Ta, q) double buffer with +-2 halo rows (98,304 B), wz
// of both fields with +-2 halo rows (49,152 B), one scratch of two (2, R,
// X) buffers (73,728 B) that the two sub-cycles use in turn, and the rows'
// constants; xz waits in the next buffer's own rows, which the block alone
// writes and which take each cell's new value in place, the cell read
// first (a third (2, R, X) buffer would have made it 258,048 B, over the
// 232,448 B a block has).  The state, the annual sums, K3's monthly means
// and the step's winds stay in global memory and L2, as in the fold's
// forms.  A sub-cycle round takes the rows still within their counts
// (sub_cycle: the block's rows in order of count), so the pole blocks'
// deep rounds touch the pole row alone; a row past its count keeps its
// value, which the plain version's masked add of a finite increment
// leaves unchanged.  The pole blocks' rows hold the deepest counts (1652,
// 184, 67, ... a substep from each pole; every other row at most 3): their
// diffusion sub-cycle runs spread over half the cluster each
// (spread_cycle: each block 48 of the 384 columns of every pole row, an
// exchange of 3k edge columns with its two neighbours every k rounds,
// one thread a cell with a named barrier between rounds), after every
// block's own rows' sub-cycle, between two cluster barriers.  What
// bounds it: the pole rows' 1652 dependent rounds a substep, each now a
// 7-point stencil and a barrier of 3 warps, and an exchange every k
// rounds (ROADMAP Queue 2, redesign d).
//
// The member kernels (K4 fluxcorr_years_refined, K3 scenario_years_refined,
// and their other forms and variants) run the same body with MEMBERS:
// cluster
// m = member_index() runs member m
// with its own params (member_params, kept in 128 B of static shared
// memory: held in registers across the year they spilled into the
// substeps, and a member's year took ~13% longer than K1's on an H100)
// and its own slice of every buffer:
// field k of its state at (k*M + m)*Y*X, its coefficient scratch at
// m*12*2*Y*X, its correction tables at m*T*corr_step (K3's one shared
// table, corr_shared, at 0), and K3's annual sums of year y at (m, y) and
// monthly means at (m, y*nmon + mon[t]), read-modified-written in global
// memory each step as K2's annual sums are (the month's five planes of 12
// rows would need 92 KB more shared memory than the block has left).  K3
// loops over its n_years years inside the kernel, each year's CO2 from
// co2_years.  Members beyond the card's capacity of 16-block clusters run
// in waves.
//
// The additive packed form (R_ADDITIVE_PACKED, suffixes _additive_packed
// and _additive_packed_legacy, built in band_kernel.cu: 224x112 to 352x176
// at dt_crcl 1800 s) runs the fold of a grid inside the reference's
// envelope whose composites are packed: additive splitting, diffusion and
// advection segments and the packed composite rows (3 to 6 a pole).  It is
// the additive form with packed_comp, the sequential form's composite rows
// on their own rank columns in the same blocked order, where dense_comp
// is (additive_substep<MEMBERS, true>; its block is refined_parts',
// 102,432 B at 256x128).  What bounds it is what bounds the other forms:
// blocks 0-1 and 14-15 hold the composite rows and segments, the other
// twelve wait at the barrier; on an H100 80GB HBM3 at 700 W
// (chip_smoke.py) a 256x128 K2 year takes ~806 ms, ~46 us a substep.
//
// The strict additive form (R_STRICT_ADDITIVE, suffix _strict_additive,
// built in band_kernel.cu) runs the strict transport (and no transport)
// where the cluster body's strict block does not hold K3 (224x112 to
// 352x176), for all four kernels: strict_add_substep repeats the cluster
// body's strict arithmetic (strict_value, additive splitting, compact
// polar sub-cycles) with the state, the sums and the winds in global
// memory and L2, as the sequential strict form keeps them.  Its block
// (strict_refined_parts with 8 words a row, 106,752 B at 256x128) has the
// double buffer, wz with halo rows and the sub-cycles' two buffers: the
// diffusion sub-cycle runs first, its rows' last values park in the next
// buffer's own rows, then the advection sub-cycle (where strict_substep
// runs both at once over four buffers, which at 352x176 would need
// 250,624 B).  A round takes the rows still within their counts
// (sub_cycle), so the pole block does not sub-cycle its other rows to the
// pole row's count as the cluster body does.  What bounds it: the pole
// rows' rounds (450 a substep at 256x128); on an H100 80GB HBM3 at 700 W
// a 256x128 strict year takes ~3.08 s, ~176 us a substep.
//
// The wide form (WIDE, suffixes _wide and _wide_legacy: 768x384 at dt_crcl
// 450 s, 96 substeps a step; and the sequential strict form's, suffix
// _strict_wide, below, built in csrc/strict_wide_kernel.cu) runs the sequential form's body for a grid
// whose rows one 16-block cluster cannot hold (24 rows of 768 columns a
// block: the double buffer alone is 344,064 B).  One run, or one member,
// spreads over G = RefinedArgs::groups clusters of 16 blocks (G = 6 at
// 768x384: 96 blocks of R = 4 rows, 196,656 B of shared memory a block);
// cluster k of a run holds rows [16 k R, 16 (k + 1) R), block b = 16 k +
// rank rows [b R, (b + 1) R), and the member is the cluster index / G.
// Every phase of a substep stays row-local, so only the halo rows cross
// blocks: inside a cluster through distributed shared memory as before;
// across the G - 1 edges between a run's clusters the edge blocks post
// their two edge rows of both fields to a small global array
// (RefinedArgs::ghalo, two slots used in turn, so a slot is written again
// only two barriers after its last read) and read their neighbour's into
// their halo rows after a grid barrier (wide_exchange).  That barrier
// follows each step start and each substep, where the cluster body has
// its cluster.sync(): cg::this_grid().sync() of a cooperative launch
// (cudaLaunchAttributeCooperative beside the cluster dimension), after
// the cluster.sync() that orders the distributed shared memory pushes.
// It spans the launch, all of its members, which pass the same barriers.
// The first barrier (after the state copy) and the last stay
// cluster-wide: they order only the blocks' shared memory lifetimes, and
// no global data crosses a cluster there.  A grid barrier over clusters
// that are not all resident never ends, so the launcher refuses a launch
// whose M * G clusters the card does not run at once
// (GREB_ERR_RESIDENT); K3 and K4 launch floor(capacity / G) members at a
// time (ops/cuda/multiyear.py).  What bounds it: the
// composite rows (rows 0-13 and 370-383 in blocks 0-3 and 92-95) read
// U_all and W_all, 39.6 MB each at 768x384, every substep; together
// they exceed the 50 MB L2, so those eight blocks stream them from HBM
// while the other 88 wait at the barrier (ROADMAP Queue 2, redesign e).
//
// The strict wide form (R_STRICT with WIDE, suffix _strict_wide: the
// strict transport and no transport at 768x384; its entries and launchers
// in csrc/strict_wide_kernel.cu, a library of its own) is the sequential strict
// form's body on the wide form's clusters and exchanges: 6 clusters of 16
// blocks of 4 rows, strict_refined_parts on 96 blocks (196,704 B a block),
// the halo rows across the cluster edges through ghalo after each step
// start and substep.  Each pole's 4 rows (6612, 734, 265, 135 diffusion
// rounds a substep; every other row at most 82) run spread over its own
// cluster's 16 blocks, 48 of the 768 columns each (spread_cycle), after
// those blocks' own rows; the middle clusters wait at the grid barrier.
// Without transport a step is the state update alone.

#define MAX_SEGS 8        // = year_kernel.MAX_SEGS
#define MAX_GROUPS 8      // = year_kernel.MAX_GROUPS: clusters a wide run
                          // may span (132 SMs hold 8 clusters of 16)

// The forms of the refined instantiation (RefinedArgs::form): the fold with
// sequential splitting and packed composites (_refined), the fold with
// additive splitting and dense composites (pcomp in YearArgs; _additive),
// the strict transport with sequential splitting (_strict_refined), the
// fold with additive splitting and packed composites (_additive_packed),
// the strict transport with additive splitting (_strict_additive).
enum RefinedForm { R_SEQ, R_ADDITIVE, R_STRICT, R_ADDITIVE_PACKED,
                   R_STRICT_ADDITIVE };

struct RefinedArgs {
  const float* pcu;        // (X, rtot) U_all
  const float* pcw;        // (rtot, X) W_all
  const int* comp_off;     // (2K,) offset in rtot of composite row f*K + k
  const int* comp_rank;    // (2K,) its rank
  int rtot, n_dseg, n_aseg;
  int dseg[3 * MAX_SEGS];  // the diffusion segments (kt, kb, iters), in order
  int aseg[3 * MAX_SEGS];  // the advection segments
  int form;                // enum RefinedForm
  // the wide form: clusters a run spans (1 or 0 elsewhere) and the halo
  // rows across its cluster edges (M, 2 slots, groups - 1 edges, 2 sides,
  // 2 fields, HALO, X)
  int groups;
  float* ghalo;
  // the sequential strict form: rounds of the spread pole sub-cycle
  // between exchanges (1..SPREAD_KMAX)
  int spread_k;
};

// Parts of a refined block's shared memory, in layout order
// (ops/cuda/year_kernel.py REFINED_PARTS).
enum RefinedPart { Q_XBUF, Q_WZ, Q_XA, Q_SCRATCH, Q_INDEX, N_QPARTS };

// Rows of [r0, r1) in [a, b).
__host__ __device__ inline int rows_in(int r0, int r1, int a, int b) {
  const int lo = r0 > a ? r0 : a, hi = r1 < b ? r1 : b;
  return hi > lo ? hi - lo : 0;
}

// The rows from each pole that any of n segments reaches: segments are
// nested, so their union is (max kt, max kb).
__host__ __device__ inline void seg_reach(const int* seg, int n, int* kt,
                                          int* kb) {
  *kt = 0;
  *kb = 0;
  for (int s = 0; s < n; ++s) {
    *kt = seg[3 * s] > *kt ? seg[3 * s] : *kt;
    *kb = seg[3 * s + 1] > *kb ? seg[3 * s + 1] : *kb;
  }
}

// The most rows of [a0, a1) and [b0, b1) together that one of C blocks of
// R rows holds.
__host__ __device__ inline long long most_rows(int C, int R, int a0, int a1,
                                               int b0, int b1) {
  long long m = 0;
  for (int b = 0; b < C; ++b) {
    const long long k = rows_in(b * R, (b + 1) * R, a0, a1)
                        + rows_in(b * R, (b + 1) * R, b0, b1);
    m = k > m ? k : m;
  }
  return m;
}

// Bytes of each part of a refined block's shared memory for a Y x X grid
// on C blocks, and their total; 0 where C does not split the rows into
// blocks of at least HALO rows, X is not a multiple of COMP_BLOCK (the
// composite sums take whole blocks of a row) or a segment table is longer
// than MAX_SEGS.  The scratch holds, in turn, the
// diffusion segments' two buffers (both fields of the block's rows in any
// diffusion segment), the composite rows' t1 and z (both fields of its
// composite rows, z at most X a row) and the advection segments' two
// buffers.  The same reckoning as ops/cuda/year_kernel.py refined_layout.
// C counts every block of a run: up to max_blocks (the wide form's 16 G).
__host__ __device__ inline long long refined_parts(int Y, int X, int ktc,
                                                   int kbc, int C,
                                                   const RefinedArgs& g,
                                                   long long* parts,
                                                   int max_blocks =
                                                       MAX_CLUSTER) {
  if (C < 1 || C > max_blocks || Y % C != 0 || Y / C < HALO
      || X % COMP_BLOCK != 0 || g.n_dseg < 0 || g.n_dseg > MAX_SEGS
      || g.n_aseg < 0
      || g.n_aseg > MAX_SEGS)
    return 0;
  const int R = Y / C;
  int dkt, dkb, akt, akb;
  seg_reach(g.dseg, g.n_dseg, &dkt, &dkb);
  seg_reach(g.aseg, g.n_aseg, &akt, &akb);
  long long rows = most_rows(C, R, 0, ktc, Y - kbc, Y);   // composite rows
  const long long kmax = rows;
  const long long nsd = most_rows(C, R, ktc, ktc + dkt, Y - kbc - dkb,
                                  Y - kbc);
  const long long nsa = most_rows(C, R, 0, akt, Y - akb, Y);
  rows = nsd > rows ? nsd : rows;
  rows = nsa > rows ? nsa : rows;
  const long long f = sizeof(float), RX = (long long)R * X;
  parts[Q_XBUF] = f * 2 * 2 * (R + 2 * HALO) * X;
  parts[Q_WZ] = f * 2 * RX;
  parts[Q_XA] = f * 2 * RX;
  parts[Q_SCRATCH] = f * 2 * 2 * rows * X;
  parts[Q_INDEX] = f * ((2 * kmax + 1 + 3) / 4 * 4);
  long long total = 0;
  for (int k = 0; k < N_QPARTS; ++k) total += parts[k];
  return total;
}

// The strict forms' block (R_STRICT, R_STRICT_ADDITIVE) in refined_parts'
// terms: the double buffer, wz of both fields with HALO rows each side
// (Q_WZ), no xa (R_STRICT's xz and R_STRICT_ADDITIVE's finished diffusion
// sub-cycle wait in the next buffer's own rows), the sub-cycles' two (2,
// R, X) buffers (Q_SCRATCH) and the rows' constants (Q_INDEX): 6 words a
// row (the two sub-cycle coefficients and counts, and the block's rows in
// order of each count), R_STRICT_ADDITIVE (`additive`) 8, with the 7-point
// diffusion and 2-point advection coefficients of the rows without a
// sub-cycle; 0 where C does not split the rows into blocks of at least
// HALO rows or X is not a multiple of 4.  The same reckoning as
// ops/cuda/year_kernel.py strict_refined_layout.
// C counts every block of a run: up to max_blocks (the wide form's 16 G).
__host__ __device__ inline long long strict_refined_parts(int Y, int X, int C,
                                                          long long* parts,
                                                          bool additive =
                                                              false,
                                                          int max_blocks =
                                                              MAX_CLUSTER) {
  if (C < 1 || C > max_blocks || Y % C != 0 || Y / C < HALO || X % 4 != 0)
    return 0;
  const long long R = Y / C, f = sizeof(float);
  parts[Q_XBUF] = f * 2 * 2 * (R + 2 * HALO) * X;
  parts[Q_WZ] = f * 2 * (R + 2 * HALO) * X;
  parts[Q_XA] = 0;
  parts[Q_SCRATCH] = f * 2 * 2 * R * X;
  parts[Q_INDEX] = f * (((additive ? 8 : 6) * R + 3) / 4 * 4);
  long long total = 0;
  for (int k = 0; k < N_QPARTS; ++k) total += parts[k];
  return total;
}

#define SPREAD_KMAX 16  // = year_kernel.SPREAD_KMAX: most rounds between
                        // exchanges (RefinedArgs::spread_k)
#define SPREAD_MAXR 32  // most rows a block of the sequential strict form

// The blocks of a spread group on a run of G clusters of C blocks.
__host__ __device__ inline int spread_blocks(int C, int G) {
  return G > 1 ? C : C / 2;
}

// Words of a block's spread scratch (a line's two buffers and wz of
// W + 6k columns, its two slots of both sides' 3k columns; 2 lines a row),
// which lives in the sub-cycles' second (2, R, X) buffer.
__host__ __device__ inline long long spread_words(int R, int W, int k) {
  return 2LL * R * (3LL * W + 30LL * k);
}

// Whether the spread fits a run of G clusters of C blocks (k rounds
// between exchanges): each group at least 2 blocks over whole columns,
// W >= 3k (only the next block's columns are a halo), a warp for each of
// the pole block's 2R lines, and the scratch in the second sub-cycle
// buffer.  The same reckoning as ops/cuda/year_kernel.py spread_layout.
__host__ __device__ inline bool spread_fits(int Y, int X, int C, int G,
                                            int k) {
  const int H = spread_blocks(C, G);
  if (G < 1 || C < 1 || (G == 1 && C % 2) || H < 2 || X % H || k < 1
      || k > SPREAD_KMAX || Y % (C * G))
    return false;
  const int R = Y / (C * G), W = X / H;
  return R >= HALO && R <= SPREAD_MAXR && W >= 3 * k
         && 2 * R * 32 <= cluster_threads(R, X)
         && spread_words(R, W, k) <= 2LL * R * X;
}

// The block's shared memory in the form of g (host side); the wide form
// (g.groups > 1, the sequential fold or strict form) on g.groups clusters
// of C.  The sequential strict form only where its spread sub-cycle fits.
static long long form_parts(int Y, int X, int ktc, int kbc, int C,
                            const RefinedArgs& g, long long* parts) {
  const int G = g.groups > 1 ? g.groups : 1;
  if (G > MAX_GROUPS) return 0;
  if (g.form == R_STRICT)
    return spread_fits(Y, X, C, G, g.spread_k)
               ? strict_refined_parts(Y, X, C * G, parts, false,
                                      G > 1 ? MAX_CLUSTER * MAX_GROUPS
                                            : MAX_CLUSTER)
               : 0;
  if (G > 1)
    return g.form == R_SEQ ? refined_parts(Y, X, ktc, kbc, C * G, g, parts,
                                           MAX_CLUSTER * MAX_GROUPS)
                           : 0;
  if (g.form == R_STRICT_ADDITIVE)
    return strict_refined_parts(Y, X, C, parts, true);
  return refined_parts(Y, X, ktc, kbc, C, g, parts);
}

// A block's local rows (0..R-1 from global row r0) in the global rows
// [a0, a1) and [c0, c1), as slots 0, 1, ... in row order.
struct RowSlots {
  int t0, nt, b0, nb;
  __device__ RowSlots(int r0, int R, int a0, int a1, int c0, int c1)
      : t0((a0 > r0 ? a0 : r0) - r0), nt(rows_in(r0, r0 + R, a0, a1)),
        b0((c0 > r0 ? c0 : r0) - r0), nb(rows_in(r0, r0 + R, c0, c1)) {}
  __device__ __forceinline__ int n() const { return nt + nb; }
  __device__ __forceinline__ int slot(int i) const {
    if (i >= t0 && i < t0 + nt) return i - t0;
    if (i >= b0 && i < b0 + nb) return nt + (i - b0);
    return -1;
  }
  __device__ __forceinline__ int row(int s) const {
    return s < nt ? t0 + s : b0 + (s - nt);
  }
};

// Field f, local row i of a block plane: f * fs + (i + r0) * X from p.
struct Plane {
  float* p;
  int fs, r0;
  __device__ __forceinline__ float* at(int f, int i, int X) const {
    return p + f * fs + (i + r0) * X;
  }
};

// sum_s co[s * cs] * taps in sequence, centre first (fastcirc._apply7):
// the explicit segment iterations' form.
__device__ __forceinline__ float apply7_seq(const float* co, int cs,
                                            const Taps& t) {
  float d = co[3 * cs] * t.x0;
  d = d + co[0] * t.xm3;
  d = d + co[cs] * t.xm2;
  d = d + co[2 * cs] * t.xm1;
  d = d + co[4 * cs] * t.xp1;
  d = d + co[5 * cs] * t.xp2;
  d = d + co[6 * cs] * t.xp3;
  return d;
}

// The merged meridional increment of one (field, cell) from its row of a
// buffer with HALO rows each side: mc 7..10, c0m 11 (fastcirc2.substep).
__device__ __forceinline__ float merid(const float* cf, int cs,
                                       const float* row, int j, int X) {
  float dy = cf[11 * cs] * row[j];
  dy = dy + cf[7 * cs] * row[j - 2 * X];
  dy = dy + cf[8 * cs] * row[j - X];
  dy = dy + cf[9 * cs] * row[j + X];
  dy = dy + cf[10 * cs] * row[j + 2 * X];
  return dy;
}

// One explicit segment (fastcirc._iterate) on the block's rows `in`, which
// lie in `band`, the rows the scratch holds (slot s of field f at
// (f * band.n() + s) * X): t1 = base + d, `iters` iterations
// t1 = t1 + clamp(apply7(t1)) between the scratch's two buffers, then
// d = t1 - base.  Coefficient s of global cell c is co[c + s * P].
// Block-uniform; ends at a __syncthreads().
__device__ void seg_iterate(const RowSlots& band, const RowSlots& in,
                            int iters, const Plane& base, const Plane& d,
                            const float* co, float* scr, int r0, int X,
                            int YX) {
  const int NB = band.n() * X, NI = in.n() * X, P = 2 * YX;
  float* const buf0 = scr;
  float* const buf1 = scr + 2 * NB;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_ni(NI), by_x(X);
  // (field, cell) l of the segment's own rows: local row i, column j, and
  // its offset in a scratch buffer
  auto cell = [&](int l, int& f, int& i, int& j) {
    f = by_ni(l);
    const int rest = l - f * NI, s = by_x(rest);
    j = rest - s * X;
    i = in.row(s);
    return (f * band.n() + band.slot(i)) * X + j;
  };
  for (int l = tid; l < 2 * NI; l += nt) {
    int f, i, j;
    const int o = cell(l, f, i, j);
    buf0[o] = base.at(f, i, X)[j] + d.at(f, i, X)[j];
  }
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
    const float* src = it & 1 ? buf1 : buf0;
    float* dst = it & 1 ? buf0 : buf1;
    for (int l = tid; l < 2 * NI; l += nt) {
      int f, i, j;
      const int o = cell(l, f, i, j);
      Taps t;
      zonal_taps(src + (o - j), j, X, t);
      const float v = apply7_seq(
          co + (size_t)f * YX + (size_t)(r0 + i) * X + j, P, t);
      dst[o] = t.x0 + clamp_neg(v, t.x0);
    }
  }
  __syncthreads();
  const float* fin = iters & 1 ? buf1 : buf0;
  for (int l = tid; l < 2 * NI; l += nt) {
    int f, i, j;
    const int o = cell(l, f, i, j);
    d.at(f, i, X)[j] = fin[o] - base.at(f, i, X)[j];
  }
  __syncthreads();
}

// Composite index k of global row r: the top ktc rows, then the bottom.
__device__ __forceinline__ int comp_k(int r, int Y, int ktc, int kbc) {
  return r < ktc ? r : ktc + (r - (Y - kbc));
}

// The packed composites (fastcirc2._packed_comp) of the block's composite
// rows (slots q of `comp`, field-major fq = f * nq + q): t1 = x + dd;
// z = t1 U_all[:, off:off+r]; t2 = z W_all[off:off+r, :], each sum in
// blocks of COMP_BLOCK terms aligned to 0 in X and in Rtot as _row_dot
// sums; then dd = (t1 + clamp(t2 - t1, t1)) - x.  zpre: the slots' prefix
// sums of ranks (z of slot fq at zpre[fq]).  Each block of COMP_BLOCK
// terms is summed in sequence with zeros outside the row, as _row_dot
// sums its masked terms (a zero term changes no sum but the sign of a
// zero), from the block that holds the row's first column.  Block-uniform;
// ends at a __syncthreads().
__device__ void packed_comp(const RefinedArgs& g, const RowSlots& comp,
                            const int* zpre, const Plane& x, float* dd,
                            float* scr, int r0, int R, int Y, int X, int ktc,
                            int kbc) {
  const int nq = comp.n(), K = ktc + kbc, RX = R * X;
  float* t1 = scr;               // (2, nq, X)
  float* z = scr + 2 * nq * X;   // zpre[2 nq] values
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_x(X), by_nq(nq);
  for (int o = tid; o < 2 * nq * X; o += nt) {
    const int fq = by_x(o), j = o - fq * X;
    const int f = by_nq(fq), i = comp.row(fq - f * nq);
    t1[o] = x.at(f, i, X)[j] + dd[f * RX + i * X + j];
  }
  __syncthreads();
  for (int o = tid; o < zpre[2 * nq]; o += nt) {
    int fq = 0;
    while (zpre[fq + 1] <= o) ++fq;
    const int f = by_nq(fq), r = r0 + comp.row(fq - f * nq);
    const int col = g.comp_off[f * K + comp_k(r, Y, ktc, kbc)]
                    + (o - zpre[fq]);
    // t1's row 16 bytes at a time (X is a multiple of COMP_BLOCK)
    const float4* tr = reinterpret_cast<const float4*>(t1 + fq * X);
    const float* u = g.pcu + col;
    float zv = 0.f;
#pragma unroll 2
    for (int b = 0; b < X; b += COMP_BLOCK, u += (size_t)COMP_BLOCK * g.rtot) {
      float uv[COMP_BLOCK];
#pragma unroll
      for (int k = 0; k < COMP_BLOCK; ++k) uv[k] = u[(size_t)k * g.rtot];
      const float4 ta = tr[b / 4], tb = tr[b / 4 + 1];
      float part = ta.x * uv[0];
      part = part + ta.y * uv[1];
      part = part + ta.z * uv[2];
      part = part + ta.w * uv[3];
      part = part + tb.x * uv[4];
      part = part + tb.y * uv[5];
      part = part + tb.z * uv[6];
      part = part + tb.w * uv[7];
      zv = b == 0 ? part : zv + part;
    }
    z[o] = zv;
  }
  __syncthreads();
  for (int o = tid; o < 2 * nq * X; o += nt) {
    const int fq = by_x(o), j = o - fq * X;
    const int f = by_nq(fq), i = comp.row(fq - f * nq);
    const int kk = f * K + comp_k(r0 + i, Y, ktc, kbc);
    const int off = g.comp_off[kk], end = off + g.comp_rank[kk];
    const float* zr = z + zpre[fq] - off;   // zr[c], c in [off, end)
    const float* w = g.pcw + j;
    const int b0 = off - off % COMP_BLOCK;
    float t2 = 0.f;
    for (int bs = b0; bs < end; bs += COMP_BLOCK) {
      // whole blocks load without guards; the branch is uniform where a
      // warp's threads share the row (X a multiple of 32, as 384)
      const float* wb = w + (size_t)bs * X;
      float wv[COMP_BLOCK], zc[COMP_BLOCK];
      if (bs >= off && bs + COMP_BLOCK <= end) {
#pragma unroll
        for (int k = 0; k < COMP_BLOCK; ++k) {
          wv[k] = wb[k * X];
          zc[k] = zr[bs + k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < COMP_BLOCK; ++k) {
          const bool in = bs + k >= off && bs + k < end;
          wv[k] = in ? wb[k * X] : 0.f;
          zc[k] = in ? zr[bs + k] : 0.f;
        }
      }
      float part = zc[0] * wv[0];
#pragma unroll
      for (int k = 1; k < COMP_BLOCK; ++k) part = part + zc[k] * wv[k];
      t2 = bs == b0 ? part : t2 + part;
    }
    const float tv = t1[o];
    dd[f * RX + i * X + j] = (tv + clamp_neg(t2 - tv, tv)) - x.at(f, i, X)[j];
  }
  __syncthreads();
}

// What a refined block holds besides its buffers: its rows' sets and
// shared-memory parts.
struct RefinedBlock {
  RowSlots comp, dband, aband;  // composite rows; rows of any diffusion /
                                // advection segment
  const int* zpre;              // the composite slots' prefix sums of ranks
  const float* wz;              // (2, R, X)
  float* xa;                    // (2, R, X): dd, then xa (additive: dd)
  float* scr;                   // the scratch
};

// One refined substep of this block's rows, buffer cur -> nxt
// (fastcirc2.substep at seq_zonal): the zonal diffusion dd of every
// (field, cell), clamped on the band rows, and xa = x + wz * dd at once on
// rows without segments or composites; the diffusion segments, the
// composites and xa of their rows; the zonal advection da of xa, clamped;
// the advection segments (da of their rows parked in the next buffer's own
// rows, which the block alone writes); xa + da + dy into buffer nxt,
// pushed to the neighbours' halos.  MEMBERS: this cluster's member's
// coefficient scratch (run_refined; WIDE: the member of g.groups clusters).
template <bool MEMBERS, bool WIDE = false>
__device__ void refined_substep(const YearArgs& a, const RefinedArgs& g,
                                const RefinedBlock& bk, const Bufs& bufs,
                                int cur, int nxt, int r0) {
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const float* const cfm =
      a.cf + (MEMBERS ? (size_t)(member_index() / (WIDE ? g.groups : 1)) *
                            12 * P
                      : 0);
  const int R = bufs.R, RX = R * X, BX = bufs.field();
  const int ktc = a.ktc, kbc = a.kbc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  const float* xb = bufs.mine + cur;
  const Plane x{bufs.mine + cur, BX, HALO};
  const Plane xa{bk.xa, RX, 0};
  for (int l = tid; l < 2 * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X, r = r0 + i;
    Taps tp;
    zonal_taps(xb + f * BX + (i + HALO) * X, j, X, tp);
    const float* zd = a.zd + (size_t)f * YX + (size_t)r0 * X + li;
    float dd = tree7(zd[3 * P] * tp.x0, zd[0] * tp.xm3, zd[P] * tp.xm2,
                     zd[2 * P] * tp.xm1, zd[4 * P] * tp.xp1,
                     zd[5 * P] * tp.xp2, zd[6 * P] * tp.xp3);
    if (r < a.bt || r >= Y - a.bb) dd = clamp_neg(dd, tp.x0);
    const bool later = bk.comp.slot(i) >= 0 || bk.dband.slot(i) >= 0;
    bk.xa[l] = later ? dd : tp.x0 + bk.wz[l] * dd;
  }
  __syncthreads();
  if (bk.comp.n() + bk.dband.n() > 0) {   // block-uniform
    for (int k = 0; k < g.n_dseg; ++k) {
      const int kt = g.dseg[3 * k], kb = g.dseg[3 * k + 1];
      const RowSlots in(r0, R, ktc, ktc + kt, Y - kbc - kb, Y - kbc);
      if (in.n() > 0)
        seg_iterate(bk.dband, in, g.dseg[3 * k + 2], x, xa, a.zd, bk.scr, r0,
                    X, YX);
    }
    if (bk.comp.n() > 0)
      packed_comp(g, bk.comp, bk.zpre, x, bk.xa, bk.scr, r0, R, Y, X, ktc,
                  kbc);
    for (int l = tid; l < 2 * RX; l += nt) {
      const int f = by_rx(l), li = l - f * RX, i = by_x(li);
      if (bk.comp.slot(i) >= 0 || bk.dband.slot(i) >= 0)
        bk.xa[l] = xb[f * BX + HALO * X + li] + bk.wz[l] * bk.xa[l];
    }
    __syncthreads();
  }
  const Plane da{bufs.mine + nxt, BX, HALO};
  for (int l = tid; l < 2 * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X, r = r0 + i;
    Taps ta;
    zonal_taps(bk.xa + f * RX + i * X, j, X, ta);
    const float* cf = cfm + (size_t)f * YX + (size_t)r0 * X + li;
    float dv = tree7(cf[3 * P] * ta.x0, cf[0] * ta.xm3, cf[P] * ta.xm2,
                     cf[2 * P] * ta.xm1, cf[4 * P] * ta.xp1,
                     cf[5 * P] * ta.xp2, cf[6 * P] * ta.xp3);
    if (r < a.bt || r >= Y - a.bb) dv = clamp_neg(dv, ta.x0);
    if (bk.aband.slot(i) >= 0) {
      da.at(f, i, X)[j] = dv;
      continue;
    }
    bufs.put(nxt, f, i, j,
             (ta.x0 + dv) + merid(cf, P, xb + f * BX + (i + HALO) * X, j, X));
  }
  if (bk.aband.n() == 0) return;   // block-uniform
  __syncthreads();
  for (int k = 0; k < g.n_aseg; ++k) {
    const int kt = g.aseg[3 * k], kb = g.aseg[3 * k + 1];
    const RowSlots in(r0, R, 0, kt, Y - kb, Y);
    if (in.n() > 0)
      seg_iterate(bk.aband, in, g.aseg[3 * k + 2], xa, da, cfm, bk.scr, r0,
                  X, YX);
  }
  for (int l = tid; l < 2 * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    if (bk.aband.slot(i) < 0) continue;
    const float* cf = cfm + (size_t)f * YX + (size_t)r0 * X + li;
    bufs.put(nxt, f, i, j,
             (bk.xa[l] + da.at(f, i, X)[j])
                 + merid(cf, P, xb + f * BX + (i + HALO) * X, j, X));
  }
}

// The dense composites (fastcirc2._extra_diffusion's composite rows) of
// the block's composite rows (slots q of `comp`, field-major
// fq = f * nq + q): t1 = x + dd into the scratch; t2 = t1 pcomp[f, k], one
// column a thread, its X terms read from global memory (L2) and summed in
// _row_dot's order: each block of COMP_BLOCK terms in sequence, added to
// the column's running sum in order; then dd = (t1 + clamp(t2 - t1, t1))
// - x.  Block-uniform; ends at a __syncthreads().
__device__ void dense_comp(const YearArgs& a, const RowSlots& comp,
                           const Plane& x, float* dd, float* scr, int r0,
                           int R) {
  const int Y = a.Y, X = a.X, nq = comp.n(), K = a.ktc + a.kbc, RX = R * X;
  float* t1 = scr;   // (2, nq, X)
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_x(X), by_nq(nq);
  for (int o = tid; o < 2 * nq * X; o += nt) {
    const int fq = by_x(o), j = o - fq * X;
    const int f = by_nq(fq), i = comp.row(fq - f * nq);
    t1[o] = x.at(f, i, X)[j] + dd[f * RX + i * X + j];
  }
  __syncthreads();
  for (int o = tid; o < 2 * nq * X; o += nt) {
    const int fq = by_x(o), j = o - fq * X;
    const int f = by_nq(fq), i = comp.row(fq - f * nq);
    const int k = comp_k(r0 + i, Y, a.ktc, a.kbc);
    // t1's row 16 bytes at a time (X is a multiple of COMP_BLOCK)
    const float4* tr = reinterpret_cast<const float4*>(t1 + fq * X);
    const float* pc = a.pcomp + (size_t)(f * K + k) * X * X + j;
    float t2 = 0.f;
#pragma unroll 2
    for (int b = 0; b < X; b += COMP_BLOCK, pc += (size_t)COMP_BLOCK * X) {
      float pv[COMP_BLOCK];
#pragma unroll
      for (int kk = 0; kk < COMP_BLOCK; ++kk) pv[kk] = pc[(size_t)kk * X];
      const float4 ta = tr[b / 4], tb = tr[b / 4 + 1];
      float part = ta.x * pv[0];
      part = part + ta.y * pv[1];
      part = part + ta.z * pv[2];
      part = part + ta.w * pv[3];
      part = part + tb.x * pv[4];
      part = part + tb.y * pv[5];
      part = part + tb.z * pv[6];
      part = part + tb.w * pv[7];
      t2 = b == 0 ? part : t2 + part;
    }
    const float tv = t1[o];
    dd[f * RX + i * X + j] = (tv + clamp_neg(t2 - tv, tv)) - x.at(f, i, X)[j];
  }
  __syncthreads();
}

// One refined substep with additive zonal splitting and dense composites
// (fastcirc2.substep without seq_zonal: 192x96), or packed ones (PACKED:
// 224x112 to 352x176, packed_comp as the sequential form runs it, its
// slots' rank sums in bk.zpre), buffer cur -> nxt: the
// zonal diffusion dd and advection da of every (field, cell) from the same
// taps of x, each clamped on the band rows, and the merged meridional dy
// (increments, as the cluster body); a cell of a row in no segment and no
// composite goes out at once, ((x + wz*dd) + da) + dy (combine), pushed to
// the neighbours' halos.  The other rows (`later`: those of bk.comp,
// bk.dband and bk.aband) keep dd in bk.xa and
// park da in the next buffer's own rows, which the block alone writes;
// the diffusion segments and the composites finish dd, the advection
// segments (from x) da, and those rows go out last, combined the same
// way.  MEMBERS: this cluster's member's coefficient scratch.
template <bool MEMBERS, bool PACKED = false>
__device__ void additive_substep(const YearArgs& a, const RefinedArgs& g,
                                 const RefinedBlock& bk,
                                 const RowSlots& later, const Bufs& bufs,
                                 int cur, int nxt, int r0) {
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const float* const cfm =
      a.cf + (MEMBERS ? (size_t)member_index() * 12 * P : 0);
  const int R = bufs.R, RX = R * X, BX = bufs.field();
  const int ktc = a.ktc, kbc = a.kbc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  const float* xb = bufs.mine + cur;
  const Plane x{bufs.mine + cur, BX, HALO};
  const Plane dd{bk.xa, RX, 0};
  const Plane da{bufs.mine + nxt, BX, HALO};
  for (int l = tid; l < 2 * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X, r = r0 + i;
    const float* row = xb + f * BX + (i + HALO) * X;
    Taps tp;
    zonal_taps(row, j, X, tp);
    tp.km2 = row[j - 2 * X];
    tp.km1 = row[j - X];
    tp.kp1 = row[j + X];
    tp.kp2 = row[j + 2 * X];
    const size_t c = (size_t)f * YX + (size_t)r0 * X + li;
    float dv, av, dy;
    increments(a.zd + c, P, cfm + c, P, tp, r < a.bt || r >= Y - a.bb, dv,
               av, dy);
    if (later.slot(i) >= 0) {
      bk.xa[l] = dv;
      da.at(f, i, X)[j] = av;
    } else {
      bufs.put(nxt, f, i, j, combine(tp.x0, bk.wz[l], dv, av, dy));
    }
  }
  if (later.n() == 0) return;   // block-uniform
  __syncthreads();
  for (int k = 0; k < g.n_dseg; ++k) {
    const int kt = g.dseg[3 * k], kb = g.dseg[3 * k + 1];
    const RowSlots in(r0, R, ktc, ktc + kt, Y - kbc - kb, Y - kbc);
    if (in.n() > 0)
      seg_iterate(bk.dband, in, g.dseg[3 * k + 2], x, dd, a.zd, bk.scr, r0,
                  X, YX);
  }
  if (bk.comp.n() > 0) {
    if constexpr (PACKED)
      packed_comp(g, bk.comp, bk.zpre, x, bk.xa, bk.scr, r0, R, Y, X, ktc,
                  kbc);
    else
      dense_comp(a, bk.comp, x, bk.xa, bk.scr, r0, R);
  }
  for (int k = 0; k < g.n_aseg; ++k) {
    const int kt = g.aseg[3 * k], kb = g.aseg[3 * k + 1];
    const RowSlots in(r0, R, 0, kt, Y - kb, Y);
    if (in.n() > 0)
      seg_iterate(bk.aband, in, g.aseg[3 * k + 2], x, da, cfm, bk.scr, r0,
                  X, YX);
  }
  const int NL = later.n() * X;
  const Div by_nl(NL);
  for (int o = tid; o < 2 * NL; o += nt) {
    const int f = by_nl(o), rest = o - f * NL, s = by_x(rest);
    const int j = rest - s * X, i = later.row(s);
    const int l = f * RX + i * X + j;
    const float* row = xb + f * BX + (i + HALO) * X;
    const float* cf = cfm + (size_t)f * YX + (size_t)r0 * X + i * X + j;
    bufs.put(nxt, f, i, j,
             combine(row[j], bk.wz[l], bk.xa[l], da.at(f, i, X)[j],
                     merid(cf, P, row, j, X)));
  }
}

// The strict form's per-block constants and scratch (run_refined,
// R_STRICT), in shared memory (strict_refined_parts).
struct StrictSeq {
  const float* wz;    // (2, R + 2*HALO, X) wz of Ta and q, zero past the poles
  const float* ccx2;  // (R,) kappa*dtdff2/dxlat^2: the diffusion sub-cycle's
  const float* cax2;  // (R,) the advection sub-cycle's coefficient
  const int* nd;      // (R,) diffusion sub-cycles of each row
  const int* na;      // (R,) advection sub-cycles of each row
  const int* od;      // (R,) the block's rows by diffusion count, most first
  const int* oa;      // (R,) the block's rows by advection count, most first
  float* sub;         // (2, 2, R, X): the sub-cycles' two buffers
  float ccy_d, ccy_a;
  int nf;    // fields that move: 2, or 1 (Ta) under VAPOR_CIRCULATION_OFF
  int nfa;   // fields that advect: nf, or 1 under VAPOR_DIFFUSION_ONLY
  bool quirk;   // the jp2 quirk (src/greb.f90:881)
};

// A cell's increment in one round of the diffusion sub-cycle
// (stencils._subcycle of _diff7): its wz taps w and the row's coefficient.
struct DiffCell {
  Taps w;
  float cc;
  __device__ __forceinline__ float operator()(const Taps& t) const {
    return clamp_neg(diff7(t, w, cc), t.x0);
  }
};

// ... and in one round of the advection sub-cycle (_adv_smooth3), with
// the cell's wind split and the jp2 quirk (q: the cell reads j+1 for j+2).
struct AdvCell {
  Taps w;
  float cc, um, up;
  bool q;
  __device__ __forceinline__ float operator()(const Taps& t) const {
    return clamp_neg(smooth3(t, w, q ? t.xp1 : t.xp2, q ? w.xp1 : w.xp2, um,
                             up, cc),
                     t.x0);
  }
};

// Rounds of one clamped zonal sub-cycle (stencils._subcycle) of fields
// [0, nfl) over the scratch's two buffers (field f, local row i at
// (f*R + i)*X), round k from buffer k&1 into the other.  A round takes the
// rows still within their counts n (ord: the rows by count, most first),
// so a row's last value is in buffer n[i]&1; cell(f, i, j) gives the
// increment function (DiffCell, AdvCell) of field f, row i, column j.
// While the rows left have one cell a thread or fewer (the pole row's
// deep rounds), each thread keeps its cell's function and tap columns
// across the rounds until the next row leaves.  Block-uniform: a
// __syncthreads() precedes each round and follows the last.
template <typename Cell>
__device__ __forceinline__ void sub_cycle(float* sub, const int* n,
                                          const int* ord, int nfl, int R,
                                          int X, Cell cell) {
  const int P = 2 * R * X;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_x(X);
  int nact = R;
  for (int it = 0;;) {
    while (nact > 0 && n[ord[nact - 1]] <= it) --nact;
    __syncthreads();
    if (nact == 0) return;
    if (nact * nfl * X <= nt) {
      const int stop = n[ord[nact - 1]];
      const bool mine = tid < nact * nfl * X;
      int o = 0, cols[7] = {};
      decltype(cell(0, 0, 0)) fn{};
      if (mine) {
        const int f = tid / (nact * X), rest = tid - f * nact * X;
        const int s = by_x(rest), j = rest - s * X, i = ord[s];
        o = (f * R + i) * X;
        for (int k = 0; k < 7; ++k) {
          const int c = j + k - 3;
          cols[k] = c < 0 ? c + X : (c >= X ? c - X : c);
        }
        fn = cell(f, i, j);
      }
      for (const int first = it; it < stop; ++it) {
        if (it > first) __syncthreads();
        if (!mine) continue;
        const float* row = sub + (it & 1) * P + o;
        Taps t;
        t.x0 = row[cols[3]];
        t.xm3 = row[cols[0]]; t.xm2 = row[cols[1]]; t.xm1 = row[cols[2]];
        t.xp1 = row[cols[4]]; t.xp2 = row[cols[5]]; t.xp3 = row[cols[6]];
        sub[(1 - (it & 1)) * P + o + cols[3]] = t.x0 + fn(t);
      }
      continue;
    }
    const float* src = sub + (it & 1) * P;
    float* dst = sub + (1 - (it & 1)) * P;
    for (int c = tid; c < nfl * X; c += nt) {
      const int f = by_x(c), j = c - f * X;
      for (int s = 0; s < nact; ++s) {
        const int i = ord[s], o = (f * R + i) * X;
        Taps t;
        zonal_taps(src + o, j, X, t);
        dst[o + j] = t.x0 + cell(f, i, j)(t);
      }
    }
    ++it;
  }
}

// ---------------------------------------------------------------------------
// the pole blocks' diffusion sub-cycle spread over their blocks' group
// (ROADMAP Queue 2 redesign d)
// ---------------------------------------------------------------------------
// The sequential strict form's deepest rounds are the pole blocks' rows'
// (768x384: 6612, 734, 265, 135 a substep; 384x192: 1652, 184, 67, ...),
// where every other row takes at most 82.  One SM cannot take them fast:
// at 768x384 a round is 1,536 (field, cell)s, past one a thread.  So each
// pole block's rows run on a group of H blocks, each owning W = X / H
// columns of every row (a line: one row of one field; the zonal stencils
// are row-local, and lines leave at their rows' counts): a block keeps its
// columns and 3k more each side, runs k rounds on them with a barrier of
// the line's warps between rounds (the valid columns shrink by 3 a round:
// the 7-point stencil reaches 3), then sends its 3k edge columns of each
// line still running to its two neighbours (st.async into their slots,
// which completes bytes on their mbarrier: no cluster barrier between
// exchanges).  Each cell's update is sub_cycle's, so the rounds stay
// bitwise equal to stencils._subcycle.  Groups: one cluster (384x192),
// its two halves, the top pole's (ranks 0..C/2-1) and the bottom's; a
// wide run, its first and last clusters.  The blocks of a group run their
// own rows' sub-cycles first, then lend their warps to the pole rows.  On
// an H100 a round takes ~400 cycles, an exchange ~1,400 (chip_smoke.py
// step 23 times k).
// A pole's spread group: H blocks from cluster rank rank0 (H = 0: this
// block is in none), this block h-th; the pole block's cluster rank and
// first global row.
struct SpreadGroup {
  int H, h, rank0, pole, r0p;
  bool top;
};

// This block's spread group, by its cluster rank and its cluster's place
// grp in a run of G clusters.
__device__ __forceinline__ SpreadGroup spread_group(int Y, int R, int C,
                                                    int G, int rank,
                                                    int grp) {
  SpreadGroup s{};
  if (G == 1) {
    s.H = C / 2;
    s.top = rank < s.H;
    s.rank0 = s.top ? 0 : s.H;
  } else {
    if (grp != 0 && grp != G - 1) return s;
    s.H = C;
    s.top = grp == 0;
  }
  s.h = rank - s.rank0;
  s.pole = s.top ? 0 : C - 1;
  s.r0p = s.top ? 0 : Y - R;
  return s;
}

// The mbarriers a spread block's slots complete on (two, used in turn),
// in static shared memory: the same offset in every block.
__shared__ unsigned long long spread_bar[2];

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of a phase, expecting `bytes` from the neighbours.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete; a wait past ~4e9
// clocks (seconds, where an exchange takes microseconds) means a missing
// arrival, and traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 4000000000LL) __trap();
  } while (!done);
}

// v into block `rank`'s shared memory at the offset of dst, completing 4
// bytes on that block's mbarrier at the offset of bar.
__device__ __forceinline__ void st_async(float* dst, float v,
                                         unsigned long long* bar,
                                         unsigned rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(d), "r"(__float_as_uint(v)), "r"(b) : "memory");
}

// The pole block's lines' counts, from the pole row outward (static
// shared memory).
__shared__ int spread_n[SPREAD_MAXR];

// One line's part of the spread sub-cycle in a run of epochs, the
// line's group of n threads, one cell a thread (spread_cycle).
struct SpreadLine {
  float* b0;          // the line's two buffers of L positions
  float* b1;
  float* slot;        // its slots: slot s at slot + s * sstride, the left
  int sstride;        // halo's 3k columns, then the right halo's
  int L, W, k, n;     // chunk, owned columns, rounds an epoch, its count
  int E, base;        // epochs of the substep, the slot epochs before it
  unsigned left, right;   // the neighbours' cluster ranks
  float cc;           // the row's coefficient
  unsigned bytes_in, bytes_next;   // a block's slot bytes an epoch in the
                                   // run, and in the epoch after it
};

// Epochs [e0, e1) of line ln (spread_cycle), this thread taking position
// p = 3 + t of the group's n threads (wz taps w), named barrier id
// between rounds: from epoch 1 on, the neighbours' edge columns from the
// epoch's slot after its mbarrier (thread 0 of the block arming the next
// epoch's), then the epoch's rounds, then this block's edge columns to the
// neighbours' slots where the line runs on.  Not inlined: the rounds run
// in registers of their own, apart from the substep's.  The one-warp
// schedule of spread_cycle repeats this protocol inline: a stride loop
// and a runtime choice of barrier here cost 44% of the pole rounds' time
// on an H100 (PERF.md §6), so the two stay apart and change together.
__device__ __noinline__ void spread_epochs(const SpreadLine& ln, int e0,
                                           int e1, int t, int n, int id,
                                           Taps w) {
  const SpreadLine s = ln;
  const int K3 = 3 * s.k, p = 3 + t;
  for (int e = e0; e < e1; ++e) {
    int b = (e * s.k) & 1;
    if (e > 0) {
      const int sl = (s.base + e - 1) & 1;
      if (threadIdx.x == 0 && e + 1 < s.E)
        mbar_expect(spread_bar + ((s.base + e) & 1),
                    e + 1 < e1 ? s.bytes_in : s.bytes_next);
      mbar_wait(spread_bar + sl, ((s.base + e - 1) >> 1) & 1);
      const float* src = s.slot + sl * s.sstride;
      float* cb = b ? s.b1 : s.b0;
      if (t < K3) {
        cb[t] = src[t];
        cb[K3 + s.W + t] = src[K3 + t];
      }
    }
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
    const int rounds = s.n - e * s.k < s.k ? s.n - e * s.k : s.k;
    for (int q = 0; q < rounds; ++q, b ^= 1) {
      const float* src = b ? s.b1 : s.b0;
      float* dst = b ? s.b0 : s.b1;
      if (p >= 3 * (q + 1) && p < s.L - 3 * (q + 1)) {
        Taps x;
        x.xm3 = src[p - 3]; x.xm2 = src[p - 2]; x.xm1 = src[p - 1];
        x.x0 = src[p];
        x.xp1 = src[p + 1]; x.xp2 = src[p + 2]; x.xp3 = src[p + 3];
        dst[p] = x.x0 + clamp_neg(diff7(x, w, s.cc), x.x0);
      }
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
    }
    if (e + 1 < s.E && s.n > (e + 1) * s.k && t < K3) {
      // the next epoch's halos: the first 3k owned columns to the left
      // neighbour's right slot, the last 3k to the right one's left slot
      const int sl = (s.base + e) & 1;
      float* dst = s.slot + sl * s.sstride;
      const float* cb = b ? s.b1 : s.b0;
      st_async(dst + K3 + t, cb[K3 + t], spread_bar + sl, s.left);
      st_async(dst + t, cb[s.W + t], spread_bar + sl, s.right);
    }
  }
}

// The diffusion sub-cycle of the pole block's rows (strict_seq_substep's
// first sub_cycle and xz, for those rows) on this block's columns of its
// group sg, k rounds between exchanges; after the cluster.sync() that ends
// every block's own rows' xz, before the one that hands the pole block its
// xz.  Line l is row l / nf from the pole outward, field l % nf; a line's
// chunk position p is global column c0 - 3k + p (periodic).  Epoch e runs
// the rounds [e k, (e + 1) k) of the lines still within their counts (a
// prefix of the lines: the counts fall away from the pole).  Between two
// epochs where a row leaves the lines keep their groups of warps: where
// the block has the warps, enough for one cell a thread (spread_epochs),
// else one warp a line, a lane taking its cells in turn; the block
// synchronises only where the groups change.  Epoch 0 starts from the
// pole block's x, a later one takes its neighbours' edge columns from slot
// (sc + e - 1) & 1.  A line's last value makes xz = x + wz (t1 - x) of its
// owned columns, written into the pole block's next buffer and its
// scratch's buffer 0 (the advection's start).  *sc counts the slot epochs
// of the run, the same in every block of a group.
__device__ void spread_cycle(const YearArgs& a, const StrictSeq& st,
                             const Bufs& bufs, const SpreadGroup& sg, int k,
                             int cur, int nxt, int* sc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int Y = a.Y, X = a.X, R = bufs.R, RX = R * X, P = 2 * RX;
  const int BX = bufs.field(), W = X / sg.H, K3 = 3 * k, L = W + 2 * K3;
  const int nf = st.nf, NL = nf * R, c0 = sg.h * W;
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int nmax = a.st_n[sg.top ? 0 : Y - 1];
  const int E = (nmax + k - 1) / k, base = *sc;
  *sc = base + (E > 1 ? E - 1 : 0);
  float* const priv = st.sub + P;              // (2, NL, L) the lines
  float* const wzl = priv + 2 * NL * L;        // (NL, L) their wz
  float* const slot = wzl + NL * L;            // (2, NL, 2, 3k)
  const unsigned left = sg.rank0 + (sg.h + sg.H - 1) % sg.H;
  const unsigned right = sg.rank0 + (sg.h + 1) % sg.H;
  const float* xpole = cluster.map_shared_rank(bufs.mine + cur, sg.pole);
  auto row = [&](int l) { return sg.top ? l / nf : R - 1 - l / nf; };
  auto xrow = [&](int l) {
    return xpole + (l % nf) * BX + (HALO + row(l)) * X;
  };
  if (tid < R) spread_n[tid] = a.st_n[sg.r0p + (sg.top ? tid : R - 1 - tid)];
  __syncthreads();
  // the lines still running are a prefix of them: the counts fall away
  // from the pole (as at every grid spread_fits takes; the host checks it)
  if (tid > 0 && tid < R && spread_n[tid] > spread_n[tid - 1]) __trap();
  for (int l = warp; l < NL; l += nw) {
    const float* xp = xrow(l);
    const float* wg = a.st_wz + (size_t)(l % nf) * Y * X
                      + (size_t)(sg.r0p + row(l)) * X;
    for (int p = lane; p < L; p += 32) {
      int c = c0 - K3 + p;
      c = c < 0 ? c + X : (c >= X ? c - X : c);
      priv[l * L + p] = xp[c];
      wzl[l * L + p] = wg[c];
    }
  }
  __syncthreads();
  // rows still running in epoch e
  auto rows_at = [&](int e, int r) {
    while (r > 0 && spread_n[r - 1] <= e * k) --r;
    return r;
  };
  const unsigned line_bytes = 2 * K3 * sizeof(float) * nf;
  if (tid == 0 && E > 1)
    mbar_expect(spread_bar + (base & 1), line_bytes * rows_at(1, R));
  // one cell a thread: warps a line
  const int wcell = (L - 6 + 31) / 32;
  for (int e0 = 0, rr = R; e0 < E;) {
    // a run of epochs [e0, e1) with the same lines: until the last of them
    // leaves
    if (e0 > 0) __syncthreads();
    rr = rows_at(e0, rr);
    const int A = nf * rr;
    const int e1 = min(E, (spread_n[rr - 1] + k - 1) / k);
    const int wpl = A * wcell <= nw && A <= 15 ? wcell : 1;
    const int g = warp / wpl, gt = tid - g * wpl * 32, gn = wpl * 32;
    const int l = g < A ? g : -1;
    if (l >= 0) {
      const int n = spread_n[l / nf], r = sg.r0p + row(l);
      const float* wl = wzl + l * L;
      SpreadLine ln{priv + l * L, priv + (NL + l) * L,
                    slot + l * 2 * K3, NL * 2 * K3, L, W, k, n, E, base,
                    left, right,
                    (a.st_kappa * a.st_rows[Y + r]) / a.st_rows[r],
                    line_bytes * rr, line_bytes * rows_at(e1, rr)};
      if (wpl > 1) {
        const int p = 3 + gt;
        Taps w{};
        if (p < L - 3) {
          w.xm3 = wl[p - 3]; w.xm2 = wl[p - 2]; w.xm1 = wl[p - 1];
          w.x0 = wl[p];
          w.xp1 = wl[p + 1]; w.xp2 = wl[p + 2]; w.xp3 = wl[p + 3];
        }
        spread_epochs(ln, e0, e1, gt, gn, 1 + g, w);
      } else {
        // one warp a line, a lane's cells in turn (spread_epochs' protocol)
        for (int e = e0; e < e1; ++e) {
          int b = (e * k) & 1;
          if (e > 0) {
            const int s = (base + e - 1) & 1;
            if (tid == 0 && e + 1 < E)
              mbar_expect(spread_bar + ((base + e) & 1),
                          e + 1 < e1 ? ln.bytes_in : ln.bytes_next);
            mbar_wait(spread_bar + s, ((base + e - 1) >> 1) & 1);
            const float* sl = ln.slot + s * ln.sstride;
            float* cb = b ? ln.b1 : ln.b0;
            for (int j = lane; j < K3; j += 32) {
              cb[j] = sl[j];
              cb[K3 + W + j] = sl[K3 + j];
            }
          }
          __syncwarp();
          const int rounds = n - e * k < k ? n - e * k : k;
          for (int q = 0; q < rounds; ++q, b ^= 1) {
            const float* src = b ? ln.b1 : ln.b0;
            float* dst = b ? ln.b0 : ln.b1;
            for (int p = 3 * (q + 1) + lane; p < L - 3 * (q + 1); p += 32) {
              Taps t, ww;
              t.xm3 = src[p - 3]; t.xm2 = src[p - 2]; t.xm1 = src[p - 1];
              t.x0 = src[p];
              t.xp1 = src[p + 1]; t.xp2 = src[p + 2]; t.xp3 = src[p + 3];
              ww.xm3 = wl[p - 3]; ww.xm2 = wl[p - 2]; ww.xm1 = wl[p - 1];
              ww.x0 = wl[p];
              ww.xp1 = wl[p + 1]; ww.xp2 = wl[p + 2]; ww.xp3 = wl[p + 3];
              dst[p] = t.x0 + clamp_neg(diff7(t, ww, ln.cc), t.x0);
            }
            __syncwarp();
          }
          if (e + 1 < E && n > (e + 1) * k) {
            const int s = (base + e) & 1;
            float* sl = ln.slot + s * ln.sstride;
            const float* cb = b ? ln.b1 : ln.b0;
            for (int j = lane; j < K3; j += 32) {
              st_async(sl + K3 + j, cb[K3 + j], spread_bar + s, left);
              st_async(sl + j, cb[W + j], spread_bar + s, right);
            }
          }
        }
      }
      if (n <= e1 * k) {
        // the line's last epoch was e1 - 1: xz of its owned columns, in
        // the pole block, from its last value (buffer n & 1)
        const int f = l % nf, i = row(l);
        const float* xp = xrow(l);
        const float* cb = n & 1 ? ln.b1 : ln.b0;
        float* xz = cluster.map_shared_rank(bufs.mine + nxt, sg.pole)
                    + f * BX + (HALO + i) * X;
        float* zs = f < st.nfa ? cluster.map_shared_rank(st.sub, sg.pole)
                                     + f * RX + i * X
                               : nullptr;
        if (wpl == 1) __syncwarp();
        for (int j = gt; j < W; j += gn) {
          const float x0 = xp[c0 + j];
          const float z = x0 + wl[K3 + j] * (cb[K3 + j] - x0);
          xz[c0 + j] = z;
          if (zs != nullptr) zs[c0 + j] = z;
        }
      }
    }
    e0 = e1;
  }
}

// One strict substep with sequential zonal splitting (stencils.circulation
// at seq_zonal, every row sub-cycled) of this block's rows at step t,
// buffer cur -> nxt: the diffusion sub-cycle of each moving field from x;
// xz = x + wz*(t1 - x) into the next buffer's own rows and the scratch's
// buffer 0; the advection sub-cycle of each advecting field from xz; then
// each cell's new value, xz + wz*dty + (dtx_a + dty_a) (a field that does
// not advect: xz + wz*dty), the meridional terms from x (dty of
// stencils.diffusion and of stencils.advection), written over its xz and
// pushed to the neighbours' halos.  The winds are read from global memory.
// SPREAD (run_refined's R_STRICT forms; g: the run's RefinedArgs, *sc the
// spread's slot epochs): the pole blocks' rows' diffusion sub-cycle and
// xz run on their groups (spread_cycle) between two cluster barriers,
// after the other blocks' own rows'; the slab kernels run the rest alone.
template <bool SPREAD = false>
__device__ void strict_seq_substep(const YearArgs& a, const StrictSeq& st,
                                   const Bufs& bufs, int cur, int nxt,
                                   int r0, int t,
                                   const RefinedArgs* g = nullptr,
                                   int* sc = nullptr) {
  const int Y = a.Y, X = a.X, R = bufs.R, RX = R * X, P = 2 * RX;
  const int BX = bufs.field(), WX = (R + 2 * HALO) * X;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  const float* x = bufs.mine + cur;
  float* xz = bufs.mine + nxt;
  const size_t row0 = (size_t)t * Y * X + (size_t)r0 * X;
  const float* u = a.u + row0;
  const float* v = a.v + row0;
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l);
    st.sub[l] = x[f * BX + HALO * X + (l - f * RX)];
  }
  SpreadGroup sg{};
  bool own = true;   // this block runs its own rows' diffusion sub-cycle
  if constexpr (SPREAD) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int G = g->groups > 1 ? g->groups : 1;
    sg = spread_group(Y, R, C, G, rank, (int)(blockIdx.x / C) % G);
    own = sg.H == 0 || rank != sg.pole;
  }
  if (own) {
    sub_cycle(st.sub, st.nd, st.od, st.nf, R, X, [&](int f, int i, int j) {
      DiffCell c;
      zonal_taps(st.wz + f * WX + (i + HALO) * X, j, X, c.w);
      c.cc = st.ccx2[i];
      return c;
    });
    for (int l = tid; l < st.nf * RX; l += nt) {
      const int f = by_rx(l), li = l - f * RX, i = by_x(li);
      const int o = f * BX + HALO * X + li;
      const float x0 = x[o];
      const float z = x0 + st.wz[f * WX + HALO * X + li]
                               * (st.sub[(st.nd[i] & 1) * P + l] - x0);
      xz[o] = z;
      if (f < st.nfa) st.sub[l] = z;
    }
  }
  if constexpr (SPREAD) {
    if (sg.H > 0) {   // cluster-uniform
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      spread_cycle(a, st, bufs, sg, g->spread_k, cur, nxt, sc);
      cluster.sync();
    }
  }
  sub_cycle(st.sub, st.na, st.oa, st.nfa, R, X, [&](int f, int i, int j) {
    AdvCell c;
    zonal_taps(st.wz + f * WX + (i + HALO) * X, j, X, c.w);
    const float uu = u[i * X + j];
    c.um = uu > 0.f ? uu : 0.f;
    c.up = uu < 0.f ? uu : 0.f;
    c.cc = st.cax2[i];
    c.q = st.quirk && j == X - 3;
    return c;
  });
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X, r = r0 + i;
    const float* xr = x + f * BX + (i + HALO) * X;
    const float* w = st.wz + f * WX + (i + HALO) * X;
    const float x0 = xr[j], km1 = xr[j - X], kp1 = xr[j + X];
    const float wm1 = w[j - X], wp1 = w[j + X];
    const float z = xz[f * BX + (i + HALO) * X + j];
    float val = z + w[j] * (st.ccy_d * (wm1 * (km1 - x0) + wp1 * (kp1 - x0)));
    if (f < st.nfa) {
      const float vv = v[li];
      const float vm = vv > 0.f ? vv : 0.f, vp = vv < 0.f ? vv : 0.f;
      const float km2 = xr[j - 2 * X], kp2 = xr[j + 2 * X];
      const float s_m = vm * (wm1 * (x0 - km1) + w[j - 2 * X] * (x0 - km2));
      const float s_p = vp * (wp1 * (x0 - kp1) + w[j + 2 * X] * (x0 - kp2));
      const float dya = st.ccy_a * ((-(r == 1 ? s_m : s_m / 3.f))
                                    + (r == Y - 2 ? s_p : s_p / 3.f));
      val = val + ((st.sub[(st.na[i] & 1) * P + l] - z) + dya);
    }
    bufs.put(nxt, f, i, j, val);
  }
}

// The strict form with additive splitting (run_refined, R_STRICT_ADDITIVE):
// StrictSeq's constants and scratch, and the coefficients of the rows
// without a polar sub-cycle (strict_value's), in shared memory
// (strict_refined_parts).
struct StrictAdd : StrictSeq {
  const float* ccx;   // (R,) kappa*dt_crcl/dxlat^2: 7-point diffusion
  const float* cax;   // (R,) dt_crcl/dxlat/2: 2-point upwind advection
};

// One strict substep with additive zonal splitting (stencils.circulation's
// compact-polar form: strict_substep's arithmetic, the cluster body's) of
// this block's rows at step t, buffer cur -> nxt, the winds read from
// global memory: each (field, cell) of a row without a polar sub-cycle at
// once (strict_value); the diffusion sub-cycle of the sub-cycled rows from
// x, each row's last value parked in the next buffer's own rows, which the
// block alone writes; the advection sub-cycle from x in the scratch; then
// those rows' cells, strict_value with both sub-cycles' values, written
// over the parked value (the cell read first) and pushed to the
// neighbours' halos.  A round takes the rows still within their counts
// (sub_cycle), where strict_substep adds 0 past a row's count.
__device__ void strict_add_substep(const YearArgs& a, const StrictAdd& st,
                                   const Bufs& bufs, int cur, int nxt,
                                   int r0, int t) {
  const int Y = a.Y, X = a.X, R = bufs.R, RX = R * X, P = 2 * RX;
  const int BX = bufs.field(), WX = (R + 2 * HALO) * X;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  const float* xb = bufs.mine + cur;
  float* park = bufs.mine + nxt;
  const size_t row0 = (size_t)t * Y * X + (size_t)r0 * X;
  const float* u = a.u + row0;
  const float* v = a.v + row0;
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    const bool adv = f < st.nfa;
    const bool sd = st.nd[i] >= 0, sa = adv && st.na[i] >= 0;
    const float* x = xb + f * BX + (i + HALO) * X;
    if (sd) st.sub[l] = x[j];
    if (sd || sa) continue;
    const int r = r0 + i;
    bufs.put(nxt, f, i, j,
             strict_value(x, st.wz + f * WX + (i + HALO) * X, j, X, st.ccx[i],
                          st.cax[i], st.ccy_d, st.ccy_a, adv, u[li], v[li],
                          r == 1, r == Y - 2, nullptr, nullptr));
  }
  sub_cycle(st.sub, st.nd, st.od, st.nf, R, X, [&](int f, int i, int j) {
    DiffCell c;
    zonal_taps(st.wz + f * WX + (i + HALO) * X, j, X, c.w);
    c.cc = st.ccx2[i];
    return c;
  });
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX, i = by_x(li);
    const int o = f * BX + HALO * X + li;
    if (st.nd[i] >= 0) park[o] = st.sub[(st.nd[i] & 1) * P + l];
    if (f < st.nfa && st.na[i] >= 0) st.sub[l] = xb[o];
  }
  sub_cycle(st.sub, st.na, st.oa, st.nfa, R, X, [&](int f, int i, int j) {
    AdvCell c;
    zonal_taps(st.wz + f * WX + (i + HALO) * X, j, X, c.w);
    const float uu = u[i * X + j];
    c.um = uu > 0.f ? uu : 0.f;
    c.up = uu < 0.f ? uu : 0.f;
    c.cc = st.cax2[i];
    c.q = st.quirk && j == X - 3;
    return c;
  });
  for (int l = tid; l < st.nf * RX; l += nt) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    const bool adv = f < st.nfa;
    const bool sd = st.nd[i] >= 0, sa = adv && st.na[i] >= 0;
    if (!sd && !sa) continue;
    const int r = r0 + i, row = f * BX + (i + HALO) * X;
    bufs.put(nxt, f, i, j,
             strict_value(xb + row, st.wz + f * WX + (i + HALO) * X, j, X,
                          st.ccx[i], st.cax[i], st.ccy_d, st.ccy_a, adv,
                          u[li], v[li], r == 1, r == Y - 2,
                          sd ? park + row : nullptr,
                          sa ? st.sub + (st.na[i] & 1) * P + f * RX + i * X
                             : nullptr));
  }
}

// A wide block's halo slots across its run's cluster edges: block 0 of
// cluster k > 0 posts its two top rows for the block above and takes that
// block's two bottom rows (edge k - 1, `top`); block C - 1 of cluster
// k < G - 1 the other way round (edge k, `bot`); -1: no such edge.  Edge e
// of slot s, side d (0: the rows above the edge, 1: the rows below) holds
// both fields' HALO rows at base + ((s (G - 1) + e) 2 + d) 2 HALO X.
struct WideEdge {
  float* base;   // this member's slots in RefinedArgs::ghalo
  int G, top, bot;
};

// Buffer `off`'s rows across the cluster edges (WIDE), after the
// cluster.sync() that ends a phase: the edge rows posted to slot `slot`,
// the launch's grid barrier, then the neighbours' rows read into this
// block's halo rows.  Every block of the launch calls it, in the same
// order.
__device__ void wide_exchange(const WideEdge& w, const Bufs& bufs, int off,
                              int slot) {
  const int X = bufs.X, R = bufs.R, BX = bufs.field(), HX = HALO * X;
  const int tid = threadIdx.x, nt = blockDim.x;
  auto at = [&](int e, int d) {
    return w.base + (((size_t)slot * (w.G - 1) + e) * 2 + d) * 2 * HX;
  };
  if (w.top >= 0) {
    float* dst = at(w.top, 1);
    for (int l = tid; l < 2 * HX; l += nt) {
      const int f = l >= HX, h = l - f * HX;
      dst[l] = bufs.mine[off + f * BX + HX + h];         // rows 0, 1
    }
  }
  if (w.bot >= 0) {
    float* dst = at(w.bot, 0);
    for (int l = tid; l < 2 * HX; l += nt) {
      const int f = l >= HX, h = l - f * HX;
      dst[l] = bufs.mine[off + f * BX + R * X + h];      // rows R-2, R-1
    }
  }
  cg::this_grid().sync();
  if (w.top >= 0) {
    const float* src = at(w.top, 0);
    for (int l = tid; l < 2 * HX; l += nt) {
      const int f = l >= HX, h = l - f * HX;
      bufs.mine[off + f * BX + h] = src[l];              // halo above
    }
  }
  if (w.bot >= 0) {
    const float* src = at(w.bot, 1);
    for (int l = tid; l < 2 * HX; l += nt) {
      const int f = l >= HX, h = l - f * HX;
      bufs.mine[off + f * BX + (R + HALO) * X + h] = src[l];   // below
    }
  }
  __syncthreads();
}

// The years of one member at an extension-mode grid on a cluster of C
// blocks, this block's rows, in the form FORM (enum RefinedForm): one year
// of the single run (K1: FLUX, K2: SCEN; MEMBERS false, physics p) or of
// member m = member_index() (K4: FLUX, K3: SCEN_YEARS, n_years years;
// MEMBERS true, physics p with the pack's columns cols, kept in shared
// memory: held in registers across the substeps they spill).  LEGACY: the
// state update with the switches of the flags word (the strict form always
// has them; under CIRCULATION_OFF it skips the substeps and their
// barriers and takes Ta and q from the state).  The state in the member's
// slice of a.state_out (copied from a.state_in first), the fold's step
// coefficient planes in its slice of a.cf, the annual sums in a.asum
// (K2; K3 at (m, y)) from 0 at each year's first step, K3's monthly means
// at (m, y*nmon + month) from 0 at each month's first step.  WIDE (the
// sequential form only): the run spans g.groups clusters, this block's
// rows and member follow its cluster's place in them, and the step start
// and each substep end at wide_exchange after their cluster.sync().
template <int KIND, bool MEMBERS, int FORM, bool LEGACY, bool WIDE = false>
__device__ void run_refined(const YearArgs& a, const RefinedArgs& g,
                            const GrebParams& p, const PackCols& cols) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // WIDE: G clusters a run, this cluster the run's grp-th
  const int G = WIDE ? g.groups : 1;
  const int grp = WIDE ? (int)(blockIdx.x / C) % G : 0;
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int R = Y / (C * G), RX = R * X, r0 = (grp * C + rank) * R;
  const int ktc = a.ktc, kbc = a.kbc, K = ktc + kbc;
  constexpr bool SADD = FORM == R_STRICT_ADDITIVE;
  constexpr bool STRICT = FORM == R_STRICT || SADD;
  static_assert(!WIDE || FORM == R_SEQ || FORM == R_STRICT,
                "the wide form is sequential");
  long long parts[N_QPARTS];
  if constexpr (STRICT)
    strict_refined_parts(Y, X, C * G, parts, SADD,
                         WIDE ? MAX_CLUSTER * MAX_GROUPS : MAX_CLUSTER);
  else if constexpr (WIDE)
    refined_parts(Y, X, ktc, kbc, C * G, g, parts, MAX_CLUSTER * MAX_GROUPS);
  else
    refined_parts(Y, X, ktc, kbc, C, g, parts);
  float* sp[N_QPARTS];
  sp[0] = smem;
  for (int k = 1; k < N_QPARTS; ++k)
    sp[k] = sp[k - 1] + parts[k - 1] / sizeof(float);
  Bufs bufs{sp[Q_XBUF], nullptr, nullptr, R, X};
  const int BX = bufs.field(), NXT = 2 * BX;
  int dkt, dkb, akt, akb;
  seg_reach(g.dseg, g.n_dseg, &dkt, &dkb);
  seg_reach(g.aseg, g.n_aseg, &akt, &akb);
  int* zpre = reinterpret_cast<int*>(sp[Q_INDEX]);
  const RefinedBlock bk{
      RowSlots(r0, R, 0, ktc, Y - kbc, Y),
      RowSlots(r0, R, ktc, ktc + dkt, Y - kbc - dkb, Y - kbc),
      RowSlots(r0, R, 0, akt, Y - akb, Y),
      zpre, sp[Q_WZ], sp[Q_XA], sp[Q_SCRATCH]};
  // additive: the rows that the segments or composites finish, the nested
  // rows from each pole that any of them reaches
  const RowSlots later(r0, R, 0, ktc + dkt > akt ? ktc + dkt : akt,
                       Y - (kbc + dkb > akb ? kbc + dkb : akb), Y);
  float* wz = sp[Q_WZ];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Div by_rx(RX), by_x(X);
  // member m's slice: field k of its state at k * FS, its coefficient
  // scratch, and step t of its corrections at corr_m + t * corr_step
  const int m = MEMBERS ? member_index() / G : 0;
  const size_t FS = MEMBERS ? (size_t)a.M * YX : (size_t)YX;
  const size_t m0 = MEMBERS ? (size_t)m * YX : 0;
  float* st = a.state_out + m0 + (size_t)r0 * X;
  const float* st_in = a.state_in + m0 + (size_t)r0 * X;
  float* const cfm = a.cf + (MEMBERS ? (size_t)m * 12 * P : 0);
  const size_t corr_m =
      MEMBERS ? (size_t)(KIND == SCEN_YEARS && a.corr_shared ? 0 : m) * a.T *
                    a.corr_step
              : 0;
  float* const tf_m = a.tf + corr_m;
  float* const tof_m = a.tof + corr_m;
  float* const qf_m = a.qf + corr_m;
  // the member's physics, written by one thread before the first
  // cluster.sync(); K3 sets each year's CO2 there
  GrebParams* pm = nullptr;
  if constexpr (MEMBERS) {
    __shared__ GrebParams s_pm;
    pm = &s_pm;
    if (tid == 0) s_pm = member_params(p, a, cols, m);
  }
  const GrebParams& pt = MEMBERS ? *pm : p;
  // the fold moves Ta and q; the strict form the fields of the flags word
  // (nf), or none under CIRCULATION_OFF (whose launch has no stencil
  // constants)
  const bool circ = !STRICT || !on<true>(p, CIRCULATION_OFF);
  const int nf = STRICT && on<true>(p, VAPOR_CIRCULATION_OFF) ? 1 : 2;

  for (int i = tid; i < 5 * RX; i += nt) {
    const int k = i / RX;
    st[k * FS + (i - k * RX)] = st_in[k * FS + (i - k * RX)];
  }
  StrictSeq ss;
  StrictAdd sa;
  if constexpr (STRICT) {
    if (circ) {
      // wz of Ta and q with HALO rows each side, zero past the poles, and
      // the rows' constants (ops/stencils.py), the rows in order of each
      // count (the sub-cycle rounds take a prefix)
      const int WX = (R + 2 * HALO) * X;
      for (int i = tid; i < 2 * WX; i += nt) {
        const int f = i / WX, h = i - f * WX, r = r0 - HALO + h / X;
        wz[i] = r >= 0 && r < Y ? a.st_wz[(size_t)f * YX + r * X + h % X]
                                : 0.f;
      }
      float* rc = sp[Q_INDEX];
      int* rn = reinterpret_cast<int*>(rc + 2 * R);
      for (int i = tid; i < R; i += nt) {
        const float* rows = a.st_rows + r0 + i;   // (4, Y), this row
        rc[i] = (a.st_kappa * rows[Y]) / rows[0];
        rc[R + i] = rows[2 * Y];
        rn[i] = a.st_n[r0 + i];
        rn[R + i] = a.st_n[Y + r0 + i];
        if constexpr (SADD) {   // after the counts and the orders
          rc[6 * R + i] = a.st_kdt / rows[0];
          rc[7 * R + i] = rows[3 * Y];
        }
      }
      __syncthreads();
      if (tid < 2) {   // insertion sort by count, most first; stable
        const int* cnt = rn + tid * R;
        int* ord = rn + (2 + tid) * R;
        for (int i = 0; i < R; ++i) {
          int k = i;
          for (; k > 0 && cnt[ord[k - 1]] < cnt[i]; --k) ord[k] = ord[k - 1];
          ord[k] = i;
        }
      }
      ss = StrictSeq{wz, rc, rc + R, rn, rn + R, rn + 2 * R, rn + 3 * R,
                     sp[Q_SCRATCH], a.st_ccy_d, a.st_ccy_a, nf,
                     on<true>(p, VAPOR_DIFFUSION_ONLY) ? 1 : nf,
                     a.quirk != 0};
      if constexpr (SADD) sa = StrictAdd{ss, rc + 6 * R, rc + 7 * R};
    }
  } else {
    for (int i = tid; i < 2 * RX; i += nt)
      wz[i] = a.wz[(size_t)(i / RX) * YX + r0 * X + i % RX];
  }
  // halo rows start at zero: those past the poles stay so
  for (int i = tid; i < 2 * 2 * 2 * HALO * X; i += nt) {
    const int fb = i / (2 * HALO * X);          // buffer*2 + field
    const int h = i - fb * 2 * HALO * X;
    const int row = h < HALO * X ? h / X : R + h / X;
    bufs.mine[fb * BX + row * X + h % X] = 0.f;
  }
  // R_STRICT: the spread sub-cycle's mbarriers, before the first
  // cluster.sync() (which any remote arrival follows) and its slot epochs
  int spread_sc = 0;
  if constexpr (FORM == R_STRICT) {
    if (tid == 0) {
      mbar_init(spread_bar);
      mbar_init(spread_bar + 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  if ((FORM == R_SEQ || FORM == R_ADDITIVE_PACKED) && tid == 0) {
    // the packed composites' slots
    const int nq = bk.comp.n();
    int acc = 0;
    for (int fq = 0; fq < 2 * nq; ++fq) {
      zpre[fq] = acc;
      const int f = fq / nq, r = r0 + bk.comp.row(fq - f * nq);
      acc += g.comp_rank[f * K + comp_k(r, Y, ktc, kbc)];
    }
    zpre[2 * nq] = acc;
  }
  // every block's shared memory is live before any remote write; the
  // state copy is visible to the block (WIDE: no global data crosses a
  // cluster before the first step start's exchange)
  cluster.sync();
  if (rank > 0) bufs.up = cluster.map_shared_rank(bufs.mine, rank - 1);
  if (rank < C - 1) bufs.dn = cluster.map_shared_rank(bufs.mine, rank + 1);
  // WIDE: this block's edges and the exchanges made
  WideEdge we{};
  int ep = 0;
  if constexpr (WIDE)
    we = WideEdge{g.ghalo + (size_t)m * 8 * (G - 1) * HALO * X, G,
                  rank == 0 && grp > 0 ? grp - 1 : -1,
                  rank == C - 1 && grp < G - 1 ? grp : -1};

  const int n_years = KIND == SCEN_YEARS ? a.n_years : 1;
  for (int y = 0; y < n_years; ++y) {
    // K3: this year's CO2 from the table, after the last step's update
    // (its __syncthreads) and seen after the next step start's
    // cluster.sync() (the strict form's, which may have none: after its
    // own __syncthreads())
    if (KIND == SCEN_YEARS && tid == 0) pm->co2 = a.co2_years[y];
    if (KIND == SCEN_YEARS && STRICT) __syncthreads();
    // this year's annual sums: K2's one year, K3's (m, y)
    float* const asum =
        a.asum + (KIND == SCEN_YEARS ? ((size_t)m * n_years + y) * N_SUM * YX
                                     : 0);
    for (int t = 0; t < a.T; ++t) {
      const size_t tyx = (size_t)t * YX;
      int cur = 0;
      if constexpr (STRICT) {
        if (circ) {
          // -- step start: the moving fields into buffer 0, pushed to the
          //    neighbours' halos
          for (int l = tid; l < nf * RX; l += nt) {
            const int f = by_rx(l), li = l - f * RX;
            const int i = by_x(li), j = li - i * X;
            bufs.put(0, f, i, j, st[(f == 0 ? 1 : 3) * FS + li]);
          }
          cluster.sync();
          if constexpr (WIDE)
            wide_exchange(we, bufs, 0, ep++ & 1);
          // -- circulation: nsub strict substeps, buffer cur -> nxt
          for (int s = 0; s < a.nsub; ++s) {
            const int nxt = NXT - cur;
            if constexpr (SADD)
              strict_add_substep(a, sa, bufs, cur, nxt, r0, t);
            else
              strict_seq_substep<true>(a, ss, bufs, cur, nxt, r0, t, &g,
                                       &spread_sc);
            cluster.sync();
            if constexpr (WIDE)
              wide_exchange(we, bufs, nxt, ep++ & 1);
            cur = nxt;
          }
        }
      } else {
        // -- step start: (Ta, q) into buffer 0, pushed to the neighbours'
        //    halos, and this step's coefficients into the global scratch
        for (int l = tid; l < 2 * RX; l += nt) {
          const int f = by_rx(l), li = l - f * RX;
          const int i = by_x(li), j = li - i * X;
          const size_t c = (size_t)f * YX + (size_t)r0 * X + li;
          bufs.put(0, f, i, j, st[(f == 0 ? 1 : 3) * FS + li]);
          step_coeffs(a.zam + c, a.mer + c, P, a.u[tyx + r0 * X + li],
                      a.v[tyx + r0 * X + li], cfm + c, P);
        }
        cluster.sync();
        if constexpr (WIDE)
          wide_exchange(we, bufs, 0, ep++ & 1);
        // -- circulation: nsub substeps, buffer cur -> nxt
        for (int s = 0; s < a.nsub; ++s) {
          const int nxt = NXT - cur;
          if constexpr (FORM == R_ADDITIVE)
            additive_substep<MEMBERS>(a, g, bk, later, bufs, cur, nxt, r0);
          else if constexpr (FORM == R_ADDITIVE_PACKED)
            additive_substep<MEMBERS, true>(a, g, bk, later, bufs, cur, nxt,
                                            r0);
          else
            refined_substep<MEMBERS, WIDE>(a, g, bk, bufs, cur, nxt, r0);
          // every block's rows and halos of buffer nxt are written, and no
          // block reads buffer cur any more
          cluster.sync();
          if constexpr (WIDE)
            wide_exchange(we, bufs, nxt, ep++ & 1);
          cur = nxt;
        }
      }
      // K3: this step's month slot, set at the month's first step
      float* mon = nullptr;
      bool mstart = false;
      float w = 0.f;
      if (KIND == SCEN_YEARS) {
        const int mo = a.mon[t];
        mstart = t == 0 || a.mon[t - 1] != mo;
        w = a.mon_w[t];
        mon = a.monthly +
              (((size_t)m * n_years + y) * a.nmon + mo) * N_OUT * YX;
      }
      // -- pointwise physics and the state update of this block's cells
      const float* xc = bufs.mine + cur + HALO * X;   // circulated, row 0
      for (int li = tid; li < RX; li += nt) {
        const int pix = r0 * X + li;
        float s[5];
        for (int k = 0; k < 5; ++k) s[k] = st[k * FS + li];
        float vals[N_SUM];
        update_cell<KIND, LEGACY>(a, pt, t, pix, s, circ ? xc[li] : s[1],
                                  circ && nf == 2 ? xc[BX + li] : s[3], tf_m,
                                  tof_m, qf_m, (size_t)t * a.corr_step + pix,
                                  vals);
        if (KIND == SCEN) {
          float* out = a.outs + tyx * N_OUT + pix;
          for (int k = 0; k < N_OUT; ++k) out[(size_t)k * YX] = vals[k];
        }
        if (KIND != FLUX) {
          // annual sums in sequence, from 0 at the year's first step
          for (int k = 0; k < N_SUM; ++k) {
            float* sum = asum + (size_t)k * YX + pix;
            *sum = (t == 0 ? 0.f : *sum) + vals[k];
          }
        }
        if (KIND == SCEN_YEARS) {
          // monthly means: w * fields in sequence, from 0 at the month's
          // first step
          for (int k = 0; k < N_OUT; ++k) {
            float* mean = mon + (size_t)k * YX + pix;
            *mean = (mstart ? 0.f : *mean) + w * vals[k];
          }
        }
        for (int k = 0; k < 5; ++k) st[k * FS + li] = s[k];
      }
      __syncthreads();
    }
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

// The entry functions and their launchers follow.  What comes before the
// guard below serves them and the sources that build their own entries on
// these device functions (slab_kernel.cu; refined_kernel.cu, the refined
// instantiation's entries; band_kernel.cu, the refined forms of the grids
// between 192x96 and 384x192; strict_wide_kernel.cu, the strict form's
// wide variant at 768x384; members_kernel.cu, the member kernels' matmul
// circulation), which define GREB_DEVICE_ONLY before including this file.

// The refined instantiation of the four kernels: in each form and variant,
// <kernel><suffix> runs run_refined<kind, members, form, legacy>.
#define REFINED_KERNELS(SUFFIX, FORM, LEGACY, WIDE)                          \
  __global__ void __launch_bounds__(NT, 1) fluxcorr_year##SUFFIX(            \
      YearArgs a, GrebParams p, RefinedArgs g) {                             \
    run_refined<FLUX, false, FORM, LEGACY, WIDE>(a, g, p, PackCols{});       \
  }                                                                          \
  __global__ void __launch_bounds__(NT, 1) scenario_year##SUFFIX(            \
      YearArgs a, GrebParams p, RefinedArgs g) {                             \
    run_refined<SCEN, false, FORM, LEGACY, WIDE>(a, g, p, PackCols{});       \
  }                                                                          \
  __global__ void __launch_bounds__(NT, 1) fluxcorr_years##SUFFIX(           \
      YearArgs a, GrebParams p, PackCols c, RefinedArgs g) {                 \
    run_refined<FLUX, true, FORM, LEGACY, WIDE>(a, g, p, c);                 \
  }                                                                          \
  __global__ void __launch_bounds__(NT, 1) scenario_years##SUFFIX(           \
      YearArgs a, GrebParams p, PackCols c, RefinedArgs g) {                 \
    run_refined<SCEN_YEARS, true, FORM, LEGACY, WIDE>(a, g, p, c);           \
  }

// The instantiations a flags word launches (variant).
enum Variant { V_MODERN, V_LEGACY, V_STRICT, V_NONE };

// V_MODERN at flags 0; V_STRICT for the strict transport or none
// (CIRCULATION_OFF); V_LEGACY for any other word; V_NONE for a word
// with a bit not in Flag, a vapour bit without STRICT_TRANSPORT, or the
// strict transport with CIRCULATION_OFF.
static inline Variant variant(const GrebParams& p) {
  const int f = p.flags;
  const bool strict = (f & STRICT_TRANSPORT) != 0;
  const bool off = (f & CIRCULATION_OFF) != 0;
  if ((f & ~KNOWN_FLAGS) != 0 || (strict && off)
      || (!strict && (f & (VAPOR_CIRCULATION_OFF | VAPOR_DIFFUSION_ONLY))))
    return V_NONE;
  if (strict || off) return V_STRICT;
  return f ? V_LEGACY : V_MODERN;
}

// The launch of a.M clusters of C blocks of `kernel` with `smem` bytes of
// dynamic shared memory a block into cfg (attrs: room for 2), and how many
// such clusters the card runs at once (cluster_config, refined_config).
// G clusters a member is the wide form: a cooperative launch, for its
// grid barrier.
template <typename Kernel>
static int config_with(Kernel kernel, const YearArgs& a, int C,
                       long long smem, void* stream,
                       cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                       int* clusters, int G = 1) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(a.M * C * G, 1, 1);
  cfg->blockDim = dim3(cluster_threads(a.Y / (C * G), a.X), 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (G > 1) {
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg->numAttrs = 2;
  }
  *clusters = 0;
  e = cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters == 0 ? GREB_ERR_NO_CLUSTER : 0;
}

// The refined instantiation's launch (a.M members) as cluster_config's.
template <typename Kernel>
static int refined_config(Kernel kernel, const YearArgs& a,
                          const RefinedArgs& g, int C, void* stream,
                          cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                          int* clusters) {
  long long parts[N_QPARTS];
  const long long smem = form_parts(a.Y, a.X, a.ktc, a.kbc, C, g, parts);
  if (smem == 0 || smem > MAX_SMEM || a.M < 1) return GREB_ERR_LAYOUT;
  return config_with(kernel, a, C, smem, stream, attr, cfg, clusters,
                     g.groups > 1 ? g.groups : 1);
}

#ifndef GREB_DEVICE_ONLY

// Each kernel in three instantiations: the modern variant (flags 0); with
// the suffix _legacy, the fold with the switches of the flags word; with
// the suffix _strict, the strict transport or none, with the switches.
// The refined instantiation's entries build in refined_kernel.cu.
__global__ void __launch_bounds__(NT, 1) fluxcorr_year(YearArgs a, GrebParams p) {
  run_cluster<FLUX, false, false>(a, p);
}

__global__ void __launch_bounds__(NT, 1) scenario_year(YearArgs a, GrebParams p) {
  run_cluster<SCEN, false, false>(a, p);
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_years(YearArgs a, GrebParams p,
                                                        PackCols c) {
  run_cluster<FLUX, false, false>(a, member_params(p, a, c, member_index()));
}

__global__ void __launch_bounds__(NT, 1) scenario_years(YearArgs a, GrebParams p,
                                                        PackCols c) {
  run_cluster<SCEN_YEARS, false, false>(a, member_params(p, a, c,
                                                         member_index()));
}

__global__ void __launch_bounds__(NT, 1) scenario_years_block(
    YearArgs a, GrebParams p, PackCols c) {
  run_years<false>(a, member_params(p, a, c, blockIdx.x));
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_year_legacy(YearArgs a,
                                                              GrebParams p) {
  run_cluster<FLUX, true, false>(a, p);
}

__global__ void __launch_bounds__(NT, 1) scenario_year_legacy(YearArgs a,
                                                              GrebParams p) {
  run_cluster<SCEN, true, false>(a, p);
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_years_legacy(
    YearArgs a, GrebParams p, PackCols c) {
  run_cluster<FLUX, true, false>(a, member_params(p, a, c, member_index()));
}

__global__ void __launch_bounds__(NT, 1) scenario_years_legacy(
    YearArgs a, GrebParams p, PackCols c) {
  run_cluster<SCEN_YEARS, true, false>(a, member_params(p, a, c,
                                                        member_index()));
}

__global__ void __launch_bounds__(NT, 1) scenario_years_block_legacy(
    YearArgs a, GrebParams p, PackCols c) {
  run_years<true>(a, member_params(p, a, c, blockIdx.x));
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_year_strict(YearArgs a,
                                                              GrebParams p) {
  run_cluster<FLUX, true, true>(a, p);
}

__global__ void __launch_bounds__(NT, 1) scenario_year_strict(YearArgs a,
                                                              GrebParams p) {
  run_cluster<SCEN, true, true>(a, p);
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_years_strict(
    YearArgs a, GrebParams p, PackCols c) {
  run_cluster<FLUX, true, true>(a, member_params(p, a, c, member_index()));
}

__global__ void __launch_bounds__(NT, 1) scenario_years_strict(
    YearArgs a, GrebParams p, PackCols c) {
  run_cluster<SCEN_YEARS, true, true>(a, member_params(p, a, c,
                                                       member_index()));
}

// One block of NT threads per member (a.M blocks).
template <typename Kernel, typename... Extra>
static int launch(Kernel kernel, const YearArgs& a, void* stream,
                  const GrebParams& p, Extra... extra) {
  const size_t smem = smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.M, NT, smem, (cudaStream_t)stream>>>(a, p, extra...);
  return (int)cudaGetLastError();
}

// The launch of a.M clusters of C blocks of `kernel` (of `kind`; `strict`:
// a strict instantiation), one member a cluster, into cfg (whose attrs
// point at attr), and how many such clusters the card runs at once;
// GREB_ERR_NO_CLUSTER where none.
template <typename Kernel>
static int cluster_config(Kernel kernel, const YearArgs& a, int C, int kind,
                          bool strict, void* stream,
                          cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                          int* clusters) {
  long long parts[N_PARTS];
  const long long smem = cluster_parts(a.Y, a.X, a.ktc, a.kbc, C, kind,
                                       strict, parts);
  if (smem == 0 || smem > MAX_SMEM || a.M < 1) return GREB_ERR_LAYOUT;
  return config_with(kernel, a, C, smem, stream, attr, cfg, clusters);
}

// a.M members on a.M clusters of C blocks; raises (returns
// GREB_ERR_NO_CLUSTER) where the card cannot schedule such a cluster, and
// takes no other C.  Clusters beyond the card's capacity run in waves.
template <typename Kernel, typename... Extra>
static int launch_cluster(Kernel kernel, const YearArgs& a,
                          const GrebParams& p, int C, int kind, bool strict,
                          void* stream, Extra... extra) {
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int clusters;
  const int err = cluster_config(kernel, a, C, kind, strict, stream, attr,
                                 &cfg, &clusters);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, p, extra...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// Each launcher runs the instantiation of the word's variant and refuses
// (GREB_ERR_FLAGS) a word that has none.
int greb_fluxcorr_year(YearArgs a, GrebParams p, int C, void* stream) {
  switch (variant(p)) {
    case V_MODERN:
      return launch_cluster(fluxcorr_year, a, p, C, FLUX, false, stream);
    case V_LEGACY:
      return launch_cluster(fluxcorr_year_legacy, a, p, C, FLUX, false,
                            stream);
    case V_STRICT:
      return launch_cluster(fluxcorr_year_strict, a, p, C, FLUX, true,
                            stream);
    default:
      return GREB_ERR_FLAGS;
  }
}

int greb_scenario_year(YearArgs a, GrebParams p, int C, void* stream) {
  switch (variant(p)) {
    case V_MODERN:
      return launch_cluster(scenario_year, a, p, C, SCEN, false, stream);
    case V_LEGACY:
      return launch_cluster(scenario_year_legacy, a, p, C, SCEN, false,
                            stream);
    case V_STRICT:
      return launch_cluster(scenario_year_strict, a, p, C, SCEN, true,
                            stream);
    default:
      return GREB_ERR_FLAGS;
  }
}

int greb_fluxcorr_years(YearArgs a, GrebParams p, PackCols c, int C,
                        void* stream) {
  switch (variant(p)) {
    case V_MODERN:
      return launch_cluster(fluxcorr_years, a, p, C, FLUX, false, stream, c);
    case V_LEGACY:
      return launch_cluster(fluxcorr_years_legacy, a, p, C, FLUX, false,
                            stream, c);
    case V_STRICT:
      return launch_cluster(fluxcorr_years_strict, a, p, C, FLUX, true,
                            stream, c);
    default:
      return GREB_ERR_FLAGS;
  }
}

// C = 1: the one-block body, one block per member; it moves Ta and q with
// the fold or not at all, and refuses the strict transport
int greb_scenario_years(YearArgs a, GrebParams p, PackCols c, int C,
                        void* stream) {
  const Variant v = variant(p);
  if (C == 1) {
    if (v == V_NONE || (p.flags & STRICT_TRANSPORT)) return GREB_ERR_FLAGS;
    return p.flags ? launch(scenario_years_block_legacy, a, stream, p, c)
                   : launch(scenario_years_block, a, stream, p, c);
  }
  switch (v) {
    case V_MODERN:
      return launch_cluster(scenario_years, a, p, C, SCEN_YEARS, false,
                            stream, c);
    case V_LEGACY:
      return launch_cluster(scenario_years_legacy, a, p, C, SCEN_YEARS,
                            false, stream, c);
    case V_STRICT:
      return launch_cluster(scenario_years_strict, a, p, C, SCEN_YEARS, true,
                            stream, c);
    default:
      return GREB_ERR_FLAGS;
  }
}

// The kernel's own reckoning of a cluster block's shared memory (`strict`:
// the strict instantiation's): fills parts[N_PARTS] (bytes, layout order),
// returns the total (0: no layout).
long long greb_cluster_layout(int Y, int X, int ktc, int kbc, int C,
                              int kind, int strict, long long* parts) {
  return cluster_parts(Y, X, ktc, kbc, C, kind, strict != 0, parts);
}

// How many clusters of C blocks of the member kernel of `kind` (FLUX:
// fluxcorr_years, SCEN: scenario_year, SCEN_YEARS: scenario_years; `strict`:
// its strict instantiation) the card runs at once, into *clusters; returns
// an error code as the launchers do.
int greb_cluster_capacity(int Y, int X, int ktc, int kbc, int C, int kind,
                          int strict, int* clusters) {
  YearArgs a = {};
  a.Y = Y; a.X = X; a.ktc = ktc; a.kbc = kbc; a.M = 1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  const bool st = strict != 0;
  if (kind == FLUX)
    return st ? cluster_config(fluxcorr_years_strict, a, C, kind, st, nullptr,
                               attr, &cfg, clusters)
              : cluster_config(fluxcorr_years, a, C, kind, st, nullptr, attr,
                               &cfg, clusters);
  if (kind == SCEN)
    return st ? cluster_config(scenario_year_strict, a, C, kind, st, nullptr,
                               attr, &cfg, clusters)
              : cluster_config(scenario_year, a, C, kind, st, nullptr, attr,
                               &cfg, clusters);
  return st ? cluster_config(scenario_years_strict, a, C, kind, st, nullptr,
                             attr, &cfg, clusters)
            : cluster_config(scenario_years, a, C, kind, st, nullptr, attr,
                             &cfg, clusters);
}

int greb_cluster_threads(int Y, int X, int C) {
  return cluster_threads(Y / C, X);
}

const char* greb_error_string(int err) {
  if (err == GREB_ERR_LAYOUT)
    return "no cluster layout: C does not split the latitude rows into "
           "blocks of at least 2 rows, or a block's shared memory exceeds "
           "227 KB (refined: or a row is not whole composite blocks, or a "
           "segment table is too long)";
  if (err == GREB_ERR_NO_CLUSTER)
    return "cudaOccupancyMaxActiveClusters is 0: the card cannot schedule "
           "a cluster of this size with this shared memory";
  if (err == GREB_ERR_FLAGS)
    return "the flags word has a bit the kernels do not know, or a "
           "combination no instantiation runs";
  if (err == GREB_ERR_RESIDENT)
    return "the wide form's clusters are not all resident at once: its "
           "grid barrier would never end";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // GREB_DEVICE_ONLY
