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
//                     outputs.
// All four run one shared __device__ step body: the pointwise physics
// (ops/pointwise.py), the fold's per-step coefficients
// (ops/fastcirc2.py step_coeffs) and nsub circulation substeps
// (fastcirc2.substep): the 7-point zonal diffusion, the band clamp, the
// dense pole composite rows, the 7-point zonal advection, the band clamp,
// the merged 5-point meridional step and the combine.
//
// Design.  The TPU kernel's sequential grid axis (one grid step per model
// step, state resident in VMEM) becomes a loop inside one thread block per
// member (blockIdx.x; one block for the single-run kernels): the
// 5-field state (90 KiB at 96x48) and a double buffer of the two transported
// fields (2 x 36 KiB) stay in dynamic shared memory for the whole year.  The
// fold's constant planes, each step's forcing slice and the per-step
// coefficient scratch are read from global memory / L2.  __syncthreads()
// separates the phases of a substep whose cells read cells other threads
// wrote.  Each thread owns fixed cells, so the coefficient scratch, the
// monthly means and the annual sums are thread-private and need no barrier.
// Each member has its own slice of every buffer the kernel writes (state,
// coefficient scratch, corrections, monthly means, sums), so the blocks of
// a member-batched launch never share a written address.  The monthly
// means and annual sums are read-modified-written in global memory every
// step: with the state they would need 262 KB of shared memory, over a
// block's 227 KB.
//
// What bounds it.  One block runs on one of the card's 132 SMs.  A substep
// rereads about 20 coefficient planes x 2 fields x 4608 cells x 4 B
// (~0.74 MB) plus the four 96x96 composite matrices (~0.15 MB) from L2, and
// does ~0.44 MFLOP.  Per substep that is a few microseconds of one SM's L2
// bandwidth against ~1 us of its float32 rate, so the kernel is bound by
// one SM's L2 bandwidth and uses 1/132 of the card.  The whole-card bound
// (PERF.md) is far lower; spreading a year over many SMs is later work.
//
// Numerics.  Built without --use_fast_math and with --fmad=false, so every
// float32 operation rounds as in the plain PyTorch version and in the JAX
// package: expf/logf/sqrtf, ts**4 as (t*t)*(t*t), the same association of
// every sum (the 7-point sums as the JAX balanced tree), true division.
// The composite row sums follow the plain version's blocked order
// (fastcirc2._row_dot), which differs from the JAX package's library dot.

#include <cuda_runtime.h>

#define NT 1024
#define COMP_BLOCK 8   // = fastcirc2.COMP_BLOCK
#define N_SUM 9        // annual sums: the 9 StepOutputs fields
#define N_OUT 5        // written fields: ts, ta, to, q, albedo

struct GrebParams {
  float sig, rho_air, ct_sens, da_ice, a_no_ice, a_cloud;
  float Tl_ice1, Tl_ice2, To_ice1, To_ice2;
  float co_turb, ce, cq_latent, cq_rain, r_qviwv, c_effmix;
  float p_emi[10];
  float cap_ocean, cap_land, cap_air;
  float dt;    // model step [s]
  float co2;   // this year's CO2 [ppm]
};

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
  // correction tables: step t of member m at (m*T + t)*corr_step; read by
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
  float *cf;              // scratch (M, 12, 2, Y, X): za 7, mc 4, c0m 1
  int Y, X, T, nsub, bt, bb, ktc, kbc;
  int M, n_years, nmon, corr_step, n_pack;
};

// Columns of the member pack (multiyear.pack_member_params) that hold each
// GrebParams field; p_emi is 10 consecutive columns.
struct PackCols {
  int sig, rho_air, ct_sens, da_ice, a_no_ice, a_cloud;
  int Tl_ice1, Tl_ice2, To_ice1, To_ice2;
  int co_turb, ce, cq_latent, cq_rain, r_qviwv, c_effmix;
  int p_emi, cap_ocean, cap_land, cap_air;
};

static size_t smem_bytes(const YearArgs& a) {
  const size_t yx = (size_t)a.Y * a.X;
  const size_t kx = (size_t)(a.ktc + a.kbc) * a.X;
  return sizeof(float) * (5 * yx + 4 * yx + 6 * kx);
}

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
// src/greb.f90:277-308, 367-525).
__device__ Tend tendencies(const GrebParams& p, float ts, float ta, float to,
                           float q, float tclim, float swet, float u, float v,
                           float mld, float mld_prev, float cld, float swsol,
                           float z_topo, float glacier, float wz_air,
                           float z_ocean) {
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
  o.albedo = (a_surf + a_atmos) - a_surf * a_atmos;
  o.sw = swsol * (1.f - o.albedo);

  // longwave (src/greb.f90:407-434)
  const float* pe = p.p_emi;
  const float e_co2 = wz_air * p.co2;
  const float e_vapor = (wz_air * p.r_qviwv) * q;
  const float a0 = pe[0] * e_co2;
  const float a1 = pe[1] * e_vapor;
  float em = pe[3] * logf((a0 + a1) + pe[2]) + pe[6];
  em = em + pe[4] * logf(a0 + pe[2]);
  em = em + pe[5] * logf(a1 + pe[2]);
  em = ((pe[7] - cld) / pe[8]) * (em - pe[9]) + pe[9];
  o.em = em;
  const float dtrad = -0.16f * tclim - 5.f;
  o.lw_surf = (-p.sig) * pow4(ts);
  o.lwair = ((-em) * p.sig) * pow4(ta + dtrad);

  // sensible heat (src/greb.f90:295)
  o.q_sens = p.ct_sens * (ta - ts);

  // hydrology (src/greb.f90:438-469)
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

  // deep ocean (src/greb.f90:495-525)
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

// Sea-ice heat capacity (src/greb.f90:472-492).
__device__ __forceinline__ float seaice(const GrebParams& p, float ts0,
                                        float cap_prev, float mld,
                                        float z_topo, float glacier) {
  const float cap_open = p.cap_ocean * mld;
  const float ramp = p.cap_land + ((cap_open - p.cap_land) / (p.To_ice2 - p.To_ice1))
                     * (ts0 - p.To_ice1);
  const float oc = ts0 <= p.To_ice1 ? p.cap_land : (ts0 >= p.To_ice2 ? cap_open : ramp);
  const float cap = z_topo < 0.f ? oc : cap_prev;
  return glacier > 0.5f ? p.cap_land : cap;
}

// One circulation substep of both transported fields, xa -> xb
// (fastcirc2.substep, comp_mode "dense", no explicit segments).
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
    const float* row = xf + r * X;
    const float x0 = row[j];
    const float xm3 = row[j >= 3 ? j - 3 : j - 3 + X];
    const float xm2 = row[j >= 2 ? j - 2 : j - 2 + X];
    const float xm1 = row[j >= 1 ? j - 1 : j - 1 + X];
    const float xp1 = row[j + 1 < X ? j + 1 : j + 1 - X];
    const float xp2 = row[j + 2 < X ? j + 2 : j + 2 - X];
    const float xp3 = row[j + 3 < X ? j + 3 : j + 3 - X];
    const bool band = r < a.bt || r >= Y - a.bb;

    // zonal diffusion, clamped on the band rows
    const float* zd = a.zd + c;
    float dd = tree7(zd[3 * P] * x0, zd[0] * xm3, zd[P] * xm2, zd[2 * P] * xm1,
                     zd[4 * P] * xp1, zd[5 * P] * xp2, zd[6 * P] * xp3);
    if (band) dd = clamp_neg(dd, x0);

    // zonal advection, clamped on the band rows
    const float* cf = cf_m + c;
    float da = tree7(cf[3 * P] * x0, cf[0] * xm3, cf[P] * xm2, cf[2 * P] * xm1,
                     cf[4 * P] * xp1, cf[5 * P] * xp2, cf[6 * P] * xp3);
    if (band) da = clamp_neg(da, x0);

    // merged meridional step; zero halo beyond the poles
    const float km2 = r >= 2 ? xf[(r - 2) * X + j] : 0.f;
    const float km1 = r >= 1 ? xf[(r - 1) * X + j] : 0.f;
    const float kp1 = r + 1 < Y ? xf[(r + 1) * X + j] : 0.f;
    const float kp2 = r + 2 < Y ? xf[(r + 2) * X + j] : 0.f;
    float dy = cf[11 * P] * x0;
    dy = dy + cf[7 * P] * km2;
    dy = dy + cf[8 * P] * km1;
    dy = dy + cf[9 * P] * kp1;
    dy = dy + cf[10 * P] * kp2;

    int k = -1;
    if (r < ktc) k = r;
    else if (r >= Y - kbc) k = ktc + (r - (Y - kbc));
    if (k >= 0) {
      // composite row: finished below, once the whole row's t1 is known
      const int o = (f * K + k) * X + j;
      s_t1[o] = x0 + dd;
      s_da[o] = da;
      s_dy[o] = dy;
    } else {
      xb[c] = ((x0 + a.wz[c] * dd) + da) + dy;
    }
  }
  if (K == 0) return;
  __syncthreads();
  // dense pole composites: t2[j] = sum_i t1[i] * pcomp[f, k, i, j]
  // (fastcirc2._extra_diffusion / _row_dot), clamped once against t2
  for (int o = threadIdx.x; o < 2 * K * X; o += blockDim.x) {
    const int fk = o / X;
    const int j = o - fk * X;
    const int f = fk / K;
    const int k = fk - f * K;
    const int r = k < ktc ? k : Y - kbc + (k - ktc);
    const float* t1row = s_t1 + fk * X;
    const float* pc = a.pcomp + (size_t)fk * X * X + j;
    // summed as fastcirc2._row_dot: in sequence within blocks of
    // COMP_BLOCK consecutive i, then over the blocks in sequence
    float t2 = 0.f;
    for (int b = 0; b < X; b += COMP_BLOCK) {
      float s = t1row[b] * pc[(size_t)b * X];
      for (int i = b + 1; i < b + COMP_BLOCK; ++i)
        s = s + (i < X ? t1row[i] * pc[(size_t)i * X] : 0.f);
      t2 = b == 0 ? s : t2 + s;
    }
    float t1 = t1row[j];
    t1 = t1 + clamp_neg(t2 - t1, t1);
    const int c = f * YX + r * X + j;
    const float x0 = xa[c];
    xb[c] = ((x0 + a.wz[c] * (t1 - x0)) + s_da[o]) + s_dy[o];
  }
}

// The physics of member blockIdx.x: the pack's row, by field name; dt and
// CO2 come from the host's p.
__device__ GrebParams member_params(GrebParams p, const YearArgs& a,
                                    const PackCols& c) {
  const float* r = a.ppack + (size_t)blockIdx.x * a.n_pack;
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

enum Kind { FLUX, SCEN, SCEN_YEARS };

// The years of member m = blockIdx.x: a loop over n_years x T model steps
// in one block.  FLUX is a spin-up year (fluxcorr_year, fluxcorr_years),
// SCEN one scenario year with per-step outputs (scenario_year), SCEN_YEARS
// n_years scenario years with monthly means (scenario_years).
template <int KIND>
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
  const size_t corr_m = (size_t)m * a.T * a.corr_step;
  float* tf_m = a.tf + corr_m;
  float* tof_m = a.tof + corr_m;
  float* qf_m = a.qf + corr_m;

  for (int i = tid; i < 5 * YX; i += nt)
    s_state[i] = state_in[(i / YX) * MYX + i % YX];
  if (KIND == SCEN)
    for (int i = tid; i < N_SUM * YX; i += nt) a.asum[i] = 0.f;
  __syncthreads();

  const int n_years = KIND == SCEN_YEARS ? a.n_years : 1;
  for (int y = 0; y < n_years; ++y) {
    float* asum = a.asum;
    float* mon_y = nullptr;
    if (KIND == SCEN_YEARS) {
      p.co2 = a.co2_years[y];
      const size_t my = (size_t)m * a.n_years + y;
      asum = a.asum + my * N_SUM * YX;
      mon_y = a.monthly + my * a.nmon * N_OUT * YX;
    }
    for (int t = 0; t < a.T; ++t) {
      const size_t tyx = (size_t)t * YX;
      const size_t tc = (size_t)t * a.corr_step;
      // -- step start: copy (Ta, q) and assemble this step's coefficients
      //    (fastcirc2.step_coeffs) into the thread-private scratch
      for (int c = tid; c < P; c += nt) {
        const int f = c / YX;
        const int pix = c - f * YX;
        s_xa[c] = s_state[(f == 0 ? 1 : 3) * YX + pix];
        const float u = a.u[tyx + pix], v = a.v[tyx + pix];
        const float um = u > 0.f ? u : 0.f, up = u < 0.f ? u : 0.f;
        const float vm = v > 0.f ? v : 0.f, vp = v < 0.f ? v : 0.f;
        const float* zam = a.zam + c;
        const float* mer = a.mer + c;
        float* cfc = cf + c;
        cfc[0 * P] = zam[0 * P] * um;
        cfc[1 * P] = zam[1 * P] * um;
        cfc[2 * P] = zam[2 * P] * um;
        cfc[3 * P] = zam[3 * P] * um + zam[4 * P] * up;
        cfc[4 * P] = zam[5 * P] * up;
        cfc[5 * P] = zam[6 * P] * up;
        cfc[6 * P] = zam[7 * P] * up;
        cfc[7 * P] = mer[3 * P] * vm;
        cfc[8 * P] = mer[0 * P] + mer[4 * P] * vm;
        cfc[9 * P] = mer[1 * P] + mer[5 * P] * vp;
        cfc[10 * P] = mer[6 * P] * vp;
        cfc[11 * P] = (mer[2 * P] + mer[7 * P] * vm) + mer[8 * P] * vp;
      }
      __syncthreads();

      // -- circulation: nsub substeps, ping-ponging the two buffers
      float* xa = s_xa;
      float* xb = s_xb;
      for (int s = 0; s < a.nsub; ++s) {
        substep(a, cf, xa, xb, s_t1, s_da, s_dy);
        __syncthreads();
        float* tmp = xa; xa = xb; xb = tmp;
      }

      // this step's month slot (SCEN_YEARS), zeroed at the month's first step
      int mo = 0;
      bool mstart = false;
      float w = 0.f;
      if (KIND == SCEN_YEARS) {
        mo = a.mon[t];
        mstart = t == 0 || a.mon[t - 1] != mo;
        w = a.mon_w[t];
      }

      // -- pointwise physics and the state update of every cell
      for (int pix = tid; pix < YX; pix += nt) {
        const int r = pix / X;
        const size_t tp = tyx + pix;
        const float ts = s_state[pix], ta = s_state[YX + pix];
        const float to = s_state[2 * YX + pix], q = s_state[3 * YX + pix];
        const float cap = s_state[4 * YX + pix];
        const float mld = a.mld[tp];
        const float z_topo = a.z_topo[pix], glacier = a.glacier[pix];
        const Tend e = tendencies(p, ts, ta, to, q, a.tclim[tp], a.swet[tp],
                                  a.u[tp], a.v[tp], mld, a.mld_prev[tp],
                                  a.cld[tp], a.sw_solar[(size_t)t * Y + r],
                                  z_topo, glacier, a.wz_air[pix], a.z_ocean[pix]);
        const float dta_crcl = xa[pix] - ta;
        const float dq_crcl = xa[YX + pix] - q;
        const float dt = p.dt;
        const float air = ((e.lwair + e.lwair) - e.em * e.lw_surf + e.q_lat_air) - e.q_sens;
        const size_t cp = tc + pix;
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
          const float vals[N_SUM] = {ts0, ta0, to0, q0, e.albedo, e.sw,
                                     e.lw_surf, e.q_lat, e.q_sens};
          if (KIND == SCEN) {
            float* out = a.outs + (size_t)t * N_OUT * YX + pix;
            for (int k = 0; k < N_OUT; ++k) out[k * YX] = vals[k];
            for (int k = 0; k < N_SUM; ++k)
              asum[k * YX + pix] = asum[k * YX + pix] + vals[k];
          } else {
            // monthly means and annual sums in sequence, from 0 at the
            // month's / year's first step
            float* mp = mon_y + (size_t)mo * N_OUT * YX + pix;
            for (int k = 0; k < N_OUT; ++k)
              mp[k * YX] = (mstart ? 0.f : mp[k * YX]) + w * vals[k];
            for (int k = 0; k < N_SUM; ++k)
              asum[k * YX + pix] = (t == 0 ? 0.f : asum[k * YX + pix]) + vals[k];
          }
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
        s_state[pix] = ts0;
        s_state[YX + pix] = ta0;
        s_state[2 * YX + pix] = to0;
        s_state[3 * YX + pix] = q0;
        s_state[4 * YX + pix] = seaice(p, ts0, cap, mld, z_topo, glacier);
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < 5 * YX; i += nt)
    state_out[(i / YX) * MYX + i % YX] = s_state[i];
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_year(YearArgs a, GrebParams p) {
  run_years<FLUX>(a, p);
}

__global__ void __launch_bounds__(NT, 1) scenario_year(YearArgs a, GrebParams p) {
  run_years<SCEN>(a, p);
}

__global__ void __launch_bounds__(NT, 1) fluxcorr_years(YearArgs a, GrebParams p,
                                                        PackCols c) {
  run_years<FLUX>(a, member_params(p, a, c));
}

__global__ void __launch_bounds__(NT, 1) scenario_years(YearArgs a, GrebParams p,
                                                        PackCols c) {
  run_years<SCEN_YEARS>(a, member_params(p, a, c));
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

extern "C" {

int greb_fluxcorr_year(YearArgs a, GrebParams p, void* stream) {
  return launch(fluxcorr_year, a, stream, p);
}

int greb_scenario_year(YearArgs a, GrebParams p, void* stream) {
  return launch(scenario_year, a, stream, p);
}

int greb_fluxcorr_years(YearArgs a, GrebParams p, PackCols c, void* stream) {
  return launch(fluxcorr_years, a, stream, p, c);
}

int greb_scenario_years(YearArgs a, GrebParams p, PackCols c, void* stream) {
  return launch(scenario_years, a, stream, p, c);
}

const char* greb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
