// The member-batched matmul circulation in the member kernels K3 and K4:
// mb members on one thread-block cluster, in a library of its own.
//
// Replaces, with year_kernel.cu's entries, the member-batched mode of two
// Pallas TPU kernels of greb_tpu/ops/pallas/multiyear.py:
//   fluxcorr_years_mxu  <- build_fluxcorr_years (:253, call :338) with mb
//                          members a kernel instance (:255) and a
//                          fastcirc2.MxuMembers in its fold tuple
//                          (year_kernel.py _fast_pack, :159-206);
//   scenario_years_mxu  <- build_scenario_years (:107, call :227), mb
//                          members a kernel instance (:110, :122, :198).
// Their circulation is greb_tpu/ops/fastcirc2.py mxu_members_circulation
// (:782): each substep one (F*Y, mb, X) @ (F*Y, X, 2X) product of the
// members' rows with the rows' dense zonal diffusion and advection
// matrices (build_mxu :490, adv_matrix :512), at a precision of "bf16_3x"
// (_dot_b :764: hi*hi + hi*lo + lo*hi of bfloat16 parts) or "highest"
// (exact float32); then the band clamps, the dense pole composites, the
// meridional step and the combine, as the cluster body runs them.
//
// The dense matrices are exact densifications: an output column has 7
// non-zero entries of X, the fold's zd (diffusion) or the step's za
// (advection) coefficients, and the other terms of the dense dot are exact
// zeros.  So the row product here is evaluated over the 7 non-zero terms,
// from the coefficient planes a block already holds in shared memory
// (zd; the step's za), and summed in the fold's balanced order (tree7):
// only the order of the float32 sums differs from a dense dot, and the
// plain twin (ops/fastcirc2.py circulation at MxuTwin's precision) sums in
// this order, so the kernel is bitwise equal to it.  At "highest" a term
// is x * m, so the member kernels compute the fold's circulation exactly
// (year_kernel.cu increments); at "bf16_3x" each x and m splits into
// bfloat16 parts (__float2bfloat16_rn rounds to nearest even, as torch's
// .to(torch.bfloat16) does), the three products of two bfloat16 values are
// exact in float32, each product kind sums in tree7's order, and the three
// sums add in _dot_b's order, (hh + hl) + lh.  The composite rows stay
// exact float32 in the blocked order (comp_partial), as greb_tpu's member
// form keeps them at HIGHEST.  A dense product on tensor cores would do
// X / 7 times these multiply-adds (ROADMAP Queue 2 item 2b).
//
// What the batch shares: a block of a 16-block cluster owns R = Y / 16
// latitude rows of all mb members (run_members below, a 96x48 block 3
// rows), and holds once, for all of them, what does not depend on the
// member: the step's 12 coefficient planes, the 7 zd planes, wz and the
// composite matrices of a pole row it holds; a thread owns one (field,
// cell) and loads its 20 coefficients (and at bf16_3x splits them) once a
// substep for all mb members.  Each member has its own state, (Ta, q)
// double buffer with +-2 halo rows (pushed to the neighbours through
// distributed shared memory as in run_cluster), annual sums and (K3) the
// month's means, composite rows and partial sums, and its physics
// (member_params) in shared memory (members_parts).  At 96x48 K3 holds mb
// = 2 (208,384 B a block), K4 mb = 4 (232,448 B).  ceil(M / mb) clusters
// run, the last with M mod mb members where mb does not divide M, as many
// at once as the card schedules, the rest in waves.
//
// The legacy fold words (log_exp 5, 6, 9, 11, 13-15) run in the _legacy
// entries (update_cell<KIND, true>); the strict transport and no transport
// have no fold and are refused (GREB_ERR_FLAGS).  Built with year_kernel.cu's
// flags (--fmad=false, no fast math); year_kernel.cu's device code is
// included with GREB_DEVICE_ONLY, so its entries compile as they did.

#define GREB_DEVICE_ONLY
#include "year_kernel.cu"

#include <cuda_bf16.h>

#define MEMBER_NT 640     // threads a block at most (launch bounds)
#define MAX_MB 8          // = multiyear.MAX_MB: members a cluster at most

enum MxuPrecision { PREC_HIGHEST = 0, PREC_BF16_3X = 1 };

// Parts of a member block's shared memory, in layout order
// (ops/cuda/multiyear.py MEMBER_PARTS): shared by the batch, then mb of
// each member's.
enum MemberPart { MP_COEFFS, MP_ZD, MP_WZ, MP_PCOMP, MP_PARAMS, MP_STATE,
                  MP_XBUF, MP_ASUM, MP_MONTHLY, MP_COMP_ROWS, MP_COMP_PARTS,
                  N_MPARTS };

// Bytes of each part of a member block for a Y x X grid on C blocks for
// a kernel of `kind` (FLUX or SCEN_YEARS) with mb members, and their
// total; 0 where the cluster body has no layout (cluster_parts) or mb is
// outside 1..MAX_MB.  Every part is a multiple of 16 bytes.
__host__ __device__ inline long long members_parts(int Y, int X, int ktc,
                                                   int kbc, int C, int kind,
                                                   int mb, long long* parts) {
  long long cp[N_PARTS];
  if (mb < 1 || mb > MAX_MB ||
      cluster_parts(Y, X, ktc, kbc, C, kind, false, cp) == 0)
    return 0;
  static_assert(sizeof(GrebParams) % 16 == 0, "GrebParams in 16-byte rows");
  const long long per = sizeof(GrebParams);
  parts[MP_COEFFS] = cp[P_COEFFS];
  parts[MP_ZD] = cp[P_ZD];
  parts[MP_WZ] = cp[P_WZ];
  parts[MP_PCOMP] = cp[P_PCOMP];
  parts[MP_PARAMS] = mb * per;
  parts[MP_STATE] = mb * cp[P_STATE];
  parts[MP_XBUF] = mb * cp[P_XBUF];
  parts[MP_ASUM] = kind == SCEN_YEARS ? mb * cp[P_ASUM] : 0;
  parts[MP_MONTHLY] = mb * cp[P_MONTHLY];
  parts[MP_COMP_ROWS] = mb * cp[P_COMP_ROWS];
  parts[MP_COMP_PARTS] = mb * cp[P_COMP_PARTS];
  long long total = 0;
  for (int k = 0; k < N_MPARTS; ++k) total += parts[k];
  return total;
}

// Threads of a member block: one per (field, cell) of its rows, at most
// MEMBER_NT (a thread loops over its cells' members).
__host__ __device__ inline int members_threads(int R, int X) {
  const int n = (2 * R * X + 31) / 32 * 32;
  return n < MEMBER_NT ? n : MEMBER_NT;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One zonal apply of a member: the 7 terms coef[k] * tap[k] in tree7's
// order [c, m3, m2, m1, p1, p2, p3]; at PREC_BF16_3X with the split
// coefficients ch, cl and the split taps th, tl, (hh + hl) + lh.
template <int PREC>
__device__ __forceinline__ float zonal(const float* c, const float* ch,
                                       const float* cl, const float* t,
                                       const float* th, const float* tl) {
  if constexpr (PREC == PREC_HIGHEST) {
    return tree7(c[0] * t[0], c[1] * t[1], c[2] * t[2], c[3] * t[3],
                 c[4] * t[4], c[5] * t[5], c[6] * t[6]);
  } else {
    const float hh = tree7(th[0] * ch[0], th[1] * ch[1], th[2] * ch[2],
                           th[3] * ch[3], th[4] * ch[4], th[5] * ch[5],
                           th[6] * ch[6]);
    const float hl = tree7(th[0] * cl[0], th[1] * cl[1], th[2] * cl[2],
                           th[3] * cl[3], th[4] * cl[4], th[5] * cl[5],
                           th[6] * cl[6]);
    const float lh = tree7(tl[0] * ch[0], tl[1] * ch[1], tl[2] * ch[2],
                           tl[3] * ch[3], tl[4] * ch[4], tl[5] * ch[5],
                           tl[6] * ch[6]);
    return (hh + hl) + lh;
  }
}

// The years of members [m0, m0 + nm) of cluster blockIdx.x / C, this
// block's rows: FLUX a spin-up year (fluxcorr_years), SCEN_YEARS n_years
// scenario years with monthly means and annual sums (scenario_years), the
// circulation at PREC.  run_cluster's schedule and barriers; each member's
// buffers at its own offset in the same layout in every block.
template <int KIND, bool LEGACY, int PREC>
__device__ void run_members(const YearArgs& a, const GrebParams& host,
                            const PackCols& pc, int mb) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m0 = (int)(blockIdx.x / C) * mb;
  const int nm = a.M - m0 < mb ? a.M - m0 : mb;
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int R = Y / C, RX = R * X, r0 = rank * R;
  const int ktc = a.ktc, kbc = a.kbc, K = ktc + kbc;
  long long parts[N_MPARTS];
  members_parts(Y, X, ktc, kbc, C, KIND, mb, parts);
  const int nb = (X + COMP_BLOCK - 1) / COMP_BLOCK;
  const int kmax = (int)(parts[MP_PCOMP] / (sizeof(float) * 2 * X * X));
  float* sp[N_MPARTS];
  sp[0] = smem;
  for (int k = 1; k < N_MPARTS; ++k)
    sp[k] = sp[k - 1] + parts[k - 1] / sizeof(float);
  float* s_cf = sp[MP_COEFFS];     // (12, 2, R, X)
  float* s_zd = sp[MP_ZD];         // (7, 2, R, X)
  float* s_wz = sp[MP_WZ];         // (2, R, X)
  float* s_pc = sp[MP_PCOMP];      // (2, kmax, X, X)
  GrebParams* s_par = reinterpret_cast<GrebParams*>(sp[MP_PARAMS]);
  // member mm's parts at mm times their per-member size
  const int ST = 5 * RX;                      // state (5, R, X)
  Bufs bufs{sp[MP_XBUF], nullptr, nullptr, R, X};
  const int BX = bufs.field();
  const int NXT = 2 * BX;                     // the second buffer
  const int MB_BUF = 4 * BX;                  // a member's two buffers
  const int CR = 3 * 2 * kmax * X;            // t1, da, dy rows
  const int CP = 2 * kmax * nb * X;           // partial row sums
  float* s_state = sp[MP_STATE];
  float* s_asum = sp[MP_ASUM];                // (9, R, X) a member
  float* s_mon = sp[MP_MONTHLY];              // (5, R, X) a member
  float* s_rows = sp[MP_COMP_ROWS];
  float* s_part = sp[MP_COMP_PARTS];
  const int ntop = comp_rows_in(r0, r0 + R, Y, ktc, 0);
  const int kb = comp_rows_in(r0, r0 + R, Y, ktc, kbc);
  const int bot0 = R - (kb - ntop);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int X4 = X / 4;
  const Div by_rx(RX), by_x(X), by_x4(X4), by_nbx4(nb * X4), by_kb(kb),
      by_st(ST);
  const size_t MYX = (size_t)a.M * YX;

  if (tid < nm) s_par[tid] = member_params(host, a, pc, m0 + tid);
  for (int i = tid; i < nm * ST; i += nt) {
    const int mm = by_st(i), li = i - mm * ST;
    s_state[i] = a.state_in[(size_t)(m0 + mm) * YX + r0 * X +
                            (size_t)(li / RX) * MYX + li % RX];
  }
  for (int i = tid; i < 7 * 2 * RX; i += nt)
    s_zd[i] = a.zd[(size_t)(i / RX) * YX + r0 * X + i % RX];
  for (int i = tid; i < 2 * RX; i += nt)
    s_wz[i] = a.wz[(size_t)(i / RX) * YX + r0 * X + i % RX];
  // halo rows start at zero: those past the poles stay so
  for (int i = tid; i < nm * 4 * 2 * HALO * X; i += nt) {
    const int fb = i / (2 * HALO * X);        // member*4 + buffer*2 + field
    const int h = i - fb * 2 * HALO * X;
    const int row = h < HALO * X ? h / X : R + h / X;
    bufs.mine[fb * BX + row * X + h % X] = 0.f;
  }
  for (int i = tid; i < 2 * kb * X * X; i += nt) {
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

  const int n_years = KIND == SCEN_YEARS ? a.n_years : 1;
  for (int yt = 0; yt < n_years * a.T; ++yt) {
    const int y = yt / a.T, t = yt - y * a.T;
    if (KIND == SCEN_YEARS && t == 0 && tid < nm)
      s_par[tid].co2 = a.co2_years[y];
    const size_t tyx = (size_t)t * YX;
    int cur = 0;
    // -- step start: each member's (Ta, q) into its buffer 0, pushed to
    //    the neighbours' halos, and this step's coefficients, once
    for (int l = tid; l < 2 * RX; l += nt) {
      const int f = by_rx(l), li = l - f * RX;
      const int i = by_x(li), j = li - i * X;
      const int c = f * YX + r0 * X + li;
      for (int mm = 0; mm < nm; ++mm)
        bufs.put(mm * MB_BUF, f, i, j,
                 s_state[mm * ST + (f == 0 ? 1 : 3) * RX + li]);
      step_coeffs(a.zam + c, a.mer + c, P, a.u[tyx + r0 * X + li],
                  a.v[tyx + r0 * X + li], s_cf + l, 2 * RX);
    }
    cluster.sync();

    // -- circulation: nsub substeps, each member's buffer cur -> nxt
    for (int s = 0; s < a.nsub; ++s) {
      const int nxt = NXT - cur;
      for (int l = tid; l < 2 * RX; l += nt) {
        const int f = by_rx(l), li = l - f * RX;
        const int i = by_x(li), j = li - i * X;
        const int r = r0 + i;
        const bool band = r < a.bt || r >= Y - a.bb;
        // the cell's coefficients in tree7's term order, once for the batch
        const int cs = 2 * RX;
        const float* zd = s_zd + l;
        const float* cf = s_cf + l;
        const float cz[7] = {zd[3 * cs], zd[0], zd[cs], zd[2 * cs],
                             zd[4 * cs], zd[5 * cs], zd[6 * cs]};
        const float ca[7] = {cf[3 * cs], cf[0], cf[cs], cf[2 * cs],
                             cf[4 * cs], cf[5 * cs], cf[6 * cs]};
        float zh[7], zl[7], ah[7], al[7];
        if constexpr (PREC == PREC_BF16_3X) {
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            zh[k] = bf16_round(cz[k]);
            zl[k] = bf16_round(cz[k] - zh[k]);
            ah[k] = bf16_round(ca[k]);
            al[k] = bf16_round(ca[k] - ah[k]);
          }
        }
        const float wz = s_wz[l];
        const float mc0 = cf[7 * cs], mc1 = cf[8 * cs], mc2 = cf[9 * cs],
                    mc3 = cf[10 * cs], c0m = cf[11 * cs];
        const int q = i < ntop ? i : (i >= bot0 ? ntop + (i - bot0) : -1);
        for (int mm = 0; mm < nm; ++mm) {
          const float* row = bufs.mine + mm * MB_BUF + cur + f * BX +
                             (i + HALO) * X;
          Taps tp;
          zonal_taps(row, j, X, tp);
          const float tv[7] = {tp.x0, tp.xm3, tp.xm2, tp.xm1,
                               tp.xp1, tp.xp2, tp.xp3};
          float th[7], tl[7];
          if constexpr (PREC == PREC_BF16_3X) {
#pragma unroll
            for (int k = 0; k < 7; ++k) {
              th[k] = bf16_round(tv[k]);
              tl[k] = bf16_round(tv[k] - th[k]);
            }
          }
          float dd = zonal<PREC>(cz, zh, zl, tv, th, tl);
          if (band) dd = clamp_neg(dd, tp.x0);
          float da = zonal<PREC>(ca, ah, al, tv, th, tl);
          if (band) da = clamp_neg(da, tp.x0);
          float dy = c0m * tp.x0;
          dy = dy + mc0 * row[j - 2 * X];
          dy = dy + mc1 * row[j - X];
          dy = dy + mc2 * row[j + X];
          dy = dy + mc3 * row[j + 2 * X];
          if (q >= 0) {
            // composite row: finished below, once the whole row is known
            float* t1 = s_rows + mm * CR;
            const int o = (f * kmax + q) * X + j;
            t1[o] = tp.x0 + dd;
            t1[2 * kmax * X + o] = da;
            t1[4 * kmax * X + o] = dy;
          } else {
            bufs.put(mm * MB_BUF + nxt, f, i, j,
                     combine(tp.x0, wz, dd, da, dy));
          }
        }
      }
      if (kb) {   // block-uniform: only the blocks that hold a pole row
        __syncthreads();
        // each member's dense pole composites, as run_cluster's
        for (int o = tid; o < 2 * kb * nb * X4; o += nt) {
          const int fq = by_nbx4(o), rest = o - fq * nb * X4;
          const int b = by_x4(rest), j = 4 * (rest - b * X4);
          const int f = by_kb(fq);
          const int sl = f * kmax + (fq - f * kb);
          for (int mm = 0; mm < nm; ++mm) {
            float ps[4];
            comp_partial<4>(s_rows + mm * CR + sl * X,
                            s_pc + (size_t)sl * X * X + j, b * COMP_BLOCK,
                            X, ps);
            *reinterpret_cast<float4*>(s_part + mm * CP + (sl * nb + b) * X +
                                       j) =
                make_float4(ps[0], ps[1], ps[2], ps[3]);
          }
        }
        __syncthreads();
        for (int o = tid; o < 2 * kb * X; o += nt) {
          const int fq = by_x(o), j = o - fq * X;
          const int f = by_kb(fq), q = fq - f * kb;
          const int sl = f * kmax + q;
          const int i = q < ntop ? q : bot0 + (q - ntop);
          for (int mm = 0; mm < nm; ++mm) {
            const float* part = s_part + mm * CP + sl * nb * X + j;
            float t2 = part[0];
            for (int b = 1; b < nb; ++b) t2 = t2 + part[b * X];
            const float* t1 = s_rows + mm * CR;
            const int so = sl * X + j;
            const float* xa = bufs.mine + mm * MB_BUF + cur;
            bufs.put(mm * MB_BUF + nxt, f, i, j,
                     comp_combine(t1[so], t2,
                                  xa[f * BX + (i + HALO) * X + j],
                                  s_wz[f * RX + i * X + j],
                                  t1[2 * kmax * X + so],
                                  t1[4 * kmax * X + so]));
          }
        }
      }
      // every block's rows and halos of buffer nxt are written, and no
      // block reads buffer cur any more
      cluster.sync();
      cur = nxt;
    }

    // this step's month (SCEN_YEARS): its slot is set at the month's first
    // step and goes out at its last; the annual sums at the year's last
    const bool last = t == a.T - 1;
    bool mstart = false, mend = false;
    float w = 0.f;
    int mo = 0;
    if (KIND == SCEN_YEARS) {
      mo = a.mon[t];
      mstart = t == 0 || a.mon[t - 1] != mo;
      mend = last || a.mon[t + 1] != mo;
      w = a.mon_w[t];
    }

    // -- pointwise physics and the state update of each member's cells
    for (int l = tid; l < nm * RX; l += nt) {
      const int mm = by_rx(l), li = l - mm * RX;
      const int m = m0 + mm;
      const int pix = r0 * X + li;
      const size_t corr_m =
          (size_t)(KIND == SCEN_YEARS && a.corr_shared ? 0 : m) * a.T *
          a.corr_step;
      const float* xc = bufs.mine + mm * MB_BUF + cur + HALO * X;
      float* st = s_state + mm * ST;
      float s5[5];
      for (int k = 0; k < 5; ++k) s5[k] = st[k * RX + li];
      float vals[N_SUM];
      update_cell<KIND, LEGACY>(a, s_par[mm], t, pix, s5, xc[li],
                                xc[BX + li], a.tf + corr_m, a.tof + corr_m,
                                a.qf + corr_m, (size_t)t * a.corr_step + pix,
                                vals);
      if (KIND == SCEN_YEARS) {
        const size_t my = (size_t)m * n_years + y;
        float* asum = a.asum + my * N_SUM * YX + r0 * X;
        float* sa = s_asum + mm * N_SUM * RX;
        for (int k = 0; k < N_SUM; ++k) {
          const float v = (t == 0 ? 0.f : sa[k * RX + li]) + vals[k];
          sa[k * RX + li] = v;
          if (last) asum[k * YX + li] = v;
        }
        float* mon = a.monthly + (my * a.nmon + mo) * N_OUT * YX + r0 * X;
        float* sm = s_mon + mm * N_OUT * RX;
        for (int k = 0; k < N_OUT; ++k) {
          const float v = (mstart ? 0.f : sm[k * RX + li]) + w * vals[k];
          sm[k * RX + li] = v;
          if (mend) mon[k * YX + li] = v;
        }
      }
      for (int k = 0; k < 5; ++k) st[k * RX + li] = s5[k];
    }
    __syncthreads();
  }
  for (int i = tid; i < nm * ST; i += nt) {
    const int mm = by_st(i), li = i - mm * ST;
    a.state_out[(size_t)(m0 + mm) * YX + r0 * X + (size_t)(li / RX) * MYX +
                li % RX] = s_state[i];
  }
  // no block leaves while another may still write into its shared memory
  cluster.sync();
}

#define MEMBER_KERNELS(NAME, KIND)                                            \
  __global__ void __launch_bounds__(MEMBER_NT, 1) NAME##_highest(             \
      YearArgs a, GrebParams p, PackCols c, int mb) {                         \
    run_members<KIND, false, PREC_HIGHEST>(a, p, c, mb);                      \
  }                                                                           \
  __global__ void __launch_bounds__(MEMBER_NT, 1) NAME##_bf16_3x(             \
      YearArgs a, GrebParams p, PackCols c, int mb) {                         \
    run_members<KIND, false, PREC_BF16_3X>(a, p, c, mb);                      \
  }                                                                           \
  __global__ void __launch_bounds__(MEMBER_NT, 1) NAME##_highest_legacy(      \
      YearArgs a, GrebParams p, PackCols c, int mb) {                         \
    run_members<KIND, true, PREC_HIGHEST>(a, p, c, mb);                       \
  }                                                                           \
  __global__ void __launch_bounds__(MEMBER_NT, 1) NAME##_bf16_3x_legacy(      \
      YearArgs a, GrebParams p, PackCols c, int mb) {                         \
    run_members<KIND, true, PREC_BF16_3X>(a, p, c, mb);                       \
  }

MEMBER_KERNELS(fluxcorr_years_mxu, FLUX)
MEMBER_KERNELS(scenario_years_mxu, SCEN_YEARS)

// The launch of ceil(a.M / mb) clusters of C blocks of `kernel` (of
// `kind`), mb members a cluster, into cfg (whose attrs point at attr), and
// how many such clusters the card runs at once; GREB_ERR_LAYOUT where the
// layout does not fit, GREB_ERR_NO_CLUSTER where the card runs none.
template <typename Kernel>
static int members_config(Kernel kernel, const YearArgs& a, int C, int kind,
                          int mb, void* stream, cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* cfg, int* clusters) {
  long long parts[N_MPARTS];
  const long long smem = members_parts(a.Y, a.X, a.ktc, a.kbc, C, kind, mb,
                                       parts);
  if (smem == 0 || smem > MAX_SMEM || a.M < 1) return GREB_ERR_LAYOUT;
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
  cfg->gridDim = dim3((a.M + mb - 1) / mb * C, 1, 1);
  cfg->blockDim = dim3(members_threads(a.Y / C, a.X), 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *clusters = 0;
  e = cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters == 0 ? GREB_ERR_NO_CLUSTER : 0;
}

// The entry of `table` (highest, bf16_3x, each modern then legacy) that
// runs precision `prec` under p's flags word; -1 where none does (the
// strict transport, no transport, an unknown word or precision).
static int members_pick(const GrebParams& p, int prec) {
  const Variant v = variant(p);
  if ((v != V_MODERN && v != V_LEGACY) || prec < 0 || prec > 1) return -1;
  return 2 * (v == V_LEGACY) + prec;
}

template <typename Kernel>
static int launch_members(Kernel const (&table)[4], const YearArgs& a,
                          const GrebParams& p, const PackCols& c, int prec,
                          int mb, int C, int kind, void* stream) {
  const int k = members_pick(p, prec);
  if (k < 0) return GREB_ERR_FLAGS;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  int clusters;
  const int err = members_config(table[k], a, C, kind, mb, stream, attr, &cfg,
                                 &clusters);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, table[k], a, p, c, mb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#define MEMBER_TABLE(K)                                                      \
  { K##_highest, K##_bf16_3x, K##_highest_legacy, K##_bf16_3x_legacy }

extern "C" {

// K4 and K3 with mb members a cluster of C blocks at precision `prec`
// (0: highest, 1: bf16_3x), the modern or legacy entry by the flags word
// (GREB_ERR_FLAGS for a word without the fold); errors as year_kernel.cu's
// launchers (greb_error_string).
int greb_fluxcorr_years_mxu(YearArgs a, GrebParams p, PackCols c, int prec,
                            int mb, int C, void* stream) {
  decltype(&fluxcorr_years_mxu_highest) const t[] =
      MEMBER_TABLE(fluxcorr_years_mxu);
  return launch_members(t, a, p, c, prec, mb, C, FLUX, stream);
}

int greb_scenario_years_mxu(YearArgs a, GrebParams p, PackCols c, int prec,
                            int mb, int C, void* stream) {
  decltype(&scenario_years_mxu_highest) const t[] =
      MEMBER_TABLE(scenario_years_mxu);
  return launch_members(t, a, p, c, prec, mb, C, SCEN_YEARS, stream);
}

// The kernel's own reckoning of a member block's shared memory: fills
// parts[N_MPARTS] (bytes, layout order), returns the total (0: none).
long long greb_members_layout(int Y, int X, int ktc, int kbc, int C,
                              int kind, int mb, long long* parts) {
  return members_parts(Y, X, ktc, kbc, C, kind, mb, parts);
}

// How many clusters of C blocks of the member kernel of `kind` (FLUX,
// SCEN_YEARS) with mb members the card runs at once, into *clusters.
int greb_members_capacity(int Y, int X, int ktc, int kbc, int C, int kind,
                          int mb, int* clusters) {
  YearArgs a = {};
  a.Y = Y; a.X = X; a.ktc = ktc; a.kbc = kbc; a.M = mb;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg;
  if (kind == FLUX)
    return members_config(fluxcorr_years_mxu_bf16_3x, a, C, kind, mb,
                          nullptr, attr, &cfg, clusters);
  return members_config(scenario_years_mxu_bf16_3x, a, C, kind, mb, nullptr,
                        attr, &cfg, clusters);
}

int greb_members_threads(int Y, int X, int C) {
  return members_threads(Y / C, X);
}

// The entry (MEMBER_TABLE's index) a launcher runs for a flags word at
// precision `prec`; -1: none (GREB_ERR_FLAGS).
int greb_members_pick(int flags, int prec) {
  GrebParams p = {};
  p.flags = flags;
  return members_pick(p, prec);
}

}  // extern "C"
