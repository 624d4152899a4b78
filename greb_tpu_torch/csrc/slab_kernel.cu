// The slab kernels: one latitude shard's step of the transport, a phase a
// launch, for the sharded runners (ops/cuda/slab.py, parallel/sharded.py).
//
// Replaces no TPU kernel: greb_tpu runs its latitude-sharded fold and
// strict stencils on XLA (parallel/sharded.py, ops/fastcirc2.py
// sharded_substep, ops/stencils.py), with no Pallas kernel on that path.
// They were added because a shard's year cannot be one resident launch as
// the year kernels' are: the shard's meridional halo rows come from
// another shard, on another card or in another process, after every
// substep.  So a shard's step is 2 + nsub launches:
//   slab_start            (Ta, q) into the transported buffer 0, the step's
//                         12 coefficient planes (step_coeffs) into a global
//                         scratch, and the shard's first and last two rows
//                         of buffer 0 into its edge buffer for the exchange;
//                         slab_start_strict the moving fields alone (no
//                         fold: no coefficients);
//   slab_substep<FORM>    one fold substep of the shard's rows, buffer cur
//                         -> nxt, its edge rows of nxt into the edge buffer:
//                         the additive form with dense composites
//                         (additive_substep: 96x48, 192x96) or packed ones
//                         (additive_substep<false, true>: 224x112 to
//                         352x176), or the sequential form with packed
//                         composites (refined_substep: 384x192, 768x384);
//   slab_strict<FORM>     one substep of the strict transport, the year
//                         kernels' form of the grid: the cluster body's
//                         (strict_substep: 96x48, 192x96, the small grids),
//                         the sequential one (strict_seq_substep: 384x192)
//                         or the additive one (strict_add_substep: 224x112
//                         to 352x176);
//   slab_finish<KIND, M, LEGACY>
//                         the pointwise physics and state update of every
//                         cell (update_cell): K1's correction records
//                         (FLUX) or K2's per-step outputs and annual sums
//                         (SCEN); M: a member's params from the pack;
//                         LEGACY: the switches of the flags word, Ta and q
//                         from the state where they do not move.
// Under no transport (CIRCULATION_OFF) a step is slab_finish alone.
// Between launches the host (or the graph it captured) copies the
// neighbour shards' edge rows into this shard's received halo rows
// (parallel/halo.py); the outer shards' stay zero, the reference's pole
// boundary.  The state, the transported buffers, the coefficient scratch,
// the corrections, outputs and sums live in global memory.  The step's
// index and the year's CO2 are read from device memory, so one captured
// step replays for every step of every year.
//
// A shard's rows are split over nblk blocks of R = Y / nblk rows (R >=
// HALO), one member's blocks after another's.  Each block runs the year
// kernels' own device functions on its rows with the shard's local
// geometry (YearArgs.Y is the shard's rows; bt, bb, ktc, kbc and the
// segments are the shard's share of the global plan's,
// ops/fastcirc2.py build_sharded), so every cell takes the unsharded
// fold's float32 operations in the same order and a sharded year equals
// the unsharded kernels' bit for bit.  The strict forms take the shard's
// rows of the strict constants (each row's sub-cycle counts and
// coefficients, ops/cuda/slab.py cut_strict) and wz with its HALO rows
// from the neighbour shards, cut once (static, never exchanged); the
// advection's one-sided forms at global rows 1 and Y-2 are placed from
// the shard's first global row (SlabArgs::row0).  A block's sub-cycle
// rounds run to its own rows' largest count, as in the unsharded block.
// A block's transported buffers are
// its own slice of a global array laid out as a cluster block's shared
// memory (Bufs: 2 buffers of 2 fields, R + 2 HALO rows); its neighbours'
// halo rows are written through Bufs::put into their slices, which the
// next launch reads.  wz, xa and the scratch of the segments and
// composites are the block's shared memory (refined_parts without the
// transported part); the strict forms' wz with halo rows, winds,
// sub-cycle scratch and rows' constants (slab_strict_parts).
//
// What bounds it: launches.  A 96x48 step on 4 shards is 4 x 26 launches
// and 25 exchanges of 2 copies a shard (1 for the outer shards) of 2 x 2
// rows, microseconds each, against the one-launch year's ~58 us a step
// (PERF.md §6); the runners capture a step as one CUDA graph.  At 768x384 each substep reads the shard's
// coefficient planes and its packed factors from L2 or HBM; the shards
// that hold composite rows set the pace, as the wide form's pole blocks
// do.  Under the strict transport the pole shard sets the pace: it holds
// the polar sub-cycles' rounds while the others wait at the exchange.

#define GREB_DEVICE_ONLY
#include "year_kernel.cu"

struct SlabArgs {
  float* xg;             // (M, nblk, 2 buffers, 2 fields, R + 2 HALO, X)
  const float* halo_in;  // (2, M, 2, HALO, X): side 0 the rows above the
                         // shard's first row, side 1 those below its last
  float* edge_out;       // (2, M, 2, HALO, X): side 0 the shard's first two
                         // rows, side 1 its last two
  const int* step;       // this step's index in the year
  const float* co2;      // this year's CO2 [ppm]
  int nblk;              // blocks a member
  int row0, Yg;          // the shard's first row in the global grid, and
                         // the global grid's rows (the strict forms)
};

// The strict forms of slab_strict beside the refined ones (RefinedArgs::
// form: R_STRICT, R_STRICT_ADDITIVE): the cluster body's strict substep.
enum SlabForm { S_STRICT_CLUSTER = R_STRICT_ADDITIVE + 1 };

// This block's member, block index, rows and transported buffers.
struct SlabBlock {
  int m, b, R, r0;
  Bufs bufs;
};

__device__ __forceinline__ SlabBlock slab_block(const YearArgs& a,
                                                const SlabArgs& s) {
  SlabBlock k;
  k.m = (int)blockIdx.x / s.nblk;
  k.b = (int)blockIdx.x - k.m * s.nblk;
  k.R = a.Y / s.nblk;
  k.r0 = k.b * k.R;
  const size_t region = (size_t)4 * (k.R + 2 * HALO) * a.X;
  float* mine = s.xg + ((size_t)k.m * s.nblk + k.b) * region;
  k.bufs = Bufs{mine, k.b > 0 ? mine - region : nullptr,
                k.b < s.nblk - 1 ? mine + region : nullptr, k.R, a.X};
  return k;
}

// Element l (field-major, HALO rows of X) of side `side` of member m in an
// edge or halo buffer.
__device__ __forceinline__ size_t slab_side(int M, int m, int side, int X,
                                            int l) {
  return ((size_t)side * M + m) * 2 * HALO * X + l;
}

// The shard's edge rows of buffer `off` into s.edge_out: its first block's
// rows 0, 1 and its last block's rows R-2, R-1.
__device__ void slab_edges(const YearArgs& a, const SlabArgs& s,
                           const SlabBlock& k, int off) {
  const int X = a.X, HX = HALO * X, BX = k.bufs.field();
  for (int l = threadIdx.x; l < 2 * HX; l += blockDim.x) {
    const int f = l >= HX, h = l - f * HX;
    if (k.b == 0)
      s.edge_out[slab_side(a.M, k.m, 0, X, l)] =
          k.bufs.mine[off + f * BX + HX + h];
    if (k.b == s.nblk - 1)
      s.edge_out[slab_side(a.M, k.m, 1, X, l)] =
          k.bufs.mine[off + f * BX + k.R * X + h];
  }
}

// The received halo rows into buffer `off` at the shard's edges: side 0
// above its first block's rows, side 1 below its last block's.
__device__ __forceinline__ void slab_halo_in(const YearArgs& a,
                                             const SlabArgs& s,
                                             const SlabBlock& k, int off) {
  const int X = a.X, HX = HALO * X, BX = k.bufs.field();
  for (int l = threadIdx.x; l < 2 * HX; l += blockDim.x) {
    const int f = l >= HX, h = l - f * HX;
    if (k.b == 0)
      k.bufs.mine[off + f * BX + h] = s.halo_in[slab_side(a.M, k.m, 0, X, l)];
    if (k.b == s.nblk - 1)
      k.bufs.mine[off + f * BX + (k.R + HALO) * X + h] =
          s.halo_in[slab_side(a.M, k.m, 1, X, l)];
  }
}

// Step start (run_refined's, for a shard): (Ta, q) of the state into
// buffer 0 and the neighbour blocks' halos, this step's coefficient planes
// into the member's scratch a.cf (M, 12, 2, Y, X), the edge rows out.
__global__ void __launch_bounds__(NT, 1) slab_start(YearArgs a, SlabArgs s) {
  const SlabBlock k = slab_block(a, s);
  const int X = a.X, YX = a.Y * X, P = 2 * YX, RX = k.R * X;
  const size_t FS = (size_t)a.M * YX, tyx = (size_t)(*s.step) * YX;
  const float* st = a.state_out + (size_t)k.m * YX + (size_t)k.r0 * X;
  float* const cfm = a.cf + (size_t)k.m * 12 * P;
  const Div by_rx(RX), by_x(X);
  for (int l = threadIdx.x; l < 2 * RX; l += blockDim.x) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    const size_t c = (size_t)f * YX + (size_t)k.r0 * X + li;
    k.bufs.put(0, f, i, j, st[(f == 0 ? 1 : 3) * FS + li]);
    step_coeffs(a.zam + c, a.mer + c, P, a.u[tyx + k.r0 * X + li],
                a.v[tyx + k.r0 * X + li], cfm + c, P);
  }
  __syncthreads();
  slab_edges(a, s, k, 0);
}

// Step start of the strict transport (run_cluster's and run_refined's
// strict step start, for a shard): the nf moving fields of the state (Ta,
// and q unless VAPOR_CIRCULATION_OFF) into buffer 0 and the neighbour
// blocks' halos, the edge rows out; no fold, so no coefficients.
__global__ void __launch_bounds__(NT, 1) slab_start_strict(YearArgs a,
                                                           SlabArgs s,
                                                           int nf) {
  const SlabBlock k = slab_block(a, s);
  const int X = a.X, YX = a.Y * X, RX = k.R * X;
  const size_t FS = (size_t)a.M * YX;
  const float* st = a.state_out + (size_t)k.m * YX + (size_t)k.r0 * X;
  const Div by_rx(RX), by_x(X);
  for (int l = threadIdx.x; l < nf * RX; l += blockDim.x) {
    const int f = by_rx(l), li = l - f * RX;
    const int i = by_x(li), j = li - i * X;
    k.bufs.put(0, f, i, j, st[(f == 0 ? 1 : 3) * FS + li]);
  }
  __syncthreads();
  slab_edges(a, s, k, 0);
}

// One substep of the fold on the shard's rows, buffer cur -> nxt
// (run_refined's substep phase): the received halo rows into buffer cur
// at the shard's edges, wz and the composite slots'
// prefix sums into shared memory (the packed forms), then additive_substep
// (FORM R_ADDITIVE: dense composites; R_ADDITIVE_PACKED: packed) or
// refined_substep (R_SEQ) of this block's rows with the member's
// coefficient scratch, then the edge rows of nxt out.
template <int FORM>
__global__ void __launch_bounds__(NT, 1) slab_substep(YearArgs a,
                                                      RefinedArgs g,
                                                      SlabArgs s, int cur) {
  extern __shared__ float smem[];
  const SlabBlock k = slab_block(a, s);
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int R = k.R, RX = R * X, r0 = k.r0;
  const int ktc = a.ktc, kbc = a.kbc, K = ktc + kbc;
  const int tid = threadIdx.x, nt = blockDim.x;
  long long parts[N_QPARTS];
  refined_parts(Y, X, ktc, kbc, s.nblk, g, parts, 1 << 30);
  float* sp[N_QPARTS];
  sp[Q_XBUF] = nullptr;   // the transported buffers are k.bufs, in xg
  sp[Q_WZ] = smem;
  for (int q = Q_WZ + 1; q < N_QPARTS; ++q)
    sp[q] = sp[q - 1] + parts[q - 1] / sizeof(float);
  const Bufs& bufs = k.bufs;
  const int BX = bufs.field();
  slab_halo_in(a, s, k, cur);
  float* wz = sp[Q_WZ];
  for (int i = tid; i < 2 * RX; i += nt)
    wz[i] = a.wz[(size_t)(i / RX) * YX + r0 * X + i % RX];
  int dkt, dkb, akt, akb;
  seg_reach(g.dseg, g.n_dseg, &dkt, &dkb);
  seg_reach(g.aseg, g.n_aseg, &akt, &akb);
  int* zpre = reinterpret_cast<int*>(sp[Q_INDEX]);
  const RefinedBlock bk{
      RowSlots(r0, R, 0, ktc, Y - kbc, Y),
      RowSlots(r0, R, ktc, ktc + dkt, Y - kbc - dkb, Y - kbc),
      RowSlots(r0, R, 0, akt, Y - akb, Y),
      zpre, wz, sp[Q_XA], sp[Q_SCRATCH]};
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
  __syncthreads();
  // the member's coefficient scratch, as the single-run bodies read theirs
  YearArgs am = a;
  am.cf = a.cf + (size_t)k.m * 12 * P;
  const int nxt = 2 * BX - cur;
  if constexpr (FORM == R_ADDITIVE || FORM == R_ADDITIVE_PACKED) {
    const RowSlots later(r0, R, 0, ktc + dkt > akt ? ktc + dkt : akt,
                         Y - (kbc + dkb > akb ? kbc + dkb : akb), Y);
    additive_substep<false, FORM == R_ADDITIVE_PACKED>(am, g, bk, later,
                                                       bufs, cur, nxt, r0);
  } else {
    refined_substep<false, false>(am, g, bk, bufs, cur, nxt, r0);
  }
  __syncthreads();
  slab_edges(a, s, k, nxt);
}

// Shared memory of a slab_strict block of form `form` for the shard's Y
// rows on nblk blocks, in refined_parts' order (ops/cuda/slab.py
// SLAB_STRICT_PARTS): no transported buffers (global here), wz of both
// fields with HALO rows each side, the step's winds (the cluster body's
// form; the others read them from global memory), the sub-cycles' scratch
// (the cluster body's four (2, R, X) planes, the refined strict forms'
// two) and the rows' constants (strict_refined_parts' 6 or 8 words a row;
// the cluster body's form 6: ccx, ccx2, cax, cax2 and the two counts);
// their total, 0 where there is no layout (R < HALO, X not a multiple of
// 4, another form).
__host__ __device__ inline long long slab_strict_parts(int Y, int X, int nblk,
                                                       int form,
                                                       long long* parts) {
  if (nblk < 1 || Y % nblk != 0 || Y / nblk < HALO || X % 4 != 0
      || (form != S_STRICT_CLUSTER && form != R_STRICT
          && form != R_STRICT_ADDITIVE))
    return 0;
  const long long R = Y / nblk, f = sizeof(float);
  const bool cl = form == S_STRICT_CLUSTER;
  parts[Q_XBUF] = 0;
  parts[Q_WZ] = f * 2 * (R + 2 * HALO) * X;
  parts[Q_XA] = cl ? f * 2 * R * X : 0;
  parts[Q_SCRATCH] = f * (cl ? 4 : 2) * 2 * R * X;
  parts[Q_INDEX] = f * (((form == R_STRICT_ADDITIVE ? 8 : 6) * R + 3) / 4 * 4);
  long long total = 0;
  for (int q = 0; q < N_QPARTS; ++q) total += parts[q];
  return total;
}

// One substep of the strict transport on the shard's rows, buffer cur ->
// nxt, in the year kernels' form of the grid (FORM): the received halo
// rows into buffer cur at the shard's edges; wz with HALO rows (the
// shard's cut a.st_wz, (2, Y + 2 HALO, X), its neighbours' rows in its
// halo rows, zero past the poles) and the rows' constants into shared
// memory, as the year kernels' strict set-up loads them (run_cluster for
// S_STRICT_CLUSTER, with this step's winds; run_refined for R_STRICT and
// R_STRICT_ADDITIVE, with each count's row order); then strict_substep,
// strict_seq_substep or strict_add_substep of this block's rows, the
// moving fields and the advecting ones from the flags word, at global
// rows (SlabArgs::row0 on, of SlabArgs::Yg) for the one-sided advection
// at rows 1 and Y-2; then the edge rows of nxt out.  The refined forms'
// device functions read the winds of step t at t*Y*X + r*X of global row
// r: they are given a view of the grid whose step 0 is this step's rows
// of the shard.
template <int FORM>
__global__ void __launch_bounds__(NT, 1) slab_strict(YearArgs a, SlabArgs s,
                                                     int cur, int flags) {
  extern __shared__ float smem[];
  const SlabBlock k = slab_block(a, s);
  const int Y = a.Y, X = a.X, YX = Y * X;
  const int R = k.R, RX = R * X, r0 = k.r0;
  const int tid = threadIdx.x, nt = blockDim.x;
  long long parts[N_QPARTS];
  slab_strict_parts(Y, X, s.nblk, FORM, parts);
  float* sp[N_QPARTS];
  sp[Q_XBUF] = nullptr;   // the transported buffers are k.bufs, in xg
  sp[Q_WZ] = smem;
  for (int q = Q_WZ + 1; q < N_QPARTS; ++q)
    sp[q] = sp[q - 1] + parts[q - 1] / sizeof(float);
  const Bufs& bufs = k.bufs;
  const int BX = bufs.field(), WX = (R + 2 * HALO) * X;
  slab_halo_in(a, s, k, cur);
  float* wz = sp[Q_WZ];
  const size_t SW = (size_t)(Y + 2 * HALO) * X;
  for (int i = tid; i < 2 * WX; i += nt) {
    const int f = i / WX;
    wz[i] = a.st_wz[f * SW + (size_t)r0 * X + (i - f * WX)];
  }
  const int t = *s.step;
  const int nf = (flags & VAPOR_CIRCULATION_OFF) ? 1 : 2;
  const bool q_adv = !(flags & VAPOR_DIFFUSION_ONLY);
  const int rg = s.row0 + r0;   // the block's first global row
  const int nxt = 2 * BX - cur;
  float* rc = sp[Q_INDEX];
  if constexpr (FORM == S_STRICT_CLUSTER) {
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
    float* uv = sp[Q_XA];
    const size_t tr = (size_t)t * YX + (size_t)r0 * X;
    for (int li = tid; li < RX; li += nt) {
      uv[li] = a.u[tr + li];
      uv[RX + li] = a.v[tr + li];
    }
    __syncthreads();
    Strict st;
    st.wz = wz;
    st.uv = uv;
    st.ccx = rc;
    st.ccx2 = rc + R;
    st.cax = rc + 2 * R;
    st.cax2 = rc + 3 * R;
    st.nd = rn;
    st.na = rn + R;
    st.sub = sp[Q_SCRATCH];
    st.ccy_d = a.st_ccy_d;
    st.ccy_a = a.st_ccy_a;
    st.nf = nf;
    st.q_adv = q_adv;
    st.quirk = a.quirk != 0;
    st.has_sub = false;
    st.nit = 0;
    for (int i = 0; i < R; ++i) {
      const int n = rn[i] > rn[R + i] ? rn[i] : rn[R + i];
      st.has_sub = st.has_sub || n >= 0;
      st.nit = n > st.nit ? n : st.nit;
    }
    strict_substep(st, bufs, bufs.mine + cur, nxt, rg, s.Yg);
  } else {
    int* rn = reinterpret_cast<int*>(rc + 2 * R);
    for (int i = tid; i < R; i += nt) {
      const float* rows = a.st_rows + r0 + i;   // (4, Y), this row
      rc[i] = (a.st_kappa * rows[Y]) / rows[0];
      rc[R + i] = rows[2 * Y];
      rn[i] = a.st_n[r0 + i];
      rn[R + i] = a.st_n[Y + r0 + i];
      if constexpr (FORM == R_STRICT_ADDITIVE) {
        rc[6 * R + i] = a.st_kdt / rows[0];
        rc[7 * R + i] = rows[3 * Y];
      }
    }
    __syncthreads();
    if (tid < 2) {   // insertion sort by count, most first; stable
      const int* cnt = rn + tid * R;
      int* ord = rn + (2 + tid) * R;
      for (int i = 0; i < R; ++i) {
        int j = i;
        for (; j > 0 && cnt[ord[j - 1]] < cnt[i]; --j) ord[j] = ord[j - 1];
        ord[j] = i;
      }
    }
    __syncthreads();
    const StrictSeq ss{wz, rc, rc + R, rn, rn + R, rn + 2 * R, rn + 3 * R,
                       sp[Q_SCRATCH], a.st_ccy_d, a.st_ccy_a, nf,
                       q_adv ? nf : 1, a.quirk != 0};
    YearArgs ag = a;
    ag.Y = s.Yg;
    const long long view = (long long)t * YX - (long long)s.row0 * X;
    ag.u = a.u + view;
    ag.v = a.v + view;
    if constexpr (FORM == R_STRICT_ADDITIVE)
      strict_add_substep(ag, StrictAdd{ss, rc + 6 * R, rc + 7 * R}, bufs, cur,
                         nxt, rg, 0);
    else
      strict_seq_substep(ag, ss, bufs, cur, nxt, rg, 0);
  }
  __syncthreads();
  slab_edges(a, s, k, nxt);
}

// The step's end (run_refined's update): each cell's pointwise physics and
// state update from the circulated (Ta, q) of buffer cur, at step
// *s.step and CO2 *s.co2; FLUX writes member m's correction records at
// m * T * corr_step + t * corr_step + pix, SCEN its per-step outputs
// (M, T, 5, Y, X) and its annual sums (M, 9, Y, X) in sequence from 0 at
// the year's first step.  MEMBERS: member m's physics from row m of the
// pack.  LEGACY: the state update with the switches of the flags word
// (update_cell<KIND, true>, as the year kernels' legacy and strict
// instantiations run it), Ta and q taken from the state where they do not
// move (CIRCULATION_OFF: both, no substeps ran; VAPOR_CIRCULATION_OFF: q),
// as run_cluster takes them.
template <int KIND, bool MEMBERS, bool LEGACY>
__global__ void __launch_bounds__(NT, 1) slab_finish(YearArgs a, GrebParams p,
                                                     PackCols c, SlabArgs s,
                                                     int cur) {
  const SlabBlock k = slab_block(a, s);
  const int X = a.X, YX = a.Y * X, RX = k.R * X;
  const int t = *s.step;
  GrebParams pt = MEMBERS ? member_params(p, a, c, k.m) : p;
  pt.co2 = *s.co2;
  const size_t FS = (size_t)a.M * YX;
  float* st = a.state_out + (size_t)k.m * YX + (size_t)k.r0 * X;
  const size_t corr_m = (size_t)k.m * a.T * a.corr_step;
  float* const asum = a.asum + (size_t)k.m * N_SUM * YX;
  const float* xc = k.bufs.mine + cur + HALO * X;   // circulated, row 0
  const int BX = k.bufs.field();
  const bool circ = !on<LEGACY>(p, CIRCULATION_OFF);
  const bool q_moves = circ && !on<LEGACY>(p, VAPOR_CIRCULATION_OFF);
  for (int li = threadIdx.x; li < RX; li += blockDim.x) {
    const int pix = k.r0 * X + li;
    float sv[5];
    for (int q = 0; q < 5; ++q) sv[q] = st[q * FS + li];
    float vals[N_SUM];
    update_cell<KIND, LEGACY>(a, pt, t, pix, sv, circ ? xc[li] : sv[1],
                              q_moves ? xc[BX + li] : sv[3], a.tf + corr_m,
                              a.tof + corr_m, a.qf + corr_m,
                              (size_t)t * a.corr_step + pix, vals);
    if (KIND == SCEN) {
      float* out = a.outs + ((size_t)k.m * a.T + t) * N_OUT * YX + pix;
      for (int q = 0; q < N_OUT; ++q) out[(size_t)q * YX] = vals[q];
      for (int q = 0; q < N_SUM; ++q) {
        float* sum = asum + (size_t)q * YX + pix;
        *sum = (t == 0 ? 0.f : *sum) + vals[q];
      }
    }
    for (int q = 0; q < 5; ++q) st[q * FS + li] = sv[q];
  }
}

// Shared memory of a slab_substep block: refined_parts' parts for the
// shard's Y rows on nblk blocks, without the transported buffers (global
// here); 0 where refined_parts has no layout.
static long long slab_parts(int Y, int X, int ktc, int kbc, int nblk,
                            const RefinedArgs& g, long long* parts) {
  if (refined_parts(Y, X, ktc, kbc, nblk, g, parts, 1 << 30) == 0) return 0;
  parts[Q_XBUF] = 0;
  long long total = 0;
  for (int q = 0; q < N_QPARTS; ++q) total += parts[q];
  return total;
}

template <typename Kernel, typename... Args>
static int slab_launch(Kernel kernel, const YearArgs& a, const SlabArgs& s,
                       long long smem, void* stream, Args... args) {
  if (s.nblk < 1 || a.Y % s.nblk != 0 || a.Y / s.nblk < HALO || a.M < 1
      || smem > MAX_SMEM)
    return GREB_ERR_LAYOUT;
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.M * s.nblk, cluster_threads(a.Y / s.nblk, a.X), (size_t)smem,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" {

// nf: 0 the fold's step start (slab_start), 1 or 2 the strict transport's
// with that many moving fields (slab_start_strict).
int greb_slab_start(YearArgs a, SlabArgs s, int nf, void* stream) {
  if (nf == 0) return slab_launch(slab_start, a, s, 0, stream, a, s);
  if (nf == 1 || nf == 2)
    return slab_launch(slab_start_strict, a, s, 0, stream, a, s, nf);
  return GREB_ERR_FLAGS;
}

// g.form: the fold's R_ADDITIVE, R_ADDITIVE_PACKED or R_SEQ, or the strict
// transport's S_STRICT_CLUSTER, R_STRICT or R_STRICT_ADDITIVE (which take
// the flags word: the strict transport without CIRCULATION_OFF); cur: the
// offset of the buffer the substep reads (0 or 2 (R + 2 HALO) X).
int greb_slab_substep(YearArgs a, RefinedArgs g, SlabArgs s, int cur,
                      int flags, void* stream) {
  long long parts[N_QPARTS];
  if (g.form == S_STRICT_CLUSTER || g.form == R_STRICT
      || g.form == R_STRICT_ADDITIVE) {
    const long long smem = slab_strict_parts(a.Y, a.X, s.nblk, g.form, parts);
    if (smem == 0) return GREB_ERR_LAYOUT;
    if ((flags & ~KNOWN_FLAGS) || !(flags & STRICT_TRANSPORT)
        || (flags & CIRCULATION_OFF))
      return GREB_ERR_FLAGS;
    if (g.form == S_STRICT_CLUSTER)
      return slab_launch(slab_strict<S_STRICT_CLUSTER>, a, s, smem, stream, a,
                         s, cur, flags);
    if (g.form == R_STRICT)
      return slab_launch(slab_strict<R_STRICT>, a, s, smem, stream, a, s, cur,
                         flags);
    return slab_launch(slab_strict<R_STRICT_ADDITIVE>, a, s, smem, stream, a,
                       s, cur, flags);
  }
  const long long smem = slab_parts(a.Y, a.X, a.ktc, a.kbc, s.nblk, g,
                                    parts);
  if (smem == 0) return GREB_ERR_LAYOUT;
  if (g.form == R_ADDITIVE)
    return slab_launch(slab_substep<R_ADDITIVE>, a, s, smem, stream, a, g, s,
                       cur);
  if (g.form == R_ADDITIVE_PACKED)
    return slab_launch(slab_substep<R_ADDITIVE_PACKED>, a, s, smem, stream, a,
                       g, s, cur);
  if (g.form == R_SEQ)
    return slab_launch(slab_substep<R_SEQ>, a, s, smem, stream, a, g, s, cur);
  return GREB_ERR_FLAGS;
}

// kind: FLUX or SCEN; members: the pack's columns give each member's
// physics.  The modern variant at flags 0, the legacy one (the switches)
// at any other word a year kernel runs (variant).
int greb_slab_finish(YearArgs a, GrebParams p, PackCols c, SlabArgs s,
                     int kind, int members, int cur, void* stream) {
  const Variant v = variant(p);
  if (v == V_NONE || (kind != FLUX && kind != SCEN)) return GREB_ERR_FLAGS;
#define SLAB_FINISH(K, M, L) \
  slab_launch(slab_finish<K, M, L>, a, s, 0, stream, a, p, c, s, cur)
  if (v == V_MODERN) {
    if (kind == FLUX)
      return members ? SLAB_FINISH(FLUX, true, false)
                     : SLAB_FINISH(FLUX, false, false);
    return members ? SLAB_FINISH(SCEN, true, false)
                   : SLAB_FINISH(SCEN, false, false);
  }
  if (kind == FLUX)
    return members ? SLAB_FINISH(FLUX, true, true)
                   : SLAB_FINISH(FLUX, false, true);
  return members ? SLAB_FINISH(SCEN, true, true)
                 : SLAB_FINISH(SCEN, false, true);
#undef SLAB_FINISH
}

// The kernel's own reckoning of a slab_substep or slab_strict block's
// shared memory (by g.form): fills parts[N_QPARTS] (bytes, refined_parts'
// order, the transported part 0), returns the total (0: no layout).
long long greb_slab_layout(int Y, int X, int ktc, int kbc, int nblk,
                           RefinedArgs g, long long* parts) {
  if (g.form == S_STRICT_CLUSTER || g.form == R_STRICT
      || g.form == R_STRICT_ADDITIVE)
    return slab_strict_parts(Y, X, nblk, g.form, parts);
  return slab_parts(Y, X, ktc, kbc, nblk, g, parts);
}

int greb_slab_threads(int R, int X) { return cluster_threads(R, X); }

const char* greb_slab_error_string(int err) {
  if (err == GREB_ERR_LAYOUT)
    return "no slab layout: the shard's rows do not split into blocks of at "
           "least 2 rows, or a block's shared memory exceeds 227 KB";
  if (err == GREB_ERR_FLAGS)
    return "the slab kernels have no form for this plan, or a year kernel "
           "runs no variant of this flags word";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
