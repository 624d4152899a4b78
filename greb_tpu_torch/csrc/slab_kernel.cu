// The slab kernels: one latitude shard's step of the fold, a phase a
// launch, for the sharded runners (ops/cuda/slab.py, parallel/sharded.py).
//
// Replaces no TPU kernel: greb_tpu runs its latitude-sharded fold on XLA
// (parallel/sharded.py, ops/fastcirc2.py sharded_substep), with no Pallas
// kernel on that path.  They were added because a shard's year cannot be
// one resident launch as the year kernels' are: the shard's meridional
// halo rows come from another shard, on another card or in another
// process, after every substep.  So a shard's step is 2 + nsub launches:
//   slab_start            (Ta, q) into the transported buffer 0, the step's
//                         12 coefficient planes (step_coeffs) into a global
//                         scratch, and the shard's first and last two rows
//                         of buffer 0 into its edge buffer for the exchange;
//   slab_substep<FORM>    one fold substep of the shard's rows, buffer cur
//                         -> nxt, its edge rows of nxt into the edge buffer:
//                         the additive form with dense composites
//                         (additive_substep: 96x48, 192x96) or the
//                         sequential form with packed composites
//                         (refined_substep: 384x192, 768x384);
//   slab_finish<KIND, M>  the pointwise physics and state update of every
//                         cell (update_cell): K1's correction records
//                         (FLUX) or K2's per-step outputs and annual sums
//                         (SCEN); M: a member's params from the pack.
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
// the unsharded kernels' bit for bit.  A block's transported buffers are
// its own slice of a global array laid out as a cluster block's shared
// memory (Bufs: 2 buffers of 2 fields, R + 2 HALO rows); its neighbours'
// halo rows are written through Bufs::put into their slices, which the
// next launch reads.  wz, xa and the scratch of the segments and
// composites are the block's shared memory (refined_parts without the
// transported part).
//
// What bounds it: launches.  A 96x48 step on 4 shards is 4 x 26 launches
// and 25 exchanges of 2 copies a shard (1 for the outer shards) of 2 x 2
// rows, microseconds each, against the one-launch year's ~58 us a step
// (PERF.md §6); the runners capture a step as one CUDA graph.  At 768x384 each substep reads the shard's
// coefficient planes and its packed factors from L2 or HBM; the shards
// that hold composite rows set the pace, as the wide form's pole blocks
// do.

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
};

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

// One substep of the fold on the shard's rows, buffer cur -> nxt
// (run_refined's substep phase): the received halo rows into buffer cur
// at the shard's edges, wz and (sequential form) the composite slots'
// prefix sums into shared memory, then additive_substep or
// refined_substep of this block's rows with the member's coefficient
// scratch, then the edge rows of nxt out.
template <int FORM>
__global__ void __launch_bounds__(NT, 1) slab_substep(YearArgs a,
                                                      RefinedArgs g,
                                                      SlabArgs s, int cur) {
  extern __shared__ float smem[];
  const SlabBlock k = slab_block(a, s);
  const int Y = a.Y, X = a.X, YX = Y * X, P = 2 * YX;
  const int R = k.R, RX = R * X, r0 = k.r0, HX = HALO * X;
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
  for (int l = tid; l < 2 * HX; l += nt) {
    const int f = l >= HX, h = l - f * HX;
    if (k.b == 0)
      bufs.mine[cur + f * BX + h] = s.halo_in[slab_side(a.M, k.m, 0, X, l)];
    if (k.b == s.nblk - 1)
      bufs.mine[cur + f * BX + (R + HALO) * X + h] =
          s.halo_in[slab_side(a.M, k.m, 1, X, l)];
  }
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
  if (FORM == R_SEQ && tid == 0) {   // the packed composites' slots
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
  if constexpr (FORM == R_ADDITIVE) {
    const RowSlots later(r0, R, 0, ktc + dkt > akt ? ktc + dkt : akt,
                         Y - (kbc + dkb > akb ? kbc + dkb : akb), Y);
    additive_substep<false>(am, g, bk, later, bufs, cur, nxt, r0);
  } else {
    refined_substep<false, false>(am, g, bk, bufs, cur, nxt, r0);
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
// pack.
template <int KIND, bool MEMBERS>
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
  for (int li = threadIdx.x; li < RX; li += blockDim.x) {
    const int pix = k.r0 * X + li;
    float sv[5];
    for (int q = 0; q < 5; ++q) sv[q] = st[q * FS + li];
    float vals[N_SUM];
    update_cell<KIND, false>(a, pt, t, pix, sv, xc[li], xc[BX + li],
                             a.tf + corr_m, a.tof + corr_m, a.qf + corr_m,
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

int greb_slab_start(YearArgs a, SlabArgs s, void* stream) {
  return slab_launch(slab_start, a, s, 0, stream, a, s);
}

// g.form: R_ADDITIVE or R_SEQ (GREB_ERR_FLAGS for another), cur: the
// offset of the buffer the substep reads (0 or 2 (R + 2 HALO) X).
int greb_slab_substep(YearArgs a, RefinedArgs g, SlabArgs s, int cur,
                      void* stream) {
  long long parts[N_QPARTS];
  const long long smem = slab_parts(a.Y, a.X, a.ktc, a.kbc, s.nblk, g,
                                    parts);
  if (smem == 0) return GREB_ERR_LAYOUT;
  if (g.form == R_ADDITIVE)
    return slab_launch(slab_substep<R_ADDITIVE>, a, s, smem, stream, a, g, s,
                       cur);
  if (g.form == R_SEQ)
    return slab_launch(slab_substep<R_SEQ>, a, s, smem, stream, a, g, s, cur);
  return GREB_ERR_FLAGS;
}

// kind: FLUX or SCEN; members: the pack's columns give each member's
// physics.  Only the modern word (flags 0) runs here.
int greb_slab_finish(YearArgs a, GrebParams p, PackCols c, SlabArgs s,
                     int kind, int members, int cur, void* stream) {
  if (p.flags != 0) return GREB_ERR_FLAGS;
  if (kind == FLUX)
    return members ? slab_launch(slab_finish<FLUX, true>, a, s, 0, stream, a,
                                 p, c, s, cur)
                   : slab_launch(slab_finish<FLUX, false>, a, s, 0, stream,
                                 a, p, c, s, cur);
  if (kind == SCEN)
    return members ? slab_launch(slab_finish<SCEN, true>, a, s, 0, stream, a,
                                 p, c, s, cur)
                   : slab_launch(slab_finish<SCEN, false>, a, s, 0, stream,
                                 a, p, c, s, cur);
  return GREB_ERR_FLAGS;
}

// The kernel's own reckoning of a slab_substep block's shared memory:
// fills parts[N_QPARTS] (bytes, refined_parts' order, the transported part
// 0), returns the total (0: no layout).
long long greb_slab_layout(int Y, int X, int ktc, int kbc, int nblk,
                           RefinedArgs g, long long* parts) {
  return slab_parts(Y, X, ktc, kbc, nblk, g, parts);
}

int greb_slab_threads(int R, int X) { return cluster_threads(R, X); }

const char* greb_slab_error_string(int err) {
  if (err == GREB_ERR_LAYOUT)
    return "no slab layout: the shard's rows do not split into blocks of at "
           "least 2 rows, or a block's shared memory exceeds 227 KB";
  if (err == GREB_ERR_FLAGS)
    return "the slab kernels run the fold's modern word in the additive or "
           "sequential form only";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
