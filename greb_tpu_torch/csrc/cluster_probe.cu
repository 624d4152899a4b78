// Cost of one thread-block cluster barrier on the card, for the note on
// what bounds the single-run year kernels (csrc/year_kernel.cu).  Not a
// kernel of the model: chip_smoke.py reads it beside the kernels' times.
//
// Each of n iterations stores one float into the next block's shared
// memory (as a substep pushes its halo rows), then waits at a cluster
// barrier.  release=1 is the barrier the year kernels use
// (cooperative_groups cluster.sync(): barrier.cluster.arrive with release
// semantics, which makes the pushed rows visible to the neighbours and
// compiles to a GPU-scope memory barrier before the arrive); release=0
// arrives relaxed, which orders nothing and so cannot carry the halos, and
// shows what the barrier costs without that memory barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

template <int RELEASE>
__global__ void barrier_loop(int n, float* out) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  sm[threadIdx.x] = 0.f;
  cluster.sync();
  float* next = cluster.map_shared_rank(sm, (rank + 1) % C);
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    next[threadIdx.x] = (float)i;
    if (RELEASE)
      cluster.sync();
    else
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                   "barrier.cluster.wait.aligned;" ::: "memory");
    acc += sm[threadIdx.x];
  }
  cluster.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <int RELEASE>
static int time_loop(int C, int threads, int n, float* ms) {
  void (*kernel)(int, float*) = barrier_loop<RELEASE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  float* out = nullptr;
  e = cudaMalloc(&out, C * sizeof(float));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = threads * sizeof(float);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  e = cudaLaunchKernelEx(&cfg, kernel, n, out);            // warm-up
  if (e == cudaSuccess) {
    cudaEventRecord(start);
    e = cudaLaunchKernelEx(&cfg, kernel, n, out);
    cudaEventRecord(stop);
  }
  if (e == cudaSuccess) e = cudaEventSynchronize(stop);
  if (e == cudaSuccess) e = cudaEventElapsedTime(ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  cudaFree(out);
  return (int)e;
}

extern "C" {

// ns per iteration of a cluster of C blocks of `threads` threads; returns
// a cudaError_t (0: success).
int greb_cluster_barrier_ns(int C, int threads, int n, int release,
                            double* ns) {
  float ms = 0.f;
  const int e = release ? time_loop<1>(C, threads, n, &ms)
                        : time_loop<0>(C, threads, n, &ms);
  *ns = (double)ms * 1e6 / n;
  return e;
}

}  // extern "C"
