// A standalone probe of the wide form's grid barrier (not built by
// ops/cuda/build.py): 6 clusters of 16 blocks of 1024 threads with
// 196,656 B of dynamic shared memory a block, as 768x384's wide kernels
// launch.  It checks that a cooperative launch combines with the cluster
// dimension (cudaLaunchAttributeCooperative beside
// cudaLaunchAttributeClusterDimension), that cg::this_grid().sync() then
// orders every block's global writes for every other block (each block
// posts a value a round to one of two slots and reads another cluster's
// after the barrier: "mismatches"), and times a barrier against a counter
// barrier with GPU-scope release and acquire.  It also asks how many such
// clusters the card runs at once with 8 a launch, and does not launch
// that: a grid barrier over clusters that are not all resident never ends.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        grid_barrier_probe.cu -o grid_barrier_probe && ./grid_barrier_probe
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;

// The counter barrier: one atomic add a block, GPU-scope fences around it.
__device__ __forceinline__ void ctr_sync(unsigned* ctr, unsigned blocks,
                                         unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += blocks;
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(ctr) : "memory");
      if ((int)(seen - target) >= 0) break;
    }
    __threadfence();
  }
  __syncthreads();
}

// `iters` rounds of: post the round to slot (round & 1), cluster.sync(),
// the grid barrier (COOP: cg::this_grid().sync()), read a block 17 on.
template <bool COOP>
__global__ void k(unsigned* slots, unsigned* ctr, int iters, unsigned* bad,
                  int* valid) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int b = blockIdx.x, n = gridDim.x;
  if (COOP && b == 0 && threadIdx.x == 0) *valid = cg::this_grid().is_valid();
  if (COOP && !cg::this_grid().is_valid()) return;   // never sync then
  unsigned target = 0, nbad = 0;
  for (int it = 1; it <= iters; ++it) {
    unsigned* s = slots + (it & 1) * n;
    if (threadIdx.x == 0) s[b] = it;
    sm[threadIdx.x] = (float)it;
    cl.sync();
    if (COOP) cg::this_grid().sync(); else ctr_sync(ctr, n, target);
    if (threadIdx.x == 0 && ((volatile unsigned*)s)[(b + 17) % n] != (unsigned)it)
      ++nbad;
  }
  if (threadIdx.x == 0) atomicAdd(bad, nbad);
}

// One launch of `clusters` clusters (iters 0: the occupancy query only).
template <bool COOP>
static void run(int clusters, int iters) {
  const int C = 16, NT = 1024;
  const size_t smem = 196656;
  auto kern = k<COOP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C); cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem; cfg.attrs = attr; cfg.numAttrs = COOP ? 2 : 1;
  int cap = -1;
  cudaError_t oe = cudaOccupancyMaxActiveClusters(&cap, (void*)kern, &cfg);
  unsigned *slots, *ctr, *bad; int* valid;
  cudaMalloc(&slots, 2 * clusters * C * 4); cudaMalloc(&ctr, 4);
  cudaMalloc(&bad, 4); cudaMalloc(&valid, 4);
  cudaMemset(slots, 0, 2 * clusters * C * 4); cudaMemset(ctr, 0, 4);
  cudaMemset(bad, 0, 4); cudaMemset(valid, 0xff, 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  if (iters == 0) { printf("clusters=%d: occupancy %s cap=%d (not launched)\n", clusters, cudaGetErrorString(oe), cap); return; }
  cudaError_t le = cudaLaunchKernelEx(&cfg, kern, slots, ctr, iters, bad, valid);
  cudaEventRecord(e1);
  cudaError_t se = cudaDeviceSynchronize();
  float ms = 0; cudaEventElapsedTime(&ms, e0, e1);
  unsigned hbad = 0; int hvalid = -2;
  cudaMemcpy(&hbad, bad, 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(&hvalid, valid, 4, cudaMemcpyDeviceToHost);
  printf("%s clusters=%d iters=%d: occupancy %s cap=%d; launch %s; sync %s; "
         "is_valid=%d; mismatches=%u; %.3f ms = %.3f us a barrier\n",
         COOP ? "cooperative+cluster" : "counter barrier", clusters, iters,
         cudaGetErrorString(oe), cap, cudaGetErrorString(le),
         cudaGetErrorString(se), hvalid, hbad, ms,
         le == cudaSuccess ? 1e3 * ms / iters : 0.0);
  cudaGetLastError();
  cudaFree(slots); cudaFree(ctr); cudaFree(bad); cudaFree(valid);
}

int main() {
  run<true>(6, 100);        // warm-up and correctness
  run<false>(6, 100);
  run<true>(6, 20000);
  run<false>(6, 20000);
  run<true>(6, 20000);
  run<false>(6, 20000);
  run<true>(8, 0);          // occupancy only: a launch past it could hang
  return 0;
}
