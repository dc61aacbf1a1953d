// Latency probes for Hopper (sm_90a).  No caller of the package launches
// these: chip_smoke.py times them to put a floor under the chase and the
// allocator kernels.
//
// * cz_chase_probe: one thread runs p <- F.flat[clamp(sel[c] * cap + p)],
//   `sub` times per selector, straight from global memory.  It was the
//   selector chase's kernel before the chase staged F in shared memory;
//   over a random single cycle of F's size held in L2 it measures the
//   latency of one dependent L2 load.
// * cz_smem_chain_probe: one thread runs p <- ring[p & (n - 1)] `steps`
//   times over a ring held in shared memory: the latency of one
//   dependent shared-memory load, the floor of any one-thread chain that
//   reads shared memory (the staged chase, the allocator's merge).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void chase_probe_kernel(const int32_t* __restrict__ F,
                                   const int32_t* __restrict__ sel,
                                   int32_t* __restrict__ starts,
                                   int64_t cap, int G, int n, int sub) {
  const int64_t last = static_cast<int64_t>(G) * cap - 1;
  int64_t p = 0;
  for (int c = 0; c < n; ++c) {
    starts[c] = static_cast<int32_t>(p);
    const int64_t row = static_cast<int64_t>(sel[c]) * cap;
    for (int t = 0; t < sub; ++t) {
      int64_t i = row + p;
      i = i < 0 ? 0 : (i > last ? last : i);
      p = F[i];
    }
  }
}

__global__ void smem_chain_kernel(const int32_t* __restrict__ ring, int n,
                                  int steps, int32_t* __restrict__ out) {
  extern __shared__ int32_t s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = ring[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int mask = n - 1;
  int p = 0;
  for (int t = 0; t < steps; ++t) p = s[p & mask];
  out[0] = p;
}

}  // namespace

// F: (G, cap) int32; sel: (n,) int32; starts: (n,) int32 out.
extern "C" int cz_chase_probe(const int32_t* F, const int32_t* sel,
                              int32_t* starts, int G, int64_t cap, int n,
                              int sub, void* stream) {
  if (G > 0 && cap > 0 && n > 0) {
    chase_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        F, sel, starts, cap, G, n, sub);
  }
  return static_cast<int>(cudaGetLastError());
}

// ring: (n,) int32, n a power of two <= 32768; out: (1,) int32, the p
// after `steps` steps from p = 0.
extern "C" int cz_smem_chain_probe(const int32_t* ring, int n, int steps,
                                   int32_t* out, void* stream) {
  if (n > 0 && (n & (n - 1)) == 0 && n <= 32768) {
    const int bytes = n * 4;
    cudaFuncSetAttribute(smem_chain_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    smem_chain_kernel<<<1, 256, bytes, static_cast<cudaStream_t>(stream)>>>(
        ring, n, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
