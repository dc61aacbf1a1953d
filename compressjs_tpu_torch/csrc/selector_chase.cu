// Selector chase of the parallel Huffman walk for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this as a lax.scan
// (compressjs_tpu/ops/device_huffman.py:291-300, inside huffman_walk_dev).
// F[g, p] is the bit position reached after power_k symbols decoded
// with group g's table from bit p; the chunk boundaries follow
//
//   p <- F[sel[c] * cap + p],  `sub` times per selector c,
//
// starting at p = 0, and starts[c] is p before chunk c's first step.
// In PyTorch that chain would be one launch per step (thousands a -9
// block), so one thread runs it here.
//
// What bounds it: latency.  Every step is a load whose address depends
// on the previous load: s_cap * sub dependent reads, each an L2 hit at
// best (a -9 block's F is 6 x 2^20 int32, 25 MB, inside the 50 MB L2).
// Bytes and operations are negligible.  The loops are bounded by s_cap
// and sub alone, and the flat index is clamped into F, as a JAX gather
// clamps, so no input can read outside F.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void selector_chase_kernel(const int32_t* __restrict__ F,
                                      const int32_t* __restrict__ sel,
                                      int32_t* __restrict__ starts,
                                      int64_t cap, int G, int s_cap,
                                      int sub) {
  const int64_t last = static_cast<int64_t>(G) * cap - 1;
  int64_t p = 0;
  for (int c = 0; c < s_cap; ++c) {
    starts[c] = static_cast<int32_t>(p);
    const int64_t row = static_cast<int64_t>(sel[c]) * cap;
    for (int t = 0; t < sub; ++t) {
      int64_t i = row + p;
      i = i < 0 ? 0 : (i > last ? last : i);
      p = F[i];
    }
  }
}

}  // namespace

// F: (G, cap) int32; sel: (s_cap,) int32; starts: (s_cap,) int32 out.
// Returns cudaGetLastError().
extern "C" int cz_selector_chase(const int32_t* F, const int32_t* sel,
                                 int32_t* starts, int G, int64_t cap,
                                 int s_cap, int sub, void* stream) {
  if (G > 0 && cap > 0 && s_cap > 0) {
    selector_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        F, sel, starts, cap, G, s_cap, sub);
  }
  return static_cast<int>(cudaGetLastError());
}
