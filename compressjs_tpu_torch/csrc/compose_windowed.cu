// Windowed composition of next-position maps for Hopper (sm_90a).
//
// Replaces compressjs_tpu/ops/pallas_compose.py:_compose_kernel (launched
// by compose_windowed).  For (G, cap) int32 maps a and b whose jumps
// b[g, p] - p lie in [blo, bhi] (bzip2 codes are 1..20 bits, so the
// k-th power of the walk's next-symbol map jumps k..20k),
//
//   c[g, p] = a_pad[g, p + clip(b[g, p] - p, blo, bhi)],
//
// where a_pad is a extended on the right by a[g, cap - 1]; the read
// index is therefore min(p + d, cap - 1).  Jumps outside the window
// are clipped, so tail positions read a clamped value exactly as the
// JAX package's builds do (the selector chase never reaches them).
//
// What bounds it: bytes.  Each element reads b once, a once and writes
// c once, 12 bytes (8 when a squaring passes one map as both a and b),
// and does a handful of integer operations.  The
// Pallas kernel swept the window with lane rotations because random
// gathers are slow on the TPU; on Hopper a gather is cheap when it stays
// near its neighbours' addresses, and here it does: a warp's 32 reads of
// a fall inside 32 + bhi consecutive elements, a few cache lines that L1
// and L2 serve.  So one thread owns one (g, p): a coalesced load of b,
// one load of a, a coalesced store of c.  blockIdx.y is the group row,
// so no 64-bit division is needed; indices are 64-bit.  No loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compose_windowed_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ c, int64_t cap, int blo,
                        int bhi) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (p >= cap) return;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * cap;
  int64_t d = static_cast<int64_t>(b[row + p]) - p;
  d = d < blo ? blo : (d > bhi ? bhi : d);
  const int64_t q = p + d < cap - 1 ? p + d : cap - 1;
  c[row + p] = a[row + q];
}

}  // namespace

// a, b, c: (G, cap) int32, contiguous.  Requires 0 <= blo <= bhi and
// G <= 65535.  Returns cudaGetLastError().
extern "C" int cz_compose_windowed(const int32_t* a, const int32_t* b,
                                   int32_t* c, int G, int64_t cap, int blo,
                                   int bhi, void* stream) {
  if (G > 0 && cap > 0) {
    const dim3 grid(static_cast<unsigned>((cap + kThreads - 1) / kThreads),
                    static_cast<unsigned>(G));
    compose_windowed_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        a, b, c, cap, blo, bhi);
  }
  return static_cast<int>(cudaGetLastError());
}
