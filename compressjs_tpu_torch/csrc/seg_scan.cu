// Device-wide inclusive max-scans for Hopper (sm_90a): the rotation
// sorts' group starts and RLE2's running maxima.
//
// Replaces no Pallas kernel.  The port computed these scans with
// torch.cummax, whose CUDA kernel (scan_innermost_dim_with_indices,
// ATen/native/cuda/ScanUtils.cuh) takes a 1-D tensor as one row: one
// thread block on one of the 132 SMs walks the whole array 1,024 elements
// at a time, and writes an int64 index array the port never reads (~2.4 ms
// a call at a -9 block's 899,981 elements).  The JAX package computes the
// same scans with lax.associative_scan (compressjs_tpu/ops/jax_kernels.py
// _seg_start and rle2_encode).
//
// Two entries, one scan:
//   cz_group_start: out[i] = max{ j <= i : diff[j] != 0 }, 0 where there is
//                   none (diff: torch.bool bytes), i.e. torch.cummax of
//                   where(diff, arange(n), 0);
//   cz_max_scan:    out[i] = max(in[0..i]) over int64, any values (the call
//                   sites' are positions in [0, 2^40); nothing is packed
//                   beside a value).
//
// Bound: bytes.  A call reads its input once and writes n int64: 9 bytes an
// element for cz_group_start, 16 for cz_max_scan (8.1 and 14.4 MB at
// 899,981 elements: 0.0024 and 0.0043 ms at 3.35 TB/s; an input written
// just before may sit in the 50 MB L2).  So the design spreads the array
// over every SM and moves each byte in 16-byte accesses, a warp's lanes on
// adjacent addresses:
//
// * reduce-then-scan over tiles of kTile elements (220 tiles at 899,981,
//   1,758 at bwt_block_batch's 8 x 899,981), in two launches: the tiles
//   kernel writes each tile's maximum to agg[tile]; the scan kernel's
//   block t reduces agg[0..t) to its carry while its own loads are in
//   flight, scans its tile and writes it.  A call of one tile is the scan
//   launch alone.  Nothing is kept between calls, so calls on different
//   streams share no state.
// * A tile is kWarps warps, each a run of kWarpItems elements.  int64
//   values: pair p of a lane holds elements 64 p + 2 lane and +1 of its
//   warp's run (one 16-byte load); the warp scans pair by pair with
//   shuffles, carrying the running maximum.  Flags: a lane loads 16 bytes,
//   elements 16 lane .. 16 lane + 15, as a 16-bit mask, and the warp scans
//   the lanes' last set positions; the outputs are then written as pairs
//   in the int64 layout, each lane taking the mask and carry of the lane
//   that loaded them.
// * One __syncthreads a block combines the warps' totals and their parts of
//   the tile carry.  An input or output not 16-byte aligned takes the same
//   code with scalar accesses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 8;                    // 16-byte int64 pairs a lane
constexpr int kWarpItems = 64 * kPairs;      // 512: 32 lanes x 16 flags
constexpr int kTile = kWarps * kWarpItems;   // ops/block_kernels.py SCAN_TILE
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kLowest = -0x7fffffffffffffffLL - 1;

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ long long warp_inclusive_max(long long v,
                                                        int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// This thread's part of the maximum of agg[0..tile), reduced over its warp.
__device__ __forceinline__ long long tile_carry_part(
    const long long* __restrict__ agg, int tile, long long identity) {
  long long c = identity;
  for (int t = threadIdx.x; t < tile; t += kThreads) c = max(c, agg[t]);
  return warp_max(c);
}

// The carry into warp `warp` of its tile: the maximum of the tile's carry
// (each warp's part in `part`) and the totals of the warps before it.
__device__ __forceinline__ long long block_carry(long long total,
                                                 long long part, int warp,
                                                 int lane,
                                                 long long identity) {
  __shared__ long long s_total[kWarps], s_part[kWarps];
  if (lane == 0) {
    s_total[warp] = total;
    s_part[warp] = part;
  }
  __syncthreads();
  long long c = identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    c = max(c, s_part[w]);
    if (w < warp) c = max(c, s_total[w]);
  }
  return c;
}

// The maximum over the block of each thread's `v`, by thread 0.
__device__ __forceinline__ long long block_max(long long v, int warp,
                                               int lane) {
  __shared__ long long s_max[kWarps];
  v = warp_max(v);
  if (lane == 0) s_max[warp] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = max(v, s_max[w]);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void load_pair(const long long* __restrict__ in,
                                          int64_t i, int64_t n, long long& a,
                                          long long& b) {
  if (kVec && i + 1 < n) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(in + i));
    a = v.x;
    b = v.y;
  } else {
    a = i < n ? in[i] : kLowest;
    b = i + 1 < n ? in[i + 1] : kLowest;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_pair(long long* __restrict__ out,
                                           int64_t i, int64_t n, long long a,
                                           long long b) {
  if (kVec && i + 1 < n) {
    *reinterpret_cast<longlong2*>(out + i) = make_longlong2(a, b);
  } else {
    if (i < n) out[i] = a;
    if (i + 1 < n) out[i + 1] = b;
  }
}

// Bit k set where flag i + k is non-zero, for k < 16 and i + k < n.
template <bool kVec>
__device__ __forceinline__ unsigned load_flags(
    const uint8_t* __restrict__ diff, int64_t i, int64_t n) {
  unsigned m = 0;
  if (kVec && i + 16 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(diff + i));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) m |= 1u << k;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i + k < n && diff[i + k]) m |= 1u << k;
  }
  return m;
}

// The last set position of a lane's 16 flags from `at`, 0 if none.
__device__ __forceinline__ long long last_set(unsigned m, int64_t at) {
  return m ? at + 31 - __clz(m) : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
max_tiles_kernel(const long long* __restrict__ in, long long* __restrict__ agg,
                 int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       warp * kWarpItems + 2 * lane;
  long long m = kLowest;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    long long a, b;
    load_pair<kVec>(in, base + 64 * p, n, a, b);
    m = max(m, max(a, b));
  }
  m = block_max(m, warp, lane);
  if (threadIdx.x == 0) agg[blockIdx.x] = m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
max_scan_kernel(const long long* __restrict__ in,
                const long long* __restrict__ agg, long long* __restrict__ out,
                int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       warp * kWarpItems + 2 * lane;
  long long v[2 * kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
    load_pair<kVec>(in, base + 64 * p, n, v[2 * p], v[2 * p + 1]);
  const long long part = tile_carry_part(agg, blockIdx.x, kLowest);
  // the warp's run, pair by pair: `run` is the maximum of the pairs before
  long long run = kLowest;
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const long long incl =
        warp_inclusive_max(max(v[2 * p], v[2 * p + 1]), lane);
    long long excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kLowest;
    v[2 * p] = max(max(run, excl), v[2 * p]);
    v[2 * p + 1] = max(v[2 * p], v[2 * p + 1]);
    run = max(run, __shfl_sync(kFull, incl, 31));
  }
  const long long carry = block_carry(run, part, warp, lane, kLowest);
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
    store_pair<kVec>(out, base + 64 * p, n, max(carry, v[2 * p]),
                     max(carry, v[2 * p + 1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
group_tiles_kernel(const uint8_t* __restrict__ diff,
                   long long* __restrict__ agg, int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kTile +
                     warp * kWarpItems + 16 * lane;
  long long m = last_set(load_flags<kVec>(diff, at, n), at);
  m = block_max(m, warp, lane);
  if (threadIdx.x == 0) agg[blockIdx.x] = m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
group_scan_kernel(const uint8_t* __restrict__ diff,
                  const long long* __restrict__ agg,
                  long long* __restrict__ out, int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t run = static_cast<int64_t>(blockIdx.x) * kTile +
                      warp * kWarpItems;
  const unsigned mask = load_flags<kVec>(diff, run + 16 * lane, n);
  const long long part = tile_carry_part(agg, blockIdx.x, 0);
  const long long incl =
      warp_inclusive_max(last_set(mask, run + 16 * lane), lane);
  long long excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0;
  const long long carry = block_carry(__shfl_sync(kFull, incl, 31), part,
                                      warp, lane, 0);
  // the group start before this lane's 16 flags
  const long long before = max(carry, excl);
  // pair p of this lane: elements e, e + 1 of the run (e = 64 p + 2 lane),
  // loaded by lane e / 16 at bit e % 16 of its mask
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int e = 64 * p + 2 * lane;
    const int owner = e >> 4, bit = e & 15;
    const unsigned m = __shfl_sync(kFull, mask, owner);
    const long long start = __shfl_sync(kFull, before, owner);
    const unsigned below = m & ((1u << bit) - 1u);
    const long long a =
        (m >> bit) & 1u ? run + e
                        : (below ? run + 16 * owner + 31 - __clz(below)
                                 : start);
    const long long b = (m >> (bit + 1)) & 1u ? run + e + 1 : a;
    store_pair<kVec>(out, run + e, n, a, b);
  }
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// in: (n,) int64; out: (n,) int64 out, the inclusive max-scan of in; agg:
// ceil(n / 4096) int64 of scratch (unused, may be null, at n <= 4096).
// Two launches on `stream` (one at n <= 4096).  Returns cudaGetLastError().
extern "C" int cz_max_scan(const int64_t* in, int64_t n, int64_t* out,
                           int64_t* agg, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = tiles_for(n);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles));
  const auto* x = reinterpret_cast<const long long*>(in);
  auto* y = reinterpret_cast<long long*>(out);
  auto* a = reinterpret_cast<long long*>(agg);
  const bool vec = aligned16(in) && aligned16(out);
  if (tiles > 1) {
    if (vec)
      max_tiles_kernel<true><<<grid, kThreads, 0, s>>>(x, a, n);
    else
      max_tiles_kernel<false><<<grid, kThreads, 0, s>>>(x, a, n);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (vec)
    max_scan_kernel<true><<<grid, kThreads, 0, s>>>(x, a, y, n);
  else
    max_scan_kernel<false><<<grid, kThreads, 0, s>>>(x, a, y, n);
  return static_cast<int>(cudaGetLastError());
}

// diff: (n,) bool bytes; out: (n,) int64 out, out[i] the last j <= i with
// diff[j] != 0, or 0 where there is none; agg as for cz_max_scan.  Two
// launches on `stream` (one at n <= 4096).  Returns cudaGetLastError().
extern "C" int cz_group_start(const uint8_t* diff, int64_t n, int64_t* out,
                              int64_t* agg, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = tiles_for(n);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles));
  auto* y = reinterpret_cast<long long*>(out);
  auto* a = reinterpret_cast<long long*>(agg);
  const bool vec = aligned16(diff) && aligned16(out);
  if (tiles > 1) {
    if (vec)
      group_tiles_kernel<true><<<grid, kThreads, 0, s>>>(diff, a, n);
    else
      group_tiles_kernel<false><<<grid, kThreads, 0, s>>>(diff, a, n);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (vec)
    group_scan_kernel<true><<<grid, kThreads, 0, s>>>(diff, a, y, n);
  else
    group_scan_kernel<false><<<grid, kThreads, 0, s>>>(diff, a, y, n);
  return static_cast<int>(cudaGetLastError());
}
