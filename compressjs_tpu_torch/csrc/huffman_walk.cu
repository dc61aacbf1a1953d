// The bzip2 decode's Huffman walk, stages 1 and 4, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package runs these stages as XLA
// ops: `_window_vals` and `_group_lengths`
// (compressjs_tpu/ops/device_huffman.py:61, :85) and the 50-step chunk
// walk, a `lax.scan` (:313-329).  The port's plain versions
// (compressjs_tpu_torch/ops/device_huffman.py: `_next_maps`,
// `chunk_walk_plain`) issue one tensor operation at a time, some 800
// small launches a block; each stage here is one launch.
//
// Code length.  Under group g's table the code at window v (the 20 bits
// from an offset) has the smallest length L >= min_len[g] with
// (v >> (20 - L)) <= limit[g][L], else 20.  For v >= 0 that test equals
// v < T[g][L] with T = (limit + 1) << (20 - L), 0 for limit < 0 or
// L < min_len, capped at 2^20 (every v is below it).  Each block builds
// T in shared memory, and a length is 20 compare-and-selects against it.
//
// cz_walk_maps (stage 1): for every offset p < cap, val[p] = the 20-bit
// window at payload bit bit0 + p (bytes past the payload read as zero),
// and nxt[g][p] = min(p + len_g(p), cap - 1).  What bounds it: bytes.  It
// writes (1 + G) x cap x 4 B, 117 MB at G = 6 and cap = 2^22, ~35 us at
// 3.35 TB/s, and reads cap / 8 payload bytes.  Its arithmetic, 20
// compare-and-selects a group, is ~40 integer operations per output
// word, about as long as the write at the card's integer rate.  So a
// thread takes four offsets, loads a group's 20 thresholds into
// registers once for all four, and each store of a warp is coalesced.
// The code lengths are not written: stage 4 recomputes the few it needs,
// which saves writing and reading G x cap int32 (100 MB at -9).
//
// cz_chunk_walk (stage 4): one thread per 50-symbol chunk c, from bit
// starts[c] (0 for c >= n_starts): 50 dependent steps of
//   ln = len_g(pos), j = (val[pos] >> (20 - ln)) - base[g][ln],
//   sym = perm[g][clamp(j, 0, 257)], end = pos + ln,
//   pos = min(end, cap - 1),
// with g = sel[c] (clamped into [0, G), as the JAX walk's gathers
// clamp).  What bounds it: the chain.  Each step waits on one load of
// val from L2 (~0.5-0.8 us under load), so a thread takes 50 such waits,
// with 32,768 threads in flight at -9.  The design keeps everything else
// off the chain: the chunk's 20 thresholds sit in registers, bases and
// permutations in shared memory (7.4 KB at G = 6), and the outputs go
// to shared memory, chunk-major, then out in coalesced stores once the
// block's chunks are done.  64 threads a block and 32.6 KB of shared
// memory let every block of a -9 walk (512) be resident at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 20;        // bzip2 code lengths are 1..20
constexpr int kMaxGroups = 6;    // bzip2 has 2..6 tables
constexpr int kLimitW = kBits + 2;
constexpr int kBaseW = kBits + 1;
constexpr int kPermW = 258;
constexpr int kGroupSize = 50;   // symbols a selector covers
constexpr int kMapThreads = 256;
constexpr int kMapPerThread = 4;
constexpr int kWalkThreads = 64;

// T[g][L], L = 1..kBits (entry 0 unused), for groups [0, G): every thread
// of the block takes part; the caller synchronises.
__device__ void build_thresholds(const int32_t* __restrict__ limits,
                                 const int32_t* __restrict__ mins, int G,
                                 int32_t (*thr)[kBits + 1]) {
  for (int i = threadIdx.x; i < G * kBits; i += blockDim.x) {
    const int g = i / kBits, L = i % kBits + 1;
    const int32_t lim = limits[g * kLimitW + L];
    int64_t t = lim < 0 ? 0
                        : (static_cast<int64_t>(lim) + 1) << (kBits - L);
    if (L < mins[g]) t = 0;
    thr[g][L] = static_cast<int32_t>(t < (1 << kBits) ? t : (1 << kBits));
  }
}

__device__ __forceinline__ int code_length(int32_t v,
                                           const int32_t (&t)[kBits + 1]) {
  int ln = kBits;
#pragma unroll
  for (int L = kBits; L >= 1; --L) ln = v < t[L] ? L : ln;
  return ln;
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ b,
                                            int64_t n, int64_t i) {
  return i < n ? static_cast<uint32_t>(__ldg(b + i)) : 0u;
}

__global__ void __launch_bounds__(kMapThreads)
walk_maps_kernel(const uint8_t* __restrict__ payload, int64_t n_bytes,
                 int bit0, int cap, const int32_t* __restrict__ limits,
                 const int32_t* __restrict__ mins, int G,
                 int32_t* __restrict__ val, int32_t* __restrict__ nxt) {
  __shared__ int32_t thr[kMaxGroups][kBits + 1];
  build_thresholds(limits, mins, G, thr);
  __syncthreads();
  const int p0 = blockIdx.x * (kMapThreads * kMapPerThread) + threadIdx.x;
  int32_t v[kMapPerThread] = {};
#pragma unroll
  for (int k = 0; k < kMapPerThread; ++k) {
    const int p = p0 + k * kMapThreads;
    if (p < cap) {
      // the 32 bits from byte q / 8 hold the window: q % 8 + 20 <= 27
      const int64_t q = static_cast<int64_t>(bit0) + p;
      const int64_t b = q >> 3;
      const uint32_t w = byte_at(payload, n_bytes, b) << 24 |
                         byte_at(payload, n_bytes, b + 1) << 16 |
                         byte_at(payload, n_bytes, b + 2) << 8 |
                         byte_at(payload, n_bytes, b + 3);
      v[k] = static_cast<int32_t>((w << (q & 7)) >> (32 - kBits));
      val[p] = v[k];
    }
  }
  for (int g = 0; g < G; ++g) {
    int32_t t[kBits + 1];
#pragma unroll
    for (int L = 1; L <= kBits; ++L) t[L] = thr[g][L];
    int32_t* row = nxt + static_cast<int64_t>(g) * cap;
#pragma unroll
    for (int k = 0; k < kMapPerThread; ++k) {
      const int p = p0 + k * kMapThreads;
      if (p < cap) row[p] = min(p + code_length(v[k], t), cap - 1);
    }
  }
}

__global__ void __launch_bounds__(kWalkThreads)
chunk_walk_kernel(const int32_t* __restrict__ val,
                  const int32_t* __restrict__ sel,
                  const int32_t* __restrict__ starts, int n_starts,
                  const int32_t* __restrict__ limits,
                  const int32_t* __restrict__ bases,
                  const int32_t* __restrict__ perms,
                  const int32_t* __restrict__ mins, int G, int cap,
                  int s_cap, int32_t* __restrict__ syms,
                  int64_t* __restrict__ ends) {
  __shared__ int32_t thr[kMaxGroups][kBits + 1];
  __shared__ int32_t base_s[kMaxGroups][kBaseW];
  __shared__ int32_t perm_s[kMaxGroups][kPermW];
  __shared__ int32_t sym_s[kWalkThreads * kGroupSize];
  __shared__ int32_t end_s[kWalkThreads * kGroupSize];
  build_thresholds(limits, mins, G, thr);
  for (int i = threadIdx.x; i < G * kBaseW; i += kWalkThreads)
    base_s[i / kBaseW][i % kBaseW] = bases[i];
  for (int i = threadIdx.x; i < G * kPermW; i += kWalkThreads)
    perm_s[i / kPermW][i % kPermW] = perms[i];
  __syncthreads();

  const int c0 = blockIdx.x * kWalkThreads;
  const int c = c0 + threadIdx.x;
  if (c < s_cap) {
    const int g = min(max(sel[c], 0), G - 1);
    int32_t t[kBits + 1];
#pragma unroll
    for (int L = 1; L <= kBits; ++L) t[L] = thr[g][L];
    int pos = c < n_starts ? min(max(starts[c], 0), cap - 1) : 0;
    int32_t* sym_out = sym_s + threadIdx.x * kGroupSize;
    int32_t* end_out = end_s + threadIdx.x * kGroupSize;
    for (int step = 0; step < kGroupSize; ++step) {
      const int32_t v = __ldg(val + pos);
      const int ln = code_length(v, t);
      const int32_t j = (v >> (kBits - ln)) - base_s[g][ln];
      sym_out[step] = perm_s[g][min(max(j, 0), kPermW - 1)];
      end_out[step] = pos + ln;
      pos = min(pos + ln, cap - 1);
    }
  }
  __syncthreads();
  // the block's chunks are one stretch of the chunk-major outputs
  const int n_out = min(kWalkThreads, s_cap - c0) * kGroupSize;
  const int64_t o = static_cast<int64_t>(c0) * kGroupSize;
  for (int i = threadIdx.x; i < n_out; i += kWalkThreads) {
    syms[o + i] = sym_s[i];
    ends[o + i] = end_s[i];
  }
}

}  // namespace

// payload: n_bytes uint8; 0 <= bit0 < 8; 1 <= cap <= 2^30; limits (G, 22),
// mins (G,) int32 with 1 <= G <= 6; val (cap,) and nxt (G, cap) int32
// out.  Returns cudaGetLastError().
extern "C" int cz_walk_maps(const uint8_t* payload, int64_t n_bytes,
                            int bit0, int cap, const int32_t* limits,
                            const int32_t* mins, int G, int32_t* val,
                            int32_t* nxt, void* stream) {
  if (cap > 0 && G > 0) {
    const int per_block = kMapThreads * kMapPerThread;
    walk_maps_kernel<<<(cap + per_block - 1) / per_block, kMapThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        payload, n_bytes, bit0, cap, limits, mins, G, val, nxt);
  }
  return static_cast<int>(cudaGetLastError());
}

// val (cap,), sel (s_cap,), starts (n_starts <= s_cap,) int32; limits
// (G, 22), bases (G, 21), perms (G, 258), mins (G,) int32 with
// 1 <= G <= 6; 1 <= cap <= 2^30; syms (s_cap * 50,) int32 and ends
// (s_cap * 50,) int64 out, chunk-major.  Returns cudaGetLastError().
extern "C" int cz_chunk_walk(const int32_t* val, const int32_t* sel,
                             const int32_t* starts, int n_starts,
                             const int32_t* limits, const int32_t* bases,
                             const int32_t* perms, const int32_t* mins,
                             int G, int cap, int s_cap, int32_t* syms,
                             int64_t* ends, void* stream) {
  if (s_cap > 0 && cap > 0 && G > 0) {
    chunk_walk_kernel<<<(s_cap + kWalkThreads - 1) / kWalkThreads,
                        kWalkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        val, sel, starts, n_starts, limits, bases, perms, mins, G, cap,
        s_cap, syms, ends);
  }
  return static_cast<int>(cudaGetLastError());
}
