// Chunked move-to-front encode for Hopper (sm_90a).
//
// Replaces compressjs_tpu/ops/pallas_kernels.py:_mtf_kernel (launched by
// mtf_chunks) together with the start tables the JAX package builds for
// it (jax_kernels.py:365, _chunk_start_positions).  The stage is three
// launches, with nothing between them:
//
//   cz_mtf_encode_tiles:  the last occurrence of every symbol in each
//                         tile of kTileChunks chunks;
//   cz_mtf_encode_prefix: one block max-scans them over the tiles: the
//                         last occurrence of every symbol before each
//                         tile (virtual occurrences -(s + 1) for symbols
//                         not seen yet);
//   cz_mtf_encode:        each block finds the last occurrences before
//                         each of its chunks (the tile's, and those of
//                         the chunks before it in the tile), each warp
//                         ranks its chunk's 256 of them into the chunk's
//                         start list and encodes the chunk.
//
// The list before chunk c is every symbol ordered by its last occurrence
// before c, most recent first, symbols never seen after them in symbol
// order; a symbol's code j is its position, and it then moves to the
// front.
//
// What bounded the first design: every step bumped the whole
// 256-entry position table, 8 entries in each lane (~60 integer
// instructions a warp a step, whatever j).  With up to 4 warps on an SM
// a launch took the same time at 1 and at 528 chunks (the chain of 512
// steps, ~190 cycles a step); at the main path's 13-16 warps per SM it
// took 2.8x longer: the integer pipe's issue rate set it (PERF.md
// section 6, tools/torch_mtf_profile.py).  On bzip2's data the codes are
// small: on sample5's first block 81 % are 0 and 99.4 % are below 32.
// So the work of a step now follows j:
//
// * The list lives in registers by position: position `lane` in `front`,
//   positions 32 + kTail * lane + k in tail[k].
// * A symbol equal to the one before it codes 0 and changes nothing.
//   One pass over the chunk (all its loads in flight at once) records each
//   symbol's last position and stages the other symbols in shared memory,
//   in order (the first compares with the symbol before the chunk, the
//   start list's front); only those steps run.
// * The staged steps run in two passes, neither with a branch per step
//   (a branch around warp-synchronous code costs a convergence barrier,
//   more than a step).  Pass 1 moves the front for every step as if the
//   symbol were in it, eight at a time with their symbols loaded ahead:
//   a ballot finds it, lanes at or below it (all lanes if it is not
//   there) take the entry before them, lane 0 takes the symbol; so the
//   front comes out right either way, and a step that missed keeps the
//   entry its front pushed out.  Pass 2 runs only the steps that missed
//   (0.6 % of sample5's steps, 87 % of uniform symbols') on the tail,
//   which no other step touches: the one lane holding the symbol adds up
//   its position and a warp reduction hands it to all.  On sample5 the
//   launch's time is the longest chunk's pass 1 (~470 steps at ~90
//   cycles; tools/torch_mtf_profile.py --phases).
// * Nothing is indexed by a variable, so the list stays in registers
//   (ptxas reports no stack frame).
// * The rank of a chunk's 256 last occurrences is a bitonic sort in the
//   warp's registers, 8 keys a lane, shuffles for the strides of 8 and
//   more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkLen = 512;   // ops/block_kernels.py CHUNK_LEN
constexpr int kWidth = 256;
constexpr int kTileChunks = 16;  // ops/block_kernels.py TILE_CHUNKS
constexpr int kThreads = kTileChunks * 32;  // a warp per chunk
constexpr int kTail = 7;         // (kWidth - 32) / 32 tail slots a lane
constexpr int kKeys = kWidth / 32;
constexpr int kGroups = kChunkLen / 32;

// CZ_MTF_PROFILE=1 (tools/torch_mtf_profile.py --phases) records each
// chunk's cycles by phase and its step counts; the package's build leaves
// them out.
#ifndef CZ_MTF_PROFILE
#define CZ_MTF_PROFILE 0
#endif
constexpr bool kProfile = CZ_MTF_PROFILE != 0;
constexpr int kProfileChunks = 4096;
constexpr int kPhases = 8;  // 5 phases' cycles, steps, deep steps, spare
__device__ long long g_phases[kProfile ? kProfileChunks * kPhases : 1];

// Records the cycles since `t` as phase q of `phases` and restarts `t`.
__device__ __forceinline__ void mark(long long (&phases)[kPhases], int q,
                                     long long& t) {
  if (kProfile) {
    const long long now = clock64();
    phases[q] = now - t;
    t = now;
  }
}

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tail_pos(int lane, int k) {
  return 32 + kTail * lane + k;
}

// Records each symbol's last position of the kChunkLen of chunk `chunk` in
// last[] (initialised to -1 by the caller): per group of 32 the last lane
// of each run of equal symbols takes an atomicMax.
__device__ __forceinline__ void last_occurrences(
    const int32_t* __restrict__ data, int64_t n, int chunk, int lane,
    int* last) {
  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  for (int t = 0; t < kChunkLen; t += 32) {
    const int64_t i = base + t + lane;
    const int s = i < n ? __ldg(data + i) : -1;
    const int after = __shfl_down_sync(kFull, s, 1);
    if (static_cast<unsigned>(s) < kWidth && (lane == 31 || after != s))
      atomicMax(last + s, static_cast<int>(i));
  }
}

__global__ void __launch_bounds__(kThreads)
mtf_tiles_kernel(const int32_t* __restrict__ data, int32_t* __restrict__ agg,
                 int64_t n, int n_chunks) {
  __shared__ int last[kWidth];
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kTileChunks + (threadIdx.x >> 5);
  if (threadIdx.x < kWidth) last[threadIdx.x] = -1;
  __syncthreads();
  if (chunk < n_chunks) last_occurrences(data, n, chunk, lane, last);
  __syncthreads();
  if (threadIdx.x < kWidth)
    agg[static_cast<int64_t>(blockIdx.x) * kWidth + threadIdx.x] =
        last[threadIdx.x];
}

// One block of kWidth threads, thread s scanning symbol s's column.
__global__ void __launch_bounds__(kWidth)
mtf_prefix_kernel(const int32_t* __restrict__ agg, int32_t* __restrict__ pre,
                  int n_tiles) {
  const int s = threadIdx.x;
  int run = -1 - s;
#pragma unroll 32
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t at = static_cast<int64_t>(t) * kWidth + s;
    pre[at] = run;
    run = max(run, __ldg(agg + at));
  }
}

// Sorts the warp's 256 keys (kKeys in each lane, key e = kKeys * lane + r
// in key[r]) into descending order.
__device__ __forceinline__ void bitonic_desc(int (&key)[kKeys], int lane) {
#pragma unroll
  for (int k = 2; k <= kWidth; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kKeys) {  // partner in lane ^ (j / kKeys), same slot
        const bool lower = (lane & (j / kKeys)) == 0;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const int e = kKeys * lane + r;
          const bool desc = (e & k) == 0;
          const int other = __shfl_xor_sync(kFull, key[r], j / kKeys);
          const bool keep_max = lower == desc;
          key[r] = keep_max ? max(key[r], other) : min(key[r], other);
        }
      } else {  // partner in the same lane
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          if (r & j) continue;
          const int e = kKeys * lane + r;
          const bool desc = (e & k) == 0;
          const int a = key[r], b = key[r + j];
          key[r] = desc ? max(a, b) : min(a, b);
          key[r + j] = desc ? min(a, b) : max(a, b);
        }
      }
    }
  }
}

// The tail's part of a step for a symbol s not in the front 32 (the same
// in every lane), after the front has shifted: s leaves the tail, the
// entries from position 32 up to its old position move up by one and
// `last` (the front's old last entry) takes position 32.  Returns s's
// code, its old position: the one lane holding s adds it up from its
// slots, and one reduction hands it to every lane.
__device__ __forceinline__ int tail_step(int (&tail)[kTail], int s, int last,
                                         int lane) {
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kTail; ++k)
    mine += tail[k] == s ? tail_pos(lane, k) : 0;
  // a symbol outside the list (none on valid input) finds no position
  // and codes as position 255
  int j = static_cast<int>(__reduce_max_sync(kFull,
                                             static_cast<unsigned>(mine)));
  j = j ? j : kWidth - 1;
  int carry = __shfl_up_sync(kFull, tail[kTail - 1], 1);
  carry = lane == 0 ? last : carry;
#pragma unroll
  for (int k = kTail - 1; k > 0; --k)
    tail[k] = tail_pos(lane, k) <= j ? tail[k - 1] : tail[k];
  tail[0] = tail_pos(lane, 0) <= j ? carry : tail[0];
  return j;
}

// The front's part of a step for symbol s, right whether s is in the
// front 32 or not: lanes at or below its position (all of them if it is
// not there) take the entry before them, lane 0 takes s.  Returns its
// code if it was in the front, kMiss if not, and the entry the front's
// last lane held in `last`.
constexpr int kMiss = 255;

__device__ __forceinline__ int front_step(int& front, int s, int lane,
                                          int& last) {
  const unsigned hit = __ballot_sync(kFull, front == s);
  last = __shfl_sync(kFull, front, 31);
  const int up = __shfl_up_sync(kFull, front, 1);
  const unsigned upto = hit ? hit : 0x80000000u;
  front = lane == 0 ? s : ((upto >> lane) ? up : front);
  return hit ? 31 - __clz(hit) : kMiss;
}

// A warp's staging of one chunk's steps in shared memory: the symbols
// that differ from the one before them, in order, their codes and the
// entry each pushed out of the front 32.
struct __align__(16) Steps {
  uint8_t sym[kChunkLen];
  uint8_t code[kChunkLen];
  uint8_t last[kChunkLen];
};

__global__ void __launch_bounds__(kThreads)
mtf_encode_kernel(const int32_t* __restrict__ data,
                  const int32_t* __restrict__ pre, int32_t* __restrict__ out,
                  int64_t n, int n_chunks) {
  // the chunks' last occurrences share one buffer with the deep steps'
  // ranks, which are written after the start lists are built
  __shared__ __align__(16) int scratch[kTileChunks][kWidth];
  __shared__ __align__(16) uint8_t list[kTileChunks][kWidth];
  __shared__ Steps steps[kTileChunks];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int chunk = tile * kTileChunks + w;
  const bool active = chunk < n_chunks;  // uniform across the warp
  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  Steps& st = steps[w];
  long long phases[kPhases] = {}, t = kProfile ? clock64() : 0;
  int (*last_at)[kWidth] = scratch;
  int16_t* deep = reinterpret_cast<int16_t*>(scratch[w]);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) last_at[w][32 * r + lane] = -1;
  __syncwarp();

  // one pass over the chunk (all loads in flight at once): each symbol's
  // last position, and the symbols that differ from the one before them
  // (for the first, the symbol before the chunk: the start list's front)
  // staged in order; a symbol equal to the one before it codes 0 and
  // changes nothing
  unsigned walked[kGroups];
  int count = 0;
  if (active) {
    int v[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t i = base + 32 * g + lane;
      v[g] = i < n ? __ldg(data + i) : -1;
    }
    int prev_last = chunk > 0 ? __ldg(data + base - 1) : 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int s = v[g];
      const int after = __shfl_down_sync(kFull, s, 1);
      if (static_cast<unsigned>(s) < kWidth && (lane == 31 || after != s))
        atomicMax(&last_at[w][s], static_cast<int>(base + 32 * g + lane));
      int prev = __shfl_up_sync(kFull, s, 1);
      prev = lane == 0 ? prev_last : prev;
      const bool walk = s >= 0 && s != prev;
      walked[g] = __ballot_sync(kFull, walk);
      if (walk)
        st.sym[count + __popc(walked[g] & below)] = static_cast<uint8_t>(s);
      count += __popc(walked[g]);
      prev_last = __shfl_sync(kFull, s, 31);
    }
  }
  __syncthreads();
  mark(phases, 0, t);

  // the last occurrence of each symbol before this chunk, packed with the
  // symbol into a key whose descending order is the start list (ties, -1
  // for symbols not seen, go to the smaller symbol); 257 + before >= 1
  // and < 2^21, so the key fits in 29 bits
  int front = 0;
  int tail[kTail];
  if (active) {
    int key[kKeys];
#pragma unroll
    for (int r = 0; r < kKeys; ++r)
      key[r] = __ldg(pre + static_cast<int64_t>(tile) * kWidth + 32 * r +
                     lane);
    for (int u = 0; u < w; ++u) {
#pragma unroll
      for (int r = 0; r < kKeys; ++r)
        key[r] = max(key[r], last_at[u][32 * r + lane]);
    }
#pragma unroll
    for (int r = 0; r < kKeys; ++r)
      key[r] = ((key[r] + 257) << 8) | (kWidth - 1 - (32 * r + lane));
    bitonic_desc(key, lane);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int r = 0; r < kKeys; ++r) {
      const uint32_t s = kWidth - 1 - (key[r] & (kWidth - 1));
      if (r < 4) lo |= s << (8 * r);
      else hi |= s << (8 * (r - 4));
    }
    reinterpret_cast<uint2*>(list[w])[lane] = make_uint2(lo, hi);
    __syncwarp();
    front = list[w][lane];
#pragma unroll
    for (int k = 0; k < kTail; ++k) tail[k] = list[w][tail_pos(lane, k)];
  }
  __syncthreads();  // every warp has read the last occurrences
  if (!active) return;
  mark(phases, 1, t);

  // pass 1: the front's part of every staged step, eight at a time with
  // their symbols loaded ahead and no branch; the front comes out right
  // whether or not a symbol was in it
  int r = 0;
  for (; r + 8 <= count; r += 8) {
    int s[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] = st.sym[r + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      int last;
      const int j = front_step(front, s[u], lane, last);
      if (lane == 0) {
        st.code[r + u] = static_cast<uint8_t>(j);
        st.last[r + u] = static_cast<uint8_t>(last);
      }
    }
  }
  for (; r < count; ++r) {
    int last;
    const int j = front_step(front, st.sym[r], lane, last);
    if (lane == 0) {
      st.code[r] = static_cast<uint8_t>(j);
      st.last[r] = static_cast<uint8_t>(last);
    }
  }
  __syncwarp();

  mark(phases, 2, t);

  // pass 2: the steps whose symbol was not in the front, in order, on the
  // tail alone (only they move it), each with the entry its step pushed
  // out of the front
  int n_deep = 0;
  for (int g = 0; g < count; g += 32) {
    const bool miss = g + lane < count && st.code[g + lane] == kMiss;
    const unsigned misses = __ballot_sync(kFull, miss);
    if (miss) deep[n_deep + __popc(misses & below)] =
        static_cast<int16_t>(g + lane);
    n_deep += __popc(misses);
  }
  __syncwarp();
  int d = 0;
  for (; d + 4 <= n_deep; d += 4) {
    int at[4], sym[4], out_of_front[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) at[u] = deep[d + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sym[u] = st.sym[at[u]];
      out_of_front[u] = st.last[at[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tail_step(tail, sym[u], out_of_front[u], lane);
      if (lane == 0) st.code[at[u]] = static_cast<uint8_t>(j);
    }
  }
  for (; d < n_deep; ++d) {
    const int at = deep[d];
    const int j = tail_step(tail, st.sym[at], st.last[at], lane);
    if (lane == 0) st.code[at] = static_cast<uint8_t>(j);
  }
  __syncwarp();

  mark(phases, 3, t);

  int done = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t i = base + 32 * g + lane;
    if (i < n)
      out[i] = (walked[g] >> lane) & 1u
                   ? st.code[done + __popc(walked[g] & below)]
                   : 0;
    done += __popc(walked[g]);
  }
  mark(phases, 4, t);
  if (kProfile && lane == 0 && chunk < kProfileChunks) {
    phases[5] = count;
    phases[6] = n_deep;
#pragma unroll
    for (int q = 0; q < kPhases; ++q)
      g_phases[kPhases * chunk + q] = phases[q];
  }
}

int tiles_for(int n_chunks) {
  return (n_chunks + kTileChunks - 1) / kTileChunks;
}

}  // namespace

// data: (n,) int32 symbols < 256; agg: (ceil(n_chunks / 16), 256) int32
// out, row t the last position of each symbol in tile t (-1 if none).
// Requires n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_encode_tiles(const int32_t* data, int32_t* agg,
                                   int64_t n, int n_chunks, void* stream) {
  if (n_chunks > 0) {
    mtf_tiles_kernel<<<tiles_for(n_chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(data, agg, n,
                                                            n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// agg: (n_tiles, 256) int32 as above; pre: (n_tiles, 256) int32 out, row t
// the last position of each symbol before tile t, -(s + 1) for a symbol s
// not seen.  Returns cudaGetLastError().
extern "C" int cz_mtf_encode_prefix(const int32_t* agg, int32_t* pre,
                                    int n_tiles, void* stream) {
  if (n_tiles > 0) {
    mtf_prefix_kernel<<<1, kWidth, 0, static_cast<cudaStream_t>(stream)>>>(
        agg, pre, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// data: (n,) int32 symbols < 256; pre as above; out: (n,) int32 MTF codes,
// each chunk of 512 from the list its own last occurrences give.
// Requires n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_encode(const int32_t* data, const int32_t* pre,
                             int32_t* out, int64_t n, int n_chunks,
                             void* stream) {
  if (n_chunks > 0) {
    mtf_encode_kernel<<<tiles_for(n_chunks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        data, pre, out, n, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

#if CZ_MTF_PROFILE
// dst: (n_chunks, 8) int64 out, each chunk's cycles in loading and
// staging, ranking, pass 1, pass 2 and writing, its steps and deep steps,
// from the last cz_mtf_encode launch.  Returns the CUDA error code.
extern "C" int cz_mtf_encode_phases(void* dst, int n_chunks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_phases, sizeof(long long) * kPhases *
                         (n_chunks < kProfileChunks ? n_chunks
                                                    : kProfileChunks)));
}
#endif
