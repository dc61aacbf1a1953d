// Move-to-front undo of the bzip2 block decode for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this stage as two lax.scans over
// the 512 steps of every chunk and an associative composition scan
// between them (compressjs_tpu/ops/jax_kernels.py:617, mtf_decode).  Here
// the whole stage is three launches, with nothing between them:
//
//   cz_mtf_undo_perm:   each 512-index chunk applied to the identity list
//                       gives the chunk's permutation; each block of
//                       kTileChunks chunks also composes its chunks'
//                       permutations into the tile's;
//   cz_mtf_undo_prefix: one block composes the tiles' permutations in
//                       order: the list before each tile;
//   cz_mtf_undo_decode: each block rebuilds its chunks' start lists from
//                       the tile's list and its chunks' permutations, and
//                       every chunk decodes.
//
// A step at index j moves the value at position j to the front, and
// positions 0..j-1 up by one.  An index outside [0, 256) puts value 0 at
// the front (an index past the list shifts the whole row, a negative one
// shifts nothing), as the JAX package's masked select does; rle2_decode
// gives none, but the plain version and this kernel agree on them.
//
// What bounded the first design: every step was a pass over the
// whole 256-entry list, 8 positions in each lane (~55 integer
// instructions a warp a step, whatever j).  With up to 4 warps on an SM
// a launch took the same time at 1 and at 528 chunks (the chain of 512
// steps, ~190 cycles a step); at the main path's 13-16 warps per SM it
// took 2.9x longer: the integer pipe's issue rate set it (PERF.md
// section 6, tools/torch_mtf_profile.py).  On bzip2's data j is small: on
// sample5's first block 81 % of the indices are 0 and 99.4 % are below
// 32.  So the work of a step now follows j:
//
// * The list lives in registers by position: position `lane` in `front`,
//   positions 32 + kTail * lane + k in tail[k].
// * An index 0 changes nothing and outputs the front.  One pass over the
//   chunk (all its loads in flight at once) stages its non-zero indices in
//   shared memory, in order, with the ranks of the deep ones (j >= 32 or
//   outside the list); only those steps run, and an index's value is
//   what the last staged step at or before it moved.
// * 0 < j < 32 is two shuffles and two selects on `front`, with no
//   branch: the steps between two deep ones run eight at a time, their
//   indices loaded ahead.  A branch per step cost more than the step
//   (the convergence barrier around a warp-synchronous branch).  On
//   sample5 the launch's time is the longest chunk's steps (~490 at
//   ~65-80 cycles; tools/torch_mtf_profile.py --phases).
// * A deep step (`any_step`) moves the tail too, also without a branch.
// * The tail is picked with masks, never indexed by a variable, so the
//   list stays in registers (ptxas reports no stack frame).
// * The start lists come from the same source: each block composes its
//   16 chunks' permutations in shared memory, one block composes the
//   tiles' in order, and the decode launch recomposes each chunk's list
//   from its tile's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkLen = 512;  // ops/block_decode.py CHUNK_LEN
constexpr int kWidth = 256;     // ops/block_decode.py WIDTH
constexpr int kTileChunks = 16;  // ops/block_decode.py TILE_CHUNKS
constexpr int kThreads = kTileChunks * 32;  // a warp per chunk
constexpr int kTail = 7;        // (kWidth - 32) / 32 tail slots a lane
constexpr int kGroups = kChunkLen / 32;
constexpr int kPrefixRows = 64;  // tile permutations staged at a time

// CZ_MTF_PROFILE=1 (tools/torch_mtf_profile.py --phases) records each
// chunk's cycles by phase and its step counts; the package's build leaves
// them out.
#ifndef CZ_MTF_PROFILE
#define CZ_MTF_PROFILE 0
#endif
constexpr bool kProfile = CZ_MTF_PROFILE != 0;
constexpr int kProfileChunks = 4096;
constexpr int kPhases = 8;  // 4 phases' cycles, steps, deep steps, spare
__device__ long long g_perm_phases[kProfile ? kProfileChunks * kPhases : 1];
__device__ long long g_decode_phases[kProfile ? kProfileChunks * kPhases
                                              : 1];

// Records the cycles since `t` as phase q of `phases` and restarts `t`.
__device__ __forceinline__ void mark(long long (&phases)[kPhases], int q,
                                     long long& t) {
  if (kProfile) {
    const long long now = clock64();
    phases[q] = now - t;
    t = now;
  }
}

// Writes one chunk's phases and step counts (lane 0, profile build only).
__device__ __forceinline__ void keep_phases(long long* dst,
                                            long long (&phases)[kPhases],
                                            int2 counts, int chunk,
                                            int lane) {
  if (kProfile && lane == 0 && chunk < kProfileChunks) {
    phases[4] = counts.x;
    phases[5] = counts.y;
#pragma unroll
    for (int q = 0; q < kPhases; ++q) dst[kPhases * chunk + q] = phases[q];
  }
}
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tail_pos(int lane, int k) {
  return 32 + kTail * lane + k;
}

// One step at any non-zero index j in [-1, 256] (the same in every
// lane), with no branch; returns the value moved to the front.
__device__ __forceinline__ int any_step(int& front, int (&tail)[kTail],
                                        int j, int lane) {
  const int q = max(j - 32, 0);
  const int owner = min(q / kTail, 31);
  const int k = q - owner * kTail;
  int held = 0;
#pragma unroll
  for (int s = 0; s < kTail; ++s) held |= tail[s] & -static_cast<int>(k == s);
  const int in_front = __shfl_sync(kFull, front, j & 31);
  const int in_tail = __shfl_sync(kFull, held, owner);
  const int moved = j < 1 ? 0 : (j < 32 ? in_front : (j < kWidth ? in_tail
                                                                   : 0));
  const int up = __shfl_up_sync(kFull, front, 1);
  const int last_front = __shfl_sync(kFull, front, 31);
  int carry = __shfl_up_sync(kFull, tail[kTail - 1], 1);
  carry = lane == 0 ? last_front : carry;
#pragma unroll
  for (int s = kTail - 1; s > 0; --s)
    tail[s] = tail_pos(lane, s) <= j ? tail[s - 1] : tail[s];
  tail[0] = tail_pos(lane, 0) <= j ? carry : tail[0];
  front = lane == 0 ? moved : (lane <= j ? up : front);
  return moved;
}

// A warp's staging of one chunk's steps in shared memory: the chunk's
// non-zero indices in order (outside [0, 256) clamped to -1 or 256, which
// act the same), the ranks among them of the deep ones (j >= 32 or
// outside the list) and the value each step moved.
struct Steps {
  int16_t j[kChunkLen];
  int16_t deep[kChunkLen];
  uint8_t moved[kChunkLen];
};

// Loads the chunk's kGroups groups of 32 indices (all loads in flight at
// once) and stages its non-zero ones; returns (their count, the count of
// deep ones).
__device__ __forceinline__ int2 compact(const int32_t* __restrict__ idx,
                                        int64_t base, int64_t n, int lane,
                                        int (&v)[kGroups], Steps& st) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t i = base + 32 * g + lane;
    v[g] = i < n ? __ldg(idx + i) : 0;
  }
  const unsigned below = (1u << lane) - 1u;
  int count = 0, n_deep = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const unsigned walked = __ballot_sync(kFull, v[g] != 0);
    const bool deep = v[g] < 0 || v[g] >= 32;
    const unsigned deeps = __ballot_sync(kFull, deep);
    const int rank = count + __popc(walked & below);
    if (v[g] != 0)
      st.j[rank] = static_cast<int16_t>(min(max(v[g], -1), kWidth));
    if (deep) st.deep[n_deep + __popc(deeps & below)] =
        static_cast<int16_t>(rank);
    count += __popc(walked);
    n_deep += __popc(deeps);
  }
  __syncwarp();
  return make_int2(count, n_deep);
}

// A step at 0 < j < 32, which touches only `front`: its chain is one
// shuffle and a select.
__device__ __forceinline__ int front_step(int& front, int j, int lane) {
  const int moved = __shfl_sync(kFull, front, j);
  const int up = __shfl_up_sync(kFull, front, 1);
  front = lane == 0 ? moved : (lane <= j ? up : front);
  return moved;
}

// Runs the chunk's staged steps on the warp's list; with keep_moved each
// step's value goes to st.moved.  The steps between two deep ones run
// with no branch, eight at a time with their indices loaded ahead; each
// deep one is an `any_step`, also with no branch inside (a branch per
// step would cost more than the step: PERF.md section 6).
template <bool keep_moved>
__device__ __forceinline__ void run_steps(Steps& st, int2 counts, int& front,
                                          int (&tail)[kTail], int lane) {
  const bool store = keep_moved && lane == 0;
  int r = 0;
  for (int d = 0;; ++d) {
    const int stop = d < counts.y ? st.deep[d] : counts.x;
    for (; r + 8 <= stop; r += 8) {
      int j[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) j[u] = st.j[r + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int moved = front_step(front, j[u], lane);
        if (store) st.moved[r + u] = static_cast<uint8_t>(moved);
      }
    }
    for (; r < stop; ++r) {
      const int moved = front_step(front, st.j[r], lane);
      if (store) st.moved[r] = static_cast<uint8_t>(moved);
    }
    if (d >= counts.y) break;
    const int moved = any_step(front, tail, st.j[r], lane);
    if (store) st.moved[r] = static_cast<uint8_t>(moved);
    ++r;
  }
}

__global__ void __launch_bounds__(kThreads)
mtf_undo_perm_kernel(const int32_t* __restrict__ idx,
                     uint8_t* __restrict__ perm, uint8_t* __restrict__ agg,
                     int64_t n, int n_chunks) {
  __shared__ __align__(16) uint8_t rows[kTileChunks][kWidth];
  __shared__ Steps steps[kTileChunks];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int chunk = blockIdx.x * kTileChunks + w;
  const bool active = chunk < n_chunks;  // uniform across the warp
  long long phases[kPhases] = {}, t = kProfile ? clock64() : 0;

  int front = lane;
  int tail[kTail];
#pragma unroll
  for (int k = 0; k < kTail; ++k) tail[k] = tail_pos(lane, k);
  int2 counts = make_int2(0, 0);
  if (active) {
    int v[kGroups];
    counts = compact(idx, static_cast<int64_t>(chunk) * kChunkLen, n, lane,
                     v, steps[w]);
    mark(phases, 0, t);
    run_steps<false>(steps[w], counts, front, tail, lane);
    mark(phases, 1, t);
  }
  // a chunk past the end keeps the identity, which composes to nothing
  rows[w][lane] = static_cast<uint8_t>(front);
#pragma unroll
  for (int k = 0; k < kTail; ++k)
    rows[w][tail_pos(lane, k)] = static_cast<uint8_t>(tail[k]);
  __syncwarp();
  if (active) {
    const uint2 v = reinterpret_cast<const uint2*>(rows[w])[lane];
    reinterpret_cast<uint2*>(perm + static_cast<int64_t>(chunk) * kWidth)
        [lane] = v;
  }
  __syncthreads();
  // the tile's permutation: list after the tile = list before it
  // indexed by agg, agg[i] = P_0[P_1[...P_15[i]]]
  if (threadIdx.x < kWidth) {
    int x = threadIdx.x;
#pragma unroll
    for (int v = kTileChunks - 1; v >= 0; --v) x = rows[v][x];
    agg[static_cast<int64_t>(blockIdx.x) * kWidth + threadIdx.x] =
        static_cast<uint8_t>(x);
  }
  mark(phases, 2, t);
  if (active) keep_phases(g_perm_phases, phases, counts, chunk, lane);
}

// One block of kWidth threads, thread i holding entry i: lists[t] is the
// list before tile t.  The tile permutations are staged in shared memory
// with cp.async (all of them in flight at once, not one global load's
// latency after another); a step is then a shared-memory gather and a
// barrier.
__global__ void __launch_bounds__(kWidth)
mtf_undo_prefix_kernel(const uint8_t* __restrict__ agg,
                       uint8_t* __restrict__ lists, int n_tiles) {
  __shared__ __align__(16) uint8_t staged[kPrefixRows][kWidth];
  __shared__ uint8_t list[2][kWidth];
  const int i = threadIdx.x;
  int b = 0;
  list[0][i] = static_cast<uint8_t>(i);
  for (int t0 = 0; t0 < n_tiles; t0 += kPrefixRows) {
    const int rows = min(kPrefixRows, n_tiles - t0);
    __syncthreads();  // the previous rows are read, list[b] is written
    const uint8_t* src = agg + static_cast<int64_t>(t0) * kWidth;
    for (int q = i; q < rows * (kWidth / 16); q += kWidth) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(&staged[0][0] + 16 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst), "l"(src + 16 * q));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const uint8_t before = list[b][i];
      lists[static_cast<int64_t>(t0 + r) * kWidth + i] = before;
      list[b ^ 1][i] = list[b][staged[r][i]];
      __syncthreads();
      b ^= 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mtf_undo_decode_kernel(const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ perm,
                       const uint8_t* __restrict__ lists,
                       int32_t* __restrict__ out, int64_t n, int n_chunks) {
  __shared__ __align__(16) uint8_t rows[kTileChunks][kWidth];
  __shared__ uint8_t start[kWidth];
  __shared__ Steps steps[kTileChunks];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int chunk = tile * kTileChunks + w;
  if (chunk < n_chunks) {
    reinterpret_cast<uint2*>(rows[w])[lane] = reinterpret_cast<const uint2*>(
        perm + static_cast<int64_t>(chunk) * kWidth)[lane];
  }
  if (threadIdx.x < kWidth)
    start[threadIdx.x] = lists[static_cast<int64_t>(tile) * kWidth +
                               threadIdx.x];
  __syncthreads();
  if (chunk >= n_chunks) return;  // uniform across the warp
  long long phases[kPhases] = {}, t = kProfile ? clock64() : 0;

  // the list before chunk w of the tile: the tile's list indexed by
  // P_0[P_1[...P_{w-1}[p]]], for the positions this lane holds
  int front = lane;
  int tail[kTail];
#pragma unroll
  for (int k = 0; k < kTail; ++k) tail[k] = tail_pos(lane, k);
  for (int v = w - 1; v >= 0; --v) {
    front = rows[v][front];
#pragma unroll
    for (int k = 0; k < kTail; ++k) tail[k] = rows[v][tail[k]];
  }
  front = start[front];
#pragma unroll
  for (int k = 0; k < kTail; ++k) tail[k] = start[tail[k]];

  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  int v[kGroups];
  mark(phases, 0, t);
  const int2 counts = compact(idx, base, n, lane, v, steps[w]);
  mark(phases, 1, t);
  const int first = __shfl_sync(kFull, front, 0);
  run_steps<true>(steps[w], counts, front, tail, lane);
  __syncwarp();
  mark(phases, 2, t);
  // an index's value is what the last non-zero index at or before it
  // moved, or the front the chunk started from
  const unsigned upto = 0xffffffffu >> (31 - lane);
  int done = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t i = base + 32 * g + lane;
    const unsigned walked = __ballot_sync(kFull, v[g] != 0);
    const int le = done + __popc(walked & upto);
    if (i < n) out[i] = le ? steps[w].moved[le - 1] : first;
    done += __popc(walked);
  }
  mark(phases, 3, t);
  keep_phases(g_decode_phases, phases, counts, chunk, lane);
}

int tiles_for(int n_chunks) {
  return (n_chunks + kTileChunks - 1) / kTileChunks;
}

}  // namespace

// idx: (n,) int32 MTF indices; perm: (n_chunks, 256) uint8 out, row c the
// list after chunk c's indices are applied to the identity; agg:
// (ceil(n_chunks / 16), 256) uint8 out, row t the same for tile t's 16
// chunks.  Requires n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_undo_perm(const int32_t* idx, uint8_t* perm,
                                uint8_t* agg, int64_t n, int n_chunks,
                                void* stream) {
  if (n_chunks > 0) {
    mtf_undo_perm_kernel<<<tiles_for(n_chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        idx, perm, agg, n, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// agg: (n_tiles, 256) uint8 tile permutations; lists: (n_tiles, 256)
// uint8 out, row t the list before tile t.  Returns cudaGetLastError().
extern "C" int cz_mtf_undo_prefix(const uint8_t* agg, uint8_t* lists,
                                  int n_tiles, void* stream) {
  if (n_tiles > 0) {
    mtf_undo_prefix_kernel<<<1, kWidth, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        agg, lists, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx: (n,) int32 MTF indices; perm and lists as the two entry points
// above wrote them; out: (n,) int32 values.  Requires
// n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_undo_decode(const int32_t* idx, const uint8_t* perm,
                                  const uint8_t* lists, int32_t* out,
                                  int64_t n, int n_chunks, void* stream) {
  if (n_chunks > 0) {
    mtf_undo_decode_kernel<<<tiles_for(n_chunks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        idx, perm, lists, out, n, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

#if CZ_MTF_PROFILE
// perm_dst, decode_dst: (n_chunks, 8) int64 out, each chunk's cycles by
// phase (permutation launch: staging, steps, rows and the tile's
// composition; decode launch: start list, staging, steps, writing) and
// its steps and deep steps, from the last launch of each.  Returns the
// CUDA error code.
extern "C" int cz_mtf_undo_phases(void* perm_dst, void* decode_dst,
                                  int n_chunks) {
  const size_t bytes = sizeof(long long) * kPhases *
                       (n_chunks < kProfileChunks ? n_chunks
                                                  : kProfileChunks);
  const int rc = static_cast<int>(
      cudaMemcpyFromSymbol(perm_dst, g_perm_phases, bytes));
  return rc ? rc : static_cast<int>(cudaMemcpyFromSymbol(
                       decode_dst, g_decode_phases, bytes));
}
#endif
