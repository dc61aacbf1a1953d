// Move-to-front undo of the bzip2 block decode for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this stage as two lax.scans over
// the 512 steps of every chunk (compressjs_tpu/ops/jax_kernels.py:617,
// mtf_decode).  In PyTorch each scan step is ~10 small launches, ~10,000
// a -9 block, so the two scans become two kernels:
//
//   cz_mtf_undo_perm:   each 512-index chunk applied to the identity
//                       list gives the chunk's permutation;
//   cz_mtf_undo_decode: each chunk decodes from its start list (the
//                       composition scan of the permutations, which the
//                       wrapper runs between the launches).
//
// A step at index j moves the value at position j to the front, and
// positions 0..j-1 up by one.  An index outside [0, 256) moves value 0
// to the front (an index past the list shifts the whole row), as the
// JAX package's masked select does; rle2_decode gives none, but the
// plain version and this kernel agree on them.
//
// What bounds it: the chain of 512 dependent steps per chunk, not its
// ~7 MB of traffic (int32 indices in, int32 values out, 256-byte lists).
// Chunks are independent, so one warp owns one chunk and the card runs
// ~1,800 chains side by side.  The list lives in registers by position:
// lane l holds positions 8l..8l+7.  A step is three shuffles (the index,
// the value at j from the lane that holds it, and the carry of each
// lane's last position into the next lane's first) and predicated
// register moves.  Indices are read 32 at a time (one coalesced load
// per lane) and broadcast by shuffle; the decode writes the 32 values
// of a group in one coalesced store.  Steps past n read index 0, which
// leaves the list as it is, and write nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkLen = 512;  // ops/block_decode.py CHUNK_LEN
constexpr int kWidth = 256;     // ops/block_decode.py WIDTH
constexpr int kWarpsPerBlock = 4;
constexpr int kSlots = 8;  // kWidth / 32 positions per lane
constexpr unsigned kFull = 0xffffffffu;

// One move-to-front step at index j on the warp's list (position
// kSlots * lane + s in v[s]).  Returns the value moved to the front, the
// same in every lane.
__device__ __forceinline__ int mtf_step(int (&v)[kSlots], int j,
                                        int lane) {
  const bool inside = j >= 0 && j < kWidth;
  const int at = inside ? j : 0;
  // the value at j in the lane that holds it, picked with masks: a chain
  // of selects here was compiled as an indexed load, which put the list
  // in local memory and made the step three times slower
  int held = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    held |= v[s] & -static_cast<int>((at & 7) == s);
  int moved = __shfl_sync(kFull, held, at >> 3);
  moved = inside ? moved : 0;
  const int carry = __shfl_up_sync(kFull, v[kSlots - 1], 1);
  const int p0 = kSlots * lane;
#pragma unroll
  for (int s = kSlots - 1; s > 0; --s)
    v[s] = (p0 + s <= j) ? v[s - 1] : v[s];
  v[0] = lane == 0 ? moved : ((p0 <= j) ? carry : v[0]);
  return moved;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mtf_undo_perm_kernel(const int32_t* __restrict__ idx,
                     uint8_t* __restrict__ perm, int64_t n, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // uniform across the warp

  int v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = kSlots * lane + s;

  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  for (int t = 0; t < kChunkLen; t += 32) {
    const int64_t i = base + t + lane;
    const int mine = i < n ? idx[i] : 0;
#pragma unroll 4
    for (int q = 0; q < 32; ++q)
      mtf_step(v, __shfl_sync(kFull, mine, q), lane);
  }
  uint8_t* row = perm + static_cast<int64_t>(chunk) * kWidth + kSlots * lane;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) row[s] = static_cast<uint8_t>(v[s]);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mtf_undo_decode_kernel(const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ lists,
                       int32_t* __restrict__ out, int64_t n,
                       int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // uniform across the warp

  const uint8_t* row =
      lists + static_cast<int64_t>(chunk) * kWidth + kSlots * lane;
  int v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = row[s];

  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  for (int t = 0; t < kChunkLen; t += 32) {
    const int64_t i = base + t + lane;
    const bool live = i < n;
    const int mine = live ? idx[i] : 0;
    int value = 0;
#pragma unroll 4
    for (int q = 0; q < 32; ++q) {
      const int moved = mtf_step(v, __shfl_sync(kFull, mine, q), lane);
      value = (lane == q) ? moved : value;
    }
    if (live) out[i] = value;
  }
}

int blocks_for(int n_chunks) {
  return (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

// idx: (n,) int32 MTF indices; perm: (n_chunks, 256) uint8 out, row c
// the list after chunk c's indices are applied to the identity.
// Requires n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_undo_perm(const int32_t* idx, uint8_t* perm,
                                int64_t n, int n_chunks, void* stream) {
  if (n_chunks > 0) {
    mtf_undo_perm_kernel<<<blocks_for(n_chunks), kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        idx, perm, n, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx: (n,) int32 MTF indices; lists: (n_chunks, 256) uint8, row c the
// list before chunk c; out: (n,) int32 values.  Requires
// n_chunks == ceil(n / 512).  Returns cudaGetLastError().
extern "C" int cz_mtf_undo_decode(const int32_t* idx, const uint8_t* lists,
                                  int32_t* out, int64_t n, int n_chunks,
                                  void* stream) {
  if (n_chunks > 0) {
    mtf_undo_decode_kernel<<<blocks_for(n_chunks), kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        idx, lists, out, n, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
