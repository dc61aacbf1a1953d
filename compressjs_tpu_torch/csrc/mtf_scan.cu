// Chunked move-to-front scan for Hopper (sm_90a).
//
// Replaces compressjs_tpu/ops/pallas_kernels.py:_mtf_kernel (launched by
// mtf_chunks).  Each chunk of kChunkLen symbols starts from its own
// symbol -> position table (computed by ops.block_kernels.
// _chunk_start_positions); for every symbol s the coded index is
// j = pos[s], every entry with pos < j moves up by one and pos[s] = 0.
//
// What bounds it: the chain of kChunkLen dependent steps per chunk, not
// its ~9 MB of traffic (int32 symbols in, start tables, int32 indices
// out).  The TPU kernel walked chunks in the lane dimension of one core;
// here chunks are independent, so one warp owns one chunk and the card
// runs ~1,800 chains side by side.  The 256-entry table lives in
// registers, 8 entries per lane (symbol s sits in slot s >> 5 of lane
// s & 31); a warp shuffle broadcasts j from the owning lane, and every
// lane bumps its 8 entries with predicated adds, so a step is two
// shuffles and ~30 ALU instructions with no shared-memory traffic.
// Symbols are read 32 at a time (one coalesced load per lane) and
// broadcast by shuffle; the 32 codes of a group are written back in one
// coalesced store.  The ragged last chunk is masked against n.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunkLen = 512;  // ops/block_kernels.py CHUNK_LEN
constexpr int kWarpsPerBlock = 4;
constexpr int kSlots = 8;  // 256 table entries / 32 lanes
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mtf_scan_kernel(const int32_t* __restrict__ data,
                const int32_t* __restrict__ starts,
                int32_t* __restrict__ out, int64_t n, int n_chunks,
                int width) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // uniform across the warp

  // symbols >= width never occur; their entries keep a position >= width,
  // above every coded index, so they are never bumped
  int pos[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int s = 32 * k + lane;
    pos[k] = s < width ? starts[static_cast<int64_t>(chunk) * width + s]
                       : s;
  }

  const int64_t base = static_cast<int64_t>(chunk) * kChunkLen;
  for (int t = 0; t < kChunkLen; t += 32) {
    const int64_t i = base + t + lane;
    const bool live = i < n;
    const int mine = live ? data[i] : 0;
    int code = 0;
#pragma unroll 4
    for (int q = 0; q < 32; ++q) {
      const int s = __shfl_sync(kFull, mine, q);
      const int slot = s >> 5;
      const int owner = s & 31;
      int held = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) held = (k == slot) ? pos[k] : held;
      const int j = __shfl_sync(kFull, held, owner);
      const bool own = lane == owner;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        pos[k] = (own && k == slot) ? 0 : pos[k] + (pos[k] < j);
      code = (lane == q) ? j : code;
    }
    if (live) out[i] = code;
  }
}

}  // namespace

// data: (n,) int32 dense symbols < width; starts: (n_chunks, width) int32;
// out: (n,) int32.  Requires width <= 256 and
// n_chunks == ceil(n / kChunkLen).  Returns cudaGetLastError().
extern "C" int cz_mtf_scan(const int32_t* data, const int32_t* starts,
                           int32_t* out, int64_t n, int n_chunks,
                           int width, void* stream) {
  const int blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    mtf_scan_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        data, starts, out, n, n_chunks, width);
  }
  return static_cast<int>(cudaGetLastError());
}
