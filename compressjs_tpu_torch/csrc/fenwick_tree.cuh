// The adaptive Fenwick model's tree, one per lane in shared memory, for the
// encode and decode scans (fenwick_encode.cu, fenwick_decode.cu), and what
// both scans do with a lane's valid bytes.
//
// The tree is the host FenwickModel's heap layout (host/fenwick_model.py,
// and compressjs_tpu/ops/device_model.py's (L, 2 * max_n) array): node i
// has children 2i and 2i + 1, the N leaves of a lane with N symbols sit at
// [N, 2N) (the last one the escape symbol), and each u32 packs two planes,
// the escape counts in its low 16 bits and the symbol counts in its high
// 16.  Nodes in [2N, 2 * max_n) stay 0, as in the JAX array.
//
// Both scans take a block a lane, and the lane's tree sits at word i for
// node i.  One warp keeps it: its 32 threads share each tree operation
// (the *_warp functions, which every thread of the warp calls with its
// lane index).
#pragma once

#include <cstdint>

namespace fenwick {

constexpr uint32_t kEscMask = 0x0000FFFFu;
constexpr uint32_t kSymMask = 0xFFFF0000u;
constexpr uint32_t kScaleMask = 0xFFFEFFFEu;
constexpr int kSymShift = 16;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Internal sums, level by level from the deepest (the plain _sum_tree),
// so that every parent reads final children; the warp takes a level's
// nodes 32 at a time.
__device__ __forceinline__ void sum_tree_warp(uint32_t* t, int N, int lane) {
  for (int lev = 31 - __clz(N - 1); lev >= 0; --lev) {
    const int hi = (2 << lev) < N ? (2 << lev) : N;
    for (int i = (1 << lev) + lane; i < hi; i += 32) {
      t[i] = t[2 * i] + t[2 * i + 1];
    }
    __syncwarp();
  }
}

// host FenwickModel.__init__ by a warp: the nodes of [0, width) zeroed,
// symbols 0 .. N-2 one escape count, the escape symbol N-1 the increment
// in the symbol plane, then the internal sums; returns the root.
__device__ __forceinline__ uint32_t init_tree_warp(uint32_t* t, int N,
                                                   int width,
                                                   uint32_t increment,
                                                   int lane) {
  for (int i = lane; i < width; i += 32) {
    t[i] = i >= N && i < 2 * N - 1 ? 1u
         : (i == 2 * N - 1 ? increment << kSymShift : 0u);
  }
  __syncwarp();
  sum_tree_warp(t, N, lane);
  return t[1];
}

// host FenwickModel._rescale by a warp: each thread halves every 32nd
// symbol leaf (a leaf that still carries an escape count is kept, one
// that halves to 0 gets an escape count), the warp's vote decides whether
// any leaf still carries an escape count, then the escape leaf (0 where
// none does, else halved, at least 1 << 16) and the sums.  Returns the
// new root.  The first
// __syncwarp orders every thread's earlier reads of the tree before the
// writes.
__device__ __forceinline__ uint32_t rescale_warp(uint32_t* t, int N,
                                                 int lane) {
  __syncwarp();
  bool escape = false;
  for (int i = N + lane; i < 2 * N - 1; i += 32) {
    uint32_t p = t[i];
    if (p & kEscMask) {
      escape = true;
      continue;
    }
    p = (p & kScaleMask) >> 1;
    if (p == 0) {
      p = 1;
      escape = true;
    }
    t[i] = p;
  }
  const bool no_escape = !__any_sync(kFullWarp, escape);
  if (lane == 0) {
    const uint32_t p = (t[2 * N - 1] & kScaleMask) >> 1;
    t[2 * N - 1] = no_escape ? 0u : (p == 0 ? 1u << kSymShift : p);
  }
  __syncwarp();
  sum_tree_warp(t, N, lane);
  return t[1];
}

// Words between two levels' sibling columns (walk_warp's `col`): 33, so
// that a walk's stores and a step's reads fall in distinct banks.
constexpr int kSibStride = 33;

// One leaf -> root walk by a warp: thread k takes the path's node
// leaf >> k (the depth is at most 13 < 32), reads its left sibling where
// the node is a right child and adds `update` to the node, the root
// included.  The siblings are never on the path, so the levels are
// independent: one round of shared memory.  Thread k stores its sibling
// (0 off the path or for a left child) at col[k * kSibStride]: their sum
// mod 2^32 (any order gives the serial walk's bits) is lt_f before its
// plane's mask, which the caller adds up when it needs it, off the
// model's chain.  The threads off the path read and write the word
// `spare` (past the tree, never read for a value), so that every thread
// runs the same instructions.  The first __syncwarp orders every
// thread's earlier reads of the tree before the walk's writes.
__device__ __forceinline__ void walk_warp(uint32_t* t, int leaf,
                                          uint32_t update, int spare,
                                          int lane, uint32_t* col) {
  __syncwarp();
  const int n = leaf >> lane;
  const int at = n >= 1 ? n : spare;
  const bool left = n > 1 && (n & 1);
  const uint32_t sib = t[left ? n - 1 : spare];
  t[at] += update;
  col[lane * kSibStride] = left ? sib : 0u;
  __syncwarp();
}

// 1 + the index of the row's last non-zero byte (0 if none), by the whole
// block of kWarps warps: 16-byte loads on the row's aligned middle, bytes
// at its ends.  `red` holds kWarps words; every thread returns the end.
template <int kWarps>
__device__ int64_t valid_end(const uint8_t* __restrict__ row, int64_t n,
                             int64_t* red) {
  constexpr int kThreads = 32 * kWarps;
  const int tid = threadIdx.x;
  int64_t best = 0;
  int64_t head = static_cast<int64_t>(
      (16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
  if (head > n) head = n;
  const int64_t nvec = (n - head) >> 4;
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (int64_t k = tid; k < nvec; k += kThreads) {
    const uint4 w = vec[k];
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    for (int j = 3; j >= 0; --j) {
      if (words[j]) {
        const int64_t at = head + 16 * k + 4 * j +
                           ((31 - __clz(words[j])) >> 3) + 1;
        best = at > best ? at : best;
        break;
      }
    }
  }
  for (int64_t i = tid; i < head; i += kThreads) {
    if (row[i]) best = i + 1 > best ? i + 1 : best;
  }
  for (int64_t i = head + 16 * nvec + tid; i < n; i += kThreads) {
    if (row[i]) best = i + 1 > best ? i + 1 : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(kFullWarp, best, off);
    best = o > best ? o : best;
  }
  if ((tid & 31) == 0) red[tid >> 5] = best;
  __syncthreads();
  best = 0;
  for (int w = 0; w < kWarps; ++w) best = red[w] > best ? red[w] : best;
  return best;
}

}  // namespace fenwick
