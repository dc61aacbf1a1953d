// The adaptive Fenwick model's tree, one per lane in shared memory, for the
// encode and decode scans (fenwick_encode.cu, fenwick_decode.cu).
//
// The tree is the host FenwickModel's heap layout (host/fenwick_model.py,
// and compressjs_tpu/ops/device_model.py's (L, 2 * max_n) array): node i
// has children 2i and 2i + 1, the N leaves of a lane with N symbols sit at
// [N, 2N) (the last one the escape symbol), and each u32 packs two planes,
// the escape counts in its low 16 bits and the symbol counts in its high
// 16.  Nodes in [2N, 2 * max_n) stay 0, as in the JAX array.
//
// Two layouts:
//
// * one thread a lane (fenwick_decode.cu): the lanes of a block interleave
//   their trees, node i of the block's lane k at word i * blockDim.x + k,
//   so that the lanes' reads of one node (the root, above all) fall in
//   distinct banks (Tree, init_tree, rescale);
// * one warp a lane (fenwick_encode.cu): node i at word i, and the warp's
//   32 threads share each tree operation (the *_warp functions, which
//   every thread of the warp calls with its lane index).
#pragma once

#include <cstdint>

namespace fenwick {

constexpr uint32_t kEscMask = 0x0000FFFFu;
constexpr uint32_t kSymMask = 0xFFFF0000u;
constexpr uint32_t kScaleMask = 0xFFFEFFFEu;
constexpr int kSymShift = 16;
// lanes a block: 16 trees of max_n 258 are 33 KB, inside the 48 KB a
// block gets without opting in
constexpr int kLanesPerBlock = 16;
constexpr int kSmemBytes = 48 * 1024;

struct Tree {
  uint32_t* base;  // the lane's node 0
  int stride;      // blockDim.x
  __device__ __forceinline__ uint32_t& operator[](int i) const {
    return base[i * stride];
  }
};

// Node i's index clamped into [0, width): the JAX package reads
// tree[min(i, width - 1)] for a lane whose step is masked off.
__device__ __forceinline__ int clamp_node(int64_t i, int width) {
  return i < 0 ? 0 : (i >= width ? width - 1 : static_cast<int>(i));
}

// Internal sums, i = N - 1 .. 1 (host FenwickModel._sum_tree).
__device__ __forceinline__ void sum_tree(const Tree& t, int N) {
  for (int i = N - 1; i > 0; --i) t[i] = t[2 * i] + t[2 * i + 1];
}

// host FenwickModel.__init__: symbols 0 .. N-2 carry one escape count, the
// escape symbol N-1 the increment in the symbol plane.
__device__ __forceinline__ void init_tree(const Tree& t, int N, int width,
                                          uint32_t increment) {
  for (int i = 0; i < width; ++i) t[i] = 0;
  for (int i = N; i < 2 * N - 1; ++i) t[i] = 1;
  t[2 * N - 1] = increment << kSymShift;
  sum_tree(t, N);
}

// host FenwickModel._rescale: halve the symbol leaves (a leaf that still
// carries an escape count is kept), give a leaf that halves to 0 an
// escape count, then the escape leaf: 0 where no leaf carries an escape,
// else halved (at least 1 << 16); then the internal sums.
__device__ __forceinline__ void rescale(const Tree& t, int N) {
  bool no_escape = true;
  for (int i = N; i < 2 * N - 1; ++i) {
    uint32_t p = t[i];
    if (p & kEscMask) {
      no_escape = false;
      continue;
    }
    p = (p & kScaleMask) >> 1;
    if (p == 0) {
      p = 1;
      no_escape = false;
    }
    t[i] = p;
  }
  uint32_t p = (t[2 * N - 1] & kScaleMask) >> 1;
  if (no_escape) {
    p = 0;
  } else if (p == 0) {
    p = 1u << kSymShift;
  }
  t[2 * N - 1] = p;
  sum_tree(t, N);
}

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

// init_tree by a warp; returns the root.
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

// rescale by a warp: each thread halves every 32nd symbol leaf, the
// warp's vote decides whether any leaf still carries an escape count,
// then the escape leaf and the sums.  Returns the new root.  The first
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

// Lanes a block for trees of 2 * max_n words: kLanesPerBlock, fewer where
// those would pass kSmemBytes.
inline int lanes_per_block(int max_n) {
  const int fit = kSmemBytes / (8 * max_n);
  return fit < 1 ? 1 : (fit < kLanesPerBlock ? fit : kLanesPerBlock);
}

}  // namespace fenwick
