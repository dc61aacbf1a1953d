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
// The lanes of a block interleave their trees: node i of the block's
// lane k is word i * blockDim.x + k, so the lanes' reads of one node (the
// root, above all) fall in distinct banks.

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

// Lanes a block for trees of 2 * max_n words: kLanesPerBlock, fewer where
// those would pass kSmemBytes.
inline int lanes_per_block(int max_n) {
  const int fit = kSmemBytes / (8 * max_n);
  return fit < 1 ? 1 : (fit < kLanesPerBlock ? fit : kLanesPerBlock);
}

}  // namespace fenwick
