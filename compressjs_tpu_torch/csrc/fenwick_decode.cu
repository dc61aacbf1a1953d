// Batched adaptive Fenwick model with its range decoder, for Hopper
// (sm_90a).
//
// No TPU kernel: the JAX package runs this as a lax.scan with one step per
// symbol over L independent lanes (compressjs_tpu/ops/device_model.py:118,
// fenwick_decode_streams, scan at :206), with the decoder's steps
// (compressjs_tpu/ops/device_coder.py:142-195: _dec_normalize,
// dec_cul_freq, dec_update) fused in, since the root -> leaf walk depends
// on each decoded cumulative frequency.  One launch here decodes every
// step of every lane, as the host FenwickModel.decode does:
//
// * a pass in the symbol plane: up to 4 normalise iterations read bytes
//   (a read past the lane's bytes yields 0xFFFFFFFF, the host's -1), then
//   the cumulative frequency, the root -> leaf descent, the update of the
//   path, decode_update, the last-escape removal and the rescale test;
// * where that pass decodes the escape symbol N-1, a second pass in the
//   escape plane gives the symbol.
//
// A masked step changes nothing and writes 1 - N (the JAX scan's symbol
// of a walk that did not move).  The decoder state (low, range, buffer,
// the read position, which must not be negative) comes in and goes out
// per lane, the host coder's export_dec_state seam.
//
// What bounds it: one lane is one chain of dependent steps (per
// sub-decode a normalise, a u32 division, the descent's levels, each a
// shared-memory read and a decision, then decode_update), which nothing
// splits.  Warp 0 runs it, its 32 threads in step (every value of the
// chain is the same in each) so that the tree operations spread over the
// warp; a warp's integer instruction takes two cycles (16 INT32 lanes a
// sub-partition), so the chain's instruction count weighs as much as its
// latency.  The design:
//
// * one lane a block: L lanes fill L SMs (BWTC-L's 128, BWTC-P's 8), and
//   no lane waits on another's escapes or rescales; init_tree_warp and
//   rescale_warp (fenwick_tree.cuh) take the whole tree 32 words at a
//   time;
// * the descent reads only: the serial walk adds the update to a node
//   before it reads the node's child and reads the leaf before updating
//   it, so every word it reads is the tree as it stood before the symbol.
//   A round loads the left children of the next kLevels levels at once
//   (2^kLevels - 1 independent loads), then takes the kLevels decisions
//   in registers, so a sub-decode costs ceil(levels / kLevels) rounds of
//   shared memory, not a read-add-write a level.  The second division
//   (low / help) goes: a decision compares R = min(low, help * tot - 1) -
//   help * lt with help * left, exactly (see sub_decode).  Then thread d
//   reads the path's node at level d and writes it back with the update
//   (and the last-escape removal) added: one round;
// * the lane's bytes sit in a ring in shared memory, staged ahead of the
//   chain: the block stages the first kFirst, then warp 0 loads the next
//   kChunk bytes one group of 32 steps before it stores them, whenever
//   fewer than kLow are staged ahead; a normalise takes its bytes from a
//   four-byte window read from the ring ahead of it.  The chain never
//   waits on a global load;
// * the chain ends at the lane's last valid step: the block first finds
//   it in the lane's valid bytes (16-byte loads); warps 1 to kWarps - 1
//   then write the masked tail's 1 - N, coalesced, while warp 0 decodes.
//   Symbols go out 32 steps at a time (thread k holds step g + k).
//
// Every loop is bounded by T, by the tree's depth and by 4 normalise
// iterations; a lane with N outside [2, max_n] sets *err and decodes
// nothing.

#include <cstdint>
#include <cuda_runtime.h>
#ifdef CZ_DECODE_PROFILE
#include <cstdio>
#endif

#include "fenwick_tree.cuh"

#ifndef CZ_DECODE_LEVELS
#define CZ_DECODE_LEVELS 3
#endif

namespace {

using fenwick::kEscMask;
using fenwick::kFullWarp;
using fenwick::kSymShift;

constexpr uint32_t kBottom = 1u << 23;
constexpr int kExtraBits = 7;
constexpr int kWarps = 4;  // all find the end; 0 decodes, the others the tail
constexpr int kThreads = 32 * kWarps;
// tree levels a descent round takes, and its loads
constexpr int kLevels = CZ_DECODE_LEVELS;
static_assert(kLevels >= 1 && kLevels <= 5, "CZ_DECODE_LEVELS in [1, 5]");
constexpr int kCand = (1 << kLevels) - 1;
// The ring: byte p of the row at ring[p & (kRing - 1)].  A group of 32
// steps reads at most 32 x 2 x 4 = 256 bytes, so at a group's start at
// least kLow - 256 >= 256 + 5 are staged ahead (the window and the byte
// after it, read at the group's end, included), and a chunk stored at
// most kLow + kChunk past the read position overwrites no byte still to
// be read.
constexpr int kRing = 4096;
constexpr int kChunk = 512;  // 16 bytes a thread of warp 0
constexpr int kLow = 1024;
constexpr int kFirst = 2048;
// a row's bytes from the start position on, as the chain counts them
// (a lane reads at most 8 bytes a step)
constexpr int32_t kMaxRow = 1 << 30;
static_assert(kLow - 256 >= 256 + 5 && kLow + kChunk <= kRing &&
                  kFirst <= kRing && kChunk == 32 * 16,
              "ring sizes");

// CZ_DECODE_PROFILE=1 (a build of tools/torch_scan_split.py, never the
// package's): block 0 prints the cycles its chain spends in each part of
// a sub-decode, summed, when the lane ends
#ifdef CZ_DECODE_PROFILE
#define CZ_TICK(k) prof_tick(k)
#else
#define CZ_TICK(k)
#endif

template <bool kEsc>
__device__ __forceinline__ uint32_t plane(uint32_t w) {
  return kEsc ? w & kEscMask : w >> kSymShift;
}

// The lane's model and decoder on warp 0 (every thread holds the same
// values but `lane`).  Positions are 32-bit, counted from the lane's
// start position.  kSafe: no plane's count passes 16 bits (max_prob +
// increment <= 0x10000), so no node's count passes its plane's total.
template <bool kSafe>
struct Chain {
  uint32_t* t;
  const uint8_t* ring;
  int N, width, lane;
  uint32_t root, upd_sym, max_prob;
  uint32_t low, rng, buf;
  uint32_t start;  // the start position mod 2^32 (the ring's index base)
  int32_t adv;     // bytes read since the start
  int32_t avail;   // bytes of the row from the start on
  uint32_t w[4];   // the bytes at adv .. adv + 3, 0xFFFFFFFF past the row
  int root_at[kCand];  // the nodes load_round(1, c) reads
#ifdef CZ_DECODE_PROFILE
  long long prof[5], last;
  __device__ __forceinline__ void prof_tick(int k) {
    const long long now = clock64();
    prof[k] += now - last;
    last = now;
  }
#endif

  // the byte at adv + k, 0xFFFFFFFF past the row
  __device__ __forceinline__ uint32_t byte_at(int k) const {
    return adv + k < avail ? ring[(start + adv + k) & (kRing - 1)]
                           : 0xFFFFFFFFu;
  }

  __device__ __forceinline__ void window() {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = byte_at(k);
  }

  // _dec_normalize: ~0.5 iterations a sub-decode on the paths' streams.
  // Each takes the window's first byte and reads the byte after it, so
  // the chain never waits on the ring.
  __device__ __forceinline__ void normalize() {
#pragma unroll 1
    for (int k = 0; k < 4 && rng <= kBottom; ++k) {
      low = (low << 8) | ((buf << kExtraBits) & 0xFF) |
            (w[0] >> (8 - kExtraBits));
      buf = w[0] & 0xFF;
      rng <<= 8;
      w[0] = w[1];
      w[1] = w[2];
      w[2] = w[3];
      w[3] = byte_at(4);
      ++adv;
    }
  }

  // The left children of the kLevels levels under `base` (< N), clamped
  // into the tree (those of the first level need no clamp).
  __device__ __forceinline__ void load_round(int base, uint32_t* c) const {
#pragma unroll
    for (int s = 0; s < kLevels; ++s) {
#pragma unroll
      for (int p = 0; p < (1 << s); ++p) {
        const int at = ((base << s) + p) << 1;
        c[(1 << s) - 1 + p] = t[s == 0 ? at : min(at, width - 1)];
      }
    }
  }

  // load_round(1, c), its nodes clamped once (root_at)
  __device__ __forceinline__ void load_root(uint32_t* c) const {
#pragma unroll
    for (int j = 0; j < kCand; ++j) c[j] = t[root_at[j]];
  }

  // One host _decode(is_escape): returns the symbol.
  //
  // With help >= 1 and tot >= 1, cul = min(low / help, tot - 1) passes a
  // count C exactly when A = min(low, help * tot - 1) >= help * C, so the
  // descent needs no second division: it keeps R = A - help * lt and goes
  // right where R >= help * left, a count above tot taken as tot (it
  // cannot be passed; no product then passes 2^32; with kSafe there is
  // none).  A degenerate state (help or tot 0) takes the serial form:
  // help 1 and A = cul.
  template <bool kEsc>
  __device__ __forceinline__ int sub_decode() {
    const uint32_t update = kEsc ? upd_sym - 1 : upd_sym;
    const uint32_t tot = plane<kEsc>(root);
    uint32_t c[kCand];
    load_root(c);
    CZ_TICK(0);
    normalize();
    const uint32_t help = rng / (tot > 0 ? tot : 1u);
    uint32_t hh = help, sat = tot, R;
    if (help == 0 || tot == 0) {
      const uint32_t q = low / (help > 0 ? help : 1u);
      R = q >= tot ? tot - 1 : q;
      hh = 1;
      sat = 0xFFFFu;
    } else {
      const uint32_t top = help * tot - 1;
      R = low < top ? low : top;
    }
    CZ_TICK(1);
    // the descent: `node` stops at the leaf
    int node = 1;
    uint32_t lt = 0;
    for (;;) {  // at most depth / kLevels rounds: N <= max_n
      uint32_t lp[kCand], hp[kCand];
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        lp[j] = plane<kEsc>(c[j]);
        hp[j] = hh * (kSafe || lp[j] < sat ? lp[j] : sat);
      }
      bool b[kLevels];
#pragma unroll
      for (int s = 0; s < kLevels; ++s) {
        // the left child under the round's first s decisions, its
        // product and count, picked by the decisions in turn
        uint32_t xh[1 << (kLevels - 1)], xl[1 << (kLevels - 1)];
#pragma unroll
        for (int p = 0; p < (1 << s); ++p) {
          xh[p] = hp[(1 << s) - 1 + p];
          xl[p] = lp[(1 << s) - 1 + p];
        }
#pragma unroll
        for (int r = 0; r < s; ++r) {
          const int h = 1 << (s - 1 - r);
#pragma unroll
          for (int p = 0; p < h; ++p) {
            xh[p] = b[r] ? xh[p + h] : xh[p];
            xl[p] = b[r] ? xl[p + h] : xl[p];
          }
        }
        const bool go = s == 0 || node < N;
        const bool right = go && R >= xh[0];
        b[s] = right;
        R = right ? R - xh[0] : R;
        lt = right ? lt + xl[0] : lt;
        node = go ? 2 * node + right : node;
      }
      if (node >= N) break;
      load_round(node, c);
    }
    CZ_TICK(2);
    // the leaf's word, and thread d's node on the path (level d), both
    // as they stood before the symbol
    const int symbol = node - N;
    const uint32_t vleaf = t[node];
    const int depth = 31 - __clz(node);
    const int mine = lane <= depth ? node >> (depth - lane) : 0;
    const uint32_t old = t[mine];
    const uint32_t sy = plane<kEsc>(vleaf);
    const uint32_t tmp = help * lt;
    rng = lt + sy < tot ? help * sy : rng - tmp;
    low -= tmp;
    // the update along the path; coding the escape symbol while one
    // escape count is left removes its last count (the leaf then 0)
    const uint32_t upd =
        symbol == N - 1 && ((root + update) & kEscMask) == 1 ? 0u - vleaf
                                                              : update;
    __syncwarp();
    if (mine) t[mine] = old + upd;
    root += upd;
    __syncwarp();
    CZ_TICK(3);
    if ((root >> kSymShift) >= max_prob) {
      root = fenwick::rescale_warp(t, N, lane);
    }
    CZ_TICK(4);
    return symbol;
  }
};

template <bool kSafe>
__global__ void __launch_bounds__(kThreads) fenwick_decode_kernel(
    const uint8_t* __restrict__ payload, int64_t B,
    int64_t* __restrict__ state, const int32_t* __restrict__ Ns,
    const uint8_t* __restrict__ valid, int64_t T, int max_n,
    uint32_t max_prob, uint32_t increment, int32_t* __restrict__ out,
    int32_t* __restrict__ err) {
  extern __shared__ uint32_t tree[];
  __shared__ int64_t red[kWarps];
  __shared__ uint8_t ring[kRing];
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int N = Ns[l];
  if (N < 2 || N > max_n) {
    if (threadIdx.x == 0) atomicOr(err, 1);
    return;
  }
  const int width = 2 * max_n;
  const int64_t row = static_cast<int64_t>(l) * T;
  const int64_t end = fenwick::valid_end<kWarps>(valid + row, T, red);
  int64_t* st = state + 4 * static_cast<int64_t>(l);
  const int64_t pos0 = st[3];
  const uint8_t* bytes = payload + static_cast<int64_t>(l) * B;
  for (int i = threadIdx.x; i < kFirst; i += kThreads) {
    const int64_t p = pos0 + i;
    if (p >= 0 && p < B) ring[p & (kRing - 1)] = bytes[p];
  }
  uint32_t root = 0;
  if (warp == 0) {
    root = fenwick::init_tree_warp(tree, N, width, increment, lane);
  }
  __syncthreads();
  if (warp > 0) {
    // the masked tail
    for (int64_t s = end + threadIdx.x - 32; s < T; s += kThreads - 32) {
      out[row + s] = 1 - N;
    }
    return;
  }

  Chain<kSafe> c;
  c.t = tree;
  c.ring = ring;
  c.N = N;
  c.width = width;
  c.lane = lane;
  c.root = root;
  c.upd_sym = increment << kSymShift;
  c.max_prob = max_prob;
  c.low = static_cast<uint32_t>(st[0]);
  c.rng = static_cast<uint32_t>(st[1]);
  c.buf = static_cast<uint32_t>(st[2]);
  c.start = static_cast<uint32_t>(pos0);
  c.adv = 0;
  const int64_t avail = B - pos0;
  c.avail = static_cast<int32_t>(avail < 0 ? 0 : (avail > kMaxRow ? kMaxRow
                                                                  : avail));
  c.window();
#pragma unroll
  for (int s = 0; s < kLevels; ++s) {
#pragma unroll
    for (int p = 0; p < (1 << s); ++p) {
      c.root_at[(1 << s) - 1 + p] = min(((1 << s) + p) << 1, width - 1);
    }
  }
  int32_t staged = kFirst;  // the ring holds the bytes below adv = staged
  bool pending = false;
  uint8_t chunk[kChunk / 32];
  bool nv = lane < end && valid[row + lane];
#ifdef CZ_DECODE_PROFILE
  for (int k = 0; k < 5; ++k) c.prof[k] = 0;
  c.last = clock64();
  const long long t_start = c.last;
#endif
  for (int64_t g = 0; g < end; g += 32) {
    if (pending) {
#pragma unroll
      for (int m = 0; m < kChunk / 32; ++m) {
        const int32_t p = staged + lane + 32 * m;
        if (p < c.avail) ring[(c.start + p) & (kRing - 1)] = chunk[m];
      }
      staged += kChunk;
      pending = false;
      __syncwarp();
    }
    if (staged < c.avail && staged - c.adv < kLow) {
#pragma unroll
      for (int m = 0; m < kChunk / 32; ++m) {
        const int32_t p = staged + lane + 32 * m;
        chunk[m] = p < c.avail ? bytes[pos0 + p] : 0;
      }
      pending = true;
    }
    const uint32_t vm = __ballot_sync(kFullWarp, nv);
    const int64_t s = g + 32 + lane;
    nv = s < end && valid[row + s];
    const int n = end - g < 32 ? static_cast<int>(end - g) : 32;
    int32_t mine = 1 - N;
    for (int k = 0; k < n; ++k) {
      int sym = 1 - N;
      if ((vm >> k) & 1) {
        sym = c.template sub_decode<false>();
        if (sym == N - 1) sym = c.template sub_decode<true>();
      }
      if (lane == k) mine = sym;
    }
    if (lane < n) out[row + g + lane] = mine;
  }
#ifdef CZ_DECODE_PROFILE
  if (blockIdx.x == 0 && lane == 0) {
    printf("CZ_DECODE_PROFILE lane 0: steps %lld, cycles %lld: before the "
           "normalise %lld, normalise and division %lld, descent %lld, "
           "update %lld, rescale test %lld\n", (long long)end,
           clock64() - t_start, c.prof[0], c.prof[1], c.prof[2], c.prof[3],
           c.prof[4]);
  }
#endif
  if (lane == 0) {
    st[0] = c.low;
    st[1] = c.rng;
    st[2] = c.buf;
    st[3] = pos0 + c.adv;
  }
}

}  // namespace

// payload (L, B) uint8, each row one lane's bytes; state (L, 4) int64
// (low, range, buffer, read position >= 0) in and out; Ns (L,) int32;
// valid (L, T) uint8; out (L, T) int32 symbols; err (1,) int32, ORed with
// 1 where a lane's N is outside [2, max_n], never cleared.  Requires
// 2 <= max_n <= 4096.  Returns cudaGetLastError().
extern "C" int cz_fenwick_decode(const uint8_t* payload, int64_t B,
                                 int64_t* state, const int32_t* Ns,
                                 const uint8_t* valid, int L, int64_t T,
                                 int max_n, int max_prob, int increment,
                                 int32_t* out, int32_t* err, void* stream) {
  if (L > 0) {
    const size_t smem = sizeof(uint32_t) * 2 * static_cast<size_t>(max_n);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // a root count stays below max_prob + increment (<= 0x10000: 16 bits)
    const bool safe = max_prob >= 0 && increment >= 0 &&
                      static_cast<int64_t>(max_prob) + increment <= 0x10000;
    const uint32_t mp = static_cast<uint32_t>(max_prob);
    const uint32_t inc = static_cast<uint32_t>(increment);
    if (safe) {
      fenwick_decode_kernel<true><<<L, kThreads, smem, st>>>(
          payload, B, state, Ns, valid, T, max_n, mp, inc, out, err);
    } else {
      fenwick_decode_kernel<false><<<L, kThreads, smem, st>>>(
          payload, B, state, Ns, valid, T, max_n, mp, inc, out, err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Tree levels a descent round of cz_fenwick_decode takes (the build's
// CZ_DECODE_LEVELS).
extern "C" int cz_fenwick_decode_levels() { return kLevels; }
