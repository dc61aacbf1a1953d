// Batched adaptive Fenwick model and range coder, encode side, for Hopper
// (sm_90a): one kernel body, three C entries.
//
// No TPU kernel: the JAX package runs the model and the coder as two
// lax.scans with one step per symbol (or triple) over L independent lanes
// (compressjs_tpu/ops/device_model.py:211, fenwick_encode_streams, scan at
// :276; compressjs_tpu/ops/device_coder.py:63, batched_range_encode, scan
// at :108).  The template parameter of encode_kernel picks the entry:
//
// * kCode, cz_fenwick_code: symbols -> coder tokens in one launch.  The
//   model's (sy_f, lt_f, tot_f) triples never leave the block: the model
//   warp hands them, 32 steps at a time, to a coder warp
//   (range_coder.cuh) through a ring in shared memory, and the coder
//   starts from the lane's exported state.
// * kModel, cz_fenwick_encode: the model alone, writing the (L, 2T)
//   triples the JAX function returns, masked slots included.
// * kCoder, cz_range_encode: the coder alone, reading triples.
//
// Per lane and step the model does what the host FenwickModel.encode
// does:
//
// * the leaf of the symbol is read; a symbol with no count in the symbol
//   plane escapes: the escape symbol N-1 is coded first in the symbol
//   plane (slot 2t), then the symbol itself in the escape plane (slot
//   2t + 1);
// * each sub-step walks leaf -> root, summing the left siblings (lt_f) and
//   adding the update on the path and at the root; coding the escape
//   symbol while one escape count is left removes it (update = -leaf);
// * sy_f of the second sub-step comes from the leaf as read before the
//   escape sub-step (the host's quirk, visible when that sub-step
//   rescaled), lt_f and tot_f from the tree after it;
// * after every sub-step, masked ones too, a root of max_prob or more in
//   the symbol plane halves the tree (fenwick_tree.cuh, rescale_warp).
//   The JAX scan rescales every lane that meets that test once any lane
//   does; each lane's result is the same, so each lane tests its own root.
//
// A masked step writes what the JAX scan writes there: sy_f of the
// symbol's clamped leaf, lt_f 0, tot_f of the root, valid 0.
//
// What bounds it: latency.  A lane is two chains of dependent steps: the
// model's (a leaf read, a walk and a rescale test per sub-step) and the
// coder's (three normalise tests, a u32 division and two products per
// triple).  The design shortens the chains, runs the two side by side and
// spreads the lanes:
//
// * one lane a block: L lanes fill L SMs (BWTC-L's 128 lanes, BWTC-P's
//   8), and no lane waits on another's escapes or rescales;
// * the walk takes one level per thread (walk_warp: one shared-memory
//   round, the same instructions in every thread, not ~10 dependent
//   read-add-writes); lt_f, which only the coder needs, is summed from
//   the walks' stored siblings once per 32 steps, off the model's chain;
//   the rescale takes 32 leaves at a time (rescale_warp);
// * the fused entry runs the model on warp 0 and the coder on warp 1, so
//   a step costs the longer of the two chains, not their sum, and no
//   triple goes to device memory (no 13 bytes a slot written and read
//   back, no second launch);
// * the lane's inputs come 32 steps at a time, one coalesced load a
//   thread issued a group ahead, so the chain never waits on a global
//   load; the model's outputs go out 32 steps at a time, coalesced;
// * the chain ends at the lane's last valid step: all the block's warps
//   first find it in the lane's valid bytes (16-byte loads); after it the
//   tree no longer changes (unless its root still passes max_prob, which
//   the chain then walks out step by step), so the model's masked tail is
//   one coalesced pass by the whole block, and the coder skips it.
//
// Every loop is bounded by T, by the tree's size and by 3 normalise
// iterations a triple; a lane with N outside [2, max_n], or an unmasked
// symbol outside [0, N), sets *err and codes nothing (that step, or the
// lane).

#include <cstdint>
#include <cuda_runtime.h>

#include "fenwick_tree.cuh"
#include "range_coder.cuh"

namespace {

using fenwick::kEscMask;
using fenwick::kFullWarp;
using fenwick::kSymMask;
using fenwick::kSymShift;

constexpr int kWarps = 8;  // all find the end; 0 models, 1 codes (kCode)
constexpr int kThreads = 32 * kWarps;

enum Mode { kCode, kModel, kCoder };

struct Args {
  const int32_t* symbols;  // (L, T), model modes
  const uint8_t* valid;    // (L, T) steps, or (L, T) slots for kCoder
  const int32_t* Ns;
  const int32_t* sy_in;  // (L, T) triples, kCoder
  const int32_t* lt_in;
  const int32_t* tot_in;
  const int64_t* init;  // (L, 5) coder states
  int64_t T;
  int max_n;
  uint32_t max_prob, increment;
  int32_t* sy;  // (L, 2T) triples out, kModel
  int32_t* lt;
  int32_t* tot;
  uint8_t* vout;
  int32_t* tokens;  // (L, cap, 3), zeroed by the caller
  int64_t cap;
  int32_t* tok_n;
  int64_t* bytes;
  int32_t* err;
};

struct Triple {
  uint32_t sy, lt, tot;
};

// Node N + sym clamped into [0, width), as the JAX scan reads a masked
// step's leaf (any int32 symbol, no overflow).
__device__ __forceinline__ int leaf_of(int N, int sym, int width) {
  return sym >= width - N ? width - 1 : (sym < -N ? 0 : N + sym);
}

// The model's state on the chain warp: the lane's tree (and the spare
// word after it, walk_warp's), its root (kept in a register by every
// thread, the tree's node 1 beside it), the walks' sibling columns of
// the current group of 32 steps (sub-step a's and b's) and constants.
struct Model {
  uint32_t* t;
  uint32_t* sib_a;
  uint32_t* sib_b;
  int N, width, lane, levels;
  uint32_t root, upd_sym, max_prob;

  __device__ __forceinline__ void rescale_test() {
    if ((root >> kSymShift) >= max_prob) {
      root = fenwick::rescale_warp(t, N, lane);
    }
  }

  // One step of the host encode(sym), or a masked step (act false), as
  // step k of the group: the two slots' triples but for lt_f (see
  // lt_of), a in the symbol plane (valid where `esc`), b in the escape
  // plane where esc, else the symbol plane (valid where act).
  __device__ __forceinline__ void step(int sym, bool act, int k, bool& esc,
                                       Triple& a, Triple& b) {
    const int li = leaf_of(N, sym, width);
    const uint32_t raw = t[li];
    esc = act && (raw & kSymMask) == 0;
    if (esc) {
      const int el = 2 * N - 1;
      const uint32_t rawe = t[el];
      const uint32_t upd =
          (root & kEscMask) == 1 ? 0u - rawe : upd_sym;  // last escape
      a.sy = rawe >> kSymShift;
      a.tot = root >> kSymShift;
      fenwick::walk_warp(t, el, upd, width, lane, sib_a + k);
      root += upd;
    } else {
      a.sy = raw >> kSymShift;
      a.tot = root >> kSymShift;
    }
    rescale_test();
    if (act) {
      uint32_t upd = upd_sym;
      if (esc) {
        upd = upd_sym - 1;
      } else if (sym == N - 1 && (root & kEscMask) == 1) {
        upd = 0u - t[li];  // the escape symbol coded: its last count
      }
      const uint32_t mask = esc ? kEscMask : kSymMask;
      const int shift = esc ? 0 : kSymShift;
      b.sy = (raw & mask) >> shift;
      b.tot = (root & mask) >> shift;
      fenwick::walk_warp(t, li, upd, width, lane, sib_b + k);
      root += upd;
    } else {
      b.sy = raw >> kSymShift;
      b.tot = root >> kSymShift;
    }
    rescale_test();
  }

  // lt_f of the group's step `lane` (the thread that keeps it): the sums
  // of its walks' sibling columns, in each slot's plane; 0 where a slot
  // did not walk.
  __device__ __forceinline__ void lt_of(bool esc, bool act, Triple& a,
                                        Triple& b) const {
    __syncwarp();
    uint32_t sa = 0, sb = 0;
    for (int i = 0; i < levels; ++i) {
      sa += sib_a[i * fenwick::kSibStride + lane];
      sb += sib_b[i * fenwick::kSibStride + lane];
    }
    a.lt = esc ? sa >> kSymShift : 0u;
    b.lt = !act ? 0u : (esc ? sb & kEscMask : sb >> kSymShift);
  }
};

// The fused entry's model warp hands each group of 32 steps to its coder
// warp through a ring of two batches in shared memory: slot 2k + 1 and
// 2k of step k (the escape first), and which are valid.  Named barriers
// 1 + b ("batch b full") and 3 + b ("batch b free") order them, 64
// threads each.
constexpr int kRing = 2;
struct alignas(16) Batch {
  uint32_t sy[64], lt[64], tot[64];
  uint32_t esc, act;  // bit k: slot 2k, slot 2k + 1 valid
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// bits of x at the even positions of the result, bits of y at the odd
__device__ __forceinline__ uint64_t interleave(uint32_t x, uint32_t y) {
  uint64_t v[2] = {x, y};
  for (int k = 0; k < 2; ++k) {
    v[k] = (v[k] | (v[k] << 16)) & 0x0000FFFF0000FFFFull;
    v[k] = (v[k] | (v[k] << 8)) & 0x00FF00FF00FF00FFull;
    v[k] = (v[k] | (v[k] << 4)) & 0x0F0F0F0F0F0F0F0Full;
    v[k] = (v[k] | (v[k] << 2)) & 0x3333333333333333ull;
    v[k] = (v[k] | (v[k] << 1)) & 0x5555555555555555ull;
  }
  return v[0] | (v[1] << 1);
}

template <Mode M>
__global__ void __launch_bounds__(kThreads) encode_kernel(Args p) {
  extern __shared__ uint32_t tree[];
  __shared__ int64_t red[kWarps];
  __shared__ int64_t tail_at;
  __shared__ Batch ring[kRing];
  __shared__ uint32_t sibs[2][32 * fenwick::kSibStride];
  const int l = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t T = p.T;
  const int64_t row = static_cast<int64_t>(l) * T;
  int N = 0;
  if (M != kCoder) {
    N = p.Ns[l];
    if (N < 2 || N > p.max_n) {
      if (threadIdx.x == 0) atomicOr(p.err, 1);
      return;
    }
  }
  const int64_t end = fenwick::valid_end<kWarps>(p.valid + row, T, red);
  // kCoder: warp 0 codes; kCode: warp 0 models, warp 1 codes; kModel:
  // warp 0 models, then every warp writes the static tail
  if (M != kModel && warp > (M == kCode ? 1 : 0)) return;

  range_coder::Encoder coder;
  if (M == kCoder || (M == kCode && warp == 1)) {
    coder.start(p.init + 5 * static_cast<int64_t>(l),
                p.tokens + static_cast<int64_t>(l) * p.cap * 3, p.cap,
                lane == 0);
  }

  if (M == kCoder) {
    // groups of 32 slots, each thread loading one a group ahead; the
    // valid slots of a group in order by the warp's vote
    int32_t nsy = 0, nlt = 0, ntot = 0;
    bool nv = false;
    if (lane < end) {
      nsy = p.sy_in[row + lane];
      nlt = p.lt_in[row + lane];
      ntot = p.tot_in[row + lane];
      nv = p.valid[row + lane] != 0;
    }
    for (int64_t g = 0; g < end; g += 32) {
      const int32_t gsy = nsy, glt = nlt, gtot = ntot;
      uint32_t vm = __ballot_sync(kFullWarp, nv);
      const int64_t s = g + 32 + lane;
      nv = false;
      if (s < end) {
        nsy = p.sy_in[row + s];
        nlt = p.lt_in[row + s];
        ntot = p.tot_in[row + s];
        nv = p.valid[row + s] != 0;
      }
      while (vm) {
        const int k = __ffs(vm) - 1;
        vm &= vm - 1;
        coder.encode(static_cast<uint32_t>(__shfl_sync(kFullWarp, gsy, k)),
                     static_cast<uint32_t>(__shfl_sync(kFullWarp, glt, k)),
                     static_cast<uint32_t>(__shfl_sync(kFullWarp, gtot, k)));
      }
    }
    coder.finish(p.tok_n + l, p.bytes + l);
    return;
  }

  const int64_t batches = (end + 31) >> 5;
  if (M == kCode && warp == 1) {
    // the coder warp: each batch's valid slots in order
    for (int64_t j = 0; j < batches; ++j) {
      const int b = static_cast<int>(j & 1);
      bar_sync(1 + b);
      const Batch& B = ring[b];
      uint64_t vm = interleave(B.esc, B.act);
      while (vm) {
        const int k = __ffsll(static_cast<long long>(vm)) - 1;
        vm &= vm - 1;
        coder.encode(B.sy[k], B.lt[k], B.tot[k]);
      }
      if (j + kRing < batches) bar_arrive(3 + b);
    }
    coder.finish(p.tok_n + l, p.bytes + l);
    return;
  }

  const int width = 2 * p.max_n;
  Model m;
  m.t = tree;
  m.sib_a = sibs[0];
  m.sib_b = sibs[1];
  m.levels = 32 - __clz(2 * p.max_n - 1);
  m.N = N;
  m.width = width;
  m.lane = lane;
  m.upd_sym = p.increment << kSymShift;
  m.max_prob = p.max_prob;
  int64_t tail = end;  // the first step of the model's static tail
  if (warp == 0) {
    m.root = fenwick::init_tree_warp(tree, N, width, p.increment, lane);
    const int64_t orow = 2 * row;
    bool flagged = false;
    int32_t nsym = 0;
    bool nv = false;
    if (lane < end) {
      nsym = p.symbols[row + lane];
      nv = p.valid[row + lane] != 0;
    }
    for (int64_t g = 0; g < end; g += 32) {
      const int32_t gsym = nsym;
      const uint32_t vm = __ballot_sync(kFullWarp, nv);
      const int64_t s = g + 32 + lane;
      nv = false;
      if (s < end) {
        nsym = p.symbols[row + s];
        nv = p.valid[row + s] != 0;
      }
      const int n = end - g < 32 ? static_cast<int>(end - g) : 32;
      // thread k keeps step g + k's two slots
      Triple ka{0, 0, 0}, kb{0, 0, 0};
      bool kesc = false, kact = false;
      int next = __shfl_sync(kFullWarp, gsym, 0);
      for (int k = 0; k < n; ++k) {
        const int sym = next;
        next = __shfl_sync(kFullWarp, gsym, (k + 1) & 31);
        bool act = (vm >> k) & 1;
        if (act && static_cast<unsigned>(sym) >= static_cast<unsigned>(N)) {
          flagged = true;
          act = false;
        }
        bool esc;
        Triple a{}, b{};
        m.step(sym, act, k, esc, a, b);
        if (lane == k) {
          ka = a;
          kb = b;
          kesc = esc;
          kact = act;
        }
      }
      m.lt_of(kesc, kact, ka, kb);
      if (M == kModel) {
        if (lane < n) {
          const int64_t o = orow + 2 * (g + lane);
          *reinterpret_cast<int2*>(p.sy + o) =
              make_int2(static_cast<int>(ka.sy), static_cast<int>(kb.sy));
          *reinterpret_cast<int2*>(p.lt + o) =
              make_int2(static_cast<int>(ka.lt), static_cast<int>(kb.lt));
          *reinterpret_cast<int2*>(p.tot + o) =
              make_int2(static_cast<int>(ka.tot), static_cast<int>(kb.tot));
          p.vout[o] = kesc;
          p.vout[o + 1] = kact;
        }
      } else {
        const int64_t j = g >> 5;
        const int b = static_cast<int>(j & 1);
        if (j >= kRing) bar_sync(3 + b);  // the coder is done with j - 2
        Batch& B = ring[b];
        *reinterpret_cast<uint2*>(B.sy + 2 * lane) = make_uint2(ka.sy, kb.sy);
        *reinterpret_cast<uint2*>(B.lt + 2 * lane) = make_uint2(ka.lt, kb.lt);
        *reinterpret_cast<uint2*>(B.tot + 2 * lane) =
            make_uint2(ka.tot, kb.tot);
        const uint32_t besc = __ballot_sync(kFullWarp, kesc);
        const uint32_t bact = __ballot_sync(kFullWarp, kact);
        if (lane == 0) {
          B.esc = besc;
          B.act = bact;
        }
        bar_arrive(1 + b);
      }
    }
    if (flagged && lane == 0) atomicOr(p.err, 2);
    if (M == kCode) return;
    // a root still at max_prob rescales on masked steps too: walk them
    // one at a time until it no longer does
    while (tail < T && (m.root >> kSymShift) >= m.max_prob) {
      bool esc;
      Triple a{}, b{};
      m.step(p.symbols[row + tail], false, 0, esc, a, b);
      if (lane == 0) {
        const int64_t o = orow + 2 * tail;
        p.sy[o] = static_cast<int32_t>(a.sy);
        p.sy[o + 1] = static_cast<int32_t>(b.sy);
        p.lt[o] = p.lt[o + 1] = 0;
        p.tot[o] = static_cast<int32_t>(a.tot);
        p.tot[o + 1] = static_cast<int32_t>(b.tot);
        p.vout[o] = p.vout[o + 1] = 0;
      }
      ++tail;
    }
    if (lane == 0) tail_at = tail;
  }
  if (M == kModel) {
    // the static tail: each step's slots a function of its symbol
    __syncthreads();
    tail = tail_at;
    const int32_t rt = static_cast<int32_t>(tree[1] >> kSymShift);
    for (int64_t s = tail + threadIdx.x; s < T; s += kThreads) {
      const int32_t v = static_cast<int32_t>(
          tree[leaf_of(N, p.symbols[row + s], width)] >> kSymShift);
      const int64_t o = 2 * (row + s);
      *reinterpret_cast<int2*>(p.sy + o) = make_int2(v, v);
      *reinterpret_cast<int2*>(p.lt + o) = make_int2(0, 0);
      *reinterpret_cast<int2*>(p.tot + o) = make_int2(rt, rt);
      *reinterpret_cast<uint16_t*>(p.vout + o) = 0;
    }
  }
}

template <Mode M>
int launch(const Args& a, int L, void* stream) {
  if (L > 0) {
    // the tree and walk_warp's spare word
    const size_t smem = M == kCoder ? 0 : sizeof(uint32_t) *
                                              (2 * static_cast<size_t>(a.max_n) + 1);
    encode_kernel<M><<<L, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// symbols (L, T) int32, valid (L, T) uint8, Ns (L,) int32 (each lane's
// N = model size + 1); init (L, 5) int64 (low, range, buffer, help,
// bytecount: the host coder's export_enc_state); tokens (L, cap, 3) int32
// out, zeroed by the caller (the tail's literal tokens leave their fill
// 0); tok_n (L,) int32 and bytes (L,) int64 (each coder's final byte
// count) out; err (1,) int32, ORed with 1 (a lane's N outside [2, max_n])
// or 2 (an unmasked symbol outside [0, N)), never cleared.  Requires
// 2 <= max_n <= 4096.  Returns cudaGetLastError().
extern "C" int cz_fenwick_code(const int32_t* symbols, const uint8_t* valid,
                               const int32_t* Ns, int L, int64_t T,
                               int max_n, int max_prob, int increment,
                               const int64_t* init, int32_t* tokens,
                               int64_t cap, int32_t* tok_n, int64_t* bytes,
                               int32_t* err, void* stream) {
  Args a{};
  a.symbols = symbols;
  a.valid = valid;
  a.Ns = Ns;
  a.init = init;
  a.T = T;
  a.max_n = max_n;
  a.max_prob = static_cast<uint32_t>(max_prob);
  a.increment = static_cast<uint32_t>(increment);
  a.tokens = tokens;
  a.cap = cap;
  a.tok_n = tok_n;
  a.bytes = bytes;
  a.err = err;
  return launch<kCode>(a, L, stream);
}

// As cz_fenwick_code, but the model alone: sy, lt, tot (L, 2T) int32 and
// vout (L, 2T) uint8 out, two slots per step, the escape first.
extern "C" int cz_fenwick_encode(const int32_t* symbols, const uint8_t* valid,
                                 const int32_t* Ns, int L, int64_t T,
                                 int max_n, int max_prob, int increment,
                                 int32_t* sy, int32_t* lt, int32_t* tot,
                                 uint8_t* vout, int32_t* err, void* stream) {
  Args a{};
  a.symbols = symbols;
  a.valid = valid;
  a.Ns = Ns;
  a.T = T;
  a.max_n = max_n;
  a.max_prob = static_cast<uint32_t>(max_prob);
  a.increment = static_cast<uint32_t>(increment);
  a.sy = sy;
  a.lt = lt;
  a.tot = tot;
  a.vout = vout;
  a.err = err;
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  return launch<kModel>(a, L, stream);
}

// The coder alone: sy, lt, tot (L, T) int32 holding u32 (tot < 2^23),
// valid (L, T) uint8, the T slots of each lane; init, tokens, cap, tok_n
// and bytes as cz_fenwick_code's.  Returns cudaGetLastError().
extern "C" int cz_range_encode(const int32_t* sy, const int32_t* lt,
                               const int32_t* tot, const uint8_t* valid,
                               const int64_t* init, int L, int64_t T,
                               int32_t* tokens, int64_t cap, int32_t* tok_n,
                               int64_t* bytes, void* stream) {
  Args a{};
  a.valid = valid;
  a.sy_in = sy;
  a.lt_in = lt;
  a.tot_in = tot;
  a.init = init;
  a.T = T;
  a.tokens = tokens;
  a.cap = cap;
  a.tok_n = tok_n;
  a.bytes = bytes;
  return launch<kCoder>(a, L, stream);
}
