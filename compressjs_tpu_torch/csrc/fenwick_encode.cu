// Batched adaptive Fenwick model, encode side, for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this as a lax.scan with one step per
// symbol over L independent lanes (compressjs_tpu/ops/device_model.py:211,
// fenwick_encode_streams, scan at :276).  One launch here runs every step
// of every lane and writes the (sy_f, lt_f, tot_f, valid) triples that
// range_encode.cu codes: two slots per symbol, the escape first.
//
// Per lane and step, as the host FenwickModel.encode does:
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
// * after every sub-step a root of max_prob or more in the symbol plane
//   halves the tree (fenwick_tree.cuh, rescale).  The JAX scan rescales
//   every lane that meets that test once any lane does; each lane's
//   result is the same, so each thread tests its own root.
//
// A masked step writes what the JAX scan writes there: sy_f of the
// symbol's clamped leaf, lt_f 0, tot_f of the root, valid 0.
//
// What bounds it: latency.  A lane is a chain of dependent steps, each
// about 2 x depth (10 at max_n 258) dependent shared-memory read-add-write
// steps, plus a rescale of ~3N operations every ~(max_prob / increment)
// symbols.  Nothing splits one lane's chain, so the design keeps every
// step's reads in shared memory: one thread per lane, its tree there
// (2,064 B at max_n 258), 16 lanes a block.  The bytes (each symbol and
// mask read once, 13 bytes written per slot) take a small share of that
// chain's time.  Every loop is bounded by T and by the tree's size; a
// lane with N outside [2, max_n], or an unmasked symbol outside [0, N),
// sets *err and codes nothing (that step, or the lane).

#include <cstdint>
#include <cuda_runtime.h>

#include "fenwick_tree.cuh"

namespace {

using fenwick::Tree;

struct Triple {
  uint32_t sy, lt, tot;
};

// One host encode() body without its escape recursion, in the plane
// plane_esc picks; raw_pre, where has_pre, is the leaf read before the
// escape sub-step.
__device__ __forceinline__ Triple sub_encode(const Tree& t, int N, int width,
                                             int sym, bool plane_esc,
                                             bool active, bool has_pre,
                                             uint32_t raw_pre,
                                             uint32_t upd_sym,
                                             uint32_t max_prob) {
  int i = fenwick::clamp_node(static_cast<int64_t>(N) + sym, width);
  const uint32_t raw = t[i];
  const bool last_esc = !plane_esc && sym == N - 1 &&
                        (t[1] & fenwick::kEscMask) == 1;
  const uint32_t update =
      plane_esc ? upd_sym - 1 : (last_esc ? 0u - raw : upd_sym);
  uint32_t lt = 0;
  if (active) {
    while (i > 1) {  // at most depth steps: i < 2 * max_n
      if (i & 1) lt += t[i - 1];
      t[i] += update;
      i >>= 1;
    }
  }
  const uint32_t tot = t[1];
  if (active) t[1] += update;
  const uint32_t mask = plane_esc ? fenwick::kEscMask : fenwick::kSymMask;
  const int shift = plane_esc ? 0 : fenwick::kSymShift;
  Triple r;
  r.sy = ((has_pre ? raw_pre : raw) & mask) >> shift;
  r.lt = (lt & mask) >> shift;
  r.tot = (tot & mask) >> shift;
  if ((t[1] >> fenwick::kSymShift) >= max_prob) fenwick::rescale(t, N);
  return r;
}

__global__ void fenwick_encode_kernel(
    const int32_t* __restrict__ symbols, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ Ns, int L, int64_t T, int max_n,
    uint32_t max_prob, uint32_t increment, int32_t* __restrict__ sy,
    int32_t* __restrict__ lt, int32_t* __restrict__ tot,
    uint8_t* __restrict__ vout, int32_t* __restrict__ err) {
  extern __shared__ uint32_t smem[];
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const Tree t{smem + threadIdx.x, static_cast<int>(blockDim.x)};
  const int width = 2 * max_n;
  const int N = Ns[l];
  if (N < 2 || N > max_n) {
    atomicOr(err, 1);
    return;
  }
  fenwick::init_tree(t, N, width, increment);
  const uint32_t upd_sym = increment << fenwick::kSymShift;
  const int64_t row = static_cast<int64_t>(l) * T;
  const int64_t orow = 2 * row;
  for (int64_t s = 0; s < T; ++s) {
    const int sym = symbols[row + s];
    bool active = valid[row + s] != 0;
    if (active && static_cast<unsigned>(sym) >= static_cast<unsigned>(N)) {
      atomicOr(err, 2);
      active = false;
    }
    const uint32_t raw =
        t[fenwick::clamp_node(static_cast<int64_t>(N) + sym, width)];
    const bool escapes = active && (raw & fenwick::kSymMask) == 0;
    const Triple a = sub_encode(t, N, width, escapes ? N - 1 : sym, false,
                                escapes, false, 0u, upd_sym, max_prob);
    const Triple b = sub_encode(t, N, width, sym, escapes, active, true, raw,
                                upd_sym, max_prob);
    const int64_t o = orow + 2 * s;
    sy[o] = static_cast<int32_t>(a.sy);
    lt[o] = static_cast<int32_t>(a.lt);
    tot[o] = static_cast<int32_t>(a.tot);
    vout[o] = escapes;
    sy[o + 1] = static_cast<int32_t>(b.sy);
    lt[o + 1] = static_cast<int32_t>(b.lt);
    tot[o + 1] = static_cast<int32_t>(b.tot);
    vout[o + 1] = active;
  }
}

}  // namespace

// symbols (L, T) int32, valid (L, T) uint8, Ns (L,) int32 (each lane's
// N = model size + 1); sy, lt, tot (L, 2T) int32 and vout (L, 2T) uint8
// out; err (1,) int32, ORed with 1 (a lane's N outside [2, max_n]) or 2
// (an unmasked symbol outside [0, N)), never cleared.  Requires
// 2 <= max_n <= 4096.  Returns cudaGetLastError().
extern "C" int cz_fenwick_encode(const int32_t* symbols, const uint8_t* valid,
                                 const int32_t* Ns, int L, int64_t T,
                                 int max_n, int max_prob, int increment,
                                 int32_t* sy, int32_t* lt, int32_t* tot,
                                 uint8_t* vout, int32_t* err, void* stream) {
  if (L > 0 && T > 0) {
    const int lanes = fenwick::lanes_per_block(max_n);
    const int threads = L < lanes ? L : lanes;
    const size_t smem = sizeof(uint32_t) * 2 * max_n * threads;
    fenwick_encode_kernel<<<(L + threads - 1) / threads, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        symbols, valid, Ns, L, T, max_n, static_cast<uint32_t>(max_prob),
        static_cast<uint32_t>(increment), sy, lt, tot, vout, err);
  }
  return static_cast<int>(cudaGetLastError());
}
