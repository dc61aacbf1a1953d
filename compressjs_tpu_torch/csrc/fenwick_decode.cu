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
//   the cumulative frequency, the root -> leaf walk adding the update,
//   the leaf's update, decode_update, the last-escape removal and the
//   rescale test;
// * where that pass decodes the escape symbol N-1, a second pass in the
//   escape plane gives the symbol.
//
// A masked step changes nothing and writes 1 - N (the JAX scan's symbol
// of a walk that did not move).  The decoder state (low, range, buffer,
// the read position) comes in and goes out per lane, the host coder's
// export_dec_state seam.
//
// What bounds it: latency, as fenwick_encode.cu: per symbol a chain of
// dependent shared-memory steps (depth read-add-writes, a divide) that
// nothing splits, so one thread per lane keeps its tree in shared memory,
// 16 lanes a block.  Every loop is bounded by T, by 4 normalise iterations
// and by the tree's depth; a lane with N outside [2, max_n] sets *err and
// decodes nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "fenwick_tree.cuh"

namespace {

using fenwick::Tree;

constexpr uint32_t kBottom = 1u << 23;
constexpr int kExtraBits = 7;

struct Decoder {
  uint32_t low, rng, buf;
  int64_t pos;
  const uint8_t* bytes;  // the lane's payload row
  int64_t len;

  __device__ __forceinline__ void normalize() {
    for (int k = 0; k < 4 && rng <= kBottom; ++k) {
      const uint32_t nxt = pos < len ? bytes[pos] : 0xFFFFFFFFu;
      low = (low << 8) | ((buf << kExtraBits) & 0xFF);
      low |= nxt >> (8 - kExtraBits);
      buf = nxt & 0xFF;
      ++pos;
      rng <<= 8;
    }
  }
};

// One host _decode(is_escape) for an active lane: returns the symbol.
__device__ __forceinline__ int sub_decode(const Tree& t, Decoder& d, int N,
                                          int width, bool plane_esc,
                                          uint32_t upd_sym,
                                          uint32_t max_prob) {
  const uint32_t mask = plane_esc ? fenwick::kEscMask : fenwick::kSymMask;
  const int shift = plane_esc ? 0 : fenwick::kSymShift;
  const uint32_t update = plane_esc ? upd_sym - 1 : upd_sym;
  const uint32_t tot = (t[1] & mask) >> shift;
  d.normalize();
  const uint32_t help = d.rng / (tot > 0 ? tot : 1u);
  const uint32_t q = d.low / (help > 0 ? help : 1u);
  const uint32_t cul = q >= tot ? tot - 1 : q;
  int i = 1;
  uint32_t lt = 0;
  while (i < N) {  // at most depth steps: N <= max_n
    t[i] += update;
    const uint32_t left = (t[fenwick::clamp_node(2 * i, width)] & mask) >>
                          shift;
    const bool right = cul - lt >= left;
    if (right) lt += left;
    i = 2 * i + right;
  }
  const int symbol = i - N;
  const uint32_t sy = (t[i] & mask) >> shift;
  t[i] += update;
  const uint32_t tmp = help * lt;
  d.low -= tmp;
  d.rng = lt + sy < tot ? help * sy : d.rng - tmp;
  if (symbol == N - 1 && (t[1] & fenwick::kEscMask) == 1) {
    const uint32_t neg = 0u - t[i];
    for (int j = i; j >= 1; j >>= 1) t[j] += neg;
  }
  if ((t[1] >> fenwick::kSymShift) >= max_prob) fenwick::rescale(t, N);
  return symbol;
}

__global__ void fenwick_decode_kernel(
    const uint8_t* __restrict__ payload, int64_t B,
    int64_t* __restrict__ state, const int32_t* __restrict__ Ns,
    const uint8_t* __restrict__ valid, int L, int64_t T, int max_n,
    uint32_t max_prob, uint32_t increment, int32_t* __restrict__ out,
    int32_t* __restrict__ err) {
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
  int64_t* st = state + 4 * static_cast<int64_t>(l);
  Decoder d;
  d.low = static_cast<uint32_t>(st[0]);
  d.rng = static_cast<uint32_t>(st[1]);
  d.buf = static_cast<uint32_t>(st[2]);
  d.pos = st[3];
  d.bytes = payload + static_cast<int64_t>(l) * B;
  d.len = B;
  const int64_t row = static_cast<int64_t>(l) * T;
  for (int64_t s = 0; s < T; ++s) {
    int sym = 1 - N;
    if (valid[row + s]) {
      sym = sub_decode(t, d, N, width, false, upd_sym, max_prob);
      if (sym == N - 1) sym = sub_decode(t, d, N, width, true, upd_sym,
                                         max_prob);
    }
    out[row + s] = sym;
  }
  st[0] = d.low;
  st[1] = d.rng;
  st[2] = d.buf;
  st[3] = d.pos;
}

}  // namespace

// payload (L, B) uint8, each row one lane's bytes; state (L, 4) int64
// (low, range, buffer, read position) in and out; Ns (L,) int32; valid
// (L, T) uint8; out (L, T) int32 symbols; err (1,) int32, ORed with 1
// where a lane's N is outside [2, max_n], never cleared.  Requires
// 2 <= max_n <= 4096.  Returns cudaGetLastError().
extern "C" int cz_fenwick_decode(const uint8_t* payload, int64_t B,
                                 int64_t* state, const int32_t* Ns,
                                 const uint8_t* valid, int L, int64_t T,
                                 int max_n, int max_prob, int increment,
                                 int32_t* out, int32_t* err, void* stream) {
  if (L > 0) {
    const int lanes = fenwick::lanes_per_block(max_n);
    const int threads = L < lanes ? L : lanes;
    const size_t smem = sizeof(uint32_t) * 2 * max_n * threads;
    fenwick_decode_kernel<<<(L + threads - 1) / threads, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        payload, B, state, Ns, valid, L, T, max_n,
        static_cast<uint32_t>(max_prob), static_cast<uint32_t>(increment),
        out, err);
  }
  return static_cast<int>(cudaGetLastError());
}
