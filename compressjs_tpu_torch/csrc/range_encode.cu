// Batched Schindler range coder, encode side, for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this as a lax.scan with one step per
// triple over L independent lanes (compressjs_tpu/ops/device_coder.py:63,
// batched_range_encode, scan at :108).  One launch here codes every lane's
// (sy_f, lt_f, tot_f) triples (fenwick_encode.cu writes them) and finishes
// each coder, byte for byte as the host RangeCoder
// (host/range_coder.py):
//
// * before each valid triple, up to 3 normalise iterations (enough for
//   tot_f < 2^23) shift a byte out while the range is at most 2^23; a
//   shifted byte whose carry is settled emits a token (byte, run, fill):
//   the byte, then `run` bytes of `fill` (0xFF, or 0x00 after a carry),
//   the pending-carry run the host writes in a loop;
// * then encode_freq (encode_shift is the same arithmetic at
//   tot_f = 1 << shift);
// * at the end encode_finish: 3 normalise iterations, the rounded top
//   byte with its run, and four literal bytes (the low byte and the
//   24-bit byte count).
//
// Tokens past tok_cap are dropped but still counted in tok_n, as the JAX
// scan drops them; the caller compares tok_n with tok_cap.  Tokens
// become bytes in ops/device_coder.py (token_bytes: a sum, a
// searchsorted and a gather), which needs no kernel.
//
// What bounds it: latency.  A lane is a chain of dependent steps (three
// compares and shifts, a 32-bit division and two products); one thread
// per lane, its state in registers, reading its triples once and writing
// its tokens once (12 bytes each, about 0.3 a triple on text).  Every
// loop is bounded: T steps of at most 3 normalise iterations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTop = 1u << 31;
constexpr uint32_t kBottom = 1u << 23;
constexpr int kShiftBits = 23;
constexpr int kThreads = 32;

struct Coder {
  uint32_t low, rng, buffer, help, bytecount;
  int32_t tok_n;
  int32_t* tokens;  // the lane's (cap, 3) row
  int64_t cap;

  __device__ __forceinline__ void token(uint32_t byte, uint32_t run,
                                        uint32_t fill) {
    if (tok_n < cap) {
      int32_t* p = tokens + 3 * static_cast<int64_t>(tok_n);
      p[0] = static_cast<int32_t>(byte);
      p[1] = static_cast<int32_t>(run);
      p[2] = static_cast<int32_t>(fill);
    }
    ++tok_n;
  }

  // One enc_normalize loop iteration.
  __device__ __forceinline__ void normalize_iter() {
    if (rng > kBottom) return;
    const bool below = low < (0xFFu << kShiftBits);
    if (below || (low & kTop)) {
      token(below ? buffer : ((buffer + 1) & 0xFF), help,
            below ? 0xFFu : 0x00u);
      buffer = (low >> kShiftBits) & 0xFF;
      help = 0;
    } else {
      ++help;
    }
    rng <<= 8;
    low = (low << 8) & (kTop - 1);
    ++bytecount;
  }
};

__global__ void __launch_bounds__(kThreads)
range_encode_kernel(const int32_t* __restrict__ sy,
                    const int32_t* __restrict__ lt,
                    const int32_t* __restrict__ tot,
                    const uint8_t* __restrict__ valid,
                    const int64_t* __restrict__ init, int L, int64_t T,
                    int32_t* __restrict__ tokens, int64_t cap,
                    int32_t* __restrict__ tok_n, int64_t* __restrict__ bytes) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  Coder c;
  c.low = static_cast<uint32_t>(init[5 * l]);
  c.rng = static_cast<uint32_t>(init[5 * l + 1]);
  c.buffer = static_cast<uint32_t>(init[5 * l + 2]);
  c.help = static_cast<uint32_t>(init[5 * l + 3]);
  c.bytecount = static_cast<uint32_t>(init[5 * l + 4]);
  c.tok_n = 0;
  c.tokens = tokens + static_cast<int64_t>(l) * cap * 3;
  c.cap = cap;
  const int64_t row = static_cast<int64_t>(l) * T;
  for (int64_t s = 0; s < T; ++s) {
    if (!valid[row + s]) continue;
    const uint32_t f_sy = static_cast<uint32_t>(sy[row + s]);
    const uint32_t f_lt = static_cast<uint32_t>(lt[row + s]);
    const uint32_t f_tot = static_cast<uint32_t>(tot[row + s]);
    c.normalize_iter();
    c.normalize_iter();
    c.normalize_iter();
    const uint32_t r = c.rng / (f_tot > 0 ? f_tot : 1u);
    const uint32_t tmp = r * f_lt;
    c.low += tmp;
    c.rng = f_lt + f_sy < f_tot ? r * f_sy : c.rng - tmp;
  }
  // encode_finish
  c.normalize_iter();
  c.normalize_iter();
  c.normalize_iter();
  c.bytecount += 5;
  uint32_t top = c.low >> kShiftBits;
  if ((c.low & (kBottom - 1)) >= ((c.bytecount & 0xFFFFFF) >> 1)) ++top;
  const bool carry = top > 0xFF;
  c.token(carry ? ((c.buffer + 1) & 0xFF) : c.buffer, c.help,
          carry ? 0x00u : 0xFFu);
  c.token(top & 0xFF, 0, 0);
  c.token((c.bytecount >> 16) & 0xFF, 0, 0);
  c.token((c.bytecount >> 8) & 0xFF, 0, 0);
  c.token(c.bytecount & 0xFF, 0, 0);
  tok_n[l] = c.tok_n;
  bytes[l] = c.bytecount;
}

}  // namespace

// sy, lt, tot (L, T) int32 holding u32 (tot < 2^23), valid (L, T) uint8,
// init (L, 5) int64 (low, range, buffer, help, bytecount: the host coder's
// export_enc_state); tokens (L, cap, 3) int32 out, zeroed by the caller
// (the tail's literal tokens leave their fill 0); tok_n (L,) int32 and
// bytes (L,) int64 (each coder's final byte count) out.  Returns
// cudaGetLastError().
extern "C" int cz_range_encode(const int32_t* sy, const int32_t* lt,
                               const int32_t* tot, const uint8_t* valid,
                               const int64_t* init, int L, int64_t T,
                               int32_t* tokens, int64_t cap, int32_t* tok_n,
                               int64_t* bytes, void* stream) {
  if (L > 0) {
    range_encode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        sy, lt, tot, valid, init, L, T, tokens, cap, tok_n, bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
