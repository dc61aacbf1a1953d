// The Schindler range coder's encode side, one per lane, for the encode
// kernels of fenwick_encode.cu, byte for byte as the host RangeCoder
// (host/range_coder.py):
//
// * before each valid triple, up to 3 normalise iterations (enough for
//   tot_f < 2^23) shift a byte out while the range is at most 2^23; a
//   shifted byte whose carry is settled emits a token (byte, run, fill):
//   the byte, then `run` bytes of `fill` (0xFF, or 0x00 after a carry),
//   the pending-carry run the host writes in a loop;
// * then encode_freq (encode_shift is the same arithmetic at
//   tot_f = 1 << shift), the division exact in u32;
// * at the end encode_finish: 3 normalise iterations, the rounded top
//   byte with its run, and four literal bytes (the low byte and the
//   24-bit byte count).
//
// Tokens past the cap are dropped but still counted, as the JAX scan
// drops them; the caller compares the count with the cap.  Every thread
// of a warp may hold the same coder (its state warp-uniform): only the
// one whose `writer` is set stores tokens.

#pragma once

#include <cstdint>

namespace range_coder {

constexpr uint32_t kTop = 1u << 31;
constexpr uint32_t kBottom = 1u << 23;
constexpr int kShiftBits = 23;

struct Encoder {
  uint32_t low, rng, buffer, help, bytecount;
  int32_t tok_n;
  int32_t* tokens;  // the lane's (cap, 3) row
  int64_t cap;
  bool writer;

  // state: (low, range, buffer, help, bytecount), the host coder's
  // export_enc_state
  __device__ __forceinline__ void start(const int64_t* state, int32_t* row,
                                        int64_t row_cap, bool writes) {
    low = static_cast<uint32_t>(state[0]);
    rng = static_cast<uint32_t>(state[1]);
    buffer = static_cast<uint32_t>(state[2]);
    help = static_cast<uint32_t>(state[3]);
    bytecount = static_cast<uint32_t>(state[4]);
    tok_n = 0;
    tokens = row;
    cap = row_cap;
    writer = writes;
  }

  __device__ __forceinline__ void token(uint32_t byte, uint32_t run,
                                        uint32_t fill) {
    if (writer && tok_n < cap) {
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

  // encode_freq(sy, lt, tot) with its normalisation
  __device__ __forceinline__ void encode(uint32_t sy, uint32_t lt,
                                         uint32_t tot) {
    normalize_iter();
    normalize_iter();
    normalize_iter();
    const uint32_t r = rng / (tot > 0 ? tot : 1u);
    const uint32_t tmp = r * lt;
    low += tmp;
    rng = lt + sy < tot ? r * sy : rng - tmp;
  }

  // encode_finish; the writer stores the token count and the byte count
  __device__ __forceinline__ void finish(int32_t* tok_n_out,
                                         int64_t* bytes_out) {
    normalize_iter();
    normalize_iter();
    normalize_iter();
    bytecount += 5;
    uint32_t top = low >> kShiftBits;
    if ((low & (kBottom - 1)) >= ((bytecount & 0xFFFFFF) >> 1)) ++top;
    const bool carry = top > 0xFF;
    token(carry ? ((buffer + 1) & 0xFF) : buffer, help,
          carry ? 0x00u : 0xFFu);
    token(top & 0xFF, 0, 0);
    token((bytecount >> 16) & 0xFF, 0, 0);
    token((bytecount >> 8) & 0xFF, 0, 0);
    token(bytecount & 0xFF, 0, 0);
    if (writer) {
      *tok_n_out = tok_n;
      *bytes_out = bytecount;
    }
  }
};

}  // namespace range_coder
