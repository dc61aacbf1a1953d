// Selector chase of the parallel Huffman walk for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this as a lax.scan
// (compressjs_tpu/ops/device_huffman.py:291-300, inside huffman_walk_dev).
// F[g, p] is the bit position reached after power_k symbols decoded
// with group g's table from bit p; the chunk boundaries follow
//
//   p <- F.flat[clamp(sel[c] * cap + p, 0, G * cap - 1)],  `sub` times
//
// per selector c, starting at p = 0, and starts[c] is p before chunk c's
// first step.  Every step depends on the one before, so one thread runs
// the chain.
//
// What bounds it: the latency of each dependent load.  A -9 block's F is
// 6 x 2^20 int32 (25 MB); read from L2, one step costs ~230 ns.  The
// chain is monotone on a valid payload: a symbol is 1..20 bits, so a
// chunk of 50 symbols moves p forward by 50..1000 bits.  So the chain
// only ever reads a short stretch of F just ahead of p, and that stretch
// is staged in shared memory before the walking thread gets there:
//
// * F's positions are cut into windows of kW; kStages windows are in
//   flight in a ring of shared-memory buffers, each filled by TMA bulk
//   copies (cp.async.bulk, one per row) that complete on the stage's
//   mbarrier.  A producer thread (warp 1) issues them: the walker (warp
//   0) publishes the window and chunk it has reached, and the producer
//   keeps the windows after it in flight, so the walker only waits on a
//   barrier (and only when it outruns the copies).
// * Only the rows named by selectors that can reach a window are copied:
//   from chunk c, with p at or past window w, the windows up to
//   w + kStages - 1 end within kStages * kW bits, which take at most
//   kStages * kW / 50 + 1 more chunks.  A per-64-selector OR of the
//   groups used (computed by all threads at the start) gives that set in
//   a few loads.  A window the walker has already passed is not copied.
// * A step reads shared memory when p lies in the current window and its
//   row was staged there.  Its word is loaded before that is known (p's
//   offset masked into the buffer), so a step is one dependent
//   shared-memory load and two integer operations.  Any other step (an
//   out-of-range selector, a row left out, p behind the window or past
//   the cap's aligned end, a misaligned row) takes the slow path: it
//   moves to p's window if the ring can stage it, else loads F from
//   global memory at the clamped flat index, as before.  So any F gives
//   the plain chase's answer exactly; only a valid one is fast.
// * At one step per selector (the main path) the loop is unrolled four
//   chunks deep, one 4-byte load bringing four selectors.
//
// Measured on an H100 (tools/torch_chase_profile.py): two windows of
// 4096 beat four of 2048 and eight of 1024, because each window change
// is a slow step; the walker's steps, not the copies, set the time.  The
// window and the ring's depth are compile-time settings
// (CZ_CHASE_WINDOW_LOG, CZ_CHASE_STAGES) so that tool can build the
// others; CZ_CHASE_PROFILE=1 adds its clock-cycle and window-advance
// counts, which the package's build leaves out.
//
// The last chunk's steps are not run: their result is not an output.
// Every loop is bounded by n, sub and the window count; a barrier wait
// or a poll that never completes traps after kMaxPolls tries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef CZ_CHASE_WINDOW_LOG
#define CZ_CHASE_WINDOW_LOG 12
#endif
#ifndef CZ_CHASE_STAGES
#define CZ_CHASE_STAGES 2
#endif
#ifndef CZ_CHASE_PROFILE
#define CZ_CHASE_PROFILE 0
#endif

constexpr int kW = 1 << CZ_CHASE_WINDOW_LOG;  // positions per window
constexpr int kStages = CZ_CHASE_STAGES;      // windows in flight
constexpr bool kProfile = CZ_CHASE_PROFILE != 0;
constexpr int kRowSlots = 6;      // rows staged: bzip2 has <= 6 groups
constexpr int kMaskBlock = 64;    // selectors per row-mask entry
constexpr int kMinChunkBits = 50; // a 50-symbol chunk moves >= 50 bits
constexpr int kLookChunks = kStages * kW / kMinChunkBits + 2;
constexpr int kThreads = 256;
constexpr long long kMaxPolls = 1LL << 32;
constexpr uint8_t kNoRow = 7;     // selector that is never staged
constexpr int kStageInts = kRowSlots * kW;
constexpr uint32_t kDone = 0x7fffffffu;  // published window: walk ended

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int32_t lds(uint32_t addr) {
  int32_t v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The walker's progress, published to the producer.  Relaxed: the
// walker's loads from a buffer have returned (its p depends on them)
// before it publishes the window that lets the producer refill it.
__device__ __forceinline__ void publish(uint64_t* at, uint64_t v) {
  asm volatile("st.relaxed.cta.shared.b64 [%0], %1;\n"
               :: "r"(smem(at)), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t read_published(uint64_t* at) {
  uint64_t v;
  asm volatile("ld.relaxed.cta.shared.b64 %0, [%1];\n"
               : "=l"(v) : "r"(smem(at)) : "memory");
  return v;
}

__device__ __forceinline__ int volatile_load(const int* at) {
  return *static_cast<const volatile int*>(at);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// The ring of staged windows: window k goes to stage k % kStages, a
// buffer of kRowSlots rows of kW positions.  Every window is issued
// once, in order, so window k's barrier completes its phase
// k / kStages.
struct Ring {
  const int32_t* F;
  int64_t cap;
  int32_t* buf;         // kStages x kRowSlots x kW int32
  uint64_t* bars;       // kStages mbarriers
  uint32_t* stage_rows; // kStages: the rows staged in each stage
  int* stage_win;       // kStages: the window last issued to each stage
  int nwin;             // windows over the aligned span [0, cap & ~3)
  int span;             // cap & ~3 (a bulk copy moves 16-byte units)
  uint32_t row_ok;      // rows whose start is 16-byte aligned

  __device__ void init(const int32_t* F_, int64_t cap_, int G,
                       unsigned char* shm) {
    F = F_;
    cap = cap_;
    buf = reinterpret_cast<int32_t*>(shm);
    bars = reinterpret_cast<uint64_t*>(buf + kStages * kStageInts);
    stage_rows = reinterpret_cast<uint32_t*>(bars + kStages);
    stage_win = reinterpret_cast<int*>(stage_rows + kStages);
    span = static_cast<int>(cap & ~static_cast<int64_t>(3));
    nwin = (span + kW - 1) / kW;
    row_ok = 0;
    for (int g = 0; g < min(G, kRowSlots); ++g) {
      if ((reinterpret_cast<uintptr_t>(F + g * cap) & 15u) == 0)
        row_ok |= 1u << g;
    }
  }

  __device__ int len(int k) const { return min(kW, span - k * kW); }

  // window k, rows `rows`; returns the bytes it copies
  __device__ uint32_t issue(int k, uint32_t rows) const {
    const int st = k % kStages;
    rows &= row_ok;
    stage_rows[st] = rows;
    stage_win[st] = k;
    const uint32_t row_bytes = static_cast<uint32_t>(len(k)) * 4u;
    // the walker's reads of this stage are done before the copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_arrive_tx(&bars[st], row_bytes * __popc(rows));
    for (int g = 0; g < kRowSlots; ++g) {
      if ((rows >> g) & 1u) {
        bulk_copy(buf + st * kStageInts + g * kW,
                  F + g * cap + static_cast<int64_t>(k) * kW, row_bytes,
                  &bars[st]);
      }
    }
    return row_bytes * __popc(rows);
  }

  // Until window k has landed.  Its barrier tells phases apart only by
  // parity, so first the stage must hold window k at all (the producer
  // issues k only after k - kStages landed); the walker only waits for a
  // window it has published, whose stage the producer cannot refill yet.
  __device__ void wait(int k) const {
    long long polls = 0;
    while (volatile_load(&stage_win[k % kStages]) != k) {
      if (++polls == kMaxPolls) __trap();
    }
    const uint32_t parity = (k / kStages) & 1u;
    while (!bar_try(&bars[k % kStages], parity)) {
      if (++polls == kMaxPolls) __trap();
    }
  }
};

// Groups used by the chunks [c, c + kLookChunks]: an OR of the per-64
// masks that cover them.
__device__ __forceinline__ uint32_t rows_ahead(const uint8_t* blk_mask,
                                               int n_blk, int c) {
  const int b1 = min((c + kLookChunks) / kMaskBlock, n_blk - 1);
  uint32_t rows = 0;
  for (int b = c / kMaskBlock; b <= b1; ++b) rows |= blk_mask[b];
  return rows;
}

// The producer: keeps the windows after the walker's in flight until the
// walker publishes kDone, then waits for its last copies to land.
// Returns the bytes it copied; a profiling build also gives its cycles.
__device__ long long produce(const Ring& ring, uint64_t* progress,
                             const uint8_t* blk_mask, int n_blk,
                             long long* cycles) {
  long long t0 = 0;
  if constexpr (kProfile) t0 = clock64();
  long long staged = 0;
  int k = 0;
  for (long long polls = 0;; ++polls) {
    const uint64_t pr = read_published(progress);
    const uint32_t w = static_cast<uint32_t>(pr >> 32);
    if (w == kDone) break;
    if (k < ring.nwin && k < static_cast<int>(w) + kStages) {
      // a window the walker has passed is issued empty, so that every
      // window's barrier phase still completes in order
      const uint32_t rows = k < static_cast<int>(w) ? 0u
          : rows_ahead(blk_mask, n_blk, static_cast<int>(pr & 0xffffffffu));
      if (k >= kStages) ring.wait(k - kStages);
      staged += ring.issue(k, rows);
      ++k;
    } else if (polls == kMaxPolls) {
      __trap();
    }
  }
  for (int j = max(0, k - kStages); j < k; ++j) ring.wait(j);
  if constexpr (kProfile) *cycles = clock64() - t0;
  return staged;
}

// The walking thread's view of the ring: it has published window `cur`
// (the producer may refill any window before it), which has landed and
// covers positions [base, base + lim) of the rows `rows`, staged at
// shared address `wsm`.
struct Walker {
  Ring ring;
  uint64_t* progress;
  const int32_t* sel;
  int64_t last;        // G * cap - 1
  int cur, base, lim;
  uint32_t rows, wsm;
  long long global_loads;
  long long advances, wait_cycles;  // counted by a profiling build only

  // publish window w at chunk c and wait for it to land
  __device__ void enter(int w, int c) {
    long long t0 = 0;
    if constexpr (kProfile) t0 = clock64();
    publish(progress, (static_cast<uint64_t>(w) << 32) |
                          static_cast<uint32_t>(c));
    ring.wait(w);
    if constexpr (kProfile) wait_cycles += clock64() - t0;
    cur = w;
    base = w * kW;
    lim = ring.len(w);
    rows = ring.stage_rows[w % kStages];
    wsm = smem(ring.buf + (w % kStages) * kStageInts);
  }

  // One step the current window cannot serve: p left it (forward into a
  // window the ring can stage, or elsewhere), or its row is not staged.
  __device__ __noinline__ int32_t slow_step(int32_t p, int c, uint32_t s) {
    if (s < kRowSlots && p >= 0 && p < ring.span && p / kW > cur) {
      if constexpr (kProfile) ++advances;
      enter(p / kW, c);
      if ((rows >> s) & 1u)
        return lds(wsm + (s * kW + (p - base)) * 4u);
    }
    ++global_loads;
    int64_t i = static_cast<int64_t>(sel[c]) * ring.cap + p;
    i = i < 0 ? 0 : (i > last ? last : i);
    return ring.F[i];
  }
};

// One step of chunk C with selector S: the shared-memory word is loaded
// before the window check, at p's offset masked into the buffer (base is
// a multiple of kW, and a selector past the rows reads row 0), and used
// only if p was in the window and its row staged there.
#define CZ_CHASE_STEP(C, S)                                              \
  {                                                                      \
    const uint32_t s_ = (S);                                             \
    const int32_t v_ = lds(wsm + ((s_ < kRowSlots ? s_ : 0u) * kW +      \
                                  (static_cast<uint32_t>(p) & (kW - 1))) \
                                     * 4u);                              \
    if (((rows >> s_) & 1u) && static_cast<uint32_t>(p - base) < lim) {  \
      p = v_;                                                            \
    } else {                                                             \
      p = wk.slow_step(p, (C), s_);                                      \
      base = wk.base;                                                    \
      lim = static_cast<uint32_t>(wk.lim);                               \
      rows = wk.rows;                                                    \
      wsm = wk.wsm;                                                      \
    }                                                                    \
  }

__global__ void __launch_bounds__(kThreads)
selector_chase_kernel(const int32_t* __restrict__ F,
                      const int32_t* __restrict__ sel,
                      int32_t* __restrict__ starts, int64_t cap, int G,
                      int n, int sub, long long* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char shm[];
  Ring ring;
  ring.init(F, cap, G, shm);
  uint64_t* progress = reinterpret_cast<uint64_t*>(ring.stage_win +
                                                   kStages);
  uint8_t* sel_s = reinterpret_cast<uint8_t*>(progress + 1);
  const int n_pad = (n + 4) & ~3;  // room for a 4-byte look-ahead read
  uint8_t* blk_mask = sel_s + n_pad;
  const int n_blk = (n + kMaskBlock - 1) / kMaskBlock;
  const int staged_rows = min(G, kRowSlots);

  // selectors as bytes (kNoRow: not a staged row), and per 64 selectors
  // the OR of the rows they name
  for (int c = threadIdx.x; c < n_pad; c += kThreads) {
    const int s = c < n ? sel[c] : 0;
    sel_s[c] = (s >= 0 && s < staged_rows) ? static_cast<uint8_t>(s)
                                            : kNoRow;
  }
  if (threadIdx.x < kStages) {
    bar_init(&ring.bars[threadIdx.x]);
    ring.stage_rows[threadIdx.x] = 0;
    ring.stage_win[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) *progress = 0;  // window 0, chunk 0
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < n_blk; b += kThreads / 32) {
    uint32_t m = 0;
    for (int c = b * kMaskBlock + lane; c < min(n, (b + 1) * kMaskBlock);
         c += 32) {
      const uint8_t s = sel_s[c];
      if (s != kNoRow) m |= 1u << s;
    }
    m = __reduce_or_sync(0xffffffffu, m);
    if (lane == 0) blk_mask[b] = static_cast<uint8_t>(m);
  }
  __syncthreads();

  if (threadIdx.x == 32) {
    long long cycles = 0;
    const long long staged = produce(ring, progress, blk_mask, n_blk,
                                     &cycles);
    if (stats != nullptr) {
      stats[0] = staged;
      if constexpr (kProfile) stats[6] = cycles;
    }
    return;
  }
  if (threadIdx.x != 0) return;

  long long t_begin = 0;
  if constexpr (kProfile) t_begin = clock64();
  Walker wk;
  wk.ring = ring;
  wk.progress = progress;
  wk.sel = sel;
  wk.last = static_cast<int64_t>(G) * cap - 1;
  wk.global_loads = wk.advances = wk.wait_cycles = 0;
  if (ring.nwin > 0) {
    wk.enter(0, 0);
  } else {  // a cap below 4 stages nothing: every step reads F
    wk.cur = wk.base = wk.lim = 0;
    wk.rows = 0;
    wk.wsm = smem(ring.buf);
  }

  // the chain: (n - 1) * sub steps (the last chunk's are not needed)
  int32_t p = 0;
  starts[0] = 0;
  int base = wk.base;
  uint32_t lim = static_cast<uint32_t>(wk.lim), rows = wk.rows,
           wsm = wk.wsm;
  if (sub == 1) {
    int c = 0;
    uint32_t s4 = *reinterpret_cast<const uint32_t*>(sel_s);
    for (; c + 4 <= n - 1; c += 4) {
      const uint32_t s_now = s4;
      s4 = *reinterpret_cast<const uint32_t*>(sel_s + c + 4);
      CZ_CHASE_STEP(c, s_now & 0xffu)
      starts[c + 1] = p;
      CZ_CHASE_STEP(c + 1, (s_now >> 8) & 0xffu)
      starts[c + 2] = p;
      CZ_CHASE_STEP(c + 2, (s_now >> 16) & 0xffu)
      starts[c + 3] = p;
      CZ_CHASE_STEP(c + 3, s_now >> 24)
      starts[c + 4] = p;
    }
    for (; c < n - 1; ++c) {
      CZ_CHASE_STEP(c, sel_s[c])
      starts[c + 1] = p;
    }
  } else {
    for (int c = 0; c < n - 1; ++c) {
      const uint32_t s = sel_s[c];
      for (int t = 0; t < sub; ++t) CZ_CHASE_STEP(c, s)
      starts[c + 1] = p;
    }
  }
  publish(progress, static_cast<uint64_t>(kDone) << 32);
  if (stats != nullptr) {
    stats[1] = wk.global_loads;
    stats[2] = kW;
    stats[3] = kStages;
    if constexpr (kProfile) {
      stats[4] = clock64() - t_begin;
      stats[5] = wk.wait_cycles;
      stats[7] = wk.advances;
    }
  }
}

// TMA streaming rate of one SM: every window of rows [0, G) through the
// same ring, with no chain.  The smoke divides the bytes by its time.
__global__ void stage_probe_kernel(const int32_t* __restrict__ F,
                                   int64_t cap, int G,
                                   long long* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char shm[];
  Ring ring;
  ring.init(F, cap, G, shm);
  if (threadIdx.x < kStages) {
    bar_init(&ring.bars[threadIdx.x]);
    ring.stage_win[threadIdx.x] = -1;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long staged = 0;
  int32_t acc = 0;
  for (int k = 0; k < min(kStages, ring.nwin); ++k)
    staged += ring.issue(k, ~0u);
  for (int k = 0; k < ring.nwin; ++k) {
    ring.wait(k);
    acc ^= ring.buf[(k % kStages) * kStageInts];
    if (k + kStages < ring.nwin) staged += ring.issue(k + kStages, ~0u);
  }
  stats[0] = staged;
  stats[1] = acc;
}

size_t shared_bytes(int n) {
  // buffers, barriers, staged rows and windows, the walker's progress,
  // selectors (padded for the look-ahead read), row masks
  return static_cast<size_t>(kStages) * kStageInts * 4 + kStages * 8 +
         kStages * 8 + 8 + ((n + 4) & ~3) + (n + kMaskBlock - 1) / kMaskBlock;
}

}  // namespace

// F: (G, cap) int32, cap < 2^31; sel: (n,) int32, n <= 32768 (a bzip2
// block has at most 32,767 selectors; the shared memory holds 32 KB of
// them beside the 192 KB ring); starts: (n,) int32 out; stats: null or 4
// int64 out (bytes staged, global loads, window, stages), 8 in a
// profiling build (then clock cycles: the walker's in all, the walker's
// waiting on windows, the producer's in all; and the walker's window
// advances).  Returns cudaGetLastError().
extern "C" int cz_selector_chase(const int32_t* F, const int32_t* sel,
                                 int32_t* starts, int G, int64_t cap, int n,
                                 int sub, long long* stats, void* stream) {
  if (G > 0 && cap > 0 && n > 0 && sub > 0) {
    const size_t bytes = shared_bytes(n);
    cudaFuncSetAttribute(selector_chase_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    selector_chase_kernel<<<1, kThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
        F, sel, starts, cap, G, n, sub, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

// stats: 2 int64 out (bytes staged, a checksum).
extern "C" int cz_stage_probe(const int32_t* F, int G, int64_t cap,
                              long long* stats, void* stream) {
  if (G > 0 && cap > 0) {
    const size_t bytes = shared_bytes(0);
    cudaFuncSetAttribute(stage_probe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    stage_probe_kernel<<<1, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
        F, cap, G, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
