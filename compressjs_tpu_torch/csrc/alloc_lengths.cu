// Length-limited Huffman code-length allocator for Hopper (sm_90a).
//
// Replaces compressjs_tpu/ops/device_entropy.py:_alloc_kernel (launched
// by alloc_lengths_pallas).  Each table is a 260-slot buffer whose first
// m slots hold sorted symbol frequencies; the in-place algorithm of
// Milidiu, Pessoa and Laber turns them into code lengths of at most
// max_len bits in three phases: extended parent pointers, nodes to
// relocate, then a plain or a relocating depth fill.
//
// Two entry points share that device code:
//
// * cz_alloc_lengths takes sorted tables, as alloc_lengths_pallas does,
//   and writes one error flag per table.
// * cz_code_lengths is a whole table build, the body of the port's
//   code_lengths_batch in one launch: it ranks each symbol's key
//   (freq << 9 | sym) by counting the smaller keys of its table (the
//   keys are distinct, so the rank is its slot in torch.sort's order;
//   slots >= m hold 0), allocates, and scatters the lengths back by
//   symbol.  It ORs its error flag into one int32 the caller owns, which
//   the caller reads once per block beside a value it fetches anyway,
//   so no launch waits on the host.
//
// What bounds it: latency.  A launch carries at most 6 tables of a few
// hundred dependent scalar steps each, 9 launches per 900 KB block; no
// layout makes that wide.  As on the TPU (scalar loops over an SMEM
// table), one warp runs one table out of shared memory; one block per
// table lets the tables run on separate SMs, and the block's threads
// copy, rank and scatter the table with coalesced loads.  Phase 1, a
// dependent merge, runs on one lane.  The galloping and binary searches
// of phases 2 and 3 become two warp-wide probes (`first_node`) and the
// depth fills are written by all lanes.  After phase 1 every slot the
// searches read holds a parent pointer below 2m, so `v % m` is one
// compare and subtract; a value outside [0, 2m) flags the table.
//
// Every loop has a fixed upper bound, so a table that breaks the
// algorithm's invariants cannot hang the card: the galloping and binary
// searches stop after kSearchSteps, the depth loops after kMaxDepths,
// and a fill may not run below slot 0.  A table that hits a bound gets
// its error flag set and the caller raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 260;          // static alphabet buffer
constexpr int kSearchSteps = 10; // both searches need <= 9 for kN slots
constexpr int kMaxDepths = 32;   // a depth fill ends by depth max_len <= 20

__device__ __forceinline__ int clamp_slot(int i) {
  return i < 0 ? 0 : (i > kN - 1 ? kN - 1 : i);
}

// a[i] % m for a parent pointer a[i] in [0, 2m); anything else flags
// the table.
__device__ __forceinline__ int node_of(const int* a, int i, int m,
                                       bool* bad) {
  const int v = a[clamp_slot(i)];
  if (static_cast<unsigned>(v) >= static_cast<unsigned>(2 * m)) *bad = true;
  return v >= m ? v - m : v;
}

// Smallest k with nodes_to_move <= k <= i and i <= a[k] % m; run by
// one whole warp, every lane with the same arguments and result.
//
// Where P(k) = a[k] % m > i holds at k = i (nearly every call), it holds
// on a valid table from the answer up to i and nowhere below: two
// warp-wide probes find the answer, 32 points spread over [lo, i], then
// the (at most 8) slots of the bracket the first hit closes.  A probe
// whose hits are not a run up to its end flags the table.  Otherwise the
// answer lies above i, where P need not be monotone: the scalar binary
// search runs as the sequential allocator runs it.
__device__ int first_node(const int* a, int m, int i, int nodes_to_move,
                          bool* bad) {
  const int limit = i;
  const unsigned lane = threadIdx.x & 31u;
  if (i >= nodes_to_move && node_of(a, i, m, bad) > limit) {
    const int lo = max(nodes_to_move, 0);
    const int stride = (limit - lo + 32) >> 5;  // ceil(len / 32)
    const int k1 = lo + static_cast<int>(lane) * stride;
    const unsigned in1 = __ballot_sync(~0u, k1 <= limit);
    const unsigned hit1 = __ballot_sync(
        ~0u, k1 <= limit && node_of(a, k1, m, bad) > limit);
    int bottom, top;  // the answer is in (bottom, top]
    if (hit1 == 0) {
      bottom = lo + (31 - __clz(in1)) * stride;
      top = limit;
    } else {
      const int f = __ffs(hit1) - 1;
      if (hit1 != (in1 & (~0u << f))) *bad = true;
      top = lo + f * stride;
      bottom = f == 0 ? lo - 1 : top - stride;
    }
    const int k2 = bottom + 1 + static_cast<int>(lane);
    const unsigned in2 = __ballot_sync(~0u, k2 < top);
    const unsigned hit2 = __ballot_sync(
        ~0u, k2 < top && node_of(a, k2, m, bad) > limit);
    if (hit2 != 0 && hit2 != (in2 & (~0u << (__ffs(hit2) - 1))))
      *bad = true;
    *bad = __any_sync(~0u, *bad);
    return hit2 != 0 ? bottom + __ffs(hit2) : top;
  }
  int k = m - 2;
  i = max(nodes_to_move - 1, i);
  for (int step = 0; step < kSearchSteps && k > i + 1; ++step) {
    const int mid = (i + k) >> 1;
    if (node_of(a, mid, m, bad) > limit) k = mid; else i = mid;
  }
  if (k > i + 1) *bad = true;
  *bad = __any_sync(~0u, *bad);
  return k;
}

// a[next-cnt+1 .. next] = depth, the warp's lanes writing in turn;
// returns the new next.
__device__ int fill_down(int* a, int next, int cnt, int depth, bool* bad) {
  if (cnt > next + 1) {
    *bad = true;
    return next;
  }
  for (int j = threadIdx.x & 31; j < cnt; j += 32) a[next - j] = depth;
  __syncwarp();
  return next - max(cnt, 0);
}

__device__ int bit_length(int x) { return x > 0 ? 32 - __clz(x) : 0; }

// Phase 1 of the allocator: extended parent pointers (one thread).
__device__ void phase1(int* a, int m) {
  a[0] += a[1];
  int head = 0, top = 2;
  for (int tail = 1; tail < m - 1; ++tail) {
    int total;
    if (top >= m || a[head] < a[top]) {
      total = a[head];
      a[head++] = tail;
    } else {
      total = a[top++];
    }
    if (top >= m || (head < tail && a[head] < a[top])) {
      total += a[head];
      a[head++] = tail + m;
    } else {
      total += a[top++];
    }
    a[tail] = total;
  }
}

// Run by one whole warp: phase 1, a dependent merge, on lane 0; phases
// 2 and 3 on every lane alike (warp-wide searches and fills).
__device__ bool allocate(int* a, int m, int max_len) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (m <= 2) {
    if (lead && m >= 1) a[0] = 1;
    if (lead && m == 2) a[1] = 1;
    __syncwarp();
    return true;
  }
  bool bad = false;

  // phase 1: extended parent pointers
  if (lead) phase1(a, m);
  __syncwarp();

  // phase 2: nodes to relocate
  int ntr = m - 2;
  for (int depth = 1; depth < max_len - 1 && ntr > 1; ++depth)
    ntr = first_node(a, m, ntr - 1, 0, &bad);

  // phase 3: depth fill
  int first = m - 2, next = m - 1;
  if (node_of(a, 0, m, &bad) >= ntr) {
    int depth = 1, available = 2, it = 0;
    for (; it < kMaxDepths && available > 0 && !bad; ++it) {
      const int last = first;
      first = first_node(a, m, last - 1, 0, &bad);
      next = fill_down(a, next, available - (last - first), depth, &bad);
      available = (last - first) << 1;
      ++depth;
    }
    if (available > 0) bad = true;
  } else {
    const int insert_depth = max_len - bit_length(ntr - 1);
    int depth = insert_depth == 1 ? 2 : 1;
    int left_to_move = insert_depth == 1 ? ntr - 2 : ntr;
    int available = depth << 1, it = 0;
    for (; it < kMaxDepths && available > 0 && !bad; ++it) {
      const int last = first;
      if (first > ntr) first = first_node(a, m, last - 1, ntr, &bad);
      int offset = 0;
      if (depth >= insert_depth) {
        offset = min(left_to_move, 1 << min(depth - insert_depth, 30));
      } else if (depth == insert_depth - 1) {
        offset = 1;
        if (a[clamp_slot(first)] == last) ++first;
      }
      next = fill_down(a, next, available - (last - first + offset), depth,
                       &bad);
      left_to_move -= offset;
      available = (last - first + offset) << 1;
      ++depth;
    }
    if (available > 0) bad = true;
  }
  return !bad;
}

__global__ void alloc_lengths_kernel(const int32_t* __restrict__ arrs,
                                     const int32_t* __restrict__ ms,
                                     int32_t* __restrict__ out,
                                     int32_t* __restrict__ err,
                                     int max_len) {
  __shared__ int a[kN];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kN;
  for (int i = threadIdx.x; i < kN; i += blockDim.x) a[i] = arrs[row + i];
  __syncthreads();
  const int m = ms[blockIdx.x];  // the block's one warp allocates
  const bool ok = m <= kN && allocate(a, m, max_len);
  if (threadIdx.x == 0) err[blockIdx.x] = ok ? 0 : 1;
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) out[row + i] = a[i];
}

constexpr int kBuildThreads = 288;           // 9 warps: one per symbol
constexpr int64_t kKeyLimit = int64_t{1} << 31;  // torch.sort's pad key

__global__ void __launch_bounds__(kBuildThreads)
code_lengths_kernel(const int32_t* __restrict__ freqs, int m,
                    int32_t* __restrict__ lens, int32_t* __restrict__ err,
                    int max_len) {
  __shared__ int64_t key[kN];
  __shared__ int a[kN];
  __shared__ int bad_input;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kN;
  const int s = threadIdx.x;
  if (s == 0) bad_input = 0;
  __syncthreads();
  int64_t my_key = 0;
  if (s < kN) {
    const int f = freqs[row + s];
    my_key = (static_cast<int64_t>(f) << 9) | s;
    if (s < m) {
      key[s] = my_key;
      // the plain sort pads with key 2^31 - 1: a key at or past it, or a
      // negative frequency, is not a table this build takes
      if (f < 0 || my_key >= kKeyLimit - 1) bad_input = 1;
    }
    a[s] = 0;
  }
  __syncthreads();
  int rank = 0;
  if (s < m) {
    for (int j = 0; j < m; ++j) rank += key[j] < my_key;
    a[rank] = static_cast<int>(my_key >> 9);
  }
  __syncthreads();
  if (s < 32) {  // warp 0 allocates
    const bool ok = m <= kN && !bad_input && allocate(a, m, max_len);
    if (s == 0 && !ok) atomicOr(err, 1);
  }
  __syncthreads();
  if (s < kN) lens[row + s] = s < m ? a[rank] : 0;
}

}  // namespace

// arrs, out: (B, 260) int32 sorted tables; ms, err: (B,) int32.
// Returns cudaGetLastError().
extern "C" int cz_alloc_lengths(const int32_t* arrs, const int32_t* ms,
                                int32_t* out, int32_t* err, int B,
                                int max_len, void* stream) {
  if (B > 0) {
    alloc_lengths_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        arrs, ms, out, err, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// freqs, lens: (B, 260) int32, frequencies and code lengths by symbol;
// 0 <= m <= 260 symbols in use; err: (1,) int32, set to 1 (never
// cleared) if a table is not allocated.  Returns cudaGetLastError().
extern "C" int cz_code_lengths(const int32_t* freqs, int m, int32_t* lens,
                               int32_t* err, int B, int max_len,
                               void* stream) {
  if (B > 0) {
    code_lengths_kernel<<<B, kBuildThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        freqs, m, lens, err, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}
