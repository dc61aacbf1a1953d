// Length-limited Huffman code-length allocator for Hopper (sm_90a).
//
// Replaces compressjs_tpu/ops/device_entropy.py:_alloc_kernel (launched
// by alloc_lengths_pallas).  Each table is a 260-slot buffer whose first
// m slots hold sorted symbol frequencies; the in-place algorithm of
// Milidiu, Pessoa and Laber turns them into code lengths of at most
// max_len bits in three phases: extended parent pointers, nodes to
// relocate, then a plain or a relocating depth fill.
//
// What bounds it: latency.  A launch carries at most 6 tables of a few
// hundred dependent scalar steps each, about 9 launches per 900 KB
// block; no layout makes that wide.  As on the TPU (scalar loops over an
// SMEM table), one thread runs one table out of shared memory; one
// block per table lets the tables run on separate SMs, and the block's
// warp copies the table in and out with coalesced loads.
//
// Every loop has a fixed upper bound, so a table that breaks the
// algorithm's invariants cannot hang the card: the galloping and binary
// searches stop after kSearchSteps, the depth loops after kMaxDepths,
// and a fill may not run below slot 0.  A table that hits a bound gets
// err[b] = 1 and the caller raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 260;          // static alphabet buffer
constexpr int kSearchSteps = 10; // both searches need <= 9 for kN slots
constexpr int kMaxDepths = 32;   // a depth fill ends by depth max_len <= 20

__device__ __forceinline__ int clamp_slot(int i) {
  return i < 0 ? 0 : (i > kN - 1 ? kN - 1 : i);
}

// Smallest k with nodes_to_move <= k <= i and i <= a[k] % m.
__device__ int first_node(const int* a, int m, int i, int nodes_to_move,
                          bool* bad) {
  const int limit = i;
  int k = m - 2;
  for (int step = 0; step < kSearchSteps; ++step) {
    if (!(i >= nodes_to_move && a[clamp_slot(i)] % m > limit)) break;
    k = i;
    i -= limit - i + 1;
  }
  if (i >= nodes_to_move && a[clamp_slot(i)] % m > limit) *bad = true;
  i = max(nodes_to_move - 1, i);
  for (int step = 0; step < kSearchSteps && k > i + 1; ++step) {
    const int mid = (i + k) >> 1;
    if (a[clamp_slot(mid)] % m > limit) k = mid; else i = mid;
  }
  if (k > i + 1) *bad = true;
  return k;
}

// a[next-cnt+1 .. next] = depth; returns the new next.
__device__ int fill_down(int* a, int next, int cnt, int depth, bool* bad) {
  if (cnt > next + 1) {
    *bad = true;
    return next;
  }
  for (int j = 0; j < cnt; ++j) a[next--] = depth;
  return next;
}

__device__ int bit_length(int x) { return x > 0 ? 32 - __clz(x) : 0; }

__device__ bool allocate(int* a, int m, int max_len) {
  if (m <= 2) {
    if (m >= 1) a[0] = 1;
    if (m == 2) a[1] = 1;
    return true;
  }
  bool bad = false;

  // phase 1: extended parent pointers
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

  // phase 2: nodes to relocate
  int ntr = m - 2;
  for (int depth = 1; depth < max_len - 1 && ntr > 1; ++depth)
    ntr = first_node(a, m, ntr - 1, 0, &bad);

  // phase 3: depth fill
  int first = m - 2, next = m - 1;
  if (a[0] % m >= ntr) {
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
  if (threadIdx.x == 0) {
    const int m = ms[blockIdx.x];
    const bool ok = m <= kN && allocate(a, m, max_len);
    err[blockIdx.x] = ok ? 0 : 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN; i += blockDim.x) out[row + i] = a[i];
}

}  // namespace

// arrs, out: (B, 260) int32; ms, err: (B,) int32.  Returns
// cudaGetLastError().
extern "C" int cz_alloc_lengths(const int32_t* arrs, const int32_t* ms,
                                int32_t* out, int32_t* err, int B,
                                int max_len, void* stream) {
  if (B > 0) {
    alloc_lengths_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        arrs, ms, out, err, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}
