// Native host runtime of compressjs_tpu_torch: the sequential host stages
// of the bzip2 encode that the `core` and `hybrid` splits run beside the
// card, and the host cyclic BWT that `self_check` holds the card against.
//
// Copied from the JAX package's native runtime, with only what this
// package calls: the SA-IS and two-stage suffix sorters, the
// length-limited Huffman allocator, and the exports cz_huff_code_lengths,
// cz_selector_mtf, cz_bwt_cyclic, cz_mtf_rle2, cz_group_costs,
// cz_chunk_freqs, cz_payload_pack and cz_rle1_encode.  Built by g++ at
// first use and loaded with ctypes (native/__init__.py).

#include <cstdint>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// SA-IS suffix array construction over an integer alphabet.
//
// T: input of length n over [0, K).  SA: output length n.
// Memory: uses internal buffers; recursion halves the problem size.
// The passes are memory-bound, so the working types matter: IdxT is
// int32 for every input this framework produces (blocks <= 900 KB,
// doubled <= 1.8 M), the top-level text is uint16 (alphabet 257 after
// the sentinel shift), and the S/L type map is a byte array — together
// ~4x less memory traffic than the naive int64 layout.

template <typename CharT, typename IdxT>
void count_chars(const CharT* T, IdxT n, IdxT K, IdxT* cnt) {
  std::fill(cnt, cnt + K, 0);
  for (IdxT i = 0; i < n; i++) cnt[T[i]]++;
}

template <typename IdxT>
void bucket_heads(const IdxT* cnt, IdxT K, IdxT* bkt) {
  IdxT sum = 0;
  for (IdxT c = 0; c < K; c++) { bkt[c] = sum; sum += cnt[c]; }
}

template <typename IdxT>
void bucket_tails(const IdxT* cnt, IdxT K, IdxT* bkt) {
  IdxT sum = 0;
  for (IdxT c = 0; c < K; c++) { sum += cnt[c]; bkt[c] = sum; }
}

// stype[i] = 1 if suffix i is S-type
template <typename CharT, typename IdxT>
void classify(const CharT* T, IdxT n, std::vector<uint8_t>& stype) {
  stype.assign(n, 0);
  stype[n - 1] = 1;  // sentinel position (virtual $ handled by caller)
  for (IdxT i = n - 2; i >= 0; i--)
    stype[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && stype[i + 1]))
                   ? 1 : 0;
}

template <typename IdxT>
inline bool is_lms(const std::vector<uint8_t>& stype, IdxT i) {
  return i > 0 && stype[i] && !stype[i - 1];
}

template <typename CharT, typename IdxT>
void induce(const CharT* T, IdxT* SA, IdxT n, IdxT K,
            const IdxT* cnt, const std::vector<uint8_t>& stype,
            std::vector<IdxT>& bkt) {
  // L-type pass (left to right, bucket heads)
  bucket_heads<IdxT>(cnt, K, bkt.data());
  // virtual sentinel suffix induces T[n-1]
  {
    IdxT j = n - 1;
    if (!stype[j]) SA[bkt[T[j]]++] = j;
    else { /* placed in S pass */ }
  }
  // the sentinel's predecessor is n-1; handle by seeding above, then scan
  for (IdxT i = 0; i < n; i++) {
    IdxT j = SA[i];
    if (j > 0 && !stype[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
  }
  // S-type pass (right to left, bucket tails)
  bucket_tails<IdxT>(cnt, K, bkt.data());
  for (IdxT i = n - 1; i >= 0; i--) {
    IdxT j = SA[i];
    if (j > 0 && stype[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
  }
}

template <typename CharT, typename IdxT>
void sais_core(const CharT* T, IdxT* SA, IdxT n, IdxT K) {
  if (n == 1) { SA[0] = 0; return; }
  std::vector<uint8_t> stype;
  classify<CharT, IdxT>(T, n, stype);
  std::vector<IdxT> cnt(K), bkt(K);
  count_chars<CharT, IdxT>(T, n, K, cnt.data());

  // step 1: place LMS suffixes at bucket tails, induce-sort LMS substrings
  std::fill(SA, SA + n, (IdxT)-1);
  bucket_tails<IdxT>(cnt.data(), K, bkt.data());
  for (IdxT i = n - 1; i >= 1; i--)
    if (is_lms<IdxT>(stype, i)) SA[--bkt[T[i]]] = i;
  induce<CharT, IdxT>(T, SA, n, K, cnt.data(), stype, bkt);

  // step 2: name LMS substrings in sorted order.  NOTE: the comparison
  // deliberately stops at the next LMS position WITHOUT comparing the
  // terminal character — that is the equivalence the step-1 induced
  // sort actually ordered by (ties on it appear in arbitrary order, so
  // a finer partition here would assign names inconsistent with true
  // suffix order); the terminal character's ordering is recovered in
  // the reduced problem, where it starts the next symbol's substring.
  std::vector<IdxT> lms_order;
  lms_order.reserve(n / 2 + 1);
  for (IdxT i = 0; i < n; i++)
    if (SA[i] > 0 && is_lms<IdxT>(stype, SA[i])) lms_order.push_back(SA[i]);
  // map position -> compact LMS index
  std::vector<IdxT> lms_pos;
  for (IdxT i = 1; i < n; i++)
    if (is_lms<IdxT>(stype, i)) lms_pos.push_back(i);
  IdxT m = (IdxT)lms_pos.size();
  std::vector<IdxT> name_of(n, -1);
  IdxT names = 0;
  IdxT prev = -1;
  for (IdxT r = 0; r < (IdxT)lms_order.size(); r++) {
    IdxT p = lms_order[r];
    if (prev < 0) { name_of[p] = names; prev = p; continue; }
    // compare LMS substrings at prev and p
    bool same = true;
    for (IdxT d = 0;; d++) {
      bool pl = is_lms<IdxT>(stype, p + d), ql = is_lms<IdxT>(stype, prev + d);
      if (d > 0 && (pl || ql)) { same = pl && ql; break; }
      if (p + d >= n || prev + d >= n) { same = false; break; }
      if (T[p + d] != T[prev + d] || stype[p + d] != stype[prev + d]) {
        same = false; break;
      }
    }
    if (!same) names++;
    name_of[p] = names;
    prev = p;
  }
  names++;

  // step 3: solve the reduced problem
  std::vector<IdxT> reduced(m), red_sa(m);
  for (IdxT i = 0; i < m; i++) reduced[i] = name_of[lms_pos[i]];
  if (names < m) {
    sais_core<IdxT, IdxT>(reduced.data(), red_sa.data(), m, names);
  } else {
    for (IdxT i = 0; i < m; i++) red_sa[reduced[i]] = i;
  }

  // step 4: place LMS suffixes in final order, induce everything
  std::fill(SA, SA + n, (IdxT)-1);
  bucket_tails<IdxT>(cnt.data(), K, bkt.data());
  for (IdxT i = m - 1; i >= 0; i--) {
    IdxT p = lms_pos[red_sa[i]];
    SA[--bkt[T[p]]] = p;
  }
  induce<CharT, IdxT>(T, SA, n, K, cnt.data(), stype, bkt);
}

// ---------------------------------------------------------------------------
// Two-stage suffix/rotation sorter (the divsufsort / Itoh-Tanaka family),
// in a linear (EOF-terminated suffixes) and a cyclic (bzip2 rotations)
// variant.  Only the type-B* entries (a type-B position whose successor
// is type A; at most n/2, ~n/3 on text) get a full comparison sort: a
// 2-byte radix split into (c0,c1) buckets followed by multikey introsort
// on the B* substrings, with remaining ties resolved by doubling on the
// reduced name string.  Every other suffix/rotation is then *induced* in
// two linear scans, exactly as in SA-IS.  The payoff over running SA-IS
// on the full text: the top level works on the raw uint8 text (no uint16
// sentinel copy), only m <= n/2 elements are sorted, the multikey sort
// is cache-friendly where SA-IS's induced scatter passes are not — and
// the cyclic variant sorts the n rotations DIRECTLY, where the previous
// design suffix-sorted the doubled string (2x the work, plus every B*
// tied with its second-half twin, the worst case for tie resolution).
//
// Substring comparison semantics (matching the published divsufsort
// design): the B* substring of position P[e] extends to two characters
// past the NEXT B* position (cyclically for the rotation sort; bound n
// for the last linear entry); a substring that exhausts its bound first
// compares smaller; substrings compare equal only when both exhaust
// together (same length), which makes the name-string reduction
// order-exact.

namespace dss {

struct Ctx {
  const uint8_t* W;    // text window (linear: T; cyclic: T.T + 2 bytes)
  const int32_t* P;    // B* positions, ascending
  const int32_t* bnd;  // per-entry substring end (exclusive) in W
  int32_t* base;       // start of the packed B* order array (tie marks)
  uint8_t* tie;        // tie[r] = 1 iff entry at rank r equals rank r-1
  inline int ch(int32_t e, int32_t d) const {
    int32_t p = P[e] + d;
    return p < bnd[e] ? (int)W[p] : -1;
  }
  // two characters at once: ((W[d]+1) << 9 | (W[d+1]+1)), with 0 for an
  // exhausted second char and -1 for a fully exhausted substring —
  // ordering identical to two successive ch() comparisons
  inline int ch2(int32_t e, int32_t d) const {
    int32_t p = P[e] + d, b = bnd[e];
    if (p >= b) return -1;
    int hi = ((int)W[p] + 1) << 9;
    return p + 1 < b ? hi | ((int)W[p + 1] + 1) : hi;
  }
  // compare B* substrings e1, e2 from character `depth`
  inline int cmp(int32_t e1, int32_t e2, int32_t depth) const {
    int32_t p1 = P[e1] + depth, b1 = bnd[e1];
    int32_t p2 = P[e2] + depth, b2 = bnd[e2];
    while (p1 < b1 && p2 < b2 && W[p1] == W[p2]) { p1++; p2++; }
    if (p1 < b1) return p2 < b2 ? (int)W[p1] - (int)W[p2] : 1;
    return p2 < b2 ? -1 : 0;
  }
};

void bstar_insertion_sort(const Ctx& c, int32_t* a, int32_t len,
                          int32_t depth) {
  for (int32_t i = 1; i < len; i++) {
    int32_t v = a[i], j = i - 1;
    while (j >= 0 && c.cmp(v, a[j], depth) < 0) { a[j + 1] = a[j]; j--; }
    a[j + 1] = v;
  }
  // these positions are final: record full-substring ties for naming
  for (int32_t i = 1; i < len; i++)
    if (c.cmp(a[i - 1], a[i], depth) == 0) c.tie[(a - c.base) + i] = 1;
}

// Bentley-Sedgewick multikey quicksort on B* substrings, two characters
// per level (ch2 keys), halving the partition passes over a per-char
// descent.  Recurses on the two smaller partitions and loops on the
// largest, so stack depth is O(log len).
void bstar_mkqsort(const Ctx& c, int32_t* a, int32_t len, int32_t depth) {
  while (len > 8) {
    int x = c.ch2(a[0], depth), y = c.ch2(a[len / 2], depth),
        z = c.ch2(a[len - 1], depth);
    int pv = x < y ? (y < z ? y : (x < z ? z : x))
                   : (x < z ? x : (y < z ? z : y));
    // ternary partition on the character pair at `depth`
    int32_t lt = 0, gt = len, p = 0;
    while (p < gt) {
      int cc = c.ch2(a[p], depth);
      if (cc < pv) std::swap(a[lt++], a[p++]);
      else if (cc > pv) std::swap(a[--gt], a[p]);
      else p++;
    }
    int32_t l1 = lt, l2 = gt - lt, l3 = len - gt;
    // the equal partition is final when its substrings exhausted: at
    // this depth (pv == -1) or one char in (pv low bits == 0).  Either
    // way the entries share a full substring (same content AND length)
    // and their position range [lt, gt) is final — record the ties.
    bool settled = pv < 0 || (pv & 511) == 0;
    if (settled && l2 > 1)
      for (int32_t t = lt + 1; t < gt; t++) c.tie[(a - c.base) + t] = 1;
    struct Seg { int32_t off, len, depth; } segs[3];
    int ns = 0;
    if (l1 > 1) segs[ns++] = {0, l1, depth};
    if (l2 > 1 && !settled) segs[ns++] = {l1, l2, depth + 2};
    if (l3 > 1) segs[ns++] = {l1 + l2, l3, depth};
    if (ns == 0) return;
    int largest = 0;
    for (int s = 1; s < ns; s++)
      if (segs[s].len > segs[largest].len) largest = s;
    for (int s = 0; s < ns; s++)
      if (s != largest)
        bstar_mkqsort(c, a + segs[s].off, segs[s].len, segs[s].depth);
    a += segs[largest].off;
    len = segs[largest].len;
    depth = segs[largest].depth;
  }
  if (len > 1) bstar_insertion_sort(c, a, len, depth);
}

// --- Larsson-Sadakane doubling (the trsort stage) ----------------------
// Resolves remaining B* ties by sorting the reduced name string's
// suffixes (linear) or rotations (cyclic), touching ONLY still-tied
// groups — after the substring sort most ranks are already unique.
// I[0..M): reduced positions, with sorted runs stored as a negative run
// length at the run start.  V[p]: group id = index of the group's LAST
// element in I.
//
// Sort one still-tied group [lo, lo+len) by the doubling key V at p+h.
// The keys are SNAPSHOTTED before any V write: a group's keys may point
// into the group itself, and updating V mid-sort would mutate keys
// between comparisons (observed inversion on periodic inputs).  With
// the snapshot, self-referential groups split by their start-of-group
// ranks (plain Manber-Myers freshness — resolved one pass later), while
// groups processed earlier in the same pass still hand later groups
// their refined ranks (the Larsson-Sadakane acceleration, which is
// consistent because a finished group's ids are final for the pass).

using LsScratch = std::vector<std::pair<int32_t, int32_t>>;

template <bool CYCLIC>
void ls_sort_group(int32_t* I, int32_t* V, int32_t M, int32_t lo,
                   int32_t len, int32_t h, LsScratch& scratch) {
  if (len == 1) { V[I[lo]] = lo; I[lo] = -1; return; }
  scratch.resize(len);
  for (int32_t i = 0; i < len; i++) {
    int32_t p = I[lo + i] + h;
    if (CYCLIC && p >= M) p -= M;  // h < M, so one subtraction suffices
    scratch[i] = {V[p], I[lo + i]};
  }
  std::sort(scratch.begin(), scratch.end());
  int32_t i = 0;
  while (i < len) {
    int32_t j = i + 1;
    while (j < len && scratch[j].first == scratch[i].first) j++;
    for (int32_t t = i; t < j; t++) {
      I[lo + t] = scratch[t].second;
      V[scratch[t].second] = lo + j - 1;
    }
    if (j - i == 1) I[lo + i] = -1;
    i = j;
  }
}

template <bool CYCLIC>
void ls_pass(int32_t* I, int32_t* V, int32_t M, int32_t h,
             LsScratch& scratch) {
  int32_t i = 0, sl = 0;
  while (i < M) {
    int32_t s = I[i];
    if (s < 0) {
      i -= s;       // skip a sorted run of length -s
      sl += s;      // and accumulate it
    } else {
      if (sl) { I[i + sl] = sl; sl = 0; }  // store combined run start
      int32_t gend = V[s];
      ls_sort_group<CYCLIC>(I, V, M, i, gend - i + 1, h, scratch);
      i = gend + 1;
    }
  }
  if (sl) I[i + sl] = sl;
}

// Linear variant: position M-1 is the unique sentinel (smallest), which
// guarantees p+h <= M-1 for every entry of an unsorted group.
void ls_sort(int32_t* I, int32_t* V, int32_t M) {
  LsScratch scratch;
  for (int32_t h = 1; I[0] != -M; h *= 2)
    ls_pass<false>(I, V, M, h, scratch);
}

// Cyclic variant: keys wrap mod M.  Groups still unsorted once h >= M
// consist of IDENTICAL rotations of the name string (their members
// share a rank prefix of length >= M); they are ordered by descending
// reduced index, which maps back to descending text position — the
// order the reference's doubled-string sort gives identical rotations
// (the shorter doubled-string suffix, i.e. the larger start index,
// sorts first; reference BWT.js:372-417 keeps exactly those).
void ls_sort_cyclic(int32_t* I, int32_t* V, int32_t M) {
  LsScratch scratch;
  for (int32_t h = 1; I[0] != -M && h < M; h *= 2)
    ls_pass<true>(I, V, M, h, scratch);
  if (I[0] == -M) return;
  // resolve identical-rotation groups by descending reduced index
  int32_t i = 0;
  while (i < M) {
    int32_t s = I[i];
    if (s < 0) { i -= s; continue; }
    int32_t gend = V[s];
    std::sort(I + i, I + gend + 1, std::greater<int32_t>());
    for (int32_t t = i; t <= gend; t++) V[I[t]] = t;
    i = gend + 1;
  }
}

// --- shared helpers -----------------------------------------------------

struct Buckets {
  std::vector<int32_t> cntA, cntB, cntBs;     // counts
  std::vector<int32_t> Ahead, BsStart, Bend;  // layout offsets
  Buckets() : cntA(256, 0), cntB(65536, 0), cntBs(65536, 0),
              Ahead(256), BsStart(65536), Bend(65536) {}
  void layout() {
    int32_t off = 0;
    for (int c0 = 0; c0 < 256; c0++) {
      Ahead[c0] = off;
      off += cntA[c0];
      for (int c1 = c0; c1 < 256; c1++) {
        int key = (c0 << 8) | c1;
        BsStart[key] = off;
        off += cntBs[key] + cntB[key];
        Bend[key] = off;
      }
    }
  }
};

// Sort the B* entries exactly.  On return bs[0..m) holds B* indices in
// final (suffix/rotation) order.  `W` is the read window, `bnd` the
// per-entry substring bounds.
void sort_bstar(const uint8_t* W, const std::vector<int32_t>& P,
                const std::vector<int32_t>& bnd, std::vector<int32_t>& bs,
                bool cyclic) {
  int32_t m = (int32_t)P.size();
  // radix split by (c0,c1) into a packed array of indices into P
  std::vector<int32_t> bsOff(65537, 0);
  for (int32_t k = 0; k < m; k++)
    bsOff[(((int)W[P[k]] << 8) | W[P[k] + 1]) + 1]++;
  for (int key = 0; key < 65536; key++) bsOff[key + 1] += bsOff[key];
  bs.resize(m);
  {
    std::vector<int32_t> cur(bsOff.begin(), bsOff.begin() + 65536);
    for (int32_t k = 0; k < m; k++) {
      int key = ((int)W[P[k]] << 8) | W[P[k] + 1];
      bs[cur[key]++] = k;
    }
  }
  std::vector<uint8_t> tie(m, 0);
  Ctx c{W, P.data(), bnd.data(), bs.data(), tie.data()};
  for (int key = 0; key < 65536; key++) {
    int32_t len = bsOff[key + 1] - bsOff[key];
    if (len > 1) bstar_mkqsort(c, bs.data() + bsOff[key], len, 2);
  }
  int32_t ties = 0;
  for (int32_t r = 1; r < m; r++) ties += tie[r];
  if (ties == 0) return;

  if (!cyclic && ties * 4 > m) {
    // heavy-tie case (e.g. long periodic runs): doubling would need
    // many passes over large groups; a from-scratch SA-IS solve of the
    // reduced name string is O(m) regardless.  Names fall out of the
    // tie bitmap — no re-comparison needed.
    std::vector<int32_t> R(m + 1), RS(m + 1);
    int32_t nm = 1;
    for (int32_t r = 0; r < m; r++) {
      if (r > 0 && !tie[r]) nm++;
      R[bs[r]] = nm;
    }
    R[m] = 0;  // sentinel
    sais_core<int32_t, int32_t>(R.data(), RS.data(), m + 1, nm + 1);
    for (int32_t i = 1; i <= m; i++) bs[i - 1] = RS[i];
    return;
  }

  if (cyclic && ties == m - 1) {
    // every entry tied: the name string is constant, all its rotations
    // identical — descending index order directly
    for (int32_t k = 0; k < m; k++) bs[k] = m - 1 - k;
    return;
  }

  // Larsson-Sadakane doubling over the reduced name string.  Reduced
  // position k = B* index k; linear gets the sentinel position m.
  int32_t M = cyclic ? m : m + 1;
  std::vector<int32_t> I(M), V(M);
  int32_t b0 = cyclic ? 0 : 1;  // I-offset of rank 0
  if (!cyclic) { V[m] = 0; I[0] = -1; }
  int32_t r = 0;
  while (r < m) {
    int32_t j = r;
    while (j + 1 < m && tie[j + 1]) j++;
    for (int32_t t = r; t <= j; t++) V[bs[t]] = b0 + j;
    if (j == r) I[b0 + r] = -1;
    else for (int32_t t = r; t <= j; t++) I[b0 + t] = bs[t];
    r = j + 1;
  }
  if (cyclic) ls_sort_cyclic(I.data(), V.data(), M);
  else ls_sort(I.data(), V.data(), M);
  // V[k] is now the final rank of B* index k
  for (int32_t k = 0; k < m; k++) bs[V[k] - b0] = k;
}

// --- cyclic variant: rotation order of T (the bzip2 BWT sort) ----------
// Output: SA[r] = start position of the r-th smallest rotation, with
// identical rotations ordered by DESCENDING start position (matching
// the doubled-string sort of reference BWT.js:372-417: of two identical
// rotations, the larger start index is the shorter doubled-string
// suffix, a prefix of the longer one, so it sorts first).

void cyclic_divsufsort32(const uint8_t* T, int32_t* SA, int32_t n) {
  if (n <= 0) return;
  if (n == 1) { SA[0] = 0; return; }

  // read window: T.T plus two bytes so the widest substring
  // (single B*: length n+2 starting at up to n-1) stays in bounds
  std::vector<uint8_t> W(2 * n + 2);
  std::memcpy(W.data(), T, n);
  std::memcpy(W.data() + n, T, n);
  W[2 * n] = T[0];
  W[2 * n + 1] = T[1];

  // cyclic types via the doubled window: for i < n the first strict
  // inequality lies within [i, i+n) unless T is constant
  std::vector<uint8_t> types(n);
  {
    bool constant = true;
    for (int32_t i = 1; i < n; i++)
      if (T[i] != T[0]) { constant = false; break; }
    if (constant) {
      // all rotations identical: descending start position
      for (int32_t r = 0; r < n; r++) SA[r] = n - 1 - r;
      return;
    }
    uint8_t t = 0;
    for (int32_t i = 2 * n - 2; i >= 0; i--) {
      t = W[i] < W[i + 1] ? 1 : (W[i] > W[i + 1] ? 0 : t);
      if (i < n) types[i] = t;
    }
  }

  Buckets bk;
  int32_t m = 0;
  for (int32_t i = 0; i < n; i++) {
    uint8_t tnext = types[i + 1 == n ? 0 : i + 1];
    if (types[i]) {
      int key = ((int)T[i] << 8) | W[i + 1];
      if (!tnext) { bk.cntBs[key]++; m++; }
      else bk.cntB[key]++;
    } else {
      bk.cntA[T[i]]++;
    }
  }
  bk.layout();

  // m >= 1: a non-constant cycle has at least one B->A transition
  std::vector<int32_t> P(m), bnd(m);
  {
    int32_t k = 0;
    for (int32_t i = 0; i < n; i++)
      if (types[i] && !types[i + 1 == n ? 0 : i + 1]) P[k++] = i;
    for (int32_t e = 0; e + 1 < m; e++) bnd[e] = P[e + 1] + 2;
    bnd[m - 1] = P[0] + n + 2;  // wrap to the first B*, via the window
  }
  std::vector<int32_t> bs;
  sort_bstar(W.data(), P, bnd, bs, /*cyclic=*/true);

  {
    std::vector<int32_t> cur(bk.BsStart);
    for (int32_t r = 0; r < m; r++) {
      int32_t pos = P[bs[r]];
      int key = ((int)T[pos] << 8) | W[pos + 1];
      SA[cur[key]++] = pos;
    }
  }
  // induce non-B* type-B rotations (predecessors wrap: every rotation
  // has one; rank(k) < rank(k+1) stays strict because adjacent
  // identical rotations would make T constant, handled above)
  {
    std::vector<int32_t> cur(bk.Bend);
    for (int c0 = 255; c0 >= 0; c0--) {
      int32_t lo = bk.BsStart[(c0 << 8) | c0];
      int32_t hi = bk.Bend[(c0 << 8) | 255];
      for (int32_t i = hi - 1; i >= lo; i--) {
        int32_t j = SA[i];
        int32_t k = j == 0 ? n - 1 : j - 1;
        if (types[k]) {
          int key = ((int)T[k] << 8) | T[j];
          SA[--cur[key]] = k;
        }
      }
    }
  }
  // induce type-A rotations: no seed needed — the globally smallest
  // rotation is always type B (strictly below its successor), so the
  // left-to-right scan starts on placed material
  {
    std::vector<int32_t> cur(bk.Ahead);
    for (int32_t i = 0; i < n; i++) {
      int32_t j = SA[i];
      int32_t k = j == 0 ? n - 1 : j - 1;
      if (!types[k]) SA[cur[T[k]]++] = k;
    }
  }
}

}  // namespace dss

// ---------------------------------------------------------------------------
// Static length-limited canonical Huffman code-length allocation: the
// in-place Milidiu/Pessoa/Laber algorithm, a direct native build of
// coders/huffman_allocator.py (itself matching reference
// HuffmanAllocator.js:52-222).  Called ~44x per bzip2 block by the
// group-optimization loop, which made the Python version ~25% of the
// entropy stage.

namespace huffalloc {

int32_t first_node(const int64_t* a, int32_t len, int32_t i, int32_t ntm) {
  int32_t limit = i, k = len - 2;
  while (i >= ntm && (a[i] % len) > limit) {
    k = i;
    i -= (limit - i + 1);
  }
  i = std::max(ntm - 1, i);
  while (k > i + 1) {
    int32_t mid = (i + k) >> 1;
    if ((a[mid] % len) > limit) k = mid;
    else i = mid;
  }
  return k;
}

void set_extended_parent_pointers(int64_t* a, int32_t len) {
  a[0] += a[1];
  int32_t head = 0, top = 2;
  for (int32_t tail = 1; tail < len - 1; tail++) {
    int64_t total;
    if (top >= len || a[head] < a[top]) {
      total = a[head];
      a[head] = tail;
      head++;
    } else {
      total = a[top];
      top++;
    }
    if (top >= len || (head < tail && a[head] < a[top])) {
      total += a[head];
      a[head] = tail + len;
      head++;
    } else {
      total += a[top];
      top++;
    }
    a[tail] = total;
  }
}

int32_t find_nodes_to_relocate(const int64_t* a, int32_t len,
                               int32_t maximum_length) {
  int32_t node = len - 2;
  int32_t depth = 1;
  while (depth < maximum_length - 1 && node > 1) {
    node = first_node(a, len, node - 1, 0);
    depth++;
  }
  return node;
}

void allocate_node_lengths(int64_t* a, int32_t len) {
  int32_t fst = len - 2, nxt = len - 1;
  int32_t depth = 1, available = 2;
  while (available > 0) {
    int32_t last = fst;
    fst = first_node(a, len, last - 1, 0);
    for (int32_t i = 0; i < available - (last - fst); i++) {
      if (nxt < 0) return;  // defensive; see the relocation variant
      a[nxt--] = depth;
    }
    available = (last - fst) << 1;
    depth++;
  }
}

void allocate_node_lengths_with_relocation(int64_t* a, int32_t len,
                                           int32_t ntm,
                                           int32_t insert_depth) {
  int32_t fst = len - 2, nxt = len - 1;
  int32_t depth = insert_depth == 1 ? 2 : 1;
  int32_t left_to_move = insert_depth == 1 ? ntm - 2 : ntm;
  int32_t available = depth << 1;
  while (available > 0) {
    int32_t last = fst;
    if (fst > ntm) fst = first_node(a, len, last - 1, ntm);
    int32_t offset = 0;
    if (depth >= insert_depth) {
      offset = std::min(left_to_move,
                        (int32_t)1 << (depth - std::max(insert_depth, 1)));
    } else if (depth == insert_depth - 1) {
      offset = 1;
      if (a[fst] == last) fst++;
    }
    for (int32_t i = 0; i < available - (last - fst + offset); i++) {
      if (nxt < 0) return;  // infeasible (maxlen, n) combination: the
                            // codecs never produce one (bzip2: maxlen
                            // 20, <= 258 symbols); stay memory-safe
      a[nxt--] = depth;
    }
    left_to_move -= offset;
    available = (last - fst + offset) << 1;
    depth++;
  }
}

void allocate(int64_t* a, int32_t n, int32_t maximum_length) {
  if (n <= 2) {
    if (n == 2) a[1] = 1;
    if (n >= 1) a[0] = 1;
    return;
  }
  set_extended_parent_pointers(a, n);
  int32_t ntm = find_nodes_to_relocate(a, n, maximum_length);
  if ((a[0] % n) >= ntm) {
    allocate_node_lengths(a, n);
  } else {
    int32_t bl = 0;
    for (int32_t v = ntm - 1; v > 0; v >>= 1) bl++;
    allocate_node_lengths_with_relocation(a, n, ntm, maximum_length - bl);
  }
}

}  // namespace huffalloc

}  // namespace

extern "C" {

// Length-limited canonical Huffman code lengths for `freq[0..n)`
// (reference StaticHuffman ctor, Bzip2.js:551-579): sort (freq<<9|sym),
// allocate in place, scatter lengths back by symbol.
void cz_huff_code_lengths(const int64_t* freq, int32_t n, int32_t maxlen,
                          uint8_t* lengths) {
  std::vector<int64_t> merged(n);
  for (int32_t i = 0; i < n; i++)
    merged[i] = (freq[i] << 9) | i;
  std::sort(merged.begin(), merged.end());
  std::vector<int64_t> arr(n);
  for (int32_t i = 0; i < n; i++) arr[i] = merged[i] >> 9;
  huffalloc::allocate(arr.data(), n, maxlen);
  for (int32_t i = 0; i < n; i++)
    lengths[merged[i] & 0x1FF] = (uint8_t)arr[i];
}

// Selectors MTF'd then unary-coded as 0/1 bytes (reference
// Bzip2.js:849-862).  `out` needs nsel * n_groups bytes; returns the
// bit count.
int64_t cz_selector_mtf(const uint8_t* sel, int64_t nsel, int32_t n_groups,
                        uint8_t* out) {
  if (n_groups < 1 || n_groups > 6) return -1;
  uint8_t lst[8];
  for (int32_t i = 0; i < n_groups; i++) lst[i] = (uint8_t)i;
  int64_t o = 0;
  for (int64_t s = 0; s < nsel; s++) {
    uint8_t v = sel[s];
    int32_t j = 0;
    while (j < n_groups && lst[j] != v) j++;
    if (j >= n_groups) return -1;  // invalid selector
    for (int32_t t = j; t > 0; t--) lst[t] = lst[t - 1];
    lst[0] = v;
    for (int32_t t = 0; t < j; t++) out[o++] = 1;
    out[o++] = 0;
  }
  return o;
}

// Cyclic BWT (ties: larger start index first).  Sorts the n rotations
// directly with the cyclic two-stage sorter — no doubled string.
// Returns pidx.
int64_t cz_bwt_cyclic(const uint8_t* T, uint8_t* U, int64_t n) {
  if (n <= 0 || 2 * n >= (int64_t)INT32_MAX - 1) return 0;
  if (n == 1) { U[0] = T[0]; return 0; }
  std::vector<int32_t> SA(n);
  dss::cyclic_divsufsort32(T, SA.data(), (int32_t)n);
  int64_t pidx = 0;
  for (int64_t r = 0; r < n; r++) {
    int32_t s = SA[r];
    if (s == 0) pidx = r;
    U[r] = T[s == 0 ? n - 1 : s - 1];
  }
  return pidx;
}


// Fused MTF + RLE2: BWT column -> bzip2 symbol stream (zero runs as
// bijective base-2 RUNA/RUNB digits, literal j -> j+1, EOB appended) with
// the frequency histogram.  Returns symbol count.
int64_t cz_mtf_rle2(const uint8_t* U, int64_t n, const uint8_t* alphabet,
                    int32_t asize, uint16_t* syms, int64_t* freq) {
  uint8_t list[256];
  std::memcpy(list, alphabet, asize);
  int32_t eob = asize + 1;
  for (int i = 0; i <= eob; i++) freq[i] = 0;
  int64_t out = 0;
  int64_t run = 0;
  auto flush_run = [&]() {
    while (run) {
      int d = (run & 1) ? 0 : 1;  // RUNA : RUNB
      syms[out++] = (uint16_t)d;
      freq[d]++;
      run = (run - 1 - d) >> 1;
    }
  };
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = U[i];
    int32_t j = 0;
    while (list[j] != c) j++;
    if (j) {
      std::memmove(list + 1, list, j);
      list[0] = c;
      flush_run();
      syms[out++] = (uint16_t)(j + 1);
      freq[j + 1]++;
    } else {
      run++;
    }
  }
  flush_run();
  syms[out++] = (uint16_t)eob;
  freq[eob]++;
  return out;
}

// Per-50-symbol-chunk bit costs under each Huffman table.
// lengths: uint8[n_groups][alpha]; costs out: int64[n_chunks][n_groups].
void cz_group_costs(const uint16_t* syms, int64_t count,
                    const uint8_t* lengths, int32_t n_groups,
                    int32_t alpha, int64_t* costs) {
  int64_t n_chunks = (count + 49) / 50;
  for (int64_t ch = 0; ch < n_chunks; ch++) {
    int64_t lo = ch * 50;
    int64_t hi = std::min(lo + 50, count);
    for (int32_t g = 0; g < n_groups; g++) {
      const uint8_t* L = lengths + (int64_t)g * alpha;
      int64_t c = 0;
      for (int64_t i = lo; i < hi; i++) c += L[syms[i]];
      costs[ch * n_groups + g] = c;
    }
  }
}

// Per-group frequency recompute given chunk selectors.
// freqs out: int64[n_groups][alpha].
void cz_chunk_freqs(const uint16_t* syms, int64_t count,
                    const uint8_t* selectors, int32_t n_groups,
                    int32_t alpha, int64_t* freqs) {
  std::fill(freqs, freqs + (int64_t)n_groups * alpha, 0);
  int64_t n_chunks = (count + 49) / 50;
  for (int64_t ch = 0; ch < n_chunks; ch++) {
    int64_t lo = ch * 50;
    int64_t hi = std::min(lo + 50, count);
    int64_t* f = freqs + (int64_t)selectors[ch] * alpha;
    for (int64_t i = lo; i < hi; i++) f[syms[i]]++;
  }
}

// Huffman payload packing: per-chunk selected tables, MSB-first bits.
// out must hold ceil(count*20/8) bytes (zero-initialized by callee).
// Returns total bit count.
int64_t cz_payload_pack(const uint16_t* syms, int64_t count,
                        const uint8_t* selectors,
                        const uint8_t* lengths, const uint32_t* codes,
                        int32_t alpha, uint8_t* out) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t o = 0;
  int64_t bits = 0;
  const uint8_t* L = lengths;
  const uint32_t* C = codes;
  for (int64_t i = 0; i < count; i++) {
    if (i % 50 == 0) {
      int g = selectors[i / 50];
      L = lengths + (int64_t)g * alpha;
      C = codes + (int64_t)g * alpha;
    }
    uint16_t s = syms[i];
    int len = L[s];
    acc = (acc << len) | C[s];
    accbits += len;
    bits += len;
    while (accbits >= 8) {
      accbits -= 8;
      out[o++] = (uint8_t)(acc >> accbits);
    }
  }
  if (accbits) out[o++] = (uint8_t)(acc << (8 - accbits));
  return bits;
}



// RLE1 encode: pack runs of >=4 equal bytes as [v,v,v,v,count<=251] into
// a block of at most block_size output bytes, with the exact lazy
// count-byte / block-cut semantics of the bzip2 readBlock loop
// (reference Bzip2.js:636-667).  Returns output length; *consumed_io is
// set to the number of input bytes eaten.
int64_t cz_rle1_encode(const uint8_t* in, int64_t avail, int64_t block_size,
                       uint8_t* out, int64_t* consumed_io) {
  int64_t pos = 0;       // output position
  int64_t i = 0;         // input position
  int last = -1;
  int64_t run = 0;
  bool counted = false;  // current 4-run's count byte already emitted?
  while (pos < block_size) {
    if (run == 4) {
      out[pos++] = 0;  // count byte, incremented as extras arrive
      counted = true;
      if (pos >= block_size) break;
    }
    if (i >= avail) break;
    int c = in[i++];
    if (c != last) {
      last = c;
      run = 1;
      counted = false;
    } else {
      run++;
      if (run > 4) {
        if (run < 256) {
          out[pos - 1]++;
          continue;
        }
        run = 1;
        counted = false;
      }
    }
    out[pos++] = (uint8_t)c;
  }
  // never end a block with a 4-run awaiting its count byte: C bzip2
  // reads the count from the same block, so such streams are rejected.
  // (The JS reference emits the dangling run — a reference bug; we
  // defer the 4th byte to the next block instead, which decodes
  // identically everywhere.)
  if (run == 4 && !counted && pos >= block_size && pos > 0) {
    pos--;
    i--;
  }
  *consumed_io = i;
  return pos;
}

}  // extern "C"
