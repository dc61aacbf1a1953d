// Native host runtime of compressjs_tpu_torch: the sequential host stages
// of the bzip2 encode that the `core` and `hybrid` splits run beside the
// card, the host cyclic BWT that `self_check` holds the card against, the
// host block decode of the parallel and mesh decoders, the BWTC codec's
// host stages (the EOF-terminated BWT and its inverse, MTF, and the
// range-coded block body), and the bodies of the host codecs (LZP3, LZJB,
// LZJB-R, PPM, DMC, Simple) and of the models' self-test codecs.
//
// Copied from the JAX package's native runtime, with only what this
// package calls: the SA-IS and two-stage suffix sorters, the
// length-limited Huffman allocator, the range coder with its Fenwick and
// deferred-summation models and the composite models over it (NoModelRC,
// LogDistModel), the adaptive Vitter Huffman coder (vhuff), DMC's Markov
// model and MTF-list model (dmc), PPM's context models (ppm) and LZP3's
// window (lzp3), and the exports cz_suffix_sort, cz_suffix_sort_sais,
// cz_huff_code_lengths, cz_selector_mtf, cz_bwt_cyclic, cz_bwt_cyclic_ref,
// cz_mtf_rle2, cz_group_costs, cz_chunk_freqs, cz_payload_pack,
// cz_rle1_encode, cz_bz2_decode_block, cz_bz2_block_full,
// cz_inverse_bwt, cz_rle1_decode, cz_bwt_eof, cz_inverse_bwt_eof,
// cz_mtf_encode, cz_mtf_decode, cz_huff_encode/_decode, cz_ctx1_*,
// cz_simple_*, cz_order0_mtf_*, cz_order0_defsum_*, cz_dmc_*, cz_ppm_*,
// cz_lzp3_*, cz_lzjb_*, cz_lzjbr_*, cz_bwtc_encode_block,
// cz_bwtc_decode_block and cz_order0_fenwick_*.  Built by g++ at first
// use and loaded with ctypes (native/__init__.py).

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

// Plain SA-IS suffix sort (kept as the differential-test reference for
// the two-stage sorter below, and exported as cz_suffix_sort_sais).
void suffix_sort32_sais(const uint8_t* T, int32_t* SA, int32_t n) {
  // append a virtual sentinel by shifting the alphabet up by one
  std::vector<uint16_t> T2(n + 1);
  for (int32_t i = 0; i < n; i++) T2[i] = (uint16_t)(T[i] + 1);
  T2[n] = 0;
  std::vector<int32_t> SA2(n + 1);
  sais_core<uint16_t, int32_t>(T2.data(), SA2.data(), n + 1, 257);
  // SA2[0] is the sentinel suffix; drop it
  std::memcpy(SA, SA2.data() + 1, sizeof(int32_t) * n);
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

// --- linear variant: suffix array with virtual-sentinel semantics ------

void divsufsort32(const uint8_t* T, int32_t* SA, int32_t n) {
  if (n <= 0) return;
  if (n == 1) { SA[0] = 0; return; }

  // classify suffixes (1 = type B: suffix i < suffix i+1) and count
  std::vector<uint8_t> types(n);
  Buckets bk;
  types[n - 1] = 0;  // last suffix > empty suffix => type A
  bk.cntA[T[n - 1]]++;
  int32_t m = 0;
  for (int32_t i = n - 2; i >= 0; i--) {
    uint8_t t = T[i] < T[i + 1] ? 1
              : (T[i] > T[i + 1] ? 0 : types[i + 1]);
    types[i] = t;
    if (t) {
      int key = ((int)T[i] << 8) | T[i + 1];
      if (!types[i + 1]) { bk.cntBs[key]++; m++; }
      else bk.cntB[key]++;
    } else {
      bk.cntA[T[i]]++;
    }
  }
  bk.layout();

  if (m > 0) {
    std::vector<int32_t> P(m), bnd(m);
    {
      int32_t k = 0;
      for (int32_t i = 0; i < n - 1; i++)
        if (types[i] && !types[i + 1]) P[k++] = i;
      for (int32_t e = 0; e + 1 < m; e++) bnd[e] = P[e + 1] + 2;
      bnd[m - 1] = n;
    }
    std::vector<int32_t> bs;
    sort_bstar(T, P, bnd, bs, /*cyclic=*/false);
    // drop sorted B* positions into their final SA slots (global B*
    // order visits the (c0,c1) sub-buckets in layout order)
    {
      std::vector<int32_t> cur(bk.BsStart);
      for (int32_t r = 0; r < m; r++) {
        int32_t pos = P[bs[r]];
        int key = ((int)T[pos] << 8) | T[pos + 1];
        SA[cur[key]++] = pos;
      }
    }
    // induce the non-B* type-B suffixes: scan each first-char bucket's
    // B region right to left, buckets in descending order.  Every
    // non-B* B suffix k has a type-B successor k+1 with rank(k) <
    // rank(k+1), so its inducer is always scanned first.
    {
      std::vector<int32_t> cur(bk.Bend);
      for (int c0 = 255; c0 >= 0; c0--) {
        int32_t lo = bk.BsStart[(c0 << 8) | c0];
        int32_t hi = bk.Bend[(c0 << 8) | 255];
        for (int32_t i = hi - 1; i >= lo; i--) {
          int32_t j = SA[i];
          if (j > 0 && types[j - 1]) {
            int key = ((int)T[j - 1] << 8) | T[j];
            SA[--cur[key]] = j - 1;
          }
        }
      }
    }
  }

  // induce the type-A suffixes: seed with suffix n-1 (the smallest
  // suffix of its first-char bucket), then one left-to-right scan
  {
    std::vector<int32_t> cur(bk.Ahead);
    SA[cur[T[n - 1]]++] = n - 1;
    for (int32_t i = 0; i < n; i++) {
      int32_t j = SA[i];
      if (j > 0 && !types[j - 1]) SA[cur[T[j - 1]]++] = j - 1;
    }
  }
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

// Suffix sort into int32 indices.  Callers must keep n (doubled for the
// cyclic wrapper) below 2^31 - 2; the extern "C" wrappers reject larger
// inputs and the Python layer routes them to the numpy path.
void suffix_sort32(const uint8_t* T, int32_t* SA, int32_t n) {
  dss::divsufsort32(T, SA, n);
}


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

// Suffix array of T[0..n-1] (EOF-terminated semantics: shorter suffixes
// that are prefixes sort first — matching a virtual sentinel < all).
void cz_suffix_sort(const uint8_t* T, int64_t* SA, int64_t n) {
  if (n <= 0 || n >= (int64_t)INT32_MAX - 1) return;  // Python layer guards
  if (n == 1) { SA[0] = 0; return; }
  std::vector<int32_t> SA32(n);
  suffix_sort32(T, SA32.data(), (int32_t)n);
  for (int64_t i = 0; i < n; i++) SA[i] = SA32[i];
}

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

// Plain SA-IS path, kept as the differential-test reference for the
// two-stage sorter that cz_suffix_sort dispatches to.
void cz_suffix_sort_sais(const uint8_t* T, int64_t* SA, int64_t n) {
  if (n <= 0 || n >= (int64_t)INT32_MAX - 1) return;
  if (n == 1) { SA[0] = 0; return; }
  std::vector<int32_t> SA32(n);
  suffix_sort32_sais(T, SA32.data(), (int32_t)n);
  for (int64_t i = 0; i < n; i++) SA[i] = SA32[i];
}

// Doubled-string construction of the same transform, kept as the
// differential-test reference for the direct rotation sort above.
int64_t cz_bwt_cyclic_ref(const uint8_t* T, uint8_t* U, int64_t n) {
  if (n <= 0 || 2 * n >= (int64_t)INT32_MAX - 1) return 0;
  if (n == 1) { U[0] = T[0]; return 0; }
  std::vector<uint8_t> TT(2 * n);
  std::memcpy(TT.data(), T, n);
  std::memcpy(TT.data() + n, T, n);
  std::vector<int32_t> SA(2 * n);
  suffix_sort32_sais(TT.data(), SA.data(), (int32_t)(2 * n));
  int64_t j = 0, pidx = 0;
  for (int64_t i = 0; i < 2 * n; i++) {
    int64_t s = SA[i];
    if (s < n) {
      if (s == 0) pidx = j;
      U[j++] = T[(s + n - 1) % n];
    }
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



// CRC-32/BZIP2 (poly 0x04C11DB7, MSB first, init and xorout 0xFFFFFFFF)
// eight bytes a step: t[k][b] is byte b's contribution k bytes before
// the end of the step.
struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t b = 0; b < 256; b++) {
      uint32_t c = b << 24;
      for (int k = 0; k < 8; k++)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
      t[0][b] = c;
    }
    for (int k = 1; k < 8; k++)
      for (int b = 0; b < 256; b++)
        t[k][b] = (t[k - 1][b] << 8) ^ t[0][t[k - 1][b] >> 24];
  }
};

// CRC register `crc` (0xFFFFFFFF to start) run over n bytes at p;
// returns the register complemented, as bzip2 writes it.
uint32_t cz_crc32_bzip2(const uint8_t* p, int64_t n, uint32_t crc) {
  static const Crc32Tables tabs;
  const auto& t = tabs.t;
  uint32_t c = crc;
  for (; n >= 8; p += 8, n -= 8) {
    c ^= (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 |
         (uint32_t)p[2] << 8 | p[3];
    c = t[7][c >> 24] ^ t[6][(c >> 16) & 255] ^ t[5][(c >> 8) & 255] ^
        t[4][c & 255] ^ t[3][p[4]] ^ t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
  }
  for (; n > 0; p++, n--) c = (c << 8) ^ t[0][(c >> 24) ^ *p];
  return ~c;
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

// bzip2 hot decode loop: canonical-Huffman symbol walk + MTF + RLE2 undo.
// Bit source: data/bitpos (MSB-first).  Tables are per group:
//   minlen/maxlen: int32[ngroups]
//   limit:  int64[ngroups][25]
//   base:   int64[ngroups][22]
//   permute:int32[ngroups][258]
// Returns dbuf_count (>=0) or -1 on data error.  *bitpos_io is updated.
int64_t cz_bz2_decode_block(const uint8_t* data, int64_t data_len,
                            int64_t* bitpos_io,
                            const uint8_t* selectors, int64_t nsel,
                            const int32_t* minlen, const int32_t* maxlen,
                            const int64_t* limit, const int64_t* base,
                            const int32_t* permute,
                            int32_t sym_total, const uint8_t* sym_to_byte,
                            uint8_t* dbuf, int64_t dbuf_size) {
  int64_t bitpos = *bitpos_io;
  int64_t total_bits = data_len * 8;
  // bit reader: 64-bit cache
  uint64_t cache = 0;
  int cached = 0;
  int64_t bytep = bitpos >> 3;
  int skip = (int)(bitpos & 7);
  auto refill = [&](int need) {
    while (cached < need) {
      uint64_t b = bytep < data_len ? data[bytep] : 0;
      bytep++;
      cache = (cache << 8) | b;
      cached += 8;
    }
  };
  if (skip) { refill(skip); cached -= skip; }
  auto read_bits = [&](int nb) -> int64_t {
    refill(nb);
    cached -= nb;
    return (int64_t)((cache >> cached) & ((1ULL << nb) - 1));
  };

  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = (uint8_t)i;
  int64_t dbuf_count = 0;
  int64_t run_pos = 0, t_acc = 0;
  int64_t selector_idx = 0;
  int sym_budget = 0;
  const int64_t* glimit = nullptr;
  const int64_t* gbase = nullptr;
  const int32_t* gperm = nullptr;
  int gmin = 0, gmax = 0;

  // per-group decode LUT over the first LUT_BITS code bits:
  // entry = (symbol << 5) | code length, 0xFFFF = longer code (walk).
  // Typical bzip2 codes are <= 11 bits, so ~99% of symbols decode with
  // one peek+lookup instead of a bit-by-bit limit walk.
  constexpr int LUT_BITS = 11;
  static_assert(LUT_BITS <= 15, "length field needs 5 bits");
  uint16_t lut[6][1 << LUT_BITS];
  int lut_bits[6];
  bool lut_ok[6] = {false, false, false, false, false, false};
  auto build_lut = [&](int g) {
    const int64_t* lim = limit + g * 25;
    const int64_t* bas = base + g * 22;
    const int32_t* perm = permute + g * 258;
    int L = std::min(LUT_BITS, maxlen[g]);
    lut_bits[g] = L;
    uint16_t* t = lut[g];
    std::fill(t, t + (1 << LUT_BITS), (uint16_t)0xFFFF);
    int64_t lo = 0;  // first code value of the current length
    for (int l = minlen[g]; l <= maxlen[g] && l <= L; l++) {
      // clamp to the code space of length l: an over-subscribed
      // (Kraft > 1) table from corrupt input may claim lim[l] >= 2^l,
      // which would index past the table; clamped codes stay 0xFFFF
      // and fall to the walk path, which bounds-checks and errors
      int64_t hi = std::min(lim[l], ((int64_t)1 << l) - 1);
      for (int64_t j = lo; j <= hi; j++) {
        int64_t idx = j - bas[l];
        if (idx < 0 || idx >= 258) continue;  // corrupt table: walk path
        uint16_t v = (uint16_t)((perm[idx] << 5) | l);
        int shift = L - l;
        for (int64_t e = j << shift; e < ((j + 1) << shift); e++)
          t[e] = v;
      }
      lo = (lim[l] + 1) << 1;
    }
    lut_ok[g] = true;
  };
  const uint16_t* glut = nullptr;
  int gL = 0;

  for (;;) {
    if (!sym_budget) {
      sym_budget = 50;
      if (selector_idx >= nsel) return -1;
      int g = selectors[selector_idx++];
      glimit = limit + g * 25;
      gbase = base + g * 22;
      gperm = permute + g * 258;
      gmin = minlen[g];
      gmax = maxlen[g];
      if (g < 6) {
        if (!lut_ok[g]) build_lut(g);
        glut = lut[g];
        gL = lut_bits[g];
      } else {
        glut = nullptr;  // defensive: >6 groups is invalid bzip2
      }
    }
    sym_budget--;
    int32_t next_sym;
    uint16_t v = 0xFFFF;
    if (glut) {
      refill(gL);
      uint32_t peek =
          (uint32_t)((cache >> (cached - gL)) & ((1u << gL) - 1));
      v = glut[peek];
    }
    if (v != 0xFFFF) {
      cached -= (int)(v & 31);
      next_sym = v >> 5;
    } else {
      int i = gmin;
      int64_t j = read_bits(i);
      while (j > glimit[i]) {
        i++;
        if (i > gmax) return -1;
        j = (j << 1) | read_bits(1);
      }
      j -= gbase[i];
      if (j < 0 || j >= 258) return -1;
      next_sym = gperm[j];
    }
    if (next_sym <= 1) {  // RUNA / RUNB
      if (!run_pos) { run_pos = 1; t_acc = 0; }
      t_acc += (next_sym == 0) ? run_pos : 2 * run_pos;
      run_pos <<= 1;
      if (t_acc > dbuf_size) return -1;  // also preempts int64 wrap of
                                         // run_pos/t_acc on crafted
                                         // 60+-symbol run codes
      continue;
    }
    if (run_pos) {
      run_pos = 0;
      if (dbuf_count + t_acc > dbuf_size) return -1;
      uint8_t uc = sym_to_byte[mtf[0]];
      std::memset(dbuf + dbuf_count, uc, t_acc);
      dbuf_count += t_acc;
    }
    if (next_sym > sym_total) break;  // EOB
    if (dbuf_count >= dbuf_size) return -1;
    int32_t jj = next_sym - 1;
    uint8_t uc = mtf[jj];
    std::memmove(mtf + 1, mtf, jj);
    mtf[0] = uc;
    uc = sym_to_byte[uc];
    dbuf[dbuf_count++] = uc;
    (void)total_bits;
  }
  *bitpos_io = (bytep << 3) - cached;
  return dbuf_count;
}

// Full-native bzip2 block parse + decode: everything after the 48-bit
// block magic and 32-bit CRC (randomized bit, origPtr, symbol bitmap,
// unary+MTF selectors, delta-coded length tables -> permute/base/limit,
// then the symbol decode via cz_bz2_decode_block).  Returns the dbuf
// count, or -1 on ANY anomaly — the Python caller then re-parses on its
// own path so that error behavior (and acceptance of degenerate blocks)
// stays byte-for-byte identical to the reference.
int64_t cz_bz2_block_full(const uint8_t* data, int64_t data_len,
                          int64_t* bitpos_io, int64_t dbuf_size,
                          uint8_t* dbuf, int64_t* orig_ptr_out) {
  int64_t pos = *bitpos_io;
  int64_t total_bits = data_len * 8;
  auto read_bits = [&](int nb) -> int64_t {
    int64_t v = 0;
    for (int k = 0; k < nb; k++) {
      int64_t p = pos + k;
      int bit = p < total_bits
          ? (data[p >> 3] >> (7 - (p & 7))) & 1 : 0;
      v = (v << 1) | bit;
    }
    pos += nb;
    return v;
  };

  if (read_bits(1)) return -1;  // randomized: obsolete format
  int64_t orig_pointer = read_bits(24);
  if (orig_pointer > dbuf_size) return -1;

  // symbol bitmap
  uint8_t sym_to_byte[256];
  int32_t sym_total = 0;
  {
    int64_t t = read_bits(16);
    for (int i = 0; i < 16; i++) {
      if (t & ((int64_t)1 << (15 - i))) {
        int64_t k = read_bits(16);
        for (int j = 0; j < 16; j++)
          if (k & ((int64_t)1 << (15 - j)))
            sym_to_byte[sym_total++] = (uint8_t)((i << 4) | j);
      }
    }
  }
  if (sym_total == 0) return -1;
  int32_t sym_count = sym_total + 2;

  int32_t group_count = (int32_t)read_bits(3);
  if (group_count < 2 || group_count > 6) return -1;
  int64_t n_selectors = read_bits(15);
  if (n_selectors == 0) return -1;

  // selectors: unary + MTF
  std::vector<uint8_t> selectors(n_selectors);
  {
    uint8_t lst[6];
    for (int i = 0; i < group_count; i++) lst[i] = (uint8_t)i;
    for (int64_t s = 0; s < n_selectors; s++) {
      int j = 0;
      while (read_bits(1)) {
        j++;
        if (j >= group_count) return -1;
      }
      uint8_t v = lst[j];
      for (int t = j; t > 0; t--) lst[t] = lst[t - 1];
      lst[0] = v;
      selectors[s] = v;
    }
  }

  // delta-coded length tables -> permute/base/limit (Bzip2.js:226-275)
  int32_t minlen[6], maxlen[6];
  std::vector<int64_t> limit(6 * 25, 0), base(6 * 22, 0);
  std::vector<int32_t> permute(6 * 258, 0);
  for (int g = 0; g < group_count; g++) {
    int32_t lengths[258];
    int64_t t = read_bits(5);
    for (int32_t i = 0; i < sym_count; i++) {
      for (;;) {
        if (t < 1 || t > 20) return -1;
        if (!read_bits(1)) break;
        if (!read_bits(1)) t++;
        else t--;
      }
      lengths[i] = (int32_t)t;
    }
    int32_t mn = lengths[0], mx = lengths[0];
    for (int32_t i = 1; i < sym_count; i++) {
      mn = std::min(mn, lengths[i]);
      mx = std::max(mx, lengths[i]);
    }
    minlen[g] = mn;
    maxlen[g] = mx;
    int32_t* perm = permute.data() + g * 258;
    int64_t* lim = limit.data() + g * 25;
    int64_t* bas = base.data() + g * 22;
    int32_t pp = 0;
    for (int32_t l = mn; l <= mx; l++)
      for (int32_t i = 0; i < sym_count; i++)
        if (lengths[i] == l) perm[pp++] = i;
    int64_t temp[21] = {0};
    for (int32_t i = 0; i < sym_count; i++) temp[lengths[i]]++;
    int64_t acc = 0, tt = 0;
    for (int32_t l = mn; l < mx; l++) {
      acc += temp[l];
      lim[l] = acc - 1;
      acc <<= 1;
      tt += temp[l];
      bas[l + 1] = acc - tt;
    }
    lim[mx] = acc + temp[mx] - 1;
    if (mx + 1 < 25) lim[mx + 1] = INT64_MAX;
    bas[mn] = 0;
  }

  int64_t count = cz_bz2_decode_block(
      data, data_len, &pos, selectors.data(), n_selectors,
      minlen, maxlen, limit.data(), base.data(), permute.data(),
      sym_total, sym_to_byte, dbuf, dbuf_size);
  if (count < 0) return -1;
  if (orig_pointer >= count) return -1;
  *orig_ptr_out = orig_pointer;
  *bitpos_io = pos;
  return count;
}

// Inverse cyclic BWT: fill out[0..n) from BWT column U and pidx.
void cz_inverse_bwt(const uint8_t* U, int64_t n, int64_t pidx,
                    uint8_t* out) {
  if (n < (int64_t)1 << 24) {
    // pack (LF target << 8 | byte) into one uint32 so the walk makes a
    // single random access per step over a half-size table (blocks are
    // <= 900059 bytes, so LF always fits 24 bits)
    std::vector<uint32_t> lf(n);
    uint32_t cnt[256] = {0};
    for (int64_t i = 0; i < n; i++)
      lf[i] = (cnt[U[i]]++ << 8) | U[i];
    uint32_t starts[256];
    uint32_t sum = 0;
    for (int c = 0; c < 256; c++) { starts[c] = sum; sum += cnt[c]; }
    for (int64_t i = 0; i < n; i++) lf[i] += starts[U[i]] << 8;
    uint32_t t = (uint32_t)pidx;
    for (int64_t i = n - 1; i >= 0; i--) {
      uint32_t v = lf[t];
      out[i] = (uint8_t)v;
      t = v >> 8;
    }
    return;
  }
  std::vector<int64_t> lf(n);
  int64_t cnt[256] = {0};
  for (int64_t i = 0; i < n; i++) lf[i] = cnt[U[i]]++;
  int64_t starts[256];
  int64_t sum = 0;
  for (int c = 0; c < 256; c++) { starts[c] = sum; sum += cnt[c]; }
  for (int64_t i = 0; i < n; i++) lf[i] += starts[U[i]];
  int64_t t = pidx;
  for (int64_t i = n - 1; i >= 0; i--) {
    out[i] = U[t];
    t = lf[t];
  }
}

// RLE1 decode: after 4 equal bytes the next byte is an extras count.
// Returns output length, or -1 if out_cap exceeded.
int64_t cz_rle1_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_cap) {
  int64_t o = 0;
  int64_t i = 0;
  while (i < n) {
    uint8_t c = in[i];
    int64_t run = 1;
    while (i + run < n && run < 4 && in[i + run] == c) run++;
    if (o + run > out_cap) return -1;
    std::memset(out + o, c, run);
    o += run;
    i += run;
    if (run == 4) {
      int64_t extra = (i < n) ? in[i] : 0;
      if (i < n) i++;
      if (o + extra > out_cap) return -1;
      std::memset(out + o, c, extra);
      o += extra;
    }
  }
  return o;
}


// EOF-terminated BWT (reference bwtransform contract): U[0]=T[n-1], the
// suffix-0 slot is skipped; returns pidx+1.
int64_t cz_bwt_eof(const uint8_t* T, uint8_t* U, int64_t n) {
  if (n <= 0 || n >= (int64_t)INT32_MAX - 1) return 0;
  if (n == 1) { U[0] = T[0]; return 1; }
  std::vector<int32_t> SA(n);
  suffix_sort32(T, SA.data(), (int32_t)n);
  int64_t pidx = 0;
  for (int64_t i = 0; i < n; i++) if (SA[i] == 0) { pidx = i; break; }
  U[0] = T[n - 1];
  for (int64_t i = 0; i < pidx; i++) U[i + 1] = T[SA[i] - 1];
  for (int64_t i = pidx + 1; i < n; i++) U[i] = T[SA[i] - 1];
  return pidx + 1;
}

// MTF encode over a dense alphabet list (alphabet[0..asize) initial order)
void cz_mtf_encode(const uint8_t* data, int64_t n, const uint8_t* alphabet,
                   int32_t asize, int32_t* out) {
  uint8_t list[256];
  std::memcpy(list, alphabet, asize);
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = data[i];
    int32_t j = 0;
    while (list[j] != c) j++;
    out[i] = j;
    if (j) {
      std::memmove(list + 1, list, j);
      list[0] = c;
    }
  }
}

void cz_mtf_decode(const int32_t* idx, int64_t n, const uint8_t* alphabet,
                   int32_t asize, uint8_t* out) {
  uint8_t list[256];
  std::memcpy(list, alphabet, asize);
  for (int64_t i = 0; i < n; i++) {
    int32_t j = idx[i];
    uint8_t c = list[j];
    out[i] = c;
    if (j) {
      std::memmove(list + 1, list, j);
      list[0] = c;
    }
  }
}

// Inverse EOF-terminated BWT (reference unbwtransform contract,
// BWT.js:352-363): T is the BWT column, U the output, pidx from the
// forward transform.  A valid column's walk steps to slot n only after
// its last byte; a corrupt one is held inside the column there (as the
// device inverse clamps its step).
void cz_inverse_bwt_eof(const uint8_t* T, uint8_t* U, int64_t n,
                        int64_t pidx) {
  if (n < (int64_t)1 << 24) {
    // packed (LF target << 8 | byte): one random access per walk step
    std::vector<uint32_t> lf(n);
    uint32_t cnt[256] = {0};
    for (int64_t i = 0; i < n; i++)
      lf[i] = (cnt[T[i]]++ << 8) | T[i];
    uint32_t starts[256];
    uint32_t sum = 0;
    for (int c = 0; c < 256; c++) { starts[c] = sum; sum += cnt[c]; }
    for (int64_t i = 0; i < n; i++) lf[i] += starts[T[i]] << 8;
    uint32_t t = 0;
    for (int64_t i = n - 1; i >= 0; i--) {
      uint32_t v = lf[t];
      U[i] = (uint8_t)v;
      t = v >> 8;
      if (t < (uint32_t)pidx) t++;
      if (t == (uint32_t)n) t = (uint32_t)n - 1;  // only a corrupt column
    }
    return;
  }
  std::vector<int64_t> lf(n);
  int64_t cnt[256] = {0};
  for (int64_t i = 0; i < n; i++) lf[i] = cnt[T[i]]++;
  int64_t starts[256];
  int64_t sum = 0;
  for (int c = 0; c < 256; c++) { starts[c] = sum; sum += cnt[c]; }
  int64_t t = 0;
  for (int64_t i = n - 1; i >= 0; i--) {
    uint8_t ch = T[t];
    U[i] = ch;
    t = lf[t] + starts[ch];
    if (t < pidx) t++;
    if (t == n) t = n - 1;  // only a corrupt column walks here
  }
}

}  // extern "C"

// ===========================================================================
// Range coder (Schindler carry-counting, byte-oriented) + adaptive models.
//
// Bit-compatible with the framework's Python coder (and hence the
// reference rngcod13 semantics).  State crosses the C/Python boundary as
// an int64[5]: [low, range, buffer, help, bytecount] for the encoder,
// [low, range, buffer, in_pos, 0] for the decoder — BWTC interleaves
// Python-coded headers with native-coded symbol streams on one coder.

namespace rc {

constexpr uint64_t TOP = 1ULL << 31;
constexpr uint64_t BOT = 1ULL << 23;
constexpr int SHIFT = 23;
constexpr int EXTRA = 7;
constexpr uint64_t M32 = 0xFFFFFFFFULL;

struct Enc {
  uint64_t low, range, buffer, help, bytecount;
  uint8_t* out;
  int64_t outlen;

  void load(const int64_t* s) {
    low = (uint64_t)s[0]; range = (uint64_t)s[1]; buffer = (uint64_t)s[2];
    help = (uint64_t)s[3]; bytecount = (uint64_t)s[4];
  }
  void store(int64_t* s) const {
    s[0] = (int64_t)low; s[1] = (int64_t)range; s[2] = (int64_t)buffer;
    s[3] = (int64_t)help; s[4] = (int64_t)bytecount;
  }
  inline void put(uint8_t b) { out[outlen++] = b; }
  inline void normalize() {
    while (range <= BOT) {
      if (low < (0xFFULL << SHIFT)) {
        put((uint8_t)buffer);
        for (; help; help--) put(0xFF);
        buffer = (low >> SHIFT) & 0xFF;
      } else if (low & TOP) {
        put((uint8_t)(buffer + 1));
        for (; help; help--) put(0x00);
        buffer = (low >> SHIFT) & 0xFF;
      } else {
        help++;
      }
      range = (range << 8) & M32;
      low = (low << 8) & (TOP - 1);
      bytecount++;
    }
  }
  inline void encode_freq(uint32_t sy_f, uint32_t lt_f, uint32_t tot_f) {
    normalize();
    uint64_t r = range / tot_f;
    uint64_t tmp = r * lt_f;
    low += tmp;
    if (lt_f + sy_f < tot_f) range = r * sy_f;
    else range -= tmp;
  }
  inline void encode_shift(uint32_t sy_f, uint32_t lt_f, uint32_t shift) {
    normalize();
    uint64_t r = range >> shift;
    uint64_t tmp = r * lt_f;
    low += tmp;
    if ((lt_f + sy_f) >> shift) range -= tmp;
    else range = r * sy_f;
  }
};

struct Dec {
  uint64_t low, range, buffer, help;
  const uint8_t* in;
  int64_t pos, len;

  void load(const int64_t* s) {
    low = (uint64_t)s[0]; range = (uint64_t)s[1]; buffer = (uint64_t)s[2];
    pos = s[3];
  }
  void store(int64_t* s) const {
    s[0] = (int64_t)low; s[1] = (int64_t)range; s[2] = (int64_t)buffer;
    s[3] = pos;
  }
  inline int64_t next_byte() { return pos < len ? in[pos++] : -1; }
  inline void normalize() {
    while (range <= BOT) {
      low = ((low << 8) | ((buffer << EXTRA) & 0xFF)) & M32;
      int64_t b = next_byte();
      buffer = (uint64_t)b;  // -1 reproduces the JS >>> semantics below
      low = (low | (((uint64_t)b & M32) >> (8 - EXTRA))) & M32;
      range = (range << 8) & M32;
    }
  }
  // The three guards below never fire on a valid stream (totals are
  // 1..2^23 <= range after normalize, and decoded sy_f >= 1); they cap
  // what a CORRUPT stream can do at garbage output instead of SIGFPE
  // (division by zero) or a zero range that would spin normalize()
  // forever.
  inline uint32_t decode_cul_freq(uint32_t tot_f) {
    normalize();
    if (tot_f == 0) tot_f = 1;
    help = range / tot_f;
    if (help == 0) help = 1;
    uint64_t tmp = low / help;
    return (uint32_t)(tmp >= tot_f ? tot_f - 1 : tmp);
  }
  inline uint32_t decode_cul_shift(uint32_t shift) {
    normalize();
    help = range >> shift;
    if (help == 0) help = 1;
    uint64_t tmp = low / help;
    return (uint32_t)((tmp >> shift) ? (1ULL << shift) - 1 : tmp);
  }
  inline void update(uint32_t sy_f, uint32_t lt_f, uint32_t tot_f) {
    uint64_t tmp = help * lt_f;
    low -= tmp;
    if (lt_f + sy_f < tot_f) range = help * sy_f;
    else range -= tmp;
    if (range == 0) range = 1;
  }
};

// --- Fenwick-tree adaptive model (heap layout, packed esc|sym u32) ------

struct Fenwick {
  std::vector<uint32_t> tree;
  int32_t num_syms;
  uint32_t max_prob, increment;

  Fenwick(int32_t size, uint32_t maxp, uint32_t incr)
      : tree((size + 1) * 2, 0), num_syms(size + 1),
        max_prob(maxp), increment(incr) {
    for (int32_t i = 0; i < size; i++)
      tree[num_syms + i] = 1;                      // esc=1, sym=0
    tree[num_syms + size] = increment << 16;       // escape symbol
    sum_tree();
  }
  void sum_tree() {
    for (int32_t i = num_syms - 1; i > 0; i--)
      tree[i] = tree[2 * i] + tree[2 * i + 1];
  }
  void rescale() {
    bool no_escape = true;
    for (int32_t i = 0; i < num_syms - 1; i++) {
      uint32_t p = tree[num_syms + i];
      if (p & 0xFFFF) { no_escape = false; continue; }
      p = (p & 0xFFFEFFFEu) >> 1;
      if (p == 0) { p = 1; no_escape = false; }
      tree[num_syms + i] = p;
    }
    uint32_t p = (tree[num_syms + num_syms - 1] & 0xFFFEFFFEu) >> 1;
    if (no_escape) p = 0;
    else if (p == 0) p = 1u << 16;
    tree[num_syms + num_syms - 1] = p;
    sum_tree();
  }
  void encode(Enc& e, int32_t symbol) {
    int32_t i = num_syms + symbol;
    uint32_t sy_f = tree[i];
    uint32_t mask = 0xFFFF0000u;
    int shift = 16;
    uint32_t update = increment << 16;
    if ((sy_f & 0xFFFF0000u) == 0) {  // escape
      encode(e, num_syms - 1);
      mask = 0xFFFFu; shift = 0;
      update -= 1;
    } else if (symbol == num_syms - 1 && (tree[1] & 0xFFFF) == 1) {
      update = (uint32_t)(0 - tree[i]);  // remove last escape
    }
    uint32_t lt_f = 0;
    while (i > 1) {
      int32_t parent = i >> 1;
      if (i & 1) lt_f += tree[2 * parent];
      tree[i] += update;
      i = parent;
    }
    uint32_t tot_f = tree[1];
    tree[1] += update;
    e.encode_freq((sy_f & mask) >> shift, (lt_f & mask) >> shift,
                  (tot_f & mask) >> shift);
    if ((tree[1] >> 16) >= max_prob) rescale();
  }
  int32_t decode_pass(Dec& d, bool is_escape) {
    uint32_t mask = 0xFFFF0000u;
    int shift = 16;
    uint32_t update = increment << 16;
    if (is_escape) { mask = 0xFFFFu; shift = 0; update -= 1; }
    uint32_t tot_f = (tree[1] & mask) >> shift;
    uint32_t prob = d.decode_cul_freq(tot_f);
    int32_t i = 1;
    uint32_t lt_f = 0;
    while (i < num_syms) {
      tree[i] += update;
      uint32_t left = (tree[2 * i] & mask) >> shift;
      i *= 2;
      if (prob - lt_f >= left) { lt_f += left; i++; }
    }
    int32_t symbol = i - num_syms;
    uint32_t sy_f = (tree[i] & mask) >> shift;
    tree[i] += update;
    d.update(sy_f, lt_f, tot_f);
    if (symbol == num_syms - 1 && (tree[1] & 0xFFFF) == 1) {
      update = (uint32_t)(0 - tree[i]);
      while (i >= 1) { tree[i] += update; i >>= 1; }
    }
    if ((tree[1] >> 16) >= max_prob) rescale();
    return symbol;
  }
  int32_t decode(Dec& d) {
    int32_t s = decode_pass(d, false);
    if (s == num_syms - 1) s = decode_pass(d, true);
    return s;
  }
};

// --- Deferred-summation model -------------------------------------------

struct DefSum {
  int32_t num_syms;
  std::vector<uint16_t> prob, escape, update_tab;
  std::vector<uint16_t> prob_to_sym, esc_prob_to_sym;
  int32_t update_count, update_thresh;
  bool is_decoder;

  DefSum(int32_t size, bool dec)
      : num_syms(size), prob(size + 2, 0), escape(size + 1),
        update_tab(size + 1, 0), update_count(0),
        update_thresh(256 - 128), is_decoder(dec) {
    prob[size + 1] = 256;
    for (int32_t i = 0; i <= size; i++) escape[i] = (uint16_t)i;
    if (dec) {
      prob_to_sym.assign(256, (uint16_t)size);
      esc_prob_to_sym.resize(size);
      for (int32_t i = 0; i < size; i++) esc_prob_to_sym[i] = (uint16_t)i;
    }
  }
  void do_update(int32_t symbol) {
    if (symbol == num_syms) {
      if (update_tab[symbol] >= 40) return;
      if (update_count >= update_thresh - 1) return;
    }
    update_tab[symbol]++;
    update_count++;
    if (update_count < update_thresh) return;
    int32_t cum = 0, cum_esc = 0, odd = 0;
    for (int32_t i = 0; i < num_syms + 1; i++) {
      int32_t np = ((prob[i + 1] - prob[i]) >> 1) + update_tab[i];
      if (np) {
        prob[i] = (uint16_t)cum;
        cum += np;
        if (np & 1) odd++;
        escape[i] = (uint16_t)cum_esc;
      } else {
        prob[i] = (uint16_t)cum;
        escape[i] = (uint16_t)cum_esc;
        cum_esc++;
      }
    }
    prob[num_syms + 1] = (uint16_t)cum;
    update_thresh = 256 - (cum - odd) / 2;
    for (int32_t i = 0; i < num_syms + 1; i++) update_tab[i] = 0;
    update_tab[num_syms] = 1;
    update_count = 1;
    if (!is_decoder) return;
    int32_t j = 0, k = 0;
    for (int32_t i = 0; i < num_syms + 1; i++) {
      for (; j < prob[i + 1]; j++) prob_to_sym[j] = (uint16_t)i;
      if (i + 1 <= num_syms)
        for (; k < escape[i + 1]; k++) esc_prob_to_sym[k] = (uint16_t)i;
    }
  }
  void encode(Enc& e, int32_t symbol) {
    uint32_t lt_f = prob[symbol];
    uint32_t sy_f = prob[symbol + 1] - lt_f;
    if (sy_f) {
      e.encode_shift(sy_f, lt_f, 8);
      do_update(symbol);
      return;
    }
    encode(e, num_syms);
    lt_f = escape[symbol];
    sy_f = escape[symbol + 1] - lt_f;
    e.encode_freq(sy_f, lt_f, escape[num_syms]);
    do_update(symbol);
  }
  int32_t decode(Dec& d) {
    uint32_t p = d.decode_cul_shift(8);
    int32_t symbol = prob_to_sym[p];
    uint32_t lt_f = prob[symbol];
    uint32_t sy_f = prob[symbol + 1] - lt_f;
    d.update(sy_f, lt_f, 256);
    do_update(symbol);
    if (symbol != num_syms) return symbol;
    uint32_t tot = escape[num_syms];
    p = d.decode_cul_freq(tot);
    symbol = esc_prob_to_sym[p];
    lt_f = escape[symbol];
    sy_f = escape[symbol + 1] - lt_f;
    d.update(sy_f, lt_f, tot);
    do_update(symbol);
    return symbol;
  }
};

// --- composite models over the range coder -------------------------------

// fixed-width bit coding through the coder's bit interface (NoModel)
struct NoModelRC {
  int bits;
  explicit NoModelRC(int32_t size) {
    bits = 0;
    int64_t v = (int64_t)size - 1;
    while (v > 0) { bits++; v >>= 1; }
  }
  void encode(Enc& e, int32_t symbol) {
    for (int i = bits - 1; i >= 0; i--)
      e.encode_shift(1, (symbol >> i) & 1, 1);
  }
  int32_t decode(Dec& d) {
    int32_t r = 0;
    for (int i = bits - 1; i >= 0; i--) {
      uint32_t t = d.decode_cul_shift(1);
      d.update(1, t, 2);
      r = (r << 1) | (int32_t)t;
    }
    return r;
  }
};

// log-distance model: fls through one Fenwick (+extra states), low bits
// through per-length Fenwick or NoModel above `cutoff`
struct LogDistModel {
  int extra;
  Fenwick lg;
  std::vector<Fenwick> dist;     // index i-2 for i in [2, bits]
  std::vector<NoModelRC> nodist;
  std::vector<int> use_no;       // per i: 1 if NoModel
  int bits;

  static int fls_i(int64_t v) {
    int r = 0;
    while (v > 0) { r++; v >>= 1; }
    return r;
  }

  LogDistModel(int64_t size, int extra_states, int32_t cutoff,
               uint32_t maxp, uint32_t incr)
      : extra(extra_states),
        lg((int32_t)(fls_i(size - 1) + extra_states + 1), maxp, incr),
        bits(fls_i(size - 1)) {
    // NOTE: Fenwick(size) models alphabet `size` with its own escape; the
    // framework's factories are called with the alphabet size directly,
    // so lg gets (1 + bits + extra) and dist[i] gets (1 << (i-1)).
    for (int i = 2; i <= bits; i++) {
      int64_t sz = 1LL << (i - 1);
      use_no.push_back(sz > cutoff);
      if (sz > cutoff) {
        nodist.emplace_back((int32_t)sz);
        dist.emplace_back(1, maxp, incr);  // placeholder
      } else {
        nodist.emplace_back(1);
        dist.emplace_back((int32_t)sz, maxp, incr);
      }
    }
  }
  void encode(Enc& e, int64_t v) {
    if (v < 2) { lg.encode(e, (int32_t)(v + extra)); return; }
    int l = fls_i(v);
    lg.encode(e, l + extra);
    int64_t rest = v & ((1LL << (l - 1)) - 1);
    if (use_no[l - 2]) nodist[l - 2].encode(e, (int32_t)rest);
    else dist[l - 2].encode(e, (int32_t)rest);
  }
  int64_t decode(Dec& d) {
    int l = lg.decode(d) - extra;
    if (l < 2) return l;
    int64_t rest = use_no[l - 2] ? nodist[l - 2].decode(d)
                                 : dist[l - 2].decode(d);
    return (1LL << (l - 1)) + rest;
  }
};

}  // namespace rc

// --- adaptive (Vitter) Huffman over a bit stream -------------------------
// Mirrors host/huffman.py (itself the behavior clone of Huffman.js).

namespace vhuff {

struct BitWriter {
  uint8_t* out;
  int64_t o = 0;
  uint64_t acc = 0;
  int accbits = 0;
  void put(int b) {
    acc = (acc << 1) | (uint64_t)(b & 1);
    accbits++;
    if (accbits == 8) {
      out[o++] = (uint8_t)acc;
      acc = 0;
      accbits = 0;
    }
  }
  void flush() {
    while (accbits) put(0);
  }
};

struct BitReader {
  const uint8_t* in;
  int64_t len;
  int64_t bitpos = 0;
  int get() {
    if (bitpos >= len * 8) { bitpos++; return 0; }  // zeros past EOF
    int b = (in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
    bitpos++;
    return b;
  }
};

template <typename BitIO>
struct Coder {
  std::vector<int32_t> up, down, symbol, weight, map;
  int32_t size, esc, root;
  int32_t max_weight;
  BitIO* io;

  Coder(int32_t sz, int32_t rt, BitIO* bio, int32_t maxw)
      : size(sz), max_weight(maxw), io(bio) {
    if (!rt || rt > sz) rt = sz;
    rt = rt * 2 - 1;
    up.assign(rt + 1, 0);
    down.assign(rt + 1, 0);
    symbol.assign(rt + 1, 0);
    weight.assign(rt + 1, 0);
    map.assign(sz, 0);
    esc = root = rt;
  }
  int32_t split(int32_t sym) {
    int32_t pair = esc;
    esc--;
    int32_t node;
    if (esc) {
      node = esc;
      down[pair] = node;
      weight[pair] = 1;
      up[node] = pair;
      esc--;
    } else {
      pair = 0;
      node = 1;
    }
    symbol[node] = sym;
    weight[node] = 0;
    down[node] = 0;
    map[sym] = node;
    weight[esc] = 0;
    down[esc] = 0;
    up[esc] = pair;
    return node;
  }
  int32_t leader(int32_t node) {
    int32_t w = weight[node];
    int32_t lead = node;
    while (w == weight[lead + 1]) lead++;
    if (lead == node) return node;
    int32_t s = symbol[node], prev = symbol[lead];
    symbol[lead] = s;
    symbol[node] = prev;
    map[s] = lead;
    map[prev] = node;
    return lead;
  }
  int32_t slide(int32_t node) {
    int32_t nxt = node + 1;
    int32_t s_up = up[node], s_down = down[node];
    int32_t s_sym = symbol[node], s_w = weight[node];
    if (s_w & 1) {
      while (s_w > weight[nxt + 1]) nxt++;
    }
    up[node] = up[nxt];
    down[node] = down[nxt];
    symbol[node] = symbol[nxt];
    weight[node] = weight[nxt];
    down[nxt] = s_down;
    symbol[nxt] = s_sym;
    weight[nxt] = s_w;
    up[nxt] = up[node];
    up[node] = s_up;
    if (s_w & 1) {
      up[s_down] = nxt;
      up[s_down - 1] = nxt;
      map[symbol[node]] = node;
    } else {
      int32_t d = down[node];
      up[d - 1] = node;
      up[d] = node;
      map[s_sym] = nxt;
    }
    return nxt;
  }
  void increment(int32_t node) {
    if (up[node] == node + 1) {
      weight[node] += 2;
      node++;
    } else {
      node = leader(node);
    }
    for (;;) {
      weight[node] += 2;
      int32_t u = up[node];
      if (!u) break;
      while (weight[node] > weight[node + 1]) node = slide(node);
      if (weight[node] & 1) node = u;
      else node = up[node];
    }
    if (max_weight && weight[root] >= max_weight) scale(1);
  }
  void scale(int bits) {
    int32_t node = esc;
    for (;;) {
      node++;
      if (node > root) break;
      int32_t w;
      if (weight[node] & 1) {
        w = weight[down[node]] & ~1;
        if (w) w += weight[down[node] - 1] | 1;
      } else {
        w = (weight[node] >> bits) & ~1;
        if (!w) {
          map[symbol[node]] = 0;
          if (esc) esc += 2;
          else esc += 1;
        }
      }
      weight[node] = w;
      int32_t prev = node;
      for (;;) {
        prev--;
        if (w < weight[prev]) slide(prev);
        else break;
      }
    }
    down[esc] = 0;
  }
  void sendid(int32_t sym) {
    int32_t empty = 0;
    for (int32_t s = 0; s < sym; s++)
      if (!map[s]) empty++;
    int32_t mx = size - (root - esc) / 2 - 1;
    if (mx) {
      for (;;) {
        io->put(empty & 1);
        empty >>= 1;
        mx >>= 1;
        if (!mx) break;
      }
    }
  }
  void encode(int32_t sym) {
    int32_t node = map[sym];
    int32_t idx = node;
    if (!idx) {
      idx = esc;
      if (!idx) return;
    }
    uint64_t emit = 1;
    for (;;) {
      int32_t u = up[idx];
      if (!u) break;
      emit = (emit << 1) | (uint64_t)(idx & 1);
      idx = u;
    }
    for (;;) {
      int bit = (int)(emit & 1);
      emit >>= 1;
      if (!emit) break;
      io->put(bit);
    }
    if (!node) {
      sendid(sym);
      node = split(sym);
    }
    increment(node);
  }
  int32_t readid() {
    int32_t empty = 0, bit = 1;
    int32_t mx = size - (root - esc) / 2 - 1;
    if (mx) {
      for (;;) {
        if (io->get()) empty |= bit;
        bit <<= 1;
        mx >>= 1;
        if (!mx) break;
      }
    }
    for (int32_t s = 0; s < size; s++) {
      if (!map[s]) {
        if (!empty) return s;
        empty--;
      }
    }
    return 0;
  }
  int32_t decode() {
    int32_t node = root;
    for (;;) {
      int32_t d = down[node];
      if (!d) break;
      node = io->get() ? d - 1 : d;
    }
    int32_t sym;
    if (node == esc) {
      sym = readid();
      node = split(sym);
    } else {
      sym = symbol[node];
    }
    increment(node);
    return sym;
  }
};

}  // namespace vhuff

// --- DMC -----------------------------------------------------------------
// Byte-oriented dynamic Markov compression (mirrors host/dmc.py).

namespace dmc {

// MTF-list adaptive model (mirrors host/mtf_model.py, no better_escape)
struct MTFModel {
  std::vector<uint16_t> sym, prob;
  int32_t seen = 1;
  int32_t num_syms;
  uint32_t max_prob, increment;

  MTFModel(int32_t size, uint32_t maxp, uint32_t incr)
      : sym(size + 1, 0), prob(size + 2, 0), num_syms(size),
        max_prob(maxp), increment(incr) {
    sym[0] = (uint16_t)size;  // escape
    prob[1] = (uint16_t)increment;
  }
  void update_at(int32_t symbol, int32_t index, int32_t sy_f) {
    int32_t j = index;
    int32_t tot_f;
    while (j < seen - 1) {
      sym[j] = sym[j + 1];
      prob[j] = (uint16_t)(prob[j + 1] - sy_f);
      j++;
    }
    if (index < seen) {
      sym[j] = (uint16_t)symbol;
      prob[j] = (uint16_t)(prob[j + 1] - sy_f);
      tot_f = prob[seen] + increment;
      prob[seen] = (uint16_t)tot_f;
      if (symbol == num_syms && seen >= num_syms) {
        seen--;
        tot_f = prob[seen];
      }
    } else {
      tot_f = prob[seen];
      sym[index] = (uint16_t)symbol;
      prob[index] = (uint16_t)tot_f;
      tot_f += increment;
      seen++;
      prob[seen] = (uint16_t)tot_f;
    }
    if ((uint32_t)tot_f >= max_prob) rescale();
  }
  void rescale() {
    int32_t total = 0, j = 0;
    bool no_escape = true;
    for (int32_t i = 0; i < seen; i++) {
      int32_t s = sym[i];
      int32_t f = (prob[i + 1] - prob[i]) >> 1;
      if (f > 0) {
        if (s == num_syms) no_escape = false;
        sym[j] = (uint16_t)s;
        prob[j] = (uint16_t)total;
        j++;
        total += f;
      }
    }
    prob[j] = (uint16_t)total;
    seen = j;
    if (no_escape && seen < num_syms)
      update_at(num_syms, seen, 0);
  }
  void encode(rc::Enc& e, int32_t symbol) {
    for (int32_t i = seen - 1; i >= 0; i--) {
      if (sym[i] == symbol) {
        int32_t lt_f = prob[i];
        int32_t sy_f = prob[i + 1] - lt_f;
        e.encode_freq(sy_f, lt_f, prob[seen]);
        update_at(symbol, i, sy_f);
        return;
      }
    }
    encode(e, num_syms);  // escape
    e.encode_freq(1, symbol, num_syms);
    update_at(symbol, seen, 0);
  }
  int32_t decode(rc::Dec& d) {
    int32_t tot_f = prob[seen];
    int32_t p = (int32_t)d.decode_cul_freq(tot_f);
    int32_t i = seen - 1;
    while (i >= 0 && prob[i] > p) i--;
    int32_t symbol = sym[i];
    int32_t lt_f = prob[i];
    int32_t sy_f = prob[i + 1] - lt_f;
    d.update(sy_f, lt_f, tot_f);
    update_at(symbol, i, sy_f);
    if (symbol == num_syms) {
      symbol = (int32_t)d.decode_cul_freq(num_syms);
      d.update(1, symbol, num_syms);
      update_at(symbol, seen, 0);
    }
    return symbol;
  }
};

struct Node {
  std::vector<int32_t> out;      // node indices
  MTFModel model;
  std::vector<uint16_t> count;
  int64_t sum = 0;
  Node(int32_t size) : out(size, 0), model(size, 0xFF00, 0x100),
                       count(size, 0) {}
};

struct Markov {
  std::vector<Node> nodes;
  int32_t size;
  int64_t min1, min2;
  int32_t current = 0;

  Markov(int32_t sz, int64_t m1, int64_t m2)
      : size(sz), min1(m1), min2(m2) {
    nodes.reserve(1024);
    for (int32_t i = 0; i < sz; i++) nodes.emplace_back(sz);
    for (int32_t i = 0; i < sz; i++)
      for (int32_t j = 0; j < sz; j++) nodes[i].out[j] = j;
  }
  int32_t maybe_split(int32_t from, int32_t symbol, int32_t to) {
    int64_t trans = nodes[from].count[symbol];
    int64_t next_cnt = nodes[to].sum;
    if (trans <= min1 || next_cnt - trans <= min2) return to;
    int32_t nn = (int32_t)nodes.size();
    nodes.emplace_back(size);
    Node& node = nodes[nn];
    node.out = nodes[to].out;
    nodes[from].out[symbol] = nn;
    node.sum = 0;
    nodes[to].sum = 0;
    for (int32_t i = 0; i < size; i++) {
      // truncation matches the reference's float-to-U16 store
      uint16_t share = (uint16_t)((double)nodes[to].count[i] * trans /
                                  (double)next_cnt);
      node.count[i] = share;
      node.sum += share;
      nodes[to].count[i] = (uint16_t)(nodes[to].count[i] - share);
      nodes[to].sum += nodes[to].count[i];
    }
    return nn;
  }
  void advance(int32_t symbol) {
    int32_t from = current;
    int32_t to = nodes[from].out[symbol];
    if (nodes[from].count[symbol] != 0xFFFF) {
      nodes[from].count[symbol]++;
      nodes[from].sum++;
    }
    current = maybe_split(from, symbol, to);
  }
};

}  // namespace dmc

// --- PPM -----------------------------------------------------------------
// Method-D-ish PPM with full exclusion (mirrors host/ppm.py, itself the
// behavior clone of the reference PPM.js).

namespace ppm {

constexpr int MAX_CONTEXT = 5;
constexpr int LOG_WINDOW = 18;
constexpr int64_t WINDOW = 1LL << LOG_WINDOW;
constexpr int32_t INCR = 0x100;
constexpr int32_t MAX_PROB = 0xFF00;

struct Exclude {
  bool ex[258] = {false};
  int32_t total = 0;
};

struct DenseMTF {
  std::vector<int32_t> sym;
  std::vector<int32_t> prob;
  int64_t refcount = 0;
  int32_t size;

  explicit DenseMTF(int32_t sz) : size(sz) {
    sym = {sz};                 // escape
    prob = {0, INCR};
  }
  int32_t rescale() {
    int32_t seen = (int32_t)sym.size();
    int32_t total = 0;
    int32_t j = 0;
    bool no_escape = true;
    for (int32_t i = 0; i < seen; i++) {
      int32_t s = sym[i];
      int32_t f = (prob[i + 1] - prob[i]) >> 1;
      if (f > 0) {
        if (s == size) no_escape = false;
        sym[j] = s;
        prob[j] = total;
        j++;
        total += f;
      }
    }
    prob[j] = total;
    sym.resize(j);
    prob.resize(j + 1);
    if (no_escape && (int32_t)sym.size() < size)
      total = update_at(size, (int32_t)sym.size(), 0, 1);
    return total;
  }
  int32_t update_sym(int32_t symbol, int32_t incr) {
    for (int32_t i = 0; i < (int32_t)sym.size(); i++)
      if (sym[i] == symbol)
        return update_at(symbol, i, prob[i + 1] - prob[i], incr);
    return update_at(symbol, (int32_t)sym.size(), 0, incr);
  }
  int32_t update_at(int32_t symbol, int32_t index, int32_t sy_f,
                    int32_t incr) {
    int32_t seen = (int32_t)sym.size();
    int32_t tot_f;
    int32_t j = index;
    for (; j < seen - 1; j++) {
      sym[j] = sym[j + 1];
      prob[j] = prob[j + 1] - sy_f;
    }
    if (index < seen) {
      sym[j] = symbol;
      prob[j] = prob[j + 1] - sy_f;
      prob[seen] = tot_f = prob[seen] + incr;
    } else {
      tot_f = prob[seen];
      sym.push_back(symbol);
      prob.push_back(tot_f + incr);
      prob[index] = tot_f;
      tot_f += incr;
      seen++;
      if ((int32_t)sym.size() > size) {
        for (int32_t i = 0; i < seen; i++) {
          if (sym[i] == size) {
            update_at(size, i, prob[i + 1] - prob[i], -1);
            sym.pop_back();
            prob.pop_back();
            tot_f = prob.back();
            break;
          }
        }
      }
    }
    if (tot_f >= MAX_PROB) tot_f = rescale();
    return tot_f;
  }
  // returns: 1 = coded, 0 = coded escape (literal came from this table's
  // escape entry), -1 = symbol absent (escape coded, exclusions extended)
  int32_t encode(rc::Enc& e, int32_t symbol, Exclude& ex) {
    int32_t seen = (int32_t)sym.size();
    int32_t ex_seen = 0, ex_tot = 0;
    for (int32_t i = seen - 1; i >= 0; i--) {
      int32_t lt_f = prob[i];
      int32_t sy_f = prob[i + 1] - lt_f;
      if (sym[i] == symbol) {
        int32_t ex_lt = 0;
        for (int32_t j = i - 1; j >= 0 && ex_seen < ex.total; j--) {
          if (ex.ex[sym[j]]) {
            ex_seen++;
            int32_t f = prob[j + 1] - prob[j];
            ex_lt += f;
            ex_tot += f;
          }
        }
        int32_t tot_f = prob[seen];
        e.encode_freq(sy_f, lt_f - ex_lt, tot_f - ex_tot);
        if (symbol == size) {
          update_at(symbol, i, sy_f, INCR / 2);
          return 0;
        }
        return 1;
      } else if (ex.ex[sym[i]]) {
        ex_seen++;
        ex_tot += sy_f;
      }
    }
    encode(e, size, ex);  // escape (always present here)
    for (int32_t i = 0; i < (int32_t)sym.size() - 1; i++) {
      if (!ex.ex[sym[i]]) {
        ex.ex[sym[i]] = true;
        ex.total++;
      }
    }
    return -1;
  }
  int32_t decode(rc::Dec& d, Exclude& ex) {
    int32_t seen = (int32_t)sym.size();
    int32_t tot_f = prob[seen];
    int32_t ex_seen = 0, ex_tot = 0;
    for (int32_t i = seen - 1; i >= 0 && ex_seen < ex.total; i--) {
      if (ex.ex[sym[i]]) {
        ex_seen++;
        ex_tot += prob[i + 1] - prob[i];
      }
    }
    int32_t p = (int32_t)d.decode_cul_freq(tot_f - ex_tot) + ex_tot;
    int32_t ex_lt = ex_tot;
    int32_t i;
    for (i = seen - 1; i >= 0; i--) {
      if (ex.ex[sym[i]]) {
        int32_t f = prob[i + 1] - prob[i];
        ex_lt -= f;
        p -= f;
      } else if (prob[i] <= p) {
        break;
      }
    }
    int32_t symbol = sym[i];
    int32_t lt_f = prob[i];
    int32_t sy_f = prob[i + 1] - lt_f;
    d.update(sy_f, lt_f - ex_lt, tot_f - ex_tot);
    if (symbol < size) return symbol;
    update_at(symbol, i, sy_f, INCR / 2);
    for (int32_t k = 0; k < (int32_t)sym.size() - 1; k++) {
      if (!ex.ex[sym[k]]) {
        ex.ex[sym[k]] = true;
        ex.total++;
      }
    }
    return -1;
  }
};

// Open-addressing context table for orders 3-5.  std::unordered_map's
// node-per-entry chains were 55% of PPM encode time (~15M finds per
// 2.1MB input); linear probing over flat arrays makes each lookup one
// or two cache lines.  Real keys always carry the length tag
// ((n+1)<<41, n>=3), so 0 and 1 are free for empty/tombstone.
struct CtxMap {
  static constexpr uint64_t EMPTY = 0, TOMB = 1;
  std::vector<uint64_t> keys;
  std::vector<DenseMTF*> vals;
  size_t mask = 0;
  size_t used = 0;     // live entries
  size_t filled = 0;   // live + tombstones
  CtxMap() { rehash_to(1 << 16); }
  static inline size_t mix(uint64_t x) {   // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return (size_t)(x ^ (x >> 31));
  }
  void rehash_to(size_t cap) {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<DenseMTF*> ov = std::move(vals);
    keys.assign(cap, EMPTY);
    vals.assign(cap, nullptr);
    mask = cap - 1;
    filled = used;
    for (size_t i = 0; i < ok.size(); i++) {
      if (ok[i] > TOMB) {
        size_t h = mix(ok[i]) & mask;
        while (keys[h] != EMPTY) h = (h + 1) & mask;
        keys[h] = ok[i];
        vals[h] = ov[i];
      }
    }
  }
  DenseMTF* find(uint64_t k) const {
    size_t h = mix(k) & mask;
    while (true) {
      uint64_t kk = keys[h];
      if (kk == k) return vals[h];
      if (kk == EMPTY) return nullptr;
      h = (h + 1) & mask;
    }
  }
  DenseMTF*& get_or_insert(uint64_t k) {
    while (true) {
      size_t h = mix(k) & mask;
      size_t tomb = (size_t)-1;
      while (true) {
        uint64_t kk = keys[h];
        if (kk == k) return vals[h];
        if (kk == EMPTY) break;
        if (kk == TOMB && tomb == (size_t)-1) tomb = h;
        h = (h + 1) & mask;
      }
      if (filled >= mask - (mask >> 2)) {    // load 0.75 incl tombstones
        // grow only if mostly live; otherwise just purge tombstones
        rehash_to(used * 2 > mask ? (mask + 1) * 2 : mask + 1);
        continue;
      }
      if (tomb != (size_t)-1) h = tomb; else filled++;
      keys[h] = k;
      vals[h] = nullptr;
      used++;
      return vals[h];
    }
  }
  void erase(uint64_t k) {
    size_t h = mix(k) & mask;
    while (true) {
      uint64_t kk = keys[h];
      if (kk == k) {
        keys[h] = TOMB;
        vals[h] = nullptr;
        used--;
        return;
      }
      if (kk == EMPTY) return;
      h = (h + 1) & mask;
    }
  }
};

struct Model {
  int32_t size;
  std::vector<uint8_t> win;
  int64_t pos = 0;
  bool first_pass = true;
  // orders 0-2 are dense and hot: direct-indexed tables (order-0 one
  // slot, order-1 by last byte, order-2 by last two bytes); orders 3-5
  // live in the flat probing table keyed by packed context bytes
  DenseMTF* o0 = nullptr;
  std::vector<DenseMTF*> o1, o2;
  CtxMap contexts;

  DenseMTF** slot_for(uint64_t key, int order) {
    if (order == 0) return &o0;
    if (order == 1) return &o1[key & 0xFF];
    if (order == 2) return &o2[key & 0xFFFF];
    return nullptr;
  }
  DenseMTF* find(uint64_t key, int order) {
    DenseMTF** s = slot_for(key, order);
    if (s) return *s;
    return contexts.find(key);
  }
  DenseMTF* find_or_create(uint64_t key, int order) {
    DenseMTF** s = slot_for(key, order);
    if (s) {
      if (!*s) *s = new DenseMTF(size);
      return *s;
    }
    DenseMTF*& v = contexts.get_or_insert(key);
    if (!v) v = new DenseMTF(size);
    return v;
  }
  void drop(uint64_t key, int order) {
    DenseMTF** s = slot_for(key, order);
    if (s) {
      delete *s;
      *s = nullptr;
      return;
    }
    DenseMTF* m = contexts.find(key);
    if (m) {
      delete m;
      contexts.erase(key);
    }
  }

  explicit Model(int32_t sz)
      : size(sz), win(WINDOW, 0), o1(256, nullptr), o2(65536, nullptr) {
    const char* prime = "cSaCsA";
    for (int i = 0; i < MAX_CONTEXT; i++) put((uint8_t)prime[i % 6]);
    for (int i = 0; i < MAX_CONTEXT; i++) {
      for (int j = 0; j <= i; j++) {
        uint64_t cc = ctx_key(j + (MAX_CONTEXT - 1 - i), j);
        find_or_create(cc, j)->refcount++;
      }
    }
  }
  ~Model() {
    for (size_t i = 0; i < contexts.keys.size(); i++)
      if (contexts.keys[i] > CtxMap::TOMB) delete contexts.vals[i];
    delete o0;
    for (auto* p : o1) delete p;
    for (auto* p : o2) delete p;
  }
  void put(uint8_t b) {
    win[pos++] = b;
    if (pos >= WINDOW) { pos = 0; first_pass = false; }
  }
  uint64_t ctx_key(int64_t p, int n) const {
    // the n bytes ending just before p, tagged with the length
    uint64_t k = 0;
    int64_t q = (p - n) & (WINDOW - 1);
    for (int i = 0; i < n; i++) {
      k = (k << 8) | win[q];
      q++;
      if (q >= WINDOW) q = 0;
    }
    return k | ((uint64_t)(n + 1) << 41);
  }
  // all MAX_CONTEXT+1 keys ending just before p in one backward pass:
  // key[c] = key[c-1] with the byte c back ORed in one lane higher
  // (identical values to ctx_key(p, c) for every c)
  void ctx_keys(int64_t p, uint64_t* keys) const {
    uint64_t k = 0;
    keys[0] = (uint64_t)1 << 41;
    for (int c = 1; c <= MAX_CONTEXT; c++) {
      k |= (uint64_t)win[(p - c) & (WINDOW - 1)] << (8 * (c - 1));
      keys[c] = k | ((uint64_t)(c + 1) << 41);
    }
  }
  void update(int32_t symbol, int64_t at_pos, int c_match,
              DenseMTF* const* seen = nullptr, int seen_from = 0x7f) {
    uint64_t ks[MAX_CONTEXT + 1];
    ctx_keys(at_pos, ks);
    for (int c = 0; c <= MAX_CONTEXT; c++) {
      // the encode/decode walk already looked these contexts up (from
      // the longest down to the match level); reuse its non-null hits
      DenseMTF* m = (seen && c >= seen_from && seen[c])
          ? seen[c] : find_or_create(ks[c], c);
      if (c >= c_match) m->update_sym(symbol, INCR / 2);
      m->refcount++;
    }
    if (!first_pass) {
      // GC contexts sliding out of the window: prefixes (length
      // MAX_CONTEXT..0) of the bytes starting at pos, built up
      // incrementally (k_c = k_{c-1} shifted with the next byte in)
      uint64_t fwd[MAX_CONTEXT + 1];
      fwd[0] = 0;
      for (int c = 1; c <= MAX_CONTEXT; c++)
        fwd[c] = (fwd[c - 1] << 8) | win[(pos + c - 1) & (WINDOW - 1)];
      for (int c = MAX_CONTEXT; c >= 0; c--) {
        uint64_t cc = fwd[c] | ((uint64_t)(c + 1) << 41);
        DenseMTF* m = find(cc, c);
        if (m && --m->refcount <= 0) drop(cc, c);
      }
    }
    put((uint8_t)symbol);
  }
  void cm1_encode(rc::Enc& e, int32_t symbol, Exclude& ex) {
    int32_t lt_f = 0;
    for (int32_t i = 0; i < symbol; i++)
      if (!ex.ex[i]) lt_f++;
    e.encode_freq(1, lt_f, size - ex.total);
  }
  int32_t cm1_decode(rc::Dec& d, Exclude& ex) {
    int32_t tot = size - ex.total;
    int32_t lt = (int32_t)d.decode_cul_freq(tot);
    int32_t symbol = lt;
    for (int32_t i = 0; i <= symbol; i++)
      if (ex.ex[i]) symbol++;
    d.update(1, lt, tot);
    return symbol;
  }
  void encode(rc::Enc& e, int32_t symbol) {
    int64_t p0 = pos;
    Exclude ex;
    uint64_t ks[MAX_CONTEXT + 1];
    ctx_keys(p0, ks);
    DenseMTF* seen[MAX_CONTEXT + 1];
    int c;
    for (c = MAX_CONTEXT; c >= 0; c--) {
      DenseMTF* m = find(ks[c], c);
      seen[c] = m;
      if (m) {
        int32_t r = m->encode(e, symbol, ex);
        if (r == 1) {
          update(symbol, p0, c, seen, c);
          return;
        }
      }
    }
    cm1_encode(e, symbol, ex);
    update(symbol, p0, c, seen, 0);  // c == -1
  }
  int32_t decode(rc::Dec& d) {
    int64_t p0 = pos;
    Exclude ex;
    uint64_t ks[MAX_CONTEXT + 1];
    ctx_keys(p0, ks);
    DenseMTF* seen[MAX_CONTEXT + 1];
    int c;
    int32_t symbol = -1;
    for (c = MAX_CONTEXT; c >= 0; c--) {
      DenseMTF* m = find(ks[c], c);
      seen[c] = m;
      if (m) {
        symbol = m->decode(d, ex);
        if (symbol >= 0) {
          update(symbol, p0, c, seen, c);
          return symbol;
        }
      }
    }
    symbol = cm1_decode(d, ex);
    update(symbol, p0, c, seen, 0);
    return symbol;
  }
};

}  // namespace ppm

// --- LZP3 ----------------------------------------------------------------

namespace lzp3 {

constexpr int LOG_WINDOW = 20;
constexpr int64_t WINDOW = 1LL << LOG_WINDOW;
constexpr int64_t MAX_MATCH = WINDOW - 1;
constexpr uint32_t CTXT4_SIZE = 1 << 16;
constexpr uint32_t CTXT3_SIZE = 1 << 12;
constexpr uint32_t MAX24 = 0xFFFFFF;
constexpr uint32_t MAX16 = 0xFFFF;
constexpr int32_t LEN_CUTOFF = 256;

struct Window {
  std::vector<uint8_t> buf;
  int64_t pos = 0;
  std::vector<int64_t> c4, c3, c2;

  explicit Window(int64_t max_size)
      : buf(std::min(max_size + 4, WINDOW), 0),
        c4(CTXT4_SIZE, 0), c3(CTXT3_SIZE, 0), c2(1 << 16, 0) {
    put(0x63); put(0x53); put(0x61); put(0x20);
  }
  void ensure(int64_t i) {
    if (i >= (int64_t)buf.size()) {
      int64_t need = std::min(std::max(i + 1, (int64_t)buf.size() * 2),
                              WINDOW);
      buf.resize(need, 0);
    }
  }
  uint8_t put(uint8_t b) {
    ensure(pos);
    buf[pos++] = b;
    if (pos >= WINDOW) pos = 0;
    return b;
  }
  uint8_t get(int64_t p) const {
    int64_t i = p & (WINDOW - 1);
    return i < (int64_t)buf.size() ? buf[i] : 0;
  }
  uint32_t context(int64_t p, int n) const {
    uint32_t c = 0;
    int64_t q = (p - n) & (WINDOW - 1);
    for (int i = 0; i < n; i++) {
      c = (c << 8) | get(q);
      q++;
      if (q >= WINDOW) q = 0;
    }
    return c;
  }
  int64_t get_index(int64_t s, int64_t match_len) {
    uint32_t c = context(s, 4);
    uint32_t h4 = ((c >> 15) ^ c) & (CTXT4_SIZE - 1);
    uint32_t h3 = ((c >> 11) ^ c) & (CTXT3_SIZE - 1);
    uint32_t h2 = c & MAX16;
    int64_t p = 0;
    if (match_len == 0) {
      p = c4[h4];
      if (p != 0 && c != context(p - 1, 4)) p = 0;
      if (p == 0) {
        p = c3[h3];
        if (p != 0 && (c & MAX24) != context(p - 1, 3)) p = 0;
        if (p == 0) {
          p = c2[h2];
          // reproduce the reference's (c && MAX16) confirmation quirk
          uint32_t confirm = c ? MAX16 : 0;
          if (p != 0 && confirm != context(p - 1, 2)) p = 0;
        }
      }
    }
    if (match_len) match_len--;
    int64_t val = (s | (match_len << LOG_WINDOW)) + 1;
    c4[h4] = val; c3[h3] = val; c2[h2] = val;
    return p;
  }
};

}  // namespace lzp3

extern "C" {


// Adaptive-Huffman order-0 codec ('huff'): alphabet 256 (size known),
// table capacity 257, max_weight 8191.  Returns bytes written.
int64_t cz_huff_encode(const uint8_t* data, int64_t n, uint8_t* out) {
  vhuff::BitWriter bw;
  bw.out = out;
  vhuff::Coder<vhuff::BitWriter> h(257, 256, &bw, 8191);
  for (int64_t i = 0; i < n; i++) h.encode(data[i]);
  bw.flush();
  return bw.o;
}

int64_t cz_huff_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t n) {
  vhuff::BitReader br;
  br.in = in;
  br.len = in_len;
  vhuff::Coder<vhuff::BitReader> h(257, 256, &br, 8191);
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)h.decode();
  return 0;
}

// Order-1 adaptive-Huffman codec ('ctx1'): one coder per previous byte.
int64_t cz_ctx1_encode(const uint8_t* data, int64_t n, uint8_t* out) {
  vhuff::BitWriter bw;
  bw.out = out;
  std::vector<vhuff::Coder<vhuff::BitWriter>> coders;
  coders.reserve(256);
  for (int i = 0; i < 256; i++) coders.emplace_back(256, 256, &bw, 8191);
  int last = 0x20;
  for (int64_t i = 0; i < n; i++) {
    coders[last].encode(data[i]);
    last = data[i];
  }
  bw.flush();
  return bw.o;
}

int64_t cz_ctx1_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t n) {
  vhuff::BitReader br;
  br.in = in;
  br.len = in_len;
  std::vector<vhuff::Coder<vhuff::BitReader>> coders;
  coders.reserve(256);
  for (int i = 0; i < 256; i++) coders.emplace_back(256, 256, &br, 8191);
  int last = 0x20;
  for (int64_t i = 0; i < n; i++) {
    int32_t s = coders[last].decode();
    out[i] = (uint8_t)s;
    last = s;
  }
  return 0;
}

// Semi-static 'smpl' codec body: 128 KiB blocks, raw 16-bit counts, block
// continuation bit, early cut on count saturation.
int64_t cz_simple_encode(const uint8_t* data, int64_t n,
                         int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  const int64_t MAXB = 1 << 17;
  int64_t i = 0;
  while (i < n) {
    int32_t counts[257] = {0};
    int64_t start = i;
    while (i < n && i - start < MAXB) {
      counts[data[i]]++;
      i++;
      if (counts[data[i - 1]] == 0xFFFF) break;  // saturation cut
    }
    int64_t blen = i - start;
    e.encode_shift(1, 1, 1);  // continuation bit = 1
    for (int k = 0; k < 256; k++) e.encode_shift(1, counts[k], 16);
    int32_t cum[257];
    int32_t run = 0;
    for (int k = 0; k < 256; k++) { cum[k] = run; run += counts[k]; }
    cum[256] = (int32_t)blen;
    for (int64_t j = start; j < i; j++) {
      int c = data[j];
      e.encode_freq(counts[c], cum[c], (uint32_t)blen);
    }
  }
  e.encode_shift(1, 0, 1);  // stop bit
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_simple_decode(const uint8_t* in, int64_t in_len,
                         int64_t* dec_state, uint8_t* out, int64_t cap) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  int64_t o = 0;
  for (;;) {
    uint32_t bit = d.decode_cul_shift(1);
    d.update(1, bit, 2);
    if (!bit) break;
    int64_t counts[257];
    for (int k = 0; k < 256; k++) {
      uint32_t v = d.decode_cul_shift(16);
      d.update(1, v, 1 << 16);
      counts[k] = v;
    }
    int64_t cum[257];
    int64_t run = 0;
    for (int k = 0; k < 256; k++) { cum[k] = run; run += counts[k]; }
    cum[256] = run;
    for (int64_t j = 0; j < run; j++) {
      uint32_t cf = d.decode_cul_freq((uint32_t)run);
      // binary search the cumulative table (zero-width ranges exist)
      int lo = 0, hi = 256;
      while (lo + 1 < hi) {
        int mid = (lo + hi) >> 1;
        if (cum[mid] <= (int64_t)cf) lo = mid;
        else hi = mid;
      }
      while (cum[lo + 1] <= (int64_t)cf) lo++;
      if (o >= cap) return -1;
      out[o++] = (uint8_t)lo;
      d.update((uint32_t)(cum[lo + 1] - cum[lo]), (uint32_t)cum[lo],
               (uint32_t)run);
    }
  }
  d.store(dec_state);
  return o;
}

// Order-0 whole-stream coding with the MTF-list model ('mtfm' codec).
int64_t cz_order0_mtf_encode(const uint8_t* data, int64_t n, int32_t size,
                             int32_t eof_sym, int64_t* enc_state,
                             uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  dmc::MTFModel m(size, 0xFF00, 0x100);
  for (int64_t i = 0; i < n; i++) m.encode(e, data[i]);
  if (eof_sym >= 0) m.encode(e, eof_sym);
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_order0_mtf_decode(const uint8_t* in, int64_t in_len,
                             int64_t* dec_state, int32_t size,
                             uint8_t* out, int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  dmc::MTFModel m(size, 0xFF00, 0x100);
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)m.decode(d);
  d.store(dec_state);
  return 0;
}

// Order-0 whole-stream coding with the deferred-summation model ('dfsm').
int64_t cz_order0_defsum_encode(const uint8_t* data, int64_t n,
                                int32_t size, int32_t eof_sym,
                                int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  rc::DefSum m(size, false);
  for (int64_t i = 0; i < n; i++) m.encode(e, data[i]);
  if (eof_sym >= 0) m.encode(e, eof_sym);
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_order0_defsum_decode(const uint8_t* in, int64_t in_len,
                                int64_t* dec_state, int32_t size,
                                uint8_t* out, int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  rc::DefSum m(size, true);
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)m.decode(d);
  d.store(dec_state);
  return 0;
}

// DMC whole-stream coding.
int64_t cz_dmc_encode(const uint8_t* data, int64_t n, int32_t size,
                      int32_t eof_sym, int64_t min1, int64_t min2,
                      int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  dmc::Markov mm(size, min1, min2);
  for (int64_t i = 0; i < n; i++) {
    mm.nodes[mm.current].model.encode(e, data[i]);
    mm.advance(data[i]);
  }
  if (eof_sym >= 0) {
    mm.nodes[mm.current].model.encode(e, eof_sym);
    mm.advance(eof_sym);
  }
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_dmc_decode(const uint8_t* in, int64_t in_len,
                      int64_t* dec_state, int32_t size, int64_t min1,
                      int64_t min2, uint8_t* out, int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  dmc::Markov mm(size, min1, min2);
  for (int64_t i = 0; i < n; i++) {
    int32_t s = mm.nodes[mm.current].model.decode(d);
    mm.advance(s);
    out[i] = (uint8_t)s;
  }
  d.store(dec_state);
  return 0;
}

// PPM whole-stream coding.  eof_sym >= 0 appends an EOF symbol.
int64_t cz_ppm_encode(const uint8_t* data, int64_t n, int32_t size,
                      int32_t eof_sym, int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  ppm::Model m(size);
  for (int64_t i = 0; i < n; i++) m.encode(e, data[i]);
  if (eof_sym >= 0) m.encode(e, eof_sym);
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_ppm_decode(const uint8_t* in, int64_t in_len,
                      int64_t* dec_state, int32_t size, uint8_t* out,
                      int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  ppm::Model m(size);
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)m.decode(d);
  d.store(dec_state);
  return 0;
}

// LZP3 encode body (after the 0x00 coder-mode byte; the caller wrote the
// container).  data: input bytes; enc_state/out as in the BWTC entry.
// Returns bytes written.
int64_t cz_lzp3_encode(const uint8_t* data, int64_t n, int64_t* enc_state,
                       uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  lzp3::Window w(n);
  // literal model: order-1 context of 256 Fenwicks over alphabet 256
  std::vector<rc::Fenwick> lit;
  lit.reserve(256);
  for (int i = 0; i < 256; i++) lit.emplace_back(256, 0xFF00, 0x100);
  std::vector<rc::LogDistModel> lens;
  lens.reserve(16);
  for (int i = 0; i < 16; i++)
    lens.emplace_back(lzp3::MAX_MATCH + 1, 1, lzp3::LEN_CUTOFF,
                      0xFF00, 0x100);
  int64_t i = 0;
  uint32_t match_context = 0;
  while (i < n) {
    int64_t ch = data[i];
    int64_t consumed_this = 1;
    int64_t s = w.pos;
    int64_t p = w.get_index(s, 0);
    if (p != 0) {
      p--;
      int64_t prev_len = (p >> lzp3::LOG_WINDOW) + 1;
      int64_t match_len = 0;
      while (i + match_len < n && w.get(p + match_len) == data[i + match_len]
             && match_len < lzp3::MAX_MATCH) {
        w.put(data[i + match_len]);
        match_len++;
      }
      auto& lm = lens[match_context & 15];
      if (prev_len == match_len) lm.encode(e, -1);
      else lm.encode(e, match_len);
      w.get_index(s, match_len);
      i += match_len;
      match_context <<= 1;
      if (match_len > 0) match_context |= 1;
      if (i >= n) break;  // EOF right after match; size is known
      ch = data[i];
    }
    uint8_t context1 = w.get(w.pos - 1);
    lit[context1].encode(e, (int32_t)ch);
    w.put((uint8_t)ch);
    i++;
    (void)consumed_this;
  }
  e.store(enc_state);
  return e.outlen;
}

// --- LZJB family ---------------------------------------------------------
// Multi-candidate match finder (EXPAND slots per hash bucket), inlined in
// both variants below; C_COMPAT keeps offset 0 unusable in classic LZJB.

// LZJB classic: copymap bytes + 2-byte matches.  Returns output length.
int64_t cz_lzjb_encode(const uint8_t* data, int64_t n, int32_t lempel_size,
                       int32_t expand, uint8_t* out) {
  std::vector<uint16_t> lempel((size_t)lempel_size * expand, 0);
  uint8_t window[1 << 10];
  std::memset(window, 0, sizeof window);
  const int WLEN = 1 << 10;
  const int OFFSET_MASK = WLEN - 1;
  int64_t windowpos = 0;
  int64_t i = 0;
  int64_t o = 0;
  int copymask = 1 << 7;
  int64_t mapbyte = -1;
  int matches[512];
  while (i < n) {
    int c1 = data[i];
    copymask <<= 1;
    if (copymask == (1 << 8)) {
      copymask = 1;
      mapbyte = o;
      out[o++] = 0;
    }
    if (i + 2 >= n) {
      // fewer than 3 bytes left: literals
      out[o++] = (uint8_t)c1;
      window[windowpos++ & OFFSET_MASK] = (uint8_t)c1;
      windowpos &= OFFSET_MASK;
      i++;
      continue;
    }
    int c2 = data[i + 1], c3 = data[i + 2];
    uint32_t h = ((uint32_t)c1 << 16) + ((uint32_t)c2 << 8) + (uint32_t)c3;
    h ^= (h >> 9);
    h += (h >> 5);
    h ^= (uint32_t)c1;
    int64_t hp = (int64_t)(h & (lempel_size - 1)) * expand;
    int nmatch = 0;
    for (int j = 0; j < expand; j++) {
      int offset = (int)((windowpos - lempel[hp + j]) & OFFSET_MASK);
      int64_t cpy = WLEN + windowpos - offset;
      int w1 = window[cpy & OFFSET_MASK];
      int w2 = window[(cpy + 1) & OFFSET_MASK];
      int w3 = window[(cpy + 2) & OFFSET_MASK];
      if (offset == 0) w1 = c1 ^ 1;      // C_COMPAT: offset 0 unusable
      else if (offset == 1) { w2 = c1; w3 = c2; }
      else if (offset == 2) { w3 = c1; }
      if (c1 == w1 && c2 == w2 && c3 == w3) matches[nmatch++] = offset;
    }
    for (int j = expand - 1; j > 0; j--) lempel[hp + j] = lempel[hp + j - 1];
    lempel[hp] = (uint16_t)windowpos;
    if (nmatch == 0) {
      out[o++] = (uint8_t)c1;
      window[windowpos++ & OFFSET_MASK] = (uint8_t)c1;
      windowpos &= OFFSET_MASK;
      i++;
    } else {
      out[mapbyte] |= (uint8_t)copymask;
      for (int k = 0; k < 3; k++) {
        window[windowpos++ & OFFSET_MASK] = data[i + k];
        windowpos &= OFFSET_MASK;
      }
      int last = matches[0];
      int mlen = 3;
      int64_t base = WLEN + windowpos;
      int64_t ip = i + 3;
      while (mlen < 66) {
        if (ip >= n) break;
        int c4 = data[ip];
        int j = 0;
        while (j < nmatch) {
          int w4 = window[(base - matches[j]) & OFFSET_MASK];
          if (c4 != w4) {
            last = matches[j];
            for (int k = j; k < nmatch - 1; k++) matches[k] = matches[k + 1];
            nmatch--;
          } else {
            j++;
          }
        }
        if (nmatch == 0) break;
        window[windowpos++ & OFFSET_MASK] = (uint8_t)c4;
        windowpos &= OFFSET_MASK;
        ip++;
        mlen++;
        base++;
      }
      if (nmatch != 0) last = matches[0];
      out[o++] = (uint8_t)(((mlen - 3) << 2) | (last >> 8));
      out[o++] = (uint8_t)(last & 0xFF);
      i += mlen;
    }
  }
  return o;
}

int64_t cz_lzjb_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t out_size) {
  uint8_t window[1 << 10];
  std::memset(window, 0, sizeof window);
  const int WLEN = 1 << 10;
  int64_t windowpos = 0;
  int copymask = 1 << 7;
  int copymap = 0;
  int64_t i = 0, o = 0;
  while (o != out_size && i < n) {
    int c = in[i++];
    copymask <<= 1;
    if (copymask == (1 << 8)) {
      copymask = 1;
      copymap = c;
      if (i >= n) break;
      c = in[i++];
    }
    if (copymap & copymask) {
      int mlen = (c >> 2) + 3;
      if (i >= n) break;
      int offset = (((c << 8) | in[i++]) & (WLEN - 1));
      int64_t cpy = windowpos - offset;
      if (cpy < 0) cpy += WLEN;
      while (mlen-- > 0 && o < out_size) {
        uint8_t b = window[cpy++];
        window[windowpos++] = b;
        out[o++] = b;
        if (windowpos >= WLEN) windowpos = 0;
        if (cpy >= WLEN) cpy = 0;
      }
    } else {
      out[o++] = (uint8_t)c;
      window[windowpos++] = (uint8_t)c;
      if (windowpos >= WLEN) windowpos = 0;
    }
  }
  return o;
}

// LZJB-R: same parse, range-coded.  Returns bytes written.
int64_t cz_lzjbr_encode(const uint8_t* data, int64_t n,
                        int32_t lempel_size, int32_t expand,
                        int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  std::vector<uint16_t> lempel((size_t)lempel_size * expand, 0);
  uint8_t window[1 << 10];
  std::memset(window, 0, sizeof window);
  const int WLEN = 1 << 10;
  const int OFFSET_MASK = WLEN - 1;
  const int MATCH = 256;
  // literal: order-1 context of 256 Fenwicks over 257 (MATCH+1)
  std::vector<rc::Fenwick> lit;
  lit.reserve(256);
  for (int i = 0; i < 256; i++) lit.emplace_back(MATCH + 1, 0xFF00, 0x100);
  rc::LogDistModel len_model(64, 0, 32, 0xFF00, 0x100);
  rc::LogDistModel pos_model(WLEN, 1, 32, 0xFF00, 0x100);
  int64_t windowpos = 0;
  int64_t i = 0;
  int last_char = 0x20;
  int last_offset = 0;
  int matches[512];
  while (i < n) {
    int64_t initial_pos = windowpos;
    int c1 = data[i];
    if (i + 2 >= n) {
      window[windowpos++ & OFFSET_MASK] = (uint8_t)c1;
      windowpos &= OFFSET_MASK;
      lit[last_char].encode(e, c1);
      last_char = c1;
      i++;
      continue;
    }
    int c2 = data[i + 1], c3 = data[i + 2];
    uint32_t h = ((uint32_t)c1 << 16) + ((uint32_t)c2 << 8) + (uint32_t)c3;
    h ^= (h >> 9);
    h += (h >> 5);
    h ^= (uint32_t)c1;
    int64_t hp = (int64_t)(h & (lempel_size - 1)) * expand;
    int nmatch = 0;
    for (int j = 0; j < expand; j++) {
      int offset = (int)((windowpos - lempel[hp + j]) & OFFSET_MASK);
      int64_t cpy = WLEN + windowpos - offset;
      int w1 = window[cpy & OFFSET_MASK];
      int w2 = window[(cpy + 1) & OFFSET_MASK];
      int w3 = window[(cpy + 2) & OFFSET_MASK];
      if (offset == 1) { w2 = c1; w3 = c2; }
      else if (offset == 2) { w3 = c1; }
      if (c1 == w1 && c2 == w2 && c3 == w3) matches[nmatch++] = offset;
    }
    for (int j = expand - 1; j > 0; j--) lempel[hp + j] = lempel[hp + j - 1];
    lempel[hp] = (uint16_t)windowpos;
    if (nmatch == 0) {
      window[windowpos++ & OFFSET_MASK] = (uint8_t)c1;
      windowpos &= OFFSET_MASK;
      lit[last_char].encode(e, c1);
      last_char = c1;
      i++;
    } else {
      lit[last_char].encode(e, MATCH);
      for (int k = 0; k < 3; k++) {
        window[windowpos++ & OFFSET_MASK] = data[i + k];
        windowpos &= OFFSET_MASK;
      }
      last_char = c3;
      int last = matches[0];
      int mlen = 3;
      int64_t base = WLEN + windowpos;
      int64_t ip = i + 3;
      while (mlen < 66) {
        if (ip >= n) break;
        int c4 = data[ip];
        int j = 0;
        while (j < nmatch) {
          int w4 = window[(base - matches[j]) & OFFSET_MASK];
          if (c4 != w4) {
            last = matches[j];
            for (int k = j; k < nmatch - 1; k++) matches[k] = matches[k + 1];
            nmatch--;
          } else {
            j++;
          }
        }
        if (nmatch == 0) break;
        window[windowpos++ & OFFSET_MASK] = (uint8_t)c4;
        windowpos &= OFFSET_MASK;
        last_char = c4;
        ip++;
        mlen++;
        base++;
      }
      if (nmatch != 0) last = matches[0];
      len_model.encode(e, mlen - 3);
      int offset = (int)((initial_pos - last) & OFFSET_MASK);
      if (offset == last_offset) {
        pos_model.encode(e, -1);
      } else {
        pos_model.encode(e, offset);
        last_offset = offset;
      }
      i += mlen;
    }
  }
  e.store(enc_state);
  return e.outlen;
}

int64_t cz_lzjbr_decode(const uint8_t* in, int64_t in_len,
                        int64_t* dec_state, uint8_t* out,
                        int64_t out_size) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  uint8_t window[1 << 10];
  std::memset(window, 0, sizeof window);
  const int WLEN = 1 << 10;
  const int MATCH = 256;
  std::vector<rc::Fenwick> lit;
  lit.reserve(256);
  for (int i = 0; i < 256; i++) lit.emplace_back(MATCH + 1, 0xFF00, 0x100);
  rc::LogDistModel len_model(64, 0, 32, 0xFF00, 0x100);
  rc::LogDistModel pos_model(WLEN, 1, 32, 0xFF00, 0x100);
  int64_t windowpos = 0;
  int last_char = 0x20;
  int64_t last_offset = 0;
  int64_t o = 0;
  while (o != out_size) {
    int32_t c = lit[last_char].decode(d);
    if (c == MATCH) {
      int64_t mlen = len_model.decode(d) + 3;
      int64_t cpy = pos_model.decode(d);
      if (cpy < 0) cpy = last_offset;
      else last_offset = cpy;
      while (mlen-- > 0) {
        uint8_t b = window[cpy++];
        last_char = b;
        window[windowpos++] = b;
        out[o++] = b;
        if (windowpos >= WLEN) windowpos = 0;
        if (cpy >= WLEN) cpy = 0;
      }
    } else {
      out[o++] = (uint8_t)c;
      last_char = c;
      window[windowpos++] = (uint8_t)c;
      if (windowpos >= WLEN) windowpos = 0;
    }
  }
  d.store(dec_state);
  return 0;
}

int64_t cz_lzp3_decode(const uint8_t* in, int64_t in_len,
                       int64_t* dec_state, uint8_t* out, int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  lzp3::Window w(n);
  std::vector<rc::Fenwick> lit;
  lit.reserve(256);
  for (int i = 0; i < 256; i++) lit.emplace_back(256, 0xFF00, 0x100);
  std::vector<rc::LogDistModel> lens;
  lens.reserve(16);
  for (int i = 0; i < 16; i++)
    lens.emplace_back(lzp3::MAX_MATCH + 1, 1, lzp3::LEN_CUTOFF,
                      0xFF00, 0x100);
  int64_t o = 0;
  uint32_t match_context = 0;
  while (o < n) {
    int64_t s = w.pos;
    int64_t p = w.get_index(s, 0);
    if (p != 0) {
      p--;
      int64_t prev_len = (p >> lzp3::LOG_WINDOW) + 1;
      int64_t match_len = lens[match_context & 15].decode(d);
      if (match_len < 0) match_len = prev_len;
      // a corrupt stream can code a match longer than the remaining
      // output; clamp so the copy below cannot write past `out`
      if (match_len > n - o) match_len = n - o;
      for (int64_t k = 0; k < match_len; k++) {
        uint8_t ch = w.get(p + k);
        out[o++] = w.put(ch);
      }
      w.get_index(s, match_len);
      match_context <<= 1;
      if (match_len > 0) match_context |= 1;
    }
    if (o >= n) break;
    uint8_t context1 = w.get(w.pos - 1);
    int32_t ch = lit[context1].decode(d);
    out[o++] = w.put((uint8_t)ch);
  }
  d.store(dec_state);
  return 0;
}

// BWTC block body: RLE2-code the MTF index stream through a fresh
// Fenwick (fast=0) or DefSum (fast=1) model on a shared range coder.
// enc_state: int64[5] in/out.  Returns bytes written to `out`.
int64_t cz_bwtc_encode_block(const int32_t* mtf, int64_t n, int32_t asize,
                             int32_t fast, int64_t* enc_state,
                             uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  rc::Fenwick fen(fast ? 1 : asize + 1, 0xFF00, 0x100);
  rc::DefSum def(fast ? asize + 1 : 1, false);
  int64_t run = 0;
  auto emit = [&](int32_t sym) {
    if (fast) def.encode(e, sym); else fen.encode(e, sym);
  };
  auto flush_run = [&]() {
    while (run) {
      int d = (run & 1) ? 0 : 1;
      emit(d);
      run = (run - 1 - d) >> 1;
    }
  };
  for (int64_t i = 0; i < n; i++) {
    int32_t c = mtf[i];
    if (c == 0) { run++; continue; }
    flush_run();
    emit(c + 1);
  }
  flush_run();
  e.store(enc_state);
  return e.outlen;
}

// BWTC block decode: fill b[0..length) with MTF indices.
// dec_state: int64[5] in/out ([low, range, buffer, pos]).
// Returns 0, or -1 on overrun.
int64_t cz_bwtc_decode_block(const uint8_t* in, int64_t in_len,
                             int64_t* dec_state, int32_t asize,
                             int32_t fast, uint8_t* b, int64_t length) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  rc::Fenwick fen(fast ? 1 : asize + 1, 0xFF00, 0x100);
  rc::DefSum def(fast ? asize + 1 : 1, true);
  int64_t i = 0;
  int64_t val = 1;
  while (i < length) {
    int32_t c = fast ? def.decode(d) : fen.decode(d);
    if (c == 0) {
      if (i + val > length) return -1;
      std::memset(b + i, 0, val);
      i += val;
      val *= 2;
    } else if (c == 1) {
      if (i + 2 * val > length) return -1;
      std::memset(b + i, 0, 2 * val);
      i += 2 * val;
      val *= 2;
    } else {
      val = 1;
      b[i++] = (uint8_t)(c - 1);
    }
  }
  d.store(dec_state);
  return 0;
}

// Order-0 coding of a whole symbol stream through one fresh Fenwick model
// of `size` symbols (a BWTC-L lane).  data: the symbols, each below
// `size` and below 256; eof_sym >= 0 appends that symbol.  enc_state:
// int64[5] in/out.  Returns bytes written to `out`.
int64_t cz_order0_fenwick_encode(const uint8_t* data, int64_t n,
                                 int32_t size, int32_t eof_sym,
                                 int64_t* enc_state, uint8_t* out) {
  rc::Enc e;
  e.load(enc_state);
  e.out = out;
  e.outlen = 0;
  rc::Fenwick fen(size, 0xFF00, 0x100);
  for (int64_t i = 0; i < n; i++) fen.encode(e, data[i]);
  if (eof_sym >= 0) fen.encode(e, eof_sym);
  e.store(enc_state);
  return e.outlen;
}

// Decode n symbols of such a stream into out.  dec_state: int64[5]
// in/out ([low, range, buffer, pos]).  Returns 0.
int64_t cz_order0_fenwick_decode(const uint8_t* in, int64_t in_len,
                                 int64_t* dec_state, int32_t size,
                                 uint8_t* out, int64_t n) {
  rc::Dec d;
  d.load(dec_state);
  d.in = in;
  d.len = in_len;
  rc::Fenwick fen(size, 0xFF00, 0x100);
  for (int64_t i = 0; i < n; i++) out[i] = (uint8_t)fen.decode(d);
  d.store(dec_state);
  return 0;
}

}  // extern "C"
