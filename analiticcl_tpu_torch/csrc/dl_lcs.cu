// Banded, windowed Damerau-Levenshtein + longest common substring on Hopper.
//
// Replaces the TPU kernel `_dl_kernel` in analiticcl_tpu/ops/dl_pallas.py
// (launched by `_dl_lcs_pallas`). Same contract: for every (query, candidate)
// pair the unrestricted DL distance is exact when it is <= W and some value
// > W otherwise; the LCS is exact. The DP is banded to |i - j| <= W + 1 and
// the transposition lookback is bounded to W + 1 rows and columns; a margin
// of W + 1 cells on each side of the band is cleared to `big` so that a
// reused ring slot never feeds a stale small value into a live read
// (proof of the contract in analiticcl_tpu/ops/dl_jax.py).
//
// Design: one thread per pair. The Pallas kernel put 1024 pairs in the
// (8, 128) vector lanes and unrolled the DP over static indices because a
// TPU cannot gather per lane; a CUDA thread indexes its own state, so the
// transposition term is a single read at (last, db) instead of a
// (W+1)^2 select slab.
//
// Storage: the ring of W + 3 DP rows of L + 1 columns and the last-match
// column live in dynamic shared memory as bytes, pair-fastest (element k of
// thread t at smem[k * THREADS + t], the Pallas kernel's ring[R, L+1, SUB,
// LANE] layout): when a warp touches one element it reads 32 consecutive
// bytes, one wavefront without bank conflicts; only the transposition read
// has a data-dependent address. b's characters and the LCS row sit in
// registers (static indices in fully unrolled loops); one pass over them per
// DP row also builds the row's match mask (bit j: b[j] == a[i-1]), which
// the band loop tests instead of indexing b. No per-thread array has a
// dynamic index, so nothing goes to local memory. For L > 32 (the LMAX 64
// instance) the LCS row is kept in shared memory as bytes too.
//
// Why bytes are exact: a band cell is min(sub, ins, del, transp) and
// del = (the cell to its left) + 1, starting from `i` or `big` at the band's
// first column, so along a row every stored cell is at most big + L =
// 3L + 8 <= 200 for L <= 64; row 0 and the margins hold big = 2L + 8, row 1
// holds 0..L, the last-match column and the LCS row hold values <= L. Every
// stored value fits in a uint8_t unchanged: no clamping, no saturation, and
// the outputs equal those of the same DP on int cells bit for bit, above W
// too (tests/test_torch_dl.py holds both host builds against each other).
//
// What bounds it on the H100: instruction issue, about 3,000 integer
// operations per pair at L 25 and W 3 (the band, and a full-width pass per
// row for the mask and the LCS row); the pairs' strings are read once.
// Shared memory per thread is (W + 3)(L + 1) + L bytes (+ L for LMAX 64);
// the registers (96-116 at LMAX 32) allow 4-5 blocks of 128 threads per
// SM, and capping them to fit more blocks spills and runs slower.
//
// Two entries run this DP. `analiticcl_dl_lcs` takes int32 [P, L] pair
// strings. The slot entry, which the query core runs, also replaces the
// JAX core's XLA glue beside the Pallas call: the per-pair gathers and the
// affixes (analiticcl_tpu/ops/pipeline.py:594-647) and, in its epilogue,
// the score and the keep tests after it (:671-722). It takes stage B's
// slots (query, device row, valid) and each thread reads its pair's two
// strings by row from the index's int8 or int32 norms and the batch's
// query norms (both stay in L2), computes the common prefix and suffix
// (the suffix from the ends of the forward strings) and the case flag, and
// runs the DP on the rows as they are, so no [P, L] strings are written.
// Its metrics instance (`analiticcl_dl_lcs_slots`) writes six int32
// metrics and the case flag a slot; the main path's
// (`analiticcl_dl_lcs_slots_scored`) scores each slot in f32 in the JAX
// core's operation order (no FMA contraction), applies the edit-threshold,
// StopAtExactMatch and score tests, takes the per-query frequency maxima
// (a segmented max in the warp, then one 64-bit atomicMax per query run)
// and writes only the keep flag and five uint8 metrics: 6 bytes a slot
// instead of 25, and none of the score's torch ops after it. Each block
// also stores how many of its slots it kept (one __syncthreads_count and
// one int32 store), which the survivor compaction (csrc/compact.cu) sums to
// place its survivors without a second pass over the keep flags. Bound the
// same way: its bytes are the slots, the rows the pairs touch and its
// outputs; its time is the DP's. (Staging the block's rows in shared
// memory was measured slower on the H100: the copy's loads waited one by
// one, or, issued together, raised the registers to 204-255 with spills.)

// Width: the byte DP above takes pairs whose two strings are both at most
// NARROW = 64 long (3 * 64 + 8 = 200 fits a byte), at any table width L: a
// pair's DP depends on its own lengths, so above L 64 it runs at DP width
// 64 on rows read at stride L. A pair with a longer string (possible only
// above L 64, and rare: stage A pairs strings of near-equal length) takes
// the wide path, a second launch over the same slots: one warp per pair,
// lane k holding band column jstart + k of a row (the band's 2W + 3
// columns fit a warp up to W 14). The del chain along a row is a warp
// prefix minimum, the last match left of a column a ballot; the band
// values of the last W + 3 rows (the transposition's lookback) and the
// last-match row of the band's columns live in shared memory as int
// cells, band-relative, so a warp's state is O(W) at any L. It computes
// the same cells as the full-width DP: a row's band plus its margins
// covers every column a later row reads of it, so a read outside a stored
// band is a margin, `big` (or column 0, or row 0/1's initial values). The
// LCS (not banded) is the longest run of matches along a diagonal: the
// lanes walk the diagonals, O(1) state each. A wide
// pair's outputs and its keep test are the same functions as the byte
// path's; its frequency maximum and its block's kept count are one
// atomicMax and one atomicAdd after the first launch's stores. From L 256
// the scored entry writes its five metrics as int32 (the JAX pipeline's
// rule; an LCS, prefix or suffix can pass 255 there).

// With -DANALITICCL_HOST_TEST the per-pair DP compiles as plain C++ (for
// checking its arithmetic on a machine without a card).
#include <climits>
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define DEVFN __device__ __forceinline__
#define HDFN __host__ __device__ __forceinline__
#else
#include <algorithm>
#include <cstddef>
#include <vector>
using std::max;
using std::min;
#define DEVFN inline
#define HDFN inline
#endif

namespace {

constexpr int NARROW = 64;  // the byte DP's widest pair
static_assert(3 * NARROW + 8 <= 255,
              "every stored DP value (at most 3L + 8) must fit in a byte");

// The scored entry's metric columns: uint8 below L 256, int32 from it.
HDFN constexpr int met_bytes(int L) { return L >= 256 ? 4 : 1; }

template <int LMAX>
struct MaskOf {
  using T = unsigned long long;
};
template <>
struct MaskOf<32> {
  using T = unsigned int;
};

// Per-pair state elements: the ring (R rows of L + 1), the last-match
// column (L) and, for LMAX > 32, the LCS row (L).
template <int W, int LMAX>
HDFN constexpr int state_elems(int L) {
  return (W + 3) * (L + 1) + L + (LMAX > 32 ? L : 0);
}

// Initial value of state element k: ring row 1 holds 0..L, the other rows
// big; the last-match column and the LCS row 0.
template <int W>
HDFN int state_init(int k, int L) {
  const int pitch = L + 1;
  if (k >= (W + 3) * pitch) return 0;
  return k / pitch == 1 ? k - pitch : 2 * L + 8;
}

// The DP of one pair over initialised state: element k at st[k * stride].
// The strings are read as elements of type Ch: int32 pair strings (the
// `analiticcl_dl_lcs` entry), or int8/int32 rows of the index's and the
// batch's tables (the slot entry). Only a[0 .. al) and b[0 .. L) are read,
// and b's elements from bl on feed no cell of a column <= bl: the distance
// (read at column bl) and the LCS (masked to j < bl) do not depend on
// what the row holds past its length.
template <typename Cell, int W, int LMAX, typename Ch = int>
DEVFN void dl_lcs_pair(const Ch* ap, int al, const Ch* bp, int bl, int L,
                       Cell* st, int stride, int* ld_out, int* lcs_out) {
  constexpr int R = W + 3;   // ring depth: rows i+1 .. i-W-1
  constexpr int B1 = W + 1;  // band half-width
  constexpr bool LCS_IN_STATE = LMAX > 32;
  using Mask = typename MaskOf<LMAX>::T;
  const int big = 2 * L + 8;
  const int pitch = L + 1;
  Cell* const ring = st;  // slot k % R holds DP row k; (slot, p) at slot * pitch + p
  Cell* const lastcol = st + R * pitch * stride;  // last row i with a[i-1] == b[j]
  Cell* const lcs_st = lastcol + L * stride;      // LCS row when LCS_IN_STATE

  int bs[LMAX];
  int lcsrow[LMAX];
#pragma unroll
  for (int j = 0; j < LMAX; ++j) {
    bs[j] = j < L ? bp[j] : 0;
    lcsrow[j] = 0;
  }

  int res = big;
  int best = 0;
  int s_next = al > 0 ? ap[0] : 0;
  for (int i1 = 0; i1 < al; ++i1) {
    const int i = i1 + 1;  // reading row i, writing row i + 1
    const int s = s_next;
    if (i < al) s_next = ap[i];

    // the row's match mask, and the LCS row rolled in place from the right
    Mask mbits = 0;
#pragma unroll
    for (int j = LMAX - 1; j >= 0; --j) {
      const bool m = bs[j] == s;
      mbits |= Mask(m) << j;
      if (!LCS_IN_STATE) {
        const int v = m && j < bl ? (j > 0 ? lcsrow[j - 1] : 0) + 1 : 0;
        lcsrow[j] = v;
        best = max(best, v);
      }
    }
    if (LCS_IN_STATE) {
      for (int j = bl - 1; j >= 0; --j) {
        const int v = (mbits >> j) & 1 ? (j > 0 ? int(lcs_st[(j - 1) * stride]) : 0) + 1 : 0;
        lcs_st[j * stride] = Cell(v);
        best = max(best, v);
      }
    }

    Cell* const wrow = ring + ((i + 1) % R) * pitch * stride;
    const Cell* const rrow = ring + (i % R) * pitch * stride;
    const int center = i1 + 1;
    const int jstart = max(1, center - B1);
    const int jend = min(L, center + B1);

    wrow[0] = Cell(i);
#pragma unroll
    for (int m = 1; m <= B1; ++m) {
      const int lo = center - B1 - m, hi = center + B1 + m;
      if (lo >= 1 && lo <= L) wrow[lo * stride] = Cell(big);
      if (hi >= 1 && hi <= L) wrow[hi * stride] = Cell(big);
    }

    const int ndl = min(W, i);
    int del_prev = jstart == 1 ? i : big;
    int up_left = rrow[(jstart - 1) * stride];  // rrow[j - 1]
    int db = 0;  // last column < j of this row with a match
    for (int j = jstart; j <= jend; ++j) {
      const bool match = (mbits >> (j - 1)) & 1;
      const int up = rrow[j * stride];
      const int sub = up_left + (match ? 0 : 1);
      const int ins = up + 1;
      const int del = del_prev + 1;
      const int last = lastcol[(j - 1) * stride];
      const int d = i - last;
      const int smax = min(W, j - 1);
      int transp = big;
      if (smax >= 1 && d >= 1 && d <= ndl && db >= j - smax) {
        const int t = int(ring[((last % R) * pitch + db - 1) * stride]) + d - 1 + j - db;
        transp = min(transp, t);
      }
      const int nv = min(min(sub, ins), min(del, transp));
      wrow[j * stride] = Cell(nv);
      if (i1 == al - 1 && j == bl) res = nv;
      del_prev = nv;
      up_left = up;
      if (match) {
        db = j;
        lastcol[(j - 1) * stride] = Cell(i);
      }
    }
  }
  if (al == 0) res = bl;
  if (bl == 0) res = al;
  *ld_out = res;
  *lcs_out = best;
}

// The slot entry's inputs: stage B's pair slots and the tables their
// strings and attributes are read from, by row. Ch is the tables' element
// type (int8, or int32 for alphabets of 120 symbols or more).
template <typename Ch>
struct SlotTables {
  const int* q;                        // [P] the slot's query
  const int* pc;                       // [P] the slot's device row
  const unsigned char* valid;          // [P]
  const Ch* norms2;                    // [Ni, 2L] forward | reversed norms
  const int* norm_lens;                // [Ni]
  const unsigned char* first_lower;    // [Ni]
  const Ch* q_norms;                   // [B, L]
  const int* q_lens;                   // [B]
  const unsigned char* q_first_lower;  // [B]
  const int* k_ed;                     // [B]
};

// The metrics instance's outputs (the holds and the `gather_dl` stop):
// rows of one int32 [6, P] block (ld, lcs, prefix, suffix, the query
// length (0 for an invalid slot) and the query's edit threshold) and
// same_first [P]. Null on the main path.
struct SlotOut {
  int* metrics;
  unsigned char* same_first;
};

// The scoring epilogue's inputs (the JAX core's score and keep tests,
// analiticcl_tpu/ops/pipeline.py:671-722). Null weights: no epilogue.
struct ScoreIn {
  const float* weights;            // [6] ld, lcs, prefix, suffix, case, sum
  const float* thr;                // [1] the score threshold less the slack
  const int* pc_band;              // [P] the slot's band row
  const unsigned char* exact_q;    // [B, nb8] stage A's exact-anagram bits
  int nb8;
  const unsigned char* use_exact;  // [B], or null: no StopAtExactMatch
  const long long* freqs;          // [Ni], or null: no frequencies
};

// Its outputs: the keep flag, the metrics the survivor compaction moves
// (one [5, P] block of met_bytes(L)-byte elements: ld, and lcs, prefix,
// suffix and the case flag as the weights gate them), the per-query
// frequency maxima (zeroed by the caller; null without frequencies), for
// the `score` stop the score, and the kept slots of each block of
// slot_threads slots (null: none).
struct ScoreOut {
  unsigned char* keep;
  void* met;
  int met_bytes;
  unsigned long long* max_freq;
  float* score;
  int* counts;
};

// Slots per block of the slot entry's instance for strings up to LMAX.
template <int LMAX>
HDFN constexpr int slot_threads() {
  return LMAX > 32 ? 64 : 128;
}


// One slot's metrics.
struct SlotMetrics {
  int ld, lcs, pf, sf, ql;
  bool same_first;
};

// A slot's query length (0 for an invalid slot) and its two strings'
// lengths; a length above L is invalid input, and clamping keeps every
// read in the row.
struct SlotLens {
  int ql, al, bl;
};

template <typename Ch>
HDFN SlotLens slot_lens(const SlotTables<Ch>& t, int qi, int ci, bool v,
                        int L) {
  SlotLens n;
  n.ql = v ? t.q_lens[qi] : 0;
  n.al = min(n.ql, L);
  n.bl = min(v ? t.norm_lens[ci] : 0, L);
  return n;
}

// The common prefix and suffix of a[0, al) and b[0, bl), the suffix from
// the ends of the forward strings.
template <typename Ch>
HDFN void affixes(const Ch* ap, int al, const Ch* bp, int bl, int& pf,
                  int& sf) {
  const int n = min(al, bl);
  pf = 0;
  while (pf < n && ap[pf] == bp[pf]) ++pf;
  sf = 0;
  while (sf < n && ap[al - 1 - sf] == bp[bl - 1 - sf]) ++sf;
}

// Slot p of query qi and device row ci on the byte path: its strings ap
// and bp (the rows of the tables as they are; empty for an invalid slot),
// the affixes, the case flags compared, and the DP on the rows at width
// Ldp; what gather_pairs, affix_metrics_aligned and the DL+LCS of the pair
// strings give.
template <typename Cell, int W, int LMAX, typename Ch>
DEVFN SlotMetrics slot_pair(int qi, int ci, const SlotLens& n, const Ch* ap,
                            const Ch* bp, int Ldp, const SlotTables<Ch>& t,
                            Cell* st, int stride) {
  SlotMetrics r;
  r.ql = n.ql;
  affixes(ap, n.al, bp, n.bl, r.pf, r.sf);
  r.same_first = (t.first_lower[ci] != 0) == (t.q_first_lower[qi] != 0);
  dl_lcs_pair<Cell, W, LMAX, Ch>(ap, n.al, bp, n.bl, Ldp, st, stride, &r.ld,
                                 &r.lcs);
  return r;
}

// IEEE single-precision operations, rounded to nearest, none contracted
// into an FMA: the score's arithmetic as torch evaluates it, op by op.
#ifndef ANALITICCL_HOST_TEST
DEVFN float f_mul(float a, float b) { return __fmul_rn(a, b); }
DEVFN float f_add(float a, float b) { return __fadd_rn(a, b); }
DEVFN float f_sub(float a, float b) { return __fsub_rn(a, b); }
DEVFN float f_div(float a, float b) { return __fdiv_rn(a, b); }
#else  // built with -ffp-contract=off
inline float f_mul(float a, float b) { return a * b; }
inline float f_add(float a, float b) { return a + b; }
inline float f_sub(float a, float b) { return a - b; }
inline float f_div(float a, float b) { return a / b; }
#endif

template <typename T>
DEVFN void store_met(T* m, int P, int p, int ld, int lcs, int pf, int sf,
                     bool samecase) {
  m[p] = (T)ld;
  m[(size_t)P + p] = (T)lcs;
  m[2 * (size_t)P + p] = (T)pf;
  m[3 * (size_t)P + p] = (T)sf;
  m[4 * (size_t)P + p] = (T)samecase;
}

// Slot p's outputs. The metrics instance writes r as it is; the epilogue
// the JAX core's f32 score of r in its operation order (the weights gate
// lcs, prefix, suffix and the case flag; each ratio term is (w * x) /
// qlen, left to right), the edit-threshold and exact tests, the keep flag
// and the gated metrics; `kept` is set to the keep flag. Returns the
// frequency the slot offers its query's maximum: its row's where it passes
// the edit tests, else 0.
DEVFN unsigned long long write_slot(int p, int P, int qi, int ci, bool v,
                                    const SlotMetrics& r, int k_ed,
                                    SlotOut out, const ScoreIn& in,
                                    ScoreOut so, bool& kept) {
  if (out.metrics) {
    int* const m = out.metrics;
    m[p] = r.ld;
    m[(size_t)P + p] = r.lcs;
    m[2 * (size_t)P + p] = r.pf;
    m[3 * (size_t)P + p] = r.sf;
    m[4 * (size_t)P + p] = r.ql;
    m[5 * (size_t)P + p] = k_ed;
  }
  if (out.same_first) out.same_first[p] = r.same_first;
  if (!in.weights) return 0;
  const float* const w = in.weights;
  const int lcs = w[1] > 0.f ? r.lcs : 0;
  const int pf = w[2] > 0.f ? r.pf : 0;
  const int sf = w[3] > 0.f ? r.sf : 0;
  const bool samecase = w[4] > 0.f ? r.same_first : true;
  const float qlen_f = (float)max(r.ql, 1);
  const float ds = r.ld > r.ql ? 0.f : f_sub(1.f, f_div((float)r.ld, qlen_f));
  float score = f_mul(w[0], ds);
  score = f_add(score, f_div(f_mul(w[1], (float)lcs), qlen_f));
  score = f_add(score, f_div(f_mul(w[2], (float)pf), qlen_f));
  score = f_add(score, f_div(f_mul(w[3], (float)sf), qlen_f));
  score = f_add(score, samecase ? w[4] : 0.f);
  score = f_div(score, w[5]);
  bool pass_ed = v && r.ld <= k_ed;
  if (in.use_exact && pass_ed && in.use_exact[qi]) {
    // StopAtExactMatch: a query with an exact anagram keeps only those
    const int pcb = in.pc_band[p];
    pass_ed = (in.exact_q[(size_t)qi * in.nb8 + (pcb >> 3)] >> (pcb & 7)) & 1;
  }
  kept = pass_ed && score >= *in.thr;
  so.keep[p] = kept;
  if (so.met_bytes == 4)
    store_met((int*)so.met, P, p, r.ld, lcs, pf, sf, samecase);
  else
    store_met((unsigned char*)so.met, P, p, r.ld, lcs, pf, sf, samecase);
  if (so.score) so.score[p] = score;
  return pass_ed && in.freqs ? (unsigned long long)in.freqs[ci] : 0ull;
}

// ---- The wide path: one warp per pair with a string over NARROW ----

template <int W>
struct Wide {
  static constexpr int R = W + 3;            // ring depth, the byte DP's
  static constexpr int B1 = W + 1;           // band half-width
  static constexpr int BW = 2 * B1 + 1;      // band columns of a row
  static constexpr int STATE = R * BW + BW;  // the rows' bands, last matches
  static_assert(BW <= 32, "a row's band fits in a warp");
};

// Cell (r, c) of the DP, 0 <= c <= L, as the full-width DP holds it when a
// later row reads it: row 0 is big, row 1 is 0..L, column 0 of row r is
// r - 1; from row 2 on, columns inside the row's band are stored (ring
// slot r % R, band-relative) and those outside it are its margins, big.
template <int W>
HDFN int wide_cell(const int* ring, int r, int c, int L) {
  using D = Wide<W>;
  if (r == 0) return 2 * L + 8;
  if (r == 1) return c;
  if (c == 0) return r - 1;
  const int lo = max(1, r - 1 - D::B1);
  if (c < lo || c > min(L, r - 1 + D::B1)) return 2 * L + 8;
  return ring[(r % D::R) * D::BW + c - lo];
}

// Band column j of the row written from row i: min(sub, ins, transp), the
// byte DP's terms (transp big unless its tests pass); db is the last column
// left of j in the row's band with a match, 0 for none. The last-match row
// of column j is slot (j - 1) % BW; a column entering the band (j = i + B1)
// has none yet.
template <int W>
HDFN int wide_candidate(const int* st, int i, int j, bool match, int db,
                        int L) {
  using D = Wide<W>;
  const int sub = wide_cell<W>(st, i, j - 1, L) + (match ? 0 : 1);
  const int ins = wide_cell<W>(st, i, j, L) + 1;
  const int last = j == i + D::B1 ? 0 : st[D::R * D::BW + (j - 1) % D::BW];
  const int d = i - last, smax = min(W, j - 1);
  int transp = 2 * L + 8;
  if (smax >= 1 && d >= 1 && d <= min(W, i) && db >= j - smax)
    transp = min(transp,
                 wide_cell<W>(st, last, db - 1, L) + d - 1 + j - db);
  return min(min(sub, ins), transp);
}

// Cell (i + 1, j) = nv into its ring slot, and column j's last match.
template <int W>
HDFN void wide_store(int* st, int i, int j, int jstart, bool match, int nv) {
  using D = Wide<W>;
  st[((i + 1) % D::R) * D::BW + j - jstart] = nv;
  if (match || j == i + D::B1)
    st[D::R * D::BW + (j - 1) % D::BW] = match ? i : 0;
}

// The longest run of matches along the diagonals first, first + step, ...
// (offset j - i from -(al - 1) to bl - 1): the LCS, over every lane's
// diagonals. Four steps of a diagonal are loaded at once; a diagonal, or
// its rest, that cannot beat the best (even continuing the current run)
// is skipped.
template <typename Ch>
HDFN int lcs_diagonals(const Ch* ap, int al, const Ch* bp, int bl, int first,
                       int step) {
  int best = 0;
  for (int d = first - (al - 1); d < bl; d += step) {
    const int i0 = max(0, -d);
    const int n = min(al - i0, bl - i0 - d);
    const Ch* const x = ap + i0;
    const Ch* const y = bp + i0 + d;
    int run = 0;
    for (int k = 0; k < n && run + n - k > best; k += 4) {
      bool eq[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) eq[u] = k + u < n && x[k + u] == y[k + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run = eq[u] ? run + 1 : 0;
        best = max(best, run);
      }
    }
  }
  return best;
}

#ifndef ANALITICCL_HOST_TEST
constexpr unsigned FULL = 0xffffffffu;

// Element k of every thread is one row of THREADS equal bytes: the block
// fills the rows with 16-byte stores.
template <int W, int LMAX, int THREADS>
__device__ __forceinline__ void init_state(unsigned char* smem, int L) {
  constexpr int PER_ROW = THREADS / 16;
  const int nwords = state_elems<W, LMAX>(L) * PER_ROW;
  uint4* const words = reinterpret_cast<uint4*>(smem);
  for (int w = threadIdx.x; w < nwords; w += THREADS) {
    const unsigned v = 0x01010101u * (unsigned)state_init<W>(w / PER_ROW, L);
    words[w] = make_uint4(v, v, v, v);
  }
  __syncthreads();
}

// The byte path of the pair-string entry. Rows are at stride L; the DP
// runs at width Ldp = min(L, NARROW), and the LMAX 64 instance leaves a
// pair with a longer string to the wide path.
template <int W, int LMAX, int THREADS>
__global__ void __launch_bounds__(THREADS)
dl_lcs_kernel(const int* __restrict__ a, const int* __restrict__ a_len,
              const int* __restrict__ b, const int* __restrict__ b_len,
              int* __restrict__ ld, int* __restrict__ lcs, int P, int L,
              int Ldp) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_state<W, LMAX, THREADS>(smem, Ldp);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  // a length above L is invalid input; clamping keeps every read in the row
  const int al = min(a_len[p], L), bl = min(b_len[p], L);
  if (LMAX > 32 && max(al, bl) > Ldp) return;
  dl_lcs_pair<unsigned char, W, LMAX>(
      a + (size_t)p * L, al, b + (size_t)p * L, bl, Ldp, smem + threadIdx.x,
      THREADS, ld + p, lcs + p);
}

// The frequency maxima: each lane offers its slot's frequency v for query
// qi. A segmented max down the warp over runs of lanes with equal queries
// (slots are query-major, so a run is a query's slots in the warp) leaves
// each run's maximum in its first lane, which alone updates max_freq.
__device__ __forceinline__ void max_freq_update(unsigned long long v, int qi,
                                                unsigned long long* max_freq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(FULL, v, o);
    const int qy = __shfl_down_sync(FULL, qi, o);
    if (lane + o < 32 && qy == qi && y > v) v = y;
  }
  const int qu = __shfl_up_sync(FULL, qi, 1);
  if ((lane == 0 || qu != qi) && v > 0) atomicMax(max_freq + qi, v);
}

// The slot entry's byte path: one thread per slot, the same state and DP
// as dl_lcs_kernel, the strings read from the tables (both stay in L2:
// about 200 KB of queries and 6 MB of candidate rows at the main batch).
// With the epilogue (ScoreIn's weights) it writes the keep flag and the
// compaction's metrics instead of the int32 metrics, and the block's kept
// count; every lane, past P too, takes part in the warp's frequency maxima
// and in the block's count (those past P, and the wide path's slots,
// count 0).
template <int W, int LMAX, int THREADS, typename Ch>
__global__ void __launch_bounds__(THREADS)
dl_lcs_slots_kernel(SlotTables<Ch> t, SlotOut out, ScoreIn in, ScoreOut so,
                    int P, int L, int Ldp) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_state<W, LMAX, THREADS>(smem, Ldp);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool live = p < P;
  const int qi = live ? t.q[p] : -1;
  unsigned long long f = 0;
  bool kept = false;
  if (live) {
    const int ci = t.pc[p];
    const bool v = t.valid[p] != 0;
    const SlotLens n = slot_lens(t, qi, ci, v, L);
    if (LMAX == 32 || max(n.al, n.bl) <= Ldp) {
      const SlotMetrics r = slot_pair<unsigned char, W, LMAX, Ch>(
          qi, ci, n, t.q_norms + (size_t)qi * L,
          t.norms2 + (size_t)ci * 2 * L, Ldp, t, smem + threadIdx.x,
          THREADS);
      f = write_slot(p, P, qi, ci, v, r, t.k_ed[qi], out, in, so, kept);
    }
  }
  if (so.max_freq) max_freq_update(f, qi, so.max_freq);
  if (so.counts) {  // uniform: the whole block reaches the barrier
    const int n = __syncthreads_count(kept);
    if (threadIdx.x == 0) so.counts[blockIdx.x] = n;
  }
}

// The wide path's DP of one pair by the calling warp over its state st
// (Wide<W>::STATE ints): lane k takes band column jstart + k of each row.
// Every lane returns the pair's DL and LCS.
template <int W, typename Ch>
__device__ void wide_pair(const Ch* ap, int al, const Ch* bp, int bl, int L,
                          int* st, int* ld_out, int* lcs_out) {
  using D = Wide<W>;
  const int lane = threadIdx.x & 31;
  const int big = 2 * L + 8;
  for (int k = lane; k < D::BW; k += 32) st[D::R * D::BW + k] = 0;
  __syncwarp();
  int mine = INT_MAX;  // cell (al, bl), in the lane that computes it
  for (int i = 1; i <= al; ++i) {
    const int s = ap[i - 1];
    const int jstart = max(1, i - D::B1), jend = min(L, i + D::B1);
    const int j = jstart + lane;
    const bool in = j <= jend;
    const bool match = in && bp[j - 1] == s;
    const unsigned below = __ballot_sync(FULL, match) & ((1u << lane) - 1);
    const int db = below ? jstart + 31 - __clz(below) : 0;
    // the del chain: nv(k) = k + min(min over m <= k of cand(m) - m,
    // del(jstart - 1) + 1), a prefix minimum over the lanes
    int x = in ? wide_candidate<W>(st, i, j, match, db, L) - lane : INT_MAX;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = min(x, y);
    }
    const int nv = lane + min(x, (jstart == 1 ? i : big) + 1);
    if (in) {
      wide_store<W>(st, i, j, jstart, match, nv);
      if (i == al && j == bl) mine = nv;
    }
    __syncwarp();
  }
  int best = lcs_diagonals(ap, al, bp, bl, lane, 32);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mine = min(mine, __shfl_xor_sync(FULL, mine, o));
    best = max(best, __shfl_xor_sync(FULL, best, o));
  }
  int res = mine == INT_MAX ? big : mine;
  if (al == 0) res = bl;
  if (bl == 0) res = al;
  *ld_out = res;
  *lcs_out = best;
}

constexpr int WIDE_WARPS = 16;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;

// The wide path's launch (either entry): each warp of a block checks a run
// of 32 consecutive slots, a lane a slot (coalesced), and neighbouring runs
// go to neighbouring blocks (run (turn * WIDE_WARPS + warp) * grid +
// block), so a cluster of long pairs (a long query's slots, long queries
// sorted together) spreads over the grid. A turn's wide slots go into a
// list in shared memory (in any order: each writes only its own outputs
// and adds to the maxima and counts atomically), and the block's warps take
// them in turn. `wide(p)` says whether slot p is the wide path's; `run(p,
// st)` does it by the warp.
template <int W, typename IsWide, typename Run>
__device__ __forceinline__ void wide_slots(int P, IsWide wide, Run run) {
  __shared__ int st[WIDE_WARPS][Wide<W>::STATE];
  __shared__ int list[WIDE_THREADS];
  __shared__ int nlist;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long runs = (P + 31) / 32;
  for (long long turn = 0; turn * WIDE_WARPS * gridDim.x < runs; ++turn) {
    if (threadIdx.x == 0) nlist = 0;
    __syncthreads();
    const long long r = (turn * WIDE_WARPS + warp) * gridDim.x + blockIdx.x;
    const long long p = r * 32 + lane;
    if (p < P && wide((int)p)) list[atomicAdd(&nlist, 1)] = (int)p;
    __syncthreads();
    for (int k = warp; k < nlist; k += WIDE_WARPS) run(list[k], st[warp]);
    __syncthreads();
  }
}

template <int W>
__global__ void __launch_bounds__(WIDE_THREADS)
dl_lcs_wide_kernel(const int* __restrict__ a, const int* __restrict__ a_len,
                   const int* __restrict__ b, const int* __restrict__ b_len,
                   int* __restrict__ ld, int* __restrict__ lcs, int P, int L) {
  wide_slots<W>(
      P,
      [&](int p) { return max(min(a_len[p], L), min(b_len[p], L)) > NARROW; },
      [&](int p, int* st) {
        int d, c;
        wide_pair<W, int>(a + (size_t)p * L, min(a_len[p], L),
                          b + (size_t)p * L, min(b_len[p], L), L, st, &d, &c);
        if ((threadIdx.x & 31) == 0) {
          ld[p] = d;
          lcs[p] = c;
        }
        __syncwarp();
      });
}

template <int W, typename Ch>
__global__ void __launch_bounds__(WIDE_THREADS)
dl_lcs_slots_wide_kernel(SlotTables<Ch> t, SlotOut out, ScoreIn in,
                         ScoreOut so, int P, int L) {
  wide_slots<W>(
      P,
      [&](int p) {
        const SlotLens n = slot_lens(t, t.q[p], t.pc[p], t.valid[p] != 0, L);
        return max(n.al, n.bl) > NARROW;
      },
      [&](int p, int* st) {
        const int qi = t.q[p], ci = t.pc[p];
        const bool v = t.valid[p] != 0;
        const SlotLens n = slot_lens(t, qi, ci, v, L);
        const Ch* const ap = t.q_norms + (size_t)qi * L;
        const Ch* const bp = t.norms2 + (size_t)ci * 2 * L;
        SlotMetrics r;
        r.ql = n.ql;
        affixes(ap, n.al, bp, n.bl, r.pf, r.sf);
        r.same_first =
            (t.first_lower[ci] != 0) == (t.q_first_lower[qi] != 0);
        wide_pair<W, Ch>(ap, n.al, bp, n.bl, L, st, &r.ld, &r.lcs);
        if ((threadIdx.x & 31) == 0) {
          bool kept = false;
          const unsigned long long f =
              write_slot(p, P, qi, ci, v, r, t.k_ed[qi], out, in, so, kept);
          if (so.max_freq && f > 0) atomicMax(so.max_freq + qi, f);
          if (so.counts && kept)
            atomicAdd(so.counts + p / slot_threads<NARROW>(), 1);
        }
        __syncwarp();
      });
}

// The wide path's grid: a block per WIDE_WARPS runs of 32 slots, up to
// 1,024 blocks (a few waves of 16 warps a block).
inline unsigned wide_grid(int P) {
  const int blocks = (P + WIDE_THREADS - 1) / WIDE_THREADS;
  return (unsigned)min(max(blocks, 1), 1024);
}

// Above 48 KB a block's dynamic shared memory needs the attribute; it is
// set once per kernel instance and device, for `bytes`, the instance's
// largest.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       unsigned long long& attr_set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (attr_set >> dev & 1)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) attr_set |= 1ull << dev;
  return e;
}

template <int W, int LMAX, int THREADS>
int launch(const int* a, const int* al, const int* b, const int* bl, int* ld,
           int* lcs, int P, int L, cudaStream_t st) {
  static_assert(THREADS % 16 == 0, "rows of whole 16-byte words");
  static unsigned long long attr_set = 0;
  cudaError_t e = allow_smem(dl_lcs_kernel<W, LMAX, THREADS>,
                             (size_t)state_elems<W, LMAX>(LMAX) * THREADS,
                             attr_set);
  if (e != cudaSuccess) return (int)e;
  const int Ldp = min(L, NARROW);
  const size_t smem = (size_t)state_elems<W, LMAX>(Ldp) * THREADS;
  dl_lcs_kernel<W, LMAX, THREADS><<<(P + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      a, al, b, bl, ld, lcs, P, L, Ldp);
  return (int)cudaGetLastError();
}

// The byte path's launch, then above L 64 the wide path's.
template <int W>
int launch_w(const int* a, const int* al, const int* b, const int* bl, int* ld,
             int* lcs, int P, int L, cudaStream_t st) {
  // 128 threads: at L 32, 230 B a thread at W=3 (29 KB a block), 527 B at
  // W=12 (67 KB, three blocks per SM); LMAX 64 takes 64 threads (W=12, L 64:
  // 71 KB)
  const int e = L <= 32 ? launch<W, 32, 128>(a, al, b, bl, ld, lcs, P, L, st)
                        : launch<W, 64, 64>(a, al, b, bl, ld, lcs, P, L, st);
  if (e != 0 || L <= NARROW) return e;
  dl_lcs_wide_kernel<W><<<wide_grid(P), WIDE_THREADS, 0, st>>>(
      a, al, b, bl, ld, lcs, P, L);
  return (int)cudaGetLastError();
}

template <int W, int LMAX, int THREADS, typename Ch>
int launch_slots(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                 ScoreOut so, int P, int L, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  cudaError_t e = allow_smem(dl_lcs_slots_kernel<W, LMAX, THREADS, Ch>,
                             (size_t)state_elems<W, LMAX>(LMAX) * THREADS,
                             attr_set);
  if (e != cudaSuccess) return (int)e;
  const int Ldp = min(L, NARROW);
  const size_t smem = (size_t)state_elems<W, LMAX>(Ldp) * THREADS;
  dl_lcs_slots_kernel<W, LMAX, THREADS, Ch>
      <<<(P + THREADS - 1) / THREADS, THREADS, smem, st>>>(t, out, in, so, P,
                                                          L, Ldp);
  return (int)cudaGetLastError();
}

// The instances of launch_w, then above L 64 the wide path's launch, which
// adds its kept slots to the byte launch's block counts.
template <int W, typename Ch>
int launch_slots_w(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                   ScoreOut so, int P, int L, cudaStream_t st) {
  const int e =
      L <= 32
          ? launch_slots<W, 32, slot_threads<32>(), Ch>(t, out, in, so, P, L,
                                                        st)
          : launch_slots<W, 64, slot_threads<64>(), Ch>(t, out, in, so, P, L,
                                                        st);
  if (e != 0 || L <= NARROW) return e;
  dl_lcs_slots_wide_kernel<W, Ch><<<wide_grid(P), WIDE_THREADS, 0, st>>>(
      t, out, in, so, P, L);
  return (int)cudaGetLastError();
}

template <typename Ch>
int launch_slots_all(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                     ScoreOut so, int P, int L, int W, cudaStream_t st) {
  switch (W) {
    case 3: return launch_slots_w<3, Ch>(t, out, in, so, P, L, st);
    case 6: return launch_slots_w<6, Ch>(t, out, in, so, P, L, st);
    case 12: return launch_slots_w<12, Ch>(t, out, in, so, P, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

template <typename Ch>
SlotTables<Ch> slot_tables(const void* q, const void* pc, const void* valid,
                           const void* norms2, const void* norm_lens,
                           const void* first_lower, const void* q_norms,
                           const void* q_lens, const void* q_first_lower,
                           const void* k_ed) {
  return SlotTables<Ch>{
      (const int*)q, (const int*)pc, (const unsigned char*)valid,
      (const Ch*)norms2, (const int*)norm_lens,
      (const unsigned char*)first_lower, (const Ch*)q_norms,
      (const int*)q_lens, (const unsigned char*)q_first_lower,
      (const int*)k_ed};
}

ScoreIn score_in(const void* pc_band, const void* exact_q, int nb8,
                 const void* use_exact, const void* freqs,
                 const void* weights, const void* thr) {
  return ScoreIn{(const float*)weights, (const float*)thr,
                 (const int*)pc_band, (const unsigned char*)exact_q, nb8,
                 (const unsigned char*)use_exact, (const long long*)freqs};
}

ScoreOut score_out(void* keep, void* met, int L, void* max_freq, void* score,
                   void* counts) {
  return ScoreOut{(unsigned char*)keep, met, met_bytes(L),
                  (unsigned long long*)max_freq, (float*)score, (int*)counts};
}

}  // namespace

#ifndef ANALITICCL_HOST_TEST
namespace {
int slots_entry(const void* q, const void* pc, const void* valid,
                const void* norms2, const void* norm_lens,
                const void* first_lower, const void* q_norms,
                const void* q_lens, const void* q_first_lower,
                const void* k_ed, int elem_bytes, SlotOut out,
                const ScoreIn& in, ScoreOut so, int P, int L, int W,
                void* stream) {
  if (P <= 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return launch_slots_all(
        slot_tables<signed char>(q, pc, valid, norms2, norm_lens, first_lower,
                                 q_norms, q_lens, q_first_lower, k_ed),
        out, in, so, P, L, W, st);
  if (elem_bytes == 4)
    return launch_slots_all(
        slot_tables<int>(q, pc, valid, norms2, norm_lens, first_lower,
                         q_norms, q_lens, q_first_lower, k_ed),
        out, in, so, P, L, W, st);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Each entry launches K2's byte path on `stream` (every pair whose two
// strings are at most 64 long; all of them up to L 64) and, above L 64, the
// wide path after it (the rest): one launch, or two in order.
//
// a, b: int32 [P, L] (PAD_A / PAD_B padded); a_len, b_len: int32 [P];
// ld, lcs: int32 [P] outputs. W in {3, 6, 12}, L >= 1.
extern "C" int analiticcl_dl_lcs(const void* a, const void* a_len,
                                 const void* b, const void* b_len, void* ld,
                                 void* lcs, int P, int L, int W,
                                 void* stream) {
  if (P <= 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto A = (const int*)a, AL = (const int*)a_len, B = (const int*)b,
       BL = (const int*)b_len;
  auto LD = (int*)ld, LCS = (int*)lcs;
  switch (W) {
    case 3: return launch_w<3>(A, AL, B, BL, LD, LCS, P, L, st);
    case 6: return launch_w<6>(A, AL, B, BL, LD, LCS, P, L, st);
    case 12: return launch_w<12>(A, AL, B, BL, LD, LCS, P, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The slot entry's metrics instance. q, pc: int32 [P]; valid: bool [P];
// norms2: [Ni, 2L] and q_norms: [B, L], both int8 (elem_bytes 1) or both
// int32 (4); norm_lens: int32 [Ni]; first_lower: bool [Ni]; q_lens, k_ed:
// int32 [B]; q_first_lower: bool [B]. metrics: int32 [6, P] out (ld, lcs,
// prefix, suffix, query length, edit threshold); same_first: bool [P] out.
// W in {3, 6, 12}, L >= 1.
extern "C" int analiticcl_dl_lcs_slots(
    const void* q, const void* pc, const void* valid, const void* norms2,
    const void* norm_lens, const void* first_lower, const void* q_norms,
    const void* q_lens, const void* q_first_lower, const void* k_ed,
    int elem_bytes, void* metrics, void* same_first, int P, int L, int W,
    void* stream) {
  return slots_entry(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                     q_lens, q_first_lower, k_ed, elem_bytes,
                     SlotOut{(int*)metrics, (unsigned char*)same_first},
                     ScoreIn{}, ScoreOut{}, P, L, W, stream);
}

// The slot entry with the scoring epilogue, the main path's: the inputs of
// analiticcl_dl_lcs_slots, then pc_band: int32 [P]; exact_q: uint8
// [B, nb8]; use_exact: bool [B] or null; freqs: int64 [Ni] or null;
// weights: float32 [6]; thr: float32 [1]. keep: bool [P] out; met: [5, P]
// out (ld, lcs, prefix, suffix, case flag, gated), uint8 below L 256 and
// int32 from it; max_freq: int64 [B] in/out, zeros in (null with freqs);
// score: float32 [P] out or null; counts: int32 [ceil(P / T)] out, the kept
// slots of each block of T = 128 slots (64 above L 32), or null: the byte
// launch stores them, the wide launch adds its slots to them.
extern "C" int analiticcl_dl_lcs_slots_scored(
    const void* q, const void* pc, const void* valid, const void* norms2,
    const void* norm_lens, const void* first_lower, const void* q_norms,
    const void* q_lens, const void* q_first_lower, const void* k_ed,
    int elem_bytes, const void* pc_band, const void* exact_q, int nb8,
    const void* use_exact, const void* freqs, const void* weights,
    const void* thr, void* keep, void* met, void* max_freq, void* score,
    void* counts, int P, int L, int W, void* stream) {
  if (!weights || !thr || !keep || !met || !pc_band || !exact_q ||
      (freqs == nullptr) != (max_freq == nullptr))
    return (int)cudaErrorInvalidValue;
  return slots_entry(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                     q_lens, q_first_lower, k_ed, elem_bytes, SlotOut{},
                     score_in(pc_band, exact_q, nb8, use_exact, freqs,
                              weights, thr),
                     score_out(keep, met, L, max_freq, score, counts), P, L,
                     W, stream);
}
#else
namespace {
// The wide path's warp on the host: each row's lanes walked in order (the
// ballot a bit mask, the prefix minimum a running one), then their stores.
template <int W, typename Ch>
void wide_pair_host(const Ch* ap, int al, const Ch* bp, int bl, int L,
                    int* st, int* ld_out, int* lcs_out) {
  using D = Wide<W>;
  const int big = 2 * L + 8;
  for (int k = 0; k < D::BW; ++k) st[D::R * D::BW + k] = 0;
  int res = big;
  for (int i = 1; i <= al; ++i) {
    const int s = ap[i - 1];
    const int jstart = max(1, i - D::B1), jend = min(L, i + D::B1);
    const int n = jend - jstart + 1;
    bool match[32];
    unsigned bits = 0;
    for (int lane = 0; lane < n; ++lane) {
      match[lane] = bp[jstart + lane - 1] == s;
      bits |= (unsigned)match[lane] << lane;
    }
    int nv[32], x = 1 << 30;
    for (int lane = 0; lane < n; ++lane) {
      const unsigned below = bits & ((1u << lane) - 1);
      const int db = below ? jstart + 31 - __builtin_clz(below) : 0;
      x = min(x, wide_candidate<W>(st, i, jstart + lane, match[lane], db, L) -
                     lane);
      nv[lane] = lane + min(x, (jstart == 1 ? i : big) + 1);
    }
    for (int lane = 0; lane < n; ++lane) {
      const int j = jstart + lane;
      wide_store<W>(st, i, j, jstart, match[lane], nv[lane]);
      if (i == al && j == bl) res = nv[lane];
    }
  }
  if (al == 0) res = bl;
  if (bl == 0) res = al;
  int best = 0;
  for (int lane = 0; lane < 32; ++lane)
    best = max(best, lcs_diagonals(ap, al, bp, bl, lane, 32));
  *ld_out = res;
  *lcs_out = best;
}

// The kernels' instances on the host, one pair at a time over state of
// stride 1: LMAX 32 (LCS row in registers) up to L 32, else LMAX 64 at DP
// width min(L, 64), and a pair with a longer string on the wide path.
template <typename Cell, int W, int LMAX>
void host_pairs(const int* a, const int* a_len, const int* b, const int* b_len,
                int* ld, int* lcs, int P, int L) {
  const int Ldp = min(L, NARROW);
  std::vector<Cell> st(state_elems<W, LMAX>(Ldp));
  std::vector<int> wide(Wide<W>::STATE);
  for (int p = 0; p < P; ++p) {
    const int al = min(a_len[p], L), bl = min(b_len[p], L);
    const int* ap = a + (size_t)p * L;
    const int* bp = b + (size_t)p * L;
    if (max(al, bl) > Ldp) {
      wide_pair_host<W>(ap, al, bp, bl, L, wide.data(), ld + p, lcs + p);
      continue;
    }
    for (size_t k = 0; k < st.size(); ++k)
      st[k] = Cell(state_init<W>((int)k, Ldp));
    dl_lcs_pair<Cell, W, LMAX>(ap, al, bp, bl, Ldp, st.data(), 1, ld + p,
                               lcs + p);
  }
}

template <typename Cell, int W>
void host_w(const int* a, const int* a_len, const int* b, const int* b_len,
            int* ld, int* lcs, int P, int L) {
  if (L <= 32) host_pairs<Cell, W, 32>(a, a_len, b, b_len, ld, lcs, P, L);
  else host_pairs<Cell, W, 64>(a, a_len, b, b_len, ld, lcs, P, L);
}

template <typename Cell>
void host_all(const int* a, const int* a_len, const int* b, const int* b_len,
              int* ld, int* lcs, int P, int L, int W) {
  if (L < 1) return;
  if (W == 3) host_w<Cell, 3>(a, a_len, b, b_len, ld, lcs, P, L);
  if (W == 6) host_w<Cell, 6>(a, a_len, b, b_len, ld, lcs, P, L);
  if (W == 12) host_w<Cell, 12>(a, a_len, b, b_len, ld, lcs, P, L);
}
}  // namespace

// the kernel's byte cells (and the wide path's int cells)
extern "C" void analiticcl_dl_lcs_host(const int* a, const int* a_len,
                                       const int* b, const int* b_len, int* ld,
                                       int* lcs, int P, int L, int W) {
  host_all<unsigned char>(a, a_len, b, b_len, ld, lcs, P, L, W);
}

namespace {
// The slot entry's per-slot work on the host, one slot at a time: the byte
// path over cells of stride 1, the wide path's warp walked lane by lane;
// the loads, affixes, DP and outputs; the frequency maxima a plain max per
// slot, the blocks' kept counts a plain sum.
template <typename Ch, int W, int LMAX>
void host_slots_pairs(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                      ScoreOut so, int P, int L) {
  const int Ldp = min(L, NARROW);
  std::vector<unsigned char> st(state_elems<W, LMAX>(Ldp));
  std::vector<int> wide(Wide<W>::STATE);
  constexpr int THREADS = slot_threads<LMAX>();
  if (so.counts)
    for (int b = 0; b < (P + THREADS - 1) / THREADS; ++b) so.counts[b] = 0;
  for (int p = 0; p < P; ++p) {
    const int qi = t.q[p], ci = t.pc[p];
    const bool v = t.valid[p] != 0;
    const SlotLens n = slot_lens(t, qi, ci, v, L);
    const Ch* const ap = t.q_norms + (size_t)qi * L;
    const Ch* const bp = t.norms2 + (size_t)ci * 2 * L;
    SlotMetrics r;
    if (max(n.al, n.bl) > Ldp) {
      r.ql = n.ql;
      affixes(ap, n.al, bp, n.bl, r.pf, r.sf);
      r.same_first = (t.first_lower[ci] != 0) == (t.q_first_lower[qi] != 0);
      wide_pair_host<W>(ap, n.al, bp, n.bl, L, wide.data(), &r.ld, &r.lcs);
    } else {
      for (size_t k = 0; k < st.size(); ++k)
        st[k] = (unsigned char)state_init<W>((int)k, Ldp);
      r = slot_pair<unsigned char, W, LMAX, Ch>(qi, ci, n, ap, bp, Ldp, t,
                                                st.data(), 1);
    }
    bool kept = false;
    const unsigned long long f =
        write_slot(p, P, qi, ci, v, r, t.k_ed[qi], out, in, so, kept);
    if (so.max_freq && f > so.max_freq[qi]) so.max_freq[qi] = f;
    if (so.counts) so.counts[p / THREADS] += kept;
  }
}

template <typename Ch, int W>
void host_slots_w(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                  ScoreOut so, int P, int L) {
  if (L <= 32) host_slots_pairs<Ch, W, 32>(t, out, in, so, P, L);
  else host_slots_pairs<Ch, W, 64>(t, out, in, so, P, L);
}

template <typename Ch>
void host_slots(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                ScoreOut so, int P, int L, int W) {
  if (L < 1) return;
  if (W == 3) host_slots_w<Ch, 3>(t, out, in, so, P, L);
  if (W == 6) host_slots_w<Ch, 6>(t, out, in, so, P, L);
  if (W == 12) host_slots_w<Ch, 12>(t, out, in, so, P, L);
}

void host_slots_any(const void* q, const void* pc, const void* valid,
                    const void* norms2, const void* norm_lens,
                    const void* first_lower, const void* q_norms,
                    const void* q_lens, const void* q_first_lower,
                    const void* k_ed, int elem_bytes, SlotOut out,
                    const ScoreIn& in, ScoreOut so, int P, int L, int W) {
  if (elem_bytes == 1)
    host_slots(slot_tables<signed char>(q, pc, valid, norms2, norm_lens,
                                        first_lower, q_norms, q_lens,
                                        q_first_lower, k_ed),
               out, in, so, P, L, W);
  if (elem_bytes == 4)
    host_slots(slot_tables<int>(q, pc, valid, norms2, norm_lens, first_lower,
                                q_norms, q_lens, q_first_lower, k_ed),
               out, in, so, P, L, W);
}
}  // namespace

// the slot entry's metrics instance on the host (both paths), arguments as
// analiticcl_dl_lcs_slots's
extern "C" void analiticcl_dl_lcs_slots_host(
    const void* q, const void* pc, const void* valid, const void* norms2,
    const void* norm_lens, const void* first_lower, const void* q_norms,
    const void* q_lens, const void* q_first_lower, const void* k_ed,
    int elem_bytes, void* metrics, void* same_first, int P, int L, int W) {
  host_slots_any(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                 q_lens, q_first_lower, k_ed, elem_bytes,
                 SlotOut{(int*)metrics, (unsigned char*)same_first},
                 ScoreIn{}, ScoreOut{}, P, L, W);
}

// the slot entry with the scoring epilogue on the host (both paths),
// arguments as analiticcl_dl_lcs_slots_scored's
extern "C" void analiticcl_dl_lcs_slots_scored_host(
    const void* q, const void* pc, const void* valid, const void* norms2,
    const void* norm_lens, const void* first_lower, const void* q_norms,
    const void* q_lens, const void* q_first_lower, const void* k_ed,
    int elem_bytes, const void* pc_band, const void* exact_q, int nb8,
    const void* use_exact, const void* freqs, const void* weights,
    const void* thr, void* keep, void* met, void* max_freq, void* score,
    void* counts, int P, int L, int W) {
  host_slots_any(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                 q_lens, q_first_lower, k_ed, elem_bytes, SlotOut{},
                 score_in(pc_band, exact_q, nb8, use_exact, freqs, weights,
                          thr),
                 score_out(keep, met, L, max_freq, score, counts), P, L, W);
}

// the same DP on int cells
extern "C" void analiticcl_dl_lcs_host_int(const int* a, const int* a_len,
                                           const int* b, const int* b_len,
                                           int* ld, int* lcs, int P, int L,
                                           int W) {
  host_all<int>(a, a_len, b, b_len, ld, lcs, P, L, W);
}
#endif
