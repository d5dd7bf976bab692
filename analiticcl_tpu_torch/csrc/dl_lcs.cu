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
// the wide path, a second launch over the same slots. The byte launch
// puts those pairs on a work list (one atomicAdd a warp); the wide
// launch's warps take them from it (a block-free counter: a cluster of
// long pairs, a long query's slots, spreads over every warp of the card,
// and a batch without one costs the launch), one warp a pair, or while
// the list outnumbers the warps and W <= 6, two: each half warp walks one
// pair's band (at most 15 columns), which halves the band's instructions
// a pair where throughput, not one pair's latency, sets the launch's time.
//
// The band DP (exact up to W, the byte DP's cells bit for bit above it):
// lane k holds band column js + k of a row (the band's 2W + 3 columns fit
// a warp up to W 14) and its column's cell of the row before and its last
// match in registers, taken from the lane to its right when the band
// moves right (one shuffle each; the rows whose band lies inside [2, L]
// run a form without the edge tests). The del chain along a row is a warp
// prefix minimum, the last match left of a column a ballot. The
// transposition's lookback reads the last W + 1 rows' bands from a ring
// in shared memory indexed by row and column masks (a column outside a
// row's band is its margin, big). A pair whose lengths differ by more
// than W + 1 never reaches cell (al, bl) in its band: its DL is big, as
// the walk gives it, and the band is not walked.
//
// The LCS (not banded: the longest run of matches along a diagonal) runs
// row by row on the whole warp: each column holds its diagonal's current
// run, packed 4 to a 32-bit word as bytes (at most 255 columns, so a run
// fits) or 2 as 16-bit halves (up to 512); each lane holds up to 8 words
// of the columns' characters and runs in registers. A row is a funnel
// shift of the runs by one column, plus one where the character equals
// the row's (a zero-field test against the character broadcast to every
// field), and a run grows by one a row, so best grows only through best +
// 1: one zero-field test of best + 1 - run and one vote a row keep it
// exact without a per-cell maximum, about 2.5 instructions a cell. Where
// the band is walked the LCS shares its rows (b's characters the columns)
// and its chains overlap the band's (in a half warp's rows too, for bytes);
// otherwise the shorter string gives the columns. Strings of more than 512
// characters both, or int32 characters over 255, take the lanes'
// diagonals instead (lcs_diagonals).
// A wide pair's outputs and its keep test are the same functions as the
// byte path's; its frequency maximum and its block's kept count are one
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
#include <cstdlib>
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
  static constexpr int B1 = W + 1;       // band half-width
  static constexpr int BW = 2 * B1 + 1;  // band columns of a row
  // The rows' band history for the transposition's lookback: RP rows (a
  // power of two above W + 1, so a row is written while the W before it
  // are read) of CP band columns (a power of two >= BW), row r at slot
  // r & (RP - 1), column c at c & (CP - 1).
  static constexpr int RP = W + 2 <= 8 ? 8 : 16;
  static constexpr int CP = BW <= 16 ? 16 : 32;
  static constexpr int RING = RP * CP;
  static constexpr int SPAN = CP;  // lanes of the del chain's prefix minimum
  static_assert(BW <= 32, "a row's band fits in a warp");
  static_assert(RP >= W + 2 && CP >= BW, "the ring holds the lookback");
};

// Cell (r, c) of the DP, 0 <= c <= L, as the full-width DP holds it when a
// later row reads it: row 0 is big, row 1 is 0..L, column 0 of row r is
// r - 1; from row 2 on, columns inside the row's band are stored (ring
// slot (r & (RP - 1), c & (CP - 1))) and those outside it are its margins,
// big. Row r is written while the band walks row r - 1 of a.
template <int W>
HDFN int ring_cell(const int* ring, int r, int c, int L) {
  using D = Wide<W>;
  if (r == 0) return 2 * L + 8;
  if (r == 1) return c;
  if (c == 0) return r - 1;
  if (c < max(1, r - 1 - D::B1) || c > min(L, r - 1 + D::B1)) return 2 * L + 8;
  return ring[(r & (D::RP - 1)) * D::CP + (c & (D::CP - 1))];
}

// Band column j of the row written at step i (cell (i + 1, j)) before the
// del chain: min(sub, ins, transp), the byte DP's terms, from the cells
// up-left and up (upl, up), the row of column j's last match before this
// one (last < i, 0 for none) and db, the last column left of j in this
// row's band with a match (0 for none); transp is big unless its tests
// pass. Those tests, the byte DP's (d = i - last in [1, min(W, i)], and
// db >= j - min(W, j - 1) >= 1), reduce here to last >= i - W and db >=
// max(1, j - W), since last < i and db < j.
template <int W>
HDFN int band_candidate(const int* ring, int i, int j, int up, int upl,
                        bool match, int last, int db, int L) {
  const int sub = upl + (match ? 0 : 1);
  const int ins = up + 1;
  int transp = 2 * L + 8;
  if (last >= i - W && db >= max(1, j - W))
    transp = min(transp, ring_cell<W>(ring, last, db - 1, L) + i - last - 1 +
                             j - db);
  return min(min(sub, ins), transp);
}

// The longest run of matches along the diagonals first, first + step, ...
// (offset j - i from -(al - 1) to bl - 1): the LCS, over every lane's
// diagonals. Four steps of a diagonal are loaded at once; a diagonal, or
// its rest, that cannot beat the best (even continuing the current run)
// is skipped. The LCS of the pairs the packed rows do not take.
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

// The packed LCS rows. The columns are one string's characters (b's where
// the band is walked, else the shorter string's), the rows the other's;
// each column holds the length of the run of matches along its diagonal
// ending at the current row, at most the number of columns. While the
// columns number at most 255 a run fits a byte and a 32-bit word packs 4
// columns, up to 512 a 16-bit half and 2; each lane of the warp holds
// `lcs_words` consecutive words of the columns' characters (a field
// each), of their valid-column mask and of the runs, in registers.
HDFN int lcs_words(int nc) {  // words a lane; 0: the diagonals take it
  return nc <= 128 ? 1 : nc <= 255 ? 2 : nc <= 256 ? 4 : nc <= 384 ? 6
         : nc <= 512 ? 8 : 0;
}

// Each field of x set to all ones where its top bit is set, else zero:
// one PRMT with the sign-replicating selector.
template <bool HALF>
HDFN unsigned sign_fields(unsigned x) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(r)
      : "r"(x), "r"(HALF ? 0xBB99u : 0xBA98u));
  return r;
#else
  unsigned r = 0;
  for (int f = 0; f < (HALF ? 2 : 4); ++f) {
    const int bits = HALF ? 16 : 8;
    if (x >> (bits * (f + 1) - 1) & 1) r |= ((1u << bits) - 1) << (bits * f);
  }
  return r;
#endif
}

// The high 32 bits of (hi:lo) << n, 0 < n < 32.
HDFN unsigned funnel_l(unsigned lo, unsigned hi, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, n);
#else
  return (hi << n) | (lo >> (32 - n));
#endif
}

// One word of a row: the new runs of its fields from the old runs one
// column to the left (the word's own shifted up a field, and the top
// field of the word to its left, `left`), plus one where the column's
// character equals the row's (`a`, in every field), zero elsewhere and in
// invalid columns (`vm` zero). Every old run is at most best, so a new run
// is at most best + 1: `acc` gains a field's top bit where one equals it
// (bp1: best + 1 in every field), by the zero-field test of bp1 - run.
template <bool HALF>
HDFN unsigned lcs_word(unsigned ch, unsigned vm, unsigned a, unsigned old,
                       unsigned left, unsigned bp1, unsigned& acc) {
  constexpr unsigned ONE = HALF ? 0x00010001u : 0x01010101u;
  const unsigned x = ch ^ a;
  // top bit of a field set where the characters differ: characters fill a
  // half's low byte, so x + 0x7fff carries into bit 15; a byte's own seven
  // low bits first, then its top bit
  const unsigned miss = HALF ? sign_fields<true>(x + 0x7FFF7FFFu)
                             : sign_fields<false>(
                                   ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
  const unsigned run = (funnel_l(left, old, HALF ? 16 : 8) + ONE) & ~miss & vm;
  const unsigned w = bp1 - run;
  acc |= (w - ONE) & ~w;
  return run;
}

// Word `word` of the columns: their characters, a field each, and the
// valid-column mask (all ones in a column below nc).
template <bool HALF, typename Ch>
HDFN void lcs_pack(const Ch* cp, int nc, int word, unsigned& ch,
                   unsigned& vm) {
  constexpr int PER = HALF ? 2 : 4, BITS = 32 / PER;
  ch = vm = 0;
  for (int u = 0; u < PER; ++u) {
    const int c = word * PER + u;
    if (c < nc) {
      ch |= (unsigned)(unsigned char)cp[c] << (BITS * u);
      vm |= ((1u << BITS) - 1) << (BITS * u);
    }
  }
}

// Whether every character of s[0, n) packs into a byte as it is (always
// for int8 tables, whose characters are taken as unsigned bytes).
template <typename Ch>
HDFN bool byte_chars(const Ch* s, int n, int first, int step) {
  if (sizeof(Ch) == 1) return true;
  bool ok = true;
  for (int k = first; k < n; k += step) ok &= (unsigned)s[k] <= 255u;
  return ok;
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

// The wide path's work list: the byte launch appends each pair it leaves
// to the wide path (one atomicAdd a warp), the wide launch's warps take
// them one at a time, and its last block resets the counters for the next
// call on the stream. ctr: [0] pairs listed, [1] taken, [2] blocks done;
// zero before the byte launch.
struct WorkList {
  int* items;  // [P]
  int* ctr;    // [3]
};

// Every lane of the warp calls it; slot p goes on the list if `wide`.
__device__ __forceinline__ void list_append(WorkList wl, bool wide, int p) {
  const unsigned m = __ballot_sync(FULL, wide);
  if (!m) return;
  const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
  int base = 0;
  if (lane == lead) base = atomicAdd(wl.ctr, __popc(m));
  base = __shfl_sync(FULL, base, lead);
  if (wide) wl.items[base + __popc(m & ((1u << lane) - 1))] = p;
}

// The byte path of the pair-string entry. Rows are at stride L; the DP
// runs at width Ldp = min(L, NARROW), and the LMAX 64 instance leaves a
// pair with a longer string to the wide path, on its work list.
template <int W, int LMAX, int THREADS>
__global__ void __launch_bounds__(THREADS)
dl_lcs_kernel(const int* __restrict__ a, const int* __restrict__ a_len,
              const int* __restrict__ b, const int* __restrict__ b_len,
              int* __restrict__ ld, int* __restrict__ lcs, int P, int L,
              int Ldp, WorkList wl) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_state<W, LMAX, THREADS>(smem, Ldp);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if constexpr (LMAX > 32) {  // above L 64: list the wide path's pairs
    if (wl.items)
      list_append(wl, p < P && max(min(a_len[p], L), min(b_len[p], L)) > Ldp,
                  p);
  }
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
// count 0), and above L 64 in listing the wide path's slots.
template <int W, int LMAX, int THREADS, typename Ch>
__global__ void __launch_bounds__(THREADS)
dl_lcs_slots_kernel(SlotTables<Ch> t, SlotOut out, ScoreIn in, ScoreOut so,
                    int P, int L, int Ldp, WorkList wl) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_state<W, LMAX, THREADS>(smem, Ldp);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool live = p < P;
  const int qi = live ? t.q[p] : -1;
  unsigned long long f = 0;
  bool kept = false, wide = false;
  if (live) {
    const int ci = t.pc[p];
    const bool v = t.valid[p] != 0;
    const SlotLens n = slot_lens(t, qi, ci, v, L);
    wide = LMAX > 32 && max(n.al, n.bl) > Ldp;
    if (!wide) {
      const SlotMetrics r = slot_pair<unsigned char, W, LMAX, Ch>(
          qi, ci, n, t.q_norms + (size_t)qi * L,
          t.norms2 + (size_t)ci * 2 * L, Ldp, t, smem + threadIdx.x,
          THREADS);
      f = write_slot(p, P, qi, ci, v, r, t.k_ed[qi], out, in, so, kept);
    }
  }
  if constexpr (LMAX > 32) {
    if (wl.items) list_append(wl, wide, p);
  }
  if (so.max_freq) max_freq_update(f, qi, so.max_freq);
  if (so.counts) {  // uniform: the whole block reaches the barrier
    const int n = __syncthreads_count(kept);
    if (threadIdx.x == 0) so.counts[blockIdx.x] = n;
  }
}

// ---- The wide path on the card ----

// One packed LCS row of the calling segment of SEG lanes (lcs_word on
// each of the lane's NW words): the row's character `a` in every field,
// best + 1 in bp1. The word left of a lane's first is its left
// neighbour's last (one shuffle; none for the segment's lane 0). Every
// lane of the warp calls it; returns whether a run of the lane's segment
// reached best + 1.
template <int NW, bool HALF, int SEG = 32>
__device__ __forceinline__ bool lcs_row(const unsigned (&ch)[NW],
                                        const unsigned (&vm)[NW],
                                        unsigned (&run)[NW], unsigned a,
                                        unsigned bp1) {
  constexpr unsigned TOP = HALF ? 0x80008000u : 0x80808080u;
  const int lane = threadIdx.x & (SEG - 1);
  unsigned left = __shfl_up_sync(FULL, run[NW - 1], 1, SEG);
  if (lane == 0) left = 0;
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const unsigned old = run[k];
    run[k] = lcs_word<HALF>(ch[k], vm[k], a, old, left, bp1, acc);
    left = old;
  }
  if (SEG == 32) return __any_sync(FULL, acc & TOP);
  return (__ballot_sync(FULL, acc & TOP) >> (threadIdx.x & 16) & 0xFFFFu) != 0;
}

// The packed LCS rows (lcs_word) of nr rows of rp against nc >= 1 columns
// of cp, lane k holding words k NW .. k NW + NW - 1 of the columns'
// characters, valid-column mask and runs in registers. A row's new runs
// are its words shifted up a field plus one where the characters match;
// best rises by one in a row where a run reaches best + 1, which the
// zero-field test finds without a per-cell maximum. At best = nc no run
// can pass it: the rows stop there (and a byte's best + 1 stays <= 255).
template <int NW, bool HALF, typename Ch>
__device__ __forceinline__ int lcs_rows(const Ch* rp, int nr, const Ch* cp,
                                        int nc) {
  constexpr unsigned ONE = HALF ? 0x00010001u : 0x01010101u;
  const int lane = threadIdx.x & 31;
  unsigned ch[NW], vm[NW], run[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    lcs_pack<HALF>(cp, nc, lane * NW + k, ch[k], vm[k]);
    run[k] = 0;
  }
  int best = 0;
  unsigned a_next = (unsigned char)rp[0];
  for (int i = 0; i < nr && best < nc; ++i) {
    const unsigned a = a_next * ONE;
    if (i + 1 < nr) a_next = (unsigned char)rp[i + 1];
    best += lcs_row<NW, HALF>(ch, vm, run, a, (best + 1) * ONE);
  }
  return best;
}

// The band walk's registers: the lane's column's cell of the row before
// and its last match, the row before's band [pjs, pje], the cell written
// last, and the next row's characters.
struct BandRow {
  int prev, last, pjs, pje, nv, a_next, b_next;
};

// Step i of the band walk: row i + 1 of the DP, lane k of the calling
// segment of SEG lanes (the warp, or a half warp walking a pair of its own
// while W <= 6) its band column js + k. STEADY: a row whose band lies
// inside [2, L] and started one column further right than the one before
// (i in [W + 3, L - W - 1]), where the lane's column's neighbours and the
// entering column are the same lanes every row; the other rows take the
// general tests. Returns the row's character.
template <int W, bool STEADY, int SEG, typename Ch>
__device__ __forceinline__ int band_step(const Ch* ap, int al, const Ch* bp,
                                         int L, int* ring, int i,
                                         BandRow& r) {
  using D = Wide<W>;
  const int lane = threadIdx.x & (SEG - 1);
  const int big = 2 * L + 8;
  const int ach = r.a_next, bch = r.b_next;
  const int js = STEADY ? i - D::B1 : max(1, i - D::B1);
  const int je = STEADY ? i + D::B1 : min(L, i + D::B1);
  const int j = js + lane;
  const bool in = STEADY ? lane < D::BW : j <= je;
  if (i < al) {  // the next row's characters, off the chain
    r.a_next = ap[i];
    const int jn = max(1, i + 1 - D::B1) + lane;
    r.b_next = jn <= min(L, i + 1 + D::B1) ? bp[jn - 1] : 0;
  }
  const bool match = in && bch == ach;
  const unsigned seg_bits =
      __ballot_sync(FULL, match) >> (threadIdx.x & ~(SEG - 1) & 31);
  const unsigned left = seg_bits & ((1u << lane) - 1);
  const int db = left ? js + 31 - __clz(left) : 0;
  // the row before's cells of columns j and j - 1: the lane's own and its
  // right neighbour's when the band moved right (s = 1), else its left
  // neighbour's and its own; a column past the row before's band is its
  // margin, column 0 of row i is i - 1, a column entering the band has no
  // match yet
  int up, upl, lastc;
  if (STEADY) {
    const int nb = __shfl_down_sync(FULL, r.prev, 1, SEG);
    const int lnb = __shfl_down_sync(FULL, r.last, 1, SEG);
    const bool enter = lane == D::BW - 1;
    up = enter ? big : nb;
    upl = r.prev;
    lastc = enter ? 0 : lnb;
  } else {
    const int s = js - r.pjs;  // 0 or 1
    const int nb = __shfl_sync(FULL, r.prev, s ? lane + 1 : lane - 1, SEG);
    const int last_v = __shfl_sync(FULL, r.last, lane + s, SEG);
    up = j > r.pje ? big : s ? nb : r.prev;
    upl = j == 1 ? i - 1 : s ? r.prev : nb;
    lastc = j == i + D::B1 ? 0 : last_v;
  }
  int x = in ? band_candidate<W>(ring, i, j, up, upl, match, lastc, db, L) -
                   lane
             : INT_MAX;
#pragma unroll
  for (int o = 1; o < D::SPAN; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o, SEG);
    if (lane >= o) x = min(x, y);
  }
  r.nv = lane + min(x, (!STEADY && js == 1 ? i : big) + 1);
  if (in) ring[((i + 1) & (D::RP - 1)) * D::CP + (j & (D::CP - 1))] = r.nv;
  r.prev = r.nv;
  r.last = match ? i : lastc;
  r.pjs = js;
  r.pje = je;
  return ach;
}

// The band DP of one pair with al, bl >= 1 and |al - bl| <= W + 1 by the
// calling warp (band_step, row by row), and with NW > 0 its LCS in the
// same rows (lcs_row; the columns b's characters: bl <= 255 as bytes in
// NW 1 or 2 words a lane, up to 512 as 16-bit halves in 4 to 8), so each
// row's two chains overlap and share its loads. The rows go to the ring
// for the transposition's lookback. Every lane returns DL (cell (al + 1,
// bl)) in ld and, with NW > 0, the LCS in lcs.
template <int W, int NW, bool HALF, typename Ch>
__device__ __forceinline__ void wide_rows(const Ch* ap, int al, const Ch* bp,
                                          int bl, int L, int* ring, int& ld,
                                          int& lcs) {
  using D = Wide<W>;
  constexpr unsigned ONE = HALF ? 0x00010001u : 0x01010101u;
  constexpr int NWL = NW > 0 ? NW : 1;
  const int lane = threadIdx.x & 31;
  unsigned ch[NWL], vm[NWL], run[NWL];
  if (NW > 0) {
#pragma unroll
    for (int k = 0; k < NWL; ++k) {
      lcs_pack<HALF>(bp, bl, lane * NWL + k, ch[k], vm[k]);
      run[k] = 0;
    }
  }
  int best = 0;
  // row 1: cell (1, c) = c, column c at lane c - 1; its band every column
  BandRow r{lane + 1, 0, 1, L, 0, ap[0], lane <= D::B1 ? bp[lane] : 0};
  auto lcs_step = [&](int ach) {  // the LCS row, independent of the band's
    if (NW > 0 && best < bl)
      best += lcs_row<NWL, HALF>(ch, vm, run,
                                 (unsigned)(unsigned char)ach * ONE,
                                 (best + 1) * ONE);
    __syncwarp();
  };
  const int steady0 = D::B1 + 2, steady1 = min(al, L - D::B1);
  int i = 1;
  for (; i <= al && i < steady0; ++i)
    lcs_step(band_step<W, false, 32>(ap, al, bp, L, ring, i, r));
  for (; i <= steady1; ++i)
    lcs_step(band_step<W, true, 32>(ap, al, bp, L, ring, i, r));
  for (; i <= al; ++i)
    lcs_step(band_step<W, false, 32>(ap, al, bp, L, ring, i, r));
  ld = __shfl_sync(FULL, r.nv, bl - r.pjs);
  lcs = best;
}

// The band DP of two pairs at once, while W <= 6 (a band of at most 15
// columns): each half warp walks its own pair (band_step on 16 lanes),
// both for as many rows as the longer needs; a half whose pair walks no
// band (band false) idles through them. With NW > 0 a half whose pair has
// lcs_on (b's characters packed as bytes, bl <= 255: NW 2 or 4 words a
// lane of the half) also takes its LCS in the same rows (lcs_row on 16
// lanes); the other half runs the same instructions on masked columns and
// keeps nothing. Each lane of a half returns its pair's DL (cell (al + 1,
// bl)) in ld where band, else 0, and its LCS in lcs where lcs_on.
template <int W, int NW, typename Ch>
__device__ void wide_rows2(const Ch* ap, int al, const Ch* bp, int bl, int L,
                           int* ring, bool band, bool lcs_on, int& ld,
                           int& lcs) {
  using D = Wide<W>;
  if constexpr (D::SPAN > 16) {
    return;  // a half warp does not hold the band: take_list never calls
  } else {
    constexpr int NWL = NW > 0 ? NW : 1;
    const int lane = threadIdx.x & 15;
    const int rows = band ? al : 0;
    const int all = max(rows, __shfl_xor_sync(FULL, rows, 16));
    unsigned ch[NWL], vm[NWL], run[NWL];
    if (NW > 0) {
#pragma unroll
      for (int k = 0; k < NWL; ++k) {
        ch[k] = vm[k] = run[k] = 0;
        if (lcs_on) lcs_pack<false>(bp, bl, lane * NWL + k, ch[k], vm[k]);
      }
    }
    int best = 0;
    BandRow r{lane + 1, 0, 1, L, 0, rows ? ap[0] : 0,
              rows && lane <= D::B1 ? bp[lane] : 0};
    int cell = 0;  // cell (al + 1, bl), in the lane that writes it
    auto step = [&](int i, int ach) {
      if (i == rows && max(1, i - D::B1) + lane == bl) cell = r.nv;
      if (NW > 0) {
        const bool hit = lcs_row<NWL, false, 16>(
            ch, vm, run, (unsigned)(unsigned char)ach * 0x01010101u,
            (unsigned)(best + 1) * 0x01010101u);
        best += hit && lcs_on && i <= rows && best < bl;
      }
      __syncwarp();
    };
    const int steady0 = D::B1 + 2, steady1 = min(all, L - D::B1);
    int i = 1;
    for (; i <= all && i < steady0; ++i)
      step(i, band_step<W, false, 16>(ap, rows, bp, L, ring, i, r));
    for (; i <= steady1; ++i)
      step(i, band_step<W, true, 16>(ap, rows, bp, L, ring, i, r));
    for (; i <= all; ++i)
      step(i, band_step<W, false, 16>(ap, rows, bp, L, ring, i, r));
    ld = __shfl_sync(FULL, cell, rows ? bl - max(1, rows - D::B1) : 0, 16);
    lcs = best;
  }
}

// The LCS of a[0, al) and b[0, bl) by the calling warp; every lane returns
// it. The shorter string gives the columns (the LCS is symmetric): up to
// 512 of them, of characters that pack into bytes, take the packed rows;
// the rest (both strings over 512, or an int32 character over 255) the
// lanes' diagonals.
template <typename Ch>
__device__ __noinline__ int wide_lcs(const Ch* ap, int al, const Ch* bp,
                                     int bl) {
  const int lane = threadIdx.x & 31;
  const bool rows_a = al >= bl;
  const Ch* const rp = rows_a ? ap : bp;
  const Ch* const cp = rows_a ? bp : ap;
  const int nr = rows_a ? al : bl, nc = rows_a ? bl : al;
  if (nc == 0) return 0;
  const int nw = lcs_words(nc);
  const bool packed =
      nw > 0 && __all_sync(FULL, byte_chars(rp, nr, lane, 32) &&
                                     byte_chars(cp, nc, lane, 32));
  if (packed) {
    switch (nw) {
      case 1: return lcs_rows<1, false>(rp, nr, cp, nc);
      case 2: return lcs_rows<2, false>(rp, nr, cp, nc);
      case 4: return lcs_rows<4, true>(rp, nr, cp, nc);
      case 6: return lcs_rows<6, true>(rp, nr, cp, nc);
      default: return lcs_rows<8, true>(rp, nr, cp, nc);
    }
  }
  int best = lcs_diagonals(ap, al, bp, bl, lane, 32);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, o));
  return best;
}

// affixes() by the calling warp, 32 positions a step: the common prefix
// is the first position whose characters differ (a ballot), the suffix
// likewise from the ends. Every lane returns both.
template <typename Ch>
__device__ void wide_affixes(const Ch* ap, int al, const Ch* bp, int bl,
                             int& pf, int& sf) {
  const int lane = threadIdx.x & 31;
  const int n = min(al, bl);
  pf = sf = n;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    const unsigned diff = __ballot_sync(FULL, k < n && ap[k] != bp[k]);
    if (diff) {
      pf = k0 + __ffs(diff) - 1;
      break;
    }
  }
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    const unsigned diff =
        __ballot_sync(FULL, k < n && ap[al - 1 - k] != bp[bl - 1 - k]);
    if (diff) {
      sf = k0 + __ffs(diff) - 1;
      break;
    }
  }
}

// The wide path's two parts, both on; tools/k2_wide_parts.py times each
// alone by building this source with the other off (its outputs wrong).
constexpr bool WIDE_BAND = true;
constexpr bool WIDE_LCS = true;

// The wide path's DL and LCS of one pair by the calling warp over its ring
// (Wide<W>::RING ints); every lane returns both. A pair whose lengths
// differ by more than W + 1 never has cell (al + 1, bl) in its band: its
// DL is big, as the walked band gives it, without walking it; its LCS
// alone takes wide_lcs. A pair whose band is walked takes the LCS in the
// same rows where b's characters pack (at most 512, of a byte each).
template <int W, typename Ch>
__device__ void wide_pair(const Ch* ap, int al, const Ch* bp, int bl, int L,
                          int* ring, int* ld_out, int* lcs_out) {
  const int lane = threadIdx.x & 31;
  const bool band = al > 0 && bl > 0 && abs(al - bl) <= Wide<W>::B1;
  int ld = al == 0 ? bl : bl == 0 ? al : 2 * L + 8, lcs = 0;
  if (band && WIDE_BAND) {
    const int nw =
        WIDE_LCS && __all_sync(FULL, byte_chars(ap, al, lane, 32) &&
                                         byte_chars(bp, bl, lane, 32))
            ? lcs_words(bl)
            : 0;
    switch (nw) {
      case 1: wide_rows<W, 1, false>(ap, al, bp, bl, L, ring, ld, lcs); break;
      case 2: wide_rows<W, 2, false>(ap, al, bp, bl, L, ring, ld, lcs); break;
      case 4: wide_rows<W, 4, true>(ap, al, bp, bl, L, ring, ld, lcs); break;
      case 6: wide_rows<W, 6, true>(ap, al, bp, bl, L, ring, ld, lcs); break;
      case 8: wide_rows<W, 8, true>(ap, al, bp, bl, L, ring, ld, lcs); break;
      default:
        wide_rows<W, 0, false>(ap, al, bp, bl, L, ring, ld, lcs);
        if (WIDE_LCS) lcs = wide_lcs(ap, al, bp, bl);
    }
  } else if (WIDE_LCS) {
    lcs = wide_lcs(ap, al, bp, bl);
  }
  *ld_out = ld;
  *lcs_out = lcs;
}

constexpr int WIDE_WARPS = 8;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;

// The wide launch: each warp takes the next listed pairs until none is
// left (`run(p, ring)` does one by the warp), so a cluster of long pairs
// spreads over every warp of the grid. While many are left a warp takes
// up to 16 at once (an eighth of its share), so that one counter's atomics
// stay few; a warp that finds the list taken takes none. While W <= 6 and
// the pairs left outnumber the warps, a warp takes them two at a time
// (`run2(p0, p1, ring)`: their band DPs on a half warp each); fewer, and
// each pair has a warp to itself, which finishes it soonest. A batch
// without a wide pair costs the launch and one atomic a block.
template <int W, typename Run, typename Run2>
__device__ __forceinline__ void take_list(WorkList wl, Run run, Run2 run2) {
  constexpr bool TWO = Wide<W>::SPAN <= 16;
  __shared__ int rings[WIDE_WARPS][(TWO ? 2 : 1) * Wide<W>::RING];
  int* const ring = rings[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int n = *(volatile int*)wl.ctr;
  const int warps = (int)gridDim.x * WIDE_WARPS;
  while (true) {
    int k = 0, m = 0, two = 0;
    if (lane == 0) {
      const int left = n - *(volatile int*)(wl.ctr + 1);
      two = TWO && left > warps;
      m = left > 0 ? min(16, max(two ? 2 : 1, left / (8 * warps))) : 0;
      if (m) k = atomicAdd(wl.ctr + 1, m);
    }
    k = __shfl_sync(FULL, k, 0);
    m = min(__shfl_sync(FULL, m, 0), n - k);
    if (m <= 0) break;
    int e = k;
    if constexpr (TWO) {
      if (__shfl_sync(FULL, two, 0))
        for (; e + 1 < k + m; e += 2)
          run2(wl.items[e], wl.items[e + 1], ring);  // cut: scan
    }
    for (; e < k + m; ++e) run(wl.items[e], ring);  // cut: scan
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(wl.ctr + 2, 1) == (int)gridDim.x - 1) {
      wl.ctr[0] = 0;
      wl.ctr[1] = 0;
      wl.ctr[2] = 0;
    }
  }
}

// A pair's strings and lengths.
template <typename Ch>
struct PairStrings {
  const Ch* ap;
  int al;
  const Ch* bp;
  int bl;
};

// DL and LCS of pairs p0 and p1 (their strings by `strings(p)`), half
// warp h walking pair h's band and, where its characters pack as bytes
// and bl <= 255, its LCS in the same rows (wide_rows2) over the warp's
// two rings; the other LCS by the whole warp (wide_lcs). Every lane
// returns both pairs' (ld[h], lcs[h]).
template <int W, typename Strings>
__device__ void wide_pair2(int p0, int p1, int L, int* ring, Strings strings,
                           int (&ld)[2], int (&lcs)[2]) {
  const int lane = threadIdx.x & 31, h = lane >> 4;
  const auto s = strings(h ? p1 : p0);
  const bool band =
      WIDE_BAND && s.al > 0 && s.bl > 0 && abs(s.al - s.bl) <= Wide<W>::B1;
  const unsigned bytes = __ballot_sync(
      FULL, byte_chars(s.ap, s.al, lane & 15, 16) &&
                byte_chars(s.bp, s.bl, lane & 15, 16));
  const bool lcs_on = WIDE_LCS && band && s.bl <= 255 &&
                      (bytes >> (lane & 16) & 0xFFFFu) == 0xFFFFu;
  const int nw = lcs_on ? (s.bl <= 128 ? 2 : 4) : 0;
  const int nw2 = max(nw, __shfl_xor_sync(FULL, nw, 16));
  int d = 0, c = 0;
  int* const rh = ring + h * Wide<W>::RING;
  if (nw2 == 4)
    wide_rows2<W, 4>(s.ap, s.al, s.bp, s.bl, L, rh, band, lcs_on, d, c);
  else if (nw2 == 2)
    wide_rows2<W, 2>(s.ap, s.al, s.bp, s.bl, L, rh, band, lcs_on, d, c);
  else
    wide_rows2<W, 0>(s.ap, s.al, s.bp, s.bl, L, rh, band, false, d, c);
  d = band ? d : s.al == 0 ? s.bl : s.bl == 0 ? s.al : 2 * L + 8;
  for (int q = 0; q < 2; ++q) {
    ld[q] = __shfl_sync(FULL, d, 16 * q);
    lcs[q] = __shfl_sync(FULL, c, 16 * q);
    if (!__shfl_sync(FULL, lcs_on, 16 * q) && WIDE_LCS) {
      const auto t = strings(q ? p1 : p0);
      lcs[q] = wide_lcs(t.ap, t.al, t.bp, t.bl);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(WIDE_THREADS)
dl_lcs_wide_kernel(const int* __restrict__ a, const int* __restrict__ a_len,
                   const int* __restrict__ b, const int* __restrict__ b_len,
                   int* __restrict__ ld, int* __restrict__ lcs, int L,
                   WorkList wl) {
  auto strings = [&](int p) {
    return PairStrings<int>{a + (size_t)p * L, min(a_len[p], L),
                            b + (size_t)p * L, min(b_len[p], L)};
  };
  take_list<W>(
      wl,
      [&](int p, int* ring) {
        const auto s = strings(p);
        int d, c;
        wide_pair<W, int>(s.ap, s.al, s.bp, s.bl, L, ring, &d, &c);
        if ((threadIdx.x & 31) == 0) {
          ld[p] = d;
          lcs[p] = c;
        }
      },
      [&](int p0, int p1, int* ring) {
        int d[2], c[2];
        wide_pair2<W>(p0, p1, L, ring, strings, d, c);
        if ((threadIdx.x & 31) == 0) {
          ld[p0] = d[0];
          lcs[p0] = c[0];
          ld[p1] = d[1];
          lcs[p1] = c[1];
        }
      });
}

template <int W, typename Ch>
__global__ void __launch_bounds__(WIDE_THREADS)
dl_lcs_slots_wide_kernel(SlotTables<Ch> t, SlotOut out, ScoreIn in,
                         ScoreOut so, int P, int L, WorkList wl) {
  auto strings = [&](int p) {
    const int qi = t.q[p], ci = t.pc[p];
    const SlotLens n = slot_lens(t, qi, ci, t.valid[p] != 0, L);
    return PairStrings<Ch>{t.q_norms + (size_t)qi * L, n.al,
                           t.norms2 + (size_t)ci * 2 * L, n.bl};
  };
  // slot p's affixes and case flag, its DL and LCS (by wide_pair with
  // ld < 0), then its outputs
  auto finish = [&](int p, int ld, int lcs, int* ring) {
    const int qi = t.q[p], ci = t.pc[p];
    const bool v = t.valid[p] != 0;
    const SlotLens n = slot_lens(t, qi, ci, v, L);
    const auto s = strings(p);
    SlotMetrics r;
    r.ql = n.ql;
    wide_affixes(s.ap, s.al, s.bp, s.bl, r.pf, r.sf);
    r.same_first = (t.first_lower[ci] != 0) == (t.q_first_lower[qi] != 0);
    if (ld < 0) {
      wide_pair<W, Ch>(s.ap, s.al, s.bp, s.bl, L, ring, &r.ld, &r.lcs);
    } else {
      r.ld = ld;
      r.lcs = lcs;
    }
    if ((threadIdx.x & 31) == 0) {
      bool kept = false;
      const unsigned long long f =
          write_slot(p, P, qi, ci, v, r, t.k_ed[qi], out, in, so, kept);
      if (so.max_freq && f > 0) atomicMax(so.max_freq + qi, f);
      if (so.counts && kept)
        atomicAdd(so.counts + p / slot_threads<NARROW>(), 1);
    }
  };
  take_list<W>(
      wl, [&](int p, int* ring) { finish(p, -1, 0, ring); },
      [&](int p0, int p1, int* ring) {
        int d[2], c[2];
        wide_pair2<W>(p0, p1, L, ring, strings, d, c);
        finish(p0, d[0], c[0], ring);
        finish(p1, d[1], c[1], ring);
      });
}

// The wide launch's grid: as many blocks as fit on the card at once, or
// fewer when the launch's P slots hold fewer pairs than their warps.
template <typename Kernel>
cudaError_t wide_grid(Kernel kernel, int P, unsigned& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WIDE_THREADS, 0);
  const long long need = ((long long)P + WIDE_WARPS - 1) / WIDE_WARPS;
  grid = (unsigned)max(1LL, min((long long)max(per_sm, 1) * sms, need));
  return e;
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
           int* lcs, int P, int L, WorkList wl, cudaStream_t st) {
  static_assert(THREADS % 16 == 0, "rows of whole 16-byte words");
  static unsigned long long attr_set = 0;
  cudaError_t e = allow_smem(dl_lcs_kernel<W, LMAX, THREADS>,
                             (size_t)state_elems<W, LMAX>(LMAX) * THREADS,
                             attr_set);
  if (e != cudaSuccess) return (int)e;
  const int Ldp = min(L, NARROW);
  const size_t smem = (size_t)state_elems<W, LMAX>(Ldp) * THREADS;
  dl_lcs_kernel<W, LMAX, THREADS><<<(P + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      a, al, b, bl, ld, lcs, P, L, Ldp, wl);
  return (int)cudaGetLastError();
}

// The byte path's launch, then above L 64 the wide path's, which takes the
// pairs the byte launch listed.
template <int W>
int launch_w(const int* a, const int* al, const int* b, const int* bl, int* ld,
             int* lcs, int P, int L, WorkList wl, cudaStream_t st) {
  // 128 threads: at L 32, 230 B a thread at W=3 (29 KB a block), 527 B at
  // W=12 (67 KB, three blocks per SM); LMAX 64 takes 64 threads (W=12, L 64:
  // 71 KB)
  const int e =
      L <= 32 ? launch<W, 32, 128>(a, al, b, bl, ld, lcs, P, L, wl, st)
              : launch<W, 64, 64>(a, al, b, bl, ld, lcs, P, L, wl, st);
  if (e != 0 || L <= NARROW) return e;
  unsigned grid = 0;
  const cudaError_t g = wide_grid(dl_lcs_wide_kernel<W>, P, grid);
  if (g != cudaSuccess) return (int)g;
  dl_lcs_wide_kernel<W><<<grid, WIDE_THREADS, 0, st>>>(a, al, b, bl, ld, lcs,
                                                      L, wl);
  return (int)cudaGetLastError();
}

template <int W, int LMAX, int THREADS, typename Ch>
int launch_slots(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                 ScoreOut so, int P, int L, WorkList wl, cudaStream_t st) {
  static unsigned long long attr_set = 0;
  cudaError_t e = allow_smem(dl_lcs_slots_kernel<W, LMAX, THREADS, Ch>,
                             (size_t)state_elems<W, LMAX>(LMAX) * THREADS,
                             attr_set);
  if (e != cudaSuccess) return (int)e;
  const int Ldp = min(L, NARROW);
  const size_t smem = (size_t)state_elems<W, LMAX>(Ldp) * THREADS;
  dl_lcs_slots_kernel<W, LMAX, THREADS, Ch>
      <<<(P + THREADS - 1) / THREADS, THREADS, smem, st>>>(t, out, in, so, P,
                                                          L, Ldp, wl);
  return (int)cudaGetLastError();
}

// The instances of launch_w, then above L 64 the wide path's launch, which
// takes the slots the byte launch listed and adds its kept slots to the
// byte launch's block counts.
template <int W, typename Ch>
int launch_slots_w(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                   ScoreOut so, int P, int L, WorkList wl, cudaStream_t st) {
  const int e =
      L <= 32
          ? launch_slots<W, 32, slot_threads<32>(), Ch>(t, out, in, so, P, L,
                                                        wl, st)
          : launch_slots<W, 64, slot_threads<64>(), Ch>(t, out, in, so, P, L,
                                                        wl, st);
  if (e != 0 || L <= NARROW) return e;
  unsigned grid = 0;
  const cudaError_t g = wide_grid(dl_lcs_slots_wide_kernel<W, Ch>, P, grid);
  if (g != cudaSuccess) return (int)g;
  dl_lcs_slots_wide_kernel<W, Ch><<<grid, WIDE_THREADS, 0, st>>>(
      t, out, in, so, P, L, wl);
  return (int)cudaGetLastError();
}

template <typename Ch>
int launch_slots_all(const SlotTables<Ch>& t, SlotOut out, const ScoreIn& in,
                     ScoreOut so, int P, int L, int W, WorkList wl,
                     cudaStream_t st) {
  switch (W) {
    case 3: return launch_slots_w<3, Ch>(t, out, in, so, P, L, wl, st);
    case 6: return launch_slots_w<6, Ch>(t, out, in, so, P, L, wl, st);
    case 12: return launch_slots_w<12, Ch>(t, out, in, so, P, L, wl, st);
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
// The wide path's work list from an entry's last two arguments: both are
// needed above L 64 (false without them), neither at or below it.
bool work_list(void* items, void* ctr, int L, WorkList& wl) {
  wl = L > NARROW ? WorkList{(int*)items, (int*)ctr} : WorkList{};
  return L <= NARROW || (items && ctr);
}

int slots_entry(const void* q, const void* pc, const void* valid,
                const void* norms2, const void* norm_lens,
                const void* first_lower, const void* q_norms,
                const void* q_lens, const void* q_first_lower,
                const void* k_ed, int elem_bytes, SlotOut out,
                const ScoreIn& in, ScoreOut so, int P, int L, int W,
                void* stream, void* wide_list, void* wide_ctr) {
  if (P <= 0) return 0;
  WorkList wl;
  if (L < 1 || !work_list(wide_list, wide_ctr, L, wl))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return launch_slots_all(
        slot_tables<signed char>(q, pc, valid, norms2, norm_lens, first_lower,
                                 q_norms, q_lens, q_first_lower, k_ed),
        out, in, so, P, L, W, wl, st);
  if (elem_bytes == 4)
    return launch_slots_all(
        slot_tables<int>(q, pc, valid, norms2, norm_lens, first_lower,
                         q_norms, q_lens, q_first_lower, k_ed),
        out, in, so, P, L, W, wl, st);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// Whether this build's entries take the wide path's work list after the
// stream (the two trailing arguments below).
extern "C" int analiticcl_dl_lcs_work_list() { return 1; }

// Each entry launches K2's byte path on `stream` (every pair whose two
// strings are at most 64 long; all of them up to L 64) and, above L 64, the
// wide path after it (the rest, which the byte launch lists): one launch,
// or two in order. Above L 64 every entry also takes, after the stream,
// wide_list: int32 [P] scratch, and wide_ctr: int32 [3], zero when the
// call is made and zero again when its launches have run (the wide
// launch's last block resets it), so one buffer serves every call on the
// stream; null at or below L 64.
//
// a, b: int32 [P, L] (PAD_A / PAD_B padded); a_len, b_len: int32 [P];
// ld, lcs: int32 [P] outputs. W in {3, 6, 12}, L >= 1.
extern "C" int analiticcl_dl_lcs(const void* a, const void* a_len,
                                 const void* b, const void* b_len, void* ld,
                                 void* lcs, int P, int L, int W,
                                 void* stream, void* wide_list,
                                 void* wide_ctr) {
  if (P <= 0) return 0;
  WorkList wl;
  if (L < 1 || !work_list(wide_list, wide_ctr, L, wl))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto A = (const int*)a, AL = (const int*)a_len, B = (const int*)b,
       BL = (const int*)b_len;
  auto LD = (int*)ld, LCS = (int*)lcs;
  switch (W) {
    case 3: return launch_w<3>(A, AL, B, BL, LD, LCS, P, L, wl, st);
    case 6: return launch_w<6>(A, AL, B, BL, LD, LCS, P, L, wl, st);
    case 12: return launch_w<12>(A, AL, B, BL, LD, LCS, P, L, wl, st);
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
    void* stream, void* wide_list, void* wide_ctr) {
  return slots_entry(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                     q_lens, q_first_lower, k_ed, elem_bytes,
                     SlotOut{(int*)metrics, (unsigned char*)same_first},
                     ScoreIn{}, ScoreOut{}, P, L, W, stream, wide_list,
                     wide_ctr);
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
    void* counts, int P, int L, int W, void* stream, void* wide_list,
    void* wide_ctr) {
  if (!weights || !thr || !keep || !met || !pc_band || !exact_q ||
      (freqs == nullptr) != (max_freq == nullptr))
    return (int)cudaErrorInvalidValue;
  return slots_entry(q, pc, valid, norms2, norm_lens, first_lower, q_norms,
                     q_lens, q_first_lower, k_ed, elem_bytes, SlotOut{},
                     score_in(pc_band, exact_q, nb8, use_exact, freqs,
                              weights, thr),
                     score_out(keep, met, L, max_freq, score, counts), P, L,
                     W, stream, wide_list, wide_ctr);
}
#else
namespace {
// The wide path's warp on the host, its lanes walked in order: a shuffle
// reads the lane's array element, a ballot is a bit mask, the prefix
// minimum a running one, a vote an OR over the lanes.
template <int W, typename Ch>
int wide_band_host(const Ch* ap, int al, const Ch* bp, int bl, int L,
                   int* ring) {
  using D = Wide<W>;
  const int big = 2 * L + 8;
  int prev[32], last[32], nv[32];
  for (int k = 0; k < 32; ++k) {
    prev[k] = k + 1;
    last[k] = 0;
  }
  int pjs = 1, pje = L;
  for (int i = 1; i <= al; ++i) {
    const int ach = ap[i - 1];
    const int js = max(1, i - D::B1), je = min(L, i + D::B1);
    const int s = js - pjs;
    bool match[32];
    unsigned bits = 0;
    for (int k = 0; k < 32; ++k) {
      match[k] = js + k <= je && bp[js + k - 1] == ach;
      bits |= (unsigned)match[k] << k;
    }
    int up[32], upl[32], lastc[32];
    for (int k = 0; k < 32; ++k) {
      const int j = js + k;
      up[k] = j > pje ? big : prev[(k + s) & 31];
      upl[k] = j == 1 ? i - 1 : prev[(k + s - 1) & 31];
      lastc[k] = j == i + D::B1 ? 0 : last[(k + s) & 31];
    }
    int x = INT_MAX;
    for (int k = 0; k < D::SPAN; ++k) {
      const int j = js + k;
      const unsigned left = bits & ((1u << k) - 1);
      const int db = left ? js + 31 - __builtin_clz(left) : 0;
      if (j <= je)
        x = min(x, band_candidate<W>(ring, i, j, up[k], upl[k], match[k],
                                     lastc[k], db, L) - k);
      nv[k] = k + min(x, (js == 1 ? i : big) + 1);
    }
    for (int k = 0; k < D::SPAN; ++k) {
      const int j = js + k;
      if (j <= je)
        ring[((i + 1) & (D::RP - 1)) * D::CP + (j & (D::CP - 1))] = nv[k];
      prev[k] = nv[k];
      last[k] = match[k] ? i : lastc[k];
    }
    pjs = js;
    pje = je;
  }
  return nv[bl - pjs];
}

template <bool HALF, typename Ch>
int lcs_rows_host(const Ch* rp, int nr, const Ch* cp, int nc, int NW) {
  const unsigned ONE = HALF ? 0x00010001u : 0x01010101u;
  const unsigned TOP = HALF ? 0x80008000u : 0x80808080u;
  std::vector<unsigned> ch(32 * NW), vm(32 * NW), run(32 * NW, 0);
  for (int w = 0; w < 32 * NW; ++w) lcs_pack<HALF>(cp, nc, w, ch[w], vm[w]);
  int best = 0;
  unsigned bp1 = ONE;
  for (int i = 0; i < nr && best < nc; ++i) {
    const unsigned a = (unsigned)(unsigned char)rp[i] * ONE;
    unsigned acc = 0, left = 0;  // left of lane 0's first word: no column
    for (int w = 0; w < 32 * NW; ++w) {  // lane w / NW, its word w % NW
      const unsigned old = run[w];
      run[w] = lcs_word<HALF>(ch[w], vm[w], a, old, left, bp1, acc);
      left = old;
    }
    if (acc & TOP) {
      ++best;
      bp1 += ONE;
    }
  }
  return best;
}

template <typename Ch>
int wide_lcs_host(const Ch* ap, int al, const Ch* bp, int bl) {
  const bool rows_a = al >= bl;
  const Ch* const rp = rows_a ? ap : bp;
  const Ch* const cp = rows_a ? bp : ap;
  const int nr = rows_a ? al : bl, nc = rows_a ? bl : al;
  if (nc == 0) return 0;
  const int nw = lcs_words(nc);
  bool packed = nw > 0;
  for (int lane = 0; lane < 32; ++lane)
    packed = packed && byte_chars(rp, nr, lane, 32) &&
             byte_chars(cp, nc, lane, 32);
  if (packed)
    return nw <= 2 ? lcs_rows_host<false>(rp, nr, cp, nc, nw)
                   : lcs_rows_host<true>(rp, nr, cp, nc, nw);
  int best = 0;
  for (int lane = 0; lane < 32; ++lane)
    best = max(best, lcs_diagonals(ap, al, bp, bl, lane, 32));
  return best;
}

template <int W, typename Ch>
void wide_pair_host(const Ch* ap, int al, const Ch* bp, int bl, int L,
                    int* ring, int* ld_out, int* lcs_out) {
  const bool band = al > 0 && bl > 0 && abs(al - bl) <= Wide<W>::B1;
  int ld = al == 0 ? bl : bl == 0 ? al : 2 * L + 8, lcs;
  if (band) {
    ld = wide_band_host<W>(ap, al, bp, bl, L, ring);
    bool packed = true;
    for (int lane = 0; lane < 32; ++lane)
      packed = packed && byte_chars(ap, al, lane, 32) &&
               byte_chars(bp, bl, lane, 32);
    const int nw = packed ? lcs_words(bl) : 0;  // the LCS in the band's rows
    lcs = nw == 0   ? wide_lcs_host(ap, al, bp, bl)
          : nw <= 2 ? lcs_rows_host<false>(ap, al, bp, bl, nw)
                    : lcs_rows_host<true>(ap, al, bp, bl, nw);
  } else {
    lcs = wide_lcs_host(ap, al, bp, bl);
  }
  *ld_out = ld;
  *lcs_out = lcs;
}

// The kernels' instances on the host, one pair at a time over state of
// stride 1: LMAX 32 (LCS row in registers) up to L 32, else LMAX 64 at DP
// width min(L, 64), and a pair with a longer string on the wide path.
template <typename Cell, int W, int LMAX>
void host_pairs(const int* a, const int* a_len, const int* b, const int* b_len,
                int* ld, int* lcs, int P, int L) {
  const int Ldp = min(L, NARROW);
  std::vector<Cell> st(state_elems<W, LMAX>(Ldp));
  std::vector<int> wide(Wide<W>::RING);
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
  std::vector<int> wide(Wide<W>::RING);
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
