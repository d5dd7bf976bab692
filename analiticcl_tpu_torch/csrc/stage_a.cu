// Stage A on Hopper: charcount-banded L1-ball retrieval masks.
//
// Replaces the TPU kernel `_stage_a_kernel` in analiticcl_tpu/ops/stage_a.py
// (line 88, launched by `stage_a_masks_pallas`), and matches
// `stage_a_masks_xla` bit for bit, `validrows` included. For each query q and
// band row r:
//   L1    = cc[row] + q_cc[q] - 2 * dot(bins[row], qbin[q])  (int8 planes)
//   hit   = L1 <= k_ana[q] && |cc[row] - q_cc[q]| <= k_len[q] && valid[row]
//   exact = L1 == 0 && valid[row]
// with row = start_blk[q / bt] * 1024 + r. The planes are threshold-major
// (column t * A + a holds count[a] > t; convert.py), so a row whose
// characters occur at most c times is zero past column c * A, and each
// 1024-row block of the index has an extent (convert.block_extents): past
// it every row of the block is zero. Outputs are banded and
// query-major: packed_q / exact_q uint8 [B, Nb/8] (bit k of byte j is band
// row 8j + k), counts_t int32 [Nb/128, B] (hits per 128 band rows), and the
// per-query totals nmatch / nexact int32 [B].
//
// What bounds it on the H100: the int8 products. B * Nb * AT multiply-adds
// (4,096 x 91,136 x 224 on the main path, 1.67e11 operations) take 84.5 us at
// the dense int8 tensor-core rate of 1,979 TOP/s; the ~130 MB of planes read
// and bits written take ~39 us at 3.35 TB/s.
//
// Design. The product runs on the int8 tensor cores as
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, fed by ldmatrix. Both
// operands are K-contiguous as they lie (qbin [B, at_pad] is the row-major
// A, bins [Ni, at_pad] the column-major B), so no operand is transposed, and
// 0/1 planes keep the int32 sums exact. mma.sync was chosen over wgmma: its
// fragments are plain registers with a documented layout, which the fused
// epilogue below reads element by element, and it takes both operands from
// shared memory without wgmma's swizzled descriptors.
//   A block takes QT = min(128, bt) queries (so its queries share one band
// start, start_blk[q0 / bt]) and one 1024-row band block. The queries'
// planes stay resident in shared memory; the band block streams through a
// three-stage ring of 64-row chunks with cp.async (the next chunks' planes,
// charcounts and valid flags load while the tensor cores work on this one).
// Eight warps split a chunk as 4 query groups x 2 row groups; each warp
// computes a 32-query x 32-row tile (2 x 4 mma tiles over at_pad / 32
// k-steps). At the main path's AT 224 (7 k-steps) each warp keeps its
// queries' A fragments in registers for the whole block, so ldmatrix reads
// only the band rows from shared memory (the smem reads per product halve).
// 128 queries per block means the band's planes are read from L2 once per
// 128 queries; query tiles vary fastest in the grid, so the blocks
// on the card at one time share a few band blocks. Two blocks fit on an SM
// (111.6 KB of shared memory, at most 128 registers a thread at AT 224), so
// one block's epilogue overlaps the other's loads and products. Wider
// planes (AT = A x T, T the largest count of one character in one entry:
// long lexicon entries) keep 128 resident queries up to AT 576.
//   Above that the streamed instance (`stage_a_kernel_stream`) takes any
// width: no planes stay resident. For each 64-row chunk it walks the
// planes in k-chunks of KC = 128 bytes, and each step (chunk, k-chunk)
// brings the queries' piece [qt, 128] and the rows' piece [64, 128]
// through a two-stage cp.async ring (one barrier per four k-steps); the
// accumulators stay in the same m16n8k32 registers across the k-chunks,
// and after a chunk's last k-chunk the same fused epilogue runs. Its
// shared memory (87.6 KB at 128 queries) does not depend on AT, so two
// blocks fit an SM at any width. (On an H100, against 64-byte k-chunks
// in a ring of four stages: 3.55 against 4.11 ms on planes 1,664 wide; a
// ring of three 128-byte stages, one block an SM, 4.82.) It reads the
// queries' planes from L2 once per 64 rows (twice the band's bytes); the
// tensor cores wait on L2 more than in the resident instances. (Where both
// fit, it took the time of a resident block of 64 queries at AT 608 and
// 0.6x that of one of 32 at AT 864 and 960, on an H100, so the resident
// blocks of fewer queries are gone.) It runs the main body too, so its
// dynamic shared memory is the main block's, 111.6 KB, still two blocks
// an SM; `k1_route` does not pick it where that does not fit (it always
// fits on an H100). The main instance stays a launch of its own: on the
// main path's batch, where every block runs the main body, the streamed
// kernel took 2.2 % longer on an H100 (`tools/k1_parts.py`'s turns).
//   Each launch walks only the columns its rows use. `k1_route` picks the
// instance before the launch from the launch's width (the largest extent
// among the band blocks its tiles read, which the band plan reckons on
// the host): the main instance up to 224 (its first 224 columns, whatever
// the planes' row stride), a resident one at the width while it fits,
// else streamed. The streamed instance reads each band block's own extent
// from the table on the card: a block of extent at most 224 runs the main
// instance's body (its queries' A fragments in registers), a wider one
// walks kchunks(extent) k-chunks per row chunk. Its grid runs the band
// blocks last to first, so that the widest (the rows sort by charcount,
// and the long, repetitive entries last) start first and do not trail.
// Planes are padded to a multiple of 32 bytes (one k-step) by convert.py;
// shared-memory rows carry 16 spare bytes so that ldmatrix's eight row
// reads hit distinct banks. When qt < 128 the unused MMA rows hold zero
// planes and their bits are never stored; a warp whose 32 queries are all
// unused skips its work.
//   The epilogue is fused, straight from the accumulators. With the queries
// as A, a lane holds 4 queries x 8 band rows of its warp's tile; per element
// it makes one multiply-add and four compares (the L1, length and exact
// tests, with the query terms and the row's valid flag folded beforehand),
// and ORs the bits into one word per query.
// Two shfl_xor join the four lanes of a query into its 32-row word. Those
// words go to a bit tile in shared memory; after the last chunk the block
// writes each query's 128 bytes of packed_q and exact_q with coalesced
// stores, the per-128-row counts by __popc, and the per-query totals with
// one int32 atomicAdd per block and query (exact in any order; CUDA blocks,
// unlike the TPU grid, run in no order). The integer issue of this epilogue
// (B * Nb pairs) is, after the products, what the design cannot remove.
//
// With -DANALITICCL_HOST_TEST the epilogue (fragment predicates, the lane
// words, the counts and the stores) compiles as plain C++, driven by
// `analiticcl_stage_a_host` from accumulators given in fragment order, so its
// arithmetic is checked on a machine without a card; and
// `analiticcl_stage_a_stream_host` walks the streamed instance's loop nest
// (row chunk x k-chunk x ring stage) through the same offset helpers, with a
// scalar dot in place of mma, into the same epilogue (a block that takes
// the main body: a scalar dot over its first 224 columns). `k1_route`
// compiles on both sides.

#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define DEVFN __device__ __forceinline__
#define HDFN __host__ __device__ __forceinline__
#define POPC(x) __popc(x)
#define ATOMIC_ADD(p, v) atomicAdd((p), (v))
#else
#include <cstdlib>
#include <cstring>
#include <vector>
#define DEVFN inline
#define HDFN inline
#define POPC(x) __builtin_popcount(x)
#define ATOMIC_ADD(p, v) (*(p) += (v))
#endif
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int ROW_BLOCK = 1024;
constexpr int CHUNK = 64;
constexpr int NCHUNK = ROW_BLOCK / CHUNK;  // 16
constexpr int QT_MAX = 128;
constexpr int NWARP = 8;                   // 4 query groups x 2 row groups
constexpr int NTHREAD = NWARP * 32;
constexpr int NSTAGE = 3;
constexpr int WORDS = ROW_BLOCK / 32;      // bit words per query and block
constexpr int WSTRIDE = WORDS + 1;         // odd: conflict-free bit tile
constexpr int NACC = 32;                   // accumulators per lane
constexpr int NEVER = -2147483647 - 1;     // a term no element meets
// the streamed instance: plane bytes per k-chunk, its ring's depth, and the
// bytes of a k-chunk row in shared memory (16 spare, as in the resident
// instances)
constexpr int KC = 128;
constexpr int SSTAGE = 2;
constexpr int SROW = KC + 16;
constexpr int KPIECES = KC / 16;  // 16-byte pieces of a k-chunk row

// K1's instances, as `k1_route` picks them and the C entry takes them
enum { K1_NONE = 0, K1_MAIN = 1, K1_RESIDENT = 2, K1_STREAM = 3 };

// Query rows a streamed block holds in shared memory (plane pieces, bit
// tiles): its qt queries rounded up to whole warp query groups of 32.
HDFN int tile_rows(int qt) { return (qt + 31) & ~31; }

// Dynamic shared memory of a resident block (128 query rows).
HDFN size_t smem_bytes(int at_pad) {
  const size_t rstride = (size_t)at_pad + 16;
  return QT_MAX * rstride + NSTAGE * (CHUNK * rstride + CHUNK * 4 + CHUNK) +
         2 * sizeof(unsigned) * QT_MAX * WSTRIDE;
}

// One stage of the streamed ring: `rows` query rows and the chunk's 64 band
// rows of one k-chunk, then the chunk's charcounts and valid flags.
HDFN size_t stream_stage_bytes(int rows) {
  return (size_t)(rows + CHUNK) * SROW + CHUNK * 4 + CHUNK;
}

// Dynamic shared memory of a streamed block holding `rows` query rows: the
// same at any plane width.
HDFN size_t stream_smem_bytes(int rows) {
  return SSTAGE * stream_stage_bytes(rows) +
         2 * sizeof(unsigned) * rows * WSTRIDE;
}

// The main instance's k width: the main path's 210 plane columns, padded.
constexpr int MAIN_WIDTH = 7 * 32;

// Whether the main instance serves a launch `width` wide over planes
// `at_pad` wide (it reads their first MAIN_WIDTH columns).
HDFN bool main_fits(int width, int at_pad, size_t limit) {
  return width <= MAIN_WIDTH && at_pad >= MAIN_WIDTH &&
         smem_bytes(MAIN_WIDTH) <= limit;
}

// The streamed instance's dynamic shared memory: the ring's, or the main
// body's where that is larger (its blocks of extent at most 224 run it).
HDFN size_t stream_launch_smem(int qt) {
  const size_t ring = stream_smem_bytes(tile_rows(qt));
  return smem_bytes(MAIN_WIDTH) > ring ? smem_bytes(MAIN_WIDTH) : ring;
}

// Whether the streamed instance serves planes at_pad wide (its main body
// reads their first MAIN_WIDTH columns).
HDFN bool stream_fits(int at_pad, int qt, size_t limit) {
  return at_pad >= MAIN_WIDTH && stream_launch_smem(qt) <= limit;
}

// The instance for a launch whose rows use `width` columns (the largest
// extent of the band blocks it reads) of planes at_pad wide, qt queries a
// block and a block's shared-memory `limit`, decided before the launch:
// the main one up to width 224, a resident one while 128 queries' planes
// of that width fit (up to 576 on an H100), else streamed; K1_NONE when
// nothing fits.
HDFN int k1_route(int width, int at_pad, int qt, size_t limit) {
  if (main_fits(width, at_pad, limit)) return K1_MAIN;
  if (smem_bytes(width) <= limit) return K1_RESIDENT;
  return stream_fits(at_pad, qt, limit) ? K1_STREAM : K1_NONE;
}

// The k width a streamed block walks: its band block's extent, kept
// inside the planes (a table entry is a multiple of 32 in [32, at_pad]).
HDFN int block_width(const int* extents, int blk, int at_pad) {
  const int w = extents[blk];
  return w < 32 ? 32 : (w > at_pad ? at_pad : w);
}

// k-chunks of a width kw, and the bytes of k-chunk kc (the last one may be
// narrower: kw is a multiple of 32, not of KC).
HDFN int kchunks(int kw) { return (kw + KC - 1) / KC; }
HDFN int kchunk_cols(int kw, int kc) {
  const int w = kw - kc * KC;
  return w < KC ? w : KC;
}

// Piece i of a streamed step (rows of KPIECES pieces of 16 bytes): stage
// rows [0, qt) take the block's queries q0 + row, rows [qs, qs + CHUNK) the
// chunk's band rows r0 + row - qs; k-chunk kc has w16 pieces a row, and
// the planes' rows are `stride` bytes apart. Sets the piece's byte offset
// in the stage and in its source (qbin or bins); false for a piece that
// loads nothing (query rows past qt stay zero).
HDFN bool stream_piece(int i, int qt, int qs, int q0, int r0, int stride,
                       int kc, int w16, int* dst, size_t* src, bool* from_q) {
  const int row = i / KPIECES, col = i - row * KPIECES;
  if (col >= w16 || (row >= qt && row < qs)) return false;
  *dst = row * SROW + col * 16;
  *from_q = row < qs;
  const size_t src_row = *from_q ? (size_t)(q0 + row) : (size_t)(r0 + row - qs);
  *src = src_row * stride + (size_t)kc * KC + col * 16;
  return true;
}

// A warp's tile is 32 queries x 32 band rows, 2 x 4 m16n8 tiles. Accumulator
// acc[(mi * 4 + ni) * 4 + reg] of lane (g = lane / 4, t = lane % 4) is the
// dot of tile query 8 k + g, k = 2 mi + reg / 2, with tile row
// 8 ni + 2 t + j, j = reg % 2. The lane's row r = 2 ni + j has charcount
// rcc[r] (row_term: NEVER for a row that is not valid); its query k has the
// terms kq = k_ana - q_cc, nq = -q_cc, lo = q_cc - k_len, hi = q_cc + k_len,
// so for a valid row
//   L1 <= k_ana            <=>  rcc - 2 dot <= kq
//   |rcc - q_cc| <= k_len  <=>  lo <= rcc <= hi
//   L1 == 0                <=>  rcc - 2 dot == nq
// and a row at NEVER fails lo <= rcc and, its difference wrapping, never
// equals nq (all exact while charcounts, thresholds and plane widths stay far
// inside int32, as they do). hit[k] / ex[k] get bit 8 ni + 2 t + j: the
// lane's share of query k's 32-row word.
DEVFN int row_term(int cc, bool valid) { return valid ? cc : NEVER; }

DEVFN void fragment_words(const int* acc, int t, const int* rcc,
                          const int* kq, const int* nq, const int* lo,
                          const int* hi, unsigned* hit, unsigned* ex) {
#pragma unroll
  for (int k = 0; k < 4; ++k) hit[k] = ex[k] = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int k = 2 * mi + (reg >> 1), j = reg & 1, r = 2 * ni + j;
        const int v = (int)((unsigned)rcc[r] -
                            2u * (unsigned)acc[(mi * 4 + ni) * 4 + reg]);
        const unsigned bit = 1u << (8 * ni + j);
        if ((rcc[r] >= lo[k]) & (rcc[r] <= hi[k]) & (v <= kq[k])) hit[k] |= bit;
        if (v == nq[k]) ex[k] |= bit;
      }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hit[k] <<= 2 * t;
    ex[k] <<= 2 * t;
  }
}

// The query terms of tile column c (unused columns match nothing).
DEVFN void query_terms(int c, int qt, int q0, const int* q_cc,
                       const int* k_ana, const int* k_len, int* kq, int* nq,
                       int* lo, int* hi) {
  if (c < qt) {
    const int qc = q_cc[q0 + c], kl = k_len[q0 + c];
    *kq = k_ana[q0 + c] - qc;
    *nq = -qc;
    *lo = qc - kl;
    *hi = qc + kl;
  } else {
    *kq = *nq = NEVER;
    *lo = 1;
    *hi = 0;
  }
}

// The rcc terms of lane (rg, t)'s 8 rows of a chunk, from the chunk's 64
// charcounts and valid flags.
DEVFN void lane_rows(const int* cc_c, const uint8_t* val_c, int rg, int t,
                     int* rcc) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = rg * 32 + 8 * (r >> 1) + 2 * t + (r & 1);
    rcc[r] = row_term(cc_c[row], val_c[row] != 0);
  }
}

// w[t] without a dynamically indexed array
DEVFN unsigned pick(const unsigned* w, int t) {
  return (t & 2) ? ((t & 1) ? w[3] : w[2]) : ((t & 1) ? w[1] : w[0]);
}

// The bit-tile word of chunk `chunk` that lane (g, t) of the warp (qg, rg)
// writes: query 8 t + g's 32 rows.
DEVFN int word_index(int qg, int rg, int g, int t, int chunk) {
  return (qg * 32 + 8 * t + g) * WSTRIDE + chunk * 2 + rg;
}

// Output step i of a block's packed_q / exact_q stores: query c = i / 32,
// word k = i % 32 (one query's 128 bytes are one block's 1024 band rows).
DEVFN void store_mask_word(int i, const unsigned* hit_w, const unsigned* ex_w,
                           int q0, int band_blk, size_t bytes_per_q,
                           uint8_t* packed_q, uint8_t* exact_q) {
  const int c = i / WORDS, k = i - c * WORDS;
  const size_t off = (size_t)(q0 + c) * bytes_per_q + (size_t)band_blk * (ROW_BLOCK / 8);
  reinterpret_cast<uint32_t*>(packed_q + off)[k] = hit_w[c * WSTRIDE + k];
  reinterpret_cast<uint32_t*>(exact_q + off)[k] = ex_w[c * WSTRIDE + k];
}

// Output step i of the per-128-row counts: 128-row group i / qt, query
// i % qt.
DEVFN void store_count(int i, const unsigned* hit_w, int qt, int q0,
                       int band_blk, int B, int* counts_t) {
  const int grp = i / qt, c = i - grp * qt;
  const unsigned* w = hit_w + c * WSTRIDE + grp * 4;
  counts_t[(size_t)(band_blk * (ROW_BLOCK / 128) + grp) * B + q0 + c] =
      POPC(w[0]) + POPC(w[1]) + POPC(w[2]) + POPC(w[3]);
}

// The block's share of query c's totals.
DEVFN void add_totals(int c, const unsigned* hit_w, const unsigned* ex_w,
                      int q0, int* nmatch, int* nexact) {
  int m = 0, e = 0;
  for (int k = 0; k < WORDS; ++k) {
    m += POPC(hit_w[c * WSTRIDE + k]);
    e += POPC(ex_w[c * WSTRIDE + k]);
  }
  ATOMIC_ADD(&nmatch[q0 + c], m);
  ATOMIC_ADD(&nexact[q0 + c], e);
}

#ifndef ANALITICCL_HOST_TEST
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 32-byte k-step of the warp's tile: the B (band rows) fragments by
// ldmatrix, then 2 x 4 products with the A (queries) fragments a.
__device__ __forceinline__ void kstep(int* acc, const unsigned (*a)[4],
                                      unsigned b_addr, int rstride, int ks) {
  unsigned b[2][4];
  ldmatrix_x4(b[0], b_addr + ks * 32);
  ldmatrix_x4(b[1], b_addr + 16 * rstride + ks * 32);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_s8(acc + (mi * 4 + ni) * 4, a[mi], b[ni >> 1][(ni & 1) * 2],
             b[ni >> 1][(ni & 1) * 2 + 1]);
}

// The A fragments of a query tile at k-step ks.
__device__ __forceinline__ void load_a(unsigned (*a)[4], unsigned a_addr,
                                       int rstride, int ks) {
  ldmatrix_x4(a[0], a_addr + ks * 32);
  ldmatrix_x4(a[1], a_addr + 16 * rstride + ks * 32);
}

// A chunk's epilogue for one lane: its fragment words from the chunk's
// charcounts and valid flags (`tail`: 64 int32, then 64 bytes), the four
// lanes of each query joined, and the lane's word into the bit tiles.
__device__ __forceinline__ void chunk_words(
    const int* acc, const unsigned char* tail, int qg, int rg, int g, int t,
    int chunk, const int* kq, const int* nq, const int* lo, const int* hi,
    unsigned* hit_w, unsigned* ex_w) {
  int rcc[8];
  lane_rows(reinterpret_cast<const int*>(tail), tail + CHUNK * 4, rg, t, rcc);
  unsigned hw[4], ew[4];
  fragment_words(acc, t, rcc, kq, nq, lo, hi, hw, ew);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // join the four lanes of each query
    hw[k] |= __shfl_xor_sync(0xffffffffu, hw[k], 1);
    hw[k] |= __shfl_xor_sync(0xffffffffu, hw[k], 2);
    ew[k] |= __shfl_xor_sync(0xffffffffu, ew[k], 1);
    ew[k] |= __shfl_xor_sync(0xffffffffu, ew[k], 2);
  }
  // lane (g, t) keeps query 8 t + g's words
  const int w = word_index(qg, rg, g, t, chunk);
  hit_w[w] = pick(hw, t);
  ex_w[w] = pick(ew, t);
}

// The block's stores after its last chunk: packed_q / exact_q, the
// per-128-row counts and the totals, from the bit tiles.
__device__ __forceinline__ void block_stores(
    const unsigned* hit_w, const unsigned* ex_w, int tid, int qt, int q0,
    int band_blk, int nb_band, int B, uint8_t* packed_q, uint8_t* exact_q,
    int* counts_t, int* nmatch, int* nexact) {
  const size_t bytes_per_q = (size_t)nb_band * (ROW_BLOCK / 8);
  for (int i = tid; i < qt * WORDS; i += NTHREAD)
    store_mask_word(i, hit_w, ex_w, q0, band_blk, bytes_per_q, packed_q, exact_q);
  for (int i = tid; i < qt * (ROW_BLOCK / 128); i += NTHREAD)
    store_count(i, hit_w, qt, q0, band_blk, B, counts_t);
  for (int c = tid; c < qt; c += NTHREAD)
    add_totals(c, hit_w, ex_w, q0, nmatch, nexact);
}

// One block of a resident instance: queries q0 .. q0 + qt over band block
// band_blk, the product over the planes' first kw columns (the k width;
// their rows lie `stride` bytes apart). KS > 0: kw == 32 * KS, a
// compile-time constant, and each warp keeps its queries' A fragments in
// registers for the whole block (2 x 4 x KS of them); KS == 0: kw ==
// at_pad, any width that fits, A fragments reloaded by ldmatrix at every
// k-step.
template <int KS>
__device__ __forceinline__ void resident_block(
    unsigned char* smem, const int8_t* __restrict__ bins,
    const int* __restrict__ cc, const uint8_t* __restrict__ validrows,
    const int8_t* __restrict__ qbin, const int* __restrict__ q_cc,
    const int* __restrict__ k_ana, const int* __restrict__ k_len,
    uint8_t* packed_q, uint8_t* exact_q, int* counts_t, int* nmatch,
    int* nexact, int B, int at_pad, int stride, int nb_band, int qt, int q0,
    int band_blk, int row_base) {
  const int kw = KS > 0 ? 32 * KS : at_pad;
  const int rstride = kw + 16;  // bytes per plane row in shared memory
  const int stage_bytes = CHUNK * rstride + CHUNK * 4 + CHUNK;
  const int qs = QT_MAX;
  unsigned char* q_s = smem;                          // [qs][rstride]
  unsigned char* stages = q_s + qs * rstride;         // NSTAGE x stage
  unsigned* hit_w =
      reinterpret_cast<unsigned*>(stages + NSTAGE * stage_bytes);  // [qs][WSTRIDE]
  unsigned* ex_w = hit_w + qs * WSTRIDE;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 1, qg = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int at16 = kw / 16;

  auto load_chunk = [&](int chunk) {
    unsigned char* st = stages + (chunk % NSTAGE) * stage_bytes;
    const int r0 = row_base + chunk * CHUNK;
    const int8_t* src = bins + (size_t)r0 * stride;
    for (int i = tid; i < CHUNK * at16; i += NTHREAD) {
      const int row = i / at16, col = i - row * at16;
      cp_async16(st + row * rstride + col * 16, src + (size_t)row * stride + col * 16);
    }
    if (tid < CHUNK / 4)
      cp_async16(st + CHUNK * rstride + tid * 16,
                 reinterpret_cast<const uint8_t*>(cc + r0) + tid * 16);
    else if (tid < CHUNK / 4 + CHUNK / 16)
      cp_async16(st + CHUNK * rstride + CHUNK * 4 + (tid - CHUNK / 4) * 16,
                 validrows + r0 + (tid - CHUNK / 4) * 16);
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    load_chunk(s);
    cp_async_commit();
  }
  // the block's query planes stay resident; unused tile rows are zero
  for (int i = tid; i < qs * at16; i += NTHREAD) {
    const int c = i / at16, col = i - c * at16;
    int4 v = make_int4(0, 0, 0, 0);
    if (c < qt)
      v = reinterpret_cast<const int4*>(qbin + (size_t)(q0 + c) * stride)[col];
    *reinterpret_cast<int4*>(q_s + c * rstride + col * 16) = v;
  }

  // this lane's 4 tile queries: 8 k + g of the warp's 32
  int kq[4], nq[4], lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    query_terms(qg * 32 + 8 * k + g, qt, q0, q_cc, k_ana, k_len, &kq[k],
                &nq[k], &lo[k], &hi[k]);
  const bool active = qg * 32 < qt;  // warp-uniform
  // ldmatrix row addresses. A (queries): matrices (queries 0-7 | 8-15) x
  // (bytes 0-15 | 16-31); B (band rows): (n-tile, bytes 0-15 | 16-31) for
  // n-tiles 0, 1 (and 2, 3 at 16 rows on)
  const unsigned a_addr = (unsigned)__cvta_generic_to_shared(q_s) +
                          (qg * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * rstride +
                          (lane >> 4) * 16;
  const int b_off =
      (rg * 32 + (lane & 7) + (lane >> 4) * 8) * rstride + ((lane >> 3) & 1) * 16;
  const int ksteps = kw / 32;
  unsigned a_res[KS > 0 ? KS : 1][2][4];
  if (KS > 0) {
    __syncthreads();  // the query planes are in shared memory
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) load_a(a_res[ks], a_addr, rstride, ks);
    }
  }

  for (int chunk = 0; chunk < NCHUNK; ++chunk) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk's stage landed; the oldest stage is free
    if (chunk + NSTAGE - 1 < NCHUNK) load_chunk(chunk + NSTAGE - 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* st = stages + (chunk % NSTAGE) * stage_bytes;
    const unsigned b_addr = (unsigned)__cvta_generic_to_shared(st) + b_off;

    int acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    if (KS > 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) kstep(acc, a_res[ks], b_addr, rstride, ks);
    } else {
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[2][4];
        load_a(a, a_addr, rstride, ks);
        kstep(acc, a, b_addr, rstride, ks);
      }
    }

    const int* cc_s = reinterpret_cast<const int*>(st + CHUNK * rstride);
    const uint8_t* val_s = st + CHUNK * rstride + CHUNK * 4;
    int rcc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = rg * 32 + 8 * (r >> 1) + 2 * t + (r & 1);
      rcc[r] = row_term(cc_s[row], val_s[row] != 0);
    }
    unsigned hw[4], ew[4];
    fragment_words(acc, t, rcc, kq, nq, lo, hi, hw, ew);
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // join the four lanes of each query
      hw[k] |= __shfl_xor_sync(0xffffffffu, hw[k], 1);
      hw[k] |= __shfl_xor_sync(0xffffffffu, hw[k], 2);
      ew[k] |= __shfl_xor_sync(0xffffffffu, ew[k], 1);
      ew[k] |= __shfl_xor_sync(0xffffffffu, ew[k], 2);
    }
    // lane (g, t) keeps query 8 t + g's words
    const int w = (qg * 32 + 8 * t + g) * WSTRIDE + chunk * 2 + rg;
    hit_w[w] = pick(hw, t);
    ex_w[w] = pick(ew, t);
  }
  __syncthreads();

  const size_t bytes_per_q = (size_t)nb_band * (ROW_BLOCK / 8);
  for (int i = tid; i < qt * WORDS; i += NTHREAD)
    store_mask_word(i, hit_w, ex_w, q0, band_blk, bytes_per_q, packed_q, exact_q);
  for (int i = tid; i < qt * (ROW_BLOCK / 128); i += NTHREAD)
    store_count(i, hit_w, qt, q0, band_blk, B, counts_t);
  for (int c = tid; c < qt; c += NTHREAD)
    add_totals(c, hit_w, ex_w, q0, nmatch, nexact);
}

// The main and resident instances: at_pad is the k width, `stride` the
// planes' row bytes.
template <int KS>
__global__ void __launch_bounds__(NTHREAD, 2)
stage_a_kernel(const int8_t* __restrict__ bins, const int* __restrict__ cc,
               const uint8_t* __restrict__ validrows,
               const int8_t* __restrict__ qbin, const int* __restrict__ q_cc,
               const int* __restrict__ k_ana, const int* __restrict__ k_len,
               const int* __restrict__ start_blk, uint8_t* packed_q,
               uint8_t* exact_q, int* counts_t, int* nmatch, int* nexact,
               int B, int nb_band, int bt, int qt, int at_pad, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  // query tiles vary fastest, so the blocks on the card at one time share
  // a few band blocks, which stay in L2
  const int q0 = blockIdx.x * qt;
  const int band_blk = blockIdx.y;
  resident_block<KS>(smem, bins, cc, validrows, qbin, q_cc, k_ana, k_len,
                     packed_q, exact_q, counts_t, nmatch, nexact, B, at_pad,
                     stride, nb_band, qt, q0, band_blk,
                     (start_blk[q0 / bt] + band_blk) * ROW_BLOCK);
}

// The streamed instance, at any at_pad of at least 224 (see the note at
// the top). A block whose band block's extent is at most 224 runs the
// main body; the others walk kw = their extent: step s is row chunk s / nk and k-chunk s % nk, in ring
// stage s % SSTAGE, and the accumulators carry over the chunk's k-chunks.
__global__ void __launch_bounds__(NTHREAD, 2)
stage_a_kernel_stream(const int8_t* __restrict__ bins,
                      const int* __restrict__ cc,
                      const uint8_t* __restrict__ validrows,
                      const int8_t* __restrict__ qbin,
                      const int* __restrict__ q_cc,
                      const int* __restrict__ k_ana,
                      const int* __restrict__ k_len,
                      const int* __restrict__ start_blk, uint8_t* packed_q,
                      uint8_t* exact_q, int* counts_t, int* nmatch,
                      int* nexact, int B, int nb_band, int bt, int qt,
                      const int* __restrict__ extents, int at_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.x * qt;
  // the last band blocks, the widest, first
  const int band_blk = nb_band - 1 - blockIdx.y;
  const int blk = start_blk[q0 / bt] + band_blk;
  const int row_base = blk * ROW_BLOCK;
  const int kw = block_width(extents, blk, at_pad);
  if (kw <= MAIN_WIDTH) {  // block-uniform
    resident_block<MAIN_WIDTH / 32>(smem, bins, cc, validrows, qbin, q_cc,
                                    k_ana, k_len, packed_q, exact_q,
                                    counts_t, nmatch, nexact, B, MAIN_WIDTH,
                                    at_pad, nb_band, qt, q0, band_blk,
                                    row_base);
    return;
  }
  const int qs = tile_rows(qt);
  const int stage_bytes = (int)stream_stage_bytes(qs);
  unsigned char* stages = smem;  // SSTAGE x stage
  unsigned* hit_w =
      reinterpret_cast<unsigned*>(stages + SSTAGE * stage_bytes);  // [qs][WSTRIDE]
  unsigned* ex_w = hit_w + qs * WSTRIDE;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 1, qg = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int nk = kchunks(kw), nsteps = NCHUNK * nk;

  // query rows past qt are zero in every stage (no load writes them)
  const int pad16 = (qs - qt) * SROW / 16;
  for (int i = tid; i < SSTAGE * pad16; i += NTHREAD) {
    const int s = i / pad16, j = i - s * pad16;
    *reinterpret_cast<int4*>(stages + s * stage_bytes + qt * SROW + j * 16) =
        make_int4(0, 0, 0, 0);
  }

  auto load_step = [&](int s) {
    const int chunk = s / nk, kc = s - chunk * nk;
    unsigned char* st = stages + (s % SSTAGE) * stage_bytes;
    const int r0 = row_base + chunk * CHUNK;
    const int w16 = kchunk_cols(kw, kc) / 16;
    for (int i = tid; i < (qs + CHUNK) * KPIECES; i += NTHREAD) {
      int dst;
      size_t src;
      bool from_q;
      if (stream_piece(i, qt, qs, q0, r0, at_pad, kc, w16, &dst, &src, &from_q))
        cp_async16(st + dst, (from_q ? qbin : bins) + src);
    }
    if (kc == nk - 1) {  // the chunk's charcounts and flags, for its epilogue
      unsigned char* tail = st + (qs + CHUNK) * SROW;
      if (tid < CHUNK / 4)
        cp_async16(tail + tid * 16,
                   reinterpret_cast<const uint8_t*>(cc + r0) + tid * 16);
      else if (tid < CHUNK / 4 + CHUNK / 16)
        cp_async16(tail + CHUNK * 4 + (tid - CHUNK / 4) * 16,
                   validrows + r0 + (tid - CHUNK / 4) * 16);
    }
  };

#pragma unroll
  for (int s = 0; s < SSTAGE - 1; ++s) {
    if (s < nsteps) load_step(s);
    cp_async_commit();
  }

  int kq[4], nq[4], lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    query_terms(qg * 32 + 8 * k + g, qt, q0, q_cc, k_ana, k_len, &kq[k],
                &nq[k], &lo[k], &hi[k]);
  const bool active = qg * 32 < qt;  // warp-uniform
  // ldmatrix row offsets in a stage, as in the resident instances (the band
  // rows start at stage row qs)
  const int a_off =
      (qg * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * SROW + (lane >> 4) * 16;
  const int b_off = (qs + rg * 32 + (lane & 7) + (lane >> 4) * 8) * SROW +
                    ((lane >> 3) & 1) * 16;
  const unsigned ring = (unsigned)__cvta_generic_to_shared(stages);

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  int chunk = 0, kc = 0;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<SSTAGE - 2>();
    __syncthreads();  // step s landed; the stage of step s - 1 is free
    if (s + SSTAGE - 1 < nsteps) load_step(s + SSTAGE - 1);
    cp_async_commit();
    if (active) {
      const int stage = s % SSTAGE;
      const unsigned st = ring + stage * stage_bytes;
      const int ksn = kchunk_cols(kw, kc) / 32;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        if (ks < ksn) {
          unsigned a[2][4];
          load_a(a, st + a_off, SROW, ks);
          kstep(acc, a, st + b_off, SROW, ks);
        }
      }
      if (kc == nk - 1) {
        chunk_words(acc, stages + stage * stage_bytes + (qs + CHUNK) * SROW,
                    qg, rg, g, t, chunk, kq, nq, lo, hi, hit_w, ex_w);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0;
      }
    }
    if (++kc == nk) {
      kc = 0;
      ++chunk;
    }
  }
  __syncthreads();
  block_stores(hit_w, ex_w, tid, qt, q0, band_blk, nb_band, B, packed_q,
               exact_q, counts_t, nmatch, nexact);
}

struct Args {
  const void *bins, *cc, *validrows, *qbin, *q_cc, *k_ana, *k_len, *start_blk;
  void *packed_q, *exact_q, *counts_t, *nmatch, *nexact;
  int B, nb_band, bt;
};

// One launch of `kernel` over the (query tile, band block) grid; `extra`
// are the instance's own arguments after the shared ones.
template <typename Kernel, typename... Extra>
int launch_kernel(Kernel kernel, const Args& a, int qt, size_t smem,
                  cudaStream_t stream, Extra... extra) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B / qt, a.nb_band), block(NTHREAD);
  kernel<<<grid, block, smem, stream>>>(
      (const int8_t*)a.bins, (const int*)a.cc, (const uint8_t*)a.validrows,
      (const int8_t*)a.qbin, (const int*)a.q_cc, (const int*)a.k_ana,
      (const int*)a.k_len, (const int*)a.start_blk, (uint8_t*)a.packed_q,
      (uint8_t*)a.exact_q, (int*)a.counts_t, (int*)a.nmatch, (int*)a.nexact,
      a.B, a.nb_band, a.bt, qt, extra...);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory a block of the current device may ask
// for, read once per device.
cudaError_t smem_limit(size_t& limit) {
  static int limits[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e ? e : cudaErrorInvalidDevice;
  if (!limits[dev])
    e = cudaDeviceGetAttribute(&limits[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  limit = (size_t)limits[dev];
  return e;
}
#endif

}  // namespace

// The instance (K1_MAIN 1, K1_RESIDENT 2, K1_STREAM 3; 0 where none fits)
// for a launch whose rows use `width` columns of planes at_pad wide, qt
// queries a block and a block's shared-memory limit in bytes; on the card
// a negative limit reads the current device's (and a failed read returns
// minus the CUDA error).
extern "C" int analiticcl_stage_a_route(int width, int at_pad, int qt,
                                        long long limit) {
#ifndef ANALITICCL_HOST_TEST
  if (limit < 0) {
    size_t dev_limit = 0;
    const cudaError_t e = smem_limit(dev_limit);
    if (e != cudaSuccess) return -(int)e;
    limit = (long long)dev_limit;
  }
#endif
  return k1_route(width, at_pad, qt, limit < 0 ? 0 : (size_t)limit);
}

#ifndef ANALITICCL_HOST_TEST

// bins int8 [Ni, at_pad] (at_pad % 32 == 0), cc int32 [Ni], validrows
// uint8 [Ni], qbin int8 [B, at_pad], q_cc / k_ana / k_len int32 [B],
// start_blk int32 [B / bt] with (start_blk[t] + nb_band) * 1024 <= Ni (the
// band plan clamps it so), extents int32 [Ni / 1024] (each block's
// extent, convert.block_extents). `width` (a multiple of 32 in [32,
// at_pad]) is at least the extent of every block the tiles read. Every
// plane and output pointer 16-byte aligned. nmatch / nexact must be
// zeroed by the caller. qt <= 128 divides bt, and bt divides B.
// `instance` is the one `analiticcl_stage_a_route` gives; one that does
// not fit this shape returns cudaErrorInvalidValue without a launch.
extern "C" int analiticcl_stage_a(
    const void* bins, const void* cc, const void* validrows, const void* qbin,
    const void* q_cc, const void* k_ana, const void* k_len,
    const void* start_blk, const void* extents, void* packed_q,
    void* exact_q, void* counts_t, void* nmatch, void* nexact, int B,
    int at_pad, int width, int nb_band, int bt, int qt, int instance,
    void* stream) {
  if (B <= 0 || nb_band <= 0) return 0;
  if (at_pad <= 0 || at_pad % 32 || width < 32 || width % 32 ||
      width > at_pad || qt < 1 || qt > QT_MAX || bt % qt || B % bt)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {bins, cc, validrows, qbin, packed_q, exact_q};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  if (nb_band > 65535) return (int)cudaErrorInvalidValue;  // grid y
  size_t limit = 0;
  const cudaError_t e = smem_limit(limit);
  if (e != cudaSuccess) return (int)e;
  const Args a{bins,     cc,     validrows, qbin,      q_cc,
               k_ana,    k_len,  start_blk, packed_q,  exact_q,
               counts_t, nmatch, nexact,    B,         nb_band,
               bt};
  auto st = (cudaStream_t)stream;
  if (instance == K1_MAIN) {  // the first 224 columns
    if (!main_fits(width, at_pad, limit)) return (int)cudaErrorInvalidValue;
    return launch_kernel(stage_a_kernel<MAIN_WIDTH / 32>, a, qt,
                         smem_bytes(MAIN_WIDTH), st, MAIN_WIDTH, at_pad);
  }
  if (instance == K1_RESIDENT) {  // the first `width` columns
    if (smem_bytes(width) > limit) return (int)cudaErrorInvalidValue;
    return launch_kernel(stage_a_kernel<0>, a, qt, smem_bytes(width), st,
                         width, at_pad);
  }
  if (instance == K1_STREAM) {  // each block at its own extent
    if (!stream_fits(at_pad, qt, limit)) return (int)cudaErrorInvalidValue;
    return launch_kernel(stage_a_kernel_stream, a, qt, stream_launch_smem(qt),
                         st, (const int*)extents, at_pad);
  }
  return (int)cudaErrorInvalidValue;
}
#else
namespace {
// One warp's epilogue on the host: its lanes' accumulators (32 lanes x
// NACC, fragment order) against the chunk's 64 charcounts and valid flags,
// the shfl_xor joins done in turn, and the lanes' words into the bit tiles.
void host_warp_words(const int* acc, const int* cc_c, const uint8_t* val_c,
                     int qg, int rg, int chunk, int qt, int q0,
                     const int* q_cc, const int* k_ana, const int* k_len,
                     unsigned* hit_w, unsigned* ex_w) {
  unsigned hw[32][4], ew[32][4];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    int rcc[8], kq[4], nq[4], lo[4], hi[4];
    lane_rows(cc_c, val_c, rg, t, rcc);
    for (int k = 0; k < 4; ++k)
      query_terms(qg * 32 + 8 * k + g, qt, q0, q_cc, k_ana, k_len, &kq[k],
                  &nq[k], &lo[k], &hi[k]);
    fragment_words(acc + lane * NACC, t, rcc, kq, nq, lo, hi, hw[lane],
                   ew[lane]);
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, t = lane & 3;
    unsigned h[4] = {0, 0, 0, 0}, e[4] = {0, 0, 0, 0};
    for (int k = 0; k < 4; ++k)
      for (int tt = 0; tt < 4; ++tt) {  // the shfl_xor joins
        h[k] |= hw[4 * g + tt][k];
        e[k] |= ew[4 * g + tt][k];
      }
    const int w = word_index(qg, rg, g, t, chunk);
    hit_w[w] = pick(h, t);
    ex_w[w] = pick(e, t);
  }
}

void host_block_stores(const unsigned* hit_w, const unsigned* ex_w, int qt,
                       int q0, int band_blk, int nb_band, int B,
                       uint8_t* packed_q, uint8_t* exact_q, int* counts_t,
                       int* nmatch, int* nexact) {
  const size_t bytes_per_q = (size_t)nb_band * (ROW_BLOCK / 8);
  for (int i = 0; i < qt * WORDS; ++i)
    store_mask_word(i, hit_w, ex_w, q0, band_blk, bytes_per_q, packed_q,
                    exact_q);
  for (int i = 0; i < qt * (ROW_BLOCK / 128); ++i)
    store_count(i, hit_w, qt, q0, band_blk, B, counts_t);
  for (int c = 0; c < qt; ++c) add_totals(c, hit_w, ex_w, q0, nmatch, nexact);
}
}  // namespace

// The kernel's epilogue on the host, one block and one warp at a time, from
// accumulators in fragment order: acc int32
// [B / qt][nb_band][16 chunks][8 warps][32 lanes][32] (see fragment_words;
// warp w takes queries 32 (w / 2) of the block's tile and rows 32 (w % 2) of
// the 64-row chunk, queries past qt zero). Outputs as the kernel's; nmatch / nexact
// zeroed by the caller.
extern "C" void analiticcl_stage_a_host(
    const int* acc, const int* cc, const uint8_t* validrows, const int* q_cc,
    const int* k_ana, const int* k_len, const int* start_blk,
    uint8_t* packed_q, uint8_t* exact_q, int* counts_t, int* nmatch,
    int* nexact, int B, int nb_band, int bt, int qt) {
  std::vector<unsigned> hit_w(QT_MAX * WSTRIDE), ex_w(QT_MAX * WSTRIDE);
  for (int qb = 0; qb < B / qt; ++qb)
    for (int band_blk = 0; band_blk < nb_band; ++band_blk) {
      const int q0 = qb * qt;
      const int row_base = (start_blk[q0 / bt] + band_blk) * ROW_BLOCK;
      for (int chunk = 0; chunk < NCHUNK; ++chunk)
        for (int warp = 0; warp < NWARP; ++warp) {
          const int rg = warp & 1, qg = warp >> 1;
          if (qg * 32 >= qt) continue;
          const size_t f =
              (((size_t)qb * nb_band + band_blk) * NCHUNK + chunk) * NWARP + warp;
          const int r0 = row_base + chunk * CHUNK;
          host_warp_words(acc + f * 32 * NACC, cc + r0, validrows + r0, qg,
                          rg, chunk, qt, q0, q_cc, k_ana, k_len,
                          hit_w.data(), ex_w.data());
        }
      host_block_stores(hit_w.data(), ex_w.data(), qt, q0, band_blk, nb_band,
                        B, packed_q, exact_q, counts_t, nmatch, nexact);
    }
}

// The streamed instance on the host: for each block its extent from the
// table (`block_width`), then, where it is at most 224, the main body's
// product as a scalar dot over each row chunk's first 224 columns, else
// the kernel's loop nest (row chunk x k-chunk of its extent, each step's
// pieces placed in its ring stage by `stream_piece` and step s + SSTAGE -
// 1 loaded before step s is used, over a ring that starts with stale
// bytes), each lane's accumulators summed by a scalar dot over the
// stage's rows in fragment order; either way the epilogue as the kernel
// runs it. `walk` int32 [B / qt][nb_band][2] gets each block's ring steps
// (16 chunks for the main body, 16 x kchunks(extent) streamed) and the
// plane bytes of a row its products read. Other arguments and outputs
// as `analiticcl_stage_a`'s (host pointers; at_pad at least 224, as
// `stream_fits` holds the kernel to; nmatch / nexact zeroed by the caller).
extern "C" void analiticcl_stage_a_stream_host(
    const int8_t* bins, const int* cc, const uint8_t* validrows,
    const int8_t* qbin, const int* q_cc, const int* k_ana, const int* k_len,
    const int* start_blk, const int* extents, uint8_t* packed_q,
    uint8_t* exact_q, int* counts_t, int* nmatch, int* nexact, int B,
    int at_pad, int nb_band, int bt, int qt, int* walk) {
  const int qs = tile_rows(qt);
  const size_t stage_bytes = stream_stage_bytes(qs);
  std::vector<unsigned char> ring(SSTAGE * stage_bytes);
  std::vector<unsigned> hit_w(QT_MAX * WSTRIDE), ex_w(QT_MAX * WSTRIDE);
  std::vector<int> acc(NWARP * 32 * NACC);
  // lane's accumulators: a scalar dot over `width` bytes of query and band
  // rows given by their pointers in fragment order
  auto lane_dots = [&](int warp, int lane, const int8_t* const* qrows,
                       const int8_t* const* brows, int width) {
    int* a = acc.data() + (warp * 32 + lane) * NACC;
    for (int e = 0; e < NACC; ++e) {
      int dot = 0;
      for (int c = 0; c < width; ++c) dot += qrows[e][c] * brows[e][c];
      a[e] += dot;
    }
  };
  for (int qb = 0; qb < B / qt; ++qb)
    for (int band_blk = 0; band_blk < nb_band; ++band_blk) {
      const int q0 = qb * qt;
      const int blk = start_blk[q0 / bt] + band_blk;
      const int row_base = blk * ROW_BLOCK;
      const int kw = block_width(extents, blk, at_pad);
      int* w = walk + ((size_t)qb * nb_band + band_blk) * 2;
      if (kw <= MAIN_WIDTH) {  // the main body: resident queries, 224 columns
        static const int8_t zero[MAIN_WIDTH] = {};
        for (int chunk = 0; chunk < NCHUNK; ++chunk) {
          std::fill(acc.begin(), acc.end(), 0);
          const int r0 = row_base + chunk * CHUNK;
          for (int warp = 0; warp < NWARP; ++warp) {
            const int rg = warp & 1, qg = warp >> 1;
            if (qg * 32 >= qt) continue;
            for (int lane = 0; lane < 32; ++lane) {
              const int g = lane >> 2, t = lane & 3;
              const int8_t *qr[NACC], *br[NACC];
              for (int e = 0; e < NACC; ++e) {
                const int mi = e / 16, ni = (e / 4) % 4, reg = e % 4;
                const int c = qg * 32 + 16 * mi + 8 * (reg >> 1) + g;
                qr[e] = c < qt ? qbin + (size_t)(q0 + c) * at_pad : zero;
                br[e] = bins + (size_t)(r0 + rg * 32 + 8 * ni + 2 * t +
                                        (reg & 1)) * at_pad;
              }
              lane_dots(warp, lane, qr, br, MAIN_WIDTH);
            }
            host_warp_words(acc.data() + warp * 32 * NACC, cc + r0,
                            validrows + r0, qg, rg, chunk, qt, q0, q_cc,
                            k_ana, k_len, hit_w.data(), ex_w.data());
          }
        }
        w[0] = NCHUNK;
        w[1] = MAIN_WIDTH;
        host_block_stores(hit_w.data(), ex_w.data(), qt, q0, band_blk,
                          nb_band, B, packed_q, exact_q, counts_t, nmatch,
                          nexact);
        continue;
      }
      const int nk = kchunks(kw), nsteps = NCHUNK * nk;
      std::memset(ring.data(), 0xA5, ring.size());
      for (int s = 0; s < SSTAGE; ++s)
        std::memset(ring.data() + s * stage_bytes + qt * SROW, 0,
                    (size_t)(qs - qt) * SROW);
      auto load_step = [&](int s) {
        const int chunk = s / nk, kc = s - chunk * nk;
        unsigned char* st = ring.data() + (s % SSTAGE) * stage_bytes;
        const int r0 = row_base + chunk * CHUNK;
        const int w16 = kchunk_cols(kw, kc) / 16;
        for (int i = 0; i < (qs + CHUNK) * KPIECES; ++i) {
          int dst;
          size_t src;
          bool from_q;
          if (stream_piece(i, qt, qs, q0, r0, at_pad, kc, w16, &dst, &src,
                           &from_q))
            std::memcpy(st + dst, (from_q ? qbin : bins) + src, 16);
        }
        if (kc == nk - 1) {
          unsigned char* tail = st + (qs + CHUNK) * SROW;
          std::memcpy(tail, cc + r0, CHUNK * 4);
          std::memcpy(tail + CHUNK * 4, validrows + r0, CHUNK);
        }
      };
      for (int s = 0; s < SSTAGE - 1 && s < nsteps; ++s) load_step(s);
      std::fill(acc.begin(), acc.end(), 0);
      w[0] = w[1] = 0;
      for (int s = 0; s < nsteps; ++s) {
        if (s + SSTAGE - 1 < nsteps) load_step(s + SSTAGE - 1);
        const int chunk = s / nk, kc = s - chunk * nk;
        const unsigned char* st = ring.data() + (s % SSTAGE) * stage_bytes;
        const int width = kchunk_cols(kw, kc);
        ++w[0];
        if (chunk == 0) w[1] += width;
        for (int warp = 0; warp < NWARP; ++warp) {
          const int rg = warp & 1, qg = warp >> 1;
          if (qg * 32 >= qt) continue;
          for (int lane = 0; lane < 32; ++lane) {
            const int g = lane >> 2, t = lane & 3;
            const int8_t *qr[NACC], *br[NACC];
            for (int e = 0; e < NACC; ++e) {
              const int mi = e / 16, ni = (e / 4) % 4, reg = e % 4;
              qr[e] = reinterpret_cast<const int8_t*>(
                  st + (qg * 32 + 16 * mi + 8 * (reg >> 1) + g) * SROW);
              br[e] = reinterpret_cast<const int8_t*>(
                  st + (qs + rg * 32 + 8 * ni + 2 * t + (reg & 1)) * SROW);
            }
            lane_dots(warp, lane, qr, br, width);
          }
        }
        if (kc != nk - 1) continue;
        const unsigned char* tail = st + (qs + CHUNK) * SROW;
        for (int warp = 0; warp < NWARP; ++warp) {
          const int rg = warp & 1, qg = warp >> 1;
          if (qg * 32 >= qt) continue;
          host_warp_words(acc.data() + warp * 32 * NACC,
                          reinterpret_cast<const int*>(tail), tail + CHUNK * 4,
                          qg, rg, chunk, qt, q0, q_cc, k_ana, k_len,
                          hit_w.data(), ex_w.data());
        }
        std::fill(acc.begin(), acc.end(), 0);
      }
      host_block_stores(hit_w.data(), ex_w.data(), qt, q0, band_blk, nb_band,
                        B, packed_q, exact_q, counts_t, nmatch, nexact);
    }
}
#endif
