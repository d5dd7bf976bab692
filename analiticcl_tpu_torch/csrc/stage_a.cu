// Stage A on Hopper: charcount-banded L1-ball retrieval masks.
//
// Replaces the TPU kernel `_stage_a_kernel` in analiticcl_tpu/ops/stage_a.py
// (line 88, launched by `stage_a_masks_pallas`), and matches
// `stage_a_masks_xla` bit for bit, `validrows` included. For each query q and
// band row r:
//   L1    = cc[row] + q_cc[q] - 2 * dot(bins[row], qbin[q])  (int8 planes)
//   hit   = L1 <= k_ana[q] && |cc[row] - q_cc[q]| <= k_len[q] && valid[row]
//   exact = L1 == 0 && valid[row]
// with row = start_blk[q / bt] * 1024 + r. Outputs are banded and
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
// long lexicon entries) take 64 queries a block from AT 608 and 32 from
// AT 832, so that the planes, the ring and the bit tiles still fit the
// block's 227 KB; above AT 960 nothing fits and the launch refuses.
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
// arithmetic is checked on a machine without a card.

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

// Query rows a block holds in shared memory (planes, bit tiles): its qt
// queries rounded up to whole warp query groups of 32.
HDFN int tile_rows(int qt) { return (qt + 31) & ~31; }

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

// w[t] without a dynamically indexed array
DEVFN unsigned pick(const unsigned* w, int t) {
  return (t & 2) ? ((t & 1) ? w[3] : w[2]) : ((t & 1) ? w[1] : w[0]);
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

// KS > 0: at_pad == 32 * KS, and each warp keeps its queries' A fragments
// in registers for the whole block (2 x 4 x KS of them); KS == 0: any
// at_pad, A fragments reloaded by ldmatrix at every k-step.
template <int KS, int QS>
__global__ void __launch_bounds__(NTHREAD, 2)
stage_a_kernel(const int8_t* __restrict__ bins, const int* __restrict__ cc,
               const uint8_t* __restrict__ validrows,
               const int8_t* __restrict__ qbin, const int* __restrict__ q_cc,
               const int* __restrict__ k_ana, const int* __restrict__ k_len,
               const int* __restrict__ start_blk, uint8_t* packed_q,
               uint8_t* exact_q, int* counts_t, int* nmatch, int* nexact,
               int B, int at_pad, int nb_band, int bt, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rstride = at_pad + 16;  // bytes per plane row in shared memory
  const int stage_bytes = CHUNK * rstride + CHUNK * 4 + CHUNK;
  const int qs = QS ? QS : tile_rows(qt);  // QS 0: wide planes
  unsigned char* q_s = smem;                          // [qs][rstride]
  unsigned char* stages = q_s + qs * rstride;         // NSTAGE x stage
  unsigned* hit_w =
      reinterpret_cast<unsigned*>(stages + NSTAGE * stage_bytes);  // [qs][WSTRIDE]
  unsigned* ex_w = hit_w + qs * WSTRIDE;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 1, qg = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  // query tiles vary fastest, so the blocks on the card at one time share
  // a few band blocks, which stay in L2
  const int q0 = blockIdx.x * qt;
  const int band_blk = blockIdx.y;
  const int row_base = (start_blk[q0 / bt] + band_blk) * ROW_BLOCK;
  const int at16 = at_pad / 16;

  auto load_chunk = [&](int chunk) {
    unsigned char* st = stages + (chunk % NSTAGE) * stage_bytes;
    const int r0 = row_base + chunk * CHUNK;
    const int8_t* src = bins + (size_t)r0 * at_pad;
    for (int i = tid; i < CHUNK * at16; i += NTHREAD) {
      const int row = i / at16, col = i - row * at16;
      cp_async16(st + row * rstride + col * 16, src + (size_t)row * at_pad + col * 16);
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
      v = reinterpret_cast<const int4*>(qbin + (size_t)(q0 + c) * at_pad)[col];
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
  const int ksteps = at_pad / 32;
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

// Dynamic shared memory of a block holding `rows` query rows.
size_t smem_bytes(int at_pad, int rows) {
  const size_t rstride = (size_t)at_pad + 16;
  return rows * rstride + NSTAGE * (CHUNK * rstride + CHUNK * 4 + CHUNK) +
         2 * sizeof(unsigned) * rows * WSTRIDE;
}

template <int KS, int QS>
int launch_q(const void* bins, const void* cc, const void* validrows,
             const void* qbin, const void* q_cc, const void* k_ana,
             const void* k_len, const void* start_blk, void* packed_q,
             void* exact_q, void* counts_t, void* nmatch, void* nexact, int B,
             int at_pad, int nb_band, int bt, int qt, cudaStream_t stream) {
  const size_t smem = smem_bytes(at_pad, QS ? QS : tile_rows(qt));
  cudaError_t e = cudaFuncSetAttribute(
      stage_a_kernel<KS, QS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B / qt, nb_band), block(NTHREAD);
  stage_a_kernel<KS, QS><<<grid, block, smem, stream>>>(
      (const int8_t*)bins, (const int*)cc, (const uint8_t*)validrows,
      (const int8_t*)qbin, (const int*)q_cc, (const int*)k_ana,
      (const int*)k_len, (const int*)start_blk, (uint8_t*)packed_q,
      (uint8_t*)exact_q, (int*)counts_t, (int*)nmatch, (int*)nexact, B, at_pad,
      nb_band, bt, qt);
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

template <int KS>
int launch(const void* bins, const void* cc, const void* validrows,
           const void* qbin, const void* q_cc, const void* k_ana,
           const void* k_len, const void* start_blk, void* packed_q,
           void* exact_q, void* counts_t, void* nmatch, void* nexact, int B,
           int at_pad, int nb_band, int bt, int qt, cudaStream_t stream) {
  size_t limit = 0;
  const cudaError_t e = smem_limit(limit);
  if (e != cudaSuccess) return (int)e;
  if (KS > 0 || smem_bytes(at_pad, QT_MAX) <= limit)
    return launch_q<KS, QT_MAX>(bins, cc, validrows, qbin, q_cc, k_ana,
                                k_len, start_blk, packed_q, exact_q,
                                counts_t, nmatch, nexact, B, at_pad, nb_band,
                                bt, qt, stream);
  // wide planes (a lexicon whose entries hold many of one character): fewer
  // queries a block, so that their planes and bit tiles still fit
  while (smem_bytes(at_pad, tile_rows(qt)) > limit && qt > 32 && qt % 2 == 0)
    qt /= 2;
  if (smem_bytes(at_pad, tile_rows(qt)) > limit)
    return (int)cudaErrorInvalidValue;
  return launch_q<0, 0>(bins, cc, validrows, qbin, q_cc, k_ana, k_len,
                        start_blk, packed_q, exact_q, counts_t, nmatch,
                        nexact, B, at_pad, nb_band, bt, qt, stream);
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// bins int8 [Ni, at_pad] (at_pad % 32 == 0), cc int32 [Ni], validrows
// uint8 [Ni], qbin int8 [B, at_pad], q_cc / k_ana / k_len int32 [B],
// start_blk int32 [B / bt] with (start_blk[t] + nb_band) * 1024 <= Ni (the
// band plan clamps it so). Every pointer 16-byte aligned. nmatch / nexact
// must be zeroed by the caller. qt <= 128 divides bt, and bt divides B.
extern "C" int analiticcl_stage_a(
    const void* bins, const void* cc, const void* validrows, const void* qbin,
    const void* q_cc, const void* k_ana, const void* k_len,
    const void* start_blk, void* packed_q, void* exact_q, void* counts_t,
    void* nmatch, void* nexact, int B, int at_pad, int nb_band, int bt, int qt,
    void* stream) {
  if (B <= 0 || nb_band <= 0) return 0;
  if (at_pad <= 0 || at_pad % 32 || qt < 1 || qt > QT_MAX || bt % qt || B % bt)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {bins, cc, validrows, qbin, packed_q, exact_q};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  if (nb_band > 65535) return (int)cudaErrorInvalidValue;  // grid y
  auto st = (cudaStream_t)stream;
  if (at_pad == 7 * 32)  // the main path's 210 planes, padded
    return launch<7>(bins, cc, validrows, qbin, q_cc, k_ana, k_len, start_blk,
                     packed_q, exact_q, counts_t, nmatch, nexact, B, at_pad,
                     nb_band, bt, qt, st);
  return launch<0>(bins, cc, validrows, qbin, q_cc, k_ana, k_len, start_blk,
                   packed_q, exact_q, counts_t, nmatch, nexact, B, at_pad,
                   nb_band, bt, qt, st);
}
#else
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
  const size_t bytes_per_q = (size_t)nb_band * (ROW_BLOCK / 8);
  for (int qb = 0; qb < B / qt; ++qb)
    for (int band_blk = 0; band_blk < nb_band; ++band_blk) {
      const int q0 = qb * qt;
      const int row_base = (start_blk[q0 / bt] + band_blk) * ROW_BLOCK;
      for (int chunk = 0; chunk < NCHUNK; ++chunk)
        for (int warp = 0; warp < NWARP; ++warp) {
          const int rg = warp & 1, qg = warp >> 1;
          if (qg * 32 >= qt) continue;
          unsigned hw[32][4], ew[32][4];
          for (int lane = 0; lane < 32; ++lane) {
            const int g = lane >> 2, t = lane & 3;
            int rcc[8], kq[4], nq[4], lo[4], hi[4];
            for (int r = 0; r < 8; ++r) {
              const int row = row_base + chunk * CHUNK + rg * 32 +
                              8 * (r >> 1) + 2 * t + (r & 1);
              rcc[r] = row_term(cc[row], validrows[row] != 0);
            }
            for (int k = 0; k < 4; ++k)
              query_terms(qg * 32 + 8 * k + g, qt, q0, q_cc, k_ana, k_len,
                          &kq[k], &nq[k], &lo[k], &hi[k]);
            const size_t f =
                ((((size_t)qb * nb_band + band_blk) * NCHUNK + chunk) * NWARP + warp) * 32 + lane;
            fragment_words(acc + f * NACC, t, rcc, kq, nq, lo, hi, hw[lane],
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
            const int w = (qg * 32 + 8 * t + g) * WSTRIDE + chunk * 2 + rg;
            hit_w[w] = pick(h, t);
            ex_w[w] = pick(e, t);
          }
        }
      for (int i = 0; i < qt * WORDS; ++i)
        store_mask_word(i, hit_w.data(), ex_w.data(), q0, band_blk,
                        bytes_per_q, packed_q, exact_q);
      for (int i = 0; i < qt * (ROW_BLOCK / 128); ++i)
        store_count(i, hit_w.data(), qt, q0, band_blk, B, counts_t);
      for (int c = 0; c < qt; ++c)
        add_totals(c, hit_w.data(), ex_w.data(), q0, nmatch, nexact);
    }
}
#endif
