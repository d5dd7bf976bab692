// The slot resolve of the query core on Hopper (kernel K3): stage A's hit
// bits expanded into the P pair slots of stage B.
//
// Replaces the JAX core's slot resolve, XLA glue between its two Pallas
// calls (analiticcl_tpu/ops/pipeline.py:450-592 in `_query_core`), which the
// port ran as torch ops (`resolve_pairs_plain` in ops/pipeline.py). Slot s
// holds the (s + 1)-th stage-A hit in query-major, then band-row order, the
// reference's gather order: the query q, its band row pc_band, the device
// row pc = start_blk[q / bt] * ROW_BLOCK + pc_band and valid = 1. Hits past
// P are dropped; the total still counts them. A slot past the total gets
// valid = 0 and the values the plain version gives it (the last query, the
// last band row of its band), which keep every later index in range.
//
// Design: expand, don't search, in one launch. The plain version searches
// for each slot's 128-row block in a cumsum over all B x M_band block
// counts and ranks the slot's bit inside the block. Here a block of
// QT_WARPS warps takes QT_WARPS consecutive queries, a warp each:
// - Its first slot: every block sums stage A's per-query totals `nmatch`
//   below its first query (and all of them, the total) itself; B is a few
//   thousand, so this costs a few coalesced loads a thread and no second
//   launch or grid-wide scan.
// - The block counts: `counts_t` is [M_band, B], so the block reads it
//   along its contiguous axis, CHUNK rows of its QT_WARPS columns at a time
//   (one 32-byte sector a row), into shared memory, double-buffered: the
//   next chunk's loads are in flight while the warps expand this one, and a
//   chunk costs one block barrier. A warp walks its query's column in rows
//   of 32 blocks, a lane each (the padded pitch keeps the reads free of
//   bank conflicts), and a shuffle scan per row gives each block its first
//   slot.
// - The expansion: each lane takes its own blocks, ROWS of a chunk: it
//   loads the 16 bytes of hit bits of each of them that is non-empty and
//   starts below P at once (one latency for the chunk, not one per block),
//   then writes each set bit's slot in band-row order. Stage A's hits are
//   sparse, a few per non-empty block, so a lane's loop is short. Measured
//   on the H100 (tools/k3_compare.py), these variants were no faster:
//   blocks of 4 or 16 queries, chunks of 256 blocks, the whole band's
//   counts in two chunks with each warp's non-empty blocks listed and
//   their bits loaded in one batch; handing the blocks of more than 6 hits
//   to the whole warp, a nibble a lane, was 1.6x slower.
// - The tail: every block writes a grid-stride share of the slots'
//   validity and the fixed values of the slots past the total; the warps
//   write only slots below it, so no slot is written twice.
//
// What bounds it on the H100: bytes. It reads the block counts (4 B x
// M_band x B) once and the 16 bytes of each non-empty block, and writes 13
// bytes per slot; its arithmetic is a few operations per hit. The
// per-block sums of `nmatch` read B x 4 bytes a block, from L2.

// With -DANALITICCL_HOST_TEST the per-block writes, the slot values and
// the tiles' arithmetic compile as plain C++, driven by a sequential walk
// of the same tiles, chunks and prefix sums that stands in for the warps
// (for checking the arithmetic on a machine without a card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>

#include <algorithm>
#define HDFN __host__ __device__ __forceinline__
#else
#include <cstddef>
#define HDFN inline
#endif

namespace {

constexpr int HIT_BLOCK = 128;                 // band rows per count
constexpr int BLOCK_BYTES = HIT_BLOCK / 8;     // bytes of hit bits per count
constexpr int ROW_BLOCK = 1024;                // band-start granularity
constexpr int QT_WARPS = 8;                    // queries per block, a warp each
constexpr int THREADS = QT_WARPS * 32;
constexpr int ROWS = 4;                        // rows of 32 blocks per chunk
constexpr int CHUNK = 32 * ROWS;               // block counts per chunk
constexpr int PER_THREAD = CHUNK * QT_WARPS / THREADS;  // counts a thread loads
static_assert(CHUNK * QT_WARPS % THREADS == 0, "whole loads a thread");

struct Slots {
  int* q;
  int* pc_band;
  int* pc;
  unsigned char* valid;
};

// The index of the lowest set bit of x (x != 0).
HDFN int lowest_bit(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Write the set bits of the 128-row block `blk` (its 16 bytes `bits`, as
// four little-endian words) into the slots from `slot` on, in band-row
// order; slots at or past P are dropped.
HDFN void write_block(const unsigned* words, long long slot, int q, int blk,
                      int row0, int P, Slots out) {
  for (int w = 0; w < BLOCK_BYTES / 4 && slot < P; ++w) {
    for (unsigned x = words[w]; x && slot < P; x &= x - 1, ++slot) {
      const int row = blk * HIT_BLOCK + 32 * w + lowest_bit(x);
      out.q[slot] = q;
      out.pc_band[slot] = row;
      out.pc[slot] = row0 + row;
    }
  }
}

// Slot s's validity, and a slot past the total's values: the last query and
// the last band row of its band, as the plain version's clamped search
// gives them.
HDFN void write_tail(long long s, long long total, int B, int Nb,
                     int last_row0, Slots out) {
  out.valid[s] = s < total;
  if (s >= total) {
    out.q[s] = B - 1;
    out.pc_band[s] = Nb - 1;
    out.pc[s] = last_row0 + Nb - 1;
  }
}

// The block count the j-th load of thread t brings for the chunk from
// block row m0: its index i = t + j * THREADS is row m0 + i / QT_WARPS of
// the tile's column i % QT_WARPS (0 past the edges).
HDFN int chunk_count(const int* counts_t, int m0, int i, int q0, int B,
                     int M_band) {
  const int m = m0 + i / QT_WARPS, col = q0 + i % QT_WARPS;
  return m < M_band && col < B ? counts_t[(size_t)m * B + col] : 0;
}

// The grid: a block per tile of QT_WARPS queries, and more (up to 512)
// where the slots would leave a block over 1,024 tail slots.
HDFN int grid_blocks(int B, int P) {
  const int tiles = (B + QT_WARPS - 1) / QT_WARPS;
  const long long tail = ((long long)P + 4 * THREADS - 1) / (4 * THREADS);
  return tail > tiles ? (int)(tail < 512 ? tail : 512) : tiles;
}

#ifndef ANALITICCL_HOST_TEST
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Inclusive prefix sum across the warp.
__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
resolve_kernel(const unsigned char* __restrict__ packed_q,
               const int* __restrict__ counts_t,
               const int* __restrict__ nmatch,
               const int* __restrict__ start_blk, int B, int M_band, int bt,
               int P, Slots out, long long* __restrict__ total_out) {
  // the chunk's counts, column by column (a column's rows of 32 are read
  // by a warp); the pitch's + 1 spreads the stores over the banks
  __shared__ int s_cnt[2][QT_WARPS][CHUNK + 1];
  __shared__ long long s_red[2][QT_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * QT_WARPS;
  const int Nb = M_band * HIT_BLOCK;

  // the tile's first chunk of counts is in flight during the sums
  int next[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    next[j] = chunk_count(counts_t, 0, t + j * THREADS, q0, B, M_band);

  // the hits of the queries below the tile, and of all of them
  long long pre = 0, all = 0;
  for (int i = t; i < B; i += THREADS) {
    const int v = nmatch[i];
    all += v;
    if (i < q0) pre += v;
  }
  pre = warp_sum(pre);
  all = warp_sum(all);
  if (lane == 0) {
    s_red[0][warp] = pre;
    s_red[1][warp] = all;
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = t + j * THREADS;
    s_cnt[0][i % QT_WARPS][i / QT_WARPS] = next[j];
  }
  __syncthreads();
  pre = all = 0;
#pragma unroll
  for (int w = 0; w < QT_WARPS; ++w) {
    pre += s_red[0][w];
    all += s_red[1][w];
  }
  if (blockIdx.x == 0 && t == 0) *total_out = all;

  // this block's share of every slot's validity and of the slots past the
  // total (stores only: nothing below waits for them)
  const int last_row0 = start_blk[(B - 1) / bt] * ROW_BLOCK;
  for (long long s = (long long)blockIdx.x * THREADS + t; s < P;
       s += (long long)gridDim.x * THREADS)
    write_tail(s, all, B, Nb, last_row0, out);
  if (q0 >= B || pre >= P) return;  // uniform: no slot of this tile

  // the warp's query and its first slot (uniform in the warp)
  const int q = q0 + warp;
  const bool live = q < B;
  long long off = pre;
  for (int j = q0; j < q; ++j) off += nmatch[j];
  const int row0 = live ? start_blk[q / bt] * ROW_BLOCK : 0;
  const uint4* const bits = reinterpret_cast<const uint4*>(
      packed_q + (size_t)(live ? q : 0) * M_band * BLOCK_BYTES);

  for (int k = 0, m0 = 0; m0 < M_band; ++k, m0 += CHUNK) {
    const bool more = m0 + CHUNK < M_band;
    if (more) {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        next[j] = chunk_count(counts_t, m0 + CHUNK, t + j * THREADS, q0, B,
                              M_band);
    }
    if (live && off < P) {
      // each lane's block of each row of 32: its count and first slot
      long long first[ROWS];
      int cnt[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int c = s_cnt[k & 1][warp][r * 32 + lane];
        const int incl = warp_incl_scan(c, lane);
        first[r] = off + incl - c;
        cnt[r] = c > 0 && first[r] < P ? c : 0;
        off += __shfl_sync(FULL, incl, 31);
      }
      uint4 b[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (cnt[r]) b[r] = bits[m0 + r * 32 + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (!cnt[r]) continue;
        const unsigned words[4] = {b[r].x, b[r].y, b[r].z, b[r].w};
        write_block(words, first[r], q, m0 + r * 32 + lane, row0, P, out);
      }
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = t + j * THREADS;
        s_cnt[(k + 1) & 1][i % QT_WARPS][i / QT_WARPS] = next[j];
      }
    }
    __syncthreads();
  }
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// packed_q: uint8 [B, M_band * 16]; counts_t: int32 [M_band, B]; nmatch:
// int32 [B] (the column sums of counts_t); start_blk: int32 [B / bt].
// Outputs: q, pc_band, pc int32 [P], valid uint8 [P], total int64 [1].
// One launch on `stream`.
extern "C" int analiticcl_resolve(const void* packed_q, const void* counts_t,
                                  const void* nmatch, const void* start_blk,
                                  void* q, void* pc_band, void* pc,
                                  void* valid, void* total, int B, int M_band,
                                  int bt, int P, void* stream) {
  if (B < 1 || M_band < 1 || bt < 1 || B % bt || P < 0)
    return (int)cudaErrorInvalidValue;
  Slots out{(int*)q, (int*)pc_band, (int*)pc, (unsigned char*)valid};
  resolve_kernel<<<grid_blocks(B, P), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)packed_q, (const int*)counts_t,
      (const int*)nmatch, (const int*)start_blk, B, M_band, bt, P, out,
      (long long*)total);
  return (int)cudaGetLastError();
}
#else
// The same slots on the host: the kernel's tiles, chunks, rows of 32 and
// prefix sums walked in order, warp by warp and lane by lane, with its
// lanes' block writes and its tail values.
extern "C" void analiticcl_resolve_host(const unsigned char* packed_q,
                                        const int* counts_t,
                                        const int* nmatch,
                                        const int* start_blk, int* q,
                                        int* pc_band, int* pc,
                                        unsigned char* valid,
                                        long long* total, int B, int M_band,
                                        int bt, int P) {
  Slots out{q, pc_band, pc, valid};
  const int Nb = M_band * HIT_BLOCK;
  const int last_row0 = start_blk[(B - 1) / bt] * ROW_BLOCK;
  const int grid = grid_blocks(B, P);
  for (int blk_i = 0; blk_i < grid; ++blk_i) {
    const int q0 = blk_i * QT_WARPS;
    long long pre = 0, all = 0;
    for (int i = 0; i < B; ++i) {
      all += nmatch[i];
      if (i < q0) pre += nmatch[i];
    }
    if (blk_i == 0) *total = all;
    for (long long s = (long long)blk_i * THREADS; s < P;
         s += (long long)grid * THREADS)
      for (long long u = s; u < s + THREADS && u < P; ++u)
        write_tail(u, all, B, Nb, last_row0, out);
    if (q0 >= B || pre >= P) continue;
    for (int warp = 0; warp < QT_WARPS && q0 + warp < B; ++warp) {
      const int qi = q0 + warp;
      long long off = pre;
      for (int j = q0; j < qi; ++j) off += nmatch[j];
      const int row0 = start_blk[qi / bt] * ROW_BLOCK;
      const unsigned char* bits = packed_q + (size_t)qi * M_band * BLOCK_BYTES;
      for (int m0 = 0; m0 < M_band && off < P; m0 += CHUNK) {
        for (int r = 0; r < ROWS; ++r) {
          long long first = off;  // the lanes' exclusive scan, in order
          for (int lane = 0; lane < 32; ++lane) {
            const int m = r * 32 + lane;  // the count's place in the chunk
            const int c =
                chunk_count(counts_t, m0, m * QT_WARPS + warp, q0, B, M_band);
            if (c > 0 && first < P) {
              const int blk = m0 + m;
              unsigned words[4];
              for (int w = 0; w < 4; ++w) {
                const unsigned char* b4 =
                    bits + (size_t)blk * BLOCK_BYTES + 4 * w;
                words[w] = b4[0] | b4[1] << 8 | b4[2] << 16 |
                           (unsigned)b4[3] << 24;
              }
              write_block(words, first, qi, blk, row0, P, out);
            }
            first += c;
          }
          off = first;
        }
      }
    }
  }
}
#endif
