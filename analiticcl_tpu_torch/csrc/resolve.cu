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
// Design: expand, don't search. The plain version searches for each slot's
// 128-row block in a cumsum over all B x M_band block counts and ranks the
// slot's bit inside the block. Here each query's first slot is one
// exclusive scan over stage A's per-query totals `nmatch` (launch 1, one
// block), and then one block per query (launch 2) scans the query's column
// of `counts_t` for each block's first slot and writes the set bits of every
// non-empty block straight into their slots: one warp per 128-row block,
// each lane a nibble of its 16 bytes, the nibble's slot offset a prefix sum
// of `__popc` across the warp. Extra blocks of launch 2 write the validity
// of every slot and the fixed values of the slots past the total; the query
// blocks write only slots below it, so no slot is written twice.
//
// What bounds it on the H100: bytes. It reads the column counts (4 B x
// M_band bytes) and the 16 bytes of each non-empty block, and writes 13
// bytes per slot; its arithmetic is a few operations per hit.

// With -DANALITICCL_HOST_TEST the per-nibble writes and the slot values
// compile as plain C++, driven by a sequential walk that stands in for the
// warps (for checking the arithmetic on a machine without a card).
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
constexpr int NIBBLES = HIT_BLOCK / 4;         // one per lane of a warp

struct Slots {
  int* q;
  int* pc_band;
  int* pc;
  unsigned char* valid;
};

// The 4 hit bits of nibble `lane` of a 128-row block (band rows
// 4 * lane .. 4 * lane + 3 of the block).
HDFN unsigned nibble_of(const unsigned char* block_bits, int lane) {
  return (block_bits[lane >> 1] >> ((lane & 1) * 4)) & 0xFu;
}

// Write the set bits of `nib` into the slots from `slot` on, in band-row
// order; `row` is the band row of the nibble's bit 0. Slots at or past P
// are dropped.
HDFN void write_nibble(unsigned nib, long long slot, int q, int row, int row0,
                       int P, Slots out) {
  for (int k = 0; k < 4; ++k) {
    if (!((nib >> k) & 1u)) continue;
    if (slot < P) {
      out.q[slot] = q;
      out.pc_band[slot] = row + k;
      out.pc[slot] = row0 + row + k;
    }
    ++slot;
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

#ifndef ANALITICCL_HOST_TEST
constexpr int SCAN_THREADS = 1024;
constexpr int EXPAND_THREADS = 256;
constexpr int TAIL_BLOCKS_MAX = 512;

// Exclusive prefix sum of `v` over the block's threads; `*total` gets the
// block's sum. `sh` holds one entry per warp.
template <int THREADS>
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* sh,
                                                          long long* total) {
  constexpr int NWARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < NWARPS ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NWARPS) sh[lane] = w;
  }
  __syncthreads();
  const long long ex = x - v + (warp > 0 ? sh[warp - 1] : 0);
  *total = sh[NWARPS - 1];
  __syncthreads();  // sh is reused by the next call
  return ex;
}

// Launch 1: each query's first slot (the exclusive scan of nmatch) and the
// hit total. One block; each thread sums a contiguous run of queries.
__global__ void __launch_bounds__(SCAN_THREADS)
resolve_scan_kernel(const int* __restrict__ nmatch, int B,
                    long long* __restrict__ base, long long* __restrict__ total) {
  __shared__ long long sh[SCAN_THREADS / 32];
  const int per = (B + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(B, (int)threadIdx.x * per), hi = min(B, lo + per);
  long long s = 0;
  for (int i = lo; i < hi; ++i) s += nmatch[i];
  long long all;
  long long ex = block_exclusive_scan<SCAN_THREADS>(s, sh, &all);
  for (int i = lo; i < hi; ++i) {
    base[i] = ex;
    ex += nmatch[i];
  }
  if (threadIdx.x == 0) *total = all;
}

// Launch 2: blocks 0 .. B-1 expand query blockIdx.x's hits; the blocks
// after them write every slot's validity and the slots past the total.
__global__ void __launch_bounds__(EXPAND_THREADS)
resolve_expand_kernel(const unsigned char* __restrict__ packed_q,
                      const int* __restrict__ counts_t,
                      const long long* __restrict__ base,
                      const long long* __restrict__ total,
                      const int* __restrict__ start_blk, int B, int M_band,
                      int bt, int P, Slots out) {
  constexpr int NWARPS = EXPAND_THREADS / 32;
  const int Nb = M_band * HIT_BLOCK;
  if ((int)blockIdx.x >= B) {
    const long long tot = *total;
    const int last_row0 = start_blk[(B - 1) / bt] * ROW_BLOCK;
    const long long stride = (long long)(gridDim.x - B) * EXPAND_THREADS;
    for (long long s = (long long)(blockIdx.x - B) * EXPAND_THREADS +
                       threadIdx.x;
         s < P; s += stride)
      write_tail(s, tot, B, Nb, last_row0, out);
    return;
  }
  __shared__ long long sh[NWARPS];
  __shared__ int s_cnt[EXPAND_THREADS];
  __shared__ long long s_off[EXPAND_THREADS];
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = start_blk[q / bt] * ROW_BLOCK;
  const unsigned char* bits = packed_q + (size_t)q * M_band * BLOCK_BYTES;
  long long off = base[q];  // the same in every thread: the loop is uniform
  for (int m0 = 0; m0 < M_band && off < P; m0 += EXPAND_THREADS) {
    const int m = m0 + (int)threadIdx.x;
    const int c = m < M_band ? counts_t[(size_t)m * B + q] : 0;
    long long chunk;
    const long long ex = block_exclusive_scan<EXPAND_THREADS>(c, sh, &chunk);
    s_cnt[threadIdx.x] = c;
    s_off[threadIdx.x] = off + ex;
    __syncthreads();
    for (int k = warp; k < EXPAND_THREADS; k += NWARPS) {
      if (s_cnt[k] == 0 || s_off[k] >= P) continue;  // uniform in the warp
      const int blk = m0 + k;
      const unsigned nib = nibble_of(bits + (size_t)blk * BLOCK_BYTES, lane);
      const int n = __popc(nib);
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      write_nibble(nib, s_off[k] + incl - n, q, blk * HIT_BLOCK + 4 * lane,
                   row0, P, out);
    }
    off += chunk;
    __syncthreads();  // s_cnt and s_off are rewritten next round
  }
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// packed_q: uint8 [B, M_band * 16]; counts_t: int32 [M_band, B]; nmatch:
// int32 [B] (the column sums of counts_t); start_blk: int32 [B / bt].
// Outputs: q, pc_band, pc int32 [P], valid uint8 [P], total int64 [1];
// base: int64 [B] scratch. Two launches on `stream`.
extern "C" int analiticcl_resolve(const void* packed_q, const void* counts_t,
                                  const void* nmatch, const void* start_blk,
                                  void* q, void* pc_band, void* pc,
                                  void* valid, void* total, void* base, int B,
                                  int M_band, int bt, int P, void* stream) {
  if (B < 1 || M_band < 1 || bt < 1 || B % bt || P < 0)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  resolve_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      (const int*)nmatch, B, (long long*)base, (long long*)total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tail = (int)std::min<long long>(
      TAIL_BLOCKS_MAX, ((long long)P + EXPAND_THREADS - 1) / EXPAND_THREADS);
  Slots out{(int*)q, (int*)pc_band, (int*)pc, (unsigned char*)valid};
  resolve_expand_kernel<<<B + std::max(tail, 1), EXPAND_THREADS, 0, st>>>(
      (const unsigned char*)packed_q, (const int*)counts_t,
      (const long long*)base, (const long long*)total,
      (const int*)start_blk, B, M_band, bt, P, out);
  return (int)cudaGetLastError();
}
#else
// The same slots on the host: the kernel's nibble writes and tail values,
// the warps' prefix sums and the block scans walked in order.
extern "C" void analiticcl_resolve_host(const unsigned char* packed_q,
                                        const int* counts_t,
                                        const int* nmatch,
                                        const int* start_blk, int* q,
                                        int* pc_band, int* pc,
                                        unsigned char* valid,
                                        long long* total, int B, int M_band,
                                        int bt, int P) {
  Slots out{q, pc_band, pc, valid};
  long long off = 0;
  for (int qi = 0; qi < B; ++qi) {
    const int row0 = start_blk[qi / bt] * ROW_BLOCK;
    const unsigned char* bits = packed_q + (size_t)qi * M_band * BLOCK_BYTES;
    long long blk_off = off;
    for (int m = 0; m < M_band && blk_off < P; ++m) {
      const int c = counts_t[(size_t)m * B + qi];
      if (c > 0) {
        long long slot = blk_off;
        for (int lane = 0; lane < NIBBLES; ++lane) {
          const unsigned nib = nibble_of(bits + (size_t)m * BLOCK_BYTES, lane);
          write_nibble(nib, slot, qi, m * HIT_BLOCK + 4 * lane, row0, P, out);
          slot += __builtin_popcount(nib);
        }
      }
      blk_off += c;
    }
    off += nmatch[qi];
  }
  *total = off;
  const int last_row0 = start_blk[(B - 1) / bt] * ROW_BLOCK;
  for (long long s = 0; s < P; ++s)
    write_tail(s, off, B, M_band * HIT_BLOCK, last_row0, out);
}
#endif
