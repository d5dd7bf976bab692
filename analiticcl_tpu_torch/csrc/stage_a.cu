// Stage A on Hopper: charcount-banded L1-ball retrieval masks.
//
// Replaces the TPU kernel `_stage_a_kernel` in analiticcl_tpu/ops/stage_a.py
// (launched by `stage_a_masks_pallas`), and matches `stage_a_masks_xla` bit
// for bit, `validrows` included. For each query q and band row r:
//   L1    = cc[row] + q_cc[q] - 2 * dot(bins[row], qbin[q])  (int8 planes)
//   hit   = L1 <= k_ana[q] && |cc[row] - q_cc[q]| <= k_len[q] && valid[row]
//   exact = L1 == 0 && valid[row]
// with row = start_blk[q / bt] * 1024 + r. Outputs are banded and
// query-major: packed_q / exact_q uint8 [B, Nb/8] (bit k of byte j is band
// row 8j + k), counts_t int32 [Nb/128, B] (hits per 128 band rows), and the
// per-query totals nmatch / nexact int32 [B].
//
// Design: a block takes QT <= 32 queries (one query per lane; QT divides the
// band tile bt, so the block's queries share one band start) and one
// 1024-row band block, walked in chunks of 128 rows. Each chunk's int8
// planes are staged in shared memory; each of the 8 warps takes 16 rows,
// and each lane takes the dot products of its query with those rows by
// __dp4a, four planes at a time. The rows are read by all lanes at once
// (a shared-memory broadcast); the query planes sit in shared memory with an
// odd word stride, so the lanes' reads hit 32 distinct banks. A lane's 16
// hits form one little-endian uint16, which is exactly two bytes of the
// packed layout. Per-128-row counts come from __popc summed across the
// warps in shared memory. The TPU kernel carried nmatch / nexact across its
// sequential band axis; CUDA blocks run in no order, so each block adds
// its partial sums with one int32 atomicAdd per query (exact in any order).
//
// What bounds it on the H100: the dp4a issue rate (B * Nb * AT / 4
// instructions) and the band's planes re-read from L2 once per query
// group. Tensor cores (an int8 wgmma tile with the planes as operands) are
// the later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_BLOCK = 1024;
constexpr int CHUNK = 128;
constexpr int NWARP = 8;
constexpr int ROWS_PER_WARP = CHUNK / NWARP;  // 16: one uint16 of hit bits

__global__ void __launch_bounds__(NWARP * 32)
stage_a_kernel(const int8_t* __restrict__ bins, const int* __restrict__ cc,
               const uint8_t* __restrict__ validrows,
               const int8_t* __restrict__ qbin, const int* __restrict__ q_cc,
               const int* __restrict__ k_ana, const int* __restrict__ k_len,
               const int* __restrict__ start_blk, uint8_t* packed_q,
               uint8_t* exact_q, int* counts_t, int* nmatch, int* nexact,
               int B, int at_pad, int nb_band, int bt, int qt) {
  extern __shared__ int smem[];
  const int at4 = at_pad / 4;  // 32-bit words per plane row
  const int qstride = at4 + 1;  // odd: conflict-free per-lane reads
  int* rows_s = smem;                     // [CHUNK][at4]
  int* q_s = rows_s + CHUNK * at4;        // [32][qstride]
  int* cnt_s = q_s + 32 * qstride;        // [32] hits per query, this chunk
  int* tot_s = cnt_s + 32;                // [2][32] block totals

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * qt;
  const bool qok = lane < qt;
  const int q = q0 + lane;
  const int band_blk = blockIdx.x;
  const int row_base = (start_blk[q0 / bt] + band_blk) * ROW_BLOCK;
  const size_t bytes_per_q = (size_t)nb_band * (ROW_BLOCK / 8);

  const int* qbin4 = reinterpret_cast<const int*>(qbin);
  for (int idx = tid; idx < qt * at4; idx += blockDim.x) {
    const int qq = idx / at4, k = idx - qq * at4;
    q_s[qq * qstride + k] = qbin4[(size_t)(q0 + qq) * at4 + k];
  }
  if (tid < 64) tot_s[tid] = 0;
  int my_cc = 0, my_ka = -1, my_kl = -1;
  if (qok) {
    my_cc = q_cc[q];
    my_ka = k_ana[q];
    my_kl = k_len[q];
  }
  int tot_m = 0, tot_e = 0;
  const int* qrow = q_s + lane * qstride;

  for (int chunk = 0; chunk < ROW_BLOCK / CHUNK; ++chunk) {
    const int r0 = row_base + chunk * CHUNK;
    __syncthreads();  // the previous chunk's readers are done
    const int4* src = reinterpret_cast<const int4*>(bins + (size_t)r0 * at_pad);
    int4* dst = reinterpret_cast<int4*>(rows_s);
    for (int idx = tid; idx < CHUNK * at_pad / 16; idx += blockDim.x)
      dst[idx] = src[idx];
    if (tid < 32) cnt_s[tid] = 0;
    __syncthreads();

    int acc[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = 0;
    const int* wrows = rows_s + warp * ROWS_PER_WARP * at4;
    if (qok) {
      for (int k = 0; k < at4; ++k) {
        const int qv = qrow[k];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r)
          acc[r] = __dp4a(wrows[r * at4 + k], qv, acc[r]);
      }
    }

    unsigned hit = 0, ex = 0;
    const int wrow0 = r0 + warp * ROWS_PER_WARP;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int c = cc[wrow0 + r];
      const bool v = validrows[wrow0 + r] != 0;
      const int l1 = c + my_cc - 2 * acc[r];
      const int ccd = c - my_cc;
      hit |= (unsigned)(v && l1 <= my_ka && abs(ccd) <= my_kl) << r;
      ex |= (unsigned)(v && l1 == 0) << r;
    }
    if (qok) {
      const size_t byte0 =
          (size_t)(band_blk * ROW_BLOCK + chunk * CHUNK + warp * ROWS_PER_WARP) / 8;
      *reinterpret_cast<uint16_t*>(packed_q + q * bytes_per_q + byte0) =
          (uint16_t)hit;
      *reinterpret_cast<uint16_t*>(exact_q + q * bytes_per_q + byte0) =
          (uint16_t)ex;
      const int h = __popc(hit);
      atomicAdd(&cnt_s[lane], h);
      tot_m += h;
      tot_e += __popc(ex);
    }
    __syncthreads();
    if (tid < qt)
      counts_t[(size_t)(band_blk * (ROW_BLOCK / CHUNK) + chunk) * B + q0 + tid] =
          cnt_s[tid];
  }

  if (qok) {
    atomicAdd(&tot_s[lane], tot_m);
    atomicAdd(&tot_s[32 + lane], tot_e);
  }
  __syncthreads();
  if (tid < qt) {
    atomicAdd(&nmatch[q0 + tid], tot_s[tid]);
    atomicAdd(&nexact[q0 + tid], tot_s[32 + tid]);
  }
}

}  // namespace

// bins int8 [Ni, at_pad] (at_pad % 16 == 0), cc int32 [Ni], validrows
// uint8 [Ni], qbin int8 [B, at_pad], q_cc / k_ana / k_len int32 [B],
// start_blk int32 [B / bt] with (start_blk[t] + nb_band) * 1024 <= Ni (the
// band plan clamps it so). nmatch / nexact must be zeroed by the caller.
// qt divides bt, and bt divides B.
extern "C" int analiticcl_stage_a(
    const void* bins, const void* cc, const void* validrows, const void* qbin,
    const void* q_cc, const void* k_ana, const void* k_len,
    const void* start_blk, void* packed_q, void* exact_q, void* counts_t,
    void* nmatch, void* nexact, int B, int at_pad, int nb_band, int bt, int qt,
    void* stream) {
  if (B <= 0 || nb_band <= 0) return 0;
  if (at_pad % 16 || qt < 1 || qt > 32 || bt % qt || B % bt)
    return (int)cudaErrorInvalidValue;
  const int at4 = at_pad / 4;
  const size_t smem =
      sizeof(int) * ((size_t)CHUNK * at4 + 32 * (at4 + 1) + 32 + 64);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stage_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nb_band, B / qt), block(NWARP * 32);
  stage_a_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int8_t*)bins, (const int*)cc, (const uint8_t*)validrows,
      (const int8_t*)qbin, (const int*)q_cc, (const int*)k_ana,
      (const int*)k_len, (const int*)start_blk, (uint8_t*)packed_q,
      (uint8_t*)exact_q, (int*)counts_t, (int*)nmatch, (int*)nexact, B, at_pad,
      nb_band, bt, qt);
  return (int)cudaGetLastError();
}
