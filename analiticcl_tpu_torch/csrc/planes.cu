// The query planes of the query core on Hopper (kernel K5): each query's
// per-character counts binarized into the int8 planes stage A multiplies,
// and stage A's per-query totals zeroed, in one launch.
//
// Replaces the JAX core's query planes (analiticcl_tpu/ops/pipeline.py:
// 402-408), XLA glue before its first Pallas call, which the port ran as
// torch ops (`query_planes_plain` in ops/pipeline.py: an arange, a clamp, a
// compare, a cast and a pad), and the two `torch.zeros` of K1's atomic
// totals `nmatch` and `nexact` (ops/stage_a.py). The planes are the
// port's threshold-major ones (convert.py): column t * A + a of query b's
// plane is 1 where min(count[b, a], T) > t, that is count[b, a] > t (the
// JAX core's column a * T + t); the columns from A * T to the padded width
// are 0.
//
// Design: a grid of at most one wave walks the rows in groups of `rows`
// (as many rows as the block's threads cover at 16 bytes a thread: 18 at
// AT 224). A group's A counts a row are staged in shared memory once, in
// coalesced loads; then each thread writes one 16-byte piece of a row's
// plane from them (one division a piece: the column's level and character
// step along, a piece's 16 characters in a row of the counts), so a warp
// stores 512 consecutive bytes. The grid's threads also zero the totals. (A table of each
// column's character and level, made once a block so that the 16 bytes'
// reads are independent, measured slower on the H100: 0.0033 against
// 0.0028 ms at B 4,096.) What bounds it on the H100: bytes, 4 A + at_pad
// + 8 a query, a few operations a byte.

// With -DANALITICCL_HOST_TEST the piece arithmetic compiles as plain C++,
// driven by a loop over the rows' pieces (for checking it on a machine
// without a card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define HDFN __host__ __device__ __forceinline__
#else
#define HDFN inline
#endif

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 16;  // plane bytes a thread stores at once

// Rows of a group: the pieces of as many rows as the block has threads.
HDFN int group_rows(int at_pad) {
  const int r = THREADS / (at_pad / PIECE);
  return r > 0 ? r : 1;
}

// Piece k of a row whose counts are `cnt` (A of them): its 16 bytes as four
// little-endian words, column 16k + j in byte j, column c = t * A + a
// holding cnt[a] > t; from level T on the columns are padding, 0.
HDFN void plane_piece(const int* cnt, int k, int A, int T, unsigned w[4]) {
  const int c0 = k * PIECE;
  int t = c0 / A, a = c0 - t * A;
  for (int i = 0; i < 4; ++i) {
    unsigned v = 0;
    for (int j = 0; j < 4; ++j) {
      if (t < T && cnt[a] > t) v |= 1u << (8 * j);
      if (++a == A) {
        a = 0;
        ++t;
      }
    }
    w[i] = v;
  }
}

#ifndef ANALITICCL_HOST_TEST
__global__ void __launch_bounds__(THREADS)
planes_kernel(const int* __restrict__ q_counts, uint4* __restrict__ planes,
              int* __restrict__ totals, int B, int A, int T, int at_pad) {
  extern __shared__ int s_cnt[];  // [rows, A]
  const int pieces = at_pad / PIECE, rows = group_rows(at_pad);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (totals)
    for (long long i = tid; i < 2LL * B; i += (long long)gridDim.x * THREADS)
      totals[i] = 0;
  for (long long r0 = (long long)blockIdx.x * rows; r0 < B;
       r0 += (long long)gridDim.x * rows) {
    const int nr = (int)(B - r0 < rows ? B - r0 : rows);
    const int* const src = q_counts + r0 * A;
    for (int i = threadIdx.x; i < nr * A; i += THREADS) s_cnt[i] = src[i];
    __syncthreads();
    for (int k = threadIdx.x; k < nr * pieces; k += THREADS) {
      const int r = k / pieces, p = k - r * pieces;
      unsigned w[4];
      plane_piece(s_cnt + r * A, p, A, T, w);
      planes[(r0 + r) * pieces + p] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
  }
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// q_counts: int32 [B, A]; planes: int8 [B, at_pad] out (at_pad a multiple
// of 16, at least A * T; 16-byte aligned); totals: int32 [2, B] zeroed, or
// null. One launch on `stream`.
extern "C" int analiticcl_planes(const void* q_counts, void* planes,
                                 void* totals, int B, int A, int T,
                                 int at_pad, void* stream) {
  if (B < 1 || A < 1 || T < 1 || at_pad % PIECE || A * T > at_pad ||
      ((unsigned long long)planes & 15))
    return (int)cudaErrorInvalidValue;
  static int waves[64];  // blocks in one wave, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !waves[dev]) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    waves[dev] = 8 * sms;  // 8 blocks of 256 threads an SM
  }
  const int rows = group_rows(at_pad);
  const long long groups = (B + rows - 1) / rows;
  const int wave = dev < 64 ? waves[dev] : 1024;
  const unsigned grid = (unsigned)(groups < wave ? groups : wave);
  planes_kernel<<<grid, THREADS, (size_t)rows * A * sizeof(int),
                  (cudaStream_t)stream>>>(
      (const int*)q_counts, (uint4*)planes, (int*)totals, B, A, T, at_pad);
  return (int)cudaGetLastError();
}
#else
// The same planes and zeroed totals on the host, piece by piece. Returns
// 0, or -1 for the arguments the kernel refuses.
extern "C" int analiticcl_planes_host(const int* q_counts,
                                      unsigned char* planes, int* totals,
                                      int B, int A, int T, int at_pad) {
  if (B < 1 || A < 1 || T < 1 || at_pad % PIECE || A * T > at_pad) return -1;
  const int pieces = at_pad / PIECE;
  for (long long b = 0; b < B; ++b)
    for (int p = 0; p < pieces; ++p) {
      unsigned w[4];
      plane_piece(q_counts + b * A, p, A, T, w);
      for (int i = 0; i < PIECE; ++i)
        planes[(b * pieces + p) * PIECE + i] =
            (unsigned char)(w[i / 4] >> 8 * (i % 4));
    }
  if (totals)
    for (int i = 0; i < 2 * B; ++i) totals[i] = 0;
  return 0;
}
#endif
