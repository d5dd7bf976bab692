// The query planes of the query core on Hopper (kernel K5): each query's
// per-character counts binarized into the int8 planes stage A multiplies,
// and stage A's per-query totals zeroed, in one launch.
//
// Replaces the JAX core's query planes (analiticcl_tpu/ops/pipeline.py:
// 402-408), XLA glue before its first Pallas call, which the port ran as
// torch ops (`query_planes_plain` in ops/pipeline.py: an arange, a clamp, a
// compare, a cast and a pad), and the two `torch.zeros` of K1's atomic
// totals `nmatch` and `nexact` (ops/stage_a.py). Column a * T + t of query
// b's plane is 1 where min(count[b, a], T) > t, that is count[b, a] > t;
// the columns from A * T to the padded width are 0.
//
// Design: a thread per 4 bytes of planes. Each reads the counts its 4
// columns fall in (at most two, from L1) and stores one 32-bit word, so a
// warp writes 128 consecutive bytes of a row; the grid's first 2 B threads
// also zero the totals. What bounds it on the H100: bytes, 4 A + at_pad + 8
// a query, a few operations a byte.

// With -DANALITICCL_HOST_TEST the word arithmetic compiles as plain C++,
// driven by a loop over the words (for checking it on a machine without a
// card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define HDFN __host__ __device__ __forceinline__
#else
#define HDFN inline
#endif

namespace {

constexpr int THREADS = 256;

// Word w of query b's plane row (at_pad / 4 words a row): its 4 bytes,
// little-endian, column 4w + j in byte j.
HDFN unsigned plane_word(const int* q_counts, long long w, int A, int T,
                         int at_pad) {
  const int words = at_pad / 4;
  const long long b = w / words;
  const int c0 = (int)(w % words) * 4;
  const int* row = q_counts + b * A;
  unsigned v = 0;
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    if (c < A * T && row[c / T] > c % T) v |= 1u << (8 * j);
  }
  return v;
}

#ifndef ANALITICCL_HOST_TEST
__global__ void __launch_bounds__(THREADS)
planes_kernel(const int* __restrict__ q_counts, unsigned* __restrict__ planes,
              int* __restrict__ totals, int B, int A, int T, int at_pad) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n = (long long)B * (at_pad / 4);
  if (i < n) planes[i] = plane_word(q_counts, i, A, T, at_pad);
  if (totals && i < 2LL * B) totals[i] = 0;
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// q_counts: int32 [B, A]; planes: int8 [B, at_pad] out (at_pad a multiple
// of 4, at least A * T); totals: int32 [2, B] zeroed, or null. One launch
// on `stream`.
extern "C" int analiticcl_planes(const void* q_counts, void* planes,
                                 void* totals, int B, int A, int T,
                                 int at_pad, void* stream) {
  if (B < 1 || A < 1 || T < 1 || at_pad % 4 || A * T > at_pad)
    return (int)cudaErrorInvalidValue;
  const long long words = (long long)B * (at_pad / 4);
  const long long n = words > 2LL * B ? words : 2LL * B;
  planes_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>((const int*)q_counts,
                                          (unsigned*)planes, (int*)totals, B,
                                          A, T, at_pad);
  return (int)cudaGetLastError();
}
#else
// The same planes and zeroed totals on the host, word by word. Returns 0,
// or -1 for the arguments the kernel refuses.
extern "C" int analiticcl_planes_host(const int* q_counts,
                                      unsigned char* planes, int* totals,
                                      int B, int A, int T, int at_pad) {
  if (B < 1 || A < 1 || T < 1 || at_pad % 4 || A * T > at_pad) return -1;
  for (long long w = 0; w < (long long)B * (at_pad / 4); ++w) {
    const unsigned v = plane_word(q_counts, w, A, T, at_pad);
    for (int j = 0; j < 4; ++j) planes[4 * w + j] = (unsigned char)(v >> 8 * j);
  }
  if (totals)
    for (int i = 0; i < 2 * B; ++i) totals[i] = 0;
  return 0;
}
#endif
