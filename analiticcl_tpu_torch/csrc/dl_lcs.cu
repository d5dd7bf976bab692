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
// TPU cannot gather per lane; a CUDA thread indexes its own arrays, so the
// transposition term is a single read at (last, db) instead of a
// (W+1)^2 select slab. The ring of W + 3 DP rows, the last-occurrence
// column and the LCS row live in per-thread local memory (L1-cached).
//
// What bounds it on the H100: per-thread local-memory traffic, about six
// 4-byte accesses per band cell, al * (2W + 3) cells per pair; the pairs'
// strings are read once. Nothing is shared between threads, so the kernel
// needs no shared memory and no synchronisation. Making it fast (a
// warp-cooperative band, rings in registers or shared memory, 16-bit cells)
// is later work.

// With -DANALITICCL_HOST_TEST the per-pair DP compiles as plain C++ (for
// checking its arithmetic on a machine without a card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define DEVFN __device__ __forceinline__
#else
#include <algorithm>
#include <cstddef>
using std::max;
using std::min;
#define DEVFN inline
#endif

namespace {

template <int W, int LMAX>
DEVFN void dl_lcs_pair(const int* ap, int al, const int* bp, int bl, int L,
                       int* ld_out, int* lcs_out) {
  constexpr int R = W + 3;   // ring depth: rows i+1 .. i-W-1
  constexpr int B1 = W + 1;  // band half-width
  const int big = 2 * L + 8;

  int bs[LMAX];
  int ring[R][LMAX + 1];  // slot k % R holds DP row k; position p = column p+1
  int lastcol[LMAX];      // last query row i with a[i-1] == b[j-1]
  int lcsrow[LMAX];
  for (int j = 0; j < L; ++j) {
    bs[j] = bp[j];
    lastcol[j] = 0;
    lcsrow[j] = 0;
  }
  for (int r = 0; r < R; ++r)
    for (int p = 0; p <= L; ++p) ring[r][p] = big;
  for (int p = 0; p <= L; ++p) ring[1 % R][p] = p;

  int res = big;
  int best = 0;
  for (int i1 = 0; i1 < al; ++i1) {
    const int i = i1 + 1;  // reading row i, writing row i + 1
    const int s = ap[i1];
    int* wrow = ring[(i + 1) % R];
    const int* rrow = ring[i % R];
    const int center = i1 + 1;
    const int jstart = max(1, center - B1);
    const int jend = min(L, center + B1);

    wrow[0] = i;
    for (int m = 1; m <= B1; ++m) {
      const int lo = center - B1 - m, hi = center + B1 + m;
      if (lo >= 1 && lo <= L) wrow[lo] = big;
      if (hi >= 1 && hi <= L) wrow[hi] = big;
    }

    const int ndl = min(W, i);
    int del_prev = jstart == 1 ? i : big;
    int db = 0;  // last column < j of this row with a match
    for (int j = jstart; j <= jend; ++j) {
      const bool match = bs[j - 1] == s;
      const int sub = rrow[j - 1] + (match ? 0 : 1);
      const int ins = rrow[j] + 1;
      const int del = del_prev + 1;
      const int last = lastcol[j - 1];
      const int d = i - last;
      const int smax = min(W, j - 1);
      int transp = big;
      if (smax >= 1 && d >= 1 && d <= ndl && db >= j - smax) {
        const int t = ring[last % R][db - 1] + d - 1 + j - db;
        transp = min(transp, t);
      }
      const int nv = min(min(sub, ins), min(del, transp));
      wrow[j] = nv;
      if (i1 == al - 1 && j == bl) res = nv;
      del_prev = nv;
      if (match) {
        db = j;
        lastcol[j - 1] = i;
      }
    }

    // full-width LCS row, rolled in place from the right
    for (int j = bl - 1; j >= 0; --j) {
      const int v = bs[j] == s ? (j > 0 ? lcsrow[j - 1] : 0) + 1 : 0;
      lcsrow[j] = v;
      best = max(best, v);
    }
  }
  if (al == 0) res = bl;
  if (bl == 0) res = al;
  *ld_out = res;
  *lcs_out = best;
}

#ifndef ANALITICCL_HOST_TEST
template <int W, int LMAX>
__global__ void __launch_bounds__(128)
dl_lcs_kernel(const int* __restrict__ a, const int* __restrict__ a_len,
              const int* __restrict__ b, const int* __restrict__ b_len,
              int* __restrict__ ld, int* __restrict__ lcs, int P, int L) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  // a length above L is invalid input; clamping keeps every read in the row
  dl_lcs_pair<W, LMAX>(a + (size_t)p * L, min(a_len[p], L), b + (size_t)p * L,
                       min(b_len[p], L), L, ld + p, lcs + p);
}

template <int W>
void launch(const int* a, const int* al, const int* b, const int* bl, int* ld,
            int* lcs, int P, int L, cudaStream_t st) {
  const dim3 block(128), grid((P + 127) / 128);
  if (L <= 32)
    dl_lcs_kernel<W, 32><<<grid, block, 0, st>>>(a, al, b, bl, ld, lcs, P, L);
  else
    dl_lcs_kernel<W, 64><<<grid, block, 0, st>>>(a, al, b, bl, ld, lcs, P, L);
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// a, b: int32 [P, L] (PAD_A / PAD_B padded); a_len, b_len: int32 [P];
// ld, lcs: int32 [P] outputs. W in {3, 6, 12}, 1 <= L <= 64.
extern "C" int analiticcl_dl_lcs(const void* a, const void* a_len,
                                 const void* b, const void* b_len, void* ld,
                                 void* lcs, int P, int L, int W,
                                 void* stream) {
  if (P <= 0) return 0;
  if (L < 1 || L > 64) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto A = (const int*)a, AL = (const int*)a_len, B = (const int*)b,
       BL = (const int*)b_len;
  auto LD = (int*)ld, LCS = (int*)lcs;
  switch (W) {
    case 3: launch<3>(A, AL, B, BL, LD, LCS, P, L, st); break;
    case 6: launch<6>(A, AL, B, BL, LD, LCS, P, L, st); break;
    case 12: launch<12>(A, AL, B, BL, LD, LCS, P, L, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#else
extern "C" void analiticcl_dl_lcs_host(const int* a, const int* a_len,
                                       const int* b, const int* b_len, int* ld,
                                       int* lcs, int P, int L, int W) {
  for (int p = 0; p < P; ++p) {
    const int* ap = a + (size_t)p * L;
    const int* bp = b + (size_t)p * L;
    if (W == 3) dl_lcs_pair<3, 64>(ap, a_len[p], bp, b_len[p], L, ld + p, lcs + p);
    if (W == 6) dl_lcs_pair<6, 64>(ap, a_len[p], bp, b_len[p], L, ld + p, lcs + p);
    if (W == 12) dl_lcs_pair<12, 64>(ap, a_len[p], bp, b_len[p], L, ld + p, lcs + p);
  }
}
#endif
