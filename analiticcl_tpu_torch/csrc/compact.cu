// The survivor compaction of the query core on Hopper (kernel K4): the kept
// pair slots moved, in order, into the P2 survivor slots of the batch's one
// output buffer.
//
// Replaces the JAX core's `_compact` (analiticcl_tpu/ops/pipeline.py:242-266,
// called at :726-750), XLA glue after its second Pallas call, which the port
// ran as torch ops (`compact_survivors_plain` in ops/pipeline.py: a cumsum,
// a search and three gathers, then a `torch.cat` of the ten outputs). The
// kept slot of rank r (the r-th kept slot in slot order, that is query-major
// then device-row order) goes to survivor slot r where r < P2: its query,
// its device row and its five uint8 metrics. Survivor slots from the
// number kept up to P2 hold query B and zeros, the JAX fill
// (B, 0, 0, 0, 0, 0, False). Kept slots ranked at P2 or past are dropped;
// the total counts them (the pipeline's overflow escalation reads it).
//
// The outputs are written straight into one byte buffer laid out as the
// pipeline's `_pack` lays out the core's ten outputs (widest dtype first,
// in order): max_freq int64 [B], total_match int64, total_keep int64, o_q
// int32 [P2], o_c int32 [P2], then the five uint8 [P2] metric columns. So
// the buffer is the batch's one copy to the host, with no concatenation
// before it; every int64 piece sits at a multiple of 8 bytes.
//
// Design: one launch, no grid-wide scan. K2's slot entry stores the kept
// count of each of its blocks (128 slots, or 64 above L 32). A block here
// takes CHUNK slots, a whole number of those blocks:
// - Its first rank: every block sums the counts before its chunk (and all
//   of them, the total) itself. At P 393,216 there are 3,072 counts, 12
//   coalesced loads a thread from L2: no second launch.
// - Its slots: each warp takes ITER runs of 32 consecutive slots, a lane
//   each; one ballot per run gives the run's kept lanes, whose ranks are
//   the popcounts below them. One barrier exchanges the warps' kept
//   totals. The kept lanes then load their slot's query, row and metrics
//   (coalesced within the run) and store them at consecutive ranks.
// - The fill and the small outputs: every block writes a grid-stride share
//   of the survivor slots from the total to P2 and of the max_freq copy;
//   the last block writes the two totals. No byte is written twice.
//
// What bounds it on the H100: bytes. It reads the counts, the keep flags,
// and each kept slot's 13 bytes, and writes 13 bytes per survivor slot and
// the 8 (B + 2) bytes of the small outputs; its arithmetic is a few
// operations a slot.

// With -DANALITICCL_HOST_TEST the per-slot writes, the fill and the chunk
// arithmetic compile as plain C++, driven by a sequential walk of the same
// blocks, warps and runs that stands in for the ballots (for checking the
// arithmetic on a machine without a card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#define HDFN __host__ __device__ __forceinline__
#else
#include <cstddef>
#define HDFN inline
#endif

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ITER = 8;                     // runs of 32 slots a warp
constexpr int WARP_SLOTS = 32 * ITER;       // a warp's consecutive slots
constexpr int CHUNK = THREADS * ITER;       // slots a block
constexpr int MET = 5;                      // uint8 metric columns
static_assert(CHUNK % 128 == 0, "a chunk is whole blocks of K2's slot entry");

// The buffer's pieces, as `_pack` lays out the core's outputs.
struct Out {
  long long* max_freq;     // [B]
  long long* total_match;  // [1]
  long long* total_keep;   // [1]
  int* q;                  // [P2]
  int* c;                  // [P2]
  unsigned char* met;      // [MET, P2]
};

HDFN Out out_pieces(unsigned char* buf, int B, int P2) {
  Out o;
  o.max_freq = (long long*)buf;
  o.total_match = o.max_freq + B;
  o.total_keep = o.total_match + 1;
  o.q = (int*)(o.total_keep + 1);
  o.c = o.q + P2;
  o.met = (unsigned char*)(o.c + P2);
  return o;
}

// Survivor slot r takes kept slot s.
HDFN void write_survivor(long long r, long long s, const int* q,
                         const int* pc, const unsigned char* met, int P,
                         int P2, Out o) {
  o.q[r] = q[s];
  o.c[r] = pc[s];
  for (int k = 0; k < MET; ++k)
    o.met[(size_t)k * P2 + r] = met[(size_t)k * P + s];
}

// Survivor slot r past the total: the JAX fill.
HDFN void write_fill(long long r, int B, int P2, Out o) {
  o.q[r] = B;
  o.c[r] = 0;
  for (int k = 0; k < MET; ++k) o.met[(size_t)k * P2 + r] = 0;
}

// The grid: a block per chunk of slots, and as many as the survivor slots
// would have at a chunk a block, at least one.
HDFN int grid_blocks(int P, int P2) {
  const int a = (P + CHUNK - 1) / CHUNK, b = (P2 + CHUNK - 1) / CHUNK;
  const int g = a > b ? a : b;
  return g > 0 ? g : 1;
}

#ifndef ANALITICCL_HOST_TEST
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const int* __restrict__ counts, int nblk, int blk_slots,
               const unsigned char* __restrict__ keep,
               const int* __restrict__ q, const int* __restrict__ pc,
               const unsigned char* __restrict__ met,
               const long long* __restrict__ max_freq,
               const long long* __restrict__ total_match, int B, int P,
               int P2, Out o) {
  __shared__ long long s_red[2][WARPS];
  __shared__ int s_warp[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long c0 = (long long)blockIdx.x * CHUNK;
  const long long s0 = c0 + (long long)warp * WARP_SLOTS + lane;

  // the warp's runs: which lanes keep their slot
  unsigned runs[ITER];
  int n = 0;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const long long s = s0 + 32 * i;
    runs[i] = __ballot_sync(FULL, s < P && keep[s]);
    n += __popc(runs[i]);
  }

  // the kept slots before the chunk, and all of them
  const long long first_blk = c0 / blk_slots;
  long long pre = 0, all = 0;
  for (int i = t; i < nblk; i += THREADS) {
    const int v = counts[i];
    all += v;
    if (i < first_blk) pre += v;
  }
  pre = warp_sum(pre);
  all = warp_sum(all);
  if (lane == 0) {
    s_red[0][warp] = pre;
    s_red[1][warp] = all;
    s_warp[warp] = n;
  }
  __syncthreads();
  long long off = 0;
  pre = all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    pre += s_red[0][w];
    all += s_red[1][w];
    if (w < warp) off += s_warp[w];
  }
  off += pre;

  // this block's share of the fill and of the max_freq copy (stores only)
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long r = all + (long long)blockIdx.x * THREADS + t; r < P2;
       r += stride)
    write_fill(r, B, P2, o);
  for (long long b = (long long)blockIdx.x * THREADS + t; b < B; b += stride)
    o.max_freq[b] = max_freq[b];
  if (blockIdx.x == gridDim.x - 1 && t == 0) {
    *o.total_match = *total_match;
    *o.total_keep = all;
  }

  // the warp's survivors, run by run, at consecutive ranks
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    if (off >= P2) break;  // uniform in the warp
    const unsigned m = runs[i];
    if (m >> lane & 1) {
      const long long r = off + __popc(m & below);
      if (r < P2) write_survivor(r, s0 + 32 * i, q, pc, met, P, P2, o);
    }
    off += __popc(m);
  }
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// counts: int32 [nblk], the kept slots of each block of blk_slots slots
// (K2's slot entry's; CHUNK must be a multiple of blk_slots); keep: bool
// [P]; q, pc: int32 [P]; met: uint8 [5, P]; max_freq: int64 [B];
// total_match: int64 [1]. out: uint8 [8 (B + 2) + 13 P2], the layout above.
// One launch on `stream`.
extern "C" int analiticcl_compact(const void* counts, int nblk, int blk_slots,
                                  const void* keep, const void* q,
                                  const void* pc, const void* met,
                                  const void* max_freq,
                                  const void* total_match, void* out, int B,
                                  int P, int P2, void* stream) {
  if (B < 1 || P < 0 || P2 < 1 || blk_slots < 1 || CHUNK % blk_slots ||
      nblk != (P + blk_slots - 1) / blk_slots)
    return (int)cudaErrorInvalidValue;
  compact_kernel<<<grid_blocks(P, P2), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, nblk, blk_slots, (const unsigned char*)keep,
      (const int*)q, (const int*)pc, (const unsigned char*)met,
      (const long long*)max_freq, (const long long*)total_match, B, P, P2,
      out_pieces((unsigned char*)out, B, P2));
  return (int)cudaGetLastError();
}
#else
// The same buffer on the host: the kernel's blocks, warps and runs walked in
// order, a run's kept lanes ranked by the popcount below them, its fill,
// copy and totals. Returns 0, or -1 for the arguments the kernel refuses.
extern "C" int analiticcl_compact_host(const int* counts, int nblk,
                                       int blk_slots,
                                       const unsigned char* keep,
                                       const int* q, const int* pc,
                                       const unsigned char* met,
                                       const long long* max_freq,
                                       const long long* total_match,
                                       unsigned char* out, int B, int P,
                                       int P2) {
  if (B < 1 || P < 0 || P2 < 1 || blk_slots < 1 || CHUNK % blk_slots ||
      nblk != (P + blk_slots - 1) / blk_slots)
    return -1;
  const Out o = out_pieces(out, B, P2);
  const int grid = grid_blocks(P, P2);
  long long all = 0;
  for (int i = 0; i < nblk; ++i) all += counts[i];
  for (int blk = 0; blk < grid; ++blk) {
    const long long c0 = (long long)blk * CHUNK;
    long long off = 0;  // the counts before the chunk
    for (long long i = 0; i < c0 / blk_slots && i < nblk; ++i)
      off += counts[i];
    for (int warp = 0; warp < WARPS; ++warp) {
      for (int i = 0; i < ITER && off < P2; ++i) {
        const long long s0 = c0 + (long long)warp * WARP_SLOTS + 32 * i;
        unsigned m = 0;  // the run's ballot
        for (int lane = 0; lane < 32; ++lane)
          if (s0 + lane < P && keep[s0 + lane]) m |= 1u << lane;
        for (int lane = 0; lane < 32; ++lane) {
          if (!(m >> lane & 1)) continue;
          const long long r = off + __builtin_popcount(m & ((1u << lane) - 1));
          if (r < P2) write_survivor(r, s0 + lane, q, pc, met, P, P2, o);
        }
        off += __builtin_popcount(m);
      }
    }
  }
  for (long long r = all; r < P2; ++r) write_fill(r, B, P2, o);
  for (int b = 0; b < B; ++b) o.max_freq[b] = max_freq[b];
  *o.total_match = *total_match;
  *o.total_keep = all;
  return 0;
}
#endif
