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
// its device row and its five metrics. Survivor slots from the number kept
// up to P2 hold query B and zeros, the JAX fill (B, 0, 0, 0, 0, 0, False).
// Kept slots ranked at P2 or past are dropped; the total counts them (the
// pipeline's overflow escalation reads it).
//
// The outputs are written straight into one byte buffer laid out as the
// pipeline's `_pack` lays out the core's ten outputs (widest dtype first,
// in order): max_freq int64 [B], total_match int64, total_keep int64, o_q
// int32 [P2], o_c int32 [P2], then the five metric columns [P2], uint8
// (below L 256) or int32 (from L 256, as K2's slot entry writes them). So
// the buffer is the batch's one copy to the host, with no concatenation
// before it; every int64 piece sits at a multiple of 8 bytes.
//
// Design: one launch, no grid-wide scan, two memory round trips before the
// stores. K2's slot entry stores the kept count of each of its blocks (128
// slots, or 64 above L 32). A block here takes CHUNK slots, a whole number
// of those blocks, 16 to a lane:
// - First round trip: each lane loads its 16 keep flags in one 16-byte load
//   and, in the same breath, its share of the counts (up to 16 16-byte
//   loads issued at once): every block sums the counts before its chunk and
//   all of them (the total) itself. At P 393,216 there are 3,072 counts, 6
//   vector loads a thread from L2.
// - In the SM: a warp scan of the lanes' kept counts and one barrier give
//   each lane the rank of its first kept slot in the block; the lanes write
//   their kept slots' offsets, in order, into a list in shared memory; a
//   second barrier.
// - Second round trip: thread k of the block takes list entries k,
//   k + 128, ... (ranks before + k, ...): it loads up to four slots' query,
//   row and metrics before it stores any, at consecutive ranks, so a warp's
//   loads and stores are coalesced, at uint8 or int32, and a block dense in
//   survivors still pays about one round trip.
// - The fill and the small outputs: every block writes a grid-stride share
//   of the survivor slots from the total to P2 and of the max_freq copy;
//   the last block writes the two totals. No byte is written twice.
//
// What bounds it on the H100: bytes (the counts, the keep flags, each kept
// slot's payload, the buffer); its arithmetic is a few operations a slot.
// At the main batch that is 0.5 us of traffic, under the launch's own
// floor, so what is left is latency: the chain of round trips per block.

// With -DANALITICCL_HOST_TEST the per-slot writes, the fill and the chunk
// arithmetic compile as plain C++, driven by a sequential walk of the same
// blocks, lanes and lists that stands in for the scans (for checking the
// arithmetic on a machine without a card).
#ifndef ANALITICCL_HOST_TEST
#include <cuda_runtime.h>
#include <cstdint>
#define HDFN __host__ __device__ __forceinline__
#else
#include <cstddef>
#include <vector>
#define HDFN inline
#endif

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PER = 16;                     // keep flags a lane
constexpr int CHUNK = THREADS * PER;        // slots a block
constexpr int MET = 5;                      // metric columns
constexpr int UNROLL = 4;   // survivors a thread loads before it stores
constexpr int COUNT4 = 16;  // counts' 16-byte loads a thread issues at once
static_assert(CHUNK % 128 == 0, "a chunk is whole blocks of K2's slot entry");

// The buffer's pieces, as `_pack` lays out the core's outputs.
struct Out {
  long long* max_freq;     // [B]
  long long* total_match;  // [1]
  long long* total_keep;   // [1]
  int* q;                  // [P2]
  int* c;                  // [P2]
  unsigned char* met;      // [MET, P2] of met_bytes each
  int met_bytes;
};

HDFN Out out_pieces(unsigned char* buf, int B, int P2, int met_bytes) {
  Out o;
  o.max_freq = (long long*)buf;
  o.total_match = o.max_freq + B;
  o.total_keep = o.total_match + 1;
  o.q = (int*)(o.total_keep + 1);
  o.c = o.q + P2;
  o.met = (unsigned char*)(o.c + P2);
  o.met_bytes = met_bytes;
  return o;
}

// Kept slot s's payload: its query, device row and metrics.
struct Payload {
  int q, c, met[MET];
};

HDFN Payload load_payload(long long s, const int* q, const int* pc,
                          const void* met, int met_bytes, int P) {
  Payload v;
  v.q = q[s];
  v.c = pc[s];
  for (int k = 0; k < MET; ++k)
    v.met[k] = met_bytes == 4
                   ? ((const int*)met)[(size_t)k * P + s]
                   : ((const unsigned char*)met)[(size_t)k * P + s];
  return v;
}

// Survivor slot r takes a kept slot's payload.
HDFN void store_survivor(long long r, const Payload& v, int P2, Out o) {
  o.q[r] = v.q;
  o.c[r] = v.c;
  if (o.met_bytes == 4)
    for (int k = 0; k < MET; ++k) ((int*)o.met)[(size_t)k * P2 + r] = v.met[k];
  else
    for (int k = 0; k < MET; ++k)
      o.met[(size_t)k * P2 + r] = (unsigned char)v.met[k];
}

// Survivor slot r past the total: the JAX fill.
HDFN void write_fill(long long r, int B, int P2, Out o) {
  o.q[r] = B;
  o.c[r] = 0;
  if (o.met_bytes == 4)
    for (int k = 0; k < MET; ++k) ((int*)o.met)[(size_t)k * P2 + r] = 0;
  else
    for (int k = 0; k < MET; ++k) o.met[(size_t)k * P2 + r] = 0;
}

// The grid: a block per chunk of slots, and as many as the survivor slots
// would have at a chunk a block, at least one.
HDFN int grid_blocks(int P, int P2) {
  const int a = (P + CHUNK - 1) / CHUNK, b = (P2 + CHUNK - 1) / CHUNK;
  const int g = a > b ? a : b;
  return g > 0 ? g : 1;
}

// Bit k of a lane's mask: slot PER * lane + k of the chunk is kept (keep
// flags are bool bytes, 0 or 1).
HDFN unsigned flag_bits(unsigned w, int k0) {
  return (w & 1u) << k0 | (w >> 8 & 1u) << (k0 + 1) |
         (w >> 16 & 1u) << (k0 + 2) | (w >> 24 & 1u) << (k0 + 3);
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
               const void* __restrict__ met,
               const long long* __restrict__ max_freq,
               const long long* __restrict__ total_match, int B, int P,
               int P2, Out o) {
  __shared__ short s_list[CHUNK];  // the chunk's kept slots, in order
  __shared__ long long s_red[2][WARPS];
  __shared__ int s_warp[WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long c0 = (long long)blockIdx.x * CHUNK;
  const long long s0 = c0 + (long long)PER * t;

  // ---- one round trip: the lane's 16 keep flags and its counts ----
  // (keep and counts are 16-byte aligned: the entry refuses them else;
  // the scalar loops are the tails past P and past whole int4s)
  unsigned bits = 0;
  if (s0 + PER <= P) {
    const uint4 f = *reinterpret_cast<const uint4*>(keep + s0);
    bits = flag_bits(f.x, 0) | flag_bits(f.y, 4) | flag_bits(f.z, 8) |
           flag_bits(f.w, 12);
  } else {
    for (int k = 0; s0 + k < P; ++k)
      if (keep[s0 + k]) bits |= 1u << k;
  }
  const long long first_blk = c0 / blk_slots;
  long long pre = 0, all = 0;
  const int4* const c4 = reinterpret_cast<const int4*>(counts);
  const int n4 = nblk / 4;
  for (int i0 = t; i0 < n4; i0 += COUNT4 * THREADS) {
    int4 v[COUNT4];
#pragma unroll
    for (int u = 0; u < COUNT4; ++u) {
      const int i = i0 + u * THREADS;
      v[u] = i < n4 ? c4[i] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < COUNT4; ++u) {
      const long long b0 = 4LL * (i0 + u * THREADS);
      all += (long long)v[u].x + v[u].y + v[u].z + v[u].w;
      pre += (b0 < first_blk ? v[u].x : 0) +
             (b0 + 1 < first_blk ? v[u].y : 0) +
             (b0 + 2 < first_blk ? v[u].z : 0) +
             (b0 + 3 < first_blk ? v[u].w : 0);
    }
  }
  for (int i = (nblk & ~3) + t; i < nblk; i += THREADS) {
    all += counts[i];
    if (i < first_blk) pre += counts[i];
  }

  // ---- in the SM: the lanes' ranks in the block, the kept list ----
  const int n = __popc(bits);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  pre = warp_sum(pre);
  all = warp_sum(all);
  if (lane == 31) s_warp[warp] = incl;
  if (lane == 0) {
    s_red[0][warp] = pre;
    s_red[1][warp] = all;
  }
  __syncthreads();
  int rank = incl - n, n_block = 0;
  pre = all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    pre += s_red[0][w];
    all += s_red[1][w];
    if (w < warp) rank += s_warp[w];
    n_block += s_warp[w];
  }
  for (unsigned m = bits; m; m &= m - 1)
    s_list[rank++] = (short)(PER * t + __ffs(m) - 1);
  __syncthreads();

  // ---- the second round trip: survivor k of the block at rank pre + k,
  // UNROLL of them a thread loaded before any is stored ----
  const int n_out = (int)(P2 - pre < n_block ? (P2 - pre > 0 ? P2 - pre : 0)
                                             : n_block);
  for (int k0 = t; k0 < n_out; k0 += UNROLL * THREADS) {
    Payload v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      if (k < n_out)
        v[u] = load_payload(c0 + s_list[k], q, pc, met, o.met_bytes, P);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      if (k < n_out) store_survivor(pre + k, v[u], P2, o);
    }
  }

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
}
#endif

}  // namespace

#ifndef ANALITICCL_HOST_TEST
// counts: int32 [nblk], the kept slots of each block of blk_slots slots
// (K2's slot entry's; CHUNK must be a multiple of blk_slots); keep: bool
// [P]; both 16-byte aligned; q, pc: int32 [P]; met: [5, P] of met_bytes (1: uint8, 4: int32);
// max_freq: int64 [B]; total_match: int64 [1]. out: uint8
// [8 (B + 2) + (8 + 5 met_bytes) P2], the layout above. One launch on
// `stream`.
extern "C" int analiticcl_compact(const void* counts, int nblk, int blk_slots,
                                  const void* keep, const void* q,
                                  const void* pc, const void* met,
                                  int met_bytes, const void* max_freq,
                                  const void* total_match, void* out, int B,
                                  int P, int P2, void* stream) {
  if (B < 1 || P < 0 || P2 < 1 || blk_slots < 1 || CHUNK % blk_slots ||
      nblk != (P + blk_slots - 1) / blk_slots ||
      (met_bytes != 1 && met_bytes != 4) || ((uintptr_t)counts & 15) ||
      ((uintptr_t)keep & 15))
    return (int)cudaErrorInvalidValue;
  compact_kernel<<<grid_blocks(P, P2), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, nblk, blk_slots, (const unsigned char*)keep,
      (const int*)q, (const int*)pc, met, (const long long*)max_freq,
      (const long long*)total_match, B, P, P2,
      out_pieces((unsigned char*)out, B, P2, met_bytes));
  return (int)cudaGetLastError();
}
#else
// The same buffer on the host: the kernel's blocks walked in order, each
// lane's 16 flags in turn into the block's list, the list's entries at
// consecutive ranks; its fill, copy and totals. Returns 0, or -1 for the
// arguments the kernel refuses.
extern "C" int analiticcl_compact_host(const int* counts, int nblk,
                                       int blk_slots,
                                       const unsigned char* keep,
                                       const int* q, const int* pc,
                                       const void* met, int met_bytes,
                                       const long long* max_freq,
                                       const long long* total_match,
                                       unsigned char* out, int B, int P,
                                       int P2) {
  if (B < 1 || P < 0 || P2 < 1 || blk_slots < 1 || CHUNK % blk_slots ||
      nblk != (P + blk_slots - 1) / blk_slots ||
      (met_bytes != 1 && met_bytes != 4))
    return -1;
  const Out o = out_pieces(out, B, P2, met_bytes);
  const int grid = grid_blocks(P, P2);
  long long all = 0;
  for (int i = 0; i < nblk; ++i) all += counts[i];
  std::vector<int> list;
  for (int blk = 0; blk < grid; ++blk) {
    const long long c0 = (long long)blk * CHUNK;
    long long pre = 0;  // the counts before the chunk
    for (long long i = 0; i < c0 / blk_slots && i < nblk; ++i)
      pre += counts[i];
    list.clear();
    for (int t = 0; t < THREADS; ++t)
      for (int k = 0; k < PER; ++k) {
        const long long s = c0 + (long long)PER * t + k;
        if (s < P && keep[s]) list.push_back(PER * t + k);
      }
    for (size_t k = 0; k < list.size() && pre + (long long)k < P2; ++k)
      store_survivor(pre + k,
                     load_payload(c0 + list[k], q, pc, met, met_bytes, P),
                     P2, o);
  }
  for (long long r = all; r < P2; ++r) write_fill(r, B, P2, o);
  for (int b = 0; b < B; ++b) o.max_freq[b] = max_freq[b];
  *o.total_match = *total_match;
  *o.total_keep = all;
  return 0;
}
#endif
