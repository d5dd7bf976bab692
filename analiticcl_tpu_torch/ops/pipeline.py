"""The batched device query: retrieval -> scoring, then the exact host tail.

The port of ``analiticcl_tpu/ops/pipeline.py``'s query path:

* :func:`query_core` is the counterpart of the fused ``_query_core``, with the
  same inputs (the index arrays in a :class:`~..convert.DeviceIndex`, then the
  per-batch query arrays), the same pair budgets ``P`` (candidate-pair slots)
  and ``P2`` (survivor slots), and the same outputs ``o_q, o_c, o_ld, o_lcs,
  o_pf, o_sf, o_case`` (``[P2]``, unused slots filled with query ``B`` and
  zeros), ``max_freq, total_match, total_keep``. On CUDA tensors a call
  is a short chain of hand-written kernels: the query planes (K5,
  :func:`query_planes`), stage A (K1, ``ops/stage_a.py``), the slot
  resolve (K3, :func:`resolve_pairs`), the pair loading with DL+LCS, the
  affixes, the f32 score and the keep tests (K2's slot entry and its
  epilogue, ``ops/dl.py``) and the survivor compaction (K4,
  :func:`compact_survivors`), which writes the ten outputs into the one
  byte buffer that is copied to the host.
  It is the composition of :func:`query_stage_a` and
  :func:`query_stage_b`, which a sharded index
  (``parallel/mesh.py``) calls per shard, combining the shards' exact
  counts between them. Its ``stop_stage`` prefixes (:data:`STOP_STAGES`)
  end it after one stage with int32 checksums of that stage's outputs, as
  the JAX core's do: ``tools/profile_device_stages_torch.py`` times them.
* Pair compaction is the JAX core's slot resolve (:func:`resolve_pairs`):
  slot ``p`` holds the ``p + 1``-th stage-A hit in query-major, then
  band-row order. The kernel expands each query's hit bits into its slots
  from the per-query totals and block counts, in one launch; the plain
  version (:func:`resolve_pairs_plain`) searches each slot's block and
  ranks its bit. Survivors move into the P2 slots in slot order
  (:func:`compact_survivors`: the kernel ranks them from K2's per-block
  kept counts; the plain version by a cumsum and a search,
  :func:`compact_index`). A batch whose totals pass
  its budgets comes back truncated query-major, as in JAX, and is re-run.
  Nothing between ``submit``'s entry and its return waits for the card.
* :class:`DevicePipeline` ports the host side: query preparation, the window
  split, the band plan, the sticky pair budgets (overflow escalation, the
  top-bucket split, de-escalation), the asynchronous submit/collect, and the
  float64 ranking tail (the native C++ one, or the numpy one). On a CUDA
  device ``submit`` packs the query arrays into one pinned host buffer and
  one copy, enqueues the core on the pipeline's own stream, packs its
  outputs into one byte buffer copied into pinned memory, and returns;
  ``collect`` waits for the batch's event (the outputs are already one
  buffer on the card: :func:`_pack` copies nothing). Every launch costs
  host time that the card cannot hide, so the glue is written for few
  launches. A CPU pipeline runs the same code on the CPU, with no stream
  and no pinning.

What the JAX version needed for XLA's static shapes on a TPU and the port
leaves out:

* the cross-process budget-hint file: it saved TPU compiles, and PyTorch
  compiles nothing per budget;
* the radix descents of the resolve (``_searchsorted_radix`` and the block
  descent): the kernel expands the hits instead of searching for them;
* the packed output buffer's int32 bitcasts and run-length query bounds
  (``_pack_query_out``): the port packs the outputs' bytes as they are;
* the ``max_B`` batch ceiling, the band-width compile ceiling with its
  split, and the band-width buckets: there is no compile step on the card,
  so a batch runs with its exact band. The one cap left is on memory: a
  batch whose stage-A hit bits (queries x band rows) pass
  :attr:`DevicePipeline.max_hit_bits` splits into charcount-contiguous
  sub-batches, joined as the window split joins its sub-batches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from itertools import repeat
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (
    Distance,
    MAX_ANAGRAM_DISTANCE,
    MAX_EDIT_DISTANCE,
    SearchParameters,
    StopCriterion,
    ThresholdKind,
    VariantResult,
    rank_results,
)
from ..utils.native import fastemit_build_result_lists, rank_tail_native
from ..utils.profiling import StageTimer
from ..convert import (
    DeviceIndex, band_width, count_planes, device_index, host_layout,
)
from ..device import resolve_device
from . import _build
from .dl import ScoreInputs, dl_lcs_slots, slot_block
from .rank_batch import rank_fast_batch
from .ranked import RankedResults
from .stage_a import ROW_BLOCK, _b_tile, stage_a_masks

THRESHOLD_SLACK = 1e-4
B_BUCKETS = (8, 64, 256, 1024, 2048, 4096, 8192)
B_BASE = 1024  # batch size the initial pair budgets scale from
# candidate-pair budgets; a batch over the top one splits (collect)
P_BUCKETS = (
    2048, 8192, 32768, 131072, 262144, 393216, 524288, 786432, 1048576,
    1572864,
)
P2_BUCKETS = (2048, 16384, 32768, 49152, 65536, 98304, 131072, 262144)
# DL exactness windows (12 = reference MAX_EDIT_DISTANCE)
WINDOW_BUCKETS = (3, 6, 12)
HIT_BLOCK = 128  # rows per stage-A hit count (counts_t)


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _params_key(params: SearchParameters) -> tuple:
    """Hashable fingerprint of a SearchParameters (oracle-memo key)."""
    return dataclasses.astuple(params)


def _resolve_thresholds(threshold, lens: np.ndarray, cap: int) -> np.ndarray:
    """Vectorized DistanceThreshold.resolve (lib.rs:982-1012 semantics)."""
    if threshold.kind is ThresholdKind.RATIO:
        return np.minimum((lens * threshold.ratio).astype(np.int32), cap)
    if threshold.kind is ThresholdKind.RATIO_WITH_LIMIT:
        return np.minimum(
            (lens * threshold.ratio).astype(np.int32), threshold.limit
        )
    return np.minimum(threshold.limit, lens // 2).astype(np.int32)


def _batch_rows(n: int) -> int:
    """Padded batch size: the JAX package's buckets up to 8192 queries, then
    whole band tiles."""
    if n <= B_BUCKETS[-1]:
        return _bucket(n, B_BUCKETS)
    return -(-n // 1024) * 1024


def query_planes_plain(index: DeviceIndex, q_counts):
    """int8 [B, at_pad] binarized count planes of the queries in the
    index's threshold-major order (column ``t*A + a``: ``count[a] > t``;
    the JAX core's planes, ops/pipeline.py:403-409, under
    ``convert.plane_columns``), zero-padded to the index's plane width, as
    torch ops: the plain version of :func:`query_planes`."""
    T = index.at // q_counts.shape[1]
    qbin = count_planes(q_counts.clamp(max=T), T)
    return torch.nn.functional.pad(qbin, (0, index.bins.shape[1] - index.at))


def query_planes(index: DeviceIndex, q_counts, totals=None):
    """The queries' int8 ``[B, at_pad]`` binarized count planes, as
    :func:`query_planes_plain` gives them; ``totals`` (int32 ``[2, B]``,
    stage A's ``nmatch`` and ``nexact``, which K1 adds to) is zeroed too.
    Kernel K5 (``csrc/planes.cu``, one launch) for CUDA tensors, the plain
    version (and ``zero_``) for CPU tensors."""
    B, A = q_counts.shape
    at_pad = index.bins.shape[1]
    dev = q_counts.device
    if (q_counts.dtype != torch.int32 or not q_counts.is_contiguous()
            or index.bins.device != dev):
        raise ValueError(f"query_planes: q_counts is {q_counts.dtype} on "
                         f"{dev}, wants contiguous int32 on "
                         f"{index.bins.device}")
    if totals is not None and (
            totals.dtype != torch.int32 or tuple(totals.shape) != (2, B)
            or not totals.is_contiguous() or totals.device != dev):
        raise ValueError(f"query_planes: totals is {totals.dtype} "
                         f"{tuple(totals.shape)} on {totals.device}, wants "
                         f"contiguous int32 (2, {B}) on {dev}")
    if dev.type == "cpu":
        if totals is not None:
            totals.zero_()
        return query_planes_plain(index, q_counts)
    if dev.type != "cuda":
        raise ValueError(f"query_planes: unsupported device {dev}")
    planes = torch.empty((B, at_pad), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.load("planes").analiticcl_planes(
            q_counts.data_ptr(), planes.data_ptr(),
            None if totals is None else totals.data_ptr(), B, A,
            index.at // A, at_pad, torch.cuda.current_stream(dev).cuda_stream)
    query_planes.launches += 1
    _build.check(err, "planes kernel launch")
    return planes


query_planes.launches = 0


_TABLES: dict = {}


class _ByteTables(NamedTuple):
    popcount: torch.Tensor  # float32 [256]: set bits of each byte value
    select: torch.Tensor  # int64 [256 * 9]: (v * 9 + k) -> k-th set bit
    upper: torch.Tensor  # float32 [16, 16]: ones on and above the diagonal


def _byte_tables(dev) -> _ByteTables:
    """Lookup tables over byte values, made on ``dev`` by torch ops (no
    host copy) and kept. ``select[v * 9 + k]`` is the position of the
    k-th set bit (k = 1..8) of the byte v, 7 past its last."""
    tabs = _TABLES.get(dev)
    if tabs is None:
        lanes = torch.arange(8, device=dev)
        bits = (torch.arange(256, device=dev)[:, None] >> lanes) & 1
        upto = bits.cumsum(1)  # set bits at or below each position
        k = torch.arange(9, device=dev)
        select = (upto[:, None, :] < k[None, :, None]).sum(2).clamp(max=7)
        tabs = _ByteTables(
            bits.sum(1).float(), select.reshape(-1),
            torch.ones(16, 16, device=dev).triu(),
        )
        _TABLES[dev] = tabs
    return tabs


def resolve_pairs_plain(packed_q, counts_t, nmatch, start_blk, Ni_pad: int,
                        P: int):
    """:func:`resolve_pairs` as torch ops, one search per slot: the
    kernel's plain version.

    The JAX core finds a slot's query by a search over the per-query totals,
    then its block by a search over that query's block counts. Both collapse
    into one search over the query-major cumsum of ``counts_t``, whose row
    ends are the per-query totals (``nmatch``, which only the kernel reads).
    In the block's 16 bytes of hit bits, a
    matrix product with a triangular matrix gives the popcount prefix sums
    (exact: small integers), which locate the byte; a table gives the bit.
    Slots past the total read the last block and are invalid: the JAX core
    masks their query and row as well, but no output depends on them."""
    B, nbytes = packed_q.shape
    M_band = counts_t.shape[0]
    dev = packed_q.device
    tabs = _byte_tables(dev)
    slot = torch.arange(1, P + 1, dtype=torch.int64, device=dev)
    counts = counts_t.t().reshape(-1)  # [B * M_band], query-major
    bcum = torch.cumsum(counts, 0, dtype=torch.int64)
    total = bcum[-1]
    fb = torch.searchsorted(bcum, slot).clamp_(max=B * M_band - 1)
    rank = slot - (bcum - counts)[fb]  # 1-based rank within the block
    row = packed_q.view(B * M_band, HIT_BLOCK // 8)[fb].long()  # [P, 16]
    pop = tabs.popcount[row]
    within = pop @ tabs.upper  # inclusive prefix sums of set bits
    byte = (within < rank[:, None]).sum(1).clamp_(max=HIT_BLOCK // 8 - 1)
    rank_in_byte = rank - (within - pop).gather(1, byte[:, None])[:, 0]
    bit = tabs.select[row.gather(1, byte[:, None])[:, 0] * 9
                      + rank_in_byte.long().clamp_(max=8)]
    q = fb // M_band
    pc_band = (fb % M_band) * HIT_BLOCK + byte * 8 + bit
    row0 = (start_blk.long() * ROW_BLOCK)[q // _b_tile(B, Ni_pad)]
    i32 = torch.int32
    return (q.to(i32), pc_band.to(i32), (row0 + pc_band).to(i32),
            slot <= total, total)


def _check_resolve(packed_q, counts_t, nmatch, start_blk, Ni_pad):
    B, nbytes = packed_q.shape
    M_band = counts_t.shape[0]
    bt = _b_tile(B, Ni_pad)
    want = {
        "packed_q": (packed_q, torch.uint8, (B, M_band * HIT_BLOCK // 8)),
        "counts_t": (counts_t, torch.int32, (M_band, B)),
        "nmatch": (nmatch, torch.int32, (B,)),
        "start_blk": (start_blk, torch.int32, (B // bt,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"resolve_pairs: {name} is {t.dtype} {tuple(t.shape)}, "
                f"wants contiguous {dtype} {shape}"
            )
        if t.device != packed_q.device:
            raise ValueError(f"resolve_pairs: {name} on {t.device}, "
                             f"packed_q on {packed_q.device}")
    return B, M_band, bt


def resolve_pairs(packed_q, counts_t, nmatch, start_blk, Ni_pad: int,
                  P: int):
    """The (query, band row, device row) of each of ``P`` pair slots, int32,
    the validity of each slot, and the int64 hit total: slot ``p`` holds the
    ``p + 1``-th stage-A hit in query-major, then band-row order, the
    reference's gather order (the JAX core's resolve,
    ``analiticcl_tpu/ops/pipeline.py:450-592``). Hits past ``P`` are
    dropped; the total counts them. Slots past the total hold the last
    query and the last row of its band. Kernel K3 (``csrc/resolve.cu``, one
    launch) for CUDA tensors, :func:`resolve_pairs_plain` for CPU
    tensors; both give the same slots."""
    B, M_band, bt = _check_resolve(packed_q, counts_t, nmatch, start_blk,
                                   Ni_pad)
    dev = packed_q.device
    if dev.type == "cpu":
        return resolve_pairs_plain(packed_q, counts_t, nmatch, start_blk,
                                   Ni_pad, P)
    if dev.type != "cuda":
        raise ValueError(f"resolve_pairs: unsupported device {dev}")
    slots = torch.empty((3, P), dtype=torch.int32, device=dev)
    valid = torch.empty(P, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    lib = _build.load("resolve")
    with torch.cuda.device(dev):
        err = lib.analiticcl_resolve(
            packed_q.data_ptr(), counts_t.data_ptr(), nmatch.data_ptr(),
            start_blk.data_ptr(), slots[0].data_ptr(), slots[1].data_ptr(),
            slots[2].data_ptr(), valid.data_ptr(), total.data_ptr(),
            B, M_band, bt, P,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    resolve_pairs.launches += 1
    _build.check(err, "resolve kernel launch")
    return slots[0], slots[1], slots[2], valid, total


resolve_pairs.launches = 0


def compact_index(keep, P2: int):
    """Where the survivors of ``keep`` go, in order (the JAX ``_compact``):
    slot ``j`` of ``P2`` takes the first position where the cumsum of
    ``keep`` reaches ``j + 1``. Returns those positions (clamped into
    range), whether each slot takes one, and the number of set
    positions."""
    n = keep.shape[0]
    csum = torch.cumsum(keep, 0, dtype=torch.int64)
    idx = torch.searchsorted(
        csum, torch.arange(1, P2 + 1, dtype=torch.int64, device=keep.device)
    )
    hit = idx < n
    return idx.clamp_(max=n - 1), hit, csum[-1]


def compact_survivors_plain(keep, counts, block: int, q, pc, met, max_freq,
                            total_match, P2: int):
    """:func:`compact_survivors` as torch ops (:func:`compact_index` and
    three gathers; ``counts`` and ``block`` are not read): the kernel's
    plain version."""
    B = max_freq.shape[0]
    idx, hit, total_keep = compact_index(keep, P2)
    o_q = torch.where(hit, q[idx], B)
    o_c = torch.where(hit, pc[idx], 0)
    o_met = torch.where(hit, met[:, idx], 0)
    return (o_q, o_c, *o_met.unbind(), max_freq, total_match, total_keep)


def _output_views(flat, B: int, P2: int, met_dtype=torch.uint8) -> tuple:
    """The core's ten outputs as views of K4's buffer ``flat``, which holds
    them as :func:`_pack` lays them out: ``max_freq`` (int64 ``[B]``),
    ``total_match``, ``total_keep`` (int64), ``o_q``, ``o_c`` (int32
    ``[P2]``), the five metric columns (``[P2]``, ``met_dtype``: uint8, or
    int32 from L 256). A few slices, for the host's sake: every view op
    costs enqueue time."""
    wide = 8 * (B + 2)
    i64 = flat[:wide].view(torch.int64)
    qc = flat[wide : wide + 8 * P2].view(torch.int32).view(2, P2)
    met = flat[wide + 8 * P2 :]
    if met_dtype != torch.uint8:
        met = met.view(met_dtype)
    met = met.view(5, P2)
    return (qc[0], qc[1], *met.unbind(), i64[:B], i64[B], i64[B + 1])


def _check_compact(keep, counts, block, q, pc, met, max_freq, total_match):
    P = keep.shape[0]
    B = max_freq.shape[0]
    want = {
        "keep": (keep, torch.bool, (P,)),
        "counts": (counts, torch.int32, (-(-P // block),)),
        "q": (q, torch.int32, (P,)), "pc": (pc, torch.int32, (P,)),
        "met": (met, torch.int32 if met.dtype == torch.int32
                else torch.uint8, (5, P)),
        "max_freq": (max_freq, torch.int64, (B,)),
        "total_match": (total_match, torch.int64, ()),
    }
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != keep.device):
            raise ValueError(
                f"compact_survivors: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, wants contiguous {dtype} {shape} on "
                f"{keep.device}")
    return P, B


def compact_survivors(keep, counts, block: int, q, pc, met, max_freq,
                      total_match, P2: int) -> tuple:
    """The core's ten outputs from the scored slots: the kept slots of
    ``keep`` moved in slot order into ``P2`` survivor slots (their query
    ``q``, device row ``pc`` and five metric rows ``met``; the slots past
    the survivors hold query ``B`` and zeros, the JAX ``_compact`` and its
    fill, ``analiticcl_tpu/ops/pipeline.py:242-266, 726-750``), then
    ``max_freq``, ``total_match`` and the number kept, ``total_keep`` (all
    of them: survivors past ``P2`` are dropped). ``counts`` holds the kept
    slots of each block of ``block`` slots (:class:`~.dl.SlotScore`).
    Kernel K4 (``csrc/compact.cu``, one launch) for CUDA tensors: it writes
    the ten into one byte buffer as :func:`_pack` lays them out and
    returns their views of it, which :func:`_pack` passes on without a
    copy. :func:`compact_survivors_plain` for CPU tensors; both give the
    same values. ``met`` is uint8, or int32 from L 256
    (:func:`~.dl.met_dtype`); the outputs keep its dtype."""
    P, B = _check_compact(keep, counts, block, q, pc, met, max_freq,
                          total_match)
    dev = keep.device
    if dev.type == "cpu":
        return compact_survivors_plain(keep, counts, block, q, pc, met,
                                       max_freq, total_match, P2)
    if dev.type != "cuda":
        raise ValueError(f"compact_survivors: unsupported device {dev}")
    if keep.data_ptr() % 16 or counts.data_ptr() % 16:
        raise ValueError("compact_survivors: keep and counts must start at a "
                         "16-byte boundary (the kernel loads them 16 bytes "
                         "at a time)")
    mb = met.element_size()
    flat = torch.empty(8 * (B + 2) + (8 + 5 * mb) * P2, dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        err = _build.load("compact").analiticcl_compact(
            counts.data_ptr(), counts.numel(), block, keep.data_ptr(),
            q.data_ptr(), pc.data_ptr(), met.data_ptr(), mb,
            max_freq.data_ptr(), total_match.data_ptr(), flat.data_ptr(), B,
            P, P2, torch.cuda.current_stream(dev).cuda_stream)
    compact_survivors.launches += 1
    _build.check(err, "compact kernel launch")
    return _output_views(flat, B, P2, met.dtype)


compact_survivors.launches = 0


class StageA(NamedTuple):
    packed_q: torch.Tensor  # uint8 [B, Nb / 8] hit bits
    exact_q: torch.Tensor  # uint8 [B, Nb / 8] exact-anagram bits
    counts_t: torch.Tensor  # int32 [Nb / 128, B] hits per 128 band rows
    nmatch: torch.Tensor  # int32 [B] hits per query
    nexact: torch.Tensor  # int32 [B] exact anagrams per query


# Profiling prefixes of query_core, in order: each returns int32 checksums
# of its stage's outputs (:func:`probe`) in place of the rest of the core.
# The JAX core's stops of the same names (analiticcl_tpu/ops/pipeline.py:385)
# probe the same arrays.
STAGE_A_STOPS = ("noop", "stageA")
STAGE_B_STOPS = ("resolve", "gather_dl", "score", "compact_sum")
STOP_STAGES = STAGE_A_STOPS + STAGE_B_STOPS


def _check_stop(stop_stage: Optional[str], allowed: Tuple[str, ...]) -> None:
    if stop_stage is None or stop_stage in allowed:
        return
    if stop_stage in ("resolve_pre", "resolve_tables"):
        raise ValueError(
            f"stop_stage {stop_stage!r} has no stage in the port: it "
            "expands stage A's hits into their slots from a scan of the "
            "per-query totals (resolve_pairs), with no per-query search or "
            "radix tables before it; stop at 'resolve' instead"
        )
    raise ValueError(f"stop_stage {stop_stage!r} is not one of {allowed}")


def probe(*tensors) -> tuple:
    """int32 checksums standing in for a stage's outputs: each tensor cast
    to int32 and summed with int32 wrap-around, the JAX core's
    ``jnp.sum(a.astype(jnp.int32))``."""
    out = []
    for t in tensors:
        s = t.to(torch.int32).sum(dtype=torch.int64)
        out.append(torch.remainder(s + 2**31, 2**32).sub_(2**31)
                   .to(torch.int32))
    return tuple(out)


def query_stage_a(index: DeviceIndex, q_counts, q_cc, k_ana, k_len,
                  start_blk, nb_band: int, width: int, *,
                  stop_stage: Optional[str] = None):
    """Stage A of :func:`query_core`: the query planes (kernel K5), then
    banded retrieval (kernel K1) over ``index``'s rows at the k ``width``
    the band plan gives (the largest block extent its tiles read,
    ``convert.band_width``). ``stop_stage``
    ``"noop"`` returns the probes of ``(q_cc, k_ana)`` before any device
    work, ``"stageA"`` those of the stage's outputs (every 64th byte
    column of the bits)."""
    _check_stop(stop_stage, STAGE_A_STOPS)
    if stop_stage == "noop":
        return probe(q_cc, k_ana)
    # K5 writes the planes and zeroes the totals K1 adds to
    totals = torch.empty((2, q_counts.shape[0]), dtype=torch.int32,
                         device=q_counts.device)
    sa = StageA(*stage_a_masks(
        index.bins, index.cc, index.validrows,
        query_planes(index, q_counts, totals), q_cc, k_ana, k_len, start_blk,
        nb_band, index.extents, width, totals=totals,
    ))
    if stop_stage == "stageA":
        return probe(sa.packed_q[:, ::64], sa.exact_q[:, ::64], sa.counts_t,
                     sa.nmatch, sa.nexact)
    return sa


def query_core(
    index: DeviceIndex,
    q_counts,  # int32 [B, A] per-character counts
    q_cc,  # int32 [B]
    q_norms,  # int8/int32 [B, L]
    q_lens,  # int32 [B]
    q_first_lower,  # bool [B]
    k_ana,  # int32 [B]
    k_ed,  # int32 [B]
    k_len,  # int32 [B]: min(k_ana, k_ed), the stage-A length-difference cap
    stop_exact,  # bool [B]
    start_blk,  # int32 [B // bt]: per-tile band start block
    weights,  # float32 [6]: ld, lcs, prefix, suffix, case, sum
    score_threshold,  # float32 scalar tensor
    *,
    have_freq: bool,
    P: int,  # candidate-pair slots
    P2: int,  # survivor slots
    window: int,  # DL exactness window (>= every per-query edit distance)
    nb_band: int,  # band width in ROW_BLOCK blocks
    width: int,  # stage A's k width (query_stage_a)
    use_stop_exact: bool = True,
    stop_stage: Optional[str] = None,  # profiling: one of STOP_STAGES
):
    """One batch through stage A, the slot resolve, stage B and the f32
    pre-filter. Survivors come back in (query, device row) order. With
    ``stop_stage`` the core ends after that stage and returns its probes
    (:func:`query_stage_a`, :func:`query_stage_b`)."""
    _check_stop(stop_stage, STOP_STAGES)
    stop_a = stop_stage if stop_stage in STAGE_A_STOPS else None
    sa = query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                       nb_band, width, stop_stage=stop_a)
    if stop_a is not None:
        return sa
    return query_stage_b(
        index, sa, stop_exact & (sa.nexact > 0), q_norms, q_lens,
        q_first_lower, k_ed, start_blk, weights, score_threshold,
        have_freq=have_freq, P=P, P2=P2, window=window,
        use_stop_exact=use_stop_exact, stop_stage=stop_stage,
    )


def query_stage_b(
    index: DeviceIndex,
    sa: StageA,
    use_exact,  # bool [B]: the query keeps only its exact-anagram pairs
    q_norms, q_lens, q_first_lower, k_ed, start_blk, weights,
    score_threshold,
    *,
    have_freq: bool,
    P: int,
    P2: int,
    window: int,
    use_stop_exact: bool = True,
    stop_stage: Optional[str] = None,
):
    """Stage B of :func:`query_core` over stage A's hits in ``index``: the
    slot resolve at ``P`` (kernel K3), the pair loading, DL + LCS, the
    affixes, the f32 score and the keep tests (K2's slot entry and its
    epilogue), and the survivor compaction into ``P2`` slots (kernel K4).
    ``use_exact`` is separate because under a sharded index it depends on
    every shard's exact count. ``stop_stage`` (one of
    :data:`STAGE_B_STOPS`) ends it after that stage with the probes the JAX
    core gives there."""
    _check_stop(stop_stage, STAGE_B_STOPS)
    packed_q = sa.packed_q
    B = packed_q.shape[0]
    Ni_pad = index.bins.shape[0]
    q, pc_band, pc, pvalid, total_match = resolve_pairs(
        packed_q, sa.counts_t, sa.nmatch, start_blk, Ni_pad, P
    )
    if stop_stage == "resolve":
        # the JAX core masks the slots past the total (query B, row 0)
        return probe(torch.where(pvalid, q, B),
                     torch.where(pvalid, pc.clamp(max=Ni_pad - 1), 0))

    # ---- stage B: the pairs' strings, DL + LCS and the affixes (K2) ----
    slot_args = (index, q_norms, q_lens, k_ed, q_first_lower, q, pc, pvalid,
                 window)
    if stop_stage == "gather_dl":
        m = dl_lcs_slots(*slot_args)
        return probe(m.ld, m.lcs, m.pf, m.sf)

    # ---- the f32 score and the keep tests, in the JAX core's operation
    # order, in K2's epilogue ----
    s = dl_lcs_slots(*slot_args, score=ScoreInputs(
        pc_band, sa.exact_q, use_exact if use_stop_exact else None, weights,
        score_threshold - THRESHOLD_SLACK,
        index.freqs if have_freq else None, stop_stage == "score"))
    if stop_stage == "score":
        return probe(s.keep, s.max_freq) + ((s.score * s.keep).sum(),)

    # ---- survivor compaction into P2 slots, order kept; unused slots hold
    # query B and zeros; the metrics are uint8 below L 256, int32 from it
    # (K4) ----
    out = compact_survivors(s.keep, s.counts, slot_block(q_norms.shape[1]),
                            q, pc, s.met, s.max_freq, total_match, P2)
    if stop_stage == "compact_sum":
        return probe(*out[:7])
    return out


def _one_buffer(tensors, layout):
    """The bytes of ``tensors`` as one flat view, where they already lie
    back to back in ``layout``'s order in one buffer (K4's outputs), else
    None."""
    first = tensors[layout[0][0]]
    storage = first.untyped_storage().data_ptr()
    at = first.data_ptr()
    for i, _, _ in layout:
        t = tensors[i]
        if (t.data_ptr() != at or not t.is_contiguous()
                or t.untyped_storage().data_ptr() != storage):
            return None
        at += t.numel() * t.element_size()
    head = first.view(-1).view(torch.uint8)
    return head.as_strided((at - first.data_ptr(),), (1,))


def _pack(tensors):
    """One flat byte tensor holding ``tensors``, widest dtype first so that
    every piece stays aligned, and the layout :func:`_unpack` reads it
    back with: one copy moves them all. Tensors that already lie so in one
    buffer are passed on as its view, with no copy."""
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    layout = [(i, tensors[i].dtype, tuple(tensors[i].shape)) for i in order]
    flat = _one_buffer(tensors, layout)
    if flat is None:
        flat = torch.cat([tensors[i].reshape(-1).view(torch.uint8)
                          for i in order])
    return flat, layout


def _unpack(flat, layout) -> list:
    """The tensors :func:`_pack` packed into ``flat``, as views of it."""
    out = [None] * len(layout)
    off = 0
    for i, dtype, shape in layout:
        n = int(np.prod(shape)) * dtype.itemsize
        out[i] = flat[off : off + n].view(dtype).view(shape)
        off += n
    return out


class Fetched(NamedTuple):
    """A collected batch's outputs on the host."""

    cols: tuple  # o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case: valid slots
    max_freq: np.ndarray  # uint32 [B]
    total_match: int  # stage-A hits (summed over shards)
    total_keep: int  # f32-filter survivors (summed over shards)
    peak_match: int  # the largest hit total of one core call: against P
    peak_keep: int  # the largest survivor total of one core call: against P2


class DevicePipeline:
    """A built model's index on one device, and the batched query over it."""

    # Largest B x band rows of one query_core call: stage A writes two
    # bitmaps of that many bits (128 MiB each here) and the slot resolve a
    # cumsum over its 128-row blocks (64 MiB of int64). Larger batches split
    # (``prepare``).
    max_hit_bits = 1 << 30

    # K2 and the gathers run over all P slots, so an escalated budget taxes
    # every later batch. After DEESC_N collected batches of one batch size,
    # budgets step down to the bucket of the window's largest totals with
    # DEESC_MARGIN headroom where that is lower.
    DEESC_N = 6
    DEESC_MARGIN = 1.3

    def __init__(self, model, device):
        self.model = model
        self.device = resolve_device(device)
        lay = host_layout(model)
        self.A = model.alphabet_size()
        self.L = lay.L
        self.Ni_pad = len(lay.cc)
        self.M_total = self.Ni_pad // ROW_BLOCK
        self._canon_of = lay.canon_of
        self._cc_dev = lay.cc  # host copy for the exact band plan
        self._norm_dtype = lay.norms2.dtype
        self.index = device_index(
            lay.bins, lay.cc, lay.validrows, lay.norms2, lay.norm_lens,
            lay.freqs, lay.first_lower, self.device,
        )
        self._init_async([self.device], model.index.size)
        self._share_with_stream(self.index)
        self._refresh_variant_flags()
        self.stats = StageTimer()
        # stage-A hits and f32-filter survivors summed over collected batches
        self.candidates = 0
        self.survivors = 0
        # (text, params, early-confusables flag, confusable count) -> oracle
        # results for over-long queries; cleared whenever frequencies
        # refresh (freq_score is part of the results). The confusables'
        # flag and count may change on a model that has served queries.
        self._oracle_memo: dict = {}

    def _init_async(self, devices, budget_rows: int) -> None:
        """The sticky budgets (sized from ``budget_rows`` index rows per
        core call) and, on CUDA, one stream per device for the pipeline's
        device work."""
        self._budget_rows = budget_rows
        self._P_by_B: dict = {}
        self._P2_by_B: dict = {}
        self._obs_max: dict = {}
        self._obs_n: dict = {}
        self._streams = {
            d: torch.cuda.Stream(d) for d in set(devices) if d.type == "cuda"
        }
        self.stream = self._streams.get(self.device)

    def _on(self, dev):
        """The context that makes the pipeline's stream on ``dev`` current."""
        s = self._streams.get(dev)
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def _share_with_stream(self, idx: DeviceIndex) -> None:
        """Index tensors are made on the default stream and read on the
        pipeline's: their memory is reused only after the pipeline's stream
        is done with them."""
        s = self._streams.get(idx.bins.device)
        if s is not None:
            for t in idx[:8]:
                t.record_stream(s)

    def _refresh_variant_flags(self, linked=None) -> None:
        """Rows whose vocab entries carry variant links take the exact
        object ranking tail, which expands them (``expand_variants``,
        reference lib.rs:1677-1727); the rest take the fast tail.

        With ``linked`` (the vids whose variant lists may have changed),
        only their rows are updated instead of scanning the decoder."""
        model = self.model
        decoder = model.decoder
        if linked is None:
            dec_flags = np.fromiter(
                (e.variants is not None for e in decoder), dtype=bool,
                count=len(decoder),
            )
            self._has_variants = dec_flags[model.index.vocab_ids]
        else:
            inv = model.index.vid_to_row()
            vids = np.fromiter(linked, dtype=np.int64)
            vids = vids[vids < inv.shape[0]]
            rows = inv[vids]
            vids, rows = vids[rows >= 0], rows[rows >= 0]
            self._has_variants[rows] = np.fromiter(
                (decoder[v].variants is not None for v in vids.tolist()),
                dtype=bool, count=len(vids),
            )
        self._has_var_u8 = (
            np.ascontiguousarray(self._has_variants, dtype=np.uint8)
            if self._has_variants.any()
            else None
        )

    def refresh_freqs(self, freqs_canonical: np.ndarray, linked=None) -> None:
        """Replace the device frequency column (canonical row order in).

        Learn calls this after a merge that added no index entry; the merge
        may still have given indexed entries variant links, so the variant
        flags are refreshed too (the JAX pipeline keeps them stale): those
        of the ``linked`` vids, or all of them when ``linked`` is None."""
        freqs = np.asarray(freqs_canonical[self._canon_of], dtype=np.int64)
        self.index = self.index._replace(
            freqs=torch.from_numpy(freqs).to(self.device)
        )
        self._share_with_stream(self.index)
        self._refresh_variant_flags(linked)
        self._oracle_memo.clear()

    # ------------------------------------------------------------------

    def find_variants_batch(
        self, inputs: Sequence[str], params: SearchParameters
    ) -> List[List[VariantResult]]:
        return self.collect(self.submit(inputs, params))

    def find_variants_stream(
        self, batches, params: SearchParameters, depth: int = 2,
        ranked: bool = False,
    ):
        """Yields one result list per input batch, in order, keeping up to
        ``depth`` submitted batches ahead of the one being ranked. On a CUDA
        pipeline ``submit`` returns before the card has run its batch, so
        from depth 1 the card runs the next batches while the host prepares
        and ranks this one. With ``ranked``, batches that complete through
        the native tail yield :class:`RankedResults` instead of eager lists;
        callers handle both."""
        pending: List = []
        for batch in batches:
            st = self.submit(batch, params)
            st["want_ranked"] = ranked
            pending.append(st)
            if len(pending) > depth:
                yield self.collect(pending.pop(0))
        while pending:
            yield self.collect(pending.pop(0))

    def submit(self, inputs: Sequence[str], params: SearchParameters):
        """Host prep, then the device call enqueued at the batch size's
        sticky budgets; on a CUDA pipeline nothing in it waits for the card.
        Pair with :meth:`collect`."""
        state = self.prepare(inputs, params)
        if "args" in state:
            with self.stats.stage("dispatch"):
                P, P2 = self._budgets(state["B"])
                state["submit_P"], state["submit_P2"] = P, P2
                state["out"] = self._dispatch(state, P, P2)
        return state

    def _dispatch(self, state, P: int, P2: int):
        """Enqueue a prepared batch's device call at budgets (P, P2) and the
        copies of its outputs to the host: ``(host outputs per core call,
        events)``. On CUDA each device's work runs on the pipeline's stream
        there, after what the caller's stream has enqueued (index uploads,
        :meth:`refresh_freqs`); the outputs land in pinned buffers, and the
        events fire once they have. On the CPU it runs at once."""
        for dev, s in self._streams.items():
            s.wait_stream(torch.cuda.current_stream(dev))
        with self._on(self.device):
            parts = self._query(
                state["args"], state["window"], state["nb_band"],
                state["width"], state["use_stop_exact"], P, P2,
            )
            host = []
            for dev, outs in parts:
                with self._on(dev):
                    flat, layout = _pack(outs)
                    if dev.type == "cuda":
                        flat = torch.empty(
                            flat.shape, dtype=torch.uint8, pin_memory=True
                        ).copy_(flat, non_blocking=True)
                host.append((flat, layout))
        streams = dict.fromkeys(
            self._streams[dev] for dev, _ in parts if dev in self._streams
        )
        return host, [s.record_event() for s in streams]

    def _query(self, args, window: int, nb_band, width, use_stop_exact: bool,
               P: int, P2: int):
        """The device calls of one prepared batch: ``[(device, outputs)]``."""
        return [(self.device, query_core(
            self.index, *args, have_freq=bool(self.model.have_freq), P=P,
            P2=P2, window=window, nb_band=nb_band, width=width,
            use_stop_exact=use_stop_exact,
        ))]

    def _upload(self, arrays):
        """The query arrays on the pipeline's device in one copy: packed
        into one host buffer (pinned on CUDA, copied without waiting, on the
        pipeline's stream; the caching host allocator reuses a pinned block
        only after its copy has run), then viewed on the device."""
        flat, layout = _pack([torch.from_numpy(x) for x in arrays])
        if self.stream is not None:
            flat = torch.empty(
                flat.shape, dtype=torch.uint8, pin_memory=True
            ).copy_(flat)
        with self._on(self.device):
            return tuple(_unpack(flat.to(self.device, non_blocking=True),
                                 layout))

    def _fetch(self, out, B: int, P2: int) -> Fetched:
        """Wait for a dispatched batch (the ``device`` stage) and read its
        outputs (``device_get``)."""
        host, events = out
        with self.stats.stage("device"):
            for ev in events:
                ev.synchronize()
        with self.stats.stage("device_get"):
            return self._finalize(
                [_unpack(flat, layout) for flat, layout in host], B, P2
            )

    def _budgets(self, B: int) -> Tuple[int, int]:
        """Sticky (P, P2) pair budgets for batch size ``B``, set at first
        use: on the card from the index rows per core call, as the JAX
        pipeline sizes them off the CPU; on the CPU at the smallest
        buckets."""
        if B not in self._P_by_B:
            if self.device.type == "cuda":
                scale = max(1, B // B_BASE)
                self._P_by_B[B] = _bucket(
                    max(P_BUCKETS[0], (self._budget_rows // 2) * scale),
                    P_BUCKETS,
                )
                self._P2_by_B[B] = _bucket(12288 * scale, P2_BUCKETS)
            else:
                self._P_by_B[B] = P_BUCKETS[0]
                self._P2_by_B[B] = P2_BUCKETS[0]
        return self._P_by_B[B], self._P2_by_B[B]

    def _deesc_reset(self, B: int) -> None:
        self._obs_max[B] = (0, 0)
        self._obs_n[B] = 0

    def _observe_totals(self, B: int, total_match: int,
                        total_keep: int) -> None:
        """Count a collected batch into ``B``'s de-escalation window."""
        m, k = self._obs_max.get(B, (0, 0))
        self._obs_max[B] = (max(m, total_match), max(k, total_keep))
        self._obs_n[B] = self._obs_n.get(B, 0) + 1
        if self._obs_n[B] < self.DEESC_N:
            return
        m, k = self._obs_max[B]
        self._deesc_reset(B)
        P, P2 = self._budgets(B)
        P_new = _bucket(
            max(int(m * self.DEESC_MARGIN), P_BUCKETS[0]), P_BUCKETS
        )
        P2_new = _bucket(
            max(int(k * self.DEESC_MARGIN), P2_BUCKETS[0]), P2_BUCKETS
        )
        if P_new < P or P2_new < P2:
            self._P_by_B[B] = min(P, P_new)
            self._P2_by_B[B] = min(P2, P2_new)

    def _batch_rows(self, n: int) -> int:
        """Padded batch size for ``n`` active queries."""
        return _batch_rows(n)

    def _hit_bits(self, B: int, nb_band) -> int:
        """Stage-A hit bits of the largest device call of a batch: the
        quantity :attr:`max_hit_bits` caps."""
        return B * nb_band * ROW_BLOCK

    def prepare(self, inputs: Sequence[str], params: SearchParameters):
        """Host prep of one batch. The state it returns holds the results
        already known (empty, over-long), and either sub-batches (``subs``,
        one per DL window or per part under :attr:`max_hit_bits`, each
        already submitted) or :func:`query_core`'s
        arguments on the device (``args``) with its static parameters."""
        model = self.model
        enc = model.enc
        n = len(inputs)
        results: List[Optional[List[VariantResult]]] = [None] * n

        prep_cm = self.stats.stage("host_prep")
        prep_cm.__enter__()
        A, L = self.A, self.L
        all_norms, all_lens = enc.normalize_batch_padded(list(inputs), L)
        max_cand_len = int(model.index.max_norm_len)
        lens_n = all_lens[:n]
        over_mask = lens_n > L
        empty_mask = lens_n == 0
        active = np.nonzero(~over_mask & ~empty_mask)[0].tolist()
        for i in np.nonzero(empty_mask)[0].tolist():
            results[i] = []
        for i in np.nonzero(over_mask)[0].tolist():
            # longer than any index entry: provably empty when the length
            # difference exceeds the edit threshold, else the exact host path
            text = inputs[i]
            ln = int(all_lens[i])
            k_ed_i = params.max_edit_distance.resolve(ln, MAX_EDIT_DISTANCE)
            if ln - max_cand_len > k_ed_i:
                results[i] = []
            else:
                key = (text, _params_key(params),
                       model.confusables_before_pruning,
                       len(model.confusables))
                got = self._oracle_memo.get(key)
                if got is None:
                    with self.stats.stage("host_oracle_fallback"):
                        got = model._find_variants_oracle(text, params)
                    if len(self._oracle_memo) >= 100_000:
                        self._oracle_memo.clear()
                    self._oracle_memo[key] = got
                results[i] = list(got)
        if not active:
            prep_cm.__exit__(None, None, None)
            return {"results": results, "active": [], "inputs": inputs}

        B = self._batch_rows(len(active))
        act = np.asarray(active)
        # charcount-sorted queries: each tile then covers a narrow band
        cc_act = enc.counts_from_norms(all_norms[act], all_lens[act])
        cc_sums = cc_act.sum(axis=1).astype(np.int32)
        ord_cc = np.argsort(cc_sums, kind="stable")
        act = act[ord_cc]
        active = [active[i] for i in ord_cc]
        na = len(active)
        q_norms = np.zeros((B, L), dtype=self._norm_dtype)
        q_norms[:na] = all_norms[act]
        q_lens = np.zeros(B, dtype=np.int32)
        q_lens[:na] = all_lens[act]
        q_counts = np.zeros((B, A), dtype=np.int32)
        q_counts[:na] = cc_act[ord_cc]
        q_first_lower = np.zeros(B, dtype=bool)
        q_first_lower[:na] = [
            inputs[i][:1].islower() if inputs[i] else False for i in active
        ]
        k_ana = np.full(B, -1, dtype=np.int32)  # padding rows match nothing
        k_ana[:na] = _resolve_thresholds(
            params.max_anagram_distance, q_lens[:na], MAX_ANAGRAM_DISTANCE
        )
        k_ed = np.zeros(B, dtype=np.int32)
        k_ed[:na] = _resolve_thresholds(
            params.max_edit_distance, q_lens[:na], MAX_EDIT_DISTANCE
        )

        # a batch that mixes DL windows splits into one sub-batch per window,
        # so each pays only its own window and its own stage-A band
        if na > 1:
            ke = k_ed[:na]
            if _bucket(int(ke.max()), WINDOW_BUCKETS) != _bucket(
                int(ke.min()), WINDOW_BUCKETS
            ):
                wb = np.searchsorted(WINDOW_BUCKETS, ke, side="left")
                prep_cm.__exit__(None, None, None)
                return self._split(inputs, params, results, active, [
                    [active[j] for j in range(na) if wb[j] == w]
                    for w in np.unique(wb)
                ])

        # DL >= |len(a) - len(q)|: rows past min(k_ana, k_ed) cannot survive
        k_len = np.minimum(k_ana, k_ed)
        k_len[na:] = -1
        q_cc = q_counts.sum(axis=1).astype(np.int32)
        start_blk, nb_band, width = self._band_plan(q_cc, k_len, B)
        # over the memory cap: charcount-contiguous parts, each with its own
        # (narrower) band; a part still over the cap splits again
        hit_bits = self._hit_bits(B, nb_band)
        if hit_bits > self.max_hit_bits and na > 1:
            prep_cm.__exit__(None, None, None)
            nparts = min(na, -(-hit_bits // self.max_hit_bits))
            cuts = np.linspace(0, na, nparts + 1).astype(np.int64).tolist()
            return self._split(inputs, params, results, active, [
                active[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])
            ])
        stop_exact = np.full(
            B, params.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH
        )
        w = model.weights
        weights_arr = np.array(
            [w.ld, w.lcs, w.prefix, w.suffix, w.case, w.sum()], dtype=np.float32
        )
        window = _bucket(int(k_ed.max(initial=0)), WINDOW_BUCKETS)
        use_se = params.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH
        args = self._upload((
            q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana, k_ed,
            k_len, stop_exact, start_blk, weights_arr,
            np.asarray(params.score_threshold, dtype=np.float32),
        ))
        prep_cm.__exit__(None, None, None)
        return {
            "results": results, "active": active, "inputs": inputs,
            "params": params, "args": args, "window": window,
            "nb_band": nb_band, "width": width, "use_stop_exact": use_se,
            "B": B,
            "q_lens": q_lens,
        }

    def _split(self, inputs, params, results, active, groups):
        """Submit each group of active inputs as its own batch; :meth:`collect`
        joins them in input order (:meth:`_collect_subs`)."""
        subs = [
            (grp, self.submit([inputs[i] for i in grp], params))
            for grp in groups
        ]
        return {
            "results": results, "active": active, "inputs": inputs,
            "params": params, "subs": subs,
        }

    def _band_plan(self, q_cc: np.ndarray, k_ana: np.ndarray, B: int):
        """Exact per-tile charcount band plan for a (padded) query batch.

        Returns (start_blk int32 [B // bt], nb_band, width): every tile's
        block window [start, start + nb_band) covers all device rows with
        charcount in [min(q_cc - k), max(q_cc + k)] over the tile's active
        queries (k < 0 marks padding) -- the reference's sortedindex
        charcount sweep (lib.rs:1266-1288) as a block range; ``width`` is
        the largest extent of the blocks the tiles read (stage A's k width,
        which routes its launch)."""
        bt = _b_tile(B, self.Ni_pad)
        nqt = B // bt
        cc_t = q_cc.reshape(nqt, bt)
        k_t = k_ana.reshape(nqt, bt)
        act = k_t >= 0
        lo_t = np.where(act, cc_t - k_t, np.iinfo(np.int32).max).min(axis=1)
        hi_t = np.where(act, cc_t + k_t, -1).max(axis=1)
        lo_row = np.searchsorted(self._cc_dev, lo_t, side="left")
        hi_row = np.searchsorted(self._cc_dev, hi_t, side="right")
        start = (lo_row // ROW_BLOCK).astype(np.int32)
        need = np.maximum(-(-hi_row // ROW_BLOCK) - start, 1).astype(np.int32)
        nb_band = min(int(need.max(initial=1)), self.M_total)
        # keep every window inside the padded rows; moving a start down only
        # widens the coverage below
        start = np.minimum(start, self.M_total - nb_band).astype(np.int32)
        np.maximum(start, 0, out=start)
        return start, nb_band, band_width(self.index.extents_host, start,
                                          nb_band)

    def _finalize(self, host, B: int, P2: int) -> Fetched:
        """A batch's outputs on the host as numpy, cut to the valid survivor
        slots; ``max_freq`` as the uint32 floors the native tail reads."""
        (*cols, max_freq, total_match, total_keep) = (
            t.numpy() for t in host[0]
        )
        m, k = int(total_match), int(total_keep)
        n = min(k, P2)
        return Fetched(tuple(x[:n] for x in cols), max_freq.astype(np.uint32),
                       m, k, m, k)

    def _collect_split(self, state) -> List[List[VariantResult]]:
        """A batch over the top budgets: run it again in halves (each half
        submitted and collected in turn), and a single query through the
        host oracle, so that no candidate list is ever truncated."""
        results = state["results"]
        active = state["active"]
        inputs = state["inputs"]
        params = state["params"]
        texts = [inputs[i] for i in active]
        if len(active) == 1:
            sub = [self.model._find_variants_oracle(texts[0], params)]
        else:
            mid = len(active) // 2
            sub = self.collect(self.submit(texts[:mid], params))
            sub += self.collect(self.submit(texts[mid:], params))
        for i, r in zip(active, sub):
            results[i] = r
        return [r if r is not None else [] for r in results]

    def _native_obj_instances(
        self, row, perm, nbounds, o_c_dev, o_ld, o_lcs, o_pf, o_sf, o_case,
        vocab_ids,
    ) -> List[Tuple[int, Distance]]:
        """(query, canonical)-ordered (vocab_id, Distance) pairs for one row,
        read through the native tail's sorted permutation."""
        lo, hi = int(nbounds[row]), int(nbounds[row + 1])
        canon_of = self._canon_of
        ni_max = self.Ni_pad - 1
        out: List[Tuple[int, Distance]] = []
        for k in range(lo, hi):
            p = int(perm[k])
            c = int(canon_of[min(int(o_c_dev[p]), ni_max)])
            out.append((
                int(vocab_ids[c]),
                Distance(
                    ld=int(o_ld[p]), lcs=int(o_lcs[p]), prefixlen=int(o_pf[p]),
                    suffixlen=int(o_sf[p]), samecase=bool(o_case[p]),
                ),
            ))
        return out

    def _late_conf_and_finalize(
        self, results, active, inputs, params, batch_res, elig_row,
        late_conf, nrows, instances_fn, floors, q_lens,
    ) -> None:
        """Shared tail epilogue: batched late confusables, then the exact
        object path for rows the fast tail skipped."""
        model = self.model
        late_conf_batched = False
        if late_conf and batch_res is not None:
            nc = model._native_confusables()
            if nc is not None:
                row_ids = [row for row in range(nrows) if elig_row[row]]
                inputs_list = [inputs[active[row]] for row in row_ids]
                texts: List[str] = []
                input_of: List[int] = []
                decoder = model.decoder
                for ri, row in enumerate(row_ids):
                    for r in batch_res[row]:
                        texts.append(decoder[r.vocab_id].text)
                        input_of.append(ri)
                if texts:
                    try:
                        ws = nc.weights_pairs(
                            inputs_list, texts,
                            np.asarray(input_of, dtype=np.int32),
                        )
                    except Exception:
                        ws = None
                    if ws is not None:
                        pos = 0
                        for row in row_ids:
                            res = batch_res[row]
                            for j, r in enumerate(res):
                                res[j] = VariantResult(
                                    r[0], r[1] * float(ws[pos]), r[2], r[3]
                                )
                                pos += 1
                            rank_results(res, params.freq_weight)
                            batch_res[row] = model.cutoff_tail(res, params)
                        late_conf_batched = True
                else:
                    late_conf_batched = True
        for row, i in enumerate(active):
            if elig_row[row]:
                if late_conf and not late_conf_batched:
                    results[i] = model.late_rescore_and_cutoff(
                        batch_res[row], inputs[i], params
                    )
                else:
                    results[i] = batch_res[row]
            else:
                results[i] = model.score_and_rank(
                    instances_fn(row), inputs[i], int(q_lens[row]),
                    params.max_matches, params.score_threshold,
                    params.cutoff_threshold, params.freq_weight,
                    max_freq_floor=float(floors[row]),
                )

    def collect(self, state) -> List[List[VariantResult]]:
        """Fetch a submitted batch's survivors and rank them on the host."""
        results = state["results"]
        active = state["active"]
        inputs = state["inputs"]
        want_ranked = state.get("want_ranked", False)
        if not active:
            return [r if r is not None else [] for r in results]
        if state.get("subs") is not None:
            return self._collect_subs(state, want_ranked)
        params = state["params"]
        B = state["B"]
        q_lens = state["q_lens"]
        model = self.model

        got = self._fetch(state["out"], B, state["submit_P2"])
        # compare with the budgets THIS batch ran with: under a stream, a
        # de-escalation between its submit and collect is no overflow
        P, P2 = state["submit_P"], state["submit_P2"]
        while True:
            overflowed = False
            if got.peak_match > P and P < P_BUCKETS[-1]:
                self._P_by_B[B] = max(
                    self._P_by_B[B], _bucket(got.peak_match, P_BUCKETS)
                )
                overflowed = True
            if got.peak_keep > P2 and P2 < P2_BUCKETS[-1]:
                self._P2_by_B[B] = max(
                    self._P2_by_B[B], _bucket(got.peak_keep, P2_BUCKETS)
                )
                overflowed = True
            if not overflowed:
                if got.peak_match > P or got.peak_keep > P2:
                    # over the top buckets: the outputs are truncated
                    # query-major and are never ranked
                    print(
                        f"WARNING: pair budget overflow ({got.peak_match} "
                        f"matches / {got.peak_keep} kept at P={P}/P2={P2}); "
                        f"splitting batch",
                        file=sys.stderr,
                    )
                    return self._collect_split(state)
                break
            self._deesc_reset(B)
            P, P2 = self._budgets(B)
            with self.stats.stage("dispatch"):
                out = self._dispatch(state, P, P2)
            got = self._fetch(out, B, P2)
        self._observe_totals(B, got.peak_match, got.peak_keep)
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case = got.cols
        max_freq = got.max_freq
        total_match, total_keep = got.total_match, got.total_keep
        self.candidates += total_match
        self.survivors += total_keep

        tail_cm = self.stats.stage("host_tail")
        tail_cm.__enter__()
        index = model.index
        vocab_ids = index.vocab_ids
        late_conf = (
            bool(model.confusables) and not model.confusables_before_pruning
        )
        fast_ok = (not model.confusables or late_conf) and getattr(
            model, "fast_tail", True
        )
        nrows = len(active)

        # ---- native one-call ranking tail (exact f64) ----
        nt = None
        if fast_ok:
            with self.stats.stage("tail_native"):
                w = model.weights
                nt = rank_tail_native(
                    o_q, o_c, (o_ld, o_lcs, o_pf, o_sf, o_case),
                    self._canon_of, q_lens,
                    index.freqs if model.have_freq else None,
                    self._has_var_u8, vocab_ids, max_freq, nrows,
                    (w.ld, w.lcs, w.prefix, w.suffix, w.case, w.sum()),
                    params.score_threshold, params.cutoff_threshold,
                    params.freq_weight, params.max_matches,
                    bool(model.have_freq), late_conf,
                )
        if nt is not None:
            (n_out, r_seg, r_vid, r_ds, r_fq, elig_u8, perm, nbounds) = nt
            if want_ranked and not late_conf:
                # array-backed result (search mode, strict learn): rows with
                # expandable variants and pre-resolved inputs become eager
                # overrides
                with self.stats.stage("tail_emit"):
                    sb = np.searchsorted(
                        r_seg[:n_out], np.arange(nrows + 1)
                    ).astype(np.int64)
                    row_of = np.full(len(results), -1, dtype=np.int64)
                    overrides = {}
                    floors = max_freq[:B].astype(np.float64)
                    for row, i in enumerate(active):
                        if elig_u8[row]:
                            row_of[i] = row
                            continue
                        overrides[i] = model.score_and_rank(
                            self._native_obj_instances(
                                row, perm, nbounds, o_c, o_ld, o_lcs, o_pf,
                                o_sf, o_case, vocab_ids,
                            ),
                            inputs[i], int(q_lens[row]), params.max_matches,
                            params.score_threshold, params.cutoff_threshold,
                            params.freq_weight,
                            max_freq_floor=float(floors[row]),
                        )
                    for i, r in enumerate(results):
                        if r is not None:
                            overrides[i] = r
                    rr = RankedResults(
                        len(results), r_vid[:n_out], r_ds[:n_out],
                        r_fq[:n_out], row_of, sb, overrides,
                    )
                tail_cm.__exit__(None, None, None)
                self._debug_report(nrows, total_match, total_keep, state)
                return rr
            with self.stats.stage("tail_emit"):
                elig_row = np.zeros(B, dtype=bool)
                elig_row[:nrows] = elig_u8.view(bool)
                sbounds_arr = np.searchsorted(
                    r_seg[:n_out], np.arange(nrows + 1)
                ).astype(np.int64)
                femit = fastemit_build_result_lists()
                if femit is not None:
                    batch_res: List[List[VariantResult]] = femit(
                        VariantResult,
                        np.ascontiguousarray(r_vid[:n_out], dtype=np.int64),
                        np.ascontiguousarray(r_ds[:n_out], dtype=np.float64),
                        np.ascontiguousarray(r_fq[:n_out], dtype=np.float64),
                        sbounds_arr,
                        nrows,
                    )
                else:
                    sbounds = sbounds_arr.tolist()
                    all_objs = list(map(
                        tuple.__new__,
                        repeat(VariantResult),
                        zip(
                            r_vid[:n_out].tolist(), r_ds[:n_out].tolist(),
                            r_fq[:n_out].tolist(), repeat(None),
                        ),
                    ))
                    batch_res = [
                        all_objs[sbounds[g] : sbounds[g + 1]]
                        for g in range(nrows)
                    ]
                self._late_conf_and_finalize(
                    results, active, inputs, params, batch_res, elig_row,
                    late_conf, nrows,
                    lambda row: self._native_obj_instances(
                        row, perm, nbounds, o_c, o_ld, o_lcs, o_pf, o_sf,
                        o_case, vocab_ids,
                    ),
                    max_freq[:B].astype(np.float64),
                    q_lens,
                )
            tail_cm.__exit__(None, None, None)
            self._debug_report(nrows, total_match, total_keep, state)
            return [r if r is not None else [] for r in results]

        # ---- numpy ranking tail ----
        # device rows back to canonical rows, then the reference's (query,
        # canonical candidate) order
        o_c = self._canon_of[np.minimum(o_c, self.Ni_pad - 1)]
        order = np.lexsort((o_c, o_q))
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case = (
            x[order] for x in (o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case)
        )
        bounds = np.searchsorted(o_q, np.arange(B + 1))
        w = model.weights
        qlen_all = np.maximum(
            q_lens[np.minimum(o_q, B - 1)].astype(np.float64), 1.0
        )
        ld_f = o_ld.astype(np.float64)
        ds_all = np.where(ld_f > qlen_all, 0.0, 1.0 - ld_f / qlen_all)
        score_all = (
            w.ld * ds_all
            + w.lcs * o_lcs / qlen_all
            + w.prefix * o_pf / qlen_all
            + w.suffix * o_sf / qlen_all
            + np.where(o_case.astype(bool), w.case, 0.0)
        ) / w.sum()
        oc_safe = np.minimum(o_c, index.size - 1)
        freq_all = (
            index.freqs[oc_safe] if model.have_freq else np.ones(len(o_c))
        )
        expandable_all = self._has_variants[oc_safe]
        # the device max runs over every scored pair: it is the floor
        floors = max_freq[:B].astype(np.float64)
        if fast_ok:
            exp_rows = np.zeros(B, dtype=bool)
            if expandable_all.any():
                exp_rows[:B] = np.bincount(
                    o_q[expandable_all], minlength=B
                )[:B].astype(bool)
            elig_row = ~exp_rows
            elig_row[nrows:] = False
            pair_elig = elig_row[np.minimum(o_q, B - 1)] & (o_q < nrows)
            batch_res = rank_fast_batch(
                model, vocab_ids, o_c[pair_elig], score_all[pair_elig],
                freq_all[pair_elig], o_q[pair_elig], nrows, floors[:nrows],
                params, stop_before_cutoff=late_conf,
            )
        else:
            elig_row = np.zeros(B, dtype=bool)
            batch_res = None

        def _np_instances(row: int) -> List[Tuple[int, Distance]]:
            lo, hi = int(bounds[row]), int(bounds[row + 1])
            return [
                (
                    int(vocab_ids[o_c[p]]),
                    Distance(
                        ld=int(o_ld[p]), lcs=int(o_lcs[p]),
                        prefixlen=int(o_pf[p]), suffixlen=int(o_sf[p]),
                        samecase=bool(o_case[p]),
                    ),
                )
                for p in range(lo, hi)
            ]

        self._late_conf_and_finalize(
            results, active, inputs, params, batch_res, elig_row, late_conf,
            nrows, _np_instances, floors, q_lens,
        )
        tail_cm.__exit__(None, None, None)
        self._debug_report(nrows, total_match, total_keep, state)
        return [r if r is not None else [] for r in results]

    def _collect_subs(self, state, want_ranked: bool):
        """Collect a window-split batch's sub-batches in input order. Ranked
        sub-results join into one :class:`RankedResults` whose ``row_of``
        and overrides are remapped to the parent's inputs, so a search unit
        keeps the array-native consolidation through the split."""
        results = state["results"]
        parts = []
        for grp, sub in state["subs"]:
            sub["want_ranked"] = want_ranked
            parts.append((grp, self.collect(sub)))
        if want_ranked and all(
            isinstance(p, RankedResults) for _, p in parts
        ):
            joined = RankedResults.concat([p for _, p in parts])
            order = np.fromiter(
                (i for grp, _ in parts for i in grp), dtype=np.int64,
                count=joined.n,
            )
            row_of = np.full(len(results), -1, dtype=np.int64)
            row_of[order] = joined.row_of
            overrides = {
                int(order[k]): v for k, v in joined.overrides.items()
            }
            for i, r in enumerate(results):
                if r is not None:
                    overrides[i] = r
            return RankedResults(
                len(results), joined.vid, joined.ds, joined.fq, row_of,
                joined.sbounds, overrides,
            )
        for grp, sub_res in parts:
            for i, r in zip(grp, sub_res):
                results[i] = r
        return [r if r is not None else [] for r in results]

    def _debug_report(self, nrows, total_match, total_keep, state) -> None:
        if self.model.debug >= 2:
            print(
                f"(batch of {nrows}: {total_match} candidates, "
                f"{total_keep} kept; window={state['window']})",
                file=sys.stderr,
            )
            self.stats.report()
            self.stats.clear()
