"""The least time of one query batch on the card, counted from its shapes.

Whatever implements it, a batch must read every input byte once and write
every output byte once, and do the operations its inputs need; the larger
of the bytes over the memory rate and the operations over the peak rate of
their type is its bound. Work that depends on the data (the hit total, the
pairs' lengths, the candidate rows the pairs touch) is counted on the
batch's own inputs, and planes at the alphabet's true width ``A * T``, not
at the zero columns the device layout pads them to. The parts:

* **K5** (the query planes): bytes only: the per-character counts read
  once, the planes (at the true width) and the zeroed totals written once;
* **K1** (stage A): the int8 multiply-adds of the binarized planes
  against the band rows, the query planes and the hit bits, counts and
  totals, each block of a tile's band at its own columns
  (``convert.block_columns``: 1 + its last column that holds a 1, not
  rounded to the kernel's k-step): the columns past them are zero in
  every row of the block, so the least work for the same outputs is
  ``2 * bt * 1024 * columns`` per tile and block; ``k1_full`` counts every
  block at the full width, ``2 * B * Nb * AT``;
* **K3** (the slot resolve): bytes only: the per-query totals, the band
  starts and the block counts read once, the hit bits of the blocks that
  reach a slot read once, and the P slots (query, band row, device row,
  validity) and the total written once;
* **K2** (DL + LCS): about 10 32-bit operations per banded DL cell and 3 per
  LCS cell of each valid pair. ``k2_valid`` is the pair-string entry at the
  valid pairs (the strings and lengths in, both metrics out); ``k2_slots``
  the slot entry the main path runs at the budget's P slots, with the score
  and the keep tests in its epilogue: the slots in, the query rows and the
  candidate rows the valid pairs touch read once (with their frequencies
  when the model has them), the exact-bit bytes the valid pairs test under
  StopAtExactMatch, and every slot's keep flag and five uint8 metrics and
  the ``[B]`` frequency maxima written once;
* **K4** (the survivor compaction): bytes only: the slot entry's per-block
  kept counts and keep flags read once, the query, device row and five
  metrics of each kept slot that reaches a survivor slot read once, the
  frequency maxima and the hit total read once; the batch's one output
  buffer (the ``[P2]`` survivor columns, the maxima, the two totals)
  written once;
* **the glue** (the torch ops left between the kernels): bytes only: the
  StopAtExactMatch flags and stage A's exact counts read and the per-query
  flags written (``stop_exact & (nexact > 0)``), the threshold less its
  slack, and the frequency maxima's initial values written.

The parts' floors count the data that passes between them (K1's bits and
counts, the pair strings) as memory traffic. **The program** does not: it
reads only its own inputs (the batch's arguments, the band rows' planes and
charcounts, the candidate rows the pairs touch) and writes only its
outputs, and does K1's and K2's operations.

The peaks (:func:`peaks_for`): the data sheet's int8 and HBM rates, and
the 32-bit integer rate at 64 operations per SM and clock; on a card
:func:`card_peaks` takes its SM count and maximum SM clock.

``chip_smoke.py`` and ``tools/roofline_torch.py`` both count here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.stage_a import ROW_BLOCK


class Peaks(NamedTuple):
    name: str
    int8_ops_per_s: float  # dense int8 tensor-core operations
    hbm_bytes_per_s: float
    int32_ops_per_s: float  # 32-bit integer operations outside the tensor cores


# 32-bit integer operations an SM issues per clock on compute capability 9.0
# (the CUDA C++ Programming Guide's table of arithmetic instruction
# throughput: add, logic, shift, compare, min/max and IMAD each 64). The
# data sheet's 67 TFLOP/s is the FP32 rate with an FMA counted as two.
INT32_OPS_PER_SM_CLOCK = 64


def int32_rate(sms: int, sm_clock_mhz: float) -> float:
    """32-bit integer operations per second of a card with ``sms`` SMs at
    ``sm_clock_mhz``."""
    return INT32_OPS_PER_SM_CLOCK * sms * sm_clock_mhz * 1e6


# NVIDIA H100 SXM data sheet, dense, at 700 W; 32-bit integer work at 64
# operations per SM and clock on its 132 SMs at their 1,980 MHz maximum.
# A run on a card derives the last from the card itself (card_peaks).
H100_SXM = Peaks("NVIDIA H100 SXM data sheet (dense, 700 W; int32 64/SM/clock "
                 "x 132 SMs x 1980 MHz)", 1.979e15, 3.35e12,
                 int32_rate(132, 1980))


def peaks_for(card: str, int8: Optional[float] = None,
              hbm: Optional[float] = None, int32: Optional[float] = None,
              sms: Optional[int] = None,
              sm_clock_mhz: Optional[float] = None) -> Peaks:
    """The peaks to bound a run on the card named ``card``
    (``torch.cuda.get_device_name``): the ones given, else the H100 SXM
    data sheet's for an H100 SXM (HBM3) card. Without ``int32``, the 32-bit
    rate comes from ``sms`` and ``sm_clock_mhz`` (:func:`int32_rate`) where
    both are given. Any other card raises."""
    if int32 is None and sms is not None and sm_clock_mhz is not None:
        int32 = int32_rate(sms, sm_clock_mhz)
    if None not in (int8, hbm, int32):
        return Peaks(f"given for {card}", int8, hbm, int32)
    if "H100" in card and ("HBM3" in card or "SXM" in card):
        if int32 is None:
            return H100_SXM
        how = (f"{sms} SMs x {sm_clock_mhz:g} MHz" if sms is not None
               else "given")
        return H100_SXM._replace(
            name=f"NVIDIA H100 SXM data sheet (dense, 700 W); int32 "
                 f"64/SM/clock x {how}", int32_ops_per_s=int32)
    raise ValueError(f"no data-sheet peaks for {card!r}: give --peak-int8, "
                     "--peak-hbm and --peak-int32")


def card_peaks(index: int = 0, int8: Optional[float] = None,
               hbm: Optional[float] = None,
               int32: Optional[float] = None) -> Peaks:
    """:func:`peaks_for` the CUDA card ``index``, its 32-bit rate derived
    from its SM count (``torch.cuda.get_device_properties``) and its maximum
    SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import subprocess

    props = torch.cuda.get_device_properties(index)
    clock = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return peaks_for(torch.cuda.get_device_name(index), int8, hbm, int32,
                     sms=props.multi_processor_count,
                     sm_clock_mhz=float(clock))


class Work(NamedTuple):
    """Bytes to move, and operations to do by type."""

    nbytes: float
    int8_ops: float = 0.0  # on the tensor cores
    int32_ops: float = 0.0  # outside them

    def bound_ms(self, peaks: Peaks = H100_SXM) -> Tuple[float, str]:
        """The least time in ms, and which of bytes and operations bounds
        it. The tensor cores and the other units may run at once, so the
        operations take the longer of their two types' times."""
        t_bytes = self.nbytes / peaks.hbm_bytes_per_s * 1e3
        t_ops = max(self.int8_ops / peaks.int8_ops_per_s,
                    self.int32_ops / peaks.int32_ops_per_s) * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def band_rows(start_blk, nb_band: int) -> int:
    """Index rows in the union of the query tiles' bands."""
    blocks = set()
    for s in start_blk.tolist():
        blocks.update(range(s, s + nb_band))
    return len(blocks) * ROW_BLOCK


def k1_work(at: int, B: int, start_blk, nb_band: int,
            columns=None) -> Work:
    """Stage A on these inputs, at the true plane width ``at``: the int8
    multiply-adds (2 operations each) and the bytes: the band rows' planes,
    charcounts and valid flags, the queries' planes and scalars and the
    tiles' band starts read once; the hit and exact bits, the block counts
    and the two totals written once. With ``columns`` (the planes' columns
    in use per block, ``convert.block_columns``) each block's planes count
    at its columns and each tile's queries' planes at the most columns of
    a block it reads, each capped at ``at``."""
    Nb = nb_band * ROW_BLOCK
    out_bytes = (4 * start_blk.numel() + 2 * B * Nb // 8
                 + 4 * (Nb // 128) * B + 8 * B)
    if columns is None:
        nbytes = (band_rows(start_blk, nb_band) * (at + 4 + 1)
                  + B * (at + 12) + out_bytes)
        return Work(nbytes, int8_ops=2 * B * Nb * at)
    ext = np.minimum(torch.as_tensor(columns).cpu().numpy(), at).astype(
        np.int64)
    starts = torch.as_tensor(start_blk).cpu().numpy().astype(np.int64)
    blocks = starts[:, None] + np.arange(nb_band)  # [tiles, nb_band]
    bt = B // len(starts)
    distinct = np.unique(blocks)
    nbytes = (int(ROW_BLOCK * (ext[distinct] + 5).sum())
              + int(bt * (ext[blocks].max(1) + 12).sum()) + out_bytes)
    return Work(nbytes, int8_ops=int(2 * bt * ROW_BLOCK * ext[blocks].sum()))


def k1_bound_ms(at: int, B: int, start_blk, nb_band: int,
                peaks: Peaks = H100_SXM, columns=None):
    """The least time of stage A for ``B`` queries over the bands
    ``start_blk`` of ``nb_band`` blocks (at the blocks' ``columns`` where
    given, else at the full width), and its bound."""
    return k1_work(at, B, start_blk, nb_band, columns).bound_ms(peaks)


def _dl_ops(a_len, b_len, L: int, W: int) -> float:
    """About 10 operations per banded DL cell (``a_len * (2W + 3)`` cells)
    and 2.5 per LCS cell (``a_len * b_len``): 10 per 32-bit word of four
    cells' runs packed as bytes, the least of the kernel's LCS walks (the
    wide path's packed rows; csrc/dl_lcs.cu ``lcs_word``); empty pairs cost
    none."""
    al = a_len.clamp(max=L).double()
    return float((10 * al * (2 * W + 3)
                  + 2.5 * al * b_len.clamp(max=L)).sum())


def k2_work(a_len, b_len, L: int, W: int) -> Work:
    """DL + LCS on these pairs: both int32 strings, both lengths and both
    outputs per pair, and :func:`_dl_ops`. Empty slots cost their bytes and
    no operations."""
    P = a_len.shape[0]
    return Work(P * (8 * L + 16), int32_ops=_dl_ops(a_len, b_len, L, W))


def k2_bound_ms(a_len, b_len, L: int, W: int, peaks: Peaks = H100_SXM):
    """The least time of the DL + LCS kernel on these pairs, and its bound."""
    return k2_work(a_len, b_len, L, W).bound_ms(peaks)


# bytes per slot: K3 writes query, band row and device row (int32) and the
# validity; the slot entry, on the main path, the keep flag and five uint8
# metrics (a survivor slot: :func:`_survivor_bytes`)
SLOT_BYTES = 13
KEEP_BYTES = 6


def k5_work(B: int, A: int, at: int) -> Work:
    """The query planes: the ``[B, A]`` int32 counts read once, the
    ``[B, at]`` int8 planes at the true width and the two ``[B]`` int32
    totals written once."""
    return Work(4 * B * A + B * at + 8 * B)


def k5_bound_ms(B: int, A: int, at: int, peaks: Peaks = H100_SXM):
    """The least time of the query planes, and its bound."""
    return k5_work(B, A, at).bound_ms(peaks)


def k3_work(counts_t, nmatch, start_blk, P: int) -> Work:
    """The slot resolve on these inputs: ``nmatch``, ``start_blk`` and
    ``counts_t`` read once, the 16 bytes of hit bits of each non-empty
    128-row block whose first slot is below ``P`` (the blocks the kernel
    expands), the ``P`` slots and the int64 total written once."""
    counts = counts_t.t().reshape(-1).long()  # query-major
    first = torch.cumsum(counts, 0) - counts
    blocks = int(((counts > 0) & (first < P)).sum())
    nbytes = (4 * nmatch.numel() + 4 * start_blk.numel()
              + 4 * counts_t.numel() + 16 * blocks + SLOT_BYTES * P + 8)
    return Work(nbytes)


def k3_bound_ms(counts_t, nmatch, start_blk, P: int,
                peaks: Peaks = H100_SXM):
    """The least time of the slot resolve on these inputs, and its bound."""
    return k3_work(counts_t, nmatch, start_blk, P).bound_ms(peaks)


def _cand_row_bytes(L: int, norm_bytes: int, have_freq: bool) -> int:
    """One candidate row as the pairs read it: string, length, case flag,
    and frequency when the model has them."""
    return L * norm_bytes + 5 + (8 if have_freq else 0)


def k2_slots_work(ql, cl, P: int, L: int, W: int, norm_bytes: int,
                  n_queries: int, cand_rows: int, *, B: int = 0,
                  have_freq: bool = False,
                  exact_bytes: Optional[int] = None) -> Work:
    """K2's slot entry as the main path runs it, with the score and the
    keep tests in its epilogue, at ``P`` slots whose valid ones have the
    lengths ``ql``, ``cl``: each slot's query, row and validity in (and its
    band row under StopAtExactMatch, where ``exact_bytes`` counts the
    distinct bytes of exact bits the valid pairs test, read once with the
    ``B`` per-query flags); each of the ``n_queries`` query rows (string,
    length, threshold, case flag) and ``cand_rows`` candidate rows (string,
    length, case flag, frequency with ``have_freq``) the valid pairs touch
    read once; the weights and the threshold; every slot's keep flag and
    five metrics and, with ``have_freq``, the ``B`` frequency maxima
    written once; and :func:`_dl_ops` on the valid pairs (the epilogue's
    few dozen operations a slot are under 1 % of them)."""
    stop_exact = exact_bytes is not None
    nbytes = (P * (9 + (4 if stop_exact else 0) + KEEP_BYTES)
              + n_queries * (L * norm_bytes + 9)
              + cand_rows * _cand_row_bytes(L, norm_bytes, have_freq)
              + (exact_bytes + B if stop_exact else 0)
              + (8 * B if have_freq else 0) + 6 * 4 + 4)
    return Work(nbytes, int32_ops=_dl_ops(ql, cl, L, W))


def _survivor_bytes(met_bytes: int = 1) -> int:
    """A survivor slot: query and device row (int32) and five metrics of
    ``met_bytes`` each (uint8 below L 256, int32 from it)."""
    return 8 + 5 * met_bytes


def _output_bytes(B: int, P2: int, met_bytes: int = 1) -> int:
    """The core's outputs: the survivor columns, the int64 frequency maxima
    and the two int64 totals."""
    return P2 * _survivor_bytes(met_bytes) + 8 * B + 16


def k4_work(P: int, P2: int, B: int, n_keep: int, block: int,
            met_bytes: int = 1) -> Work:
    """The survivor compaction of ``n_keep`` kept slots of ``P`` into
    ``P2``: the ``ceil(P / block)`` int32 per-block counts and the ``P``
    keep flags read once, the query, device row and five metrics of the
    kept slots below ``P2`` read once, the ``B`` frequency maxima and the
    hit total read once; the core's outputs written once."""
    return Work(4 * -(-P // block) + P
                + _survivor_bytes(met_bytes) * min(n_keep, P2) + 8 * B + 8
                + _output_bytes(B, P2, met_bytes))


def k4_bound_ms(P: int, P2: int, B: int, n_keep: int, block: int,
                peaks: Peaks = H100_SXM, met_bytes: int = 1):
    """The least time of the survivor compaction, and its bound."""
    return k4_work(P, P2, B, n_keep, block, met_bytes).bound_ms(peaks)


def glue_work(B: int) -> Work:
    """The least bytes of the torch ops left between the kernels: the
    ``B`` StopAtExactMatch flags and exact counts read and the per-query
    flags written, the threshold read and written less its slack, and the
    ``B`` int64 frequency maxima's initial values written."""
    return Work(B * (1 + 4 + 1) + 4 + 4 + 8 * B)


def program_work(args: Sequence[torch.Tensor], at: int, rows: int,
                 cand_rows: int, L: int, norm_bytes: int, have_freq: bool,
                 P2: int, k1: Work, k2: Work) -> Work:
    """The whole core on one batch: its arguments ``args`` and, of the
    index, the ``rows`` band rows' planes, charcounts and valid flags and
    the candidate rows the pairs touch read once; its outputs written once;
    K1's int8 and K2's 32-bit operations. Nothing that passes between the
    stages counts."""
    B = args[0].shape[0]
    reads = (sum(t.numel() * t.element_size() for t in args)
             + rows * (at + 4 + 1)
             + cand_rows * _cand_row_bytes(L, norm_bytes, have_freq))
    return Work(reads + _output_bytes(B, P2), int8_ops=k1.int8_ops,
                int32_ops=k2.int32_ops)


# the main path's parts, in their order in a core call
PARTS = ("k5", "k1", "k3", "k2_slots", "k4", "glue")


class BatchFloor(NamedTuple):
    """One batch's parts and the program, as work."""

    k5: Work
    k1: Work  # at the band blocks' columns
    k1_full: Work  # K1 at the full width
    k3: Work
    k2_valid: Work  # the pair-string entry at the valid pairs
    k2_slots: Work  # the slot entry at the budget's P slots
    k4: Work
    glue: Work
    program: Work
    n_valid: int
    cand_rows: int
    peaks: Peaks

    def ms(self, part: str) -> Tuple[float, str]:
        return getattr(self, part).bound_ms(self.peaks)

    @property
    def program_ms(self) -> float:
        return self.ms("program")[0]

    @property
    def parts_ms(self) -> float:
        """K5 + K1 + K3 + K2's slot entry + K4 + glue, the main path's
        parts: the program with the data between its stages counted as
        memory traffic."""
        return sum(self.ms(p)[0] for p in PARTS)


def batch_floor(index, args, *, P: int, P2: int, window: int, nb_band: int,
                use_stop_exact: bool, have_freq: bool, width: int,
                peaks: Peaks = H100_SXM) -> BatchFloor:
    """Count one batch of ``query_core`` (its arguments ``args`` on the
    index ``index``, at budgets P and P2): stage A and the slot resolve run
    once, to find the valid pairs, their lengths, and the query and
    candidate rows they touch, and the whole core once, for the number
    kept."""
    from ..convert import block_columns
    from ..ops.dl import slot_block
    from ..ops.pipeline import query_core, query_stage_a, resolve_pairs

    (q_counts, q_cc, q_norms, q_lens, _q_fl, k_ana, _k_ed, k_len, _se,
     start_blk, _w, _thr) = args
    sa = query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                       nb_band, width)
    q, pcb, pc, _valid, total = resolve_pairs(
        sa.packed_q, sa.counts_t, sa.nmatch, start_blk, index.bins.shape[0],
        P)
    n_valid = min(int(total), P)
    exact_bytes = None
    if use_stop_exact:  # the bytes of exact bits the valid pairs test
        nb8 = sa.exact_q.shape[1]
        exact_bytes = int(torch.unique(q[:n_valid].long() * nb8
                                       + (pcb[:n_valid] >> 3)).numel())
    cand_rows = int(torch.unique(pc[:n_valid]).numel())
    n_queries = int(torch.unique(q[:n_valid]).numel())
    ql = q_lens[q[:n_valid].long()]
    cl = index.norm_lens[pc[:n_valid].long()]
    L = q_norms.shape[1]
    B = q_lens.shape[0]
    nbytes = q_norms.element_size()
    k1 = k1_work(index.at, B, start_blk, nb_band, block_columns(index.bins))
    k2_valid = k2_work(ql, cl, L, window)
    n_keep = int(query_core(
        index, *args, have_freq=have_freq, P=P, P2=P2, window=window,
        nb_band=nb_band, width=width, use_stop_exact=use_stop_exact)[9])
    return BatchFloor(
        k5=k5_work(B, q_counts.shape[1], index.at),
        k1=k1,
        k1_full=k1_work(index.at, B, start_blk, nb_band),
        k3=k3_work(sa.counts_t, sa.nmatch, start_blk, P),
        k2_valid=k2_valid,
        k2_slots=k2_slots_work(ql, cl, P, L, window, nbytes, n_queries,
                               cand_rows, B=B, have_freq=have_freq,
                               exact_bytes=exact_bytes),
        k4=k4_work(P, P2, B, n_keep, slot_block(L)),
        glue=glue_work(B),
        program=program_work(args, index.at, band_rows(start_blk, nb_band),
                             cand_rows, L, nbytes, have_freq, P2, k1,
                             k2_valid),
        n_valid=n_valid, cand_rows=cand_rows, peaks=peaks,
    )
