"""Stage B metrics: windowed Damerau-Levenshtein + LCS, prefix and suffix.

On pair strings, three functions:

* :func:`dl_metrics_windowed_plain` is the plain PyTorch version, a port of
  the JAX row-vectorized DP (``analiticcl_tpu/ops/dl_jax.py``,
  ``dl_metrics_windowed``). It returns ``(ld, lcs, prefix, suffix)``.
* :func:`affix_metrics_aligned` gives prefix and suffix lengths from
  pre-aligned forward and reversed strings (``dl_jax.affix_metrics_aligned``).
  They stay torch ops on every device, as they stay XLA ops in the JAX package.
* :func:`dl_lcs` gives ``(ld, lcs)``: for a CUDA tensor it launches the
  hand-written kernel ``csrc/dl_lcs.cu``; for a CPU tensor it takes the plain
  version. Anything else raises.

The kernel takes any width ``L``, on two paths: a pair whose two strings
are both at most :data:`NARROW_LEN` long runs the byte-cell DP (one thread a
pair; every pair up to L 64); above L 64 a pair with a longer string runs
the wide path (one warp a pair: the band DP in O(W) state, the LCS row by
row on packed runs), a second launch that the same C entry makes after the
first, on the pairs the first put on a work list (:func:`_work_list`). Its
launches are counted in :data:`wide_path`.

Inputs are int32 ``[P, L]`` strings, queries padded with ``PAD_A`` and
candidates with ``PAD_B`` so that padding never matches, and int32 ``[P]``
lengths.

Exactness contract (shared with the JAX package): where the true unrestricted
DL is <= ``window`` the value is exact; otherwise it is some value > ``window``.
The kernel and the plain version may differ above ``window``; a comparison
clips both at ``window + 1``. The LCS is exact everywhere.

On stage B's pair slots (the query and device row of each slot, from the
slot resolve), the main path's entry:

* :func:`dl_lcs_slots` launches the kernel's slot entry for CUDA tensors:
  each thread reads its slot's two strings by row from the index's and the
  batch's tables and gives DL + LCS, prefix, suffix and the per-pair
  attributes stage B scores with, with no ``[P, L]`` strings in between. Given :class:`ScoreInputs` (the main
  path's instance) its epilogue also scores each slot as the JAX core does
  and writes only what the survivor compaction needs (:class:`SlotScore`:
  the keep flag, five uint8 metrics, the per-query frequency maxima, and
  the kept slots of each of its blocks, :func:`slot_block`).
  For CPU tensors it takes :func:`dl_lcs_slots_plain`, the composition of
  :func:`gather_pairs`, :func:`dl_metrics_windowed_plain` and
  :func:`affix_metrics_aligned`, and with a score :func:`score_slots_plain`
  after it, the JAX core's score as torch ops. Both agree exactly, above
  ``window`` too: the slot entry runs the same DP on the same strings and
  the same f32 operations in the same order.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Union

import torch

from . import _build

PAD_A = -1
PAD_B = -2
KERNEL_WINDOWS = (3, 6, 12)
NARROW_LEN = 64  # the byte DP's longest string; longer ones take the wide path
# K2's wide path, launched by either entry after its byte path whenever L >
# NARROW_LEN: the entries' wrappers count its launches here
wide_path = SimpleNamespace(launches=0)
# the wide path's counters, zero between calls: one int32 [3] buffer per
# (device, stream), made at the stream's first call above L 64
_counters: dict = {}


def _work_list(P: int, L: int, dev: torch.device):
    """The wide path's work list for a call at width ``L`` on ``dev``'s
    current stream: an int32 ``[P]`` scratch list and the stream's
    counters; ``(None, None)`` at or below L 64, where it has no wide
    path. The byte launch lists its pairs over 64 and counts them, the
    wide launch takes them and its last block zeroes the counters again,
    so one buffer serves every call on the stream in order."""
    if L <= NARROW_LEN:
        return None, None
    key = (torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    ctr = _counters.get(key)
    if ctr is None:
        ctr = _counters[key] = torch.zeros(3, dtype=torch.int32, device=dev)
    return torch.empty(P, dtype=torch.int32, device=dev), ctr


def _launch(entry: str, args, L: int, P: int, dev: torch.device) -> int:
    """Call K2's C entry ``entry`` on ``dev``'s current stream, with the
    wide path's work list above L 64; returns its CUDA error. After a
    failed call the stream's counters are zeroed, as its launches would
    have left them."""
    with torch.cuda.device(dev):
        items, ctr = _work_list(P, L, dev)
        err = getattr(_build.load("dl_lcs"), entry)(
            *args, torch.cuda.current_stream(dev).cuda_stream,
            None if items is None else items.data_ptr(),
            None if ctr is None else ctr.data_ptr())
        if err and ctr is not None:
            ctr.zero_()
    return err


def met_dtype(L: int) -> torch.dtype:
    """The scored slot entry's metric columns at width ``L``: uint8 below
    L 256, where DL <= 3L + 8 wraps only above the window and the rest are
    <= L; int32 from L 256, as the JAX pipeline carries them."""
    return torch.uint8 if L < 256 else torch.int32


def slot_block(L: int) -> int:
    """Slots per block of the slot entry for strings of width ``L``
    (``slot_threads`` in ``csrc/dl_lcs.cu``): the blocks whose kept slots
    :class:`SlotScore` counts."""
    return 128 if L <= 32 else 64


def _first_mismatch_len(x, y):
    """The common prefix length of each row pair: the first column where
    they differ, or L. Padding never matches (PAD_A against PAD_B or a
    symbol), so the prefix never runs past the shorter string."""
    L = x.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=x.device)
    return torch.where(x != y, pos, L).amin(dim=1)


def affix_metrics_aligned(a, a_len, b, b_len, a_rev, b_rev):
    """Common prefix and suffix lengths; ``a_rev``/``b_rev`` are the strings
    reversed and left-aligned, so the suffix is the prefix of the reversed
    pair. Every string is padded past its length (queries with PAD_A,
    candidates with PAD_B), which bounds both by the shorter length."""
    return _first_mismatch_len(a, b), _first_mismatch_len(a_rev, b_rev)


def _shift_end(x, lens, pad):
    """Right-align the first ``lens`` entries of each row at column L."""
    L = x.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=x.device)[None, :]
    idx = pos - (L - lens[:, None])
    got = torch.gather(x, 1, idx.clamp(min=0).long())
    return torch.where(idx >= 0, got, pad)


def dl_metrics_windowed_plain(a, a_len, b, b_len, max_len: int, window: int):
    """Windowed DL + LCS + prefix/suffix as dense torch ops, row by row.

    Follows ``dl_jax.dl_metrics_windowed`` step for step. The ring of the
    last ``window + 2`` DP rows is one ``[P, window + 2, L + 1]`` tensor in
    which row ``k`` lives in slot ``k % (window + 2)``; the transposition
    term, which the JAX version assembles from ``(window + 1)**2`` selects,
    is one gather at slot ``last % (window + 2)``, column ``db - 1``.
    """
    P, L = a.shape
    assert L == max_len
    dev = a.device
    Wp = window + 1
    nslot = Wp + 1
    big = 2 * L + 8
    i32 = torch.int32

    minlen = torch.minimum(a_len, b_len)
    prefix = _first_mismatch_len(a, b)
    a_r = _shift_end(a, a_len, PAD_A)
    b_r = _shift_end(b, b_len, PAD_B)
    pos = torch.arange(L, dtype=i32, device=dev)[None, :]
    in_tail = pos >= (L - minlen)[:, None]
    last_mismatch = torch.where((a_r != b_r) & in_tail, pos, -1).amax(dim=1)
    suffix = torch.where(last_mismatch < 0, minlen, L - 1 - last_mismatch)

    cols = torch.arange(1, L + 1, dtype=i32, device=dev)[None, :]
    jidx = torch.arange(0, L + 1, dtype=i32, device=dev)[None, :]
    ring = torch.full((P, nslot, L + 1), big, dtype=i32, device=dev)
    ring[:, 1 % nslot] = jidx  # mat[1] = 0..L
    ring_flat = ring.view(P, nslot * (L + 1))
    lastrow_col = torch.zeros((P, L), dtype=i32, device=dev)
    lcs_prev = torch.zeros((P, L), dtype=i32, device=dev)
    lcs_best = torch.zeros(P, dtype=i32, device=dev)
    res = torch.zeros(P, dtype=i32, device=dev)
    zero_col = torch.zeros((P, 1), dtype=i32, device=dev)
    b_len_idx = b_len.clamp(min=0).long()[:, None]

    for i1 in range(L):
        i = i1 + 1  # reading mat[i], writing mat[i+1]
        match = b == a[:, i1 : i1 + 1]
        jm = torch.where(match, cols, 0)
        db = torch.cat([zero_col, torch.cummax(jm, dim=1).values[:, :-1]], 1)
        last = lastrow_col

        prev_row = ring[:, i % nslot]
        sub = prev_row[:, 0:L] + torch.where(match, 0, 1)
        ins = prev_row[:, 1 : L + 1] + 1

        # term = mat[i-d][j-s] + d + s - 1 for d = i - last, s = j - db,
        # both in [1, Wp]; mat[i-d] sits in slot last % nslot
        d = i - last
        s = cols - db
        gidx = (last % nslot) * (L + 1) + (db - 1).clamp(min=0)
        v = torch.gather(ring_flat, 1, gidx.long())
        v = torch.where(db >= 1, v, big)
        sel = (d >= 1) & (d <= Wp) & (s >= 1) & (s <= Wp)
        transp = torch.where(sel, v + d + s - 1, 4 * big)

        cand = torch.minimum(torch.minimum(sub, ins), transp)
        shifted0 = torch.cat([torch.full_like(zero_col, i), cand], 1)
        new_row = torch.cummin(shifted0 - jidx, dim=1).values + jidx

        res_col = torch.gather(new_row, 1, b_len_idx)[:, 0]
        res = torch.where(a_len - 1 == i1, res_col, res)
        lastrow_col = torch.where(match, i, lastrow_col)

        valid = match & (i1 < a_len)[:, None] & (pos < b_len[:, None])
        lcs_shift = torch.cat([zero_col, lcs_prev[:, :-1]], 1)
        lcs_prev = torch.where(valid, lcs_shift + 1, 0)
        lcs_best = torch.maximum(lcs_best, lcs_prev.amax(dim=1))

        ring[:, (i + 1) % nslot] = new_row

    ld = torch.where(a_len == 0, b_len, res)
    ld = torch.where(b_len == 0, a_len, ld)
    return ld, lcs_best, prefix, suffix.to(i32)


def _check_pairs(a, a_len, b, b_len, max_len):
    P, L = a.shape
    if L != max_len or b.shape != (P, L) or a_len.shape != (P,) or b_len.shape != (P,):
        raise ValueError(
            f"bad pair shapes a {tuple(a.shape)} b {tuple(b.shape)} "
            f"a_len {tuple(a_len.shape)} b_len {tuple(b_len.shape)} L {max_len}"
        )
    for t in (a, a_len, b, b_len):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != a.device:
            raise ValueError("dl_lcs takes contiguous int32 tensors on one device")


def dl_lcs(a, a_len, b, b_len, max_len: int, window: int):
    """``(ld, lcs)`` int32 ``[P]``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_pairs(a, a_len, b, b_len, max_len)
    if a.device.type == "cpu":
        ld, lcs, _, _ = dl_metrics_windowed_plain(a, a_len, b, b_len, max_len, window)
        return ld.to(torch.int32), lcs
    if a.device.type != "cuda":
        raise ValueError(f"dl_lcs: unsupported device {a.device}")
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"dl_lcs kernel: window {window} not in {KERNEL_WINDOWS}")
    P = a.shape[0]
    ld = torch.empty(P, dtype=torch.int32, device=a.device)
    lcs = torch.empty(P, dtype=torch.int32, device=a.device)
    if P == 0:
        return ld, lcs
    err = _launch("analiticcl_dl_lcs",
                  (a.data_ptr(), a_len.data_ptr(), b.data_ptr(),
                   b_len.data_ptr(), ld.data_ptr(), lcs.data_ptr(), P,
                   max_len, window), max_len, P, a.device)
    dl_lcs.launches += 1
    wide_path.launches += max_len > NARROW_LEN
    _build.check(err, "dl_lcs kernel launch")
    return ld, lcs


dl_lcs.launches = 0


class PairInputs(NamedTuple):
    a: torch.Tensor  # int32 [P, L] query strings, PAD_A padded
    ql: torch.Tensor  # int32 [P]
    b: torch.Tensor  # int32 [P, L] candidate strings, PAD_B padded
    cl: torch.Tensor  # int32 [P]
    a_rev: torch.Tensor  # reversed, left-aligned query strings
    b_rev: torch.Tensor  # reversed, left-aligned candidate strings
    k_ed: torch.Tensor  # int32 [P] the pair's query edit threshold
    same_first: torch.Tensor  # bool [P]: both first letters lowercase, or neither


def gather_pairs(index, q_norms, q_lens, k_ed, q_first_lower, pq, pc,
                 valid) -> PairInputs:
    """Per-pair strings and attributes from the index's tables (``index`` a
    ``convert.DeviceIndex``) and the batch's, one gather per side: each
    side's columns are concatenated into one int32 table first
    (``analiticcl_tpu/ops/pipeline.py:594-639``). Slots outside ``valid``
    get empty strings, as in the JAX core."""
    i32 = torch.int32
    L = index.norms2.shape[1] // 2
    pos = torch.arange(L, dtype=i32, device=q_norms.device)
    # reversed query strings; columns past the length are masked below
    rev = torch.gather(q_norms, 1, (q_lens[:, None] - 1 - pos).clamp_(min=0)
                       .long())
    cg = torch.cat(
        [index.norms2.to(i32), index.norm_lens[:, None],
         index.first_lower[:, None].to(i32)], 1,
    )[pc]
    qg = torch.cat(
        [q_norms.to(i32), rev.to(i32), q_lens[:, None], k_ed[:, None],
         q_first_lower[:, None].to(i32)], 1,
    )[pq]
    ql = torch.where(valid, qg[:, 2 * L], 0)
    cl = torch.where(valid, cg[:, 2 * L], 0)
    q_in = pos < ql[:, None]
    c_in = pos < cl[:, None]
    return PairInputs(
        a=torch.where(q_in, qg[:, :L], PAD_A),
        ql=ql,
        b=torch.where(c_in, cg[:, :L], PAD_B),
        cl=cl,
        a_rev=torch.where(q_in, qg[:, L : 2 * L], PAD_A),
        b_rev=torch.where(c_in, cg[:, L : 2 * L], PAD_B),
        k_ed=qg[:, 2 * L + 1],
        same_first=cg[:, 2 * L + 1] == qg[:, 2 * L + 2],
    )


class SlotMetrics(NamedTuple):
    """Stage B's per-slot inputs to the score, int32 ``[P]`` but
    ``same_first``."""

    ld: torch.Tensor
    lcs: torch.Tensor
    pf: torch.Tensor  # common prefix length
    sf: torch.Tensor  # common suffix length
    ql: torch.Tensor  # the query's length, 0 for an invalid slot
    k_ed: torch.Tensor  # the query's edit threshold
    same_first: torch.Tensor  # bool: both first letters lowercase, or neither


def dl_lcs_slots_plain(index, q_norms, q_lens, k_ed, q_first_lower, q, pc,
                       valid, window: int) -> SlotMetrics:
    """The slot entry's plain version: the pair strings gathered
    (:func:`gather_pairs`), then DL + LCS and the affixes on them."""
    pr = gather_pairs(index, q_norms, q_lens, k_ed, q_first_lower, q, pc,
                      valid)
    L = pr.a.shape[1]
    ld, lcs, _, _ = dl_metrics_windowed_plain(pr.a, pr.ql, pr.b, pr.cl, L,
                                              window)
    pf, sf = affix_metrics_aligned(pr.a, pr.ql, pr.b, pr.cl, pr.a_rev,
                                   pr.b_rev)
    return SlotMetrics(ld.to(torch.int32), lcs, pf, sf, pr.ql, pr.k_ed,
                       pr.same_first)


def _check_slots(index, q_norms, q_lens, k_ed, q_first_lower, q, pc, valid):
    Ni, L2 = index.norms2.shape
    B, L = q_norms.shape
    P = q.shape[0]
    want = {
        "q": (q, torch.int32, (P,)), "pc": (pc, torch.int32, (P,)),
        "valid": (valid, torch.bool, (P,)),
        "norms2": (index.norms2, q_norms.dtype, (Ni, 2 * L)),
        "norm_lens": (index.norm_lens, torch.int32, (Ni,)),
        "first_lower": (index.first_lower, torch.bool, (Ni,)),
        "q_lens": (q_lens, torch.int32, (B,)),
        "k_ed": (k_ed, torch.int32, (B,)),
        "q_first_lower": (q_first_lower, torch.bool, (B,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"dl_lcs_slots: {name} is {t.dtype} {tuple(t.shape)}, "
                f"wants contiguous {dtype} {shape}"
            )
        if t.device != q.device:
            raise ValueError(f"dl_lcs_slots: {name} on {t.device}, q on "
                             f"{q.device}")
    if q_norms.dtype not in (torch.int8, torch.int32) \
            or not q_norms.is_contiguous() or q_norms.device != q.device:
        raise ValueError(f"dl_lcs_slots: q_norms is {q_norms.dtype} on "
                         f"{q_norms.device}, wants contiguous int8 or int32 "
                         f"on {q.device}")
    return P, L


class ScoreInputs(NamedTuple):
    """What the slot entry's scoring epilogue reads beside the metrics (the
    JAX core's score and keep tests, ``analiticcl_tpu/ops/pipeline.py:
    671-722``)."""

    pc_band: torch.Tensor  # int32 [P] the slot's band row
    exact_q: torch.Tensor  # uint8 [B, Nb / 8] stage A's exact-anagram bits
    use_exact: Optional[torch.Tensor]  # bool [B]; None: no StopAtExactMatch
    weights: torch.Tensor  # float32 [6] ld, lcs, prefix, suffix, case, sum
    thr: torch.Tensor  # float32 [] the score threshold less the slack
    freqs: Optional[torch.Tensor]  # int64 [Ni]; None: no frequencies
    want_score: bool = False  # also return the f32 score (the score stop)


class SlotScore(NamedTuple):
    """The scored slot entry's outputs."""

    keep: torch.Tensor  # bool [P]: within the edit tests and the threshold
    met: torch.Tensor  # [5, P] ld, lcs, prefix, suffix, case flag as the
    # weights gate them: uint8 below L 256 (the survivors' values fit), else
    # int32
    max_freq: torch.Tensor  # int64 [B] over the slots within the edit tests
    score: Optional[torch.Tensor]  # float32 [P] with want_score
    counts: torch.Tensor  # int32 [ceil(P / slot_block(L))]: kept slots of
    # each block of slot_block(L) slots, which the survivor compaction sums


def score_slots_plain(m: SlotMetrics, q, pc, valid, L: int,
                      s: ScoreInputs) -> SlotScore:
    """The scoring epilogue as torch ops on the metrics ``m`` of the slots
    ``(q, pc, valid)`` of strings of width ``L``, in the JAX core's f32
    operation order: the weights gate lcs, prefix, suffix and the case
    flag; the score; the edit-threshold test and, with ``use_exact``,
    StopAtExactMatch's exact test; keep at or above the threshold; the
    exact int64 frequency maximum of each query over its slots within the
    edit tests, also those below the threshold (lib.rs:1455-1476); the kept
    slots of each block of :func:`slot_block` slots."""
    w_ld, w_lcs, w_pf, w_sf, w_case, w_sum = s.weights.unbind()
    ld, ql = m.ld, m.ql
    lcs = torch.where(w_lcs > 0, m.lcs, 0)
    pf = torch.where(w_pf > 0, m.pf, 0)
    sf = torch.where(w_sf > 0, m.sf, 0)
    samecase = torch.where(w_case > 0, m.same_first, True)
    qlen_f = ql.clamp(min=1).to(torch.float32)
    ds = torch.where(ld > ql, 0.0, 1.0 - ld.to(torch.float32) / qlen_f)
    score = (
        w_ld * ds
        + w_lcs * lcs.to(torch.float32) / qlen_f
        + w_pf * pf.to(torch.float32) / qlen_f
        + w_sf * sf.to(torch.float32) / qlen_f
        + torch.where(samecase, w_case, 0.0)
    ) / w_sum
    pass_ed = valid & (ld <= m.k_ed)
    if s.use_exact is not None:
        # StopAtExactMatch (lib.rs:1158-1174): queries with an exact anagram
        # keep only their exact pairs
        byte = s.exact_q[q.long(), (s.pc_band >> 3).long()].to(torch.int32)
        pair_exact = ((byte >> (s.pc_band & 7)) & 1) != 0
        pass_ed = pass_ed & (~s.use_exact[q.long()] | pair_exact)
    keep = pass_ed & (score >= s.thr)
    B = s.exact_q.shape[0]
    if s.freqs is not None:
        # slots outside pass_ed add 0, the initial value
        max_freq = torch.zeros(B, dtype=torch.int64, device=q.device
                               ).scatter_reduce(
            0, q.long(), torch.where(pass_ed, s.freqs[pc.long()], 0), "amax")
    else:
        max_freq = torch.ones(B, dtype=torch.int64, device=q.device)
    met = torch.stack([ld, lcs, pf, sf, samecase.to(torch.int32)]).to(
        met_dtype(L))
    T = slot_block(L)
    P = keep.shape[0]
    counts = torch.nn.functional.pad(keep, (0, -P % T)).view(-1, T).sum(
        1, dtype=torch.int32)
    return SlotScore(keep, met, max_freq, score if s.want_score else None,
                     counts)


def _check_score(s: ScoreInputs, B: int, P: int, Ni: int, dev) -> None:
    want = {
        "pc_band": (s.pc_band, torch.int32, (P,)),
        "exact_q": (s.exact_q, torch.uint8, (B, s.exact_q.shape[1])),
        "weights": (s.weights, torch.float32, (6,)),
        "thr": (s.thr, torch.float32, ()),
    }
    if s.use_exact is not None:
        want["use_exact"] = (s.use_exact, torch.bool, (B,))
    if s.freqs is not None:
        want["freqs"] = (s.freqs, torch.int64, (Ni,))
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(
                f"dl_lcs_slots: score input {name} is {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, wants contiguous {dtype} "
                f"{shape} on {dev}"
            )


def dl_lcs_slots(index, q_norms, q_lens, k_ed, q_first_lower, q, pc, valid,
                 window: int, score: Optional[ScoreInputs] = None
                 ) -> Union[SlotMetrics, SlotScore]:
    """Stage B's metrics of the ``P`` slots ``(q, pc, valid)`` over the
    index's rows (``index.norms2``, ``norm_lens``, ``first_lower``, and
    ``freqs`` through ``score``) and the batch's (``q_norms``, ``q_lens``,
    ``k_ed``, ``q_first_lower``): :class:`SlotMetrics`, or with ``score``
    the scored slots (:class:`SlotScore`). The kernel's slot entry for CUDA
    tensors; for CPU tensors :func:`dl_lcs_slots_plain`, then
    :func:`score_slots_plain` with ``score``. A launch adds to
    :func:`dl_lcs`'s count as well: it is the same kernel's DP."""
    P, L = _check_slots(index, q_norms, q_lens, k_ed, q_first_lower, q, pc,
                        valid)
    dev = q.device
    B = q_lens.shape[0]
    if score is not None:
        _check_score(score, B, P, index.norm_lens.shape[0], dev)
    if dev.type == "cpu":
        m = dl_lcs_slots_plain(index, q_norms, q_lens, k_ed, q_first_lower,
                               q, pc, valid, window)
        return m if score is None else score_slots_plain(m, q, pc, valid, L,
                                                         score)
    if dev.type != "cuda":
        raise ValueError(f"dl_lcs_slots: unsupported device {dev}")
    if window not in KERNEL_WINDOWS:
        raise ValueError(f"dl_lcs_slots kernel: window {window} not in "
                         f"{KERNEL_WINDOWS}")
    tables = (q.data_ptr(), pc.data_ptr(), valid.data_ptr(),
              index.norms2.data_ptr(), index.norm_lens.data_ptr(),
              index.first_lower.data_ptr(), q_norms.data_ptr(),
              q_lens.data_ptr(), q_first_lower.data_ptr(), k_ed.data_ptr(),
              q_norms.element_size())
    if score is None:
        metrics = torch.empty((6, P), dtype=torch.int32, device=dev)
        same_first = torch.empty(P, dtype=torch.bool, device=dev)
        out = SlotMetrics(*metrics.unbind(), same_first)
        if not P:
            return out
        entry = "analiticcl_dl_lcs_slots"
        args = (*tables, metrics.data_ptr(), same_first.data_ptr(), P, L,
                window)
    else:
        s = score
        keep = torch.empty(P, dtype=torch.bool, device=dev)
        met = torch.empty((5, P), dtype=met_dtype(L), device=dev)
        max_freq = (torch.zeros if s.freqs is not None else torch.ones)(
            B, dtype=torch.int64, device=dev)
        f32 = (torch.empty(P, dtype=torch.float32, device=dev)
               if s.want_score else None)
        counts = torch.empty(-(-P // slot_block(L)), dtype=torch.int32,
                             device=dev)
        out = SlotScore(keep, met, max_freq, f32, counts)
        if not P:
            return out

        def ptr(t):
            return None if t is None else t.data_ptr()

        entry = "analiticcl_dl_lcs_slots_scored"
        args = (*tables, s.pc_band.data_ptr(), s.exact_q.data_ptr(),
                s.exact_q.shape[1], ptr(s.use_exact), ptr(s.freqs),
                s.weights.data_ptr(), s.thr.data_ptr(), keep.data_ptr(),
                met.data_ptr(),
                ptr(max_freq if s.freqs is not None else None),
                ptr(f32), counts.data_ptr(), P, L, window)
    err = _launch(entry, args, L, P, dev)
    dl_lcs_slots.launches += 1
    dl_lcs.launches += 1
    wide_path.launches += L > NARROW_LEN
    _build.check(err, "dl_lcs_slots kernel launch")
    return out


dl_lcs_slots.launches = 0
