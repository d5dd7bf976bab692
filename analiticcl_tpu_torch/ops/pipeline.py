"""The batched device query: retrieval -> scoring, then the exact host tail.

The port of ``analiticcl_tpu/ops/pipeline.py``'s query path:

* :func:`query_core` is the counterpart of the fused ``_query_core``, with the
  same inputs (the index arrays in a :class:`~..convert.DeviceIndex`, then the
  per-batch query arrays) and the same outputs ``o_q, o_c, o_ld, o_lcs, o_pf,
  o_sf, o_case, max_freq, total_match, total_keep``. Stage A and the DL+LCS
  DP run in the hand-written kernels (``ops/stage_a.py``, ``ops/dl.py``) on
  CUDA tensors; the glue between them is torch ops. It is the composition
  of :func:`query_stage_a` and :func:`query_stage_b`, which a sharded index
  (``parallel/mesh.py``) calls per shard, combining the shards' exact
  counts between them.
* :class:`DevicePipeline` ports the host side: query preparation, the window
  split, the band plan, and the float64 ranking tail (the native C++ one, or
  the numpy one).

What the JAX version needed for XLA's static shapes on a TPU and the port
leaves out, because PyTorch runs eagerly and sizes every tensor from the data:

* the P/P2 pair-budget buckets, their overflow escalation, de-escalation and
  the cross-process budget-hint file: pair lists are sized from the true
  totals, so they cannot overflow;
* the radix block descent and ``_searchsorted_radix`` for pair compaction:
  the hit bits are unpacked and ``nonzero`` gives the (query, band row) pairs,
  query-major by construction, as the reference's gather order wants;
* the single packed int32 output buffer (``_pack_query_out``), built for a
  per-array transfer cost of the remote TPU;
* the ``max_B`` batch ceiling, the band-width compile ceiling, the batch
  split (``_collect_split``) and the band-width buckets: there is no compile
  step on the card, so a batch runs with its exact band. The one cap left is
  on memory: a batch whose stage-A hit bits (queries x band rows) pass
  :attr:`DevicePipeline.max_hit_bits` splits into charcount-contiguous
  sub-batches, joined as the window split joins its sub-batches.
"""

from __future__ import annotations

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
from ..convert import DeviceIndex, host_layout, index_tensors_from_numpy
from ..device import resolve_device
from .dl import PAD_A, PAD_B, affix_metrics_aligned, dl_lcs
from .rank_batch import rank_fast_batch
from .ranked import RankedResults
from .stage_a import ROW_BLOCK, _b_tile, stage_a_masks

THRESHOLD_SLACK = 1e-4
B_BUCKETS = (8, 64, 256, 1024, 2048, 4096, 8192)
# DL exactness windows (12 = reference MAX_EDIT_DISTANCE)
WINDOW_BUCKETS = (3, 6, 12)


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


def query_planes(index: DeviceIndex, q_counts):
    """int8 [B, at_pad] binarized count planes of the queries, zero-padded to
    the index's plane width (ops/pipeline.py:403-409)."""
    B, A = q_counts.shape
    T = index.at // A
    t_levels = torch.arange(T, dtype=torch.int32, device=q_counts.device)
    qbin = (q_counts.clamp(max=T)[:, :, None] > t_levels).reshape(B, A * T)
    pad = index.bins.shape[1] - A * T
    return torch.nn.functional.pad(qbin.to(torch.int8), (0, pad))


def compact_pairs(packed_q, start_blk, Ni_pad: int):
    """(query, band row, device row) of every stage-A hit, query-major and
    then in band-row order: the reference's gather order."""
    B = packed_q.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed_q.device)
    bits = (packed_q[:, :, None] >> shifts) & 1
    pairs = torch.nonzero(bits.view(B, -1))
    pq = pairs[:, 0]
    pc_band = pairs[:, 1]
    pc = start_blk.long()[pq // _b_tile(B, Ni_pad)] * ROW_BLOCK + pc_band
    return pq, pc_band, pc


class PairInputs(NamedTuple):
    a: torch.Tensor  # int32 [P, L] query strings, PAD_A padded
    ql: torch.Tensor  # int32 [P]
    b: torch.Tensor  # int32 [P, L] candidate strings, PAD_B padded
    cl: torch.Tensor  # int32 [P]
    a_rev: torch.Tensor  # reversed, left-aligned query strings
    b_rev: torch.Tensor  # reversed, left-aligned candidate strings
    k_ed: torch.Tensor  # int32 [P] the pair's query edit threshold
    c_first_lower: torch.Tensor  # bool [P]
    q_first_lower: torch.Tensor  # bool [P]


def gather_pairs(index: DeviceIndex, q_norms, q_lens, k_ed, q_first_lower,
                 pq, pc) -> PairInputs:
    """Per-pair strings and attributes, one gather per side: each side's
    columns are concatenated into one table first (ops/pipeline.py:594-639)."""
    i32 = torch.int32
    L = index.norms2.shape[1] // 2
    pos = torch.arange(L, dtype=i32, device=q_norms.device)[None, :]
    rev_idx = q_lens[:, None] - 1 - pos
    q_norms_rev = torch.where(
        rev_idx >= 0, torch.gather(q_norms, 1, rev_idx.clamp(min=0).long()), 0
    ).to(q_norms.dtype)
    norms2 = index.norms2
    tdt = torch.int8 if norms2.dtype == torch.int8 and L < 127 else i32
    cand_tab = torch.cat(
        [norms2.to(tdt), index.norm_lens[:, None].to(tdt),
         index.first_lower[:, None].to(tdt)],
        1,
    )
    cg = cand_tab[pc]
    cl = cg[:, 2 * L].to(i32)
    q_tab = torch.cat(
        [q_norms.to(tdt), q_norms_rev.to(tdt), q_lens[:, None].to(tdt),
         k_ed[:, None].to(tdt), q_first_lower[:, None].to(tdt)],
        1,
    )
    qg = q_tab[pq]
    ql = qg[:, 2 * L].to(i32)
    q_in = pos < ql[:, None]
    c_in = pos < cl[:, None]
    return PairInputs(
        a=torch.where(q_in, qg[:, :L].to(i32), PAD_A).contiguous(),
        ql=ql,
        b=torch.where(c_in, cg[:, :L].to(i32), PAD_B).contiguous(),
        cl=cl,
        a_rev=torch.where(q_in, qg[:, L : 2 * L].to(i32), PAD_A),
        b_rev=torch.where(c_in, cg[:, L : 2 * L].to(i32), PAD_B),
        k_ed=qg[:, 2 * L + 1].to(i32),
        c_first_lower=cg[:, 2 * L + 1].bool(),
        q_first_lower=qg[:, 2 * L + 2].bool(),
    )


class StageA(NamedTuple):
    packed_q: torch.Tensor  # uint8 [B, Nb / 8] hit bits
    exact_q: torch.Tensor  # uint8 [B, Nb / 8] exact-anagram bits
    nmatch: torch.Tensor  # int32 [B] hits per query
    nexact: torch.Tensor  # int32 [B] exact anagrams per query


def query_stage_a(index: DeviceIndex, q_counts, q_cc, k_ana, k_len,
                  start_blk, nb_band: int) -> StageA:
    """Stage A of :func:`query_core`: banded retrieval (kernel K1) over
    ``index``'s rows. The per-128-row counts fed the JAX core's radix
    descent; ``nonzero`` over the unpacked bits needs no counts."""
    packed_q, exact_q, _counts_t, nmatch, nexact = stage_a_masks(
        index.bins, index.cc, index.validrows, query_planes(index, q_counts),
        q_cc, k_ana, k_len, start_blk, nb_band,
    )
    return StageA(packed_q, exact_q, nmatch, nexact)


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
    window: int,  # DL exactness window (>= every per-query edit distance)
    nb_band: int,  # band width in ROW_BLOCK blocks
    use_stop_exact: bool = True,
):
    """One batch through stage A, pair compaction, stage B and the f32
    pre-filter. Survivors come back in (query, device row) order."""
    sa = query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                       nb_band)
    return query_stage_b(
        index, sa, stop_exact & (sa.nexact > 0), q_norms, q_lens,
        q_first_lower, k_ed, start_blk, weights, score_threshold,
        have_freq=have_freq, window=window, use_stop_exact=use_stop_exact,
    )


def query_stage_b(
    index: DeviceIndex,
    sa: StageA,
    use_exact,  # bool [B]: the query keeps only its exact-anagram pairs
    q_norms, q_lens, q_first_lower, k_ed, start_blk, weights,
    score_threshold,
    *,
    have_freq: bool,
    window: int,
    use_stop_exact: bool = True,
):
    """Stage B of :func:`query_core` over stage A's hits in ``index``: pair
    compaction, the gathers, DL + LCS (kernel K2), the affixes, the f32
    score and survivor compaction. ``use_exact`` is separate because under
    a sharded index it depends on every shard's exact count."""
    packed_q, exact_q, nmatch = sa.packed_q, sa.exact_q, sa.nmatch
    dev = packed_q.device
    B = packed_q.shape[0]
    i32 = torch.int32
    total_match = nmatch.sum()
    pq, pc_band, pc = compact_pairs(packed_q, start_blk, index.bins.shape[0])
    pr = gather_pairs(index, q_norms, q_lens, k_ed, q_first_lower, pq, pc)
    a, ql, b, cl = pr.a, pr.ql, pr.b, pr.cl

    # ---- stage B: DL + LCS (kernel K2), prefix/suffix as torch ops ----
    ld, lcs = dl_lcs(a, ql, b, cl, a.shape[1], window)
    pf, sf = affix_metrics_aligned(a, ql, b, cl, pr.a_rev, pr.b_rev)

    # ---- f32 pre-filter score, same operation order as the JAX core ----
    w_ld, w_lcs, w_pf, w_sf, w_case, w_sum = weights.unbind()
    lcs = torch.where(w_lcs > 0, lcs, 0)
    pf = torch.where(w_pf > 0, pf, 0)
    sf = torch.where(w_sf > 0, sf, 0)
    samecase = torch.where(
        w_case > 0, pr.c_first_lower == pr.q_first_lower, True
    )
    qlen_f = ql.clamp(min=1).to(torch.float32)
    ds = torch.where(ld > ql, 0.0, 1.0 - ld.to(torch.float32) / qlen_f)
    score = (
        w_ld * ds
        + w_lcs * lcs.to(torch.float32) / qlen_f
        + w_pf * pf.to(torch.float32) / qlen_f
        + w_sf * sf.to(torch.float32) / qlen_f
        + torch.where(samecase, w_case, 0.0)
    ) / w_sum

    pass_ed = ld <= pr.k_ed
    if use_stop_exact:
        # StopAtExactMatch (lib.rs:1158-1174): queries with an exact anagram
        # keep only their exact pairs
        eb = exact_q[pq, pc_band // 8].to(i32)
        pair_exact = ((eb >> (pc_band % 8).to(i32)) & 1) == 1
        pass_ed = pass_ed & (~use_exact[pq] | pair_exact)
    keep = pass_ed & (score >= score_threshold - THRESHOLD_SLACK)

    # the normalization max runs over every pair within the edit threshold,
    # also those below the score threshold (lib.rs:1455-1476); exact int64
    if have_freq:
        cf = index.freqs[pc]
        max_freq = torch.zeros(B, dtype=torch.int64, device=dev).scatter_reduce(
            0, pq, torch.where(pass_ed, cf, 0), "amax"
        )
    else:
        max_freq = torch.ones(B, dtype=torch.int64, device=dev)
    total_keep = keep.sum()

    # ---- survivor compaction, order kept ----
    kidx = torch.nonzero(keep).squeeze(1)
    o_q = pq[kidx].to(i32)
    o_c = pc[kidx].to(i32)
    o_ld, o_lcs, o_pf, o_sf = (x[kidx] for x in (ld, lcs, pf, sf))
    if a.shape[1] < 256:  # kept pairs: ld <= 12, lcs/prefix/suffix <= L
        o_ld = o_ld.clamp(max=255).to(torch.uint8)
        o_lcs, o_pf, o_sf = (x.to(torch.uint8) for x in (o_lcs, o_pf, o_sf))
    o_case = samecase[kidx].to(torch.uint8)
    return (
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
        max_freq, total_match, total_keep,
    )


class DevicePipeline:
    """A built model's index on one device, and the batched query over it."""

    # Largest B x band rows of one query_core call: pair compaction unpacks
    # every hit bit to a byte (1 GiB here), and torch.nonzero counts them
    # in int32. Larger batches split (``prepare``).
    max_hit_bits = 1 << 30

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
        self.index = index_tensors_from_numpy(
            lay.bins, lay.cc, lay.validrows, lay.norms2, lay.norm_lens,
            lay.freqs, lay.first_lower, self.device,
        )
        self._refresh_variant_flags()
        self.stats = StageTimer()
        # stage-A hits and f32-filter survivors summed over collected batches
        self.candidates = 0
        self.survivors = 0
        # (text, params) -> oracle results for over-long queries; cleared
        # whenever frequencies refresh (freq_score is part of the results)
        self._oracle_memo: dict = {}

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
        ``depth`` submitted batches ahead of the one being ranked.
        :func:`query_core` synchronises with the card at its ``nonzero``
        calls, so a submitted batch has run by the time ``submit`` returns:
        the host tail does not yet overlap device work. With ``ranked``,
        batches that complete through the native tail yield
        :class:`RankedResults` instead of eager lists; callers handle both."""
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
        """Host prep and the device call; pair with :meth:`collect`."""
        state = self.prepare(inputs, params)
        if "args" in state:
            with self.stats.stage("device"):
                state["out"] = self._query(
                    state["args"], state["window"], state["nb_band"],
                    state["use_stop_exact"],
                )
        return state

    def _query(self, args, window: int, nb_band, use_stop_exact: bool):
        """The device call of one prepared batch."""
        return query_core(
            self.index, *args, have_freq=bool(self.model.have_freq),
            window=window, nb_band=nb_band, use_stop_exact=use_stop_exact,
        )

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
                key = (text, _params_key(params))
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
        start_blk, nb_band = self._band_plan(q_cc, k_len, B)
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
        args = tuple(
            torch.from_numpy(x).to(self.device)
            for x in (
                q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana, k_ed,
                k_len, stop_exact, start_blk, weights_arr,
                np.asarray(params.score_threshold, dtype=np.float32),
            )
        )
        prep_cm.__exit__(None, None, None)
        return {
            "results": results, "active": active, "inputs": inputs,
            "params": params, "args": args, "window": window,
            "nb_band": nb_band, "use_stop_exact": use_se, "B": B,
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

        Returns (start_blk int32 [B // bt], nb_band): every tile's block
        window [start, start + nb_band) covers all device rows with
        charcount in [min(q_cc - k), max(q_cc + k)] over the tile's active
        queries (k < 0 marks padding) -- the reference's sortedindex
        charcount sweep (lib.rs:1266-1288) as a block range."""
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
        return start, nb_band

    def _finalize(self, out):
        """Device outputs as numpy; ``max_freq`` as the uint32 floors the
        native tail reads."""
        (o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
         max_freq, total_match, total_keep) = (t.cpu().numpy() for t in out)
        return (
            o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
            max_freq.astype(np.uint32), int(total_match), int(total_keep),
        )

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

        with self.stats.stage("device_get"):
            (
                o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
                max_freq, total_match, total_keep,
            ) = self._finalize(state["out"])
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
