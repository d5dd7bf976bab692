"""Whole-batch vectorized ranking tail.

The port's copy of ``analiticcl_tpu/ops/rank_batch.py``.

Applies score_and_rank's post-scoring semantics (threshold, frequency
normalization, stable rank order, tie-aware max_matches crop with the
reference's early_cutoff quirk, relative cutoff threshold — lib.rs:1405-1653)
to *every* query of a batch at once with segment reductions, instead of one
numpy pass per query. Used only for queries with no confusables and no
expandable variants; bit-equal to ops.pipeline._rank_fast (which remains the
single-query reference and the fallback), enforced by tests.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..types import SearchParameters, VariantResult

_BIG = np.iinfo(np.int64).max // 4


def rank_fast_batch(
    model,
    vocab_ids: np.ndarray,
    o_c: np.ndarray,  # [K] candidate rows (kept pairs of eligible queries)
    dist_scores: np.ndarray,  # [K] f64
    freqs: np.ndarray,  # [K] f64 absolute
    seg: np.ndarray,  # [K] query-slot id per pair, non-decreasing
    nseg: int,
    max_freq_floors: np.ndarray,  # [nseg]
    params: SearchParameters,
    stop_before_cutoff: bool = False,
) -> List[List[VariantResult]]:
    """Returns one result list per segment (query slot).

    ``stop_before_cutoff=True`` returns the tie-aware-cropped lists WITHOUT
    applying the relative cutoff threshold — the late-confusables fast path
    (pipeline.collect) rescores the cropped survivors first, then re-ranks
    and applies the cutoff per query (score_and_rank order,
    lib.rs:1592-1622)."""
    out: List[List[VariantResult]] = [[] for _ in range(nseg)]
    if len(o_c) == 0:
        return out

    # strict threshold
    keep = dist_scores >= params.score_threshold
    o_c = o_c[keep]
    dist_scores = dist_scores[keep]
    freqs = freqs[keep]
    seg = seg[keep]
    if len(o_c) == 0:
        return out

    counts = np.bincount(seg, minlength=nseg)
    seg_starts_all = np.concatenate([[0], np.cumsum(counts)[:-1]])
    nonempty = counts > 0
    # frequency normalization (max over above-threshold + device floor)
    if model.have_freq:
        seg_max = np.full(nseg, 0.0)
        np.maximum.at(seg_max, seg, freqs)
        max_freq = np.maximum(seg_max, max_freq_floors)
    else:
        max_freq = np.maximum(1.0, max_freq_floors)
    denom = np.where(max_freq > 0.0, max_freq, 1.0)
    freqn = freqs / denom[seg]

    fw = params.freq_weight
    if fw > 0.0:
        blended = (dist_scores + fw * freqn) / (1.0 + fw)
        order = np.lexsort((-blended, seg))
    else:
        order = np.lexsort((-freqn, -dist_scores, seg))
    o_c = o_c[order]
    dist_scores = dist_scores[order]
    freqn = freqn[order]
    seg_sorted = seg[order]
    s = (dist_scores + fw * freqn) / (1.0 + fw) if fw > 0.0 else dist_scores

    n_rows = len(o_c)
    starts = seg_starts_all  # valid where nonempty
    rank = np.arange(n_rows) - starts[seg_sorted]
    sizes = counts[seg_sorted]

    # ---- tie-aware crop at max_matches (lib.rs:1536-1589) ----
    mm = params.max_matches
    end_per_seg = counts.astype(np.int64).copy()  # default: keep all
    if mm > 0:
        crop_seg = np.nonzero(nonempty & (counts > mm))[0]
        if len(crop_seg):
            st = starts[crop_seg]
            last_sc = s[st + mm - 1]
            cropped_sc = s[st + mm]
            simple = cropped_sc < last_sc
            end_per_seg[crop_seg[simple]] = mm
            hard = crop_seg[~simple]
            if len(hard):
                hard_mask = np.isin(seg_sorted, hard)
                cropped_of = np.zeros(nseg)
                cropped_of[hard] = cropped_sc[~simple]
                cexp = cropped_of[seg_sorted]
                # first rank with dist < cropped (per segment)
                lt = hard_mask & (dist_scores < cexp)
                seg_first_lt = np.full(nseg, _BIG, dtype=np.int64)
                np.minimum.at(seg_first_lt, seg_sorted[lt], rank[lt])
                # eq ranks below first_lt
                limit = seg_first_lt[seg_sorted]
                limit = np.where(limit == _BIG, sizes, limit)
                eq = hard_mask & (dist_scores == cexp) & (rank < limit)
                seg_eq1 = np.full(nseg, _BIG, dtype=np.int64)
                np.minimum.at(seg_eq1, seg_sorted[eq], rank[eq])
                eq2_mask = eq & (rank > seg_eq1[seg_sorted])
                seg_eq2 = np.full(nseg, _BIG, dtype=np.int64)
                np.minimum.at(seg_eq2, seg_sorted[eq2_mask], rank[eq2_mask])
                for g in hard:
                    e1 = seg_eq1[g]
                    e2 = seg_eq2[g]
                    if e1 != _BIG and e1 != 0:
                        early = e1
                    elif e2 != _BIG:
                        early = e2
                    else:
                        early = 0
                    late = seg_first_lt[g] if seg_first_lt[g] != _BIG else 0
                    if early > 0:
                        end_per_seg[g] = early + 1
                    elif late > 0:
                        end_per_seg[g] = late + 1
                    # else: keep all

    # ---- cutoff threshold (lib.rs:1597-1622) ----
    if params.cutoff_threshold >= 1.0 and not stop_before_cutoff:
        best = np.zeros(nseg)
        best[nonempty] = s[starts[nonempty]]
        below = (
            (rank >= 1)
            & (rank < end_per_seg[seg_sorted])
            & (s <= best[seg_sorted] / params.cutoff_threshold)
        )
        seg_cut = np.full(nseg, _BIG, dtype=np.int64)
        np.minimum.at(seg_cut, seg_sorted[below], rank[below])
        end_per_seg = np.minimum(
            end_per_seg, np.where(seg_cut == _BIG, end_per_seg, seg_cut)
        )

    final_mask = rank < end_per_seg[seg_sorted]
    rows = np.nonzero(final_mask)[0]
    # bulk-extract fields once, then build result objects from Python scalars
    # (per-row numpy scalar indexing costs ~10x more than tolist+zip)
    segl = seg_sorted[rows].tolist()
    vids = vocab_ids[o_c[rows]].tolist()
    ds = dist_scores[rows].tolist()
    fs = freqn[rows].tolist()
    for g, v, dv, fv in zip(segl, vids, ds, fs):
        out[g].append(VariantResult(v, dv, fv, None))
    return out
