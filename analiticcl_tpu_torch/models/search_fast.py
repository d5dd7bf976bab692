"""Array-native search-mode unit pipeline (the fast path of find_all_matches).

The port's copy of ``analiticcl_tpu/models/search_fast.py``, with the port's
:class:`~..ops.ranked.RankedResults` in place of the JAX pipeline's.

The object path in variant_model.py mirrors the reference structurally:
boundary/segment ``Match`` objects, per-hard-batch lattices, an n-best DP
(lib.rs:1789-2495). That path stays — it handles the LM, context rules,
debug dumps, and non-ASCII text. This module is the production fast path
for everything else, and it is *shaped for the machine* rather than for the
reference: on one host core feeding a TPU, per-object Python work is the
throughput floor, so segmentation, attachment, redundancy filtering, arc
construction, the Viterbi DP, and path backtracking all run as flat numpy
array programs over the whole unit (several texts, all hard batches in
lockstep). Python objects materialize only for best-path output.

Exact output equivalence with the object path — offsets, tie order,
variants sharing, the redundancy and internal-boundaries quirks
(search.rs:103-120, 317-336) — is pinned by tests/test_search.py.
"""

from __future__ import annotations

import re
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..search import Match, Offset, remap_offsets_to_unicodepoints

_ASCII_NONALPHA = re.compile(rb"[^A-Za-z]+")


@dataclass
class FastUnit:
    """Segmentation product of one stream unit (several texts)."""

    texts: Sequence[str]
    # per text: boundary offset arrays (python lists for scalar access)
    bb: List[Optional[List[int]]]
    be: List[Optional[List[int]]]
    # per text: UTF-8 bytes for non-ASCII texts (offsets are byte offsets;
    # ASCII texts slice the str directly), else None
    raw: List[Optional[bytes]] = field(default_factory=list)
    # chains (= hard batches), global across the unit
    chain_text: List[int] = field(default_factory=list)
    chain_begin: List[int] = field(default_factory=list)
    chain_end: List[int] = field(default_factory=list)
    chain_blo: List[int] = field(default_factory=list)
    chain_bhi: List[int] = field(default_factory=list)
    # per text: global chain id range [lo, hi)
    text_chains: List[Tuple[int, int]] = field(default_factory=list)
    # segments, global across the unit, text-major / batch-major /
    # order-major: (chain, order, begin, end, q) tuples (python path) ...
    segments: List[Tuple[int, int, int, int, int]] = field(
        default_factory=list
    )
    # ... or the same five columns as int64 arrays (native path)
    seg_cols: Optional[Tuple[np.ndarray, ...]] = None
    # deduplicated lookup texts, first-appearance order
    all_texts: List[str] = field(default_factory=list)


def _prepare_unit_native(
    texts: Sequence[str], max_ngram: int
) -> Optional[FastUnit]:
    """FastUnit via the C++ segmentation core (ananorm_segment); None when
    the native library is absent (the Python loop below is the oracle —
    equivalence is pinned by tests/test_search.py)."""
    from ..utils import native as _native

    res = _native.segment_unit(texts, max_ngram)
    if res is None:
        return None
    (
        b_off, bb_all, be_all, c_off, c_begin, c_end, c_blo, c_bhi,
        s_chain, s_order, s_begin, s_end, s_q, u_text, u_begin, u_end,
    ) = res
    n_texts = len(texts)
    unit = FastUnit(
        texts=texts,
        bb=[None] * n_texts,
        be=[None] * n_texts,
        raw=[None] * n_texts,
    )
    for ti in range(n_texts):
        lo, hi = int(b_off[ti]), int(b_off[ti + 1])
        unit.bb[ti] = bb_all[lo:hi]
        unit.be[ti] = be_all[lo:hi]
        unit.text_chains.append((int(c_off[ti]), int(c_off[ti + 1])))
    unit.chain_begin = c_begin.tolist()
    unit.chain_end = c_end.tolist()
    unit.chain_blo = c_blo.tolist()
    unit.chain_bhi = c_bhi.tolist()
    unit.chain_text = np.repeat(
        np.arange(n_texts), np.diff(c_off.astype(np.int64))
    ).tolist()
    unit.seg_cols = tuple(
        a.astype(np.int64)
        for a in (s_chain, s_order, s_begin, s_end, s_q)
    )
    unit.all_texts = [
        texts[t][b:e]
        for t, b, e in zip(u_text.tolist(), u_begin.tolist(), u_end.tolist())
    ]
    return unit


def _boundaries_unicode(text: str) -> Tuple[List[int], List[int]]:
    """Boundary runs (byte offsets) for non-ASCII text — the generic
    unicode-isalpha scan of search._find_boundaries_generic."""
    bb: List[int] = []
    be: List[int] = []
    begin: Optional[int] = None
    pos = 0
    for ch in text:
        if begin is not None:
            if ch.isalpha():
                bb.append(begin)
                be.append(pos)
                begin = None
        else:
            if not ch.isalpha():
                begin = pos
        pos += len(ch.encode())
    if begin is not None:
        bb.append(begin)
        be.append(pos)
    if not bb or be[-1] != pos:
        bb.append(pos)
        be.append(pos)
    return bb, be


def prepare_unit(texts: Sequence[str], max_ngram: int) -> Optional[FastUnit]:
    """Segment a unit of texts into flat arrays (no Match objects).

    Mirrors find_boundaries + classify_boundaries + the hard-batch split +
    find_match_ngrams (search.rs:190-313, lib.rs:1817-1861) exactly,
    including the trailing-segment internal-boundaries quirk. All offsets
    are UTF-8 byte offsets; all-ASCII units take the C++ core, non-ASCII
    texts the generic unicode boundary scan.
    """
    if all(not t or t.isascii() for t in texts):
        native = _prepare_unit_native(texts, max_ngram)
        if native is not None:
            return native
    unit = FastUnit(
        texts=texts,
        bb=[None] * len(texts),
        be=[None] * len(texts),
    )
    uniq: Dict[bytes, int] = {}
    all_bytes: List[bytes] = []
    ct, cb, ce, cblo, cbhi = (
        unit.chain_text, unit.chain_begin, unit.chain_end,
        unit.chain_blo, unit.chain_bhi,
    )
    segments = unit.segments

    unit.raw = [None] * len(texts)
    for ti, text in enumerate(texts):
        if not text:
            unit.text_chains.append((len(ct), len(ct)))
            continue
        data = text.encode()
        if text.isascii():
            # boundaries: runs of non-alphabetic bytes + trailing empty
            # (find_boundaries ASCII fast path, fuzz-pinned in tests)
            bb: List[int] = []
            be: List[int] = []
            for m in _ASCII_NONALPHA.finditer(data):
                bb.append(m.start())
                be.append(m.end())
            n = len(data)
            if not bb or be[-1] != n:
                bb.append(n)
                be.append(n)
        else:
            bb, be = _boundaries_unicode(text)
            unit.raw[ti] = data  # byte offsets: slice bytes, then decode
        unit.bb[ti] = bb
        unit.be[ti] = be
        nb = len(bb)

        # hard-batch split (lib.rs:1817-1836): HARD = multi-byte or final
        chain_lo = len(ct)
        begin = 0
        begin_index = 0
        for i in range(nb):
            if (be[i] - bb[i] > 1 or i == nb - 1) and bb[i] != begin:
                ct.append(ti)
                cb.append(begin)
                ce.append(bb[i])
                cblo.append(begin_index)
                cbhi.append(i + 1)
                begin = be[i]
                begin_index = i + 1
        unit.text_chains.append((chain_lo, len(ct)))

        # segments per batch, order-major within the batch (the attach /
        # arc creation order of the object path)
        for cid in range(chain_lo, len(ct)):
            bbegin, bend = cb[cid], ce[cid]
            blo, bhi = cblo[cid], cbhi[cid]
            m_b = bhi - blo
            for order in range(1, max_ngram + 1):
                seg_begin = bbegin
                i = 0
                while i + order - 1 < m_b:
                    bnd_begin = bb[blo + i + order - 1]
                    if bnd_begin > bend:
                        break
                    ln = bnd_begin - seg_begin
                    if ln > 0 and not (ln == 1 and data[seg_begin] == 0x20):
                        key = data[seg_begin:bnd_begin]
                        q = uniq.get(key)
                        if q is None:
                            q = len(all_bytes)
                            uniq[key] = q
                            all_bytes.append(key)
                        segments.append(
                            (cid, order, seg_begin, bnd_begin, q)
                        )
                    seg_begin = be[blo + i]
                    i += 1
                if seg_begin < bend:
                    ln = bend - seg_begin
                    if ln > 0 and not (ln == 1 and data[seg_begin] == 0x20):
                        # internal-boundaries quirk (search.rs:103-120): the
                        # hit range over the batch slice is contiguous, the
                        # quirk slice length equals the hit count, and a
                        # single hit yields an empty slice
                        lo_i = bisect_right(bb, seg_begin, blo, bhi)
                        hi_i = bisect_left(be, bend, blo, bhi)
                        cnt = hi_i - lo_i
                        if cnt >= 2 and cnt == order:
                            key = data[seg_begin:bend]
                            q = uniq.get(key)
                            if q is None:
                                q = len(all_bytes)
                                uniq[key] = q
                                all_bytes.append(key)
                            segments.append(
                                (cid, order, seg_begin, bend, q)
                            )

    unit.all_texts = [b.decode() for b in all_bytes]
    return unit


def _found_arrays(found, nq: int, fw: float):
    """(score, ds, vid, k_of_q, lo_of_q) flat survivor columns from a
    RankedResults batch, or from plain per-query lists (fallback envs)."""
    from ..ops.ranked import RankedResults

    if isinstance(found, RankedResults):
        ds = found.ds
        fqv = found.fq
        vid = found.vid
        row_of = found.row_of
        sb = found.sbounds
        safe = np.maximum(row_of, 0)
        k_of_q = np.where(row_of >= 0, sb[safe + 1] - sb[safe], 0).astype(
            np.int64
        )
        lo_of_q = np.where(row_of >= 0, sb[safe], 0).astype(np.int64)
        if found.overrides:
            # pre-resolved / expandable-variant inputs (rare): patch their
            # object scores into an extra region behind the arrays
            extra_ds: List[float] = []
            extra_fq: List[float] = []
            extra_vid: List[int] = []
            base = len(ds)
            for q, lst in found.overrides.items():
                if not 0 <= q < nq:
                    continue
                k_of_q[q] = len(lst)
                lo_of_q[q] = base + len(extra_ds)
                extra_ds.extend(r.dist_score for r in lst)
                extra_fq.extend(r.freq_score for r in lst)
                extra_vid.extend(r.vocab_id for r in lst)
            if extra_ds:
                ds = np.concatenate([ds, np.asarray(extra_ds, np.float64)])
                fqv = np.concatenate([fqv, np.asarray(extra_fq, np.float64)])
                vid = np.concatenate([vid, np.asarray(extra_vid, np.int64)])
        if fw > 0.0:
            score = (ds + fw * fqv) / (1.0 + fw)
        else:
            score = ds.astype(np.float64, copy=False)
        return score, ds, vid, k_of_q, lo_of_q

    # generic: flatten per-query object lists (also covers override rows)
    k_of_q = np.fromiter(
        (len(found[q]) for q in range(nq)), np.int64, count=nq
    )
    lo_of_q = np.zeros(nq, np.int64)
    np.cumsum(k_of_q[:-1], out=lo_of_q[1:])
    tot = int(k_of_q.sum())
    ds = np.empty(tot, np.float64)
    fqv = np.empty(tot, np.float64)
    vid = np.empty(tot, np.int64)
    pos = 0
    for q in range(nq):
        for r in found[q]:
            ds[pos] = r.dist_score
            fqv[pos] = r.freq_score
            vid[pos] = r.vocab_id
            pos += 1
    score = ds if fw <= 0.0 else (ds + fw * fqv) / (1.0 + fw)
    return score, ds, vid, k_of_q, lo_of_q


def consolidate_unit(
    unit: FastUnit, found, params, consolidate: bool, model=None
) -> List[List[Match]]:
    """Attach + redundancy filter + lockstep decode + emit, all flat.

    ``consolidate`` mirrors the object path's gate (max_ngram > 1, LM
    present, or context rules). Without an LM the decode is a lockstep
    nbest=1 Viterbi; with ``model`` given and an active LM it is the
    lockstep n-best + LM rescoring decode (:func:`_consolidate_lm`),
    equivalent to the object path's most_likely_sequence
    (lib.rs:2088-2495) minus context rules, which stay on the object path.
    """
    fw = params.freq_weight
    nq = len(unit.all_texts)
    score, ds_all, vid_all, k_of_q, lo_of_q = _found_arrays(found, nq, fw)

    if unit.seg_cols is not None:
        s_chain, s_order, s_begin, s_end, s_q = unit.seg_cols
    elif unit.segments:
        s_chain, s_order, s_begin, s_end, s_q = (
            np.asarray(col, np.int64) for col in zip(*unit.segments)
        )
    else:
        s_chain = s_order = s_begin = s_end = s_q = np.zeros(0, np.int64)
    nseg = len(s_chain)
    nchain = len(unit.chain_text)
    chain_blo = np.asarray(unit.chain_blo, np.int64) if nchain else np.zeros(0, np.int64)
    chain_end = np.asarray(unit.chain_end, np.int64) if nchain else np.zeros(0, np.int64)
    chain_bhi_arr = np.asarray(unit.chain_bhi, np.int64) if nchain else np.zeros(0, np.int64)

    # per-survivor-set predicates for the redundancy filter
    k_seg = k_of_q[s_q] if nseg else np.zeros(0, np.int64)
    lo_seg = lo_of_q[s_q] if nseg else np.zeros(0, np.int64)
    n_sv = len(ds_all)
    if n_sv:
        perfect_seg = (k_seg > 0) & (
            ds_all[np.minimum(lo_seg, n_sv - 1)] >= 1.0
        )
    else:
        perfect_seg = np.zeros(nseg, bool)

    # ---- attach + redundancy (vectorized per text) ----
    # a higher-order segment keeps its lookup only if some covered unigram
    # is missing or imperfect (search.rs:317-336); unigram spans per text
    # are ascending in both begin and end, so the covered set is a slice
    attached = np.ones(nseg, bool)
    nb_local = np.zeros(nseg, np.int64)
    pv_state = np.zeros(nseg, np.int64)  # prevstate (0 = chain start)
    arc_ok = np.zeros(nseg, bool)
    for ti in range(len(unit.texts)):
        clo, chi = unit.text_chains[ti]
        if clo == chi:
            continue
        sl, sh = (
            int(np.searchsorted(s_chain, clo)),
            int(np.searchsorted(s_chain, chi)),
        )
        if sl == sh:
            continue
        seg_sl = slice(sl, sh)
        t_begin = s_begin[seg_sl]
        t_end = s_end[seg_sl]
        t_order = s_order[seg_sl]
        uni = t_order == 1
        ub = t_begin[uni]
        ue = t_end[uni]
        # unigram arrays are batch-major ascending, but order-major storage
        # interleaves per batch; re-sort unigrams by begin for the slices
        us = np.argsort(ub, kind="stable")
        ub = ub[us]
        ue = ue[us]
        uperf = perfect_seg[seg_sl][uni][us]
        pp = np.zeros(len(ub) + 1, np.int64)
        np.cumsum(uperf, out=pp[1:])
        hi_order = ~uni
        if hi_order.any():
            cb2 = t_begin[hi_order]
            ce2 = t_end[hi_order]
            lo_r = np.searchsorted(ub, cb2, side="left")
            hi_r = np.searchsorted(ue, ce2, side="right")
            cov = np.maximum(hi_r - lo_r, 0)
            redundant = (pp[np.maximum(hi_r, lo_r)] - pp[lo_r]) == cov
            att = attached[seg_sl]
            att[hi_order] = ~redundant
            attached[seg_sl] = att

        # boundary resolution: next boundary starts at seg end, previous
        # boundary ends at seg begin, both restricted to the chain's slice
        bb = np.asarray(unit.bb[ti], np.int64)
        be = np.asarray(unit.be[ti], np.int64)
        blo_seg = chain_blo[s_chain[seg_sl]]
        bhi_seg = chain_bhi_arr[s_chain[seg_sl]]
        nbi = np.searchsorted(bb, t_end)
        nb_valid = (
            (nbi < len(bb)) & (nbi >= blo_seg) & (nbi < bhi_seg)
        )
        nb_valid &= np.where(nb_valid, bb[np.minimum(nbi, len(bb) - 1)], -1) == t_end
        pbi = np.searchsorted(be, t_begin)
        pb_valid = (pbi < len(be)) & (pbi >= blo_seg) & (pbi < bhi_seg)
        pb_valid &= np.where(pb_valid, be[np.minimum(pbi, len(be) - 1)], -1) == t_begin
        nb_loc = nbi - blo_seg
        pb_loc = pbi - blo_seg
        nb_local[seg_sl] = np.where(nb_valid, nb_loc, -1)
        pv_state[seg_sl] = np.where(pb_valid, pb_loc + 1, 0)
        arc_ok[seg_sl] = nb_valid
    n_span = np.where(
        pv_state > 0, nb_local + 1 - pv_state, nb_local + 1
    )

    k_att = np.where(attached, k_seg, 0)
    var_mask = arc_ok & (k_att > 0)
    oov_mask = arc_ok & (k_att == 0) & (n_span == 1)

    # output materialization: bypass RankedResults.__getitem__ (its per-call
    # span/cache machinery costs ~3x the object construction) with one bulk
    # numpy->python conversion and direct list slicing
    found_cache: Dict[int, list] = {}
    from ..ops.ranked import RankedResults
    from ..types import VariantResult

    if isinstance(found, RankedResults):
        row_l = found.row_of.tolist()
        f_over = found.overrides
        nrows_f = len(found.sbounds) - 1
        from ..utils.native import fastemit_build_result_lists

        femit = fastemit_build_result_lists()
        if femit is not None and nrows_f >= 0:
            # ONE C call builds every row's VariantResult list (matches with
            # the same qidx share the list object, like the object path's
            # cached __getitem__). Per-call Python construction measured
            # ~22 us per materialized segment — about half of consolidate.
            rows_lists = femit(
                VariantResult,
                np.ascontiguousarray(found.vid, dtype=np.int64),
                np.ascontiguousarray(found.ds, dtype=np.float64),
                np.ascontiguousarray(found.fq, dtype=np.float64),
                np.ascontiguousarray(found.sbounds, dtype=np.int64),
                nrows_f,
            )

            def variants_of(q: int):
                res = f_over.get(q)
                if res is None:
                    row = row_l[q]
                    res = rows_lists[row] if row >= 0 else []
                return res
        else:
            vid_l = found.vid.tolist()
            ds_l = found.ds.tolist()
            fq_l = found.fq.tolist()
            sb_l = found.sbounds.tolist()

            def variants_of(q: int):
                got = found_cache.get(q)
                if got is not None:
                    return got
                res = f_over.get(q)
                if res is None:
                    row = row_l[q]
                    if row < 0:
                        res = []
                    else:
                        lo2 = sb_l[row]
                        hi2 = sb_l[row + 1]
                        res = list(
                            map(
                                VariantResult,
                                vid_l[lo2:hi2], ds_l[lo2:hi2], fq_l[lo2:hi2],
                            )
                        )
                found_cache[q] = res
                return res
    else:

        def variants_of(q: int):
            got = found_cache.get(q)
            if got is None:
                got = found[q]
                found_cache[q] = got
            return got

    attached_l = attached.tolist()
    if unit.segments:
        segs = unit.segments
    else:  # native path: one bulk conversion for scalar access at emit
        segs = list(
            zip(*(c.tolist() for c in unit.seg_cols))
        ) if unit.seg_cols is not None else []
    chain_text = unit.chain_text
    texts_l = unit.texts
    raw_l = unit.raw

    def make_match(si: int, selected) -> Match:
        cid, order, sb, se, q = segs[si]
        ti = chain_text[cid]
        r = raw_l[ti]
        m = Match(
            # ASCII: byte offsets == char offsets, slice the str; non-ASCII
            # texts carry their UTF-8 bytes (offsets are byte offsets)
            text=texts_l[ti][sb:se] if r is None else r[sb:se].decode(),
            offset=Offset(sb, se),
            n=order,
            qidx=q if attached_l[si] else None,
        )
        if attached_l[si]:
            # each Match owns its list: matches of one row (and the row
            # cache) must not see each other's edits
            m.variants = list(variants_of(q))
        m.selected = selected
        return m

    if not consolidate:
        results: List[List[Match]] = []
        for ti, text in enumerate(unit.texts):
            clo, chi = unit.text_chains[ti]
            sl = int(np.searchsorted(s_chain, clo))
            sh = int(np.searchsorted(s_chain, chi))
            matches = [make_match(si, 0) for si in range(sl, sh)]
            if params.unicodeoffsets:
                matches = remap_offsets_to_unicodepoints(text, matches)
            results.append(matches)
        return results

    # ---- arc expansion (creation order = segment order, eps arcs last) ----
    group_mask = var_mask | oov_mask
    g_idx = np.nonzero(group_mask)[0]
    g_k = np.where(var_mask[g_idx], k_att[g_idx], 1)
    g_oov = oov_mask[g_idx]
    scores_cat = np.concatenate([score, np.zeros(1)])
    vid_cat = np.concatenate([vid_all, np.zeros(1, np.int64)])
    sentinel = len(score)
    g_lo = np.where(g_oov, sentinel, lo_seg[g_idx])
    gk = g_k.astype(np.int64)
    tot = int(gk.sum())
    offs = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(gk) - gk, gk)
    a_chain = np.repeat(s_chain[g_idx], gk)
    a_src = np.repeat(pv_state[g_idx], gk)
    a_tgt = np.repeat(nb_local[g_idx] + 1, gk)
    a_sv = np.repeat(g_lo, gk) + offs  # survivor slot (sentinel for OOV)
    a_cost = (
        np.repeat(n_span[g_idx].astype(np.float64) + 1.0, gk)
        - scores_cat[a_sv]
    )
    a_vid = vid_cat[a_sv]  # arc vocab id (0 for OOV)
    a_seg = np.repeat(g_idx, gk)
    a_vidx = np.where(np.repeat(g_oov, gk), -1, offs)
    narcs = np.bincount(a_chain, minlength=nchain) if tot else np.zeros(
        nchain, np.int64
    )
    # epsilon failsafe arcs (lib.rs:2265-2276), chain-major
    nstates_c = (
        np.asarray(unit.chain_bhi, np.int64) - chain_blo + 1
        if nchain
        else np.zeros(0, np.int64)
    )
    e_cnt = nstates_c - 1
    e_tot = int(e_cnt.sum())
    e_chain = np.repeat(np.arange(nchain, dtype=np.int64), e_cnt)
    e_local = (
        np.arange(e_tot, dtype=np.int64)
        - np.repeat(np.cumsum(e_cnt) - e_cnt, e_cnt)
    )  # boundary index i within the chain
    e_src = np.where(e_local == 0, 0, e_local)
    e_tgt = e_local + 1
    a_chain = np.concatenate([a_chain, e_chain])
    a_src = np.concatenate([a_src, e_src])
    a_tgt = np.concatenate([a_tgt, e_tgt])
    a_cost = np.concatenate([a_cost, np.full(e_tot, 100.0)])
    a_vid = np.concatenate([a_vid, np.zeros(e_tot, np.int64)])
    a_seg = np.concatenate([a_seg, np.full(e_tot, -1, np.int64)])
    a_vidx = np.concatenate([a_vidx, np.full(e_tot, -2, np.int64)])
    a_serial = np.arange(len(a_chain), dtype=np.int64)

    if model is not None and model.have_lm and params.lm_weight > 0:
        return _consolidate_lm(
            unit, params, model, make_match, s_chain, nchain, nstates_c,
            chain_blo, chain_end, chain_bhi_arr, narcs,
            a_chain, a_src, a_tgt, a_cost, a_vid, a_seg, a_vidx, a_serial,
        )

    # ---- lockstep Viterbi over all chains ----
    smax = int(nstates_c.max(initial=1))
    v = np.full((nchain, smax), np.inf)
    v[:, 0] = 0.0
    back = np.full((nchain, smax), -1, dtype=np.int64)
    bytgt = np.argsort(a_tgt, kind="stable")
    st_tgt = a_tgt[bytgt]
    starts = np.searchsorted(st_tgt, np.arange(smax + 1))
    st_chain = a_chain[bytgt]
    st_src = a_src[bytgt]
    st_cost = a_cost[bytgt]
    st_serial = a_serial[bytgt]
    for t in range(1, smax):
        lo_, hi_ = int(starts[t]), int(starts[t + 1])
        if lo_ == hi_:
            continue
        ch = st_chain[lo_:hi_]
        src = st_src[lo_:hi_]
        cand = v[ch, src] + st_cost[lo_:hi_]
        # first strict minimum in in_arcs order == min by (cost, src,
        # creation serial), matching VariantModel._best_path
        order = np.lexsort((st_serial[lo_:hi_], src, cand, ch))
        chs = ch[order]
        firsts = np.ones(chs.size, bool)
        firsts[1:] = chs[1:] != chs[:-1]
        sel = order[firsts]
        win = ch[sel]
        v[win, t] = cand[sel]
        back[win, t] = st_serial[lo_:hi_][sel]

    # ---- final states + lockstep backtrack ----
    # finals: boundaries whose begin or end equals the batch end; the object
    # path takes min((cost, state)) over them
    best_state = np.zeros(nchain, np.int64)
    best_cost = np.full(nchain, np.inf)
    for cid in range(nchain):
        ti = unit.chain_text[cid]
        bb = unit.bb[ti]
        be = unit.be[ti]
        bend = int(chain_end[cid])
        blo, bhi = int(chain_blo[cid]), unit.chain_bhi[cid]
        bc, bs = np.inf, -1
        for i in range(blo, bhi):
            if bb[i] == bend or be[i] == bend:
                s = i - blo + 1
                c = v[cid, s]
                if c < bc:
                    bc, bs = c, s
        best_state[cid] = bs
        best_cost[cid] = bc

    dp_chain = (narcs > 0) & (best_state > 0) & np.isfinite(best_cost)
    # collect (round, chain, arc) rows; round 0 is the LAST arc of the path
    rc_chain: List[np.ndarray] = []
    rc_aid: List[np.ndarray] = []
    rc_round: List[np.ndarray] = []
    act = np.nonzero(dp_chain)[0]
    state = best_state[act]
    rnd = 0
    while len(act):
        aid = back[act, state]
        rc_chain.append(act)
        rc_aid.append(aid)
        rc_round.append(np.full(len(act), rnd, np.int64))
        state = a_src[aid]
        keep = state > 0
        act = act[keep]
        state = state[keep]
        rnd += 1
    out_by_chain: List[List[Match]] = [[] for _ in range(nchain)]
    if rc_chain:
        pc = np.concatenate(rc_chain)
        pa = np.concatenate(rc_aid)
        pr = np.concatenate(rc_round)
        keep = a_vidx[pa] != -2  # drop epsilon arcs
        pc, pa, pr = pc[keep], pa[keep], pr[keep]
        # forward order per chain = descending round
        order = np.lexsort((-pr, pc))
        for cid, aid in zip(pc[order].tolist(), pa[order].tolist()):
            vx = int(a_vidx[aid])
            out_by_chain[cid].append(
                make_match(int(a_seg[aid]), vx if vx >= 0 else None)
            )

    # zero-arc chains: the object path returns the raw match list untouched
    # (most_likely_sequence early-out) — reconstruct it, selected unset
    for cid in np.nonzero(~dp_chain)[0].tolist():
        if narcs[cid] > 0:
            continue  # unreachable final (cannot happen: eps chain)
        sl = int(np.searchsorted(s_chain, cid))
        sh = int(np.searchsorted(s_chain, cid + 1))
        out_by_chain[cid] = [make_match(si, None) for si in range(sl, sh)]

    results = []
    for ti, text in enumerate(unit.texts):
        clo, chi = unit.text_chains[ti]
        matches: List[Match] = []
        for cid in range(clo, chi):
            matches.extend(out_by_chain[cid])
        if params.unicodeoffsets:
            matches = remap_offsets_to_unicodepoints(text, matches)
        results.append(matches)
    return results


# test hook: force the numpy LM decoder even when the native one is present
FORCE_NUMPY_LM = False


def _consolidate_lm_native(
    unit: FastUnit, params, model, nchain, nstates_c, chain_blo,
    finals_lists, a_chain, a_src, a_tgt, a_cost, a_vid, a_seg, a_vidx,
    a_serial, nbest, make_match,
):
    """Native n-best + LM decode (ananorm_nbest_lm). Builds the unique-vid /
    unique-boundary token tables on the host (tiny, cached per model), hands
    the whole lattice to C++, and materializes only each chain's selected
    path. Returns out_by_chain (zero-arc chains left empty for _lm_emit), or
    None when the native library is absent."""
    from itertools import chain as _it_chain

    from ..search import TRANSITION_SMOOTHING_LOGPROB
    from ..utils import native as _native
    from ..vocab import BOS, EOS

    if not _native.available():
        return None
    bi_keys, _bc, _uk, _uc, bi_contrib = model._lm_tables()

    n_arcs = len(a_chain)
    eps_base = n_arcs - int((a_vidx == -2).sum())

    # unique-vid token table (into_ngram results, cached on the model —
    # invalidated alongside _lm_tables_cache)
    vt_cache = getattr(model, "_lm_vidtok_cache", None)
    if vt_cache is None:
        vt_cache = model._lm_vidtok_cache = {}
    mvid = a_vid[:eps_base]
    uvid = np.unique(mvid[mvid > 0])
    vid_lists: List[Tuple[int, ...]] = []
    for vid in uvid.tolist():
        toks = vt_cache.get(vid, False)
        if toks is False:
            toks = model.into_ngram(vid, None)
            vt_cache[vid] = toks
        vid_lists.append(() if toks is None else toks)
    arc_vid_idx = np.where(
        mvid > 0, np.searchsorted(uvid, mvid), -1
    ).astype(np.int32)

    # unique-boundary tail table (lib.rs:2605-2626): encoded boundary text
    mchain = a_chain[:eps_base]
    ti_of_chain = np.asarray(unit.chain_text, np.int64)
    gb = chain_blo[mchain] + a_tgt[:eps_base] - 1
    bkey = (ti_of_chain[mchain] << 32) | gb
    ubkey, binv = np.unique(bkey, return_inverse=True)
    arc_b_idx = binv.astype(np.int32)
    encoder_get = model.encoder.get
    into_ngram = model.into_ngram
    tail_lists: List[Tuple[int, ...]] = []
    for key in ubkey.tolist():
        ti = key >> 32
        bgl = key & 0xFFFFFFFF
        bb = unit.bb[ti]
        be = unit.be[ti]
        raw = unit.raw[ti]
        if raw is None:
            btext = unit.texts[ti][bb[bgl] : be[bgl]]
        else:
            btext = raw[bb[bgl] : be[bgl]].decode()
        btext = btext.strip()
        if not btext:
            tail: Tuple[int, ...] = ()
        else:
            bvid = encoder_get(btext)
            if bvid is None:
                tail = (-1,)
            else:
                tk = vt_cache.get(bvid, False)
                if tk is False:
                    tk = into_ngram(bvid, None)
                    vt_cache[bvid] = tk
                tail = tuple(tk) if tk is not None else ()
        tail_lists.append(tail)

    def flat_table(lists):
        lens = np.fromiter((len(g) for g in lists), np.int64, len(lists))
        off = np.zeros(len(lists) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        flat = np.fromiter(
            _it_chain.from_iterable(lists), np.int32, int(off[-1])
        )
        return flat, off

    vid_tok, vid_tok_off = flat_table(vid_lists)
    tail_tok, tail_off = flat_table(tail_lists)

    finals_flat = np.fromiter(
        _it_chain.from_iterable(finals_lists),
        np.int32,
        sum(len(f) for f in finals_lists),
    )
    finals_off = np.zeros(nchain + 1, np.int64)
    np.cumsum(
        np.fromiter((len(f) for f in finals_lists), np.int64, nchain),
        out=finals_off[1:],
    )

    order = np.lexsort((a_serial, a_src, a_tgt, a_chain))
    chain_arc_off = np.searchsorted(
        a_chain[order], np.arange(nchain + 1)
    ).astype(np.int64)

    res = _native.nbest_lm_native(
        (a_chain[order], a_src[order], a_tgt[order], a_cost[order],
         order.astype(np.int64)),
        chain_arc_off, arc_vid_idx, arc_b_idx,
        vid_tok, vid_tok_off, tail_tok, tail_off,
        nstates_c.astype(np.int32), finals_flat, finals_off,
        nbest, eps_base, bi_keys, bi_contrib,
        TRANSITION_SMOOTHING_LOGPROB, BOS, EOS,
        params.lm_weight, params.variantmodel_weight,
        params.contextrules_weight,
    )
    if res is None:
        return None
    out_arcs, out_off = res
    out_by_chain: List[List[Match]] = [[] for _ in range(nchain)]
    a_seg_l = a_seg.tolist()
    a_vidx_l = a_vidx.tolist()
    oa = out_arcs.tolist()
    oo = out_off.tolist()
    for cid in range(nchain):
        lo, hi = oo[cid], oo[cid + 1]
        if hi > lo:
            out_by_chain[cid] = [
                make_match(
                    a_seg_l[arc],
                    a_vidx_l[arc] if a_vidx_l[arc] >= 0 else None,
                )
                for arc in oa[lo:hi]
            ]
    return out_by_chain


def _consolidate_lm(
    unit: FastUnit, params, model, make_match, s_chain, nchain, nstates_c,
    chain_blo, chain_end, chain_bhi_arr, narcs,
    a_chain, a_src, a_tgt, a_cost, a_vid, a_seg, a_vidx, a_serial,
) -> List[List[Match]]:
    """Lockstep n-best + LM decode across ALL chains of a unit.

    Equivalent to the object path's most_likely_sequence with an active LM
    and no context rules (lib.rs:2088-2495): exact n-best paths per chain
    (ties by (cost, source state, arc creation order, source-hyp index) —
    the in_arcs enumeration order of _nbest_paths_arrays), ONE vectorized
    `_lm_score_pairs` call over every hypothesis of every chain, and the
    reference's weighted log-space selection. Logs go through math.log
    (np.log's SIMD path differs by ULPs and would flip near-ties); float
    accumulation orders match the object path op for op, so outputs are
    bit-identical (pinned by tests/test_search.py).
    """
    import math
    import os
    import time

    from ..search import remap_offsets_to_unicodepoints
    from ..vocab import BOS, EOS

    trace = os.environ.get("ANALITICCL_TRACE_LM")
    t_mark = time.process_time()

    def mark(label):
        nonlocal t_mark
        if trace:
            now = time.process_time()
            print(f"    [lm] {label}: {(now - t_mark) * 1e3:.1f} ms")
            t_mark = now

    nbest = max(1, params.max_seq)
    smax = int(nstates_c.max(initial=1))
    n_arcs = len(a_chain)

    # final local states per chain: boundaries whose begin or end equals the
    # chain end (most_likely_sequence's final_states) — shared by both the
    # native and the numpy decoder
    finals_lists: List[List[int]] = []
    for cid in range(nchain):
        ti = unit.chain_text[cid]
        bb = unit.bb[ti]
        be = unit.be[ti]
        bend = int(chain_end[cid])
        blo, bhi = int(chain_blo[cid]), int(chain_bhi_arr[cid])
        fl = [
            i - blo + 1
            for i in range(blo, bhi)
            if bb[i] == bend or be[i] == bend
        ]
        finals_lists.append(fl)

    if not FORCE_NUMPY_LM:
        out_by_chain = _consolidate_lm_native(
            unit, params, model, nchain, nstates_c, chain_blo, finals_lists,
            a_chain, a_src, a_tgt, a_cost, a_vid, a_seg, a_vidx, a_serial,
            nbest, make_match,
        )
        if out_by_chain is not None:
            mark("native decode")
            return _lm_emit(
                unit, params, make_match, s_chain, narcs, out_by_chain
            )

    # ---- lockstep exact n-best DP over states 1..smax-1 ----
    bytgt = np.argsort(a_tgt, kind="stable")
    st_tgt = a_tgt[bytgt]
    starts = np.searchsorted(st_tgt, np.arange(smax + 1))
    st_chain = a_chain[bytgt]
    st_src = a_src[bytgt]
    st_cost = a_cost[bytgt]
    st_serial = a_serial[bytgt]

    # hypotheses live in ONE flat global pool (rows 0..nchain-1 are every
    # chain's empty state-0 hypothesis); per state we keep only the chain
    # column and per-chain offsets. Candidate expansion and backtracking are
    # then single gathers instead of per-source-state masked passes.
    cap = nchain * (1 + (smax - 1) * nbest)
    pool_cost = np.empty(cap)
    pool_prev = np.empty(cap, np.int64)  # global row of the source hyp
    pool_arc = np.empty(cap, np.int64)  # arc taken into this hyp's state
    pool_cost[:nchain] = 0.0
    pool_prev[:nchain] = -1
    pool_arc[:nchain] = -1
    pool_size = nchain
    pool_base = [0]  # per state: first pool row
    empty_i = np.zeros(0, np.int64)
    zero_off = np.zeros(nchain + 1, np.int64)
    h_chain: List[np.ndarray] = [np.arange(nchain, dtype=np.int64)]
    h_off: List[np.ndarray] = [np.arange(nchain + 1, dtype=np.int64)]

    serial_span = np.int64(n_arcs + 1)
    arange_nc1 = np.arange(nchain + 1, dtype=np.int64)
    for t in range(1, smax):
        lo, hi = int(starts[t]), int(starts[t + 1])
        empty = lo == hi
        if not empty:
            ch = st_chain[lo:hi]
            src = st_src[lo:hi]
            cost = st_cost[lo:hi]
            serial = st_serial[lo:hi]
            n_in = hi - lo
            cnt = np.zeros(n_in, np.int64)
            gbase = np.zeros(n_in, np.int64)
            for s in np.unique(src).tolist():
                m = src == s
                offs_s = h_off[s]
                cm = ch[m]
                cnt[m] = offs_s[cm + 1] - offs_s[cm]
                gbase[m] = pool_base[s] + offs_s[cm]
            tot = int(cnt.sum())
            empty = tot == 0
        if empty:
            h_chain.append(empty_i)
            h_off.append(zero_off)
            pool_base.append(pool_size)
            continue
        rep = np.repeat(np.arange(n_in, dtype=np.int64), cnt)
        local = (
            np.arange(tot, dtype=np.int64)
            - np.repeat(np.cumsum(cnt) - cnt, cnt)
        )
        c_gpos = gbase[rep] + local
        c_chain = ch[rep]
        c_cost = pool_cost[c_gpos] + cost[rep]
        # tie key: (src, creation serial); source-hyp index rides on
        # lexsort stability (expansion emits it ascending within an arc)
        c_key = src[rep] * serial_span + serial[rep]
        order = np.lexsort((c_key, c_cost, c_chain))
        och = c_chain[order]
        newg = np.ones(tot, bool)
        newg[1:] = och[1:] != och[:-1]
        gstart = np.flatnonzero(newg)
        glen = np.diff(np.append(gstart, tot))
        rank = np.arange(tot, dtype=np.int64) - np.repeat(gstart, glen)
        sel = order[rank < nbest]
        k = len(sel)
        slot = slice(pool_size, pool_size + k)
        pool_cost[slot] = c_cost[sel]
        pool_prev[slot] = c_gpos[sel]
        pool_arc[slot] = serial[rep[sel]]
        kch = c_chain[sel]
        h_chain.append(kch)
        h_off.append(np.searchsorted(kch, arange_nc1))
        pool_base.append(pool_size)
        pool_size += k

    mark("nbest DP")
    # ---- final-state collection: (cost, state, hidx) order, top nbest ----
    is_final = np.zeros((nchain, smax + 1), bool)
    for cid, fl in enumerate(finals_lists):
        for s in fl:
            if s <= smax:
                is_final[cid, s] = True
    f_chain: List[np.ndarray] = []
    f_cost: List[np.ndarray] = []
    f_state: List[np.ndarray] = []
    f_pos: List[np.ndarray] = []
    f_hidx: List[np.ndarray] = []
    for t in range(1, smax):
        hc = h_chain[t]
        if not len(hc):
            continue
        idx = np.flatnonzero(is_final[hc, t])
        if not len(idx):
            continue
        f_chain.append(hc[idx])
        f_cost.append(pool_cost[pool_base[t] + idx])
        f_state.append(np.full(len(idx), t, np.int64))
        f_pos.append(pool_base[t] + idx)
        f_hidx.append(idx - h_off[t][hc[idx]])

    out_by_chain: List[List[Match]] = [[] for _ in range(nchain)]
    n_hyp = 0
    if f_chain:
        fc = np.concatenate(f_chain)
        fcost = np.concatenate(f_cost)
        fst = np.concatenate(f_state)
        fpos = np.concatenate(f_pos)
        fh = np.concatenate(f_hidx)
        order = np.lexsort((fh, fst, fcost, fc))
        oc = fc[order]
        newg = np.ones(len(oc), bool)
        newg[1:] = oc[1:] != oc[:-1]
        gstart = np.flatnonzero(newg)
        glen = np.diff(np.append(gstart, len(oc)))
        rank = np.arange(len(oc), dtype=np.int64) - np.repeat(gstart, glen)
        sel = order[rank < nbest]
        hyp_chain = fc[sel]
        hyp_cost = fcost[sel]
        hyp_pos = fpos[sel]  # global pool rows
        n_hyp = len(sel)
        hyp_off = np.searchsorted(hyp_chain, arange_nc1)

    mark("finals")
    if n_hyp:
        # ---- lockstep backtrack of EVERY kept hypothesis (pool walks) ----
        cur = hyp_pos.copy()
        act = np.arange(n_hyp)
        r_h: List[np.ndarray] = []
        r_arc: List[np.ndarray] = []
        r_round: List[np.ndarray] = []
        rnd = 0
        while len(act):
            rows = cur[act]
            r_h.append(act.copy())
            r_arc.append(pool_arc[rows])
            r_round.append(np.full(len(act), rnd, np.int64))
            nxt = pool_prev[rows]
            cur[act] = nxt
            act = act[nxt >= nchain]  # rows < nchain are state-0 roots
            rnd += 1
        ph = np.concatenate(r_h)
        pa = np.concatenate(r_arc)
        pr = np.concatenate(r_round)
        real = a_vidx[pa] != -2  # drop epsilon arcs (symbol None)
        ph, pa, pr = ph[real], pa[real], pr[real]
        order = np.lexsort((-pr, ph))  # forward order per hypothesis
        ph = ph[order]
        pa = pa[order]
        sym_counts = np.bincount(ph, minlength=n_hyp)
        sym_bounds = np.zeros(n_hyp + 1, np.int64)
        np.cumsum(sym_counts, out=sym_bounds[1:])

        mark("backtrack")
        # ---- per-arc token groups (lm_score expansion, lib.rs:2580-2628):
        # a symbol's tokens = its vocab entry's ngram decomposition (an OOV
        # copies the input as one unknown token) + the trailing boundary's
        # encoded text — constants per arc, cached per vid / boundary
        uarc = np.unique(pa)
        vid_tok_cache: Dict[int, Optional[Tuple[int, ...]]] = {}
        tail_cache: Dict[Tuple[int, int], Optional[Tuple[int, ...]]] = {}
        groups: List[Tuple[int, ...]] = []
        chain_text_l = unit.chain_text
        encoder_get = model.encoder.get
        into_ngram = model.into_ngram
        a_vid_l = a_vid[uarc].tolist()
        a_chain_l = a_chain[uarc].tolist()
        a_bgl_l = (chain_blo[a_chain[uarc]] + a_tgt[uarc] - 1).tolist()
        for vid, cid, bgl in zip(a_vid_l, a_chain_l, a_bgl_l):
            parts: List[int] = []
            if vid == 0:
                parts.append(-1)  # OOV token (None in the object path)
            else:
                toks = vid_tok_cache.get(vid, False)
                if toks is False:
                    toks = into_ngram(vid, None)
                    vid_tok_cache[vid] = toks
                if toks is not None:
                    parts.extend(toks)
            ti = chain_text_l[cid]
            key = (ti, bgl)
            tail = tail_cache.get(key, False)
            if tail is False:
                bb = unit.bb[ti]
                be = unit.be[ti]
                raw = unit.raw[ti]
                if raw is None:
                    btext = unit.texts[ti][bb[bgl] : be[bgl]]
                else:
                    btext = raw[bb[bgl] : be[bgl]].decode()
                btext = btext.strip()
                if not btext:
                    tail = None
                else:
                    bvid = encoder_get(btext)
                    if bvid is None:
                        tail = (-1,)
                    else:
                        tk = vid_tok_cache.get(bvid, False)
                        if tk is False:
                            tk = into_ngram(bvid, None)
                            vid_tok_cache[bvid] = tk
                        tail = tuple(tk) if tk is not None else None
                tail_cache[key] = tail
            if tail is not None:
                parts.extend(tail)
            groups.append(tuple(parts))
        groups.append((BOS,))
        groups.append((EOS,))
        gid_bos = len(groups) - 2
        gid_eos = len(groups) - 1
        from itertools import chain as _it_chain

        table_len = np.fromiter(
            (len(g) for g in groups), np.int64, len(groups)
        )
        table_lo = np.zeros(len(groups) + 1, np.int64)
        np.cumsum(table_len, out=table_lo[1:])
        table_flat = np.fromiter(
            _it_chain.from_iterable(groups), np.int64, int(table_lo[-1])
        )
        gid_of_pa = np.searchsorted(uarc, pa)

        mark("token groups")
        # ---- per-hypothesis token streams + ONE LM scoring pass ----
        seq_tot = sym_counts + 2
        seq_starts = np.zeros(n_hyp + 1, np.int64)
        np.cumsum(seq_tot, out=seq_starts[1:])
        all_gid = np.full(int(seq_starts[-1]), gid_eos, np.int64)
        all_gid[seq_starts[:-1]] = gid_bos
        if len(pa):
            pos = np.arange(len(pa), dtype=np.int64) + np.repeat(
                seq_starts[:-1] + 1 - sym_bounds[:-1], sym_counts
            )
            all_gid[pos] = gid_of_pa
        seq_of_sym = np.repeat(np.arange(n_hyp, dtype=np.int64), seq_tot)
        gl = table_len[all_gid]
        tot_tok = int(gl.sum())
        offs = (
            np.arange(tot_tok, dtype=np.int64)
            - np.repeat(np.cumsum(gl) - gl, gl)
        )
        tokens_flat = table_flat[np.repeat(table_lo[all_gid], gl) + offs]
        tseq = np.repeat(seq_of_sym, gl)
        m_pair = tseq[1:] == tseq[:-1]
        _, perps = model._lm_score_pairs_arrays(
            tokens_flat[:-1][m_pair],
            tokens_flat[1:][m_pair],
            tseq[1:][m_pair],
            n_hyp,
        )

        mark("lm scoring")
        # ---- weighted log-space selection (lib.rs:2383-2425) ----
        hyp_sizes = np.diff(hyp_off)
        best_perp = np.full(nchain, 999999.0)
        np.minimum.at(best_perp, hyp_chain, perps)
        init_bvc = (nstates_c.astype(np.float64) - 2.0) * 2.0
        bvc = init_bvc.copy()
        np.minimum.at(bvc, hyp_chain, hyp_cost)
        lm_w = params.lm_weight
        vm_w = params.variantmodel_weight
        ctx_w = params.contextrules_weight
        denom = lm_w + vm_w + ctx_w
        lm_ratio = (best_perp[hyp_chain] / perps).tolist()
        cost_l = hyp_cost.tolist()
        bvc_l = bvc[hyp_chain].tolist()
        neg_inf = float("-inf")
        scores = np.empty(n_hyp)
        for i in range(n_hyp):
            norm_lm = math.log(lm_ratio[i])
            cost = cost_l[i]
            if cost <= 0:
                norm_vs = 0.0
            elif bvc_l[i] <= 0:
                norm_vs = neg_inf
            else:
                norm_vs = math.log(bvc_l[i] / cost)
            # ctx term: no rules here, so log(1/1) == 0 — kept in the sum
            # and denominator exactly as the object path computes it
            scores[i] = (lm_w * norm_lm + vm_w * norm_vs + ctx_w * 0.0) / denom
        kidx = (
            np.arange(n_hyp, dtype=np.int64)
            - np.repeat(hyp_off[:-1], hyp_sizes)
        )
        order = np.lexsort((kidx, -scores, hyp_chain))
        och = hyp_chain[order]
        firsts = np.ones(len(order), bool)
        firsts[1:] = och[1:] != och[:-1]
        best_rows = order[firsts]

        mark("selection")
        # ---- emit best-path matches per chain ----
        a_seg_l = a_seg.tolist()
        a_vidx_l = a_vidx.tolist()
        pa_l = pa.tolist()
        for row, cid in zip(best_rows.tolist(), och[firsts].tolist()):
            out: List[Match] = []
            for j in range(int(sym_bounds[row]), int(sym_bounds[row + 1])):
                arc = pa_l[j]
                vx = a_vidx_l[arc]
                out.append(make_match(a_seg_l[arc], vx if vx >= 0 else None))
            out_by_chain[cid] = out

    return _lm_emit(unit, params, make_match, s_chain, narcs, out_by_chain)


def _lm_emit(
    unit: FastUnit, params, make_match, s_chain, narcs, out_by_chain
) -> List[List[Match]]:
    """Shared LM-decode emission: zero-arc chains return the raw match list
    untouched (the len(sym_vid)==1 early-out of most_likely_sequence), then
    matches assemble per text with optional unicode offset remapping."""
    narcs_l = narcs.tolist()
    for cid in range(len(out_by_chain)):
        if narcs_l[cid] > 0:
            continue
        sl = int(np.searchsorted(s_chain, cid))
        sh = int(np.searchsorted(s_chain, cid + 1))
        out_by_chain[cid] = [make_match(si, None) for si in range(sl, sh)]

    results: List[List[Match]] = []
    for ti, text in enumerate(unit.texts):
        clo, chi = unit.text_chains[ti]
        matches: List[Match] = []
        for cid in range(clo, chi):
            matches.extend(out_by_chain[cid])
        if params.unicodeoffsets:
            matches = remap_offsets_to_unicodepoints(text, matches)
        results.append(matches)
    return results
