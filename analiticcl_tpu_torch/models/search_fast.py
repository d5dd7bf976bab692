"""The port's array-native search consolidation.

``consolidate_unit`` and ``_found_arrays`` are the JAX package's
(``analiticcl_tpu/models/search_fast.py``) with the port's
:class:`~..ops.ranked.RankedResults` in place of the JAX pipeline's, which
they imported at call time. Everything else of that module (segmentation,
``FastUnit``, the LM n-best decode and its ``FORCE_NUMPY_LM`` test hook)
imports no JAX and is used from there: set
``analiticcl_tpu.models.search_fast.FORCE_NUMPY_LM`` to force the numpy LM
decoder here too.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from analiticcl_tpu.models.search_fast import (  # noqa: F401 (re-exported)
    FastUnit,
    _consolidate_lm,
    prepare_unit,
)
from analiticcl_tpu.search import Match, Offset, remap_offsets_to_unicodepoints
from analiticcl_tpu.types import VariantResult
from analiticcl_tpu.utils.native import fastemit_build_result_lists

from ..ops.ranked import RankedResults


def _found_arrays(found, nq: int, fw: float):
    """(score, ds, vid, k_of_q, lo_of_q) flat survivor columns from a
    RankedResults batch, or from plain per-query lists (fallback envs)."""
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
    if isinstance(found, RankedResults):
        row_l = found.row_of.tolist()
        f_over = found.overrides
        nrows_f = len(found.sbounds) - 1
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
            m.variants = variants_of(q)
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
