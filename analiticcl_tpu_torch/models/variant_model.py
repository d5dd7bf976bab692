"""The port's VariantModel: the JAX package's model with its device path on
PyTorch.

Everything above the device call (vocabulary, index build, the host oracle,
the ranking helpers, segmentation, the lattice decode and LM scoring) is
inherited from ``analiticcl_tpu.models.variant_model``, which imports no JAX.
The methods of that model that reach for the JAX pipeline module are
overridden here: ``find_variants_batch`` (query mode), ``find_all_matches_stream``
and ``_fam_fast_ok`` (search mode; ``find_all_matches`` and
``find_all_matches_batch`` delegate to them), and ``learn_variants`` (its
strict mode reads the ranked lookup stream). ``find_variants_stream`` finds
its pipeline already set, and ``_refresh_index_freqs`` hands learn's linked
entries to the port's ``DevicePipeline.refresh_freqs``. ``use_mesh`` is not
ported.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

from analiticcl_tpu.models.variant_model import VariantModel as _HostModel
from analiticcl_tpu.types import (
    SearchParameters,
    VariantReference,
    VariantReferenceKind,
    VariantResult,
)
from analiticcl_tpu.vocab import FrequencyHandling, VocabParams, VocabType

from ..device import resolve_device
from ..ops.pipeline import DevicePipeline
from ..ops.ranked import RankedResults
from . import search_fast

# Lookups per device call in search mode. A search unit aims at 95 % of this
# many unique segments, but that is an estimate from its token count and a
# unit can reach the card with many more. Stage A's pair compaction unpacks
# B x band-rows hit bits and runs ``nonzero`` over them: at 16,384 lookups
# and the full 120,832-row band of a 120k lexicon that is about 2G elements,
# near INT_MAX and about 2 GB per call. So a unit goes to the card in parts of
# at most this many lookups; ``RankedResults.concat`` joins the parts, and the
# results do not change.
SEARCH_BATCH = 8192
# Lookups per device call in strict learn mode (the JAX package's size).
LEARN_BATCH = 4096


class VariantModel(_HostModel):
    """Variant model whose device path runs on ``device`` ("cuda" or "cpu")."""

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    def use_mesh(self, mesh=None, dp: Optional[int] = None) -> None:
        raise NotImplementedError(
            "sharding the index over several devices is not ported to "
            "PyTorch yet (ROADMAP P10)"
        )

    def _use_device(self) -> bool:
        """The parent's ``auto`` rule: the device path from 64 index
        entries up, the host oracle below."""
        if self._backend == "auto":
            return self.index.size >= 64
        return self._backend == "device"

    def _pipeline(self) -> DevicePipeline:
        if self._device is None:
            self._device = DevicePipeline(self, self.device)
        return self._device

    def find_variants_batch(
        self, inputs: Sequence[str], params: SearchParameters
    ) -> List[List[VariantResult]]:
        if self.index is None:
            print(
                "ERROR: Model has not been built yet! Call build() before "
                "find_variants()",
                file=sys.stderr,
            )
            return [[] for _ in inputs]
        if self._use_device():
            return self._pipeline().find_variants_batch(inputs, params)
        return [self._find_variants_oracle(text, params) for text in inputs]

    def find_variants_stream(
        self, inputs: Sequence[str], params: SearchParameters,
        batch_size: int = 4096,
    ):
        if self.index is not None and self._use_device():
            self._pipeline()
        return super().find_variants_stream(inputs, params, batch_size)

    def _refresh_index_freqs(self, bumped=None, linked=None) -> None:
        """The parent's in-place refresh of the host frequency column, then
        the device pipeline's. With ``linked`` (the vids whose variant lists
        may have changed) the pipeline updates only their variant flags."""
        pipe, self._device = self._device, None
        try:
            super()._refresh_index_freqs(bumped)
        finally:
            self._device = pipe
        if pipe is not None and self.index is not None:
            pipe.refresh_freqs(self.index.freqs, linked)

    # ------------------------------------------------------------------
    # Search mode
    # ------------------------------------------------------------------

    def find_all_matches_stream(
        self, texts, params: SearchParameters, depth: int = 2
    ):
        """Pipelined :meth:`find_all_matches` over an iterable of texts.

        Texts are aggregated until their estimated unique-segment count
        fills a large lookup batch; up to ``depth`` such units stay
        submitted while earlier ones are consolidated (lattice decode and LM
        scoring). Yields one ``List[Match]`` per text, in order."""
        if self.index is None or not self._use_device():
            for text in texts:
                yield self.find_all_matches(text, params)
            return
        pipe = self._pipeline()
        # The token-based estimate of unique segments per token only steers
        # aggregation, never the results; it calibrates itself from each
        # prepared unit's dedup ratio.
        target = int(SEARCH_BATCH * 0.95)
        est_factor = {1: 1.0, 2: 1.6}.get(min(params.max_ngram, 3), 2.4)
        pending = []  # submitted units
        buf: List[str] = []  # texts accumulated for the next unit
        buf_tokens = 0

        # the array-native unit pipeline covers the argmin decode and the
        # LM-rescored n-best decode; context rules (tags) and debug lattice
        # dumps take the object path
        fast_applicable = (
            getattr(self, "fast_consolidate", True)
            and self.debug < 3
            and not self.context_rules
        )
        consolidate = (
            params.max_ngram > 1 or self.have_lm or bool(self.context_rules)
        )

        def submit_lookups(all_texts):
            sts = []
            for s in range(0, len(all_texts), SEARCH_BATCH):
                st = pipe.submit(all_texts[s : s + SEARCH_BATCH], params)
                st["want_ranked"] = True
                sts.append(st)
            return sts

        def submit_unit(unit_texts, unit_tokens):
            nonlocal est_factor
            if fast_applicable:
                with pipe.stats.stage("search_prepare"):
                    unit = search_fast.prepare_unit(
                        unit_texts, params.max_ngram
                    )
                if unit is not None:
                    all_texts = unit.all_texts
                    if unit_tokens:
                        est_factor = 0.5 * est_factor + 0.5 * (
                            len(all_texts) / unit_tokens
                        )
                    return ("arr", unit, None, submit_lookups(all_texts))
            with pipe.stats.stage("search_prepare"):
                preps, uniq, all_texts = self._fam_prepare(unit_texts, params)
            if unit_tokens:
                est_factor = 0.5 * est_factor + 0.5 * (
                    len(all_texts) / unit_tokens
                )
            return ("obj", preps, uniq, submit_lookups(all_texts))

        def flush_one():
            kind, preps, uniq, sts = pending.pop(0)
            parts = [pipe.collect(st) for st in sts]
            if all(isinstance(p, RankedResults) for p in parts):
                found = RankedResults.concat(parts) if parts else []
            else:
                # a part fell off the ranked path (early confusables, no
                # native tail): merge as eager per-query lists
                found = []
                for p in parts:
                    found.extend(list(p))
            if kind == "arr":
                with pipe.stats.stage("search_consolidate"):
                    return search_fast.consolidate_unit(
                        preps, found, params, consolidate, self
                    )
            with pipe.stats.stage("search_consolidate_obj"):
                return self._fam_consolidate(preps, uniq, found, params)

        for text in texts:
            ntok = len(text.split())
            if buf and (buf_tokens + ntok) * est_factor > target:
                pending.append(submit_unit(buf, buf_tokens))
                buf, buf_tokens = [], 0
                if len(pending) > depth:
                    yield from flush_one()
            buf.append(text)
            buf_tokens += ntok
        if buf:
            pending.append(submit_unit(buf, buf_tokens))
        while pending:
            yield from flush_one()

    def _fam_fast_ok(self, found, params: SearchParameters) -> bool:
        """Whether the parent's array-native argmin consolidation applies:
        results arrived as a RankedResults batch and the decode is pure
        argmin path cost (no LM in play, no context rules, no lattice
        dump). ``fast_consolidate = False`` forces the object path."""
        if not getattr(self, "fast_consolidate", True) or self.debug >= 3:
            return False
        if not isinstance(found, RankedResults):
            return False
        if self.context_rules:  # tags are computed even at weight 0
            return False
        return not (self.have_lm and params.lm_weight > 0)

    # ------------------------------------------------------------------
    # Learn mode (reference lib.rs:1029-1139)
    # ------------------------------------------------------------------

    def learn_variants(
        self,
        inputs: Sequence[str],
        params: SearchParameters,
        strict: bool = False,
        auto_build: bool = True,
    ) -> int:
        """Bootstrap weighted variants from a corpus (lib.rs:1062-1139).

        Batched lookup replaces the reference's rayon parallelism; the merge
        phase is sequential, as in the reference, with the JAX package's
        semantics: first mention wins, and the VariantOf-side dedup quirk
        (lib.rs:497-508) stays."""
        vocabparams = VocabParams().with_vocab_type(
            VocabType.TRANSPARENT
        ).with_freq_handling(FrequencyHandling.MAX)

        def triples():
            """(input, ref vocab id, dist score) stream; strict mode on the
            device reads survivor arrays directly (no VariantResult
            objects)."""
            inputs_list = list(inputs)
            if not strict:
                # one combined lookup batch across the corpus slice
                for matches in self.find_all_matches_batch(
                    inputs_list, params
                ):
                    for m in matches:
                        solution = m.solution()
                        if solution is not None:
                            yield m.text, solution.vocab_id, solution.dist_score
                return
            if self.index is None or not self._use_device():
                for inputstr in inputs_list:
                    for r in self.find_variants(inputstr, params):
                        yield inputstr, r.vocab_id, r.dist_score
                return
            batches = [
                inputs_list[s : s + LEARN_BATCH]
                for s in range(0, len(inputs_list), LEARN_BATCH)
            ]
            stream = self._pipeline().find_variants_stream(
                batches, params, ranked=True
            )
            for batch, rr in zip(batches, stream):
                if isinstance(rr, RankedResults):
                    vidl = rr.vid.tolist()
                    dsl = rr.ds.tolist()
                    sbl = rr.sbounds.tolist()
                    rowl = rr.row_of.tolist()
                    ov = rr.overrides
                    for i, inputstr in enumerate(batch):
                        o = ov.get(i)
                        if o is not None:
                            for r in o:
                                yield inputstr, r.vocab_id, r.dist_score
                            continue
                        row = rowl[i]
                        if row < 0:
                            continue
                        for k in range(sbl[row], sbl[row + 1]):
                            yield inputstr, vidl[k], dsl[k]
                else:  # eager lists (late confusables, no native tail)
                    for inputstr, res in zip(batch, rr):
                        for r in res:
                            yield inputstr, r.vocab_id, r.dist_score

        # Merge phase: the reference's serial merge (lib.rs:1098-1126) with
        # link dedup against per-entry sets built once per touched entry.
        count = 0
        prev: Optional[str] = None
        encoder_get = self.encoder.get
        decoder = self.decoder
        ref_for: Dict[int, set] = {}  # ref_id -> {variant ids linked}
        var_of: Dict[int, set] = {}  # variant id -> {ids in VARIANT_OF checks}
        REF_FOR = VariantReferenceKind.REFERENCE_FOR
        VAR_OF = VariantReferenceKind.VARIANT_OF
        t_lookup = 0.0
        t_merge_start = time.perf_counter()

        def timed_triples():
            nonlocal t_lookup
            gen = triples()
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    t_lookup += time.perf_counter() - t0
                    return
                t_lookup += time.perf_counter() - t0
                yield item

        # A learn iteration can only append TRANSPARENT entries (no INDEXED
        # or LM bit) and bump frequencies. Unless a bumped entry is LM-typed
        # or an index-relevant change happened, build() would reproduce the
        # same index with only the freqs column changed, so auto_build
        # refreshes that column in place.
        lm_flag = int(VocabType.LM)
        indexed_flag = int(VocabType.INDEXED)
        structural = self.index is None
        bumped: set = set()  # vids whose frequency changed
        n_decoder_before = len(decoder)

        for inputstr, ref_id, dist_score in timed_triples():
            vocab_id = encoder_get(inputstr)
            if vocab_id is not None:
                if prev != inputstr:
                    decoder[vocab_id].frequency += 1
                    bumped.add(vocab_id)
                    if decoder[vocab_id].vocabtype.value & lm_flag:
                        structural = True
            else:
                vocab_id = self.add_to_vocabulary(inputstr, 1, vocabparams)
                if vocab_id < n_decoder_before:
                    bumped.add(vocab_id)  # reused an existing entry
                if vocab_id < len(decoder) and (
                    decoder[vocab_id].vocabtype.value & (indexed_flag | lm_flag)
                ):
                    structural = True
            if ref_id != vocab_id:
                refitem = decoder[ref_id] if ref_id < len(decoder) else None
                if refitem is not None:
                    seen = ref_for.get(ref_id)
                    if seen is None:
                        seen = {
                            v.vocab_id
                            for v in (refitem.variants or [])
                            if v.kind is REF_FOR
                        }
                        ref_for[ref_id] = seen
                    if vocab_id not in seen:
                        ref = VariantReference(REF_FOR, vocab_id, dist_score)
                        if refitem.variants is None:
                            refitem.variants = [ref]
                        else:
                            refitem.variants.append(ref)
                        seen.add(vocab_id)
                varitem = decoder[vocab_id] if vocab_id < len(decoder) else None
                if varitem is not None:
                    seen = var_of.get(vocab_id)
                    if seen is None:
                        seen = {
                            v.vocab_id
                            for v in (varitem.variants or [])
                            if v.kind is VAR_OF
                        }
                        var_of[vocab_id] = seen
                    # reference quirk: the VariantOf-side dedup compares
                    # against the VARIANT id, not the reference id
                    # (lib.rs:497-508)
                    if vocab_id not in seen:
                        ref = VariantReference(VAR_OF, ref_id, dist_score)
                        if varitem.variants is None:
                            varitem.variants = [ref]
                        else:
                            varitem.variants.append(ref)
                        seen.add(ref_id)
                count += 1
            prev = inputstr
        t_merge = time.perf_counter() - t_merge_start - t_lookup
        t_build = 0.0
        build_mode = "none"
        if auto_build:
            t0 = time.perf_counter()
            if structural:
                self.build()
                build_mode = "full"
            else:
                if bumped:
                    # every entry whose variant list the merge may have
                    # touched is a key of ref_for or var_of
                    self._refresh_index_freqs(
                        bumped, linked=ref_for.keys() | var_of.keys()
                    )
                build_mode = "freq_refresh" if bumped else "noop"
            t_build = time.perf_counter() - t0
        self.learn_profile = {
            "lookup_s": round(t_lookup, 3),
            "merge_s": round(t_merge, 3),
            "build_s": round(t_build, 3),
            "build_mode": build_mode,
        }
        return count
