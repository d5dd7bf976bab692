"""Model checkpointing: serialize a built VariantModel to a single .npz.

The port's copy of ``analiticcl_tpu/checkpoint.py``.

The reference has no checkpoint story — models are rebuilt from text resources
on every run, and learn mode's emitted variant list is the only persisted
artifact (SURVEY.md §5). Here the whole model state — vocabulary, variant
links, n-gram LM, confusables, context rules, and the built index arrays —
round-trips through one compressed npz, so a million-entry model loads in a
fraction of the build time and learn-mode progress survives restarts.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from .confusables import Confusable
from .search import ContextRule, PatternMatch
from .types import (
    VariantReference,
    VariantReferenceKind,
    Weights,
)
from .vocab import VocabType, VocabValue

FORMAT_VERSION = 1


def _pattern_to_json(pm: PatternMatch):
    if pm.kind == PatternMatch.NOT:
        return {"kind": pm.kind, "value": _pattern_to_json(pm.value)}
    if pm.kind == PatternMatch.DISJUNCTION:
        return {"kind": pm.kind, "value": [_pattern_to_json(p) for p in pm.value]}
    return {"kind": pm.kind, "value": pm.value}


def _pattern_from_json(d) -> PatternMatch:
    if d["kind"] == PatternMatch.NOT:
        return PatternMatch(d["kind"], _pattern_from_json(d["value"]))
    if d["kind"] == PatternMatch.DISJUNCTION:
        return PatternMatch(d["kind"], [_pattern_from_json(p) for p in d["value"]])
    return PatternMatch(d["kind"], d["value"])


def save_model(model, path: str) -> None:
    """Serialize a (built or unbuilt) model to ``path`` (.npz)."""
    n = len(model.decoder)
    texts = [v.text for v in model.decoder]
    freqs = np.asarray([v.frequency for v in model.decoder], dtype=np.int64)
    tokencounts = np.asarray([v.tokencount for v in model.decoder], dtype=np.int32)
    lexindex = np.asarray([v.lexindex for v in model.decoder], dtype=np.int64)
    vocabtype = np.asarray(
        [int(v.vocabtype) for v in model.decoder], dtype=np.int32
    )
    # variant links as a flat (owner, kind, target, score) table
    link_owner: List[int] = []
    link_kind: List[int] = []
    link_target: List[int] = []
    link_score: List[float] = []
    for vid, v in enumerate(model.decoder):
        if v.variants:
            for ref in v.variants:
                link_owner.append(vid)
                link_kind.append(
                    0 if ref.kind is VariantReferenceKind.REFERENCE_FOR else 1
                )
                link_target.append(ref.vocab_id)
                link_score.append(ref.score)

    ngram_keys = list(model.ngrams.keys())
    ngram_lens = np.asarray([len(k) for k in ngram_keys], dtype=np.int32)
    ngram_flat = np.asarray(
        [t for k in ngram_keys for t in k], dtype=np.int64
    )
    ngram_counts = np.asarray(
        [model.ngrams[k] for k in ngram_keys], dtype=np.int64
    )

    meta = {
        "format_version": FORMAT_VERSION,
        "alphabet": model.alphabet,
        "weights": model.weights.__dict__,
        "lexicons": model.lexicons,
        "tags": model.tags,
        "have_freq": model.have_freq,
        "have_lm": model.have_lm,
        "freq_sum": model.freq_sum,
        "confusables_before_pruning": model.confusables_before_pruning,
        "confusables": [
            {
                "pattern": _confusable_pattern(c),
                "weight": c.weight,
            }
            for c in model.confusables
        ],
        "context_rules": [
            {
                "pattern": [_pattern_to_json(pm) for pm in rule.pattern],
                "score": rule.score,
                "tag": rule.tag,
                "tagoffset": rule.tagoffset,
            }
            for rule in model.context_rules
        ],
        "texts": texts,
    }

    arrays = {
        "freqs": freqs,
        "tokencounts": tokencounts,
        "lexindex": lexindex,
        "vocabtype": vocabtype,
        "link_owner": np.asarray(link_owner, dtype=np.int64),
        "link_kind": np.asarray(link_kind, dtype=np.int8),
        "link_target": np.asarray(link_target, dtype=np.int64),
        "link_score": np.asarray(link_score, dtype=np.float64),
        "ngram_lens": ngram_lens,
        "ngram_flat": ngram_flat,
        "ngram_counts": ngram_counts,
        "meta_json": np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ),
    }
    index = model.index
    if index is not None:
        arrays.update(
            idx_vocab_ids=index.vocab_ids,
            idx_counts=index.counts,
            idx_norms=index.norms,
            idx_norm_lens=index.norm_lens,
            idx_freqs=index.freqs,
            idx_first_lower=index.first_lower,
            idx_group_starts=np.asarray(
                [s for s, _ in index.group_ranges], dtype=np.int64
            ),
            idx_group_ends=np.asarray(
                [e for _, e in index.group_ranges], dtype=np.int64
            ),
        )
    np.savez_compressed(path, **arrays)


def _confusable_pattern(c: Confusable) -> str:
    from .editscript import script_to_str

    core = script_to_str(c.editscript)
    return ("^" if c.strictbegin else "") + core + ("$" if c.strictend else "")


def load_model(path: str, backend: str = "auto", device="cuda"):
    """Load a model saved by :func:`save_model` (of either package), its
    device path on ``device``."""
    from .models.variant_model import BuiltIndex, VariantModel

    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta_json"].tobytes()).decode("utf-8"))
    assert meta["format_version"] == FORMAT_VERSION

    model = VariantModel(
        alphabet=meta["alphabet"],
        weights=Weights(**meta["weights"]),
        device=device,
    )
    model.set_backend(backend)
    model.lexicons = list(meta["lexicons"])
    model.tags = list(meta["tags"])
    model.have_freq = bool(meta["have_freq"])
    model.have_lm = bool(meta["have_lm"])
    model.freq_sum = list(meta["freq_sum"])
    model.confusables_before_pruning = bool(meta["confusables_before_pruning"])
    for c in meta["confusables"]:
        model.add_to_confusables(c["pattern"], c["weight"])
    for r in meta["context_rules"]:
        model.context_rules.append(
            ContextRule(
                pattern=[_pattern_from_json(p) for p in r["pattern"]],
                score=r["score"],
                tag=list(r["tag"]),
                tagoffset=[tuple(t) for t in r["tagoffset"]],
            )
        )

    texts = meta["texts"]
    freqs = data["freqs"]
    tokencounts = data["tokencounts"]
    lexindex = data["lexindex"]
    vocabtype = data["vocabtype"]
    model.decoder = []
    model.encoder = {}
    for vid, text in enumerate(texts):
        model.decoder.append(
            VocabValue(
                text=text,
                norm=None,  # lazily recomputed by oracle paths if needed
                frequency=int(freqs[vid]),
                tokencount=int(tokencounts[vid]),
                lexindex=int(lexindex[vid]),
                variants=None,
                vocabtype=VocabType(int(vocabtype[vid])),
            )
        )
        model.encoder.setdefault(text, vid)
    for owner, kind, target, score in zip(
        data["link_owner"], data["link_kind"], data["link_target"], data["link_score"]
    ):
        v = model.decoder[int(owner)]
        ref = VariantReference(
            VariantReferenceKind.REFERENCE_FOR
            if int(kind) == 0
            else VariantReferenceKind.VARIANT_OF,
            int(target),
            float(score),
        )
        if v.variants is None:
            v.variants = [ref]
        else:
            v.variants.append(ref)

    model.ngrams = {}
    pos = 0
    flat = data["ngram_flat"]
    for length, count in zip(data["ngram_lens"], data["ngram_counts"]):
        key = tuple(int(x) for x in flat[pos : pos + int(length)])
        model.ngrams[key] = int(count)
        pos += int(length)

    if "idx_vocab_ids" in data:
        counts = data["idx_counts"]
        model.index = BuiltIndex(
            vocab_ids=data["idx_vocab_ids"],
            counts=counts,
            charcounts=counts.sum(axis=1, dtype=np.int32),
            norms=data["idx_norms"],
            norm_lens=data["idx_norm_lens"],
            freqs=data["idx_freqs"],
            first_lower=data["idx_first_lower"],
            max_norm_len=int(data["idx_norms"].shape[1]),
            group_lookup=None,
            group_anavalues=None,
            group_ranges=list(
                zip(
                    data["idx_group_starts"].tolist(),
                    data["idx_group_ends"].tolist(),
                )
            ),
        )
    return model
