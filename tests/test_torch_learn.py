"""Learn mode of the port on the CPU: ``learn_variants`` strict and
non-strict against the JAX package's device backend, and the variant flags
of the port's pipeline after learn's in-place frequency refresh."""

import numpy as np
import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
    VariantReferenceKind,
    VocabType,
)
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
)
from test_torch_slice import ref_populate, to_ref

torch.set_num_threads(2)

PARAMS = SearchParameters(
    max_anagram_distance=DistanceThreshold.absolute(3),
    max_edit_distance=DistanceThreshold.absolute(2),
    max_matches=10,
    score_threshold=0.25,
    max_ngram=2,
)


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=17, n=2000)


def snapshot(model):
    """Every decoder entry: text, frequency, type and variant links, as
    plain values (the two packages' link kinds are distinct enums)."""
    return [
        (
            v.text, v.frequency, int(v.vocabtype),
            None
            if v.variants is None
            else [(r.kind.name, r.vocab_id, r.score) for r in v.variants],
        )
        for v in model.decoder
    ]


def _tuples(model, results):
    return [
        [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
         for r in res]
        for res in results
    ]


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "search"])
def test_learn_matches_jax(words, strict):
    freqs = synthetic_frequencies(4, len(words))
    if strict:  # lexicon words among the inputs gain VARIANT_OF links
        corpus = corrupt_queries(words, 21, 192) + words[:64:2] + words[:8]
    else:
        corpus = synthetic_text(words, 22, 24)
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.set_backend("device")
    n_port = port.learn_variants(corpus, PARAMS, strict=strict)
    n_ref = ref.learn_variants(corpus, to_ref(PARAMS), strict=strict)
    assert n_port == n_ref > len(corpus) // 4
    assert snapshot(port) == snapshot(ref)
    assert (
        port.learn_profile["build_mode"]
        == ref.learn_profile["build_mode"]
        == "freq_refresh"
    )
    pipe = port._device
    assert isinstance(pipe, DevicePipeline)
    assert pipe.stats.counts["device"] > 0
    assert len(port.decoder) > len(words) + 3
    flags = np.array([port.decoder[v].variants is not None
                      for v in port.index.vocab_ids])
    assert flags.any() and np.array_equal(pipe._has_variants, flags)


@pytest.mark.parametrize("how", ["learn", "links"])
def test_variant_flags_follow_links_after_freq_refresh(words, how):
    """Indexed entries gain VARIANT_OF links and the index frequencies are
    refreshed in place (``_refresh_index_freqs``). The port's results must
    then equal the host oracle's and a fresh build's. Here the port follows
    the reference's ``expand_variants`` (lib.rs:1677-1727), which expands
    every candidate that has links, and departs from the JAX device path,
    whose variant flags stay as its pipeline was built."""
    freqs = synthetic_frequencies(6, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    probe = words[:400:5]
    port.find_variants_batch(probe, PARAMS)  # the pipeline, before any link
    pipe = port._device
    if how == "learn":
        port.learn_variants(probe, PARAMS, strict=True)
        assert port.learn_profile["build_mode"] == "freq_refresh"
    else:
        for k in range(0, 200, 4):
            port.add_variant_by_id(
                port.encoder[words[k + 1]], port.encoder[words[k]], 0.75
            )
            port.decoder[port.encoder[words[k]]].frequency += 3
        port._refresh_index_freqs()
    assert port._device is pipe  # refreshed in place, not rebuilt
    # learn updates only the rows it linked; that equals a full recompute
    flags = np.array([port.decoder[v].variants is not None
                      for v in port.index.vocab_ids])
    assert np.array_equal(pipe._has_variants, flags)
    linked = [
        vid for vid in port.index.vocab_ids.tolist()
        if port.decoder[vid].variants
        and any(r.kind is VariantReferenceKind.VARIANT_OF
                for r in port.decoder[vid].variants)
    ]
    assert len(linked) >= 16
    texts = [port.decoder[v].text for v in linked]
    queries = texts + corrupt_queries(texts, 8, 64)
    got = _tuples(port, port.find_variants_batch(queries, PARAMS))
    oracle = _tuples(
        port, [port._find_variants_oracle(q, PARAMS) for q in queries]
    )
    assert got == oracle
    assert sum(r[3] is not None for res in got for r in res) >= len(texts)
    port.build()
    assert port._device is None
    assert _tuples(port, port.find_variants_batch(queries, PARAMS)) == got
    assert np.array_equal(port._device._has_variants, flags)
    assert port.decoder[linked[0]].vocabtype & VocabType.INDEXED
