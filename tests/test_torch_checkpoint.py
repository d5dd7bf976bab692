"""Checkpoints cross between the packages: the port's ``save``/``load`` keep
the JAX package's on-disk format. A model saved by either package loads into
the other and answers queries and searches with the same result tuples, and
a port model saved after learning keeps its variant links and frequencies."""

import numpy as np
import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
)
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_bigrams,
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
    lm_weight=1.0,
)


@pytest.fixture(scope="module")
def corpus():
    words = synthetic_lexicon(seed=31, n=3000)
    freqs = synthetic_frequencies(32, len(words))
    bigrams = synthetic_bigrams(words, 33, 300)
    texts = synthetic_text(words, 34, 12, bigrams)
    queries = corrupt_queries(words, 35, 160) + words[:16]
    return words, freqs, bigrams, texts, queries


def query_tuples(model, results):
    return [
        [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
         for r in res]
        for res in results
    ]


def search_tuples(model, outs):
    return [
        [
            (m.text, m.offset.begin, m.offset.end, m.selected, m.n,
             None if m.variants is None else [
                 (model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
                  r.via)
                 for r in m.variants
             ])
            for m in out
        ]
        for out in outs
    ]


def decoder_tuples(model):
    """Every entry as plain values: text, frequency, type bits and links
    (the link kind by name: the packages' enums are distinct classes)."""
    return [
        (v.text, v.frequency, v.tokencount, v.lexindex, int(v.vocabtype),
         None if v.variants is None else [
             (r.kind.name, r.vocab_id, r.score) for r in v.variants
         ])
        for v in model.decoder
    ]


def test_reference_checkpoint_loads_into_the_port(tmp_path, corpus):
    words, freqs, bigrams, texts, queries = corpus
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs, bigrams)
    ref.set_backend("device")
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    port = VariantModel.load(path, device="cpu")
    assert isinstance(port, VariantModel) and port.device.type == "cpu"
    assert decoder_tuples(port) == decoder_tuples(ref)
    assert port.have_lm and port.ngrams == ref.ngrams
    got = query_tuples(port, port.find_variants_batch(queries, PARAMS))
    want = query_tuples(ref, ref.find_variants_batch(queries, to_ref(PARAMS)))
    assert got == want and sum(map(len, got)) > len(queries)
    assert isinstance(port._device, DevicePipeline)
    got = search_tuples(port, port.find_all_matches_batch(texts, PARAMS))
    want = search_tuples(ref, ref.find_all_matches_batch(texts, to_ref(PARAMS)))
    assert got == want


def test_port_checkpoint_loads_into_the_reference(tmp_path, corpus):
    words, freqs, bigrams, texts, queries = corpus
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                    freqs, bigrams)
    path = str(tmp_path / "port.npz")
    port.save(path)
    ref = JaxModel.load(path, backend="device")
    assert decoder_tuples(ref) == decoder_tuples(port)
    np.testing.assert_array_equal(ref.index.vocab_ids, port.index.vocab_ids)
    got = query_tuples(port, port.find_variants_batch(queries, PARAMS))
    want = query_tuples(ref, ref.find_variants_batch(queries, to_ref(PARAMS)))
    assert got == want
    got = search_tuples(port, port.find_all_matches_batch(texts, PARAMS))
    want = search_tuples(ref, ref.find_all_matches_batch(texts, to_ref(PARAMS)))
    assert got == want


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "search"])
def test_learned_port_model_round_trips(tmp_path, corpus, strict):
    words, freqs, _, texts, queries = corpus
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    learn_on = corrupt_queries(words, 36, 200) + words[:40:2] if strict else texts
    assert port.learn_variants(learn_on, PARAMS, strict=strict) > 0
    assert port.learn_profile["build_mode"] == "freq_refresh"
    n_links = sum(bool(v.variants) for v in port.decoder)
    assert n_links > 10
    path = str(tmp_path / "learned.npz")
    port.save(path)
    back = VariantModel.load(path, device="cpu")
    assert decoder_tuples(back) == decoder_tuples(port)
    np.testing.assert_array_equal(back.index.freqs, port.index.freqs)
    probe = learn_on[:60] if strict else queries
    got = query_tuples(back, back.find_variants_batch(probe, PARAMS))
    want = query_tuples(port, port.find_variants_batch(probe, PARAMS))
    assert got == want
    if strict:  # results through variant links survive the round trip
        assert any(r[3] is not None for res in got for r in res)
