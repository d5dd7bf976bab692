"""A lexicon with entries over 64 characters (ROADMAP F10) end to end on
the CPU: the port's device path (its plain versions; the card runs K2's
byte path for pairs up to 64 and its wide path for longer ones) against
the JAX package's device path and both packages' host oracles, in query,
search (``max_ngram`` 2) and strict learn mode.

The lexicon is 2,000 seeded entries plus seeded entries of 70, 100 and 300
letters, so L is 300 and the metrics travel as int32 (from L 256, as in the
JAX pipeline). One fault sits on the reference side (F11): the JAX
package's native ranking tail reads those int32 metrics as bytes, so a
survivor whose LCS, prefix or suffix passes 255 gets a wrapped score there.
The port sends int32 metrics to its numpy tail instead. Every result is
held against the oracle (learn: its lookups after); against the JAX
package's device path, every result except those that meet F11, and
those are asserted to exist and to be the ones with a metric over 255.
"""

import dataclasses

import numpy as np
import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
)
from analiticcl_tpu_torch.ops.distance import longest_common_substring_length
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
)
from test_torch_learn import snapshot
from test_torch_search import signature
from test_torch_slice import ref_populate, to_ref

torch.set_num_threads(2)

LONG_LENGTHS = (70, 100, 300)
PARAMS = SearchParameters(
    max_anagram_distance=DistanceThreshold.absolute(3),
    max_edit_distance=DistanceThreshold.absolute(2),
    max_matches=10,
    score_threshold=0.25,
    max_ngram=2,
)


@pytest.fixture(scope="module")
def lexicon():
    words = synthetic_lexicon(seed=0, n=2000)
    rng = np.random.default_rng(5)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    longs = ["".join(rng.choice(letters, n)) for n in LONG_LENGTHS]
    return words + longs, longs


def _models(words, freqs=None):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                    freqs)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.set_backend("device")
    return port, ref


def _tuples(model, results):
    return [[(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
              r.via) for r in res] for res in results]


def _over_255(query: str, texts) -> bool:
    """Whether a pair of ``query`` and one of ``texts`` has an LCS, common
    prefix or common suffix over 255: where the JAX tail wraps (F11)."""
    q = query.lower()
    for t in texts:
        t = t.lower()
        n = 0
        while n < min(len(q), len(t)) and q[n] == t[n]:
            n += 1
        m = 0
        while m < min(len(q), len(t)) and q[-1 - m] == t[-1 - m]:
            m += 1
        if max(n, m) > 255 or (
                min(len(q), len(t)) > 255
                and longest_common_substring_length(list(q), list(t)) > 255):
            return True
    return False


def test_wide_query_equals_jax_and_oracle(lexicon):
    words, longs = lexicon
    port, ref = _models(words)
    assert port._pipeline().L == max(LONG_LENGTHS)
    queries = (corrupt_queries(longs, 1, 12) + longs
               + corrupt_queries(words[:2000], 2, 40))
    params = dataclasses.replace(PARAMS, max_ngram=1)
    got = _tuples(port, port.find_variants_batch(queries, params))
    streamed = _tuples(port, list(port.find_variants_stream(
        queries, params, batch_size=16)))
    oracle = _tuples(port, [port._find_variants_oracle(q, params)
                            for q in queries])
    want = _tuples(ref, ref.find_variants_batch(queries, to_ref(params)))
    ref.set_backend("oracle")
    ref_oracle = _tuples(ref, ref.find_variants_batch(queries,
                                                      to_ref(params)))
    assert got == streamed == oracle == ref_oracle
    near_long = [i for i, q in enumerate(queries) if len(q) > 64]
    assert len(near_long) >= 12 and all(got[i] for i in near_long)
    wrapped = [i for i, q in enumerate(queries)
               if _over_255(q, [t for t, *_ in got[i]])]
    assert wrapped  # the exact 300-letter query at least
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g != w) == (i in wrapped), queries[i]


def test_wide_search_equals_jax_and_host(lexicon):
    words, longs = lexicon
    port, ref = _models(words)
    # a third of the tokens long: the 70- and 100-letter entries (their
    # metrics fit a byte) and the 300-letter one, some of them corrupted
    texts = synthetic_text(words[:400] + longs * 100, 31, 16)
    assert sum(any(len(t) > 64 for t in line.split()) for line in texts) > 8
    got = signature(list(port.find_all_matches_stream(texts, PARAMS)))
    want = signature(ref.find_all_matches_batch(texts, to_ref(PARAMS)))
    preps, uniq, lookups = port._fam_prepare(texts, PARAMS)
    found = [port._find_variants_oracle(q, PARAMS) for q in lookups]
    host = signature(port._fam_consolidate(preps, uniq, found, PARAMS))
    assert got == host
    texts_of = {i: [port.decoder[v].text for m in out if m[5]
                    for v, *_ in m[5]] for i, out in enumerate(got)}
    wrapped = {i for i, line in enumerate(texts)
               if any(_over_255(tok, texts_of[i]) for tok in line.split())}
    for i, (g, w) in enumerate(zip(got, want)):
        if i not in wrapped:
            assert g == w, texts[i]
    assert len(wrapped) < len(texts)


def test_wide_strict_learn_equals_jax(lexicon):
    """Strict learn over corrupted long and ordinary words: the learned
    links, frequencies and types equal the JAX package's, but for entries
    of over 255 letters whose links the JAX tail scored wrapped (F11: a
    metric over 255 needs both strings over 255); such entries exist. After
    learning, the port's lookups of long and ordinary words equal its
    oracle's."""
    words, longs = lexicon
    freqs = synthetic_frequencies(4, len(words))
    port, ref = _models(words, freqs)
    corpus = (corrupt_queries(longs, 21, 24)
              + corrupt_queries(words[:2000], 22, 160) + words[:32:2])
    n_port = port.learn_variants(corpus, PARAMS, strict=True)
    n_ref = ref.learn_variants(corpus, to_ref(PARAMS), strict=True)
    assert n_port == n_ref > len(corpus) // 4
    got, want = snapshot(port), snapshot(ref)
    assert len(got) == len(want)
    wrapped = {i for i, (text, _f, _t, links) in enumerate(got)
               if len(text) > 255 and any(
                   len(port.decoder[v].text) > 255 for _k, v, _s in links
                   or ())}
    assert wrapped
    for i, (g, w) in enumerate(zip(got, want)):
        if i not in wrapped:
            assert g == w, g[0]
    assert any(len(t) > 64 and links for t, _f, _t, links in got)
    after = corrupt_queries(longs, 23, 6) + corrupt_queries(words, 24, 16)
    params = dataclasses.replace(PARAMS, max_ngram=1)
    got = _tuples(port, port.find_variants_batch(after, params))
    assert got == _tuples(port, [port._find_variants_oracle(q, params)
                                 for q in after])
