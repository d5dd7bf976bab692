"""Count planes wider than 960 columns (ROADMAP F12) end to end on the CPU:
the port's device path (its plain versions; the card runs K1's streamed
instance at these widths) against the JAX package's device path and both
packages' host oracles, in query and search (``max_ngram`` 2).

The lexicon is 2,000 seeded entries plus one of 64 characters that holds
one letter 50 times, so the largest count of one character in one entry
is 50 and the planes are 30 x 50 = 1,500 columns wide (1,504 on the port's
device, padded to 32), while L stays 64. Every result is held exactly
against the JAX package's device path and both oracles.

Then the same lexicon with a 1,000-letter entry too (L 1,000), queried
near that entry and elsewhere: held against the port's host oracle only.
The JAX package's device path took 40 s on this file's 15 queries on a
CPU (over the file's budget of about 30 s), and its native tail reads the
int32 metrics of such pairs as bytes (F11, on the reference side).
"""

import dataclasses

import numpy as np
import pytest
import torch

import analiticcl_tpu_torch.ops.pipeline as ppl
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
)
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_lexicon,
    synthetic_text,
)
from test_torch_search import signature
from test_torch_slice import ref_populate, to_ref

torch.set_num_threads(2)

PARAMS = SearchParameters(
    max_anagram_distance=DistanceThreshold.absolute(3),
    max_edit_distance=DistanceThreshold.absolute(2),
    max_matches=10,
    score_threshold=0.25,
    max_ngram=2,
)
QUERY = dataclasses.replace(PARAMS, max_ngram=1)


def _repetitive(rng, n=64, k=50) -> str:
    """``n`` letters of which exactly ``k`` are one letter, in a seeded
    order."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    one = rng.choice(letters)
    chars = np.concatenate([np.repeat(one, k),
                            rng.choice(letters[letters != one], n - k)])
    return "".join(rng.permutation(chars))


@pytest.fixture(scope="module")
def lexicon():
    words = synthetic_lexicon(seed=0, n=2000)
    rng = np.random.default_rng(17)
    rep = _repetitive(rng)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    long = "".join(rng.choice(letters, 1000))
    return words, rep, long


@pytest.fixture(scope="module")
def models(lexicon):
    words, rep, _ = lexicon
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"),
                    words + [rep])
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words + [rep])
    ref.set_backend("device")
    return port, ref


def _tuples(model, results):
    return [[(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
              r.via) for r in res] for res in results]


def test_planes_are_wider_than_960(models):
    port, _ = models
    pipe = port._pipeline()
    assert pipe.index.at == 30 * 50 and pipe.index.bins.shape[1] == 1504
    assert pipe.L == 64


def test_wide_planes_query_equals_jax_and_oracle(lexicon, models):
    words, rep, _ = lexicon
    port, ref = models
    queries = (corrupt_queries([rep], 1, 12) + [rep]
               + corrupt_queries(words, 2, 60))
    got = _tuples(port, port.find_variants_batch(queries, QUERY))
    streamed = _tuples(port, list(port.find_variants_stream(
        queries, QUERY, batch_size=16)))
    oracle = _tuples(port, [port._find_variants_oracle(q, QUERY)
                            for q in queries])
    want = _tuples(ref, ref.find_variants_batch(queries, to_ref(QUERY)))
    ref.set_backend("oracle")
    try:
        ref_oracle = _tuples(ref, ref.find_variants_batch(queries,
                                                          to_ref(QUERY)))
    finally:
        ref.set_backend("device")
    assert got == streamed == oracle == ref_oracle == want
    # the entry with the wide planes is found from its corruptions
    assert sum(any(t == rep for t, *_ in g) for g in got[:13]) >= 10


def test_wide_planes_search_equals_jax_and_host(lexicon, models):
    words, rep, _ = lexicon
    port, ref = models
    texts = synthetic_text(words[:400] + [rep] * 60, 31, 16)
    assert sum(rep in line for line in texts) >= 4
    got = signature(list(port.find_all_matches_stream(texts, PARAMS)))
    want = signature(ref.find_all_matches_batch(texts, to_ref(PARAMS)))
    preps, uniq, lookups = port._fam_prepare(texts, PARAMS)
    found = [port._find_variants_oracle(q, PARAMS) for q in lookups]
    host = signature(port._fam_consolidate(preps, uniq, found, PARAMS))
    assert got == want == host


def test_thousand_letter_entry_equals_oracle(monkeypatch, lexicon):
    """The plain DL's time grows with the pair budget times L on the CPU,
    so the budgets start at 64 pairs here (and escalate where a batch
    needs more)."""
    monkeypatch.setattr(ppl, "P_BUCKETS", (64, 256, 1024, 4096))
    monkeypatch.setattr(ppl, "P2_BUCKETS", (32, 128, 512, 2048))
    words, rep, long = lexicon
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"),
                    words + [rep, long])
    pipe = port._pipeline()
    assert pipe.L == 1000 and pipe.index.bins.shape[1] > 960
    queries = (corrupt_queries([long], 3, 2) + [long]
               + corrupt_queries([rep], 4, 4) + corrupt_queries(words, 5, 8))
    got = _tuples(port, port.find_variants_batch(queries, QUERY))
    oracle = _tuples(port, [port._find_variants_oracle(q, QUERY)
                            for q in queries])
    assert got == oracle
    assert all(any(t == long for t, *_ in g) for g in got[:3])


def test_band_width_follows_the_queries(lexicon, models):
    """A batch whose band reaches the repetitive entry's block runs stage A
    at that block's extent (the streamed instance on the card, each block
    at its own extent); a batch of short queries stays below it, at 224
    columns or fewer (the main instance). Both equal the JAX package's
    device path and the oracle."""
    words, rep, _ = lexicon
    port, ref = models
    pipe = port._pipeline()
    ext = pipe.index.extents_host
    assert ext.max() == 1504 and (ext > 224).sum() == 1
    near = corrupt_queries([rep], 6, 8) + [rep]
    short = [w for w in words if len(w) <= 4][:24]
    found = []
    for queries, width in ((near, 1504), (short, None)):
        st = pipe.prepare(queries, QUERY)
        assert (st["width"] == width if width else st["width"] <= 224)
        got = _tuples(port, port.find_variants_batch(queries, QUERY))
        oracle = _tuples(port, [port._find_variants_oracle(q, QUERY)
                                for q in queries])
        want = _tuples(ref, ref.find_variants_batch(queries, to_ref(QUERY)))
        assert got == oracle == want
        found.append(sum(any(t == rep for t, *_ in g) for g in got))
    assert found[0] >= 6 and found[1] == 0
