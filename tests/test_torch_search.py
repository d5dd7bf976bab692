"""Search mode of the port against the JAX package's device backend on the
CPU: ``find_all_matches``/``_batch``/``_stream`` of
``analiticcl_tpu_torch.VariantModel`` must give the same ``Match`` lists as
``analiticcl_tpu``'s model with ``set_backend("device")``, field for field:
text, offsets, ``selected``, ``n`` and every variant as (vocab_id,
dist_score, freq_score, via), floats compared exactly. Also the port's
``RankedResults`` against the JAX class, and ranked output through the
window split. Parameters are built from the port's types (``to_port`` of the
JAX package's test parameters) and carried back by ``to_ref``."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import analiticcl_tpu.models.search_fast as jax_search_fast
import analiticcl_tpu.types as ref_types
import analiticcl_tpu.vocab as ref_vocab
import analiticcl_tpu_torch.types as port_types
import analiticcl_tpu_torch.vocab as port_vocab
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu.ops.pipeline import RankedResults as JaxRankedResults
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
    VariantResult,
)
from analiticcl_tpu_torch.models import search_fast as port_search_fast
from analiticcl_tpu_torch.models import variant_model as port_vm
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.ops.ranked import RankedResults
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    lm_bigram_hits,
    populate,
    synthetic_bigrams,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
)
from fixtures import get_test_alphabet, get_test_searchparams
from test_torch_slice import ref_populate, to_port, to_ref

torch.set_num_threads(2)

# the word lists of tests/test_search.py's fast-consolidation tests
WORDS = [
    "rites", "tiers", "tires", "tries", "tyres", "rides", "brides",
    "dire", "bride", "to", "happy", "earth", "wide", "world", "again",
    "point", "appoint", "are", "right", "over", "under", "the",
]
EXTRA_TEXTS = [
    "",  # empty text -> empty result
    "xyzq gmbh qqq",  # heavy OOV
    "are rihgt",
    "naïve tires — rites",  # non-ASCII: the unicode segmentation
    "тires прright, tires!",  # cyrillic mixed
    "ñ",  # a single non-ASCII character
    "café-bride's dire…",  # weak boundaries and an ellipsis
]


def signature(outs):
    return [
        [
            (
                m.text, m.offset.begin, m.offset.end, m.selected, m.n,
                None
                if m.variants is None
                else [
                    (r.vocab_id, r.dist_score, r.freq_score, r.via)
                    for r in m.variants
                ],
            )
            for m in out
        ]
        for out in outs
    ]


def _corrupt(rng, w):
    if len(w) > 3 and rng.random() < 0.6:
        i = rng.randrange(len(w) - 1)
        return w[:i] + w[i + 1] + w[i] + w[i + 2 :]
    return w


def _texts(seed, n):
    rng = random.Random(seed)
    texts = []
    for _ in range(n):
        parts = [_corrupt(rng, rng.choice(WORDS)) for _ in range(rng.randrange(1, 9))]
        sep = rng.choice([" ", " ", ", ", ". ", " - "])
        texts.append(sep.join(parts) + rng.choice(["", ".", "!", "?!"]))
    return texts + EXTRA_TEXTS


def _pair(fill):
    """The port's model and the JAX package's, filled alike (each with its
    own package's vocabulary types), both on their device backend."""
    alphabet, _ = get_test_alphabet()
    models = []
    for cls, kw, types, vocab in (
        (VariantModel, {"device": "cpu"}, port_types, port_vocab),
        (JaxModel, {}, ref_types, ref_vocab),
    ):
        model = cls(alphabet=alphabet, weights=types.Weights(), **kw)
        fill(model, vocab)
        model.build()
        model.set_backend("device")
        models.append(model)
    return models


def _params(**changes):
    """The JAX package's test search parameters as the port's type."""
    return dataclasses.replace(to_port(get_test_searchparams()), **changes)


def _fill_words(model, vocab):
    rng = random.Random(23)
    for w in WORDS:
        model.add_to_vocabulary(w, rng.randrange(1, 50), vocab.VocabParams())


def _fill_lm(model, vocab):
    """tests/test_search.py's LM model: multi-word entries, a bigram LM and
    punctuation as an LM entry."""
    rng = random.Random(23)
    vp = vocab.VocabParams
    for w in WORDS:
        model.add_to_vocabulary(w, rng.randrange(1, 50), vp())
    model.add_to_vocabulary("wide world", 9, vp())
    model.add_to_vocabulary("are right", 7, vp())
    lmp = vp(vocab_type=vocab.VocabType.LM)
    for _ in range(60):
        a, b = rng.choice(WORDS), rng.choice(WORDS)
        model.add_to_vocabulary(f"{a} {b}", rng.randrange(1, 20), lmp)
    model.add_to_vocabulary(".", 5, lmp)


@pytest.fixture(scope="module")
def word_models():
    return _pair(_fill_words)


@pytest.fixture(scope="module")
def lm_models():
    return _pair(_fill_lm)


@pytest.mark.parametrize(
    "max_ngram,uoff,fw",
    [(1, False, 0.0), (2, False, 0.0), (3, False, 0.0), (2, True, 0.0),
     (2, False, 1.0)],
    ids=["ngram1", "ngram2", "ngram3", "unicodeoffsets", "freq_weight"],
)
def test_search_matches_jax(word_models, max_ngram, uoff, fw):
    port, ref = word_models
    params = _params(max_ngram=max_ngram, unicodeoffsets=uoff, freq_weight=fw)
    texts = _texts(7, 24)
    want = signature(ref.find_all_matches_batch(texts, to_ref(params)))
    got = signature(list(port.find_all_matches_stream(texts, params)))
    assert got == want
    assert signature(port.find_all_matches_batch(texts, params)) == want
    assert signature([port.find_all_matches(texts[0], params)]) == want[:1]
    port.fast_consolidate = False
    try:
        assert signature(port.find_all_matches_batch(texts, params)) == want
    finally:
        port.fast_consolidate = True
    assert isinstance(port._device, DevicePipeline)
    assert sum(len(m) for m in want) > len(texts)


@pytest.mark.parametrize(
    "max_seq,fw,uoff",
    [(250, 0.0, False), (3, 0.0, False), (50, 1.0, True), (1, 0.0, False)],
    ids=["seq250", "seq3", "seq50-freq-unicode", "seq1"],
)
@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
def test_lm_search_matches_jax(lm_models, max_seq, fw, uoff, force_numpy):
    port, ref = lm_models
    assert port.have_lm
    params = _params(max_ngram=2, lm_weight=1.0, max_seq=max_seq,
                     freq_weight=fw, unicodeoffsets=uoff)
    texts = _texts(23, 30)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(jax_search_fast, "FORCE_NUMPY_LM", force_numpy)
    monkeypatch.setattr(port_search_fast, "FORCE_NUMPY_LM", force_numpy)
    try:
        want = signature(ref.find_all_matches_batch(texts, to_ref(params)))
        got = signature(list(port.find_all_matches_stream(texts, params)))
    finally:
        monkeypatch.undo()
    assert got == want
    port.fast_consolidate = False
    try:
        assert signature(port.find_all_matches_batch(texts, params)) == want
    finally:
        port.fast_consolidate = True


def test_context_rules_take_the_object_path():
    def fill(model, vocab):
        for w in ("I", "think", "sink", "you", "are", "right"):
            model.add_to_vocabulary(w, 2, vocab.VocabParams())
        model.add_contextrule("I; think", 1.1, ["testtag", "testtag2"], [])
        model.add_contextrule("are", 0.9, ["testtag"], [])

    port, ref = _pair(fill)
    params = _params(lm_weight=0.0, max_ngram=1)
    texts = ["I tink you are rihgt", "are you right", ""]
    got = port.find_all_matches_batch(texts, params)
    want = ref.find_all_matches_batch(texts, to_ref(params))
    assert signature(got) == signature(want)
    assert [[(m.tag, m.seqnr) for m in o] for o in got] == [
        [(m.tag, m.seqnr) for m in o] for o in want
    ]
    assert got[0][1].tag == [0, 1]


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=5, n=6000)


@pytest.mark.parametrize("split", [False, True], ids=["one_batch", "split"])
@pytest.mark.parametrize("lm", [False, True], ids=["nolm", "lm"])
def test_synthetic_search_matches_jax(words, monkeypatch, lm, split):
    freqs = synthetic_frequencies(9, len(words))
    bigrams = synthetic_bigrams(words, 4, 400) if lm else None
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                    freqs, bigrams)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs, bigrams)
    ref.set_backend("device")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        max_ngram=2,
        freq_weight=1.0 if lm else 0.0,
        lm_weight=1.0,
    )
    texts = synthetic_text(words, 3, 24, bigrams) + ["", "zzqx vvkj"]
    if split:  # a unit goes to the card in several parts
        monkeypatch.setattr(port_vm, "SEARCH_BATCH", 97)
    submits = []
    real_submit = DevicePipeline.submit
    monkeypatch.setattr(
        DevicePipeline, "submit",
        lambda self, *a: submits.append(1) or real_submit(self, *a),
    )
    outs = list(port.find_all_matches_stream(texts, params))
    got = signature(outs)
    want = signature(ref.find_all_matches_batch(texts, to_ref(params)))
    assert got == want
    assert (len(submits) > 1) == split
    n_sel = sum(m[3] is not None for out in want for m in out)
    assert n_sel > 10 * len(texts)
    # the LM decode meets known bigrams, not only the smoothing branch
    assert (lm_bigram_hits(port, outs) > 10) == lm


def test_ranked_results_matches_jax_class():
    rng = np.random.default_rng(3)

    def part(n, nrows):
        sizes = rng.integers(0, 4, size=nrows)
        sb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        tot = int(sb[-1])
        row_of = np.full(n, -1, dtype=np.int64)
        rows = rng.permutation(n)[:nrows]
        row_of[rows] = np.arange(nrows)
        free = [i for i in range(n) if row_of[i] < 0]
        overrides = {i: [] for i in free[:1]}
        for i in free[1:3]:
            overrides[i] = [VariantResult(7, 0.5, 0.25, None)]
        return (n, rng.integers(3, 99, size=tot).astype(np.int64),
                rng.random(tot), rng.random(tot), row_of, sb, overrides)

    parts = [part(9, 5), part(4, 1), part(6, 0)]
    ours = [RankedResults(*p) for p in parts]
    theirs = [JaxRankedResults(*p) for p in parts]
    for a, b in zip(ours + [RankedResults.concat(ours)],
                    theirs + [JaxRankedResults.concat(theirs)]):
        assert len(a) == len(b)
        for i in range(len(b)):
            assert a.arrays_of(i) == b.arrays_of(i)
            assert a[i] == b[i]
            assert a[i - len(b)] == b[i]
        assert list(a) == list(b)
        for name in ("vid", "ds", "fq", "row_of", "sbounds"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        with pytest.raises(IndexError):
            a[len(b)]
        with pytest.raises(TypeError):
            a[np.int64(0)]


def test_window_split_yields_one_ranked_results(words):
    """A lookup batch that mixes DL windows splits into per-window
    sub-batches; with ``want_ranked`` their results join into one
    RankedResults in input order, whose every ``[i]`` equals the eager
    result, also for pre-resolved (empty, over-long) and expandable inputs."""
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)
    for k in range(0, 40, 4):  # a few indexed entries with variant links
        port.add_variant_by_id(port.encoder[words[k]],
                               port.encoder[words[k + 1]], 0.9)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_with_limit(0.5, 6),
        max_edit_distance=DistanceThreshold.ratio_with_limit(0.5, 12),
        max_matches=10,
        score_threshold=0.25,
    )
    long_words = [w for w in words if len(w) >= 14]
    queries = (
        corrupt_queries(words, 11, 48) + long_words[:8]
        + ["", "q" * 40, "ab"] + [words[k] for k in range(0, 40, 4)]
    )
    pipe = port._pipeline()
    state = pipe.submit(queries, params)
    assert state.get("subs") is not None and len(state["subs"]) > 1
    state["want_ranked"] = True
    ranked = pipe.collect(state)
    assert isinstance(ranked, RankedResults)
    eager = pipe.find_variants_batch(queries, params)
    assert len(ranked) == len(queries)
    for i in range(len(queries)):
        assert ranked[i] == eager[i], queries[i]
    assert ranked.overrides  # expandable rows and pre-resolved inputs
    assert (ranked.row_of >= 0).sum() > len(queries) // 2
    assert any(r.via is not None for res in eager for r in res)
