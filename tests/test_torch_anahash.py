"""The port's anagram algebra (``analiticcl_tpu_torch.anahash``) and
deletion iterators (``analiticcl_tpu_torch.iterators``) against the JAX
package's: the cases of ``tests/test_anahash.py`` and
``tests/test_iterators.py`` run through the port, and every function and
iterator mode on count vectors made by ``numpy.random.default_rng(seed)``,
yield orders included."""

import itertools

import numpy as np
import pytest

import analiticcl_tpu.anahash as jax_ah
import analiticcl_tpu.iterators as jax_it
import analiticcl_tpu_torch.anahash as ah
import analiticcl_tpu_torch.iterators as it
from analiticcl_tpu_torch.alphabet import AlphabetEncoder
from analiticcl_tpu_torch.types import PRIMES
from fixtures import get_test_alphabet

ALPHABET, _ = get_test_alphabet()
ENC = AlphabetEncoder(ALPHABET)
SEEDS = range(4)


def cv(text):
    return ENC.count_vector(text)


def av(text):
    return ah.anahash(text, ALPHABET)


def random_counts(seed: int, n: int = 12, size: int = 28, most: int = 6):
    """``n`` count vectors of ``size`` slots with at most ``most``
    characters each (small enough for the full deletion trees)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = np.zeros(size, np.uint8)
        for idx in rng.integers(size, size=int(rng.integers(0, most + 1))):
            c[idx] += 1
        out.append(c)
    return out


def test_reference_hash_cases():
    """tests/test_anahash.py's cases, on the port."""
    assert ah.empty_anavalue() == 1 and not cv("").any()
    assert (av("a"), av("b"), av("c"), av("ab")) == (2, 3, 5, 6)
    assert av("abc") == 30 and av("abcabcabc") == 30 ** 3
    assert av("abc") == av("ABC") == av("bAc") and av("a.b") == av("a,b")
    assert av("stressed") == av("desserts") and av("dormitory") == av("dirtyroom")
    assert av("xyz" * 24) > 1
    assert ah.av_insert(av("ab"), av("c")) == av("abc")
    assert ah.av_contains(av("abc"), av("ab")) and not ah.av_contains(av("ab"), av("c"))
    assert ah.av_delete(av("abc"), av("b")) == av("ac")
    assert ah.av_delete(av("c"), av("abc")) is None
    assert np.array_equal(ah.cv_delete(cv("abc"), cv("c")), cv("ab"))
    assert ah.cv_delete(cv("abc"), cv("x")) is None
    assert ah.cv_alphabet_upper_bound(cv("abc")) == (2, 3)
    assert ah.cv_alphabet_upper_bound(cv("x")) == (23, 1)
    assert ah.cv_anagram_distance(cv("abc"), cv("xyz")) == 6
    assert ah.character(0) == PRIMES[0] == 2
    for word in ("house", "stressed", "xyzzy", "a", ""):
        counts = cv(word)
        assert ah.counts_to_anavalue(counts) == av(word)
        assert np.array_equal(ah.anavalue_to_counts(av(word), len(counts)), counts)


@pytest.mark.parametrize("word", ["", "a", "house", "Stressed", "a.b,c",
                                  "naïve", "xyz" * 24])
def test_text_functions_match_jax(word):
    assert ah.anahash(word, ALPHABET) == jax_ah.anahash(word, ALPHABET)
    assert ah.normalize_to_alphabet(word, ALPHABET) == (
        jax_ah.normalize_to_alphabet(word, ALPHABET))


@pytest.mark.parametrize("seed", SEEDS)
def test_algebra_matches_jax(seed):
    vecs = random_counts(seed)
    for a, b in itertools.product(vecs, repeat=2):
        x, y = ah.counts_to_anavalue(a), ah.counts_to_anavalue(b)
        assert x == jax_ah.counts_to_anavalue(a)
        assert np.array_equal(ah.anavalue_to_counts(x, len(a)),
                              jax_ah.anavalue_to_counts(x, len(a)))
        assert ah.av_insert(x, y) == jax_ah.av_insert(x, y)
        assert ah.av_contains(x, y) == jax_ah.av_contains(x, y)
        assert ah.av_delete(x, y) == jax_ah.av_delete(x, y)
        assert ah.cv_contains(a, b) == jax_ah.cv_contains(a, b)
        assert np.array_equal(ah.cv_insert(a, b), jax_ah.cv_insert(a, b))
        got, want = ah.cv_delete(a, b), jax_ah.cv_delete(a, b)
        assert (got is None and want is None) or np.array_equal(got, want)
        assert ah.cv_anagram_distance(a, b) == jax_ah.cv_anagram_distance(a, b)
        # the bigint and the count-vector forms agree
        assert ah.av_contains(x, y) == ah.cv_contains(a, b)
    for a in vecs:
        assert ah.cv_char_count(a) == jax_ah.cv_char_count(a) == it.char_count(a)
        assert it.char_count(a) == jax_it.char_count(a)
        assert ah.cv_is_empty(a) == jax_ah.cv_is_empty(a)
        assert ah.cv_alphabet_upper_bound(a) == jax_ah.cv_alphabet_upper_bound(a)
    assert ah.av_insert(0, 6) == jax_ah.av_insert(0, 6) == 6
    assert [ah.character(i) for i in range(28)] == [
        jax_ah.character(i) for i in range(28)]
    assert ah.empty_anavalue() == jax_ah.empty_anavalue()


def _seq(pairs):
    return [(v.tobytes(), d) for v, d in pairs]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("band", [(3, 1), (2, 1), (4, 2), (6, 3)],
                         ids=lambda b: f"max{b[0]}_min{b[1]}")
def test_deletion_neighborhood_matches_jax(seed, band):
    hi, lo = band
    for counts in random_counts(seed + 10):
        got = _seq(ah.deletion_neighborhood(counts, hi, lo))
        assert got == _seq(jax_ah.deletion_neighborhood(counts, hi, lo))


def _walk(module, counts, **kwargs):
    return [(r.value.tobytes(), r.charindex, d)
            for r, d in module.RecurseDeletionIterator(counts, **kwargs)]


MODES = {
    "dfs": {},
    "dfs_no_empty": {"empty_leaves": False},
    "dfs_unique": {"unique": True, "empty_leaves": False},
    "dfs_min2_max3": {"mindepth": 2, "maxdepth": 3},
    "bfs": {"breadthfirst": True},
    "bfs_unique": {"breadthfirst": True, "unique": True, "empty_leaves": False},
    "bfs_unique_max2": {"breadthfirst": True, "unique": True, "maxdepth": 2},
    "bfs_min3": {"breadthfirst": True, "mindepth": 3, "unique": True},
    "singlebeam": {"singlebeam": True},
    "singlebeam_max2": {"singlebeam": True, "maxdepth": 2},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_recurse_deletion_iterator_matches_jax(mode):
    for seed in SEEDS:
        for counts in random_counts(seed + 20, n=6, most=5):
            got = _walk(it, counts, **MODES[mode])
            assert got == _walk(jax_it, counts, **MODES[mode]), (mode, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_single_deletions_and_values_match_jax(seed):
    for counts in random_counts(seed + 30):
        got = [(r.value.tobytes(), r.charindex) for r in it.iter_deletions(counts)]
        assert got == [(r.value.tobytes(), r.charindex)
                       for r in jax_it.iter_deletions(counts)]
        got = [(r.value.tobytes(), r.charindex, d) for r, d in it.iter_values(counts)]
        assert got == [(r.value.tobytes(), r.charindex, d)
                       for r, d in jax_it.iter_values(counts)]
        assert len(got) == int(counts.sum())


def test_reference_iterator_cases():
    """tests/test_iterators.py's cases, on the port."""
    def words(pairs):
        return [(av(w), d) for w, d in pairs]

    dels = list(it.iter_deletions(cv("house")))
    assert [ah.character(r.charindex) for r in dels] == [
        av(c) for c in ("u", "s", "o", "h", "e")]
    assert [ah.counts_to_anavalue(r.value) for r in dels] == [
        av(w) for w in ("hose", "houe", "huse", "ouse", "hous")]
    assert [ah.counts_to_anavalue(r.value) for r in it.iter_deletions(cv("pass"))] == [
        av(w) for w in ("pas", "ass", "pss")]
    beam = [(ah.counts_to_anavalue(r.value), d) for r, d in it.iter_values(cv("house"))]
    assert beam == words([("hose", 1), ("hoe", 2), ("he", 3), ("e", 4)]) + [(1, 5)]

    def collect(**kw):
        return [(ah.counts_to_anavalue(r.value), d)
                for r, d in it.RecurseDeletionIterator(cv("abcd"), **kw)]

    dfs = [v for v, _ in collect()]
    assert dfs[:8] == [av(w) for w in ("abc", "ab", "a", "", "b", "", "ac", "a")]
    uniq = [v for v, _ in collect(empty_leaves=False, unique=True)]
    assert uniq[:8] == [av(w) for w in ("abc", "ab", "a", "b", "ac", "c", "bc", "abd")]
    level = [("abc", 1), ("abd", 1), ("acd", 1), ("bcd", 1), ("ab", 2), ("ac", 2),
             ("bc", 2), ("ad", 2), ("bd", 2), ("cd", 2)]
    bfs_kw = dict(breadthfirst=True, unique=True, empty_leaves=False)
    assert collect(**bfs_kw, maxdepth=2) == words(level)
    assert collect(**bfs_kw) == words(level + [(c, 3) for c in "abcd"])
    for word in ("abcd", "pass", "house", "stressed"):
        got = [(ah.counts_to_anavalue(v), d)
               for v, d in ah.deletion_neighborhood(cv(word), max_distance=3)]
        assert got == [(ah.counts_to_anavalue(r.value), d)
                       for r, d in it.RecurseDeletionIterator(cv(word), maxdepth=3,
                                                              **bfs_kw)]
