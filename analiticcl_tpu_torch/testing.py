"""Seeded synthetic lexicons and corrupted queries for tests and the chip smoke run.

The real eng.aspell lexicon is not shipped with the repository, so the port is
driven on a generated lexicon of about the same size (eng.aspell has 119,773
entries; the default here is 120,000). Its neighbourhoods are as dense as a
dictionary's: about 15k stems drawn with English letter frequencies, and
every other entry derived from a stem by common suffixes or by one or two
random edits, so a corrupted query sees many candidates within a few edits,
as a misspelling does in a real dictionary.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from analiticcl_tpu.vocab import VocabParams

# 26 case-folded letters plus punctuation, like the reference's test alphabet
ALPHABET = [[c, c.upper()] for c in "abcdefghijklmnopqrstuvwxyz"] + [
    [".", ","], ["'"], ["-"],
]

_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
# English letter frequencies (percent), a..z
_FREQ = np.array([
    8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4,
    6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074,
])
_P = _FREQ / _FREQ.sum()
_SUFFIXES = (
    "s", "es", "ed", "ing", "er", "ers", "ly", "ness", "ment", "able",
    "'s", "ation", "ations", "ist", "ism", "ful", "less", "ity",
)
MAX_LEN = 28


def _letters(rng: np.random.Generator, n: int) -> str:
    return "".join(rng.choice(_LETTERS, size=n, p=_P))


def _edit(word: str, rng: np.random.Generator) -> str:
    """One random deletion, transposition, insertion or substitution."""
    if len(word) < 2:
        return word + _letters(rng, 1)
    i = int(rng.integers(len(word) - 1))
    op = int(rng.integers(4))
    if op == 0:
        return word[:i] + word[i + 1 :]
    if op == 1:
        return word[:i] + word[i + 1] + word[i] + word[i + 2 :]
    if op == 2:
        return word[:i] + _letters(rng, 1) + word[i:]
    return word[:i] + _letters(rng, 1) + word[i + 1 :]


def synthetic_lexicon(seed: int, n: int = 120_000) -> List[str]:
    """``n`` distinct words of length 1-28, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    n_stems = min(n, max(1, n // 8))
    seen = set()
    words: List[str] = []

    def add(w: str) -> None:
        if 1 <= len(w) <= MAX_LEN and w not in seen:
            seen.add(w)
            words.append(w)

    lens = np.clip(np.rint(rng.normal(7.0, 2.6, size=4 * n_stems)), 1, 20)
    for ln in lens.astype(int):
        if len(words) >= n_stems:
            break
        w = _letters(rng, int(ln))
        if rng.random() < 0.1:
            w = w.capitalize()
        add(w)
    stems = list(words)
    while len(words) < n:
        w = stems[int(rng.integers(len(stems)))]
        r = rng.random()
        if r < 0.45:
            w += _SUFFIXES[int(rng.integers(len(_SUFFIXES)))]
            if rng.random() < 0.3:
                w += _SUFFIXES[int(rng.integers(len(_SUFFIXES)))]
        else:
            for _ in range(1 + int(r > 0.8)):
                w = _edit(w, rng)
        add(w)
    return words


def synthetic_frequencies(seed: int, n: int) -> np.ndarray:
    """Zipf-like integer frequencies in a random rank order, some above
    2**24 so that a float32 path would round them."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n) + 1
    return (2_000_000_000 // ranks).astype(np.int64)


def corrupt_queries(words: Sequence[str], seed: int, n: int) -> List[str]:
    """``n`` queries, each a lexicon word under one or two random edits."""
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.integers(len(words), size=n):
        w = words[int(k)]
        for _ in range(1 + int(rng.random() < 0.3)):
            w = _edit(w, rng)
        out.append(w)
    return out


def populate(model, words: Sequence[str], freqs: Optional[np.ndarray] = None):
    """Add ``words`` (with ``freqs``, if given) to ``model`` and build it.
    Works for the JAX package's model and the port's alike."""
    vp = VocabParams()
    for i, w in enumerate(words):
        model.add_to_vocabulary(w, None if freqs is None else int(freqs[i]), vp)
    model.have_freq = freqs is not None
    model.build()
    return model
