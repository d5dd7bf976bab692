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

from .editscript import script_to_str, shortest_edit_script
from .vocab import VocabParams, VocabType

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


_SEPARATORS = (" ", " ", " ", ", ", ". ", "! ", " - ")


def synthetic_text(words: Sequence[str], seed: int, n_lines: int,
                   bigrams=None) -> List[str]:
    """``n_lines`` lines of running text, 8-16 tokens each: lexicon words,
    about a third of them under one or two random edits, joined by spaces
    and ``, . ! -`` separators.

    With ``bigrams`` (as :func:`synthetic_bigrams` gives them), about a
    third of the tokens come as space-joined pairs drawn from that list, so
    a language model over it meets its bigrams in the text."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_lines):
        ntok = int(rng.integers(8, 17))
        toks = [words[int(k)] for k in rng.integers(len(words), size=ntok)]
        paired = [False] * ntok  # joined to the token before by a space
        i = 0
        while bigrams and i < ntok - 1:
            if rng.random() < 0.2:
                toks[i : i + 2] = bigrams[int(rng.integers(len(bigrams)))][0].split(" ")
                paired[i + 1] = True
                i += 2
            else:
                i += 1
        parts = []
        for w in toks:
            if rng.random() < 0.35:
                for _ in range(1 + int(rng.random() < 0.3)):
                    w = _edit(w, rng)
            parts.append(w)
        line = parts[0]
        for w, pair in zip(parts[1:], paired[1:]):
            sep = _SEPARATORS[int(rng.integers(len(_SEPARATORS)))]
            line += (" " if pair else sep) + w
        lines.append(line + (".", "!", "")[int(rng.integers(3))])
    return lines


def synthetic_confusables(words: Sequence[str], seed: int) -> List[str]:
    """Lines of a weighted confusable list (``pattern<TAB>weight``): the
    changed part of the edit script from a corrupted word to its lexicon
    word, for the first six distinct two-instruction scripts, and one
    pattern anchored at the word's start."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    for w in (words[int(k)] for k in rng.integers(len(words), size=400)):
        bad = corrupt_queries([w], int(rng.integers(1 << 30)), 1)[0]
        core = [ins for ins in shortest_edit_script(bad, w)
                if ins.op.value != "="]
        pat = script_to_str(core)
        if (len(core) == 2 and core[0].text != core[1].text
                and pat not in seen):
            seen.add(pat)
            out.append(pat)
        if len(out) == 6:
            break
    weights = (1.2, 0.8, 1.1, 1.05, 0.9, 1.3)
    lines = [f"{p}\t{wt}" for p, wt in zip(out, weights)]
    lines.append(f"^=[{words[0][0].lower()}]-[e]\t1.15")
    return lines


def synthetic_variants(refs: Sequence[str], seed: int,
                       scores: Optional[Sequence[float]] = None,
                       stride: Optional[int] = None, max_forms: int = 3,
                       freqs: bool = False) -> List[str]:
    """Lines of a weighted variant list (``-V``; reference lib.rs:772-897)
    over the lexicon words ``refs``: each reference, then its forms, each
    with a score. Form k of ``refs[i]`` is ``refs[i]`` under one or two
    random edits from the seed ``seed + k * stride + i`` (``stride``
    defaults to ``len(refs)``). ``scores`` gives every line's forms by
    their scores; without it a generator seeded with ``seed`` draws 1 to
    ``max_forms`` forms a line, each scored in [0.5, 1.0]. With ``freqs``
    the lines take the frequency-bearing layout: the reference, its
    frequency, then (form, score, frequency) triples, the frequencies drawn
    from the same generator. A reader tells the two layouts apart by the
    column count and the second column."""
    rng = np.random.default_rng(seed)
    stride = len(refs) if stride is None else stride
    lines = []
    for i, w in enumerate(refs):
        line_scores = scores
        if line_scores is None:
            n = 1 + int(rng.integers(max_forms))
            line_scores = np.round(rng.uniform(0.5, 1.0, size=n), 3).tolist()
        fields = [w]
        if freqs:
            fields.append(str(int(rng.integers(1, 100_000))))
        for k, score in enumerate(line_scores):
            fields += [corrupt_queries([w], seed + k * stride + i, 1)[0],
                       f"{score:g}"]
            if freqs:
                fields.append(str(int(rng.integers(1, 1000))))
        lines.append("\t".join(fields))
    return lines


def synthetic_errors(refs: Sequence[str], seed: int,
                     scores: Optional[Sequence[float]] = None,
                     stride: Optional[int] = None) -> List[str]:
    """Lines of an error list (``-E``, read as a transparent variant list):
    :func:`synthetic_variants` with one or two error forms a reference."""
    return synthetic_variants(refs, seed, scores, stride, max_forms=2)


def synthetic_contextrules(words: Sequence[str], bigrams, text: Sequence[str],
                           groups: int = 1) -> List[str]:
    """Lines of a context-rule list (``-R``: pattern, score, tags, tag
    offsets; reference lib.rs:570-656), a comment and then ``groups``
    groups of seven: three tagged and two untagged rules over word pairs of
    the bigram list ``bigrams`` (as :func:`synthetic_bigrams` gives it)
    that the lines ``text`` hold, one tagged rule over a single word of
    such a pair, and a disjunction of two of ``words`` before any word,
    tagged at its first position only."""
    held = set()
    for line in text:
        toks = line.split(" ")
        held.update(zip(toks, toks[1:]))
    pairs = [b.split(" ") for b, _ in bigrams
             if tuple(b.split(" ")) in held][:6 * groups]
    if len(pairs) < 6 * groups:
        raise ValueError(f"the text holds {len(pairs)} of the bigrams, "
                         f"not {6 * groups}")
    rules = ["# seeded rules"]
    for g in range(groups):
        p = pairs[6 * g : 6 * g + 6]
        rules += [f"{a}; {b}\t1.25\tpair" for a, b in p[:3]]
        rules += [f"{a}; {b}\t0.8" for a, b in p[3:5]]
        rules += [f"{p[5][0]}\t1.1\tsingle",
                  f"{words[7 + 2 * g]}|{words[8 + 2 * g]}; ?\t1.2\tany\t0:1"]
    return rules


def lm_bigram_hits(model, outs) -> int:
    """How many adjacent selected matches in the search results ``outs``
    form a bigram of ``model``'s language model."""
    hits = 0
    for out in outs:
        vids = [m.solution() and m.solution().vocab_id for m in out]
        hits += sum((a, b) in model.ngrams for a, b in zip(vids, vids[1:])
                    if a is not None and b is not None)
    return hits


def synthetic_bigrams(words: Sequence[str], seed: int, n: int):
    """``n`` distinct word bigrams ``"a b"`` over ``words`` with Zipf-like
    integer frequencies: the entries of a bigram language model."""
    rng = np.random.default_rng(seed)
    seen = set()
    out = []
    while len(out) < n:
        a, b = rng.integers(len(words), size=2)
        bigram = f"{words[int(a)]} {words[int(b)]}"
        if bigram not in seen:
            seen.add(bigram)
            out.append((bigram, int(1 + 1000 // (1 + len(out) % 97))))
    return out


def populate(model, words: Sequence[str], freqs: Optional[np.ndarray] = None,
             bigrams=None):
    """Add ``words`` (with ``freqs``, if given) and the LM ``bigrams`` (as
    :func:`synthetic_bigrams` gives them, if given) to ``model`` and build
    it (the port's model)."""
    vp = VocabParams()
    for i, w in enumerate(words):
        model.add_to_vocabulary(w, None if freqs is None else int(freqs[i]), vp)
    lm = VocabParams(vocab_type=VocabType.LM)
    for text, freq in bigrams or ():
        model.add_to_vocabulary(text, freq, lm)
    model.have_freq = freqs is not None
    model.build()
    return model
