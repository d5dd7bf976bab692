#!/usr/bin/env python3
"""The PyTorch port's benchmark: the cells of ``BENCHMARK.json`` on one card.

    python3 bench_torch.py --cell query_synth120k [--seed S]
    python3 bench_torch.py --cell search_synth120k [--seed S]

Each cell is a file of its own, ``bench_cells/<cell>.json`` (``read_cell``
lists its keys): its mode (``query``, ``search`` or ``search_lm``), the
size of its seeded synthetic lexicon, its search parameters, its traffic
and the sizes of its checks. This script reads that file and names no
cell in its code: a cell with another size or mix is a new file. Every
cell builds
``VariantModel(device="cuda")`` from ``testing.synthetic_lexicon(seed,
lexicon_entries)`` (eng.aspell's size in both cells; eng.aspell is not in
the repository, so every number is labelled ``synthetic-120k``) or, with
``--lexicon FILE``, from a lexicon file over the same alphabet, and takes
the device backend explicitly.

Every result the run reports as correct is held against ``Reference``, a
plain implementation in this file that shares no code with the port: its
own normalization, anagram filter, Damerau-Levenshtein distance, score,
ranking, segmentation, lattice decode and n-best language-model decode,
at the cell's parameters. One differing result aborts the run with a
non-zero exit and no metric.

A ``query`` cell (``find_variants_stream``, the main path): two gates
come first, each comparing full ``(text, dist_score, freq_score, via)``
tuples: ``gate_queries`` corrupted words, and ``w12_queries`` words of
``w12_min_length`` letters or more corrupted twice under the
``w12_thresholds``, which reach the DL window 12. Then the heap is frozen,
the pair budgets are warmed, and ROUNDS timed blocks follow. In each, one
caller drives one stream at its default in-flight depth over ``windows``
windows of ``window_queries`` queries in batches of ``batch``: the base
words (every ``base_every``-th lexicon entry from the first) corrupted
once per window, anew, by a generator seeded from (seed, window),
counting the windows of all rounds. Every ``sample_every``-th result of
every window is held against the reference after the rounds. A round's
rate is all the queries of its settled windows (``settled_view``) over
their summed time.

A ``search`` cell (``find_all_matches_stream`` up to ``max_ngram``, no
language model): a gate holds the first ``lines_checked`` lines of a
warm-up pass against the reference; then ROUNDS timed blocks of
``passes`` passes, each over ``lines`` fresh lines of 8-16 tokens
(``testing.synthetic_text(words, (seed, round, pass), lines)``), whose
first ``lines_checked`` lines are held against the reference after the
rounds. A round's rate is all its tokens over the summed time of its
passes.

A ``search_lm`` cell is a ``search`` cell over a model that also holds a
bigram language model of ``bigrams`` entries
(``testing.synthetic_bigrams(words, seed, bigrams)``, added as LM
entries), whose lines carry some of their tokens in pairs drawn from
those bigrams (``synthetic_text(..., bigrams)``), decoded at
``lm_weight``, ``variantmodel_weight`` and ``max_seq``: the
``max_seq`` cheapest paths of each hard batch scored by the language
model, the best by the weighted mean of the two. The reference decodes
the same way and its answers are held exactly, as in a ``search`` cell.
The run aborts unless the language model changes the choice on some
checked line (``lm_changed_lines``: the reference's choice is not its
cheapest path). ``bench_cells/`` holds no cell of this mode: synthetic
bigrams stand for no deployment, and the repository holds no n-gram list
counted from a public corpus.

The metric of any cell is all the work of every round over all their
time; the median round and the rounds' spread are printed beside it. The
reference's answers for the gates and for every timed sample are computed
before timing, in WORKERS processes, while the port runs the gates. All
five kernel sources (KERNEL_SOURCES) are built before the model, and no
kernel may build after that. After every timed window or pass the launch
counters of every hand-written kernel are read (``launch_counts``: K1 in
all and by instance, K5, K3, K2's slot entry, its pair-string entry and
its wide path, K4) and held to ``require_launches``, whose rules come
from the built index, never from the cell's name (``launch_rules``): K1,
K5, K3, the slot entry and K4 launched, K5 as often as K1 and K4 as K3
(one output buffer per core call), K1's instances adding up to its
launches, and the wide path not at all on an index of strings of 64
letters or fewer. A breach aborts the run with no metric, and so does a
module of JAX or of the JAX package loaded during the run
(``require_no_jax``).

The harness pins the host as a GPU server is deployed: before anything is
built, the process goes to card 0's NUMA-local cores (its present affinity
where sysfs does not give that list) and torch to TORCH_THREADS intra-op
threads; ``main`` restores both. Around every timed window and pass it
reads the host, outside the window: a fixed CPU probe's time, the
process's CPU seconds, context switches and page faults, RSS, the last
core and the thread count; once per command
the cores, affinity, threads, the card's NUMA-local CPU list, and load and
clock before and after the timed rounds. These go into the record, not
into any metric. After the metrics, one more window or pass of the same
shape, seeded apart, runs under one ``torch.profiler`` window: the card's
busy time and idle share (``utils.profiling.profile_window``'s rule), its
top operations and the longest idle gaps with the host stages that ran in
them. No profiler window and no
``nvidia-smi`` call runs inside the timed rounds. The script prints every
metric by name with its unit, then, as its last line, one JSON record with
the settings, the card, its power limit, the torch, CUDA and nvcc versions
and the commit.

``--device cpu`` exists for the CPU test, which gives cut copies of the
cells' files with ``--cells DIR``; ``--device cuda``, the default, raises when CUDA is absent. The
JAX package's benchmark is ``bench.py``; this script imports nothing of it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time
from itertools import islice
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# every source in analiticcl_tpu_torch/csrc, built before the model
KERNEL_SOURCES = ("stage_a", "dl_lcs", "resolve", "compact", "planes")
CELLS_DIR = Path(__file__).resolve().parent / "bench_cells"
# the keys of a cell's file: those of every cell, then those of each mode
CELL_KEYS = ("about", "mode", "lexicon_entries", "thresholds", "max_matches",
             "score_threshold", "cutoff_threshold")
MODE_KEYS = {
    "query": ("batch", "window_queries", "windows", "base_every",
              "gate_queries", "w12_queries", "w12_min_length",
              "w12_thresholds", "sample_every"),
    "search": ("max_ngram", "lines", "passes", "lines_checked"),
}
# a search_lm cell's language-model settings, as SearchParameters names them
LM_SETTINGS = ("lm_weight", "variantmodel_weight", "max_seq")
MODE_KEYS["search_lm"] = MODE_KEYS["search"] + ("bigrams",) + LM_SETTINGS
# query_synth120k's batch and window (bench_cells/query_synth120k.json),
# which chip_smoke.core_shapes imports; the harness reads the cell's file
BATCH = 4096
N_QUERIES = 65_536
ROUNDS = 3  # timed blocks per command; the metric is all their work
# over all their time
TORCH_THREADS = 1  # torch's intra-op threads (BENCHMARK.json "parameters")
WORKERS = 8  # processes computing the reference's answers (a core is left)
PROBE_LOOPS = 100_000  # iterations of core_probe's loop, a few ms
QUERY_STAGES = {"host_prep": "host_prep", "dispatch": "dispatch",
                "device": "collect_wait", "device_get": "device_get",
                "host_tail": "host_tail"}  # StageTimer stage: metric
SEARCH_STAGES = ("search_prepare", "search_consolidate", "host_prep",
                 "dispatch", "host_tail", "host_oracle_fallback")
NOT_MEASURED = "not measured"  # a device metric of a CPU run
# analiticcl's default weight of the context rules, which a search_lm cell
# leaves as it is (the model holds no rules: their term is log 1)
CONTEXTRULES_WEIGHT = 1.0
# the top-level packages of JAX and of the JAX package, none of which a run
# may load
JAX_PACKAGES = ("jax", "jaxlib", "flax", "analiticcl_tpu")


def jax_modules(names) -> list:
    """The names among ``names`` of a module of JAX or the JAX package."""
    return sorted(n for n in names if n.split(".")[0] in JAX_PACKAGES)


# the JAX modules this process held before the script loaded: none when it
# runs as a script; where a test process imports it, those other tests loaded
PRELOADED = frozenset(() if __name__ == "__main__"
                      else jax_modules(list(sys.modules)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settled_view(passes: list, complete: bool) -> tuple:
    """The steady-state windows (``bench.py``'s rule): drop leading windows
    below 70 % of the median of the last three settled ones, and the final
    window of a completed stream, which drains in-flight batches without
    submitting new ones. Returns (indices, values); every window stays
    recorded."""
    n = len(passes)
    hi = n - 1 if (complete and n >= 4) else n
    lo = 0
    if hi >= 3:
        tail = sorted(passes[hi - 3:hi])[1]  # median of the last 3 settled
        while lo < hi - 2 and passes[lo] < 0.7 * tail:
            lo += 1
    idx = list(range(lo, hi))
    return idx, [passes[i] for i in idx]


def round_view(rounds: list) -> tuple:
    """The statistic over a command's rounds, each given as ``(work,
    seconds)``: (all the work over all the time, the metric; the median of
    the rounds' rates; max/min of the rates). Each round's rate is its own
    work over its own time. The metric keeps a round that a stall slowed
    whole, which the median would drop."""
    rates = [work / seconds for work, seconds in rounds]
    return (sum(w for w, _ in rounds) / sum(s for _, s in rounds),
            statistics.median(rates), max(rates) / min(rates))


def corrupt(word: str, rng: random.Random) -> str:
    """One deletion, transposition, insertion of ``x`` or substitution by
    ``q`` (``bench.py``'s corruption); words under 4 letters stay."""
    if len(word) < 4:
        return word
    i = rng.randrange(len(word) - 1)
    choice = rng.randrange(4)
    if choice == 0:
        return word[:i] + word[i + 1:]
    if choice == 1:
        return word[:i] + word[i + 1] + word[i] + word[i + 2:]
    if choice == 2:
        return word[:i] + "x" + word[i:]
    return word[:i] + "q" + word[i + 1:]


def corrupted(words, n: int, seed: int, tag, times: int = 1) -> list:
    """The first ``n`` of ``words`` (cycled), each corrupted ``times`` times
    by one generator seeded from (seed, tag)."""
    rng = random.Random(f"{seed}/{tag}")
    out = []
    for i in range(n):
        w = words[i % len(words)]
        for _ in range(times):
            w = corrupt(w, rng)
        out.append(w)
    return out


def cell_names(cells=CELLS_DIR) -> list:
    """The cells described in the directory ``cells``, by file name."""
    return sorted(p.stem for p in Path(cells).glob("*.json"))


def read_cell(name: str, cells=CELLS_DIR) -> SimpleNamespace:
    """The cell ``name`` as ``<cells>/<name>.json`` describes it; raises
    on a key missing or unknown to its mode. Every cell has CELL_KEYS:
    ``about`` (what it stands for), ``mode``, ``lexicon_entries`` (the
    seeded synthetic lexicon's size), ``thresholds`` (the anagram and edit
    rules, each ``["absolute", k]`` or ``["ratio_with_limit", ratio,
    limit]``), ``max_matches``, ``score_threshold`` and
    ``cutoff_threshold``. A ``query`` cell adds ``batch`` (queries per
    batch), ``window_queries``, ``windows`` (per round), ``base_every``
    (the base words: every n-th lexicon entry), ``gate_queries``, the W=12
    gate's ``w12_queries`` of ``w12_min_length`` letters or more at
    ``w12_thresholds``, and ``sample_every`` (every n-th result of a timed
    window is checked); a ``search`` cell ``max_ngram``, ``lines`` and
    ``passes`` (per round) and ``lines_checked`` (the leading lines of the
    gate pass and of every timed pass that are checked); a ``search_lm``
    cell those of ``search`` and ``bigrams`` (the language model's
    entries), ``lm_weight``, ``variantmodel_weight`` and ``max_seq``."""
    path = Path(cells) / f"{name}.json"
    spec = json.loads(path.read_text())
    want = set(CELL_KEYS) | set(MODE_KEYS.get(spec.get("mode"), ()))
    if spec.get("mode") not in MODE_KEYS or set(spec) != want:
        raise ValueError(f"{path}: mode {spec.get('mode')!r}, keys missing "
                         f"{sorted(want - set(spec))}, unknown "
                         f"{sorted(set(spec) - want)}")
    for key in ("thresholds", "w12_thresholds"):
        if key in spec:
            spec[key] = tuple(tuple(rule) for rule in spec[key])
    return SimpleNamespace(name=name, **spec)


def scoring(cell) -> dict:
    """The parameters ``Reference`` takes from ``cell``."""
    out = {"thresholds": cell.thresholds, "max_matches": cell.max_matches,
           "score_threshold": cell.score_threshold,
           "cutoff_threshold": cell.cutoff_threshold,
           "max_ngram": getattr(cell, "max_ngram", 1)}
    if hasattr(cell, "bigrams"):
        out.update({k: getattr(cell, k) for k in LM_SETTINGS},
                   contextrules_weight=CONTEXTRULES_WEIGHT)
    return out


# ---------------------------------------------------------------------------
# The plain reference. It is given the alphabet, the lexicon and, for a
# search_lm cell, the language model's entries, and shares no code with the
# port. It follows analiticcl's definitions for a model without
# confusables, variant lists or context rules, at the default weights (ld
# 0.5, lcs, prefix, suffix and case 0.125 each) and freq_weight 0:
# retrieval by anagram distance (L1 between character counts), unrestricted
# Damerau-Levenshtein distance with transpositions, the score, a stable rank
# in the lexicon's anagram-value order, the crop at max_matches with its tie
# rule and the cutoff threshold; for search, the byte-offset segmentation,
# hard-boundary batches, n-grams, the redundancy filter and the cheapest
# path through the lattice of each batch; with a language model, the
# max_seq cheapest paths, each path's perplexity under the bigram counts
# and the weighted log-space selection (analiticcl src/lib.rs:2088-2495,
# 2580-2674).
# ---------------------------------------------------------------------------

BOS, EOS, UNK = "<bos>", "<eos>", "<unk>"  # the vocabulary's special texts
SMOOTHING = math.log(1e-6)  # the log-probability of an unseen transition
MAX_ORDER = 5  # a language-model entry of more tokens is left out


def first_primes(n: int) -> list:
    primes, k = [], 2
    while len(primes) < n:
        if all(k % p for p in primes if p * p <= k):
            primes.append(k)
        k += 1
    return primes


def damerau_levenshtein(a: bytes, b: bytes) -> int:
    """Unrestricted Damerau-Levenshtein distance (Lowrance-Wagner)."""
    inf = len(a) + len(b)
    d = [[inf] * (len(b) + 2)]
    d += [[inf, i] + [0] * len(b) for i in range(len(a) + 1)]
    d[1] = [inf] + list(range(len(b) + 1))
    last_row = {}  # character: last row of a holding it
    for i in range(1, len(a) + 1):
        x, above, row = a[i - 1], d[i], d[i + 1]
        last_col = 0  # last column of b matching x in this row
        for j in range(1, len(b) + 1):
            y = b[j - 1]
            k, m = last_row.get(y, 0), last_col
            cost = 1
            if x == y:
                cost, last_col = 0, j
            row[j + 1] = min(above[j] + cost, row[j] + 1, above[j + 1] + 1,
                             d[k][m] + (i - k - 1) + 1 + (j - m - 1))
        last_row[x] = i
    return d[len(a) + 1][len(b) + 1]


def longest_common_substring(a: bytes, b: bytes) -> int:
    best = 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b):
            if x == y:
                cur[j + 1] = prev[j] + 1
                best = max(best, cur[j + 1])
        prev = cur
    return best


def common_prefix(a: bytes, b: bytes) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def resolve(rule: tuple, length: int) -> int:
    """An absolute distance for a query of ``length`` characters: absolute
    values are capped at half the length, ratios floored and capped."""
    if rule[0] == "absolute":
        return min(rule[1], length // 2)
    return min(int(length * rule[1]), rule[2])


class Reference:
    """Query and search results computed plainly from the lexicon, at the
    parameters ``params`` (``scoring``: the anagram and edit thresholds
    lookups take by default, max_matches, score_threshold,
    cutoff_threshold, max_ngram; with a language model also lm_weight,
    variantmodel_weight, contextrules_weight and max_seq). ``lm`` is the
    language model's entries, ``(text, frequency)`` with the words of a
    text joined by spaces, or None."""

    def __init__(self, alphabet, words, params: dict, freqs=None, lm=None):
        if any(len(c) != 1 for cls in alphabet for c in cls):
            raise ValueError("the reference takes one-character alphabets")
        self.inputs = (alphabet, words, params, freqs, lm)
        self.params = SimpleNamespace(**params)
        self.code = {c: i for i, cls in enumerate(alphabet) for c in cls}
        self.unknown = len(alphabet)
        primes = first_primes(len(alphabet) + 1)
        norms = [self.normalize(w) for w in words]
        # the index's order: anagram value (the product of one prime per
        # character class), then the order of the lexicon
        order = sorted(range(len(words)), key=lambda i: (
            math.prod(primes[c] for c in norms[i]), i))
        self.words = [words[i] for i in order]
        self.norms = [norms[i] for i in order]
        self.freqs = None if freqs is None else [float(freqs[i])
                                                 for i in order]
        lens = np.array([len(x) for x in self.norms])
        counts = np.zeros((len(words), len(alphabet) + 1), np.int16)
        np.add.at(counts, (np.repeat(np.arange(len(words)), lens),
                           np.frombuffer(b"".join(self.norms), np.uint8)), 1)
        # rows and character counts of the words of each length
        self.by_len = [(rows, counts[rows]) for rows in (
            np.nonzero(lens == n)[0] for n in range(lens.max() + 1))]
        self.memo = {}
        self.lm_entries = lm
        self.ngrams = self._language_model(words, lm or ())
        self.use_lm = bool(self.ngrams) and getattr(self.params, "lm_weight",
                                                    0) > 0

    def _language_model(self, words, lm) -> dict:
        """The n-gram counts of the language model's entries: each entry's
        words as tokens (a word outside the vocabulary as UNK), the
        frequencies of the entries that give the same tokens summed; an
        entry repeated keeps its largest frequency."""
        entries = {}
        for text, freq in lm:
            entries[text] = max(entries.get(text, freq), freq)
        self.vocab = set(words) | set(entries) | {BOS, EOS, UNK}
        if len(self.vocab) != len(set(words)) + len(entries) + 3:
            raise ValueError("the reference takes language-model entries "
                             "apart from the lexicon")
        counts = {}
        for text, freq in entries.items():
            ngram = self.tokens(text)
            if ngram is not None:
                counts[ngram] = counts.get(ngram, 0) + freq
        return counts

    def tokens(self, text: str):
        """The tokens of a vocabulary entry: its words, each itself if the
        vocabulary holds it and UNK if not; None above MAX_ORDER words."""
        parts = text.split(" ")
        if len(parts) > MAX_ORDER:
            return None
        return tuple(p if p in self.vocab else UNK for p in parts)

    def perplexity(self, tokens: list) -> float:
        """The perplexity of a token stream under the bigram counts: the
        log-probability of each transition (the joint count, over the first
        token's own count where that is at least the joint count; SMOOTHING
        where the bigram is unknown or a token is out of the vocabulary),
        summed in order, its negative mean."""
        logprob, n = 0.0, 0
        for t0, t1 in zip(tokens, tokens[1:]):
            n += 1
            joint = (None if t0 is None or t1 is None
                     else self.ngrams.get((t0, t1)))
            if joint is None:
                logprob += SMOOTHING
                continue
            prior = self.ngrams.get((t0,), 1)
            logprob += (math.log(joint) if prior < joint
                        else math.log(joint / prior))
        return -1.0 / n * logprob if n else 0.0

    def normalize(self, text: str) -> bytes:
        return bytes(self.code.get(c, self.unknown) for c in text)

    def lookup(self, text: str, rules: tuple = None) -> list:
        """``(text, dist_score, freq_score, via)`` tuples, best first, at
        the (anagram, edit) ``rules`` or the reference's thresholds."""
        key = (text, rules or self.params.thresholds)
        if key not in self.memo:
            self.memo[key] = self._lookup(*key)
        return self.memo[key]

    def _lookup(self, text: str, rules: tuple) -> list:
        q = self.normalize(text)
        n = len(q)
        if not n:
            return []
        k_ana, k_ed = resolve(rules[0], n), resolve(rules[1], n)
        # the anagram ball within the edit distance's length band (a
        # distance of k changes the length by at most k), in index order
        qc = np.bincount(np.frombuffer(q, np.uint8),
                         minlength=self.by_len[0][1].shape[1]).astype(np.int16)
        rows = sorted(row for rows, counts in self.by_len[
            max(n - k_ed, 0):n + k_ed + 1] for row in rows[
                np.abs(counts - qc).sum(axis=1) <= k_ana].tolist())
        found, max_freq = [], 0.0
        for row in rows:
            c = self.norms[row]
            ld = damerau_levenshtein(q, c)
            if ld > k_ed:
                continue
            word = self.words[row]
            dist = 0.0 if ld > n else 1.0 - ld / n
            score = (0.5 * dist
                     + 0.125 * (longest_common_substring(q, c) / n)
                     + 0.125 * (common_prefix(q, c) / n)
                     + 0.125 * (common_prefix(q[::-1], c[::-1]) / n)
                     + (0.125 if word[:1].islower() == text[:1].islower()
                        else 0.0)) / 1.0
            freq = 1.0 if self.freqs is None else self.freqs[row]
            max_freq = max(max_freq, freq)
            if score >= self.params.score_threshold:
                found.append([word, score, freq])
        for r in found:
            r[2] /= max_freq
        found.sort(key=lambda r: (-r[1], -r[2]))
        top = self.params.max_matches
        if 0 < top < len(found):
            last, cropped = found[top - 1][1], found[top][1]
            if cropped < last:
                del found[top:]
            else:  # ties at the crop: analiticcl's rule
                early = late = 0
                for i, r in enumerate(found):
                    if r[1] == cropped and early == 0:
                        early = i
                    if r[1] < cropped:
                        late = i
                        break
                if early > 0:
                    del found[early + 1:]
                elif late > 0:
                    del found[late + 1:]
        for i in range(1, len(found)):
            if found[i][1] <= found[0][1] / self.params.cutoff_threshold:
                del found[i:]
                break
        return [(w, s, f, None) for w, s, f in found]

    def search(self, text: str) -> list:
        """Per selected match: ``(text, begin, end, selected, n, variants)``,
        offsets in bytes."""
        return self.search_decoded(text)[0]

    def search_decoded(self, text: str) -> tuple:
        """``(matches, changed)``: ``search``'s matches, and whether the
        language model chose other than the cheapest path in some hard
        batch."""
        data = text.encode()
        bounds, start, pos = [], None, 0  # runs of non-letters
        for ch in text:
            if not ch.isalpha():
                start = pos if start is None else start
            elif start is not None:
                bounds.append((start, pos))
                start = None
            pos += len(ch.encode())
        bounds.append((start, pos) if start is not None else (pos, pos))
        out, changed, begin, first = [], False, 0, 0
        for i, (b, e) in enumerate(bounds):
            hard = i == len(bounds) - 1 or e - b > 1
            if hard and b != begin:
                path, lm = self._decode(data, bounds[first:i + 1], begin, b)
                out += path
                changed |= lm
                begin, first = e, i + 1
        return out, changed

    def _decode(self, data, bounds, begin, end) -> tuple:
        """``(path, changed)`` of a hard batch: its selected matches, and
        whether the language model chose other than the cheapest path."""
        matches = []  # [text, begin, end, n, variants]
        for n in range(1, self.params.max_ngram + 1):
            for seg in self._ngrams(data, bounds, begin, end, n):
                covered = [m[4] for m in matches if m[3] == 1
                           and m[1] >= seg[1] and m[2] <= seg[2]]
                redundant = n > 1 and all(v and v[0][1] >= 1.0
                                          for v in covered)
                matches.append(seg + [None if redundant
                                      else self.lookup(seg[0])])
        arcs = [[] for _ in range(len(bounds) + 1)]  # (target, cost, sym)
        symbols = []  # (match, variant index or None)
        for mi, (_, mb, me, _, variants) in enumerate(matches):
            prev = nxt = None
            for i, (b, e) in enumerate(bounds):
                if mb == e:
                    prev = i
                elif me == b:
                    nxt = i
            if nxt is None:
                continue
            span = nxt + 1 if prev is None else nxt - prev
            src = 0 if prev is None else prev + 1
            if variants:
                for vi, v in enumerate(variants):
                    arcs[src].append((nxt + 1, span + (1.0 - v[1]),
                                      len(symbols)))
                    symbols.append((mi, vi))
            elif span == 1:
                arcs[src].append((nxt + 1, float(span + 1), len(symbols)))
                symbols.append((mi, None))
        for i in range(len(bounds)):  # epsilon arcs: a failsafe path
            arcs[i].append((i + 1, 100.0, None))
        if self.use_lm:
            return self._lm_decode(data, bounds, end, matches, arcs, symbols)
        cost = [0.0] + [math.inf] * len(bounds)
        back = [None] * (len(bounds) + 1)
        for state in range(1, len(bounds) + 1):
            for src in range(state):
                for target, c, sym in arcs[src]:
                    if target == state and cost[src] + c < cost[state]:
                        cost[state] = cost[src] + c
                        back[state] = (src, sym)
        finals = [i + 1 for i, (b, e) in enumerate(bounds)
                  if b == end or e == end]
        state = min((cost[s], s) for s in finals)[1]
        path = []
        while state > 0:
            state, sym = back[state]
            if sym is not None:
                mi, vi = symbols[sym]
                t, mb, me, n, variants = matches[mi]
                path.append((t, mb, me, vi, n, variants))
        return path[::-1], False

    def _lm_decode(self, data, bounds, end, matches, arcs, symbols) -> tuple:
        """``(path, changed)`` of a batch under the language model: the
        max_seq cheapest paths (``nbest_paths``), each path's perplexity
        over BOS, the tokens of every selected match each followed by those
        of the boundary after it, and EOS; the path of the best weighted
        mean of the normalised variant, LM and context scores (the first of
        equals). A batch without arcs keeps its matches, none selected."""
        p = self.params
        if not symbols:
            return [(t, mb, me, None, n, variants)
                    for t, mb, me, n, variants in matches], False
        finals = [i + 1 for i, (b, e) in enumerate(bounds)
                  if b == end or e == end]
        costs, paths, perps = [], [], []
        for c, steps in nbest_paths(arcs, finals, max(1, p.max_seq)):
            path, tokens = [], [BOS]
            for sym, state in steps:
                mi, vi = symbols[sym]
                t, mb, me, n, variants = matches[mi]
                path.append((t, mb, me, vi, n, variants))
                tokens += ([None] if vi is None
                           else self.tokens(variants[vi][0]) or [])
                # the boundary the symbol's state stands for
                tokens += self._boundary_tokens(data, bounds[state - 1])
            costs.append(c)
            paths.append(path)
            perps.append(self.perplexity(tokens + [EOS]))
        best_perp = min([999999.0] + perps)
        best_cost = min([(len(bounds) - 1) * 2.0] + costs)
        weights = p.lm_weight + p.variantmodel_weight + p.contextrules_weight
        scores = []
        for c, perp in zip(costs, perps):
            if c <= 0:
                variant = 0.0
            elif best_cost <= 0:
                variant = -math.inf
            else:
                variant = math.log(best_cost / c)
            scores.append((p.lm_weight * math.log(best_perp / perp)
                           + p.variantmodel_weight * variant
                           + p.contextrules_weight * math.log(1.0))
                          / weights)
        best_score, pick = -99999999.0, -1
        for k, score in enumerate(scores):
            if score > best_score or pick < 0:
                best_score, pick = score, k
        return paths[pick], paths[pick] != paths[0]

    def _boundary_tokens(self, data, bound) -> list:
        """The tokens of a boundary's text, stripped: none if it is empty,
        its entry's if the vocabulary holds it, else one out of the
        vocabulary (None)."""
        text = data[bound[0]:bound[1]].decode().strip()
        if not text:
            return []
        if text not in self.vocab:
            return [None]
        return list(self.tokens(text) or ())

    @staticmethod
    def _ngrams(data, bounds, begin, end, n) -> list:
        """Segments of ``n`` tokens between ``begin`` and ``end`` (the
        batch's last boundary starts at ``end``, so at n <= 2 no segment
        is left after the last one)."""
        out = []
        for i in range(len(bounds) - n + 1):
            b = bounds[i + n - 1][0]
            seg = data[begin:b].decode()
            if seg and seg != " ":
                out.append([seg, begin, b, n])
            begin = bounds[i][1]
        return out


def nbest_paths(arcs: list, finals: list, nbest: int) -> list:
    """The ``nbest`` cheapest paths from state 0 to a state of ``finals``
    through the lattice whose state ``s`` has the arcs ``arcs[s]``
    (``(target, cost, symbol)``, targets above ``s``), cheapest first, each
    ``(cost, [(symbol, the state it leads to), ...])`` without the arcs of
    no symbol (None). Each state keeps its ``nbest`` cheapest hypotheses;
    equal costs keep the order of their source state, then of the arc
    among the source's arcs, then of the source's hypothesis, and the final
    states' hypotheses are taken by cost, state and hypothesis."""
    into = [[] for _ in arcs]  # per state: (source, cost, symbol)
    for src, out in enumerate(arcs):
        for target, c, sym in out:
            into[target].append((src, c, sym))
    # per state: (cost, source state, source hypothesis, symbol)
    hyps = [[(0.0, -1, -1, None)]]
    for state in range(1, len(arcs)):
        found = [(hyp[0] + c, src, h, sym) for src, c, sym in into[state]
                 for h, hyp in enumerate(hyps[src])]
        found.sort(key=lambda x: x[0])
        hyps.append(found[:nbest])
    paths = []
    for c, s, h in sorted((hyps[s][h][0], s, h) for s in finals
                          for h in range(len(hyps[s])))[:nbest]:
        steps = []
        while s > 0:
            _, src, sh, sym = hyps[s][h]
            if sym is not None:
                steps.append((sym, s))
            s, h = src, sh
        paths.append((c, steps[::-1]))
    return paths


_REFERENCE = None  # a reference process's own Reference


def _reference_start(inputs) -> None:
    global _REFERENCE
    _REFERENCE = Reference(*inputs)


def _job(ref, method: str, args: tuple):
    """One item of ``reference_answers``: a method of ``ref`` (``lookup``,
    ``search``, ``search_decoded``), or ``lines``: ``testing.synthetic_text``
    over its lexicon and language model, the search cells' traffic, made
    here because it takes about a second a pass."""
    if method == "lines":
        from analiticcl_tpu_torch.testing import synthetic_text

        return synthetic_text(ref.inputs[1], *args, ref.lm_entries)
    return getattr(ref, method)(*args)


def _reference_call(job):
    return _job(_REFERENCE, *job)


@contextlib.contextmanager
def reference_answers(ref):
    """``answers(method, items)``: ``_job`` over each tuple of ``items``,
    in order (``ref``'s ``lookup``, ``search`` or ``search_decoded``, or
    ``lines``). With WORKERS above 1, the items go to that many spawned
    processes (at most one fewer than the cores this process may run on),
    each with its own Reference over the same lexicon; the answers come
    back as an iterator that waits for them, so the caller can run the
    port meanwhile. The processes end with the block. The answers are the reference's either way: the check is
    the same, only sooner."""
    workers = min(WORKERS, len(os.sched_getaffinity(0)) - 1)
    if workers <= 1:
        yield lambda method, items: [_job(ref, method, a) for a in items]
        return
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    pool = ProcessPoolExecutor(workers, mp_context=get_context("spawn"),
                               initializer=_reference_start,
                               initargs=(ref.inputs,))
    try:
        yield lambda method, items: pool.map(
            _reference_call, [(method, a) for a in items],
            chunksize=max(1, len(items) // (8 * workers)))
    finally:
        pool.shutdown(cancel_futures=True)


def lexicon_file(path: str) -> tuple:
    """Words and frequencies of a lexicon TSV (text, then an optional
    frequency; a repeated text keeps its largest frequency)."""
    freqs = {}
    with open(path, encoding="utf-8") as f:
        for line in f.read().split("\n"):
            if line:
                text, *rest = line.split("\t")
                freq = int(rest[0]) if rest else 1
                freqs[text] = max(freqs.get(text, freq), freq)
    return list(freqs), list(freqs.values())


# ---------------------------------------------------------------------------
# Checks against the reference
# ---------------------------------------------------------------------------


def as_tuples(model, results) -> list:
    return [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
             r.via) for r in results]


def match_signature(model, out) -> list:
    """A line's search results as plain values: each match's text, offsets,
    selection, n-gram order and variant tuples."""
    return [(m.text, m.offset.begin, m.offset.end, m.selected, m.n,
             None if m.variants is None else as_tuples(model, m.variants))
            for m in out]


def hold(name: str, got: list, want: list, what: list) -> None:
    """Abort the run unless ``got`` equals ``want`` item for item."""
    bad = [(w, g, x) for g, x, w in zip(got, want, what) if g != x]
    if bad or len(got) != len(want):
        for w, g, x in bad[:10]:
            log(f"  MISMATCH {w!r}: reference={x} port={g}")
        raise SystemExit(f"{name}: {len(bad)} of {len(want)} results differ "
                         "from the reference; benchmark aborted")


def threshold(rule: tuple):
    from analiticcl_tpu_torch import DistanceThreshold

    if rule[0] == "absolute":
        return DistanceThreshold.absolute(rule[1])
    return DistanceThreshold.ratio_with_limit(rule[1], rule[2])


def search_parameters(cell, rules: tuple = None):
    """``cell``'s parameters, with the (anagram, edit) ``rules`` in place
    of its thresholds where they are given."""
    from analiticcl_tpu_torch import SearchParameters

    rules = rules or cell.thresholds
    changed = {k: getattr(cell, k) for k in ("max_ngram",) + LM_SETTINGS
               if hasattr(cell, k)}
    return SearchParameters(
        max_anagram_distance=threshold(rules[0]),
        max_edit_distance=threshold(rules[1]),
        max_matches=cell.max_matches, score_threshold=cell.score_threshold,
        cutoff_threshold=cell.cutoff_threshold, **changed)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


# the kernels every core call launches, by launch_counts' names
REQUIRED = ("k1", "k5", "k3", "k2_slots", "k4")


def launch_counts() -> dict:
    """The launch count each kernel wrapper of the port keeps: K1
    (``stage_a_masks``) in all and by instance, K5 (``query_planes``), K3
    (``resolve_pairs``), K2 (``dl_lcs``, either entry) and its slot entry
    (``dl_lcs_slots``), its pair-string entry (the difference), its wide
    path (``wide_path``) and K4 (``compact_survivors``)."""
    from analiticcl_tpu_torch.ops import pipeline
    from analiticcl_tpu_torch.ops.dl import dl_lcs, dl_lcs_slots, wide_path
    from analiticcl_tpu_torch.ops.stage_a import stage_a_masks

    by = stage_a_masks.launches_by_instance
    return {"k1": stage_a_masks.launches, "k1_main": by["main"],
            "k1_resident": by["resident"], "k1_stream": by["stream"],
            "k5": pipeline.query_planes.launches,
            "k3": pipeline.resolve_pairs.launches,
            "k2": dl_lcs.launches, "k2_slots": dl_lcs_slots.launches,
            "k2_pairs": dl_lcs.launches - dl_lcs_slots.launches,
            "k2_wide": wide_path.launches,
            "k4": pipeline.compact_survivors.launches}


def require_launches(moved: dict, what: str, wide: bool) -> dict:
    """``moved`` (the launches of one window or pass, by
    ``launch_counts``' names); raises unless every kernel of REQUIRED was
    launched, K5 as often as K1 and K4 as K3 (one output buffer per core
    call), K1's instances add up to its launches, and K2's wide path did
    not run unless the index holds a string over 64 letters (``wide``;
    where it does, the wrapper counts the wide path with every slot-entry
    launch, so its count is recorded and not held)."""
    missing = [k for k in REQUIRED if moved[k] <= 0]
    if missing:
        raise RuntimeError(f"{what}: a kernel was not launched "
                           f"({', '.join(missing)}): {moved}")
    if (moved["k5"], moved["k4"]) != (moved["k1"], moved["k3"]):
        raise RuntimeError(f"{what}: K5/K4 launches differ from K1/K3's: "
                           f"{moved}")
    if sum(moved[f"k1_{i}"] for i in ("main", "resident", "stream")) != (
            moved["k1"]):
        raise RuntimeError(f"{what}: K1's instances do not add up to its "
                           f"launches: {moved}")
    if not wide and moved["k2_wide"]:
        raise RuntimeError(f"{what}: K2's wide path ran on an index of L "
                           f"<= 64: {moved}")
    return moved


def launch_rules(model) -> dict:
    """``require_launches``' rules, from the built index alone: ``wide``
    where its strings are wider than K2's byte DP takes."""
    from analiticcl_tpu_torch.ops.dl import NARROW_LEN

    return {"wide": model._device.L > NARROW_LEN}


def index_shape(model) -> dict:
    """The device index's rows, string width L, plane width and widest
    block extent (the widest K1 launch), and the language model's n-grams,
    which hold no row."""
    pipe = model._device
    return {"rows": int(pipe.index.bins.shape[0]), "L": int(pipe.L),
            "plane_width": int(pipe.index.bins.shape[1]),
            "widest_block": int(pipe.index.extents_host.max()),
            "lm_ngrams": len(model.ngrams)}


def launches_since(before: dict, what: str, wide: bool) -> dict:
    """Launches of each kernel since ``before`` (``launch_counts``), held
    to ``require_launches``."""
    return require_launches({k: v - before[k] for k, v in
                             launch_counts().items()}, what, wide)


class Timed:
    """Host wall time of a block that ends with the card idle, and the
    host's readings (``host_window``) around it."""

    def __init__(self, device: str):
        self.device = device

    def __enter__(self):
        sync(self.device)
        self.probe_ms = core_probe()
        self.counters = host_counters()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.s = time.perf_counter() - self.t0
        self.host = {"probe_ms": self.probe_ms,
                     **host_window(self.counters, host_counters(), self.s)}


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The host's side of a window. Each reading is taken just before and just
# after a timed window or pass, never inside it, and goes into the record
# beside the stage times, not into a metric. A source this machine lacks
# reads NOT_MEASURED, never 0.
# ---------------------------------------------------------------------------


def read_proc(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def core_probe() -> float:
    """ms of a fixed pure-Python loop on this thread, taken before each
    window: the speed of the core the program runs on, apart from the
    program's own work."""
    t0 = time.perf_counter()
    x = 0
    for i in range(PROBE_LOOPS):
        x += i * i
    return (time.perf_counter() - t0) * 1e3


def host_counters() -> dict:
    """The process's cumulative counters: Python's collections per
    generation; CPU seconds (all threads, and the main thread alone),
    context switches and page faults from ``getrusage``. A kernel that
    keeps no switches or faults reports zeros since the process began,
    which no running process can have: those read NOT_MEASURED."""
    out = dict.fromkeys(("cpu_user_s", "cpu_sys_s", "cpu_main_thread_s",
                         "switches_voluntary", "switches_involuntary",
                         "faults_minor", "faults_major"), NOT_MEASURED)
    for g, st in enumerate(gc.get_stats()):
        out[f"gc_gen{g}"] = st["collections"]
    try:
        import resource
    except ImportError:
        return out
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out.update(cpu_user_s=ru.ru_utime, cpu_sys_s=ru.ru_stime)
    if ru.ru_nvcsw + ru.ru_nivcsw:
        out.update(switches_voluntary=ru.ru_nvcsw,
                   switches_involuntary=ru.ru_nivcsw)
    if ru.ru_minflt + ru.ru_majflt:
        out.update(faults_minor=ru.ru_minflt, faults_major=ru.ru_majflt)
    if hasattr(resource, "RUSAGE_THREAD"):
        th = resource.getrusage(resource.RUSAGE_THREAD)
        out["cpu_main_thread_s"] = th.ru_utime + th.ru_stime
    return out


def host_place(scheduled: bool) -> dict:
    """RSS, the core the main thread last ran on and the thread count, at
    the end of a window. The core is NOT_MEASURED where the kernel keeps
    no scheduler counts (``scheduled`` false): such a kernel reports core
    0 for every thread."""
    out = dict.fromkeys(("rss_mib", "last_core", "threads"), NOT_MEASURED)
    statm = read_proc("/proc/self/statm")
    if statm:
        out["rss_mib"] = (int(statm.split()[1]) * os.sysconf("SC_PAGE_SIZE")
                          / 2**20)
    stat = read_proc("/proc/self/stat")
    if stat and scheduled:  # fields after the command name (may hold " ")
        out["last_core"] = int(stat.rsplit(")", 1)[1].split()[36])  # field 39
    for line in (read_proc("/proc/self/status") or "").splitlines():
        if line.startswith("Threads:"):
            out["threads"] = int(line.split()[1])
    return out


def host_window(before: dict, after: dict, seconds: float) -> dict:
    """The host's readings for one window: the counters' differences, CPU
    seconds (all threads) per wall second, and where the process stood at
    its end."""
    out = {k: (after[k] - before[k] if NOT_MEASURED not in (before[k],
                                                            after[k])
               else NOT_MEASURED) for k in before}
    cpu = (out["cpu_user_s"], out["cpu_sys_s"])
    out["cpu_per_wall"] = (NOT_MEASURED if NOT_MEASURED in cpu
                           else sum(cpu) / seconds)
    return {**out, **host_place(out["switches_voluntary"] != NOT_MEASURED)}


def host_line(h: dict) -> str:
    """A window's host readings in one line of the log."""
    def f(key, fmt):
        return h[key] if h[key] == NOT_MEASURED else format(h[key], fmt)

    return (f"probe {h['probe_ms']:.2f} ms, cpu/wall "
            f"{f('cpu_per_wall', '.3f')} (main thread "
            f"{f('cpu_main_thread_s', '.3f')} s), switches "
            f"{h['switches_voluntary']}/{h['switches_involuntary']}, "
            f"faults {h['faults_minor']}/{h['faults_major']}, rss "
            f"{f('rss_mib', '.1f')} MiB, core {h['last_core']}, threads "
            f"{h['threads']}")


def cpu_list(text: str) -> list:
    """Cores of a kernel CPU list such as ``0-3,8``."""
    cores = []
    for part in text.strip().split(","):
        lo, _, hi = part.partition("-")
        cores += range(int(lo), int(hi or lo) + 1)
    return cores


def card_local_cpus(device: str):
    """``(PCI bus id, NUMA-local CPU list)`` of card 0 from ``nvidia-smi``
    (``00000000:1B:00.0``; sysfs names it ``0000:1b:00.0``) and sysfs;
    NOT_MEASURED for what cannot be read."""
    if device != "cuda":
        return NOT_MEASURED, NOT_MEASURED
    try:
        bus = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0].lower()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return NOT_MEASURED, NOT_MEASURED
    if not re.fullmatch(r"[0-9a-f]{4,8}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]", bus):
        return NOT_MEASURED, NOT_MEASURED  # "[n/a]" where it is hidden
    bus = bus[-12:]
    local = read_proc(f"/sys/bus/pci/devices/{bus}/local_cpulist")
    return bus, local.strip() if local else NOT_MEASURED


def host_state(metrics: dict, when: str) -> None:
    """The machine's load averages and the mean ``cpu MHz`` over the cores
    this process may run on, into ``metrics`` as ``loadavg_<when>`` and
    ``cpu_mhz_<when>``. Load averages of exactly 0 while this process runs
    are a kernel that keeps none: NOT_MEASURED."""
    try:
        load = list(os.getloadavg())
    except OSError:
        load = []
    mhz, core = {}, None
    for line in (read_proc("/proc/cpuinfo") or "").splitlines():
        key, _, value = line.partition(":")
        if key.strip() == "processor":
            core = int(value)
        elif key.strip() == "cpu MHz" and core is not None:
            mhz[core] = float(value)
    allowed = [mhz[c] for c in os.sched_getaffinity(0) if c in mhz]
    metrics[f"loadavg_{when}"] = (load if any(load) else NOT_MEASURED,
                                  "1/5/15-minute load")
    metrics[f"cpu_mhz_{when}"] = (statistics.mean(allowed) if allowed
                                  else NOT_MEASURED,
                                  "MHz, mean over the allowed cores")


def pin_host(device: str, metrics: dict) -> None:
    """Pins this process to card 0's NUMA-local cores (those of them it may
    run on), or keeps its present affinity where that list cannot be read,
    and sets torch's intra-op threads to TORCH_THREADS, as a GPU server is
    deployed. Records the cores, the affinity, the threads and where the
    affinity came from."""
    import torch

    bus, local = card_local_cpus(device)
    present = os.sched_getaffinity(0)
    cores = present & set(cpu_list(local)) if local != NOT_MEASURED else None
    if cores:
        os.sched_setaffinity(0, cores)
        source = "the card's NUMA-local cores"
    else:
        source = ("present affinity: the card's NUMA-local CPU list is "
                  + ("not readable" if local == NOT_MEASURED
                     else "outside it"))
    torch.set_num_threads(TORCH_THREADS)
    metrics.update({
        "host_cpu_count": (os.cpu_count() or NOT_MEASURED, "cores"),
        "host_affinity_cores": (len(os.sched_getaffinity(0)), "cores"),
        "host_affinity_source": (source, "affinity"),
        "torch_threads": (torch.get_num_threads(), "intra-op threads"),
        "card_pci_bus_id": (bus, "PCI bus id"),
        "card_local_cpulist": (local, "NUMA-local CPU list"),
    })
    log("host: " + ", ".join(f"{k} {metrics[k][0]}" for k in (
        "host_cpu_count", "host_affinity_cores", "host_affinity_source",
        "torch_threads", "card_pci_bus_id", "card_local_cpulist")))


# ---------------------------------------------------------------------------
# The profiled window: one extra window or pass after the timed ones and
# their check, on traffic of the same shape seeded apart, under one
# torch.profiler window opened here, so that its events come back in order
# for the idle gaps. It feeds no end-to-end metric: those are taken with the
# profiler off.
# ---------------------------------------------------------------------------

TOP_OPS = 8  # device operations listed, by total time
TOP_GAPS = 5  # idle gaps listed, longest first


@contextlib.contextmanager
def stage_spans(stats, spans: list):
    """Each ``StageTimer`` stage of ``stats`` also appends ``(name, start,
    end)`` on the host's ``perf_counter_ns`` clock to ``spans`` while the
    block runs. (A profiler range per stage would also count as device time
    in the profile: the profiler gives each range a device-side span over
    the kernels launched inside it.)"""
    plain = stats.stage

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter_ns()
        try:
            with plain(name):
                yield
        finally:
            spans.append((name, t0, time.perf_counter_ns()))

    stats.stage = stage
    try:
        yield
    finally:
        del stats.stage


def device_spans(events) -> list:
    """The intervals in which the card ran an operation of ``events``
    (overlaps merged), in order, in the profiler's microseconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    merged = []
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.device_type == cuda):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_gaps(events, stages, top: int = TOP_GAPS) -> list:
    """The ``top`` longest gaps between the card's operations, longest
    first: each gap's ms, its start in ms after the first operation began,
    and the ms that each host stage of ``stages`` (``(name, start, end)`` in
    the profiler's microseconds) overlaps it."""
    spans = device_spans(events)
    gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        during = {}
        for name, s, e in stages:
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                during[name] = during.get(name, 0.0) + overlap / 1e3
        out.append({"ms": (g1 - g0) / 1e3, "at_ms": (g0 - spans[0][0]) / 1e3,
                    "stages_ms": during})
    return out


def profiled_window(args, pipe, fn, metrics: dict) -> dict:
    """``fn()`` once under a ``torch.profiler`` window, the card
    synchronised before and after: the card's busy ms (the union of its
    operations' intervals) and its idle share of the window's wall into
    ``metrics``, and the top device operations and the longest idle gaps,
    each with the pipeline's host stages in it, for the record. An empty
    profiler range ``bench:clock`` at the start ties the host's clock to
    the profiler's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = args.device == "cuda"
    spans = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync(args.device)
    with stage_spans(pipe.stats, spans), profile(activities=activities) as p:
        with torch.profiler.record_function("bench:clock"):
            clock = time.perf_counter_ns()
        t0 = time.perf_counter()
        fn()
        sync(args.device)
        wall = (time.perf_counter() - t0) * 1e3
    busy = idle = ops = gaps = n_ops = NOT_MEASURED
    if cuda:
        events = p.events()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e - s for s, e in device_spans(kernels)) / 1e3
        idle = 1 - busy / wall
        by_name = {}
        for e in kernels:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.time_range.end - e.time_range.start) / 1e3)
        ops = [{"name": k, "ms": v} for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]]
        n_ops = len(kernels)
        (mark,) = [e.time_range.start for e in events
                   if e.name == "bench:clock"]
        gaps = idle_gaps(kernels, [
            (name, mark + (a - clock) / 1e3, mark + (b - clock) / 1e3)
            for name, a, b in spans])
    metrics["device_busy_ms"] = (busy, "ms in the profiled window")
    metrics["device_idle_share"] = (idle, "of the profiled window's wall")
    log(f"profiled window: wall {wall:.3f} ms, busy {busy} ms, "
        f"idle share {idle}")
    for op in ops if ops != NOT_MEASURED else ():
        log(f"  device op {op['ms']:.3f} ms: {op['name']}")
    for g in gaps if gaps != NOT_MEASURED else ():
        stages = ", ".join(f"{k} {v:.3f} ms" for k, v in
                           g["stages_ms"].items()) or "no stage"
        log(f"  idle gap {g['ms']:.3f} ms at +{g['at_ms']:.3f} ms: {stages}")
    return {"wall_ms": wall, "device_ops": n_ops, "top_ops": ops,
            "idle_gaps": gaps}


def environment(device: str) -> dict:
    """The record's account of where it ran: the card's name and power
    limit as ``nvidia-smi`` gives them, the versions and the commit."""
    import torch

    from analiticcl_tpu_torch.utils.provenance import stamp

    env = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device == "cuda":
        from analiticcl_tpu_torch.ops import _build

        env["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        env["nvcc"] = subprocess.run(
            [_build.nvcc_path(), "--version"], capture_output=True,
            text=True, check=True,
        ).stdout.strip().splitlines()[-1]
        env["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}
    else:
        env["card"] = "cpu run: no card, device metrics not measured"
        env["nvcc"] = None
        env["device"] = {"platform": "cpu", "kind": "cpu", "count": 0}
    return stamp(env)


def build_kernels(device: str, metrics: dict) -> dict:
    """Every kernel source of KERNEL_SOURCES built (one ``nvcc`` each, all
    started together) and loaded on the card, its time into ``metrics``
    as ``kernel_build_s``. Returns the builds done so far
    (``_build.build_seconds``), which ``require_no_build`` compares
    with later."""
    metrics["kernel_build_s"] = (NOT_MEASURED, "s")
    if device != "cuda":
        return {}
    from analiticcl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    metrics["kernel_build_s"] = (time.perf_counter() - t0, "s")
    return dict(_build.build_seconds)


def require_no_build(device: str, built: dict) -> None:
    """Raises if a kernel was built with ``nvcc`` after ``build_kernels``:
    its time would have gone into a gate or a timed window."""
    if device != "cuda":
        return
    from analiticcl_tpu_torch.ops import _build

    if _build.build_seconds != built:
        raise RuntimeError(f"a kernel was built after build_kernels: "
                           f"{sorted(set(_build.build_seconds) - set(built))}")


def require_no_jax() -> None:
    """Raises if a module of JAX or of the JAX package (JAX_PACKAGES) was
    loaded since the script loaded: the run measures the port alone."""
    loaded = [n for n in jax_modules(list(sys.modules)) if n not in PRELOADED]
    if loaded:
        raise RuntimeError(f"JAX or the JAX package was loaded during the "
                           f"run: {', '.join(loaded[:8])}")


def lexicon(args, cell) -> tuple:
    """``(words, freqs, label)``: ``--lexicon``'s, or the seeded synthetic
    lexicon of ``cell.lexicon_entries``."""
    from analiticcl_tpu_torch.testing import synthetic_lexicon

    if args.lexicon:
        words, freqs = lexicon_file(args.lexicon)
        return words, freqs, args.lexicon
    n = cell.lexicon_entries
    return synthetic_lexicon(args.seed, n), None, f"synthetic-{n // 1000}k"


def build_model(args, cell):
    """``(model, words, reference, lexicon label, metrics, built)``: every
    kernel built (``build_kernels``), then the model on the device backend,
    with both build times, and the reference over the same lexicon (and
    language model, where the cell has ``bigrams``) at ``cell``'s
    parameters."""
    from analiticcl_tpu_torch import VariantModel
    from analiticcl_tpu_torch.testing import (
        ALPHABET, populate, synthetic_bigrams,
    )
    from analiticcl_tpu_torch.vocab import VocabParams, VocabType

    metrics = {}
    built = build_kernels(args.device, metrics)
    words, freqs, label = lexicon(args, cell)
    bigrams = (synthetic_bigrams(words, args.seed, cell.bigrams)
               if hasattr(cell, "bigrams") else None)
    with Timed(args.device) as t:
        model = VariantModel(alphabet=ALPHABET, device=args.device)
        if args.lexicon:
            model.read_vocabulary(args.lexicon, VocabParams())
            for text, freq in bigrams or ():
                model.add_to_vocabulary(
                    text, freq, VocabParams(vocab_type=VocabType.LM))
            model.build()
        else:
            populate(model, words, bigrams=bigrams)
        model.set_backend("device")  # "auto" takes the oracle below 64 rows
        model._pipeline()
    metrics["build_s"] = (t.s, "s")
    log(f"model: {model.index.size} entries ({label}), "
        f"{len(model.ngrams)} n-grams, built in {t.s:.1f} s")
    t0 = time.perf_counter()
    reference = Reference(ALPHABET, words, scoring(cell), freqs, bigrams)
    metrics["reference_build_s"] = (time.perf_counter() - t0, "s")
    return model, words, reference, label, metrics, built


def freeze_heap(metrics: dict) -> None:
    from analiticcl_tpu_torch.utils.gc_tuning import freeze_model_heap

    frozen = freeze_model_heap()
    metrics["heap_frozen_objects"] = (frozen, "objects")
    log(f"gc: froze {frozen} model-heap objects")


def stage_ms(stats, before: dict, name: str) -> float:
    return (stats.totals.get(name, 0.0) - before.get(name, 0.0)) * 1e3


def peak_memory(device: str):
    import torch

    if device != "cuda":
        return (NOT_MEASURED, "MiB")
    return (torch.cuda.max_memory_allocated() / 2**20, "MiB")


def reset_peak_memory(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def query_gate(cell, model, queries, want, rules, name: str,
               metrics: dict) -> None:
    """Device results against the reference's answers ``want``, as full
    tuples; one difference aborts the run."""
    t0 = time.perf_counter()
    got = [as_tuples(model, r) for r in model.find_variants_stream(
        queries, search_parameters(cell, rules), cell.batch)]
    hold(f"gate {name}", got, list(want), queries)
    metrics[f"gate_{name}_s"] = (time.perf_counter() - t0, "s")
    log(f"gate {name}: {len(queries)} queries equal to the reference")


def query_round(args, cell, model, windows, params, r: int,
                rules: dict) -> tuple:
    """One timed block: one stream over ``windows``. Returns the round's
    record (its rate: the queries of its settled windows over their summed
    time; every window's details, its launches held to
    ``require_launches(**rules)``) and every ``cell.sample_every``-th
    result as plain tuples, so that what the harness keeps adds no objects
    for the collector to walk."""
    pipe, n = model._device, cell.window_queries
    stream = model.find_variants_stream(
        (q for qs in windows for q in qs), params, cell.batch)
    found = (pipe.candidates, pipe.survivors)
    seconds, details, kept = [], [], []
    sync(args.device)
    probe = core_probe()
    counters = host_counters()
    last = time.perf_counter()
    for w in range(cell.windows):
        before = launch_counts()
        stages = dict(pipe.stats.totals)
        oracle = pipe.stats.counts.get("host_oracle_fallback", 0)
        got = list(islice(stream, n))
        now = time.perf_counter()
        ended = host_counters()
        if len(got) != n:
            raise RuntimeError(f"round {r} window {w}: {len(got)} results "
                               f"for {n} queries")
        kept += [as_tuples(model, x) for x in got[::cell.sample_every]]
        del got
        seconds.append(now - last)
        details.append({
            "queries_per_s": n / seconds[-1], "seconds": seconds[-1],
            "launches": launches_since(before, f"round {r} window {w}",
                                       **rules),
            "host_oracle_fallback_count":
                pipe.stats.counts.get("host_oracle_fallback", 0) - oracle,
            **{f"{m}_ms": stage_ms(pipe.stats, stages, k)
               for k, m in QUERY_STAGES.items()},
            "host": {"probe_ms": probe,
                     **host_window(counters, ended, seconds[-1])},
        })
        log(f"round {r} window {w}: {details[-1]['queries_per_s']:.1f} q/s, "
            f"launches {details[-1]['launches']}, "
            f"{host_line(details[-1]['host'])}")
        probe = core_probe()
        counters = host_counters()
        last = time.perf_counter()
    sync(args.device)
    idx, _ = settled_view([d["queries_per_s"] for d in details],
                          complete=True)
    record = {
        "value": n * len(idx) / sum(seconds[i] for i in idx),
        "queries": n * len(idx), "seconds": sum(seconds[i] for i in idx),
        "settled_windows": [i + 1 for i in idx],
        "candidates_per_query": (pipe.candidates - found[0])
        / (cell.windows * n),
        "survivors_per_query": (pipe.survivors - found[1])
        / (cell.windows * n),
        "windows": details}
    log(f"round {r}: {record['value']:.1f} q/s over settled windows "
        f"{record['settled_windows']} of {cell.windows}")
    return record, kept


def query_cell(args, cell, model, words, ref, metrics: dict,
               rules: dict) -> tuple:
    """Gates and the reference's answers for every timed sample (computed
    while the gates run), heap freeze, warm-up, ROUNDS timed blocks, the
    samples of every round against the answers, then the profiled
    window."""
    params = search_parameters(cell)
    n, batch, seed = cell.window_queries, cell.batch, args.seed
    base = words[::cell.base_every]
    gate = corrupted(base, cell.gate_queries, seed, "gate")
    long_words = [w for w in base if len(w) >= cell.w12_min_length]
    gate12 = corrupted(long_words, cell.w12_queries, seed, "w12", times=2)
    # round r's window w is window r * windows + w of one seeded sequence:
    # each round's queries are fresh, round 0's are those of a single
    # timed block
    windows = [[corrupted(base, n, seed, r * cell.windows + w)
                for w in range(cell.windows)] for r in range(ROUNDS)]
    sample = [q for block in windows for qs in block
              for q in qs[::cell.sample_every]]
    t0 = time.perf_counter()
    with reference_answers(ref) as answers:
        want_gate = answers("lookup", [(q, cell.thresholds) for q in gate])
        want12 = answers("lookup", [(q, cell.w12_thresholds)
                                    for q in gate12])
        want = answers("lookup", [(q, cell.thresholds) for q in sample])
        query_gate(cell, model, gate, want_gate, cell.thresholds, "query",
                   metrics)
        query_gate(cell, model, gate12, want12, cell.w12_thresholds, "w12",
                   metrics)
        want = list(want)
    metrics["reference_answers_s"] = (time.perf_counter() - t0, "s")
    freeze_heap(metrics)

    pipe = model._device
    for i in range(2 + pipe.DEESC_N):  # until the pair budgets settle
        model.find_variants_batch(gate[:batch], params)
    log(f"warm: budgets (P, P2) {pipe._P_by_B} {pipe._P2_by_B}")
    pipe.stats.clear()
    pipe.candidates = pipe.survivors = 0
    reset_peak_memory(args.device)
    host_state(metrics, "before_timed")
    rounds, kept = [], []
    for r, block in enumerate(windows):
        record, results = query_round(args, cell, model, block, params, r,
                                      rules)
        rounds.append(record)
        kept += results
    host_state(metrics, "after_timed")

    t0 = time.perf_counter()
    hold("timed windows", kept, want, sample)
    metrics["check_timed_s"] = (time.perf_counter() - t0, "s")
    log(f"timed windows: {len(sample)} sampled results of {ROUNDS} rounds "
        "equal to the reference")

    every = [d for rd in rounds for d in rd["windows"]]
    settled = [rd["windows"][i - 1] for rd in rounds
               for i in rd["settled_windows"]]
    rates = [d["queries_per_s"] for d in settled]
    overall, median, spread = round_view(
        [(rd["queries"], rd["seconds"]) for rd in rounds])
    n_batches = len(every) * n // batch
    metrics.update({
        "query_throughput": (overall, "queries/s"),
        "query_throughput_round_median": (median, "queries/s"),
        "query_throughput_round_spread": (spread, "max/min of the rounds"),
        "query_throughput_all_windows": (
            n * len(every) / sum(d["seconds"] for d in every), "queries/s"),
        "query_throughput_window_median": (statistics.median(rates),
                                           "queries/s"),
        "query_throughput_spread": (max(rates) / min(rates),
                                    "max/min of the settled windows"),
        "settled_windows": (len(settled), "windows"),
        **{f"{m}_ms": (pipe.stats.totals.get(k, 0.0) * 1e3 / n_batches,
                       "ms per batch") for k, m in QUERY_STAGES.items()},
        **{f"{k}_launches_per_window": (statistics.mean(
            d["launches"][k] for d in every), "launches per window")
           for k in every[0]["launches"]},
        "host_oracle_fallback_count": (statistics.mean(
            d["host_oracle_fallback_count"] for d in every),
            "lookups per window"),
        # round 0's: its traffic is that of a single timed block, as
        # before rounds (every round's is in its record)
        "candidates_per_query": (rounds[0]["candidates_per_query"],
                                 "per query"),
        "survivors_per_query": (rounds[0]["survivors_per_query"],
                                "per query"),
        "peak_device_memory": peak_memory(args.device),
    })
    profiled = corrupted(base, n, seed, "profiled")
    profile = profiled_window(args, pipe, lambda: list(
        model.find_variants_stream(profiled, params, batch)), metrics)
    return "query_throughput", {
        "rounds": rounds, "batch": batch, "profiled": profile,
        "checked": {"gate_query": len(gate), "gate_w12": len(gate12),
                    "timed_sample": len(sample)}}


def search_round(args, cell, model, passes, params, r: int,
                 rules: dict) -> tuple:
    """One timed block: ``passes``, each one ``find_all_matches_stream``.
    Returns the round's record (its rate: all its tokens over the passes'
    summed time; every pass's details, its launches held to
    ``require_launches(**rules)``) and each pass's first
    ``cell.lines_checked`` results as plain values
    (``match_signature``)."""
    pipe = model._device
    details, kept = [], []
    for p, texts in enumerate(passes):
        before = launch_counts()
        stages = dict(pipe.stats.totals)
        fallbacks = pipe.stats.counts.get("host_oracle_fallback", 0)
        with Timed(args.device) as t:
            out = list(model.find_all_matches_stream(texts, params))
        if len(out) != len(texts):
            raise RuntimeError(f"round {r} pass {p}: {len(out)} results for "
                               f"{len(texts)} lines")
        kept += [match_signature(model, x)
                 for x in out[:cell.lines_checked]]
        del out
        tokens = sum(len(text.split()) for text in texts)
        details.append({
            "tokens_per_s": tokens / t.s, "seconds": t.s, "tokens": tokens,
            "launches": launches_since(before, f"round {r} pass {p}",
                                       **rules),
            "host_oracle_fallback_count":
                pipe.stats.counts.get("host_oracle_fallback", 0) - fallbacks,
            **{f"{k}_ms": stage_ms(pipe.stats, stages, k)
               for k in SEARCH_STAGES},
            "host": t.host,
        })
        log(f"round {r} pass {p}: {tokens} tokens, {tokens / t.s:.1f} "
            f"tokens/s, launches {details[-1]['launches']}, "
            f"{host_line(t.host)}")
    seconds = sum(d["seconds"] for d in details)
    tokens = sum(d["tokens"] for d in details)
    log(f"round {r}: {tokens / seconds:.1f} tokens/s")
    return {"value": tokens / seconds, "seconds": seconds, "tokens": tokens,
            "passes": details}, kept


def search_cell(args, cell, model, words, ref, metrics: dict,
                rules: dict) -> tuple:
    """Gate on a warm-up pass, while the reference's processes make every
    timed pass's lines and then answer their leading lines; heap freeze,
    ROUNDS timed blocks, the leading lines of every pass against the
    answers, then the profiled pass. With a language model (a
    ``search_lm`` cell) the run aborts unless the model changed the
    reference's choice on some checked line."""
    from analiticcl_tpu_torch.testing import synthetic_text

    params = search_parameters(cell)
    head, n_lines, n_passes = cell.lines_checked, cell.lines, cell.passes
    warm = synthetic_text(words, (args.seed, n_passes), n_lines,
                          ref.lm_entries)
    t0 = time.perf_counter()
    with reference_answers(ref) as answers:
        want_gate = answers("search_decoded", [(t,) for t in warm[:head]])
        # round r's pass p: fresh lines from (seed, r, p), apart from the
        # warm-up's (seed, passes)
        lines = answers("lines", [((args.seed, r, p), n_lines)
                                  for r in range(ROUNDS)
                                  for p in range(n_passes)])
        got = list(model.find_all_matches_stream(warm, params))
        if len(got) != len(warm):
            raise RuntimeError(f"warm-up: {len(got)} results for "
                               f"{len(warm)} lines")
        lines = list(lines)
        passes = [lines[r * n_passes:(r + 1) * n_passes]
                  for r in range(ROUNDS)]
        heads = [t for texts in lines for t in texts[:head]]
        want = answers("search_decoded", [(t,) for t in heads])
        want_gate = list(want_gate)
        hold("gate search", [match_signature(model, o) for o in got[:head]],
             [m for m, _ in want_gate], warm[:head])
        metrics["gate_search_s"] = (time.perf_counter() - t0, "s")
        log(f"gate search: {head} lines equal to the reference")
        want = list(want)
    metrics["reference_answers_s"] = (time.perf_counter() - t0, "s")
    freeze_heap(metrics)

    pipe = model._device
    pipe.stats.clear()
    reset_peak_memory(args.device)
    host_state(metrics, "before_timed")
    rounds, kept = [], []
    for r, block in enumerate(passes):
        record, outs = search_round(args, cell, model, block, params, r,
                                    rules)
        rounds.append(record)
        kept += outs
    host_state(metrics, "after_timed")

    t0 = time.perf_counter()
    hold("timed passes", kept, [m for m, _ in want], heads)
    metrics["check_timed_s"] = (time.perf_counter() - t0, "s")
    log(f"timed passes: {head} lines of each pass of {ROUNDS} rounds equal "
        "to the reference")
    checked = {"gate_lines": head, "timed_lines": len(heads)}
    if ref.use_lm:
        changed = sum(c for _, c in want_gate + want)
        log(f"language model: {changed} of {head + len(heads)} checked lines "
            "chose other than the cheapest path")
        if not changed:
            raise SystemExit(f"lm: the language model chose the cheapest "
                             f"path on all {head + len(heads)} checked "
                             "lines; benchmark aborted")
        metrics["lm_changed_lines"] = (changed, "lines")
        checked["lm_changed_lines"] = changed

    every = [d for rd in rounds for d in rd["passes"]]
    seconds = sum(d["seconds"] for d in every)
    rates = [d["tokens_per_s"] for d in every]
    overall, median, spread = round_view(
        [(rd["tokens"], rd["seconds"]) for rd in rounds])
    metrics.update({
        "search_throughput": (overall, "tokens/s"),
        "search_throughput_round_median": (median, "tokens/s"),
        "search_throughput_round_spread": (spread, "max/min of the rounds"),
        "search_lines_per_s": (n_lines * len(every) / seconds, "lines/s"),
        "search_throughput_pass_median": (statistics.median(rates),
                                          "tokens/s"),
        "search_throughput_spread": (max(rates) / min(rates),
                                     "max/min of the passes"),
        **{f"{k}_ms": (statistics.mean(d[f"{k}_ms"] for d in every),
                       "ms per pass") for k in SEARCH_STAGES},
        "host_oracle_fallback_count": (statistics.mean(
            d["host_oracle_fallback_count"] for d in every),
            "lookups per pass"),
        **{f"{k}_launches_per_pass": (statistics.mean(
            d["launches"][k] for d in every), "launches per pass")
           for k in every[0]["launches"]},
        "peak_device_memory": peak_memory(args.device),
    })
    profiled = synthetic_text(words, (args.seed, n_passes + 1), n_lines,
                              ref.lm_entries)
    profile = profiled_window(args, pipe, lambda: list(
        model.find_all_matches_stream(profiled, params)), metrics)
    return "search_throughput", {
        "rounds": rounds, "profiled": profile, "checked": checked}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True,
                    help="a cell: a file <cell>.json in --cells")
    ap.add_argument("--cells", default=str(CELLS_DIR),
                    help="the directory of the cells' files (default "
                         "bench_cells/ beside this script)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the workload seed: lexicon, queries and text")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda; no fallback)")
    ap.add_argument("--lexicon", default=None,
                    help="a lexicon file instead of the seeded synthetic one")
    args = ap.parse_args(argv)
    if args.cell not in cell_names(args.cells):
        ap.error(f"--cell {args.cell}: no such cell in {args.cells} "
                 f"({', '.join(cell_names(args.cells))})")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: --device cuda, but "
                           "torch.cuda.is_available() is false")
    prior = (os.sched_getaffinity(0), torch.get_num_threads())
    host = {}
    try:
        pin_host(args.device, host)  # before anything is built
        return run(args, host)
    finally:
        os.sched_setaffinity(0, prior[0])
        torch.set_num_threads(prior[1])


def run(args, host: dict) -> int:
    env = environment(args.device)
    log(env["card"])
    cell = read_cell(args.cell, args.cells)
    model, words, ref, label, metrics, built = build_model(args, cell)
    metrics.update(host)
    rules = launch_rules(model)
    drive = {"query": query_cell, "search": search_cell,
             "search_lm": search_cell}[cell.mode]
    try:
        name, extra = drive(args, cell, model, words, ref, metrics, rules)
    finally:
        gc.unfreeze()
    require_no_build(args.device, built)
    require_no_jax()
    # every check above aborts the run on one difference
    print(f"gates: passed | {env['card']}")
    for key, (value, unit) in metrics.items():
        print(f"{key}: {value} {unit}" if value != NOT_MEASURED
              else f"{key}: {value} ({unit})")
    value, unit = metrics[name]
    record = {
        "cell": args.cell, "metric": name, "value": value, "unit": unit,
        "statistic": f"all the work of {ROUNDS} rounds over their time",
        "correct": True, "impl": "analiticcl_tpu_torch", "lexicon": label,
        "seed": args.seed,
        "settings": {"affinity": sorted(os.sched_getaffinity(0)),
                     "affinity_source": host["host_affinity_source"][0],
                     "torch_threads": TORCH_THREADS, "rounds": ROUNDS},
        "cell_spec": vars(cell), "kernel_sources": list(KERNEL_SOURCES),
        "launch_rules": rules,
        "index": index_shape(model),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in
                    metrics.items()},
        **extra, **env,
    }
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
