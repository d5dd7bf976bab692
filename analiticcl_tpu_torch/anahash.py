"""Anagram-value algebra over character-count vectors.

The port's copy of ``analiticcl_tpu/anahash.py``.

The reference (src/anahash.rs) represents a bag of characters as a product of
per-character primes over an arbitrary-precision integer; insertion is multiply,
deletion is divide, containment is a modulo test. Here the canonical value is a
dense count vector ``c`` (uint8, one slot per alphabet class + UNK):

    insert      -> elementwise add                   (anahash.rs:146-152)
    delete      -> elementwise subtract, valid iff   (anahash.rs:156-162)
                   ``all(self >= value)``
    contains    -> ``all(self >= value)``            (anahash.rs:165-171)
    char_count  -> ``sum(c)``                        (anahash.rs:108-110)
    empty       -> zero vector                       (anahash.rs:252-254)

A prime-product compatibility layer (`counts_to_anavalue`, `anahash`) is kept
because Python integers are arbitrary precision, making the reference's bigint
semantics free to reproduce for tests and for stable canonical ordering of
anagram values (the index sorts anagrams by their bigint value, mirroring the
reference's BTreeSet/sorted secondary index ordering, lib.rs:1149/222-245).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from .alphabet import Alphabet, AlphabetEncoder
from .types import PRIMES


def anahash(text: str, alphabet: Alphabet) -> int:
    """Prime-product anagram hash of a string (anahash.rs:16-47)."""
    enc = AlphabetEncoder(alphabet)
    return counts_to_anavalue(enc.count_vector(text))


def normalize_to_alphabet(text: str, alphabet: Alphabet) -> List[int]:
    """Normalize a string via the alphabet (anahash.rs:50-80)."""
    return AlphabetEncoder(alphabet).normalize(text)


def character(seqnr: int) -> int:
    """Anagram value of the n'th alphabet entry (anahash.rs:141-143)."""
    return PRIMES[seqnr]


def empty_anavalue() -> int:
    """The empty anagram value (anahash.rs:252-254)."""
    return 1


def av_insert(a: int, b: int) -> int:
    """Insert characters represented by ``b`` (anahash.rs:146-152)."""
    if a == 0:
        return b
    return a * b


def av_contains(a: int, b: int) -> bool:
    """Containment test (anahash.rs:165-171)."""
    if b > a:
        return False
    return a % b == 0


def av_delete(a: int, b: int):
    """Delete characters represented by ``b``; None if absent (anahash.rs:156-162)."""
    if av_contains(a, b):
        return a // b
    return None


def counts_to_anavalue(counts: np.ndarray) -> int:
    """Convert a count vector to the reference's prime-product bigint."""
    value = 1
    for idx in np.nonzero(counts)[0]:
        value *= PRIMES[int(idx)] ** int(counts[idx])
    return value


def anavalue_to_counts(value: int, alphabet_size: int) -> np.ndarray:
    """Factorize a prime-product anagram value back into a count vector."""
    counts = np.zeros(alphabet_size, dtype=np.uint8)
    for idx in range(alphabet_size):
        p = PRIMES[idx]
        while value % p == 0:
            value //= p
            counts[idx] += 1
    return counts


# ---------------------------------------------------------------------------
# Count-vector algebra (the engine-native form)
# ---------------------------------------------------------------------------

def cv_contains(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(a >= b))


def cv_insert(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


def cv_delete(a: np.ndarray, b: np.ndarray):
    if cv_contains(a, b):
        return a - b
    return None


def cv_char_count(a: np.ndarray) -> int:
    return int(a.sum())


def cv_is_empty(a: np.ndarray) -> bool:
    return not a.any()


def cv_alphabet_upper_bound(a: np.ndarray) -> Tuple[int, int]:
    """(max char index used, char count) — reference anahash.rs:126-136."""
    nz = np.nonzero(a)[0]
    maxcharindex = int(nz[-1]) if len(nz) else 0
    return maxcharindex, int(a.sum())


def cv_anagram_distance(a: np.ndarray, b: np.ndarray) -> int:
    """L1 distance between two count vectors.

    This is the anagram distance the reference explores through its deletion
    BFS + insertion sweep (lib.rs:1143-1308): an index entry is reachable from
    the query within ``k`` insertions/deletions iff the L1 distance of their
    count vectors is <= k.
    """
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def deletion_neighborhood(
    counts: np.ndarray, max_distance: int, min_distance: int = 1
) -> Iterable[Tuple[np.ndarray, int]]:
    """All unique multiset-deletions of ``counts`` within the distance band,
    in breadth-first order with per-level descending-char-index expansion.

    Reproduces the visit order of the reference's RecurseDeletionIterator in
    BFS/unique/no-empty-leaves mode (iterators.rs:150-187), which is what
    find_nearest_anahashes uses (lib.rs:1202-1213).
    """
    seen = {counts.tobytes()}
    frontier: List[np.ndarray] = [counts]
    depth = 0
    while frontier and depth < max_distance:
        depth += 1
        next_frontier: List[np.ndarray] = []
        for vec in frontier:
            # descending char index (iterators.rs:54-69)
            for idx in np.nonzero(vec)[0][::-1]:
                child = vec.copy()
                child[idx] -= 1
                key = child.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                next_frontier.append(child)
                if depth >= min_distance and child.any():
                    yield child, depth
        frontier = next_frontier
