"""Prime-product anagram values of character-count vectors.

The port's copy of ``analiticcl_tpu/anahash.py``, cut to what the port uses.

The reference (src/anahash.rs) represents a bag of characters as a product of
per-character primes over an arbitrary-precision integer. The engine works on
dense count vectors; these two conversions give the reference's bigint value
for stable canonical ordering of anagram groups (the index sorts anagrams by
their bigint value, mirroring the reference's BTreeSet/sorted secondary index
ordering, lib.rs:1149/222-245) and back.
"""

from __future__ import annotations

import numpy as np

from .types import PRIMES


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
