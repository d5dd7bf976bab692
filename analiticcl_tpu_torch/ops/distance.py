"""String distance metrics — host oracle implementations.

The port's copy of ``analiticcl_tpu/ops/distance.py``.

These are exact, scalar reference implementations used for (a) numeric-parity
tests against the batched device kernels and (b) small host-side fallbacks.
Semantics match reference src/distance.rs:

  - levenshtein                      distance.rs:7-82   (None above max_distance)
  - damerau_levenshtein              distance.rs:101-179 (unrestricted DL with
    last-occurrence table; transpositions cost 1; None above max_distance)
  - longest_common_substring_length  distance.rs:181-205
  - common_prefix_length / common_suffix_length  distance.rs:208-231
"""

from __future__ import annotations

from typing import Optional, Sequence


def levenshtein(a: Sequence[int], b: Sequence[int], max_distance: int) -> Optional[int]:
    if list(a) == list(b):
        return 0
    la, lb = len(a), len(b)
    if la == 0:
        return lb if lb <= max_distance else None
    if la > lb and la - lb > max_distance:
        return None
    if lb == 0:
        return la if la <= max_distance else None
    if lb > la and lb - la > max_distance:
        return None

    cache = list(range(1, la + 1))
    result = 0
    for ib, eb in enumerate(b):
        result = ib
        dist_a = ib
        for ia, ea in enumerate(a):
            dist_b = dist_a if ea == eb else dist_a + 1
            dist_a = cache[ia]
            if dist_a > result:
                result = result + 1 if dist_b > result else dist_b
            elif dist_b > dist_a:
                result = dist_a + 1
            else:
                result = dist_b
            cache[ia] = result
    return result if result <= max_distance else None


def damerau_levenshtein(
    s: Sequence[int], t: Sequence[int], max_distance: int
) -> Optional[int]:
    len_s, len_t = len(s), len(t)
    if len_s == 0:
        return len_t if len_t <= max_distance else None
    if len_s > len_t and len_s - len_t > max_distance:
        return None
    if len_t == 0:
        return len_s if len_s <= max_distance else None
    if len_t > len_s and len_t - len_s > max_distance:
        return None

    big = len_s + len_t
    # (len_s+2) x (len_t+2) matrix with sentinel row/col of `big`
    mat = [[0] * (len_t + 2) for _ in range(len_s + 2)]
    mat[0][0] = big
    for i in range(len_s + 1):
        mat[i + 1][0] = big
        mat[i + 1][1] = i
    for j in range(len_t + 1):
        mat[0][j + 1] = big
        mat[1][j + 1] = j

    char_map: dict = {}
    for i1, s_char in enumerate(s):
        db = 0
        i = i1 + 1
        for j1, t_char in enumerate(t):
            j = j1 + 1
            last = char_map.get(t_char, 0)
            cost = 0 if s_char == t_char else 1
            mat[i + 1][j + 1] = min(
                mat[i + 1][j] + 1,  # deletion
                mat[i][j + 1] + 1,  # insertion
                mat[i][j] + cost,  # substitution
                mat[last][db] + (i - last - 1) + 1 + (j - db - 1),  # transposition
            )
            if cost == 0:
                db = j
        char_map[s_char] = i

    result = mat[len_s + 1][len_t + 1]
    return result if result <= max_distance else None


def longest_common_substring_length(s1: Sequence[int], s2: Sequence[int]) -> int:
    lcs = 0
    n1, n2 = len(s1), len(s2)
    for i in range(n1):
        for j in range(n2):
            if s1[i] == s2[j]:
                tmp = 1
                ti, tj = i + 1, j + 1
                while ti < n1 and tj < n2 and s1[ti] == s2[tj]:
                    tmp += 1
                    ti += 1
                    tj += 1
                if tmp > lcs:
                    lcs = tmp
    return lcs


def common_prefix_length(s1: Sequence[int], s2: Sequence[int]) -> int:
    n = min(len(s1), len(s2))
    out = 0
    for i in range(n):
        if s1[i] == s2[i]:
            out += 1
        else:
            break
    return out


def common_suffix_length(s1: Sequence[int], s2: Sequence[int]) -> int:
    n = min(len(s1), len(s2))
    out = 0
    for i in range(n):
        if s1[len(s1) - i - 1] == s2[len(s2) - i - 1]:
            out += 1
        else:
            break
    return out
