"""Core types and configuration for the TPU-native analiticcl rebuild.

The port's copy of ``analiticcl_tpu/types.py``.

Behavioral parity targets (reference: proycon/analiticcl v0.4.9):
  - Weights                   reference src/types.rs:39-73
  - DistanceThreshold         reference src/types.rs:75-108
  - SearchParameters          reference src/types.rs:110-287
  - Distance                  reference src/types.rs:289-305
  - StopCriterion             reference src/types.rs:307-313
  - VariantReference          reference src/types.rs:315-324
  - VariantResult             reference src/types.rs:326-366
  - NGram                     reference src/types.rs:369-532 (we use plain tuples)
  - PRIMES table              reference src/types.rs:20-30 (kept only for the
    bigint-compatibility layer in anahash.py; the engine itself uses count vectors)

The representational shift: the reference encodes a bag-of-characters as a product of
per-character primes over an arbitrary-precision integer (``AnaValue``). Here the canonical
representation is a dense uint8 *character-count vector* ``c`` of size ``alphabet_size``;
prime products survive only as a derived value (Python ints are arbitrary precision) for
API/test compatibility.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

# Vocabulary IDs are plain Python ints (reference: u64, types.rs:11)
VocabId = int

# First 168 primes (reference types.rs:20-30). Only used by the AnaValue
# compatibility layer; the engine operates on count vectors.
PRIMES: Tuple[int, ...] = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
    331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
    421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
    509, 521, 523, 541, 547, 557, 563, 569, 571, 577, 587, 593, 599, 601, 607,
    613, 617, 619, 631, 641, 643, 647, 653, 659, 661, 673, 677, 683, 691, 701,
    709, 719, 727, 733, 739, 743, 751, 757, 761, 769, 773, 787, 797, 809, 811,
    821, 823, 827, 829, 839, 853, 857, 859, 863, 877, 881, 883, 887, 907, 911,
    919, 929, 937, 941, 947, 953, 967, 971, 977, 983, 991, 997,
)

# Absolute caps, matching reference lib.rs:43-46
MAX_ANAGRAM_DISTANCE = 12
MAX_EDIT_DISTANCE = 12


@dataclass
class Weights:
    """Score-component weights (reference types.rs:39-73)."""

    ld: float = 0.5
    lcs: float = 0.125
    prefix: float = 0.125
    suffix: float = 0.125
    case: float = 0.125

    def sum(self) -> float:
        return self.ld + self.lcs + self.prefix + self.suffix + self.case


class ThresholdKind(enum.Enum):
    RATIO = "ratio"
    RATIO_WITH_LIMIT = "ratio_with_limit"
    ABSOLUTE = "absolute"


@dataclass(frozen=True)
class DistanceThreshold:
    """Absolute | ratio-of-length | ratio-with-cap threshold.

    Parse grammar matches reference types.rs:85-108: ``"3"`` (absolute),
    ``"0.3"`` (ratio in [0,1]), ``"0.3;5"`` (ratio with absolute cap).
    """

    kind: ThresholdKind
    ratio: float = 0.0
    limit: int = 0

    @staticmethod
    def absolute(value: int) -> "DistanceThreshold":
        return DistanceThreshold(ThresholdKind.ABSOLUTE, limit=int(value))

    @staticmethod
    def ratio_of(value: float) -> "DistanceThreshold":
        return DistanceThreshold(ThresholdKind.RATIO, ratio=float(value))

    @staticmethod
    def ratio_with_limit(ratio: float, limit: int) -> "DistanceThreshold":
        return DistanceThreshold(
            ThresholdKind.RATIO_WITH_LIMIT, ratio=float(ratio), limit=int(limit)
        )

    @staticmethod
    def parse(s: Union[str, int, float, "DistanceThreshold"]) -> "DistanceThreshold":
        if isinstance(s, DistanceThreshold):
            return s
        if isinstance(s, bool):
            raise ValueError("invalid distance threshold")
        if isinstance(s, int):
            return DistanceThreshold.absolute(s)
        if isinstance(s, float):
            if 0.0 <= s <= 1.0:
                return DistanceThreshold.ratio_of(s)
            raise ValueError("ratio threshold must be between 0.0 and 1.0")
        s = str(s)
        if ";" in s:
            fields = s.split(";")
            if len(fields) == 2:
                try:
                    return DistanceThreshold.ratio_with_limit(
                        float(fields[0]), int(fields[1])
                    )
                except ValueError:
                    pass
            raise ValueError(
                "Expected a combination of a ratio (float) and an absolute maximum "
                "(integer) separated by a semicolon"
            )
        try:
            return DistanceThreshold.absolute(int(s))
        except ValueError:
            pass
        try:
            num = float(s)
        except ValueError:
            num = None
        if num is not None and 0.0 <= num <= 1.0:
            return DistanceThreshold.ratio_of(num)
        raise ValueError(
            "Input must be integer (absolute threshold) or float between 0.0 and 1.0 "
            "(ratio), or a combination of a ratio and an absolute maximum separated "
            "by a semicolon"
        )

    def resolve(self, length: int, absolute_cap: int) -> int:
        """Resolve to a per-input absolute distance given the normalized input length.

        Mirrors the resolution in reference lib.rs:982-1012: ratios floor to int and
        clamp to the global cap; absolute values clamp to floor(length / 2).
        """
        if self.kind is ThresholdKind.RATIO:
            return min(int(length * self.ratio), absolute_cap)
        if self.kind is ThresholdKind.RATIO_WITH_LIMIT:
            return min(int(length * self.ratio), self.limit)
        return min(self.limit, length // 2)


class StopCriterion(enum.Enum):
    """Reference types.rs:307-313."""

    EXHAUSTIVE = "exhaustive"
    STOP_AT_EXACT_MATCH = "stop_at_exact_match"


@dataclass
class SearchParameters:
    """Full runtime search configuration (reference types.rs:110-192 for defaults)."""

    max_anagram_distance: DistanceThreshold = field(
        default_factory=lambda: DistanceThreshold.absolute(3)
    )
    max_edit_distance: DistanceThreshold = field(
        default_factory=lambda: DistanceThreshold.absolute(3)
    )
    max_matches: int = 20
    score_threshold: float = 0.25
    cutoff_threshold: float = 2.0
    stop_criterion: StopCriterion = StopCriterion.EXHAUSTIVE
    max_ngram: int = 3
    lm_order: int = 3
    max_seq: int = 250
    single_thread: bool = False
    context_weight: float = 0.0
    variantmodel_weight: float = 3.0
    lm_weight: float = 1.0
    contextrules_weight: float = 1.0
    freq_weight: float = 0.0
    consolidate_matches: bool = True
    unicodeoffsets: bool = False

    def __post_init__(self):
        # Accept the same loose threshold spellings as the reference's Python
        # binding (int = absolute, float = ratio, "r;limit" strings) directly
        # on the core dataclass, so SearchParameters(max_edit_distance=2)
        # works from the package root, not only via api.SearchParameters.
        if not isinstance(self.max_anagram_distance, DistanceThreshold):
            self.max_anagram_distance = DistanceThreshold.parse(
                self.max_anagram_distance
            )
        if not isinstance(self.max_edit_distance, DistanceThreshold):
            self.max_edit_distance = DistanceThreshold.parse(self.max_edit_distance)

    # --- chained setters (reference types.rs:214-287) ---
    def with_edit_distance(self, d) -> "SearchParameters":
        return dataclasses.replace(self, max_edit_distance=DistanceThreshold.parse(d))

    def with_anagram_distance(self, d) -> "SearchParameters":
        return dataclasses.replace(self, max_anagram_distance=DistanceThreshold.parse(d))

    def with_max_matches(self, n: int) -> "SearchParameters":
        return dataclasses.replace(self, max_matches=n)

    def with_score_threshold(self, t: float) -> "SearchParameters":
        return dataclasses.replace(self, score_threshold=t)

    def with_cutoff_threshold(self, t: float) -> "SearchParameters":
        return dataclasses.replace(self, cutoff_threshold=t)

    def with_stop_criterion(self, c: StopCriterion) -> "SearchParameters":
        return dataclasses.replace(self, stop_criterion=c)

    def with_max_ngram(self, n: int) -> "SearchParameters":
        return dataclasses.replace(self, max_ngram=n)

    def with_max_seq(self, n: int) -> "SearchParameters":
        return dataclasses.replace(self, max_seq=n)

    def with_single_thread(self) -> "SearchParameters":
        return dataclasses.replace(self, single_thread=True)

    def with_unicodeoffsets(self) -> "SearchParameters":
        return dataclasses.replace(self, unicodeoffsets=True)

    def with_utf8offsets(self) -> "SearchParameters":
        return dataclasses.replace(self, unicodeoffsets=False)

    def with_context_weight(self, w: float) -> "SearchParameters":
        return dataclasses.replace(self, context_weight=w)

    def with_lm_weight(self, w: float) -> "SearchParameters":
        return dataclasses.replace(self, lm_weight=w)

    def with_lm_order(self, n: int) -> "SearchParameters":
        return dataclasses.replace(self, lm_order=n)

    def with_freq_weight(self, w: float) -> "SearchParameters":
        return dataclasses.replace(self, freq_weight=w)

    def with_variantmodel_weight(self, w: float) -> "SearchParameters":
        return dataclasses.replace(self, variantmodel_weight=w)

    def with_contextrules_weight(self, w: float) -> "SearchParameters":
        return dataclasses.replace(self, contextrules_weight=w)

    def with_consolidate_matches(self, v: bool) -> "SearchParameters":
        return dataclasses.replace(self, consolidate_matches=v)


@dataclass(slots=True)
class Distance:
    """Per-candidate raw metrics record (reference types.rs:289-305)."""

    ld: int
    lcs: int = 0
    prefixlen: int = 0
    suffixlen: int = 0
    samecase: bool = True


class VariantReferenceKind(enum.Enum):
    REFERENCE_FOR = "reference_for"
    VARIANT_OF = "variant_of"


@dataclass
class VariantReference:
    """Bidirectional variant link (reference types.rs:315-324)."""

    kind: VariantReferenceKind
    vocab_id: VocabId
    score: float


class VariantResult(tuple):
    """(vocab_id, dist_score, freq_score, via) result record.

    ``score()`` mirrors reference types.rs:334-366: combined score blends
    frequency when ``freq_weight > 0``; ranking is by decreasing dist_score
    with freq_score tiebreak (or by blended score).

    Implemented as an immutable tuple subclass rather than a dataclass:
    query mode materializes tens of thousands of these per device batch,
    and C-level bulk construction (``tuple.__new__`` driven by ``map``,
    see pipeline tail_emit) is ~5x cheaper than dataclass ``__init__``.
    Rescoring paths replace list elements instead of mutating fields.
    """

    __slots__ = ()

    def __new__(
        cls,
        vocab_id: VocabId,
        dist_score: float,
        freq_score: float,
        via: Optional[VocabId] = None,
    ):
        return tuple.__new__(cls, (vocab_id, dist_score, freq_score, via))

    @property
    def vocab_id(self) -> VocabId:
        return self[0]

    @property
    def dist_score(self) -> float:
        return self[1]

    @property
    def freq_score(self) -> float:
        return self[2]

    @property
    def via(self) -> Optional[VocabId]:
        return self[3]

    def score(self, freq_weight: float = 0.0) -> float:
        if freq_weight == 0.0:
            return self[1]
        return (self[1] + freq_weight * self[2]) / (1.0 + freq_weight)

    def __repr__(self) -> str:
        return (
            f"VariantResult(vocab_id={self[0]!r}, dist_score={self[1]!r}, "
            f"freq_score={self[2]!r}, via={self[3]!r})"
        )


def rank_results(results: List[VariantResult], freq_weight: float) -> None:
    """Stable in-place sort in decreasing rank order (reference types.rs:344-365,
    lib.rs:1667-1669). Python's sort is stable, like Rust's ``sort_by``."""
    if freq_weight > 0.0:
        results.sort(key=lambda r: -r.score(freq_weight))
    else:
        results.sort(key=lambda r: (-r.dist_score, -r.freq_score))


# N-grams are represented as plain tuples of VocabIds (reference types.rs:369-532
# uses a stack-allocated enum; a tuple is the idiomatic Python equivalent).
NGramT = Tuple[VocabId, ...]

MAX_NGRAM_ORDER = 5
