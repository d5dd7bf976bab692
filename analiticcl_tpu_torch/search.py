"""Text segmentation, match/sequence types, and the context-rule engine.

The port's copy of ``analiticcl_tpu/search.py``.

Parity target: reference src/search.rs. All of this is light host logic;
the heavy per-segment variant lookups are batched onto the device by
``VariantModel.find_all_matches``.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq, Tuple

from .types import VariantResult, VocabId

# ln(1e-6), reference search.rs:4
TRANSITION_SMOOTHING_LOGPROB = -13.815510557964274


@dataclass(slots=True)
class Offset:
    """Byte offset pair (search.rs:8-38)."""

    begin: int
    end: int

    def convert(self, mapping: List[Optional[int]]) -> None:
        self.begin = mapping[self.begin]
        self.end = mapping[self.end]
        assert self.begin is not None and self.end is not None


@dataclass(slots=True)
class Match:
    """A match between the input text and the lexicon (search.rs:42-121)."""

    text: str
    offset: Offset
    variants: Optional[List[VariantResult]] = None
    selected: Optional[int] = None
    tag: List[int] = field(default_factory=list)
    seqnr: List[int] = field(default_factory=list)
    prevboundary: Optional[int] = None
    nextboundary: Optional[int] = None
    n: int = 0
    # index of this segment's lookup in the unit's deduplicated query batch;
    # the array-native consolidation reads scores through it instead of
    # attaching materialized ``variants`` lists (models/variant_model.py)
    qidx: Optional[int] = None

    def is_empty(self) -> bool:
        return not self.variants

    def solution(self) -> Optional[VariantResult]:
        if self.selected is not None and self.variants is not None:
            if 0 <= self.selected < len(self.variants):
                return self.variants[self.selected]
        return None

    def internal_boundaries(self, boundaries: Seq["Match"]) -> Seq["Match"]:
        """Boundaries strictly inside this match (search.rs:103-120).

        Mirrors the reference quirk: requires at least two interior boundaries
        before the slice is non-empty (begin set on first hit, end only
        advanced from the second hit on).
        """
        begin = None
        end = 0
        for i, boundary in enumerate(boundaries):
            if (
                boundary.offset.begin > self.offset.begin
                and boundary.offset.end < self.offset.end
            ):
                if begin is None:
                    begin = i
                else:
                    end = i + 1
        if begin is None or begin >= end:
            return []
        return boundaries[begin:end]

    def shallow_copy(self) -> "Match":
        return Match(
            text=self.text,
            offset=Offset(self.offset.begin, self.offset.end),
            variants=self.variants,
            selected=self.selected,
            tag=list(self.tag),
            seqnr=list(self.seqnr),
            prevboundary=self.prevboundary,
            nextboundary=self.nextboundary,
            n=self.n,
            qidx=self.qidx,
        )


@dataclass
class OutputSymbol:
    """Lattice bookkeeping (search.rs:133-149)."""

    vocab_id: VocabId  # 0 = out-of-vocabulary, copy from input
    match_index: int
    variant_index: Optional[int]
    boundary_index: int
    symbol: int


@dataclass
class SequenceHyp:
    """A candidate output sequence with its scores (search.rs:153-174)."""

    output_symbols: List[OutputSymbol] = field(default_factory=list)
    variant_cost: float = 0.0
    lm_logprob: float = 0.0
    perplexity: float = 0.0
    context_score: float = 1.0
    tags: List[List[Tuple[int, int]]] = field(default_factory=list)


class BoundaryStrength(enum.Enum):
    NONE = 0
    WEAK = 1
    NORMAL = 2
    HARD = 3


_ASCII_NONALPHA = re.compile(rb"[^A-Za-z]+")


def find_boundaries(text: str) -> List[Match]:
    """Identify token boundaries: runs of non-alphabetic characters, plus a
    final (possibly empty) boundary (search.rs:190-233). Offsets are UTF-8
    byte offsets, matching the reference.

    Pure-ASCII text (the overwhelmingly common case) takes a regex scan —
    ~20x faster than the per-character unicode loop, and equivalent because
    ``str.isalpha()`` over ASCII is exactly ``[A-Za-z]`` (fuzzed against the
    generic path in tests/test_search.py)."""
    if text.isascii():
        data = text.encode()
        boundaries = [
            Match(
                text=m.group().decode(),
                offset=Offset(m.start(), m.end()),
            )
            for m in _ASCII_NONALPHA.finditer(data)
        ]
        if not boundaries or boundaries[-1].offset.end != len(data):
            boundaries.append(Match(text="", offset=Offset(len(data), len(data))))
        return boundaries
    return _find_boundaries_generic(text)


def _find_boundaries_generic(text: str) -> List[Match]:
    boundaries: List[Match] = []
    begin: Optional[int] = None  # byte offset
    bytepos = 0
    positions: List[Tuple[int, str]] = []
    for c in text:
        positions.append((bytepos, c))
        bytepos += len(c.encode("utf-8"))
    total = bytepos
    bytetext = text.encode("utf-8")

    for i, c in positions:
        if begin is not None:
            if c.isalpha():
                boundaries.append(
                    Match(
                        text=bytetext[begin:i].decode("utf-8"),
                        offset=Offset(begin, i),
                    )
                )
                begin = None
        else:
            if not c.isalpha():
                begin = i

    if begin is not None:
        boundaries.append(
            Match(text=bytetext[begin:].decode("utf-8"), offset=Offset(begin, total))
        )
    else:
        boundaries.append(Match(text="", offset=Offset(total, total)))
    return boundaries


def classify_boundaries(boundaries: Seq[Match]) -> List[BoundaryStrength]:
    """Hard (multi-char or final), Weak (' - _), Normal (search.rs:238-258)."""
    strengths = []
    for i, boundary in enumerate(boundaries):
        if i == len(boundaries) - 1:
            strengths.append(BoundaryStrength.HARD)
        elif len(boundary.text.encode("utf-8")) > 1:
            strengths.append(BoundaryStrength.HARD)
        elif boundary.text in ("'", "-", "_"):
            strengths.append(BoundaryStrength.WEAK)
        else:
            strengths.append(BoundaryStrength.NORMAL)
    return strengths


def find_match_ngrams(
    text: str,
    boundaries: Seq[Match],
    order: int,
    begin: int,
    end: Optional[int] = None,
    bytetext: Optional[bytes] = None,
) -> List[Match]:
    """All ngrams of the given order between boundaries (search.rs:262-313).

    Offsets are UTF-8 byte offsets into ``text``. Pass ``bytetext`` when the
    caller already encoded the text — re-encoding a long text once per
    (hard batch, order) call dominated search-mode segmentation otherwise.
    """
    if bytetext is None:
        bytetext = text.encode("utf-8")
    ngrams: List[Match] = []
    end = end if end is not None else len(bytetext)
    i = 0
    while i + order - 1 < len(boundaries):
        boundary = boundaries[i + order - 1]
        if boundary.offset.begin > end:
            break
        matchtext = bytetext[begin : boundary.offset.begin].decode("utf-8")
        if matchtext and matchtext != " ":
            ngram = Match(
                text=matchtext, offset=Offset(begin, boundary.offset.begin), n=order
            )
            ngrams.append(ngram)
        begin = boundaries[i].offset.end
        i += 1

    # add the last one
    if begin < end:
        matchtext = bytetext[begin:end].decode("utf-8")
        if matchtext and matchtext != " ":
            ngram = Match(text=matchtext, offset=Offset(begin, end), n=order)
            if len(ngram.internal_boundaries(boundaries)) == order:
                ngrams.append(ngram)
    return ngrams


def redundant_match(candidate: Match, matches: Seq[Match]) -> bool:
    """A higher-order match is redundant if its covered unigrams already score
    a perfect 1.0 (search.rs:317-336)."""
    for refmatch in matches:
        if refmatch.n == 1:
            if (
                refmatch.offset.begin >= candidate.offset.begin
                and refmatch.offset.end <= candidate.offset.end
            ):
                if refmatch.variants is not None:
                    if (
                        not refmatch.variants
                        or refmatch.variants[0].dist_score < 1.0
                    ):
                        return False
                else:
                    return False
        else:
            break  # unigrams are at the beginning of the vector
    return True


# ---------------------------------------------------------------------------
# Context rules (search.rs:338-524)
# ---------------------------------------------------------------------------


class PatternMatch:
    """Pattern element for context rules (search.rs:339-459)."""

    __slots__ = ("kind", "value")

    # kinds
    VOCAB = "vocab"
    ANY = "any"
    NO_LEXICON = "nolexicon"
    FROM_LEXICON = "fromlexicon"
    NOT = "not"
    DISJUNCTION = "disjunction"

    def __init__(self, kind: str, value=None):
        self.kind = kind
        self.value = value

    def __repr__(self):
        return f"PatternMatch({self.kind}, {self.value})"

    def matches(self, sequence: Seq[Tuple[VocabId, int]], index: int) -> bool:
        if self.kind == PatternMatch.ANY:
            return True
        if index >= len(sequence):
            return self.kind == PatternMatch.NOT and not self.value.matches(
                sequence, index
            )
        vocabid, lexindex = sequence[index]
        if self.kind == PatternMatch.NO_LEXICON:
            return lexindex == 0 or vocabid == 0
        if self.kind == PatternMatch.VOCAB:
            return vocabid == self.value
        if self.kind == PatternMatch.FROM_LEXICON:
            bit = 1 << self.value
            return (lexindex & bit) == bit
        if self.kind == PatternMatch.NOT:
            return not self.value.matches(sequence, index)
        if self.kind == PatternMatch.DISJUNCTION:
            return any(pm.matches(sequence, index) for pm in self.value)
        return False

    @staticmethod
    def parse(
        s: str, lexicons: Seq[str], encoder: Dict[str, VocabId]
    ) -> "PatternMatch":
        s = s.strip()
        if s == "?":
            return PatternMatch(PatternMatch.ANY)
        if s == "^":
            return PatternMatch(PatternMatch.NO_LEXICON)
        if s.startswith("!(") and s.endswith(")"):
            return PatternMatch(
                PatternMatch.NOT, PatternMatch.parse(s[2:-1], lexicons, encoder)
            )
        if "|" in s:
            items = [PatternMatch.parse(item, lexicons, encoder) for item in s.split("|")]
            return PatternMatch(PatternMatch.DISJUNCTION, items)
        if s.startswith("!"):
            return PatternMatch(
                PatternMatch.NOT, PatternMatch.parse(s[1:], lexicons, encoder)
            )
        if s.startswith("@"):
            source = s[1:]
            relsource = "/" + source
            for i, lexicon in enumerate(lexicons):
                if source == lexicon or lexicon.endswith(relsource):
                    return PatternMatch(PatternMatch.FROM_LEXICON, i)
            raise ValueError(
                f"Context rule references lexicon or variant list '{source}' "
                "but this source was not loaded"
            )
        if s in encoder:
            return PatternMatch(PatternMatch.VOCAB, encoder[s])
        raise ValueError(
            f"Context rule references word '{s}' but this word does not occur "
            "in any lexicon"
        )


@dataclass
class PatternMatchResult:
    score: float
    tag: Optional[int]
    seqnr: int


@dataclass
class ContextRule:
    pattern: List[PatternMatch]
    score: float
    tag: List[int]
    tagoffset: List[Tuple[int, int]]  # (begin, length)

    def invert_score(self) -> float:
        return 1.0 / self.score

    def __len__(self) -> int:
        return len(self.pattern)

    def matches(
        self,
        sequence: Seq[Tuple[VocabId, int]],
        begin: int,
        sequence_result: List[List[PatternMatchResult]],
    ) -> bool:
        """First-match-wins application over the sequence (search.rs:472-523)."""
        assert len(sequence) == len(sequence_result)
        if begin + len(self.pattern) > len(sequence):
            return False
        for cursor, contextmatch in enumerate(self.pattern):
            if sequence_result[begin + cursor] or not contextmatch.matches(
                sequence, begin + cursor
            ):
                return False
        for cursor in range(len(self.pattern)):
            if not self.tag:
                sequence_result[begin + cursor] = [
                    PatternMatchResult(score=self.score, tag=None, seqnr=cursor)
                ]
            else:
                results = []
                for tag, (tbegin, tlength) in zip(self.tag, self.tagoffset):
                    if tbegin <= cursor < tbegin + tlength:
                        results.append(
                            PatternMatchResult(
                                score=self.score, tag=tag, seqnr=cursor - tbegin
                            )
                        )
                sequence_result[begin + cursor] = results
        return True


def remap_offsets_to_unicodepoints(text: str, matches: List[Match]) -> List[Match]:
    """Remap UTF-8 byte offsets to unicode codepoint offsets (search.rs:527-546)."""
    bytes2unicode: List[Optional[int]] = []
    end = 0
    for unicodeoffset, c in enumerate(text):
        bytes2unicode.append(unicodeoffset)
        for _ in range(len(c.encode("utf-8")) - 1):
            bytes2unicode.append(None)
        end = unicodeoffset + 1
    bytes2unicode.append(end)
    for m in matches:
        m.offset.convert(bytes2unicode)
    return matches
