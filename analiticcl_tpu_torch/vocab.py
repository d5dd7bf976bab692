"""Vocabulary store, lexicon parameters, and special tokens.

The port's copy of ``analiticcl_tpu/vocab.py``.

Parity targets:
  - VocabValue / VocabType bitflags   reference src/vocab.rs:7-90
  - VocabDecoder / VocabEncoder       reference src/vocab.rs:93-96
  - FrequencyHandling / VocabParams   reference src/vocab.rs:100-143
  - BOS/EOS/UNK seeding               reference src/vocab.rs:145-181
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from .types import VariantReference, VocabId


class VocabType(enum.IntFlag):
    """Bitflags (vocab.rs:31-49)."""

    NONE = 0
    INDEXED = 1
    LM = 2
    TRANSPARENT = 4

    def check(self, test: "VocabType") -> bool:
        return (self & test) == test


@dataclass
class VocabValue:
    text: str
    # normalized alphabet-index string; None = not yet computed (the oracle
    # paths are the only consumers — VariantModel._norm_of fills it lazily, so
    # million-entry ingestion never pays per-entry normalization)
    norm: Optional[List[int]] = None
    frequency: int = 1
    tokencount: int = 1
    lexindex: int = 0  # bitmask over lexicon indices
    variants: Optional[List[VariantReference]] = None
    vocabtype: VocabType = VocabType.NONE

    def in_lexicon(self, index: int) -> bool:
        return (self.lexindex & (1 << index)) == (1 << index)

    def lexindex_as_list(self) -> List[int]:
        return [i for i in range(31) if self.in_lexicon(i)]


# decoder: list indexed by VocabId; encoder: text -> VocabId
VocabDecoder = List[VocabValue]
VocabEncoder = Dict[str, VocabId]


class FrequencyHandling(enum.Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    REPLACE = "replace"


@dataclass
class VocabParams:
    """Per-lexicon load parameters (vocab.rs:108-143)."""

    text_column: int = 0
    freq_column: Optional[int] = 1
    freq_handling: FrequencyHandling = FrequencyHandling.MAX
    vocab_type: VocabType = VocabType.INDEXED
    index: int = 0

    def with_vocab_type(self, vocab_type: VocabType) -> "VocabParams":
        return replace(self, vocab_type=vocab_type)

    def with_freq_handling(self, fh: FrequencyHandling) -> "VocabParams":
        return replace(self, freq_handling=fh)


BOS: VocabId = 0
EOS: VocabId = 1
UNK: VocabId = 2


def init_vocab(decoder: VocabDecoder, encoder: VocabEncoder) -> None:
    """Seed the BOS/EOS/UNK special tokens (vocab.rs:150-181)."""
    for text, vid in (("<bos>", BOS), ("<eos>", EOS), ("<unk>", UNK)):
        decoder.append(
            VocabValue(
                text=text,
                norm=[],
                frequency=0,
                tokencount=1,
                lexindex=0,
                variants=None,
                vocabtype=VocabType.NONE,
            )
        )
        encoder[text] = vid
