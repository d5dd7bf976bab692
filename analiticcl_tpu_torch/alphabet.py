"""Alphabet handling and greedy string normalization.

The port's copy of ``analiticcl_tpu/alphabet.py``.

Reference behavior:
  - read_alphabet        reference src/lib.rs:369-407 (TSV, ``\\s``/``\\t``/``\\n``
    escapes, empty fields dropped, one equivalence class per line)
  - anahash/normalize    reference src/anahash.rs:14-81 (greedy matching in order
    of appearance in the alphabet; multi-character alphabet entries supported; unknown
    characters map to the UNK slot)

The engine representation produced here:
  - ``normalize(text)``  -> list of alphabet indices (one per matched element)
  - ``count_vector(text)`` -> uint8 vector of size ``size()`` (= len(alphabet)+1, the
    last slot being UNK), the canonical "anagram value"

Note a reference quirk we mirror: the *anahash* maps unknown characters to index
``len(alphabet)`` while *normalize_to_alphabet* uses ``len(alphabet)+1``
(anahash.rs:42 vs anahash.rs:76). Count vectors follow the anahash convention
(UNK slot = len(alphabet)); normalized strings follow the normalize convention.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# Alphabet: ordered list of equivalence classes, each a list of strings
Alphabet = List[List[str]]


def read_alphabet_file(filename: str) -> Alphabet:
    """Load an alphabet TSV (reference lib.rs:369-407)."""
    alphabet: Alphabet = []
    with open(filename, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields: List[str] = []
            for x in line.split("\t"):
                if x == "\\s":
                    fields.append(" ")
                elif x == "\\t":
                    fields.append("\t")
                elif x == "\\n":
                    fields.append("\n")
                elif x.strip():
                    fields.append(x.strip())
            alphabet.append(fields)
    return alphabet


class AlphabetEncoder:
    """Greedy longest-defined-first... no: *order-of-appearance* matcher.

    The reference matches alphabet entries in file order at every character
    position; the first entry whose string matches wins, even if a later entry
    would match a longer substring (anahash.rs:25-39). We reproduce that exactly,
    but organize entries per first character for speed.
    """

    def __init__(self, alphabet: Alphabet):
        self.alphabet = alphabet
        # size includes the UNK slot (reference lib.rs:163-165: alphabet_size = len+1)
        self.size = len(alphabet) + 1
        self.unk_count_index = len(alphabet)  # anahash.rs:42
        self.unk_norm_index = len(alphabet) + 1  # anahash.rs:76
        # Flat list of (seqnr, element) in alphabet order, bucketed by first char.
        self._by_first: dict = {}
        for seqnr, chars in enumerate(alphabet):
            for element in chars:
                if not element:
                    continue
                self._by_first.setdefault(element[0], []).append((seqnr, element))
        # Entries within a bucket must stay in global (seqnr, element-order) order;
        # construction order already guarantees that.
        self._single_char_only = all(
            len(el) == 1 for chars in alphabet for el in chars
        )
        if self._single_char_only:
            # fast path: direct char -> index map (first mention wins)
            self._charmap = {}
            for seqnr, chars in enumerate(alphabet):
                for element in chars:
                    self._charmap.setdefault(element, seqnr)

    def normalize(self, text: str) -> List[int]:
        """Normalize a string to alphabet indices (anahash.rs:50-80)."""
        if self._single_char_only:
            cm = self._charmap
            unk = self.unk_norm_index
            return [cm.get(c, unk) for c in text]
        result: List[int] = []
        i = 0
        n = len(text)
        while i < n:
            candidates = self._by_first.get(text[i])
            matched = False
            if candidates is not None:
                best = None
                for seqnr, element in candidates:
                    if text.startswith(element, i):
                        best = (seqnr, element)
                        break
                if best is not None:
                    result.append(best[0])
                    i += len(best[1])
                    matched = True
            if not matched:
                result.append(self.unk_norm_index)
                i += 1
        return result

    def _match_indices(self, text: str, unk_index: int) -> List[int]:
        """Like normalize() but with anahash's UNK convention (anahash.rs:16-47)."""
        if self._single_char_only:
            cm = self._charmap
            return [cm.get(c, unk_index) for c in text]
        out: List[int] = []
        i = 0
        n = len(text)
        while i < n:
            candidates = self._by_first.get(text[i])
            matched = False
            if candidates is not None:
                for seqnr, element in candidates:
                    if text.startswith(element, i):
                        out.append(seqnr)
                        i += len(element)
                        matched = True
                        break
            if not matched:
                out.append(unk_index)
                i += 1
        return out

    def count_vector(self, text: str) -> np.ndarray:
        """The canonical anagram value: per-index character counts (uint8)."""
        vec = np.zeros(self.size, dtype=np.uint8)
        for idx in self._match_indices(text, self.unk_count_index):
            # saturate rather than wrap (counts >255 are pathological)
            if vec[idx] != 255:
                vec[idx] += 1
        return vec

    def count_vectors(self, texts: Sequence[str]) -> np.ndarray:
        """Batched count vectors [len(texts), size] (uint8)."""
        out = np.zeros((len(texts), self.size), dtype=np.uint8)
        for row, text in enumerate(texts):
            for idx in self._match_indices(text, self.unk_count_index):
                if out[row, idx] != 255:
                    out[row, idx] += 1
        return out

    def normalize_batch_padded(
        self, texts: Sequence[str], pad_to: "int | None" = None
    ) -> "tuple[np.ndarray, np.ndarray]":
        """Normalize a batch to a padded int32 matrix plus true lengths.

        Uses the native C++ matcher (utils/native.py) when available; entries
        longer than ``pad_to`` are truncated (lens still report true length).
        ``pad_to=None`` sizes the pad automatically (max norm length of the
        batch — nothing truncated).
        """
        native = self._native_matcher()
        if native is not None:
            if pad_to is None:
                return native.normalize_batch_auto(texts)
            return native.normalize_batch(texts, pad_to)
        norms = [self.normalize(text) for text in texts]
        if pad_to is None:
            pad_to = max((len(n) for n in norms), default=1) or 1
        out = np.zeros((len(texts), pad_to), dtype=np.int32)
        lens = np.zeros(len(texts), dtype=np.int32)
        for row, norm in enumerate(norms):
            lens[row] = len(norm)
            norm = norm[:pad_to]
            out[row, : len(norm)] = norm
        return out, lens

    def _native_matcher(self):
        if not hasattr(self, "_native"):
            try:
                from .utils.native import NativeMatcher, available

                self._native = NativeMatcher(self.alphabet) if available() else None
            except Exception as e:
                from .utils.native import warn_once

                warn_once(
                    "native_matcher",
                    f"native normalizer unavailable ({e!r}); "
                    "using pure-Python normalization",
                )
                self._native = None
        return self._native

    def counts_from_norms(self, norms: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Derive count vectors from padded normalized strings.

        The UNK convention differs between norm strings (len(alphabet)+1,
        anahash.rs:76) and count vectors (len(alphabet), anahash.rs:42);
        remapped here.
        """
        if self._native_matcher() is not None:
            from .utils.native import counts_batch

            out = counts_batch(norms, lens, self.size)
            if out is not None:
                return out
        n, L = norms.shape
        nbins = self.size + 1  # one extra trash bin for padding positions
        pos = np.arange(L, dtype=np.int32)[None, :]
        valid = pos < np.minimum(lens, L)[:, None]
        cls = np.minimum(norms, self.unk_count_index).astype(np.int64)
        np.putmask(cls, ~valid, self.size)  # padding -> trash bin
        cls += np.arange(n, dtype=np.int64)[:, None] * nbins
        counts = np.bincount(cls.ravel(), minlength=n * nbins).reshape(n, nbins)
        return np.minimum(counts[:, : self.size], 255).astype(np.uint8)
