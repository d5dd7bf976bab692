"""Array-backed per-input variant results of one lookup batch.

The port of ``RankedResults`` (``analiticcl_tpu/ops/pipeline.py``), which
lives in a module that imports JAX; the class itself is host-only numpy
code, so it moves here unchanged in behaviour.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..types import VariantResult


class RankedResults:
    """Array-backed per-input variant results (one device batch).

    Sequence-compatible with ``List[List[VariantResult]]``: ``[i]`` lazily
    builds (and memoizes) the object list, while the flat survivor arrays
    let array-native consumers (the search consolidation, strict learn)
    read scores without a Python object per survivor. Survivors are stored
    row-major in final rank order, exactly as the native ranking tail emits
    them.
    """

    __slots__ = ("n", "vid", "ds", "fq", "row_of", "sbounds", "overrides",
                 "_cache", "_lists")

    def __init__(self, n, vid, ds, fq, row_of, sbounds, overrides):
        self.n = n  # number of inputs
        self.vid = vid  # int64 [n_out] vocab ids (rank order, row-major)
        self.ds = ds  # f64 [n_out] dist scores
        self.fq = fq  # f64 [n_out] freq scores
        self.row_of = row_of  # int64 [n]: input -> survivor row (-1: override)
        self.sbounds = sbounds  # int64 [nrows+1] survivor bounds per row
        self.overrides = overrides  # input idx -> eager List[VariantResult]
        self._cache: dict = {}
        self._lists = None  # lazy .tolist() copies for fast materialization

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (self[i] for i in range(self.n))

    @staticmethod
    def concat(parts: Sequence["RankedResults"]) -> "RankedResults":
        """One RankedResults whose input indices run over the parts in
        order: a search unit submitted as several batches is consolidated
        as one."""
        if len(parts) == 1:
            return parts[0]
        n = sum(p.n for p in parts)
        vid = np.concatenate([p.vid for p in parts])
        ds = np.concatenate([p.ds for p in parts])
        fq = np.concatenate([p.fq for p in parts])
        row_of = np.full(n, -1, dtype=np.int64)
        sb_parts = [np.zeros(1, dtype=np.int64)]
        overrides: dict = {}
        qoff = 0
        voff = 0
        row_off = 0
        for p in parts:
            sb = np.asarray(p.sbounds, dtype=np.int64)
            sb_parts.append(sb[1:] + voff)
            pr = np.asarray(p.row_of, dtype=np.int64)
            row_of[qoff : qoff + p.n] = np.where(pr >= 0, pr + row_off, -1)
            for k, v in p.overrides.items():
                overrides[qoff + k] = v
            voff += int(sb[-1])
            row_off += len(sb) - 1
            qoff += p.n
        return RankedResults(
            n, vid, ds, fq, row_of, np.concatenate(sb_parts), overrides
        )

    def arrays_of(self, i: int):
        """(lo, hi) into vid/ds/fq for input ``i``, or None when the input
        was resolved outside the fast tail (use ``[i]`` instead)."""
        if i in self.overrides:
            return None
        row = int(self.row_of[i])
        if row < 0:
            return None
        return int(self.sbounds[row]), int(self.sbounds[row + 1])

    def __getitem__(self, i: int) -> List[VariantResult]:
        if not isinstance(i, int):
            raise TypeError("RankedResults supports integer indexing only")
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError(i)
        got = self._cache.get(i)
        if got is not None:
            return got
        ov = self.overrides.get(i)
        if ov is not None:
            res = ov
        else:
            span = self.arrays_of(i)
            if span is None:
                res = []
            else:
                lo, hi = span
                if self._lists is None:
                    # one bulk numpy -> python conversion; per-element numpy
                    # scalar reads cost far more across a search unit
                    self._lists = (
                        self.vid.tolist(), self.ds.tolist(), self.fq.tolist()
                    )
                vl, dl, fl = self._lists
                res = [
                    VariantResult(v, d, f, None)
                    for v, d, f in zip(vl[lo:hi], dl[lo:hi], fl[lo:hi])
                ]
        self._cache[i] = res
        return res
