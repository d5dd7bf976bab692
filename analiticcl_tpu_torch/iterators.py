"""Deletion-neighborhood iterators over count vectors.

The port's copy of ``analiticcl_tpu/iterators.py``.

API-parity port of the reference iterators (src/iterators.rs). These are host-side
utilities (decomposition, tests, debugging); the engine's hot path replaces them with
the dense L1-ball retrieval in ops/ (see anahash.cv_anagram_distance).

Yield orders match the reference exactly:
  - DeletionIterator yields single deletions in descending alphabet index
    (iterators.rs:51-70).
  - RecurseDeletionIterator supports DFS (pre-order), BFS, single-beam descent,
    min/max depth, uniqueness, and empty-leaf suppression (iterators.rs:95-235).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Set, Tuple

import numpy as np


@dataclass
class DeletionResult:
    value: np.ndarray  # count vector
    charindex: int


def iter_deletions(counts: np.ndarray) -> Iterator[DeletionResult]:
    """All single-character deletions, descending char index (iterators.rs:51-70)."""
    for idx in np.nonzero(counts)[0][::-1]:
        child = counts.copy()
        child[idx] -= 1
        yield DeletionResult(child, int(idx))


class RecurseDeletionIterator:
    """Multi-deletion traversal (iterators.rs:95-235)."""

    def __init__(
        self,
        counts: np.ndarray,
        singlebeam: bool = False,
        mindepth: Optional[int] = None,
        maxdepth: Optional[int] = None,
        breadthfirst: bool = False,
        unique: bool = False,
        empty_leaves: bool = True,
        visited: Optional[Set[bytes]] = None,
    ):
        self.queue: deque = deque([(DeletionResult(counts, 0), 0)])
        self.singlebeam = singlebeam
        self.breadthfirst = breadthfirst
        self.mindepth = mindepth if mindepth is not None else 1
        self.maxdepth = maxdepth
        self.unique = unique
        self.empty_leaves = empty_leaves
        self.visited: Set[bytes] = visited if visited is not None else set()

    def __iter__(self) -> Iterator[Tuple[DeletionResult, int]]:
        return self

    def __next__(self) -> Tuple[DeletionResult, int]:
        while True:
            if not self.queue:
                raise StopIteration
            if self.breadthfirst:
                node, depth = self.queue.popleft()
                if self.unique and node.value.tobytes() in self.visited:
                    continue
                if self.maxdepth is None or depth < self.maxdepth:
                    for child in iter_deletions(node.value):
                        if self.unique and child.value.tobytes() in self.visited:
                            continue
                        self.queue.append((child, depth + 1))
            else:
                node, depth = self.queue.pop()
                if self.maxdepth is None or depth < self.maxdepth:
                    if self.unique and node.value.tobytes() in self.visited:
                        continue
                    children = list(iter_deletions(node.value))
                    if self.singlebeam:
                        if children:
                            self.queue.append((children[0], depth + 1))
                    else:
                        for child in reversed(children):
                            if self.unique and child.value.tobytes() in self.visited:
                                continue
                            self.queue.append((child, depth + 1))
            if depth < self.mindepth or (
                not self.empty_leaves and not node.value.any()
            ):
                continue
            if self.unique:
                self.visited.add(node.value.tobytes())
            return node, depth


def iter_values(counts: np.ndarray) -> Iterator[Tuple[DeletionResult, int]]:
    """Single-beam decomposition iterator (anahash.rs:192-204): dives to the
    bottom along first children, yielding one character per step."""
    return RecurseDeletionIterator(counts, singlebeam=True)


def char_count(counts: np.ndarray) -> int:
    return int(counts.sum())
