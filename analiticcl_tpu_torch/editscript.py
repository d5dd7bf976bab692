"""Shortest edit scripts between strings.

The port's copy of ``analiticcl_tpu/editscript.py``.

A from-scratch reimplementation of the semantics the reference gets from the
external ``sesdiff`` crate (used via ``shortest_edit_script(input, candidate,
false, false, false)`` in reference src/lib.rs:1736 and parsed from
confusable patterns in reference src/confusables.rs).

An edit script is a sequence of instructions over aggregated character runs:

    Identity("hu")  =[hu]    characters kept
    Deletion("y")   -[y]     characters removed from the source
    Insertion("i")  +[i]     characters added from the target

``shortest_edit_script(a, b)`` computes a minimal-cost alignment (unit-cost
insert/delete, zero-cost match — i.e. the LCS alignment) and aggregates
consecutive operations into runs, emitting deletions before insertions inside
each mixed block, so that the substitution of ``y`` by ``i`` appears as
``-[y]+[i]`` (matching the documented analiticcl confusable examples,
reference README.md:376-399).

Pattern scripts (confusable syntax) additionally support option lists inside
brackets: ``=[c|k]-[y]+[i]`` matches when the identity run ends with either
``c`` or ``k``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple, Union


class Op(enum.Enum):
    IDENTITY = "="
    INSERTION = "+"
    DELETION = "-"


@dataclass(frozen=True)
class Instruction:
    op: Op
    # a single run string, or (for pattern scripts) a tuple of alternatives
    text: Union[str, Tuple[str, ...]]

    @property
    def is_options(self) -> bool:
        return isinstance(self.text, tuple)

    def __repr__(self) -> str:  # sesdiff-style display
        if self.is_options:
            inner = "|".join(self.text)
        else:
            inner = self.text
        return f"{self.op.value}[{inner}]"


EditScript = List[Instruction]


def shortest_edit_script(a: str, b: str) -> EditScript:
    """Minimal insert/delete script transforming ``a`` into ``b``.

    Uses the native C++ implementation when available (same DP and traceback
    preferences; parity-tested), falling back to the Python path."""
    try:
        from .utils.native import edit_script_native

        ops = edit_script_native(a, b)
        if ops is not None:
            return [Instruction(Op(op), text) for op, text in ops]
    except Exception as e:
        from .utils.native import warn_once

        warn_once(
            "edit_script_native",
            f"native edit-script path failed ({e!r}); using Python fallback",
        )
    return _shortest_edit_script_py(a, b)


def _shortest_edit_script_py(a: str, b: str) -> EditScript:
    sa, sb = list(a), list(b)
    n, m = len(sa), len(sb)

    # strip common prefix/suffix for speed; reattach as identity runs
    pre = 0
    while pre < n and pre < m and sa[pre] == sb[pre]:
        pre += 1
    suf = 0
    while suf < n - pre and suf < m - pre and sa[n - 1 - suf] == sb[m - 1 - suf]:
        suf += 1
    core_a = sa[pre : n - suf]
    core_b = sb[pre : m - suf]
    ops: List[Tuple[Op, str]] = []
    if pre:
        ops.append((Op.IDENTITY, a[:pre]))
    ops.extend(_diff_core(core_a, core_b))
    if suf:
        ops.append((Op.IDENTITY, a[n - suf :]))
    return _aggregate(ops)


def _diff_core(sa: List[str], sb: List[str]) -> List[Tuple[Op, str]]:
    n, m = len(sa), len(sb)
    if n == 0:
        return [(Op.INSERTION, c) for c in sb]
    if m == 0:
        return [(Op.DELETION, c) for c in sa]
    # LCS-alignment DP: dp[i][j] = min edits between sa[:i], sb[:j]
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        row = dp[i]
        prev = dp[i - 1]
        ai = sa[i - 1]
        for j in range(1, m + 1):
            if ai == sb[j - 1]:
                row[j] = prev[j - 1]
            else:
                row[j] = min(prev[j], row[j - 1]) + 1
    # traceback; consuming insertions first here puts deletions first in
    # forward order within each mixed block
    out: List[Tuple[Op, str]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and sa[i - 1] == sb[j - 1] and dp[i][j] == dp[i - 1][j - 1]:
            out.append((Op.IDENTITY, sa[i - 1]))
            i -= 1
            j -= 1
        elif j > 0 and dp[i][j] == dp[i][j - 1] + 1:
            out.append((Op.INSERTION, sb[j - 1]))
            j -= 1
        else:
            out.append((Op.DELETION, sa[i - 1]))
            i -= 1
    out.reverse()
    return out


def _aggregate(ops: List[Tuple[Op, str]]) -> EditScript:
    """Merge consecutive same-op characters into run instructions."""
    script: EditScript = []
    for op, text in ops:
        if script and script[-1].op is op:
            script[-1] = Instruction(op, script[-1].text + text)
        else:
            script.append(Instruction(op, text))
    return script


def parse_editscript(pattern: str) -> EditScript:
    """Parse a sesdiff-syntax pattern script, e.g. ``=[c|k]-[y]+[i]``.

    Bracketed contents containing ``|`` become option instructions
    (matching reference src/confusables.rs:68-105 semantics).
    """
    script: EditScript = []
    i = 0
    n = len(pattern)
    while i < n:
        opchar = pattern[i]
        try:
            op = Op(opchar)
        except ValueError:
            raise ValueError(
                f"invalid edit script instruction at position {i}: {pattern!r}"
            )
        if i + 1 >= n or pattern[i + 1] != "[":
            raise ValueError(f"expected '[' after operator in {pattern!r}")
        end = pattern.find("]", i + 2)
        if end < 0:
            raise ValueError(f"unterminated bracket in {pattern!r}")
        content = pattern[i + 2 : end]
        if "|" in content:
            script.append(Instruction(op, tuple(content.split("|"))))
        else:
            script.append(Instruction(op, content))
        i = end + 1
    return script


def script_to_str(script: EditScript) -> str:
    return "".join(repr(ins) for ins in script)
