"""Weighted confusable patterns matched against shortest edit scripts.

The port's copy of ``analiticcl_tpu/confusables.py``.

Parity target: reference src/confusables.rs (Confusable::new parses
``^``/``$`` anchors; Confusable::found_in scans a reference edit script for the
pattern with suffix/prefix semantics at the pattern edges).
"""

from __future__ import annotations

from dataclasses import dataclass

from .editscript import EditScript, Instruction, Op, parse_editscript


@dataclass
class Confusable:
    editscript: EditScript
    weight: float
    strictbegin: bool = False
    strictend: bool = False

    @staticmethod
    def new(pattern: str, weight: float) -> "Confusable":
        """Parse a confusable pattern (confusables.rs:14-44)."""
        if not pattern:
            raise ValueError("empty confusable pattern")
        strictbegin = pattern[0] == "^"
        strictend = pattern[-1] == "$"
        core = pattern
        if strictbegin and strictend:
            core = pattern[1:-1]
        elif strictbegin:
            core = pattern[1:]
        elif strictend:
            core = pattern[:-1]
        return Confusable(
            editscript=parse_editscript(core),
            weight=weight,
            strictbegin=strictbegin,
            strictend=strictend,
        )

    def found_in(self, refscript: EditScript) -> bool:
        """Is this confusable instantiated inside a reference edit script?

        Mirrors confusables.rs:47-128: instructions must match consecutively;
        Insertion/Deletion pattern runs match when the reference run *ends
        with* them; Identity runs use suffix semantics at the pattern start,
        prefix semantics at the pattern end, and exact equality in the middle
        (or when the pattern is a single instruction).
        """
        l = len(self.editscript)
        matches = 0
        for i, refins in enumerate(refscript):
            ins = self.editscript[matches] if matches < l else None
            if ins is None:
                break
            found = _instruction_matches(ins, refins, matches, l)
            if not found:
                matches = 0
                if self.strictbegin:
                    return False
                continue
            matches += 1
            if matches == l:
                if self.strictend:
                    return i == len(refscript) - 1
                return True
        return False


def _instruction_matches(
    ins: Instruction, refins: Instruction, matches: int, l: int
) -> bool:
    if refins.is_options:
        return False  # reference scripts never contain options
    sref = refins.text
    options = ins.text if ins.is_options else (ins.text,)
    if ins.op in (Op.INSERTION, Op.DELETION) and refins.op is ins.op:
        return any(sref.endswith(s) for s in options)
    if ins.op is Op.IDENTITY and refins.op is Op.IDENTITY:
        for s in options:
            if matches == 0 and matches == l - 1:
                if s == sref:
                    return True
            elif matches == 0:
                if sref.endswith(s):
                    return True
            elif matches == l - 1:
                if sref.startswith(s):
                    return True
            elif s == sref:
                return True
        return False
    return False
