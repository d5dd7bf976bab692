"""Commit provenance stamps for measurement records.

The port's copy of ``analiticcl_tpu/utils/provenance.py``.

Every JSON line a measurement script writes carries the git commit it
measured, whether the tree was dirty, and a UTC timestamp, so a recorded
number can always be matched (or mismatched) against the code it measured.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional

# the checkout's root: analiticcl_tpu_torch/utils/provenance.py -> ../..
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_cached: Optional[dict] = None


def git_state() -> dict:
    """{"commit": short-hash-or-None, "dirty": bool} for the repo root.

    Cached per process: a script calls this once per emitted line and the
    tree does not change mid-run. Outside a git checkout (or without git)
    the commit is None.
    """
    global _cached
    if _cached is None:
        commit = None
        dirty = False
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                capture_output=True, text=True, timeout=10, cwd=_REPO,
            ).stdout.strip() or None
            dirty = bool(
                subprocess.run(
                    ["git", "status", "--porcelain", "-uno"],
                    capture_output=True, text=True, timeout=10, cwd=_REPO,
                ).stdout.strip()
            )
        except Exception:
            pass
        _cached = {"commit": commit, "dirty": dirty}
    return dict(_cached)


def stamp(obj: dict) -> dict:
    """Add commit/dirty/timestamp keys to a result dict (in place)."""
    st = git_state()
    obj.setdefault("commit", st["commit"])
    obj.setdefault("dirty", st["dirty"])
    obj.setdefault(
        "timestamp", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    )
    return obj
