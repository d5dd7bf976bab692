#!/usr/bin/env python3
"""The query core's glue kernels in two checkouts, timed in turns on one
CUDA card.

    python3 tools/kernel_compare.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists. The turns run other, this, this, other, each in a fresh process
that imports ``analiticcl_tpu_torch`` and ``chip_smoke`` from its
checkout (and builds that checkout's kernels): it builds chip_smoke's main
model (the seeded 120,000-entry lexicon), holds the kernels against their
plain versions on the main path's first batch of 4,096 queries and times
them there by its checkout's ``chip_smoke.glue_records`` (K3, K2's slot
entry with its epilogue at W 3/6/12, K4, K5: CUDA events over 10
back-to-back calls and the profiler's device time). Prints the card's
name and power limit, one JSON line per turn and, per kernel, the device
times in turn order. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KEYS = ("ms", "device_ms", "bound_ms")


def worker(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )
    from analiticcl_tpu_torch.utils.roofline import card_peaks

    if not chip_smoke.__file__.startswith(root):
        raise SystemExit(f"worker imported {chip_smoke.__file__}, not {root}")
    _build.load_all(chip_smoke.KERNEL_SOURCES)
    card = chip_smoke.gpu_line()
    words = synthetic_lexicon(chip_smoke.SEED, chip_smoke.N_LEXICON)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries = corrupt_queries(words, chip_smoke.SEED + 1,
                              chip_smoke.N_QUERIES)
    _pairs, n_valid, _slots, _P, main = chip_smoke.k2_main_pairs(
        model._pipeline(), queries, params)
    records = chip_smoke.glue_records(main, n_valid, card, card_peaks(0))
    torch.cuda.synchronize()
    out = {r["name"]: {k: r.get(k) for k in KEYS} for r in records}
    slot = next(r for r in records if r["name"] == "dl_lcs_slots")
    for W, w in slot["by_window"].items():
        out[f"dl_lcs_slots_W{W}"] = {k: w.get(k) for k in KEYS}
    print("RESULT " + json.dumps({"root": root, "card": card, **out}),
          flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[1] == "--worker":
        return worker(argv[2])
    if len(argv) != 2:
        raise SystemExit(__doc__)
    other = str(Path(argv[1]).resolve())
    this = str(HERE)
    turns = []
    for root in (other, this, this, other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root], cwd=root,
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            raise SystemExit(f"worker for {root} failed ({proc.returncode}):"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1][len("RESULT "):])
        rec["side"] = "other" if root == other else "this"
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    print(turns[0]["card"])
    for name in turns[0]:
        if name in ("root", "card", "side"):
            continue
        seq = ", ".join(f"{t['side']} {t[name]['device_ms']}" for t in turns)
        print(f"{name}: device ms in turns {seq}; events ms "
              + ", ".join(str(t[name]["ms"]) for t in turns))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
