#!/usr/bin/env python3
"""The DL+LCS kernel (K2) against another version of its source, on one
CUDA card.

    python3 tools/k2_compare.py OTHER_DL_LCS_CU

Builds ``analiticcl_tpu_torch/csrc/dl_lcs.cu`` ("this") and OTHER (for
example an earlier commit's copy, unpacked by ``git archive`` into a
directory that ``.gitignore`` lists) with the port's nvcc flags, both at
once, and prints ptxas's registers, stack frame and spills per instance.
On the main path's pairs (``chip_smoke.k2_main_pairs``: the seeded
120,000-entry lexicon, the first batch of 4,096 of chip_smoke's corrupted
queries, repeated to 1,048,576 pairs) at W 3, 6 and 12 it requires the two to give the same
``ld`` and ``lcs`` bit for bit (they run the same DP), then times them in
turns other, this, this, other: CUDA events around 10 back-to-back calls
through the C entry point, median of 10. One line per window, with the
card's name and power limit, then one JSON line of the times. Needs
``nvcc``; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch

    import chip_smoke
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )

    if len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("k2_compare: no CUDA card")
    card = chip_smoke.gpu_line()
    print(card, flush=True)
    out = ROOT / "build" / "k2_compare"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "dl_lcs.cu", "other": Path(argv[1]).resolve()}
    procs = {
        name: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, src in sources.items()
    }
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {sources[name]}:\n{log}")
        print(f"{name} ({sources[name]}): ptxas "
              f"{chip_smoke.dl_lcs_ptxas(log)}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).analiticcl_dl_lcs
        fn.argtypes = _build.SIGNATURES["dl_lcs"]["analiticcl_dl_lcs"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    words = synthetic_lexicon(chip_smoke.SEED, chip_smoke.N_LEXICON)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    # chip_smoke's queries: the main path's first batch is the same
    queries = corrupt_queries(words, chip_smoke.SEED + 1, chip_smoke.N_QUERIES)
    (a, al, b, bl), n_distinct, _slots, _P, _main = chip_smoke.k2_main_pairs(
        model._pipeline(), queries, params)
    P, L = a.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, W, ld, lcs):
        err = fns[name](a.data_ptr(), al.data_ptr(), b.data_ptr(),
                        bl.data_ptr(), ld.data_ptr(), lcs.data_ptr(), P, L,
                        W, stream)
        _build.check(err, f"{name} dl_lcs launch")

    record = {}
    for W in (3, 6, 12):
        outs = {}
        for name in fns:
            outs[name] = (torch.empty(P, dtype=torch.int32, device="cuda"),
                          torch.empty(P, dtype=torch.int32, device="cuda"))
            call(name, W, *outs[name])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y)
                   for x, y in zip(outs["this"], outs["other"])):
            raise SystemExit(f"W={W}: the two sources give different results")
        times = {name: [] for name in fns}
        for name in ("other", "this", "this", "other"):
            times[name].append(chip_smoke.time_ms(
                lambda: call(name, W, *outs[name]), 10, inner=10))
        record[W] = times
        print(f"K2 W={W}: P={P} L={L} ({n_distinct} distinct main-path "
              f"pairs) bit-identical; ms per call (CUDA events, median of "
              f"10 x 10 back-to-back calls), in turns other/this/this/other: "
              f"other {times['other']}, this {times['this']} | {card}",
              flush=True)
    print(json.dumps({"k2_compare": record, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
