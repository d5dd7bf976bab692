#!/usr/bin/env python3
"""The slot resolve (K3) against other versions of its source, on one CUDA
card.

    python3 tools/k3_compare.py OTHER_RESOLVE_CU [OTHER_RESOLVE_CU ...]

Builds ``analiticcl_tpu_torch/csrc/resolve.cu`` ("this") and each OTHER
(for example an earlier commit's copy, unpacked by ``git archive`` into a
directory that ``.gitignore`` lists, or a copy with another constant) with
the port's nvcc flags, all at once, and prints ptxas's registers and
spills. On the main path's first batch (``chip_smoke.k2_main_pairs``: the
seeded 120,000-entry lexicon, 4,096 of chip_smoke's corrupted queries,
stage A on the card) at the batch's budget and at half its hits (the
overflow), it requires every version to give the same five outputs bit
for bit, then times them in turns (this, the others, then the same in
reverse): CUDA events around 10 back-to-back calls through the C entry
point, median of 10, and the profiler's device time per launch. One line
per version with the card's name and power limit, then one JSON line.
Needs ``nvcc``; imports no JAX.
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
    from analiticcl_tpu_torch.ops.stage_a import _b_tile
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )

    if len(argv) < 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("k3_compare: no CUDA card")
    card = chip_smoke.gpu_line()
    print(card, flush=True)
    out = ROOT / "build" / "k3_compare"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "resolve.cu"}
    sources.update({f"other{k}": Path(a).resolve()
                    for k, a in enumerate(argv[1:], 1)})
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
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name} ({sources[name]}): ptxas {regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).analiticcl_resolve
        fn.argtypes = _build.SIGNATURES["resolve"]["analiticcl_resolve"]
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
    _pairs, n_valid, _slots, P, main = chip_smoke.k2_main_pairs(
        model._pipeline(), queries, params)
    sa, start_blk, idx = main["sa"], main["start_blk"], main["idx"]
    B, M_band = sa.packed_q.shape[0], sa.counts_t.shape[0]
    bt = _b_tile(B, idx.bins.shape[0])
    stream = torch.cuda.current_stream().cuda_stream

    def outputs(P_):
        return (torch.empty((3, P_), dtype=torch.int32, device="cuda"),
                torch.empty(P_, dtype=torch.bool, device="cuda"),
                torch.empty((), dtype=torch.int64, device="cuda"))

    def call(name, o):
        slots, valid, total = o
        P_ = valid.shape[0]
        err = fns[name](sa.packed_q.data_ptr(), sa.counts_t.data_ptr(),
                        sa.nmatch.data_ptr(), start_blk.data_ptr(),
                        slots[0].data_ptr(), slots[1].data_ptr(),
                        slots[2].data_ptr(), valid.data_ptr(),
                        total.data_ptr(), B, M_band, bt, P_, stream)
        _build.check(err, f"{name} resolve launch")

    record = {}
    for label, P_ in (("budget", P), ("overflow", max(1, n_valid // 2))):
        outs = {name: outputs(P_) for name in fns}
        for name in fns:
            call(name, outs[name])
        torch.cuda.synchronize()
        for name in fns:
            if not all(torch.equal(x, y) for x, y in
                       zip(outs[name], outs["this"])):
                raise SystemExit(f"{label}: {name} differs from this")
        times = {name: [] for name in fns}
        order = list(fns) + list(fns)[::-1]
        for name in order:
            times[name].append(chip_smoke.time_ms(
                lambda: call(name, outs[name]), 10, inner=10))
        dev = {name: chip_smoke.device_ms(lambda: call(name, outs[name]),
                                          "resolve", 10)
               for name in fns}
        record[label] = {"P": P_, "events_ms": times, "device_ms": dev}
        for name in fns:
            print(f"K3 {label}: B={B} M_band={M_band} P={P_} ({n_valid} "
                  f"hits), bit-identical; {name}: events {times[name]} ms "
                  f"(median of 10 x 10 back-to-back calls, in turns), "
                  f"profiler device time {chip_smoke.ms4(dev[name])} | "
                  f"{card}", flush=True)
    print(json.dumps({"k3_compare": record, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
