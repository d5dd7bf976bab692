#!/usr/bin/env python3
"""The DL+LCS kernel (K2) against another version of its source, on one
CUDA card.

    python3 tools/k2_compare.py OTHER_DL_LCS_CU

Builds ``analiticcl_tpu_torch/csrc/dl_lcs.cu`` ("this") and OTHER (for
example an earlier commit's copy, unpacked by ``git archive`` into a
directory that ``.gitignore`` lists) with the port's nvcc flags, both at
once, and prints ptxas's registers, stack frame and spills per instance
(the byte path's) and the wide path's registers and spills. On the main
path's pairs (``chip_smoke.k2_main_pairs``: the seeded 120,000-entry
lexicon, the first batch of 4,096 of chip_smoke's corrupted queries,
repeated to 1,048,576 pairs) at W 3, 6 and 12 it requires the two to give
the same ``ld`` and ``lcs`` bit for bit (they run the same DP), then times
them in turns other, this, this, other: CUDA events around 10
back-to-back calls through the C entry point, median of 10. Then the wide
path, through the wrappers: 1,048,576 pairs at L 100 and at L 300, W=3
(``chip_smoke.wide_pair_strings``, three in four over 64) through the
pair-string entry, and phase 12's first batch (``chip_smoke.wide_batch``,
L 300) through the scored slot entry, the main path's: the same outputs
bit for bit (ld and lcs; the keep flags, metrics, frequency maxima and
block counts), then in turns CUDA events (3 calls per 1M pairs, 10 x 10
on the batch) and the wide kernel's profiler device time. A source
whose entries take no work list (before it) is called without one. One
line per input, with the card's name and power limit, then one JSON line
of the times. Needs ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from k2_wide_parts import load, wide_ptxas  # noqa: E402  (tools/)


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
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {sources[name]}:\n{log}")
        print(f"{name} ({sources[name]}): ptxas "
              f"{chip_smoke.dl_lcs_ptxas(log)}; the slot entry's byte path "
              f"{slots_ptxas(log)}; wide {wide_ptxas(log)}", flush=True)
        libs[name] = load(out / f"{name}.so")

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

    def call(name, W, ld, lcs):  # at L <= 64: no work list
        err = libs[name].analiticcl_dl_lcs(
            a.data_ptr(), al.data_ptr(), b.data_ptr(), bl.data_ptr(),
            ld.data_ptr(), lcs.data_ptr(), P, L, W, stream, None, None)
        _build.check(err, f"{name} dl_lcs launch")

    record = {}
    for W in (3, 6, 12):
        outs = {}
        for name in libs:
            outs[name] = (torch.empty(P, dtype=torch.int32, device="cuda"),
                          torch.empty(P, dtype=torch.int32, device="cuda"))
            call(name, W, *outs[name])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y)
                   for x, y in zip(outs["this"], outs["other"])):
            raise SystemExit(f"W={W}: the two sources give different results")
        times = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(chip_smoke.time_ms(
                lambda: call(name, W, *outs[name]), 10, inner=10))
        record[W] = times
        print(f"K2 W={W}: P={P} L={L} ({n_distinct} distinct main-path "
              f"pairs) bit-identical; ms per call (CUDA events, median of "
              f"10 x 10 back-to-back calls), in turns other/this/this/other: "
              f"other {times['other']}, this {times['this']} | {card}",
              flush=True)
    record["wide"] = wide_compare(libs, words, params, card)
    print(json.dumps({"k2_compare": record, "card": card}))
    return 0


def slots_ptxas(report: str) -> dict:
    """ptxas's registers and spills of each ``dl_lcs_slots_kernel``
    instance (the slot entry's byte path), keyed by W, LMAX, threads and
    the tables' element type."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"dl_lcs_slots_kernelILi(\d+)ELi(\d+)ELi(\d+)E(\w)",
                          m.group(1))
            key = "/".join(k.groups()) if k else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(key, {})["spill_stores"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m[1])
    return out


def wide_compare(libs: dict, words, params, card: str) -> dict:
    """The wide path of both sources on the same inputs: per 1M pairs at
    L 100 and 300 (the pair-string entry) and phase 12's first batch (the
    scored slot entry); outputs bit for bit, then times in turns."""
    import torch

    import chip_smoke
    from analiticcl_tpu_torch import VariantModel
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.testing import ALPHABET, populate

    def use(name):
        _build._libs["dl_lcs"] = libs[name]

    inputs = {}
    for L, W in ((100, 3), (300, 3)):
        a, al, b, bl = chip_smoke.wide_pair_strings(
            chip_smoke.SEED + 7 * L + W, L, chip_smoke.WIDE_PAIRS)
        inputs[f"L{L}_W{W}"] = (
            lambda a=a, al=al, b=b, bl=bl, L=L, W=W:
            tdl.dl_lcs(a, al, b, bl, L, W), "dl_lcs_wide_kernel", 3, 1)
    longs = chip_smoke.wide_words()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                     list(words) + longs)
    queries, _near = chip_smoke.wide_queries(words, longs)
    s_args, score, _pr, _P, _valid = chip_smoke.wide_batch(
        model._pipeline(), queries[:chip_smoke.WIDE_BATCH], params)
    inputs["phase12_batch"] = (
        lambda: tdl.dl_lcs_slots(*s_args, score=score),
        "dl_lcs_slots_wide_kernel", 10, 10)
    record = {}
    for what, (fn, kernel, reps, inner) in inputs.items():
        outs = {}
        for name in libs:
            use(name)
            outs[name] = [x for x in fn() if x is not None]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y)
                   for x, y in zip(outs["this"], outs["other"])):
            raise SystemExit(f"wide {what}: the two sources give different "
                             f"results")
        times = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            use(name)
            times[name].append({
                "events_ms": chip_smoke.time_ms(fn, reps, inner=inner),
                "device_ms": chip_smoke.device_ms(fn, kernel, reps)})
        record[what] = times
        print(f"K2 wide path, {what}: bit-identical; in turns other/this/"
              f"this/other, ms per call (CUDA events; {kernel}'s profiler "
              f"device time): other {times['other']}, this "
              f"{times['this']} | {card}", flush=True)
    return record


if __name__ == "__main__":
    sys.exit(main(sys.argv))
