#!/usr/bin/env python3
"""Roofline of the port's query program: how far is it from the card's floor?

The counterpart of ``tools/roofline.py`` for the PyTorch port. One batch of
``--batch`` corrupted queries (default 4,096) on the model
(``tools/common_torch.py``), budgets settled by two submit/collect rounds;
its work counted from its shapes by ``analiticcl_tpu_torch/utils/
roofline.py`` (the query planes K5, K1, the slot resolve K3, K2's
pair-string entry at the valid pairs and its slot entry at the budget's P
slots, the survivor compaction K4, the bytes of the glue left between
them, the main path's parts together, and the program, which reads only
its inputs and writes only its outputs) and bounded by the card's peaks; then,
on the
card, the core's device busy time per call (one ``torch.profiler`` window
over 10 back-to-back calls) and the wall
time per batch of a warm streamed pass over ``--batches`` batches, each
beside the floor.

    python3 tools/roofline_torch.py [--batch 4096] [--batches 4]
        [--peak-int8 OPS --peak-hbm BYTES --peak-int32 OPS]
        [--device cuda|cpu] [--lexicon FILE]

Peaks: the NVIDIA H100 SXM data sheet's (1,979 TOP/s int8 dense, 3.35 TB/s
HBM) on an H100 SXM card, with the 32-bit integer rate derived from the
card: 64 operations per SM and clock (compute capability 9.0) x its SM
count x its maximum SM clock (``utils.roofline.card_peaks``); any other
card needs all three ``--peak-*``. ``--device cpu`` counts the same work
against the given peaks or the H100 SXM constant (132 SMs at 1,980 MHz:
16.7 TOP/s 32-bit) and measures nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common_torch.add_args(ap)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--peak-int8", type=float, default=None)
    ap.add_argument("--peak-hbm", type=float, default=None)
    ap.add_argument("--peak-int32", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    from analiticcl_tpu_torch.ops.pipeline import query_core
    from analiticcl_tpu_torch.utils.profiling import (
        REPS, profile_window, settled_batch,
    )
    from analiticcl_tpu_torch.utils.roofline import (
        H100_SXM, Peaks, batch_floor, card_peaks,
    )

    cuda = args.device == "cuda"
    given = (args.peak_int8, args.peak_hbm, args.peak_int32)
    model, _words, queries, params = common_torch.setup(
        args, args.batches * args.batch)
    pipe = model._pipeline()
    if cuda:
        peaks = card_peaks(0, *given)
    elif None in given:
        peaks = H100_SXM
    else:
        peaks = Peaks("given", *given)
    B = args.batch
    st, static = settled_batch(pipe, queries[:B], params)
    floor = batch_floor(pipe.index, st["args"], **static, peaks=peaks)
    print(common_torch.card_line(args.device))
    print(f"peaks: {peaks.name}: {peaks.int8_ops_per_s:.4g} int8 op/s, "
          f"{peaks.hbm_bytes_per_s:.4g} B/s, {peaks.int32_ops_per_s:.4g} "
          "32-bit op/s")
    print(f"batch: B={st['B']}, band {static['nb_band'] * 1024} rows "
          f"(K1 width {static['width']}), "
          f"P={static['P']} ({floor.n_valid} valid pairs over "
          f"{floor.cand_rows} candidate rows), P2={static['P2']}, "
          f"window {static['window']}")
    for name, part in (("K5 (query planes)", "k5"),
                       ("K1 (each band block at its columns)", "k1"),
                       ("K1 at the full width", "k1_full"),
                       ("K3 (slot resolve)", "k3"),
                       ("K2 at the valid pairs", "k2_valid"),
                       ("K2 at the P slots", "k2_slots"),
                       ("K4 (survivor compaction)", "k4"),
                       ("glue", "glue"), ("program floor", "program")):
        w = getattr(floor, part)
        ms, by = floor.ms(part)
        print(f"{name}: {w.nbytes:.6g} bytes, {w.int8_ops:.6g} int8 and "
              f"{w.int32_ops:.6g} 32-bit operations: {ms:.4f} ms ({by})")
    prog = floor.program_ms
    print(f"the parts together (K5 + K1 + K3 + K2's slot entry + K4 + glue, "
          f"the data "
          f"between them counted as traffic): {floor.parts_ms:.4f} ms; the "
          f"program floor {prog:.4f} ms per batch, a ceiling of "
          f"{st['B'] / prog * 1e3:.1f} q/s")
    if not cuda:
        print("measured: not measured (cpu run)")
        return 0
    _, prof = profile_window(
        lambda: [query_core(pipe.index, *st["args"], **static)
                 for _ in range(REPS)], cuda)
    busy = prof.busy_ms / REPS
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    list(pipe.find_variants_stream(iter(batches), params))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(pipe.find_variants_stream(iter(batches), params))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    print(f"measured: core device busy {busy:.4f} ms per call "
          f"({REPS} back-to-back calls, profiler): the floor is "
          f"{prog / busy:.4f} of it; streamed wall {wall:.3f} ms per batch "
          f"({len(batches)} batches): the floor is {prog / wall:.5f} of it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
