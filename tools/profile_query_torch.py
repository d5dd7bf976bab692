#!/usr/bin/env python3
"""Per-stage profile of the port's query path: streamed against sequential.

The counterpart of ``tools/profile_query.py`` for the PyTorch port.
``--batches`` batches of ``--batch`` corrupted queries on the model
(``tools/common_torch.py``), after one warm-up pass: ``--passes`` passes
through ``DevicePipeline.find_variants_stream`` at depth 2 (streamed), then
as many at depth 0 (sequential: each batch submitted and collected before
the next), then streamed again with Python's garbage collector off; each
with q/s per pass, the ``StageTimer`` stages (``host_prep``, ``dispatch``,
``device``, ``device_get``, ``host_tail``) per batch and the collector's
collections and time per pass; then one ``torch.profiler`` window over a
streamed pass: the card's busy time and idle share, its ops per batch, and
the host's time in CUDA runtime calls. Every pass must give the warm-up
pass's results.

    python3 tools/profile_query_torch.py [--batches 4] [--batch 4096]
        [--passes 3] [--trace DIR] [--mesh DPxLEX] [--learn [--calls 5]]
        [--device cuda|cpu] [--lexicon FILE]

``--trace DIR`` writes one streamed pass as a Chrome trace into DIR.
``--mesh DPxLEX`` shards the index over a (dp, lex) mesh of the device
repeated (``cuda:0`` or ``cpu``). ``--learn`` times ``--calls`` strict
learn calls over ``--batch`` corrupted words each (a new corpus per call)
instead of queries, after a 64-word lookup that takes the process's
one-time costs, with the stages and the collector's time of each call,
and as many calls with the collector off, in turns (each call learns into
the model, so a later call has more links to rank); then one under the
profiler. ``--device cpu`` runs the
same code on the CPU and reads only the host clock.
"""

from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch  # noqa: E402

STAGES = ("host_prep", "dispatch", "device", "device_get", "host_tail")


def stage_line(stats, n: int) -> str:
    return ", ".join(f"{k} {stats.totals.get(k, 0.0) * 1e3 / n:.3f} ms"
                     for k in STAGES)


def profile_line(prof, n: int, unit: str) -> str:
    if prof.busy_ms is None:
        return (f"profile: wall {prof.wall_ms:.3f} ms; device busy, idle "
                "share and ops not measured (cpu run)")
    top = sorted(prof.runtime.items(), key=lambda kv: -kv[1])[:5]
    return (f"profile: wall {prof.wall_ms:.3f} ms, device busy "
            f"{prof.busy_ms:.3f} ms, idle share {prof.idle_share:.4f}, "
            f"{prof.n_ops / n:.1f} device ops per {unit}; host in CUDA "
            "runtime calls: "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common_torch.add_args(ap)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3,
                    help="timed passes per mode")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--mesh", default=None, metavar="DPxLEX")
    ap.add_argument("--learn", action="store_true")
    ap.add_argument("--calls", type=int, default=5,
                    help="learn calls with --learn")
    args = ap.parse_args(argv)

    from analiticcl_tpu_torch import DistanceThreshold, SearchParameters
    from analiticcl_tpu_torch.parallel.mesh import make_mesh
    from analiticcl_tpu_torch.testing import corrupt_queries
    from analiticcl_tpu_torch.utils.profiling import (
        GcClock, profile_window, trace,
    )

    dev = args.device
    cuda = dev == "cuda"
    t0 = time.perf_counter()
    model, words, queries, params = common_torch.setup(
        args, args.batches * args.batch)
    if args.mesh:
        n_dp, n_lex = (int(x) for x in args.mesh.lower().split("x"))
        model.use_mesh(make_mesh(["cuda:0" if cuda else "cpu"]
                                 * (n_dp * n_lex), dp=n_dp))
    pipe = model._pipeline()
    common_torch.sync(dev)
    print(common_torch.card_line(dev))
    print(f"model: {model.index.size} entries, {type(pipe).__name__}"
          f"{' ' + args.mesh if args.mesh else ''}, built in "
          f"{time.perf_counter() - t0:.3f} s")

    if args.learn:
        lparams = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=10,
            score_threshold=0.25,
            max_ngram=2,
        )
        corpora = [corrupt_queries(words, common_torch.SEED + 10 + k,
                                   args.batch)
                   for k in range(2 * args.calls + 1)]
        # the process's one-time costs (kernel loads, library handles) go
        # to a small lookup; call 0 then shows the pipeline's first use
        model.find_variants_batch(corpora[-1][:64], lparams)
        print(f"{len(gc.get_objects())} objects tracked by the collector")
        for k, corpus in enumerate(corpora[:-1]):
            pause = k % 2 == 1
            pipe.stats.clear()
            with GcClock(pause) as gcc:
                t0 = time.perf_counter()
                n = model.learn_variants(corpus, lparams, strict=True)
                common_torch.sync(dev)
                dt = time.perf_counter() - t0
            calls = pipe.stats.counts.get("dispatch", 0)
            print(f"learn call {k} (collector {'off' if pause else 'on'}): "
                  f"{len(corpus)} words in {dt * 1e3:.3f} ms "
                  f"({len(corpus) / dt:.1f} words/s), {n} variants, "
                  f"{calls} dispatches; stages in total: "
                  f"{stage_line(pipe.stats, 1)}; gc {gcc.n} collections "
                  f"{gcc.ms:.3f} ms; learn_profile {model.learn_profile}")
        _, prof = profile_window(
            lambda: model.learn_variants(corpora[-1], lparams, strict=True),
            cuda)
        print(f"learn call {2 * args.calls} "
              f"{profile_line(prof, 1, 'call')}")
        return 0

    B = args.batch
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    n = len(batches)

    def one_pass(depth: int):
        return list(pipe.find_variants_stream(iter(batches), params,
                                              depth=depth))

    want = one_pass(2)  # warm-up
    print(f"{len(gc.get_objects())} objects tracked by the collector")
    for label, depth, pause in (("streamed", 2, False),
                                ("sequential", 0, False),
                                ("streamed, collector off", 2, True)):
        pipe.stats.clear()
        qps, gc_n, gc_ms = [], 0, 0.0
        for _ in range(args.passes):
            common_torch.sync(dev)
            with GcClock(pause) as gcc:
                t0 = time.perf_counter()
                got = one_pass(depth)
                common_torch.sync(dev)
                dt = time.perf_counter() - t0
            if got != want:
                raise SystemExit(f"{label}: the results differ between "
                                 "passes")
            qps.append(len(queries) / dt)
            gc_n, gc_ms = gc_n + gcc.n, gc_ms + gcc.ms
        print(f"{label} (depth {depth}): {args.passes} passes of "
              f"{len(queries)} queries in {n} batches: "
              f"{', '.join(f'{q:.1f}' for q in qps)} q/s (median "
              f"{statistics.median(qps):.1f}); per batch: "
              f"{stage_line(pipe.stats, n * args.passes)}; gc "
              f"{gc_n / args.passes:.1f} collections "
              f"{gc_ms / args.passes:.3f} ms per pass")
    _, prof = profile_window(lambda: one_pass(2), cuda)
    print(f"streamed {profile_line(prof, n, 'batch')}")
    if args.trace:
        with trace(args.trace):
            one_pass(2)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
