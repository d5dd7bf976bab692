#!/usr/bin/env python3
"""Attribute the port's query core to its stages: the ``stop_stage`` ladder.

The counterpart of ``tools/profile_device_stages.py`` for the PyTorch port.
One batch of ``--batch`` corrupted queries (default 4,096) on the model
(``tools/common_torch.py``), its pair budgets settled by two submit/collect
rounds; then ``ops.pipeline.query_core`` on the batch's kept device
arguments, stopped after each stage in turn (``noop``, ``stageA``,
``resolve``, ``gather_dl``, ``score``, ``compact_sum``) and whole. For each,
over 10 back-to-back calls: the host's time to enqueue one call
(until it returns, no sync), the card's ms per call by CUDA events (the
card held first, so the host is ahead), and the card's busy time and ops
per call from one ``torch.profiler`` window; each column also as the
difference from the stop before. A prefix returns int32 checksums, so each
difference is one stage's cost and the change in its checksums' cost; the
line under each stop splits its device ops into the hand-written kernels'
launches by kernel and the other ops (torch's, the checksums' among them),
and the next line names the other ops whose count changed from the stop
before.

    python3 tools/profile_device_stages_torch.py [--batch 4096]
        [--device cuda|cpu] [--lexicon FILE]

``--device cpu`` runs the same code on the CPU and reads only the host
clock.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import common_torch  # noqa: E402


# the device names (a part of each) of the port's hand-written kernels
KERNELS = ("planes_kernel", "stage_a_kernel", "resolve_kernel",
           "dl_lcs_kernel", "dl_lcs_slots_kernel", "compact_kernel")


def _kernel_ops(n_by_name) -> str:
    """A rung's device ops per call split into each hand-written kernel's
    and the rest."""
    counts = {k: sum(n for name, n in n_by_name.items() if k in name)
              for k in KERNELS}
    other = sum(n_by_name.values()) - sum(counts.values())
    return ", ".join([f"{k} {n:.1f}" for k, n in counts.items() if n]
                     + [f"other {other:.1f}"])


def _other_delta(n_by_name, prev_by_name) -> str:
    """The other ops (not a hand-written kernel's) whose count per call
    changed from the rung before, by name, most changed first."""
    def other(d):
        return {k: v for k, v in d.items()
                if not any(kern in k for kern in KERNELS)}

    now, before = other(n_by_name), other(prev_by_name)
    delta = {k: now.get(k, 0.0) - before.get(k, 0.0)
             for k in set(now) | set(before)}
    moved = sorted(((v, k) for k, v in delta.items() if abs(v) > 1e-9),
                   key=lambda x: (-abs(x[0]), x[1]))
    return "; ".join(f"{k[:70]} {v:+.1f}" for v, k in moved) or "none"


def _fmt(value, prev, digits: int) -> str:
    if value is None:
        return "not measured"
    delta = "" if prev is None else f" ({value - prev:+.{digits}f})"
    return f"{value:.{digits}f}{delta}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common_torch.add_args(ap)
    args = ap.parse_args(argv)

    from analiticcl_tpu_torch.ops.pipeline import query_core
    from analiticcl_tpu_torch.utils.profiling import (
        REPS, settled_batch, stop_ladder,
    )

    model, _words, queries, params = common_torch.setup(args, args.batch)
    pipe = model._pipeline()
    st, static = settled_batch(pipe, queries, params)
    cuda = pipe.device.type == "cuda"
    print(common_torch.card_line(args.device))
    print(f"batch: B={st['B']} ({len(st['active'])} queries), "
          f"P={static['P']} P2={static['P2']} window={static['window']} "
          f"nb_band={static['nb_band']} Ni_pad={pipe.Ni_pad}, "
          f"{REPS} back-to-back calls per stop")
    rungs = stop_ladder(
        lambda stop: query_core(pipe.index, *st["args"], **static,
                                stop_stage=stop),
        cuda)
    print("stop: enqueue ms | events ms | device busy ms | device ops, "
          "per call (difference from the stop before)")
    prev = None
    for r in rungs:
        print(f"{r.stop}: "
              f"{_fmt(r.enqueue_ms, prev and prev.enqueue_ms, 3)} | "
              f"{_fmt(r.event_ms, prev and prev.event_ms, 3)} | "
              f"{_fmt(r.busy_ms, prev and prev.busy_ms, 4)} | "
              f"{_fmt(r.n_ops, prev and prev.n_ops, 1)}")
        if r.n_by_name is not None:
            print(f"  device ops per call: {_kernel_ops(r.n_by_name)}")
            if prev is not None and prev.n_by_name is not None:
                print(f"  other ops changed: "
                      f"{_other_delta(r.n_by_name, prev.n_by_name)}")
        prev = r
    return 0


if __name__ == "__main__":
    sys.exit(main())
