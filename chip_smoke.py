#!/usr/bin/env python3
"""Drive the PyTorch port's query path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line: the card; the build of the five CUDA
sources in ``analiticcl_tpu_torch/csrc`` (one ``nvcc`` each, all at once;
with ptxas's registers, shared memory and spills); the stage-A kernel (K1)
against its plain PyTorch version (bit for bit) on seeded inputs with query
tiles of 8, 64, 1,024 and (from 262,144 index rows) 256, and at the main
path's shapes, after the query planes (K5, ``csrc/planes.cu``) bit for bit;
on the main path's first batch the slot resolve (K3,
``csrc/resolve.cu``, one launch) bit for bit and the DL+LCS kernel's slot
entry (K2 reading the pairs' strings from the tables) against their plain
versions, at the batch's budget (the slot entry at windows 3, 6 and 12,
int8 and int32 tables; its scoring epilogue, the main path's instance,
against the plain score with StopAtExactMatch off and on, zero weights and
seeded frequencies: keep, the frequency maxima, the per-block kept
counts and the survivors exact) and the survivor compaction (K4,
``csrc/compact.cu``, which writes the batch's one output buffer) bit for
bit at the batch's P2 and at one below its survivors, all at the batch's
budget and at one below its hit total (the overflow); the
DL+LCS kernel's pair-string entry against its plain version (DL clipped at
window + 1) on the main path's pairs at windows 3, 6 and 12, with the
ptxas summary and the shared memory per block of each window's instance;
CUDA-event and profiler times of the six beside their bounds at the
card's peaks (the 32-bit rate from its SM count and maximum SM clock).
Then the
main path:
``VariantModel(device="cuda")`` over a seeded synthetic lexicon of
eng.aspell's size, ``find_variants_stream`` over 16,384 corrupted queries,
and 1,024 ratio-threshold queries that reach the W=12 window and the window
split, held against the exact host oracle, and one ``torch.profiler`` window
over a warm 16,384-query pass (device time per kernel, idle share), and
the distinct core shapes (B, band, P, P2, window) of one pass of
``bench_torch.py``'s 65,536-query window. Then
search mode over 4,096 lines of running text (``find_all_matches_stream``,
bigram segments), the same with a seeded bigram language model whose
bigrams the text holds, and learn mode (strict over 4,096 corrupted words,
then over 512 lines, five corpora each), each held against the object-path
consolidation or the host oracle, each holding every kernel against its
plain version on its own first lookup batch, and each required to launch
every kernel. Then the CLI and the API (phase 9): the lexicon written to
files under ``build/chip_smoke_cli/``, a model read and built from them as
the CLI does it with every kernel held against its plain version on its
first query batch, and ``cli.main`` in this process for ``query`` (TSV, ``--json`` and ``-C``
with a seeded confusable list), ``search -N 2`` and ``learn --strict``,
each required to launch every kernel, their output held byte for byte
against the ``--backend oracle`` output on prefixes and the JSON against
``api.VariantModel.find_variants_par``. Then lexicon sharding (phase 10,
``parallel/mesh.py``, every mesh over ``cuda:0`` repeated): the main
lexicon, built anew, on 1x1, 1x4 and 2x2 meshes, each pass of the 16,384 queries equal to the
single-device pipeline's (and under StopAtExactMatch on 4,096), its first
256 to the oracle, K1 launched once per shard and batch, one profiler
window over the warm 1x4 pass; the same strict learn on a 2x2-meshed and
a single-device 120k model, with equal links, frequencies and lookups
after; and a seeded 1,000,000-entry lexicon on a 1x4 mesh: 4,096 queries
in batches of 2,048 against its single-device pipeline and the oracle, a
strict learn over 7,000 words, a re-shard and the oracle again. Each mesh
path holds every kernel against its plain version on its first batch's
call of shard 0. Then profiling (phase 11): the ``stop_stage`` ladder of
``query_core`` on the main batch (enqueue, CUDA-event and profiler time and
device ops per stop; the whole core after it equal to its outputs before),
the batch's roofline (``utils/roofline.py``) beside the core's time by
CUDA events and the main pass's wall time per batch, and one ``trace`` of two warm
batches under ``build/chip_smoke_trace/`` that must name every kernel (taken
again over 4, then 8 batches where it lost a kernel's records). Then a
lexicon wider than 64 (phase 12): the main lexicon plus seeded entries of
70, 100 and 300 letters (L 300, int32 metrics) serves queries (512 of
2,048 near a long entry), search over lines with long tokens and a 1x4
mesh of ``cuda:0``, each holding every kernel against its plain version on
its first 256 lookups (K4 at int32 metrics), launching K2's wide path (a
second launch, by the same C entry, for the pairs with a string over 64)
once after each slot-entry launch and equal to the oracle; then both K2
entries at L 100, 255, 256 and 300 against their plain versions (each
with two equal 255-letter strings; at L 300 also on lists long enough for
two pairs a warp), the wide path's times on the phase's batch, on a batch
without a pair over 64 and per 1M pairs, and K1 at planes 608, 864 and
960 wide. Then planes wider than a resident K1 block holds (phase
13): the main lexicon plus a 1,000-letter entry and a 64-letter one
holding one letter 50 times (planes 1,664 wide, L 1,000; one block that
wide, the rest 224 or less) serves query, search and a 1x4 mesh, each
holding every kernel against its plain version on its first 256 lookups,
equal to the oracle (the mesh to the single device); both K2 entries are
held at L 1,000 against their plain versions; K1 is held bit for
bit and timed beside its bounds (at the full width and at the blocks'
extents) on the first batch of 4,096 (streamed, each block at its
extent) and on the 4,096 shortest other queries (the main instance),
held at planes 992 to 6,016 wide, on planes whose blocks' extents run
from 32 to 1,664 and on a tile of 8 queries, and timed at 1,664 and
6,016 on a main-sized band. Each K1 launch routes by its width, the
widest block extent it reads: every path must launch only the instances
its index's extents route to (the main one for the main lexicon, the
main and resident ones for the CLI's and the 1M lexicon's, main and
streamed in phase 13), and phases 12 and 13's query and mesh paths the
widest one among them. K4's record also gives the library call's device
time. Then the configurations beyond plain lexicons (phase 14): the main
lexicon with weighted variant lists in both column layouts (14,000
references), an error list (4,000), 203 context rules, an LM and
confusables, read from files under ``build/chip_smoke_cli/`` through the
API's readers, serve 16,384 queries (StopAtExactMatch off and on) equal to
the oracle on the first 512, with rows on the object tail and results
through variant links and error forms (none showing an error form), and
search with the rules and the LM on the object consolidation, equal to a
host-only search with the oracle's lookups, tags included; a checkpoint
of that model, loaded onto the card and onto a 1x4 mesh of ``cuda:0``,
gives the same queries and lines; early confusables equal the oracle;
and the CLI's query (TSV, JSON, ``-s``, ``--early-confusables``),
search and strict learn with them equal the ``--backend oracle``
commands' output byte for byte (those run meanwhile in processes of
their own), ``index`` and ``testinput`` on ``--device cuda`` equal
``--device cpu``. The phase's model, the loaded one, its mesh and the
CLI's model hold every kernel on their first batch, and each of its
paths launches every kernel. The last two lines are the kernels' JSON
record (stamped with the commit, launches per path and K1's launches by
instance on each path; the wide path's launches are phases 12 and 13's,
the streamed instance's record phase 13's) and ``{"ok": true, ...}``.

Needs one CUDA card and ``nvcc``; exits non-zero on any failure, and when no
card is visible. Imports no JAX. Writes nothing outside the checkout's
``build/`` directory (the kernels' builds and phase 9's and 14's files).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

SEED = 0
N_LEXICON = 120_000  # eng.aspell holds 119,773 entries
BATCH = 4096
N_QUERIES = 16_384
N_RATIO = 1024
N_ORACLE = 1024
N_ORACLE_RATIO = 256
TARGET_PAIRS = 1 << 20
SLOT_WINDOWS = (3, 6, 12)  # the DL windows: absolute(2) gives 3, ratios 6, 12
N_LINES = 4096  # search mode: lines of 8-16 tokens
N_LINES_ORACLE = 32
N_BIGRAMS = 100_000  # entries of the bigram language model
N_LEARN_STRICT = 4096
N_LEARN_LINES = 512
N_LEARN_CALLS = 5  # learn calls per mode, each on its own corpus
N_LEARN_CHECK = 256
N_OTHER = 10_000  # entries of the CLI phase's second lexicon
MESHES = ((1, 1), (1, 4), (2, 2))  # (dp, lex) meshes of cuda:0, phase 10
N_MESH_ORACLE = 256
N_1M = 1_000_000  # the background lexicon of the JAX suite's sharded_1m
N_1M_QUERIES = 4096
BATCH_1M = 2048
N_1M_ORACLE = 64
N_1M_LEARN = 7000  # learn_1m's corpus
# (B, index rows, band blocks) of the direct K1 checks: query tiles of 8,
# 64 and 1,024, and 256 from 262,144 index rows up
K1_DIRECT = ((8, 32_768, 4), (64, 32_768, 8), (8192, 32_768, 8),
             (4096, 262_144, 16))
STAGES = ("search_prepare", "host_prep", "dispatch", "device", "device_get",
          "host_tail", "search_consolidate", "host_oracle_fallback")
BATCH_CUT = 1024  # batches of the cut-bucket run (one batch size, B=1024)
# csrc/<name>.cu
KERNEL_SOURCES = ("stage_a", "dl_lcs", "resolve", "compact", "planes")
# the wide phase: the main lexicon plus seeded entries of these normalized
# lengths, so L = 300; K2's wide path takes the pairs over 64
WIDE_LENGTHS = (70, 100, 300)
N_WIDE_EACH = 8  # long entries of each length
WIDE_BATCH = 1024
# lookups of the first batch that each wide path's holds and sync-free
# submit check take (the over-long queries of a batch go to the host
# oracle, which is slow at L 300)
WIDE_HOLD = 256
N_WIDE_QUERIES = 2048
N_WIDE_NEAR = 512  # of them near a long entry
N_WIDE_ORACLE = 64
N_WIDE_LINES = 256
N_WIDE_HOST_LINES = 8  # of them through the oracle-lookup host search
WIDE_PAIRS = 1 << 20  # the wide path's timing per 1M pairs
WIDE_TIMED = ((100, 3), (300, 3))  # (L, W) of that timing
WIDE_K1_T = (20, 28, 32)  # K1 at planes 30 x T wide (608, 864, 960)
N_LIGHT = 300  # queries of each light batch of the cut-bucket run
# the wide-planes phase: the main lexicon plus a 1,000-letter entry drawn
# as wide_words draws (this seed's holds 55 of one letter: planes 30 x 55
# = 1,650 wide, padded to 1,664; L 1,000) and a 64-letter one holding one
# letter 50 times
PLANES_SEED = SEED + 37
PLANES_AT = 1664
PLANES_BATCH = 4096  # the timed first batch: the main path's batch size
N_PLANES_QUERIES = 8192
N_PLANES_NEAR = 64  # of them near one of the two entries
PLANES_HOLD = 256
HOLD_AT_HITS_L = 512  # hold_kernels' budget rule from this L
N_PLANES_ORACLE_LONG = 3  # the longest queries the oracle checks (~1.2 s each)
N_PLANES_ORACLE = 32  # and the shortest
N_PLANES_LINES = 128
N_PLANES_HOST_LINES = 2
# K1 held directly at planes 30 x T wide: 992, 1,216, 1,664, 2,048, 6,016
PLANES_K1_T = (33, 40, 55, 68, 200)
# phase 14: the main lexicon with weighted variant and error lists,
# context rules, an LM and confusables, built from files under
# build/chip_smoke_cli/
N_VAR_REFS = 12_000  # references of the two-column variant list
N_VAR_FREQ_REFS = 2_000  # references of the frequency-bearing one
N_ERR_REFS = 4_000  # references of the error list
N_RULE_GROUPS = 29  # context rules, seven a group: 203
N_VAR_FORM_QUERIES = 4096  # of the 16,384 queries: forms, or forms edited
N_VAR_EXACT = 64  # exact lexicon words among the queries
N_VAR_UPPER = 64  # upper-cased queries
N_VAR_LINES = 1024  # lines of text, over whose bigrams the rules are made
N_VAR_SEARCH = 32  # of them searched: 203 rules make a line cost ~0.2 s
N_VAR_ORACLE = 512  # queries the oracle checks in query mode, and
N_VAR_ORACLE_MORE = 256  # under StopAtExactMatch and early confusables
N_VAR_EARLY = 4096
N_VAR_HOST_LINES = 8  # lines of the host search, and of the CLI's search
N_VAR_CLI_HEAD = 256  # queries of the oracle backend's query heads
N_VAR_LEARN = 512  # words of the CLI's strict learn


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of ``fn``, per call, after one warm-up. With ``inner`` > 1 the
    card has the next launch queued while it runs one, so a kernel that
    takes longer than its wrapper's host work is timed without that work."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int, per_call: int = 1,
              windows: int = 3) -> float | None:
    """The device time per call of ``fn`` in the CUDA kernels whose names
    contain ``kernel`` (``per_call`` launches of them per call), from a
    torch.profiler window over ``reps`` calls of ``fn`` (the kernels alone,
    without their wrapper's host work). None, logged as not measured, when
    none of ``windows`` windows kept at least half of the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        # the trace can miss a launch's record (9 of 10, and once all 10,
        # seen on an H100 with torch 2.11), never add one: the mean over
        # the records it kept is the time per launch
        if reps * per_call // 2 <= len(spans) <= reps * per_call:
            return (sum(tr.end - tr.start for tr in spans) / len(spans)
                    * per_call / 1e3)
        if len(spans) > reps * per_call:
            raise SystemExit(f"profiler saw {len(spans)} launches of "
                             f"{kernel}, more than {reps * per_call}")
        seen.append(len(spans))
    log(f"profiler device time of {kernel}: not measured (its windows kept "
        f"{seen} of {reps * per_call} launches)")
    return None


def device_all_ms(fn, reps: int) -> float | None:
    """The device time per call of ``fn`` summed over every CUDA kernel it
    launches (a library call's several), from one torch.profiler window
    over ``reps`` calls; None when the window kept no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    return sum(tr.end - tr.start for tr in spans) / reps / 1e3


def ms4(x: float | None) -> str:
    """A device time as the log lines print it."""
    return "not measured" if x is None else f"{x:.4f} ms"


def counted_wrappers() -> dict:
    """Each kernel's name in the ``kernels`` record and the wrapper that
    counts its launches: K1, K2 (either entry; the main path runs the slot
    entry, which adds to both its own count and K2's), K3, K2's slot
    entry, K4 and K5."""
    from analiticcl_tpu_torch.ops.dl import dl_lcs, dl_lcs_slots
    from analiticcl_tpu_torch.ops.pipeline import (
        compact_survivors, query_planes, resolve_pairs,
    )
    from analiticcl_tpu_torch.ops.stage_a import stage_a_masks

    return {"stage_a": stage_a_masks, "dl_lcs": dl_lcs,
            "resolve": resolve_pairs, "dl_lcs_slots": dl_lcs_slots,
            "compact": compact_survivors, "planes": query_planes}


# the device kernel name (a part of it) each count's launches run under
TRACE_NAMES = {"stage_a": "stage_a_kernel", "dl_lcs": "dl_lcs",
               "resolve": "resolve_kernel",
               "dl_lcs_slots": "dl_lcs_slots_kernel",
               "compact": "compact_kernel", "planes": "planes_kernel"}


def launch_counts(wide: bool = False) -> dict:
    """The launch counts since the last reset; with ``wide`` (a lexicon
    wider than 64) also K2's wide path's, ``dl_lcs_wide``."""
    from analiticcl_tpu_torch.ops.dl import wide_path

    counts = {k: fn.launches for k, fn in counted_wrappers().items()}
    if wide:
        counts["dl_lcs_wide"] = wide_path.launches
    return counts


def reset_counts() -> None:
    from analiticcl_tpu_torch.ops.dl import wide_path
    from analiticcl_tpu_torch.ops.stage_a import stage_a_masks

    for fn in counted_wrappers().values():
        fn.launches = 0
    wide_path.launches = 0
    stage_a_masks.launches_by_instance.update(
        dict.fromkeys(stage_a_masks.launches_by_instance, 0))


def k1_instances() -> dict:
    """K1's launches since the last reset by instance (main, resident,
    stream)."""
    from analiticcl_tpu_torch.ops.stage_a import stage_a_masks

    return dict(stage_a_masks.launches_by_instance)


def k1_routes(pipe) -> tuple:
    """The K1 instances a launch of the pipeline ``pipe`` may run on the
    card, narrowest first: each launch routes by its width, the largest
    extent of the blocks it reads (``convert.band_width``), so by one of
    its index's block extents, or on a mesh its shard's (main up to 224
    columns, resident up to 576, streamed above)."""
    from analiticcl_tpu_torch.ops.stage_a import (
        INSTANCES, KERNEL_QT, kernel_instance,
    )
    from analiticcl_tpu_torch.parallel.mesh import ShardedPipeline

    indexes = ([pipe.shard(d, s) for d in range(pipe.n_dp)
                for s in range(pipe.n_lex)]
               if isinstance(pipe, ShardedPipeline) else [pipe.index])
    names = {kernel_instance(w, idx.bins.shape[1], KERNEL_QT,
                             idx.bins.device)
             for idx in indexes for w in set(idx.extents_host.tolist())}
    return tuple(sorted(names, key=INSTANCES.get))


K1_CHECKED: dict = {}  # phase -> K1's launches by instance there


def require_k1(phase: str, total: int, k1: str | None = "main",
               routes: tuple | None = None) -> dict:
    """Fails unless K1's ``total`` launches since the last reset all ran
    instances of ``routes`` (default: ``k1`` alone), and ``k1`` (where
    given) at least once; records the launches by instance in
    K1_CHECKED and returns them."""
    by = k1_instances()
    routes = routes or (k1,)
    if (sum(by[r] for r in routes) != total or sum(by.values()) != total
            or (k1 is not None and by[k1] == 0)):
        raise SystemExit(f"{phase}: K1's {total} launches ran the "
                         f"instances {by}, not only {routes}"
                         + (f" with {k1} among them" if k1 else ""))
    K1_CHECKED[phase] = {r: by[r] for r in routes}
    return by


def require_launches(phase: str, wide: bool = False,
                     counts: dict | None = None, k1: str | None = "main",
                     routes: tuple | None = None) -> dict:
    """The launch counts since the last reset (:func:`launch_counts`), or
    ``counts``; fails unless every kernel was launched and K1's launches
    ran as :func:`require_k1` requires. With ``wide``, K2's wide path must
    follow each launch of its slot entry once; without, it must not have
    run."""
    from analiticcl_tpu_torch.ops.dl import wide_path

    if counts is None:
        counts = launch_counts(wide)
    if min(counts.values()) <= 0:
        raise SystemExit(f"{phase}: a kernel was not launched: {counts}")
    require_k1(phase, counts["stage_a"], k1, routes)
    if wide and counts["dl_lcs_wide"] != counts["dl_lcs_slots"]:
        raise SystemExit(f"{phase}: K2's wide path launched other than once "
                         f"a slot-entry launch: {counts}")
    if not wide and wide_path.launches:
        raise SystemExit(f"{phase}: K2's wide path ran at L <= 64: "
                         f"{wide_path.launches} launches")
    return counts


def with_wide_and_stream(counts: dict) -> dict:
    """``counts`` with the launches since the last reset of K2's wide path
    (``dl_lcs_wide``) and of K1's streamed instance (``stage_a_stream``),
    read from their counters, for those two kernels' records of a path
    that :func:`require_launches` checked."""
    from analiticcl_tpu_torch.ops.dl import wide_path

    return {**counts, "dl_lcs_wide": wide_path.launches,
            "stage_a_stream": k1_instances()["stream"]}


def require_one_buffer_per_call(phase: str, counts: dict) -> None:
    """Every core call of a path launches K5 with K1 (stage A) and K4 with
    K3 (stage B), once each."""
    if (counts["planes"], counts["compact"]) != (counts["stage_a"],
                                                 counts["resolve"]):
        raise SystemExit(f"{phase}: K5/K4 launches differ from K1/K3's: "
                         f"{counts}")


def stage_line(stats) -> str:
    """The StageTimer totals of the search and learn phases, with the count
    of over-long segments that took the host oracle."""
    parts = [f"{k} {stats.totals.get(k, 0.0) * 1e3:.1f} ms" for k in STAGES]
    parts.append(
        f"host_oracle_fallback count {stats.counts.get('host_oracle_fallback', 0)}"
    )
    return ", ".join(parts)


def match_signature(outs, tags: bool = False):
    """Search results as comparable tuples; with ``tags``, each match's
    context-rule tags and their sequence numbers too."""
    return [
        [
            (m.text, m.offset.begin, m.offset.end, m.selected, m.n,
             *((tuple(m.tag), tuple(m.seqnr)) if tags else ()),
             None if m.variants is None else [
                 (r.vocab_id, r.dist_score, r.freq_score, r.via)
                 for r in m.variants
             ])
            for m in out
        ]
        for out in outs
    ]


def k1_direct_inputs(seed: int, Ni: int, B: int, nb_band: int, A: int = 30,
                     T: int = 7, caps=None):
    """Seeded stage-A inputs on the card: charcount-sorted random count
    planes (A x T columns, 210 by default, threshold-major and zero-padded
    to a multiple of 32 as the index is; with ``caps``, the counts of
    consecutive 1024-row blocks capped at them in turn, so the blocks'
    extents differ), the last rows padding, a few queries exact anagrams
    of indexed rows, and a random band start per query tile."""
    import numpy as np
    import torch

    from analiticcl_tpu_torch.convert import count_planes
    from analiticcl_tpu_torch.ops.stage_a import ROW_BLOCK, _b_tile

    rng = np.random.default_rng(seed)
    ctype = np.int8 if T < 127 else np.int16
    counts = rng.integers(0, T + 1, size=(Ni, A), dtype=ctype) * (
        rng.random((Ni, A), dtype=np.float32) < 0.25)
    cc = counts.sum(1, dtype=np.int32)
    order = np.argsort(cc, kind="stable")
    counts, cc = counts[order], cc[order]
    if caps is not None:
        cap = np.resize(np.asarray(caps, ctype), Ni // ROW_BLOCK)
        counts = np.minimum(counts, cap.repeat(ROW_BLOCK)[:, None])
        cc = counts.sum(1, dtype=np.int32)
    at_pad = -(-A * T // 32) * 32
    bins = np.zeros((Ni, at_pad), np.int8)
    bins[:, :A * T] = count_planes(counts, T)
    valid = np.arange(Ni) < Ni - 100
    bins[~valid] = 0
    cc[~valid] = 1 << 28
    bt = _b_tile(B, Ni)
    start = rng.integers(0, Ni // ROW_BLOCK - nb_band + 1,
                         size=B // bt).astype(np.int32)
    # most queries are a row of their tile's band with 0-2 counts moved by
    # one (hits and exact hits), a quarter are random (mostly misses)
    lo = start.astype(np.int64)[np.arange(B) // bt] * ROW_BLOCK
    src = np.minimum(lo + rng.integers(0, nb_band * ROW_BLOCK, size=B),
                     Ni - 101)
    qc = counts[src].astype(np.int64)
    for k in range(2):
        col = rng.integers(0, A, size=B)
        step = rng.integers(-1, 2, size=B) * (rng.random(B) < 0.5)
        qc[np.arange(B), col] = np.clip(qc[np.arange(B), col] + step, 0, T)
    rand = rng.random(B) < 0.25
    qc[rand] = rng.integers(0, T + 1, size=(int(rand.sum()), A)) * (
        rng.random((int(rand.sum()), A)) < 0.25)
    qbin = np.zeros((B, at_pad), np.int8)
    qbin[:, :A * T] = count_planes(qc, T)
    q_cc = qc.sum(1).astype(np.int32)
    k_ana = rng.integers(0, 5, size=B).astype(np.int32)
    k_len = np.minimum(k_ana, rng.integers(0, 4, size=B)).astype(np.int32)
    k_ana[-3:] = k_len[-3:] = -1  # padding queries
    return tuple(torch.from_numpy(x).cuda() for x in (
        bins, cc, valid, qbin, q_cc, k_ana, k_len, start))


def k1_args(seed: int, Ni: int, B: int, nb_band: int, **kw) -> tuple:
    """K1's wrapper arguments on :func:`k1_direct_inputs` (``kw`` passed
    on): the inputs, ``nb_band``, and the block extents and launch width
    reckoned from the planes (``convert.k1_table``)."""
    from analiticcl_tpu_torch.convert import k1_table

    ins = k1_direct_inputs(seed, Ni, B, nb_band, **kw)
    return ins + (nb_band, *k1_table(ins[0], ins[7], nb_band))


def index_k1_args(idx, qbin, st, q_cc, k_ana, k_len, start_blk,
                  nb_band=None, width=None) -> tuple:
    """K1's wrapper arguments for a prepared batch ``st`` over the device
    index ``idx``: its band, and the width its band plan gives (or
    ``nb_band``/``width``: a mesh shard's)."""
    return (idx.bins, idx.cc, idx.validrows, qbin, q_cc, k_ana, k_len,
            start_blk, st["nb_band"] if nb_band is None else nb_band,
            idx.extents, st["width"] if width is None else width)


def k1_instances_of(args) -> str:
    """The K1 instance the wrapper's arguments ``args`` route to."""
    from analiticcl_tpu_torch.ops.stage_a import KERNEL_QT, kernel_instance

    return kernel_instance(args[10], args[0].shape[1], KERNEL_QT,
                           args[0].device)


def hold_k1(*args):
    """Hold the stage-A kernel against its plain version on ``args`` (the
    wrapper's arguments), bit for bit; returns (max abs error, bt, exact
    hits)."""
    import torch

    from analiticcl_tpu_torch.ops.stage_a import (
        _b_tile, stage_a_masks, stage_a_masks_plain,
    )

    got = stage_a_masks(*args)
    want = stage_a_masks_plain(*args)
    torch.cuda.synchronize()
    B = args[3].shape[0]
    for n, g, w in zip(("packed_q", "exact_q", "counts_t", "nmatch",
                        "nexact"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"stage_a kernel differs from plain in {n} at "
                             f"B={B}, Ni={args[0].shape[0]}, "
                             f"nb_band={args[8]}, width {args[10]}")
    if int(want[3].sum()) == 0:
        raise SystemExit(f"stage_a check at B={B} saw no hits")
    return 0, _b_tile(B, args[0].shape[0]), int(want[4].sum())


def hold_k5(idx, q_counts):
    """Hold the query planes' kernel (K5) against its plain version on a
    batch's counts, bit for bit, and its zeroing of stage A's totals;
    returns the planes and the zeroed totals."""
    import torch

    from analiticcl_tpu_torch.ops.pipeline import (
        query_planes, query_planes_plain,
    )

    totals = torch.full((2, q_counts.shape[0]), 7, dtype=torch.int32,
                        device=q_counts.device)
    got = query_planes(idx, q_counts, totals)
    want = query_planes_plain(idx, q_counts)
    torch.cuda.synchronize()
    if (got.dtype != want.dtype or got.shape != want.shape
            or not torch.equal(got, want) or bool((totals != 0).any())):
        raise SystemExit(f"planes kernel differs from plain at "
                         f"B={q_counts.shape[0]}, {tuple(got.shape)}")
    return got, totals


def hold_k4(name: str, args, P2: int) -> None:
    """Hold the survivor compaction's kernel (K4) against its plain version
    on ``args`` (its wrapper's arguments but P2) at ``P2``: the ten outputs
    bit for bit, and the buffer passed on by ``_pack`` without a copy."""
    import torch

    from analiticcl_tpu_torch.ops import pipeline as ppl

    got = ppl.compact_survivors(*args, P2)
    want = ppl.compact_survivors_plain(*args, P2)
    torch.cuda.synchronize()
    bad = [k for k, (g, w) in enumerate(zip(got, want))
           if g.dtype != w.dtype or g.shape != w.shape
           or not torch.equal(g, w)]
    flat, _ = ppl._pack(got)
    if got[7].is_cuda and flat.data_ptr() != got[7].data_ptr():
        bad.append("one buffer")
    if bad:
        raise SystemExit(f"{name}: compact kernel differs from plain in "
                         f"outputs {bad} at P2={P2}")


def prepared(pipe, lookups, params):
    """``pipe.prepare`` of ``lookups``, its uploads finished: they run on
    the pipeline's stream, and the caller reads them on the default one
    (which the allocator is told, so their memory outlives that use)."""
    import torch

    st = pipe.prepare(lookups, params)
    torch.cuda.synchronize()
    for t in st.get("args", ()):
        t.record_stream(torch.cuda.current_stream())
    return st


def stage_b_budget(pipe, B: int, sa, at_hits: bool = False) -> tuple:
    """The pair budgets a batch of size ``B`` with stage-A outputs ``sa``
    runs with (the sticky P, escalated to cover these hits as ``collect``
    escalates it, and the sticky P2), and the batch's hit total. With
    ``at_hits`` P is the smallest bucket that covers the hits instead."""
    from analiticcl_tpu_torch.ops import pipeline as ppl

    total = int(sa.nmatch.sum())
    P, P2 = pipe._budgets(B)
    P_hits = ppl._bucket(total, ppl.P_BUCKETS)
    return (P_hits if at_hits else max(P, P_hits)), P2, total


def score_variants(idx, sa, sc: dict, every: bool) -> list:
    """The epilogue inputs (``ops.dl.ScoreInputs``) of K2's slot entry as
    the main path gives them for a batch whose arguments ``sc`` holds
    (``stop_exact``, ``weights``, ``thr``, ``use_stop_exact``,
    ``have_freq``, ``pc_band``), labelled: the batch's own; with ``every``
    also StopAtExactMatch off and on, zero weights (lcs and case, the sum
    kept true) and seeded frequencies, some above 2**24."""
    import torch

    from analiticcl_tpu_torch.ops.dl import ScoreInputs
    from analiticcl_tpu_torch.ops.pipeline import THRESHOLD_SLACK
    from analiticcl_tpu_torch.testing import synthetic_frequencies

    use_exact = sc["stop_exact"] & (sa.nexact > 0)
    base = ScoreInputs(
        sc["pc_band"], sa.exact_q, use_exact if sc["use_stop_exact"] else None,
        sc["weights"], sc["thr"] - THRESHOLD_SLACK,
        idx.freqs if sc["have_freq"] else None)
    out = [("the batch's", base)]
    if not every:
        return out
    zw = sc["weights"].clone()
    zw[1] = zw[4] = 0.0
    zw[5] = zw[:5].sum()
    freqs = torch.from_numpy(synthetic_frequencies(
        SEED + 9, idx.freqs.shape[0])).to(idx.freqs.device)
    return out + [
        ("StopAtExactMatch off", base._replace(use_exact=None)),
        ("StopAtExactMatch on", base._replace(use_exact=sa.nexact > 0)),
        ("zero weights", base._replace(weights=zw)),
        ("frequencies", base._replace(freqs=freqs)),
    ]


def hold_glue(name: str, idx, sa, start_blk, P: int, q_norms, q_lens, k_ed,
              q_fl, W: int, sc: dict, every: bool = False, P2: int = 0):
    """Hold K3 (the slot resolve) against its plain version on stage A's
    outputs ``sa`` at budget ``P``, all five outputs bit for bit; then K2's
    slot entry against its plain version (the gathers, the plain DL and
    the affixes) on K3's slots: its metrics instance's LCS, prefix, suffix,
    query length, threshold and case flag bit for bit, DL clipped at
    ``W + 1`` (the kernel's contract), and DL and LCS bit for bit against
    K2's pair-string entry on the gathered strings (the same DP on the same
    strings), which is held against the same plain DL and LCS (DL clipped
    at ``W + 1``); and its main-path instance, the scoring epilogue, against
    the plain score on the plain metrics for each of
    :func:`score_variants` (``sc``, ``every``): the keep flags, the
    frequency maxima, the per-block kept counts and, through the survivor
    compaction (K4 on the kernels' outputs against its plain version on
    the plain ones), the ten outputs at P survivor slots exactly; then K4
    against its plain version on the kernels' own outputs
    (:func:`hold_k4`) at the batch's ``P2`` and at half its survivors (the
    overflow). Returns K3's slots, the pair strings and the valid
    count."""
    import torch

    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.ops import pipeline as ppl

    r_args = (sa.packed_q, sa.counts_t, sa.nmatch, start_blk,
              idx.bins.shape[0], P)
    got = ppl.resolve_pairs(*r_args)
    want = ppl.resolve_pairs_plain(*r_args)
    torch.cuda.synchronize()
    for n, g, w in zip(("q", "pc_band", "pc", "valid", "total"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise SystemExit(f"{name}: resolve kernel differs from plain in "
                             f"{n} at P={P}")
    q, pcb, pc, valid, total = got
    s_args = (idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid, W)
    m = tdl.dl_lcs_slots(*s_args)
    mp = tdl.dl_lcs_slots_plain(*s_args)
    pr = tdl.gather_pairs(idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid)
    ld_k2, lcs_k2 = tdl.dl_lcs(pr.a, pr.ql, pr.b, pr.cl, q_norms.shape[1], W)
    torch.cuda.synchronize()
    bad = [f for f, g, w in zip(tdl.SlotMetrics._fields[1:], m[1:], mp[1:])
           if g.dtype != w.dtype or not torch.equal(g, w)]
    if not torch.equal(m.ld.clamp(max=W + 1), mp.ld.clamp(max=W + 1)):
        bad.append("ld")
    if not (torch.equal(m.ld, ld_k2) and torch.equal(m.lcs, lcs_k2)):
        bad.append("ld/lcs against the pair-string entry")
    if not (torch.equal(ld_k2.clamp(max=W + 1), mp.ld.clamp(max=W + 1))
            and torch.equal(lcs_k2, mp.lcs)):
        bad.append("the pair-string entry's ld/lcs")
    if bad:
        raise SystemExit(f"{name}: dl_lcs slot entry differs from plain in "
                         f"{bad} at P={P}, W={W}")
    L = q_norms.shape[1]
    T = tdl.slot_block(L)
    for label, s in score_variants(idx, sa, dict(sc, pc_band=pcb), every):
        ks = tdl.dl_lcs_slots(*s_args, score=s)
        kp = tdl.score_slots_plain(mp, q, pc, valid, L, s)
        torch.cuda.synchronize()
        bad = [f for f, g, w in (("keep", ks.keep, kp.keep),
                                 ("max_freq", ks.max_freq, kp.max_freq),
                                 ("block counts", ks.counts, kp.counts))
               if g.dtype != w.dtype or not torch.equal(g, w)]
        survivors = ppl.compact_survivors(ks.keep, ks.counts, T, q, pc,
                                          ks.met, ks.max_freq, total, P)
        survivors_p = ppl.compact_survivors_plain(
            kp.keep, kp.counts, T, q, pc, kp.met, kp.max_freq, total, P)
        torch.cuda.synchronize()
        if not all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(survivors, survivors_p)):
            bad.append("compacted survivors")
        if bad:
            raise SystemExit(f"{name}: dl_lcs slot entry's epilogue differs "
                             f"from the plain score in {bad} ({label}) at "
                             f"P={P}, W={W}")
        n_keep = int(survivors_p[9])
        k4_args = (ks.keep, ks.counts, T, q, pc, ks.met, ks.max_freq, total)
        P2_over = max(1, n_keep // 2)
        for p2 in (P2 or P, P2_over):
            hold_k4(name, k4_args, p2)
        if every:
            log(f"{name}: slot entry's epilogue ({label}) equal to the plain "
                f"score: {n_keep} kept of {min(int(total), P)} valid "
                f"slots, max_freq max {int(ks.max_freq.max())}; K4 equal to "
                f"plain at P2={P2 or P} and {P2_over}")
    return got, pr, min(int(total), P)


def stage_b_slots(pipe, idx, sa, B: int, q_norms, q_lens, k_ed, q_fl,
                  start_blk, W: int, name: str, sc: dict,
                  every: bool = False, at_hits: bool = False):
    """K3's and K2's work as ``query_stage_b`` gives it from stage A's
    outputs ``sa`` at the budget of a batch of size ``B``
    (:func:`stage_b_budget`, ``at_hits`` passed on), both kernels held
    against their plain versions on it (:func:`hold_glue`). Returns the
    gathered pair strings (the pair-string entry's input), P, the valid
    slots and K3's slots."""
    P, P2, _total = stage_b_budget(pipe, B, sa, at_hits)
    slots, pr, n = hold_glue(name, idx, sa, start_blk, P, q_norms, q_lens,
                             k_ed, q_fl, W, sc, every, P2=P2)
    return pr, P, n, slots


def score_args(pipe, st) -> dict:
    """What :func:`score_variants` reads of a prepared batch ``st``."""
    (_qc, _qcc, _qn, _ql, _qf, _ka, _ke, _kl, stop_exact, _blk, weights,
     thr) = st["args"]
    return dict(stop_exact=stop_exact, weights=weights, thr=thr,
                use_stop_exact=st["use_stop_exact"],
                have_freq=bool(pipe.model.have_freq))


def k2_main_pairs(pipe, queries, params):
    """The main path's first batch of ``queries`` through stage A on the
    card, then K3 and K2's slot entry held against their plain versions at
    the batch's budget (at each of SLOT_WINDOWS; the slot entry's
    epilogue also with StopAtExactMatch off and on, zero weights and
    frequencies), and once more at a budget below its hit total (the
    overflow, W=3). Returns K2's pair-string input: its P slots ``(a, al,
    b, bl)``, the valid ones, and the distinct pairs repeated to
    TARGET_PAIRS; and the batch (stage A's outputs, its arrays, P) for
    timing K3 and the slot entry."""
    from analiticcl_tpu_torch.ops.pipeline import query_stage_a

    st = prepared(pipe, queries[:BATCH], params)
    (q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len, _se,
     start_blk, _w, _thr) = st["args"]
    idx = pipe.index
    hold_k5(idx, q_counts)
    sa = query_stage_a(idx, q_counts, q_cc, k_ana, k_len, start_blk,
                       st["nb_band"], st["width"])
    sc = score_args(pipe, st)
    pr, P, n, _slots = stage_b_slots(pipe, idx, sa, st["B"], q_norms,
                                     q_lens, k_ed, q_fl, start_blk, 3,
                                     "main batch", sc, every=True)
    # the slot entry's other instances, which the ratio-threshold queries
    # of the main path launch, on the same slots
    for W in SLOT_WINDOWS[1:]:
        hold_glue(f"main batch W={W}", idx, sa, start_blk, P, q_norms,
                  q_lens, k_ed, q_fl, W, sc, every=True)
    P_over = max(1, n // 2)
    _s, _p, n_over = hold_glue("main batch overflow", idx, sa, start_blk,
                               P_over, q_norms, q_lens, k_ed, q_fl, 3, sc)
    if n_over != P_over or n <= P_over:
        raise SystemExit(f"overflow check: {n_over} valid of {P_over} slots "
                         f"for {n} hits")
    slots = tuple(x.contiguous() for x in (pr.a, pr.ql, pr.b, pr.cl))
    reps = -(-TARGET_PAIRS // max(1, n))
    pairs = tuple(x[:n].repeat((reps,) + (1,) * (x.dim() - 1))[:TARGET_PAIRS]
                  .contiguous() for x in slots)
    main = dict(idx=idx, sa=sa, start_blk=start_blk, P=P, P_over=P_over,
                P2=pipe._budgets(st["B"])[1], q_counts=q_counts,
                batch=(q_norms, q_lens, k_ed, q_fl), sc=sc)
    return pairs, n, slots, P, main


def glue_records(main: dict, n_valid: int, card: str, peaks) -> list:
    """K3, K2's slot entry, K4 and K5 on the main path's first batch (held
    against their plain versions in :func:`k2_main_pairs`): CUDA-event and
    profiler times of the kernels, the plain versions' times and the bounds
    at the card's ``peaks`` (``utils/roofline.py``); K4's beside one
    library call's (``torch.nonzero_static`` of the keep flags and the
    gathers of the survivors' columns). The slot entry's are its
    main-path instance's (the scoring epilogue, the batch's own inputs;
    the plain version the plain metrics and the plain score) at each of
    SLOT_WINDOWS (its record's own numbers are W=3's, the main batch's
    window), after its int32 instance is held equal to its int8 one there;
    beside them its metrics instance's time at W=3 (the int32 metrics the
    holds and the `gather_dl` stop read). Their ``kernels`` records."""
    import torch

    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.ops import pipeline as ppl
    from analiticcl_tpu_torch.utils.roofline import (
        k2_slots_work, k3_bound_ms, k4_bound_ms, k5_bound_ms,
    )

    idx, sa, start_blk, P = (main[k] for k in ("idx", "sa", "start_blk",
                                                "P"))
    q_norms, q_lens, k_ed, q_fl = main["batch"]
    r_args = (sa.packed_q, sa.counts_t, sa.nmatch, start_blk,
              idx.bins.shape[0], P)
    k3 = {
        "ms": time_ms(lambda: ppl.resolve_pairs(*r_args), 10, inner=10),
        "device_ms": device_ms(lambda: ppl.resolve_pairs(*r_args),
                               "resolve_kernel", 10),
        "plain_ms": time_ms(lambda: ppl.resolve_pairs_plain(*r_args), 5),
    }
    k3["bound_ms"], k3["bound_by"] = k3_bound_ms(sa.counts_t, sa.nmatch,
                                                 start_blk, P, peaks)
    q, pcb, pc, valid, total = ppl.resolve_pairs(*r_args)
    qv, pv = q[:n_valid].long(), pc[:n_valid].long()
    L, B = q_norms.shape[1], q_lens.shape[0]
    n_q, n_c = int(torch.unique(qv).numel()), int(torch.unique(pv).numel())
    (_, score), = score_variants(idx, sa, dict(main["sc"], pc_band=pcb),
                                 False)
    exact_bytes = None
    if score.use_exact is not None:
        exact_bytes = int(torch.unique(qv * sa.exact_q.shape[1]
                                       + (pcb[:n_valid] >> 3)).numel())
    # the int32 instances (alphabets of 120 symbols or more) on the same
    # strings give the same metrics and scores
    idx32 = SimpleNamespace(norms2=idx.norms2.int(), norm_lens=idx.norm_lens,
                            first_lower=idx.first_lower, freqs=idx.freqs)
    by_window = {}
    for W in SLOT_WINDOWS:
        s_args = (idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid, W)
        s32_args = (idx32, q_norms.int(), *s_args[2:])
        pairs = ((tdl.dl_lcs_slots(*s_args), tdl.dl_lcs_slots(*s32_args)),
                 (tdl.dl_lcs_slots(*s_args, score=score),
                  tdl.dl_lcs_slots(*s32_args, score=score)))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for m8, m32 in pairs
                   for a, b in zip(m8, m32) if a is not None):
            raise SystemExit(f"dl_lcs slot entry: int32 tables differ from "
                             f"int8 at W={W}")

        def plain():
            m = tdl.dl_lcs_slots_plain(*s_args)
            return tdl.score_slots_plain(m, q, pc, valid, L, score)

        w = {
            "ms": time_ms(lambda: tdl.dl_lcs_slots(*s_args, score=score),
                          10, inner=10),
            "device_ms": device_ms(
                lambda: tdl.dl_lcs_slots(*s_args, score=score),
                "dl_lcs_slots_kernel", 10),
            "plain_ms": time_ms(plain, 3),
        }
        w["bound_ms"], w["bound_by"] = k2_slots_work(
            q_lens[qv], idx.norm_lens[pv], P, L, W, q_norms.element_size(),
            n_q, n_c, B=B, have_freq=score.freqs is not None,
            exact_bytes=exact_bytes).bound_ms(peaks)
        if W == SLOT_WINDOWS[0]:
            w["metrics_instance_ms"] = time_ms(
                lambda: tdl.dl_lcs_slots(*s_args), 10, inner=10)
            w["metrics_instance_device_ms"] = device_ms(
                lambda: tdl.dl_lcs_slots(*s_args), "dl_lcs_slots_kernel", 10)
        by_window[W] = w
        log(f"K2 slot entry W={W}: P={P} slots ({n_valid} valid) from K3's "
            f"slots, {q_norms.dtype} tables (int32 tables give the same "
            f"metrics and scores), its epilogue equal to the plain score; "
            f"kernel with the epilogue {w['ms']:.4f} ms (CUDA events, 10 "
            f"back-to-back calls; profiler device time "
            f"{ms4(w['device_ms'])})"
            + (f", the metrics instance {w['metrics_instance_ms']:.4f} ms "
               f"(device {ms4(w['metrics_instance_device_ms'])})"
               if "metrics_instance_ms" in w else "")
            + f", plain (gathers + plain DL + affixes + score) "
            f"{w['plain_ms']:.3f} ms, bound {w['bound_ms']:.4f} ms "
            f"({w['bound_by']}) | {card}")
    W = SLOT_WINDOWS[0]
    se = dict(by_window[W])

    # K4 on the batch's own scored slots at its P2, and K5 on its counts
    T = tdl.slot_block(L)
    P2 = main["P2"]
    ks = tdl.dl_lcs_slots(idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid, W,
                          score=score)
    k4_args = (ks.keep, ks.counts, T, q, pc, ks.met, ks.max_freq, total, P2)
    n_keep = int(ks.keep.sum())

    def library():
        at = torch.nonzero_static(ks.keep, size=P2)[:, 0]
        return q[at], pc[at], ks.met[:, at]

    k4 = {
        "ms": time_ms(lambda: ppl.compact_survivors(*k4_args), 10, inner=10),
        "device_ms": device_ms(lambda: ppl.compact_survivors(*k4_args),
                               "compact_kernel", 10),
        "plain_ms": time_ms(lambda: ppl.compact_survivors_plain(*k4_args),
                            10, inner=10),
        "library_ms": time_ms(library, 10, inner=10),
        "library_device_ms": device_all_ms(library, 10),
    }
    k4["bound_ms"], k4["bound_by"] = k4_bound_ms(P, P2, B, n_keep, T, peaks,
                                                 ks.met.element_size())
    q_counts = main["q_counts"]
    totals = torch.empty((2, B), dtype=torch.int32, device=q_counts.device)
    k5 = {
        "ms": time_ms(lambda: ppl.query_planes(idx, q_counts, totals), 10,
                      inner=10),
        "device_ms": device_ms(lambda: ppl.query_planes(idx, q_counts,
                                                        totals),
                               "planes_kernel", 10),
        "plain_ms": time_ms(lambda: ppl.query_planes_plain(idx, q_counts),
                            10, inner=10),
    }
    k5["bound_ms"], k5["bound_by"] = k5_bound_ms(B, q_counts.shape[1],
                                                 idx.at, peaks)
    mb = ks.met.element_size()
    log(f"K4 compact: P={P} slots ({n_keep} kept) into P2={P2}, one output "
        f"buffer of {8 * (B + 2) + (8 + 5 * mb) * P2} bytes, bit-identical "
        f"to plain, and at P2 below the survivors; kernel {k4['ms']:.4f} ms "
        f"(CUDA events, 10 back-to-back calls; profiler device time "
        f"{ms4(k4['device_ms'])}, one launch), plain (compact_index + "
        f"gathers) {k4['plain_ms']:.4f} ms, library (nonzero_static + "
        f"gathers) {k4['library_ms']:.4f} ms (device time of its kernels "
        f"{ms4(k4['library_device_ms'])}), bound {k4['bound_ms']:.4f} ms "
        f"({k4['bound_by']}) | {card}")
    log(f"K5 planes: B={B}, A={q_counts.shape[1]}, planes "
        f"{idx.bins.shape[1]} wide (AT {idx.at}), bit-identical to plain, "
        f"totals zeroed; kernel {k5['ms']:.4f} ms (CUDA events, 10 "
        f"back-to-back calls; profiler device time {ms4(k5['device_ms'])}, "
        f"one launch), plain {k5['plain_ms']:.4f} ms, bound "
        f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}) | {card}")
    log(f"K3 resolve: B={B}, {sa.counts_t.shape[0]} blocks of 128 band rows "
        f"per query, P={P} ({n_valid} valid), bit-identical to plain, and at "
        f"P={main['P_over']} below the hit total; kernel {k3['ms']:.4f} ms "
        f"(CUDA events, 10 back-to-back calls; profiler device time "
        f"{ms4(k3['device_ms'])}, one launch), plain "
        f"{k3['plain_ms']:.3f} ms, bound {k3['bound_ms']:.4f} ms "
        f"({k3['bound_by']}) | {card}")
    note = ("no single PyTorch call computes it: the plain version is a "
            "sequence of torch ops")
    return [
        {"name": "resolve", "route": "cuda",
         "source": "analiticcl_tpu_torch/csrc/resolve.cu",
         "replaces": "analiticcl_tpu/ops/pipeline.py:450-592",
         "max_abs_err": 0, **k3, "library_ms": None, "library_note": note,
         "P": P, "valid": n_valid, "P_overflow_held": main["P_over"]},
        {"name": "dl_lcs_slots", "route": "cuda",
         "source": "analiticcl_tpu_torch/csrc/dl_lcs.cu",
         "replaces": "analiticcl_tpu/ops/pipeline.py:594-647, 671-722",
         "max_abs_err": 0, **se, "library_ms": None, "library_note": note,
         "P": P, "valid": n_valid, "window": W, "by_window": by_window},
        {"name": "compact", "route": "cuda",
         "source": "analiticcl_tpu_torch/csrc/compact.cu",
         "replaces": "analiticcl_tpu/ops/pipeline.py:242-266, 726-750",
         "max_abs_err": 0, **k4,
         "library_note": "torch.nonzero_static(keep, size=P2) and the "
                         "gathers of the survivors' query, row and metrics "
                         "(no fill, no totals, no one buffer)",
         "P": P, "P2": P2, "kept": n_keep},
        {"name": "planes", "route": "cuda",
         "source": "analiticcl_tpu_torch/csrc/planes.cu",
         "replaces": "analiticcl_tpu/ops/pipeline.py:402-408",
         "max_abs_err": 0, **k5, "library_ms": None, "library_note": note,
         "B": B},
    ]


def k2_instance(L: int):
    """(LMAX, threads per block) of the DL+LCS kernel instance for strings
    of width L (csrc/dl_lcs.cu ``launch_w``)."""
    return (32, 128) if L <= 32 else (64, 64)


def k2_smem_bytes(W: int, L: int) -> int:
    """Dynamic shared memory per block of the DL+LCS kernel: a byte per
    state element per thread (csrc/dl_lcs.cu ``state_elems``)."""
    lmax, threads = k2_instance(L)
    return ((W + 3) * (L + 1) + L + (L if lmax > 32 else 0)) * threads


def dl_lcs_ptxas(report: str) -> dict:
    """ptxas's registers, stack frame and spills of each ``dl_lcs_kernel``
    instance in ``report``, keyed by (W, LMAX)."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"dl_lcs_kernelILi(\d+)ELi(\d+)E", m.group(1))
            key = (int(k.group(1)), int(k.group(2))) if k else None
            if key is not None:
                out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[key].update(stack=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key]["registers"] = int(m[1])
    return out


def profile_pass(fn) -> str:
    """One torch.profiler window over ``fn``: device time per kernel (the
    hand-written kernels, then the other device ops by time) and the device's
    idle share of the window's wall time (1 - the union of device intervals
    over the wall time). A window whose trace kept no device op (seen once
    on an H100) is taken again; fails when three windows saw no device
    time."""
    from analiticcl_tpu_torch.utils.profiling import profile_window

    for _ in range(3):
        _, prof = profile_window(fn, cuda=True)
        if prof.n_ops:
            break
    else:
        raise SystemExit("profile: the profiler saw no device time")
    by_name = prof.by_name
    ours = {"K5 planes": "planes_kernel", "K1 stage_a": "stage_a_kernel",
            "K3 resolve": "resolve_", "K2 dl_lcs": "dl_lcs",
            "K4 compact": "compact_kernel"}
    mine = {label: sum(v for k, v in by_name.items() if part in k)
            for label, part in ours.items()}
    rest = sorted(((v, k) for k, v in by_name.items()
                   if not any(part in k for part in ours.values())),
                  reverse=True)
    top = "; ".join(f"{k[:60]} {v:.3f} ms" for v, k in rest[:8])
    return (f"profile: wall {prof.wall_ms:.3f} ms, device busy "
            f"{prof.busy_ms:.3f} ms, idle share {prof.idle_share:.4f}, "
            f"{prof.n_ops} device ops; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in mine.items())
            + f", other device ops {sum(v for v, _ in rest):.3f} ms in "
            f"{len(rest)} kinds: {top}")


def hold_kernels(name: str, pipe, lookups, params) -> None:
    """Prepare ``lookups`` as one device batch, as the path does, and hold
    the query planes' kernel and the stage-A kernel (bit for bit), the slot
    resolve, K2's slot entry, the DL+LCS kernel's pair-string entry (DL
    clipped at the batch's window + 1, LCS exact) and the survivor
    compaction (:func:`hold_glue`) against their plain versions on it; on
    a sharded pipeline, on the call of mesh row 0 and lex shard 0. Above
    L 64 the batch must hold a pair over 64. From L HOLD_AT_HITS_L the
    glue is held at the smallest budget that covers the batch's hits (the
    plain DL's time grows with P x L**2; the slots past the hits are
    empty), below it at the path's own budget.
    Its launches count, so call it before the path's counts are reset."""
    import torch

    from analiticcl_tpu_torch.ops.dl import NARROW_LEN
    from analiticcl_tpu_torch.ops.pipeline import StageA
    from analiticcl_tpu_torch.ops.stage_a import (
        KERNEL_QT, kernel_instance, stage_a_masks,
    )
    from analiticcl_tpu_torch.parallel.mesh import ShardedPipeline

    t0 = time.perf_counter()
    st = prepared(pipe, lookups, params)
    if "args" not in st:
        raise SystemExit(f"{name}: the kernel check batch did not form one "
                         "device batch")
    (q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len, _se,
     start_blk, _w, _thr) = st["args"]
    nb_band, width = st["nb_band"], st["width"]
    where = ""
    if isinstance(pipe, ShardedPipeline):
        rows = slice(0, q_lens.shape[0] // pipe.n_dp)
        q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len = (
            x[rows] for x in (q_counts, q_cc, q_norms, q_lens, q_fl, k_ana,
                              k_ed, k_len))
        start_blk, nb_band, width, idx = (start_blk[0, 0], int(nb_band[0, 0]),
                                          int(width[0, 0]), pipe.shard(0, 0))
        where = (f" of mesh row 0, lex shard 0 ({idx.bins.shape[0]} shard "
                 f"rows)")
    else:
        idx = pipe.index
    qbin, totals = hold_k5(idx, q_counts)
    a_args = index_k1_args(idx, qbin, st, q_cc, k_ana, k_len, start_blk,
                           nb_band, width)
    hold_k1(*a_args)
    sa = StageA(*stage_a_masks(*a_args, totals=totals))
    W = st["window"]
    sc = score_args(pipe, st)
    if isinstance(pipe, ShardedPipeline):
        sc["stop_exact"] = sc["stop_exact"][rows]
    # K3, K2's two entries and K4 (hold_glue)
    pr, P, n_valid, _slots = stage_b_slots(
        pipe, idx, sa, st["B"], q_norms, q_lens, k_ed, q_fl, start_blk, W,
        name, sc, at_hits=pipe.L >= HOLD_AT_HITS_L)
    wide = ""
    if pipe.L > NARROW_LEN:  # the batch must reach K2's wide path
        n_wide = int((torch.maximum(pr.ql, pr.cl) > NARROW_LEN).sum())
        if not n_wide:
            raise SystemExit(f"{name}: no pair over {NARROW_LEN} to hold")
        wide = f" ({n_wide} over {NARROW_LEN})"
    pipe._oracle_memo.clear()  # the timed run meets over-long segments anew
    log(f"{name} kernels: K5 and K1 bit-identical to plain on "
        f"B={q_lens.shape[0]}{where} ({len(st['active'])} device lookups of "
        f"{len(lookups)}, band {nb_band * 1024} rows, K1 width {width}, "
        f"{kernel_instance(width, idx.bins.shape[1], KERNEL_QT, 'cuda')} "
        f"instance); K3 bit-identical to "
        f"plain, K2 (both entries) equal to plain at W={W} on the "
        f"{'hits' if pipe.L >= HOLD_AT_HITS_L else 'budget'}'s "
        f"P={P} slots, {n_valid} valid{wide}, K4 bit-identical to plain "
        f"({time.perf_counter() - t0:.2f} s)")


def sync_free_submit(name: str, pipe, lookups, params, card: str) -> None:
    """A warm ``submit`` of ``lookups`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at the first
    operation that makes the host wait for the card; then its ``collect``.
    Logs how long ``submit`` took and whether the card was still running the
    batch when it returned."""
    import torch

    pipe.collect(pipe.submit(lookups, params))  # warm: budgets, allocators
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        st = pipe.submit(lookups, params)
        dt = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    subs = [sub for _, sub in st["subs"]] if st.get("subs") else [st]
    events = [ev for sub in subs if "out" in sub for ev in sub["out"][1]]
    if not events:
        raise SystemExit(f"{name}: the submit launched no device call")
    running = not all(ev.query() for ev in events)
    t0 = time.perf_counter()
    pipe.collect(st)
    log(f"{name} submit: no host sync under set_sync_debug_mode('error') "
        f"({len(lookups)} lookups, {len(subs)} device call(s)); returned in "
        f"{dt * 1e3:.3f} ms with the card "
        f"{'still running the batch' if running else 'done'}, collect "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms | {card}")


def async_line(stats, n_batches: int) -> str:
    """The submit/collect stages of a pass: enqueue, wait and read."""
    parts = [f"{k} {stats.totals.get(k, 0.0) * 1e3:.3f} ms "
             f"({stats.counts.get(k, 0)} calls)"
             for k in ("host_prep", "dispatch", "device", "device_get",
                       "host_tail")]
    return f"{', '.join(parts)} over {n_batches} batches"


def cut_bucket_phase(model, queries, params, default, oracle, card) -> None:
    """The 16,384 queries through a fresh pipeline whose pair-budget ladder
    is cut to two buckets set from this run's stage-A totals, so that on the
    card the budgets step down (six light batches), escalate and overflow
    the top bucket (the heaviest batch, which splits in halves). The
    results must equal the default run's tuple for tuple, and the oracle's
    on the first 1,024."""
    import torch

    from analiticcl_tpu_torch.ops import pipeline as ppl

    pipe = ppl.DevicePipeline(model, "cuda")
    n_light = 6 * N_LIGHT
    lights = [list(range(k, k + N_LIGHT)) for k in range(0, n_light,
                                                          N_LIGHT)]
    chunks = [list(range(k, min(k + BATCH_CUT, len(queries))))
              for k in range(n_light, len(queries), BATCH_CUT)]

    def hits(rows):
        st = prepared(pipe, [queries[i] for i in rows], params)
        (q_counts, q_cc, _qn, _ql, _qf, k_ana, _ke, k_len, _se, start_blk,
         _w, _thr) = st["args"]
        sa = ppl.query_stage_a(pipe.index, q_counts, q_cc, k_ana, k_len,
                               start_blk, st["nb_band"], st["width"])
        return int(sa.nmatch.sum()), st["B"]

    light = [hits(r) for r in lights]
    full = [hits(c) for c in chunks]
    heavy = max(range(len(chunks)), key=lambda i: full[i][0])
    rest = [t for i, (t, b) in enumerate(full) if i != heavy and b == 1024]
    low = int(max(t for t, _ in light) * pipe.DEESC_MARGIN) + 1
    top = max(rest)
    # the first budget of a batch size is the bucket of half the index rows:
    # it must be the top one, for the light batches to step it down
    first = pipe._budget_rows // 2
    if not (low < first <= top < full[heavy][0]
            and all(b == 1024 for _, b in light)):
        raise SystemExit(f"cut-bucket run: no ladder fits the totals "
                         f"(light {light}, full {full})")
    batches = [[queries[i] for i in r] for r in lights + chunks]
    order = [i for r in lights + chunks for i in r]
    seen, splits = [], []
    collect, split = pipe.collect, pipe._collect_split

    def counted_collect(state):
        out = collect(state)
        seen.append(pipe._P_by_B.get(1024))
        return out

    pipe.collect = counted_collect
    pipe._collect_split = lambda state: splits.append(1) or split(state)
    saved = ppl.P_BUCKETS
    ppl.P_BUCKETS = (low, top)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [r for res in pipe.find_variants_stream(iter(batches), params)
               for r in res]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        ppl.P_BUCKETS = saved
    steps = [b for a, b in zip(seen, seen[1:]) if a is not None and b != a]
    down = sum(b < a for a, b in zip(seen, seen[1:])
               if a is not None and b is not None)
    up = sum(b > a for a, b in zip(seen, seen[1:])
             if a is not None and b is not None)
    if not (down and up and splits):
        raise SystemExit(f"cut-bucket run: budgets {seen}, {len(splits)} "
                         "splits: no de-escalation, escalation or split")
    by_query = dict(zip(order, got))
    want = [default[i] for i in order]
    require_equal("cut-bucket run", [by_query[i] for i in order], want,
                  [queries[i] for i in order])
    require_equal("cut-bucket run oracle", [by_query[i] for i in
                                            range(len(oracle))], oracle,
                  queries[:len(oracle)])
    log(f"cut buckets: P ladder ({low}, {top}) from this run's totals (light "
        f"batches {[t for t, _ in light]}, heaviest {full[heavy][0]}); "
        f"{len(batches)} batches, {len(queries)} queries in {dt:.3f} s; "
        f"budget steps {steps} ({down} down, {up} up), {len(splits)} "
        f"top-bucket split(s); equal to the default run on {len(queries)} "
        f"queries and to the oracle on {len(oracle)} | {card}")
    log(f"cut buckets stages: {async_line(pipe.stats, len(batches))}")
    del pipe


def search_phase(name: str, model, texts, params, card: str,
                 hold_n: int = 0, n_host: int = N_LINES_ORACLE,
                 k1: str | None = "main", routes: tuple | None = None) -> dict:
    """Search ``texts`` through the device path; hold the array-native
    consolidation against the object path and the first lines against a
    host-only search with the oracle's lookups (the first ``n_host``
    lines), and every kernel against its plain version on the path's first
    lookup batch (its first ``hold_n`` lookups, if given; the sync-free
    ``submit`` check takes the same lookups). K1's launches must run as
    :func:`require_k1` requires of ``k1`` and ``routes``."""
    import torch

    from analiticcl_tpu_torch.models import search_fast
    from analiticcl_tpu_torch.models.variant_model import SEARCH_BATCH
    from analiticcl_tpu_torch.ops.dl import NARROW_LEN
    from analiticcl_tpu_torch.testing import lm_bigram_hits

    pipe = model._pipeline()
    list(model.find_all_matches_stream(texts[:64], params))  # warm-up
    lookups = search_fast.prepare_unit(texts, params.max_ngram).all_texts
    hold_kernels(name, pipe, lookups[:hold_n or SEARCH_BATCH], params)
    sync_free_submit(name, pipe, lookups[:hold_n or SEARCH_BATCH], params,
                     card)
    reset_counts()
    pipe.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(model.find_all_matches_stream(texts, params))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = require_launches(name, wide=pipe.L > NARROW_LEN, k1=k1,
                                routes=routes)
    stages = stage_line(pipe.stats)
    if len(got) != len(texts):
        raise SystemExit(f"{name}: {len(got)} results for {len(texts)} lines")
    sig = match_signature(got)
    t1 = time.perf_counter()
    model.fast_consolidate = False
    try:
        obj = match_signature(model.find_all_matches_stream(texts, params))
    finally:
        model.fast_consolidate = True
    t_obj = time.perf_counter() - t1
    if obj != sig:
        bad = sum(a != b for a, b in zip(obj, sig))
        raise SystemExit(f"{name}: {bad} lines differ from the object path")
    t1 = time.perf_counter()
    head = texts[:n_host]
    preps, uniq, head_lookups = model._fam_prepare(head, params)
    found = [model._find_variants_oracle(q, params) for q in head_lookups]
    host = match_signature(model._fam_consolidate(preps, uniq, found, params))
    t_host = time.perf_counter() - t1
    if host != sig[:n_host]:
        bad = sum(a != b for a, b in zip(host, sig))
        raise SystemExit(f"{name}: {bad} lines differ from the host search")
    n_tok = sum(len(t.split()) for t in texts)
    n_sel = sum(m[3] is not None for out in sig for m in out)
    lm = ""
    if model.have_lm:
        hits = lm_bigram_hits(model, got)
        if hits == 0:
            raise SystemExit(f"{name}: the decode selected no LM bigram")
        lm = f", {hits} adjacent selections are LM bigrams"
    log(f"{name}: {len(texts)} lines, {n_tok} tokens in {dt:.3f} s: "
        f"{n_tok / dt:.1f} tokens/s, {len(texts) / dt:.1f} lines/s; "
        f"{len(lookups)} distinct segments, {n_sel} matches selected{lm}; "
        f"launches {launches} | {card}")
    log(f"{name} stages: {stages}")
    log(f"{name} checks: equal to the object path on {len(texts)} lines "
        f"({t_obj:.1f} s), to the oracle-lookup host search on "
        f"{len(head)} lines ({len(head_lookups)} lookups, {t_host:.1f} s)")
    return launches


def learn_phase(model, words, card: str) -> dict:
    """Strict learn over corrupted words, then learn over running text, each
    over several corpora and each refreshing the index frequencies in
    place; then lookups whose candidates gained variant links must equal
    the oracle."""
    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantReferenceKind,
    )
    from analiticcl_tpu_torch.models import search_fast
    from analiticcl_tpu_torch.models.variant_model import (
        LEARN_BATCH, SEARCH_BATCH,
    )
    from analiticcl_tpu_torch.testing import corrupt_queries, synthetic_text

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        max_ngram=2,
    )
    pipe = model._pipeline()
    corpora = [corrupt_queries(words, SEED + 10 + k, N_LEARN_STRICT)
               for k in range(N_LEARN_CALLS)]
    texts = [synthetic_text(words, SEED + 20 + k, N_LEARN_LINES)
             for k in range(N_LEARN_CALLS)]
    hold_kernels("learn strict", pipe, corpora[0][:LEARN_BATCH], params)
    hold_kernels("learn search", pipe, search_fast.prepare_unit(
        texts[0], params.max_ngram).all_texts[:SEARCH_BATCH], params)
    reset_counts()
    pipe.stats.clear()
    for mode, sets, unit in (("strict", corpora, "words"),
                             ("search", texts, "lines")):
        times = []
        for k, data in enumerate(sets):
            t0 = time.perf_counter()
            n = model.learn_variants(data, params, strict=mode == "strict")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if model.learn_profile["build_mode"] != "freq_refresh":
                raise SystemExit(f"learn {mode}: {model.learn_profile}")
            if model._device is not pipe:
                raise SystemExit(f"learn {mode}: the pipeline was rebuilt")
            log(f"learn {mode} call {k}: {len(data)} {unit} in "
                f"{times[-1]:.3f} s, {n} variants; learn_profile "
                f"{model.learn_profile}")
        dt = statistics.median(times)
        log(f"learn {mode}: median of {len(sets)} calls of {len(sets[0])} "
            f"{unit}: {dt:.3f} s, {len(sets[0]) / dt:.1f} {unit}/s | {card}")
    launches = require_launches("learn")
    stages = stage_line(pipe.stats)

    # indexed entries that gained links: VARIANT_OF links (expanded in the
    # results) first, then REFERENCE_FOR links (ranked by the object tail)
    VAR_OF = VariantReferenceKind.VARIANT_OF
    var_of, ref_for = [], []
    for v in model.index.vocab_ids.tolist():
        links = model.decoder[v].variants
        if links:
            kinds = var_of if any(r.kind is VAR_OF for r in links) else ref_for
            kinds.append(model.decoder[v].text)
    linked = var_of + ref_for
    half = N_LEARN_CHECK // 2
    if len(var_of) < 16 or len(linked) < half:
        raise SystemExit(f"learn: only {len(var_of)} + {len(ref_for)} "
                         "indexed entries gained links")
    queries = linked[:half] + corrupt_queries(linked[:half], SEED + 7, half)
    got = model.find_variants_batch(queries, params)
    want = [model._find_variants_oracle(q, params) for q in queries]
    if got != want:
        bad = [q for q, a, b in zip(queries, got, want) if a != b]
        raise SystemExit(f"learn: {len(bad)} queries differ from the oracle "
                         f"after the frequency refresh: {bad[:5]}")
    n_via = sum(r.via is not None for res in got for r in res)
    if n_via == 0:
        raise SystemExit("learn: no result came via a variant link")
    log(f"learn stages: {stages}")
    log(f"learn check: {len(var_of)} indexed entries gained VARIANT_OF links "
        f"and {len(ref_for)} only REFERENCE_FOR links; {len(queries)} queries "
        f"over them equal the oracle after the in-place refresh, {n_via} "
        f"results via a variant link; launches {launches}")
    return launches


class StampedStderr(io.TextIOBase):
    """Passes writes on to the process's stderr and notes when the CLI
    announces its serving loop, which it does right after its model is
    read and built."""

    SERVING = ("Querying the model", "Finding all variants", "Collecting")

    def __init__(self):
        self.serving_at = None

    def write(self, s: str) -> int:
        if self.serving_at is None and s.startswith(self.SERVING):
            self.serving_at = time.perf_counter()
        return sys.__stderr__.write(s)


def run_cli(name: str, argv, stdin_path: Path, stdout_path: Path,
            serves: bool = True):
    """``cli.main(argv)`` in this process, its standard input and output
    redirected to files; returns (wall seconds, seconds to the model's read
    and build, the launch counts of the run). Fails unless it exits 0 and,
    where it ``serves`` (query, search, learn), announced its serving
    loop."""
    import torch

    from analiticcl_tpu_torch import cli

    gc.collect()
    reset_counts()
    err = StampedStderr()
    old = sys.stdin
    with open(stdin_path, encoding="utf-8") as fin, \
            open(stdout_path, "w", encoding="utf-8") as fout:
        sys.stdin = fin
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(fout), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(list(argv))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            sys.stdin = old
    if rc != 0 or (serves and err.serving_at is None):
        raise SystemExit(f"{name}: cli.main exited {rc}")
    return (dt, err.serving_at - t0 if serves else dt, launch_counts())


def write_lines(path: Path, lines) -> Path:
    path.write_text("".join(f"{line}\n" for line in lines), encoding="utf-8")
    return path


def cli_phase(words, queries, texts, card: str) -> dict:
    """The CLI and the API on the card: a model built from lexicon files as
    the CLI builds it, every kernel held against its plain version on
    the CLI's first query batch, then ``cli.main`` for query (TSV and
    JSON), search and strict learn, each required to launch every kernel;
    the device output against the oracle backend's on prefixes, and
    ``api.VariantModel.find_variants_par`` against the JSON run."""
    import torch

    from analiticcl_tpu_torch import api, cli
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, synthetic_confusables,
        synthetic_frequencies, synthetic_lexicon,
    )

    d = Path("build/chip_smoke_cli")
    d.mkdir(parents=True, exist_ok=True)
    known = set(words)
    other = [w for w in synthetic_lexicon(SEED + 40, 2 * N_OTHER)
             if w not in known][:N_OTHER]
    freqs = synthetic_frequencies(SEED + 41, len(words))
    alphabet = write_lines(d / "alphabet.tsv", ["\t".join(c) for c in ALPHABET])
    lexicon = write_lines(d / "lexicon.tsv",
                          [f"{w}\t{f}" for w, f in zip(words, freqs)])
    lexicon2 = write_lines(d / "other.tsv", [f"{w}\t3" for w in other])
    confusables = write_lines(d / "confusables.tsv",
                              synthetic_confusables(words, SEED + 43))
    learn_words = corrupt_queries(words, SEED + 42, N_LEARN_STRICT)
    inputs = {
        "queries": write_lines(d / "queries.txt", queries),
        "queries_head": write_lines(d / "queries_head.txt", queries[:N_ORACLE]),
        "text": write_lines(d / "text.txt", texts),
        "text_head": write_lines(d / "text_head.txt", texts[:N_LINES_ORACLE]),
        "learn": write_lines(d / "learn.txt", learn_words),
        "learn_head": write_lines(d / "learn_head.txt",
                                  learn_words[:N_LEARN_CHECK]),
    }
    common = ["-a", str(alphabet), "-l", str(lexicon), "-l", str(lexicon2),
              "--device", "cuda"]

    # the model as the CLI builds it, and every kernel on its first batch
    t0 = time.perf_counter()
    args = cli.build_argparser().parse_args(
        ["query", *common, "--backend", "device"])
    model, params = cli.build_model_from_args(args)
    t_load = time.perf_counter() - t0
    model.build()
    pipe = model._pipeline()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"cli model: {len(words)} + {len(other)} lexicon entries from files, "
        f"index {model.index.size}, read in {t_load:.3f} s, read and built "
        f"in {t_build:.3f} s | {card}")
    hold_kernels("cli", pipe, queries[:cli.MAX_BATCHSIZE], params)
    # the second lexicon deepens the planes (T 8): each launch takes the
    # instance of the widest block it reads
    routes = k1_routes(pipe)
    log(f"cli model: planes {pipe.index.bins.shape[1]} wide, block extents "
        f"{sorted(set(pipe.index.extents_host.tolist()))}: K1's instances "
        f"{routes}")
    del model, pipe
    gc.collect()

    runs = {  # name: (argv, input, unit, count)
        "cli_query": (["query", *common, "--backend", "device"], "queries",
                      "queries", len(queries)),
        "cli_query_json": (["query", *common, "--backend", "device", "--json"],
                           "queries", "queries", len(queries)),
        "cli_query_confusables": (["query", *common, "--backend", "device",
                                   "-C", str(confusables)],
                                  "queries", "queries", len(queries)),
        "cli_search": (["search", *common, "--backend", "device", "-N", "2"],
                       "text", "tokens", sum(len(t.split()) for t in texts)),
        "cli_learn": (["learn", *common, "--backend", "device", "--strict"],
                      "learn", "words", len(learn_words)),
    }
    by_path, out = {}, {}
    for name, (argv, src, unit, n) in runs.items():
        out[name] = d / f"{name}.out"
        dt, t_model, counts = run_cli(name, argv, inputs[src], out[name])
        if min(counts.values()) <= 0:
            raise SystemExit(f"{name}: a kernel was not launched: {counts}")
        require_k1(name, counts["stage_a"], None, routes)
        by_path[name] = counts
        log(f"{name}: {n} {unit} in {dt:.3f} s wall, of which {t_model:.3f} s "
            f"to read and build the model and {dt - t_model:.3f} s to serve "
            f"and emit: {n / (dt - t_model):.1f} {unit}/s served, "
            f"{n / dt:.1f} {unit}/s over the wall; "
            f"{out[name].stat().st_size} bytes out; launches {counts} | {card}")

    # exactness against the oracle backend
    def lines(path):
        return path.read_text(encoding="utf-8").split("\n")

    query_out = lines(out["cli_query"])
    if len(query_out) != len(queries) + 1:
        raise SystemExit(f"cli_query: {len(query_out) - 1} lines for "
                         f"{len(queries)} queries")
    conf_out = lines(out["cli_query_confusables"])
    if len(conf_out) != len(query_out) or conf_out == query_out:
        raise SystemExit("cli_query_confusables: the confusables changed no "
                         "line, or the line count")
    checks = []
    for name, argv, src, want in (
        ("query", runs["cli_query"][0], "queries_head",
         query_out[:N_ORACLE]),
        ("query -C", runs["cli_query_confusables"][0], "queries_head",
         conf_out[:N_ORACLE]),
        ("search", runs["cli_search"][0], "text_head", None),
        ("learn", runs["cli_learn"][0], "learn_head", None),
    ):
        t0 = time.perf_counter()
        if want is None:  # the device run on the head of the input
            path = d / f"{name}_head_device.out"
            run_cli(name, argv, inputs[src], path)
            want = lines(path)
        path = d / f"{name.replace(' -C', '_confusables')}_head_oracle.out"
        oracle = [a if a != "device" else "oracle" for a in argv]
        run_cli(name, oracle, inputs[src], path)
        got = lines(path)[:len(want)]
        if got != want or len(want) < 16:
            bad = sum(a != b for a, b in zip(got, want))
            raise SystemExit(f"cli {name}: {bad} of {len(want)} lines differ "
                             f"from the oracle backend")
        checks.append(f"{name} {len(want)} lines ({time.perf_counter() - t0:.1f} s)")
    log(f"cli checks: device output equal to the oracle backend's, byte for "
        f"byte: {', '.join(checks)}")

    # the API over the first 4,096 queries against the JSON run
    entries = json.loads(out["cli_query_json"].read_text(encoding="utf-8"))
    if len(entries) != len(queries):
        raise SystemExit(f"cli_query_json: {len(entries)} entries for "
                         f"{len(queries)} queries")
    t0 = time.perf_counter()
    m = api.VariantModel(str(alphabet), api.Weights(), device="cuda")
    m.read_lexicon(str(lexicon))
    m.read_lexicon(str(lexicon2))
    m.build()
    t_api_build = time.perf_counter() - t0
    sp = api.SearchParameters(
        max_anagram_distance=3, max_edit_distance=2, max_matches=10,
        score_threshold=0.25, cutoff_threshold=2.0, freq_weight=0.0,
        stop_at_exact_match=False,
    )
    head = queries[:BATCH]
    reset_counts()
    t0 = time.perf_counter()
    par = m.find_variants_par(head, sp)
    dt = time.perf_counter() - t0
    counts = require_launches("api", k1=None, routes=routes)
    keys = ("text", "score", "dist_score", "freq_score")
    got = [(r["input"], [tuple(v[k] for k in keys) for v in r["variants"]])
           for r in par]
    want = [(e["input"], [tuple(v[k] for k in keys) for v in e.get("variants", [])])
            for e in entries[:len(head)]]
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise SystemExit(f"api: {bad} of {len(head)} results differ from the "
                         f"CLI's JSON")
    log(f"api: VariantModel(device='cuda') read and built in "
        f"{t_api_build:.3f} s; find_variants_par over {len(head)} queries in "
        f"{dt:.3f} s ({len(head) / dt:.1f} q/s), equal to the CLI's JSON "
        f"(text, score, dist_score, freq_score); launches {counts} | {card}")
    del m
    gc.collect()
    return by_path


def core_shapes(model, words, params) -> dict:
    """The distinct static shapes (B, nb_band, P, P2, window) of the core
    calls of one pass over a window of ``bench_torch.py``'s
    ``query_synth120k`` cell (65,536 queries of its traffic, batches of
    4,096), each with its number of calls: what CUDA graphs per shape
    would have to cover. The pass runs after the path's counts are read."""
    from bench_torch import BATCH as CELL_BATCH, N_QUERIES as CELL_QUERIES
    from bench_torch import corrupted

    from analiticcl_tpu_torch.ops import pipeline as ppl

    window = corrupted(words[::7], CELL_QUERIES, SEED, 0)
    seen: dict = {}
    core = ppl.query_core

    def recording(index, *args, **kw):
        key = (args[0].shape[0], kw["nb_band"], kw["P"], kw["P2"],
               kw["window"])
        seen[key] = seen.get(key, 0) + 1
        return core(index, *args, **kw)

    ppl.query_core = recording
    try:
        list(model.find_variants_stream(window, params, CELL_BATCH))
    finally:
        ppl.query_core = core
    return {"queries": len(window), "calls": sum(seen.values()),
            "distinct": sorted(seen.items())}


def cuda_mesh(n_dp: int, n_lex: int):
    """A ("dp", "lex") mesh whose devices are all ``cuda:0``."""
    from analiticcl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(["cuda:0"] * (n_dp * n_lex), dp=n_dp)


def timed_stream(model, queries, params, batch: int, wide: bool = False):
    """One warm pass of ``find_variants_stream``: (results, seconds,
    launches, with K2's wide path's if ``wide``); the counts are reset
    just before it."""
    import torch

    list(model.find_variants_stream(queries[:batch], params, batch))  # warm
    reset_counts()
    model._device.stats.clear()
    model._device.candidates = model._device.survivors = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(model.find_variants_stream(queries, params, batch))
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0, launch_counts(wide)


def require_equal(name: str, got, want, queries) -> None:
    if got != want:
        bad = [q for q, a, b in zip(queries, got, want) if a != b]
        raise SystemExit(f"{name}: {len(bad)} of {len(queries)} results "
                         f"differ: {bad[:5]}")


def mesh_query_phase(words, queries, params, card: str) -> dict:
    """Phase 10 (a): the main model's lexicon, built anew (learn's links
    would send most rows to the object tail), sharded over 1x1, 1x4 and
    2x2 meshes of ``cuda:0``. Each mesh's 16,384-query pass equals the
    single-device pipeline's tuple for tuple (and under StopAtExactMatch on
    4,096 queries), its first 256 queries equal the oracle, and it launches
    K1 once per shard and batch; one profiler window over the warm 1x4
    pass."""
    import dataclasses

    from analiticcl_tpu_torch import StopCriterion, VariantModel
    from analiticcl_tpu_torch.testing import ALPHABET, populate

    stop = dataclasses.replace(
        params, stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    model._pipeline()
    single, dt, base = timed_stream(model, queries, params, BATCH)
    single_stop = list(model.find_variants_stream(queries[:BATCH], stop,
                                                  BATCH))
    t0 = time.perf_counter()
    head = queries[:N_MESH_ORACLE]
    oracle = [model._find_variants_oracle(q, params) for q in head]
    require_equal("single device vs oracle", single[:N_MESH_ORACLE], oracle,
                  head)
    log(f"mesh reference: single-device pipeline {N_QUERIES} queries "
        f"{N_QUERIES / dt:.1f} q/s, launches {base}; oracle on "
        f"{N_MESH_ORACLE} ({time.perf_counter() - t0:.1f} s) | {card}")
    by_path = {}
    for n_dp, n_lex in MESHES:
        name = f"mesh_{n_dp}x{n_lex}"
        t0 = time.perf_counter()
        model.use_mesh(cuda_mesh(n_dp, n_lex))
        pipe = model._device
        t_shard = time.perf_counter() - t0
        hold_kernels(name, pipe, queries[:BATCH], params)
        if (n_dp, n_lex) == (1, 4):
            sync_free_submit(name, pipe, queries[:BATCH], params, card)
        got, dt, counts = timed_stream(model, queries, params, BATCH)
        stages = stage_line(pipe.stats)
        cand, surv = pipe.candidates, pipe.survivors
        if counts["stage_a"] != n_dp * n_lex * base["stage_a"] \
                or counts["dl_lcs"] <= 0:
            raise SystemExit(f"{name}: launches {counts}, single {base}")
        require_k1(name, counts["stage_a"])
        require_one_buffer_per_call(name, counts)
        require_equal(name, got, single, queries)
        require_equal(f"{name} StopAtExactMatch",
                      list(model.find_variants_stream(queries[:BATCH], stop,
                                                      BATCH)),
                      single_stop, queries[:BATCH])
        require_equal(f"{name} oracle", got[:N_MESH_ORACLE], oracle, head)
        by_path[name] = counts
        log(f"{name}: {N_QUERIES} queries in batches of {BATCH}: "
            f"{N_QUERIES / dt:.1f} q/s warm ({dt:.3f} s), sharded in "
            f"{t_shard:.3f} s, {pipe.index_bytes()} index bytes per shard, "
            f"{cand / N_QUERIES:.2f} candidates and {surv / N_QUERIES:.2f} "
            f"survivors per query; equal to the single-device pipeline on "
            f"{N_QUERIES} queries, under StopAtExactMatch on {BATCH}, and "
            f"to the oracle on {N_MESH_ORACLE}; launches {counts} | {card}")
        log(f"{name} stages: {stages}")
        log(f"{name} async: {async_line(pipe.stats, N_QUERIES // BATCH)} "
            f"| {card}")
        if (n_dp, n_lex) == (1, 4):
            log(f"{name} {profile_pass(lambda: list(model.find_variants_stream(queries, params, BATCH)))} | {card}")
    return by_path


def mesh_learn_phase(words, card: str) -> dict:
    """Phase 10 (b): the same strict learn on a 120k model sharded over a
    2x2 mesh and on a single-device one; links, frequencies and the lookups
    afterwards must be equal."""
    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.models.variant_model import LEARN_BATCH
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate,
    )

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        max_ngram=2,
    )
    corpus = corrupt_queries(words, SEED + 50, N_LEARN_STRICT)
    out = {}
    for name in ("single", "mesh_2x2"):
        model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                         words)
        if name == "single":
            pipe = model._pipeline()
        else:
            model.use_mesh(cuda_mesh(2, 2))
            pipe = model._device
            hold_kernels("mesh_learn_2x2", pipe, corpus[:LEARN_BATCH],
                         params)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = model.learn_variants(corpus, params, strict=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = require_launches(f"learn {name}")
        if model.learn_profile["build_mode"] != "freq_refresh" \
                or model._device is not pipe:
            raise SystemExit(f"learn {name}: {model.learn_profile}")
        out[name] = (model, n, dt, counts)
    (single, n_s, dt_s, _), (mesh, n_m, dt_m, counts) = out.values()
    snap = [[(v.text, v.frequency, v.variants) for v in m.decoder]
            for m in (single, mesh)]
    if n_s != n_m or snap[0] != snap[1]:
        raise SystemExit(f"mesh learn: {n_m} variants against {n_s}, or "
                         "the links and frequencies differ")
    linked = [v.text for v in mesh.decoder if v.variants]
    qs = linked[:BATCH // 2] + corrupt_queries(linked, SEED + 51, BATCH // 2)
    require_equal("mesh learn lookups", mesh.find_variants_batch(qs, params),
                  single.find_variants_batch(qs, params), qs)
    log(f"mesh_learn_2x2: strict learn over {len(corpus)} words in "
        f"{dt_m:.3f} s ({len(corpus) / dt_m:.1f} words/s; single device "
        f"{dt_s:.3f} s, {len(corpus) / dt_s:.1f} words/s), {n_m} variants; "
        f"links and frequencies of {len(snap[0])} entries equal, and "
        f"{len(qs)} lookups over {len(linked)} linked entries equal; "
        f"launches {counts} | {card}")
    return {"mesh_learn_2x2": counts}


def mesh_1m_phase(card: str) -> dict:
    """Phase 10 (c): a seeded 1,000,000-entry lexicon sharded over a 1x4
    mesh of ``cuda:0``: sharded_1m's traffic (4,096 corrupted queries in
    batches of 2,048) against the same model's single-device pipeline and
    the oracle, then learn_1m's strict learn over 7,000 corrupted words,
    a re-shard and the oracle again."""
    import gc

    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )

    t0 = time.perf_counter()
    words = synthetic_lexicon(SEED + 60, N_1M)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.use_mesh(cuda_mesh(1, 4))
    pipe = model._device
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    log(f"mesh_1m model: {model.index.size} entries generated in "
        f"{t_gen:.3f} s, added and built in {t_build:.3f} s, sharded over "
        f"1x4 in {t_shard:.3f} s: {pipe.Ni_shard} rows and "
        f"{pipe.index_bytes()} index bytes per shard, L={pipe.L} | {card}")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    queries = corrupt_queries(words, SEED + 61, N_1M_QUERIES)
    hold_kernels("mesh_1m", pipe, queries[:BATCH_1M], params)
    got, dt, counts = timed_stream(model, queries, params, BATCH_1M)
    if min(counts.values()) <= 0:
        raise SystemExit(f"mesh_1m: a kernel was not launched: {counts}")
    # the 1M lexicon's planes are deeper (T 9) than the main one's: each
    # launch takes the instance of the widest block it reads
    routes = k1_routes(pipe)
    require_k1("mesh_1m", counts["stage_a"], None, routes)
    stages = stage_line(pipe.stats)
    cand = pipe.candidates
    single_pipe = DevicePipeline(model, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = [r for b in range(0, len(queries), BATCH_1M)
              for r in single_pipe.find_variants_batch(
                  queries[b:b + BATCH_1M], params)]
    torch.cuda.synchronize()
    dt_single = time.perf_counter() - t0
    n_split = single_pipe.stats.counts.get("dispatch", 0)
    del single_pipe
    gc.collect()
    require_equal("mesh_1m vs single device", got, single, queries)
    t0 = time.perf_counter()
    head = queries[:N_1M_ORACLE]
    require_equal("mesh_1m oracle", got[:N_1M_ORACLE],
                  [model._find_variants_oracle(q, params) for q in head],
                  head)
    log(f"mesh_1m query: {len(queries)} queries in batches of {BATCH_1M}: "
        f"{len(queries) / dt:.1f} q/s warm ({dt:.3f} s), "
        f"{cand / len(queries):.2f} candidates per query; single-device "
        f"pipeline {len(queries) / dt_single:.1f} q/s (cold, {n_split} "
        f"device calls for {len(queries) // BATCH_1M} batches); equal to it "
        f"on {len(queries)} queries and to the oracle on {N_1M_ORACLE} "
        f"({time.perf_counter() - t0:.1f} s); launches {counts} | {card}")
    log(f"mesh_1m query stages: {stages}")

    corpus = corrupt_queries(words, SEED + 62, N_1M_LEARN)
    lparams = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=3,
        score_threshold=0.7,
    )
    reset_counts()
    pipe.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = model.learn_variants(corpus, lparams, strict=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    lcounts = require_launches("mesh_1m learn", k1=None, routes=routes)
    lstages = stage_line(pipe.stats)
    log(f"mesh_1m learn: strict over {len(corpus)} words in {dt:.3f} s, "
        f"{len(corpus) / dt:.1f} words/s, {n} variants; learn_profile "
        f"{model.learn_profile}; launches {lcounts} | {card}")
    log(f"mesh_1m learn stages: {lstages}")
    t0 = time.perf_counter()
    model.use_mesh(cuda_mesh(1, 4))  # re-shard the learned model
    head = corpus[:N_1M_ORACLE]
    require_equal("mesh_1m after learn",
                  model.find_variants_batch(head, lparams),
                  [model._find_variants_oracle(q, lparams) for q in head],
                  head)
    log(f"mesh_1m re-shard: {N_1M_ORACLE} learned words equal the oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, pipe
    gc.collect()
    return {"mesh_1m_query": counts, "mesh_1m_learn": lcounts}


def profiling_phase(words, queries, params, wall_ms: float,
                    card: str) -> dict:
    """Phase 11: the ``stop_stage`` ladder of ``query_core`` on the main
    path's 4,096-query batch (a fresh model of the main lexicon, budgets
    settled by two submit/collect rounds): per stop, the host's enqueue, the
    card's time by CUDA events and its busy time and ops by the profiler,
    over 10 back-to-back calls; the whole core after the ladder must equal
    its outputs before it, and the ``compact_sum`` probes the probes of
    those outputs. Then the batch's roofline beside the core's time by CUDA
    events (the profiler's device records in this process can come back
    short, PERF.md section 6) and the main pass's wall time per batch
    (``wall_ms``), and one ``trace`` of
    two warm batches under ``build/``, which must name every kernel (taken
    again over 4, then 8 batches where it lost a kernel's records)."""
    import shutil

    import torch

    from analiticcl_tpu_torch import VariantModel
    from analiticcl_tpu_torch.ops.pipeline import probe, query_core
    from analiticcl_tpu_torch.testing import ALPHABET, populate
    from analiticcl_tpu_torch.utils.profiling import (
        settled_batch, stop_ladder, trace,
    )
    from analiticcl_tpu_torch.utils.roofline import batch_floor, card_peaks

    t0 = time.perf_counter()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    pipe = model._pipeline()
    batch = queries[:BATCH]
    st, static = settled_batch(pipe, batch, params)
    P, P2 = static["P"], static["P2"]

    def call(stop):
        return query_core(pipe.index, *st["args"], **static, stop_stage=stop)

    want = call(None)
    torch.cuda.synchronize()
    reset_counts()
    rungs = stop_ladder(call, cuda=True)
    full = rungs[-1]
    if not all(torch.equal(g, w) for g, w in zip(full.out, want)):
        raise SystemExit("profiling: the full core after the ladder differs "
                         "from its outputs before it")
    if [int(x) for x in rungs[-2].out] != [int(x) for x in probe(*want[:7])]:
        raise SystemExit("profiling: the compact_sum probes differ from the "
                         "probes of the full core's outputs")
    prev = None
    for r in rungs:
        delta = "" if prev is None else (
            f" (delta enqueue {r.enqueue_ms - prev.enqueue_ms:+.3f}, events "
            f"{r.event_ms - prev.event_ms:+.3f}, busy "
            f"{r.busy_ms - prev.busy_ms:+.4f}, ops "
            f"{r.n_ops - prev.n_ops:+.1f})")
        log(f"ladder {r.stop}: enqueue {r.enqueue_ms:.3f} ms, events "
            f"{r.event_ms:.3f} ms, device busy {r.busy_ms:.4f} ms, "
            f"{r.n_ops:.1f} device ops per call{delta}")
        prev = r
    floor = batch_floor(pipe.index, st["args"], **static,
                        peaks=card_peaks(0))
    prog, prog_by = floor.ms("program")
    parts = ", ".join(
        f"{name} {floor.ms(part)[0]:.4f} ms ({floor.ms(part)[1]})"
        for name, part in (("K5", "k5"), ("K1", "k1"), ("K3", "k3"),
                           ("K2 at valid pairs", "k2_valid"),
                           ("K2's slot entry at P slots", "k2_slots"),
                           ("K4", "k4"), ("glue", "glue")))
    log(f"roofline: B={st['B']} band {st['nb_band'] * 1024} rows, AT "
        f"{pipe.index.at}, P={P} ({floor.n_valid} valid pairs over "
        f"{floor.cand_rows} candidate rows), P2={P2}: {parts}; the parts "
        f"together {floor.parts_ms:.4f} ms; program floor {prog:.4f} ms "
        f"({prog_by}; {floor.program.nbytes:.6g} bytes) per batch = "
        f"{prog / full.event_ms:.4f} of the core's {full.event_ms:.4f} ms "
        f"by CUDA events and {prog / wall_ms:.5f} of the main pass's "
        f"wall {wall_ms:.3f} ms per batch ({floor.peaks.name}) | {card}")

    # two warm batches: in this process, after the earlier phases, a
    # profiler window comes back without some of its device records, and a
    # trace has lacked K1 (and K5 with it: PERF.md section 6), so a trace
    # that names a kernel no time is taken again over twice the batches,
    # up to three times; a fresh process keeps them all
    root = Path("build/chip_smoke_trace")
    shutil.rmtree(root, ignore_errors=True)
    for attempt in range(3):
        d = root / str(attempt)
        n_batches = 2 << attempt
        before = launch_counts()
        with trace(str(d)):
            list(pipe.find_variants_stream(iter([batch] * n_batches),
                                           params))
        in_trace = {k: v - before[k] for k, v in launch_counts().items()}
        files = sorted(d.glob("*.json"))
        events = (json.loads(files[0].read_text(encoding="utf-8"))
                  ["traceEvents"] if len(files) == 1 else [])
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        counts = {k: sum(TRACE_NAMES[k] in n for n in kernels)
                  for k in in_trace}
        if min(counts.values()) > 0:
            break
        log(f"profiling: the trace {files} names a kernel no time: "
            f"{counts} for the launches {in_trace}; its kernels: "
            f"{sorted(set(n[:60] for n in kernels))}")
    else:
        raise SystemExit("profiling: three traces each named a kernel no "
                         "time")
    launches = require_launches("profiling")
    log(f"profiling: trace {files[0]} of {n_batches} warm batches (attempt "
        f"{attempt + 1}): {len(kernels)} kernel records, {counts} for the "
        f"launches {in_trace}; launches {launches} | {card}")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return {"profiling": launches}


def wide_words() -> list:
    """The wide phase's long entries: N_WIDE_EACH seeded strings of each of
    WIDE_LENGTHS lowercase letters (as many normalized characters)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, n)) for n in WIDE_LENGTHS
            for _ in range(N_WIDE_EACH)]


def wide_queries(words, longs) -> tuple:
    """Phase 12's queries: N_WIDE_NEAR near (or equal to) the long entries
    ``longs`` and the rest corrupted main-lexicon words, shuffled; and the
    near ones."""
    import numpy as np

    from analiticcl_tpu_torch.testing import corrupt_queries

    near = corrupt_queries(longs, SEED + 21, N_WIDE_NEAR - len(longs)) + longs
    rest = corrupt_queries(words, SEED + 22, N_WIDE_QUERIES - len(near))
    order = np.random.default_rng(SEED + 23).permutation(N_WIDE_QUERIES)
    return [(near + rest)[i] for i in order], near


def short_queries(words) -> list:
    """The 4,096 shortest of 16,384 corrupted main-lexicon words: a batch
    of a wide lexicon (phase 12's) with no pair over 64, on which K2's wide
    launch has no pair to take."""
    from analiticcl_tpu_torch.testing import corrupt_queries

    pool = corrupt_queries(words, SEED + 25, 4 * BATCH)
    return sorted(pool, key=len)[:BATCH]


def wide_pair_strings(seed: int, L: int, n: int):
    """``n`` seeded int32 pairs at width ``L`` for K2's pair-string entry,
    made on the card: three in four of lengths 65 to L (the wide path), the
    rest of 1 to 64 (the byte path); each candidate its query under up to
    three substitutions, so the DL is within W=3 for most."""
    import torch

    from analiticcl_tpu_torch.ops.dl import PAD_A, PAD_B

    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda", dtype=torch.int32)
    a = torch.randint(1, 27, (n, L), **kw)
    short = torch.rand(n, generator=g, device="cuda") < 0.25
    al = torch.where(short, torch.randint(1, 65, (n,), **kw),
                     torch.randint(65, L + 1, (n,), **kw))
    b = a.clone()
    rows = torch.arange(n, device="cuda")
    for _ in range(3):
        at = (torch.rand(n, generator=g, device="cuda") * al).long()
        keep = torch.rand(n, generator=g, device="cuda") < 0.5
        b[rows, at] = torch.where(keep, b[rows, at],
                                  torch.randint(1, 27, (n,), **kw))
    pos = torch.arange(L, device="cuda", dtype=torch.int32)[None, :]
    a = torch.where(pos < al[:, None], a, PAD_A).contiguous()
    b = torch.where(pos < al[:, None], b, PAD_B).contiguous()
    return a, al.contiguous(), b, al.clone()


def equal_pair(seed: int, a, al, b, bl, L: int) -> int:
    """Pair 0 of :func:`wide_pair_strings`' output made two equal seeded
    strings of min(L, 255) letters, in place: the longest run a byte holds
    (its LCS must not wrap). Returns their length."""
    import torch

    from analiticcl_tpu_torch.ops.dl import PAD_A, PAD_B

    m = min(L, 255)
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = torch.randint(1, 27, (m,), generator=g, device="cuda",
                      dtype=torch.int32)
    a[0], b[0] = PAD_A, PAD_B
    a[0, :m] = s
    b[0, :m] = s
    al[0] = bl[0] = m
    return m


def hold_wide_pairs(L: int, W: int, n: int, card: str) -> None:
    """K2's pair-string entry at width ``L`` (both launches) against its
    plain version on :func:`wide_pair_strings`, pair 0 two equal strings
    of min(L, 255) letters (:func:`equal_pair`): DL clipped at W + 1, LCS
    exact."""
    import torch

    from analiticcl_tpu_torch.ops.dl import dl_lcs, dl_metrics_windowed_plain

    a, al, b, bl = wide_pair_strings(SEED + L + W, L, n)
    m = equal_pair(SEED + L, a, al, b, bl, L)
    ld, lcs = dl_lcs(a, al, b, bl, L, W)
    ld_p, lcs_p, _, _ = dl_metrics_windowed_plain(a, al, b, bl, L, W)
    torch.cuda.synchronize()
    if not (torch.equal(ld.clamp(max=W + 1), ld_p.clamp(max=W + 1))
            and torch.equal(lcs, lcs_p) and int(lcs[0]) == m
            and int(ld[0]) == 0):
        raise SystemExit(f"dl_lcs pair-string entry differs from plain at "
                         f"L={L}, W={W}")
    n_wide = int((al > 64).sum())
    log(f"K2 pair-string entry L={L} W={W}: {n} pairs, {n_wide} on the "
        f"wide path, equal to plain (DL clipped at W+1, "
        f"{int((ld <= W).sum())} within W) | {card}")


def hold_wide_slots(L: int, W: int, card: str, B: int = 256) -> None:
    """K2's slot entry at width ``L`` (both launches; metrics and scored
    instances) against its plain version on seeded tables: B queries of
    lengths 1 to L, each paired with a row made from it by up to three
    substitutions (query 0's an equal copy of min(L, 255) letters,
    :func:`equal_pair`) and with an unrelated row. The metrics as in
    :func:`hold_glue`; the epilogue's keep flags, frequency maxima and
    block counts exactly, and K4 on its outputs (int32 metrics from L 256)
    bit for bit against its plain version."""
    import torch

    from analiticcl_tpu_torch.ops import dl as tdl

    a, al, b, bl = wide_pair_strings(SEED + 3 * L + W, L, B)
    m = equal_pair(SEED + 2 * L, a, al, b, bl, L)  # slot 0: LCS m
    g = torch.Generator(device="cuda").manual_seed(SEED + L)
    other = torch.randint(1, 27, (B, L), generator=g, device="cuda",
                          dtype=torch.int32)
    ol = torch.randint(1, L + 1, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    pos = torch.arange(L, device="cuda")[None, :]
    rows = torch.stack([b.clamp(min=0), torch.where(pos < ol[:, None], other,
                                                    0)], 1).view(2 * B, L)
    lens = torch.stack([al, ol], 1).view(2 * B)
    rev = torch.where(pos < lens[:, None],
                      rows.gather(1, (lens[:, None] - 1 - pos).clamp(min=0)),
                      0)
    idx = SimpleNamespace(
        norms2=torch.cat([rows, rev], 1).to(torch.int8).contiguous(),
        norm_lens=lens.contiguous(),
        first_lower=(torch.rand(2 * B, generator=g, device="cuda") < 0.5))
    q_norms = a.clamp(min=0).to(torch.int8).contiguous()
    k_ed = torch.full((B,), W, dtype=torch.int32, device="cuda")
    q_fl = torch.rand(B, generator=g, device="cuda") < 0.5
    q = torch.arange(B, device="cuda", dtype=torch.int32).repeat_interleave(2)
    pc = torch.arange(2 * B, device="cuda", dtype=torch.int32)
    valid = torch.ones(2 * B, dtype=torch.bool, device="cuda")
    s_args = (idx, q_norms, al, k_ed, q_fl, q, pc, valid, W)
    sm = tdl.dl_lcs_slots(*s_args)
    mp = tdl.dl_lcs_slots_plain(*s_args)
    torch.cuda.synchronize()
    bad = [f for f, x, y in zip(tdl.SlotMetrics._fields[1:], sm[1:], mp[1:])
           if x.dtype != y.dtype or not torch.equal(x, y)]
    if not torch.equal(sm.ld.clamp(max=W + 1), mp.ld.clamp(max=W + 1)):
        bad.append("ld")
    if int(sm.lcs[0]) != m:
        bad.append("the equal pair's lcs")
    score = tdl.ScoreInputs(
        torch.zeros(2 * B, dtype=torch.int32, device="cuda"),
        torch.zeros((B, 1), dtype=torch.uint8, device="cuda"), None,
        torch.tensor([0.5, 0.125, 0.125, 0.125, 0.125, 1.0], device="cuda"),
        torch.tensor(0.25, device="cuda"), None)
    ks = tdl.dl_lcs_slots(*s_args, score=score)
    kp = tdl.score_slots_plain(mp, q, pc, valid, L, score)
    torch.cuda.synchronize()
    bad += [f for f, x, y in (("keep", ks.keep, kp.keep),
                              ("max_freq", ks.max_freq, kp.max_freq),
                              ("counts", ks.counts, kp.counts),
                              ("kept metrics", ks.met[:, ks.keep],
                               kp.met[:, kp.keep]))
            if x.dtype != y.dtype or not torch.equal(x, y)]
    if bad:
        raise SystemExit(f"dl_lcs slot entry differs from plain at L={L}, "
                         f"W={W} in {bad}")
    total = torch.tensor(2 * B, dtype=torch.int64, device="cuda")
    hold_k4(f"wide slots L={L}", (ks.keep, ks.counts, tdl.slot_block(L), q,
                                  pc, ks.met, ks.max_freq, total), 2 * B)
    wide = int((torch.maximum(al.repeat_interleave(2), lens) > 64).sum())
    log(f"K2 slot entry L={L} W={W}: {2 * B} slots, {wide} on the wide "
        f"path, equal to plain; its epilogue exact ({int(ks.keep.sum())} "
        f"kept, {ks.met.dtype} metrics), K4 bit-identical to plain on them "
        f"| {card}")


def wide_batch(pipe, lookups, params):
    """The slots of ``lookups`` as one device batch at its budget: stage A
    and K3 on the card; returns the slot entry's arguments, its scoring
    inputs, the gathered pair strings, P and the valid slots."""
    import torch

    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.ops import pipeline as ppl

    st = prepared(pipe, lookups, params)
    (q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len, _se,
     start_blk, _w, _thr) = st["args"]
    idx = pipe.index
    sa = ppl.query_stage_a(idx, q_counts, q_cc, k_ana, k_len, start_blk,
                           st["nb_band"], st["width"])
    P, _P2, total = stage_b_budget(pipe, st["B"], sa)
    q, pcb, pc, valid, _t = ppl.resolve_pairs(
        sa.packed_q, sa.counts_t, sa.nmatch, start_blk, idx.bins.shape[0], P)
    W = st["window"]
    s_args = (idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid, W)
    (_, score), = score_variants(idx, sa, dict(score_args(pipe, st),
                                               pc_band=pcb), False)
    pr = tdl.gather_pairs(idx, q_norms, q_lens, k_ed, q_fl, q, pc, valid)
    torch.cuda.synchronize()
    return s_args, score, pr, P, min(total, P)


def wide_records(pipe, lookups, short, params, card: str, peaks) -> dict:
    """The wide path's numbers: on the first batch of the wide phase (its
    pairs with a string over 64, as gathered strings through the
    pair-string entry, whose byte launch has none of them to do, against
    the plain version on the same pairs and their bound; the scored slot
    entry's two launches at the batch's budget, the pairs on the wide
    launch's one work list and the largest list a block of the first
    design's scan took); the same launch on ``short``, a batch without a
    pair over 64, where it has nothing to do; and per 1M pairs at
    WIDE_TIMED. The wide kernel's device time is read by its name."""
    import torch

    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.utils.roofline import k2_bound_ms

    s_args, score, pr, P, n_valid = wide_batch(pipe, lookups, params)
    L, W = pipe.L, s_args[-1]
    wide = (torch.maximum(pr.ql, pr.cl) > tdl.NARROW_LEN).nonzero()[:, 0]
    n_wide = int(wide.numel())
    if not n_wide:
        raise SystemExit("wide phase: the first batch has no pair over 64")
    a, al, b, bl = (x[wide].contiguous() for x in (pr.a, pr.ql, pr.b, pr.cl))
    ld, lcs = tdl.dl_lcs(a, al, b, bl, L, W)
    ld_p, lcs_p, _, _ = tdl.dl_metrics_windowed_plain(a, al, b, bl, L, W)
    torch.cuda.synchronize()
    err = max(int((ld.clamp(max=W + 1) - ld_p.clamp(max=W + 1)).abs().max()),
              int((lcs - lcs_p).abs().max()))
    if err:
        raise SystemExit("wide phase: the wide path differs from plain on "
                         "the batch's pairs")

    def wide_only():  # both launches; the byte launch has none of these
        tdl.dl_lcs(a, al, b, bl, L, W)

    rec = {
        "ms": time_ms(wide_only, 10, inner=10),
        "device_ms": device_ms(wide_only, "dl_lcs_wide_kernel", 10),
        "plain_ms": time_ms(lambda: tdl.dl_metrics_windowed_plain(
            a, al, b, bl, L, W), 1),
        "max_abs_err": err, "pairs": n_wide, "L": L, "W": W,
    }
    rec["bound_ms"], rec["bound_by"] = k2_bound_ms(al, bl, L, W, peaks)
    slot = {
        "P": P, "valid": n_valid, "wide": n_wide,
        "ms": time_ms(lambda: tdl.dl_lcs_slots(*s_args, score=score), 10,
                      inner=10),
        "byte_device_ms": device_ms(
            lambda: tdl.dl_lcs_slots(*s_args, score=score),
            "dl_lcs_slots_kernel", 10),
        "wide_device_ms": device_ms(
            lambda: tdl.dl_lcs_slots(*s_args, score=score),
            "dl_lcs_slots_wide_kernel", 10),
        "list": n_wide,
    }
    rec["at_batch"] = slot
    s_args, score, pr, P_s, _ = wide_batch(pipe, short, params)
    if bool((torch.maximum(pr.ql, pr.cl) > tdl.NARROW_LEN).any()):
        raise SystemExit("wide phase: the short batch has a pair over 64")
    rec["no_wide_batch"] = {
        "P": P_s, "B": len(short),
        "ms": time_ms(lambda: tdl.dl_lcs_slots(*s_args, score=score), 10,
                      inner=10),
        "wide_device_ms": device_ms(
            lambda: tdl.dl_lcs_slots(*s_args, score=score),
            "dl_lcs_slots_wide_kernel", 10),
    }
    log(f"K2 wide path on the wide batch: {n_wide} of {n_valid} valid "
        f"slots have a string over 64 (L={L}, W={W}); the pair-string "
        f"entry on them {rec['ms']:.4f} ms (both launches, CUDA events, 10 "
        f"back-to-back calls; the wide kernel's profiler device time "
        f"{ms4(rec['device_ms'])}), plain {rec['plain_ms']:.3f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); the scored slot "
        f"entry at P={P}: {slot['ms']:.4f} ms both launches (device: byte "
        f"path {ms4(slot['byte_device_ms'])}, wide path "
        f"{ms4(slot['wide_device_ms'])}; {n_wide} pairs on the work "
        f"list); on {len(short)} queries "
        f"without a pair over 64 (P={P_s}) the wide launch "
        f"{ms4(rec['no_wide_batch']['wide_device_ms'])} device | {card}")
    per = {}
    for Lt, Wt in WIDE_TIMED:
        a, al, b, bl = wide_pair_strings(SEED + 7 * Lt + Wt, Lt, WIDE_PAIRS)
        n_w = int((al > 64).sum())

        def run():  # both launches: a quarter of the pairs fit in 64
            tdl.dl_lcs(a, al, b, bl, Lt, Wt)

        r = {"wide_pairs": n_w, "ms": time_ms(run, 3),
             "device_ms": device_ms(run, "dl_lcs_wide_kernel", 3)}
        sel = al > 64
        r["bound_ms"], r["bound_by"] = k2_bound_ms(al[sel], bl[sel], Lt, Wt,
                                                   peaks)
        per[f"L{Lt}_W{Wt}"] = r
        log(f"K2 wide path per 1M pairs L={Lt} W={Wt}: {n_w} of "
            f"{WIDE_PAIRS} pairs over 64: the entry {r['ms']:.3f} ms (both "
            f"launches, CUDA events; the wide kernel's profiler device time "
            f"{ms4(r['device_ms'])}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | {card}")
        del a, b
    rec["per_1M_pairs"] = per
    return rec


def wide_phase(words, card: str, peaks) -> tuple:
    """Phase 12: a lexicon wider than 64 on the card. The main lexicon plus
    :func:`wide_words` (L 300) serves 2,048 queries, 512 of them near a
    long entry, in batches of 1,024; 256 lines of text with long tokens
    through search (``max_ngram`` 2); and the same queries on a 1x4 mesh of
    ``cuda:0``. Each path holds every kernel against its plain version on
    its first 256 lookups (K4 at int32 metrics; pairs over 64 among them),
    must launch K2's wide path once after each slot-entry launch, and
    equals the oracle (search: the object path and the host search);
    the mesh equals the single-device pipeline. Then both K2 entries at
    L 100, 255, 256 and 300 against their plain versions (at L 300 also
    on lists long enough for two pairs a warp), the wide path's times, and
    K1 at planes 608, 864 and 960 wide. Every K1 launch of the paths must
    run an instance one of the lexicon's block extents routes to, and the
    query and mesh paths (near the long entries) the widest's. Logs the
    seconds of each part. Returns the wide path's record and the paths'
    launches."""
    import dataclasses

    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.testing import (
        ALPHABET, populate, synthetic_text,
    )

    t_phase = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = round(time.perf_counter() - t_phase - sum(
            parts.values()), 2)

    longs = wide_words()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                     list(words) + longs)
    pipe = model._pipeline()
    if pipe.L != max(WIDE_LENGTHS):
        raise SystemExit(f"wide phase: L={pipe.L}, not {max(WIDE_LENGTHS)}")
    # the long entries' blocks are wider than the main path's: a launch
    # that reads one takes the widest block's instance
    routes = k1_routes(pipe)
    k1 = routes[-1]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries, near = wide_queries(words, longs)
    lap("model")
    hold_kernels("wide query", pipe, queries[:WIDE_HOLD], params)
    sync_free_submit("wide query", pipe, queries[:WIDE_HOLD], params, card)
    list(model.find_variants_stream(queries[:WIDE_BATCH], params, WIDE_BATCH))
    lap("query holds")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(model.find_variants_stream(queries, params, WIDE_BATCH))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_path = {"wide_query": require_launches("wide query", wide=True,
                                              k1=k1, routes=routes)}
    lap("query")
    require_one_buffer_per_call("wide query", by_path["wide_query"])

    def tuples(res):
        return [[(model.decoder[r.vocab_id].text, r.dist_score,
                  r.freq_score, r.via) for r in x] for x in res]

    t1 = time.perf_counter()
    check = sorted(range(N_WIDE_QUERIES),
                   key=lambda i: len(queries[i]), reverse=True)
    check = check[:N_WIDE_ORACLE // 2] + check[-(N_WIDE_ORACLE // 2):]
    oracle = {i: model._find_variants_oracle(queries[i], params)
              for i in check}
    require_equal("wide query vs oracle", tuples(got[i] for i in check),
                  tuples(oracle[i] for i in check),
                  [queries[i] for i in check])
    n_long_found = sum(1 for i in check[:N_WIDE_ORACLE // 2] if got[i])
    log(f"wide query: {N_WIDE_QUERIES} queries ({len(near)} near a long "
        f"entry) in batches of {WIDE_BATCH} on L={pipe.L}: "
        f"{N_WIDE_QUERIES / dt:.1f} q/s warm ({dt:.3f} s); equal to the "
        f"oracle on the {N_WIDE_ORACLE // 2} longest queries "
        f"({n_long_found} with a result) and the {N_WIDE_ORACLE // 2} "
        f"shortest ({time.perf_counter() - t1:.1f} s); launches "
        f"{by_path['wide_query']}, K1's {k1} instance (planes "
        f"{pipe.index.bins.shape[1]} wide) | {card}")
    lap("query oracle")
    record = wide_records(pipe, queries[:WIDE_BATCH], short_queries(words),
                          params, card, peaks)
    lap("wide times")

    # search over lines that carry long tokens
    texts = synthetic_text(list(words[:2000]) + longs * 40, SEED + 24,
                           N_WIDE_LINES)
    s_params = dataclasses.replace(params, max_ngram=2)
    by_path["wide_search"] = search_phase(
        "wide search", model, texts, s_params, card, hold_n=WIDE_HOLD,
        n_host=N_WIDE_HOST_LINES, k1=None, routes=routes)
    lap("search")

    # the same queries on a 1x4 mesh of cuda:0
    model.use_mesh(cuda_mesh(1, 4))
    hold_kernels("wide mesh_1x4", model._device, queries[:WIDE_HOLD],
                 params)
    mgot, mdt, mcounts = timed_stream(model, queries, params, WIDE_BATCH,
                                      wide=True)
    mroutes = k1_routes(model._device)  # the shards' own extents
    require_launches("wide mesh_1x4", wide=True, counts=mcounts,
                     k1=mroutes[-1], routes=mroutes)
    require_equal("wide mesh_1x4", tuples(mgot), tuples(got), queries)
    require_one_buffer_per_call("wide mesh_1x4", mcounts)
    by_path["wide_mesh_1x4"] = mcounts
    log(f"wide mesh_1x4: {N_WIDE_QUERIES} queries {N_WIDE_QUERIES / mdt:.1f} "
        f"q/s warm, equal to the single-device pipeline (and so to the "
        f"oracle on {N_WIDE_ORACLE}); launches {mcounts} | {card}")
    del model, pipe
    gc.collect()
    lap("mesh")

    # both K2 entries at L 100, 255, 256 (a run a byte holds, and the
    # width from which the packed LCS rows take 16-bit runs) and 300
    for L in (100, 255, 256, 300):
        hold_wide_pairs(L, 3, 4096, card)
        hold_wide_slots(L, 3, card)
    hold_wide_slots(300, 12, card)
    # lists that outnumber the wide launch's warps: two pairs a warp
    hold_wide_pairs(300, 3, 65536, card)
    hold_wide_slots(300, 6, card, B=16384)
    lap("K2 entries")

    # K1 at planes too wide for a resident block of 128 queries (the
    # streamed instance; up to AT 960 resident blocks of 64 and 32 queries
    # took them before)
    for T in WIDE_K1_T:
        args = k1_args(SEED + 40 + T, 32_768, 1024, 8, T=T)
        _err, _bt, n_exact = hold_k1(*args)
        if n_exact == 0:
            raise SystemExit(f"K1 at AT={args[0].shape[1]} saw no exact hits")
        log(f"K1 stage_a at planes {args[0].shape[1]} wide (A=30, T={T}), "
            f"B=1024: bit-identical to plain ({n_exact} exact hits) | {card}")
    lap("K1 wide planes")
    log(f"phase 12 (wide): {time.perf_counter() - t_phase:.1f} s: {parts}")
    return record, by_path


def planes_words() -> list:
    """Phase 13's two entries: 1,000 letters drawn as :func:`wide_words`
    draws (55 of one letter), and 64 letters of which 50 are one letter
    (a wide-plane entry on K2's byte path)."""
    import numpy as np

    rng = np.random.default_rng(PLANES_SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    long = "".join(rng.choice(letters, 1000))
    one = rng.choice(letters)
    chars = np.concatenate([np.repeat(one, 50),
                            rng.choice(letters[letters != one], 14)])
    return [long, "".join(rng.permutation(chars))]


def k1_times(args, at: int, card: str, peaks, what: str,
             instance: str) -> dict:
    """K1 on ``args`` (the wrapper's arguments; planes ``at`` wide before
    their padding), which must route to ``instance``: held bit for bit
    against its plain version (:func:`hold_k1`, exact hits required), then
    its time (CUDA events over 10 back-to-back calls, and the profiler's
    device time of the kernel), its bound (each band block at the columns
    its rows use, ``convert.block_columns``: the least work for the same
    outputs) and its bound at the planes' full width, and the plain
    version's time, once."""
    import numpy as np

    from analiticcl_tpu_torch.convert import block_columns
    from analiticcl_tpu_torch.ops.stage_a import (
        KERNEL_QT, kernel_instance, stage_a_masks, stage_a_masks_plain,
    )
    from analiticcl_tpu_torch.utils.roofline import k1_bound_ms

    bins, qbin, start_blk, nb_band, ext, width = (args[0], args[3], args[7],
                                                  args[8], args[9], args[10])
    got = kernel_instance(width, bins.shape[1], KERNEL_QT, bins.device)
    if got != instance:
        raise SystemExit(f"K1 at {what}: width {width} routes to the {got} "
                         f"instance, not the {instance} one")
    err, bt, n_exact = hold_k1(*args)
    if n_exact == 0:
        raise SystemExit(f"K1 at {what} saw no exact hits")

    def run():
        stage_a_masks(*args)

    kernel = "stage_a_kernel_stream" if instance == "stream" else \
        "stage_a_kernel<"
    rec = {"B": qbin.shape[0], "nb_band": nb_band, "at_pad": bins.shape[1],
           "width": width, "instance": instance, "max_abs_err": err,
           "ms": time_ms(run, 10, inner=10),
           "device_ms": device_ms(run, kernel, 10),
           "plain_ms": time_ms(lambda: stage_a_masks_plain(*args), 1)}
    rec["bound_ms"], rec["bound_by"] = k1_bound_ms(
        at, rec["B"], start_blk, nb_band, peaks, columns=block_columns(bins))
    rec["bound_full_ms"], rec["bound_full_by"] = k1_bound_ms(
        at, rec["B"], start_blk, nb_band, peaks)
    exts = ext.cpu().numpy()[start_blk.cpu().numpy()[:, None].astype(int)
                             + np.arange(nb_band)]
    rec["extents"] = {int(e): int((exts == e).sum())
                      for e in sorted(set(exts.ravel().tolist()))}
    log(f"K1 {instance} instance at {what}: B={rec['B']} bt={bt} "
        f"nb_band={nb_band} planes {rec['at_pad']} wide, width {width} "
        f"(the tiles' band blocks by extent: {rec['extents']}), "
        f"bit-identical to plain ({n_exact} exact hits); {rec['ms']:.4f} ms "
        f"(CUDA events, 10 back-to-back calls; profiler device time "
        f"{ms4(rec['device_ms'])}), plain {rec['plain_ms']:.3f} ms, bound "
        f"{rec['bound_ms']:.4f} ms at the blocks' columns ({rec['bound_by']}),"
        f" {rec['bound_full_ms']:.4f} ms at the full width "
        f"({rec['bound_full_by']}) | {card}")
    return rec


def planes_phase(words, card: str, peaks) -> tuple:
    """Phase 13: planes wider than any resident K1 block holds. The main
    lexicon plus :func:`planes_words` (planes 1,664 wide, L 1,000) serves
    8,192 queries (64 near the two entries) in batches of 4,096; 128
    lines through search (``max_ngram`` 2); and the same queries on a 1x4
    mesh of ``cuda:0``. One block holds the two entries (extent 1,664),
    the others the main lexicon's words (224 or less), so a launch whose
    band reaches that block takes K1's streamed instance (each block at
    its own extent) and the others the main one. Each path holds every
    kernel against its plain version on its first 256 lookups (K2's wide
    path at L 1,000 among them), launches only those two K1 instances
    (query and mesh: the streamed one among them), and equals the oracle
    (the longest and shortest queries; search: the object path and the
    host search on its first lines); the mesh equals the single device.
    K1 is held bit for bit and timed beside its bounds on the first batch
    of 4,096 (its band reaches the entries' block: streamed) and on the
    4,096 shortest other queries (the main instance at the narrowed
    width); then directly on seeded planes 992 to 6,016 wide (every block
    at the full width), on seeded planes whose blocks' extents run from 32
    to 1,664, and on a tile of 8 queries (bit for bit, exact hits
    required), timed at 1,664 and 6,016 on a main-sized band. Logs the
    seconds of each part. Returns K1's streamed record and the paths'
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops.stage_a import KERNEL_QT, kernel_instance
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_text,
    )

    t_phase = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = round(time.perf_counter() - t_phase - sum(
            parts.values()), 2)

    longs = planes_words()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                     list(words) + longs)
    pipe = model._pipeline()
    at_pad = pipe.index.bins.shape[1]
    if (pipe.L, at_pad) != (1000, PLANES_AT):
        raise SystemExit(f"planes phase: L={pipe.L}, planes {at_pad} wide, "
                         f"not 1000 and {PLANES_AT}")
    ext = pipe.index.extents_host
    routes = k1_routes(pipe)
    if routes != ("main", "stream"):
        raise SystemExit(f"planes phase: block extents "
                         f"{sorted(set(ext.tolist()))} route to {routes}, "
                         "not to the main and the streamed instance")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    # corruptions no longer than the 1,000-letter entry: a longer query
    # goes to the host oracle (about 1.2 s each at this length, on every
    # pass: the holds clear its memo)
    near = [q for q in corrupt_queries(longs, SEED + 38, 2 * N_PLANES_NEAR)
            if len(q) <= 1000][:N_PLANES_NEAR - 2] + longs
    queries = near + corrupt_queries(words, SEED + 39,
                                     N_PLANES_QUERIES - len(near))
    log(f"planes model: {model.index.size} entries, L={pipe.L}, "
        f"AT={pipe.index.at} (padded {at_pad}), Ni_pad={pipe.Ni_pad}; "
        f"block extents (blocks each): "
        f"{ {int(e): int((ext == e).sum()) for e in sorted(set(ext.tolist()))} }")
    lap("model")
    hold_kernels("planes query", pipe, queries[:PLANES_HOLD], params)
    sync_free_submit("planes query", pipe, queries[:PLANES_HOLD], params,
                     card)
    lap("query holds")

    # K1 on the first batch of 4,096, as the path gives it (its band
    # reaches the two entries' block), and on the 4,096 shortest other
    # queries (whose bands stay below it)
    def k1_batch(lookups, instance, what):
        st = prepared(pipe, lookups, params)
        (q_counts, q_cc, _qn, _ql, _qf, k_ana, _ke, k_len, _se, start_blk,
         _w, _thr) = st["args"]
        qbin, _totals = hold_k5(pipe.index, q_counts)
        return k1_times(index_k1_args(pipe.index, qbin, st, q_cc, k_ana,
                                      k_len, start_blk),
                        pipe.index.at, card, peaks, what, instance)

    rec = k1_batch(queries[:PLANES_BATCH], "stream",
                   "the wide-planes model's first batch")
    rec["main_batch"] = k1_batch(
        sorted(queries[len(near):], key=len)[:PLANES_BATCH], "main",
        "the wide-planes model's 4,096 shortest other queries")
    lap("K1 batches")

    list(model.find_variants_stream(queries[:PLANES_BATCH], params,
                                    PLANES_BATCH))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(model.find_variants_stream(queries, params, PLANES_BATCH))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    by_path = {"planes_query": require_launches("planes query", wide=True,
                                                k1="stream", routes=routes)}
    require_one_buffer_per_call("planes query", by_path["planes_query"])
    lap("query")

    def tuples(res):
        return [[(model.decoder[r.vocab_id].text, r.dist_score,
                  r.freq_score, r.via) for r in x] for x in res]

    t1 = time.perf_counter()
    by_len = sorted(range(len(queries)), key=lambda i: len(queries[i]),
                    reverse=True)
    # the longest (near the 1,000-letter entry), those near the 64-letter
    # one, and the shortest
    near_rep = [i for i in range(len(near)) if len(queries[i]) < 100][:8]
    check = (by_len[:N_PLANES_ORACLE_LONG] + near_rep
             + by_len[-N_PLANES_ORACLE:])
    oracle = [model._find_variants_oracle(queries[i], params) for i in check]
    require_equal("planes query vs oracle", tuples(got[i] for i in check),
                  tuples(oracle), [queries[i] for i in check])
    found = sum(1 for i in by_len[:N_PLANES_ORACLE_LONG] + near_rep
                if any(model.decoder[r.vocab_id].text in longs
                       for r in got[i]))
    if found < len(near_rep):
        raise SystemExit(f"planes query: the long entries were found for "
                         f"{found} of their near queries")
    log(f"planes query: {len(queries)} queries ({len(near)} near the two "
        f"entries) in batches of {PLANES_BATCH} on planes {at_pad} wide, "
        f"L={pipe.L}: {len(queries) / dt:.1f} q/s warm ({dt:.3f} s); equal "
        f"to the oracle on the {N_PLANES_ORACLE_LONG} longest queries, "
        f"{len(near_rep)} near the 64-letter entry ({found} of these found "
        f"an entry) and the {N_PLANES_ORACLE} shortest "
        f"({time.perf_counter() - t1:.1f} s); launches "
        f"{by_path['planes_query']}, K1 {k1_instances()} | {card}")
    lap("query oracle")

    texts = synthetic_text(list(words[:2000]) + longs * 40, SEED + 41,
                           N_PLANES_LINES)
    by_path["planes_search"] = search_phase(
        "planes search", model, texts, dataclasses.replace(params,
                                                           max_ngram=2),
        card, hold_n=PLANES_HOLD, n_host=N_PLANES_HOST_LINES, k1=None,
        routes=routes)
    lap("search")

    model.use_mesh(cuda_mesh(1, 4))
    hold_kernels("planes mesh_1x4", model._device, queries[:PLANES_HOLD],
                 params)
    mgot, mdt, mcounts = timed_stream(model, queries, params, PLANES_BATCH,
                                      wide=True)
    require_launches("planes mesh_1x4", wide=True, counts=mcounts,
                     k1="stream", routes=k1_routes(model._device))
    require_equal("planes mesh_1x4", tuples(mgot), tuples(got), queries)
    require_one_buffer_per_call("planes mesh_1x4", mcounts)
    by_path["planes_mesh_1x4"] = mcounts
    log(f"planes mesh_1x4: {len(queries)} queries "
        f"{len(queries) / mdt:.1f} q/s warm, equal to the single-device "
        f"pipeline; launches {mcounts} | {card}")
    del model, pipe
    gc.collect()
    lap("mesh")

    # both K2 entries at L 1,000: the longest pairs take the LCS along the
    # diagonals, the rest the packed rows
    hold_wide_pairs(1000, 3, 4096, card)
    hold_wide_slots(1000, 3, card)
    lap("K2 entries")

    # K1 directly at planes 30 x T wide (every block at the full width),
    # on blocks whose counts are capped at 1, 7, 8 and 55 in turn (extents
    # 32, 224, 256 and 1,664), and a tile of 8 queries
    for T, caps in [(T, None) for T in PLANES_K1_T] + [(55, (1, 7, 8, 55))]:
        args = k1_args(SEED + 40 + T + (caps is not None), 32_768, 1024, 8,
                       T=T, caps=caps)
        at, width = args[0].shape[1], args[10]
        if kernel_instance(width, at, KERNEL_QT, "cuda") != "stream":
            raise SystemExit(f"K1 at AT={at}: not the streamed instance")
        exts = sorted(set(args[9].tolist()))
        if caps is not None and exts != [32, 224, 256, at]:
            raise SystemExit(f"K1 at capped counts: block extents {exts}")
        _err, _bt, n_exact = hold_k1(*args)
        if n_exact == 0:
            raise SystemExit(f"K1 at AT={at} saw no exact hits")
        log(f"K1 stage_a at planes {at} wide (A=30, T={T}"
            f"{f', counts capped at {caps} by block' if caps else ''}), "
            f"block extents {exts}, B=1024: bit-identical to plain "
            f"({n_exact} exact hits) | {card}")
    args = k1_args(SEED + 8, 32_768, 8, 4, T=55)
    _err, bt, n_exact = hold_k1(*args)
    if n_exact == 0 or bt != 8:
        raise SystemExit(f"K1 at a tile of 8 queries: bt={bt}, "
                         f"{n_exact} exact hits")
    log(f"K1 stage_a at planes {args[0].shape[1]} wide, B=8 (a tile of 8 "
        f"queries): bit-identical to plain ({n_exact} exact hits) | {card}")
    del args
    lap("K1 direct")
    # at AT 1,664 and 6,016 on a band of the main path's size: 4,096
    # queries over 89 blocks of 131,072 rows, every block at the full width
    for T in (55, 200):
        args = k1_args(SEED + 240 + (T == 55), 131_072, 4096, 89, T=T)
        rec[f"at_{args[0].shape[1]}"] = k1_times(
            args, 30 * T, card, peaks,
            f"AT {args[0].shape[1]:,} on a main-sized band", "stream")
        del args
    torch.cuda.empty_cache()
    lap("K1 at 1,664 and 6,016")
    log(f"phase 13 (wide planes): {time.perf_counter() - t_phase:.1f} s: "
        f"{parts}")
    return rec, by_path


@contextlib.contextmanager
def object_tail_rows():
    """Counts, inside the block, the rows that a model ranks on its exact
    object tail (``VariantModel.score_and_rank``: rows whose survivors
    carry variant links, a batch under early confusables, the host oracle):
    yields a dict whose ``"rows"`` grows with each."""
    from analiticcl_tpu_torch.models.variant_model import VariantModel

    real = VariantModel.score_and_rank
    seen = {"rows": 0}

    def counting(self, *args, **kw):
        seen["rows"] += 1
        return real(self, *args, **kw)

    VariantModel.score_and_rank = counting
    try:
        yield seen
    finally:
        VariantModel.score_and_rank = real


def result_tuples(model, results) -> list:
    """Query results as (text, dist_score, freq_score, via's text)."""
    dec = model.decoder
    return [[(dec[r.vocab_id].text, r.dist_score, r.freq_score,
              None if r.via is None else dec[r.via].text) for r in res]
            for res in results]


def via_counts(name: str, model, results) -> dict:
    """The results reached through a weighted variant link and through an
    error form (a transparent entry: the JAX package's and the reference's
    error lists, lib.rs:772-897); fails when either count is 0, or when a
    transparent entry is a result's text (an error form is shown only as
    ``via``)."""
    from analiticcl_tpu_torch.vocab import VocabType

    transparent = int(VocabType.TRANSPARENT)
    dec = model.decoder
    link = err = shown = 0
    for res in results:
        for r in res:
            if r.via is not None:
                if int(dec[r.via].vocabtype) & transparent:
                    err += 1
                else:
                    link += 1
            shown += bool(int(dec[r.vocab_id].vocabtype) & transparent)
    if shown:
        raise SystemExit(f"{name}: {shown} results show an error form")
    if not link or not err:
        raise SystemExit(f"{name}: {link} results through a variant link, "
                         f"{err} through an error form")
    return {"via_variant": link, "via_error": err}


def rules_fired(name: str, model, outs) -> dict:
    """How the context rules acted on search output: matches tagged by a
    rule, and lines whose selected words a rule matches (a context score
    other than 1); fails when both are 0."""
    tagged = sum(1 for out in outs for m in out if m.tag)
    scored = 0
    for out in outs:
        vids = [(m.solution().vocab_id if m.solution() else 0) for m in out]
        scored += bool(vids) and model.test_context_rules(vids)[0] != 1.0
    if not tagged and not scored:
        raise SystemExit(f"{name}: no context rule fired")
    return {"tagged_matches": tagged, "rule_lines": scored}


def served_queries(name: str, model, queries, params, routes):
    """One warm pass of ``find_variants_stream`` over ``queries`` in
    batches of BATCH: (results, seconds, launches, object-tail rows); every
    kernel must launch (K1 on ``routes``) and each core call write one
    output buffer."""
    import torch

    list(model.find_variants_stream(queries[:BATCH], params, BATCH))  # warm
    reset_counts()
    torch.cuda.synchronize()
    with object_tail_rows() as tail:
        t0 = time.perf_counter()
        got = list(model.find_variants_stream(queries, params, BATCH))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = with_wide_and_stream(
        require_launches(name, k1=None, routes=routes))
    require_one_buffer_per_call(name, counts)
    if not tail["rows"]:
        raise SystemExit(f"{name}: no row took the object tail")
    return got, dt, counts, tail["rows"]


def served_search(name: str, model, texts, params, routes):
    """One warm pass of ``find_all_matches_stream`` over ``texts``:
    (results, seconds, launches, object-tail rows, :func:`via_counts` of
    the matches' variants); every kernel must launch (K1 on ``routes``),
    some row take the object tail, and the consolidation must be the
    object path that context rules take."""
    import torch

    pipe = model._device
    list(model.find_all_matches_stream(texts[:8], params))  # warm
    reset_counts()
    pipe.stats.clear()
    torch.cuda.synchronize()
    with object_tail_rows() as tail:
        t0 = time.perf_counter()
        got = list(model.find_all_matches_stream(texts, params))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = with_wide_and_stream(
        require_launches(name, k1=None, routes=routes))
    if not tail["rows"]:
        raise SystemExit(f"{name}: no row took the object tail")
    stages = set(pipe.stats.totals)
    if ("search_consolidate_obj" not in stages
            or "search_consolidate" in stages):
        raise SystemExit(f"{name}: the consolidation ran {sorted(stages)}, "
                         f"not the object path alone")
    if len(got) != len(texts):
        raise SystemExit(f"{name}: {len(got)} results for {len(texts)} lines")
    vias = via_counts(name, model, [m.variants for out in got for m in out
                                    if m.variants])
    return got, dt, counts, tail["rows"], vias


def variant_data(words, d: Path) -> SimpleNamespace:
    """Phase 14's inputs, each from SEED, with the files written under
    ``d``: the main lexicon with frequencies, a weighted variant list over
    N_VAR_REFS references (two columns a form) and one over
    N_VAR_FREQ_REFS more (the frequency-bearing layout), an error list over
    N_ERR_REFS, context rules over bigrams the text holds, the LM's
    bigrams, phase 9's confusables; 16,384 queries, N_VAR_FORM_QUERIES of
    them forms of the lists or forms edited, a few exact words and some
    upper-cased; N_VAR_LINES lines of text carrying the bigrams with some
    tokens replaced by forms (the first N_VAR_SEARCH lines, which are
    searched); and the words of a strict learn."""
    import numpy as np

    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, synthetic_bigrams, synthetic_confusables,
        synthetic_contextrules, synthetic_errors, synthetic_frequencies,
        synthetic_text, synthetic_variants,
    )

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 70)
    pick = rng.permutation(len(words))
    cuts = np.cumsum([N_VAR_REFS, N_VAR_FREQ_REFS, N_ERR_REFS])
    var_refs, freq_refs, err_refs = ([words[i] for i in part] for part in
                                     np.split(pick[:cuts[-1]], cuts[:-1]))
    variants = synthetic_variants(var_refs, SEED + 71)
    variants_freq = synthetic_variants(freq_refs, SEED + 72, freqs=True)
    errors = synthetic_errors(err_refs, SEED + 73)

    def forms(lines, step, first):
        return [f for line in lines for f in line.split("\t")[first::step]]

    var_forms = forms(variants, 2, 1) + forms(variants_freq, 3, 2)
    err_forms = forms(errors, 2, 1)
    bigrams = synthetic_bigrams(words, SEED + 4, N_BIGRAMS)
    texts = synthetic_text(words, SEED + 74, N_VAR_LINES, bigrams)
    rules = synthetic_contextrules(words, bigrams, texts, N_RULE_GROUPS)
    every = var_forms + err_forms

    def swap(tok):  # a tenth of the tokens become a form of either list
        r = rng.random()
        if r < 0.05:
            return var_forms[int(rng.integers(len(var_forms)))]
        if r < 0.1:
            return err_forms[int(rng.integers(len(err_forms)))]
        return tok

    texts = [" ".join(swap(t) for t in line.split(" "))
             for line in texts[:N_VAR_SEARCH]]
    n_forms = N_VAR_FORM_QUERIES // 4
    queries = ([var_forms[int(i)] for i in rng.integers(len(var_forms),
                                                        size=n_forms)]
               + [err_forms[int(i)] for i in rng.integers(len(err_forms),
                                                          size=n_forms)]
               + corrupt_queries(every, SEED + 75, 2 * n_forms)
               + [words[int(i)] for i in rng.integers(len(words),
                                                       size=N_VAR_EXACT)])
    rest = corrupt_queries(words, SEED + 76, N_QUERIES - len(queries))
    queries += [q.upper() for q in rest[:N_VAR_UPPER]] + rest[N_VAR_UPPER:]
    queries = [queries[int(i)] for i in rng.permutation(len(queries))]
    learn = corrupt_queries(every, SEED + 77, N_VAR_LEARN // 2) + \
        corrupt_queries(words, SEED + 78, N_VAR_LEARN // 2)
    freqs = synthetic_frequencies(SEED + 41, len(words))
    files = {
        "alphabet": write_lines(d / "alphabet.tsv",
                                ["\t".join(c) for c in ALPHABET]),
        "lexicon": write_lines(d / "lexicon.tsv",
                               [f"{w}\t{f}" for w, f in zip(words, freqs)]),
        "variants": write_lines(d / "variants.tsv", variants),
        "variants_freq": write_lines(d / "variants_freq.tsv", variants_freq),
        "errors": write_lines(d / "errors.tsv", errors),
        "rules": write_lines(d / "rules.tsv", rules),
        "lm": write_lines(d / "lm.tsv", [f"{b}\t{f}" for b, f in bigrams]),
        "confusables": write_lines(d / "confusables.tsv",
                                   synthetic_confusables(words, SEED + 43)),
        "queries": write_lines(d / "variants_queries.txt", queries),
        "queries_head": write_lines(d / "variants_queries_head.txt",
                                    queries[:N_VAR_CLI_HEAD]),
        "text": write_lines(d / "variants_text.txt", texts),
        "text_head": write_lines(d / "variants_text_head.txt",
                                 texts[:N_VAR_HOST_LINES]),
        "learn_head": write_lines(d / "variants_learn.txt", learn),
    }
    return SimpleNamespace(
        files={k: str(v) for k, v in files.items()}, queries=queries,
        texts=texts, n_forms=len(set(every) - set(words)),
        n_rules=len(rules) - 1, n_bigrams=len(bigrams))


def start_cli(argv, stdin_path: Path, stdout_path: Path):
    """``python -m analiticcl_tpu_torch.cli argv`` in a process of its own,
    from this checkout, in this process's directory, its standard input
    and output on files (its standard error beside the output, ``.err``);
    returns the process."""
    import os

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with open(stdin_path, "rb") as fin, open(stdout_path, "wb") as fout, \
            open(stdout_path.with_suffix(".err"), "wb") as ferr:
        return subprocess.Popen(
            [sys.executable, "-m", "analiticcl_tpu_torch.cli", *argv],
            stdin=fin, stdout=fout, stderr=ferr, env=env)


def variants_cli(data, d: Path, card: str) -> dict:
    """Check 6 of phase 14: ``cli.main`` on the card for query (TSV, JSON,
    StopAtExactMatch, early confusables), search (``-N 2``, the LM, the
    context rules, JSON: the tags) and strict learn, each with both
    variant lists, the error list and the confusables; each device run
    must launch every kernel, and its output equal, byte for byte, that
    of the same command with ``--backend oracle`` on its input's head
    (query mode: the device output begins with it) or its whole input
    (search and learn, whose inputs are short). The oracle commands run
    meanwhile on ``--device cpu``, each in a process of its own. Then
    ``index`` and ``testinput`` on ``--device cuda`` byte for byte against
    ``--device cpu``."""
    from analiticcl_tpu_torch import cli

    f = data.files
    common = ["-a", f["alphabet"], "-l", f["lexicon"], "-V", f["variants"],
              "-V", f["variants_freq"], "-E", f["errors"],
              "-C", f["confusables"], "--device", "cuda"]
    query = ["query", *common, "--backend", "device"]
    runs = {  # name: (argv, input, the oracle's input)
        "cli_var_query": (query, "queries", "queries_head"),
        "cli_var_query_json": (query + ["--json"], "queries", "queries_head"),
        "cli_var_query_stop": (query + ["-s"], "queries", "queries_head"),
        "cli_early_confusables": (query + ["--early-confusables"], "queries",
                                  "queries_head"),
        "cli_var_search": (["search", *common, "--backend", "device", "-N",
                            "2", "--lm", f["lm"], "-R", f["rules"],
                            "--json"], "text_head", "text_head"),
        "cli_var_learn": (["learn", *common, "--backend", "device",
                           "--strict"], "learn_head", "learn_head"),
    }
    t_oracle = time.perf_counter()
    oracles = {}
    try:
        for name, (argv, _, head) in runs.items():
            oracles[name] = start_cli(  # the host oracle needs no card
                [{"device": "oracle", "cuda": "cpu"}.get(a, a) for a in argv],
                Path(f[head]), d / f"{name}_oracle.out")
        args = cli.build_argparser().parse_args(query)
        model, params = cli.build_model_from_args(args)
        model.build()
        pipe = model._pipeline()
        hold_kernels("cli variants", pipe, data.queries[:cli.MAX_BATCHSIZE],
                     params)
        routes = k1_routes(pipe)
        del model, pipe
        gc.collect()
        by_path, outs = {}, {}
        for name, (argv, src, _) in runs.items():
            out = d / f"{name}.out"
            with object_tail_rows() as tail:
                dt, t_model, counts = run_cli(name, argv, Path(f[src]), out)
            counts = with_wide_and_stream(require_launches(
                name, counts=counts, k1=None, routes=routes))
            if not tail["rows"]:
                raise SystemExit(f"{name}: no row took the object tail")
            by_path[name] = counts
            outs[name] = text = out.read_text(encoding="utf-8")
            extra = ""
            if "--json" in argv:  # results through a link, the rules' tags
                n_via, n_tag = text.count(' "via": '), text.count(' "tag": ')
                if not n_via or (not n_tag and "search" in argv):
                    raise SystemExit(f"{name}: no result with via, or no tag")
                extra = f", {n_via} results with via, {n_tag} tagged matches"
            n = len(Path(f[src]).read_text(encoding="utf-8").splitlines())
            log(f"{name}: {n} input lines in {dt:.3f} s wall, of which "
                f"{t_model:.3f} s to read and build the model; "
                f"{tail['rows']} object-tail rows{extra}; {len(text)} "
                f"characters out; launches {counts} | {card}")
        t_wait = time.perf_counter()
        for name, proc in oracles.items():
            if proc.wait() != 0:
                raise SystemExit(f"{name}: the oracle backend exited "
                                 f"{proc.returncode}")
        t_wait = time.perf_counter() - t_wait
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    checks = []
    for name, (argv, src, head) in runs.items():
        got = (d / f"{name}_oracle.out").read_text(encoding="utf-8")
        want = outs[name]
        if "--json" in argv and src != head:
            got = got[:-len("]\n")]  # the head's closing bracket
        if not (want.startswith(got) if src != head else want == got) \
                or got.count("\n") < 16:
            bad = sum(a != b for a, b in zip(got.split("\n"),
                                              want.split("\n")))
            raise SystemExit(f"{name}: {bad} lines differ from the oracle "
                             f"backend's")
        checks.append(f"{name} {got.count(chr(10))} lines")
    log(f"cli variants checks: device output equal to the oracle backend's, "
        f"byte for byte: {', '.join(checks)} (the oracle commands in "
        f"processes of their own, {time.perf_counter() - t_oracle:.1f} s "
        f"from their start, {t_wait:.1f} s waited for) | {card}")
    for name, argv, src in (
            ("index", ["index", "-a", f["alphabet"], "-l", f["lexicon"], "-V",
                       f["variants"], "-V", f["variants_freq"], "-E",
                       f["errors"]], "queries_head"),
            ("testinput", ["testinput", "-a", f["alphabet"]], "queries")):
        got = []
        for dev in ("cuda", "cpu"):
            path = d / f"{name}_{dev}.out"
            dt, _, _ = run_cli(name, [*argv, "--device", dev], Path(f[src]),
                               path, serves=False)
            got.append(path.read_bytes())
        if got[0] != got[1] or not got[0]:
            raise SystemExit(f"cli {name}: --device cuda differs from cpu")
        log(f"cli {name}: --device cuda equal to --device cpu, "
            f"{len(got[0])} bytes ({dt:.3f} s) | {card}")
    return by_path


def variants_phase(words, card: str) -> dict:
    """Phase 14: the configurations beyond plain lexicons. The main
    lexicon with weighted variant lists (both layouts), an error list,
    context rules, an LM and confusables, read from files through the
    API's readers and served by its engine on the card: (1) 16,384
    queries equal to the oracle on the first N_VAR_ORACLE, with rows on
    the object tail and results through variant links and error forms;
    (2) the same under StopAtExactMatch (the oracle on
    N_VAR_ORACLE_MORE); (3) search with the rules and the LM
    (``max_ngram`` 2) on the object consolidation, equal to a host-only
    search on the first lines, tags included, some rule firing; (5) a
    checkpoint of that model loaded onto the card, and onto a 1x4 mesh
    of ``cuda:0``, giving the same queries and lines; (4) early
    confusables on N_VAR_EARLY queries against the oracle; (6) the CLI
    with them (:func:`variants_cli`). The model, the loaded one, its
    mesh and the CLI's hold every kernel on their first batch, and every
    path launches every kernel. Logs the seconds of each part. Returns
    the paths' launches."""
    import dataclasses

    import numpy as np
    import torch

    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, StopCriterion, VariantModel, api,
    )

    t_phase = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = round(time.perf_counter() - t_phase - sum(
            parts.values()), 2)

    d = Path("build/chip_smoke_cli")
    data = variant_data(words, d)
    f = data.files
    lap("data")
    m = api.VariantModel(f["alphabet"], api.Weights(), device="cuda")
    m.read_lexicon(f["lexicon"])
    m.read_variants(f["variants"])
    m.read_variants(f["variants_freq"])
    m.read_variants(f["errors"], transparent=True)
    m.read_lm(f["lm"])
    m.read_confusablelist(f["confusables"])
    m.read_contextrules(f["rules"])
    m.build()
    model = m.engine
    pipe = model._pipeline()
    torch.cuda.synchronize()
    n_linked = int(pipe._has_variants.sum())
    if model.index.size != len(words) + data.n_forms or not n_linked:
        raise SystemExit(f"variants: index {model.index.size}, not "
                         f"{len(words)} + {data.n_forms} forms, or no row "
                         f"with a link ({n_linked})")
    routes = k1_routes(pipe)
    log(f"variants model: {len(words)} lexicon entries + {data.n_forms} "
        f"variant and error forms = index {model.index.size} "
        f"({n_linked} rows with variant links), {data.n_rules} context "
        f"rules, {data.n_bigrams} LM bigrams, {len(model.confusables)} "
        f"confusables; read and built in {time.perf_counter() - t_phase:.1f} "
        f"s; K1's instances {routes} | {card}")
    lap("model")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries, texts = data.queries, data.texts
    hold_kernels("variants query", pipe, queries[:BATCH], params)
    by_path = {}

    def query_check(name, model, queries, params, routes, n_oracle):
        got, dt, counts, rows = served_queries(name, model, queries, params,
                                               routes)
        t0 = time.perf_counter()
        head = queries[:n_oracle]
        want = [model._find_variants_oracle(q, params) for q in head]
        require_equal(f"{name} vs oracle",
                      result_tuples(model, got[:len(head)]),
                      result_tuples(model, want), head)
        vias = via_counts(name, model, got)
        by_path[name.replace(" ", "_")] = counts
        log(f"{name}: {len(queries)} queries in batches of {BATCH}: "
            f"{len(queries) / dt:.1f} q/s warm ({dt:.3f} s); {rows} rows on "
            f"the object tail, {vias['via_variant']} results through a "
            f"variant link, {vias['via_error']} through an error form, none "
            f"showing one; equal to the oracle on {len(head)} "
            f"({time.perf_counter() - t0:.1f} s); launches {counts} | {card}")
        return got

    # (1) query with the variant and error lists, (2) StopAtExactMatch
    got1 = query_check("variants query", model, queries, params, routes,
                       N_VAR_ORACLE)
    lap("query")
    stop = dataclasses.replace(
        params, stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH)
    query_check("variants query stop", model, queries, stop, routes,
                N_VAR_ORACLE_MORE)
    lap("query stop")

    # (3) search with the rules and the LM: the object consolidation
    s_params = dataclasses.replace(params, max_ngram=2, lm_weight=1.0)
    outs, dt, counts, rows, vias = served_search("variants search", model,
                                                 texts, s_params, routes)
    sig3 = match_signature(outs, tags=True)
    fired = rules_fired("variants search", model, outs)
    t0 = time.perf_counter()
    head = texts[:N_VAR_HOST_LINES]
    preps, uniq, lookups = model._fam_prepare(head, s_params)
    found = [model._find_variants_oracle(q, s_params) for q in lookups]
    host = match_signature(model._fam_consolidate(preps, uniq, found,
                                                   s_params), tags=True)
    if host != sig3[:len(head)]:
        bad = sum(a != b for a, b in zip(host, sig3))
        raise SystemExit(f"variants search: {bad} lines differ from the "
                         f"oracle-lookup host search")
    by_path["variants_search"] = counts
    n_tok = sum(len(t.split()) for t in texts)
    log(f"variants search: {len(texts)} lines, {n_tok} tokens in {dt:.3f} "
        f"s: {n_tok / dt:.1f} tokens/s on the object consolidation; "
        f"{rows} rows on the object tail, {vias['via_variant']} variants "
        f"through a variant link and {vias['via_error']} through an error "
        f"form among the matches; {fired['tagged_matches']} matches tagged "
        f"by a rule, "
        f"{fired['rule_lines']} lines whose selection a rule matches; equal "
        f"to the oracle-lookup host search on {len(head)} lines, tags "
        f"included ({len(lookups)} lookups, {time.perf_counter() - t0:.1f} "
        f"s); launches {counts} | {card}")
    lap("search")

    # (5) the model to a checkpoint, loaded onto the card and a 1x4 mesh
    path = d / "variants_model.npz"
    t0 = time.perf_counter()
    model.save(str(path))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = VariantModel.load(str(path), device="cuda")
    lpipe = loaded._pipeline()
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if not np.array_equal(lpipe._has_variants, pipe._has_variants):
        raise SystemExit("checkpoint: the loaded index's variant flags "
                         "differ from the saved model's")
    log(f"checkpoint: {path.stat().st_size} bytes, saved in {t_save:.3f} s, "
        f"loaded onto cuda in {t_load:.3f} s ({len(loaded.context_rules)} "
        f"rules, {len(loaded.confusables)} confusables, {len(loaded.ngrams)} "
        f"n-grams, {int(lpipe._has_variants.sum())} rows with variant links) "
        f"| {card}")
    want1 = result_tuples(model, got1)
    for name, pipe_of in (("checkpoint", lambda: loaded._pipeline()),
                          ("checkpoint mesh_1x4", None)):
        if pipe_of is None:
            loaded.use_mesh(cuda_mesh(1, 4))
        lp = loaded._device if pipe_of is None else pipe_of()
        lroutes = k1_routes(lp)
        hold_kernels(f"{name} query", lp, queries[:BATCH], params)
        got, dt, counts, rows = served_queries(f"{name} query", loaded,
                                               queries, params, lroutes)
        require_equal(f"{name} query", result_tuples(loaded, got), want1,
                      queries)
        by_path[f"{name.replace(' ', '_')}_query"] = counts
        outs, sdt, scounts, _, _ = served_search(f"{name} search", loaded,
                                                 texts, s_params, lroutes)
        if match_signature(outs, tags=True) != sig3:
            raise SystemExit(f"{name} search: the lines differ from the "
                             f"saved model's")
        by_path[f"{name.replace(' ', '_')}_search"] = scounts
        log(f"{name}: {len(queries)} queries ({len(queries) / dt:.1f} q/s "
            f"warm, {rows} object-tail rows) and {len(texts)} lines "
            f"({sdt:.3f} s) equal to the saved model's; launches {counts}, "
            f"search {scounts} | {card}")
        lap(name)
    del loaded, lpipe, lp
    gc.collect()

    # (4) early confusables, on the model the checkpoint was taken of
    model.set_confusables_before_pruning()
    early_q = queries[:N_VAR_EARLY]
    got4 = query_check("early confusables", model, early_q, params, routes,
                       N_VAR_ORACLE_MORE)
    n_moved = sum(a != b for a, b in zip(result_tuples(model, got4), want1))
    log(f"early confusables: {n_moved} of {len(early_q)} results differ "
        f"from the late confusables' | {card}")
    model.confusables_before_pruning = False
    del m, model, pipe
    gc.collect()
    lap("early confusables")

    # (6) the CLI
    by_path.update(variants_cli(data, d, card))
    lap("cli")
    log(f"phase 14 (variants): {time.perf_counter() - t_phase:.1f} s: "
        f"{parts} | {card}")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.convert import block_columns
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.ops.dl import (
        dl_lcs, dl_metrics_windowed_plain,
    )
    from analiticcl_tpu_torch.ops.stage_a import (
        stage_a_masks, stage_a_masks_plain,
    )
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_bigrams,
        synthetic_lexicon, synthetic_text,
    )
    from analiticcl_tpu_torch.utils.provenance import stamp
    from analiticcl_tpu_torch.utils.roofline import (
        card_peaks, k1_bound_ms, k2_bound_ms,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    # ---- 1. the card ----
    card = gpu_line()
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    log(card)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| nvcc {nvcc} | devices {torch.cuda.device_count()}")
    peaks = card_peaks(0)
    log(f"peaks: {peaks.name}: {peaks.int8_ops_per_s:.4g} int8 op/s, "
        f"{peaks.hbm_bytes_per_s:.4g} B/s, {peaks.int32_ops_per_s:.4g} "
        f"32-bit op/s")

    # ---- 2. the build ----
    t0 = time.perf_counter()
    _build.load_all(KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s for "
        f"{' + '.join(f'{n}.cu' for n in KERNEL_SOURCES)} in parallel "
        f"(nvcc per file: {_build.build_seconds})")
    for name in KERNEL_SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # the main path's model (its shapes feed phases 3 and 4)
    t0 = time.perf_counter()
    words = synthetic_lexicon(SEED, N_LEXICON)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    pipe = model._pipeline()
    torch.cuda.synchronize()
    log(f"model: {model.index.size} entries, L={pipe.L}, "
        f"AT={pipe.index.at} (padded {pipe.index.bins.shape[1]}), "
        f"Ni_pad={pipe.Ni_pad}, built in {time.perf_counter() - t0:.1f} s")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries = corrupt_queries(words, SEED + 1, N_QUERIES)
    idx = pipe.index
    records = []

    # ---- 3. K1 against its plain version: direct shapes, then one
    # main-path batch ----
    for B, ni, nb in K1_DIRECT:
        k1_err, bt, n_exact = hold_k1(*k1_args(SEED + B, ni, B, nb))
        if n_exact == 0:
            raise SystemExit(f"K1 direct check at B={B} saw no exact hits")
        log(f"K1 stage_a direct: B={B} bt={bt} Ni={ni} nb_band={nb} "
            f"bit-identical to plain ({n_exact} exact hits)")
    st = prepared(pipe, queries[:BATCH], params)
    (q_counts, q_cc, _qn, _ql, _qf, k_ana, _ke, k_len, _se,
     start_blk, _w, _thr) = st["args"]
    qbin, _totals = hold_k5(idx, q_counts)
    a_args = index_k1_args(idx, qbin, st, q_cc, k_ana, k_len, start_blk)
    k1_err, _bt, _ne = hold_k1(*a_args)
    k1_ms = time_ms(lambda: stage_a_masks(*a_args), 10, inner=10)
    k1_dev = device_ms(lambda: stage_a_masks(*a_args), "stage_a_kernel", 10)
    k1_plain = time_ms(lambda: stage_a_masks_plain(*a_args), 5)
    k1_bound, k1_by = k1_bound_ms(idx.at, qbin.shape[0], start_blk,
                                  st["nb_band"], peaks,
                                  columns=block_columns(idx.bins))
    k1_bound_full, _by = k1_bound_ms(idx.at, qbin.shape[0], start_blk,
                                     st["nb_band"], peaks)
    rs = idx.bins.shape[1] + 16  # csrc/stage_a.cu smem_bytes
    log(f"K1 stage_a: dynamic shared memory "
        f"{128 * rs + 3 * (64 * rs + 320) + 2 * 4 * 128 * 33} bytes per "
        f"block of 256 threads at AT {idx.bins.shape[1]}")
    log(f"K1 stage_a: B={BATCH} nb_band={st['nb_band']} "
        f"(band {st['nb_band'] * 1024} rows of {pipe.Ni_pad}, AT {idx.at} "
        f"padded to {idx.bins.shape[1]}, width {st['width']}: the "
        f"{k1_instances_of(a_args)} instance) bit-identical to plain; kernel "
        f"{k1_ms:.3f} ms "
        f"(CUDA events, 10 back-to-back calls; profiler device time "
        f"{ms4(k1_dev)}), "
        f"plain {k1_plain:.3f} ms, bound {k1_bound:.4f} ms at the blocks' "
        f"columns ({k1_by}; at the full width {k1_bound_full:.4f} ms) | "
        f"{card}")
    records.append({
        "name": "stage_a", "route": "cuda",
        "source": "analiticcl_tpu_torch/csrc/stage_a.cu",
        "replaces": "analiticcl_tpu/ops/stage_a.py:88",
        "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by,
        "bound_full_ms": k1_bound_full,
        "device_ms": k1_dev, "library_ms": None,
        "library_note": "no PyTorch call computes it: torch._int_mm of the "
                        "same planes writes an int32 product 32x the size "
                        "of the bits, and no call fuses the tests",
    })
    # the resident instance at the CLI's and the 1M lexicon's plane
    # widths, 256 and 288 (every block at the full width)
    records[-1]["resident"] = {}
    for T in (8, 9):
        args = k1_args(SEED + 60 + T, 131_072, 4096, 89, T=T)
        records[-1]["resident"][f"at_{args[0].shape[1]}"] = k1_times(
            args, 30 * T, card, peaks,
            f"AT {args[0].shape[1]} on a main-sized band", "resident")
        del args

    # ---- 4. K3 and K2's slot entry against their plain versions on the
    # main path's first batch (and at a budget below its hits), then K2's
    # pair-string entry on its pairs ----
    (a, al, b, bl), n_distinct, slots, P_main, main = k2_main_pairs(
        pipe, queries, params)
    records += glue_records(main, n_distinct, card, peaks)
    P, L = a.shape
    lmax, threads = k2_instance(L)
    k2_ptxas = dl_lcs_ptxas(_build.ptxas_report("dl_lcs"))
    k2 = {}
    for W in (3, 6, 12):
        ld, lcs = dl_lcs(a, al, b, bl, L, W)
        ld_p, lcs_p, _, _ = dl_metrics_windowed_plain(a, al, b, bl, L, W)
        torch.cuda.synchronize()
        err = max(
            int((ld.clamp(max=W + 1) - ld_p.clamp(max=W + 1)).abs().max()),
            int((lcs - lcs_p).abs().max()),
        )
        if err:
            raise SystemExit(f"dl_lcs kernel differs from plain at W={W}")
        ms = time_ms(lambda: dl_lcs(a, al, b, bl, L, W), 10, inner=10)
        dev = device_ms(lambda: dl_lcs(a, al, b, bl, L, W), "dl_lcs_kernel",
                        10)
        plain = time_ms(
            lambda: dl_metrics_windowed_plain(a, al, b, bl, L, W), 3
        )
        bound, by = k2_bound_ms(al, bl, L, W, peaks)
        px = k2_ptxas.get((W, lmax))
        k2[W] = (err, ms, plain, bound, by, dev, px)
        log(f"K2 dl_lcs W={W}: P={P} L={L} ({n_distinct} distinct "
            f"main-path pairs) equal to plain (DL clipped at W+1); kernel "
            f"{ms:.3f} ms (CUDA events, 10 back-to-back calls; profiler "
            f"device time {ms4(dev)}), plain {plain:.3f} ms, bound "
            f"{bound:.4f} ms ({by}); instance W={W} LMAX={lmax}: ptxas {px}, "
            f"dynamic shared memory {k2_smem_bytes(W, L)} bytes per block of "
            f"{threads} threads | {card}")
    # K2 at the budget: the main path's first batch as the kernel gets it,
    # P slots of which the valid ones lead and the rest are empty strings
    W = 3
    ld, lcs = dl_lcs(*slots, L, W)
    ld_p, lcs_p, _, _ = dl_metrics_windowed_plain(*slots, L, W)
    torch.cuda.synchronize()
    if not (torch.equal(ld.clamp(max=W + 1), ld_p.clamp(max=W + 1))
            and torch.equal(lcs, lcs_p)):
        raise SystemExit("dl_lcs kernel differs from plain at the budget")
    entry = next(r for r in records if r["name"] == "dl_lcs_slots")
    budget = {
        "P": P_main, "valid": n_distinct,
        "ms": time_ms(lambda: dl_lcs(*slots, L, W), 10, inner=10),
        "device_ms": device_ms(lambda: dl_lcs(*slots, L, W),
                               "dl_lcs_kernel", 10),
        "bound_ms": k2_bound_ms(slots[1], slots[3], L, W, peaks)[0],
        "slot_entry_ms": entry["ms"],
        "slot_entry_device_ms": entry["device_ms"],
        "slot_entry_bound_ms": entry["bound_ms"],
    }
    log(f"K2 dl_lcs W={W} at the main path's budget: P={P_main} slots, "
        f"{n_distinct} valid, equal to plain; pair-string entry "
        f"{budget['ms']:.3f} ms (CUDA events, 10 back-to-back calls; "
        f"profiler device time {ms4(budget['device_ms'])}), bound "
        f"{budget['bound_ms']:.4f} ms; slot entry {entry['ms']:.3f} ms "
        f"(device {ms4(entry['device_ms'])}), bound "
        f"{entry['bound_ms']:.4f} ms | {card}")
    records.append({
        "name": "dl_lcs", "route": "cuda",
        "source": "analiticcl_tpu_torch/csrc/dl_lcs.cu",
        "replaces": "analiticcl_tpu/ops/dl_pallas.py:47",
        "max_abs_err": max(v[0] for v in k2.values()),
        "ms": k2[3][1], "plain_ms": k2[3][2],
        "bound_ms": k2[3][3], "bound_by": k2[3][4], "library_ms": None,
        "library_note": "no PyTorch call computes banded Damerau-Levenshtein",
        "launches_note": "launches of either entry: the paths run the slot "
                         "entry (its own record's by_window has its times), "
                         "which adds to this count too; ms, by_window and "
                         "the bound are the pair-string entry's",
        "by_window": {W: {"ms": v[1], "device_ms": v[5], "plain_ms": v[2],
                          "bound_ms": v[3], "ptxas": v[6]}
                      for W, v in k2.items()},
        "at_budget_w3": budget,
    })

    # ---- 5. the main path ----
    list(model.find_variants_stream(queries[:BATCH], params))  # warm-up
    sync_free_submit("main path", pipe, queries[:BATCH], params, card)
    reset_counts()
    pipe.candidates = pipe.survivors = 0
    pipe.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(model.find_variants_stream(queries, params, BATCH))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    cand, surv = pipe.candidates, pipe.survivors
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in sorted(
        pipe.stats.totals.items()))
    async_stages = async_line(pipe.stats, N_QUERIES // BATCH)
    budgets = {B: (pipe._P_by_B[B], pipe._P2_by_B[B]) for B in pipe._P_by_B}

    params_ratio = SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_with_limit(0.5, 6),
        max_edit_distance=DistanceThreshold.ratio_with_limit(0.5, 12),
        max_matches=10,
        score_threshold=0.25,
    )
    long_words = [w for w in words if len(w) >= 9]
    rq = corrupt_queries(long_words, SEED + 2, N_RATIO)
    ratio_results = list(model.find_variants_stream(rq, params_ratio, BATCH))
    launches = launch_counts()
    if len(results) != N_QUERIES or len(ratio_results) != N_RATIO:
        raise SystemExit("main path returned the wrong number of results")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: {launches}")
    require_k1("main path", launches["stage_a"])
    require_one_buffer_per_call("main path", launches)
    rlens = model.enc.normalize_batch_padded(rq, pipe.L)[1]
    n_w12 = int((rlens >= 14).sum())  # k_ed = len * 0.5 > 6 -> window 12
    if not 0 < n_w12 < N_RATIO:
        raise SystemExit(f"ratio queries did not mix windows ({n_w12} at W=12)")

    def tuples(res):
        return [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
                 r.via) for r in res]

    t1 = time.perf_counter()
    oracle = [model._find_variants_oracle(q, params)
              for q in queries[:N_ORACLE]]
    bad = [q for q, r, o in zip(queries, results, oracle)
           if tuples(r) != tuples(o)]
    bad += [q for q, r in zip(rq[:N_ORACLE_RATIO], ratio_results)
            if tuples(r) != tuples(model._find_variants_oracle(q, params_ratio))]
    if bad:
        raise SystemExit(f"{len(bad)} queries differ from the oracle: {bad[:5]}")
    n_found = sum(1 for r in results if r)
    shapes = core_shapes(model, words, params)
    log(f"main path: {N_QUERIES} queries in batches of {BATCH}: "
        f"{N_QUERIES / dt:.1f} q/s warm ({dt:.3f} s), "
        f"{cand / N_QUERIES:.2f} candidates and {surv / N_QUERIES:.2f} "
        f"survivors per query, {n_found} with a result; one "
        f"query_synth120k window ({shapes['queries']} queries, "
        f"{shapes['calls']} core calls) runs {len(shapes['distinct'])} "
        f"distinct (B, nb_band, P, P2, window) shapes: "
        f"{shapes['distinct']} | {card}")
    log(f"main path host stages over the {N_QUERIES} queries: {stages}")
    log(f"main path async: {async_stages}; budgets (P, P2) by batch size "
        f"{budgets} | {card}")
    log(f"ratio thresholds: {N_RATIO} queries, {n_w12} at W=12, window split; "
        f"oracle parity exact on {N_ORACLE} + {N_ORACLE_RATIO} queries "
        f"({time.perf_counter() - t1:.1f} s); launches {launches}")
    # one profiler window over a warm pass of the same 16,384 queries
    # (after the path's launch counts were read)
    log(f"main path {profile_pass(lambda: list(model.find_variants_stream(queries, params, BATCH)))} | {card}")
    cut_bucket_phase(model, queries, params, results, oracle, card)

    # ---- 6-8. search, search with a language model, learn ----
    by_path = {"query": launches}
    search_params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        max_ngram=2,
        lm_weight=1.0,
    )
    bigrams = synthetic_bigrams(words, SEED + 4, N_BIGRAMS)
    texts = synthetic_text(words, SEED + 3, N_LINES, bigrams)
    by_path["search"] = search_phase("search", model, texts, search_params,
                                     card)
    t0 = time.perf_counter()
    lm_model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words,
                        bigrams=bigrams)
    log(f"LM model: {len(lm_model.ngrams)} n-grams, built in "
        f"{time.perf_counter() - t0:.1f} s")
    by_path["lm_search"] = search_phase("LM search", lm_model, texts,
                                        search_params, card)
    del lm_model
    by_path["learn"] = learn_phase(model, words, card)

    # ---- 9. the CLI and the API ----
    by_path.update(cli_phase(words, queries, texts, card))

    # ---- 10. the index sharded over meshes of cuda:0 ----
    del model, pipe
    gc.collect()
    t10 = time.perf_counter()
    by_path.update(mesh_query_phase(words, queries, params, card))
    gc.collect()
    by_path.update(mesh_learn_phase(words, card))
    gc.collect()
    by_path.update(mesh_1m_phase(card))
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # ---- 11. the stop ladder, the roofline and a trace ----
    gc.collect()
    by_path.update(profiling_phase(words, queries, params,
                                   dt * 1e3 / (N_QUERIES // BATCH), card))

    # ---- 12. a lexicon wider than 64: K2's wide path ----
    gc.collect()
    wide_rec, wide_paths = wide_phase(words, card, peaks)
    by_path.update(wide_paths)

    # ---- 13. planes wider than a resident K1 block holds ----
    gc.collect()
    planes_rec, planes_paths = planes_phase(words, card, peaks)
    by_path.update(planes_paths)

    # ---- 14. variant and error lists, rules, early confusables,
    # checkpoints ----
    gc.collect()
    variant_paths = variants_phase(words, card)
    by_path.update(variant_paths)

    for r in records:
        r["launches"] = launches[r["name"]]
        r["launches_by_path"] = {k: v[r["name"]] for k, v in by_path.items()}
    # every path's K1 launches by instance (require_k1)
    k1_rec = next(r for r in records if r["name"] == "stage_a")
    k1_rec["instance_by_check"] = dict(K1_CHECKED)
    records.append({
        "name": "stage_a_stream", "route": "cuda",
        "source": "analiticcl_tpu_torch/csrc/stage_a.cu",
        "replaces": "analiticcl_tpu/ops/stage_a.py:88",
        **planes_rec, "library_ms": None,
        "library_note": k1_rec["library_note"],
        "launches": K1_CHECKED["planes query"]["stream"],
        "launches_note": "K1's streamed instance (stage_a_kernel_stream: "
                         "launches whose band reaches a block wider than "
                         "a resident block of 128 queries holds, each "
                         "block at its own extent), counted on phase 13's "
                         "query path; times on its first batch, "
                         "main_batch's on the main instance, at_1664's and "
                         "at_6016's on seeded full-width planes",
        "launches_by_path": {
            **{k: v["stage_a_stream"] for k, v in variant_paths.items()},
            **{k: v["stream"] for k, v in K1_CHECKED.items()
               if "stream" in v}},
    })
    records.append({
        "name": "dl_lcs_wide", "route": "cuda",
        "source": "analiticcl_tpu_torch/csrc/dl_lcs.cu",
        "replaces": "analiticcl_tpu/ops/dl_pallas.py:47",
        **wide_rec, "library_ms": None,
        "library_note": "no PyTorch call computes banded Damerau-Levenshtein",
        "launches": wide_paths["wide_query"]["dl_lcs_wide"],
        "launches_note": "K2's wide path (one warp a pair with a string "
                         "over 64, taken from the byte launch's work list), "
                         "which either entry launches after its byte path "
                         "above L 64 (once a slot-entry launch, checked on "
                         "each path); counted on phase 12's query path",
        "launches_by_path": {
            **{k: v["dl_lcs_wide"] for k, v in variant_paths.items()},
            **{k: v["dl_lcs_wide"]
               for k, v in {**wide_paths, **planes_paths}.items()}},
    })
    log(json.dumps(stamp({"kernels": records})))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
