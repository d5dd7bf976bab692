"""Tracing and profiling: the stage timer, profiler windows and traces, and
the stop ladder of the query core.

The port of ``analiticcl_tpu/utils/profiling.py``, on ``torch.profiler``:

  * :class:`StageTimer` (copied) accumulates host wall-clock per named
    stage; ``DevicePipeline.stats`` holds one, printed at debug >= 2;
    :class:`GcClock` adds the garbage collector's time;
  * :func:`trace` wraps a block in a ``torch.profiler`` window and writes a
    Chrome trace (CPU activity, and the card's when one is in use);
  * :func:`profile_window` runs a function under the profiler and sums what
    the card did: busy time, device ops, time per kernel name, and the
    host's time in CUDA runtime calls;
  * :func:`stop_ladder` times the ``stop_stage`` prefixes of
    ``ops.pipeline.query_core`` (host enqueue, CUDA events, one profiler
    window each), the counterpart of ``tools/profile_device_stages.py``.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=sys.stderr) -> None:
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            print(
                f" (stage {name}: {total * 1e3:.1f} ms over {n} calls, "
                f"{total / n * 1e3:.2f} ms/call)",
                file=out,
            )

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()


class GcClock:
    """Counts the Python garbage collector's collections and their time
    while the ``with`` block runs; with ``pause``, the collector is off
    for the block instead, and back in its prior state after it."""

    def __init__(self, pause: bool = False) -> None:
        self.n, self.ms, self._t0 = 0, 0.0, 0.0
        self.pause = pause

    def __call__(self, phase, _info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.n += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self):
        self._was_enabled = gc.isenabled()
        gc.callbacks.append(self)
        if self.pause:
            gc.disable()
        return self

    def __exit__(self, *exc) -> None:
        if self.pause and self._was_enabled:
            gc.enable()
        gc.callbacks.remove(self)


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Run the block under ``torch.profiler`` and write its Chrome trace
    (``trace_<pid>_<ns>.json``) into ``logdir``; with ``None``, do nothing.
    The trace holds CPU activity, and the card's when CUDA is available."""
    if logdir is None:
        yield
        return
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities(torch.cuda.is_available())) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class DeviceProfile(NamedTuple):
    """What one profiler window saw. Device fields are None on the CPU."""

    wall_ms: float  # host clock over the window, ending in a sync
    busy_ms: Optional[float]  # union of the card's op intervals
    n_ops: Optional[int]  # the card's ops (kernels, copies, sets)
    by_name: Dict[str, float]  # device ms per op name
    runtime: Dict[str, float]  # host ms per CUDA runtime call name
    n_by_name: Dict[str, int]  # device ops per op name

    @property
    def idle_share(self) -> Optional[float]:
        if self.busy_ms is None:
            return None
        return 1 - self.busy_ms / self.wall_ms


def profile_window(fn: Callable, cuda: bool):
    """``fn()`` under one ``torch.profiler`` window, the card synchronised
    before and after: ``(fn's result, DeviceProfile)``. In a process that
    has run much device work before, the profiler may return fewer device
    records than the card ran (PERF.md section 6); a fresh process gets
    them all."""
    from torch.profiler import profile

    if cuda:
        torch.cuda.synchronize()
    with profile(activities=_activities(cuda)) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if not cuda:
        return out, DeviceProfile(wall, None, None, {}, {}, {})
    by_name: Dict[str, float] = {}
    n_by_name: Dict[str, int] = {}
    runtime: Dict[str, float] = {}
    spans = []
    for e in prof.events():
        tr = e.time_range
        ms = (tr.end - tr.start) / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((tr.start, tr.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
        elif e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0.0) + ms
    busy = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    return out, DeviceProfile(wall, busy / 1e3, len(spans), by_name,
                              runtime, n_by_name)


def settled_batch(pipe, queries, params):
    """``queries`` as one device batch of ``pipe`` after two submit/collect
    rounds have settled its pair budgets: ``(prepared state,
    query_core's keyword arguments)``. On CUDA the uploads (made on the
    pipeline's stream) are finished and their memory kept for use on the
    current stream."""
    for _ in range(2):
        pipe.collect(pipe.submit(queries, params))
    st = pipe.prepare(queries, params)
    if "args" not in st:
        raise ValueError("the batch splits (DL window or memory cap): it "
                         "forms no single core call")
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
        for t in st["args"]:
            t.record_stream(torch.cuda.current_stream())
    P, P2 = pipe._budgets(st["B"])
    return st, dict(have_freq=bool(pipe.model.have_freq), P=P, P2=P2,
                    window=st["window"], nb_band=st["nb_band"],
                    width=st["width"], use_stop_exact=st["use_stop_exact"])


# the ladder of query_core prefixes, ending with the whole core (None)
LADDER = ("noop", "stageA", "resolve", "gather_dl", "score", "compact_sum",
          None)
# back-to-back calls per stop: one call between two events times the
# wrapper's host work, not the card
REPS = 10


class Rung(NamedTuple):
    """One prefix of the core over :data:`REPS` back-to-back calls, per
    call."""

    stop: str  # the stop stage, "full" for the whole core
    enqueue_ms: float  # host time until the calls return, no sync
    event_ms: Optional[float]  # CUDA events around the run, card held first
    busy_ms: Optional[float]  # profiler: the card's busy time
    n_ops: Optional[float]  # profiler: the card's ops
    out: tuple  # the last call's outputs
    n_by_name: Optional[Dict[str, float]] = None  # profiler: ops per name


def _sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``, which spins the current stream
    for a number of clock cycles, timed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def stop_ladder(call: Callable, cuda: bool):
    """Each stop of :data:`LADDER` (``call(stop)`` runs the core once,
    ``None`` the whole core): one warm call, then :data:`REPS` back-to-back
    calls three times: timed on the host until they return (the enqueue);
    between CUDA events after ``torch.cuda._sleep`` has held the card for
    twice that time, so that the host is ahead and the events time the card;
    and under one profiler window. Returns one :class:`Rung` per stop. On
    the CPU only the host clock is read."""
    rate = _sleep_cycles_per_ms() if cuda else None
    rungs = []
    for stop in LADDER:
        out = call(stop)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = call(stop)
        enqueue = (time.perf_counter() - t0) * 1e3 / REPS
        event_ms = busy = n_ops = n_by_name = None
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int((2 * enqueue * REPS + 5) * rate))
            start.record()
            for _ in range(REPS):
                call(stop)
            end.record()
            end.synchronize()
            event_ms = start.elapsed_time(end) / REPS
            _, prof = profile_window(
                lambda: [call(stop) for _ in range(REPS)], cuda)
            busy, n_ops = prof.busy_ms / REPS, prof.n_ops / REPS
            n_by_name = {k: v / REPS for k, v in prof.n_by_name.items()}
        rungs.append(Rung(stop or "full", enqueue, event_ms, busy, n_ops,
                          tuple(out), n_by_name))
    return rungs
