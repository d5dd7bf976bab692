"""The port's benchmark, ``bench_torch.py``, on the CPU at a small size.

Both cells run through ``main(argv)`` with ``--device cpu`` and the
module's size constants cut: the gates pass, every metric that
``BENCHMARK.json`` names is printed with its unit and lands in the last
line's record, every round holds its windows or passes with the host's
readings beside them, the metric is all the rounds' work over all their
time with the median round beside it, the settings the
harness imposes (affinity, torch's threads, rounds) are recorded and
undone when ``main`` returns, and a tampered device result, in a gate or
in the last timed round, makes the run abort with no metric. On the CPU
the kernel wrappers take their plain versions and count no launch, so
counting wrappers stand in for the launches the script requires after
every timed window. The script's own reference agrees with the port's
host oracle, with distances worked by hand and with itself in spawned
processes; ``settled_view`` makes ``bench.py``'s selection; the round
statistic, the card's busy intervals and idle gaps, the card's CPU list
and the host readings are
checked by hand, a source the kernel does not keep reading "not
measured"; and ``--device cuda`` raises without a card."""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.ops import pipeline as pipeline_mod
from analiticcl_tpu_torch.ops.dl import dl_lcs, dl_lcs_slots
from analiticcl_tpu_torch.ops.stage_a import stage_a_masks
from analiticcl_tpu_torch.types import VariantResult

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SMALL = {"N_LEXICON": 3000, "BATCH": 64, "N_QUERIES": 256, "N_GATE": 64,
         "N_W12": 16, "SAMPLE_EVERY": 16, "N_LINES": 64, "N_PASSES": 4,
         "ROUNDS": 3, "WORKERS": 0}

torch.set_num_threads(2)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench(**sizes):
    """A fresh ``bench_torch`` module with its size constants set. It is
    ``sys.modules["bench_torch"]``, as the script is ``__main__`` when run,
    so that its reference processes can be handed its functions."""
    mod = _load("bench_torch")
    for name, value in sizes.items():
        assert hasattr(mod, name), name
        setattr(mod, name, value)
    sys.modules["bench_torch"] = mod
    return mod


@pytest.fixture
def counted(monkeypatch):
    """Each call of a kernel wrapper from the pipeline adds one to the
    kernel's launch count, as a launch on the card does: K1's wrapper to
    its own, K2's slot entry to K2's (``dl_lcs``)."""
    for fn, counter in ((stage_a_masks, stage_a_masks),
                        (dl_lcs_slots, dl_lcs)):
        monkeypatch.setattr(counter, "launches", 0)

        def counting(*args, _fn=fn, _counter=counter, **kwargs):
            _counter.launches += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(pipeline_mod, fn.__name__, counting)


def _cell(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in spec["workloads"] if w["name"] == name]
    return cell


def _host_fields_are_sane(h: dict) -> None:
    """One window's host readings on this machine: CPU seconds, switches and
    faults as counts or "not measured", RSS above 0."""
    for key in ("cpu_user_s", "cpu_sys_s", "cpu_main_thread_s",
                "cpu_per_wall"):
        assert h[key] >= 0, key
    for key in ("switches_voluntary", "switches_involuntary", "faults_minor",
                "faults_major"):
        assert h[key] == "not measured" or (
            isinstance(h[key], int) and h[key] >= 0), key
    assert h["rss_mib"] > 0 and h["threads"] >= 1
    assert h["last_core"] == "not measured" or h["last_core"] in range(
        os.cpu_count())
    for g in range(3):
        assert isinstance(h[f"gc_gen{g}"], int) and h[f"gc_gen{g}"] >= 0


@pytest.mark.parametrize("cell", ["query_synth120k", "search_synth120k"])
def test_cell_runs_on_the_cpu(cell, counted, capsys):
    affinity, threads = os.sched_getaffinity(0), torch.get_num_threads()
    bench = _bench(**{**SMALL, "WORKERS": 2})  # the reference in processes
    assert bench.main(["--cell", cell] + CPU) == 0
    # the harness's settings are undone when main returns
    assert os.sched_getaffinity(0) == affinity
    assert torch.get_num_threads() == threads
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("gates: passed")
    record = json.loads(out[-1])
    assert record["cell"] == cell and record["correct"] is True
    assert record["device"]["platform"] == "cpu"
    assert record["lexicon"] == "synthetic-3k"
    spec = _cell(cell)
    assert spec["chips"] == 1 and f"--cell {cell}" in spec["command"]
    assert record["metric"] == spec["metric"]["name"]
    assert record["unit"] == spec["metric"]["unit"]
    assert record["value"] > 0
    named = ([spec["metric"]] + spec["beside_metrics"]
             + spec["layer_metrics"] + spec["setup_metrics"])
    printed = {line.split(":")[0]: line for line in out[1:-1]}
    for m in named:
        assert m["name"] in printed, m["name"]
        assert m["unit"] in printed[m["name"]], m["name"]
        assert record["metrics"][m["name"]]["unit"] == m["unit"]
    metrics = {k: v["value"] for k, v in record["metrics"].items()}
    for key in ("peak_device_memory", "device_busy_ms", "device_idle_share",
                "card_pci_bus_id", "card_local_cpulist"):
        assert metrics[key] == "not measured", key
    assert metrics["heap_frozen_objects"] > 0
    for key in ("torch", "cuda", "nvcc", "card", "commit"):
        assert key in record
    # the settings the harness imposes, named in the record
    assert record["settings"] == {
        "affinity": sorted(affinity),
        "affinity_source": "present affinity: the card's NUMA-local CPU "
                           "list is not readable",
        "torch_threads": 1, "rounds": 3}
    assert metrics["torch_threads"] == 1
    assert metrics["host_affinity_cores"] == len(affinity)
    assert metrics["host_cpu_count"] == os.cpu_count()
    for when in ("before_timed", "after_timed"):
        assert metrics[f"loadavg_{when}"] == "not measured" or len(
            metrics[f"loadavg_{when}"]) == 3
        assert metrics[f"cpu_mhz_{when}"] == "not measured" or metrics[
            f"cpu_mhz_{when}"] > 0
    assert record["statistic"] == "all the work of 3 rounds over their time"
    assert spec["metric"]["statistic"].startswith(
        "all the work of 3 rounds over their summed time")
    assert record["profiled"]["wall_ms"] > 0
    assert record["profiled"]["idle_gaps"] == "not measured"
    rounds = record["rounds"]
    assert len(rounds) == 3
    if cell == "query_synth120k":
        for rd in rounds:
            assert len(rd["windows"]) == 9
            assert all(min(w["launches"].values()) > 0 for w in rd["windows"])
            settled = rd["settled_windows"]
            seconds = sum(rd["windows"][i - 1]["seconds"] for i in settled)
            assert rd["seconds"] == pytest.approx(seconds)
            assert rd["queries"] == 256 * len(settled)
            assert rd["value"] == pytest.approx(256 * len(settled) / seconds)
        assert record["batch"] == 64
        assert record["checked"] == {"gate_query": 64, "gate_w12": 16,
                                     "timed_sample": 3 * 9 * 256 // 16}
        work = [(rd["queries"], rd["seconds"]) for rd in rounds]
        rows = [w for rd in rounds for w in rd["windows"]]
    else:
        for rd in rounds:
            assert len(rd["passes"]) == 4
            assert all(p["tokens"] > 64 * 8 for p in rd["passes"])
            assert all(min(p["launches"].values()) > 0 for p in rd["passes"])
            assert rd["tokens"] == sum(p["tokens"] for p in rd["passes"])
            assert rd["seconds"] == pytest.approx(
                sum(p["seconds"] for p in rd["passes"]))
        assert record["checked"] == {"gate_lines": 32,
                                     "timed_lines": 3 * 4 * 32}
        work = [(rd["tokens"], rd["seconds"]) for rd in rounds]
        rows = [p for rd in rounds for p in rd["passes"]]
    # every round's traffic is fresh
    key = "candidates_per_query" if cell == "query_synth120k" else "tokens"
    assert len({rd[key] for rd in rounds}) == 3
    if cell == "query_synth120k":  # round 0's, a single block's traffic
        for key in ("candidates_per_query", "survivors_per_query"):
            assert metrics[key] == rounds[0][key] > 0
    overall, median, spread = bench.round_view(work)
    assert record["value"] == overall == pytest.approx(
        sum(w for w, _ in work) / sum(s for _, s in work))
    name = record["metric"]
    assert metrics[f"{name}_round_median"] == median == sorted(
        w / s for w, s in work)[1]
    assert metrics[f"{name}_round_spread"] == pytest.approx(spread)
    for row in rows:
        _host_fields_are_sane(row["host"])
        assert row["host"]["probe_ms"] > 0


def _tamper_query(monkeypatch, call=0, start=0):
    """Shift one score of the ``call``-th stream (0 and 1: the gates, 2 on:
    the timed rounds), in its first checked non-empty result from
    ``start`` on."""
    real = VariantModel.find_variants_stream
    calls = []

    def stream(self, *args, **kwargs):
        calls.append(None)
        mine = len(calls) - 1 == call
        for k, res in enumerate(real(self, *args, **kwargs)):
            if mine and res and k >= start and k % SMALL["SAMPLE_EVERY"] == 0:
                r = res[0]
                res = [VariantResult(r.vocab_id, r.dist_score + 1e-9,
                                     r.freq_score, r.via)] + res[1:]
                mine = False
            yield res

    monkeypatch.setattr(VariantModel, "find_variants_stream", stream)


def _tamper_search(monkeypatch, call=0):
    """Reverse the fourth line's matches in the ``call``-th stream (0: the
    gate's warm-up pass, 1 on: the timed passes, N_PASSES to a round)."""
    real = VariantModel.find_all_matches_stream
    calls = []

    def stream(self, *args, **kwargs):
        calls.append(None)
        mine = len(calls) - 1 == call
        for k, out in enumerate(real(self, *args, **kwargs)):
            yield out[::-1] if mine and k == 3 else out

    monkeypatch.setattr(VariantModel, "find_all_matches_stream", stream)


@pytest.mark.parametrize("cell,tamper,where,check", [
    ("query_synth120k", _tamper_query, {}, "gate query"),
    ("query_synth120k", _tamper_query, {"call": 1}, "gate w12"),
    ("query_synth120k", _tamper_query, {"call": 3, "start": 256 * 4},
     "timed windows"),
    ("search_synth120k", _tamper_search, {}, "gate search"),
    ("search_synth120k", _tamper_search, {"call": 7}, "timed passes"),
], ids=["query", "query_w12", "query_timed", "search", "search_timed"])
def test_a_differing_result_aborts(cell, tamper, where, check, counted,
                                   monkeypatch, capsys):
    """Timed results are tampered in the last of two rounds: the check
    holds every round."""
    tamper(monkeypatch, **where)
    with pytest.raises(SystemExit) as err:
        _bench(**{**SMALL, "ROUNDS": 2}).main(["--cell", cell] + CPU)
    assert str(err.value.code).startswith(f"{check}: 1 of ")
    assert str(err.value.code).endswith("benchmark aborted")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("a,b,dl,lcs,prefix,suffix", [
    ("ca", "abc", 2, 1, 0, 0),  # restricted (OSA) distance 3
    ("abc", "acb", 1, 1, 1, 0),
    ("kitten", "sitting", 3, 3, 0, 0),
    ("abcdef", "badcfe", 3, 1, 0, 0),
    ("a", "", 1, 0, 0, 0),
    ("word", "word", 0, 4, 4, 4),
    ("theere", "there", 1, 3, 3, 3),
])
def test_reference_distances_by_hand(a, b, dl, lcs, prefix, suffix):
    bench = _bench()
    a, b = a.encode(), b.encode()
    assert bench.damerau_levenshtein(a, b) == dl
    assert bench.damerau_levenshtein(b, a) == dl
    assert bench.longest_common_substring(a, b) == lcs
    assert bench.common_prefix(a, b) == prefix
    assert bench.common_prefix(a[::-1], b[::-1]) == suffix


@pytest.mark.parametrize("rules", ["ABSOLUTE", "RATIO", "search"])
def test_reference_agrees_with_the_port_oracle(rules):
    """The script's reference against the port's host-only path (numpy
    retrieval, scalar distances, object-path consolidation) on a seeded
    lexicon: the two are written apart, and must agree result for
    result."""
    from analiticcl_tpu_torch.testing import (
        ALPHABET, populate, synthetic_lexicon, synthetic_text,
    )

    bench = _bench()
    words = synthetic_lexicon(5, 3000)
    model = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)
    model.set_backend("oracle")
    ref = bench.Reference(ALPHABET, words)
    if rules == "search":
        texts = synthetic_text(words, 5, 24)
        got = model.find_all_matches_batch(
            texts, bench.search_parameters(max_ngram=bench.MAX_NGRAM))
        assert [bench.match_signature(model, o) for o in got] == [
            ref.search(t) for t in texts]
        return
    rule = getattr(bench, rules)
    base = [w for w in words if len(w) >= (9 if rules == "RATIO" else 1)]
    queries = bench.corrupted(base, 200, 5, rules, times=2)
    params = bench.search_parameters(rule)
    want = [ref.lookup(q, rule) for q in queries]
    assert sum(len(w) for w in want) > 400
    assert [bench.as_tuples(model, model.find_variants(q, params))
            for q in queries] == want


def test_no_launch_in_a_window_raises(capsys):
    """Without counting wrappers the CPU path launches no kernel, and the
    first timed window says so."""
    with pytest.raises(RuntimeError, match="window 0: a kernel was not"):
        _bench(**SMALL).main(["--cell", "query_synth120k"] + CPU)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("passes,complete", [
    ([50.0, 90.0, 100.0, 101.0, 99.0, 102.0, 98.0, 100.0, 300.0], True),
    ([30.0, 60.0, 100.0, 101.0, 99.0, 102.0, 98.0, 100.0, 300.0], True),
    ([100.0, 101.0, 99.0, 102.0, 98.0], False),
    ([10.0, 20.0, 30.0], True),
    ([10.0, 100.0, 100.0, 100.0], True),
    ([1.0, 1.0, 1.0, 100.0, 100.0, 100.0], False),
])
def test_settled_view_is_bench_pys(passes, complete):
    got = _bench().settled_view(passes, complete)
    assert got == _load("bench").settled_view(passes, complete)


def test_settled_view_by_hand():
    sv = _bench().settled_view
    # fill windows below 70 % of the tail's median go, and the drain window
    assert sv([30.0, 60.0, 100.0, 101.0, 99.0, 300.0], True) == (
        [2, 3, 4], [100.0, 101.0, 99.0])
    # an unfinished stream keeps its last window
    assert sv([100.0, 101.0, 99.0, 102.0], False) == (
        [0, 1, 2, 3], [100.0, 101.0, 99.0, 102.0])
    # under four windows no drain window goes, a slow first one still does
    assert sv([1.0, 2.0, 3.0], True) == ([1, 2], [2.0, 3.0])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _bench().main(["--cell", "query_synth120k"])


def test_cells_are_the_benchmarks():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in spec["workloads"]]
    assert names == ["query_synth120k", "search_synth120k"]
    bench_torch = _bench()
    assert tuple(names) == bench_torch.CELLS
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert len(w["source"]) <= 200
        assert w["metric"]["bound_pct"] >= 5
        assert w["command"] == f"python3 bench_torch.py --cell {w['name']}"


def test_round_view_by_hand():
    rv = _bench().round_view
    # rates 100, 150 and 90: all the work over all the time, the median
    # round, and max/min of the rates
    assert rv([(100, 1.0), (300, 2.0), (90, 1.0)]) == (122.5, 100.0, 150 / 90)
    # a round slowed whole moves the metric, not the median
    assert rv([(100, 1.0), (300, 2.0), (90, 3.0)]) == (
        490 / 6, 100.0, 150 / 30)
    # an even count of rounds takes the mean of the middle two
    assert rv([(100, 1.0), (200, 1.0), (60, 0.5), (300, 1.0)]) == (
        660 / 3.5, 160.0, 3.0)
    # one round: its own rate
    assert rv([(50, 2.0)]) == (25.0, 25.0, 1.0)


def test_host_readings_by_source(monkeypatch):
    """Counters of this process are counts, and a source a kernel does not
    keep (zeros since boot, a missing file) reads "not measured", never
    0."""
    import resource

    bench = _bench()
    before = bench.host_counters()
    sum(range(10**6))
    h = bench.host_window(before, bench.host_counters(), 0.5)
    _host_fields_are_sane(h)
    assert h["cpu_per_wall"] == pytest.approx(
        (h["cpu_user_s"] + h["cpu_sys_s"]) / 0.5)
    monkeypatch.setattr(bench, "read_proc", lambda path: None)
    zero = SimpleNamespace(ru_utime=1.0, ru_stime=0.5, ru_nvcsw=0,
                           ru_nivcsw=0, ru_minflt=0, ru_majflt=0)
    monkeypatch.setattr(resource, "getrusage", lambda who: zero)
    h = bench.host_window(bench.host_counters(), bench.host_counters(), 1.0)
    for key in ("switches_voluntary", "switches_involuntary", "faults_minor",
                "faults_major", "rss_mib", "last_core", "threads"):
        assert h[key] == "not measured", key
    assert h["cpu_user_s"] == 0.0 and h["cpu_per_wall"] == 0.0
    monkeypatch.setattr(os, "getloadavg", lambda: (0.0, 0.0, 0.0))
    metrics = {}
    bench.host_state(metrics, "x")
    assert metrics == {
        "loadavg_x": ("not measured", "1/5/15-minute load"),
        "cpu_mhz_x": ("not measured", "MHz, mean over the allowed cores")}


@pytest.mark.parametrize("smi,bus,local", [
    ("00000000:1B:00.0\n", "0000:1b:00.0", "0-3,8"),
    ("0000:c4:00.0\n", "0000:c4:00.0", "0-3,8"),
    ("[N/A]\n", "not measured", "not measured"),
])
def test_card_local_cpus(smi, bus, local, monkeypatch):
    bench = _bench()
    monkeypatch.setattr(bench.subprocess, "run",
                        lambda *a, **k: SimpleNamespace(stdout=smi))
    read = []
    monkeypatch.setattr(bench, "read_proc",
                        lambda path: read.append(path) or "0-3,8\n")
    assert bench.card_local_cpus("cuda") == (bus, local)
    assert read == ([] if bus == "not measured"
                    else [f"/sys/bus/pci/devices/{bus}/local_cpulist"])
    assert bench.card_local_cpus("cpu") == ("not measured", "not measured")
    assert bench.cpu_list("0-3,8") == [0, 1, 2, 3, 8]


def test_pin_host(monkeypatch):
    """The process goes to the card's NUMA-local cores it may run on, or
    keeps its affinity, and torch to TORCH_THREADS; each is recorded."""
    bench = _bench()
    affinity, threads = os.sched_getaffinity(0), torch.get_num_threads()
    core = min(affinity)
    metrics = {}
    try:
        monkeypatch.setattr(bench, "card_local_cpus",
                            lambda device: ("0000:1b:00.0", f"{core}"))
        bench.pin_host("cuda", metrics)
        assert os.sched_getaffinity(0) == {core}
        assert torch.get_num_threads() == bench.TORCH_THREADS == 1
        assert metrics["host_affinity_cores"] == (1, "cores")
        assert metrics["host_affinity_source"][0] == (
            "the card's NUMA-local cores")
        assert metrics["card_local_cpulist"] == (f"{core}",
                                                 "NUMA-local CPU list")
        os.sched_setaffinity(0, affinity)
        monkeypatch.setattr(bench, "card_local_cpus",
                            lambda device: ("0000:1b:00.0", "100000"))
        bench.pin_host("cuda", metrics)
        assert os.sched_getaffinity(0) == affinity
        assert metrics["host_affinity_source"][0] == (
            "present affinity: the card's NUMA-local CPU list is outside it")
    finally:
        os.sched_setaffinity(0, affinity)
        torch.set_num_threads(threads)


def test_idle_gaps_by_hand():
    from torch.autograd import DeviceType

    def ev(name, start, end, cuda=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=start, end=end),
            device_type=DeviceType.CUDA if cuda else DeviceType.CPU)

    events = [ev("k1", 1000, 2000, True), ev("copy", 1500, 2500, True),
              ev("k2", 4500, 5000, True), ev("k3", 6000, 7000, True),
              ev("aten::add", 2600, 2700)]
    stages = [("host_tail", 2000, 4000), ("host_prep", 4000, 6500),
              ("host_prep", 900, 1000)]
    gaps = _bench().idle_gaps(events, stages)
    # the card is busy over [1000, 2500], [4500, 5000] and [6000, 7000] us
    assert gaps == [
        {"ms": 2.0, "at_ms": 1.5,
         "stages_ms": {"host_tail": 1.5, "host_prep": 0.5}},
        {"ms": 1.0, "at_ms": 4.0, "stages_ms": {"host_prep": 1.0}}]
    assert _bench().idle_gaps(events, stages, top=1) == gaps[:1]
    assert _bench().idle_gaps(events[:2], stages) == []


def test_device_spans_by_hand():
    """The card's busy intervals: device operations only, overlapping or
    touching ones merged, in order; their sum is the profiled window's
    busy time."""
    from torch.autograd import DeviceType

    def ev(start, end, cuda=True):
        return SimpleNamespace(
            time_range=SimpleNamespace(start=start, end=end),
            device_type=DeviceType.CUDA if cuda else DeviceType.CPU)

    spans = _bench().device_spans([
        ev(6000, 7000), ev(1500, 2500), ev(1000, 2000), ev(2500, 3000),
        ev(3100, 3200), ev(0, 9000, cuda=False)])
    assert spans == [[1000, 3000], [3100, 3200], [6000, 7000]]
    assert sum(e - s for s, e in spans) == 3100
    assert _bench().device_spans([ev(0, 10, cuda=False)]) == []


def test_reference_answers_in_processes():
    """The reference's answers from its processes equal its own, in
    order."""
    from analiticcl_tpu_torch.testing import (
        ALPHABET, synthetic_lexicon, synthetic_text,
    )

    bench = _bench(WORKERS=2)
    words = synthetic_lexicon(7, 2000)
    ref = bench.Reference(ALPHABET, words)
    queries = [(q, rules) for rules in (bench.ABSOLUTE, bench.RATIO)
               for q in bench.corrupted(words, 40, 7, "pool", times=2)]
    texts = [(t,) for t in synthetic_text(words, 7, 6)]
    with bench.reference_answers(ref) as answers:
        lookups = answers("lookup", queries)
        lines = answers("search", texts)
        assert not isinstance(lookups, list) or len(
            os.sched_getaffinity(0)) < 3  # no processes on under 3 cores
        lookups, lines = list(lookups), list(lines)
    assert lookups == [ref.lookup(*a) for a in queries]
    assert lines == [ref.search(*a) for a in texts]
    assert sum(map(len, lookups)) > 80
