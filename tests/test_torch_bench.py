"""The port's benchmark, ``bench_torch.py``, on the CPU at a small size.

Every cell runs through ``main(argv)`` with ``--device cpu`` and cut
copies of the cells' files (``--cells``): the gates pass, every metric
that ``BENCHMARK.json`` names is printed with its unit and lands in the
last line's record, every round holds its windows or passes with the
host's readings beside them, the metric is all the rounds' work over all
their time with the median round beside it, the settings the harness
imposes (affinity, torch's threads, rounds) are recorded and undone when
``main`` returns, and a tampered device result, in a gate or in the last
timed round, makes the run abort with no metric. On the CPU the kernel
wrappers take their plain versions and count no launch, so counting
stand-ins count the launches the script requires after every timed window
and pass; one stand-in that counts otherwise (a kernel not counted, K5 or
K4 apart from K1 or K3, a wide launch at L 64 or less) aborts the run in
its first window, and so does a module of JAX or of the JAX package
loaded during the run. The cells' files are the benchmark's cells and
are read strictly; the launch rules come from the built index; every
kernel source is built before the model. The script's own reference
agrees with the port's host oracle, with distances worked by hand and
with itself in spawned processes, and its language-model decode with the
JAX package's and the port's search at three n-best depths;
``settled_view`` makes ``bench.py``'s selection; the round statistic, the card's busy intervals and idle gaps,
the card's CPU list and the host readings are checked by hand, a source
the kernel does not keep reading "not measured"; and ``--device cuda``
raises without a card."""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace

import pytest
import torch

from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.ops import pipeline as pipeline_mod
from analiticcl_tpu_torch.ops.dl import (
    NARROW_LEN, dl_lcs, dl_lcs_slots, wide_path,
)
from analiticcl_tpu_torch.ops.stage_a import stage_a_masks
from analiticcl_tpu_torch.types import VariantResult

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SMALL = {"ROUNDS": 3, "WORKERS": 0}  # the harness's own constants
# the cells' sizes, cut where a cell's file has the key
CUT = {"lexicon_entries": 3000, "batch": 64, "window_queries": 256,
       "gate_queries": 64, "w12_queries": 16, "sample_every": 16,
       "lines": 64, "passes": 4}
# a cell of mode search_lm, which bench_cells/ holds none of (no n-gram
# list from a public corpus is in the repository): the search cell with a
# language model of synthetic bigrams at analiticcl's defaults
LM_CELL = {"mode": "search_lm", "bigrams": 2500, "lm_weight": 1.0,
           "variantmodel_weight": 3.0, "max_seq": 250}


def cut_cells(directory: Path, **cut) -> list:
    """``--cells`` naming ``directory``, which gets a copy of every cell
    file of ``bench_cells/`` with the values of CUT and ``cut`` in place of
    the file's where it has the key, and ``search_lm.json``: the cut search
    cell with LM_CELL's keys."""
    directory.mkdir(parents=True, exist_ok=True)
    for path in (ROOT / "bench_cells").glob("*.json"):
        spec = json.loads(path.read_text())
        spec.update({k: v for k, v in {**CUT, **cut}.items() if k in spec})
        (directory / path.name).write_text(json.dumps(spec))
        if path.stem == "search_synth120k":
            (directory / "search_lm.json").write_text(
                json.dumps({**spec, **LM_CELL}))
    return ["--cells", str(directory)]


@pytest.fixture
def cells(tmp_path):
    """``--cells`` of the cells' files at CUT."""
    return cut_cells(tmp_path / "cells")


torch.set_num_threads(2)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench(**sizes):
    """A fresh ``bench_torch`` module with its own constants set. It is
    ``sys.modules["bench_torch"]``, as the script is ``__main__`` when run,
    so that its reference processes can be handed its functions."""
    mod = _load("bench_torch")
    for name, value in sizes.items():
        assert hasattr(mod, name), name
        setattr(mod, name, value)
    sys.modules["bench_torch"] = mod
    return mod


def k1_instance(width: int, at_pad: int) -> str:
    """The instance ``kernel_instance`` gives a K1 launch ``width`` columns
    wide on planes ``at_pad`` wide on the H100: main up to 224 columns (on
    planes at least that wide), resident up to 576, streamed above."""
    if width <= 224 and at_pad >= 224:
        return "main"
    return "resident" if width <= 576 else "stream"


class Counting:
    """A kernel wrapper's stand-in on the CPU: each call runs the wrapper
    (whose CPU path is the plain version) after ``count(stub, *args,
    **kwargs)``, which counts as the wrapper does where it launches its
    kernel on the card. ``launches`` reads the wrapper's own counter, as the harness
    reads it."""

    def __init__(self, fn, count):
        self.fn, self.count, self.calls = fn, count, 0
        self.__name__ = fn.__name__

    def __call__(self, *args, **kwargs):
        self.calls += 1
        self.count(self, *args, **kwargs)
        return self.fn(*args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches


def count_k1(stub, bins, *args, **kwargs):
    stage_a_masks.launches += 1
    stage_a_masks.launches_by_instance[
        k1_instance(args[9], bins.shape[1])] += 1


def count_slots(wide_always=False):
    def count(stub, index, q_norms, *args, **kwargs):
        dl_lcs_slots.launches += 1
        dl_lcs.launches += 1
        wide_path.launches += wide_always or q_norms.shape[1] > NARROW_LEN
    return count


def count_own(stub, *args, **kwargs):
    stub.fn.launches += 1


def count_every_other(stub, *args, **kwargs):
    stub.fn.launches += stub.calls % 2


def no_count(stub, *args, **kwargs):
    pass


def install(monkeypatch, **changed):
    """Counting stand-ins for the five wrappers the pipeline calls, their
    counters zeroed; ``changed`` gives a wrapper (by its name) another
    count."""
    counts = {"stage_a_masks": count_k1, "query_planes": count_own,
              "resolve_pairs": count_own, "dl_lcs_slots": count_slots(),
              "compact_survivors": count_own, **changed}
    for fn in (stage_a_masks, dl_lcs_slots, dl_lcs, wide_path,
               pipeline_mod.query_planes, pipeline_mod.resolve_pairs,
               pipeline_mod.compact_survivors):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(stage_a_masks, "launches_by_instance",
                        dict.fromkeys(stage_a_masks.launches_by_instance, 0))
    for name, count in counts.items():
        fn = getattr(pipeline_mod, name)
        monkeypatch.setattr(pipeline_mod, name, Counting(fn, count))


@pytest.fixture
def counted(monkeypatch):
    """Each call of a kernel wrapper from the pipeline counts as its launch
    on the card would: K1 in all and by instance, K5, K3, K2's slot entry
    (in its own count, K2's and, above L 64, the wide path's) and K4."""
    install(monkeypatch)


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


@pytest.mark.parametrize("cell", ["query_synth120k", "search_synth120k",
                                  "search_lm"])
def test_cell_runs_on_the_cpu(cell, counted, cells, capsys):
    """A cut cell runs on the CPU; ``search_lm``, a cell of the benchmark's
    search_lm mode written beside the cut cells, is held to the search
    cell's workload, whose metrics it prints, and prints
    ``lm_changed_lines`` beside them."""
    affinity, threads = os.sched_getaffinity(0), torch.get_num_threads()
    bench = _bench(**{**SMALL, "WORKERS": 2})  # the reference in processes
    assert bench.main(["--cell", cell] + cells + CPU) == 0
    # the harness's settings are undone when main returns
    assert os.sched_getaffinity(0) == affinity
    assert torch.get_num_threads() == threads
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("gates: passed")
    record = json.loads(out[-1])
    assert record["cell"] == cell and record["correct"] is True
    assert record["device"]["platform"] == "cpu"
    assert record["lexicon"] == "synthetic-3k"
    assert record["kernel_sources"] == list(bench.KERNEL_SOURCES)
    # the cut file's values, as the run read them
    spec = record["cell_spec"]
    lm = spec["mode"] == "search_lm"
    assert spec["name"] == cell and spec["lexicon_entries"] == 3000
    read = (bench.read_cell("search_synth120k") if lm
            else bench.read_cell(cell))
    assert spec == json.loads(json.dumps({**vars(read), **{
        k: v for k, v in CUT.items() if k in spec}, "name": cell,
        **(LM_CELL if lm else {})}))
    assert record["launch_rules"] == {"wide": False}
    assert record["index"]["L"] <= NARROW_LEN
    # the language model's entries hold no index row
    assert record["index"]["lm_ngrams"] == (LM_CELL["bigrams"] if lm else 0)
    spec = _cell("search_synth120k" if lm else cell)
    assert spec["chips"] == 1
    assert lm or f"--cell {cell}" in spec["command"]
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
            for w in rd["windows"]:
                _launches_are_held(w["launches"])
                assert w["host_oracle_fallback_count"] == 0
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
            for p in rd["passes"]:
                _launches_are_held(p["launches"])
            assert rd["tokens"] == sum(p["tokens"] for p in rd["passes"])
            assert rd["seconds"] == pytest.approx(
                sum(p["seconds"] for p in rd["passes"]))
        checked = record["checked"]
        assert {k: checked.pop(k) for k in ("gate_lines", "timed_lines")} == {
            "gate_lines": 32, "timed_lines": 3 * 4 * 32}
        if lm:  # the language model changed some choice the gates held
            assert checked.pop("lm_changed_lines") == metrics[
                "lm_changed_lines"] >= 1
            assert "lm_changed_lines" in printed
        assert checked == {}
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


def _launches_are_held(launches: dict) -> None:
    """One window's or pass's launches as the CPU's counting stand-ins give
    them: every kernel by name, K1 by instance, K5 with K1 and K4 with K3,
    the slot entry as K2 (the pair-string entry not called), the wide path
    and K1's streamed instance not at all (the index is 64 wide or less,
    its planes narrower than 576 columns)."""
    assert set(launches) == {"k1", "k1_main", "k1_resident", "k1_stream",
                             "k5", "k3", "k2", "k2_slots", "k2_pairs",
                             "k2_wide", "k4"}
    assert min(launches[k] for k in ("k1", "k5", "k3", "k2_slots",
                                     "k4")) > 0
    assert launches["k5"] == launches["k1"] == sum(
        launches[f"k1_{i}"] for i in ("main", "resident", "stream"))
    assert launches["k4"] == launches["k3"]
    assert launches["k2"] == launches["k2_slots"]
    assert launches["k2_pairs"] == 0
    assert launches["k2_wide"] == 0
    assert launches["k1_stream"] == 0


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
            if mine and res and k >= start and k % CUT["sample_every"] == 0:
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


def _tamper_selection(monkeypatch, call=0):
    """In the ``call``-th stream (as ``_tamper_search``), select another
    variant, of another score, of the first match among the checked lines
    that has one: the language model's choice changed."""
    real = VariantModel.find_all_matches_stream
    calls = []

    def stream(self, *args, **kwargs):
        calls.append(None)
        mine = len(calls) - 1 == call
        for k, out in enumerate(real(self, *args, **kwargs)):
            for i, m in enumerate(out if mine and k < 32 else ()):
                other = [j for j, v in enumerate(m.variants or ())
                         if m.selected is not None and v.dist_score
                         != m.variants[m.selected].dist_score]
                if other:
                    out = list(out)
                    out[i] = m.shallow_copy()
                    out[i].selected = other[0]
                    mine = False
                    break
            yield out

    monkeypatch.setattr(VariantModel, "find_all_matches_stream", stream)


@pytest.mark.parametrize("cell,tamper,where,check", [
    ("query_synth120k", _tamper_query, {}, "gate query"),
    ("query_synth120k", _tamper_query, {"call": 1}, "gate w12"),
    ("query_synth120k", _tamper_query, {"call": 3, "start": 256 * 4},
     "timed windows"),
    ("search_synth120k", _tamper_search, {}, "gate search"),
    ("search_synth120k", _tamper_search, {"call": 7}, "timed passes"),
    ("search_lm", _tamper_selection, {"call": 7}, "timed passes"),
], ids=["query", "query_w12", "query_timed", "search", "search_timed",
        "search_lm_timed"])
def test_a_differing_result_aborts(cell, tamper, where, check, counted,
                                   cells, monkeypatch, capsys):
    """Timed results are tampered in the last of two rounds: the check
    holds every round."""
    tamper(monkeypatch, **where)
    with pytest.raises(SystemExit) as err:
        _bench(**{**SMALL, "ROUNDS": 2}).main(["--cell", cell] + cells
                                              + CPU)
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
    if rules == "search":
        cell = bench.read_cell("search_synth120k")
        ref = bench.Reference(ALPHABET, words, bench.scoring(cell))
        texts = synthetic_text(words, 5, 24)
        got = model.find_all_matches_batch(texts,
                                           bench.search_parameters(cell))
        assert [bench.match_signature(model, o) for o in got] == [
            ref.search(t) for t in texts]
        return
    cell = bench.read_cell("query_synth120k")
    ref = bench.Reference(ALPHABET, words, bench.scoring(cell))
    # ABSOLUTE: the cell's thresholds; RATIO: its W=12 gate's
    rule = cell.thresholds if rules == "ABSOLUTE" else cell.w12_thresholds
    base = [w for w in words if len(w) >= (9 if rules == "RATIO" else 1)]
    queries = bench.corrupted(base, 200, 5, rules, times=2)
    params = bench.search_parameters(cell, rule)
    want = [ref.lookup(q, rule) for q in queries]
    assert sum(len(w) for w in want) > 400
    assert [bench.as_tuples(model, model.find_variants(q, params))
            for q in queries] == want


@pytest.mark.parametrize("max_seq", [1, 5, 250])
def test_lm_reference_agrees_with_jax_and_the_port(max_seq, cells):
    """The script's language-model decode against the JAX package's
    ``find_all_matches`` with the same language model (host lookups) and
    the port's search on the CPU (its device path's plain versions), match
    lists exact, on a seeded 2,000-word lexicon, 400 bigrams and 64 lines
    that carry them. At ``max_seq`` 1 the decode keeps one path, so the
    language model changes no choice; deeper, it changes some."""
    from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
    from analiticcl_tpu_torch.testing import (
        ALPHABET, populate, synthetic_bigrams, synthetic_lexicon,
        synthetic_text,
    )
    from test_torch_slice import ref_populate, to_ref

    bench = _bench()
    words = synthetic_lexicon(11, 2000)
    bigrams = synthetic_bigrams(words, 12, 400)
    texts = synthetic_text(words, 13, 64, bigrams)
    cell = bench.read_cell("search_lm", cells[1])
    cell.max_seq = max_seq
    params = bench.search_parameters(cell)
    assert (params.max_seq, params.lm_weight, params.variantmodel_weight,
            params.contextrules_weight) == (max_seq, 1.0, 3.0, 1.0)
    ref = bench.Reference(ALPHABET, words, bench.scoring(cell), None, bigrams)
    want = [ref.search_decoded(t) for t in texts]
    flat = [matches for matches, _ in want]
    assert flat == [ref.search(t) for t in texts]
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                    bigrams=bigrams)
    jax = ref_populate(JaxModel(alphabet=ALPHABET), words, bigrams=bigrams)
    jax.set_backend("oracle")
    assert port.have_lm and jax.have_lm
    got = [bench.match_signature(port, o)
           for o in port.find_all_matches_stream(texts, params)]
    assert got == flat
    assert [bench.match_signature(jax, o) for o in
            jax.find_all_matches_batch(texts, to_ref(params))] == flat
    assert any(changed for _, changed in want) == (max_seq > 1)
    assert sum(m[3] is not None for line in flat for m in line) > 8 * 64


def test_nbest_paths_by_hand():
    """Equal costs keep the order of their source state, then of the arc,
    then of the source's hypothesis; the final states' paths go by cost,
    state and hypothesis; arcs of no symbol leave no step."""
    nbest = _bench().nbest_paths
    arcs = [[(1, 1.0, "a"), (1, 1.0, "b"), (2, 2.0, "c"), (1, 9.0, None)],
            [(2, 1.0, "d"), (2, 1.0, "e"), (2, 0.5, None)], []]
    ad, bd, ae, be = ([(x, 1), (y, 2)] for x, y in ("ad", "bd", "ae", "be"))
    assert nbest(arcs, [2], 9) == [
        (1.5, [("a", 1)]), (1.5, [("b", 1)]), (2.0, [("c", 2)]),
        (2.0, ad), (2.0, bd), (2.0, ae), (2.0, be), (9.5, []),
        (10.0, [("d", 2)])]
    assert nbest(arcs, [2], 4) == [
        (1.5, [("a", 1)]), (1.5, [("b", 1)]), (2.0, [("c", 2)]), (2.0, ad)]
    # each state keeps its own cheapest: state 1 holds a and b at nbest 2
    assert nbest(arcs, [1, 2], 3) == [
        (1.0, [("a", 1)]), (1.0, [("b", 1)]), (1.5, [("a", 1)])]
    assert nbest(arcs, [2], 1) == [(1.5, [("a", 1)])]


def test_perplexity_by_hand():
    """Each transition's log-probability: ln 1e-6 where the bigram is
    unknown or a token is out of the vocabulary, else the joint count's
    log, over the first token's own count where that is at least the joint
    count; the perplexity is their negative mean."""
    from analiticcl_tpu_torch.testing import ALPHABET

    bench = _bench()
    ref = bench.Reference(ALPHABET, ["ab", "cd"], {}, None, [
        ("ab cd", 7), ("cd ef", 2), ("ef", 4), ("ef ab", 1), ("ab cd", 3),
        ("ab gh", 5)])
    unseen = math.log(1e-6)
    assert unseen == bench.SMOOTHING == -13.815510557964274
    # "ab cd" keeps its largest frequency; "ef" is a word of the language
    # model alone, "gh" no word at all: UNK
    assert ref.ngrams == {("ab", "cd"): 7, ("cd", "ef"): 2, ("ef",): 4,
                          ("ef", "ab"): 1, ("ab", "<unk>"): 5}
    assert ref.perplexity(["<bos>", "ab", "cd", "ef", "<eos>"]) == (
        -1.0 / 4 * (unseen + math.log(7) + math.log(2) + unseen))
    assert ref.perplexity(["<bos>", "ef", "ab", None, "<eos>"]) == (
        -1.0 / 4 * (unseen + math.log(1 / 4) + unseen + unseen))
    assert ref.perplexity(["<bos>"]) == 0.0
    assert ref.tokens("ab cd gh") == ("ab", "cd", "<unk>")
    assert ref.tokens("ab ab ab ab ab ab") is None  # over five words
    with pytest.raises(ValueError, match="apart from the lexicon"):
        bench.Reference(ALPHABET, ["ab", "cd"], {}, None, [("cd", 1)])


@pytest.mark.parametrize("cell,changed,message", [
    ("query_synth120k", None, "a kernel was not launched"),
    ("query_synth120k", {"stage_a_masks": no_count},
     r"a kernel was not launched \(k1\)"),
    ("query_synth120k", {"query_planes": no_count},
     r"a kernel was not launched \(k5\)"),
    ("query_synth120k", {"resolve_pairs": no_count},
     r"a kernel was not launched \(k3\)"),
    ("query_synth120k", {"dl_lcs_slots": no_count},
     r"a kernel was not launched \(k2_slots\)"),
    ("query_synth120k", {"compact_survivors": no_count},
     r"a kernel was not launched \(k4\)"),
    ("query_synth120k", {"query_planes": count_every_other},
     "K5/K4 launches differ from K1/K3's"),
    ("query_synth120k", {"compact_survivors": count_every_other},
     "K5/K4 launches differ from K1/K3's"),
    ("query_synth120k", {"dl_lcs_slots": count_slots(wide_always=True)},
     "K2's wide path ran on an index of L <= 64"),
    ("search_synth120k", {"dl_lcs_slots": count_slots(wide_always=True)},
     "K2's wide path ran on an index of L <= 64"),
], ids=["none", "k1", "k5", "k3", "k2_slots", "k4", "k5_not_k1",
        "k4_not_k3", "wide_narrow", "wide_narrow_search"])
def test_no_launch_in_a_window_raises(cell, changed, message, cells,
                                      monkeypatch, capsys):
    """Without counting stand-ins the CPU path launches no kernel, and the
    first timed window says so; with them, a kernel that does not count
    its launch, K5 or K4 launched other than with K1 or K3, and K2's wide
    path on an index of L 21 each abort the run there with no metric."""
    if changed is not None:
        install(monkeypatch, **changed)
    bench = _bench(**{**SMALL, "ROUNDS": 1})
    where = "pass" if cell == "search_synth120k" else "window"
    with pytest.raises(RuntimeError, match=f"round 0 {where} 0: {message}"):
        bench.main(["--cell", cell] + cells + CPU)
    assert capsys.readouterr().out == ""


def test_launch_rules_by_hand():
    """``require_launches`` on counts given by hand: each rule alone."""
    bench = _bench()
    ok = {"k1": 4, "k1_main": 3, "k1_resident": 0, "k1_stream": 1, "k5": 4,
          "k3": 4, "k2": 4, "k2_slots": 4, "k2_pairs": 0, "k2_wide": 0,
          "k4": 4}
    assert bench.require_launches(ok, "w", wide=False) == ok
    # on a wide index the wide path's count is recorded, not held
    for k2_wide in (0, 3, 4):
        moved = {**ok, "k2_wide": k2_wide}
        assert bench.require_launches(moved, "w", wide=True) == moved
    for changed, message in [
        ({"k3": 0, "k4": 0}, r"not launched \(k3, k4\)"),
        ({"k4": 3}, "K5/K4 launches differ"),
        ({"k5": 5}, "K5/K4 launches differ"),
        ({"k1_main": 2}, "K1's instances do not add up"),
        ({"k2_wide": 1}, "wide path ran on an index of L <= 64"),
    ]:
        with pytest.raises(RuntimeError, match=f"^w: .*{message}"):
            bench.require_launches({**ok, **changed}, "w", wide=False)


@pytest.mark.parametrize("L,wide", [(21, False), (64, False), (65, True),
                                    (1000, True)])
def test_launch_rules_come_from_the_index(L, wide):
    """The rules read the built index's string width, not the cell."""
    model = SimpleNamespace(_device=SimpleNamespace(L=L))
    assert _bench().launch_rules(model) == {"wide": wide}


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "analiticcl_tpu",
                                  "analiticcl_tpu.ops.stage_a"])
def test_a_jax_module_in_the_run_raises(name, monkeypatch):
    """A module of JAX or of the JAX package loaded after the script
    (here, put into ``sys.modules``, whatever this process held under that
    name set aside until the test ends) makes ``require_no_jax`` raise;
    the port's own package and what the process held before do not."""
    bench = _bench()
    held = frozenset(bench.jax_modules(list(sys.modules))) - {name}
    monkeypatch.setattr(bench, "PRELOADED", held)
    monkeypatch.delitem(sys.modules, name, raising=False)
    bench.require_no_jax()
    monkeypatch.setitem(sys.modules, "analiticcl_tpu_torch_like",
                        ModuleType("analiticcl_tpu_torch_like"))
    bench.require_no_jax()
    monkeypatch.setitem(sys.modules, name, ModuleType(name))
    with pytest.raises(RuntimeError, match=f"loaded during the run: .*{name}"):
        bench.require_no_jax()
    assert bench.jax_modules(["analiticcl_tpu_torch", "analiticcl_tpu_torch."
                              "ops", "numpy", name]) == [name]


def test_jax_loaded_during_a_run_aborts_it(counted, cells, monkeypatch,
                                           capsys):
    """A whole run in which a dummy ``jax`` module appears (as an import
    the port pulled in would) ends with a non-zero exit and no metric."""
    bench = _bench(**{**SMALL, "ROUNDS": 1})
    held = frozenset(bench.jax_modules(list(sys.modules))) - {"jax"}
    monkeypatch.setattr(bench, "PRELOADED", held)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    real = bench.build_model

    def build_model(*args):
        monkeypatch.setitem(sys.modules, "jax", ModuleType("jax"))
        return real(*args)

    monkeypatch.setattr(bench, "build_model", build_model)
    with pytest.raises(RuntimeError, match="loaded during the run: jax"):
        bench.main(["--cell", "query_synth120k"] + cells + CPU)
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
    """``BENCHMARK.json``'s cells are the cells' files, each read as its
    mode wants, its parameters those the workload states."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in spec["workloads"]]
    assert names == ["query_synth120k", "search_synth120k"]
    bench_torch = _bench()
    assert sorted(names) == bench_torch.cell_names()
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert len(w["source"]) <= 200
        assert w["metric"]["bound_pct"] >= 5
        assert w["command"] == f"python3 bench_torch.py --cell {w['name']}"
        assert w["reduced"] == []
        cell = bench_torch.read_cell(w["name"])
        assert w["metric"]["name"] == f"{cell.mode}_throughput"
        assert f"bench_cells/{w['name']}.json" in w["parameters"]
        (anagram, k_ana), (edit, k_ed) = cell.thresholds
        assert (f"k_ana {anagram} {k_ana}, k_ed {edit} {k_ed}, max_matches "
                f"{cell.max_matches}, score_threshold "
                f"{cell.score_threshold}") in w["parameters"]
        assert f"{cell.lexicon_entries})" in w["source"]
        unit = "window" if cell.mode == "query" else "pass"
        # every kernel's launches beside the layers
        layers = {m["name"] for m in w["layer_metrics"]}
        assert {f"{k}_launches_per_{unit}" for k in (
            "k1", "k1_main", "k1_resident", "k1_stream", "k5", "k3", "k2",
            "k2_slots", "k2_pairs", "k2_wide", "k4")} < layers
        assert "host_oracle_fallback_count" in layers
    query, search = (bench_torch.read_cell(n) for n in names)
    assert (query.batch, query.window_queries, query.windows) == (
        4096, 65536, 9)
    # the two chip_smoke.core_shapes imports
    assert (bench_torch.BATCH, bench_torch.N_QUERIES) == (
        query.batch, query.window_queries)
    assert (search.max_ngram, search.lines, search.passes) == (2, 4096, 10)


@pytest.mark.parametrize("cell,change,message", [
    ("query_synth120k", {"mode": "learn"}, "mode 'learn'"),
    ("query_synth120k", {"lines": 64}, r"unknown \['lines'\]"),
    ("query_synth120k", {"batch": None}, r"missing \['batch'\]"),
    ("search_lm", {"bigrams": None}, r"missing \['bigrams'\]"),
    ("search_synth120k", {"lm_weight": 1.0}, r"unknown \['lm_weight'\]"),
], ids=["mode", "unknown_key", "missing_key", "lm_missing_key",
        "lm_key_without_lm"])
def test_a_cell_file_is_read_strictly(cell, change, message, tmp_path):
    """A cell's file with another mode, a key its mode does not take (the
    language model's in a search cell without one) or a key missing is
    refused, not run with a default."""
    bench = _bench()
    cut_cells(tmp_path / "cells")
    spec = json.loads((tmp_path / f"cells/{cell}.json").read_text())
    spec.update(change)
    spec = {k: v for k, v in spec.items() if v is not None}
    (tmp_path / "odd.json").write_text(json.dumps(spec))
    assert bench.cell_names(tmp_path) == ["odd"]
    with pytest.raises(ValueError, match=message):
        bench.read_cell("odd", tmp_path)


def test_an_unknown_cell_is_refused(cells, capsys):
    with pytest.raises(SystemExit):
        _bench().main(["--cell", "no_such_cell"] + cells + CPU)
    assert "no such cell" in capsys.readouterr().err


def test_kernel_build_covers_every_source(monkeypatch):
    """``build_kernels`` builds every ``csrc/*.cu`` before the model, at
    once, so no kernel builds inside a gate or a timed window; a build
    after it aborts the run."""
    from analiticcl_tpu_torch.ops import _build

    bench = _bench()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(bench.KERNEL_SOURCES) == sources == sorted(
        _build.SIGNATURES)
    loaded = []
    monkeypatch.setattr(_build, "load_all", lambda names: loaded.append(
        list(names)))
    monkeypatch.setattr(_build, "build_seconds", {"planes": 1.0})
    metrics = {}
    built = bench.build_kernels("cuda", metrics)
    assert sorted(loaded[0]) == sources and len(loaded) == 1
    assert metrics["kernel_build_s"][0] >= 0 and built == {"planes": 1.0}
    bench.require_no_build("cuda", built)
    _build.build_seconds["stage_a"] = 2.0
    with pytest.raises(RuntimeError, match=r"built after .*\['stage_a'\]"):
        bench.require_no_build("cuda", built)
    assert bench.build_kernels("cpu", {}) == {}


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
    cell = bench.read_cell("search_synth120k")
    ref = bench.Reference(ALPHABET, words, bench.scoring(cell))
    queries = [(q, rules) for rules in (
        cell.thresholds, bench.read_cell("query_synth120k").w12_thresholds)
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
