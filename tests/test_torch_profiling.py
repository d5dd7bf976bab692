"""The port's device profiling against the JAX package's.

* The ``stop_stage`` prefixes of ``query_core`` give the JAX
  ``_query_core``'s probes on identical inputs (``test_torch_query_core``'s
  batch: the seeded 7,000-word lexicon with and without frequencies,
  exhaustive and StopAtExactMatch) at equal P and P2, slots past the hit
  total included and budgets below the totals: every integer probe
  exactly, the f32 ``score`` sum within a relative 1e-5 (XLA and torch
  reduce in different orders). The stops the port has no stage for raise.
* ``utils.profiling``: ``trace``, ``profile_window`` and ``stop_ladder`` on
  the CPU.
* ``utils.roofline``: the counts against values worked out by hand.
* The three tools' ``main(argv)`` with ``--device cpu`` on a small seeded
  lexicon.
"""

import gc
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analiticcl_tpu.ops.pipeline as jpl
from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.convert import (
    band_width, block_columns, index_tensors_from_numpy,
)
from analiticcl_tpu_torch.ops.pipeline import (
    STOP_STAGES,
    probe,
    query_core,
    query_stage_a,
    query_stage_b,
)
from analiticcl_tpu_torch.testing import ALPHABET, corrupt_queries, populate
from analiticcl_tpu_torch.utils import roofline
from analiticcl_tpu_torch.utils.profiling import (
    LADDER,
    GcClock,
    profile_window,
    settled_batch,
    stop_ladder,
    trace,
)
from test_pipeline import QUERIES
from test_torch_query_core import (  # noqa: F401  (fixtures)
    P_BUDGET,
    _jax_core,
    _params,
    freqs,
    jax_model,
    words,
)
from test_torch_slice import to_ref

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
SCORE_RTOL = 1e-5


def jax_static(static: dict) -> dict:
    """The JAX core's static arguments: the port's but stage A's k
    width (the JAX core reads every plane column)."""
    return {k: v for k, v in static.items() if k != "width"}


@pytest.fixture(scope="module", params=["exhaustive", "stop_at_exact"])
def batch(request, jax_model, words):
    """One submitted JAX batch and its arguments for both cores, with its
    totals at P_BUDGET."""
    queries = QUERIES + corrupt_queries(words, 11, 200) + words[:56]
    pipe = jpl.DevicePipeline(jax_model)
    st = pipe.submit(queries, to_ref(_params(request.param)))
    assert "args" in st
    index = index_tensors_from_numpy(*(np.asarray(x) for x in pipe._idx), "cpu",
                                     A=pipe.A)
    args = [torch.from_numpy(np.array(x)) for x in st["args"]]
    static = dict(have_freq=bool(jax_model.have_freq), window=st["window"],
                  nb_band=st["nb_band"], use_stop_exact=st["use_stop_exact"],
                  width=band_width(index.extents_host, st["args"][9],
                                   st["nb_band"]))
    full = _jax_core(*pipe._idx, *st["args"], **jax_static(static), P=P_BUDGET,
                     P2=P_BUDGET)
    totals = int(full[8]), int(full[9])
    assert 0 < totals[1] < totals[0] <= P_BUDGET
    return pipe, st, index, args, static, totals


def _both(batch, stop, P, P2):
    pipe, st, index, args, static, _ = batch
    want = _jax_core(*pipe._idx, *st["args"], **jax_static(static), P=P, P2=P2,
                     stop_stage=stop)
    got = query_core(index, *args, **static, P=P, P2=P2, stop_stage=stop)
    return got, [np.asarray(w) for w in want]


def _assert_probes_equal(got, want, stop):
    assert len(got) == len(want), stop
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == () and w.shape == (), stop
        if stop == "score" and k == len(got) - 1:
            assert g.dtype == torch.float32
            np.testing.assert_allclose(float(g), float(w), rtol=SCORE_RTOL,
                                       err_msg=stop)
        else:
            assert g.dtype == torch.int32 and w.dtype == np.int32, stop
            assert int(g) == int(w), (stop, k)


@pytest.mark.parametrize("stop", STOP_STAGES)
def test_probes_match_jax(batch, stop):
    """At P = P2 = P_BUDGET, above both totals: the slots past the hit
    total are in every stage-B probe."""
    got, want = _both(batch, stop, P_BUDGET, P_BUDGET)
    _assert_probes_equal(got, want, stop)


@pytest.mark.parametrize("stop", STOP_STAGES[2:])
def test_probes_match_jax_below_the_totals(batch, stop):
    """Budgets below both totals: every slot holds a hit and the survivor
    slots are truncated query-major in both cores."""
    total_match, total_keep = batch[-1]
    got, want = _both(batch, stop, total_match // 2, total_keep // 4)
    _assert_probes_equal(got, want, stop)


def test_stop_stage_none_gives_the_outputs(batch):
    pipe, st, index, args, static, _ = batch
    want = _jax_core(*pipe._idx, *st["args"], **jax_static(static),
                     P=P_BUDGET,
                     P2=P_BUDGET)
    got = query_core(index, *args, **static, P=P_BUDGET, P2=P_BUDGET,
                     stop_stage=None)
    assert len(got) == 10
    for g, w in zip(got[:7], want[:7]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[7].numpy(),
                                  np.asarray(want[7]).astype(np.int64))
    assert [int(x) for x in got[8:]] == [int(x) for x in want[8:]]
    # the last prefix probes exactly these survivor columns
    compact = query_core(index, *args, **static, P=P_BUDGET, P2=P_BUDGET,
                         stop_stage="compact_sum")
    assert [int(x) for x in compact] == [int(x) for x in probe(*got[:7])]


@pytest.mark.parametrize("stop", ["resolve_pre", "resolve_tables", "full",
                                  "stage_a"])
def test_unported_and_unknown_stops_raise(batch, stop):
    _, _, index, args, static, _ = batch
    with pytest.raises(ValueError, match="resolve_pairs" if "resolve_" in stop
                       else "not one of"):
        query_core(index, *args, **static, P=2048, P2=2048, stop_stage=stop)


def test_stage_functions_take_only_their_own_stops(batch):
    _, _, index, args, static, _ = batch
    (q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len, stop_exact,
     start_blk, weights, thr) = args
    with pytest.raises(ValueError, match="not one of"):
        query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                      static["nb_band"], static["width"], stop_stage="resolve")
    sa = query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                       static["nb_band"], static["width"])
    with pytest.raises(ValueError, match="not one of"):
        query_stage_b(index, sa, stop_exact, q_norms, q_lens, q_fl, k_ed,
                      start_blk, weights, thr, have_freq=static["have_freq"],
                      P=2048, P2=2048, window=static["window"],
                      stop_stage="stageA")


@pytest.mark.parametrize("dtype", ["int32", "uint8", "bool", "int64"])
def test_probe_wraps_like_jax(dtype):
    """The checksum is ``jnp.sum(a.astype(jnp.int32))``: int32 wrap-around
    past 2**31, casts of narrow and wide types included."""
    rng = np.random.default_rng(5)
    if dtype == "bool":
        a = rng.random(1000) < 0.5
    elif dtype == "uint8":
        a = rng.integers(0, 256, size=(70, 33)).astype(np.uint8)
    else:
        a = rng.integers(0, 2**31 - 1, size=3000).astype(dtype)
    (got,) = probe(torch.from_numpy(a))
    want = np.asarray(jnp.sum(jnp.asarray(a).astype(jnp.int32)))
    assert got.dtype == torch.int32 and int(got) == int(want)
    if dtype in ("int32", "int64"):
        assert int(a.astype(np.int64).sum()) != int(want)  # it did wrap


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())


def test_trace_writes_one_chrome_trace(tmp_path):
    out = tmp_path / "tr"
    with trace(str(out)):
        (torch.arange(1000) * 3).sum()
    files = list(out.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("pause", [False, True], ids=["on", "paused"])
@pytest.mark.parametrize("enabled", [True, False], ids=["enabled", "disabled"])
def test_gc_clock_leaves_the_collector_as_it_found_it(pause, enabled):
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with GcClock(pause) as gcc:
            assert gc.isenabled() == (enabled and not pause)
            gc.collect()
        assert gc.isenabled() == enabled
        assert gcc.n >= 1 and gcc.ms >= 0
        assert gcc not in gc.callbacks
    finally:
        (gc.enable if was else gc.disable)()


def test_profile_window_on_the_cpu_measures_no_device():
    out, prof = profile_window(lambda: torch.arange(10).sum(), cuda=False)
    assert int(out) == 45
    assert prof.wall_ms > 0
    assert (prof.busy_ms, prof.n_ops, prof.idle_share) == (None, None, None)
    assert prof.n_by_name == {}


def test_stop_ladder_on_the_cpu(words):
    """The ladder over a batch settled by ``settled_batch`` on the port's
    own CPU pipeline: one rung per stop, only the host clock read, and the
    whole core's outputs and the ``compact_sum`` probes agree."""
    model = populate(VariantModel(alphabet=ALPHABET, device="cpu"),
                     words[:3000])
    pipe = model._pipeline()
    st, static = settled_batch(pipe, corrupt_queries(words[:3000], 4, 200),
                               _params("exhaustive"))
    assert (static["P"], static["P2"]) == pipe._budgets(st["B"])

    def call(stop):
        return query_core(pipe.index, *st["args"], **static, stop_stage=stop)

    rungs = stop_ladder(call, cuda=False)
    assert [r.stop for r in rungs] == [s or "full" for s in LADDER]
    assert all(r.enqueue_ms > 0 and r.event_ms is None and r.busy_ms is None
               and r.n_by_name is None for r in rungs)
    full = call(None)
    assert int(full[8]) > 0
    assert all(torch.equal(g, w) for g, w in zip(rungs[-1].out, full))
    assert [int(x) for x in rungs[-2].out] == [int(x) for x in probe(*full[:7])]


# ---- roofline counts ----

@pytest.mark.parametrize("at, ops, nbytes, ms", [
    # the main lexicon: 30 symbols x 7 count levels, padded to 224 columns
    # on the device; the padding's zero columns are not counted
    (210, 156_783_083_520, 131_909_648, 0.0792),
    # an alphabet whose planes are 224 columns wide
    (224, 167_235_289_088, 133_658_640, 0.0845),
    # a lexicon with a 1,000-letter entry (T 55; padded to 1,664) and one
    # whose planes are padded to 6,016 (T 200): still bound by operations
    (1650, 1_231_867_084_800, 311_805_968, 0.6225),
    (6000, 4_479_516_672_000, 855_242_768, 2.2635),
], ids=["AT210", "AT224", "AT1650", "AT6000"])
def test_k1_count_at_the_main_shape(at, ops, nbytes, ms):
    """B 4,096, band 91,136 rows (89 blocks of 1,024) of 120,832, four
    query tiles whose bands cover 118 blocks once; at AT 224 the count is
    1.67e11 operations."""
    start_blk = torch.tensor([0, 0, 29, 29], dtype=torch.int32)
    w = roofline.k1_work(at, 4096, start_blk, 89)
    assert w.int8_ops == 2 * 4096 * 91_136 * at == ops
    assert w.int32_ops == 0
    assert w.nbytes == (118 * 1024 * (at + 5) + 4096 * (at + 12) + 16
                        + 2 * 4096 * 11_392 + 4 * 712 * 4096 + 8 * 4096)
    assert w.nbytes == nbytes
    got, by = roofline.k1_bound_ms(at, 4096, start_blk, 89)
    assert by == "operations"
    assert got == pytest.approx(ops / 1.979e15 * 1e3)
    assert round(got, 4) == ms
    if at == 224:
        assert f"{w.int8_ops:.3g}" == "1.67e+11"


def test_k1_count_at_the_extents():
    """K1 at the band blocks' columns in use: per tile, 2 x bt x 1024 x
    columns operations for each block it reads; each distinct block's
    planes at its columns and each tile's queries' planes at the most
    columns of a block it reads; columns capped at the true width. On the
    main shape, every block at the full width, the count is the full-width
    one."""
    start_blk = torch.tensor([0, 0, 29, 29], dtype=torch.int32)
    full = roofline.k1_work(224, 4096, start_blk, 89)
    at_full = roofline.k1_work(224, 4096, start_blk, 89,
                               np.full(118, 224, np.int32))
    assert at_full == full
    # the main lexicon's 210 columns but a block of 1,664 (capped at AT
    # 1,650), and blocks of 93 below block 10
    ext = np.full(118, 210, np.int32)
    ext[:10] = 93
    ext[117] = 1664
    w = roofline.k1_work(1650, 4096, start_blk, 89, ext)
    per_tile = [ext[:89].astype(np.int64), ext[29:118].astype(np.int64)]
    per_tile[1][-1] = 1650
    assert w.int8_ops == 2 * 1024 * 1024 * 2 * sum(int(x.sum())
                                                    for x in per_tile)
    capped = np.minimum(ext, 1650).astype(np.int64)
    out = 16 + 2 * 4096 * 11_392 + 4 * 712 * 4096 + 8 * 4096
    assert w.nbytes == (1024 * int((capped + 5).sum())
                        + 2 * 1024 * (210 + 12) + 2 * 1024 * (1650 + 12)
                        + out)
    by_full = roofline.k1_bound_ms(1650, 4096, start_blk, 89)
    by_ext = roofline.k1_bound_ms(1650, 4096, start_blk, 89, columns=ext)
    assert by_ext[0] < by_full[0] / 5 and by_ext[1] == "operations"


def test_k2_and_glue_counts():
    a_len = torch.tensor([3, 0, 30], dtype=torch.int32)
    b_len = torch.tensor([4, 5, 2], dtype=torch.int32)
    w = roofline.k2_work(a_len, b_len, L=25, W=3)
    # 10 ops per banded DL cell (a_len * 9 cells), 2.5 per LCS cell (10 a
    # word of four packed runs); a_len clipped at L; the empty slot costs
    # its bytes only
    assert w.int32_ops == (10 * 3 * 9 + 2.5 * 3 * 4 + 10 * 25 * 9
                           + 2.5 * 25 * 2)
    assert w.int8_ops == 0
    assert w.nbytes == 3 * (8 * 25 + 16)
    assert roofline.k2_bound_ms(a_len, b_len, 25, 3)[1] == "bytes"
    # the slot entry at 100 slots whose three valid ones touch two query
    # rows and three candidate rows: the same operations, its own bytes
    # (the keep flag and five uint8 metrics a slot out, the weights and the
    # threshold in)
    s = roofline.k2_slots_work(a_len, b_len, P=100, L=25, W=3, norm_bytes=1,
                               n_queries=2, cand_rows=3)
    assert s.int32_ops == w.int32_ops
    assert s.nbytes == 100 * (9 + 6) + 2 * (25 + 9) + 3 * (25 + 5) + 28
    # with frequencies (read per candidate row, the B maxima written) and
    # under StopAtExactMatch (each slot's band row, the tested bytes of
    # exact bits and the B per-query flags read)
    s2 = roofline.k2_slots_work(a_len, b_len, P=100, L=25, W=3,
                                norm_bytes=1, n_queries=2, cand_rows=3, B=8,
                                have_freq=True, exact_bytes=3)
    assert s2.nbytes == s.nbytes + 3 * 8 + 8 * 8 + 100 * 4 + 3 + 8
    # the glue left between the kernels at B 8: the StopAtExactMatch
    # flags and exact counts in and the per-query flags out, the threshold
    # in and out, the frequency maxima's initial values out
    g = roofline.glue_work(B=8)
    assert g.nbytes == 8 * (1 + 4 + 1) + 4 + 4 + 8 * 8
    assert g.int8_ops == g.int32_ops == 0


def test_k4_and_k5_counts():
    """K4 at 1,000 slots (blocks of 128: 8 counts), 40 kept, 64 survivor
    slots, 8 queries: the counts and keep flags in, the kept slots' 13
    bytes in (all 40 fit), the maxima and the hit total in, the outputs
    out; at P2 16 only 16 kept slots are read. K5 at 8 queries of 30
    symbols, planes 210 wide: the counts in, the planes and the totals
    out."""
    w = roofline.k4_work(P=1000, P2=64, B=8, n_keep=40, block=128)
    assert w.nbytes == 8 * 4 + 1000 + 40 * 13 + 8 * 8 + 8 + (64 * 13 + 8 * 8
                                                             + 16)
    assert w.int8_ops == w.int32_ops == 0
    assert roofline.k4_work(1000, 16, 8, 40, 64).nbytes == (
        16 * 4 + 1000 + 16 * 13 + 72 + 16 * 13 + 80)
    assert roofline.k4_bound_ms(1000, 64, 8, 40, 128) == (
        pytest.approx(w.nbytes / 3.35e12 * 1e3), "bytes")
    k5 = roofline.k5_work(B=8, A=30, at=210)
    assert k5.nbytes == 8 * 30 * 4 + 8 * 210 + 8 * 8
    assert k5.int8_ops == k5.int32_ops == 0
    assert roofline.k5_bound_ms(8, 30, 210) == (
        pytest.approx(k5.nbytes / 3.35e12 * 1e3), "bytes")
    # at the wide planes' widths (A 30, T 55 and 200), B 4,096
    for at in (1650, 6000):
        wide = roofline.k5_work(B=4096, A=30, at=at)
        assert wide.nbytes == 4096 * (30 * 4 + at + 8)


def test_k3_counts_the_blocks_it_expands():
    """Two queries over three 128-row blocks: counts (query-major) 5, 0, 2
    and 0, 7, 1. At P 9 the blocks of the first slots 0, 5 and 7 reach a
    slot and the one starting at 14 does not."""
    counts_t = torch.tensor([[5, 0], [0, 7], [2, 1]], dtype=torch.int32)
    nmatch = torch.tensor([7, 8], dtype=torch.int32)
    start_blk = torch.tensor([0], dtype=torch.int32)
    w = roofline.k3_work(counts_t, nmatch, start_blk, P=9)
    assert w.nbytes == 2 * 4 + 4 + 6 * 4 + 3 * 16 + 9 * 13 + 8
    assert w.int8_ops == w.int32_ops == 0
    assert roofline.k3_work(counts_t, nmatch, start_blk, P=15).nbytes == \
        w.nbytes + 16 + 6 * 13
    assert roofline.k3_bound_ms(counts_t, nmatch, start_blk, 9) == (
        pytest.approx(w.nbytes / 3.35e12 * 1e3), "bytes")


def test_program_counts_its_inputs_and_outputs_only():
    """Eight queries (int32 counts over 30 symbols, one-byte strings of
    25), 2,048 band rows at AT 210, ten candidate rows with frequencies,
    64 survivor slots: nothing that passes between the stages counts, and
    the operations are K1's and K2's, each at its own rate."""
    args = [torch.zeros(8, 30, dtype=torch.int32),
            torch.zeros(8, 25, dtype=torch.int8),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(6, dtype=torch.float32)]
    k1 = roofline.Work(1e6, int8_ops=4e12)
    k2 = roofline.Work(1e6, int32_ops=1e11)
    w = roofline.program_work(args, at=210, rows=2048, cand_rows=10, L=25,
                              norm_bytes=1, have_freq=True, P2=64, k1=k1,
                              k2=k2)
    assert w.nbytes == (8 * 30 * 4 + 8 * 25 + 2 * 4 + 6 * 4 + 2048 * 215
                        + 10 * 38 + 64 * 13 + 8 * 8 + 16)
    assert (w.int8_ops, w.int32_ops) == (4e12, 1e11)
    # 2.021 ms for the int8 products, 5.979 ms for the 32-bit work at 64
    # operations per SM and clock (132 SMs, 1,980 MHz): the longer of the
    # two, since they run on different units
    ms, by = w.bound_ms()
    assert by == "operations"
    assert ms == pytest.approx(1e11 / (64 * 132 * 1980e6) * 1e3)
    assert roofline.Work(1e6, 4e12, 1e10).bound_ms() == (
        pytest.approx(4e12 / 1.979e15 * 1e3), "operations")
    assert roofline.Work(1e11, 4e12, 1e11).bound_ms() == (
        pytest.approx(1e11 / 3.35e12 * 1e3), "bytes")


def test_peaks_for_cards():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    # the data sheet's int8 and HBM rates; 32-bit integer work at 64
    # operations per SM and clock, 132 SMs at 1,980 MHz (not the FP32 data
    # sheet's 67 TFLOP/s, which counts an FMA as two)
    assert roofline.H100_SXM[1:] == (1.979e15, 3.35e12, 64 * 132 * 1980e6)
    assert roofline.H100_SXM.int32_ops_per_s == pytest.approx(16.727e12,
                                                              rel=1e-4)
    # derived from a card's SM count and maximum SM clock
    p = roofline.peaks_for("NVIDIA H100 80GB HBM3", sms=114,
                           sm_clock_mhz=1755)
    assert p[1:] == (1.979e15, 3.35e12, 64 * 114 * 1755e6)
    assert "114 SMs x 1755 MHz" in p.name
    assert roofline.int32_rate(132, 1980) == roofline.H100_SXM[3]
    # a given rate wins over the derived one
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3", int32=1e13, sms=114,
                              sm_clock_mhz=1755).int32_ops_per_s == 1e13
    with pytest.raises(ValueError, match="--peak-int8"):
        roofline.peaks_for("NVIDIA H100 PCIe")
    p = roofline.peaks_for("NVIDIA A100-SXM4-80GB", 1.248e15, 2.039e12,
                           19.5e12)
    assert p.hbm_bytes_per_s == 2.039e12
    p = roofline.peaks_for("NVIDIA A100-SXM4-80GB", 1.248e15, 2.039e12,
                           sms=108, sm_clock_mhz=1410)
    assert p.int32_ops_per_s == 64 * 108 * 1410e6


def test_batch_floor_counts_this_batch(batch):
    _, _, index, args, static, (total_match, total_keep) = batch
    f = roofline.batch_floor(index, args, **static, P=P_BUDGET, P2=P_BUDGET)
    assert f.n_valid == total_match
    assert 0 < f.cand_rows <= total_match
    assert f.k2_valid.int32_ops == f.k2_slots.int32_ops > 0
    (q_counts, q_cc, q_norms, q_lens, _qf, k_ana, _ke, k_len, _se,
     start_blk, _w, _thr) = args
    L = q_norms.shape[1]
    assert f.k2_valid.nbytes == total_match * (8 * L + 16)
    # the valid pairs by an enumeration of stage A's hit bits (all of them
    # fit in P_BUDGET): the query rows and candidate rows they touch
    sa = query_stage_a(index, q_counts, q_cc, k_ana, k_len, start_blk,
                       static["nb_band"], static["width"])
    hits = np.unpackbits(sa.packed_q.numpy(), axis=1, bitorder="little")
    q_ref, r_ref = np.nonzero(hits)
    assert len(q_ref) == total_match
    bt = q_counts.shape[0] // start_blk.shape[0]
    rows = start_blk.numpy().astype(np.int64)[q_ref // bt] * 128 + r_ref
    n_queries, cand_rows = len(np.unique(q_ref)), len(np.unique(rows))
    assert f.cand_rows == cand_rows
    # under StopAtExactMatch the bytes of exact bits the pairs test
    B = q_lens.shape[0]
    exact_bytes = (len(np.unique(q_ref * (hits.shape[1] // 8) + r_ref // 8))
                   if static["use_stop_exact"] else None)
    assert f.k2_slots == roofline.k2_slots_work(
        q_lens[torch.from_numpy(q_ref)], index.norm_lens[torch.from_numpy(rows)],
        P_BUDGET, L, static["window"], q_norms.element_size(), n_queries,
        cand_rows, B=B, have_freq=static["have_freq"],
        exact_bytes=exact_bytes)
    nb = q_norms.element_size()
    freq = 8 if static["have_freq"] else 0
    assert f.k2_slots.nbytes == (
        P_BUDGET * (9 + 6) + n_queries * (L * nb + 9)
        + cand_rows * (L * nb + 5 + freq) + freq * B + 28
        + (P_BUDGET * 4 + exact_bytes + B if exact_bytes is not None else 0))
    assert f.glue == roofline.glue_work(B)
    assert f.k3.nbytes > P_BUDGET * 13 and f.k3.int32_ops == 0
    # K5 on the batch's counts; K4 on its survivors (all fit in P_BUDGET)
    assert f.k5 == roofline.k5_work(B, q_counts.shape[1], index.at)
    assert f.k4 == roofline.k4_work(P_BUDGET, P_BUDGET, B, total_keep,
                                    128 if L <= 32 else 64)
    assert f.parts_ms == pytest.approx(
        f.ms("k5")[0] + f.ms("k1")[0] + f.ms("k3")[0] + f.ms("k2_slots")[0]
        + f.ms("k4")[0] + f.ms("glue")[0])
    assert f.program.int8_ops == f.k1.int8_ops > 0
    # K1 at the index's block columns: no more than at the full width
    assert f.k1 == roofline.k1_work(index.at, B, start_blk,
                                    static["nb_band"],
                                    block_columns(index.bins))
    assert f.k1_full == roofline.k1_work(index.at, B, start_blk,
                                         static["nb_band"])
    assert 0 < f.k1.int8_ops <= f.k1_full.int8_ops
    assert f.program.int32_ops == f.k2_valid.int32_ops
    # the program moves less than its parts: K1's bits and counts, the
    # slots and the metrics stay between its stages
    assert f.program.nbytes < (f.k5.nbytes + f.k1.nbytes + f.k3.nbytes
                               + f.k2_slots.nbytes + f.k4.nbytes
                               + f.glue.nbytes)
    assert f.program_ms == f.ms("program")[0] <= f.parts_ms


# ---- the tools, in this process, on the CPU ----

def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = ["--device", "cpu", "--n-lexicon", "3000", "--batch", "128"]


def test_profile_device_stages_tool(capsys):
    assert _tool("profile_device_stages_torch").main(SMALL) == 0
    out = capsys.readouterr().out
    assert "cpu run: no card" in out
    for stop in LADDER:
        assert f"\n{stop or 'full'}: " in out
    assert "not measured" in out


def test_profile_device_stages_tool_splits_the_kernels_ops():
    """A rung's device ops per call, each hand-written kernel's by a part
    of its device name (template instances summed), the rest as other."""
    tool = _tool("profile_device_stages_torch")
    split = tool._kernel_ops({
        "void stage_a_kernel<64>(...)": 1.0,
        "resolve_kernel(...)": 1.0,
        "void dl_lcs_slots_kernel<signed char, 3>(...)": 0.5,
        "void dl_lcs_slots_kernel<int, 3>(...)": 0.5,
        "void at::native::reduce_kernel<...>(...)": 4.0,
        "Memset (Device)": 2.0,
    })
    assert split == ("stage_a_kernel 1.0, resolve_kernel 1.0, "
                     "dl_lcs_slots_kernel 1.0, other 6.0")
    # a core call since K4 and K5: every kernel once, in the call's order
    split = tool._kernel_ops({
        "compact_kernel(...)": 1.0, "planes_kernel(...)": 1.0,
        "void stage_a_kernel<64>(...)": 1.0, "resolve_kernel(...)": 1.0,
        "void dl_lcs_slots_kernel<signed char, 3>(...)": 1.0,
        "Memcpy DtoH (Device -> Pinned)": 1.0,
    })
    assert split == ("planes_kernel 1.0, stage_a_kernel 1.0, "
                     "resolve_kernel 1.0, dl_lcs_slots_kernel 1.0, "
                     "compact_kernel 1.0, other 1.0")
    # the other ops that changed from the rung before, by name
    moved = tool._other_delta(
        {"resolve_kernel(...)": 1.0, "reduce_kernel<...>": 4.0,
         "Memset (Device)": 2.0, "fill_kernel": 1.0},
        {"reduce_kernel<...>": 2.0, "Memset (Device)": 2.0, "copy": 1.0})
    assert moved == "reduce_kernel<...> +2.0; copy -1.0; fill_kernel +1.0"
    assert tool._other_delta({"a": 1.0}, {"a": 1.0}) == "none"


@pytest.mark.parametrize("extra", [[], ["--mesh", "1x2"]],
                         ids=["single", "mesh"])
def test_profile_query_tool(capsys, tmp_path, extra):
    argv = SMALL + ["--batches", "2", "--trace", str(tmp_path)] + extra
    assert _tool("profile_query_torch").main(argv) == 0
    out = capsys.readouterr().out
    for label in ("streamed (depth 2)", "sequential (depth 0)",
                  "streamed profile"):
        assert label in out
    for stage in ("host_prep", "dispatch", "device", "device_get",
                  "host_tail"):
        assert f"{stage} " in out
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_profile_query_tool_learn(capsys):
    argv = SMALL + ["--learn", "--calls", "2", "--mesh", "2x1"]
    assert _tool("profile_query_torch").main(argv) == 0
    out = capsys.readouterr().out
    for k, state in enumerate(("on", "off", "on", "off")):
        assert f"learn call {k} (collector {state}):" in out
    assert "learn call 4 profile" in out


def test_roofline_tool(capsys):
    assert _tool("roofline_torch").main(SMALL) == 0
    out = capsys.readouterr().out
    for part in ("K1 (each band block at its columns):",
                 "K1 at the full width:",
                 "K3 (slot resolve):", "K2 at the valid pairs:",
                 "K2 at the P slots:", "glue:", "program floor",
                 "measured: not measured"):
        assert part in out


def test_tools_need_the_card_they_ask_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        _tool("roofline_torch").main(["--n-lexicon", "300", "--batch", "8"])
