"""The port's pair budgets and asynchronous submit/collect against the JAX
package's ``DevicePipeline`` on the CPU.

Both pipelines start at the smallest buckets on the CPU and run the same
escalation, top-bucket split and de-escalation, so with the buckets cut (on
each package's module, as ``tests/test_pipeline.py`` cuts the JAX ones) the
``(P, P2)`` budgets after every collected batch and every result tuple must
be equal. The slot resolve is also held against a plain enumeration of the
hit bits.
"""

import jax
import numpy as np
import pytest
import torch

import analiticcl_tpu.ops.pipeline as jpl
import analiticcl_tpu_torch.ops.pipeline as ppl
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu.parallel.mesh import ShardedPipeline as JaxSharded
from analiticcl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.ops.pipeline import (
    DevicePipeline,
    compact_index,
    resolve_pairs,
)
from analiticcl_tpu_torch.ops.stage_a import ROW_BLOCK, _b_tile
from analiticcl_tpu_torch.parallel.mesh import ShardedPipeline, make_mesh
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
)
from test_pipeline import QUERIES
from test_torch_slice import PARAMS, _tuples, ref_populate, to_ref

torch.set_num_threads(2)

# cut ladders: the test lexicon's batches cross several buckets
CUT_P = (256, 1024, 2048, 4096, 8192)
CUT_P2 = (128, 512, 1024, 2048)
# the top buckets of tests/test_pipeline.py's overflow test
TINY_P = (32, 64)
TINY_P2 = (16, 32)
# top buckets one query of the test lexicon passes alone
SINGLE_P = (8, 16)
SINGLE_P2 = (4, 8)


def cut_buckets(monkeypatch, p, p2):
    for mod in (jpl, ppl):
        monkeypatch.setattr(mod, "P_BUCKETS", p)
        monkeypatch.setattr(mod, "P2_BUCKETS", p2)


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=5, n=6000)


@pytest.fixture(scope="module")
def models(words):
    freqs = synthetic_frequencies(9, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    return port, ref


@pytest.fixture(scope="module")
def queries(words):
    return corrupt_queries(words, 13, 600)


def budgets(pipe):
    return dict(pipe._P_by_B), dict(pipe._P2_by_B)


def run_both(port_pipe, jax_pipe, batches, params, port, ref):
    """Each batch submitted and collected on both pipelines; the budgets
    after each batch and the result tuples must be equal. Returns the
    budgets after each batch."""
    seen = []
    for batch in batches:
        got = _tuples(port, port_pipe.collect(port_pipe.submit(batch, params)))
        want = _tuples(ref, jax_pipe.collect(jax_pipe.submit(
            batch, to_ref(params))))
        assert got == want
        assert budgets(port_pipe) == budgets(jax_pipe)
        seen.append(budgets(port_pipe))
    return seen


def test_cpu_pipeline_has_no_stream(models):
    pipe = DevicePipeline(models[0], "cpu")
    assert pipe.stream is None and not pipe._streams
    assert pipe._budgets(1024) == (ppl.P_BUCKETS[0], ppl.P2_BUCKETS[0])


def test_escalation_matches_jax(models, queries, monkeypatch):
    cut_buckets(monkeypatch, CUT_P, CUT_P2)
    port, ref = models
    params = PARAMS["absolute"]
    batches = [queries[:270], queries[:40], queries[:600], queries[:100],
               queries[300:570]]
    seen = run_both(DevicePipeline(port, "cpu"), jpl.DevicePipeline(ref),
                    batches, params, port, ref)
    # the 1,024-query bucket escalated past its first bucket, then went on
    # escalating with the larger batch
    assert seen[0][0][1024] > CUT_P[0] and seen[0][1][1024] > CUT_P2[0]
    assert seen[2][0][1024] > seen[0][0][1024]
    oracle = _tuples(port, [port._find_variants_oracle(q, params)
                            for q in queries[:40]])
    pipe = DevicePipeline(port, "cpu")
    assert _tuples(port, pipe.find_variants_batch(queries[:40], params)) \
        == oracle


def test_deescalation_matches_jax(models, queries, monkeypatch):
    """Budgets set at the top buckets step down after DEESC_N batches, on
    both pipelines alike, and the results stay equal to the oracle."""
    cut_buckets(monkeypatch, CUT_P, CUT_P2)
    port, ref = models
    params = PARAMS["absolute"]
    pipe, jpipe = DevicePipeline(port, "cpu"), jpl.DevicePipeline(ref)
    assert pipe.DEESC_N == jpipe.DEESC_N
    assert pipe.DEESC_MARGIN == jpipe.DEESC_MARGIN
    batch = queries[:270]
    run_both(pipe, jpipe, [batch], params, port, ref)
    for p in (pipe, jpipe):
        p._P_by_B[1024], p._P2_by_B[1024] = CUT_P[-1], CUT_P2[-1]
        p._deesc_reset(1024)
    seen = run_both(pipe, jpipe, [batch] * pipe.DEESC_N, params, port, ref)
    assert all(s[0][1024] == CUT_P[-1] for s in seen[:-1])
    assert seen[-1][0][1024] < CUT_P[-1] and seen[-1][1][1024] < CUT_P2[-1]
    oracle = _tuples(port, [port._find_variants_oracle(q, params)
                            for q in batch])
    assert _tuples(port, pipe.find_variants_batch(batch, params)) == oracle


def test_top_bucket_overflow_splits_not_truncates(models, queries,
                                                  monkeypatch):
    """Totals over the top buckets: the batch runs again in halves, down to
    single queries that take the oracle; no list is truncated."""
    cut_buckets(monkeypatch, TINY_P, TINY_P2)
    port, ref = models
    params = PARAMS["absolute"]
    batch = QUERIES + queries[:40]
    splits = []
    real = DevicePipeline._collect_split
    monkeypatch.setattr(DevicePipeline, "_collect_split",
                        lambda self, st: splits.append(1) or real(self, st))
    run_both(DevicePipeline(port, "cpu"), jpl.DevicePipeline(ref), [batch],
             params, port, ref)
    assert len(splits) > 3
    oracle = _tuples(port, [port._find_variants_oracle(q, params)
                            for q in batch])
    got = _tuples(port, DevicePipeline(port, "cpu").find_variants_batch(
        batch, params))
    assert got == oracle and sum(map(len, got)) > len(batch)


def test_single_query_over_top_bucket_takes_the_oracle(models, queries,
                                                       monkeypatch):
    port, ref = models
    params = PARAMS["absolute"]
    pipe = DevicePipeline(port, "cpu")
    hits = []
    for q in queries[:64]:
        pipe.candidates = 0
        pipe.find_variants_batch([q], params)
        hits.append(pipe.candidates)
    q = queries[int(np.argmax(hits))]
    assert max(hits) > SINGLE_P[-1]
    cut_buckets(monkeypatch, SINGLE_P, SINGLE_P2)
    calls = []
    real = type(port)._find_variants_oracle
    monkeypatch.setattr(type(port), "_find_variants_oracle",
                        lambda self, *a: calls.append(a[0]) or real(self, *a))
    run_both(DevicePipeline(port, "cpu"), jpl.DevicePipeline(ref), [[q]],
             params, port, ref)
    assert calls == [q]
    assert _tuples(port, [real(port, q, params)])[0]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stream_matches_batch(models, queries, depth, monkeypatch):
    """The stream keeps up to ``depth`` batches submitted ahead; batches
    escalate while others are in flight, and each is compared with the
    budgets it ran with."""
    cut_buckets(monkeypatch, CUT_P, CUT_P2)
    port, ref = models
    params = PARAMS["absolute"]
    batches = [queries[k:k + 150] for k in range(0, 600, 150)] + [QUERIES]
    want = [_tuples(port, DevicePipeline(port, "cpu").find_variants_batch(
        b, params)) for b in batches]
    pipe = DevicePipeline(port, "cpu")
    got = [_tuples(port, res) for res in pipe.find_variants_stream(
        iter(batches), params, depth=depth)]
    assert got == want
    jpipe = jpl.DevicePipeline(ref)
    assert [_tuples(ref, res) for res in jpipe.find_variants_stream(
        iter(batches), to_ref(params), depth=depth)] == want
    assert budgets(pipe) == budgets(jpipe)


def test_mesh_with_cut_buckets_matches_single_device(models, queries,
                                                     monkeypatch):
    """A 1x4 CPU mesh escalates per shard call, as the JAX mesh does, and
    equals the single-device pipeline and the oracle."""
    cut_buckets(monkeypatch, CUT_P, CUT_P2)
    port, ref = models
    params = PARAMS["absolute"]
    batches = [queries[:270], queries[270:600], QUERIES]
    mesh = ShardedPipeline(port, make_mesh(["cpu"] * 4))
    jmesh = JaxSharded(ref, jax_make_mesh(jax.devices()[:4], dp=1))
    seen = run_both(mesh, jmesh, batches, params, port, ref)
    assert seen[0][0][1024] > CUT_P[0]
    single = DevicePipeline(port, "cpu")
    for b in batches:
        assert _tuples(port, mesh.find_variants_batch(b, params)) == \
            _tuples(port, single.find_variants_batch(b, params))
    oracle = [port._find_variants_oracle(q, params) for q in QUERIES]
    assert _tuples(port, mesh.find_variants_batch(QUERIES, params)) == \
        _tuples(port, oracle)


def _random_stage_a(seed: int, B: int, nb_band: int, density: float):
    """Random hit bits with their per-128-row counts and totals, as stage A
    gives them, and a band start per query tile."""
    rng = np.random.default_rng(seed)
    Nb = nb_band * ROW_BLOCK
    hits = rng.random((B, Nb)) < density
    hits[rng.random(B) < 0.2] = False  # queries without hits
    packed = np.packbits(hits, axis=1, bitorder="little")
    counts_t = hits.reshape(B, Nb // 128, 128).sum(2).T.astype(np.int32)
    nmatch = hits.sum(1).astype(np.int32)
    Ni_pad = 4 * Nb
    bt = _b_tile(B, Ni_pad)
    start = rng.integers(0, Ni_pad // ROW_BLOCK - nb_band + 1, size=B // bt)
    return hits, tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        packed, counts_t, nmatch, start.astype(np.int32))), Ni_pad, bt


@pytest.mark.parametrize("budget", ["above", "below"])
@pytest.mark.parametrize("B,nb_band,density",
                         [(8, 1, 0.02), (64, 2, 0.005), (256, 1, 0.001)])
def test_resolve_pairs_enumerates_hits(B, nb_band, density, budget):
    """Slot p holds the (p + 1)-th hit in query-major, band-row order, as an
    enumeration of the bits gives it; slots past the total are invalid and
    still index inside the bits and the rows."""
    hits, (packed, counts_t, nmatch, start), Ni_pad, bt = _random_stage_a(
        B * nb_band, B, nb_band, density)
    q_ref, r_ref = np.nonzero(hits)
    total = len(q_ref)
    assert total > 16
    P = total + 37 if budget == "above" else total // 3
    q, pc_band, pc, valid, got_total = resolve_pairs(packed, counts_t, nmatch,
                                                     start, Ni_pad, P)
    n = min(P, total)
    assert int(got_total) == total == int(nmatch.sum())
    assert valid.numpy().tolist() == [True] * n + [False] * (P - n)
    np.testing.assert_array_equal(q[:n].numpy(), q_ref[:n])
    np.testing.assert_array_equal(pc_band[:n].numpy(), r_ref[:n])
    row0 = start.numpy().astype(np.int64)[q_ref[:n] // bt] * ROW_BLOCK
    np.testing.assert_array_equal(pc[:n].numpy(), row0 + r_ref[:n])
    assert (q < B).all() and (pc_band < nb_band * ROW_BLOCK).all()
    assert (pc < Ni_pad).all()


@pytest.mark.parametrize("P2", [1, 7, 50, 200])
def test_compact_slots_is_stable(P2):
    """The survivor compaction's positions (``compact_index``): slot j of
    P2 takes the (j + 1)-th set position of ``keep``, in order; the slots
    past the survivors take none."""
    rng = np.random.default_rng(P2)
    keep = rng.random(120) < 0.3
    idx, hit, n = compact_index(torch.from_numpy(keep), P2)
    want = np.nonzero(keep)[0][:P2]
    assert idx.shape == hit.shape == (P2,)
    np.testing.assert_array_equal(hit.numpy(), np.arange(P2) < len(want))
    np.testing.assert_array_equal(idx[hit].numpy(), want)
    assert int(idx.max()) < len(keep)
    assert int(n) == keep.sum()


def test_pack_round_trip():
    """The one-copy transfer layout: tensors of mixed dtypes and shapes
    (0-d included) come back equal, as aligned views of one byte tensor."""
    rng = np.random.default_rng(3)
    tensors = [
        torch.from_numpy(rng.integers(0, 9, size=(5, 7)).astype(np.int8)),
        torch.tensor(7, dtype=torch.int64),
        torch.from_numpy(rng.random(11) < 0.5),
        torch.from_numpy(rng.integers(-5, 5, size=13).astype(np.int32)),
        torch.tensor(0.25, dtype=torch.float32),
        torch.from_numpy(rng.integers(0, 2**40, size=3)),
    ]
    flat, layout = ppl._pack(tensors)
    assert flat.dtype == torch.uint8
    assert flat.numel() == sum(t.numel() * t.element_size() for t in tensors)
    back = ppl._unpack(flat.clone(), layout)
    for t, b in zip(tensors, back):
        assert b.dtype == t.dtype and b.shape == t.shape
        assert torch.equal(b, t)
