"""The port's lexicon sharding (``analiticcl_tpu_torch/parallel/mesh.py``) on
the CPU: meshes over repeated CPU devices against the JAX package's
``ShardedPipeline`` on ``conftest.py``'s 8 virtual CPU devices, the host
oracle and the port's single-device pipeline, with exact result tuples.

Under StopAtExactMatch the port's meshes equal the oracle while the JAX mesh
does not: it reads each shard's own exact-anagram count (ROADMAP F8)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu.parallel.mesh import ShardedPipeline as JaxSharded
from analiticcl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantModel,
)
from analiticcl_tpu_torch.convert import host_layout
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.parallel.mesh import (
    ShardedPipeline,
    get_sharded_pipeline,
    make_mesh,
)
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_bigrams,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
)
from test_pipeline import QUERIES
from test_torch_checkpoint import search_tuples
from test_torch_learn import snapshot
from test_torch_slice import PARAMS, REPO, _tuples, ref_populate, to_ref

torch.set_num_threads(2)

STOP = dataclasses.replace(
    PARAMS["absolute"], stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH
)
F8_WORDS = "dire fire dine hire wire dike tire mire sire diet edit tide".split()
F8_PARAMS = SearchParameters(
    max_anagram_distance=DistanceThreshold.absolute(2),
    max_edit_distance=DistanceThreshold.absolute(2),
    stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH,
)
LEARN_PARAMS = dataclasses.replace(PARAMS["absolute"], max_ngram=2)


def cpu_mesh(n_dp: int, n_lex: int):
    return make_mesh(["cpu"] * (n_dp * n_lex), dp=n_dp)


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=5, n=6000)


@pytest.fixture(scope="module")
def queries(words):
    return QUERIES + corrupt_queries(words, 13, 256)


@pytest.fixture(scope="module")
def models(words):
    """(port model, JAX model) per with_freq, built once."""
    cache = {}

    def get(with_freq: bool):
        if with_freq not in cache:
            freqs = synthetic_frequencies(9, len(words)) if with_freq else None
            cache[with_freq] = (
                populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                         freqs),
                ref_populate(JaxModel(alphabet=ALPHABET), words, freqs),
            )
        return cache[with_freq]

    return get


@pytest.fixture(scope="module")
def expected(models, queries):
    """Oracle and single-device results of the port per (params, with_freq),
    computed once."""
    cache = {}

    def get(name: str, params, with_freq: bool):
        key = (name, with_freq)
        if key not in cache:
            port = models(with_freq)[0]
            port.set_backend("auto")
            single = _tuples(port, port.find_variants_batch(queries, params))
            assert type(port._device) is DevicePipeline
            oracle = _tuples(
                port, [port._find_variants_oracle(q, params) for q in queries]
            )
            cache[key] = single, oracle
        return cache[key]

    return get


@pytest.mark.parametrize("with_freq", [False, True], ids=["nofreq", "freq"])
@pytest.mark.parametrize("kind", ["absolute", "ratio"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
def test_mesh_matches_jax_oracle_and_single_device(
    models, expected, queries, shape, kind, with_freq
):
    params = PARAMS[kind]
    port, ref = models(with_freq)
    single, oracle = expected(kind, params, with_freq)
    port.use_mesh(cpu_mesh(*shape))
    pipe = port._device
    assert isinstance(pipe, ShardedPipeline)
    assert pipe.mesh.shape == {"dp": shape[0], "lex": shape[1]}
    got = _tuples(port, port.find_variants_batch(queries, params))
    jax_pipe = JaxSharded(ref, jax_make_mesh(jax.devices(), dp=shape[0]))
    want = _tuples(ref, jax_pipe.find_variants_batch(queries, to_ref(params)))
    assert sum(map(len, got)) > len(queries)
    for q, g, w, o, s in zip(queries, got, want, oracle, single):
        assert g == w == o == s, q
    assert pipe.stats.counts["device"] >= (2 if kind == "ratio" else 1)


@pytest.mark.parametrize("stop", [False, True], ids=["exhaustive", "stop_exact"])
@pytest.mark.parametrize(
    "shape", [(1, 1), (1, 3), (2, 2), (4, 2), (3, 1)],
    ids=["1x1", "1x3", "2x2", "4x2", "3x1"],
)
def test_mesh_shapes_match_single_device(models, expected, queries, shape, stop):
    params = STOP if stop else PARAMS["absolute"]
    port = models(True)[0]
    single, oracle = expected("stop" if stop else "absolute", params, True)
    port.use_mesh(cpu_mesh(*shape))
    got = _tuples(port, port.find_variants_batch(queries, params))
    assert got == single == oracle
    pipe = port._device
    # the candidate and survivor counters are sums over the shards
    port.set_backend("auto")
    port.find_variants_batch(queries, params)
    assert (pipe.candidates, pipe.survivors) == (
        port._device.candidates, port._device.survivors
    )


@pytest.mark.parametrize("shape", [(2, 2), (1, 3)], ids=["2x2", "1x3"])
def test_mesh_memory_split(models, expected, queries, shape, monkeypatch):
    """A batch whose per-shard hit bits pass ``max_hit_bits`` splits into
    charcount-contiguous parts; the results do not change."""
    params = PARAMS["absolute"]
    port = models(False)[0]
    single, oracle = expected("absolute", params, False)
    monkeypatch.setattr(ShardedPipeline, "max_hit_bits", 1 << 17)
    port.use_mesh(cpu_mesh(*shape))
    got = _tuples(port, port.find_variants_batch(queries, params))
    assert got == single == oracle
    assert port._device.stats.counts["device"] > 2


@pytest.mark.parametrize("shape", [(1, 8), (1, 2)], ids=["1x8", "1x2"])
def test_stop_at_exact_match_across_shards(shape):
    """F8: a query whose exact anagram sits in one shard keeps only its
    exact pairs in every shard. The JAX mesh keeps the other shards' pairs
    within the edit threshold."""
    qs = ["ride", "tied", "dire", "fire"]
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), F8_WORDS)
    oracle = _tuples(port, [port._find_variants_oracle(q, F8_PARAMS) for q in qs])
    assert [[r[0] for r in res] for res in oracle[:2]] == [
        ["dire"], ["tide", "diet"]
    ]
    port.use_mesh(cpu_mesh(*shape))
    assert _tuples(port, port.find_variants_batch(qs, F8_PARAMS)) == oracle
    port.set_backend("device")
    assert _tuples(port, port.find_variants_batch(qs, F8_PARAMS)) == oracle

    ref = ref_populate(JaxModel(alphabet=ALPHABET), F8_WORDS)
    ref.use_mesh(jax_make_mesh(jax.devices()[: shape[1]], dp=1))
    jax_mesh = _tuples(ref, ref.find_variants_batch(qs, to_ref(F8_PARAMS)))
    assert jax_mesh[0] != oracle[0]
    assert len(jax_mesh[0]) > 1 and oracle[0][0] in jax_mesh[0]


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3", "2x2"])
def test_exact_counts_copied_on_their_shards_stream(
    models, expected, queries, shape, monkeypatch
):
    """F9: each shard's exact-anagram counts are copied to the mesh's device
    inside the ``_on`` context in which that shard's stage A made them. A
    copy between cards runs on the source card's current stream, so there
    it is the pipeline stream K1 wrote the counts on; outside it, the
    card's default stream, which is not ordered after K1. The CPU has no
    streams, so the contexts are recorded instead."""
    from analiticcl_tpu_torch.parallel import mesh as mesh_mod

    stack, copies = [], []
    real_on, real_stage_a = ShardedPipeline._on, mesh_mod.query_stage_a

    class Context:
        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            stack.append(self)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            stack.pop()
            return self.inner.__exit__(*exc)

    class Counts(torch.Tensor):
        """Records, at each ``.to``, the context it was made in and the
        context current at the copy."""

        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            if func is torch.Tensor.to:
                copies.append((args[0].made_in, stack[-1] if stack else None))
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **(kwargs or {}))

    def stage_a(*args, **kwargs):
        sa = real_stage_a(*args, **kwargs)
        nexact = sa.nexact.as_subclass(Counts)
        nexact.made_in = stack[-1] if stack else None
        return sa._replace(nexact=nexact)

    monkeypatch.setattr(ShardedPipeline, "_on",
                        lambda self, dev: Context(real_on(self, dev)))
    monkeypatch.setattr(mesh_mod, "query_stage_a", stage_a)
    port = models(True)[0]
    single, oracle = expected("stop", STOP, True)
    port.use_mesh(cpu_mesh(*shape))
    got = _tuples(port, port.find_variants_batch(queries, STOP))
    assert got == single == oracle
    n_shards = shape[0] * shape[1]
    assert len(copies) >= n_shards and len(copies) % n_shards == 0
    for made_in, copied_in in copies:
        assert made_in is not None
        assert copied_in is made_in


def test_shard_layout(words):
    """Rows dealt round-robin over the shards of a global charcount sort:
    each shard is charcount-sorted, ``_canon_of`` is shard-major, and a
    shard held by one device for several mesh rows is stored once."""
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)
    pipe = get_sharded_pipeline(port, cpu_mesh(2, 3))
    assert pipe.Ni_pad % (1024 * 3) == 0 and pipe.Ni_pad >= len(words)
    lay = host_layout(port, pad_unit=1024 * 3)
    glob = lay.canon_of
    for s in range(3):
        rows = pipe._canon_of[s * pipe.Ni_shard:(s + 1) * pipe.Ni_shard]
        assert np.array_equal(rows, glob[s::3])
        assert np.all(np.diff(pipe._cc_shard[s]) >= 0)
        idx = pipe.shard(1, s)
        assert idx is pipe.shard(0, s)
        assert np.array_equal(idx.cc.numpy(), lay.cc[s::3])
    assert len(pipe._copies) == 3
    assert pipe.index_bytes() * 3 >= pipe.Ni_pad * 200
    with pytest.raises(ValueError):
        host_layout(port, pad_unit=1000)


@pytest.mark.parametrize("shape", [(1, 3), (2, 2)], ids=["1x3", "2x2"])
def test_outlier_entry_over_mesh(words, shape):
    """A lexicon with one entry that holds a letter 50 times (planes 1,504
    wide; one block of one shard that wide, the rest within 224 columns):
    the mesh equals the single-device pipeline and the oracle, on queries
    near that entry and elsewhere, and each shard's band plan takes the
    widest extent its tiles read in that shard."""
    rng = np.random.default_rng(23)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    rep = "".join(rng.permutation(np.concatenate(
        [np.repeat("e", 50), rng.choice(letters[letters != "e"], 14)])))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"),
                    words[:2500] + [rep])
    params = PARAMS["absolute"]
    queries = (corrupt_queries([rep], 8, 6) + [rep]
               + corrupt_queries(words[:2500], 9, 40))
    single = _tuples(port, port.find_variants_batch(queries, params))
    oracle = _tuples(port, [port._find_variants_oracle(q, params)
                            for q in queries])
    port.use_mesh(cpu_mesh(*shape))
    pipe = port._device
    widths = [int(pipe.shard(0, s).extents_host.max())
              for s in range(shape[1])]
    assert max(widths) == 1504 and min(widths) <= 224
    got = _tuples(port, port.find_variants_batch(queries, params))
    assert got == single == oracle
    assert sum(any(t == rep for t, *_ in g) for g in got[:7]) >= 5
    st = pipe.prepare(queries[:7], params)
    assert st["width"].max() == 1504


@pytest.mark.parametrize("lm", [False, True], ids=["nolm", "lm"])
def test_search_over_mesh(words, lm):
    freqs = synthetic_frequencies(9, len(words))
    bigrams = synthetic_bigrams(words, 4, 400) if lm else None
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words,
                    freqs, bigrams)
    params = dataclasses.replace(LEARN_PARAMS, lm_weight=1.0,
                                 freq_weight=1.0 if lm else 0.0)
    texts = synthetic_text(words, 3, 24, bigrams) + ["", "zzqx vvkj"]
    single = search_tuples(port, list(port.find_all_matches_stream(texts, params)))
    port.use_mesh(cpu_mesh(2, 2))
    got = search_tuples(port, list(port.find_all_matches_stream(texts, params)))
    assert got == single
    assert port._device.stats.counts["device"] > 0
    assert sum(m[3] is not None for out in got for m in out) > 10 * len(texts)


@pytest.mark.parametrize("corpus", ["corrupted", "lexicon"])
def test_learn_over_mesh(words, corpus):
    """Strict learn on a 2x2 mesh equals the same learn on a single-device
    model: links and frequencies, then lookups. Over lexicon words the merge
    gives indexed entries VARIANT_OF links and refreshes the index in place
    (no structural build), so the mesh's variant flags must follow."""
    freqs = synthetic_frequencies(6, len(words))
    data = (corrupt_queries(words, 21, 192) if corpus == "corrupted"
            else words[:400:5])
    single = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    port.use_mesh(cpu_mesh(2, 2))
    pipe = port._device
    assert (port.learn_variants(data, LEARN_PARAMS, strict=True)
            == single.learn_variants(data, LEARN_PARAMS, strict=True) > 0)
    assert port.learn_profile["build_mode"] == "freq_refresh"
    assert port._device is pipe
    assert snapshot(port) == snapshot(single)
    flags = np.array([port.decoder[v].variants is not None
                      for v in port.index.vocab_ids])
    assert flags.any() and np.array_equal(pipe._has_variants, flags)
    linked = [port.decoder[v].text for v in port.index.vocab_ids[flags]]
    qs = linked[:64] + corrupt_queries(linked, 8, 64)
    got = _tuples(port, port.find_variants_batch(qs, LEARN_PARAMS))
    assert got == _tuples(single, single.find_variants_batch(qs, LEARN_PARAMS))
    assert got == _tuples(
        port, [port._find_variants_oracle(q, LEARN_PARAMS) for q in qs]
    )
    assert sum(r[3] is not None for res in got for r in res) > 0
    port.build()
    assert port._device is None  # a build drops the mesh


def test_checkpoint_from_mesh_model_reshards(words, queries, tmp_path):
    params = PARAMS["absolute"]
    freqs = synthetic_frequencies(9, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    port.use_mesh(cpu_mesh(2, 2))
    port.learn_variants(corrupt_queries(words, 3, 128), LEARN_PARAMS,
                        strict=True)
    want = _tuples(port, port.find_variants_batch(queries, params))
    path = str(tmp_path / "mesh.npz")
    port.save(path)
    back = VariantModel.load(path, device="cpu")
    back.use_mesh(cpu_mesh(4, 2))
    assert back._device.mesh.shape == {"dp": 4, "lex": 2}
    assert _tuples(back, back.find_variants_batch(queries, params)) == want


def test_jax_checkpoint_on_port_mesh(words, queries, tmp_path):
    params = PARAMS["ratio"]
    freqs = synthetic_frequencies(9, len(words))
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.use_mesh(dp=2)
    want = _tuples(ref, ref.find_variants_batch(queries, to_ref(params)))
    path = str(tmp_path / "jax.npz")
    ref.save(path)
    port = VariantModel.load(path, device="cpu")
    port.use_mesh(cpu_mesh(2, 4))
    assert _tuples(port, port.find_variants_batch(queries, params)) == want


def test_mesh_errors(words):
    port = VariantModel(alphabet=ALPHABET, device="cpu")
    with pytest.raises(RuntimeError, match="build"):
        port.use_mesh(cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="dp=2"):
        make_mesh(["cpu"] * 3, dp=2)
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError):
        make_mesh(["meta"])
    if not torch.cuda.is_available():  # no CPU fallback for a CUDA mesh
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(["cuda:0"] * 2)
        populate(port, words[:100])
        with pytest.raises(RuntimeError):
            port.use_mesh()
        assert port._device is None


def test_initialize_distributed_then_mesh_query():
    """``initialize_distributed`` passes its arguments to
    ``torch.distributed.init_process_group`` (gloo, one process, a TCP
    rendezvous on localhost); a mesh query runs inside the group."""
    script = textwrap.dedent(
        """
        import socket
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        import analiticcl_tpu_torch as at
        from analiticcl_tpu_torch.parallel.mesh import (
            initialize_distributed, make_mesh,
        )
        from analiticcl_tpu_torch.testing import (
            ALPHABET, corrupt_queries, populate, synthetic_lexicon,
        )
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        initialize_distributed(backend="gloo", world_size=1, rank=0,
                               init_method=f"tcp://localhost:{port}")
        assert dist.is_initialized() and dist.get_world_size() == 1
        words = synthetic_lexicon(seed=2, n=300)
        model = populate(at.VariantModel(alphabet=ALPHABET, device="cpu"),
                         words)
        model.use_mesh(make_mesh(["cpu"] * 4, dp=2))
        params = at.SearchParameters(
            max_anagram_distance=at.DistanceThreshold.absolute(3),
            max_edit_distance=at.DistanceThreshold.absolute(2),
        )
        qs = corrupt_queries(words, 3, 24)
        got = model.find_variants_batch(qs, params)
        assert got == [model._find_variants_oracle(q, params) for q in qs]
        assert sum(map(len, got)) > 0
        dist.destroy_process_group()
        assert not dist.is_initialized()
        print("ok")
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
