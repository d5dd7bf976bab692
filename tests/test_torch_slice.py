"""The port's query path end to end on the CPU: ``analiticcl_tpu_torch``'s
VariantModel against the JAX package's device backend and the host oracle,
with exact result tuples (text, dist_score, freq_score, via); and the port's
promise never to load JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu.types import DistanceThreshold, SearchParameters
from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.device import resolve_device
from analiticcl_tpu_torch.ops.dl import dl_lcs
from analiticcl_tpu_torch.ops.stage_a import stage_a_masks
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
)
from test_pipeline import QUERIES

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {
    "absolute": SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    ),
    # ratio thresholds reach the W=6 and W=12 windows and the window split
    "ratio": SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_with_limit(0.5, 6),
        max_edit_distance=DistanceThreshold.ratio_with_limit(0.5, 12),
        max_matches=10,
        score_threshold=0.25,
    ),
}


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=5, n=6000)


@pytest.fixture(scope="module")
def queries(words):
    return QUERIES + corrupt_queries(words, 13, 256)


def _tuples(model, results):
    return [
        [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
         for r in res]
        for res in results
    ]


@pytest.mark.parametrize("with_freq", [False, True], ids=["nofreq", "freq"])
@pytest.mark.parametrize("kind", ["absolute", "ratio"])
def test_port_matches_jax_and_oracle(words, queries, kind, with_freq):
    params = PARAMS[kind]
    freqs = synthetic_frequencies(9, len(words)) if with_freq else None
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    ref = populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.set_backend("device")
    got = _tuples(port, port.find_variants_batch(queries, params))
    streamed = _tuples(
        port, list(port.find_variants_stream(queries, params, batch_size=100))
    )
    want = _tuples(ref, ref.find_variants_batch(queries, params))
    oracle = _tuples(port, [port._find_variants_oracle(q, params) for q in queries])
    assert sum(map(len, got)) > len(queries)
    for q, g, s, w, o in zip(queries, got, streamed, want, oracle):
        assert g == s == w == o, q
    if kind == "ratio":
        lens = port.enc.normalize_batch_padded(queries, port._device.L)[1]
        assert (lens >= 14).any() and (lens < 7).any()  # W=12 and W=3 groups


def test_small_lexicon_takes_the_oracle(words):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words[:40])
    res = port.find_variants_batch(["abc", words[3]], PARAMS["absolute"])
    assert port._device is None
    assert res == [port._find_variants_oracle(q, PARAMS["absolute"])
                   for q in ["abc", words[3]]]


def test_refresh_freqs_matches_rebuild(words):
    params = PARAMS["absolute"]
    freqs = synthetic_frequencies(1, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    qs = corrupt_queries(words, 2, 64)
    port.find_variants_batch(qs, params)
    new = synthetic_frequencies(2, len(words))
    for i, w in enumerate(words):
        port.decoder[port.encoder[w]].frequency = int(new[i])
    idx = port.index
    idx.freqs = np.array(
        [port.decoder[v].frequency for v in idx.vocab_ids], dtype=np.float64
    )
    port._device.refresh_freqs(idx.freqs)
    fresh = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, new)
    assert _tuples(port, port.find_variants_batch(qs, params)) == _tuples(
        fresh, fresh.find_variants_batch(qs, params)
    )


def test_explicit_device_and_no_fallback():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            VariantModel(alphabet=ALPHABET)  # the default device is "cuda"


def test_cpu_run_launches_no_kernel(words, queries):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)
    before = (stage_a_masks.launches, dl_lcs.launches)
    port.find_variants_batch(queries[:32], PARAMS["absolute"])
    assert (stage_a_masks.launches, dl_lcs.launches) == before


def test_use_mesh_is_not_ported(words):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words[:100])
    with pytest.raises(NotImplementedError, match="ROADMAP P10"):
        port.use_mesh()
    assert port._device is None


def test_port_never_imports_jax():
    """Query, search (with and without an LM, batch and stream) and learn
    (strict and not), each on a fresh model, load no JAX module."""
    script = textwrap.dedent(
        """
        import sys
        import torch
        torch.set_num_threads(1)
        import analiticcl_tpu_torch as at
        from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
        from analiticcl_tpu_torch.testing import (
            ALPHABET, populate, synthetic_bigrams, synthetic_lexicon,
            synthetic_text,
        )
        words = synthetic_lexicon(seed=1, n=300)
        texts = synthetic_text(words, 2, 6)
        bigrams = synthetic_bigrams(words, 3, 50)

        def fresh(lm=False):
            return populate(at.VariantModel(alphabet=ALPHABET, device="cpu"),
                            words, bigrams=bigrams if lm else None)

        params = at.SearchParameters(
            max_anagram_distance=at.DistanceThreshold.absolute(3),
            max_edit_distance=at.DistanceThreshold.absolute(2),
        )
        model = fresh()
        res = model.find_variants_batch([words[0][:-1] + "x"], params)
        res += list(model.find_variants_stream([words[1]], params))
        assert res[1], res
        models = [model]
        model = fresh()
        assert model.find_all_matches(texts[0], params)
        models.append(model)
        model = fresh(lm=True)
        assert model.have_lm
        assert model.find_all_matches(texts[1], params)
        models.append(model)
        model = fresh(lm=True)
        assert len(list(model.find_all_matches_stream(texts, params))) == 6
        models.append(model)
        for strict in (True, False):
            model = fresh()
            assert model.learn_variants(texts if not strict else
                                        [w + "e" for w in words[:40]],
                                        params, strict=strict) > 0
            models.append(model)
        for m in models:
            assert isinstance(m._device, DevicePipeline), m._device
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
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
