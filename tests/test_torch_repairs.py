"""Faults of the port, each pinned by a test on the CPU: the packaging of the
port's subpackages and native sources, ``new_with_alphabet(device=)``,
search matches that owned no variant list of their own, and query batches
with no cap on their stage-A hit bits (now split under
``DevicePipeline.max_hit_bits``, against the unsplit run and the JAX
package)."""

import tomllib
from pathlib import Path

import pytest
import torch

from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
    VariantResult,
)
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.ops.ranked import RankedResults
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
)
from test_pipeline import QUERIES
from test_torch_search import _fill_words, _pair, _params, signature
from test_torch_slice import _tuples, ref_populate, to_ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "analiticcl_tpu_torch"


def _setuptools():
    return tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]


def test_pyproject_lists_every_port_package():
    listed = set(_setuptools()["packages"])
    on_disk = {
        ".".join(p.parent.relative_to(REPO).parts)
        for p in PORT.rglob("__init__.py")
    }
    assert "analiticcl_tpu_torch.utils" in on_disk
    assert on_disk <= listed, sorted(on_disk - listed)


def test_pyproject_ships_the_port_sources():
    data = _setuptools()["package-data"]["analiticcl_tpu_torch"]
    shipped = {p for pat in data for p in PORT.glob(pat)}
    for name in ("native/ananorm.cpp", "native/fastemit.c", "native/Makefile",
                 "csrc/stage_a.cu", "csrc/dl_lcs.cu"):
        assert PORT / name in shipped, name
    # every native and kernel source that the build reads is shipped
    sources = {p for d in ("native", "csrc") for p in (PORT / d).iterdir()
               if p.suffix in (".c", ".cpp", ".cu") or p.name == "Makefile"}
    assert sources <= shipped, sorted(map(str, sources - shipped))


def test_new_with_alphabet_takes_the_device():
    words = synthetic_lexicon(seed=3, n=200)
    model = VariantModel.new_with_alphabet(ALPHABET, device="cpu")
    assert model.device.type == "cpu"
    populate(model, words)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
    )
    got = model.find_variants_batch([words[5] + "e", words[9]], params)
    assert got == [model._find_variants_oracle(q, params)
                   for q in (words[5] + "e", words[9])]
    assert isinstance(model._device, DevicePipeline)
    assert model._device.device.type == "cpu"


@pytest.mark.parametrize("fast", [True, False], ids=["array_native", "object"])
def test_matches_own_their_variant_lists(fast):
    """Matches of one looked-up segment get equal, not shared, lists."""
    port, ref = _pair(_fill_words)
    params = _params(max_ngram=1)
    texts = ["tires rihgt tires", "tires the tires"]
    want = signature(ref.find_all_matches_batch(texts, to_ref(params)))
    port.fast_consolidate = fast
    try:
        got = port.find_all_matches_batch(texts, params)
        assert signature(got) == want
        same = [m for out in got for m in out if m.text == "tires"]
        assert len(same) == 4 and all(m.variants for m in same)
        before = [list(m.variants) for m in same]
        same[0].variants.append(VariantResult(1, 0.5, 0.5, None))
        same[2].variants.clear()
        assert [m.variants for m in same[1:2] + same[3:]] == (
            before[1:2] + before[3:])
        # nothing cached behind the results saw the edits either
        assert signature(port.find_all_matches_batch(texts, params)) == want
    finally:
        port.fast_consolidate = True


@pytest.fixture(scope="module")
def split_models():
    words = synthetic_lexicon(seed=5, n=6000)
    freqs = synthetic_frequencies(9, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.set_backend("device")
    return port, ref, QUERIES + corrupt_queries(words, 13, 200)


@pytest.mark.parametrize("ranked", [False, True], ids=["plain", "ranked"])
def test_hit_bit_cap_splits_a_batch(split_models, monkeypatch, ranked):
    port, ref, queries = split_models
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    pipe = port._pipeline()
    whole = pipe.submit(queries, params)
    assert "args" in whole  # one W=3 batch under the default cap
    bits = whole["B"] * whole["nb_band"] * 1024
    unsplit = pipe.find_variants_batch(queries, params)

    calls = []
    real = DevicePipeline.submit
    monkeypatch.setattr(DevicePipeline, "submit",
                        lambda self, *a: calls.append(1) or real(self, *a))
    monkeypatch.setattr(pipe, "max_hit_bits", bits // 5)
    state = pipe.submit(queries, params)
    assert state.get("subs") is not None and len(calls) > 5
    assert len(state["subs"]) >= 5
    state["want_ranked"] = ranked
    got = pipe.collect(state)
    assert isinstance(got, RankedResults) == ranked
    got = [got[i] for i in range(len(queries))]
    assert got == unsplit
    want = _tuples(ref, ref.find_variants_batch(queries, to_ref(params)))
    assert _tuples(port, got) == want
    assert sum(map(len, got)) > len(queries)
