"""The port's fused query core against the JAX package's ``_query_core`` on
identical inputs.

A JAX ``DevicePipeline`` (CPU backend) over a seeded synthetic lexicon gives
the index arrays (``_idx``) and one submitted batch's query arguments; both
cores run on them as numpy arrays. Survivor columns, the per-query frequency
max and both totals must be equal: every value is an integer, and the f32
pre-filter score is computed in the same operation order.
"""

import jax
import numpy as np
import pytest
import torch

import analiticcl_tpu.ops.pipeline as jpl
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantModel,
)
from analiticcl_tpu_torch.convert import (
    host_layout,
    index_tensors_from_model,
    index_tensors_from_numpy,
)
from analiticcl_tpu_torch.ops.pipeline import query_core
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
)
from test_pipeline import QUERIES
from test_torch_slice import ref_populate, to_ref

torch.set_num_threads(2)

P_BUDGET = 16384  # above every case's pair total (asserted)
_jax_core = jax.jit(
    jpl._query_core,
    static_argnames=("have_freq", "P", "P2", "window", "nb_band",
                     "use_stop_exact", "stop_stage"),
)


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=7, n=7000)


@pytest.fixture(scope="module", params=[False, True], ids=["nofreq", "freq"])
def freqs(request, words):
    return synthetic_frequencies(3, len(words)) if request.param else None


@pytest.fixture(scope="module")
def jax_model(words, freqs):
    return ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)


@pytest.mark.parametrize("stop", ["exhaustive", "stop_at_exact"])
def test_query_core_matches_jax(jax_model, words, stop):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        stop_criterion=(StopCriterion.STOP_AT_EXACT_MATCH if stop != "exhaustive"
                        else StopCriterion.EXHAUSTIVE),
    )
    # corrupted words and exact lexicon words (the latter have exact anagrams)
    queries = QUERIES + corrupt_queries(words, 11, 200) + words[:56]
    pipe = jpl.DevicePipeline(jax_model)
    st = pipe.submit(queries, to_ref(params))
    assert "args" in st, "the batch must not split by window"
    have_freq = bool(jax_model.have_freq)
    want = _jax_core(
        *pipe._idx, *st["args"], have_freq=have_freq, P=P_BUDGET,
        P2=P_BUDGET, window=st["window"], nb_band=st["nb_band"],
        use_stop_exact=st["use_stop_exact"],
    )
    want = [np.asarray(x) for x in want]
    total_match, total_keep = int(want[8]), int(want[9])
    assert 0 < total_keep < total_match <= P_BUDGET

    index = index_tensors_from_numpy(*(np.asarray(x) for x in pipe._idx), "cpu")
    args = [torch.from_numpy(np.array(x)) for x in st["args"]]
    got = query_core(
        index, *args, have_freq=have_freq, window=st["window"],
        nb_band=st["nb_band"], use_stop_exact=st["use_stop_exact"],
    )
    assert int(got[8]) == total_match
    assert int(got[9]) == total_keep
    n = total_keep
    names = ("o_q", "o_c", "o_ld", "o_lcs", "o_pf", "o_sf", "o_case")
    for name, g, w in zip(names, got[:7], want[:7]):
        assert g.shape == (n,), name
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w[:n], err_msg=name)
    # the JAX core fills its unused survivor slots: query B, row 0
    assert (want[0][n:] == st["B"]).all()
    np.testing.assert_array_equal(got[7].numpy(), want[7].astype(np.int64))


def test_index_layout_matches_jax(jax_model, words, freqs):
    """The port's own model and layout of the same lexicon equal the JAX
    pipeline's, and its planes are zero-padded to a multiple of 32."""
    pipe = jpl.DevicePipeline(jax_model)
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    lay = host_layout(port)
    ours = index_tensors_from_model(port, "cpu")
    theirs = index_tensors_from_numpy(*(np.asarray(x) for x in pipe._idx), "cpu")
    assert ours.at == theirs.at == pipe.A * pipe.T
    assert ours.bins.shape[1] % 32 == 0
    assert not ours.bins[:, ours.at:].any()
    for name in ours._fields[:-1]:
        assert torch.equal(getattr(ours, name), getattr(theirs, name)), name
    np.testing.assert_array_equal(lay.canon_of, pipe._canon_of)
    np.testing.assert_array_equal(
        lay.freqs, np.asarray(pipe._idx[5]).astype(np.int64)
    )
