"""The port's fused query core against the JAX package's ``_query_core`` on
identical inputs.

A JAX ``DevicePipeline`` (CPU backend) over a seeded synthetic lexicon gives
the index arrays (``_idx``) and one submitted batch's query arguments; both
cores run on them as numpy arrays at equal pair budgets P and P2. The padded
survivor columns (fill slots included), the per-query frequency max and both
totals must be equal: every value is an integer, and the f32 pre-filter
score is computed in the same operation order. Budgets below the totals
truncate both cores' outputs query-major, and the truncations must agree.
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
    band_width,
    host_layout,
    index_tensors_from_model,
    index_tensors_from_numpy,
    plane_columns,
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


def _params(stop: str):
    return SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        stop_criterion=(StopCriterion.STOP_AT_EXACT_MATCH if stop != "exhaustive"
                        else StopCriterion.EXHAUSTIVE),
    )


def _both_cores(jax_model, words, stop: str, budgets):
    """One batch through the JAX core and the port's at the budgets
    ``budgets(total_match, total_keep)`` gives from the totals at
    P_BUDGET: (port outputs, JAX outputs, P, P2, B)."""
    # corrupted words and exact lexicon words (the latter have exact anagrams)
    queries = QUERIES + corrupt_queries(words, 11, 200) + words[:56]
    pipe = jpl.DevicePipeline(jax_model)
    st = pipe.submit(queries, to_ref(_params(stop)))
    assert "args" in st, "the batch must not split by window"
    have_freq = bool(jax_model.have_freq)

    def jax_core(P, P2):
        out = _jax_core(
            *pipe._idx, *st["args"], have_freq=have_freq, P=P, P2=P2,
            window=st["window"], nb_band=st["nb_band"],
            use_stop_exact=st["use_stop_exact"],
        )
        return [np.asarray(x) for x in out]

    full = jax_core(P_BUDGET, P_BUDGET)
    total_match, total_keep = int(full[8]), int(full[9])
    assert 0 < total_keep < total_match <= P_BUDGET
    P, P2 = budgets(total_match, total_keep)
    want = full if (P, P2) == (P_BUDGET, P_BUDGET) else jax_core(P, P2)

    index = index_tensors_from_numpy(*(np.asarray(x) for x in pipe._idx), "cpu",
                                     A=pipe.A)
    args = [torch.from_numpy(np.array(x)) for x in st["args"]]
    got = query_core(
        index, *args, have_freq=have_freq, P=P, P2=P2, window=st["window"],
        nb_band=st["nb_band"], use_stop_exact=st["use_stop_exact"],
        width=band_width(index.extents_host, st["args"][9], st["nb_band"]),
    )
    return got, want, P, P2, st["B"]


def _assert_outputs_equal(got, want, P2):
    names = ("o_q", "o_c", "o_ld", "o_lcs", "o_pf", "o_sf", "o_case")
    for name, g, w in zip(names, got[:7], want[:7]):
        assert g.shape == (P2,), name
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(got[7].numpy(), want[7].astype(np.int64))
    assert (int(got[8]), int(got[9])) == (int(want[8]), int(want[9]))


@pytest.mark.parametrize("stop", ["exhaustive", "stop_at_exact"])
def test_query_core_matches_jax(jax_model, words, stop):
    got, want, P, P2, B = _both_cores(
        jax_model, words, stop, lambda m, k: (P_BUDGET, P_BUDGET)
    )
    _assert_outputs_equal(got, want, P2)
    n = int(want[9])
    # both cores fill their unused survivor slots: query B, row 0, zeros
    assert (want[0][n:] == B).all() and not want[1][n:].any()


def test_index_layout_matches_jax(jax_model, words, freqs):
    """The port's own model and layout of the same lexicon equal the JAX
    pipeline's, its planes the JAX planes' columns in the port's
    threshold-major order (``plane_columns``), zero-padded to a multiple
    of 32; the JAX arrays carried over by ``index_tensors_from_numpy``
    give the same index, block extents included."""
    pipe = jpl.DevicePipeline(jax_model)
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    lay = host_layout(port)
    jbins = np.asarray(pipe._idx[0])
    np.testing.assert_array_equal(lay.bins,
                                  jbins[:, plane_columns(pipe.A, pipe.T)])
    ours = index_tensors_from_model(port, "cpu")
    theirs = index_tensors_from_numpy(*(np.asarray(x) for x in pipe._idx), "cpu",
                                      A=pipe.A)
    assert ours.at == theirs.at == pipe.A * pipe.T
    assert ours.bins.shape[1] % 32 == 0
    assert not ours.bins[:, ours.at:].any()
    for name in ours._fields:
        got, want = getattr(ours, name), getattr(theirs, name)
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(ours.extents.numpy(), ours.extents_host)
    np.testing.assert_array_equal(lay.canon_of, pipe._canon_of)
    np.testing.assert_array_equal(
        lay.freqs, np.asarray(pipe._idx[5]).astype(np.int64)
    )


@pytest.mark.parametrize("short", ["P", "P2"])
@pytest.mark.parametrize("stop", ["exhaustive", "stop_at_exact"])
def test_query_core_truncates_like_jax(jax_model, words, stop, short):
    """Budgets below the totals: the first P pairs are scored and the first
    P2 survivors kept, query-major, in both cores; the totals still count
    every hit (and every survivor among the P pairs), which is how
    ``collect`` sees the overflow."""
    def budgets(total_match, total_keep):
        if short == "P":
            return total_match // 2, P_BUDGET
        return P_BUDGET, total_keep // 2

    got, want, P, P2, B = _both_cores(jax_model, words, stop, budgets)
    _assert_outputs_equal(got, want, P2)
    total_match, total_keep = int(want[8]), int(want[9])
    if short == "P":
        assert total_match > P and (want[0] == B).any()
    else:
        assert total_keep > P2 and (want[0] < B).all()
