"""The port's stage A (analiticcl_tpu_torch/ops/stage_a.py) against the JAX
package's ``stage_a_masks_xla``, bit for bit, across query tiles and band
starts; and the port's banded pipeline against the host oracle with a forced
small query tile (as test_banding.py does for the JAX pipeline)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analiticcl_tpu.ops.pipeline as jpl
import analiticcl_tpu.ops.stage_a as jsa
import analiticcl_tpu_torch.ops.stage_a as tsa
from analiticcl_tpu.types import DistanceThreshold, SearchParameters
from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
from analiticcl_tpu_torch.testing import populate
from fixtures import TEST_ALPHABET, get_test_searchparams
from test_banding import _mixed_model, _tuples

torch.set_num_threads(2)


def _inputs(seed, Ni, A, T, B, nb_band, n_pad_rows=100):
    """Charcount-sorted random planes; the last rows are padding."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, T + 1, size=(Ni, A)) * (rng.random((Ni, A)) < 0.25)
    cc = counts.sum(1).astype(np.int32)
    order = np.argsort(cc, kind="stable")
    counts, cc = counts[order], cc[order]
    levels = np.arange(T)[None, None, :]
    bins = (counts[:, :, None] > levels).reshape(Ni, A * T).astype(np.int8)
    valid = np.arange(Ni) < Ni - n_pad_rows
    bins[~valid] = 0
    cc[~valid] = 1 << 28
    qc = rng.integers(0, T + 1, size=(B, A)) * (rng.random((B, A)) < 0.25)
    qbin = (qc[:, :, None] > levels).reshape(B, A * T).astype(np.int8)
    q_cc = qc.sum(1).astype(np.int32)
    k_ana = rng.integers(0, 5, size=B).astype(np.int32)
    k_ana[-3:] = -1  # padding queries
    k_len = np.minimum(k_ana, rng.integers(0, 4, size=B)).astype(np.int32)
    k_len[-3:] = -1
    # a few exact anagrams of indexed rows, so exact bits are exercised
    for q in range(0, B, 7):
        r = int(rng.integers(Ni - n_pad_rows))
        qbin[q], q_cc[q] = bins[r], cc[r]
    M = Ni // tsa.ROW_BLOCK
    bt = tsa._b_tile(B, Ni)
    start = rng.integers(0, M - nb_band + 1, size=B // bt).astype(np.int32)
    return bins, cc, valid, qbin, q_cc, k_ana, k_len, start


def _compare(args, nb_band, pad_to=None):
    want = jsa.stage_a_masks_xla(*map(jnp.asarray, args), nb_band)
    targs = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    if pad_to is not None:  # zero plane columns change no dot product
        extra = pad_to - targs[0].shape[1]
        targs[0] = torch.nn.functional.pad(targs[0], (0, extra))
        targs[3] = torch.nn.functional.pad(targs[3], (0, extra))
    got = tsa.stage_a_masks(*targs, nb_band)
    names = ("packed_q", "exact_q", "counts_t", "nmatch", "nexact")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return got


@pytest.mark.parametrize(
    "b_tile,B,nb_band",
    [(1024, 64, 2), (16, 64, 1), (8, 32, 3), (32, 128, 2)],
)
def test_plain_matches_xla(monkeypatch, b_tile, B, nb_band):
    monkeypatch.setattr(jsa, "B_TILE", b_tile)
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    args = _inputs(b_tile + B, Ni=4096, A=9, T=3, B=B, nb_band=nb_band)
    got = _compare(args, nb_band)
    assert int(got[3].sum()) > 0 and int(got[4].sum()) > 0


def test_zero_padded_planes_are_exact(monkeypatch):
    monkeypatch.setattr(jsa, "B_TILE", 16)
    monkeypatch.setattr(tsa, "B_TILE", 16)
    args = _inputs(5, Ni=3072, A=9, T=3, B=64, nb_band=2)
    _compare(args, 2, pad_to=32)


def test_kernel_inputs_are_checked():
    args = _inputs(1, Ni=2048, A=4, T=4, B=8, nb_band=1)
    targs = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    with pytest.raises(ValueError):
        tsa.stage_a_masks(*targs, 3)  # band wider than the index
    targs[1] = targs[1].to(torch.int64)
    with pytest.raises(ValueError):
        tsa.stage_a_masks(*targs, 1)


def _port_mixed_model():
    jm = _mixed_model()
    words = [jm.decoder[i].text for i in range(3, len(jm.decoder))]
    return populate(VariantModel(alphabet=TEST_ALPHABET, device="cpu"), words)


@pytest.mark.parametrize("b_tile", [8, 1024])
def test_banded_pipeline_matches_oracle(monkeypatch, b_tile):
    monkeypatch.setattr(jsa, "B_TILE", b_tile)
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    model = _port_mixed_model()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(2),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.0,
    )
    queries = [
        "cat", "dogg", "sn", "windwo", "bottel", "gadren",
        "extraordinry", "misunderstnad", "architectual", "pilow",
        "carpets", "aproximately", "xy", "uncharacteristicaly",
        "pens", "suns",
    ]
    device = DevicePipeline(model, "cpu").find_variants_batch(queries, params)
    jax_dev = jpl.DevicePipeline(model).find_variants_batch(queries, params)
    for q, d, j in zip(queries, device, jax_dev):
        o = model._find_variants_oracle(q, params)
        assert _tuples(model, d) == _tuples(model, o) == _tuples(model, j), q


def test_band_plan_matches_jax(monkeypatch):
    """The port's band is the exact need, never wider than the JAX plan's
    bucketed band, and covers every tile's charcount range."""
    monkeypatch.setattr(jsa, "B_TILE", 8)
    monkeypatch.setattr(tsa, "B_TILE", 8)
    model = _port_mixed_model()
    pipe = DevicePipeline(model, "cpu")
    jpipe = jpl.DevicePipeline(model)
    B = 16
    rng = np.random.default_rng(0)
    q_cc = np.sort(rng.integers(2, 21, size=B).astype(np.int32))
    k_ana = rng.integers(0, 4, size=B).astype(np.int32)
    start, nb = pipe._band_plan(q_cc, k_ana, B)
    _, jnb = jpipe._band_plan(q_cc, k_ana, B)
    assert nb <= jnb
    np.testing.assert_array_equal(pipe._cc_dev, jpipe._cc_dev)
    rows = np.arange(len(pipe._cc_dev))
    for j in range(B // 8):
        lo = int((q_cc[j * 8 : (j + 1) * 8] - k_ana[j * 8 : (j + 1) * 8]).min())
        hi = int((q_cc[j * 8 : (j + 1) * 8] + k_ana[j * 8 : (j + 1) * 8]).max())
        in_band = (pipe._cc_dev >= lo) & (pipe._cc_dev <= hi)
        covered = (rows >= start[j] * 1024) & (rows < (start[j] + nb) * 1024)
        assert not (in_band & ~covered).any()


def test_all_padding_tile(monkeypatch):
    monkeypatch.setattr(tsa, "B_TILE", 8)
    model = _port_mixed_model()
    params = get_test_searchparams()
    queries = ["cat", "dog", "sun", "map", "pen", "pens", "cats", "dogs", "sunn"]
    device = DevicePipeline(model, "cpu").find_variants_batch(queries, params)
    for q, d in zip(queries, device):
        o = model._find_variants_oracle(q, params)
        assert _tuples(model, d) == _tuples(model, o), q
