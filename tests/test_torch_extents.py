"""The port's threshold-major planes and their block extents
(``analiticcl_tpu_torch/convert.py``) on the CPU: each 1024-row block's
extent against a direct reckoning from the entries' character counts, in
the port's order and the JAX package's; stage A computed block by block
over only the columns each block's extent keeps equal to stage A over the
whole planes (hypothesis, seeded); the query planes in the order of the
index they meet on every path that builds one (a mismatch gives wrong
hits, not an error); and the band plans' widths."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import analiticcl_tpu_torch.ops.stage_a as tsa
from analiticcl_tpu_torch import VariantModel
from analiticcl_tpu_torch.convert import (
    band_width,
    block_extents,
    count_planes,
    host_layout,
    plane_columns,
)
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline, query_planes
from analiticcl_tpu_torch.parallel.mesh import get_sharded_pipeline, make_mesh
from analiticcl_tpu_torch.testing import ALPHABET, populate, synthetic_lexicon

torch.set_num_threads(2)


def _repetitive(seed: int, n: int = 64, k: int = 50) -> str:
    """``n`` letters of which ``k`` are one letter (test_torch_planes')."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    one = rng.choice(letters)
    chars = np.concatenate([np.repeat(one, k),
                            rng.choice(letters[letters != one], n - k)])
    return "".join(rng.permutation(chars))


@pytest.fixture(scope="module", params=["main", "outlier"])
def model(request):
    """3,000 seeded entries, with or without one entry that holds a letter
    50 times (planes 30 x 50 wide)."""
    words = synthetic_lexicon(seed=3, n=3000)
    if request.param == "outlier":
        words = words + [_repetitive(7)]
    return populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)


def _device_counts(model, lay):
    """int32 [Ni_pad, A]: each device row's character counts (0 for
    padding rows)."""
    counts = np.zeros((len(lay.cc), model.alphabet_size()), np.int32)
    n = model.index.size
    counts[:n] = model.index.counts[lay.canon_of[:n]]
    return counts


def _reckoned(counts, T: int, order: str) -> np.ndarray:
    """Each block's extent straight from its rows' counts: the largest
    count of each character in the block gives its last 1 column (``t*A +
    a`` threshold-major, ``a*T + t`` letter-major), rounded up to 32, at
    least 32."""
    A = counts.shape[1]
    out = []
    for blk in counts.reshape(-1, 1024, A):
        cmax = blk.max(0)
        a = np.nonzero(cmax)[0]
        last = ((cmax[a] - 1) * A + a + 1 if order == "threshold"
                else a * T + cmax[a])
        out.append(max(32, -(-int(last.max(initial=0)) // 32) * 32))
    return np.array(out, np.int32)


def test_block_extents_equal_counts_reckoning(model):
    lay = host_layout(model)
    counts = _device_counts(model, lay)
    A, T = counts.shape[1], lay.bins.shape[1] // counts.shape[1]
    np.testing.assert_array_equal(lay.bins, count_planes(counts, T))
    ext = block_extents(lay.bins).numpy()
    np.testing.assert_array_equal(ext, _reckoned(counts, T, "threshold"))
    # the JAX package's letter-major planes: the same reduction, their order
    jax_bins = np.empty_like(lay.bins)
    jax_bins[:, plane_columns(A, T)] = lay.bins
    np.testing.assert_array_equal(block_extents(jax_bins).numpy(),
                                  _reckoned(counts, T, "letter"))
    pipe = DevicePipeline(model, "cpu")
    np.testing.assert_array_equal(pipe.index.extents_host, ext)
    # one block at the outlier's width; the rest, as the whole main
    # lexicon, within the main instance's 224 columns
    assert (ext > 224).sum() == (T == 50)
    assert ext.max() == (1504 if T == 50 else 224)


def _stage_a_at_extents(bins, cc, valid, qbin, q_cc, k_ana, k_len, start,
                        nb_band, ext):
    """Stage A as the kernel's streamed instance reads the planes: for each
    tile and band block, the dot over the block's first ``ext`` columns of
    both operands only; then the plain version's tests and packing."""
    B = qbin.shape[0]
    bt = tsa._b_tile(B, bins.shape[0])
    dots = []
    for t in range(B // bt):
        q = qbin[t * bt:(t + 1) * bt].float()
        for j in range(nb_band):
            blk = int(start[t]) + j
            e = int(ext[blk])
            rows = bins[blk * 1024:(blk + 1) * 1024, :e].float()
            dots.append((t, j, (rows @ q[:, :e].T).to(torch.int32)))
    # fold the blockwise dots back through the plain version: planes
    # whose dot with each query is the blockwise one (one-hot columns)
    out = []
    for t in range(B // bt):
        d = torch.cat([x for tt, _, x in dots if tt == t])  # [Nb, bt]
        r0 = int(start[t]) * 1024
        rows = slice(r0, r0 + nb_band * 1024)
        l1 = cc[rows][:, None] + q_cc[t * bt:(t + 1) * bt][None] - 2 * d
        kq = k_ana[t * bt:(t + 1) * bt][None]
        kl = k_len[t * bt:(t + 1) * bt][None]
        hit = (l1 <= kq) & ((cc[rows][:, None] - q_cc[t * bt:(t + 1) * bt][None])
                            .abs() <= kl) & valid[rows][:, None]
        exact = (l1 == 0) & valid[rows][:, None]
        out.append((hit, exact))
    return out


def _plain_masks(args, nb_band):
    """stage_a_masks_plain's hit and exact masks per tile, unpacked."""
    packed, exact, *_ = tsa.stage_a_masks_plain(*args, nb_band)
    B = packed.shape[0]
    bt = tsa._b_tile(B, args[0].shape[0])
    bits = torch.arange(8)

    def unpack(x):  # [B, Nb/8] -> [Nb, B]
        return ((x[:, :, None].int() >> bits) & 1).reshape(B, -1).T.bool()

    hit, ex = unpack(packed), unpack(exact)
    return [(hit[:, t * bt:(t + 1) * bt], ex[:, t * bt:(t + 1) * bt])
            for t in range(B // bt)]


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), A=st.integers(2, 12),
       T=st.integers(1, 9), outlier=st.booleans(), random_bits=st.booleans())
def test_plain_at_block_extents_equals_full(seed, A, T, outlier,
                                            random_bits):
    """Whatever the queries hold, stage A over each band block's first
    ``extent`` columns equals stage A over the whole planes: on count
    planes (threshold-major, rows charcount-sorted) with or without one
    outlier entry whose count is the planes' depth, and on random 0/1
    planes whose blocks are cut at random widths."""
    rng = np.random.default_rng(seed)
    Ni, B, nb_band = 4096, 32, 2
    Tp = T + 6 if outlier else T
    if random_bits:
        bins = (rng.random((Ni, A * Tp)) < 0.3).astype(np.int8)
        for blk in range(Ni // 1024):
            bins[blk * 1024:(blk + 1) * 1024, rng.integers(1, A * Tp + 1):] = 0
        cc = bins.sum(1, dtype=np.int32)
    else:
        counts = rng.integers(0, T + 1, (Ni, A)) * (rng.random((Ni, A)) < 0.4)
        if outlier:
            counts[rng.integers(Ni)] = 0
            counts[rng.integers(Ni), rng.integers(A)] = Tp
        cc = counts.sum(1).astype(np.int32)
        order = np.argsort(cc, kind="stable")
        counts, cc = counts[order], cc[order]
        bins = count_planes(counts, Tp)
    at_pad = -(-bins.shape[1] // 32) * 32
    bins = np.pad(bins, ((0, 0), (0, at_pad - bins.shape[1])))
    valid = np.arange(Ni) < Ni - 50
    qbin = (rng.random((B, at_pad)) < 0.4).astype(np.int8)  # any planes
    q_cc = qbin.sum(1, dtype=np.int32)
    for q in range(0, B, 4):  # some exact matches of band rows
        qbin[q] = bins[rng.integers(Ni - 50)]
        q_cc[q] = qbin[q].sum(dtype=np.int32)
    k_ana = rng.integers(0, 6, B).astype(np.int32)
    k_len = np.minimum(k_ana, rng.integers(0, 6, B)).astype(np.int32)
    bt = tsa._b_tile(B, Ni)
    start = rng.integers(0, Ni // 1024 - nb_band + 1, B // bt).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        bins, cc, valid, qbin, q_cc, k_ana, k_len, start)]
    ext = block_extents(args[0])
    assert band_width(ext.numpy(), start, nb_band) <= at_pad
    got = _stage_a_at_extents(*args, nb_band, ext)
    want = _plain_masks(args, nb_band)
    for (gh, ge), (wh, we) in zip(got, want):
        assert torch.equal(gh, wh) and torch.equal(ge, we)


def _dot_identity(index, counts_q, counts_rows):
    """The dot of a query's planes with a row's is the sum over characters
    of the smaller count (both clipped at the planes' depth) only where
    both planes are in one order: check it over the first rows."""
    qbin = query_planes(index, torch.from_numpy(counts_q))
    A = counts_q.shape[1]
    T = index.at // A
    n = len(counts_rows)
    dot = (index.bins[:n].float() @ qbin.float().T).to(torch.int64)
    want = np.minimum(np.minimum(counts_rows, T)[:, None, :],
                      np.minimum(counts_q, T)[None, :, :]).sum(2)
    np.testing.assert_array_equal(dot.numpy(), want)


def test_query_planes_follow_the_index_order(model):
    """On the single-device pipeline and on every shard of a 1x3 and a
    2x2 mesh, the query planes meet the index's planes in one column
    order."""
    lay = host_layout(model)
    counts = _device_counts(model, lay)
    rng = np.random.default_rng(0)
    q = counts[rng.integers(0, model.index.size, 24)]
    q[::3] = rng.integers(0, 9, (8, q.shape[1]))  # counts past T too
    pipe = DevicePipeline(model, "cpu")
    _dot_identity(pipe.index, q, counts[:model.index.size])
    for shape in ((1, 3), (2, 2)):
        mesh = get_sharded_pipeline(
            model, make_mesh(["cpu"] * (shape[0] * shape[1]), dp=shape[0]))
        for s in range(shape[1]):
            rows = mesh._canon_of[s * mesh.Ni_shard:(s + 1) * mesh.Ni_shard]
            n = int(mesh.shard(0, s).validrows.sum())  # a prefix of the shard
            sc = model.index.counts[rows[:n]].astype(np.int32)
            for d in range(shape[0]):
                _dot_identity(mesh.shard(d, s), q, sc)


def test_band_plan_widths(model):
    """The single-device and the mesh band plans' widths are the largest
    extents of the blocks their tiles read, shard by shard; a batch of
    short queries stays off the outlier's block."""
    pipe = DevicePipeline(model, "cpu")
    ext = pipe.index.extents_host
    B = 64
    q_cc = np.sort(np.random.default_rng(1).integers(2, 70, B)).astype(
        np.int32)
    k = np.full(B, 2, np.int32)
    start, nb, width = pipe._band_plan(q_cc, k, B)
    assert width == max(int(ext[s:s + nb].max()) for s in start)
    _, _, narrow = pipe._band_plan(np.full(B, 3, np.int32), k, B)
    assert narrow <= 224
    mesh = get_sharded_pipeline(model, make_mesh(["cpu"] * 6, dp=2))
    starts, nbs, widths = mesh._band_plan(q_cc, k, B)
    for d in range(2):
        for s in range(3):
            e = mesh.shard(d, s).extents_host
            nb_ds = int(nbs[d, s])
            assert widths[d, s] == max(int(e[x:x + nb_ds].max())
                                       for x in starts[d, s])
