"""The port's stage A (analiticcl_tpu_torch/ops/stage_a.py) against the JAX
package's ``stage_a_masks_xla``, bit for bit, across query tiles and band
starts; and the port's banded pipeline against the host oracle with a forced
small query tile (as test_banding.py does for the JAX pipeline)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analiticcl_tpu.ops.pipeline as jpl
import analiticcl_tpu.ops.stage_a as jsa
import analiticcl_tpu_torch.ops.stage_a as tsa
from analiticcl_tpu_torch import DistanceThreshold, SearchParameters, VariantModel
from analiticcl_tpu_torch.convert import (
    block_extents, count_planes, k1_table, plane_columns,
)
from analiticcl_tpu_torch.ops.pipeline import DevicePipeline, query_planes
from analiticcl_tpu_torch.testing import populate
from fixtures import TEST_ALPHABET, get_test_searchparams
from test_banding import _mixed_model, _tuples
from test_torch_slice import to_port, to_ref

torch.set_num_threads(2)


def _inputs(seed, Ni, A, T, B, nb_band, n_pad_rows=100):
    """Charcount-sorted random planes; the last rows are padding."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, T + 1, size=(Ni, A)) * (rng.random((Ni, A)) < 0.25)
    cc = counts.sum(1).astype(np.int32)
    order = np.argsort(cc, kind="stable")
    counts, cc = counts[order], cc[order]
    bins = count_planes(counts, T)
    valid = np.arange(Ni) < Ni - n_pad_rows
    bins[~valid] = 0
    cc[~valid] = 1 << 28
    qc = rng.integers(0, T + 1, size=(B, A)) * (rng.random((B, A)) < 0.25)
    qbin = count_planes(qc, T)
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
    got = tsa.stage_a_masks(*targs, nb_band,
                            *k1_table(targs[0], targs[7], nb_band))
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
    ext = block_extents(targs[0])
    with pytest.raises(ValueError):
        tsa.stage_a_masks(*targs, 3, ext, 32)  # band wider than the index
    for bad_ext, width in ((ext, 16), (ext, 64), (ext[:1], 32),
                           (ext.long(), 32)):
        with pytest.raises(ValueError):  # width or table out of shape
            tsa.stage_a_masks(*targs, 1, bad_ext, width)
    targs[1] = targs[1].to(torch.int64)
    with pytest.raises(ValueError):
        tsa.stage_a_masks(*targs, 1, ext, 32)


def _fragment_accumulators(bins, qbin, start, bt, qt, nb_band):
    """The kernel's int32 accumulators in mma.m16n8k32 fragment order:
    [B / qt, nb_band, 16 chunks, 8 warps, 32 lanes, 32] (csrc/stage_a.cu,
    ``fragment_words``: queries are the MMA's rows, band rows its columns);
    tile queries past ``qt`` are zero."""
    B = qbin.shape[0]
    qb, bb, ch, wp, ln, e = np.indices((B // qt, nb_band, 16, 8, 32, 32))
    mi, ni, reg = e // 16, (e // 4) % 4, e % 4
    col = (wp // 2) * 32 + 16 * mi + 8 * (reg // 2) + ln // 4
    band_row = (bb * 1024 + ch * 64 + (wp % 2) * 32 + 8 * ni
                + 2 * (ln % 4) + reg % 2)
    q = qb * qt + np.minimum(col, qt - 1)
    row = start[q // bt] * 1024 + band_row
    dot = np.einsum("...k,...k->...", bins[row].astype(np.int32),
                    qbin[q].astype(np.int32))
    return np.ascontiguousarray(np.where(col < qt, dot, 0), dtype=np.int32)


@pytest.fixture(scope="module")
def host_epilogue(tmp_path_factory):
    """csrc/stage_a.cu compiled as plain C++ with -DANALITICCL_HOST_TEST."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("stage_a_host") / "libstage_a_host.so"
    src = Path(tsa.__file__).resolve().parent.parent / "csrc" / "stage_a.cu"
    subprocess.run(
        [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST", "-shared",
         "-fPIC", "-o", str(so), str(src)],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize(
    "b_tile,B,nb_band",
    [(1024, 64, 2), (8, 8, 2), (32, 128, 1), (256, 512, 1), (1024, 256, 1)],
)
def test_kernel_epilogue_on_host(monkeypatch, host_epilogue, b_tile, B,
                                 nb_band):
    """The CUDA kernel's fused epilogue (fragment predicates, ballot words to
    query-major bits, per-128-row counts, totals) from accumulators in MMA
    fragment order, against stage_a_masks_plain byte for byte; bt = 8 covers
    a query tile narrower than the MMA width. The launch runs only on a card."""
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    bins, cc, valid, qbin, q_cc, k_ana, k_len, start = _inputs(
        b_tile + B + 3, Ni=4096, A=9, T=3, B=B, nb_band=nb_band
    )
    bt = tsa._b_tile(B, bins.shape[0])
    qt = min(tsa.KERNEL_QT, bt)
    acc = _fragment_accumulators(bins, qbin, start, bt, qt, nb_band)
    Nb = nb_band * 1024
    out = [np.zeros((B, Nb // 8), np.uint8), np.zeros((B, Nb // 8), np.uint8),
           np.zeros((Nb // 128, B), np.int32), np.zeros(B, np.int32),
           np.zeros(B, np.int32)]
    valid_u8 = valid.astype(np.uint8)
    ptr = ctypes.c_void_p
    host_epilogue.analiticcl_stage_a_host(
        *[ptr(x.ctypes.data) for x in (acc, cc, valid_u8, q_cc, k_ana, k_len,
                                       start, *out)],
        *map(ctypes.c_int, (B, nb_band, bt, qt)),
    )
    want = tsa.stage_a_masks_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            bins, cc, valid, qbin, q_cc, k_ana, k_len, start)), nb_band,
    )
    names = ("packed_q", "exact_q", "counts_t", "nmatch", "nexact")
    for name, g, w in zip(names, out, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert out[3].sum() > 0 and out[4].sum() > 0


# (A, T, plane width padded to 32): AT 992 and 1,056 (not multiples of the
# streamed instance's 128-byte k-chunks), 1,664, 2,048 and 6,016
STREAM_WIDTHS = [(30, 33, 992), (30, 35, 1056), (30, 55, 1664),
                 (30, 68, 2048), (30, 200, 6016)]
MAIN_WIDTH = 224  # the main instance's k width (the streamed instance's
# blocks of extent up to 224 run its body)


def _mixed_inputs(seed, Ni, A, T, B, nb_band, at_pad, caps):
    """Threshold-major planes ``at_pad`` wide whose 1024-row blocks cap
    their counts at ``caps`` in turn (so their extents run from 32 up to
    the full width), charcounts from the planes, the last 100 rows
    padding; queries as :func:`_inputs` makes them, with a band start per
    tile."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, T + 1, size=(Ni, A)) * (rng.random((Ni, A)) < 0.25)
    cap = np.resize(np.asarray(caps), Ni // 1024).repeat(1024)
    counts = np.minimum(counts, cap[:, None])
    bins = np.zeros((Ni, at_pad), np.int8)
    bins[:, :A * T] = count_planes(counts, T)
    valid = np.arange(Ni) < Ni - 100
    bins[~valid] = 0
    cc = bins.sum(1, dtype=np.int32)
    cc[~valid] = 1 << 28
    qc = rng.integers(0, T + 1, size=(B, A)) * (rng.random((B, A)) < 0.25)
    qbin = np.zeros((B, at_pad), np.int8)
    qbin[:, :A * T] = count_planes(qc, T)
    q_cc = qc.sum(1).astype(np.int32)
    k_ana = rng.integers(0, 5, size=B).astype(np.int32)
    k_len = np.minimum(k_ana, rng.integers(0, 4, size=B)).astype(np.int32)
    k_ana[-3:] = k_len[-3:] = -1
    bt = tsa._b_tile(B, Ni)
    start = rng.integers(0, Ni // 1024 - nb_band + 1,
                         size=B // bt).astype(np.int32)
    for q in range(0, B, 5):  # exact anagrams of rows of the tile's band
        r = int(start[q // bt]) * 1024 + int(rng.integers(nb_band * 1024))
        if valid[r]:
            qbin[q], q_cc[q] = bins[r], cc[r]
    return bins, cc, valid, qbin, q_cc, k_ana, k_len, start


def _stream_host(lib, ins, B, at_pad, nb_band, bt, qt):
    """``analiticcl_stage_a_stream_host`` on numpy inputs: the outputs and
    each block's walk (ring steps, plane bytes a row's products read)."""
    Nb = nb_band * 1024
    out = [np.zeros((B, Nb // 8), np.uint8), np.zeros((B, Nb // 8), np.uint8),
           np.zeros((Nb // 128, B), np.int32), np.zeros(B, np.int32),
           np.zeros(B, np.int32)]
    bins, cc, valid, qbin, q_cc, k_ana, k_len, start = ins
    ext = block_extents(bins).numpy()
    walk = np.zeros((B // qt, nb_band, 2), np.int32)
    arrs = [np.ascontiguousarray(x) for x in (
        bins, cc, valid.astype(np.uint8), qbin, q_cc, k_ana, k_len, start,
        ext)]
    ptr = ctypes.c_void_p
    lib.analiticcl_stage_a_stream_host(
        *[ptr(x.ctypes.data) for x in (*arrs, *out)],
        *map(ctypes.c_int, (B, at_pad, nb_band, bt, qt)),
        ptr(walk.ctypes.data),
    )
    return out, walk, ext


def _check_stream(out, walk, ext, ins, nb_band, bt, qt):
    """The host walk's outputs equal stage_a_masks_plain byte for byte, and
    each block walked its own extent: 16 rounds of kchunks(extent) steps
    (128-byte k-chunks), or the main body's 16 chunks at 224 columns."""
    want = tsa.stage_a_masks_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in ins), nb_band)
    names = ("packed_q", "exact_q", "counts_t", "nmatch", "nexact")
    for name, g, w in zip(names, out, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert out[3].sum() > 0 and out[4].sum() > 0
    start = ins[7]
    for qb, band_blk in np.ndindex(walk.shape[:2]):
        e = int(ext[start[qb * qt // bt] + band_blk])
        want_walk = ((16, MAIN_WIDTH) if e <= MAIN_WIDTH
                     else (16 * -(-e // 128), e))
        assert tuple(walk[qb, band_blk]) == want_walk, (qb, band_blk, e)


@pytest.mark.parametrize(
    "A,T,at_pad,b_tile,B,Ni,nb_band",
    [(*w, 128, 256, 4096, 2) for w in STREAM_WIDTHS[:4]]
    + [(*STREAM_WIDTHS[4], 128, 128, 2048, 1),
       (*STREAM_WIDTHS[2], 8, 16, 4096, 2)],
    ids=[f"AT{w[2]}" for w in STREAM_WIDTHS] + ["AT1664-bt8"],
)
def test_streamed_loop_on_host(monkeypatch, host_epilogue, A, T, at_pad,
                               b_tile, B, Ni, nb_band):
    """The streamed instance's loop nest (row chunk x k-chunk x ring stage,
    ``analiticcl_stage_a_stream_host``: the kernel's piece offsets, a scalar
    dot for each accumulator in fragment order, the same epilogue) against
    stage_a_masks_plain byte for byte, at planes wider than any resident
    block holds, 128 queries a block and (bt 8) 8; random threshold-major
    planes, nearly every block at the full width."""
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    bins, cc, valid, qbin, q_cc, k_ana, k_len, start = _inputs(
        at_pad + B, Ni=Ni, A=A, T=T, B=B, nb_band=nb_band)
    extra = ((0, 0), (0, at_pad - A * T))  # zero columns, as convert.py pads
    bins, qbin = np.pad(bins, extra), np.pad(qbin, extra)
    bt = tsa._b_tile(B, Ni)
    qt = min(tsa.KERNEL_QT, bt)
    assert qt == min(128, b_tile)
    ins = (bins, cc, valid, qbin, q_cc, k_ana, k_len, start)
    out, walk, ext = _stream_host(host_epilogue, ins, B, at_pad, nb_band, bt,
                                  qt)
    _check_stream(out, walk, ext, ins, nb_band, bt, qt)


# the count caps of consecutive blocks: extents 32 (one level of 30
# letters), 224 (the main lexicon's 7), 256 (8), and the full width
MIXED_CAPS = (1, 7, 8, 200)


@pytest.mark.parametrize("at_pad,T,b_tile,B,nb_band", [
    (1664, 55, 128, 256, 3),  # tiles span narrow and wide blocks
    (1664, 55, 8, 16, 4),
    (992, 33, 128, 128, 4),  # the last k-chunk 96 bytes wide
    (6016, 200, 64, 128, 4),
], ids=["AT1664", "AT1664-bt8", "AT992", "AT6016"])
def test_streamed_loop_at_block_extents(monkeypatch, host_epilogue, at_pad, T,
                                        b_tile, B, nb_band):
    """A lexicon whose blocks' extents run from 32 to the full width: the
    streamed instance walks each band block at its own extent (the main
    body at most 224), and its outputs equal stage_a_masks_plain's byte
    for byte."""
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    Ni = 8192
    ins = _mixed_inputs(at_pad + B + MAIN_WIDTH, Ni, 30, T, B, nb_band,
                        at_pad, MIXED_CAPS)
    bt = tsa._b_tile(B, Ni)
    qt = min(tsa.KERNEL_QT, bt)
    out, walk, ext = _stream_host(host_epilogue, ins, B, at_pad, nb_band, bt,
                                  qt)
    assert sorted(set(ext.tolist())) == [32, 224, 256, at_pad]
    _check_stream(out, walk, ext, ins, nb_band, bt, qt)
    assert len({tuple(w) for w in walk.reshape(-1, 2)}) >= 3


H100_SMEM = 232_448  # the dynamic shared memory a block may opt in to


@pytest.mark.parametrize("width,at_pad,qt,limit,want", [
    (224, 224, 128, H100_SMEM, "main"),
    (224, 224, 8, H100_SMEM, "main"),
    (256, 256, 128, H100_SMEM, "resident"),
    (576, 576, 128, H100_SMEM, "resident"),  # the last that fits 128 queries
    (608, 608, 128, H100_SMEM, "stream"),
    (608, 608, 8, H100_SMEM, "stream"),
    (992, 992, 128, H100_SMEM, "stream"),
    (6016, 6016, 128, H100_SMEM, "stream"),
    (224, 224, 128, 111_552, "main"),  # the main block: 111,552 bytes
    (224, 224, 128, 111_551, None),  # a lowered limit: nothing fits
    # the streamed block runs the main body, so it takes the main block's
    # shared memory: its ring alone is 89,728 bytes (36,736 at 32 query
    # rows)
    (992, 992, 128, 111_552, "stream"),
    (992, 992, 128, 111_551, None),
    (992, 992, 8, 111_552, "stream"),
    (992, 992, 8, 111_551, None),
    # the launch's width, not the planes', decides
    (224, 1664, 128, H100_SMEM, "main"),  # the main lexicon's blocks
    (96, 1664, 128, H100_SMEM, "main"),
    (256, 1664, 128, H100_SMEM, "resident"),  # planes 256 and 288 wide
    (256, 256, 128, H100_SMEM, "resident"),
    (224, 288, 128, H100_SMEM, "main"),
    (96, 96, 128, H100_SMEM, "resident"),  # planes narrower than 224
    (576, 1664, 128, H100_SMEM, "resident"),
    (608, 1664, 128, H100_SMEM, "stream"),
    (1664, 1664, 128, H100_SMEM, "stream"),
    (224, 1664, 128, 111_551, None),
])
def test_kernel_routing(host_epilogue, width, at_pad, qt, limit, want):
    """``k1_route`` at its edges: the main instance for a launch whose rows
    use at most 224 columns, a resident one while its width fits the
    limit, else the streamed one, whose shared memory does not depend on
    the width (the main block's, since it runs the main body too)."""
    route = host_epilogue.analiticcl_stage_a_route
    route.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong]
    code = route(width, at_pad, qt, limit)
    names = {v: k for k, v in tsa.INSTANCES.items()}
    assert names.get(code) == want


def _port_mixed_model(jm=None):
    """The port's model over test_banding's mixed lexicon (the JAX package's
    model ``jm``, built anew if not given)."""
    jm = _mixed_model() if jm is None else jm
    words = [jm.decoder[i].text for i in range(3, len(jm.decoder))]
    return populate(VariantModel(alphabet=TEST_ALPHABET, device="cpu"), words)


@pytest.mark.parametrize("b_tile", [8, 1024])
def test_banded_pipeline_matches_oracle(monkeypatch, b_tile):
    monkeypatch.setattr(jsa, "B_TILE", b_tile)
    monkeypatch.setattr(tsa, "B_TILE", b_tile)
    jm = _mixed_model()
    model = _port_mixed_model(jm)
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
    jax_dev = jpl.DevicePipeline(jm).find_variants_batch(queries, to_ref(params))
    for q, d, j in zip(queries, device, jax_dev):
        o = model._find_variants_oracle(q, params)
        assert _tuples(model, d) == _tuples(model, o) == _tuples(jm, j), q


def test_band_plan_matches_jax(monkeypatch):
    """The port's band is the exact need, never wider than the JAX plan's
    bucketed band, and covers every tile's charcount range; its width is
    the largest extent of the blocks the tiles read."""
    monkeypatch.setattr(jsa, "B_TILE", 8)
    monkeypatch.setattr(tsa, "B_TILE", 8)
    jm = _mixed_model()
    pipe = DevicePipeline(_port_mixed_model(jm), "cpu")
    jpipe = jpl.DevicePipeline(jm)
    B = 16
    rng = np.random.default_rng(0)
    q_cc = np.sort(rng.integers(2, 21, size=B).astype(np.int32))
    k_ana = rng.integers(0, 4, size=B).astype(np.int32)
    start, nb, width = pipe._band_plan(q_cc, k_ana, B)
    _, jnb = jpipe._band_plan(q_cc, k_ana, B)
    assert nb <= jnb
    ext = block_extents(pipe.index.bins).numpy()
    np.testing.assert_array_equal(ext, pipe.index.extents_host)
    assert width == max(int(ext[s:s + nb].max()) for s in start)
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
    params = to_port(get_test_searchparams())
    queries = ["cat", "dog", "sun", "map", "pen", "pens", "cats", "dogs", "sunn"]
    device = DevicePipeline(model, "cpu").find_variants_batch(queries, params)
    for q, d in zip(queries, device):
        o = model._find_variants_oracle(q, params)
        assert _tuples(model, d) == _tuples(model, o), q


def test_index_planes_padded_to_32_match_jax():
    """The port pads the index's count planes (and so the query planes) with
    zero columns to a multiple of 32, one int8 MMA k-step, and orders their
    columns threshold-major. On a batch of the port's pipeline, stage A
    over the padded planes, at the band's width, equals the JAX package's
    over the JAX pipeline's own planes of the same lexicon (letter-major,
    the port's under ``plane_columns``) without the padding."""
    jm = _mixed_model()
    model = _port_mixed_model(jm)
    pipe = DevicePipeline(model, "cpu")
    jpipe = jpl.DevicePipeline(jm)
    idx = pipe.index
    assert idx.bins.shape[1] % 32 == 0 and idx.bins.shape[1] > idx.at
    cols = plane_columns(jpipe.A, jpipe.T)
    jbins = np.asarray(jpipe._idx[0])
    np.testing.assert_array_equal(idx.bins[:, :idx.at].numpy(),
                                  jbins[:, cols])
    queries = ["cat", "dogg", "windwo", "bottel", "gadren", "pilow",
               "carpets", "aproximately", "pens", "suns", "extraordinry"]
    st = pipe.prepare(queries, to_port(get_test_searchparams()))
    q_counts, q_cc, _, _, _, k_ana, _, k_len, _, start_blk, _, _ = st["args"]
    qbin = query_planes(idx, q_counts)
    assert qbin.shape[1] == idx.bins.shape[1]
    got = tsa.stage_a_masks(idx.bins, idx.cc, idx.validrows, qbin, q_cc,
                            k_ana, k_len, start_blk, st["nb_band"],
                            idx.extents, st["width"])
    at = idx.at
    jqbin = np.empty((qbin.shape[0], at), np.int8)
    jqbin[:, cols] = qbin[:, :at].numpy()  # the JAX core's query planes
    want = jsa.stage_a_masks_xla(
        jnp.asarray(jbins), *(jnp.asarray(x.numpy()) for x in (
            idx.cc, idx.validrows)), jnp.asarray(jqbin),
        *(jnp.asarray(x.numpy()) for x in (q_cc, k_ana, k_len, start_blk)),
        st["nb_band"],
    )
    for name, g, w in zip(("packed_q", "exact_q", "counts_t", "nmatch",
                           "nexact"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[3].sum()) > 0 and int(got[4].sum()) > 0
