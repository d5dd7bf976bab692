"""The survivor compaction (kernel K4, ``csrc/compact.cu``) and the query
planes (kernel K5, ``csrc/planes.cu``) of the port's query core.

* K4's compaction, compiled as plain C++ with ``-DANALITICCL_HOST_TEST``
  (the kernel's blocks walked in order, each lane's 16 keep flags into the
  block's list, the list at consecutive ranks, its fill, copy and
  totals), equals ``compact_survivors_plain`` and the JAX ``_compact``
  (``analiticcl_tpu/ops/pipeline.py:242``, on JAX's CPU backend, with the
  core's fill) exactly on seeded keep masks: no survivors, every slot
  kept, survivors on the edges of K4's lanes, K2's blocks, K4's warps and
  its chunks, P not a multiple of K2's block at both block sizes (128 and
  64 slots), survivors past P2 (dropped, the total exact), P2 above P,
  batches of 13 and 4,096 queries, and uint8 and int32 metrics (the
  latter from L 256). The host build writes the one output buffer;
  ``_unpack`` reads it at ``_pack``'s layout of the core's ten outputs,
  and its bytes equal ``_pack`` of the plain version's outputs.
* ``_pack`` passes K4's buffer on as it is: no copy, the same layout.
* K5's host build (its 16-byte pieces) equals ``query_planes`` (its
  plain version on the CPU) and the JAX core's planes
  (``analiticcl_tpu/ops/pipeline.py:402-408``) at widths padded to 32 and
  unpadded, a row of one piece and one of more pieces than a block has
  threads, counts above the plane depth included, and zeroes stage A's
  totals.
* Both wrappers take the plain versions for CPU tensors, launch nothing
  there, and raise on inputs the kernels do not take.
* The port's CPU core with K3, K2's slot entry, K4 and K5 all replaced by
  their host builds equals the JAX ``_query_core`` exactly: the
  ``stageA`` and ``compact_sum`` probes and the outputs, at a budget above
  the totals and one below them.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analiticcl_tpu_torch.ops.pipeline as ppl
from analiticcl_tpu_torch.convert import plane_columns
from analiticcl_tpu.ops.pipeline import _compact
from analiticcl_tpu_torch.ops.pipeline import (
    compact_survivors,
    compact_survivors_plain,
    query_planes,
    query_planes_plain,
)
from test_torch_profiling import _assert_probes_equal, batch  # noqa: F401
from test_torch_query_core import (  # noqa: F401  (fixtures)
    P_BUDGET,
    _jax_core,
    freqs,
    jax_model,
    words,
)
from test_torch_resolve import (  # noqa: F401  (fixtures)
    _assert_outputs_equal,
    _budgets,
    _jax,
    _port,
    host_resolve,
    host_slots_lib,
)

torch.set_num_threads(2)

CSRC = Path(ppl.__file__).resolve().parent.parent / "csrc"
_jax_compact = jax.jit(_compact, static_argnums=(2, 3))


def _host_lib(tmp_path_factory, name: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp(f"{name}host") / f"lib{name}host.so"
    subprocess.run(
        [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST", "-shared",
         "-fPIC", "-o", str(so), str(CSRC / f"{name}.cu")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


@pytest.fixture(scope="module")
def host_compact_flat(tmp_path_factory):
    """``csrc/compact.cu`` built for the host, as a function with
    ``compact_survivors``'s arguments that returns the output buffer."""
    fn = _host_lib(tmp_path_factory, "compact").analiticcl_compact_host
    fn.restype = ctypes.c_int

    def run(keep, counts, block, q, pc, met, max_freq, total_match, P2):
        B, P = max_freq.shape[0], keep.shape[0]
        mb = met.element_size()
        flat = torch.full((8 * (B + 2) + (8 + 5 * mb) * P2,), 0xA5,
                          dtype=torch.uint8)
        err = fn(_ptr(counts), ctypes.c_int(counts.numel()),
                 ctypes.c_int(block),
                 *[_ptr(t.contiguous()) for t in (keep, q, pc, met)],
                 ctypes.c_int(mb),
                 *[_ptr(t.contiguous()) for t in (max_freq, total_match)],
                 _ptr(flat), ctypes.c_int(B), ctypes.c_int(P),
                 ctypes.c_int(P2))
        assert err == 0
        return flat

    return run


@pytest.fixture(scope="module")
def host_compact(host_compact_flat):
    """The host build with ``compact_survivors``'s arguments and outputs:
    the buffer read back at ``_pack``'s layout of the plain version's
    outputs."""
    def run(keep, counts, block, q, pc, met, max_freq, total_match, P2):
        flat = host_compact_flat(keep, counts, block, q, pc, met, max_freq,
                                 total_match, P2)
        _, layout = ppl._pack(compact_survivors_plain(
            keep, counts, block, q, pc, met, max_freq, total_match, P2))
        return tuple(ppl._unpack(flat, layout))

    return run


@pytest.fixture(scope="module")
def host_planes(tmp_path_factory):
    """``csrc/planes.cu`` built for the host, with ``query_planes``'s
    arguments and output."""
    fn = _host_lib(tmp_path_factory, "planes").analiticcl_planes_host
    fn.restype = ctypes.c_int

    def run(index, q_counts, totals=None):
        B, A = q_counts.shape
        at_pad = index.bins.shape[1]
        planes = torch.full((B, at_pad), 7, dtype=torch.int8)
        err = fn(_ptr(q_counts.contiguous()), _ptr(planes), _ptr(totals),
                 ctypes.c_int(B), ctypes.c_int(A),
                 ctypes.c_int(index.at // A), ctypes.c_int(at_pad))
        assert err == 0
        return planes

    return run


# slots K2's blocks, K4's lanes (16 slots), warps (512) and chunks (2,048)
# start at, and their last slots
EDGES = (0, 15, 16, 31, 32, 63, 64, 127, 128, 255, 256, 511, 512, 2047,
         2048, 2049, 4095, 4096)


def _slots(seed: int, B: int, P: int, block: int, pattern: str,
           met_dtype=np.uint8):
    """Seeded scored slots as K2's slot entry leaves them: keep flags by
    ``pattern`` ("none", "all", "edges" or "random"), query-major queries,
    random rows and metrics (uint8, or int32 up to 2**20 as from L 256),
    per-query frequency maxima, the hit total, and the kept slots of each
    block of ``block`` slots."""
    rng = np.random.default_rng(seed)
    if pattern == "none":
        keep = np.zeros(P, bool)
    elif pattern == "all":
        keep = np.ones(P, bool)
    elif pattern == "edges":
        keep = rng.random(P) < 0.01
        keep[[e for e in EDGES if e < P] + [P - 1]] = True
    else:
        keep = rng.random(P) < 0.3
        keep[rng.random(P) < 0.02] = True
    q = np.sort(rng.integers(0, B, P)).astype(np.int32)
    pc = rng.integers(0, 1 << 20, P).astype(np.int32)
    met = rng.integers(0, 256 if met_dtype == np.uint8 else 1 << 20,
                       (5, P)).astype(met_dtype)
    max_freq = rng.integers(1, 1 << 40, B).astype(np.int64)
    keep_t = torch.from_numpy(keep)
    counts = torch.nn.functional.pad(keep_t, (0, -P % block)).view(
        -1, block).sum(1, dtype=torch.int32)
    return (keep_t, counts, block, torch.from_numpy(q), torch.from_numpy(pc),
            torch.from_numpy(met), torch.from_numpy(max_freq),
            torch.tensor(P + 5, dtype=torch.int64))


def _p2(rule: str, total: int, P: int) -> int:
    return {"over": total + 37, "equal": total, "under": max(1, total // 3),
            "beyond": P + 3000, "one": 1}[rule]


# (B, P, K2's block, keep pattern, P2 rule)
CASES = [
    (13, 2048, 128, "none", "over"),
    (13, 2048, 128, "all", "equal"),
    (13, 2048, 64, "all", "under"),  # every slot kept, most dropped
    (13, 6144, 128, "edges", "over"),
    (13, 6144, 64, "edges", "under"),
    (13, 6144, 128, "edges", "one"),
    (13, 1000, 128, "random", "over"),  # P not a multiple of the block
    (13, 1000, 64, "random", "under"),
    (13, 1000, 64, "random", "beyond"),  # P2 above P: fill past P
    (13, 4197, 128, "random", "equal"),
    (4096, 9001, 128, "random", "over"),
    (4096, 9001, 64, "random", "under"),
    (4096, 2048, 128, "none", "beyond"),
]


@pytest.mark.parametrize("met_dtype", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("B,P,block,pattern,rule", CASES)
def test_host_compact_equals_plain_and_jax(host_compact, host_compact_flat, B,
                                           P, block, pattern, rule,
                                           met_dtype):
    """uint8 metrics (below L 256) and int32 ones (from L 256, the JAX
    pipeline's rule), each kept at its width through the buffer."""
    args = _slots(B + P + block, B, P, block, pattern, met_dtype)
    keep, counts, _, q, pc, met, max_freq, total_match = args
    total = int(keep.sum())
    P2 = _p2(rule, total, P)
    want = compact_survivors_plain(*args, P2)
    got = host_compact(*args, P2)
    names = ("o_q", "o_c", "o_ld", "o_lcs", "o_pf", "o_sf", "o_case",
             "max_freq", "total_match", "total_keep")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    assert int(got[9]) == total and int(got[8]) == P + 5
    n = min(total, P2)
    assert (got[0][n:] == B).all() and (got[1][n:] == 0).all()
    # the same bytes as the plain outputs packed for the host
    assert torch.equal(host_compact_flat(*args, P2), ppl._pack(want)[0])
    # the JAX core's compaction and fill of the same payloads
    fills = (B, 0, 0, 0, 0, 0, 0)
    jax_out = _jax_compact(jnp.asarray(keep.numpy()),
                           tuple(jnp.asarray(x.numpy()) for x in (
                               q, pc, *met)), P2, fills)
    for name, g, w in zip(names, got, jax_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("met_dtype", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
def test_pack_passes_the_kernels_buffer_on(host_compact_flat, met_dtype):
    """K4's outputs are views of one buffer in ``_pack``'s order: ``_pack``
    returns that buffer, not a copy, with the layout ``_unpack`` reads; at
    uint8 and at int32 metrics."""
    args = _slots(1, 13, 1000, 128, "random", met_dtype)
    P2 = 300
    flat = host_compact_flat(*args, P2)
    views = ppl._output_views(flat, 13, P2, args[5].dtype)
    assert flat.numel() == 8 * 15 + (8 + 5 * args[5].element_size()) * P2
    packed, layout = ppl._pack(views)
    assert packed.data_ptr() == flat.data_ptr()
    assert packed.numel() == flat.numel() and torch.equal(packed, flat)
    # separate tensors are still concatenated, in the same layout
    plain = compact_survivors_plain(*args, P2)
    copy, plain_layout = ppl._pack(plain)
    assert copy.data_ptr() not in [t.data_ptr() for t in plain]
    assert torch.equal(copy, flat) and layout == plain_layout
    for g, w in zip(ppl._unpack(flat, layout), views):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_compact_cpu_takes_the_plain_version():
    args = _slots(2, 13, 1000, 64, "random")
    before = compact_survivors.launches
    got = compact_survivors(*args, 100)
    want = compact_survivors_plain(*args, 100)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    keep, counts, block, q, pc, met, max_freq, total_match = args
    bad = [
        (keep.int(), counts, block, q, pc, met, max_freq, total_match),
        (keep, counts[:-1], block, q, pc, met, max_freq, total_match),
        (keep, counts, 128, q, pc, met, max_freq, total_match),
        (keep, counts, block, q.long(), pc, met, max_freq, total_match),
        (keep, counts, block, q, pc[:-1], met, max_freq, total_match),
        (keep, counts, block, q, pc, met[:4], max_freq, total_match),
        (keep, counts, block, q, pc, met.long(), max_freq, total_match),
        (keep, counts, block, q, pc, met.t().contiguous().t(), max_freq,
         total_match),  # not contiguous
        (keep, counts, block, q, pc, met, max_freq.int(), total_match),
        (keep, counts, block, q, pc, met, max_freq, total_match[None]),
    ]
    for b in bad:
        with pytest.raises(ValueError, match="compact_survivors"):
            compact_survivors(*b, 100)
    # a tensor on neither the CPU nor a card raises: no fallback
    with pytest.raises(ValueError, match="unsupported device"):
        compact_survivors(*(t.to("meta") if torch.is_tensor(t) else t
                            for t in args), 100)
    assert compact_survivors.launches == before


def _jax_planes(q_counts, A: int, T: int):
    """The JAX core's query planes (analiticcl_tpu/ops/pipeline.py:
    402-408), on JAX's CPU backend, in the port's threshold-major column
    order (``plane_columns``: the JAX planes are letter-major)."""
    B = q_counts.shape[0]
    t_levels = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    return np.asarray((jnp.minimum(jnp.asarray(q_counts), T)[:, :, None]
                       > t_levels).reshape(B, A * T).astype(jnp.int8)
                      )[:, plane_columns(A, T)]


@pytest.mark.parametrize("B,A,T,at_pad", [
    (13, 30, 7, 224),  # 210 columns padded to 224
    (4096, 26, 7, 192),
    (8, 8, 4, 32),  # no padding
    (13, 5, 3, 16),  # a row of one 16-byte piece
    (1000, 30, 7, 224),  # groups of 18 rows, the last one short
    (5, 300, 15, 4512),  # a row of more pieces than a block has threads
    (40, 30, 55, 1664),  # a 1,000-letter entry's planes: groups of 2 rows
    (9, 30, 200, 6016),  # groups of one row of 376 pieces
])
def test_host_planes_equal_plain_and_jax(host_planes, B, A, T, at_pad):
    rng = np.random.default_rng(B + A)
    # counts up to T + 3: above the plane depth, the clamp's case
    q_counts = rng.integers(0, T + 4, (B, A)).astype(np.int32)
    q_counts[rng.random((B, A)) < 0.5] = 0
    idx = SimpleNamespace(at=A * T, bins=torch.zeros((1, at_pad),
                                                     dtype=torch.int8))
    qc = torch.from_numpy(q_counts)
    totals = torch.full((2, B), 9, dtype=torch.int32)
    got = host_planes(idx, qc, totals)
    assert (totals == 0).all()
    totals.fill_(9)
    want = query_planes(idx, qc, totals)
    assert (totals == 0).all()
    assert got.dtype == want.dtype == torch.int8
    assert torch.equal(got, want)
    assert torch.equal(want, query_planes_plain(idx, qc))
    np.testing.assert_array_equal(got[:, :A * T].numpy(),
                                  _jax_planes(q_counts, A, T))
    assert (got[:, A * T:] == 0).all()
    assert int(got.sum()) > 0


def test_planes_cpu_take_the_plain_version():
    idx = SimpleNamespace(at=210, bins=torch.zeros((1, 224),
                                                   dtype=torch.int8))
    qc = torch.randint(0, 9, (16, 30), dtype=torch.int32)
    before = query_planes.launches
    assert torch.equal(query_planes(idx, qc), query_planes_plain(idx, qc))
    for args in [(qc.long(),), (qc.t(),),
                 (qc, torch.zeros(2, 15, dtype=torch.int32)),
                 (qc, torch.zeros(2, 16, dtype=torch.int64))]:
        with pytest.raises(ValueError, match="query_planes"):
            query_planes(idx, *args)
    meta = SimpleNamespace(at=210, bins=idx.bins.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        query_planes(meta, qc.to("meta"))
    assert query_planes.launches == before


def test_core_through_every_host_kernel_equals_jax(batch, host_resolve,
                                                   host_slots_lib,
                                                   host_compact, host_planes,
                                                   monkeypatch):
    """The CPU core with K5, K3, K2's slot entry (its scoring epilogue) and
    K4 replaced by their host builds: the stageA and compact_sum probes
    and the outputs equal the JAX core's, at a budget above the totals and
    one below them (survivors dropped past P2)."""
    monkeypatch.setattr(ppl, "query_planes", host_planes)
    monkeypatch.setattr(ppl, "resolve_pairs", host_resolve)
    monkeypatch.setattr(ppl, "dl_lcs_slots", host_slots_lib)
    monkeypatch.setattr(ppl, "compact_survivors", host_compact)
    for P, P2 in _budgets(batch):
        for stop in ("stageA", "compact_sum"):
            _assert_probes_equal(_port(batch, stop, P, P2),
                                 _jax(batch, stop, P, P2), stop)
        _assert_outputs_equal(_port(batch, None, P, P2),
                              _jax(batch, None, P, P2))
