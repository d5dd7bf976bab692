"""The slot resolve (kernel K3, ``csrc/resolve.cu``) and K2's slot entry
inside the port's query core.

* K3's per-query expansion, compiled as plain C++ with
  ``-DANALITICCL_HOST_TEST`` (the kernel's nibble writes and slot values,
  the warps' prefix sums walked in order), equals ``resolve_pairs_plain``
  exactly on seeded hit bits: no hits, totals below and above the budget
  (overflow: hits past P dropped, the total still counted), several band
  tiles, query tiles of 8 under batches that are not powers of two, and
  more 128-row blocks per query than a block of the kernel scans at once.
* ``resolve_pairs`` takes the plain version for CPU tensors, launches
  nothing there, and raises on inputs the kernel does not take.
* The port's CPU core through both wrappers equals the JAX ``_query_core``
  (the Pallas kernels in interpret mode, as ``test_torch_profiling.py``
  runs it) exactly, tolerance 0: the ``resolve`` and ``gather_dl`` probes
  and the outputs, at a budget above the hit total and one below it. With
  the wrappers replaced by the two kernels' host builds (K2's slot entry
  with its scoring epilogue, as the main path runs it), the ``resolve``
  and ``score`` probes and the outputs are still exact (the ``gather_dl``
  probe sums DL values above the window, where the kernel's DP and the
  plain one may differ by contract, so it is held on the plain route
  only).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import analiticcl_tpu_torch.ops.pipeline as ppl
from analiticcl_tpu_torch.ops.pipeline import (
    query_core,
    resolve_pairs,
    resolve_pairs_plain,
)
from analiticcl_tpu_torch.ops.stage_a import ROW_BLOCK, _b_tile
from test_torch_dl import host_slots_fn
from test_torch_profiling import (  # noqa: F401  (fixtures)
    _assert_probes_equal,
    batch,
    jax_static,
)
from test_torch_query_core import (  # noqa: F401  (fixtures)
    P_BUDGET,
    _jax_core,
    freqs,
    jax_model,
    words,
)

torch.set_num_threads(2)

CSRC = Path(ppl.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module")
def host_resolve(tmp_path_factory):
    """``csrc/resolve.cu`` built for the host, as a function with
    ``resolve_pairs``'s arguments and outputs."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    so = tmp_path_factory.mktemp("resolvehost") / "libresolvehost.so"
    subprocess.run(
        [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST", "-shared",
         "-fPIC", "-o", str(so), str(CSRC / "resolve.cu")],
        check=True, capture_output=True,
    )
    fn = ctypes.CDLL(str(so)).analiticcl_resolve_host
    ptr = ctypes.c_void_p

    def run(packed_q, counts_t, nmatch, start_blk, Ni_pad, P):
        B = packed_q.shape[0]
        M_band = counts_t.shape[0]
        slots = torch.full((3, P), -7, dtype=torch.int32)
        valid = torch.zeros(P, dtype=torch.bool)
        total = torch.full((), -7, dtype=torch.int64)
        ins = [t.contiguous() for t in (packed_q, counts_t, nmatch,
                                        start_blk)]
        fn(*[ptr(t.data_ptr()) for t in ins],
           *[ptr(t.data_ptr()) for t in (slots[0], slots[1], slots[2],
                                         valid, total)],
           ctypes.c_int(B), ctypes.c_int(M_band),
           ctypes.c_int(_b_tile(B, Ni_pad)), ctypes.c_int(P))
        return slots[0], slots[1], slots[2], valid, total

    return run


def _stage_a_bits(seed: int, B: int, nb_band: int, Ni_pad: int,
                  density: float):
    """Seeded hit bits with their per-128-row counts and totals, as stage
    A gives them, and a band start per query tile. A fifth of the queries
    have no hits, and at a density above 0 a few have dense runs that fill
    whole blocks."""
    rng = np.random.default_rng(seed)
    Nb = nb_band * ROW_BLOCK
    hits = rng.random((B, Nb)) < density
    hits[rng.random(B) < 0.2] = False
    dense = (rng.random(B) < 0.05) & (density > 0)
    lo = rng.integers(0, Nb - 300, size=B)
    for q in np.nonzero(dense)[0]:
        hits[q, lo[q]:lo[q] + 300] = True
    packed = np.packbits(hits, axis=1, bitorder="little")
    counts_t = hits.reshape(B, Nb // 128, 128).sum(2).T.astype(np.int32)
    nmatch = hits.sum(1).astype(np.int32)
    bt = _b_tile(B, Ni_pad)
    start = rng.integers(0, Ni_pad // ROW_BLOCK - nb_band + 1, size=B // bt)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        packed, counts_t, nmatch, start.astype(np.int32)))


# (B, nb_band, Ni_pad, density, budget): budget "over" gives P above the
# total, "under" a third of it (overflow), "none" a budget with no hits;
# "first", "middle" and "last" a budget that runs out inside the hits of
# the first, a middle or the last query that has any (_overflow_at)
CASES = [
    (8, 1, 4096, 0.0, "none"),
    (8, 1, 4096, 0.02, "over"),
    (8, 1, 4096, 0.02, "under"),
    (24, 2, 8192, 0.01, "over"),  # bt 8: three band tiles
    (3000, 1, 8192, 0.002, "under"),  # bt 8: 375 band tiles
    (2048, 1, 262_144, 0.003, "over"),  # bt 256 from 262,144 rows
    (8, 40, 65_536, 0.004, "over"),  # 320 blocks of 128 rows per query
    (8, 40, 65_536, 0.004, "under"),
    # B not a multiple of the kernel's 8-query tile: bt 4, so each tile
    # straddles two band tiles; bt 1 (every query its own band)
    (20, 1, 4096, 0.02, "over"),
    (20, 1, 4096, 0.02, "middle"),
    (13, 2, 8192, 0.01, "over"),
    (13, 2, 8192, 0.01, "last"),
    (24, 2, 8192, 0.01, "first"),
    (3000, 1, 8192, 0.002, "middle"),
    (3000, 1, 8192, 0.002, "last"),
    (8, 40, 65_536, 0.004, "first"),
]


def _overflow_at(nmatch, where: str) -> int:
    """A budget that ends halfway through the hits of the first, a middle
    or the last query with hits."""
    n = nmatch.long()
    qs = torch.nonzero(n).flatten().tolist()
    q = {"first": qs[0], "middle": qs[len(qs) // 2], "last": qs[-1]}[where]
    return int(n[:q].sum()) + max(1, int(n[q]) // 2)


@pytest.mark.parametrize("B,nb_band,Ni_pad,density,budget", CASES)
def test_host_resolve_equals_plain(host_resolve, B, nb_band, Ni_pad, density,
                                   budget):
    args = _stage_a_bits(B * nb_band + len(budget), B, nb_band, Ni_pad,
                         density)
    total = int(args[2].sum())
    assert (total == 0) == (budget == "none")
    P = ({"none": 2048, "over": total + 37, "under": max(1, total // 3)}
         .get(budget) or _overflow_at(args[2], budget))
    assert (P < total) == (budget not in ("none", "over"))
    want = resolve_pairs_plain(*args, Ni_pad, P)
    got = host_resolve(*args, Ni_pad, P)
    for name, g, w in zip(("q", "pc_band", "pc", "valid", "total"), got,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    assert int(got[4]) == total
    assert int(got[3].sum()) == min(total, P)


def test_resolve_cpu_takes_the_plain_version():
    args = _stage_a_bits(5, 16, 1, 4096, 0.01)
    before = resolve_pairs.launches
    got = resolve_pairs(*args, 4096, 500)
    want = resolve_pairs_plain(*args, 4096, 500)
    assert resolve_pairs.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    packed, counts_t, nmatch, start = args
    bad = [
        (packed.long(), counts_t, nmatch, start),
        (packed, counts_t.long(), nmatch, start),
        (packed, counts_t, nmatch[:-1], start),
        (packed, counts_t.t(), nmatch, start),  # not contiguous
        (packed[:, :-16], counts_t, nmatch, start),
        (packed, counts_t, nmatch, torch.cat([start, start])),
    ]
    for b in bad:
        with pytest.raises(ValueError, match="resolve_pairs"):
            resolve_pairs(*b, 4096, 500)
    # a tensor on neither the CPU nor a card raises: no fallback
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_pairs(*(t.to("meta") for t in args), 4096, 500)
    assert resolve_pairs.launches == before


def _budgets(batch):
    total_match, total_keep = batch[-1]
    return [(P_BUDGET, P_BUDGET), (total_match // 2, total_keep // 4)]


def _jax(batch, stop, P, P2):
    pipe, st, _, _, static, _ = batch
    return [np.asarray(w) for w in _jax_core(
        *pipe._idx, *st["args"], **jax_static(static), P=P, P2=P2,
        stop_stage=stop)]


def _port(batch, stop, P, P2):
    _, _, index, args, static, _ = batch
    return query_core(index, *args, **static, P=P, P2=P2, stop_stage=stop)


def _assert_outputs_equal(got, want):
    assert len(got) == len(want) == 10
    for g, w in zip(got[:7], want[:7]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[7].numpy(), want[7].astype(np.int64))
    assert [int(x) for x in got[8:]] == [int(x) for x in want[8:]]


@pytest.fixture
def counted(monkeypatch):
    """Calls of the two wrappers from the core, by name."""
    calls = {"resolve_pairs": 0, "dl_lcs_slots": 0}
    for name in calls:
        fn = getattr(ppl, name)

        def counting(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ppl, name, counting)
    return calls


def test_core_through_the_wrappers_equals_jax(batch, counted):
    """The CPU core calls both wrappers once per call (the plain versions
    behind them) and equals the JAX core exactly at the resolve and
    gather_dl stops and in its outputs."""
    for P, P2 in _budgets(batch):
        for stop in ("resolve", "gather_dl"):
            _assert_probes_equal(_port(batch, stop, P, P2),
                                 _jax(batch, stop, P, P2), stop)
        _assert_outputs_equal(_port(batch, None, P, P2),
                              _jax(batch, None, P, P2))
    assert counted == {"resolve_pairs": 6, "dl_lcs_slots": 4}


def test_core_through_the_host_kernels_equals_jax(batch, host_resolve,
                                                  host_slots_lib,
                                                  monkeypatch):
    """The same core with K3 and K2's slot entry (its scoring epilogue on
    the main path) replaced by their host builds: the resolve and score
    probes and the outputs equal the JAX core's."""
    monkeypatch.setattr(ppl, "resolve_pairs", host_resolve)
    monkeypatch.setattr(ppl, "dl_lcs_slots", host_slots_lib)
    for P, P2 in _budgets(batch):
        for stop in ("resolve", "score"):
            _assert_probes_equal(_port(batch, stop, P, P2),
                                 _jax(batch, stop, P, P2), stop)
        _assert_outputs_equal(_port(batch, None, P, P2),
                              _jax(batch, None, P, P2))


@pytest.fixture(scope="module")
def host_slots_lib(tmp_path_factory):
    """K2's slot entry built for the host, with ``dl_lcs_slots``'s
    arguments and outputs: the metrics instance, and with ``score`` the
    scoring epilogue the core's main path runs."""
    return host_slots_fn(tmp_path_factory.mktemp("slotshost"))
