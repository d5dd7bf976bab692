"""The port's stage-B metrics (analiticcl_tpu_torch/ops/dl.py) against the JAX
package's.

Windowed DL is exact only up to the window: every comparison of DL values
clips both sides at window + 1 (the contract of dl_jax.dl_metrics_windowed).
LCS, prefix and suffix are compared exactly. Inputs come from the pair
generator of test_pallas.py with a fixed numpy seed.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analiticcl_tpu.ops import distance as oracle
from analiticcl_tpu.ops.dl_jax import (
    affix_metrics_aligned as jax_affix,
    dl_metrics_windowed,
)
from analiticcl_tpu.ops.dl_pallas import BLOCK, dl_lcs_pallas
from analiticcl_tpu_torch.ops import dl as tdl
from test_pallas import _random_pairs

torch.set_num_threads(2)


def _reversed_aligned(x, lens, pad):
    out = np.full_like(x, pad)
    for p, n in enumerate(lens):
        out[p, :n] = x[p, :n][::-1]
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", [8, 24])
def test_plain_matches_jax_windowed(window, L):
    rng = np.random.default_rng(100 * window + L)
    a, al, b, bl = _random_pairs(rng, 384, L, sigma=6)
    want = [np.asarray(x) for x in dl_metrics_windowed(
        jnp.asarray(a), jnp.asarray(al), jnp.asarray(b), jnp.asarray(bl),
        L, window,
    )]
    got = [x.numpy() for x in tdl.dl_metrics_windowed_plain(*_t(a, al, b, bl), L, window)]
    clip = window + 1
    np.testing.assert_array_equal(
        np.minimum(got[0], clip), np.minimum(want[0], clip)
    )
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)

    a_rev = _reversed_aligned(a, al, tdl.PAD_A)
    b_rev = _reversed_aligned(b, bl, tdl.PAD_B)
    jpf, jsf = jax_affix(*map(jnp.asarray, (a, al, b, bl, a_rev, b_rev)))
    tpf, tsf = tdl.affix_metrics_aligned(*_t(a, al, b, bl, a_rev, b_rev))
    np.testing.assert_array_equal(tpf.numpy(), np.asarray(jpf))
    np.testing.assert_array_equal(tsf.numpy(), np.asarray(jsf))
    # the aligned affixes agree with the DP's own prefix/suffix
    np.testing.assert_array_equal(tpf.numpy(), got[2])
    np.testing.assert_array_equal(tsf.numpy(), got[3])


@pytest.mark.parametrize("window", [3, 12])
def test_empty_strings(window):
    L = 8
    rng = np.random.default_rng(window)
    a, al, b, bl = _random_pairs(rng, 64, L, sigma=4)
    al[:16] = 0  # empty query
    a[:16] = tdl.PAD_A
    bl[8:24] = 0  # empty candidate (and both empty for rows 8..15)
    b[8:24] = tdl.PAD_B
    ld, lcs, pf, sf = (x.numpy() for x in tdl.dl_metrics_windowed_plain(
        *_t(a, al, b, bl), L, window))
    jl, jc, jp, js = (np.asarray(x) for x in dl_metrics_windowed(
        *map(jnp.asarray, (a, al, b, bl)), L, window))
    clip = window + 1
    np.testing.assert_array_equal(np.minimum(ld, clip), np.minimum(jl, clip))
    for g, w in ((lcs, jc), (pf, jp), (sf, js)):
        np.testing.assert_array_equal(g, w)
    # empty-side shortcuts: the distance is the other side's length
    np.testing.assert_array_equal(ld[:8], bl[:8])
    np.testing.assert_array_equal(ld[8:24], al[8:24])
    assert (lcs[:24] == 0).all() and (pf[:24] == 0).all() and (sf[:24] == 0).all()


def test_plain_matches_pallas_interpret():
    """One 1,024-pair block through the Pallas kernel's interpreter at W=3."""
    L, window = 8, 3
    rng = np.random.default_rng(11)
    a, al, b, bl = _random_pairs(rng, BLOCK, L, sigma=6)
    ld_p, lcs_p = dl_lcs_pallas(
        *map(jnp.asarray, (a, al, b, bl)), L, window, interpret=True
    )
    ld, lcs = tdl.dl_lcs(*_t(a, al, b, bl), L, window)
    clip = window + 1
    np.testing.assert_array_equal(
        np.minimum(ld.numpy(), clip), np.minimum(np.asarray(ld_p), clip)
    )
    np.testing.assert_array_equal(lcs.numpy(), np.asarray(lcs_p))


def test_cpu_tensors_take_the_plain_version():
    L, window = 8, 6
    rng = np.random.default_rng(3)
    a, al, b, bl = _random_pairs(rng, 40, L, sigma=5)
    before = tdl.dl_lcs.launches
    ld, lcs = tdl.dl_lcs(*_t(a, al, b, bl), L, window)
    pl, pc, _, _ = tdl.dl_metrics_windowed_plain(*_t(a, al, b, bl), L, window)
    assert tdl.dl_lcs.launches == before
    assert torch.equal(ld, pl) and torch.equal(lcs, pc)
    with pytest.raises(ValueError):
        tdl.dl_lcs(*_t(a.astype(np.int64), al, b, bl), L, window)
    with pytest.raises(ValueError):
        tdl.dl_lcs(*_t(a, al, b, bl), L + 1, window)


def test_cpu_wide_tensors_take_the_plain_version():
    """Above L 64 too, CPU tensors take the plain version: no launch is
    counted, of either path."""
    L, window = 80, 3
    rng = np.random.default_rng(4)
    a, al, b, bl = _random_pairs(rng, 40, L, sigma=5)
    assert max(al.max(), bl.max()) > tdl.NARROW_LEN
    before = (tdl.dl_lcs.launches, tdl.wide_path.launches)
    ld, lcs = tdl.dl_lcs(*_t(a, al, b, bl), L, window)
    pl, pc, _, _ = tdl.dl_metrics_windowed_plain(*_t(a, al, b, bl), L, window)
    assert (tdl.dl_lcs.launches, tdl.wide_path.launches) == before
    assert torch.equal(ld, pl) and torch.equal(lcs, pc)


def _host_dp(tmp_path, entry="analiticcl_dl_lcs_host"):
    """The CUDA kernel's per-pair DP (csrc/dl_lcs.cu, compiled as plain C++
    with -DANALITICCL_HOST_TEST) as a function of numpy pairs: ``entry`` is
    the kernel's byte-cell instance or ``analiticcl_dl_lcs_host_int``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    src = Path(tdl.__file__).resolve().parent.parent / "csrc" / "dl_lcs.cu"
    so = tmp_path / "libdlhost.so"
    if not so.exists():
        subprocess.run(
            [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST",
             "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
             str(src)],
            check=True, capture_output=True,
        )
    fn = getattr(ctypes.CDLL(str(so)), entry)
    ptr = ctypes.c_void_p

    def host(a, al, b, bl, L, W):
        P = len(al)
        ld = np.zeros(P, np.int32)
        lcs = np.zeros(P, np.int32)
        fn(
            *[ptr(x.ctypes.data) for x in (a, al, b, bl, ld, lcs)],
            ctypes.c_int(P), ctypes.c_int(L), ctypes.c_int(W),
        )
        return ld, lcs

    return host


@pytest.fixture(scope="module")
def host_dp_lib(tmp_path_factory):
    path = tmp_path_factory.mktemp("dlhost")
    return _host_dp(path), _host_dp(path, "analiticcl_dl_lcs_host_int")


def _adversarial_pairs(rng, L):
    """Pairs that push the DP's stored values up: disjoint alphabets, one
    repeated character, identical strings, full length against lengths 0-3
    (both ways), both empty, and random lengths of unrelated strings."""
    rows = []

    def add(sa, sb):
        rows.append((list(sa), list(sb)))

    for la, lb in ((L, L), (L, L // 2), (L // 3, L), (L, 1), (1, L)):
        add(rng.integers(1, 6, la), rng.integers(10, 16, lb))  # disjoint
        add([3] * la, [3] * lb)  # one repeated character
        add([3] * la, [4] * lb)
    for n in (L, L - 1, L // 2, 2):
        s = rng.integers(1, 4, n)
        add(s, s)  # identical
        add(s, s[::-1])
    for short in range(4):
        long_ = rng.integers(1, 8, L)
        add(long_, rng.integers(1, 8, short))
        add(rng.integers(1, 8, short), long_)
        add([5] * L, [5] * short)
    add([], [])
    for _ in range(40):
        add(rng.integers(1, 30, rng.integers(0, L + 1)),
            rng.integers(1, 30, rng.integers(0, L + 1)))
    P = len(rows)
    a = np.full((P, L), tdl.PAD_A, np.int32)
    b = np.full((P, L), tdl.PAD_B, np.int32)
    al = np.zeros(P, np.int32)
    bl = np.zeros(P, np.int32)
    for p, (sa, sb) in enumerate(rows):
        al[p], bl[p] = len(sa), len(sb)
        a[p, :len(sa)] = sa
        b[p, :len(sb)] = sb
    return a, al, b, bl


@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", [8, 24, 32, 64])
def test_kernel_byte_cells_equal_int_cells(host_dp_lib, L, window):
    """The kernel's DP on byte cells equals the same DP on int cells exactly,
    above the window too (no clipping), on random and adversarial pairs;
    both equal the oracle with DL clipped at window + 1."""
    host_u8, host_int = host_dp_lib
    rng = np.random.default_rng(31 * L + window)
    adv = _adversarial_pairs(rng, L)
    rnd = _random_pairs(rng, 160, L, sigma=6)
    for a, al, b, bl in (adv, rnd):
        ld8, lcs8 = host_u8(a, al, b, bl, L, window)
        ldi, lcsi = host_int(a, al, b, bl, L, window)
        np.testing.assert_array_equal(ld8, ldi)
        np.testing.assert_array_equal(lcs8, lcsi)
        assert (ld8 <= window).any()
        assert (ld8 > window).any() or window >= L  # DL <= L at L 8, W 12
        for p in range(len(al)):
            sa = a[p, : al[p]].tolist()
            sb = b[p, : bl[p]].tolist()
            true_ld = oracle.damerau_levenshtein(sa, sb, 4 * L)
            assert min(int(ld8[p]), window + 1) == min(true_ld, window + 1)
            assert lcs8[p] == oracle.longest_common_substring_length(sa, sb)


def test_kernel_pair_dp_on_host(tmp_path):
    """The CUDA kernel's per-pair DP (csrc/dl_lcs.cu, compiled as plain C++
    with -DANALITICCL_HOST_TEST) against the scalar oracle and the Pallas
    interpreter. The launch itself runs only on a card."""
    host = _host_dp(tmp_path)

    for window in (3, 6, 12):
        for L in (8, 24):
            rng = np.random.default_rng(7 * window + L)
            a, al, b, bl = _random_pairs(rng, 300, L, sigma=6)
            ld, lcs = host(a, al, b, bl, L, window)
            for p in range(len(al)):
                sa = a[p, : al[p]].tolist()
                sb = b[p, : bl[p]].tolist()
                true_ld = oracle.damerau_levenshtein(sa, sb, 4 * L)
                assert min(int(ld[p]), window + 1) == min(true_ld, window + 1)
                assert lcs[p] == oracle.longest_common_substring_length(sa, sb)
    rng = np.random.default_rng(5)
    a, al, b, bl = _random_pairs(rng, BLOCK, 8, sigma=6)
    ld_p, lcs_p = dl_lcs_pallas(*map(jnp.asarray, (a, al, b, bl)), 8, 3,
                                interpret=True)
    ld, lcs = host(a, al, b, bl, 8, 3)
    # same banded DP as the Pallas kernel: equal even above the window
    np.testing.assert_array_equal(ld, np.asarray(ld_p))
    np.testing.assert_array_equal(lcs, np.asarray(lcs_p))


# ---- K2's slot entry: the pair strings read by row from the tables ----

def host_slots_fn(build_dir):
    """K2's slot entry (``analiticcl_dl_lcs_slots_host``: the kernel's
    per-slot loads, affixes and byte-cell DP; with ``score`` its scoring
    epilogue too, ``analiticcl_dl_lcs_slots_scored_host``) built for the
    host, as a function with ``dl_lcs_slots``'s arguments and outputs
    (``SlotMetrics``, or ``SlotScore`` with ``score``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    src = Path(tdl.__file__).resolve().parent.parent / "csrc" / "dl_lcs.cu"
    so = Path(build_dir) / "libdlslots.so"
    if not so.exists():
        subprocess.run(
            [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST",
             "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
             str(src)],
            check=True, capture_output=True,
        )
    lib = ctypes.CDLL(str(so))
    fn, scored = lib.analiticcl_dl_lcs_slots_host, \
        lib.analiticcl_dl_lcs_slots_scored_host

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    def host(index, q_norms, q_lens, k_ed, q_first_lower, q, pc, valid,
             window, score=None):
        P, (B, L) = q.shape[0], q_norms.shape
        ins = [ptr(t.contiguous()) for t in (
            q, pc, valid, index.norms2, index.norm_lens, index.first_lower,
            q_norms, q_lens, q_first_lower, k_ed)]
        ins.append(ctypes.c_int(q_norms.element_size()))
        size = [ctypes.c_int(P), ctypes.c_int(L), ctypes.c_int(window)]
        if score is None:
            metrics = torch.full((6, P), -7, dtype=torch.int32)
            same_first = torch.zeros(P, dtype=torch.bool)
            fn(*ins, ptr(metrics), ptr(same_first), *size)
            return tdl.SlotMetrics(*metrics.unbind(), same_first)
        s = score
        keep = torch.ones(P, dtype=torch.bool)
        met = torch.full((5, P), 77, dtype=tdl.met_dtype(L))
        max_freq = (torch.zeros if s.freqs is not None else torch.ones)(
            B, dtype=torch.int64)
        f32 = torch.full((P,), float("nan")) if s.want_score else None
        counts = torch.full((-(-P // tdl.slot_block(L)),), -7,
                            dtype=torch.int32)
        scored(*ins, ptr(s.pc_band), ptr(s.exact_q),
               ctypes.c_int(s.exact_q.shape[1]), ptr(s.use_exact),
               ptr(s.freqs), ptr(s.weights), ptr(s.thr), ptr(keep), ptr(met),
               ptr(max_freq if s.freqs is not None else None), ptr(f32),
               ptr(counts), *size)
        return tdl.SlotScore(keep, met, max_freq, f32, counts)

    return host


@pytest.fixture(scope="module")
def host_slots(tmp_path_factory):
    return host_slots_fn(tmp_path_factory.mktemp("dlslots"))


def _slot_tables(seed: int, L: int, dtype, B: int = 48, P: int = 240):
    """Seeded tables laid out as ``convert.py`` lays out the index
    (forward | reversed norms, zero past each length) and as the pipeline
    lays out a batch, and ``P`` slots: most pair a query with a row made
    from it by a few edits (distances on both sides of the window), the
    rest with a random row; about one in seven is invalid, the last four
    too. int32 tables take symbols from 110 to 149, across the 120 at
    which ``convert.py`` stops using int8."""
    rng = np.random.default_rng(seed)
    lo, hi = (110, 150) if dtype == np.int32 else (0, 40)

    def word(n):
        return list(rng.integers(lo, hi, n))

    def edited(s):
        s = list(s)
        for _ in range(rng.integers(0, 6)):
            op = rng.integers(0, 4)
            k = int(rng.integers(0, len(s) + 1))
            if op == 0 and k < len(s):
                s[k] = int(rng.integers(lo, hi))
            elif op == 1 and k + 1 < len(s):
                s[k], s[k + 1] = s[k + 1], s[k]
            elif op == 2 and k < len(s):
                del s[k]
            elif op == 3:
                s.insert(k, int(rng.integers(lo, hi)))
        return s[:L]

    lens = rng.integers(0, L + 1, size=B)
    lens[:3] = (0, 1, L)
    qs = [word(n) for n in lens]
    rows = [edited(s) for s in qs] + [word(rng.integers(0, L + 1))
                                      for _ in range(B)]
    Ni = len(rows)
    norms2 = np.zeros((Ni, 2 * L), dtype)
    norm_lens = np.zeros(Ni, np.int32)
    for i, s in enumerate(rows):
        norm_lens[i] = len(s)
        norms2[i, :len(s)] = s
        norms2[i, L:L + len(s)] = s[::-1]
    q_norms = np.zeros((B, L), dtype)
    for i, s in enumerate(qs):
        q_norms[i, :len(s)] = s
    q = rng.integers(0, B, size=P)
    pc = np.where(rng.random(P) < 0.7, q, rng.integers(0, Ni, size=P))
    valid = rng.random(P) < 6 / 7
    valid[-4:] = False
    index = _slot_index(norms2, norm_lens, rng.random(Ni) < 0.5)
    batch = _t(q_norms, lens.astype(np.int32),
               rng.integers(0, 13, size=B).astype(np.int32),
               rng.random(B) < 0.5)
    return index, batch, _t(q.astype(np.int32), pc.astype(np.int32), valid)


def _slot_index(norms2, norm_lens, first_lower):
    """The index tables the slot entry reads, as a ``DeviceIndex`` holds
    them."""
    n2, nl, fl = _t(norms2, norm_lens, first_lower)
    return SimpleNamespace(norms2=n2, norm_lens=nl, first_lower=fl)


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", [8, 25, 32, 64])
def test_host_slot_entry_equals_plain(host_slots, host_dp_lib, L, window,
                                      dtype):
    """The slot entry's host build against the plain composition (the
    gathers, the plain DL and the affixes): LCS, prefix, suffix, query
    length, threshold and case flag exactly, DL clipped at window + 1 (the
    kernel's contract); and DL exactly against the kernel's DP on the
    gathered pair strings (the old entry's host build): the same DP on the
    same strings."""
    index, (q_norms, q_lens, k_ed, q_fl), (q, pc, valid) = _slot_tables(
        7 * L + window, L, dtype)
    got = host_slots(index, q_norms, q_lens, k_ed, q_fl, q, pc, valid,
                     window)
    want = tdl.dl_lcs_slots_plain(index, q_norms, q_lens, k_ed, q_fl, q, pc,
                                  valid, window)
    for name, g, w in zip(tdl.SlotMetrics._fields[1:], got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    clip = window + 1
    assert torch.equal(got[0].clamp(max=clip), want.ld.clamp(max=clip))
    pr = tdl.gather_pairs(index, q_norms, q_lens, k_ed, q_fl, q, pc, valid)
    ld_dp, lcs_dp = host_dp_lib[0](*(x.numpy() for x in (pr.a, pr.ql, pr.b,
                                                          pr.cl)), L, window)
    np.testing.assert_array_equal(got[0].numpy(), ld_dp)
    np.testing.assert_array_equal(got[1].numpy(), lcs_dp)
    v = valid.numpy()
    assert (got[0].numpy()[v] <= window).any()
    assert (got[0].numpy()[v] > window).any() or window >= L
    assert (got[0].numpy()[~v] == 0).all() and (got[4].numpy()[~v] == 0).all()


# weights (ld, lcs, prefix, suffix, case, sum): the defaults, and sets with
# zero weights, which gate their metrics to 0 (the case flag to true)
WEIGHT_SETS = {
    "default": (0.5, 0.125, 0.125, 0.125, 0.125, 1.0),
    "zeros": (1.0, 0.0, 0.5, 0.0, 0.0, 1.5),
    "case": (0.7, 0.3, 0.0, 0.25, 1.0, 2.25),
}


def _score_inputs(seed: int, index, B: int, P: int, weights: str):
    """Seeded epilogue inputs for the slots of :func:`_slot_tables`: band
    rows, exact bits (four bytes a query), per-query StopAtExactMatch
    flags, and Zipf-like frequencies, some above 2**24."""
    rng = np.random.default_rng(seed)
    nb8 = 4
    freqs = (2_000_000_000 // (rng.permutation(index.norm_lens.shape[0]) + 1))
    pc_band, exact_q, use_exact, freqs = _t(
        rng.integers(0, 8 * nb8, P).astype(np.int32),
        rng.integers(0, 256, (B, nb8)).astype(np.uint8), rng.random(B) < 0.5,
        freqs.astype(np.int64))
    return tdl.ScoreInputs(pc_band, exact_q, use_exact,
                           torch.tensor(WEIGHT_SETS[weights]),
                           torch.tensor(0.0), freqs, True)


@pytest.mark.parametrize("weights", list(WEIGHT_SETS))
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", [8, 25, 64])
def test_host_scored_slot_entry_equals_plain(host_slots, L, window, dtype,
                                             weights):
    """The slot entry's scoring epilogue (its host build, compiled without
    FMA contraction) against the plain score (``score_slots_plain``: the
    JAX core's f32 operations in torch), tolerance 0, with StopAtExactMatch
    on and off, with and without frequencies, and with the threshold set to
    one slot's score exactly (kept: the test is ``score >= thr``):
    - on the host build's own metrics, every output bit for bit: the keep
      flags, the gated uint8 metrics, the score, the int64 frequency
      maxima and the kept slots of each block (128 slots a block, 64 at
      L 64; 240 slots leave the last block partial);
    - against the whole plain route (the gathers, the plain DL, the
      affixes, the plain score), with every edit threshold within the
      window as the pipeline sets them: the keep flags and the frequency
      maxima, and the metrics and the score of the kept slots (above the
      window the two DPs may differ, by contract)."""
    index, (q_norms, q_lens, k_ed, q_fl), (q, pc, valid) = _slot_tables(
        13 * L + window, L, dtype)
    k_ed = k_ed.clamp(max=window)
    B, P = q_lens.shape[0], q.shape[0]
    base = _score_inputs(L + window, index, B, P, weights)
    args = (index, q_norms, q_lens, k_ed, q_fl, q, pc, valid, window)
    m = host_slots(*args)  # the host build's metrics
    assert (valid & (m.ld > m.ql)).any()
    for stop_exact in (False, True):
        for with_freq in (False, True):
            s = base._replace(use_exact=base.use_exact if stop_exact else None,
                              freqs=base.freqs if with_freq else None,
                              thr=torch.tensor(float("-inf")))
            # every slot within the edit tests passes at -inf; put the
            # threshold on the score of one of them
            sc = tdl.score_slots_plain(m, q, pc, valid, L, s)
            passing = torch.nonzero(sc.keep).flatten()
            k = int(passing[torch.argsort(sc.score[passing])[len(passing)
                                                              // 2]])
            s = s._replace(thr=sc.score[k].clone())
            got = host_slots(*args, score=s)
            want = tdl.score_slots_plain(m, q, pc, valid, L, s)
            assert want.met.dtype == tdl.met_dtype(L)
            for name, g, w in zip(tdl.SlotScore._fields, got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), name
            assert got.keep[k] and got.score[k] == s.thr
            assert 0 < int(got.keep.sum()) < int(sc.keep.sum())
            if with_freq:
                assert int(got.max_freq.max()) > 2**24
            else:
                assert (got.max_freq == 1).all()
            plain = tdl.dl_lcs_slots(*args, score=s)  # CPU: the plain route
            keep = got.keep
            assert torch.equal(plain.keep, keep)
            assert torch.equal(plain.max_freq, got.max_freq)
            assert torch.equal(plain.counts, got.counts)
            assert torch.equal(plain.met[:, keep], got.met[:, keep])
            assert torch.equal(plain.score[keep], got.score[keep])
    # a zero weight gates its metric to 0 (the case flag to 1)
    gated = [f for f, w in zip(("lcs", "pf", "sf", "same_first"),
                               WEIGHT_SETS[weights][1:5]) if w == 0]
    for row, name in enumerate(("lcs", "pf", "sf", "same_first"), 1):
        if name in gated:
            assert (got.met[row] == (1 if name == "same_first" else 0)).all()


def test_slot_entry_cpu_takes_the_plain_version():
    index, (q_norms, q_lens, k_ed, q_fl), (q, pc, valid) = _slot_tables(
        2, 16, np.int8)
    before = (tdl.dl_lcs.launches, tdl.dl_lcs_slots.launches)
    got = tdl.dl_lcs_slots(index, q_norms, q_lens, k_ed, q_fl, q, pc, valid, 6)
    want = tdl.dl_lcs_slots_plain(index, q_norms, q_lens, k_ed, q_fl, q, pc,
                                  valid, 6)
    assert (tdl.dl_lcs.launches, tdl.dl_lcs_slots.launches) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    good = dict(index=index, q_norms=q_norms, q_lens=q_lens, k_ed=k_ed,
                q_first_lower=q_fl, q=q, pc=pc, valid=valid)
    bad = [
        dict(q=q.long()), dict(pc=pc[:-1]), dict(valid=valid.int()),
        dict(q_norms=q_norms.int()),  # not the index's element type
        dict(q_lens=q_lens[:-1]), dict(k_ed=k_ed.long()),
        dict(index=_slot_index(index.norms2[:, :-2].numpy(),
                             index.norm_lens.numpy(),
                             index.first_lower.numpy())),
    ]
    for change in bad:
        with pytest.raises(ValueError, match="dl_lcs_slots"):
            tdl.dl_lcs_slots(**{**good, **change}, window=6)
    # a tensor on neither the CPU nor a card raises: no fallback
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v)
            for k, v in good.items() if k != "index"}
    meta_index = SimpleNamespace(**{k: getattr(index, k).to("meta") for k in (
        "norms2", "norm_lens", "first_lower")})
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.dl_lcs_slots(index=meta_index, **meta, window=6)
    assert (tdl.dl_lcs.launches, tdl.dl_lcs_slots.launches) == before


# ---- widths above 64: the byte path for pairs that fit, the wide path for
# the rest (one warp a pair in the kernel, its lanes walked on the host) ----

WIDE_LS = (65, 83, 100, 255, 256, 300, 1000, 1100)


def _wide_pairs(rng, L: int):
    """Pair strings at width ``L`` mixing both paths: near-identical pairs
    (a few substitutions, a transposition, an insertion or a deletion) of
    lengths above 64 and up to 64, pairs whose lengths differ by more than
    the band (their DL is the DP's ``big``), a long string against a short
    or empty one, both empty, and unrelated strings of random lengths."""
    rows = []

    def near(n):
        s = list(rng.integers(1, 6, n))
        t = list(s)
        for _ in range(rng.integers(0, 4)):
            k = int(rng.integers(0, len(t)))
            op = rng.integers(0, 4)
            if op == 0:
                t[k] = int(rng.integers(1, 6))
            elif op == 1 and k + 1 < len(t):
                t[k], t[k + 1] = t[k + 1], t[k]
            elif op == 2 and len(t) > 1:
                del t[k]
            elif len(t) < L:
                t.insert(k, int(rng.integers(1, 6)))
        return s, t[:L]

    for n in (L, L - 1, 65, 66, (L + 64) // 2, 64, 40, 8, 1):
        rows += [near(max(1, min(n, L))) for _ in range(3)]
    for la, lb in ((L, L - 20), (L - 20, L), (70, 40), (64, 50), (L, 1),
                   (1, L), (L, 0), (0, L), (0, 0)):
        la, lb = max(0, min(la, L)), max(0, min(lb, L))
        rows.append((list(rng.integers(1, 6, la)),
                     list(rng.integers(1, 6, lb))))
    for _ in range(12):
        rows.append((list(rng.integers(1, 30, rng.integers(0, L + 1))),
                     list(rng.integers(1, 30, rng.integers(0, L + 1)))))
    P = len(rows)
    a = np.full((P, L), tdl.PAD_A, np.int32)
    b = np.full((P, L), tdl.PAD_B, np.int32)
    al = np.zeros(P, np.int32)
    bl = np.zeros(P, np.int32)
    for p, (sa, sb) in enumerate(rows):
        al[p], bl[p] = len(sa), len(sb)
        a[p, :len(sa)] = sa
        b[p, :len(sb)] = sb
    return a, al, b, bl


def _route_big(al, bl, L: int) -> np.ndarray:
    """The DP's ``big`` on each pair's path: 2 * 64 + 8 on the byte path
    (DP width 64 above L 64), 2L + 8 on the wide path. A pair whose
    lengths differ by more than the band reads its DL there."""
    wide = np.maximum(al, bl) > tdl.NARROW_LEN
    return np.where(wide, 2 * L + 8, 2 * min(L, tdl.NARROW_LEN) + 8)


@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", WIDE_LS)
def test_host_pair_entry_wide_equals_plain(host_dp_lib, L, window):
    """The pair-string entry's host build above L 64, on byte and on int
    cells, against the plain version: DL clipped at window + 1 (the
    kernel's contract), LCS exactly; both builds equal bit for bit (the
    wide path is the same int-cell code in both). The routing: each path
    gives its own ``big`` for pairs outside the band, and a mixed batch
    takes both."""
    host_u8, host_int = host_dp_lib
    rng = np.random.default_rng(L + window)
    a, al, b, bl = _wide_pairs(rng, L)
    ld, lcs = host_u8(a, al, b, bl, L, window)
    ld_i, lcs_i = host_int(a, al, b, bl, L, window)
    np.testing.assert_array_equal(ld, ld_i)
    np.testing.assert_array_equal(lcs, lcs_i)
    want_ld, want_lcs, _, _ = tdl.dl_metrics_windowed_plain(
        *_t(a, al, b, bl), L, window)
    clip = window + 1
    np.testing.assert_array_equal(np.minimum(ld, clip),
                                  np.minimum(want_ld.numpy(), clip))
    np.testing.assert_array_equal(lcs, want_lcs.numpy())
    wide = np.maximum(al, bl) > tdl.NARROW_LEN
    assert wide.any() and (~wide).any()
    assert (ld[wide] <= window).any() and (ld[~wide] <= window).any()
    out = (np.abs(al - bl) > window + 1) & (al > 0) & (bl > 0)
    assert (out & wide).any() and (out & ~wide).any()
    np.testing.assert_array_equal(ld[out], _route_big(al, bl, L)[out])


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", WIDE_LS)
def test_host_slot_entry_wide_equals_plain(host_slots, host_dp_lib, L,
                                           window, dtype):
    """The slot entry's host build above L 64 against the plain
    composition, as at L 8-64: LCS, prefix, suffix, query length,
    threshold and case flag exactly, DL clipped at window + 1, and DL and
    LCS exactly against the pair-string entry's host build on the gathered
    strings (both entries route a pair alike). Some slots take each
    path."""
    index, (q_norms, q_lens, k_ed, q_fl), (q, pc, valid) = _slot_tables(
        11 * L + window, L, dtype, B=24, P=64)
    got = host_slots(index, q_norms, q_lens, k_ed, q_fl, q, pc, valid,
                     window)
    want = tdl.dl_lcs_slots_plain(index, q_norms, q_lens, k_ed, q_fl, q, pc,
                                  valid, window)
    for name, g, w in zip(tdl.SlotMetrics._fields[1:], got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    clip = window + 1
    assert torch.equal(got[0].clamp(max=clip), want.ld.clamp(max=clip))
    pr = tdl.gather_pairs(index, q_norms, q_lens, k_ed, q_fl, q, pc, valid)
    ld_dp, lcs_dp = host_dp_lib[0](*(x.numpy() for x in (pr.a, pr.ql, pr.b,
                                                          pr.cl)), L, window)
    np.testing.assert_array_equal(got[0].numpy(), ld_dp)
    np.testing.assert_array_equal(got[1].numpy(), lcs_dp)
    wide = torch.maximum(pr.ql, pr.cl) > tdl.NARROW_LEN
    v = valid
    assert (wide & v).any() and (~wide & v).any()
    assert (got[0][wide & v] <= window).any()


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("window", [3, 12])
@pytest.mark.parametrize("L", [100, 256, 300])
def test_host_scored_slot_entry_wide_equals_plain(host_slots, L, window,
                                                  dtype):
    """The scoring epilogue above L 64, on both paths: every output bit
    for bit against the plain score of the host build's own metrics
    (uint8 metrics at L 100, int32 from L 256, where an LCS, prefix or
    suffix passes 255), and against the whole plain route the keep flags,
    the frequency maxima, the block counts (64 slots a block; the wide
    path's kept slots added to their blocks) and the kept slots' metrics
    and scores, with StopAtExactMatch on and with frequencies."""
    index, (q_norms, q_lens, k_ed, q_fl), (q, pc, valid) = _slot_tables(
        17 * L + window, L, dtype, B=24, P=96)
    # slot 0: query 2 (L long) against an exact copy of it, kept, so that
    # its LCS, prefix and suffix are L
    index.norms2[2] = torch.cat([q_norms[2], q_norms[2].flip(0)])
    index.norm_lens[2] = L
    q[0], pc[0], valid[0] = 2, 2, True
    k_ed = k_ed.clamp(max=window)
    B, P = q_lens.shape[0], q.shape[0]
    args = (index, q_norms, q_lens, k_ed, q_fl, q, pc, valid, window)
    m = host_slots(*args)
    s = _score_inputs(L + window, index, B, P, "default")._replace(
        thr=torch.tensor(0.3))
    band = int(s.pc_band[0])
    s.exact_q[2, band >> 3] |= 1 << (band & 7)
    got = host_slots(*args, score=s)
    want = tdl.score_slots_plain(m, q, pc, valid, L, s)
    assert got.met.dtype == tdl.met_dtype(L)
    for name, g, w in zip(tdl.SlotScore._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    plain = tdl.dl_lcs_slots(*args, score=s)  # CPU: the plain route
    keep = got.keep
    assert torch.equal(plain.keep, keep)
    assert torch.equal(plain.max_freq, got.max_freq)
    assert torch.equal(plain.counts, got.counts)
    assert torch.equal(plain.met[:, keep], got.met[:, keep])
    assert torch.equal(plain.score[keep], got.score[keep])
    wide = torch.maximum(m.ql, index.norm_lens[pc.long()]) > tdl.NARROW_LEN
    assert (keep & wide).any() and (keep & ~wide).any()
    if L >= 256:
        assert int(got.met[1:4, keep].max()) > 255


# ---- the wide path's edge cases: the packed LCS rows' run widths, the
# band's reach, an LCS off the main diagonal, empty strings, and int32
# symbols over a byte (which take the LCS along the diagonals) ----

WIDE_CASES = ("equal", "band_edge", "off_diagonal", "empty", "symbols")


def _case_pairs(case: str, L: int, window: int):
    """Pair strings at width ``L`` for one of :data:`WIDE_CASES`:
    ``equal``, equal strings of min(L, 255) letters (a run a byte holds)
    and of 128, 129 and min(L, 256); ``band_edge``, lengths that differ by
    window + 1 (the band reaches cell (al, bl)) and window + 2 (it does
    not: DL is the wide path's big), each way, at lengths over 64 and over
    512; ``off_diagonal``, a common substring on the main diagonal
    shorter than one off it, both ways; ``empty``, an empty string against
    one of 0, 70 and L letters, both ways; ``symbols``, near-equal strings
    of symbols 250 to 299."""
    rng = np.random.default_rng(L + 101 * window + 7 * WIDE_CASES.index(case))
    rows = []

    def letters(n, lo=1, hi=27):
        return list(rng.integers(lo, hi, n))

    if case == "equal":
        for n in (min(L, 255), 128, 129, min(L, 256)):
            s = letters(n)
            rows.append((s, s))
    elif case == "band_edge":
        for n in (100, min(L, 600)):
            s = letters(n)
            for d in (window + 1, window + 2):
                t = list(s[:n - d])
                t[len(t) // 2] = int(rng.integers(1, 27))
                rows += [(s, t), (t, s)]
    elif case == "off_diagonal":
        r, m = L // 3, L // 2
        R, S = letters(r), letters(m)
        a = R + [27] + S + [28] * 3
        b = R + [29] * 4 + S
        rows += [(a[:L], b[:L]), (b[:L], a[:L])]
    elif case == "empty":
        for n in (0, 70, L):
            rows += [([], letters(n)), (letters(n), [])]
    else:
        s = letters(min(L, 300), 250, 300)
        t = list(s)
        t[len(t) // 3] = 251
        rows += [(s, t), (s[:90], t[:92]), (letters(80, 250, 300), s)]
    P = len(rows)
    a = np.full((P, L), tdl.PAD_A, np.int32)
    b = np.full((P, L), tdl.PAD_B, np.int32)
    al = np.zeros(P, np.int32)
    bl = np.zeros(P, np.int32)
    for p, (sa, sb) in enumerate(rows):
        al[p], bl[p] = len(sa), len(sb)
        a[p, :len(sa)] = sa
        b[p, :len(sb)] = sb
    return a, al, b, bl


def _pairs_as_slots(a, al, b, bl, L: int, dtype):
    """The pairs as the slot entry reads them: slot p pairs query p (a's
    row p) with index row p (b's row p, forward | reversed, zero past its
    length)."""
    P = len(al)
    norms2 = np.zeros((P, 2 * L), dtype)
    q_norms = np.zeros((P, L), dtype)
    for p in range(P):
        norms2[p, :bl[p]] = b[p, :bl[p]]
        norms2[p, L:L + bl[p]] = b[p, :bl[p]][::-1]
        q_norms[p, :al[p]] = a[p, :al[p]]
    index = _slot_index(norms2, bl.copy(), np.zeros(P, bool))
    slots = np.arange(P, dtype=np.int32)
    return (index, *_t(q_norms, al.copy(), np.full(P, 3, np.int32),
                       np.zeros(P, bool)),
            *_t(slots, slots.copy(), np.ones(P, bool)))


@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("window", [3, 6, 12])
@pytest.mark.parametrize("L", [255, 256, 1100])
def test_host_wide_cases(host_slots, host_dp_lib, L, window, case):
    """Each edge case of the wide path against the plain version (DL
    clipped at window + 1, LCS exact), and bit for bit between the u8 and
    int host builds of the pair-string entry and the slot entry's host
    build (int32 tables, and int8 where the symbols fit), with each case's
    own outcome: equal strings' LCS their length (255 in a byte run,
    without wrapping) and DL 0; the band's reach decides DL, exact at
    window + 1 and the path's big at window + 2; the LCS off the main
    diagonal; an empty string's DL the other's length and LCS 0."""
    host_u8, host_int = host_dp_lib
    a, al, b, bl = _case_pairs(case, L, window)
    ld, lcs = host_u8(a, al, b, bl, L, window)
    ld_i, lcs_i = host_int(a, al, b, bl, L, window)
    np.testing.assert_array_equal(ld, ld_i)
    np.testing.assert_array_equal(lcs, lcs_i)
    for dtype in (np.int32, np.int8):
        if dtype == np.int8 and case == "symbols":
            continue
        m = host_slots(*_pairs_as_slots(a, al, b, bl, L, dtype), window)
        np.testing.assert_array_equal(m.ld.numpy(), ld)
        np.testing.assert_array_equal(m.lcs.numpy(), lcs)
    want_ld, want_lcs, _, _ = tdl.dl_metrics_windowed_plain(
        *_t(a, al, b, bl), L, window)
    clip = window + 1
    np.testing.assert_array_equal(np.minimum(ld, clip),
                                  np.minimum(want_ld.numpy(), clip))
    np.testing.assert_array_equal(lcs, want_lcs.numpy())
    assert (np.maximum(al, bl) > tdl.NARROW_LEN).any()
    big = _route_big(al, bl, L)
    if case == "equal":
        np.testing.assert_array_equal(lcs, al)
        assert (ld == 0).all() and lcs[0] == min(L, 255)
    elif case == "band_edge":
        d = np.abs(al - bl)
        assert set(d) == {window + 1, window + 2}
        assert (ld[d == window + 1] < big[d == window + 1]).all()
        np.testing.assert_array_equal(ld[d == window + 2],
                                      big[d == window + 2])
    elif case == "off_diagonal":
        assert (lcs == L // 2).all()
    elif case == "empty":
        np.testing.assert_array_equal(ld, np.maximum(al, bl))
        assert (lcs == 0).all()

