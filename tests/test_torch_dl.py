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
            [gxx, "-O2", "-x", "c++", "-DANALITICCL_HOST_TEST", "-shared",
             "-fPIC", "-o", str(so), str(src)],
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
