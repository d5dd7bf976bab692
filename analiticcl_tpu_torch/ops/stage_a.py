"""Stage A: charcount-banded L1-ball retrieval masks.

For every query and every row of its tile's charcount band::

    L1  = cc(row) + cc(q) - 2 * (bin(row) . bin(q))   # int8 planes, int32 dot
    hit = L1 <= k_ana(q)  and  |cc(row) - cc(q)| <= k_len(q)  and  valid(row)
    exact = L1 == 0  and  valid(row)

Outputs, in banded coordinates (``Nb = nb_band * ROW_BLOCK`` rows per band;
band row ``r`` of query ``q`` is device row
``start_blk[q // bt] * ROW_BLOCK + r``), exactly as the JAX package's
``analiticcl_tpu/ops/stage_a.py`` gives them:

* ``packed_q``, ``exact_q``: uint8 ``[B, Nb / 8]``, bit ``k`` of byte ``j``
  is band row ``8j + k``;
* ``counts_t``: int32 ``[Nb / 128, B]``, hits per 128 band rows;
* ``nmatch``, ``nexact``: int32 ``[B]`` per-query totals.

:func:`stage_a_masks_plain` is the plain PyTorch version (a port of
``stage_a_masks_xla``); :func:`stage_a_masks` launches the hand-written kernel
``csrc/stage_a.cu`` for CUDA tensors and takes the plain version for CPU
tensors. The tiling constants are the JAX package's, copied rather than
imported because that module loads JAX.
"""

from __future__ import annotations

import torch

from . import _build

ROW_BLOCK = 1024  # band-start granularity in rows
B_TILE = 1024  # queries per band tile
BIG_NI_ROWS = 262_144  # above this many rows the query tile shrinks ...
BIG_NI_B_TILE = 256  # ... to this, so each tile's charcount band narrows
KERNEL_QT = 128  # queries per CUDA block (never straddles a band tile)
# the kernel's instances, by the number csrc/stage_a.cu gives each: the
# main one (the first 224 plane columns), one whose block keeps its 128
# queries' planes in shared memory (up to 576 columns on an H100), and one
# that streams the planes in k-chunks, each band block to its own extent
# (any width). Planes are A x T wide, T the largest count of one character
# in one entry; a launch's width is the largest block extent it reads.
INSTANCES = {"main": 1, "resident": 2, "stream": 3}
_routes: dict = {}  # (device, width, AT, qt) -> the instance's name


def _b_tile(B: int, Ni: int = 0) -> int:
    """Queries per band tile: a power of two dividing ``B``."""
    bt = min(B, BIG_NI_B_TILE if Ni >= BIG_NI_ROWS else B_TILE)
    while bt > 1 and B % bt != 0:
        bt = 1 << ((bt - 1).bit_length() - 1)
    return max(bt, 1)


def _pack_bits_rows(mask_t):
    """[R, B] bool -> [B, R/8] uint8: bit r%8 of byte r//8 is row r."""
    R, B = mask_t.shape
    w = (1 << torch.arange(8, dtype=torch.int32, device=mask_t.device))
    packed = (mask_t.view(R // 8, 8, B).to(torch.int32) * w[None, :, None]).sum(1)
    return packed.T.to(torch.uint8)


def stage_a_masks_plain(bins, cc, validrows, qbin, q_cc, k_ana, k_len,
                        start_blk, nb_band: int, extents=None, width=None):
    """Plain PyTorch stage A, one band tile at a time, over every plane
    column: ``extents`` and ``width`` (the kernel's arguments) are not
    read, so a wrong table shows as a difference from the kernel.

    The int8 dot product runs as a float32 matmul: the planes are 0/1 and the
    sums stay far below 2**24, so the result is exact (TF32 is off for
    matmuls by default, and 0/1 inputs are exact in TF32 as well)."""
    Ni, AT = bins.shape
    B = qbin.shape[0]
    bt = _b_tile(B, Ni)
    nqt = B // bt
    Nb = nb_band * ROW_BLOCK
    binsf = bins.to(torch.float32)
    qbinf = qbin.to(torch.float32)
    outs = []
    for t in range(nqt):
        q = slice(t * bt, (t + 1) * bt)
        r0 = int(start_blk[t]) * ROW_BLOCK
        rows = slice(r0, r0 + Nb)
        dot = (binsf[rows] @ qbinf[q].T).to(torch.int32)  # [Nb, bt]
        cc_b = cc[rows][:, None]
        vr_b = validrows[rows][:, None]
        l1 = cc_b + q_cc[q][None, :] - 2 * dot
        mask = (l1 <= k_ana[q][None, :]) & ((cc_b - q_cc[q][None, :]).abs()
                                            <= k_len[q][None, :]) & vr_b
        exact = (l1 == 0) & vr_b
        outs.append((
            _pack_bits_rows(mask),
            _pack_bits_rows(exact),
            mask.view(Nb // 128, 128, bt).sum(1, dtype=torch.int32),
            mask.sum(0, dtype=torch.int32),
            exact.sum(0, dtype=torch.int32),
        ))
    packed_q = torch.cat([o[0] for o in outs], 0)
    exact_q = torch.cat([o[1] for o in outs], 0)
    counts_t = torch.cat([o[2] for o in outs], 1)
    nmatch = torch.cat([o[3] for o in outs])
    nexact = torch.cat([o[4] for o in outs])
    return packed_q, exact_q, counts_t, nmatch, nexact


def _check_inputs(bins, cc, validrows, qbin, q_cc, k_ana, k_len, start_blk,
                  nb_band, extents, width):
    Ni, AT = bins.shape
    B = qbin.shape[0]
    bt = _b_tile(B, Ni)
    want = {
        "bins": (bins, torch.int8, (Ni, AT)), "cc": (cc, torch.int32, (Ni,)),
        "validrows": (validrows, torch.bool, (Ni,)),
        "qbin": (qbin, torch.int8, (B, AT)), "q_cc": (q_cc, torch.int32, (B,)),
        "k_ana": (k_ana, torch.int32, (B,)), "k_len": (k_len, torch.int32, (B,)),
        "start_blk": (start_blk, torch.int32, (B // bt,)),
        "extents": (extents, torch.int32, (Ni // ROW_BLOCK,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"stage_a: {name} is {t.dtype} {tuple(t.shape)}, "
                f"wants contiguous {dtype} {shape}"
            )
        if t.device != bins.device:
            raise ValueError(f"stage_a: {name} on {t.device}, bins on {bins.device}")
    if Ni % ROW_BLOCK or nb_band < 1 or nb_band * ROW_BLOCK > Ni:
        raise ValueError(f"stage_a: Ni={Ni} nb_band={nb_band}")
    if not 32 <= width <= -(-AT // 32) * 32 or width % 32:
        raise ValueError(f"stage_a: width {width} is not a multiple of 32 "
                         f"in [32, {AT}]")
    return B, AT, bt


def kernel_instance(width: int, AT: int, qt: int, device) -> str:
    """The kernel's instance for a launch whose rows use ``width`` columns
    of planes ``AT`` wide, ``qt`` queries a block, on CUDA ``device``, as
    ``csrc/stage_a.cu``'s ``k1_route`` decides it from the shape and the
    device's shared memory (asked once per device, width, plane width and
    query tile)."""
    dev = torch.device(device)
    key = (dev.index, width, AT, qt)
    name = _routes.get(key)
    if name is None:
        with torch.cuda.device(dev):
            code = _build.load("stage_a").analiticcl_stage_a_route(
                width, AT, qt, -1)
        if code < 0:
            _build.check(-code, "stage_a shared-memory limit")
        name = next((k for k, v in INSTANCES.items() if v == code), None)
        if name is None:
            raise RuntimeError(f"stage_a kernel: no instance fits a "
                               f"launch {width} wide (planes {AT} wide) in "
                               "the device's shared memory")
        _routes[key] = name
    return name


def stage_a_masks(bins, cc, validrows, qbin, q_cc, k_ana, k_len, start_blk,
                  nb_band: int, extents, width: int, totals=None):
    """Banded stage-A outputs: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``extents`` (int32 ``[Ni / ROW_BLOCK]``) is
    the planes' block extents (``convert.block_extents``: every row of
    block ``j`` is zero past column ``extents[j]``) and ``width`` (a
    multiple of 32) at least the extent of every block the tiles read
    (``convert.band_width``); the kernel reads no column past them. The
    kernel wants ``AT`` (the plane width) a multiple of 32, one int8 MMA
    k-step; ``convert.py`` pads the index with zero columns. Any width
    launches, at :func:`kernel_instance`'s instance for ``width``; each
    launch counts in ``stage_a_masks.launches_by_instance`` too. The
    kernel adds each query's totals into ``nmatch`` and
    ``nexact``: the rows of ``totals`` (int32 ``[2, B]``, zeroed by the
    caller: the query planes' kernel zeroes them in its launch) where it
    is given, else two tensors of zeros made here. The plain version makes
    its own."""
    B, AT, bt = _check_inputs(bins, cc, validrows, qbin, q_cc, k_ana, k_len,
                              start_blk, nb_band, extents, width)
    if totals is not None and (
            totals.dtype != torch.int32 or tuple(totals.shape) != (2, B)
            or not totals.is_contiguous() or totals.device != bins.device):
        raise ValueError(f"stage_a: totals is {totals.dtype} "
                         f"{tuple(totals.shape)} on {totals.device}, wants "
                         f"contiguous int32 (2, {B}) on {bins.device}")
    dev = bins.device
    if dev.type == "cpu":
        return stage_a_masks_plain(bins, cc, validrows, qbin, q_cc, k_ana,
                                   k_len, start_blk, nb_band)
    if dev.type != "cuda":
        raise ValueError(f"stage_a: unsupported device {dev}")
    if AT % 32:
        raise ValueError(f"stage_a kernel: AT={AT} is not a multiple of 32")
    qt = min(KERNEL_QT, bt)
    instance = kernel_instance(width, AT, qt, dev)
    Nb = nb_band * ROW_BLOCK
    packed_q = torch.empty((B, Nb // 8), dtype=torch.uint8, device=dev)
    exact_q = torch.empty((B, Nb // 8), dtype=torch.uint8, device=dev)
    counts_t = torch.empty((Nb // 128, B), dtype=torch.int32, device=dev)
    if totals is None:
        nmatch = torch.zeros(B, dtype=torch.int32, device=dev)
        nexact = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        nmatch, nexact = totals
    lib = _build.load("stage_a")
    with torch.cuda.device(dev):
        err = lib.analiticcl_stage_a(
            bins.data_ptr(), cc.data_ptr(), validrows.data_ptr(),
            qbin.data_ptr(), q_cc.data_ptr(), k_ana.data_ptr(),
            k_len.data_ptr(), start_blk.data_ptr(), extents.data_ptr(),
            packed_q.data_ptr(), exact_q.data_ptr(), counts_t.data_ptr(),
            nmatch.data_ptr(), nexact.data_ptr(),
            B, AT, width, nb_band, bt, qt, INSTANCES[instance],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    stage_a_masks.launches += 1
    stage_a_masks.launches_by_instance[instance] += 1
    _build.check(err, f"stage_a kernel launch ({instance} instance, width "
                      f"{width}, AT {AT})")
    return packed_q, exact_q, counts_t, nmatch, nexact


stage_a_masks.launches = 0
stage_a_masks.launches_by_instance = dict.fromkeys(INSTANCES, 0)
