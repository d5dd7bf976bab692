"""Carry a built index onto the device: the port's counterpart of the JAX
``DevicePipeline``'s index arrays (``analiticcl_tpu/ops/pipeline.py``).

The device layout is the JAX package's: rows sorted by charcount (stable, so
canonical order within one charcount), padded to a multiple of ROW_BLOCK with
rows of charcount ``BIG_L1`` that never match, the binarized count planes,
forward and reversed norms side by side, and int8 norms when the alphabet
indices fit.

Four differences, all exact:

* The planes are threshold-major: ``bins[row, t*A + a] = counts[row, a] > t``
  where the JAX package has ``a*T + t`` (:func:`plane_columns` maps one to the
  other). Stage A takes dot products of planes whose columns are permuted
  alike, so its outputs do not change; but a row whose characters occur at
  most ``c`` times now has zeros past column ``c*A``, wherever its letters
  are. The query planes are always built in this order.
* ``bins`` gains zero columns up to a multiple of 32 (``at_pad``): the stage-A
  kernel's int8 tensor-core product takes 32 bytes of depth per k-step. A zero
  column adds nothing to a dot product. ``at`` keeps
  the true width ``A * T`` so that query planes are built to match.
* Each 1024-row block has an extent (:func:`block_extents`): the columns past
  it are zero in every row of the block, so stage A over the block need not
  read them. The table is kept on the device for the kernel and on the host
  for the band plan, which routes each launch by the widest extent its
  tiles read (:func:`band_width`).
* ``freqs`` is int64, not uint32: PyTorch's uint32 support on CUDA does not
  cover the per-query segment max. Frequencies are integers below 2**32, so
  the values are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .ops.stage_a import ROW_BLOCK

BIG_L1 = np.int32(1 << 28)


class DeviceIndex(NamedTuple):
    bins: torch.Tensor  # int8 [Ni_pad, at_pad], threshold-major
    cc: torch.Tensor  # int32 [Ni_pad]
    validrows: torch.Tensor  # bool [Ni_pad]
    norms2: torch.Tensor  # int8/int32 [Ni_pad, 2L]: forward | reversed norms
    norm_lens: torch.Tensor  # int32 [Ni_pad]
    freqs: torch.Tensor  # int64 [Ni_pad]
    first_lower: torch.Tensor  # bool [Ni_pad]
    extents: torch.Tensor  # int32 [Ni_pad / ROW_BLOCK]: block_extents(bins)
    extents_host: np.ndarray  # the same table on the host
    at: int  # true plane width A * T (bins' columns past it are zero)


def plane_columns(A: int, T: int) -> np.ndarray:
    """The port's plane order as a permutation of the JAX package's: port
    column ``t*A + a`` is JAX column ``a*T + t`` (``counts[a] > t`` in
    both), so ``port_bins = jax_bins[:, plane_columns(A, T)]``."""
    return np.arange(A * T).reshape(A, T).T.reshape(-1)


def count_planes(counts, T: int):
    """int8 ``[N, T*A]`` threshold-major planes of per-character ``counts``
    ``[N, A]`` (a numpy array, or a tensor for planes on its device):
    column ``t*A + a`` is ``counts[a] > t`` (the JAX package's planes
    under :func:`plane_columns`). Every plane of the port, the index's and
    the queries', is built in this order."""
    if torch.is_tensor(counts):
        levels = torch.arange(T, dtype=torch.int32, device=counts.device)
    else:
        levels = np.arange(T, dtype=np.int32)
    planes = (counts[:, None, :] > levels[:, None]).reshape(len(counts), -1)
    return planes.to(torch.int8) if torch.is_tensor(planes) else \
        planes.view(np.int8)


def block_columns(bins) -> torch.Tensor:
    """int32 ``[Ni / ROW_BLOCK]``: for each 1024-row block of the planes
    ``bins`` (a tensor, or a numpy array, as they are stored), 1 + the last
    column that holds a 1 in any of its rows (0 for a block of zeros):
    every row of the block is zero past it. On ``bins``' device."""
    t = torch.as_tensor(bins)
    Ni, W = t.shape
    nz = (t.view(Ni // ROW_BLOCK, ROW_BLOCK, W) != 0).any(1)
    cols = torch.arange(1, W + 1, dtype=torch.int32, device=t.device)
    return torch.where(nz, cols, 0).amax(1).to(torch.int32)


def block_extents(bins) -> torch.Tensor:
    """int32 ``[Ni / ROW_BLOCK]``: each block's :func:`block_columns`
    rounded up to 32 (one k-step of stage A's product), at least 32: the
    k width stage A walks over the block. On ``bins``' device."""
    last = block_columns(bins)
    return ((last + 31) // 32 * 32).clamp_(min=32).to(torch.int32)


def band_width(extents_host: np.ndarray, start_blk: np.ndarray,
               nb_band: int) -> int:
    """The k width a stage-A launch needs: the largest extent among the
    blocks ``[start, start + nb_band)`` that its tiles read."""
    blocks = np.asarray(start_blk).reshape(-1)[:, None] + np.arange(nb_band)
    return int(np.asarray(extents_host)[blocks].max())


def k1_table(bins, start_blk, nb_band: int):
    """``(extents, width)`` for a stage-A call that has no
    :class:`DeviceIndex` (seeded planes): the table reckoned from ``bins``
    (a reduction over the planes) and the width its tiles read."""
    ext = block_extents(bins)
    return ext, band_width(ext.cpu().numpy(),
                           torch.as_tensor(start_blk).cpu().numpy(), nb_band)


class HostLayout(NamedTuple):
    """The numpy arrays of the device layout, plus the row permutation."""

    bins: np.ndarray
    cc: np.ndarray
    validrows: np.ndarray
    norms2: np.ndarray
    norm_lens: np.ndarray
    freqs: np.ndarray
    first_lower: np.ndarray
    canon_of: np.ndarray  # int64 [Ni_pad]: device row -> canonical index row
    L: int  # padded string width, at least 8


def host_layout(model, pad_unit: int = ROW_BLOCK) -> HostLayout:
    """The device layout of ``model``'s built index, as numpy arrays
    (ported from ``DevicePipeline.__init__``, ops/pipeline.py:966-1004),
    its rows padded to a multiple of ``pad_unit`` (a multiple of
    ROW_BLOCK; a sharded index passes ROW_BLOCK times its shard count)."""
    index = model.index
    if index is None:
        raise RuntimeError("build() the model before moving its index")
    if pad_unit < ROW_BLOCK or pad_unit % ROW_BLOCK:
        raise ValueError(f"pad_unit {pad_unit} is not a multiple of {ROW_BLOCK}")
    A = model.alphabet_size()
    Ni = index.size
    L = max(8, index.max_norm_len)
    counts = index.counts.astype(np.int32)
    T = max(1, int(counts.max())) if counts.size else 1
    Ni_pad = max(pad_unit, -(-Ni // pad_unit) * pad_unit)

    perm = np.argsort(index.charcounts, kind="stable")
    canon_of = np.full(Ni_pad, max(Ni - 1, 0), dtype=np.int64)
    canon_of[:Ni] = perm
    cc = np.full(Ni_pad, BIG_L1, dtype=np.int32)
    cc[:Ni] = index.charcounts[perm]
    bins = np.zeros((Ni_pad, A * T), dtype=np.int8)
    bins[:Ni] = count_planes(counts[perm], T)
    wn = index.norms.shape[1]
    norm_dtype = np.int8 if int(index.norms.max(initial=0)) < 120 else np.int32
    norms2 = np.zeros((Ni_pad, 2 * L), dtype=norm_dtype)
    norms2[:Ni, :wn] = index.norms[perm]
    norms2[:Ni, L : L + wn] = index.norms_reversed()[perm]
    norm_lens = np.zeros(Ni_pad, dtype=np.int32)
    norm_lens[:Ni] = index.norm_lens[perm]
    freqs = np.zeros(Ni_pad, dtype=np.int64)
    freqs[:Ni] = index.freqs[perm].astype(np.int64)
    first_lower = np.zeros(Ni_pad, dtype=bool)
    first_lower[:Ni] = index.first_lower[perm]
    validrows = np.arange(Ni_pad) < Ni
    return HostLayout(bins, cc, validrows, norms2, norm_lens, freqs,
                      first_lower, canon_of, L)


def device_index(bins, cc, validrows, norms2, norm_lens, freqs, first_lower,
                 device, extents=None) -> DeviceIndex:
    """The seven arrays of a device layout (:class:`HostLayout`'s; ``bins``
    threshold-major, ``A * T`` wide) on ``device``: the planes padded to a
    multiple of 32 columns, and their block extents (``extents``, the
    host table of the padded planes where the caller has it, else reckoned
    here)."""
    dev = resolve_device(device)
    bins = np.asarray(bins, dtype=np.int8)
    at = bins.shape[1]
    at_pad = -(-at // 32) * 32
    if at_pad != at:
        bins = np.pad(bins, ((0, 0), (0, at_pad - at)))
    if extents is None:
        extents = block_extents(bins).numpy()

    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(dev)

    norms2 = np.asarray(norms2)
    return DeviceIndex(
        bins=put(bins, np.int8),
        cc=put(cc, np.int32),
        validrows=put(validrows, np.bool_),
        norms2=put(norms2, norms2.dtype),
        norm_lens=put(norm_lens, np.int32),
        freqs=put(freqs, np.int64),
        first_lower=put(first_lower, np.bool_),
        extents=put(extents, np.int32),
        extents_host=np.array(extents, dtype=np.int32),
        at=at,
    )


def index_tensors_from_numpy(bins, cc, validrows, norms2, norm_lens, freqs,
                             first_lower, device, *, A: int) -> DeviceIndex:
    """The seven index arrays of the JAX ``DevicePipeline._idx``, as numpy
    arrays, on ``device`` in the port's layout. ``A`` is the alphabet size:
    the JAX package's planes are letter-major (``a*T + t``), and their
    columns are put in the port's order (:func:`plane_columns`)."""
    bins = np.asarray(bins, dtype=np.int8)
    if bins.shape[1] % A:
        raise ValueError(f"planes {bins.shape[1]} wide are not A={A} x T")
    bins = bins[:, plane_columns(A, bins.shape[1] // A)]
    return device_index(bins, cc, validrows, norms2, norm_lens, freqs,
                        first_lower, device)


def index_tensors_from_model(model, device) -> DeviceIndex:
    """``model``'s built index on ``device``."""
    lay = host_layout(model)
    return device_index(
        lay.bins, lay.cc, lay.validrows, lay.norms2, lay.norm_lens,
        lay.freqs, lay.first_lower, device,
    )
