"""Carry a built index onto the device: the port's counterpart of the JAX
``DevicePipeline``'s index arrays (``analiticcl_tpu/ops/pipeline.py``).

The device layout is the JAX package's: rows sorted by charcount (stable, so
canonical order within one charcount), padded to a multiple of ROW_BLOCK with
rows of charcount ``BIG_L1`` that never match, the binarized count planes
``bins[row, a*T + t] = counts[row, a] > t``, forward and reversed norms side by
side, and int8 norms when the alphabet indices fit.

Two differences, both exact:

* ``bins`` gains zero columns up to a multiple of 32 (``at_pad``): the stage-A
  kernel's int8 tensor-core product takes 32 bytes of depth per k-step. A zero
  column adds nothing to a dot product. ``at`` keeps
  the true width ``A * T`` so that query planes are built to match.
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
    bins: torch.Tensor  # int8 [Ni_pad, at_pad]
    cc: torch.Tensor  # int32 [Ni_pad]
    validrows: torch.Tensor  # bool [Ni_pad]
    norms2: torch.Tensor  # int8/int32 [Ni_pad, 2L]: forward | reversed norms
    norm_lens: torch.Tensor  # int32 [Ni_pad]
    freqs: torch.Tensor  # int64 [Ni_pad]
    first_lower: torch.Tensor  # bool [Ni_pad]
    at: int  # true plane width A * T (bins' columns past it are zero)


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
    t_levels = np.arange(T, dtype=np.int32)[None, None, :]
    bins = np.zeros((Ni_pad, A * T), dtype=np.int8)
    bins[:Ni] = (counts[perm][:, :, None] > t_levels).reshape(Ni, A * T)
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


def index_tensors_from_numpy(bins, cc, validrows, norms2, norm_lens, freqs,
                             first_lower, device) -> DeviceIndex:
    """The seven index arrays of the JAX ``DevicePipeline._idx``, as numpy
    arrays, on ``device`` in the port's layout."""
    dev = resolve_device(device)
    bins = np.asarray(bins, dtype=np.int8)
    at = bins.shape[1]
    at_pad = -(-at // 32) * 32
    if at_pad != at:
        bins = np.pad(bins, ((0, 0), (0, at_pad - at)))

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
        at=at,
    )


def index_tensors_from_model(model, device) -> DeviceIndex:
    """``model``'s built index on ``device``."""
    lay = host_layout(model)
    return index_tensors_from_numpy(
        lay.bins, lay.cc, lay.validrows, lay.norms2, lay.norm_lens,
        lay.freqs, lay.first_lower, device,
    )
