"""The port's VariantModel: the JAX package's model with its device path on
PyTorch.

Everything above the device call (vocabulary, index build, the host oracle,
the ranking helpers) is inherited from ``analiticcl_tpu.models.variant_model``,
which imports no JAX. The two query entry points are redirected so that the
JAX pipeline module is never imported: ``find_variants_batch`` is overridden
(the parent imports ``analiticcl_tpu.ops.pipeline`` on every device call),
and ``find_variants_stream`` finds its pipeline already set. Search, learn
and ``use_mesh`` are not ported yet.
"""

from __future__ import annotations

import sys
from typing import List, Sequence

from analiticcl_tpu.models.variant_model import VariantModel as _HostModel
from analiticcl_tpu.types import SearchParameters, VariantResult

from ..device import resolve_device
from ..ops.pipeline import DevicePipeline


class VariantModel(_HostModel):
    """Variant model whose device path runs on ``device`` ("cuda" or "cpu")."""

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    def _use_device(self) -> bool:
        """The parent's ``auto`` rule: the device path from 64 index
        entries up, the host oracle below."""
        if self._backend == "auto":
            return self.index.size >= 64
        return self._backend == "device"

    def _pipeline(self) -> DevicePipeline:
        if self._device is None:
            self._device = DevicePipeline(self, self.device)
        return self._device

    def find_variants_batch(
        self, inputs: Sequence[str], params: SearchParameters
    ) -> List[List[VariantResult]]:
        if self.index is None:
            print(
                "ERROR: Model has not been built yet! Call build() before "
                "find_variants()",
                file=sys.stderr,
            )
            return [[] for _ in inputs]
        if self._use_device():
            return self._pipeline().find_variants_batch(inputs, params)
        return [self._find_variants_oracle(text, params) for text in inputs]

    def find_variants_stream(
        self, inputs: Sequence[str], params: SearchParameters,
        batch_size: int = 4096,
    ):
        if self.index is not None and self._use_device():
            self._pipeline()
        return super().find_variants_stream(inputs, params, batch_size)
