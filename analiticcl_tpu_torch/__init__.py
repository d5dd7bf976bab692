"""analiticcl_tpu_torch: analiticcl-tpu's query, search and learn modes on
PyTorch and CUDA.

A port of the JAX package ``analiticcl_tpu`` for one NVIDIA H100. It imports
the JAX-free modules of that package (types, vocabulary, alphabet, anagram
algebra, the host oracle, the native C++ ranking tail) and replaces its device
path: the stage-A retrieval and the windowed DL+LCS DP run in hand-written
CUDA kernels (``csrc/``), with plain PyTorch versions beside them for CPU
tensors. It never imports JAX.
"""

from analiticcl_tpu.types import (
    Distance,
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantReference,
    VariantReferenceKind,
    VariantResult,
    VocabId,
    Weights,
)
from analiticcl_tpu.vocab import (
    BOS,
    EOS,
    UNK,
    FrequencyHandling,
    VocabParams,
    VocabType,
    VocabValue,
)

from .models.variant_model import VariantModel

__all__ = [
    "BOS",
    "Distance",
    "DistanceThreshold",
    "EOS",
    "FrequencyHandling",
    "SearchParameters",
    "StopCriterion",
    "UNK",
    "VariantModel",
    "VariantReference",
    "VariantReferenceKind",
    "VariantResult",
    "VocabId",
    "VocabParams",
    "VocabType",
    "VocabValue",
    "Weights",
]
