"""analiticcl_tpu_torch: analiticcl-tpu's query, search and learn modes on
PyTorch and CUDA.

A port of the JAX package ``analiticcl_tpu`` for one NVIDIA H100, standing
alone: it keeps its own copy of that package's host layer (types,
vocabulary, alphabet, anagram algebra, the host oracle, segmentation and the
lattice decode, checkpoints, the native C/C++ helpers in ``native/``) and
replaces its device path: the stage-A retrieval and the windowed DL+LCS DP
run in hand-written CUDA kernels (``csrc/``), with plain PyTorch versions
beside them for CPU tensors. It imports neither JAX nor ``analiticcl_tpu``;
checkpoints keep the JAX package's format and cross in both directions.
"""

from .types import (
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
from .vocab import (
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
