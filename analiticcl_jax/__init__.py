"""analiticcl-jax: an approximate string matching engine on the GPU.

A brand-new JAX/XLA/Pallas framework with the capabilities of
proycon/analiticcl (lexicon-backed fuzzy matching for spelling correction and
text normalisation): anagram-based candidate retrieval, weighted
Damerau-Levenshtein/LCS/prefix/suffix scoring, frequency ranking, confusable
rescoring, variant/error lists, running-text search with n-gram language
models and context rules, and corpus-driven variant learning.

Architecture (device-first, not a port):
  * anagram values are dense character-count vectors; candidate retrieval is a
    batched L1-ball query over the lexicon as an int8 matmul, replacing the
    reference's bigint deletion BFS + hash probes
  * candidate scoring is a batched banded DP (a Triton kernel on the GPU)
    over padded pairs, fused with the weighted score and threshold filter
  * the lexicon index shards across a device mesh for million-entry lexicons
"""

from .types import (
    Distance,
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantReference,
    VariantResult,
    VocabId,
    Weights,
    PRIMES,
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
from .alphabet import Alphabet, AlphabetEncoder, read_alphabet_file
from . import anahash

__version__ = "0.1.0"

__all__ = [
    "Alphabet",
    "AlphabetEncoder",
    "BOS",
    "Distance",
    "DistanceThreshold",
    "EOS",
    "FrequencyHandling",
    "PRIMES",
    "SearchParameters",
    "StopCriterion",
    "UNK",
    "VariantReference",
    "VariantResult",
    "VocabId",
    "VocabParams",
    "VocabType",
    "VocabValue",
    "Weights",
    "anahash",
    "read_alphabet_file",
]


def __getattr__(name):
    # Lazy import of the model (pulls in JAX) so that light-weight uses of the
    # algebra don't pay the JAX import cost.
    if name == "VariantModel":
        from .models.variant_model import VariantModel

        return VariantModel
    raise AttributeError(f"module 'analiticcl_jax' has no attribute {name!r}")
