"""Shared test fixtures, mirroring the reference's test module (src/test.rs:3-68)."""

from analiticcl_jax.types import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
)

# 27-entry case-folding alphabet (src/test.rs:3-31)
TEST_ALPHABET = [
    ["a", "A"], ["b", "B"], ["c", "C"], ["d", "D"], ["e", "E"], ["f", "F"],
    ["g", "G"], ["h", "H"], ["i", "I"], ["j", "J"], ["k", "K"], ["l", "L"],
    ["m", "M"], ["n", "N"], ["o", "O"], ["p", "P"], ["q", "Q"], ["r", "R"],
    ["s", "S"], ["t", "T"], ["u", "U"], ["v", "V"], ["w", "W"], ["x", "X"],
    ["y", "Y"], ["z", "Z"], [".", ","],
]


def get_test_alphabet():
    return TEST_ALPHABET, len(TEST_ALPHABET)


def get_test_searchparams() -> SearchParameters:
    """src/test.rs:48-68"""
    return SearchParameters(
        max_edit_distance=DistanceThreshold.absolute(2),
        max_anagram_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        stop_criterion=StopCriterion.EXHAUSTIVE,
        score_threshold=0.0,
        cutoff_threshold=0.0,
        max_ngram=2,
        lm_order=2,
        freq_weight=0.0,
        single_thread=True,
        context_weight=0.0,
        lm_weight=1.0,
        variantmodel_weight=3.0,
        contextrules_weight=1.0,
        max_seq=250,
        consolidate_matches=True,
        unicodeoffsets=False,
    )
