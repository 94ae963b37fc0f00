"""Normalization and distance metric parity tests (reference tests/main.rs 03xx)."""

from analiticcl_jax.anahash import normalize_to_alphabet
from analiticcl_jax.ops.distance import (
    common_prefix_length,
    common_suffix_length,
    damerau_levenshtein,
    levenshtein,
    longest_common_substring_length,
)

from fixtures import get_test_alphabet

ALPHABET, _ = get_test_alphabet()


def norm(text):
    return normalize_to_alphabet(text, ALPHABET)


def test0301_normalize_to_alphabet():
    assert norm("a") == [0]
    assert norm("b") == [1]


def test0302_levenshtein():
    assert levenshtein(norm("a"), norm("a"), 99) == 0
    assert levenshtein(norm("a"), norm("b"), 99) == 1
    assert levenshtein(norm("ab"), norm("ac"), 99) == 1
    assert levenshtein(norm("a"), norm("ab"), 99) == 1
    assert levenshtein(norm("ab"), norm("a"), 99) == 1
    assert levenshtein(norm("ab"), norm("ba"), 99) == 2
    assert levenshtein(norm("abc"), norm("xyz"), 99) == 3


def test0303_damerau_levenshtein():
    assert damerau_levenshtein(norm("a"), norm("a"), 99) == 0
    assert damerau_levenshtein(norm("a"), norm("b"), 99) == 1
    assert damerau_levenshtein(norm("ab"), norm("ac"), 99) == 1
    assert damerau_levenshtein(norm("a"), norm("ab"), 99) == 1
    assert damerau_levenshtein(norm("ab"), norm("a"), 99) == 1
    assert damerau_levenshtein(norm("ab"), norm("ba"), 99) == 1
    assert damerau_levenshtein(norm("abc"), norm("xyz"), 99) == 3


def test0303_damerau_levenshtein2():
    assert damerau_levenshtein(norm("hipotesis"), norm("hypothesis"), 99) == 2


def test0303_damerau_levenshtein_max_distance():
    assert damerau_levenshtein(norm("abc"), norm("xyz"), 2) is None
    assert damerau_levenshtein(norm(""), norm("abc"), 2) is None
    assert damerau_levenshtein(norm("abc"), norm(""), 3) == 3
    assert damerau_levenshtein(norm("abcdef"), norm("a"), 3) is None


def test0304_lcslen():
    assert longest_common_substring_length(norm("test"), norm("testable")) == 4
    assert longest_common_substring_length(norm("fasttest"), norm("testable")) == 4
    assert longest_common_substring_length(norm("abcdefhij"), norm("def")) == 3
    assert longest_common_substring_length(norm("def"), norm("abcdefhij")) == 3


def test0304_prefixlen():
    assert common_prefix_length(norm("test"), norm("testable")) == 4
    assert common_prefix_length(norm("testable"), norm("test")) == 4
    assert common_prefix_length(norm("fasttest"), norm("testable")) == 0
    assert common_prefix_length(norm("fasttest"), norm("test")) == 0


def test0304_suffixlen():
    assert common_suffix_length(norm("test"), norm("testable")) == 0
    assert common_suffix_length(norm("testable"), norm("test")) == 0
    assert common_suffix_length(norm("fasttest"), norm("testable")) == 0
    assert common_suffix_length(norm("fasttest"), norm("test")) == 4
