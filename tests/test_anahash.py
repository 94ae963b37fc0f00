"""Anagram algebra parity tests (reference tests/main.rs 00xx-01xx)."""

import numpy as np
import pytest

from analiticcl_jax.alphabet import AlphabetEncoder
from analiticcl_jax import anahash as ah
from analiticcl_jax.types import PRIMES

from fixtures import get_test_alphabet


def av(text):
    alphabet, _ = get_test_alphabet()
    return ah.anahash(text, alphabet)


def cv(text):
    alphabet, _ = get_test_alphabet()
    return AlphabetEncoder(alphabet).count_vector(text)


def test0001_alphabet():
    alphabet, _ = get_test_alphabet()
    assert len(alphabet) == 27


def test0002_primes():
    for prime in PRIMES:
        for i in range(2, prime):
            assert prime % i != 0


def test0102_empty_hash():
    assert ah.empty_anavalue() == 1
    assert not cv("").any()


def test0103_hash_basic():
    assert av("a") == 2
    assert av("b") == 3
    assert av("c") == 5
    assert av("ab") == 6
    assert av("ba") == 6
    assert av("ab") == av("ba")
    assert av("abc") == 2 * 3 * 5
    assert av("abcabcabc") == (2 * 3 * 5) ** 3


def test0103_hash_alphabet_equivalence():
    assert av("abc") == av("ABC")
    assert av("abc") == av("bAc")
    assert av("a.b") == av("a,b")
    assert np.array_equal(cv("abc"), cv("ABC"))
    assert np.array_equal(cv("a.b"), cv("a,b"))


def test0104_hash_big():
    assert av("xyz" * 24) > 1


def test0105_hash_anagram():
    assert av("stressed") == av("desserts")
    assert av("dormitory") == av("dirtyroom")
    assert av("presents") == av("serpents")
    assert np.array_equal(cv("stressed"), cv("desserts"))


def test0106_hash_insertion():
    assert ah.av_insert(av("ab"), av("c")) == av("abc")
    assert ah.av_insert(av("c"), av("ab")) == av("abc")
    assert np.array_equal(ah.cv_insert(cv("ab"), cv("c")), cv("abc"))


def test0107_hash_containment():
    assert ah.av_contains(av("abc"), av("c"))
    assert ah.av_contains(av("abc"), av("ab"))
    assert ah.av_contains(av("abc"), av("abc"))
    assert not ah.av_contains(av("c"), av("abc"))
    assert not ah.av_contains(av("ab"), av("c"))
    assert not ah.av_contains(av("ab"), av("abc"))
    assert ah.cv_contains(cv("abc"), cv("c"))
    assert not ah.cv_contains(cv("ab"), cv("c"))


def test0108_hash_deletion():
    assert ah.av_delete(av("abc"), av("c")) == av("ab")
    assert ah.av_delete(av("abc"), av("b")) == av("ac")
    assert ah.av_delete(av("c"), av("abc")) is None
    assert ah.av_delete(av("abc"), av("x")) is None
    assert np.array_equal(ah.cv_delete(cv("abc"), cv("c")), cv("ab"))
    assert ah.cv_delete(cv("abc"), cv("x")) is None


def test0108_hash_upper_bound():
    assert ah.cv_alphabet_upper_bound(cv("abc")) == (2, 3)
    assert ah.cv_alphabet_upper_bound(cv("ab")) == (1, 2)
    assert ah.cv_alphabet_upper_bound(cv("x")) == (23, 1)


def test_counts_roundtrip():
    for word in ("house", "stressed", "xyzzy", "a", ""):
        counts = cv(word)
        value = ah.counts_to_anavalue(counts)
        assert value == av(word)
        back = ah.anavalue_to_counts(value, len(counts))
        assert np.array_equal(back, counts)


def test_anagram_distance():
    assert ah.cv_anagram_distance(cv("abc"), cv("abc")) == 0
    assert ah.cv_anagram_distance(cv("abc"), cv("ab")) == 1
    assert ah.cv_anagram_distance(cv("abc"), cv("abd")) == 2
    assert ah.cv_anagram_distance(cv("abc"), cv("xyz")) == 6
