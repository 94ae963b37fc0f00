"""Deletion iterator parity tests (reference tests/main.rs 02xx)."""

import numpy as np

from analiticcl_jax.alphabet import AlphabetEncoder
from analiticcl_jax import anahash as ah
from analiticcl_jax.iterators import (
    RecurseDeletionIterator,
    iter_deletions,
    iter_values,
)

from fixtures import get_test_alphabet

ALPHABET, ALPHABET_SIZE = get_test_alphabet()
ENC = AlphabetEncoder(ALPHABET)


def cv(text):
    return ENC.count_vector(text)


def to_av(counts):
    return ah.counts_to_anavalue(counts)


def test0201_iterator_parents():
    anavalue = cv("house")
    chars = []
    deletions = []
    for deletion in iter_deletions(anavalue):
        chars.append(ah.character(deletion.charindex))
        deletions.append(to_av(deletion.value))
    assert len(chars) == 5
    assert chars == [
        ah.anahash(c, ALPHABET) for c in ("u", "s", "o", "h", "e")
    ]
    assert deletions == [
        ah.anahash(w, ALPHABET) for w in ("hose", "houe", "huse", "ouse", "hous")
    ]


def test0202_iterator_parents_dup():
    anavalue = cv("pass")
    chars = []
    deletions = []
    for deletion in iter_deletions(anavalue):
        chars.append(ah.character(deletion.charindex))
        deletions.append(to_av(deletion.value))
    assert len(chars) == 3
    assert chars == [ah.anahash(c, ALPHABET) for c in ("s", "p", "a")]
    assert deletions == [ah.anahash(w, ALPHABET) for w in ("pas", "ass", "pss")]


def test0203_iterator_recursive_singlebeam():
    anavalue = cv("house")
    chars, deletions, depths = [], [], []
    for deletion, depth in iter_values(anavalue):
        chars.append(ah.character(deletion.charindex))
        deletions.append(to_av(deletion.value))
        depths.append(depth)
    assert len(chars) == 5
    assert chars == [ah.anahash(c, ALPHABET) for c in ("u", "s", "o", "h", "e")]
    assert deletions == [
        ah.anahash(w, ALPHABET) for w in ("hose", "hoe", "he", "e")
    ] + [1]
    assert depths == [1, 2, 3, 4, 5]


def _collect(text, **kwargs):
    out = []
    for deletion, depth in RecurseDeletionIterator(cv(text), **kwargs):
        out.append((to_av(deletion.value), depth))
    return out


def test0203_iterator_recursive_dfs():
    result = _collect("abcd")
    values = [v for v, _ in result]
    expected_words = [
        "abc", "ab", "a", "", "b", "", "ac", "a", "", "c", "", "bc", "b", "",
        "c", "", "abd", "ab", "a",
    ]
    expected = [ah.anahash(w, ALPHABET) for w in expected_words]
    assert values[: len(expected)] == expected


def test0203_iterator_recursive_no_empty_leaves():
    result = _collect("abcd", empty_leaves=False)
    values = [v for v, _ in result]
    expected_words = [
        "abc", "ab", "a", "b", "ac", "a", "c", "bc", "b", "c", "abd", "ab", "a",
    ]
    expected = [ah.anahash(w, ALPHABET) for w in expected_words]
    assert values[: len(expected)] == expected


def test0203_iterator_recursive_no_duplicates():
    result = _collect("abcd", empty_leaves=False, unique=True)
    values = [v for v, _ in result]
    expected_words = ["abc", "ab", "a", "b", "ac", "c", "bc", "abd"]
    expected = [ah.anahash(w, ALPHABET) for w in expected_words]
    assert values[: len(expected)] == expected


def test0203_iterator_recursive_bfs():
    result = _collect("abcd", breadthfirst=True)
    expected_words_depths = [
        ("abc", 1), ("abd", 1), ("acd", 1), ("bcd", 1),
        ("ab", 2), ("ac", 2), ("bc", 2),
        ("ab", 2), ("ad", 2), ("bd", 2),
        ("ac", 2), ("ad", 2), ("cd", 2),
        ("bc", 2), ("bd", 2), ("cd", 2),
        ("a", 3), ("b", 3),
        ("a", 3), ("c", 3),
    ]
    expected = [(ah.anahash(w, ALPHABET), d) for w, d in expected_words_depths]
    assert result[: len(expected)] == expected


def test0203_iterator_recursive_bfs_no_duplicates():
    result = _collect("abcd", breadthfirst=True, unique=True, empty_leaves=False)
    expected_words_depths = [
        ("abc", 1), ("abd", 1), ("acd", 1), ("bcd", 1),
        ("ab", 2), ("ac", 2), ("bc", 2), ("ad", 2), ("bd", 2), ("cd", 2),
        ("a", 3), ("b", 3), ("c", 3), ("d", 3),
    ]
    expected = [(ah.anahash(w, ALPHABET), d) for w, d in expected_words_depths]
    assert result == expected


def test0203_iterator_recursive_bfs_max_dist():
    result = _collect(
        "abcd", breadthfirst=True, unique=True, empty_leaves=False, maxdepth=3
    )
    expected_words_depths = [
        ("abc", 1), ("abd", 1), ("acd", 1), ("bcd", 1),
        ("ab", 2), ("ac", 2), ("bc", 2), ("ad", 2), ("bd", 2), ("cd", 2),
        ("a", 3), ("b", 3), ("c", 3), ("d", 3),
    ]
    expected = [(ah.anahash(w, ALPHABET), d) for w, d in expected_words_depths]
    assert result == expected


def test0203_iterator_recursive_bfs_max_dist2():
    result = _collect(
        "abcd", breadthfirst=True, unique=True, empty_leaves=False, maxdepth=2
    )
    expected_words_depths = [
        ("abc", 1), ("abd", 1), ("acd", 1), ("bcd", 1),
        ("ab", 2), ("ac", 2), ("bc", 2), ("ad", 2), ("bd", 2), ("cd", 2),
    ]
    expected = [(ah.anahash(w, ALPHABET), d) for w, d in expected_words_depths]
    assert result == expected


def test_deletion_neighborhood_matches_bfs_iterator():
    """The batched neighborhood enumerator must reproduce the BFS-unique order
    used by the reference's find_nearest_anahashes (lib.rs:1202-1213)."""
    for word in ("abcd", "pass", "house", "stressed"):
        counts = cv(word)
        got = [
            (to_av(v), d)
            for v, d in ah.deletion_neighborhood(counts, max_distance=3)
        ]
        expected = [
            (to_av(node.value), depth)
            for node, depth in RecurseDeletionIterator(
                counts,
                breadthfirst=True,
                unique=True,
                empty_leaves=False,
                maxdepth=3,
            )
        ]
        assert got == expected
