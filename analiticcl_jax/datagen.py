"""Seeded synthetic data shaped like the reference's English example data.

The reference ships an alphabet (``simple.alphabet.tsv``) and the
eng.aspell lexicon (119,773 entries). Those files are not part of this
repository, so the smoke run, the benchmark and the tests generate data of
the same shape from a seed. Everything the generator assumes is stated
here:

  * the alphabet: one line per letter with its upper-case form, one per
    digit, and a handful of punctuation classes (like simple.alphabet.tsv);
  * word lengths follow ``LENGTH_WEIGHTS`` (an English dictionary's shape:
    mode 8, tail to 30 characters, so the padded norm length L is real);
  * characters are drawn from English letter frequencies (``LETTER_FREQ``);
    ``CAPITALIZED_SHARE`` of the entries are capitalised (proper nouns) and
    ``POSSESSIVE_SHARE`` end in "'s", as aspell's English list does;
  * frequencies are Zipfian with exponent ``ZIPF_S`` over a random rank
    order, capped at ``MAX_FREQ``;
  * queries are lexicon words with one edit (``corrupt``), running text is
    sentences of such words, and the LM counts the text's clean bigrams.

Command line: ``python -m analiticcl_jax.datagen OUTDIR [--seed N]``.
"""

from __future__ import annotations

import os
import random
import string
from typing import Dict, List, Sequence

import numpy as np

ENG_ASPELL_ENTRIES = 119_773
ROWS_1M = 1_000_000  # the background-lexicon scale (BASELINE.md configs[4])

# share of entries per word length 1..30
LENGTH_WEIGHTS = np.array([
    0.1, 0.5, 2.0, 4.5, 7.5, 10.5, 12.5, 13.0, 12.5, 10.5,
    8.0, 6.0, 4.2, 2.8, 1.8, 1.2, 0.8, 0.5, 0.35, 0.25,
    0.17, 0.12, 0.08, 0.06, 0.04, 0.03, 0.02, 0.015, 0.01, 0.01,
])
# English letter frequencies (per cent, a..z)
LETTER_FREQ = np.array([
    8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4,
    6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074,
])
CAPITALIZED_SHARE = 0.12
POSSESSIVE_SHARE = 0.06
ZIPF_S = 1.0
MAX_FREQ = 1_000_000
PUNCTUATION = [".", ",", ":", ";", "!", "?", "-", "'", '"', "(", ")", "/"]


def alphabet_rows() -> List[List[str]]:
    """Equivalence classes shaped like the reference's simple alphabet."""
    rows = [[c, c.upper()] for c in string.ascii_lowercase]
    rows += [[d] for d in string.digits]
    rows += [[p] for p in PUNCTUATION]
    return rows


def write_alphabet(path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for row in alphabet_rows():
            f.write("\t".join(row) + "\n")
    return path


def lexicon_words(n: int, seed: int) -> List[str]:
    """``n`` distinct words with the length and character distributions
    above, in generation order."""
    rng = np.random.default_rng(seed)
    lens_p = LENGTH_WEIGHTS / LENGTH_WEIGHTS.sum()
    char_p = LETTER_FREQ / LETTER_FREQ.sum()
    letters = np.array(list(string.ascii_lowercase))
    words: Dict[str, None] = {}
    while len(words) < n:
        m = int((n - len(words)) * 1.1) + 16
        lens = rng.choice(np.arange(1, 31), size=m, p=lens_p)
        chars = letters[rng.choice(26, size=int(lens.sum()), p=char_p)]
        cap = rng.random(m) < CAPITALIZED_SHARE
        poss = rng.random(m) < POSSESSIVE_SHARE
        ends = np.cumsum(lens)
        for k, (end, ln) in enumerate(zip(ends.tolist(), lens.tolist())):
            w = "".join(chars[end - ln : end])
            if cap[k]:
                w = w[0].upper() + w[1:]
            if poss[k] and ln <= 27:
                w += "'s"
            words.setdefault(w)
            if len(words) == n:
                break
    return list(words)


def zipf_freqs(n: int, seed: int) -> np.ndarray:
    """Zipfian frequencies over a random rank order."""
    rng = np.random.default_rng(seed + 1)
    ranks = rng.permutation(n) + 1
    return np.maximum(1, (MAX_FREQ / ranks.astype(np.float64) ** ZIPF_S)).astype(
        np.int64
    )


def write_lexicon(path: str, words: Sequence[str], freqs: np.ndarray) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(f"{w}\t{int(c)}\n" for w, c in zip(words, freqs)))
    return path


def corrupt(word: str, rng: random.Random) -> str:
    """One random edit (deletion, transposition, insertion, substitution)
    to a word of 4+ characters; shorter words pass through."""
    if len(word) < 4:
        return word
    i = rng.randrange(len(word) - 1)
    choice = rng.randrange(4)
    if choice == 0:  # deletion
        return word[:i] + word[i + 1 :]
    if choice == 1:  # transposition
        return word[:i] + word[i + 1] + word[i] + word[i + 2 :]
    if choice == 2:  # insertion
        return word[:i] + "x" + word[i:]
    return word[:i] + "q" + word[i + 1 :]  # substitution


def queries(words: Sequence[str], n: int, seed: int, stride: int = 7) -> List[str]:
    """``n`` corrupted queries from every ``stride``-th lexicon word."""
    rng = random.Random(seed)
    picked = words[3::stride]
    return [corrupt(picked[i % len(picked)], rng) for i in range(n)]


def running_text(
    words: Sequence[str], n_lines: int, seed: int, words_per_line: int = 12
) -> List[str]:
    """Lines of running text: sentences of lexicon words, each corrupted
    with one edit, ending in a full stop."""
    rng = random.Random(seed)
    common = list(words[: max(1, len(words) // 8)])
    lines = []
    for _ in range(n_lines):
        toks = [rng.choice(common) for _ in range(words_per_line)]
        lines.append(" ".join(corrupt(t, rng) for t in toks) + ".")
    return lines


def lm_counts(
    words: Sequence[str], n_sentences: int, seed: int, words_per_line: int = 12
) -> Dict[str, int]:
    """Bigram counts of clean sentences over the same common words the
    running text draws from (the LM a search run loads)."""
    rng = random.Random(seed + 2)
    common = list(words[: max(1, len(words) // 8)])
    counts: Dict[str, int] = {}
    for _ in range(n_sentences):
        toks = [rng.choice(common) for _ in range(words_per_line)]
        for a, b in zip(toks, toks[1:]):
            counts[f"{a} {b}"] = counts.get(f"{a} {b}", 0) + 1
    return counts


def make_dataset(
    outdir: str, seed: int = 0, n_entries: int = ENG_ASPELL_ENTRIES,
    n_queries: int = 8192, n_lines: int = 200,
) -> Dict[str, str]:
    """Write alphabet, lexicon, queries, running text and LM into ``outdir``;
    returns their paths by name."""
    os.makedirs(outdir, exist_ok=True)
    words = lexicon_words(n_entries, seed)
    paths = {
        "alphabet": write_alphabet(os.path.join(outdir, "alphabet.tsv")),
        "lexicon": write_lexicon(
            os.path.join(outdir, "lexicon.tsv"), words,
            zipf_freqs(n_entries, seed),
        ),
    }
    qpath = os.path.join(outdir, "queries.txt")
    with open(qpath, "w", encoding="utf-8") as f:
        f.write("\n".join(queries(words, n_queries, seed)) + "\n")
    paths["queries"] = qpath
    tpath = os.path.join(outdir, "text.txt")
    with open(tpath, "w", encoding="utf-8") as f:
        f.write("\n".join(running_text(words, n_lines, seed + 3)) + "\n")
    paths["text"] = tpath
    lm = lm_counts(words, 4 * n_lines, seed)
    paths["lm"] = write_lexicon(
        os.path.join(outdir, "lm.tsv"), list(lm), np.array(list(lm.values()))
    )
    return paths


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entries", type=int, default=ENG_ASPELL_ENTRIES)
    a = ap.parse_args()
    for name, path in make_dataset(a.outdir, a.seed, a.entries).items():
        print(f"{name}\t{path}")
