"""Property-based parity: random lexicons/params, device vs oracle bit-equal."""

import dataclasses
import random
import string

import pytest

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    Weights,
)
from analiticcl_jax.vocab import VocabParams, VocabType


def _result_tuples(model, results):
    return [
        (
            model.decoder[r.vocab_id].text,
            round(r.dist_score, 12),
            round(r.freq_score, 12),
            r.via,
        )
        for r in results
    ]


def _random_word(rng, alpha):
    return "".join(rng.choice(alpha) for _ in range(rng.randint(1, 12)))


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_device_oracle_parity(seed):
    rng = random.Random(seed)
    # random small alphabet (sometimes with multichar elements and case folds)
    letters = string.ascii_lowercase[: rng.randint(5, 14)]
    alphabet = [[c, c.upper()] for c in letters]
    if rng.random() < 0.5:
        alphabet.append(["ch", "c"])  # multichar element exercising greediness
    alpha = letters

    model = VariantModel(
        alphabet=alphabet,
        weights=Weights(
            ld=rng.choice([0.5, 1.0]),
            lcs=rng.choice([0.0, 0.125, 0.5]),
            prefix=rng.choice([0.0, 0.125]),
            suffix=rng.choice([0.0, 0.125]),
            case=rng.choice([0.0, 0.125]),
        ),
    )
    nwords = rng.randint(50, 1200)
    params_v = VocabParams()
    for _ in range(nwords):
        model.add_to_vocabulary(
            _random_word(rng, alpha), rng.randint(1, 100), params_v
        )
    if rng.random() < 0.5:
        model.have_freq = True
    if rng.random() < 0.3:
        # transparent variants in the mix
        ref = model.add_to_vocabulary(_random_word(rng, alpha), 5, params_v)
        model.add_variant(
            ref,
            _random_word(rng, alpha),
            0.8,
            None,
            params_v.with_vocab_type(VocabType.INDEXED | VocabType.TRANSPARENT),
        )
    model.build()

    params = SearchParameters(
        max_anagram_distance=rng.choice(
            [
                DistanceThreshold.absolute(rng.randint(1, 4)),
                DistanceThreshold.ratio_of(rng.choice([0.25, 0.5])),
                DistanceThreshold.ratio_with_limit(0.5, 3),
            ]
        ),
        max_edit_distance=DistanceThreshold.absolute(rng.randint(1, 3)),
        max_matches=rng.choice([0, 1, 3, 10]),
        score_threshold=rng.choice([0.0, 0.25, 0.5]),
        cutoff_threshold=rng.choice([0.0, 1.5, 2.0]),
        freq_weight=rng.choice([0.0, 0.5, 1.0]),
        stop_criterion=rng.choice(
            [StopCriterion.EXHAUSTIVE, StopCriterion.STOP_AT_EXACT_MATCH]
        ),
    )

    queries = [_random_word(rng, alpha + alpha.upper()) for _ in range(24)]
    # include exact lexicon hits and empty-ish cases
    queries += [model.decoder[i].text for i in range(3, min(8, len(model.decoder)))]
    # and queries with out-of-alphabet characters (UNK class handling)
    queries += [
        _random_word(rng, alpha + "09!€?汉") for _ in range(6)
    ] + ["??", ""]

    model.set_backend("oracle")
    want = [model.find_variants(q, params) for q in queries]
    model.set_backend("device")
    got = model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(model, g) == _result_tuples(model, w), (
            seed,
            q,
            params,
        )


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_confusables_parity(seed):
    """Device vs oracle with confusable lists active (exercises the object
    ranking tail + native confusable matcher end to end)."""
    import os
    import tempfile

    rng = random.Random(seed + 900)
    letters = string.ascii_lowercase[: rng.randint(5, 10)]
    alphabet = [[c, c.upper()] for c in letters]
    model = VariantModel(alphabet=alphabet, weights=Weights())
    words = []
    for _ in range(rng.randint(80, 500)):
        w = "".join(rng.choice(letters) for _ in range(rng.randint(2, 10)))
        words.append(w)
        model.add_to_vocabulary(w, rng.randint(1, 100), VocabParams())
    model.have_freq = rng.random() < 0.5
    cf = tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False)
    for _ in range(rng.randint(1, 6)):
        a, b = rng.choice(letters), rng.choice(letters)
        kind = rng.random()
        if kind < 0.4:
            pat = f"-[{a}]+[{b}]"
        elif kind < 0.7:
            pat = f"^=[{a}]-[{b}]"
        else:
            pat = f"-[{a}{b}]+[{b}]$"
        cf.write(f"{pat}\t{rng.choice([0.8, 1.1, 1.3])}\n")
    cf.close()
    model.read_confusablelist(cf.name)
    os.unlink(cf.name)
    model.build()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(rng.randint(1, 3)),
        max_edit_distance=DistanceThreshold.absolute(rng.randint(1, 3)),
        max_matches=rng.choice([3, 10]),
        score_threshold=rng.choice([0.0, 0.25]),
        cutoff_threshold=rng.choice([0.0, 2.0]),
        freq_weight=rng.choice([0.0, 1.0]),
    )

    def corrupt(w):
        if len(w) < 3:
            return w
        i = rng.randrange(len(w) - 1)
        return w[:i] + w[i + 1] + w[i] + w[i + 2:]

    queries = [corrupt(rng.choice(words)) for _ in range(20)]
    model.set_backend("oracle")
    want = [model.find_variants(q, params) for q in queries]
    model.set_backend("device")
    got = model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(model, g) == _result_tuples(model, w), (seed, q)
