"""analiticcl-compatible Python API tests (mirrors
/root/reference/bindings/python/tests/tests.py plus surface checks)."""

import pytest

from analiticcl_jax.api import (
    SearchParameters,
    VariantModel,
    VocabParams,
    Weights,
)

ALPHABET = "/root/reference/examples/simple.alphabet.tsv"
LEXICON_AMPHIBIANS = "/root/reference/bindings/python/tests/amphibians.tsv"
LEXICON_REPTILES = "/root/reference/bindings/python/tests/reptiles.tsv"


def test_find_all_matches_with_multiple_lexicons():
    model = VariantModel(ALPHABET, Weights(), debug=False)
    model.read_lexicon(LEXICON_AMPHIBIANS)
    model.read_lexicon(LEXICON_REPTILES)
    model.build()
    results = model.find_all_matches(
        "Salamander lizard frog snake toad",
        SearchParameters(max_edit_distance=3, max_ngram=1),
    )
    assert len(results) == 5

    def assert_result(result, orig_term, lexicon, lex_term=None):
        lex_term = lex_term or orig_term
        assert result["input"] == orig_term
        assert len(result["variants"]) > 0
        best = result["variants"][0]
        assert best["text"] == lex_term
        assert best["lexicons"] == [lexicon]

    assert_result(results[0], "Salamander", LEXICON_AMPHIBIANS, "salamander")
    assert_result(results[1], "lizard", LEXICON_REPTILES)
    assert_result(results[2], "frog", LEXICON_AMPHIBIANS)
    assert_result(results[3], "snake", LEXICON_REPTILES)
    assert_result(results[4], "toad", LEXICON_AMPHIBIANS)


def test_weights_kwargs_and_attrs():
    w = Weights(ld=1.0, lcs=0.5)
    assert w.ld == 1.0
    assert w.lcs == 0.5
    w.prefix = 0.25
    assert w.to_dict()["prefix"] == 0.25
    # reference warns and ignores unknown kwargs (bindings lib.rs:49)
    w2 = Weights(bogus=1)
    assert w2.to_dict() == Weights().to_dict()


def test_searchparameters_kwargs_and_threshold_coercion():
    p = SearchParameters(
        max_edit_distance=3,
        max_anagram_distance=(0.4, 5),
        max_matches=7,
        stop_at_exact_match=True,
    )
    assert p.max_edit_distance == 3
    assert p.max_anagram_distance == (0.4, 5)
    assert p.max_matches == 7
    assert p.stop_at_exact_match
    p.max_edit_distance = 0.3
    assert p.max_edit_distance == pytest.approx(0.3)
    p.stop_at_exact_match = False
    assert not p.stop_at_exact_match
    d = p.to_dict()
    assert d["max_matches"] == 7


def test_core_searchparameters_coerces_loose_thresholds():
    # the CORE dataclass (package root), not the api wrapper: loose int /
    # float / "r;limit" threshold spellings must coerce in __post_init__
    # instead of crashing deep in the pipeline (round-5 verify finding)
    from analiticcl_jax.types import (
        DistanceThreshold,
        SearchParameters as CoreParams,
        ThresholdKind,
    )

    p = CoreParams(max_edit_distance=2, max_anagram_distance="0.3;5")
    assert isinstance(p.max_edit_distance, DistanceThreshold)
    assert p.max_edit_distance.kind is ThresholdKind.ABSOLUTE
    assert p.max_edit_distance.limit == 2
    assert p.max_anagram_distance.kind is ThresholdKind.RATIO_WITH_LIMIT
    assert p.max_anagram_distance.ratio == pytest.approx(0.3)
    assert p.max_anagram_distance.limit == 5
    q = CoreParams(max_edit_distance=0.5)
    assert q.max_edit_distance.kind is ThresholdKind.RATIO
    # already-typed thresholds pass through untouched
    t = DistanceThreshold.absolute(4)
    assert CoreParams(max_edit_distance=t).max_edit_distance is t


def test_vocabparams_kwargs():
    vp = VocabParams(text_column=2, freq_column=None, vocabtype="LM", freqhandling="sum")
    assert vp.text_column == 2
    assert vp.freq_column is None


def test_find_variants_and_par():
    model = VariantModel(ALPHABET, Weights(), debug=0)
    model.read_lexicon(LEXICON_AMPHIBIANS)
    model.build()
    params = SearchParameters(max_edit_distance=2, score_threshold=0.0)
    res = model.find_variants("frog", params)
    assert res[0]["text"] == "frog"
    assert res[0]["score"] == 1.0
    assert res[0]["lexicons"] == [LEXICON_AMPHIBIANS]
    assert "dist_score" in res[0] and "freq_score" in res[0]

    par = model.find_variants_par(["frog", "saalamander"], params)
    assert par[0]["input"] == "frog"
    assert par[0]["variants"][0]["text"] == "frog"
    assert par[1]["variants"][0]["text"] == "salamander"


def test_contains():
    model = VariantModel(ALPHABET, Weights(), debug=0)
    model.read_lexicon(LEXICON_AMPHIBIANS)
    model.build()
    assert "frog" in model
    assert "xyzzy" not in model


def test_binding_surface_parity():
    """Every method the reference PyO3 binding exposes must exist on our api
    classes (bindings/python/src/lib.rs)."""
    import re

    import analiticcl_jax.api as api

    src = open("/root/reference/bindings/python/src/lib.rs").read()
    names = set(re.findall(r"fn ([a-z_0-9]+)", src))
    names -= {"analiticcl", "new", "extract_distance_threshold"}  # module/ctor/helper
    missing = []
    for name in sorted(names):
        if name.startswith(("get_", "set_")):
            attr = name[4:]
            targets = (
                api.Weights,
                api.SearchParameters,
                api.VocabParams,
                api.VariantModel,
            )
            ok = any(
                hasattr(t, attr)
                or hasattr(t, name)  # explicit getter/setter method
                or attr in getattr(t, "_FIELDS", ())
                for t in targets
            )
            # kwargs/attribute-style delegation: instantiating and touching
            # the attribute is the real check
            if not ok:
                for t in (api.Weights(), api.SearchParameters(), api.VocabParams()):
                    try:
                        getattr(t, attr)
                        ok = True
                        break
                    except AttributeError:
                        continue
            if not ok and attr in ("stop_at_exact_match", "confusables_before_pruning"):
                ok = hasattr(api.SearchParameters(), attr)
            if not ok:
                missing.append(name)
        else:
            if not (
                hasattr(api.VariantModel, name)
                or hasattr(api.SearchParameters, name)
                or hasattr(api.Weights, name)
            ):
                missing.append(name)
    assert not missing, f"binding surface gaps: {missing}"


def test_search_mode_backend_parity_fuzz():
    """find_all_matches must be identical between the device (JAX) and oracle
    backends on randomized lexicons, LMs, and texts."""
    import random

    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.types import (
        DistanceThreshold,
        SearchParameters,
        Weights,
    )
    from analiticcl_jax.vocab import VocabParams, VocabType

    for seed in range(4):
        rng = random.Random(seed + 100)
        alpha = "abcdefghij"
        alphabet = [[c, c.upper()] for c in alpha]
        model = VariantModel(alphabet=alphabet, weights=Weights())
        words = []
        for _ in range(rng.randint(40, 200)):
            w = "".join(rng.choice(alpha) for _ in range(rng.randint(2, 9)))
            words.append(w)
            model.add_to_vocabulary(w, rng.randint(1, 50), VocabParams())
        lm = VocabParams(vocab_type=VocabType.LM)
        for _ in range(rng.randint(0, 12)):
            a, b = rng.choice(words), rng.choice(words)
            model.add_to_vocabulary(f"{a} {b}", rng.randint(1, 5), lm)
        model.build()

        def corrupt(w):
            if len(w) < 3:
                return w
            i = rng.randrange(len(w) - 1)
            return w[:i] + w[i + 1] + w[i] + w[i + 2:]

        sents = []
        for _ in range(6):
            sents.append(
                " ".join(corrupt(rng.choice(words)) for _ in range(rng.randint(3, 10)))
                + rng.choice([".", "!", ""])
            )
        text = "\n".join(sents)
        params = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(2),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=5,
            max_ngram=rng.choice([1, 2]),
            lm_weight=rng.choice([0.0, 1.0]),
        )

        def snap(model, matches):
            out = []
            for m in matches:
                var = None
                if m.selected is not None and m.variants:
                    r = m.variants[m.selected]
                    var = (model.decoder[r.vocab_id].text, round(r.dist_score, 12))
                out.append((m.text, m.offset.begin, m.offset.end, var))
            return out

        model.set_backend("oracle")
        want = snap(model, model.find_all_matches(text, params))
        model.set_backend("device")
        got = snap(model, model.find_all_matches(text, params))
        assert got == want, (seed, text)


def test_former_package_name_is_an_alias():
    """The package's former import name resolves to the same module objects,
    so code written against it keeps working."""
    import analiticcl_jax
    import analiticcl_jax.cli
    import analiticcl_jax.models.variant_model as vm
    import analiticcl_tpu
    import analiticcl_tpu.cli
    from analiticcl_tpu.models.variant_model import VariantModel as Old

    assert analiticcl_tpu is analiticcl_jax
    assert analiticcl_tpu.cli is analiticcl_jax.cli
    assert Old is vm.VariantModel
