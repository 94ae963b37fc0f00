"""Learn-mode and checkpoint/resume tests."""

import dataclasses

import pytest

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import VariantReferenceKind, Weights
from analiticcl_jax.vocab import VocabParams, VocabType

from fixtures import get_test_alphabet, get_test_searchparams


def _model(words=("right", "think", "you", "are")):
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in words:
        model.add_to_vocabulary(w, 2, VocabParams())
    model.build()
    return model


def test_learn_strict_adds_transparent_variants():
    model = _model()
    count = model.learn_variants(
        ["rihgt", "thinck", "rihgt"], get_test_searchparams(), strict=True
    )
    assert count > 0
    # learned variants become transparent vocabulary entries with links
    vid = model.encoder["rihgt"]
    item = model.decoder[vid]
    assert item.vocabtype.check(VocabType.TRANSPARENT)
    assert any(
        ref.kind is VariantReferenceKind.VARIANT_OF for ref in item.variants
    )
    # non-consecutive re-occurrence increments frequency (lib.rs:1109-1113;
    # consecutive repeats of the same input do not)
    assert item.frequency == 2
    # a later query for the learned form resolves to the canonical word
    results = model.find_variants("rihgt", get_test_searchparams())
    texts = [model.decoder[r.vocab_id].text for r in results]
    assert "right" in texts
    assert "rihgt" not in texts  # transparent: never a solution itself


def test_learn_repeat_does_not_grow_links():
    model = _model()
    first = model.learn_variants(["rihgt"], get_test_searchparams(), strict=True)
    assert first > 0
    right = model.encoder["right"]
    nrefs = len(model.decoder[right].variants)
    # Re-learning reports counts again (the reference's add_variant_by_id
    # returns true for existing links too, lib.rs:478-514). The ReferenceFor
    # side dedups first-mention-wins; the VariantOf side duplicates, mirroring
    # the reference's comparison quirk (lib.rs:502 compares against the wrong
    # id) — expansion dedup downstream absorbs the duplicates.
    second = model.learn_variants(["rihgt"], get_test_searchparams(), strict=True)
    assert second >= 0
    assert len(model.decoder[right].variants) == nrefs
    results = model.find_variants("rihgt", get_test_searchparams())
    assert [model.decoder[r.vocab_id].text for r in results].count("right") == 1


def test_learn_search_mode():
    model = _model()
    params = dataclasses.replace(get_test_searchparams(), max_ngram=1)
    count = model.learn_variants(
        ["you are rihgt"], params, strict=False
    )
    assert count > 0
    assert "rihgt" in model.encoder


def test_checkpoint_roundtrip(tmp_path):
    model = _model()
    model.add_to_confusables("-[y]+[i]", 1.1)
    model.add_contextrule("you; are", 1.1, ["tag1"], [])
    model.add_to_vocabulary(
        "you are", 2, VocabParams(vocab_type=VocabType.LM)
    )
    model.have_freq = True
    model.build()
    params = get_test_searchparams()
    want = [
        [
            (model.decoder[r.vocab_id].text, r.dist_score, r.freq_score)
            for r in model.find_variants(q, params)
        ]
        for q in ("rihgt", "thinck", "yuo")
    ]

    path = str(tmp_path / "model.npz")
    model.save(path)
    restored = VariantModel.load(path)
    got = [
        [
            (restored.decoder[r.vocab_id].text, r.dist_score, r.freq_score)
            for r in restored.find_variants(q, params)
        ]
        for q in ("rihgt", "thinck", "yuo")
    ]
    assert got == want
    assert restored.ngrams == model.ngrams
    assert restored.tags == model.tags
    assert len(restored.context_rules) == len(model.context_rules)
    assert len(restored.confusables) == len(model.confusables)
    assert restored.have_freq == model.have_freq
    # confusable behavior survives the roundtrip
    r1 = restored.find_variants("huys", params)  # no huis in lexicon: empty ok
    # search mode works post-restore
    matches = restored.find_all_matches("you are rihgt", params)
    assert matches


def test_checkpoint_learn_resume(tmp_path):
    model = _model()
    model.learn_variants(["rihgt"], get_test_searchparams(), strict=True)
    path = str(tmp_path / "learned.npz")
    model.save(path)
    restored = VariantModel.load(path)
    # the learned transparent variant + links survive
    vid = restored.encoder["rihgt"]
    assert restored.decoder[vid].vocabtype.check(VocabType.TRANSPARENT)
    assert restored.decoder[vid].variants
    results = restored.find_variants("rihgt", get_test_searchparams())
    assert "right" in [restored.decoder[r.vocab_id].text for r in results]


def test_learn_strict_device_equals_oracle():
    """Strict learn through the ranked device stream (survivor arrays, no
    VariantResult objects) must produce the same vocabulary, links, and
    frequencies as the oracle path."""
    words = (
        "right", "think", "you", "are", "rites", "tiers", "tires", "tries",
        "tyres", "rides", "brides", "dire", "bride", "happy", "earth",
    )
    corpus = [
        "rihgt", "thinck", "rihgt", "tirse", "brid", "erth", "hapy",
        "rihgt", "tirse",
    ]

    def snapshot(model):
        out = []
        for v in model.decoder:
            links = (
                None
                if v.variants is None
                else [(r.kind, r.vocab_id, r.score) for r in v.variants]
            )
            out.append((v.text, v.frequency, int(v.vocabtype), links))
        return out

    results = {}
    for backend in ("oracle", "device"):
        model = _model(words)
        model.set_backend(backend)
        count = model.learn_variants(
            list(corpus), get_test_searchparams(), strict=True
        )
        results[backend] = (count, snapshot(model))
    assert results["device"] == results["oracle"]


def test_learn_incremental_rebuild_equals_full_build():
    """A strict-learn iteration only appends TRANSPARENT (non-indexed)
    entries and bumps frequencies, so auto_build degrades to a freqs
    refresh (learn_profile.build_mode == 'freq_refresh'); the resulting
    index and query results must be bit-identical to a forced full
    build()."""
    import numpy as np

    corpus = ["rihgt", "thinck", "rihgt", "yuo", "aer", "thinck"]
    params = get_test_searchparams()

    m_inc = _model()
    m_full = _model()
    c1 = m_inc.learn_variants(corpus, params, strict=True, auto_build=True)
    assert m_inc.learn_profile["build_mode"] == "freq_refresh"
    c2 = m_full.learn_variants(corpus, params, strict=True, auto_build=False)
    m_full.build()
    assert c1 == c2

    a, b = m_inc.index, m_full.index
    np.testing.assert_array_equal(a.vocab_ids, b.vocab_ids)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.norms, b.norms)
    np.testing.assert_array_equal(a.freqs, b.freqs)
    np.testing.assert_array_equal(a.first_lower, b.first_lower)
    np.testing.assert_array_equal(a.group_ranges, b.group_ranges)

    def tuples(m, res):
        return [
            (m.decoder[r.vocab_id].text, r.dist_score, r.freq_score)
            for r in res
        ]

    for q in ["rihgt", "thinck", "right", "yuo"]:
        assert tuples(m_inc, m_inc.find_variants(q, params)) == tuples(
            m_full, m_full.find_variants(q, params)
        ), q

    # a second iteration on the refreshed model keeps converging
    c3 = m_inc.learn_variants(corpus, params, strict=True, auto_build=True)
    assert c3 >= 0


def test_learn_full_rebuild_when_lm_frequency_touched():
    """Bumping an LM-typed entry's frequency invalidates the LM tables, so
    auto_build must take the full path."""
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("right", "think", "you"):
        model.add_to_vocabulary(w, 2, VocabParams())
    model.add_to_vocabulary(
        "tonight", 3, VocabParams(vocab_type=VocabType.LM | VocabType.INDEXED)
    )
    model.build()
    # "tonight" is an exact input occurrence: its frequency increments, and
    # since it is LM-typed the LM tables depend on it
    model.learn_variants(
        ["tonight", "rihgt"], get_test_searchparams(), strict=True,
        auto_build=True,
    )
    assert model.learn_profile["build_mode"] == "full"


def test_learn_incremental_rebuild_keeps_variant_expansions_on_device(tmp_path):
    """After a strict-learn iteration that only refreshes frequencies, the
    device pipeline must see the variant links learn added to indexed
    entries (their results expand through the object tail), exactly as the
    oracle does (a learned input that is itself an indexed word gets links).
    A generated 6,000-entry lexicon keeps the device backend in play (it
    needs 64+ index rows)."""
    from analiticcl_jax import datagen
    from analiticcl_jax.types import DistanceThreshold, SearchParameters

    data = datagen.make_dataset(
        str(tmp_path), seed=3, n_entries=6000, n_queries=2400, n_lines=1
    )
    model = VariantModel(alphabet_file=data["alphabet"])
    model.read_vocabulary(data["lexicon"], VocabParams())
    model.build()
    model.set_backend("device")
    with open(data["queries"], encoding="utf-8") as f:
        queries = f.read().split()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=3, score_threshold=0.7,
    )
    model.find_variants_batch(queries[:8], params)  # device pipeline is live
    learned = model.learn_variants(
        queries[:2000], params, strict=True, auto_build=True
    )
    assert learned > 0
    assert model.learn_profile["build_mode"] == "freq_refresh"

    def tuples(res):
        return [
            [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
             for r in rs]
            for rs in res
        ]

    probe = queries
    got = tuples(model.find_variants_batch(probe, params))
    model.set_backend("oracle")
    want = tuples(model.find_variants_batch(probe, params))
    assert any(r[3] is not None for rs in want for r in rs)
    assert got == want
