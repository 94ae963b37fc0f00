"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import DistanceThreshold, SearchParameters, Weights
from analiticcl_jax.vocab import VocabParams

from analiticcl_jax import datagen
from fixtures import get_test_alphabet, get_test_searchparams

# an eng.aspell-shaped lexicon of 12k entries, generated from a seed
ENG_WORDS = datagen.lexicon_words(12_000, seed=6)


def _result_tuples(model, results):
    return [
        (model.decoder[r.vocab_id].text, round(r.dist_score, 12), round(r.freq_score, 12))
        for r in results
    ]


@pytest.fixture(scope="module")
def eng_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("lex")
    lex = datagen.write_lexicon(
        str(d / "lexicon.tsv"), ENG_WORDS, datagen.zipf_freqs(len(ENG_WORDS), 6)
    )
    model = VariantModel(alphabet_file=datagen.write_alphabet(str(d / "a.tsv")))
    model.read_vocabulary(lex, VocabParams())
    model.build()
    return model


def test_devices_available():
    assert len(jax.devices()) == 8


# lexicon words with one edit (they have matches) and two edge cases
QUERIES = datagen.queries(ENG_WORDS, 6, seed=2, stride=1499) + ["a", "qwrtp"]


def test_sharded_matches_oracle_lex_only(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in QUERIES]
    eng_model.use_mesh(dp=1)  # 1 x 8 lexicon shards
    got = eng_model.find_variants_batch(QUERIES, params)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_sharded_matches_oracle_dp_lex(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in QUERIES]
    eng_model.use_mesh(dp=2)  # 2 x 4 mesh: batch + lexicon sharding
    got = eng_model.find_variants_batch(QUERIES, params)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_sharded_small_model():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for text in ["rites", "tiers", "tires", "tries", "tyres", "rides", "brides", "dire"]:
        model.add_to_vocabulary(text, None, VocabParams())
    model.build()
    params = get_test_searchparams()
    model.set_backend("oracle")
    want = [model.find_variants(q, params) for q in ["rite", "tire"]]
    model.use_mesh(dp=2)
    got = model.find_variants_batch(["rite", "tire"], params)
    for w, g in zip(want, got):
        assert _result_tuples(model, g) == _result_tuples(model, w)


def test_sharded_budget_escalation_and_overflow_split(eng_model, monkeypatch):
    """Tiny pair budgets on the mesh: the pipeline must escalate through the
    buckets and, at the top, split the batch rather than truncate — results
    stay oracle-exact throughout."""
    from analiticcl_jax.ops import pipeline as pl_mod
    from analiticcl_jax.parallel.mesh import ShardedPipeline, make_mesh

    # the charcount-interleaved shard layout balances per-shard survivor
    # counts, so buckets must be small enough that balanced shards still
    # overflow them
    monkeypatch.setattr(pl_mod, "P_BUCKETS", (64, 256))
    monkeypatch.setattr(pl_mod, "P2_BUCKETS", (16, 24))

    mesh = make_mesh(jax.devices(), dp=2)
    pipe = ShardedPipeline(eng_model, mesh)
    assert pipe._budgets(8) == (64, 16)  # smallest buckets on CPU

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in QUERIES]
    # enough queries that per-shard pair totals overflow even the top bucket,
    # forcing escalation AND the split fallback
    queries = QUERIES * 8
    got = pipe.find_variants_batch(queries, params)
    for i, q in enumerate(queries):
        assert _result_tuples(eng_model, got[i]) == _result_tuples(
            eng_model, want[i % len(QUERIES)]
        ), q
    # budgets escalated to the top bucket along the way
    assert (max(pipe._P_by_B.values()), max(pipe._P2_by_B.values())) == (256, 24)


def test_sharded_streaming_and_oversized_batch(eng_model, monkeypatch):
    """Streaming (depth-2) over the mesh and a batch larger than the max
    bucket must both return per-query results identical to one-shot calls."""
    from analiticcl_jax.parallel.mesh import ShardedPipeline, make_mesh
    from analiticcl_jax.ops import pipeline as pl_mod

    # shrink the bucket ladder: "oversized" should exercise the splitter, not
    # compile a multi-thousand-query CPU program
    monkeypatch.setattr(pl_mod, "B_BUCKETS", (8, 64))

    mesh = make_mesh(jax.devices(), dp=2)
    pipe = ShardedPipeline(eng_model, mesh)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(2),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=5,
    )
    queries = QUERIES * 6  # 48 queries
    want = pipe.collect(pipe.submit(QUERIES, params))

    # streamed in sub-batches of 8
    batches = [queries[i : i + 8] for i in range(0, len(queries), 8)]
    streamed = []
    for res in pipe.find_variants_stream(batches, params):
        streamed.extend(res)
    assert len(streamed) == len(queries)
    for i, q in enumerate(queries):
        assert _result_tuples(eng_model, streamed[i]) == _result_tuples(
            eng_model, want[i % len(QUERIES)]
        ), q

    # oversized batch goes through the same streaming splitter
    from analiticcl_jax.ops import pipeline as pl_mod

    big = queries * ((pl_mod.B_BUCKETS[-1] // len(queries)) + 2)
    got = pipe.find_variants_batch(big, params)
    assert len(got) == len(big)
    for i in (0, len(QUERIES) + 3, len(big) - 1):
        assert _result_tuples(eng_model, got[i]) == _result_tuples(
            eng_model, want[i % len(QUERIES)]
        )


def test_sharded_learn_incremental_rebuild_keeps_variant_expansions(tmp_path):
    """Sharded twin of the one-card learn test: after a strict-learn
    iteration that only refreshes frequencies, ShardedPipeline.refresh_freqs
    must pick up the variant links learn added to indexed entries, so the
    mesh's results expand through them exactly as the oracle's do."""
    from analiticcl_jax.parallel.mesh import ShardedPipeline

    data = datagen.make_dataset(
        str(tmp_path), seed=3, n_entries=6000, n_queries=2400, n_lines=1
    )
    model = VariantModel(alphabet_file=data["alphabet"])
    model.read_vocabulary(data["lexicon"], VocabParams())
    model.build()
    model.use_mesh(dp=2)
    with open(data["queries"], encoding="utf-8") as f:
        queries = f.read().split()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=3, score_threshold=0.7,
    )
    mesh_pipe = model._device
    model.find_variants_batch(queries[:8], params)  # mesh pipeline is live
    learned = model.learn_variants(
        queries[:2000], params, strict=True, auto_build=True
    )
    assert learned > 0
    assert model.learn_profile["build_mode"] == "freq_refresh"
    assert model._device is mesh_pipe and isinstance(mesh_pipe, ShardedPipeline)

    def tuples(res):
        return [
            [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
             for r in rs]
            for rs in res
        ]

    got = tuples(model.find_variants_batch(queries, params))
    model.set_backend("oracle")
    want = tuples(model.find_variants_batch(queries, params))
    assert any(r[3] is not None for rs in want for r in rs)
    assert got == want
