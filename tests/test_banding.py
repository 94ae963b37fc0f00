"""Charcount-banded stage A: device pipeline vs oracle with forced tiling.

Banding only changes WHICH lexicon blocks stage A scans (coverage of
[cc-k, cc+k] per query tile); results must stay bit-identical to the host
oracle. These tests shrink B_TILE/ROW_BLOCK-adjacent parameters so small CPU
batches exercise multiple tiles with different band windows.
"""

import numpy as np
import pytest

import analiticcl_jax.ops.pipeline as pl
import analiticcl_jax.ops.stage_a as sa
from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import DistanceThreshold, SearchParameters
from analiticcl_jax.vocab import VocabParams

from fixtures import TEST_ALPHABET, get_test_searchparams


def _mixed_model():
    model = VariantModel(alphabet=TEST_ALPHABET)
    words = []
    # short, medium, and long words: the device layout spans many charcounts
    for base in ["cat", "dog", "sun", "map", "pen"]:
        words.append(base)
    for base in ["window", "bottle", "garden", "pillow", "carpet"]:
        words.append(base)
        words.append(base + "s")
    for base in [
        "extraordinary", "misunderstand", "architectural",
        "approximately", "uncharacteristically",
    ]:
        words.append(base)
    for w in words:
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    return model


def _tuples(model, res):
    return [
        (model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
        for r in res
    ]


@pytest.mark.parametrize("b_tile", [8, 1024])
def test_banded_pipeline_matches_oracle(monkeypatch, b_tile):
    monkeypatch.setattr(sa, "B_TILE", b_tile)
    model = _mixed_model()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(2),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.0,
    )
    queries = [
        "cat", "dogg", "sn", "windwo", "bottel", "gadren",
        "extraordinry", "misunderstnad", "architectual", "pilow",
        "carpets", "aproximately", "xy", "uncharacteristicaly",
        "pens", "suns",
    ]
    pipe = pl.DevicePipeline(model)
    device = pipe.find_variants_batch(queries, params)
    oracle = [model._find_variants_oracle(q, params) for q in queries]
    for q, d, o in zip(queries, device, oracle):
        assert _tuples(model, d) == _tuples(model, o), q


def test_band_plan_covers_all_candidates(monkeypatch):
    """Every tile's block window covers [min cc-k, max cc+k] of its tile."""
    monkeypatch.setattr(sa, "B_TILE", 8)
    model = _mixed_model()
    pipe = pl.DevicePipeline(model)
    B = 16
    rng = np.random.default_rng(0)
    q_cc = np.sort(rng.integers(2, 21, size=B).astype(np.int32))
    k_ana = rng.integers(0, 4, size=B).astype(np.int32)
    start, nb = pipe._band_plan(q_cc, k_ana, B)
    assert start.shape == (B // 8,)
    assert nb in pipe.nb_buckets
    for j in range(B // 8):
        lo = int((q_cc[j * 8 : (j + 1) * 8] - k_ana[j * 8 : (j + 1) * 8]).min())
        hi = int((q_cc[j * 8 : (j + 1) * 8] + k_ana[j * 8 : (j + 1) * 8]).max())
        rows = np.arange(len(pipe._cc_dev))
        in_band = (pipe._cc_dev >= lo) & (pipe._cc_dev <= hi)
        lo_row = start[j] * sa.ROW_BLOCK
        hi_row = lo_row + nb * sa.ROW_BLOCK
        covered = (rows >= lo_row) & (rows < hi_row)
        assert not (in_band & ~covered).any()


def test_band_plan_all_padding_tile(monkeypatch):
    """A tile of only padding queries (k_ana < 0) must not crash or match."""
    monkeypatch.setattr(sa, "B_TILE", 8)
    model = _mixed_model()
    params = get_test_searchparams()
    pipe = pl.DevicePipeline(model)
    # 9 active queries pad to B=64: tiles 2.. are pure padding
    queries = ["cat", "dog", "sun", "map", "pen", "pens", "cats", "dogs", "sunn"]
    device = pipe.find_variants_batch(queries, params)
    oracle = [model._find_variants_oracle(q, params) for q in queries]
    for q, d, o in zip(queries, device, oracle):
        assert _tuples(model, d) == _tuples(model, o), q
