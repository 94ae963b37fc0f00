"""Device pipeline vs host oracle parity, and DL kernel numerics."""

import random

import numpy as np
import pytest

import jax.numpy as jnp

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.ops import distance as oracle
from analiticcl_jax.ops.dl_jax import PAD_A, PAD_B, dl_metrics_batch
from analiticcl_jax.types import DistanceThreshold, SearchParameters, Weights
from analiticcl_jax.vocab import VocabParams

from analiticcl_jax import datagen
from fixtures import get_test_alphabet, get_test_searchparams

# an eng.aspell-shaped lexicon of 25k entries, generated from a seed
ENG_WORDS = datagen.lexicon_words(25_000, seed=5)


def _write_lexicon(path, words):
    """alphabet + lexicon files for ``words``; returns the alphabet path."""
    datagen.write_lexicon(
        str(path / "lexicon.tsv"), words, datagen.zipf_freqs(len(words), 5)
    )
    return datagen.write_alphabet(str(path / "alphabet.tsv"))


def test_dl_kernel_parity_random():
    random.seed(7)
    L = 24
    P = 256
    pairs = []
    for _ in range(P):
        la = random.randint(0, L)
        lb = random.randint(0, L)
        pairs.append(
            (
                [random.randint(0, 4) for _ in range(la)],
                [random.randint(0, 4) for _ in range(lb)],
            )
        )
    a = np.full((P, L), PAD_A, np.int32)
    b = np.full((P, L), PAD_B, np.int32)
    al = np.zeros(P, np.int32)
    bl = np.zeros(P, np.int32)
    for i, (A, B) in enumerate(pairs):
        a[i, : len(A)] = A
        b[i, : len(B)] = B
        al[i] = len(A)
        bl[i] = len(B)
    ld, lcs, pf, sf = dl_metrics_batch(
        jnp.array(a), jnp.array(al), jnp.array(b), jnp.array(bl), L
    )
    for i, (A, B) in enumerate(pairs):
        assert int(ld[i]) == oracle.damerau_levenshtein(A, B, 999)
        assert int(lcs[i]) == oracle.longest_common_substring_length(A, B)
        assert int(pf[i]) == oracle.common_prefix_length(A, B)
        assert int(sf[i]) == oracle.common_suffix_length(A, B)


def _result_tuples(model, results):
    return [
        (model.decoder[r.vocab_id].text, round(r.dist_score, 12), round(r.freq_score, 12), r.via)
        for r in results
    ]


@pytest.fixture(scope="module")
def eng_model(tmp_path_factory):
    # 25k entries keep CPU CI fast while still exercising the full
    # retrieval + scoring stack at realistic scale
    d = tmp_path_factory.mktemp("lex")
    model = VariantModel(alphabet_file=_write_lexicon(d, ENG_WORDS))
    model.read_vocabulary(str(d / "lexicon.tsv"), VocabParams())
    model.build()
    return model


# edge cases (lengths, case, nothing in reach) plus lexicon words with one
# edit, which have matches
QUERIES = datagen.queries(ENG_WORDS, 8, seed=1, stride=997) + [
    "theere",
    "seperate",
    "recieve",
    "apox",
    "xylophone",
    "Amsterdam",
    "hous",
    "howse",
    "a",
    "zzzzz",
    "qwrtp",
    "misspeling",
    "ACCOMODATE",
]


def test_device_oracle_parity_eng(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in QUERIES]
    eng_model.set_backend("device")
    got = eng_model.find_variants_batch(QUERIES, params)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_device_oracle_parity_freq_ranking(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(3),
        max_matches=10,
        score_threshold=0.5,
        freq_weight=1.0,
    )
    queries = QUERIES[:6]
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in queries]
    eng_model.set_backend("device")
    got = eng_model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_device_oracle_parity_small_model():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for text in ["rites", "tiers", "tires", "tries", "tyres", "rides", "brides", "dire"]:
        model.add_to_vocabulary(text, None, VocabParams())
    model.build()
    params = get_test_searchparams()
    model.set_backend("oracle")
    want = [model.find_variants(q, params) for q in ["rite", "tire", "bride"]]
    model.set_backend("device")
    got = model.find_variants_batch(["rite", "tire", "bride"], params)
    for w, g in zip(want, got):
        assert _result_tuples(model, g) == _result_tuples(model, w)


def test_device_stop_at_exact(eng_model):
    import dataclasses

    from analiticcl_jax.types import StopCriterion

    params = dataclasses.replace(
        SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
        ),
        stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH,
    )
    word = ENG_WORDS[100]  # an exact anagram hit exists
    eng_model.set_backend("oracle")
    want = eng_model.find_variants(word, params)
    eng_model.set_backend("device")
    got = eng_model.find_variants_batch([word], params)[0]
    assert _result_tuples(eng_model, got) == _result_tuples(eng_model, want)


def test_fast_tail_matches_object_tail(eng_model):
    """The vectorized numpy ranking tail must be bit-equal to score_and_rank."""
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("device")
    eng_model.fast_tail = False
    want = eng_model.find_variants_batch(QUERIES, params)
    eng_model.fast_tail = True
    got = eng_model.find_variants_batch(QUERIES, params)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_fast_tail_matches_object_tail_freq(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(3),
        max_matches=10,
        score_threshold=0.5,
        freq_weight=1.0,
    )
    eng_model.set_backend("device")
    eng_model.fast_tail = False
    want = eng_model.find_variants_batch(QUERIES, params)
    eng_model.fast_tail = True
    got = eng_model.find_variants_batch(QUERIES, params)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_device_oracle_parity_random_sweep(eng_model):
    """200 random corrupted queries: device (fast tail) vs oracle, bit-equal."""
    random.seed(99)
    words = [eng_model.decoder[i].text for i in range(3, len(eng_model.decoder), 29)]

    def corrupt(w):
        if len(w) < 4:
            return w
        i = random.randrange(len(w) - 1)
        return random.choice(
            [w[:i] + w[i + 1:], w[:i] + w[i + 1] + w[i] + w[i + 2:],
             w[:i] + "x" + w[i:], w[:i] + "q" + w[i + 1:]]
        )

    queries = [corrupt(w) for w in words[:200]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in queries]
    eng_model.set_backend("device")
    eng_model.fast_tail = True
    got = eng_model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_stream_matches_batch(eng_model):
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    eng_model.set_backend("device")
    want = eng_model.find_variants_batch(QUERIES, params)
    got = list(eng_model.find_variants_stream(QUERIES, params, batch_size=4))
    assert len(got) == len(want)
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q


def test_rank_fast_batch_equals_rank_fast():
    """rank_fast_batch must be bit-equal to _rank_fast per segment, including
    the tie-aware crop quirks — stress with quantized scores so ties collide
    at the crop boundary far more often than real queries produce."""
    import random
    import types as pytypes

    import numpy as np

    from analiticcl_jax.ops.pipeline import _rank_fast
    from analiticcl_jax.ops.rank_batch import rank_fast_batch
    from analiticcl_jax.types import SearchParameters

    rng = random.Random(7)
    fake_model = pytypes.SimpleNamespace(have_freq=True)
    vocab_ids = np.arange(5000, dtype=np.int64)

    for trial in range(40):
        nseg = rng.randint(1, 12)
        segs, rows, dists, freqs = [], [], [], []
        for g in range(nseg):
            n = rng.choice([0, 1, 2, 3, 5, 9, 15, 40])
            for _ in range(n):
                segs.append(g)
                rows.append(rng.randrange(5000))
                # quantized scores -> many exact ties
                dists.append(rng.choice([0.25, 0.5, 0.5, 0.625, 0.75, 1.0]))
                freqs.append(float(rng.choice([1, 1, 2, 10])))
        seg = np.array(segs, dtype=np.int64)
        o_c = np.array(rows, dtype=np.int64)
        ds = np.array(dists)
        fr = np.array(freqs)
        floors = np.array([rng.choice([0.0, 5.0]) for _ in range(nseg)])
        fake_model.have_freq = rng.random() < 0.7
        params = SearchParameters(
            max_matches=rng.choice([0, 1, 2, 3, 10]),
            score_threshold=rng.choice([0.0, 0.3, 0.6]),
            cutoff_threshold=rng.choice([0.0, 1.0, 1.5, 2.0]),
            freq_weight=rng.choice([0.0, 0.0, 0.5, 1.0]),
        )
        got = rank_fast_batch(
            fake_model, vocab_ids, o_c, ds, fr, seg, nseg, floors, params
        )
        for g in range(nseg):
            m = seg == g
            want = _rank_fast(
                fake_model, vocab_ids, o_c[m], ds[m], fr[m], params,
                float(floors[g]),
            )
            gt = [(r.vocab_id, r.dist_score, r.freq_score) for r in got[g]]
            wt = [(r.vocab_id, r.dist_score, r.freq_score) for r in want]
            assert gt == wt, (trial, g, params)


def test_pair_budget_overflow_splits_not_truncates(monkeypatch, tmp_path):
    """When totals exceed the top pair budgets the batch must be recomputed
    (split / oracle), never truncated query-major: every query keeps its full
    candidate set (reference guarantee, lib.rs:1143-1308)."""
    from analiticcl_jax.ops import pipeline as pl_mod

    # tiny top buckets force overflow on a normal workload
    monkeypatch.setattr(pl_mod, "P_BUCKETS", (32, 64))
    monkeypatch.setattr(pl_mod, "P2_BUCKETS", (16, 32))

    model = VariantModel(alphabet_file=_write_lexicon(tmp_path, ENG_WORDS[::8]))
    model.read_vocabulary(str(tmp_path / "lexicon.tsv"), VocabParams())
    model.build()

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries = QUERIES + ["aple", "bannana", "chocolat", "definately", "wierd"]
    model.set_backend("oracle")
    want = [model.find_variants(q, params) for q in queries]
    model.set_backend("device")
    got = model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(model, g) == _result_tuples(model, w), q


def test_searchsorted_radix_matches_numpy():
    """The 64-ary radix searchsorted must equal np.searchsorted(side='left')
    on sorted arrays of assorted sizes, including ties, zeros, plateaus, and
    out-of-range targets."""
    import numpy as np
    import jax.numpy as jnp

    from analiticcl_jax.ops.pipeline import _searchsorted_radix

    rng = np.random.default_rng(5)
    for n in (1, 7, 63, 64, 65, 700, 4096, 5000, 70000):
        vals = np.sort(rng.integers(0, max(2, n // 3), size=n)).astype(np.int32)
        targets = rng.integers(-2, vals[-1] + 3, size=997).astype(np.int32)
        got = np.asarray(
            _searchsorted_radix(jnp.asarray(vals), jnp.asarray(targets))
        )
        want = np.searchsorted(vals, targets, side="left")
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_native_rank_tail_equals_numpy_tail(eng_model):
    """The C++ one-call ranking tail (ananorm_rank_tail) vs the numpy
    rank_fast_batch path, bit-equal on the same device batches."""
    import analiticcl_jax.ops.pipeline as pl
    from analiticcl_jax.utils import native as _native

    if not _native.available():
        import pytest as _pytest

        _pytest.skip("native library unavailable")
    random.seed(123)
    words = [
        eng_model.decoder[i].text
        for i in range(3, len(eng_model.decoder), 41)
    ]
    queries = []
    for w in words[:300]:
        lst = list(w)
        if len(lst) > 2:
            i = random.randrange(len(lst) - 1)
            lst[i], lst[i + 1] = lst[i + 1], lst[i]
        queries.append("".join(lst))
    for fw in (0.0, 1.0):
        params = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=10,
            freq_weight=fw,
        )
        eng_model.set_backend("device")
        got = eng_model.find_variants_batch(queries, params)
        saved = pl._rank_tail_native
        pl._rank_tail_native = None
        try:
            want = eng_model.find_variants_batch(queries, params)
        finally:
            pl._rank_tail_native = saved
        for q, w, g in zip(queries, want, got):
            assert _result_tuples(eng_model, g) == _result_tuples(
                eng_model, w
            ), q


def test_find_variants_stream_accepts_generators(eng_model):
    """The steady-state benchmark stream cycles a GENERATOR through
    find_variants_stream; chunking must not require len() (regression:
    the suite's query scenarios crashed on unsized iterables)."""
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    eng_model.set_backend("device")
    streamed = [
        _result_tuples(eng_model, res)
        for res in eng_model.find_variants_stream(
            (q for q in QUERIES), params, batch_size=4
        )
    ]
    batched = [
        _result_tuples(eng_model, res)
        for res in eng_model.find_variants_batch(QUERIES, params)
    ]
    assert streamed == batched


def test_budget_deescalation(eng_model, monkeypatch):
    """A stale oversized pair-budget hint must step back down after a window
    of small batches (kernel time scales with the static P budget: a
    1,572,864 hint vs the ~390k a workload needs measured 3x slower), and
    results must stay oracle-exact through the recompile."""
    from analiticcl_jax.ops import pipeline as pl_mod
    from analiticcl_jax.ops.pipeline import get_device_pipeline

    # a short ladder keeps the top-bucket CPU compile cheap (the real
    # ladder's 1.5M-pair top bucket compiles for minutes on CPU)
    monkeypatch.setattr(pl_mod, "P_BUCKETS", (8192, 16384, 32768))
    monkeypatch.setattr(pl_mod, "P2_BUCKETS", (2048, 4096, 8192))
    P_BUCKETS = pl_mod.P_BUCKETS
    P2_BUCKETS = pl_mod.P2_BUCKETS

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("oracle")
    want = [
        _result_tuples(eng_model, eng_model.find_variants(q, params))
        for q in QUERIES
    ]
    pipe = get_device_pipeline(eng_model)
    pipe.find_variants_batch(QUERIES, params)  # init the B bucket
    (B,) = pipe._P_by_B.keys()
    # simulate the stale hint: start at the top buckets
    pipe._P_by_B[B] = P_BUCKETS[-1]
    pipe._P2_by_B[B] = P2_BUCKETS[-1]
    pipe._deesc_reset(B)
    for _ in range(pipe.DEESC_N):
        got = pipe.find_variants_batch(QUERIES, params)
        assert [_result_tuples(eng_model, g) for g in got] == want
    # window elapsed: budgets stepped down to what the batches actually need
    assert pipe._P_by_B[B] < P_BUCKETS[-1]
    assert pipe._P2_by_B[B] < P2_BUCKETS[-1]
    # and the shrunken program still returns exact results
    got = pipe.find_variants_batch(QUERIES, params)
    assert [_result_tuples(eng_model, g) for g in got] == want


def test_fastemit_matches_python_bulk_construction():
    """native/fastemit.c vs the Python tuple.__new__ bulk path: identical
    lists of VariantResult (type, values, via=None) over random columns,
    including empty segments and a zero-survivor batch."""
    import numpy as np

    from analiticcl_jax.types import VariantResult
    from analiticcl_jax.utils.native import fastemit_build_result_lists

    femit = fastemit_build_result_lists()
    if femit is None:
        import pytest

        pytest.skip("fastemit extension unavailable")
    rng = np.random.default_rng(11)
    for nrows, n in [(7, 23), (1, 0), (5, 5), (64, 300)]:
        vid = rng.integers(0, 1 << 40, size=n).astype(np.int64)
        ds = rng.random(n)
        fq = rng.random(n)
        cuts = np.sort(rng.integers(0, n + 1, size=nrows - 1))
        bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
        out = femit(VariantResult, vid, ds, fq, bounds, nrows)
        assert len(out) == nrows
        expect = [
            [
                VariantResult(int(vid[i]), float(ds[i]), float(fq[i]))
                for i in range(bounds[g], bounds[g + 1])
            ]
            for g in range(nrows)
        ]
        assert out == expect
        for row in out:
            for r in row:
                assert type(r) is VariantResult and r.via is None


def test_window_split_ratio_thresholds(eng_model):
    """Ratio thresholds mix DL window buckets within one batch (len<=13 ->
    W3, 14-23 -> W6, >=24 -> W12): submit() must split the batch into
    per-window sub-submissions (pipeline.WINDOW_BUCKETS) with results
    bit-identical to the oracle and in input order."""
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_of(0.5),
        max_edit_distance=DistanceThreshold.ratio_of(0.3),
        max_matches=5,
        score_threshold=0.25,
    )
    queries = [
        "cat", "theere", "misunderstanding", "howse",
        "uncharacteristicaly", "apoximately", "a", "extraordinarily",
        "internationalizations", "zzzzz", "recieve", "dissatisfactions",
    ]
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in queries]
    eng_model.set_backend("device")
    got = eng_model.find_variants_batch(queries, params)
    for q, w, g in zip(queries, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q
    # the split actually happened: k_ed spans more than one window bucket
    import numpy as np

    from analiticcl_jax.ops.pipeline import WINDOW_BUCKETS, _bucket

    k_eds = {
        _bucket(min(len(q) * 3 // 10, 12), WINDOW_BUCKETS) for q in queries
    }
    assert len(k_eds) > 1


@pytest.mark.parametrize("gs", [64, 128])
def test_wide_radix_block_descent(eng_model, monkeypatch, gs):
    """The adaptive block-descent radix (GS=64/128 for >=1024-block bands,
    pipeline._radix_gs) must stay bit-identical to the oracle; CPU fixtures
    have small bands, so force the wide radix."""
    import analiticcl_jax.ops.pipeline as plmod

    monkeypatch.setattr(plmod, "_radix_gs", lambda m: gs)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    eng_model.set_backend("oracle")
    want = [eng_model.find_variants(q, params) for q in QUERIES]
    eng_model.set_backend("device")
    eng_model._device = None  # fresh pipeline: recompile with the forced GS
    got = eng_model.find_variants_batch(QUERIES, params)
    eng_model._device = None  # don't leak the forced-GS pipeline
    for q, w, g in zip(QUERIES, want, got):
        assert _result_tuples(eng_model, g) == _result_tuples(eng_model, w), q
