"""Search-mode parity tests (reference tests/main.rs 06xx, 07xx, 09xx)."""

import dataclasses

import pytest

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.search import find_boundaries, find_match_ngrams
from analiticcl_jax.types import Weights
from analiticcl_jax.vocab import VocabParams, VocabType

from fixtures import get_test_alphabet, get_test_searchparams

LEXICON_AMPHIBIANS = "/root/reference/bindings/python/tests/amphibians.tsv"
LEXICON_REPTILES = "/root/reference/bindings/python/tests/reptiles.tsv"


def test0601_find_boundaries():
    text = 'Hallo allemaal, ik zeg: "Welkom in Aix-les-bains!".'
    boundaries = find_boundaries(text)
    assert len(boundaries) == 9
    assert boundaries[0].offset.begin == 5
    assert boundaries[0].offset.end == 6
    assert [b.text for b in boundaries] == [
        " ", ", ", " ", ': "', " ", " ", "-", "-", '!".',
    ]


def test0602_find_ngrams_unigram1():
    text = "dit is een mooie test"
    ngrams = find_match_ngrams(text, find_boundaries(text), 1, 0, None)
    assert [n.text for n in ngrams] == ["dit", "is", "een", "mooie", "test"]


def test0603_find_ngrams_unigram2():
    text = "dit is een mooie test."
    ngrams = find_match_ngrams(text, find_boundaries(text), 1, 0, None)
    assert [n.text for n in ngrams] == ["dit", "is", "een", "mooie", "test"]


def test0604_find_ngrams_unigram3():
    text = "hello, world!"
    ngrams = find_match_ngrams(text, find_boundaries(text), 1, 0, None)
    assert [n.text for n in ngrams] == ["hello", "world"]


def test0605_find_ngrams_bigrams():
    text = "dit is een mooie test."
    boundaries = find_boundaries(text)
    assert len(boundaries) == 5
    ngrams = find_match_ngrams(text, boundaries, 2, 0, None)
    assert [n.text for n in ngrams] == [
        "dit is", "is een", "een mooie", "mooie test",
    ]


def test0606_find_ngrams_bigrams2():
    text = "hello,world!"
    ngrams = find_match_ngrams(text, find_boundaries(text), 2, 0, None)
    assert [n.text for n in ngrams] == ["hello,world"]


def test0607_find_ngrams_bigrams3():
    text = "hello, world!"
    ngrams = find_match_ngrams(text, find_boundaries(text), 2, 0, None)
    assert [n.text for n in ngrams] == ["hello, world"]


def test0608_find_ngrams_bigrams4():
    text = "hello!"
    ngrams = find_match_ngrams(text, find_boundaries(text), 2, 0, None)
    assert ngrams == []


def _lm_model():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "think", "sink", "you"):
        model.add_to_vocabulary(w, 2, VocabParams())
    for w in ("are", "right", "are right"):
        model.add_to_vocabulary(w, 2, VocabParams())
    lm = VocabParams(vocab_type=VocabType.LM)
    model.add_to_vocabulary("<bos> I", 2, lm)
    model.add_to_vocabulary("I think", 2, lm)
    model.add_to_vocabulary("I sink", 1, lm)
    model.add_to_vocabulary("you are", 2, lm)
    model.add_to_vocabulary("right <eos>", 2, lm)
    return model


def test0701_find_all_matches_unigram_only():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "think", "sink", "you", "are", "right"):
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    matches = model.find_all_matches(
        "I tink you are rihgt", get_test_searchparams().with_max_ngram(1)
    )
    assert matches
    assert matches[0].text == "I"
    assert matches[1].text == "tink"
    assert model.match_to_str(matches[1]) == "think"
    assert matches[2].text == "you"
    assert matches[3].text == "are"
    assert matches[4].text == "rihgt"
    assert model.match_to_str(matches[4]) == "right"


def test0702_find_all_matches():
    model = _lm_model()
    model.build()
    matches = model.find_all_matches("I tink you are rihgt", get_test_searchparams())
    assert matches
    assert matches[0].text == "I"
    assert model.match_to_str(matches[0]) == "I"
    assert matches[1].text == "tink"
    assert matches[1].offset.begin == 2
    assert matches[1].offset.end == 6
    assert model.match_to_str(matches[1]) == "think"
    assert matches[2].text == "you"
    assert model.match_to_str(matches[2]) == "you"
    assert matches[3].text == "are rihgt"  # system opts for the bigram here
    assert model.match_to_str(matches[3]) == "are right"


def test0703_find_all_matches_linebreak():
    model = _lm_model()
    model.build()
    matches = model.find_all_matches(
        "I tink you are\nrihgt", get_test_searchparams()
    )
    assert [m.text for m in matches] == ["I", "tink", "you", "are\nrihgt"]
    assert model.match_to_str(matches[3]) == "are right"


def test0704_find_all_matches_two_batches():
    model = _lm_model()
    model.add_to_vocabulary("am", 2, VocabParams())
    model.add_to_vocabulary("sure", 2, VocabParams())
    lm = VocabParams(vocab_type=VocabType.LM)
    model.add_to_vocabulary("I am", 2, lm)
    model.add_to_vocabulary("sure <eos>", 2, lm)
    model.build()
    matches = model.find_all_matches(
        "I tink you are rihgt\n\nI am sur", get_test_searchparams()
    )
    assert [m.text for m in matches] == [
        "I", "tink", "you", "are rihgt", "I", "am", "sur",
    ]
    assert model.match_to_str(matches[1]) == "think"
    assert model.match_to_str(matches[3]) == "are right"
    assert model.match_to_str(matches[6]) == "sure"


def test0706_find_all_matches_unicodeoffsets():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "think", "you", "are", "right"):
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    matches = model.find_all_matches(
        "I thиnk you are righт",
        get_test_searchparams().with_max_ngram(1).with_unicodeoffsets(),
    )
    assert matches[1].text == "thиnk"
    assert matches[1].offset.begin == 2
    assert matches[1].offset.end == 7
    assert model.match_to_str(matches[1]) == "think"
    assert matches[4].text == "righт"
    assert model.match_to_str(matches[4]) == "right"


def test0707_find_all_matches_utf8offsets():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "think", "you", "are", "right"):
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    matches = model.find_all_matches(
        "I thиnk you are rihgt", get_test_searchparams().with_max_ngram(1)
    )
    assert matches[1].text == "thиnk"
    assert matches[1].offset.begin == 2
    assert matches[1].offset.end == 8
    assert model.match_to_str(matches[1]) == "think"


def test0901_find_all_matches_with_multiple_lexicons():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    model.read_vocabulary(LEXICON_AMPHIBIANS, VocabParams())
    model.read_vocabulary(LEXICON_REPTILES, VocabParams())
    model.build()
    assert len(model.lexicons) == 2
    inputwords = ["Salamander", "lizard", "frog", "snake", "toad"]
    outputrefwords = ["salamander", "lizard", "frog", "snake", "toad"]
    matches = model.find_all_matches(
        " ".join(inputwords),
        get_test_searchparams().with_max_ngram(1).with_single_thread(),
    )
    assert len(matches) == len(inputwords)
    for i, w in enumerate(inputwords):
        assert matches[i].text == w
    for i, w in enumerate(outputrefwords):
        assert model.match_to_str(matches[i]) == w
    assert model.match_to_vocabvalue(matches[0]).in_lexicon(0)  # amphibians
    assert model.match_to_vocabvalue(matches[1]).in_lexicon(1)  # reptiles
    assert model.match_to_vocabvalue(matches[2]).in_lexicon(0)
    assert model.match_to_vocabvalue(matches[3]).in_lexicon(1)
    assert model.match_to_vocabvalue(matches[4]).in_lexicon(0)


def _contextrule_model():
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "think", "sink", "you", "are", "right"):
        model.add_to_vocabulary(w, 2, VocabParams())
    model.build()
    return model


def test0902_context_rules_bonus():
    model = _contextrule_model()
    model.add_contextrule("I; think", 1.1, ["testtag"], [])
    params = dataclasses.replace(
        get_test_searchparams(), lm_weight=0.0, max_ngram=1
    )
    matches = model.find_all_matches("I tink you are rihgt", params)
    assert matches[0].text == "I"
    assert matches[0].tag == [0]
    assert matches[0].seqnr == [0]
    assert matches[1].text == "tink"
    assert matches[1].tag == [0]
    assert matches[1].seqnr == [1]
    assert model.match_to_str(matches[1]) == "think"
    assert model.match_to_str(matches[4]) == "right"


def test0903_context_rules_penalty():
    model = _contextrule_model()
    model.add_contextrule("I; think", 0.9, [], [])
    params = dataclasses.replace(
        get_test_searchparams(), lm_weight=0.0, max_ngram=1
    )
    matches = model.find_all_matches("I tink you are rihgt", params)
    assert model.match_to_str(matches[1]) == "sink"
    assert model.match_to_str(matches[4]) == "right"


def test0904_context_rules2():
    model = _contextrule_model()
    model.add_contextrule("think", 1.0, ["testtag"], [])
    model.add_contextrule("are", 1.0, ["testtag"], [])
    model.add_contextrule("right", 1.0, ["testtag"], [])
    params = dataclasses.replace(
        get_test_searchparams(), lm_weight=0.0, max_ngram=1
    )
    matches = model.find_all_matches("I tink you are rihgt", params)
    assert matches[0].tag == []
    assert matches[1].tag == [0]
    assert matches[1].seqnr == [0]
    assert model.match_to_str(matches[1]) == "think"
    assert matches[3].tag == [0]
    assert matches[4].tag == [0]
    assert model.match_to_str(matches[4]) == "right"


def test0905_context_rules_multitag():
    model = _contextrule_model()
    model.add_contextrule("I; think", 1.1, ["testtag", "testtag2"], [])
    params = dataclasses.replace(
        get_test_searchparams(), lm_weight=0.0, max_ngram=1
    )
    matches = model.find_all_matches("I tink you are rihgt", params)
    assert matches[0].tag == [0, 1]
    assert matches[0].seqnr == [0, 0]
    assert matches[1].tag == [0, 1]
    assert matches[1].seqnr == [1, 1]
    assert model.match_to_str(matches[1]) == "think"


def test0705_find_all_matches_context_only():
    """context_weight is accepted but inert in v0.4.9 (rescore_input_context
    is commented out upstream); the variant score alone picks 'think'."""
    model = _lm_model()
    model.build()
    params = dataclasses.replace(
        get_test_searchparams(), context_weight=0.5, lm_weight=0.0
    )
    matches = model.find_all_matches("I tink you are rihgt", params)
    assert [m.text for m in matches] == ["I", "tink", "you", "are rihgt"]
    assert model.match_to_str(matches[1]) == "think"
    assert model.match_to_str(matches[3]) == "are right"


def test_lm_score_tokens_batch_matches_scalar():
    """Vectorized LM scoring must be bit-equal to the scalar path."""
    import random

    from analiticcl_jax.vocab import BOS, EOS

    model = _lm_model() if "_lm_model" in dir() else None
    if model is None:
        # build a small LM-bearing model inline
        from fixtures import get_test_alphabet
        from analiticcl_jax.models.variant_model import VariantModel
        from analiticcl_jax.types import Weights
        from analiticcl_jax.vocab import VocabParams, VocabType

        alphabet, _ = get_test_alphabet()
        model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
        params = VocabParams(vocab_type=VocabType.INDEXED | VocabType.LM)
        for text, freq in [
            ("are", 50), ("right", 20), ("rights", 5), ("are right", 12),
            ("right now", 7), ("now", 30), ("we", 40), ("we are", 18),
        ]:
            model.add_to_vocabulary(text, freq, params)
        model.build()

    rng = random.Random(5)
    vids = list(range(len(model.decoder)))
    token_lists = []
    for _ in range(60):
        n = rng.randint(0, 8)
        toks = [BOS]
        for _ in range(n):
            toks.append(None if rng.random() < 0.25 else rng.choice(vids))
        toks.append(EOS)
        if rng.random() < 0.1:
            toks = [BOS]  # degenerate: single-token-ish stream
        token_lists.append(toks)
    token_lists.append([])  # empty stream
    token_lists.append([BOS])  # no pairs

    got = model.lm_score_tokens_batch(token_lists)
    want = [model.lm_score_tokens(toks) for toks in token_lists]
    for g, w, toks in zip(got, want, token_lists):
        assert g == w, (toks, g, w)


def test_nbest_equal_cost_tie_order():
    """Characterize the self-declared divergence from rustfst's n-best set
    ordering (docs/STATUS.md): when hypotheses tie on *path cost* AND on every
    sequence-selection key, this engine breaks the tie by serial enumeration
    order — hypotheses created from a lower lattice state (and, within a
    state, from arcs in match-enumeration order) come first. rustfst's
    ``shortest_path_with_config`` (reference lib.rs:2313-2317) may order an
    equal-cost *set* differently; the reference's final selection is likewise
    unspecified under a full tie, so only determinism and the documented
    tie-break are pinned here.

    Construction: the input token 'zink' has two equal-frequency, equal-
    distance variants ('sink', 'wink'; one substitution each) with equal LM
    bigram counts, making every selection key (variant cost, LM perplexity)
    identical across the competing sequences.
    """
    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    for w in ("I", "sink", "wink", "you"):
        model.add_to_vocabulary(w, 2, VocabParams())
    lm = VocabParams(vocab_type=VocabType.LM)
    model.add_to_vocabulary("<bos> I", 2, lm)
    model.add_to_vocabulary("I sink", 2, lm)
    model.add_to_vocabulary("I wink", 2, lm)
    model.add_to_vocabulary("you <eos>", 2, lm)
    model.build()
    params = get_test_searchparams().with_max_ngram(1)

    # the two variants tie on every distance metric and frequency
    variants = model.find_variants("zink", params)
    texts = [model.decoder[v.vocab_id].text for v in variants]
    assert set(texts[:2]) == {"sink", "wink"}
    s0, s1 = variants[0], variants[1]
    assert s0.score(params.freq_weight) == s1.score(params.freq_weight)
    # variant-result tie order itself is canonical (anavalue, vocab id)
    expect_winner = texts[0]

    runs = []
    for _ in range(3):
        matches = model.find_all_matches("I zink you", params)
        picked = [
            model.match_to_str(m) for m in matches if m.text == "zink"
        ]
        assert picked, matches
        runs.append(picked[0])
    # deterministic across runs, and equal to the serial-order winner: the
    # lattice enumerates variant arcs in find_variants order, so under a full
    # tie the first-ranked variant wins
    assert runs == [expect_winner] * 3


def test_best_path_equals_nbest_first():
    """The scalar Viterbi fast path must agree with the n-best DP's first
    hypothesis — cost, symbols, AND tie-break — on random DAGs with many
    deliberate cost ties."""
    import numpy as np

    rng = np.random.default_rng(7)
    for _ in range(200):
        nstates = int(rng.integers(2, 12))
        in_arcs = [[] for _ in range(nstates)]
        for state in range(1, nstates):
            for _arc in range(int(rng.integers(1, 4))):
                src = int(rng.integers(0, state))
                cost = float(rng.integers(1, 4))  # small ints => frequent ties
                symbol = (
                    None if rng.random() < 0.2 else int(rng.integers(0, 50))
                )
                in_arcs[state].append((src, cost, symbol))
        finals = sorted(
            set(int(x) for x in rng.integers(1, nstates, size=2))
        )
        best = VariantModel._best_path(nstates, in_arcs, finals)
        ref = VariantModel._nbest_paths(nstates, in_arcs, finals, 5)
        assert best[0] == ref[0], (in_arcs, finals, best, ref[:2])


def test_find_boundaries_ascii_fast_path_equivalence():
    """The ASCII regex fast path must produce byte-identical boundaries to
    the generic per-character scanner on random ASCII strings (and the
    generic path must be taken for non-ASCII)."""
    import random as _random

    from analiticcl_jax.search import _find_boundaries_generic

    rng = _random.Random(11)
    chars = "abcXYZ .,-'_!?\n\t0123456789\"();:"
    for _ in range(300):
        n = rng.randrange(0, 40)
        s = "".join(rng.choice(chars) for _ in range(n))
        fast = find_boundaries(s)
        slow = _find_boundaries_generic(s)
        assert [(b.text, b.offset.begin, b.offset.end) for b in fast] == [
            (b.text, b.offset.begin, b.offset.end) for b in slow
        ], repr(s)
    # non-ASCII goes through the generic path (equivalence by construction)
    s = "thиnk правда x"
    assert [(b.text, b.offset.begin, b.offset.end) for b in find_boundaries(s)] == [
        (b.text, b.offset.begin, b.offset.end)
        for b in _find_boundaries_generic(s)
    ]


def test_fast_consolidation_equals_object_path():
    """The array-native search consolidation (_fam_consolidate_fast over a
    RankedResults batch) must reproduce the object path bit-for-bit:
    offsets, selection, tie order, variants, quirks (redundancy-filtered
    segments keep variants None; zero-arc chains return raw match lists)."""
    import random as _random

    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    words = [
        "rites", "tiers", "tires", "tries", "tyres", "rides", "brides",
        "dire", "bride", "to", "happy", "earth", "wide", "world", "again",
        "point", "appoint", "are", "right", "over", "under", "the",
    ]
    for w in words:
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    model.set_backend("device")
    params = dataclasses.replace(get_test_searchparams(), max_ngram=2)

    rng = _random.Random(7)

    def corrupt(w):
        if len(w) > 3 and rng.random() < 0.6:
            i = rng.randrange(len(w) - 1)
            return w[:i] + w[i + 1] + w[i] + w[i + 2:]
        return w

    texts = []
    for _ in range(24):
        n = rng.randrange(1, 9)
        parts = [corrupt(rng.choice(words)) for _ in range(n)]
        sep = rng.choice([" ", " ", ", ", ". ", " - "])
        texts.append(sep.join(parts) + rng.choice(["", ".", "!", "?!"]))
    texts.append("")  # empty text -> empty result
    texts.append("xyzq gmbh qqq")  # heavy OOV

    def signature(outs):
        return [
            [
                (
                    m.text, m.offset.begin, m.offset.end, m.selected, m.n,
                    None
                    if m.variants is None
                    else [
                        (r.vocab_id, r.dist_score, r.freq_score, r.via)
                        for r in m.variants
                    ],
                )
                for m in out
            ]
            for out in outs
        ]

    model.fast_consolidate = False
    legacy = signature(list(model.find_all_matches_stream(texts, params)))
    model.fast_consolidate = True
    fast = signature(list(model.find_all_matches_stream(texts, params)))
    assert fast == legacy


def test_fast_consolidation_more_modes():
    """Fast-path equivalence across more modes: max_ngram=3, unicode
    offsets, non-ASCII fallback units, and the batch (non-stream) API."""
    import random as _random

    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    words = [
        "rites", "tiers", "tires", "tries", "tyres", "rides", "brides",
        "dire", "bride", "to", "happy", "earth", "wide", "world", "again",
    ]
    for w in words:
        model.add_to_vocabulary(w, None, VocabParams())
    model.build()
    model.set_backend("device")
    rng = _random.Random(13)
    texts = []
    for _ in range(12):
        n = rng.randrange(1, 7)
        texts.append(" ".join(rng.choice(words) for _ in range(n)) + ".")
    texts.append("naïve tires — rites")  # non-ASCII: unicode fast path
    texts.append("тires прright, tires!")  # cyrillic mixed
    texts.append("ñ")  # single non-ASCII char
    texts.append("café-bride's dire…")  # weak boundaries + ellipsis

    def signature(outs):
        return [
            [
                (
                    m.text, m.offset.begin, m.offset.end, m.selected, m.n,
                    None
                    if m.variants is None
                    else [(r.vocab_id, r.dist_score) for r in m.variants],
                )
                for m in out
            ]
            for out in outs
        ]

    for max_ngram, uoff in [(3, False), (2, True), (1, False)]:
        params = dataclasses.replace(
            get_test_searchparams(), max_ngram=max_ngram, unicodeoffsets=uoff
        )
        model.fast_consolidate = False
        legacy = signature(model.find_all_matches_batch(texts, params))
        model.fast_consolidate = True
        fast = signature(model.find_all_matches_batch(texts, params))
        assert fast == legacy, (max_ngram, uoff)


def test_native_segmentation_equals_python():
    """ananorm_segment (C++) vs the Python prepare loop: boundaries,
    chains, segments, dedup table — field-for-field on randomized ASCII."""
    import random as _random

    import numpy as np

    from analiticcl_jax.models import search_fast
    from analiticcl_jax.utils import native as _native

    if not _native.available():
        import pytest as _pytest

        _pytest.skip("native library unavailable")

    rng = _random.Random(23)
    chars = "abcdefXYZ .,-'_!?\n\t0123456789\"();:  "
    cases = []
    for _ in range(40):
        n = rng.randrange(0, 120)
        cases.append("".join(rng.choice(chars) for _ in range(n)))
    cases += ["", " ", "a", "word", "two words.", "a.b.c d!  e", "...", "x" * 50]

    for max_ngram in (1, 2, 3):
        texts = [rng.choice(cases) for _ in range(9)]
        nat = search_fast._prepare_unit_native(texts, max_ngram)
        assert nat is not None
        # force the python loop
        import unittest.mock as mock

        with mock.patch.object(
            search_fast, "_prepare_unit_native", lambda *a: None
        ):
            py = search_fast.prepare_unit(texts, max_ngram)
        assert py is not None
        assert nat.all_texts == py.all_texts
        assert nat.text_chains == py.text_chains
        assert nat.chain_begin == py.chain_begin
        assert nat.chain_end == py.chain_end
        assert nat.chain_blo == py.chain_blo
        assert nat.chain_bhi == py.chain_bhi
        assert nat.chain_text == py.chain_text
        for ti in range(len(texts)):
            nb = nat.bb[ti]
            pb = py.bb[ti]
            if nb is None or pb is None:
                assert (nb is None or len(nb) == 0) == (
                    pb is None or len(pb) == 0
                )
                continue
            assert list(nb) == list(pb)
            assert list(nat.be[ti]) == list(py.be[ti])
        nat_segs = (
            list(zip(*(c.tolist() for c in nat.seg_cols)))
            if nat.seg_cols is not None
            else nat.segments
        )
        assert nat_segs == py.segments


def test_fast_consolidation_lm_equals_object_path():
    """LM-mode array-native decode (search_fast._consolidate_lm) vs the
    object path (most_likely_sequence with n-best + LM rescoring,
    lib.rs:2088-2495): bit-identical selections, offsets, variants —
    including n-best truncation ties (small max_seq), OOV-heavy chains,
    freq blending, unicode offsets, and non-ASCII texts."""
    import random as _random

    alphabet, _ = get_test_alphabet()
    model = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
    words = [
        "rites", "tiers", "tires", "tries", "tyres", "rides", "brides",
        "dire", "bride", "to", "happy", "earth", "wide", "world", "again",
        "point", "appoint", "are", "right", "over", "under", "the",
    ]
    rng = _random.Random(23)
    for w in words:
        model.add_to_vocabulary(w, rng.randrange(1, 50), VocabParams())
    # multi-word INDEXED entries: their arcs expand to multi-token LM
    # streams (into_ngram > 1 token)
    model.add_to_vocabulary("wide world", 9, VocabParams())
    model.add_to_vocabulary("are right", 7, VocabParams())
    # LM: bigrams over word pairs (space-joined entries become 2-grams in
    # build; unseen unigram parts are auto-added)
    lmp = VocabParams(vocab_type=VocabType.LM)
    for _ in range(60):
        a, b = rng.choice(words), rng.choice(words)
        model.add_to_vocabulary(f"{a} {b}", rng.randrange(1, 20), lmp)
    # punctuation as an LM vocab entry: "." boundaries then encode to a
    # real token (the bvid branch of the boundary-tail expansion)
    model.add_to_vocabulary(".", 5, lmp)
    model.build()
    model.set_backend("device")

    def corrupt(w):
        if len(w) > 3 and rng.random() < 0.6:
            i = rng.randrange(len(w) - 1)
            return w[:i] + w[i + 1] + w[i] + w[i + 2:]
        return w

    texts = []
    for _ in range(30):
        n = rng.randrange(1, 9)
        parts = [corrupt(rng.choice(words)) for _ in range(n)]
        sep = rng.choice([" ", " ", ", ", ". ", " - "])
        texts.append(sep.join(parts) + rng.choice(["", ".", "!", "?!"]))
    texts.append("")
    texts.append("xyzq gmbh qqq")  # heavy OOV
    texts.append("are rihgt")  # the reference's LM-driven bigram case
    texts.append("naïve tires — rites")  # non-ASCII unit

    def signature(outs):
        return [
            [
                (
                    m.text, m.offset.begin, m.offset.end, m.selected, m.n,
                    None
                    if m.variants is None
                    else [
                        (r.vocab_id, r.dist_score, r.freq_score, r.via)
                        for r in m.variants
                    ],
                )
                for m in out
            ]
            for out in outs
        ]

    from analiticcl_jax.models import search_fast

    for max_seq, fw, uoff in [(250, 0.0, False), (3, 0.0, False),
                              (50, 1.0, True), (1, 0.0, False)]:
        params = dataclasses.replace(
            get_test_searchparams(), max_ngram=2, lm_weight=1.0,
            max_seq=max_seq, freq_weight=fw, unicodeoffsets=uoff,
        )
        model.fast_consolidate = False
        legacy = signature(list(model.find_all_matches_stream(texts, params)))
        model.fast_consolidate = True
        # both decoders: the C++ ananorm_nbest_lm and the numpy lockstep
        for force_numpy in (False, True):
            old = search_fast.FORCE_NUMPY_LM
            search_fast.FORCE_NUMPY_LM = force_numpy
            try:
                fast = signature(
                    list(model.find_all_matches_stream(texts, params))
                )
            finally:
                search_fast.FORCE_NUMPY_LM = old
            assert fast == legacy, (max_seq, fw, uoff, force_numpy)
