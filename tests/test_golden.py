"""Golden tests against the reference's *published* outputs.

The reference README (README.md:121-161) shows the exact result set for the
query "seperate" against examples/eng.aspell.lexicon with default query-mode
parameters. These tests assert we reproduce it digit-for-digit.

(Note: the README's TSV and JSON examples disagree on the order within the
0.609375 tie — "separates separated" vs "separated separates". The JSON
example matches deterministic anagram-value ordering, which is what the
reference's own tie-order test (tests/main.rs:872-911) pins down, so that is
the order asserted here.)
"""

import pytest

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import DistanceThreshold, SearchParameters
from analiticcl_jax.vocab import VocabParams

ALPHABET = "/root/reference/examples/simple.alphabet.tsv"
ENG = "/root/reference/examples/eng.aspell.lexicon"

# reference README.md:150-161 (JSON example, --output-lexmatch)
GOLDEN_SEPERATE = [
    ("separate", 0.734375),
    ("operate", 0.6875),
    ("desperate", 0.6875),
    ("temperate", 0.6875),
    ("serrate", 0.65625),
    ("separated", 0.609375),
    ("separates", 0.609375),
]


@pytest.fixture(scope="module")
def eng_model_full():
    model = VariantModel(alphabet_file=ALPHABET)
    model.read_vocabulary(ENG, VocabParams())
    model.build()
    return model


def _query_defaults():
    # CLI query-mode defaults: -k 3 -d 2 -n 10 -t 0.25 -T 2.0 (bin:656-895)
    return SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
        cutoff_threshold=2.0,
    )


@pytest.mark.parametrize("backend", ["oracle", "device"])
def test_golden_seperate(eng_model_full, backend):
    eng_model_full.set_backend(backend)
    results = eng_model_full.find_variants_batch(["seperate"], _query_defaults())[0]
    got = [
        (eng_model_full.decoder[r.vocab_id].text, r.dist_score) for r in results
    ]
    # the JSON golden lists desperate before operate but both at 0.6875; the
    # reference's deterministic order is by anagram value then vocab id, which
    # puts operate first (smaller anagram value) — the TSV golden agrees
    assert got == GOLDEN_SEPERATE


def test_golden_index_counts(eng_model_full):
    # README.md:106-109: 119,773 instances -> 108,802 anagram values
    assert eng_model_full.index.size == 119773
    assert len(eng_model_full.index.group_ranges) == 108802
