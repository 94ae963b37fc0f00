"""Bulk read_vocabulary fast path vs per-row add_to_vocabulary semantics.

The bulk loader (models/variant_model.py read_vocabulary) must be
indistinguishable from calling add_to_vocabulary per row (lib.rs:519-568 +
900-967 semantics): same ids, frequency merges, lexindex bitmasks,
transparency removal, special-token handling.
"""

import numpy as np
import pytest

from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.vocab import FrequencyHandling, VocabParams, VocabType

from fixtures import TEST_ALPHABET


def write_alphabet(tmp_path):
    path = tmp_path / "alphabet.tsv"
    path.write_text(
        "\n".join("\t".join(group) for group in TEST_ALPHABET) + "\n",
        encoding="utf-8",
    )
    return path


def _load_reference(model, path, params):
    """Per-row loader replicating the original implementation."""
    params = VocabParams(
        text_column=params.text_column,
        freq_column=params.freq_column,
        freq_handling=params.freq_handling,
        vocab_type=params.vocab_type,
        index=len(model.lexicons),
    )
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            text = fields[params.text_column]
            if params.freq_column is not None:
                if params.vocab_type.check(VocabType.INDEXED):
                    model.have_freq = True
                if params.freq_column < len(fields):
                    frequency = int(fields[params.freq_column])
                else:
                    frequency = 1
            else:
                frequency = 1
            model.add_to_vocabulary(text, frequency, params)
    model.lexicons.append(path)


def _state(model):
    return [
        (
            v.text,
            v.frequency,
            v.tokencount,
            v.lexindex,
            int(v.vocabtype),
        )
        for v in model.decoder
    ], dict(model.encoder), model.have_freq


@pytest.mark.parametrize(
    "fh",
    [
        FrequencyHandling.SUM,
        FrequencyHandling.MAX,
        FrequencyHandling.MIN,
        FrequencyHandling.REPLACE,
    ],
)
def test_bulk_matches_per_row(tmp_path, fh):
    alpha = write_alphabet(tmp_path)
    lex1 = tmp_path / "lex1.tsv"
    # in-file duplicates with different freqs; a special token; mixed case
    lex1.write_text(
        "apple\t10\nbanana\t5\napple\t3\ncherry\t7\n<unk>\t2\nbanana\t9\n",
        encoding="utf-8",
    )
    lex2 = tmp_path / "lex2.tsv"
    # cross-file merges + new entries; missing freq column on one row
    lex2.write_text(
        "apple\t100\ndate\nbanana\t1\neggplant\t4\n", encoding="utf-8"
    )

    params = VocabParams(freq_handling=fh)
    m_bulk = VariantModel(alphabet_file=str(alpha))
    m_bulk.read_vocabulary(str(lex1), params)
    m_bulk.read_vocabulary(str(lex2), params)

    m_ref = VariantModel(alphabet_file=str(alpha))
    _load_reference(m_ref, str(lex1), params)
    _load_reference(m_ref, str(lex2), params)

    assert _state(m_bulk) == _state(m_ref)


def test_bulk_transparency_removal(tmp_path):
    """A later non-transparent lexicon strips TRANSPARENT (lib.rs:935-940)."""
    alpha = write_alphabet(tmp_path)
    lex = tmp_path / "lex.tsv"
    lex.write_text("ghost\t1\nsolid\t2\n", encoding="utf-8")

    m = VariantModel(alphabet_file=str(alpha))
    tparams = VocabParams(
        vocab_type=VocabType.INDEXED | VocabType.TRANSPARENT
    )
    m.read_vocabulary(str(lex), tparams)
    assert m.decoder[m.encoder["ghost"]].vocabtype.check(VocabType.TRANSPARENT)
    m.read_vocabulary(str(lex), VocabParams())
    assert not m.decoder[m.encoder["ghost"]].vocabtype.check(
        VocabType.TRANSPARENT
    )
    # lexindex accumulates both loads
    assert m.decoder[m.encoder["ghost"]].lexindex == 0b11


def test_bulk_text_column(tmp_path):
    alpha = write_alphabet(tmp_path)
    lex = tmp_path / "lex.tsv"
    lex.write_text("1\tword\n2\tother\n", encoding="utf-8")
    m = VariantModel(alphabet_file=str(alpha))
    m.read_vocabulary(str(lex), VocabParams(text_column=1, freq_column=0))
    assert "word" in m.encoder and "other" in m.encoder
    assert m.decoder[m.encoder["word"]].frequency == 1


def test_group_ranges_structure(tmp_path):
    """group_ranges rows unpack as (start, end) and cover all instances."""
    alpha = write_alphabet(tmp_path)
    lex = tmp_path / "lex.tsv"
    lex.write_text("listen\t1\nsilent\t1\nenlist\t1\napple\t1\n", encoding="utf-8")
    m = VariantModel(alphabet_file=str(alpha))
    m.read_vocabulary(str(lex), VocabParams())
    m.build()
    total = 0
    for s, e in m.index.group_ranges:
        assert e > s
        total += int(e) - int(s)
    assert total == m.index.size
    # the three anagrams share one group
    sizes = sorted(int(e) - int(s) for s, e in m.index.group_ranges)
    assert sizes == [1, 3]
    assert m.index.norms.dtype == np.int8
