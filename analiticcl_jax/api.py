"""Drop-in analiticcl-compatible Python API.

Mirrors the PyO3 binding surface of the reference
(/root/reference/bindings/python/src/lib.rs): class names, kwargs
constructors, getter/setter attributes, and dict result schemas, so code
written against `import analiticcl` runs against this engine with only the
import changed:

    from analiticcl_jax.api import VariantModel, Weights, SearchParameters, VocabParams

Batched, device-specific extensions (find_variants_batch, use_mesh) remain
available on the underlying engine via ``.engine``; ``find_variants_par``
maps to the batched device pipeline.
"""

from __future__ import annotations

import sys as _sys
from typing import Dict, List, Optional, Sequence

from .models.variant_model import VariantModel as _EngineModel
from .types import (
    DistanceThreshold,
    SearchParameters as _SearchParameters,
    StopCriterion,
    Weights as _Weights,
)
from .vocab import FrequencyHandling, VocabParams as _VocabParams, VocabType


class Weights:
    """Score-component weights (bindings lib.rs:10-113). Attribute access
    delegates to the engine dataclass."""

    _FIELDS = ("ld", "lcs", "prefix", "suffix", "case")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_w", _Weights())
        for key, value in kwargs.items():
            if key in self._FIELDS:
                setattr(self._w, key, float(value))
            else:
                # reference warns and ignores (bindings lib.rs:49)
                print(f"Ignored unknown kwargs option {key}", file=_sys.stderr)

    def __getattr__(self, name):
        if name in Weights._FIELDS:
            return getattr(self._w, name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in Weights._FIELDS:
            setattr(self._w, name, float(value))
        else:
            object.__setattr__(self, name, value)

    def to_dict(self) -> Dict[str, float]:
        return {
            "ld": self._w.ld,
            "lcs": self._w.lcs,
            "prefix": self._w.prefix,
            "suffix": self._w.suffix,
            "case": self._w.case,
        }


def _coerce_threshold(value) -> DistanceThreshold:
    """int | float | (ratio, limit) | str -> DistanceThreshold
    (bindings lib.rs:116-141)."""
    if isinstance(value, tuple) and len(value) == 2:
        return DistanceThreshold.ratio_with_limit(float(value[0]), int(value[1]))
    return DistanceThreshold.parse(value)


def _threshold_value(t: DistanceThreshold):
    from .types import ThresholdKind

    if t.kind is ThresholdKind.ABSOLUTE:
        return t.limit
    if t.kind is ThresholdKind.RATIO:
        return t.ratio
    return (t.ratio, t.limit)


class SearchParameters:
    """Runtime search configuration (bindings lib.rs:116-446)."""

    _FIELDS = (
        "max_anagram_distance", "max_edit_distance", "max_matches",
        "score_threshold", "cutoff_threshold", "max_ngram", "max_seq",
        "single_thread", "context_weight", "freq_weight", "lm_weight",
        "variantmodel_weight", "contextrules_weight", "consolidate_matches",
        "unicodeoffsets",
    )

    def __init__(self, **kwargs):
        self._p = _SearchParameters()
        for key, value in kwargs.items():
            if key == "stop_at_exact_match":
                self._p.stop_criterion = (
                    StopCriterion.STOP_AT_EXACT_MATCH
                    if value
                    else StopCriterion.EXHAUSTIVE
                )
            elif key in ("max_anagram_distance", "max_edit_distance"):
                setattr(self._p, key, _coerce_threshold(value))
            elif key in self._FIELDS:
                setattr(self._p, key, value)
            else:
                # reference warns and ignores (bindings lib.rs:255)
                print(f"Ignored unknown kwargs option {key}", file=_sys.stderr)

    @property
    def data(self) -> _SearchParameters:
        return self._p

    @property
    def max_anagram_distance(self):
        return _threshold_value(self._p.max_anagram_distance)

    @max_anagram_distance.setter
    def max_anagram_distance(self, value):
        self._p.max_anagram_distance = _coerce_threshold(value)

    @property
    def max_edit_distance(self):
        return _threshold_value(self._p.max_edit_distance)

    @max_edit_distance.setter
    def max_edit_distance(self, value):
        self._p.max_edit_distance = _coerce_threshold(value)

    @property
    def stop_at_exact_match(self) -> bool:
        return self._p.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH

    @stop_at_exact_match.setter
    def stop_at_exact_match(self, value: bool):
        self._p.stop_criterion = (
            StopCriterion.STOP_AT_EXACT_MATCH if value else StopCriterion.EXHAUSTIVE
        )

    # plain fields delegate straight to the engine dataclass
    _PLAIN = (
        "max_matches", "score_threshold", "cutoff_threshold", "max_ngram",
        "max_seq", "single_thread", "context_weight", "freq_weight",
        "lm_weight", "variantmodel_weight", "contextrules_weight",
        "consolidate_matches", "unicodeoffsets",
    )

    def __getattr__(self, name):
        if name in SearchParameters._PLAIN:
            return getattr(self._p, name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in SearchParameters._PLAIN:
            setattr(self._p, name, value)
        else:
            super().__setattr__(name, value)

    def to_dict(self) -> Dict:
        d = {f: getattr(self, f) for f in self._FIELDS}
        d["stop_at_exact_match"] = self.stop_at_exact_match
        return d


class VocabParams:
    """Per-lexicon load parameters (bindings lib.rs:448-546)."""

    def __init__(self, **kwargs):
        self._p = _VocabParams()
        for key, value in kwargs.items():
            if key == "text_column":
                self._p.text_column = int(value)
            elif key == "freq_column":
                self._p.freq_column = value if value is None else int(value)
            elif key == "index":
                self._p.index = int(value)
            elif key == "freqhandling":
                try:
                    self._p.freq_handling = FrequencyHandling(value)
                except ValueError:
                    print(
                        f"WARNING: Ignored unknown value for "
                        f"VocabParams.freqhandling ({value})"
                    )
            elif key == "vocabtype":
                mapping = {
                    "NONE": VocabType.NONE,
                    "INDEXED": VocabType.INDEXED,
                    "TRANSPARENT": VocabType.TRANSPARENT | VocabType.INDEXED,
                    "LM": VocabType.LM,
                }
                if value in mapping:
                    self._p.vocab_type = mapping[value]
                else:
                    print(
                        f"WARNING: Ignored unknown value for "
                        f"VocabParams.vocabtype ({value})"
                    )
            else:
                print(f"WARNING: Ignored unknown VocabParams kwargs option {key}")

    @property
    def data(self) -> _VocabParams:
        return self._p

    text_column = property(
        lambda self: self._p.text_column,
        lambda self, v: setattr(self._p, "text_column", int(v)),
    )
    freq_column = property(
        lambda self: self._p.freq_column,
        lambda self, v: setattr(self._p, "freq_column", v),
    )
    index = property(
        lambda self: self._p.index,
        lambda self, v: setattr(self._p, "index", int(v)),
    )


class VariantModel:
    """analiticcl.VariantModel-compatible facade (bindings lib.rs:548-812)."""

    def __init__(self, alphabet_file: str, weights: Weights, debug: int = 0):
        self.engine = _EngineModel(
            alphabet_file=alphabet_file, weights=weights._w, debug=debug
        )

    # --- construction & loading -------------------------------------
    def build(self) -> None:
        self.engine.build()

    def add_to_vocabulary(
        self, text: str, frequency: Optional[int], params: VocabParams
    ) -> None:
        self.engine.add_to_vocabulary(text, frequency, params._p)

    def read_vocabulary(self, filename: str, params: VocabParams) -> None:
        self.engine.read_vocabulary(filename, params._p)

    def read_lexicon(self, filename: str) -> None:
        self.engine.read_vocabulary(filename, _VocabParams())

    def read_lm(self, filename: str) -> None:
        self.engine.read_vocabulary(
            filename, _VocabParams(vocab_type=VocabType.LM)
        )

    def read_variants(self, filename: str, transparent: bool = False) -> None:
        self.engine.read_variants(filename, _VocabParams(), transparent)

    def read_confusablelist(self, filename: str) -> None:
        self.engine.read_confusablelist(filename)

    def read_contextrules(self, filename: str) -> None:
        self.engine.read_contextrules(filename)

    def add_contextrule(
        self,
        pattern: str,
        score: float,
        tag: Sequence[str],
        tagoffset: Sequence[str],
    ) -> None:
        self.engine.add_contextrule(pattern, score, list(tag), list(tagoffset))

    def set_confusables_before_pruning(self) -> None:
        self.engine.set_confusables_before_pruning()

    def __contains__(self, text: str) -> bool:
        return text in self.engine

    # --- queries -----------------------------------------------------
    def _variantresult_to_dict(self, result, freq_weight: float) -> Dict:
        value = self.engine.get_vocab(result.vocab_id)
        d = {
            "text": value.text,
            "score": result.score(freq_weight),
            "dist_score": result.dist_score,
            "freq_score": result.freq_score,
        }
        if result.via is not None:
            d["via"] = self.engine.get_vocab(result.via).text
        d["lexicons"] = [
            name
            for i, name in enumerate(self.engine.lexicons)
            if value.in_lexicon(i)
        ]
        return d

    # public parity alias for the binding helper (lib.rs:554-586)
    variantresult_to_dict = _variantresult_to_dict

    def find_variants(self, input: str, params: SearchParameters) -> List[Dict]:
        fw = params._p.freq_weight
        return [
            self._variantresult_to_dict(r, fw)
            for r in self.engine.find_variants(input, params._p)
        ]

    def find_variants_par(
        self, input: Sequence[str], params: SearchParameters
    ) -> List[Dict]:
        """Batched lookup (maps to the device pipeline rather than threads)."""
        fw = params._p.freq_weight
        batches = self.engine.find_variants_batch(list(input), params._p)
        return [
            {
                "input": input_str,
                "variants": [self._variantresult_to_dict(r, fw) for r in results],
            }
            for input_str, results in zip(input, batches)
        ]

    def find_all_matches(self, text: str, params: SearchParameters) -> List[Dict]:
        fw = params._p.freq_weight
        out = []
        for m in self.engine.find_all_matches(text, params._p):
            odict: Dict = {
                "input": m.text,
                "offset": {"begin": m.offset.begin, "end": m.offset.end},
            }
            if m.tag:
                odict["tag"] = [self.engine.tags[t] for t in m.tag]
                odict["seqnr"] = list(m.seqnr)
            variants = []
            if m.variants is not None:
                if m.selected is not None and 0 <= m.selected < len(m.variants):
                    variants.append(
                        self._variantresult_to_dict(m.variants[m.selected], fw)
                    )
                for i, r in enumerate(m.variants):
                    if m.selected is None or m.selected != i:
                        variants.append(self._variantresult_to_dict(r, fw))
            odict["variants"] = variants
            out.append(odict)
        return out
