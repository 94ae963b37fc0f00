"""The VariantModel engine: loaders, index build, variant querying, ranking.

Parity target: /root/reference/src/lib.rs (VariantModel). The architecture is
device-first rather than a port:

  * ``build()`` produces a dense *array index*: the count-vector matrix of all
    indexed entries in a canonical order (sorted by prime-product anagram value
    then vocab id, matching the reference's BTreeSet iteration order,
    lib.rs:1149 + insertion order in nodes), plus padded normalized strings,
    frequencies, and casing flags.
  * candidate retrieval is an L1-ball query over that matrix. This is exactly
    the set the reference's deletion-BFS + insertion sweep explores
    (lib.rs:1143-1308): an index entry is reachable within ``k`` anagram
    insertions/deletions iff the L1 distance between count vectors is <= k.
  * batched queries run on the device (see ops/pipeline.py); a numpy/scalar
    oracle path implements the same semantics for parity testing and tiny
    models.

Scoring, ranking, crops, variant expansion, and confusable rescoring follow
lib.rs:1405-1756 exactly.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..alphabet import Alphabet, AlphabetEncoder, read_alphabet_file
from ..anahash import counts_to_anavalue
from ..confusables import Confusable
from ..editscript import shortest_edit_script
from ..ops import distance as dist_oracle
from ..search import (
    ContextRule,
    Match,
    PatternMatch,
    PatternMatchResult,
    SequenceHyp,
    TRANSITION_SMOOTHING_LOGPROB,
)
from ..types import (
    Distance,
    MAX_ANAGRAM_DISTANCE,
    MAX_EDIT_DISTANCE,
    SearchParameters,
    StopCriterion,
    VariantReference,
    VariantReferenceKind,
    VariantResult,
    VocabId,
    Weights,
    rank_results,
)
from ..vocab import (
    BOS,
    EOS,
    UNK,
    FrequencyHandling,
    VocabParams,
    VocabType,
    VocabValue,
    init_vocab,
)


@dataclass
class BuiltIndex:
    """Dense array form of the anagram index, in canonical enumeration order.

    Canonical order = ascending (prime-product anagram value, vocab id); ties
    in scoring then break identically to the reference (stable sort over the
    gather order, lib.rs:1311-1402 + 1527-1533).
    """

    vocab_ids: np.ndarray  # int64 [Ni]
    counts: np.ndarray  # uint8  [Ni, A]
    charcounts: np.ndarray  # int32  [Ni]
    norms: np.ndarray  # uint16 [Ni, Lmax]
    norm_lens: np.ndarray  # int32  [Ni]
    freqs: np.ndarray  # float64[Ni]
    first_lower: np.ndarray  # bool   [Ni]
    max_norm_len: int
    # anagram grouping (for get_anagram_instances / index dump)
    group_lookup: Optional[Dict[bytes, Tuple[int, int]]]  # built lazily
    group_anavalues: Optional[List[int]]  # bigints, computed lazily
    group_ranges: List[Tuple[int, int]]

    def norms_reversed(self) -> np.ndarray:
        """Left-aligned reversed norms (for gather-free suffix metrics)."""
        if getattr(self, "_norms_rev", None) is None:
            L = self.norms.shape[1]
            pos = np.arange(L, dtype=np.int32)[None, :]
            idx = self.norm_lens[:, None] - 1 - pos
            valid = idx >= 0
            self._norms_rev = np.where(
                valid,
                np.take_along_axis(self.norms, np.maximum(idx, 0), axis=1),
                0,
            ).astype(np.int32)
        return self._norms_rev

    def lookup(self) -> Dict[bytes, Tuple[int, int]]:
        if self.group_lookup is None:
            self.group_lookup = {
                self.counts[s].tobytes(): (s, e) for s, e in self.group_ranges
            }
        return self.group_lookup

    def vid_to_row(self) -> np.ndarray:
        """Inverse of vocab_ids: row index per vocab id, -1 when not indexed.
        Built lazily (one scatter); learn's incremental freq refresh updates
        only the bumped rows through it. Sized to the vids known at build
        time — later (transparent, non-indexed) vids simply fall outside."""
        if getattr(self, "_vid_to_row", None) is None:
            n = int(self.vocab_ids.max(initial=-1)) + 1
            inv = np.full(n, -1, dtype=np.int64)
            inv[self.vocab_ids] = np.arange(len(self.vocab_ids))
            self._vid_to_row = inv
        return self._vid_to_row

    @property
    def size(self) -> int:
        return len(self.vocab_ids)

    def group_anavalue(self, g: int) -> int:
        """Prime-product anagram value of group ``g`` (ascending in g)."""
        start, _ = self.group_ranges[g]
        return counts_to_anavalue(self.counts[start])


class VariantModel:
    """High-level model holding all data for variant matching (lib.rs:50-100)."""

    def __init__(
        self,
        alphabet_file: Optional[str] = None,
        weights: Optional[Weights] = None,
        debug: int = 0,
        alphabet: Optional[Alphabet] = None,
    ):
        if alphabet is None:
            if alphabet_file is None:
                raise ValueError("provide alphabet_file or alphabet")
            alphabet = read_alphabet_file(alphabet_file)
        self.alphabet: Alphabet = alphabet
        self.enc = AlphabetEncoder(alphabet)
        self.weights = weights if weights is not None else Weights()
        self.debug = debug

        self.decoder: List[VocabValue] = []
        self.encoder: Dict[str, VocabId] = {}
        init_vocab(self.decoder, self.encoder)

        self.index: Optional[BuiltIndex] = None
        self.ngrams: Dict[Tuple[VocabId, ...], int] = {}
        self.freq_sum: List[int] = [0]
        self.have_freq = False
        self.have_lm = False
        self.context_rules: List[ContextRule] = []
        self.tags: List[str] = []
        self.lexicons: List[str] = []
        self.confusables: List[Confusable] = []
        self.confusables_before_pruning = False
        # device pipeline handle (set lazily; see ops/pipeline.py)
        self._device = None
        self._backend = "auto"  # auto | device | oracle

    # ------------------------------------------------------------------
    # Construction & loading
    # ------------------------------------------------------------------

    @classmethod
    def new_with_alphabet(
        cls, alphabet: Alphabet, weights: Optional[Weights] = None, debug: int = 0
    ) -> "VariantModel":
        return cls(alphabet=alphabet, weights=weights, debug=debug)

    def set_confusables_before_pruning(self) -> None:
        self.confusables_before_pruning = True

    def set_backend(self, backend: str) -> None:
        """Select the query backend: 'auto', 'device' (JAX), or 'oracle' (numpy)."""
        assert backend in ("auto", "device", "oracle")
        self._backend = backend
        self._device = None

    def use_mesh(self, mesh=None, dp: Optional[int] = None) -> None:
        """Shard the index over a device mesh (see parallel/mesh.py).

        ``mesh`` defaults to a ("dp", "lex") mesh over all visible devices with
        the given dp degree (default 1 = pure lexicon sharding).
        """
        from ..parallel.mesh import ShardedPipeline, make_mesh

        if self.index is None:
            raise RuntimeError("call build() before use_mesh()")
        self._backend = "device"
        self._device = ShardedPipeline(
            self, make_mesh(dp=dp) if mesh is None else mesh
        )

    def alphabet_size(self) -> int:
        """Alphabet size incl. the UNK symbol (lib.rs:163-165)."""
        return len(self.alphabet) + 1

    def save(self, path: str) -> None:
        """Checkpoint the model (vocabulary, links, LM, built index) to .npz."""
        from ..checkpoint import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, backend: str = "auto") -> "VariantModel":
        """Restore a model checkpointed with :meth:`save`."""
        from ..checkpoint import load_model

        return load_model(path, backend)

    def read_confusablelist(self, filename: str) -> None:
        """TSV: sesdiff edit script + optional weight (lib.rs:414-441)."""
        with open(filename, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                weight = float(fields[1]) if len(fields) >= 2 else 1.0
                self.add_to_confusables(fields[0], weight)

    def add_to_confusables(self, editscript: str, weight: float) -> None:
        self.confusables.append(Confusable.new(editscript, weight))

    def read_vocabulary(self, filename: str, params: VocabParams) -> None:
        """Read a lexicon TSV (lib.rs:519-568).

        Bulk-optimized: one file read, a single parse/dedup pass appending
        straight to the decoder (``add_to_vocabulary`` is only invoked for
        the rare already-known texts, preserving its exact merge semantics),
        and NO normalization — ``VocabValue.norm`` is computed lazily by the
        oracle paths, and ``build()`` runs its own batched native pass.
        """
        params = VocabParams(
            text_column=params.text_column,
            freq_column=params.freq_column,
            freq_handling=params.freq_handling,
            vocab_type=params.vocab_type,
            index=len(self.lexicons),
        )
        with open(filename, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        tc = params.text_column
        fc = params.freq_column
        indexed = params.vocab_type.check(VocabType.INDEXED)
        encoder = self.encoder
        decoder = self.decoder
        vt = params.vocab_type
        lexbit_params = params
        enc_get = encoder.get
        new_texts: List[str] = []
        new_freqs: List[int] = []
        nt_append = new_texts.append
        nf_append = new_freqs.append
        next_id = len(decoder)
        any_line = False
        for line in lines:
            if not line:
                continue
            any_line = True
            if tc != 0 or "\t" in line:
                fields = line.split("\t")
                text = fields[tc]
                if fc is not None and fc < len(fields):
                    frequency = int(fields[fc])
                else:
                    frequency = 1
            else:
                text = line
                frequency = 1
            vid = enc_get(text)
            if vid is None:
                # within-file duplicates still merge: register the id now
                encoder[text] = next_id
                next_id += 1
                nt_append(text)
                nf_append(frequency)
            else:
                if vid >= len(decoder):
                    # duplicate of a row earlier in THIS file (not yet
                    # materialized): merge into the pending column
                    row = vid - len(decoder)
                    fh = params.freq_handling
                    if fh is FrequencyHandling.SUM:
                        new_freqs[row] += frequency
                    elif fh is FrequencyHandling.MAX:
                        new_freqs[row] = max(new_freqs[row], frequency)
                    elif fh is FrequencyHandling.MIN:
                        new_freqs[row] = min(new_freqs[row], frequency)
                    else:
                        new_freqs[row] = frequency
                else:
                    # existing entry (earlier lexicon or special token):
                    # exact merge semantics live in add_to_vocabulary
                    self.add_to_vocabulary(text, frequency, lexbit_params)
        if fc is not None and indexed and any_line:
            self.have_freq = True
        lexbit = 1 << params.index
        decoder.extend(
            VocabValue(
                text=text,
                norm=None,
                frequency=frequency,
                tokencount=text.count(" ") + 1,
                lexindex=lexbit,
                variants=None,
                vocabtype=vt,
            )
            for text, frequency in zip(new_texts, new_freqs)
        )
        self.lexicons.append(filename)

    # alias matching the Python binding surface
    read_lexicon = read_vocabulary

    def read_variants(
        self,
        filename: str,
        params: Optional[VocabParams] = None,
        transparent: bool = False,
    ) -> None:
        """Read a weighted variant list (lib.rs:772-897)."""
        if params is not None:
            params = VocabParams(
                text_column=params.text_column,
                freq_column=params.freq_column,
                freq_handling=params.freq_handling,
                vocab_type=params.vocab_type,
                index=len(self.lexicons),
            )
        else:
            params = VocabParams(index=len(self.lexicons))
        transparent_params = (
            params.with_vocab_type(params.vocab_type | VocabType.TRANSPARENT)
            if transparent
            else params
        )
        has_freq: Optional[bool] = None
        with open(filename, "r", encoding="utf-8") as f:
            for linenr, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line:
                    continue
                fields = line.split("\t")
                reference = fields[0]
                freq: Optional[int] = None
                if has_freq is None:
                    # autodetect frequency-bearing column layout (lib.rs:815-830)
                    if (len(fields) - 2) % 3 == 0:
                        try:
                            freq = int(fields[1])
                            has_freq = True
                        except (ValueError, IndexError):
                            freq = None
                    else:
                        has_freq = False
                elif has_freq:
                    freq = int(fields[1])
                ref_id = self.add_to_vocabulary(reference, freq, params)
                vparams = transparent_params if transparent else params
                if has_freq:
                    rest = fields[2:]
                    for k in range(0, len(rest) - 2, 3):
                        variant = rest[k]
                        score = float(rest[k + 1])
                        vfreq = int(rest[k + 2])
                        self.add_variant(ref_id, variant, score, vfreq, vparams)
                else:
                    rest = fields[1:]
                    for k in range(0, len(rest) - 1, 2):
                        variant = rest[k]
                        score = float(rest[k + 1])
                        self.add_variant(ref_id, variant, score, None, vparams)
        self.lexicons.append(filename)

    def read_contextrules(self, filename: str) -> None:
        """4-column TSV: pattern; score; tags; tagoffsets (lib.rs:570-656)."""
        with open(filename, "r", encoding="utf-8") as f:
            for linenr, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                fields = line.split("\t")
                if len(fields) < 2:
                    raise ValueError(
                        f"Expected at least two columns in context rules file "
                        f"{filename}, line {linenr}"
                    )
                pattern = fields[0]
                if not pattern:
                    continue
                try:
                    score = float(fields[1])
                except ValueError:
                    raise ValueError(
                        "context rule score should be a floating point value "
                        f"({filename}, line {linenr})"
                    )
                tag = (
                    [w.strip() for w in fields[2].split(";") if w.strip()]
                    if len(fields) > 2
                    else []
                )
                tagoffset = (
                    [w.strip() for w in fields[3].split(";") if w.strip()]
                    if len(fields) > 3
                    else []
                )
                if len(tag) == 1 and len(tagoffset) == 0:
                    tagoffset.append("0:")
                elif len(tag) != len(tagoffset):
                    raise ValueError(
                        "Multiple tags specified for a context rule; expected the "
                        f"same number of tag offsets ({filename}, line {linenr})"
                    )
                self.add_contextrule(pattern, score, tag, tagoffset)

    def add_contextrule(
        self,
        pattern: str,
        score: float,
        tag: Sequence[str],
        tagoffset: Sequence[str],
    ) -> None:
        """Parse and register a context rule (lib.rs:658-764)."""
        expressions = [s.strip() for s in pattern.split(";")]
        parsed: List[PatternMatch] = [
            PatternMatch.parse(expr, self.lexicons, self.encoder)
            for expr in expressions
        ]
        tag_ids: List[int] = []
        for t in tag:
            if not t:
                raise ValueError("tag is empty")
            if t in self.tags:
                tag_ids.append(self.tags.index(t))
            else:
                self.tags.append(t)
                tag_ids.append(len(self.tags) - 1)
        offsets: List[Tuple[int, int]] = []
        for s in tagoffset:
            fields = s.split(":")
            tagbegin = int(fields[0]) if fields and fields[0] else 0
            if len(fields) > 1 and fields[1]:
                taglength = int(fields[1])
            else:
                taglength = len(parsed) - tagbegin
            offsets.append((tagbegin, taglength))
        while len(offsets) < len(tag_ids):
            offsets.append((0, len(parsed)))
        if parsed:
            self.context_rules.append(
                ContextRule(pattern=parsed, score=score, tag=tag_ids, tagoffset=offsets)
            )

    def add_to_vocabulary(
        self,
        text: str,
        frequency: Optional[int],
        params: VocabParams,
        norm: Optional[List[int]] = None,
    ) -> VocabId:
        """Add/merge an entry (lib.rs:900-967). ``norm`` may carry a
        precomputed normalization (batch ingestion path)."""
        frequency = frequency if frequency is not None else 1
        vocab_id = self.encoder.get(text)
        if vocab_id is not None:
            item = self.decoder[vocab_id]
            fh = params.freq_handling
            if fh is FrequencyHandling.SUM:
                item.frequency += frequency
            elif fh is FrequencyHandling.MAX:
                item.frequency = max(item.frequency, frequency)
            elif fh is FrequencyHandling.MIN:
                item.frequency = min(item.frequency, frequency)
            else:
                item.frequency = frequency
            if vocab_id in (BOS, EOS, UNK):
                item.vocabtype = VocabType.LM  # by definition (lib.rs:933-934)
            elif item.vocabtype.check(VocabType.TRANSPARENT) and not params.vocab_type.check(
                VocabType.TRANSPARENT
            ):
                # a later non-transparent lexicon removes transparency
                item.vocabtype ^= VocabType.TRANSPARENT
            item.lexindex |= 1 << params.index
            return vocab_id
        self.encoder[text] = len(self.decoder)
        self.decoder.append(
            VocabValue(
                text=text,
                norm=norm,  # None = computed lazily (oracle paths only)
                frequency=frequency,
                tokencount=text.count(" ") + 1,
                lexindex=1 << params.index,
                variants=None,
                vocabtype=params.vocab_type,
            )
        )
        return len(self.decoder) - 1

    def add_variant(
        self,
        ref_id: VocabId,
        variant: str,
        score: float,
        freq: Optional[int],
        params: VocabParams,
    ) -> bool:
        variantid = self.add_to_vocabulary(variant, freq, params)
        return self.add_variant_by_id(ref_id, variantid, score)

    def add_variant_by_id(
        self, ref_id: VocabId, variantid: VocabId, score: float
    ) -> bool:
        """Create bidirectional variant links, first mention wins (lib.rs:478-514)."""
        if variantid == ref_id:
            return False
        refitem = self.decoder[ref_id] if ref_id < len(self.decoder) else None
        if refitem is not None:
            ref = VariantReference(
                VariantReferenceKind.REFERENCE_FOR, variantid, score
            )
            if refitem.variants is None:
                refitem.variants = [ref]
            elif not any(
                v.kind is VariantReferenceKind.REFERENCE_FOR and v.vocab_id == variantid
                for v in refitem.variants
            ):
                refitem.variants.append(ref)
        varitem = self.decoder[variantid] if variantid < len(self.decoder) else None
        if varitem is not None:
            ref = VariantReference(VariantReferenceKind.VARIANT_OF, ref_id, score)
            if varitem.variants is None:
                varitem.variants = [ref]
            elif not any(
                v.kind is VariantReferenceKind.VARIANT_OF and v.vocab_id == variantid
                for v in varitem.variants
            ):
                varitem.variants.append(ref)
        return True

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    def build(self) -> None:
        """Build the array index + language model (lib.rs:192-297).

        Array construction is fully batched: one native normalization pass
        over all indexed entries, count vectors via a single bincount, and
        the canonical (anagram value, vocab id) sort over 512-bit big-endian
        prime-product keys computed natively (exact Python-int fallback)."""
        self._lm_tables_cache = None
        self._lm_vidtok_cache = None
        A = self.alphabet_size()
        indexed_flag = int(VocabType.INDEXED)
        lm_flag = int(VocabType.LM)
        # ONE pass over the decoder collecting everything every later stage
        # needs (at 1M entries, each extra pass with enum attribute access
        # costs ~0.5 s; .value & flag avoids IntFlag.__and__ overhead)
        indexed_vids: List[int] = []
        texts: List[str] = []
        lm_vids: List[int] = []
        freq_list: List[int] = []
        fl_list: List[bool] = []
        iv_append = indexed_vids.append
        tx_append = texts.append
        lm_append = lm_vids.append
        fq_append = freq_list.append
        fl_append = fl_list.append
        for vid, value in enumerate(self.decoder):
            vt = value.vocabtype.value
            text = value.text
            if vt & indexed_flag:
                iv_append(vid)
                tx_append(text)
            if vt & lm_flag:
                lm_append(vid)
            fq_append(value.frequency)
            fl_append(text[:1].islower() if text else False)

        if indexed_vids:
            norms_all, lens_all = self.enc.normalize_batch_padded(texts)
            max_norm_len = max(int(lens_all.max()), 1)
            norms_all = norms_all[:, :max_norm_len]
            counts = self.enc.counts_from_norms(norms_all, lens_all)

            # canonical sort keys: big-endian prime products
            from ..types import PRIMES
            from ..utils.native import anavalue_bytes_batch

            primes = PRIMES[: A]
            keys = anavalue_bytes_batch(
                norms_all, lens_all, primes, self.enc.unk_norm_index
            )
            vids_arr = np.asarray(indexed_vids, dtype=np.int64)
            if keys is not None:
                skeys = keys.view("S64").reshape(-1)
                saturated = skeys == b"\xff" * 64
                # rows are in ascending-vid order, so a STABLE key-only sort
                # already yields (key, vid) order — no composite record sort.
                # Fast path: when every value fits 192 bits (top 40 bytes
                # zero — true for any word of < ~28 letters), compare as
                # three big-endian u64 words via lexsort (~4x faster than
                # the 64-byte string argsort at 1M rows).
                words = keys.view(">u8").reshape(-1, 8)
                if not words[:, :5].any():
                    order = np.lexsort(
                        (words[:, 7], words[:, 6], words[:, 5])
                    )
                else:
                    order = np.argsort(skeys, kind="stable")
                if saturated.any():
                    # exact ordering among >512-bit values via Python ints
                    sat_rows = np.nonzero(saturated)[0]
                    sat_in_order = [r for r in order if saturated[r]]
                    sat_sorted = sorted(
                        sat_in_order,
                        key=lambda r: (
                            counts_to_anavalue(counts[r]),
                            vids_arr[r],
                        ),
                    )
                    order = np.concatenate(
                        [order[~saturated[order]], np.asarray(sat_sorted)]
                    ).astype(order.dtype)
            else:
                order = np.asarray(
                    sorted(
                        range(len(vids_arr)),
                        key=lambda r: (counts_to_anavalue(counts[r]), vids_arr[r]),
                    )
                )

            vocab_ids = vids_arr[order]
            counts = counts[order]
            # norm indices are alphabet positions: int8 whenever they fit
            # (fresh-page faults cost ~70 ms/MB on Firecracker-style VMs, so
            # the index keeps narrow dtypes end-to-end — the native
            # normalizer already emits int8 for small alphabets; the device
            # pipeline consumes either width)
            norm_dtype = np.int8 if A <= 126 else np.int32
            if norms_all.dtype != norm_dtype:
                norms_all = norms_all.astype(norm_dtype)
            norms = norms_all[order]
            norm_lens = np.minimum(lens_all[order], max_norm_len).astype(np.int32)
            charcounts = counts.sum(axis=1, dtype=np.int32)
            # columns collected in the single decoder pass above
            dec_freq = np.asarray(freq_list, dtype=np.float64)
            dec_fl = np.asarray(fl_list, dtype=bool)
            freqs = dec_freq[vocab_ids]
            first_lower = dec_fl[vocab_ids]
            # group boundaries: runs of identical count vectors in sorted order
            n = len(vocab_ids)
            boundary = np.ones(n, dtype=bool)
            boundary[1:] = np.any(counts[1:] != counts[:-1], axis=1)
            starts = np.nonzero(boundary)[0]
            ends = np.append(starts[1:], n)
            # [G, 2] array: rows tuple-unpack like the (start, end) tuples
            # consumers expect, without materializing G Python tuples
            group_ranges = np.stack([starts, ends], axis=1)
            self.index = BuiltIndex(
                vocab_ids=vocab_ids,
                counts=counts,
                charcounts=charcounts,
                norms=norms,
                norm_lens=norm_lens,
                freqs=freqs,
                first_lower=first_lower,
                max_norm_len=max_norm_len,
                group_lookup=None,  # built lazily on first exact lookup
                group_anavalues=None,  # computed lazily (see group_anavalue)
                group_ranges=group_ranges,
            )
        else:
            self.index = None
        self._device = None  # invalidate any device copy

        # --- language model construction (lib.rs:247-297) ---
        self.ngrams.clear()
        self.freq_sum = [0]
        unseen_parts: Dict[str, VocabId] = {}
        for vid in lm_vids:
            ngram = self.into_ngram(vid, unseen_parts)
            if ngram is None:  # order > 5: reference errors out and skips
                continue
            freq = self.decoder[vid].frequency
            if len(ngram) > 1:
                while len(self.freq_sum) < len(ngram):
                    self.freq_sum.append(0)
                self.freq_sum[len(ngram) - 1] += freq
            else:
                self.freq_sum[0] += freq
            self.add_ngram(ngram, freq)
        for part, vid in unseen_parts.items():
            self.add_ngram((vid,), 1)
            self.encoder[part] = vid
            # mirror VocabValue::new (vocab.rs:64-75): tokencount counts spaces
            self.decoder.append(
                VocabValue(
                    text=part,
                    norm=[],
                    frequency=1,
                    tokencount=part.count(" "),
                    lexindex=0,
                    variants=None,
                    vocabtype=VocabType.LM,
                )
            )
        self.have_lm = bool(self.ngrams)

    def _norm_to_counts(self, text: str, alphabet_size: int) -> np.ndarray:
        return self.enc.count_vector(text)

    # ------------------------------------------------------------------
    # Lookups / accessors (lib.rs:299-360, 2756-2813)
    # ------------------------------------------------------------------

    def contains_anagram(self, counts: np.ndarray) -> bool:
        return self.index is not None and counts.tobytes() in self.index.lookup()

    def get_anagram_instances(self, text: str) -> List[VocabValue]:
        if self.index is None:
            return []
        key = self.enc.count_vector(text).tobytes()
        rng = self.index.lookup().get(key)
        if rng is None:
            return []
        return [
            self.decoder[int(self.index.vocab_ids[i])] for i in range(rng[0], rng[1])
        ]

    def get(self, text: str) -> Optional[VocabValue]:
        for instance in self.get_anagram_instances(text):
            if instance.text == text:
                return instance
        return None

    def has(self, text: str) -> bool:
        return self.get(text) is not None

    def get_vocab(self, vocab_id: VocabId) -> Optional[VocabValue]:
        if 0 <= vocab_id < len(self.decoder):
            return self.decoder[vocab_id]
        return None

    def __contains__(self, text: str) -> bool:
        return self.has(text)

    # ------------------------------------------------------------------
    # Query: find_variants (lib.rs:969-1027)
    # ------------------------------------------------------------------

    def find_variants(
        self, input_text: str, params: SearchParameters
    ) -> List[VariantResult]:
        return self.find_variants_batch([input_text], params)[0]

    def find_variants_batch(
        self, inputs: Sequence[str], params: SearchParameters
    ) -> List[List[VariantResult]]:
        """Batched variant lookup; the device replacement for per-input
        rayon parallelism (reference bin:416-482)."""
        if self.index is None:
            print(
                "ERROR: Model has not been built yet! Call build() before "
                "find_variants()",
                file=sys.stderr,
            )
            return [[] for _ in inputs]
        backend = self._backend
        if backend == "auto":
            backend = "device" if len(self.index.vocab_ids) >= 64 else "oracle"
        if backend == "device":
            from ..ops.pipeline import get_device_pipeline

            if self._device is None:
                self._device = get_device_pipeline(self)
            return self._device.find_variants_batch(inputs, params)
        return [self._find_variants_oracle(text, params) for text in inputs]

    def find_variants_stream(
        self, inputs: Sequence[str], params: SearchParameters, batch_size: int = 4096
    ):
        """Generator over per-input results with double-buffered device
        execution: the device computes batch N+1 while the host ranks batch N
        (hides device round trips). Falls back to plain batching on the
        oracle backend."""
        from itertools import islice

        backend = self._backend
        if backend == "auto":
            backend = "device" if (self.index and self.index.size >= 64) else "oracle"
        if backend != "device":
            it = iter(inputs)
            while True:
                chunk = list(islice(it, batch_size))
                if not chunk:
                    return
                for res in self.find_variants_batch(chunk, params):
                    yield res
            return
        if self._device is None:
            from ..ops.pipeline import get_device_pipeline

            self._device = get_device_pipeline(self)
        # huge lexicons cap the per-call batch (see DevicePipeline.max_B)
        batch_size = min(batch_size, self._device.max_B)
        it = iter(inputs)

        def batches():
            # islice chunking: accepts plain lists AND unsized iterables
            # (the suite's steady-state stream cycles a generator)
            while True:
                chunk = list(islice(it, batch_size))
                if not chunk:
                    return
                yield chunk

        for batch_results in self._device.find_variants_stream(
            batches(), params
        ):
            for res in batch_results:
                yield res

    def _resolve_distances(
        self, normstring_len: int, params: SearchParameters
    ) -> Tuple[int, int]:
        """Per-input absolute anagram/edit distances (lib.rs:982-1012)."""
        k_ana = params.max_anagram_distance.resolve(normstring_len, MAX_ANAGRAM_DISTANCE)
        k_ed = params.max_edit_distance.resolve(normstring_len, MAX_EDIT_DISTANCE)
        return k_ana, k_ed

    def _find_variants_oracle(
        self, input_text: str, params: SearchParameters
    ) -> List[VariantResult]:
        """Reference-mirroring host path (numpy retrieval + scalar DL)."""
        index = self.index
        assert index is not None
        normstring = self.enc.normalize(input_text)
        if not normstring:
            return []
        q = self.enc.count_vector(input_text)
        k_ana, k_ed = self._resolve_distances(len(normstring), params)

        # exact pre-filter: DL >= |len(a)-len(b)| (indels change length by 1,
        # substitutions/transpositions preserve it), so candidates outside the
        # +-k_ed length band can never reach the result set — this makes the
        # long-query fallback O(band) instead of O(lexicon)
        band = np.nonzero(
            np.abs(index.norm_lens.astype(np.int32) - len(normstring)) <= k_ed
        )[0]
        d = np.abs(
            index.counts[band].astype(np.int32) - q.astype(np.int32)
        ).sum(axis=1)
        if (
            params.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH
            and (d == 0).any()
        ):
            mask = d == 0
        else:
            mask = d <= k_ana
        rows = band[np.nonzero(mask)[0]]  # canonical order preserved

        instances: List[Tuple[VocabId, Distance]] = []
        q_first_lower = input_text[:1].islower() if input_text else False
        w = self.weights
        for row in rows:
            vid = int(index.vocab_ids[row])
            item = self.decoder[vid]
            # candidate norms live in the built index arrays (build() never
            # truncates: norm length <= utf-8 byte length <= the batch pad)
            cand_norm = index.norms[row, : index.norm_lens[row]].tolist()
            ld = dist_oracle.damerau_levenshtein(normstring, cand_norm, k_ed)
            if ld is None:
                continue
            instances.append(
                (
                    vid,
                    Distance(
                        ld=ld,
                        lcs=(
                            dist_oracle.longest_common_substring_length(
                                normstring, cand_norm
                            )
                            if w.lcs > 0.0
                            else 0
                        ),
                        prefixlen=(
                            dist_oracle.common_prefix_length(normstring, cand_norm)
                            if w.prefix > 0.0
                            else 0
                        ),
                        suffixlen=(
                            dist_oracle.common_suffix_length(normstring, cand_norm)
                            if w.suffix > 0.0
                            else 0
                        ),
                        samecase=(
                            (item.text[:1].islower() == q_first_lower)
                            if w.case > 0.0
                            else True
                        ),
                    ),
                )
            )
        return self.score_and_rank(
            instances,
            input_text,
            len(normstring),
            params.max_matches,
            params.score_threshold,
            params.cutoff_threshold,
            params.freq_weight,
        )

    # ------------------------------------------------------------------
    # Scoring & ranking (lib.rs:1404-1756)
    # ------------------------------------------------------------------

    def score_and_rank(
        self,
        instances: List[Tuple[VocabId, Distance]],
        input_text: str,
        input_length: int,
        max_matches: int,
        score_threshold: float,
        cutoff_threshold: float,
        freq_weight: float,
        max_freq_floor: float = 0.0,
    ) -> List[VariantResult]:
        """``max_freq_floor`` lets the device pipeline report the maximum
        frequency among above-threshold candidates that were cropped before
        reaching the host (frequency normalization, lib.rs:1521-1525, must see
        the full above-threshold set)."""
        results: List[VariantResult] = []
        max_freq = max_freq_floor
        has_expandable = False
        weights_sum = self.weights.sum()
        assert input_length > 0

        for vocab_id, distance in instances:
            item = self.get_vocab(vocab_id)
            if item is None:
                continue
            if distance.ld > input_length:
                distance_score = 0.0
            else:
                distance_score = 1.0 - distance.ld / input_length
            lcs_score = distance.lcs / input_length
            prefix_score = distance.prefixlen / input_length
            suffix_score = distance.suffixlen / input_length
            score = (
                self.weights.ld * distance_score
                + self.weights.lcs * lcs_score
                + self.weights.prefix * prefix_score
                + self.weights.suffix * suffix_score
                + (self.weights.case if distance.samecase else 0.0)
            ) / weights_sum
            freq_score = float(item.frequency) if self.have_freq else 1.0
            if freq_score > max_freq:
                max_freq = freq_score
            if not has_expandable and item.variants is not None:
                has_expandable = True
            if math.isnan(score):
                raise ValueError(f"Invalid score (NaN) for variant={item.text}")
            if self.debug >= 3:
                print(
                    f"   (variant={item.text}, distance={distance}, "
                    f"score={score}, "
                    f"transparent={item.vocabtype.check(VocabType.TRANSPARENT)}"
                    f"{'' if score >= score_threshold else ', PRUNED'})",
                    file=sys.stderr,
                )
            if score >= score_threshold:
                results.append(
                    VariantResult(
                        vocab_id=vocab_id,
                        dist_score=score,
                        freq_score=freq_score,
                        via=None,
                    )
                )

        return self._rank_tail(
            results,
            input_text,
            max_matches,
            cutoff_threshold,
            freq_weight,
            max_freq,
            has_expandable,
        )

    def _rank_tail(
        self,
        results: List[VariantResult],
        input_text: str,
        max_matches: int,
        cutoff_threshold: float,
        freq_weight: float,
        max_freq: float,
        has_expandable: bool,
    ) -> List[VariantResult]:
        """The post-scoring tail of score_and_rank (lib.rs:1505-1652): early
        confusables, expansion, freq normalization, ranking, tie-aware crop,
        late confusables, cutoff threshold."""
        if self.confusables and self.confusables_before_pruning:
            self.rescore_confusables(results, input_text)

        if has_expandable:
            results = self.expand_variants(results)
            for result in results:
                if result.freq_score > max_freq:
                    max_freq = result.freq_score

        if max_freq > 0.0:
            for i, result in enumerate(results):
                results[i] = VariantResult(
                    result[0], result[1], result[2] / max_freq, result[3]
                )

        rank_results(results, freq_weight)

        if has_expandable:
            # remove consecutive duplicates (Rust dedup_by_key semantics)
            deduped: List[VariantResult] = []
            for r in results:
                if not deduped or deduped[-1].vocab_id != r.vocab_id:
                    deduped.append(r)
            results = deduped

        # crop at max_matches with tie handling (lib.rs:1536-1589)
        if 0 < max_matches < len(results):
            last_score = results[max_matches - 1].score(freq_weight)
            cropped_score = results[max_matches].score(freq_weight)
            if cropped_score < last_score:
                del results[max_matches:]
            else:
                early_cutoff = 0
                late_cutoff = 0
                for i, result in enumerate(results):
                    if result.dist_score == cropped_score and early_cutoff == 0:
                        early_cutoff = i
                    if result.dist_score < cropped_score:
                        late_cutoff = i
                        break
                if early_cutoff > 0:
                    del results[early_cutoff + 1 :]
                elif late_cutoff > 0:
                    del results[late_cutoff + 1 :]

        if self.confusables and not self.confusables_before_pruning:
            self.rescore_confusables(results, input_text)
            rank_results(results, freq_weight)

        # cutoff threshold (lib.rs:1597-1622)
        cutoff = 0
        bestscore: Optional[float] = None
        if cutoff_threshold >= 1.0:
            for i, result in enumerate(results):
                if bestscore is not None:
                    if result.score(freq_weight) <= bestscore / cutoff_threshold:
                        cutoff = i
                        break
                else:
                    bestscore = result.score(freq_weight)
        if cutoff > 0:
            del results[cutoff:]
        return results

    def late_rescore_and_cutoff(
        self,
        results: List[VariantResult],
        input_text: str,
        params: SearchParameters,
    ) -> List[VariantResult]:
        """Late-confusables rescoring + relative cutoff over an
        already-cropped list — the tail of :meth:`_rank_tail` after the
        max_matches crop (lib.rs:1592-1622). Used by the device pipeline's
        vectorized ranking fast path, which crops whole batches at once and
        then rescores only the few survivors per query."""
        if self.confusables and not self.confusables_before_pruning:
            self.rescore_confusables(results, input_text)
            rank_results(results, params.freq_weight)
        return self.cutoff_tail(results, params)

    def cutoff_tail(
        self, results: List[VariantResult], params: SearchParameters
    ) -> List[VariantResult]:
        """The relative cutoff-threshold prune (lib.rs:1597-1622)."""
        cutoff = 0
        bestscore: Optional[float] = None
        if params.cutoff_threshold >= 1.0:
            for i, result in enumerate(results):
                if bestscore is not None:
                    if (
                        result.score(params.freq_weight)
                        <= bestscore / params.cutoff_threshold
                    ):
                        cutoff = i
                        break
                else:
                    bestscore = result.score(params.freq_weight)
        if cutoff > 0:
            del results[cutoff:]
        return results

    def rescore_confusables(
        self, results: List[VariantResult], input_text: str
    ) -> None:
        """Multiply in confusable weights (lib.rs:1656-1663). The full match —
        edit scripts plus confusable pattern scan — runs in one native call
        when the C++ library is available (cross-validated against the Python
        path by tests); otherwise falls back to batched native edit scripts
        with Python matching, then to pure Python."""
        if not results:
            return
        texts = [self.decoder[r.vocab_id].text for r in results]
        nc = self._native_confusables()
        if nc is not None:
            try:
                weights = nc.weights_batch(input_text, texts)
            except Exception as e:
                from ..utils.native import warn_once

                warn_once(
                    "native_confusables_batch",
                    f"native confusable matcher failed ({e!r}); "
                    "falling back to edit-script batching",
                )
                weights = None
            if weights is not None:
                for i, (result, w) in enumerate(zip(results, weights)):
                    results[i] = VariantResult(
                        result[0], result[1] * float(w), result[2], result[3]
                    )
                return
        try:
            from ..utils.native import edit_scripts_batch
            from ..editscript import Instruction, Op

            scripts = edit_scripts_batch(input_text, texts)
        except Exception as e:
            from ..utils.native import warn_once

            warn_once(
                "edit_scripts_batch",
                f"native edit-script batch failed ({e!r}); "
                "using pure-Python confusable weights",
            )
            scripts = None
        if scripts is not None:
            for i, (result, ops) in enumerate(zip(results, scripts)):
                script = [Instruction(Op(op), text) for op, text in ops]
                weight = 1.0
                for confusable in self.confusables:
                    if confusable.found_in(script):
                        weight *= confusable.weight
                results[i] = VariantResult(
                    result[0], result[1] * weight, result[2], result[3]
                )
            return
        for i, result in enumerate(results):
            results[i] = VariantResult(
                result[0],
                result[1]
                * self.compute_confusable_weight(input_text, result.vocab_id),
                result[2],
                result[3],
            )

    def _native_confusables(self):
        """Compiled native confusable set, rebuilt when the list changes."""
        key = tuple(map(id, self.confusables))
        cached = getattr(self, "_native_conf_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        nc = None
        if self.confusables:
            try:
                from ..utils.native import NativeConfusables

                nc = NativeConfusables(self.confusables)
            except Exception as e:
                from ..utils.native import warn_once

                warn_once(
                    "native_confusables_build",
                    f"native confusable set unavailable ({e!r}); "
                    "using Python matching",
                )
                nc = None
        self._native_conf_cache = (key, nc)
        return nc

    def compute_confusable_weight(self, input_text: str, candidate: VocabId) -> float:
        """Product of weights of confusables matching the edit script between
        input and candidate (lib.rs:1729-1756)."""
        weight = 1.0
        item = self.get_vocab(candidate)
        if item is not None:
            editscript = shortest_edit_script(input_text, item.text)
            for confusable in self.confusables:
                if confusable.found_in(editscript):
                    weight *= confusable.weight
        return weight

    def expand_variants(self, results: List[VariantResult]) -> List[VariantResult]:
        """Follow VariantOf links; drop TRANSPARENT originals (lib.rs:1677-1727)."""
        new_results: List[VariantResult] = []
        for result in results:
            item = self.decoder[result.vocab_id]
            if item.variants is not None:
                for variantref in item.variants:
                    if variantref.kind is VariantReferenceKind.VARIANT_OF:
                        target = self.decoder[variantref.vocab_id]
                        new_results.append(
                            VariantResult(
                                vocab_id=variantref.vocab_id,
                                dist_score=result.dist_score * variantref.score,
                                freq_score=min(
                                    float(target.frequency), result.freq_score
                                ),
                                via=result.vocab_id,
                            )
                        )
            if not item.vocabtype.check(VocabType.TRANSPARENT):
                new_results.append(result)
        return new_results

    # ------------------------------------------------------------------
    # Language model (lib.rs:2578-2754)
    # ------------------------------------------------------------------

    def add_ngram(self, ngram: Tuple[VocabId, ...], frequency: int) -> None:
        self.ngrams[ngram] = self.ngrams.get(ngram, 0) + frequency
        self._lm_tables_cache = None
        self._lm_vidtok_cache = None

    def into_ngram(
        self, word: VocabId, unseen_parts: Optional[Dict[str, VocabId]]
    ) -> Optional[Tuple[VocabId, ...]]:
        """Decompose a vocab entry into token ids (lib.rs:2687-2729).
        Returns None for orders above 5 (reference errors out)."""
        item = self.decoder[word]
        n = item.tokencount
        if n == 0:
            return ()
        if n > 5:
            return None
        parts = item.text.split(" ")
        return tuple(
            self.encode_token(parts[i], True, unseen_parts) for i in range(n)
        )

    def encode_token(
        self,
        token: str,
        use_unk: bool,
        unseen: Optional[Dict[str, VocabId]],
    ) -> VocabId:
        """lib.rs:2731-2754."""
        vid = self.encoder.get(token)
        if vid is not None:
            return vid
        if use_unk:
            return UNK
        if unseen is not None:
            if token in unseen:
                return unseen[token]
            vid = len(self.decoder) + len(unseen)
            unseen[token] = vid
            return vid
        raise KeyError(f"Token does not exist in vocabulary: {token}")

    def lm_score_tokens(
        self, tokens: List[Optional[VocabId]]
    ) -> Tuple[float, float]:
        """Sliding-bigram log-probability + perplexity (lib.rs:2630-2674)."""
        logprob = 0.0
        n = 0
        for i in range(1, len(tokens)):
            t0, t1 = tokens[i - 1], tokens[i]
            if t0 is not None and t1 is not None:
                prior = (t0,)
                bigram = (t0, t1)
                priorcount = self.ngrams.get(prior, 1)
                jointcount = self.ngrams.get(bigram)
                if jointcount is not None:
                    if priorcount < jointcount:
                        logprob += math.log(jointcount)
                    else:
                        logprob += math.log(jointcount / priorcount)
                else:
                    logprob += TRANSITION_SMOOTHING_LOGPROB
                n += 1
            else:
                n += 1
                logprob += TRANSITION_SMOOTHING_LOGPROB
        perplexity = -1.0 / n * logprob if n else 0.0
        return logprob, perplexity

    def _lm_tables(self):
        """Sorted unigram/bigram count arrays for vectorized LM lookups.

        Built lazily from ``self.ngrams`` (invalidated by build()); bigram
        keys pack (t0, t1) into one int64 so a single searchsorted resolves
        the joint count for every transition in a batch at once."""
        t = getattr(self, "_lm_tables_cache", None)
        if t is not None:
            return t
        bi_k: List[int] = []
        bi_v: List[int] = []
        uni_k: List[int] = []
        uni_v: List[int] = []
        for ng, c in self.ngrams.items():
            if len(ng) == 2:
                bi_k.append((ng[0] << 32) | ng[1])
                bi_v.append(c)
            elif len(ng) == 1:
                uni_k.append(ng[0])
                uni_v.append(c)
        bi_keys = np.asarray(bi_k, dtype=np.int64)
        bi_counts = np.asarray(bi_v, dtype=np.int64)
        order = np.argsort(bi_keys)
        bi_keys, bi_counts = bi_keys[order], bi_counts[order]
        uni_keys = np.asarray(uni_k, dtype=np.int64)
        uni_counts = np.asarray(uni_v, dtype=np.int64)
        order = np.argsort(uni_keys)
        uni_keys, uni_counts = uni_keys[order], uni_counts[order]
        # per-bigram contribution, precomputed ONCE with math.log — the
        # scalar oracle's exact values (lib.rs:2650-2660); the batch path
        # and the native decode gather from this table, so every path is
        # bit-equal to lm_score_tokens by construction
        ngrams_get = self.ngrams.get
        bi_contrib = np.empty(len(bi_keys))
        for i, (key, joint) in enumerate(
            zip(bi_keys.tolist(), bi_counts.tolist())
        ):
            prior = ngrams_get((key >> 32,), 1)
            bi_contrib[i] = (
                math.log(joint) if prior < joint else math.log(joint / prior)
            )
        t = (bi_keys, bi_counts, uni_keys, uni_counts, bi_contrib)
        self._lm_tables_cache = t
        return t

    def lm_score_tokens_batch(
        self, token_lists: Sequence[List[Optional[VocabId]]]
    ) -> List[Tuple[float, float]]:
        """Vectorized ``lm_score_tokens`` over many sequences at once.

        Bit-equal to the scalar path: per-sequence contributions accumulate
        in pair order (np.bincount sums left-to-right), lookups use the same
        default-1 prior and the same smoothing constant."""
        nseq = len(token_lists)
        if nseq == 0:
            return []
        t0s: List[int] = []
        t1s: List[int] = []
        segs: List[int] = []
        for si, toks in enumerate(token_lists):
            for i in range(1, len(toks)):
                a = toks[i - 1]
                b = toks[i]
                t0s.append(-1 if a is None else a)
                t1s.append(-1 if b is None else b)
                segs.append(si)
        return self._lm_score_pairs(
            np.asarray(t0s, dtype=np.int64),
            np.asarray(t1s, dtype=np.int64),
            np.asarray(segs, dtype=np.int64),
            nseq,
        )

    def _lm_score_pairs(
        self,
        t0a: np.ndarray,
        t1a: np.ndarray,
        seg: np.ndarray,
        nseq: int,
    ) -> List[Tuple[float, float]]:
        """Score pre-built (token, next token, sequence) bigram columns
        (None tokens encoded as -1). Contributions accumulate per sequence
        in array order — callers must supply pairs sequence-major and
        left-to-right for bit-equality with the scalar path."""
        logprob, perp = self._lm_score_pairs_arrays(t0a, t1a, seg, nseq)
        return list(zip(logprob.tolist(), perp.tolist()))

    def _lm_score_pairs_arrays(
        self,
        t0a: np.ndarray,
        t1a: np.ndarray,
        seg: np.ndarray,
        nseq: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(logprob, perplexity) arrays per sequence; contributions
        accumulate per sequence in array order (see _lm_score_pairs)."""
        if len(seg) == 0:
            return np.zeros(nseq), np.zeros(nseq)
        present = (t0a >= 0) & (t1a >= 0)

        bi_keys, _bi_counts, _uk, _uc, bi_contrib = self._lm_tables()
        key = (t0a << 32) | np.where(t1a >= 0, t1a, 0)
        if len(bi_keys):
            bidx = np.searchsorted(bi_keys, key)
            bsafe = np.minimum(bidx, len(bi_keys) - 1)
            bfound = present & (bi_keys[bsafe] == key)
            contrib = np.where(
                bfound, bi_contrib[bsafe], TRANSITION_SMOOTHING_LOGPROB
            )
        else:
            contrib = np.full(len(key), TRANSITION_SMOOTHING_LOGPROB)
        logprob = np.bincount(seg, weights=contrib, minlength=nseq)
        n = np.bincount(seg, minlength=nseq)
        with np.errstate(divide="ignore", invalid="ignore"):
            perp = np.where(n > 0, (-1.0 / np.maximum(n, 1)) * logprob, 0.0)
        return logprob, perp

    def lm_score(
        self, sequence: SequenceHyp, boundaries: Sequence[Match]
    ) -> Tuple[float, float]:
        """Expand a sequence into tokens and score it (lib.rs:2578-2628)."""
        tokens: List[Optional[VocabId]] = [BOS]
        for output_symbol in sequence.output_symbols:
            next_boundary = boundaries[output_symbol.boundary_index]
            if output_symbol.vocab_id == 0:
                tokens.append(None)  # out-of-vocabulary, copied from input
            else:
                ngram = self.into_ngram(output_symbol.vocab_id, None)
                if ngram is not None:
                    tokens.extend(ngram)
            btext = next_boundary.text.strip()
            if btext:
                vid = self.encoder.get(btext)
                if vid is not None:
                    ngram = self.into_ngram(vid, None)
                    if ngram is not None:
                        tokens.extend(ngram)
                else:
                    tokens.append(None)
        tokens.append(EOS)
        return self.lm_score_tokens(tokens)

    def test_context_rules(
        self, vids: Sequence[VocabId]
    ) -> Tuple[float, List[List[PatternMatchResult]]]:
        """Apply context rules over a sequence of output vocab ids
        (lib.rs:2501-2576; 0 = out-of-vocabulary)."""
        seq: List[Tuple[VocabId, int]] = []
        for vid in vids:
            if vid == 0:
                seq.append((0, 0))
            else:
                item = self.get_vocab(vid)
                seq.append(
                    (vid, item.lexindex if item is not None else 0)
                )
        sequence_results: List[List[PatternMatchResult]] = [[] for _ in seq]
        found = False
        for begin in range(len(seq)):
            for context_rule in self.context_rules:
                if context_rule.matches(seq, begin, sequence_results):
                    found = True
        if not found:
            return 1.0, sequence_results
        total = sum(x[0].score if x else 1.0 for x in sequence_results)
        return total / len(seq), sequence_results

    # ------------------------------------------------------------------
    # Search mode: find_all_matches (lib.rs:1789-1957)
    # ------------------------------------------------------------------

    def find_all_matches(
        self, text: str, params: SearchParameters
    ) -> List[Match]:
        """Search running text, returning highest-ranking matches.

        Structure mirrors lib.rs:1789-1957, but the per-segment variant
        lookups are *batched across the whole text and all ngram orders* into
        device calls (the device replacement for rayon's par_iter_mut,
        lib.rs:1881-1900). ``consolidate_matches`` is accepted for parity but,
        like the reference (v0.4.9), not consulted here: sequence consolidation
        runs whenever max_ngram > 1, an LM is present, or context rules exist.
        """
        return self.find_all_matches_batch([text], params)[0]

    def find_all_matches_batch(
        self, texts: Sequence[str], params: SearchParameters
    ) -> List[List[Match]]:
        """find_all_matches over many independent texts with ONE combined
        lookup batch: segments of every ngram order of every text are
        deduplicated into a single device pass (learn mode feeds whole corpus
        batches through here; the reference round-trips per line,
        lib.rs:1040-1056)."""
        if self.index is None:
            if any(texts):
                print(
                    "ERROR: Model has not been built yet! Call build() before "
                    "find_all_matches()",
                    file=sys.stderr,
                )
            return [[] for _ in texts]
        backend = self._backend
        if backend == "auto":
            backend = (
                "device" if (self.index and self.index.size >= 64) else "oracle"
            )
        if backend == "device":
            # the stream path aggregates, pipelines, and takes the
            # array-native consolidation; identical results
            return list(self.find_all_matches_stream(texts, params))
        preps, uniq, all_texts = self._fam_prepare(texts, params)
        found = (
            self.find_variants_batch(all_texts, params) if all_texts else []
        )
        return self._fam_consolidate(preps, uniq, found, params)

    def find_all_matches_stream(
        self, texts, params: SearchParameters, depth: int = 2
    ):
        """Pipelined :meth:`find_all_matches` over an iterable of texts.

        Texts are AGGREGATED until their combined unique-segment count fills
        a large device batch (several CLI 100-line groups per fused call —
        segment lookups then run at the same batch efficiency as plain query
        mode), and up to ``depth`` such units stay in flight on the device
        while the host consolidates earlier texts (lattice DP + LM scoring).
        Yields one ``List[Match]`` per text, in order."""
        backend = self._backend
        if backend == "auto":
            backend = (
                "device" if (self.index and self.index.size >= 64) else "oracle"
            )
        if backend != "device" or self.index is None:
            for text in texts:
                yield self.find_all_matches(text, params)
            return
        if self._device is None:
            from ..ops.pipeline import get_device_pipeline

            self._device = get_device_pipeline(self)
        pipe = self._device
        # target one large batch bucket per unit; the token-based estimate
        # (unique segments per token after dedup, workload-dependent) only
        # controls aggregation, never correctness — underestimates simply
        # land in a larger batch bucket. The factor self-calibrates from
        # each prepared unit's actual dedup ratio.
        target = min(int(pipe.max_B * 0.95), 7800)
        est_factor = {1: 1.0, 2: 1.6}.get(min(params.max_ngram, 3), 2.4)
        pending = []  # submitted units
        buf: List[str] = []  # texts accumulated for the next unit
        buf_tokens = 0

        # the array-native unit pipeline covers the argmin decode AND the
        # LM-rescored n-best decode (search_fast._consolidate_lm); only
        # context rules (tags) and debug lattice dumps take the object path
        fast_applicable = (
            getattr(self, "fast_consolidate", True)
            and self.debug < 3
            and not self.context_rules
        )
        consolidate = (
            params.max_ngram > 1 or self.have_lm or bool(self.context_rules)
        )

        def submit_lookups(all_texts):
            """Dispatch a unit's deduplicated lookups as one or more ranked
            batches (oversized units split at max_B — the results
            concatenate back into ONE RankedResults at collect)."""
            sts = []
            for s in range(0, len(all_texts), pipe.max_B):
                st = pipe.submit(all_texts[s : s + pipe.max_B], params)
                st["want_ranked"] = True
                sts.append(st)
            return sts

        def submit_unit(unit_texts, unit_tokens):
            nonlocal est_factor
            all_texts = None
            if fast_applicable:
                from . import search_fast

                with pipe.stats.stage("search_prepare"):
                    unit = search_fast.prepare_unit(
                        unit_texts, params.max_ngram
                    )
                if unit is not None:
                    all_texts = unit.all_texts
                    if unit_tokens:
                        est_factor = 0.5 * est_factor + 0.5 * (
                            len(all_texts) / unit_tokens
                        )
                    return ("arr", unit, None, submit_lookups(all_texts), [])
            preps, uniq, all_texts = self._fam_prepare(unit_texts, params)
            if unit_tokens:
                est_factor = 0.5 * est_factor + 0.5 * (
                    len(all_texts) / unit_tokens
                )
            return ("obj", preps, uniq, submit_lookups(all_texts), [])

        def flush_one():
            from ..ops.pipeline import RankedResults

            kind, preps, uniq, sts, fb = pending.pop(0)
            parts = [pipe.collect(st) for st in sts] if sts else [fb]
            if all(isinstance(p, RankedResults) for p in parts):
                found = RankedResults.concat(parts)
            else:
                # a sub-batch fell off the ranked path (overflow split,
                # object-tail rows): merge as eager per-query lists
                found = []
                for p in parts:
                    found.extend(list(p))
            if kind == "arr":
                from . import search_fast

                with pipe.stats.stage("search_consolidate"):
                    return search_fast.consolidate_unit(
                        preps, found, params, consolidate, self
                    )
            with pipe.stats.stage("search_consolidate_obj"):
                return self._fam_consolidate(preps, uniq, found, params)

        for text in texts:
            ntok = len(text.split())
            if buf and (buf_tokens + ntok) * est_factor > target:
                pending.append(submit_unit(buf, buf_tokens))
                buf, buf_tokens = [], 0
                if len(pending) > depth:
                    yield from flush_one()
            buf.append(text)
            buf_tokens += ntok
        if buf:
            pending.append(submit_unit(buf, buf_tokens))
        while pending:
            yield from flush_one()

    def _fam_prepare(self, texts: Sequence[str], params: SearchParameters):
        """find_all_matches phase 1: segmentation + segment collection
        across ALL texts (one deduplicated lookup list)."""
        from ..search import (
            BoundaryStrength,
            classify_boundaries,
            find_boundaries,
            find_match_ngrams,
        )

        # phase 1: segmentation + segment collection across ALL texts
        preps: List[Optional[Tuple]] = []
        uniq: Dict[str, int] = {}
        all_texts: List[str] = []
        for text in texts:
            if not text:
                preps.append(None)
                continue
            boundaries = find_boundaries(text)
            strengths = classify_boundaries(boundaries)
            bytetext = text.encode("utf-8")

            # split into batches at hard boundaries (lib.rs:1817-1836)
            hard_batches = []  # (begin, end_offset, boundaries_slice, text)
            begin = 0
            begin_index = 0
            for i, (strength, boundary) in enumerate(
                zip(strengths, boundaries)
            ):
                if (
                    strength is BoundaryStrength.HARD
                    and boundary.offset.begin != begin
                ):
                    text_current = bytetext[
                        begin : boundary.offset.begin
                    ].decode("utf-8")
                    hard_batches.append(
                        (
                            begin,
                            boundary.offset.begin,
                            boundaries[begin_index : i + 1],
                            text_current,
                        )
                    )
                    begin = boundary.offset.end
                    begin_index = i + 1

            # segments of ALL orders over all hard batches join the combined
            # lookup. The redundancy filter (search.rs:317-336) only consults
            # order-1 results and only gates whether a higher-order segment's
            # variants are *attached*, so lookups are issued speculatively and
            # the filter applied afterwards — a few wasted candidate lookups
            # in exchange for one batched round trip for everything.
            per_order: List[List[Tuple[int, Match]]] = []
            for order in range(1, params.max_ngram + 1):
                pending: List[Tuple[int, Match]] = []
                for bi, (bbegin, bend, bslice, _btext) in enumerate(
                    hard_batches
                ):
                    for segment in find_match_ngrams(
                        text, bslice, order, bbegin, bend, bytetext=bytetext
                    ):
                        pending.append((bi, segment))
                        if segment.text not in uniq:
                            uniq[segment.text] = len(all_texts)
                            all_texts.append(segment.text)
                per_order.append(pending)
            preps.append((text, hard_batches, per_order))
        return preps, uniq, all_texts

    def _fam_fast_ok(self, found, params: SearchParameters) -> bool:
        """Whether the array-native consolidation applies: device results
        arrived as a RankedResults batch and the decode reduces to pure
        argmin path cost (no LM in play, no context rules, no lattice
        dump). ``fast_consolidate = False`` forces the object path (used by
        the equivalence tests)."""
        if not getattr(self, "fast_consolidate", True) or self.debug >= 3:
            return False
        from ..ops.pipeline import RankedResults

        if not isinstance(found, RankedResults):
            return False
        if self.context_rules:  # tags are computed even at weight 0
            return False
        if self.have_lm and params.lm_weight > 0:
            return False
        return True

    def _fam_consolidate(
        self, preps, uniq, found, params: SearchParameters
    ) -> List[List[Match]]:
        """find_all_matches phase 3: attach looked-up variants to segments,
        apply the redundancy filter, consolidate sequences per hard batch."""
        from ..search import redundant_match, remap_offsets_to_unicodepoints

        if self._fam_fast_ok(found, params):
            return self._fam_consolidate_fast(preps, uniq, found, params)

        results: List[List[Match]] = []
        for prep in preps:
            if prep is None:
                results.append([])
                continue
            text, hard_batches, per_order = prep
            batch_matches: List[List[Match]] = [[] for _ in hard_batches]
            for order_idx, pending in enumerate(per_order):
                for bi, seg in pending:
                    if order_idx == 0 or not redundant_match(
                        seg, batch_matches[bi]
                    ):
                        # shared, not copied: Match.variants is read-only
                        # everywhere downstream (selection writes
                        # Match.selected, never the list)
                        seg.variants = found[uniq[seg.text]]
                    batch_matches[bi].append(seg)

            matches: List[Match] = []
            for bi, (bbegin, bend, bslice, btext) in enumerate(hard_batches):
                bmatches = batch_matches[bi]
                if params.max_ngram > 1 or self.have_lm or self.context_rules:
                    matches.extend(
                        self.most_likely_sequence(
                            bmatches, bslice, bbegin, bend, params, btext
                        )
                    )
                else:
                    for m in bmatches:
                        m.selected = 0
                        matches.append(m)

            if params.unicodeoffsets:
                matches = remap_offsets_to_unicodepoints(text, matches)
            results.append(matches)
        return results

    def _fam_consolidate_fast(
        self, preps, uniq, found, params: SearchParameters
    ) -> List[List[Match]]:
        """Array-native consolidation for the common search case.

        Equivalent to :meth:`_fam_consolidate` + :meth:`most_likely_sequence`
        when the decode is pure argmin path cost (nbest=1, no LM scoring, no
        context rules — the `_best_path` route): every hard batch of every
        text becomes one chain in a flat arc array, the Viterbi DP runs
        lockstep across ALL chains in ~max_states numpy steps (first-minimum
        tie-break in (source state, creation order) — the in_arcs order of
        the object path), and Match/VariantResult objects materialize only
        for the best-path output. Equivalence with the object path is pinned
        by tests/test_search.py.
        """
        from ..search import remap_offsets_to_unicodepoints

        fw = params.freq_weight
        ds = found.ds
        if fw > 0.0:
            score_all = (ds + fw * found.fq) / (1.0 + fw)
        else:
            score_all = ds.astype(np.float64, copy=False)
        # sentinel slot: OOV arcs price as score 0 (cost n+1); override
        # segments (rare) append their object scores behind it
        extra_scores: List[float] = []
        extra_base = len(score_all) + 1
        consolidate = (
            params.max_ngram > 1 or self.have_lm or bool(self.context_rules)
        )

        row_of = found.row_of.tolist()  # input -> survivor row (-1: override)
        sbounds = found.sbounds
        n_sv = len(ds)
        # per-row redundancy predicate, vectorized once: non-empty survivor
        # set whose top dist_score is a perfect 1.0 (search.rs:317-336)
        row_lo = sbounds[:-1]
        if n_sv:
            perfect_row = (
                (sbounds[1:] > row_lo)
                & (ds[np.minimum(row_lo, n_sv - 1)] >= 1.0)
            ).tolist()
        else:
            perfect_row = [False] * len(row_lo)

        def top_perfect(q: int) -> bool:
            row = row_of[q]
            if row >= 0:
                return perfect_row[row]
            lst = found[q]
            return bool(lst) and lst[0].dist_score >= 1.0

        def redundant_fast(cand, bmatches) -> bool:
            # search.redundant_match over qidx/arrays (search.rs:317-336)
            for ref in bmatches:
                if ref.n != 1:
                    break  # unigrams are at the beginning of the vector
                if (
                    ref.offset.begin >= cand.offset.begin
                    and ref.offset.end <= cand.offset.end
                ):
                    if ref.qidx is None or not top_perfect(ref.qidx):
                        return False
            return True

        # ---- phase A: attach + redundancy filter + arc-group collection ----
        all_matches: List[Match] = []  # global match registry (arc targets)
        # variant/OOV arc groups, in creation order (one row per match):
        # (chain, src, tgt, score_lo, k, n_span, match, is_oov)
        groups: List[Tuple[int, int, int, int, int, int, int, bool]] = []
        # epsilon failsafe arcs (created after all match arcs, lib.rs:2265)
        e_chain: List[int] = []
        e_src: List[int] = []
        e_tgt: List[int] = []
        chain_states: List[int] = []  # nstates per chain
        chain_finals: List[List[int]] = []
        chain_narcs: List[int] = []  # non-eps arc count (quirk detection)
        chain_bmatches: List[List[Match]] = []
        # per text: list of ("dp", chain_id) | ("direct", matches)
        text_plans: List[Optional[Tuple[str, List]]] = []

        for prep in preps:
            if prep is None:
                text_plans.append(None)
                continue
            text, hard_batches, per_order = prep
            batch_matches: List[List[Match]] = [[] for _ in hard_batches]
            for order_idx, pending in enumerate(per_order):
                for bi, seg in pending:
                    if order_idx == 0 or redundant_fast(
                        seg, batch_matches[bi]
                    ) is False:
                        seg.qidx = uniq[seg.text]
                    batch_matches[bi].append(seg)

            plan: List = []
            for bi, (bbegin, bend, bslice, _btext) in enumerate(hard_batches):
                bmatches = batch_matches[bi]
                if not consolidate:
                    for m in bmatches:
                        if m.qidx is not None:
                            m.variants = found[m.qidx]
                        m.selected = 0
                    plan.append(("direct", bmatches))
                    continue
                cid = len(chain_states)
                nstates = len(bslice) + 1
                finals = [
                    i + 1
                    for i, b in enumerate(bslice)
                    if b.offset.begin == bend or b.offset.end == bend
                ]
                if not finals:
                    raise RuntimeError("no final state found")
                # boundary offsets are strictly increasing, so the last-match
                # -wins scan of the object path is an exact dict lookup
                end_at = {b.offset.end: i for i, b in enumerate(bslice)}
                begin_at = {b.offset.begin: i for i, b in enumerate(bslice)}
                narcs = 0
                for m in bmatches:
                    nextb = begin_at.get(m.offset.end)
                    if nextb is None:
                        continue
                    prevb = end_at.get(m.offset.begin)
                    if prevb is not None:
                        n_span = nextb - prevb
                        prevstate = prevb + 1
                    else:
                        n_span = nextb + 1
                        prevstate = 0
                    q = m.qidx
                    k = 0
                    lo = 0
                    if q is not None:
                        row = row_of[q]
                        if row >= 0:
                            lo = int(sbounds[row])
                            k = int(sbounds[row + 1]) - lo
                        else:  # override row (rare): object scores
                            objlist = found[q]
                            k = len(objlist)
                            lo = extra_base + len(extra_scores)
                            extra_scores.extend(r.score(fw) for r in objlist)
                    if k > 0:
                        groups.append(
                            (cid, prevstate, nextb + 1, lo, k, n_span,
                             len(all_matches), False)
                        )
                        all_matches.append(m)
                        narcs += k
                    elif n_span == 1:  # out-of-vocabulary unigram
                        groups.append(
                            (cid, prevstate, nextb + 1, len(score_all), 1,
                             n_span, len(all_matches), True)
                        )
                        all_matches.append(m)
                        narcs += 1
                for i in range(len(bslice)):
                    e_chain.append(cid)
                    e_src.append(0 if i == 0 else i)
                    e_tgt.append(i + 1)
                chain_states.append(nstates)
                chain_finals.append(finals)
                chain_narcs.append(narcs)
                chain_bmatches.append(bmatches)
                plan.append(("dp", cid))
            text_plans.append((text, plan))

        # ---- phase B: arc expansion + lockstep Viterbi over all chains ----
        chain_out: List[List[Match]] = []
        if chain_states:
            scores_cat = np.concatenate(
                [score_all, np.zeros(1), np.asarray(extra_scores, np.float64)]
            )
            if groups:
                (g_chain, g_src, g_tgt, g_lo, g_k, g_n, g_match, g_oov) = (
                    np.asarray(col) for col in zip(*groups)
                )
            else:
                g_chain = g_src = g_tgt = g_lo = g_k = g_n = g_match = (
                    np.zeros(0, np.int64)
                )
                g_oov = np.zeros(0, bool)
            gk = g_k.astype(np.int64)
            tot = int(gk.sum())
            offs = (
                np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(gk) - gk, gk)
            )
            a_chain = np.repeat(g_chain.astype(np.int64), gk)
            a_src = np.repeat(g_src.astype(np.int64), gk)
            a_tgt = np.repeat(g_tgt.astype(np.int64), gk)
            a_cost = (
                np.repeat(g_n.astype(np.float64) + 1.0, gk)
                - scores_cat[np.repeat(g_lo.astype(np.int64), gk) + offs]
            )
            a_match = np.repeat(g_match.astype(np.int64), gk)
            a_vidx = np.where(np.repeat(g_oov, gk), -1, offs).astype(np.int64)
            ne = len(e_chain)
            a_chain = np.concatenate([a_chain, np.asarray(e_chain, np.int64)])
            a_src = np.concatenate([a_src, np.asarray(e_src, np.int64)])
            a_tgt = np.concatenate([a_tgt, np.asarray(e_tgt, np.int64)])
            a_cost = np.concatenate([a_cost, np.full(ne, 100.0)])
            a_match = np.concatenate([a_match, np.full(ne, -1, np.int64)])
            a_vidx = np.concatenate([a_vidx, np.full(ne, -2, np.int64)])
            a_serial = np.arange(len(a_chain), dtype=np.int64)

            nchains = len(chain_states)
            smax = max(chain_states)
            v = np.full((nchains, smax), np.inf)
            v[:, 0] = 0.0
            back = np.full((nchains, smax), -1, dtype=np.int64)
            bytgt = np.argsort(a_tgt, kind="stable")
            s_tgt = a_tgt[bytgt]
            starts = np.searchsorted(s_tgt, np.arange(smax + 1))
            s_chain = a_chain[bytgt]
            s_src = a_src[bytgt]
            s_cost = a_cost[bytgt]
            s_serial = a_serial[bytgt]
            for t in range(1, smax):
                lo_, hi_ = int(starts[t]), int(starts[t + 1])
                if lo_ == hi_:
                    continue
                ch = s_chain[lo_:hi_]
                src = s_src[lo_:hi_]
                cand = v[ch, src] + s_cost[lo_:hi_]
                # first strict minimum in in_arcs order == min by
                # (cost, src, creation serial), matching _best_path
                order = np.lexsort((s_serial[lo_:hi_], src, cand, ch))
                chs = ch[order]
                firsts = np.ones(chs.size, bool)
                firsts[1:] = chs[1:] != chs[:-1]
                sel = order[firsts]
                win = ch[sel]
                v[win, t] = cand[sel]
                back[win, t] = s_serial[lo_:hi_][sel]

            for cid in range(nchains):
                bmatches = chain_bmatches[cid]
                if chain_narcs[cid] == 0:
                    # no symbols at all: the object path returns the raw
                    # match list untouched (most_likely_sequence early-out);
                    # redundancy-filtered segments keep variants None there
                    for m in bmatches:
                        if m.variants is None and m.qidx is not None:
                            m.variants = found[m.qidx]
                    chain_out.append(bmatches)
                    continue
                best_cost = np.inf
                best_state = -1
                for s in sorted(chain_finals[cid]):
                    c = v[cid, s]
                    if c < best_cost:
                        best_cost = c
                        best_state = s
                if best_state < 0 or not np.isfinite(best_cost):
                    chain_out.append([])  # unreachable (cannot happen: eps)
                    continue
                path: List[int] = []
                state = best_state
                while state > 0:
                    aid = int(back[cid, state])
                    if a_vidx[aid] != -2:
                        path.append(aid)
                    state = int(a_src[aid])
                path.reverse()
                out: List[Match] = []
                for aid in path:
                    m = all_matches[int(a_match[aid])].shallow_copy()
                    vx = int(a_vidx[aid])
                    m.selected = vx if vx >= 0 else None
                    if m.qidx is not None:
                        m.variants = found[m.qidx]
                    out.append(m)
                chain_out.append(out)

        # ---- phase C: reassemble per text ----
        results: List[List[Match]] = []
        for tp in text_plans:
            if tp is None:
                results.append([])
                continue
            text, plan = tp
            matches: List[Match] = []
            for kind, payload in plan:
                if kind == "dp":
                    matches.extend(chain_out[payload])
                else:
                    matches.extend(payload)
            if params.unicodeoffsets:
                matches = remap_offsets_to_unicodepoints(text, matches)
            results.append(matches)
        return results

    # ------------------------------------------------------------------
    # Sequence consolidation (lib.rs:2087-2495) — lattice n-best decoding
    # ------------------------------------------------------------------

    @staticmethod
    def _best_path(nstates, in_arcs, final_states):
        """Scalar Viterbi fast path (the common no-LM/no-rules case, ~4x
        cheaper than the per-state numpy n-best arrays of
        :meth:`_nbest_paths`): strict ``<`` keeps the first minimum in
        enumeration order — the same tie-break as the stable argsort there
        (equivalence fuzzed in tests/test_search.py)."""
        inf = float("inf")
        v_cost = [0.0] + [inf] * (nstates - 1)
        v_src = [-1] * nstates
        v_sym = [-1] * nstates
        for state in range(1, nstates):
            best = inf
            bsrc = -1
            bsym = -1
            for src, cost, symbol in in_arcs[state]:
                c = v_cost[src] + cost
                if c < best:
                    best = c
                    bsrc = src
                    bsym = -1 if symbol is None else symbol
            v_cost[state] = best
            v_src[state] = bsrc
            v_sym[state] = bsym
        fbest = min((v_cost[s], s) for s in sorted(final_states))
        if fbest[0] == inf:  # no reachable final state
            return []
        state = fbest[1]
        syms: List[int] = []
        while state > 0:
            if v_sym[state] >= 0:
                syms.append(v_sym[state])
            state = v_src[state]
        syms.reverse()
        return [(fbest[0], tuple(syms))]

    @staticmethod
    def _nbest_paths(nstates, in_arcs, final_states, nbest):
        """Exact n-best paths as [(cost, symbol-tuple)] best-first (the
        array form below avoids the tuple round trip on the hot path)."""
        res = VariantModel._nbest_paths_arrays(
            nstates, in_arcs, final_states, nbest
        )
        if not res[0]:
            return []
        costs, syms_all, bounds = res
        syms_l = syms_all.tolist()
        return [
            (cost, tuple(syms_l[bounds[k] : bounds[k + 1]]))
            for k, cost in enumerate(costs)
        ]

    @staticmethod
    def _nbest_paths_arrays(nstates, in_arcs, final_states, nbest):
        """Exact n-best paths over the topologically ordered lattice DAG.

        Per-state hypothesis arrays, each sorted by (cost, construction
        order); the construction order reproduces the reference n-best's
        deterministic tie-break (arcs enumerated source-hyp-major, and a
        hyp created at a lower state always precedes one at a higher state).
        Returns [(cost, symbol-tuple)] best-first.
        """
        hyp_cost: List[np.ndarray] = [np.zeros(1)] * nstates
        hyp_src: List[np.ndarray] = [np.full(1, -1, np.int32)] * nstates
        hyp_shidx: List[np.ndarray] = [np.full(1, -1, np.int32)] * nstates
        hyp_sym: List[np.ndarray] = [np.full(1, -1, np.int32)] * nstates
        hyp_n = [0] * nstates
        hyp_n[0] = 1
        for state in range(1, nstates):
            parts_c, parts_s, parts_h, parts_y = [], [], [], []
            for src, cost, symbol in in_arcs[state]:
                n = hyp_n[src]
                if n == 0:
                    continue
                parts_c.append(hyp_cost[src][:n] + cost)
                parts_s.append(np.full(n, src, np.int32))
                parts_h.append(np.arange(n, dtype=np.int32))
                parts_y.append(
                    np.full(n, -1 if symbol is None else symbol, np.int32)
                )
            if not parts_c:
                hyp_n[state] = 0
                continue
            ec = np.concatenate(parts_c)
            # stable sort on cost == sort by (cost, serial): the concatenated
            # order IS the serial enumeration order
            order = np.argsort(ec, kind="stable")[:nbest]
            hyp_cost[state] = ec[order]
            hyp_src[state] = np.concatenate(parts_s)[order]
            hyp_shidx[state] = np.concatenate(parts_h)[order]
            hyp_sym[state] = np.concatenate(parts_y)[order]
            hyp_n[state] = len(order)

        # collect final hypotheses; ties break by (state, hidx), which equals
        # the global serial order (see above)
        collected_refs: List[Tuple[float, int, int]] = []
        for state in sorted(final_states):
            for hidx in range(hyp_n[state]):
                collected_refs.append(
                    (float(hyp_cost[state][hidx]), state, hidx)
                )
        collected_refs.sort(key=lambda x: (x[0], x[1], x[2]))
        collected_refs = collected_refs[:nbest]

        if not collected_refs:
            return [], np.zeros(0, np.int64), np.zeros(1, np.int64)
        # lockstep reconstruction: flatten the per-state hypothesis arrays
        # once, then walk ALL collected paths in parallel (the scalar
        # per-hypothesis walk dominated LM-mode consolidation)
        off = np.zeros(nstates + 1, np.int64)
        np.cumsum(np.asarray(hyp_n, np.int64), out=off[1:])
        flat_src = np.concatenate(
            [hyp_src[s][: hyp_n[s]] for s in range(nstates)]
        ).astype(np.int64)
        flat_shidx = np.concatenate(
            [hyp_shidx[s][: hyp_n[s]] for s in range(nstates)]
        ).astype(np.int64)
        flat_sym = np.concatenate(
            [hyp_sym[s][: hyp_n[s]] for s in range(nstates)]
        ).astype(np.int64)
        n_col = len(collected_refs)
        cur_state = np.fromiter(
            (s for _, s, _ in collected_refs), np.int64, count=n_col
        )
        cur_hidx = np.fromiter(
            (h for _, _, h in collected_refs), np.int64, count=n_col
        )
        act = np.arange(n_col)
        r_k: List[np.ndarray] = []
        r_sym: List[np.ndarray] = []
        r_round: List[np.ndarray] = []
        rnd = 0
        while len(act):
            idx = off[cur_state[act]] + cur_hidx[act]
            r_k.append(act)
            r_sym.append(flat_sym[idx])
            r_round.append(np.full(len(act), rnd, np.int64))
            cur_state[act] = flat_src[idx]
            cur_hidx[act] = flat_shidx[idx]
            keep = cur_state[act] >= 0
            act = act[keep]
            rnd += 1
        ks = np.concatenate(r_k)
        syms_all = np.concatenate(r_sym)
        rounds = np.concatenate(r_round)
        real = syms_all >= 0
        ks, syms_all, rounds = ks[real], syms_all[real], rounds[real]
        # forward order per hypothesis = descending round
        order = np.lexsort((-rounds, ks))
        ks = ks[order]
        syms_all = syms_all[order]
        counts = np.bincount(ks, minlength=n_col)
        bounds = np.zeros(n_col + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        return [c for c, _, _ in collected_refs], syms_all, bounds

    def most_likely_sequence(
        self,
        matches: List[Match],
        boundaries: Sequence[Match],
        begin_offset: int,
        end_offset: int,
        params: SearchParameters,
        input_text: str,
    ) -> List[Match]:
        """Find the best-scoring segmentation of a hard-boundary batch.

        The reference builds a rustfst VectorFst and runs n-shortest-paths
        (lib.rs:2104-2317). The lattice here is the same graph — states are
        the start plus one per boundary, arcs are (match, variant) transitions
        with cost ``n + (1 - score)``, OOV unigram arcs with cost ``n + 1``,
        and epsilon failsafe arcs with cost 100 — but decoded with an exact
        n-best dynamic program over the DAG (states are topologically ordered
        by construction), which needs no FST library.
        """
        nstates = len(boundaries) + 1  # 0 = start, i+1 = boundary i
        final_states = set()
        for i, boundary in enumerate(boundaries):
            if (
                boundary.offset.begin == end_offset
                or boundary.offset.end == end_offset
            ):
                final_states.add(i + 1)
        if not final_states:
            raise RuntimeError("no final state found")

        # symbols as parallel columns (an OutputSymbol object per (match,
        # variant) pair dominated LM-mode consolidation); entry 0 is the
        # reference's dummy symbol
        sym_vid: List[VocabId] = [0]
        sym_match: List[int] = [0]
        sym_vidx: List[Optional[int]] = [None]
        sym_bidx: List[int] = [0]
        arcs: List[List[Tuple[int, float, Optional[int]]]] = [
            [] for _ in range(nstates)
        ]  # source -> [(target, cost, symbol index or None)]

        for match_index, m in enumerate(matches):
            prevboundary: Optional[int] = None
            nextboundary: Optional[int] = None
            for i, boundary in enumerate(boundaries):
                if m.offset.begin == boundary.offset.end:
                    prevboundary = i
                elif m.offset.end == boundary.offset.begin:
                    nextboundary = i
            if nextboundary is None:
                continue
            if prevboundary is not None:
                n = nextboundary - prevboundary
                prevstate = prevboundary + 1
            else:
                n = nextboundary + 1
                prevstate = 0
            nextstate = nextboundary + 1

            if m.variants:
                for variant_index, variantresult in enumerate(m.variants):
                    symbol = len(sym_vid)
                    sym_vid.append(variantresult.vocab_id)
                    sym_match.append(match_index)
                    sym_vidx.append(variant_index)
                    sym_bidx.append(nextboundary)
                    cost = n + (1.0 - variantresult.score(params.freq_weight))
                    arcs[prevstate].append((nextstate, cost, symbol))
            elif n == 1:
                # out-of-vocabulary unigram, copied from input
                symbol = len(sym_vid)
                sym_vid.append(0)
                sym_match.append(match_index)
                sym_vidx.append(None)
                sym_bidx.append(nextboundary)
                arcs[prevstate].append((nextstate, float(n + 1), symbol))

        # epsilon failsafe arcs (lib.rs:2265-2276)
        for i in range(len(boundaries)):
            prevstate = 0 if i == 0 else i
            arcs[prevstate].append((i + 1, 100.0, None))

        if len(sym_vid) == 1:
            return matches

        if self.debug >= 3:
            from ..search import OutputSymbol

            output_symbols = [
                OutputSymbol(
                    vocab_id=v, symbol=k, match_index=mi,
                    variant_index=vx, boundary_index=bi,
                )
                for k, (v, mi, vx, bi) in enumerate(
                    zip(sym_vid, sym_match, sym_vidx, sym_bidx)
                )
            ]
            self._dump_lattice_dot(
                input_text, arcs, final_states, output_symbols, matches
            )

        # exact n-best DP over the topologically ordered DAG.
        # When neither the LM nor context rules participate, the final
        # selection reduces to argmin path cost (the normalized variant score
        # is monotone in cost, lib.rs:2399-2403), so n-best collapses to 1.
        use_lm = self.have_lm and params.lm_weight > 0
        use_rules = bool(self.context_rules) and params.contextrules_weight > 0
        nbest = max(1, params.max_seq) if (use_lm or use_rules) else 1

        in_arcs: List[List[Tuple[int, float, Optional[int]]]] = [
            [] for _ in range(nstates)
        ]
        for state in range(nstates):
            for target, cost, symbol in arcs[state]:
                in_arcs[target].append((state, cost, symbol))

        if nbest == 1:
            bp = self._best_path(nstates, in_arcs, final_states)
            costs = [c for c, _ in bp]
            syms_concat = np.asarray(
                [s for _, ss in bp for s in ss], np.int64
            )
            bounds = np.zeros(len(bp) + 1, np.int64)
            if bp:
                np.cumsum([len(ss) for _, ss in bp], out=bounds[1:])
        else:
            costs, syms_concat, bounds = self._nbest_paths_arrays(
                nstates, in_arcs, final_states, nbest
            )

        # hypotheses as parallel columns (a SequenceHyp object per
        # hypothesis dominated LM-mode consolidation at max_seq=250)
        nseq = len(costs)
        best_lm_perplexity = 999999.0
        best_variant_cost = (len(boundaries) - 1) * 2.0
        best_context_score = 0.0
        ctx_scores: List[float] = [1.0] * nseq
        tags_of: List[Optional[List]] = [None] * nseq
        perps: List[float] = [0.0] * nseq
        syms_list = syms_concat.tolist()
        for k, cost in enumerate(costs):
            if self.context_rules:
                context_score, sequence_results = self.test_context_rules(
                    [
                        sym_vid[s]
                        for s in syms_list[bounds[k] : bounds[k + 1]]
                    ]
                )
                ctx_scores[k] = context_score
                tags_of[k] = [
                    [(pm.tag, pm.seqnr) for pm in vecpm if pm.tag is not None]
                    for vecpm in sequence_results
                ]
            if cost < best_variant_cost:
                best_variant_cost = cost
            if ctx_scores[k] > best_context_score:
                best_context_score = ctx_scores[k]

        if self.have_lm and params.lm_weight > 0 and nseq:
            # one vectorized LM pass over every kept hypothesis; the token
            # expansion (lm_score, lib.rs:2578-2628) is shared via caches —
            # the same vocab entry or boundary text recurs across hypotheses
            ngram_cache: Dict[int, Optional[Tuple[VocabId, ...]]] = {}
            btail_cache: Dict[int, Optional[List[Optional[VocabId]]]] = {}

            def vid_tokens(vid: int):
                toks = ngram_cache.get(vid, False)
                if toks is False:
                    toks = self.into_ngram(vid, None)
                    ngram_cache[vid] = toks
                return toks

            def boundary_tail(bidx: int):
                tail = btail_cache.get(bidx, False)
                if tail is False:
                    btext = boundaries[bidx].text.strip()
                    if not btext:
                        tail = None
                    else:
                        bvid = self.encoder.get(btext)
                        if bvid is None:
                            tail = [None]
                        else:
                            ng = vid_tokens(bvid)
                            tail = list(ng) if ng is not None else None
                    btail_cache[bidx] = tail
                return tail

            from itertools import chain as _chain

            # per-SYMBOL token groups memoized once: a symbol's expansion
            # (its vocab tokens + its boundary tail) is identical across
            # every hypothesis it appears in
            symtok_cache: Dict[int, Tuple[Optional[VocabId], ...]] = {}

            def sym_tokens(s: int) -> Tuple[Optional[VocabId], ...]:
                t = symtok_cache.get(s)
                if t is None:
                    parts: List[Optional[VocabId]] = []
                    vid = sym_vid[s]
                    if vid == 0:
                        parts.append(None)
                    else:
                        ng = vid_tokens(vid)
                        if ng is not None:
                            parts.extend(ng)
                    tail = boundary_tail(sym_bidx[s])
                    if tail is not None:
                        parts.extend(tail)
                    t = tuple(parts)
                    symtok_cache[s] = t
                return t

            # flat bigram construction over symbol token GROUPS (the
            # expansions are per-symbol constants): sequence-major and
            # left-to-right, the exact accumulation order of the scalar path
            nsym_tot = len(sym_vid)
            group_of = [sym_tokens(s) for s in range(nsym_tot)]
            group_of.append((BOS,))  # virtual start symbol
            group_of.append((EOS,))  # virtual end symbol
            bos_id, eos_id = nsym_tot, nsym_tot + 1
            glen = np.fromiter(
                (len(g) for g in group_of), np.int64, len(group_of)
            )
            glo = np.zeros(len(group_of) + 1, np.int64)
            np.cumsum(glen, out=glo[1:])
            table = np.fromiter(
                _chain.from_iterable(
                    (-1 if t is None else t for t in g) for g in group_of
                ),
                np.int64,
                int(glo[-1]),
            )
            # per-hypothesis symbol streams with virtual BOS/EOS symbols,
            # assembled by scatter (positions not written hold eos_id)
            s_counts = np.diff(bounds)
            seq_tot = s_counts + 2
            seq_starts = np.zeros(nseq + 1, np.int64)
            np.cumsum(seq_tot, out=seq_starts[1:])
            all_syms = np.full(int(seq_starts[-1]), eos_id, np.int64)
            all_syms[seq_starts[:-1]] = bos_id
            if len(syms_concat):
                pos = np.arange(len(syms_concat), dtype=np.int64) + np.repeat(
                    seq_starts[:-1] + 1 - bounds[:-1], s_counts
                )
                all_syms[pos] = syms_concat
            seq_of_sym = np.repeat(np.arange(nseq, dtype=np.int64), seq_tot)
            gl = glen[all_syms]
            tot = int(gl.sum())
            offs = (
                np.arange(tot, dtype=np.int64)
                - np.repeat(np.cumsum(gl) - gl, gl)
            )
            tokens_flat = table[np.repeat(glo[all_syms], gl) + offs]
            tseq = np.repeat(seq_of_sym, gl)
            m_pair = tseq[1:] == tseq[:-1]
            for k, (lm_logprob, perplexity) in enumerate(
                self._lm_score_pairs(
                    tokens_flat[:-1][m_pair],
                    tokens_flat[1:][m_pair],
                    tseq[1:][m_pair],
                    nseq,
                )
            ):
                perps[k] = perplexity
                if perplexity < best_lm_perplexity:
                    best_lm_perplexity = perplexity

        best_score = -99999999.0
        best_k = -1
        use_lm_score = self.have_lm and params.lm_weight > 0
        plain = (not self.have_lm or params.lm_weight == 0.0) and (
            not self.context_rules or params.contextrules_weight == 0.0
        )
        for k in range(nseq):
            if use_lm_score:
                norm_lm_score = math.log(best_lm_perplexity / perps[k])
            else:
                norm_lm_score = 0.0
            # Rust's f64::ln(0.0) is -inf (no panic): a single-boundary hard
            # batch has best_variant_cost == 0, and the reference's
            # (0/cost).ln() scores such sequences -inf (lib.rs:2399-2403);
            # math.log would raise instead, so mirror Rust explicitly
            cost = costs[k]
            if cost <= 0:
                norm_variant_score = 0.0
            elif best_variant_cost <= 0:
                norm_variant_score = float("-inf")
            else:
                norm_variant_score = math.log(best_variant_cost / cost)
            norm_context_score = (
                math.log(ctx_scores[k] / best_context_score)
                if best_context_score > 0 and ctx_scores[k] > 0
                else 0.0
            )
            if plain:
                score = norm_variant_score
            else:
                score = (
                    params.lm_weight * norm_lm_score
                    + params.variantmodel_weight * norm_variant_score
                    + params.contextrules_weight * norm_context_score
                ) / (
                    params.lm_weight
                    + params.variantmodel_weight
                    + params.contextrules_weight
                )
            if score > best_score or best_k < 0:
                best_score = score
                best_k = k

        assert best_k >= 0
        out: List[Match] = []
        best_tags = tags_of[best_k]
        for i, s in enumerate(syms_list[bounds[best_k] : bounds[best_k + 1]]):
            m = matches[sym_match[s]].shallow_copy()
            m.selected = sym_vidx[s]
            if best_tags:
                if i < len(best_tags):
                    tags = best_tags[i]
                    m.tag = [t for t, _ in tags]
                    m.seqnr = [sq for _, sq in tags]
            out.append(m)
        return out

    def _dump_lattice_dot(
        self, input_text, arcs, final_states, output_symbols, matches
    ) -> None:
        """Render the decoding lattice to Graphviz, mirroring the reference's
        FST drawing at debug>=3 (lib.rs:2296-2312)."""
        safe = "".join(
            c if c.isalnum() else "_" for c in input_text.replace(" ", "_")
        )[:60]
        path = f"/tmp/analiticcl.{safe}.lattice.dot"
        try:
            with open(path, "w", encoding="utf-8") as f:
                f.write(f'digraph lattice {{\n  label="{input_text}";\n')
                for state, out in enumerate(arcs):
                    shape = (
                        "doublecircle" if state in final_states else "circle"
                    )
                    f.write(f'  s{state} [shape={shape}];\n')
                    for target, cost, symbol in out:
                        if symbol is None:
                            label = f"<eps>/{cost}"
                        else:
                            osym = output_symbols[symbol]
                            if osym.vocab_id:
                                text = self.decoder[osym.vocab_id].text
                            else:
                                text = matches[osym.match_index].text + " (OOV)"
                            label = f"{text}/{cost:.3f}"
                        f.write(
                            f'  s{state} -> s{target} [label="{label}"];\n'
                        )
                f.write("}\n")
            print(f"(lattice rendered to {path})", file=sys.stderr)
        except OSError:
            pass

    def decompose_anavalue(self, av: int) -> List[str]:
        """Decompose an anagram value into its characters (lib.rs:345-360)."""
        from ..anahash import anavalue_to_counts

        counts = anavalue_to_counts(av, self.alphabet_size())
        out: List[str] = []
        for idx in np.nonzero(counts)[0]:
            if idx < len(self.alphabet):
                out.extend([self.alphabet[idx][0]] * int(counts[idx]))
        return out

    # ------------------------------------------------------------------
    # Learn mode (lib.rs:1029-1139)
    # ------------------------------------------------------------------

    def find_variants_for_learning(
        self, inputstr: str, params: SearchParameters, strict: bool
    ) -> List[Tuple[str, VariantResult]]:
        if strict:
            return [(inputstr, r) for r in self.find_variants(inputstr, params)]
        out = []
        for m in self.find_all_matches(inputstr, params):
            solution = m.solution()
            if solution is not None:
                out.append((m.text, solution))
        return out

    def learn_variants(
        self,
        inputs: Sequence[str],
        params: SearchParameters,
        strict: bool = False,
        auto_build: bool = True,
    ) -> int:
        """Bootstrap weighted variants from a corpus (lib.rs:1062-1139).

        Batched lookup replaces rayon parallelism; the merge phase is
        sequential, as in the reference.
        """
        vocabparams = VocabParams().with_vocab_type(VocabType.TRANSPARENT).with_freq_handling(
            FrequencyHandling.MAX
        )

        def triples():
            """(input, ref vocab id, dist score) stream; strict mode reads
            survivor arrays directly (no VariantResult objects at all)."""
            inputs_list = list(inputs)
            if not strict:
                # one combined lookup batch across the whole corpus slice
                # instead of a device round trip per line (lib.rs:1040-1056)
                for matches in self.find_all_matches_batch(
                    inputs_list, params
                ):
                    for m in matches:
                        solution = m.solution()
                        if solution is not None:
                            yield m.text, solution.vocab_id, solution.dist_score
                return
            backend = self._backend
            if backend == "auto":
                backend = (
                    "device"
                    if (self.index and self.index.size >= 64)
                    else "oracle"
                )
            if backend != "device":
                for inputstr in inputs_list:
                    for r in self.find_variants(inputstr, params):
                        yield inputstr, r.vocab_id, r.dist_score
                return
            from ..ops.pipeline import RankedResults, get_device_pipeline

            if self._device is None:
                self._device = get_device_pipeline(self)
            pipe = self._device
            bs = min(4096, pipe.max_B)
            batches = [
                inputs_list[s : s + bs]
                for s in range(0, len(inputs_list), bs)
            ]
            for batch, rr in zip(
                batches,
                pipe.find_variants_stream(batches, params, ranked=True),
            ):
                if isinstance(rr, RankedResults):
                    vidl = rr.vid.tolist()
                    dsl = rr.ds.tolist()
                    sbl = rr.sbounds.tolist()
                    rowl = rr.row_of.tolist()
                    ov = rr.overrides
                    for i, inputstr in enumerate(batch):
                        o = ov.get(i)
                        if o is not None:
                            for r in o:
                                yield inputstr, r.vocab_id, r.dist_score
                            continue
                        row = rowl[i]
                        if row < 0:
                            continue
                        for k in range(sbl[row], sbl[row + 1]):
                            yield inputstr, vidl[k], dsl[k]
                else:  # eager lists (fallback paths)
                    for inputstr, res in zip(batch, rr):
                        for r in res:
                            yield inputstr, r.vocab_id, r.dist_score

        # Merge phase: same per-item semantics as the reference's serial
        # merge (lib.rs:1098-1126) — first-mention-wins links, frequency
        # increment on first consecutive occurrence — but link dedup runs
        # against per-entry SETS built once per touched entry instead of
        # re-scanning the variants list per pair (the list scan made popular
        # reference entries quadratic: ~0.5 s per 20k learned variants).
        count = 0
        prev: Optional[str] = None
        encoder_get = self.encoder.get
        decoder = self.decoder
        ref_for: Dict[int, set] = {}  # ref_id -> {variant ids linked}
        var_of: Dict[int, set] = {}  # variant id -> {vocab ids in VARIANT_OF checks}
        REF_FOR = VariantReferenceKind.REFERENCE_FOR
        VAR_OF = VariantReferenceKind.VARIANT_OF
        # phase attribution: generator-internal time (batched lookups, device
        # waits) vs merge-loop time vs the auto_build rebuild, recorded in
        # ``self.learn_profile`` so learn-rate regressions are diagnosable
        # from the artifact (see benchmarks/suite.py learn_1m)
        import time as _time

        _t_lookup = 0.0
        _t_merge_start = _time.perf_counter()

        def _timed_triples():
            nonlocal _t_lookup
            gen = triples()
            while True:
                t0 = _time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    _t_lookup += _time.perf_counter() - t0
                    return
                _t_lookup += _time.perf_counter() - t0
                yield item

        # Incremental-rebuild eligibility, tracked while merging. The learn
        # vocabparams give new entries VocabType.TRANSPARENT with NO INDEXED
        # or LM bit (with_vocab_type REPLACES, mirroring lib.rs:1077), so a
        # learn iteration can only (a) append non-indexed entries and
        # (b) bump frequencies of existing entries. Unless a bumped entry is
        # LM-typed (its frequency feeds the LM tables) or an index-relevant
        # structural change happened elsewhere, the post-learn build()
        # would reproduce the SAME (anavalue, vid) index with only the freqs
        # column changed — so auto_build degrades to a freqs refresh plus an
        # in-place device column update (full 1M rebuild: ~6 s; refresh:
        # ~0.3 s — the learn_1m wall is otherwise rebuild-dominated).
        lm_flag = int(VocabType.LM)
        indexed_flag = int(VocabType.INDEXED)
        structural = self.index is None
        bumped: set = set()  # vids whose frequency changed
        n_decoder_before = len(decoder)

        for inputstr, ref_id, dist_score in _timed_triples():
            vocab_id = encoder_get(inputstr)
            if vocab_id is not None:
                if prev != inputstr:
                    decoder[vocab_id].frequency += 1
                    bumped.add(vocab_id)
                    if decoder[vocab_id].vocabtype.value & lm_flag:
                        structural = True
            else:
                vocab_id = self.add_to_vocabulary(inputstr, 1, vocabparams)
                if vocab_id < n_decoder_before:
                    bumped.add(vocab_id)  # reused an existing entry
                if vocab_id < len(decoder) and (
                    decoder[vocab_id].vocabtype.value & (indexed_flag | lm_flag)
                ):
                    structural = True
            if ref_id != vocab_id:
                # inlined add_variant_by_id with cached dedup sets
                # (add_variant_by_id returns True whenever the ids differ)
                refitem = decoder[ref_id] if ref_id < len(decoder) else None
                if refitem is not None:
                    seen = ref_for.get(ref_id)
                    if seen is None:
                        seen = {
                            v.vocab_id
                            for v in (refitem.variants or [])
                            if v.kind is REF_FOR
                        }
                        ref_for[ref_id] = seen
                    if vocab_id not in seen:
                        ref = VariantReference(REF_FOR, vocab_id, dist_score)
                        if refitem.variants is None:
                            refitem.variants = [ref]
                        else:
                            refitem.variants.append(ref)
                        seen.add(vocab_id)
                varitem = decoder[vocab_id] if vocab_id < len(decoder) else None
                if varitem is not None:
                    seen = var_of.get(vocab_id)
                    if seen is None:
                        seen = {
                            v.vocab_id
                            for v in (varitem.variants or [])
                            if v.kind is VAR_OF
                        }
                        var_of[vocab_id] = seen
                    # reference quirk: the VariantOf-side dedup compares
                    # against the VARIANT id, not the reference id
                    # (lib.rs:497-508); mirrored by add_variant_by_id
                    if vocab_id not in seen:
                        ref = VariantReference(VAR_OF, ref_id, dist_score)
                        if varitem.variants is None:
                            varitem.variants = [ref]
                        else:
                            varitem.variants.append(ref)
                        seen.add(ref_id)
                count += 1
            prev = inputstr
        _t_merge = _time.perf_counter() - _t_merge_start - _t_lookup
        _t_build = 0.0
        build_mode = "none"
        if auto_build:
            t0 = _time.perf_counter()
            if structural:
                self.build()
                build_mode = "full"
            else:
                if bumped:
                    self._refresh_index_freqs(bumped)
                build_mode = "freq_refresh" if bumped else "noop"
            _t_build = _time.perf_counter() - t0
        self.learn_profile = {
            "lookup_s": round(_t_lookup, 3),
            "merge_s": round(_t_merge, 3),
            "build_s": round(_t_build, 3),
            "build_mode": build_mode,
        }
        return count

    def _refresh_index_freqs(self, bumped=None) -> None:
        """Refresh the built index's frequency column from the decoder,
        in place, including any live device copy.

        Exactness: equals a full build() when (and only when — callers
        guarantee it) the set of INDEXED texts, the LM entries, and every
        vocabtype are unchanged since the last build: the canonical sort,
        norms, charcounts, first_lower, and group ranges are functions of
        the texts alone, and freqs is the one column read from the decoder
        (build(): ``freqs = dec_freq[vocab_ids]``). With ``bumped`` (the
        vids whose frequency changed), only those rows are written — a few
        thousand scalar stores instead of a 1M-object decoder scan."""
        index = self.index
        if index is None:
            return
        decoder = self.decoder
        if bumped is not None:
            inv = index.vid_to_row()
            n = inv.shape[0]
            freqs = index.freqs
            for vid in bumped:
                if vid < n:
                    row = inv[vid]
                    if row >= 0:
                        freqs[row] = decoder[vid].frequency
        else:
            dec_freq = np.fromiter(
                (v.frequency for v in decoder), dtype=np.float64,
                count=len(decoder),
            )
            index.freqs = dec_freq[index.vocab_ids]
        if self._device is not None:
            refresh = getattr(self._device, "refresh_freqs", None)
            if refresh is not None:
                refresh(index.freqs)
            else:  # pipeline without in-place support: rebuild lazily
                self._device = None

    # ------------------------------------------------------------------
    # Helpers used by search mode & output
    # ------------------------------------------------------------------

    def match_to_vocabvalue(self, m: Match) -> Optional[VocabValue]:
        solution = m.solution()
        if solution is not None:
            return self.get_vocab(solution.vocab_id)
        return None

    def match_to_str(self, m: Match) -> str:
        value = self.match_to_vocabvalue(m)
        return value.text if value is not None else m.text

    def ngram_to_str(self, ngram: Tuple[VocabId, ...]) -> str:
        return " ".join(self.decoder[v].text for v in ngram)

    def match_to_ngram(
        self, m: Match, boundaries: Sequence[Match]
    ) -> Tuple[VocabId, ...]:
        """Convert a match to an ngram of known vocab ids (lib.rs:2794-2813).
        Raises KeyError on out-of-vocabulary tokens."""
        from ..search import find_match_ngrams

        internal = m.internal_boundaries(boundaries)
        parts = find_match_ngrams(m.text, internal, 1, 0, None)
        ngram: List[VocabId] = []
        for part in parts:
            if part.text in self.encoder:
                ngram.append(self.encoder[part.text])
            else:
                raise KeyError(
                    "unable to convert match to ngram, contains "
                    f"out-of-vocabulary token: {part.text}"
                )
        return tuple(ngram)

    def add_to_reverse_index(
        self,
        reverseindex: Dict[VocabId, List[Tuple[object, float]]],
        input_text: str,
        matched_vocab_id: VocabId,
        score: float,
    ) -> None:
        """Reverse-index helper (lib.rs:1759-1787): lexicon item -> observed
        variants, exact matches skipped. Variant is a VocabId when known,
        else the raw string."""
        known = self.encoder.get(input_text)
        if known is not None:
            if known == matched_vocab_id:
                return  # exact match
            variant: object = known
        else:
            variant = input_text
        reverseindex.setdefault(matched_vocab_id, []).append((variant, score))
