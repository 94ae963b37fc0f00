"""The batched device query pipeline: retrieval -> scoring in one fused call.

Device replacement for the reference's per-query hot loops
(find_nearest_anahashes lib.rs:1143-1308, gather_instances lib.rs:1311-1402,
and the scoring half of score_and_rank lib.rs:1405-1503):

Stage A — retrieval. Candidate set = all indexed entries whose count vector is
within L1 distance <= k of the query's. Computed as a *binarized matmul*:
expanding counts into per-(char, threshold) binary planes makes
``sum(min(a, q))`` an inner product, so

    L1(a, q) = cc(a) + cc(q) - 2 * (bin(a) . bin(q))

One [B, A*T] x [A*T, N] int8 matmul scores every query against its charcount
band of the lexicon (ops/stage_a.py). The boolean hit mask is *compacted*
into a flat (query, candidate) pair list (hierarchical: block-count reduce,
tiny cumsum, per-slot radix descent, in-block rank), so downstream DP work is
proportional to the number of real candidates rather than a padded
per-query budget. StopAtExactMatch restricts a query's mask to exact anagram
hits (lib.rs:1158-1174).

Stage B — scoring. Gather each pair's normalized strings, run the banded
DL+LCS DP and the prefix/suffix metrics (ops/dl_triton.py, ops/dl_jax.py),
compute the weighted linear score (lib.rs:1430-1452), and mask by per-query
max edit distance and score threshold. Surviving pairs are compacted again —
in (query, canonical candidate) order, which is exactly the reference's
gather order — and returned to the host, where the exact float64 ranking
tail (sort/crop/cutoff/confusables/variant expansion;
models/variant_model.py) runs on the few survivors.

Both stages execute as ONE jitted call per batch, and all outputs come back
in ONE device_get. Which implementation runs each stage is decided in one
place, :func:`stage_impls`.

Exactness notes:
  * the L1-ball candidate set is exactly the set the reference's deletion BFS
    + insertion sweep visits (see SURVEY.md §7);
  * stage A is an exact integer dot and stage B an integer DP, so every
    implementation of a stage gives identical integers (no float matrix
    product is on the path);
  * device scores are float32 and used only for *pre-filtering*; the host
    recomputes float64 scores from the exact integer metrics. The device
    threshold uses a small slack so float32 rounding cannot drop a candidate
    the float64 threshold would keep;
  * pair-budget overflow is detected on the host (totals are returned) and
    the batch transparently re-runs with the next budget bucket.
"""

from __future__ import annotations

import os
import sys
from functools import partial
from itertools import repeat
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

# Persistent compilation cache. When the environment names a directory
# (JAX_COMPILATION_CACHE_DIR) JAX uses it and nothing is set here; otherwise
# the cache lives at one fixed path inside the checkout — the path is part
# of what a later process must find again, so it never moves.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir(environ=os.environ) -> Optional[str]:
    """The directory this module sets for JAX's compile cache, or None when
    the environment already names one (JAX then reads it itself)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


if compile_cache_dir() is not None:
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from .dl_jax import PAD_A, PAD_B, affix_metrics_aligned, dl_metrics_windowed
from .dl_triton import dl_lcs_triton
from .rank_batch import rank_fast_batch
from .stage_a import (
    ROW_BLOCK,
    _b_tile,
    at_width,
    stage_a_masks_triton,
    stage_a_masks_xla,
)

try:
    from ..utils.native import rank_tail_native as _rank_tail_native
except Exception:  # pragma: no cover - native module always importable
    _rank_tail_native = None
from ..types import (
    Distance,
    MAX_ANAGRAM_DISTANCE as _MAX_ANAGRAM_DISTANCE,
    MAX_EDIT_DISTANCE as _MAX_EDIT_DISTANCE,
    SearchParameters,
    StopCriterion,
    ThresholdKind as _ThresholdKind,
    VariantResult,
)


def stage_b_xla(a, a_len, b, b_len, a_rev, b_rev, max_len: int, window: int):
    """Stage B metrics (ld, lcs, prefix, suffix) through the plain XLA DP,
    mapped over DL_CHUNK-pair slices to bound its [P, L] intermediates."""
    del a_rev, b_rev  # the XLA DP derives the suffix itself
    P = a.shape[0]
    if P <= DL_CHUNK:
        return dl_metrics_windowed(a, a_len, b, b_len, max_len, window)
    n = P // DL_CHUNK
    out = jax.lax.map(
        lambda args: dl_metrics_windowed(*args, max_len, window),
        (
            a.reshape(n, DL_CHUNK, max_len),
            a_len.reshape(n, DL_CHUNK),
            b.reshape(n, DL_CHUNK, max_len),
            b_len.reshape(n, DL_CHUNK),
        ),
    )
    return tuple(x.reshape(P) for x in out)


def stage_b_triton(
    a, a_len, b, b_len, a_rev, b_rev, max_len: int, window: int,
    interpret: bool = False,
):
    """Stage B metrics with the banded DL+LCS Triton kernel; prefix/suffix
    are dense vector ops that XLA fuses."""
    ld, lcs = dl_lcs_triton(a, a_len, b, b_len, max_len, window, interpret)
    pf, sf = affix_metrics_aligned(a, a_len, b, b_len, a_rev, b_rev)
    return ld, lcs, pf, sf


def stage_impls(platform: Optional[str] = None):
    """(stage A, stage B) implementations for ``platform`` (default: JAX's
    default backend). ``cpu`` takes the plain XLA versions, ``gpu`` the
    Pallas kernels through Triton. Any other platform is an error; a kernel
    that fails to compile fails the run rather than falling back."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return stage_a_masks_xla, stage_b_xla
    if platform == "gpu":
        return stage_a_masks_triton, stage_b_triton
    raise RuntimeError(
        f"no stage implementations for platform {platform!r} "
        "(supported: cpu, gpu)"
    )


def on_accelerator() -> bool:
    """True off the CPU, where every fused compile costs seconds: pair
    budgets then start at a size-based estimate and settled budgets persist
    across processes (see DevicePipeline._budgets)."""
    return jax.default_backend() != "cpu"


BIG_L1 = np.int32(1 << 28)
THRESHOLD_SLACK = 1e-4

# static shape buckets
B_BUCKETS = (8, 64, 256, 1024, 2048, 4096, 8192)
B_BASE = 1024  # reference size for scaling per-bucket pair budgets
# candidate-pair budget, capped at 1.5M pairs; past-cap overflows take the
# batch-split path instead (collect -> _collect_split)
P_BUCKETS = (
    2048, 8192, 32768, 131072, 262144, 393216, 524288, 786432, 1048576,
    1572864,
)
P2_BUCKETS = (2048, 16384, 32768, 49152, 65536, 98304, 131072, 262144)  # surviving-pair budget
# DL exactness windows (12 = reference MAX_EDIT_DISTANCE). The W6 mid-tier
# exists for ratio thresholds: len*0.3 puts most natural-language queries at
# k_ed 4-6, and the W6 DP costs a fraction of the W12 one.
WINDOW_BUCKETS = (3, 6, 12)
DL_CHUNK = 16384


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


_BUDGET_HINTS: Optional[dict] = None


def _budget_hint_path():
    import os

    d = jax.config.jax_compilation_cache_dir
    return os.path.join(d, "budget_hints.json") if d else None


def _budget_hints() -> dict:
    """Best-effort cross-process budget hints (see DevicePipeline._budgets)."""
    global _BUDGET_HINTS
    if _BUDGET_HINTS is None:
        _BUDGET_HINTS = {}
        path = _budget_hint_path()
        if path:
            import json

            try:
                with open(path) as f:
                    _BUDGET_HINTS = {
                        k: tuple(v) for k, v in json.load(f).items()
                    }
            except (OSError, ValueError):
                pass
    return _BUDGET_HINTS


def _save_budget_hint(key: str, value: Tuple[int, int]) -> None:
    hints = _budget_hints()
    if hints.get(key) == value:
        return
    hints[key] = value
    path = _budget_hint_path()
    if not path:
        return
    import json
    import os

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({k: list(v) for k, v in hints.items()}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _params_key(params: SearchParameters) -> tuple:
    """Hashable fingerprint of a SearchParameters (oracle-memo key)."""
    import dataclasses

    return dataclasses.astuple(params)


def _resolve_thresholds(threshold, lens: np.ndarray, cap: int) -> np.ndarray:
    """Vectorized DistanceThreshold.resolve (lib.rs:982-1012 semantics)."""
    if threshold.kind is _ThresholdKind.RATIO:
        return np.minimum((lens * threshold.ratio).astype(np.int32), cap)
    if threshold.kind is _ThresholdKind.RATIO_WITH_LIMIT:
        return np.minimum(
            (lens * threshold.ratio).astype(np.int32), threshold.limit
        )
    return np.minimum(threshold.limit, lens // 2).astype(np.int32)


def _radix_gs(m_band: int) -> int:
    """Block-descent radix for a band of ``m_band`` 128-row blocks (static
    per compile; module-level so tests can force the wide-radix paths on
    small CPU fixtures)."""
    return 32 if m_band <= 1024 else (64 if m_band <= 4096 else 128)


def _searchsorted_radix(vals, targets):
    """``searchsorted(vals, targets, side='left')`` for sorted int32 ``vals``.

    ``jnp.searchsorted`` lowers to a log2(n)-iteration while loop of
    DEPENDENT [T]-gathers. This radix form samples group tops (64-ary),
    resolves the group with ONE broadcast compare per level plus one
    contiguous row gather from the reshaped array — 2-3 levels total for the
    sizes here, all streaming vector work.
    """
    GS = 64
    BIGV = jnp.iinfo(jnp.int32).max
    n = vals.shape[0]
    levels = []
    cur = vals
    while cur.shape[0] > GS:
        npad = -(-cur.shape[0] // GS) * GS
        mat = jnp.pad(
            cur, (0, npad - cur.shape[0]), constant_values=BIGV
        ).reshape(-1, GS)
        levels.append(mat)
        cur = mat[:, GS - 1]
    top = jnp.pad(cur, (0, GS - cur.shape[0]), constant_values=BIGV)
    idx = jnp.sum((top[None, :] < targets[:, None]).astype(jnp.int32), axis=1)
    for mat in reversed(levels):
        row = jnp.minimum(idx, mat.shape[0] - 1)
        sl = mat[row]  # [T, GS] contiguous row gather
        j = jnp.sum((sl < targets[:, None]).astype(jnp.int32), axis=1)
        idx = row * GS + j
    return jnp.minimum(idx, n)


def _compact(flat_mask, payload_arrays, P: int, fill_values):
    """Stable compaction: gather payloads of set mask positions into P slots.

    Implemented as cumsum + searchsorted (an inverse-permutation *gather*)
    rather than a scatter (ROADMAP S4 asks whether a scatter is shorter and
    no slower on the GPU).
    """
    csum = jnp.cumsum(flat_mask.astype(jnp.int32))
    n = flat_mask.shape[0]
    # slot p holds the first flat position where csum == p+1
    idx = _searchsorted_radix(csum, jnp.arange(1, P + 1, dtype=jnp.int32))
    valid = idx < n
    idx_safe = jnp.minimum(idx, n - 1)
    outs = []
    for arr, fill in zip(payload_arrays, fill_values):
        fillv = jnp.asarray(fill, dtype=arr.dtype)
        outs.append(jnp.where(valid, arr[idx_safe], fillv))
    return outs


def _rank_fast(
    model,
    vocab_ids: np.ndarray,
    cand_rows: np.ndarray,
    dist_scores: np.ndarray,  # f64, pre-threshold
    freqs: np.ndarray,  # f64 absolute frequencies (or ones)
    params: SearchParameters,
    max_freq_floor: float,
) -> List[VariantResult]:
    """Vectorized ranking tail for the common case (no confusables, no
    expandable variants). Bit-equal to VariantModel.score_and_rank — same
    float64 formulas, stable orders, tie-aware crop quirks, cutoff — just
    numpy instead of Python objects."""
    keep = dist_scores >= params.score_threshold
    if not keep.all():
        cand_rows = cand_rows[keep]
        dist_scores = dist_scores[keep]
        freqs = freqs[keep]
    n = len(cand_rows)
    if n == 0:
        return []
    if model.have_freq:
        max_freq = max(float(freqs.max()), max_freq_floor)
    else:
        max_freq = max(1.0, max_freq_floor)
    freqn = freqs / max_freq if max_freq > 0.0 else freqs

    fw = params.freq_weight
    if fw > 0.0:
        blended = (dist_scores + fw * freqn) / (1.0 + fw)
        order = np.argsort(-blended, kind="stable")
    else:
        # lexsort: last key primary; stable, so full ties keep canonical order
        order = np.lexsort((-freqn, -dist_scores))
    cand_rows = cand_rows[order]
    dist_scores = dist_scores[order]
    freqn = freqn[order]
    s = (
        (dist_scores + fw * freqn) / (1.0 + fw) if fw > 0.0 else dist_scores
    )

    # tie-aware crop at max_matches (lib.rs:1536-1589, incl. the early_cutoff
    # quirk where index 0 doesn't latch)
    mm = params.max_matches
    if 0 < mm < n:
        last_score = s[mm - 1]
        cropped_sc = s[mm]
        if cropped_sc < last_score:
            end = mm
        else:
            lt = dist_scores < cropped_sc
            first_lt = int(np.argmax(lt)) if lt.any() else None
            limit = first_lt if first_lt is not None else n
            eq_idx = np.nonzero(dist_scores[:limit] == cropped_sc)[0]
            if len(eq_idx) and eq_idx[0] != 0:
                early = int(eq_idx[0])
            elif len(eq_idx) > 1:
                early = int(eq_idx[1])
            else:
                early = 0
            late = first_lt if first_lt is not None else 0
            if early > 0:
                end = early + 1
            elif late > 0:
                end = late + 1
            else:
                end = n
        cand_rows = cand_rows[:end]
        dist_scores = dist_scores[:end]
        freqn = freqn[:end]
        s = s[:end]
        n = end

    # cutoff threshold (lib.rs:1597-1622)
    if params.cutoff_threshold >= 1.0 and n > 1:
        below = s[1:] <= s[0] / params.cutoff_threshold
        if below.any():
            cutoff = int(np.argmax(below)) + 1
            cand_rows = cand_rows[:cutoff]
            dist_scores = dist_scores[:cutoff]
            freqn = freqn[:cutoff]
            n = cutoff

    return [
        VariantResult(
            vocab_id=int(vocab_ids[cand_rows[i]]),
            dist_score=float(dist_scores[i]),
            freq_score=float(freqn[i]),
            via=None,
        )
        for i in range(n)
    ]


def _query_core(
    bins,  # int8 [Ni_pad, ATp]: A*T count planes, zero-padded to ATp
    cc,  # int32 [Ni_pad] (padding rows: BIG_L1, so they never match)
    norms2,  # int32 [Ni_pad, 2L]: forward norms | reversed left-aligned norms
    norm_lens,  # int32 [Ni_pad]
    freqs,  # uint32 [Ni_pad] absolute frequencies
    first_lower,  # bool [Ni_pad]
    q_counts,  # int32 [B, A] per-character counts (qbin derived on device)
    q_cc,  # int32 [B]
    q_norms,  # int8/int32 [B, L] (reversed copy derived on device)
    q_lens,  # int32 [B]
    q_first_lower,  # bool [B]
    k_ana,  # int32 [B]
    k_ed,  # int32 [B]
    k_len,  # int32 [B]: min(k_ana, k_ed) — stage-A length-difference cap
    stop_exact,  # bool [B]
    start_blk,  # int32 [B // bt]: per-tile band start block (host-exact)
    weights,  # f32 [6]
    score_threshold,  # f32 scalar
    have_freq: bool,  # STATIC: model has frequencies (gates the segment max)
    T: int,  # STATIC: count planes per character
    P: int,
    P2: int,
    window: int,  # exactness window for DL (>= max per-query edit distance)
    nb_band: int,  # STATIC: band width in ROW_BLOCK blocks (charcount band)
    use_stop_exact: bool = True,  # static: include the StopAtExactMatch filter
    stop_stage: Optional[str] = None,  # profiling: truncate after a stage
):
    def _probe(*arrays):
        """Small checksums standing in for a stage's outputs (profiling)."""
        return tuple(jnp.sum(a.astype(jnp.int32)) for a in arrays)

    B = q_counts.shape[0]
    A = q_counts.shape[1]
    Ni_pad = bins.shape[0]
    L = norms2.shape[1] // 2
    if stop_stage == "noop":
        # profiling floor: dispatch and transfer, no real compute
        return _probe(q_cc, k_ana)

    # derive the device-side query artifacts from the compact uploads:
    # expanding the [B, A*T] binary planes and the reversed norms here cuts
    # the per-batch upload ~4x
    t_levels = jnp.arange(T, dtype=jnp.int32)[None, None, :]
    qbin = (
        (jnp.minimum(q_counts, T)[:, :, None] > t_levels)
        .reshape(B, A * T)
        .astype(jnp.int8)
    )
    qbin = jnp.pad(qbin, ((0, 0), (0, bins.shape[1] - A * T)))
    pos_l = jnp.arange(L, dtype=jnp.int32)[None, :]
    rev_idx = q_lens[:, None] - 1 - pos_l
    q_norms_rev = jnp.where(
        rev_idx >= 0,
        jnp.take_along_axis(q_norms, jnp.maximum(rev_idx, 0), axis=1),
        0,
    ).astype(q_norms.dtype)

    # ---------------- Stage A: banded retrieval ----------------
    # hit/exact masks arrive bit-packed with per-128-block counts in BANDED
    # coordinates (each query tile scans only its charcount band) — never
    # as a materialized [B, Ni] distance matrix
    stage_a, stage_b = stage_impls()
    with jax.named_scope("stage_a"):
        packed_q8, exact_q8, counts_q = stage_a(
            bins, cc, qbin, q_cc, k_ana, k_len, start_blk, nb_band
        )
    nmatch = counts_q.sum(axis=1)
    Ni_band = nb_band * ROW_BLOCK  # band rows per query tile (banded coords)
    total_match = nmatch.sum()
    if stop_stage == "stageA":
        return _probe(packed_q8[:, ::64], exact_q8[:, ::64], counts_q)

    # hierarchical compaction over block counts. Stage-A outputs arrive
    # query-major directly from the kernel; everything below runs in the
    # q-major flat (query, candidate) order the pair list uses.
    #
    # Slot -> (query, block) resolution. The design minimizes gathered
    # [P]-columns: the query is found with a gather-free compare-sum reduction
    # (the [B] cumsum broadcasts and streams), the block with an unrolled
    # log2(M_lex)-step binary search (one column each). Ranking within the
    # 128-candidate block reads ONE contiguous 16-byte slice per slot (the
    # masks are re-laid out q-major and bitcast to u32 words) instead of 16
    # B-strided bytes.
    BLK = 128
    M_band = Ni_band // BLK  # 128-row blocks per band (banded coords)
    targets = jnp.arange(1, P + 1, dtype=jnp.int32)

    qcum = jnp.cumsum(nmatch.astype(jnp.int32))  # [B] inclusive
    # q_of[p] = #{q : qcum[q] < t[p]} == searchsorted(qcum, t, 'left').
    # A flat [P, B] compare-sum costs P*B ops (1.6G at B=4096): use
    # the same radix descent as the block search below — per-level group
    # cumsums, one broadcast compare at the top, then one tiny-table row
    # gather + in-register compare per level. The descent also yields the
    # 1-based within-query rank directly (no qexcl gather).
    GSQ = 64
    laneq = jnp.arange(GSQ, dtype=jnp.int32)[None, :]
    q_tables = []
    cl_q = nmatch.astype(jnp.int32)[None, :]  # [1, B]
    while cl_q.shape[1] > GSQ:
        M = cl_q.shape[1]
        Mp = -(-M // GSQ) * GSQ
        grp = jnp.pad(cl_q, ((0, 0), (0, Mp - M))).reshape(1, Mp // GSQ, GSQ)
        within = jnp.cumsum(grp, axis=2)
        q_tables.append(within.reshape(Mp // GSQ, GSQ))
        cl_q = within[:, :, GSQ - 1]
    top_q = jnp.cumsum(
        jnp.pad(cl_q, ((0, 0), (0, GSQ - cl_q.shape[1]))), axis=1
    )[0]  # [GSQ]
    total_m = qcum[B - 1]
    pvalid_slot = targets <= total_m
    r = targets
    j = jnp.sum((top_q[None, :] < r[:, None]).astype(jnp.int32), axis=1)
    j = jnp.minimum(j, GSQ - 1)
    r = r - jnp.sum(jnp.where(laneq == (j - 1)[:, None], top_q[None, :], 0), axis=1)
    idxq = j
    for tab in reversed(q_tables):
        row_q = jnp.minimum(idxq, tab.shape[0] - 1)
        sl = tab[row_q]  # [P, GSQ] row gather from a tiny table
        j = jnp.sum((sl < r[:, None]).astype(jnp.int32), axis=1)
        j = jnp.minimum(j, GSQ - 1)
        r = r - jnp.sum(jnp.where(laneq == (j - 1)[:, None], sl, 0), axis=1)
        idxq = idxq * GSQ + j
    q_safe = jnp.minimum(idxq, B - 1)
    r_q = r  # 1-based rank within the query
    if stop_stage == "resolve_pre":
        return _probe(q_safe, r_q)

    # Band block within the query: a radix descent instead of a binary
    # search. The binary search costs log2(M_band) DEPENDENT per-element
    # [P]-gathers. Each radix level instead
    # fetches ONE GS-int32 group row per slot — expressed as a ROW gather
    # (major-axis indexing with the minor dim intact), which XLA lowers as a
    # slice fetch per row rather than GS scalar gathers — and resolves the
    # child with in-register compare-sums. The radix GS adapts to the band
    # so the descent stays at TWO dependent row-gathers up to 2M band rows
    # (each level is one more dependent gather); wider rows only grow the
    # cheap in-register compare-sums.
    GS = _radix_gs(M_band)
    tables = []  # level tables: [B * n_groups, GS] within-group incl. cumsums
    counts_l = counts_q
    while counts_l.shape[1] > GS:
        M = counts_l.shape[1]
        Mp = -(-M // GS) * GS
        grp = jnp.pad(counts_l, ((0, 0), (0, Mp - M))).reshape(B, Mp // GS, GS)
        within = jnp.cumsum(grp, axis=2)
        tables.append(within.reshape(B * (Mp // GS), GS))
        counts_l = within[:, :, GS - 1]
    Mtop = counts_l.shape[1]
    top = jnp.cumsum(
        jnp.pad(counts_l, ((0, 0), (0, GS - Mtop))), axis=1
    )  # [B, GS]
    tables.append(top)
    if stop_stage == "resolve_tables":
        return _probe(*(t[::8] for t in tables), packed_q8[:, ::64])

    lane = jnp.arange(GS, dtype=jnp.int32)[None, :]
    idx = jnp.zeros_like(q_safe)
    r = r_q
    for lvl in range(len(tables) - 1, -1, -1):
        tab = tables[lvl]
        n_groups = tab.shape[0] // B
        row = jnp.minimum(q_safe * n_groups + idx, tab.shape[0] - 1)
        sl = tab[row]  # [P, GS] row gather
        j = jnp.sum((sl < r[:, None]).astype(jnp.int32), axis=1)
        j = jnp.minimum(j, GS - 1)
        # prev = sl[j-1] (0 when j == 0), as a masked sum: pure vector ops
        prev = jnp.sum(jnp.where(lane == (j - 1)[:, None], sl, 0), axis=1)
        r = r - prev
        idx = idx * GS + j
    blk_band = jnp.minimum(idx, M_band - 1)
    rank = r  # 1-based rank within the block

    # rank -> candidate within the 128-row block: ONE contiguous 16-byte row
    # gather from the q-major packed mask (consumed as bytes — a u32 bitcast
    # view would force a ~15 MB tile-relayout copy of the whole mask),
    # then in-register popcount prefix sums locate the byte and the bit
    NBPB = BLK // 8  # bytes per block
    packed_rows = packed_q8.reshape(B * M_band, NBPB)
    rid = jnp.minimum(q_safe * M_band + blk_band, B * M_band - 1)
    row_bytes = packed_rows[rid]  # [P, 16] u8 row gather
    blane = jnp.arange(NBPB, dtype=jnp.int32)[None, :]
    pcnt = jax.lax.population_count(row_bytes).astype(jnp.int32)
    within16 = jnp.cumsum(pcnt, axis=1)
    byte_pos = jnp.sum(within16 < rank[:, None], axis=1).astype(jnp.int32)
    byte_pos = jnp.minimum(byte_pos, NBPB - 1)
    base = jnp.sum(
        jnp.where(blane == (byte_pos - 1)[:, None], within16, 0), axis=1
    )
    chosen = jnp.sum(
        jnp.where(blane == byte_pos[:, None], row_bytes.astype(jnp.int32), 0),
        axis=1,
    )
    rank_in_byte = rank - base
    bits8 = (chosen[:, None] >> jnp.arange(8, dtype=jnp.int32)) & 1
    within8 = jnp.cumsum(bits8, axis=1)
    bit_pos = jnp.sum(within8 < rank_in_byte[:, None], axis=1).astype(jnp.int32)
    pos = byte_pos * 8 + bit_pos

    # ---------------- Stage B: scoring ----------------
    # pairs stay as separate (query, candidate) columns — a combined
    # q*Ni_pad+c encoding would overflow int32 past ~2M lexicon rows.
    # pc_band is banded (within the query tile's band window); the global
    # device row adds the tile's band start row.
    pvalid = pvalid_slot
    pq = jnp.where(pvalid, q_safe, B)
    pc_band = blk_band * BLK + pos
    bt_sz = _b_tile(B, Ni_pad)
    band_row0 = start_blk[q_safe // bt_sz] * ROW_BLOCK  # [P] tiny gather
    pc = jnp.where(
        pvalid, jnp.minimum(band_row0 + pc_band, Ni_pad - 1), 0
    )
    if stop_stage == "resolve":
        return _probe(pq, pc)

    # Per-pair gathers are latency-bound (a cost per [P]-column regardless of
    # width): concatenate per-row attributes into ONE table per side first —
    # the dense concat costs microseconds, and each side then pays a single
    # gather instead of three to five. Lens, thresholds, and flags fit the
    # narrow norm dtype whenever L < 127 (k_ed <= 12, lens <= L, flags 0/1).
    pack8 = norms2.dtype == jnp.int8 and L < 127
    tdt = jnp.int8 if pack8 else jnp.int32
    cand_tab = jnp.concatenate(
        [
            norms2,
            norm_lens[:, None].astype(tdt),
            first_lower[:, None].astype(tdt),
        ],
        axis=1,
    )
    cg = cand_tab[pc]  # [P, 2L+2]: the ONLY candidate-side gather (+freqs)
    cn2 = cg[:, : 2 * L].astype(jnp.int32)
    cn = cn2[:, :L]
    cnr = cn2[:, L:]
    cl = jnp.where(pvalid, cg[:, 2 * L].astype(jnp.int32), 0)
    cfl = cg[:, 2 * L + 1].astype(bool)
    if have_freq:
        cf = freqs[pc]

    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    pq_safe = jnp.minimum(pq, B - 1)
    q_tab = jnp.concatenate(
        [
            q_norms.astype(tdt),
            q_norms_rev.astype(tdt),
            q_lens[:, None].astype(tdt),
            k_ed[:, None].astype(tdt),
            q_first_lower[:, None].astype(tdt),
        ],
        axis=1,
    )
    qg = q_tab[pq_safe]  # [P, 2L+3]: the ONLY query-side gather
    qn = qg[:, :L].astype(jnp.int32)
    qnr = qg[:, L : 2 * L].astype(jnp.int32)
    ql = jnp.where(pvalid, qg[:, 2 * L].astype(jnp.int32), 0)
    k_ed_pair = qg[:, 2 * L + 1].astype(jnp.int32)
    q_fl_pair = qg[:, 2 * L + 2].astype(bool)
    a = jnp.where(pos < ql[:, None], qn, PAD_A)
    b = jnp.where(pos < cl[:, None], cn, PAD_B)
    a_rev = jnp.where(pos < ql[:, None], qnr, PAD_A)
    b_rev = jnp.where(pos < cl[:, None], cnr, PAD_B)

    with jax.named_scope("stage_b"):
        ld, lcs, pf, sf = stage_b(a, ql, b, cl, a_rev, b_rev, L, window)

    if stop_stage == "gather_dl":
        return _probe(ld, lcs, pf, sf)

    w_ld, w_lcs, w_pf, w_sf, w_case, w_sum = (
        weights[0], weights[1], weights[2], weights[3], weights[4], weights[5],
    )
    # weight gating mirrors gather_instances (lib.rs:1350-1378)
    lcs = jnp.where(w_lcs > 0, lcs, 0)
    pf = jnp.where(w_pf > 0, pf, 0)
    sf = jnp.where(w_sf > 0, sf, 0)
    samecase = jnp.where(w_case > 0, cfl == q_fl_pair, True)

    qlen_f = jnp.maximum(ql, 1).astype(jnp.float32)
    ds = jnp.where(ld > ql, 0.0, 1.0 - ld.astype(jnp.float32) / qlen_f)
    score = (
        w_ld * ds
        + w_lcs * lcs.astype(jnp.float32) / qlen_f
        + w_pf * pf.astype(jnp.float32) / qlen_f
        + w_sf * sf.astype(jnp.float32) / qlen_f
        + jnp.where(samecase, w_case, 0.0)
    ) / w_sum

    pass_ed = pvalid & (ld <= k_ed_pair)
    if use_stop_exact:
        # stop-at-exact restriction: drop non-exact pairs of queries with
        # exacts (compiled in only when the stop criterion can need it — the
        # gather into the exact mask costs a [P]-column otherwise). The mask
        # is query-major in BANDED coords: byte pc_band//8 of query row pq.
        exact_byte_idx = jnp.minimum(
            pq_safe * (Ni_band // 8) + pc_band // 8, B * (Ni_band // 8) - 1
        )
        pair_exact_byte = exact_q8.reshape(-1)[exact_byte_idx].astype(
            jnp.int32
        )
        pair_exact = ((pair_exact_byte >> (pc_band % 8)) & 1) == 1
        # StopAtExactMatch (lib.rs:1158-1174): a query with an exact
        # anagram keeps only its exact pairs (a subset of its L1 ball)
        nexact = jax.lax.population_count(exact_q8).astype(jnp.int32).sum(1)
        use_exact = stop_exact & (nexact > 0)
        pass_ed = pass_ed & (~use_exact[pq_safe] | pair_exact)
    keep = pass_ed & (score >= score_threshold - THRESHOLD_SLACK)

    # frequency normalization max runs over ALL scored instances (ld within
    # threshold), including ones below the score threshold — the reference
    # updates max_freq before the threshold push (lib.rs:1455-1476). Exact
    # uint32 arithmetic: this max is load-bearing for every query's
    # freq_score, and f32 would round frequencies above 2^24.
    if have_freq:
        # pq is non-decreasing (slots are emitted query-major)
        max_freq = jax.ops.segment_max(
            jnp.where(pass_ed, cf, jnp.uint32(0)),
            pq,
            num_segments=B + 1,
            indices_are_sorted=True,
        )[:B]
    else:
        # frequency-less model: the normalization max is constant 1 and the
        # segment reduction (a scatter) is compiled out
        max_freq = jnp.ones(B, dtype=jnp.uint32)
    total_keep = keep.sum()
    if stop_stage == "score":
        return _probe(keep, max_freq) + (jnp.sum(score * keep),)

    # compact survivors, preserving (query, canonical candidate) order.
    # Metric columns travel as uint8 (kept pairs have ld <= k_ed <= 12 and
    # lcs/prefix/suffix <= L) to shrink the device->host transfer.
    out = _compact(
        keep,
        (pq, pc, ld, lcs, pf, sf, samecase),
        P2,
        (B, 0, 0, 0, 0, 0, False),
    )
    o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case = out
    # narrow AFTER compaction: the [P2] converts are ~8x cheaper than the
    # same converts at [P], and kept pairs have ld <= k_ed <= 12 and
    # lcs/prefix/suffix <= L, so uint8 is lossless below L=256
    if L < 256:
        o_ld = jnp.minimum(o_ld, 255).astype(jnp.uint8)
        o_lcs, o_pf, o_sf = (
            x.astype(jnp.uint8) for x in (o_lcs, o_pf, o_sf)
        )
    o_case = o_case.astype(jnp.uint8)
    if stop_stage == "compact_sum":
        return _probe(o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case)
    return (
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
        max_freq, total_match, total_keep,
    )


def _pack_query_out(out, B: int, P2: int) -> jnp.ndarray:
    """Bundle the 10 query outputs into ONE flat int32 buffer.

    Every fetched array pays its own synchronised transfer; a single
    device_get pays one, and the per-query column o_q (P2 int32, the largest
    column) is replaced by B+1 query *bounds*: survivors are emitted
    query-major, so o_q is non-decreasing and fully recoverable from its
    run-length boundaries. Layout (int32):
    [bounds (B+1) | o_c | 5 uint8 metric rows bitcast 4->1 | max_freq bitcast
    | total_match, total_keep]. Unpacked by
    :meth:`DevicePipeline._finalize_fused` via numpy views (bitcast byte
    order is the host's little-endian order on the CPU and GPU backends).
    """
    (
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
        max_freq, total_match, total_keep,
    ) = out
    # o_q is sorted (query-major emission; invalid slots hold B): bounds[q] =
    # first slot of query q, bounds[B] = number of valid survivor slots
    bounds = jnp.searchsorted(
        o_q, jnp.arange(B + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    m = jnp.stack([o_ld, o_lcs, o_pf, o_sf, o_case]).reshape(-1)  # [5*P2]
    if m.dtype == jnp.uint8:
        pad = (-m.shape[0]) % 4
        if pad:
            m = jnp.concatenate([m, jnp.zeros(pad, jnp.uint8)])
        m32 = jax.lax.bitcast_convert_type(m.reshape(-1, 4), jnp.int32)
    else:  # L >= 256: metrics stayed int32
        m32 = m
    mf32 = jax.lax.bitcast_convert_type(max_freq, jnp.int32)
    return jnp.concatenate(
        [
            bounds,
            o_c,
            m32,
            mf32,
            jnp.reshape(total_match, (1,)).astype(jnp.int32),
            jnp.reshape(total_keep, (1,)).astype(jnp.int32),
        ]
    )


def _query_core_packed(
    *args, have_freq, T, P, P2, window, nb_band, use_stop_exact=True
):
    out = _query_core(
        *args, have_freq=have_freq, T=T, P=P, P2=P2, window=window,
        nb_band=nb_band, use_stop_exact=use_stop_exact,
    )
    B = args[6].shape[0]  # q_counts
    return _pack_query_out(out, B, P2)


# single-device entry point; the multi-chip path wraps _query_core in a
# shard_map over the lexicon axis (see parallel/mesh.py)
_query_fused = partial(
    jax.jit,
    static_argnames=(
        "T", "P", "P2", "window", "nb_band", "use_stop_exact", "have_freq"
    ),
)(_query_core_packed)


class RankedResults:
    """Array-backed per-input variant results (one device batch).

    Sequence-compatible with ``List[List[VariantResult]]`` — ``[i]`` lazily
    materializes (and memoizes) the object list — while exposing the flat
    survivor arrays so array-native consumers (the vectorized search
    consolidation in models/variant_model.py) can read scores without
    building a Python object per survivor. Survivors are stored row-major
    in final rank order, exactly as the native ranking tail emits them.
    """

    __slots__ = ("n", "vid", "ds", "fq", "row_of", "sbounds", "overrides",
                 "_cache", "_lists")

    def __init__(self, n, vid, ds, fq, row_of, sbounds, overrides):
        self.n = n  # number of inputs
        self.vid = vid  # int64 [n_out] vocab ids (rank order, row-major)
        self.ds = ds  # f64 [n_out] dist scores
        self.fq = fq  # f64 [n_out] freq scores
        self.row_of = row_of  # int64 [n]: input -> survivor row (-1: override)
        self.sbounds = sbounds  # int64 [nrows+1] survivor bounds per row
        self.overrides = overrides  # input idx -> eager List[VariantResult]
        self._cache: dict = {}
        self._lists = None  # lazy .tolist() copies for fast materialization

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (self[i] for i in range(self.n))

    @staticmethod
    def concat(parts: Sequence["RankedResults"]) -> "RankedResults":
        """Concatenate batch results into one RankedResults whose input
        indices run over the parts in order — so a search unit whose unique
        segments exceed one batch bucket can be submitted as several ranked
        batches and consolidated array-natively (the eager fallback costs
        ~4-15x: device arrays -> objects -> arrays again)."""
        if len(parts) == 1:
            return parts[0]
        n = sum(p.n for p in parts)
        vid = np.concatenate([p.vid for p in parts])
        ds = np.concatenate([p.ds for p in parts])
        fq = np.concatenate([p.fq for p in parts])
        row_of = np.full(n, -1, dtype=np.int64)
        sb_parts = [np.zeros(1, dtype=np.int64)]
        overrides: dict = {}
        qoff = 0
        voff = 0
        row_off = 0
        for p in parts:
            sb = np.asarray(p.sbounds, dtype=np.int64)
            sb_parts.append(sb[1:] + voff)
            pr = np.asarray(p.row_of, dtype=np.int64)
            row_of[qoff : qoff + p.n] = np.where(pr >= 0, pr + row_off, -1)
            for k, v in p.overrides.items():
                overrides[qoff + k] = v
            voff += int(sb[-1])
            row_off += len(sb) - 1
            qoff += p.n
        return RankedResults(
            n, vid, ds, fq, row_of, np.concatenate(sb_parts), overrides
        )

    def arrays_of(self, i: int):
        """(lo, hi) into vid/ds/fq for input ``i``, or None when the input
        was resolved outside the fast tail (use ``[i]`` instead)."""
        if i in self.overrides:
            return None
        row = int(self.row_of[i])
        if row < 0:
            return None
        return int(self.sbounds[row]), int(self.sbounds[row + 1])

    def __getitem__(self, i: int) -> List[VariantResult]:
        if not isinstance(i, int):
            raise TypeError("RankedResults supports integer indexing only")
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError(i)
        got = self._cache.get(i)
        if got is not None:
            return got
        ov = self.overrides.get(i)
        if ov is not None:
            res = ov
        else:
            span = self.arrays_of(i)
            if span is None:
                res = []
            else:
                lo, hi = span
                if self._lists is None:
                    # one bulk numpy->python conversion; per-element numpy
                    # scalar reads cost ~30x more across a search unit
                    self._lists = (
                        self.vid.tolist(), self.ds.tolist(), self.fq.tolist()
                    )
                vl, dl, fl = self._lists
                res = [
                    VariantResult(v, d, f, None)
                    for v, d, f in zip(vl[lo:hi], dl[lo:hi], fl[lo:hi])
                ]
        self._cache[i] = res
        return res


def variant_flags(model):
    """Per index row: does its vocab entry carry variant links? Those rows
    need the exact object ranking tail (expansion); everything else takes
    the fast tail. Returns the bool flags and their contiguous uint8 copy
    for the native tail (None when no row has variants, so it skips the
    per-pair flag reads). One sequential pass over the decoder, then a
    vectorized re-index."""
    decoder = model.decoder
    dec_flags = np.fromiter(
        (e.variants is not None for e in decoder), dtype=bool,
        count=len(decoder),
    )
    flags = dec_flags[model.index.vocab_ids]
    return flags, (
        np.ascontiguousarray(flags, dtype=np.uint8) if flags.any() else None
    )


class DevicePipeline:
    """Device-resident index + fused jitted query for one built model."""

    def __init__(self, model):
        index = model.index
        assert index is not None
        self.model = model
        self.A = model.alphabet_size()
        self.Ni = index.size
        self.L = max(8, index.max_norm_len)
        counts = index.counts.astype(np.int32)
        self.T = max(1, int(counts.max())) if counts.size else 1

        # pad rows so the band blocks (ROW_BLOCK) divide evenly
        Ni_pad = max(ROW_BLOCK, -(-self.Ni // ROW_BLOCK) * ROW_BLOCK)
        self.Ni_pad = Ni_pad
        self.M_total = Ni_pad // ROW_BLOCK
        # Largest batch bucket this lexicon supports: the stage-A masks grow
        # with B x band rows, and programs are capped at 2.2G mask cells
        # (ROADMAP R3). Sized pessimistically with the FULL (padded) row
        # count so a worst-case full-band batch never needs the split path.
        self.max_B = B_BUCKETS[0]
        for b in B_BUCKETS:
            if b * self.M_total * ROW_BLOCK <= 2_200_000_000:
                self.max_B = b
        # band-width buckets (in ROW_BLOCK blocks): few enough that typical
        # workloads compile one fused variant
        cand = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
        self.nb_buckets = tuple(
            [c for c in cand if c < self.M_total] + [self.M_total]
        )
        self._nb_seen: dict = {}  # B -> band widths already compiled
        pad = Ni_pad - self.Ni

        # DEVICE LAYOUT: rows sorted by charcount (stable, so canonical order
        # within equal charcounts). Stage A scans only each query tile's
        # charcount band; _canon_of maps surviving device rows back to
        # canonical index rows on the host (collect() lexsorts into the
        # reference's (query, canonical candidate) order either way).
        perm = np.argsort(index.charcounts, kind="stable")
        self._canon_of = np.full(Ni_pad, max(self.Ni - 1, 0), dtype=np.int64)
        self._canon_of[: self.Ni] = perm
        # host copy of the device charcount column for exact band computation
        cc = np.full(Ni_pad, BIG_L1, dtype=np.int32)
        cc[: self.Ni] = index.charcounts[perm]
        self._cc_dev = cc

        # padded arrays are filled into preallocated buffers: one pass each
        # instead of reshape+pad+astype copy chains (learn mode rebuilds this
        # on every iteration, so construction cost is throughput)
        t_levels = np.arange(self.T, dtype=np.int32)[None, None, :]
        bins = np.zeros((Ni_pad, at_width(self.A * self.T)), dtype=np.int8)
        bins[: self.Ni, : self.A * self.T] = (
            counts[perm][:, :, None] > t_levels
        ).reshape(self.Ni, self.A * self.T)
        wn = index.norms.shape[1]
        # norm indices are alphabet positions (tiny ints): store int8 when
        # they fit — the per-pair norm gather is latency/byte-bound and this
        # quarters its traffic ([P, 2L] int32 -> int8); _query_core widens
        # back to int32 right after the gather (a cheap dense pass)
        max_norm_idx = int(index.norms.max(initial=0))
        self._norm_dtype = np.int8 if max_norm_idx < 120 else np.int32
        norms2 = np.zeros((Ni_pad, 2 * self.L), dtype=self._norm_dtype)
        norms2[: self.Ni, :wn] = index.norms[perm]
        norms2[: self.Ni, self.L : self.L + wn] = index.norms_reversed()[perm]
        norm_lens = np.zeros(Ni_pad, dtype=np.int32)
        norm_lens[: self.Ni] = index.norm_lens[perm]
        freqs = np.zeros(Ni_pad, dtype=np.uint32)
        freqs[: self.Ni] = index.freqs[perm].astype(np.uint32)
        first_lower = np.zeros(Ni_pad, dtype=bool)
        first_lower[: self.Ni] = index.first_lower[perm]

        # index arrays as explicit jit arguments: executables shared across
        # models of identical shape, nothing constant-baked
        self._idx = (
            jnp.asarray(bins),
            jnp.asarray(cc),
            jnp.asarray(norms2),
            jnp.asarray(norm_lens),
            jnp.asarray(freqs),
            jnp.asarray(first_lower),
        )
        # sticky budgets: start small, escalate on overflow, remember —
        # tracked per batch bucket B, since the expected pair totals scale
        # with the number of queries in flight (see _budgets)
        self._P_by_B = {}
        self._P2_by_B = {}
        self._has_variants, self._has_var_u8 = variant_flags(model)
        from ..utils.profiling import StageTimer

        self.stats = StageTimer()
        # (text, params) -> oracle results for over-long queries; bounded,
        # cleared whenever frequencies refresh (freq_score is part of the
        # memoized VariantResults)
        self._oracle_memo: dict = {}

    # ------------------------------------------------------------------

    def refresh_freqs(self, freqs_canonical: np.ndarray) -> None:
        """Replace the device frequency column in place.

        Used by learn's incremental auto_build (variant_model.
        _refresh_index_freqs): when an iteration only bumped frequencies,
        re-uploading this one [Ni_pad] uint32 column (~4 MB at 1M rows)
        replaces a full index rebuild + ~390 MB re-upload. ``freqs_canonical``
        is index.freqs in canonical row order; device rows apply the
        charcount-sort permutation (_canon_of). Compiled executables are
        unaffected — index arrays are jit arguments, not constants."""
        freqs = np.asarray(
            freqs_canonical[self._canon_of], dtype=np.uint32
        )
        idx = list(self._idx)
        idx[4] = jnp.asarray(freqs)
        self._idx = tuple(idx)
        # learn may have linked variants to existing indexed entries
        self._has_variants, self._has_var_u8 = variant_flags(self.model)
        self._oracle_memo.clear()

    def _hint_key(self, B: int) -> str:
        return f"{jax.default_backend()}:{self.Ni}:{B}"

    def _budgets(self, B: int) -> Tuple[int, int]:
        """Sticky (P, P2) pair budgets for batch bucket ``B`` (lazy init).

        On an accelerator every escalation compiles a new fused program, so
        budgets start from (a) a cross-process hint file recording where they
        settled for this (backend, lexicon size, B) last time, else (b) a
        size-based estimate. On the CPU they start at the smallest bucket, so
        tests exercise escalation cheaply and stay isolated."""
        if B not in self._P_by_B:
            hint = (
                _budget_hints().get(self._hint_key(B))
                if on_accelerator()
                else None
            )
            if hint and hint[0] in P_BUCKETS and hint[1] in P2_BUCKETS:
                self._P_by_B[B], self._P2_by_B[B] = hint
            elif on_accelerator():
                scale = max(1, B // B_BASE)
                self._P_by_B[B] = _bucket(
                    max(P_BUCKETS[0], (self.Ni // 2) * scale), P_BUCKETS
                )
                self._P2_by_B[B] = _bucket(12288 * scale, P2_BUCKETS)
            else:
                self._P_by_B[B] = P_BUCKETS[0]
                self._P2_by_B[B] = P2_BUCKETS[0]
        return self._P_by_B[B], self._P2_by_B[B]

    def _record_budgets(self, B: int) -> None:
        """Persist escalated budgets so the next process starts there."""
        if on_accelerator():  # CPU compiles are cheap; keep tests isolated
            _save_budget_hint(
                self._hint_key(B), (self._P_by_B[B], self._P2_by_B[B])
            )

    # fused-program time scales with the static P budget (stage B runs over
    # the whole budget), so an over-escalated budget taxes every later
    # batch. Budgets therefore also step DOWN: after
    # DEESC_N consecutive non-overflow batches, if the window's max totals
    # fit a lower bucket with DEESC_MARGIN headroom, shrink and re-persist.
    # The one-time recompile this costs is far smaller than the steady tax.
    DEESC_N = 6
    DEESC_MARGIN = 1.3

    def _deesc_reset(self, B: int) -> None:
        if not hasattr(self, "_obs_max"):  # subclasses skip our __init__
            self._obs_max: Dict[int, Tuple[int, int]] = {}
            self._obs_n: Dict[int, int] = {}
        self._obs_max[B] = (0, 0)
        self._obs_n[B] = 0

    def _observe_totals(self, B: int, total_match: int, total_keep: int) -> None:
        if not hasattr(self, "_obs_max"):
            self._deesc_reset(B)
        m, k = self._obs_max.get(B, (0, 0))
        self._obs_max[B] = (max(m, total_match), max(k, total_keep))
        self._obs_n[B] = self._obs_n.get(B, 0) + 1
        if self._obs_n[B] < self.DEESC_N:
            return
        m, k = self._obs_max[B]
        self._deesc_reset(B)
        P, P2 = self._budgets(B)
        P_new = _bucket(
            max(int(m * self.DEESC_MARGIN), P_BUCKETS[0]), P_BUCKETS
        )
        P2_new = _bucket(
            max(int(k * self.DEESC_MARGIN), P2_BUCKETS[0]), P2_BUCKETS
        )
        if P_new < P or P2_new < P2:
            self._P_by_B[B] = min(P, P_new)
            self._P2_by_B[B] = min(P2, P2_new)
            self._record_budgets(B)

    def _submit_fused(
        self, args, window: int, nb_band: int, use_stop_exact: bool = True
    ):
        """Enqueue the fused device call without blocking (async dispatch)."""
        B = args[0].shape[0]
        P, P2 = self._budgets(B)
        buf = _query_fused(
            *self._idx, *args, have_freq=bool(self.model.have_freq),
            T=self.T, P=P, P2=P2, window=window, nb_band=nb_band,
            use_stop_exact=use_stop_exact,
        )
        # enqueue the device->host copy NOW: it fires as soon as the fused
        # call finishes, overlapping the transfer with whatever host
        # work (ranking, consolidation) runs before collect()
        try:
            buf.copy_to_host_async()
        except AttributeError:
            pass
        return (buf, B, P2)

    def _finalize_fused(self, out):
        """ONE device->host transfer, then numpy-view unpacking (layout from
        :func:`_pack_query_out`). Returns only the ``n`` valid survivor rows
        (o_q rebuilt from the transferred bounds), so downstream host work
        scales with real survivors rather than the padded budget."""
        buf, B, P2 = out
        with self.stats.stage("dev_get"):
            host = np.asarray(jax.device_get(buf))
        bounds = host[: B + 1]
        n = int(bounds[B])
        o_q = np.repeat(
            np.arange(B, dtype=np.int32), np.diff(bounds).astype(np.int64)
        )
        off = B + 1
        o_c = host[off : off + n]
        off += P2
        n8 = 5 * P2
        if self.L < 256:  # metrics travelled as uint8, bitcast into int32
            nw = (n8 + 3) // 4
            met = host[off : off + nw].view(np.uint8)[:n8].reshape(5, P2)
            off += nw
        else:
            met = host[off : off + n8].reshape(5, P2)
            off += n8
        o_ld, o_lcs, o_pf, o_sf, o_case = (row[:n] for row in met)
        max_freq = host[off : off + B].view(np.uint32)
        return (
            o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case, max_freq,
            int(host[off + B]), int(host[off + B + 1]),
        )

    def _run_fused(
        self, args, window: int, nb_band: int, use_stop_exact: bool = True
    ):
        return self._finalize_fused(
            self._submit_fused(args, window, nb_band, use_stop_exact)
        )

    def find_variants_batch(
        self, inputs: Sequence[str], params: SearchParameters
    ) -> List[List[VariantResult]]:
        if len(inputs) > self.max_B:
            # pipeline oversized batches through the depth-2 stream instead
            # of running the sub-batches serially
            out: List[List[VariantResult]] = []
            sub = [
                inputs[start : start + self.max_B]
                for start in range(0, len(inputs), self.max_B)
            ]
            for res in self.find_variants_stream(sub, params):
                out.extend(res)
            return out
        return self.collect(self.submit(inputs, params))

    def find_variants_stream(
        self, batches, params: SearchParameters, depth: int = 2,
        ranked: bool = False,
    ):
        """Pipelined execution over an iterable of input batches.

        Keeps up to ``depth`` batches in flight: the device works ahead while
        the host ranks earlier survivors (ROADMAP S5: re-tune the depth on the
        GPU). Yields one result list per input
        batch, in order. With ``ranked=True``, batches that complete through
        the native tail yield :class:`RankedResults` (flat survivor arrays)
        instead of eager object lists; callers must handle both.
        """
        pending: List = []

        def _submit(batch):
            st = self.submit(batch, params)
            if ranked:
                st["want_ranked"] = True
            return st

        for batch in batches:
            pending.append(_submit(batch))
            if len(pending) > depth:
                yield self.collect(pending.pop(0))
        while pending:
            yield self.collect(pending.pop(0))

    def submit(self, inputs: Sequence[str], params: SearchParameters):
        """Host prep + async device dispatch; pair with :meth:`collect`."""
        assert len(inputs) <= self.max_B, (len(inputs), self.max_B)
        model = self.model
        enc = model.enc
        n = len(inputs)
        results: List[Optional[List[VariantResult]]] = [None] * n

        prep_cm = self.stats.stage("host_prep")
        prep_cm.__enter__()
        A, T, L = self.A, self.T, self.L
        # batch-normalize every query in one native pass
        all_norms, all_lens = enc.normalize_batch_padded(list(inputs), L)
        max_cand_len = int(self.model.index.max_norm_len)
        # classify vectorized (a per-input Python loop costs ~5 us/input —
        # search units carry ~7k unique segments per submit)
        lens_n = all_lens[:n]
        over_mask = lens_n > self.L
        empty_mask = lens_n == 0
        active = np.nonzero(~over_mask & ~empty_mask)[0].tolist()
        for i in np.nonzero(empty_mask)[0].tolist():
            results[i] = []
        for i in np.nonzero(over_mask)[0].tolist():
            # query longer than any index entry: DL >= length difference,
            # so if that exceeds the edit threshold the result is provably
            # empty (common for ngram segments in search mode); otherwise
            # fall back to the exact host path for this rare query —
            # memoized, because streamed corpora repeat segments and each
            # BFS costs ~0.3 ms (eng) to seconds (1M rows)
            text = inputs[i]
            ln = int(all_lens[i])
            k_ed_i = params.max_edit_distance.resolve(ln, _MAX_EDIT_DISTANCE)
            if ln - max_cand_len > k_ed_i:
                results[i] = []
            else:
                key = (text, _params_key(params))
                got = self._oracle_memo.get(key)
                if got is None:
                    with self.stats.stage("host_oracle_fallback"):
                        got = model._find_variants_oracle(text, params)
                    if len(self._oracle_memo) >= 100_000:
                        self._oracle_memo.clear()
                    self._oracle_memo[key] = got
                results[i] = list(got)
        if not active:
            prep_cm.__exit__(None, None, None)
            return {"results": results, "active": [], "inputs": inputs}

        B = _bucket(len(active), B_BUCKETS)
        act = np.asarray(active)
        # sort active queries by charcount: tiles then cover narrow charcount
        # ranges, which is what makes per-tile banding effective. (Results
        # are re-scattered through the `active` list, so output order is
        # unaffected; charcount == norm length for queries.)
        cc_act = enc.counts_from_norms(all_norms[act], all_lens[act])
        cc_sums = cc_act.sum(axis=1).astype(np.int32)
        ord_cc = np.argsort(cc_sums, kind="stable")
        act = act[ord_cc]
        active = [active[i] for i in ord_cc]
        q_norms = np.zeros((B, L), dtype=self._norm_dtype)
        q_norms[: len(active)] = all_norms[act]
        q_lens = np.zeros(B, dtype=np.int32)
        q_lens[: len(active)] = all_lens[act]
        q_counts = np.zeros((B, A), dtype=np.int32)
        q_counts[: len(active)] = cc_act[ord_cc]
        q_first_lower = np.zeros(B, dtype=bool)
        q_first_lower[: len(active)] = [
            inputs[i][:1].islower() if inputs[i] else False for i in active
        ]
        k_ana = np.full(B, -1, dtype=np.int32)  # padding rows match nothing
        k_ana[: len(active)] = _resolve_thresholds(
            params.max_anagram_distance, q_lens[: len(active)],
            _MAX_ANAGRAM_DISTANCE,
        )
        k_ed = np.zeros(B, dtype=np.int32)
        k_ed[: len(active)] = _resolve_thresholds(
            params.max_edit_distance, q_lens[: len(active)], _MAX_EDIT_DISTANCE
        )

        # Per-query DL windows: a batch mixing window buckets would compile
        # and pay the LARGEST window for every pair — with ratio thresholds
        # one len>=14 query would push a whole 4096-batch onto the W12
        # program AND its k_ana onto every tile's band plan. Split
        # window-mixed batches into
        # per-window sub-submissions; every group dispatches asynchronously
        # here, so the device still sees back-to-back work, and each group
        # pays only its own window and its own (narrower) stage-A band.
        if len(active) > 1:
            ke = k_ed[: len(active)]
            if _bucket(int(ke.max()), WINDOW_BUCKETS) != _bucket(
                int(ke.min()), WINDOW_BUCKETS
            ):
                wb = np.searchsorted(WINDOW_BUCKETS, ke, side="left")
                prep_cm.__exit__(None, None, None)
                subs = []
                for w in np.unique(wb):
                    grp = [
                        active[j] for j in range(len(active)) if wb[j] == w
                    ]
                    subs.append(
                        (grp, self.submit([inputs[i] for i in grp], params))
                    )
                return {
                    "results": results,
                    "active": active,
                    "inputs": inputs,
                    "params": params,
                    "subs": subs,
                }

        # stage-A cap on |charcount difference|: DL >= |len(a) - len(q)|, so
        # rows past min(k_ana, k_ed) can never survive stage B — the band
        # AND the pair list shrink to +-k_len (2 vs 3 on default thresholds).
        # Padding rows keep -1 (match nothing).
        k_len = np.minimum(k_ana, k_ed)
        k_len[len(active):] = -1
        q_cc = q_counts.sum(axis=1).astype(np.int32)
        start_blk, nb_band = self._band_plan(q_cc, k_len, B)
        if self._band_over_ceiling(B, nb_band) and len(active) > 1:
            # band too wide for this batch bucket (mixed very-long/short
            # queries at high k): split proactively rather than compile an
            # over-ceiling program
            prep_cm.__exit__(None, None, None)
            return {
                "results": results,
                "active": active,
                "inputs": inputs,
                "params": params,
                "split": True,
            }
        stop_exact = np.full(
            B, params.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH
        )
        w = model.weights
        weights_arr = np.array(
            [w.ld, w.lcs, w.prefix, w.suffix, w.case, w.sum()], dtype=np.float32
        )

        # ONE batched host->device transfer for all query arrays (each
        # separate jnp.asarray pays its own dispatch)
        args = jax.device_put(
            (
                q_counts,
                q_cc,
                q_norms,
                q_lens,
                q_first_lower,
                k_ana,
                k_ed,
                k_len,
                stop_exact,
                start_blk,
                weights_arr,
                np.float32(params.score_threshold),
            )
        )

        # DL exactness window: the smallest static bucket covering every
        # per-query max edit distance in the batch
        window = _bucket(int(k_ed.max(initial=0)), WINDOW_BUCKETS)
        use_se = params.stop_criterion is StopCriterion.STOP_AT_EXACT_MATCH
        prep_cm.__exit__(None, None, None)

        # async dispatch at the current sticky budgets; collect() re-runs
        # synchronously on overflow. Timed separately from host_prep: a
        # nominally-async dispatch that blocks (a compile, a full queue)
        # otherwise shows up nowhere in the stage report.
        with self.stats.stage("dispatch"):
            out = self._submit_fused(args, window, nb_band, use_se)
        return {
            "results": results,
            "active": active,
            "inputs": inputs,
            "params": params,
            "args": args,
            "window": window,
            "nb_band": nb_band,
            "use_stop_exact": use_se,
            "B": B,
            "q_lens": q_lens,
            "out": out,
            "submit_P": self._P_by_B[B],
            "submit_P2": self._P2_by_B[B],
        }

    def _band_over_ceiling(self, B: int, nb_band: int) -> bool:
        return B * nb_band * ROW_BLOCK > 2_200_000_000

    def _band_plan(self, q_cc: np.ndarray, k_ana: np.ndarray, B: int):
        """Exact per-tile charcount band plan for a (padded) query batch.

        Returns (start_blk int32 [B // B_TILE], nb_band) such that every
        tile's block window [start, start + nb_band) covers all device rows
        with charcount in [min(q_cc - k), max(q_cc + k)] over the tile's
        active queries (k_ana < 0 marks padding). Mirrors the reference's
        sortedindex charcount sweep (lib.rs:1266-1288) as a block range.
        """
        bt = _b_tile(B, self.Ni_pad)
        nqt = B // bt
        cc_t = q_cc.reshape(nqt, bt)
        k_t = k_ana.reshape(nqt, bt)
        act = k_t >= 0
        lo_t = np.where(act, cc_t - k_t, np.iinfo(np.int32).max).min(axis=1)
        hi_t = np.where(act, cc_t + k_t, -1).max(axis=1)
        lo_row = np.searchsorted(self._cc_dev, lo_t, side="left")
        hi_row = np.searchsorted(self._cc_dev, hi_t, side="right")
        start = (lo_row // ROW_BLOCK).astype(np.int32)
        need = np.maximum(-(-hi_row // ROW_BLOCK) - start, 1).astype(np.int32)
        nb_band = _bucket(int(need.max(initial=1)), self.nb_buckets)
        # sticky widths: each distinct nb_band compiles its own fused
        # variant, and successive batches of a stream can need different
        # buckets (small-tile plans especially). A WIDER band is always
        # correct — extra rows simply fail the L1 test — so reuse the
        # smallest already-compiled width >= need instead of compiling a
        # new variant mid-stream (each recompile costs seconds).
        # Widths are recorded only if they clear the compile ceiling: an
        # over-ceiling need must NOT enter the seen-set, or every later batch
        # at this B would sticky-widen to it, trip the ceiling check in
        # submit(), and take the recursive split path forever.
        if not self._band_over_ceiling(B, nb_band):
            seen = self._nb_seen.setdefault(B, set())
            wider = [w for w in seen if w >= nb_band]
            if wider:
                nb_band = min(wider)
            else:
                seen.add(nb_band)
        # clamp so every band window stays inside the padded row range;
        # shifting a start down only widens coverage below
        start = np.minimum(start, self.M_total - nb_band).astype(np.int32)
        np.maximum(start, 0, out=start)
        return start, nb_band

    def _collect_split(self, state) -> List[List[VariantResult]]:
        """Overflow fallback: recompute the batch exactly by splitting it."""
        results = state["results"]
        active = state["active"]
        inputs = state["inputs"]
        params = state["params"]
        texts = [inputs[i] for i in active]
        if len(active) == 1:
            sub = [self.model._find_variants_oracle(texts[0], params)]
        else:
            mid = len(active) // 2
            sub = self.collect(self.submit(texts[:mid], params))
            sub += self.collect(self.submit(texts[mid:], params))
        for i, r in zip(active, sub):
            results[i] = r
        return [r if r is not None else [] for r in results]

    def _native_obj_instances(
        self, row, perm, nbounds, o_c_dev, o_ld, o_lcs, o_pf, o_sf, o_case,
        vocab_ids,
    ) -> List[Tuple[int, "Distance"]]:
        """(query, canonical)-ordered (vocab_id, Distance) pairs for one row,
        read through the native tail's sorted permutation — the exact
        object-path input for rows with expandable variants."""
        lo, hi = int(nbounds[row]), int(nbounds[row + 1])
        canon_of = self._canon_of
        ni_max = self.Ni_pad - 1
        out: List[Tuple[int, Distance]] = []
        for k in range(lo, hi):
            p = int(perm[k])
            c = int(canon_of[min(int(o_c_dev[p]), ni_max)])
            out.append(
                (
                    int(vocab_ids[c]),
                    Distance(
                        ld=int(o_ld[p]), lcs=int(o_lcs[p]),
                        prefixlen=int(o_pf[p]), suffixlen=int(o_sf[p]),
                        samecase=bool(o_case[p]),
                    ),
                )
            )
        return out

    def _late_conf_and_finalize(
        self, results, active, inputs, params, batch_res, elig_row,
        late_conf, nrows, instances_fn, floors, q_lens,
    ) -> None:
        """Shared tail epilogue for the native and numpy rank paths.

        Batched late-confusables: ONE native library crossing rescopes the
        whole batch's cropped survivors (per-query calls cost ~0.5 ms of
        ctypes/edit-script overhead each); per-query work shrinks to the
        tiny re-rank + cutoff over <= max_matches survivors. Rows the fast
        path skipped (expandable variants / fast_ok off) take the exact
        object path via ``instances_fn``."""
        model = self.model
        late_conf_batched = False
        if late_conf and batch_res is not None:
            nc = model._native_confusables()
            if nc is not None:
                from ..types import rank_results

                row_ids = [row for row in range(nrows) if elig_row[row]]
                inputs_list = [inputs[active[row]] for row in row_ids]
                texts: List[str] = []
                input_of: List[int] = []
                decoder = model.decoder
                for ri, row in enumerate(row_ids):
                    for r in batch_res[row]:
                        texts.append(decoder[r.vocab_id].text)
                        input_of.append(ri)
                if texts:
                    try:
                        ws = nc.weights_pairs(
                            inputs_list, texts,
                            np.asarray(input_of, dtype=np.int32),
                        )
                    except Exception:
                        ws = None
                    if ws is not None:
                        pos = 0
                        for row in row_ids:
                            res = batch_res[row]
                            for j, r in enumerate(res):
                                res[j] = VariantResult(
                                    r[0], r[1] * float(ws[pos]), r[2], r[3]
                                )
                                pos += 1
                            rank_results(res, params.freq_weight)
                            batch_res[row] = model.cutoff_tail(res, params)
                        late_conf_batched = True
                else:
                    late_conf_batched = True
        for row, i in enumerate(active):
            if elig_row[row]:
                if late_conf and not late_conf_batched:
                    results[i] = model.late_rescore_and_cutoff(
                        batch_res[row], inputs[i], params
                    )
                else:
                    results[i] = batch_res[row]
            else:
                results[i] = model.score_and_rank(
                    instances_fn(row),
                    inputs[i],
                    int(q_lens[row]),
                    params.max_matches,
                    params.score_threshold,
                    params.cutoff_threshold,
                    params.freq_weight,
                    max_freq_floor=float(floors[row]),
                )

    def collect(self, state) -> List[List[VariantResult]]:
        """Block on a submitted batch, handle budget escalation, rank."""
        results = state["results"]
        active = state["active"]
        inputs = state["inputs"]
        if not active:
            return [r if r is not None else [] for r in results]
        if state.get("subs") is not None:
            # window-mixed batch: sub-batches were already dispatched by
            # submit(); collect each and scatter back into input order
            for grp, sub in state["subs"]:
                for i, r in zip(grp, self.collect(sub)):
                    results[i] = r
            return [r if r is not None else [] for r in results]
        if state.get("split"):
            # band width exceeded the compile ceiling for this batch bucket
            return self._collect_split(state)
        params = state["params"]
        args = state["args"]
        window = state["window"]
        nb_band = state["nb_band"]
        B = state["B"]
        q_lens = state["q_lens"]
        model = self.model

        dev_cm = self.stats.stage("device")
        dev_cm.__enter__()
        (
            o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
            max_freq, total_match, total_keep,
        ) = self._finalize_fused(state["out"])
        # compare against the budgets THIS buffer actually ran with: under
        # depth-2 streaming a de-escalation between submit and collect must
        # not read as a (phantom) overflow of the shrunken current budget
        P = state.get("submit_P", self._budgets(B)[0])
        P2 = state.get("submit_P2", self._budgets(B)[1])
        while True:
            overflowed = False
            if total_match > P and P < P_BUCKETS[-1]:
                self._P_by_B[B] = max(
                    self._P_by_B[B], _bucket(total_match, P_BUCKETS)
                )
                overflowed = True
            if total_keep > P2 and P2 < P2_BUCKETS[-1]:
                self._P2_by_B[B] = max(
                    self._P2_by_B[B], _bucket(total_keep, P2_BUCKETS)
                )
                overflowed = True
            if overflowed:
                self._deesc_reset(B)
                self._record_budgets(B)
            if not overflowed:
                if total_match > P or total_keep > P2:
                    # budgets are maxed out and the batch still overflows: the
                    # flat pair list is truncated query-major, which would
                    # silently zero the tail queries' candidate sets. Instead
                    # split the batch and re-run each half (halving the pair
                    # total); a single query that alone overflows the top
                    # bucket takes the exact host oracle path. The reference
                    # guarantees the full candidate set (lib.rs:1143-1308).
                    print(
                        f"WARNING: pair budget overflow "
                        f"({total_match} matches / {total_keep} kept at "
                        f"P={P}/P2={P2}); splitting batch",
                        file=sys.stderr,
                    )
                    dev_cm.__exit__(None, None, None)
                    return self._collect_split(state)
                break
            (
                o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
                max_freq, total_match, total_keep,
            ) = self._run_fused(args, window, nb_band, state["use_stop_exact"])
            P, P2 = self._budgets(B)

        dev_cm.__exit__(None, None, None)
        self._observe_totals(B, total_match, total_keep)

        tail_cm = self.stats.stage("host_tail")
        tail_cm.__enter__()
        index = self.model.index
        vocab_ids = index.vocab_ids
        late_conf = (
            bool(model.confusables) and not model.confusables_before_pruning
        )
        fast_ok = (not model.confusables or late_conf) and getattr(
            model, "fast_tail", True
        )
        nrows = len(active)

        # ---- native one-call ranking tail (sort + score + rank + crop) ----
        # Exact f64 port of the numpy tail below (ananorm.cpp rank_tail);
        # ~60 ms of GIL-holding numpy per 4096-query batch becomes ~3 ms of
        # C++. The numpy path remains the fallback and the test oracle.
        nt = None
        if fast_ok and _rank_tail_native is not None:
            with self.stats.stage("tail_native"):
                w = model.weights
                nt = _rank_tail_native(
                    o_q, o_c, (o_ld, o_lcs, o_pf, o_sf, o_case),
                    self._canon_of, q_lens,
                    index.freqs if model.have_freq else None,
                    self._has_var_u8, vocab_ids, max_freq, nrows,
                    (w.ld, w.lcs, w.prefix, w.suffix, w.case, w.sum()),
                    params.score_threshold, params.cutoff_threshold,
                    params.freq_weight, params.max_matches,
                    bool(model.have_freq), late_conf,
                )
        if nt is not None:
            (n_out, r_seg, r_vid, r_ds, r_fq, elig_u8, perm, nbounds) = nt
            if state.get("want_ranked") and not late_conf:
                # array-backed result (search mode): no per-survivor object
                # construction; ineligible rows (expandable variants) and
                # pre-resolved inputs become eager overrides
                with self.stats.stage("tail_emit"):
                    sb = np.searchsorted(
                        r_seg[:n_out], np.arange(nrows + 1)
                    ).astype(np.int64)
                    row_of = np.full(len(results), -1, dtype=np.int64)
                    overrides = {}
                    floors = None
                    for row, i in enumerate(active):
                        if elig_u8[row]:
                            row_of[i] = row
                            continue
                        if floors is None:
                            floors = max_freq[:B].astype(np.float64)
                        overrides[i] = model.score_and_rank(
                            self._native_obj_instances(
                                row, perm, nbounds, o_c, o_ld, o_lcs, o_pf,
                                o_sf, o_case, vocab_ids,
                            ),
                            inputs[i],
                            int(q_lens[row]),
                            params.max_matches,
                            params.score_threshold,
                            params.cutoff_threshold,
                            params.freq_weight,
                            max_freq_floor=float(floors[row]),
                        )
                    for i, r in enumerate(results):
                        if r is not None:
                            overrides[i] = r
                    rr = RankedResults(
                        len(results), r_vid[:n_out], r_ds[:n_out],
                        r_fq[:n_out], row_of, sb, overrides,
                    )
                tail_cm.__exit__(None, None, None)
                if model.debug >= 2:
                    self.stats.report()
                    self.stats.clear()
                return rr
            with self.stats.stage("tail_emit"):
                elig_row = np.zeros(B, dtype=bool)
                elig_row[:nrows] = elig_u8.view(bool)
                # survivors are seg-major in final rank order: ONE C-level
                # bulk construction over all survivors. Preferred: the
                # fastemit CPython extension (native/fastemit.c) builds the
                # per-row lists of VariantResult tuples in a single C pass;
                # fallback: tuple.__new__ driven by map over zipped columns
                # (VariantResult is a tuple subclass precisely so these
                # paths exist; ~5x cheaper than dataclass __init__), then
                # per-row list slices.
                sbounds_arr = np.searchsorted(
                    r_seg[:n_out], np.arange(nrows + 1)
                ).astype(np.int64)
                from ..utils.native import fastemit_build_result_lists

                femit = fastemit_build_result_lists()
                if femit is not None:
                    batch_res: List[List[VariantResult]] = femit(
                        VariantResult,
                        np.ascontiguousarray(r_vid[:n_out], dtype=np.int64),
                        np.ascontiguousarray(r_ds[:n_out], dtype=np.float64),
                        np.ascontiguousarray(r_fq[:n_out], dtype=np.float64),
                        sbounds_arr,
                        nrows,
                    )
                else:
                    sbounds = sbounds_arr.tolist()
                    all_objs = list(
                        map(
                            tuple.__new__,
                            repeat(VariantResult),
                            zip(
                                r_vid[:n_out].tolist(),
                                r_ds[:n_out].tolist(),
                                r_fq[:n_out].tolist(),
                                repeat(None),
                            ),
                        )
                    )
                    batch_res = [
                        all_objs[sbounds[g] : sbounds[g + 1]]
                        for g in range(nrows)
                    ]
                self._late_conf_and_finalize(
                    results, active, inputs, params, batch_res, elig_row,
                    late_conf, nrows,
                    # exact object path for the rare expandable rows
                    lambda row: self._native_obj_instances(
                        row, perm, nbounds, o_c, o_ld, o_lcs, o_pf, o_sf,
                        o_case, vocab_ids,
                    ),
                    max_freq[:B].astype(np.float64),
                    q_lens,
                )
            tail_cm.__exit__(None, None, None)
            if model.debug >= 2:
                print(
                    f"(batch of {len(active)}: {total_match} candidates, "
                    f"{total_keep} kept; P={self._P_by_B.get(B)}, "
                    f"P2={self._P2_by_B.get(B)}, window={window})",
                    file=sys.stderr,
                )
                self.stats.report()
                self.stats.clear()
            return [r if r is not None else [] for r in results]

        sub_cm = self.stats.stage("tail_sort")
        sub_cm.__enter__()
        # survivors arrive as DEVICE rows (charcount-sorted layout): map back
        # to canonical index rows, then restore the reference's (query,
        # canonical candidate) order with a lexsort
        o_c = self._canon_of[np.minimum(o_c, self.Ni_pad - 1)]
        order = np.lexsort((o_c, o_q))
        o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case = (
            x[order] for x in (o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case)
        )
        bounds = np.searchsorted(o_q, np.arange(B + 1))
        sub_cm.__exit__(None, None, None)

        # vectorized float64 scoring over all surviving pairs at once
        # (exact: integer metrics, same formula as score_and_rank)
        sub_cm = self.stats.stage("tail_score")
        sub_cm.__enter__()
        w = model.weights
        qlen_all = q_lens[np.minimum(o_q, B - 1)].astype(np.float64)
        qlen_all = np.maximum(qlen_all, 1.0)
        ld_f = o_ld.astype(np.float64)
        ds_all = np.where(ld_f > qlen_all, 0.0, 1.0 - ld_f / qlen_all)
        score_all = (
            w.ld * ds_all
            + w.lcs * o_lcs / qlen_all
            + w.prefix * o_pf / qlen_all
            + w.suffix * o_sf / qlen_all
            + np.where(o_case.astype(bool), w.case, 0.0)
        ) / w.sum()
        oc_safe = np.minimum(o_c, index.size - 1)
        freq_all = (
            index.freqs[oc_safe] if model.have_freq else np.ones(len(o_c))
        )
        expandable_all = self._has_variants[oc_safe]

        # late confusables (the default mode) stay on the fast path: rank
        # vectorized first, then rescore only the cropped survivors per query
        # via the native batch matcher and re-rank (the reference applies
        # confusables to survivors too, lib.rs:1592-1595). Early confusables
        # rescore BEFORE the crop, so they keep the exact object path.
        # the device max runs over ALL scored instances (incl. below the score
        # threshold, which never reach the host) — it IS the reference's
        # normalization max, so it is always the floor (lib.rs:1455-1476)
        floors = max_freq[:B].astype(np.float64)
        sub_cm.__exit__(None, None, None)
        sub_cm = self.stats.stage("tail_rank")
        sub_cm.__enter__()
        if fast_ok:
            # rows whose pairs contain an expandable variant fall back to the
            # object path; everything else ranks in one whole-batch pass
            exp_rows = np.zeros(B, dtype=bool)
            if expandable_all.any():
                exp_rows[: B] = np.bincount(
                    o_q[expandable_all], minlength=B
                )[:B].astype(bool)
            elig_row = ~exp_rows
            elig_row[nrows:] = False
            pair_elig = elig_row[np.minimum(o_q, B - 1)] & (o_q < nrows)
            batch_res = rank_fast_batch(
                model,
                vocab_ids,
                o_c[pair_elig],
                score_all[pair_elig],
                freq_all[pair_elig],
                o_q[pair_elig],
                nrows,
                floors[:nrows],
                params,
                stop_before_cutoff=late_conf,
            )
        else:
            elig_row = np.zeros(B, dtype=bool)
            batch_res = None
        sub_cm.__exit__(None, None, None)
        sub_cm = self.stats.stage("tail_emit")
        sub_cm.__enter__()

        def _np_instances(row: int) -> List[Tuple[int, Distance]]:
            lo, hi = int(bounds[row]), int(bounds[row + 1])
            return [
                (
                    int(vocab_ids[o_c[p]]),
                    Distance(
                        ld=int(o_ld[p]),
                        lcs=int(o_lcs[p]),
                        prefixlen=int(o_pf[p]),
                        suffixlen=int(o_sf[p]),
                        samecase=bool(o_case[p]),
                    ),
                )
                for p in range(lo, hi)
            ]

        self._late_conf_and_finalize(
            results, active, inputs, params, batch_res, elig_row, late_conf,
            nrows, _np_instances, floors, q_lens,
        )
        sub_cm.__exit__(None, None, None)
        tail_cm.__exit__(None, None, None)
        if model.debug >= 2:
            print(
                f"(batch of {len(active)}: {total_match} candidates, "
                f"{total_keep} kept; P={self._P_by_B.get(B)}, P2={self._P2_by_B.get(B)}, "
                f"window={window})",
                file=sys.stderr,
            )
            self.stats.report()
            self.stats.clear()
        return [r if r is not None else [] for r in results]


def get_device_pipeline(model) -> DevicePipeline:
    return DevicePipeline(model)
