"""The Triton kernels of both stages against the plain versions.

On the CPU the kernels run in the Pallas interpreter, which executes the
same kernel program (bit packing, band-local DP ring, selects) without a
card; the ``gpu``-marked cases compile them for the card and skip here
(``python chip_smoke.py`` runs them on the GPU).

Both stages are exact integer computations, so every comparison is exact
equality: stage A bit-for-bit, stage B's ld under the windowed contract of
dl_jax.dl_metrics_windowed (exact when the true distance <= window, merely
"> window" otherwise, so every implementation is clipped at window+1) and
lcs, prefix and suffix exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from analiticcl_jax.ops import distance as oracle
from analiticcl_jax.ops import stage_a
from analiticcl_jax.ops.dl_jax import PAD_A, PAD_B, dl_metrics_windowed
from analiticcl_jax.ops.dl_triton import BP, dl_lcs_triton
from analiticcl_jax.ops.pipeline import stage_b_triton, stage_b_xla


def _random_pairs(rng, P, L, sigma):
    """Random padded pairs with clustered characters so edits stay small."""
    a = np.full((P, L), PAD_A, dtype=np.int32)
    b = np.full((P, L), PAD_B, dtype=np.int32)
    al = rng.integers(0, L + 1, size=P).astype(np.int32)
    bl = np.zeros(P, dtype=np.int32)
    for p in range(P):
        base = rng.integers(1, sigma + 1, size=al[p])
        a[p, : al[p]] = base
        # derive b from a by a few random edits (keeps many DLs inside the
        # window) or draw it independently (exercises the >window branch)
        if rng.random() < 0.7 and al[p] > 0:
            s = list(base)
            for _ in range(rng.integers(0, 4)):
                op = rng.integers(0, 4)
                if op == 0 and len(s) < L:
                    s.insert(rng.integers(0, len(s) + 1), rng.integers(1, sigma + 1))
                elif op == 1 and s:
                    s.pop(rng.integers(0, len(s)))
                elif op == 2 and s:
                    s[rng.integers(0, len(s))] = rng.integers(1, sigma + 1)
                elif op == 3 and len(s) >= 2:
                    i = rng.integers(0, len(s) - 1)
                    s[i], s[i + 1] = s[i + 1], s[i]
            s = s[:L]
        else:
            s = list(rng.integers(1, sigma + 1, size=rng.integers(0, L + 1)))
        bl[p] = len(s)
        b[p, : len(s)] = s
    return a, al, b, bl


def check_dl(window, L, seed, interpret, P=2 * BP, check_xla=True):
    """dl_lcs_triton vs dl_metrics_windowed vs the scalar oracle."""
    rng = np.random.default_rng(seed)
    a, al, b, bl = _random_pairs(rng, P, L, sigma=6)
    args = tuple(jnp.asarray(x) for x in (a, al, b, bl))
    ld_k, lcs_k = (np.asarray(x) for x in dl_lcs_triton(
        *args, L, window, interpret=interpret
    ))
    clip = window + 1
    if check_xla:
        ld_x, lcs_x, _, _ = (
            np.asarray(x) for x in dl_metrics_windowed(*args, L, window)
        )
        np.testing.assert_array_equal(lcs_k, lcs_x)
        np.testing.assert_array_equal(
            np.minimum(ld_k, clip), np.minimum(ld_x, clip)
        )
    for p in range(P):
        sa = [int(x) for x in a[p, : al[p]]]
        sb = [int(x) for x in b[p, : bl[p]]]
        true_ld = oracle.damerau_levenshtein(sa, sb, 4 * L)
        assert lcs_k[p] == oracle.longest_common_substring_length(sa, sb), (
            p, sa, sb,
        )
        assert min(int(ld_k[p]), clip) == min(true_ld, clip), (
            p, sa, sb, int(ld_k[p]), true_ld,
        )


def _stage_a_case(rng, Ni, B, A=6, T=3, sort=False):
    counts = rng.integers(0, T + 1, size=(Ni, A)).astype(np.int32)
    if sort:  # charcount-sorted device layout, as DevicePipeline builds it
        counts = counts[np.argsort(counts.sum(axis=1), kind="stable")]
    t_levels = np.arange(T, dtype=np.int32)[None, None, :]
    at = stage_a.at_width(A * T)
    bins = np.zeros((Ni, at), dtype=np.int8)
    bins[:, : A * T] = (counts[:, :, None] > t_levels).reshape(Ni, A * T)
    cc = counts.sum(axis=1).astype(np.int32)
    qc = rng.integers(0, T + 1, size=(B, A)).astype(np.int32)
    if sort:
        qc = qc[np.argsort(qc.sum(axis=1), kind="stable")]
    qbin = np.zeros((B, at), dtype=np.int8)
    qbin[:, : A * T] = (qc[:, :, None] > t_levels).reshape(B, A * T)
    q_cc = qc.sum(axis=1).astype(np.int32)
    return counts, bins, cc, qc, qbin, q_cc


def check_stage_a(seed, B, interpret):
    """Kernel vs XLA bit-for-bit, full scan and a one-block band, plus a
    numpy L1 oracle for the totals."""
    rng = np.random.default_rng(seed)
    Ni = 2048  # two ROW_BLOCK band blocks
    counts, bins, cc, qc, qbin, q_cc = _stage_a_case(rng, Ni, B)
    # a padded tail the way DevicePipeline marks it: huge cc, zero bins
    n_real = Ni - 137
    bins[n_real:] = 0
    cc[n_real:] = np.int32(1 << 28)
    k_ana = rng.integers(0, 4, size=B).astype(np.int32)
    k_ana[0] = -1  # padding-row convention: matches nothing
    # independent length cap (min(k_ana, k_ed) in production)
    k_len = np.minimum(k_ana, rng.integers(0, 4, size=B).astype(np.int32))
    args = tuple(
        jnp.asarray(x) for x in (bins, cc, qbin, q_cc, k_ana, k_len)
    )
    for start, nb_band, rows in ((0, 2, slice(0, Ni)), (1, 1, slice(1024, Ni))):
        st = jnp.full((1,), start, jnp.int32)
        k_out = stage_a.stage_a_masks_triton(
            *args, st, nb_band, interpret=interpret
        )
        x_out = stage_a.stage_a_masks_xla(*args, st, nb_band)
        for k_arr, x_arr in zip(k_out, x_out):
            np.testing.assert_array_equal(np.asarray(k_arr), np.asarray(x_arr))
        l1 = np.abs(counts[rows, None, :] - qc[None, :, :]).sum(axis=2)
        ccd = np.abs(cc[rows, None].astype(np.int64) - q_cc[None, :])
        valid = (np.arange(Ni) < n_real)[rows, None]
        mask = (l1 <= k_ana[None, :]) & (ccd <= k_len[None, :]) & valid
        np.testing.assert_array_equal(
            np.asarray(x_out[2]).sum(axis=1), mask.sum(axis=0)
        )
        bits = np.unpackbits(
            np.asarray(k_out[0]), axis=1, bitorder="little"
        ).astype(bool)
        np.testing.assert_array_equal(bits, mask.T)


def check_stage_a_multi_tile(interpret):
    """Several band tiles (the large-lexicon small-tile path): per-tile
    band starts select DIFFERENT block windows, and both implementations
    agree with a numpy oracle restricted to each tile's band. The tile
    threshold is lowered so a 16384-row lexicon takes that path (B=64 -> 4
    tiles of 16)."""
    saved = stage_a.BIG_NI_ROWS, stage_a.BIG_NI_B_TILE
    stage_a.BIG_NI_ROWS, stage_a.BIG_NI_B_TILE = 1024, 16
    try:
        _check_multi_tile(interpret)
    finally:
        stage_a.BIG_NI_ROWS, stage_a.BIG_NI_B_TILE = saved


def _check_multi_tile(interpret):
    rng = np.random.default_rng(7)
    Ni, B = 16384, 64
    counts, bins, cc, qc, qbin, q_cc = _stage_a_case(rng, Ni, B, sort=True)
    k_ana = rng.integers(0, 2, size=B).astype(np.int32)
    bt = stage_a._b_tile(B, Ni)
    nqt = B // bt
    assert bt == 16 and nqt == 4
    # exact per-tile band plan (mirrors DevicePipeline._band_plan)
    lo = (q_cc.reshape(nqt, bt) - k_ana.reshape(nqt, bt)).min(axis=1)
    hi = (q_cc.reshape(nqt, bt) + k_ana.reshape(nqt, bt)).max(axis=1)
    lo_row = np.searchsorted(cc, lo, side="left")
    hi_row = np.searchsorted(cc, hi, side="right")
    start = (lo_row // 1024).astype(np.int32)
    nb_band = int(np.maximum(-(-hi_row // 1024) - start, 1).max())
    start = np.minimum(start, Ni // 1024 - nb_band).astype(np.int32)
    assert len(set(start.tolist())) > 1
    args = tuple(
        jnp.asarray(x)
        for x in (bins, cc, qbin, q_cc, k_ana, k_ana, start)
    )
    k_out = stage_a.stage_a_masks_triton(*args, nb_band, interpret=interpret)
    x_out = stage_a.stage_a_masks_xla(*args, nb_band)
    for k_arr, x_arr in zip(k_out, x_out):
        np.testing.assert_array_equal(np.asarray(k_arr), np.asarray(x_arr))
    expect = np.zeros(B, dtype=np.int64)
    for q in range(B):
        r0 = start[q // bt] * 1024
        rows = slice(r0, r0 + nb_band * 1024)
        l1 = np.abs(counts[rows] - qc[q][None, :]).sum(axis=1)
        expect[q] = (l1 <= k_ana[q]).sum()
    np.testing.assert_array_equal(np.asarray(k_out[2]).sum(axis=1), expect)


@pytest.mark.parametrize(
    "window,L,seed", [(3, 8, 0), (3, 16, 1), (5, 10, 3), (5, 12, 2)]
)
def test_dl_triton_matches_xla_and_oracle(window, L, seed):
    check_dl(window, L, seed, interpret=True)


def test_dl_triton_window12_matches_oracle():
    """The W=12 bucket (WINDOW_BUCKETS in ops/pipeline.py) vs the scalar
    oracle: a ring of 13 band rows of 27 cells. The XLA cross-check is left
    out; its W=12 CPU compile is slow and it is cross-checked at 3 and 5."""
    check_dl(12, 14, 4, interpret=True, P=BP, check_xla=False)


def test_dl_triton_empty_sides():
    L, window = 8, 3
    P = BP
    a = np.full((P, L), PAD_A, dtype=np.int32)
    b = np.full((P, L), PAD_B, dtype=np.int32)
    al = np.zeros(P, dtype=np.int32)
    bl = np.zeros(P, dtype=np.int32)
    # pair 0: both empty; pair 1: a empty; pair 2: b empty
    b[1, :3] = [1, 2, 3]
    bl[1] = 3
    a[2, :2] = [4, 5]
    al[2] = 2
    ld, lcs = dl_lcs_triton(
        jnp.asarray(a), jnp.asarray(al), jnp.asarray(b), jnp.asarray(bl),
        L, window, interpret=True,
    )
    assert np.asarray(ld)[:3].tolist() == [0, 3, 2]
    assert np.asarray(lcs)[:3].tolist() == [0, 0, 0]


def test_stage_b_wrappers_agree():
    """The pipeline's two stage-B implementations give the same four
    metrics, the kernel's prefix/suffix coming from the pre-reversed
    arrays; P is not a multiple of the kernel's block (padding path)."""
    rng = np.random.default_rng(5)
    P, L, W = 200, 10, 3
    a, al, b, bl = _random_pairs(rng, P, L, sigma=4)
    pos = np.arange(L)[None, :]

    def rev(x, ln, pad):
        idx = np.maximum(ln[:, None] - 1 - pos, 0)
        return np.where(pos < ln[:, None], np.take_along_axis(x, idx, 1), pad)

    args = tuple(
        jnp.asarray(x)
        for x in (a, al, b, bl, rev(a, al, PAD_A), rev(b, bl, PAD_B))
    )
    x = [np.asarray(v) for v in stage_b_xla(*args, L, W)]
    k = [np.asarray(v) for v in stage_b_triton(*args, L, W, interpret=True)]
    np.testing.assert_array_equal(np.minimum(k[0], W + 1), np.minimum(x[0], W + 1))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(k[i], x[i])


@pytest.mark.parametrize("seed,B", [(0, 8), (1, 64)])
def test_stage_a_triton_matches_xla_bit_for_bit(seed, B):
    check_stage_a(seed, B, interpret=True)


def test_stage_a_multi_tile_matches_xla():
    check_stage_a_multi_tile(interpret=True)


def test_at_width_pads_to_the_dot_step():
    assert stage_a.at_width(1) == stage_a.KB
    assert stage_a.at_width(stage_a.KB) == stage_a.KB
    assert stage_a.at_width(49 * 10) == 512


# ---- the same checks compiled for the card (skip without one) ----

GPU_CASES = (
    [(check_dl, (w, L, s), {"interpret": False, "P": 8 * BP})
     for w, L, s in ((3, 30, 0), (6, 30, 1), (12, 30, 2))]
    + [(check_stage_a, (s, B), {"interpret": False})
       for s, B in ((0, 8), (1, 64), (2, 1024))]
    + [(check_stage_a_multi_tile, (), {"interpret": False})]
)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "fn,args,kw", GPU_CASES,
    ids=[f"{fn.__name__}{args}" for fn, args, _ in GPU_CASES],
)
def test_kernels_on_gpu(gpu, fn, args, kw):
    fn(*args, **kw)


def run_gpu_cases():
    """The gpu-marked cases as plain calls, for chip_smoke.py (one process
    holds the card, so they run inside it rather than under pytest)."""
    assert jax.default_backend() == "gpu"
    for fn, args, kw in GPU_CASES:
        fn(*args, **kw)
    return len(GPU_CASES)
