"""Batched Damerau-Levenshtein + LCS + prefix/suffix — pure-JAX device path.

Computes, for a batch of padded (query, candidate) integer-sequence pairs, the
exact metrics of /root/reference/src/distance.rs in one fused row-wise DP:

  * unrestricted Damerau-Levenshtein (transpositions via the last-occurrence
    construction, distance.rs:101-179) — vectorized per DP row with
    - per-column ``last``: the last row where s[i'] == t[j] (replaces the
      reference's per-character hash map)
    - per-column ``db``: exclusive running argmax of in-row matches
    - the sequential in-row deletion dependency resolved as a min-plus prefix
      scan: new[j] = j + cummin(cand[j'] - j')
  * longest common substring (distance.rs:181-205) as a masked diagonal
    recurrence in the same row loop
  * common prefix/suffix lengths as argmin-of-mismatch vector ops

Padding protocol: query rows are padded with PAD_A, candidate rows with PAD_B
(distinct negatives), so padded positions never match anything.

This is the plain XLA version of stage B beside the Triton kernel in
dl_triton.py; both are validated against ops/distance.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

PAD_A = -1
PAD_B = -2


@functools.partial(jax.jit, static_argnames=("max_len",))
def dl_metrics_batch(
    a: jnp.ndarray,  # int32 [P, L] query sequences, padded with PAD_A
    a_len: jnp.ndarray,  # int32 [P]
    b: jnp.ndarray,  # int32 [P, L] candidate sequences, padded with PAD_B
    b_len: jnp.ndarray,  # int32 [P]
    max_len: int,
):
    """Returns (ld, lcs, prefix, suffix), each int32 [P].

    ld is the full Damerau-Levenshtein distance (no early-exit; callers mask
    against their max_edit_distance afterwards, reproducing the reference's
    None-above-maximum semantics).
    """
    P, L = a.shape
    assert L == max_len
    big = 2 * L + 8

    # --- prefix / suffix ---------------------------------------------------
    minlen = jnp.minimum(a_len, b_len)  # [P]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]  # [1, L]
    eq = (a == b) & (pos < minlen[:, None])
    # prefix = index of first mismatch within minlen
    first_mismatch = jnp.min(
        jnp.where((~eq) & (pos < minlen[:, None]), pos, big), axis=1
    )
    prefix = jnp.where(first_mismatch == big, minlen, first_mismatch)

    # suffix: align ends
    def shift_end(x, lens, pad):
        # gather so that the last `lens` entries are right-aligned at L
        idx = pos - (L - lens[:, None])
        return jnp.where(idx >= 0, jnp.take_along_axis(x, jnp.maximum(idx, 0), axis=1), pad)

    a_r = shift_end(a, a_len, PAD_A)
    b_r = shift_end(b, b_len, PAD_B)
    eq_r = (a_r == b_r) & (pos >= (L - minlen)[:, None])
    last_mismatch = jnp.max(
        jnp.where((~eq_r) & (pos >= (L - minlen)[:, None]), pos, -1), axis=1
    )
    suffix = jnp.where(last_mismatch < 0, minlen, L - 1 - last_mismatch)

    # --- DL + LCS row loop -------------------------------------------------
    # mat layout mirrors distance.rs:134-144: (L+2)x(L+2) with sentinel row/col
    W = L + 2
    mat0 = jnp.full((P, W, W), big, dtype=jnp.int32)
    mat0 = mat0.at[:, 1, 1:].set(jnp.arange(0, L + 1, dtype=jnp.int32)[None, :])
    mat0 = mat0.at[:, 1:, 1].set(jnp.arange(0, L + 1, dtype=jnp.int32)[None, :])

    cols = jnp.arange(1, L + 1, dtype=jnp.int32)[None, :]  # j = 1..L  [1, L]

    def row_body(i1, carry):
        # i1 = 0-based row; reference row i = i1 + 1
        mat, lastrow_col, lcs_prev, lcs_best = carry
        i = i1 + 1
        s_char = jax.lax.dynamic_slice_in_dim(a, i1, 1, axis=1)  # [P, 1]

        match = b == s_char  # [P, L] (padded positions can't match)
        # db[j]: last column j' < j (1-based) with an in-row match, else 0
        jm = jnp.where(match, cols, 0)
        db = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), jax.lax.cummax(jm, axis=1)[:, :-1]],
            axis=1,
        )  # [P, L]
        last = lastrow_col  # [P, L]: last row i' < i with s[i'] == t[j]

        cost = jnp.where(match, 0, 1)
        prev_row = jax.lax.dynamic_slice_in_dim(mat, i, 1, axis=1)[:, 0, :]  # mat[i]
        sub = prev_row[:, 1 : L + 1] + cost  # mat[i][j] + cost
        ins = prev_row[:, 2 : L + 2] + 1  # mat[i][j+1] + 1
        # transposition: mat[last][db] + (i - last - 1) + 1 + (j - db - 1)
        flat = mat.reshape(P, W * W)
        gather_idx = last * W + db
        mat_ld = jnp.take_along_axis(flat, gather_idx, axis=1)
        transp = mat_ld + (i - last - 1) + 1 + (cols - db - 1)

        cand = jnp.minimum(jnp.minimum(sub, ins), transp)  # without deletion term
        # deletion resolves as min-plus prefix scan including new_row[1] = i
        # new[j] = min(cand[j], new[j-1] + 1)  over j = 1..L, new[0] := i
        shifted = jnp.concatenate(
            [jnp.full((P, 1), i, dtype=jnp.int32), cand], axis=1
        )  # positions 0..L with col index 0..L
        scan_in = shifted - jnp.arange(0, L + 1, dtype=jnp.int32)[None, :]
        new_vals = jax.lax.cummin(scan_in, axis=1) + jnp.arange(
            0, L + 1, dtype=jnp.int32
        )[None, :]
        new_row = new_vals[:, 1:]  # j = 1..L  -> mat[i+1][j+1]

        mat = jax.lax.dynamic_update_slice_in_dim(
            mat,
            jnp.concatenate(
                [
                    jnp.full((P, 1), big, dtype=jnp.int32),
                    jnp.full((P, 1), i, dtype=jnp.int32),
                    new_row,
                ],
                axis=1,
            )[:, None, :],
            i + 1,
            axis=1,
        )

        # update lastrow_col AFTER the row (char_map insert, distance.rs:170)
        lastrow_col = jnp.where(match, i, lastrow_col)

        # LCS diagonal recurrence, masked to valid area
        valid = match & (i1 < a_len[:, None]) & (pos < b_len[:, None])
        lcs_shift = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), lcs_prev[:, :-1]], axis=1
        )
        lcs_new = jnp.where(valid, lcs_shift + 1, 0)
        lcs_best = jnp.maximum(lcs_best, jnp.max(lcs_new, axis=1))
        return mat, lastrow_col, lcs_new, lcs_best

    init = (
        mat0,
        jnp.zeros((P, L), jnp.int32),
        jnp.zeros((P, L), jnp.int32),
        jnp.zeros((P,), jnp.int32),
    )
    mat, _, _, lcs_best = jax.lax.fori_loop(0, L, row_body, init)

    # result = mat[len_s + 1][len_t + 1]
    flat = mat.reshape(P, W * W)
    ld = jnp.take_along_axis(
        flat, ((a_len + 1) * W + (b_len + 1))[:, None], axis=1
    )[:, 0]
    # empty-side shortcuts (distance.rs:109-130)
    ld = jnp.where(a_len == 0, b_len, ld)
    ld = jnp.where(b_len == 0, a_len, ld)
    return ld, lcs_best, prefix, suffix


def affix_metrics_aligned(a, a_len, b, b_len, a_rev, b_rev):
    """Prefix/suffix lengths from pre-aligned arrays — no gathers.

    ``a_rev``/``b_rev`` are the sequences reversed and left-aligned (computed
    once per index build / per query batch), so the suffix is just the prefix
    of the reversed pair."""

    def first_mismatch_len(x, y, minlen):
        L = x.shape[1]
        big = 2 * L + 8
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        window = pos < minlen[:, None]
        mism = (x != y) & window
        first = jnp.min(jnp.where(mism, pos, big), axis=1)
        return jnp.where(first == big, minlen, first)

    minlen = jnp.minimum(a_len, b_len)
    prefix = first_mismatch_len(a, b, minlen)
    suffix = first_mismatch_len(a_rev, b_rev, minlen)
    return prefix, suffix


def affix_metrics(a, a_len, b, b_len):
    """Common prefix/suffix lengths as dense vector ops (distance.rs:208-231).

    a/b are [P, L] padded with PAD_A/PAD_B; returns (prefix, suffix) int32 [P].
    """
    P, L = a.shape
    big = 2 * L + 8
    minlen = jnp.minimum(a_len, b_len)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    eq = (a == b) & (pos < minlen[:, None])
    first_mismatch = jnp.min(
        jnp.where((~eq) & (pos < minlen[:, None]), pos, big), axis=1
    )
    prefix = jnp.where(first_mismatch == big, minlen, first_mismatch)

    def shift_end(x, lens, pad):
        idx = pos - (L - lens[:, None])
        return jnp.where(
            idx >= 0, jnp.take_along_axis(x, jnp.maximum(idx, 0), axis=1), pad
        )

    a_r = shift_end(a, a_len, PAD_A)
    b_r = shift_end(b, b_len, PAD_B)
    eq_r = (a_r == b_r) & (pos >= (L - minlen)[:, None])
    last_mismatch = jnp.max(
        jnp.where((~eq_r) & (pos >= (L - minlen)[:, None]), pos, -1), axis=1
    )
    suffix = jnp.where(last_mismatch < 0, minlen, L - 1 - last_mismatch)
    return prefix, suffix


@functools.partial(jax.jit, static_argnames=("max_len", "window"))
def dl_metrics_windowed(
    a: jnp.ndarray,  # int32 [P, L] query sequences, padded with PAD_A
    a_len: jnp.ndarray,  # int32 [P]
    b: jnp.ndarray,  # int32 [P, L] candidate sequences, padded with PAD_B
    b_len: jnp.ndarray,  # int32 [P]
    max_len: int,
    window: int,  # max edit distance for which exact values are needed
):
    """Windowed Damerau-Levenshtein + LCS + prefix/suffix.

    Exactness contract: for every pair, if the true (unrestricted) DL is
    <= ``window``, the returned value is exact; otherwise the returned value
    is some number > ``window``. Proof sketch: a transposition referencing
    mat[last][db] contributes mat[last][db] + (i-last-1) + (j-db-1) + 1, and
    all matrix entries are >= 0, so any reference with lookback beyond
    ``window`` rows/columns costs > window; DP values are non-decreasing along
    optimal paths, so inflating don't-care cells never corrupts cells whose
    true value is <= window. The engine only consumes DL values that pass the
    per-query max_edit_distance cutoff (reference distance.rs None semantics,
    lib.rs:1343-1389), so this is exact end-to-end whenever
    window >= max(k_ed).

    The bounded lookback removes the full DP matrix and the per-pair gather of
    the plain kernel: the carry is a ring of the last window+2 rows, and the
    transposition value is assembled from statically-shifted row slices — all
    dense vector ops.
    """
    P, L = a.shape
    assert L == max_len
    W = window + 1  # lookback depth in rows/cols
    big = 2 * L + 8

    # --- prefix / suffix / lcs bookkeeping shared with the plain kernel ---
    minlen = jnp.minimum(a_len, b_len)
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    eq = (a == b) & (pos < minlen[:, None])
    first_mismatch = jnp.min(
        jnp.where((~eq) & (pos < minlen[:, None]), pos, big), axis=1
    )
    prefix = jnp.where(first_mismatch == big, minlen, first_mismatch)

    def shift_end(x, lens, pad):
        idx = pos - (L - lens[:, None])
        return jnp.where(
            idx >= 0, jnp.take_along_axis(x, jnp.maximum(idx, 0), axis=1), pad
        )

    a_r = shift_end(a, a_len, PAD_A)
    b_r = shift_end(b, b_len, PAD_B)
    eq_r = (a_r == b_r) & (pos >= (L - minlen)[:, None])
    last_mismatch = jnp.max(
        jnp.where((~eq_r) & (pos >= (L - minlen)[:, None]), pos, -1), axis=1
    )
    suffix = jnp.where(last_mismatch < 0, minlen, L - 1 - last_mismatch)

    cols = jnp.arange(1, L + 1, dtype=jnp.int32)[None, :]  # j = 1..L
    jidx = jnp.arange(0, L + 1, dtype=jnp.int32)[None, :]

    # rows ring: ring[d] = DP row mat[i-d] over columns j=0..L (mat col j+1),
    # where "mat" follows distance.rs indexing. mat[r][0-col] sentinel handled
    # by the out-of-window INF default.
    # Initial: computing row for s[0] (mat row 2) uses prev = mat[1] = 0..L.
    row_init = jnp.broadcast_to(
        jnp.arange(0, L + 1, dtype=jnp.int32)[None, :], (P, L + 1)
    )
    ring0 = (row_init,) + tuple(
        jnp.full((P, L + 1), big, dtype=jnp.int32) for _ in range(W)
    )

    def row_body(i1, carry):
        ring, lastrow_col, lcs_prev, lcs_best, res = carry
        i = i1 + 1  # mat row being read is mat[i] = ring[0]; writing mat[i+1]
        s_char = jax.lax.dynamic_slice_in_dim(a, i1, 1, axis=1)  # [P, 1]
        match = b == s_char  # [P, L]

        jm = jnp.where(match, cols, 0)
        db = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), jax.lax.cummax(jm, axis=1)[:, :-1]],
            axis=1,
        )  # [P, L] per column j=1..L
        last = lastrow_col  # [P, L]

        cost = jnp.where(match, 0, 1)
        prev_row = ring[0]  # mat[i], columns j=0..L at positions 0..L
        sub = prev_row[:, 0:L] + cost  # mat[i][j] + cost   (j=1..L)
        ins = prev_row[:, 1 : L + 1] + 1  # mat[i][j+1] + 1

        # transposition from the bounded window:
        #   term = mat[last][db] + (i-last-1) + (j-db-1) + 1
        # last in [i-W, i-1]  -> ring depth d = i-last in [1, W]
        # db   in [j-W, j-1]  -> column shift s = j-db in [1, W]
        transp = jnp.full((P, L), big * 4, dtype=jnp.int32)
        for d in range(1, W + 1):
            row_d = ring[d] if d < len(ring) else None
            if row_d is None:
                continue
            sel_row = last == (i - d)
            for s in range(1, W + 1):
                sel = sel_row & (db == (cols - s))
                # mat[i-d][j-s] lives at ring[d] position (j-s) for j-s>=0
                shifted = jnp.concatenate(
                    [
                        jnp.full((P, s), big, dtype=jnp.int32),
                        row_d[:, : L + 1 - s],
                    ],
                    axis=1,
                )[:, 0:L]  # value of mat[i-d][j-s] for j=1..L; j-s<1 -> big
                term = shifted + (d - 1) + 1 + (s - 1)
                transp = jnp.where(sel, term, transp)

        cand = jnp.minimum(jnp.minimum(sub, ins), transp)
        shifted0 = jnp.concatenate(
            [jnp.full((P, 1), i, dtype=jnp.int32), cand], axis=1
        )
        scan_in = shifted0 - jidx
        new_vals = jax.lax.cummin(scan_in, axis=1) + jidx  # positions 0..L
        new_row = new_vals  # column j at position j (j=0 -> value i)

        # capture the result when this is the last real row of `a`
        res_col = jnp.take_along_axis(
            new_row, jnp.maximum(b_len[:, None], 0), axis=1
        )[:, 0]
        res = jnp.where(i1 == a_len - 1, res_col, res)

        lastrow_col = jnp.where(match, i, lastrow_col)

        valid = match & (i1 < a_len[:, None]) & (pos < b_len[:, None])
        lcs_shift = jnp.concatenate(
            [jnp.zeros((P, 1), jnp.int32), lcs_prev[:, :-1]], axis=1
        )
        lcs_new = jnp.where(valid, lcs_shift + 1, 0)
        lcs_best = jnp.maximum(lcs_best, jnp.max(lcs_new, axis=1))

        ring = (new_row,) + ring[:-1]
        return ring, lastrow_col, lcs_new, lcs_best, res

    init = (
        ring0,
        jnp.zeros((P, L), jnp.int32),
        jnp.zeros((P, L), jnp.int32),
        jnp.zeros((P,), jnp.int32),
        jnp.zeros((P,), jnp.int32),
    )
    _, _, _, lcs_best, res = jax.lax.fori_loop(0, L, row_body, init)

    ld = jnp.where(a_len == 0, b_len, res)
    ld = jnp.where(b_len == 0, a_len, ld)
    return ld, lcs_best, prefix, suffix


def dl_metrics_chunked(a, a_len, b, b_len, max_len: int, chunk: int = 8192):
    """Apply dl_metrics_batch in fixed-size chunks to bound the DP matrix
    footprint (P * (L+2)^2 * 4 bytes)."""
    P = a.shape[0]
    if P <= chunk:
        return dl_metrics_batch(a, a_len, b, b_len, max_len)
    outs = []
    for start in range(0, P, chunk):
        end = min(start + chunk, P)
        pad = chunk - (end - start)
        aa = jnp.pad(a[start:end], ((0, pad), (0, 0)), constant_values=PAD_A)
        bb = jnp.pad(b[start:end], ((0, pad), (0, 0)), constant_values=PAD_B)
        al = jnp.pad(a_len[start:end], (0, pad))
        bl = jnp.pad(b_len[start:end], (0, pad))
        res = dl_metrics_batch(aa, al, bb, bl, max_len)
        outs.append(tuple(r[: end - start] for r in res))
    return tuple(jnp.concatenate([o[k] for o in outs]) for k in range(4))
