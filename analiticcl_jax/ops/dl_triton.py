"""Banded windowed Damerau-Levenshtein + LCS as a Pallas kernel through Triton.

The XLA version (dl_jax.dl_metrics_windowed) lays each string across the
vector and pays, per DP row, about W^2 masked selects and a cummin scan over
[P, L] arrays that travel through device memory between fusions. This kernel
gives every pair its own thread: a program holds BP pairs as [BP] vectors,
loops over the query's L characters, and keeps only what a row needs in
registers.

Per row it computes the 2W+3 band cells |i - j| <= W+1 (D(s[:i], t[:j]) >=
|i - j|, so cells off the band are > window and only need to stay so). The
ring of the W+1 previous rows is band-local: row r stores band offset o for
position j = r - W - 2 + o, so the cells a new cell reads sit at static
offsets: substitution at o, insertion at o+1 of the row above, and the
transposition cell mat[r-1-d][j-s] at o+d-s of the row d above.

The unrestricted-DL transposition (distance.rs:101-179) needs ``last`` (the
last query row whose character equals t[j]) and ``db`` (the last column of
this row whose character equals s[i]). Terms with i - last > W or j - db > W
cost more than the window, so both are found among the last W rows and
columns by compare-and-select chains; no per-pair gather is needed.

Exactness contract (dl_jax.dl_metrics_windowed): ld is exact whenever the
true distance is <= window and otherwise some value > window. LCS has no
band and is exact everywhere. Prefix/suffix stay in XLA
(dl_jax.affix_metrics_aligned).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .dl_jax import PAD_A, PAD_B

BP = 128  # pairs per program: one per thread at 4 warps
BIG = 1 << 20  # "> window" filler; DP sums of it cannot overflow int32


def _dl_kernel(aT_ref, bT_ref, al_ref, bl_ref, ld_ref, lcs_ref, *, L, W):
    """aT: [W + L, P] query chars, W rows of PAD_A in front (row W + i is
    a[i]). bT: [L + 3W + 2, P] candidate chars, 2W+1 rows of PAD_B in front
    (row 2W+1 + j is b[j]). Both are whole arrays; this program reads the
    column range of its BP pairs."""
    NB = 2 * W + 3  # band cells per row
    OFF = 2 * W + 1
    cols = pl.ds(pl.program_id(0) * BP, BP)
    al = al_ref[...]
    bl = bl_ref[...]
    tchars = [bT_ref[OFF + j, cols].astype(jnp.int32) for j in range(L)]
    big = jnp.full((BP,), BIG, jnp.int32)

    # ring[d][o]: row r - d of the band (r = the row just written). Row 1 is
    # mat[1][j] = j; rows <= 0 are the all-big sentinel.
    row1 = tuple(
        jnp.full((BP,), o - W - 1, jnp.int32) if o >= W + 1 else big
        for o in range(NB)
    )
    ring0 = (row1,) + tuple((big,) * NB for _ in range(W))
    lcs0 = (jnp.zeros((BP,), jnp.int32),) * L

    def row(i1, carry):
        ring, lcs_prev, lcs_best, res = carry
        k = i1 + 2  # mat row being written (mat[1] is the init row)
        s_char = aT_ref[W + i1, cols].astype(jnp.int32)
        # qc[d] = a[i1 - d]: the query characters of the W rows above
        qc = [None] + [
            aT_ref[W + i1 - d, cols].astype(jnp.int32) for d in range(1, W + 1)
        ]
        # band characters: tch[o + W] = t at position j - 1 of band cell o,
        # for o in [-W, 2W+2] (the W columns left of the band feed db)
        tch = [
            bT_ref[k + W - 2 + o, cols].astype(jnp.int32)
            for o in range(-W, NB)
        ]
        ms = [t == s_char for t in tch]  # t[j'] == s[i] at each column
        j0 = k - W - 2  # position of band cell 0
        prev = ring[0]
        # the cell left of the band: mat[k][1] = k - 1 when it is column 1
        cell = jnp.where(j0 == 1, jnp.full_like(big, k - 1), big)
        capture = al + 1 == k
        cur = []
        for o in range(NB):
            j = j0 + o
            sub = prev[o] + jnp.where(ms[o + W], 0, 1)
            ins = prev[o + 1] + 1 if o + 1 < NB else big
            best = jnp.minimum(jnp.minimum(sub, ins), cell + 1)
            # db = j - s for the smallest s in [1, W] with t[j-s-1] == s[i]
            s_star = big
            for s in range(W, 0, -1):
                s_star = jnp.where(ms[o + W - s], s, s_star)
            transp = big
            for d in range(W, 0, -1):  # smallest d (latest row) wins
                v = big
                for s in range(W, 0, -1):
                    x = o + d - s
                    if 0 <= x < NB:
                        v = jnp.where(ms[o + W - s], ring[d][x], v)
                # last = i - d when a[i1 - d] == t[j - 1]
                transp = jnp.where(
                    qc[d] == tch[o + W], v + s_star + (d - 1), transp
                )
            best = jnp.minimum(best, transp)
            best = jnp.where(j == 0, jnp.full_like(big, k - 1), best)
            best = jnp.where(j < 0, big, best)
            res = jnp.where(capture & (bl == j), best, res)
            cur.append(best)
            cell = best
        # longest common substring: the diagonal run ending at (i, j)
        lcs_new = []
        for jj in range(L):
            run = (lcs_prev[jj - 1] if jj else 0) + 1
            lcs_new.append(jnp.where(tchars[jj] == s_char, run, 0))
            lcs_best = jnp.maximum(lcs_best, lcs_new[-1])
        ring = (tuple(cur),) + ring[:-1]
        return ring, tuple(lcs_new), lcs_best, res

    _, _, lcs_best, res = jax.lax.fori_loop(
        0, L, row, (ring0, lcs0, jnp.zeros((BP,), jnp.int32), big)
    )
    # empty-side shortcuts (distance.rs:109-130)
    res = jnp.where(al == 0, bl, res)
    ld_ref[...] = jnp.where(bl == 0, al, res)
    lcs_ref[...] = lcs_best


@functools.partial(jax.jit, static_argnames=("max_len", "window", "interpret"))
def dl_lcs_triton(
    a, a_len, b, b_len, max_len: int, window: int, interpret: bool = False
):
    """(ld, lcs) int32 [P] for PAD_A/PAD_B-padded int pairs a, b [P, L]."""
    P, L = a.shape
    assert L == max_len and b.shape == (P, L)
    W = window
    Pp = -(-P // BP) * BP
    # pairs along the minor axis, so one row of characters is one
    # contiguous [BP] load per program; int16 holds any alphabet index
    aT = jnp.pad(
        a.T.astype(jnp.int16), ((W, 0), (0, Pp - P)), constant_values=PAD_A
    )
    bT = jnp.pad(
        b.T.astype(jnp.int16), ((2 * W + 1, W + 1), (0, Pp - P)),
        constant_values=PAD_B,
    )
    al = jnp.pad(a_len.astype(jnp.int32), (0, Pp - P))
    bl = jnp.pad(b_len.astype(jnp.int32), (0, Pp - P))
    pspec = pl.BlockSpec((BP,), lambda p: (p,))
    ld, lcs = pl.pallas_call(
        functools.partial(_dl_kernel, L=L, W=W),
        grid=(Pp // BP,),
        in_specs=[pl.BlockSpec(), pl.BlockSpec(), pspec, pspec],
        out_specs=[pspec, pspec],
        out_shape=[
            jax.ShapeDtypeStruct((Pp,), jnp.int32),
            jax.ShapeDtypeStruct((Pp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=f"dl_lcs_w{W}",
    )(aT, bT, al, bl)
    return ld[:P], lcs[:P]
