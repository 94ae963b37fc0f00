"""Stage A: charcount-banded L1-ball retrieval masks — Triton kernel + XLA.

Computes, for every (query, lexicon row) pair, whether the row lies in the
query's L1 ball, and emits *compact artifacts* instead of materializing the
[B, Ni] distance matrix in HBM.

**Charcount banding.** L1(a, q) >= |cc(a) - cc(q)|, so only rows with
charcount within +-k of the query's can match. The device index is laid out
sorted by charcount (ops/pipeline.py applies the permutation and maps
survivor rows back to canonical order on the host), queries are sorted by
charcount within the batch, and each tile of ``_b_tile`` queries scans only
the contiguous block range covering [min cc - k, max cc + k] for its tile —
the device equivalent of the reference's sortedindex charcount-bucket sweep
(lib.rs:1266-1288). The host computes the per-tile start block exactly (it
holds the same sorted charcount array), and the static band width
``nb_band`` is bucketed so typical workloads compile one program variant.
Extra rows at the band edges are REAL rows that simply fail the L1 test —
coverage, not exactness, is the only banding requirement.

Banded outputs (Nb = nb_band * ROW_BLOCK rows per tile band):

  * ``packed_q``  uint8 [B, Nb/8]   — hit mask, bit-packed along band rows
    (byte j of a query row holds band rows 8j..8j+7, bit k <-> row 8j+k);
    band row r of query q is global device row
    ``start_blk[q // bt] * ROW_BLOCK + r``
  * ``exact_q``   uint8 [B, Nb/8]   — exact-anagram mask (L1 == 0)
  * ``counts_q``  int32 [B, Nb/128] — hits per 128-row band block

Two implementations with identical outputs: ``stage_a_masks_triton`` (a
Pallas kernel through Triton, for the GPU) keeps each [query, row] L1 tile
on chip from the int8 dot's accumulator to the packed bytes;
``stage_a_masks_xla`` dynamic-slices the band per query tile inside a
lax.map and lets XLA materialize the int32 L1 tile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

ROW_BLOCK = 1024  # band-start granularity and row padding unit
B_TILE = 1024  # queries per band tile
# Above this many lexicon rows the band tile shrinks: a tile's band must
# cover the JOINT charcount range of its queries (+-k), and rows per
# charcount grow linearly with Ni, so at ~1M rows a 1024-query tile's band
# approaches the whole lexicon. A 256-query tile quarters the per-tile
# charcount spread (queries arrive cc-sorted).
BIG_NI_ROWS = 262_144
BIG_NI_B_TILE = 256

# Triton kernel tiling: BQ queries x RBK band rows per program, the int8
# contraction in KB-column steps, NUM_WARPS warps. All powers of two, as
# Triton requires; RBK divides ROW_BLOCK, and BQ divides every band tile of
# >= 16 queries. Chosen on an H100 among 8 configurations at the eng-scale
# widths (PERF.md).
BQ = 128
RBK = 256
KB = 64
NUM_WARPS = 8


def at_width(at: int) -> int:
    """Columns of the device count planes: A*T padded to a multiple of KB
    (zero columns add nothing to the dot)."""
    return -(-at // KB) * KB


def _b_tile(B: int, Ni: int = 0) -> int:
    """Queries per band tile (B buckets are powers of two, so it divides)."""
    return min(B, BIG_NI_B_TILE if Ni >= BIG_NI_ROWS else B_TILE)


def _pack_bits_rows_i32(mask_t: jnp.ndarray) -> jnp.ndarray:
    """[R, B] bool -> [R/8, B] int32 bytes: bit r%8 of byte r//8 is row r."""
    R, B = mask_t.shape
    m = mask_t.reshape(R // 8, 8, B).astype(jnp.int32)
    weights = (1 << jnp.arange(8, dtype=jnp.int32))[None, :, None]
    return jnp.sum(m * weights, axis=1)


def _stage_a_kernel(
    start_ref,  # [nqt] int32: band start block per band tile (whole array)
    qbin_ref,  # [B, ATp] int8 (whole array)
    q_cc_ref,  # [bq] int32
    k_ana_ref,  # [bq] int32
    k_len_ref,  # [bq] int32: min(k_ana, k_ed) — the length-difference cap
    bins_ref,  # [Ni, ATp] int8 (whole array; the program slices its band)
    cc_ref,  # [Ni] int32 (whole array)
    packed_ref,  # [bq, RBK/8] uint8
    exact_ref,  # [bq, RBK/8] uint8
    counts_ref,  # [bq, RBK/128] int32
    *, bq: int, bt: int, nqt: int, at_pad: int,
):
    j = pl.program_id(0)  # query tile
    i = pl.program_id(1)  # RBK-row block within the band
    start = start_ref[jnp.minimum(j * bq // bt, nqt - 1)]
    r0 = pl.multiple_of(start * ROW_BLOCK + i * RBK, RBK)
    rows = pl.ds(r0, RBK)
    qrows = pl.ds(pl.multiple_of(j * bq, bq), bq)
    acc = jnp.zeros((bq, RBK), jnp.int32)
    for k0 in range(0, at_pad, KB):  # static: A*T is a few hundred columns
        acc += jax.lax.dot_general(
            qbin_ref[qrows, pl.ds(k0, KB)],
            bins_ref[rows, pl.ds(k0, KB)],
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
    cc = cc_ref[rows]
    q_cc = q_cc_ref[...]
    l1 = cc[None, :] + q_cc[:, None] - 2 * acc  # [bq, RBK], never in HBM
    # |charcount difference| = |norm length difference| <= DL, so rows past
    # the per-query edit threshold can never survive stage B's ld <= k_ed
    # filter (lib.rs:1350-1378)
    ccd = cc[None, :] - q_cc[:, None]
    mask = (l1 <= k_ana_ref[...][:, None]) & (
        jnp.abs(ccd) <= k_len_ref[...][:, None]
    )
    exact = l1 == 0
    weights = jnp.left_shift(1, jnp.arange(8, dtype=jnp.int32))

    def pack(m):
        m8 = m.astype(jnp.int32).reshape(bq, RBK // 8, 8)
        return jnp.sum(m8 * weights[None, None, :], axis=2).astype(jnp.uint8)

    packed_ref[...] = pack(mask)
    exact_ref[...] = pack(exact)
    counts_ref[...] = jnp.sum(
        mask.astype(jnp.int32).reshape(bq, RBK // 128, 128), axis=2
    )


@functools.partial(jax.jit, static_argnames=("nb_band", "interpret"))
def stage_a_masks_triton(
    bins, cc, qbin, q_cc, k_ana, k_len, start_blk, nb_band: int,
    interpret: bool = False,
):
    """Banded stage A as one Pallas kernel through Triton.

    Shapes: bins [Ni, ATp] int8 (charcount-sorted; ATp a multiple of KB),
    cc [Ni] int32, qbin [B, ATp] int8, q_cc/k_ana/k_len [B] int32, start_blk
    [B // bt] int32 with (start + nb_band) * ROW_BLOCK <= Ni. Padded lexicon
    rows must carry a huge cc so they never match. One program per (BQ query
    tile, RBK band rows): each loads its own band start, so programs share
    nothing and run in any order. ``interpret=True`` runs the kernel in the
    Pallas interpreter (CPU tests)."""
    Ni, at_pad = bins.shape
    B = qbin.shape[0]
    assert at_pad % KB == 0 and qbin.shape[1] == at_pad, (at_pad, qbin.shape)
    assert Ni % ROW_BLOCK == 0 and nb_band * ROW_BLOCK <= Ni
    bt = _b_tile(B, Ni)
    nqt = B // bt
    assert start_blk.shape == (nqt,)
    # a program's queries must share one band tile; Triton's dot wants >= 16
    # rows, so the 8-query bucket is padded (padding rows match nothing)
    bq = max(16, min(BQ, bt))
    Bp = -(-B // bq) * bq
    if Bp != B:
        qbin = jnp.pad(qbin, ((0, Bp - B), (0, 0)))
        q_cc = jnp.pad(q_cc, (0, Bp - B))
        k_ana = jnp.pad(k_ana, (0, Bp - B), constant_values=-1)
        k_len = jnp.pad(k_len, (0, Bp - B), constant_values=-1)
    Nb = nb_band * ROW_BLOCK
    qspec = pl.BlockSpec((bq,), lambda j, i: (j,))
    kernel = functools.partial(
        _stage_a_kernel, bq=bq, bt=bt, nqt=nqt, at_pad=at_pad
    )
    packed_q, exact_q, counts_q = pl.pallas_call(
        kernel,
        grid=(Bp // bq, Nb // RBK),
        in_specs=[
            pl.BlockSpec(),
            pl.BlockSpec(),
            qspec,
            qspec,
            qspec,
            pl.BlockSpec(),
            pl.BlockSpec(),
        ],
        out_specs=[
            pl.BlockSpec((bq, RBK // 8), lambda j, i: (j, i)),
            pl.BlockSpec((bq, RBK // 8), lambda j, i: (j, i)),
            pl.BlockSpec((bq, RBK // 128), lambda j, i: (j, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Bp, Nb // 8), jnp.uint8),
            jax.ShapeDtypeStruct((Bp, Nb // 8), jnp.uint8),
            jax.ShapeDtypeStruct((Bp, Nb // 128), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="stage_a_masks",
    )(start_blk.astype(jnp.int32), qbin, q_cc, k_ana, k_len, bins, cc)
    return packed_q[:B], exact_q[:B], counts_q[:B]


def stage_a_masks_xla(bins, cc, qbin, q_cc, k_ana, k_len, start_blk, nb_band):
    """Plain XLA version with outputs identical to the kernel's."""
    Ni, AT = bins.shape
    B = qbin.shape[0]
    bt = _b_tile(B, Ni)
    nqt = B // bt
    Nb = nb_band * ROW_BLOCK

    def tile(args):
        qb, qc, ka, kl, sb = args
        sr = sb * ROW_BLOCK
        bins_b = jax.lax.dynamic_slice_in_dim(bins, sr, Nb, 0)
        cc_b = jax.lax.dynamic_slice_in_dim(cc, sr, Nb, 0)
        summin = jax.lax.dot_general(
            bins_b, qb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [Nb, bt]
        l1 = cc_b[:, None] + qc[None, :] - 2 * summin
        ccd = cc_b[:, None] - qc[None, :]
        mask = (l1 <= ka[None, :]) & (jnp.abs(ccd) <= kl[None, :])
        exact = l1 == 0
        packed_q = _pack_bits_rows_i32(mask).T.astype(jnp.uint8)
        exact_q = _pack_bits_rows_i32(exact).T.astype(jnp.uint8)
        counts = mask.reshape(Nb // 128, 128, bt).astype(jnp.int32).sum(axis=1)
        return packed_q, exact_q, counts.T

    outs = jax.lax.map(
        tile,
        (
            qbin.reshape(nqt, bt, AT),
            q_cc.reshape(nqt, bt),
            k_ana.reshape(nqt, bt),
            k_len.reshape(nqt, bt),
            start_blk,
        ),
    )
    return (
        outs[0].reshape(B, Nb // 8),
        outs[1].reshape(B, Nb // 8),
        outs[2].reshape(B, Nb // 128),
    )
