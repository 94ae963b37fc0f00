"""Multi-chip execution: lexicon + batch sharding over a device mesh.

The reference's only parallelism is shared-memory data parallelism over
independent inputs (rayon; SURVEY.md §2.8). The device equivalents here:

  * **Batch data parallelism** ("dp" mesh axis): queries are sharded across
    devices; each dp group answers its own slice of the batch.
  * **Lexicon model parallelism** ("lex" mesh axis): the index arrays (binary
    count planes, normalized strings, frequencies) are sharded row-wise across
    HBM — the tensor-parallel analogue for million-entry background lexicons.
    Every device scans only its shard; per-query frequency maxima are
    combined with a pmax collective (NCCL on GPUs), and the host
    merges the per-shard survivor lists (already canonically ordered within a
    shard) by global canonical index.

The per-device computation is exactly ops/pipeline._query_core, so the
single-chip and multi-chip paths cannot drift apart.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import pipeline as pl
from ..ops.pipeline import (
    BIG_L1, DevicePipeline, _query_core, on_accelerator, variant_flags,
)
from ..ops.stage_a import ROW_BLOCK, _b_tile, at_width


def initialize_distributed(**kwargs) -> None:
    """Multi-host (DCN) initialization passthrough.

    The reference has no distributed story (SURVEY.md §2.8); here multi-host
    runs use standard JAX distributed initialization — afterwards
    ``jax.devices()`` returns the global device set and :func:`make_mesh`
    spans hosts, with the lexicon shards placed across all device memory and
    the same pmax collective spanning hosts.
    """
    jax.distributed.initialize(**kwargs)


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None) -> Mesh:
    """Create a ("dp", "lex") mesh over the given devices.

    ``dp`` defaults to 1 (pure lexicon sharding); pass dp>1 to also shard the
    query batch.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    dp = dp or 1
    assert n % dp == 0, f"{n} devices not divisible by dp={dp}"
    arr = np.array(devices).reshape(dp, n // dp)
    return Mesh(arr, ("dp", "lex"))


class ShardedPipeline(DevicePipeline):
    """DevicePipeline with the index sharded over a ("dp", "lex") mesh."""

    def __init__(self, model, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dp = self.mesh.shape["dp"]
        self.n_lex = self.mesh.shape["lex"]

        index = model.index
        assert index is not None
        self.model = model
        self.A = model.alphabet_size()
        self.Ni = index.size
        self.L = max(8, index.max_norm_len)
        counts = index.counts.astype(np.int32)
        self.T = max(1, int(counts.max())) if counts.size else 1

        # pad rows to uniform shards; shards must also tile the band blocks
        unit = ROW_BLOCK * self.n_lex
        Ni_pad = max(unit, -(-self.Ni // unit) * unit)
        self.Ni_pad = Ni_pad
        self.Ni_shard = Ni_pad // self.n_lex
        self.M_shard = self.Ni_shard // ROW_BLOCK
        self.M_total = self.M_shard  # per-shard band space (base-class name)
        # per-device stage-A mask is B_local x band rows (see
        # DevicePipeline.max_B for the compile-size ceiling)
        self.max_B = pl.B_BUCKETS[0]
        for b in pl.B_BUCKETS:
            if (
                max(1, b // self.n_dp) * self.M_shard * ROW_BLOCK
                <= 2_200_000_000
            ):
                self.max_B = b
        cand = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
        self.nb_buckets = tuple(
            [c for c in cand if c < self.M_shard] + [self.M_shard]
        )
        self._nb_seen: dict = {}  # B -> band widths already compiled
        pad = Ni_pad - self.Ni

        # DEVICE LAYOUT: global charcount sort, then ROUND-ROBIN interleave
        # across lexicon shards — every shard sees the full charcount range
        # (balanced stage-B load for banded batches) and its local rows stay
        # charcount-sorted, so per-shard banding works. Device flat id
        # f = shard * Ni_shard + local corresponds to global sorted position
        # local * n_lex + shard; _canon_of maps f back to canonical rows.
        gperm = np.argsort(index.charcounts, kind="stable")

        def to_dev(arr_sorted_padded):
            """[Ni_pad, ...] in global-sorted order -> shard-major layout."""
            shp = arr_sorted_padded.shape
            return (
                arr_sorted_padded.reshape(self.Ni_shard, self.n_lex, -1)
                .swapaxes(0, 1)
                .reshape(shp)
            )

        canon_sorted = np.full(Ni_pad, max(self.Ni - 1, 0), dtype=np.int64)
        canon_sorted[: self.Ni] = gperm
        self._canon_of = to_dev(canon_sorted)
        cc_sorted = np.full(Ni_pad, BIG_L1, dtype=np.int32)
        cc_sorted[: self.Ni] = index.charcounts[gperm]
        cc = to_dev(cc_sorted)
        # per-shard ascending charcount columns for the host band plan
        self._cc_shard = cc.reshape(self.n_lex, self.Ni_shard)

        t_levels = np.arange(self.T, dtype=np.int32)[None, None, :]
        bins = np.zeros((Ni_pad, at_width(self.A * self.T)), dtype=np.int8)
        bins[: self.Ni, : self.A * self.T] = (
            counts[gperm][:, :, None] > t_levels
        ).reshape(self.Ni, self.A * self.T)
        bins = to_dev(bins)
        # int8 norms when indices fit (see DevicePipeline: the per-pair norm
        # gather is byte-bound; _query_core widens after the gather)
        max_norm_idx = int(index.norms.max(initial=0))
        self._norm_dtype = np.int8 if max_norm_idx < 120 else np.int32
        wn = index.norms.shape[1]
        norms2 = np.zeros((Ni_pad, 2 * self.L), dtype=self._norm_dtype)
        norms2[: self.Ni, :wn] = index.norms[gperm]
        norms2[: self.Ni, self.L : self.L + wn] = index.norms_reversed()[gperm]
        norms2 = to_dev(norms2)
        norm_lens = np.zeros(Ni_pad, dtype=np.int32)
        norm_lens[: self.Ni] = index.norm_lens[gperm]
        norm_lens = to_dev(norm_lens)
        freqs = np.zeros(Ni_pad, dtype=np.uint32)
        freqs[: self.Ni] = index.freqs[gperm].astype(np.uint32)
        freqs = to_dev(freqs)
        first_lower = np.zeros(Ni_pad, dtype=bool)
        first_lower[: self.Ni] = index.first_lower[gperm]
        first_lower = to_dev(first_lower)

        row_sharding = NamedSharding(self.mesh, P("lex"))
        self._idx = tuple(
            jax.device_put(arr, row_sharding)
            for arr in (bins, cc, norms2, norm_lens, freqs, first_lower)
        )
        # sticky budgets are per (dp, lex) shard and per batch bucket (see
        # _budgets)
        self._P_by_B = {}
        self._P2_by_B = {}
        self._sharded_cache = {}
        self._has_variants, self._has_var_u8 = variant_flags(model)
        from ..utils.profiling import StageTimer

        self.stats = StageTimer()
        self._oracle_memo: dict = {}  # see DevicePipeline

    # ------------------------------------------------------------------

    def refresh_freqs(self, freqs_canonical: np.ndarray) -> None:
        """Sharded twin of DevicePipeline.refresh_freqs: one [Ni_pad]
        uint32 column re-uploaded with the lex row sharding."""
        freqs = np.asarray(
            freqs_canonical[self._canon_of], dtype=np.uint32
        )
        idx = list(self._idx)
        idx[4] = jax.device_put(freqs, NamedSharding(self.mesh, P("lex")))
        self._idx = tuple(idx)
        self._has_variants, self._has_var_u8 = variant_flags(self.model)
        self._oracle_memo.clear()

    def _sharded_fn(
        self, P_: int, P2: int, window: int, nb_band: int,
        use_stop_exact: bool, have_freq: bool,
    ):
        key = (P_, P2, window, nb_band, use_stop_exact, have_freq)
        fn = self._sharded_cache.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh
        Ni_shard = self.Ni_shard

        idx_specs = (P("lex"),) * 6
        # q_counts, q_cc, q_norms, q_lens, q_fl, k_ana, k_ed, k_len, stop
        q_specs = (P("dp"),) * 9
        band_specs = (P("dp", "lex"),)  # start_blk [n_dp, n_lex, nqt_local]
        rep_specs = (P(), P())  # weights, threshold

        @partial(
            jax.shard_map,
            mesh=mesh,
            # the DP loop carries constant-initialized buffers; skip the
            # varying-manual-axes analysis (outputs are explicitly combined)
            check_vma=False,
            in_specs=idx_specs + q_specs + band_specs + rep_specs,
            # ONE per-shard packed int32 buffer: a second fetched array costs
            # a second host sync every batch
            out_specs=P(("dp", "lex")),
        )
        def step(
            bins, cc, norms2, norm_lens, freqs, first_lower,
            q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana,
            k_ed, k_len, stop_exact, start_blk, weights, score_threshold,
        ):
            B_local = q_counts.shape[0]
            (
                o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case,
                max_freq, total_match, total_keep,
            ) = _query_core(
                bins, cc, norms2, norm_lens, freqs, first_lower,
                q_counts, q_cc, q_norms, q_lens, q_first_lower,
                k_ana, k_ed, k_len, stop_exact, start_blk.reshape(-1),
                weights, score_threshold, have_freq, T=self.T,
                P=P_, P2=P2, window=window, nb_band=nb_band,
                use_stop_exact=use_stop_exact,
            )  # have_freq is a static closure value
            dp_i = jax.lax.axis_index("dp")
            lex_i = jax.lax.axis_index("lex")
            # globalize ids; invalid slots (o_q == B_local) become B_global
            B_global = B_local * self.n_dp
            o_q = jnp.where(o_q < B_local, o_q + dp_i * B_local, B_global)
            o_c = o_c + lex_i * Ni_shard
            if have_freq:
                # combine per-query stats across lexicon shards
                max_freq = jax.lax.pmax(max_freq, "lex")

            # pack this shard's outputs into ONE flat int32 buffer (same
            # motivation as pipeline._pack_query_out: every fetched array
            # pays a host round trip). o_q is non-decreasing within the
            # shard, so it travels as B_global+1 run-length bounds.
            bounds = jnp.searchsorted(
                o_q, jnp.arange(B_global + 1, dtype=jnp.int32), side="left"
            ).astype(jnp.int32)
            m = jnp.stack([o_ld, o_lcs, o_pf, o_sf, o_case]).reshape(-1)
            if m.dtype == jnp.uint8:
                padn = (-m.shape[0]) % 4
                if padn:
                    m = jnp.concatenate([m, jnp.zeros(padn, jnp.uint8)])
                m32 = jax.lax.bitcast_convert_type(m.reshape(-1, 4), jnp.int32)
            else:
                m32 = m
            parts = [
                bounds,
                o_c,
                m32,
                jnp.reshape(total_match, (1,)).astype(jnp.int32),
                jnp.reshape(total_keep, (1,)).astype(jnp.int32),
            ]
            if have_freq:
                # ride the single buffer (replicated across lex after pmax;
                # the host reads lex shard 0's copy per dp row). Without
                # frequencies the normalization max is constant 1 and
                # travels as nothing at all.
                parts.append(jax.lax.bitcast_convert_type(max_freq, jnp.int32))
            return jnp.concatenate(parts)

        fn = jax.jit(step)
        self._sharded_cache[key] = fn
        return fn

    def _hint_key(self, B: int) -> str:
        # budgets are per shard: keep mesh hints separate from single-device
        return (
            f"{jax.default_backend()}:mesh{self.n_dp}x{self.n_lex}:"
            f"{self.Ni}:{B}"
        )

    def _budgets(self, B: int):
        """Per-(shard, batch-bucket) sticky budgets (overrides the
        single-device sizing: pair totals scale with the per-shard row count
        and the batch size)."""
        if B not in self._P_by_B:
            scale = max(1, B // pl.B_BASE)
            hint = (
                pl._budget_hints().get(self._hint_key(B))
                if on_accelerator()
                else None
            )
            if hint and hint[0] in pl.P_BUCKETS and hint[1] in pl.P2_BUCKETS:
                self._P_by_B[B], self._P2_by_B[B] = hint
            elif on_accelerator():
                self._P_by_B[B] = pl._bucket(
                    max(pl.P_BUCKETS[0], (self.Ni_shard // 2) * scale),
                    pl.P_BUCKETS,
                )
                self._P2_by_B[B] = pl._bucket(12288 * scale, pl.P2_BUCKETS)
            else:
                self._P_by_B[B] = pl.P_BUCKETS[0]
                self._P2_by_B[B] = pl.P2_BUCKETS[0]
        return self._P_by_B[B], self._P2_by_B[B]

    def _band_plan(self, q_cc: np.ndarray, k_ana: np.ndarray, B: int):
        """Per-(dp shard, lex shard, tile) band plan.

        Queries arrive charcount-sorted (base submit), so each dp-local
        contiguous chunk is sorted too; each lex shard holds every n_lex-th
        globally-sorted row, so shard-local bands are ~1/n_lex of the global
        band. Returns (start_blk int32 [n_dp, n_lex, nqt_local], nb_band).
        """
        B_local = B // self.n_dp
        # tile size keys off the SHARD-local row count (each lex shard scans
        # only its own rows, so that is what sets the band economics)
        bt = _b_tile(B_local, self.M_shard * ROW_BLOCK)
        nqt = B_local // bt
        cc_t = q_cc.reshape(self.n_dp, nqt, bt)
        k_t = k_ana.reshape(self.n_dp, nqt, bt)
        act = k_t >= 0
        lo_t = np.where(act, cc_t - k_t, np.iinfo(np.int32).max).min(axis=2)
        hi_t = np.where(act, cc_t + k_t, -1).max(axis=2)  # [n_dp, nqt]
        starts = np.zeros((self.n_dp, self.n_lex, nqt), dtype=np.int32)
        need_max = 1
        for s in range(self.n_lex):
            cc_s = self._cc_shard[s]
            lo_row = np.searchsorted(cc_s, lo_t, side="left")
            hi_row = np.searchsorted(cc_s, hi_t, side="right")
            st = (lo_row // ROW_BLOCK).astype(np.int32)
            need = np.maximum(-(-hi_row // ROW_BLOCK) - st, 1)
            need_max = max(need_max, int(need.max(initial=1)))
            starts[:, s, :] = st
        nb_band = pl._bucket(need_max, self.nb_buckets)
        # sticky widths (see DevicePipeline._band_plan): reuse the smallest
        # already-compiled band >= need rather than compiling a new variant
        # only record widths that clear the compile ceiling (see
        # DevicePipeline._band_plan: an over-ceiling width in the seen-set
        # would force every later batch onto the split path)
        if not self._band_over_ceiling(B, nb_band):
            seen = self._nb_seen.setdefault(B, set())
            wider = [w for w in seen if w >= nb_band]
            if wider:
                nb_band = min(wider)
            else:
                seen.add(nb_band)
        np.minimum(starts, self.M_shard - nb_band, out=starts)
        np.maximum(starts, 0, out=starts)
        return starts, nb_band

    def _band_over_ceiling(self, B: int, nb_band: int) -> bool:
        return (
            max(1, B // self.n_dp) * nb_band * ROW_BLOCK > 2_200_000_000
        )

    def _submit_fused(
        self, args, window: int, nb_band: int, use_stop_exact: bool = True
    ):
        # shard query arrays over dp
        (
            q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana,
            k_ed, k_len, stop_exact, start_blk, weights, score_threshold,
        ) = args
        B = q_counts.shape[0]
        P, P2 = self._budgets(B)
        fn = self._sharded_fn(
            P, P2, window, nb_band, use_stop_exact,
            bool(self.model.have_freq),
        )
        buf = fn(
            *self._idx,
            q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana,
            k_ed, k_len, stop_exact, start_blk, weights, score_threshold,
        )
        try:
            buf.copy_to_host_async()
        except AttributeError:
            pass
        return (buf, B, P2)

    def _finalize_fused(self, out):
        """ONE device fetch (the packed per-shard buffers, max_freq riding
        behind the totals when the model has frequencies); per-shard numpy
        unpacking mirrors :meth:`DevicePipeline._finalize_fused`."""
        buf, B, P2 = out
        host = np.asarray(jax.device_get(buf))
        nsh = self.n_dp * self.n_lex
        L_buf = host.shape[0] // nsh
        n8 = 5 * P2
        nw = (n8 + 3) // 4 if self.L < 256 else n8
        have_freq = bool(self.model.have_freq)
        B_local = B // self.n_dp
        parts_q, parts_c, parts_m, parts_mf = [], [], [], []
        total_match = total_keep = 0
        for s in range(nsh):
            sh = host[s * L_buf : (s + 1) * L_buf]
            bounds = sh[: B + 1]
            n = int(bounds[B])
            off = B + 1
            parts_q.append(
                np.repeat(
                    np.arange(B, dtype=np.int32),
                    np.diff(bounds).astype(np.int64),
                )
            )
            parts_c.append(sh[off : off + n])
            off += P2
            if self.L < 256:
                met = sh[off : off + nw].view(np.uint8)[:n8].reshape(5, P2)
            else:
                met = sh[off : off + n8].reshape(5, P2)
            off += nw
            parts_m.append(met[:, :n])
            # overflow checks are per (dp, lex) shard
            total_match = max(total_match, int(sh[off]))
            total_keep = max(total_keep, int(sh[off + 1]))
            if have_freq and s % self.n_lex == 0:  # lex shard 0 per dp row
                parts_mf.append(
                    sh[off + 2 : off + 2 + B_local].view(np.uint32)
                )
        o_q = np.concatenate(parts_q)
        o_c = np.concatenate(parts_c)
        o_ld, o_lcs, o_pf, o_sf, o_case = np.concatenate(parts_m, axis=1)
        max_freq = (
            np.concatenate(parts_mf)
            if have_freq
            else np.ones(B, dtype=np.uint32)
        )
        return (
            o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case, max_freq,
            total_match, total_keep,
        )


def get_sharded_pipeline(model, mesh: Optional[Mesh] = None) -> ShardedPipeline:
    return ShardedPipeline(model, mesh)
