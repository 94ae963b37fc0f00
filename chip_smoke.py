#!/usr/bin/env python3
"""Smoke run of analiticcl on one NVIDIA GPU: every phase of the main path.

    python chip_smoke.py [--seed N] [--out DIR]   one card, all phases
    python chip_smoke.py --four                   four cards: sharded path only
    python chip_smoke.py --rehearse [--four]      CPU dry run at a tiny size

Phases, in one process that holds the card:

  1. data   — generate an eng.aspell-scale configuration from the seed
              (analiticcl_jax.datagen: alphabet, 119,773-entry lexicon,
              8192 corrupted queries, running text, bigram LM);
  2. kernels — compile each stage's Triton kernel at the real widths and
              compare it with the plain XLA version on the card (exact
              integer equality), run the gpu-marked kernel tests, and print
              the fused step's memory analysis;
  3. query  — read_vocabulary -> build -> device backend, 8192 queries at
              the largest batch bucket; the first 2048 must equal the host
              oracle's ranked tuples (text, dist_score, freq_score, via);
              then a few queries through ``cli.main(["query", ...])``;
  4. search — running text through find_all_matches, without and with the
              LM, device vs oracle;
  5. learn  — one learn_variants iteration, then a query on the rebuilt
              index, device vs oracle;
  6. scale  — a 1M-row lexicon, a few batches at its largest batch bucket,
              a sample checked against the oracle.

``--four`` runs only the sharded path (parallel/mesh.ShardedPipeline) with
the lexicon sharded lex=4 and dp=2 x lex=2, at eng scale and at 1M rows,
and requires results equal to the one-card DevicePipeline's.

The last line of standard output is one JSON object; ``"ok": true`` only
after every phase passed on a GPU. Without a GPU the script exits non-zero
(``--rehearse`` never prints ``"ok": true``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured (nvidia-smi: {type(e).__name__})"


class Phases:
    """Runs named phases; a failure is recorded and later phases that need
    its products are skipped."""

    def __init__(self):
        self.done, self.failed = [], []

    @contextlib.contextmanager
    def run(self, name):
        t0 = time.perf_counter()
        log(f"== {name}")
        try:
            yield
        except Exception:
            self.failed.append(name)
            log(f"== {name} FAILED after {time.perf_counter() - t0:.1f} s")
            traceback.print_exc(file=sys.stdout)
        else:
            self.done.append(name)
            log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")


def result_tuples(model, results):
    return [
        [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
         for r in res]
        for res in results
    ]


def match_keys(model, matches):
    return [
        (m.text, m.offset.begin, m.offset.end, m.selected,
         result_tuples(model, [m.variants or []])[0])
        for m in matches
    ]


def load_model(alphabet, lexicon, lm=None):
    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.vocab import VocabParams, VocabType

    model = VariantModel(alphabet_file=alphabet)
    model.read_vocabulary(lexicon, VocabParams())
    if lm:
        model.read_vocabulary(lm, VocabParams(vocab_type=VocabType.LM))
    model.build()
    model.set_backend("device")
    return model


def oracle_results(model, queries, params):
    model.set_backend("oracle")
    try:
        return model.find_variants_batch(queries, params)
    finally:
        model.set_backend("device")


def check_equal(name, want, got):
    bad = [i for i, (w, g) in enumerate(zip(want, got)) if w != g]
    if len(want) != len(got) or bad:
        i = bad[0] if bad else min(len(want), len(got))
        raise AssertionError(
            f"{name}: {len(bad)} of {len(want)} differ; first at {i}: "
            f"want {want[i] if i < len(want) else None} got "
            f"{got[i] if i < len(got) else None}"
        )
    log(f"{name}: {len(want)} equal")


# ---- stage inputs at real widths (also used by tools/kernel_vs_xla.py) ----


def stage_a_inputs(pipe, queries, params):
    """Stage-A arguments of one real batch: the submit path's band plan."""
    import jax.numpy as jnp

    seen = {}
    orig = pipe._submit_fused

    def grab(args, window, nb_band, use_stop_exact=True):
        seen.update(args=args, nb_band=nb_band)
        return orig(args, window, nb_band, use_stop_exact)

    pipe._submit_fused = grab
    try:
        pipe.collect(pipe.submit(queries, params))
    finally:
        pipe._submit_fused = orig
    q_counts, q_cc, _, _, _, k_ana, _, k_len, _, start_blk, _, _ = seen["args"]
    B, A, T = q_counts.shape[0], pipe.A, pipe.T
    bins, cc = pipe._idx[0], pipe._idx[1]
    tl = jnp.arange(T)[None, None, :]
    qbin = (jnp.minimum(q_counts, T)[:, :, None] > tl).reshape(B, A * T)
    qbin = jnp.pad(qbin.astype(jnp.int8), ((0, 0), (0, bins.shape[1] - A * T)))
    return (bins, cc, qbin, q_cc, k_ana, k_len, start_blk), seen["nb_band"]


def stage_b_inputs(pipe, P, seed):
    """P (query, candidate) pairs of real lengths from the index: queries
    are index rows, candidates rows of the same charcount neighbourhood."""
    import numpy as np

    import jax.numpy as jnp
    from analiticcl_jax.ops.dl_jax import PAD_A, PAD_B

    L = pipe.L
    rng = np.random.default_rng(seed)
    norms = np.asarray(pipe._idx[2])[: pipe.Ni, :L].astype(np.int32)
    lens = np.asarray(pipe._idx[3])[: pipe.Ni]
    qi = rng.integers(0, pipe.Ni, P)
    ci = np.clip(qi + rng.integers(-64, 64, P), 0, pipe.Ni - 1)
    pos = np.arange(L)[None, :]

    def side(rows, pad):
        ln = lens[rows][:, None]
        fwd = np.where(pos < ln, norms[rows], pad)
        rev = np.where(
            pos < ln,
            np.take_along_axis(norms[rows], np.maximum(ln - 1 - pos, 0), 1),
            pad,
        )
        return jnp.asarray(fwd), jnp.asarray(lens[rows]), jnp.asarray(rev)

    a, al, a_rev = side(qi, PAD_A)
    b, bl, b_rev = side(ci, PAD_B)
    return a, al, b, bl, a_rev, b_rev


def compare_stages(pipe, queries, params, P, windows, interpret, seed):
    """Each stage's kernel vs its XLA version on real inputs; exact."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from analiticcl_jax.ops import pipeline as pl

    sa_args, nb = stage_a_inputs(pipe, queries, params)
    outs = {}
    for name, fn in (
        ("xla", pl.stage_a_masks_xla),
        ("triton", partial(pl.stage_a_masks_triton, interpret=interpret)),
    ):
        t0 = time.perf_counter()
        outs[name] = jax.block_until_ready(
            jax.jit(fn, static_argnums=7)(*sa_args, nb)
        )
        log(f"stage A {name}: first call {time.perf_counter() - t0:.2f} s "
            f"(B={len(queries)}, band {nb * 1024} rows)")
    for x, k in zip(outs["xla"], outs["triton"]):
        assert bool(jnp.array_equal(x, k)), "stage A kernel != XLA"
    log("stage A kernel == XLA (bit-for-bit)")
    pairs = stage_b_inputs(pipe, P, seed)
    for W in windows:
        outs = {}
        for name, fn in (
            ("xla", pl.stage_b_xla),
            ("triton", partial(pl.stage_b_triton, interpret=interpret)),
        ):
            t0 = time.perf_counter()
            outs[name] = jax.block_until_ready(
                jax.jit(fn, static_argnums=(6, 7))(*pairs, pipe.L, W)
            )
            log(f"stage B W{W} {name}: first call "
                f"{time.perf_counter() - t0:.2f} s (P={P}, L={pipe.L})")
        x, k = outs["xla"], outs["triton"]
        assert bool(jnp.array_equal(jnp.minimum(x[0], W + 1),
                                    jnp.minimum(k[0], W + 1))), f"ld W{W}"
        for i in (1, 2, 3):
            assert bool(jnp.array_equal(x[i], k[i])), f"metric {i} W{W}"
        log(f"stage B W{W} kernel == XLA (ld clipped at {W + 1}; lcs, "
            "prefix, suffix exact)")


def memory_analysis(pipe, queries, params):
    """Compile the fused step for one batch and print its memory analysis."""
    from analiticcl_jax.ops import pipeline as pl

    seen = {}
    orig = pipe._submit_fused

    def grab(args, window, nb_band, use_stop_exact=True):
        seen.update(args=args, window=window, nb_band=nb_band, se=use_stop_exact)
        return orig(args, window, nb_band, use_stop_exact)

    pipe._submit_fused = grab
    try:
        pipe.collect(pipe.submit(queries, params))
    finally:
        pipe._submit_fused = orig
    B = seen["args"][0].shape[0]
    P, P2 = pipe._budgets(B)
    compiled = pl._query_fused.lower(
        *pipe._idx, *seen["args"], have_freq=bool(pipe.model.have_freq),
        T=pipe.T, P=P, P2=P2, window=seen["window"], nb_band=seen["nb_band"],
        use_stop_exact=seen["se"],
    ).compile()
    log(f"fused step B={B} P={P} P2={P2}: {compiled.memory_analysis()}")


# ---- the phases ----


def one_card(args, ph, sizes, interpret):
    import jax
    from analiticcl_jax import datagen
    from analiticcl_jax.types import DistanceThreshold, SearchParameters

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
    )
    st = {}
    with ph.run("data"):
        st["data"] = datagen.make_dataset(
            os.path.join(args.out, "eng"), seed=args.seed,
            n_entries=sizes["entries"], n_queries=sizes["queries"],
            n_lines=sizes["lines"],
        )
        with open(st["data"]["queries"], encoding="utf-8") as f:
            st["queries"] = f.read().split()
        with open(st["data"]["text"], encoding="utf-8") as f:
            st["text"] = f.read().splitlines()
        t0 = time.perf_counter()
        st["model"] = load_model(st["data"]["alphabet"], st["data"]["lexicon"])
        from analiticcl_jax.ops.pipeline import get_device_pipeline

        st["pipe"] = get_device_pipeline(st["model"])
        st["model"]._device = st["pipe"]
        p = st["pipe"]
        from analiticcl_jax.utils import native

        log(f"native host library built from tracked sources: "
            f"{native.available()}; fastemit: "
            f"{native.fastemit_build_result_lists() is not None}")
        log(f"lexicon {p.Ni} entries, load+build+upload "
            f"{time.perf_counter() - t0:.1f} s; A={p.A} T={p.T} L={p.L} "
            f"bins {tuple(p._idx[0].shape)}, max_B={p.max_B}")
    if "model" not in st:
        return
    model, pipe, queries = st["model"], st["pipe"], st["queries"]
    B = min(pipe.max_B, len(queries))

    with ph.run("kernels"):
        compare_stages(
            pipe, queries[:B], params, sizes["pairs"], sizes["windows"],
            interpret, args.seed,
        )
        if not interpret:
            sys.path.insert(0, os.path.join(HERE, "tests"))
            import test_kernels

            log(f"gpu-marked kernel cases: {test_kernels.run_gpu_cases()} ok")
        memory_analysis(pipe, queries[:B], params)

    with ph.run("query"):
        t0 = time.perf_counter()
        got = model.find_variants_batch(queries[:B], params)
        t1 = time.perf_counter()
        got = model.find_variants_batch(queries[:B], params)
        t2 = time.perf_counter()
        log(f"query: {B} queries per batch; first call {t1 - t0:.2f} s, "
            f"second {t2 - t1:.3f} s = {B / (t2 - t1):.1f} q/s "
            f"(P={pipe._P_by_B}, P2={pipe._P2_by_B})")
        n = min(sizes["oracle"], B)
        want = oracle_results(model, queries[:n], params)
        check_equal("query device vs oracle", result_tuples(model, want),
                    result_tuples(model, got[:n]))
        from analiticcl_jax import cli

        qfile = os.path.join(args.out, "cli_queries.txt")
        with open(qfile, "w", encoding="utf-8") as f:
            f.write("\n".join(queries[:32]) + "\n")
        outs = {}
        for backend in ("device", "oracle"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([
                    "query", "-a", st["data"]["alphabet"],
                    "-l", st["data"]["lexicon"], "--backend", backend, qfile,
                ])
            assert rc == 0, f"cli query --backend {backend} exited {rc}"
            outs[backend] = buf.getvalue().splitlines()
        assert len(outs["device"]) == 32, len(outs["device"])
        check_equal("cli query device vs oracle", outs["oracle"], outs["device"])
        import analiticcl

        shim = analiticcl.VariantModel(
            st["data"]["alphabet"], analiticcl.Weights()
        )
        shim.read_lexicon(st["data"]["lexicon"])
        shim.build()
        sp = analiticcl.SearchParameters(
            max_anagram_distance=3, max_edit_distance=2
        )
        got = [
            [(v["text"], v["dist_score"], v["freq_score"])
             for v in r["variants"]]
            for r in shim.find_variants_par(queries[:64], sp)
        ]
        want = [[w[:3] for w in ws]
                for ws in result_tuples(model, oracle_results(
                    model, queries[:64], params))]
        check_equal("analiticcl shim (device) vs oracle", want, got)

    with ph.run("search"):
        sp = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=5, max_ngram=2,
        )
        lines = st["text"][: sizes["search_lines"]]
        for label, m in (
            ("without LM", model),
            ("with LM", load_model(st["data"]["alphabet"],
                                   st["data"]["lexicon"], st["data"]["lm"])),
        ):
            prm = sp if m is model else dataclasses.replace(sp, lm_weight=1.0)
            t0 = time.perf_counter()
            got = [match_keys(m, m.find_all_matches(x, prm)) for x in lines]
            dt = time.perf_counter() - t0
            m.set_backend("oracle")
            want = [match_keys(m, m.find_all_matches(x, prm)) for x in lines]
            m.set_backend("device")
            n_match = sum(len(g) for g in got)
            log(f"search {label}: {len(lines)} lines, {n_match} matches, "
                f"{dt:.2f} s on the device path (incl. compiles)")
            assert n_match > 0
            check_equal(f"search {label} device vs oracle", want, got)

    with ph.run("learn"):
        lp = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=3, score_threshold=0.7,
        )
        corpus = queries[: sizes["learn"]]
        t0 = time.perf_counter()
        learned = model.learn_variants(corpus, lp, strict=True, auto_build=True)
        log(f"learn: {learned} variants from {len(corpus)} inputs in "
            f"{time.perf_counter() - t0:.2f} s")
        probe = queries[-64:]
        got = model.find_variants_batch(probe, params)
        want = oracle_results(model, probe, params)
        check_equal("query after learn, device vs oracle",
                    result_tuples(model, want), result_tuples(model, got))

    st.pop("model", None)
    st.pop("pipe", None)
    model = pipe = None
    with ph.run("scale"):
        big = scale_model(args, sizes)
        from analiticcl_jax.ops.pipeline import get_device_pipeline

        bp = get_device_pipeline(big)
        big._device = bp
        Bs = sizes["scale_B"] or bp.max_B
        bq = datagen.queries(big_words(big), Bs * 3, args.seed + 5, 211)
        t0 = time.perf_counter()
        res = [big.find_variants_batch(bq[i : i + Bs], params)
               for i in range(0, len(bq), Bs)]
        dt = time.perf_counter() - t0
        log(f"scale: {bp.Ni} rows, B={Bs} (max_B), {len(res)} batches in "
            f"{dt:.2f} s incl. compile (P={bp._P_by_B}, P2={bp._P2_by_B})")
        n = sizes["scale_oracle"]
        want = oracle_results(big, bq[:n], params)
        check_equal("scale device vs oracle", result_tuples(big, want),
                    result_tuples(big, res[0][:n]))


def big_words(model):
    return [model.decoder[i].text for i in range(3, len(model.decoder))]


def scale_model(args, sizes):
    from analiticcl_jax import datagen

    d = os.path.join(args.out, "1m")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    words = datagen.lexicon_words(sizes["rows_1m"], args.seed + 11)
    lex = datagen.write_lexicon(
        os.path.join(d, "lexicon.tsv"), words,
        datagen.zipf_freqs(len(words), args.seed + 11),
    )
    alpha = datagen.write_alphabet(os.path.join(d, "alphabet.tsv"))
    model = load_model(alpha, lex)
    log(f"scale lexicon: {len(words)} rows generated and built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def four_cards(args, ph, sizes):
    import jax
    from analiticcl_jax import datagen
    from analiticcl_jax.ops.pipeline import DevicePipeline
    from analiticcl_jax.parallel.mesh import ShardedPipeline, make_mesh
    from analiticcl_jax.types import DistanceThreshold, SearchParameters

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 devices, JAX has {len(devs)}"
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
    )

    def compare(label, model, queries):
        one = DevicePipeline(model)
        B = min(one.max_B, len(queries))
        t0 = time.perf_counter()
        want = result_tuples(model, one.find_variants_batch(queries[:B], params))
        log(f"{label}: one card, {B} queries, {time.perf_counter() - t0:.2f} s "
            "incl. compile")
        for dp in (1, 2):
            mesh = make_mesh(devs[:4], dp=dp)
            sp = ShardedPipeline(model, mesh)
            t0 = time.perf_counter()
            got = result_tuples(model, sp.find_variants_batch(queries[:B], params))
            log(f"{label}: mesh dp={dp} x lex={4 // dp}, "
                f"{time.perf_counter() - t0:.2f} s incl. compile")
            check_equal(f"{label} mesh {dp}x{4 // dp} vs one card", want, got)

    with ph.run("four: eng scale"):
        data = datagen.make_dataset(
            os.path.join(args.out, "eng"), seed=args.seed,
            n_entries=sizes["entries"], n_queries=sizes["queries"],
            n_lines=sizes["lines"],
        )
        with open(data["queries"], encoding="utf-8") as f:
            queries = f.read().split()
        compare("eng", load_model(data["alphabet"], data["lexicon"]), queries)
    with ph.run("four: 1M rows"):
        big = scale_model(args, sizes)
        bq = datagen.queries(big_words(big), 8192, args.seed + 5, 211)
        compare("1M", big, bq)


FULL = dict(entries=119_773, queries=8192, lines=200, pairs=524_288,
            windows=(3, 6, 12), oracle=2048, search_lines=8, learn=4096,
            rows_1m=1_000_000, scale_oracle=8, scale_B=None)
TINY = dict(entries=2000, queries=64, lines=8, pairs=256, windows=(3,),
            oracle=64, search_lines=2, learn=64, rows_1m=8000, scale_oracle=4,
            scale_B=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"))
    ap.add_argument("--four", action="store_true",
                    help="only the sharded path on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at a tiny size (kernels interpreted)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    platform = devs[0].platform
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX platform {platform!r}); "
              "use --rehearse for a CPU dry run", file=sys.stderr)
        return 2
    card = card_line() if platform == "gpu" else "not measured (no GPU)"
    log(f"card: {card}")
    sys.path.insert(0, HERE)
    ph = Phases()
    t0 = time.perf_counter()
    sizes = TINY if args.rehearse else FULL
    if args.four:
        four_cards(args, ph, sizes)
    else:
        one_card(args, ph, sizes, interpret=args.rehearse)
    if platform == "gpu":
        stats = devs[0].memory_stats() or {}
        log(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes "
            f"({card})")
    log(f"phases ok: {ph.done}; failed: {ph.failed}; "
        f"{time.perf_counter() - t0:.1f} s")
    log(card)
    if ph.failed:
        return 1
    if args.rehearse:
        print(json.dumps({"rehearsal": True, "phases": ph.done}))
        return 0
    print(json.dumps({
        "ok": True,
        "device": {"platform": platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
