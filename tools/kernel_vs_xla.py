"""Time each stage's hand-written kernel against the plain XLA version.

On the GPU, at the widths of the eng-scale smoke configuration
(analiticcl_jax.datagen, 119,773 entries; inputs built by chip_smoke.py):

  * kernel alone: stage A (``stage_a_masks_triton`` vs
    ``stage_a_masks_xla``) on one 8192-query batch's real band plan, and
    stage B (``stage_b_triton`` vs ``stage_b_xla``) on P real-length pairs
    at windows 3, 6 and 12. Outputs must be equal (exact integer contract;
    ld clipped at window+1).
  * end to end: ``find_variants_batch`` over 8192-query batches for each
    stage combination in ``--combos`` and each edit threshold in
    ``--max-edit`` (2, 5, 8 select the DL windows 3, 6, 12). Every
    combination is compiled and its pair budgets settled first; then
    ``--rounds`` rounds of ``--batches`` batches each alternate the order of
    the combinations (A B B A), and results must be equal across them. The
    summary gives each combination's per-round rates, median and quartiles,
    and for each pair of combinations that differ in one stage the number of
    rounds the kernel side won.

    python tools/kernel_vs_xla.py [--seed N] [--reps N] [--rounds N]
        [--batches N] [--max-edit D ...] [--combos xla:xla ...] [--skip-b]

Prints one line per measurement and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

import jax
import jax.numpy as jnp

import chip_smoke


def timeit(fn, reps):
    """Median wall seconds of ``fn()`` after one warm call (blocked on)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--max-edit", nargs="*", type=int, default=[2, 5, 8])
    ap.add_argument("--combos", nargs="*",
                    default=["xla:xla", "triton:xla", "xla:triton",
                             "triton:triton"])
    ap.add_argument("--skip-b", action="store_true")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at a tiny size, kernels interpreted")
    a = ap.parse_args()
    if jax.default_backend() != "gpu" and not a.rehearse:
        sys.exit(f"needs a GPU; JAX found {jax.default_backend()!r}")

    from analiticcl_jax import datagen
    from analiticcl_jax.ops import pipeline as pl
    from analiticcl_jax.types import DistanceThreshold, SearchParameters

    dev = jax.devices()[0]
    card = chip_smoke.card_line()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card}", flush=True)
    summary = {"card": card, "device_kind": dev.device_kind}
    data = datagen.make_dataset(
        tempfile.mkdtemp(prefix="kvx_"), seed=a.seed,
        n_entries=3000 if a.rehearse else datagen.ENG_ASPELL_ENTRIES,
    )
    model = chip_smoke.load_model(data["alphabet"], data["lexicon"])
    with open(data["queries"], encoding="utf-8") as f:
        queries = f.read().split()
    B = 64 if a.rehearse else 8192

    def search_params(d):
        return SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(d),
        )

    pipe = pl.get_device_pipeline(model)
    print(f"index: Ni={pipe.Ni} A={pipe.A} T={pipe.T} L={pipe.L} "
          f"bins={tuple(pipe._idx[0].shape)} max_B={pipe.max_B}", flush=True)

    # ---- stage A alone ----
    sa_args, nb = chip_smoke.stage_a_inputs(pipe, queries[:B], search_params(2))
    summary["stage_a_ms"] = {}
    ref = None
    for name, fn in (
        ("xla", pl.stage_a_masks_xla),
        ("triton", partial(pl.stage_a_masks_triton, interpret=a.rehearse)),
    ):
        f = jax.jit(fn, static_argnums=7)
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*sa_args, nb))
        comp = time.perf_counter() - t0
        ms = timeit(lambda: f(*sa_args, nb), a.reps) * 1e3
        ref = out if ref is None else ref
        same = all(bool(jnp.array_equal(x, y)) for x, y in zip(ref, out))
        print(f"stage A {name}: {ms:.3f} ms (first call {comp:.1f} s; "
              f"B={B}, band {nb * 1024} rows; == xla: {same})", flush=True)
        summary["stage_a_ms"][name] = ms
        assert same

    # ---- stage B alone ----
    summary["stage_b_ms"] = {}
    if not a.skip_b:
        P = 2048 if a.rehearse else 524288
        pairs = chip_smoke.stage_b_inputs(pipe, P, a.seed)
        for W in (3,) if a.rehearse else (3, 6, 12):
            outs = {}
            for name, fn in (
                ("xla", pl.stage_b_xla),
                ("triton", partial(pl.stage_b_triton, interpret=a.rehearse)),
            ):
                f = jax.jit(fn, static_argnums=(6, 7))
                t0 = time.perf_counter()
                outs[name] = jax.block_until_ready(f(*pairs, pipe.L, W))
                comp = time.perf_counter() - t0
                ms = timeit(lambda: f(*pairs, pipe.L, W), a.reps) * 1e3
                print(f"stage B W{W} {name}: {ms:.3f} ms (first call "
                      f"{comp:.1f} s; P={P}, L={pipe.L})", flush=True)
                summary["stage_b_ms"][f"W{W}:{name}"] = ms
            x, k = outs["xla"], outs["triton"]
            same = bool(jnp.array_equal(jnp.minimum(x[0], W + 1),
                                        jnp.minimum(k[0], W + 1))) and all(
                bool(jnp.array_equal(x[i], k[i])) for i in (1, 2, 3))
            print(f"stage B W{W} triton == xla: {same}", flush=True)
            assert same

    # ---- end to end, alternating order ----
    impl = {
        "a": {"xla": pl.stage_a_masks_xla,
              "triton": partial(pl.stage_a_masks_triton,
                                interpret=a.rehearse)},
        "b": {"xla": pl.stage_b_xla,
              "triton": partial(pl.stage_b_triton, interpret=a.rehearse)},
    }
    orig = pl.stage_impls, pl._query_fused
    traced = {}

    def activate(combo, fused):
        # the fused step reads stage_impls when it is traced; each
        # combination keeps its own jit, so switching recompiles nothing
        ca, cb = combo.split(":")

        def impls(platform=None):
            traced[combo] = traced.get(combo, 0) + 1
            return impl["a"][ca], impl["b"][cb]

        pl.stage_impls = impls
        pl._query_fused = fused

    def tuples(rs):
        return [[(r.vocab_id, r.dist_score, r.freq_score) for r in q]
                for q in rs]

    summary["e2e"] = {}
    for d in a.max_edit:
        params = search_params(d)
        W = pl._bucket(d, pl.WINDOW_BUCKETS)
        runs = {}
        for combo in a.combos:
            def fused_fn(*args, **kw):  # a new function: its own trace cache
                return pl._query_core_packed(*args, **kw)

            fused = jax.jit(
                fused_fn,
                static_argnames=("T", "P", "P2", "window", "nb_band",
                                 "use_stop_exact", "have_freq"),
            )
            activate(combo, fused)
            p2 = pl.DevicePipeline(model)
            t0 = time.perf_counter()
            res = tuples(p2.find_variants_batch(queries[:B], params))
            for _ in range(1 + p2.DEESC_N):  # settle budgets
                p2.find_variants_batch(queries[:B], params)
            assert traced.get(combo), f"{combo} was not traced"
            runs[combo] = (fused, p2, res)
            print(f"-d {d} (W{W}) {combo}: compiled and settled in "
                  f"{time.perf_counter() - t0:.1f} s; P={p2._P_by_B} "
                  f"P2={p2._P2_by_B}; same results as {a.combos[0]}: "
                  f"{res == runs[a.combos[0]][2]}", flush=True)
            assert res == runs[a.combos[0]][2]
        qps = {c: [] for c in a.combos}
        for rnd in range(a.rounds):
            line = []
            for combo in a.combos if rnd % 2 == 0 else a.combos[::-1]:
                fused, p2, _ = runs[combo]
                activate(combo, fused)
                p2.stats.clear()
                t0 = time.perf_counter()
                for _ in range(a.batches):
                    p2.find_variants_batch(queries[:B], params)
                dt = time.perf_counter() - t0
                qps[combo].append(a.batches * B / dt)
                dev_ms = p2.stats.totals.get("device", 0.0) / a.batches * 1e3
                line.append(f"{combo} {qps[combo][-1]:.1f} q/s "
                            f"(device {dev_ms:.2f} ms/batch)")
            print(f"-d {d} round {rnd}: " + "; ".join(line), flush=True)
        cell = {"window": W, "qps": qps, "quartiles": {
            c: [float(x) for x in np.percentile(v, [25, 50, 75])]
            for c, v in qps.items()}, "kernel_wins": {}}
        for c1 in a.combos:  # c1 has the kernel where c2 has XLA
            for c2 in a.combos:
                diff = [i for i, (x, y) in enumerate(
                    zip(c1.split(":"), c2.split(":"))) if x != y]
                if len(diff) == 1 and c1.split(":")[diff[0]] == "triton" \
                        and c2.split(":")[diff[0]] == "xla":
                    wins = sum(x > y for x, y in zip(qps[c1], qps[c2]))
                    cell["kernel_wins"][f"{c1} > {c2}"] = (
                        f"{wins} of {a.rounds}")
        for c, q in cell["quartiles"].items():
            print(f"-d {d} (W{W}) {c}: median {q[1]:.1f} q/s, quartiles "
                  f"{q[0]:.1f} .. {q[2]:.1f}", flush=True)
        print(f"-d {d} (W{W}) kernel wins: {cell['kernel_wins']}", flush=True)
        summary["e2e"][f"d{d}"] = cell
    pl.stage_impls, pl._query_fused = orig
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
