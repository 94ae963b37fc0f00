"""Benchmark: variant-query throughput on an eng.aspell-scale lexicon.

Reproduces the reference's methodology (performance.md: query a corrupted
word list against a ~120k lexicon, steady-state items/sec) on the GPU. The
lexicon, alphabet and queries are generated from ``--seed``
(analiticcl_jax.datagen), so the run needs nothing outside the repository.
Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "queries/sec", "vs_baseline": N,
     "device": {...}, "windows": [...], "spread": N}

Baseline: 2532 queries/sec — the reference's best published multi-thread
(8-core i7-4770K) throughput (performance.md:106-114, see BASELINE.md).
A run that finds no GPU fails; it never measures the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

REFERENCE_BASELINE_QPS = 2532.0  # reference v0.3.0 final opts, 8 threads
METRIC = "variant_query_throughput_eng_scale"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def tuples(model, res):
    return [
        (model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
        for r in res
    ]


def gate(model, queries, params, label):
    """Device results must equal the exact host oracle's, full tuples."""
    model.set_backend("oracle")
    want = [tuples(model, r) for r in model.find_variants_batch(queries, params)]
    model.set_backend("device")
    got = [tuples(model, r) for r in model.find_variants_stream(queries, params)]
    hit = sum(1 for w, g in zip(want, got) if w == g)
    log(f"{label}: {hit}/{len(queries)} queries identical to the oracle")
    if hit < len(queries):
        raise SystemExit(f"{label}: device/oracle mismatch — benchmark aborted")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--windows", type=int, default=9)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {dev.platform!r})")

    from analiticcl_jax import datagen
    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.types import DistanceThreshold, SearchParameters
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap
    from analiticcl_jax.vocab import VocabParams

    data = datagen.make_dataset(
        tempfile.mkdtemp(prefix="analiticcl_bench_"), seed=args.seed,
        n_queries=16384,
    )
    t0 = time.time()
    model = VariantModel(alphabet_file=data["alphabet"])
    model.read_vocabulary(data["lexicon"], VocabParams())
    model.build()
    log(f"loaded and built {model.index.size} entries in {time.time() - t0:.1f}s")
    model.set_backend("device")
    with open(data["queries"], encoding="utf-8") as f:
        queries = f.read().split()

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    gate(model, queries[:4096], params, "exactness gate")
    # ratio thresholds push per-query edit distances past 3 and compile the
    # window-12 DL bucket
    params12 = SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_with_limit(0.5, 6),
        max_edit_distance=DistanceThreshold.ratio_with_limit(0.5, 12),
        max_matches=10,
        score_threshold=0.25,
    )
    rng = __import__("random").Random(args.seed)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    long_words = [w for w in words if len(w) >= 9][:512]
    gate(
        model,
        [datagen.corrupt(datagen.corrupt(w, rng), rng) for w in long_words],
        params12, "window-12 gate",
    )

    freeze_model_heap()
    B = args.batch
    t0 = time.time()
    model.find_variants_batch(queries[:B], params)
    log(f"warmup (compile): {time.time() - t0:.1f}s")
    # settle the sticky pair budgets (escalation and de-escalation both
    # recompile) before any measured window
    pipe = model._device
    for _ in range(2 + pipe.DEESC_N):
        model.find_variants_batch(queries[:B], params)

    windows = []
    done = 0
    last = time.time()
    for _res in model.find_variants_stream(
        queries * args.windows, params, batch_size=B
    ):
        done += 1
        if done % len(queries) == 0:
            now = time.time()
            windows.append(len(queries) / (now - last))
            log(f"window {len(windows)}: {windows[-1]:.0f} q/s")
            last = now
    pipe.stats.report()
    ordered = sorted(windows)
    qps = ordered[len(ordered) // 2]
    print(json.dumps({
        "metric": METRIC,
        "value": qps,
        "unit": "queries/sec",
        "vs_baseline": qps / REFERENCE_BASELINE_QPS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "windows": windows,
        "spread": ordered[-1] / ordered[0],
    }))


if __name__ == "__main__":
    main()
