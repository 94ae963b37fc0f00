#!/usr/bin/env python3
"""Per-stage profile of the query pipeline on the attached device.

Prints host_prep / device / host_tail per-batch timings in steady state
(streamed, depth 2), plus a sequential (non-streamed) breakdown where the
stages don't overlap — the difference shows how much host work the stream
actually hides. Optionally wraps one pass in a jax.profiler trace.

Usage: python tools/profile_query.py [--batches N] [--trace DIR] [--seq]
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import tempfile

    from analiticcl_jax import datagen
    from analiticcl_jax.datagen import corrupt
    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.types import DistanceThreshold, SearchParameters
    from analiticcl_jax.vocab import VocabParams

    data = datagen.make_dataset(tempfile.mkdtemp(), seed=args.seed)
    model = VariantModel(alphabet_file=data["alphabet"])
    model.read_vocabulary(data["lexicon"], VocabParams())
    model.build()
    model.set_backend("device")
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    rng = random.Random(42)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    B = args.batch_size
    n = args.batches * B
    queries = [corrupt(w, rng) for w in (words * (n // len(words) + 1))[:n]]
    batches = [queries[i : i + B] for i in range(0, n, B)]

    from analiticcl_jax.ops.pipeline import get_device_pipeline

    model._device = get_device_pipeline(model)
    pipe = model._device
    # warm both budget variants
    for _ in range(2):
        t0 = time.time()
        model.find_variants_batch(batches[0], params)
        log(f"warm: {time.time() - t0:.2f}s (P={pipe._P_by_B}, P2={pipe._P2_by_B})")

    # --- sequential: stages don't overlap, true per-stage cost ---
    pipe.stats.clear()
    t0 = time.time()
    for b in batches:
        pipe.collect(pipe.submit(b, params))
    seq_s = time.time() - t0
    log(f"\nsequential: {n} queries in {seq_s:.2f}s = {n/seq_s:.0f} q/s")
    pipe.stats.report()

    # --- streamed steady state ---
    pipe.stats.clear()
    t0 = time.time()
    for _ in pipe.find_variants_stream(batches, params):
        pass
    stream_s = time.time() - t0
    log(f"\nstreamed(depth2): {n} queries in {stream_s:.2f}s = {n/stream_s:.0f} q/s")
    pipe.stats.report()

    if args.trace:
        import jax

        with jax.profiler.trace(args.trace):
            for _ in pipe.find_variants_stream(batches[:4], params):
                pass
        log(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
