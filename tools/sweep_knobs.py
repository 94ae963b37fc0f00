#!/usr/bin/env python3
"""Sweep the two throughput knobs on the attached device and print a table.

Builds each model ONCE, then measures short steady-state windows per knob
setting — query-mode device batch size (B) and search-mode pipeline depth —
so optimal defaults can be picked on real hardware in one chip lease
(~6 min total at the default budget) before recording the suite.

    python tools/sweep_knobs.py [--budget-s 12] [--skip-search] [--skip-query]

The query workload mirrors benchmarks/suite.py::query_eng and the search
workload mirrors search_text; numbers are comparable to the suite's.
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
    ap.add_argument("--budget-s", type=float, default=12.0)
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[2048, 4096, 8192])
    ap.add_argument("--depths", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--skip-query", action="store_true")
    ap.add_argument("--skip-search", action="store_true")
    args = ap.parse_args()

    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.types import DistanceThreshold, SearchParameters
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap
    from analiticcl_jax.vocab import VocabParams

    import tempfile

    from analiticcl_jax import datagen

    data = datagen.make_dataset(tempfile.mkdtemp(), seed=0)
    model = VariantModel(alphabet_file=data["alphabet"])
    model.read_vocabulary(data["lexicon"], VocabParams())
    model.build()
    model.set_backend("device")
    freeze_model_heap()

    rng = random.Random(1)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]

    def corrupt(word):
        if len(word) < 4:
            return word
        i = rng.randrange(len(word) - 1)
        c = rng.randrange(4)
        if c == 0:
            return word[:i] + word[i + 1:]
        if c == 1:
            return word[:i] + word[i + 1] + word[i] + word[i + 2:]
        if c == 2:
            return word[:i] + "x" + word[i:]
        return word[:i] + "q" + word[i + 1:]

    results = []

    if not args.skip_query:
        queries = [corrupt(w) for w in words[:16384]]
        params = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=10,
        )
        for B in args.batches:
            model.find_variants_batch(queries[:B], params)  # compile
            model.find_variants_batch(queries[:B], params)

            def cycle():
                while True:
                    yield from queries

            t0 = time.time()
            done = 0
            for _ in model.find_variants_stream(cycle(), params, batch_size=B):
                done += 1
                if done % B == 0 and time.time() - t0 > args.budget_s:
                    break
            qps = done / (time.time() - t0)
            results.append(("query", f"B={B}", qps, "q/s"))
            log(f"query B={B}: {qps:.0f} q/s")

    if not args.skip_search:
        rng2 = random.Random(3)
        swords = [model.decoder[i].text for i in range(3, len(model.decoder), 17)]
        sentences = []
        for _ in range(512):
            sent = " ".join(
                corrupt(rng2.choice(swords)) for _ in range(12)
            )
            sentences.append(sent + ".")
        groups = ["\n".join(sentences[i:i + 100]) for i in range(0, 512, 100)]
        tokens_of = [
            sum(len(s.split()) for s in g.split("\n")) for g in groups
        ]
        sparams = SearchParameters(
            max_anagram_distance=DistanceThreshold.absolute(3),
            max_edit_distance=DistanceThreshold.absolute(2),
            max_matches=5,
            max_ngram=2,
        )
        list(model.find_all_matches_stream(groups, sparams))  # compile
        for depth in args.depths:
            def cycle_g():
                while True:
                    yield from range(len(groups))

            t0 = time.time()
            toks = 0
            gi_iter = cycle_g()
            pending = []

            def gen():
                for gi in gi_iter:
                    pending.append(gi)
                    yield groups[gi]

            for _m in model.find_all_matches_stream(gen(), sparams, depth=depth):
                toks += tokens_of[pending.pop(0)]
                if time.time() - t0 > args.budget_s:
                    break
            tps = toks / (time.time() - t0)
            results.append(("search", f"depth={depth}", tps, "tokens/s"))
            log(f"search depth={depth}: {tps:.0f} tokens/s")

    print(f"{'mode':8} {'knob':10} {'throughput':>12} unit")
    for mode, knob, val, unit in results:
        print(f"{mode:8} {knob:10} {val:12.0f} {unit}")


if __name__ == "__main__":
    main()
