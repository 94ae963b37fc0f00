#!/usr/bin/env python3
"""Attribute device time inside the fused query call, stage by stage.

Builds the eng-scale generated index (analiticcl_jax.datagen), forms one
realistic batch (PROF_B queries, default 1024), then times jitted prefixes of
the pipeline (stage A only; + pair resolution; + gathers + DL; full compute;
full with real outputs). Each variant returns tiny scalars except the last,
so the difference between successive medians isolates one stage; the
last-minus-previous difference is the device->host transfer cost.
"""

from __future__ import annotations

import os
import random
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.ops import pipeline as P
    from analiticcl_jax.types import DistanceThreshold, SearchParameters
    from analiticcl_jax.vocab import VocabParams
    import tempfile

    from analiticcl_jax import datagen
    from analiticcl_jax.datagen import corrupt

    data = datagen.make_dataset(tempfile.mkdtemp(), seed=0)
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
    import os as _os
    NB = int(_os.environ.get("PROF_B", "1024"))
    queries = [corrupt(w, rng) for w in (words * (NB // len(words) + 1))[:NB]]

    pipe = model._device if model._device else None
    from analiticcl_jax.ops.pipeline import get_device_pipeline

    pipe = get_device_pipeline(model)
    # capture the args of a real batch + settle budgets
    state = pipe.submit(queries, params)
    pipe.collect(state)
    state = pipe.submit(queries, params)
    pipe.collect(state)
    args = state["args"]
    window = state["window"]
    nb_band = state["nb_band"]
    PP, P2 = state["submit_P"], state["submit_P2"]
    log(
        f"budgets: P={PP} P2={P2} window={window} nb_band={nb_band} "
        f"Ni_pad={pipe.Ni_pad}"
    )

    idx = pipe._idx
    core = P._query_core

    def run_prefix(stop: str):
        """Jitted prefix of _query_core, returning small checksums."""

        def fn(*all_args):
            out = core(
                *all_args, have_freq=bool(model.have_freq), T=pipe.T,
                P=PP, P2=P2, window=window, nb_band=nb_band,
                stop_stage=stop,
            )
            return out

        return jax.jit(fn)

    # assemble timing variants; stop_stage support is added to _query_core
    variants = [
        ("noop", "noop"),
        ("stageA", "stageA"),
        ("resolve_pre", "resolve_pre"),
        ("resolve_tables", "resolve_tables"),
        ("resolve", "resolve"),
        ("gather_dl", "gather_dl"),
        ("score", "score"),
        ("full_small", "compact_sum"),
        ("full", None),
    ]
    results = {}
    for name, stop in variants:
        if stop is None:
            fn = jax.jit(
                lambda *a: core(
                    *a, have_freq=bool(model.have_freq), T=pipe.T,
                    P=PP, P2=P2, window=window, nb_band=nb_band,
                )
            )
        else:
            fn = run_prefix(stop)
        # compile
        t0 = time.time()
        out = fn(*idx, *args)
        jax.block_until_ready(out)
        log(f"{name}: compiled+first in {time.time() - t0:.1f}s")
        reps = []
        for _ in range(12):
            t0 = time.perf_counter()
            out = fn(*idx, *args)
            jax.block_until_ready(out)
            reps.append(time.perf_counter() - t0)
        med = statistics.median(reps) * 1e3
        results[name] = med
        log(f"{name}: {med:.2f} ms (min {min(reps)*1e3:.2f})")

    order = [n for n, _ in variants]
    log("\n--- stage deltas ---")
    prev = 0.0
    for n in order:
        log(f"{n}: {results[n]:.2f} ms (delta {results[n] - prev:+.2f})")
        prev = results[n]


if __name__ == "__main__":
    main()
