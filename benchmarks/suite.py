"""Scenario benchmark suite, mirroring BASELINE.json's configs.

Each scenario prints one JSON line to stdout. Run:

    python benchmarks/suite.py [scenario ...]

Scenarios: query_eng, query_nld_freq, search_text, learn, build_1m
(default: all except build_1m).
"""

from __future__ import annotations

import functools
import json
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from analiticcl_jax import datagen
from analiticcl_jax.datagen import corrupt
from analiticcl_jax.models.variant_model import VariantModel
from analiticcl_jax.types import DistanceThreshold, SearchParameters
from analiticcl_jax.vocab import VocabParams, VocabType

@functools.lru_cache(maxsize=None)
def data() -> dict:
    """Lexicons generated from fixed seeds (analiticcl_jax.datagen) into a
    temporary directory on first use: an eng.aspell-scale one and a second
    at nld.aspell scale (222,908 entries)."""
    d = tempfile.mkdtemp(prefix="analiticcl_suite_")
    eng = datagen.make_dataset(os.path.join(d, "eng"), seed=0)
    nld = datagen.write_lexicon(
        os.path.join(d, "nld.tsv"), datagen.lexicon_words(222_908, 1),
        datagen.zipf_freqs(222_908, 1),
    )
    return {"dir": d, "alphabet": eng["alphabet"], "eng": eng["lexicon"],
            "nld": nld}

# per-scenario steady-state measurement budget (env-overridable for quick
# smoke runs and tight outage windows)
BUDGET_S = float(os.environ.get("ANALITICCL_BUDGET_S", "30"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _model(lexicon):
    model = VariantModel(alphabet_file=data()["alphabet"])
    model.read_vocabulary(lexicon, VocabParams())
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    model.set_backend("device")
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap

    freeze_model_heap()
    return model, build_s


def _util_snap(model):
    """Snapshot for the utilization meter: (wall, host process-CPU, stage
    totals of the device pipeline). The 'device' stage accumulates time the
    host spends BLOCKED on device results — with the host busy in between,
    it approximates the device-bound fraction of the wall clock."""
    pipe = getattr(model, "_device", None)
    stats = dict(pipe.stats.totals) if pipe is not None else {}
    return time.time(), time.process_time(), stats


def _util_report(model, snap):
    """Per-scenario utilization: host CPU fraction and device-wait fraction
    of the measured wall interval (VERDICT r3 directive: the suite must say
    how busy each side is, not just items/sec)."""
    wall0, cpu0, st0 = snap
    wall = time.time() - wall0
    if wall <= 0:
        return {}
    pipe = getattr(model, "_device", None)
    st1 = dict(pipe.stats.totals) if pipe is not None else {}
    dev_wait = st1.get("device", 0.0) - st0.get("device", 0.0)
    out = {
        "host_cpu_frac": round((time.process_time() - cpu0) / wall, 3),
        "device_wait_frac": round(dev_wait / wall, 3),
    }
    # tail_native nests inside the host_tail span — counting both would
    # double-count the native part (r04 logs did exactly that)
    tail = st1.get("host_tail", 0.0) - st0.get("host_tail", 0.0)
    if tail:
        out["rank_tail_frac"] = round(tail / wall, 3)
    # full per-stage wall deltas (seconds): the attribution behind the
    # fractions, so a slow scenario is diagnosable from the artifact alone
    stages = {
        k: round(st1.get(k, 0.0) - st0.get(k, 0.0), 3)
        for k in st1
        if st1.get(k, 0.0) - st0.get(k, 0.0) > 0.0005
    }
    if stages:
        out["stages_s"] = stages
        c1 = dict(pipe.stats.counts) if pipe is not None else {}
        out["stage_calls"] = {k: c1.get(k, 0) for k in stages}
    return out


def _throughput(model, queries, params, budget_s=None, batch=None):
    """Steady-state q/s: ONE continuous warm stream that cycles the query
    set until the time budget is met (a stream shorter than the budget
    would make pipeline fill/drain latency dominate the measurement).
    Returns (qps, utilization dict)."""
    budget_s = BUDGET_S if budget_s is None else budget_s
    if batch is None:  # device-batch knob (tools/sweep_knobs.py tunes it)
        # 8192 beats 4096 ~1.7x on the sync-overhead-dominated eng workload
        # (see bench.py); lexicons whose compile ceiling caps max_B lower
        # pass an explicit batch (build_1m/sharded_1m)
        batch = int(os.environ.get("ANALITICCL_QUERY_BATCH", "8192"))
    model.find_variants_batch(queries[:batch], params)  # compile
    # settle the sticky budgets through BOTH escalation and de-escalation:
    # deesc fires after DEESC_N non-overflow batches and recompiles at the
    # shrunken budget — in r5 a ~45 s mid-window recompile read as 882 q/s
    pipe = getattr(model, "_device", None)
    n_settle = 1 + (pipe.DEESC_N if pipe is not None else 6)
    for _ in range(n_settle):
        model.find_variants_batch(queries[:batch], params)
    tail = len(queries) % batch
    if tail:  # warm the final partial-batch bucket too
        model.find_variants_batch(queries[-tail:], params)

    def cycle():
        while True:
            yield from queries

    snap = _util_snap(model)
    t0 = time.time()
    done = 0
    for _res in model.find_variants_stream(cycle(), params, batch_size=batch):
        done += 1
        if done % batch == 0 and time.time() - t0 > budget_s:
            break
    qps = done / (time.time() - t0)
    return qps, _util_report(model, snap)


def query_eng():
    model, build_s = _model(data()["eng"])
    rng = random.Random(1)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    queries = [corrupt(w, rng) for w in words[:16384]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    qps, util = _throughput(model, queries, params)
    return {"scenario": "query_eng", "qps": round(qps, 1),
            "build_s": round(build_s, 2), **util}


def query_ratio():
    """Ratio thresholds (CLI ``-k 0.5 -d 0.3``): per-query distances scale
    with length, pushing long queries past edit distance 3 and compiling
    the production window-12 DL bucket (reference types.rs:75-108)."""
    model, build_s = _model(data()["eng"])
    rng = random.Random(5)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    queries = [corrupt(w, rng) for w in words[:16384]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_of(0.5),
        max_edit_distance=DistanceThreshold.ratio_of(0.3),
        max_matches=10,
    )
    qps, util = _throughput(model, queries, params)
    return {
        "scenario": "query_ratio",
        "qps": round(qps, 1),
        "build_s": round(build_s, 2),
        **util,
    }


def query_nld_freq():
    model, build_s = _model(data()["nld"])
    model.have_freq = True  # exercise frequency-weighted ranking
    rng = random.Random(2)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 13)]
    queries = [corrupt(w, rng) for w in words[:8192]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        freq_weight=1.0,
    )
    qps, util = _throughput(model, queries, params)
    return {
        "scenario": "query_nld_freq",
        "qps": round(qps, 1),
        "build_s": round(build_s, 2),
        **util,
    }


def search_text():
    model, build_s = _model(data()["eng"])
    rng = random.Random(3)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 17)]
    sentences = []
    for _ in range(512):
        sent = " ".join(corrupt(rng.choice(words), rng) for _ in range(12))
        sentences.append(sent + ".")
    text = "\n".join(sentences[:64])
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=5,
        max_ngram=2,
    )
    # CLI-shaped workload: 100-line groups streamed (device lookups for
    # group N+1 in flight while group N consolidates), as process_search does.
    # Steady state: cycle the groups in ONE continuous stream until the time
    # budget is met (a handful of groups would be fill/drain-dominated).
    groups = ["\n".join(sentences[i : i + 100]) for i in range(0, 512, 100)]
    tokens_of = [sum(len(s.split()) for s in g.split("\n")) for g in groups]
    model.find_all_matches(text, params)  # compile all shape variants
    for _ in range(3):  # settle budgets incl. the deesc recompile (>=6 units)
        list(model.find_all_matches_stream(groups, params))

    def cycle():
        while True:
            yield from groups

    budget_s = BUDGET_S
    depth = int(os.environ.get("ANALITICCL_SEARCH_DEPTH", "2"))
    snap = _util_snap(model)
    t0 = time.time()
    done_tokens = 0
    matches = 0
    for gi, out in enumerate(
        model.find_all_matches_stream(cycle(), params, depth=depth)
    ):
        done_tokens += tokens_of[gi % len(groups)]
        matches += len(out)
        if gi % len(groups) == len(groups) - 1 and time.time() - t0 > budget_s:
            break
    dt = time.time() - t0
    util = _util_report(model, snap)
    return {
        "scenario": "search_text",
        "tokens_per_s": round(done_tokens / dt, 1),
        "matches": matches,
        "build_s": round(build_s, 2),
        **util,
    }


def search_lm():
    """BASELINE configs[3]: running-text search with language-model context
    scoring. The LM (bigram counts over a synthetic corpus of lexicon words)
    forces the exact n-best object path (lattice DP + batched LM scoring);
    the array-native fast path covers the no-LM case (search_text)."""
    model = VariantModel(alphabet_file=data()["alphabet"])
    model.read_vocabulary(data()["eng"], VocabParams())
    rng = random.Random(8)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 17)]
    # synthetic corpus: sentences of real words; bigrams become LM entries
    lmp = VocabParams(vocab_type=VocabType.LM)
    bigrams = {}
    sentences = []
    for _ in range(512):
        toks = [rng.choice(words) for _ in range(12)]
        sentences.append(
            " ".join(corrupt(t, rng) for t in toks) + "."
        )
        for a, b in zip(toks, toks[1:]):
            key = f"{a} {b}"
            bigrams[key] = bigrams.get(key, 0) + 1
    for key, freq in bigrams.items():
        model.add_to_vocabulary(key, freq, lmp)
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    model.set_backend("device")
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap

    freeze_model_heap()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=5,
        max_ngram=2,
        lm_weight=1.0,
    )
    groups = ["\n".join(sentences[i : i + 100]) for i in range(0, 512, 100)]
    tokens_of = [sum(len(s.split()) for s in g.split("\n")) for g in groups]
    model.find_all_matches(groups[0], params)  # compile
    for _ in range(3):  # settle budgets incl. the deesc recompile
        list(model.find_all_matches_stream(groups, params))

    def cycle():
        while True:
            yield from groups

    depth = int(os.environ.get("ANALITICCL_SEARCH_DEPTH", "2"))
    snap = _util_snap(model)
    t0 = time.time()
    done_tokens = 0
    matches = 0
    for gi, out in enumerate(
        model.find_all_matches_stream(cycle(), params, depth=depth)
    ):
        done_tokens += tokens_of[gi % len(groups)]
        matches += len(out)
        if gi % len(groups) == len(groups) - 1 and time.time() - t0 > BUDGET_S:
            break
    dt = time.time() - t0
    util = _util_report(model, snap)
    return {
        "scenario": "search_lm",
        "tokens_per_s": round(done_tokens / dt, 1),
        "matches": matches,
        "build_s": round(build_s, 2),
        **util,
    }


def learn():
    model, build_s = _model(data()["eng"])
    rng = random.Random(4)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    corpus = [corrupt(w, rng) for w in words[:16384]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=3,
        score_threshold=0.7,
    )
    # compile exactly the bucket the strict-learn stream uses
    list(model.find_variants_stream(corpus, params))
    t0 = time.time()
    count = model.learn_variants(corpus, params, strict=True, auto_build=True)
    dt = time.time() - t0
    return {
        "scenario": "learn",
        "inputs_per_s": round(len(corpus) / dt, 1),
        "learned": count,
        "iteration_s": round(dt, 2),
        "phases": getattr(model, "learn_profile", None),
    }


def _make_1m_lexicon(path):
    """A generated 1M-entry lexicon (analiticcl_jax.datagen)."""
    words = datagen.lexicon_words(datagen.ROWS_1M, 5)
    datagen.write_lexicon(path, words, datagen.zipf_freqs(len(words), 5))


def build_1m():
    import os

    path = os.path.join(data()["dir"], "bench_1m.tsv")
    if not os.path.exists(path):
        _make_1m_lexicon(path)
    from analiticcl_jax.utils.gc_tuning import prewarm_heap

    # provision guest memory once up front: on lazily-backed VMs the first
    # touch of fresh pages costs 50-200 ms/MB (host-load dependent), which
    # would otherwise dominate the timed build
    prewarm_heap(768 * 1024 * 1024)
    model = VariantModel(alphabet_file=data()["alphabet"])
    t0 = time.time()
    model.read_vocabulary(path, VocabParams())
    load_s = time.time() - t0
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    model.set_backend("device")
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap

    freeze_model_heap()  # gen-2 GC over 1M decoder objects costs ~1s/pause
    rng = random.Random(6)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 211)]
    queries = [corrupt(w, rng) for w in words[:4096]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    # B=2048: the 1M-row batch ceiling (DevicePipeline.max_B)
    qps, util = _throughput(model, queries, params, budget_s=40.0, batch=2048)
    return {
        "scenario": "build_1m",
        "load_s": round(load_s, 2),
        "build_s": round(build_s, 2),
        "qps": round(qps, 1),
        **util,
    }


def confusables_errors():
    """BASELINE config[2]: confusable list + error list with weighted rescoring."""
    import os

    conf_path = os.path.join(data()["dir"], "confusables.tsv")
    with open(conf_path, "w", encoding="utf-8") as f:
        f.write("-[y]+[i]\t1.2\n-[s]+[f]\t1.1\n-[rn]+[m]\t1.2\n=[c]-[e]+[a]\t1.1\n")
    err_path = os.path.join(data()["dir"], "errors.tsv")
    with open(err_path, "w", encoding="utf-8") as f:
        f.write("their\tthier\t0.9\nreceive\trecieve\t0.9\nseparate\tseperate\t0.9\n")
    model = VariantModel(alphabet_file=data()["alphabet"])
    model.read_vocabulary(data()["eng"], VocabParams())
    model.read_variants(err_path, VocabParams(), transparent=True)
    model.read_confusablelist(conf_path)
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    model.set_backend("device")
    rng = random.Random(7)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 19)]
    queries = ([corrupt(w, rng) for w in words[:4096]] + [
        "thier", "recieve", "seperate"
    ]) * 4  # multiple stream batches so pipeline fill amortizes
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    qps, util = _throughput(model, queries, params)
    res = model.find_variants_batch(["thier"], params)[0]
    top = model.decoder[res[0].vocab_id].text if res else None
    return {
        "scenario": "confusables_errors",
        "qps": round(qps, 1),
        "build_s": round(build_s, 2),
        "thier_top": top,
        **util,
    }


def micro():
    """Host micro-benchmarks mirroring the reference's criterion set
    (/root/reference/benches/benchmarks.rs:6-159): anahash, count-vector
    algebra (insert/contains/delete), deletion iterators, tiny model build —
    plus the eng.aspell index build the reference never timed. Medians of
    repeated timed loops, reported in ns/op (ops/s for iterators)."""
    import statistics
    import timeit

    sys.path.insert(0, "tests")
    from fixtures import get_test_alphabet

    from analiticcl_jax import anahash as ah
    from analiticcl_jax.alphabet import AlphabetEncoder
    from analiticcl_jax.iterators import RecurseDeletionIterator
    from analiticcl_jax.types import Weights

    alphabet, _ = get_test_alphabet()
    enc = AlphabetEncoder(alphabet)

    def med_ns(fn, number=None):
        if number is None:
            # size the loop so one repeat runs ~20ms
            per = timeit.timeit(fn, number=100) / 100
            number = max(100, int(0.02 / max(per, 1e-9)))
        reps = [timeit.timeit(fn, number=number) / number for _ in range(7)]
        return statistics.median(reps) * 1e9

    out = {"scenario": "micro"}
    inputs = ["a", "rat", "houses", "benchmarking",
              "the lazy dog jumped over the quick brown fox"]
    for text in inputs:
        out[f"anahash_{len(text)}c_ns"] = round(med_ns(lambda: enc.count_vector(text)), 1)

    change = enc.count_vector("change")
    rat = enc.count_vector("houses")
    out["insert_ns"] = round(med_ns(lambda: ah.cv_insert(rat, change)), 1)
    out["contains_ns"] = round(med_ns(lambda: ah.cv_contains(rat, change)), 1)
    out["delete_ns"] = round(med_ns(lambda: ah.cv_delete(rat, change)), 1)

    for text in ["rat", "houses", "benchmarking"]:
        avv = enc.count_vector(text)
        n = len(text)
        out[f"iter_bfs_nodups_{n}c_ns"] = round(
            med_ns(
                lambda: sum(
                    1
                    for _ in RecurseDeletionIterator(
                        avv, breadthfirst=True, unique=True, empty_leaves=False
                    )
                )
            ),
            1,
        )

    simple = ["rites", "tiers", "tires", "tries", "tyres", "rides", "brides", "dire"]

    def build_tiny():
        m = VariantModel.new_with_alphabet(alphabet, Weights(), 0)
        for item in simple:
            m.add_to_vocabulary(item, None, VocabParams())
        m.build()

    out["model_init_and_build_ns"] = round(med_ns(build_tiny, number=20), 1)

    # full-lexicon index build (reference README shows it as startup work)
    reps = []
    for _ in range(3):
        m = VariantModel(alphabet_file=data()["alphabet"])
        m.read_vocabulary(data()["eng"], VocabParams())
        t0 = time.time()
        m.build()
        reps.append(time.time() - t0)
    out["build_eng_aspell_s"] = round(statistics.median(reps), 3)
    return out


def sharded_query():
    """Query throughput through the ShardedPipeline (mesh path) on a 1x1
    mesh over one card — the same shard_map program as a multi-card mesh
    (dp x lex), so it times the collective/merge overhead the mesh path
    adds (SURVEY.md §2.8; tests/test_mesh.py validates bit-parity on a
    virtual 8-device CPU mesh)."""
    import jax

    from analiticcl_jax.parallel.mesh import ShardedPipeline, make_mesh

    model, build_s = _model(data()["eng"])
    mesh = make_mesh(jax.devices()[:1], dp=1)
    pipe = ShardedPipeline(model, mesh)
    rng = random.Random(1)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 7)]
    queries = [corrupt(w, rng) for w in words[:16384]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    batch = 4096
    pipe.collect(pipe.submit(queries[:batch], params))  # compile
    pipe.collect(pipe.submit(queries[:batch], params))  # settle budgets
    batches = [queries[i : i + batch] for i in range(0, len(queries), batch)]
    t0 = time.time()
    done = 0
    for res in pipe.find_variants_stream(batches, params):
        done += len(res)
    qps = done / (time.time() - t0)
    return {
        "scenario": "sharded_query",
        "qps": round(qps, 1),
        "mesh": f"{mesh.shape['dp']}x{mesh.shape['lex']}",
        "build_s": round(build_s, 2),
    }


def sharded_1m():
    """The 1M-entry background lexicon (BASELINE configs[4]) through the
    ShardedPipeline — the scenario lexicon sharding exists for (SURVEY §7
    stage 7), here on a 1x1 mesh; with n lex shards each holds 1/n of the
    rows, shrinking every per-shard stage linearly (tests/test_mesh.py
    proves bit-parity on a virtual 8-device CPU mesh, and
    ``python chip_smoke.py --four`` runs it on four cards)."""
    import os

    import jax

    from analiticcl_jax.parallel.mesh import ShardedPipeline, make_mesh
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap, prewarm_heap

    path = os.path.join(data()["dir"], "bench_1m.tsv")
    if not os.path.exists(path):
        _make_1m_lexicon(path)
    prewarm_heap(768 * 1024 * 1024)
    model = VariantModel(alphabet_file=data()["alphabet"])
    model.read_vocabulary(path, VocabParams())
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    mesh = make_mesh(jax.devices()[:1], dp=1)
    pipe = ShardedPipeline(model, mesh)
    freeze_model_heap()
    rng = random.Random(6)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 211)]
    queries = [corrupt(w, rng) for w in words[:4096]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
    )
    batch = min(2048, pipe.max_B)  # see build_1m: optimal at 1M single-chip
    pipe.collect(pipe.submit(queries[:batch], params))  # compile
    for _ in range(1 + pipe.DEESC_N):  # settle budgets incl. deesc recompile
        pipe.collect(pipe.submit(queries[:batch], params))
    batches = [queries[i : i + batch] for i in range(0, len(queries), batch)]

    def batch_cycle():
        # ONE continuous stream (restarting the stream per pass pays the
        # pipeline fill/drain every 2 batches — measured ~35% of wall here)
        while True:
            yield from batches

    t0 = time.time()
    done = 0
    for res in pipe.find_variants_stream(batch_cycle(), params):
        done += len(res)
        if done % len(queries) == 0 and time.time() - t0 > BUDGET_S:
            break
    qps = done / (time.time() - t0)
    return {
        "scenario": "sharded_1m",
        "qps": round(qps, 1),
        "mesh": f"{mesh.shape['dp']}x{mesh.shape['lex']}",
        "build_s": round(build_s, 2),
        "batch": batch,
    }


def learn_1m():
    """BASELINE configs[4]: iterative variant learning against the 1M-entry
    background lexicon through the sharded pipeline (mesh 1x1 here; the
    same program compiles and runs on 2x4 in dryrun_multichip)."""
    import os

    import jax

    from analiticcl_jax.parallel.mesh import make_mesh
    from analiticcl_jax.utils.gc_tuning import freeze_model_heap, prewarm_heap

    path = os.path.join(data()["dir"], "bench_1m.tsv")
    if not os.path.exists(path):
        _make_1m_lexicon(path)
    prewarm_heap(768 * 1024 * 1024)
    model = VariantModel(alphabet_file=data()["alphabet"])
    model.read_vocabulary(path, VocabParams())
    t0 = time.time()
    model.build()
    build_s = time.time() - t0
    model.use_mesh(make_mesh(jax.devices()[:1], dp=1))
    freeze_model_heap()
    rng = random.Random(9)
    words = [model.decoder[i].text for i in range(3, len(model.decoder), 131)]
    corpus = [corrupt(w, rng) for w in words[:7000]]
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=3,
        score_threshold=0.7,
    )
    # warm the EXACT batch buckets the strict-learn stream will use (its
    # bs = min(4096, pipe.max_B), plus the tail batch's bucket): a fused
    # compile must not land inside the timed iteration
    from analiticcl_jax.ops.pipeline import get_device_pipeline

    pipe = model._device or get_device_pipeline(model)
    bs = min(4096, pipe.max_B)
    model.find_variants_batch(corpus[:bs], params)
    model.find_variants_batch(corpus[:bs], params)  # settle budgets
    tail = len(corpus) % bs
    if tail:
        model.find_variants_batch(corpus[-tail:], params)
    t0 = time.time()
    count = model.learn_variants(corpus, params, strict=True, auto_build=True)
    dt = time.time() - t0
    pipe = model._device
    stages = (
        {k: round(v, 3) for k, v in pipe.stats.totals.items()}
        if pipe is not None
        else None
    )
    return {
        "scenario": "learn_1m",
        "inputs_per_s": round(len(corpus) / dt, 1),
        "learned": count,
        "iteration_s": round(dt, 2),
        "build_s": round(build_s, 2),
        "phases": getattr(model, "learn_profile", None),
        "pipe_stages": stages,
    }


SCENARIOS = {
    "query_eng": query_eng,
    "micro": micro,
    "query_ratio": query_ratio,
    "query_nld_freq": query_nld_freq,
    "search_text": search_text,
    "search_lm": search_lm,
    "learn": learn,
    "build_1m": build_1m,
    "confusables_errors": confusables_errors,
    "sharded_query": sharded_query,
    "sharded_1m": sharded_1m,
    "learn_1m": learn_1m,
}


def main():
    names = sys.argv[1:] or ["query_eng", "query_nld_freq", "search_text", "learn"]
    for name in names:
        log(f"=== {name} ===")
        t0 = time.time()
        result = SCENARIOS[name]()
        log(f"({name} took {time.time() - t0:.1f}s total)")
        from analiticcl_jax.utils.provenance import stamp

        print(json.dumps(stamp(result)), flush=True)


if __name__ == "__main__":
    main()
