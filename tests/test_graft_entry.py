"""Driver entry-point regression tests.

Round-5 lesson: a signature change to ops/pipeline._query_core (the k_len
stage-A cap) silently broke __graft_entry__.entry() — the driver's
compile-check surface — while the whole suite stayed green. Tracing the
tiny-model fused program takes ~5 min even via jax.eval_shape (the Pallas
grid trace dominates), so the full trace stays behind ANALITICCL_SLOW_TESTS;
the cheap arity check below always runs and catches exactly the breakage
that happened.
"""

import inspect
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_args_match_query_core_signature():
    import __graft_entry__ as g
    from analiticcl_jax.ops.pipeline import _query_core

    fn, args = g.entry()
    sig = inspect.signature(_query_core)
    positional = [
        p for p in sig.parameters.values()
        if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
        and p.default is inspect.Parameter.empty
    ]
    bound = set(fn.keywords)
    missing = [p.name for p in positional if p.name not in bound]
    assert len(args) == len(missing), (
        f"entry() packs {len(args)} example args but _query_core expects "
        f"{len(missing)} unbound positionals: {missing}"
    )


@pytest.mark.skipif(
    not os.environ.get("ANALITICCL_SLOW_TESTS"),
    reason="~5 min trace; set ANALITICCL_SLOW_TESTS=1",
)
def test_entry_traces():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    jax.eval_shape(fn, *args)
