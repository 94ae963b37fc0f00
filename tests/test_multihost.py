"""Multi-host (DCN) initialization path smoke tests.

A real multi-host run calls parallel.mesh.initialize_distributed (a
jax.distributed.initialize passthrough) before building the mesh. No second
host exists in CI, so these tests exercise the single-process DCN
bootstrap — a real coordinator bind/handshake on localhost with
num_processes=1 — and verify the mesh/sharding path still works afterwards.
"""

import os
import socket

import jax
import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(
    os.environ.get("ANALITICCL_DCN_SMOKE") != "1",
    reason=(
        "jax.distributed.initialize is a process-global singleton; run "
        "separately with ANALITICCL_DCN_SMOKE=1 so it cannot leak into "
        "other tests"
    ),
)
def test_dcn_initialize_single_process():
    from analiticcl_jax.parallel.mesh import initialize_distributed

    port = _free_port()
    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=1,
        process_id=0,
    )
    assert jax.process_count() == 1
    assert jax.process_index() == 0

    # the mesh path works under the distributed runtime
    from analiticcl_jax.models.variant_model import VariantModel
    from analiticcl_jax.parallel.mesh import make_mesh
    from analiticcl_jax.types import SearchParameters, Weights
    from analiticcl_jax.vocab import VocabParams

    from fixtures import TEST_ALPHABET, get_test_searchparams

    model = VariantModel.new_with_alphabet(TEST_ALPHABET, Weights(), 0)
    for text in ["rites", "tiers", "tires", "tries", "dire"]:
        model.add_to_vocabulary(text, None, VocabParams())
    model.build()
    mesh = make_mesh(jax.devices(), dp=1)
    model.use_mesh(mesh)
    res = model.find_variants_batch(["rite"], get_test_searchparams())
    assert res and res[0]
    jax.distributed.shutdown()


def test_initialize_distributed_signature():
    """The passthrough forwards kwargs verbatim to jax.distributed.initialize
    (the production entry point for multi-host DCN runs)."""
    import inspect

    from analiticcl_jax.parallel import mesh

    sig = inspect.signature(jax.distributed.initialize)
    assert "coordinator_address" in sig.parameters
    assert mesh.initialize_distributed.__wrapped__ is jax.distributed.initialize \
        if hasattr(mesh.initialize_distributed, "__wrapped__") \
        else callable(mesh.initialize_distributed)
