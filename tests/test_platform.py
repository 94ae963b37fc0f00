"""What the program decides from the platform it runs on, and the smoke run.

  * the per-stage implementation choice (ops/pipeline.stage_impls);
  * the compile-cache directory rule;
  * ``chip_smoke.py``: its CPU rehearsal passes, and without a GPU it exits
    non-zero and prints no result.
"""

import json
import os
import subprocess
import sys

import pytest

from analiticcl_jax.ops import pipeline as pl
from analiticcl_jax.ops import stage_a

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,want_a,want_b",
    [
        ("cpu", stage_a.stage_a_masks_xla, pl.stage_b_xla),
        ("gpu", stage_a.stage_a_masks_triton, pl.stage_b_triton),
    ],
)
def test_stage_impls_by_platform(platform, want_a, want_b):
    assert pl.stage_impls(platform) == (want_a, want_b)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "cuda"])
def test_stage_impls_unknown_platform_is_an_error(platform):
    with pytest.raises(RuntimeError, match=platform):
        pl.stage_impls(platform)


def test_default_platform_is_jax_backend():
    assert pl.stage_impls() == pl.stage_impls("cpu")
    assert not pl.on_accelerator()


def test_compile_cache_dir_honours_environment():
    assert pl.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_compile_cache_dir_default_is_fixed_inside_checkout():
    d = pl.compile_cache_dir({})
    assert d == os.path.join(ROOT, ".jax_cache")
    assert d == pl.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""})
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(*args, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )


def test_chip_smoke_refuses_without_gpu():
    r = _run_smoke(timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_rehearsal(tmp_path):
    r = _run_smoke("--rehearse", "--out", str(tmp_path), timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == {
        "rehearsal": True,
        "phases": ["data", "kernels", "query", "search", "learn", "scale"],
    }
    assert '"ok": true' not in r.stdout
