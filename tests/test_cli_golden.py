"""CLI emitter byte-parity: current output vs committed golden fixtures.

The fixtures (tests/fixtures_cli/*) were generated by tools/gen_cli_golden.py
after a line-by-line audit of the emitters against the reference's format
strings (/root/reference/src/bin/analiticcl.rs:21-367; divergences documented
in PARITY.md §2.6). Any byte change in the TSV/JSON output surface —
separators, float formatting, indentation, field order, envelope — fails
here. Regenerate deliberately with tools/gen_cli_golden.py.
"""

import contextlib
import io
import os
import sys

import pytest

from cli_golden_cases import FIXDIR, cases, fixture_bytes, small_lexicon


@pytest.fixture(scope="module")
def lexicon(tmp_path_factory):
    return small_lexicon(str(tmp_path_factory.mktemp("goldenlex")))


def _run_cli(argv, stdin_lines, extra):
    from analiticcl_jax.cli import main as cli_main

    buf = io.StringIO()
    stdin = io.StringIO("\n".join(stdin_lines) + "\n")
    old_stdin = sys.stdin
    sys.stdin = stdin
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
    finally:
        sys.stdin = old_stdin
    assert rc == 0
    return fixture_bytes(buf.getvalue(), extra)


@pytest.mark.parametrize("case_index", range(13))
def test_cli_output_matches_golden(lexicon, case_index):
    name, argv, stdin_lines, extra = cases(lexicon)[case_index]
    fixture = os.path.join(FIXDIR, name)
    with open(fixture, encoding="utf-8") as f:
        want = f.read()
    got = _run_cli(argv, stdin_lines, extra)
    if got != want:
        got_lines = got.splitlines()
        want_lines = want.splitlines()
        for i, (g, w) in enumerate(zip(got_lines, want_lines)):
            assert g == w, f"{name} line {i + 1}:\n  got:  {g!r}\n  want: {w!r}"
        assert len(got_lines) == len(want_lines), (
            f"{name}: line count {len(got_lines)} != {len(want_lines)}"
        )
        raise AssertionError(f"{name}: outputs differ")
