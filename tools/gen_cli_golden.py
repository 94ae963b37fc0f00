#!/usr/bin/env python3
"""Generate the CLI golden-byte fixtures (tests/fixtures_cli/*).

Run ONCE after auditing the emitters against the reference's format strings
(/root/reference/src/bin/analiticcl.rs:21-367, see PARITY.md §2.6); the
committed fixtures then pin every byte of the TSV/JSON output surface so
emitter regressions are caught by tests/test_cli_golden.py.
"""

import io
import contextlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from cli_golden_cases import (  # noqa: E402
    FIXDIR,
    cases,
    fixture_bytes,
    small_lexicon,
)


def main():
    from analiticcl_jax.cli import main as cli_main

    os.makedirs(FIXDIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        lex = small_lexicon(tmp)
        for name, argv, stdin_lines, extra in cases(lex):
            buf = io.StringIO()
            stdin = io.StringIO("\n".join(stdin_lines) + "\n")
            old_stdin = sys.stdin
            sys.stdin = stdin
            try:
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(argv)
            finally:
                sys.stdin = old_stdin
            assert rc == 0, (name, rc)
            out = fixture_bytes(buf.getvalue(), extra)
            path = os.path.join(FIXDIR, name)
            with open(path, "w", encoding="utf-8") as f:
                f.write(out)
            print(f"{name}: {len(out.splitlines())} lines, {len(out)} bytes")


if __name__ == "__main__":
    main()
