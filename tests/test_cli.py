"""CLI end-to-end tests (subprocess, oracle backend for speed)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "/root/reference/examples/simple.alphabet.tsv"
AMPHIBIANS = "/root/reference/bindings/python/tests/amphibians.tsv"
REPTILES = "/root/reference/bindings/python/tests/reptiles.tsv"

ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def run_cli(args, stdin=""):
    proc = subprocess.run(
        [sys.executable, "-m", "analiticcl_jax.cli", *args],
        input=stdin,
        capture_output=True,
        text=True,
        cwd=REPO,
        env=ENV,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_query_tsv():
    out = run_cli(
        ["query", "-a", ALPHABET, "-l", AMPHIBIANS, "--backend", "oracle"],
        stdin="frog\nsaalamander\n",
    )
    lines = out.strip().split("\n")
    assert lines[0].startswith("frog\tfrog\t1\t")
    assert "salamander" in lines[1]


def test_query_json():
    out = run_cli(
        ["query", "-a", ALPHABET, "-l", AMPHIBIANS, "--backend", "oracle", "--json"],
        stdin="frog\n",
    )
    data = json.loads(out)
    assert data[0]["input"] == "frog"
    assert data[0]["variants"][0]["text"] == "frog"
    assert data[0]["variants"][0]["score"] == 1


def test_query_lexmatch():
    out = run_cli(
        [
            "query", "-a", ALPHABET, "-l", AMPHIBIANS, "-l", REPTILES,
            "--backend", "oracle", "--output-lexmatch",
        ],
        stdin="lizard\n",
    )
    assert REPTILES in out
    assert f'"{AMPHIBIANS}' not in out.split("\n")[0].split("lizard\t")[-1].split("\t")[0]


def test_search_mode():
    out = run_cli(
        [
            "search", "-a", ALPHABET, "-l", AMPHIBIANS, "--backend", "oracle",
            "-N", "1",
        ],
        stdin="a frog and a salamandr\n",
    )
    assert "salamandr\t" in out
    assert "salamander" in out
    assert ":" in out  # offsets


def test_index_mode():
    out = run_cli(
        ["index", "-a", ALPHABET, "-l", AMPHIBIANS, "--backend", "oracle"],
    )
    lines = out.strip().split("\n")
    assert lines
    first = lines[0].split("\t")
    assert first[0].isdigit()  # anagram value
    assert len(first) >= 2  # at least one word


def test_learn_mode():
    out = run_cli(
        [
            "learn", "-a", ALPHABET, "-l", AMPHIBIANS, "--backend", "oracle",
            "--strict", "-t", "0.5",
        ],
        stdin="frgo\nfrgo\n",
    )
    # learned variant list: reference word followed by variant/score pairs
    assert "frog\tfrgo\t" in out


def test_testinput_mode():
    out = run_cli(["testinput", "-a", ALPHABET], stdin="hello\n")
    assert out.startswith("OK: hello\t")


def test_search_with_lm(tmp_path):
    """LM-driven bigram selection through the CLI (reference test0702 shape)."""
    lex = tmp_path / "lex.tsv"
    lex.write_text(
        "I\t2\nthink\t2\nsink\t2\nyou\t2\nare\t2\nright\t2\nare right\t2\n"
    )
    lm = tmp_path / "lm.tsv"
    lm.write_text(
        "<bos> I\t2\nI think\t2\nI sink\t1\nyou are\t2\nright <eos>\t2\n"
    )
    out = run_cli(
        [
            "search", "-a", ALPHABET, "-l", str(lex), "--lm", str(lm),
            "--backend", "oracle", "-t", "0.0", "-T", "0",
        ],
        stdin="I tink you are rihgt\n",
    )
    lines = out.strip().split("\n")
    texts = [l.split("\t")[0] for l in lines]
    assert texts == ["I", "tink", "you", "are rihgt"]
    assert "\tthink\t" in lines[1]
    assert "\tare right\t" in lines[3]


def test_import_analiticcl_shim():
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import analiticcl; m = analiticcl.VariantModel("
            f"'{ALPHABET}', analiticcl.Weights()); print('shim ok')",
        ],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=ENV,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert "shim ok" in proc.stdout


def test_fmt_float_rust_display_semantics():
    """Rust's `{}` f64 Display: shortest round-trip digits, plain decimal
    (never scientific), integers without '.0' (bin emitters rely on this for
    byte-exact TSV/JSON parity)."""
    from analiticcl_jax.cli import _fmt_float

    cases = [
        (1.0, "1"),
        (0.0, "0"),
        (0.734375, "0.734375"),
        (0.7083333333333334, "0.7083333333333334"),
        (1e-05, "0.00001"),
        (1.5e-07, "0.00000015"),
        (1e-09, "0.000000001"),
        (1e16, "10000000000000000"),
        (1.23e17, "123000000000000000"),
        (-0.5, "-0.5"),
        (-1e-06, "-0.000001"),
    ]
    for x, want in cases:
        got = _fmt_float(x)
        assert got == want, (x, got, want)
        # round-trip: the printed form must parse back to the same float
        assert float(got) == x


def test_search_per_line_and_linebreaks(tmp_path):
    """--per-line isolates each line in its own batch; the default folds
    linebreaks to spaces while --retain-linebreaks keeps them
    (reference bin:559-636 semantics)."""
    import contextlib
    import io
    import sys as _sys

    from analiticcl_jax.cli import main as cli_main

    from cli_golden_cases import REF_ALPHA, small_lexicon

    lexicon = small_lexicon(str(tmp_path))
    common = [
        "search", "-a", REF_ALPHA, "-l", lexicon, "--backend", "oracle",
        "-n", "2", "-N", "1",
    ]
    text = "separatly\nhuis\n"

    def run(argv):
        buf = io.StringIO()
        old = _sys.stdin
        _sys.stdin = io.StringIO(text)
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
        finally:
            _sys.stdin = old
        assert rc == 0
        return buf.getvalue()

    folded = run(common)
    per_line = run(common + ["--per-line"])
    retained = run(common + ["--retain-linebreaks"])
    # all three must find both words; outputs stay line-per-match TSV
    for out in (folded, per_line, retained):
        assert "separatly" in out and "huis" in out
    # folded batch: global offsets (linebreak folded to a space keeps
    # byte positions); per-line: offsets restart per line
    assert "huis\t10:14" in folded and "huis\t10:14" in retained
    assert "huis\t0:4" in per_line
