"""Command-line interface: query, search, learn, index, testinput.

Parity target: /root/reference/src/bin/analiticcl.rs (clap v2 CLI, 5
subcommands, TSV/JSON emitters, batching drivers). Batching here feeds the
device pipeline instead of rayon threads.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import IO, List, Optional, Sequence, Tuple

from .models.variant_model import VariantModel
from .search import Offset
from .types import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantResult,
    Weights,
)
from .vocab import VocabParams, VocabType

# the reference caps query batches at 1000 lines (bin/analiticcl.rs) to bound
# rayon memory; here the batch is the device dispatch unit, and 4096 queries
# per fused call amortize the per-call cost — output is identical, only the
# progress-meter cadence changes
MAX_BATCHSIZE = 4096
MAX_BATCHSIZE_SEARCH = 100


def _fmt_float(x: float) -> str:
    """Rust-style float Display: shortest round-trip digits, integers without
    '.0', and NEVER scientific notation (Rust's `{}` always prints plain
    decimal; Python's repr switches to exponents below 1e-4 / at 1e16)."""
    if x != x:
        return "NaN"
    if x in (float("inf"), float("-inf")):
        return "inf" if x > 0 else "-inf"
    if x == int(x) and abs(x) < 1e16:
        return str(int(x))
    s = repr(x)
    if "e" not in s and "E" not in s:
        return s
    from decimal import Decimal

    return format(Decimal(s), "f")


class _ResourceAction(argparse.Action):
    """Records lexicon/variant/error resources in exact argument order
    (reference bin:1028-1068: order drives lexindex bitmask semantics)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if not hasattr(namespace, "ordered_resources"):
            namespace.ordered_resources = []
        kind = {
            "--lexicon": "lexicon",
            "-l": "lexicon",
            "--variants": "variants",
            "-V": "variants",
            "--errors": "errors",
            "-E": "errors",
        }[option_string]
        namespace.ordered_resources.append((kind, values))


def _common_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--lexicon", "-l", action=_ResourceAction, metavar="FILE",
                        help="Lexicon against which matches are made (may be used multiple times)")
    parser.add_argument("--variants", "-V", action=_ResourceAction, metavar="FILE",
                        help="Weighted variant list (may be used multiple times)")
    parser.add_argument("--errors", "-E", action=_ResourceAction, metavar="FILE",
                        help="Weighted variant list in which variants are errors (transparent)")
    parser.add_argument("--alphabet", "-a", required=True, metavar="FILE",
                        help="Alphabet file")
    parser.add_argument("--confusables", "-C", action="append", default=[], metavar="FILE",
                        help="Confusable list with weights (sesdiff edit scripts)")
    parser.add_argument("--early-confusables", action="store_true",
                        help="Process confusables before pruning rather than after")
    parser.add_argument("--contextrules", "-R", action="append", default=[], metavar="FILE",
                        help="Context rules TSV")
    parser.add_argument("--output-lexmatch", action="store_true",
                        help="Output the matching lexicon name for each variant match")
    parser.add_argument("--json", "-j", action="store_true",
                        help="Output JSON instead of TSV")
    parser.add_argument("--progress", action="store_true", help="Show progress")
    parser.add_argument("--stop-exact", "-s", action="store_true",
                        help="Do not continue looking for variants once an exact match is found")
    parser.add_argument("--score-threshold", "-t", type=float, default=0.25)
    parser.add_argument("--cutoff-threshold", "-T", type=float, default=2.0)
    parser.add_argument("--freq-ranking", "-F", type=float, default=None,
                        help="Weight of the frequency component in ranking")
    parser.add_argument("--single-thread", "-1", action="store_true")
    parser.add_argument("--interactive", "-x", action="store_true",
                        help="Interactive mode (per-line, unbatched)")
    parser.add_argument("--backend", choices=("auto", "device", "oracle"),
                        default="auto",
                        help="Query backend: device (JAX), oracle (numpy host), auto")
    parser.add_argument("--weight-ld", type=float, default=0.5)
    parser.add_argument("--weight-lcs", type=float, default=0.125)
    parser.add_argument("--weight-prefix", type=float, default=0.125)
    parser.add_argument("--weight-suffix", type=float, default=0.125)
    parser.add_argument("--weight-case", type=float, default=0.125)
    parser.add_argument("--max-anagram-distance", "-k", default="3",
                        help="Absolute (int), ratio (0-1 float), or 'ratio;limit'")
    parser.add_argument("--max-edit-distance", "-d", default="2",
                        help="Absolute (int), ratio (0-1 float), or 'ratio;limit'")
    parser.add_argument("--max-matches", "-n", type=int, default=10)
    parser.add_argument("--unicode-offsets", "-u", action="store_true",
                        help="Output offsets in unicode points rather than UTF-8 bytes")
    parser.add_argument("files", nargs="*", help="Input files (default: stdin)")


def _search_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--per-line", action="store_true",
                        help="Process per line (n-grams never cross line boundaries)")
    parser.add_argument("--retain-linebreaks", action="store_true",
                        help="Retain linebreaks instead of treating them as spaces")
    parser.add_argument("--max-ngram-order", "-N", type=int, default=3)
    parser.add_argument("--max-seq", "-Q", type=int, default=250)
    parser.add_argument("--lm", action="append", default=[], metavar="FILE",
                        help="Language model n-gram frequency list")
    parser.add_argument("--lm-order", "-L", type=int, default=3)
    parser.add_argument("--weight-lm", type=float, default=1.0)
    parser.add_argument("--weight-variant-model", type=float, default=3.0)
    parser.add_argument("--weight-contextrules", type=float, default=1.0)
    parser.add_argument("--weight-context", type=float, default=0.0)
    parser.add_argument("--allow-overlap", action="store_true",
                        help="Return all matches as-is without consolidation")


def build_argparser() -> argparse.ArgumentParser:
    root = argparse.ArgumentParser(
        prog="analiticcl-jax",
        description="Approximate string matching on the GPU "
        "(spelling correction / text normalisation)",
    )
    root.add_argument("--debug", "-D", type=int, default=0)
    sub = root.add_subparsers(dest="command")
    for name, extra in (
        ("query", False),
        ("search", True),
        ("learn", True),
        ("index", False),
        ("testinput", False),
    ):
        p = sub.add_parser(name)
        _common_arguments(p)
        if extra:
            _search_arguments(p)
        if name == "learn":
            p.add_argument("--iterations", "-I", type=int, default=1)
            p.add_argument("--multi-output", "-O", action="store_true",
                           help="Write variant lists to per-lexicon output files")
            p.add_argument("--strict", action="store_true")
    return root


# ---------------------------------------------------------------------------
# Output emitters (reference bin:21-367)
# ---------------------------------------------------------------------------


def output_result_as_tsv(
    model: VariantModel, result: VariantResult, output_lexmatch: bool,
    freq_weight: float, out: IO,
) -> None:
    value = model.get_vocab(result.vocab_id)
    out.write(f"\t{value.text}\t{_fmt_float(result.score(freq_weight))}\t")
    if output_lexmatch:
        lexicons = [
            name for i, name in enumerate(model.lexicons) if value.in_lexicon(i)
        ]
        out.write('\t"' + ";".join(lexicons) + '"')


def output_matches_as_tsv(
    model: VariantModel,
    input_text: str,
    variants: Optional[List[VariantResult]],
    selected: Optional[int],
    offset: Optional[Offset],
    output_lexmatch: bool,
    freq_weight: float,
    out: Optional[IO] = None,
) -> None:
    out = out if out is not None else sys.stdout
    out.write(input_text)
    if offset is not None:
        out.write(f"\t{offset.begin}:{offset.end}")
    if variants is not None:
        if selected is not None and 0 <= selected < len(variants):
            output_result_as_tsv(
                model, variants[selected], output_lexmatch, freq_weight, out
            )
        for i, result in enumerate(variants):
            if selected is None or selected != i:
                output_result_as_tsv(model, result, output_lexmatch, freq_weight, out)
    out.write("\n")


def _json_escape(s: str) -> str:
    return s.replace('"', '\\"')


def output_result_as_json(
    model: VariantModel, result: VariantResult, output_lexmatch: bool,
    freq_weight: float, out: IO,
) -> None:
    value = model.get_vocab(result.vocab_id)
    out.write(
        f'        {{ "text": "{_json_escape(value.text)}", '
        f'"score": {_fmt_float(result.score(freq_weight))}'
    )
    out.write(f', "dist_score": {_fmt_float(result.dist_score)}')
    out.write(f', "freq_score": {_fmt_float(result.freq_score)}')
    if result.via is not None:
        via = model.get_vocab(result.via)
        out.write(f', "via": "{_json_escape(via.text)}"')
    if output_lexmatch:
        lexicons = [
            f'"{_json_escape(name)}"'
            for i, name in enumerate(model.lexicons)
            if value.in_lexicon(i)
        ]
        out.write(f', "lexicons": [ {", ".join(lexicons)} ]')
    out.write(" }")


def output_matches_as_json(
    model: VariantModel,
    input_text: str,
    variants: Optional[List[VariantResult]],
    selected: Optional[int],
    offset: Optional[Offset],
    output_lexmatch: bool,
    freq_weight: float,
    seqnr: int,
    tag: List[int],
    tag_seqnr: List[int],
    out: Optional[IO] = None,
) -> None:
    out = out if out is not None else sys.stdout
    out.write("    ," if seqnr > 1 else "    ")
    out.write(f'{{ "input": "{_json_escape(input_text)}"')
    if offset is not None:
        out.write(f', "begin": {offset.begin}, "end": {offset.end}')
    if tag:
        tags = ",".join(f'"{model.tags[t]}"' for t in tag)
        seqnrs = ",".join(str(s) for s in tag_seqnr)
        out.write(f', "tag": [{tags}], "seqnr": [ {seqnrs}]')
    if variants is not None:
        out.write(', "variants": [ \n')
        wrote = False
        if selected is not None and 0 <= selected < len(variants):
            output_result_as_json(
                model, variants[selected], output_lexmatch, freq_weight, out
            )
            wrote = True
        for i, result in enumerate(variants):
            if selected is None or selected != i:
                if wrote:
                    out.write(",\n")
                output_result_as_json(model, result, output_lexmatch, freq_weight, out)
                wrote = True
        # reference: println!("") then println!("    ] }}") (bin:142-143)
        out.write("\n    ] }\n")
    else:
        out.write(" }\n")


def output_weighted_variants_as_tsv(
    model: VariantModel, multioutput: bool, out: Optional[IO] = None
) -> None:
    """Learn-mode TSV emitter (reference bin:190-268).

    Deliberate divergences from the reference, documented in PARITY.md: the
    reference's multi-output lexindex filter is broken (``lexindex & (1<<i)
    == i << i``, bin:202 — writes rows to the WRONG per-lexicon files); this
    emitter uses the correct membership test. File rows keep the reference's
    layout (leading tab, text/score/freq) and files are truncated per run
    (File::create semantics), and the head word still goes to stdout even in
    multi-output mode, exactly as the reference's outer loop does.
    """
    from .types import VariantReferenceKind

    out = out if out is not None else sys.stdout
    outfiles = {}
    for item in model.decoder:
        if item.variants is None:
            continue
        first = True
        for variant in item.variants:
            if variant.kind is not VariantReferenceKind.REFERENCE_FOR:
                continue
            variantitem = model.decoder[variant.vocab_id]
            # head word goes to stdout in BOTH modes (reference bin:245-248)
            if first:
                out.write(item.text)
                first = False
            if multioutput:
                for lexindex in range(len(model.lexicons)):
                    if not variantitem.in_lexicon(lexindex):
                        continue
                    f = outfiles.get(lexindex)
                    if f is None:
                        f = open(
                            f"{model.lexicons[lexindex]}.variants.tsv",
                            "w",
                            encoding="utf-8",
                        )
                        outfiles[lexindex] = f
                    f.write(
                        f"\t{variantitem.text}\t{_fmt_float(variant.score)}"
                        f"\t{variantitem.frequency}\n"
                    )
            else:
                out.write(f"\t{variantitem.text}\t{_fmt_float(variant.score)}")
        if not first:
            out.write("\n")
    for f in outfiles.values():
        f.close()


def output_weighted_variants_as_json(
    model: VariantModel, multioutput: bool, out: Optional[IO] = None
) -> None:
    """Learn-mode JSON emitter (reference bin:271-367).

    Multi-output writes per-lexicon ``<lexicon>.variants.json`` row files
    while the skeleton stays on stdout, as the reference does. Deliberate
    divergence (PARITY.md): the reference's multi-output row format swaps
    the score and freq values (format args reversed, bin:311-316) and
    double-spaces after "text"; this emitter writes them correctly.
    """
    from .types import VariantReferenceKind

    out = out if out is not None else sys.stdout
    outfiles = {}
    out.write("{\n")
    for item in model.decoder:
        first = True
        if item.variants is not None:
            for variant in item.variants:
                if variant.kind is not VariantReferenceKind.REFERENCE_FOR:
                    continue
                variantitem = model.decoder[variant.vocab_id]
                if first:
                    out.write(f'    "{_json_escape(item.text)}": [ \n')
                    first = False
                if multioutput:
                    for lexindex in range(len(model.lexicons)):
                        if not variantitem.in_lexicon(lexindex):
                            continue
                        f = outfiles.get(lexindex)
                        if f is None:
                            f = open(
                                f"{model.lexicons[lexindex]}.variants.json",
                                "w",
                                encoding="utf-8",
                            )
                            outfiles[lexindex] = f
                        f.write(
                            f'        {{ "text": '
                            f'"{_json_escape(variantitem.text)}", '
                            f'"score": {_fmt_float(variant.score)}, '
                            f'"freq": {variantitem.frequency} }}, '
                        )
                else:
                    out.write(
                        f'        {{ "text": "{_json_escape(variantitem.text)}", '
                        f'"score": {_fmt_float(variant.score)}, '
                        f'"freq": {variantitem.frequency} }}, \n'
                    )
        if not first:
            out.write("    ]\n")
    out.write("}\n")
    for f in outfiles.values():
        f.close()


# ---------------------------------------------------------------------------
# Drivers (reference bin:369-654)
# ---------------------------------------------------------------------------


def _show_progress(seqnr: int, lasttime: float, batchsize: int) -> float:
    now = time.time()
    if lasttime >= now or seqnr <= 1:
        print(f"@ {seqnr}", file=sys.stderr)
    else:
        rate = batchsize / (now - lasttime)
        print(
            f"@ {seqnr} - processing speed was {rate:.0f} items per second",
            file=sys.stderr,
        )
    return now


def process_batched(
    model: VariantModel,
    stream: IO,
    params: SearchParameters,
    output_lexmatch: bool,
    json_out: bool,
    progress: bool,
    batchsize: int = MAX_BATCHSIZE,
) -> None:
    """Batched query driver (replaces the reference's process/process_par)."""
    seqnr = 0
    progresstime = time.time()
    batch: List[str] = []

    def flush():
        nonlocal seqnr, progresstime
        if not batch:
            return
        results = model.find_variants_batch(batch, params)
        for input_text, variants in zip(batch, results):
            seqnr += 1
            if json_out:
                output_matches_as_json(
                    model, input_text, variants, 0, None, output_lexmatch,
                    params.freq_weight, seqnr, [], [],
                )
            else:
                output_matches_as_tsv(
                    model, input_text, variants, 0, None, output_lexmatch,
                    params.freq_weight,
                )
        if progress:
            progresstime = _show_progress(seqnr, progresstime, len(batch))
        batch.clear()
        if batchsize == 1:
            sys.stdout.flush()  # interactive mode: respond per line

    lines = iter(stream.readline, "") if batchsize == 1 else stream
    for line in lines:
        batch.append(line.rstrip("\n"))
        if len(batch) >= batchsize:
            flush()
    flush()


def process_search(
    model: VariantModel,
    stream: IO,
    params: SearchParameters,
    output_lexmatch: bool,
    json_out: bool,
    progress: bool,
    newline_as_space: bool,
    per_line: bool,
) -> None:
    seqnr = 0
    prevseqnr = 0
    progresstime = time.time()

    def batches():
        lines = iter(stream)
        eof = False
        while not eof:
            batch_parts: List[str] = []
            for i in range(MAX_BATCHSIZE_SEARCH):
                try:
                    line = next(lines)
                except StopIteration:
                    eof = True
                    break
                line = line.rstrip("\n")
                if i > 0:
                    batch_parts.append(" " if newline_as_space else "\n")
                empty = not line
                batch_parts.append(line)
                if empty or per_line:
                    break
            batch = "".join(batch_parts)
            if not batch and eof:
                break
            yield batch

    # pipelined: group N+1's segment lookups run on the device while group N
    # consolidates on the host
    for output in model.find_all_matches_stream(batches(), params):
        if seqnr > 0 and output:
            print()
        for m in output:
            seqnr += 1
            if json_out:
                output_matches_as_json(
                    model, m.text, m.variants, m.selected, m.offset,
                    output_lexmatch, params.freq_weight, seqnr, m.tag, m.seqnr,
                )
            else:
                output_matches_as_tsv(
                    model, m.text, m.variants, m.selected, m.offset,
                    output_lexmatch, params.freq_weight,
                )
        if progress:
            progresstime = _show_progress(seqnr, progresstime, seqnr - prevseqnr)
        prevseqnr = seqnr


def process_learn(
    model: VariantModel,
    stream: IO,
    params: SearchParameters,
    iterations: int,
    json_out: bool,
    multioutput: bool,
    strict: bool,
) -> None:
    lines = [line.rstrip("\n") for line in stream]
    for i in range(iterations):
        count = model.learn_variants(lines, params, strict, auto_build=True)
        print(
            f"(Iteration #{i + 1}: learned {count} variants "
            f"(out of a total of {len(lines)} input strings)",
            file=sys.stderr,
        )
        if count == 0 and i + 1 < iterations:
            print("(Halting further iterations)", file=sys.stderr)
            break
    if json_out:
        output_weighted_variants_as_json(model, multioutput)
    else:
        output_weighted_variants_as_tsv(model, multioutput)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def build_model_from_args(args) -> Tuple[VariantModel, SearchParameters]:
    weights = Weights(
        ld=args.weight_ld,
        lcs=args.weight_lcs,
        prefix=args.weight_prefix,
        suffix=args.weight_suffix,
        case=args.weight_case,
    )
    print("Initializing model...", file=sys.stderr)
    model = VariantModel(
        alphabet_file=args.alphabet, weights=weights, debug=args.debug
    )
    model.set_backend(args.backend)

    print("Loading lexicons...", file=sys.stderr)
    for kind, filename in getattr(args, "ordered_resources", []):
        if kind == "lexicon":
            model.read_vocabulary(filename, VocabParams())
        elif kind == "variants":
            model.read_variants(filename, VocabParams(), transparent=False)
        else:
            model.read_variants(filename, VocabParams(), transparent=True)
    for filename in getattr(args, "lm", []):
        model.read_vocabulary(
            filename, VocabParams(vocab_type=VocabType.LM)
        )
    if args.confusables:
        print("Loading confusable lists...", file=sys.stderr)
        for filename in args.confusables:
            model.read_confusablelist(filename)
    if args.contextrules:
        print("Loading context rules...", file=sys.stderr)
        for filename in args.contextrules:
            model.read_contextrules(filename)
    if args.early_confusables:
        model.set_confusables_before_pruning()

    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.parse(args.max_anagram_distance),
        max_edit_distance=DistanceThreshold.parse(args.max_edit_distance),
        max_matches=args.max_matches,
        score_threshold=args.score_threshold,
        cutoff_threshold=args.cutoff_threshold,
        stop_criterion=(
            StopCriterion.STOP_AT_EXACT_MATCH
            if args.stop_exact
            else StopCriterion.EXHAUSTIVE
        ),
        single_thread=args.single_thread or bool(args.debug) or args.interactive,
        consolidate_matches=not getattr(args, "allow_overlap", False),
        max_ngram=getattr(args, "max_ngram_order", 1),
        freq_weight=args.freq_ranking if args.freq_ranking is not None else 0.0,
        lm_order=getattr(args, "lm_order", 1),
        lm_weight=getattr(args, "weight_lm", 1.0),
        variantmodel_weight=getattr(args, "weight_variant_model", 1.0),
        context_weight=getattr(args, "weight_context", 1.0),
        contextrules_weight=getattr(args, "weight_contextrules", 1.0),
        max_seq=getattr(args, "max_seq", 250),
        unicodeoffsets=args.unicode_offsets,
    )
    if params.cutoff_threshold < 1.0 and params.cutoff_threshold != 0.0:
        print("ERROR: Cutoff-threshold must be >= 1.0, or 0 to disable", file=sys.stderr)
        sys.exit(2)
    return model, params


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if not args.command:
        print("No command specified, please see --help", file=sys.stderr)
        return 2

    if args.command == "testinput":
        # check encodability against the alphabet (reference bin:1007-1023)
        from .alphabet import AlphabetEncoder, read_alphabet_file

        enc = AlphabetEncoder(read_alphabet_file(args.alphabet))
        print("Testing whether input can be fully encoded...", file=sys.stderr)
        from .anahash import counts_to_anavalue

        for line in sys.stdin:
            input_text = line.rstrip("\n")
            counts = enc.count_vector(input_text)
            norm = enc.normalize(input_text)
            av = counts_to_anavalue(counts)
            if counts[enc.unk_count_index] > 0:
                print(f"UNKNOWN: {input_text}\t{av}\t{norm}", file=sys.stderr)
            else:
                print(f"OK: {input_text}\t{av}\t{norm}")
        return 0

    model, params = build_model_from_args(args)
    print("Building model...", file=sys.stderr)
    model.build()
    # steady-state serving: freeze the model heap so gen-2 GC passes stop
    # rescanning the (large, immortal) vocabulary on every few batches
    from .utils.gc_tuning import freeze_model_heap

    freeze_model_heap()

    if args.command == "index":
        print("Computing and outputting anagram index...", file=sys.stderr)
        index = model.index
        if index is not None:
            for g, (start, end) in enumerate(index.group_ranges):
                parts = [str(index.group_anavalue(g))]
                for row in range(start, end):
                    parts.append(model.decoder[int(index.vocab_ids[row])].text)
                print("\t".join(parts))
        return 0

    if args.command == "query":
        print("Querying the model...", file=sys.stderr)
    elif args.command == "search":
        print("Finding all variants in the input text...", file=sys.stderr)
    else:
        print("Collecting variants...", file=sys.stderr)

    if args.json:
        print("[")

    files = args.files if args.files else ["-"]
    for filename in files:
        if filename in ("-", "STDIN", "stdin"):
            stream = sys.stdin
        else:
            stream = open(filename, "r", encoding="utf-8")
        try:
            if args.command == "learn":
                process_learn(
                    model, stream, params, args.iterations, args.json,
                    args.multi_output, args.strict,
                )
            elif args.command == "search":
                process_search(
                    model, stream, params, args.output_lexmatch, args.json,
                    args.progress, not args.retain_linebreaks, args.per_line,
                )
            else:
                process_batched(
                    model, stream, params, args.output_lexmatch, args.json,
                    args.progress,
                    batchsize=1 if args.interactive else MAX_BATCHSIZE,
                )
        finally:
            if stream is not sys.stdin:
                stream.close()

    if args.json:
        print("]")
    return 0


def _main_cli() -> int:
    try:
        return main()
    except FileNotFoundError as e:
        print(f"ERROR: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(_main_cli())
