"""Command-line interface.

Mirrors the reference CLI surface (commands/root_args.rs:61-123): build,
export {gfa, block-consensus, block-sequences, core-genome}, simplify,
reconstruct, schema, completions. Run as `python -m pangraph_tpu.cli` or via
the `pangraph-tpu` entry point.
"""
from __future__ import annotations

import argparse
import logging
import sys


def _add_verbosity(p):
    p.add_argument("-v", "--verbose", action="count", default=0, help="Increase verbosity")
    p.add_argument("-q", "--quiet", action="count", default=0, help="Decrease verbosity")
    p.add_argument("--verbosity", default=None, help="Set verbosity level explicitly")
    p.add_argument("--silent", action="store_true", help="Disable all console output")
    p.add_argument("-j", "--jobs", type=int, default=None, help="Number of host threads (advisory)")


def build_parser():
    p = argparse.ArgumentParser(prog="pangraph-tpu", description="Pangenome graph toolkit (JAX rebuild of pangraph)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="Align genomes into a multiple sequence alignment graph")
    b.add_argument("input_fastas", nargs="+", help="Input FASTA files (optionally compressed)")
    b.add_argument("-o", "--output-json", default="-", help="Output graph JSON path ('-' = stdout)")
    b.add_argument("-l", "--len", dest="indel_len_threshold", type=int, default=100, help="Minimum block size")
    b.add_argument("-a", "--alpha", type=float, default=100.0, help="Energy cost of block splits")
    b.add_argument("-b", "--beta", type=float, default=10.0, help="Energy cost of alignment diversity")
    b.add_argument("-c", "--circular", action="store_true", help="Treat genomes as circular")
    b.add_argument("-x", "--max-self-map", type=int, default=100, help="Max self-merge iterations")
    b.add_argument("-s", "--sensitivity", type=int, default=10, help="Alignment preset: 5/10/20 (asm5/10/20)")
    b.add_argument("-K", "--kmer-length", type=int, default=None, help="k-mer length override")
    b.add_argument(
        "-k", "--alignment-kernel", default="minimap2", choices=["minimap2", "mmseqs"], help="Alignment backend"
    )
    b.add_argument("-f", "--verify", action="store_true", help="Verify lossless reconstruction")
    b.add_argument("--extra-band-width", type=int, default=5)
    b.add_argument("--max-alignment-attempts", type=int, default=4)
    b.add_argument("--guide-tree", default=None, help="Newick guide tree path")
    b.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Directory for merge-tree checkpoints; an interrupted build resumes from completed subgraphs",
    )
    b.add_argument(
        "--coordinate",
        nargs="?",
        const=True,
        default=False,
        metavar="tcp://HOST:PORT",
        help="Share one build across workers: bare flag claims merges via the "
        "checkpoint dir (shared filesystem); with tcp://HOST:PORT, claims and "
        "subgraphs go through a coordination server (first worker to bind "
        "hosts it) — no shared filesystem needed",
    )
    b.add_argument("--no-device", action="store_true", help="Run the banded alignment on the host aligner only")
    b.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Shard alignment batches over this many GPUs (default: all available; 1 disables the mesh)",
    )
    b.add_argument("--trace", action="store_true", help="Log per-phase wall-time breakdown at the end")
    b.add_argument("--no-progress-bar", action="store_true")
    b.add_argument("--upper-case", action="store_true", help="Uppercase input sequences (always on)")
    _add_verbosity(b)

    e = sub.add_parser("export", help="Export a pangenome graph")
    esub = e.add_subparsers(dest="export_what", required=True)

    eg = esub.add_parser("gfa", help="Export GFA v1")
    eg.add_argument("input_json")
    eg.add_argument("-o", "--output", default="-")
    eg.add_argument("--minimum-length", type=int, default=None)
    eg.add_argument("--maximum-length", type=int, default=None)
    eg.add_argument("--minimum-depth", type=int, default=None)
    eg.add_argument("--maximum-depth", type=int, default=None)
    eg.add_argument("--include-sequences", action="store_true")
    eg.add_argument("--no-duplicated", action="store_true")
    _add_verbosity(eg)

    ec = esub.add_parser("block-consensus", help="Export block consensus sequences to FASTA")
    ec.add_argument("input_json")
    ec.add_argument("-o", "--output", default="-")
    _add_verbosity(ec)

    es = esub.add_parser("block-sequences", help="Export per-block sequences (one FASTA per block)")
    es.add_argument("input_json")
    es.add_argument("-o", "--output", required=True, help="Output directory")
    es.add_argument("--unaligned", action="store_true")
    _add_verbosity(es)

    ek = esub.add_parser("core-genome", help="Export core-genome alignment")
    ek.add_argument("input_json")
    ek.add_argument("-o", "--output", default="-")
    ek.add_argument("--guide-strain", required=True)
    ek.add_argument("--unaligned", action="store_true")
    _add_verbosity(ek)

    s = sub.add_parser("simplify", help="Keep only selected strains and re-compact")
    s.add_argument("input_json")
    s.add_argument("-o", "--output-json", default="-")
    s.add_argument("-s", "--strains", required=True, help="Comma-separated strain names to keep")
    _add_verbosity(s)

    r = sub.add_parser("reconstruct", help="Reconstruct input sequences from the graph")
    r.add_argument("input_json")
    r.add_argument("-o", "--output-fasta", default="-")
    r.add_argument("--verify", default=None, help="FASTA to compare reconstruction against")
    _add_verbosity(r)

    sc = sub.add_parser("schema", help="Emit the graph JSON schema")
    sc.add_argument("-o", "--output", default="-")
    _add_verbosity(sc)

    co = sub.add_parser("completions", help="Generate shell completions")
    co.add_argument("shell", choices=["bash", "zsh", "fish"], nargs="?", default="bash")

    hm = sub.add_parser("help-markdown", help="Print the CLI reference as Markdown")

    mg = sub.add_parser("merge", help="Merge two pangenome graph JSONs directly (dev tool; bin/merge_two_graphs.rs)")
    mg.add_argument("left_json")
    mg.add_argument("right_json")
    mg.add_argument("-o", "--output-json", default="-")
    mg.add_argument("-c", "--circular", action="store_true")
    _add_verbosity(mg)

    return p


def _setup_logging(args):
    level = logging.WARNING
    v = getattr(args, "verbose", 0) - getattr(args, "quiet", 0)
    if getattr(args, "silent", False):
        level = logging.CRITICAL
    elif getattr(args, "verbosity", None):
        level = getattr(logging, str(args.verbosity).upper(), logging.WARNING)
    elif v >= 2:
        level = logging.DEBUG
    elif v == 1:
        level = logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")


def main(argv=None) -> int:
    """Dispatch with clean one-line contextual errors (the analog of the
    reference's eyre/color-eyre report wrapping, utils/global_init.rs:65-121).
    Tracebacks are shown with -v or PANGRAPH_TPU_DEBUG=1."""
    args = build_parser().parse_args(argv)
    _setup_logging(args)
    import os

    debug = bool(os.environ.get("PANGRAPH_TPU_DEBUG")) or getattr(args, "verbose", 0) > 0
    try:
        return _dispatch(args)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        if debug:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.command == "build":
        return _cmd_build(args)
    if args.command == "export":
        return _cmd_export(args)
    if args.command == "simplify":
        return _cmd_simplify(args)
    if args.command == "reconstruct":
        return _cmd_reconstruct(args)
    if args.command == "schema":
        from pangraph_tpu.commands import export_schema

        out = export_schema(None if args.output == "-" else args.output)
        if args.output == "-":
            sys.stdout.write(out)
        return 0
    if args.command == "completions":
        sys.stdout.write(_completions(args.shell))
        return 0
    if args.command == "help-markdown":
        sys.stdout.write(_help_markdown())
        return 0
    if args.command == "merge":
        return _cmd_merge(args)
    return 2


def _cmd_build(args) -> int:
    from pangraph_tpu.align.params import AlignmentArgs, BuildArgs
    from pangraph_tpu.build.build import build
    from pangraph_tpu.io.fasta import read_fasta

    build_args = BuildArgs(
        circular=args.circular,
        max_self_map=args.max_self_map,
        extra_band_width=args.extra_band_width,
        max_alignment_attempts=args.max_alignment_attempts,
        verify=args.verify,
        guide_tree=args.guide_tree,
        jobs=args.jobs or 1,
        checkpoint_dir=args.checkpoint_dir,
        coordinate=args.coordinate,
        aln_args=AlignmentArgs(
            indel_len_threshold=args.indel_len_threshold,
            alpha=args.alpha,
            beta=args.beta,
            sensitivity=args.sensitivity,
            kmer_length=args.kmer_length,
        ),
    )
    if args.alignment_kernel == "mmseqs":
        from pangraph_tpu.align.mmseqs import check_mmseqs

        check_mmseqs()

    aligner = _make_aligner(build_args, args.no_device, args.devices)
    if args.trace:
        from pangraph_tpu.utils import trace

        trace.enable(True)
    recs = read_fasta(args.input_fastas)
    from pangraph_tpu.utils.progress import ProgressBar

    progress = ProgressBar(max(len(recs) - 1, 1), enabled=not args.no_progress_bar)
    if args.alignment_kernel == "mmseqs":
        from pangraph_tpu.align.mmseqs import make_mmseqs_find_matches

        graph = build(
            recs, build_args, aligner=aligner,
            find_matches_override=make_mmseqs_find_matches(build_args), progress=progress,
        )
    else:
        graph = build(recs, build_args, aligner=aligner, progress=progress)
    progress.close()
    if args.trace:
        from pangraph_tpu.utils import trace

        print(trace.summary(), file=sys.stderr)
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0


def _make_aligner(build_args, no_device: bool = False, devices: int = None):
    """The build's aligner: device kernel plus host aligner where the
    platform has a device kernel, the host aligner alone otherwise. With
    devices > 1 every device batch is sharded over a mesh of that many."""
    import jax

    from pangraph_tpu.ops.batch_align import BatchAligner
    from pangraph_tpu.ops.stripe_dp import has_device_kernel

    n_avail = len(jax.devices())
    n_dev = devices if devices is not None else n_avail
    if n_dev > n_avail:
        raise ValueError(f"--devices {n_dev}: only {n_avail} device(s) available")
    use_device = not no_device and has_device_kernel()
    if not no_device and not use_device:
        logging.getLogger(__name__).warning(
            "no GPU (JAX platform %r): the host aligner runs every alignment", jax.default_backend()
        )
    mesh = None
    if use_device and n_dev > 1:
        from pangraph_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_dev)
    return BatchAligner(
        build_args.banded_params, build_args.extra_band_width, build_args.max_alignment_attempts,
        mesh=mesh, device=use_device,
    )


def _cmd_export(args) -> int:
    from pangraph_tpu.graph.graph import Pangraph

    graph = Pangraph.from_file(args.input_json)
    if args.export_what == "gfa":
        from pangraph_tpu.io.gfa import GfaParams, gfa_write

        gfa_write(
            graph,
            None if args.output == "-" else args.output,
            GfaParams(
                minimum_length=args.minimum_length,
                maximum_length=args.maximum_length,
                minimum_depth=args.minimum_depth,
                maximum_depth=args.maximum_depth,
                include_sequences=args.include_sequences,
                no_duplicated=args.no_duplicated,
            ),
        )
    elif args.export_what == "block-consensus":
        from pangraph_tpu.commands import export_block_consensus

        export_block_consensus(graph, None if args.output == "-" else args.output)
    elif args.export_what == "block-sequences":
        from pangraph_tpu.commands import export_block_sequences

        export_block_sequences(graph, args.output, unaligned=args.unaligned)
    elif args.export_what == "core-genome":
        from pangraph_tpu.commands import export_core_genome

        export_core_genome(
            graph, args.guide_strain, None if args.output == "-" else args.output, unaligned=args.unaligned
        )
    return 0


def _cmd_simplify(args) -> int:
    from pangraph_tpu.commands import simplify
    from pangraph_tpu.graph.graph import Pangraph

    graph = Pangraph.from_file(args.input_json)
    graph = simplify(graph, args.strains.split(","))
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0


def _cmd_reconstruct(args) -> int:
    from pangraph_tpu.commands import reconstruct_to_fasta
    from pangraph_tpu.graph.graph import Pangraph, reconstruct
    from pangraph_tpu.graph.seq import to_str
    from pangraph_tpu.io.fasta import read_fasta

    graph = Pangraph.from_file(args.input_json)
    if args.verify:
        expected = {r.seq_name: r.seq for r in read_fasta(args.verify)}
        ok = True
        for name, desc, seq in reconstruct(graph):
            exp = expected.get(name)
            if exp is None:
                print(f"MISSING {name}: not in verification FASTA", file=sys.stderr)
                ok = False
            elif to_str(seq) != to_str(exp):
                print(f"MISMATCH {name}: {len(seq)} bp vs expected {len(exp)} bp", file=sys.stderr)
                ok = False
        if ok:
            print("All sequences reconstructed exactly", file=sys.stderr)
        return 0 if ok else 1
    reconstruct_to_fasta(graph, None if args.output_fasta == "-" else args.output_fasta)
    return 0


def _cmd_merge(args) -> int:
    """Merge two serialized graphs (reference dev tool bin/merge_two_graphs.rs)."""
    from pangraph_tpu.align.params import BuildArgs
    from pangraph_tpu.build.build import make_find_matches
    from pangraph_tpu.build.merge import merge_graphs
    from pangraph_tpu.graph.graph import Pangraph

    left = Pangraph.from_file(args.left_json)
    right = Pangraph.from_file(args.right_json)
    build_args = BuildArgs(circular=args.circular)
    aligner = _make_aligner(build_args)
    graph = merge_graphs(left, right, build_args, make_find_matches(build_args, aligner), aligner)
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0


def _help_markdown() -> str:
    """Render the whole CLI as a Markdown reference (reference:
    commands/md_help -> docs/docs/reference.md)."""
    parser = build_parser()
    out = ["# pangraph-tpu CLI reference", "", "```", parser.format_help().rstrip(), "```", ""]
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    seen = set()
    for name, sp in subs.choices.items():
        if id(sp) in seen:
            continue
        seen.add(id(sp))
        out += [f"## `pangraph-tpu {name}`", "", "```", sp.format_help().rstrip(), "```", ""]
        for a in sp._actions:
            if isinstance(a, argparse._SubParsersAction):
                for n2, sp2 in a.choices.items():
                    out += [f"### `pangraph-tpu {name} {n2}`", "", "```", sp2.format_help().rstrip(), "```", ""]
    return "\n".join(out)


def _parser_tree():
    """{(subcommand path): {flag: help}} introspected from the live parser —
    completions can never drift from the CLI (the reference generates its
    completions from the clap definition the same way, root_args.rs:125)."""
    tree = {}

    def walk(parser, path):
        flags = {}
        subs = {}
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    subs[name] = sp
            else:
                for s in a.option_strings:
                    flags[s] = (a.help or "").replace("'", "").replace('"', "")
        tree[path] = (flags, sorted(subs))
        for name, sp in subs.items():
            walk(sp, path + (name,))

    walk(build_parser(), ())
    return tree


def _completions(shell: str) -> str:
    tree = _parser_tree()

    if shell == "bash":
        cases = []
        for path, (flags, subs) in tree.items():
            words = " ".join(sorted(flags) + subs)
            key = " ".join(path) if path else "_root"
            cases.append(f'    "{key}") words="{words}" ;;')
        return (
            "_pangraph_tpu() {\n"
            '  local cur="${COMP_WORDS[COMP_CWORD]}" words path=""\n'
            "  local -a ctx=()\n"
            '  for ((i=1; i<COMP_CWORD; i++)); do\n'
            '    [[ "${COMP_WORDS[i]}" == -* ]] || ctx+=("${COMP_WORDS[i]}")\n'
            "  done\n"
            '  path="${ctx[*]:-_root}"\n'
            '  case "$path" in\n' + "\n".join(cases) + "\n"
            '    *) words="" ;;\n'
            "  esac\n"
            '  if [[ -n "$words" && ( "$cur" == -* || -n "${ctx[*]}" == "" ) ]]; then\n'
            '    COMPREPLY=( $(compgen -W "$words" -- "$cur") )\n'
            "  fi\n"
            '  [[ ${#COMPREPLY[@]} -eq 0 ]] && COMPREPLY=( $(compgen -f -- "$cur") )\n'
            "}\n"
            "complete -o filenames -F _pangraph_tpu pangraph-tpu\n"
        )

    if shell == "zsh":
        out = ["#compdef pangraph-tpu", "", "_pangraph_tpu() {"]
        root_flags, root_subs = tree[()]
        out.append("  local -a subcmds=(" + " ".join(root_subs) + ")")
        out.append('  if (( CURRENT == 2 )); then')
        out.append("    _describe 'command' subcmds")
        flag_specs = " ".join(f"'{f}[{h}]'" for f, h in sorted(root_flags.items()))
        out.append(f"    _arguments {flag_specs}")
        out.append("    return")
        out.append("  fi")
        out.append('  case "$words[2]" in')
        for path, (flags, subs) in tree.items():
            if len(path) != 1:
                continue
            specs = " ".join(f"'{f}[{h}]'" for f, h in sorted(flags.items()))
            sub2 = ""
            if subs:
                sub2 = f" '1: :({' '.join(subs)})'"
            out.append(f"    {path[0]}) _arguments {specs}{sub2} '*:file:_files' ;;")
        out.append("  esac")
        out.append("}")
        out.append("_pangraph_tpu")
        return "\n".join(out) + "\n"

    # fish
    lines = []
    _, root_subs = tree[()]
    for name in root_subs:
        lines.append(
            f"complete -c pangraph-tpu -n '__fish_use_subcommand' -a {name}"
        )
    for path, (flags, subs) in tree.items():
        if not path:
            continue
        cond = f"__fish_seen_subcommand_from {path[0]}"
        for f, h in sorted(flags.items()):
            if f.startswith("--"):
                lines.append(f"complete -c pangraph-tpu -n '{cond}' -l {f[2:]} -d '{h}'")
            elif f.startswith("-") and len(f) == 2:
                lines.append(f"complete -c pangraph-tpu -n '{cond}' -s {f[1]} -d '{h}'")
        for s in subs:
            lines.append(f"complete -c pangraph-tpu -n '{cond}' -a {s}")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    sys.exit(main())


def entry() -> int:
    """Console-script entry point."""
    return main()
