"""Command-line interface: the four sub-commands of the reference CLI
(Main.scala, ClpMain.scala), with the same flags, short options and
defaults (SearchReference.scala:451-471, AlignToReference.scala:34-51,
PairwiseAlignSequences.scala:24-34, PrepareVcf.scala:31-37)."""

from __future__ import annotations

import argparse
import logging
import sys

from calitas_tpu.core.scoring import Defaults
from calitas_tpu.utils import ENGINES


class _Once(argparse.Action):
    """Reject a repeated single-valued flag instead of silently keeping
    the last value (argparse's default), which would silently search one
    guide when a user writes ``-i G1 -i G2`` expecting a multi-guide run
    (that is ``--guide-file``).  Mirrors sopt's duplicate-flag error."""

    def __call__(self, parser, namespace, values, option_string=None):
        if getattr(namespace, self.dest, None) is not None:
            parser.error(
                f"{option_string} given more than once; for multi-guide "
                "searches use --guide-file"
            )
        setattr(namespace, self.dest, values)


def _add_scoring_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--guide-mismatch-net-cost", type=int,
                   default=Defaults.MISMATCH_NET_COST,
                   help="Net cost of going from a match to a mismatch in the guide.")
    p.add_argument("-M", "--pam-mismatch-net-cost", type=int,
                   default=Defaults.PAM_MISMATCH_NET_COST,
                   help="Net cost of going from a match to a mismatch in the PAM.")
    p.add_argument("-b", "--genome-gap-net-cost", type=int,
                   default=Defaults.GENOME_GAP_NET_COST,
                   help="Net cost of a 1bp gap in the genome.")
    p.add_argument("-B", "--guide-gap-net-cost", type=int,
                   default=Defaults.GUIDE_GAP_NET_COST,
                   help="Net cost of a 1bp gap in the guide.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="calitas-tpu",
        description="CRISPR off-target search on a GPU (CALITAS-compatible).",
    )
    from calitas_tpu.version import aligner_version

    parser.add_argument(
        "--version", action="version", version=f"calitas-tpu {aligner_version()}"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    # ---------------------------------------------------------- SearchReference
    sr = sub.add_parser(
        "SearchReference",
        help="Searches a reference sequence for alignments of a guide+PAM.",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""\
The search finds all candidate alignments of the guide without the PAM,
then extends them with an optional PAM (PAM-less, single- or multi-PAM via
--auxiliary-pams; best extension wins, earlier PAMs preferred on ties).
Protospacer sequence must be upper case, PAM sequence lower case, e.g.:

    --guide ATCGATCGATAGACTGCATnrg --auxiliary-pams nnrg kgg

Scoring uses NET costs (the lost match is folded into each difference).
Defaults guarantee that all alignments within --max-guide-diffs /
--max-pam-mismatches / --max-gaps-between-guide-and-pam are found for
common 20-40bp guides.  When changing costs keep:

    (max_guide_diffs + 1) * min_cost > max_guide_diffs * max_cost

where min/max_cost range over the three guide-region net costs; otherwise
valid alignments may be silently lost.  Note that --max-total-diffs is
enforced as a post-filter: running with loose limits plus the filter can
prefer e.g. a 4+0 alignment over a competing 3+1 alignment that tighter
limits would emit; set --max-overlap large (e.g. 100) to emit all
overlapping alignments instead.""",
    )
    sr.add_argument("-i", "--guide", default=None, action=_Once,
                    help="Guide with PAM, PAM must be lower case.")
    sr.add_argument("-I", "--guide-id", default=None, action=_Once,
                    help="ID of the guide.")
    sr.add_argument("--guide-file", default=None,
                    help="TSV of guides (columns: guide_id, guide, optional "
                         "aux_pams comma-separated) searched in one pass with "
                         "the genome staged on device once. Mutually "
                         "exclusive with --guide/--guide-id.")
    sr.add_argument("-x", "--auxiliary-pams", nargs="*", default=[],
                    help="Additional PAM sequences. Must be lower case.")
    sr.add_argument("-r", "--ref", required=True, help="Reference genome fasta.")
    sr.add_argument("-v", "--variants", default=None,
                    help="Optional VCF of variants to merge into the genome.")
    sr.add_argument("-V", "--max-variants", type=int,
                    default=Defaults.MAX_VARIANTS_IN_CLUSTER,
                    help="Exclude clusters of more than this many variants.")
    sr.add_argument("-o", "--output", default=None, help="Output file to write.")
    sr.add_argument("-t", "--threads", type=int, default=8)
    sr.add_argument("-w", "--window-size", type=int, default=1000)
    sr.add_argument("-d", "--max-guide-diffs", type=int, default=Defaults.MAX_GUIDE_DIFFS)
    sr.add_argument("-p", "--max-pam-mismatches", type=int, default=Defaults.MAX_PAM_MISMATCHES)
    sr.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    sr.add_argument("-D", "--max-total-diffs", type=int, default=None)
    sr.add_argument("-O", "--max-overlap", type=int, default=Defaults.MAX_OVERLAP)
    _add_scoring_args(sr)
    sr.add_argument("-c", "--chrom", default=None,
                    help="Examine only the named chromosome.")
    sr.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: device screen when an "
                         "accelerator is present; tpu = device).")
    sr.add_argument("--profile-dir", default=None,
                    help="Write a JAX profiler trace of the run to this directory.")
    sr.add_argument("--checkpoint", default=None,
                    help="Checkpoint state file: completed contigs are recorded "
                         "durably and skipped on resume.")
    sr.add_argument("--process-index", type=int, default=None,
                    help="Multi-host: this process's 0-based index. The run "
                         "covers only this process's deterministic whole-contig "
                         "shard; merge per-host outputs with MergeHitTables.")
    sr.add_argument("--process-count", type=int, default=None,
                    help="Multi-host: total number of processes sharding the "
                         "genome by whole contigs.")
    sr.add_argument("--distributed", action="store_true",
                    help="Initialize jax.distributed from the environment "
                         "(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, "
                         "JAX_PROCESS_ID); process index/count default to the "
                         "JAX process identity.")

    # --------------------------------------------------------- AlignToReference
    ar = sub.add_parser(
        "AlignToReference",
        help="Glocal alignment of query sequences to windows on the reference.",
    )
    ar.add_argument("-i", "--input", required=True,
                    help="Input file of sequence queries and approximate positions.")
    ar.add_argument("-r", "--ref", required=True,
                    help="Reference genome fasta, must be indexed with faidx.")
    ar.add_argument("-o", "--output", default=None)
    ar.add_argument("-w", "--window-size", type=int, default=None)
    ar.add_argument("-d", "--max-guide-diffs", type=int, default=None)
    ar.add_argument("-p", "--max-pam-mismatches", type=int, default=None)
    ar.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    ar.add_argument("-D", "--max-total-diffs", type=int, default=None)
    ar.add_argument("-O", "--max-overlap", type=int, default=None)
    _add_scoring_args(ar)
    ar.add_argument("-t", "--threads", type=int, default=8)
    ar.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: device pair screen when "
                         "available; output-identical; tpu = device).")

    # ---------------------------------------------------- PairwiseAlignSequences
    pw = sub.add_parser(
        "PairwiseAlignSequences", help="Performs pairwise alignment of sequences."
    )
    pw.add_argument("-i", "--input", required=True, help="Input file of sequence pairs.")
    pw.add_argument("-o", "--output", default=None)
    pw.add_argument("-t", "--threads", type=int, default=8)
    pw.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    pw.add_argument("-O", "--max-overlap", type=int, default=Defaults.MAX_OVERLAP)
    _add_scoring_args(pw)
    pw.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: device pair screen when "
                         "available; output-identical; tpu = device).")

    # ----------------------------------------------------------- MergeHitTables
    mh = sub.add_parser(
        "MergeHitTables",
        help="Merge per-host SearchReference outputs (whole-contig shards) "
             "into the canonical global table.",
    )
    mh.add_argument("-i", "--input", nargs="+", required=True,
                    help="Per-host hit tables to merge.")
    mh.add_argument("-o", "--output", required=True)
    mh.add_argument("-r", "--ref", default=None,
                    help="Reference fasta (for dictionary sort order).")

    # ----------------------------------------------------------------- Serve
    sv = sub.add_parser(
        "Serve",
        help="Long-lived search server: stage the genome (and index the "
             "VCF) once, answer SearchReference requests over a JSON "
             "line protocol on stdin/stdout.",
    )
    sv.add_argument("-r", "--ref", required=True, help="Reference genome fasta.")
    sv.add_argument("-v", "--variants", default=None,
                    help="Optional VCF of variants to merge into the genome.")
    sv.add_argument("-w", "--window-size", type=int, default=1000)
    sv.add_argument("-t", "--threads", type=int, default=8)
    sv.add_argument("-c", "--contigs", nargs="*", default=None,
                    help="Stage only these contigs (default: all).")
    sv.add_argument("--engine", choices=ENGINES, default="auto")
    sv.add_argument("--warmup", type=_strict_bool, nargs="?", const=True,
                    default=True, metavar="true|false",
                    help="Run a throwaway search at startup so the first "
                         "real request runs at warm speed (default: on — "
                         "a resident server's first query should not pay "
                         "the worker-pool + compile cost; --warmup false "
                         "skips it).")
    _add_scoring_args(sv)

    # ----------------------------------------------------------------- PrepareVcf
    pv = sub.add_parser("PrepareVcf",
                        help="Prepares a VCF for optimal use by SearchReference.")
    pv.add_argument("-i", "--input", nargs="+", required=True,
                    help="One or more input VCFs")
    pv.add_argument("-o", "--output", required=True, help="The output VCF to create.")
    pv.add_argument("-f", "--min-af", type=float, default=0.01,
                    help="The minimum allele frequency of variants to retain.")
    pv.add_argument("-d", "--dict", dest="dict_path", default=None,
                    help="An optional sequence dictionary to use to override contig lines.")
    pv.add_argument("-c", "--add-chr-prefix", type=_strict_bool,
                    default=True, help="If true, add 'chr' to chroms 1-22, X and Y.")

    return parser


def _strict_bool(s: str) -> bool:
    """'true'/'false' (case-insensitive) or an error — like the
    reference's sopt boolean parser; anything else must not silently
    become False."""
    v = s.strip().lower()
    if v == "true":
        return True
    if v == "false":
        return False
    import argparse

    raise argparse.ArgumentTypeError(
        f"expected 'true' or 'false', got {s!r}"
    )


def _parse_guide_file(path: str) -> list[tuple[str, str, list[str]]]:
    """Parse a guide TSV: columns guide_id, guide, optional aux_pams
    (comma-separated).  CRLF files and short rows get clear errors."""
    specs = []
    with open(path, newline=None) as fh:  # universal newlines eat \r\n
        header = fh.readline().rstrip("\r\n").split("\t")
        col = {name.strip(): i for i, name in enumerate(header)}
        for req in ("guide_id", "guide"):
            if req not in col:
                raise SystemExit(f"--guide-file missing required column: {req}")
        need = max(col["guide_id"], col["guide"]) + 1
        for lineno, line in enumerate(fh, start=2):
            if not line.strip():
                continue
            f = line.rstrip("\r\n").split("\t")
            if len(f) < need:
                raise SystemExit(
                    f"--guide-file line {lineno}: expected at least "
                    f"{need} columns, got {len(f)}"
                )
            aux: list[str] = []
            if "aux_pams" in col and len(f) > col["aux_pams"] and f[col["aux_pams"]]:
                aux = f[col["aux_pams"]].split(",")
            specs.append((f[col["guide_id"]], f[col["guide"]], aux))
    if not specs:
        raise SystemExit(f"--guide-file contains no guides: {path}")
    return specs


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    args = build_parser().parse_args(argv)
    cmd = args.command
    try:
        return _dispatch(cmd, args)
    except (FileNotFoundError, ValueError, KeyError) as ex:
        print(f"error: {ex}", file=sys.stderr)
        return 1


def _dispatch(cmd, args) -> int:

    if cmd == "SearchReference":
        from calitas_tpu.tools import search_reference

        guide_specs = None
        if args.guide_file is not None:
            if args.guide is not None or args.guide_id is not None:
                raise SystemExit("--guide-file is mutually exclusive with --guide/--guide-id")
            if args.auxiliary_pams:
                # the file carries its own aux_pams column; silently
                # dropping a user's -x would lose hits
                raise SystemExit(
                    "-x/--auxiliary-pams cannot be combined with "
                    "--guide-file (use the file's aux_pams column)"
                )
            guide_specs = _parse_guide_file(args.guide_file)
        elif args.guide is None or args.guide_id is None:
            raise SystemExit("Provide --guide and --guide-id, or --guide-file")

        search_reference.run(
            guide=args.guide,
            guide_id=args.guide_id,
            ref=args.ref,
            auxiliary_pams=args.auxiliary_pams,
            guide_specs=guide_specs,
            variants=args.variants,
            max_variants=args.max_variants,
            output=args.output,
            threads=args.threads,
            window_size=args.window_size,
            max_guide_diffs=args.max_guide_diffs,
            max_pam_mismatches=args.max_pam_mismatches,
            max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
            max_total_diffs=args.max_total_diffs,
            max_overlap=args.max_overlap,
            guide_mismatch_net_cost=args.guide_mismatch_net_cost,
            pam_mismatch_net_cost=args.pam_mismatch_net_cost,
            genome_gap_net_cost=args.genome_gap_net_cost,
            guide_gap_net_cost=args.guide_gap_net_cost,
            chrom=args.chrom,
            engine=args.engine,
            profile_dir=args.profile_dir,
            checkpoint=args.checkpoint,
            process_index=args.process_index,
            process_count=args.process_count,
            distributed=args.distributed,
        )
    elif cmd == "AlignToReference":
        from calitas_tpu.tools import align_to_reference

        align_to_reference.run(
            input=args.input,
            ref=args.ref,
            output=args.output,
            window_size=args.window_size,
            max_guide_diffs=args.max_guide_diffs,
            max_pam_mismatches=args.max_pam_mismatches,
            max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
            max_total_diffs=args.max_total_diffs,
            max_overlap=args.max_overlap,
            guide_mismatch_net_cost=args.guide_mismatch_net_cost,
            pam_mismatch_net_cost=args.pam_mismatch_net_cost,
            genome_gap_net_cost=args.genome_gap_net_cost,
            guide_gap_net_cost=args.guide_gap_net_cost,
            threads=args.threads,
            engine=args.engine,
        )
    elif cmd == "PairwiseAlignSequences":
        from calitas_tpu.tools import pairwise

        pairwise.run(
            input=args.input,
            output=args.output,
            threads=args.threads,
            max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
            max_overlap=args.max_overlap,
            guide_mismatch_net_cost=args.guide_mismatch_net_cost,
            pam_mismatch_net_cost=args.pam_mismatch_net_cost,
            genome_gap_net_cost=args.genome_gap_net_cost,
            guide_gap_net_cost=args.guide_gap_net_cost,
            engine=args.engine,
        )
    elif cmd == "MergeHitTables":
        from calitas_tpu.io.fasta import extract_dictionary
        from calitas_tpu.parallel.multihost import merge_host_outputs

        dictionary = extract_dictionary(args.ref) if args.ref else None
        n = merge_host_outputs(args.input, dictionary, args.output)
        print(f"Wrote {n} rows to {args.output}", file=sys.stderr)
    elif cmd == "Serve":
        from calitas_tpu.serve import ResidentSearcher, serve_stdio

        searcher = ResidentSearcher(
            ref=args.ref,
            variants=args.variants,
            window_size=args.window_size,
            threads=args.threads,
            engine=args.engine,
            contigs=args.contigs,
            guide_mismatch_net_cost=args.guide_mismatch_net_cost,
            pam_mismatch_net_cost=args.pam_mismatch_net_cost,
            genome_gap_net_cost=args.genome_gap_net_cost,
            guide_gap_net_cost=args.guide_gap_net_cost,
        )
        if args.warmup:
            searcher.warmup()
        serve_stdio(searcher)
    elif cmd == "PrepareVcf":
        from calitas_tpu.tools import prepare_vcf

        prepare_vcf.run(
            input=args.input,
            output=args.output,
            min_af=args.min_af,
            dict_path=args.dict_path,
            add_chr_prefix=args.add_chr_prefix,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
