"""PairwiseAlignSequences: best glocal alignment per (query, target) pair.

Parity contract: PairwiseAlignSequences.scala (SURVEY.md §3.4).  Input is
a whitespace-delimited file of (query, target) pairs; output the 11-column
table with query_start hardcoded to 1 and target_start = aln.startOffset.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import Defaults
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.io.tsv import open_output

COLUMNS = [
    "query", "target", "score", "query_start", "target_start", "cigar",
    "mismatches", "gap_bases", "padded_query", "alignment", "padded_target",
]

BATCH_SIZE = 10_000  # PairwiseAlignSequences.scala:63


def run(
    input: str | Path,
    output: Optional[str | Path] = None,
    threads: int = 8,
    max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
    max_overlap: int = Defaults.MAX_OVERLAP,
    guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    engine: str = "auto",  # one of utils.ENGINES
) -> None:
    tasks: list = []
    with open(input) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise ValueError(
                    f"Line found with {len(fields)} fields: {' '.join(fields)}"
                )
            tasks.append((fields[0], fields[1].upper()))

    aligner = SequentialAligner(
        mismatch_net_cost=guide_mismatch_net_cost,
        pam_mismatch_net_cost=pam_mismatch_net_cost,
        genome_gap_net_cost=genome_gap_net_cost,
        guide_gap_net_cost=guide_gap_net_cost,
    )

    from calitas_tpu.tools.search_reference import _resolve_engine

    use_dev = _resolve_engine(
        engine, n_tasks=len(tasks), prefer_host_when_native=True
    )
    if use_dev:
        # Device batching (SURVEY.md §7 step 4): one dispatch computes
        # both chains' exact DP maxima for every pair; the host finish
        # then skips the rev pass whenever it provably cannot beat the
        # fwd result (engine.align_best pass_dp_bounds — output-identical).
        from calitas_tpu.ops.pair_screen import PairScreen, pass_bounds_for

        dp_queries: list[str] = []
        guides: list = []
        for query, _target in tasks:
            try:
                g = Guide.parse(query)
            except Exception:
                g = None  # the worker re-parses and reports the error
            guides.append(g)
            dp_queries.append(
                "" if g is None
                else (g.guide_rc if g.pam_is_5prime else g.guide_fw)
            )
        try:
            screen = PairScreen(aligner.scorer)
            chain_a, chain_b = screen.chain_maxima(
                dp_queries, [t for _q, t in tasks]
            )
            tasks = [
                (
                    q, t,
                    pass_bounds_for(g, int(a), int(b))
                    if g is not None else None,
                )
                for (q, t), g, a, b in zip(tasks, guides, chain_a, chain_b)
            ]
        except Exception as ex:
            from calitas_tpu.utils import degradable

            if not degradable(ex):
                raise
            # Device failure degrades, not aborts: unbounded tasks just
            # run both passes on the host (output-identical).
            import logging

            logging.getLogger("calitas_tpu.PairwiseAlignSequences").warning(
                "Device pair screen unavailable; aligning unscreened.",
                exc_info=True,
            )

    from calitas_tpu.parallel.host_pool import _mp_pairwise_chunk, map_items_mp

    s = aligner.scorer
    spec = {
        "key": ("pw", s.match_score, s.mismatch_score, s.pam_match_score,
                 s.pam_mismatch_score, s.query_gap_score, s.target_gap_score,
                 max_gaps_between_guide_and_pam),
        "max_gaps": max_gaps_between_guide_and_pam,
        "mismatch_net_cost": guide_mismatch_net_cost,
        "genome_gap_net_cost": genome_gap_net_cost,
        "guide_gap_net_cost": guide_gap_net_cost,
        "pam_mismatch_net_cost": pam_mismatch_net_cost,
    }

    out = open_output(output)
    out.write("\t".join(COLUMNS) + "\n")
    for (query, target, *_extra), aln in map_items_mp(
        tasks, spec, threads,
        worker_fn=_mp_pairwise_chunk, to_payload=lambda t: t,
    ):
        fields = [
            query,
            target,
            str(aln.score),
            "1",
            str(aln.start_offset),
            str(aln.cigar),
            str(aln.mismatches),
            str(aln.gap_bases),
            aln.padded_guide,
            aln.padded_alignment,
            aln.padded_target,
        ]
        out.write("\t".join(fields) + "\n")
    if out.name != "<stdout>":
        out.close()
    else:
        out.flush()
