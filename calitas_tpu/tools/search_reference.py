"""SearchReference: genome-wide off-target search.

Parity contract: SearchReference.scala:402-676 (SURVEY.md §2.7, §3.1/3.2).
Two passes — plain reference windows, then (optionally) variant haplotype
windows — feed the same aligner; hits get globally deduped to canonical
per-locus alignments, sorted in dictionary order, and written as the
34-column table.

Execution engines:
  - ``host``: every window is aligned with the exact host engine.
  - ``device`` (``tpu`` is its former name, still accepted; the default
    when JAX sees an accelerator): windows are batched to the device DP
    *screen* kernel, which computes exact final-row DP scores
    for every window x strand; only windows with a qualifying end column
    (sparse) are handed to the host engine for traceback + PAM extension.
    The screen is exact (integer DP), so results are identical.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import Defaults
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.io.fasta import IndexedFasta, extract_dictionary
from calitas_tpu.search.hits import (
    HitBuilder,
    ReferenceHit,
    RenderedBlock,
    count_rows,
)
from calitas_tpu.utils import ENGINES, camel_to_gnu

logger = logging.getLogger("calitas_tpu.SearchReference")


def core_parameters_string(
    max_variants, window_size, max_guide_diffs, max_pam_mismatches,
    max_gaps_between_guide_and_pam, max_total_diffs_actual, max_overlap,
    guide_mismatch_net_cost, pam_mismatch_net_cost, genome_gap_net_cost,
    guide_gap_net_cost,
) -> str:
    """The aligner_other_parameters column (SearchReference.scala:496-508)."""
    params = {
        "maxVariants": max_variants,
        "windowSize": window_size,
        "maxGuideDiffs": max_guide_diffs,
        "maxPamMismatches": max_pam_mismatches,
        "maxGapsBetweenGuideAndPam": max_gaps_between_guide_and_pam,
        "maxTotalDiffs": max_total_diffs_actual,
        "maxOverlap": max_overlap,
        "guideMismatchNetCost": guide_mismatch_net_cost,
        "pamMismatchNetCost": pam_mismatch_net_cost,
        "genomeGapNetCost": genome_gap_net_cost,
        "guideGapNetCost": guide_gap_net_cost,
    }
    return ";".join(sorted(f"{camel_to_gnu(k)}={v}" for k, v in params.items()))


def run(
    guide: Optional[str] = None,
    guide_id: Optional[str] = None,
    ref: str | Path = None,
    auxiliary_pams: Sequence[str] = (),
    guide_specs: Optional[Sequence[tuple[str, str, Sequence[str]]]] = None,
    variants: Optional[str | Path] = None,
    max_variants: int = Defaults.MAX_VARIANTS_IN_CLUSTER,
    output: Optional[str | Path] = None,
    threads: int = 8,
    window_size: int = 1000,
    max_guide_diffs: int = Defaults.MAX_GUIDE_DIFFS,
    max_pam_mismatches: int = Defaults.MAX_PAM_MISMATCHES,
    max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
    max_total_diffs: Optional[int] = None,
    max_overlap: int = Defaults.MAX_OVERLAP,
    guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    chrom: Optional[str] = None,
    engine: str = "auto",  # one of ENGINES
    profile_dir: Optional[str] = None,
    checkpoint: Optional[str | Path] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    distributed: bool = False,
    mesh=None,  # jax.sharding.Mesh: shard both passes' device screens
    _vcf_index=None,  # injectable prebuilt VcfIndex (tests / resident serving)
    _screen=None,  # injectable GenomeScreen (resident serving)
    _prestaged=None,  # {contig: staged device array} (resident serving)
) -> None:
    import time as _time

    run_start = _time.perf_counter()
    if distributed:
        # On a jax.distributed deployment (multi-host), initialize()
        # picks coordinator + process identity up from the cluster
        # environment (Slurm / MPI); the contig partition below then
        # keys off the process identity automatically.  Outside those
        # clusters the coordinator can be given explicitly via
        # JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
        # (exercised by the two-process CPU-backend test in
        # tests/test_multihost.py).
        import os as _os

        import jax

        _coord = _os.environ.get("JAX_COORDINATOR_ADDRESS")
        if _coord:
            _n = int(_os.environ["JAX_NUM_PROCESSES"])
            _pid = int(_os.environ["JAX_PROCESS_ID"])
            jax.distributed.initialize(
                coordinator_address=_coord, num_processes=_n,
                process_id=_pid,
            )
            # The explicit identity IS the process identity (initialize
            # verified it against the coordinator); the default backend
            # may be single-process (e.g. CPU without gloo collectives).
            if process_index is None:
                process_index = _pid
            if process_count is None:
                process_count = _n
        else:
            jax.distributed.initialize()
        if process_index is None:
            process_index = jax.process_index()
        if process_count is None:
            process_count = jax.process_count()
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    if ref is None:
        raise ValueError("SearchReference requires a reference FASTA (ref=)")
    ref = Path(ref)
    dictionary = extract_dictionary(ref)  # required (SearchReference.scala:478-484)
    ref_file = IndexedFasta(ref)

    # Multi-host launcher (SURVEY.md §2.10): each process runs the whole
    # tool over its deterministic whole-contig shard and writes a raw
    # per-host table; MergeHitTables concatenates + dictionary-sorts the
    # per-host outputs into the canonical global table (provably
    # row-identical — dedup groups never span contigs).
    shard_contigs: Optional[list[str]] = None
    if process_count is not None:
        from calitas_tpu.parallel.multihost import host_contig_partition

        if process_index is None:
            raise ValueError("--process-count requires --process-index")
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}"
            )
        if chrom is not None:
            raise ValueError("--chrom cannot be combined with --process-count")
        shard_contigs = host_contig_partition(
            [(e.name, e.length) for e in dictionary.entries],
            process_index, process_count,
        )
        logger.info(
            "Multi-host shard %d/%d: %d of %d contigs.",
            process_index, process_count, len(shard_contigs), len(dictionary),
        )

    aligner = SequentialAligner(
        mismatch_net_cost=guide_mismatch_net_cost,
        pam_mismatch_net_cost=pam_mismatch_net_cost,
        genome_gap_net_cost=genome_gap_net_cost,
        guide_gap_net_cost=guide_gap_net_cost,
    )
    max_total_diffs_actual = (
        max_total_diffs
        if max_total_diffs is not None
        else max_guide_diffs + max_gaps_between_guide_and_pam + max_pam_mismatches
    )
    arguments = core_parameters_string(
        max_variants, window_size, max_guide_diffs, max_pam_mismatches,
        max_gaps_between_guide_and_pam, max_total_diffs_actual, max_overlap,
        guide_mismatch_net_cost, pam_mismatch_net_cost, genome_gap_net_cost,
        guide_gap_net_cost,
    )
    # One or many guides: a multi-guide run reuses the staged genome on
    # device (extension over the reference, which is one guide per run).
    if guide_specs is None:
        if guide is None or guide_id is None:
            raise ValueError("Provide either guide+guide_id or guide_specs")
        guide_specs = [(guide_id, guide, tuple(auxiliary_pams))]
    specs = [
        (gid, gstr, Guide.parse(gstr, aux)) for gid, gstr, aux in guide_specs
    ]

    # Completeness-guarantee check (documented constraint,
    # SearchReference.scala:433-441): warn when custom costs can lose
    # valid alignments.
    mags = [abs(guide_mismatch_net_cost), abs(genome_gap_net_cost),
            abs(guide_gap_net_cost)]
    if (max_guide_diffs + 1) * min(mags) <= max_guide_diffs * max(mags):
        logger.warning(
            "Scoring constraint violated: (max-guide-diffs+1)*min_cost must "
            "exceed max-guide-diffs*max_cost or alignments within the given "
            "limits may be missed (min=%d max=%d max-guide-diffs=%d).",
            min(mags), max(mags), max_guide_diffs,
        )

    hits: list[ReferenceHit] = []
    base_builder = HitBuilder(
        guide_id=specs[0][0],
        guide=specs[0][2],
        ref=ref_file,
        vcf=variants,
        aligner_id="CALITAS:SearchReference",
        arguments=arguments,
    )
    builders = {specs[0][0]: base_builder}
    for gid, _, g in specs[1:]:
        b = base_builder.copy(guide_id=gid, guide=g)
        builders[gid] = b

    align_kwargs = dict(
        max_guide_diffs=max_guide_diffs,
        max_pam_diffs=max_pam_mismatches,
        max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
        max_total_diffs=max_total_diffs_actual,
        max_overlap=max_overlap,
    )

    # ------------------------------------------------------------------
    # Pass 1: the unaltered reference (SearchReference.scala:527-564)
    # ------------------------------------------------------------------
    logger.info("Aligning to reference genome without variants.")

    from calitas_tpu.utils import ProgressLogger

    def step_for(guide_str: str) -> int:
        window_overlap = (
            len(guide_str) + max_guide_diffs + max_gaps_between_guide_and_pam - 1
        )
        return window_size - window_overlap

    progress = ProgressLogger(logger, noun="windows", verb="Processed", unit=25_000)
    use_device = _resolve_engine(engine)
    if use_device and window_size > 2048:
        from calitas_tpu.ops.genome_screen import range_block

        # Ranges stay on at any width but get coarser (range_block
        # doubles past 2048 columns): each candidate's DP slice widens
        # by up to a block per side.  Worth a note, not a warning.
        logger.info(
            "--window-size %d > 2048: end-column ranges use coarser "
            "%d-column blocks (slightly wider finish DP slices).",
            window_size, range_block(window_size),
        )

    # Parse + index the VCF once per run; every guide / checkpointed
    # contig queries the in-memory index (the reference's per-chromosome
    # indexed VariantSource, SearchReference.scala:227-231).
    vcf_index = _vcf_index
    if variants is not None and vcf_index is None:
        from calitas_tpu.io.vcf import VcfIndex

        vcf_index = VcfIndex(variants)

    if checkpoint is not None:
        from calitas_tpu.search.checkpoint import CheckpointState

        # Every input that shapes the output table belongs in the
        # fingerprint — aux PAMs, the VCF content identity (md5, not
        # just the path), the aligner version, and any contig/shard
        # restriction included — so a resume with changed inputs REFUSES
        # instead of silently merging stale rows.
        from calitas_tpu.search.hits import md5_of_file
        from calitas_tpu.version import aligner_version

        fingerprint = "|".join(
            [
                arguments, str(ref),
                f"variants={variants}:"
                f"{md5_of_file(variants) if variants is not None else ''}",
                f"chrom={chrom}",
                f"shard={process_index}/{process_count}",
                f"version={aligner_version()}",
            ]
            + sorted(
                gid + ":" + gstr + ":" + ",".join(aux)
                for gid, gstr, aux in guide_specs
            )
        )
        state = CheckpointState.open(checkpoint, fingerprint)
        if state.timestamp is not None:
            # Resumed rows keep the original run-start timestamp.
            for b in builders.values():
                b.timestamp = state.timestamp
        else:
            state.set_timestamp(base_builder.timestamp)
        hits.extend(state.hits)
        if shard_contigs is not None:
            contig_list = shard_contigs
        else:
            contig_list = [chrom] if chrom is not None else ref_file.names
        for name in contig_list:
            if state.is_done(name):
                logger.info("Checkpoint: skipping completed contig %s.", name)
                continue
            contig_hits: list[ReferenceHit] = []
            _run_both_passes(
                name, contig_hits, specs, builders, aligner, ref_file,
                vcf_index, max_variants, window_size, step_for, use_device,
                threads, align_kwargs, progress, logger,
                screen=_screen, prestaged=_prestaged, mesh=mesh,
            )
            state.record(name, contig_hits)
            hits.extend(contig_hits)
        _finalize(
            hits, max_overlap, dictionary, output, profile_dir, run_start,
            specs, logger,
        )
        return
    if shard_contigs is not None:
        for name in shard_contigs:
            _run_both_passes(
                name, hits, specs, builders, aligner, ref_file, vcf_index,
                max_variants, window_size, step_for, use_device, threads,
                align_kwargs, progress, logger,
                screen=_screen, prestaged=_prestaged, mesh=mesh,
            )
    else:
        _run_both_passes(
            chrom, hits, specs, builders, aligner, ref_file, vcf_index,
            max_variants, window_size, step_for, use_device, threads,
            align_kwargs, progress, logger,
            screen=_screen, prestaged=_prestaged, mesh=mesh,
        )
    _finalize(
        hits, max_overlap, dictionary, output, profile_dir, run_start,
        specs, logger,
    )


def _run_both_passes(
    chrom, hits, specs, builders, aligner, ref_file, variants, max_variants,
    window_size, step_for, use_device, threads, align_kwargs, progress, logger,
    screen=None, prestaged=None, mesh=None,
):
    """Both search passes (reference windows + variant windows) for one
    chromosome restriction (or the whole genome when chrom is None),
    appending ReferenceHits to ``hits``."""
    from calitas_tpu.utils import ProgressLogger

    hits_progress = ProgressLogger(
        logger, noun="hits", verb="Collected", unit=25_000
    )

    # Start the variant-pass feeds BEFORE the reference pass (use_device
    # only): the native window builder + device screen produce from a
    # BlockFeed thread immediately, overlapping pass 1 — the builder is
    # the variant pass's dominant host phase, and serialized behind
    # pass 1 it was pure added wall-clock.  Host-engine runs keep the
    # lazy iterator (the host pass already saturates every core).
    variant_feeds = _start_variant_feeds(
        chrom, specs, aligner, ref_file, variants, max_variants, step_for,
        use_device, align_kwargs, mesh,
    )

    def _close_feeds():
        for _gspecs, feed in variant_feeds or ():
            if hasattr(feed, "close"):
                feed.close()  # idempotent; stops a still-producing thread

    try:
        _reference_pass(
            chrom, hits, specs, builders, aligner, ref_file, window_size,
            step_for, use_device, threads, align_kwargs, progress,
            hits_progress, logger, screen, prestaged, mesh,
        )
        logger.info("Reference windows processed.")

        if variant_feeds is not None:
            _variant_pass(
                variant_feeds, hits, specs, builders, aligner, threads,
                align_kwargs, logger,
            )
            logger.info("Variant windows processed.")
    except BaseException:
        # An error in EITHER pass must stop every remaining eager
        # producer thread (builder + device screen) — a leaked feed
        # keeps screening the VCF against a device nobody is draining.
        _close_feeds()
        raise


def _reference_pass(
    chrom, hits, specs, builders, aligner, ref_file, window_size, step_for,
    use_device, threads, align_kwargs, progress, hits_progress, logger,
    screen, prestaged, mesh,
):
    """Pass 1: the unaltered reference (SearchReference.scala:527-564)."""
    if use_device:
        from calitas_tpu.parallel.screen_runner import GuideTask, screened_search

        gtasks = [
            GuideTask(
                guide_id=gid, guide=g, guide_length=len(gstr),
                step_size=step_for(gstr),
            )
            for gid, gstr, g in specs
        ]
        any_builder = next(iter(builders.values()))
        hit_spec = dict(
            ref_path=str(ref_file.path),
            aligner_id=any_builder.aligner_id,
            arguments=any_builder.arguments,
            vcf_id=any_builder.vcf_id,
            timestamp=any_builder.timestamp,
            aligner_version=any_builder.aligner_version,
        )
        for _gtask, wchrom, wstart, rows in screened_search(
            ref_file, chrom, gtasks, aligner,
            window_size=window_size, threads=threads, swallow_errors=True,
            hit_spec=hit_spec, screen=screen, prestaged=prestaged,
            mesh=mesh, **align_kwargs,
        ):
            # Columnar blocks append whole (the dedup reads their key
            # arrays directly); object rows extend as before.
            if type(rows) is RenderedBlock:
                hits.append(rows)
            else:
                hits.extend(rows)
            # The device path yields per-candidate-batch row collections,
            # not per-window results; count hits under their own noun
            # (the screen already logs the window/candidate totals).
            hits_progress.record(wchrom, wstart, n=len(rows))
    else:
        from calitas_tpu.parallel.host_pool import make_align_spec, map_windows_mp
        from calitas_tpu.search.windows import window_iterator

        for gid, gstr, g in specs:
            guide_length = len(gstr)
            windows = (
                w
                for w in window_iterator(
                    ref_file, window_size, step_for(gstr), chrom
                )
                if len(w.bases) >= guide_length
            )

            spec = make_align_spec(g, aligner, align_kwargs)
            b = builders[gid]
            for window, results in map_windows_mp(
                windows, spec, threads, swallow_errors=True, logger=logger
            ):
                for a in results:
                    hits.append(b.build(a))
                progress.record(window.chrom, window.start)


def _start_variant_feeds(
    chrom, specs, aligner, ref_file, variants, max_variants, step_for,
    use_device, align_kwargs, mesh,
):
    """Build the variant-pass block feeds (SearchReference.scala:570-630's
    window streams), one per guide padding group.

    Guides with identical padding see an identical window stream (both
    the chunking distance and the window construction depend only on
    padding, SearchReference.scala:217-256) — so the stream is built
    ONCE per padding group and every guide in the group is aligned
    against the same materialized windows.  The VCF itself was parsed
    once per run (VcfIndex), never per guide/contig.

    On the device engine each feed is an eagerly-started
    :class:`~calitas_tpu.parallel.host_pool.BlockFeed`: the native
    window builder + device screen start producing immediately so they
    overlap the reference pass.  The host engine keeps a lazy iterator
    (its reference pass already saturates every core).  Returns
    ``[(gspecs, feed)]`` or None when there is no VCF."""
    if variants is None:
        return None
    from calitas_tpu.parallel.host_pool import BlockFeed, iter_blocks_threaded
    from calitas_tpu.search.variants import (
        screened_variant_windows_multi,
        variant_window_iterator,
    )

    max_guide_diffs = align_kwargs["max_guide_diffs"]
    max_gaps = align_kwargs["max_gaps_between_guide_and_pam"]
    groups: dict[int, list] = {}
    for spec in specs:
        padding = spec[2].length - 1 + max_guide_diffs + max_gaps
        groups.setdefault(padding, []).append(spec)
    feeds = []
    for padding, gspecs in groups.items():
        # The screened path takes raw native-builder blocks: mask rows
        # pack straight from the block buffers and only flagged windows
        # materialize Python objects.
        vwindows = variant_window_iterator(
            ref_file, variants, chrom, padding, max_variants,
            blocks=use_device,
        )
        if use_device:
            flagged = screened_variant_windows_multi(
                vwindows, aligner,
                [
                    (gid, g, aligner.min_guide_score(g, max_guide_diffs))
                    for gid, _, g in gspecs
                ],
                mesh=mesh,
            )
            feed = BlockFeed(flagged, 8192, depth=2)  # producing NOW
        else:
            # A generator FUNCTION, not a genexp: the group's id set must
            # bind at creation — feeds are drained after this loop ends,
            # when a genexp's free variables would hold the LAST group's
            # values.
            def _tag_all(stream, ids):
                for w in stream:
                    yield w, ids

            flagged = _tag_all(vwindows, frozenset(g[0] for g in gspecs))
            feed = iter_blocks_threaded(flagged, 8192, depth=2)
        feeds.append((gspecs, feed))
    return feeds


def _variant_pass(
    variant_feeds, hits, specs, builders, aligner, threads, align_kwargs,
    logger,
):
    """Pass 2: reference with variants (SearchReference.scala:570-630) —
    drain the (already-producing) feeds through the finish pool."""
    from calitas_tpu.search.variants import flank_and_absolutize
    from calitas_tpu.utils import ProgressLogger

    vprogress = ProgressLogger(
        logger, noun="variant windows", verb="Processed", unit=100_000
    )
    per_guide_rows: dict[str, list] = {gid: [] for gid, _, _ in specs}
    for gspecs, feed in variant_feeds:
        # Window DP fans out to the worker pool in blocks (the
        # reference pools variant windows too, SearchReference.scala
        # :582); variant bookkeeping (lift-back, annotation, row
        # build) stays in the parent where the VariantWindow lives.
        from calitas_tpu.parallel.host_pool import (
            _mp_align_chunk_batched,
            make_align_spec,
            map_items_mp,
        )

        specs_by_gid = {
            gid: make_align_spec(g, aligner, align_kwargs)
            for gid, _gstr, g in gspecs
        }

        def process_block(block):
            for gid, _gstr, g in gspecs:
                wins = [vw for vw, keys in block if gid in keys]
                if not wins:
                    continue
                b = builders[gid]
                rows = per_guide_rows[gid]
                for vw, results in map_items_mp(
                    wins, specs_by_gid[gid], threads,
                    worker_fn=_mp_align_chunk_batched,
                    to_payload=lambda vw: (
                        vw.chrom, 1, vw.bases, ("fwd", "rev"),
                    ),
                    swallow_errors=True, logger=logger,
                ):
                    for a in flank_and_absolutize(results, vw):
                        rows.append(b.build(a, vw.variants))
            for vw, _keys in block:
                vprogress.record(vw.chrom, vw.start)

        for block in feed:
            process_block(block)
    # Guide-major append order, exactly as the previous per-guide loop
    # produced (keeps dedup/sort tie-breaks insertion-stable).
    for gid, _, _ in specs:
        hits.extend(per_guide_rows[gid])


def _finalize(
    hits, max_overlap, dictionary, output, profile_dir, run_start, specs, logger
):
    """Global dedup, sort, write, stats (SearchReference.scala:637-648)."""
    import time as _time

    logger.info("Sorting and Outputting.")
    # Fused dedup + sort + serialization: block-sourced keepers write as
    # raw blob slices — no per-row object materialization (byte-identical
    # to MetricWriter.write_all(dedup_and_sort(...)), pinned by
    # tests/test_rendered_hit.py).
    from calitas_tpu.io.tsv import fields_of
    from calitas_tpu.search.hits import dedup_sort_serialize

    body, n_keep, n_fwd = dedup_sort_serialize(hits, max_overlap, dictionary)

    if n_keep:
        fwd_fraction = n_fwd / n_keep
        if fwd_fraction > 0.52 or fwd_fraction < 0.48:
            logger.warning(
                "Strand imbalance: %f of alignments are on the F strand.",
                fwd_fraction,
            )

    header = "\t".join(fields_of(ReferenceHit)) + "\n"
    if output is None or str(output) in ("-", "/dev/stdout"):
        sys.stdout.write(header)
        sys.stdout.write(body.decode("utf-8"))
        sys.stdout.flush()
    else:
        with open(output, "wb") as out_fh:
            out_fh.write(header.encode("utf-8"))
            out_fh.write(body)

    if profile_dir:
        import jax

        jax.profiler.stop_trace()
    elapsed = _time.perf_counter() - run_start
    total_bases = sum(e.length for e in dictionary) if dictionary else 0
    logger.info(
        "Done: %d guides, %s genome bases, %d raw hits, %d kept, %.1fs (%.2g bases/s).",
        len(specs), f"{total_bases:,}", count_rows(hits), n_keep, elapsed,
        (total_bases * len(specs)) / elapsed if elapsed > 0 else 0.0,
    )


#: below this many items the list-driven tools' auto engine stays on the
#: host: the device pair screen's one-time compilation only pays for
#: itself on large batches (the host engine is ~10 ms/item)
AUTO_DEVICE_MIN_TASKS = 1000

def _resolve_engine(
    engine: str,
    n_tasks: Optional[int] = None,
    prefer_host_when_native: bool = False,
) -> bool:
    """True when the run screens on the device.  ``auto`` picks the device
    whenever JAX's default backend is an accelerator (and, for the
    list-driven tools, the batch is large enough to amortize the device
    compilation, and the native host library is missing: those tools'
    batched native worker is the default there).  The chosen device is
    logged once."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if engine == "host":
        return False
    if engine == "auto":
        if n_tasks is not None and n_tasks < AUTO_DEVICE_MIN_TASKS:
            return False
        if prefer_host_when_native:
            from calitas_tpu import native

            if native.available():
                return False
        import jax

        if jax.default_backend() == "cpu":
            return False
    _log_device()
    return True


def _log_device() -> None:
    import jax

    devs = jax.devices()
    logging.getLogger("calitas_tpu.engine").info(
        "Screening on %s (%s), %d device(s).",
        devs[0].platform, devs[0].device_kind, len(devs),
    )
