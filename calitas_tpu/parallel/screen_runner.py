"""Device execution of the genome search: device-resident screen, host finish.

The execution strategy for SearchReference (SURVEY.md §2.10, §7): each
contig's mask array is staged to device memory once; the device
extracts every search window, screens both strands with the exact int32
DP kernel, and returns one flag per window.  Only flagged windows (hits
are sparse at default thresholds) are materialized with the reference's
exact window semantics (N-trim, uppercase) and run through the host
alignment engine.  Output is therefore bit-identical to the host-only
path.

Multi-guide searches reuse the staged genome: the contig loop is outer,
the guide loop inner, so the genome is uploaded once per contig no matter
how many guides are searched (the reference JVM re-scans the genome per
guide invocation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from calitas_tpu.core.guide import Guide
from calitas_tpu.core.sequence import revcomp
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.io.fasta import IndexedFasta
from calitas_tpu.ops.genome_screen import BATCH_WINDOWS, GenomeScreen, range_block
from calitas_tpu.search.windows import materialize_window
from calitas_tpu.utils import degradable, note_degraded


#: candidates per array-batch item shipped to the finish workers (one
#: columnar RenderedBlock comes back per item)
_CAND_BATCH = 1024

#: resolve segment readbacks on a small thread pool instead of serially
#: in the candidate stream (each serial resolve waits on one readback);
#: False = serial, the in-process A/B baseline
PREFETCH_RESOLVES = True


def _memoize(resolve):
    """Resolve once, serve every caller (a guide group's segment readback
    is shared by all its guides' candidate streams)."""
    cell: list = []

    def get():
        if not cell:
            cell.append(resolve())
        return cell[0]

    return get


@dataclass(frozen=True)
class GuideTask:
    """One guide's search parameters within a (possibly multi-guide) run."""

    guide_id: str
    guide: Guide
    guide_length: int  # raw guide-string length (window length filter)
    step_size: int  # window step for this guide's overlap math


def screened_search(
    fasta: IndexedFasta,
    chrom: Optional[str],
    tasks: Sequence[GuideTask],
    aligner: SequentialAligner,
    *,
    window_size: int,
    batch_windows: int = BATCH_WINDOWS,
    threads: int = 1,
    mesh=None,
    swallow_errors: bool = False,
    hit_spec: Optional[dict] = None,
    screen: Optional[GenomeScreen] = None,
    prestaged: Optional[dict] = None,
    **align_kwargs,
) -> Iterator[tuple]:
    """Search every contig with the device screen + batched native finish.

    With ``hit_spec`` (ref_path, aligner_id, arguments, vcf_id, timestamp)
    the workers build the final ReferenceHit rows themselves and the
    iterator yields ``(task, chrom, start, [ReferenceHit, ...])`` — the
    production path: the parent process never touches window bases.
    Without it, yields ``(task, window, [GuideAlignment, ...])`` (used by
    tests that inspect alignments).  Contigs outer (staged once), guides
    inner."""
    if screen is None:
        if mesh is not None and mesh.devices.size > 1:
            from calitas_tpu.ops.genome_screen import ShardedGenomeScreen

            screen = ShardedGenomeScreen(
                aligner.scorer, mesh, window=window_size,
                batch_windows=batch_windows,
            )
        else:
            screen = GenomeScreen(
                aligner.scorer, window=window_size, batch_windows=batch_windows
            )

    names = [chrom] if chrom is not None else fasta.names

    # Contig pipeline: a one-slot staging thread reads + uploads contig
    # N+1 while contig N is screened and finished, hiding the per-contig
    # disk read + H2D behind compute (at most two staged contigs live in
    # device memory at once).  Callers that keep a genome resident across
    # runs (serving, benchmarks) can pass ``prestaged={name: staged}`` to
    # skip staging entirely.  Contig bases are only loaded for staging —
    # the production (hit_spec) path's workers materialize candidate
    # windows from the mmap'd reference themselves.
    _SKIP = object()  # contig too short to search at all

    def stage_contig(name: str):
        contig_len = fasta.sequence_length(name) or 0
        if contig_len < 2:
            return name, contig_len, _SKIP
        genome_dev = (prestaged or {}).get(name)
        if genome_dev is None:
            try:
                genome_dev = screen.stage(fasta.get_bases(name))
            except Exception as ex:
                if not degradable(ex):
                    raise
                # Device staging failure degrades to the host-only path
                # for this contig (None genome_dev -> all-candidates).
                note_degraded("staging", name)
                genome_dev = None
        return name, contig_len, genome_dev

    from concurrent.futures import ThreadPoolExecutor

    stager = ThreadPoolExecutor(max_workers=1)
    try:
        nxt = stager.submit(stage_contig, names[0]) if names else None
        for idx in range(len(names)):
            name, contig_len, genome_dev = nxt.result()
            nxt = (
                stager.submit(stage_contig, names[idx + 1])
                if idx + 1 < len(names)
                else None
            )
            if genome_dev is _SKIP:
                continue
            bases = None
            yield from _search_contig(
                fasta, name, contig_len, genome_dev, bases, tasks, aligner,
                screen, window_size, threads, swallow_errors, hit_spec,
                align_kwargs,
            )
    finally:
        stager.shutdown(wait=False, cancel_futures=True)


def _search_contig(
    fasta, name, contig_len, genome_dev, bases, tasks, aligner, screen,
    window_size, threads, swallow_errors, hit_spec, align_kwargs,
):

    # Production path: pre-dispatch every guide's SEGMENTED screen before
    # any finishing starts — the device works through all guides' spans
    # back to back while the host pool finishes earlier guides' candidates.
    # Same-shape guide groups (equal DP-query length, step and PAM spec)
    # share ONE fused dispatch per span: the window blocks are extracted,
    # transposed and PAM-annotated once for the whole group, and the
    # fused kernel screens each window block for every guide — with the
    # full single-guide contract (PAM gate + per-guide end-column
    # ranges), so the sliced finish applies to every guide.
    # Ranges scale to any window width (range_block doubles so 256 uint8
    # blocks always cover the window), so the sliced finish + segmented
    # pipeline stay on at every legal -w.
    want_ranges = hit_spec is not None
    seg_dispatch: dict = {}
    # Both the single-device and the mesh-sharded screens provide the
    # segmented async interface with identical flag/range semantics.
    if want_ranges and genome_dev is not None and isinstance(
        screen, GenomeScreen
    ):
        def _task_shape(task):
            g = task.guide
            dq = g.guide_rc if g.pam_is_5prime else g.guide_fw
            dp_pams = g.pams_rc if g.pam_is_5prime else g.pams_fw
            pspec = (
                (
                    tuple(dp_pams),
                    align_kwargs["max_pam_diffs"],
                    align_kwargs["max_gaps_between_guide_and_pam"],
                )
                if dp_pams
                else None
            )
            return dq, pspec

        shape_groups: dict[tuple, list] = {}
        for task in tasks:
            dq, pspec = _task_shape(task)
            shape_groups.setdefault(
                (len(dq), task.step_size, pspec), []
            ).append((task, dq, pspec))

        # Both the single-device and the mesh-sharded screens provide the
        # fused multi-async interface with per-guide-identical semantics.
        can_fuse = isinstance(screen, GenomeScreen)
        for (_qlen, step_size, pspec), group in shape_groups.items():
            try:
                if len(group) >= 2 and can_fuse:
                    dqs = [(dq, revcomp(dq)) for _, dq, _ in group]
                    mss = [
                        aligner.min_guide_score(
                            t.guide, align_kwargs["max_guide_diffs"]
                        )
                        for t, _, _ in group
                    ]
                    segs = screen.screen_contig_multi_async(
                        genome_dev, contig_len, step_size, dqs, mss,
                        pam_spec=pspec,
                    )
                    # Per-guide views over the group's memoized resolvers:
                    # the group resolves once; guide gi reads its slice.
                    memo = [
                        (i0, n_seg, _memoize(res)) for i0, n_seg, res in segs
                    ]
                    for gi, (task, _, _) in enumerate(group):
                        seg_dispatch[task.guide_id] = [
                            (
                                i0, n_seg,
                                (lambda get=get, gi=gi:
                                 (lambda r: (r[0][gi], r[1][gi]))(get())),
                            )
                            for i0, n_seg, get in memo
                        ]
                else:
                    for task, dq, _ in group:
                        seg_dispatch[task.guide_id] = (
                            screen.screen_contig_async(
                                genome_dev, contig_len, task.step_size, dq,
                                revcomp(dq),
                                aligner.min_guide_score(
                                    task.guide,
                                    align_kwargs["max_guide_diffs"],
                                ),
                                pam_spec=pspec,
                            )
                        )
            except Exception as ex:
                if not degradable(ex):
                    raise
                note_degraded(
                    "segmented screen dispatch",
                    f"{name}, {len(group)} guides; single-span screen",
                )

    # Group same-length guides: one window-extraction pass per group
    # (the multi-guide kernel re-uses each window block across guides).
    groups: dict[tuple[int, int], list[GuideTask]] = {}
    for task in tasks:
        if task.guide_id in seg_dispatch:
            continue  # already covered by a segmented dispatch
        g = task.guide
        dp_q = g.guide_rc if g.pam_is_5prime else g.guide_fw
        groups.setdefault((len(dp_q), task.step_size), []).append(task)
    multi_flags: dict[str, np.ndarray] = {}
    if type(screen) is GenomeScreen:  # sharded subclass screens per guide
        from calitas_tpu.ops.genome_screen import screen_contig_multi

        for (_, step_size), group in groups.items():
            if len(group) < 2:
                continue
            dq = []
            ms = []
            for t in group:
                g = t.guide
                q = g.guide_rc if g.pam_is_5prime else g.guide_fw
                dq.append((q, revcomp(q)))
                ms.append(
                    aligner.min_guide_score(
                        g, align_kwargs["max_guide_diffs"]
                    )
                )
            try:
                flags_g = screen_contig_multi(
                    screen, genome_dev, contig_len, step_size, dq, ms
                )
            except Exception as ex:
                if not degradable(ex):
                    raise
                # fall back to per-guide screening (correctness is
                # unaffected; only the feed amortization is lost)
                note_degraded("multi-guide screen", "per-guide screening")
                continue
            for i, t in enumerate(group):
                multi_flags[t.guide_id] = flags_g[i]

    for task in tasks:
        guide = task.guide
        min_score = aligner.min_guide_score(
            guide, align_kwargs["max_guide_diffs"]
        )
        dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
        # DP-orientation PAMs enable the kernel's PAM prefilter: for
        # 5'-PAM guides the DP query is the revcomp'd guide, whose
        # PAMs in DP space are the revcomp'd PAMs.
        dp_pams = guide.pams_rc if guide.pam_is_5prime else guide.pams_fw
        pam_spec = (
            (
                tuple(dp_pams),
                align_kwargs["max_pam_diffs"],
                align_kwargs["max_gaps_between_guide_and_pam"],
            )
            if dp_pams
            else None
        )
        chain_flags = None
        cranges = None  # [2, n, 2] uint8 coarse end-column blocks
        # Ranges let the native finish run the DP on a column slice
        # instead of the whole window; uint8 blocks of range_block()
        # columns cover any window width (the block scales).
        starts = screen.window_starts(contig_len, task.step_size)

        # Pipelined production path: the screen was dispatched above as
        # several independent window spans (for every guide at once);
        # the candidate stream resolves spans lazily so the worker pool
        # finishes span N while the device screens span N+1 and later
        # guides (flags identical to the one-span screen — same device
        # batch loop).
        segs = seg_dispatch.get(task.guide_id)
        if segs is not None:
            yield from _finish_segments(
                segs, starts, fasta, name, task, guide, aligner, screen,
                window_size, threads, swallow_errors, hit_spec,
                align_kwargs, min_score,
            )
            continue
        try:
            if genome_dev is None:
                # staging failed (counted there): every window on the host
                hit_idx = np.arange(len(starts))
            else:
                if task.guide_id in multi_flags:
                    chain_flags = multi_flags[task.guide_id]  # [2, n]
                elif want_ranges:
                    chain_flags, cranges = screen.screen_contig(
                        genome_dev, contig_len, task.step_size, dp_query,
                        revcomp(dp_query), min_score, pam_spec=pam_spec,
                        return_ranges=True,
                    )
                else:
                    chain_flags = screen.screen_contig(
                        genome_dev, contig_len, task.step_size, dp_query,
                        revcomp(dp_query), min_score, pam_spec=pam_spec,
                        return_chains=True,
                    )
                hit_idx = np.nonzero(chain_flags.any(axis=0))[0]
        except Exception as ex:
            if not degradable(ex):
                raise  # programming error: propagate, don't mask 100x slow
            # Device failure degrades, not aborts: align EVERY window of
            # this contig on the host (the screen is a pure accelerator —
            # all-candidates is exactly the host engine's work list, so
            # output is unchanged).  Mirrors the reference's log-and-
            # continue failure policy (SearchReference.scala:555-559).
            note_degraded("contig screen", f"{name}/{task.guide_id}")
            chain_flags = None
            cranges = None
            hit_idx = np.arange(len(starts))
        n_cand = len(hit_idx)

        import logging

        log = logging.getLogger("calitas_tpu.SearchReference")
        log.info(
            "Screen %s/%s: %d of %d windows are candidates (%.2f%%).",
            name, task.guide_id, len(hit_idx), len(starts),
            100.0 * len(hit_idx) / max(len(starts), 1),
        )

        if hit_spec is not None:
            # Production path: candidates ship to the workers as ARRAY
            # batches (one item per ~1k windows: starts + chain-flag
            # codes + widened ranges); each worker returns one columnar
            # RenderedBlock — per-candidate work is all native.
            from calitas_tpu.parallel.host_pool import (
                _mp_finish_chunk,
                make_finish_spec,
                map_items_mp,
            )

            spec = make_finish_spec(
                guide, aligner, align_kwargs,
                guide_id=task.guide_id,
                window_size=window_size,
                guide_length=task.guide_length,
                swallow_errors=swallow_errors,
                **hit_spec,
            )
            cstarts = starts[hit_idx]
            sel = (
                (
                    chain_flags[0, hit_idx].astype(np.uint8)
                    + 2 * chain_flags[1, hit_idx].astype(np.uint8)
                )
                if chain_flags is not None
                else None
            )
            # Widen the coarse range blocks back to 1-based column
            # bounds (the worker trim-shifts, mirrors chain B and clips
            # — align/batch.py::chain_ranges_to_pass).
            cr4 = None
            if cranges is not None and n_cand:
                rb = range_block(window_size)
                cr = cranges[:, hit_idx, :].astype(np.int32) * rb
                cr4 = np.stack(
                    [cr[0, :, 0] + 1, cr[0, :, 1] + rb,
                     cr[1, :, 0] + 1, cr[1, :, 1] + rb], axis=1
                )

            def cand():
                for c0 in range(0, n_cand, _CAND_BATCH):
                    c1 = c0 + _CAND_BATCH
                    yield (
                        "__batch__", name, cstarts[c0:c1],
                        None if sel is None else sel[c0:c1],
                        None if cr4 is None else cr4[c0:c1],
                    )

            for (_tag, c, bstarts, *_rest), rows in map_items_mp(
                cand(), spec, threads,
                worker_fn=_mp_finish_chunk,
                to_payload=lambda t: t,
                chunk=1,
                swallow_errors=swallow_errors,
                logger=log,
            ):
                if len(rows):
                    yield task, c, int(bstarts[0]) + 1, rows
            continue

        # chain A (DP-orientation query over the forward genome) IS the
        # engine's fwd pass for 3'/PAM-less guides and the rev pass for
        # 5'-PAM guides; chain B is the mirror-equivalent of the other
        # pass, so a chain below threshold lets the host skip that pass
        # (a skipped pass would contribute no alignments anyway).
        chain_a_pass = "rev" if guide.pam_is_5prime else "fwd"
        chain_b_pass = "fwd" if guide.pam_is_5prime else "rev"
        cstarts = starts[hit_idx].tolist() if n_cand else []
        if chain_flags is not None and n_cand:
            _ptab = (
                (), (chain_a_pass,), (chain_b_pass,),
                (chain_a_pass, chain_b_pass),
            )
            sel = (
                chain_flags[0, hit_idx].astype(np.int8)
                + 2 * chain_flags[1, hit_idx].astype(np.int8)
            )
            passes_l = [_ptab[k] for k in sel.tolist()]
        else:
            passes_l = [("fwd", "rev")] * n_cand

        if bases is None:
            bases = fasta.get_bases(name)
        cand_pairs = (
            (materialize_window(name, bases, s, window_size), ps)
            for s, ps in zip(cstarts, passes_l)
        )
        cand_pairs = (
            (w, ps)
            for (w, ps) in cand_pairs
            if len(w.bases) >= task.guide_length
        )

        from calitas_tpu.parallel.host_pool import (
            _mp_align_chunk_batched,
            make_align_spec,
            map_items_mp,
        )

        spec = make_align_spec(guide, aligner, align_kwargs)
        for (w, _ps), results in map_items_mp(
            cand_pairs, spec, threads,
            worker_fn=_mp_align_chunk_batched,
            to_payload=lambda t: (t[0].chrom, t[0].start, t[0].bases, t[1]),
            swallow_errors=swallow_errors,
            logger=log,
        ):
            if results:
                yield task, w, results


def _finish_segments(
    segs, starts, fasta, name, task, guide, aligner, screen, window_size,
    threads, swallow_errors, hit_spec, align_kwargs, min_score,
):
    """Consume a segmented contig screen (screen_contig_async): resolve
    each span's flags lazily inside the candidate stream so the worker
    pool finishes span N while the device screens span N+1.  A span
    whose readback fails degrades that span and every later one to
    unscreened host alignment (identical output, like the classic
    path's whole-contig degradation)."""
    import logging

    log = logging.getLogger("calitas_tpu.SearchReference")
    stats = {"cand": 0}

    # Resolve the spans' (tiny, already-async-copied) readbacks on a
    # small thread pool instead of one by one in the candidate stream,
    # where each serial resolve would stall candidate production behind
    # the screen.  Results are consumed in span order, so flags/ranges
    # and the ordered-yield contract are untouched; a failed readback still degrades that span and every
    # later one (their prefetched resolves fail the same way).
    from concurrent.futures import ThreadPoolExecutor

    if PREFETCH_RESOLVES:
        resolver = ThreadPoolExecutor(
            max_workers=min(4, max(1, len(segs))),
            thread_name_prefix="calitas-resolve",
        )
        futs = [resolver.submit(resolve) for _i0, _n, resolve in segs]
    else:  # A/B baseline: resolve serially inside the candidate stream
        resolver = None

        class _Lazy:
            def __init__(self, fn):
                self._fn = fn

            def result(self):
                return self._fn()

        futs = [_Lazy(resolve) for _i0, _n, resolve in segs]

    def cand_stream():
        degraded = False
        for (i0, n_seg, _resolve), fut in zip(segs, futs):
            chain_flags = cranges = None
            if not degraded:
                try:
                    chain_flags, cranges = fut.result()
                except Exception as ex:
                    if not degradable(ex):
                        raise
                    degraded = True
                    note_degraded(
                        "segment readback",
                        f"{name}/{task.guide_id} from window {i0}",
                    )
            if degraded:
                stats["cand"] += n_seg
                span = starts[i0 : i0 + n_seg]
                for c0 in range(0, n_seg, _CAND_BATCH):
                    yield ("__batch__", name, span[c0 : c0 + _CAND_BATCH],
                           None, None)
                continue
            flags = chain_flags.any(axis=0)
            hit_idx = np.nonzero(flags)[0]
            n_cand = len(hit_idx)
            stats["cand"] += n_cand
            if not n_cand:
                continue
            cstarts = starts[i0 + hit_idx]
            sel = (
                chain_flags[0, hit_idx].astype(np.uint8)
                + 2 * chain_flags[1, hit_idx].astype(np.uint8)
            )
            rb = range_block(window_size)
            cr = cranges[:, hit_idx, :].astype(np.int32) * rb
            cr4 = np.stack(
                [cr[0, :, 0] + 1, cr[0, :, 1] + rb,
                 cr[1, :, 0] + 1, cr[1, :, 1] + rb], axis=1
            )
            for c0 in range(0, n_cand, _CAND_BATCH):
                c1 = c0 + _CAND_BATCH
                yield ("__batch__", name, cstarts[c0:c1], sel[c0:c1],
                       cr4[c0:c1])

    from calitas_tpu.parallel.host_pool import (
        _mp_finish_chunk,
        make_finish_spec,
        map_items_mp,
    )

    spec = make_finish_spec(
        guide, aligner, align_kwargs,
        guide_id=task.guide_id,
        window_size=window_size,
        guide_length=task.guide_length,
        swallow_errors=swallow_errors,
        **hit_spec,
    )
    try:
        for (_tag, c, bstarts, *_rest), rows in map_items_mp(
            cand_stream(), spec, threads,
            worker_fn=_mp_finish_chunk,
            to_payload=lambda t: t,
            chunk=1,
            swallow_errors=swallow_errors,
            logger=log,
        ):
            if len(rows):
                yield task, c, int(bstarts[0]) + 1, rows
    finally:
        if resolver is not None:
            resolver.shutdown(wait=False)
    log.info(
        "Screen %s/%s: %d of %d windows are candidates (%.2f%%).",
        name, task.guide_id, stats["cand"], len(starts),
        100.0 * stats["cand"] / max(len(starts), 1),
    )
