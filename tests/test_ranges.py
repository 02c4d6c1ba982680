"""Device end-column ranges → sliced native finish.

The screen (XLA scan and GPU kernel) reports, per window and chain, the
(min, max) 1-based end columns whose guide-only final-row DP score
reaches min_score.  The native finisher then runs the DP only on the
containing column slice (aligner.cpp::run_pass_collect).  These tests pin

  1. the reported ranges against a brute-force DP final row, and
  2. the sliced finish against the unsliced finish and the Python engine
     (exactness: every kept alignment's qualifying end is contained in
     the range, incl. the chain-B mirror conversion and N-trim shifts).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from calitas_tpu import native
from calitas_tpu.align.batch import (
    chain_ranges_to_pass,
    finish_windows,
    max_target_span,
)
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import encode_query, revcomp
from calitas_tpu.ops.dp_screen import _screen_scores_ranges
from calitas_tpu.ops.genome_screen import GenomeScreen
from calitas_tpu.search.windows import materialize_window

KW = dict(
    max_guide_diffs=4,
    max_pam_diffs=1,
    max_gaps_between_guide_and_pam=3,
    max_total_diffs=8,
    max_overlap=5,
)


def brute_final_row(qmask, tmask, match, mismatch, qgap, tgap):
    """S[Q, 1..T] of the glocal DP (free start row, qgap horizontal)."""
    Q, T = len(qmask), len(tmask)
    S = np.zeros((Q + 1, T + 1), np.int64)
    S[:, 0] = np.arange(Q + 1) * tgap
    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            pair = match if (qmask[i - 1] & tmask[j - 1]) else mismatch
            S[i, j] = max(
                S[i - 1, j - 1] + pair, S[i, j - 1] + qgap, S[i - 1, j] + tgap
            )
    return S[Q, 1:]


def check_ranges(best_b, mn_b, mx_b, row, ms, T):
    assert int(best_b) == row.max()
    q = np.nonzero(row >= ms)[0] + 1  # 1-based qualifying ends
    if len(q):
        assert (int(mn_b), int(mx_b)) == (int(q.min()), int(q.max()))
    else:
        assert int(mn_b) == T + 1 and int(mx_b) == 0


def test_xla_screen_ranges_match_bruteforce():
    rng = np.random.default_rng(7)
    s = derive_scorer()
    Q, T, B = 12, 40, 24
    qmask = encode_query("".join(rng.choice(list("ACGT"), Q)))
    wins = rng.integers(1, 16, size=(B, T)).astype(np.uint8)
    lengths = np.full(B, T, np.int32)
    lengths[3] = 25  # short window: ends beyond the length must not count
    ms = s.match_score * Q - 2 * 120
    kw = dict(
        match=s.match_score, mismatch=s.mismatch_score,
        qgap=s.query_gap_score, tgap=s.target_gap_score,
    )
    best, mn, mx = _screen_scores_ranges(
        jnp.asarray(qmask.astype(np.uint8)), jnp.asarray(wins),
        jnp.asarray(lengths), ms, **kw,
    )
    for b in range(B):
        row = brute_final_row(qmask, wins[b], **kw)[: lengths[b]]
        check_ranges(best[b], mn[b], mx[b], row, ms, T)


def test_pallas_dual_ranges_match_bruteforce_interpret():
    from calitas_tpu.ops import dp_kernel

    rng = np.random.default_rng(3)
    s = derive_scorer()
    Q, T, B = 10, 32, 2 * dp_kernel.BLOCK_W
    query = "".join(rng.choice(list("ACGT"), Q))
    qm_fw = encode_query(query)
    qm_rc = encode_query(revcomp(query))
    wins = rng.integers(1, 16, size=(B, T)).astype(np.uint8)
    ms = s.match_score * Q - 130
    kw = dict(
        match=s.match_score, mismatch=s.mismatch_score,
        qgap=s.query_gap_score, tgap=s.target_gap_score,
    )
    qv = jnp.asarray(np.stack([qm_fw, qm_rc])[None].astype(np.int32))
    best, ranges = dp_kernel.screen_multi(
        qv, dp_kernel.pack_tcols(jnp.asarray(wins)), jnp.asarray([ms]),
        T=T, Q=Q, emit_ranges=True, interpret=True, **kw
    )
    best = np.asarray(best)[0]
    ranges = np.asarray(ranges)[0]
    for b in rng.choice(B, 40, replace=False):
        for c, qm in enumerate((qm_fw, qm_rc)):
            row = brute_final_row(qm, wins[b], **kw)
            check_ranges(
                best[c, b], ranges[c, 0, b], ranges[c, 1, b], row, ms, T
            )


def _plant_sites(rng, genome, proto, n=10, with_n_block=True):
    for _ in range(n):
        pos = int(rng.integers(50, len(genome) - 50))
        site = list(proto)
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, len(site)))
            site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
        seq = "".join(site) + rng.choice(["TGG", "GAG", "CGG"])
        if rng.random() < 0.5:
            seq = revcomp(seq)
        genome[pos : pos + len(seq)] = list(seq)
    if with_n_block:
        # leading-N windows exercise the trim shift in the conversion
        p = int(rng.integers(0, len(genome) // 2))
        genome[p : p + 37] = ["N"] * 37
    return genome


def _aln_key(a):
    return (
        a.guide, a.chrom, a.start_offset, a.end_offset,
        a.guide_start_offset, a.guide_end_offset, a.strand, a.score,
        str(a.cigar), a.padded_guide, a.padded_alignment, a.padded_target,
        a.mismatches, a.gap_bases, a.guide_mismatches, a.guide_gap_bases,
        a.pam_mismatches, a.pam_gap_bases,
    )


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
@pytest.mark.parametrize("pam", ["nrg", ""])
def test_sliced_finish_identical_to_full(pam):
    rng = np.random.default_rng(11)
    proto = "".join(rng.choice(list("ACGT"), 20))
    guide = Guide.parse(proto + pam)
    genome = _plant_sites(rng, list("".join(rng.choice(list("ACGT"), 30_000))), proto)
    bases = np.frombuffer("".join(genome).encode(), dtype=np.uint8)

    aligner = SequentialAligner()
    window, step = 200, 150
    screen = GenomeScreen(
        aligner.scorer, window=window, batch_windows=1024, use_kernel=False
    )
    dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
    min_score = aligner.min_guide_score(guide, KW["max_guide_diffs"])
    Q = len(dp_query)

    genome_dev = screen.stage(bases)
    chain_flags, cranges = screen.screen_contig(
        genome_dev, len(bases), step, dp_query, revcomp(dp_query), min_score,
        return_ranges=True,
    )
    starts = screen.window_starts(len(bases), step)
    flags = chain_flags.any(axis=0)
    hit = np.nonzero(flags)[0]
    assert len(hit) >= 3  # planted sites must flag

    windows, passes, ranges_rows = [], [], []
    for i in hit:
        s0 = int(starts[i])
        w = materialize_window("chr1", bases, s0, window)
        if len(w.bases) < len(guide.guide):
            continue
        T = len(w.bases)
        trim = w.start - (s0 + 1)
        cr = (
            int(cranges[0, i, 0]) * 8 + 1, int(cranges[0, i, 1]) * 8 + 8,
            int(cranges[1, i, 0]) * 8 + 1, int(cranges[1, i, 1]) * 8 + 8,
        )
        span = max_target_span(
            Q, aligner.scorer.match_score, aligner.scorer.query_gap_score,
            min_score, T,
        )
        windows.append((w.chrom, w.start, w.bases))
        passes.append(("fwd", "rev"))
        ranges_rows.append(chain_ranges_to_pass(cr, trim, T, span))

    sliced = finish_windows(
        guide, aligner, windows, passes,
        ranges=np.asarray(ranges_rows, np.int32), **KW,
    )
    full = finish_windows(guide, aligner, windows, passes, ranges=None, **KW)
    assert sliced is not None and full is not None
    total = 0
    for ws, a_sliced, a_full in zip(windows, sliced, full):
        assert [_aln_key(a) for a in a_sliced] == [_aln_key(a) for a in a_full]
        # and both equal the Python engine on this window
        want = aligner.align(
            guide, ws[2], target_name=ws[0], target_offset=ws[1] - 1, **KW
        )
        assert [_aln_key(a) for a in a_sliced] == [_aln_key(a) for a in want]
        total += len(a_sliced)
    assert total > 0


def test_sliced_finish_exact_at_32768_window():
    """Ranges past the former 16,384 ceiling (VERDICT r3 item 9): at
    -w 32768 the screen emits 128-column blocks and the sliced native
    finish stays row-identical to the full finish and the Python engine."""
    from calitas_tpu.ops.genome_screen import range_block

    window = 32768
    rb = range_block(window)
    assert rb == 128

    rng = np.random.default_rng(13)
    proto = "".join(rng.choice(list("ACGT"), 20))
    guide = Guide.parse(proto + "ngg")
    genome = list("".join(rng.choice(list("ACGT"), 3 * window)))
    for pos in (5_000, 40_000, 90_000):
        site = proto + "TGG"
        genome[pos : pos + len(site)] = list(site)
    bases = np.frombuffer("".join(genome).encode(), dtype=np.uint8)

    aligner = SequentialAligner()
    step = window - 64
    screen = GenomeScreen(
        aligner.scorer, window=window, batch_windows=128, use_kernel=False
    )
    dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
    min_score = aligner.min_guide_score(guide, KW["max_guide_diffs"])
    Q = len(dp_query)

    genome_dev = screen.stage(bases)
    chain_flags, cranges = screen.screen_contig(
        genome_dev, len(bases), step, dp_query, revcomp(dp_query), min_score,
        return_ranges=True,
    )
    starts = screen.window_starts(len(bases), step)
    hit = np.nonzero(chain_flags.any(axis=0))[0]
    assert len(hit) >= 2  # planted sites must flag

    windows, passes, ranges_rows = [], [], []
    for i in hit:
        s0 = int(starts[i])
        w = materialize_window("chr1", bases, s0, window)
        if len(w.bases) < len(guide.guide):
            continue
        T = len(w.bases)
        trim = w.start - (s0 + 1)
        cr = (
            int(cranges[0, i, 0]) * rb + 1, (int(cranges[0, i, 1]) + 1) * rb,
            int(cranges[1, i, 0]) * rb + 1, (int(cranges[1, i, 1]) + 1) * rb,
        )
        span = max_target_span(
            Q, aligner.scorer.match_score, aligner.scorer.query_gap_score,
            min_score, T,
        )
        windows.append((w.chrom, w.start, w.bases))
        passes.append(("fwd", "rev"))
        ranges_rows.append(chain_ranges_to_pass(cr, trim, T, span))

    sliced = finish_windows(
        guide, aligner, windows, passes,
        ranges=np.asarray(ranges_rows, np.int32), **KW,
    )
    full = finish_windows(guide, aligner, windows, passes, ranges=None, **KW)
    assert sliced is not None and full is not None
    total = 0
    for ws, a_sliced, a_full in zip(windows, sliced, full):
        assert [_aln_key(a) for a in a_sliced] == [_aln_key(a) for a in a_full]
        total += len(a_sliced)
    assert total >= 2
