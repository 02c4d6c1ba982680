"""Differential tests: the batched native finisher vs the Python engine.

``finish_windows`` must reproduce ``SequentialAligner.align`` exactly —
same alignments, same order, same padded strings, counters and
coordinates — because the device search path swaps one for the other
(the engine itself is pinned to the reference by the transcribed tests).
"""

import numpy as np
import pytest

from calitas_tpu import native
from calitas_tpu.core.guide import Guide
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.align.batch import finish_windows

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

KW = dict(
    max_guide_diffs=5,
    max_pam_diffs=1,
    max_gaps_between_guide_and_pam=3,
    max_total_diffs=9,
    max_overlap=10,
)


def assert_same(ga, gb):
    assert ga.guide == gb.guide
    assert ga.chrom == gb.chrom
    assert ga.start_offset == gb.start_offset
    assert ga.end_offset == gb.end_offset
    assert ga.guide_start_offset == gb.guide_start_offset
    assert ga.guide_end_offset == gb.guide_end_offset
    assert ga.strand == gb.strand
    assert ga.score == gb.score
    assert str(ga.cigar) == str(gb.cigar)
    assert ga.padded_guide == gb.padded_guide
    assert ga.padded_alignment == gb.padded_alignment
    assert ga.padded_target == gb.padded_target
    assert ga.mismatches == gb.mismatches
    assert ga.gap_bases == gb.gap_bases
    assert ga.guide_mismatches == gb.guide_mismatches
    assert ga.guide_gap_bases == gb.guide_gap_bases
    assert ga.pam_mismatches == gb.pam_mismatches
    assert ga.pam_gap_bases == gb.pam_gap_bases
    assert ga.unpadded_target_without_pam == gb.unpadded_target_without_pam


def run_diff(guide, windows, passes=None, **kw):
    aligner = SequentialAligner()
    passes = passes or [("fwd", "rev")] * len(windows)
    got = finish_windows(guide, aligner, windows, passes, **kw)
    assert got is not None
    for (chrom, start1, bases), ps, batch in zip(windows, passes, got):
        want = aligner.align(
            guide, bases, target_name=chrom, target_offset=start1 - 1,
            passes=ps, **kw,
        )
        assert len(batch) == len(want), (chrom, start1)
        for ga, gb in zip(batch, want):
            assert_same(ga, gb)


def random_windows(rng, n, length, plant=None, n_prob=0.0):
    """Uppercase windows, optionally with a planted (mutated) guide copy."""
    out = []
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(n):
        w = rng.choice(alpha, size=length)
        if n_prob and rng.random() < 0.8:
            idx = rng.random(length) < n_prob
            w[idx] = ord("N")
        if plant is not None and rng.random() < 0.8:
            copy = np.frombuffer(plant.upper().encode(), dtype=np.uint8).copy()
            for _ in range(rng.integers(0, 5)):
                copy[rng.integers(0, len(copy))] = alpha[rng.integers(0, 4)]
            p = rng.integers(0, length - len(copy))
            w[p : p + len(copy)] = copy
        out.append(("chrT", int(rng.integers(1, 10_000)), w))
    return out


GUIDES = [
    Guide.parse("GACGCATAAAGATGAGACGCngg"),          # 3' PAM
    Guide.parse("ccnGACGCATAAAGATGAGACGC"),          # 5' PAM
    Guide.parse("GACGCATAAAGATGAGACGC"),             # PAM-less
    Guide.parse("GACGCATAAAGATGAGACGCngg", ["nag"]),  # aux PAM
    Guide.parse("ttanAACCGGTTACGTACGGTT"),           # longer 5' PAM
]


@pytest.mark.parametrize("gi", range(len(GUIDES)))
def test_fuzz_matches_engine(gi):
    guide = GUIDES[gi]
    rng = np.random.default_rng(100 + gi)
    plant = guide.guide + (guide.pams[0].replace("n", "a") if guide.pams else "")
    windows = random_windows(rng, 40, 400, plant=plant, n_prob=0.02)
    run_diff(guide, windows, **KW)


def test_pass_restriction():
    guide = GUIDES[0]
    rng = np.random.default_rng(7)
    windows = random_windows(rng, 12, 300, plant=guide.guide + "agg")
    for ps in [("fwd",), ("rev",), ("fwd", "rev"), ()]:
        run_diff(guide, windows, passes=[ps] * len(windows), **KW)


def test_mixed_window_lengths_and_order():
    guide = GUIDES[1]
    rng = np.random.default_rng(11)
    windows = (
        random_windows(rng, 5, 150, plant="GGA" + guide.guide)
        + random_windows(rng, 5, 1000, plant="CCA" + guide.guide)
        + random_windows(rng, 5, 37, plant=None)
    )
    run_diff(guide, windows, **KW)


def test_loose_limits_many_hits():
    guide = Guide.parse("ACGTACGTACGTnrg")
    rng = np.random.default_rng(3)
    windows = random_windows(rng, 10, 500, plant="ACGTACGTACGTagg")
    run_diff(
        guide, windows,
        max_guide_diffs=4, max_pam_diffs=1,
        max_gaps_between_guide_and_pam=3, max_total_diffs=8, max_overlap=5,
    )


def test_ambiguity_codes_in_target():
    guide = GUIDES[0]
    rng = np.random.default_rng(5)
    windows = []
    alpha = np.frombuffer(b"ACGTRYSWKMN", dtype=np.uint8)
    for i in range(10):
        w = rng.choice(alpha, size=200)
        windows.append(("chrA", 1 + i, w))
    run_diff(guide, windows, **KW)


def test_explicit_full_ranges_equal_default():
    guide = GUIDES[0]
    rng = np.random.default_rng(9)
    windows = random_windows(rng, 10, 400, plant=guide.guide + "tgg")
    aligner = SequentialAligner()
    passes = [("fwd", "rev")] * len(windows)
    full = np.zeros((len(windows), 4), np.int32)
    for i, (_, _, b) in enumerate(windows):
        full[i] = (1, len(b), 1, len(b))
    a = finish_windows(guide, aligner, windows, passes, ranges=full, **KW)
    b = finish_windows(guide, aligner, windows, passes, **KW)
    for la, lb in zip(a, b):
        assert len(la) == len(lb)
        for ga, gb in zip(la, lb):
            assert_same(ga, gb)


@pytest.mark.parametrize("gi", range(len(GUIDES)))
def test_rendered_rows_match_object_path(gi, tmp_path):
    """finish_rendered's direct line assembly == render_row(build(aln))
    for every row, including contig-edge flank N-padding and both
    strands (the production reference-pass path vs the object path)."""
    from calitas_tpu.align.batch import finish_rendered, make_render_consts
    from calitas_tpu.io.fasta import ReferenceSetBuilder, IndexedFasta
    from calitas_tpu.io.tsv import fields_of, render_row
    from calitas_tpu.search.hits import HitBuilder, ReferenceHit

    guide = GUIDES[gi]
    rng = np.random.default_rng(100 + gi)
    # A short contig so flanks run off both ends (N-padding exercised).
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.choice(alpha, size=600)
    plant = (guide.guide + (guide.pams_3prime[0].upper() if guide.pams_3prime else "")) \
        if not guide.pams_5prime else (guide.pams_5prime[0].upper() + guide.guide)
    pb = np.frombuffer(plant.encode(), dtype=np.uint8)
    contig[5 : 5 + len(pb)] = pb        # hit at the very start
    contig[560 : 560 + len(pb)] = pb    # hit near the end
    contig[260 : 260 + len(pb)] = pb
    b = ReferenceSetBuilder(assembly="rr")
    b.add("chrR").add(contig.tobytes().decode())
    fa = b.to_file(tmp_path / "r.fa")
    ref = IndexedFasta(fa)

    aligner = SequentialAligner()
    builder = HitBuilder(
        guide_id="gid", guide=guide, ref=ref, vcf=None,
        aligner_id="CALITAS:SearchReference", arguments="args",
    )
    windows = [("chrR", 1, contig)]
    passes = [("fwd", "rev")]
    consts = make_render_consts(builder, guide)
    rendered = finish_rendered(
        guide, aligner, windows, passes, None, consts,
        lambda c, a, z: builder._fetch(c, a, z, False), **KW,
    )
    objs = finish_windows(guide, aligner, windows, passes, **KW)
    fields = fields_of(ReferenceHit)
    assert rendered is not None and objs is not None
    got = rendered[0]
    want = [builder.build(a) for a in objs[0]]
    assert len(got) == len(want) and len(want) >= 2
    for r, h in zip(got, want):
        assert r._line == render_row(h, fields)
        assert (r.guide_id, r.chromosome, r.strand) == (
            h.guide_id, h.chromosome, h.strand,
        )
        assert (r.coordinate_start, r.score, r.end) == (
            h.coordinate_start, h.score, h.end,
        )


@pytest.mark.parametrize("gi", range(len(GUIDES)))
def test_native_lines_match_rendered(gi, tmp_path):
    """finish_lines (C++ composes the full 34-column line, flanks
    included) == finish_rendered line-for-line and key-for-key, including
    contig-edge N-padding, both strands, all guide kinds — the production
    worker path vs the Python-assembly path it replaced."""
    from calitas_tpu.align.batch import (
        finish_lines,
        finish_rendered,
        make_render_consts,
    )
    from calitas_tpu.io.fasta import ReferenceSetBuilder, IndexedFasta
    from calitas_tpu.search.hits import HitBuilder
    from calitas_tpu.search.windows import materialize_window, upper_bytes

    guide = GUIDES[gi]
    rng = np.random.default_rng(500 + gi)
    alpha = np.frombuffer(b"ACGTacgt", dtype=np.uint8)  # soft-masked case
    contig = rng.choice(alpha, size=900)
    plant = (guide.guide + (guide.pams_3prime[0].upper() if guide.pams_3prime else "")) \
        if not guide.pams_5prime else (guide.pams_5prime[0].upper() + guide.guide)
    pb = np.frombuffer(plant.encode(), dtype=np.uint8)
    contig[2 : 2 + len(pb)] = pb          # flanks off the contig start
    contig[870 : 870 + len(pb)] = pb      # flanks off the contig end
    contig[400 : 400 + len(pb)] = pb
    contig[100:110] = ord("N")            # N-trim interplay
    b = ReferenceSetBuilder(assembly="nl")
    b.add("chrL").add(contig.tobytes().decode())
    fa = b.to_file(tmp_path / "l.fa")
    ref = IndexedFasta(fa)

    aligner = SequentialAligner()
    builder = HitBuilder(
        guide_id="gid", guide=guide, ref=ref, vcf=None,
        aligner_id="CALITAS:SearchReference", arguments="args",
    )
    consts = make_render_consts(builder, guide)

    # Overlapping windows covering the contig, reference semantics
    # (N-trim via materialize_window), with flank sources built exactly
    # as the production worker builds them.
    PAD = 10
    window_size = 300
    windows, passes, srcs = [], [], []
    for start0 in range(0, 899, 270):
        end = min(900, start0 + window_size)
        c1 = max(1, start0 + 1 - PAD)
        c2 = min(900, end + PAD)
        ctx = np.frombuffer(
            ref.get_subsequence("chrL", c1, c2), dtype=np.uint8
        )
        a = start0 + 1 - c1
        w = materialize_window("chrL", ctx[a : a + (end - start0)], 0, window_size)
        w.start += start0
        w.end += start0
        if len(w.bases) < len(guide.guide):
            continue
        windows.append((w.chrom, w.start, w.bases))
        passes.append(("fwd", "rev"))
        srcs.append((c1, upper_bytes(ctx)))

    got = finish_lines(
        guide, aligner, windows, passes, None, consts, srcs, **KW
    )
    want = finish_rendered(
        guide, aligner, windows, passes, None, consts,
        lambda c, a, z: builder._fetch(c, a, z, False), **KW,
    )
    assert got is not None and want is not None
    total = 0
    for lg, lw in zip(got, want):
        assert len(lg) == len(lw)
        for rg, rw in zip(lg, lw):
            total += 1
            assert rg._line == rw._line
            assert (
                rg.guide_id, rg.chromosome, rg.strand, rg.variant_description,
                rg.coordinate_start, rg.score, rg.end,
            ) == (
                rw.guide_id, rw.chromosome, rw.strand, rw.variant_description,
                rw.coordinate_start, rw.score, rw.end,
            )
    assert total >= 3  # planted hits actually exercised the comparison


@pytest.mark.parametrize("gi", range(len(GUIDES)))
def test_materialized_native_chunk_matches_incremental(gi, tmp_path, monkeypatch):
    """The fully-native worker path (one mmap read per candidate ->
    materialize_finish_render) must produce the same rows, line for
    line, as the incremental materialize_window + finish_lines path —
    across N-trim windows, soft-masked bases, contig edges, pass
    restrictions and screen ranges."""
    import calitas_tpu.align.batch as batch
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.parallel.host_pool import _mp_finish_chunk, make_finish_spec

    guide = GUIDES[gi]
    rng = np.random.default_rng(900 + gi)
    alpha = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    contig = rng.choice(alpha, size=3000)
    plant = (guide.guide + (guide.pams_3prime[0].upper() if guide.pams_3prime else "")) \
        if not guide.pams_5prime else (guide.pams_5prime[0].upper() + guide.guide)
    pb = np.frombuffer(plant.encode(), dtype=np.uint8)
    for pos in (3, 777, 1500, 2960):
        contig[pos : pos + len(pb)] = pb
    contig[700:760] = ord("N")   # leading-N trim inside a window
    contig[1600:1610] = ord("n") # lowercase n must NOT trim
    b = ReferenceSetBuilder(assembly="mn")
    b.add("chrM").add(contig.tobytes().decode())
    ref_path = b.to_file(tmp_path / "m.fa")

    aligner = SequentialAligner()
    spec = make_finish_spec(
        guide, aligner, KW, guide_id="gid", ref_path=ref_path,
        aligner_id="CALITAS:SearchReference", arguments="args",
        vcf_id=None, timestamp="Mon Jan 01 00:00:00 UTC 2026",
        window_size=400, guide_length=len(guide.guide) + guide.pam_length,
    )
    chunk = []
    for start0 in range(0, 2999, 370):
        ps = ("fwd", "rev") if start0 % 740 else ("fwd",)
        # alternate: no ranges / full-width explicit ranges (both exact)
        cr = None if start0 % 1110 else (1, 400, 1, 400)
        chunk.append(("chrM", start0, ps, cr))

    native_rows = _mp_finish_chunk(spec, chunk)

    monkeypatch.setattr(batch, "materialize_finish_lines",
                        lambda *a, **k: None)
    incr_rows = _mp_finish_chunk(spec, chunk)

    assert len(native_rows) == len(incr_rows)
    total = 0
    for a, b2 in zip(native_rows, incr_rows):
        assert len(a) == len(b2)
        for ra, rb in zip(a, b2):
            total += 1
            assert ra._line == rb._line
            assert (ra.coordinate_start, ra.score, ra.end, ra.strand) == (
                rb.coordinate_start, rb.score, rb.end, rb.strand,
            )
    assert total >= 3


def test_raw_spans_match_get_subsequence(tmp_path):
    """IndexedFasta.raw_spans byte addressing: stripping newlines from
    the returned raw slices must reproduce get_subsequence exactly, for
    ranges crossing line boundaries and at contig edges."""
    from calitas_tpu.io.fasta import ReferenceSetBuilder, IndexedFasta

    rng = np.random.default_rng(4100)
    alpha = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    contig = rng.choice(alpha, size=507).tobytes().decode()
    b = ReferenceSetBuilder(assembly="rs", line_length=60)
    b.add("chrR").add(contig)
    b.add("chrS").add(contig[:123])  # second contig shifts file offsets
    ref = IndexedFasta(b.to_file(tmp_path / "r.fa"))

    for chrom, clen in (("chrR", 507), ("chrS", 123)):
        s1 = rng.integers(1, clen + 1, size=200)
        e1 = np.minimum(clen, s1 + rng.integers(0, 140, size=200))
        buf, off, rlen = ref.raw_spans(chrom, s1, e1)
        for i in range(len(s1)):
            raw = buf[off[i] : off[i] + rlen[i]].tobytes()
            stripped = raw.replace(b"\n", b"").replace(b"\r", b"")
            assert stripped == ref.get_subsequence(
                chrom, int(s1[i]), int(e1[i])
            ), (chrom, s1[i], e1[i])

    with pytest.raises(ValueError):
        ref.raw_spans("chrR", np.array([0]), np.array([5]))
    with pytest.raises(ValueError):
        ref.raw_spans("chrS", np.array([1]), np.array([124]))


@pytest.mark.parametrize("gi", range(len(GUIDES)))
def test_batch_raw_ctx_matches_sliced(gi, tmp_path, monkeypatch):
    """The raw-mmap batch finish (materialize_finish_render_raw: contexts
    addressed in the FASTA file bytes, newlines stripped natively) must
    return a RenderedBlock identical to the sliced-context path — across
    line-wrap boundaries, contig edges, N-trim, soft-masking, pass
    restrictions and screen ranges."""
    from calitas_tpu.io import fasta as fasta_mod
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.parallel.host_pool import (
        _mp_finish_batch_item,
        make_finish_spec,
    )
    from calitas_tpu.search.hits import RenderedBlock

    guide = GUIDES[gi]
    rng = np.random.default_rng(4200 + gi)
    alpha = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    contig = rng.choice(alpha, size=3000)
    plant = (guide.guide + (guide.pams_3prime[0].upper() if guide.pams_3prime else "")) \
        if not guide.pams_5prime else (guide.pams_5prime[0].upper() + guide.guide)
    pb = np.frombuffer(plant.encode(), dtype=np.uint8)
    for pos in (1, 777, 1500, 2960):
        contig[pos : pos + len(pb)] = pb
    contig[700:760] = ord("N")
    b = ReferenceSetBuilder(assembly="rb", line_length=61)  # force wraps
    b.add("chrB").add(contig.tobytes().decode())
    ref_path = b.to_file(tmp_path / "b.fa")

    aligner = SequentialAligner()
    spec = make_finish_spec(
        guide, aligner, KW, guide_id="gid", ref_path=ref_path,
        aligner_id="CALITAS:SearchReference", arguments="args",
        vcf_id=None, timestamp="Mon Jan 01 00:00:00 UTC 2026",
        window_size=400, guide_length=len(guide.guide) + guide.pam_length,
    )
    starts = np.arange(0, 2999, 370, dtype=np.int64)
    sel = np.array([1 if i % 4 == 3 else 3 for i in range(len(starts))],
                   dtype=np.uint8)
    item = ("__batch__", "chrB", starts, sel, None)

    got = _mp_finish_batch_item(spec, item)
    assert isinstance(got, RenderedBlock)

    # Disable the raw path: identical block must come out of the
    # sliced-context tier.
    monkeypatch.setattr(
        fasta_mod.IndexedFasta, "raw_spans",
        property(lambda self: None), raising=True,
    )
    want = _mp_finish_batch_item(spec, item)
    assert isinstance(want, RenderedBlock)
    assert got.blob == want.blob
    np.testing.assert_array_equal(got.strands, want.strands)
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.ends, want.ends)
    np.testing.assert_array_equal(got.line_offs, want.line_offs)
    assert len(got) >= 3  # planted hits actually exercised the comparison


def test_oversized_pam_falls_back_to_python_engine():
    """PAMs beyond the native 63-base mismatch mask gate the batch off
    the native path (None -> caller's Python tiers) instead of hitting
    shift UB; the Python engine handles any PAM length."""
    import numpy as np

    from calitas_tpu.align.batch import _pack_query_pams, finish_windows
    from calitas_tpu.align.engine import SequentialAligner
    from calitas_tpu.core.guide import Guide

    long_pam = "n" * 70
    guide = Guide.parse("CTTGCCCCACAGGGCAGTAA" + long_pam)
    assert _pack_query_pams(guide) is None
    rng = np.random.default_rng(5)
    bases = rng.choice(
        np.frombuffer(b"ACGT", np.uint8), 200
    ).astype(np.uint8)
    out = finish_windows(
        guide, SequentialAligner(), [("chr1", 1, bases)], [("fwd", "rev")],
        None, max_guide_diffs=4, max_pam_diffs=1,
        max_gaps_between_guide_and_pam=3, max_total_diffs=8, max_overlap=5,
    )
    assert out is None  # callers fall back to the per-window engine
    # a 63-base PAM still takes the native path
    ok_guide = Guide.parse("CTTGCCCCACAGGGCAGTAA" + "n" * 63)
    assert _pack_query_pams(ok_guide) is not None
