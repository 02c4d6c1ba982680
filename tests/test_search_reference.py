"""SearchReference end-to-end + variant engine tests, transcribed from the
reference's SearchReferenceTest.scala."""

import numpy as np
import pytest

from calitas_tpu.io.fasta import IndexedFasta, ReferenceSetBuilder
from calitas_tpu.io.tsv import read_metrics
from calitas_tpu.io.vcf import VcfVariant
from calitas_tpu.search.hits import ReferenceHit
from calitas_tpu.search.variants import (
    VariantSet,
    allele_combo_indices,
    allele_combos,
    build_variant_window,
)
from calitas_tpu.search.windows import window_iterator
from calitas_tpu.tools import search_reference

from tests.vcf_util import VcfBuilder

GUIDE = "ACGTACATGCTCGATACGACGnngrrn"
PERFECT = "ACGTACATGCTCGATACGACGccgaat".upper()
MISMATCHED = "ACGcACAcGCcCGAcACGACGccgaat".upper()


def v(chrom, pos, vid, alleles):
    return VcfVariant(
        chrom=chrom,
        pos=pos,
        id=None if vid in (".", "") else vid,
        ref=alleles.split("/")[0],
        alts=tuple(alleles.split("/")[1:]),
        qual=None,
        filters=frozenset({"PASS"}),
        info=(),
    )


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    b = ReferenceSetBuilder()
    c1 = b.add("chr1")
    c1.add("N", 5000)
    c1.add("AATAT", 1000)
    c1.add("N", 5000)
    c2 = b.add("chr2")
    c2.add("N", 3000)
    c2.add(PERFECT)
    c2.add("GT", 500)
    c2.add(MISMATCHED)
    c2.add("CA", 500)
    c2.add("N", 3000)
    path = b.to_file(tmp_path_factory.mktemp("fasta") / "ref.fa")
    return path


class TestWindowIterator:
    def test_iterates(self, tmp_path):  # SearchReferenceTest.scala:43-49
        b = ReferenceSetBuilder()
        b.add("chr1").add("ACGTC", 5000)
        path = b.to_file(tmp_path / "r.fa")
        fa = IndexedFasta(path)
        count = sum(1 for _ in window_iterator(fa, 451, 426, None))
        assert count > 0


class TestSearchReference:
    @pytest.mark.parametrize("engine", ["host", "tpu"])
    def test_end_to_end(self, fasta, tmp_path, engine):  # :51-62
        out = tmp_path / f"hits.{engine}.txt"
        search_reference.run(
            guide=GUIDE, guide_id="a", ref=fasta, output=out, threads=1,
            engine=engine,
        )
        hits = read_metrics(out, ReferenceHit)
        assert len(hits) == 2
        assert all(h.chromosome == "chr2" for h in hits)
        assert hits[0].coordinate_start == 3000
        assert hits[0].total_mm_plus_gaps == 0
        assert hits[1].coordinate_start == 4000 + len(PERFECT)
        assert hits[1].total_mm_plus_gaps == 4

    def test_pamless(self, fasta, tmp_path):  # :64-69
        out = tmp_path / "hits.txt"
        search_reference.run(
            guide="".join(c for c in GUIDE if c.isupper()),
            guide_id="a", ref=fasta, output=out, threads=1, engine="host",
        )
        hits = read_metrics(out, ReferenceHit)
        assert len(hits) == 2

    def test_adjacent_short_contigs(self, tmp_path):  # :71-92
        b = ReferenceSetBuilder()
        b.add("ref").add("GTGCGTGACTTGAAGTCTCAGTATACCTTGCCACACGTTGCAGGTTGCCC")
        b.add("alt").add("GTGCGTGACTTGAAGTCTCAGTATgaaaTTGCCACACGTTGCAGGTTGCCC")
        ref = b.to_file(tmp_path / "r.fa")
        out = tmp_path / "hits.txt"
        search_reference.run(
            guide="GTGACTTGAAGTCTCAGTATA", guide_id="a", ref=ref,
            output=out, threads=1, engine="host",
        )
        hits = read_metrics(out, ReferenceHit)
        assert len(hits) == 2
        assert hits[0].chromosome == "ref"
        assert hits[0].coordinate_start == 4
        assert hits[0].padded_alignment == "|||||||||||||||||||||"
        assert hits[1].chromosome == "alt"
        assert hits[1].coordinate_start == 4
        assert hits[1].padded_alignment == "||||||||||||||||||||."

    @pytest.mark.parametrize("engine", ["host", "tpu"])
    def test_flanks_ref_and_variant_windows(self, tmp_path, engine):  # :94-147
        query = "GCGTCACGGTCGAGCGATTGnrg"
        b = ReferenceSetBuilder()
        c = b.add("chr1")
        c.add("ACACACACACACACACACACACACACACACACACACACAgcgtcacggtcgagcgattggggAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA".upper())
        c.add("ACACACACACACACACACACACACACACACACACACACAccccaatcgctcgaccgtgacgcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA".upper())
        c.add("ACACACACACACACACACACACACACACACACACACACAcacggtcgagcgattggggAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA".upper())
        c.add("ACACACACACACACACACACACACACACACACACACACAaatcgctcgaccgtgacgcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA".upper())
        ref = b.to_file(tmp_path / "r.fa")

        vcf = VcfBuilder()
        vcf.add("chr1", 239, "insGAGGCGT", ["A", "AGAGGCGT"])
        vcf.add("chr1", 339, "insTCGCCCC", ["A", "ATCGCCCC"])
        vcf_path = vcf.to_file(tmp_path / "v.vcf")

        out = tmp_path / "results.txt"
        search_reference.run(
            guide=query, guide_id="test", ref=ref, variants=vcf_path,
            output=out, max_gaps_between_guide_and_pam=0, max_guide_diffs=0,
            engine=engine,
        )
        hits = read_metrics(out, ReferenceHit)
        assert len(hits) == 4

        h1, h2, h3, h4 = hits
        assert h1.coordinate_start == 39
        assert h1.padded_extra_8_bases_5_prime == "CACACACA"
        assert h1.padded_extra_8_bases_3_prime == "AAAAAAAA"
        assert h1.ten_bases_5_prime == "CACACACACA"
        assert h1.ten_bases_3_prime == "GGGAAAAAAA"

        assert h2.coordinate_start == 142
        assert h2.padded_extra_8_bases_5_prime == "TTTTTTTT"
        assert h2.padded_extra_8_bases_3_prime == "TGTGTGTG"
        assert h2.ten_bases_5_prime == "TTTTTTTTTT"
        assert h2.ten_bases_3_prime == "GGGTGTGTGT"

        assert h3.coordinate_start == 238
        assert h3.padded_extra_8_bases_5_prime == "ACACAGAG"
        assert h3.padded_extra_8_bases_3_prime == "AAAAAAAA"
        assert h3.ten_bases_5_prime == "ACACACAGAG"
        assert h3.ten_bases_3_prime == "GGGAAAAAAA"

        assert h4.coordinate_start == 338
        assert h4.padded_extra_8_bases_5_prime == "TTTTTTTT"
        assert h4.padded_extra_8_bases_3_prime == "CGATGTGT"
        assert h4.ten_bases_5_prime == "TTTTTTTTTT"
        assert h4.ten_bases_3_prime == "GGGCGATGTG"


class TestAlleleComboIndices:
    def test_single_variant(self):  # :150-153
        assert allele_combo_indices([2]) == [[0], [1]]
        assert allele_combo_indices([3]) == [[0], [1], [2]]

    def test_two_variants(self):  # :155-158
        assert allele_combo_indices([2, 2]) == [[0, 0], [0, 1], [1, 0], [1, 1]]
        assert allele_combo_indices([3, 2]) == [
            [0, 0], [0, 1], [1, 0], [1, 1], [2, 0], [2, 1]
        ]

    def test_three_variants(self):  # :160-181
        assert allele_combo_indices([3, 2, 3]) == [
            [0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 1, 0], [0, 1, 1], [0, 1, 2],
            [1, 0, 0], [1, 0, 1], [1, 0, 2], [1, 1, 0], [1, 1, 1], [1, 1, 2],
            [2, 0, 0], [2, 0, 1], [2, 0, 2], [2, 1, 0], [2, 1, 1], [2, 1, 2],
        ]


REF_SEQ_50 = "CTAGACTGACTGACTAGCACTAGCCGCTTTATATATGCTATGGGACACCG"


def ref_bases(s):
    return np.frombuffer(s.encode(), dtype=np.uint8)


class TestBuildVariantWindow:
    def test_single_snp(self):  # :183-196
        w = build_variant_window(
            VariantSet((v("chr1", 20, "rs123", "C/G"),), (1,)),
            "chr1", ref_bases(REF_SEQ_50), 15,
        )
        assert w.bases.tobytes().decode() == "ACTGACTGACTAGCAgTAGCCGCTTTATATA".upper()
        assert str(w.cigar) == "31M"
        assert w.ref_offset_at_base_offset(0, True) == 4
        assert w.ref_offset_at_base_offset(15, True) == 19
        assert w.ref_offset_at_base_offset(20, True) == 24
        assert w.ref_offset_at_base_offset(31, True) == 35

    def test_single_insertion(self):  # :198-215
        w = build_variant_window(
            VariantSet((v("chr1", 20, "rs123", "C/CGT"),), (1,)),
            "chr1", ref_bases(REF_SEQ_50), 15,
        )
        assert w.bases.tobytes().decode() == "ACTGACTGACTAGCAcgtTAGCCGCTTTATATA".upper()
        assert str(w.cigar) == "16M2I15M"
        assert w.ref_offset_at_base_offset(0, True) == 4
        assert w.ref_offset_at_base_offset(14, True) == 18
        assert w.ref_offset_at_base_offset(15, True) == 19
        assert w.ref_offset_at_base_offset(16, True) == 19
        assert w.ref_offset_at_base_offset(17, True) == 19
        assert w.ref_offset_at_base_offset(15, False) == 19
        assert w.ref_offset_at_base_offset(16, False) == 20
        assert w.ref_offset_at_base_offset(17, False) == 20

    def test_single_deletion(self):  # :217-230
        w = build_variant_window(
            VariantSet((v("chr1", 20, "rs123", "CTA/C"),), (1,)),
            "chr1", ref_bases(REF_SEQ_50), 15,
        )
        assert w.bases.tobytes().decode() == "ACTGACTGACTAGCAcGCCGCTTTATATATG".upper()
        assert str(w.cigar) == "16M2D15M"
        assert w.ref_offset_at_base_offset(0, True) == 4
        assert w.ref_offset_at_base_offset(15, True) == 19
        assert w.ref_offset_at_base_offset(16, True) == 22

    def test_multiple_variants(self):  # :232-247
        variants = (
            v("chr1", 10, "snp", "C/T"),
            v("chr1", 20, "ins", "C/CG"),
            v("chr1", 30, "del", "TAT/T"),
        )
        seq = "CTAGACTGACTGACTAGCACTAGCCGCTTTATATATGCTAGGCGCTACTGAATGCTATAGCTCTGAGACTGGGACACCG"
        w = build_variant_window(
            VariantSet(variants, (1, 1, 1)), "chr1", ref_bases(seq), 15
        )
        assert (
            w.bases.tobytes().decode()
            == "CTAGACTGAtTGACTAGCAcgTAGCCGCTTtATATGCTAGGCGCTA".upper()
        )
        assert str(w.cigar) == "20M1I10M2D15M"


class TestAlleleCombos:
    def test_single_variant_single_alt(self):  # :249-255
        vs = [v("chr1", 20, "snp", "A/C")]
        sets = allele_combos(vs, 10)
        assert len(sets) == 1
        assert sets[0] == VariantSet((vs[0],), (1,))

    def test_entry_per_allele(self):  # :257-266
        vs = [v("chr1", 20, "snp", "A/C/G/T")]
        sets = allele_combos(vs, 10)
        assert sorted(sets, key=lambda s: s.alleles) == [
            VariantSet((vs[0],), (1,)),
            VariantSet((vs[0],), (2,)),
            VariantSet((vs[0],), (3,)),
        ]

    def test_all_combinations(self):  # :268-284
        a = v("chr1", 20, "a", "A/C")
        b = v("chr1", 25, "b", "C/T")
        c = v("chr1", 30, "c", "G/A")
        sets = allele_combos([a, b, c], 10)
        expected = [
            VariantSet((a,), (1,)),
            VariantSet((b,), (1,)),
            VariantSet((c,), (1,)),
            VariantSet((a, b), (1, 1)),
            VariantSet((a, c), (1, 1)),
            VariantSet((b, c), (1, 1)),
            VariantSet((a, b, c), (1, 1, 1)),
        ]
        assert sorted(map(repr, sets)) == sorted(map(repr, expected))

    def test_too_many_variants_falls_back(self):  # :286-295
        vs = [
            v("chr1", 20, "a", "A/C"),
            v("chr1", 25, "b", "C/T"),
            v("chr1", 30, "c", "G/A"),
        ]
        assert len(allele_combos(vs, 2)) == 1
        assert len(allele_combos(vs, 3)) == 7


class TestParametersColumn:
    def test_core_parameters_format(self):
        # SearchReference.scala:496-508: sorted, ';'-joined, GNU-cased
        from calitas_tpu.tools.search_reference import core_parameters_string

        s = core_parameters_string(16, 1000, 5, 1, 3, 9, 10, -120, -260, -122, -121)
        assert s == (
            "genome-gap-net-cost=-122;guide-gap-net-cost=-121;"
            "guide-mismatch-net-cost=-120;max-gaps-between-guide-and-pam=3;"
            "max-guide-diffs=5;max-overlap=10;max-pam-mismatches=1;"
            "max-total-diffs=9;max-variants=16;pam-mismatch-net-cost=-260;"
            "window-size=1000"
        )


class TestCrossPassDedup:
    def test_variant_hit_does_not_suppress_reference_hit(self, tmp_path):
        """Reference-pass and variant-pass hits at the same locus both
        survive the global dedup: the group key includes
        variant_description (SearchReference.scala:656; SURVEY §3.2 note).
        """
        proto = "CTTGCCCCACAGGGCAGTAA"
        b = ReferenceSetBuilder(assembly="xp")
        # perfect site in the reference; a variant inside it creates a
        # second (1-mm in proto) haplotype hit at the same locus
        b.add("c1").add("GT" * 200).add(proto + "TGG").add("AC" * 200)
        ref = b.to_file(tmp_path / "r.fa")
        vcf = VcfBuilder()
        # SNP at protospacer position 5 (contig pos 400 + 5)
        ref_base = proto[4]
        alt = "G" if ref_base != "G" else "C"
        vcf.add("c1", 405, "rsX", [ref_base, alt], info={"AF": "0.3"})
        vcf_path = vcf.to_file(tmp_path / "v.vcf")

        out = tmp_path / "out.txt"
        search_reference.run(
            guide=proto + "nrg", guide_id="g", ref=ref, variants=vcf_path,
            output=out, engine="host",
        )
        hits = read_metrics(out, ReferenceHit)
        same_locus = [h for h in hits if h.coordinate_start == 400]
        descs = {h.variant_description for h in same_locus}
        assert None in descs, "reference-pass hit missing"
        assert any(d for d in descs if d), "variant-pass hit missing"
        ref_hit = next(h for h in same_locus if h.variant_description is None)
        var_hit = next(h for h in same_locus if h.variant_description)
        assert ref_hit.total_mm_plus_gaps == 0
        assert var_hit.total_mm_plus_gaps == 1  # the SNP
        assert var_hit.variant_description == f"rsX:404:{ref_base}>{alt}:0.300"
        # float32-widened, as the JAR's Float->Option[Double] assignment
        # produces (ReferenceHit.scala:54,233).
        assert var_hit.allele_frequency == 0.30000001192092896


class TestWideWindowWarning:
    def test_very_wide_window_keeps_ranges(self, fasta, tmp_path, caplog):
        """-w 32768 (past the former 16,384 ceiling, VERDICT r3 item 9)
        now stays on the sliced-finish path with 128-column range blocks —
        identical table to the host engine, no cliff warning."""
        import logging

        out = tmp_path / "wide.txt"
        out_host = tmp_path / "wide_host.txt"
        with caplog.at_level(logging.INFO, logger="calitas_tpu.SearchReference"):
            search_reference.run(
                guide=GUIDE, guide_id="w", ref=fasta, output=out,
                engine="device", window_size=32768, chrom="chr2",
            )
        assert not any(
            "without end-column ranges" in r.message for r in caplog.records
        ), "32768 must not hit a no-ranges cliff anymore"
        assert any(
            "coarser" in r.message and "128-column" in r.message
            for r in caplog.records
        ), "missing coarser-blocks info line"
        hits = read_metrics(out, ReferenceHit)
        assert len(hits) >= 2
        search_reference.run(
            guide=GUIDE, guide_id="w", ref=fasta, output=out_host,
            engine="host", window_size=32768, chrom="chr2",
        )
        host_hits = read_metrics(out_host, ReferenceHit)
        strip = lambda h: tuple(
            v for k, v in h.__dict__.items() if k != "time_stamp"
        )
        assert [strip(h) for h in hits] == [strip(h) for h in host_hits]

    def test_4096_window_keeps_ranges_with_coarser_blocks(
        self, fasta, tmp_path, caplog
    ):
        """-w 4096 now stays on the sliced-finish path (16-column range
        blocks) — identical table to the host engine, no cliff warning."""
        import logging

        out = tmp_path / "wide4096.txt"
        out_host = tmp_path / "wide4096_host.txt"
        with caplog.at_level(logging.INFO, logger="calitas_tpu.SearchReference"):
            search_reference.run(
                guide=GUIDE, guide_id="w", ref=fasta, output=out,
                engine="device", window_size=4096, chrom="chr2",
            )
        assert not any(
            "without end-column ranges" in r.message for r in caplog.records
        ), "4096 must not hit the no-ranges cliff"
        assert any(
            "coarser" in r.message for r in caplog.records
        ), "missing coarser-blocks info line"
        search_reference.run(
            guide=GUIDE, guide_id="w", ref=fasta, output=out_host,
            engine="host", window_size=4096, chrom="chr2",
        )

        def rows(path):
            with open(path) as fh:
                header = fh.readline().rstrip("\n").split("\t")
                ts = header.index("time_stamp")
                got = []
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    f[ts] = ""
                    got.append(tuple(f))
            return got

        assert rows(out) == rows(out_host)
        assert len(rows(out)) >= 2

    def test_default_window_does_not_warn(self, fasta, tmp_path, caplog):
        import logging

        out = tmp_path / "norm.txt"
        with caplog.at_level(logging.WARNING, logger="calitas_tpu.SearchReference"):
            search_reference.run(
                guide=GUIDE, guide_id="w", ref=fasta, output=out,
                engine="device", chrom="chr2",
            )
        assert not any(
            "without end-column ranges" in r.message for r in caplog.records
        )
