"""Extra end-to-end coverage: 5'-PAM guides, auxiliary PAMs, chromosome
restriction, custom scoring, custom window size."""

import numpy as np
import pytest

from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.io.tsv import read_metrics
from calitas_tpu.search.hits import ReferenceHit
from calitas_tpu.tools import search_reference

FIVE_PRIME_GUIDE = "tttvGACCAACATGATGAAACTCT"  # 5' PAM tttv
SITE_5P = "TTTG" + "GACCAACATGATGAAACTCT"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    b = ReferenceSetBuilder(assembly="x")
    c = b.add("chr1")
    c.add("GCAT" * 100)
    c.add(SITE_5P)  # + strand 5'-PAM site
    c.add("TGCA" * 100)
    c.add(revcomp(SITE_5P))  # - strand site
    c.add("GGTA" * 100)
    c2 = b.add("chr2")
    c2.add("ATCG" * 100)
    c2.add(SITE_5P)
    c2.add("CGAT" * 100)
    return b.to_file(tmp_path_factory.mktemp("e2e") / "ref.fa")


@pytest.mark.parametrize("engine", ["host", "tpu"])
def test_five_prime_pam_search(ref, tmp_path, engine):
    out = tmp_path / f"5p.{engine}.txt"
    search_reference.run(
        guide=FIVE_PRIME_GUIDE, guide_id="g5", ref=ref, output=out,
        engine=engine,
    )
    hits = read_metrics(out, ReferenceHit)
    by_chrom_strand = {(h.chromosome, h.strand) for h in hits}
    assert ("chr1", "+") in by_chrom_strand
    assert ("chr1", "-") in by_chrom_strand
    assert ("chr2", "+") in by_chrom_strand
    for h in hits:
        if h.total_mm_plus_gaps == 0 and h.pam_mm == 0:
            assert h.pam_used == "tttv"
            assert h.aligner_search_pam == "tttv"


def test_chrom_restriction(ref, tmp_path):
    out = tmp_path / "chr2.txt"
    search_reference.run(
        guide=FIVE_PRIME_GUIDE, guide_id="g5", ref=ref, output=out,
        chrom="chr2", engine="host",
    )
    hits = read_metrics(out, ReferenceHit)
    assert hits and all(h.chromosome == "chr2" for h in hits)


def test_aux_pams_search(tmp_path):
    b = ReferenceSetBuilder()
    c = b.add("c")
    c.add("TTTT" * 50)
    c.add("CTTGCCCCACAGGGCAGTAA" + "TTG")  # only matches aux pam ntg
    c.add("AAAC" * 50)
    ref = b.to_file(tmp_path / "ref.fa")
    out = tmp_path / "out.txt"
    search_reference.run(
        guide="CTTGCCCCACAGGGCAGTAAnrg", guide_id="g", ref=ref, output=out,
        auxiliary_pams=["ntg"], engine="host", max_pam_mismatches=0,
    )
    hits = read_metrics(out, ReferenceHit)
    perfect = [h for h in hits if h.total_mm_plus_gaps == 0]
    assert perfect and perfect[0].pam_used == "ntg"
    assert perfect[0].aligner_search_pam == "nrg,ntg"


def test_custom_scoring_and_window(tmp_path):
    b = ReferenceSetBuilder()
    c = b.add("c")
    c.add("GGCC" * 200)
    c.add("CTTGCCCCACAGGGCAGTAATGG")
    c.add("CCGG" * 200)
    ref = b.to_file(tmp_path / "ref.fa")
    out = tmp_path / "out.txt"
    search_reference.run(
        guide="CTTGCCCCACAGGGCAGTAAnrg", guide_id="g", ref=ref, output=out,
        window_size=500, guide_mismatch_net_cost=-100,
        pam_mismatch_net_cost=-200, engine="host",
    )
    hits = read_metrics(out, ReferenceHit)
    assert len(hits) == 1
    # perfect score under custom costs: 20*(100//2) + 3*(200//2)
    assert hits[0].score == 20 * 50 + 3 * 100
    assert "guide-mismatch-net-cost=-100" in hits[0].aligner_other_parameters
    assert "window-size=500" in hits[0].aligner_other_parameters


def test_version_format():
    from calitas_tpu.version import aligner_version

    v = aligner_version()
    # yyyyMMdd-sha[-dirty] or fallback
    assert len(v) >= 8


class TestCheckpoint:
    def test_resume_produces_identical_table(self, tmp_path):
        from calitas_tpu.io.fasta import ReferenceSetBuilder
        from calitas_tpu.io.tsv import read_metrics
        from calitas_tpu.search.hits import ReferenceHit
        from calitas_tpu.tools import search_reference

        b = ReferenceSetBuilder(assembly="ck")
        b.add("c1").add("AAGG" * 100).add("CTTGCCCCACAGGGCAGTAATGG").add("GGTT" * 100)
        b.add("c2").add("CCAA" * 100).add("CTTGCCCCACAGGGCAGTAACGG").add("TTGG" * 100)
        ref = b.to_file(tmp_path / "ref.fa")
        guide = "CTTGCCCCACAGGGCAGTAAnrg"

        # plain run
        plain = tmp_path / "plain.txt"
        search_reference.run(guide=guide, guide_id="g", ref=ref, output=plain,
                             engine="host")

        # checkpointed run interrupted after first contig: simulate by
        # monkeypatching record to raise after c1
        ck = tmp_path / "state.jsonl"
        from calitas_tpu.search.checkpoint import CheckpointState

        orig_record = CheckpointState.record

        def bomb(self, chrom, hits):
            orig_record(self, chrom, hits)
            if chrom == "c1":
                raise RuntimeError("simulated crash")

        CheckpointState.record = bomb
        out1 = tmp_path / "part.txt"
        try:
            search_reference.run(guide=guide, guide_id="g", ref=ref,
                                 output=out1, engine="host", checkpoint=ck)
        except RuntimeError:
            pass
        finally:
            CheckpointState.record = orig_record

        # resume
        out2 = tmp_path / "resumed.txt"
        search_reference.run(guide=guide, guide_id="g", ref=ref, output=out2,
                             engine="host", checkpoint=ck)

        resumed = read_metrics(out2, ReferenceHit)
        plain_hits = read_metrics(plain, ReferenceHit)
        key = lambda h: (h.chromosome, h.coordinate_start, h.strand, h.score, h.cigar)
        assert sorted(map(key, resumed)) == sorted(map(key, plain_hits))
        assert len(resumed) >= 2

    def test_fingerprint_mismatch_rejected(self, tmp_path):
        import pytest as _pytest

        from calitas_tpu.search.checkpoint import CheckpointState

        ck = tmp_path / "s.jsonl"
        s = CheckpointState.open(ck, "fp1")
        s.set_timestamp("t")
        s.record("c1", [])
        with _pytest.raises(ValueError):
            CheckpointState.open(ck, "fp2")


def test_checkpoint_multi_guide_with_variants(tmp_path):
    """Checkpoint/resume combined with multi-guide + VCF pass."""
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.io.tsv import read_metrics
    from calitas_tpu.search.hits import ReferenceHit
    from calitas_tpu.tools import search_reference
    from tests.vcf_util import VcfBuilder

    b = ReferenceSetBuilder(assembly="ckmg")
    b.add("c1").add("AT" * 200).add("CTTGCCCCACAGGGCAGTAATGG").add("GC" * 200)
    b.add("c2").add("TA" * 200).add("GGCCTTAAGGCCTTAAGGCCAGG").add("CG" * 200)
    ref = b.to_file(tmp_path / "ref.fa")

    vcf = VcfBuilder()
    vcf.add("c1", 410, "snp1", ["T", "G"], info={"AF": "0.4"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")

    specs = [
        ("g1", "CTTGCCCCACAGGGCAGTAAnrg", ()),
        ("g2", "GGCCTTAAGGCCTTAAGGCCnrg", ()),
    ]
    plain = tmp_path / "plain.txt"
    search_reference.run(ref=ref, output=plain, guide_specs=specs,
                         variants=vcf_path, engine="host")

    ck = tmp_path / "state.jsonl"
    out1 = tmp_path / "ck1.txt"
    search_reference.run(ref=ref, output=out1, guide_specs=specs,
                         variants=vcf_path, engine="host", checkpoint=ck)
    # resume over a completed state must also produce the same table
    out2 = tmp_path / "ck2.txt"
    search_reference.run(ref=ref, output=out2, guide_specs=specs,
                         variants=vcf_path, engine="host", checkpoint=ck)

    def key_rows(p):
        hits = read_metrics(p, ReferenceHit)
        return sorted(
            (h.guide_id, h.chromosome, h.coordinate_start, h.strand, h.score,
             h.cigar, h.variant_description or "")
            for h in hits
        )

    assert key_rows(out1) == key_rows(plain)
    assert key_rows(out2) == key_rows(plain)


@pytest.mark.parametrize("engine", ["host", "tpu"])
def test_multi_guide_variant_pass_shared_stream(tmp_path, engine):
    """Guides of mixed lengths (two padding groups) over a variant-bearing
    genome: the shared materialized window stream must reproduce exactly
    the per-guide runs' rows (VERDICT r1 item 5)."""
    import numpy as np

    from calitas_tpu.core.sequence import revcomp
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.io.tsv import read_metrics
    from calitas_tpu.search.hits import ReferenceHit
    from calitas_tpu.tools import search_reference
    from tests.vcf_util import VcfBuilder

    rng = np.random.default_rng(21)
    g20 = "CTTGCCCCACAGGGCAGTAA"
    g20b = "GGCCTTAAGGCCTTAAGGCC"
    g18 = "ACGTACGTTGCATGCATG"
    contig = list("".join(rng.choice(list("ACGT"), 6000)))
    contig[500:523] = list(g20 + "TGG")
    contig[1500:1523] = list(revcomp(g20b + "AGG"))
    contig[2500:2521] = list(g18 + "CGG")
    # a site one SNP away from g20, fixed by a variant below
    near = list(g20)
    near[7] = "T" if near[7] != "T" else "A"
    contig[4000:4023] = list("".join(near) + "TGG")
    b = ReferenceSetBuilder(assembly="mgvar")
    b.add("c1").add("".join(contig))
    ref = b.to_file(tmp_path / "ref.fa")

    vcf = VcfBuilder()
    vcf.add("c1", 4008, "fix", [contig[4007], g20[7]], info={"AF": "0.35"})
    vcf.add("c1", 2490, "near18", [contig[2489], "T"], info={"AF": "0.2"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")

    specs = [("a", g20 + "nrg", ()), ("b", g20b + "nrg", ()),
             ("c", g18 + "nrg", ())]

    def key_rows(p):
        return sorted(
            (h.guide_id, h.chromosome, h.coordinate_start, h.strand, h.score,
             h.cigar, h.variant_description or "")
            for h in read_metrics(p, ReferenceHit)
        )

    multi = tmp_path / "multi.txt"
    search_reference.run(ref=ref, output=multi, guide_specs=specs,
                         variants=vcf_path, engine=engine)
    singles = []
    for gid, gstr, aux in specs:
        out = tmp_path / f"single_{gid}.txt"
        search_reference.run(ref=ref, output=out, guide=gstr, guide_id=gid,
                             auxiliary_pams=aux, variants=vcf_path,
                             engine=engine)
        singles.extend(key_rows(out))
    rows = key_rows(multi)
    assert rows == sorted(singles)
    assert any(r[6] for r in rows), "no variant-described hit produced"


def test_vcf_parsed_once_per_run(tmp_path, monkeypatch):
    """A multi-guide + checkpointed run must read the VCF exactly once
    (the VcfIndex replaces per-guide/per-contig re-scans)."""
    from calitas_tpu.io import vcf as vcf_mod
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools import search_reference
    from tests.vcf_util import VcfBuilder

    b = ReferenceSetBuilder(assembly="once")
    b.add("c1").add("AT" * 150).add("CTTGCCCCACAGGGCAGTAATGG").add("GC" * 150)
    b.add("c2").add("TA" * 150).add("GGCCTTAAGGCCTTAAGGCCAGG").add("CG" * 150)
    ref = b.to_file(tmp_path / "ref.fa")
    vcf = VcfBuilder()
    vcf.add("c1", 310, "s1", ["T", "G"], info={"AF": "0.4"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")

    opens = []
    orig = vcf_mod.VcfReader.__init__

    def counting(self, path):
        opens.append(str(path))
        orig(self, path)

    monkeypatch.setattr(vcf_mod.VcfReader, "__init__", counting)
    search_reference.run(
        ref=ref, output=tmp_path / "o.txt",
        guide_specs=[("g1", "CTTGCCCCACAGGGCAGTAAnrg", ()),
                     ("g2", "GGCCTTAAGGCCTTAAGGCCnrg", ())],
        variants=vcf_path, engine="host", checkpoint=tmp_path / "ck.jsonl",
    )
    assert opens.count(str(vcf_path)) == 1, opens


def test_long_guide_falls_back_to_xla_screen(tmp_path):
    """Guides beyond the pallas unroll budget (48nt) use the XLA screen."""
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.io.tsv import read_metrics
    from calitas_tpu.search.hits import ReferenceHit
    from calitas_tpu.tools import search_reference

    rng = np.random.default_rng(8)
    proto = "".join(rng.choice(list("ACGT"), 60))
    b = ReferenceSetBuilder()
    b.add("c").add("GT" * 300).add(proto + "TGG").add("CA" * 300)
    ref = b.to_file(tmp_path / "r.fa")
    for engine in ("host", "device"):
        out = tmp_path / f"{engine}.txt"
        search_reference.run(guide=proto + "nrg", guide_id="g", ref=ref,
                             output=out, engine=engine)
        hits = read_metrics(out, ReferenceHit)
        assert any(h.total_mm_plus_gaps == 0 for h in hits)


def test_no_hits_produces_header_only(tmp_path):
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools import search_reference

    b = ReferenceSetBuilder()
    b.add("c").add("AT" * 2000)
    ref = b.to_file(tmp_path / "r.fa")
    out = tmp_path / "out.txt"
    search_reference.run(guide="GGGGGGGGGGCCCCCCCCCCnrg", guide_id="g",
                         ref=ref, output=out, engine="host")
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 1 and lines[0].startswith("guide_id\t")


@pytest.mark.parametrize("engine", ["host", "tpu"])
def test_five_prime_pam_with_variants(tmp_path, engine):
    """Variant pass with a 5'-PAM guide: an insertion creates the
    protospacer match next to a TTTV PAM."""
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.io.tsv import read_metrics
    from calitas_tpu.search.hits import ReferenceHit
    from calitas_tpu.tools import search_reference
    from tests.vcf_util import VcfBuilder

    proto = "GACCAACATGATGAAACTCT"
    b = ReferenceSetBuilder(assembly="v5p")
    # reference genome has the site minus one base (created by variant)
    broken = proto[:10] + proto[11:]
    b.add("c1").add("GA" * 150).add("TTTG" + broken).add("AG" * 150)
    ref = b.to_file(tmp_path / "r.fa")

    # insertion restores the full protospacer: at position of the missing
    # base, insert it back
    pos = 300 + 4 + 10  # after 'GA'*150 + TTTG + first 10 proto bases
    prev_base = proto[9]
    vcf = VcfBuilder()
    vcf.add("c1", pos, "fix", [prev_base, prev_base + proto[10]],
            info={"AF": "0.25"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")

    out = tmp_path / "out.txt"
    search_reference.run(
        guide="tttv" + proto, guide_id="g", ref=ref, variants=vcf_path,
        output=out, engine=engine, max_guide_diffs=0,
        max_gaps_between_guide_and_pam=0,
    )
    hits = read_metrics(out, ReferenceHit)
    vhits = [h for h in hits if h.variant_id == "fix"]
    assert vhits, "variant-created 5'-PAM site not found"
    assert vhits[0].genome_build == "v5p+variants"
    assert vhits[0].allele_frequency == 0.25
    assert vhits[0].pam_used == "tttv"


def test_checkpoint_refuses_changed_inputs(tmp_path):
    """The fingerprint covers EVERY output-shaping input (VERDICT-class
    round-4 review finding): resuming with a different VCF, chrom
    restriction, or aux-PAM set must refuse, not silently merge stale
    rows."""
    import pytest as _pytest

    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools import search_reference
    from tests.vcf_util import VcfBuilder

    b = ReferenceSetBuilder(assembly="ckfp")
    b.add("c1").add("AT" * 200).add("CTTGCCCCACAGGGCAGTAATGG").add("GC" * 200)
    b.add("c2").add("TA" * 200).add("CTTGCCCCACAGGGCAGTAACGG").add("CG" * 200)
    ref = b.to_file(tmp_path / "ref.fa")
    guide = "CTTGCCCCACAGGGCAGTAAnrg"

    vcf1 = VcfBuilder()
    vcf1.add("c1", 410, "snp1", ["T", "G"], info={"AF": "0.4"})
    v1 = vcf1.to_file(tmp_path / "v1.vcf")
    vcf2 = VcfBuilder()
    vcf2.add("c1", 420, "snp2", ["A", "C"], info={"AF": "0.4"})
    v2 = vcf2.to_file(tmp_path / "v2.vcf")

    ck = tmp_path / "state.jsonl"
    search_reference.run(guide=guide, guide_id="g", ref=ref,
                         output=tmp_path / "o1.txt", engine="host",
                         checkpoint=ck, variants=v1)
    # same inputs: resume (here: all contigs done -> instant) is fine
    search_reference.run(guide=guide, guide_id="g", ref=ref,
                         output=tmp_path / "o2.txt", engine="host",
                         checkpoint=ck, variants=v1)
    # changed VCF / chrom restriction / aux PAMs: refused
    for kw in (
        {"variants": v2},
        {"variants": v1, "chrom": "c1"},
        {"variants": v1, "auxiliary_pams": ("nag",)},
    ):
        with _pytest.raises(ValueError):
            search_reference.run(
                guide=guide, guide_id="g", ref=ref,
                output=tmp_path / "oX.txt", engine="host", checkpoint=ck,
                **kw,
            )


def test_checkpoint_torn_tail_truncated_and_resumable(tmp_path):
    """A crash mid-write (kill -9/ENOSPC) tears the final JSONL line;
    open() must truncate the un-fsynced tail and resume, not crash with
    JSONDecodeError forever."""
    from calitas_tpu.search.checkpoint import CheckpointState

    ck = tmp_path / "s.jsonl"
    s = CheckpointState.open(ck, "fp")
    s.set_timestamp("t0")
    s.record("c1", [])
    s._fh.close()
    with open(ck, "a") as fh:
        fh.write('{"chrom": "c2", "hits": [{"l": "truncat')  # torn line
    s2 = CheckpointState.open(ck, "fp")
    assert s2.timestamp == "t0"
    assert s2.is_done("c1") and not s2.is_done("c2")
    # the torn bytes are gone; a fresh record appends cleanly
    s2.record("c2", [])
    s2._fh.close()
    s3 = CheckpointState.open(ck, "fp")
    assert s3.is_done("c2")


def test_checkpoint_torn_tail_non_ascii_byte_exact(tmp_path):
    """ADVICE r4: the truncate offset is bytes, not characters — a
    checkpoint holding non-ASCII records (e.g. a unicode guide id) with
    a torn tail must truncate at the right BYTE offset."""
    import json as _json

    from calitas_tpu.search.checkpoint import CheckpointState

    ck = tmp_path / "u.jsonl"
    # Hand-write records with raw (non-escaped) UTF-8 so byte len != char len.
    meta = _json.dumps({"meta": {"fingerprint": "fp", "timestamp": "t0"}})
    rec = _json.dumps(
        {"chrom": "chrß", "hits": []}, ensure_ascii=False
    )
    with open(ck, "wb") as fh:
        fh.write(meta.encode() + b"\n")
        fh.write(rec.encode("utf-8") + b"\n")
        fh.write(b'{"chrom": "c2", "hits": [{"l": "tor')  # torn tail
    s = CheckpointState.open(ck, "fp")
    assert s.is_done("chrß") and not s.is_done("c2")
    s._fh.close()
    # Byte-exact truncation: the file ends exactly after the good record.
    data = ck.read_bytes()
    assert data == meta.encode() + b"\n" + rec.encode("utf-8") + b"\n"


def test_native_abi_version_guard(tmp_path):
    """ADVICE r4: a stale .so with a fresh mtime must be rebuilt, not
    loaded silently with a mismatched buffer layout."""
    import ctypes

    from calitas_tpu import native

    lib = native.get_lib()
    if lib is None:
        pytest.skip("no compiler")
    assert native._abi_of(lib) == native._ABI_VERSION
    # A library without the symbol reads as pre-versioned (-1).
    class _NoSym:
        def __getattr__(self, name):
            raise AttributeError(name)

    assert native._abi_of(_NoSym()) == -1


def test_fused_serialize_handles_non_ascii_rows(tmp_path):
    """ADVICE r4: dedup_sort_serialize must not reject rows with
    non-ASCII fields (user-supplied guide ids) that the MetricWriter
    text path accepted."""
    from calitas_tpu.search.hits import dedup_sort_serialize
    from tests.test_rendered_hit import make_hit

    h = make_hit(
        chromosome="chr1", coordinate_start=10, coordinate_end=33,
        guide_id="guïde-ß",
    )
    body, n, n_fwd = dedup_sort_serialize([h], 10, None)
    assert n == 1
    assert "guïde-ß" in body.decode("utf-8")
