"""Multi-guide SearchReference: one staged-genome pass over many guides
must equal per-guide runs concatenated."""

import pytest

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.io.tsv import read_metrics
from calitas_tpu.search.hits import ReferenceHit
from calitas_tpu.tools import search_reference
from calitas_tpu.cli import main as cli_main

G1 = "ACGTACATGCTCGATACGACGnngrrn"
G2 = "TTGACCAAGCAAAACAGACCnrg"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    b = ReferenceSetBuilder()
    c = b.add("chr1")
    c.add("N", 500)
    c.add("ACGTACATGCTCGATACGACG" + "CCGAAT")  # G1 site
    c.add("GT", 300)
    c.add("TTGACCAAGCAAAACAGACC" + "TGG")  # G2 site
    c.add("N", 500)
    return b.to_file(tmp_path_factory.mktemp("mg") / "ref.fa")


@pytest.mark.parametrize("engine", ["host", "tpu"])
def test_multi_guide_equals_individual_runs(ref, tmp_path, engine):
    multi = tmp_path / f"multi.{engine}.txt"
    search_reference.run(
        ref=ref, output=multi, engine=engine,
        guide_specs=[("g1", G1, ()), ("g2", G2, ())],
    )
    multi_hits = read_metrics(multi, ReferenceHit)

    singles = []
    for gid, g in (("g1", G1), ("g2", G2)):
        out = tmp_path / f"{gid}.{engine}.txt"
        search_reference.run(
            guide=g, guide_id=gid, ref=ref, output=out, engine=engine
        )
        singles.extend(read_metrics(out, ReferenceHit))

    def key(h):
        return (h.guide_id, h.chromosome, h.coordinate_start, h.strand,
                h.score, h.cigar, h.padded_alignment)

    assert sorted(map(key, multi_hits)) == sorted(map(key, singles))
    assert {h.guide_id for h in multi_hits} == {"g1", "g2"}


def test_guide_file_cli(ref, tmp_path):
    gf = tmp_path / "guides.tsv"
    gf.write_text("guide_id\tguide\ng1\t%s\ng2\t%s\n" % (G1, G2))
    out = tmp_path / "out.txt"
    rc = cli_main([
        "SearchReference", "--guide-file", str(gf),
        "-r", str(ref), "-o", str(out), "--engine", "host",
    ])
    assert rc == 0
    hits = read_metrics(out, ReferenceHit)
    assert {h.guide_id for h in hits} == {"g1", "g2"}


def test_same_length_guides_use_grouped_screen(ref, tmp_path):
    """Same-length guide groups run the multi-guide kernel path; output
    must equal per-guide runs."""
    # Same protospacer length (21) and same total guide-string length ->
    # one screen group.
    g1 = "ACGTACATGCTCGATACGACGnr"
    g2 = "TTGACCAAGCAAAACAGACCAnr"
    g3 = "GGGGCCCCAAAATTTTACGTAnr"
    specs = [("m1", g1, ()), ("m2", g2, ()), ("m3", g3, ())]
    multi = tmp_path / "multi3.txt"
    search_reference.run(ref=ref, output=multi, engine="device",
                         guide_specs=specs)
    multi_hits = read_metrics(multi, ReferenceHit)

    singles = []
    for gid, g, _ in specs:
        out = tmp_path / f"{gid}.txt"
        search_reference.run(guide=g, guide_id=gid, ref=ref, output=out,
                             engine="device")
        singles.extend(read_metrics(out, ReferenceHit))

    key = lambda h: (h.guide_id, h.chromosome, h.coordinate_start, h.strand,
                     h.score, h.cigar)
    assert sorted(map(key, multi_hits)) == sorted(map(key, singles))


def test_repeated_guide_flag_is_an_error(capsys):
    """-i twice must error (pointing at --guide-file), not silently
    search only the last guide."""
    import pytest

    from calitas_tpu.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(
            ["SearchReference", "-i", "ACGTACGTACGTACGTACGTnrg",
             "-i", "TTTTACGTACGTACGTACGTnrg", "-r", "x.fa"]
        )
    err = capsys.readouterr().err
    assert "more than once" in err and "--guide-file" in err
