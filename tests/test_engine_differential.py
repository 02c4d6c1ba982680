"""Randomized end-to-end differential: the device-screened engine must emit
tables identical (modulo time_stamp) to the host-only engine."""

import numpy as np
import pytest

from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.tools import search_reference


def table_without_timestamp(path):
    rows = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        ts = header.index("time_stamp")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            f[ts] = ""
            rows.append(tuple(f))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engines_identical_on_random_genomes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    proto = "".join(rng.choice(list("ACGT"), 20))
    guide = proto + "nrg"

    genome = list("".join(rng.choice(list("ACGT"), 120_000)))
    # plant several mutated copies on both strands
    for _ in range(8):
        pos = int(rng.integers(100, 118_000))
        site = list(proto)
        for _ in range(int(rng.integers(0, 5))):
            i = int(rng.integers(0, len(site)))
            site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
        seq = "".join(site) + rng.choice(["TGG", "GAG", "CGG"])
        if rng.random() < 0.5:
            seq = revcomp(seq)
        genome[pos : pos + len(seq)] = list(seq)

    b = ReferenceSetBuilder(assembly=f"fuzz{seed}")
    b.add("chr1").add("".join(genome))
    ref = b.to_file(tmp_path / "ref.fa")

    out_host = tmp_path / "host.txt"
    out_dev = tmp_path / "device.txt"
    search_reference.run(
        guide=guide, guide_id="g", ref=ref, output=out_host, engine="host"
    )
    search_reference.run(
        guide=guide, guide_id="g", ref=ref, output=out_dev, engine="device"
    )
    host_rows = table_without_timestamp(out_host)
    dev_rows = table_without_timestamp(out_dev)
    assert host_rows == dev_rows
    assert len(host_rows) > 0  # planted sites must be found


def test_long_guide_beyond_pallas_budget(tmp_path):
    """A 60nt guide exceeds the pallas kernel's unroll budget (Q<=48);
    the screened path must fall to the XLA kernel and still match the
    host engine row-for-row."""
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools.search_reference import run

    rng = np.random.default_rng(21)
    proto = "".join(rng.choice(list("ACGT"), 60))
    guide = proto + "ngg"
    b = ReferenceSetBuilder(assembly="lg")
    seq = list("".join(rng.choice(list("ACGT"), 200_000)))
    for k in range(4):
        p = 20_000 + k * 40_000
        site = list(proto + "TGG")
        for _ in range(k):
            i = int(rng.integers(0, 60))
            site[i] = rng.choice(list("ACGT"))
        seq[p : p + len(site)] = site
    b.add("chr1").add("".join(seq))
    fa = b.to_file(tmp_path / "ref.fa")
    run(guide=guide, guide_id="lg", ref=fa, engine="device", threads=1,
        output=tmp_path / "t.txt")
    run(guide=guide, guide_id="lg", ref=fa, engine="host", threads=1,
        output=tmp_path / "h.txt")
    assert table_without_timestamp(tmp_path / "t.txt") == \
        table_without_timestamp(tmp_path / "h.txt")
    assert len((tmp_path / "t.txt").read_text().splitlines()) >= 4


@pytest.mark.parametrize("kw", [
    dict(window_size=3000),  # beyond the end-column-range limit: the
    #                          screen must run rangeless, still exact
    dict(max_overlap=0),
    dict(guide_mismatch_net_cost=-100, genome_gap_net_cost=-103,
         guide_gap_net_cost=-102),
    dict(max_guide_diffs=2, max_gaps_between_guide_and_pam=1),
])
def test_engines_identical_odd_configs(tmp_path, kw):
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools.search_reference import run

    rng = np.random.default_rng(31)
    proto = "GACGCATAAAGATGAGACGC"
    b = ReferenceSetBuilder(assembly="mx")
    seq = list("".join(rng.choice(list("ACGT"), 120_000)))
    for k in range(6):
        p = 8_000 + k * 18_000
        site = list(proto + "TGG")
        for _ in range(k % 5):
            i = int(rng.integers(0, 20))
            site[i] = rng.choice(list("ACGT"))
        seq[p : p + 23] = site
    b.add("chr1").add("".join(seq))
    fa = b.to_file(tmp_path / "ref.fa")
    run(guide=proto + "nrg", guide_id="g", ref=fa, engine="device",
        threads=1, output=tmp_path / "t.txt", **kw)
    run(guide=proto + "nrg", guide_id="g", ref=fa, engine="host",
        threads=1, output=tmp_path / "h.txt", **kw)
    assert table_without_timestamp(tmp_path / "t.txt") == \
        table_without_timestamp(tmp_path / "h.txt")


@pytest.mark.parametrize("seed", [7, 8])
def test_engines_identical_with_variants(tmp_path, seed):
    """The variant pass through the fused slot screen (mixed guide
    lengths -> two same-length groups) must emit tables identical to the
    host-only engine, including variant rows."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from vcf_util import VcfBuilder

    rng = np.random.default_rng(seed)
    proto_a = "".join(rng.choice(list("ACGT"), 20))
    proto_b = "".join(rng.choice(list("ACGT"), 22))

    genome = list("".join(rng.choice(list("ACGT"), 80_000)))
    for proto in (proto_a, proto_b):
        for _ in range(4):
            pos = int(rng.integers(100, 78_000))
            site = list(proto)
            for _ in range(int(rng.integers(0, 4))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            seq = "".join(site) + rng.choice(["TGG", "GAG", "CGG"])
            if rng.random() < 0.5:
                seq = revcomp(seq)
            genome[pos : pos + len(seq)] = list(seq)
    gstr = "".join(genome)

    b = ReferenceSetBuilder(assembly=f"vfuzz{seed}")
    b.add("chr1").add(gstr)
    ref = b.to_file(tmp_path / "ref.fa")

    vb = VcfBuilder()
    for pos in sorted(int(p) for p in rng.integers(500, 79_500, size=300)):
        ref_b = gstr[pos - 1]
        kind = rng.random()
        if kind < 0.7:  # SNP
            alt = rng.choice([c for c in "ACGT" if c != ref_b])
            alleles = (ref_b, alt)
        elif kind < 0.85:  # insertion
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
            alleles = (ref_b, ref_b + ins)
        else:  # deletion
            dlen = int(rng.integers(1, 4))
            alleles = (gstr[pos - 1 : pos + dlen], ref_b)
        vb.add(chrom="chr1", pos=pos, alleles=alleles, info={"AF": "0.25"})
    vcf = vb.to_file(tmp_path / "v.vcf")

    out_host = tmp_path / "host.txt"
    out_dev = tmp_path / "device.txt"
    specs = [("ga", proto_a + "nrg", ()), ("gb", proto_b + "nrg", ())]
    search_reference.run(
        ref=ref, variants=vcf, output=out_host, engine="host",
        guide_specs=specs,
    )
    search_reference.run(
        ref=ref, variants=vcf, output=out_dev, engine="device",
        guide_specs=specs,
    )
    host_rows = table_without_timestamp(out_host)
    dev_rows = table_without_timestamp(out_dev)
    assert host_rows == dev_rows
    assert len(host_rows) > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_pairwise_engines_identical(tmp_path, seed):
    """PairwiseAlignSequences --engine device (pair screen + exact pass
    skipping) must emit byte-identical output to the host path,
    including 5'-PAM guides whose chain->pass mapping swaps."""
    from calitas_tpu.tools import pairwise

    rng = np.random.default_rng(seed)
    inp = tmp_path / "pairs.txt"
    with open(inp, "w") as fh:
        for i in range(300):
            plen = int(rng.integers(16, 23))
            proto = "".join(rng.choice(list("ACGT"), plen))
            guide = ("nrg" + proto) if i % 4 == 0 else (proto + "ngg")
            if i % 4 == 0:
                guide = "ccn" + proto  # 5' PAM (lowercase leading run)
            t = list("".join(rng.choice(list("ACGT"), 70)))
            if i % 3 == 0:  # plant (sometimes mutated, sometimes rc)
                site = list(proto)
                for _ in range(int(rng.integers(0, 4))):
                    j = int(rng.integers(0, len(site)))
                    site[j] = rng.choice(list("ACGT"))
                seq = "".join(site)
                if rng.random() < 0.5:
                    seq = revcomp(seq)
                pos = int(rng.integers(0, 70 - len(seq)))
                t[pos : pos + len(seq)] = list(seq)
            fh.write(f"{guide}\t{''.join(t)}\n")
    out_h = tmp_path / "h.txt"
    out_t = tmp_path / "t.txt"
    pairwise.run(input=inp, output=out_h, engine="host", threads=1)
    pairwise.run(input=inp, output=out_t, engine="device", threads=1)
    assert out_h.read_text() == out_t.read_text()


@pytest.mark.parametrize("all_hits", [False, True])
def test_align_to_reference_engines_identical(tmp_path, all_hits):
    """AlignToReference --engine device (pair screen bounds: exact rev-pass
    skip in best mode, pass restriction in all-hits mode) must emit
    tables identical to the host path."""
    from calitas_tpu.tools import align_to_reference

    rng = np.random.default_rng(31)
    proto = "".join(rng.choice(list("ACGT"), 20))
    genome = list("".join(rng.choice(list("ACGT"), 50_000)))
    positions = []
    for _ in range(12):
        pos = int(rng.integers(200, 49_000))
        site = list(proto)
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, len(site)))
            site[j] = rng.choice(list("ACGT"))
        seq = "".join(site) + "TGG"
        if rng.random() < 0.5:
            seq = revcomp(seq)
        genome[pos : pos + len(seq)] = list(seq)
        positions.append(pos)
    b = ReferenceSetBuilder(assembly="a2r")
    b.add("chr1").add("".join(genome))
    ref = b.to_file(tmp_path / "ref.fa")
    inp = tmp_path / "loci.txt"
    with open(inp, "w") as fh:
        fh.write("id\tquery\tchrom\tposition\n")
        for i, pos in enumerate(positions):
            fh.write(f"t{i}\t{proto}nrg\tchr1\t{pos + 1}\n")

    kw = {}
    if all_hits:
        kw = dict(max_guide_diffs=4, max_pam_mismatches=1, max_overlap=10)
    out_h = tmp_path / "h.txt"
    out_t = tmp_path / "t.txt"
    align_to_reference.run(input=inp, ref=ref, output=out_h, engine="host",
                           threads=1, window_size=120, **kw)
    align_to_reference.run(input=inp, ref=ref, output=out_t, engine="device",
                           threads=1, window_size=120, **kw)
    assert table_without_timestamp(out_h) == table_without_timestamp(out_t)
    assert len(table_without_timestamp(out_h)) > 0
