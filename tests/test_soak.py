"""Extended randomized soaks (opt-in: CALITAS_SOAK=1).

These mirror the quick differential tests but with broad random coverage
of costs, IUPAC content, PAM styles and limits.  Run before releases:

    CALITAS_SOAK=1 python -m pytest tests/test_soak.py -q
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("CALITAS_SOAK"), reason="set CALITAS_SOAK=1 to run"
)


def test_engine_differential_many_seeds(tmp_path):
    from calitas_tpu.core.sequence import revcomp
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools import search_reference
    from tests.test_engine_differential import table_without_timestamp

    for seed in range(10):
        rng = np.random.default_rng(1000 + seed)
        proto = "".join(rng.choice(list("ACGT"), int(rng.integers(16, 26))))
        style = seed % 3
        guide = [proto + "nrg", "tttv" + proto, proto][style]
        genome = list("".join(rng.choice(list("ACGT"), 60_000)))
        for _ in range(6):
            pos = int(rng.integers(100, 59_000))
            site = list(proto)
            for _ in range(int(rng.integers(0, 5))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice(list("ACGT"))
            seq = ("TTTG" if style == 1 else "") + "".join(site) + (
                "" if style == 1 else rng.choice(["TGG", "GAG"])
            )
            if rng.random() < 0.5:
                seq = revcomp(seq)
            genome[pos : pos + len(seq)] = list(seq)

        b = ReferenceSetBuilder(assembly=f"s{seed}")
        b.add("chr1").add("".join(genome))
        ref = b.to_file(tmp_path / f"ref{seed}.fa")
        out_h = tmp_path / f"h{seed}.txt"
        out_t = tmp_path / f"t{seed}.txt"
        search_reference.run(guide=guide, guide_id="g", ref=ref,
                             output=out_h, engine="host")
        search_reference.run(guide=guide, guide_id="g", ref=ref,
                             output=out_t, engine="device")
        assert table_without_timestamp(out_h) == table_without_timestamp(out_t), (
            f"seed {seed} guide {guide}"
        )


def test_native_search_pass_soak():
    from calitas_tpu.core.guide import Guide
    from calitas_tpu.core.sequence import (
        encode_query, encode_target, revcomp_bytes,
    )
    from calitas_tpu.align import oracle
    from calitas_tpu.align.engine import SequentialAligner

    rng = np.random.default_rng(2024)
    for trial in range(300):
        costs = dict(
            mismatch_net_cost=int(rng.integers(-300, -10)),
            genome_gap_net_cost=int(rng.integers(-300, -10)),
            guide_gap_net_cost=int(rng.integers(-300, -10)),
            pam_mismatch_net_cost=int(rng.integers(-500, -10)),
        )
        al = SequentialAligner(**costs)
        Q = int(rng.integers(8, 30))
        proto = "".join(rng.choice(list("ACGTN"), Q))
        style = trial % 4
        if style == 0:
            guide = Guide.parse(proto)
        elif style == 1:
            guide = Guide.parse(
                proto + "".join(rng.choice(list("nrykgact"), int(rng.integers(2, 5))))
            )
        elif style == 2:
            guide = Guide.parse("".join(rng.choice(list("nrykgact"), 3)) + proto)
        else:
            guide = Guide.parse(proto + "nrg", aux_pams=["ntg"])
        T = int(rng.integers(Q + 3, 400))
        target = "".join(rng.choice(list("ACGTNRY"), T))
        kw = dict(
            max_guide_diffs=int(rng.integers(0, 7)),
            max_gaps_between_guide_and_pam=int(rng.integers(0, 5)),
            max_pam_diffs=int(rng.integers(0, 4)),
            max_overlap=int(rng.integers(0, 15)),
            max_total_diffs=int(rng.integers(0, 12)),
        )

        got = al.align(guide, target, **kw)

        min_score = al.min_guide_score(guide, kw["max_guide_diffs"])
        tgt_b = target.encode()
        rc_b = bytes(revcomp_bytes(np.frombuffer(tgt_b, np.uint8)))
        dp_query = (
            guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
        ).encode()
        fwd_tgt = rc_b if guide.pam_is_5prime else tgt_b
        rev_tgt = tgt_b if guide.pam_is_5prime else rc_b
        import calitas_tpu.native as native_mod

        real = native_mod.get_lib
        native_mod.get_lib = lambda: None
        try:
            pre = {
                "fwd": oracle.glocal_align_multi(
                    dp_query, fwd_tgt, encode_query(dp_query),
                    encode_target(fwd_tgt), al.scorer, min_score,
                ),
                "rev": oracle.glocal_align_multi(
                    dp_query, rev_tgt, encode_query(dp_query),
                    encode_target(rev_tgt), al.scorer, min_score,
                ),
            }
            want = al.align(guide, target, precomputed=pre, **kw)
        finally:
            native_mod.get_lib = real

        def key(a):
            return (a.strand, a.start_offset, a.end_offset, a.score,
                    str(a.cigar), a.padded_guide, a.padded_alignment,
                    a.padded_target)

        assert [key(a) for a in got] == [key(a) for a in want], f"trial {trial}"


def test_variant_pass_differential_many_seeds(tmp_path):
    """Broad random coverage of the variant pass: SNPs/insertions/
    deletions, multi-allelic records, clustered variants, mixed guide
    lengths, blocks-mode device screening vs the host engine."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vcf_util import VcfBuilder

    from calitas_tpu.core.sequence import revcomp
    from calitas_tpu.io.fasta import ReferenceSetBuilder
    from calitas_tpu.tools import search_reference
    from tests.test_engine_differential import table_without_timestamp

    for seed in range(6):
        rng = np.random.default_rng(2000 + seed)
        protos = [
            "".join(rng.choice(list("ACGT"), int(rng.integers(17, 24))))
            for _ in range(2)
        ]
        genome = list("".join(rng.choice(list("ACGT"), 50_000)))
        for proto in protos:
            for _ in range(4):
                pos = int(rng.integers(100, 49_000))
                site = list(proto)
                for _ in range(int(rng.integers(0, 4))):
                    i = int(rng.integers(0, len(site)))
                    site[i] = rng.choice(list("ACGT"))
                seq = "".join(site) + rng.choice(["TGG", "CGG"])
                if rng.random() < 0.5:
                    seq = revcomp(seq)
                genome[pos : pos + len(seq)] = list(seq)
        gstr = "".join(genome)
        b = ReferenceSetBuilder(assembly=f"vs{seed}")
        b.add("chr1").add(gstr)
        ref = b.to_file(tmp_path / f"vref{seed}.fa")

        vb = VcfBuilder()
        used = set()
        for pos in sorted(int(p) for p in rng.integers(500, 49_500, size=250)):
            if pos in used:
                continue
            used.add(pos)
            rb = gstr[pos - 1]
            kind = rng.random()
            if kind < 0.55:  # SNP (possibly multi-allelic)
                alts = rng.choice(
                    [c for c in "ACGT" if c != rb],
                    size=int(rng.integers(1, 3)), replace=False,
                )
                alleles = (rb, *alts)
            elif kind < 0.8:  # insertion
                ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 5))))
                alleles = (rb, rb + ins)
            else:  # deletion
                dlen = int(rng.integers(1, 5))
                alleles = (gstr[pos - 1 : pos + dlen], rb)
            vb.add(chrom="chr1", pos=pos, alleles=alleles,
                   info={"AF": f"{rng.uniform(0.01, 0.9):.3f}"})
        vcf = vb.to_file(tmp_path / f"v{seed}.vcf")

        specs = [(f"g{i}", p + "nrg", ()) for i, p in enumerate(protos)]
        out_h = tmp_path / f"vh{seed}.txt"
        out_t = tmp_path / f"vt{seed}.txt"
        search_reference.run(ref=ref, variants=vcf, output=out_h,
                             engine="host", guide_specs=specs)
        search_reference.run(ref=ref, variants=vcf, output=out_t,
                             engine="device", guide_specs=specs)
        assert table_without_timestamp(out_h) == table_without_timestamp(
            out_t
        ), f"seed {seed}"
