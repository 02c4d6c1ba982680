"""Multi-device sharding tests on the virtual 8-device CPU mesh:
shard-merge equality with single-device output (SURVEY.md §4's
multi-host test requirement)."""

import numpy as np
import pytest

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import revcomp


@pytest.fixture(scope="module")
def mesh8():
    import jax

    try:
        devices = jax.devices("cpu")
    except Exception:
        devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 devices (set xla_force_host_platform_device_count)")
    from calitas_tpu.parallel.mesh import make_mesh

    return make_mesh(8, devices=devices)


class TestShardedScreen:
    def test_flags_match_single_device(self, mesh8):
        from calitas_tpu.ops.genome_screen import GenomeScreen, ShardedGenomeScreen

        rng = np.random.default_rng(2)
        guide = "CTTGCCCCACAGGGCAGTAA"
        contig = "".join(rng.choice(list("ACGT"), 60_000))
        contig = contig[:5000] + guide + contig[5000 + len(guide) :]
        bases = np.frombuffer(contig.encode(), dtype=np.uint8)
        scorer = derive_scorer()

        single = GenomeScreen(scorer, window=1000, batch_windows=512, use_kernel=False)
        f1 = single.screen_contig(
            single.stage(bases), len(bases), 970, guide, revcomp(guide), 590
        )
        sharded = ShardedGenomeScreen(
            scorer, mesh8, window=1000, batch_windows=512, use_kernel=False
        )
        f2 = sharded.screen_contig(
            sharded.stage(bases), len(bases), 970, guide, revcomp(guide), 590
        )
        assert np.array_equal(f1, f2)
        assert f1.any()

    def test_gated_chain_flags_and_ranges_match_single_device(self, mesh8):
        """The sharded screen must reproduce the single-device screen's
        FULL output contract: per-chain flags, PAM-gated kernel path and
        coarse end-column ranges (VERDICT r1 item 3)."""
        from calitas_tpu.ops.genome_screen import GenomeScreen, ShardedGenomeScreen

        rng = np.random.default_rng(5)
        guide = "CTTGCCCCACAGGGCAGTAA"
        contig = list("".join(rng.choice(list("ACGT"), 30_000)))
        for pos, seq in ((700, guide + "TGG"), (9000, revcomp(guide + "AGG"))):
            contig[pos : pos + len(seq)] = list(seq)
        bases = np.frombuffer("".join(contig).encode(), dtype=np.uint8)
        scorer = derive_scorer()
        pam_spec = (("ngg",), 1, 3)

        kw = dict(window=250, batch_windows=1024, use_kernel=True,
                  interpret=True)
        single = GenomeScreen(scorer, **kw)
        f1, r1 = single.screen_contig(
            single.stage(bases), len(bases), 220, guide, revcomp(guide),
            1100, pam_spec=pam_spec, return_ranges=True,
        )
        sharded = ShardedGenomeScreen(scorer, mesh8, **kw)
        f2, r2 = sharded.screen_contig(
            sharded.stage(bases), len(bases), 220, guide, revcomp(guide),
            1100, pam_spec=pam_spec, return_ranges=True,
        )
        assert np.array_equal(f1, f2)
        assert f1.any()
        # ranges are only contractual where the chain flag is set
        assert np.array_equal(r1[f1], r2[f2])

    def test_screened_search_on_mesh_identical_rows(self, mesh8, tmp_path):
        """End-to-end: screened_search over the mesh yields the same
        alignments as the single-device path (and exercises the sharded
        ranges -> sliced native finish wiring)."""
        from calitas_tpu.align.engine import SequentialAligner
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.io.fasta import ReferenceSetBuilder
        from calitas_tpu.parallel.screen_runner import GuideTask, screened_search

        rng = np.random.default_rng(9)
        proto = "".join(rng.choice(list("ACGT"), 20))
        contig = list("".join(rng.choice(list("ACGT"), 50_000)))
        for _ in range(6):
            pos = int(rng.integers(100, 49_000))
            site = list(proto)
            for _ in range(int(rng.integers(0, 3))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            seq = "".join(site) + "TGG"
            if rng.random() < 0.5:
                seq = revcomp(seq)
            contig[pos : pos + len(seq)] = list(seq)
        from calitas_tpu.io.fasta import IndexedFasta

        b = ReferenceSetBuilder(assembly="shardtest")
        b.add("chr1").add("".join(contig))
        ref = IndexedFasta(b.to_file(tmp_path / "ref.fa"))

        guide = Guide.parse(proto + "nrg")
        aligner = SequentialAligner()
        kw = dict(
            max_guide_diffs=5, max_pam_diffs=1,
            max_gaps_between_guide_and_pam=3, max_total_diffs=9,
            max_overlap=10,
        )
        task = GuideTask(
            guide_id="g", guide=guide, guide_length=len(guide.guide),
            step_size=970,
        )
        hit_spec = dict(
            ref_path=str(ref.path), aligner_id="a", arguments="args",
            vcf_id="", timestamp="ts",
        )

        def run(mesh):
            rows = []
            for _t, chrom, start, rr in screened_search(
                ref, None, [task], aligner, window_size=1000,
                mesh=mesh, hit_spec=hit_spec, **kw,
            ):
                rows.extend(
                    (chrom, start, r.coordinate_start, r.coordinate_end,
                     r.strand, r.cigar, r.score, r.padded_target)
                    for r in rr
                )
            return rows

        single_rows = run(None)
        mesh_rows = run(mesh8)
        assert single_rows == mesh_rows
        assert len(single_rows) > 0

    def test_mesh_psum_hit_count(self, mesh8):
        from calitas_tpu.core.sequence import encode_query, encode_target
        from calitas_tpu.parallel.mesh import screen_on_mesh

        scorer = derive_scorer()
        rng = np.random.default_rng(0)
        Q, B, T = 12, 32, 64
        query = "ACGTACGTACGT"
        qmask = encode_query(query)
        tmasks = rng.integers(1, 15, size=(B, T), dtype=np.uint8)
        tmasks[5, 3 : 3 + Q] = qmask
        lengths = np.full(B, T, np.int32)
        best, total = screen_on_mesh(
            mesh8, scorer, qmask, tmasks, lengths, scorer.match_score * Q
        )
        assert best[5] == scorer.match_score * Q
        assert total >= 1


class TestShardedPackedStaging:
    def test_packed_staging_replicated_and_identical(self, mesh8):
        """The nibble-packed staging transport must produce the same
        fully-replicated mask array as raw staging on a mesh."""
        from calitas_tpu.ops.genome_screen import ShardedGenomeScreen

        rng = np.random.default_rng(6)
        bases = rng.choice(
            np.frombuffer(b"ACGTNacgtn", np.uint8), 5001
        )
        scorer = derive_scorer()
        raw = ShardedGenomeScreen(
            scorer, mesh8, window=256, use_kernel=False, pack_staging=False
        )
        packed = ShardedGenomeScreen(
            scorer, mesh8, window=256, use_kernel=False, pack_staging=True
        )
        a = raw.stage(bases)
        b = packed.stage(bases)
        assert b.sharding.is_fully_replicated
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestShardedAsyncScreen:
    def test_segmented_flags_and_ranges_match_single_device(self, mesh8):
        """The sharded segmented screen must resolve to the same
        per-chain flags and coarse end-column ranges as the one-shot
        single-device screen."""
        from calitas_tpu.ops.genome_screen import (
            GenomeScreen,
            ShardedGenomeScreen,
        )

        rng = np.random.default_rng(9)
        guide = "CTTGCCCCACAGGGCAGTAA"
        contig = "".join(rng.choice(list("ACGT"), 2_000_000))
        for pos in (5000, 800_000, 1_900_000):
            contig = contig[:pos] + guide + contig[pos + len(guide):]
        bases = np.frombuffer(contig.encode(), dtype=np.uint8)
        scorer = derive_scorer()

        single = GenomeScreen(
            scorer, window=1000, batch_windows=128, use_kernel=False
        )
        f1, r1 = single.screen_contig(
            single.stage(bases), len(bases), 970, guide, revcomp(guide),
            590, return_ranges=True,
        )
        sharded = ShardedGenomeScreen(
            scorer, mesh8, window=1000, batch_windows=128, use_kernel=False
        )
        segs = sharded.screen_contig_async(
            sharded.stage(bases), len(bases), 970, guide, revcomp(guide),
            590, segments=2,
        )
        assert len(segs) >= 2, "expected multiple segments at this size"
        flags_parts, range_parts = [], []
        n_total = 0
        for i0, n_seg, resolve in segs:
            assert i0 == n_total
            cf, rg = resolve()
            assert cf.shape == (2, n_seg)
            flags_parts.append(cf)
            range_parts.append(rg)
            n_total += n_seg
        f2 = np.concatenate(flags_parts, axis=1)[:, : f1.shape[1]]
        r2 = np.concatenate(range_parts, axis=1)[:, : r1.shape[1]]
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(r1, r2)
        assert f1.any()


class TestShardedMultiGuideScreen:
    def test_sharded_multi_async_equals_single_device_multi(self, mesh8):
        """The mesh-sharded fused multi-guide screen must match the
        single-device multi screen per guide — flags AND ranges, PAM
        gate included (one contract across both screens)."""
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.ops.genome_screen import (
            GenomeScreen,
            ShardedGenomeScreen,
        )

        rng = np.random.default_rng(31)
        bases = rng.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 120_000
        ).astype(np.uint8)
        guides = [
            Guide.parse("CTTGCCCCACAGGGCAGTAAnrg"),
            Guide.parse("ACGTACATGCTCGATACGACnrg"),
        ]
        for g, pos in zip(guides, (7_000, 90_000)):
            site = (g.guide + "TGG").encode()
            bases[pos : pos + len(site)] = np.frombuffer(site, dtype=np.uint8)
        scorer = derive_scorer()
        dqs = [(g.guide_fw, revcomp(g.guide_fw)) for g in guides]
        mss = [60 * len(g.guide_fw) - 5 * 122 for g in guides]
        pam_spec = (tuple(guides[0].pams_fw), 1, 3)

        def run(screen):
            gdev = screen.stage(bases)
            parts_f, parts_r = [], []
            for _i0, n_seg, resolve in screen.screen_contig_multi_async(
                gdev, len(bases), 230, dqs, mss, pam_spec=pam_spec,
            ):
                cf, cr = resolve()
                assert cf.shape[2] == n_seg and cr.shape[2] == n_seg
                parts_f.append(cf)
                parts_r.append(cr)
            return (
                np.concatenate(parts_f, axis=2),
                np.concatenate(parts_r, axis=2),
            )

        f1, r1 = run(
            GenomeScreen(scorer, window=256, batch_windows=1024,
                         use_kernel=False)
        )
        f2, r2 = run(
            ShardedGenomeScreen(scorer, mesh8, window=256,
                                batch_windows=1024, use_kernel=False)
        )
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(r1, r2)
        assert f1.any(axis=(1, 2)).all()  # every guide found its plant


class TestShardedVariantPass:
    """VERDICT r4 item 4: the variant pass must have a multi-device
    story — slot batches shard across the mesh
    (genome_screen.make_sharded_slot_flags) and the full tool's table is
    identical to single-device execution."""

    def test_slot_flags_match_single_device(self, mesh8):
        from calitas_tpu.align.engine import SequentialAligner
        from calitas_tpu.core.sequence import encode_query, revcomp
        from calitas_tpu.ops.genome_screen import screen_slots_multi

        rng = np.random.default_rng(23)
        al = SequentialAligner()
        B, T = 64, 64
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        from calitas_tpu.core.sequence import TARGET_MASK_TABLE

        tmasks = TARGET_MASK_TABLE[
            letters[rng.integers(0, 4, size=(B, T))]
        ]
        proto = "CTTGCCCCACAGGGCAGTAA"
        site = np.frombuffer((proto + "TGG").encode(), np.uint8)
        tmasks[5, 10 : 10 + len(site)] = TARGET_MASK_TABLE[site]
        tmasks[40, : len(site)] = TARGET_MASK_TABLE[site]
        lengths = np.full(B, T, np.int32)
        qv = np.stack(
            [encode_query(proto), encode_query(revcomp(proto))]
        ).astype(np.int32)[None]
        groups = [(False, qv, np.asarray([al.scorer.match_score * 10], np.int32))]

        single = screen_slots_multi(al.scorer, tmasks, lengths, groups)[0]()
        sharded = screen_slots_multi(
            al.scorer, tmasks, lengths, groups, mesh=mesh8
        )[0]()
        np.testing.assert_array_equal(single, sharded)
        assert single.any()

    def test_variant_pass_on_mesh_identical_table(self, mesh8, tmp_path):
        """Full SearchReference with a VCF: mesh run == single-device
        run, row for row (only time_stamp may differ)."""
        from calitas_tpu.io.fasta import ReferenceSetBuilder
        from calitas_tpu.tools import search_reference
        from tests.vcf_util import VcfBuilder

        rng = np.random.default_rng(17)
        proto = "CTTGCCCCACAGGGCAGTAA"
        contig = list("".join(rng.choice(list("ACGT"), 20_000)))
        for i, pos in enumerate((500, 5_000, 12_000)):
            site = proto + "TGG"
            if i % 2:
                site = revcomp(site)
            contig[pos : pos + len(site)] = list(site)
        # A site that only matches once a variant restores base 10.
        broken = list(proto)
        broken[10] = "A" if proto[10] != "A" else "C"
        contig[8_000 : 8_000 + 23] = list("".join(broken) + "TGG")
        contig = "".join(contig)
        b = ReferenceSetBuilder(assembly="shardvar")
        b.add("chr1").add(contig)
        ref = b.to_file(tmp_path / "ref.fa")

        vb = VcfBuilder()
        vb.add("chr1", 8_011, alleles=(contig[8_010], proto[10]),
               info={"AF": "0.5"})
        for _ in range(60):  # noise variants across the contig
            p = int(rng.integers(100, 19_000))
            ref_b = contig[p - 1]
            alt = rng.choice([c for c in "ACGT" if c != ref_b])
            vb.add("chr1", p, alleles=(ref_b, alt), info={"AF": "0.1"})
        vcf = vb.to_file(tmp_path / "v.vcf")

        def rows(p):
            lines = open(p).read().splitlines()
            ts = lines[0].split("\t").index("time_stamp")
            return [
                tuple(x for i, x in enumerate(l.split("\t")) if i != ts)
                for l in lines[1:]
            ]

        single = tmp_path / "single.txt"
        search_reference.run(
            guide=proto + "nrg", guide_id="g", ref=ref, variants=vcf,
            output=single, engine="device", threads=1,
        )
        meshed = tmp_path / "meshed.txt"
        search_reference.run(
            guide=proto + "nrg", guide_id="g", ref=ref, variants=vcf,
            output=meshed, engine="device", threads=1, mesh=mesh8,
        )
        assert rows(single) == rows(meshed)
        # the variant-restored site must be present (variant columns set)
        assert any(r for r in rows(single) if "0.500" in "\t".join(r))
