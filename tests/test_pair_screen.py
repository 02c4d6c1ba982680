"""Pair-batched DP screen (heterogeneous query+target) vs the exact
oracle, and the device paths of PairwiseAlignSequences/AlignToReference
vs their host-only runs (VERDICT r1 item 6 / SURVEY.md §7 step 4)."""

import numpy as np
import pytest

from tests.test_engine_differential import table_without_timestamp

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import encode_query, encode_target, revcomp
from calitas_tpu.align.oracle import dp_matrix
from calitas_tpu.ops.pair_screen import PairScreen, pass_bounds_for

RNG = np.random.default_rng(77)
BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_seq(n, with_n=False):
    pool = BASES if with_n else BASES[:4]
    return RNG.choice(pool, size=n).tobytes().decode()


@pytest.fixture(scope="module")
def scorer():
    return derive_scorer()


class TestPairKernel:
    def test_chain_maxima_match_oracle(self, scorer):
        """Every pair has its own query AND target; both chains must be
        the oracle's final-row maxima exactly."""
        screen = PairScreen(scorer)
        queries, targets = [], []
        for Q, T in [(18, 50), (18, 70), (20, 64), (20, 200), (23, 90)]:
            q = random_seq(Q)
            t = random_seq(T, with_n=True)
            queries.append(q)
            targets.append(t)
        # plant a perfect hit for one pair
        queries.append("CTTGCCCCACAGGGCAGTAA")
        targets.append(random_seq(30) + "CTTGCCCCACAGGGCAGTAA" + random_seq(30))
        a, b = screen.chain_maxima(queries, targets)
        for i, (q, t) in enumerate(zip(queries, targets)):
            qm = encode_query(q)
            S = dp_matrix(qm, encode_target(t), scorer)
            assert a[i] == S[len(q), 1:].max(), (i, "chain A")
            S2 = dp_matrix(
                encode_query(revcomp(q)), encode_target(t), scorer
            )
            assert b[i] == S2[len(q), 1:].max(), (i, "chain B")
        assert a[-1] == scorer.match_score * 20

    def test_chain_b_equals_revcomp_target(self, scorer):
        """Chain B is score-equivalent to DP(query, revcomp(target)) —
        the engine's other strand pass."""
        screen = PairScreen(scorer)
        q = random_seq(20)
        t = random_seq(80)
        _, b = screen.chain_maxima([q], [t])
        S = dp_matrix(encode_query(q), encode_target(revcomp(t)), scorer)
        assert b[0] == S[20, 1:].max()

    def test_unscreenable_pairs_marked(self, scorer):
        screen = PairScreen(scorer)
        a, b = screen.chain_maxima(
            ["", "ACGT"], ["ACGTACGT", "T" * (PairScreen.MAX_SLOT + 1)]
        )
        assert a[0] == PairScreen.NO_SCREEN and b[0] == PairScreen.NO_SCREEN
        assert a[1] == PairScreen.NO_SCREEN and b[1] == PairScreen.NO_SCREEN

    def test_pass_bounds_mapping(self):
        from calitas_tpu.core.guide import Guide

        g3 = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
        assert pass_bounds_for(g3, 10, 20) == {"fwd": 10, "rev": 20}
        g5 = Guide.parse("tttvCTTGCCCCACAGGGCAGTAA")
        assert pass_bounds_for(g5, 10, 20) == {"rev": 10, "fwd": 20}


def _random_guide_query(rng, five_prime=False):
    proto = "".join(rng.choice(list("ACGT"), int(rng.integers(18, 23))))
    return ("tttv" + proto) if five_prime else (proto + "nrg")


class TestPairwiseDeviceParity:
    def test_tpu_engine_byte_identical(self, tmp_path):
        """engine=device (pair screen + exact rev-skip) must write the exact
        bytes of the host-only run, including competitive-rev pairs."""
        from calitas_tpu.tools import pairwise

        rng = np.random.default_rng(5)
        lines = []
        for i in range(40):
            five = i % 3 == 0
            q = _random_guide_query(rng, five)
            proto = q[4:] if five else q[:-3]
            t = random_seq(12) + proto + random_seq(12)
            if i % 4 == 1:
                t = random_seq(10) + revcomp(proto) + random_seq(10)
            if i % 5 == 2:  # both strands competitive: embed both
                t = proto + random_seq(6) + revcomp(proto)
            lines.append(f"{q} {t}")
        # mutate some targets
        inp = tmp_path / "pairs.txt"
        inp.write_text("\n".join(lines) + "\n")

        host = tmp_path / "host.txt"
        dev = tmp_path / "dev.txt"
        pairwise.run(input=inp, output=host, threads=2, engine="host")
        pairwise.run(input=inp, output=dev, threads=2, engine="device")
        assert dev.read_bytes() == host.read_bytes()
        assert len(host.read_text().splitlines()) == 41


class TestA2RDeviceParity:
    @pytest.fixture()
    def ref(self, tmp_path):
        from calitas_tpu.io.fasta import ReferenceSetBuilder

        rng = np.random.default_rng(9)
        b = ReferenceSetBuilder(assembly="a2r")
        seq = list("".join(rng.choice(list("ACGT"), 20_000)))
        self.sites = []
        for k in range(12):
            pos = 1000 + k * 1500
            proto = "".join(rng.choice(list("ACGT"), 20))
            site = list(proto)
            for _ in range(int(rng.integers(0, 3))):
                i = int(rng.integers(0, 20))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            s = "".join(site) + "TGG"
            if k % 2:
                s = revcomp(s)
            seq[pos : pos + len(s)] = list(s)
            self.sites.append((proto + "nrg", pos + 1))
        b.add("chr1").add("".join(seq))
        return b.to_file(tmp_path / "ref.fa")

    def _input(self, tmp_path, shifts=(0,)):
        rows = ["id\tquery\tchrom\tposition"]
        for i, (q, pos) in enumerate(self.sites):
            rows.append(f"s{i}\t{q}\tchr1\t{pos + shifts[i % len(shifts)]}")
        p = tmp_path / "loci.txt"
        p.write_text("\n".join(rows) + "\n")
        return p

    def test_best_mode_byte_identical(self, tmp_path, ref):
        from calitas_tpu.tools import align_to_reference

        inp = self._input(tmp_path)
        host = tmp_path / "host.txt"
        dev = tmp_path / "dev.txt"
        kw = dict(input=inp, ref=ref, threads=2)
        align_to_reference.run(output=host, engine="host", **kw)
        align_to_reference.run(output=dev, engine="device", **kw)
        assert table_without_timestamp(dev) == table_without_timestamp(host)
        assert len(host.read_text().splitlines()) == 13

    def test_all_hits_mode_byte_identical(self, tmp_path, ref):
        from calitas_tpu.tools import align_to_reference

        # shift half the positions so their windows hold no qualifying
        # hit (the device screen must skip exactly those)
        inp = self._input(tmp_path, shifts=(100, 400))
        host = tmp_path / "host.txt"
        dev = tmp_path / "dev.txt"
        kw = dict(
            input=inp, ref=ref, threads=2, window_size=500,
            max_guide_diffs=3, max_pam_mismatches=1, max_overlap=5,
        )
        align_to_reference.run(output=host, engine="host", **kw)
        align_to_reference.run(output=dev, engine="device", **kw)
        assert table_without_timestamp(dev) == table_without_timestamp(host)
        assert len(host.read_text().splitlines()) > 1


class TestPairRanges:
    """chain_maxima_ranges must bound, per pair per chain, every end
    column whose final-row DP score reaches that pair's threshold — the
    device side of A2R's sliced native finish."""

    def test_ranges_bound_qualifying_columns(self, scorer):
        screen = PairScreen(scorer)
        queries, targets, min_scores = [], [], []
        planted = "CTTGCCCCACAGGGCAGTAA"
        for T in (50, 90, 200, 300):
            queries.append(planted)
            targets.append(
                random_seq(T // 3) + planted + random_seq(T - T // 3)
            )
            # a 2-diff budget: hits qualify, random background doesn't
            min_scores.append(scorer.match_score * len(planted) - 2 * 122)
        # one pair with no qualifying columns at all
        queries.append(planted)
        targets.append(random_seq(60))
        min_scores.append(scorer.match_score * len(planted))
        # and one unscreenable pair (target beyond MAX_SLOT)
        queries.append(planted)
        targets.append(random_seq(PairScreen.MAX_SLOT + 1))
        min_scores.append(0)
        a, b, ranges = screen.chain_maxima_ranges(queries, targets, min_scores)
        assert ranges is not None and ranges.shape == (len(queries), 4)
        assert tuple(ranges[-1]) == (-1, -1, -1, -1)  # unscreenable
        for i in range(len(queries) - 1):
            qual_by_chain = []
            for c, q in enumerate((queries[i], revcomp(queries[i]))):
                S = dp_matrix(encode_query(q), encode_target(targets[i]), scorer)
                final = S[len(q), 1:]
                qual = np.nonzero(final >= min_scores[i])[0] + 1  # 1-based
                qual_by_chain.append(qual)
                lo, hi = int(ranges[i, 2 * c]), int(ranges[i, 2 * c + 1])
                if len(qual):
                    assert lo == qual.min() and hi == qual.max(), (i, c)
                else:
                    assert lo > hi, (i, c)  # the empty range
            if i < 4:
                assert len(qual_by_chain[0]), f"pair {i}: planted hit missed"

    def test_maxima_unchanged_by_ranges(self, scorer):
        screen = PairScreen(scorer)
        queries = [random_seq(20) for _ in range(5)]
        targets = [random_seq(70, with_n=True) for _ in range(5)]
        a0, b0 = screen.chain_maxima(queries, targets)
        a1, b1, _ = screen.chain_maxima_ranges(queries, targets, [0] * 5)
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)


class TestA2RSlicedFinish:
    """All-hits A2R through the device screen now carries end-column
    ranges into the sliced native finish; output must stay byte-identical
    to the host engine, including on indel-mutated sites (the chain-B
    span widening edge)."""

    @pytest.mark.parametrize("seed", [11, 12])
    def test_all_hits_sliced_identical(self, tmp_path, seed):
        from calitas_tpu.io.fasta import ReferenceSetBuilder
        from calitas_tpu.tools import align_to_reference

        rng = np.random.default_rng(seed)
        proto = "".join(rng.choice(list("ACGT"), 20))
        guide = proto + "nrg"
        genome = list("".join(rng.choice(list("ACGT"), 40_000)))
        loci = []
        for k in range(12):
            pos = 1500 + k * 3000
            site = list(proto)
            r = rng.random()
            if r < 0.4:  # substitutions
                for _ in range(int(rng.integers(0, 4))):
                    j = int(rng.integers(0, len(site)))
                    site[j] = rng.choice([c for c in "ACGT" if c != site[j]])
            elif r < 0.7:  # deletion (guide bulge)
                j = int(rng.integers(2, len(site) - 2))
                del site[j]
            else:  # insertion (genome bulge)
                j = int(rng.integers(2, len(site) - 2))
                site.insert(j, str(rng.choice(list("ACGT"))))
            seq = "".join(site) + str(rng.choice(["TGG", "AAG", "CGG"]))
            if rng.random() < 0.5:
                from calitas_tpu.core.sequence import revcomp as rc

                seq = rc(seq)
            genome[pos : pos + len(seq)] = list(seq)
            loci.append(pos + 10)
        b = ReferenceSetBuilder(assembly=f"a2rslice{seed}")
        b.add("chr1").add("".join(genome))
        ref = b.to_file(tmp_path / "ref.fa")
        inp = tmp_path / "in.txt"
        with open(inp, "w") as fh:
            fh.write("id\tquery\tchrom\tposition\n")
            for k, pos in enumerate(loci):
                fh.write(f"t{k}\t{guide}\tchr1\t{pos}\n")
        out_h = tmp_path / "host.txt"
        out_t = tmp_path / "device.txt"
        kw = dict(max_guide_diffs=4, max_pam_mismatches=1, max_overlap=10,
                  threads=2)
        align_to_reference.run(input=inp, ref=ref, output=out_h,
                               engine="host", **kw)
        align_to_reference.run(input=inp, ref=ref, output=out_t,
                               engine="device", **kw)
        rows_h = table_without_timestamp(out_h)
        rows_t = table_without_timestamp(out_t)
        assert rows_h == rows_t
        assert len(rows_h) >= 6, "fixture should produce plenty of hits"
