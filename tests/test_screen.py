"""Device DP screen vs exact oracle: the kernel parity contract.

The screen must compute, bit-exactly, the final DP row the oracle
computes — no false negatives, no false positives at the score level."""

import numpy as np
import pytest

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import encode_query, encode_target
from calitas_tpu.align.oracle import dp_matrix
from calitas_tpu.ops.dp_screen import ScreenKernel

RNG = np.random.default_rng(42)
BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def random_seq(n, with_n=False):
    pool = BASES if with_n else BASES[:4]
    return RNG.choice(pool, size=n).tobytes().decode()


@pytest.fixture(scope="module")
def scorer():
    return derive_scorer()


class TestScreenEquivalence:
    def test_final_rows_match_oracle(self, scorer):
        Q, T, B = 20, 64, 8
        query = random_seq(Q)
        qmask = encode_query(query)
        targets = [random_seq(T, with_n=True) for _ in range(B)]
        tmasks = np.stack([encode_target(t) for t in targets])
        kernel = ScreenKernel(scorer)
        rows = kernel.final_rows(qmask, tmasks)
        for b, t in enumerate(targets):
            S = dp_matrix(qmask, encode_target(t), scorer)
            np.testing.assert_array_equal(rows[b], S[Q, 1:])

    def test_max_scores_with_planted_hit(self, scorer):
        query = "CTTGCCCCACAGGGCAGTAA"
        qmask = encode_query(query)
        clean = random_seq(100)
        planted = clean[:40] + query + clean[60:]
        tmasks = np.stack([encode_target(clean), encode_target(planted)])
        lengths = np.array([100, 100], dtype=np.int32)
        kernel = ScreenKernel(scorer)
        best = kernel.max_scores(qmask, tmasks, lengths)
        perfect = scorer.match_score * len(query)
        assert best[1] == perfect
        assert best[0] < perfect

    def test_length_masking(self, scorer):
        # End columns beyond the window length must not contribute.
        query = "ACGTACGTAC"
        qmask = encode_query(query)
        t = "TTTTTTTTTT" + query  # hit only at the very end
        tmask = encode_target(t)
        padded = np.zeros((1, 32), dtype=np.uint8)
        padded[0, : len(t)] = tmask
        kernel = ScreenKernel(scorer)
        full = kernel.max_scores(qmask, padded, np.array([len(t)], np.int32))
        cut = kernel.max_scores(qmask, padded, np.array([10], np.int32))
        assert full[0] == scorer.match_score * len(query)
        assert cut[0] < full[0]

    def test_random_fuzz_vs_oracle(self, scorer):
        kernel = ScreenKernel(scorer)
        for trial in range(10):
            Q = int(RNG.integers(8, 30))
            T = int(RNG.integers(Q, 120))
            query = random_seq(Q)
            target = random_seq(T, with_n=True)
            qmask = encode_query(query)
            tmask = encode_target(target)
            S = dp_matrix(qmask, tmask, scorer)
            padded = np.zeros((1, 128), dtype=np.uint8)
            padded[0, :T] = tmask
            best = kernel.max_scores(qmask, padded, np.array([T], np.int32))
            assert best[0] == S[Q, 1:].max()


def brute_gated_row(qmask, raw, scorer, gate):
    """S[Q, 1..T] of the glocal DP over annotated bytes ``raw`` (low 4
    bits = target mask) with the kernel's PAM gate: ``"end"`` lets only
    columns with bit 4 end an alignment, ``"start"`` closes row 0 at
    columns without bit 5 (column 0 stays open)."""
    from calitas_tpu.ops.dp_kernel import NEG_GATE, NEG_INF

    m, mm = scorer.match_score, scorer.mismatch_score
    qg, tg = scorer.query_gap_score, scorer.target_gap_score
    Q, T = len(qmask), len(raw)
    S = np.zeros((Q + 1, T + 1), np.int64)
    S[:, 0] = np.arange(Q + 1) * tg
    if gate == "start":
        S[0, 1:] = np.where(raw & 32, 0, NEG_GATE)
    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            pair = m if (qmask[i - 1] & raw[j - 1] & 15) else mm
            S[i, j] = max(S[i - 1, j - 1] + pair, S[i, j - 1] + qg,
                          S[i - 1, j] + tg)
    row = S[Q, 1:]
    if gate == "end":
        row = np.where(raw & 16, row, NEG_INF)
    return row


def _kernel_scores(scorer):
    s = scorer
    return dict(match=s.match_score, mismatch=s.mismatch_score,
                qgap=s.query_gap_score, tgap=s.target_gap_score)


def _kernel_run(scorer, qvals, wins, ms=None, **kw):
    """dp_kernel.screen_multi in the Pallas interpreter on host arrays."""
    import jax.numpy as jnp

    from calitas_tpu.ops import dp_kernel

    return dp_kernel.screen_multi(
        jnp.asarray(qvals), dp_kernel.pack_tcols(jnp.asarray(wins)),
        None if ms is None else jnp.asarray(ms), T=wins.shape[1],
        Q=qvals.shape[2], interpret=True, **_kernel_scores(scorer), **kw,
    )


class TestPallasKernelsInterpret:
    """The GPU kernel (ops/dp_kernel.py) in the Pallas interpreter (CPU
    coverage of its arithmetic).  Integer adds and maxima only — no
    matrix product, so no TF32 or reduction-order question arises:
    every comparison here is exact (tolerance 0)."""

    @pytest.mark.parametrize("Q", [1, 9, 23, 48])
    def test_v2_matches_oracle(self, scorer, Q):
        """Fuzz over query lengths up to the kernel's limit, both chains,
        against the NumPy oracle; T = 45 leaves a ragged last word."""
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.dp_kernel import BLOCK_W, MAX_Q

        assert Q <= MAX_Q
        rng = np.random.default_rng(Q)
        T, B = 45, BLOCK_W
        query = "".join(rng.choice(list("ACGT"), Q))
        qm = np.stack([encode_query(query), encode_query(revcomp(query))])
        wins = rng.integers(0, 16, size=(B, T), dtype=np.uint8)
        if Q <= T:
            wins[5, 3 : 3 + Q] = qm[0]
            wins[6, T - Q :] = qm[1]
        best = np.asarray(_kernel_run(scorer, qm[None].astype(np.int32), wins))
        for b in range(B):
            for c in range(2):
                S = dp_matrix(qm[c], wins[b], scorer)
                assert best[0, c, b] == S[Q, 1:].max(), (b, c)

    @pytest.mark.parametrize("pam_gate", [False, True])
    def test_kernel_ranges_match_gated_bruteforce(self, scorer, pam_gate):
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.dp_kernel import BLOCK_W

        rng = np.random.default_rng(4)
        Q, T, B = 10, 30, BLOCK_W
        query = "".join(rng.choice(list("ACGT"), Q))
        qm = np.stack([encode_query(query), encode_query(revcomp(query))])
        wins = rng.integers(0, 64, size=(B, T), dtype=np.uint8)
        ms = np.array([scorer.match_score * Q - 300], np.int32)
        best, ranges = (
            np.asarray(x)
            for x in _kernel_run(scorer, qm[None].astype(np.int32), wins, ms,
                               pam_gate=pam_gate, emit_ranges=True)
        )
        n_qual = 0
        for b in rng.choice(B, 48, replace=False):
            for c, gate in enumerate(("end", "start")):
                row = brute_gated_row(qm[c], wins[b], scorer,
                                      gate if pam_gate else None)
                assert best[0, c, b] == row.max()
                q = np.nonzero(row >= ms[0])[0] + 1
                want = (q.min(), q.max()) if len(q) else (T + 1, 0)
                assert tuple(ranges[0, c, :, b]) == want
                n_qual += bool(len(q))
        assert n_qual  # some windows qualify

    @pytest.mark.parametrize("pam_gate", [False, True])
    def test_dual_matches_two_singles(self, scorer, pam_gate):
        """Maxima and ranges of a 2-guide launch equal the gated XLA scan
        per guide and chain, bit for bit."""
        import jax.numpy as jnp

        from calitas_tpu.ops.dp_kernel import BLOCK_W
        from calitas_tpu.ops.dp_screen import _screen_scores_ranges

        rng = np.random.default_rng(8)
        Q, T, B, G = 12, 40, 2 * BLOCK_W, 2
        qvals = rng.integers(1, 16, size=(G, 2, Q)).astype(np.int32)
        wins = rng.integers(0, 64, size=(B, T), dtype=np.uint8)
        ms = np.array([200, 450], np.int32)
        best, ranges = (
            np.asarray(x)
            for x in _kernel_run(scorer, qvals, wins, ms, pam_gate=pam_gate,
                               emit_ranges=True)
        )
        lengths = jnp.full((B,), T, jnp.int32)
        for g in range(G):
            for c, gate in enumerate(("end", "start")):
                b, mn, mx = _screen_scores_ranges(
                    jnp.asarray(qvals[g, c].astype(np.uint8)),
                    jnp.asarray(wins), lengths, int(ms[g]),
                    gate=gate if pam_gate else None, **_kernel_scores(scorer)
                )
                np.testing.assert_array_equal(best[g, c], np.asarray(b))
                np.testing.assert_array_equal(ranges[g, c, 0], np.asarray(mn))
                np.testing.assert_array_equal(ranges[g, c, 1], np.asarray(mx))


class TestMultiKernelPerChain:
    def test_multi_matches_dual_per_guide(self, scorer):
        """A G-guide launch equals G one-guide launches (interpret mode)."""
        from calitas_tpu.ops.dp_kernel import BLOCK_W

        rng = np.random.default_rng(9)
        Q, T, G = 8, 24, 3
        qvals = rng.integers(1, 16, size=(G, 2, Q)).astype(np.int32)
        wins = rng.integers(0, 64, size=(BLOCK_W, T), dtype=np.uint8)
        multi = np.asarray(_kernel_run(scorer, qvals, wins, pam_gate=True))
        for g in range(G):
            one = np.asarray(
                _kernel_run(scorer, qvals[g : g + 1], wins, pam_gate=True)
            )
            np.testing.assert_array_equal(multi[g], one[0])


@pytest.mark.gpu
@pytest.mark.parametrize("pam_gate", [False, True])
def test_compiled_kernel_matches_xla_scan(gpu, scorer, pam_gate):
    """The kernel as compiled for the card (no interpreter) against the
    XLA scan, exactly."""
    import jax
    import jax.numpy as jnp

    from calitas_tpu.ops import dp_kernel
    from calitas_tpu.ops.genome_screen import _xla_screen_multi

    rng = np.random.default_rng(12)
    Q, T, B, G = 23, 1000, 4 * dp_kernel.BLOCK_W, 2
    with jax.default_device(gpu):
        qvals = jnp.asarray(rng.integers(1, 16, size=(G, 2, Q)).astype(np.int32))
        wins = jnp.asarray(rng.integers(0, 64, size=(B, T), dtype=np.uint8))
        ms = jnp.asarray(np.array([700, 900], np.int32))
        got = dp_kernel.screen_multi(
            qvals, dp_kernel.pack_tcols(wins), ms, T=T, Q=Q,
            pam_gate=pam_gate, emit_ranges=True, **_kernel_scores(scorer))
        want = _xla_screen_multi(
            qvals, wins, jnp.full((B,), T, jnp.int32), ms, G=G,
            pam_gate=pam_gate, emit_ranges=True, **_kernel_scores(scorer))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestKernelWrapper:
    """What surrounds the kernel: the packed layout, batch padding and
    the choice between kernel and XLA scan."""

    @pytest.mark.parametrize("T", [4, 37, 1000])
    def test_pack_tcols_layout(self, T):
        import jax.numpy as jnp

        from calitas_tpu.ops.dp_kernel import pack_tcols

        rng = np.random.default_rng(T)
        wins = rng.integers(0, 64, size=(16, T), dtype=np.uint8)
        words = np.asarray(pack_tcols(jnp.asarray(wins)))
        assert words.shape == (-(-T // 4), 16) and words.dtype == np.int32
        # byte b of word w is column 4w+b; the ragged tail is zero
        cols = words.T.copy().view(np.uint8).reshape(16, -1)
        np.testing.assert_array_equal(cols[:, :T], wins)
        assert not cols[:, T:].any()

    def test_kernel_requires_whole_blocks(self, scorer):
        import jax.numpy as jnp

        from calitas_tpu.ops import dp_kernel

        wins = jnp.zeros((dp_kernel.BLOCK_W + 8, 16), jnp.uint8)
        with pytest.raises(ValueError):
            dp_kernel.screen_multi(
                jnp.ones((1, 2, 4), jnp.int32), dp_kernel.pack_tcols(wins),
                T=16, Q=4, interpret=True, **_kernel_scores(scorer),
            )

    def test_kernel_for_routes_long_guides_to_xla(self, caplog):
        import logging

        from calitas_tpu.ops import genome_screen
        from calitas_tpu.ops.dp_kernel import MAX_Q

        genome_screen._LONG_GUIDES_LOGGED.discard(MAX_Q + 1)
        assert genome_screen.kernel_for(True, MAX_Q)
        assert not genome_screen.kernel_for(False, 20)
        with caplog.at_level(logging.WARNING, "calitas_tpu.screen"):
            assert not genome_screen.kernel_for(True, MAX_Q + 1)
            assert not genome_screen.kernel_for(True, MAX_Q + 1)
        assert len([r for r in caplog.records if "XLA scan" in r.message]) == 1

    def test_default_engine_follows_platform(self, scorer, monkeypatch):
        from calitas_tpu.ops import genome_screen

        for platform, want in (("gpu", True), ("cpu", False)):
            monkeypatch.setattr(
                genome_screen, "default_device_platform", lambda p=platform: p
            )
            assert genome_screen.GenomeScreen(scorer).use_kernel is want

    def test_long_guide_screens_on_xla_scan(self, scorer):
        """A kernel-enabled screen given a guide past the kernel limit
        returns the XLA screen's flags (no kernel launch)."""
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.dp_kernel import MAX_Q
        from calitas_tpu.ops.genome_screen import GenomeScreen

        rng = np.random.default_rng(10)
        q = "".join(rng.choice(list("ACGT"), MAX_Q + 2))
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
        bases[1000 : 1000 + len(q)] = np.frombuffer(q.encode(), np.uint8)
        out = []
        for use_kernel in (True, False):
            screen = GenomeScreen(scorer, window=256, use_kernel=use_kernel,
                                  interpret=True)
            out.append(screen.screen_contig(
                screen.stage(bases), len(bases), 180, q, revcomp(q),
                60 * len(q) - 300, return_ranges=True,
            ))
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])
        assert out[0][0].any()


class TestPamGate:
    """The PAM prefilter must be a conservative superset of true hit
    windows, and strictly reduce candidates for strict PAMs."""

    def _flags(self, contig, guide_obj, scorer, pam_spec, interpret=True):
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen

        bases = np.frombuffer(contig.encode(), dtype=np.uint8)
        screen = GenomeScreen(
            scorer, window=256, batch_windows=1024, use_kernel=True,
            interpret=interpret,
        )
        g = screen.stage(bases)
        dp_query = (
            guide_obj.guide_rc if guide_obj.pam_is_5prime else guide_obj.guide_fw
        )
        return screen.screen_contig(
            g, len(bases), 230, dp_query, revcomp(dp_query),
            60 * len(dp_query) - 5 * 122, pam_spec=pam_spec,
        )

    def test_gated_flags_cover_all_hit_windows(self):
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.align.engine import SequentialAligner
        from calitas_tpu.ops.genome_screen import GenomeScreen
        from calitas_tpu.search.windows import materialize_window

        rng = np.random.default_rng(31)
        al = SequentialAligner()
        guide = Guide.parse("CTTGCCCCACAGGGCAGTAAngg")
        contig = list("".join(rng.choice(list("ACGT"), 30_000)))
        # plant sites with varying PAMs / strands / mismatches
        for i in range(12):
            pos = 500 + i * 2300
            site = list("CTTGCCCCACAGGGCAGTAA")
            for _ in range(i % 4):
                site[int(rng.integers(0, 20))] = rng.choice(list("ACGT"))
            seq = "".join(site) + ["TGG", "AGG", "TAG", "CGG"][i % 4]
            if i % 2:
                seq = revcomp(seq)
            contig[pos : pos + len(seq)] = list(seq)
        contig = "".join(contig)

        pam_spec = (("ngg",), 1, 3)
        gated = self._flags(contig, guide, al.scorer, pam_spec)
        ungated = self._flags(contig, guide, al.scorer, None)

        # conservative: gated never flags what ungated doesn't
        assert not np.any(gated & ~ungated)
        # and it must cover every window that actually produces output
        bases = np.frombuffer(contig.encode(), dtype=np.uint8)
        starts = np.arange(0, len(bases) - 1, 230)
        kw = dict(max_guide_diffs=5, max_gaps_between_guide_and_pam=3,
                  max_pam_diffs=1, max_total_diffs=9, max_overlap=10)
        n_hit_windows = 0
        for i, st in enumerate(starts):
            w = materialize_window("c", bases, int(st), 256)
            if len(w.bases) < len("CTTGCCCCACAGGGCAGTAAngg"):
                continue
            res = al.align(guide, w.bases, target_name="c",
                           target_offset=w.start - 1, **kw)
            if res:
                n_hit_windows += 1
                assert gated[i], f"window {i} has hits but was gated out"
        assert n_hit_windows >= 6
        # the gate should prune some candidates on random sequence
        assert gated.sum() <= ungated.sum()

    def test_gate_covers_five_prime_pam_hits(self):
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.align.engine import SequentialAligner
        from calitas_tpu.search.windows import materialize_window

        rng = np.random.default_rng(5)
        al = SequentialAligner()
        proto = "GACCAACATGATGAAACTCT"
        guide = Guide.parse("tttv" + proto)
        contig = list("".join(rng.choice(list("ACGT"), 12_000)))
        for i in range(6):
            pos = 400 + i * 1800
            seq = "TTTG" + proto
            if i % 2:
                seq = revcomp(seq)
            contig[pos : pos + len(seq)] = list(seq)
        contig = "".join(contig)
        bases = np.frombuffer(contig.encode(), dtype=np.uint8)

        pam_spec = (tuple(guide.pams_rc), 1, 3)
        gated = self._flags(contig, guide, al.scorer, pam_spec)
        starts = np.arange(0, len(bases) - 1, 230)
        kw = dict(max_guide_diffs=5, max_gaps_between_guide_and_pam=3,
                  max_pam_diffs=1, max_total_diffs=9, max_overlap=10)
        n_hits = 0
        for i, st in enumerate(starts):
            w = materialize_window("c", bases, int(st), 256)
            if len(w.bases) < guide.length:
                continue
            if al.align(guide, w.bases, target_name="c",
                        target_offset=w.start - 1, **kw):
                n_hits += 1
                assert gated[i]
        assert n_hits >= 4


class TestFlagBitPacking:
    """The screen's D2H contract: device-side bit-packed flags must round
    trip exactly through the host unpack."""

    def test_roundtrip_random(self):
        import jax.numpy as jnp

        from calitas_tpu.ops.genome_screen import (
            _pack_flag_bits,
            _unpack_flag_bits,
        )

        rng = np.random.default_rng(3)
        for shape in [(2, 128), (2, 8192), (4, 2, 1024), (1, 8)]:
            flags = rng.random(shape) < 0.07
            packed = np.asarray(_pack_flag_bits(jnp.asarray(flags)))
            assert packed.shape == (*shape[:-1], shape[-1] // 8)
            out = _unpack_flag_bits(packed, shape[-1])
            assert out.dtype == bool
            np.testing.assert_array_equal(out, flags)

    def test_unpack_trims_padding(self):
        import jax.numpy as jnp

        from calitas_tpu.ops.genome_screen import (
            _pack_flag_bits,
            _unpack_flag_bits,
        )

        flags = np.zeros((2, 16), bool)
        flags[:, 15] = True  # only in the padded tail
        packed = np.asarray(_pack_flag_bits(jnp.asarray(flags)))
        out = _unpack_flag_bits(packed, 10)
        assert out.shape == (2, 10)
        assert not out.any()


class TestDeviceEncoding:
    def test_encode_staged_matches_host_table_all_bytes(self):
        """The device-side arithmetic IUPAC encoder must agree with the
        host 256-entry table (core/sequence.py:50-57) on every byte value
        (zero pad bytes therefore encode to mask 0)."""
        import jax.numpy as jnp

        from calitas_tpu.core.sequence import TARGET_MASK_TABLE
        from calitas_tpu.ops.genome_screen import _encode_staged

        raw = np.arange(256, dtype=np.uint8)
        out = np.asarray(_encode_staged(jnp.asarray(raw)))
        np.testing.assert_array_equal(out, TARGET_MASK_TABLE)
        assert TARGET_MASK_TABLE[0] == 0

    def test_encode_staged_chunked_path(self):
        """Inputs above the per-step chunk run through the fori_loop body;
        the result must still equal the host table everywhere."""
        import jax.numpy as jnp

        from calitas_tpu.core.sequence import TARGET_MASK_TABLE
        from calitas_tpu.ops.genome_screen import _ENCODE_CHUNK, _encode_staged

        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, 2 * _ENCODE_CHUNK, dtype=np.uint8)
        out = np.asarray(_encode_staged(jnp.asarray(raw)))
        np.testing.assert_array_equal(out, TARGET_MASK_TABLE[raw])


class TestMultiBatchScreen:
    def test_flags_identical_across_batch_sizes(self):
        """The packed-flag batch offsets must agree between a single-batch
        and a many-batch screen of the same genome (XLA path, CPU)."""
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen

        rng = np.random.default_rng(17)
        scorer = derive_scorer()
        bases = rng.choice(
            np.frombuffer(b"ACGT", np.uint8), 60_000
        ).astype(np.uint8)
        guide = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
        q = guide.guide_fw
        min_score = 60 * len(q) - 5 * 122
        flags = {}
        for bw in (128, 8192):  # 60k/step=100 -> 600 windows: 5 batches vs 1
            screen = GenomeScreen(
                scorer, window=200, batch_windows=bw, use_kernel=False
            )
            g = screen.stage(bases)
            flags[bw] = screen.screen_contig(
                g, len(bases), 100, q, revcomp(q), min_score,
                return_chains=True,
            )
        np.testing.assert_array_equal(flags[128], flags[8192])
        assert flags[128].any()  # non-degenerate


class TestSegmentedScreen:
    """screen_contig_async must partition the window grid into spans
    whose flags/ranges concatenate to exactly one screen_contig call."""

    def test_segments_equal_single_span(self):
        import numpy as np

        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.scoring import derive_scorer
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen

        rng = np.random.default_rng(41)
        guide = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
        dpq = guide.guide_fw
        bases = rng.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 300_000
        ).astype(np.uint8)
        # plant some hits
        planted = np.frombuffer(b"CTTGCCCCACAGGGCAGTAATGG", dtype=np.uint8)
        for pos in (5_000, 123_456, 250_101):
            bases[pos : pos + len(planted)] = planted
        scorer = derive_scorer()
        screen = GenomeScreen(
            scorer, window=256, batch_windows=512, use_kernel=False
        )
        g = screen.stage(bases)
        min_score = 60 * len(dpq) - 5 * 122
        pam_spec = (tuple(guide.pams_fw), 1, 3)
        flags1, ranges1 = screen.screen_contig(
            g, len(bases), 230, dpq, revcomp(dpq), min_score,
            pam_spec=pam_spec, return_ranges=True,
        )
        for segments in (1, 3, 7):
            segs = screen.screen_contig_async(
                g, len(bases), 230, dpq, revcomp(dpq), min_score,
                pam_spec=pam_spec, segments=segments,
            )
            parts_f, parts_r = [], []
            n_total = 0
            for i0, n_seg, resolve in segs:
                assert i0 == n_total
                cf, cr = resolve()
                assert cf.shape[1] == n_seg and cr.shape[1] == n_seg
                parts_f.append(cf)
                parts_r.append(cr)
                n_total += n_seg
            flags2 = np.concatenate(parts_f, axis=1)
            ranges2 = np.concatenate(parts_r, axis=1)
            assert flags2.shape == flags1.shape
            assert np.array_equal(flags2, flags1)
            assert np.array_equal(ranges2, ranges1)
            assert flags1.any(), "no planted hit flagged"


class TestSlotFlagsMulti:
    """The fused variant/pair slot screen: one dispatch per same-length
    guide group, device-thresholded bit-packed flags."""

    def _random_batch(self, rng, B, T):
        tmasks = np.zeros((B, T), np.uint8)
        lengths = rng.integers(8, T + 1, size=B).astype(np.int32)
        for i in range(B):
            seq = random_seq(int(lengths[i]), with_n=True)
            tmasks[i, : lengths[i]] = encode_target(seq)
        return tmasks, lengths

    def test_xla_flags_match_per_guide_max_scores(self, scorer):
        from calitas_tpu.ops.genome_screen import screen_slots_multi

        rng = np.random.default_rng(11)
        B, T = 64, 96
        tmasks, lengths = self._random_batch(rng, B, T)
        queries = [random_seq(18), random_seq(18), random_seq(18)]
        qvals = np.stack(
            [
                np.stack([encode_query(q), encode_query(q[::-1])]).astype(
                    np.int32
                )
                for q in queries
            ]
        )
        # Thresholds spanning never/sometimes/always flagged.
        mins = np.array([10**9, 0, -(10**9)], np.int32)
        [resolver] = screen_slots_multi(
            scorer, tmasks, lengths, [(False, qvals, mins)]
        )
        flags = resolver()
        kernel = ScreenKernel(scorer)
        for g, q in enumerate(queries):
            bf = kernel.max_scores(encode_query(q), tmasks, lengths)
            br = kernel.max_scores(encode_query(q[::-1]), tmasks, lengths)
            expect = (bf >= mins[g]) | (br >= mins[g])
            np.testing.assert_array_equal(flags[g], expect)

    def test_mixed_length_groups_share_one_upload(self, scorer):
        from calitas_tpu.ops.genome_screen import screen_slots_multi

        rng = np.random.default_rng(12)
        B, T = 32, 80
        tmasks, lengths = self._random_batch(rng, B, T)
        q_a = random_seq(16)
        q_b = random_seq(24)
        groups = [
            (
                False,
                np.stack([encode_query(q), encode_query(q[::-1])])[None].astype(np.int32),
                np.array([0], np.int32),
            )
            for q in (q_a, q_b)
        ]
        r_a, r_b = screen_slots_multi(scorer, tmasks, lengths, groups)
        kernel = ScreenKernel(scorer)
        for q, resolver in ((q_a, r_a), (q_b, r_b)):
            fl = resolver()
            bf = kernel.max_scores(encode_query(q), tmasks, lengths)
            br = kernel.max_scores(encode_query(q[::-1]), tmasks, lengths)
            np.testing.assert_array_equal(fl[0], (bf >= 0) | (br >= 0))

    def test_pallas_interpret_flags_are_exact_superset(self, scorer):
        """The kernel path ignores slot lengths (padding only adds
        candidate end columns): flags must cover every length-honoring
        flag, and on full-length slots be exactly equal."""
        from calitas_tpu.ops.dp_kernel import BLOCK_W
        from calitas_tpu.ops.genome_screen import _slot_flags_multi, _unpack_flag_bits
        import jax.numpy as jnp

        rng = np.random.default_rng(13)
        B, T = BLOCK_W, 64
        tmasks, lengths = self._random_batch(rng, B, T)
        full = rng.random(B) < 0.5
        lengths[full] = T  # half the slots are full length
        queries = [random_seq(20), random_seq(20)]
        qvals = np.stack(
            [
                np.stack([encode_query(q), encode_query(q[::-1])]).astype(np.int32)
                for q in queries
            ]
        )
        mins = np.array([300, 600], np.int32)
        s = scorer
        kw = dict(
            Q=20, G=2, match=s.match_score, mismatch=s.mismatch_score,
            qgap=s.query_gap_score, tgap=s.target_gap_score,
        )
        packed = _slot_flags_multi(
            jnp.asarray(qvals), jnp.asarray(tmasks),
            jnp.asarray(lengths), jnp.asarray(mins),
            use_kernel=True, interpret=True, **kw
        )
        got = _unpack_flag_bits(np.asarray(packed), B)
        kernel = ScreenKernel(scorer)
        for g, q in enumerate(queries):
            bf = kernel.max_scores(encode_query(q), tmasks, lengths)
            br = kernel.max_scores(encode_query(q[::-1]), tmasks, lengths)
            exact = (bf >= mins[g]) | (br >= mins[g])
            assert (got[g] | exact == got[g]).all()  # no false negatives
            np.testing.assert_array_equal(got[g][full], exact[full])


class TestPackedStaging:
    """The link-adaptive staging transport: nibble-packed staging must
    produce the identical device mask array as raw-byte staging."""

    def test_packed_equals_raw_all_bytes(self, scorer):
        from calitas_tpu.ops.genome_screen import GenomeScreen

        rng = np.random.default_rng(21)
        # every byte value, both cases, Ns, plus random genome-ish tail
        bases = np.concatenate(
            [
                np.arange(256, dtype=np.uint8),
                np.frombuffer(b"acgtnACGTNryswkmbdhvRYSWKMBDHV", np.uint8),
                rng.choice(np.frombuffer(b"ACGTN", np.uint8), 4093),
            ]
        )
        raw = GenomeScreen(scorer, window=256, pack_staging=False)
        packed = GenomeScreen(scorer, window=256, pack_staging=True)
        np.testing.assert_array_equal(
            np.asarray(raw.stage(bases)), np.asarray(packed.stage(bases))
        )

    def test_odd_length_contig(self, scorer):
        from calitas_tpu.ops.genome_screen import GenomeScreen

        bases = np.frombuffer(b"ACGTNAC", np.uint8)  # odd length
        raw = GenomeScreen(scorer, window=64, pack_staging=False)
        packed = GenomeScreen(scorer, window=64, pack_staging=True)
        np.testing.assert_array_equal(
            np.asarray(raw.stage(bases)), np.asarray(packed.stage(bases))
        )

    def test_unpack_staged_chunked_path(self, scorer):
        import jax.numpy as jnp

        from calitas_tpu.ops.genome_screen import (
            _ENCODE_CHUNK,
            _unpack_staged,
        )

        rng = np.random.default_rng(22)
        n2 = 2 * _ENCODE_CHUNK  # forces the fori_loop branch
        packed = rng.integers(0, 256, n2, dtype=np.uint8)
        out = np.asarray(_unpack_staged(jnp.asarray(packed)))
        expect = np.empty(2 * n2, np.uint8)
        expect[0::2] = packed & 15
        expect[1::2] = packed >> 4
        np.testing.assert_array_equal(out, expect)


class TestMultiGuideFullContract:
    """screen_contig_multi_async must match each guide's own
    screen_contig_async bit-for-bit — flags AND coarse ranges, PAM gate
    included — on both the XLA path and the Pallas kernel (interpret).
    One contract, no weaker multi-guide fallback (VERDICT r2 item 3)."""

    def _setup(self):
        from calitas_tpu.core.guide import Guide

        rng = np.random.default_rng(77)
        bases = rng.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 200_000
        ).astype(np.uint8)
        guides = [
            Guide.parse("CTTGCCCCACAGGGCAGTAAnrg"),
            Guide.parse("ACGTACATGCTCGATACGACnrg"),
            Guide.parse("TTGACCAAGCAAAACAGACCnrg"),
        ]
        for g, pos in zip(guides, (5_000, 77_777, 150_101)):
            site = (g.guide + g.pams_3prime[0].replace("n", "a").replace(
                "r", "g").upper()).encode()
            planted = np.frombuffer(site, dtype=np.uint8)
            bases[pos : pos + len(planted)] = planted
        return bases, guides

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_multi_async_equals_per_guide_async(self, use_kernel):
        from calitas_tpu.core.scoring import derive_scorer
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen

        bases, guides = self._setup()
        scorer = derive_scorer()
        screen = GenomeScreen(
            scorer, window=256, batch_windows=1024, use_kernel=use_kernel,
            interpret=use_kernel,
        )
        gdev = screen.stage(bases)
        step = 230
        dqs = [(g.guide_fw, revcomp(g.guide_fw)) for g in guides]
        mss = [60 * len(g.guide_fw) - 5 * 122 for g in guides]
        pam_spec = (tuple(guides[0].pams_fw), 1, 3)

        segs = screen.screen_contig_multi_async(
            gdev, len(bases), step, dqs, mss, pam_spec=pam_spec,
        )
        parts_f, parts_r = [], []
        for _i0, n_seg, resolve in segs:
            cf, cr = resolve()
            assert cf.shape[0] == len(guides) and cf.shape[2] == n_seg
            parts_f.append(cf)
            parts_r.append(cr)
        multi_f = np.concatenate(parts_f, axis=2)
        multi_r = np.concatenate(parts_r, axis=2)

        hit_windows = 0
        for gi, g in enumerate(guides):
            single = screen.screen_contig_async(
                gdev, len(bases), step, dqs[gi][0], dqs[gi][1], mss[gi],
                pam_spec=pam_spec,
            )
            sf, sr = [], []
            for _i0, _n, resolve in single:
                cf, cr = resolve()
                sf.append(cf)
                sr.append(cr)
            sf = np.concatenate(sf, axis=1)
            sr = np.concatenate(sr, axis=1)
            np.testing.assert_array_equal(multi_f[gi], sf)
            np.testing.assert_array_equal(multi_r[gi], sr)
            hit_windows += int(sf.any(axis=0).sum())
        assert hit_windows >= len(guides)  # planted hits flagged


class TestWideWindowRanges:
    """Windows wider than 2048 keep end-column ranges with coarser blocks
    (range_block doubles so 256 uint8 blocks always cover the window) —
    the -w 4096 perf cliff of VERDICT r2 item 8, removed."""

    def test_range_block_widths(self):
        from calitas_tpu.ops.genome_screen import range_block

        assert range_block(256) == 8
        assert range_block(1024) == 8
        assert range_block(2048) == 8
        assert range_block(2049) == 16
        assert range_block(4096) == 16
        assert range_block(8192) == 32
        assert range_block(16384) == 64
        # no ceiling: blocks keep doubling, 256 cover any window
        assert range_block(32768) == 128
        assert range_block(65536) == 256
        for w in (2048, 16384, 32768, 1 << 20):
            assert w <= 256 * range_block(w)

    @pytest.mark.parametrize("window", [4096, 8192, 32768])
    def test_wide_ranges_bound_qualifying_columns(self, scorer, window):
        # 32768 exceeds the former RANGE_MAX_WINDOW=16384 ceiling: ranges
        # now scale to any -w (VERDICT r3 item 9).
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.sequence import TARGET_MASK_TABLE, revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen, range_block

        rng = np.random.default_rng(7)
        guide = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
        dpq = guide.guide_fw
        n_bases = max(30_000, window * 3 + window // 2)
        bases = rng.choice(BASES[:4], n_bases).astype(np.uint8)
        planted = np.frombuffer(b"CTTGCCCCACAGGGCAGTAATGG", dtype=np.uint8)
        for pos in (1_000, n_bases // 3, n_bases - n_bases // 4):
            bases[pos : pos + len(planted)] = planted
        step = window - 64
        screen = GenomeScreen(
            scorer, window=window, batch_windows=256, use_kernel=False
        )
        g = screen.stage(bases)
        min_score = 60 * len(dpq) - 2 * 122
        flags, ranges = screen.screen_contig(
            g, n_bases, step, dpq, revcomp(dpq), min_score,
            return_ranges=True,
        )
        rb = range_block(window)
        # Brute force: full final DP row per window/chain over the same
        # zero-padded mask stream the device screens.
        masks = np.zeros(n_bases + window, np.uint8)
        masks[:n_bases] = TARGET_MASK_TABLE[bases]
        kern = ScreenKernel(scorer)
        starts = screen.window_starts(n_bases, step)
        wins = np.stack([masks[s : s + window] for s in starts])
        any_hit = False
        for c, q in enumerate((dpq, revcomp(dpq))):
            rows = kern.final_rows(encode_query(q), wins)  # [n, window]
            for i in range(len(starts)):
                qual = np.nonzero(rows[i] >= min_score)[0] + 1  # 1-based
                assert flags[c, i] == bool(len(qual))
                if not len(qual):
                    continue
                any_hit = True
                lo = int(ranges[c, i, 0]) * rb + 1
                hi = (int(ranges[c, i, 1]) + 1) * rb
                assert lo <= qual.min() and qual.max() <= hi, (
                    f"chain {c} window {i}: columns {qual.min()}..{qual.max()}"
                    f" escape widened range {lo}..{hi}"
                )
                # the coarse range must also be tight to within one block
                assert qual.min() - lo < rb and hi - qual.max() < rb
        assert any_hit, "no planted hit qualified"

    def test_multi_async_wide_window_ranges(self, scorer):
        """The fused multi-guide screen uses the same scaled range blocks
        as the single-guide screen at wide windows (window 4096 ->
        16-column blocks) — flags and ranges equal per guide."""
        from calitas_tpu.core.guide import Guide
        from calitas_tpu.core.sequence import revcomp
        from calitas_tpu.ops.genome_screen import GenomeScreen

        rng = np.random.default_rng(77)
        bases = rng.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 200_000
        ).astype(np.uint8)
        guides = [
            Guide.parse("CTTGCCCCACAGGGCAGTAAnrg"),
            Guide.parse("ACGTACATGCTCGATACGACnrg"),
            Guide.parse("TTGACCAAGCAAAACAGACCnrg"),
        ]
        for g, pos in zip(guides, (5_000, 77_777, 150_101)):
            site = (g.guide + "AGG").encode()
            planted = np.frombuffer(site, dtype=np.uint8)
            bases[pos : pos + len(planted)] = planted
        screen = GenomeScreen(
            scorer, window=4096, batch_windows=256, use_kernel=False
        )
        gdev = screen.stage(bases)
        step = 4000
        dqs = [(g.guide_fw, revcomp(g.guide_fw)) for g in guides]
        mss = [60 * len(g.guide_fw) - 5 * 122 for g in guides]

        segs = screen.screen_contig_multi_async(
            gdev, len(bases), step, dqs, mss,
        )
        parts_f, parts_r = [], []
        for _i0, _n, resolve in segs:
            cf, cr = resolve()
            parts_f.append(cf)
            parts_r.append(cr)
        multi_f = np.concatenate(parts_f, axis=2)
        multi_r = np.concatenate(parts_r, axis=2)

        any_hits = 0
        for gi in range(len(guides)):
            sflags, sranges = screen.screen_contig(
                gdev, len(bases), step, dqs[gi][0], dqs[gi][1], mss[gi],
                return_ranges=True,
            )
            np.testing.assert_array_equal(multi_f[gi], sflags)
            np.testing.assert_array_equal(multi_r[gi], sranges)
            any_hits += int(sflags.any(axis=0).sum())
        assert any_hits >= len(guides)


class TestBatchWindowsFor:
    """Pins the _batch_windows_for contract (the round-3 regression):
    unit rounding, trim-to-n, and the BATCH_ELEM_BUDGET cap at wide
    windows (the -w 16384 OOM protection)."""

    def _screen(self, scorer, window, batch_windows=8192):
        from calitas_tpu.ops.genome_screen import GenomeScreen

        return GenomeScreen(scorer, window=window, batch_windows=batch_windows)

    def test_rounds_configured_batch_up_to_unit(self, scorer):
        s = self._screen(scorer, window=1024, batch_windows=8192)
        # huge n: the configured batch governs, rounded up to unit
        assert s._batch_windows_for(1_000_000, 128) == 8192
        s.batch_windows = 8000  # not a multiple of 384
        assert s._batch_windows_for(1_000_000, 384) == 8064  # ceil to unit

    def test_trims_to_window_count(self, scorer):
        s = self._screen(scorer, window=1024, batch_windows=8192)
        # n far below the batch: round n up to unit, don't inflate to 8192
        assert s._batch_windows_for(5, 128) == 128
        assert s._batch_windows_for(129, 128) == 256
        assert s._batch_windows_for(8192, 128) == 8192

    def test_budget_cap_at_wide_windows(self, scorer):
        from calitas_tpu.ops.genome_screen import GenomeScreen

        s = self._screen(scorer, window=16384, batch_windows=8192)
        bw = s._batch_windows_for(1_000_000, 128)
        # batch * window must fit the extraction budget (but >= unit)
        assert bw * s.window <= GenomeScreen.BATCH_ELEM_BUDGET
        assert bw == (GenomeScreen.BATCH_ELEM_BUDGET // 16384) // 128 * 128
        # default layout sits exactly at budget and is unchanged
        s2 = self._screen(scorer, window=1024, batch_windows=8192)
        assert s2._batch_windows_for(1_000_000, 128) == 8192

    def test_cap_never_below_unit(self, scorer):
        s = self._screen(scorer, window=1 << 24, batch_windows=8192)
        assert s._batch_windows_for(1_000_000, 128) == 128

    def test_result_is_unit_multiple(self, scorer):
        s = self._screen(scorer, window=2048, batch_windows=8192)
        for n in (1, 7, 127, 128, 999, 20_000):
            for unit in (8, 128, 384):
                bw = s._batch_windows_for(n, unit)
                assert bw % unit == 0 and bw >= unit


def window_pam_planes(wins, pam_spec):
    """Window-local PAM gate planes, the reference for the staged
    annotation.  pam_spec = (pams, max_pam_mm, max_gap) with pams a tuple
    of DP-orientation PAM mask tuples.  end_ok[:, j]: some PAM fits
    (<= max_pam_mm mismatches) at one of the gap offsets right after an
    alignment ending at column j; start_ok[:, j]: some revcomp'd PAM fits
    right before an alignment starting at column j+1.  Out-of-window
    bases count as mismatches."""
    from calitas_tpu.ops.genome_screen import _rc_mask

    pams, max_mm, max_gap = pam_spec
    bw, T = wins.shape
    pad = max_gap + max(len(p) for p in pams) + 2
    w = np.pad(wins, ((0, 0), (pad, pad)))
    end_ok = np.zeros((bw, T), bool)
    start_ok = np.zeros((bw, T), bool)
    for pam in pams:
        plen = len(pam)
        rc_pam = tuple(_rc_mask(m) for m in reversed(pam))
        for o in range(max_gap + 1):
            mm_e = np.zeros((bw, T), np.int32)
            mm_s = np.zeros((bw, T), np.int32)
            for k in range(plen):
                e0 = pad + 1 + o + k
                mm_e += (w[:, e0 : e0 + T] & pam[k]) == 0
                s0 = pad - o - plen + 1 + k
                mm_s += (w[:, s0 : s0 + T] & rc_pam[k]) == 0
            end_ok |= mm_e <= max_mm
            start_ok |= mm_s <= max_mm
    return end_ok.astype(np.uint8), start_ok.astype(np.uint8)


class TestAnnotateGenomePam:
    """annotate_genome_pam (staged PAM gates): per-position bits must be
    a conservative superset of the window-local planes (window edges
    relaxed), exactly equal away from window edges, and robust to
    ragged (non-power-of-two) array lengths."""

    def _spec(self):
        from calitas_tpu.core.sequence import encode_query

        pams = (tuple(int(m) for m in encode_query("nrg")),)
        return (pams, 1, 3)

    def test_matches_window_planes_away_from_edges(self):
        import jax.numpy as jnp

        from calitas_tpu.core.sequence import TARGET_MASK_TABLE
        from calitas_tpu.ops.genome_screen import annotate_genome_pam

        rng = np.random.default_rng(5)
        letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
        raw = letters[rng.integers(0, 5, size=4096)]
        masks = TARGET_MASK_TABLE[raw]
        spec = self._spec()
        anno = np.asarray(
            annotate_genome_pam(jnp.asarray(masks), pam_spec=spec)
        )
        assert ((anno & 15) == masks).all()

        # window-local planes over interior windows
        T = 256
        pad = 16  # PAM reach: edges within this margin may be relaxed
        for start in (0, 777, 2048, 4096 - T):
            wins = masks[start : start + T][None, :]
            end_ok, start_ok = (
                np.asarray(x) for x in window_pam_planes(wins, spec)
            )
            a_end = (anno[start : start + T] >> 4) & 1
            a_start = (anno[start : start + T] >> 5) & 1
            # superset everywhere
            assert not np.any(end_ok[0] & ~a_end)
            assert not np.any(start_ok[0] & ~a_start)
            # exact equality away from the window edges
            sl = slice(pad, T - pad)
            np.testing.assert_array_equal(a_end[sl], end_ok[0][sl])
            np.testing.assert_array_equal(a_start[sl], start_ok[0][sl])

    def test_ragged_length_tail_annotated(self):
        import jax.numpy as jnp

        from calitas_tpu.core.sequence import TARGET_MASK_TABLE
        from calitas_tpu.ops.genome_screen import annotate_genome_pam
        import calitas_tpu.ops.genome_screen as gs

        rng = np.random.default_rng(6)
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        spec = self._spec()
        # force multi-chunk + ragged tail with a tiny chunk size
        old = gs._ENCODE_CHUNK
        gs._ENCODE_CHUNK = 512
        try:
            raw = letters[rng.integers(0, 4, size=1500)]  # 2 chunks + 476
            masks = TARGET_MASK_TABLE[raw]
            got = np.asarray(
                annotate_genome_pam(jnp.asarray(masks), pam_spec=spec)
            )
        finally:
            gs._ENCODE_CHUNK = old
        # Reference: a zero-padded power-of-two array compiles as a
        # separate (single-chunk) program; its prefix must match
        # (the pad can only relax tail gates, and 'nrg' against mask-0
        # pad bases is always a mismatch, so it does not here).
        padded = np.zeros(2048, np.uint8)
        padded[:1500] = masks
        want = np.asarray(
            annotate_genome_pam(jnp.asarray(padded), pam_spec=spec)
        )[:1500]
        np.testing.assert_array_equal(got, want)
        assert got[1024:].any()  # the tail is annotated, not zeros
