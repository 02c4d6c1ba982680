"""Smoke test of SearchReference on a GPU, through the entry points a user calls.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --devices 4   # four GPUs: the mesh phase only

Phases (one process; any failure exits non-zero and prints no result):

1. Device report: JAX devices and version, the card's name and power
   limit.  Anything but a GPU platform is an error — nothing falls back
   to the CPU.
2. The DP screen kernel at real widths (window 1000, batch 8192, guide
   length 23 and the kernel's limit, 1 and 4 guides, PAM gate on and
   off) against the XLA scan (maxima, flags and ranges equal) and a
   sample of windows against the NumPy DP (equal).  Times per batch are
   printed as information.
3. SearchReference through the CLI (``--engine device``) at CALITAS
   defaults on a seeded synthetic genome of >= 1 Gb over 4 contigs (N
   runs, soft-masked lowercase, planted sites): every planted site is in
   the table, and on one 24 Mb contig the table equals ``--engine host``
   row for row (``time_stamp`` aside).
4. Variant pass: PrepareVcf on a seeded ~100k-record VCF for that contig,
   then ``SearchReference -v``; equal to the host engine.
5. Serve: a ResidentSearcher answers 3 requests with two guide lengths;
   each table equals a fresh CLI run.
6. AlignToReference ``--engine device`` on 10k loci equals ``--engine host``.
7. No degradation to the host happened, the native library is loaded,
   and this process is the only one on the card.

With ``--devices 4``: SearchReference (both passes) with
``mesh=make_mesh(4)`` against the one-device table, which must be
identical, after checking that each shard of the mesh screen lives on
its own card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
PROTO = GUIDE[:-3]
GUIDE_B = "GACGCATAAAGATGAGACGCGTnrg"  # a second length for Serve
#: CALITAS defaults (core/scoring.py Defaults): 5 guide diffs, 1 PAM
#: mismatch, 3 gaps between guide and PAM, -w 1000
DEFAULT_ARGS = ["-w", "1000", "-d", "5", "-p", "1", "-g", "3"]
#: contig sizes of the synthetic genome: 1.004 Gb over four contigs; the
#: last one carries the host-parity checks and the VCF
CONTIGS = (("chr1", 410_000_000), ("chr2", 330_000_000),
           ("chr3", 240_000_000), ("chr4", 24_000_000))
PARITY_CONTIG = "chr4"
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTacgtNn", "TGCAtgcaNn"))[::-1]


# ---------------------------------------------------------------------------
# 1. device report
# ---------------------------------------------------------------------------

def device_report(n_devices: int) -> dict:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"jax {jax.__version__}: {len(devs)} device(s), platform={d0.platform}, "
        f"kind={d0.device_kind}")
    if d0.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX reports {d0.platform!r}")
    if len(devs) < n_devices:
        raise SystemExit(f"--devices {n_devices} but JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# 2. kernel against the XLA scan and the NumPy DP
# ---------------------------------------------------------------------------

def numpy_gated_rows(qmask, raw, scorer, gate):
    """S[Q, 1..T] for each row of ``raw`` [n, T] (annotated bytes): the
    recurrence of ``align/oracle.py::dp_matrix`` column by column, with
    the kernel's PAM gate (``"end"``: only bit-4 columns end an
    alignment; ``"start"``: row 0 closed where bit 5 is clear)."""
    from calitas_tpu.ops.dp_kernel import NEG_GATE, NEG_INF

    n, T = raw.shape
    Q = len(qmask)
    m, mm = scorer.match_score, scorer.mismatch_score
    qg, tg = scorer.query_gap_score, scorer.target_gap_score
    col = np.tile(np.arange(Q + 1, dtype=np.int64) * tg, (n, 1))
    rows = np.empty((n, T), np.int64)
    for j in range(T):
        t = raw[:, j].astype(np.int64)
        new = np.empty_like(col)
        new[:, 0] = np.where(t & 32, 0, NEG_GATE) if gate == "start" else 0
        for i in range(1, Q + 1):
            pair = np.where(t & 15 & int(qmask[i - 1]), m, mm)
            new[:, i] = np.maximum(
                np.maximum(col[:, i - 1] + pair, col[:, i] + qg),
                new[:, i - 1] + tg,
            )
        col = new
        rows[:, j] = np.where(t & 16, col[:, Q], NEG_INF) if gate == "end" \
            else col[:, Q]
    return rows


def timed(fn, n: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def kernel_phase(window: int = 1000, batch: int = 8192, q_lens=None,
                 guide_counts=(1, 4), n_oracle: int = 12,
                 interpret: bool = False) -> None:
    import jax
    import jax.numpy as jnp

    from calitas_tpu.align.oracle import dp_matrix
    from calitas_tpu.core.scoring import derive_scorer
    from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query
    from calitas_tpu.ops import dp_kernel
    from calitas_tpu.ops.genome_screen import (
        _static_pam_spec,
        _xla_screen_multi,
        annotate_genome_pam,
        extract_window_grid,
    )

    scorer = derive_scorer()
    sc = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    q_lens = q_lens or (23, dp_kernel.MAX_Q)
    rng = np.random.default_rng(SEED)
    step = window - 30
    n_bases = batch * step + window
    letters = np.frombuffer(b"ACGT", np.uint8)
    genome = letters[rng.integers(0, 4, n_bases)]
    for q_len in q_lens:
        protos = ["".join(rng.choice(list("ACGT"), q_len))
                  for _ in range(max(guide_counts))]
        # plant exact and 2-mismatch sites so ranges and flags are dense
        for k in range(batch // 4):
            p = protos[k % len(protos)]
            site = list(p)
            for _ in range(k % 3):
                site[int(rng.integers(len(site)))] = "ACGT"[int(rng.integers(4))]
            s = "".join(site) + "AGG"
            if k % 2:
                s = revcomp(s)
            pos = int(rng.integers(0, n_bases - len(s)))
            genome[pos : pos + len(s)] = np.frombuffer(s.encode(), np.uint8)
        masks = jnp.asarray(TARGET_MASK_TABLE[genome])
        spec = _static_pam_spec((("nrg",), 1, 3))
        gated_genome = annotate_genome_pam(masks, pam_spec=spec)
        for G in guide_counts:
            qvals = jnp.asarray(np.stack([
                np.stack([encode_query(p), encode_query(revcomp(p))])
                for p in protos[:G]
            ]).astype(np.int32))
            ms = jnp.asarray(np.full(G, scorer.match_score * q_len - 5 * 122,
                                     np.int32))
            for pam_gate in (True, False):
                g_arr = gated_genome if pam_gate else masks
                wins = extract_window_grid(g_arr, 0, batch, step, window)
                lengths = jnp.full((batch,), window, jnp.int32)

                # layout + kernel, and the XLA scan, each one jitted step
                kern_fn = jax.jit(lambda w, q=qvals, m=ms, Q=q_len, pg=pam_gate:
                                  dp_kernel.screen_multi(
                                      q, dp_kernel.pack_tcols(w), m, T=window,
                                      Q=Q, pam_gate=pg, emit_ranges=True,
                                      interpret=interpret, **sc))
                xla_fn = jax.jit(lambda w, q=qvals, m=ms, G=G, pg=pam_gate:
                                 _xla_screen_multi(
                                     q, w, lengths, m, G=G, pam_gate=pg,
                                     emit_ranges=True, **sc))

                def kern():
                    return kern_fn(wins)

                def xla():
                    return xla_fn(wins)

                kb, kr = (np.asarray(x) for x in kern())
                xb, xr = (np.asarray(x) for x in xla())
                assert np.array_equal(kb, xb), "kernel maxima != XLA scan"
                assert np.array_equal(kr, xr), "kernel ranges != XLA scan"
                flags = kb >= np.asarray(ms)[:, None, None]
                assert np.array_equal(flags, xb >= np.asarray(ms)[:, None, None])
                # NumPy DP on a sample of windows, flagged ones included
                hot = np.nonzero(flags[0].any(axis=0))[0][: n_oracle // 2]
                sample = np.unique(np.concatenate(
                    [hot, rng.choice(batch, n_oracle - len(hot), replace=False)]))
                raw = np.asarray(wins)[sample]
                for c, gate in enumerate(("end", "start")):
                    gate = gate if pam_gate else None
                    qm = np.asarray(qvals[0, c]).astype(np.uint8)
                    rows = numpy_gated_rows(qm, raw, scorer, gate)
                    if gate != "start":  # the oracle itself, gated after
                        oracle = np.stack([dp_matrix(qm, w & 15, scorer)[q_len, 1:]
                                           for w in raw]).astype(np.int64)
                        if gate == "end":
                            oracle = np.where(raw & 16, oracle, dp_kernel.NEG_INF)
                        assert np.array_equal(rows, oracle), "NumPy DP != oracle"
                    assert np.array_equal(rows.max(axis=1), kb[0, c, sample]), \
                        "kernel maxima != NumPy DP"
                tk = timed(kern) if not interpret else float("nan")
                tx = timed(xla, 2) if not interpret else float("nan")
                log(f"kernel == XLA scan == NumPy oracle: T={window} B={batch} "
                    f"Q={q_len} G={G} gate={'on' if pam_gate else 'off'} "
                    f"flagged={int(flags.any(axis=1).sum())} "
                    f"kernel {tk * 1e3:.3f} ms/batch, XLA scan "
                    f"{tx * 1e3:.3f} ms/batch")


# ---------------------------------------------------------------------------
# synthetic genome, VCF and loci
# ---------------------------------------------------------------------------

class Genome:
    """A seeded synthetic reference: random bases with leading and inner N
    runs, soft-masked lowercase blocks and planted guide sites, written as
    FASTA + .fai + .dict."""

    def __init__(self, root: str, contigs=CONTIGS, sites_per_contig: int = 40,
                 seed: int = SEED):
        self.rng = np.random.default_rng(seed)
        self.path = os.path.join(root, "genome.fa")
        self.seqs: dict = {}
        self.planted: list = []  # (chrom, 0-based start, end) of guide+PAM
        #: (1-based pos, ref, alt) SNVs that repair 6-mismatch sites on the
        #: last contig: sites only the variant pass can find
        self.repairs: list = []
        for name, n in contigs:
            self.seqs[name] = self._contig(n, sites_per_contig, name)
        self._plant_repairable(contigs[-1][0])
        self._write()

    def _free_pos(self, seq: np.ndarray) -> int:
        while True:
            pos = int(self.rng.integers(20_000, len(seq) - 100))
            if not (seq[pos - 40 : pos + 63] == ord("N")).any():
                return pos

    def _plant_repairable(self, name: str, n: int = 10) -> None:
        seq = self.seqs[name]
        for _ in range(n):
            pos = self._free_pos(seq)
            site = list(PROTO)
            idx = self.rng.choice(len(site), 6, replace=False)
            for i in idx:
                site[i] = "ACGT"[("ACGT".index(site[i]) + 2) % 4]
            seq[pos : pos + 23] = np.frombuffer(
                ("".join(site) + "TGG").encode(), np.uint8)
            i = int(idx[0])
            self.repairs.append((pos + i + 1, site[i], PROTO[i]))

    def _contig(self, n: int, n_sites: int, name: str) -> np.ndarray:
        rng = self.rng
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, np.uint8)]
        lower = rng.integers(0, n - 200_000, max(4, n // 2_000_000))
        for a in lower:  # soft-masked repeats
            seq[a : a + int(rng.integers(1_000, 200_000))] |= 0x20
        seq[: min(10_000, n // 10)] = ord("N")  # telomere-like lead
        for a in rng.integers(20_000, n - 100_000, max(2, n // 20_000_000)):
            seq[a : a + int(rng.integers(100, 60_000))] = ord("N")
        for k in range(n_sites):
            pos = self._free_pos(seq)
            site = list(PROTO)
            for _ in range(k % 4):  # 0-3 mismatches
                i = int(rng.integers(len(site)))
                site[i] = "ACGT"[("ACGT".index(site[i]) + 1 + int(rng.integers(3))) % 4]
            s = "".join(site) + ("TGG", "AGG", "CAG", "GGG")[k % 4]
            if k % 2:
                s = revcomp(s)
            b = np.frombuffer(s.encode(), np.uint8)
            seq[pos : pos + len(s)] = b | (seq[pos : pos + len(s)] & 0x20)
            self.planted.append((name, pos, pos + len(s)))
        return seq

    def _write(self, line: int = 100) -> None:
        from calitas_tpu.io.fasta import DictEntry, SequenceDictionary, dict_path_for

        fai = []
        with open(self.path, "wb") as fh:
            for name, seq in self.seqs.items():
                fh.write(f">{name}\n".encode())
                off = fh.tell()
                rows = len(seq) // line
                out = np.empty((rows, line + 1), np.uint8)
                out[:, :line] = seq[: rows * line].reshape(rows, line)
                out[:, line] = ord("\n")
                fh.write(out.tobytes())
                if len(seq) % line:
                    fh.write(seq[rows * line :].tobytes() + b"\n")
                fai.append(f"{name}\t{len(seq)}\t{off}\t{line}\t{line + 1}\n")
        with open(self.path + ".fai", "w") as fh:
            fh.writelines(fai)
        SequenceDictionary(
            [DictEntry(name=n, length=len(s), assembly="smoke")
             for n, s in self.seqs.items()]
        ).write(dict_path_for(self.path))

    def write_vcf(self, path: str, n: int = 100_000) -> None:
        """~n SNVs and small indels (some filtered, some rare) on the last
        contig, plus the SNVs that repair its 6-mismatch sites."""
        rng = self.rng
        chrom = list(self.seqs)[-1]
        seq = self.seqs[chrom]
        pos = np.unique(rng.integers(30_000, len(seq) - 10, n))
        up = bytes(seq).upper()
        recs = {p: (ref, alt) for p, ref, alt in self.repairs}
        rep = set(recs)
        for p in pos.tolist():
            if p in recs:
                continue
            ref = chr(up[p - 1])
            if ref == "N":
                continue
            kind = rng.random()
            if kind < 0.8:
                recs[p] = (ref, "ACGT"[("ACGT".index(ref) + 1 + int(rng.integers(3))) % 4])
            elif kind < 0.9:
                recs[p] = (ref, ref + "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4)))))
            else:
                k = int(rng.integers(1, 4))
                if b"N" in up[p - 1 : p + k]:
                    continue
                recs[p] = (up[p - 1 : p + k].decode(), ref)
        with open(path, "w") as fh:
            fh.write("##fileformat=VCFv4.2\n")
            fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
            fh.write('##FILTER=<ID=LowQual,Description="low quality">\n')
            fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for p in sorted(recs):
                ref, alt = recs[p]
                af = 0.2 if p in rep else float(rng.choice([0.002, 0.02, 0.1, 0.4]))
                flt = "PASS" if p in rep or rng.random() < 0.9 else "LowQual"
                fh.write(f"{chrom}\t{p}\tv{p}\t{ref}\t{alt}\t50\t{flt}\tAF={af}\n")


def table(path: str) -> list:
    """Rows of a hit table without the time_stamp column."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    ts = lines[0].split("\t").index("time_stamp")
    return [
        "\t".join(x for k, x in enumerate(line.split("\t")) if k != ts)
        for line in lines
    ]


def cli(*args) -> float:
    from calitas_tpu.cli import main

    t0 = time.perf_counter()
    rc = main(list(args))
    assert rc in (0, None), f"CLI exited {rc}: {args}"
    return time.perf_counter() - t0


def search(ref: str, out: str, engine: str, *extra, guide=GUIDE,
           threads: int = None) -> float:
    threads = threads or os.cpu_count() or 8
    return cli("SearchReference", "-i", guide, "-I", "g", "-r", ref, "-o", out,
               *DEFAULT_ARGS, "-t", str(threads), "--engine", engine, *extra)


def check_planted(genome: Genome, rows: list) -> None:
    head = rows[0].split("\t")
    ci, si, ei = (head.index(c) for c in
                  ("chromosome", "coordinate_start", "coordinate_end"))
    spans: dict = {}
    for r in rows[1:]:
        f = r.split("\t")
        spans.setdefault(f[ci], []).append((int(f[si]), int(f[ei])))
    missing = [
        (c, a) for c, a, b in genome.planted
        if not any(s < b and a < e for s, e in spans.get(c, ()))
    ]
    assert not missing, f"planted sites missing from the table: {missing[:5]}"


# ---------------------------------------------------------------------------
# phases 3-7
# ---------------------------------------------------------------------------

def one_device_phases(root: str, contigs=CONTIGS, n_variants: int = 100_000,
                      n_loci: int = 10_000) -> None:
    from calitas_tpu import native
    from calitas_tpu.utils import degradations

    t0 = time.perf_counter()
    genome = Genome(root, contigs)
    n_bases = sum(len(s) for s in genome.seqs.values())
    log(f"synthetic genome: {n_bases:,} bases over {len(genome.seqs)} contigs, "
        f"{len(genome.planted)} planted sites ({time.perf_counter() - t0:.1f} s)")
    ref = genome.path

    # 3. reference pass, whole genome, then host parity on one contig
    out = os.path.join(root, "device.tsv")
    t_dev = search(ref, out, "device")
    rows = table(out)
    check_planted(genome, rows)
    log(f"SearchReference --engine device, {n_bases / 1e9:.3f} Gb: "
        f"{len(rows) - 1} rows, all {len(genome.planted)} planted sites found, "
        f"{t_dev:.2f} s end to end (first run, compilation included)")
    t_dev2 = search(ref, out, "device")
    assert table(out) == rows
    log(f"SearchReference --engine device, second run: {t_dev2:.2f} s "
        f"({n_bases / t_dev2:.3e} bases/s)")
    c_dev, c_host = (os.path.join(root, f"{e}_{PARITY_CONTIG}.tsv")
                     for e in ("device", "host"))
    search(ref, c_dev, "device", "-c", PARITY_CONTIG)
    t_host = search(ref, c_host, "host", "-c", PARITY_CONTIG)
    assert table(c_dev) == table(c_host), "device table != host table"
    log(f"reference pass on {PARITY_CONTIG} "
        f"({len(genome.seqs[PARITY_CONTIG]):,} bases): device == host, "
        f"{len(table(c_dev)) - 1} rows (host engine {t_host:.1f} s)")

    # 4. variant pass
    raw_vcf, vcf = (os.path.join(root, n) for n in ("raw.vcf", "prepared.vcf"))
    genome.write_vcf(raw_vcf, n_variants)
    cli("PrepareVcf", "-i", raw_vcf, "-o", vcf, "-d", ref)
    n_var = sum(1 for line in open(vcf) if not line.startswith("#"))
    v_dev, v_host = (os.path.join(root, f"{e}_vcf.tsv") for e in ("device", "host"))
    tv = search(ref, v_dev, "device", "-c", PARITY_CONTIG, "-v", vcf)
    search(ref, v_host, "host", "-c", PARITY_CONTIG, "-v", vcf)
    vrows = table(v_dev)
    assert vrows == table(v_host), "variant-pass table != host table"
    vi = vrows[0].split("\t").index("variant_id")
    n_vrows = sum(1 for r in vrows[1:] if r.split("\t")[vi] not in ("", "NA"))
    assert n_vrows > 0, "variant pass produced no variant rows"
    log(f"PrepareVcf kept {n_var} records; SearchReference -v on "
        f"{PARITY_CONTIG}: device == host, {len(vrows) - 1} rows "
        f"({n_vrows} with variants), device {tv:.1f} s")

    # 5. Serve: resident genome, two guide lengths, against fresh CLI runs
    from calitas_tpu.serve import ResidentSearcher

    searcher = ResidentSearcher(ref, vcf, engine="device",
                                contigs=[PARITY_CONTIG],
                                threads=os.cpu_count() or 8)
    for k, guide in enumerate((GUIDE, GUIDE_B, GUIDE)):
        s_out, c_out = (os.path.join(root, f"{w}{k}.tsv") for w in ("serve", "cli"))
        t0 = time.perf_counter()
        searcher.search(guide=guide, guide_id="g", output=s_out,
                        chrom=PARITY_CONTIG)
        ts = time.perf_counter() - t0
        search(ref, c_out, "device", "-c", PARITY_CONTIG, "-v", vcf, guide=guide)
        assert table(s_out) == table(c_out), f"Serve request {k} != CLI"
        log(f"Serve request {k} ({len(guide)}-nt guide): == CLI, "
            f"{len(table(s_out)) - 1} rows, {ts:.2f} s")

    # 6. AlignToReference on 10k loci
    rng = np.random.default_rng(SEED + 1)
    seq = genome.seqs[PARITY_CONTIG]
    loci = os.path.join(root, "loci.tsv")
    with open(loci, "w") as fh:
        fh.write("id\tquery\tchrom\tposition\n")
        planted = [a for c, a, _ in genome.planted if c == PARITY_CONTIG]
        for k in range(n_loci):
            if k < len(planted):
                pos = planted[k] + 10
            else:
                pos = int(rng.integers(20_000, len(seq) - 100))
            q = PROTO if k % 3 else "".join(rng.choice(list("ACGT"), 20))
            fh.write(f"l{k}\t{q}nrg\t{PARITY_CONTIG}\t{pos}\n")
    a_dev, a_host = (os.path.join(root, f"a2r_{e}.tsv") for e in ("device", "host"))
    ta = cli("AlignToReference", "-i", loci, "-r", ref, "-o", a_dev,
             "--engine", "device", "-t", str(os.cpu_count() or 8))
    cli("AlignToReference", "-i", loci, "-r", ref, "-o", a_host,
        "--engine", "host", "-t", str(os.cpu_count() or 8))
    arows = table(a_dev)
    assert arows == table(a_host), "AlignToReference device != host"
    log(f"AlignToReference --engine device, {n_loci} loci: == host, "
        f"{len(arows) - 1} rows, {ta:.1f} s")

    # 7. nothing degraded, native finish loaded, one process on the card
    assert native.available(), "native library not available"
    deg = degradations()
    assert not deg, f"device path degraded: {deg}"
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.split()
    assert len(apps) <= 1, f"{len(apps)} processes on the card: {apps}"
    log(f"degradations: 0; native library: loaded; processes on the card: "
        f"{apps or 'none listed'} (this process: {os.getpid()})")


def mesh_phase(root: str, n_devices: int, contigs=CONTIGS,
               n_variants: int = 100_000) -> None:
    from calitas_tpu.align.engine import SequentialAligner
    from calitas_tpu.core.sequence import revcomp as rc
    from calitas_tpu.ops.genome_screen import ShardedGenomeScreen
    from calitas_tpu.parallel.mesh import make_mesh
    from calitas_tpu.tools import search_reference
    from calitas_tpu.utils import degradations

    mesh = make_mesh(n_devices)
    genome = Genome(root, contigs)
    ref = genome.path
    raw_vcf, vcf = (os.path.join(root, n) for n in ("raw.vcf", "prepared.vcf"))
    genome.write_vcf(raw_vcf, n_variants)
    from calitas_tpu.tools import prepare_vcf

    prepare_vcf.run(input=[raw_vcf], output=vcf, dict_path=ref)

    # every shard of the mesh screen sits on its own card
    screen = ShardedGenomeScreen(SequentialAligner().scorer, mesh, window=1000)
    staged = screen.stage(genome.seqs["chr1"])
    [(_i0, _n, resolve)] = screen.screen_contig_multi_async(
        staged, len(genome.seqs["chr1"]), 970, [(PROTO, rc(PROTO))], [590],
        segments=1,
    )
    outs = resolve.arrays  # the segment's device-resident flags and ranges
    for arr in outs:
        devs = [s.device.id for s in arr.addressable_shards]
        assert len(set(devs)) == n_devices, devs
    used = [(d.memory_stats() or {}).get("bytes_in_use")
            for d in mesh.devices.flat]  # None on the CPU backend
    assert all(u is None or u > 0 for u in used), used
    log(f"mesh screen: output shards on devices "
        f"{sorted(s.device.id for s in outs[0].addressable_shards)}, "
        f"bytes in use per card {used}")
    del staged, screen

    kw = dict(guide=GUIDE, guide_id="g", ref=ref, variants=vcf,
              threads=os.cpu_count() or 8, window_size=1000, engine="device")
    one, four = (os.path.join(root, n) for n in ("one.tsv", "mesh.tsv"))
    t0 = time.perf_counter()
    search_reference.run(output=one, **kw)
    t1 = time.perf_counter()
    search_reference.run(output=four, mesh=mesh, **kw)
    t2 = time.perf_counter()
    rows = table(one)
    assert rows == table(four), "mesh table != one-device table"
    check_planted(genome, rows)
    vi = rows[0].split("\t").index("variant_id")
    n_vrows = sum(1 for r in rows[1:] if r.split("\t")[vi] not in ("", "NA"))
    assert n_vrows > 0
    assert not degradations(), degradations()
    log(f"SearchReference -v on a {n_devices}-device mesh == one device: "
        f"{len(rows) - 1} rows ({n_vrows} with variants); one device "
        f"{t1 - t0:.1f} s, mesh {t2 - t1:.1f} s (first runs)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    device = device_report(args.devices)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        if args.devices == 1:
            kernel_phase()
            one_device_phases(root)
        else:
            mesh_phase(root, args.devices)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
