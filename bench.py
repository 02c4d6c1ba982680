"""Benchmark harness: END-TO-END SearchReference throughput on one GPU.

Workload: a full production genome search — the device screens every
overlapping window of the genome on both strands with the exact int32
glocal-DP kernel (PAM-gated end columns, bit-packed per-chain candidate
flags, end-column ranges), the host materializes the sparse candidate
windows from the FASTA and finishes them with the batched native
(C++) aligner, and the hits flow through the reference's global
overlap-dedup + dictionary sort + 34-column TSV serialization.  The
measured region is everything a warm production process does per run;
the one-time genome staging (H2D) is excluded and reported separately —
in production the staged genome is reused across guides/runs.

Baseline: the single-host CPU engine (NumPy oracle DP, our stand-in for
the reference's JVM thread-pool engine scaled to 8 threads — the
reference publishes no numbers, see BASELINE.md).  The baseline's DP
fill dominates its end-to-end time, so the comparison is conservative.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline"}.
Optional argv: genome size in Mb (default 1024).
"""

from __future__ import annotations

import io
import json
import os
import sys
import tempfile
import time

import numpy as np

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"  # README example guide

#: murmur3 fmix32 — one uint32 in, one avalanche-mixed uint32 out.  The
#: same integer stream is generated on the host (FASTA on disk) and on
#: the device (staged mask array) so the benchmark never ships the
#: genome across the host<->device link.
_MIX_M1, _MIX_M2, _MIX_M3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def host_genome_codes(start: int, count: int) -> np.ndarray:
    """2-bit base codes for positions [start, start+count) (uint8)."""
    x = (np.arange(start, start + count, dtype=np.uint64) * _MIX_M1).astype(
        np.uint32
    )
    x ^= x >> 16
    x *= np.uint32(_MIX_M2)
    x ^= x >> 13
    x *= np.uint32(_MIX_M3)
    x ^= x >> 16
    return (x & 3).astype(np.uint8)


def device_genome_masks(padded_len: int, G: int):
    """The staged-genome mask array ([padded_len] uint8, 1<<code inside
    the contig, 0 pad) for the same hash stream, generated on device in
    fixed-size fori_loop chunks."""
    import jax
    import jax.numpy as jnp

    CHUNK = 1 << 22

    def block(idx):
        x = idx * jnp.uint32(_MIX_M1)
        x ^= x >> 16
        x *= jnp.uint32(_MIX_M2)
        x ^= x >> 13
        x *= jnp.uint32(_MIX_M3)
        x ^= x >> 16
        m = (jnp.uint8(1) << (x & 3).astype(jnp.uint8)).astype(jnp.uint8)
        return jnp.where(idx < jnp.uint32(G), m, jnp.uint8(0))

    from functools import partial

    @partial(jax.jit, static_argnums=(0,))
    def gen(n):
        if n <= CHUNK:
            return block(jax.lax.iota(jnp.uint32, n))

        def body(i, out):
            idx = i.astype(jnp.uint32) * jnp.uint32(CHUNK) + jax.lax.iota(
                jnp.uint32, CHUNK
            )
            return jax.lax.dynamic_update_slice(
                out, block(idx), (i * CHUNK,)
            )

        return jax.lax.fori_loop(
            0, n // CHUNK, body, jnp.zeros(n, jnp.uint8)
        )

    return gen(padded_len)


def write_fasta(path: str, bases: np.ndarray, line: int = 100) -> None:
    """Fast line-wrapped FASTA write for a single synthetic contig."""
    n = len(bases)
    rows = n // line
    body = bases[: rows * line].reshape(rows, line)
    out = np.empty((rows, line + 1), dtype=np.uint8)
    out[:, :line] = body
    out[:, line] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(b">chr1\n")
        fh.write(out.tobytes())
        tail = bases[rows * line :]
        if len(tail):
            fh.write(tail.tobytes() + b"\n")


def main() -> None:
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX reports {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"# card: {card}", file=sys.stderr)

    from calitas_tpu.align.engine import SequentialAligner
    from calitas_tpu.core.guide import Guide
    from calitas_tpu.core.sequence import encode_query
    from calitas_tpu.io.fasta import (
        DictEntry,
        IndexedFasta,
        SequenceDictionary,
        build_fai,
    )
    from calitas_tpu.io.tsv import MetricWriter
    from calitas_tpu.ops.genome_screen import GenomeScreen
    from calitas_tpu.parallel.screen_runner import GuideTask, screened_search
    from calitas_tpu.search.hits import ReferenceHit, dedup_sort_serialize

    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 1024.0
    G = int(genome_mb * 1e6)
    threads = min(4, os.cpu_count() or 1)

    guide = Guide.parse(GUIDE)
    aligner = SequentialAligner()
    align_kwargs = dict(
        max_guide_diffs=5, max_pam_diffs=1,
        max_gaps_between_guide_and_pam=3, max_total_diffs=9, max_overlap=10,
    )
    window_size = 1000
    step = window_size - (len(GUIDE) + 5 + 3 - 1)

    # Synthetic genome on disk: the production input.  (Untimed setup;
    # generated chunk-by-chunk to bound host memory at 1 Gb+.)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bases = np.empty(G, dtype=np.uint8)
    for off in range(0, G, 1 << 26):
        n = min(1 << 26, G - off)
        bases[off : off + n] = letters[host_genome_codes(off, n)]
    tmpdir = tempfile.mkdtemp(prefix="calitas_bench_")
    import atexit
    import shutil

    atexit.register(shutil.rmtree, tmpdir, True)
    fa = os.path.join(tmpdir, "ref.fa")
    write_fasta(fa, bases)
    build_fai(fa)
    dictionary = SequenceDictionary(
        [DictEntry(name="chr1", length=G, assembly="bench")]
    )
    ref_file = IndexedFasta(fa)

    # Host-engine baseline: exact NumPy DP on a window sample,
    # extrapolated to 8 threads (the reference default).  Measured
    # before any worker pool exists so nothing contends for the cores.
    from calitas_tpu.align.oracle import dp_matrix

    dp_query = guide.guide_fw
    qmask = encode_query(dp_query)
    rng = np.random.default_rng(7)
    sample = rng.integers(1, 15, size=(24, window_size), dtype=np.uint8)
    def measure_host() -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for row in sample:
                dp_matrix(qmask, row, aligner.scorer)  # one strand
            best = min(best, time.perf_counter() - t0)
        return best

    host_elapsed = measure_host()

    # One-time staging: the same hash stream generated device-side
    # (production would ship raw bytes H2D once instead).
    screen = GenomeScreen(aligner.scorer, window=window_size)
    t0 = time.perf_counter()
    padded_len = 1 << (G + window_size - 1).bit_length()
    genome_dev = device_genome_masks(padded_len, G)
    genome_dev.block_until_ready()
    stage_s = time.perf_counter() - t0
    prestaged = {"chr1": genome_dev}

    gtasks = [
        GuideTask(
            guide_id="bench", guide=guide, guide_length=len(GUIDE),
            step_size=step,
        )
    ]
    hit_spec = dict(
        ref_path=fa, aligner_id="CALITAS:SearchReference",
        arguments="bench", vcf_id=None,
        timestamp="Mon Jan 01 00:00:00 UTC 2026",
    )

    def e2e_once() -> tuple[int, int, int]:
        hits = []
        for _t, _c, _s, rows in screened_search(
            ref_file, None, gtasks, aligner,
            window_size=window_size, threads=threads, swallow_errors=True,
            hit_spec=hit_spec, screen=screen, prestaged=prestaged,
            **align_kwargs,
        ):
            hits.extend(rows)
        # fused dedup + sort + serialization — the exact production
        # _finalize path (search/hits.py::dedup_sort_serialize): keeper
        # lines leave as raw blob slices, no per-row objects
        body, n_keep, _n_fwd = dedup_sort_serialize(
            hits, align_kwargs["max_overlap"], dictionary
        )
        return len(hits), n_keep, len(body)

    # Warm run compiles the kernels and spins the worker pool; timed runs
    # measure the steady production state (best of 3).
    n_raw, n_kept, n_bytes = e2e_once()
    elapsed = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        e2e_once()
        elapsed = min(elapsed, time.perf_counter() - t0)
    device_bps = G / elapsed

    # Screen-only time for the phase breakdown (the same segmented spans
    # the search dispatched, re-dispatched warm and fully resolved).
    from calitas_tpu.core.sequence import revcomp

    min_score = aligner.min_guide_score(guide, align_kwargs["max_guide_diffs"])
    pam_spec = (tuple(guide.pams_fw), 1, 3)
    t0 = time.perf_counter()
    for _i0, _n, resolve in screen.screen_contig_async(
        genome_dev, G, step, dp_query, revcomp(dp_query), min_score,
        pam_spec=pam_spec,
    ):
        resolve()
    screen_s = time.perf_counter() - t0

    # Second baseline block: the container's effective CPU speed drifts
    # (shared VM); sampling before AND after the run and taking the
    # faster keeps the ratio's denominator honest-but-stable.
    host_elapsed = min(host_elapsed, measure_host())
    host_bps = (len(sample) * step) / (host_elapsed * 2) * 8  # both strands

    print(
        json.dumps(
            {
                "metric": (
                    "genome bases searched/s end-to-end (SearchReference: "
                    "device screen + native finish + dedup + TSV, 1 GPU)"
                ),
                "value": round(device_bps),
                "unit": "bases/s",
                "vs_baseline": round(device_bps / host_bps, 2),
            }
        )
    )
    from calitas_tpu.ops.genome_screen import default_device_platform

    print(
        f"# device={default_device_platform()} genome={genome_mb}Mb "
        f"threads={threads} e2e_best={elapsed:.3f}s screen={screen_s:.3f}s "
        f"stage_once={stage_s:.1f}s raw_hits={n_raw} kept={n_kept} "
        f"table_bytes={n_bytes} host8t_baseline={host_bps:.0f} bases/s",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
