"""Interleaved A/B: decoupled feed/drain (producer thread) vs the legacy
single-thread map_items_mp loop, on the full 1-chip SearchReference
end-to-end workload (the bench.py configuration).

The round-4 profiling showed the finish pool was FEED-STARVED: the 1 Gb
collect phase was identical at threads=1/2/4 while the same finish
workload fed independently scaled 4x.  This benchmark validates the fix
by alternating variants within ONE process, A B A B, and comparing
bests.

Usage: python benchmarks/feed_ab.py [genome_Mb] [n_pairs]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (the repo-root harness: genome gen, fasta write)


def main() -> None:
    import atexit
    import shutil

    import jax.numpy as jnp

    from calitas_tpu.align.engine import SequentialAligner
    from calitas_tpu.core.guide import Guide
    from calitas_tpu.io.fasta import (
        DictEntry,
        IndexedFasta,
        SequenceDictionary,
        build_fai,
    )
    from calitas_tpu.ops.genome_screen import GenomeScreen
    from calitas_tpu.parallel import host_pool as hp
    from calitas_tpu.parallel.screen_runner import GuideTask, screened_search
    from calitas_tpu.search.hits import dedup_sort_serialize

    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 1024.0
    n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    G = int(genome_mb * 1e6)
    threads = min(4, os.cpu_count() or 1)

    guide = Guide.parse(bench.GUIDE)
    aligner = SequentialAligner()
    align_kwargs = dict(
        max_guide_diffs=5, max_pam_diffs=1,
        max_gaps_between_guide_and_pam=3, max_total_diffs=9, max_overlap=10,
    )
    window_size = 1000
    step = window_size - (len(bench.GUIDE) + 5 + 3 - 1)

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bases = np.empty(G, dtype=np.uint8)
    for off in range(0, G, 1 << 26):
        n = min(1 << 26, G - off)
        bases[off : off + n] = letters[bench.host_genome_codes(off, n)]
    tmpdir = tempfile.mkdtemp(prefix="calitas_feed_ab_")
    atexit.register(shutil.rmtree, tmpdir, True)
    fa = os.path.join(tmpdir, "ref.fa")
    bench.write_fasta(fa, bases)
    build_fai(fa)
    dictionary = SequenceDictionary(
        [DictEntry(name="chr1", length=G, assembly="bench")]
    )
    ref_file = IndexedFasta(fa)

    np.asarray(jnp.arange(8).sum())  # absorb first-dispatch stall

    screen = GenomeScreen(aligner.scorer, window=window_size)
    padded_len = 1 << (G + window_size - 1).bit_length()
    genome_dev = bench.device_genome_masks(padded_len, G)
    genome_dev.block_until_ready()
    prestaged = {"chr1": genome_dev}

    gtasks = [
        GuideTask(
            guide_id="bench", guide=guide, guide_length=len(bench.GUIDE),
            step_size=step,
        )
    ]
    hit_spec = dict(
        ref_path=fa, aligner_id="CALITAS:SearchReference",
        arguments="bench", vcf_id=None,
        timestamp="Mon Jan 01 00:00:00 UTC 2026",
    )

    def e2e_once():
        hits = []
        for _t, _c, _s, rows in screened_search(
            ref_file, None, gtasks, aligner,
            window_size=window_size, threads=threads, swallow_errors=True,
            hit_spec=hit_spec, screen=screen, prestaged=prestaged,
            **align_kwargs,
        ):
            hits.extend(rows)
        body, n_keep, _ = dedup_sort_serialize(
            hits, align_kwargs["max_overlap"], dictionary
        )
        return n_keep, len(body)

    # Warm both variants (compile + pool spin-up) before timing.
    hp.FEED_THREAD = True
    ref_out = e2e_once()
    hp.FEED_THREAD = False
    legacy_out = e2e_once()
    assert ref_out == legacy_out, (ref_out, legacy_out)

    best = {"decoupled": float("inf"), "legacy": float("inf")}
    for i in range(n_pairs):
        for name, flag in (("decoupled", True), ("legacy", False)):
            hp.FEED_THREAD = flag
            t0 = time.perf_counter()
            out = e2e_once()
            dt = time.perf_counter() - t0
            assert out == ref_out, (name, out, ref_out)
            best[name] = min(best[name], dt)
            print(
                f"pair {i}: {name:9s} {dt:.3f}s "
                f"({G / dt / 1e9:.2f} Gbases/s)", flush=True,
            )
    hp.FEED_THREAD = True
    print(
        f"\nbest decoupled={best['decoupled']:.3f}s "
        f"({G / best['decoupled'] / 1e9:.2f} Gbases/s)  "
        f"legacy={best['legacy']:.3f}s "
        f"({G / best['legacy'] / 1e9:.2f} Gbases/s)  "
        f"speedup={best['legacy'] / best['decoupled']:.2f}x  "
        f"rows={ref_out[0]} (identical across all runs)"
    )


if __name__ == "__main__":
    main()
