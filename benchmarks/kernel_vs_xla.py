"""The DP screen on a GPU: the Pallas/Triton kernel against the XLA scan.

    python benchmarks/kernel_vs_xla.py [genome_Mb]    # default 1024

1. Per batch: one window batch (T = 1000, B = 8192 and 65536, guide
   length 23, 1 and 4 guides, PAM gate on) through ``dp_kernel`` and
   through the gated XLA scan, timed in turns (kernel, XLA, XLA, kernel);
   results must be equal.
2. End to end: the reference pass of SearchReference over a 1 Gb hash
   genome (the ``bench.py`` workload: device screen, native finish,
   dedup, sort, serialization, genome staged once), run with each screen
   in turns (kernel, XLA, XLA, kernel); tables must be equal.

Prints the card's name and power limit first; needs a GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(fn, n):
    import jax

    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def per_batch(scores) -> None:
    import jax
    import jax.numpy as jnp

    from calitas_tpu.ops import dp_kernel
    from calitas_tpu.ops.genome_screen import _xla_screen_multi

    T, Q = 1000, 23
    key = jax.random.PRNGKey(0)
    for B in (8192, 65536):
        wins = jax.random.randint(key, (B, T), 0, 64).astype(jnp.uint8)
        lengths = jnp.full((B,), T, jnp.int32)
        for G in (1, 4):
            qv = jax.random.randint(jax.random.PRNGKey(G), (G, 2, Q), 1, 16)
            ms = jnp.full((G,), 60 * Q - 5 * 122, jnp.int32)

            # layout + kernel, and the XLA scan, each one jitted step
            kern_fn = jax.jit(lambda w, qv=qv, ms=ms: dp_kernel.screen_multi(
                qv, dp_kernel.pack_tcols(w), ms, T=T, Q=Q, pam_gate=True,
                emit_ranges=True, **scores))
            xla_fn = jax.jit(lambda w, qv=qv, ms=ms, G=G: _xla_screen_multi(
                qv, w, lengths, ms, G=G, pam_gate=True, emit_ranges=True,
                **scores))

            def kern():
                return kern_fn(wins)

            def xla():
                return xla_fn(wins)

            t0 = time.perf_counter()
            k = jax.block_until_ready(kern())
            compile_k = time.perf_counter() - t0
            x = jax.block_until_ready(xla())
            assert all(np.array_equal(a, b) for a, b in zip(k, x))
            tk = [_time(kern, 20)]
            tx = [_time(xla, 3)]
            tx.append(_time(xla, 3))
            tk.append(_time(kern, 20))
            cells = 2 * G * B * T * Q
            print(f"batch T={T} B={B} Q={Q} G={G}: kernel {np.mean(tk) * 1e3:.3f} ms "
                  f"({cells / np.mean(tk) / 1e9:.0f} Gcells/s, first call "
                  f"{compile_k:.2f} s), XLA scan {np.mean(tx) * 1e3:.3f} ms "
                  f"({cells / np.mean(tx) / 1e9:.1f} Gcells/s), "
                  f"ratio {np.mean(tx) / np.mean(tk):.1f}x; runs k={tk} x={tx}",
                  flush=True)


def end_to_end(genome_mb: float) -> None:
    import bench
    from calitas_tpu.align.engine import SequentialAligner
    from calitas_tpu.core.guide import Guide
    from calitas_tpu.core.sequence import revcomp
    from calitas_tpu.io.fasta import DictEntry, IndexedFasta, SequenceDictionary, build_fai
    from calitas_tpu.ops.genome_screen import GenomeScreen
    from calitas_tpu.parallel.screen_runner import GuideTask, screened_search
    from calitas_tpu.search.hits import dedup_sort_serialize

    n = int(genome_mb * 1e6)
    guide = Guide.parse(bench.GUIDE)
    aligner = SequentialAligner()
    kw = dict(max_guide_diffs=5, max_pam_diffs=1,
              max_gaps_between_guide_and_pam=3, max_total_diffs=9, max_overlap=10)
    window, step = 1000, 1000 - (len(bench.GUIDE) + 5 + 3 - 1)
    letters = np.frombuffer(b"ACGT", np.uint8)
    bases = np.empty(n, np.uint8)
    for off in range(0, n, 1 << 26):
        m = min(1 << 26, n - off)
        bases[off : off + m] = letters[bench.host_genome_codes(off, m)]
    tmp = tempfile.mkdtemp(prefix="kernel_vs_xla_")
    fa = os.path.join(tmp, "ref.fa")
    bench.write_fasta(fa, bases)
    build_fai(fa)
    del bases
    dictionary = SequenceDictionary([DictEntry(name="chr1", length=n)])
    ref = IndexedFasta(fa)
    genome = bench.device_genome_masks(1 << (n + window - 1).bit_length(), n)
    tasks = [GuideTask(guide_id="b", guide=guide, guide_length=len(bench.GUIDE),
                       step_size=step)]
    hit_spec = dict(ref_path=fa, aligner_id="A", arguments="b", vcf_id=None,
                    timestamp="t")
    threads = os.cpu_count() or 8
    screens = {name: GenomeScreen(aligner.scorer, window=window, use_kernel=k)
               for name, k in (("kernel", True), ("xla", False))}

    def run(name):
        t0 = time.perf_counter()
        hits = []
        for _t, _c, _s, rows in screened_search(
            ref, None, tasks, aligner, window_size=window, threads=threads,
            hit_spec=hit_spec, screen=screens[name], prestaged={"chr1": genome},
            **kw,
        ):
            hits.extend(rows)
        body, n_keep, _ = dedup_sort_serialize(hits, kw["max_overlap"], dictionary)
        return time.perf_counter() - t0, body, n_keep

    def screen_only(name):
        ms = aligner.min_guide_score(guide, kw["max_guide_diffs"])
        q = guide.guide_fw
        t0 = time.perf_counter()
        for _i0, _n, resolve in screens[name].screen_contig_async(
            genome, n, step, q, revcomp(q), ms, pam_spec=(tuple(guide.pams_fw), 1, 3)
        ):
            resolve()
        return time.perf_counter() - t0

    first = {name: run(name) for name in ("kernel", "xla")}  # compile + warm
    assert first["kernel"][1] == first["xla"][1], "tables differ"
    times = {"kernel": [], "xla": []}
    screen_t = {"kernel": [], "xla": []}
    for name in ("kernel", "xla", "xla", "kernel"):
        times[name].append(run(name)[0])
        screen_t[name].append(screen_only(name))
    print(f"end to end, {genome_mb:g} Mb reference pass, {threads} threads, "
          f"{first['kernel'][2]} rows: first runs kernel "
          f"{first['kernel'][0]:.3f} s / XLA {first['xla'][0]:.3f} s; "
          f"warm kernel {times['kernel']} s, XLA {times['xla']} s; "
          f"screen alone kernel {screen_t['kernel']} s, XLA {screen_t['xla']} s",
          flush=True)


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX reports {dev.platform!r}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    from calitas_tpu.core.scoring import derive_scorer

    s = derive_scorer()
    per_batch(dict(match=s.match_score, mismatch=s.mismatch_score,
                   qgap=s.query_gap_score, tgap=s.target_gap_score))
    end_to_end(float(sys.argv[1]) if len(sys.argv) > 1 else 1024.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
