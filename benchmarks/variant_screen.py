"""A/B benchmark: host vs device-screened variant pass on 100 Mb + 400k
variants.

Runs the FULL SearchReference tool with --variants both ways,
INTERLEAVED in one process (A B A B), and checks the two tables match.

Usage: python benchmarks/variant_screen.py [genome_Mb] [n_variants]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import host_genome_codes, write_fasta

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"


def main() -> None:
    from calitas_tpu.io.fasta import build_fai
    from calitas_tpu.tools import search_reference

    genome_mb = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    n_var = int(sys.argv[2]) if len(sys.argv) > 2 else 400_000
    G = int(genome_mb * 1e6)

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bases = letters[host_genome_codes(0, G)]
    tmpdir = tempfile.mkdtemp(prefix="calitas_vs_")
    import atexit
    import shutil

    atexit.register(shutil.rmtree, tmpdir, True)
    fa = os.path.join(tmpdir, "ref.fa")
    write_fasta(fa, bases)
    build_fai(fa)
    # .dict sidecar (ref.fa -> ref.dict)
    with open(os.path.join(tmpdir, "ref.dict"), "w") as fh:
        fh.write("@HD\tVN:1.6\n")
        fh.write(f"@SQ\tSN:chr1\tLN:{G}\tAS:bench\n")

    rng = np.random.default_rng(12)
    vcf = os.path.join(tmpdir, "v.vcf")
    pos = np.sort(rng.integers(1000, G - 1000, size=n_var))
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        alts = rng.integers(0, 4, size=n_var)
        for i, p in enumerate(pos.tolist()):
            ref_b = chr(bases[p - 1])
            alt = "ACGT"[alts[i]]
            if alt == ref_b:
                alt = "ACGT"[(alts[i] + 1) % 4]
            fh.write(f"chr1\t{p}\trs{i}\t{ref_b}\t{alt}\t50\tPASS\tAF=0.1\n")

    def run(engine, tag):
        out = os.path.join(tmpdir, f"out.{tag}.txt")
        t0 = time.perf_counter()
        search_reference.run(
            guide=GUIDE, guide_id="b", ref=fa, variants=vcf, output=out,
            engine=engine, threads=min(4, os.cpu_count() or 1),
        )
        dt = time.perf_counter() - t0
        print(f"[{tag}] engine={engine}: {dt:.2f}s", flush=True)
        return out, dt

    # Interleaved A/B, two rounds each; first pair is also the warm-up
    # (compiles + worker pool), so report the best of round 2.
    results = {}
    outs = {}
    for rnd in range(2):
        for engine in ("host", "device"):
            out, dt = run(engine, f"{engine}{rnd}")
            outs[engine] = out
            results.setdefault(engine, []).append(dt)

    def rows(p):
        lines = open(p).read().splitlines()
        ts = lines[0].split("\t").index("time_stamp")
        return [
            tuple(x for i, x in enumerate(l.split("\t")) if i != ts)
            for l in lines[1:]
        ]

    same = rows(outs["host"]) == rows(outs["device"])
    h = min(results["host"][1:])
    t = min(results["device"][1:])
    print(
        f"host={h:.2f}s device_screened={t:.2f}s speedup={h / t:.2f}x "
        f"tables_identical={same} rows={len(rows(outs['host']))}"
    )
    if not same:
        raise SystemExit("TABLE MISMATCH between host and device engines")


if __name__ == "__main__":
    main()
