"""Measure how many candidate windows are single-strand at default
thresholds — i.e. how much host DP the per-chain screen flags save.

Run on the GPU:  python benchmarks/strand_fraction.py [mbases]
"""
import sys
import time

import numpy as np
import jax

from calitas_tpu.core.guide import Guide
from calitas_tpu.core.sequence import revcomp
from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.ops.genome_screen import GenomeScreen

MB = int(sys.argv[1]) if len(sys.argv) > 1 else 16
N = MB * 1_000_000
MAX_GUIDE_DIFFS = 5
MAX_PAM_MM = 1
MAX_GAP = 3
WINDOW = 1000

base_lut = np.frombuffer(b"ACGT", np.uint8)
bits = jax.random.bits(jax.random.PRNGKey(7), (N,), dtype=np.uint8)
genome = np.asarray(jax.device_get(base_lut[np.asarray(bits) & 3]))

guide = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
aligner = SequentialAligner()
min_score = aligner.min_guide_score(guide, MAX_GUIDE_DIFFS)
dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
dp_pams = guide.pams_rc if guide.pam_is_5prime else guide.pams_fw
pam_spec = (tuple(dp_pams), MAX_PAM_MM, MAX_GAP) if dp_pams else None
step = WINDOW - (len(guide.guide) + guide.pam_length + MAX_GUIDE_DIFFS + MAX_GAP - 1)

scr = GenomeScreen(aligner.scorer, window=WINDOW)
genome_dev = scr.stage(genome)
t0 = time.time()
chains = scr.screen_contig(
    genome_dev, N, step, dp_query, revcomp(dp_query), min_score,
    pam_spec=pam_spec, return_chains=True,
)
t1 = time.time()

a, b = chains[0], chains[1]
cand = a | b
n = int(cand.sum())
single = int((a ^ b).sum())
print(f"genome={MB}Mb windows={chains.shape[1]} screen_time={t1-t0:.2f}s")
print(f"candidates={n} ({100*n/chains.shape[1]:.2f}% of windows)")
print(f"single-strand candidates={single} ({100*single/max(n,1):.1f}% of candidates)")
print(f"host DP strand-passes saved: {single} of {2*n} ({100*single/max(2*n,1):.1f}%)")
