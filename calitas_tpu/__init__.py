"""calitas_tpu — a JAX CRISPR off-target search framework for GPUs.

A from-scratch reimplementation of the capabilities of CALITAS
(editasmedicine/calitas): glocal alignment of guide+PAM sequences against
genomes with a net-cost scoring system, genome-wide candidate off-target
enumeration with canonical per-locus deduplication, VCF variant
integration, and the four CLI workflows (SearchReference, AlignToReference,
PairwiseAlignSequences, PrepareVcf).

Architecture (device screen + host finish, not a port):
  - core/    sequence encoding (IUPAC 4-bit masks), cigar, scoring, guide model
  - align/   exact alignment engine: DP oracle, PAM extension, dedup
  - ops/     batched JAX DP screen and its Pallas/Triton GPU kernel
  - io/      FASTA (.fai/.dict), VCF, TSV-metric readers/writers
  - search/  genome windowing, variant haplotype engine, hit model
  - tools/   the four CLI tools
  - parallel/ device-mesh sharding of the search
"""

import os

__version__ = "0.1.0"


#: compile cache used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: directory of the checkout (listed in .gitignore), so repeated runs of
#: the same shapes skip compilation
DEFAULT_JAX_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _enable_jax_compilation_cache() -> None:
    """Persist XLA compilations across CLI invocations (kernel compiles
    take seconds; searches are often re-run with the same shapes).  A
    cache directory given by ``JAX_COMPILATION_CACHE_DIR`` is left to JAX
    as it is; otherwise the cache goes to :data:`DEFAULT_JAX_CACHE_DIR`."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_JAX_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
