"""longphase_s_jax — long-read phasing engine on JAX (NVIDIA GPU).

A from-scratch re-design of the capabilities of LongPhase-S
(CCU-Bioinformatics-Lab/longphase-s, a C++11/OpenMP/htslib tool) for an
accelerator:

* host layer (``io/``, ``core/``): BAM/VCF/FASTA codecs and CIGAR-walk allele
  extraction producing dense read-by-site tensors,
* device layer (``ops/``): JAX/Pallas kernels for banded edge accumulation,
  the sequential haplotype vote scan, read-haplotype scoring, somatic
  statistics and purity statistics,
* pipelines (``models/``): phase, haplotag, somatic_haplotag, estimate_purity,
  modcall,
* scaling (``parallel/``): jax.sharding mesh over genome position blocks with
  banded halo exchange.

Reference behavior parity is documented per-function with file:line citations
into the upstream C++ sources.
"""

__version__ = "0.1.0"
# Version string reported in output VCF/BAM headers (reference: main.cpp "Version: 1.0.0")
REFERENCE_VERSION = "1.0.0"
