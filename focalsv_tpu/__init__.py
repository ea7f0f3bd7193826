"""FocalSV: an accelerator region-based structural-variant assembly & refinement framework.

A ground-up JAX/XLA/Pallas re-design of the capabilities of FocalSV
(reference: maiziezhoulab/FocalSV): prior+read-signal region detection,
per-region cropping/phasing, local diploid assembly, contig->reference
alignment, CIGAR->SV extraction/refinement, genotype correction and VCF merge,
sharded data-parallel over genomic regions on the attached GPUs.

Unlike the reference -- a Python orchestration layer shelling out to native
CPU tools (hifiasm, longshot, minimap2, samtools; see SURVEY.md section 1) --
every compute stage here is a batched JAX function over fixed-shape region
tensors, compiled once and sharded with ``jax.sharding``/``shard_map``; the
host layer owns only I/O (BAM/FASTA/VCF/BED) and orchestration.
"""

__version__ = "0.1.0"

from focalsv_tpu.config import (  # noqa: F401
    DataType,
    PipelineConfig,
    preset,
)
