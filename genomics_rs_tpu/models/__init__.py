"""High-level model-like APIs (aligners over the DP kernels)."""

from genomics_rs_tpu.models.aligner import (
    PairwiseAligner,
    align_batch,
    align_pair,
)
from genomics_rs_tpu.models.mapper import (
    KmerIndex,
    MappedRead,
    map_pairs,
    map_reads,
    write_sam_paired,
)
from genomics_rs_tpu.models.caller import (
    VariantCall,
    call_reads,
    write_vcf,
)
from genomics_rs_tpu.models.msa import (
    MSAResult,
    center_star_msa,
    format_msa_clustal,
    write_msa_fasta,
)
from genomics_rs_tpu.models.reads import align_reads, write_sam

__all__ = [
    "PairwiseAligner",
    "align_batch",
    "align_pair",
    "align_reads",
    "write_sam",
    "KmerIndex",
    "MappedRead",
    "map_reads",
    "map_pairs",
    "write_sam_paired",
    "MSAResult",
    "center_star_msa",
    "format_msa_clustal",
    "write_msa_fasta",
    "VariantCall",
    "call_reads",
    "write_vcf",
]
