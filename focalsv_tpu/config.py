"""Centralized typed configuration for the FocalSV pipeline.

The reference scatters its tuned constants across hard-coded per-dtype blocks
(``focalsv/0_define_region.py:452-517``, ``extract_contig_signature_*.py``,
``Auto/define_region.py:691-707``), CSV/TXT parameter tables
(``5_post_processing/filter_para.csv``, ``para/GT_correction_para_*.txt``) and
VCF header templates.  Here every knob lives in one frozen dataclass tree with
one preset per sequencing data type (HIFI / CLR / ONT), so a compiled kernel
can close over a static config and the CLI can override any field.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class DataType(enum.Enum):
    """Long-read sequencing data type (reference: --data_type HIFI|CLR|ONT)."""

    HIFI = "HIFI"
    CLR = "CLR"
    ONT = "ONT"


def _d(**kw):
    return dataclasses.field(default_factory=lambda: dict(kw))


@dataclasses.dataclass(frozen=True)
class RegionDetectConfig:
    """Step-0 auto region detection (reference: focalsv/0_define_region.py).

    A whole-genome read-signature scan is clustered, reduced, re-clustered and
    merged with a population prior VCF to produce the BED of SV-rich regions.
    """

    # fine clustering distance for raw signatures (0_define_region.py:458,469,488)
    dt_fine: int = 500
    # min signatures per cluster to keep (HIFI: 1; CLR/ONT: 0.17 x coverage)
    min_sig: int = 1
    # fraction of estimated coverage used for min_sig on noisy reads (:482,:493)
    min_sig_cov_fraction: float = 0.17
    # re-clustering distance for region union (:461)
    re_dt: int = 15_000
    # flanking bp added around merged regions (:462)
    flank: int = 7_000
    # signatures must exceed this size to count (extract_gt30 awk '$4 > 30')
    min_sig_size: int = 30


@dataclasses.dataclass(frozen=True)
class ReadScanConfig:
    """Read-based signature scan & draft calling (reference: Reads_Based_Scan,
    a vendored cuteSV 1.0.11; defaults from Description.parseArgs:53)."""

    min_mapq: int = 20                  # (-q)
    min_read_len: int = 500             # (-r)
    min_support: int = 10               # (-s)
    min_sv_size: int = 30               # (-l)
    max_sv_size: int = 100_000          # (-L)
    max_split_parts: int = 7            # (-p)
    # genotype likelihood model (genotype.py:6-7)
    gl_error: float = 0.1
    gl_prior: float = 1.0 / 3.0
    # per-dtype signature clustering knobs (0_define_region.py call_sig :41-55)
    max_cluster_bias_ins: int = 1000
    diff_ratio_merging_ins: float = 0.9
    max_cluster_bias_del: int = 1000
    diff_ratio_merging_del: float = 0.5


@dataclasses.dataclass(frozen=True)
class PhasingConfig:
    """Per-region SNV calling + read haplotyping (replaces longshot 0.4.x,
    reference: focalsv/2_phasing/)."""

    min_mapq: int = 20
    min_allele_frac: float = 0.25       # het site detection band
    max_allele_frac: float = 0.75
    min_site_depth: int = 4
    min_minor_count: int = 2            # minor-allele read support at a site
    max_sites: int = 512                # padded SNV axis per region tile
    mec_iters: int = 30                 # iterated-flip MEC refinement rounds
    use_pairhmm: bool = False           # pair-HMM realignment at het sites


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Local per-haplotype consensus assembly (replaces hifiasm/Flye/Shasta for
    region-scale inputs; reference: focalsv/3_assembly/)."""

    polish_rounds: int = 2              # extra rounds for noisy reads (CLR/ONT)
    method: str = "guided"              # "guided" (reference pileup) | "olc"
    band_width: int = 128               # read<->draft banded DP width (olc)
    min_reads: int = 1
    # soft-clip insertion reconstruction (consensus.clip_insertion_candidates):
    # seed size / window / overlap-identity gate for the prefix-suffix
    # dovetail.  Noisy reads need short seeds (P[15-mer clean on BOTH reads]
    # ~ e^{-0.24*15} ~ 3% at CLR error rates) and a loose identity gate
    clip_merge_k: int = 15
    clip_merge_w: int = 10
    clip_merge_max_err: float = 0.15


@dataclasses.dataclass(frozen=True)
class ContigSigConfig:
    """Contig-signature extraction + pairing -> GT
    (reference: Dippav/extract_contig_signature_{CCS,CLR,ONT}.py)."""

    min_sv_size: int = 30
    min_mapq_cigar: int = 50            # CCS :679
    min_mapq_split: int = 50            # CCS :680
    # greedy clustering (cluster_del :157-210 / cluster_ins :212-249)
    max_shift: int = 100
    min_overlap_frac: float = 0.5
    min_size_sim: float = 0.5
    # CLR noise gates (extract_contig_signature_CLR.py:12-31)
    clr_max_ins_pct: float = 0.13
    clr_min_match_run: int = 200
    # split-read geometry ratio (CLR r=0.3, ONT r=0.5; HIFI uses the
    # Diffolp-threshold rules instead)
    split_ratio: float = 0.3


@dataclasses.dataclass(frozen=True)
class FPFilterConfig:
    """Read-signature support filter (reference: Dippav/FP_filter_v1.py:132-137)."""

    max_comp_svlen: int = 250           # larger SVs auto-pass
    max_dist: int = 1000
    max_shift: int = 500
    min_size_sim: float = 0.3           # compare_sigs :56-69
    min_support: int = 1
    # tandem-array read-evidence arbitration (calling/array_arbitrate.py):
    # inside a detected repeat unit, spanning-read signature clusters
    # override contig calls that conflict with them (the reference's
    # reads-rescue shape, 5_post_processing/GT_impute.py)
    array_arbitrate: bool = True
    arb_min_support: int = 3


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    """Redundancy removal (reference: Dippav/remove_redundancy.py:246-252)."""

    ins_max_dist: int = 500
    ins_min_size_sim: float = 0.5
    ins_min_edit_sim: float = 0.5
    del_max_dist: int = 3000
    del_min_size_sim: float = 0.1
    del_min_recip_overlap: float = 0.0


@dataclasses.dataclass(frozen=True)
class CoverageFilterConfig:
    """Coverage-band filter: keep calls whose rel_cov = cov/svlen lies inside
    [median*lb, median*rb] (reference: filter_vcf_by_sig_cov_insdel.py:23-74 +
    filter_para.csv, asm='volcano' rows)."""

    ins_lower: float = 0.097
    ins_upper: float = 2.754
    del_lower: float = 0.2
    del_upper: float = 2.605


@dataclasses.dataclass(frozen=True)
class GTCorrectConfig:
    """HiFi genotype re-calling matching knobs; the per-(dtype, svtype)
    re-call thresholds live in refine/gt_correct.py::GT_PARAMS (ports of
    para/GT_correction_para_{Hifi,CLR,ONT}_{DEL,INS}.txt)."""

    size_boundary: int = 1000           # large/small SV split
    min_size_sim: float = 0.6           # match_varlist_siglist :356-357
    shift_factor: float = 2.3
    min_shift: int = 500


@dataclasses.dataclass(frozen=True)
class GTImputeConfig:
    """CLR/ONT genotype transfer from the read-based draft VCF
    (reference: 5_post_processing/GT_impute.py:42-76)."""

    max_dist: int = 1000
    min_size_sim: float = 0.5


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Seed-chain-extend aligner (replaces minimap2 for contig->ref and
    INS-seq remap; also powers overlap detection and dedup similarity)."""

    k: int = 15                         # minimizer k-mer size
    w: int = 10                         # minimizer window
    max_seed_hits: int = 64             # per-seed occurrence cap
    chain_max_pred: int = 64            # chaining DP lookback window
    chain_max_gap: int = 10_000
    chain_min_score: int = 40
    chain_min_anchors: int = 3
    chain_split_gap: int = 400   # split chains when both dq,dt exceed this
    flank_extend: int = 800             # max unanchored flank to DP-extend
    # asm-preset scoring (the reference aligns contigs with minimap2 -x asm5,
    # DipPAV_variant_call.py:103): a HIGH gap-open keeps a repeat-array indel
    # as ONE gap -- with a cheap open the DP splits it across unit boundaries
    # wherever a stray match exists, fragmenting the SV signature
    match: int = 2
    mismatch: int = -8
    gap_open: int = -24
    gap_extend: int = -2


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for region-data-parallel execution."""

    data_axis: str = "regions"
    # regions per device per dispatch step (keeps the device working set
    # small; not yet re-sized for the GPU)
    regions_per_device: int = 8


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How the per-region hot path executes (pipeline/device_exec.py).

    "device": regions are bucketized into fixed-shape pileup tiles and
    phasing + consensus run as batched compiled kernels (one dispatch per
    bucket), with the aligner's gap DPs routed through the cross-thread DP
    batcher on accelerator backends.  "host": the per-region numpy path
    (pipeline/region.py), one region at a time.
    """

    mode: str = "device"                # "device" | "host"
    # device working-set budget per dispatch (priced per encoding in
    # device_exec._batch_size; the dense kernel's lax.map bounds the live
    # expansion to 8 regions at a time, so for dense tiles this caps the
    # *transfer* batch).  Values not yet re-sized for the GPU (ROADMAP)
    batch_bytes: int = 512 << 20
    max_regions_per_batch: int = 16
    # tiles above these bounds fall back to the host per-region path
    max_tile_reads: int = 1024
    max_tile_len: int = 1 << 18
    # activate the cross-thread DP batcher (parallel/batch_executor.py) so
    # concurrent gap DPs run as one device batch; None = auto (on for the
    # GPU backend)
    dp_batching: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration: one preset per data type."""

    data_type: DataType = DataType.HIFI
    detect: RegionDetectConfig = RegionDetectConfig()
    read_scan: ReadScanConfig = ReadScanConfig()
    phasing: PhasingConfig = PhasingConfig()
    assembly: AssemblyConfig = AssemblyConfig()
    contig_sig: ContigSigConfig = ContigSigConfig()
    fp_filter: FPFilterConfig = FPFilterConfig()
    dedup: DedupConfig = DedupConfig()
    coverage_filter: CoverageFilterConfig = CoverageFilterConfig()
    gt_correct: GTCorrectConfig = GTCorrectConfig()
    gt_impute: GTImputeConfig = GTImputeConfig()
    align: AlignConfig = AlignConfig()
    mesh: MeshConfig = MeshConfig()
    execution: ExecutionConfig = ExecutionConfig()

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def preset(data_type: DataType | str) -> PipelineConfig:
    """Build the per-dtype preset mirroring the reference's hard-coded blocks."""

    if isinstance(data_type, str):
        data_type = DataType(data_type.upper())

    if data_type == DataType.HIFI:
        return PipelineConfig(
            data_type=DataType.HIFI,
            detect=RegionDetectConfig(dt_fine=500, min_sig=1),
            read_scan=ReadScanConfig(
                max_cluster_bias_ins=1000,
                diff_ratio_merging_ins=0.9,
                max_cluster_bias_del=1000,
                diff_ratio_merging_del=0.5,
            ),
            assembly=AssemblyConfig(polish_rounds=1),
            contig_sig=ContigSigConfig(split_ratio=0.3),
            coverage_filter=CoverageFilterConfig(
                ins_lower=0.097, ins_upper=2.754,
                del_lower=0.2, del_upper=2.605),
        )
    if data_type == DataType.CLR:
        return PipelineConfig(
            data_type=DataType.CLR,
            detect=RegionDetectConfig(dt_fine=200, min_sig=5),
            # ~12% read error: low-depth columns with 2 coincident errors
            # pass the HiFi het band and randomize MEC -- demand real support
            phasing=PhasingConfig(min_site_depth=10, min_minor_count=4),
            read_scan=ReadScanConfig(
                max_cluster_bias_ins=100,
                diff_ratio_merging_ins=0.3,
                max_cluster_bias_del=200,
                diff_ratio_merging_del=0.5,
            ),
            assembly=AssemblyConfig(polish_rounds=3, clip_merge_k=9,
                                    clip_merge_w=5, clip_merge_max_err=0.45),
            contig_sig=ContigSigConfig(split_ratio=0.3),
            coverage_filter=CoverageFilterConfig(
                ins_lower=0.075, ins_upper=2.383,
                del_lower=0.186, del_upper=3.018),
        )
    if data_type == DataType.ONT:
        return PipelineConfig(
            data_type=DataType.ONT,
            detect=RegionDetectConfig(dt_fine=500, min_sig=5),
            phasing=PhasingConfig(min_site_depth=8, min_minor_count=3),
            read_scan=ReadScanConfig(
                max_cluster_bias_ins=100,
                diff_ratio_merging_ins=0.3,
                max_cluster_bias_del=100,
                diff_ratio_merging_del=0.3,
            ),
            assembly=AssemblyConfig(polish_rounds=3, clip_merge_k=9,
                                    clip_merge_w=5, clip_merge_max_err=0.4),
            contig_sig=ContigSigConfig(split_ratio=0.5),
            coverage_filter=CoverageFilterConfig(
                ins_lower=0.206, ins_upper=2.79,
                del_lower=0.242, del_upper=2.77),
        )
    raise ValueError(f"unknown data type: {data_type}")
