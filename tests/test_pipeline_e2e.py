import numpy as np
import pytest

from focalsv_tpu.config import DataType, preset
from focalsv_tpu.evaluation.compare import match_records, truth_from_sim
from focalsv_tpu.phasing.phase import group_reads_by_block, phase_region
from focalsv_tpu.pipeline.region import process_region
from focalsv_tpu.testing import simulate as sim


def test_phasing_recovers_haplotypes():
    region = sim.simulate_region(seed=5, ref_len=25_000, coverage=25, n_snps=25)
    pr = phase_region(region.reads, region.ref, 0, preset(DataType.HIFI).phasing)
    assert pr.n_sites >= 10
    phased = pr.hp > 0
    assert phased.mean() > 0.8
    # phasing must be consistent with the simulated haplotype of origin
    truth = np.array(region.read_hap)
    hp = pr.hp[phased]
    th = truth[phased]
    agree = (hp - 1 == th).mean()
    assert max(agree, 1 - agree) > 0.95, f"phasing agreement {agree}"


def test_group_reads_unphased_duplication():
    region = sim.simulate_region(seed=6, ref_len=15_000, coverage=12, n_snps=0)
    pr = phase_region(region.reads, region.ref, 0, preset(DataType.HIFI).phasing)
    groups = group_reads_by_block(region.reads, pr)
    # no SNPs -> no phasing -> single unphased group
    assert (-1, 0) in groups or len(groups) > 0


@pytest.mark.parametrize("dtype,err", [
    (DataType.HIFI, dict(sub_rate=0.002)),
    (DataType.CLR, dict(sub_rate=0.06, ins_rate=0.03, del_rate=0.03)),
    (DataType.ONT, dict(sub_rate=0.04, ins_rate=0.02, del_rate=0.02)),
])
def test_region_end_to_end(dtype, err):
    region = sim.simulate_region(seed=7, ref_len=30_000, coverage=24,
                                 n_snps=25, **err)
    cfg = preset(dtype)
    res = process_region(region.reads, region.ref, 0, region.chrom, cfg)
    truth = truth_from_sim(region.svs, region.chrom, region.ref)
    bench = match_records(res.records, truth, check_seq=(dtype == DataType.HIFI))
    assert bench.recall == 1.0, (
        f"recall {bench.recall}: calls="
        f"{[(r.info['SVTYPE'], r.pos, r.info['SVLEN'], r.gt) for r in res.records]}")
    assert bench.precision >= 0.5, (
        f"precision {bench.precision}: calls="
        f"{[(r.info['SVTYPE'], r.pos, r.info['SVLEN'], r.gt) for r in res.records]}")
    assert bench.gt_concordance == 1.0


def test_region_end_to_end_many_svs():
    rng = np.random.default_rng(99)
    ref_len = 60_000
    ref = sim.random_seq(rng, ref_len)
    svs = [
        sim.SimSV("DEL", 9_000, 120, "0/1"),
        sim.SimSV("INS", 21_000, 90, "0/1", seq=sim.random_seq(rng, 90)),
        sim.SimSV("DEL", 33_000, 800, "1/1"),
        sim.SimSV("INS", 47_000, 600, "1/1", seq=sim.random_seq(rng, 600)),
    ]
    region = sim.simulate_region(seed=100, ref_len=ref_len, coverage=25,
                                 n_snps=40, svs=svs, sub_rate=0.002)
    region.ref = region.ref  # ref regenerated inside; use region's own
    cfg = preset(DataType.HIFI)
    res = process_region(region.reads, region.ref, 0, region.chrom, cfg)
    truth = truth_from_sim(region.svs, region.chrom, region.ref)
    bench = match_records(res.records, truth)
    assert bench.recall == 1.0, (
        f"recall {bench.recall} calls="
        f"{[(r.info['SVTYPE'], r.pos, r.info['SVLEN'], r.gt) for r in res.records]}")
    assert bench.precision >= 0.8


def test_ont_large_het_ins_with_clipped_reads():
    """A ~1.9 kb het INS under the ONT error model: many reads are clipped
    inside the inserted sequence, so the insertion vote must use spanning
    reads as its denominator (raw column coverage under-votes large INS)."""
    rng = np.random.default_rng(4023)
    svs = [
        sim.SimSV("INS", 6_976, 1_916, "0/1",
                  seq=rng.integers(0, 4, 1_916).astype(np.uint8)),
        sim.SimSV("DEL", 19_805, 281, "0/1"),
    ]
    region = sim.simulate_region(seed=4023, ref_len=30_000, n_snps=25,
                                 svs=svs, coverage=28, sub_rate=0.04,
                                 ins_rate=0.02, del_rate=0.02)
    cfg = preset(DataType.ONT)
    res = process_region(region.reads, region.ref, 0, region.chrom, cfg)
    truth = truth_from_sim(region.svs, region.chrom, region.ref)
    bench = match_records(res.records, truth, check_seq=False)
    assert bench.recall == 1.0, (
        f"recall {bench.recall}; calls="
        f"{[(r.info['SVTYPE'], r.pos, r.info['SVLEN'], r.gt) for r in res.records]}")
    assert bench.gt_concordance == 1.0


@pytest.mark.parametrize("svtype,length,gt", [
    ("INS", 5_000, "0/1"),
    ("INS", 8_000, "1/1"),
    ("DEL", 15_000, "0/1"),
])
def test_large_sv_recovery(svtype, length, gt):
    # SVs needing DP bands wider than the GPU kernel's cap (ops/align.py
    # GPU_MAX_BAND) must route through the scan kernel and still call
    # exactly.
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 4, length).astype(np.uint8) if svtype == "INS" else None
    svs = [sim.SimSV(svtype, 25_000 if svtype == "INS" else 20_000,
                     length, gt, seq=seq)]
    r = sim.simulate_region(seed=55, ref_len=60_000, coverage=22, n_snps=40,
                            svs=svs, sub_rate=0.002)
    res = process_region(r.reads, r.ref, 0, r.chrom, preset("HIFI"))
    assert len(res.records) == 1, [(x.pos, x.info) for x in res.records]
    rec = res.records[0]
    assert rec.info["SVTYPE"] == svtype
    assert abs(abs(rec.info["SVLEN"]) - length) <= length * 0.01
    assert rec.gt == gt


@pytest.mark.parametrize("dtype,err,svtype,length", [
    ("CLR", dict(sub_rate=0.06, ins_rate=0.03, del_rate=0.03), "DEL", 8_000),
    ("CLR", dict(sub_rate=0.06, ins_rate=0.03, del_rate=0.03), "INS", 8_000),
    ("ONT", dict(sub_rate=0.04, ins_rate=0.02, del_rate=0.02), "INS", 5_000),
])
def test_large_sv_noisy_dtypes(dtype, err, svtype, length):
    # Noise-era regression: error-pileup columns inside the het-DEL zone
    # used to pass the het test, randomize the MEC init chain's parity, and
    # fragment the deletion into pieces (fixed by phase.purify_sites'
    # 3-sigma co-phasing gate + per-dtype min_minor_count presets).
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 4, length).astype(np.uint8) if svtype == "INS" else None
    svs = [sim.SimSV(svtype, 25_000, length, "0/1", seq=seq)]
    r = sim.simulate_region(seed=55, ref_len=60_000, coverage=25, n_snps=40,
                            svs=svs, **err)
    res = process_region(r.reads, r.ref, 0, r.chrom, preset(dtype))
    assert len(res.records) == 1, [(x.pos, x.info) for x in res.records]
    rec = res.records[0]
    assert rec.info["SVTYPE"] == svtype
    assert abs(abs(rec.info["SVLEN"]) - length) <= length * 0.02
    assert rec.gt == "0/1"
