"""Smoke test of the device path on the GPU: the quickest proof that the
system starts on the card and gives the host path's answers.

    python chip_smoke.py            # one card, phases a-d
    python chip_smoke.py --four     # four cards: the sharded run only

Phases (one card):

a. backend: JAX must run on a GPU; there is no CPU fallback.
b. banded DP: the shipped DP (ops/align.py::banded_align) at the DP
   batcher's shapes -- batch 128, query/target buckets 1024/4096/16384,
   bands 128/512/2048, plus one ragged batch -- against the native host DP
   (same band semantics), and a small batch against the full-matrix numpy
   DP.  Scores and direction bytes must match exactly.
c. region step: one delta bucket (HiFi) and one dense bucket (CLR) through
   the device phasing + consensus step, finished on host, against the host
   per-region path byte for byte; and the step's f32 balance ratios on the
   card against numpy's division (they must be correctly rounded).
d. end to end through the CLI entry (target mode): one simulated
   chromosome of concatenated regions per preset -- HiFi 48 regions cycling
   15/30/50/100 kb, CLR and ONT 12 each -- run with --execution device
   (twice: cold, warm) and --execution host; the VCF records must be
   identical.  HiFi must take only delta tiles and CLR/ONT only dense
   rows.  A de-novo OLC run over four HiFi regions drives the banded DP
   through the DP batcher.  Fails on any failed region, any host-fallback
   tile, or zero DP jobs run on the device.  One more ONT chromosome at
   ~8% substitutions (the encoding boundary) runs once in device mode
   against host mode; its host-fallback tiles are reported, not failed.

--four runs only the sharded path: the HiFi chromosome through the CLI in
device mode on a 4-card mesh (cold, warm), against host mode, record for
record, with the real regions in each card's share of the padded chunks.

Earlier lines report the card (nvidia-smi name and power limit), each
phase's cold and warm wall time, the DP jobs on the device and on the
native host kernel, host-fallback tiles and failed regions.  The last line
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
The script exits non-zero, without that line, when any phase fails or JAX
finds no GPU.  Data are simulated from --seed into a work directory inside
the checkout, removed at the end.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE_MIX = (15_000, 30_000, 50_000, 100_000)   # bench.py's region size mix
# CLR and ONT: per-base totals of about 13% and 12%, chosen so every tile
# takes the dense-row encoding.  The simulator injects indel errors once
# per 32-base step, so the totals come from substitutions.  At
# bench_accuracy.py's 6%/4% the tile builder picks the delta encoding.
# ONT8 (~8% substitutions) sits at the encoding boundary: its tiles split
# between the two encodings, and a noisy delta tile can overflow the delta
# kernel's run budget, which finishes it on host.  Its run reports
# n_host_fallback and is not failed for it.
READ_ERRORS = {"HIFI": dict(sub_rate=0.002),
               "CLR": dict(sub_rate=0.13, ins_rate=0.03, del_rate=0.03),
               "ONT": dict(sub_rate=0.12, ins_rate=0.02, del_rate=0.02),
               "ONT8": dict(sub_rate=0.08, ins_rate=0.02, del_rate=0.02)}
N_REGIONS = {"HIFI": 48, "CLR": 12, "ONT": 12, "ONT8": 12}
DATA_TYPE = {"ONT8": "ONT"}       # data set -> --data_type, if not its name
DP_LENGTHS = (1024, 4096, 16384)
DP_BANDS = (128, 512, 2048)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def simulate_chromosome(workdir: str, dtype: str, n_regions: int, seed: int,
                        sizes=SIZE_MIX, coverage: float = 30.0):
    """One chromosome of concatenated regions (each simulated on its own,
    bench_auto.py's chunked layout), sizes cycling through ``sizes``, about
    one SV per 15 kb.  Writes reads.bam (+.bai), ref.fa and targets.bed
    into workdir/<dtype>; returns (bam, fasta, bed) paths."""
    import numpy as np

    from focalsv_tpu.io import bam as bamio
    from focalsv_tpu.io.fasta import write_fasta
    from focalsv_tpu.testing import simulate as sim
    d = os.path.join(workdir, dtype.lower())
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    parts, recs, bed = [], [], []
    off = 0
    for i in range(n_regions):
        L = sizes[i % len(sizes)]
        n_sv = max(1, L // 15_000)
        span = (L - 6_000) // n_sv
        svs = []
        for s in range(n_sv):
            length = int(np.exp(rng.uniform(np.log(60), np.log(3_000))))
            pos = 3_000 + s * span + int(rng.integers(0, max(1, span - length
                                                              - 500)))
            svtype = "DEL" if rng.random() < 0.5 else "INS"
            seq = (rng.integers(0, 4, length).astype(np.uint8)
                   if svtype == "INS" else None)
            svs.append(sim.SimSV(svtype, pos, length,
                                 "0/1" if rng.random() < 0.5 else "1/1",
                                 seq=seq))
        region = sim.simulate_region(
            seed=seed * 1000 + i, ref_len=L, coverage=coverage,
            n_snps=L // 1_200, svs=svs, chrom="chr1", **READ_ERRORS[dtype])
        for rec in region.reads:
            rec.pos += off
            recs.append(rec)
        parts.append(region.ref)
        bed.append(f"chr1\t{off + 100}\t{off + L - 100}\n")
        off += L
    recs.sort(key=lambda r: r.pos)
    bam = os.path.join(d, "reads.bam")
    w = bamio.BamWriter(bam, ["chr1"], [off])
    for rec in recs:
        w.write(rec)
    w.close()
    bamio.build_bai(bam)
    fasta = os.path.join(d, "ref.fa")
    write_fasta(fasta, [("chr1", np.concatenate(parts))])
    bed_path = os.path.join(d, "targets.bed")
    with open(bed_path, "w") as f:
        f.writelines(bed)
    return bam, fasta, bed_path


# ---------------------------------------------------------------------------
# phase b: banded DP
# ---------------------------------------------------------------------------


def dp_batch(seed: int, B: int, L: int, W: int, ragged: bool = False):
    """B pairs padded to L (the batcher's _pad_bucket shape): substitution
    runs, deletions and leading insertions; lengths near L, or spread over
    [L/4, L] with mixed d_lo when ``ragged``.  d_lo as the batcher picks
    it, so every endpoint is in band."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    q = t.copy()
    for b in range(B):
        i0 = int(rng.integers(10, L // 2))
        ln = int(rng.integers(1, min(W // 4, 200)))
        if b % 3 == 0:
            q[b, i0 : i0 + ln] = rng.integers(0, 4)
        elif b % 3 == 1:
            q[b] = np.concatenate([np.delete(q[b], slice(i0, i0 + ln)),
                                   np.full(ln, 5, np.uint8)])
        else:
            q[b] = np.concatenate(
                [rng.integers(0, 4, ln).astype(np.uint8), q[b][: L - ln]])
    lo = L // 4 if ragged else L - L // 8
    t_len = rng.integers(lo, L + 1, B).astype(np.int32)
    q_len = np.clip(t_len - rng.integers(-W // 4, W // 4, B), 1,
                    L).astype(np.int32)
    d_lo = np.clip((t_len - q_len) // 2 - W // 2,
                   t_len - q_len - W + 1, 0).astype(np.int32)
    if ragged:
        # shift some bands off-centre while keeping the endpoint in band
        d_lo = np.clip(d_lo + rng.integers(-W // 4, W // 4, B),
                       t_len - q_len - W + 1, 0).astype(np.int32)
    return q, q_len, t, t_len, d_lo


def native_reference(args, W: int, scoring: dict):
    """Per-pair native host DP (threads: the C++ call releases the GIL)."""
    from focalsv_tpu import native
    q, q_len, t, t_len, d_lo = args

    def one(b):
        res = native.affine_banded_align(
            q[b, : q_len[b]], t[b, : t_len[b]], int(d_lo[b]), W,
            scoring["match"], scoring["mismatch"], scoring["gap_open"],
            scoring["gap_extend"])
        check(res is not None, "native host DP library unavailable")
        return res

    with ThreadPoolExecutor(max(1, min(16, os.cpu_count() or 1))) as ex:
        return list(ex.map(one, range(len(q_len))))


def compare_dp(args, scores, dirs, ref, label: str) -> None:
    import numpy as np
    q_len = args[1]
    for b, (r_score, r_dirs) in enumerate(ref):
        n = int(q_len[b])
        check(int(scores[b]) == r_score,
              f"{label}: pair {b} score {int(scores[b])} != {r_score}")
        check(np.array_equal(dirs[b, :n], r_dirs[:n]),
              f"{label}: pair {b} direction bytes differ")
        check(not dirs[b, n:].any(), f"{label}: pair {b} rows past q_len")


def phase_dp() -> None:
    import jax
    import numpy as np

    from focalsv_tpu.ops import align as alignops
    scoring = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
    shapes = [(L, W, False) for L in DP_LENGTHS for W in DP_BANDS]
    shapes.append((4096, 512, True))
    for L, W, ragged in shapes:
        label = f"dp L={L} W={W}" + (" ragged" if ragged else "")
        args = dp_batch(L + W + ragged, 128, L, W, ragged=ragged)
        times = []
        for _ in range(2):                       # cold (compile), warm
            t0 = time.perf_counter()
            scores, dirs = jax.block_until_ready(
                alignops.banded_align(*args, band=W, **scoring))
            times.append(time.perf_counter() - t0)
        scores, dirs = np.asarray(scores), np.asarray(dirs)
        compare_dp(args, scores, dirs, native_reference(args, W, scoring),
                   label)
        cells = int(args[1].sum()) * W
        say(f"{label}: identical to native; cold {times[0]:.3f} s warm "
            f"{times[1]:.4f} s ({cells / times[1] / 1e9:.2f} Gcells/s), "
            f"gpu kernel: {alignops.use_gpu_kernel(W, True)}")
        del dirs
    # small pairs against the full-matrix DP (independent of the band)
    rng = np.random.default_rng(5)
    q = np.full((8, 256), 5, np.uint8)
    t = np.full((8, 256), 5, np.uint8)
    pairs = []
    for b in range(8):
        tt = rng.integers(0, 4, int(rng.integers(120, 200))).astype(np.uint8)
        qq = np.delete(tt, slice(40, 40 + int(rng.integers(1, 30))))
        qq[90:93] = rng.integers(0, 4, 3)
        q[b, : len(qq)], t[b, : len(tt)] = qq, tt
        pairs.append((qq, tt))
    q_len = np.array([len(p[0]) for p in pairs], np.int32)
    t_len = np.array([len(p[1]) for p in pairs], np.int32)
    d_lo = np.clip((t_len - q_len) // 2 - 64, t_len - q_len - 127,
                   0).astype(np.int32)
    scores, dirs = alignops.banded_align(q, q_len, t, t_len, d_lo, band=128,
                                         **scoring)
    for b, (qq, tt) in enumerate(pairs):
        r_score, r_cig, _ = alignops.align_numpy(qq, tt, **scoring)
        check(int(scores[b]) == r_score, f"dp small pair {b} score")
        check(alignops.traceback(np.asarray(dirs[b]), len(qq), len(tt),
                                 int(d_lo[b])) == r_cig,
              f"dp small pair {b} cigar")
    say("dp small pairs: identical to the full-matrix numpy DP")


# ---------------------------------------------------------------------------
# phase c: region step
# ---------------------------------------------------------------------------


def _region_equal(h, d, label: str) -> None:
    import numpy as np
    check(np.array_equal(h.phase_hp, d.phase_hp), f"{label}: hp")
    check(np.array_equal(h.phase_ps, d.phase_ps), f"{label}: ps")
    for a, b in ((h.contigs_hp1, d.contigs_hp1),
                 (h.contigs_hp2, d.contigs_hp2)):
        check(sorted(a) == sorted(b), f"{label}: contig names")
        for name in a:
            check(np.array_equal(a[name], b[name]), f"{label}: {name}")
    rec = lambda rs: [(r.pos, r.ref, r.alt, r.gt) for r in rs]  # noqa: E731
    check(rec(h.records) == rec(d.records), f"{label}: SV records")
    snv = lambda rs: [(r.pos, r.ref, r.alt, r.gt, r.info.get("PS"))  # noqa
                      for r in rs]
    check(snv(h.snv_records) == snv(d.snv_records), f"{label}: SNV records")


def phase_region_step(data: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from focalsv_tpu.config import preset
    from focalsv_tpu.io import bam as bamio
    from focalsv_tpu.io.bed import read_bed
    from focalsv_tpu.io.fasta import FastaFile
    from focalsv_tpu.pipeline import device_exec as dx
    from focalsv_tpu.pipeline.region import process_region

    # the step's balance ratios on the card against numpy's IEEE f32
    # division, for every count pair a tile can hold; XLA's own f32 divide
    # is reported beside it (it is not correctly rounded on the GPU)
    from focalsv_tpu.parallel.region_step import _ratio_f32
    q = np.repeat(np.arange(1, 1025, dtype=np.int32), np.arange(2, 1026))
    p = np.concatenate([np.arange(0, n + 1, dtype=np.int32)
                        for n in range(1, 1025)])
    want = (p.astype(np.float32) / q.astype(np.float32)).view(np.int32)
    got = np.asarray(jax.jit(_ratio_f32)(p, q)).view(np.int32)
    xla = np.asarray(jax.jit(lambda a, b: a.astype(jnp.float32)
                             / b.astype(jnp.float32))(p, q)).view(np.int32)
    check(np.array_equal(got, want), "region-step ratios differ from numpy")
    say(f"f32 ratios: {p.size} region-step quotients identical to numpy; "
        f"XLA's f32 divide differs in {int((xla != want).sum())}")
    for dtype, n, want in (("HIFI", 4, "delta"), ("CLR", 2, "dense")):
        cfg = preset(dtype)
        bam_path, fa_path, bed_path = data[dtype]
        bam = bamio.ensure_indexed(bam_path)
        fasta = FastaFile.load(fa_path)
        tiles, hosts = [], []
        for r in read_bed(bed_path)[:n]:
            reads = list(bam.fetch(r.chrom, r.start, r.end))
            ref = fasta.fetch(r.chrom, r.start, r.end)
            tiles.append(dx.build_tile(reads, ref, r.start, r.chrom, cfg))
            hosts.append(process_region(reads, ref, r.start, r.chrom, cfg))
        keys = {dx._bucket_key(t, cfg) for t in tiles}
        check(all(k is not None and k[0] == want for k in keys),
              f"{dtype} tiles are not all {want}: {keys}")
        times = []
        for _ in range(2):                       # cold (compile), warm
            t0 = time.perf_counter()
            devs = dx.run_device_step(tiles, cfg)
            times.append(time.perf_counter() - t0)
        check(len(devs) == len(tiles), f"{dtype}: a tile left the device")
        for i, (tile, h) in enumerate(zip(tiles, hosts)):
            d = dx.finish_tile(tile, devs[i], cfg)
            _region_equal(h, d, f"{dtype} region {i}")
        say(f"region step {want} ({dtype}, buckets {sorted(keys)}): "
            f"{len(tiles)} regions identical to host; cold {times[0]:.2f} s "
            f"warm {times[1]:.3f} s")


# ---------------------------------------------------------------------------
# phase d: end to end through the CLI
# ---------------------------------------------------------------------------


def vcf_records(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


def run_cli(data, dtype: str, out_dir: str, execution: str,
            assembly: str | None = None, bed: str | None = None):
    """One CLI target-mode run; returns (wall s, VCF records, counters)."""
    from focalsv_tpu.pipeline import cli
    bam, fasta, bed_path = data[dtype]
    argv = ["--bam_file", bam, "--ref_file", fasta, "--out_dir", out_dir,
            "--data_type", DATA_TYPE.get(dtype, dtype),
            "--target_bed", bed or bed_path,
            "--execution", execution,
            "--num_threads", str(max(4, min(16, os.cpu_count() or 4)))]
    if assembly:
        argv += ["--assembly", assembly]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"CLI {dtype} {execution} returned {rc}")
    counters: dict = {}
    for p in glob.glob(os.path.join(out_dir, "*", "log", "stage_times.json")):
        with open(p) as f:
            for k, v in json.load(f).get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
    return dt, vcf_records(os.path.join(out_dir, "FocalSV_Final_SV.vcf")), \
        counters


def e2e(data, dtype: str, work: str, label: str, *, warm: bool = True,
        assembly: str | None = None, bed: str | None = None,
        encoding: str | None = None, allow_fallback: bool = False) -> dict:
    """Device run(s) against the host run of one data set; returns the last
    device run's counters.  Host-fallback tiles fail the run unless
    ``allow_fallback``."""
    runs = []
    for k in range(2 if warm else 1):
        runs.append(run_cli(data, dtype, os.path.join(work, f"{label}_dev{k}"),
                            "device", assembly, bed))
    h_dt, h_vcf, h_c = run_cli(data, dtype,
                               os.path.join(work, f"{label}_host"), "host",
                               assembly, bed)
    check(h_c.get("n_failed_regions", 0) == 0, f"{label}: host region failed")
    check(len(h_vcf) > 0, f"{label}: host run called no SVs")
    for k, (dt, vcf, c) in enumerate(runs):
        check(vcf == h_vcf, f"{label}: device run {k} VCF differs from host "
                            f"({len(vcf)} vs {len(h_vcf)} records)")
        check(c.get("n_failed_regions", 0) == 0,
              f"{label}: {c.get('n_failed_regions')} failed regions")
        check(allow_fallback or c.get("n_host_fallback", 0) == 0,
              f"{label}: {c.get('n_host_fallback')} host-fallback tiles")
        if encoding:
            other = "dense" if encoding == "delta" else "delta"
            check(c.get(f"n_chunks_{encoding}", 0) > 0
                  and c.get(f"n_chunks_{other}", 0) == 0,
                  f"{label}: chunks not all {encoding}: {c}")
    c = runs[-1][2]
    per_dev = [c.get(f"regions_dev{d}", 0) for d in range(c.get("n_devices",
                                                                   1))]
    say(f"e2e {label}: {c.get('n_regions')} regions, {len(h_vcf)} SV records "
        f"identical device vs host; device cold {runs[0][0]:.1f} s"
        + (f" warm {runs[1][0]:.1f} s" if warm else "")
        + f", host {h_dt:.1f} s; chunks delta {c.get('n_chunks_delta', 0)} "
        f"dense {c.get('n_chunks_dense', 0)} on {c.get('n_devices')} "
        f"device(s), regions per device {per_dev} in "
        f"{c.get('n_slots', 0)} slots; "
        f"failed regions {c.get('n_failed_regions')}, "
        f"n_host_fallback {c.get('n_host_fallback')}; DP device batches "
        f"{c.get('dp_device_batches', 0)} jobs {c.get('dp_device_jobs', 0)}, "
        f"native host jobs {c.get('dp_native_jobs', 0)}")
    return c


def phase_e2e(data, work: str) -> None:
    dp_jobs = 0
    for dtype, enc in (("HIFI", "delta"), ("CLR", "dense"), ("ONT", "dense")):
        dp_jobs += e2e(data, dtype, work, dtype.lower(),
                       encoding=enc).get("dp_device_jobs", 0)
    e2e(data, "ONT8", work, "ont8", warm=False, allow_fallback=True)
    olc_bed = os.path.join(work, "olc.bed")
    with open(data["HIFI"][2]) as f, open(olc_bed, "w") as g:
        g.writelines(f.readlines()[:4])
    dp_jobs += e2e(data, "HIFI", work, "hifi_olc", assembly="olc",
                   bed=olc_bed).get("dp_device_jobs", 0)
    check(dp_jobs > 0, "the DP batcher ran zero device jobs")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "host-mode comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not a GPU",
              file=sys.stderr)
        return 1
    from focalsv_tpu.pipeline.device_exec import _ensure_compile_cache
    _ensure_compile_cache()
    n_dev = len(jax.devices())
    if args.four and n_dev < 4:
        print(f"chip_smoke --four: {n_dev} GPU(s) visible", file=sys.stderr)
        return 1
    for line in card_lines():
        say(line)
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_all = time.perf_counter()
    try:
        from focalsv_tpu import native
        check(native.get_lib() is not None,
              "the native host library did not build")
        t0 = time.perf_counter()
        dtypes = ("HIFI",) if args.four else ("HIFI", "CLR", "ONT", "ONT8")
        data = {d: simulate_chromosome(work, d, N_REGIONS[d],
                                       args.seed + k)
                for k, d in enumerate(dtypes)}
        say(f"simulated {', '.join(f'{d} {N_REGIONS[d]}' for d in dtypes)} "
            f"regions in {time.perf_counter() - t0:.1f} s")
        if args.four:
            e2e(data, "HIFI", work, "hifi_4card", encoding="delta")
        else:
            phase_dp()
            phase_region_step(data)
            phase_e2e(data, work)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.four:
        for d in jax.devices():
            peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            say(f"device {d.id}: peak {peak / 2**30:.2f} GiB in use")
    say(f"total {time.perf_counter() - t_all:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
