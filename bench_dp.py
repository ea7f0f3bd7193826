"""Banded-DP benchmark on the GPU: the Pallas-Triton kernel
(ops/align_gpu.py) against XLA's lax.scan formulation
(ops/align.py::banded_align_batch), at the kernel and end to end.

- shapes: the DP batcher's own -- batch 128, _pad_bucket query/target
  lengths 1024/4096/16384, band_bucket widths 128/512/2048.  Each timing is
  the median of --reps warm calls ending in block_until_ready; the first
  call's wall time (compile included) is reported beside it.  Each kernel
  result is checked byte for byte against the scan where the scan ran.
- e2e: the CLI in target mode with de-novo OLC assembly (the path that
  feeds the DP batcher) over chip_smoke.py's OLC set (its first four HiFi
  regions, 15/30/50/100 kb), with the kernel and with the scan forced: one
  cold run of each, then --e2e-pairs warm pairs in alternating order
  (kernel-scan, scan-kernel, ...).  Every run is printed, then each side's
  median, min and max; the VCFs must agree.

Usage: python bench_dp.py [--parts shapes,e2e] [--lengths ...]
Prints one JSON line per measurement.  Fails when JAX finds no GPU.
"""

import argparse
import json
import sys
import time

import chip_smoke as cs


def timed(fn, reps: int):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, sorted(ts)[len(ts) // 2]


def bench_shapes(lengths, bands, reps: int, scan_max_cells: int
                 ) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from focalsv_tpu.ops import align as alignops
    from focalsv_tpu.ops.align_gpu import banded_align_batch_gpu
    rows = []
    for L in lengths:
        for W in bands:
            args = [jnp.asarray(a) for a in cs.dp_batch(L + W, 128, L, W)]
            (s_k, d_k), k_first, k_s = timed(
                lambda: banded_align_batch_gpu(*args, band=W), reps)
            cells = int(jnp.sum(args[1])) * W
            row = {"batch": 128, "length": L, "band": W,
                   "kernel_s": k_s, "kernel_first_s": k_first,
                   "kernel_gcells_per_s": cells / k_s / 1e9}
            if L * W <= scan_max_cells:
                (s_s, d_s), s_first, s_s_t = timed(
                    lambda: alignops.banded_align_batch(*args, band=W), reps)
                row.update(scan_s=s_s_t, scan_first_s=s_first,
                           speedup=s_s_t / k_s,
                           identical=bool(jnp.array_equal(s_k, s_s))
                           and bool(jnp.array_equal(d_k, d_s)))
                del s_s, d_s
            rows.append(row)
            print(json.dumps(row), flush=True)
            del s_k, d_k
    return rows


def bench_e2e(n_regions: int, n_pairs: int) -> list[dict]:
    import os
    import shutil
    import statistics

    from focalsv_tpu.ops import align as alignops
    work = os.path.join(cs.ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    data = {"HIFI": cs.simulate_chromosome(work, "HIFI", n_regions, 0)}
    kernel_rule = alignops.use_gpu_kernel
    order = ["kernel", "scan"]
    for p in range(n_pairs):
        order += ["kernel", "scan"] if p % 2 == 0 else ["scan", "kernel"]
    rows, vcfs = [], []
    try:
        for k, which in enumerate(order):
            alignops.use_gpu_kernel = (kernel_rule if which == "kernel"
                                       else lambda band, store_dirs: False)
            dt, vcf, c = cs.run_cli(data, "HIFI",
                                    os.path.join(work, f"run{k}"), "device",
                                    assembly="olc")
            vcfs.append(vcf)
            row = {"dp": which, "warm": k >= 2, "wall_s": dt,
                   "dp_device_jobs": c.get("dp_device_jobs", 0),
                   "dp_device_batches": c.get("dp_device_batches", 0),
                   "dp_native_jobs": c.get("dp_native_jobs", 0),
                   "n_regions": c.get("n_regions")}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        alignops.use_gpu_kernel = kernel_rule
        shutil.rmtree(work, ignore_errors=True)
    same = all(v == vcfs[0] for v in vcfs)
    summary = {"e2e_vcf_identical": same}
    for which in ("kernel", "scan"):
        w = [r["wall_s"] for r in rows if r["warm"] and r["dp"] == which]
        summary[which] = {"median_s": statistics.median(w), "min_s": min(w),
                          "max_s": max(w), "runs": len(w)}
    print(json.dumps(summary), flush=True)
    return [dict(r, identical=same) for r in rows]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="1024,4096,16384")
    ap.add_argument("--bands", default="128,512,2048")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scan-max-cells", type=int, default=16384 * 2048,
                    help="time the lax.scan version only where length x "
                         "band is at most this")
    ap.add_argument("--parts", default="shapes,e2e")
    ap.add_argument("--e2e-regions", type=int, default=4)
    ap.add_argument("--e2e-pairs", type=int, default=4)
    args = ap.parse_args()
    parts = args.parts.split(",")
    import jax
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()}",
              file=sys.stderr)
        return 1
    for line in cs.card_lines():
        print(line, flush=True)
    rows = []
    if "shapes" in parts:
        rows += bench_shapes([int(x) for x in args.lengths.split(",")],
                             [int(x) for x in args.bands.split(",")],
                             args.reps, args.scan_max_cells)
    if "e2e" in parts:
        rows += bench_e2e(args.e2e_regions, args.e2e_pairs)
    ok = all(r.get("identical", True) for r in rows)
    d = jax.devices()[0]
    print(json.dumps({"ok": ok, "device": {"platform": d.platform,
                                           "kind": d.device_kind,
                                           "count": len(jax.devices())}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
