"""Weak-scaling sweep of the sharded region step on a virtual device mesh.

The production scale-out design is one `jax.sharding.Mesh` with a single
'regions' axis spanning {hosts x chips} (SURVEY.md section 2.3): region
chunks shard on that axis, the phasing+consensus kernel runs under
shard_map, and per-region results gather back.  This harness measures the
STRUCTURE of the sharded program on the 8-device virtual CPU mesh (the
four-GPU path itself is checked by `chip_smoke.py --four`): a fixed per-device
region batch is dispatched at 1/2/4/8 devices and the per-region cost is
tracked.

Interpreting the numbers on a timeshared host: the N virtual devices share
`nproc` physical cores, so raw wall grows with N once N > nproc.  The
efficiency column therefore normalizes by occupied cores:

    cost_per_region(N) = wall(N) * min(N, nproc) / regions(N)
    efficiency(N)      = cost_per_region(1) / cost_per_region(N)

A sharded program with no cross-device serialization, no data-dependent
gathers, and no growing collective cost keeps cost_per_region flat (100%).
On real hardware min(N, nproc) = N and the same formula is the standard
weak-scaling efficiency.  The multi-device entry point is
`bench.py --mesh NxM` (see its --help), which runs the identical dispatch
path on jax.devices().

Writes one JSON document (default scaling.json) and prints it.
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="scaling.json")
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=8,
                    help="regions per device (weak scaling)")
    ap.add_argument("--ref-len", type=int, default=15_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    max_dev = max(args.devices)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={max_dev}")
    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import bench
    from focalsv_tpu.config import preset
    from focalsv_tpu.parallel import mesh as pmesh
    from focalsv_tpu.parallel import region_step as rs
    from focalsv_tpu.pipeline import device_exec as dx

    nproc = os.cpu_count() or 1
    cfg = preset("HIFI")

    # one bucket's worth of real simulated tiles (identical shape)
    tmp = os.path.join("/tmp", f"focalsv_scaling_l{args.ref_len}_c{int(args.coverage)}")
    os.makedirs(tmp, exist_ok=True)
    jobs = bench._make_jobs(tmp, 8, args.coverage, args.ref_len)
    tiles = []
    for j in jobs:
        reads, ref, chrom = bench._load_job(j)
        tiles.append(dx.build_tile(reads, ref, 0, chrom, cfg))
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    key = max(set(keys), key=keys.count)
    tiles = [t for t, k in zip(tiles, keys) if k == key]
    kw = rs.phase_consensus_kwargs(cfg.phasing)
    _, Rp, Lp, Ds, Dd = key
    kw["Drle"] = dx.drle_of(key)
    d2h_per_region = dx._d2h_bytes_per_region(key, cfg)

    rows = []
    t1_cost = None
    for n in args.devices:
        G = n * args.per_device
        chunk = [tiles[i % len(tiles)] for i in range(G)]
        buf = rs.pack_delta_chunk(chunk, list(range(G)), G, Rp, Lp, Ds, Dd)
        mesh = pmesh.make_mesh(n)

        def dispatch():
            if n > 1:
                out = rs.sharded_phase_consensus_delta_flat(
                    buf, mesh, G=G, R=Rp, L=Lp, Ds=Ds, Dd=Dd, **kw)
            else:
                out = rs.phase_consensus_delta_flat(
                    buf, G=G, R=Rp, L=Lp, Ds=Ds, Dd=Dd, **kw)
            jax.block_until_ready(out)
            return out

        dispatch()                       # compile
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            dispatch()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]
        cost = wall * min(n, nproc) / G
        if t1_cost is None:
            t1_cost = cost
        rows.append({
            "n_devices": n,
            "regions_per_dispatch": G,
            "wall_ms_median": round(wall * 1e3, 1),
            "wall_ms_min": round(min(walls) * 1e3, 1),
            "core_ms_per_region": round(cost * 1e3, 2),
            "efficiency_pct": round(100 * t1_cost / cost, 1),
            "h2d_bytes": int(buf.size),
            "d2h_bytes": int(G * d2h_per_region),
        })
        print(f"# n={n}: wall {wall*1e3:.1f} ms, "
              f"{rows[-1]['core_ms_per_region']} core-ms/region, "
              f"eff {rows[-1]['efficiency_pct']}%", file=sys.stderr)

    # n=1 runs without shard_map and XLA:CPU's intra-op pool can use every
    # core, deflating its per-region cost; the multi-device reference (the
    # smallest sharded N) is the honest baseline for scaling STRUCTURE
    multi = [r for r in rows if r["n_devices"] > 1]
    if multi:
        ref = multi[0]["core_ms_per_region"]
        for r in multi:
            r["efficiency_vs_smallest_sharded_pct"] = round(
                100 * ref / r["core_ms_per_region"], 1)
    doc = {
        "metric": "weak_scaling_sharded_region_step",
        "backend": "cpu-virtual-mesh",
        "nproc": nproc,
        "bucket": list(key),
        "per_device_regions": args.per_device,
        "normalization": "cost_per_region = wall * min(N, nproc) / regions;"
                         " efficiency = cost(1)/cost(N).  On this"
                         " timeshared host the flat core_ms_per_region"
                         " across sharded N (efficiency_vs_smallest_"
                         "sharded_pct ~100) is the scaling signal: the"
                         " sharded program adds no per-device"
                         " serialization or growing collective cost.",
        "real_pod_entry": "bench.py --mesh NxM",
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
