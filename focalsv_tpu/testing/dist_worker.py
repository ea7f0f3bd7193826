"""Subprocess worker for REAL multi-process jax.distributed runs.

Each worker is one jax process (CPU backend, gloo cross-process
collectives).  With every worker started, `jax.process_count() ==
process_count` holds inside run_target_mode, so the production
collective-gather branch (pipeline/main.py -- allgather_records over
device collectives) executes for real, not via the file-merge fallback.

Reference contrast: the reference's multi-node story is one SLURM job per
chromosome plus `cat | vcf-sort` (README.md:207-213); this worker is the
per-host entry of the accelerator replacement (SURVEY.md section 2.3).

Used by tests/test_distributed_gather.py; also usable manually:

    python -m focalsv_tpu.testing.dist_worker --pid 0 --nprocs 2 \
        --port 12345 --bam r.bam --ref ref.fa --bed t.bed --out outdir
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--coordinator", default="localhost")
    ap.add_argument("--bam", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--bed", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="HIFI")
    args = ap.parse_args()

    import jax

    # the CPU backend must be pinned BEFORE backend init (the workers
    # stay off any card), and cross-process CPU collectives need the gloo
    # implementation
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"{args.coordinator}:{args.port}",
        num_processes=args.nprocs, process_id=args.pid)
    assert jax.process_count() == args.nprocs, jax.process_count()

    from focalsv_tpu.config import preset
    from focalsv_tpu.pipeline.main import run_target_mode

    cfg = preset(args.dtype)
    path = run_target_mode(args.bam, args.ref, args.out, cfg,
                           target_bed=args.bed,
                           process_index=args.pid,
                           process_count=args.nprocs)
    print(f"FINAL:{path}", flush=True)


if __name__ == "__main__":
    main()
