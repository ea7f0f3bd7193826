"""Collective SV-record gather: device all_gather instead of file merge.

The reference's multi-node story is "one SLURM job per chromosome into a
shared out_dir, then `cat | vcf-sort`" (README.md:207-213, focalsv.py:66-70)
-- the filesystem as the all-gather fabric.  Here the gather point rides the
accelerator interconnect: each host serializes its shard's VCF records into
one flat byte payload plus a per-record length vector, both are
all_gathered across processes via device collectives
(`jax.experimental.multihost_utils`), and host 0 decodes,
cross-shard-dedups once, and writes the genome-wide VCF.  SURVEY.md
section 2.3's accelerator equivalent.

Wire format: OFFSET-ENCODED, not fixed-width.  A padded (N, W_max) matrix
would let one long-ALT INS record (a 50 kb insertion carries its full
sequence) set the pad width for every record on every host -- an
O(N * max_len) blow-up between hosts.  Concatenated bytes + lengths keep the
payload at O(total record bytes) like the reference's `cat`
(focalsv.py:66-70); the only padding is to the largest single HOST's
totals, so wire bytes stay within process_count * max_host_bytes.
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu.io.vcf import VcfRecord, parse_line
from focalsv_tpu.utils.logging import get_logger

logger = get_logger("gather")


def encode_records(records: list[VcfRecord]) -> tuple[np.ndarray, np.ndarray]:
    """Records -> (flat uint8 of concatenated VCF body lines, lengths)."""
    lines = [r.to_line().encode() for r in records]
    lens = np.array([len(b) for b in lines], np.int64)
    flat = (np.frombuffer(b"".join(lines), np.uint8).copy()
            if lines else np.zeros(0, np.uint8))
    return flat, lens


def decode_records(flat: np.ndarray, lens: np.ndarray) -> list[VcfRecord]:
    """(flat bytes, lengths) -> records."""
    out: list[VcfRecord] = []
    off = 0
    for n in lens:
        n = int(n)
        line = bytes(flat[off : off + n]).decode(errors="replace").strip()
        off += n
        if not line:
            continue
        rec = parse_line(line)
        if rec is not None:
            out.append(rec)
    return out


def allgather_records(records: list[VcfRecord]) -> list[VcfRecord]:
    """All hosts' records, gathered over device collectives.

    Every participating jax process must call this (it is a collective).
    Returns the concatenated global record list on every host, ordered by
    process index.  Single-process: returns ``records`` unchanged.
    """
    import jax
    if jax.process_count() <= 1:
        return list(records)
    from jax.experimental import multihost_utils

    flat, lens = encode_records(records)
    # round 1: agree on the global (max record count, max payload bytes)
    dims = np.array([lens.size, flat.size], np.int64)
    all_dims = np.asarray(multihost_utils.process_allgather(dims))
    n_max = int(all_dims[:, 0].max())
    b_max = int(all_dims[:, 1].max())
    # round 2: lengths and flat payload, padded to the largest host only
    lens_p = np.zeros(max(n_max, 1), np.int64)
    lens_p[: lens.size] = lens
    flat_p = np.zeros(max(b_max, 1), np.uint8)
    flat_p[: flat.size] = flat
    g_lens = np.asarray(multihost_utils.process_allgather(lens_p))
    g_flat = np.asarray(multihost_utils.process_allgather(flat_p))
    out: list[VcfRecord] = []
    for p in range(g_lens.shape[0]):
        n_p = int(all_dims[p, 0])
        out.extend(decode_records(g_flat[p], g_lens[p, :n_p]))
    return out
