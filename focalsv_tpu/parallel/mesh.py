"""Device mesh + region-data-parallel dispatch.

FocalSV's only parallelism is embarrassing data-parallelism over genomic
regions (joblib within a node + one SLURM job per chromosome + `cat|vcf-sort`
as the all-gather; SURVEY.md section 2.3).  The accelerator equivalent: one
`jax.sharding.Mesh` with a single flat 'regions' axis spanning {hosts x
cards} -- the cards of a host reach each other all to all (NVLink), so the
mesh follows the algorithm alone; fixed-shape region tiles are sharded on
that axis, every per-region kernel runs under `shard_map`, and fixed-width
SV-candidate records come back via all_gather for host-side VCF assembly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from focalsv_tpu.ops import align as alignops

DATA_AXIS = "regions"


def make_mesh(n_devices: int | None = None, local: bool = False) -> Mesh:
    """One flat 'regions' axis over the first n_devices devices (all by
    default); ``local`` keeps to this process's own devices, as a
    per-process region step in a multi-process run must."""
    devs = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def pad_batch_to_devices(arrays: list[np.ndarray], n_devices: int):
    """Pad the leading (batch) axis to a multiple of the mesh size."""
    b = arrays[0].shape[0]
    pad = (-b) % n_devices
    if pad == 0:
        return arrays, b
    out = []
    for a in arrays:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths))
    return out, b


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "band", "match", "mismatch", "gap_open",
                     "gap_extend", "store_dirs"),
)
def sharded_banded_align(
    q, q_len, t, t_len, d_lo, *, mesh: Mesh, band: int = 256,
    match: int = 2, mismatch: int = -4, gap_open: int = -4,
    gap_extend: int = -2, store_dirs: bool = True,
):
    """`banded_align_batch` sharded over the regions axis of a mesh.

    The kernel is purely data-parallel: no cross-shard collectives are needed
    during the DP; results gather lazily when the host reads them.
    """
    spec = P(DATA_AXIS)
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, store_dirs=store_dirs)

    def local(q, q_len, t, t_len, d_lo):
        return alignops.banded_align_batch(q, q_len, t, t_len, d_lo, **kw)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=(spec, spec if store_dirs else None),
        check_vma=False,
    )
    return fn(q, q_len, t, t_len, d_lo)


@functools.partial(jax.jit, static_argnames=("mesh",))
def sharded_sv_candidate_step(
    q, q_len, t, t_len, d_lo, *, mesh: Mesh,
):
    """One full device step of the region batch 'model': banded alignment of
    each region's query (contig/read) against its reference window, plus an
    on-device reduction producing fixed-width SV-candidate summaries, and an
    all_gather so every shard sees the global candidate table (the
    cross-region dedup input).  This is the flagship compiled step the
    multi-chip dry run exercises end to end.
    """
    spec = P(DATA_AXIS)

    def local(q, q_len, t, t_len, d_lo):
        scores, dirs = alignops.banded_align_batch(
            q, q_len, t, t_len, d_lo, band=128, store_dirs=True)
        # on-device candidate summary: per region, count of D/I-dominant rows
        hdir = dirs & alignops.DIR_H_MASK
        n_del = jnp.sum(hdir == 1, axis=(1, 2))
        n_ins = jnp.sum(hdir == 2, axis=(1, 2))
        cand = jnp.stack([scores, n_del.astype(jnp.int32),
                          n_ins.astype(jnp.int32)], axis=1)
        # global view for cross-region dedup decisions
        global_cand = jax.lax.all_gather(cand, DATA_AXIS, tiled=True)
        return scores, cand, global_cand

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )
    return fn(q, q_len, t, t_len, d_lo)
