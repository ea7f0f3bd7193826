"""Pallas-Triton GPU kernel for the banded affine-gap DP (forward + dirs).

Same recurrence and direction bits as ops/align.py::banded_align_batch.
XLA lowers that lax.scan to a device-side while loop that launches the
fused row body once per query row and round-trips the band state through
device memory every row.  Here one program owns one alignment pair and
walks all of its rows inside the kernel: the W-wide band state stays in
registers, only the direction bytes stream out, and rows past the pair's
own q_len are never computed (they are zero-filled).

The row's shifted and prefix dependencies map onto the block as follows:

- ``h_up``/``f_up`` (the previous row at k+1) and the one-step right
  shifts ``a[k-1]``/``g[k-1]`` go through a small per-program scratch
  strip in global memory (L1/L2 resident) between two block barriers;
- the in-band prefix max of ``g - ext*k`` is one ``lax.cummax``, lowered
  to Triton's native associative scan (``_register_cummax_lowering``).

The wrapper pre-shifts each target so a row reads one contiguous W-wide
window: ``ts[b, y] = t[b, y + d_lo_b]``, PAD outside.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from focalsv_tpu.ops.align import DIR_E_EXT, DIR_F_EXT, NEG

_PAD = 5
# the kernel addresses the dirs output with 32-bit offsets: larger batches
# run as several launches of at most this many bytes each
MAX_LAUNCH_BYTES = (1 << 31) - 1


def _register_cummax_lowering() -> None:
    """Teach the Pallas-Triton lowering ``lax.cummax`` as Triton's own
    associative scan (``tt.scan`` with a max combiner).  The installed JAX
    registers only ``cumsum`` this way; the rule below is the same one with
    ``jnp.maximum`` as the combiner."""
    from jax._src.pallas.triton import lowering as tl
    if lax.cummax_p in tl.triton_lowering_rules:
        return

    def rule(ctx, x, *, axis: int, reverse: bool):
        if reverse:
            raise NotImplementedError("reverse cummax")
        return tl._associative_scan_lowering(jnp.maximum, ctx, x, (axis,))[0]

    tl.register_lowering(lax.cummax_p)(rule)


def _kernel(q_ref, ts_ref, qlen_ref, tlen_ref, dlo_ref,
            hend_ref, dirs_ref, scr_ref,
            *, W: int, M: int, match: int, mismatch: int, gap_open: int,
            gap_extend: int, barrier: bool):
    b = pl.program_id(0)
    ks = jnp.arange(W, dtype=jnp.int32)
    qn = qlen_ref[b]
    tn = tlen_ref[b]
    dlo = dlo_ref[b]
    sync = plgpu.debug_barrier if barrier else (lambda: None)
    neg = jnp.full((W,), NEG, jnp.int32)
    # scratch rows: 0 = h, 1 = f (read back at k+1; [W, 2W) stays NEG),
    # 2 = cummax, 3 = g (written at k+1, read back at k; [0] stays NEG)
    H, F, A, G = 0, 1, 2, 3

    def put(row, idx, val):
        plgpu.store(scr_ref.at[b, row, idx], val)

    def get(row, idx):
        return plgpu.load(scr_ref.at[b, row, idx])

    j0 = dlo + ks
    h0 = jnp.where(j0 == 0, 0,
                   jnp.where(j0 > 0, gap_open + gap_extend * (j0 - 1), NEG))
    h0 = jnp.where((j0 >= 0) & (j0 <= tn), h0, NEG).astype(jnp.int32)
    put(H, ks, h0)
    put(H, ks + W, neg)
    put(F, ks, neg)
    put(F, ks + W, neg)
    put(A, ks, neg)
    put(G, ks, neg)
    sync()

    def row(i, h_prev):
        qc = q_ref[b, i - 1].astype(jnp.int32)
        tc = plgpu.load(ts_ref.at[b, i - 1 + ks]).astype(jnp.int32)
        h_up = get(H, ks + 1)
        f_up = get(F, ks + 1)
        j = i + dlo + ks
        jv = (j >= 1) & (j <= tn)
        # the j==0 column (pure leading query insertions) is F-only
        jz = j == 0
        sub = jnp.where((qc == tc) & (qc < 4), match, mismatch)
        diag = h_prev + sub
        f_open = h_up + gap_open
        f_ext = f_up + gap_extend
        f = jnp.maximum(f_open, f_ext)
        g = jnp.maximum(diag, f)
        a = lax.cummax(g - gap_extend * ks, axis=0)
        put(A, ks + 1, a)
        put(G, ks + 1, g)
        sync()
        a_shift = get(A, ks)
        g_left = get(G, ks)
        # gap of length g costs open + ext*(g-1): the -ext corrects the scan
        e = a_shift + (gap_open - gap_extend) + gap_extend * ks
        h = jnp.maximum(g, e)
        h = jnp.where(jv, h, jnp.where(jz, f, NEG))
        f_bit = jnp.where(f_ext >= f_open, DIR_F_EXT, 0)
        d = jnp.where(h == diag, 0, jnp.where(h == e, 1, 2)) | f_bit
        d = d | jnp.where(a_shift > g_left - gap_extend * (ks - 1),
                          DIR_E_EXT, 0)
        d = jnp.where(jv, d, jnp.where(jz, 2 | f_bit, 0))
        plgpu.store(dirs_ref.at[b, i - 1, ks], d.astype(jnp.uint8))
        put(H, ks, h)
        put(F, ks, jnp.where(jv | jz, f, NEG))
        sync()
        return h

    h_end = lax.fori_loop(1, qn + 1, row, h0)
    plgpu.store(hend_ref.at[b, ks], h_end)
    zeros = jnp.zeros((W,), jnp.uint8)

    def clear(i, c):
        plgpu.store(dirs_ref.at[b, i, ks], zeros)
        return c

    lax.fori_loop(qn, M, clear, 0)


def _num_warps(W: int) -> int:
    return max(1, min(8, W // 128))


@functools.partial(
    jax.jit,
    static_argnames=("band", "match", "mismatch", "gap_open", "gap_extend",
                     "interpret"),
)
def banded_align_batch_gpu(
    q: jax.Array,          # (B, Lq) uint8, PAD beyond length
    q_len: jax.Array,      # (B,) int32
    t: jax.Array,          # (B, Lt) uint8
    t_len: jax.Array,      # (B,) int32
    d_lo: jax.Array,       # (B,) int32
    band: int = 128,
    match: int = 2,
    mismatch: int = -4,
    gap_open: int = -4,
    gap_extend: int = -2,
    interpret: bool = False,
):
    """Returns (scores (B,) int32, dirs (B, Lq, band) uint8), identical to
    ops.align.banded_align_batch(..., store_dirs=True).  ``band`` must be a
    power of two (Triton block shapes are)."""
    if band & (band - 1):
        raise ValueError(f"band {band} is not a power of two")
    B, M = q.shape
    per_launch = max(1, MAX_LAUNCH_BYTES // (M * band))
    if B > per_launch:
        parts = [_launch(q[s:s + per_launch], q_len[s:s + per_launch],
                         t[s:s + per_launch], t_len[s:s + per_launch],
                         d_lo[s:s + per_launch], band, match, mismatch,
                         gap_open, gap_extend, interpret)
                 for s in range(0, B, per_launch)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))
    return _launch(q, q_len, t, t_len, d_lo, band, match, mismatch,
                   gap_open, gap_extend, interpret)


def _launch(q, q_len, t, t_len, d_lo, band, match, mismatch, gap_open,
            gap_extend, interpret):
    B, M = q.shape
    Lt = t.shape[1]
    W = band
    q_len = q_len.astype(jnp.int32)
    t_len = t_len.astype(jnp.int32)
    d_lo = d_lo.astype(jnp.int32)
    xs = jnp.arange(M + W, dtype=jnp.int32)[None, :] + d_lo[:, None]
    ts = jnp.where((xs >= 0) & (xs < Lt),
                   jnp.take_along_axis(t, jnp.clip(xs, 0, Lt - 1), axis=1),
                   jnp.uint8(_PAD))
    if not interpret:
        _register_cummax_lowering()
    kernel = functools.partial(
        _kernel, W=W, M=M, match=match, mismatch=mismatch,
        gap_open=gap_open, gap_extend=gap_extend, barrier=not interpret)
    hend, dirs, _ = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((B, W), jnp.int32),
            jax.ShapeDtypeStruct((B, M, W), jnp.uint8),
            jax.ShapeDtypeStruct((B, 4, 2 * W), jnp.int32),
        ],
        grid=(B,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(W),
                                             num_stages=1),
        interpret=interpret,
        name="banded_align_dp",
    )(q, ts, q_len, t_len, d_lo)
    k_end = t_len - q_len - d_lo
    in_band = (k_end >= 0) & (k_end < W)
    scores = jnp.where(
        in_band,
        jnp.take_along_axis(hend, jnp.clip(k_end, 0, W - 1)[:, None],
                            axis=1)[:, 0],
        NEG)
    return scores, dirs
