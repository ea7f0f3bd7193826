"""Banded affine-gap alignment DP: the framework's most-reused primitive.

Replaces the reference's native DP cores -- hifiasm's ksw2_extz2_sse.c
(SSE-vectorized extension alignment), minimap2's extension stage, and edlib's
edit distance (`remove_redundancy.py:57-63`) -- with one batched, vectorized
formulation.

Design: the band is stored by diagonal offset, so each DP row is a
fixed-width W vector; the horizontal (gap-in-query) dependency is resolved
with a *cummax prefix scan* instead of a sequential inner loop, making every
row update a pure vector op.  Valid when gap_open <= gap_extend <= 0 (opening
a gap from inside another gap never wins), which holds for all presets.

Row recurrence in band coordinates (k indexes diagonal j - i - d_lo):

    diag[k] = H_prev[k]   + sub(q[i], t[j])          # both i,j advance
    F[k]    = max(H_prev[k+1] + open, F_prev[k+1] + ext)   # query gap  (I op)
    G[k]    = max(diag, F)
    E[k]    = cummax_{k'<k}(G[k'] - ext*k') + open + ext*(k-1)  # target gap (D)
    H[k]    = max(G, E)

Direction bits (4 per cell, packed uint8) are streamed to device memory and
traced back on host to produce BAM CIGAR ops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from focalsv_tpu.io import bam as bamio

NEG = -(1 << 28)

# without a DP batcher, banded DPs up to this many cells run in the native
# host kernel (a one-pair device round trip costs more than their compute)
NATIVE_DP_MAX_CELLS = 1 << 24

# direction-bit layout
DIR_H_MASK = 0b11    # 0=diag, 1=E (target gap / D), 2=F (query gap / I), 3=start
DIR_E_EXT = 0b100    # E came from E (gap extension)
DIR_F_EXT = 0b1000   # F came from F


# ---------------------------------------------------------------------------
# numpy reference (full matrix, used as ground truth in tests)
# ---------------------------------------------------------------------------


def align_numpy(q, t, match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
                free_t_flanks: bool = False):
    """Full-matrix affine global alignment; returns (score, cigar ops list).

    With ``free_t_flanks`` the target's leading/trailing gaps are free
    (glocal / fit alignment of q inside t).
    """
    q = np.asarray(q); t = np.asarray(t)
    M, N = len(q), len(t)
    H = np.full((M + 1, N + 1), NEG, np.int64)
    E = np.full_like(H, NEG)
    F = np.full_like(H, NEG)
    ptr = np.zeros((M + 1, N + 1), np.uint8)
    H[0, 0] = 0
    for j in range(1, N + 1):
        E[0, j] = 0 if free_t_flanks else gap_open + gap_extend * (j - 1)
        H[0, j] = E[0, j]
        ptr[0, j] = 1
    for i in range(1, M + 1):
        F[i, 0] = gap_open + gap_extend * (i - 1)
        H[i, 0] = F[i, 0]
        ptr[i, 0] = 2
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            s = match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) else mismatch
            e_open, e_ext = H[i, j - 1] + gap_open, E[i, j - 1] + gap_extend
            E[i, j] = max(e_open, e_ext)
            f_open, f_ext = H[i - 1, j] + gap_open, F[i - 1, j] + gap_extend
            F[i, j] = max(f_open, f_ext)
            diag = H[i - 1, j - 1] + s
            H[i, j] = max(diag, E[i, j], F[i, j])
            p = 0 if H[i, j] == diag else (1 if H[i, j] == E[i, j] else 2)
            ptr[i, j] = p | (DIR_E_EXT if e_ext >= e_open else 0) | (
                DIR_F_EXT if f_ext >= f_open else 0)
    # endpoint
    if free_t_flanks:
        j_end = int(np.argmax(H[M, :]))
        score = int(H[M, j_end])
    else:
        j_end, score = N, int(H[M, N])
    # traceback
    ops = []
    i, j = M, j_end
    state = 0  # 0=H, 1=E, 2=F
    while i > 0 or j > 0:
        p = ptr[i, j]
        if state == 0:
            state = p & DIR_H_MASK
            if state == 0:
                ops.append(bamio.CMATCH)
                i, j = i - 1, j - 1
        elif state == 1:
            ops.append(bamio.CDEL)
            state = 1 if (p & DIR_E_EXT) else 0
            j -= 1
        else:
            ops.append(bamio.CINS)
            state = 2 if (p & DIR_F_EXT) else 0
            i -= 1
        if i == 0 and j > 0 and state == 0:
            state = 1
        if j == 0 and i > 0 and state == 0:
            state = 2
    ops.reverse()
    return score, _runlength(ops), j_end


def _runlength(ops):
    out = []
    for op in ops:
        if out and out[-1][0] == op:
            out[-1][1] += 1
        else:
            out.append([op, 1])
    return [(o, l) for o, l in out]


# ---------------------------------------------------------------------------
# JAX banded batch kernel (scan formulation; jit/shard-friendly)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("band", "max_rows", "match", "mismatch", "gap_open",
                     "gap_extend", "store_dirs"),
)
def banded_align_batch(
    q: jax.Array,          # (B, Lq) uint8, PAD beyond length
    q_len: jax.Array,      # (B,) int32
    t: jax.Array,          # (B, Lt) uint8
    t_len: jax.Array,      # (B,) int32
    d_lo: jax.Array,       # (B,) int32 band low diagonal (j - i >= d_lo)
    band: int = 256,
    max_rows: int | None = None,
    match: int = 2,
    mismatch: int = -4,
    gap_open: int = -4,
    gap_extend: int = -2,
    store_dirs: bool = True,
):
    """Batched banded affine global alignment.

    Returns (score (B,), dirs (B, max_rows+1, band) uint8 or None).
    The band for row i covers target columns j in [i + d_lo, i + d_lo + band).
    Alignment is global in both sequences; callers choose d_lo so that the
    (q_len, t_len) endpoint lies in-band (e.g. d_lo = (t_len - q_len - band//2)).
    """
    B, Lq = q.shape
    M = max_rows if max_rows is not None else Lq
    W = band

    ks = jnp.arange(W, dtype=jnp.int32)

    # To read H at row qn (qn may differ per batch item), redo with carry capture:
    def one_full(qi, qn, ti, tn, dlo):
        j0 = dlo + ks
        h0 = jnp.where(
            j0 == 0, 0,
            jnp.where(j0 > 0, gap_open + gap_extend * (j0 - 1), NEG),
        ).astype(jnp.int32)
        h0 = jnp.where((j0 >= 0) & (j0 <= tn), h0, NEG)
        e0 = jnp.where(j0 > 0, h0, NEG)
        f0 = jnp.full((W,), NEG, jnp.int32)
        t_pad = jnp.concatenate([ti, jnp.full((W + 1,), 255, ti.dtype)])

        def row(carry, i):
            h_prev, e_prev, f_prev, h_at_end = carry
            qc = qi[jnp.clip(i - 1, 0, qi.shape[0] - 1)]
            j = i + dlo + ks
            jv = (j >= 1) & (j <= tn) & (i <= qn)
            # the j==0 column (pure leading query insertions) is F-only
            jz = (j == 0) & (i <= qn)
            tc = t_pad[jnp.clip(j - 1, 0, t_pad.shape[0] - 1)]
            sub = jnp.where((qc == tc) & (qc < 4), match, mismatch)
            diag = h_prev + sub
            h_up = jnp.concatenate([h_prev[1:], jnp.array([NEG], jnp.int32)])
            f_up = jnp.concatenate([f_prev[1:], jnp.array([NEG], jnp.int32)])
            f_open = h_up + gap_open
            f_ext = f_up + gap_extend
            f = jnp.maximum(f_open, f_ext)
            g = jnp.maximum(diag, f)
            a = jax.lax.cummax(g - gap_extend * ks)
            a_shift = jnp.concatenate([jnp.array([NEG], jnp.int32), a[:-1]])
            # gap of length g costs open + ext*(g-1): the -ext corrects the scan
            e = a_shift + (gap_open - gap_extend) + gap_extend * ks
            h = jnp.maximum(g, e)
            h = jnp.where(jv, h, jnp.where(jz, f, NEG))
            e2 = jnp.where(jv, e, NEG)
            f2 = jnp.where(jv | jz, f, NEG)
            d = jnp.where(h == diag, 0, jnp.where(h == e, 1, 2)).astype(jnp.uint8)
            d = d | jnp.where(f_ext >= f_open, DIR_F_EXT, 0).astype(jnp.uint8)
            g_left = jnp.concatenate([jnp.array([NEG], jnp.int32), g[:-1]])
            e_ext_bit = (a_shift > g_left - gap_extend * (ks - 1)).astype(jnp.uint8)
            d = d | (e_ext_bit * DIR_E_EXT)
            dz = (jnp.uint8(2) |
                  jnp.where(f_ext >= f_open, DIR_F_EXT, 0).astype(jnp.uint8))
            d = jnp.where(jv, d, jnp.where(jz, dz, 0))
            h_at_end = jnp.where(i == qn, h, h_at_end)
            return (h, e2, f2, h_at_end), (d if store_dirs else 0)

        h_at_end0 = jnp.where(qn == 0, h0, jnp.full((W,), NEG, jnp.int32))
        (_, _, _, h_end), dirs = jax.lax.scan(
            row, (h0, e0, f0, h_at_end0), jnp.arange(1, M + 1, dtype=jnp.int32))
        k_end = tn - qn - dlo
        score = jnp.where(
            (k_end >= 0) & (k_end < W),
            h_end[jnp.clip(k_end, 0, W - 1)], NEG)
        return score, dirs

    scores, dirs = jax.vmap(one_full)(q, q_len, t, t_len, d_lo)
    if store_dirs:
        return scores, dirs
    return scores, None


def traceback(
    dirs: np.ndarray,        # (M, W) uint8, row r is DP row r+1
    q_len: int,
    t_len: int,
    d_lo: int,
) -> list[tuple[int, int]]:
    """Host traceback from direction bits to run-length CIGAR (op, len)."""
    W = dirs.shape[1]
    ops: list[int] = []
    i, j = int(q_len), int(t_len)
    state = 0
    while i > 0 or j > 0:
        if i == 0:
            ops.extend([bamio.CDEL] * j)
            break
        if j <= i + d_lo:  # left band edge or j==0: only query gaps possible
            if j == 0:
                ops.extend([bamio.CINS] * i)
                break
        k = j - i - d_lo
        p = int(dirs[i - 1, k]) if 0 <= k < W else 0
        if state == 0:
            state = p & DIR_H_MASK
            if state == 0:
                ops.append(bamio.CMATCH)
                i -= 1
                j -= 1
        elif state == 1:
            ops.append(bamio.CDEL)
            state = 1 if (p & DIR_E_EXT) else 0
            j -= 1
        else:
            ops.append(bamio.CINS)
            state = 2 if (p & DIR_F_EXT) else 0
            i -= 1
    ops.reverse()
    return _runlength(ops)


GPU_MAX_BAND = 2048   # widest band the GPU kernel was measured at


def use_gpu_kernel(band: int, store_dirs: bool) -> bool:
    """The Pallas-Triton kernel (ops/align_gpu.py) serves the GPU backend
    for power-of-two bands up to GPU_MAX_BAND; everything else runs the
    lax.scan formulation."""
    return (store_dirs and jax.default_backend() == "gpu"
            and band & (band - 1) == 0 and band <= GPU_MAX_BAND)


def banded_align(q, q_len, t, t_len, d_lo, band=256, store_dirs=True, **scoring):
    """Backend-dispatching banded DP (see use_gpu_kernel).  Returns
    (scores (B,), dirs (B, Lq, band) uint8 or None)."""
    if use_gpu_kernel(band, store_dirs):
        from focalsv_tpu.ops.align_gpu import banded_align_batch_gpu
        return banded_align_batch_gpu(q, q_len, t, t_len, d_lo,
                                      band=band, **scoring)
    return banded_align_batch(q, q_len, t, t_len, d_lo, band=band,
                              store_dirs=store_dirs, **scoring)


def _pad_bucket(x: np.ndarray, lo: int = 64) -> np.ndarray:
    """Pad a 1-D uint8 sequence to the next power-of-FOUR bucket.

    Coarse buckets keep the set of distinct jit shapes tiny: each new
    (Lq, Lt, band) combination is a fresh compile.
    """
    n = lo
    while n < len(x):
        n *= 4
    if n == len(x):
        return x
    return np.concatenate([x, np.full(n - len(x), 5, np.uint8)])


def band_bucket(need: int, lo: int = 128) -> int:
    """Quantize band widths to {128, 512, 2048, 8192, ...} (x4 steps)."""
    b = lo
    while b < need:
        b *= 4
    return b


def banded_align_pair(q, t, band=256, match=2, mismatch=-4, gap_open=-4,
                      gap_extend=-2):
    """Convenience single-pair wrapper: returns (score, cigar).

    When a DPBatcher is active (parallel/batch_executor.dp_batching), the job
    routes through the cross-thread batching service so concurrent pairs run
    as one device batch."""
    q = np.asarray(q, np.uint8)
    t = np.asarray(t, np.uint8)
    # a band narrower than the length difference cannot contain the global
    # endpoint -- widen it instead of silently returning garbage
    if abs(len(t) - len(q)) + 8 > band:
        band = band_bucket(abs(len(t) - len(q)) + 32, lo=band)
    d_lo = (len(t) - len(q)) // 2 - band // 2
    # ensure k_end in range and diagonal start reachable
    d_lo = int(np.clip(d_lo, len(t) - len(q) - band + 1, 0))
    from focalsv_tpu.parallel import batch_executor
    batcher = batch_executor.get_active()
    if batcher is not None and not batcher.route_native(len(q) * band):
        score, dirs = batcher.align(q, t, band, match, mismatch,
                                    gap_open, gap_extend, d_lo)
        cig = traceback(np.asarray(dirs), len(q), len(t), d_lo)
        return score, cig
    # host fast path: small DPs are latency-bound on a device round-trip,
    # not FLOP-bound -- run them in the native C++ kernel (bit-identical
    # band semantics), exactly the role ksw2 plays inside minimap2.  Large
    # DPs go to the device kernel.
    if len(q) * band <= NATIVE_DP_MAX_CELLS:
        from focalsv_tpu import native
        res = native.affine_banded_align(q, t, d_lo, band, match, mismatch,
                                         gap_open, gap_extend)
        if res is not None:
            score, dirs = res
            cig = traceback(dirs, len(q), len(t), d_lo)
            return score, cig
    qp, tp = _pad_bucket(q), _pad_bucket(t)
    scores, dirs = banded_align(
        qp[None], np.array([len(q)], np.int32),
        tp[None], np.array([len(t)], np.int32),
        np.array([d_lo], np.int32), band=band, match=match,
        mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend)
    # host traceback on the copied dirs (one pair's rows: at most a few
    # tens of MB over PCIe)
    cig = traceback(np.asarray(dirs[0]), len(q), len(t), d_lo)
    return int(scores[0]), cig


# ---------------------------------------------------------------------------
# score-only edit similarity (replaces edlib in dedup)
# ---------------------------------------------------------------------------


def edit_similarity(a: np.ndarray, b: np.ndarray, band: int = 128) -> float:
    """1 - dist/max(len) as used by remove_redundancy.edit_sim (:57-63)."""
    la, lb = len(a), len(b)
    if max(la, lb) == 0:
        return 1.0
    # host-native path: score-only O(n*band) with a small working set -- a
    # 30 kb INS-seq pair at band ~100 is ~3M cells, fractions of a ms.  The
    # previous 20 kb length cap pushed long low-divergence pairs onto a
    # fresh wide-band XLA compile (a >4 min stall per new shape on CPU)
    if max(la, lb) * (abs(la - lb) + 64) <= NATIVE_DP_MAX_CELLS * 16:
        from focalsv_tpu import native
        dist = native.banded_edit_distance(
            np.asarray(a, np.uint8), np.asarray(b, np.uint8),
            band=abs(la - lb) + 64)
        if dist is not None:
            return 1.0 - dist / max(la, lb)
    band = max(band, band_bucket(abs(la - lb) + 16))
    d_lo = (lb - la) // 2 - band // 2
    d_lo = int(np.clip(d_lo, lb - la - band + 1, 0))
    scores, _ = banded_align_batch(
        _pad_bucket(np.asarray(a, np.uint8))[None], np.array([la], np.int32),
        _pad_bucket(np.asarray(b, np.uint8))[None], np.array([lb], np.int32),
        np.array([d_lo], np.int32), band=band,
        match=0, mismatch=-1, gap_open=-1, gap_extend=-1, store_dirs=False)
    dist = -int(scores[0])
    return 1.0 - dist / max(la, lb)
