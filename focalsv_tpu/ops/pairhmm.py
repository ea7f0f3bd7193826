"""Batched pair-HMM forward likelihoods (the longshot/GATK-HC realignment core).

Replaces the probabilistic heart of Longshot (pair-HMM realignment of reads
against candidate haplotypes; reference runs `longshot` per region,
2_phasing/longshot.py:20) with an accelerator-friendly formulation: the classic
3-state (M/I/D) forward algorithm evaluated over *anti-diagonal wavefronts*,
so every scan step is a fully parallel vector update over the diagonal --
no within-row sequential dependency (cf. PAPERS.md gpuPairHMM/Endeavor,
which use the same wavefront dataflow on GPUs).

Intended use: small local windows (read segment vs candidate-allele
haplotype window around a variant site), batched over thousands of
(read, site, allele) pairs via vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

LOG0 = -1e30


def _logsumexp3(a, b, c):
    m = jnp.maximum(jnp.maximum(a, b), c)
    m_safe = jnp.maximum(m, LOG0 / 2)
    return m + jnp.log(
        jnp.exp(a - m_safe) + jnp.exp(b - m_safe) + jnp.exp(c - m_safe))


def _logsumexp2(a, b):
    m = jnp.maximum(a, b)
    m_safe = jnp.maximum(m, LOG0 / 2)
    return m + jnp.log(jnp.exp(a - m_safe) + jnp.exp(b - m_safe))


@functools.partial(
    jax.jit,
    static_argnames=("max_read", "max_hap"),
)
def pairhmm_forward_batch(
    reads: jax.Array,      # (B, max_read) uint8
    read_lens: jax.Array,  # (B,) int32
    haps: jax.Array,       # (B, max_hap) uint8
    hap_lens: jax.Array,   # (B,) int32
    quals: jax.Array | None = None,   # (B, max_read) phred, default 30
    max_read: int = 32,
    max_hap: int = 32,
    gap_open: float = 1e-3,
    gap_extend: float = 0.1,
):
    """log P(read | hap) under the 3-state pair-HMM, free hap flanks.

    Emissions: match prob 1-e, mismatch e/3 with e from the base quality;
    insert emissions uniform (1/4).  Transitions: M->gap gap_open,
    gap->gap gap_extend.  Haplotype leading/trailing deletions are free
    (local-in-hap alignment), matching realignment-window semantics.
    """
    B = reads.shape[0]
    M, N = max_read, max_hap
    if quals is None:
        quals = jnp.full((B, M), 30, jnp.int32)
    err = jnp.power(10.0, -quals.astype(jnp.float32) / 10.0)
    lm_match = jnp.log1p(-jnp.clip(err, 1e-10, 0.75))
    lm_mis = jnp.log(jnp.clip(err, 1e-10, 0.75) / 3.0)

    l_go = float(np.log(gap_open))
    l_ge = float(np.log(gap_extend))
    l_mm = float(np.log(1.0 - 2 * gap_open))
    l_gm = float(np.log(1.0 - gap_extend))
    l_ins = float(np.log(0.25))

    def one(read, rlen, hap, hlen, lmat, lmis):
        # wavefront arrays indexed by read position i in [0, M]
        # cell (i, j) lives on anti-diagonal a = i + j
        iarr = jnp.arange(M + 1)

        def emit(i, j):
            # match emission for read[i-1] vs hap[j-1]
            rc = read[jnp.clip(i - 1, 0, M - 1)]
            hc = hap[jnp.clip(j - 1, 0, N - 1)]
            return jnp.where((rc == hc) & (rc < 4),
                             lmat[jnp.clip(i - 1, 0, M - 1)],
                             lmis[jnp.clip(i - 1, 0, M - 1)])

        # init: a=0 cell (0,0); hap flanks free => Y(0, j) = 0 for all j
        m0 = jnp.where(iarr == 0, 0.0, LOG0)       # diag a=0
        x0 = jnp.full(M + 1, LOG0)
        y0 = jnp.where(iarr == 0, 0.0, LOG0)

        def step(carry, a):
            (m1, x1, y1, m2, x2, y2) = carry     # a-1 and a-2 wavefronts
            i = iarr
            j = a - i
            valid = (i >= 0) & (i <= rlen) & (j >= 1) & (j <= hlen)
            # shift helpers: value at read index i-1 on a given wavefront
            def up(v):  # (i-1) on previous diagonal arrays
                return jnp.concatenate([jnp.array([LOG0]), v[:-1]])
            e = jax.vmap(emit)(i, j)
            m_new = e + _logsumexp3(up(m2) + l_mm, up(x2) + l_gm,
                                    up(y2) + l_gm)
            x_new = l_ins + _logsumexp2(up(m1) + l_go, up(x1) + l_ge)
            y_new = _logsumexp2(m1 + l_go, y1 + l_ge)
            # free leading hap deletions: entering at (0, j) costs nothing
            y_new = jnp.where(i == 0, 0.0, y_new)
            m_new = jnp.where(valid & (i >= 1), m_new, LOG0)
            x_new = jnp.where(valid & (i >= 1), x_new, LOG0)
            y_new = jnp.where(valid | (i == 0), y_new, LOG0)
            # collect terminal likelihood at i == rlen (free hap tail)
            term = jnp.where((i == rlen) & valid,
                             _logsumexp2(m_new, x_new), LOG0)
            return (m_new, x_new, y_new, m1, x1, y1), jnp.max(term)

        init = (m0, x0, y0, jnp.full(M + 1, LOG0), jnp.full(M + 1, LOG0),
                jnp.full(M + 1, LOG0))
        _, terms = jax.lax.scan(step, init, jnp.arange(1, M + N + 1))
        # total likelihood: sum over end positions j (free tail) -- use
        # logsumexp over per-diagonal terminal maxima as an approximation of
        # the best end point family; exact enough for LR comparisons
        mt = jnp.max(terms)
        mt_safe = jnp.maximum(mt, LOG0 / 2)
        return mt + jnp.log(jnp.sum(jnp.exp(terms - mt_safe)))

    return jax.vmap(one)(reads, read_lens, haps, hap_lens, lm_match, lm_mis)


def site_allele_loglik(
    read_segs: np.ndarray,   # (B, L) uint8 read windows
    seg_lens: np.ndarray,
    ref_windows: np.ndarray, # (B, Lh)
    window_lens_ref: np.ndarray,
    alt_windows: np.ndarray,
    window_lens_alt: np.ndarray,
    quals: np.ndarray | None = None,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """(logP(read|ref), logP(read|alt)) per read window -- the allele
    assignment evidence longshot derives from realignment."""
    lr = pairhmm_forward_batch(read_segs, seg_lens, ref_windows,
                               window_lens_ref, quals,
                               max_read=read_segs.shape[1],
                               max_hap=ref_windows.shape[1], **kw)
    la = pairhmm_forward_batch(read_segs, seg_lens, alt_windows,
                               window_lens_alt, quals,
                               max_read=read_segs.shape[1],
                               max_hap=alt_windows.shape[1], **kw)
    return np.asarray(lr), np.asarray(la)
