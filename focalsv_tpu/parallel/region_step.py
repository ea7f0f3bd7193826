"""Device-batched region compute: the production phasing + consensus step.

The host builds one fixed-shape (reads x length) pileup tile per region
(pipeline/device_exec.py bucketizes them); the device then runs, for a whole
region batch in ONE dispatch:

- het-site detection: per-column base counts, integer-thresholded het band,
  f32-balance top-k site selection (phasing/phase.py::find_het_sites +
  phase_region max_sites selection, bit-identical by construction);
- 3-sigma co-phasing site purification (phasing/phase.py::purify_sites,
  exact integer reformulation);
- MEC phasing: chained adjacent-site parity init (as a cumulative XOR) +
  alternating majority refinement (phasing/phase.py::mec_phase);
- haplotype consensus voting: per-column 6-symbol counts {A,C,G,T,N,DEL}
  weighted by the read assignment, unphased reads voting in both haplotypes
  (assembly/consensus.py::_column_vote over group_reads_by_block groups).

Everything is vmapped over the region axis and shards over the mesh's
'regions' axis (parallel/mesh.py).  Every threshold comparison is integer
arithmetic and every ratio is a correctly-rounded f32 quotient (built in
integer arithmetic, _ratio_f32), so the device results bit-match the host
reference implementations -- the contract tests/test_device_pipeline.py
enforces.  Ragged work (insertion consensus,
phase-block splits, contig stitching) stays host-side in
pipeline/device_exec.py.

Transfer format: tiles ship as packed 4-bit symbols (pack_nibbles) and
results come back as ONE flat uint8 buffer per region (flat_layout) with the
consensus coverage as a packed bitmask.  These formulations, like the
select-based nibble decode, the scatter-free RLE compaction and the BLOCK
chunk gather below, were chosen for an earlier accelerator; each awaits an
A/B on the GPU (ROADMAP) and is kept here as it is.

Reference contrast: this step replaces the per-region longshot + hifiasm
process launches of focalsv/main.py:104-155 with one compiled kernel over a
batch of regions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from focalsv_tpu.parallel.wire import (BLOCK, DEL_SYM, NIB_MAP, NOCOV,
                                        delta_flat_layout, flat_layout,
                                        pack_delta_chunk, pack_nibbles,
                                        pack_row_tile, pack_rows_chunk,
                                        rows_flat_layout, unflatten_result)

__all_wire__ = ("BLOCK", "DEL_SYM", "NIB_MAP", "NOCOV", "delta_flat_layout",
                "flat_layout", "pack_delta_chunk", "pack_nibbles",
                "pack_row_tile", "pack_rows_chunk", "rows_flat_layout",
                "unflatten_result")   # moved to wire.py (jax-free)


def _unpack_nibbles(packed: jax.Array, L: int) -> jax.Array:
    """(..., L/2) split-half packed -> (..., L) uint8 pileup symbols.

    The 16-entry inverse table is computed with two selects instead of a
    table gather (_NIB_INV is n<5 -> n, 5 -> DEL_SYM, else NOCOV)."""
    def inv(n):
        return jnp.where(n < 5, n,
                         jnp.where(n == 5, jnp.uint8(DEL_SYM),
                                   jnp.uint8(NOCOV)))
    lo = inv(packed & 0xF)
    hi = inv(packed >> 4)
    return jnp.concatenate([lo, hi], axis=-1)[..., :L]


def _ratio_f32(p: jax.Array, q: jax.Array) -> jax.Array:
    """p / q as a correctly rounded f32, in integer arithmetic only, for
    int32 0 <= p <= q and 1 <= q < 2^23.

    The site selection compares these balances (max, then lowest column
    among ties) and must see exactly the host's numpy f32 quotients.  XLA's
    f32 divide on the GPU is not correctly rounded (chip_smoke.py shows
    the differing quotients), so the quotient is built by long division:
    normalise p * 2^s into [q/2, q), take 24 quotient bits in three 8-bit
    steps, round to nearest on the remainder, and scale by 2^-(24+s)."""
    p = p.astype(jnp.int32)
    q = q.astype(jnp.int32)
    s = jnp.zeros_like(p)
    for k in range(1, 24):          # p * 2^k < q, without overflow
        s = s + (p < (q + (1 << k) - 1) >> k).astype(jnp.int32)
    r = p << jnp.where(p > 0, s, 0)
    n = jnp.zeros_like(p)
    for _ in range(3):
        r = r << 8
        d = r // q
        r = r - d * q
        n = n * 256 + d
    # round to nearest; an exact half cannot occur (it would need a
    # dyadic quotient with 25 significant bits, i.e. q >= 2^24)
    n = n + (2 * r > q).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type((103 - s) << 23, jnp.float32)
    return jnp.where(p > 0, n.astype(jnp.float32) * scale, jnp.float32(0))


def _select_sites_strips_dynamic(bal: jax.Array, L_true, S: int):
    """Per-strip best-balance site selection with the TRUE region length.

    The padded kernel length L_pad is a bucket shape; strip geometry must
    come from the region's REAL length or the partition differs from the
    host's `select_sites_strips` and, whenever het candidates compete
    within a strip (high-noise pileups), a different site wins -- a
    latent host/device parity break found by the high-noise gate.  The
    reshape(S, strip) trick needs a static strip, so this runs two exact
    segment reductions over dynamic strip ids: per-strip max balance,
    then per-strip MIN column among the balance ties -- identical to
    argmax's lowest-index tie rule.  Returns (site_pos (S,) i32,
    sel (S,) bool), site s belonging to strip s in ascending position
    order.
    """
    Lp = bal.shape[0]
    strip = jnp.maximum((L_true + S - 1) // S, 1)
    col = jnp.arange(Lp, dtype=jnp.int32)
    stripe = jnp.minimum(col // strip, S - 1)
    best_bal = jnp.full(S, -1.0, jnp.float32).at[stripe].max(bal)
    is_best = bal == best_bal[stripe]
    best_col = jnp.full(S, Lp, jnp.int32).at[stripe].min(
        jnp.where(is_best, col, Lp))
    sel = best_bal > 0
    return jnp.where(sel, best_col, 0), sel


def _phase_core(A, site_pos, sel, rv, a0, a1, code_map, *,
                mec_iters, purify_window, purify_min_pairs,
                purify_num, purify_den):
    """Shared phasing core: purification -> site compaction -> PER-BLOCK
    MEC -> per-read haplotype/block assignment -> per-site summaries.

    Blocks are maximal runs of consecutive sites linked by >=1 co-covering
    read (phasing/phase.py::phase_blocks); MEC runs independently per
    block via prefix-sum block aggregation (no (R, B) matmuls: each site
    gathers its block's [start, end] prefix-sum bounds), bit-matching the
    host's per-block mec_phase loop.  Reads take the assignment of the
    block of their FIRST covered site (the host's ascending-block
    `hp == 0` priority).  With a single block this reduces exactly to the
    r3 global-MEC formulation.

    Returns (site_pos, n_sites, A, hp, read_block (R,) i16 (-1 =
    unphased), sa0, sa1, site_h, conn).
    """
    R, S = A.shape
    i32 = jnp.int32

    # --- purification (integer 3-sigma co-phasing test) ---------------
    covA = A >= 0
    passed = jnp.zeros(S, bool)
    for d in range(1, min(purify_window, S - 1) + 1):
        both = covA[:, :-d] & covA[:, d:]
        n = both.sum(0, dtype=i32)
        same = ((A[:, :-d] == A[:, d:]) & both).sum(0, dtype=i32)
        dev = jnp.abs(2 * same - n)
        ok = ((n >= purify_min_pairs)
              & (dev * purify_den >= n * purify_num)
              & (dev * dev >= 9 * n))
        passed = passed | jnp.pad(ok, (0, d)) | jnp.pad(ok, (d, 0))
    n_het = sel.sum()
    passed = jnp.where(n_het >= 2, passed, sel)  # <2 sites: purify is a no-op
    new_valid = sel & passed
    # re-compact (valid sites keep ascending position order)
    slot = jnp.arange(S, dtype=i32)
    order2 = jnp.argsort(jnp.where(new_valid, slot, S + slot))
    A = jnp.take(A, order2, axis=1)
    site_pos = jnp.take(site_pos, order2)
    new_valid = jnp.take(new_valid, order2)
    A = jnp.where(new_valid[None, :], A, jnp.int8(-1))
    n_sites = new_valid.sum().astype(i32)

    # --- block structure ----------------------------------------------
    covA = A >= 0
    link = (covA[:, :-1] & covA[:, 1:]).any(0)            # (S-1,)
    ar = jnp.arange(S, dtype=i32)
    is_start = jnp.concatenate([jnp.ones(1, bool), ~link])
    start_of = jax.lax.cummax(jnp.where(is_start, ar, 0))
    is_end = jnp.concatenate([~link, jnp.ones(1, bool)])
    end_of = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(is_end, ar, S - 1))))
    blk = jnp.cumsum(jnp.concatenate(
        [jnp.zeros(1, i32), (~link).astype(i32)]))

    # --- MEC phasing (per block) --------------------------------------
    # chained adjacent-site parity init (cumulative XOR, reset per block)
    both = covA[:, :-1] & covA[:, 1:]
    nb = both.sum(0, dtype=i32)
    same = ((A[:, :-1] == A[:, 1:]) & both).sum(0, dtype=i32)
    flip = ((nb > 0) & (same < nb - same)).astype(i32)
    H = jnp.concatenate([jnp.zeros(1, i32), jnp.cumsum(flip)])
    h = ((H - H[start_of]) % 2).astype(jnp.int8)

    def bsum(M):
        """Per-site sums of M over the site's block (prefix-sum gather)."""
        P = jnp.cumsum(M, axis=1)
        hi = jnp.take(P, end_of, axis=1)
        lo = jnp.where((start_of > 0)[None, :],
                       jnp.take(P, jnp.maximum(start_of - 1, 0), axis=1), 0)
        return hi - lo

    def it(_, h):
        agree = bsum(((A == h[None, :]) & covA).astype(i32))
        dis = bsum(((A == (1 - h)[None, :]) & covA).astype(i32))
        as0 = agree >= dis         # read assigned hap1 within s's block
        v1 = ((A == 1) & covA & as0).sum(0, dtype=i32) + \
             ((A == 0) & covA & ~as0).sum(0, dtype=i32)
        v0 = ((A == 0) & covA & as0).sum(0, dtype=i32) + \
             ((A == 1) & covA & ~as0).sum(0, dtype=i32)
        return jnp.where(v1 > v0, 1, 0).astype(jnp.int8)

    h = jax.lax.fori_loop(0, mec_iters, it, h)
    agree = bsum(((A == h[None, :]) & covA).astype(i32))
    dis = bsum(((A == (1 - h)[None, :]) & covA).astype(i32))
    as0 = agree >= dis
    fs = jnp.argmax(covA, axis=1).astype(i32)   # first covered site
    has = covA.any(1)
    a_first = jnp.take_along_axis(as0, fs[:, None], axis=1)[:, 0]
    hp = jnp.where(rv & has,
                   jnp.where(a_first, 1, 2), 0).astype(jnp.int8)
    read_block = jnp.where(rv & has, blk[fs], -1).astype(jnp.int16)

    # --- per-site summaries shipped INSTEAD of the (R, S) allele matrix
    sa0 = code_map[a0[site_pos]]
    sa1 = code_map[a1[site_pos]]
    hap1 = (hp == 1)[:, None]
    hap2 = (hp == 2)[:, None]
    v1 = ((A == 1) & hap1).sum(0, dtype=i32) + \
         ((A == 0) & hap2).sum(0, dtype=i32)
    v0 = ((A == 0) & hap1).sum(0, dtype=i32) + \
         ((A == 1) & hap2).sum(0, dtype=i32)
    site_h = (v1 > v0).astype(jnp.uint8)
    conn = jnp.pad(link, (0, 1)).astype(jnp.uint8)
    return site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h, conn


def _one_region(
    m, rv, L_true=None, *,
    max_sites, mec_iters, min_site_depth, min_minor_count,
    lo_num, lo_den, hi_num, hi_den,
    purify_window, purify_min_pairs, purify_num, purify_den,
):
    """One region's phasing + consensus; see the module docstring.

    ``L_true``: the region's REAL length (the array length L is a padded
    bucket shape); site-selection strip geometry must use it (see
    _select_sites_strips_dynamic).  None = the array length.

    Returns (site_pos (S,) i32, n_sites () i32, A (R,S) i8, hp (R,) i8,
    sym (2,L) u8, covered (2,L) bool).
    """
    R, L = m.shape
    if L_true is None:
        L_true = L
    S = max_sites
    # --- het-site detection over the 5 allele symbols {A,C,G,T,DEL}:
    #     a deleted column is a first-class phasing allele
    #     (phasing/phase.py::ALLELE_CODES); NOCOV (255) never matches ----
    allele_codes = (0, 1, 2, 3, DEL_SYM)
    counts = jnp.stack(
        [(m == b).sum(0, dtype=jnp.int32) for b in allele_codes], axis=1)
    depth = counts.sum(1)
    a0 = jnp.argmax(counts, axis=1)
    onehot0 = jax.nn.one_hot(a0, len(allele_codes), dtype=jnp.bool_)
    masked = jnp.where(onehot0, -1, counts)
    a1 = jnp.argmax(masked, axis=1)
    top1 = jnp.max(masked, axis=1)            # minor-allele count
    n0 = jnp.max(counts, axis=1)              # major-allele count
    is_het = (
        (depth >= max(min_site_depth, 1))
        & (top1 * lo_den >= depth * lo_num)
        & (top1 * hi_den <= depth * hi_num)
        & (top1 >= min_minor_count)
    )
    # strip-based selection: one best-balance site per L_true/S strip
    # (positional spread; phasing/phase.py::select_sites_strips --
    # bit-identical, with strips over the TRUE region length)
    bal = jnp.where(
        is_het,
        _ratio_f32(top1, jnp.maximum(n0 + top1, 1)),
        jnp.float32(-1.0))
    site_pos, sel = _select_sites_strips_dynamic(bal, L_true, S)
    # compact selected sites to the front (position order preserved)
    slot0 = jnp.arange(S, dtype=jnp.int32)
    order0 = jnp.argsort(jnp.where(sel, slot0, S + slot0))
    site_pos = jnp.take(site_pos, order0)
    sel = jnp.take(sel, order0)
    site_pos = jnp.where(sel, site_pos, 0)   # keep invalid gathers in range
    code_map = jnp.asarray(np.array(allele_codes, np.uint8))
    sa0 = code_map[a0[site_pos]]
    sa1 = code_map[a1[site_pos]]
    sub = m[:, site_pos]
    A = jnp.where(sub == sa0[None, :], 0,
                  jnp.where(sub == sa1[None, :], 1, -1)).astype(jnp.int8)
    A = jnp.where(sel[None, :] & rv[:, None], A, jnp.int8(-1))

    (site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h,
     conn) = _phase_core(
        A, site_pos, sel, rv, a0, a1, code_map,
        mec_iters=mec_iters, purify_window=purify_window,
        purify_min_pairs=purify_min_pairs, purify_num=purify_num,
        purify_den=purify_den)

    # --- consensus votes per haplotype (unphased reads vote in both) --
    def vote(mask):
        use = (mask | (hp == 0)) & rv
        c = jnp.stack(
            [((m == b) & use[:, None]).sum(0, dtype=jnp.int32)
             for b in range(5)]
            + [((m == DEL_SYM) & use[:, None]).sum(0, dtype=jnp.int32)],
            axis=1)
        return jnp.argmax(c, axis=1).astype(jnp.uint8), c.sum(1) > 0

    s1, c1 = vote(hp == 1)
    s2, c2 = vote(hp == 2)
    return (site_pos, n_sites, A, hp,
            jnp.stack([s1, s2]), jnp.stack([c1, c2]),
            sa0, sa1, site_h, conn, read_block)


_STATIC_NAMES = (
    "max_sites", "mec_iters", "min_site_depth", "min_minor_count",
    "lo_num", "lo_den", "hi_num", "hi_den",
    "purify_window", "purify_min_pairs", "purify_num", "purify_den",
)


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES)
def phase_consensus_batch(
    mat: jax.Array,          # (G, R, L) uint8 pileup tiles (254=del, 255=nocov)
    read_valid: jax.Array,   # (G, R) bool
    *,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,     # min_allele_frac as a rational
    hi_num: int = 3, hi_den: int = 4,     # max_allele_frac as a rational
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,   # purify min_corr rational
):
    """Unpacked-tile entry (tests, dry runs).  Returns per region (leading G
    axis): site_pos (S,) i32, n_sites i32, A (R,S) i8, hp (R,) i8,
    sym (2,L) u8, covered (2,L) bool."""
    kw = dict(
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)
    out = jax.vmap(lambda m, rv: _one_region(m, rv, **kw))(mat, read_valid)
    return out[:6]


def _flat_parts(res_tuple, L):
    """Assemble one region's flat result buffer from _one_region outputs."""
    (site_pos, n_sites, _A, hp, sym, cov,
     sa0, sa1, site_h, conn, read_block) = res_tuple
    # split-half 4-bit pack of the (2, L) consensus symbols (values 0..5)
    h = L // 2
    symnib = (sym[:, :h] | (sym[:, h:] << 4)).astype(jnp.uint8)
    return [
        jax.lax.bitcast_convert_type(n_sites[None], jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(site_pos, jnp.uint8).reshape(-1),
        sa0.reshape(-1),
        sa1.reshape(-1),
        site_h.reshape(-1),
        conn.reshape(-1),
        jax.lax.bitcast_convert_type(hp, jnp.uint8).reshape(-1),
        jax.lax.bitcast_convert_type(read_block, jnp.uint8).reshape(-1),
        symnib.reshape(-1),
        jnp.packbits(cov.reshape(-1)),
    ]


def _flat_parts_rle(res_tuple, ref, ltrue, Drle):
    """Flat result with RUN-LENGTH-ENCODED consensus tracks (vs the region
    reference the delta kernel already holds): wire.flat_layout_rle.

    The dense flat buffer ships 1.25*L bytes of symnib+covbits per region;
    a voted consensus deviates from the reference at only the variant
    sites, deletion runs, and low-depth holes, so encoding each track as
    (start, len, state) runs cuts the d2h payload (and its decode) by
    ~10-50x.  state = voted symbol 0..5 when covered, 7 when uncovered;
    a track whose true run count exceeds Drle reports it via n_runs and
    the host falls back to the per-region host path (exact, just slower).
    """
    (site_pos, n_sites, _A, hp, sym, cov,
     sa0, sa1, site_h, conn, read_block) = res_tuple
    L = sym.shape[1]
    i32 = jnp.int32
    colv = jnp.arange(L, dtype=i32) < ltrue

    def track(k):
        # scatter-free compaction: the runs are located with cumsum +
        # searchsorted (binary-search gathers) instead of a scatter -- the
        # i-th run starts at the first column whose boundary-cumsum is i+1,
        # and its length is the dev-column count between its start and the
        # next run's start (runs' dev columns are contiguous by definition)
        s = sym[k].astype(jnp.uint8)
        c = cov[k]
        state = jnp.where(c, s, jnp.uint8(7))
        dev = colv & ~(c & (s == ref))
        prev_dev = jnp.concatenate([jnp.zeros(1, jnp.bool_), dev[:-1]])
        prev_state = jnp.concatenate(
            [jnp.full(1, 255, jnp.uint8), state[:-1]])
        boundary = dev & (~prev_dev | (state != prev_state))
        cb = jnp.cumsum(boundary.astype(i32))
        n_runs = cb[-1]
        cd2 = jnp.concatenate([jnp.zeros(1, i32),
                               jnp.cumsum(dev.astype(i32))])
        starts = jnp.searchsorted(
            cb, jnp.arange(1, Drle + 2, dtype=i32))         # (Drle+1,)
        run_start = starts[:Drle]
        run_len = cd2[starts[1:]] - cd2[run_start]
        run_val = state[jnp.clip(run_start, 0, L - 1)]
        return n_runs, run_start.astype(i32), run_len.astype(i32), run_val

    n0, rs0, rl0, rv0 = track(0)
    n1, rs1, rl1, rv1 = track(1)
    u8 = lambda a: jax.lax.bitcast_convert_type(a, jnp.uint8).reshape(-1)  # noqa: E731
    return [
        u8(n_sites[None]),
        u8(site_pos),
        sa0.reshape(-1),
        sa1.reshape(-1),
        site_h.reshape(-1),
        conn.reshape(-1),
        u8(hp),
        u8(read_block),
        u8(jnp.stack([n0, n1])),
        u8(jnp.stack([rs0, rs1])),
        u8(jnp.stack([rl0, rl1])),
        rv0.reshape(-1), rv1.reshape(-1),
    ]


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES + ("L",))
def phase_consensus_batch_packed(
    packed: jax.Array,       # (G, R, L//2) packed nibbles (pack_nibbles)
    read_valid: jax.Array,   # (G, R) bool
    *,
    L: int,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
):
    """Production entry: packed 4-bit tiles in, ONE flat uint8 buffer out
    (layout per flat_layout).  L must be a multiple of 8."""
    kw = dict(
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)

    def one(p, rv):
        m = _unpack_nibbles(p, L)
        return jnp.concatenate(_flat_parts(_one_region(m, rv, **kw), L))

    G = packed.shape[0]
    inner = 8
    if G <= inner or G % inner != 0:
        return jax.vmap(one)(packed, read_valid)
    # one big transfer, bounded working set: the unpacked (inner, R, L)
    # pileups and their vote temporaries exist for one inner chunk at a
    # time (a full-G vmap OOMs HBM on large batches)
    p4 = packed.reshape(G // inner, inner, *packed.shape[1:])
    rv4 = read_valid.reshape(G // inner, inner, read_valid.shape[1])
    out = jax.lax.map(lambda args: jax.vmap(one)(*args), (p4, rv4))
    return out.reshape(G, -1)


def _one_region_delta(
    ref, starts, ends, rv, sub_pos, sub_read, sub_sym,
    del_read, del_a, del_b, L_true=None, *,
    max_sites, mec_iters, min_site_depth, min_minor_count,
    lo_num, lo_den, hi_num, hi_den,
    purify_window, purify_min_pairs, purify_num, purify_den,
):
    """One region's phasing + consensus from REFERENCE-DELTA encoded reads.

    The pileup never exists: each read is its covered span [start, end)
    plus sparse deviations from the reference -- substitutions (col, sym)
    and deletion runs [a, b).  Column symbol counts are reconstructed
    exactly (integer event cumsums + scatter-adds), so every downstream
    quantity (het band, site selection, purify, MEC, consensus vote) is
    bit-identical to the dense-tile kernel `_one_region` -- the host ships
    ~R*deviations bytes instead of R*span/2, and the kernel does
    O(R*S + D + L) work instead of O(R*L).

    Shapes: ref (L,) u8; starts/ends (R,) i32 region columns; rv (R,) bool;
    sub_* (Dsub,) with read < 0 on padding; del_* (Ddel,) likewise.
    Returns the `_one_region` output tuple.
    """
    L = ref.shape[0]
    if L_true is None:
        L_true = L
    R = starts.shape[0]
    S = max_sites
    i32 = jnp.int32

    rw = rv.astype(i32)
    vstart = jnp.where(rv, starts, 0)
    vend = jnp.where(rv, ends, 0)
    cov = jnp.cumsum(jnp.zeros(L + 1, i32).at[vstart].add(rw)
                     .at[vend].add(-rw))[:L]

    wd = (del_read >= 0)
    wdi = wd.astype(i32)
    da = jnp.where(wd, del_a, 0)
    db = jnp.where(wd, del_b, 0)
    delcov = jnp.cumsum(jnp.zeros(L + 1, i32).at[da].add(wdi)
                        .at[db].add(-wdi))[:L]

    ws = (sub_read >= 0)
    wsi = ws.astype(i32)
    sp = jnp.where(ws, sub_pos, L)          # padding -> dump column L
    nsubs = jnp.zeros(L + 1, i32).at[sp].add(wsi)[:L]
    # per-symbol substitution counts incl. N (col 4): alleles use :4,
    # the consensus vote uses all 5
    subcnt = jnp.zeros((L + 1, 5), i32).at[
        sp, jnp.clip(sub_sym, 0, 4).astype(i32)].add(wsi)[:L]

    base = cov - delcov - nsubs             # reads matching ref per column
    ref_i = ref.astype(i32)
    oh4 = ref_i[:, None] == jnp.arange(4, dtype=i32)[None, :]   # (L, 4)
    counts = jnp.concatenate(
        [base[:, None] * oh4 + subcnt[:, :4], delcov[:, None]], axis=1)

    # --- het-site detection + strip selection (bitwise as _one_region) --
    allele_codes = (0, 1, 2, 3, DEL_SYM)
    depth = counts.sum(1)
    a0 = jnp.argmax(counts, axis=1)
    onehot0 = jax.nn.one_hot(a0, len(allele_codes), dtype=jnp.bool_)
    masked = jnp.where(onehot0, -1, counts)
    a1 = jnp.argmax(masked, axis=1)
    top1 = jnp.max(masked, axis=1)
    is_het = (
        (depth >= max(min_site_depth, 1))
        & (top1 * lo_den >= depth * lo_num)
        & (top1 * hi_den <= depth * hi_num)
        & (top1 >= min_minor_count)
    )
    n0 = jnp.max(counts, axis=1)
    bal = jnp.where(
        is_het,
        _ratio_f32(top1, jnp.maximum(n0 + top1, 1)),
        jnp.float32(-1.0))
    site_pos, sel = _select_sites_strips_dynamic(bal, L_true, S)
    slot0 = jnp.arange(S, dtype=i32)
    order0 = jnp.argsort(jnp.where(sel, slot0, S + slot0))
    site_pos = jnp.take(site_pos, order0)
    sel = jnp.take(sel, order0)
    site_pos = jnp.where(sel, site_pos, 0)
    code_map = jnp.asarray(np.array(allele_codes, np.uint8))
    sa0 = code_map[a0[site_pos]]
    sa1 = code_map[a1[site_pos]]

    # --- allele matrix from the deltas (dense: sub = m[:, site_pos]) ----
    # per-site read symbol = ref unless a substitution lands on the site
    # (col->slot inverse map + one scatter) or a deletion run covers it
    col2slot = jnp.full(L + 1, S, i32).at[
        jnp.where(sel, site_pos, L)].set(jnp.arange(S, dtype=i32))
    base_sym = ref[site_pos]                                     # (S,)
    a_sym = jnp.broadcast_to(base_sym[None, :], (R, S))
    a_sym = jnp.concatenate(
        [a_sym, jnp.full((R, 1), NOCOV, jnp.uint8)], axis=1)     # dump col
    a_sym = jnp.concatenate(
        [a_sym, jnp.full((1, S + 1), NOCOV, jnp.uint8)], axis=0)  # dump row
    sub_r = jnp.where(ws, sub_read, R).astype(i32)
    sub_slot = jnp.where(ws, col2slot[sp], S)
    a_sym = a_sym.at[sub_r, sub_slot].set(sub_sym)
    # deletion-run coverage of sites: (Ddel, S) membership, scatter-add
    # into reads (duplicate rows accumulate)
    inside = ((site_pos[None, :] >= da[:, None])
              & (site_pos[None, :] < db[:, None])
              & wd[:, None] & sel[None, :]).astype(i32)
    del_r = jnp.where(wd, del_read, R).astype(i32)
    a_del = jnp.zeros((R + 1, S), i32).at[del_r].add(inside)[:R]
    span_cov = ((site_pos[None, :] >= starts[:, None])
                & (site_pos[None, :] < ends[:, None]) & rv[:, None])
    sub = jnp.where(a_del > 0, jnp.uint8(DEL_SYM), a_sym[:R, :S])
    sub = jnp.where(span_cov, sub, jnp.uint8(NOCOV))
    A = jnp.where(sub == sa0[None, :], 0,
                  jnp.where(sub == sa1[None, :], 1, -1)).astype(jnp.int8)
    A = jnp.where(sel[None, :] & rv[:, None], A, jnp.int8(-1))

    (site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h,
     conn) = _phase_core(
        A, site_pos, sel, rv, a0, a1, code_map,
        mec_iters=mec_iters, purify_window=purify_window,
        purify_min_pairs=purify_min_pairs, purify_num=purify_num,
        purify_den=purify_den)

    # --- consensus votes per haplotype from the deltas -----------------
    # (dense `vote` reconstruction: per-column 6-symbol counts over the
    # use-mask; ref-matching reads contribute to the ref symbol, subs to
    # their own symbol incl. N, deletion runs to the DEL column)
    oh5 = ref_i[:, None] == jnp.arange(5, dtype=i32)[None, :]    # (L, 5)

    def vote(mask):
        use = (mask | (hp == 0)) & rv
        uw = use.astype(i32)
        cov_u = jnp.cumsum(jnp.zeros(L + 1, i32).at[vstart].add(uw)
                           .at[vend].add(-uw))[:L]
        use1 = jnp.concatenate([use, jnp.zeros(1, bool)])
        wdu = (wd & use1[del_r]).astype(i32)
        del_u = jnp.cumsum(jnp.zeros(L + 1, i32).at[da].add(wdu)
                           .at[db].add(-wdu))[:L]
        wsu = (ws & use1[sub_r]).astype(i32)
        nsubs_u = jnp.zeros(L + 1, i32).at[sp].add(wsu)[:L]
        subcnt_u = jnp.zeros((L + 1, 5), i32).at[
            sp, jnp.clip(sub_sym, 0, 4).astype(i32)].add(wsu)[:L]
        base_u = cov_u - del_u - nsubs_u
        c = jnp.concatenate(
            [base_u[:, None] * oh5 + subcnt_u, del_u[:, None]], axis=1)
        return jnp.argmax(c, axis=1).astype(jnp.uint8), c.sum(1) > 0

    s1, c1 = vote(hp == 1)
    s2, c2 = vote(hp == 2)
    return (site_pos, n_sites, A, hp,
            jnp.stack([s1, s2]), jnp.stack([c1, c2]),
            sa0, sa1, site_h, conn, read_block)


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES + ("L",))
def phase_consensus_delta(
    ref: jax.Array,          # (G, L) uint8 region reference codes
    starts: jax.Array,       # (G, R) int32 covered-span starts
    ends: jax.Array,         # (G, R) int32 covered-span ends
    read_valid: jax.Array,   # (G, R) bool
    sub_pos: jax.Array,      # (G, Dsub) int32
    sub_read: jax.Array,     # (G, Dsub) int32 (< 0 on padding)
    sub_sym: jax.Array,      # (G, Dsub) uint8
    del_read: jax.Array,     # (G, Ddel) int32 (< 0 on padding)
    del_a: jax.Array,        # (G, Ddel) int32
    del_b: jax.Array,        # (G, Ddel) int32
    ltrue: jax.Array = None,  # (G,) int32 true region length (None = L)
    *,
    L: int,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
):
    """Production entry for DELTA-encoded region tiles: ONE flat uint8
    buffer per region out (flat_layout), bit-identical to the dense-tile
    kernels.  h2d is O(reads + deviations) instead of O(reads * span)."""
    kw = dict(
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)
    if ltrue is None:
        ltrue = jnp.full(ref.shape[0], L, jnp.int32)

    def one(*args):
        return jnp.concatenate(_flat_parts(_one_region_delta(*args, **kw), L))

    return jax.vmap(one)(ref, starts, ends, read_valid, sub_pos, sub_read,
                         sub_sym, del_read, del_a, del_b, ltrue)


def _u8_to_i32(seg: jax.Array, *shape: int) -> jax.Array:
    """Static-slice uint8 segment -> int32 array (little-endian bitcast,
    matching the host's np .view packing)."""
    return jax.lax.bitcast_convert_type(
        seg.reshape(*shape, 4), jnp.int32)


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES
                   + ("G", "R", "L", "Ds", "Dd", "Drle"))
def phase_consensus_delta_flat(
    buf: jax.Array,          # (total,) uint8, delta_flat_layout
    *,
    G: int, R: int, L: int, Ds: int, Dd: int,
    Drle: int = 0,           # >0: RLE consensus tracks (flat_layout_rle)
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
):
    """Single-argument production entry: unpacks delta_flat_layout on
    device and runs phase_consensus_delta's math."""
    lay = delta_flat_layout(G, R, L, Ds, Dd)

    def seg(name):
        a, b = lay[name]
        return buf[a:b]

    ref = seg("ref").reshape(G, L)
    starts = _u8_to_i32(seg("starts"), G, R)
    ends = _u8_to_i32(seg("ends"), G, R)
    rv = seg("rv").reshape(G, R) != 0
    sub_pos = _u8_to_i32(seg("sub_pos"), G, Ds)
    sub_read = _u8_to_i32(seg("sub_read"), G, Ds)
    sub_sym = seg("sub_sym").reshape(G, Ds)
    del_read = _u8_to_i32(seg("del_read"), G, Dd)
    del_a = _u8_to_i32(seg("del_a"), G, Dd)
    del_b = _u8_to_i32(seg("del_b"), G, Dd)
    ltrue = _u8_to_i32(seg("ltrue"), G)
    kw = dict(
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)

    def one(*args):
        out = _one_region_delta(*args, **kw)
        if Drle:
            return jnp.concatenate(
                _flat_parts_rle(out, args[0], args[-1], Drle))
        return jnp.concatenate(_flat_parts(out, L))

    return jax.vmap(one)(ref, starts, ends, rv, sub_pos, sub_read,
                         sub_sym, del_read, del_a, del_b, ltrue)


def sharded_phase_consensus_delta_flat(buf, mesh, *, G, R, L, Ds, Dd, **kw):
    """phase_consensus_delta_flat sharded over the mesh's regions axis.

    The flat buffer is reshaped to (n_dev, bytes/dev) so the region batch
    splits across devices (G must be divisible by the mesh size; the
    per-device slice is a valid delta_flat_layout of G/n_dev regions only
    when every section's G-stride divides evenly, which pack_delta_chunk's
    G-major layout does NOT -- so shard by re-packing per device)."""
    n = mesh.size
    assert G % n == 0, (G, n)
    Gd = G // n
    lay = delta_flat_layout(G, R, L, Ds, Dd)
    # slice each G-major section into per-device contiguous blocks and
    # re-concatenate so every device holds a self-contained Gd-layout
    parts = []
    for d in range(n):
        segs = []
        for name in ("ref", "starts", "ends", "rv", "sub_pos", "sub_read",
                     "sub_sym", "del_read", "del_a", "del_b", "ltrue"):
            a, b = lay[name]
            per = (b - a) // G
            segs.append(buf[a + d * Gd * per : a + (d + 1) * Gd * per])
        parts.append(np.concatenate(segs))
    dev_buf = np.stack(parts)          # (n, bytes_per_device)
    fn = _sharded_flat_fn(mesh, "delta",
                          (("G", Gd), ("R", R), ("L", L), ("Ds", Ds),
                           ("Dd", Dd)) + tuple(sorted(kw.items())))
    return fn(dev_buf).reshape(G, -1)


@functools.lru_cache(maxsize=64)
def _sharded_flat_fn(mesh, kind: str, params: tuple):
    """Cached jitted shard_map of a flat region-step entry.

    Rebuilding the shard_map callable per dispatch retraced AND recompiled
    the whole sharded program every call (measured 18x the steady-state
    dispatch wall on the virtual mesh); the cache keys on (mesh, kind,
    static params) so repeat dispatches hit the compiled executable."""
    from jax.sharding import PartitionSpec as P

    from focalsv_tpu.parallel.mesh import DATA_AXIS
    kw = dict(params)
    inner = (phase_consensus_delta_flat if kind == "delta"
             else phase_consensus_rows_flat)
    spec = P(DATA_AXIS)
    return jax.jit(jax.shard_map(
        lambda bb: inner(bb[0], **kw),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    ))


@functools.lru_cache(maxsize=64)
def _sharded_generic_fn(mesh, entry_name: str, n_args: int, n_out,
                        params: tuple):
    """Cached jitted shard_map of a non-flat entry (same retrace hazard as
    _sharded_flat_fn; these power the dryrun and test paths)."""
    from jax.sharding import PartitionSpec as P

    from focalsv_tpu.parallel.mesh import DATA_AXIS
    kw = dict(params)
    inner = globals()[entry_name]
    spec = P(DATA_AXIS)
    return jax.jit(jax.shard_map(
        lambda *a: inner(*a, **kw),
        mesh=mesh,
        in_specs=(spec,) * n_args,
        out_specs=(spec,) * n_out if n_out else spec,
        check_vma=False,
    ))


def sharded_phase_consensus_delta(args: tuple, mesh, *, L, **kw):
    """phase_consensus_delta sharded over the mesh's regions axis."""
    from jax.sharding import PartitionSpec as P

    from focalsv_tpu.parallel.mesh import DATA_AXIS
    spec = P(DATA_AXIS)
    fn = jax.shard_map(
        lambda *a: phase_consensus_delta(*a, L=L, **kw),
        mesh=mesh,
        in_specs=(spec,) * len(args),
        out_specs=spec,
        check_vma=False,
    )
    return fn(*args)


# Row starts are quantized to BLOCK columns: the host pre-shifts each row
@functools.partial(jax.jit, static_argnames=_STATIC_NAMES + ("L", "W"))
def phase_consensus_rows_packed(
    packed_rows: jax.Array,  # (G, R, W//2) split-half packed compact rows
    row_qstart: jax.Array,   # (G, R) int32 region BLOCK index of each row
    read_valid: jax.Array,   # (G, R) bool
    ltrue: jax.Array = None,  # (G,) int32 true region length (None = L)
    *,
    L: int,
    W: int,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
):
    """Production entry for COMPACT row tiles: rows expand into the (R, L)
    pileup ON DEVICE, so the host never materializes (and never transfers)
    the ~90%-NOCOV dense matrix -- h2d bytes drop from R*L/2 to R*W/2
    (W ~ read span << L for large regions).  Row starts arrive quantized
    to BLOCK columns (pack_row_tile pre-shifts each row by start % BLOCK),
    so the expansion is a BLOCK-contiguous chunk gather -- ~100x fewer
    gather indices than the per-element formulation.  Output: the same
    flat buffer as
    phase_consensus_batch_packed."""
    kw = dict(
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)
    assert L % BLOCK == 0 and W % BLOCK == 0, (L, W)
    nb_out, nb_in = L // BLOCK, W // BLOCK
    G = packed_rows.shape[0]
    if ltrue is None:
        ltrue = jnp.full(G, L, jnp.int32)

    def one(p, q, rv, lt):
        rows = _unpack_nibbles(p, W)                       # (R, W)
        R = rows.shape[0]
        rb = rows.reshape(R, nb_in, BLOCK)
        idx = jnp.arange(nb_out, dtype=jnp.int32)[None, :] - q[:, None]
        inb = (idx >= 0) & (idx < nb_in)                   # (R, nb_out)
        g = jnp.take_along_axis(
            rb, jnp.clip(idx, 0, nb_in - 1)[..., None], axis=1)
        m = jnp.where(inb[..., None], g, jnp.uint8(NOCOV)).reshape(R, L)
        return jnp.concatenate(_flat_parts(_one_region(m, rv, lt, **kw), L))

    inner = 8
    if G <= inner or G % inner != 0:
        return jax.vmap(one)(packed_rows, row_qstart, read_valid, ltrue)
    # bounded working set: the expanded (inner, R, L) pileups exist for one
    # inner chunk at a time (full-G expansion OOMs HBM on large batches)
    p4 = packed_rows.reshape(G // inner, inner, *packed_rows.shape[1:])
    s4 = row_qstart.reshape(G // inner, inner, row_qstart.shape[1])
    rv4 = read_valid.reshape(G // inner, inner, read_valid.shape[1])
    l4 = ltrue.reshape(G // inner, inner)
    out = jax.lax.map(lambda args: jax.vmap(one)(*args), (p4, s4, rv4, l4))
    return out.reshape(G, -1)


@functools.partial(jax.jit, static_argnames=_STATIC_NAMES
                   + ("G", "R", "L", "W"))
def phase_consensus_rows_flat(
    buf: jax.Array,          # (total,) uint8, rows_flat_layout
    *,
    G: int, R: int, L: int, W: int,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
):
    """Single-argument dense entry: unpacks rows_flat_layout on device and
    runs phase_consensus_rows_packed's math."""
    lay = rows_flat_layout(G, R, W)

    def seg(name):
        a, b = lay[name]
        return buf[a:b]

    rows = seg("rows").reshape(G, R, W // 2)
    qstart = _u8_to_i32(seg("qstart"), G, R)
    rv = seg("rv").reshape(G, R) != 0
    ltrue = _u8_to_i32(seg("ltrue"), G)
    return phase_consensus_rows_packed(
        rows, qstart, rv, ltrue, L=L, W=W,
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)


def sharded_phase_consensus_rows_flat(buf, mesh, *, G, R, L, W, **kw):
    """phase_consensus_rows_flat sharded over the mesh's regions axis
    (per-device re-pack, as sharded_phase_consensus_delta_flat)."""
    n = mesh.size
    assert G % n == 0, (G, n)
    Gd = G // n
    lay = rows_flat_layout(G, R, W)
    parts = []
    for d in range(n):
        segs = []
        for name in ("rows", "qstart", "rv", "ltrue"):
            a, b = lay[name]
            per = (b - a) // G
            segs.append(buf[a + d * Gd * per : a + (d + 1) * Gd * per])
        parts.append(np.concatenate(segs))
    dev_buf = np.stack(parts)
    fn = _sharded_flat_fn(mesh, "rows",
                          (("G", Gd), ("R", R), ("L", L), ("W", W))
                          + tuple(sorted(kw.items())))
    return fn(dev_buf).reshape(G, -1)


def sharded_phase_consensus_rows_packed(packed_rows, row_start, read_valid,
                                        mesh, *, L, W, **kw):
    """phase_consensus_rows_packed sharded over the mesh's regions axis."""
    from jax.sharding import PartitionSpec as P

    from focalsv_tpu.parallel.mesh import DATA_AXIS
    spec = P(DATA_AXIS)
    fn = jax.shard_map(
        lambda p, st, rv: phase_consensus_rows_packed(p, st, rv, L=L, W=W,
                                                      **kw),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(packed_rows, row_start, read_valid)


def phase_consensus_kwargs(phasing_cfg) -> dict:
    """Static kernel knobs from a PhasingConfig (rationalized thresholds)."""
    from focalsv_tpu.phasing.phase import frac_parts
    lo_num, lo_den = frac_parts(phasing_cfg.min_allele_frac)
    hi_num, hi_den = frac_parts(phasing_cfg.max_allele_frac)
    return dict(
        max_sites=phasing_cfg.max_sites,
        mec_iters=phasing_cfg.mec_iters,
        min_site_depth=phasing_cfg.min_site_depth,
        min_minor_count=phasing_cfg.min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
    )


def sharded_phase_consensus(mat, read_valid, mesh, **kw):
    """phase_consensus_batch sharded over the mesh's regions axis."""
    fn = _sharded_generic_fn(mesh, "phase_consensus_batch", 2, 6,
                             tuple(sorted(kw.items())))
    return fn(mat, read_valid)


def sharded_phase_consensus_packed(packed, read_valid, mesh, *, L, **kw):
    """phase_consensus_batch_packed sharded over the mesh's regions axis."""
    from jax.sharding import PartitionSpec as P

    from focalsv_tpu.parallel.mesh import DATA_AXIS
    spec = P(DATA_AXIS)
    fn = jax.shard_map(
        lambda p, rv: phase_consensus_batch_packed(p, rv, L=L, **kw),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(packed, read_valid)
