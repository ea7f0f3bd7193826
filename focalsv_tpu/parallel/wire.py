"""Host-side wire formats of the device region step (jax-free).

Everything here is pure numpy: tile packing (4-bit pileup nibbles, compact
rows), single-buffer chunk layouts for the delta and dense encodings, and
the flat result decode.  Split out of region_step.py so worker processes
that only build tiles and finish regions (pipeline/mp_exec.py) need no
device: only one process opens the card.

Layout rationale (see region_step.py for the device side): each chunk
ships as ONE uint8 buffer both ways, one transfer per direction.  This and
the BLOCK and split-half layouts below were chosen for an earlier
accelerator and await an A/B on the GPU (ROADMAP).
"""

from __future__ import annotations

import numpy as np

NOCOV = 255       # == assembly.consensus.NOCOV
DEL_SYM = 254

# 4-bit pileup symbol codec: halves the host->device bytes of a region tile
# (the dominant transfer).  {A,C,G,T,N} -> 0..4, DEL -> 5, NOCOV -> 15.
NIB_MAP = np.full(256, 15, np.uint8)
NIB_MAP[:5] = np.arange(5)
NIB_MAP[DEL_SYM] = 5
_NIB_INV = np.full(16, NOCOV, np.uint8)
_NIB_INV[:5] = np.arange(5)
_NIB_INV[5] = DEL_SYM

# Compact rows are pre-shifted by start % BLOCK inside their buffer so the
# device expansion gathers BLOCK-contiguous chunks (see region_step).
BLOCK = 128


def pack_nibbles(mat: np.ndarray, L_pad: int | None = None) -> np.ndarray:
    """(R, L) uint8 pileup -> (R, L_pad/2) packed nibbles (host side).

    SPLIT-HALF layout: byte j holds columns j (low nibble) and j + L_pad/2
    (high nibble), so the device unpack is a plain last-axis concatenate
    rather than a (..., L/2, 2) interleave whose trailing dim of 2 a tiled
    device layout may pad many times over.
    Columns beyond L are NOCOV padding (so L_pad just extends the tile)."""
    L = mat.shape[1]
    if L_pad is None:
        L_pad = L + (L % 2)
    assert L_pad % 2 == 0 and L_pad >= L
    # NIB_MAP as arithmetic (symbols <5 map to themselves, DEL_SYM -> 5,
    # rest incl. enc.PAD=5 -> NOCOV): a 256-entry fancy index over the full
    # tile ran ~4x slower than two vectorized selects
    nib = np.where(mat < 5, mat,
                   np.where(mat == DEL_SYM, np.uint8(5), np.uint8(15)))
    if L_pad > L:
        nib = np.concatenate(
            [nib, np.full((nib.shape[0], L_pad - L), 15, np.uint8)], axis=1)
    h = L_pad // 2
    return (nib[:, :h] | (nib[:, h:] << 4)).astype(np.uint8)


def pack_row_tile(rows: list[np.ndarray], W_pad: int,
                  offsets=None) -> np.ndarray:
    """Compact per-read rows -> (R, W_pad/2) split-half packed nibbles.

    Each row (consensus.compact_pileup_rows) is placed at ``offsets[i]``
    (its start % BLOCK; 0 when offsets is None) and padded to W_pad with
    NOCOV; the device expansion treats columns outside the row as NOCOV
    anyway, so padding is free coverage-wise.
    """
    R = len(rows)
    mat = np.full((R, W_pad), NOCOV, np.uint8)
    for i, row in enumerate(rows):
        o = 0 if offsets is None else int(offsets[i])
        mat[i, o : o + len(row)] = row
    return pack_nibbles(mat, W_pad)


def flat_layout(R: int, L: int, S: int) -> dict[str, tuple[int, int]]:
    """Byte offsets of the per-region flat result buffer (device->host is a
    single array, one transfer per chunk).

    The (R, S) allele matrix never leaves the device: the host only needs
    per-site summaries (alleles, hap-1 vote, connectivity), computed on
    device -- at 256 reads x 512 sites that is the difference between a
    131 KB and a 2 KB site payload per region.  Consensus symbols ship as
    4-bit nibbles (split-half, see pack_nibbles)."""
    off = 0
    out = {}
    for name, size in (
        ("n_sites", 4),
        ("site_pos", 4 * S),
        ("site_a0", S),
        ("site_a1", S),
        ("site_h", S),
        ("site_conn", S),
        ("hp", R),
        ("read_block", 2 * R),  # (R,) int16 phase-block id, -1 unphased
        ("symnib", L),          # (2, L) symbols 0..5, packed 2-per-byte
        ("covbits", 2 * (L // 8)),
    ):
        out[name] = (off, off + size)
        off += size
    out["__total__"] = (0, off)
    return out


def unflatten_result(buf: np.ndarray, R: int, L: int, S: int) -> tuple:
    """Host-side decode of one region's flat buffer -> the unpacked tuple
    (site_pos, n_sites, hp, sym, covered, site_a0, site_a1, site_h,
    site_conn)."""
    lay = flat_layout(R, L, S)

    def seg(name):
        a, b = lay[name]
        return buf[a:b]

    n_sites = int(seg("n_sites").view(np.int32)[0])
    site_pos = seg("site_pos").view(np.int32)
    hp = seg("hp").view(np.int8)
    read_block = seg("read_block").view(np.int16)
    symnib = seg("symnib").reshape(2, L // 2)
    h = L // 2
    sym = np.empty((2, L), np.uint8)
    sym[:, :h] = symnib & 0xF
    sym[:, h:] = symnib >> 4
    covered = np.unpackbits(seg("covbits").reshape(2, L // 8),
                            axis=1).astype(bool)
    return (site_pos, n_sites, hp, sym, covered,
            seg("site_a0"), seg("site_a1"), seg("site_h"), seg("site_conn"),
            read_block)


def flat_layout_rle(R: int, S: int, Drle: int) -> dict[str, tuple[int, int]]:
    """Per-region flat result with RLE consensus tracks (no L dependence):
    the dense symnib/covbits sections are replaced by per-track
    (start, len, state) runs vs the region reference.  Must mirror
    region_step._flat_parts_rle's section order."""
    off = 0
    out = {}
    for name, size in (
        ("n_sites", 4),
        ("site_pos", 4 * S),
        ("site_a0", S),
        ("site_a1", S),
        ("site_h", S),
        ("site_conn", S),
        ("hp", R),
        ("read_block", 2 * R),
        ("n_runs", 8),                  # (2,) int32 TRUE run counts
        ("run_start", 2 * 4 * Drle),    # (2, Drle) int32
        ("run_len", 2 * 4 * Drle),      # (2, Drle) int32
        ("run_val", 2 * Drle),          # (2, Drle) uint8 state 0..5 | 7
    ):
        out[name] = (off, off + size)
        off += size
    out["__total__"] = (0, off)
    return out


def unflatten_result_rle(buf: np.ndarray, R: int, S: int, Drle: int,
                         ref_codes: np.ndarray) -> tuple | None:
    """Decode one region's RLE flat buffer -> the unflatten_result tuple.

    The consensus tracks are reconstructed against ``ref_codes`` (length =
    the region's true length): sym = reference except inside runs, cov =
    True except inside state-7 runs.  Columns the device left uncovered
    get sym = 4 (N) -- the dense path ships an argmax-of-zeros garbage
    value there; both are masked by cov everywhere downstream.

    Returns None when a track overflowed Drle (caller takes the host
    fallback path)."""
    lay = flat_layout_rle(R, S, Drle)

    def seg(name):
        a, b = lay[name]
        return buf[a:b]

    n_runs = seg("n_runs").view(np.int32)
    if int(n_runs.max(initial=0)) > Drle:
        return None
    n_sites = int(seg("n_sites").view(np.int32)[0])
    site_pos = seg("site_pos").view(np.int32)
    hp = seg("hp").view(np.int8)
    read_block = seg("read_block").view(np.int16)
    run_start = seg("run_start").view(np.int32).reshape(2, Drle)
    run_len = seg("run_len").view(np.int32).reshape(2, Drle)
    run_val = seg("run_val").reshape(2, Drle)
    L = len(ref_codes)
    sym = np.broadcast_to(np.asarray(ref_codes, np.uint8),
                          (2, L)).copy()
    cov = np.ones((2, L), bool)
    for k in range(2):
        for i in range(int(n_runs[k])):
            a = int(run_start[k, i])
            b = min(a + int(run_len[k, i]), L)
            v = run_val[k, i]
            if v == 7:
                cov[k, a:b] = False
                sym[k, a:b] = 4
            else:
                sym[k, a:b] = v
    return (site_pos, n_sites, hp, sym, cov,
            seg("site_a0"), seg("site_a1"), seg("site_h"), seg("site_conn"),
            read_block)


def delta_flat_layout(G: int, R: int, L: int, Ds: int, Dd: int
                      ) -> dict[str, tuple[int, int]]:
    """Byte offsets of the single-buffer delta chunk wire format.

    One uint8 buffer per chunk instead of ten argument arrays: one h2d
    transfer per chunk, whatever the per-transfer cost of the link.  All
    sections are 4-byte aligned by construction (R, Ds, Dd
    pow2 >= 8; L a 4096-multiple)."""
    out = {}
    off = 0
    for name, size in (
        ("ref", G * L),
        ("starts", G * R * 4),
        ("ends", G * R * 4),
        ("rv", G * R),
        ("sub_pos", G * Ds * 4),
        ("sub_read", G * Ds * 4),
        ("sub_sym", G * Ds),
        ("del_read", G * Dd * 4),
        ("del_a", G * Dd * 4),
        ("del_b", G * Dd * 4),
        ("ltrue", G * 4),       # true region length (strip geometry)
    ):
        out[name] = (off, off + size)
        off += size
    out["__total__"] = (0, off)
    return out


def pack_delta_chunk(tiles, chunk, G: int, R: int, L: int, Ds: int, Dd: int
                     ) -> np.ndarray:
    """Host-side single-buffer pack of one delta chunk (delta_flat_layout).

    ``tiles[i]`` needs .ref_codes, .row_starts, .row_lens, .subs, .dels."""
    lay = delta_flat_layout(G, R, L, Ds, Dd)
    buf = np.zeros(lay["__total__"][1], np.uint8)

    def sect(name, dt, *shape):
        a, b = lay[name]
        return buf[a:b].view(dt).reshape(*shape)

    ref = sect("ref", np.uint8, G, L)
    starts = sect("starts", np.int32, G, R)
    ends = sect("ends", np.int32, G, R)
    rv = sect("rv", np.uint8, G, R)
    sub_pos = sect("sub_pos", np.int32, G, Ds)
    sub_read = sect("sub_read", np.int32, G, Ds)
    sub_sym = sect("sub_sym", np.uint8, G, Ds)
    del_read = sect("del_read", np.int32, G, Dd)
    del_a = sect("del_a", np.int32, G, Dd)
    del_b = sect("del_b", np.int32, G, Dd)
    ltrue = sect("ltrue", np.int32, G)
    sub_read[:] = -1
    del_read[:] = -1
    ltrue[:] = L
    for g, ti in enumerate(chunk):
        t = tiles[ti]
        if t is None:
            continue        # padded slot: rv stays 0 (empty region)
        Ra = t.row_starts.shape[0]
        La = t.region_len
        ltrue[g] = La
        ref[g, :La] = np.asarray(t.ref_codes, np.uint8)
        starts[g, :Ra] = t.row_starts
        ends[g, :Ra] = t.row_starts + t.row_lens
        rv[g, :Ra] = 1
        ns = t.subs[0].size
        sub_pos[g, :ns] = t.subs[0]
        sub_read[g, :ns] = t.subs[1]
        sub_sym[g, :ns] = t.subs[2]
        nd = t.dels[0].size
        del_read[g, :nd] = t.dels[0]
        del_a[g, :nd] = t.dels[1]
        del_b[g, :nd] = t.dels[2]
    return buf


def rows_flat_layout(G: int, R: int, W: int) -> dict[str, tuple[int, int]]:
    """Single-buffer wire format of a dense (packed-rows) chunk: one
    argument array per dispatch (see delta_flat_layout on why)."""
    out = {}
    off = 0
    for name, size in (
        ("rows", G * R * (W // 2)),
        ("qstart", G * R * 4),
        ("rv", G * R),
        ("ltrue", G * 4),       # true region length (strip geometry)
    ):
        out[name] = (off, off + size)
        off += size
    out["__total__"] = (0, off)
    return out


def pack_rows_chunk(tiles, chunk, G: int, R: int, W: int) -> np.ndarray:
    """Host-side single-buffer pack of one dense chunk (rows_flat_layout)."""
    lay = rows_flat_layout(G, R, W)
    buf = np.zeros(lay["__total__"][1], np.uint8)
    a, b = lay["rows"]
    rows = buf[a:b].reshape(G, R, W // 2)
    rows[:] = 0xFF                     # two NOCOV nibbles
    a, b = lay["qstart"]
    qstart = buf[a:b].view(np.int32).reshape(G, R)
    a, b = lay["rv"]
    rv = buf[a:b].reshape(G, R)
    a, b = lay["ltrue"]
    ltrue = buf[a:b].view(np.int32)
    ltrue[:] = W
    for g, ti in enumerate(chunk):
        t = tiles[ti]
        if t is None:
            continue        # padded slot: rv stays 0 (empty region)
        Ra = t.nib.shape[0]
        rows[g, :Ra] = t.nib
        qstart[g, :Ra] = t.q_starts
        rv[g, :Ra] = 1
        ltrue[g] = t.region_len
    return buf
