import numpy as np

from focalsv_tpu.config import preset
from focalsv_tpu.parallel import mesh as pmesh
from focalsv_tpu.parallel.region_step import (
    phase_consensus_batch, phase_consensus_kwargs, sharded_phase_consensus,
)
from focalsv_tpu.assembly.consensus import pileup_with_dels
from focalsv_tpu.testing import simulate as sim


def _tiles(regions, L):
    G = len(regions)
    R = max(len(rg.reads) for rg in regions)
    mat = np.full((G, R, L), 255, np.uint8)
    valid = np.zeros((G, R), bool)
    for g, rg in enumerate(regions):
        m, _ = pileup_with_dels(rg.reads, list(range(len(rg.reads))), 0, L)
        mat[g, : m.shape[0], : m.shape[1]] = m[:, :L]
        valid[g, : len(rg.reads)] = True
    return mat, valid


def test_phase_consensus_batch_recovers_haplotypes():
    L = 12_000
    regions = [sim.simulate_region(seed=500 + i, ref_len=L, coverage=20,
                                   n_snps=15, read_len_mean=5_000,
                                   svs=[]) for i in range(4)]
    mat, valid = _tiles(regions, L)
    kw = phase_consensus_kwargs(preset("HIFI").phasing)
    kw.update(max_sites=32, mec_iters=15)
    out = phase_consensus_batch(mat, valid, **kw)
    site_pos, n_sites, A, hp, sym, cov = [np.asarray(x) for x in out]
    for g, rg in enumerate(regions):
        truth = np.array(rg.read_hap)
        h = hp[g, : len(rg.reads)]
        phased = h > 0
        assert phased.mean() > 0.6, f"region {g}: only {phased.mean()} phased"
        agree = (h[phased] - 1 == truth[phased]).mean()
        assert max(agree, 1 - agree) > 0.9, f"region {g} agreement {agree}"
        assert int(n_sites[g]) > 0
        # valid sites are ascending genome positions
        sp = site_pos[g, : int(n_sites[g])]
        assert (np.diff(sp) > 0).all()
        # consensus columns: where covered, hap consensus must match the
        # reference in most columns (no SVs simulated)
        ref = rg.ref
        covered = cov[g, 0]        # bool coverage mask
        s1 = sym[g, 0]
        base_cols = covered & (s1 < 4)
        match_frac = (s1[base_cols] == ref[np.nonzero(base_cols)[0]]).mean()
        assert match_frac > 0.95


def test_device_phasing_matches_host_reference():
    """The device step's het sites, allele matrix, hp and consensus must
    bit-match the host implementations (the device_exec parity contract,
    checked here at the kernel level)."""
    from focalsv_tpu.phasing import phase as ph

    cfg = preset("HIFI").phasing
    L = 8_000
    regions = [sim.simulate_region(seed=900 + i, ref_len=L, coverage=16,
                                   n_snps=10, read_len_mean=4_000)
               for i in range(3)]
    mat, valid = _tiles(regions, L)
    out = phase_consensus_batch(mat, valid, **phase_consensus_kwargs(cfg))
    site_pos, n_sites, A, hp, sym, cov = [np.asarray(x) for x in out]
    for g, rg in enumerate(regions):
        pr = ph.phase_region(rg.reads, rg.ref, 0, cfg)
        S = int(n_sites[g])
        np.testing.assert_array_equal(
            site_pos[g, :S], pr.site_positions,
            err_msg=f"region {g} het sites")
        if pr.n_blocks <= 1:
            np.testing.assert_array_equal(hp[g, : len(rg.reads)], pr.hp,
                                          err_msg=f"region {g} hp")


def test_sharded_region_step():
    L = 6_000
    regions = [sim.simulate_region(seed=600 + i, ref_len=L, coverage=12,
                                   n_snps=8, read_len_mean=3_000, svs=[])
               for i in range(8)]
    mat, valid = _tiles(regions, L)
    mesh = pmesh.make_mesh()
    kw = phase_consensus_kwargs(preset("HIFI").phasing)
    kw.update(max_sites=16, mec_iters=10)
    out_sharded = sharded_phase_consensus(mat, valid, mesh, **kw)
    out_local = phase_consensus_batch(mat, valid, **kw)
    for a, b in zip(out_sharded, out_local):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _delta_arrays_from_dense(mat, valid, ref):
    """Derive the delta wire arrays from a dense (R, L) pileup (per-read
    span + substitutions + DEL runs), the inverse of the kernel's count
    reconstruction."""
    R, L = mat.shape
    starts = np.zeros(R, np.int32)
    ends = np.zeros(R, np.int32)
    sp, sr, ss = [], [], []
    dr, da, db = [], [], []
    for i in range(R):
        cov = np.nonzero(mat[i] != 255)[0]
        if not valid[i] or cov.size == 0:
            continue
        s0, s1 = int(cov[0]), int(cov[-1]) + 1
        starts[i], ends[i] = s0, s1
        row = mat[i, s0:s1]
        isdel = row == 254
        sub_at = np.nonzero((row != ref[s0:s1]) & ~isdel)[0]
        sp.extend((s0 + sub_at).tolist())
        sr.extend([i] * sub_at.size)
        ss.extend(row[sub_at].tolist())
        d = np.diff(np.concatenate([[0], isdel.astype(np.int8), [0]]))
        for a, b in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            dr.append(i)
            da.append(s0 + int(a))
            db.append(s0 + int(b))
    return (starts, ends,
            (np.array(sp, np.int32), np.array(sr, np.int32),
             np.array(ss, np.uint8)),
            (np.array(dr, np.int32), np.array(da, np.int32),
             np.array(db, np.int32)))


def test_delta_kernel_matches_dense_kernel():
    """phase_consensus_delta must bit-match phase_consensus_batch on a
    pileup with every symbol class: substitutions, N bases, reference-N
    columns, deletion runs, ragged spans and invalid rows."""
    from focalsv_tpu.parallel.region_step import (phase_consensus_delta,
                                                  unflatten_result)
    rng = np.random.default_rng(42)
    R, L, S = 24, 512, 64
    ref = rng.integers(0, 4, L).astype(np.uint8)
    ref[100:103] = 4                       # reference-N columns
    mat = np.full((R, L), 255, np.uint8)
    valid = np.ones(R, bool)
    valid[R - 1] = False                   # one invalid row
    hap = rng.integers(0, 2, R)
    het_sites = np.arange(20, L - 20, 37)
    alt = (ref + 1) % 4
    for i in range(R - 1):
        s0 = int(rng.integers(0, L // 3))
        s1 = int(rng.integers(2 * L // 3, L)) + 1
        row = ref[s0:s1].copy()
        if hap[i]:                         # hap-1 carries the alt alleles
            for p in het_sites:
                if s0 <= p < s1:
                    row[p - s0] = alt[p]
        err = rng.random(row.size) < 0.02  # random subs incl. some N
        row[err] = rng.integers(0, 5, int(err.sum()))
        if i % 5 == 0:                     # a deletion run
            a = int(rng.integers(0, row.size - 40))
            row[a : a + 30] = 254
        mat[i, s0:s1] = row
    kw = dict(max_sites=S, mec_iters=10)
    d_site, d_n, _dA, d_hp, d_sym, d_cov = (
        np.asarray(x) for x in phase_consensus_batch(
            mat[None], valid[None], **kw))
    starts, ends, subs, dels = _delta_arrays_from_dense(mat, valid, ref)
    flat = np.asarray(phase_consensus_delta(
        ref[None], starts[None], ends[None], valid[None],
        subs[0][None], subs[1][None], subs[2][None],
        dels[0][None], dels[1][None], dels[2][None], L=L, **kw))
    (site_pos, n_sites, hp, sym, cov, _a0, _a1, _h, _c,
     _rb) = unflatten_result(flat[0], R, L, S)
    assert n_sites == int(d_n[0])
    np.testing.assert_array_equal(site_pos[:n_sites], d_site[0][:n_sites])
    np.testing.assert_array_equal(hp, d_hp[0])
    np.testing.assert_array_equal(sym % 16, np.where(
        d_sym[0] == 254, 5, np.where(d_sym[0] == 255, 15, d_sym[0])) % 16)
    np.testing.assert_array_equal(cov, d_cov[0])
    assert n_sites > 4 and (hp > 0).sum() > 10   # the parity is exercised


def test_ratio_f32_is_correctly_rounded_division():
    """The region step's integer-built quotient equals numpy's IEEE f32
    division for every count pair it can see (reads per tile <= 1024), and
    at the edge of its domain."""
    import jax

    from focalsv_tpu.parallel.region_step import _ratio_f32

    q = np.repeat(np.arange(1, 1100, dtype=np.int32),
                  np.arange(2, 1101))
    p = np.concatenate([np.arange(0, n + 1, dtype=np.int32)
                        for n in range(1, 1100)])
    big_q = np.array([(1 << 23) - 1] * 4 + [5_000_000, 3], np.int32)
    big_p = np.array([0, 1, 12345, (1 << 23) - 2, 4_999_999, 3], np.int32)
    p = np.concatenate([p, big_p])
    q = np.concatenate([q, big_q])
    got = np.asarray(jax.jit(_ratio_f32)(p, q))
    want = p.astype(np.float32) / q.astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
