"""The GPU banded-DP kernel (ops/align_gpu.py) in Pallas interpret mode,
its dispatch, and the DP batcher's failure and routing rules.

On the card the kernel is compiled for the GPU and checked against the
native host DP by chip_smoke.py; here the same kernel body runs in
interpret mode against the lax.scan formulation and the full-matrix
numpy reference."""

import numpy as np
import pytest

import jax

from focalsv_tpu.ops import align as alignops
from focalsv_tpu.ops import align_gpu
from focalsv_tpu.parallel import batch_executor as be


def _batch(seed, B, L, W):
    """Ragged query/target pairs: substitution runs, deletions and leading
    insertions (the j==0 F-only column), plus one empty query."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    q = t.copy()
    for b in range(B):
        i0 = int(rng.integers(10, L // 2))
        ln = int(rng.integers(1, min(20, W // 4)))
        if b % 3 == 0:
            q[b, i0 : i0 + ln] = rng.integers(0, 4)
        elif b % 3 == 1:
            q[b] = np.concatenate([np.delete(q[b], slice(i0, i0 + ln)),
                                   np.full(ln, 5, np.uint8)])
        else:
            q[b] = np.concatenate(
                [rng.integers(0, 4, ln).astype(np.uint8), q[b][: L - ln]])
    q_len = rng.integers(L // 2, L - 20, B).astype(np.int32)
    q_len[0] = 0
    t_len = rng.integers(L // 2 + 20, L + 1, B).astype(np.int32)
    d_lo = np.clip((t_len - q_len) // 2 - W // 2,
                   t_len - q_len - W + 1, 0).astype(np.int32)
    return q, q_len, t, t_len, d_lo


@pytest.mark.parametrize("B,L,W,seed", [
    (4, 120, 64, 0), (5, 200, 64, 1), (3, 300, 128, 2), (4, 260, 128, 3),
    (3, 700, 512, 4),
])
def test_gpu_kernel_matches_scan(B, L, W, seed):
    args = _batch(seed, B, L, W)
    s_k, d_k = align_gpu.banded_align_batch_gpu(*args, band=W,
                                                interpret=True)
    s_s, d_s = alignops.banded_align_batch(*args, band=W)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_s))
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_s))


@pytest.mark.parametrize("scoring", [
    dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2),
    dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2),
])
def test_gpu_kernel_matches_full_matrix_reference(scoring):
    """Score and traced-back CIGAR equal the full-matrix numpy DP."""
    rng = np.random.default_rng(11)
    W = 64
    pairs = []
    for _ in range(3):
        t = rng.integers(0, 4, 90).astype(np.uint8)
        q = np.delete(t, slice(30, 30 + int(rng.integers(1, 12))))
        q[50:53] = rng.integers(0, 4, 3)
        pairs.append((q, t))
    L = 128
    q = np.full((3, L), 5, np.uint8)
    t = np.full((3, L), 5, np.uint8)
    for b, (qq, tt) in enumerate(pairs):
        q[b, : len(qq)] = qq
        t[b, : len(tt)] = tt
    q_len = np.array([len(p[0]) for p in pairs], np.int32)
    t_len = np.array([len(p[1]) for p in pairs], np.int32)
    d_lo = np.clip((t_len - q_len) // 2 - W // 2,
                   t_len - q_len - W + 1, 0).astype(np.int32)
    scores, dirs = align_gpu.banded_align_batch_gpu(
        q, q_len, t, t_len, d_lo, band=W, interpret=True, **scoring)
    for b, (qq, tt) in enumerate(pairs):
        ref_score, ref_cig, _ = alignops.align_numpy(qq, tt, **scoring)
        assert int(scores[b]) == ref_score
        assert alignops.traceback(np.asarray(dirs[b]), len(qq), len(tt),
                                  int(d_lo[b])) == ref_cig


def test_cummax_lowering_registers_with_pallas_triton():
    """The compiled kernel's prefix max relies on private Pallas-Triton
    lowering internals; interpret mode never touches them, so check here
    that they still exist and that the rule lands in the registry."""
    from jax import lax
    from jax._src.pallas.triton import lowering as tl
    assert callable(tl._associative_scan_lowering)
    align_gpu._register_cummax_lowering()
    align_gpu._register_cummax_lowering()          # idempotent
    assert lax.cummax_p in tl.triton_lowering_rules


def test_gpu_kernel_rejects_band_not_power_of_two():
    args = _batch(0, 2, 100, 48)
    with pytest.raises(ValueError, match="power of two"):
        align_gpu.banded_align_batch_gpu(*args, band=48, interpret=True)


@pytest.mark.parametrize("backend,band,store_dirs,expect_kernel", [
    ("gpu", 128, True, True),
    ("gpu", 2048, True, True),
    ("gpu", 8192, True, False),      # wider than GPU_MAX_BAND
    ("gpu", 96, True, False),        # not a power of two
    ("gpu", 128, False, False),      # score-only
    ("cpu", 128, True, False),
    ("tpu", 128, True, False),       # no kernel for any other backend
])
def test_dispatcher_picks_gpu_kernel_only_on_gpu(monkeypatch, backend, band,
                                                 store_dirs, expect_kernel):
    calls = []

    def fake_kernel(*a, **k):
        calls.append("kernel")
        return "kernel-result"

    def fake_scan(*a, **k):
        calls.append("scan")
        return "scan-result"

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(align_gpu, "banded_align_batch_gpu", fake_kernel)
    monkeypatch.setattr(alignops, "banded_align_batch", fake_scan)
    out = alignops.banded_align(None, None, None, None, None, band=band,
                                store_dirs=store_dirs)
    assert calls == ["kernel" if expect_kernel else "scan"]
    assert out == ("kernel-result" if expect_kernel else "scan-result")


def _pair(rng, n=200):
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = np.delete(t, slice(50, 50 + int(rng.integers(1, 10))))
    return q, t


def test_batcher_raises_on_failing_batch(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(alignops, "banded_align", boom)
    q, t = _pair(np.random.default_rng(0))
    with be.dp_batching(max_wait_ms=1.0, init_rt_ms=0.0) as batcher:
        with pytest.raises(RuntimeError, match="device DP batch failed"):
            alignops.banded_align_pair(q, t, band=128)
        # the dispatcher survives a failed batch and counts no jobs for it
        assert batcher.thread.is_alive()
        assert batcher.n_jobs == 0


def test_batcher_routes_to_device_until_a_warm_batch_is_timed():
    rng = np.random.default_rng(1)
    q, t = _pair(rng)
    with be.dp_batching(max_wait_ms=1.0) as batcher:
        assert batcher.rt_ema is None
        assert not batcher.route_native(1)      # unmeasured: device
        alignops.banded_align_pair(q, t, band=128)     # compiles
        assert batcher.rt_ema is None and batcher.n_jobs == 1
        alignops.banded_align_pair(q, t, band=128)     # warm: timed
        assert batcher.rt_ema is not None and batcher.n_jobs == 2
        assert batcher.n_native == 0
        assert batcher.route_native(1)          # 1 cell beats any batch
        assert batcher.n_native == 1


def test_batcher_pinned_to_device_never_routes_native():
    with be.dp_batching(init_rt_ms=0.0) as batcher:
        assert not batcher.route_native(1)
        assert batcher.n_native == 0


def test_gpu_kernel_splits_batches_past_32bit_offsets(monkeypatch):
    """Batches whose dirs exceed MAX_LAUNCH_BYTES run as several launches
    and give the one-launch result (the shape is unique to this test, so
    the jit trace sees the lowered cap)."""
    B, L, W = 5, 136, 64
    args = _batch(21, B, L, W)
    monkeypatch.setattr(align_gpu, "MAX_LAUNCH_BYTES", 2 * L * W)
    s_k, d_k = align_gpu.banded_align_batch_gpu(*args, band=W,
                                                interpret=True)
    s_s, d_s = alignops.banded_align_batch(*args, band=W)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_s))
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_s))
