"""Device bring-up rules checked on the CPU: the compile-cache location,
chip_smoke.py refusing to run without a GPU, the run counters that reach
it, and the absence of a silent host rerun when the device path fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from focalsv_tpu.pipeline import device_exec as dx
from focalsv_tpu.utils.profiling import StageTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh_cache_state(monkeypatch):
    """Run _ensure_compile_cache from scratch and restore the process-wide
    JAX settings afterwards."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setattr(dx, "_cache_ready", False)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_honours_environment(monkeypatch, fresh_cache_state,
                                           tmp_path):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    # what JAX itself took from the variable at start-up
    jax.config.update("jax_compilation_cache_dir", env_dir)
    dx._ensure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == env_dir


def test_compile_cache_defaults_to_fixed_dir_in_checkout(monkeypatch,
                                                         fresh_cache_state):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    dx._ensure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == dx.DEFAULT_CACHE_DIR
    assert dx.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_is_set_once(monkeypatch, fresh_cache_state):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    dx._ensure_compile_cache()
    jax.config.update("jax_compilation_cache_dir", "/elsewhere")
    dx._ensure_compile_cache()          # already done: leaves it alone
    assert jax.config.jax_compilation_cache_dir == "/elsewhere"


def _smoke(cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _prints_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except json.JSONDecodeError:
            continue
    return False


def test_chip_smoke_fails_on_cpu_backend():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert not _prints_result(out.stdout)
    assert "not a GPU" in out.stderr


def test_chip_smoke_fails_alone_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert not _prints_result(out.stdout)


def test_stage_timer_dumps_counters(tmp_path):
    t = StageTimer()
    with t.stage("a"):
        pass
    t.counters.update(n_failed_regions=0, n_host_fallback=2)
    p = tmp_path / "stage_times.json"
    t.dump(str(p))
    d = json.loads(p.read_text())
    assert d["a"]["calls"] == 1
    assert d["counters"] == {"n_failed_regions": 0, "n_host_fallback": 2}


def test_device_failure_is_not_rerun_on_host(monkeypatch, tmp_path):
    """A fault in the device streaming path propagates out of
    process_chromosome; the regions are not silently redone on host."""
    from focalsv_tpu.config import preset
    from focalsv_tpu.io import bam as bamio
    from focalsv_tpu.io.bed import Region
    from focalsv_tpu.io.fasta import FastaFile, write_fasta
    from focalsv_tpu.pipeline import main as pm
    from focalsv_tpu.testing import simulate as sim

    rg = sim.simulate_region(seed=3, ref_len=6000, coverage=8, n_snps=4,
                             read_len_mean=2500)
    bam_path = str(tmp_path / "r.bam")
    sim.write_region_bam(rg, bam_path)
    write_fasta(str(tmp_path / "ref.fa"), [(rg.chrom, rg.ref)])

    def broken(*a, **k):
        raise RuntimeError("device stream fault")

    host_calls = []
    monkeypatch.setattr(dx, "streamed_map", broken)
    monkeypatch.setattr(pm, "process_region",
                        lambda *a, **k: host_calls.append(1))
    with pytest.raises(RuntimeError, match="device stream fault"):
        pm.process_chromosome(bamio.ensure_indexed(bam_path),
                              FastaFile.load(str(tmp_path / "ref.fa")),
                              rg.chrom, [Region(rg.chrom, 100, 5900)],
                              preset("HIFI"), num_workers=1)
    assert not host_calls


def test_process_chromosome_reports_counters(tmp_path):
    """Device mode writes the counters chip_smoke.py reads."""
    from focalsv_tpu.config import preset
    from focalsv_tpu.io import bam as bamio
    from focalsv_tpu.io.bed import Region
    from focalsv_tpu.io.fasta import FastaFile, write_fasta
    from focalsv_tpu.pipeline.main import process_chromosome
    from focalsv_tpu.testing import simulate as sim

    rg = sim.simulate_region(seed=4, ref_len=8000, coverage=14, n_snps=6,
                             read_len_mean=3000)
    bam_path = str(tmp_path / "r.bam")
    sim.write_region_bam(rg, bam_path)
    write_fasta(str(tmp_path / "ref.fa"), [(rg.chrom, rg.ref)])
    process_chromosome(bamio.ensure_indexed(bam_path),
                       FastaFile.load(str(tmp_path / "ref.fa")), rg.chrom,
                       [Region(rg.chrom, 100, 7900)], preset("HIFI"),
                       out_dir=str(tmp_path / "out"), num_workers=2)
    d = json.loads((tmp_path / "out" / "log" / "stage_times.json")
                   .read_text())
    c = d["counters"]
    assert c["n_regions"] == 1 and c["n_failed_regions"] == 0
    assert c["n_host_fallback"] == 0
    assert c["n_chunks"] == c["n_chunks_delta"] + c["n_chunks_dense"] == 1
    assert c["n_devices"] == len(jax.devices())
    # the one region sits in device 0's share of a padded chunk
    assert c["n_slots"] % c["n_devices"] == 0
    assert [c[f"regions_dev{d}"] for d in range(c["n_devices"])] == \
        [1] + [0] * (c["n_devices"] - 1)


def test_native_library_builds_once_for_concurrent_first_callers(
        monkeypatch, tmp_path):
    """Threads that ask for the native library while its first build runs
    must all get the library, not a None that sends them to Python."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu import native

    real = native.get_lib()
    assert real is not None          # the suite's own build
    built = native._SO
    so = str(tmp_path / "libfocalsv_native.so")
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.3)
        shutil.copy(built, so)
        return True

    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "_build", slow_build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with ThreadPoolExecutor(8) as ex:
        libs = list(ex.map(lambda _: native.get_lib(), range(8)))
    assert len(builds) == 1
    assert all(lib is not None for lib in libs)
    assert len({id(lib) for lib in libs}) == 1


def test_cli_assembly_override_reaches_the_pipeline(monkeypatch):
    """--assembly olc (the CLI path that feeds the DP batcher) sets the
    assembly method of the config the pipeline runs with."""
    from focalsv_tpu.pipeline import cli
    from focalsv_tpu.pipeline import main as pm

    seen = {}

    def fake_target_mode(bam, ref, out, cfg, **kw):
        seen["method"] = cfg.assembly.method
        seen["mode"] = cfg.execution.mode
        return "out.vcf"

    monkeypatch.setattr(pm, "run_target_mode", fake_target_mode)
    base = ["--bam_file", "a.bam", "--ref_file", "r.fa", "-d", "HIFI",
            "--target_bed", "t.bed"]
    assert cli.main(base + ["--assembly", "olc", "--execution", "host"]) == 0
    assert seen == {"method": "olc", "mode": "host"}
    assert cli.main(base) == 0
    assert seen == {"method": "guided", "mode": "device"}
