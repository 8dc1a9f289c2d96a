"""Device selection and the absence of fallbacks.

One rule picks the device path from JAX's default device: 'gpu' takes the
fused device path with the Pallas scan kernel, 'cpu' the host packer with
lax.scan, anything else raises. A device failure raises; nothing falls
back to the host. The entry points keep XLA's compile cache where
JAX_COMPILATION_CACHE_DIR says, else in <checkout>/.jax_cache."""

import os
from types import SimpleNamespace

import jax
import pytest

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.ops import fused, vote_scan


@pytest.mark.parametrize("platform,engine", [
    ("cpu", "lax"), ("gpu", "kernel"), ("rocm", None), ("metal", None)])
def test_dispatcher(platform, engine, monkeypatch):
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [SimpleNamespace(platform=platform)])
    if engine is None:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            vote_scan.scan_engine()
    else:
        assert vote_scan.device_platform() == platform
        assert vote_scan.scan_engine() == engine


def _phase_cfg(fix, tmp_path, name):
    return PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                       fasta_file=fix["fasta"],
                       result_prefix=str(tmp_path / name), num_threads=1,
                       is_pb=True, engine="device", params=PhaseParams())


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_platform_picks_phase_path(platform, small_fixture, tmp_path,
                                   monkeypatch):
    """'gpu' runs the fused device path (here with the kernel under the
    interpreter), 'cpu' the host packer; both equal the oracle."""
    monkeypatch.setenv("LPS_MULTICHIP", "0")
    monkeypatch.setattr(vote_scan, "device_platform", lambda: platform)
    if platform == "gpu":
        monkeypatch.setattr(vote_scan, "scan_engine", lambda: "interpret")
    used = []
    orig = fused.run_fused_phase
    monkeypatch.setattr(fused, "run_fused_phase",
                        lambda *a, **k: used.append(1) or orig(*a, **k))
    got = run_phase(_phase_cfg(small_fixture, tmp_path, platform))
    oracle = run_phase(PhaseConfig(
        snp_file=small_fixture["vcf"], bam_files=[small_fixture["bam"]],
        fasta_file=small_fixture["fasta"],
        result_prefix=str(tmp_path / "oracle"), num_threads=1, is_pb=True,
        engine="oracle", params=PhaseParams()))
    assert bool(used) == (platform == "gpu")
    assert got == oracle and len(got) > 50


def _boom(*a, **k):
    raise RuntimeError("device kernel failed")


@pytest.mark.parametrize("platform,target", [
    ("gpu", (fused, "fused_phase_jit")),
    ("cpu", (vote_scan, "vote_scan_packed_jax"))])
def test_phase_device_failure_raises(platform, target, small_fixture,
                                     tmp_path, monkeypatch):
    monkeypatch.setenv("LPS_MULTICHIP", "0")
    monkeypatch.setattr(vote_scan, "device_platform", lambda: platform)
    monkeypatch.setattr(vote_scan, "scan_engine", lambda: "lax")
    monkeypatch.setattr(*target, _boom)
    with pytest.raises(RuntimeError, match="device kernel failed"):
        run_phase(_phase_cfg(small_fixture, tmp_path, "boom"))


def test_tag_device_failure_raises(small_fixture, tmp_path, monkeypatch):
    """A forced device tag engine whose kernel fails raises instead of
    finishing on the host path."""
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
    from longphase_s_jax.ops import tag_kernels

    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(
        snp_file=small_fixture["vcf"], bam_files=[small_fixture["bam"]],
        fasta_file=small_fixture["fasta"], result_prefix=phased,
        num_threads=1, is_pb=True, engine="oracle", params=PhaseParams()))
    monkeypatch.setenv("LPS_TAG_ENGINE", "device")
    monkeypatch.setattr(tag_kernels, "_get_jit_germline", lambda: _boom)
    with pytest.raises(RuntimeError, match="device kernel failed"):
        run_haplotag(HaplotagConfig(
            snp_file=phased + ".vcf", bam_file=small_fixture["bam"],
            fasta_file=small_fixture["fasta"],
            result_prefix=str(tmp_path / "tagged")))


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    from longphase_s_jax.utils.compile_cache import (CHECKOUT,
                                                     enable_compile_cache)

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(CHECKOUT, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert enable_compile_cache() == want
        if env_dir is None:
            assert jax.config.jax_compilation_cache_dir == want
        else:  # JAX reads the variable itself; nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.isfile(os.path.join(CHECKOUT, "chip_smoke.py"))
