"""Production multi-chip phase path (parallel/multichip.py): run_phase on a
multi-chromosome fixture over the virtual 8-device CPU mesh must produce
results identical to the forced single-device pipeline (the mesh path
must be the real pipeline, not an example-tensor dryrun)."""

import os

import jax
import pytest

from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import make_multichrom_fixture


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs a multi-device mesh")
def test_multichip_phase_matches_single_device(tmp_path, monkeypatch):
    fix = make_multichrom_fixture(str(tmp_path / "fix"), seed=29, n_chroms=5,
                                  base_length=60000)

    def go(out, multichip_env, wavefront_env=""):
        monkeypatch.setenv("LPS_MULTICHIP", multichip_env)
        monkeypatch.setenv("LPS_WAVEFRONT", wavefront_env)
        cfg = PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"],
                          result_prefix=str(tmp_path / out),
                          num_threads=4, is_pb=True, engine="device")
        return run_phase(cfg)

    # chromosome-batch mesh AND the site-sharded wavefront schedule (the
    # few-giant-chromosomes regime) must both match the single-device path
    r_multi = go("multi", "1", "0")
    r_wave = go("wave", "1", "1")
    r_single = go("single", "0")
    assert r_multi == r_single
    assert r_wave == r_single
    assert len(r_multi) > 100  # the fixture phases real sites

    strip = lambda ls: [l for l in ls if not l.startswith("##commandline")]
    vs = strip((tmp_path / "single.vcf").read_text().splitlines())
    for out in ("multi", "wave"):
        vm = strip((tmp_path / (out + ".vcf")).read_text().splitlines())
        assert vm == vs
