"""Golden tests: our phase pipeline output must match the reference binary
bit-for-bit on synthetic fixtures (modulo the version/commandline header
lines, which embed the invocation string)."""

import subprocess

import pytest

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.phase import PhaseConfig, run_phase


def _run_reference(binary, fix, out_prefix, extra=()):
    cmd = [binary, "phase", "--pb",
           "-s", fix["vcf"], "-b", fix["bam"], "-r", fix["fasta"],
           "-o", out_prefix, *extra]
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    return out_prefix + ".vcf"


def _run_ours(fix, out_prefix, engine="oracle", **kw):
    cfg = PhaseConfig(
        snp_file=fix["vcf"], bam_files=[fix["bam"]], fasta_file=fix["fasta"],
        result_prefix=out_prefix, engine=engine, params=PhaseParams(**kw))
    run_phase(cfg)
    return out_prefix + ".vcf"


def _strip_variable_headers(path):
    keep = []
    with open(path) as f:
        for line in f:
            if line.startswith("##longphaseVersion") or line.startswith("##commandline"):
                continue
            keep.append(line)
    return keep


def assert_vcfs_match(golden, ours):
    g = _strip_variable_headers(golden)
    o = _strip_variable_headers(ours)
    # compare data lines first for a more useful error message
    g_data = [l for l in g if not l.startswith("#")]
    o_data = [l for l in o if not l.startswith("#")]
    mismatches = [(a, b) for a, b in zip(g_data, o_data) if a != b]
    assert len(g_data) == len(o_data), (len(g_data), len(o_data))
    assert not mismatches, f"{len(mismatches)} mismatching lines; first: {mismatches[0]}"
    assert g == o


@pytest.mark.parametrize("engine", ["oracle", "device"])
def test_phase_clean_reads(reference_binary, small_fixture, tmp_path, engine):
    golden = _run_reference(reference_binary, small_fixture, str(tmp_path / "golden"))
    ours = _run_ours(small_fixture, str(tmp_path / "ours"), engine=engine)
    assert_vcfs_match(golden, ours)


def test_phase_noisy_reads(reference_binary, tmp_path):
    from longphase_s_jax.testing.simulate import make_fixture

    fix = make_fixture(str(tmp_path / "fix"), seed=11, length=150000,
                       coverage=30, read_len=9000, snp_rate=0.002,
                       error_rate=0.05, qual=20)
    golden = _run_reference(reference_binary, fix, str(tmp_path / "golden"))
    ours = _run_ours(fix, str(tmp_path / "ours"))
    assert_vcfs_match(golden, ours)
