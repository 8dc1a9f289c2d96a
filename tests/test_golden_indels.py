"""Golden tests with het indels: phase --indels and haplotag on indel-bearing
reads (insertion/deletion allele extraction, danger-indel marking,
SNP-in-deletion rescue paths)."""

import subprocess

import pytest

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_jax.testing.simulate import make_fixture
from tests.test_golden_phase import assert_vcfs_match
from tests.test_golden_haplotag import _tags


@pytest.fixture(scope="module")
def indel_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("fix_indel")
    return make_fixture(str(out), seed=23, length=150000, coverage=25,
                        read_len=9000, snp_rate=0.0015, indel_rate=0.25,
                        error_rate=0.02, qual=25)


@pytest.mark.parametrize("engine", ["oracle", "device"])
def test_phase_indels(reference_binary, indel_fixture, tmp_path, engine):
    fix = indel_fixture
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "--indels",
                    "-s", fix["vcf"], "-b", fix["bam"], "-r", fix["fasta"],
                    "-o", golden], check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    cfg = PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                      fasta_file=fix["fasta"], result_prefix=ours,
                      phase_indel=True, engine=engine, params=PhaseParams())
    run_phase(cfg)
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")


def test_haplotag_indels(reference_binary, indel_fixture, tmp_path):
    fix = indel_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "--indels",
                    "-s", fix["vcf"], "-b", fix["bam"], "-r", fix["fasta"],
                    "-o", phased], check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=fix["bam"],
                                fasta_file=fix["fasta"], result_prefix=ours))
    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o)
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert not mism, f"{len(mism)} differing records; first: {mism[0]}"


def test_phase_ont_mode(reference_binary, tmp_path):
    """--ont homopolymer SNP filter path."""
    fix = make_fixture(str(tmp_path / "fix"), seed=31, length=120000,
                       coverage=25, read_len=9000, snp_rate=0.003,
                       error_rate=0.06, qual=18)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--ont",
                    "-s", fix["vcf"], "-b", fix["bam"], "-r", fix["fasta"],
                    "-o", golden], check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    cfg = PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                      fasta_file=fix["fasta"], result_prefix=ours,
                      is_ont=True, engine="device", params=PhaseParams(is_ont=True))
    run_phase(cfg)
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")
