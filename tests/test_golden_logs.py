"""Golden tests for the observability surface: --dot, haplotag --log,
somatic --log."""

import os
import subprocess


def test_phase_dot(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    golden_dir = tmp_path / "g"
    ours_dir = tmp_path / "o"
    golden_dir.mkdir()
    ours_dir.mkdir()
    subprocess.run([reference_binary, "phase", "--pb", "--dot",
                    "-s", fix["vcf"], "-b", fix["bam"], "-r", fix["fasta"],
                    "-o", str(golden_dir / "out")],
                   check=True, capture_output=True, cwd=golden_dir)
    from longphase_s_jax.core.phase_algo import PhaseParams
    from longphase_s_jax.models.phase import PhaseConfig, run_phase

    cwd = os.getcwd()
    try:
        os.chdir(ours_dir)
        run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                              fasta_file=fix["fasta"],
                              result_prefix=str(ours_dir / "out"),
                              dot=True, engine="device", params=PhaseParams()))
    finally:
        os.chdir(cwd)
    g = open(golden_dir / f"{fix['chrom']}.dot").read()
    o = open(ours_dir / f"{fix['chrom']}.dot").read()
    assert g == o


def test_haplotag_log(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "--log",
                    "-o", golden], check=True, capture_output=True)
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag

    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=fix["bam"],
                                fasta_file=fix["fasta"], result_prefix=ours,
                                write_read_log=True))

    def norm(path, pfx):
        return [l.replace(pfx, "PREFIX") for l in open(path)]

    g = norm(golden + ".out", golden)
    o = norm(ours + ".out", ours)
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert len(g) == len(o), (len(g), len(o))
    assert not mism, f"{len(mism)} differing lines; first: {mism[0]}"


def test_somatic_log(reference_binary, tmp_path):
    from longphase_s_jax.models.somatic import SomaticConfig, run_somatic_haplotag
    from longphase_s_jax.testing.simulate import make_somatic_fixture

    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=5, length=200000,
                               purity=0.5, n_somatic=15, n_artifacts=4)
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["normal_vcf"],
                    "-b", fix["normal_bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag",
                    "-s", phased + ".vcf",
                    "--tumor-snv-file", fix["tumor_vcf"],
                    "-b", fix["normal_bam"],
                    "--tumor-bam-file", fix["tumor_bam"],
                    "-r", fix["fasta"], "--log", "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=ours, write_read_log=True))

    def norm(path, pfx):
        return [l.replace(pfx, "PREFIX") for l in open(path)]

    g = norm(golden + ".out", golden)
    o = norm(ours + ".out", ours)
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert len(g) == len(o), (len(g), len(o))
    assert not mism, f"{len(mism)} differing lines; first: {mism[0]}"


def test_somatic_calling_log(reference_binary, tmp_path):
    from longphase_s_jax.models.somatic import SomaticConfig, run_somatic_haplotag
    from longphase_s_jax.testing.simulate import make_somatic_fixture

    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=19, length=220000,
                               purity=0.55, n_somatic=18, n_artifacts=5)
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["normal_vcf"],
                    "-b", fix["normal_bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag",
                    "-s", phased + ".vcf",
                    "--tumor-snv-file", fix["tumor_vcf"],
                    "-b", fix["normal_bam"],
                    "--tumor-bam-file", fix["tumor_bam"],
                    "-r", fix["fasta"], "--somatic-calling-log", "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=ours, write_calling_log=True))

    def norm(path, pfx):
        return [l.replace(pfx, "PREFIX") for l in open(path)]

    for suffix in ("_somatic_var.out", "_dense_tumor_snp_interval.log",
                   "_somatic_filter.log", "_read_count_filter.log",
                   "_messy_read_filter.log", "_read_hp_detail.log",
                   "_read_distri_scaller.out",
                   "_read_distri_scaller_derive_by_H1_H2.out",
                   "_densealt_filter.log",
                   "_read_distri_before_inheritance.out",
                   "_read_distri_after_inheritance.out",
                   "_snp_cover_region.out", "_read_cover_region.bed",
                   "_germlineReadHpCountInNorBam_histogram.out"):
        g = norm(golden + suffix, golden)
        o = norm(ours + suffix, ours)
        assert len(g) == len(o), (suffix, len(g), len(o))
        mism = [(a, b) for a, b in zip(g, o) if a != b]
        assert not mism, f"{suffix}: {len(mism)} differing; first: {mism[0]}"
