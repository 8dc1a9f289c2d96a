"""Golden tests for the somatic pipelines: somatic_haplotag HP:Z/PS/PQ tags,
_sc.vcf, and estimate_purity output must match the reference binary."""

import subprocess

import pytest

from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.models.somatic import (SomaticConfig, run_estimate_purity,
                                            run_somatic_haplotag)
from longphase_s_jax.testing.simulate import make_somatic_fixture


@pytest.fixture(scope="module")
def somatic_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("fix_somatic")
    return make_somatic_fixture(str(out), seed=42, length=250000,
                                normal_coverage=25, tumor_coverage=30,
                                purity=0.6, n_somatic=25, n_artifacts=6)


@pytest.fixture(scope="module")
def phased_normal(reference_binary, somatic_fixture, tmp_path_factory):
    out = tmp_path_factory.mktemp("phased")
    prefix = str(out / "phased")
    subprocess.run([reference_binary, "phase", "--pb",
                    "-s", somatic_fixture["normal_vcf"],
                    "-b", somatic_fixture["normal_bam"],
                    "-r", somatic_fixture["fasta"], "-o", prefix],
                   check=True, capture_output=True)
    return prefix + ".vcf"


def _tags(bam_path):
    out = []
    r = BamReader(bam_path)
    for rec in r:
        out.append((rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                    rec.get_tag("PS"), rec.get_tag("PQ")))
    r.close()
    return out


def _cfg(somatic_fixture, phased_normal, prefix, **kw):
    return SomaticConfig(
        snp_file=phased_normal,
        tumor_snv_file=somatic_fixture["tumor_vcf"],
        bam_file=somatic_fixture["normal_bam"],
        tumor_bam_file=somatic_fixture["tumor_bam"],
        fasta_file=somatic_fixture["fasta"],
        result_prefix=prefix, **kw)


def test_somatic_haplotag(reference_binary, somatic_fixture, phased_normal,
                          tmp_path):
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag",
                    "-s", phased_normal,
                    "--tumor-snv-file", somatic_fixture["tumor_vcf"],
                    "-b", somatic_fixture["normal_bam"],
                    "--tumor-bam-file", somatic_fixture["tumor_bam"],
                    "-r", somatic_fixture["fasta"],
                    "--output-somatic-vcf", "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(_cfg(somatic_fixture, phased_normal, ours,
                              write_somatic_vcf=True))

    # purity report parity
    with open(golden + "_purity.out") as f:
        g_purity = f.read()
    with open(ours + "_purity.out") as f:
        o_purity = f.read()
    assert g_purity == o_purity

    # somatic-calling VCF parity
    def strip(p):
        return [l for l in open(p) if not l.startswith("##longphase")
                and not l.startswith("##commandline")]
    assert strip(golden + "_sc.vcf") == strip(ours + "_sc.vcf")

    # tag parity
    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o), (len(g), len(o))
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert not mism, f"{len(mism)} differing records; first 3: {mism[:3]}"


def test_estimate_purity(reference_binary, somatic_fixture, phased_normal,
                         tmp_path):
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "estimate_purity",
                    "-s", phased_normal,
                    "--tumor-snv-file", somatic_fixture["tumor_vcf"],
                    "-b", somatic_fixture["normal_bam"],
                    "--tumor-bam-file", somatic_fixture["tumor_bam"],
                    "-r", somatic_fixture["fasta"], "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_estimate_purity(_cfg(somatic_fixture, phased_normal, ours,
                             quality_threshold=20, tag_supplementary=True))
    with open(golden + "_purity.out") as f:
        g_purity = f.read()
    with open(ours + "_purity.out") as f:
        o_purity = f.read()
    assert g_purity == o_purity


@pytest.mark.parametrize("purity,snp_rate,seed", [
    (0.3, 0.0012, 7),
    (0.9, 0.0004, 9),   # sparse germline SNPs -> some H3 reads survive
])
def test_somatic_purity_sweep(reference_binary, tmp_path, purity, snp_rate, seed):
    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=seed, length=250000,
                               normal_coverage=25, tumor_coverage=30,
                               purity=purity, n_somatic=25, n_artifacts=5,
                               snp_rate=snp_rate)
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
                    "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(_cfg(fix, phased + ".vcf", ours))
    with open(golden + "_purity.out") as f:
        g_purity = f.read()
    with open(ours + "_purity.out") as f:
        o_purity = f.read()
    assert g_purity == o_purity
    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o)
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert not mism, f"{len(mism)} differing records; first 3: {mism[:3]}"


def test_somatic_benchmark_metrics(reference_binary, somatic_fixture,
                                   phased_normal, tmp_path):
    from longphase_s_jax.testing.simulate import write_truth_files

    fix = somatic_fixture
    truth_vcf, truth_bed = write_truth_files(str(tmp_path), fix["chrom"],
                                             fix["length"], fix["somatic"])
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag",
                    "-s", phased_normal,
                    "--tumor-snv-file", somatic_fixture["tumor_vcf"],
                    "-b", somatic_fixture["normal_bam"],
                    "--tumor-bam-file", somatic_fixture["tumor_bam"],
                    "-r", somatic_fixture["fasta"],
                    "--truth-vcf", truth_vcf, "--truth-bed", truth_bed,
                    "--benchmark-log",
                    "-o", golden], check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(_cfg(somatic_fixture, phased_normal, ours,
                              truth_vcf=truth_vcf, truth_bed=truth_bed,
                              write_benchmark_log=True))
    for suffix in ("_somatic_haplotag.metrics",
                   "_total_truth_somatic_read.out", "_total_tagged_read.out",
                   "_allele_count.out", "_var_in_bed.out", "_var_out_bed.out"):
        with open(golden + suffix) as f:
            g = f.read()
        with open(ours + suffix) as f:
            o = f.read()
        assert g == o, suffix
    # tags must also match with the BED-restricted variant set
    gt = _tags(golden + ".bam")
    ot = _tags(ours + ".bam")
    mism = [(a, b) for a, b in zip(gt, ot) if a != b]
    assert not mism, f"{len(mism)} differing records; first 3: {mism[:3]}"


def test_somatic_multichrom(reference_binary, tmp_path):
    """Multi-chromosome somatic pipeline: per-chrom loops end-to-end."""
    from longphase_s_jax.testing.simulate import make_multichrom_somatic_fixture

    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=81)
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["normal_vcf"],
                    "-b", fix["normal_bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag", "-s", phased + ".vcf",
                    "--tumor-snv-file", fix["tumor_vcf"],
                    "-b", fix["normal_bam"],
                    "--tumor-bam-file", fix["tumor_bam"],
                    "-r", fix["fasta"], "--output-somatic-vcf", "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=ours, write_somatic_vcf=True))
    with open(golden + "_purity.out") as f:
        g = f.read()
    with open(ours + "_purity.out") as f:
        o = f.read()
    assert g == o
    g = [l for l in open(golden + "_sc.vcf") if not l.startswith("##")]
    o = [l for l in open(ours + "_sc.vcf") if not l.startswith("##")]
    assert g == o
    assert _tags(golden + ".bam") == _tags(ours + ".bam")


def test_streaming_somatic_under_memory_cap(reference_binary, somatic_fixture,
                                            phased_normal, tmp_path,
                                            monkeypatch):
    """With LPS_MAX_INMEM_BAM below the file sizes, the somatic pipeline
    runs its extraction and tagging through streaming window handles —
    outputs must stay identical to the reference binary."""
    from longphase_s_jax import native
    from longphase_s_jax.io.bam import BamReader

    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag", "-s", phased_normal,
                    "--tumor-snv-file", somatic_fixture["tumor_vcf"],
                    "-b", somatic_fixture["normal_bam"], "--tumor-bam-file",
                    somatic_fixture["tumor_bam"], "-r",
                    somatic_fixture["fasta"], "-o", golden,
                    "--output-somatic-vcf"], check=True, capture_output=True)

    used = {}
    orig = native.StreamingBam

    class Spy(orig):
        def __init__(self, path):
            used["stream"] = True
            super().__init__(path)

    monkeypatch.setattr(native, "StreamingBam", Spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    native._bam_cache.clear()
    run_somatic_haplotag(_cfg(somatic_fixture, phased_normal,
                              str(tmp_path / "ours"),
                              write_somatic_vcf=True))
    monkeypatch.delenv("LPS_MAX_INMEM_BAM")
    native._bam_cache.clear()
    assert used.get("stream"), "memory cap did not engage streaming handles"

    def tags(path):
        return [(r.qname, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(path)]

    assert tags(str(tmp_path / "ours.bam")) == tags(golden + ".bam")
    a = [l for l in open(golden + "_sc.vcf") if not l.startswith("##")]
    b = [l for l in open(tmp_path / "ours_sc.vcf")
         if not l.startswith("##")]
    assert a == b
