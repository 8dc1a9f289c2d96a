"""Misc golden coverage: multi-BAM phase input, haplotag --region."""

import subprocess

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import (make_fixture, simulate_reads,
                                              write_bam_with_index)
from tests.test_golden_haplotag import _tags
from tests.test_golden_phase import assert_vcfs_match


def test_phase_multiple_bams(reference_binary, tmp_path):
    import numpy as np

    fix = make_fixture(str(tmp_path / "fix"), seed=71, length=140000,
                       coverage=12, read_len=9000, snp_rate=0.0012,
                       error_rate=0.03, qual=22)
    # second BAM: more reads over the same truth
    rng = np.random.default_rng(72)
    reads2 = simulate_reads(rng, fix["ref_seq"], fix["variants"], 12, 9000,
                            0.03, 22, name_prefix="extra")
    bam2 = str(tmp_path / "fix" / "reads2.bam")
    write_bam_with_index(bam2, fix["chrom"], fix["length"], reads2)

    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-b", bam2, "-r", fix["fasta"],
                    "-o", golden], check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"], bam2],
                          fasta_file=fix["fasta"], result_prefix=ours,
                          engine="device", params=PhaseParams()))
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")


def test_haplotag_region_range(reference_binary, small_fixture, tmp_path):
    """Ranged --region chr:start-end restricts the BAM iterator like
    sam_itr_querys (HaplotagParsingBam.cpp:448-450)."""
    fix = small_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    third = fix["length"] // 3
    region = f"{fix['chrom']}:{third}-{2 * third}"
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"],
                    "--region", region, "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=fix["bam"],
                                fasta_file=fix["fasta"], result_prefix=ours,
                                region=region))
    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o)
    assert g == o


def test_haplotag_region(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"],
                    "--region", fix["chrom"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=fix["bam"],
                                fasta_file=fix["fasta"], result_prefix=ours,
                                region=fix["chrom"]))
    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o)
    assert g == o


def test_phase_haplotag_multichrom(reference_binary, tmp_path):
    """Multi-chromosome fixture: per-chrom pipeline loops, chrVec ordering,
    multi-ref BAI — phase bit-identical, haplotag record-identical."""
    from longphase_s_jax.testing.simulate import make_multichrom_fixture

    fix = make_multichrom_fixture(str(tmp_path / "fix"), seed=55)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=ours,
                          engine="device", params=PhaseParams()))
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")

    gh = str(tmp_path / "gh")
    subprocess.run([reference_binary, "haplotag", "-s", golden + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", gh],
                   check=True, capture_output=True)
    oh = str(tmp_path / "oh")
    run_haplotag(HaplotagConfig(snp_file=golden + ".vcf", bam_file=fix["bam"],
                                fasta_file=fix["fasta"], result_prefix=oh))
    g = _tags(gh + ".bam")
    o = _tags(oh + ".bam")
    assert len(g) == len(o) and g == o


def test_cli_end_to_end(reference_binary, small_fixture, tmp_path):
    """Drive the installed CLI (python -m longphase_s_jax.cli) end-to-end:
    phase then haplotag, compared to the reference binary."""
    import os
    import sys

    fix = small_fixture
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    r = subprocess.run([sys.executable, "-m", "longphase_s_jax.cli",
                        "phase", "--pb", "-s", fix["vcf"],
                        "-b", fix["bam"], "-r", fix["fasta"], "-o", ours],
                       capture_output=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")

    gh = str(tmp_path / "gh")
    subprocess.run([reference_binary, "haplotag", "-s", golden + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", gh],
                   check=True, capture_output=True)
    oh = str(tmp_path / "oh")
    r = subprocess.run([sys.executable, "-m", "longphase_s_jax.cli",
                        "haplotag", "-s", ours + ".vcf", "-b", fix["bam"],
                        "-r", fix["fasta"], "-o", oh],
                       capture_output=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert _tags(gh + ".bam") == _tags(oh + ".bam")


def test_degenerate_inputs(reference_binary, small_fixture, tmp_path):
    """Empty VCF / read-less BAM: both binaries emit the same (pass-through)
    result rows with exit 0."""
    from longphase_s_jax.testing.simulate import write_bam_with_index

    fix = small_fixture
    empty_vcf = str(tmp_path / "empty.vcf")
    with open(empty_vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n"
                f"##contig=<ID={fix['chrom']},length={fix['length']}>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    noreads = str(tmp_path / "noreads.bam")
    write_bam_with_index(noreads, fix["chrom"], fix["length"], [])

    for tag, snp, bam in (("emptyvcf", empty_vcf, fix["bam"]),
                          ("noreads", fix["vcf"], noreads)):
        golden = str(tmp_path / f"g_{tag}")
        r = subprocess.run([reference_binary, "phase", "--pb", "-s", snp,
                            "-b", bam, "-r", fix["fasta"], "-o", golden],
                           capture_output=True)
        assert r.returncode == 0
        ours = str(tmp_path / f"o_{tag}")
        run_phase(PhaseConfig(snp_file=snp, bam_files=[bam],
                              fasta_file=fix["fasta"], result_prefix=ours,
                              engine="device", params=PhaseParams()))
        g = [l for l in open(golden + ".vcf") if not l.startswith("##")]
        o = [l for l in open(ours + ".vcf") if not l.startswith("##")]
        assert g == o, tag


def test_phase_multithreaded_multichrom(reference_binary, tmp_path):
    """-t 4 over a multi-chromosome fixture: threaded per-chrom processing
    stays bit-identical to the reference."""
    from longphase_s_jax.testing.simulate import make_multichrom_fixture

    fix = make_multichrom_fixture(str(tmp_path / "fix"), seed=91, n_chroms=4)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-t", "4",
                    "-o", golden], check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=ours,
                          num_threads=4, engine="device", params=PhaseParams()))
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")


def test_haplotag_flagged_reads(reference_binary, tmp_path):
    """Secondary/supplementary/duplicate-flagged reads: filter behavior and
    --tagSupplementary must match the reference."""
    import numpy as np

    from longphase_s_jax.testing.simulate import (make_fixture, simulate_reads,
                                                  write_bam_with_index)

    fix = make_fixture(str(tmp_path / "fix"), seed=66, length=100000,
                       coverage=10, read_len=8000, snp_rate=0.0012,
                       error_rate=0.03, qual=22)
    # re-flag a spread of reads: supplementary, secondary, duplicate, qcfail
    reads = []
    for i, entry in enumerate(fix["reads"]):
        entry = list(entry)
        while len(entry) < 7:
            entry.append(b"" if len(entry) == 5 else 0)
        if i % 11 == 3:
            entry[6] = 0x800            # supplementary
        elif i % 11 == 5:
            entry[6] = 0x100            # secondary
        elif i % 11 == 7:
            entry[6] = 0x400            # duplicate
        reads.append(tuple(entry))
    bam = str(tmp_path / "flagged.bam")
    write_bam_with_index(bam, fix["chrom"], fix["length"], reads)

    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", bam, "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    for sup in (False, True):
        args = ["--tagSupplementary"] if sup else []
        golden = str(tmp_path / f"golden{int(sup)}")
        subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                        "-b", bam, "-r", fix["fasta"], *args, "-o", golden],
                       check=True, capture_output=True)
        ours = str(tmp_path / f"ours{int(sup)}")
        run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=bam,
                                    fasta_file=fix["fasta"],
                                    result_prefix=ours,
                                    tag_supplementary=sup))
        g = _tags(golden + ".bam")
        o = _tags(ours + ".bam")
        assert len(g) == len(o), (sup, len(g), len(o))
        assert g == o, f"tagSupplementary={sup}"


def test_gzipped_vcf_inputs(reference_binary, small_fixture, tmp_path):
    """BGZF-compressed VCF inputs accepted identically (compressParser path,
    ParsingBam.cpp:66-118)."""
    import gzip

    fix = small_fixture
    gz_vcf = str(tmp_path / "snp.vcf.gz")
    with open(fix["vcf"], "rb") as fin, gzip.open(gz_vcf, "wb") as fout:
        fout.write(fin.read())
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "-s", gz_vcf,
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_phase(PhaseConfig(snp_file=gz_vcf, bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=ours,
                          engine="device", params=PhaseParams()))
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")
