"""Golden test for phase --deepsomatic_output (GERMLINE filtering + GT
re-derivation from AD/VAF)."""

import subprocess

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import make_fixture
from tests.test_golden_phase import assert_vcfs_match


def _write_deepsomatic_vcf(path, fix, rng):
    chrom = fix["chrom"]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={fix['length']}>\n")
        f.write('##FILTER=<ID=PASS,Description="ok">\n')
        f.write('##FILTER=<ID=GERMLINE,Description="germline">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n')
        f.write('##FORMAT=<ID=AD,Number=.,Type=Integer,Description="AD">\n')
        f.write('##FORMAT=<ID=VAF,Number=.,Type=Float,Description="VAF">\n')
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
        for i, (pos, ref_a, alt_a, hap) in enumerate(fix["variants"]):
            if len(ref_a) != 1 or len(alt_a) != 1:
                continue
            r = rng.random()
            if r < 0.1:
                # somatic-like record: dropped by preprocessing
                f.write(f"{chrom}\t{pos + 1}\t.\t{ref_a}\t{alt_a}\t12\tPASS\t.\t"
                        f"GT:AD:VAF\t0/1:25,5:0.17\n")
                continue
            if r < 0.2:
                # homozygous germline
                f.write(f"{chrom}\t{pos + 1}\t.\t{ref_a}\t{alt_a}\t40\tGERMLINE\t.\t"
                        f"GT:AD:VAF\t0/0:1,29:0.97\n")
                continue
            ref_d = 13 + int(rng.integers(0, 5))
            alt_d = 14 + int(rng.integers(0, 5))
            # GT deliberately wrong; preprocessing re-derives 0/1 from AD
            f.write(f"{chrom}\t{pos + 1}\t.\t{ref_a}\t{alt_a}\t40\tGERMLINE\t.\t"
                    f"GT:AD:VAF\t1/1:{ref_d},{alt_d}:"
                    f"{alt_d / (ref_d + alt_d):.3f}\n")


def test_phase_deepsomatic(reference_binary, tmp_path):
    import numpy as np

    fix = make_fixture(str(tmp_path / "fix"), seed=13, length=150000,
                       coverage=25, read_len=10000, snp_rate=0.0015,
                       error_rate=0.03, qual=25)
    rng = np.random.default_rng(5)
    ds_vcf = str(tmp_path / "deepsomatic.vcf")
    _write_deepsomatic_vcf(ds_vcf, fix, rng)

    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb", "--deepsomatic_output",
                    "-s", ds_vcf, "-b", fix["bam"], "-r", fix["fasta"],
                    "-o", golden], check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    cfg = PhaseConfig(snp_file=ds_vcf, bam_files=[fix["bam"]],
                      fasta_file=fix["fasta"], result_prefix=ours,
                      deepsomatic_output=True, engine="device",
                      params=PhaseParams())
    run_phase(cfg)
    with open(golden + "_preprocessed.vcf") as f:
        g_pre = f.read()
    with open(ours + "_preprocessed.vcf") as f:
        o_pre = f.read()
    assert g_pre == o_pre
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")
