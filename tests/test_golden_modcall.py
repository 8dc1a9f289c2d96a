"""Golden tests for modcall: VCF output must match the reference binary on an
MM/ML-tagged fixture."""

import subprocess

import pytest

from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
from longphase_s_jax.testing.simulate import make_meth_fixture


def _strip(path):
    return [l for l in open(path) if not l.startswith("##longphase")
            and not l.startswith("##commandline")]


@pytest.mark.parametrize("output_all", [False, True])
def test_modcall(reference_binary, tmp_path, output_all):
    fix = make_meth_fixture(str(tmp_path / "fix"), seed=17, length=150000,
                            coverage=25, read_len=10000, n_asm=12, n_homo_mod=6)
    golden = str(tmp_path / "golden")
    cmd = [reference_binary, "modcall", "-b", fix["bam"], "-r", fix["fasta"],
           "-s", fix["vcf"], "-o", golden]
    if output_all:
        cmd.append("--all")
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    ours = str(tmp_path / "ours")
    run_modcall(ModCallConfig(bam_files=[fix["bam"]], fasta_file=fix["fasta"],
                              snp_file=fix["vcf"], result_prefix=ours,
                              output_all_mod=output_all))
    g = _strip(golden + ".vcf")
    o = _strip(ours + ".vcf")
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert len(g) == len(o), (len(g), len(o), (g[:3], o[:3]))
    assert not mism, f"{len(mism)} differing lines; first: {mism[0]}"
    if not output_all:
        # fixture sanity: ASM sites must actually be called
        data = [l for l in o if not l.startswith("#")]
        assert len(data) >= 5


def test_streaming_modcall_under_memory_cap(tmp_path, monkeypatch):
    """With LPS_MAX_INMEM_BAM below the file size, modcall streams each
    chromosome into a per-chromosome native handle (open_chrom_native_bam)
    and the VCF must stay byte-identical to the whole-file in-memory run."""
    from longphase_s_jax import native

    fix = make_meth_fixture(str(tmp_path / "fix"), seed=23, length=120000,
                            coverage=20, read_len=8000, n_asm=10,
                            n_homo_mod=5)
    inmem = str(tmp_path / "inmem")
    run_modcall(ModCallConfig(bam_files=[fix["bam"]], fasta_file=fix["fasta"],
                              snp_file=fix["vcf"], result_prefix=inmem))

    used = {}
    orig = native.open_chrom_native_bam

    def spy(path, fasta_path, chrom):
        nb = orig(path, fasta_path, chrom)
        used["chrom_handle"] = nb is not None
        return nb

    monkeypatch.setattr("longphase_s_jax.models.modcall_fast."
                        "open_chrom_native_bam", spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    monkeypatch.setenv("LPS_MAX_CHROM_IMAGE", str(64 << 20))
    native.drain_bam_cache()
    streamed = str(tmp_path / "streamed")
    run_modcall(ModCallConfig(bam_files=[fix["bam"]], fasta_file=fix["fasta"],
                              snp_file=fix["vcf"], result_prefix=streamed))
    monkeypatch.delenv("LPS_MAX_INMEM_BAM")
    native.drain_bam_cache()
    assert used.get("chrom_handle"), \
        "memory cap did not engage the per-chromosome streaming handle"
    assert _strip(inmem + ".vcf") == _strip(streamed + ".vcf")


def test_streaming_modcall_cram_input_under_memory_cap(tmp_path, monkeypatch):
    """CRAM arm of the per-chromosome streaming handle: modcall on a CRAM
    input past the RAM budget decodes container batches natively
    (CramStreamingBam) into a chromosome handle — VCF must match the BAM
    whole-file run byte-for-byte."""
    from longphase_s_jax import native
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.io.cram import CramWriter

    fix = make_meth_fixture(str(tmp_path / "fix"), seed=29, length=100000,
                            coverage=18, read_len=8000, n_asm=8,
                            n_homo_mod=4)
    inmem = str(tmp_path / "inmem")
    run_modcall(ModCallConfig(bam_files=[fix["bam"]], fasta_file=fix["fasta"],
                              snp_file=fix["vcf"], result_prefix=inmem))

    cram = str(tmp_path / "reads.cram")
    br = BamReader(fix["bam"])
    w = CramWriter(cram, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    br.close()

    used = {}
    orig = native.open_chrom_native_bam

    def spy(path, fasta_path, chrom):
        nb = orig(path, fasta_path, chrom)
        used["chrom_handle"] = nb is not None
        return nb

    monkeypatch.setattr("longphase_s_jax.models.modcall_fast."
                        "open_chrom_native_bam", spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    monkeypatch.setenv("LPS_MAX_CHROM_IMAGE", str(64 << 20))
    native.drain_bam_cache()
    streamed = str(tmp_path / "streamed")
    run_modcall(ModCallConfig(bam_files=[cram], fasta_file=fix["fasta"],
                              snp_file=fix["vcf"], result_prefix=streamed))
    monkeypatch.delenv("LPS_MAX_INMEM_BAM")
    native.drain_bam_cache()
    assert used.get("chrom_handle"), \
        "memory cap did not engage the CRAM per-chromosome streaming handle"
    assert _strip(inmem + ".vcf") == _strip(streamed + ".vcf")
