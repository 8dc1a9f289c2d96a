"""Golden tests for haplotag: HP/PS/PQ tags must match the reference binary
record-for-record (reference phase output feeds both haplotag runs)."""

import subprocess

from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag


def _tags(bam_path):
    out = []
    r = BamReader(bam_path)
    for rec in r:
        out.append((rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                    rec.get_tag("PS"), rec.get_tag("PQ")))
    r.close()
    return out


def test_haplotag_matches_reference(reference_binary, small_fixture, tmp_path):
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", small_fixture["vcf"],
                    "-b", small_fixture["bam"], "-r", small_fixture["fasta"],
                    "-o", phased], check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", small_fixture["bam"], "-r", small_fixture["fasta"],
                    "-o", golden], check=True, capture_output=True)

    ours = str(tmp_path / "ours")
    cfg = HaplotagConfig(snp_file=phased + ".vcf", bam_file=small_fixture["bam"],
                         fasta_file=small_fixture["fasta"], result_prefix=ours)
    run_haplotag(cfg)

    g = _tags(golden + ".bam")
    o = _tags(ours + ".bam")
    assert len(g) == len(o), (len(g), len(o))
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert not mism, f"{len(mism)} differing records; first: {mism[0]}"


def test_streaming_haplotag_under_memory_cap(reference_binary, small_fixture,
                                             tmp_path, monkeypatch):
    """With LPS_MAX_INMEM_BAM below the file size, haplotag streams bounded
    windows through per-window handles and the streaming native writer —
    tags must stay record-identical to the reference binary."""
    import subprocess

    from longphase_s_jax import native
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
    from longphase_s_jax.models import haplotag_fast as hf

    fix = small_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)

    used = {}
    orig = native.StreamingBam

    class Spy(orig):
        def __init__(self, path):
            used["stream"] = True
            super().__init__(path)

    monkeypatch.setattr(native, "StreamingBam", Spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    native._bam_cache.clear()
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf",
                                bam_file=fix["bam"],
                                fasta_file=fix["fasta"],
                                result_prefix=str(tmp_path / "ours")))
    monkeypatch.delenv("LPS_MAX_INMEM_BAM")
    native._bam_cache.clear()
    assert used.get("stream"), "memory cap did not engage streaming haplotag"

    def tags(path):
        return [(r.qname, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(path)]

    assert tags(str(tmp_path / "ours.bam")) == tags(golden + ".bam")
