"""CRAM interop golden tests.

Both directions against htslib (linked by the reference binary):
1. our reader decodes an htslib-written CRAM to the same records as the
   equivalent BAM,
2. htslib reads a CRAM written by us and produces identical results,
3. the full pipeline runs with CRAM input and --cram output.
"""

import subprocess

from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.io.cram import CramReader, CramWriter
from longphase_s_jax.io.fasta import FastaFile
from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
from tests.test_golden_haplotag import _tags


def _fields(r):
    return (r.qname, r.flag, r.tid, r.pos, r.mapq, r.cigar_tuples(), r.seq(),
            r.qual().tolist(), sorted(r.iter_aux()))


def _phase_and_tag(reference_binary, fix, tmp_path, extra=()):
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    return phased


def test_cram_reader_vs_htslib(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    phased = _phase_and_tag(reference_binary, fix, tmp_path)
    gb = str(tmp_path / "g_bam")
    gc = str(tmp_path / "g_cram")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", gb],
                   check=True, capture_output=True)
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "--cram", "-o", gc],
                   check=True, capture_output=True)
    fa = FastaFile(fix["fasta"])
    cr = CramReader(gc + ".cram", fasta=fa)
    br = BamReader(gb + ".bam")
    n = 0
    for a, b in zip(cr, br):
        assert _fields(a) == _fields(b), f"record {n}"
        n += 1
    assert n > 0


def test_cram_writer_read_by_htslib(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    phased = _phase_and_tag(reference_binary, fix, tmp_path)
    # write the fixture BAM as CRAM with our writer
    br = BamReader(fix["bam"])
    ours_cram = str(tmp_path / "ours.cram")
    w = CramWriter(ours_cram, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    # the reference binary (htslib) must read it and produce identical tags
    g1 = str(tmp_path / "from_bam")
    g2 = str(tmp_path / "from_cram")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", g1],
                   check=True, capture_output=True)
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", ours_cram, "-r", fix["fasta"], "-o", g2],
                   check=True, capture_output=True)
    a = _tags(g1 + ".bam")
    b = _tags(g2 + ".bam")
    assert len(a) == len(b) and a == b


def test_haplotag_cram_in_cram_out(reference_binary, small_fixture, tmp_path):
    fix = small_fixture
    phased = _phase_and_tag(reference_binary, fix, tmp_path)
    # golden: reference with BAM in, BAM out
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    # ours: CRAM input (htslib-written), CRAM output
    gc = str(tmp_path / "g_cram")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "--cram", "-o", gc],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf",
                                bam_file=gc + ".cram",
                                fasta_file=fix["fasta"], result_prefix=ours,
                                output_cram=True))
    fa = FastaFile(fix["fasta"])
    cr = CramReader(ours + ".cram", fasta=fa)
    got = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in cr]
    want = _tags(golden + ".bam")
    assert len(got) == len(want)
    assert got == want


def test_somatic_cram_input(reference_binary, tmp_path):
    """Somatic pipeline with CRAM tumor input (htslib-written) matches the
    BAM-input run."""
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_somatic_haplotag)
    from longphase_s_jax.testing.simulate import make_somatic_fixture

    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=31, length=150000,
                               purity=0.6, n_somatic=10, n_artifacts=3)
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["normal_vcf"],
                    "-b", fix["normal_bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    # write the tumor BAM as CRAM with our writer (htslib-readable)
    br = BamReader(fix["tumor_bam"])
    tumor_cram = str(tmp_path / "tumor.cram")
    w = CramWriter(tumor_cram, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag", "-s", phased + ".vcf",
                    "--tumor-snv-file", fix["tumor_vcf"],
                    "-b", fix["normal_bam"], "--tumor-bam-file", fix["tumor_bam"],
                    "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True, timeout=1200)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=tumor_cram,
        fasta_file=fix["fasta"], result_prefix=ours))
    assert _tags(golden + ".bam") == _tags(ours + ".bam")


def test_somatic_cram_output_fast_path(reference_binary, tmp_path):
    """somatic_haplotag --cram stays on the native fast path: the CRAM's
    tags must match the reference's BAM output and htslib must read it."""
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_somatic_haplotag)
    from longphase_s_jax.testing.simulate import make_somatic_fixture

    fx = make_somatic_fixture(str(tmp_path / "fix"), seed=17, length=300000)
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fx["normal_vcf"],
                    "-b", fx["normal_bam"], "-r", fx["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "somatic_haplotag", "-s",
                    phased + ".vcf", "--tumor-snv-file", fx["tumor_vcf"],
                    "-b", fx["normal_bam"], "--tumor-bam-file",
                    fx["tumor_bam"], "-r", fx["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_somatic_haplotag(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fx["tumor_vcf"],
        bam_file=fx["normal_bam"], tumor_bam_file=fx["tumor_bam"],
        fasta_file=fx["fasta"], result_prefix=ours, output_cram=True))

    fa = FastaFile(fx["fasta"])

    def tags(it):
        return {(r.qname, r.pos): (r.get_tag("HP"), r.get_tag("PS"),
                                   r.get_tag("PQ")) for r in it}

    assert tags(CramReader(ours + ".cram", fasta=fa)) == \
        tags(BamReader(golden + ".bam"))
    r = subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                        "-b", ours + ".cram", "-r", fx["fasta"], "-o",
                        str(tmp_path / "rt")], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]


def _fields_full(r):
    return (r.qname, r.flag, r.tid, r.pos, r.mapq, list(r.cigar_tuples()),
            r.seq(), r.qual().tolist(), sorted(r.iter_aux()))


def test_cram31_reader_vs_htslib(reference_binary, small_fixture, tmp_path):
    """CRAM 3.1 interop: an htslib-written version-3.1 CRAM
    (rANS Nx16 data blocks + tok3 read names, which the reference CLI
    cannot emit — produced by the htslib-linked tools/bam2cram31 oracle)
    must decode to records byte-identical to the source BAM."""
    import os

    fix = small_fixture
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(root, ".refbuild", "bam2cram31")
    r = subprocess.run([os.path.join(root, "tools", "build_bam2cram31.sh")],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    cram31 = str(tmp_path / "reads31.cram")
    r = subprocess.run([tool, fix["bam"], fix["fasta"], cram31, "3.1"],
                       capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-500:]

    cr = CramReader(cram31, fasta=FastaFile(fix["fasta"]))
    assert (cr.major, cr.minor) == (3, 1)
    br = BamReader(fix["bam"])
    n = 0
    for a, b in zip(cr, br):
        assert _fields_full(a) == _fields_full(b), f"record {n}"
        n += 1
    assert n > 0
    assert sum(1 for _ in br) == 0  # same record count

    # the pure-Python fallback decoder must read the same records, and its
    # rANS Nx16 / tok3 paths must actually run (not a gzip-only file)
    from longphase_s_jax.io.cram import RANS_PR, TOK3
    import longphase_s_jax.io.cram as cram_mod
    methods = set()
    orig = cram_mod._uncompress

    def spy(method, data, raw_size):
        methods.add(method)
        return orig(method, data, raw_size)

    cram_mod._uncompress = spy
    os.environ["LPS_NO_NATIVE_CRAM"] = "1"
    try:
        py_recs = [_fields_full(r) for r in
                   CramReader(cram31, fasta=FastaFile(fix["fasta"]))]
    finally:
        cram_mod._uncompress = orig
        del os.environ["LPS_NO_NATIVE_CRAM"]
    assert RANS_PR in methods and TOK3 in methods
    nat_recs = [_fields_full(r) for r in
                CramReader(cram31, fasta=FastaFile(fix["fasta"]))]
    assert py_recs == nat_recs and len(py_recs) == n


def test_cram31_pipeline_input(reference_binary, small_fixture, tmp_path):
    """haplotag with a CRAM 3.1 input file: ours must produce tags
    identical to the reference binary reading the same 3.1 CRAM."""
    import os

    fix = small_fixture
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(root, ".refbuild", "bam2cram31")
    subprocess.run([os.path.join(root, "tools", "build_bam2cram31.sh")],
                   capture_output=True)
    cram31 = str(tmp_path / "reads31.cram")
    subprocess.run([tool, fix["bam"], fix["fasta"], cram31, "3.1"],
                   check=True, capture_output=True)
    phased = _phase_and_tag(reference_binary, fix, tmp_path)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", cram31, "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(snp_file=phased + ".vcf", bam_file=cram31,
                                fasta_file=fix["fasta"],
                                result_prefix=ours))
    assert _tags(ours + ".bam") == _tags(golden + ".bam")
