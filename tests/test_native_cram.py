"""Native CRAM decoder (native/lps_cram.cpp) vs the pure-Python reader.

The native path must (a) actually engage (no silent fallback), and
(b) produce byte-identical BAM records on both htslib-written and
own-written CRAMs, including crai-based region fetches."""

import subprocess

import pytest

from longphase_s_jax import native
from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.io.cram import CramReader, CramWriter
from longphase_s_jax.io.fasta import FastaFile


def _raw_records(reader):
    return [bytes(r.raw) for r in reader]


@pytest.fixture(scope="module")
def own_cram(tmp_path_factory, small_fixture):
    d = tmp_path_factory.mktemp("native_cram")
    br = BamReader(small_fixture["bam"])
    path = str(d / "own.cram")
    w = CramWriter(path, br.header_text, br.references, br.lengths)
    for rec in br:
        w.write(rec)
    w.close()
    return path


@pytest.fixture(scope="module")
def htslib_cram(tmp_path_factory, reference_binary, small_fixture):
    d = tmp_path_factory.mktemp("native_cram_hts")
    phased = str(d / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s",
                    small_fixture["vcf"], "-b", small_fixture["bam"],
                    "-r", small_fixture["fasta"], "-o", phased],
                   check=True, capture_output=True)
    out = str(d / "g_cram")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "-b", small_fixture["bam"], "-r", small_fixture["fasta"],
                    "--cram", "-o", out], check=True, capture_output=True)
    return out + ".cram"


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_native_engages_and_matches_python_own(own_cram, small_fixture,
                                               monkeypatch):
    fa = FastaFile(small_fixture["fasta"])
    assert native.cram_decode(own_cram, fa.path) is not None  # no fallback
    nat = _raw_records(CramReader(own_cram, fasta=fa))
    monkeypatch.setenv("LPS_NO_NATIVE_CRAM", "1")
    py = _raw_records(CramReader(own_cram, fasta=fa))
    assert len(nat) == len(py) > 0
    assert nat == py


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_native_matches_python_htslib(htslib_cram, small_fixture, monkeypatch):
    fa = FastaFile(small_fixture["fasta"])
    assert native.cram_decode(htslib_cram, fa.path) is not None
    nat = _raw_records(CramReader(htslib_cram, fasta=fa))
    monkeypatch.setenv("LPS_NO_NATIVE_CRAM", "1")
    py = _raw_records(CramReader(htslib_cram, fasta=fa))
    assert len(nat) == len(py) > 0
    assert nat == py


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_native_fetch_matches_python(own_cram, small_fixture, monkeypatch):
    fa = FastaFile(small_fixture["fasta"])
    chrom = small_fixture["chrom"]
    length = small_fixture["length"]
    start, end = length // 3, 2 * length // 3
    nat = _raw_records(CramReader(own_cram, fasta=fa).fetch(chrom, start, end))
    monkeypatch.setenv("LPS_NO_NATIVE_CRAM", "1")
    py = _raw_records(CramReader(own_cram, fasta=fa).fetch(chrom, start, end))
    assert nat == py and len(nat) > 0


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_pipelined_writer_multi_container(tmp_path, small_fixture):
    """More records than RECORDS_PER_CONTAINER forces multiple containers
    through the pipelined worker; order and counters must survive."""
    br = BamReader(small_fixture["bam"])
    recs = list(br)
    # duplicate records until we just exceed one container boundary
    per = CramWriter.RECORDS_PER_CONTAINER
    want = per + max(len(recs), 200)
    path = str(tmp_path / "multi.cram")
    w = CramWriter(path, br.header_text, br.references, br.lengths)
    n = 0
    while n < want:
        for r in recs:
            w.write(r)
            n += 1
    w.close()
    assert n > per  # really multi-container
    fa = FastaFile(small_fixture["fasta"])
    got = sum(1 for _ in CramReader(path, fasta=fa))
    assert got == n
    # python decoder agrees (exercises slice record counters)
    import os
    os.environ["LPS_NO_NATIVE_CRAM"] = "1"
    try:
        got_py = sum(1 for _ in CramReader(path, fasta=fa))
    finally:
        del os.environ["LPS_NO_NATIVE_CRAM"]
    assert got_py == n
