import os

import numpy as np

from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.io.bgzf import BgzfReader, BgzfWriter, is_bgzf
from longphase_s_jax.io.fasta import FastaFile, write_fasta
from longphase_s_jax.io import vcf as vcf_io


def test_bgzf_roundtrip(tmp_path):
    path = str(tmp_path / "x.bgzf")
    data = os.urandom(300000) + b"tail"
    w = BgzfWriter(path)
    w.write(data)
    w.close()
    assert is_bgzf(path)
    r = BgzfReader(path)
    assert r.read() == data
    r.close()


def test_fasta_fetch(tmp_path):
    path = str(tmp_path / "ref.fa")
    seq = "ACGTACGTGGGTTTACAGT" * 50
    write_fasta(path, {"chr1": seq}, width=17)
    fa = FastaFile(path)
    assert fa.fetch("chr1", 0, 10) == seq[:10]
    assert fa.fetch("chr1", 33, 170) == seq[33:170]
    assert fa.fetch("chr1", 0, 10 ** 9) == seq
    assert fa.length("chr1") == len(seq)


def test_bam_roundtrip(small_fixture):
    reader = BamReader(small_fixture["bam"])
    assert reader.references == [small_fixture["chrom"]]
    recs = list(reader)
    assert len(recs) == len(small_fixture["reads"])
    qname, pos, cigar, seq, quals = small_fixture["reads"][0]
    r = recs[0]
    assert r.qname == qname
    assert r.pos == pos
    assert r.cigar_tuples() == cigar
    assert r.seq() == seq
    assert bytes(r.qual()) == quals
    reader.close()


def test_vcf_het_parse(small_fixture):
    het = vcf_io.read_het_variants(small_fixture["vcf"])
    chrom = small_fixture["chrom"]
    assert het.contigs == [chrom]
    want = {pos for pos, *_ in small_fixture["variants"]}
    assert set(het.by_chrom[chrom]) == want
    assert het.last_snp(chrom) == max(want)


def test_bgzf_span_reader_matches_per_block(small_fixture):
    """The batched native span decode must byte-match the per-block loader
    and keep virtual offsets exact (tell/seek round-trip)."""
    from longphase_s_jax.io.bgzf import BgzfReader

    path = small_fixture["bam"]
    a = BgzfReader(path).read()
    blk = BgzfReader(path)
    blk._load_span = lambda: False  # force the legacy per-block path
    b = blk.read()
    assert a == b and len(a) > 0

    rr = BgzfReader(path)
    rr.read(len(a) // 3)
    v = rr.tell_virtual()
    want = rr.read(256)
    rr2 = BgzfReader(path)
    rr2.seek_virtual(v)
    assert rr2.read(256) == want
