"""Synthetic long-read fixture generator.

Produces FASTA + het-SNP/indel VCF + coordinate-sorted BAM (+BAI) fixtures
that both this framework and the reference binary can consume, enabling
golden-output tests (SURVEY.md §4 test plan (a)).
"""

from __future__ import annotations

import struct

import numpy as np

from ..io.bam import BamWriter, _reg2bin
from ..io.bgzf import BgzfWriter
from ..io.fasta import write_fasta

BASES = "ACGT"
_OTHER_BASES = {b: [c for c in BASES if c != b] for b in BASES}


def _other_base(rng, base):
    return _OTHER_BASES[base][rng.integers(0, 3)]


def _nt16_table():
    from ..io.bam import SEQ_NT16

    lut = np.zeros(256, np.uint8)
    for i, c in enumerate(SEQ_NT16):
        lut[ord(c)] = i
    return lut


_NT16 = _nt16_table()


def _pack_seq(seq: str) -> bytes:
    """BAM 4-bit sequence encoding (two bases per byte)."""
    nib = _NT16[np.frombuffer(seq.upper().encode(), np.uint8)]
    if len(nib) % 2:
        nib = np.append(nib, np.uint8(0))
    return ((nib[0::2] << 4) | nib[1::2]).tobytes()


def simulate_chromosome(rng, length=200000, snp_rate=0.001, indel_rate=0.0):
    """Returns (ref_seq, variants) where variants is a sorted list of
    (pos0, ref_allele, alt_allele, hap_with_alt)."""
    seq = "".join(BASES[i] for i in rng.integers(0, 4, size=length))
    variants = []
    pos = 100
    while pos < length - 100:
        gap = max(10, int(rng.exponential(1.0 / snp_rate)))
        pos += gap
        if pos >= length - 100:
            break
        ref_b = seq[pos]
        if indel_rate > 0 and rng.random() < indel_rate:
            if rng.random() < 0.5:
                ins = "".join(BASES[i] for i in rng.integers(0, 4, size=rng.integers(1, 6)))
                variants.append((pos, ref_b, ref_b + ins, int(rng.integers(0, 2))))
            else:
                del_len = int(rng.integers(1, 6))
                if pos + del_len + 1 < length:
                    variants.append((pos, seq[pos:pos + del_len + 1], ref_b,
                                     int(rng.integers(0, 2))))
        else:
            variants.append((pos, ref_b, _other_base(rng, ref_b), int(rng.integers(0, 2))))
    return seq, variants


def _assemble_segment(ref_seq, events, start, end):
    """Walk ``events`` over [start, end) building (cigar, seq) exactly like
    the inline loop simulate_reads always used (pure refactor)."""
    seq_parts = []
    cigar = []  # list[(op, len)]
    cursor = start

    def push(op, ln):
        if ln <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    for pos, ref_a, alt_a in events:
        if pos < cursor or pos >= end:
            continue
        if len(ref_a) > 1 and pos + len(ref_a) > end:
            continue
        seq_parts.append(ref_seq[cursor:pos])
        push(0, pos - cursor)
        if len(ref_a) == 1 and len(alt_a) == 1:
            seq_parts.append(alt_a)
            push(0, 1)
            cursor = pos + 1
        elif len(ref_a) == 1:  # insertion
            seq_parts.append(alt_a)
            push(0, 1)
            push(1, len(alt_a) - 1)
            cursor = pos + 1
        else:  # deletion
            seq_parts.append(alt_a)
            push(0, 1)
            push(2, len(ref_a) - 1)
            cursor = pos + len(ref_a)
    seq_parts.append(ref_seq[cursor:end])
    push(0, end - cursor)
    return cigar, "".join(seq_parts)


def _homopolymer_runs(ref_seq, min_len=3):
    """(starts, lens) arrays of homopolymer runs of length >= min_len."""
    arr = np.frombuffer(ref_seq.encode(), np.uint8)
    if not len(arr):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.flatnonzero(np.diff(arr) != 0) + 1
    starts = np.concatenate(([0], change))
    lens = np.diff(np.concatenate((starts, [len(arr)])))
    keep = lens >= min_len
    return starts[keep].astype(np.int64), lens[keep].astype(np.int64)


def _sa_tag(chrom, pos0, cigar):
    """BAM SA:Z aux bytes for a split-read mate record."""
    cig = "".join(f"{ln}{'MIDNSHP=X'[op]}" for op, ln in cigar)
    return b"SAZ" + f"{chrom},{pos0 + 1},+,{cig},60,0;".encode() + b"\x00"


def simulate_reads(rng, ref_seq, variants, coverage=25, read_len=15000,
                   error_rate=0.0, qual=40, softclip_prob=0.3,
                   max_softclip=12, svs=None, mods=None,
                   per_read_events=None, name_prefix="read",
                   hp_indel_rate=0.0, split_at_sv_prob=0.0,
                   chimera_rate=0.0, chrom="chr20"):
    """Sample reads from the two haplotypes. Returns a list of
    (qname, pos0, cigar, seq, quals[, tags, flag]) sorted by pos.

    A fraction of reads get soft-clipped ends (the reference binary requires a
    non-empty clip table: Clip::getCNVInterval dereferences
    clipCount.rbegin() unconditionally, PhasingGraph.cpp:1134).

    Realism profile (the reference's published accuracy is
    on real ONT cell lines; these close the error-structure gap the plain
    profile leaves):
    - ``hp_indel_rate``: homopolymer-conditioned 1 bp indel errors. Real
      long-read error is indel-dominated and concentrates in homopolymer
      runs, scaling with run length; each run of length L >= 3 inside a
      read gets a CIGAR-visible 1 bp ins/del with prob ~rate*(L-2).
    - ``split_at_sv_prob``: reads crossing an SV breakpoint are emitted as
      split alignments — a clipped primary plus an SA-tagged supplementary
      (flag 0x800) — the way real aligners represent SV-spanning reads.
    - ``chimera_rate``: chimeric artifacts — a read whose tail comes from a
      distant locus, emitted as clipped primary + distant supplementary.
    All three default to 0 and draw no RNG when disabled, so pre-existing
    fixtures remain byte-identical."""
    # build the two haplotype sequences with coordinate maps
    haps = []
    for h in (0, 1):
        parts = []
        coords = []  # (ref_start, ref_end, hap_start) segments of exact match
        cursor = 0
        hpos = 0
        events = []
        for pos, ref_a, alt_a, hap_alt in variants:
            if hap_alt == h:
                events.append((pos, ref_a, alt_a))
        for pos, ref_a, alt_a in events:
            parts.append(ref_seq[cursor:pos])
            hpos += pos - cursor
            parts.append(alt_a)
            coords.append((cursor, pos, hpos - (pos - cursor)))
            hpos += len(alt_a)
            cursor = pos + len(ref_a)
        parts.append(ref_seq[cursor:])
        haps.append(("".join(parts), events))

    svs = svs or []
    mods = mods or []
    sv_rnames: dict[int, list] = {}
    mod_mr: dict[int, list] = {}
    mod_nr: dict[int, list] = {}
    # merge SV events into per-hap event lists
    hap_events = []
    for h in (0, 1):
        ev = list(haps[h][1])
        for pos, _svlen, hap, ref_s, alt_s in svs:
            if hap == h:
                ev.append((pos, ref_s, alt_s))
        ev.sort(key=lambda e: e[0])
        hap_events.append(ev)
    haps = [(haps[0][0], hap_events[0]), (haps[1][0], hap_events[1])]

    hp_starts = hp_lens = None
    if hp_indel_rate > 0:
        hp_starts, hp_lens = _homopolymer_runs(ref_seq)

    n_reads = max(1, int(len(ref_seq) * coverage / read_len))
    reads = []
    for i in range(n_reads * 2):
        h = i % 2
        start = int(rng.integers(0, max(1, len(ref_seq) - read_len // 2)))
        end = min(len(ref_seq), start + read_len + int(rng.integers(-read_len // 4, read_len // 4)))
        if end - start < 200:
            continue
        _hseq, events = haps[h]
        extra = per_read_events(i, h) if per_read_events is not None else None
        err_events = []
        if hp_starts is not None and len(hp_starts):
            # homopolymer-conditioned indel errors: 1bp ins/del per run,
            # probability scaling with run length (real ONT behavior)
            lo = int(np.searchsorted(hp_starts, start))
            hi = int(np.searchsorted(hp_starts, end - 4))
            if hi > lo:
                p = np.minimum(hp_indel_rate * (hp_lens[lo:hi] - 2), 0.5)
                for kk in np.flatnonzero(rng.random(hi - lo) < p).tolist():
                    rs = int(hp_starts[lo + kk])
                    b = ref_seq[rs]
                    if rng.random() < 0.5 and rs + 2 <= len(ref_seq):
                        err_events.append((rs, ref_seq[rs:rs + 2], b))
                    else:
                        err_events.append((rs, b, b + b))
        if extra or err_events:
            events = sorted(list(events) + list(extra or ())
                            + err_events, key=lambda e: e[0])

        # split-read shapes: SV-crossing split (primary + SA supplementary)
        # or a chimeric tail from a distant locus
        split_sv = None
        if split_at_sv_prob > 0 and svs:
            for pos, svlen, hap, _r, _a in svs:
                if hap == h and start + 300 < pos < end - 300:
                    if rng.random() < split_at_sv_prob:
                        split_sv = (pos, svlen)
                    break
        chimera = None
        if chimera_rate > 0 and split_sv is None and end - start > 2000 \
                and rng.random() < chimera_rate:
            chimera = int(rng.integers(0, max(1, len(ref_seq) - 2000)))

        qname = f"{name_prefix}_{i:05d}_h{h + 1}"
        emitted = []  # (qname, pos0, cigar, seq, quals, tags, flag)
        if split_sv is not None:
            bp, svlen = split_sv
            resume = bp + (-svlen if svlen < 0 else 0) + 1
            seg_end = min(max(end, resume + 300), len(ref_seq))
            if seg_end - resume < 50:
                split_sv = None  # breakpoint too close to the contig end
        if split_sv is not None:
            cig_a, seq_a = _assemble_segment(ref_seq, events, start, bp)
            cig_b, seq_b = _assemble_segment(ref_seq, events, resume,
                                             seg_end)
            # primary: left side + the right side soft-clipped
            pa = cig_a + [(4, len(seq_b))]
            pb = [(4, len(seq_a))] + cig_b
            emitted.append([qname, start, pa, seq_a + seq_b, None,
                            _sa_tag(chrom, resume, pb), 0])
            emitted.append([qname, resume, pb, seq_a + seq_b, None,
                            _sa_tag(chrom, start, pa), 0x800])
        elif chimera is not None:
            mid = start + (end - start) // 2
            cig_a, seq_a = _assemble_segment(ref_seq, events, start, mid)
            tail_len = min(end - mid, len(ref_seq) - chimera)
            seq_b = ref_seq[chimera:chimera + tail_len]
            cig_b = [(0, tail_len)]
            pa = cig_a + [(4, len(seq_b))]
            pb = [(4, len(seq_a))] + cig_b
            emitted.append([qname, start, pa, seq_a + seq_b, None,
                            _sa_tag(chrom, chimera, pb), 0])
            emitted.append([qname, chimera, pb, seq_a + seq_b, None,
                            _sa_tag(chrom, start, pa), 0x800])
        else:
            cigar, seq = _assemble_segment(ref_seq, events, start, end)
            # soft-clipped ends
            if rng.random() < softclip_prob:
                sc = int(rng.integers(1, max_softclip))
                seq = "".join(BASES[b]
                              for b in rng.integers(0, 4, size=sc)) + seq
                cigar.insert(0, (4, sc))
            if rng.random() < softclip_prob:
                sc = int(rng.integers(1, max_softclip))
                seq = seq + "".join(BASES[b]
                                    for b in rng.integers(0, 4, size=sc))
                cigar.append((4, sc))
            emitted.append([qname, start, cigar, seq, None, b"", 0])

        for rec in emitted:
            seq = rec[3]
            # sequencing errors (substitutions only, keeps CIGAR)
            if error_rate > 0:
                seq_l = list(seq)
                n_err = rng.binomial(len(seq_l), error_rate)
                for j in rng.integers(0, len(seq_l), size=n_err):
                    seq_l[j] = _other_base(rng, seq_l[j])
                seq = "".join(seq_l)
            rec[3] = seq
            rec[4] = bytes([qual]) * len(seq)
        for pos, _svlen, hap, _r, _a in svs:
            if hap == h and start <= pos < end:
                sv_rnames.setdefault(pos, []).append(qname)
        for pos, mhap in mods:
            if start <= pos < end:
                (mod_mr if mhap == h else mod_nr).setdefault(pos, []).append(qname)
        for rec in emitted:
            if rec[5] == b"" and rec[6] == 0:
                reads.append(tuple(rec[:5]))  # plain shape, byte-stable
            else:
                reads.append(tuple(rec))
    reads.sort(key=lambda r: r[1])
    if svs or mods:
        return reads, sv_rnames, mod_mr, mod_nr
    return reads


def simulate_svs(rng, ref_seq, variants, n_svs):
    """Het structural variants: (pos0, svlen, hap, ref_str, alt_str).
    svlen > 0 insertion, < 0 deletion. Kept >=1kb away from small variants."""
    taken = sorted(p for p, *_ in variants)
    out = []
    tries = 0
    while len(out) < n_svs and tries < n_svs * 50:
        tries += 1
        pos = int(rng.integers(2000, len(ref_seq) - 2000))
        import bisect

        i = bisect.bisect_left(taken, pos - 1000)
        if i < len(taken) and taken[i] < pos + 1000:
            continue
        svlen = int(rng.integers(50, 200))
        hap = int(rng.integers(0, 2))
        if rng.random() < 0.5:
            ins = "".join(BASES[b] for b in rng.integers(0, 4, size=svlen))
            out.append((pos, svlen, hap, ref_seq[pos], ref_seq[pos] + ins))
        else:
            if pos + svlen + 1 >= len(ref_seq):
                continue
            out.append((pos, -svlen, hap, ref_seq[pos:pos + svlen + 1], ref_seq[pos]))
        taken.insert(bisect.bisect_left(taken, pos), pos)
    out.sort(key=lambda s: s[0])
    return out


def simulate_mods(rng, ref_seq, variants, svs, n_mods):
    """Allele-specific methylation sites: (pos0, methylated_hap)."""
    taken = sorted([p for p, *_ in variants] + [s[0] for s in svs])
    out = []
    tries = 0
    while len(out) < n_mods and tries < n_mods * 50:
        tries += 1
        pos = int(rng.integers(1000, len(ref_seq) - 1000))
        import bisect

        i = bisect.bisect_left(taken, pos - 500)
        if i < len(taken) and taken[i] < pos + 500:
            continue
        out.append((pos, int(rng.integers(0, 2))))
        taken.insert(bisect.bisect_left(taken, pos), pos)
    out.sort(key=lambda m: m[0])
    return out


def write_sv_vcf(path, chrom, chrom_len, svs, rnames, sample="SAMPLE"):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={chrom_len}>\n")
        f.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">\n')
        f.write('##INFO=<ID=RNAMES,Number=.,Type=String,Description="Supporting reads">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for pos, svlen, hap, ref_s, alt_s in svs:
            names = ",".join(rnames.get(pos, [])) or "none"
            svtype = "INS" if svlen > 0 else "DEL"
            f.write(f"{chrom}\t{pos + 1}\t.\tN\t<{svtype}>\t60\tPASS\t"
                    f"SVLEN={svlen};RNAMES={names};END={pos + abs(svlen)}\tGT\t0/1\n")


def write_mod_vcf(path, chrom, chrom_len, mods, mr, nr, sample="SAMPLE"):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={chrom_len}>\n")
        f.write('##INFO=<ID=RS,Number=1,Type=String,Description="Strand">\n')
        f.write('##INFO=<ID=MR,Number=.,Type=String,Description="Modified reads">\n')
        f.write('##INFO=<ID=NR,Number=.,Type=String,Description="Unmodified reads">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for pos, _hap in mods:
            mr_s = ",".join(mr.get(pos, [])) or "none"
            nr_s = ",".join(nr.get(pos, [])) or "none"
            f.write(f"{chrom}\t{pos + 1}\t.\tC\tM\t60\tPASS\t"
                    f"RS=P;MR={mr_s};NR={nr_s}\tGT\t0/1\n")


def write_vcf(path, chrom, chrom_len, variants, sample="SAMPLE", phased=False,
              extra_format=False):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={chrom_len}>\n")
        f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        if extra_format:
            f.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">\n')
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for pos, ref_a, alt_a, hap_alt in variants:
            if phased:
                gt = "0|1" if hap_alt == 1 else "1|0"
            else:
                gt = "0/1"
            fmt, val = ("GT:DP", gt + ":30") if extra_format else ("GT", gt)
            f.write(f"{chrom}\t{pos + 1}\t.\t{ref_a}\t{alt_a}\t50\tPASS\t.\t{fmt}\t{val}\n")


def write_bam_with_index(path, chrom, chrom_len, reads, sample="SAMPLE"):
    """Writes a coordinate-sorted BAM, one BGZF block per record so virtual
    offsets are trivially known, plus a .bai index."""
    header_text = ("@HD\tVN:1.6\tSO:coordinate\n"
                   f"@SQ\tSN:{chrom}\tLN:{chrom_len}\n"
                   f"@RG\tID:rg1\tSM:{sample}\n")
    fh = open(path, "wb")
    bgzf = BgzfWriter(fh)
    text = header_text.encode()
    bgzf.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    nb = chrom.encode() + b"\x00"
    bgzf.write(struct.pack("<i", 1))
    bgzf.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", chrom_len))
    # flush header into its own block(s)
    bgzf._flush_block(bytes(bgzf._buf))
    bgzf._buf = bytearray()

    records = []  # (pos, end, voffset_beg, voffset_end)
    for entry in reads:
        qname, pos, cigar, seq, quals = entry[:5]
        tags = entry[5] if len(entry) > 5 else b""
        flag = entry[6] if len(entry) > 6 else 0
        name_b = qname.encode() + b"\x00"
        ref_len = sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))
        bin_ = _reg2bin(pos, pos + ref_len)
        fixed = struct.pack("<iiBBHHHiiii", 0, pos, len(name_b), 60, bin_,
                            len(cigar), flag, len(seq), -1, -1, 0)
        cig = b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cigar)
        body = fixed + name_b + cig + _pack_seq(seq) + bytes(quals) + tags
        voff_beg = fh.tell() << 16
        bgzf.write(struct.pack("<i", len(body)) + body)
        bgzf._flush_block(bytes(bgzf._buf))
        bgzf._buf = bytearray()
        voff_end = fh.tell() << 16
        records.append((pos, pos + max(ref_len, 1), voff_beg, voff_end))
    bgzf.close()

    # ---- BAI ----
    bins: dict[int, list[tuple[int, int]]] = {}
    n_windows = (chrom_len >> 14) + 1
    ioff = [0] * n_windows
    for pos, end, vb, ve in records:
        b = _reg2bin(pos, end)
        bins.setdefault(b, []).append((vb, ve))
        for w in range(pos >> 14, ((end - 1) >> 14) + 1):
            if ioff[w] == 0:
                ioff[w] = vb
    # merge adjacent chunks per bin
    merged_bins = {}
    for b, chunks in bins.items():
        chunks.sort()
        out = [list(chunks[0])]
        for vb, ve in chunks[1:]:
            if vb == out[-1][1]:
                out[-1][1] = ve
            else:
                out.append([vb, ve])
        merged_bins[b] = out
    # fill linear index gaps with previous value
    prev = 0
    for w in range(n_windows):
        if ioff[w] == 0:
            ioff[w] = prev
        else:
            prev = ioff[w]

    with open(path + ".bai", "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<i", len(merged_bins)))
        for b in sorted(merged_bins):
            chunks = merged_bins[b]
            f.write(struct.pack("<Ii", b, len(chunks)))
            for vb, ve in chunks:
                f.write(struct.pack("<QQ", vb, ve))
        f.write(struct.pack("<i", n_windows))
        for v in ioff:
            f.write(struct.pack("<Q", v))


REALISM_PROFILE = dict(hp_indel_rate=2e-4, split_at_sv_prob=0.5,
                       chimera_rate=0.004)


def make_fixture(out_dir: str, seed: int = 7, chrom: str = "chr20",
                 length: int = 200000, coverage: int = 25,
                 read_len: int = 15000, snp_rate: float = 0.001,
                 indel_rate: float = 0.0, error_rate: float = 0.0,
                 qual: int = 40, n_svs: int = 0, n_mods: int = 0,
                 realism: bool = False):
    """Generate a full fixture set; returns dict of paths. ``realism=True``
    enables the REALISM_PROFILE error structure (homopolymer indels,
    SV-breakpoint split reads, chimeras — see simulate_reads)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    rkw = dict(REALISM_PROFILE, chrom=chrom) if realism else {}
    ref_seq, variants = simulate_chromosome(rng, length, snp_rate, indel_rate)
    svs = simulate_svs(rng, ref_seq, variants, n_svs) if n_svs else []
    mods = simulate_mods(rng, ref_seq, variants, svs, n_mods) if n_mods else []
    result = {"chrom": chrom, "length": length, "variants": variants,
              "ref_seq": ref_seq, "svs": svs, "mods": mods}
    if svs or mods:
        reads, sv_rnames, mod_mr, mod_nr = simulate_reads(
            rng, ref_seq, variants, coverage, read_len, error_rate, qual,
            svs=svs, mods=mods, **rkw)
        sv_path = os.path.join(out_dir, "sv.vcf")
        write_sv_vcf(sv_path, chrom, length, svs, sv_rnames)
        result["sv_vcf"] = sv_path
        mod_path = os.path.join(out_dir, "mod.vcf")
        write_mod_vcf(mod_path, chrom, length, mods, mod_mr, mod_nr)
        result["mod_vcf"] = mod_path
    else:
        reads = simulate_reads(rng, ref_seq, variants, coverage, read_len,
                               error_rate, qual, **rkw)
    fa = os.path.join(out_dir, "ref.fa")
    vcf_path = os.path.join(out_dir, "snp.vcf")
    bam = os.path.join(out_dir, "reads.bam")
    write_fasta(fa, {chrom: ref_seq})
    write_vcf(vcf_path, chrom, length, variants)
    write_bam_with_index(bam, chrom, length, reads)
    result.update({"fasta": fa, "vcf": vcf_path, "bam": bam, "reads": reads})
    return result


def make_somatic_fixture(out_dir: str, seed: int = 7, chrom: str = "chr20",
                         length: int = 200000, normal_coverage: int = 25,
                         tumor_coverage: int = 30, purity: float = 0.6,
                         n_somatic: int = 20, n_artifacts: int = 5,
                         read_len: int = 12000, snp_rate: float = 0.0012,
                         error_rate: float = 0.02, qual: int = 25,
                         realism: bool = False):
    """Tumor/normal pair fixture for the somatic pipelines.

    Somatic SNVs sit on one germline haplotype and appear only in the
    tumor-derived fraction (``purity``) of tumor reads; artifact candidates
    are random positions with a couple of error-carrying reads (should be
    filtered by the recalibration engine).
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref_seq, variants = simulate_chromosome(rng, length, snp_rate, 0.0)

    taken = sorted(p for p, *_ in variants)
    import bisect

    def pick_free_pos():
        for _ in range(200):
            pos = int(rng.integers(1000, length - 1000))
            i = bisect.bisect_left(taken, pos - 300)
            if i < len(taken) and taken[i] < pos + 300:
                continue
            bisect.insort(taken, pos)
            return pos
        raise RuntimeError("no free position")

    somatic = []   # (pos, ref, alt, hap)
    for _ in range(n_somatic):
        pos = pick_free_pos()
        ref_b = ref_seq[pos]
        somatic.append((pos, ref_b, _other_base(rng, ref_b), int(rng.integers(0, 2))))
    somatic.sort(key=lambda s: s[0])

    artifacts = []  # (pos, ref, alt)
    for _ in range(n_artifacts):
        pos = pick_free_pos()
        ref_b = ref_seq[pos]
        artifacts.append((pos, ref_b, _other_base(rng, ref_b)))
    artifacts.sort(key=lambda a: a[0])

    rkw = dict(REALISM_PROFILE, chrom=chrom) if realism else {}
    rkw.pop("split_at_sv_prob", None)  # no SVs in the somatic fixture
    # normal reads
    normal_reads = simulate_reads(rng, ref_seq, variants, normal_coverage,
                                  read_len, error_rate, qual,
                                  name_prefix="nor", **rkw)

    # tumor reads: per-read somatic events
    tumor_flags = {}

    def tumor_events(read_idx, hap):
        is_tumor = rng.random() < purity
        tumor_flags[read_idx] = is_tumor
        ev = []
        if is_tumor:
            for pos, ref_b, alt_b, shap in somatic:
                if shap == hap:
                    ev.append((pos, ref_b, alt_b))
        # artifact support: rare random error reads
        for k, (pos, ref_b, alt_b) in enumerate(artifacts):
            if rng.random() < 0.04:
                ev.append((pos, ref_b, alt_b))
        return ev

    tumor_reads = simulate_reads(rng, ref_seq, variants, tumor_coverage,
                                 read_len, error_rate, qual,
                                 per_read_events=tumor_events,
                                 name_prefix="tum", **rkw)

    fa = os.path.join(out_dir, "ref.fa")
    write_fasta(fa, {chrom: ref_seq})
    nvcf = os.path.join(out_dir, "normal_snp.vcf")
    write_vcf(nvcf, chrom, length, variants)
    tvcf = os.path.join(out_dir, "tumor_snv.vcf")
    tumor_candidates = ([(p, r, a, h) for p, r, a, h in somatic]
                        + [(p, r, a, 0) for p, r, a in artifacts])
    tumor_candidates.sort(key=lambda v: v[0])
    write_vcf(tvcf, chrom, length, tumor_candidates)
    nbam = os.path.join(out_dir, "normal.bam")
    write_bam_with_index(nbam, chrom, length, normal_reads)
    tbam = os.path.join(out_dir, "tumor.bam")
    write_bam_with_index(tbam, chrom, length, tumor_reads)
    return {"fasta": fa, "normal_vcf": nvcf, "tumor_vcf": tvcf,
            "normal_bam": nbam, "tumor_bam": tbam, "chrom": chrom,
            "length": length, "variants": variants, "somatic": somatic,
            "artifacts": artifacts, "purity": purity}


def write_truth_files(out_dir, chrom, length, somatic):
    """Truth somatic VCF + BED for the benchmark harness."""
    import os

    tvcf = os.path.join(out_dir, "truth.vcf")
    with open(tvcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={length}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref_b, alt_b, _hap in somatic:
            f.write(f"{chrom}\t{pos + 1}\t.\t{ref_b}\t{alt_b}\t60\tPASS\t.\n")
    tbed = os.path.join(out_dir, "truth.bed")
    with open(tbed, "w") as f:
        # two regions leaving a gap in the middle and the tail uncovered
        f.write(f"{chrom}\t0\t{int(length * 0.45)}\n")
        f.write(f"{chrom}\t{int(length * 0.55)}\t{int(length * 0.85)}\n")
    return tvcf, tbed


def make_meth_fixture(out_dir: str, seed: int = 7, chrom: str = "chr20",
                      length: int = 150000, coverage: int = 25,
                      read_len: int = 10000, snp_rate: float = 0.0012,
                      n_asm: int = 12, n_homo_mod: int = 6, qual: int = 30):
    """MM/ML-tagged BAM fixture for modcall: allele-specific methylation at
    CpG sites (forward reads list the C, reverse reads the paired G) on one
    germline haplotype, plus homozygous-methylated sites."""
    import os
    import struct as _struct
    import bisect

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref_seq, variants = simulate_chromosome(rng, length, snp_rate, 0.0)
    taken = sorted(p for p, *_ in variants)

    def pick_cg_pos():
        for _ in range(800):
            pos = int(rng.integers(1000, length - 1000))
            if ref_seq[pos] != "C" or ref_seq[pos + 1] != "G":
                continue
            i = bisect.bisect_left(taken, pos - 60)
            if i < len(taken) and taken[i] < pos + 62:
                continue
            bisect.insort(taken, pos)
            bisect.insort(taken, pos + 1)
            return pos
        raise RuntimeError("no free CpG position")

    asm_sites = sorted((pick_cg_pos(), int(rng.integers(0, 2)))
                       for _ in range(n_asm))
    homo_sites = sorted(pick_cg_pos() for _ in range(n_homo_mod))

    reads = simulate_reads(rng, ref_seq, variants, coverage, read_len,
                           error_rate=0.0, qual=qual, softclip_prob=0.25)

    tagged = []
    for qname, start, cigar, seq, quals in reads:
        hap = 0 if qname.endswith("h1") else 1
        is_rev = rng.random() < 0.5
        # ref->query map over the aligned (stored) sequence
        ref2q = {}
        qpos = 0
        rpos = start
        for op, ln in cigar:
            if op in (0, 7, 8):
                for k in range(ln):
                    ref2q[rpos + k] = qpos + k
                qpos += ln
                rpos += ln
            elif op in (1, 4):
                qpos += ln
            elif op in (2, 3):
                rpos += ln

        listed = []  # (stored_qpos, ml)
        target_base = "G" if is_rev else "C"
        for pos, mhap in asm_sites:
            q = ref2q.get(pos + 1 if is_rev else pos)
            if q is not None and seq[q] == target_base:
                listed.append((q, 240 if mhap == hap else 8))
        for pos in homo_sites:
            q = ref2q.get(pos + 1 if is_rev else pos)
            if q is not None and seq[q] == target_base:
                listed.append((q, 245))
        tags = b""
        if listed:
            if is_rev:
                # MM counts complement(C)=G bases from the tail of the
                # stored sequence
                t_positions = [i for i in range(len(seq) - 1, -1, -1)
                               if seq[i] == "G"]
                listed.sort(key=lambda x: -x[0])
            else:
                t_positions = [i for i in range(len(seq)) if seq[i] == "C"]
                listed.sort()
            rank = {p: i for i, p in enumerate(t_positions)}
            deltas = []
            mls = []
            prev = -1
            ok = True
            for q, ml_val in listed:
                r = rank.get(q)
                if r is None:
                    ok = False
                    break
                deltas.append(r - prev - 1)
                prev = r
                mls.append(ml_val)
            if ok and deltas:
                mm = "C+m?," + ",".join(str(d) for d in deltas) + ";"
                tags += b"MMZ" + mm.encode() + b"\x00"
                tags += b"MLBC" + _struct.pack("<I", len(mls)) + bytes(mls)
        flag = 0x10 if is_rev else 0
        tagged.append((qname, start, cigar, seq, quals, tags, flag))

    fa = os.path.join(out_dir, "ref.fa")
    write_fasta(fa, {chrom: ref_seq})
    vcf_path = os.path.join(out_dir, "snp.vcf")
    write_vcf(vcf_path, chrom, length, variants)
    bam = os.path.join(out_dir, "reads.bam")
    write_bam_with_index(bam, chrom, length, tagged)
    return {"fasta": fa, "vcf": vcf_path, "bam": bam, "chrom": chrom,
            "length": length, "variants": variants, "asm_sites": asm_sites,
            "homo_sites": homo_sites, "ref_seq": ref_seq}


def write_bam_multi(path, chroms, reads_by_chrom, sample="SAMPLE"):
    """Multi-reference coordinate-sorted BAM + BAI.

    ``chroms``: list of (name, length); ``reads_by_chrom``: parallel list of
    read-entry lists (same entry shape as write_bam_with_index)."""
    header_text = "@HD\tVN:1.6\tSO:coordinate\n"
    for name, ln in chroms:
        header_text += f"@SQ\tSN:{name}\tLN:{ln}\n"
    header_text += f"@RG\tID:rg1\tSM:{sample}\n"
    fh = open(path, "wb")
    bgzf = BgzfWriter(fh)
    text = header_text.encode()
    bgzf.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    bgzf.write(struct.pack("<i", len(chroms)))
    for name, ln in chroms:
        nb = name.encode() + b"\x00"
        bgzf.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
    bgzf._flush_block(bytes(bgzf._buf))
    bgzf._buf = bytearray()

    per_ref_records = []
    for tid, reads in enumerate(reads_by_chrom):
        records = []
        for entry in reads:
            qname, pos, cigar, seq, quals = entry[:5]
            tags = entry[5] if len(entry) > 5 else b""
            flag = entry[6] if len(entry) > 6 else 0
            name_b = qname.encode() + b"\x00"
            ref_len = sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))
            bin_ = _reg2bin(pos, pos + ref_len)
            fixed = struct.pack("<iiBBHHHiiii", tid, pos, len(name_b), 60,
                                bin_, len(cigar), flag, len(seq), -1, -1, 0)
            cig = b"".join(struct.pack("<I", (ln << 4) | op)
                           for op, ln in cigar)
            body = fixed + name_b + cig + _pack_seq(seq) + bytes(quals) + tags
            voff_beg = fh.tell() << 16
            bgzf.write(struct.pack("<i", len(body)) + body)
            bgzf._flush_block(bytes(bgzf._buf))
            bgzf._buf = bytearray()
            voff_end = fh.tell() << 16
            records.append((pos, pos + max(ref_len, 1), voff_beg, voff_end))
        per_ref_records.append(records)
    bgzf.close()

    with open(path + ".bai", "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", len(chroms)))
        for (name, chrom_len), records in zip(chroms, per_ref_records):
            bins: dict[int, list[tuple[int, int]]] = {}
            n_windows = (chrom_len >> 14) + 1
            ioff = [0] * n_windows
            for pos, end, vb, ve in records:
                b = _reg2bin(pos, end)
                bins.setdefault(b, []).append((vb, ve))
                for w in range(pos >> 14, ((end - 1) >> 14) + 1):
                    if ioff[w] == 0:
                        ioff[w] = vb
            merged_bins = {}
            for b, chunks in bins.items():
                chunks.sort()
                out = [list(chunks[0])]
                for vb, ve in chunks[1:]:
                    if vb == out[-1][1]:
                        out[-1][1] = ve
                    else:
                        out.append([vb, ve])
                merged_bins[b] = out
            prev = 0
            for w in range(n_windows):
                if ioff[w] == 0:
                    ioff[w] = prev
                else:
                    prev = ioff[w]
            f.write(struct.pack("<i", len(merged_bins)))
            for b in sorted(merged_bins):
                chunks = merged_bins[b]
                f.write(struct.pack("<Ii", b, len(chunks)))
                for vb, ve in chunks:
                    f.write(struct.pack("<QQ", vb, ve))
            f.write(struct.pack("<i", n_windows))
            for v in ioff:
                f.write(struct.pack("<Q", v))


def make_multichrom_fixture(out_dir: str, seed: int = 7, n_chroms: int = 3,
                            base_length: int = 120000, coverage: int = 12,
                            read_len: int = 9000, snp_rate: float = 0.0012,
                            error_rate: float = 0.03, qual: int = 22):
    """Diploid fixture spanning several chromosomes of different sizes —
    exercises the per-chromosome pipeline loops (chrVec ordering, per-chrom
    PS blocks, BAI multi-ref index)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    chroms = []
    seqs = {}
    variants_by_chrom = {}
    reads_by_chrom = []
    for c in range(n_chroms):
        name = f"chr{20 + c}"
        length = base_length + c * 40000
        ref_seq, variants = simulate_chromosome(rng, length, snp_rate, 0.0)
        reads = simulate_reads(rng, ref_seq, variants, coverage, read_len,
                               error_rate, qual, name_prefix=f"c{c}")
        chroms.append((name, length))
        seqs[name] = ref_seq
        variants_by_chrom[name] = variants
        reads_by_chrom.append(reads)

    fa = os.path.join(out_dir, "ref.fa")
    write_fasta(fa, seqs)
    vcf_path = os.path.join(out_dir, "snp.vcf")
    with open(vcf_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        for name, ln in chroms:
            f.write(f"##contig=<ID={name},length={ln}>\n")
        f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for name, _ln in chroms:
            for pos, ref_a, alt_a, _hap in variants_by_chrom[name]:
                f.write(f"{name}\t{pos + 1}\t.\t{ref_a}\t{alt_a}\t50\tPASS"
                        f"\t.\tGT\t0/1\n")
    bam = os.path.join(out_dir, "reads.bam")
    write_bam_multi(bam, chroms, reads_by_chrom)
    return {"chroms": chroms, "fasta": fa, "vcf": vcf_path, "bam": bam}


def make_multichrom_somatic_fixture(out_dir: str, seed: int = 7,
                                    n_chroms: int = 2,
                                    base_length: int = 150000,
                                    purity: float = 0.5,
                                    n_somatic: int = 12, n_artifacts: int = 4):
    """Tumor/normal fixture spanning several chromosomes — exercises the
    somatic pipeline's per-chromosome loops (chrVec from the tumor VCF,
    per-chrom extraction/calling/tagging, multi-ref BAMs)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    chroms = []
    seqs = {}
    per_chrom = []
    for c in range(n_chroms):
        name = f"chr{20 + c}"
        length = base_length + c * 50000
        sub = make_somatic_fixture(
            os.path.join(out_dir, f"_c{c}"), seed=seed + 101 * c, chrom=name,
            length=length, purity=purity, n_somatic=n_somatic,
            n_artifacts=n_artifacts)
        chroms.append((name, length))
        with open(sub["fasta"]) as f:
            seq = "".join(l.strip() for l in f if not l.startswith(">"))
        seqs[name] = seq
        per_chrom.append(sub)

    fa = os.path.join(out_dir, "ref.fa")
    write_fasta(fa, seqs)

    def merge_vcfs(key, out_name):
        out = os.path.join(out_dir, out_name)
        with open(out, "w") as f:
            f.write("##fileformat=VCFv4.2\n")
            for name, ln in chroms:
                f.write(f"##contig=<ID={name},length={ln}>\n")
            f.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
            f.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                    'Description="Genotype">\n')
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                    "\tSAMPLE\n")
            for sub in per_chrom:
                for line in open(sub[key]):
                    if not line.startswith("#"):
                        f.write(line)
        return out

    nvcf = merge_vcfs("normal_vcf", "normal_snp.vcf")
    tvcf = merge_vcfs("tumor_vcf", "tumor_snv.vcf")

    def merge_bams(key, out_name):
        from ..io.bam import BamReader
        out = os.path.join(out_dir, out_name)
        reads_by_chrom = []
        for tid, sub in enumerate(per_chrom):
            entries = []
            for rec in BamReader(sub[key]):
                entries.append((rec.qname, rec.pos, rec.cigar_tuples(),
                                rec.seq(), bytes(rec.qual()),
                                rec.raw[rec._aux_offset():], rec.flag))
            reads_by_chrom.append(entries)
        write_bam_multi(out, chroms, reads_by_chrom)
        return out

    nbam = merge_bams("normal_bam", "normal.bam")
    tbam = merge_bams("tumor_bam", "tumor.bam")
    return {"fasta": fa, "normal_vcf": nvcf, "tumor_vcf": tvcf,
            "normal_bam": nbam, "tumor_bam": tbam, "chroms": chroms}


def make_multichrom_meth_fixture(out_dir: str, seed: int = 7,
                                 n_chroms: int = 3,
                                 base_length: int = 120000):
    """MM/ML fixture spanning several chromosomes — exercises modcall's
    per-chromosome loop and multi-host sharding."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    chroms = []
    seqs = {}
    per_chrom = []
    for c in range(n_chroms):
        name = f"chr{20 + c}"
        length = base_length + c * 30000
        sub = make_meth_fixture(os.path.join(out_dir, f"_c{c}"),
                                seed=seed + 37 * c, chrom=name, length=length)
        chroms.append((name, length))
        with open(sub["fasta"]) as f:
            seqs[name] = "".join(l.strip() for l in f
                                 if not l.startswith(">"))
        per_chrom.append(sub)

    fa = os.path.join(out_dir, "ref.fa")
    write_fasta(fa, seqs)

    vcf_path = os.path.join(out_dir, "snp.vcf")
    with open(vcf_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        for name, ln in chroms:
            f.write(f"##contig=<ID={name},length={ln}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                'Description="Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                "\tSAMPLE\n")
        for sub in per_chrom:
            for line in open(sub["vcf"]):
                if not line.startswith("#"):
                    f.write(line)

    from ..io.bam import BamReader
    bam = os.path.join(out_dir, "reads.bam")
    reads_by_chrom = []
    for sub in per_chrom:
        entries = []
        for rec in BamReader(sub["bam"]):
            entries.append((rec.qname, rec.pos, rec.cigar_tuples(),
                            rec.seq(), bytes(rec.qual()),
                            rec.raw[rec._aux_offset():], rec.flag))
        reads_by_chrom.append(entries)
    write_bam_multi(bam, chroms, reads_by_chrom)
    return {"chroms": chroms, "fasta": fa, "vcf": vcf_path, "bam": bam}


def random_somatic_items(seed: int, n: int, S: int = 96, A: int = 64,
                         No: int = 1024):
    """``n`` random per-chromosome inputs (walk, tables, is_som, derive,
    gate) for the somatic tag reductions (ops/tag_kernels.py): the mesh
    and single-device forms are compared on them."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        walk = {"obs_var": rng.integers(0, S, No).astype(np.int64),
                "obs_aln": rng.integers(0, A, No).astype(np.int64),
                "obs_aux": rng.integers(0, 32, No).astype(np.int64),
                "obs_base": rng.integers(0, 6, No).astype(np.uint8),
                "obs_flags": rng.integers(0, 16, No).astype(np.uint8),
                "obs_kind": rng.integers(0, 3, No).astype(np.uint8),
                "category": np.zeros(A, np.uint8)}
        t = {"pos": np.arange(S, dtype=np.int64) * 50}
        for key in ("nor_has", "alt_eq_hp1", "alt_eq_hp2", "ref_eq_hp1",
                    "ref_eq_hp2", "hp1_long", "hp2_long", "tum_has",
                    "tum_ref_is1", "tum_alt_is1"):
            t[key] = rng.integers(0, 2, S).astype(bool)
        for key in ("nor_vt", "tum_vt"):
            t[key] = rng.integers(0, 4, S).astype(np.int32)
        for key in ("nor_gt", "tum_gt"):
            t[key] = rng.integers(-1, 2, S).astype(np.int32)
        for key in ("nor_ps", "tum_ps"):
            t[key] = rng.integers(0, 1000, S).astype(np.int64)
        for key in ("nor_ref0", "nor_alt0", "tum_ref0", "tum_alt0",
                    "nor_hp1c", "nor_hp2c"):
            t[key] = rng.integers(0, 4, S).astype(np.int32)
        items.append({"walk": walk, "t": t,
                      "is_som": rng.integers(0, 2, S).astype(bool),
                      "derive": rng.integers(0, 3, S).astype(np.int8),
                      "gate": rng.integers(0, 2, No).astype(np.uint8)})
    return items
