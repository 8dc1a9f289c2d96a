"""CRAM 3.0 reader/writer, implemented from the CRAM format specification.

Behavioral contract: files produced by htslib-1.16's CRAM writer (the
reference links htslib for `--cram` output, HaplotagParsingBam.cpp:18-161)
decode to the same records htslib produces, and files written here are
readable by htslib. No htslib code is used; the wire format follows the
hts-specs CRAM 3.0 document (container/block layout, ITF8/LTF8 varints,
codec parameter blocks, rANS 4x8, canonical-Huffman bit codes).

Reader strategy: decode each slice eagerly into raw BAM-format record
bytes and wrap them in :class:`~longphase_s_jax.io.bam.BamRecord`, so every
downstream consumer (haplotag walkers, somatic extraction) works unchanged.

Writer strategy: reference-based X-substitution encoding against the fasta
when one is given (native encoder; ~5x smaller on long reads), verbatim
'b'-run encoding otherwise (and always in the pure-Python fallback).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bam import SEQ_NT16, BamRecord, _reg2bin

# block compression methods (CRAM 3.0; 3.1 adds RANS_PR/ARITH/FQZ/TOK3)
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
RANS_PR, ARITH, FQZ, TOK3 = 5, 6, 7, 8
# block content types
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER, CT_EXTERNAL, CT_CORE = \
    0, 1, 2, 4, 5
# encodings
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, \
    E_BYTE_ARRAY_STOP, E_BETA, E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = range(10)

# CRAM record flags (cram_structs.h:954-958 values, per spec)
CF_QUAL, CF_DETACHED, CF_DOWNSTREAM, CF_NO_SEQ, CF_EXPLICIT_TLEN = \
    1, 2, 4, 8, 16
MATE_REVERSE, MATE_UNMAP = 1, 2

BAM_FPAIRED = 0x1
BAM_FUNMAP = 0x4
BAM_FMUNMAP = 0x8
BAM_FREVERSE = 0x10
BAM_FMREVERSE = 0x20
BAM_FREAD1 = 0x40

DEFAULT_SUB_MATRIX = "CGTNAGTNACTNACGNACGT"

# ASCII -> nt16 code lookup (unknown bases -> N=15), case-insensitive
_NT16_CODE = np.full(256, 15, np.uint8)
for _i, _c in enumerate(SEQ_NT16):
    _NT16_CODE[ord(_c)] = _i
    _NT16_CODE[ord(_c.lower())] = _i
_BASE_IDX = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4,
             "a": 0, "c": 1, "g": 2, "t": 3, "n": 4}

# canonical CRAM 3.0 EOF container (38 bytes, from the spec)
EOF_CONTAINER = bytes([
    0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
    0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
    0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
    0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b,
])


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def itf8_get(buf, off):
    b0 = buf[off]
    if b0 < 0x80:
        return b0, off + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[off + 1], off + 2
    if b0 < 0xE0:
        return ((b0 & 0x1F) << 16) | (buf[off + 1] << 8) | buf[off + 2], off + 3
    if b0 < 0xF0:
        return (((b0 & 0x0F) << 24) | (buf[off + 1] << 16)
                | (buf[off + 2] << 8) | buf[off + 3]), off + 4
    v = (((b0 & 0x0F) << 28) | (buf[off + 1] << 20) | (buf[off + 2] << 12)
         | (buf[off + 3] << 4) | (buf[off + 4] & 0x0F))
    return v, off + 5


def itf8_get_signed(buf, off):
    v, off = itf8_get(buf, off)
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off


def ltf8_get(buf, off):
    b0 = buf[off]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 0:
        return b0, off + 1
    if n < 8:
        v = b0 & (0xFF >> (n + 1))
        for i in range(n):
            v = (v << 8) | buf[off + 1 + i]
        return v, off + 1 + n
    v = 0
    for i in range(8):
        v = (v << 8) | buf[off + 1 + i]
    return v, off + 9


def itf8_put(v):
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def ltf8_put(v):
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    out = []
    tmp = v
    nbytes = 0
    while tmp:
        tmp >>= 8
        nbytes += 1
    # prefix byte has `n` leading ones then a zero; holds high bits if room
    for n in range(1, 8):
        if v < (1 << (7 * (n + 1) - n)):
            prefix_bits = 0xFF ^ (0xFF >> n)
            high = v >> (8 * n)
            out = [prefix_bits | high]
            for i in range(n - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return bytes(out)
    out = [0xFF]
    for i in range(7, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# rANS 4x8 static codec (CRAM 3.0 codec; spec section 13 / rANS4x8)
# ---------------------------------------------------------------------------

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_BYTE_L = 1 << 23


def _read_freqs(data, off):
    """Order-0 frequency table: {sym, freq} with +1-RLE (see spec)."""
    freqs = {}
    rle = 0
    j = data[off]
    off += 1
    while True:
        f = data[off]
        off += 1
        if f >= 128:
            f = ((f & 127) << 8) | data[off]
            off += 1
        freqs[j] = f
        if not rle and off < len(data) and data[off] == j + 1:
            j = data[off]
            rle = data[off + 1]
            off += 2
        elif rle:
            rle -= 1
            j += 1
        else:
            j = data[off]
            off += 1
        if j == 0:
            break
    return freqs, off


def _rans_tables(freqs, zero_is_total=False):
    ssym = np.zeros(TOTFREQ, np.uint8)
    sfreq = np.zeros(TOTFREQ, np.uint32)
    sbase = np.zeros(TOTFREQ, np.uint32)
    x = 0
    for sym, f in freqs.items():
        if f == 0:
            if not zero_is_total:
                continue
            f = TOTFREQ  # order-1 quirk: F==0 means the full range
        ssym[x:x + f] = sym
        sfreq[x:x + f] = f
        sbase[x:x + f] = np.arange(f, dtype=np.uint32)
        x += f
    if x == TOTFREQ - 1:  # historically 4095, not 4096
        ssym[x] = ssym[x - 1]
        sfreq[x] = sfreq[x - 1]
        sbase[x] = sbase[x - 1] + 1
    return ssym, sfreq, sbase


def _rans_decode_o0(data):
    in_sz, out_sz = struct.unpack_from("<II", data, 1)
    freqs, off = _read_freqs(data, 9)
    ssym, sfreq, sbase = _rans_tables(freqs)
    R = list(struct.unpack_from("<IIII", data, off))
    off += 16
    out = bytearray(out_sz)
    n = len(data)
    mask = TOTFREQ - 1
    for i in range(0, out_sz & ~3, 4):
        for k in range(4):
            m = R[k] & mask
            out[i + k] = ssym[m]
            R[k] = int(sfreq[m]) * (R[k] >> TF_SHIFT) + int(sbase[m])
            while R[k] < RANS_BYTE_L and off < n:
                R[k] = (R[k] << 8) | data[off]
                off += 1
    for k in range(out_sz & 3):
        out[(out_sz & ~3) + k] = ssym[R[k] & mask]
    return bytes(out)


def _rans_decode_o1(data):
    in_sz, out_sz = struct.unpack_from("<II", data, 1)
    off = 9
    # order-1 table: outer context symbol loop with its own +1-RLE
    tables = {}
    rle_i = 0
    i = data[off]
    off += 1
    while True:
        freqs = {}
        rle_j = 0
        j = data[off]
        off += 1
        while True:
            f = data[off]
            off += 1
            if f >= 128:
                f = ((f & 127) << 8) | data[off]
                off += 1
            freqs[j] = f
            if not rle_j and data[off] == j + 1:
                j = data[off]
                rle_j = data[off + 1]
                off += 2
            elif rle_j:
                rle_j -= 1
                j += 1
            else:
                j = data[off]
                off += 1
            if j == 0:
                break
        tables[i] = _rans_tables(freqs, zero_is_total=True)
        if not rle_i and data[off] == i + 1:
            i = data[off]
            rle_i = data[off + 1]
            off += 2
        elif rle_i:
            rle_i -= 1
            i += 1
        else:
            i = data[off]
            off += 1
        if i == 0:
            break

    empty = (np.zeros(TOTFREQ, np.uint8), np.zeros(TOTFREQ, np.uint32),
             np.zeros(TOTFREQ, np.uint32))
    R = list(struct.unpack_from("<IIII", data, off))
    off += 16
    out = bytearray(out_sz)
    n = len(data)
    mask = TOTFREQ - 1
    isz4 = out_sz >> 2
    ctx = [0, 0, 0, 0]
    pos = [0, isz4, 2 * isz4, 3 * isz4]
    for _ in range(isz4):
        for k in range(4):
            ssym, sfreq, sbase = tables.get(ctx[k], empty)
            m = R[k] & mask
            c = int(ssym[m])
            out[pos[k]] = c
            # R = freq * (R>>12) + (R&mask) - start == freq*(R>>12) + sbase[m]
            R[k] = int(sfreq[m]) * (R[k] >> TF_SHIFT) + int(sbase[m])
            while R[k] < RANS_BYTE_L and off < n:
                R[k] = (R[k] << 8) | data[off]
                off += 1
            ctx[k] = c
            pos[k] += 1
    # stream 3 handles the remainder
    k = 3
    while pos[k] < out_sz:
        ssym, sfreq, sbase = tables.get(ctx[k], empty)
        m = R[k] & mask
        c = int(ssym[m])
        out[pos[k]] = c
        R[k] = int(sfreq[m]) * (R[k] >> TF_SHIFT) + int(sbase[m])
        while R[k] < RANS_BYTE_L and off < n:
            R[k] = (R[k] << 8) | data[off]
            off += 1
        ctx[k] = c
        pos[k] += 1
    return bytes(out)


def rans_decode(data):
    if data[0] == 0:
        return _rans_decode_o0(data)
    if data[0] == 1:
        return _rans_decode_o1(data)
    raise ValueError(f"unsupported rANS order {data[0]}")


# ---------------------------------------------------------------------------
# rANS 4x8 order-0 encoder (for the writer)
# ---------------------------------------------------------------------------

def _rans_encode_o0(data):
    n = len(data)
    if n == 0:
        return None
    arr = np.frombuffer(data, np.uint8)
    hist = np.bincount(arr, minlength=256).astype(np.int64)
    total = int(hist.sum())
    # normalize to TOTFREQ
    freqs = {}
    fsum = 0
    m_sym, m_f = 0, 0
    for sym in range(256):
        if hist[sym] == 0:
            continue
        f = max(1, int(hist[sym] * TOTFREQ // total))
        freqs[sym] = f
        fsum += f
        if f > m_f:
            m_f, m_sym = f, sym
    diff = TOTFREQ - fsum
    freqs[m_sym] += diff
    if freqs[m_sym] <= 0:
        return None  # pathological; caller falls back to gzip

    # cumulative starts
    start = {}
    x = 0
    for sym in sorted(freqs):
        start[sym] = x
        x += freqs[sym]

    # frequency table serialization (+1 RLE as in the reader)
    tab = bytearray()
    syms = sorted(freqs)
    rle = 0
    for idx, sym in enumerate(syms):
        if rle:
            rle -= 1
        else:
            tab.append(sym)
            if idx and sym == syms[idx - 1] + 1:
                # count the run of consecutive symbols that follows
                run = 0
                while idx + run + 1 <= len(syms) - 1 and \
                        syms[idx + run + 1] == sym + run + 1:
                    run += 1
                tab.append(run)
                rle = run
        f = freqs[sym]
        if f < 128:
            tab.append(f)
        else:
            tab.append(0x80 | (f >> 8))
            tab.append(f & 0xFF)
    tab.append(0)

    # encode in reverse, 4 interleaved states
    R = [RANS_BYTE_L] * 4
    out_rev = bytearray()
    for i in range(n - 1, -1, -1):
        k = i & 3
        sym = data[i]
        f = freqs[sym]
        # renormalize
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        x = R[k]
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        R[k] = ((x // f) << TF_SHIFT) + (x % f) + start[sym]
    states = b"".join(struct.pack("<I", R[k]) for k in range(4))
    payload = bytes(tab) + states + bytes(reversed(out_rev))
    head = bytes([0]) + struct.pack("<II", len(payload), n)
    return head + payload


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class Block:
    __slots__ = ("method", "ctype", "content_id", "data", "byte", "bit")

    def __init__(self, method, ctype, content_id, data):
        self.method = method
        self.ctype = ctype
        self.content_id = content_id
        self.data = data
        self.byte = 0   # read cursor for external/byte streams
        self.bit = 7    # MSB-first bit cursor (core block)

    # bit reading (core block) ------------------------------------------
    def get_bits(self, n):
        v = 0
        data = self.data
        byte, bit = self.byte, self.bit
        for _ in range(n):
            v = (v << 1) | ((data[byte] >> bit) & 1)
            bit -= 1
            if bit < 0:
                bit = 7
                byte += 1
        self.byte, self.bit = byte, bit
        return v

    def get_bit(self):
        b = (self.data[self.byte] >> self.bit) & 1
        self.bit -= 1
        if self.bit < 0:
            self.bit = 7
            self.byte += 1
        return b


def _uncompress(method, data, raw_size):
    if method == RAW:
        return data
    if method == GZIP:
        return zlib.decompress(data, 15 + 32)
    if method == BZIP2:
        import bz2
        return bz2.decompress(data)
    if method == LZMA:
        import lzma
        return lzma.decompress(data)
    if method == RANS:
        return rans_decode(data)
    if method == RANS_PR:
        from .rans_nx16 import rans16_decode
        return rans16_decode(data)
    if method == TOK3:
        from .rans_nx16 import tok3_decode
        return tok3_decode(data)
    raise ValueError(f"unknown CRAM block compression method {method}")


def read_block(buf, off):
    method = buf[off]
    ctype = buf[off + 1]
    off += 2
    content_id, off = itf8_get(buf, off)
    comp_size, off = itf8_get(buf, off)
    raw_size, off = itf8_get(buf, off)
    data = bytes(buf[off:off + comp_size])
    off += comp_size
    off += 4  # CRC32 (not verified)
    return Block(method, ctype, content_id,
                 _uncompress(method, data, raw_size)), off


# ---------------------------------------------------------------------------
# codecs (decode side)
# ---------------------------------------------------------------------------

class Codec:
    """decode_int(core, ext) -> int; decode_bytes(core, ext) -> bytes."""


class ExternalCodec(Codec):
    def __init__(self, content_id):
        self.content_id = content_id

    def decode_int(self, core, ext):
        b = ext[self.content_id]
        v, b.byte = itf8_get(b.data, b.byte)
        if v >= 1 << 31:
            v -= 1 << 32
        return v

    def decode_byte(self, core, ext):
        b = ext[self.content_id]
        v = b.data[b.byte]
        b.byte += 1
        return v

    def decode_bytes_n(self, core, ext, n):
        b = ext[self.content_id]
        v = b.data[b.byte:b.byte + n]
        b.byte += n
        return v


class HuffmanCodec(Codec):
    def __init__(self, symbols, lengths):
        codes = sorted(zip(lengths, symbols))
        self.codes = []  # (len, code, symbol)
        val = -1
        last_len = 0
        for ln, sym in codes:
            val += 1
            if ln > last_len:
                val <<= (ln - last_len)
                last_len = ln
            self.codes.append((ln, val, sym))
        self.const = self.codes[0][2] if len(self.codes) == 1 and \
            self.codes[0][0] == 0 else None
        # decode table: by (len -> {code: sym})
        self.by_len = {}
        for ln, code, sym in self.codes:
            self.by_len.setdefault(ln, {})[code] = sym
        self.max_len = max(ln for ln, _, _ in self.codes)

    def decode_int(self, core, ext):
        if self.const is not None:
            return self.const
        code = 0
        ln = 0
        while ln <= self.max_len:
            code = (code << 1) | core.get_bit()
            ln += 1
            tab = self.by_len.get(ln)
            if tab is not None and code in tab:
                return tab[code]
        raise ValueError("bad huffman code")

    decode_byte = decode_int


class BetaCodec(Codec):
    def __init__(self, offset, nbits):
        self.offset = offset
        self.nbits = nbits

    def decode_int(self, core, ext):
        if self.nbits == 0:
            return -self.offset
        return core.get_bits(self.nbits) - self.offset

    decode_byte = decode_int


class ByteArrayStopCodec(Codec):
    def __init__(self, stop, content_id):
        self.stop = stop
        self.content_id = content_id

    def decode_bytes(self, core, ext):
        b = ext[self.content_id]
        end = b.data.index(self.stop, b.byte)
        v = b.data[b.byte:end]
        b.byte = end + 1
        return v


class ByteArrayLenCodec(Codec):
    def __init__(self, len_codec, val_codec):
        self.len_codec = len_codec
        self.val_codec = val_codec

    def decode_bytes(self, core, ext):
        n = self.len_codec.decode_int(core, ext)
        if isinstance(self.val_codec, ExternalCodec):
            return self.val_codec.decode_bytes_n(core, ext, n)
        return bytes(self.val_codec.decode_byte(core, ext) for _ in range(n))


def parse_codec(buf, off):
    """Parse one encoding entry: encoding id + size + params."""
    enc, off = itf8_get(buf, off)
    size, off = itf8_get(buf, off)
    end = off + size
    if enc == E_NULL:
        return None, end
    if enc == E_EXTERNAL:
        cid, off = itf8_get(buf, off)
        return ExternalCodec(cid), end
    if enc == E_HUFFMAN:
        ncodes, off = itf8_get(buf, off)
        syms = []
        for _ in range(ncodes):
            v, off = itf8_get_signed(buf, off)
            syms.append(v)
        n2, off = itf8_get(buf, off)
        lens = []
        for _ in range(n2):
            v, off = itf8_get(buf, off)
            lens.append(v)
        return HuffmanCodec(syms, lens), end
    if enc == E_BETA:
        offset, off = itf8_get_signed(buf, off)
        nbits, off = itf8_get(buf, off)
        return BetaCodec(offset, nbits), end
    if enc == E_BYTE_ARRAY_STOP:
        stop = buf[off]
        off += 1
        cid, off = itf8_get(buf, off)
        return ByteArrayStopCodec(stop, cid), end
    if enc == E_BYTE_ARRAY_LEN:
        len_codec, off = parse_codec(buf, off)
        val_codec, off = parse_codec(buf, off)
        return ByteArrayLenCodec(len_codec, val_codec), end
    raise ValueError(f"unsupported CRAM encoding {enc}")


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

class CompressionHeader:
    def __init__(self, data):
        off = 0
        self.read_names_included = False
        self.ap_delta = True
        self.qs_seq_orient = True
        self.no_ref = False
        self.sub_matrix = [list(DEFAULT_SUB_MATRIX[i * 4:i * 4 + 4])
                           for i in range(5)]
        self.tag_dict = []      # TL index -> list of (tag2, type_char)
        self.codecs = {}        # b"XX" -> codec
        self.tag_codecs = {}    # (tag2+type) -> codec

        # preservation map
        _size, off = itf8_get(data, off)
        count, off = itf8_get(data, off)
        for _ in range(count):
            key = bytes(data[off:off + 2])
            off += 2
            if key == b"RN":
                self.read_names_included = bool(data[off]); off += 1
            elif key == b"AP":
                self.ap_delta = bool(data[off]); off += 1
            elif key == b"RR":
                self.no_ref = not data[off]; off += 1
            elif key == b"QO":
                self.qs_seq_orient = bool(data[off]); off += 1
            elif key == b"SM":
                # 5 bytes, 2-bit codes ordering substituted bases
                for r, others in enumerate(("CGTN", "AGTN", "ACTN",
                                            "ACGN", "ACGT")):
                    byte = data[off + r]
                    row = [None] * 4
                    row[(byte >> 6) & 3] = others[0]
                    row[(byte >> 4) & 3] = others[1]
                    row[(byte >> 2) & 3] = others[2]
                    row[byte & 3] = others[3]
                    self.sub_matrix[r] = row
                off += 5
            elif key == b"TD":
                blk_size, off = itf8_get(data, off)
                blob = bytes(data[off:off + blk_size])
                off += blk_size
                for entry in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") \
                        else blob.split(b"\x00"):
                    tags = [(entry[i:i + 2].decode("latin-1"),
                             chr(entry[i + 2])) for i in range(0, len(entry), 3)]
                    self.tag_dict.append(tags)
            else:
                # MI/UI/PI single byte legacy keys
                off += 1

        # record encoding map
        _size, off = itf8_get(data, off)
        count, off = itf8_get(data, off)
        for _ in range(count):
            key = bytes(data[off:off + 2])
            off += 2
            codec, off = parse_codec(data, off)
            if codec is not None:
                self.codecs[key] = codec

        # tag encoding map
        _size, off = itf8_get(data, off)
        count, off = itf8_get(data, off)
        for _ in range(count):
            keyid, off = itf8_get(data, off)
            tag3 = (chr((keyid >> 16) & 0xFF) + chr((keyid >> 8) & 0xFF)
                    + chr(keyid & 0xFF))
            codec, off = parse_codec(data, off)
            self.tag_codecs[tag3] = codec


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Rec:
    __slots__ = ("flags", "cf", "ref_id", "len", "apos", "rg", "name",
                 "mate_flags", "mate_ref_id", "mate_pos", "mate_line",
                 "tlen", "explicit_tlen", "tags", "cigar", "seq", "qual",
                 "mqual", "aend")

    def __init__(self):
        self.flags = 0
        self.cf = 0
        self.ref_id = -1
        self.len = 0
        self.apos = 0
        self.rg = -1
        self.name = b""
        self.mate_flags = 0
        self.mate_ref_id = -1
        self.mate_pos = 0
        self.mate_line = -1
        self.tlen = None          # None == INT64_MIN sentinel
        self.explicit_tlen = None
        self.tags = b""
        self.cigar = []
        self.seq = b""
        self.qual = b""
        self.mqual = 0
        self.aend = 0


class CramReader:
    """BamReader-compatible reader for CRAM 3.x files."""

    def __init__(self, path, fasta=None):
        self._path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        if self._buf[:4] != b"CRAM":
            raise ValueError(f"{path}: not a CRAM file")
        self.major = self._buf[4]
        self.minor = self._buf[5]
        if self.major not in (2, 3):
            raise ValueError(f"unsupported CRAM version {self.major}.{self.minor}")
        self._fasta = fasta          # FastaFile for reference-based decode
        self._ref_cache = {}
        off = 26
        # SAM header container
        hdr_end, blocks, _meta = self._read_container(off)
        hdr_block = blocks[0]
        (hlen,) = struct.unpack_from("<i", hdr_block.data, 0)
        self.header_text = hdr_block.data[4:4 + hlen].decode("latin-1")
        self._data_off = hdr_end
        self._parse_header()

    def _parse_header(self):
        self.references = []
        self.lengths = []
        self.read_groups = []
        for line in self.header_text.split("\n"):
            if line.startswith("@SQ"):
                name = ln = None
                for fldid in line.split("\t")[1:]:
                    if fldid.startswith("SN:"):
                        name = fldid[3:]
                    elif fldid.startswith("LN:"):
                        ln = int(fldid[3:])
                if name is not None:
                    self.references.append(name)
                    self.lengths.append(ln or 0)
            elif line.startswith("@RG"):
                for fldid in line.split("\t")[1:]:
                    if fldid.startswith("ID:"):
                        self.read_groups.append(fldid[3:])
        self.ref_id = {n: i for i, n in enumerate(self.references)}

    def _get_ref(self, tid):
        if tid < 0 or self._fasta is None:
            return None
        if tid not in self._ref_cache:
            name = self.references[tid]
            try:
                self._ref_cache[tid] = self._fasta.fetch(
                    name, 0, self._fasta.index[name][0])
            except Exception:  # noqa: BLE001 — contig absent from FASTA
                self._ref_cache[tid] = None
        return self._ref_cache[tid]

    # -- container plumbing ---------------------------------------------
    def _read_container(self, off):
        buf = self._buf
        (length,) = struct.unpack_from("<i", buf, off)
        off += 4
        ref_seq_id, off = itf8_get_signed(buf, off)
        ref_start, off = itf8_get(buf, off)
        ref_span, off = itf8_get(buf, off)
        num_records, off = itf8_get(buf, off)
        if self.major >= 3:
            rec_counter, off = ltf8_get(buf, off)
        else:
            rec_counter, off = itf8_get(buf, off)
        num_bases, off = ltf8_get(buf, off)
        num_blocks, off = itf8_get(buf, off)
        num_landmarks, off = itf8_get(buf, off)
        for _ in range(num_landmarks):
            _lm, off = itf8_get(buf, off)
        if self.major >= 3:
            off += 4  # crc32
        data_start = off
        blocks = []
        for _ in range(num_blocks):
            b, off = read_block(buf, off)
            blocks.append(b)
        meta = dict(ref_seq_id=ref_seq_id, ref_start=ref_start,
                    ref_span=ref_span, num_records=num_records,
                    length=length, data_start=data_start)
        return off, blocks, meta

    # -- native decode (lps_cram.cpp) -----------------------------------
    def _native_decode(self, offsets=None):
        """Decode via the native library into (blob, rec_off), or None when
        unavailable/unsupported (pure-Python decode takes over)."""
        import os as _os

        if _os.environ.get("LPS_NO_NATIVE_CRAM"):
            return None
        try:
            from .. import native

            fasta_path = getattr(self._fasta, "path", "") or ""
            return native.cram_decode(self._path, fasta_path, offsets)
        except Exception:  # noqa: BLE001 — any native failure: Python path
            return None

    # -- record iteration -----------------------------------------------
    def __iter__(self):
        nat = self._native_decode()
        if nat is not None:
            blob, rec_off = nat
            blob = bytes(blob)  # BamRecord wants a bytes-like with .decode
            for i in range(len(rec_off) - 1):
                yield BamRecord(blob[rec_off[i]:rec_off[i + 1]])
            return
        off = self._data_off
        n = len(self._buf)
        while off < n:
            end, blocks, meta = self._read_container(off)
            off = end
            if meta["num_records"] == 0:
                continue  # EOF container (or empty)
            yield from self._decode_container(blocks, meta)

    def _load_crai(self):
        """Parse the .crai companion once: gzipped text lines
        ref, start, span, container_offset, slice_offset, slice_size."""
        if getattr(self, "_crai_tried", False):
            return self._crai
        self._crai_tried = True
        self._crai = None
        import gzip
        import os
        path = getattr(self, "_path", None)
        if not path or not os.path.exists(path + ".crai"):
            return None
        try:
            by_ref = {}
            with gzip.open(path + ".crai", "rt") as f:
                for line in f:
                    parts = line.split("\t")
                    if len(parts) < 6:
                        continue
                    ref, rstart, span, coff = (int(parts[0]), int(parts[1]),
                                               int(parts[2]), int(parts[3]))
                    by_ref.setdefault(ref, []).append((rstart, span, coff))
            self._crai = by_ref
        except Exception:  # noqa: BLE001 — unreadable index: fall back
            self._crai = None
        return self._crai

    def _iter_containers_at(self, offsets):
        nat = self._native_decode(sorted(set(offsets)))
        if nat is not None:
            blob, rec_off = nat
            blob = bytes(blob)
            for i in range(len(rec_off) - 1):
                yield BamRecord(blob[rec_off[i]:rec_off[i + 1]])
            return
        for off in sorted(set(offsets)):
            _end, blocks, meta = self._read_container(off)
            if meta["num_records"]:
                yield from self._decode_container(blocks, meta)

    def fetch(self, chrom, start=0, end=None):
        tid = self.ref_id[chrom]
        crai = self._load_crai()
        if crai is not None:
            slices = crai.get(tid, [])
            qend = end if end is not None else 1 << 60
            offsets = [coff for rstart, span, coff in slices
                       if rstart <= qend and (span == 0
                                              or rstart + span > start)]
            source = self._iter_containers_at(offsets)
        else:
            source = iter(self)
        for rec in source:
            if rec.tid != tid:
                if rec.tid > tid >= 0 and rec.tid != -1:
                    return
                continue
            if end is not None and rec.pos >= end:
                return
            if start > 0 and rec.ref_end() <= start:
                continue
            yield rec

    def close(self):
        self._buf = b""

    # -- slice decoding --------------------------------------------------
    def _decode_container(self, blocks, meta):
        comp = CompressionHeader(blocks[0].data)
        i = 1
        while i < len(blocks):
            if blocks[i].ctype != CT_SLICE_HEADER:
                i += 1
                continue
            sh = blocks[i]
            # slice header
            data = sh.data
            off = 0
            s_ref_id, off = itf8_get_signed(data, off)
            s_ref_start, off = itf8_get(data, off)
            s_ref_span, off = itf8_get(data, off)
            s_nrec, off = itf8_get(data, off)
            if self.major >= 3:
                _cnt, off = ltf8_get(data, off)
            else:
                _cnt, off = itf8_get(data, off)
            s_nblocks, off = itf8_get(data, off)
            n_ids, off = itf8_get(data, off)
            for _ in range(n_ids):
                _cid, off = itf8_get(data, off)
            _embed_ref, off = itf8_get_signed(data, off)
            sblocks = blocks[i + 1:i + 1 + s_nblocks]
            i += 1 + s_nblocks
            core = next(b for b in sblocks if b.ctype == CT_CORE)
            ext = {b.content_id: b for b in sblocks if b.ctype == CT_EXTERNAL}
            yield from self._decode_slice(comp, core, ext, s_ref_id,
                                          s_ref_start, s_nrec)

    def _decode_slice(self, comp, core, ext, s_ref_id, s_ref_start, nrec):
        cs = comp.codecs

        def dec_int(key, default=None):
            c = cs.get(key)
            if c is None:
                if default is None:
                    raise ValueError(f"missing codec {key}")
                return default
            return c.decode_int(core, ext)

        recs = []
        last_apos = s_ref_start
        for idx in range(nrec):
            r = _Rec()
            r.flags = dec_int(b"BF", 0x4)
            r.cf = dec_int(b"CF", 0)
            if s_ref_id == -2:
                r.ref_id = dec_int(b"RI", -1)
            else:
                r.ref_id = s_ref_id
            r.len = dec_int(b"RL", 0)
            apos = dec_int(b"AP", 0)
            if comp.ap_delta:
                apos += last_apos
            last_apos = apos
            r.apos = apos
            r.rg = dec_int(b"RG", -1)
            if comp.read_names_included and b"RN" in cs:
                r.name = bytes(cs[b"RN"].decode_bytes(core, ext))
            if r.cf & CF_DETACHED:
                r.mate_flags = dec_int(b"MF", 0)
                if not comp.read_names_included and b"RN" in cs:
                    r.name = bytes(cs[b"RN"].decode_bytes(core, ext))
                r.mate_ref_id = dec_int(b"NS", -1)
                r.mate_pos = dec_int(b"NP", 0)
                r.tlen = dec_int(b"TS", 0)
            elif r.cf & CF_DOWNSTREAM:
                nf = dec_int(b"NF", 0)
                r.mate_line = nf + idx + 1
                if r.cf & CF_EXPLICIT_TLEN:
                    r.explicit_tlen = dec_int(b"TS", 0)
            elif r.cf & CF_EXPLICIT_TLEN:
                r.explicit_tlen = dec_int(b"TS", 0)

            # aux tags
            tl = dec_int(b"TL", 0)
            tags = bytearray()
            if 0 <= tl < len(comp.tag_dict):
                for tag2, typ in comp.tag_dict[tl]:
                    codec = comp.tag_codecs.get(tag2 + typ)
                    val = codec.decode_bytes(core, ext) if hasattr(
                        codec, "decode_bytes") else bytes(
                        [codec.decode_byte(core, ext)])
                    tags += tag2.encode("latin-1") + typ.encode("latin-1")
                    tags += bytes(val)
            r.tags = bytes(tags)

            if not (r.flags & BAM_FUNMAP):
                self._decode_seq(comp, core, ext, r)
            else:
                seq = bytearray()
                if b"BA" in cs:
                    ba = cs[b"BA"]
                    if isinstance(ba, ExternalCodec):
                        seq += ba.decode_bytes_n(core, ext, r.len)
                    else:
                        for _ in range(r.len):
                            seq.append(ba.decode_byte(core, ext))
                r.seq = bytes(seq)
                r.aend = r.apos
                if r.cf & CF_QUAL:
                    qs = cs[b"QS"]
                    if isinstance(qs, ExternalCodec):
                        r.qual = bytes(qs.decode_bytes_n(core, ext, r.len))
                    else:
                        r.qual = bytes(qs.decode_byte(core, ext)
                                       for _ in range(r.len))
                else:
                    r.qual = b"\xff" * r.len
            if not comp.qs_seq_orient and (r.flags & BAM_FREVERSE):
                r.qual = r.qual[::-1]
            recs.append(r)

        self._xref(recs)
        for r in recs:
            yield self._to_bam(r)

    def _decode_seq(self, comp, core, ext, r):
        cs = comp.codecs

        def dec_int(key, default=0):
            c = cs.get(key)
            return default if c is None else c.decode_int(core, ext)

        def dec_bytes(key):
            c = cs.get(key)
            if c is None:
                return b""
            if hasattr(c, "decode_bytes"):
                return bytes(c.decode_bytes(core, ext))
            return bytes([c.decode_byte(core, ext)])

        ref = None if comp.no_ref else self._get_ref(r.ref_id)
        seq = bytearray(b"=" * r.len if ref is None else b"\x00" * r.len)
        qual = bytearray(b"\xff" * r.len)
        fn = dec_int(b"FN")
        cigar = []
        cig_op = 0  # M
        cig_len = 0
        seq_pos = 1
        ref_pos = r.apos - 1
        prev_pos = 0
        for _f in range(fn):
            op = chr(cs[b"FC"].decode_byte(core, ext))
            pos = dec_int(b"FP") + prev_pos
            prev_pos = pos
            if pos > seq_pos:
                span = pos - seq_pos
                if ref is not None:
                    seq[seq_pos - 1:pos - 1] = \
                        ref[ref_pos:ref_pos + span].encode("latin-1")
                if cig_len and cig_op != 0:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                cig_op = 0
                cig_len += span
                ref_pos += span
                seq_pos = pos
            if op == "S":
                if cig_len:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                sc = dec_bytes(b"SC")
                seq[pos - 1:pos - 1 + len(sc)] = sc
                cigar.append((4, len(sc)))
                cig_op = 4
                seq_pos += len(sc)
            elif op == "X":
                if cig_len and cig_op != 0:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                base_code = cs[b"BS"].decode_byte(core, ext)
                if ref is None or ref_pos >= len(ref):
                    ref_idx = 4
                else:
                    ref_idx = _BASE_IDX.get(ref[ref_pos], 4)
                seq[pos - 1] = ord(comp.sub_matrix[ref_idx][base_code])
                cig_op = 0
                cig_len += 1
                seq_pos += 1
                ref_pos += 1
            elif op == "D":
                if cig_len and cig_op != 2:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                dl = dec_int(b"DL")
                cig_op = 2
                cig_len += dl
                ref_pos += dl
            elif op == "I":
                if cig_len and cig_op != 1:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                ins = dec_bytes(b"IN")
                seq[pos - 1:pos - 1 + len(ins)] = ins
                cig_op = 1
                cig_len += len(ins)
                seq_pos += len(ins)
            elif op == "i":
                if cig_len and cig_op != 1:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                seq[pos - 1] = cs[b"BA"].decode_byte(core, ext)
                cig_op = 1
                cig_len += 1
                seq_pos += 1
            elif op == "b":
                if cig_len and cig_op != 0:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                bb = dec_bytes(b"BB")
                seq[pos - 1:pos - 1 + len(bb)] = bb
                cig_op = 0
                cig_len += len(bb)
                seq_pos += len(bb)
                ref_pos += len(bb)
            elif op == "q":
                if cig_len and cig_op != 0:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                qq = dec_bytes(b"QQ")
                qual[pos - 1:pos - 1 + len(qq)] = qq
                cig_op = 0
            elif op == "B":
                if cig_len and cig_op != 0:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                seq[pos - 1] = cs[b"BA"].decode_byte(core, ext)
                if b"QS" in cs:
                    qual[pos - 1] = cs[b"QS"].decode_byte(core, ext)
                cig_op = 0
                cig_len += 1
                seq_pos += 1
                ref_pos += 1
            elif op == "Q":
                qual[pos - 1] = cs[b"QS"].decode_byte(core, ext)
            elif op == "H":
                if cig_len and cig_op != 5:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                hc = dec_int(b"HC")
                cig_op = 5
                cig_len += hc
            elif op == "P":
                if cig_len and cig_op != 6:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                pd = dec_int(b"PD")
                cig_op = 6
                cig_len += pd
            elif op == "N":
                if cig_len and cig_op != 3:
                    cigar.append((cig_op, cig_len))
                    cig_len = 0
                rs = dec_int(b"RS")
                cig_op = 3
                cig_len += rs
                ref_pos += rs
            else:
                raise ValueError(f"unknown CRAM feature code {op!r}")

        # implicit trailing match
        if r.len >= seq_pos:
            span = r.len - seq_pos + 1
            if ref is not None:
                seq[seq_pos - 1:r.len] = \
                    ref[ref_pos:ref_pos + span].encode("latin-1")
            ref_pos += span
            if cig_len and cig_op != 0:
                cigar.append((cig_op, cig_len))
                cig_len = 0
            cig_op = 0
            cig_len += span
        if cig_len:
            cigar.append((cig_op, cig_len))
        r.cigar = cigar
        r.aend = max(ref_pos, r.apos)
        r.mqual = dec_int(b"MQ", 40)
        if r.cf & CF_QUAL:
            qs = cs[b"QS"]
            if isinstance(qs, ExternalCodec):
                qual = bytearray(qs.decode_bytes_n(core, ext, r.len))
            else:
                qual = bytearray(qs.decode_byte(core, ext)
                                 for _ in range(r.len))
        if r.cf & CF_NO_SEQ:
            r.len = 0
            seq = bytearray()
            qual = bytearray()
        r.seq = bytes(seq)
        r.qual = bytes(qual)

    def _xref(self, recs):
        """cram_decode_slice_xref semantics (cram_decode.c:2078-2218)."""
        n = len(recs)
        for i, r in enumerate(recs):
            if r.mate_line >= 0 and r.mate_line < n:
                if r.tlen is None:
                    aleft, aright = r.apos, r.aend
                    left_cnt = 0
                    ref = r.ref_id
                    id2 = i
                    while True:
                        if aleft > recs[id2].apos:
                            aleft = recs[id2].apos
                            left_cnt = 1
                        elif aleft == recs[id2].apos:
                            left_cnt += 1
                        if aright < recs[id2].aend:
                            aright = recs[id2].aend
                        if recs[id2].mate_line == -1:
                            recs[id2].mate_line = i
                            break
                        id2 = recs[id2].mate_line
                        if recs[id2].ref_id != ref:
                            ref = -1
                        if id2 == i:
                            break
                    if ref != -1:
                        tlen = aright - aleft + 1
                        chain = [i]
                        id2 = recs[i].mate_line
                        while id2 != i:
                            chain.append(id2)
                            id2 = recs[id2].mate_line
                        for id2 in chain:
                            if recs[id2].apos == aleft and (
                                    left_cnt == 1
                                    or recs[id2].flags & BAM_FREAD1):
                                recs[id2].tlen = tlen
                            else:
                                recs[id2].tlen = -tlen
                    else:
                        id2 = i
                        while True:
                            recs[id2].tlen = 0
                            id2 = recs[id2].mate_line
                            if id2 == i:
                                break
                mate = recs[r.mate_line]
                r.mate_pos = mate.apos
                r.mate_ref_id = mate.ref_id
                r.flags |= BAM_FPAIRED
                if mate.flags & BAM_FUNMAP:
                    r.flags |= BAM_FMUNMAP
                    r.tlen = 0
                if r.flags & BAM_FUNMAP:
                    r.tlen = 0
                if mate.flags & BAM_FREVERSE:
                    r.flags |= BAM_FMREVERSE
                if not r.name:
                    r.name = mate.name
            else:
                if r.mate_flags & MATE_REVERSE:
                    r.flags |= BAM_FPAIRED | BAM_FMREVERSE
                if r.mate_flags & MATE_UNMAP:
                    r.flags |= BAM_FMUNMAP
                if not (r.flags & BAM_FPAIRED):
                    r.mate_ref_id = -1
            if r.tlen is None:
                r.tlen = 0
        for r in recs:
            if r.explicit_tlen is not None:
                r.tlen = r.explicit_tlen

    def _to_bam(self, r):
        name = r.name or b"?"
        l_read_name = len(name) + 1
        n_cigar = len(r.cigar)
        l_seq = len(r.seq)
        end = r.aend if r.aend > r.apos else r.apos
        bam_bin = _reg2bin(r.apos - 1, end if end > r.apos - 1 else r.apos)
        tags = r.tags
        if r.rg >= 0 and r.rg < len(self.read_groups):
            tags = tags + b"RGZ" + \
                self.read_groups[r.rg].encode("latin-1") + b"\x00"
        parts = [struct.pack("<iiBBHHHiiii", r.ref_id, r.apos - 1,
                             l_read_name, r.mqual, bam_bin, n_cigar,
                             r.flags, l_seq, r.mate_ref_id,
                             r.mate_pos - 1, int(r.tlen)),
                 name, b"\x00"]
        for op, ln in r.cigar:
            parts.append(struct.pack("<I", (ln << 4) | op))
        # pack sequence into nibbles (vectorized: ASCII -> nt16 LUT -> pairs)
        codes = _NT16_CODE[np.frombuffer(r.seq, np.uint8)]
        if l_seq % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        nib = (codes[0::2] << 4) | codes[1::2]
        parts.append(nib.tobytes())
        parts.append(r.qual if len(r.qual) == l_seq else b"\xff" * l_seq)
        parts.append(tags)
        return BamRecord(b"".join(parts))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _gzip_block(data):
    try:
        from .. import native
        out = native.gzip_oneshot(data, 6)
        if out is not None:
            return out
    except Exception:  # noqa: BLE001
        pass
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


_RANS_ENCODE_MAX = 1 << 16  # python rANS encoder is per-byte; gzip above this


def _encode_block(method, ctype, content_id, raw):
    """Serialize one block, choosing the smaller of raw/gzip/rans when asked
    for compression (method is the *preferred* method). rANS is only tried
    for small blocks — the pure-Python encoder walks every byte, so large
    payloads (sequence/quality streams) go through zlib's C deflate."""
    data = raw
    used = RAW
    if method != RAW and len(raw) > 0:
        best = raw
        if method == RANS and len(raw) <= _RANS_ENCODE_MAX:
            r = _rans_encode_o0(raw)
            if r is not None and len(r) < len(best):
                best, used = r, RANS
        g = _gzip_block(raw)
        if len(g) < len(best):
            best, used = g, GZIP
        data = best
    out = bytearray()
    out.append(used)
    out.append(ctype)
    out += itf8_put(content_id)
    out += itf8_put(len(data))
    out += itf8_put(len(raw))
    out += data
    out += struct.pack("<I", zlib.crc32(bytes(out)))
    return bytes(out)


def _enc_external(cid):
    params = itf8_put(cid)
    return itf8_put(E_EXTERNAL) + itf8_put(len(params)) + params


def _enc_huffman_const(value):
    params = itf8_put(1) + itf8_put(value) + itf8_put(1) + itf8_put(0)
    return itf8_put(E_HUFFMAN) + itf8_put(len(params)) + params


def _enc_byte_array_stop(stop, cid):
    params = bytes([stop]) + itf8_put(cid)
    return itf8_put(E_BYTE_ARRAY_STOP) + itf8_put(len(params)) + params


def _enc_byte_array_len(len_cid, val_cid):
    inner = _enc_external(len_cid) + _enc_external(val_cid)
    return itf8_put(E_BYTE_ARRAY_LEN) + itf8_put(len(inner)) + inner


def _parse_aux(raw, off):
    """Yield (tag2, type_char, value_bytes) from BAM aux data."""
    n = len(raw)
    out = []
    while off + 3 <= n:
        tag = raw[off:off + 2].decode("latin-1")
        typ = chr(raw[off + 2])
        off += 3
        start = off
        if typ in "cC":
            off += 1
        elif typ in "sS":
            off += 2
        elif typ in "iIf":
            off += 4
        elif typ == "A":
            off += 1
        elif typ in "ZH":
            off = raw.index(0, off) + 1
        elif typ == "B":
            sub = chr(raw[off])
            cnt = struct.unpack_from("<I", raw, off + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            off += 5 + cnt * sz
        else:
            raise ValueError(f"unknown aux type {typ}")
        out.append((tag, typ, bytes(raw[start:off])))
    return out


# content-id assignment for the data series we emit
_SERIES = ["BF", "CF", "RI", "RL", "AP", "MF", "NS", "NP", "TS", "TL",
           "FN", "FC", "FP", "DL", "RS", "PD", "HC", "MQ",
           "BA", "SC", "BB", "IN", "QS"]
_CID = {k: i + 1 for i, k in enumerate(_SERIES)}
for _k in ("SC", "BB", "IN"):
    _CID[_k + "_len"] = len(_CID) + 1
_CID_RN = len(_CID) + 1
_CID_TAG_BASE = _CID_RN + 1


class CramWriter:
    """CRAM 3.0 writer, readable by htslib. API mirrors BamWriter.

    With ``fasta_path`` (native encoder only) sequences are encoded
    reference-based — mismatches as X substitution features against the
    fasta (RR=true) — typically shrinking the file ~5x on long reads.
    Without it every base is stored verbatim via 'b'/'S'/'I' features
    (RR=false); the pure-Python fallback always writes referenceless."""

    RECORDS_PER_CONTAINER = 10000
    BASES_PER_CONTAINER = 32 << 20  # cap container size for long reads

    def __init__(self, path, header_text, references, lengths,
                 fasta_path=None):
        self._path = path
        self._recs = []
        self._bases = 0
        self._cur_tid = None
        self._counter = 0
        self._index = []   # (ref, start, span, cont_off, slice_off, slice_sz)
        # native encoder (lps_cram.cpp): same wire layout, C speed
        self._nw = None
        try:
            from .. import native

            self._nw = native.cram_writer_open(path, header_text,
                                               fasta_path or "")
        except Exception:  # noqa: BLE001 — no native library
            self._nw = None
        if self._nw is not None:
            return
        self._f = open(path, "wb")
        self._f.write(b"CRAM\x03\x00" + path.encode("latin-1")[-20:].ljust(20, b"\x00"))
        hdr = header_text.encode("latin-1")
        blob = struct.pack("<i", len(hdr)) + hdr
        blk = _encode_block(RAW, CT_FILE_HEADER, 0, blob)
        self._write_container([blk], ref_seq_id=0, ref_start=0, ref_span=0,
                              num_records=0, num_bases=0)

    # -- container-level ------------------------------------------------
    def _write_container(self, blocks, ref_seq_id, ref_start, ref_span,
                         num_records, num_bases, landmarks=()):
        cont_off = self._f.tell()
        body = b"".join(blocks)
        head = bytearray()
        head += itf8_put(ref_seq_id if ref_seq_id >= 0 else
                         (ref_seq_id & 0xFFFFFFFF))
        head += itf8_put(ref_start)
        head += itf8_put(ref_span)
        head += itf8_put(num_records)
        head += ltf8_put(self._counter)        # record counter
        head += ltf8_put(num_bases)
        head += itf8_put(len(blocks))
        head += itf8_put(len(landmarks))
        for lm in landmarks:
            head += itf8_put(lm)
        length = struct.pack("<i", len(body))
        crc = zlib.crc32(length)
        crc = zlib.crc32(bytes(head), crc)
        self._f.write(length + bytes(head) + struct.pack("<I", crc) + body)
        return cont_off

    def write(self, rec: BamRecord):
        tid = rec.tid
        if self._recs and (tid != self._cur_tid
                           or len(self._recs) >= self.RECORDS_PER_CONTAINER
                           or self._bases >= self.BASES_PER_CONTAINER):
            self.flush()
        self._cur_tid = tid
        self._bases += rec.l_seq
        self._recs.append(rec.to_bytes())  # includes appended aux tags

    def flush(self):
        if not self._recs:
            return
        tid = self._cur_tid if self._cur_tid is not None else -1
        if self._nw is not None:
            from .. import native

            if not native.cram_writer_container(self._nw, self._recs, tid):
                raise RuntimeError("native CRAM container encode failed")
            self._recs = []
            self._bases = 0
            return
        recs = [BamRecord(r) for r in self._recs]
        self._recs = []
        self._bases = 0
        self._write_data_container(recs, tid)

    def close(self):
        self.flush()
        if self._nw is not None:
            from .. import native

            if not native.cram_writer_close(self._nw):
                raise RuntimeError("native CRAM writer close failed")
            self._nw = None
            return
        self._f.write(EOF_CONTAINER)
        self._f.close()
        # .crai companion index: gzipped text, one line per slice
        crai = "".join(
            f"{ref}\t{start}\t{span}\t{coff}\t{soff}\t{ssz}\n"
            for ref, start, span, coff, soff, ssz in self._index)
        with open(self._path + ".crai", "wb") as f:
            f.write(_gzip_block(crai.encode("ascii")))

    # -- slice encoding --------------------------------------------------
    def _write_data_container(self, recs, tid):
        ext = {k: bytearray() for k in _SERIES}
        rn = bytearray()
        tag_lists = []     # TD entries in first-seen order
        tag_index = {}
        tag_streams = {}   # (tag2+type) -> {"len": ba, "val": ba}
        num_bases = 0

        for r in recs:
            flag = r.flag & 0xFFF
            ext["BF"] += itf8_put(flag)
            ext["CF"] += itf8_put(CF_DETACHED | CF_QUAL)
            ext["RI"] += itf8_put(r.tid & 0xFFFFFFFF)
            l_seq = r.l_seq
            ext["RL"] += itf8_put(l_seq)
            num_bases += l_seq
            ext["AP"] += itf8_put(r.pos + 1)
            rn += r.qname.encode("latin-1") + b"\x00"
            mf = ((MATE_REVERSE if flag & BAM_FMREVERSE else 0)
                  | (MATE_UNMAP if flag & BAM_FMUNMAP else 0))
            ext["MF"] += itf8_put(mf)
            mate_tid, mate_pos, tlen = struct.unpack_from("<iii", r.raw, 20)
            ext["NS"] += itf8_put(mate_tid & 0xFFFFFFFF)
            ext["NP"] += itf8_put((mate_pos + 1) & 0xFFFFFFFF)
            ext["TS"] += itf8_put(tlen & 0xFFFFFFFF)

            # aux tags -> TD entry + per-tag streams
            tags = _parse_aux(r.raw, r._aux_offset())
            key = tuple((t, ty) for t, ty, _v in tags)
            tl = tag_index.get(key)
            if tl is None:
                tl = tag_index[key] = len(tag_lists)
                tag_lists.append(key)
            ext["TL"] += itf8_put(tl)
            for t, ty, val in tags:
                st = tag_streams.setdefault(t + ty, {"len": bytearray(),
                                                     "val": bytearray()})
                st["len"] += itf8_put(len(val))
                st["val"] += val

            seq = r.seq().upper().encode("latin-1")
            qual = bytes((np.minimum(r.qual(), 93)).astype(np.uint8))
            ext["QS"] += qual
            if flag & BAM_FUNMAP:
                ext["BA"] += seq
                continue

            # features covering the whole read (referenceless encoding)
            feats = []           # (op_char, read_pos_1based)
            qpos = 0
            for op, ln in r.cigar_tuples():
                if op in (0, 7, 8):       # M/=/X -> 'b' verbatim bases
                    feats.append(("b", qpos + 1))
                    ext["BB"] += seq[qpos:qpos + ln]
                    qpos += ln
                elif op == 4:             # S
                    feats.append(("S", qpos + 1))
                    ext["SC"] += seq[qpos:qpos + ln]
                    qpos += ln
                elif op == 1:             # I
                    feats.append(("I", qpos + 1))
                    ext["IN"] += seq[qpos:qpos + ln]
                    qpos += ln
                elif op == 2:             # D
                    feats.append(("D", qpos + 1))
                    ext["DL"] += itf8_put(ln)
                elif op == 3:             # N
                    feats.append(("N", qpos + 1))
                    ext["RS"] += itf8_put(ln)
                elif op == 5:             # H
                    feats.append(("H", qpos + 1))
                    ext["HC"] += itf8_put(ln)
                elif op == 6:             # P
                    feats.append(("P", qpos + 1))
                    ext["PD"] += itf8_put(ln)
                else:
                    raise ValueError(f"unsupported CIGAR op {op}")
            ext["FN"] += itf8_put(len(feats))
            prev = 0
            for opch, pos1 in feats:
                ext["FC"] += opch.encode("latin-1")
                ext["FP"] += itf8_put(pos1 - prev)
                prev = pos1
            ext["MQ"] += itf8_put(r.mapq)

        # ---- compression header ----------------------------------------
        pres = bytearray()
        entries = []
        entries.append(b"RN\x01")
        entries.append(b"AP\x00")
        entries.append(b"RR\x00")
        td_blob = bytearray()
        for key in tag_lists:
            for t, ty in key:
                td_blob += t.encode("latin-1") + ty.encode("latin-1")
            td_blob += b"\x00"
        entries.append(b"TD" + itf8_put(len(td_blob)) + bytes(td_blob))
        body = itf8_put(len(entries))
        for e in entries:
            body += e
        pres += itf8_put(len(body)) + body

        # record encoding map
        rec_map = []
        for k in _SERIES:
            if k in ("BA", "SC", "BB", "IN", "QS"):
                continue
            rec_map.append(k.encode("latin-1") + _enc_external(_CID[k]))
        rec_map.append(b"RG" + _enc_huffman_const(-1 & 0xFFFFFFFF))
        rec_map.append(b"RN" + _enc_byte_array_stop(0, _CID_RN))
        for k in ("BA", "QS"):
            rec_map.append(k.encode("latin-1") + _enc_external(_CID[k]))
        for k in ("SC", "BB", "IN"):
            # BYTE_ARRAY_LEN with the length drawn from the same block would
            # desync; give lengths their own implicit stream via FC/CIGAR —
            # instead store as BYTE_ARRAY_LEN(len external, val external)
            rec_map.append(k.encode("latin-1")
                           + _enc_byte_array_len(_CID[k + "_len"], _CID[k]))
        body = itf8_put(len(rec_map))
        for e in rec_map:
            body += e
        rec_blob = itf8_put(len(body)) + body

        # tag encoding map
        tag_map = []
        tag_cids = {}
        next_cid = _CID_TAG_BASE
        for name in sorted(tag_streams):
            len_cid = next_cid
            val_cid = next_cid + 1
            next_cid += 2
            tag_cids[name] = (len_cid, val_cid)
            keyid = (ord(name[0]) << 16) | (ord(name[1]) << 8) | ord(name[2])
            tag_map.append(itf8_put(keyid)
                           + _enc_byte_array_len(len_cid, val_cid))
        body = itf8_put(len(tag_map))
        for e in tag_map:
            body += e
        tag_blob = itf8_put(len(body)) + body

        comp_raw = bytes(pres + rec_blob + tag_blob)
        comp_block = _encode_block(GZIP, CT_COMP_HEADER, 0, comp_raw)

        # ---- external blocks -------------------------------------------
        data_blocks = []
        content_ids = []

        def add_block(cid, payload, prefer=RANS):
            if len(payload) == 0:
                return
            data_blocks.append(_encode_block(prefer, CT_EXTERNAL, cid,
                                             bytes(payload)))
            content_ids.append(cid)

        core = _encode_block(RAW, CT_CORE, 0, b"")
        for k in _SERIES:
            if k in ("SC", "BB", "IN"):
                continue
            add_block(_CID[k], ext[k])
        add_block(_CID_RN, rn, prefer=GZIP)
        for k in ("SC", "BB", "IN"):
            add_block(_CID[k], ext[k])
        for name, st in sorted(tag_streams.items()):
            len_cid, val_cid = tag_cids[name]
            add_block(len_cid, st["len"])
            add_block(val_cid, st["val"])

        # byte-array length streams for SC/BB/IN
        # (lengths were not collected above; rebuild them now)
        # -- they are needed by the BYTE_ARRAY_LEN codecs
        len_streams = {k: bytearray() for k in ("SC", "BB", "IN")}
        for r in recs:
            if r.flag & BAM_FUNMAP:
                continue
            for op, ln in r.cigar_tuples():
                if op in (0, 7, 8):
                    len_streams["BB"] += itf8_put(ln)
                elif op == 4:
                    len_streams["SC"] += itf8_put(ln)
                elif op == 1:
                    len_streams["IN"] += itf8_put(ln)
        for k in ("SC", "BB", "IN"):
            add_block(_CID[k + "_len"], len_streams[k])

        # ---- slice header ----------------------------------------------
        if tid >= 0:
            ref_start = min(r.pos for r in recs) + 1
            ref_end = max(r.ref_end() for r in recs)
            ref_span = max(0, ref_end - ref_start + 1)
        else:
            ref_start = ref_span = 0
        sh = bytearray()
        sh += itf8_put(tid if tid >= 0 else (tid & 0xFFFFFFFF))
        sh += itf8_put(ref_start)
        sh += itf8_put(ref_span)
        sh += itf8_put(len(recs))
        sh += ltf8_put(self._counter)
        sh += itf8_put(len(data_blocks) + 1)  # + core block
        sh += itf8_put(len(content_ids))
        for cid in content_ids:
            sh += itf8_put(cid)
        sh += itf8_put(-1 & 0xFFFFFFFF)       # no embedded reference
        sh += b"\x00" * 16                    # MD5 (unchecked: RR=false)
        slice_hdr_block = _encode_block(RAW, CT_SLICE_HEADER, 0, bytes(sh))

        blocks = [comp_block, slice_hdr_block, core] + data_blocks
        cont_off = self._write_container(
            blocks, ref_seq_id=tid, ref_start=ref_start, ref_span=ref_span,
            num_records=len(recs), num_bases=num_bases,
            landmarks=(len(comp_block),))
        slice_sz = len(slice_hdr_block) + len(core) + \
            sum(len(b) for b in data_blocks)
        self._index.append((tid, ref_start, ref_span, cont_off,
                            len(comp_block), slice_sz))
        self._counter += len(recs)


def is_cram(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == b"CRAM"


def open_alignment(path: str, fasta=None):
    """BamReader for BAM input, CramReader for CRAM input (auto-detected by
    magic, like htslib's sam_open)."""
    if is_cram(path):
        return CramReader(path, fasta=fasta)
    from .bam import BamReader
    return BamReader(path)


def cram_container_index(path: str):
    """Light container scan: (offset, ref_seq_id, num_records) per data
    container, skipping block payloads without decompressing. Feeds the
    container-streaming native handle."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"CRAM":
        raise ValueError("not a CRAM file")
    major = buf[4]
    out = []
    off = 26
    n = len(buf)
    first = True
    while off < n:
        start = off
        (length,) = struct.unpack_from("<i", buf, off)
        off += 4
        ref_seq_id, off = itf8_get_signed(buf, off)
        _rs, off = itf8_get(buf, off)
        _span, off = itf8_get(buf, off)
        num_records, off = itf8_get(buf, off)
        if major >= 3:
            _cnt, off = ltf8_get(buf, off)
        else:
            _cnt, off = itf8_get(buf, off)
        _nb, off = ltf8_get(buf, off)
        num_blocks, off = itf8_get(buf, off)
        num_landmarks, off = itf8_get(buf, off)
        for _ in range(num_landmarks):
            _lm, off = itf8_get(buf, off)
        if major >= 3:
            off += 4  # crc
        for _ in range(num_blocks):
            off += 2  # method, ctype
            _cid, off = itf8_get(buf, off)
            comp_size, off = itf8_get(buf, off)
            _raw, off = itf8_get(buf, off)
            off += comp_size + 4
        if not first and num_records > 0:
            out.append((start, ref_seq_id, num_records))
        first = False
    return out
