// Native CRAM 3.0 decoder: containers -> raw BAM-format record blobs.
//
// C++ port of the decode path of longphase_s_jax/io/cram.py (itself written
// from the hts-specs CRAM 3.0 document; no htslib code). Containers are
// independent, so they decode across a thread pool; the Python CramReader
// wraps the returned blobs as BamRecord objects. Any unsupported feature
// (bzip2/lzma blocks, exotic encodings) aborts the native path and the
// caller falls back to the pure-Python decoder.
//
// Behavioral contract: byte-identical BAM records to io/cram.py's
// _decode_slice/_xref/_to_bam (tested against htslib-written and own-written
// CRAMs in tests/test_cram.py).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>
#include <zlib.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace lps_cram {

struct DecodeError : std::runtime_error {
    explicit DecodeError(const std::string& m) : std::runtime_error(m) {}
};

// --- stage timing (LPS_TIMING=1; same contract as lps_ingest's) -----------
static bool lps_timing() {
    static int v = -1;
    if (v < 0) v = getenv("LPS_TIMING") ? 1 : 0;
    return v == 1;
}

struct PhaseTimer {
    const char* what;
    std::chrono::steady_clock::time_point t0;
    explicit PhaseTimer(const char* w)
        : what(w), t0(std::chrono::steady_clock::now()) {}
    ~PhaseTimer() {
        if (!lps_timing()) return;
        double ms = std::chrono::duration<double, std::milli>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
        fprintf(stderr, "[lps_timing] %s: %.1f ms\n", what, ms);
    }
};

// Cross-thread core-time accumulators (LPS_TIMING=1): decode sub-stage
// split, summed over the container pool and reported by lps_cram_decode.
static std::atomic<int64_t> acc_rans_us{0}, acc_gzip_us{0}, acc_recon_us{0},
    acc_fields_us{0}, acc_tobam_us{0};

struct AccumTimer {
    std::atomic<int64_t>* acc;
    std::chrono::steady_clock::time_point t0;
    explicit AccumTimer(std::atomic<int64_t>& a)
        : acc(lps_timing() ? &a : nullptr),
          t0(acc ? std::chrono::steady_clock::now()
                 : std::chrono::steady_clock::time_point()) {}
    ~AccumTimer() {
        if (!acc) return;
        acc->fetch_add(std::chrono::duration_cast<std::chrono::microseconds>(
                           std::chrono::steady_clock::now() - t0)
                           .count());
    }
};

// Allocator that skips value-initialization (same trick as lps_ingest's
// ByteBuf): to_bam overwrites every byte it resizes into, so the default
// zero-fill is a pure memset tax on the ~GB concatenated blob.
template <typename T>
struct NoInitAllocC {
    using value_type = T;
    NoInitAllocC() = default;
    template <class U>
    NoInitAllocC(const NoInitAllocC<U>&) {}
    T* allocate(size_t n) { return std::allocator<T>().allocate(n); }
    void deallocate(T* p, size_t n) { std::allocator<T>().deallocate(p, n); }
    template <class U>
    void construct(U* p) noexcept {
        ::new (static_cast<void*>(p)) U;
    }
    template <class U, class... Args>
    void construct(U* p, Args&&... args) {
        ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
    }
    template <class U>
    bool operator==(const NoInitAllocC<U>&) const {
        return true;
    }
    template <class U>
    bool operator!=(const NoInitAllocC<U>&) const {
        return false;
    }
};


// ---------------------------------------------------------------------------
// varints
// ---------------------------------------------------------------------------

static inline uint32_t itf8_get(const uint8_t* b, size_t n, size_t& off) {
    if (off >= n) throw DecodeError("itf8 eof");
    uint32_t b0 = b[off];
    if (b0 < 0x80) { off += 1; return b0; }
    if (b0 < 0xC0) { uint32_t v = ((b0 & 0x3F) << 8) | b[off + 1]; off += 2; return v; }
    if (b0 < 0xE0) {
        uint32_t v = ((b0 & 0x1F) << 16) | (uint32_t(b[off + 1]) << 8) | b[off + 2];
        off += 3; return v;
    }
    if (b0 < 0xF0) {
        uint32_t v = ((b0 & 0x0F) << 24) | (uint32_t(b[off + 1]) << 16)
                   | (uint32_t(b[off + 2]) << 8) | b[off + 3];
        off += 4; return v;
    }
    uint32_t v = ((b0 & 0x0F) << 28) | (uint32_t(b[off + 1]) << 20)
               | (uint32_t(b[off + 2]) << 12) | (uint32_t(b[off + 3]) << 4)
               | (b[off + 4] & 0x0F);
    off += 5; return v;
}

static inline int64_t itf8_get_signed(const uint8_t* b, size_t n, size_t& off) {
    int64_t v = itf8_get(b, n, off);
    if (v >= (int64_t(1) << 31)) v -= (int64_t(1) << 32);
    return v;
}

static inline int64_t ltf8_get(const uint8_t* b, size_t n, size_t& off) {
    if (off >= n) throw DecodeError("ltf8 eof");
    uint32_t b0 = b[off];
    int nb = 0;
    while (nb < 8 && ((b0 << nb) & 0x80)) nb++;
    if (nb == 0) { off += 1; return b0; }
    if (nb < 8) {
        int64_t v = b0 & (0xFF >> (nb + 1));
        for (int i = 0; i < nb; i++) v = (v << 8) | b[off + 1 + i];
        off += 1 + nb;
        return v;
    }
    int64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | b[off + 1 + i];
    off += 9;
    return v;
}

// ---------------------------------------------------------------------------
// rANS 4x8 decode (order 0/1); port of io/cram.py:158-319
// ---------------------------------------------------------------------------

static const int TF_SHIFT = 12;
static const int TOTFREQ = 1 << TF_SHIFT;
static const uint32_t RANS_BYTE_L = 1u << 23;

// one interleaved cell per table slot: a single cache line serves the whole
// per-byte decode step (sym + freq + base), instead of three spread arrays
struct RansCell {
    uint16_t freq;
    uint16_t base;
    uint8_t sym;
};

struct RansTable {
    std::vector<RansCell> cell;
    RansTable() : cell(TOTFREQ) {}
};

// freqs as ordered (sym, freq) pairs — insertion order matters for the table
typedef std::vector<std::pair<int, int>> FreqList;

static void read_freqs(const uint8_t* d, size_t n, size_t& off, FreqList& freqs) {
    int rle = 0;
    if (off >= n) throw DecodeError("freqs eof");
    int j = d[off++];
    while (true) {
        if (off >= n) throw DecodeError("freqs eof");
        int f = d[off++];
        if (f >= 128) {
            f = ((f & 127) << 8) | d[off++];
        }
        freqs.emplace_back(j, f);
        if (!rle && off < n && d[off] == j + 1) {
            j = d[off];
            rle = d[off + 1];
            off += 2;
        } else if (rle) {
            rle--;
            j++;
        } else {
            if (off >= n) throw DecodeError("freqs eof");
            j = d[off++];
        }
        if (j == 0) break;
    }
}

static void build_table(const FreqList& freqs, bool zero_is_total, RansTable& t) {
    int x = 0;
    for (auto& sf : freqs) {
        int sym = sf.first, f = sf.second;
        if (f == 0) {
            if (!zero_is_total) continue;
            f = TOTFREQ;
        }
        if (x + f > TOTFREQ) f = TOTFREQ - x;  // clamp malformed tables
        uint16_t fr = (uint16_t)((sf.second == 0) ? TOTFREQ : sf.second);
        for (int i = 0; i < f; i++) {
            t.cell[x + i].sym = (uint8_t)sym;
            t.cell[x + i].freq = fr;
            t.cell[x + i].base = (uint16_t)i;
        }
        x += f;
    }
    if (x == TOTFREQ - 1) {  // historically 4095, not 4096
        t.cell[x].sym = t.cell[x - 1].sym;
        t.cell[x].freq = t.cell[x - 1].freq;
        t.cell[x].base = t.cell[x - 1].base + 1;
    }
}

static void rans_decode_o0(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
    uint32_t out_sz;
    memcpy(&out_sz, d + 5, 4);
    FreqList freqs;
    size_t off = 9;
    read_freqs(d, n, off, freqs);
    RansTable t;
    build_table(freqs, false, t);
    uint32_t R[4];
    memcpy(R, d + off, 16);
    off += 16;
    out.resize(out_sz);
    const uint32_t mask = TOTFREQ - 1;
    const RansCell* cells = t.cell.data();
    size_t main_sz = out_sz & ~size_t(3);
    for (size_t i = 0; i < main_sz; i += 4) {
        for (int k = 0; k < 4; k++) {
            const RansCell& c = cells[R[k] & mask];
            out[i + k] = c.sym;
            R[k] = (uint32_t)c.freq * (R[k] >> TF_SHIFT) + c.base;
            while (R[k] < RANS_BYTE_L && off < n) R[k] = (R[k] << 8) | d[off++];
        }
    }
    for (size_t k = 0; k < (out_sz & 3); k++)
        out[main_sz + k] = cells[R[k] & mask].sym;
}

static void rans_decode_o1(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
    uint32_t out_sz;
    memcpy(&out_sz, d + 5, 4);
    size_t off = 9;
    // order-1: outer context loop with its own +1-RLE. Tables live in a
    // flat 256-slot pointer array — the per-byte context lookup must be a
    // direct index, not a hash probe (this loop runs once per output byte).
    std::vector<std::unique_ptr<RansTable>> tstore;
    const RansCell* tmap[256] = {nullptr};
    int rle_i = 0;
    int i = d[off++];
    while (true) {
        FreqList freqs;
        read_freqs(d, n, off, freqs);
        auto t = std::make_unique<RansTable>();
        build_table(freqs, true, *t);
        tmap[i & 0xff] = t->cell.data();
        tstore.push_back(std::move(t));
        if (!rle_i && off < n && d[off] == i + 1) {
            i = d[off];
            rle_i = d[off + 1];
            off += 2;
        } else if (rle_i) {
            rle_i--;
            i++;
        } else {
            if (off >= n) throw DecodeError("o1 table eof");
            i = d[off++];
        }
        if (i == 0) break;
    }
    static RansTable empty;
    for (int s = 0; s < 256; s++)
        if (!tmap[s]) tmap[s] = empty.cell.data();
    uint32_t R[4];
    memcpy(R, d + off, 16);
    off += 16;
    out.resize(out_sz);
    const uint32_t mask = TOTFREQ - 1;
    size_t isz4 = out_sz >> 2;
    uint8_t ctx[4] = {0, 0, 0, 0};
    size_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
    uint8_t* o = out.data();
    for (size_t it = 0; it < isz4; it++) {
        for (int k = 0; k < 4; k++) {
            const RansCell& c = tmap[ctx[k]][R[k] & mask];
            o[pos[k]] = c.sym;
            R[k] = (uint32_t)c.freq * (R[k] >> TF_SHIFT) + c.base;
            while (R[k] < RANS_BYTE_L && off < n) R[k] = (R[k] << 8) | d[off++];
            ctx[k] = c.sym;
            pos[k]++;
        }
    }
    int k = 3;
    while (pos[k] < out_sz) {
        const RansCell& c = tmap[ctx[k]][R[k] & mask];
        o[pos[k]] = c.sym;
        R[k] = (uint32_t)c.freq * (R[k] >> TF_SHIFT) + c.base;
        while (R[k] < RANS_BYTE_L && off < n) R[k] = (R[k] << 8) | d[off++];
        ctx[k] = c.sym;
        pos[k]++;
    }
}

static void rans_decode(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
    if (n < 9) throw DecodeError("rans short");
    if (d[0] == 0) rans_decode_o0(d, n, out);
    else if (d[0] == 1) rans_decode_o1(d, n, out);
    else throw DecodeError("unsupported rANS order");
}

// ---------------------------------------------------------------------------
// CRAM 3.1 codecs: rANS Nx16 (block method 5) and the tok3 name tokeniser
// (method 8). Same stream layouts as io/rans_nx16.py (the portable Python
// fallback); both are validated against htslib-written 3.1 files via the
// tools/bam2cram31.c interop oracle. 16-bit renormalisation, lower bound
// 2^15; 12-bit order-0 freqs, 12-or-10-bit order-1. The X32 interleave is
// rejected (htslib's CRAM encoder never emits it inside blocks).
// ---------------------------------------------------------------------------

static uint32_t uint7_get(const uint8_t* d, size_t n, size_t& off) {
    uint32_t v = 0;
    while (off < n) {
        uint8_t c = d[off++];
        v = (v << 7) | (c & 0x7f);
        if (!(c & 0x80)) return v;
    }
    throw DecodeError("nx16 uint7 eof");
}

static void nx16_alphabet(const uint8_t* d, size_t n, size_t& off,
                          std::vector<int>& syms) {
    if (off >= n) throw DecodeError("nx16 alphabet eof");
    int rle = 0;
    int j = d[off++];
    while (true) {
        syms.push_back(j);
        if (!rle && off + 1 < n && d[off] == j + 1) {
            j = d[off];
            rle = d[off + 1];
            off += 2;
        } else if (rle) {
            rle--;
            j++;
            if (j > 255) throw DecodeError("nx16 alphabet run");
        } else {
            if (off >= n) throw DecodeError("nx16 alphabet eof");
            j = d[off++];
        }
        if (j == 0) break;
    }
}

static void nx16_norm(std::vector<uint32_t>& freqs, uint32_t total,
                      uint32_t target) {
    if (total == 0 || total == target) return;
    int shift = 0;
    while (total < target) {
        total *= 2;
        shift++;
    }
    for (auto& f : freqs) f <<= shift;
}

// cumulative slot table over [0, 2^precision); built in ascending symbol
// order (the spec iterates contexts/symbols by value)
static void nx16_build(std::vector<std::pair<int, uint32_t>>& sf,
                       int precision, std::vector<RansCell>& cell) {
    uint32_t size = 1u << precision;
    cell.assign(size, RansCell{0, 0, 0});
    std::sort(sf.begin(), sf.end());
    uint32_t x = 0;
    for (auto& p : sf) {
        uint32_t f = p.second;
        if (!f) continue;
        if (f > size - x) throw DecodeError("nx16 freq overflow");
        for (uint32_t y = 0; y < f; y++) {
            cell[x + y].sym = (uint8_t)p.first;
            cell[x + y].freq = (uint16_t)f;
            cell[x + y].base = (uint16_t)y;
        }
        x += f;
    }
    if (x != size) throw DecodeError("nx16 freq total");
}

// order-0 core: freq table + 4 interleaved states, 16-bit renorm; decodes
// exactly out_sz bytes, advancing off past the consumed stream bytes
static void nx16_o0(const uint8_t* d, size_t n, size_t& off, size_t out_sz,
                    uint8_t* out) {
    std::vector<int> syms;
    nx16_alphabet(d, n, off, syms);
    std::vector<std::pair<int, uint32_t>> sf(syms.size());
    uint32_t tot = 0;
    std::vector<uint32_t> freqs(syms.size());
    for (size_t s = 0; s < syms.size(); s++) {
        freqs[s] = uint7_get(d, n, off);
        tot += freqs[s];
    }
    nx16_norm(freqs, tot, 1u << 12);
    for (size_t s = 0; s < syms.size(); s++) sf[s] = {syms[s], freqs[s]};
    std::vector<RansCell> cell;
    nx16_build(sf, 12, cell);
    if (off + 16 > n) throw DecodeError("nx16 states eof");
    uint32_t R[4];
    memcpy(R, d + off, 16);
    off += 16;
    const RansCell* cells = cell.data();
    for (size_t i = 0; i < out_sz; i++) {
        uint32_t& x = R[i & 3];
        const RansCell& c = cells[x & 0xfff];
        out[i] = c.sym;
        x = (uint32_t)c.freq * (x >> 12) + c.base;
        if (x < (1u << 15) && off + 1 < n) {
            x = (x << 16) | d[off] | ((uint32_t)d[off + 1] << 8);
            off += 2;
        }
    }
}

// order-1 core: per-previous-symbol tables (optionally themselves order-0
// compressed), output quarters per state, state 3 finishing the remainder
static void nx16_o1(const uint8_t* d, size_t n, size_t off, size_t out_sz,
                    uint8_t* out) {
    if (off >= n) throw DecodeError("nx16 o1 eof");
    int b0 = d[off];
    int shift = b0 >> 4;
    bool comp = (b0 & 1) != 0;
    off++;
    if (shift < 1 || shift > 12) throw DecodeError("nx16 o1 shift");
    std::vector<uint8_t> tbuf;
    const uint8_t* td = d;
    size_t tn = n, toff = off;
    if (comp) {
        uint32_t u_sz = uint7_get(d, n, off);
        uint32_t c_sz = uint7_get(d, n, off);
        if (off + c_sz > n) throw DecodeError("nx16 o1 table eof");
        tbuf.resize(u_sz);
        size_t so = 0;
        nx16_o0(d + off, c_sz, so, u_sz, tbuf.data());
        td = tbuf.data();
        tn = u_sz;
        toff = 0;
        off += c_sz;
    }
    std::vector<int> present;
    nx16_alphabet(td, tn, toff, present);
    std::sort(present.begin(), present.end());
    present.erase(std::unique(present.begin(), present.end()),
                  present.end());
    std::vector<std::unique_ptr<std::vector<RansCell>>> store;
    const RansCell* tmap[256] = {nullptr};
    for (int i : present) {
        std::vector<std::pair<int, uint32_t>> sf(present.size());
        std::vector<uint32_t> freqs(present.size());
        uint32_t tot = 0;
        int dz = 0;
        for (size_t jj = 0; jj < present.size(); jj++) {
            uint32_t f;
            if (dz) {
                f = 0;
                dz--;
            } else {
                f = uint7_get(td, tn, toff);
                if (f == 0) {
                    if (toff >= tn) throw DecodeError("nx16 o1 dz eof");
                    dz = td[toff++];
                }
            }
            freqs[jj] = f;
            tot += f;
        }
        if (!tot) continue;
        nx16_norm(freqs, tot, 1u << shift);
        for (size_t jj = 0; jj < present.size(); jj++)
            sf[jj] = {present[jj], freqs[jj]};
        auto t = std::make_unique<std::vector<RansCell>>();
        nx16_build(sf, shift, *t);
        tmap[i & 0xff] = t->data();
        store.push_back(std::move(t));
    }
    static std::vector<RansCell> nx16_empty(4096, RansCell{0, 0, 0});
    for (int s = 0; s < 256; s++)
        if (!tmap[s]) tmap[s] = nx16_empty.data();
    if (!comp) off = toff;
    if (off + 16 > n) throw DecodeError("nx16 o1 states eof");
    uint32_t R[4];
    memcpy(R, d + off, 16);
    off += 16;
    const uint32_t mask = (1u << shift) - 1;
    size_t isz4 = out_sz >> 2;
    uint8_t ctx[4] = {0, 0, 0, 0};
    size_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
    for (size_t it = 0; it < isz4; it++) {
        for (int k = 0; k < 4; k++) {
            uint32_t& x = R[k];
            const RansCell& c = tmap[ctx[k]][x & mask];
            out[pos[k]] = c.sym;
            x = (uint32_t)c.freq * (x >> shift) + c.base;
            if (x < (1u << 15) && off + 1 < n) {
                x = (x << 16) | d[off] | ((uint32_t)d[off + 1] << 8);
                off += 2;
            }
            ctx[k] = c.sym;
            pos[k]++;
        }
    }
    int k = 3;
    while (pos[k] < out_sz) {
        uint32_t& x = R[k];
        const RansCell& c = tmap[ctx[k]][x & mask];
        out[pos[k]] = c.sym;
        x = (uint32_t)c.freq * (x >> shift) + c.base;
        if (x < (1u << 15) && off + 1 < n) {
            x = (x << 16) | d[off] | ((uint32_t)d[off + 1] << 8);
            off += 2;
        }
        ctx[k] = c.sym;
        pos[k]++;
    }
}

static void ransnx16_decode(const uint8_t* d, size_t n, int64_t out_hint,
                            std::vector<uint8_t>& out) {
    if (n == 0) throw DecodeError("nx16 empty");
    uint8_t flags = d[0];

    if (flags & 0x08) {  // STRIPE: N rotated sub-streams, NOSZ inside
        size_t off = 1;
        uint32_t ulen = uint7_get(d, n, off);
        if (off >= n) throw DecodeError("nx16 stripe eof");
        unsigned N = d[off++];
        if (N < 1) throw DecodeError("nx16 stripe N");
        std::vector<uint32_t> clen(N);
        for (unsigned i = 0; i < N; i++) clen[i] = uint7_get(d, n, off);
        out.resize(ulen);
        std::vector<uint8_t> sub;
        for (unsigned i = 0; i < N; i++) {
            uint32_t ul = ulen / N + ((ulen % N) > i ? 1 : 0);
            if (off + clen[i] > n) throw DecodeError("nx16 stripe data eof");
            ransnx16_decode(d + off, clen[i], ul, sub);
            if (sub.size() != ul) throw DecodeError("nx16 stripe sub size");
            for (uint32_t l = 0; l < ul; l++) out[i + (size_t)l * N] = sub[l];
            off += clen[i];
        }
        return;
    }

    size_t off = 1;
    bool order1 = (flags & 1) != 0;
    if (flags & 0x04) throw DecodeError("nx16 X32 unsupported");
    uint32_t osz;
    if (flags & 0x10) {  // NOSZ
        if (out_hint < 0) throw DecodeError("nx16 NOSZ without size");
        osz = (uint32_t)out_hint;
    } else {
        osz = uint7_get(d, n, off);
    }
    size_t stage = osz;

    bool do_unpack = false;
    uint8_t pvals[16] = {0};
    int np = 0;
    if (flags & 0x80) {  // PACK
        if (off >= n) throw DecodeError("nx16 pack eof");
        int cnt = d[off];
        if (cnt == 0) cnt = 256;
        if (cnt > 16) {
            off += 1;  // >16 symbols: stored unpacked
        } else {
            np = cnt;
            if (off + 1 + (size_t)cnt > n) throw DecodeError("nx16 pack map");
            memcpy(pvals, d + off + 1, cnt);
            off += 1 + cnt;
            do_unpack = true;
        }
        stage = uint7_get(d, n, off);
    }

    bool do_rle = false;
    std::vector<uint8_t> rmeta;
    const uint8_t* meta_p = nullptr;
    size_t meta_n = 0;
    if (flags & 0x40) {  // RLE
        do_rle = true;
        uint32_t u_meta = uint7_get(d, n, off);
        uint32_t rle_len = uint7_get(d, n, off);
        if (u_meta & 1) {
            meta_n = u_meta / 2;
            if (off + meta_n > n) throw DecodeError("nx16 rle meta eof");
            meta_p = d + off;
            off += meta_n;
        } else {
            uint32_t c_meta = uint7_get(d, n, off);
            if (off + c_meta > n) throw DecodeError("nx16 rle cmeta eof");
            rmeta.resize(u_meta / 2);
            size_t so = 0;
            nx16_o0(d + off, c_meta, so, u_meta / 2, rmeta.data());
            meta_p = rmeta.data();
            meta_n = u_meta / 2;
            off += c_meta;
        }
        stage = rle_len;
    }

    std::vector<uint8_t> tmp(stage);
    if (flags & 0x20) {  // CAT
        if (off + stage > n) throw DecodeError("nx16 cat eof");
        memcpy(tmp.data(), d + off, stage);
    } else if (order1) {
        nx16_o1(d, n, off, stage, tmp.data());
    } else {
        size_t so = off;
        nx16_o0(d, n, so, stage, tmp.data());
    }

    if (do_rle) {
        if (meta_n < 1) throw DecodeError("nx16 rle meta short");
        size_t nsyms = meta_p[0] ? meta_p[0] : 256;
        if (meta_n < 1 + nsyms) throw DecodeError("nx16 rle meta short");
        const uint8_t* run = meta_p + 1 + nsyms;
        size_t run_n = meta_n - (1 + nsyms);
        bool saved[256] = {false};
        for (size_t i = 0; i < nsyms; i++) saved[meta_p[1 + i]] = true;
        std::vector<uint8_t> lit;
        lit.swap(tmp);
        size_t cap = do_unpack ? stage * 8 + 8 : (size_t)osz;
        tmp.reserve(cap < (size_t)osz ? osz : cap);
        size_t roff = 0;
        for (uint8_t b : lit) {
            if (saved[b]) {
                uint32_t rl = uint7_get(run, run_n, roff);
                tmp.insert(tmp.end(), rl + 1, b);
            } else {
                tmp.push_back(b);
            }
            if (tmp.size() > cap) throw DecodeError("nx16 rle overrun");
        }
    }

    if (do_unpack) {
        out.resize(osz);
        const uint8_t* src = tmp.data();
        size_t sn = tmp.size();
        if (np <= 1) {
            memset(out.data(), pvals[0], osz);
        } else if (np <= 2) {
            for (size_t i = 0; i < osz; i++) {
                size_t bi = i >> 3;
                if (bi >= sn) throw DecodeError("nx16 unpack eof");
                out[i] = pvals[(src[bi] >> (i & 7)) & 1];
            }
        } else if (np <= 4) {
            for (size_t i = 0; i < osz; i++) {
                size_t bi = i >> 2;
                if (bi >= sn) throw DecodeError("nx16 unpack eof");
                out[i] = pvals[(src[bi] >> ((i & 3) * 2)) & 3];
            }
        } else {
            for (size_t i = 0; i < osz; i++) {
                size_t bi = i >> 1;
                if (bi >= sn) throw DecodeError("nx16 unpack eof");
                out[i] = pvals[(i & 1) ? (src[bi] >> 4) : (src[bi] & 15)];
            }
        }
    } else {
        out.swap(tmp);
    }
    if (out.size() != osz) throw DecodeError("nx16 size mismatch");
}

// --- tok3 name tokeniser ---------------------------------------------------

enum {
    TK_TYPE = 0, TK_ALPHA, TK_CHAR, TK_DIGITS0, TK_DZLEN, TK_DUP, TK_DIFF,
    TK_DIGITS, TK_DDELTA, TK_DDELTA0, TK_MATCH, TK_NOP, TK_END
};

struct Tok3Tok {
    uint8_t type;
    uint32_t iv;     // integer payload (CHAR byte / DIGITS value)
    uint32_t so, sl; // ALPHA: offset+len into the output stream; DIGITS0: sl=width
};

static void tok3_decode(const uint8_t* d, size_t n,
                        std::vector<uint8_t>& out) {
    if (n < 9) throw DecodeError("tok3 short");
    uint32_t ulen = (uint32_t)d[0] | ((uint32_t)d[1] << 8) |
                    ((uint32_t)d[2] << 16) | ((uint32_t)d[3] << 24);
    uint32_t nreads = (uint32_t)d[4] | ((uint32_t)d[5] << 8) |
                      ((uint32_t)d[6] << 16) | ((uint32_t)d[7] << 24);
    if (d[8]) throw DecodeError("tok3 arith unsupported");
    const int MAXT = 128;
    std::vector<std::vector<uint8_t>> bufs(MAXT << 4);
    std::vector<size_t> pos(MAXT << 4, 0);
    size_t o = 9;
    int tnum = -1;
    while (o < n) {
        uint8_t tt = d[o++];
        if (tt & 64) {  // duplicate of an earlier stream
            if (o + 1 >= n) throw DecodeError("tok3 dup eof");
            int j = (d[o] << 4) + d[o + 1];
            o += 2;
            if (tt & 128) tnum++;
            if (tnum < 0 || tnum >= MAXT) throw DecodeError("tok3 tnum");
            if ((tt & 15) && (tt & 128)) {
                auto& tb = bufs[tnum << 4];
                tb.assign(nreads, (uint8_t)TK_MATCH);
                if (nreads) tb[0] = tt & 15;
            }
            int i = (tnum << 4) | (tt & 15);
            if (j >= i) throw DecodeError("tok3 dup forward");
            bufs[i] = bufs[j];
            continue;
        }
        if (tt & 128) tnum++;
        if (tnum < 0 || tnum >= MAXT) throw DecodeError("tok3 tnum");
        if ((tt & 15) && (tt & 128)) {
            auto& tb = bufs[tnum << 4];
            tb.assign(nreads, (uint8_t)TK_MATCH);
            if (nreads) tb[0] = tt & 15;
        }
        int i = (tnum << 4) | (tt & 15);
        uint32_t clen = uint7_get(d, n, o);
        if (o + clen > n) throw DecodeError("tok3 stream eof");
        ransnx16_decode(d + o, clen, -1, bufs[i]);
        o += clen;
    }

    auto u8 = [&](int id) -> int {
        if (pos[id] >= bufs[id].size()) return -1;
        return bufs[id][pos[id]++];
    };
    auto u32 = [&](int id) -> uint32_t {
        if (pos[id] + 4 > bufs[id].size())
            throw DecodeError("tok3 stream exhausted");
        const uint8_t* p = bufs[id].data() + pos[id];
        pos[id] += 4;
        return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    };

    out.clear();
    out.reserve(ulen + 64);
    std::vector<std::vector<Tok3Tok>> toks;
    std::vector<std::pair<uint32_t, uint32_t>> nm;  // (offset, len) in out
    toks.reserve(nreads);
    char numbuf[24];
    while (pos[0] < bufs[0].size() && nm.size() < nreads) {
        uint32_t cnum = (uint32_t)nm.size();
        int t0 = u8(0);
        if (t0 < 0) break;
        uint32_t dist = u32(t0);
        uint32_t pnum = dist > cnum ? 0 : cnum - dist;
        if (t0 == TK_DUP) {
            if (pnum == cnum) throw DecodeError("tok3 self dup");
            auto prev = nm[pnum];
            uint32_t so = (uint32_t)out.size();
            out.resize(so + prev.second + 1);  // then copy: self-insert
            memcpy(out.data() + so, out.data() + prev.first, prev.second);
            out[so + prev.second] = 0;
            nm.push_back({so, prev.second});
            toks.push_back(toks[pnum]);
            continue;
        }
        uint32_t so = (uint32_t)out.size();
        std::vector<Tok3Tok> tl;
        tl.push_back({TK_TYPE, 0, 0, 0});  // token 0 unused
        for (int ntok = 1; ntok < MAXT; ntok++) {
            int tok = u8(ntok << 4);
            if (tok == TK_CHAR) {
                int c = u8((ntok << 4) | TK_CHAR);
                if (c < 0) throw DecodeError("tok3 char eof");
                out.push_back((uint8_t)c);
                tl.push_back({TK_CHAR, (uint32_t)c, 0, 0});
            } else if (tok == TK_ALPHA) {
                int id = (ntok << 4) | TK_ALPHA;
                uint32_t aso = (uint32_t)out.size();
                int c;
                while ((c = u8(id)) > 0) out.push_back((uint8_t)c);
                tl.push_back({TK_ALPHA, 0, aso,
                              (uint32_t)out.size() - aso});
            } else if (tok == TK_DIGITS0) {
                int vl = u8((ntok << 4) | TK_DZLEN);
                if (vl < 0) throw DecodeError("tok3 dzlen eof");
                uint32_t v = u32((ntok << 4) | TK_DIGITS0);
                int ln = snprintf(numbuf, sizeof numbuf, "%0*u", vl, v);
                out.insert(out.end(), numbuf, numbuf + ln);
                tl.push_back({TK_DIGITS0, v, 0, (uint32_t)vl});
            } else if (tok == TK_DDELTA0) {
                int dv = u8((ntok << 4) | TK_DDELTA0);
                if (dv < 0) throw DecodeError("tok3 ddelta0 eof");
                const Tok3Tok& pt = toks[pnum].at(ntok);
                uint32_t v = pt.iv + (uint32_t)dv;
                int ln = snprintf(numbuf, sizeof numbuf, "%0*u",
                                  (int)pt.sl, v);
                out.insert(out.end(), numbuf, numbuf + ln);
                tl.push_back({TK_DIGITS0, v, 0, pt.sl});
            } else if (tok == TK_DIGITS) {
                uint32_t v = u32((ntok << 4) | TK_DIGITS);
                int ln = snprintf(numbuf, sizeof numbuf, "%u", v);
                out.insert(out.end(), numbuf, numbuf + ln);
                tl.push_back({TK_DIGITS, v, 0, 0});
            } else if (tok == TK_DDELTA) {
                int dv = u8((ntok << 4) | TK_DDELTA);
                if (dv < 0) throw DecodeError("tok3 ddelta eof");
                const Tok3Tok& pt = toks[pnum].at(ntok);
                uint32_t v = pt.iv + (uint32_t)dv;
                int ln = snprintf(numbuf, sizeof numbuf, "%u", v);
                out.insert(out.end(), numbuf, numbuf + ln);
                tl.push_back({TK_DIGITS, v, 0, 0});
            } else if (tok == TK_NOP) {
                tl.push_back({TK_NOP, 0, 0, 0});
            } else if (tok == TK_MATCH) {
                const Tok3Tok& pt = toks[pnum].at(ntok);
                if (pt.type == TK_CHAR) {
                    out.push_back((uint8_t)pt.iv);
                } else if (pt.type == TK_ALPHA) {
                    size_t at = out.size();
                    out.resize(at + pt.sl);  // then copy: self-insert
                    memcpy(out.data() + at, out.data() + pt.so, pt.sl);
                } else if (pt.type == TK_DIGITS) {
                    int ln = snprintf(numbuf, sizeof numbuf, "%u", pt.iv);
                    out.insert(out.end(), numbuf, numbuf + ln);
                } else if (pt.type == TK_DIGITS0) {
                    int ln = snprintf(numbuf, sizeof numbuf, "%0*u",
                                      (int)pt.sl, pt.iv);
                    out.insert(out.end(), numbuf, numbuf + ln);
                } else {
                    throw DecodeError("tok3 bad match");
                }
                Tok3Tok cp = pt;
                if (cp.type == TK_ALPHA) {
                    // re-anchor the string into this name's span
                    cp.so = (uint32_t)out.size() - cp.sl;
                }
                tl.push_back(cp);
            } else {  // TK_END or exhausted type stream (elided END)
                tl.push_back({TK_END, 0, 0, 0});
                break;
            }
        }
        out.push_back(0);
        nm.push_back({so, (uint32_t)out.size() - 1 - so});
        toks.push_back(std::move(tl));
    }
    (void)ulen;
}

// ---------------------------------------------------------------------------
// blocks
// ---------------------------------------------------------------------------

enum { RAW = 0, M_GZIP = 1, M_BZIP2 = 2, M_LZMA = 3, M_RANS = 4,
       M_RANS_PR = 5, M_ARITH = 6, M_FQZ = 7, M_TOK3 = 8 };
enum { CT_FILE_HEADER = 0, CT_COMP_HEADER = 1, CT_SLICE_HEADER = 2,
       CT_EXTERNAL = 4, CT_CORE = 5 };

static void gzip_decompress(const uint8_t* d, size_t n, size_t raw_size,
                            std::vector<uint8_t>& out) {
    out.resize(raw_size);
#ifdef USE_LIBDEFLATE
    if (n >= 2 && d[0] == 0x1f && d[1] == 0x8b) {
        // one decompressor per pool thread, reused across every block
        thread_local struct libdeflate_decompressor* z =
            libdeflate_alloc_decompressor();
        size_t actual = 0;
        auto r = libdeflate_gzip_decompress(z, d, n, out.data(), raw_size, &actual);
        if (r == LIBDEFLATE_SUCCESS) { out.resize(actual); return; }
    }
#endif
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 32) != Z_OK) throw DecodeError("inflateInit");
    zs.next_in = const_cast<uint8_t*>(d);
    zs.avail_in = (uInt)n;
    zs.next_out = out.data();
    zs.avail_out = (uInt)raw_size;
    int r = inflate(&zs, Z_FINISH);
    size_t got = raw_size - zs.avail_out;
    inflateEnd(&zs);
    if (r != Z_STREAM_END && r != Z_OK) throw DecodeError("inflate");
    out.resize(got);
}

struct Block {
    uint8_t method = RAW, ctype = 0;
    int64_t content_id = 0;
    std::vector<uint8_t> data;
    size_t byte = 0;  // external read cursor
    int bit = 7;      // MSB-first bit cursor (core)

    inline int get_bit() {
        if (byte >= data.size()) throw DecodeError("core eof");
        int b = (data[byte] >> bit) & 1;
        if (--bit < 0) { bit = 7; byte++; }
        return b;
    }
    inline uint32_t get_bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)get_bit();
        return v;
    }
};

static size_t read_block(const uint8_t* buf, size_t n, size_t off, Block& b) {
    if (off + 2 > n) throw DecodeError("block eof");
    b.method = buf[off];
    b.ctype = buf[off + 1];
    off += 2;
    b.content_id = itf8_get(buf, n, off);
    uint32_t comp_size = itf8_get(buf, n, off);
    uint32_t raw_size = itf8_get(buf, n, off);
    if (off + comp_size > n) throw DecodeError("block data eof");
    const uint8_t* d = buf + off;
    off += comp_size;
    off += 4;  // CRC32 (not verified; parity with Python reader)
    switch (b.method) {
        case RAW: b.data.assign(d, d + comp_size); break;
        case M_GZIP: {
            AccumTimer at(acc_gzip_us);
            gzip_decompress(d, comp_size, raw_size, b.data);
            break;
        }
        case M_RANS: {
            AccumTimer at(acc_rans_us);
            rans_decode(d, comp_size, b.data);
            break;
        }
        case M_RANS_PR: {  // CRAM 3.1 rANS Nx16
            AccumTimer at(acc_rans_us);
            ransnx16_decode(d, comp_size, raw_size, b.data);
            break;
        }
        case M_TOK3: {  // CRAM 3.1 name tokeniser
            AccumTimer at(acc_rans_us);
            tok3_decode(d, comp_size, b.data);
            break;
        }
        default: throw DecodeError("unsupported block method");  // bzip2/lzma
    }
    return off;
}

// ---------------------------------------------------------------------------
// codecs
// ---------------------------------------------------------------------------

enum { E_NULL = 0, E_EXTERNAL = 1, E_HUFFMAN = 3, E_BYTE_ARRAY_LEN = 4,
       E_BYTE_ARRAY_STOP = 5, E_BETA = 6 };

typedef std::unordered_map<int64_t, Block*> ExtMap;

struct Codec {
    int kind = E_NULL;
    // external / byte-array-stop
    int64_t content_id = 0;
    uint8_t stop = 0;
    // huffman
    bool is_const = false;
    int64_t const_val = 0;
    int max_len = 0;
    std::vector<std::unordered_map<uint32_t, int64_t>> by_len;  // [len]
    // beta
    int64_t offset = 0;
    int nbits = 0;
    // byte-array-len
    std::unique_ptr<Codec> len_codec, val_codec;

    static Block& eblk(ExtMap& ext, int64_t cid) {
        auto it = ext.find(cid);
        if (it == ext.end()) throw DecodeError("missing external block");
        return *it->second;
    }

    int64_t decode_int(Block& core, ExtMap& ext) const {
        switch (kind) {
            case E_EXTERNAL: {
                Block& b = eblk(ext, content_id);
                int64_t v = itf8_get(b.data.data(), b.data.size(), b.byte);
                if (v >= (int64_t(1) << 31)) v -= (int64_t(1) << 32);
                return v;
            }
            case E_HUFFMAN: {
                if (is_const) return const_val;
                uint32_t code = 0;
                for (int ln = 1; ln <= max_len; ln++) {
                    code = (code << 1) | (uint32_t)core.get_bit();
                    if (ln < (int)by_len.size()) {
                        auto& tab = by_len[ln];
                        auto it = tab.find(code);
                        if (it != tab.end()) return it->second;
                    }
                }
                throw DecodeError("bad huffman code");
            }
            case E_BETA:
                if (nbits == 0) return -offset;
                return (int64_t)core.get_bits(nbits) - offset;
            default:
                throw DecodeError("decode_int on non-int codec");
        }
    }

    uint8_t decode_byte(Block& core, ExtMap& ext) const {
        if (kind == E_EXTERNAL) {
            Block& b = eblk(ext, content_id);
            if (b.byte >= b.data.size()) throw DecodeError("external eof");
            return b.data[b.byte++];
        }
        return (uint8_t)decode_int(core, ext);
    }

    // byte-array decode (BYTE_ARRAY_STOP / BYTE_ARRAY_LEN)
    bool has_bytes() const {
        return kind == E_BYTE_ARRAY_STOP || kind == E_BYTE_ARRAY_LEN;
    }
    void decode_bytes(Block& core, ExtMap& ext, std::vector<uint8_t>& out) const {
        out.clear();
        if (kind == E_BYTE_ARRAY_STOP) {
            Block& b = eblk(ext, content_id);
            size_t e = b.byte;
            while (e < b.data.size() && b.data[e] != stop) e++;
            if (e >= b.data.size()) throw DecodeError("missing stop byte");
            out.assign(b.data.begin() + b.byte, b.data.begin() + e);
            b.byte = e + 1;
            return;
        }
        if (kind == E_BYTE_ARRAY_LEN) {
            int64_t nv = len_codec->decode_int(core, ext);
            if (nv < 0) throw DecodeError("negative byte array length");
            if (val_codec->kind == E_EXTERNAL) {
                Block& b = eblk(ext, val_codec->content_id);
                if (b.byte + (size_t)nv > b.data.size())
                    throw DecodeError("external eof");
                out.assign(b.data.begin() + b.byte, b.data.begin() + b.byte + nv);
                b.byte += nv;
            } else {
                out.resize(nv);
                for (int64_t i = 0; i < nv; i++)
                    out[i] = val_codec->decode_byte(core, ext);
            }
            return;
        }
        throw DecodeError("decode_bytes on non-bytes codec");
    }
    void decode_bytes_n(Block& core, ExtMap& ext, size_t nv,
                        std::vector<uint8_t>& out) const {
        if (kind == E_EXTERNAL) {
            Block& b = eblk(ext, content_id);
            size_t take = std::min(nv, b.data.size() - b.byte);
            out.assign(b.data.begin() + b.byte, b.data.begin() + b.byte + take);
            b.byte += take;
            return;
        }
        out.resize(nv);
        for (size_t i = 0; i < nv; i++) out[i] = decode_byte(core, ext);
    }

    // Fast path for the dominant feature shapes (BYTE_ARRAY_STOP /
    // BYTE_ARRAY_LEN over an external byte stream): one memcpy straight
    // into the caller's destination, no tmp-vector round trip. Consumes
    // the full run from the stream, writes at most `cap` bytes (the same
    // clipping as the per-byte loops it replaces), and returns the run
    // length. Returns -1 when the codec shape needs the general path.
    int64_t decode_bytes_into(Block& core, ExtMap& ext, uint8_t* dst,
                              size_t cap) const {
        if (kind == E_BYTE_ARRAY_STOP) {
            Block& b = eblk(ext, content_id);
            const uint8_t* base = b.data.data();
            const uint8_t* hit = (const uint8_t*)memchr(
                base + b.byte, stop, b.data.size() - b.byte);
            if (!hit) throw DecodeError("missing stop byte");
            size_t len = (size_t)(hit - (base + b.byte));
            memcpy(dst, base + b.byte, std::min(len, cap));
            b.byte += len + 1;
            return (int64_t)len;
        }
        if (kind == E_BYTE_ARRAY_LEN && val_codec->kind == E_EXTERNAL) {
            int64_t nv = len_codec->decode_int(core, ext);
            if (nv < 0) throw DecodeError("negative byte array length");
            Block& b = eblk(ext, val_codec->content_id);
            if (b.byte + (size_t)nv > b.data.size())
                throw DecodeError("external eof");
            memcpy(dst, b.data.data() + b.byte, std::min((size_t)nv, cap));
            b.byte += (size_t)nv;
            return nv;
        }
        return -1;
    }
};

static std::unique_ptr<Codec> parse_codec(const uint8_t* buf, size_t n, size_t& off) {
    int64_t enc = itf8_get(buf, n, off);
    uint32_t size = itf8_get(buf, n, off);
    size_t end = off + size;
    auto c = std::make_unique<Codec>();
    switch (enc) {
        case E_NULL:
            off = end;
            return nullptr;
        case E_EXTERNAL:
            c->kind = E_EXTERNAL;
            c->content_id = itf8_get(buf, n, off);
            break;
        case E_HUFFMAN: {
            c->kind = E_HUFFMAN;
            uint32_t ncodes = itf8_get(buf, n, off);
            std::vector<int64_t> syms(ncodes);
            for (uint32_t i = 0; i < ncodes; i++)
                syms[i] = itf8_get_signed(buf, n, off);
            uint32_t n2 = itf8_get(buf, n, off);
            std::vector<int> lens(n2);
            for (uint32_t i = 0; i < n2; i++) lens[i] = (int)itf8_get(buf, n, off);
            // canonical code assignment, sorted by (len, sym)
            std::vector<std::pair<int, int64_t>> pairs;
            for (uint32_t i = 0; i < ncodes && i < n2; i++)
                pairs.emplace_back(lens[i], syms[i]);
            std::sort(pairs.begin(), pairs.end());
            if (pairs.size() == 1 && pairs[0].first == 0) {
                c->is_const = true;
                c->const_val = pairs[0].second;
                break;
            }
            int64_t val = -1;
            int last_len = 0;
            c->max_len = 0;
            for (auto& p : pairs) c->max_len = std::max(c->max_len, p.first);
            c->by_len.resize(c->max_len + 1);
            for (auto& p : pairs) {
                val += 1;
                if (p.first > last_len) {
                    val <<= (p.first - last_len);
                    last_len = p.first;
                }
                c->by_len[p.first][(uint32_t)val] = p.second;
            }
            break;
        }
        case E_BETA:
            c->kind = E_BETA;
            c->offset = itf8_get_signed(buf, n, off);
            c->nbits = (int)itf8_get(buf, n, off);
            break;
        case E_BYTE_ARRAY_STOP:
            c->kind = E_BYTE_ARRAY_STOP;
            c->stop = buf[off++];
            c->content_id = itf8_get(buf, n, off);
            break;
        case E_BYTE_ARRAY_LEN:
            c->kind = E_BYTE_ARRAY_LEN;
            c->len_codec = parse_codec(buf, n, off);
            c->val_codec = parse_codec(buf, n, off);
            if (!c->len_codec || !c->val_codec)
                throw DecodeError("null sub-codec");
            break;
        default:
            throw DecodeError("unsupported encoding");
    }
    off = end;
    return c;
}

// ---------------------------------------------------------------------------
// compression header
// ---------------------------------------------------------------------------

static const char* DEFAULT_SUB = "CGTNAGTNACTNACGNACGT";

struct TagDef { char tag2[2]; char typ; };

struct CompHeader {
    bool read_names_included = false;
    bool ap_delta = true;
    bool qs_seq_orient = true;
    bool no_ref = false;
    char sub_matrix[5][4];
    std::vector<std::vector<TagDef>> tag_dict;
    std::unordered_map<uint16_t, std::unique_ptr<Codec>> codecs;  // "XX" key
    std::unordered_map<uint32_t, std::unique_ptr<Codec>> tag_codecs;  // 3-byte

    const Codec* get(const char* key) const {
        uint16_t k = (uint16_t(key[0]) << 8) | uint8_t(key[1]);
        auto it = codecs.find(k);
        return it == codecs.end() ? nullptr : it->second.get();
    }
};

static void parse_comp_header(const std::vector<uint8_t>& blob, CompHeader& h) {
    const uint8_t* data = blob.data();
    size_t n = blob.size(), off = 0;
    for (int r = 0; r < 5; r++)
        for (int c = 0; c < 4; c++) h.sub_matrix[r][c] = DEFAULT_SUB[r * 4 + c];

    // preservation map
    itf8_get(data, n, off);  // size
    uint32_t count = itf8_get(data, n, off);
    for (uint32_t i = 0; i < count; i++) {
        char k0 = (char)data[off], k1 = (char)data[off + 1];
        off += 2;
        if (k0 == 'R' && k1 == 'N') { h.read_names_included = data[off++] != 0; }
        else if (k0 == 'A' && k1 == 'P') { h.ap_delta = data[off++] != 0; }
        else if (k0 == 'R' && k1 == 'R') { h.no_ref = data[off++] == 0; }
        else if (k0 == 'Q' && k1 == 'O') { h.qs_seq_orient = data[off++] != 0; }
        else if (k0 == 'S' && k1 == 'M') {
            static const char* OTHERS[5] = {"CGTN", "AGTN", "ACTN", "ACGN", "ACGT"};
            for (int r = 0; r < 5; r++) {
                uint8_t byte = data[off + r];
                h.sub_matrix[r][(byte >> 6) & 3] = OTHERS[r][0];
                h.sub_matrix[r][(byte >> 4) & 3] = OTHERS[r][1];
                h.sub_matrix[r][(byte >> 2) & 3] = OTHERS[r][2];
                h.sub_matrix[r][byte & 3] = OTHERS[r][3];
            }
            off += 5;
        } else if (k0 == 'T' && k1 == 'D') {
            uint32_t blk_size = itf8_get(data, n, off);
            const uint8_t* blob2 = data + off;
            off += blk_size;
            // entries separated by \0; trailing \0 does not open a new entry
            size_t start = 0;
            for (size_t p = 0; p <= blk_size; p++) {
                if (p == blk_size || blob2[p] == 0) {
                    if (p == blk_size && start == p) break;
                    std::vector<TagDef> tags;
                    for (size_t q = start; q + 2 < p; q += 3) {
                        TagDef t;
                        t.tag2[0] = (char)blob2[q];
                        t.tag2[1] = (char)blob2[q + 1];
                        t.typ = (char)blob2[q + 2];
                        tags.push_back(t);
                    }
                    h.tag_dict.push_back(std::move(tags));
                    start = p + 1;
                    if (p == blk_size) break;
                }
            }
            // Python: blob.split(b"\0")[:-1] when trailing \0 — the loop above
            // matches (no empty trailing entry)
        } else {
            off += 1;  // MI/UI/PI single-byte legacy keys
        }
    }

    // record encoding map
    itf8_get(data, n, off);
    count = itf8_get(data, n, off);
    for (uint32_t i = 0; i < count; i++) {
        uint16_t key = (uint16_t(data[off]) << 8) | data[off + 1];
        off += 2;
        auto codec = parse_codec(data, n, off);
        if (codec) h.codecs[key] = std::move(codec);
    }

    // tag encoding map
    itf8_get(data, n, off);
    count = itf8_get(data, n, off);
    for (uint32_t i = 0; i < count; i++) {
        uint32_t keyid = itf8_get(data, n, off);
        auto codec = parse_codec(data, n, off);
        if (codec) h.tag_codecs[keyid] = std::move(codec);
    }
}

// ---------------------------------------------------------------------------
// FASTA (.fai-indexed) reference provider
// ---------------------------------------------------------------------------

struct FastaRef {
    struct Entry { int64_t length, offset, linebases, linewidth; };
    std::string path;
    std::vector<std::string> names;                 // tid order from SAM header
    std::unordered_map<std::string, Entry> index;   // from .fai
    std::unordered_map<int, std::shared_ptr<std::string>> cache;
    std::mutex mu;
    bool usable = false;

    void load_fai(const std::string& fasta_path) {
        path = fasta_path;
        FILE* f = fopen((fasta_path + ".fai").c_str(), "rb");
        if (!f) return;
        char line[4096];
        while (fgets(line, sizeof(line), f)) {
            char name[2048];
            long long len, off, lb, lw;
            if (sscanf(line, "%2047s\t%lld\t%lld\t%lld\t%lld",
                       name, &len, &off, &lb, &lw) == 5)
                index[name] = Entry{len, off, lb, lw};
        }
        fclose(f);
        usable = true;
    }

    // full contig sequence, bytes exactly as FastaFile.fetch (no case change)
    std::shared_ptr<std::string> get(int tid) {
        if (tid < 0 || !usable || tid >= (int)names.size()) return nullptr;
        std::lock_guard<std::mutex> g(mu);
        auto it = cache.find(tid);
        if (it != cache.end()) return it->second;
        auto idx = index.find(names[tid]);
        if (idx == index.end()) { cache[tid] = nullptr; return nullptr; }
        const Entry& e = idx->second;
        auto seq = std::make_shared<std::string>();
        seq->reserve(e.length);
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) { cache[tid] = nullptr; return nullptr; }
        // bytes on disk covering `length` bases
        int64_t full_lines = e.length / e.linebases;
        int64_t rem = e.length % e.linebases;
        int64_t span = full_lines * e.linewidth + rem;
        std::vector<char> raw(span);
        fseek(f, (long)e.offset, SEEK_SET);
        size_t got = fread(raw.data(), 1, span, f);
        fclose(f);
        for (size_t i = 0; i < got; i++) {
            char c = raw[i];
            if (c != '\n' && c != '\r') seq->push_back(c);
        }
        auto sp = std::shared_ptr<std::string>(seq);
        cache[tid] = sp;
        return sp;
    }

    // like get(), but drops every other contig from the cache first.
    // Writers flush containers per tid, so only the active contig needs to
    // stay resident; without eviction a WGS reference-based write would
    // accumulate ~3 GB of reference sequence over the writer's lifetime.
    std::shared_ptr<std::string> get_only(int tid) {
        {
            std::lock_guard<std::mutex> g(mu);
            for (auto it = cache.begin(); it != cache.end();)
                if (it->first == tid) ++it;
                else it = cache.erase(it);
        }
        return get(tid);
    }
};

// ---------------------------------------------------------------------------
// record decode
// ---------------------------------------------------------------------------

// CRAM record flags
enum { CF_QUAL = 1, CF_DETACHED = 2, CF_DOWNSTREAM = 4, CF_NO_SEQ = 8,
       CF_EXPLICIT_TLEN = 16 };
enum { MATE_REVERSE = 1, MATE_UNMAP = 2 };
enum { BAM_FPAIRED = 0x1, BAM_FUNMAP = 0x4, BAM_FMUNMAP = 0x8,
       BAM_FREVERSE = 0x10, BAM_FMREVERSE = 0x20, BAM_FREAD1 = 0x40 };

static const int64_t TLEN_NONE = INT64_MIN;

struct Rec {
    int32_t flags = 0, cf = 0;
    int32_t ref_id = -1;
    int64_t len = 0, apos = 0;
    int32_t rg = -1;
    std::vector<uint8_t> name;
    int32_t mate_flags = 0, mate_ref_id = -1;
    int64_t mate_pos = 0;
    int64_t mate_line = -1;
    int64_t tlen = TLEN_NONE;
    int64_t explicit_tlen = TLEN_NONE;
    bool has_explicit_tlen = false;
    std::vector<uint8_t> tags;
    std::vector<std::pair<int, int64_t>> cigar;  // (op, len)
    std::vector<uint8_t> seq, qual;
    int32_t mqual = 0;
    int64_t aend = 0;
};

static const int BASE_IDX[256] = {
    // A=0 C=1 G=2 T=3 N=4, lowercase same; everything else 4
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
};

static void decode_seq(const CompHeader& comp, Block& core, ExtMap& ext,
                       Rec& r, const std::string* ref) {
    auto dec_int = [&](const char* key, int64_t def) -> int64_t {
        const Codec* c = comp.get(key);
        return c ? c->decode_int(core, ext) : def;
    };
    std::vector<uint8_t> tmp;
    // Decode a byte run for feature `key` directly into seq/qual at
    // dst_off (memcpy fast path; general codec shapes fall back to the
    // per-byte clipped copy this replaces). Returns the run length.
    auto dec_run_into = [&](const char* key, size_t dst_off,
                            bool into_qual) -> int64_t {
        const Codec* c = comp.get(key);
        if (!c) return 0;
        std::vector<uint8_t>& arr = into_qual ? r.qual : r.seq;
        size_t lim = arr.size();
        size_t safe_off = dst_off < lim ? dst_off : lim;
        if (c->has_bytes()) {
            int64_t n = c->decode_bytes_into(core, ext, arr.data() + safe_off,
                                             lim - safe_off);
            if (n >= 0) return n;
            c->decode_bytes(core, ext, tmp);
        } else {
            tmp.clear();
            tmp.push_back(c->decode_byte(core, ext));
        }
        for (size_t i = 0; i < tmp.size(); i++)
            if (dst_off + i < lim) arr[dst_off + i] = tmp[i];
        return (int64_t)tmp.size();
    };

    if (!comp.no_ref && ref == nullptr) {
        // reference-based record without a reference sequence
        // (Python fills from a None ref silently producing '='-bases only
        //  when no_ref; here a missing contig means garbage — match Python:
        //  ref None -> '=' fill)
    }
    bool use_ref = !comp.no_ref && ref != nullptr;
    r.seq.assign(r.len, use_ref ? 0 : '=');
    r.qual.assign(r.len, 0xff);
    int64_t fn = dec_int("FN", 0);
    int cig_op = 0;
    int64_t cig_len = 0;
    int64_t seq_pos = 1;
    int64_t ref_pos = r.apos - 1;
    int64_t prev_pos = 0;
    size_t ref_len = use_ref ? ref->size() : 0;

    auto copy_ref = [&](int64_t dst, int64_t src, int64_t span) {
        if (!use_ref) return;
        // common case: the whole span is in range — one memcpy
        if (src >= 0 && dst >= 0 && src + span <= (int64_t)ref_len &&
            dst + span <= (int64_t)r.seq.size()) {
            memcpy(r.seq.data() + dst, ref->data() + src, (size_t)span);
            return;
        }
        for (int64_t i = 0; i < span; i++) {
            int64_t s = src + i, d = dst + i;
            if (s >= 0 && (size_t)s < ref_len && d >= 0 && d < (int64_t)r.seq.size())
                r.seq[d] = (uint8_t)(*ref)[s];
        }
    };
    auto flush_if = [&](int keep_op) {
        if (cig_len && cig_op != keep_op) {
            r.cigar.emplace_back(cig_op, cig_len);
            cig_len = 0;
        }
    };

    const Codec* FC = comp.get("FC");
    const Codec* FPc = comp.get("FP");
    const Codec* BSc = comp.get("BS");
    // direct stream pointers for the dominant all-external feature codecs:
    // the generic path pays three hash lookups per feature, which at
    // reference-based mismatch densities (hundreds of X features per long
    // read) dominates the whole container decode
    auto ext_blk = [&](const Codec* c) -> Block* {
        if (!c || c->kind != E_EXTERNAL) return nullptr;
        auto it = ext.find(c->content_id);
        return it == ext.end() ? nullptr : it->second;
    };
    Block* fcb = ext_blk(FC);
    Block* fpb = ext_blk(FPc);
    Block* bsb = ext_blk(BSc);
    for (int64_t fi = 0; fi < fn; fi++) {
        if (!FC) throw DecodeError("missing FC");
        char op;
        if (fcb) {
            if (fcb->byte >= fcb->data.size())
                throw DecodeError("external eof");
            op = (char)fcb->data[fcb->byte++];
        } else {
            op = (char)FC->decode_byte(core, ext);
        }
        int64_t pos = (fpb ? itf8_get_signed(fpb->data.data(),
                                             fpb->data.size(), fpb->byte)
                           : dec_int("FP", 0)) + prev_pos;
        prev_pos = pos;
        if (pos > seq_pos) {
            int64_t span = pos - seq_pos;
            copy_ref(seq_pos - 1, ref_pos, span);
            flush_if(0);
            cig_op = 0;
            cig_len += span;
            ref_pos += span;
            seq_pos = pos;
        }
        switch (op) {
            case 'S': {
                if (cig_len) { r.cigar.emplace_back(cig_op, cig_len); cig_len = 0; }
                int64_t nsc = dec_run_into("SC", (size_t)(pos - 1), false);
                r.cigar.emplace_back(4, nsc);
                cig_op = 4;
                seq_pos += nsc;
                break;
            }
            case 'X': {
                flush_if(0);
                if (!BSc) throw DecodeError("missing BS");
                int base_code;
                if (bsb) {
                    if (bsb->byte >= bsb->data.size())
                        throw DecodeError("external eof");
                    base_code = bsb->data[bsb->byte++];
                } else {
                    base_code = BSc->decode_byte(core, ext);
                }
                int ref_idx = 4;
                if (use_ref && ref_pos < (int64_t)ref_len && ref_pos >= 0)
                    ref_idx = BASE_IDX[(uint8_t)(*ref)[ref_pos]];
                if (base_code < 0 || base_code > 3)
                    throw DecodeError("bad BS code");
                if (pos - 1 < (int64_t)r.seq.size())
                    r.seq[pos - 1] = (uint8_t)comp.sub_matrix[ref_idx][base_code];
                cig_op = 0;
                cig_len += 1;
                seq_pos += 1;
                ref_pos += 1;
                break;
            }
            case 'D': {
                flush_if(2);
                int64_t dl = dec_int("DL", 0);
                cig_op = 2;
                cig_len += dl;
                ref_pos += dl;
                break;
            }
            case 'I': {
                flush_if(1);
                int64_t nin = dec_run_into("IN", (size_t)(pos - 1), false);
                cig_op = 1;
                cig_len += nin;
                seq_pos += nin;
                break;
            }
            case 'i': {
                flush_if(1);
                const Codec* BA = comp.get("BA");
                if (!BA) throw DecodeError("missing BA");
                if (pos - 1 < (int64_t)r.seq.size())
                    r.seq[pos - 1] = BA->decode_byte(core, ext);
                cig_op = 1;
                cig_len += 1;
                seq_pos += 1;
                break;
            }
            case 'b': {
                flush_if(0);
                int64_t nbb = dec_run_into("BB", (size_t)(pos - 1), false);
                cig_op = 0;
                cig_len += nbb;
                seq_pos += nbb;
                ref_pos += nbb;
                break;
            }
            case 'q': {
                flush_if(0);
                dec_run_into("QQ", (size_t)(pos - 1), true);
                cig_op = 0;
                break;
            }
            case 'B': {
                flush_if(0);
                const Codec* BA = comp.get("BA");
                if (!BA) throw DecodeError("missing BA");
                if (pos - 1 < (int64_t)r.seq.size())
                    r.seq[pos - 1] = BA->decode_byte(core, ext);
                const Codec* QS = comp.get("QS");
                if (QS && pos - 1 < (int64_t)r.qual.size())
                    r.qual[pos - 1] = QS->decode_byte(core, ext);
                cig_op = 0;
                cig_len += 1;
                seq_pos += 1;
                ref_pos += 1;
                break;
            }
            case 'Q': {
                const Codec* QS = comp.get("QS");
                if (!QS) throw DecodeError("missing QS");
                if (pos - 1 < (int64_t)r.qual.size())
                    r.qual[pos - 1] = QS->decode_byte(core, ext);
                break;
            }
            case 'H': {
                flush_if(5);
                int64_t hc = dec_int("HC", 0);
                cig_op = 5;
                cig_len += hc;
                break;
            }
            case 'P': {
                flush_if(6);
                int64_t pd = dec_int("PD", 0);
                cig_op = 6;
                cig_len += pd;
                break;
            }
            case 'N': {
                flush_if(3);
                int64_t rs = dec_int("RS", 0);
                cig_op = 3;
                cig_len += rs;
                ref_pos += rs;
                break;
            }
            default:
                throw DecodeError("unknown feature code");
        }
    }

    // implicit trailing match
    if (r.len >= seq_pos) {
        int64_t span = r.len - seq_pos + 1;
        copy_ref(seq_pos - 1, ref_pos, span);
        ref_pos += span;
        flush_if(0);
        cig_op = 0;
        cig_len += span;
    }
    if (cig_len) r.cigar.emplace_back(cig_op, cig_len);
    r.aend = std::max(ref_pos, r.apos);
    r.mqual = (int32_t)dec_int("MQ", 40);
    if (r.cf & CF_QUAL) {
        const Codec* QS = comp.get("QS");
        if (!QS) throw DecodeError("missing QS");
        QS->decode_bytes_n(core, ext, r.len, r.qual);
        if ((int64_t)r.qual.size() < r.len) r.qual.resize(r.len, 0xff);
    }
    if (r.cf & CF_NO_SEQ) {
        r.len = 0;
        r.seq.clear();
        r.qual.clear();
    }
}

// cram_decode_slice_xref semantics; port of io/cram.py:1175-1246
static void xref(std::vector<Rec>& recs) {
    int64_t n = (int64_t)recs.size();
    for (int64_t i = 0; i < n; i++) {
        Rec& r = recs[i];
        if (r.mate_line >= 0 && r.mate_line < n) {
            if (r.tlen == TLEN_NONE) {
                int64_t aleft = r.apos, aright = r.aend;
                int left_cnt = 0;
                int32_t ref = r.ref_id;
                int64_t id2 = i;
                while (true) {
                    if (aleft > recs[id2].apos) {
                        aleft = recs[id2].apos;
                        left_cnt = 1;
                    } else if (aleft == recs[id2].apos) {
                        left_cnt += 1;
                    }
                    if (aright < recs[id2].aend) aright = recs[id2].aend;
                    if (recs[id2].mate_line == -1) {
                        recs[id2].mate_line = i;
                        break;
                    }
                    id2 = recs[id2].mate_line;
                    if (recs[id2].ref_id != ref) ref = -1;
                    if (id2 == i) break;
                }
                if (ref != -1) {
                    int64_t tlen = aright - aleft + 1;
                    std::vector<int64_t> chain{i};
                    id2 = recs[i].mate_line;
                    while (id2 != i) {
                        chain.push_back(id2);
                        id2 = recs[id2].mate_line;
                    }
                    for (int64_t id3 : chain) {
                        if (recs[id3].apos == aleft
                            && (left_cnt == 1 || (recs[id3].flags & BAM_FREAD1)))
                            recs[id3].tlen = tlen;
                        else
                            recs[id3].tlen = -tlen;
                    }
                } else {
                    id2 = i;
                    while (true) {
                        recs[id2].tlen = 0;
                        id2 = recs[id2].mate_line;
                        if (id2 == i) break;
                    }
                }
            }
            Rec& mate = recs[r.mate_line];
            r.mate_pos = mate.apos;
            r.mate_ref_id = mate.ref_id;
            r.flags |= BAM_FPAIRED;
            if (mate.flags & BAM_FUNMAP) {
                r.flags |= BAM_FMUNMAP;
                r.tlen = 0;
            }
            if (r.flags & BAM_FUNMAP) r.tlen = 0;
            if (mate.flags & BAM_FREVERSE) r.flags |= BAM_FMREVERSE;
            if (r.name.empty()) r.name = mate.name;
        } else {
            if (r.mate_flags & MATE_REVERSE)
                r.flags |= BAM_FPAIRED | BAM_FMREVERSE;
            if (r.mate_flags & MATE_UNMAP) r.flags |= BAM_FMUNMAP;
            if (!(r.flags & BAM_FPAIRED)) r.mate_ref_id = -1;
        }
        if (r.tlen == TLEN_NONE) r.tlen = 0;
    }
    for (auto& r : recs)
        if (r.has_explicit_tlen) r.tlen = r.explicit_tlen;
}

// BAM bin number (standard reg2bin)
static int reg2bin(int64_t beg, int64_t end) {
    end--;
    if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

// ASCII -> nt16 code ("=ACMGRSVTWYHKDBN"), unknown -> N(15), case-insensitive
static uint8_t NT16[256];
// (hi,lo) ASCII pair -> packed nt16 byte; one 64K-table load per output
// byte instead of two lookups + shift in the seq-pack hot loop
static uint8_t NT16_PAIR[65536];
static bool nt16_init() {
    const char* s = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; i++) NT16[i] = 15;
    for (int i = 0; i < 16; i++) {
        NT16[(uint8_t)s[i]] = (uint8_t)i;
        NT16[(uint8_t)tolower(s[i])] = (uint8_t)i;
    }
    for (int a = 0; a < 256; a++)
        for (int b = 0; b < 256; b++)
            NT16_PAIR[(a << 8) | b] = (uint8_t)((NT16[a] << 4) | NT16[b]);
    return true;
}
static bool nt16_ready = nt16_init();

#if defined(__x86_64__)
// ASCII base pairs -> BAM nibbles, 32 chars -> 16 bytes per step. Only the
// unambiguous alphabet {ACGTNacgtn} is handled vectorially; the low-nibble
// code lookup is validated by reconstructing the canonical uppercase char,
// and the first 32-chunk containing anything else (IUPAC codes, '=')
// returns early so the scalar pair-table loop finishes the record.
__attribute__((target("avx2")))
static int64_t pack_nibbles_avx2(const uint8_t* sq, int64_t n, uint8_t* out) {
    const __m256i lut = _mm256_setr_epi8(
        0, 1, 0, 2, 8, 0, 0, 4, 0, 0, 0, 0, 0, 0, 15, 0,
        0, 1, 0, 2, 8, 0, 0, 4, 0, 0, 0, 0, 0, 0, 15, 0);
    // rev[0] = 0x01 so code-0 bytes can never validate: ch&0xDF == 0x01
    // forces ch's low nibble to 1, whose lut code is 1, not 0. This keeps
    // NUL/space bytes (e.g. unfilled reference-based seq) on the scalar
    // NT16 path, which maps them to 'N' like the non-AVX2 build.
    const __m256i rev = _mm256_setr_epi8(
        1, 0x41, 0x43, 1, 0x47, 1, 1, 1, 0x54, 1, 1, 1, 1, 1, 1, 0x4E,
        1, 0x41, 0x43, 1, 0x47, 1, 1, 1, 0x54, 1, 1, 1, 1, 1, 1, 0x4E);
    const __m256i low_mask = _mm256_set1_epi8(0x0F);
    const __m256i up_mask = _mm256_set1_epi8((char)0xDF);
    const __m256i mul = _mm256_set1_epi16(0x0110);  // (c0 * 16 + c1) pairs
    int64_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i ch = _mm256_loadu_si256((const __m256i*)(sq + i));
        __m256i code = _mm256_shuffle_epi8(lut,
                                           _mm256_and_si256(ch, low_mask));
        __m256i ok = _mm256_cmpeq_epi8(_mm256_shuffle_epi8(rev, code),
                                       _mm256_and_si256(ch, up_mask));
        if (_mm256_movemask_epi8(ok) != -1) break;
        __m256i sums = _mm256_maddubs_epi16(code, mul);
        __m256i packed = _mm256_packus_epi16(sums, _mm256_setzero_si256());
        _mm_storel_epi64((__m128i*)out, _mm256_castsi256_si128(packed));
        _mm_storel_epi64((__m128i*)(out + 8),
                         _mm256_extracti128_si256(packed, 1));
        out += 16;
    }
    return i;
}

static bool cpu_avx2() {
    static int v = -1;
    if (v < 0) v = __builtin_cpu_supports("avx2") ? 1 : 0;
    return v == 1;
}
#endif

static void to_bam(const Rec& r, const std::vector<std::string>& read_groups,
                   std::vector<uint8_t, NoInitAllocC<uint8_t>>& out) {
    const uint8_t* name = r.name.empty() ? (const uint8_t*)"?" : r.name.data();
    size_t name_len = r.name.empty() ? 1 : r.name.size();
    int l_read_name = (int)name_len + 1;
    int n_cigar = (int)r.cigar.size();
    int64_t l_seq = (int64_t)r.seq.size();
    int64_t end = r.aend > r.apos ? r.aend : r.apos;
    int bam_bin = reg2bin(r.apos - 1, end > r.apos - 1 ? end : r.apos);

    size_t tag_extra = 0;
    bool add_rg = r.rg >= 0 && r.rg < (int)read_groups.size();
    if (add_rg) tag_extra = 3 + read_groups[r.rg].size() + 1;

    size_t total = 32 + name_len + 1 + 4 * n_cigar + (l_seq + 1) / 2 + l_seq
                 + r.tags.size() + tag_extra;
    size_t base = out.size();
    out.resize(base + total);
    uint8_t* p = out.data() + base;

    auto put_i32 = [&](int32_t v) { memcpy(p, &v, 4); p += 4; };
    auto put_u16 = [&](uint16_t v) { memcpy(p, &v, 2); p += 2; };
    put_i32(r.ref_id);
    put_i32((int32_t)(r.apos - 1));
    *p++ = (uint8_t)l_read_name;
    *p++ = (uint8_t)r.mqual;
    put_u16((uint16_t)bam_bin);
    put_u16((uint16_t)n_cigar);
    put_u16((uint16_t)r.flags);
    put_i32((int32_t)l_seq);
    put_i32(r.mate_ref_id);
    put_i32((int32_t)(r.mate_pos - 1));
    put_i32((int32_t)r.tlen);
    memcpy(p, name, name_len);
    p += name_len;
    *p++ = 0;
    for (auto& c : r.cigar) {
        uint32_t v = ((uint32_t)c.second << 4) | (uint32_t)c.first;
        memcpy(p, &v, 4);
        p += 4;
    }
    {
        const uint8_t* sq = r.seq.data();
        int64_t done = 0;
#if defined(__x86_64__)
        if (l_seq >= 32 && cpu_avx2()) {
            done = pack_nibbles_avx2(sq, l_seq & ~int64_t(1), p);
            p += done / 2;
        }
#endif
        for (int64_t i = done; i + 1 < l_seq; i += 2)
            *p++ = NT16_PAIR[((uint32_t)sq[i] << 8) | sq[i + 1]];
        if (l_seq & 1) *p++ = (uint8_t)(NT16[sq[l_seq - 1]] << 4);
    }
    if ((int64_t)r.qual.size() == l_seq) {
        memcpy(p, r.qual.data(), l_seq);
        p += l_seq;
    } else {
        memset(p, 0xff, l_seq);
        p += l_seq;
    }
    memcpy(p, r.tags.data(), r.tags.size());
    p += r.tags.size();
    if (add_rg) {
        *p++ = 'R'; *p++ = 'G'; *p++ = 'Z';
        memcpy(p, read_groups[r.rg].data(), read_groups[r.rg].size());
        p += read_groups[r.rg].size();
        *p++ = 0;
    }
}

// ---------------------------------------------------------------------------
// slice / container decode
// ---------------------------------------------------------------------------

struct ContainerOut {
    std::vector<uint8_t, NoInitAllocC<uint8_t>> blob;  // concatenated records
    std::vector<int64_t> rec_sizes;     // per-record byte sizes
};

static void decode_slice(const CompHeader& comp, Block& core, ExtMap& ext,
                         int64_t s_ref_id, int64_t s_ref_start, int64_t nrec,
                         FastaRef* fasta,
                         const std::vector<std::string>& read_groups,
                         ContainerOut& out) {
    auto dec_int_req = [&](const char* key, int64_t def, bool has_def) -> int64_t {
        const Codec* c = comp.get(key);
        if (!c) {
            if (!has_def) throw DecodeError("missing codec");
            return def;
        }
        return c->decode_int(core, ext);
    };

    std::vector<Rec> recs(nrec);
    int64_t last_apos = s_ref_start;
    std::vector<uint8_t> tmp;
    {
    AccumTimer at_fields(acc_fields_us);
    for (int64_t idx = 0; idx < nrec; idx++) {
        Rec& r = recs[idx];
        r.flags = (int32_t)dec_int_req("BF", 0x4, true);
        r.cf = (int32_t)dec_int_req("CF", 0, true);
        if (s_ref_id == -2) r.ref_id = (int32_t)dec_int_req("RI", -1, true);
        else r.ref_id = (int32_t)s_ref_id;
        r.len = dec_int_req("RL", 0, true);
        int64_t apos = dec_int_req("AP", 0, true);
        if (comp.ap_delta) apos += last_apos;
        last_apos = apos;
        r.apos = apos;
        r.rg = (int32_t)dec_int_req("RG", -1, true);
        const Codec* RN = comp.get("RN");
        if (comp.read_names_included && RN) {
            if (RN->has_bytes()) RN->decode_bytes(core, ext, r.name);
            else { r.name.clear(); r.name.push_back(RN->decode_byte(core, ext)); }
        }
        if (r.cf & CF_DETACHED) {
            r.mate_flags = (int32_t)dec_int_req("MF", 0, true);
            if (!comp.read_names_included && RN) {
                if (RN->has_bytes()) RN->decode_bytes(core, ext, r.name);
                else { r.name.clear(); r.name.push_back(RN->decode_byte(core, ext)); }
            }
            r.mate_ref_id = (int32_t)dec_int_req("NS", -1, true);
            r.mate_pos = dec_int_req("NP", 0, true);
            r.tlen = dec_int_req("TS", 0, true);
        } else if (r.cf & CF_DOWNSTREAM) {
            int64_t nf = dec_int_req("NF", 0, true);
            r.mate_line = nf + idx + 1;
            if (r.cf & CF_EXPLICIT_TLEN) {
                r.explicit_tlen = dec_int_req("TS", 0, true);
                r.has_explicit_tlen = true;
            }
        } else if (r.cf & CF_EXPLICIT_TLEN) {
            r.explicit_tlen = dec_int_req("TS", 0, true);
            r.has_explicit_tlen = true;
        }

        // aux tags
        int64_t tl = dec_int_req("TL", 0, true);
        r.tags.clear();
        if (tl >= 0 && tl < (int64_t)comp.tag_dict.size()) {
            for (const TagDef& td : comp.tag_dict[tl]) {
                uint32_t keyid = (uint32_t(uint8_t(td.tag2[0])) << 16)
                               | (uint32_t(uint8_t(td.tag2[1])) << 8)
                               | uint8_t(td.typ);
                auto it = comp.tag_codecs.find(keyid);
                if (it == comp.tag_codecs.end())
                    throw DecodeError("missing tag codec");
                const Codec* c = it->second.get();
                if (c->has_bytes()) c->decode_bytes(core, ext, tmp);
                else { tmp.clear(); tmp.push_back(c->decode_byte(core, ext)); }
                r.tags.push_back((uint8_t)td.tag2[0]);
                r.tags.push_back((uint8_t)td.tag2[1]);
                r.tags.push_back((uint8_t)td.typ);
                r.tags.insert(r.tags.end(), tmp.begin(), tmp.end());
            }
        }

        if (!(r.flags & BAM_FUNMAP)) {
            std::shared_ptr<std::string> ref =
                (!comp.no_ref && fasta) ? fasta->get(r.ref_id) : nullptr;
            decode_seq(comp, core, ext, r, ref ? ref.get() : nullptr);
        } else {
            r.seq.clear();
            const Codec* BA = comp.get("BA");
            if (BA) {
                if (BA->kind == E_EXTERNAL)
                    BA->decode_bytes_n(core, ext, r.len, r.seq);
                else {
                    r.seq.resize(r.len);
                    for (int64_t i = 0; i < r.len; i++)
                        r.seq[i] = BA->decode_byte(core, ext);
                }
            }
            r.aend = r.apos;
            if (r.cf & CF_QUAL) {
                const Codec* QS = comp.get("QS");
                if (!QS) throw DecodeError("missing QS");
                QS->decode_bytes_n(core, ext, r.len, r.qual);
            } else {
                r.qual.assign(r.len, 0xff);
            }
        }
        if (!comp.qs_seq_orient && (r.flags & BAM_FREVERSE))
            std::reverse(r.qual.begin(), r.qual.end());
    }

    }
    AccumTimer at_bam(acc_tobam_us);
    xref(recs);
    // exact-size reservation: vector doubling would memcpy the ~GB blob
    // an extra time over the whole file
    size_t need = out.blob.size();
    for (const Rec& r : recs) {
        size_t name_len = r.name.empty() ? 1 : r.name.size();
        size_t tag_extra = 0;
        if (r.rg >= 0 && r.rg < (int)read_groups.size())
            tag_extra = 3 + read_groups[r.rg].size() + 1;
        need += 32 + name_len + 1 + 4 * r.cigar.size() +
                (r.seq.size() + 1) / 2 + r.seq.size() + r.tags.size() +
                tag_extra;
    }
    out.blob.reserve(need);
    out.rec_sizes.reserve(out.rec_sizes.size() + recs.size());
    for (const Rec& r : recs) {
        size_t before = out.blob.size();
        to_bam(r, read_groups, out.blob);
        out.rec_sizes.push_back((int64_t)(out.blob.size() - before));
    }
}

struct FileCtx {
    const uint8_t* buf;
    size_t n;
    int major;
    FastaRef* fasta;
    std::vector<std::string> read_groups;
};

// parse container at `off`; returns end offset. If `out` is non-null the
// container is fully decoded into it, else blocks are skipped (scan mode).
static size_t walk_container(const FileCtx& fc, size_t off, ContainerOut* out,
                             int64_t* num_records_out) {
    const uint8_t* buf = fc.buf;
    size_t n = fc.n;
    off += 4;  // container length (we trust block headers for the walk)
    itf8_get_signed(buf, n, off);  // ref_seq_id
    itf8_get(buf, n, off);         // ref_start
    itf8_get(buf, n, off);         // ref_span
    int64_t num_records = itf8_get(buf, n, off);
    if (fc.major >= 3) ltf8_get(buf, n, off);
    else itf8_get(buf, n, off);    // record counter
    ltf8_get(buf, n, off);         // num bases
    int64_t num_blocks = itf8_get(buf, n, off);
    int64_t num_landmarks = itf8_get(buf, n, off);
    for (int64_t i = 0; i < num_landmarks; i++) itf8_get(buf, n, off);
    if (fc.major >= 3) off += 4;  // crc32
    if (num_records_out) *num_records_out = num_records;

    if (out == nullptr || num_records == 0) {
        // skip blocks without decompressing
        for (int64_t i = 0; i < num_blocks; i++) {
            off += 2;
            itf8_get(buf, n, off);
            uint32_t comp_size = itf8_get(buf, n, off);
            itf8_get(buf, n, off);
            off += comp_size + 4;
        }
        return off;
    }

    std::vector<Block> blocks(num_blocks);
    for (int64_t i = 0; i < num_blocks; i++)
        off = read_block(buf, n, off, blocks[i]);

    CompHeader comp;
    parse_comp_header(blocks[0].data, comp);
    int64_t i = 1;
    while (i < num_blocks) {
        if (blocks[i].ctype != CT_SLICE_HEADER) { i++; continue; }
        const std::vector<uint8_t>& data = blocks[i].data;
        size_t so = 0, sn = data.size();
        int64_t s_ref_id = itf8_get_signed(data.data(), sn, so);
        int64_t s_ref_start = itf8_get(data.data(), sn, so);
        itf8_get(data.data(), sn, so);  // span
        int64_t s_nrec = itf8_get(data.data(), sn, so);
        if (fc.major >= 3) ltf8_get(data.data(), sn, so);
        else itf8_get(data.data(), sn, so);
        int64_t s_nblocks = itf8_get(data.data(), sn, so);
        int64_t n_ids = itf8_get(data.data(), sn, so);
        for (int64_t k = 0; k < n_ids; k++) itf8_get(data.data(), sn, so);
        itf8_get_signed(data.data(), sn, so);  // embedded ref id (unused)

        Block* core = nullptr;
        ExtMap ext;
        for (int64_t k = i + 1; k < i + 1 + s_nblocks && k < num_blocks; k++) {
            if (blocks[k].ctype == CT_CORE && !core) core = &blocks[k];
            else if (blocks[k].ctype == CT_EXTERNAL)
                ext[blocks[k].content_id] = &blocks[k];
        }
        if (!core) throw DecodeError("missing core block");
        {
            AccumTimer at(acc_recon_us);
            decode_slice(comp, *core, ext, s_ref_id, s_ref_start, s_nrec,
                         fc.fasta, fc.read_groups, *out);
        }
        i += 1 + s_nblocks;
    }
    return off;
}

// ---------------------------------------------------------------------------
// result + C API
// ---------------------------------------------------------------------------

struct CramResult {
    std::vector<ContainerOut> outs;   // per-container, in order
    std::vector<int64_t> rec_off;     // n_rec + 1
    int64_t blob_len = 0;
    // SAM-header metadata so a BAM handle can be synthesized without
    // re-parsing the file (lps_ingest.cpp lps_bam_load_cram)
    std::string header_text;
    std::vector<std::string> ref_names;
    std::vector<int64_t> ref_lens;
};

static CramResult* decode_file(const char* path, const char* fasta_path,
                               const int64_t* offsets, int64_t n_offsets,
                               int n_threads) {
    // slurp the file
    PhaseTimer tm_all("cram_decode_file");
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long fsz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(fsz);
    if (fread(buf.data(), 1, fsz, f) != (size_t)fsz) { fclose(f); return nullptr; }
    fclose(f);
    if (fsz < 26 || memcmp(buf.data(), "CRAM", 4) != 0) return nullptr;

    FileCtx fc;
    fc.buf = buf.data();
    fc.n = buf.size();
    fc.major = buf[4];
    if (fc.major != 2 && fc.major != 3) return nullptr;

    FastaRef fasta;
    std::string header_text_keep;
    std::vector<int64_t> ref_lens_keep;
    try {
        // SAM header container at offset 26
        size_t off = 26;
        // parse header container blocks manually: first block is file header
        {
            size_t o2 = off + 4;
            itf8_get_signed(buf.data(), fc.n, o2);
            itf8_get(buf.data(), fc.n, o2);
            itf8_get(buf.data(), fc.n, o2);
            itf8_get(buf.data(), fc.n, o2);
            if (fc.major >= 3) ltf8_get(buf.data(), fc.n, o2);
            else itf8_get(buf.data(), fc.n, o2);
            ltf8_get(buf.data(), fc.n, o2);
            int64_t nblocks = itf8_get(buf.data(), fc.n, o2);
            int64_t nlm = itf8_get(buf.data(), fc.n, o2);
            for (int64_t i = 0; i < nlm; i++) itf8_get(buf.data(), fc.n, o2);
            if (fc.major >= 3) o2 += 4;
            Block hb;
            o2 = read_block(buf.data(), fc.n, o2, hb);
            for (int64_t i = 1; i < nblocks; i++) {
                Block skip_b;
                o2 = read_block(buf.data(), fc.n, o2, skip_b);
            }
            if (hb.data.size() < 4) return nullptr;
            int32_t hlen;
            memcpy(&hlen, hb.data.data(), 4);
            std::string header_text((const char*)hb.data.data() + 4,
                                    (size_t)std::min<int64_t>(hlen, hb.data.size() - 4));
            // @SQ names (tid order) and @RG IDs
            size_t lp = 0;
            while (lp < header_text.size()) {
                size_t le = header_text.find('\n', lp);
                if (le == std::string::npos) le = header_text.size();
                std::string line = header_text.substr(lp, le - lp);
                if (line.rfind("@SQ", 0) == 0) {
                    size_t sp = line.find("SN:");
                    if (sp != std::string::npos) {
                        size_t se = line.find('\t', sp);
                        fasta.names.push_back(line.substr(
                            sp + 3, (se == std::string::npos ? line.size() : se)
                                        - sp - 3));
                    }
                    size_t lp2 = line.find("LN:");
                    int64_t ln = 0;
                    if (lp2 != std::string::npos)
                        ln = strtoll(line.c_str() + lp2 + 3, nullptr, 10);
                    ref_lens_keep.push_back(ln);
                } else if (line.rfind("@RG", 0) == 0) {
                    size_t sp = line.find("ID:");
                    if (sp != std::string::npos) {
                        size_t se = line.find('\t', sp);
                        fc.read_groups.push_back(line.substr(
                            sp + 3, (se == std::string::npos ? line.size() : se)
                                        - sp - 3));
                    }
                }
                lp = le + 1;
            }
            header_text_keep = std::move(header_text);
            off = o2;
        }
        if (fasta_path && fasta_path[0]) fasta.load_fai(fasta_path);
        fc.fasta = &fasta;

        // container offset list
        std::vector<size_t> conts;
        if (n_offsets > 0) {
            std::vector<int64_t> sorted(offsets, offsets + n_offsets);
            std::sort(sorted.begin(), sorted.end());
            sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
            for (int64_t o : sorted) conts.push_back((size_t)o);
        } else {
            size_t o = off;
            while (o < fc.n) {
                int64_t nrec = 0;
                size_t end = walk_container(fc, o, nullptr, &nrec);
                if (nrec > 0) conts.push_back(o);
                o = end;
            }
        }

        // decode containers across threads
        PhaseTimer tm_dec("cram_container_decode");
        std::vector<ContainerOut> outs(conts.size());
        std::atomic<size_t> next{0};
        std::atomic<bool> failed{false};
        int nt = std::max(1, std::min<int>(n_threads, (int)conts.size()));
        auto worker = [&]() {
            while (true) {
                size_t i = next.fetch_add(1);
                if (i >= conts.size() || failed.load()) return;
                try {
                    int64_t nrec = 0;
                    walk_container(fc, conts[i], &outs[i], &nrec);
                } catch (...) {
                    failed.store(true);
                    return;
                }
            }
        };
        if (nt == 1) worker();
        else {
            std::vector<std::thread> th;
            for (int t = 0; t < nt; t++) th.emplace_back(worker);
            for (auto& t : th) t.join();
        }
        if (failed.load()) return nullptr;
        if (lps_timing()) {
            fprintf(stderr,
                    "[lps_timing] cram core-seconds: rans=%.2f gzip=%.2f "
                    "recon_total=%.2f fields=%.2f to_bam=%.2f\n",
                    acc_rans_us.exchange(0) / 1e6,
                    acc_gzip_us.exchange(0) / 1e6,
                    acc_recon_us.exchange(0) / 1e6,
                    acc_fields_us.exchange(0) / 1e6,
                    acc_tobam_us.exchange(0) / 1e6);
        }

        auto* res = new CramResult();
        res->header_text = std::move(header_text_keep);
        res->ref_names = fasta.names;
        res->ref_lens = std::move(ref_lens_keep);
        size_t nrec_total = 0;
        for (auto& o : outs) {
            res->blob_len += (int64_t)o.blob.size();
            nrec_total += o.rec_sizes.size();
        }
        res->rec_off.reserve(nrec_total + 1);
        res->rec_off.push_back(0);
        for (auto& o : outs)
            for (int64_t sz : o.rec_sizes)
                res->rec_off.push_back(res->rec_off.back() + sz);
        res->outs = std::move(outs);  // concatenated lazily in lps_cram_fill
        return res;
    } catch (...) {
        return nullptr;
    }
}

// ---------------------------------------------------------------------------
// writer: referenceless CRAM 3.0 encode (port of io/cram.py CramWriter —
// detached mates, verbatim bases via b/S/I features, rANS-or-gzip blocks)
// ---------------------------------------------------------------------------

static void itf8_put(int64_t v64, std::vector<uint8_t>& out) {
    uint32_t v = (uint32_t)(v64 & 0xFFFFFFFF);
    if (v < 0x80) {
        out.push_back((uint8_t)v);
    } else if (v < 0x4000) {
        out.push_back((uint8_t)(0x80 | (v >> 8)));
        out.push_back((uint8_t)(v & 0xFF));
    } else if (v < 0x200000) {
        out.push_back((uint8_t)(0xC0 | (v >> 16)));
        out.push_back((uint8_t)((v >> 8) & 0xFF));
        out.push_back((uint8_t)(v & 0xFF));
    } else if (v < 0x10000000) {
        out.push_back((uint8_t)(0xE0 | (v >> 24)));
        out.push_back((uint8_t)((v >> 16) & 0xFF));
        out.push_back((uint8_t)((v >> 8) & 0xFF));
        out.push_back((uint8_t)(v & 0xFF));
    } else {
        out.push_back((uint8_t)(0xF0 | ((v >> 28) & 0x0F)));
        out.push_back((uint8_t)((v >> 20) & 0xFF));
        out.push_back((uint8_t)((v >> 12) & 0xFF));
        out.push_back((uint8_t)((v >> 4) & 0xFF));
        out.push_back((uint8_t)(v & 0x0F));
    }
}

static void ltf8_put(int64_t v64, std::vector<uint8_t>& out) {
    uint64_t v = (uint64_t)v64;
    if (v < 0x80) {
        out.push_back((uint8_t)v);
        return;
    }
    // header byte: n leading ones, a zero, then (7-n) high value bits;
    // n trailing value bytes. Matches the reader's ltf8_get.
    for (int n = 1; n < 8; n++) {
        if (v < (1ull << (7 * (n + 1) - n))) {  // same split as the Python put
            uint8_t hdr = (uint8_t)(0xFF ^ (0xFF >> n));
            out.push_back(hdr | (uint8_t)(v >> (8 * n)));
            for (int i = n - 1; i >= 0; i--)
                out.push_back((uint8_t)((v >> (8 * i)) & 0xFF));
            return;
        }
    }
    out.push_back(0xFF);
    for (int i = 7; i >= 0; i--)
        out.push_back((uint8_t)((v >> (8 * i)) & 0xFF));
}

static bool gzip_compress_buf(const uint8_t* d, size_t n, int level,
                              std::vector<uint8_t>& out) {
#ifdef USE_LIBDEFLATE
    {
        struct libdeflate_compressor* z = libdeflate_alloc_compressor(level);
        size_t bound = libdeflate_gzip_compress_bound(z, n);
        out.resize(bound);
        size_t got = libdeflate_gzip_compress(z, d, n, out.data(), bound);
        libdeflate_free_compressor(z);
        if (got > 0) {
            out.resize(got);
            return true;
        }
    }
#endif
    uLongf bound = compressBound((uLong)n) + 32;
    std::vector<uint8_t> tmp(bound);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return false;
    zs.next_in = const_cast<uint8_t*>(d);
    zs.avail_in = (uInt)n;
    zs.next_out = tmp.data();
    zs.avail_out = (uInt)bound;
    int r = deflate(&zs, Z_FINISH);
    size_t got = bound - zs.avail_out;
    deflateEnd(&zs);
    if (r != Z_STREAM_END) return false;
    tmp.resize(got);
    out.swap(tmp);
    return true;
}

// rANS 4x8 order-0 encode; port of io/cram.py:326-399
static bool rans_encode_o0(const uint8_t* data, size_t n,
                           std::vector<uint8_t>& out) {
    if (n == 0) return false;
    int64_t hist[256] = {0};
    for (size_t i = 0; i < n; i++) hist[data[i]]++;
    int64_t freqs[256] = {0};
    int64_t fsum = 0, m_f = 0;
    int m_sym = 0;
    for (int sym = 0; sym < 256; sym++) {
        if (hist[sym] == 0) continue;
        int64_t f = hist[sym] * TOTFREQ / (int64_t)n;
        if (f < 1) f = 1;
        freqs[sym] = f;
        fsum += f;
        if (f > m_f) {
            m_f = f;
            m_sym = sym;
        }
    }
    freqs[m_sym] += TOTFREQ - fsum;
    if (freqs[m_sym] <= 0) return false;  // pathological; gzip instead
    int64_t start[256];
    {
        int64_t x = 0;
        for (int sym = 0; sym < 256; sym++) {
            start[sym] = x;
            x += freqs[sym];
        }
    }
    // frequency table serialization (+1 RLE as in the reader)
    std::vector<uint8_t> tab;
    std::vector<int> syms;
    for (int sym = 0; sym < 256; sym++)
        if (freqs[sym]) syms.push_back(sym);
    int rle = 0;
    for (size_t idx = 0; idx < syms.size(); idx++) {
        int sym = syms[idx];
        if (rle) {
            rle--;
        } else {
            tab.push_back((uint8_t)sym);
            if (idx && sym == syms[idx - 1] + 1) {
                int run = 0;
                while (idx + run + 1 <= syms.size() - 1 &&
                       syms[idx + run + 1] == sym + run + 1)
                    run++;
                tab.push_back((uint8_t)run);
                rle = run;
            }
        }
        int64_t f = freqs[sym];
        if (f < 128) {
            tab.push_back((uint8_t)f);
        } else {
            tab.push_back((uint8_t)(0x80 | (f >> 8)));
            tab.push_back((uint8_t)(f & 0xFF));
        }
    }
    tab.push_back(0);

    uint32_t R[4] = {RANS_BYTE_L, RANS_BYTE_L, RANS_BYTE_L, RANS_BYTE_L};
    std::vector<uint8_t> out_rev;
    out_rev.reserve(n);
    for (int64_t i = (int64_t)n - 1; i >= 0; i--) {
        int k = i & 3;
        int sym = data[i];
        uint32_t f = (uint32_t)freqs[sym];
        uint32_t x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f;
        uint32_t x = R[k];
        while (x >= x_max) {
            out_rev.push_back((uint8_t)(x & 0xFF));
            x >>= 8;
        }
        R[k] = ((x / f) << TF_SHIFT) + (x % f) + (uint32_t)start[sym];
    }
    size_t payload_n = tab.size() + 16 + out_rev.size();
    out.clear();
    out.reserve(9 + payload_n);
    out.push_back(0);
    uint32_t in_sz = (uint32_t)payload_n, out_sz = (uint32_t)n;
    out.insert(out.end(), (uint8_t*)&in_sz, (uint8_t*)&in_sz + 4);
    out.insert(out.end(), (uint8_t*)&out_sz, (uint8_t*)&out_sz + 4);
    out.insert(out.end(), tab.begin(), tab.end());
    for (int k = 0; k < 4; k++)
        out.insert(out.end(), (uint8_t*)&R[k], (uint8_t*)&R[k] + 4);
    out.insert(out.end(), out_rev.rbegin(), out_rev.rend());
    return true;
}

// _encode_block: rANS when preferred and it wins over raw, else gzip
// (unlike the Python writer we don't compress twice to pick the smaller —
// block choice only affects size, not compatibility).
// rANS is capped to small blocks: the 4x8 decode is a serial per-byte loop
// on every reader (ours and htslib's scalar path), so multi-MB rANS blocks
// decode an order of magnitude slower than libdeflate gzip.
static const size_t RANS_ENCODE_MAX = 256u << 10;

static void encode_block(int method, int ctype, int64_t content_id,
                         const uint8_t* raw, size_t n,
                         std::vector<uint8_t>& out) {
    int used = RAW;
    std::vector<uint8_t> best(raw, raw + n);
    if (method != RAW && n > 0) {
        bool done = false;
        if (method == M_RANS && n > RANS_ENCODE_MAX) {
            // big payload: gzip compresses comparably and decodes ~5x faster
        } else if (method == M_RANS) {
            std::vector<uint8_t> r;
            if (rans_encode_o0(raw, n, r) && r.size() < best.size()) {
                best.swap(r);
                used = M_RANS;
                done = true;
            }
        }
        if (!done) {
            std::vector<uint8_t> g;
            if (gzip_compress_buf(raw, n, 6, g) && g.size() < best.size()) {
                best.swap(g);
                used = M_GZIP;
            }
        }
    }
    size_t base = out.size();
    out.push_back((uint8_t)used);
    out.push_back((uint8_t)ctype);
    itf8_put(content_id, out);
    itf8_put((int64_t)best.size(), out);
    itf8_put((int64_t)n, out);
    out.insert(out.end(), best.begin(), best.end());
    uint32_t crc = crc32(0L, out.data() + base, (uInt)(out.size() - base));
    out.insert(out.end(), (uint8_t*)&crc, (uint8_t*)&crc + 4);
}

// series layout mirrors io/cram.py _SERIES/_CID (+ BS for reference-based
// substitution features, appended so existing indices stay put)
static const char* SERIES[] = {"BF", "CF", "RI", "RL", "AP", "MF", "NS",
                               "NP", "TS", "TL", "FN", "FC", "FP", "DL",
                               "RS", "PD", "HC", "MQ", "BA", "SC", "BB",
                               "IN", "QS", "BS"};
static const int N_SERIES = 24;
// cid: series i -> i+1; SC_len/BB_len/IN_len -> 25,26,27; RN -> 28; tags 29+
static int cid_of(int series_idx) { return series_idx + 1; }
static const int CID_SC_LEN = 25, CID_BB_LEN = 26, CID_IN_LEN = 27;
static const int CID_RN = 28, CID_TAG_BASE = 29;
enum { S_BF, S_CF, S_RI, S_RL, S_AP, S_MF, S_NS, S_NP, S_TS, S_TL, S_FN,
       S_FC, S_FP, S_DL, S_RS, S_PD, S_HC, S_MQ, S_BA, S_SC, S_BB, S_IN,
       S_QS, S_BS };

struct CramWriterN {
    FILE* f = nullptr;
    std::string path;
    int64_t counter = 0;
    // reference-based sequence encoding (X substitution features against
    // the fasta) when a reference is supplied; falls back to verbatim 'b'
    // runs per segment whenever a base pair is not expressible in the
    // ACGTN substitution matrix
    FastaRef fasta;
    bool use_ref = false;
    struct CraiEntry {
        int64_t tid, start, span, coff, soff, ssz;
    };
    std::vector<CraiEntry> index;
    // container pipeline: encode+write runs on a worker thread so the
    // caller can assemble the next container concurrently
    struct Job {
        std::vector<uint8_t> blob;
        std::vector<int64_t> rec_off;
        int32_t tid;
        int64_t counter;
    };
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<Job> q;
    bool finish = false;
    bool failed = false;
    bool started = false;
};

static void enc_external(int cid, std::vector<uint8_t>& out) {
    std::vector<uint8_t> params;
    itf8_put(cid, params);
    itf8_put(1, out);  // E_EXTERNAL
    itf8_put((int64_t)params.size(), out);
    out.insert(out.end(), params.begin(), params.end());
}

static void enc_huffman_const(int64_t value, std::vector<uint8_t>& out) {
    std::vector<uint8_t> params;
    itf8_put(1, params);
    itf8_put(value, params);
    itf8_put(1, params);
    itf8_put(0, params);
    itf8_put(3, out);  // E_HUFFMAN
    itf8_put((int64_t)params.size(), out);
    out.insert(out.end(), params.begin(), params.end());
}

static void enc_byte_array_stop(uint8_t stop, int cid,
                                std::vector<uint8_t>& out) {
    std::vector<uint8_t> params;
    params.push_back(stop);
    itf8_put(cid, params);
    itf8_put(5, out);  // E_BYTE_ARRAY_STOP
    itf8_put((int64_t)params.size(), out);
    out.insert(out.end(), params.begin(), params.end());
}

static void enc_byte_array_len(int len_cid, int val_cid,
                               std::vector<uint8_t>& out) {
    std::vector<uint8_t> inner;
    enc_external(len_cid, inner);
    enc_external(val_cid, inner);
    itf8_put(4, out);  // E_BYTE_ARRAY_LEN
    itf8_put((int64_t)inner.size(), out);
    out.insert(out.end(), inner.begin(), inner.end());
}

static int64_t write_container(CramWriterN* w,
                               const std::vector<std::vector<uint8_t>>& blocks,
                               int64_t ref_seq_id, int64_t ref_start,
                               int64_t ref_span, int64_t num_records,
                               int64_t num_bases,
                               const std::vector<int64_t>& landmarks,
                               int64_t counter) {
    int64_t cont_off = (int64_t)ftell(w->f);
    size_t body_n = 0;
    for (auto& b : blocks) body_n += b.size();
    std::vector<uint8_t> head;
    itf8_put(ref_seq_id, head);
    itf8_put(ref_start, head);
    itf8_put(ref_span, head);
    itf8_put(num_records, head);
    ltf8_put(counter, head);
    ltf8_put(num_bases, head);
    itf8_put((int64_t)blocks.size(), head);
    itf8_put((int64_t)landmarks.size(), head);
    for (int64_t lm : landmarks) itf8_put(lm, head);
    int32_t length = (int32_t)body_n;
    uint32_t crc = crc32(0L, (const uint8_t*)&length, 4);
    crc = crc32(crc, head.data(), (uInt)head.size());
    fwrite(&length, 4, 1, w->f);
    fwrite(head.data(), 1, head.size(), w->f);
    fwrite(&crc, 4, 1, w->f);
    for (auto& b : blocks) fwrite(b.data(), 1, b.size(), w->f);
    return cont_off;
}

static const char SEQ_NT16_STR[] = "=ACMGRSVTWYHKDBN";

}  // namespace lps_cram

extern "C" {

void* lps_cram_writer_open(const char* path, const char* header_text,
                           int64_t header_len, const char* fasta_path) {
    using namespace lps_cram;
    auto* w = new CramWriterN();
    w->path = path;
    w->f = fopen(path, "wb");
    if (!w->f) {
        delete w;
        return nullptr;
    }
    if (fasta_path && fasta_path[0]) {
        // tid -> contig name order comes from the SAM header @SQ lines
        std::string hdr(header_text, (size_t)header_len);
        size_t lp = 0;
        while (lp < hdr.size()) {
            size_t le = hdr.find('\n', lp);
            if (le == std::string::npos) le = hdr.size();
            if (hdr.compare(lp, 3, "@SQ") == 0) {
                size_t sp = hdr.find("SN:", lp);
                if (sp != std::string::npos && sp < le) {
                    size_t se = hdr.find('\t', sp);
                    if (se == std::string::npos || se > le) se = le;
                    w->fasta.names.push_back(hdr.substr(sp + 3, se - sp - 3));
                }
            }
            lp = le + 1;
        }
        w->fasta.load_fai(fasta_path);
        w->use_ref = w->fasta.usable && !w->fasta.names.empty();
    }
    // magic + 20-byte file id (tail of the path, NUL-padded)
    fwrite("CRAM\x03\x00", 1, 6, w->f);
    char fid[20] = {0};
    size_t plen = strlen(path);
    const char* tail = path + (plen > 20 ? plen - 20 : 0);
    size_t tlen = strlen(tail);
    memcpy(fid, tail, tlen < 20 ? tlen : 20);
    fwrite(fid, 1, 20, w->f);
    // SAM header container (one RAW FILE_HEADER block)
    std::vector<uint8_t> blob;
    int32_t hl = (int32_t)header_len;
    blob.insert(blob.end(), (uint8_t*)&hl, (uint8_t*)&hl + 4);
    blob.insert(blob.end(), (const uint8_t*)header_text,
                (const uint8_t*)header_text + header_len);
    std::vector<std::vector<uint8_t>> blocks(1);
    encode_block(RAW, CT_FILE_HEADER, 0, blob.data(), blob.size(), blocks[0]);
    write_container(w, blocks, 0, 0, 0, 0, 0, {}, 0);
    return w;
}

// Encode one data container from raw BAM record blobs (all same tid).
static int64_t encode_write_container(lps_cram::CramWriterN* w,
                                      const uint8_t* blob,
                                      const int64_t* rec_off, int64_t n_rec,
                                      int32_t tid, int64_t counter) {
    using namespace lps_cram;
    std::vector<uint8_t> ext[N_SERIES];
    std::vector<uint8_t> rn, sc_len, bb_len, in_len;
    // reference chromosome for X-substitution encoding (one fetch per
    // container; all records share the tid)
    std::shared_ptr<std::string> ref_seq =
        (w->use_ref && tid >= 0) ? w->fasta.get_only(tid) : nullptr;
    const char* refp = ref_seq ? ref_seq->data() : nullptr;
    int64_t ref_n = ref_seq ? (int64_t)ref_seq->size() : 0;
    // OTHERS[r][c] = decoded base for substitution code c against ref row r
    // (identity SM, matching the 0x1B matrix written in the comp header)
    static const char* OTHERS[5] = {"CGTN", "AGTN", "ACTN", "ACGN", "ACGT"};
    std::vector<std::vector<std::pair<std::string, char>>> tag_lists;
    std::map<std::string, std::pair<std::vector<uint8_t>,
                                    std::vector<uint8_t>>> tag_streams;
    std::map<std::string, int64_t> tag_index;  // key: packed TD entry
    int64_t num_bases = 0;
    int64_t min_pos = INT64_MAX, max_end = 0;

    for (int64_t ri = 0; ri < n_rec; ri++) {
        const uint8_t* rec = blob + rec_off[ri];
        int64_t rlen = rec_off[ri + 1] - rec_off[ri];
        int32_t rtid, pos, l_seq, mate_tid, mate_pos, tlen;
        memcpy(&rtid, rec, 4);
        memcpy(&pos, rec + 4, 4);
        uint8_t l_read_name = rec[8];
        uint8_t mapq = rec[9];
        uint16_t n_cigar, flag16;
        memcpy(&n_cigar, rec + 12, 2);
        memcpy(&flag16, rec + 14, 2);
        memcpy(&l_seq, rec + 16, 4);
        memcpy(&mate_tid, rec + 20, 4);
        memcpy(&mate_pos, rec + 24, 4);
        memcpy(&tlen, rec + 28, 4);
        const char* qname = (const char*)(rec + 32);
        const uint8_t* cigar = rec + 32 + l_read_name;
        const uint8_t* seqp = cigar + 4ull * n_cigar;
        const uint8_t* qualp = seqp + (l_seq + 1) / 2;
        size_t aux_off = 32 + l_read_name + 4ull * n_cigar +
                         ((size_t)l_seq + 1) / 2 + l_seq;

        int flag = flag16 & 0xFFF;
        itf8_put(flag, ext[S_BF]);
        itf8_put(CF_DETACHED | CF_QUAL, ext[S_CF]);
        itf8_put(rtid, ext[S_RI]);
        itf8_put(l_seq, ext[S_RL]);
        num_bases += l_seq;
        itf8_put(pos + 1, ext[S_AP]);
        rn.insert(rn.end(), (const uint8_t*)qname,
                  (const uint8_t*)qname + (l_read_name - 1));
        rn.push_back(0);
        int mf = ((flag & BAM_FMREVERSE) ? MATE_REVERSE : 0) |
                 ((flag & BAM_FMUNMAP) ? MATE_UNMAP : 0);
        itf8_put(mf, ext[S_MF]);
        itf8_put(mate_tid, ext[S_NS]);
        itf8_put(mate_pos + 1, ext[S_NP]);
        itf8_put(tlen, ext[S_TS]);

        // aux tags -> TD entry + per-tag streams
        std::string td_key;
        std::vector<std::pair<std::string, char>> tags_here;
        {
            size_t i = aux_off;
            while (i + 3 <= (size_t)rlen) {
                char t0 = (char)rec[i], t1 = (char)rec[i + 1];
                char ty = (char)rec[i + 2];
                i += 3;
                size_t vstart = i;
                switch (ty) {
                    case 'c': case 'C': case 'A': i += 1; break;
                    case 's': case 'S': i += 2; break;
                    case 'i': case 'I': case 'f': i += 4; break;
                    case 'Z': case 'H':
                        while (i < (size_t)rlen && rec[i] != 0) i++;
                        i++;
                        break;
                    case 'B': {
                        char sub = (char)rec[i];
                        uint32_t cnt;
                        memcpy(&cnt, rec + i + 1, 4);
                        int sz = (sub == 'c' || sub == 'C') ? 1
                                 : (sub == 's' || sub == 'S') ? 2 : 4;
                        i += 5 + (size_t)cnt * sz;
                        break;
                    }
                    default:
                        return -1;  // unknown aux type
                }
                if (i > (size_t)rlen) return -1;
                std::string name;
                name += t0;
                name += t1;
                name += ty;
                td_key += name;
                tags_here.emplace_back(name, ty);
                auto& st = tag_streams[name];
                itf8_put((int64_t)(i - vstart), st.first);
                st.second.insert(st.second.end(), rec + vstart, rec + i);
            }
        }
        auto it = tag_index.find(td_key);
        int64_t tl;
        if (it == tag_index.end()) {
            tl = (int64_t)tag_lists.size();
            tag_index[td_key] = tl;
            tag_lists.push_back(tags_here);
        } else {
            tl = it->second;
        }
        itf8_put(tl, ext[S_TL]);

        // sequence (ASCII) + clamped quals
        std::vector<uint8_t> seq(l_seq);
        for (int32_t b = 0; b < l_seq; b++) {
            uint8_t nib = (b & 1) ? (seqp[b >> 1] & 0xF) : (seqp[b >> 1] >> 4);
            seq[b] = (uint8_t)SEQ_NT16_STR[nib];
        }
        for (int32_t b = 0; b < l_seq; b++)
            ext[S_QS].push_back(qualp[b] > 93 ? 93 : qualp[b]);

        if (flag & BAM_FUNMAP) {
            ext[S_BA].insert(ext[S_BA].end(), seq.begin(), seq.end());
            if (pos + 1 < min_pos) min_pos = pos + 1;
            if (pos + 1 > max_end) max_end = pos + 1;
            continue;
        }

        // features covering the whole read (referenceless encoding)
        std::vector<std::pair<char, int64_t>> feats;
        int64_t qpos = 0, ref_adv = 0;
        for (uint16_t ci = 0; ci < n_cigar; ci++) {
            uint32_t cv;
            memcpy(&cv, cigar + 4ull * ci, 4);
            int op = cv & 0xF;
            int64_t ln = cv >> 4;
            switch (op) {
                case 0: case 7: case 8: {
                    // reference-based: only mismatches become X features
                    // (code vs the identity substitution matrix); any base
                    // pair outside ACGTN semantics reverts the whole
                    // segment to a verbatim 'b' run
                    int64_t rstart = (int64_t)pos + ref_adv;
                    bool enc_ok = refp != nullptr && rstart >= 0 &&
                                  rstart + ln <= ref_n;
                    size_t feats_mark = feats.size();
                    size_t bs_mark = ext[S_BS].size();
                    if (enc_ok) {
                        for (int64_t i = 0; i < ln; i++) {
                            uint8_t rc = seq[qpos + i];
                            uint8_t fc2 = (uint8_t)refp[rstart + i];
                            if (NT16[rc] == NT16[fc2]) continue;
                            int ridx = BASE_IDX[fc2];
                            int code = -1;
                            for (int c4 = 0; c4 < 4; c4++)
                                if ((uint8_t)OTHERS[ridx][c4] == rc) {
                                    code = c4;
                                    break;
                                }
                            if (code < 0) { enc_ok = false; break; }
                            feats.emplace_back('X', qpos + 1 + i);
                            ext[S_BS].push_back((uint8_t)code);
                        }
                    }
                    if (!enc_ok) {
                        feats.resize(feats_mark);
                        ext[S_BS].resize(bs_mark);
                        feats.emplace_back('b', qpos + 1);
                        ext[S_BB].insert(ext[S_BB].end(), seq.begin() + qpos,
                                         seq.begin() + qpos + ln);
                        itf8_put(ln, bb_len);
                    }
                    qpos += ln;
                    ref_adv += ln;
                    break;
                }
                case 4:
                    feats.emplace_back('S', qpos + 1);
                    ext[S_SC].insert(ext[S_SC].end(), seq.begin() + qpos,
                                     seq.begin() + qpos + ln);
                    itf8_put(ln, sc_len);
                    qpos += ln;
                    break;
                case 1:
                    feats.emplace_back('I', qpos + 1);
                    ext[S_IN].insert(ext[S_IN].end(), seq.begin() + qpos,
                                     seq.begin() + qpos + ln);
                    itf8_put(ln, in_len);
                    qpos += ln;
                    break;
                case 2:
                    feats.emplace_back('D', qpos + 1);
                    itf8_put(ln, ext[S_DL]);
                    ref_adv += ln;
                    break;
                case 3:
                    feats.emplace_back('N', qpos + 1);
                    itf8_put(ln, ext[S_RS]);
                    ref_adv += ln;
                    break;
                case 5:
                    feats.emplace_back('H', qpos + 1);
                    itf8_put(ln, ext[S_HC]);
                    break;
                case 6:
                    feats.emplace_back('P', qpos + 1);
                    itf8_put(ln, ext[S_PD]);
                    break;
                default:
                    return -1;
            }
        }
        itf8_put((int64_t)feats.size(), ext[S_FN]);
        int64_t prev = 0;
        for (auto& fp2 : feats) {
            ext[S_FC].push_back((uint8_t)fp2.first);
            itf8_put(fp2.second - prev, ext[S_FP]);
            prev = fp2.second;
        }
        itf8_put(mapq, ext[S_MQ]);
        // crai span bookkeeping (bam_endpos semantics)
        int64_t end = n_cigar ? pos + ref_adv : pos + 1;
        if (pos + 1 < min_pos) min_pos = pos + 1;
        if (end > max_end) max_end = end;
    }

    // ---- compression header --------------------------------------------
    std::vector<uint8_t> pres_body;
    itf8_put(5, pres_body);  // 5 preservation entries
    const uint8_t rn_e[] = {'R', 'N', 1};
    const uint8_t ap_e[] = {'A', 'P', 0};
    const uint8_t rr_e[] = {'R', 'R',
                            (uint8_t)(w->use_ref && ref_seq ? 1 : 0)};
    // identity substitution matrix (0x1B rows): OTHERS[r][c] order
    const uint8_t sm_e[] = {'S', 'M', 0x1B, 0x1B, 0x1B, 0x1B, 0x1B};
    pres_body.insert(pres_body.end(), rn_e, rn_e + 3);
    pres_body.insert(pres_body.end(), ap_e, ap_e + 3);
    pres_body.insert(pres_body.end(), rr_e, rr_e + 3);
    pres_body.insert(pres_body.end(), sm_e, sm_e + 7);
    std::vector<uint8_t> td_blob;
    for (auto& key : tag_lists) {
        for (auto& t : key)
            td_blob.insert(td_blob.end(), t.first.begin(), t.first.end());
        td_blob.push_back(0);
    }
    pres_body.push_back('T');
    pres_body.push_back('D');
    itf8_put((int64_t)td_blob.size(), pres_body);
    pres_body.insert(pres_body.end(), td_blob.begin(), td_blob.end());
    std::vector<uint8_t> comp_raw;
    itf8_put((int64_t)pres_body.size(), comp_raw);
    comp_raw.insert(comp_raw.end(), pres_body.begin(), pres_body.end());

    // record encoding map (order mirrors the Python writer)
    std::vector<uint8_t> rec_body;
    int rec_count = 0;
    std::vector<uint8_t> rec_entries;
    auto add_key = [&](const char* k, std::vector<uint8_t>& enc) {
        rec_entries.push_back((uint8_t)k[0]);
        rec_entries.push_back((uint8_t)k[1]);
        rec_entries.insert(rec_entries.end(), enc.begin(), enc.end());
        rec_count++;
    };
    for (int s = 0; s < N_SERIES; s++) {
        const char* k = SERIES[s];
        if (s == S_BA || s == S_SC || s == S_BB || s == S_IN || s == S_QS)
            continue;
        std::vector<uint8_t> e;
        enc_external(cid_of(s), e);
        add_key(k, e);
    }
    {
        std::vector<uint8_t> e;
        enc_huffman_const((int64_t)0xFFFFFFFF, e);
        add_key("RG", e);
        e.clear();
        enc_byte_array_stop(0, CID_RN, e);
        add_key("RN", e);
        e.clear();
        enc_external(cid_of(S_BA), e);
        add_key("BA", e);
        e.clear();
        enc_external(cid_of(S_QS), e);
        add_key("QS", e);
        e.clear();
        enc_byte_array_len(CID_SC_LEN, cid_of(S_SC), e);
        add_key("SC", e);
        e.clear();
        enc_byte_array_len(CID_BB_LEN, cid_of(S_BB), e);
        add_key("BB", e);
        e.clear();
        enc_byte_array_len(CID_IN_LEN, cid_of(S_IN), e);
        add_key("IN", e);
    }
    itf8_put(rec_count, rec_body);
    rec_body.insert(rec_body.end(), rec_entries.begin(), rec_entries.end());
    itf8_put((int64_t)rec_body.size(), comp_raw);
    comp_raw.insert(comp_raw.end(), rec_body.begin(), rec_body.end());

    // tag encoding map (sorted by 3-char name, cids from CID_TAG_BASE)
    std::vector<uint8_t> tag_body;
    itf8_put((int64_t)tag_streams.size(), tag_body);
    int next_cid = CID_TAG_BASE;
    std::map<std::string, std::pair<int, int>> tag_cids;
    for (auto& kv : tag_streams) {
        int len_cid = next_cid, val_cid = next_cid + 1;
        next_cid += 2;
        tag_cids[kv.first] = {len_cid, val_cid};
        const std::string& name = kv.first;
        int64_t keyid = ((int64_t)(uint8_t)name[0] << 16) |
                        ((int64_t)(uint8_t)name[1] << 8) | (uint8_t)name[2];
        itf8_put(keyid, tag_body);
        enc_byte_array_len(len_cid, val_cid, tag_body);
    }
    std::vector<uint8_t> tag_map_sz;
    // tag_body currently holds count + entries; wrap with size prefix
    {
        std::vector<uint8_t> wrapped;
        itf8_put((int64_t)tag_body.size(), wrapped);
        wrapped.insert(wrapped.end(), tag_body.begin(), tag_body.end());
        comp_raw.insert(comp_raw.end(), wrapped.begin(), wrapped.end());
    }

    std::vector<uint8_t> comp_block;
    encode_block(M_GZIP, CT_COMP_HEADER, 0, comp_raw.data(), comp_raw.size(),
                 comp_block);

    // ---- external blocks (encoded across a thread pool) -----------------
    struct BlockJob {
        int cid;
        const std::vector<uint8_t>* payload;
        int prefer;
    };
    std::vector<BlockJob> jobs;
    auto add_block = [&](int cid, const std::vector<uint8_t>& payload,
                         int prefer) {
        if (payload.empty()) return;
        jobs.push_back({cid, &payload, prefer});
    };
    std::vector<uint8_t> core;
    encode_block(RAW, CT_CORE, 0, nullptr, 0, core);
    for (int s = 0; s < N_SERIES; s++) {
        if (s == S_SC || s == S_BB || s == S_IN) continue;
        add_block(cid_of(s), ext[s], M_RANS);
    }
    add_block(CID_RN, rn, M_GZIP);
    add_block(cid_of(S_SC), ext[S_SC], M_RANS);
    add_block(cid_of(S_BB), ext[S_BB], M_RANS);
    add_block(cid_of(S_IN), ext[S_IN], M_RANS);
    for (auto& kv : tag_streams) {
        auto cids = tag_cids[kv.first];
        add_block(cids.first, kv.second.first, M_RANS);
        add_block(cids.second, kv.second.second, M_RANS);
    }
    add_block(CID_SC_LEN, sc_len, M_RANS);
    add_block(CID_BB_LEN, bb_len, M_RANS);
    add_block(CID_IN_LEN, in_len, M_RANS);

    std::vector<std::vector<uint8_t>> data_blocks(jobs.size());
    std::vector<int> content_ids(jobs.size());
    {
        std::atomic<size_t> nexti{0};
        auto workerb = [&]() {
            for (;;) {
                size_t i = nexti.fetch_add(1);
                if (i >= jobs.size()) return;
                encode_block(jobs[i].prefer, CT_EXTERNAL, jobs[i].cid,
                             jobs[i].payload->data(), jobs[i].payload->size(),
                             data_blocks[i]);
                content_ids[i] = jobs[i].cid;
            }
        };
        unsigned nt = std::thread::hardware_concurrency();
        if (nt < 1) nt = 1;
        if (nt > 8) nt = 8;
        if (jobs.size() < 2) nt = 1;
        std::vector<std::thread> th;
        for (unsigned t = 1; t < nt; t++) th.emplace_back(workerb);
        workerb();
        for (auto& t : th) t.join();
    }

    // ---- slice header ---------------------------------------------------
    int64_t ref_start = 0, ref_span = 0;
    if (tid >= 0 && n_rec > 0) {
        ref_start = min_pos == INT64_MAX ? 0 : min_pos;
        ref_span = max_end - ref_start + 1;
        if (ref_span < 0) ref_span = 0;
    }
    std::vector<uint8_t> sh;
    itf8_put(tid, sh);
    itf8_put(ref_start, sh);
    itf8_put(ref_span, sh);
    itf8_put(n_rec, sh);
    ltf8_put(counter, sh);
    itf8_put((int64_t)data_blocks.size() + 1, sh);  // + core block
    itf8_put((int64_t)content_ids.size(), sh);
    for (int cid : content_ids) itf8_put(cid, sh);
    itf8_put((int64_t)0xFFFFFFFF, sh);  // no embedded reference
    for (int i = 0; i < 16; i++) sh.push_back(0);  // MD5 (RR=false)
    std::vector<uint8_t> slice_hdr_block;
    encode_block(RAW, CT_SLICE_HEADER, 0, sh.data(), sh.size(),
                 slice_hdr_block);

    std::vector<std::vector<uint8_t>> blocks;
    blocks.push_back(std::move(comp_block));
    blocks.push_back(std::move(slice_hdr_block));
    blocks.push_back(std::move(core));
    int64_t slice_sz = 0;
    for (size_t i = 1; i < blocks.size(); i++)
        slice_sz += (int64_t)blocks[i].size();
    for (auto& b : data_blocks) {
        slice_sz += (int64_t)b.size();
        blocks.push_back(std::move(b));
    }
    int64_t comp_len = (int64_t)blocks[0].size();
    int64_t cont_off = write_container(w, blocks, tid, ref_start, ref_span,
                                       n_rec, num_bases, {comp_len}, counter);
    w->index.push_back({tid, ref_start, ref_span, cont_off, comp_len,
                        slice_sz});
    (void)tag_map_sz;
    return 0;
}

// Public entry: enqueue the container for the pipelined worker (bounded
// queue depth 2); encode+write happen off the caller thread, in order.
int64_t lps_cram_writer_container(void* wp, const uint8_t* blob,
                                  const int64_t* rec_off, int64_t n_rec,
                                  int32_t tid) {
    using namespace lps_cram;
    auto* w = (CramWriterN*)wp;
    if (!w->started) {
        w->started = true;
        w->worker = std::thread([w]() {
            for (;;) {
                CramWriterN::Job job;
                {
                    std::unique_lock<std::mutex> lk(w->mu);
                    w->cv.wait(lk, [w] { return !w->q.empty() || w->finish; });
                    if (w->q.empty()) return;
                    job = std::move(w->q.front());
                    w->q.pop_front();
                }
                if (encode_write_container(w, job.blob.data(),
                                           job.rec_off.data(),
                                           (int64_t)job.rec_off.size() - 1,
                                           job.tid, job.counter) != 0)
                    w->failed = true;
                w->cv.notify_all();
            }
        });
    }
    CramWriterN::Job job;
    job.blob.assign(blob, blob + rec_off[n_rec]);
    job.rec_off.assign(rec_off, rec_off + n_rec + 1);
    job.tid = tid;
    job.counter = w->counter;
    w->counter += n_rec;
    {
        std::unique_lock<std::mutex> lk(w->mu);
        w->cv.wait(lk, [w] { return w->q.size() < 2; });
        if (w->failed) return -1;
        w->q.push_back(std::move(job));
    }
    w->cv.notify_all();
    return 0;
}

int64_t lps_cram_writer_close(void* wp) {
    using namespace lps_cram;
    auto* w = (CramWriterN*)wp;
    if (w->started) {
        {
            std::unique_lock<std::mutex> lk(w->mu);
            w->finish = true;
        }
        w->cv.notify_all();
        w->worker.join();
    }
    if (w->failed) {
        fclose(w->f);
        delete w;
        return -1;
    }
    static const uint8_t EOFC[38] = {
        0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
        0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
        0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
        0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b};
    fwrite(EOFC, 1, 38, w->f);
    fclose(w->f);
    w->f = nullptr;
    // .crai companion (gzipped text)
    std::string crai;
    char line[256];
    for (auto& e : w->index) {
        snprintf(line, sizeof(line),
                 "%lld\t%lld\t%lld\t%lld\t%lld\t%lld\n", (long long)e.tid,
                 (long long)e.start, (long long)e.span, (long long)e.coff,
                 (long long)e.soff, (long long)e.ssz);
        crai += line;
    }
    std::vector<uint8_t> gz;
    int64_t ok = 0;
    if (gzip_compress_buf((const uint8_t*)crai.data(), crai.size(), 6, gz)) {
        FILE* cf = fopen((w->path + ".crai").c_str(), "wb");
        if (cf) {
            ok = fwrite(gz.data(), 1, gz.size(), cf) == gz.size() ? 0 : -1;
            fclose(cf);
        } else {
            ok = -1;
        }
    } else {
        ok = -1;
    }
    delete w;
    return ok;
}

}  // extern "C"

namespace lps_cram {

}  // namespace lps_cram

extern "C" {

void* lps_cram_decode(const char* path, const char* fasta_path,
                      const int64_t* offsets, int64_t n_offsets,
                      int32_t n_threads) {
    return lps_cram::decode_file(path, fasta_path, offsets, n_offsets,
                                 n_threads);
}

int64_t lps_cram_sizes(void* rp, int64_t* blob_len, int64_t* n_rec) {
    auto* r = (lps_cram::CramResult*)rp;
    *blob_len = r->blob_len;
    *n_rec = (int64_t)r->rec_off.size() - 1;
    return 0;
}

int64_t lps_cram_fill(void* rp, uint8_t* blob, int64_t* rec_off) {
    auto* r = (lps_cram::CramResult*)rp;
    size_t off = 0;
    for (auto& o : r->outs) {
        memcpy(blob + off, o.blob.data(), o.blob.size());
        off += o.blob.size();
    }
    memcpy(rec_off, r->rec_off.data(), r->rec_off.size() * sizeof(int64_t));
    return 0;
}

void lps_cram_free(void* rp) { delete (lps_cram::CramResult*)rp; }

// zero-copy accessors so lps_ingest.cpp can synthesize a BAM handle from a
// decode result without round-tripping the record blob through Python
int64_t lps_cram_header_text(void* rp, const char** txt) {
    auto* r = (lps_cram::CramResult*)rp;
    *txt = r->header_text.data();
    return (int64_t)r->header_text.size();
}

int64_t lps_cram_n_refs(void* rp) {
    return (int64_t)((lps_cram::CramResult*)rp)->ref_names.size();
}

int64_t lps_cram_ref(void* rp, int64_t i, const char** name,
                     int64_t* name_len) {
    auto* r = (lps_cram::CramResult*)rp;
    *name = r->ref_names[i].data();
    *name_len = (int64_t)r->ref_names[i].size();
    return i < (int64_t)r->ref_lens.size() ? r->ref_lens[i] : 0;
}

int64_t lps_cram_n_containers(void* rp) {
    return (int64_t)((lps_cram::CramResult*)rp)->outs.size();
}

int64_t lps_cram_container(void* rp, int64_t i, const uint8_t** blob,
                           int64_t* blob_len, const int64_t** sizes) {
    auto* r = (lps_cram::CramResult*)rp;
    auto& o = r->outs[i];
    *blob = o.blob.data();
    *blob_len = (int64_t)o.blob.size();
    *sizes = o.rec_sizes.data();
    return (int64_t)o.rec_sizes.size();
}

}  // extern "C"
