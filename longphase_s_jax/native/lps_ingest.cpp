// lps_ingest — native host runtime for longphase_s_jax.
//
// BGZF + BAM decoding and the phase allele-extraction CIGAR walk
// (behavioral contract: BamParser::get_snp, reference ParsingBam.cpp:1303-1634
// — reimplemented from the SAM/BAM spec and the documented walk semantics,
// no htslib code). Emits flat observation arrays ready for the packing layer.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC lps_ingest.cpp -o liblps.so -lz
//
// C ABI for ctypes.

#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <unordered_map>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <malloc.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <thread>
#include <vector>

// On this class of VM (Firecracker-style) minor page faults can cost tens
// of microseconds: glibc munmap()ing each multi-MB buffer and re-faulting
// it on the next call made identical runs swing 1s <-> 10s+ (pure system
// time). Keep large allocations on the heap and never trim, so transient
// decode/compress buffers are reused across calls. LPS_NO_MALLOC_TUNING=1
// opts out (restores default trim behavior).
__attribute__((constructor)) static void lps_malloc_tuning() {
  if (getenv("LPS_NO_MALLOC_TUNING")) return;
  // thresholds above any whole-file handle image (~hundreds of MB): a
  // 450 MB buffer that crosses M_MMAP_THRESHOLD gets munmap()ed on free
  // and re-faulted page-by-page on the next run — exactly the churn this
  // ctor exists to avoid
  mallopt(M_MMAP_THRESHOLD, INT32_MAX);
  mallopt(M_TRIM_THRESHOLD, INT32_MAX);
  mallopt(M_ARENA_MAX, 4);  // one arena per decode thread on this 4-vCPU VM
}

namespace {

struct Buf {
  std::vector<uint8_t> data;
};

// Huge-buffer depot: GB-scale buffers (whole-file BAM images, CRAM handle
// blobs) cycle through mmap'd MADV_HUGEPAGE slots that are RETAINED across
// frees. glibc's heap cannot guarantee that a freed GB block's pages serve
// the next GB malloc (arena/fragmentation ping-pong re-faults the whole
// range — ~1s per load on this VM class); the depot makes reuse
// deterministic: after the first load, prefault over a depot slot is a
// no-op page walk.
static bool thp_worth_it();

struct DepotSlot {
  void* p;
  size_t cap;
};
static std::mutex depot_mu;
static std::vector<DepotSlot> depot_free_slots;
static std::unordered_map<void*, size_t> depot_live;  // ptr -> true mmap cap
static const size_t DEPOT_MIN = 64u << 20;   // route allocations >= 64 MB
static const size_t DEPOT_KEEP = 4;          // retained free slots

static void* depot_alloc(size_t bytes) {
  size_t want = (bytes + (2u << 20) - 1) & ~(size_t)((2u << 20) - 1);
  {
    std::lock_guard<std::mutex> lk(depot_mu);
    int best = -1;
    for (int i = 0; i < (int)depot_free_slots.size(); ++i) {
      if (depot_free_slots[i].cap >= want &&
          (best < 0 || depot_free_slots[i].cap < depot_free_slots[best].cap))
        best = i;
    }
    if (best >= 0) {
      DepotSlot s = depot_free_slots[best];
      depot_free_slots.erase(depot_free_slots.begin() + best);
      depot_live[s.p] = s.cap;
      return s.p;
    }
  }
  void* p = mmap(nullptr, want, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return nullptr;
#ifdef MADV_HUGEPAGE
  if (thp_worth_it()) madvise(p, want, MADV_HUGEPAGE);
#endif
  std::lock_guard<std::mutex> lk(depot_mu);
  depot_live[p] = want;
  return p;
}

// Returns false if p was not depot-allocated (caller frees via the heap).
static bool depot_free(void* p) {
  std::lock_guard<std::mutex> lk(depot_mu);
  auto it = depot_live.find(p);
  if (it == depot_live.end()) return false;
  size_t cap = it->second;
  depot_live.erase(it);
  if (depot_free_slots.size() < DEPOT_KEEP) {
    depot_free_slots.push_back({p, cap});
    return true;
  }
  // evict the smallest retained slot if this one is bigger (keep the
  // biggest working set resident), else drop the incoming one
  int smallest = 0;
  for (int i = 1; i < (int)depot_free_slots.size(); ++i)
    if (depot_free_slots[i].cap < depot_free_slots[smallest].cap)
      smallest = i;
  if (depot_free_slots[smallest].cap < cap) {
    munmap(depot_free_slots[smallest].p, depot_free_slots[smallest].cap);
    depot_free_slots[smallest] = {p, cap};
  } else {
    munmap(p, cap);
  }
  return true;
}

// Allocator that skips value-initialization: resize() on a GB-scale buffer
// must not memset memory that the very next step overwrites in full.
// Huge allocations come from the depot above.
template <typename T>
struct NoInitAlloc {
  using value_type = T;
  NoInitAlloc() = default;
  template <class U>
  NoInitAlloc(const NoInitAlloc<U>&) {}
  T* allocate(size_t n) {
    if (sizeof(T) == 1 && n >= DEPOT_MIN) {
      void* p = depot_alloc(n);
      if (p) return (T*)p;
    }
    return std::allocator<T>().allocate(n);
  }
  void deallocate(T* p, size_t n) {
    if (sizeof(T) == 1 && n >= DEPOT_MIN && depot_free((void*)p)) return;
    std::allocator<T>().deallocate(p, n);
  }
  template <class U>
  void construct(U* p) noexcept {
    ::new (static_cast<void*>(p)) U;
  }
  template <class U, class... Args>
  void construct(U* p, Args&&... args) {
    ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
  template <class U>
  bool operator==(const NoInitAlloc<U>&) const {
    return true;
  }
  template <class U>
  bool operator!=(const NoInitAlloc<U>&) const {
    return false;
  }
};
using ByteBuf = std::vector<uint8_t, NoInitAlloc<uint8_t>>;

// --- stage timing (LPS_TIMING=1 prints native phase walls to stderr) ------
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

// Ask the kernel for 2 MB THP backing on a large anonymous range: one fault
// then populates 512 pages at once, so the fault count (the expensive part
// on this VM class) drops 512x. No-op when THP is unavailable or the range
// is small; the caller's per-4KB touch loop stays correct either way.
// THP is only a win when hugepage faults are actually cheap. Under some
// hypervisors MADV_HUGEPAGE faulting runs an order of magnitude SLOWER
// than plain 4K demand faulting (synchronous per-2MB compaction, ~11 ms a
// page measured on this VM class: 0.2 GB/s vs 1.8 GB/s) — probe once with
// an 8 MB touch of each kind and only advise when huge wins.
// LPS_THP: any value other than "0" forces on, "0" forces off.
static bool thp_worth_it() {
#ifdef MADV_HUGEPAGE
  // atomic memo: depot_alloc callers can probe concurrently (a duplicate
  // probe is harmless, a torn read of a plain int is formally a race)
  static std::atomic<int> memo{-1};
  int v = memo.load(std::memory_order_relaxed);
  if (v >= 0) return v;
  const char* env = getenv("LPS_THP");
  if (env) {
    v = (env[0] != '0');
    memo.store(v, std::memory_order_relaxed);
    return v;
  }
  const size_t n = 8u << 20;
  auto probe = [&](bool huge) -> double {
    void* p = mmap(nullptr, n, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return 0.0;
    if (huge) madvise(p, n, MADV_HUGEPAGE);
    auto t0 = std::chrono::steady_clock::now();
    for (size_t q = 0; q < n; q += 4096) ((volatile char*)p)[q] = 0;
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    munmap(p, n);
    return dt;
  };
  double plain = probe(false);
  double huge = probe(true);
  v = (plain > 0 && huge > 0 && huge < plain * 1.5) ? 1 : 0;
  memo.store(v, std::memory_order_relaxed);
  return v;
#else
  return false;
#endif
}

static void madvise_huge(void* p, size_t n) {
#ifdef MADV_HUGEPAGE
  if (!thp_worth_it()) return;
  uintptr_t a = (uintptr_t)p;
  uintptr_t lo = (a + 4095) & ~(uintptr_t)4095;
  uintptr_t hi = (a + n) & ~(uintptr_t)4095;
  if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
#else
  (void)p;
  (void)n;
#endif
}

// Fault-in a heap block of ~n bytes across threads BEFORE a big vector
// allocation: malloc doesn't touch pages, one write per page from N
// threads faults them in parallel, and free keeps them resident (the
// ctor above disables trim) so the vector's own allocation reuses them.
// On this VM minor faults cost ~10us — a serial GB-sized resize() is
// seconds of pure fault time without this. THP (madvise_huge) cuts the
// fault count itself 512x where available.
static void prefault_parallel(size_t n) {
  if (n < (8u << 20)) return;  // not worth thread spawns below ~8 MB
  static int off = -1;
  if (off < 0) off = getenv("LPS_NO_PREFAULT") ? 1 : 0;
  if (off) return;
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 2) return;
  if (nt > 8) nt = 8;
  PhaseTimer tm("prefault_parallel");
  uint8_t* warm = (uint8_t*)malloc(n + 4096);
  if (!warm) return;
  madvise_huge(warm, n + 4096);
  std::vector<std::thread> ts;
  size_t per = (n / nt + 4095) & ~(size_t)4095;
  for (unsigned t = 0; t < nt; ++t) {
    ts.emplace_back([warm, n, per, t]() {
      size_t lo = t * per, hi = std::min(n, lo + per);
      for (size_t p = lo; p < hi; p += 4096) warm[p] = 0;
    });
  }
  for (auto& th : ts) th.join();
  free(warm);
}

// Fault-in the EXACT buffer that will be filled (after reserve, before the
// fill): no reliance on malloc handing back the same pages. Overwrites the
// touched bytes with 0 — callers fill the whole range right after.
static void prefault_range(uint8_t* p, size_t n) {
  if (!p || n == 0) return;
  madvise_huge(p, n);
  static int off = -1;
  if (off < 0) off = getenv("LPS_NO_PREFAULT") ? 1 : 0;
  if (off || n < (8u << 20)) return;
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 2) {
    return;
  }
  if (nt > 8) nt = 8;
  PhaseTimer tm("prefault_range");
  std::vector<std::thread> ts;
  size_t per = (n / nt + 4095) & ~(size_t)4095;
  for (unsigned t = 0; t < nt; ++t) {
    ts.emplace_back([p, n, per, t]() {
      size_t lo = t * per, hi = std::min(n, lo + per);
      for (size_t q = lo; q < hi; q += 4096) p[q] = 0;
    });
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------- BGZF ----
static bool inflate_block(const uint8_t* src, size_t src_len, size_t& consumed,
                          std::vector<uint8_t>& out) {
  if (src_len < 28 || src[0] != 0x1f || src[1] != 0x8b) return false;
  uint16_t xlen = src[10] | (src[11] << 8);
  size_t extra_off = 12;
  size_t bsize = 0;
  size_t off = 0;
  while (off + 4 <= xlen) {
    uint8_t si1 = src[extra_off + off], si2 = src[extra_off + off + 1];
    uint16_t slen = src[extra_off + off + 2] | (src[extra_off + off + 3] << 8);
    if (si1 == 66 && si2 == 67 && slen == 2) {
      bsize = (src[extra_off + off + 4] | (src[extra_off + off + 5] << 8)) + 1;
    }
    off += 4 + slen;
  }
  if (bsize == 0 || bsize > src_len) return false;
  size_t cdata_off = 12 + xlen;
  size_t cdata_len = bsize - 12 - xlen - 8;
  uint32_t isize;
  memcpy(&isize, src + bsize - 4, 4);
  size_t prev = out.size();
  out.resize(prev + isize);
  if (isize > 0) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, -15);
    zs.next_in = const_cast<uint8_t*>(src + cdata_off);
    zs.avail_in = (uInt)cdata_len;
    zs.next_out = out.data() + prev;
    zs.avail_out = isize;
    int r = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (r != Z_STREAM_END && r != Z_OK) return false;
  }
  consumed = bsize;
  return true;
}

// Parallel BGZF inflate: scan block boundaries + ISIZEs (cheap header reads),
// prefix-sum uncompressed offsets, then inflate blocks across threads.
static bool read_entire_bgzf(const char* path, ByteBuf& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  ByteBuf raw((size_t)fsize);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return false;
  }
  fclose(f);

  struct Blk {
    size_t coff, clen, uoff, ulen;
  };
  std::vector<Blk> blocks;
  size_t pos = 0;
  size_t total_u = 0;
  while (pos + 28 <= raw.size()) {
    const uint8_t* src = raw.data() + pos;
    if (src[0] != 0x1f || src[1] != 0x8b) return false;
    uint16_t xlen = src[10] | (src[11] << 8);
    size_t bsize = 0, off = 0;
    while (off + 4 <= xlen) {
      uint8_t si1 = src[12 + off], si2 = src[12 + off + 1];
      uint16_t slen = src[12 + off + 2] | (src[12 + off + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2)
        bsize = (src[12 + off + 4] | (src[12 + off + 5] << 8)) + 1;
      off += 4 + slen;
    }
    if (bsize == 0 || pos + bsize > raw.size()) return false;
    uint32_t isize;
    memcpy(&isize, src + bsize - 4, 4);
    blocks.push_back({pos, bsize, total_u, isize});
    total_u += isize;
    pos += bsize;
  }
  out.reserve(total_u);
  out.resize(total_u);  // no memset: NoInitAlloc — blocks cover every byte
  prefault_range(out.data(), total_u);

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  std::atomic<size_t> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
#ifdef USE_LIBDEFLATE
    // libdeflate one-shot raw-deflate decode: ~2-3x zlib's inflate, and the
    // per-block ISIZE gives the exact output size it wants.
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load()) break;
      const Blk& b = blocks[i];
      if (b.ulen == 0) continue;
      const uint8_t* src = raw.data() + b.coff;
      uint16_t xlen = src[10] | (src[11] << 8);
      size_t actual = 0;
      if (libdeflate_deflate_decompress(d, src + 12 + xlen,
                                        b.clen - 12 - xlen - 8,
                                        out.data() + b.uoff, b.ulen,
                                        &actual) != LIBDEFLATE_SUCCESS ||
          actual != b.ulen)
        failed.store(true);
    }
    libdeflate_free_decompressor(d);
#else
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load()) return;
      const Blk& b = blocks[i];
      if (b.ulen == 0) continue;
      const uint8_t* src = raw.data() + b.coff;
      uint16_t xlen = src[10] | (src[11] << 8);
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      inflateInit2(&zs, -15);
      zs.next_in = const_cast<uint8_t*>(src + 12 + xlen);
      zs.avail_in = (uInt)(b.clen - 12 - xlen - 8);
      zs.next_out = out.data() + b.uoff;
      zs.avail_out = (uInt)b.ulen;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END && r != Z_OK) failed.store(true);
    }
#endif
  };
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  return !failed.load();
}

// ------------------------------------------------------------- helpers ----
static inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}
static inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";

// Util.cpp:21-54 homopolymerLength (cap 10)
static int homopolymer_length(int64_t pos, const char* ref, int64_t ref_len) {
  int length = 1;
  if (pos + 1 >= ref_len) return length;
  char e = ref[pos];
  int64_t p = pos - 1;
  while (p >= 0 && ref[p] == e) {
    --p;
    ++length;
    if (length >= 10) break;
  }
  p = pos + 1;
  while (p < ref_len && ref[p] == e) {
    ++p;
    ++length;
    if (length >= 10) break;
  }
  return length;
}

struct ExtractResult {
  // per-observation
  std::vector<int64_t> obs_pos;
  std::vector<int8_t> obs_allele;
  std::vector<int16_t> obs_qual;
  // per-alignment
  std::vector<int64_t> aln_offsets;  // size A+1
  std::vector<int32_t> aln_start;
  std::vector<int64_t> name_offsets;  // size A+1
  std::string names;
  // clip events: (pos, front/back)
  std::vector<int64_t> clip_pos;
  std::vector<int8_t> clip_side;
};

}  // namespace

extern "C" {

// Pass-2 walk over precomputed record offsets; shared by the path-based and
// handle-based entry points.
// Full get_snp walk over precomputed record offsets, shared by the
// path-based and handle-based entry points. Mirrors the object walker
// core/alleles.AlleleExtractor.process_record (ParsingBam.cpp:1321-1434)
// exactly, including the SV / MOD head interleave:
//  - heads: SNP at var_pos[vi], SV at sv_start[si]-1, MOD at mod_pos[mi];
//    the minimal head below the current op limit is consumed each round,
//  - SV allele 1 iff an I/D op within +-sv_window cigar ops has
//    |sv_region - oplen|/|sv_region| < sv_threshold,
//  - MOD observation emitted iff this read has an entry for the site with
//    matching strand AND mod_pos < stale_v, where stale_v reproduces the
//    reference's unguarded *map::end() read (libstdc++ node count == number
//    of SNPs) that silently drops mods past the last SNP,
//  - sentinel quals: -1 SV, -2/-3 MOD fwd/rev, -4 indel, -5 danger indel.
static ExtractResult* phase_walk(
    const uint8_t* bam, const std::vector<size_t>& rec_offsets,
    int64_t n_var, const int64_t* var_pos, const char* var_ref0,
    const char* var_alt0, const int32_t* var_ref_len,
    const int32_t* var_alt_len, const uint8_t* var_danger,
    const char* ref_string, int64_t ref_len,
    // SV stream (sorted by start)
    int64_t n_sv = 0, const int64_t* sv_start = nullptr,
    const int64_t* sv_len = nullptr,
    // MOD stream (sorted by position) with per-site read-name entries
    int64_t n_mod = 0, const int64_t* mod_pos_arr = nullptr,
    const int64_t* mod_entry_off = nullptr,
    const char* mod_names_blob = nullptr,
    const int64_t* mod_name_off = nullptr, const uint8_t* mod_flags = nullptr,
    int32_t sv_window = 20, double sv_threshold = 0.1) {
  auto* res = new ExtractResult();
  res->aln_offsets.push_back(0);
  res->name_offsets.push_back(0);

  // per-MOD-site read-name lookup (flags: bit0 entry_rev, bit1 is_modify)
  std::vector<std::unordered_map<std::string, uint8_t>> mod_maps(n_mod);
  for (int64_t i = 0; i < n_mod; ++i) {
    for (int64_t e = mod_entry_off[i]; e < mod_entry_off[i + 1]; ++e)
      mod_maps[i].emplace(
          std::string(mod_names_blob + mod_name_off[e],
                      (size_t)(mod_name_off[e + 1] - mod_name_off[e])),
          mod_flags[e]);
  }

  // walk records in parallel chunks (the stateful first*Iter values are
  // pure functions of the record start position: lower_bound(stream, pos),
  // so chunks are independent).
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (rec_offsets.size() < 256) n_threads = 1;
  std::vector<ExtractResult> parts(n_threads);
  size_t chunk = (rec_offsets.size() + n_threads - 1) / n_threads;

  // LPS_GUARD_MOD_END=1 selects the guarded behavior (keep mods past the
  // last SNP); default emulates libstdc++'s *map::end() node-count read
  // (read per walk so tests can toggle it within one process)
  const int64_t stale_end = getenv("LPS_GUARD_MOD_END") != nullptr
                                ? (int64_t(1) << 62)
                                : n_var;

  auto walk_range = [&](size_t begin, size_t end, ExtractResult* out_r) {
    int64_t first_idx = 0, first_sv = 0, first_mod = 0;
    const int64_t BIG = int64_t(1) << 60;
    for (size_t ri = begin; ri < end; ++ri) {
      const uint8_t* rec = &bam[rec_offsets[ri]];
      int32_t pos = rd_i32(rec + 4);
      uint8_t l_read_name = rec[8];
      uint16_t n_cigar = rd_u16(rec + 12);
      uint16_t flag = rd_u16(rec + 14);
      int32_t l_seq = rd_i32(rec + 16);
      const char* qname = (const char*)(rec + 32);
      const uint8_t* cigar = rec + 32 + l_read_name;
      const uint8_t* seq = cigar + 4ull * n_cigar;
      const uint8_t* qual = seq + (l_seq + 1) / 2;
      bool is_rev = (flag & 0x10) != 0;
      std::string qname_s;
      if (n_mod) qname_s.assign(qname, l_read_name - 1);
      ExtractResult* res2 = out_r;

      while (first_idx < n_var && var_pos[first_idx] < pos) ++first_idx;
      while (first_sv < n_sv && sv_start[first_sv] < pos) ++first_sv;
      while (first_mod < n_mod && mod_pos_arr[first_mod] < pos) ++first_mod;
      int64_t vi = first_idx, si = first_sv, mi = first_mod;

      int64_t obs_begin = (int64_t)res2->obs_pos.size();
      int64_t ref_pos = pos;
      int64_t query_pos = 0;
      bool discarded = false;

      auto emit = [&](int64_t p, int8_t a, int16_t q) {
        res2->obs_pos.push_back(p);
        res2->obs_allele.push_back(a);
        res2->obs_qual.push_back(q);
      };
      auto discard = [&]() {
        res2->obs_pos.resize(obs_begin);
        res2->obs_allele.resize(obs_begin);
        res2->obs_qual.resize(obs_begin);
        discarded = true;
      };
      auto base_at = [&](int64_t qp) -> char {
        uint8_t nib = (qp & 1) ? (seq[qp >> 1] & 0xF) : (seq[qp >> 1] >> 4);
        return SEQ_NT16[nib];
      };

      for (uint32_t ci = 0; ci < n_cigar && !discarded; ++ci) {
        uint32_t cv = rd_u32(cigar + 4ull * ci);
        int op = cv & 0xF;
        int64_t oplen = cv >> 4;
        while (vi < n_var && var_pos[vi] < ref_pos) ++vi;

        // three-way head loop (ParsingBam.cpp:1350-1434)
        for (;;) {
          int64_t m = mi < n_mod ? mod_pos_arr[mi] : BIG;
          int64_t s = si < n_sv ? sv_start[si] - 1 : BIG;
          int64_t v = vi < n_var ? var_pos[vi] : BIG;
          int64_t limit = ref_pos + oplen;
          if (!(m < limit || s < limit || v < limit)) break;

          if (mi < n_mod && m < v && m < s) {
            // modification head is minimal (ParsingBam.cpp:1373-1395)
            int64_t stale_v = vi < n_var ? var_pos[vi] : stale_end;
            auto it = mod_maps[mi].find(qname_s);
            if (it != mod_maps[mi].end() && m < stale_v) {
              bool entry_rev = it->second & 1;
              bool is_modify = it->second & 2;
              if (entry_rev == is_rev)
                emit(m, is_modify ? 0 : 1, is_rev ? -3 : -2);
            }
            ++mi;
          } else if (si < n_sv && s < v && s < m) {
            // SV head is minimal (ParsingBam.cpp:1397-1434)
            int8_t allele = 0;
            int64_t sv_end = sv_start[si] + (sv_len[si] < 0 ? -sv_len[si]
                                                            : sv_len[si]);
            int64_t sv_region = sv_end - sv_start[si] + 1;
            int64_t j0 = (int64_t)ci - sv_window;
            if (j0 < 0) j0 = 0;
            int64_t j1 = (int64_t)ci + sv_window;
            if (j1 > n_cigar) j1 = n_cigar;
            for (int64_t j = j0; j < j1; ++j) {
              uint32_t jcv = rd_u32(cigar + 4ull * j);
              int jop = jcv & 0xF;
              int64_t joplen = jcv >> 4;
              if ((jop == 1 || jop == 2) &&
                  (double)(sv_region - joplen < 0 ? joplen - sv_region
                                                  : sv_region - joplen) /
                          (double)(sv_region < 0 ? -sv_region : sv_region) <
                      sv_threshold) {
                allele = 1;
                break;
              }
            }
            emit(s, allele, -1);
            ++si;
          } else if (vi < n_var && v < s && v < m) {
            if (op == 0 || op == 7 || op == 8) {
              int64_t offset = v - ref_pos;
              int16_t base_q = 0;
              int8_t allele = -1;
              if (query_pos + offset + 1 > l_seq) {
                discard();  // whole-alignment discard (ParsingBam.cpp:1453)
                break;
              }
              int rl = var_ref_len[vi], al = var_alt_len[vi];
              if (rl == 1 && al == 1) {
                char base = base_at(query_pos + offset);
                if (base == var_ref0[vi])
                  allele = 0;
                else if (base == var_alt0[vi])
                  allele = 1;
                base_q = qual[query_pos + offset];
              }
              if (rl == 1 && al != 1 && ci + 1u < n_cigar) {  // insertion
                uint32_t nv = rd_u32(cigar + 4ull * (ci + 1));
                allele = (ref_pos + oplen - 1 == v && (nv & 0xF) == 1) ? 1 : 0;
                base_q = var_danger[vi] ? -5 : -4;
              }
              if (rl != 1 && al == 1 && ci + 1u < n_cigar) {  // deletion
                uint32_t nv = rd_u32(cigar + 4ull * (ci + 1));
                allele = (ref_pos + oplen - 1 == v && (nv & 0xF) == 2) ? 1 : 0;
                base_q = var_danger[vi] ? -5 : -4;
              }
              if (allele != -1) emit(v, allele, base_q);
              ++vi;
            } else {
              break;  // var head under a non-M op: handled by op advance
            }
          } else {
            break;  // equal heads cannot occur (distinct site streams)
          }
        }
        if (discarded) break;

        // advance by op (ParsingBam.cpp:1531-1628)
        if (op == 0 || op == 7 || op == 8) {  // M/=/X
          query_pos += oplen;
          ref_pos += oplen;
        } else if (op == 1) {  // I
          query_pos += oplen;
        } else if (op == 2) {  // D
          if (ref_len > 0 && vi < n_var) {
            int64_t vpos = var_pos[vi];
            if (ref_pos + oplen + 1 == vpos) {
              // reference's empty special case
            } else if (vpos >= ref_pos && vpos < ref_pos + oplen) {
              if (homopolymer_length(vpos, ref_string, ref_len) >= 3) {
                int rl = var_ref_len[vi], al = var_alt_len[vi];
                int16_t base_q = 0;
                if (query_pos + 1 > l_seq) {
                  discard();
                  break;
                }
                int8_t allele = -1;
                if (rl == 1 && al == 1) {
                  char base = base_at(query_pos);
                  if (base == var_ref0[vi])
                    allele = 0;
                  else if (base == var_alt0[vi])
                    allele = 1;
                  base_q = qual[query_pos];
                } else if (rl != 1 && al == 1) {
                  allele = 1;
                  base_q = -4;
                }
                if (allele != -1) {
                  emit(vpos, allele, base_q);
                  ++vi;
                }
              }
            }
          }
          ref_pos += oplen;
        } else if (op == 3) {  // N
          ref_pos += oplen;
        } else if (op == 4) {  // S
          query_pos += oplen;
          if (oplen > 5) {
            res2->clip_pos.push_back(ref_pos);
            res2->clip_side.push_back(ci == 0 ? 0 : 1);
          }
        } else if (op == 5) {  // H
          if (oplen > 5) {
            res2->clip_pos.push_back(ref_pos);
            res2->clip_side.push_back(ci == 0 ? 0 : 1);
          }
        } else if (op == 6) {  // P
        } else {
          // unsupported op: reference exits; skip record conservatively
          discard();
        }
      }

      if (!discarded && (int64_t)res2->obs_pos.size() > obs_begin) {
        res2->aln_offsets.push_back((int64_t)res2->obs_pos.size());
        res2->aln_start.push_back(pos);
        res2->names.append(qname, l_read_name - 1);
        res2->name_offsets.push_back((int64_t)res2->names.size());
      } else if (!discarded) {
        // alignment emitted nothing: dropped (matches variantVec gate)
        res2->obs_pos.resize(obs_begin);
        res2->obs_allele.resize(obs_begin);
        res2->obs_qual.resize(obs_begin);
      }
    }
  };

  for (auto& part : parts) {
    part.aln_offsets.push_back(0);
    part.name_offsets.push_back(0);
  }
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) {
    size_t b = t * chunk;
    size_t e = std::min(rec_offsets.size(), (t + 1) * chunk);
    if (b < e) ts.emplace_back(walk_range, b, e, &parts[t]);
  }
  walk_range(0, std::min(rec_offsets.size(), chunk), &parts[0]);
  for (auto& t : ts) t.join();

  for (auto& part : parts) {
    int64_t obs_base = (int64_t)res->obs_pos.size();
    int64_t name_base = (int64_t)res->names.size();
    res->obs_pos.insert(res->obs_pos.end(), part.obs_pos.begin(),
                        part.obs_pos.end());
    res->obs_allele.insert(res->obs_allele.end(), part.obs_allele.begin(),
                           part.obs_allele.end());
    res->obs_qual.insert(res->obs_qual.end(), part.obs_qual.begin(),
                         part.obs_qual.end());
    for (size_t i = 1; i < part.aln_offsets.size(); ++i)
      res->aln_offsets.push_back(part.aln_offsets[i] + obs_base);
    res->aln_start.insert(res->aln_start.end(), part.aln_start.begin(),
                          part.aln_start.end());
    for (size_t i = 1; i < part.name_offsets.size(); ++i)
      res->name_offsets.push_back(part.name_offsets[i] + name_base);
    res->names += part.names;
    res->clip_pos.insert(res->clip_pos.end(), part.clip_pos.begin(),
                         part.clip_pos.end());
    res->clip_side.insert(res->clip_side.end(), part.clip_side.begin(),
                          part.clip_side.end());
  }
  return res;
}

// Opaque handle API
void* lps_extract_phase(const char* bam_path, const char* chrom,
                        int64_t last_snp_pos,
                        // variant table (sorted by position)
                        int64_t n_var, const int64_t* var_pos,
                        const char* var_ref0, const char* var_alt0,
                        const int32_t* var_ref_len, const int32_t* var_alt_len,
                        const uint8_t* var_danger,
                        // reference window string
                        const char* ref_string, int64_t ref_len,
                        int32_t mapping_quality) {
  ByteBuf bam;
  if (!read_entire_bgzf(bam_path, bam)) return nullptr;
  if (bam.size() < 12 || memcmp(bam.data(), "BAM\1", 4) != 0) return nullptr;
  size_t p = 4;
  int32_t l_text = rd_i32(&bam[p]);
  p += 4 + (size_t)l_text;
  int32_t n_ref = rd_i32(&bam[p]);
  p += 4;
  int32_t tid = -1;
  for (int32_t i = 0; i < n_ref; ++i) {
    int32_t l_name = rd_i32(&bam[p]);
    p += 4;
    if (strncmp((const char*)&bam[p], chrom, l_name - 1) == 0 &&
        (int64_t)strlen(chrom) == l_name - 1)
      tid = i;
    p += (size_t)l_name + 4;
  }
  std::vector<size_t> rec_offsets;
  if (tid >= 0) {
    // Pass 1: collect record offsets for this chromosome (cheap hops).
    while (p + 4 <= bam.size()) {
      int32_t block_size = rd_i32(&bam[p]);
      size_t rp = p + 4;
      p = rp + (size_t)block_size;
      if (p > bam.size()) break;
      const uint8_t* rec = &bam[rp];
      int32_t rec_tid = rd_i32(rec);
      if (rec_tid != tid) {
        if (rec_tid > tid && rec_tid != -1) break;
        continue;
      }
      int32_t pos = rd_i32(rec + 4);
      if (pos >= last_snp_pos) break;
      uint8_t mapq = rec[9];
      uint16_t flag = rd_u16(rec + 14);
      if (mapq < mapping_quality || (flag & 0x4) || (flag & 0x100) ||
          (flag & 0x400))
        continue;
      rec_offsets.push_back(rp);
    }
  }
  return phase_walk(bam.data(), rec_offsets, n_var, var_pos, var_ref0,
                    var_alt0, var_ref_len, var_alt_len, var_danger,
                    ref_string, ref_len);
}

// filter_overlap_alignments (PhasingGraph.cpp:707-781 incl. the
// range.first==0 quirk); C++ port of core/fastpath.filter_overlap_flat —
// same-name alignments are sequentially reconciled by overlap fraction.
int64_t lps_filter_overlap(int64_t A, const char* blob, const int64_t* noff,
                           const int64_t* first_pos, const int64_t* last_pos,
                           double threshold, uint8_t* keep) {
  struct Entry {
    int64_t rng0 = 0, rng1 = 0;
    std::vector<int64_t> idxv;
  };
  std::unordered_map<std::string, Entry> m;
  m.reserve((size_t)A);
  for (int64_t i = 0; i < A; ++i) keep[i] = 1;
  for (int64_t i = 0; i < A; ++i) {
    std::string name(blob + noff[i], (size_t)(noff[i + 1] - noff[i]));
    Entry& e = m[name];
    int64_t first = first_pos[i], last = last_pos[i];
    bool to_delete = false;
    while (e.rng0 <= first && first <= e.rng1) {
      if (last < e.rng1) {
        to_delete = true;
        keep[i] = 0;
        break;
      }
      int64_t pre = (int64_t)e.idxv.size() - 1;
      if (pre < 0) break;
      int64_t prev = e.idxv[pre];
      int64_t ps = first_pos[prev], pe = last_pos[prev];
      int64_t os = std::max(ps, first), oe = std::min(pe, last);
      if (os > oe) break;
      double ol = (double)(oe - os + 1);
      double span = (double)(std::max(pe, last) - std::min(ps, first) + 1);
      if (ol / span >= threshold) {
        int64_t len1 = pe - ps + 1, len2 = last - first + 1;
        if (len2 <= len1) {
          to_delete = true;
          keep[i] = 0;
          break;
        } else {
          keep[e.idxv[pre]] = 0;
          e.idxv.pop_back();
          e.rng1 = pre > 0 ? last_pos[e.idxv[pre - 1]] : first;
        }
      } else {
        break;
      }
    }
    e.rng1 = last;
    if (!to_delete) e.idxv.push_back(i);
  }
  return 0;
}

// merge_observations hot core (core/fastpath.merge_observations): name-sorted
// read ids, observed-position dedupe + per-observation ranks, and the stable
// (read id, rank) sort. Replaces the numpy np.unique(names) + np.unique(pos)
// + np.lexsort trio (~100 ms per bench chromosome) with radix passes (~10 ms).
// Semantics parity: read ids follow byte-lexicographic name order (np.unique
// sort order == the reference's std::map<string, ReadVariant> merge order,
// PhasingGraph.cpp:848); the sort is stable so duplicate (read, rank) pairs
// keep original stream order exactly like np.lexsort.
int64_t lps_merge_obs(int64_t No, const int64_t* obs_pos, int64_t A,
                      const int64_t* aln_offsets, const char* blob,
                      const int64_t* noff, int64_t* positions_out,
                      int32_t* rank_out, int32_t* order_out,
                      int32_t* obs_read_out, int32_t* obs_aln_out) {
  if (No <= 0 || A <= 0) return 0;
  // ---- name-sorted read ids per alignment -------------------------------
  std::vector<int32_t> aln_read((size_t)A);
  {
    std::vector<int32_t> idx((size_t)A);
    for (int64_t i = 0; i < A; ++i) idx[(size_t)i] = (int32_t)i;
    auto sv = [&](int32_t i) {
      return std::string_view(blob + noff[i], (size_t)(noff[i + 1] - noff[i]));
    };
    std::sort(idx.begin(), idx.end(),
              [&](int32_t a, int32_t b) { return sv(a) < sv(b); });
    int32_t rid = -1;
    std::string_view prev;
    for (int64_t k = 0; k < A; ++k) {
      std::string_view s = sv(idx[(size_t)k]);
      if (rid < 0 || s != prev) {
        ++rid;
        prev = s;
      }
      aln_read[(size_t)idx[(size_t)k]] = rid;
    }
  }
  // ---- per-observation alignment index + read id ------------------------
  for (int64_t a = 0; a < A; ++a) {
    for (int64_t o = aln_offsets[a]; o < aln_offsets[a + 1]; ++o) {
      obs_aln_out[o] = (int32_t)a;
      obs_read_out[o] = aln_read[(size_t)a];
    }
  }
  // ---- observed-position dedupe + ranks via one (pos, idx) radix sort ---
  // positions fit u32 in practice; fall back to std::sort otherwise
  int64_t pmax = 0;
  for (int64_t i = 0; i < No; ++i) pmax = std::max(pmax, obs_pos[i]);
  struct PI {
    uint32_t pos;
    uint32_t idx;
  };
  std::vector<int64_t> S_holder;
  int64_t S = 0;
  if (pmax < (int64_t)UINT32_MAX) {
    std::vector<PI> v((size_t)No), tmp((size_t)No);
    for (int64_t i = 0; i < No; ++i)
      v[(size_t)i] = {(uint32_t)obs_pos[i], (uint32_t)i};
    for (int shift = 0; shift < 32; shift += 16) {
      if ((pmax >> shift) == 0) break;
      size_t cnt[65536] = {0};
      for (int64_t i = 0; i < No; ++i)
        cnt[(v[(size_t)i].pos >> shift) & 0xffff]++;
      size_t run = 0;
      for (size_t d = 0; d < 65536; ++d) {
        size_t c = cnt[d];
        cnt[d] = run;
        run += c;
      }
      for (int64_t i = 0; i < No; ++i)
        tmp[cnt[(v[(size_t)i].pos >> shift) & 0xffff]++] = v[(size_t)i];
      std::swap(v, tmp);
    }
    uint32_t prev_pos = 0;
    for (int64_t i = 0; i < No; ++i) {
      if (i == 0 || v[(size_t)i].pos != prev_pos) {
        positions_out[S] = (int64_t)v[(size_t)i].pos;
        ++S;
        prev_pos = v[(size_t)i].pos;
      }
      rank_out[v[(size_t)i].idx] = (int32_t)(S - 1);
    }
  } else {
    std::vector<int64_t> idx((size_t)No);
    for (int64_t i = 0; i < No; ++i) idx[(size_t)i] = i;
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      return obs_pos[a] < obs_pos[b];
    });
    int64_t prev_pos = INT64_MIN;
    for (int64_t k = 0; k < No; ++k) {
      int64_t i = idx[(size_t)k];
      if (obs_pos[i] != prev_pos) {
        positions_out[S] = obs_pos[i];
        ++S;
        prev_pos = obs_pos[i];
      }
      rank_out[i] = (int32_t)(S - 1);
    }
  }
  // ---- stable radix sort by (read id, rank) ------------------------------
  {
    struct KI {
      uint64_t key;
      uint32_t idx;
    };
    std::vector<KI> v((size_t)No), tmp((size_t)No);
    uint64_t kmax = 0;
    for (int64_t i = 0; i < No; ++i) {
      uint64_t key = ((uint64_t)(uint32_t)obs_read_out[i] << 32) |
                     (uint32_t)rank_out[i];
      v[(size_t)i] = {key, (uint32_t)i};
      kmax = std::max(kmax, key);
    }
    for (int shift = 0; shift < 64; shift += 16) {
      if (shift && (kmax >> shift) == 0) break;
      size_t cnt[65536] = {0};
      for (int64_t i = 0; i < No; ++i)
        cnt[(v[(size_t)i].key >> shift) & 0xffff]++;
      size_t run = 0;
      for (size_t d = 0; d < 65536; ++d) {
        size_t c = cnt[d];
        cnt[d] = run;
        run += c;
      }
      for (int64_t i = 0; i < No; ++i)
        tmp[cnt[(v[(size_t)i].key >> shift) & 0xffff]++] = v[(size_t)i];
      std::swap(v, tmp);
    }
    for (int64_t i = 0; i < No; ++i) order_out[i] = (int32_t)v[(size_t)i].idx;
  }
  return S;
}

int64_t lps_result_sizes(void* handle, int64_t* n_obs, int64_t* n_aln,
                         int64_t* names_len, int64_t* n_clip) {
  auto* r = (ExtractResult*)handle;
  if (!r) return -1;
  *n_obs = (int64_t)r->obs_pos.size();
  *n_aln = (int64_t)r->aln_start.size();
  *names_len = (int64_t)r->names.size();
  *n_clip = (int64_t)r->clip_pos.size();
  return 0;
}

int64_t lps_result_fill(void* handle, int64_t* obs_pos, int8_t* obs_allele,
                        int16_t* obs_qual, int64_t* aln_offsets,
                        int32_t* aln_start, int64_t* name_offsets, char* names,
                        int64_t* clip_pos, int8_t* clip_side) {
  auto* r = (ExtractResult*)handle;
  if (!r) return -1;
  memcpy(obs_pos, r->obs_pos.data(), r->obs_pos.size() * 8);
  memcpy(obs_allele, r->obs_allele.data(), r->obs_allele.size());
  memcpy(obs_qual, r->obs_qual.data(), r->obs_qual.size() * 2);
  memcpy(aln_offsets, r->aln_offsets.data(), r->aln_offsets.size() * 8);
  memcpy(aln_start, r->aln_start.data(), r->aln_start.size() * 4);
  memcpy(name_offsets, r->name_offsets.data(), r->name_offsets.size() * 8);
  memcpy(names, r->names.data(), r->names.size());
  memcpy(clip_pos, r->clip_pos.data(), r->clip_pos.size() * 8);
  memcpy(clip_side, r->clip_side.data(), r->clip_side.size());
  return 0;
}

void lps_result_free(void* handle) { delete (ExtractResult*)handle; }

// ---------------------------------------------------------------- BGZF out -
// Parallel BGZF compression (the analog of htslib's hts_tpool-backed bgzf
// writer): split the payload into <=65280-byte chunks, deflate each across
// threads, emit standard BGZF member blocks with the BC/BSIZE extra field.
static const size_t BGZF_CHUNK = 65280;

// forward decl: single-threaded BGZF member encoding into `out` (used by
// callers that already run inside a worker pool)
static void bgzf_compress_serial(const uint8_t* data, size_t n, int level,
                                 std::vector<uint8_t>& out);

static size_t deflate_chunk(const uint8_t* src, size_t n, int level,
                            std::vector<uint8_t>& out) {
#ifdef USE_LIBDEFLATE
  // reuse one compressor per (thread, level): alloc+init per 64KB block
  // costs more than the level-1 deflate itself
  thread_local struct libdeflate_compressor* cached = nullptr;
  thread_local int cached_level = -1;
  if (cached == nullptr || cached_level != level) {
    if (cached) libdeflate_free_compressor(cached);
    cached = libdeflate_alloc_compressor(level);
    cached_level = level;
  }
  struct libdeflate_compressor* c = cached;
  size_t bound = libdeflate_deflate_compress_bound(c, n);
  out.resize(bound);
  size_t sz = libdeflate_deflate_compress(c, src, n, out.data(), bound);
  out.resize(sz);
  return sz;
#else
  uLongf bound = compressBound(n) + 64;
  out.resize(bound);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = out.data();
  zs.avail_out = (uInt)bound;
  deflate(&zs, Z_FINISH);
  size_t sz = zs.total_out;
  deflateEnd(&zs);
  out.resize(sz);
  return sz;
#endif
}

static void bgzf_compress_serial(const uint8_t* data, size_t n, int level,
                                 std::vector<uint8_t>& out) {
  size_t n_chunks = n ? (n + BGZF_CHUNK - 1) / BGZF_CHUNK : 0;
  std::vector<uint8_t> comp;
  for (size_t i = 0; i < n_chunks; ++i) {
    const uint8_t* src = data + i * BGZF_CHUNK;
    size_t len = std::min(BGZF_CHUNK, n - i * BGZF_CHUNK);
    size_t csz = deflate_chunk(src, len, level, comp);
#ifdef USE_LIBDEFLATE
    uint32_t crc = libdeflate_crc32(0, src, len);  // SIMD, ~10x zlib's
#else
    uint32_t crc = crc32(0L, src, (uInt)len);
#endif
    size_t bsize = csz + 26;
    size_t off = out.size();
    out.resize(off + bsize);
    uint8_t* p = out.data() + off;
    const uint8_t head[16] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0,
                              0,    0xff, 6, 0, 66, 67, 2, 0};
    memcpy(p, head, 16);
    uint16_t bs = (uint16_t)(bsize - 1);
    memcpy(p + 16, &bs, 2);
    memcpy(p + 18, comp.data(), csz);
    memcpy(p + 18 + csz, &crc, 4);
    uint32_t isize = (uint32_t)len;
    memcpy(p + 22 + csz, &isize, 4);
  }
}

int64_t lps_bgzf_compress(const uint8_t* data, int64_t n, int level,
                          uint8_t** out_p) {
  size_t n_chunks = (n + BGZF_CHUNK - 1) / BGZF_CHUNK;
  if (n == 0) n_chunks = 0;
  std::vector<std::vector<uint8_t>> blocks(n_chunks);
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    std::vector<uint8_t> comp;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks) return;
      const uint8_t* src = data + i * BGZF_CHUNK;
      size_t len = std::min(BGZF_CHUNK, (size_t)(n - (int64_t)i * BGZF_CHUNK));
      size_t csz = deflate_chunk(src, len, level, comp);
  #ifdef USE_LIBDEFLATE
    uint32_t crc = libdeflate_crc32(0, src, len);  // SIMD, ~10x zlib's
#else
    uint32_t crc = crc32(0L, src, (uInt)len);
#endif
      size_t bsize = csz + 26;  // 18 header + data + 8 trailer
      std::vector<uint8_t>& b = blocks[i];
      b.resize(bsize);
      uint8_t* p = b.data();
      const uint8_t head[16] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0,
                                0,    0xff, 6, 0, 66, 67, 2, 0};
      memcpy(p, head, 16);
      uint16_t bs = (uint16_t)(bsize - 1);
      memcpy(p + 16, &bs, 2);
      memcpy(p + 18, comp.data(), csz);
      memcpy(p + 18 + csz, &crc, 4);
      uint32_t isize = (uint32_t)len;
      memcpy(p + 22 + csz, &isize, 4);
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  size_t total = 0;
  for (auto& b : blocks) total += b.size();
  uint8_t* out = (uint8_t*)malloc(total ? total : 1);
  size_t off = 0;
  for (auto& b : blocks) {
    memcpy(out + off, b.data(), b.size());
    off += b.size();
  }
  *out_p = out;
  return (int64_t)total;
}

// Inflate an entire BGZF file into one malloc'd buffer (parallel blocks).
int64_t lps_bgzf_inflate_file(const char* path, uint8_t** out_p) {
  ByteBuf buf;
  if (!read_entire_bgzf(path, buf)) return -1;
  uint8_t* out = (uint8_t*)malloc(buf.size() ? buf.size() : 1);
  memcpy(out, buf.data(), buf.size());
  *out_p = out;
  return (int64_t)buf.size();
}

// Inflate the consecutive complete BGZF blocks found in a byte span
// (parallel), preserving virtual-offset bookkeeping: per-block compressed
// offsets within the span + uncompressed start offsets. A trailing partial
// block is left unconsumed (*n_used reports consumed bytes) so streaming
// readers can refill. Returns total uncompressed bytes or -1.
int64_t lps_bgzf_inflate_span(const uint8_t* raw, int64_t n, uint8_t** out_p,
                              int64_t** coff_p, int64_t** uoff_p,
                              int64_t* n_blocks, int64_t* n_used) {
  struct Blk {
    size_t coff, clen, uoff, ulen;
  };
  std::vector<Blk> blocks;
  size_t pos = 0, total_u = 0;
  while (pos + 28 <= (size_t)n) {
    const uint8_t* src = raw + pos;
    if (src[0] != 0x1f || src[1] != 0x8b) {
      if (blocks.empty()) return -1;  // not BGZF at all
      break;                          // garbage after valid blocks: stop
    }
    uint16_t xlen = src[10] | (src[11] << 8);
    if (pos + 12 + (size_t)xlen + 8 > (size_t)n) break;
    size_t bsize = 0, off = 0;
    while (off + 4 <= xlen) {
      uint8_t si1 = src[12 + off], si2 = src[12 + off + 1];
      uint16_t slen = src[12 + off + 2] | (src[12 + off + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2)
        bsize = (src[12 + off + 4] | (src[12 + off + 5] << 8)) + 1;
      off += 4 + slen;
    }
    if (bsize == 0) return -1;  // missing BC subfield: malformed
    if (pos + bsize > (size_t)n) break;  // partial trailing block
    uint32_t isize;
    memcpy(&isize, src + bsize - 4, 4);
    blocks.push_back({pos, bsize, total_u, isize});
    total_u += isize;
    pos += bsize;
  }
  *n_used = (int64_t)pos;
  *n_blocks = (int64_t)blocks.size();
  uint8_t* out = (uint8_t*)malloc(total_u ? total_u : 1);
  int64_t* coffs = (int64_t*)malloc(sizeof(int64_t) *
                                    (blocks.size() ? blocks.size() : 1));
  int64_t* uoffs = (int64_t*)malloc(sizeof(int64_t) *
                                    (blocks.size() + 1));
  for (size_t i = 0; i < blocks.size(); ++i) {
    coffs[i] = (int64_t)blocks[i].coff;
    uoffs[i] = (int64_t)blocks[i].uoff;
  }
  uoffs[blocks.size()] = (int64_t)total_u;

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (blocks.size() < 4) n_threads = 1;
  std::atomic<size_t> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
#ifdef USE_LIBDEFLATE
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
#endif
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load()) break;
      const Blk& b = blocks[i];
      if (b.ulen == 0) continue;
      const uint8_t* src = raw + b.coff;
      uint16_t xlen = src[10] | (src[11] << 8);
      const uint8_t* cdata = src + 12 + xlen;
      size_t clen = b.clen - 12 - xlen - 8;
#ifdef USE_LIBDEFLATE
      size_t actual = 0;
      if (libdeflate_deflate_decompress(d, cdata, clen, out + b.uoff, b.ulen,
                                        &actual) != LIBDEFLATE_SUCCESS ||
          actual != b.ulen) {
        failed.store(true);
      }
#else
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        failed.store(true);
        continue;
      }
      zs.next_in = const_cast<uint8_t*>(cdata);
      zs.avail_in = (uInt)clen;
      zs.next_out = out + b.uoff;
      zs.avail_out = (uInt)b.ulen;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END) failed.store(true);
#endif
    }
#ifdef USE_LIBDEFLATE
    libdeflate_free_decompressor(d);
#endif
  };
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  if (failed.load()) {
    free(out);
    free(coffs);
    free(uoffs);
    return -1;
  }
  *out_p = out;
  *coff_p = coffs;
  *uoff_p = uoffs;
  return (int64_t)total_u;
}

void lps_buf_free(uint8_t* p) { free(p); }

// One-shot whole-buffer gzip member (libdeflate when built, zlib otherwise).
int64_t lps_gzip(const uint8_t* data, int64_t n, int level, uint8_t** out_p) {
#ifdef USE_LIBDEFLATE
  struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
  size_t bound = libdeflate_gzip_compress_bound(c, (size_t)n);
  uint8_t* out = (uint8_t*)malloc(bound);
  size_t sz = libdeflate_gzip_compress(c, data, (size_t)n, out, bound);
  libdeflate_free_compressor(c);
  if (sz == 0) {
    free(out);
    return -1;
  }
  *out_p = out;
  return (int64_t)sz;
#else
  uLongf bound = compressBound(n) + 64;
  uint8_t* out = (uint8_t*)malloc(bound);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY);
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = (uInt)n;
  zs.next_out = out;
  zs.avail_out = (uInt)bound;
  int r = deflate(&zs, Z_FINISH);
  int64_t sz = zs.total_out;
  deflateEnd(&zs);
  if (r != Z_STREAM_END) {
    free(out);
    return -1;
  }
  *out_p = out;
  return sz;
#endif
}

}  // extern "C"

// ------------------------------------------------------------ VCF rewrite --
// SnpParser::writeLine semantics (ParsingBam.cpp:460-635) over a plain-text
// VCF buffer: strip any existing PS subfield, normalize unphased GT
// (a|b -> sorted a/b), inject "GT=a|b" + PS=block for phased het sites,
// append ":PS"/":." otherwise, optional INDEL_QUAL_FILTERED FILTER.
// Tables arrive as per-chromosome sorted position arrays (binary search per
// line). Mirrors io/vcf.py:rewrite_result_vcf byte-for-byte.

namespace lps_vcfrw {

struct ChromTables {
  const int64_t* het = nullptr;
  int64_t n_het = 0;
  const int64_t* res_pos = nullptr;
  const uint8_t* res_a = nullptr;  // ra_status[0]
  const uint8_t* res_b = nullptr;  // ra_status[2]
  const int64_t* res_block = nullptr;
  int64_t n_res = 0;
  const int64_t* filt = nullptr;
  int64_t n_filt = 0;
};

static bool in_sorted(const int64_t* a, int64_t n, int64_t v) {
  const int64_t* e = a + n;
  const int64_t* it = std::lower_bound(a, e, v);
  return it != e && *it == v;
}

static int64_t find_sorted(const int64_t* a, int64_t n, int64_t v) {
  const int64_t* e = a + n;
  const int64_t* it = std::lower_bound(a, e, v);
  return (it != e && *it == v) ? (int64_t)(it - a) : -1;
}

// column position in the sample string for the subfield whose key starts at
// key_pos in the format string (io/vcf.py:_find_subfield_start)
static size_t subfield_start(const std::string& fmt, size_t key_pos,
                             const std::string& sample) {
  size_t colon_target = 0;
  for (size_t i = 0; i < key_pos && i < fmt.size(); ++i)
    if (fmt[i] == ':') ++colon_target;
  size_t current = 0, start = 0;
  for (char ch : sample) {
    if (current >= colon_target) break;
    if (ch == ':') ++current;
    ++start;
  }
  return start;
}

static void strip_ps(std::string& fmt, std::string& sample) {
  size_t ps = fmt.find("PS");
  if (ps == std::string::npos) return;
  size_t start = subfield_start(fmt, ps, sample);
  if (fmt.find(':', ps + 1) != std::string::npos)
    fmt = fmt.substr(0, ps) + fmt.substr(ps + 3);
  else
    fmt = fmt.substr(0, ps - 1) + fmt.substr(ps + 2);
  size_t nxt = sample.find(':', start + 1);
  if (nxt != std::string::npos)
    sample = sample.substr(0, start) + sample.substr(nxt + 1);
  else
    sample = sample.substr(0, start - 1);
}

static void normalize_gt(const std::string& fmt, std::string& sample) {
  size_t gt = fmt.find("GT");
  if (gt == std::string::npos) return;
  size_t start = subfield_start(fmt, gt, sample);
  if (start + 2 < sample.size() && sample[start + 1] == '|') {
    if (sample[start] > sample[start + 2])
      std::swap(sample[start], sample[start + 2]);
    sample[start + 1] = '/';
  }
}

static void apply_phase(std::string& fmt, std::string& sample, uint8_t a,
                        uint8_t b, int64_t block) {
  fmt += ":PS";
  sample += ":";
  sample += std::to_string(block);
  size_t gt = fmt.find("GT");
  size_t start = subfield_start(fmt, gt, sample);
  sample[start] = (char)a;
  sample[start + 1] = '|';
  sample[start + 2] = (char)b;
}

}  // namespace lps_vcfrw

extern "C" int64_t lps_vcf_rewrite(
    const char* text, int64_t text_len, const char* out_path,
    const char* version, const char* command, int32_t phase_indel,
    int32_t indel_quality,
    // per-chromosome tables: names blob + offsets, then concatenated
    // sorted arrays with per-chrom offsets
    int64_t n_chroms, const char* chrom_blob, const int64_t* chrom_off,
    const int64_t* het_all, const int64_t* het_off,
    const int64_t* res_pos_all, const uint8_t* res_a_all,
    const uint8_t* res_b_all, const int64_t* res_block_all,
    const int64_t* res_off,
    const int64_t* filt_all, const int64_t* filt_off) {
  using namespace lps_vcfrw;
  std::unordered_map<std::string, ChromTables> chroms;
  chroms.reserve((size_t)n_chroms * 2);
  for (int64_t c = 0; c < n_chroms; ++c) {
    std::string name(chrom_blob + chrom_off[c],
                     (size_t)(chrom_off[c + 1] - chrom_off[c]));
    ChromTables t;
    t.het = het_all + het_off[c];
    t.n_het = het_off[c + 1] - het_off[c];
    t.res_pos = res_pos_all + res_off[c];
    t.res_a = res_a_all + res_off[c];
    t.res_b = res_b_all + res_off[c];
    t.res_block = res_block_all + res_off[c];
    t.n_res = res_off[c + 1] - res_off[c];
    t.filt = filt_all + filt_off[c];
    t.n_filt = filt_off[c + 1] - filt_off[c];
    chroms.emplace(std::move(name), t);
  }

  FILE* f = fopen(out_path, "wb");
  if (!f) return -1;
  std::string out;
  out.reserve(1 << 22);
  auto flush_out = [&]() {
    if (!out.empty()) {
      fwrite(out.data(), 1, out.size(), f);
      out.clear();
    }
  };

  bool ps_def = false, command_written = false;
  const char* p = text;
  const char* end = text + text_len;
  std::vector<std::string> fields;
  std::string cached_chrom;
  const ChromTables* cached_tab = nullptr;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* line_end = nl ? nl : end;
    // rstrip("\n") only (match the Python; \r stays if present)
    size_t len = (size_t)(line_end - p);
    if (len >= 2 && p[0] == '#' && p[1] == '#') {
      if (len >= 16 && memcmp(p, "##FORMAT=<ID=PS,", 16) == 0) ps_def = true;
      out.append(p, len);
      out += '\n';
      if (len >= 17 && memcmp(p, "##FILTER=<ID=PASS", 17) == 0 &&
          phase_indel && indel_quality > 0) {
        out += "##FILTER=<ID=INDEL_QUAL_FILTERED,Description=\"Indel "
               "filtered due to QUAL below threshold (";
        out += std::to_string(indel_quality);
        out += ")\">\n";
      }
    } else if (len >= 6 && (memcmp(p, "#CHROM", 6) == 0
                            || memcmp(p, "#chrom", 6) == 0)) {
      if (!command_written) {
        if (!ps_def) {
          out += "##FORMAT=<ID=PS,Number=1,Type=Integer,Description=\""
                 "Phase set identifier\">\n";
          ps_def = true;
        }
        out += "##longphaseVersion=";
        out += version;
        out += "\n##commandline=\"";
        out += command;
        out += "\"\n";
        command_written = true;
      }
      out.append(p, len);
      out += '\n';
    } else {
      // data line: whitespace-split like Python str.split()
      fields.clear();
      const char* q = p;
      while (q < line_end) {
        while (q < line_end && isspace((unsigned char)*q)) ++q;
        const char* s = q;
        while (q < line_end && !isspace((unsigned char)*q)) ++q;
        if (q > s) fields.emplace_back(s, (size_t)(q - s));
      }
      if (fields.empty()) {
        p = line_end + 1;
        continue;
      }
      if (fields.size() < 10) {
        fclose(f);
        return -2;  // caller falls back to the Python writer
      }
      int64_t pos0 = strtoll(fields[1].c_str(), nullptr, 10) - 1;
      if (fields[0] != cached_chrom) {
        cached_chrom = fields[0];
        auto it = chroms.find(cached_chrom);
        cached_tab = it == chroms.end() ? nullptr : &it->second;
      }
      const ChromTables* tab = cached_tab;
      strip_ps(fields[8], fields[9]);
      normalize_gt(fields[8], fields[9]);
      bool in_het = tab && in_sorted(tab->het, tab->n_het, pos0);
      bool filtered = phase_indel && indel_quality > 0 && tab &&
                      in_sorted(tab->filt, tab->n_filt, pos0);
      int64_t ri = tab ? find_sorted(tab->res_pos, tab->n_res, pos0) : -1;
      if (ri >= 0 && in_het) {
        apply_phase(fields[8], fields[9], tab->res_a[ri], tab->res_b[ri],
                    tab->res_block[ri]);
      } else {
        fields[8] += ":PS";
        fields[9] += ":.";
      }
      if (filtered) fields[6] = "INDEL_QUAL_FILTERED";
      for (size_t i = 0; i < fields.size(); ++i) {
        if (i) out += '\t';
        out += fields[i];
      }
      out += '\n';
    }
    if (out.size() > (1 << 22)) flush_out();
    if (!nl) break;
    p = nl + 1;
  }
  flush_out();
  fclose(f);
  return 0;
}

// ===========================================================================
// Tagging/extraction runtime: whole-BAM handle + generic variant-site
// observation walk + tag rewrite. Behavioral contracts:
//   CigarParser::parsingCigar        (reference HaplotagParsingBam.cpp:541-647)
//   ChromosomeProcessor dispatch     (reference HaplotagParsingBam.cpp:421-499)
//   getWindowsDiffRef                (reference SomaticVarCaller.cpp:654-710)
//   bam_aux_append HP/PS/PQ          (reference HaplotagProcess.cpp:357-361)
// Reimplemented from the BAM spec + the repo's Python oracles (cigar_walk.py,
// somatic_caller.py); no reference code used.
// ===========================================================================

namespace {

struct BamHandle {
  ByteBuf data;                    // whole inflated BAM
  size_t header_off = 0;           // offset of l_text field
  size_t records_off = 0;          // offset of first alignment record
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::vector<size_t> rec_off;     // offset of each record body (after size)
  std::vector<uint32_t> rec_len;
  std::vector<int64_t> tid_first, tid_last;  // record-index range per tid
};

struct TagResult {
  std::vector<int64_t> rec_idx;
  std::vector<uint8_t> category;  // 0=process 1=lowq 2=unmap 3=sec 4=supp 5=empty 6=other
  std::vector<uint16_t> flag;
  std::vector<uint8_t> mapq;
  std::vector<int64_t> pos;
  std::vector<int64_t> end_ref_pos;
  std::vector<int64_t> end_query_pos;
  std::vector<int64_t> name_off;  // A+1
  std::string names;
  std::vector<int32_t> obs_aln;
  std::vector<int32_t> obs_var;
  std::vector<uint8_t> obs_kind;   // 0=match 1=in-deletion
  std::vector<uint8_t> obs_base;   // ASCII base
  std::vector<uint8_t> obs_flags;  // b0 has_next, b1 alt_ins, b2 alt_del, b3 hp>=3
  std::vector<int32_t> obs_aux;    // deletion: cigar op index
  std::vector<int64_t> wd_obs;
  std::vector<int16_t> wd_off;
  std::vector<uint8_t> wd_base;
  int32_t error = 0;
};

static inline int64_t ref_end_of(const uint8_t* rec) {
  int64_t pos = rd_i32(rec + 4);
  uint16_t n_cigar = rd_u16(rec + 12);
  if (n_cigar == 0) return pos + 1;
  const uint8_t* cigar = rec + 32 + rec[8];
  int64_t span = 0;
  for (uint32_t i = 0; i < n_cigar; ++i) {
    uint32_t cv = rd_u32(cigar + 4ull * i);
    int op = cv & 0xF;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += cv >> 4;
  }
  return pos + span;
}

// getOrderWindowsDiffRef (SomaticVarCaller.cpp:654-686) — one directional
// walk from the variant, recording read-vs-ref mismatch offsets.
static void order_windows_diff(const uint8_t* cigar, uint32_t n_cigar,
                               int64_t ci, const uint8_t* seq, int64_t l_seq,
                               const char* ref, int64_t ref_len,
                               int64_t read_pos, int64_t remaining,
                               int64_t ref_pos, int dir, int window,
                               int64_t obs_idx, TagResult* res) {
  uint32_t cv = rd_u32(cigar + 4ull * ci);
  int op = cv & 0xF;
  for (int i = 1; i <= window; ++i) {
    remaining -= 1;
    if (remaining == 0 || remaining == -1) {
      // processCigarOperation (SomaticVarCaller.cpp:627-653)
      bool ok = false;
      int64_t cj = ci + dir;
      while (cj >= 0 && cj < (int64_t)n_cigar) {
        uint32_t nv = rd_u32(cigar + 4ull * cj);
        int nop = nv & 0xF;
        int64_t nlen = nv >> 4;
        if (nop == 0 || nop == 3 || nop == 6 || nop == 7 || nop == 8) {
          remaining += nlen;
          op = nop;
          ok = true;
          break;
        } else if (nop == 1) {
          read_pos += nlen * dir;
        } else if (nop == 2) {
          ref_pos += nlen * dir;
        } else {
          break;  // soft/hard clip or unknown
        }
        cj += dir;
      }
      if (!ok) return;
      ci = cj;
    }
    if (op == 2 || op == 1 || op == 3 || op == 6 || op == 8) continue;
    read_pos += dir;
    ref_pos += dir;
    if (read_pos > l_seq || ref_pos > ref_len || read_pos < 0 || ref_pos < 0)
      return;
    if (read_pos >= l_seq) return;
    uint8_t nib = (read_pos & 1) ? (seq[read_pos >> 1] & 0xF)
                                 : (seq[read_pos >> 1] >> 4);
    char read_base = SEQ_NT16[nib];
    if (ref_pos == ref_len) {
      // reference quirk: refString[size()] yields '\0' -> always a mismatch
      res->wd_obs.push_back(obs_idx);
      res->wd_off.push_back((int16_t)(i * dir));
      res->wd_base.push_back((uint8_t)read_base);
      continue;
    }
    if (read_base != ref[ref_pos]) {
      res->wd_obs.push_back(obs_idx);
      res->wd_off.push_back((int16_t)(i * dir));
      res->wd_base.push_back((uint8_t)read_base);
    }
  }
}

// getWindowsDiffRef (SomaticVarCaller.cpp:688-710): both directions.
static void windows_diff(const uint8_t* cigar, uint32_t n_cigar, int64_t ci,
                         const uint8_t* seq, int64_t l_seq, const char* ref,
                         int64_t ref_len, int64_t query_pos,
                         int64_t read_offset, int64_t vpos, int window,
                         int64_t obs_idx, TagResult* res) {
  uint32_t cv = rd_u32(cigar + 4ull * ci);
  int op = cv & 0xF;
  int64_t oplen = cv >> 4;
  int64_t fwd_remaining = 0, rev_remaining = 0;
  int64_t read_pos = query_pos + read_offset;
  if (op != 1) {
    fwd_remaining = std::max<int64_t>(oplen - read_offset, 0);
    rev_remaining = std::max<int64_t>(read_offset, 0);
  }
  // reverse walk first (emits i=1..window at descending positions), then fwd
  order_windows_diff(cigar, n_cigar, ci, seq, l_seq, ref, ref_len, read_pos,
                     rev_remaining, vpos, -1, window, obs_idx, res);
  order_windows_diff(cigar, n_cigar, ci, seq, l_seq, ref, ref_len, read_pos,
                     fwd_remaining, vpos, 1, window, obs_idx, res);
}

}  // namespace

extern "C" {

void* lps_bam_load(const char* path) {
  auto* h = new BamHandle();
  if (!read_entire_bgzf(path, h->data) || h->data.size() < 12 ||
      memcmp(h->data.data(), "BAM\1", 4) != 0) {
    delete h;
    return nullptr;
  }
  const ByteBuf& d = h->data;
  size_t p = 4;
  h->header_off = p;
  int32_t l_text = rd_i32(&d[p]);
  p += 4 + (size_t)l_text;
  int32_t n_ref = rd_i32(&d[p]);
  p += 4;
  for (int32_t i = 0; i < n_ref; ++i) {
    int32_t l_name = rd_i32(&d[p]);
    p += 4;
    h->ref_names.emplace_back((const char*)&d[p], (size_t)l_name - 1);
    p += (size_t)l_name;
    h->ref_lens.push_back(rd_i32(&d[p]));
    p += 4;
  }
  h->records_off = p;
  h->tid_first.assign(n_ref, -1);
  h->tid_last.assign(n_ref, -1);
  while (p + 4 <= d.size()) {
    int32_t block_size = rd_i32(&d[p]);
    size_t rp = p + 4;
    p = rp + (size_t)block_size;
    if (p > d.size()) break;
    int32_t tid = rd_i32(&d[rp]);
    int64_t idx = (int64_t)h->rec_off.size();
    h->rec_off.push_back(rp);
    h->rec_len.push_back((uint32_t)block_size);
    if (tid >= 0 && tid < n_ref) {
      if (h->tid_first[tid] < 0) h->tid_first[tid] = idx;
      h->tid_last[tid] = idx + 1;
    }
  }
  return h;
}

void lps_bam_free(void* hp) { delete (BamHandle*)hp; }

// Build a whole-file handle from already-decoded records (the native CRAM
// decoder's output): synthesizes an uncompressed BAM image so every
// handle-based runtime (phase extraction, tag walk/write, modcall walk)
// works identically on CRAM inputs.
void* lps_bam_load_unpacked(const char* header_text, int64_t header_len,
                            int64_t n_ref, const char* ref_names_blob,
                            const int64_t* ref_name_off,
                            const int64_t* ref_lens, const uint8_t* blob,
                            const int64_t* rec_off, int64_t n_rec) {
  auto* h = new BamHandle();
  size_t names_total = 0;
  for (int64_t i = 0; i < n_ref; ++i)
    names_total += (size_t)(ref_name_off[i + 1] - ref_name_off[i]) + 1 + 8;
  size_t total = 12 + (size_t)header_len + names_total +
                 (size_t)rec_off[n_rec] + 4ull * n_rec;
  h->data.reserve(total);
  prefault_range(h->data.data(), total);
  auto put_i32 = [&](int32_t v) {
    const uint8_t* p = (const uint8_t*)&v;
    h->data.insert(h->data.end(), p, p + 4);
  };
  h->data.insert(h->data.end(), {'B', 'A', 'M', 1});
  h->header_off = h->data.size();
  put_i32((int32_t)header_len);
  h->data.insert(h->data.end(), (const uint8_t*)header_text,
                 (const uint8_t*)header_text + header_len);
  put_i32((int32_t)n_ref);
  for (int64_t i = 0; i < n_ref; ++i) {
    int64_t nl = ref_name_off[i + 1] - ref_name_off[i];
    put_i32((int32_t)nl + 1);
    h->data.insert(h->data.end(),
                   (const uint8_t*)ref_names_blob + ref_name_off[i],
                   (const uint8_t*)ref_names_blob + ref_name_off[i + 1]);
    h->data.push_back(0);
    put_i32((int32_t)ref_lens[i]);
    h->ref_names.emplace_back(ref_names_blob + ref_name_off[i], (size_t)nl);
    h->ref_lens.push_back(ref_lens[i]);
  }
  h->records_off = h->data.size();
  h->tid_first.assign(n_ref, -1);
  h->tid_last.assign(n_ref, -1);
  for (int64_t i = 0; i < n_rec; ++i) {
    int64_t sz = rec_off[i + 1] - rec_off[i];
    put_i32((int32_t)sz);
    size_t rp = h->data.size();
    h->data.insert(h->data.end(), blob + rec_off[i], blob + rec_off[i + 1]);
    int32_t tid = rd_i32(&h->data[rp]);
    int64_t idx = (int64_t)h->rec_off.size();
    h->rec_off.push_back(rp);
    h->rec_len.push_back((uint32_t)sz);
    if (tid >= 0 && tid < n_ref) {
      if (h->tid_first[tid] < 0) h->tid_first[tid] = idx;
      h->tid_last[tid] = idx + 1;
    }
  }
  return h;
}

// Whole-file CRAM handle in one native pass: decode containers in parallel
// (lps_cram.cpp) and move the record blobs straight into the BamHandle
// image. On this VM fresh pages fault at tens of microseconds each, so the
// old Python round-trip (decode -> fill-copy into numpy -> copy into the
// handle) tripled the bytes touched; this path touches them once.
extern "C" void* lps_cram_decode(const char* path, const char* fasta_path,
                                 const int64_t* offsets, int64_t n_offsets,
                                 int32_t n_threads);
extern "C" void lps_cram_free(void* rp);
extern "C" int64_t lps_cram_header_text(void* rp, const char** txt);
extern "C" int64_t lps_cram_n_refs(void* rp);
extern "C" int64_t lps_cram_ref(void* rp, int64_t i, const char** name,
                                int64_t* name_len);
extern "C" int64_t lps_cram_n_containers(void* rp);
extern "C" int64_t lps_cram_container(void* rp, int64_t i,
                                      const uint8_t** blob, int64_t* blob_len,
                                      const int64_t** sizes);

void* lps_bam_load_cram(const char* path, const char* fasta_path,
                        int32_t n_threads) {
  void* rp;
  {
    PhaseTimer tm("cram_decode");
    rp = lps_cram_decode(path, fasta_path, nullptr, 0, n_threads);
  }
  if (!rp) return nullptr;
  PhaseTimer tm_all("cram_handle_build");
  const char* hdr = nullptr;
  int64_t hdr_len = lps_cram_header_text(rp, &hdr);
  int64_t n_ref = lps_cram_n_refs(rp);
  int64_t n_cont = lps_cram_n_containers(rp);
  auto* h = new BamHandle();
  size_t names_total = 0, blob_total = 0, n_rec_total = 0;
  for (int64_t i = 0; i < n_ref; ++i) {
    const char* nm;
    int64_t nl;
    lps_cram_ref(rp, i, &nm, &nl);
    names_total += (size_t)nl + 1 + 8;
  }
  for (int64_t c = 0; c < n_cont; ++c) {
    const uint8_t* blob;
    int64_t blob_len;
    const int64_t* sizes;
    int64_t nr = lps_cram_container(rp, c, &blob, &blob_len, &sizes);
    blob_total += (size_t)blob_len;
    n_rec_total += (size_t)nr;
  }
  size_t cap = 12 + (size_t)hdr_len + names_total + blob_total +
               4 * n_rec_total;
  h->data.reserve(cap);
  prefault_range(h->data.data(), cap);
  h->rec_off.reserve(n_rec_total);
  h->rec_len.reserve(n_rec_total);
  auto put_i32 = [&](int32_t v) {
    const uint8_t* p = (const uint8_t*)&v;
    h->data.insert(h->data.end(), p, p + 4);
  };
  h->data.insert(h->data.end(), {'B', 'A', 'M', 1});
  h->header_off = h->data.size();
  put_i32((int32_t)hdr_len);
  h->data.insert(h->data.end(), (const uint8_t*)hdr,
                 (const uint8_t*)hdr + hdr_len);
  put_i32((int32_t)n_ref);
  for (int64_t i = 0; i < n_ref; ++i) {
    const char* nm;
    int64_t nl;
    int64_t rl = lps_cram_ref(rp, i, &nm, &nl);
    put_i32((int32_t)nl + 1);
    h->data.insert(h->data.end(), (const uint8_t*)nm,
                   (const uint8_t*)nm + nl);
    h->data.push_back(0);
    put_i32((int32_t)rl);
    h->ref_names.emplace_back(nm, (size_t)nl);
    h->ref_lens.push_back(rl);
  }
  h->records_off = h->data.size();
  h->tid_first.assign((size_t)n_ref, -1);
  h->tid_last.assign((size_t)n_ref, -1);

  // The record image is ~GBs; on this VM the cold page faults of one big
  // serial fill dominate the whole open. Pre-fault the heap block across
  // threads (malloc doesn't touch pages; one write per page from N threads
  // faults them in parallel; free keeps them resident — the ctor above
  // disables trim), then copy containers into precomputed slices in
  // parallel.
  size_t rec_base_off = h->data.size();
  std::vector<size_t> dest_off((size_t)n_cont + 1, rec_base_off);
  std::vector<int64_t> rec_base((size_t)n_cont + 1, 0);
  for (int64_t c = 0; c < n_cont; ++c) {
    const uint8_t* blob;
    int64_t blob_len;
    const int64_t* sizes;
    int64_t nr = lps_cram_container(rp, c, &blob, &blob_len, &sizes);
    dest_off[(size_t)c + 1] = dest_off[(size_t)c] + (size_t)blob_len +
                              4 * (size_t)nr;
    rec_base[(size_t)c + 1] = rec_base[(size_t)c] + nr;
  }
  size_t total_size = dest_off[(size_t)n_cont];
  int64_t n_rec = rec_base[(size_t)n_cont];
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 8) nt = 8;
  // the pages were pre-faulted before reserve(); this memset runs at
  // memory speed and the parallel copies below never stall on faults
  {
    PhaseTimer tm("cram_handle_resize");
    h->data.resize(total_size);
    h->rec_off.resize((size_t)n_rec);
    h->rec_len.resize((size_t)n_rec);
  }
  PhaseTimer tm_copy("cram_handle_copy+scan");
  std::atomic<int64_t> next_c{0};
  auto copier = [&]() {
    for (;;) {
      int64_t c = next_c.fetch_add(1);
      if (c >= n_cont) return;
      const uint8_t* blob;
      int64_t blob_len;
      const int64_t* sizes;
      int64_t nr = lps_cram_container(rp, c, &blob, &blob_len, &sizes);
      uint8_t* dst = h->data.data() + dest_off[(size_t)c];
      int64_t boff = 0;
      int64_t ri = rec_base[(size_t)c];
      for (int64_t i = 0; i < nr; ++i, ++ri) {
        int32_t sz = (int32_t)sizes[i];
        memcpy(dst, &sz, 4);
        memcpy(dst + 4, blob + boff, (size_t)sz);
        h->rec_off[(size_t)ri] = (size_t)(dst + 4 - h->data.data());
        h->rec_len[(size_t)ri] = (uint32_t)sz;
        dst += 4 + sz;
        boff += sz;
      }
    }
  };
  {
    std::vector<std::thread> ts;
    for (unsigned t = 1; t < nt; ++t) ts.emplace_back(copier);
    copier();
    for (auto& th : ts) th.join();
  }
  for (int64_t idx = 0; idx < n_rec; ++idx) {
    int32_t tid = rd_i32(&h->data[h->rec_off[(size_t)idx]]);
    if (tid >= 0 && tid < n_ref) {
      if (h->tid_first[tid] < 0) h->tid_first[tid] = idx;
      h->tid_last[tid] = idx + 1;
    }
  }
  lps_cram_free(rp);
  return h;
}

// Streaming support: scan complete BAM records in an uncompressed byte
// window, applying the get_snp record filter (tid / pos<lastSNP / MAPQ /
// unmapped / secondary / duplicate). Returns the number of offsets
// written; *n_used = bytes consumed (a trailing partial record stays for
// the caller's carry buffer); *stop = 1 once records pass lastSNP or the
// target tid (sorted input), after which the caller can stop feeding.
int64_t lps_scan_records(const uint8_t* buf, int64_t n, int32_t tid,
                         int64_t last_snp_pos, int32_t mapping_quality,
                         int64_t* offsets, int64_t max_offsets,
                         int64_t* n_used, int32_t* stop) {
  int64_t count = 0;
  int64_t pos = 0;
  *stop = 0;
  while (pos + 4 <= n && count < max_offsets) {
    int32_t block_size = rd_i32(buf + pos);
    int64_t rp = pos + 4;
    if (rp + block_size > n) break;  // partial record: carry
    const uint8_t* rec = buf + rp;
    int32_t rec_tid = rd_i32(rec);
    int32_t rpos = rd_i32(rec + 4);
    if (rec_tid != tid) {
      if (rec_tid > tid && rec_tid != -1) {
        *stop = 1;
        pos = rp + block_size;
        break;
      }
      pos = rp + block_size;
      continue;
    }
    if (rpos >= last_snp_pos) {
      *stop = 1;
      pos = rp + block_size;
      break;
    }
    uint8_t mapq = rec[9];
    uint16_t flag = rd_u16(rec + 14);
    if (!(mapq < mapping_quality || (flag & 0x4) || (flag & 0x100) ||
          (flag & 0x400)))
      offsets[count++] = rp;
    pos = rp + block_size;
  }
  *n_used = pos;
  return count;
}

// Batch walk over scanned records in a caller-provided buffer — the same
// phase_walk the whole-file paths use; batches need no carried iterator
// state because the per-chunk lower_bound initialization is a pure
// function of each record's start position (sorted input).
void* lps_extract_phase_batch(
    const uint8_t* buf, const int64_t* rec_off, int64_t n_rec, int64_t n_var,
    const int64_t* var_pos, const char* var_ref0, const char* var_alt0,
    const int32_t* var_ref_len, const int32_t* var_alt_len,
    const uint8_t* var_danger, const char* ref_string, int64_t ref_len,
    int64_t n_sv, const int64_t* sv_start, const int64_t* sv_len,
    int64_t n_mod, const int64_t* mod_pos, const int64_t* mod_entry_off,
    const char* mod_names_blob, const int64_t* mod_name_off,
    const uint8_t* mod_flags, int32_t sv_window, double sv_threshold) {
  std::vector<size_t> offs(rec_off, rec_off + n_rec);
  return phase_walk(buf, offs, n_var, var_pos, var_ref0, var_alt0,
                    var_ref_len, var_alt_len, var_danger, ref_string, ref_len,
                    n_sv, sv_start, sv_len, n_mod, mod_pos, mod_entry_off,
                    mod_names_blob, mod_name_off, mod_flags, sv_window,
                    sv_threshold);
}

// Handle-based phase extraction: reuses an lps_bam_load'd whole-file handle
// so the BGZF inflate is paid once per file per process, not once per
// extraction call.
void* lps_extract_phase_h(void* hp, const char* chrom, int64_t last_snp_pos,
                          int64_t n_var, const int64_t* var_pos,
                          const char* var_ref0, const char* var_alt0,
                          const int32_t* var_ref_len,
                          const int32_t* var_alt_len,
                          const uint8_t* var_danger, const char* ref_string,
                          int64_t ref_len, int32_t mapping_quality) {
  auto* h = (BamHandle*)hp;
  int32_t tid = -1;
  for (size_t i = 0; i < h->ref_names.size(); ++i)
    if (h->ref_names[i] == chrom) {
      tid = (int32_t)i;
      break;
    }
  std::vector<size_t> rec_offsets;
  if (tid >= 0 && h->tid_first[tid] >= 0) {
    const uint8_t* d = h->data.data();
    for (int64_t idx = h->tid_first[tid]; idx < h->tid_last[tid]; ++idx) {
      const uint8_t* rec = d + h->rec_off[idx];
      if (rd_i32(rec) != tid) continue;
      int32_t pos = rd_i32(rec + 4);
      if (pos >= last_snp_pos) break;
      uint8_t mapq = rec[9];
      uint16_t flag = rd_u16(rec + 14);
      if (mapq < mapping_quality || (flag & 0x4) || (flag & 0x100) ||
          (flag & 0x400))
        continue;
      rec_offsets.push_back(h->rec_off[idx]);
    }
  }
  return phase_walk(h->data.data(), rec_offsets, n_var, var_pos, var_ref0,
                    var_alt0, var_ref_len, var_alt_len, var_danger,
                    ref_string, ref_len);
}

// Extended handle-based extraction with SV / MOD co-phasing streams
// (ParsingBam.cpp:1321-1434's full three-stream walk).
void* lps_extract_phase_hx(
    void* hp, const char* chrom, int64_t last_snp_pos, int64_t n_var,
    const int64_t* var_pos, const char* var_ref0, const char* var_alt0,
    const int32_t* var_ref_len, const int32_t* var_alt_len,
    const uint8_t* var_danger, const char* ref_string, int64_t ref_len,
    int32_t mapping_quality, int64_t n_sv, const int64_t* sv_start,
    const int64_t* sv_len, int64_t n_mod, const int64_t* mod_pos,
    const int64_t* mod_entry_off, const char* mod_names_blob,
    const int64_t* mod_name_off, const uint8_t* mod_flags, int32_t sv_window,
    double sv_threshold) {
  auto* h = (BamHandle*)hp;
  int32_t tid = -1;
  for (size_t i = 0; i < h->ref_names.size(); ++i)
    if (h->ref_names[i] == chrom) {
      tid = (int32_t)i;
      break;
    }
  std::vector<size_t> rec_offsets;
  if (tid >= 0 && h->tid_first[tid] >= 0) {
    const uint8_t* d = h->data.data();
    for (int64_t idx = h->tid_first[tid]; idx < h->tid_last[tid]; ++idx) {
      const uint8_t* rec = d + h->rec_off[idx];
      if (rd_i32(rec) != tid) continue;
      int32_t pos = rd_i32(rec + 4);
      if (pos >= last_snp_pos) break;
      uint8_t mapq = rec[9];
      uint16_t flag = rd_u16(rec + 14);
      if (mapq < mapping_quality || (flag & 0x4) || (flag & 0x100) ||
          (flag & 0x400))
        continue;
      rec_offsets.push_back(h->rec_off[idx]);
    }
  }
  return phase_walk(h->data.data(), rec_offsets, n_var, var_pos, var_ref0,
                    var_alt0, var_ref_len, var_alt_len, var_danger,
                    ref_string, ref_len, n_sv, sv_start, sv_len, n_mod,
                    mod_pos, mod_entry_off, mod_names_blob, mod_name_off,
                    mod_flags, sv_window, sv_threshold);
}

int32_t lps_bam_tid(void* hp, const char* chrom) {
  auto* h = (BamHandle*)hp;
  for (size_t i = 0; i < h->ref_names.size(); ++i)
    if (h->ref_names[i] == chrom) return (int32_t)i;
  return -1;
}

int64_t lps_bam_n_records(void* hp) {
  return (int64_t)((BamHandle*)hp)->rec_off.size();
}

// Generic variant-site observation walk over one chromosome region.
// Returns a TagResult* handle.
void* lps_tag_walk(void* hp, int32_t tid, int64_t beg, int64_t end,
                   int64_t n_var, const int64_t* var_pos, int64_t last_var,
                   const char* ref_string, int64_t ref_len,
                   int32_t quality_threshold, int32_t mapq_filter,
                   int32_t tag_supplementary, const uint8_t* want_window,
                   int32_t window) {
  auto* h = (BamHandle*)hp;
  auto* res = new TagResult();
  res->name_off.push_back(0);
  if (tid < 0 || tid >= (int64_t)h->tid_first.size() || h->tid_first[tid] < 0)
    return res;
  int64_t lo = h->tid_first[tid], hi = h->tid_last[tid];

  // select records: fetch(chrom, beg, end) overlap semantics
  std::vector<int64_t> sel;
  for (int64_t ri = lo; ri < hi; ++ri) {
    const uint8_t* rec = &h->data[h->rec_off[ri]];
    if (rd_i32(rec) != tid) continue;
    int64_t pos = rd_i32(rec + 4);
    if (end >= 0 && pos >= end) break;
    if (beg > 0 && ref_end_of(rec) <= beg) continue;
    sel.push_back(ri);
  }

  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (sel.size() < 256) n_threads = 1;
  size_t chunk = (sel.size() + n_threads - 1) / n_threads;
  std::vector<TagResult> parts(n_threads);

  auto walk_range = [&](size_t b, size_t e, TagResult* out) {
    for (size_t si = b; si < e; ++si) {
      int64_t ri = sel[si];
      const uint8_t* rec = &h->data[h->rec_off[ri]];
      int64_t pos = rd_i32(rec + 4);
      uint8_t l_read_name = rec[8];
      uint8_t mapq = rec[9];
      uint16_t n_cigar = rd_u16(rec + 12);
      uint16_t flag = rd_u16(rec + 14);
      int32_t l_seq = rd_i32(rec + 16);
      const char* qname = (const char*)(rec + 32);
      const uint8_t* cigar = rec + 32 + l_read_name;
      const uint8_t* seq = cigar + 4ull * n_cigar;

      uint8_t cat;
      if (mapq_filter && mapq < quality_threshold) cat = 1;
      else if (flag & 0x4) cat = 2;
      else if (flag & 0x100) cat = 3;
      else if ((flag & 0x800) && !tag_supplementary) cat = 4;
      else if (last_var < 0) cat = 5;
      else if (pos <= last_var) cat = 0;
      else cat = 6;

      int32_t aln = (int32_t)out->rec_idx.size();
      out->rec_idx.push_back(ri);
      out->category.push_back(cat);
      out->flag.push_back(flag);
      out->mapq.push_back(mapq);
      out->pos.push_back(pos);
      out->names.append(qname, l_read_name - 1);
      out->name_off.push_back((int64_t)out->names.size());

      int64_t ref_pos = pos, query_pos = 0;
      if (cat == 0) {
        // CigarParser::parsingCigar walk
        const int64_t* vp0 = std::lower_bound(var_pos, var_pos + n_var, pos);
        int64_t vi = vp0 - var_pos;
        for (uint32_t ci = 0; ci < n_cigar; ++ci) {
          uint32_t cv = rd_u32(cigar + 4ull * ci);
          int op = cv & 0xF;
          int64_t oplen = cv >> 4;
          while (vi < n_var && var_pos[vi] < ref_pos) ++vi;
          if (op == 0 || op == 7 || op == 8) {  // M/=/X
            while (vi < n_var && var_pos[vi] < ref_pos + oplen) {
              int64_t vpos = var_pos[vi];
              int64_t offset = vpos - ref_pos;
              if (offset >= 0) {
                int64_t qp = query_pos + offset;
                uint8_t nib = (qp < l_seq)
                                  ? ((qp & 1) ? (seq[qp >> 1] & 0xF)
                                              : (seq[qp >> 1] >> 4))
                                  : 15;
                uint8_t fl = 0;
                if (ci + 1u < n_cigar) {
                  fl |= 1;
                  if (ref_pos + oplen - 1 == vpos) {
                    int nop = rd_u32(cigar + 4ull * (ci + 1)) & 0xF;
                    if (nop == 1) fl |= 2;
                    if (nop == 2) fl |= 4;
                  }
                }
                int64_t obs_idx = (int64_t)out->obs_var.size();
                out->obs_aln.push_back(aln);
                out->obs_var.push_back((int32_t)vi);
                out->obs_kind.push_back(0);
                out->obs_base.push_back((uint8_t)SEQ_NT16[nib]);
                out->obs_flags.push_back(fl);
                out->obs_aux.push_back((int32_t)ci);
                if (want_window && want_window[vi])
                  windows_diff(cigar, n_cigar, ci, seq, l_seq, ref_string,
                               ref_len, query_pos, offset, vpos, window,
                               obs_idx, out);
              }
              ++vi;
            }
            query_pos += oplen;
            ref_pos += oplen;
          } else if (op == 1) {  // I
            query_pos += oplen;
          } else if (op == 2) {  // D
            while (vi < n_var && var_pos[vi] < ref_pos + oplen) {
              int64_t vpos = var_pos[vi];
              uint8_t nib = (query_pos < l_seq)
                                ? ((query_pos & 1) ? (seq[query_pos >> 1] & 0xF)
                                                   : (seq[query_pos >> 1] >> 4))
                                : 15;
              uint8_t fl = 0;
              if (ref_len > 0 && vpos < ref_len &&
                  homopolymer_length(vpos, ref_string, ref_len) >= 3)
                fl |= 8;
              out->obs_aln.push_back(aln);
              out->obs_var.push_back((int32_t)vi);
              out->obs_kind.push_back(1);
              out->obs_base.push_back((uint8_t)SEQ_NT16[nib]);
              out->obs_flags.push_back(fl);
              out->obs_aux.push_back((int32_t)ci);
              ++vi;
            }
            ref_pos += oplen;
          } else if (op == 3) {  // N
            ref_pos += oplen;
          } else if (op == 4) {  // S
            query_pos += oplen;
          } else if (op == 5 || op == 6) {  // H/P
          } else {
            out->error = 1;
            return;
          }
        }
      }
      out->end_ref_pos.push_back(ref_pos);
      out->end_query_pos.push_back(query_pos);
    }
  };

  for (auto& part : parts) part.name_off.push_back(0);
  std::vector<std::thread> ts;
  for (unsigned t = 1; t < n_threads; ++t) {
    size_t b = t * chunk;
    size_t e = std::min(sel.size(), (t + 1) * chunk);
    if (b < e) ts.emplace_back(walk_range, b, e, &parts[t]);
  }
  walk_range(0, std::min(sel.size(), chunk), &parts[0]);
  for (auto& t : ts) t.join();

  for (auto& part : parts) {
    int64_t aln_base = (int64_t)res->rec_idx.size();
    int64_t obs_base = (int64_t)res->obs_var.size();
    int64_t name_base = (int64_t)res->names.size();
    res->rec_idx.insert(res->rec_idx.end(), part.rec_idx.begin(),
                        part.rec_idx.end());
    res->category.insert(res->category.end(), part.category.begin(),
                         part.category.end());
    res->flag.insert(res->flag.end(), part.flag.begin(), part.flag.end());
    res->mapq.insert(res->mapq.end(), part.mapq.begin(), part.mapq.end());
    res->pos.insert(res->pos.end(), part.pos.begin(), part.pos.end());
    res->end_ref_pos.insert(res->end_ref_pos.end(), part.end_ref_pos.begin(),
                            part.end_ref_pos.end());
    res->end_query_pos.insert(res->end_query_pos.end(),
                              part.end_query_pos.begin(),
                              part.end_query_pos.end());
    for (size_t i = 1; i < part.name_off.size(); ++i)
      res->name_off.push_back(part.name_off[i] + name_base);
    res->names += part.names;
    for (int32_t a : part.obs_aln) res->obs_aln.push_back(a + (int32_t)aln_base);
    res->obs_var.insert(res->obs_var.end(), part.obs_var.begin(),
                        part.obs_var.end());
    res->obs_kind.insert(res->obs_kind.end(), part.obs_kind.begin(),
                         part.obs_kind.end());
    res->obs_base.insert(res->obs_base.end(), part.obs_base.begin(),
                         part.obs_base.end());
    res->obs_flags.insert(res->obs_flags.end(), part.obs_flags.begin(),
                          part.obs_flags.end());
    res->obs_aux.insert(res->obs_aux.end(), part.obs_aux.begin(),
                        part.obs_aux.end());
    for (int64_t w : part.wd_obs) res->wd_obs.push_back(w + obs_base);
    res->wd_off.insert(res->wd_off.end(), part.wd_off.begin(),
                       part.wd_off.end());
    res->wd_base.insert(res->wd_base.end(), part.wd_base.begin(),
                        part.wd_base.end());
    if (part.error) res->error = part.error;
  }
  return res;
}

int64_t lps_tag_sizes(void* rp, int64_t* n_aln, int64_t* n_obs,
                      int64_t* names_len, int64_t* n_wd, int32_t* error) {
  auto* r = (TagResult*)rp;
  if (!r) return -1;
  *n_aln = (int64_t)r->rec_idx.size();
  *n_obs = (int64_t)r->obs_var.size();
  *names_len = (int64_t)r->names.size();
  *n_wd = (int64_t)r->wd_obs.size();
  *error = r->error;
  return 0;
}

int64_t lps_tag_fill(void* rp, int64_t* rec_idx, uint8_t* category,
                     uint16_t* flag, uint8_t* mapq, int64_t* pos,
                     int64_t* end_ref_pos, int64_t* end_query_pos,
                     int64_t* name_off, char* names, int32_t* obs_aln,
                     int32_t* obs_var, uint8_t* obs_kind, uint8_t* obs_base,
                     uint8_t* obs_flags, int32_t* obs_aux, int64_t* wd_obs,
                     int16_t* wd_off, uint8_t* wd_base) {
  auto* r = (TagResult*)rp;
  if (!r) return -1;
  memcpy(rec_idx, r->rec_idx.data(), r->rec_idx.size() * 8);
  memcpy(category, r->category.data(), r->category.size());
  memcpy(flag, r->flag.data(), r->flag.size() * 2);
  memcpy(mapq, r->mapq.data(), r->mapq.size());
  memcpy(pos, r->pos.data(), r->pos.size() * 8);
  memcpy(end_ref_pos, r->end_ref_pos.data(), r->end_ref_pos.size() * 8);
  memcpy(end_query_pos, r->end_query_pos.data(), r->end_query_pos.size() * 8);
  memcpy(name_off, r->name_off.data(), r->name_off.size() * 8);
  memcpy(names, r->names.data(), r->names.size());
  memcpy(obs_aln, r->obs_aln.data(), r->obs_aln.size() * 4);
  memcpy(obs_var, r->obs_var.data(), r->obs_var.size() * 4);
  memcpy(obs_kind, r->obs_kind.data(), r->obs_kind.size());
  memcpy(obs_base, r->obs_base.data(), r->obs_base.size());
  memcpy(obs_flags, r->obs_flags.data(), r->obs_flags.size());
  memcpy(obs_aux, r->obs_aux.data(), r->obs_aux.size() * 4);
  memcpy(wd_obs, r->wd_obs.data(), r->wd_obs.size() * 8);
  memcpy(wd_off, r->wd_off.data(), r->wd_off.size() * 2);
  memcpy(wd_base, r->wd_base.data(), r->wd_base.size());
  return 0;
}

void lps_tag_free(void* rp) { delete (TagResult*)rp; }

// Tag rewrite: emit a BAM with per-record HP/PS/PQ aux surgery.
//   mode 0: passthrough; 1: strip HP/PS/PQ only;
//   2: strip + HP:i + PS:i + PQ:i (germline);
//   3: strip + HP:Z <hp_str> [+ PS:i unless ps==INT64_MIN] + PQ:i (somatic).
// Assemble one output record (aux HP/PS/PQ surgery per `mode`) into `body`.
// Modes: 0 passthrough, 1 strip, 2 germline HP:i/PS:i/PQ:i,
// 3 somatic HP:Z[/PS:i]/PQ:i.
static void assemble_tagged_record(const BamHandle* h, int64_t ri, uint8_t m,
                                   int64_t oi, const int32_t* hp_int,
                                   const int64_t* ps, const int32_t* pq,
                                   const char* hp_str_blob,
                                   const int64_t* hp_str_off,
                                   std::vector<uint8_t>& body) {
  const uint8_t* rec = &h->data[h->rec_off[ri]];
  uint32_t rlen = h->rec_len[ri];
  auto type_size = [](uint8_t t) -> int {
    switch (t) {
      case 'A': case 'c': case 'C': return 1;
      case 's': case 'S': return 2;
      case 'i': case 'I': case 'f': return 4;
      default: return -1;
    }
  };
  if (m == 0) {
    body.insert(body.end(), rec, rec + rlen);
    return;
  }
  // copy up to aux, then filter aux entries
  uint16_t n_cigar = rd_u16(rec + 12);
  int32_t l_seq = rd_i32(rec + 16);
  size_t aux_off =
      32 + rec[8] + 4ull * n_cigar + ((size_t)l_seq + 1) / 2 + l_seq;
  body.insert(body.end(), rec, rec + std::min((size_t)rlen, aux_off));
  size_t i = aux_off;
  while (i + 3 <= rlen) {
    size_t start = i;
    char c0 = rec[i], c1 = rec[i + 1];
    uint8_t t = rec[i + 2];
    i += 3;
    int ts = type_size(t);
    if (ts > 0) {
      i += ts;
    } else if (t == 'Z' || t == 'H') {
      while (i < rlen && rec[i] != 0) ++i;
      ++i;
    } else if (t == 'B') {
      int ss = type_size(rec[i]);
      uint32_t cnt = rd_u32(rec + i + 1);
      i += 5 + (size_t)(ss > 0 ? ss : 0) * cnt;
    } else {
      break;  // malformed; copy rest verbatim
    }
    bool is_hp_ps_pq = (c0 == 'H' && c1 == 'P') || (c0 == 'P' && c1 == 'S') ||
                       (c0 == 'P' && c1 == 'Q');
    if (!is_hp_ps_pq)
      body.insert(body.end(), rec + start, rec + std::min((size_t)rlen, i));
  }
  auto app_int = [&](char a, char b, int32_t v) {
    body.push_back(a);
    body.push_back(b);
    body.push_back('i');
    body.insert(body.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
  };
  if (m == 2) {
    app_int('H', 'P', hp_int[oi]);
    app_int('P', 'S', (int32_t)ps[oi]);
    app_int('P', 'Q', pq[oi]);
  } else if (m == 3) {
    body.push_back('H');
    body.push_back('P');
    body.push_back('Z');
    const char* s = hp_str_blob + hp_str_off[oi];
    const char* e = hp_str_blob + hp_str_off[oi + 1];
    body.insert(body.end(), s, e);
    body.push_back(0);
    if (ps[oi] != INT64_MIN) app_int('P', 'S', (int32_t)ps[oi]);
    app_int('P', 'Q', pq[oi]);
  }
}

// Observability for bench.py's bam_writer_util roofline: wall + uncompressed
// payload bytes of the most recent tag-writer session (either the one-shot
// lps_tag_write or a tagw_open..close stream). The roofline divides a pure
// parallel-deflate wall over the same payload by this wall.
static std::atomic<int64_t> g_tagw_wall_us{0};
static std::atomic<int64_t> g_tagw_payload{0};
double lps_last_tagw_wall_ms() { return g_tagw_wall_us.load() / 1000.0; }
int64_t lps_last_tagw_payload() { return g_tagw_payload.load(); }

int64_t lps_tag_write(void* hp, const char* header_text, int64_t header_len,
                      int64_t n_out, const int64_t* rec_indices,
                      const uint8_t* mode, const int32_t* hp_int,
                      const int64_t* ps, const int32_t* pq,
                      const char* hp_str_blob, const int64_t* hp_str_off,
                      const char* out_path, int32_t level) {
  auto t_start = std::chrono::steady_clock::now();
  std::atomic<int64_t> payload_bytes{0};
  auto* h = (BamHandle*)hp;
  // header block
  std::vector<uint8_t> head;
  head.insert(head.end(), {'B', 'A', 'M', 1});
  int32_t l_text = (int32_t)header_len;
  head.insert(head.end(), (uint8_t*)&l_text, (uint8_t*)&l_text + 4);
  head.insert(head.end(), (const uint8_t*)header_text,
              (const uint8_t*)header_text + header_len);
  int32_t n_ref = (int32_t)h->ref_names.size();
  head.insert(head.end(), (uint8_t*)&n_ref, (uint8_t*)&n_ref + 4);
  for (int32_t i = 0; i < n_ref; ++i) {
    int32_t l_name = (int32_t)h->ref_names[i].size() + 1;
    head.insert(head.end(), (uint8_t*)&l_name, (uint8_t*)&l_name + 4);
    head.insert(head.end(), h->ref_names[i].begin(), h->ref_names[i].end());
    head.push_back(0);
    int32_t l_ref = (int32_t)h->ref_lens[i];
    head.insert(head.end(), (uint8_t*)&l_ref, (uint8_t*)&l_ref + 4);
  }

  // Chunked pipeline: record assembly (aux surgery) parallelizes across a
  // worker pool in fixed record-count chunks; a writer thread consumes the
  // chunks IN ORDER, BGZF-compresses each (parallel) and appends to the
  // file. In-flight chunks are bounded so memory stays ~tens of MB and the
  // buffers never balloon to whole-file size (stable timing under
  // allocator/page-fault churn).
  FILE* f = fopen(out_path, "wb");
  if (!f) return -1;
  static const int64_t CHUNK = 512;      // records per chunk
  static const size_t IN_FLIGHT = 8;     // assembled-chunk window
  int64_t n_chunks = (n_out + CHUNK - 1) / CHUNK;
  // compressed-output ring: the IN_FLIGHT window bounds how far any worker
  // can run ahead of the writer, so chunk ci may safely reuse slot
  // ci % IN_FLIGHT — its previous occupant (ci - IN_FLIGHT) has been
  // written by the time the window wait releases. Reusing capacity (vs a
  // fresh vector per chunk) keeps the whole pipeline inside a few warm
  // buffers instead of page-faulting ~output-size of new memory.
  std::vector<std::vector<uint8_t>> bufs(IN_FLIGHT);
  std::vector<uint8_t> chunk_done((size_t)n_chunks, 0);
  std::mutex mu;
  std::condition_variable cv;
  int64_t write_cursor = 0;  // first chunk not yet written
  bool ok = true;
  int64_t total_comp = 0;

  auto compress_write = [&](const std::vector<uint8_t>& payload) {
    uint8_t* comp = nullptr;
    int64_t nc = lps_bgzf_compress(payload.data(), (int64_t)payload.size(),
                                   level, &comp);
    if (fwrite(comp, 1, (size_t)nc, f) != (size_t)nc) ok = false;
    free(comp);
    total_comp += nc;
  };
  compress_write(head);

  // assemble AND compress in the workers (compression parallelizes across
  // the pool; a serial compressor in the writer thread caps the whole
  // write at one core's deflate throughput), then fwrite in order
  std::atomic<int64_t> next_chunk{0};
  auto assembler = [&]() {
    // per-worker assembly buffer: capacity persists across the ~n_chunks/nt
    // chunks this worker handles, so the ~raw-BAM-sized assembly traffic
    // lands in a handful of warm, already-faulted buffers (a fresh vector
    // per chunk costs more in page faults than the level-3 deflate itself)
    std::vector<uint8_t> body;
    for (;;) {
      int64_t ci = next_chunk.fetch_add(1);
      if (ci >= n_chunks) return;
      {
        // bound the window: wait until the writer is close enough
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return ci - write_cursor < (int64_t)IN_FLIGHT; });
      }
      body.clear();
      int64_t b = ci * CHUNK, e = std::min(n_out, (ci + 1) * CHUNK);
      for (int64_t oi = b; oi < e; ++oi) {
        size_t rec_start = body.size();
        body.resize(body.size() + 4);  // block_size placeholder
        assemble_tagged_record(h, rec_indices[oi], mode[oi], oi, hp_int, ps,
                               pq, hp_str_blob, hp_str_off, body);
        int32_t bsz = (int32_t)(body.size() - rec_start - 4);
        memcpy(&body[rec_start], &bsz, 4);
      }
      payload_bytes.fetch_add((int64_t)body.size(),
                              std::memory_order_relaxed);
      std::vector<uint8_t>& out = bufs[(size_t)(ci % (int64_t)IN_FLIGHT)];
      out.clear();
      bgzf_compress_serial(body.data(), body.size(), level, out);
      {
        std::lock_guard<std::mutex> lk(mu);
        chunk_done[(size_t)ci] = 1;
      }
      cv.notify_all();
    }
  };

  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 2) nt = 2;
  if (nt > 8) nt = 8;
  std::vector<std::thread> workers;
  for (unsigned t = 0; t < nt; ++t) workers.emplace_back(assembler);

  for (int64_t ci = 0; ci < n_chunks; ++ci) {
    {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return chunk_done[(size_t)ci] != 0; });
    }
    const std::vector<uint8_t>& comp =
        bufs[(size_t)(ci % (int64_t)IN_FLIGHT)];
    if (fwrite(comp.data(), 1, comp.size(), f) != comp.size()) ok = false;
    total_comp += (int64_t)comp.size();
    {
      std::lock_guard<std::mutex> lk(mu);
      write_cursor = ci + 1;  // frees slot ci % IN_FLIGHT for chunk
                              // ci + IN_FLIGHT (its window wait releases)
    }
    cv.notify_all();
  }
  for (auto& t : workers) t.join();
  static const uint8_t EOF_BLOCK[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
      0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
      0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};
  ok = ok && fwrite(EOF_BLOCK, 1, 28, f) == 28;
  fclose(f);
  g_tagw_wall_us.store((int64_t)std::chrono::duration_cast<
                           std::chrono::microseconds>(
                           std::chrono::steady_clock::now() - t_start)
                           .count());
  g_tagw_payload.store(payload_bytes.load() + (int64_t)head.size());
  return ok ? total_comp : -1;
}

// Scan every complete record of `tid` in an uncompressed window (the tag
// runtimes categorize all of a chromosome's records, so no quality/flag
// filtering here). *stop = 1 once a higher tid appears (sorted input).
int64_t lps_scan_tid_records(const uint8_t* buf, int64_t n, int32_t tid,
                             int64_t* offsets, int64_t max_offsets,
                             int64_t* n_used, int32_t* stop) {
  int64_t count = 0;
  int64_t pos = 0;
  *stop = 0;
  while (pos + 4 <= n && count < max_offsets) {
    int32_t block_size = rd_i32(buf + pos);
    int64_t rp = pos + 4;
    if (rp + block_size > n) break;  // partial record: carry
    int32_t rec_tid = rd_i32(buf + rp);
    if (rec_tid == tid) {
      offsets[count++] = rp;
    } else if (rec_tid > tid && rec_tid != -1) {
      *stop = 1;
      pos = rp + block_size;
      break;
    }
    pos = rp + block_size;
  }
  *n_used = pos;
  return count;
}

// Streaming tag writer: open once, feed per-window decision batches (each
// referencing a window-local BamHandle), close to finish. Records stream
// through a bounded reusable stage (compress+write at 32MB boundaries).
struct TagWriterStream {
  FILE* f = nullptr;
  int level = 6;
  std::vector<uint8_t> stage;
  int64_t total = 0;
  bool ok = true;
  int64_t payload = 0;  // uncompressed bytes staged (bam_writer_util)
  int64_t active_us = 0;  // wall spent inside feed/flush/close
};

static bool tagw_flush(TagWriterStream* w) {
  if (w->stage.empty()) return true;
  w->payload += (int64_t)w->stage.size();
  uint8_t* comp = nullptr;
  int64_t n = lps_bgzf_compress(w->stage.data(), (int64_t)w->stage.size(),
                                w->level, &comp);
  bool ok = fwrite(comp, 1, (size_t)n, w->f) == (size_t)n;
  free(comp);
  w->total += n;
  w->stage.clear();
  return ok;
}

void* lps_tagw_open(const char* header_text, int64_t header_len,
                    int64_t n_ref, const char* names_blob,
                    const int64_t* name_off, const int64_t* ref_lens,
                    const char* out_path, int32_t level) {
  auto* w = new TagWriterStream();
  w->level = level;
  w->f = fopen(out_path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->stage.reserve((32u << 20) + (4u << 20));
  auto put_i32 = [&](int32_t v) {
    const uint8_t* p = (const uint8_t*)&v;
    w->stage.insert(w->stage.end(), p, p + 4);
  };
  w->stage.insert(w->stage.end(), {'B', 'A', 'M', 1});
  put_i32((int32_t)header_len);
  w->stage.insert(w->stage.end(), (const uint8_t*)header_text,
                  (const uint8_t*)header_text + header_len);
  put_i32((int32_t)n_ref);
  for (int64_t i = 0; i < n_ref; ++i) {
    int64_t nl = name_off[i + 1] - name_off[i];
    put_i32((int32_t)nl + 1);
    w->stage.insert(w->stage.end(),
                    (const uint8_t*)names_blob + name_off[i],
                    (const uint8_t*)names_blob + name_off[i + 1]);
    w->stage.push_back(0);
    put_i32((int32_t)ref_lens[i]);
  }
  return w;
}

int64_t lps_tagw_feed(void* wp, void* hp, int64_t n_out,
                      const int64_t* rec_indices, const uint8_t* mode,
                      const int32_t* hp_int, const int64_t* ps,
                      const int32_t* pq, const char* hp_str_blob,
                      const int64_t* hp_str_off) {
  auto* w = (TagWriterStream*)wp;
  auto* h = (BamHandle*)hp;
  auto t0 = std::chrono::steady_clock::now();
  static const size_t STAGE = 32u << 20;
  for (int64_t oi = 0; oi < n_out && w->ok; ++oi) {
    size_t rec_start = w->stage.size();
    w->stage.resize(w->stage.size() + 4);
    assemble_tagged_record(h, rec_indices[oi], mode[oi], oi, hp_int, ps, pq,
                           hp_str_blob, hp_str_off, w->stage);
    int32_t bsz = (int32_t)(w->stage.size() - rec_start - 4);
    memcpy(&w->stage[rec_start], &bsz, 4);
    if (w->stage.size() >= STAGE) w->ok = tagw_flush(w) && w->ok;
  }
  w->active_us += (int64_t)std::chrono::duration_cast<
                      std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  return w->ok ? 0 : -1;
}

int64_t lps_tagw_close(void* wp) {
  auto* w = (TagWriterStream*)wp;
  auto t0 = std::chrono::steady_clock::now();
  bool ok = tagw_flush(w) && w->ok;
  static const uint8_t EOF_BLOCK[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
      0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
      0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};
  ok = ok && fwrite(EOF_BLOCK, 1, 28, w->f) == 28;
  fclose(w->f);
  w->active_us += (int64_t)std::chrono::duration_cast<
                      std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
  g_tagw_wall_us.store(w->active_us);
  g_tagw_payload.store(w->payload);
  int64_t total = w->total;
  delete w;
  return ok ? total : -1;
}

// CRAM-output variant of lps_tag_write: the same aux surgery feeds the
// native CRAM encoder (lps_cram.cpp) in containers of up to 10000 records
// flushed on tid change (mirrors io/cram.py CramWriter batching).
extern "C" void* lps_cram_writer_open(const char* path,
                                      const char* header_text,
                                      int64_t header_len,
                                      const char* fasta_path);
extern "C" int64_t lps_cram_writer_container(void* w, const uint8_t* blob,
                                             const int64_t* rec_off,
                                             int64_t n_rec, int32_t tid);
extern "C" int64_t lps_cram_writer_close(void* w);

int64_t lps_tag_write_cram(void* hp, const char* header_text,
                           int64_t header_len, int64_t n_out,
                           const int64_t* rec_indices, const uint8_t* mode,
                           const int32_t* hp_int, const int64_t* ps,
                           const int32_t* pq, const char* hp_str_blob,
                           const int64_t* hp_str_off, const char* out_path,
                           const char* fasta_path) {
  auto* h = (BamHandle*)hp;
  void* w = lps_cram_writer_open(out_path, header_text, header_len,
                                 fasta_path);
  if (!w) return -1;
  static const int64_t RECS_PER = 10000;
  static const int64_t BASES_PER = 32ll << 20;
  std::vector<uint8_t> blob;
  std::vector<int64_t> offs{0};
  int32_t cur_tid = INT32_MIN;
  int64_t bases = 0;
  bool ok = true;
  auto flush = [&]() {
    if (offs.size() > 1) {
      if (lps_cram_writer_container(w, blob.data(), offs.data(),
                                    (int64_t)offs.size() - 1, cur_tid) != 0)
        ok = false;
    }
    blob.clear();
    offs.assign(1, 0);
    bases = 0;
  };
  for (int64_t oi = 0; oi < n_out && ok; ++oi) {
    int64_t ri = rec_indices[oi];
    const uint8_t* rec = &h->data[h->rec_off[ri]];
    int32_t tid = rd_i32(rec);
    if (offs.size() > 1 &&
        (tid != cur_tid || (int64_t)offs.size() - 1 >= RECS_PER ||
         bases >= BASES_PER))
      flush();
    cur_tid = tid;
    bases += rd_i32(rec + 16);
    assemble_tagged_record(h, ri, mode[oi], oi, hp_int, ps, pq, hp_str_blob,
                           hp_str_off, blob);
    offs.push_back((int64_t)blob.size());
  }
  flush();
  if (lps_cram_writer_close(w) != 0) ok = false;
  return ok ? 0 : -1;
}

// One-shot raw-deflate decode with known output size (per-BGZF-block).
int64_t lps_inflate_raw(const uint8_t* src, int64_t n, uint8_t* out,
                        int64_t out_n) {
#ifdef USE_LIBDEFLATE
  static thread_local struct libdeflate_decompressor* d = nullptr;
  if (!d) d = libdeflate_alloc_decompressor();
  size_t actual = 0;
  if (libdeflate_deflate_decompress(d, src, (size_t)n, out, (size_t)out_n,
                                    &actual) != LIBDEFLATE_SUCCESS)
    return -1;
  return (int64_t)actual;
#else
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  inflateInit2(&zs, -15);
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = out;
  zs.avail_out = (uInt)out_n;
  int r = inflate(&zs, Z_FINISH);
  int64_t total = zs.total_out;
  inflateEnd(&zs);
  if (r != Z_STREAM_END && r != Z_OK) return -1;
  return total;
#endif
}

}  // extern "C"

// ===========================================================================
// modcall runtime: native MM/ML base-mod decode + methylation CIGAR walk.
// Behavioral contracts (reimplemented from the SAM tags spec and the repo's
// Python oracle models/modcall.py + io/bam.py:decode_base_mods; no reference
// code used):
//   MethBamParser::detectMeth/parse_CIGAR   (reference ModCallParsingBam.cpp:58-420)
//   calculateDepth                          (reference ModCallParsingBam.cpp:735-767)
// The walk is deliberately single-threaded in file order: the per-position
// variantType gate and strand overwrite are order-sensitive across reads.
// ===========================================================================

namespace {

// decode_base_mods (io/bam.py:225-291): returns (stored_seq_pos, qual) for
// mod code 'm', ascending by (pos, qual).
static void decode_mods_m(const uint8_t* rec, uint32_t rlen,
                          std::vector<std::pair<int64_t, int32_t>>& out) {
  out.clear();
  uint8_t l_read_name = rec[8];
  uint16_t n_cigar = rd_u16(rec + 12);
  uint16_t flag = rd_u16(rec + 14);
  int32_t l_seq = rd_i32(rec + 16);
  const uint8_t* seq = rec + 32 + l_read_name + 4ull * n_cigar;
  size_t aux_off = 32 + l_read_name + 4ull * n_cigar +
                   ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
  // locate MM/Mm (Z) and ML/Ml (B)
  const char* mm = nullptr;
  size_t mm_len = 0;
  const uint8_t* ml = nullptr;
  int ml_sub = 0;  // subtype char
  int64_t n_ml = 0;
  size_t i = aux_off;
  auto type_size = [](uint8_t t) -> int {
    switch (t) {
      case 'A': case 'c': case 'C': return 1;
      case 's': case 'S': return 2;
      case 'i': case 'I': case 'f': return 4;
      default: return -1;
    }
  };
  while (i + 3 <= rlen) {
    char c0 = rec[i], c1 = rec[i + 1];
    uint8_t t = rec[i + 2];
    size_t val = i + 3;
    i += 3;
    int ts = type_size(t);
    if (ts > 0) {
      i += ts;
    } else if (t == 'Z' || t == 'H') {
      size_t s = i;
      while (i < rlen && rec[i] != 0) ++i;
      if (!mm && t == 'Z' && c0 == 'M' && (c1 == 'M' || c1 == 'm')) {
        mm = (const char*)(rec + s);
        mm_len = i - s;
      }
      ++i;
    } else if (t == 'B') {
      int ss = type_size(rec[val]);
      uint32_t cnt = rd_u32(rec + val + 1);
      if (!ml && c0 == 'M' && (c1 == 'L' || c1 == 'l') && ss > 0) {
        ml = rec + val + 5;
        ml_sub = rec[val];
        n_ml = cnt;
      }
      i = val + 5 + (size_t)(ss > 0 ? ss : 0) * cnt;
    } else {
      break;
    }
  }
  if (!mm) return;
  auto ml_at = [&](int64_t k) -> int32_t {
    if (k >= n_ml || k < 0) return 0;
    switch (ml_sub) {
      case 'C': return ml[k];
      case 'c': return (int8_t)ml[k];
      case 's': return (int16_t)(ml[2 * k] | (ml[2 * k + 1] << 8));
      case 'S': return (uint16_t)(ml[2 * k] | (ml[2 * k + 1] << 8));
      case 'i': case 'I': return rd_i32(ml + 4 * k);
      default: return 0;
    }
  };
  bool reverse = (flag & 0x10) != 0;
  // Match bitmask over the stored seq for one target nt16 code: bit q set
  // when base q matches. Built once per MM subtag (two LUT bits per seq
  // byte), consumed by rank/select walks — replaces materializing a
  // positions vector (the old per-nibble loop + push_back dominated the
  // whole modcall walk).
  static thread_local std::vector<uint64_t> match_bits;
  int64_t n_words = 0;
  bool match_all = false;
  auto fill_positions = [&](int target_nib) {
    match_all = target_nib == -1;
    if (match_all) return;
    uint8_t tbl[256];
    for (int b = 0; b < 256; ++b)
      tbl[b] = (uint8_t)(((b >> 4) == target_nib ? 1 : 0) |
                         ((b & 0xF) == target_nib ? 2 : 0));
    n_words = (l_seq + 63) >> 6;
    if ((int64_t)match_bits.size() < n_words) match_bits.resize(n_words);
    int64_t n_bytes = ((size_t)l_seq + 1) / 2;
    uint64_t w = 0;
    int64_t wi = 0;
    int shift = 0;
    for (int64_t k = 0; k < n_bytes; ++k) {
      w |= (uint64_t)tbl[seq[k]] << shift;
      shift += 2;
      if (shift == 64) {
        match_bits[wi++] = w;
        w = 0;
        shift = 0;
      }
    }
    if (shift) match_bits[wi++] = w;
    while (wi < n_words) match_bits[wi++] = 0;
    if (l_seq & 1) {
      // odd length: the final low nibble is padding, clear its bit
      match_bits[(l_seq) >> 6] &= ~(1ull << (l_seq & 63));
    }
  };
  // select cursor over the bitmask in STORED orientation; logical
  // occurrence order is reversed for reverse-strand reads
  int64_t sel_word = 0;        // forward cursor
  uint64_t sel_cur = 0;
  int64_t sel_rword = 0;       // reverse cursor (word index from top)
  uint64_t sel_rcur = 0;
  int64_t all_cursor = 0;      // match_all arithmetic cursor (logical idx)
  auto sel_reset = [&]() {
    all_cursor = 0;
    if (match_all) return;
    if (!reverse) {
      sel_word = 0;
      sel_cur = n_words ? match_bits[0] : 0;
    } else {
      sel_rword = n_words - 1;
      sel_rcur = n_words ? match_bits[n_words - 1] : 0;
    }
  };
  // skip `skip` occurrences, return stored-seq index of the next one
  // (logical order), or -1 when exhausted
  auto sel_next = [&](int64_t skip) -> int64_t {
    if (match_all) {
      int64_t logical = all_cursor + skip;
      all_cursor = logical + 1;
      if (logical >= l_seq) return -1;
      return reverse ? l_seq - 1 - logical : logical;
    }
    if (!reverse) {
      for (;;) {
        if (sel_word >= n_words) return -1;
        int c = __builtin_popcountll(sel_cur);
        if (skip >= c) {
          skip -= c;
          if (++sel_word >= n_words) return -1;
          sel_cur = match_bits[sel_word];
          continue;
        }
        while (skip--) sel_cur &= sel_cur - 1;
        int bit = __builtin_ctzll(sel_cur);
        sel_cur &= sel_cur - 1;
        return sel_word * 64 + bit;
      }
    }
    for (;;) {
      if (sel_rword < 0) return -1;
      int c = __builtin_popcountll(sel_rcur);
      if (skip >= c) {
        skip -= c;
        if (--sel_rword < 0) return -1;
        sel_rcur = match_bits[sel_rword];
        continue;
      }
      int bit;
      for (;;) {
        bit = 63 - __builtin_clzll(sel_rcur);
        sel_rcur &= ~(1ull << bit);
        if (skip-- == 0) break;
      }
      return sel_rword * 64 + bit;
    }
  };
  auto nt16_of = [](char b) -> int {
    switch (b) {
      case 'A': return 1;
      case 'C': return 2;
      case 'G': return 4;
      case 'T': case 'U': return 8;
      case 'N': return 15;
      default: return 0;
    }
  };
  auto complement = [](char b) -> char {
    switch (b) {
      case 'A': return 'T';
      case 'C': return 'G';
      case 'G': return 'C';
      case 'T': return 'A';
      case 'U': return 'A';
      default: return b;
    }
  };
  int64_t ml_idx = 0;
  size_t p = 0;
  while (p <= mm_len) {
    // split on ';'
    size_t sub_end = p;
    while (sub_end < mm_len && mm[sub_end] != ';') ++sub_end;
    size_t sp = p;
    p = sub_end + 1;
    if (sub_end == sp) {
      if (sub_end >= mm_len) break;
      continue;
    }
    // head = up to first ','
    size_t head_end = sp;
    while (head_end < sub_end && mm[head_end] != ',') ++head_end;
    // regex ([ACGTUN])([-+])([a-z]+|\d+)([.?]?)
    size_t hp = sp;
    char base = (hp < head_end) ? mm[hp] : 0;
    bool ok = base == 'A' || base == 'C' || base == 'G' || base == 'T' ||
              base == 'U' || base == 'N';
    ++hp;
    char strand_ch = (ok && hp < head_end) ? mm[hp] : 0;
    ok = ok && (strand_ch == '+' || strand_ch == '-');
    ++hp;
    size_t code_start = hp;
    bool digits = false, letters = false;
    while (ok && hp < head_end) {
      char c = mm[hp];
      if (c >= 'a' && c <= 'z' && !digits) {
        letters = true;
        ++hp;
      } else if (c >= '0' && c <= '9' && !letters) {
        digits = true;
        ++hp;
      } else {
        break;
      }
    }
    size_t code_end = hp;
    ok = ok && code_end > code_start;
    if (ok && hp < head_end && (mm[hp] == '.' || mm[hp] == '?')) ++hp;
    // re.match: trailing unmatched chars in head are tolerated
    if (!ok) continue;  // quirk: ml_idx not advanced on unmatched head
    // deltas
    std::vector<int64_t> deltas;
    size_t dp = head_end;
    while (dp < sub_end) {
      ++dp;  // skip ','
      int64_t v = 0;
      bool any = false;
      while (dp < sub_end && mm[dp] >= '0' && mm[dp] <= '9') {
        v = v * 10 + (mm[dp] - '0');
        ++dp;
        any = true;
      }
      if (any) deltas.push_back(v);
      while (dp < sub_end && mm[dp] != ',') ++dp;
    }
    int64_t n_codes = digits ? 1 : (int64_t)(code_end - code_start);
    bool single_m = !digits && n_codes == 1 && mm[code_start] == 'm';
    if (base == 'N') {
      fill_positions(-1);
    } else {
      char target = reverse ? complement(base) : base;
      fill_positions(nt16_of(target));
    }
    sel_reset();
    if (!deltas.empty() && n_codes == 1) {
      if (single_m) {
        for (size_t j = 0; j < deltas.size(); ++j) {
          int64_t posv = sel_next(deltas[j]);
          if (posv >= 0)
            out.emplace_back(posv, ml_at(ml_idx + (int64_t)j));
        }
      }
      ml_idx += (int64_t)deltas.size();
      continue;
    }
    for (int64_t d : deltas) {
      int64_t posv = sel_next(d);
      if (posv < 0) {
        ml_idx += n_codes;
        continue;
      }
      for (int64_t c = 0; c < n_codes; ++c) {
        int32_t q = ml_at(ml_idx);
        ++ml_idx;
        if (!digits && mm[code_start + c] == 'm') out.emplace_back(posv, q);
      }
    }
  }
  std::sort(out.begin(), out.end());
}

struct ModcallResult {
  // unique read names (first-occurrence order) + per-read name id
  std::vector<int64_t> name_off;  // U+1
  std::string names;
  std::vector<int32_t> r_nameid;  // R (processed reads, file order)
  // appended reads (survived full walk with >=1 variant)
  std::vector<int32_t> aread;     // read index of each appended read
  std::vector<int64_t> aread_off; // A+1 into events
  std::vector<int64_t> ev_pos;
  std::vector<int8_t> ev_allele;
  std::vector<int16_t> ev_qual;
  std::vector<uint8_t> ev_vtype;  // 0=MOD 1=SNP
  // meth-position table, sorted by pos
  std::vector<int64_t> m_pos;
  std::vector<int32_t> m_meth, m_canon, m_noise, m_depth;
  std::vector<int8_t> m_strand;
  std::vector<uint8_t> m_vtype;
  // MR/NR read-name pair lists (sorted-meth-idx, read-idx), append order
  std::vector<int32_t> mr_idx, mr_read, nr_idx, nr_read;
  int32_t error = 0;
};

}  // namespace

extern "C" {

void* lps_modcall_walk(void* hp, int32_t tid, int64_t chrom_len,
                       int64_t n_var, const int64_t* var_pos,
                       const uint8_t* var_ref0, const uint8_t* var_alt0,
                       const int32_t* var_reflen, const int32_t* var_altlen,
                       const uint8_t* var_danger, const char* ref_string,
                       int64_t ref_len, double mod_hi, double mod_lo) {
  auto* h = (BamHandle*)hp;
  auto* res = new ModcallResult();
  res->name_off.push_back(0);
  res->aread_off.push_back(0);
  if (tid < 0 || tid >= (int64_t)h->tid_first.size() || h->tid_first[tid] < 0)
    return res;

  // ---- selection (fetch(chrom, 0, chrom_len) + record filters) ----
  std::vector<int64_t> sel;
  for (int64_t ri = h->tid_first[tid]; ri < h->tid_last[tid]; ++ri) {
    const uint8_t* rec = &h->data[h->rec_off[ri]];
    if (rd_i32(rec) != tid) continue;
    int64_t pos = rd_i32(rec + 4);
    if (chrom_len >= 0 && pos >= chrom_len) break;
    uint8_t mapq = rec[9];
    uint16_t flag = rd_u16(rec + 14);
    if (mapq < 1 || (flag & 0x4) || (flag & 0x100) || (flag & 0x400) ||
        (flag & 0x800))
      continue;
    sel.push_back(ri);
  }
  size_t R = sel.size();

  // ---- phase 1 (parallel, read-local): decode + CIGAR walk emitting
  //      candidate events; all cross-read state is deferred to phase 2 ----
  struct Cand {
    int64_t pos;
    int32_t qual;   // SNP: base_q; mod: ML qual
    int8_t kind;    // 0 = SNP observation, 1 = mod candidate
    int8_t allele;  // SNP only
  };
  struct ReadOut {
    std::vector<Cand> cands;
    const char* qname = nullptr;
    int qname_len = 0;
    int64_t se_start = 0, se_end = 0;
    int8_t side = 0;
    bool has_mods = false;
    bool abandoned = false;
  };
  std::vector<ReadOut> reads(R);

  auto walk_range = [&](size_t b, size_t e) {
    std::vector<std::pair<int64_t, int32_t>> mods;
    for (size_t si = b; si < e; ++si) {
      const uint8_t* rec = &h->data[h->rec_off[sel[si]]];
      uint32_t rlen = h->rec_len[sel[si]];
      decode_mods_m(rec, rlen, mods);
      if (mods.empty()) continue;
      ReadOut& ro = reads[si];
      ro.has_mods = true;

      int64_t pos = rd_i32(rec + 4);
      uint8_t l_read_name = rec[8];
      uint16_t n_cigar = rd_u16(rec + 12);
      uint16_t flag = rd_u16(rec + 14);
      int32_t l_seq = rd_i32(rec + 16);
      ro.qname = (const char*)(rec + 32);
      ro.qname_len = l_read_name - 1;
      const uint8_t* cigar = rec + 32 + l_read_name;
      const uint8_t* seq = cigar + 4ull * n_cigar;
      const uint8_t* quals = seq + ((size_t)l_seq + 1) / 2;
      bool reverse = (flag & 0x10) != 0;
      ro.side = reverse ? 1 : 0;

      int64_t refstart = pos;
      int64_t refpos = reverse ? refstart + 1 : refstart;
      int64_t ref_pos = pos;
      int64_t querypos = 0;
      size_t mi = 0;
      const int64_t* vb = std::lower_bound(var_pos, var_pos + n_var, pos);
      int64_t vi = vb - var_pos;

      auto seq_nib = [&](int64_t q) -> int {
        return (q & 1) ? (seq[q >> 1] & 0xF) : (seq[q >> 1] >> 4);
      };

      for (uint32_t ci = 0; ci < n_cigar && !ro.abandoned; ++ci) {
        uint32_t cv = rd_u32(cigar + 4ull * ci);
        int op = cv & 0xF;
        int64_t length = cv >> 4;
        if (op == 0 || op == 7 || op == 8) {  // M/=/X
          while (vi < n_var && var_pos[vi] < ref_pos + length) {
            int64_t vpos = var_pos[vi];
            if (vpos >= ref_pos) {
              int32_t rl = var_reflen[vi], al = var_altlen[vi];
              int64_t offset = vpos - ref_pos;
              int32_t base_q = 0;
              int8_t allele = -1;
              if (querypos + offset + 1 > l_seq) {
                ro.abandoned = true;
                break;
              }
              if (rl == 1 && al == 1) {
                char base = SEQ_NT16[seq_nib(querypos + offset)];
                if ((uint8_t)base == var_ref0[vi]) allele = 0;
                else if ((uint8_t)base == var_alt0[vi]) allele = 1;
                base_q = quals[querypos + offset];
              }
              if (rl == 1 && al != 1 && ci + 1u < n_cigar) {
                allele = (ref_pos + length - 1 == vpos &&
                          (rd_u32(cigar + 4ull * (ci + 1)) & 0xF) == 1)
                             ? 1 : 0;
                base_q = var_danger[vi] ? -5 : -4;
              }
              if (rl != 1 && al == 1 && ci + 1u < n_cigar) {
                allele = (ref_pos + length - 1 == vpos &&
                          (rd_u32(cigar + 4ull * (ci + 1)) & 0xF) == 2)
                             ? 1 : 0;
                base_q = var_danger[vi] ? -5 : -4;
              }
              if (allele != -1)
                ro.cands.push_back(Cand{vpos, base_q, 0, allele});
            }
            ++vi;
          }
          if (ro.abandoned) break;
          while (mi < mods.size() && mods[mi].first <= querypos + length) {
            int64_t methrpos =
                mods[mi].first - querypos + refpos - (reverse ? 1 : 0);
            if (ref_len < methrpos) break;
            ro.cands.push_back(Cand{methrpos, mods[mi].second, 1, 0});
            ++mi;
          }
          querypos += length;
          refpos += length;
          ref_pos += length;
        } else if (op == 1) {  // I
          while (mi < mods.size() && mods[mi].first <= querypos + length) ++mi;
          querypos += length;
        } else if (op == 2) {  // D
          if (ref_len > 0) {
            bool have_v = vi < n_var;
            int64_t vpos = have_v ? var_pos[vi] : 0;
            if (have_v && ref_pos + length + 1 == vpos) {
              // reference no-op branch
            } else if (have_v && ref_pos <= vpos && vpos < ref_pos + length) {
              if (homopolymer_length(vpos, ref_string, ref_len) >= 3) {
                int32_t rl = var_reflen[vi], al = var_altlen[vi];
                int32_t base_q = 0;
                if (querypos + 1 > l_seq) {
                  ro.abandoned = true;
                  break;
                }
                int8_t allele = -1;
                if (rl == 1 && al == 1) {
                  char base = SEQ_NT16[seq_nib(querypos)];
                  if ((uint8_t)base == var_ref0[vi]) allele = 0;
                  else if ((uint8_t)base == var_alt0[vi]) allele = 1;
                  base_q = quals[querypos];
                } else if (rl != 1 && al == 1) {
                  allele = 1;
                  base_q = -4;
                }
                if (allele != -1) {
                  ro.cands.push_back(Cand{vpos, base_q, 0, allele});
                  ++vi;
                }
              }
            }
          }
          refpos += length;
          ref_pos += length;
        } else if (op == 3) {  // N
          refpos += length;
          ref_pos += length;
        } else if (op == 4) {  // S
          while (mi < mods.size() && mods[mi].first <= querypos + length) ++mi;
          querypos += length;
        } else if (op == 5 || op == 6) {  // H/P: mod-mapping quirk
          refpos += length;
        }  // other ops silently ignored, as in the oracle walk
      }
      if (!ro.abandoned) {
        ro.se_start = refstart + 1;
        ro.se_end = reverse ? refpos : refpos + 1;
      }
    }
  };

  {
    PhaseTimer tm("modcall_phase1_walk");
    unsigned n_threads = std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 8) n_threads = 8;
    if (R < 256) n_threads = 1;
    size_t chunk = (R + n_threads - 1) / n_threads;
    std::vector<std::thread> ts;
    for (unsigned t = 1; t < n_threads; ++t) {
      size_t b = t * chunk, e = std::min(R, (t + 1) * chunk);
      if (b < e) ts.emplace_back(walk_range, b, e);
    }
    walk_range(0, std::min(R, chunk));
    for (auto& t : ts) t.join();
  }
  PhaseTimer tm_p2("modcall_phase2_replay");

  // ---- phase 2 (sequential, file order): order-sensitive replay of the
  //      per-position counters, variantType gate, and name interning ----
  struct Entry {
    int32_t meth = 0, canon = 0, noise = 0;
    int8_t strand = -1;
    uint8_t vtype = 0;  // VT_MOD
  };
  std::vector<int64_t> e_pos;
  std::vector<Entry> entries;
  std::unordered_map<int64_t, int32_t> e_idx;
  auto get_entry = [&](int64_t pos) -> int32_t {
    auto it = e_idx.find(pos);
    if (it != e_idx.end()) return it->second;
    int32_t idx = (int32_t)entries.size();
    e_idx.emplace(pos, idx);
    e_pos.push_back(pos);
    entries.emplace_back();
    return idx;
  };
  std::vector<int32_t> mr_e, nr_e;
  std::unordered_map<int64_t, std::array<int64_t, 2>> se;
  std::unordered_map<std::string, int32_t> name_ids;

  std::vector<int64_t> tmp_pos;
  std::vector<int8_t> tmp_allele;
  std::vector<int16_t> tmp_qual;
  std::vector<uint8_t> tmp_vtype;

  for (size_t si = 0; si < R; ++si) {
    ReadOut& ro = reads[si];
    if (!ro.has_mods) continue;
    int32_t read_idx = (int32_t)res->r_nameid.size();
    std::string nm(ro.qname, ro.qname_len);
    auto ins = name_ids.emplace(nm, (int32_t)name_ids.size());
    if (ins.second) {
      res->names += nm;
      res->name_off.push_back((int64_t)res->names.size());
    }
    res->r_nameid.push_back(ins.first->second);

    tmp_pos.clear();
    tmp_allele.clear();
    tmp_qual.clear();
    tmp_vtype.clear();
    for (const Cand& c : ro.cands) {
      if (c.kind == 0) {
        entries[get_entry(c.pos)].vtype = 1;
        tmp_pos.push_back(c.pos);
        tmp_allele.push_back(c.allele);
        tmp_qual.push_back((int16_t)c.qual);
        tmp_vtype.push_back(1);
      } else {
        auto it = e_idx.find(c.pos);
        bool fresh = (it == e_idx.end());
        if (fresh || entries[it->second].vtype == 0) {
          int32_t ei = fresh ? get_entry(c.pos) : it->second;
          Entry& en = entries[ei];
          if ((double)c.qual >= mod_hi) {
            en.meth += 1;
            en.vtype = 0;
            en.strand = ro.side;
            mr_e.push_back(ei);
            res->mr_read.push_back(read_idx);
            tmp_pos.push_back(c.pos);
            tmp_allele.push_back(0);
            tmp_qual.push_back(60);
            tmp_vtype.push_back(0);
          } else if ((double)c.qual <= mod_lo) {
            en.canon += 1;
            nr_e.push_back(ei);
            res->nr_read.push_back(read_idx);
            tmp_pos.push_back(c.pos);
            tmp_allele.push_back(1);
            tmp_qual.push_back(60);
            tmp_vtype.push_back(0);
          } else {
            en.noise += 1;
          }
        }
      }
    }
    if (ro.abandoned) continue;

    se[ro.se_start][ro.side] += 1;
    se[ro.se_end][ro.side] -= 1;

    if (!tmp_pos.empty()) {
      size_t nv = tmp_pos.size();
      std::vector<int32_t> order(nv);
      for (size_t k = 0; k < nv; ++k) order[k] = (int32_t)k;
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) {
                         return tmp_pos[a] < tmp_pos[b];
                       });
      res->aread.push_back(read_idx);
      for (int32_t k : order) {
        res->ev_pos.push_back(tmp_pos[k]);
        res->ev_allele.push_back(tmp_allele[k]);
        res->ev_qual.push_back(tmp_qual[k]);
        res->ev_vtype.push_back(tmp_vtype[k]);
      }
      res->aread_off.push_back((int64_t)res->ev_pos.size());
    }
  }

  // sort meth table by position; remap MR/NR entry indices
  size_t ne = entries.size();
  std::vector<int32_t> order(ne);
  for (size_t k = 0; k < ne; ++k) order[k] = (int32_t)k;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return e_pos[a] < e_pos[b]; });
  std::vector<int32_t> new_of(ne);
  res->m_pos.resize(ne);
  res->m_meth.resize(ne);
  res->m_canon.resize(ne);
  res->m_noise.resize(ne);
  res->m_depth.assign(ne, 0);
  res->m_strand.resize(ne);
  res->m_vtype.resize(ne);
  for (size_t k = 0; k < ne; ++k) {
    int32_t old = order[k];
    new_of[old] = (int32_t)k;
    res->m_pos[k] = e_pos[old];
    res->m_meth[k] = entries[old].meth;
    res->m_canon[k] = entries[old].canon;
    res->m_noise[k] = entries[old].noise;
    res->m_strand[k] = entries[old].strand;
    res->m_vtype[k] = entries[old].vtype;
  }
  res->mr_idx.reserve(mr_e.size());
  for (int32_t e : mr_e) res->mr_idx.push_back(new_of[e]);
  res->nr_idx.reserve(nr_e.size());
  for (int32_t e : nr_e) res->nr_idx.push_back(new_of[e]);

  // calculateDepth (ModCallParsingBam.cpp:735-767), incl. the
  // last-event-not-applied quirk
  std::vector<std::pair<int64_t, std::array<int64_t, 2>>> sev(se.begin(),
                                                              se.end());
  std::sort(sev.begin(), sev.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  int64_t cur_f = 0, cur_r = 0;
  size_t dmi = 0;
  for (size_t k = 0; k < sev.size(); ++k) {
    if (dmi >= ne) break;
    if (k + 1 >= sev.size()) break;
    cur_f += sev[k].second[0];
    cur_r += sev[k].second[1];
    int64_t pos_k = sev[k].first;
    int64_t next_pos = sev[k + 1].first;
    while (dmi < ne && pos_k <= res->m_pos[dmi] && res->m_pos[dmi] < next_pos) {
      if (res->m_strand[dmi] == 0) res->m_depth[dmi] = (int32_t)cur_f;
      else if (res->m_strand[dmi] == 1) res->m_depth[dmi] = (int32_t)cur_r;
      ++dmi;
    }
    // NOTE: a position below pos_k stalls dmi forever (depth stays 0 for
    // all remaining positions) -- faithful to the oracle's while condition
  }
  return res;
}

int64_t lps_modcall_sizes(void* rp, int64_t* n_reads, int64_t* n_names,
                          int64_t* names_len, int64_t* n_appended,
                          int64_t* n_ev, int64_t* n_meth, int64_t* n_mr,
                          int64_t* n_nr, int32_t* error) {
  auto* r = (ModcallResult*)rp;
  if (!r) return -1;
  *n_reads = (int64_t)r->r_nameid.size();
  *n_names = (int64_t)r->name_off.size() - 1;
  *names_len = (int64_t)r->names.size();
  *n_appended = (int64_t)r->aread.size();
  *n_ev = (int64_t)r->ev_pos.size();
  *n_meth = (int64_t)r->m_pos.size();
  *n_mr = (int64_t)r->mr_idx.size();
  *n_nr = (int64_t)r->nr_idx.size();
  *error = r->error;
  return 0;
}

int64_t lps_modcall_fill(void* rp, int64_t* name_off, char* names,
                         int32_t* r_nameid, int32_t* aread, int64_t* aread_off,
                         int64_t* ev_pos, int8_t* ev_allele, int16_t* ev_qual,
                         uint8_t* ev_vtype, int64_t* m_pos, int32_t* m_meth,
                         int32_t* m_canon, int32_t* m_noise, int32_t* m_depth,
                         int8_t* m_strand, uint8_t* m_vtype, int32_t* mr_idx,
                         int32_t* mr_read, int32_t* nr_idx, int32_t* nr_read) {
  auto* r = (ModcallResult*)rp;
  if (!r) return -1;
  memcpy(name_off, r->name_off.data(), r->name_off.size() * 8);
  memcpy(names, r->names.data(), r->names.size());
  memcpy(r_nameid, r->r_nameid.data(), r->r_nameid.size() * 4);
  memcpy(aread, r->aread.data(), r->aread.size() * 4);
  memcpy(aread_off, r->aread_off.data(), r->aread_off.size() * 8);
  memcpy(ev_pos, r->ev_pos.data(), r->ev_pos.size() * 8);
  memcpy(ev_allele, r->ev_allele.data(), r->ev_allele.size());
  memcpy(ev_qual, r->ev_qual.data(), r->ev_qual.size() * 2);
  memcpy(ev_vtype, r->ev_vtype.data(), r->ev_vtype.size());
  memcpy(m_pos, r->m_pos.data(), r->m_pos.size() * 8);
  memcpy(m_meth, r->m_meth.data(), r->m_meth.size() * 4);
  memcpy(m_canon, r->m_canon.data(), r->m_canon.size() * 4);
  memcpy(m_noise, r->m_noise.data(), r->m_noise.size() * 4);
  memcpy(m_depth, r->m_depth.data(), r->m_depth.size() * 4);
  memcpy(m_strand, r->m_strand.data(), r->m_strand.size());
  memcpy(m_vtype, r->m_vtype.data(), r->m_vtype.size());
  memcpy(mr_idx, r->mr_idx.data(), r->mr_idx.size() * 4);
  memcpy(mr_read, r->mr_read.data(), r->mr_read.size() * 4);
  memcpy(nr_idx, r->nr_idx.data(), r->nr_idx.size() * 4);
  memcpy(nr_read, r->nr_read.data(), r->nr_read.size() * 4);
  return 0;
}

void lps_modcall_free(void* rp) { delete (ModcallResult*)rp; }

// Read correction over the merged observation stream (PhasingGraph.cpp:
// 891-1029 semantics; float64 ratio compares exactly like the numpy mirror
// ops/mxu_pack.py:host_read_correction_merged it replaces on the hot
// path). Two passes over the stream, each sharded across threads with
// private accumulators (no atomics).
int64_t lps_read_correction(int64_t no, const int32_t* m_rank,
                            const int8_t* m_allele, const int32_t* m_aln,
                            int64_t S, int64_t A, const int64_t* ps,
                            const int8_t* ori, const int8_t* vtype,
                            double read_confidence, double snp_confidence,
                            int64_t* new_ps, int8_t* new_ori) {
  // vtype weights: SNP(0)/SV(1)=10, INDEL(3)/DANGER(4)=1, MOD(2)=0
  static const int64_t WEIGHT[5] = {10, 10, 0, 1, 1};
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 8) nt = 8;
  if (no < (int64_t)1 << 17) nt = 1;

  // pass A: per-alignment ref10/alt10 (weight by vtype, phased sites only)
  std::vector<std::vector<int64_t>> refs(nt), alts(nt);
  auto passA = [&](unsigned t) {
    std::vector<int64_t>& ref10 = refs[t];
    std::vector<int64_t>& alt10 = alts[t];
    ref10.assign((size_t)A, 0);
    alt10.assign((size_t)A, 0);
    int64_t b = no * t / nt, e = no * (t + 1) / nt;
    for (int64_t i = b; i < e; ++i) {
      int32_t r = m_rank[i];
      int8_t vt = vtype[r];
      int64_t w = (vt >= 0 && vt < 5) ? WEIGHT[vt] : 0;
      if (w == 0 || ps[r] == 0) continue;
      int hap = m_allele[i] == 0 ? ori[r] : 1 - ori[r];
      (hap == 0 ? ref10 : alt10)[(size_t)m_aln[i]] += w;
    }
  };
  {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; ++t) th.emplace_back(passA, t);
    passA(0);
    for (auto& t : th) t.join();
  }
  std::vector<int64_t>& ref10 = refs[0];
  std::vector<int64_t>& alt10 = alts[0];
  for (unsigned t = 1; t < nt; ++t)
    for (int64_t a = 0; a < A; ++a) {
      ref10[a] += refs[t][a];
      alt10[a] += alts[t][a];
    }
  // confident alignments + belonged haplotype
  std::vector<uint8_t> conf_belong((size_t)A);  // 0 not confident; 1/2 = hap0/1
  for (int64_t a = 0; a < A; ++a) {
    int64_t rf = ref10[a], al = alt10[a], tot = rf + al;
    bool confident = tot > 10 &&
                     (double)(rf > al ? rf : al) / (double)tot >
                         read_confidence;
    conf_belong[a] = confident ? (rf > al ? 1 : 2) : 0;
  }

  // pass B: per-site votes from confident alignments' 0/1-allele obs
  std::vector<std::vector<int64_t>> cnts(nt);
  auto passB = [&](unsigned t) {
    std::vector<int64_t>& c = cnts[t];
    c.assign((size_t)S * 4, 0);
    int64_t b = no * t / nt, e = no * (t + 1) / nt;
    for (int64_t i = b; i < e; ++i) {
      uint8_t cb = conf_belong[(size_t)m_aln[i]];
      int8_t al = m_allele[i];
      if (cb == 0 || (al != 0 && al != 1)) continue;
      c[(size_t)((cb - 1) * 2 + al) * S + m_rank[i]] += 1;
    }
  };
  {
    std::vector<std::thread> th;
    for (unsigned t = 1; t < nt; ++t) th.emplace_back(passB, t);
    passB(0);
    for (auto& t : th) t.join();
  }
  std::vector<int64_t>& c0 = cnts[0];
  for (unsigned t = 1; t < nt; ++t)
    for (int64_t k = 0; k < S * 4; ++k) c0[k] += cnts[t][k];
  for (int64_t s = 0; s < S; ++s) {
    int64_t r1 = c0[0 * S + s] + c0[3 * S + s];
    int64_t r2 = c0[2 * S + s] + c0[1 * S + s];
    int64_t tot = r1 + r2;
    bool keep = tot > 0 && r1 != r2 &&
                (double)(r1 > r2 ? r1 : r2) / (double)tot > snp_confidence;
    new_ps[s] = keep ? ps[s] : 0;
    new_ori[s] = (int8_t)(r1 > r2 ? 0 : 1);
  }
  return 0;
}

}  // extern "C"
