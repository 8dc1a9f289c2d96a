"""ctypes bindings for the native ingest library (liblps.so).

Auto-builds from source on first use if a compiler is available; callers must
handle ``available() == False`` by falling back to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "liblps.so")
_SRC_PATH = os.path.join(_HERE, "lps_ingest.cpp")
_SRC_PATHS = [os.path.join(_HERE, "lps_ingest.cpp"),
              os.path.join(_HERE, "lps_cram.cpp")]
_lock = threading.Lock()
_lib = None
_tried = False


def build() -> bool:
    """Compile liblps.so from the tracked sources; returns whether it links
    libdeflate (2-3x zlib for BGZF block decode) or zlib alone."""
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-DUSE_LIBDEFLATE", "-shared",
             "-fPIC", *_SRC_PATHS, "-o", _LIB_PATH, "-ldeflate", "-lz"],
            check=True, capture_output=True)
        return True
    except subprocess.CalledProcessError:
        pass
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *_SRC_PATHS,
         "-o", _LIB_PATH, "-lz"],
        check=True, capture_output=True)
    return False


def _src_hash() -> str:
    import hashlib
    h = hashlib.sha256()
    for p in _SRC_PATHS:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build_and_stamp(stamp: str, want: str) -> None:
    deflate = build()
    with open(stamp, "w") as f:
        f.write(f"{want} libdeflate={int(deflate)}")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            # rebuild when the recorded source hash doesn't match (mtimes are
            # unreliable after a fresh clone)
            stamp = _LIB_PATH + ".srchash"
            want = _src_hash()
            have = None
            if os.path.exists(stamp):
                with open(stamp) as f:
                    have = f.read().split()
            if not os.path.exists(_LIB_PATH) or len(have) != 2 \
                    or have[0] != want:
                _build_and_stamp(stamp, want)
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                # built on another machine (e.g. against a libdeflate this
                # one lacks): rebuild here once
                _build_and_stamp(stamp, want)
                lib = ctypes.CDLL(_LIB_PATH)
        except Exception:  # noqa: BLE001 — no compiler / load failure
            return None
        lib.lps_extract_phase.restype = ctypes.c_void_p
        lib.lps_extract_phase.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.lps_result_sizes.restype = ctypes.c_int64
        lib.lps_result_sizes.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.lps_result_fill.restype = ctypes.c_int64
        lib.lps_result_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 9
        lib.lps_result_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def with_libdeflate() -> bool:
    """Whether the loaded library was built against libdeflate."""
    if not available():
        return False
    with open(_LIB_PATH + ".srchash") as f:
        return f.read().split()[1:] == ["libdeflate=1"]


def available() -> bool:
    return _load() is not None


def extract_phase(bam_path: str, chrom: str, last_snp_pos: int,
                  positions, infos, ref_string: str, mapping_quality: int,
                  fasta_path: str | None = None, sv_entries=None,
                  mod_entries=None, sv_window: int = 20,
                  sv_threshold: float = 0.1):
    """Native get_snp walk. Returns dict of flat numpy arrays or None.

    Prefers the cached whole-file handle (one BGZF inflate — or native CRAM
    decode — per file per process, shared with the tag/modcall runtimes);
    falls back to the path-based one-shot extraction for plain BAMs."""
    lib = _load()
    if lib is None:
        return None
    nb = open_native_bam(bam_path, fasta_path)
    if nb is None:
        with open(bam_path, "rb") as _f:
            if _f.read(4) == b"CRAM":
                return None  # CRAM needs the handle path
        try:
            if os.path.getsize(bam_path) > _inmem_budget():
                # bounded-memory native streaming extraction
                return extract_phase_streaming(
                    bam_path, chrom, last_snp_pos, positions, infos,
                    ref_string, mapping_quality, sv_entries=sv_entries,
                    mod_entries=mod_entries, sv_window=sv_window,
                    sv_threshold=sv_threshold)
        except OSError:
            return None
    t = _marshal_var_tables(positions, infos)
    n = t["n"]
    var_pos, ref0, alt0 = t["var_pos"], t["ref0"], t["alt0"]
    ref_len, alt_len, danger = t["ref_len"], t["alt_len"], t["danger"]
    ref_bytes = ref_string.encode("ascii")

    has_svmod = bool(sv_entries) or bool(mod_entries)
    if nb is None and has_svmod:
        return None  # the SV/MOD walk needs the handle path
    if nb is not None:
        if not getattr(lib, "_phase_h_bound", False):
            lib._phase_h_bound = True
            lib.lps_extract_phase_h.restype = ctypes.c_void_p
            lib.lps_extract_phase_h.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.lps_extract_phase_hx.restype = ctypes.c_void_p
            lib.lps_extract_phase_hx.argtypes = \
                lib.lps_extract_phase_h.argtypes + [
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int32, ctypes.c_double,
                ]
        if has_svmod:
            sm = _marshal_svmod(sv_entries, mod_entries)
            handle = lib.lps_extract_phase_hx(
                nb._h, chrom.encode(), last_snp_pos,
                n, var_pos.ctypes.data, ref0.tobytes(), alt0.tobytes(),
                ref_len.ctypes.data, alt_len.ctypes.data, danger.ctypes.data,
                ref_bytes, len(ref_bytes), mapping_quality,
                sm["n_sv"], sm["sv_start"].ctypes.data,
                sm["sv_len"].ctypes.data, sm["n_mod"],
                sm["mod_pos"].ctypes.data, sm["entry_off"].ctypes.data,
                sm["name_blob"], sm["name_off"].ctypes.data,
                sm["flags"].ctypes.data, sv_window, float(sv_threshold))
        else:
            handle = lib.lps_extract_phase_h(
                nb._h, chrom.encode(), last_snp_pos,
                n, var_pos.ctypes.data, ref0.tobytes(), alt0.tobytes(),
                ref_len.ctypes.data, alt_len.ctypes.data, danger.ctypes.data,
                ref_bytes, len(ref_bytes), mapping_quality)
    else:
        handle = lib.lps_extract_phase(
            bam_path.encode(), chrom.encode(), last_snp_pos,
            n, var_pos.ctypes.data, ref0.tobytes(), alt0.tobytes(),
            ref_len.ctypes.data, alt_len.ctypes.data, danger.ctypes.data,
            ref_bytes, len(ref_bytes), mapping_quality)
    if not handle:
        return None
    return _read_extract_result(lib, handle)


def _bgzf_bind(lib):
    import ctypes as ct
    if getattr(lib, "_bgzf_bound", False):
        return
    lib._bgzf_bound = True
    lib.lps_bgzf_compress.restype = ct.c_int64
    lib.lps_bgzf_compress.argtypes = [ct.c_char_p, ct.c_int64, ct.c_int32,
                                      ct.POINTER(ct.c_void_p)]
    lib.lps_bgzf_inflate_file.restype = ct.c_int64
    lib.lps_bgzf_inflate_file.argtypes = [ct.c_char_p,
                                          ct.POINTER(ct.c_void_p)]
    lib.lps_buf_free.argtypes = [ct.c_void_p]
    lib.lps_inflate_raw.restype = ct.c_int64
    lib.lps_inflate_raw.argtypes = [ct.c_char_p, ct.c_int64, ct.c_void_p,
                                    ct.c_int64]
    lib.lps_gzip.restype = ct.c_int64
    lib.lps_gzip.argtypes = [ct.c_char_p, ct.c_int64, ct.c_int32,
                             ct.POINTER(ct.c_void_p)]
    lib.lps_last_tagw_wall_ms.restype = ct.c_double
    lib.lps_last_tagw_wall_ms.argtypes = []
    lib.lps_last_tagw_payload.restype = ct.c_int64
    lib.lps_last_tagw_payload.argtypes = []


def last_tag_write_stats() -> tuple[float, int] | None:
    """(wall_ms, uncompressed payload bytes) of the most recent native
    tag-writer session — assembly + parallel BGZF + fwrite, the denominator
    of bench.py's bam_writer_util roofline."""
    lib = _load()
    if lib is None:
        return None
    _bgzf_bind(lib)
    return (float(lib.lps_last_tagw_wall_ms()),
            int(lib.lps_last_tagw_payload()))


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """Parallel BGZF compression of a payload into standard member blocks
    (no EOF block appended)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    _bgzf_bind(lib)
    out_p = ctypes.c_void_p()
    n = lib.lps_bgzf_compress(data, len(data), level, ctypes.byref(out_p))
    try:
        return ctypes.string_at(out_p, n)
    finally:
        lib.lps_buf_free(out_p)


def bgzf_inflate_file(path: str) -> bytes | None:
    """Inflate an entire BGZF file with the parallel block decoder."""
    lib = _load()
    if lib is None:
        return None
    _bgzf_bind(lib)
    out_p = ctypes.c_void_p()
    n = lib.lps_bgzf_inflate_file(path.encode(), ctypes.byref(out_p))
    if n < 0:
        return None
    try:
        return ctypes.string_at(out_p, n)
    finally:
        lib.lps_buf_free(out_p)


_inflate_tls = threading.local()


def inflate_raw(src: bytes, out_size: int) -> bytes | None:
    """Raw-deflate decode of one BGZF block payload (libdeflate when built).
    Reuses a thread-local output buffer — create_string_buffer per call costs
    more than the decode itself at BGZF block sizes."""
    lib = _load()
    if lib is None:
        return None
    _bgzf_bind(lib)
    buf = getattr(_inflate_tls, "buf", None)
    if buf is None or len(buf) < out_size:
        buf = ctypes.create_string_buffer(max(out_size, 1 << 16))
        _inflate_tls.buf = buf
    n = lib.lps_inflate_raw(src, len(src), buf, len(buf))
    if n < 0 or n != out_size:
        return None
    return ctypes.string_at(buf, n)


def _tag_bind(lib):
    import ctypes as ct
    if getattr(lib, "_tag_bound", False):
        return
    lib._tag_bound = True
    lib.lps_bam_load.restype = ct.c_void_p
    lib.lps_bam_load.argtypes = [ct.c_char_p]
    lib.lps_bam_free.argtypes = [ct.c_void_p]
    lib.lps_bam_tid.restype = ct.c_int32
    lib.lps_bam_tid.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.lps_bam_n_records.restype = ct.c_int64
    lib.lps_bam_n_records.argtypes = [ct.c_void_p]
    lib.lps_tag_walk.restype = ct.c_void_p
    lib.lps_tag_walk.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_int64,
        ct.c_int64, ct.c_void_p, ct.c_int64,
        ct.c_char_p, ct.c_int64,
        ct.c_int32, ct.c_int32, ct.c_int32, ct.c_void_p, ct.c_int32,
    ]
    lib.lps_tag_sizes.restype = ct.c_int64
    lib.lps_tag_sizes.argtypes = [ct.c_void_p] + [ct.c_void_p] * 5
    lib.lps_tag_fill.restype = ct.c_int64
    lib.lps_tag_fill.argtypes = [ct.c_void_p] + [ct.c_void_p] * 18
    lib.lps_tag_free.argtypes = [ct.c_void_p]
    lib.lps_tag_write_cram.restype = ct.c_int64
    lib.lps_tag_write_cram.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_int64, ct.c_int64, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_char_p,
        ct.c_void_p, ct.c_char_p, ct.c_char_p]
    lib.lps_tag_write.restype = ct.c_int64
    lib.lps_tag_write.argtypes = [
        ct.c_void_p, ct.c_char_p, ct.c_int64,
        ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_char_p, ct.c_void_p, ct.c_char_p, ct.c_int32,
    ]


def _modcall_bind(lib):
    if getattr(lib, "_modcall_bound", False):
        return
    lib._modcall_bound = True
    ct = ctypes
    lib.lps_modcall_walk.restype = ct.c_void_p
    lib.lps_modcall_walk.argtypes = [
        ct.c_void_p, ct.c_int32, ct.c_int64, ct.c_int64, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_char_p, ct.c_int64, ct.c_double, ct.c_double,
    ]
    lib.lps_modcall_sizes.restype = ct.c_int64
    lib.lps_modcall_sizes.argtypes = [ct.c_void_p] + [ct.c_void_p] * 9
    lib.lps_modcall_fill.restype = ct.c_int64
    lib.lps_modcall_fill.argtypes = [ct.c_void_p] + [ct.c_void_p] * 20
    lib.lps_modcall_free.argtypes = [ct.c_void_p]


class NativeBam:
    """Whole-file native BAM handle: one parallel BGZF inflate + record index,
    reused across per-chromosome walks and the tag rewrite."""

    def __init__(self, path: str, fasta_path: str | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        _tag_bind(lib)
        self._lib = lib
        with open(path, "rb") as f:
            is_cram = f.read(4) == b"CRAM"
        if is_cram:
            self._h = _load_cram_native(lib, path, fasta_path or "")
            if not self._h:  # exotic layouts: Python-assisted fallback
                self._h = _load_cram_handle(lib, path, fasta_path or "")
        else:
            self._h = lib.lps_bam_load(path.encode())
        if not self._h:
            raise RuntimeError(f"native load failed for {path}")
        self.path = path
        self._fasta_path = fasta_path or ""

    def close(self):
        if self._h:
            self._lib.lps_bam_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def tid(self, chrom: str) -> int:
        return self._lib.lps_bam_tid(self._h, chrom.encode())

    def tag_walk(self, chrom: str, beg: int, end: int, positions,
                 last_var: int | None, ref_string: str,
                 quality_threshold: int, mapq_filter: bool,
                 tag_supplementary: bool, want_window=None, window: int = 100):
        """Run the native observation walk; returns dict of numpy arrays or
        None when the chromosome is absent. Raises on unsupported CIGAR ops
        (reference exits)."""
        tid = self.tid(chrom)
        if tid < 0:
            return None
        var_pos = np.ascontiguousarray(positions, dtype=np.int64)
        ref_b = ref_string.encode("ascii")
        ww = None
        if want_window is not None:
            ww = np.ascontiguousarray(want_window, dtype=np.uint8)
        handle = self._lib.lps_tag_walk(
            self._h, tid, beg, -1 if end is None else end,
            len(var_pos), var_pos.ctypes.data,
            -1 if last_var is None else last_var,
            ref_b, len(ref_b), quality_threshold, int(mapq_filter),
            int(tag_supplementary),
            ww.ctypes.data if ww is not None else None, window)
        if not handle:
            return None
        lib = self._lib
        try:
            n_aln = ctypes.c_int64()
            n_obs = ctypes.c_int64()
            names_len = ctypes.c_int64()
            n_wd = ctypes.c_int64()
            error = ctypes.c_int32()
            lib.lps_tag_sizes(handle, ctypes.byref(n_aln), ctypes.byref(n_obs),
                              ctypes.byref(names_len), ctypes.byref(n_wd),
                              ctypes.byref(error))
            if error.value:
                raise SystemExit(
                    "Alignment find unsupported CIGAR operation")
            A, O, W = n_aln.value, n_obs.value, n_wd.value
            out = {
                "rec_idx": np.empty(A, np.int64),
                "category": np.empty(A, np.uint8),
                "flag": np.empty(A, np.uint16),
                "mapq": np.empty(A, np.uint8),
                "pos": np.empty(A, np.int64),
                "end_ref_pos": np.empty(A, np.int64),
                "end_query_pos": np.empty(A, np.int64),
                "name_off": np.empty(A + 1, np.int64),
                "obs_aln": np.empty(O, np.int32),
                "obs_var": np.empty(O, np.int32),
                "obs_kind": np.empty(O, np.uint8),
                "obs_base": np.empty(O, np.uint8),
                "obs_flags": np.empty(O, np.uint8),
                "obs_aux": np.empty(O, np.int32),
                "wd_obs": np.empty(W, np.int64),
                "wd_off": np.empty(W, np.int16),
                "wd_base": np.empty(W, np.uint8),
            }
            names = ctypes.create_string_buffer(max(names_len.value, 1))
            lib.lps_tag_fill(
                handle, out["rec_idx"].ctypes.data, out["category"].ctypes.data,
                out["flag"].ctypes.data, out["mapq"].ctypes.data,
                out["pos"].ctypes.data, out["end_ref_pos"].ctypes.data,
                out["end_query_pos"].ctypes.data, out["name_off"].ctypes.data,
                names, out["obs_aln"].ctypes.data, out["obs_var"].ctypes.data,
                out["obs_kind"].ctypes.data, out["obs_base"].ctypes.data,
                out["obs_flags"].ctypes.data, out["obs_aux"].ctypes.data,
                out["wd_obs"].ctypes.data, out["wd_off"].ctypes.data,
                out["wd_base"].ctypes.data)
            out["names"] = names.raw[:names_len.value].decode("ascii")
            return out
        finally:
            lib.lps_tag_free(handle)

    def modcall_walk(self, chrom: str, chrom_len: int, var_pos, var_ref0,
                     var_alt0, var_reflen, var_altlen, var_danger,
                     ref_string: str, mod_hi: float, mod_lo: float):
        """Native MM/ML + methylation CIGAR walk (MethBamParser oracle).
        Returns dict of numpy arrays or None when the chromosome is absent."""
        _modcall_bind(self._lib)
        tid = self.tid(chrom)
        if tid < 0:
            return None
        var_pos = np.ascontiguousarray(var_pos, np.int64)
        var_ref0 = np.ascontiguousarray(var_ref0, np.uint8)
        var_alt0 = np.ascontiguousarray(var_alt0, np.uint8)
        var_reflen = np.ascontiguousarray(var_reflen, np.int32)
        var_altlen = np.ascontiguousarray(var_altlen, np.int32)
        var_danger = np.ascontiguousarray(var_danger, np.uint8)
        ref_b = ref_string.encode("ascii")
        lib = self._lib
        handle = lib.lps_modcall_walk(
            self._h, tid, chrom_len, len(var_pos), var_pos.ctypes.data,
            var_ref0.ctypes.data, var_alt0.ctypes.data,
            var_reflen.ctypes.data, var_altlen.ctypes.data,
            var_danger.ctypes.data, ref_b, len(ref_b), mod_hi, mod_lo)
        if not handle:
            return None
        try:
            c = [ctypes.c_int64() for _ in range(8)]
            error = ctypes.c_int32()
            lib.lps_modcall_sizes(handle, *[ctypes.byref(x) for x in c],
                                  ctypes.byref(error))
            R, U, NL, A, E, M, MR, NR = [x.value for x in c]
            out = {
                "name_off": np.empty(U + 1, np.int64),
                "r_nameid": np.empty(R, np.int32),
                "aread": np.empty(A, np.int32),
                "aread_off": np.empty(A + 1, np.int64),
                "ev_pos": np.empty(E, np.int64),
                "ev_allele": np.empty(E, np.int8),
                "ev_qual": np.empty(E, np.int16),
                "ev_vtype": np.empty(E, np.uint8),
                "m_pos": np.empty(M, np.int64),
                "m_meth": np.empty(M, np.int32),
                "m_canon": np.empty(M, np.int32),
                "m_noise": np.empty(M, np.int32),
                "m_depth": np.empty(M, np.int32),
                "m_strand": np.empty(M, np.int8),
                "m_vtype": np.empty(M, np.uint8),
                "mr_idx": np.empty(MR, np.int32),
                "mr_read": np.empty(MR, np.int32),
                "nr_idx": np.empty(NR, np.int32),
                "nr_read": np.empty(NR, np.int32),
            }
            names = ctypes.create_string_buffer(max(NL, 1))
            lib.lps_modcall_fill(
                handle, out["name_off"].ctypes.data, names,
                out["r_nameid"].ctypes.data,
                out["aread"].ctypes.data, out["aread_off"].ctypes.data,
                out["ev_pos"].ctypes.data, out["ev_allele"].ctypes.data,
                out["ev_qual"].ctypes.data, out["ev_vtype"].ctypes.data,
                out["m_pos"].ctypes.data, out["m_meth"].ctypes.data,
                out["m_canon"].ctypes.data, out["m_noise"].ctypes.data,
                out["m_depth"].ctypes.data, out["m_strand"].ctypes.data,
                out["m_vtype"].ctypes.data, out["mr_idx"].ctypes.data,
                out["mr_read"].ctypes.data, out["nr_idx"].ctypes.data,
                out["nr_read"].ctypes.data)
            out["names"] = names.raw[:NL].decode("ascii")
            return out
        finally:
            lib.lps_modcall_free(handle)

    def tag_write(self, header_text: str, rec_indices, mode, hp_int, ps, pq,
                  hp_strs, out_path: str, level: int = 3) -> bool:
        """Write a BAM with per-record tag surgery (modes: 0 passthrough,
        1 strip, 2 germline HP:i/PS:i/PQ:i, 3 somatic HP:Z[/PS:i]/PQ:i).
        ``hp_strs`` is a list[str] or a precomputed (blob bytes, off int64)
        pair."""
        rec_indices = np.ascontiguousarray(rec_indices, np.int64)
        mode = np.ascontiguousarray(mode, np.uint8)
        hp_int = np.ascontiguousarray(hp_int, np.int32)
        ps = np.ascontiguousarray(ps, np.int64)
        pq = np.ascontiguousarray(pq, np.int32)
        blob, off = _hp_blob(hp_strs)
        hdr = header_text.encode("ascii")
        n = self._lib.lps_tag_write(
            self._h, hdr, len(hdr), len(rec_indices),
            rec_indices.ctypes.data, mode.ctypes.data, hp_int.ctypes.data,
            ps.ctypes.data, pq.ctypes.data, blob, off.ctypes.data,
            out_path.encode(), level)
        return n >= 0

    def tag_write_cram(self, header_text: str, rec_indices, mode, hp_int, ps,
                       pq, hp_strs, out_path: str) -> bool:
        """tag_write with native CRAM output (same aux surgery, containers
        encoded by lps_cram.cpp)."""
        rec_indices = np.ascontiguousarray(rec_indices, np.int64)
        mode = np.ascontiguousarray(mode, np.uint8)
        hp_int = np.ascontiguousarray(hp_int, np.int32)
        ps = np.ascontiguousarray(ps, np.int64)
        pq = np.ascontiguousarray(pq, np.int32)
        blob, off = _hp_blob(hp_strs)
        hdr = header_text.encode("ascii")
        n = self._lib.lps_tag_write_cram(
            self._h, hdr, len(hdr), len(rec_indices),
            rec_indices.ctypes.data, mode.ctypes.data, hp_int.ctypes.data,
            ps.ctypes.data, pq.ctypes.data, blob, off.ctypes.data,
            out_path.encode(), self._fasta_path.encode())
        return n == 0


def read_correction_merged(ps, ori, vtype, m_rank, m_allele, m_aln, A: int,
                           read_confidence: float, snp_confidence: float):
    """Native two-pass read correction over the merged stream; returns
    (new_ps, new_ori) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ct = ctypes
    if not getattr(lib, "_rc_bound", False):
        lib._rc_bound = True
        lib.lps_read_correction.restype = ct.c_int64
        lib.lps_read_correction.argtypes = [
            ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64,
            ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_double,
            ct.c_double, ct.c_void_p, ct.c_void_p]
    m_rank = np.ascontiguousarray(m_rank, np.int32)
    m_allele = np.ascontiguousarray(m_allele, np.int8)
    m_aln = np.ascontiguousarray(m_aln, np.int32)
    ps = np.ascontiguousarray(ps, np.int64)
    ori = np.ascontiguousarray(ori, np.int8)
    vtype = np.ascontiguousarray(vtype, np.int8)
    S = len(ps)
    new_ps = np.empty(S, np.int64)
    new_ori = np.empty(S, np.int8)
    r = lib.lps_read_correction(
        len(m_rank), m_rank.ctypes.data, m_allele.ctypes.data,
        m_aln.ctypes.data, S, int(A), ps.ctypes.data, ori.ctypes.data,
        vtype.ctypes.data, float(read_confidence), float(snp_confidence),
        new_ps.ctypes.data, new_ori.ctypes.data)
    if r != 0:
        return None
    return new_ps, new_ori


def _hp_blob(hp_strs):
    """Normalize an HP:Z payload: list[str] -> joined blob + int64 offsets;
    a precomputed (blob bytes, off) pair passes through."""
    if isinstance(hp_strs, tuple):
        blob, off = hp_strs
        return blob, np.ascontiguousarray(off, np.int64)
    blob = "".join(hp_strs).encode("ascii")
    off = np.zeros(len(hp_strs) + 1, np.int64)
    np.cumsum([len(s) for s in hp_strs], out=off[1:])
    return blob, off


_bam_cache: dict[str, tuple[float, "NativeBam"]] = {}
_bam_cache_lock = threading.Lock()

PS_OMIT = -(2**63)  # sentinel: omit PS tag in somatic mode


def _load_cram_native(lib, path: str, fasta_path: str):
    """One-pass native CRAM -> BAM handle (decode + handle build stay in
    C++; no blob round-trip through Python — each record byte is touched
    once, which matters on VMs where fresh-page faults cost ~tens of us)."""
    if os.environ.get("LPS_NO_NATIVE_CRAM"):
        return None
    if not getattr(lib, "_cram_load_bound", False):
        lib._cram_load_bound = True
        lib.lps_bam_load_cram.restype = ctypes.c_void_p
        lib.lps_bam_load_cram.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int32]
    return lib.lps_bam_load_cram(path.encode(), fasta_path.encode(),
                                 min(os.cpu_count() or 1, 8))


def _load_cram_handle(lib, path: str, fasta_path: str):
    """Native CRAM decode -> synthesized in-memory BAM handle (so every
    handle-based runtime works identically on CRAM inputs)."""
    if os.environ.get("LPS_NO_NATIVE_CRAM"):
        return None
    res = cram_decode(path, fasta_path)
    if res is None:
        return None
    blob, rec_off = res
    # header text + reference dictionary from the CRAM SAM header
    from ..io.cram import CramReader

    cr = CramReader.__new__(CramReader)
    with open(path, "rb") as f:
        cr._buf = f.read(1 << 20)  # header container is at the front
    cr.major = cr._buf[4]
    cr._fasta = None
    try:
        import struct as _struct

        hdr_end, blocks, _meta = cr._read_container(26)
        hb = blocks[0]
        (hlen,) = _struct.unpack_from("<i", hb.data, 0)
        header_text = hb.data[4:4 + hlen].decode("latin-1")
    except Exception:  # noqa: BLE001 — header parse failed: no native handle
        return None
    cr.header_text = header_text
    cr._parse_header()
    if not getattr(lib, "_unpacked_bound", False):
        lib._unpacked_bound = True
        lib.lps_bam_load_unpacked.restype = ctypes.c_void_p
        lib.lps_bam_load_unpacked.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_int64]
    names_blob = "".join(cr.references).encode("latin-1")
    name_off = np.zeros(len(cr.references) + 1, np.int64)
    np.cumsum([len(s) for s in cr.references], out=name_off[1:])
    ref_lens = np.asarray(cr.lengths, np.int64)
    hdr = header_text.encode("latin-1")
    rec_off = np.ascontiguousarray(rec_off, np.int64)
    blob_arr = np.ascontiguousarray(np.frombuffer(blob, np.uint8)
                                    if isinstance(blob, (bytes, bytearray))
                                    else blob)
    return lib.lps_bam_load_unpacked(
        hdr, len(hdr), len(cr.references), names_blob, name_off.ctypes.data,
        ref_lens.ctypes.data, ctypes.c_char_p(blob_arr.ctypes.data),
        rec_off.ctypes.data, len(rec_off) - 1)


def _inmem_budget() -> int:
    """Compressed-size cap for the whole-file in-memory handle: a BAM
    inflates ~4-6x, and two handles may be cached, so default to 1/12 of
    system RAM (LPS_MAX_INMEM_BAM overrides, bytes)."""
    env = os.environ.get("LPS_MAX_INMEM_BAM")
    if env:
        return int(env)
    try:
        ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        ram = 16 << 30
    return ram // 12


def open_native_bam(path: str,
                    fasta_path: str | None = None) -> "NativeBam | None":
    """Cached whole-file handle (keyed by path+mtime, max 2 entries).
    CRAM inputs decode through the native CRAM decoder (needs
    ``fasta_path`` unless the file is referenceless). Files too large for
    the in-memory budget fall back to the streaming readers."""
    if _load() is None:
        return None
    try:
        mtime = os.path.getmtime(path)
        if os.path.getsize(path) > _inmem_budget():
            return None
    except OSError:
        return None
    with _bam_cache_lock:
        ent = _bam_cache.get(path)
        if ent is not None and ent[0] == mtime:
            return ent[1]
        try:
            nb = NativeBam(path, fasta_path)
        except Exception:  # noqa: BLE001
            return None
        _bam_cache[path] = (mtime, nb)
        while len(_bam_cache) > 2:
            k = next(iter(_bam_cache))
            if k == path:
                k = next(it for it in _bam_cache if it != path)
            _bam_cache.pop(k)[1].close()
        return nb


def drain_bam_cache() -> None:
    """Close and evict every cached whole-file handle (tests/bench: force
    the next open to pay the full decode, without leaking native images)."""
    with _bam_cache_lock:
        for _mtime, nb in _bam_cache.values():
            nb.close()
        _bam_cache.clear()


def open_chrom_native_bam(path: str, fasta_path: str | None,
                          chrom: str) -> "NativeBam | None":
    """Per-chromosome in-memory handle for inputs past the whole-file RAM
    budget (modcall's streaming path): streams the chromosome's records in
    bounded compressed windows (StreamingBam window scan, or native CRAM
    container decode) and synthesizes a records-only handle, so resident
    memory is one chromosome's uncompressed records instead of the whole
    file. The ordinary whole-file walk then runs on it unchanged — the
    modcall phase-2 replay is order-sensitive across reads (vtype gate,
    strand last-write, global depth sweep; lps_ingest.cpp
    lps_modcall_walk), so per-window walk outputs cannot be merged
    exactly; a single walk over the chromosome image can. Returns None
    (caller falls back to the object pipeline) when the native library is
    absent, the chromosome is missing, or its image alone would exceed
    the budget's uncompressed allowance."""
    if _load() is None:
        return None
    try:
        with open(path, "rb") as f:
            is_cram = f.read(4) == b"CRAM"
        sb = (CramStreamingBam(path, fasta_path or "") if is_cram
              else StreamingBam(path))
    except Exception:  # noqa: BLE001 — unreadable/unsupported input
        return None
    if sb.tid(chrom) < 0:
        return None
    # uncompressed allowance: ~RAM/3, so with the image + the native
    # handle's own copy both alive peak stays under ~2/3 of system RAM
    # (LPS_MAX_CHROM_IMAGE overrides, bytes — lets a per-chromosome image
    # through when the whole-file budget was deliberately lowered)
    env = os.environ.get("LPS_MAX_CHROM_IMAGE")
    cap = int(env) if env else 4 * _inmem_budget()
    blobs: list[np.ndarray] = []
    boffs = [np.zeros(1, np.int64)]
    base = total = 0
    try:
        for blob, boff in sb._windows(chrom):
            arr = (np.frombuffer(blob, np.uint8)
                   if isinstance(blob, (bytes, bytearray)) else
                   np.asarray(blob, np.uint8))
            blobs.append(arr)
            boffs.append(np.asarray(boff[1:], np.int64) + base)
            base += int(boff[-1])
            total += len(arr)
            if total > cap:
                return None
    except Exception:  # noqa: BLE001 — decode failure mid-stream
        return None
    blob_all = (np.concatenate(blobs) if blobs else np.zeros(0, np.uint8))
    # drop the per-window copies before the native handle makes its own copy
    # of blob_all: peak resident memory is then ~2x the image, not ~3x —
    # at the cap boundary the difference is whether the box OOMs
    blobs.clear()
    return bam_handle_from_records(sb.header_text, sb.references, sb.lengths,
                                   blob_all, np.concatenate(boffs))


def vcf_rewrite(text: bytes, out_path: str, phasing_result: dict,
                het_by_chrom: dict, filtered_by_chrom: dict, version: str,
                command: str, phase_indel: bool, indel_quality: int) -> bool:
    """Native SnpParser::writeLine rewrite (mirrors io.vcf.rewrite_result_vcf
    byte-for-byte). ``text`` is the PLAIN (decompressed) input VCF bytes.
    Returns False when the native library is absent or the input needs the
    Python fallback (malformed data line)."""
    lib = _load()
    if lib is None or os.environ.get("LPS_NO_NATIVE_VCF"):
        return False
    if not getattr(lib, "_vcfrw_bound", False):
        lib._vcfrw_bound = True
        lib.lps_vcf_rewrite.restype = ctypes.c_int64
        lib.lps_vcf_rewrite.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
    # group the phasing_result ("chrom_pos0" -> (ra "a|b", block)) per chrom
    res_by_chrom: dict[str, list] = {}
    for key, (ra, block) in phasing_result.items():
        chrom, _, pos = key.rpartition("_")
        res_by_chrom.setdefault(chrom, []).append(
            (int(pos), ord(ra[0]), ord(ra[2]), block))
    chroms = sorted(set(het_by_chrom) | set(res_by_chrom)
                    | set(filtered_by_chrom))
    blob = "".join(chroms).encode("ascii")
    chrom_off = np.zeros(len(chroms) + 1, np.int64)
    np.cumsum([len(c) for c in chroms], out=chrom_off[1:])
    het_parts, res_parts, filt_parts = [], [], []
    het_off = [0]
    res_off = [0]
    filt_off = [0]
    for c in chroms:
        het = np.sort(np.fromiter(het_by_chrom.get(c, ()), np.int64))
        het_parts.append(het)
        het_off.append(het_off[-1] + len(het))
        rows = sorted(res_by_chrom.get(c, ()))
        res_parts.append(np.asarray(rows, np.int64).reshape(-1, 4))
        res_off.append(res_off[-1] + len(rows))
        filt = np.sort(np.fromiter(filtered_by_chrom.get(c, ()), np.int64))
        filt_parts.append(filt)
        filt_off.append(filt_off[-1] + len(filt))
    het_all = (np.concatenate(het_parts) if het_parts
               else np.zeros(0, np.int64))
    res_all = (np.concatenate(res_parts) if res_parts
               else np.zeros((0, 4), np.int64))
    filt_all = (np.concatenate(filt_parts) if filt_parts
                else np.zeros(0, np.int64))
    res_pos = np.ascontiguousarray(res_all[:, 0])
    res_a = np.ascontiguousarray(res_all[:, 1].astype(np.uint8))
    res_b = np.ascontiguousarray(res_all[:, 2].astype(np.uint8))
    res_block = np.ascontiguousarray(res_all[:, 3])
    het_all = np.ascontiguousarray(het_all)
    filt_all = np.ascontiguousarray(filt_all)
    het_off_a = np.asarray(het_off, np.int64)
    res_off_a = np.asarray(res_off, np.int64)
    filt_off_a = np.asarray(filt_off, np.int64)
    rc = lib.lps_vcf_rewrite(
        text, len(text), out_path.encode(), version.encode(),
        command.encode(), 1 if phase_indel else 0, indel_quality,
        len(chroms), blob, chrom_off.ctypes.data,
        het_all.ctypes.data, het_off_a.ctypes.data,
        res_pos.ctypes.data, res_a.ctypes.data, res_b.ctypes.data,
        res_block.ctypes.data, res_off_a.ctypes.data,
        filt_all.ctypes.data, filt_off_a.ctypes.data)
    return rc == 0


def gzip_oneshot(data: bytes, level: int = 6) -> bytes | None:
    """Whole-buffer gzip member via libdeflate (CRAM block compression)."""
    lib = _load()
    if lib is None:
        return None
    _bgzf_bind(lib)
    out_p = ctypes.c_void_p()
    n = lib.lps_gzip(data, len(data), level, ctypes.byref(out_p))
    if n < 0:
        return None
    try:
        return ctypes.string_at(out_p, n)
    finally:
        lib.lps_buf_free(out_p)


def _cram_bind(lib):
    import ctypes as ct
    if getattr(lib, "_cram_bound", False):
        return
    lib._cram_bound = True
    lib.lps_cram_decode.restype = ct.c_void_p
    lib.lps_cram_decode.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_void_p,
                                    ct.c_int64, ct.c_int32]
    lib.lps_cram_sizes.restype = ct.c_int64
    lib.lps_cram_sizes.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
    lib.lps_cram_fill.restype = ct.c_int64
    lib.lps_cram_fill.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
    lib.lps_cram_free.argtypes = [ct.c_void_p]


def cram_decode(path: str, fasta_path: str = "", offsets=None,
                n_threads: int = 0):
    """Decode a CRAM file (or just the containers at ``offsets``) into
    (blob, rec_off): concatenated raw BAM record bytes plus per-record
    offsets. Returns None when the native path can't handle the file
    (caller falls back to the Python decoder)."""
    import ctypes as ct

    lib = _load()
    if lib is None:
        return None
    _cram_bind(lib)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    offs = np.ascontiguousarray(offsets if offsets is not None else [],
                                np.int64)
    h = lib.lps_cram_decode(path.encode(), fasta_path.encode(),
                            offs.ctypes.data if len(offs) else None,
                            len(offs), n_threads)
    if not h:
        return None
    try:
        blob_len = ct.c_int64()
        n_rec = ct.c_int64()
        lib.lps_cram_sizes(h, ct.byref(blob_len), ct.byref(n_rec))
        blob = np.empty(blob_len.value, np.uint8)
        rec_off = np.empty(n_rec.value + 1, np.int64)
        lib.lps_cram_fill(h, blob.ctypes.data, rec_off.ctypes.data)
        return blob, rec_off  # np.uint8 buffer (callers avoid extra copies)
    finally:
        lib.lps_cram_free(h)


def filter_overlap(names: list[str], first_pos, last_pos,
                   threshold: float):
    """Native filter_overlap_alignments. Returns keep mask or None."""
    import ctypes as ct

    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_overlap_bound", False):
        lib._overlap_bound = True
        lib.lps_filter_overlap.restype = ct.c_int64
        lib.lps_filter_overlap.argtypes = [
            ct.c_int64, ct.c_char_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_double, ct.c_void_p]
    A = len(names)
    blob = "".join(names).encode("latin-1")
    noff = np.zeros(A + 1, np.int64)
    np.cumsum([len(s) for s in names], out=noff[1:])
    fp = np.ascontiguousarray(first_pos, np.int64)
    lp = np.ascontiguousarray(last_pos, np.int64)
    keep = np.empty(A, np.uint8)
    lib.lps_filter_overlap(A, blob, noff.ctypes.data, fp.ctypes.data,
                           lp.ctypes.data, float(threshold), keep.ctypes.data)
    return keep.astype(bool)


def merge_obs(obs_pos, aln_offsets, names: list[str]):
    """Native merge_observations hot core: name-id assignment, position
    dedupe + per-observation ranks, and the stable (read id, rank) sort
    (semantics of np.unique(names, return_inverse) + np.unique(pos) +
    np.searchsorted + np.lexsort). Returns (positions, rank, order,
    obs_read, obs_aln) or None when the native library is unavailable."""
    import ctypes as ct

    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_mergeobs_bound", False):
        lib._mergeobs_bound = True
        lib.lps_merge_obs.restype = ct.c_int64
        lib.lps_merge_obs.argtypes = [
            ct.c_int64, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_char_p,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_void_p]
    A = len(names)
    op = np.ascontiguousarray(obs_pos, np.int64)
    No = len(op)
    offs = np.ascontiguousarray(aln_offsets, np.int64)
    blob = "".join(names).encode("latin-1")
    noff = np.zeros(A + 1, np.int64)
    np.cumsum([len(s) for s in names], out=noff[1:])
    positions = np.empty(No, np.int64)
    rank = np.empty(No, np.int32)
    order = np.empty(No, np.int32)
    obs_read = np.empty(No, np.int32)
    obs_aln = np.empty(No, np.int32)
    S = lib.lps_merge_obs(No, op.ctypes.data, A, offs.ctypes.data, blob,
                          noff.ctypes.data, positions.ctypes.data,
                          rank.ctypes.data, order.ctypes.data,
                          obs_read.ctypes.data, obs_aln.ctypes.data)
    if S <= 0:
        return None
    return positions[:S].copy(), rank, order, obs_read, obs_aln


def _cram_writer_bind(lib):
    import ctypes as ct
    if getattr(lib, "_cramw_bound", False):
        return
    lib._cramw_bound = True
    lib.lps_cram_writer_open.restype = ct.c_void_p
    lib.lps_cram_writer_open.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int64,
                                         ct.c_char_p]
    lib.lps_cram_writer_container.restype = ct.c_int64
    lib.lps_cram_writer_container.argtypes = [ct.c_void_p, ct.c_char_p,
                                             ct.c_void_p, ct.c_int64,
                                             ct.c_int32]
    lib.lps_cram_writer_close.restype = ct.c_int64
    lib.lps_cram_writer_close.argtypes = [ct.c_void_p]


def cram_writer_open(path: str, header_text: str, fasta_path: str = ""):
    lib = _load()
    if lib is None or os.environ.get("LPS_NO_NATIVE_CRAM"):
        return None
    _cram_writer_bind(lib)
    hdr = header_text.encode("latin-1")
    w = lib.lps_cram_writer_open(path.encode(), hdr, len(hdr),
                                 (fasta_path or "").encode())
    return w or None


def cram_writer_container(w, rec_blobs: list[bytes], tid: int) -> bool:
    lib = _load()
    blob = b"".join(rec_blobs)
    off = np.zeros(len(rec_blobs) + 1, np.int64)
    np.cumsum([len(b) for b in rec_blobs], out=off[1:])
    return lib.lps_cram_writer_container(w, blob, off.ctypes.data,
                                         len(rec_blobs), tid) == 0


def cram_writer_close(w) -> bool:
    lib = _load()
    return lib.lps_cram_writer_close(w) == 0


def bgzf_inflate_span(raw: bytes):
    """Batched BGZF span inflate: decode all complete blocks in ``raw``.
    Returns (data, block_coffsets, block_uoffsets(+total), used_bytes) or
    None when unavailable/malformed."""
    import ctypes as ct

    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_span_bound", False):
        lib._span_bound = True
        lib.lps_bgzf_inflate_span.restype = ct.c_int64
        lib.lps_bgzf_inflate_span.argtypes = [
            ct.c_char_p, ct.c_int64, ct.POINTER(ct.c_void_p),
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_void_p),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64)]
    out_p = ctypes.c_void_p()
    coff_p = ctypes.c_void_p()
    uoff_p = ctypes.c_void_p()
    n_blocks = ctypes.c_int64()
    n_used = ctypes.c_int64()
    n = lib.lps_bgzf_inflate_span(raw, len(raw), ctypes.byref(out_p),
                                  ctypes.byref(coff_p), ctypes.byref(uoff_p),
                                  ctypes.byref(n_blocks), ctypes.byref(n_used))
    if n < 0:
        return None
    try:
        data = ctypes.string_at(out_p, n)
        nb = n_blocks.value
        coff = list(np.ctypeslib.as_array(
            ctypes.cast(coff_p, ctypes.POINTER(ctypes.c_int64)), (max(nb, 1),))
            [:nb])
        uoff = list(np.ctypeslib.as_array(
            ctypes.cast(uoff_p, ctypes.POINTER(ctypes.c_int64)), (nb + 1,)))
        return data, coff, uoff, n_used.value
    finally:
        lib.lps_buf_free(out_p)
        lib.lps_buf_free(coff_p)
        lib.lps_buf_free(uoff_p)

def _marshal_var_tables(positions, infos):
    n = len(positions)
    return {
        "n": n,
        "var_pos": np.asarray(positions, dtype=np.int64),
        "ref0": np.frombuffer(
            "".join((i.ref[0] if i.ref else "N")
                    for i in infos).encode("ascii"), dtype=np.uint8)
        if n else np.zeros(0, np.uint8),
        "alt0": np.frombuffer(
            "".join((i.alt[0] if i.alt else "N")
                    for i in infos).encode("ascii"), dtype=np.uint8)
        if n else np.zeros(0, np.uint8),
        "ref_len": np.fromiter((len(i.ref) for i in infos), np.int32, n),
        "alt_len": np.fromiter((len(i.alt) for i in infos), np.int32, n),
        "danger": np.fromiter((1 if i.is_danger else 0 for i in infos),
                              np.uint8, n),
    }


def _marshal_svmod(sv_entries, mod_entries):
    svs = sv_entries or []
    mods = mod_entries or []
    names = []
    flags = []
    for _p, e in mods:
        for qname, (rev, is_modify) in e.items():
            names.append(qname)
            flags.append((1 if rev else 0) | (2 if is_modify else 0))
    entry_off = np.zeros(len(mods) + 1, np.int64)
    np.cumsum([len(e) for _p, e in mods], out=entry_off[1:])
    name_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(s) for s in names], out=name_off[1:])
    return {
        "n_sv": len(svs),
        "sv_start": np.asarray([p for p, _l in svs], np.int64),
        "sv_len": np.asarray([l for _p, l in svs], np.int64),
        "n_mod": len(mods),
        "mod_pos": np.asarray([p for p, _e in mods], np.int64),
        "entry_off": entry_off,
        "name_blob": "".join(names).encode("latin-1"),
        "name_off": name_off,
        "flags": np.asarray(flags, np.uint8),
    }


def _read_extract_result(lib, handle):
    try:
        n_obs = ctypes.c_int64()
        n_aln = ctypes.c_int64()
        names_len = ctypes.c_int64()
        n_clip = ctypes.c_int64()
        lib.lps_result_sizes(handle, ctypes.byref(n_obs), ctypes.byref(n_aln),
                             ctypes.byref(names_len), ctypes.byref(n_clip))
        obs_pos = np.empty(n_obs.value, np.int64)
        obs_allele = np.empty(n_obs.value, np.int8)
        obs_qual = np.empty(n_obs.value, np.int16)
        aln_offsets = np.empty(n_aln.value + 1, np.int64)
        aln_start = np.empty(n_aln.value, np.int32)
        name_offsets = np.empty(n_aln.value + 1, np.int64)
        names = ctypes.create_string_buffer(max(names_len.value, 1))
        clip_pos = np.empty(n_clip.value, np.int64)
        clip_side = np.empty(n_clip.value, np.int8)
        lib.lps_result_fill(
            handle, obs_pos.ctypes.data, obs_allele.ctypes.data,
            obs_qual.ctypes.data, aln_offsets.ctypes.data,
            aln_start.ctypes.data, name_offsets.ctypes.data, names,
            clip_pos.ctypes.data, clip_side.ctypes.data)
        return {
            "obs_pos": obs_pos, "obs_allele": obs_allele, "obs_qual": obs_qual,
            "aln_offsets": aln_offsets, "aln_start": aln_start,
            "name_offsets": name_offsets,
            "names": names.raw[:names_len.value].decode("ascii"),
            "clip_pos": clip_pos, "clip_side": clip_side,
        }
    finally:
        lib.lps_result_free(handle)


def _stream_bind(lib):
    import ctypes as ct
    if getattr(lib, "_stream_bound", False):
        return
    lib._stream_bound = True
    lib.lps_scan_records.restype = ct.c_int64
    lib.lps_scan_records.argtypes = [
        ct.c_char_p, ct.c_int64, ct.c_int32, ct.c_int64, ct.c_int32,
        ct.c_void_p, ct.c_int64, ct.POINTER(ct.c_int64),
        ct.POINTER(ct.c_int32)]
    lib.lps_extract_phase_batch.restype = ct.c_void_p
    lib.lps_extract_phase_batch.argtypes = [
        ct.c_char_p, ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_void_p,
        ct.c_char_p, ct.c_char_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_char_p, ct.c_int64,
        ct.c_int64, ct.c_void_p, ct.c_void_p,
        ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_char_p, ct.c_void_p,
        ct.c_void_p, ct.c_int32, ct.c_double]


def extract_phase_streaming(bam_path: str, chrom: str, last_snp_pos: int,
                            positions, infos, ref_string: str,
                            mapping_quality: int, sv_entries=None,
                            mod_entries=None, sv_window: int = 20,
                            sv_threshold: float = 0.1,
                            window_bytes: int = 64 << 20):
    """Bounded-memory native extraction for files too large to hold
    inflated in RAM: BAI-seek to the chromosome, stream uncompressed
    windows (native span inflate) through the native record scanner and
    the same batch walk the whole-file paths use, concatenating the flat
    results. Peak memory ~= one window + the accumulated observation
    arrays."""
    lib = _load()
    if lib is None:
        return None
    _stream_bind(lib)
    from ..io.bam import BamReader

    br = BamReader(bam_path)
    try:
        if chrom not in br.ref_id:
            return {"obs_pos": np.zeros(0, np.int64),
                    "obs_allele": np.zeros(0, np.int8),
                    "obs_qual": np.zeros(0, np.int16),
                    "aln_offsets": np.zeros(1, np.int64),
                    "aln_start": np.zeros(0, np.int32),
                    "name_offsets": np.zeros(1, np.int64), "names": "",
                    "clip_pos": np.zeros(0, np.int64),
                    "clip_side": np.zeros(0, np.int8)}
        tid = br.seek_chromosome(chrom)
        t = _marshal_var_tables(positions, infos)
        sm = _marshal_svmod(sv_entries, mod_entries)
        ref_bytes = ref_string.encode("ascii")
        parts = []
        carry = b""
        max_off = max(window_bytes // 64, 1024)
        offsets = np.empty(max_off, np.int64)
        while True:
            buf = carry + br._bgzf.read(window_bytes)
            if not buf:
                break
            n_used = ctypes.c_int64()
            stop = ctypes.c_int32()
            n_rec = lib.lps_scan_records(
                buf, len(buf), tid, last_snp_pos, mapping_quality,
                offsets.ctypes.data, max_off, ctypes.byref(n_used),
                ctypes.byref(stop))
            if n_rec > 0:
                handle = lib.lps_extract_phase_batch(
                    buf, offsets.ctypes.data, n_rec,
                    t["n"], t["var_pos"].ctypes.data, t["ref0"].tobytes(),
                    t["alt0"].tobytes(), t["ref_len"].ctypes.data,
                    t["alt_len"].ctypes.data, t["danger"].ctypes.data,
                    ref_bytes, len(ref_bytes),
                    sm["n_sv"], sm["sv_start"].ctypes.data,
                    sm["sv_len"].ctypes.data, sm["n_mod"],
                    sm["mod_pos"].ctypes.data, sm["entry_off"].ctypes.data,
                    sm["name_blob"], sm["name_off"].ctypes.data,
                    sm["flags"].ctypes.data, sv_window, float(sv_threshold))
                if not handle:
                    return None
                parts.append(_read_extract_result(lib, handle))
            if stop.value:
                break
            used = n_used.value
            if used == 0 and n_rec == 0:
                # window smaller than one record: grow and retry
                more = br._bgzf.read(window_bytes)
                if not more:
                    break
                carry = buf + more
                continue
            carry = buf[used:]
        # concatenate batches (offsets shift by running totals)
        if not parts:
            parts = []
        out = {"obs_pos": [], "obs_allele": [], "obs_qual": [],
               "aln_start": [], "clip_pos": [], "clip_side": []}
        aln_offsets = [np.zeros(1, np.int64)]
        name_offsets = [np.zeros(1, np.int64)]
        names = []
        obs_base = 0
        name_base = 0
        for p in parts:
            for k in out:
                out[k].append(p[k])
            aln_offsets.append(p["aln_offsets"][1:] + obs_base)
            name_offsets.append(p["name_offsets"][1:] + name_base)
            obs_base += len(p["obs_pos"])
            name_base += len(p["names"])
            names.append(p["names"])
        res = {k: (np.concatenate(v) if v else np.zeros(0)) for k, v in
               out.items()}
        res["obs_pos"] = res["obs_pos"].astype(np.int64, copy=False)
        res["obs_allele"] = res["obs_allele"].astype(np.int8, copy=False)
        res["obs_qual"] = res["obs_qual"].astype(np.int16, copy=False)
        res["aln_start"] = res["aln_start"].astype(np.int32, copy=False)
        res["clip_pos"] = res["clip_pos"].astype(np.int64, copy=False)
        res["clip_side"] = res["clip_side"].astype(np.int8, copy=False)
        res["aln_offsets"] = np.concatenate(aln_offsets)
        res["name_offsets"] = np.concatenate(name_offsets)
        res["names"] = "".join(names)
        return res
    finally:
        br.close()


def _unpacked_bind(lib):
    import ctypes as ct
    if getattr(lib, "_unpacked_bound", False):
        return
    lib._unpacked_bound = True
    lib.lps_bam_load_unpacked.restype = ct.c_void_p
    lib.lps_bam_load_unpacked.argtypes = [
        ct.c_char_p, ct.c_int64, ct.c_int64, ct.c_char_p, ct.c_void_p,
        ct.c_void_p, ct.c_char_p, ct.c_void_p, ct.c_int64]


def bam_handle_from_records(header_text: str, references, lengths,
                            blob: bytes, rec_off) -> "NativeBam | None":
    """In-memory NativeBam over raw record blobs (window handles for the
    streaming tag runtime; also used by the CRAM loader)."""
    lib = _load()
    if lib is None:
        return None
    _tag_bind(lib)
    _unpacked_bind(lib)
    names_blob = "".join(references).encode("latin-1")
    name_off = np.zeros(len(references) + 1, np.int64)
    np.cumsum([len(s) for s in references], out=name_off[1:])
    ref_lens = np.asarray(lengths, np.int64)
    hdr = header_text.encode("latin-1")
    rec_off = np.ascontiguousarray(rec_off, np.int64)
    if isinstance(blob, np.ndarray):
        blob_arg = ctypes.c_char_p(np.ascontiguousarray(blob).ctypes.data)
    else:
        blob_arg = blob
    h = lib.lps_bam_load_unpacked(
        hdr, len(hdr), len(references), names_blob, name_off.ctypes.data,
        ref_lens.ctypes.data, blob_arg, rec_off.ctypes.data,
        len(rec_off) - 1)
    if not h:
        return None
    nb = NativeBam.__new__(NativeBam)
    nb._lib = lib
    nb._h = h
    nb.path = None
    return nb


def _tagw_bind(lib):
    import ctypes as ct
    if getattr(lib, "_tagw_bound", False):
        return
    lib._tagw_bound = True
    lib.lps_scan_tid_records.restype = ct.c_int64
    lib.lps_scan_tid_records.argtypes = [
        ct.c_char_p, ct.c_int64, ct.c_int32, ct.c_void_p, ct.c_int64,
        ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32)]
    lib.lps_tagw_open.restype = ct.c_void_p
    lib.lps_tagw_open.argtypes = [
        ct.c_char_p, ct.c_int64, ct.c_int64, ct.c_char_p, ct.c_void_p,
        ct.c_void_p, ct.c_char_p, ct.c_int32]
    lib.lps_tagw_feed.restype = ct.c_int64
    lib.lps_tagw_feed.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_char_p, ct.c_void_p]
    lib.lps_tagw_close.restype = ct.c_int64
    lib.lps_tagw_close.argtypes = [ct.c_void_p]


def tagw_open(header_text: str, references, lengths, out_path: str,
              level: int = 3):
    lib = _load()
    if lib is None:
        return None
    _tagw_bind(lib)
    names_blob = "".join(references).encode("latin-1")
    name_off = np.zeros(len(references) + 1, np.int64)
    np.cumsum([len(s) for s in references], out=name_off[1:])
    ref_lens = np.asarray(lengths, np.int64)
    hdr = header_text.encode("latin-1")
    w = lib.lps_tagw_open(hdr, len(hdr), len(references), names_blob,
                          name_off.ctypes.data, ref_lens.ctypes.data,
                          out_path.encode(), level)
    return w or None


def tagw_feed(w, window_nb: "NativeBam", rec_indices, mode, hp_int, ps, pq,
              hp_strs) -> bool:
    lib = _load()
    rec_indices = np.ascontiguousarray(rec_indices, np.int64)
    mode = np.ascontiguousarray(mode, np.uint8)
    hp_int = np.ascontiguousarray(hp_int, np.int32)
    ps = np.ascontiguousarray(ps, np.int64)
    pq = np.ascontiguousarray(pq, np.int32)
    blob, off = _hp_blob(hp_strs)
    return lib.lps_tagw_feed(
        w, window_nb._h, len(rec_indices), rec_indices.ctypes.data,
        mode.ctypes.data, hp_int.ctypes.data, ps.ctypes.data, pq.ctypes.data,
        blob, off.ctypes.data) == 0


def tagw_close(w) -> bool:
    lib = _load()
    return lib.lps_tagw_close(w) >= 0


def scan_tid_records(buf: bytes, tid: int, max_offsets: int):
    """All complete records of ``tid`` in ``buf``; returns
    (offsets, used, stop)."""
    lib = _load()
    _tagw_bind(lib)
    offsets = np.empty(max_offsets, np.int64)
    n_used = ctypes.c_int64()
    stop = ctypes.c_int32()
    n = lib.lps_scan_tid_records(buf, len(buf), tid, offsets.ctypes.data,
                                 max_offsets, ctypes.byref(n_used),
                                 ctypes.byref(stop))
    return offsets[:n], n_used.value, bool(stop.value)


class StreamingBam:
    """Virtual whole-file handle for BAMs past the RAM budget: quacks like
    ``NativeBam`` for the tag runtimes. ``tag_walk`` streams bounded
    uncompressed windows, runs the native walk per window and returns the
    concatenated walk dict (observation-scale memory, not base-scale);
    ``tag_write`` replays the identical window sequence and feeds the
    streaming native writer with the recorded per-window record selections.
    CRAM output is unsupported (callers keep their object fallback)."""

    WINDOW = 64 << 20

    def __init__(self, path: str):
        from ..io.bam import BamReader

        self.path = path
        hdr = BamReader(path)
        self.header_text = hdr.header_text
        self.references = hdr.references
        self.lengths = hdr.lengths
        self._ref_id = hdr.ref_id
        hdr.close()
        # replay plan: chrom -> list of per-window local record selections
        self._plan: dict[str, list[np.ndarray]] = {}
        self._plan_walked: dict[str, tuple] = {}

    def close(self):
        pass

    def tid(self, chrom: str) -> int:
        return self._ref_id.get(chrom, -1)

    def _windows(self, chrom: str):
        """Deterministic window stream over the chromosome's records:
        yields (blob, blob_off) of complete tid records per window."""
        from ..io.bam import BamReader

        br = BamReader(self.path)
        try:
            tid = br.seek_chromosome(chrom)
            carry = b""
            while True:
                buf = carry + br._bgzf.read(self.WINDOW)
                if not buf:
                    break
                offs, used, stop = scan_tid_records(
                    buf, tid, max(self.WINDOW // 48, 1024))
                if len(offs):
                    import struct as _struct

                    sizes = [_struct.unpack_from("<i", buf, int(o) - 4)[0]
                             for o in offs]
                    blob = b"".join(buf[int(o):int(o) + s]
                                    for o, s in zip(offs, sizes))
                    boff = np.zeros(len(sizes) + 1, np.int64)
                    np.cumsum(sizes, out=boff[1:])
                    yield blob, boff
                if stop:
                    break
                if used == 0 and not len(offs):
                    more = br._bgzf.read(self.WINDOW)
                    if not more:
                        break
                    carry = buf + more
                    continue
                carry = buf[used:]
        finally:
            br.close()

    def tag_walk(self, chrom, beg, end, positions, last_var, ref_string,
                 quality_threshold, mapq_filter, tag_supplementary,
                 want_window=None, window: int = 100):
        if self.tid(chrom) < 0:
            return None
        parts = []
        plan: list[np.ndarray] = []
        for blob, boff in self._windows(chrom):
            wnb = bam_handle_from_records(self.header_text, self.references,
                                          self.lengths, blob, boff)
            if wnb is None:
                return None
            try:
                w = wnb.tag_walk(chrom, beg, end, positions, last_var,
                                 ref_string, quality_threshold, mapq_filter,
                                 tag_supplementary, want_window=want_window,
                                 window=window)
            finally:
                wnb.close()
            if w is None:
                plan.append(np.zeros(0, np.int64))
                continue
            plan.append(w["rec_idx"].copy())  # window-local selection
            parts.append(w)
        self._plan[chrom] = plan
        if not parts:
            return {k: np.zeros(0, d) for k, d in (
                ("rec_idx", np.int64), ("category", np.uint8),
                ("flag", np.uint16), ("mapq", np.uint8), ("pos", np.int64),
                ("end_ref_pos", np.int64), ("end_query_pos", np.int64),
                ("obs_aln", np.int32), ("obs_var", np.int32),
                ("obs_kind", np.uint8), ("obs_base", np.uint8),
                ("obs_flags", np.uint8), ("obs_aux", np.int32),
                ("wd_obs", np.int64), ("wd_off", np.int16),
                ("wd_base", np.uint8))} | {
                    "name_off": np.zeros(1, np.int64), "names": ""}
        out = {}
        plain = ("category", "flag", "mapq", "pos", "end_ref_pos",
                 "end_query_pos", "obs_var", "obs_kind", "obs_base",
                 "obs_flags", "obs_aux", "wd_off", "wd_base")
        for k in plain:
            out[k] = np.concatenate([p[k] for p in parts])
        rec_parts, aln_parts, wd_parts, name_off_parts = [], [], [], [
            np.zeros(1, np.int64)]
        rec_base = aln_base = obs_base = name_base = 0
        names = []
        for p in parts:
            rec_parts.append(p["rec_idx"] + rec_base)
            aln_parts.append(p["obs_aln"] + aln_base)
            wd_parts.append(p["wd_obs"] + obs_base)
            name_off_parts.append(p["name_off"][1:] + name_base)
            rec_base += len(p["rec_idx"])
            aln_base += len(p["category"])
            obs_base += len(p["obs_aln"])
            name_base += len(p["names"])
            names.append(p["names"])
        out["rec_idx"] = np.concatenate(rec_parts)
        out["obs_aln"] = np.concatenate(aln_parts)
        out["wd_obs"] = np.concatenate(wd_parts)
        out["name_off"] = np.concatenate(name_off_parts)
        out["names"] = "".join(names)
        return out

    def tag_write(self, header_text, rec_indices, mode, hp_int, ps, pq,
                  hp_strs, out_path, level: int = 3) -> bool:
        """Replay the walked window sequence (same deterministic scan) and
        feed each window's decision slice to the streaming writer. The
        decision arrays must be in walk order (they are: the tag pipelines
        concatenate per-chromosome walk outputs)."""
        w = tagw_open(header_text, self.references, self.lengths, out_path,
                      level)
        if w is None:
            return False
        mode = np.ascontiguousarray(mode, np.uint8)
        hp_int = np.ascontiguousarray(hp_int, np.int32)
        ps = np.ascontiguousarray(ps, np.int64)
        pq = np.ascontiguousarray(pq, np.int32)
        cursor = 0
        ok = True
        for chrom, plan in self._plan.items():
            wi = 0
            for blob, boff in self._windows(chrom):
                local = plan[wi] if wi < len(plan) else np.zeros(0, np.int64)
                wi += 1
                n = len(local)
                if n == 0:
                    continue
                wnb = bam_handle_from_records(
                    self.header_text, self.references, self.lengths, blob,
                    boff)
                if wnb is None:
                    ok = False
                    break
                try:
                    sl = slice(cursor, cursor + n)
                    if isinstance(hp_strs, tuple):
                        blob, off = hp_strs
                        base = int(off[cursor])
                        hp_sl = (blob[base:int(off[cursor + n])],
                                 off[cursor:cursor + n + 1] - base)
                    else:
                        hp_sl = hp_strs[cursor:cursor + n]
                    ok = tagw_feed(w, wnb, local, mode[sl], hp_int[sl],
                                   ps[sl], pq[sl], hp_sl) and ok
                finally:
                    wnb.close()
                cursor += n
            if not ok:
                break
        return tagw_close(w) and ok and cursor == len(mode)

    def tag_write_cram(self, *a, **kw):
        raise RuntimeError("streaming handle does not support CRAM output")


class CramStreamingBam(StreamingBam):
    """Container-streaming CRAM handle for the tag runtimes: windows are
    batches of CRAM containers decoded natively on demand (no whole-file
    BAM image), so memory stays bounded and one-shot runs skip the
    decode-everything-first step."""

    CONTAINERS_PER_WINDOW = 4

    def __init__(self, path: str, fasta_path: str):
        from ..io.cram import CramReader, cram_container_index

        self.path = path
        self._fasta_path = fasta_path or ""
        cr = CramReader(path)  # header parse only (no record decode)
        self.header_text = cr.header_text
        self.references = cr.references
        self.lengths = cr.lengths
        self._ref_id = cr.ref_id
        cr.close()
        self._containers = cram_container_index(path)
        if any(rid == -2 for _o, rid, _n in self._containers):
            raise RuntimeError("multi-reference CRAM containers unsupported "
                               "by the streaming handle")
        self._plan = {}

    def _windows(self, chrom: str):
        tid = self.tid(chrom)
        batch = []
        for off, rid, nrec in self._containers:
            if rid != tid:
                continue
            batch.append(off)
            if len(batch) >= self.CONTAINERS_PER_WINDOW:
                yield self._decode(batch)
                batch = []
        if batch:
            yield self._decode(batch)

    def _decode(self, offsets):
        res = cram_decode(self.path, self._fasta_path, offsets)
        if res is None:
            raise RuntimeError("native CRAM decode failed mid-stream")
        blob, rec_off = res
        return blob, rec_off
