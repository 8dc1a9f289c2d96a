"""Vectorized modcall fast path over the native MM/ML walk.

The per-read work (MM/ML decode + methylation CIGAR walk + order-sensitive
per-position counters + depth) runs in C++ (`lps_modcall_walk`,
native/lps_ingest.cpp); genotype judgement, graph edge counting, and VCF
export are replayed here as NumPy array programs. Behavioral contracts:
  judgeMethGenotype        (reference ModCallParsingBam.cpp:625-733)
  MethylationGraph addEdge (reference ModCallParsingBam.cpp:780-823)
  exportResult             (reference ModCallParsingBam.cpp:431-593)
Element-exact against the Python oracle in models/modcall.py (the golden
tests run both).
"""

from __future__ import annotations

import numpy as np

from ..native import open_chrom_native_bam, open_native_bam
from . import modcall as mc


def _statuses(meth, non, depth, heter_ratio, noise_ratio_cfg):
    """Vector judgeMethGenotype single-position rule.

    Returns int8 codes: -1 '', 0 '0/0', 1 '0/1', 2 '1/1'."""
    noise = depth - meth - non
    mx = np.maximum(meth, non)
    safe_mx = np.where(mx > 0, mx, 1.0)
    heter = np.minimum(meth, non) / safe_mx
    nr = np.where(depth > 0, noise / np.where(depth > 0, depth, 1.0), np.inf)
    is_het = (heter >= heter_ratio) & (nr <= noise_ratio_cfg)
    st = np.where(is_het, 1, np.where(meth >= non, 2, 0)).astype(np.int8)
    return np.where(mx == 0, np.int8(-1), st)


def _in_sorted(sorted_arr, values):
    idx = np.searchsorted(sorted_arr, values)
    ok = idx < len(sorted_arr)
    idx_c = np.minimum(idx, max(len(sorted_arr) - 1, 0))
    if len(sorted_arr) == 0:
        return np.zeros(len(values), bool)
    return ok & (sorted_arr[idx_c] == values)


_STATUS_STR = {-1: "", 0: "0/0", 1: "0/1", 2: "1/1"}


class _FastGraph(mc.MethylationGraph):
    """MethylationGraph with node_info/edges built from arrays.

    node_info maps pos -> range(distinct_read_count) so the oracle
    connect_results' len()/membership reads keep working; _vtype reads a
    per-position dict (every event at one position shares a vtype — the
    walk-time variantType gate guarantees SNP and MOD events never share a
    remapped position)."""

    def __init__(self, cfg, node_counts, node_vtypes, edges):
        super().__init__(cfg)
        self.node_info = {p: range(c) for p, c in node_counts.items()}
        self._vtypes = node_vtypes
        self.edges = edges

    def _vtype(self, pos):
        return self._vtypes.get(pos, -1)


def run_chrom_fast(cfg, chrom, chrom_len, chr_seq, positions, infos,
                   has_snp, out):
    """Full fast-path modcall for one chromosome. Returns True on success,
    False to fall back to the object pipeline."""
    if len(cfg.bam_files) != 1:
        return False
    nb = open_native_bam(cfg.bam_files[0], cfg.fasta_file)
    owned = False
    if nb is None:
        # past the whole-file RAM budget: stream this chromosome's records
        # into a per-chromosome handle (memory = one chromosome, not the
        # file) and run the identical walk on it
        nb = open_chrom_native_bam(cfg.bam_files[0], cfg.fasta_file, chrom)
        owned = True
    if nb is None:
        return False
    try:
        return _run_chrom_on_handle(cfg, nb, chrom, chrom_len, chr_seq,
                                    positions, infos, has_snp, out)
    finally:
        if owned:
            nb.close()


def _run_chrom_on_handle(cfg, nb, chrom, chrom_len, chr_seq, positions,
                         infos, has_snp, out):

    n = len(positions)
    var_pos = np.asarray(positions, np.int64)
    var_ref0 = np.fromiter((ord(i.ref[0]) for i in infos), np.uint8, n)
    var_alt0 = np.fromiter((ord(i.alt[0]) for i in infos), np.uint8, n)
    var_reflen = np.fromiter((len(i.ref) for i in infos), np.int32, n)
    var_altlen = np.fromiter((len(i.alt) for i in infos), np.int32, n)
    var_danger = np.fromiter((i.is_danger for i in infos), np.uint8, n)

    w = nb.modcall_walk(chrom, chrom_len, var_pos, var_ref0, var_alt0,
                        var_reflen, var_altlen, var_danger, chr_seq,
                        cfg.mod_threshold * 255, cfg.unmod_threshold * 255)
    if w is None:
        return True  # chromosome absent from BAM: nothing to emit

    m_pos = w["m_pos"]
    meth = w["m_meth"].astype(np.float64)
    non = w["m_canon"].astype(np.float64)
    depth = w["m_depth"].astype(np.float64)
    m_strand = w["m_strand"]
    m_vtype = w["m_vtype"]
    M = len(m_pos)

    # --- judgeMethGenotype: single positions, then +/- CpG pair merge ---
    status = _statuses(meth, non, depth, cfg.heter_ratio, cfg.noise_ratio)
    pair_pos = np.zeros(0, np.int64)
    if M > 1:
        adj = ((m_pos[1:] == m_pos[:-1] + 1) & (m_strand[:-1] == 0)
               & (m_strand[1:] == 1) & (m_vtype[:-1] == mc.VT_MOD)
               & (m_vtype[1:] == mc.VT_MOD))
        ii = np.nonzero(adj)[0]
        if len(ii):
            t_meth = meth[ii] + meth[ii + 1]
            t_non = non[ii] + non[ii + 1]
            t_depth = depth[ii] + depth[ii + 1]
            valid = np.maximum(t_meth, t_non) != 0
            ps = _statuses(t_meth, t_non, t_depth, cfg.heter_ratio,
                           cfg.noise_ratio)
            iv = ii[valid]
            status[iv] = ps[valid]
            status[iv + 1] = ps[valid]
            pair_pos = m_pos[iv[ps[valid] == 1]]

    # --- per-read variant re-filtering (judgeMethGenotype tail) ---
    ev_pos = w["ev_pos"]
    ev_allele = w["ev_allele"]
    ev_vtype = w["ev_vtype"]
    n_app = len(w["aread"])
    ev_read = np.repeat(np.arange(n_app, dtype=np.int64),
                        np.diff(w["aread_off"]))
    is_mod = ev_vtype == mc.VT_MOD
    eidx = np.searchsorted(m_pos, ev_pos)
    estrand = m_strand[np.minimum(eidx, max(M - 1, 0))] if M else \
        np.zeros(len(ev_pos), np.int8)
    new_pos = np.where(is_mod & (estrand == 1), ev_pos - 1, ev_pos)
    keep_mod = _in_sorted(pair_pos, new_pos)
    keep = ~is_mod | keep_mod
    f_pos = new_pos[keep]
    f_allele = ev_allele[keep].astype(np.int64)
    f_vtype = ev_vtype[keep]
    f_read = ev_read[keep]

    # --- MethylationGraph.add_edge, vectorized ---
    # node_info: distinct read NAMES per position (native name interning
    # supplies a per-read unique-name id) + shared per-position vtype
    name_off = w["name_off"]
    names_blob = w["names"]
    name_uid = w["r_nameid"][w["aread"]].astype(np.int64) if n_app else \
        np.zeros(0, np.int64)
    n_names = int(name_off.shape[0]) - 1
    f_name = name_uid[f_read] if len(f_read) else np.zeros(0, np.int64)

    node_counts: dict[int, int] = {}
    node_vtypes: dict[int, int] = {}
    if len(f_pos):
        pn = np.unique(f_pos * (n_names + 1) + f_name)
        upos, ucnt = np.unique(pn // (n_names + 1), return_counts=True)
        node_counts = dict(zip(upos.tolist(), ucnt.tolist()))
        fpos_u, first_i = np.unique(f_pos, return_index=True)
        node_vtypes = dict(zip(fpos_u.tolist(),
                               f_vtype[first_i].astype(int).tolist()))

    edges: dict[tuple, dict] = {}
    E = len(f_pos)
    if E:
        from ..ops import tag_kernels
        dev = None
        if tag_kernels.engine(len(f_pos) * 8) == "device":
            dev = tag_kernels.modcall_edges_device(f_pos, f_allele, f_vtype,
                                                   f_read)
        if dev is not None:
            up1a, up2a, cnt = dev
        else:
            p1s, a1s, p2s, a2s = [], [], [], []
            for d in range(1, 51):
                if d >= E:
                    break
                same = f_read[:-d] == f_read[d:]
                snp2 = (f_vtype[:-d] == mc.VT_SNP) & \
                    (f_vtype[d:] == mc.VT_SNP)
                sel = same & ~snp2
                if sel.any():
                    p1s.append(f_pos[:-d][sel])
                    a1s.append(f_allele[:-d][sel])
                    p2s.append(f_pos[d:][sel])
                    a2s.append(f_allele[d:][sel])
            up1a = np.zeros(0, np.int64)
            up2a = np.zeros(0, np.int64)
            cnt = np.zeros(0, np.int64)
            if p1s:
                p1 = np.concatenate(p1s)
                a1 = np.concatenate(a1s)
                p2 = np.concatenate(p2s)
                a2 = np.concatenate(a2s)
                # composite int64 key: (p1,a1) x (delta,a2); deltas are
                # bounded by the read span, well inside 63 bits
                dd = p2 - p1
                K = 2 * (int(dd.max()) + 1)
                key = (p1 * 2 + a1) * K + dd * 2 + a2
                uq, cnt = np.unique(key, return_counts=True)
                up2a = uq % K
                up1a = uq // K
        for k1, k2, c in zip(up1a.tolist(), up2a.tolist(), cnt.tolist()):
            cell = edges.setdefault((k1 >> 1, k1 & 1), {}).setdefault(
                (k1 >> 1) + (k2 >> 1), [0, 0])
            cell[k2 & 1] += c
        # alleles outside {0,1} never occur: SNP/MOD events are only
        # emitted with allele 0/1 (see lps_modcall_walk)

    graph = _FastGraph(cfg, node_counts, node_vtypes, edges)
    pass_positions: list[int] = []
    graph.connect_results(pass_positions, has_snp)

    # --- exportResult over a dict facade of the meth table ---
    needed: set[int] = set()
    if cfg.output_all_mod:
        needed = set(m_pos.tolist())
    else:
        for p in pass_positions:
            needed.add(p)
            needed.add(p + 1)
    mr_order = np.argsort(w["mr_idx"], kind="stable")
    nr_order = np.argsort(w["nr_idx"], kind="stable")
    mr_sorted = w["mr_idx"][mr_order]
    nr_sorted = w["nr_idx"][nr_order]

    r_nameid = w["r_nameid"]

    def _names_for(order, sorted_idx, reads, mi):
        lo = np.searchsorted(sorted_idx, mi, side="left")
        hi = np.searchsorted(sorted_idx, mi, side="right")
        sel = order[lo:hi]
        sel.sort()  # restore append order
        return [names_blob[name_off[r_nameid[reads[k]]]:
                           name_off[r_nameid[reads[k]] + 1]]
                for k in sel.tolist()]

    chr_meth: dict[int, mc.MethPosInfo] = {}
    pos_to_idx = {int(p): i for i, p in enumerate(m_pos.tolist())}
    for p in needed:
        mi = pos_to_idx.get(p)
        if mi is None:
            continue
        chr_meth[p] = mc.MethPosInfo(
            methreadcnt=int(w["m_meth"][mi]),
            noisereadcnt=int(w["m_noise"][mi]),
            canonreadcnt=int(w["m_canon"][mi]),
            depth=int(w["m_depth"][mi]),
            heterstatus=_STATUS_STR[int(status[mi])],
            strand=int(m_strand[mi]),
            variant_type=int(m_vtype[mi]),
            mod_reads=_names_for(mr_order, mr_sorted, w["mr_read"], mi),
            nonmod_reads=_names_for(nr_order, nr_sorted, w["nr_read"], mi),
        )
    if cfg.output_all_mod:
        # the all-mode loop iterates every position in walk order; feed the
        # full table so the abnormal-position early-return quirk is exact
        for i, p in enumerate(m_pos.tolist()):
            if p not in chr_meth:
                chr_meth[p] = mc.MethPosInfo(
                    methreadcnt=int(w["m_meth"][i]),
                    noisereadcnt=int(w["m_noise"][i]),
                    canonreadcnt=int(w["m_canon"][i]),
                    depth=int(w["m_depth"][i]),
                    heterstatus=_STATUS_STR[int(status[i])],
                    strand=int(m_strand[i]),
                    variant_type=int(m_vtype[i]),
                    mod_reads=_names_for(mr_order, mr_sorted,
                                         w["mr_read"], i),
                    nonmod_reads=_names_for(nr_order, nr_sorted,
                                            w["nr_read"], i),
                )
    mc.export_result(cfg, chr_meth, chrom, chr_seq, chrom_len,
                     pass_positions, out)
    return True
