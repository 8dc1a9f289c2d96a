"""Vectorized somatic extraction passes over the native BAM walk.

Replaces the per-read Python CIGAR walks of ``somatic_caller`` (normal-BAM
extraction, tumor-BAM extraction) with flat observation arrays from
``native.NativeBam.tag_walk`` and NumPy judge/counter expressions. Produces
the exact data structures the calling stages consume (pos -> PosBase /
SomaticData, read_hp_result_set, tumor_pos_read_corr), matching the
reference semantics:
  ExtractNorData*   SomaticVarCaller.cpp:75-293
  ExtractTumData*   SomaticVarCaller.cpp:296-759
  judgeSomaticSnpHap / judgeNormalSnpHap  HaplotagStrategy.cpp:315-435
  judgeSomaticReadHap                     HaplotagStrategy.cpp:452-602
  classifyReadsByCase                     SomaticVarCaller.cpp:462-518
"""

from __future__ import annotations

import numpy as np

from ..io.phased_vcf import (NORMAL, PHASED_HETERO, TUMOR, UNPHASED_HETERO,
                             UNPHASED_HOMO, VT_DELETION, VT_INSERTION, VT_SNP)
from ..models.haplotag_fast import judge_reads
from .somatic_types import (GERMLINE_H1, GERMLINE_H2, PosBase, ReadVarHpCount,
                            RH_H1, RH_H1_1, RH_H2, RH_H2_1, RH_H3, RH_UNTAG,
                            SOMATIC_H3, SomaticData, calculate_base_common_info)

_BASE_CODE = np.full(256, 4, np.int8)  # A/C/G/T -> 0..3, else 4 (unknown)
for _i, _c in enumerate("ACGT"):
    _BASE_CODE[ord(_c)] = _i


def build_somatic_tables(positions, variants):
    """Flat per-variant NORMAL/TUMOR lookup tables for the somatic judges."""
    n = len(positions)
    t = {
        "pos": np.asarray(positions, dtype=np.int64),
        # NORMAL (phased-het) fields
        "nor_has": np.zeros(n, bool),
        "nor_vt": np.zeros(n, np.int8),
        "nor_gt": np.full(n, -1, np.int8),
        "nor_ps": np.full(n, -1, np.int64),
        "nor_ref0": np.zeros(n, np.uint8),
        "nor_alt0": np.zeros(n, np.uint8),
        "nor_hp1c": np.zeros(n, np.uint8),
        "nor_hp2c": np.zeros(n, np.uint8),
        "alt_eq_hp1": np.zeros(n, bool),
        "alt_eq_hp2": np.zeros(n, bool),
        "ref_eq_hp1": np.zeros(n, bool),
        "ref_eq_hp2": np.zeros(n, bool),
        # germline-haplotag style (length heuristic) for the normal pass
        "hp1_long": np.zeros(n, bool),
        "hp2_long": np.zeros(n, bool),
        # TUMOR fields
        "tum_has": np.zeros(n, bool),
        "tum_vt": np.zeros(n, np.int8),
        "tum_gt": np.full(n, -1, np.int8),
        "tum_ps": np.full(n, -1, np.int64),
        "tum_ref0": np.zeros(n, np.uint8),
        "tum_alt0": np.zeros(n, np.uint8),
        "tum_ref_is1": np.zeros(n, bool),
        "tum_alt_is1": np.zeros(n, bool),
    }
    for i, p in enumerate(positions):
        entry = variants[p]
        nor = entry.get(NORMAL)
        if nor is not None:
            t["nor_has"][i] = True
            t["nor_vt"][i] = nor.variant_type
            t["nor_gt"][i] = nor.gt
            t["nor_ps"][i] = nor.phased_set
            if nor.ref:
                t["nor_ref0"][i] = ord(nor.ref[0])
            if nor.alt:
                t["nor_alt0"][i] = ord(nor.alt[0])
            if len(nor.hp1) == 1:
                t["nor_hp1c"][i] = ord(nor.hp1)
            if len(nor.hp2) == 1:
                t["nor_hp2c"][i] = ord(nor.hp2)
            t["alt_eq_hp1"][i] = nor.alt == nor.hp1
            t["alt_eq_hp2"][i] = nor.alt == nor.hp2
            t["ref_eq_hp1"][i] = nor.ref == nor.hp1
            t["ref_eq_hp2"][i] = nor.ref == nor.hp2
            t["hp1_long"][i] = len(nor.hp1) != 1
            t["hp2_long"][i] = len(nor.hp2) != 1
        tum = entry.get(TUMOR)
        if tum is not None:
            t["tum_has"][i] = True
            t["tum_vt"][i] = tum.variant_type
            t["tum_gt"][i] = tum.gt
            t["tum_ps"][i] = tum.phased_set
            if tum.ref:
                t["tum_ref0"][i] = ord(tum.ref[0])
            if tum.alt:
                t["tum_alt0"][i] = ord(tum.alt[0])
            t["tum_ref_is1"][i] = len(tum.ref) == 1
            t["tum_alt_is1"][i] = len(tum.alt) == 1
    return t


def obs_is_alt(walk, t):
    """CigarParser::IsAltIndel per observation, judged against the NORMAL
    entry when present else TUMOR (HaplotagParsingBam.cpp:650-670,
    cigar_walk.py:87-89)."""
    vi = walk["obs_var"]
    base = walk["obs_base"]
    fl = walk["obs_flags"]
    nh = t["nor_has"][vi]
    vt = np.where(nh, t["nor_vt"][vi], t["tum_vt"][vi])
    alt0 = np.where(nh, t["nor_alt0"][vi], t["tum_alt0"][vi])
    has_any = nh | t["tum_has"][vi]
    is_alt = np.zeros(len(vi), bool)
    is_alt |= (vt == VT_SNP) & (base == alt0)
    is_alt |= (vt == VT_INSERTION) & ((fl & 2) != 0)
    is_alt |= (vt == VT_DELETION) & ((fl & 4) != 0)
    return is_alt & has_any


def somatic_match_votes(walk, t, is_alt, mode, is_somatic=None):
    """judgeSomaticSnpHap over match observations
    (HaplotagStrategy.cpp:315-389). ``mode``: 'extract' | 'haplotag'.

    Returns dict of per-observation masks: h1, h2, h3 (votes), cps_nor,
    cps_tum, base_hp (0/1/2/3), tum_allele (b==tum.alt at tumor-only pos).
    Caller must AND with its mapq gate.
    """
    vi = walk["obs_var"]
    base = walk["obs_base"]
    kind0 = walk["obs_kind"] == 0

    # --- normal phased-het branch (judgeNormalSnpHap) ---
    nor = kind0 & t["nor_has"][vi] & (t["nor_gt"][vi] == PHASED_HETERO)
    nvt = t["nor_vt"][vi]
    n_snp = nor & (nvt == VT_SNP)
    snp_match = n_snp & ((base == t["nor_ref0"][vi]) | (base == t["nor_alt0"][vi]))
    h1 = snp_match & (base == t["nor_hp1c"][vi])
    h2 = snp_match & (base == t["nor_hp2c"][vi])
    cps_nor = snp_match.copy()
    n_ind = nor & ((nvt == VT_INSERTION) | (nvt == VT_DELETION))
    # b = alt when is_alt else ref; b always matches ref-or-alt for het
    h1 |= n_ind & np.where(is_alt, t["alt_eq_hp1"][vi], t["ref_eq_hp1"][vi])
    h2 |= n_ind & np.where(is_alt, t["alt_eq_hp2"][vi], t["ref_eq_hp2"][vi])
    cps_nor |= n_ind

    # --- tumor-only branch ---
    tum = kind0 & ~t["nor_has"][vi] & t["tum_has"][vi]
    tvt = t["tum_vt"][vi]
    t_snp_ind = tum & ((tvt == VT_SNP) | (tvt == VT_INSERTION)
                       | (tvt == VT_DELETION))
    base_eq_ref = t["tum_ref_is1"][vi] & (base == t["tum_ref0"][vi])
    base_eq_alt = t["tum_alt_is1"][vi] & (base == t["tum_alt0"][vi])
    matches = t_snp_ind & (
        np.where(tvt == VT_SNP, base_eq_ref | base_eq_alt, True))
    # also: MNP-type tumor vars match when base equals their (multi-char)
    # ref/alt -- impossible for a 1-char base, so t_snp_ind covers all
    h3 = matches & np.where(tvt == VT_SNP, base_eq_alt, is_alt)
    if mode == "haplotag":
        som = is_somatic[vi]
        h3 &= som
        cps_tum = matches & som & (t["tum_gt"][vi] == PHASED_HETERO)
    else:
        cps_tum = matches & (t["tum_gt"][vi] == PHASED_HETERO)

    base_hp = np.zeros(len(vi), np.int8)
    base_hp[h1] = GERMLINE_H1
    base_hp[h2] = GERMLINE_H2
    base_hp[h3] = SOMATIC_H3
    return {"h1": h1, "h2": h2, "h3": h3, "cps_nor": cps_nor,
            "cps_tum": cps_tum, "base_hp": base_hp, "tum_matches": matches}


def normal_pass_deletion_votes(walk, t, ref_string_nonempty):
    """ExtractNorWalker.process_deletion germline part: first phased-het
    NORMAL variant per deletion op, homopolymer>=3 rescue
    (somatic_caller.py:159-211, HaplotagStrategy.cpp:147-209).
    Returns (h1, h2, cps_nor) per-obs masks (in-deletion obs only).
    Caller must AND with its per-alignment mapq gate."""
    vi = walk["obs_var"]
    fl = walk["obs_flags"]
    base = walk["obs_base"]
    n_obs = len(vi)
    h1 = np.zeros(n_obs, bool)
    h2 = np.zeros(n_obs, bool)
    cps = np.zeros(n_obs, bool)
    if not ref_string_nonempty:
        return h1, h2, cps
    cand = (walk["obs_kind"] == 1) & t["nor_has"][vi] & \
        (t["nor_gt"][vi] == PHASED_HETERO)
    if not np.any(cand):
        return h1, h2, cps
    idx = np.flatnonzero(cand)
    aux = walk["obs_aux"][idx].astype(np.int64)
    group = walk["obs_aln"][idx].astype(np.int64) * (aux.max() + 1) + aux
    _, first = np.unique(group, return_index=True)
    sel = idx[first]
    sel = sel[(fl[sel] & 8) != 0]  # homopolymerLength >= 3
    svt = t["nor_vt"][vi[sel]]
    snp = sel[svt == VT_SNP]
    h1[snp[base[snp] == t["nor_hp1c"][vi[snp]]]] = True
    h2[snp[base[snp] == t["nor_hp2c"][vi[snp]]]] = True
    cps[snp] = True
    dele = sel[svt == VT_DELETION]
    only1 = t["hp1_long"][vi[dele]] & ~t["hp2_long"][vi[dele]]
    only2 = ~t["hp1_long"][vi[dele]] & t["hp2_long"][vi[dele]]
    h1[dele[only1]] = True
    h2[dele[only2]] = True
    cps[dele] = True
    return h1, h2, cps


def nor_ps_aggregate(walk, t, cps_nor):
    """Per-alignment distinct normal-PS count, min PS, and the sorted
    (aln, ps, count) triples for reconstructing nor_count_ps dicts."""
    al = walk["obs_aln"]
    A = len(walk["category"])
    n_ps = np.zeros(A, np.int64)
    min_ps = np.zeros(A, np.int64)
    cidx = np.flatnonzero(cps_nor)
    if not len(cidx):
        return n_ps, min_ps, ([0] * (A + 1), [], [])
    psv = t["nor_ps"][walk["obs_var"][cidx]]
    aln_ps = al[cidx].astype(np.int64)
    stride = psv.max() + 1
    uk, ucnt = np.unique(aln_ps * stride + psv, return_counts=True)
    u_aln = uk // stride
    n_ps = np.bincount(u_aln, minlength=A).astype(np.int64)
    ua, ufirst = np.unique(u_aln, return_index=True)
    min_ps[ua] = uk[ufirst] % stride
    # one bulk conversion + pointer table; nor_ps_dict slices Python lists
    ptr = np.searchsorted(u_aln, np.arange(A + 1)).tolist()
    return n_ps, min_ps, (ptr, (uk % stride).tolist(), ucnt.tolist())


def nor_ps_dict(ps_triples, a):
    """nor_count_ps dict for alignment ``a`` from the sorted triples."""
    ptr, psv, cnt = ps_triples
    if not psv:
        return {}
    lo, hi = ptr[a], ptr[a + 1]
    return dict(zip(psv[lo:hi], cnt[lo:hi]))


def judge_somatic_reads(h1, h2, h3, n_nor_ps, thr):
    """Vectorized judgeSomaticReadHap (HaplotagStrategy.cpp:452-602) with
    hp4 == 0 (findOtherSomaticSnpHP is dead in the reference).

    Returns (hp, pq, nor_sim, high_sim_mask, cross_mask, without_mask).
    """
    A = len(h1)
    nor_max = np.maximum(h1, h2).astype(np.float64)
    nor_min = np.minimum(h1, h2).astype(np.float64)
    nor_tot = nor_max + nor_min
    nor_sim = np.divide(nor_max, nor_tot, out=np.zeros(A), where=nor_max > 0)
    t_on = h3 > 0
    tum_sim = np.where(t_on, 1.0, 0.0)
    max_normal_h1 = h1 > h2  # ties -> GERMLINE_H2

    hp = np.zeros(A, np.int32)  # RH_UNTAG
    nor_ok = nor_sim >= thr
    cond_t = t_on & (tum_sim >= thr)
    hp[cond_t & nor_ok & max_normal_h1] = RH_H1_1
    hp[cond_t & nor_ok & ~max_normal_h1] = RH_H2_1
    hp[cond_t & ~nor_ok] = RH_H3
    high_sim_t = t_on & ~(tum_sim >= thr)
    n_on = ~t_on & (nor_max > 0)
    cond_n = n_on & nor_ok
    hp[cond_n & max_normal_h1] = RH_H1
    hp[cond_n & ~max_normal_h1] = RH_H2
    high_sim_n = n_on & ~nor_ok

    cross = n_nor_ps > 1
    hp[cross] = RH_UNTAG

    pq = np.zeros(A, np.int32)
    pq[t_on] = 40  # tum_min == 0 always
    nfull = ~t_on & (nor_max > 0) & (nor_min == 0)
    pq[nfull] = 40
    npart = ~t_on & (nor_min > 0)
    pq[npart] = (-10 * np.log10(nor_min[npart] / nor_tot[npart])).astype(np.int32)
    without = (nor_max == 0) & ~t_on
    pq[without] = 0
    return hp, pq, nor_sim, high_sim_t | high_sim_n, cross, without


def _count_pos_base(pb: PosBase, i, arr):
    """Populate one PosBase from the accumulated per-variant count arrays."""
    pb.counts = {"A": int(arr["acgt"][i, 0]), "C": int(arr["acgt"][i, 1]),
                 "G": int(arr["acgt"][i, 2]), "T": int(arr["acgt"][i, 3])}
    pb.unknown = int(arr["acgt"][i, 4])
    pb.mpq_counts = {"A": int(arr["macgt"][i, 0]), "C": int(arr["macgt"][i, 1]),
                     "G": int(arr["macgt"][i, 2]), "T": int(arr["macgt"][i, 3])}
    pb.mpq_unknown = int(arr["macgt"][i, 4])
    pb.alt_count = int(arr["alt"][i])
    pb.mpq_alt_count = int(arr["malt"][i])
    pb.depth = int(arr["depth"][i])
    pb.mpq_depth = int(arr["mdepth"][i])
    pb.del_count = int(arr["delc"][i])


def accumulate_pos_base(walk, t, is_alt, mapq_ok_obs, n_var):
    """countBaseNucleotide / countDeletionBase accumulation at tumor
    positions (HaplotagParsingBam.cpp:682-730) as flat arrays."""
    vi = walk["obs_var"]
    base = walk["obs_base"]
    kind0 = walk["obs_kind"] == 0
    tvt = t["tum_vt"][vi]
    tum3 = t["tum_has"][vi] & ((tvt == VT_SNP) | (tvt == VT_INSERTION)
                               | (tvt == VT_DELETION))
    m = kind0 & tum3
    code = _BASE_CODE[base].astype(np.int64)
    arr = {}
    key = vi.astype(np.int64) * 5 + code
    arr["acgt"] = np.bincount(key[m], minlength=n_var * 5).reshape(n_var, 5)
    mm = m & mapq_ok_obs
    arr["macgt"] = np.bincount(key[mm], minlength=n_var * 5).reshape(n_var, 5)
    alt_m = m & is_alt
    arr["alt"] = np.bincount(vi[alt_m], minlength=n_var)
    arr["malt"] = np.bincount(vi[alt_m & mapq_ok_obs], minlength=n_var)
    arr["depth"] = np.bincount(vi[m], minlength=n_var)
    arr["mdepth"] = np.bincount(vi[mm], minlength=n_var)
    arr["delc"] = np.bincount(vi[alt_m & (tvt == VT_DELETION)],
                              minlength=n_var)
    # in-deletion observations (countDeletionBase; alt for DEL-type vars)
    kind1 = walk["obs_kind"] == 1
    d_any = kind1 & t["tum_has"][vi]
    d_sd = d_any & ((tvt == VT_SNP) | (tvt == VT_DELETION))
    arr["depth"] = arr["depth"] + np.bincount(vi[d_sd], minlength=n_var)
    arr["delc"] = arr["delc"] + np.bincount(vi[d_sd], minlength=n_var)
    d_del = d_any & (tvt == VT_DELETION)
    arr["alt"] = arr["alt"] + np.bincount(vi[d_del], minlength=n_var)
    # positions touched (entry creation semantics: match obs create entries
    # only for SNP/INS/DEL tumor vars; deletion obs create for any tumor var)
    touched = np.zeros(n_var, bool)
    touched[vi[m]] = True
    touched[vi[d_any]] = True
    return arr, touched


def extract_normal_chromosome_fast(nb, chrom, chrom_len, positions, variants,
                                   ref_string, sv_counts, cfg, tables=None,
                                   precomputed=None):
    """Native+vectorized ExtractNorData pass. Same contract as
    somatic_caller.extract_normal_chromosome. ``tables`` lets the driver
    share one build_somatic_tables result across the three passes that
    need it (normal/tumor extract + tag) instead of rebuilding it per
    pass; ``precomputed`` is an optional (walk, dev_result) pair from the
    driver's device-mesh batch (models.somatic._mesh_precompute) — the
    walk is reused and the kernel reductions come back pre-reduced."""
    from ..io.bam import region_bounds

    variant_base: dict[int, PosBase] = {}
    if nb.tid(chrom) < 0:
        return variant_base
    walk = dev_pre = None
    if precomputed is not None:
        walk, dev_pre = precomputed
    if walk is None:
        last_var = positions[-1] if positions else None
        beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
            else (0, chrom_len)
        walk = nb.tag_walk(chrom, beg, end, positions, last_var, ref_string,
                           cfg.quality_threshold, False,
                           cfg.tag_supplementary)
    if walk is None or not len(walk["category"]):
        return variant_base
    t = tables if tables is not None \
        else build_somatic_tables(positions, variants)
    n_var = len(positions)
    vi = walk["obs_var"]
    al = walk["obs_aln"]
    A = len(walk["category"])
    mapq_ok_aln = walk["mapq"] >= cfg.quality_threshold
    mapq_ok_obs = mapq_ok_aln[al]

    from ..ops import tag_kernels
    dev = dev_pre
    if dev is None and \
            tag_kernels.engine(len(walk["obs_var"])) == "device":
        dev = tag_kernels.somatic_counts_device(
            walk, t, "normal", gate=mapq_ok_obs, want_posbase=True,
            ref_nonempty=bool(ref_string))
    if dev is not None:
        arr = dev
        touched = dev["touched"] != 0
        h1_cnt, h2_cnt, n_ps = dev["h1_cnt"], dev["h2_cnt"], dev["n_ps"]
        tvp = (dev["pk"] & tag_kernels.PK_TVP) != 0
    else:
        is_alt = obs_is_alt(walk, t)
        arr, touched = accumulate_pos_base(walk, t, is_alt, mapq_ok_obs,
                                           n_var)

        # germline votes: the normal pass uses the GERMLINE judge
        # (_judge_snp_hap next-op semantics), not judgeNormalSnpHap
        # (somatic_caller.py:148-157)
        from ..models.haplotag_fast import germline_votes
        gt_tables = {
            "pos": t["pos"], "has": t["nor_has"], "vtype": t["nor_vt"],
            "gt": t["nor_gt"], "ps": t["nor_ps"], "snp_ref": t["nor_ref0"],
            "snp_alt": t["nor_alt0"], "hp1c": t["nor_hp1c"],
            "hp2c": t["nor_hp2c"],
            "hp1_long": t["hp1_long"], "hp2_long": t["hp2_long"],
        }
        h1, h2, cps = germline_votes(walk, gt_tables, bool(ref_string))
        h1 &= mapq_ok_obs
        h2 &= mapq_ok_obs
        cps &= mapq_ok_obs
        h1_cnt = np.bincount(al[h1], minlength=A).astype(np.int64)
        h2_cnt = np.bincount(al[h2], minlength=A).astype(np.int64)
        n_ps, _min_ps, _triples = nor_ps_aggregate(walk, t, cps)

        # tum_var_pos_vec: match obs at SNP/INS/DEL tumor vars + in-deletion
        # obs at any tumor var (somatic_caller.py:140-167)
        tvt = t["tum_vt"][vi]
        tum3 = t["tum_has"][vi] & ((tvt == VT_SNP) | (tvt == VT_INSERTION)
                                   | (tvt == VT_DELETION))
        tvp = ((walk["obs_kind"] == 0) & tum3) | \
            ((walk["obs_kind"] == 1) & t["tum_has"][vi])

    if sv_counts:
        names = walk["names"]
        off = walk["name_off"]
        for a in np.flatnonzero(mapq_ok_aln):
            entry = sv_counts.get(names[off[a]:off[a + 1]])
            if entry is not None:
                h1_cnt[a] += entry[0]
                h2_cnt[a] += entry[1]

    hp, _pq, _hs, _wo = judge_reads(h1_cnt, h2_cnt, n_ps,
                                    cfg.percentage_threshold)
    hp_cls = np.where(hp == -1, RH_UNTAG, hp)  # ReadHP::unTag == 0
    # per (var, read-hp-class) counts
    key = vi[tvp].astype(np.int64) * 3 + hp_cls[al[tvp]]
    rhc = np.bincount(key, minlength=n_var * 3).reshape(n_var, 3)

    for i in np.flatnonzero(touched):
        pos = positions[i]
        pb = PosBase()
        _count_pos_base(pb, i, arr)
        for cls in (RH_UNTAG, RH_H1, RH_H2):
            if rhc[i, cls]:
                pb.read_hp_count[cls] = int(rhc[i, cls])
        variant_base[pos] = pb
        tum = variants[pos].get(TUMOR)
        if tum is None:
            raise SystemExit(
                f"extractNorData:postProcess missing tumor var {pos}")
        if tum.variant_type in (VT_SNP, VT_INSERTION, VT_DELETION):
            calculate_base_common_info(pb, tum.alt, tum.variant_type)
    return variant_base


def _build_read_sets(walk, t, A, al, vi, hp, base_hp, h1_cnt, h2_cnt, h3_cnt,
                     ps_triples, tsp_idx, read_hp_result_set,
                     tumor_pos_read_corr):
    """Per-alignment ReadVarHpCount records + pos->read->hp map for the
    calling-stage filters (SomaticVarCaller.cpp:462-518)."""
    names = walk["names"]
    noff = walk["name_off"].tolist()  # python ints: numpy-scalar slice
                                      # indices cost ~1us each in the loop
    tsp_aln_b = np.zeros(A, bool)
    tsp_aln_b[al[tsp_idx]] = True
    aln_ids = np.flatnonzero(tsp_aln_b)
    voted = base_hp != 0

    # pos_hp_pairs source: voted observations presorted by (aln, pos, hp)
    # so each alignment's pair list comes out already sorted (the obs
    # stream is aln-major, so within an alignment this equals the old
    # sorted() over its voted obs). One composite-key stable radix argsort
    # (numpy int64 stable sort) replaces the 3-pass lexsort.
    v_idx = np.flatnonzero(voted)
    v_pos = t["pos"][vi[v_idx]]
    stride = int(v_pos.max(initial=0)) + 1 if len(v_pos) else 1
    key = (al[v_idx].astype(np.int64) * stride + v_pos) * 4 \
        + base_hp[v_idx]
    v_order = v_idx[np.argsort(key, kind="stable")]
    v_ptr = np.searchsorted(al[v_order], np.arange(A + 1)).tolist()
    v_pos1 = (t["pos"][vi[v_order]] + 1).tolist()
    v_hp = base_hp[v_order].tolist()

    # bulk scalar conversions for the rename/record loop
    h1_l = h1_cnt[aln_ids].tolist()
    h2_l = h2_cnt[aln_ids].tolist()
    h3_l = h3_cnt[aln_ids].tolist()
    hp_l = hp[aln_ids].tolist()
    start_l = (walk["pos"][aln_ids] + 1).tolist()
    endr_l = walk["end_ref_pos"][aln_ids].tolist()
    endq_l = walk["end_query_pos"][aln_ids].tolist()
    somatic_like = (RH_H1_1, RH_H2_1, RH_H3)
    germ_like = (RH_UNTAG, RH_H1, RH_H2)
    ps_ptr, ps_psv, ps_cnt = ps_triples
    aln_list = aln_ids.tolist()
    ids = [names[noff[a]:noff[a + 1]] for a in aln_list]
    if len(set(ids)) == len(ids):
        # unique read names (no split/supplementary duplicates among tsp
        # alignments — the common case): bulk construction. update(zip)
        # preserves the exact insertion order of the sequential loop, and
        # with unique ids the rename branch is provably dead.
        from itertools import repeat

        if ps_psv:
            psds = []
            for a in aln_list:
                plo = ps_ptr[a]
                phi = ps_ptr[a + 1]
                psds.append(
                    {} if phi == plo else
                    {ps_psv[plo]: ps_cnt[plo]} if phi == plo + 1 else
                    dict(zip(ps_psv[plo:phi], ps_cnt[plo:phi])))
        else:
            psds = [{} for _ in aln_list]
        recs = list(map(ReadVarHpCount, h1_l, h2_l, h3_l, repeat(0), psds,
                        start_l, endr_l, endq_l, hp_l))
        hp_arr = hp[aln_ids]
        qual = np.isin(hp_arr, np.asarray(somatic_like)) | \
            ((h3_cnt[aln_ids] > 0)
             & np.isin(hp_arr, np.asarray(germ_like)))
        for j in np.flatnonzero(qual).tolist():
            a = aln_list[j]
            lo, hi = v_ptr[a], v_ptr[a + 1]
            recs[j].pos_hp_pairs = list(zip(v_pos1[lo:hi], v_hp[lo:hi]))
        read_hp_result_set.update(zip(ids, recs))
        rid_by_aln = dict(zip(aln_list, ids))
    else:
        rid_by_aln = {}
        for j, a in enumerate(aln_list):
            read_id = ids[j]
            prev = read_hp_result_set.get(read_id)
            if prev is not None:
                prev.read_id_count += 1
                read_id = f"{read_id}-{prev.read_id_count}"
            hp_res = hp_l[j]
            plo = ps_ptr[a] if ps_psv else 0
            phi = ps_ptr[a + 1] if ps_psv else 0
            if phi == plo:
                psd = {}
            elif phi == plo + 1:  # common case: one phase set on the read
                psd = {ps_psv[plo]: ps_cnt[plo]}
            else:
                psd = dict(zip(ps_psv[plo:phi], ps_cnt[plo:phi]))
            r = ReadVarHpCount(h1_l[j], h2_l[j], h3_l[j], 0, psd,
                               start_l[j], endr_l[j], endq_l[j], hp_res)
            if hp_res in somatic_like or (h3_l[j] > 0
                                          and hp_res in germ_like):
                lo, hi = v_ptr[a], v_ptr[a + 1]
                r.pos_hp_pairs = list(zip(v_pos1[lo:hi], v_hp[lo:hi]))
            read_hp_result_set[read_id] = r
            rid_by_aln[a] = read_id

    # tumor_pos_read_corr: grouped construction from the tsp observation
    # stream (consumers access it keyed / accumulate commutatively, so the
    # pos-key insertion order is immaterial)
    c_pos0 = t["pos"][vi[tsp_idx]].tolist()
    c_aln = al[tsp_idx].tolist()
    c_hp = base_hp[tsp_idx].tolist()
    corr_get = tumor_pos_read_corr.get
    for p, a, hv in zip(c_pos0, c_aln, c_hp):
        d = corr_get(p)
        if d is None:
            d = tumor_pos_read_corr[p] = {}
        d[rid_by_aln[a]] = hv


def tumor_want_window(cfg, t):
    """Per-variant offset-window request mask for the tumor walk (None for
    estimate_purity, where the windows feed only the DenseAlt filter)."""
    if not getattr(cfg, "collect_offset_windows", True):
        return None
    tvt_tab = t["tum_vt"]
    return (t["tum_has"] & (
        (tvt_tab == VT_SNP) | (tvt_tab == VT_INSERTION)
        | (tvt_tab == VT_DELETION))).astype(np.uint8)


def extract_tumor_chromosome_fast(nb, chrom, chrom_len, positions, variants,
                                  ref_string, cfg, tables=None,
                                  precomputed=None):
    """Native+vectorized ExtractTumData pass. Same contract as
    somatic_caller.extract_tumor_chromosome. ``tables``/``precomputed``:
    see extract_normal_chromosome_fast."""
    from ..io.bam import region_bounds

    somatic_pos_info: dict[int, SomaticData] = {}
    read_hp_result_set: dict[str, ReadVarHpCount] = {}
    tumor_pos_read_corr: dict[int, dict[str, int]] = {}
    if nb.tid(chrom) < 0:
        return somatic_pos_info, read_hp_result_set, tumor_pos_read_corr
    t = tables if tables is not None \
        else build_somatic_tables(positions, variants)
    n_var = len(positions)
    walk = dev_pre = None
    if precomputed is not None:
        walk, dev_pre = precomputed
    if walk is None:
        last_var = positions[-1] if positions else None
        beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
            else (0, chrom_len)
        walk = nb.tag_walk(chrom, beg, end, positions, last_var, ref_string,
                           cfg.quality_threshold, False,
                           cfg.tag_supplementary,
                           want_window=tumor_want_window(cfg, t),
                           window=100)
    if walk is None or not len(walk["category"]):
        return somatic_pos_info, read_hp_result_set, tumor_pos_read_corr

    vi = walk["obs_var"]
    al = walk["obs_aln"]
    A = len(walk["category"])
    kind0 = walk["obs_kind"] == 0
    mapq_ok_aln = walk["mapq"] >= cfg.quality_threshold
    mapq_ok_obs = mapq_ok_aln[al]

    from ..ops import tag_kernels
    dev = dev_pre
    if dev is None and \
            tag_kernels.engine(len(walk["obs_var"])) == "device":
        dev = tag_kernels.somatic_counts_device(
            walk, t, "extract", gate=mapq_ok_obs, want_posbase=True)
    if dev is not None:
        arr = dev
        touched = dev["touched"] != 0
        pk = dev["pk"]
        h1 = (pk & tag_kernels.PK_H1) != 0
        h2 = (pk & tag_kernels.PK_H2) != 0
        h3 = (pk & tag_kernels.PK_H3) != 0
        cps_nor = (pk & tag_kernels.PK_CPS_NOR) != 0
        is_alt = (pk & tag_kernels.PK_IS_ALT) != 0
        allele_gate = (pk & tag_kernels.PK_ALLELE_GATE) != 0
        base_hp = np.zeros(len(vi), np.int8)
        base_hp[h1] = GERMLINE_H1
        base_hp[h2] = GERMLINE_H2
        base_hp[h3] = SOMATIC_H3
        h1_cnt, h2_cnt, h3_cnt = dev["h1_cnt"], dev["h2_cnt"], dev["h3_cnt"]
        n_ps = dev["n_ps"]
        allele_counts = dev["allele_counts"]
        # ps_triples stay host-built: they feed per-read nor_count_ps dicts
        _n_ps2, _min_ps, ps_triples = nor_ps_aggregate(walk, t, cps_nor)
    else:
        is_alt = obs_is_alt(walk, t)
        arr, touched = accumulate_pos_base(walk, t, is_alt, mapq_ok_obs,
                                           n_var)

        votes = somatic_match_votes(walk, t, is_alt, "extract")
        h1 = votes["h1"] & mapq_ok_obs
        h2 = votes["h2"] & mapq_ok_obs
        h3 = votes["h3"] & mapq_ok_obs
        cps_nor = votes["cps_nor"] & mapq_ok_obs
        base_hp = np.where(mapq_ok_obs, votes["base_hp"], 0).astype(np.int8)
        h1_cnt = np.bincount(al[h1], minlength=A).astype(np.int64)
        h2_cnt = np.bincount(al[h2], minlength=A).astype(np.int64)
        h3_cnt = np.bincount(al[h3], minlength=A).astype(np.int64)
        n_ps, _min_ps, ps_triples = nor_ps_aggregate(walk, t, cps_nor)

        # allele_count / offset_bases gate (somatic_caller.py:466-468)
        tum3_obs = kind0 & t["tum_has"][vi] & (
            (t["tum_vt"][vi] == VT_SNP) | (t["tum_vt"][vi] == VT_INSERTION)
            | (t["tum_vt"][vi] == VT_DELETION))
        base_eq = (t["tum_ref_is1"][vi]
                   & (walk["obs_base"] == t["tum_ref0"][vi])) | \
            (t["tum_alt_is1"][vi] & (walk["obs_base"] == t["tum_alt0"][vi]))
        allele_gate = tum3_obs & np.where(t["tum_vt"][vi] == VT_SNP,
                                          base_eq, True)
        ac_key = vi[allele_gate].astype(np.int64) * 2 + is_alt[allele_gate]
        allele_counts = np.bincount(ac_key,
                                    minlength=n_var * 2).reshape(n_var, 2)
    hp, _pq, _nsim, _hs, _cross, _wo = judge_somatic_reads(
        h1_cnt, h2_cnt, h3_cnt, n_ps, cfg.percentage_threshold)

    # window mismatch offsets, filtered to gated observations
    wd_obs = walk["wd_obs"]
    wd_keep = allele_gate[wd_obs] if len(wd_obs) else np.zeros(0, bool)
    wd_vi = vi[wd_obs[wd_keep]]
    wd_ia = is_alt[wd_obs[wd_keep]]
    wd_off = walk["wd_off"][wd_keep]
    wd_base = walk["wd_base"][wd_keep]

    # classifyReadsByCase per alignment (SomaticVarCaller.cpp:462-518)
    record_read = n_ps <= 1
    zero1 = h1_cnt == 0
    zero2 = h2_cnt == 0
    zero_count = zero1.astype(np.int64) + zero2
    tag_clean = ((zero_count > 0) & (h3_cnt != 0))
    nonzero_norm = (h1_cnt + h2_cnt) != 0
    pure_ratio = np.zeros(A, bool)
    with np.errstate(invalid="ignore"):
        tot = h1_cnt + h2_cnt
        r1 = np.divide(h1_cnt, tot, out=np.zeros(A), where=tot > 0)
        r2 = np.divide(h2_cnt, tot, out=np.zeros(A), where=tot > 0)
    pure_ratio = nonzero_norm & ((r1 >= 1.0) | (r2 >= 1.0))
    tag_clean = tag_clean | (~((zero_count > 0) & (h3_cnt != 0))
                             & pure_ratio)
    # per-aln case class: 0 untag, 1 clean+pureH3, 2 clean+pureH1-1,
    # 3 clean+pureH2-1, 4 clean only, 5 mixed
    case_cls = np.full(A, 5, np.int8)
    clean = record_read & tag_clean
    case_cls[clean] = 4
    case_cls[clean & zero1 & zero2 & (h3_cnt != 0)] = 1
    case_cls[clean & ~zero1 & zero2] = 2
    case_cls[clean & zero1 & ~zero2] = 3
    case_cls[~record_read] = 0

    # accumulate per (var, case class) for h3-vote observations
    h3_idx = np.flatnonzero(h3)
    cc_key = vi[h3_idx].astype(np.int64) * 6 + case_cls[al[h3_idx]]
    cc = np.bincount(cc_key, minlength=n_var * 6).reshape(n_var, 6)
    # somatic_read_hp_count per (var, hp_result) for h3-vote observations
    hp_of_obs = hp[al[h3_idx]]
    sr_key = vi[h3_idx].astype(np.int64) * 9 + hp_of_obs
    src = np.bincount(sr_key, minlength=n_var * 9).reshape(n_var, 9)

    # tumor_snp_pos_vec observations: any TUMOR entry, mapq-gated match obs
    tsp = kind0 & t["tum_has"][vi] & mapq_ok_obs
    # base.read_hp_count per (var, hp_result)
    tsp_idx = np.flatnonzero(tsp)
    bh_key = vi[tsp_idx].astype(np.int64) * 9 + hp[al[tsp_idx]]
    bhc = np.bincount(bh_key, minlength=n_var * 9).reshape(n_var, 9)

    touched_all = touched.copy()
    touched_all[vi[tsp_idx]] = True
    touched_all[vi[h3_idx]] = True

    # build SomaticData objects
    sd_by_vi = {}
    for i in np.flatnonzero(touched_all):
        pos = positions[i]
        sd = SomaticData()
        _count_pos_base(sd.base, i, arr)
        sd.allele_count = [int(allele_counts[i, 0]), int(allele_counts[i, 1])]
        sd.untag = int(cc[i, 0])
        sd.pure_h3_read = int(cc[i, 1])
        sd.pure_h1_1_read = int(cc[i, 2])
        sd.pure_h2_1_read = int(cc[i, 3])
        sd.total_clean_hp3_read = int(cc[i, 1] + cc[i, 2] + cc[i, 3] + cc[i, 4])
        sd.mixed_hp_read = int(cc[i, 5])
        for cls in (RH_H1_1, RH_H2_1, RH_H3, RH_UNTAG):
            if src[i, cls]:
                sd.somatic_read_hp_count[cls] = int(src[i, cls])
        for cls in range(9):
            if bhc[i, cls]:
                sd.base.read_hp_count[cls] = int(bhc[i, cls])
        somatic_pos_info[pos] = sd
        sd_by_vi[i] = sd

    # offset_bases lists per (var, is_alt)
    if len(wd_vi):
        order = np.lexsort((wd_off, wd_ia, wd_vi))
        sv = wd_vi[order]
        sa = wd_ia[order]
        so = wd_off[order]
        sb = wd_base[order]
        bounds = np.flatnonzero(np.diff(sv) | np.diff(sa.astype(np.int16)))
        starts = np.concatenate(([0], bounds + 1))
        ends = np.concatenate((bounds + 1, [len(sv)]))
        # one bulk conversion instead of per-element int()/chr() calls
        so_l = so.tolist()
        sb_l = sb.tobytes().decode("latin-1")
        sv_l = sv.tolist()
        sa_l = sa.tolist()
        for s, e in zip(starts.tolist(), ends.tolist()):
            sd = sd_by_vi.get(sv_l[s])
            if sd is None:
                sd = somatic_pos_info.setdefault(positions[sv_l[s]],
                                                 SomaticData())
            lst = sd.offset_bases[sa_l[s]]
            lst.extend(zip(so_l[s:e], sb_l[s:e]))

    # per-alignment sequential block: read_hp_result_set + tumor_pos_read_corr
    # (calling-stage filters only — estimate_purity skips building them)
    if getattr(cfg, "collect_read_sets", True):
        _build_read_sets(walk, t, A, al, vi, hp, base_hp, h1_cnt,
                         h2_cnt, h3_cnt, ps_triples, tsp_idx,
                         read_hp_result_set, tumor_pos_read_corr)

    # postProcess (SomaticVarCaller.cpp:520-603)
    from .somatic_types import _imbalance
    for pos, sd in somatic_pos_info.items():
        tum = variants[pos].get(TUMOR)
        if tum is None:
            raise SystemExit(
                f"extractTumData:postProcess missing tumor var {pos}")
        if tum.variant_type in (VT_SNP, VT_INSERTION, VT_DELETION):
            total_clean = sd.total_clean_hp3_read
            sd.case_read_count = total_clean + sd.mixed_hp_read
            if sd.case_read_count != 0:
                fd = np.float32(float(total_clean) + float(sd.mixed_hp_read))
                sd.mixed_hp_ratio = float(np.float32(sd.mixed_hp_read) / fd)
                sd.pure_h1_1_ratio = float(np.float32(sd.pure_h1_1_read) / fd)
                sd.pure_h2_1_ratio = float(np.float32(sd.pure_h2_1_read) / fd)
                sd.pure_h3_ratio = float(np.float32(sd.pure_h3_read) / fd)
            calculate_base_common_info(sd.base, tum.alt, tum.variant_type)
            bh1 = sd.base.read_hp_count.get(RH_H1, 0)
            bh2 = sd.base.read_hp_count.get(RH_H2, 0)
            bh1_1 = sd.base.read_hp_count.get(RH_H1_1, 0)
            bh2_1 = sd.base.read_hp_count.get(RH_H2_1, 0)
            b1 = bh1 + bh1_1
            b2 = bh2 + bh2_1
            sd.allelic_imbalance = _imbalance(b1, b2, b1 + b2)
            sd.somatic_hp_imbalance = _imbalance(bh1_1, bh2_1, bh1_1 + bh2_1)
            if tum.gt == UNPHASED_HOMO:
                sd.gt_type = "Homo"
            elif tum.gt == PHASED_HETERO:
                sd.gt_type = "Hetero"
            elif tum.gt == UNPHASED_HETERO:
                sd.gt_type = "UnphasedHetero"
            else:
                raise SystemExit(f"GTtype missing at {pos}")
    return somatic_pos_info, read_hp_result_set, tumor_pos_read_corr
