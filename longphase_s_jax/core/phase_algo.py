"""Reference-semantics phasing algorithm (NumPy/host oracle).

This module is the behavioral specification for the device kernels in ``ops/``:
a faithful re-expression of VairiantGraph (PhasingGraph.cpp) with every corner
case, used (a) to golden-test against the reference binary and (b) as the
ground truth the JAX/Pallas kernels must reproduce.

Float behavior: the reference accumulates edge counts in C++ ``float`` and
vote weights in ``float``; comparisons are strict. We emulate with np.float32
scalars so ties resolve identically.

Stage map (reference file:line):
* filter_overlap_alignments  — PhasingGraph.cpp:707-781 (including the
  operator[]-before-find quirk that leaves range.first == 0)
* cnv_mismatch_filter        — PhasingGraph.cpp:520-692
* build_graph                — PhasingGraph.cpp:793-888 (merge + type/qual
  remap + banded pair accumulation)
* vote_scan                  — PhasingGraph.cpp:286-474 (edgeConnectResult)
* read_correction            — PhasingGraph.cpp:891-1029
* export_result              — PhasingGraph.cpp:1049-1077
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .alleles import ReadAln

F32 = np.float32

# variant types (PhasingGraph.cpp:800-832)
T_SNP = 0
T_SV = 1
T_MOD = 2
T_INDEL = 3
T_DANGER = 4


@dataclass
class PhaseParams:
    """Defaults from Phasing.cpp:88-116."""

    distance: int = 300000
    connect_adjacent: int = 35
    mapping_quality: int = 1
    base_quality: int = 12
    edge_weight: float = 0.1
    snp_confidence: float = 0.75
    read_confidence: float = 0.65
    edge_threshold: float = 0.7
    overlap_threshold: float = 0.2
    sv_window: int = 20
    sv_threshold: float = 0.1
    is_ont: bool = False
    phase_indel: bool = False
    indel_quality: int = 0


# ---------------------------------------------------------------------------
# Alignment-level filters
# ---------------------------------------------------------------------------

def filter_overlap_alignments(alns: list[ReadAln], overlap_threshold: float) -> list[ReadAln]:
    """Drop shorter overlapping split alignments of a read (PhasingGraph.cpp:707-781).

    Faithful to the reference quirk: ``alignRange[readName]`` default-creates
    the entry before the find() check, so the "first appearance" branch never
    runs and range.first stays 0; the overlap test degenerates to
    ``first_pos <= tracked_last``.
    """
    align_range: dict[str, list[int]] = {}
    read_idx_vec: dict[str, list[int]] = {}
    del_idx: list[int] = []

    for read_iter, aln in enumerate(alns):
        if not aln.positions:
            # reference would UB on front() of an empty vec; keep inert entry
            continue
        to_delete = False
        name = aln.read_name
        first = aln.positions[0]
        last = aln.positions[-1]
        rng = align_range.setdefault(name, [0, 0])
        idxv = read_idx_vec.setdefault(name, [])

        while rng[0] <= first <= rng[1]:
            if last < rng[1]:
                to_delete = True
                del_idx.append(read_iter)
                break
            pre = len(idxv) - 1
            if pre < 0:
                break
            prev = alns[idxv[pre]]
            prev_start = prev.positions[0]
            prev_end = prev.positions[-1]
            overlap_start = max(prev_start, first)
            overlap_end = min(prev_end, last)
            if overlap_start > overlap_end:
                break
            overlap_len = overlap_end - overlap_start + 1
            align_start = max(prev_end, last)
            align_end = min(prev_start, first)
            align_span = align_start - align_end + 1
            overlap_ratio = overlap_len / align_span
            if overlap_ratio >= overlap_threshold:
                len1 = prev_end - prev_start + 1
                len2 = last - first + 1
                if len2 <= len1:
                    to_delete = True
                    del_idx.append(read_iter)
                    break
                else:
                    del_idx.append(idxv[pre])
                    idxv.pop()
                    rng[1] = (alns[idxv[pre - 1]].positions[-1]
                              if pre > 0 else first)
            else:
                break
        rng[1] = last
        if not to_delete:
            idxv.append(read_iter)

    dels = set(del_idx)
    return [a for i, a in enumerate(alns) if i not in dels]


def cnv_mismatch_filter(alns: list[ReadAln], cnv_vec: list[tuple[int, int]]):
    """CNV-region high-mismatch variant filtering (PhasingGraph.cpp:520-692).

    ``cnv_vec`` must be the duplicated interval list (the reference calls
    getCNVInterval twice — once in the Clip ctor, once explicitly in
    PhasingProcess.cpp:147-148 — so every interval appears twice); the
    duplicate counting cancels in the Alt/(Ref+Alt) ratio but the index-walk
    behavior is preserved for parity.
    """
    if not alns or not cnv_vec:
        return
    # stage 1: per-read alt counts per overlapping CNV interval
    mmrate: dict[int, dict[int, int]] = {}  # aln index -> {cnv_start: count}
    cnv_index = 0
    for ai, read in enumerate(alns):
        if not read.positions:
            continue
        read_start = read.positions[0]
        read_end = read.positions[-1]
        while cnv_index > 0 and cnv_vec[cnv_index][0] > read_start:
            cnv_index -= 1
        i = cnv_index
        rm = mmrate.setdefault(ai, {})
        while i < len(cnv_vec) and cnv_vec[i][0] <= read_end:
            c_start, c_end = cnv_vec[i]
            for pos, allele in zip(read.positions, read.alleles):
                if pos > c_end:
                    break
                if c_start <= pos <= c_end and allele == 1:
                    rm[c_start] = rm.get(c_start, 0) + 1
            i += 1
        cnv_index = i - 1 if i > 0 else 0

    # stage 2: aggregate per (variant position, allele)
    cnv_read_mmrate: dict[int, dict[int, list[int]]] = {}
    cnv_index = 0
    for ai, read in enumerate(alns):
        if not read.positions:
            continue
        read_start = read.positions[0]
        read_end = read.positions[-1]
        while cnv_index > 0 and cnv_vec[cnv_index][0] > read_start:
            cnv_index -= 1
        i = cnv_index
        rm = mmrate.get(ai, {})
        while i < len(cnv_vec) and cnv_vec[i][0] <= read_end:
            c_start, c_end = cnv_vec[i]
            for pos, allele in zip(read.positions, read.alleles):
                if pos > c_end:
                    break
                if c_start <= pos <= c_end and c_start in rm:
                    cnv_read_mmrate.setdefault(pos, {}).setdefault(allele, []).append(rm[c_start])
            i += 1
        cnv_index = i - 1 if i > 0 else 0

    # stage 3: average mismatch ratio per variant
    miss_rate: dict[int, float] = {}
    cnv_index = 0
    for pos in cnv_read_mmrate:  # insertion order == first-touch order
        while cnv_index > 0 and cnv_vec[cnv_index][0] > pos:
            cnv_index -= 1
        i = cnv_index
        while i < len(cnv_vec):
            if cnv_vec[i][0] > pos:
                break
            c_start, c_end = cnv_vec[i]
            if c_start <= pos <= c_end:
                ref_list = cnv_read_mmrate[pos].get(0)
                alt_list = cnv_read_mmrate[pos].get(1)
                if ref_list is not None and alt_list is not None:
                    avg_ref = sum(ref_list) / len(ref_list)
                    avg_alt = sum(alt_list) / len(alt_list)
                    if avg_ref != 0 and avg_alt != 0:
                        miss_rate[pos] = avg_alt / (avg_ref + avg_alt)
            i += 1

    if not miss_rate:
        return
    # stage 4: erase variants with ratio >= 0.7 inside a CNV interval
    cnv_index = 0
    for read in alns:
        if not read.positions:
            continue
        read_start = read.positions[0]
        while cnv_index > 0 and cnv_vec[cnv_index][0] > read_start:
            cnv_index -= 1
        vi = 0
        while vi < len(read.positions):
            erased = False
            i = cnv_index
            while i < len(cnv_vec) and cnv_vec[i][0] <= read.positions[vi]:
                c_start, c_end = cnv_vec[i]
                if c_start <= read.positions[vi] <= c_end:
                    rate = miss_rate.get(read.positions[vi])
                    if rate is not None and rate >= 0.7:
                        del read.positions[vi]
                        del read.alleles[vi]
                        del read.quals[vi]
                        erased = True
                        break
                i += 1
            if not erased:
                vi += 1
            cnv_index = i - 1 if i > 0 else 0


# ---------------------------------------------------------------------------
# Graph build
# ---------------------------------------------------------------------------

class PhaseGraph:
    """Holds the accumulated edge counts and site tables."""

    __slots__ = ("site_info", "variant_type", "edges", "edge_keys")

    def __init__(self):
        # pos -> {read_name: remapped quality}  (totalVariantInfo)
        self.site_info: dict[int, dict[str, int]] = {}
        # pos -> variant type
        self.variant_type: dict[int, int] = {}
        # (pos1, side0/1) -> {pos2: [ref_count(F32), alt_count(F32)]}
        self.edges: dict[tuple[int, int], dict[int, list]] = {}
        # positions that own an edge entry (edgeList keys)
        self.edge_keys: set[int] = set()


def build_graph(alns: list[ReadAln], params: PhaseParams) -> PhaseGraph:
    """Merge alignments per read and accumulate banded pair counts.

    PhasingGraph.cpp:793-888. Reads merge by name across alignments (and BAM
    files); variants sort by position; each variant connects to the next
    ``connect_adjacent`` variants *on the read*; contribution weight is 1.0
    when both base qualities pass ``base_quality``, else +0.1 accumulated in
    float32 like the C++ float maps.
    """
    g = PhaseGraph()
    merged: dict[str, list[tuple[int, int, int]]] = {}

    for aln in alns:
        vars_out = merged.setdefault(aln.read_name, [])
        for pos, allele, qual in zip(aln.positions, aln.alleles, aln.quals):
            if qual == -2 or qual == -3:
                g.variant_type[pos] = T_MOD
                qual = 60
            elif qual == -1:
                g.variant_type[pos] = T_SV
                qual = 60 if allele == 1 else 30
            elif qual == -4:
                g.variant_type[pos] = T_INDEL
                qual = 60
            elif qual == -5:
                g.variant_type[pos] = T_DANGER
                qual = 60
            else:
                g.variant_type[pos] = T_SNP
            vars_out.append((pos, allele, qual))
            g.site_info.setdefault(pos, {})[aln.read_name] = qual

    base_q = params.base_quality
    edge_w = params.edge_weight
    window = params.connect_adjacent
    for name in sorted(merged):
        variants = sorted(merged[name], key=lambda v: v[0])
        nv = len(variants)
        for k in range(nv):
            pos1, a1, q1 = variants[k]
            g.edge_keys.add(pos1)
            side = g.edges.setdefault((pos1, a1), {})
            hi = min(nv, k + 1 + window)
            for j in range(k + 1, hi):
                pos2, a2, q2 = variants[j]
                cell = side.setdefault(pos2, [F32(0), F32(0)])
                if q1 >= base_q and q2 >= base_q:
                    cell[a2] = F32(cell[a2] + F32(1.0))
                else:
                    # C++: float = float + (double)edgeWeight, rounded to float
                    cell[a2] = F32(np.float64(cell[a2]) + edge_w)
    return g


# ---------------------------------------------------------------------------
# Vote scan (edgeConnectResult)
# ---------------------------------------------------------------------------

def _one_long_case(votes, variant_type):
    """Onelongcase (PhasingGraph.cpp:251-283)."""
    counter = 0
    h1 = F32(0)
    h2 = F32(0)
    for v in votes:
        para, cross, weight, hap, esr, pos = v
        if F32(para + cross) <= 1:
            counter += 1
        elif esr < 0.2 and weight >= 1 and variant_type.get(pos) != T_INDEL:
            if hap == 1:
                h1 = F32(h1 + weight)
            elif hap == 2:
                h2 = F32(h2 + weight)
    if counter <= 3 or (h1 == 0 and h2 == 0):
        return None
    return h1, h2


def vote_scan(g: PhaseGraph, params: PhaseParams, debug_target: int | None = None,
              dot_collector: list | None = None):
    """edgeConnectResult (PhasingGraph.cpp:286-474).

    Returns (bk_result, sub_node_hp, hp_result) where bk_result maps
    (pos, 1|2) -> PS (block start + 1) and sub_node_hp maps (pos, 1|2) -> 0|1.
    """
    sites = sorted(g.site_info)
    S = len(sites)
    vt = g.variant_type

    hp_count2: dict[int, dict[int, np.float32]] = {}
    votes_map: dict[int, list] = {}
    hp_result: dict[int, int] = {}
    phased_blocks: dict[int, list[int]] = {}

    block_start = -1
    last_connect_pos = -1

    for t in range(S - 1):
        curr = sites[t]
        nxt = sites[t + 1]
        if abs(nxt - curr) > params.distance:
            continue

        hc = hp_count2.get(curr)
        h1 = hc[1] if hc else F32(0)
        h2 = hc[2] if hc else F32(0)
        special = _one_long_case(votes_map.get(curr, ()), vt)
        if special is not None:
            h1, h2 = special

        if h1 == h2:
            if curr < last_connect_pos:
                continue
            block_start = curr
            phased_blocks.setdefault(block_start, []).append(curr)
            hp_result[curr] = 1
        else:
            hp_result[curr] = 1 if h1 > h2 else 2
            phased_blocks.setdefault(block_start, []).append(curr)

        if curr not in g.edge_keys:
            continue

        ref_side = g.edges.get((curr, 0), {})
        alt_side = g.edges.get((curr, 1), {})
        curr_hp = hp_result[curr]
        curr_is_danger = vt.get(curr) == T_DANGER
        curr_type = vt.get(curr)

        ti = t + 1
        for _i in range(params.connect_adjacent):
            target = sites[ti]
            weight = F32(1.0)
            rc = ref_side.get(target)
            ac = alt_side.get(target)
            rr = rc[0] if rc else F32(0)
            ra = rc[1] if rc else F32(0)
            ar = ac[0] if ac else F32(0)
            aa = ac[1] if ac else F32(0)
            s_para = F32(rr + aa)
            s_cross = F32(ra + ar)

            denom = max(float(s_para), float(s_cross))
            numer = min(float(s_para), float(s_cross))
            esr = numer / denom if denom != 0 else math.nan

            if s_para > s_cross:
                ref_allele = 1
            elif s_para < s_cross:
                ref_allele = 2
            else:
                ref_allele = -1

            threshold = params.edge_threshold
            tgt_type = vt.get(target)
            if (curr_type == T_SNP and tgt_type == T_MOD) or \
                    (curr_type == T_MOD and tgt_type == T_SNP):
                threshold = 0.3
                if F32(F32(F32(rr + ra) + ar) + aa) < 1:
                    threshold = -1.0

            if esr > threshold:
                ref_allele = -1
            elif (esr <= 0.1 and F32(F32(F32(rr + aa) + ra) + ar) >= 1) or \
                    (s_para < 1 <= s_cross) or (s_para >= 1 > s_cross):
                weight = F32(20.0)

            if curr_is_danger:
                weight = F32(0.1)

            if debug_target is not None and target == debug_target:
                print("ORACLE vote", curr, "->", target, "rr/ra/ar/aa", rr, ra,
                      ar, aa, "esr", esr, "ref_allele", ref_allele,
                      "weight", weight, "hp[curr]", curr_hp)
            if ref_allele != -1:
                if dot_collector is not None:
                    alt_allele = 2 if ref_allele == 1 else 1
                    dot_collector.append(
                        f"{curr + 1}.1\t->\t{target + 1}.{ref_allele}")
                    dot_collector.append(
                        f"{curr + 1}.2\t->\t{target + 1}.{alt_allele}")
                if curr_hp == 1:
                    mapped = 1 if ref_allele == 1 else 2
                else:
                    mapped = 2 if ref_allele == 1 else 1
                tc = hp_count2.setdefault(target, {1: F32(0), 2: F32(0)})
                tc[mapped] = F32(tc[mapped] + weight)
                votes_map.setdefault(target, []).append(
                    (s_para, s_cross, weight, mapped, esr, curr))
                last_connect_pos = target
            ti += 1
            if ti >= S:
                break

    # block result assembly (PhasingGraph.cpp:423-467)
    bk_result: dict[tuple[int, int], int] = {}
    sub_node_hp: dict[tuple[int, int], int] = {}
    for bstart, members in phased_blocks.items():
        if len(members) <= 1:
            continue
        for idx in range(len(members) - 1):
            curr = members[idx]
            nxt = members[idx + 1]
            bk_result[(curr, 1)] = bstart + 1
            bk_result[(nxt, 1)] = bstart + 1
            bk_result[(curr, 2)] = bstart + 1
            bk_result[(nxt, 2)] = bstart + 1
            if idx == 0:
                sub_node_hp[(curr, 1)] = 0
                sub_node_hp[(curr, 2)] = 1
            hc = hp_result.get(curr, 0)
            hn = hp_result.get(nxt, 0)
            if hc == 0 or hn == 0:
                pass
            elif hc == hn:
                sub_node_hp[(nxt, 1)] = sub_node_hp.get((curr, 1), 0)
                sub_node_hp[(nxt, 2)] = sub_node_hp.get((curr, 2), 0)
            else:
                sub_node_hp[(nxt, 1)] = sub_node_hp.get((curr, 2), 0)
                sub_node_hp[(nxt, 2)] = sub_node_hp.get((curr, 1), 0)

    return bk_result, sub_node_hp, hp_result


# ---------------------------------------------------------------------------
# Read correction
# ---------------------------------------------------------------------------

def read_correction(alns: list[ReadAln], g: PhaseGraph,
                    bk_result: dict, sub_node_hp: dict, params: PhaseParams):
    """readCorrection (PhasingGraph.cpp:891-1029). Mutates bk_result; returns
    (new_sub_node_hp, read_hp_map)."""
    vt = g.variant_type
    hp_allele_count: dict[tuple[int, int, int], float] = {}
    read_hp: dict[str, int] = {}

    for aln in alns:
        ref_count = 0.0
        alt_count = 0.0
        for pos, allele in zip(aln.positions, aln.alleles):
            key = (pos, allele + 1)
            ps = bk_result.get(key)
            if ps is None or ps == 0:
                continue
            t = vt.get(pos)
            if t in (T_SNP, T_SV):
                if sub_node_hp.get(key, 0) == 0:
                    ref_count += 1
                else:
                    alt_count += 1
            elif t == T_MOD:
                continue
            elif t in (T_INDEL, T_DANGER):
                if sub_node_hp.get(key, 0) == 0:
                    ref_count += 0.1
                else:
                    alt_count += 0.1

        total = ref_count + alt_count
        confident = total > 0 and (max(ref_count, alt_count) / total
                                   > params.read_confidence) and total > 1
        if confident:
            belong = 0 if ref_count > alt_count else 1
            read_hp[aln.read_name] = belong
            for pos, allele in zip(aln.positions, aln.alleles):
                if allele in (0, 1):
                    k = (belong, pos, allele)
                    hp_allele_count[k] = hp_allele_count.get(k, 0) + 1
        else:
            read_hp[aln.read_name] = -1

    new_sub: dict[tuple[int, int], int] = {}
    for pos in g.site_info:
        hp1_ref = hp_allele_count.get((0, pos, 0), 0.0)
        hp1_alt = hp_allele_count.get((0, pos, 1), 0.0)
        hp2_ref = hp_allele_count.get((1, pos, 0), 0.0)
        hp2_alt = hp_allele_count.get((1, pos, 1), 0.0)
        result1 = hp1_ref + hp2_alt
        result2 = hp2_ref + hp1_alt
        total = result1 + result2
        conf = (max(result1, result2) / total) if total else math.nan
        hp1_result = -1
        hp2_result = -1
        if conf > params.snp_confidence:
            if result1 > result2:
                hp1_result, hp2_result = 0, 1
            elif result1 < result2:
                hp1_result, hp2_result = 1, 0
        if hp1_result != -1:
            new_sub[(pos, 1)] = hp1_result
            new_sub[(pos, 2)] = hp2_result
        else:
            bk_result.pop((pos, 1), None)
            bk_result.pop((pos, 2), None)

    return new_sub, read_hp


def export_result(chrom: str, g: PhaseGraph, bk_result: dict,
                  sub_node_hp: dict) -> dict[str, tuple[str, int]]:
    """exportResult (PhasingGraph.cpp:1049-1077)."""
    out: dict[str, tuple[str, int]] = {}
    for pos in g.site_info:
        ps = bk_result.get((pos, 1))
        if ps is None:
            ps = bk_result.get((pos, 2))
        if ps is None:
            continue
        if ps == 0:
            continue
        ra = f"{sub_node_hp.get((pos, 1), 0)}|{sub_node_hp.get((pos, 2), 0)}"
        out[f"{chrom}_{pos}"] = (ra, ps)
    return out


def phase_chromosome(alns: list[ReadAln], cnv_vec: list[tuple[int, int]],
                     chrom: str, params: PhaseParams,
                     generate_dot: bool = False):
    """Full per-chromosome pipeline body (PhasingProcess.cpp:113-172)."""
    alns = filter_overlap_alignments(alns, params.overlap_threshold)
    cnv_mismatch_filter(alns, cnv_vec)
    g = build_graph(alns, params)
    dot = [] if generate_dot else None
    bk_result, sub_node_hp, _hp = vote_scan(g, params, dot_collector=dot)
    sub_node_hp, read_hp = read_correction(alns, g, bk_result, sub_node_hp, params)
    result = export_result(chrom, g, bk_result, sub_node_hp)
    if generate_dot:
        # writingDotFile (PhasingGraph.cpp:1031-1047): <chrName>.dot in CWD
        with open(chrom + ".dot", "w") as f:
            f.write("digraph G {\n")
            for line in dot:
                f.write(line + "\n")
            f.write("}\n")
    return result, read_hp, g
