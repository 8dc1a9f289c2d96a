"""Read-correction as vectorized segment reductions (readCorrection,
PhasingGraph.cpp:891-1029).

Two phases:
1. score every alignment against the scanned site haplotypes (banded weights:
   SNP/SV=1, MOD=0, INDEL/DANGER=0.1 — exact decimal x10) and pick confident
   alignments (majority ratio > readConfidence, support > 1),
2. re-vote every site from confident alignments' allele counts; sites below
   snpConfidence lose their phase (bk erasure).

This is the NumPy (host) form, used with the host packer; the fused device
path runs the same segment sums on the device
(ops/fused.device_read_correction).
"""

from __future__ import annotations

import numpy as np

from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP, T_SV


def read_correction_packed(packed, ps: np.ndarray, ori: np.ndarray, params):
    """Returns (ps, ori, read_hp) with the post-correction phase state.

    ps/ori are per-site arrays from the vote scan; mutated copies are
    returned. read_hp maps read name -> 0/1/-1 (last alignment wins, like the
    reference's map overwrite).
    """
    S = len(ps)
    rank = packed.aln_rank.astype(np.int64)
    allele = packed.aln_allele.astype(np.int64)
    offsets = packed.aln_offsets.astype(np.int64)
    A = len(offsets) - 1
    obs_aln = np.repeat(np.arange(A), np.diff(offsets))

    vt = packed.vtype[rank]
    phased = ps[rank] != 0
    w10 = np.zeros(len(rank), dtype=np.int64)
    w10[(vt == T_SNP) | (vt == T_SV)] = 10
    w10[(vt == T_INDEL) | (vt == T_DANGER)] = 1
    w10[vt == T_MOD] = 0
    w10[~phased] = 0

    # orientation of the observed allele: which haplotype does this
    # observation support? subNodeHP[(pos, allele+1)] == 0 -> "refCount"
    # For allele 0 (ref node): hap value = ori[site]. For allele 1: 1 - ori.
    obs_hap = np.where(allele == 0, ori[rank], 1 - ori[rank]).astype(np.int64)

    ref10 = np.bincount(obs_aln, weights=w10 * (obs_hap == 0), minlength=A)
    alt10 = np.bincount(obs_aln, weights=w10 * (obs_hap == 1), minlength=A)
    total10 = ref10 + alt10
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(ref10, alt10) / total10
    confident = (total10 > 0) & (ratio > params.read_confidence) & (total10 > 10)
    belong = np.where(ref10 > alt10, 0, 1)

    read_hp: dict[str, int] = {}
    for i in range(A):
        read_hp[packed.aln_names[i]] = int(belong[i]) if confident[i] else -1

    # phase 2: per-site allele counts from confident alignments
    conf_obs = confident[obs_aln]
    sel = conf_obs & ((allele == 0) | (allele == 1))
    lin = (belong[obs_aln][sel] * 2 + allele[sel]) * S + rank[sel]
    counts = np.bincount(lin, minlength=4 * S).reshape(4, S)
    hp1_ref, hp1_alt, hp2_ref, hp2_alt = counts
    result1 = hp1_ref + hp2_alt
    result2 = hp2_ref + hp1_alt
    total = result1 + result2
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.maximum(result1, result2) / total
    keep = (total > 0) & (conf > params.snp_confidence) & (result1 != result2)

    new_ps = np.where(keep, ps, 0)
    new_ori = np.where(result1 > result2, 0, 1).astype(np.int8)
    return new_ps, new_ori, read_hp
