"""Dense packing: filtered alignments -> device-ready tensors.

This is the boundary between the host runtime and the device compute path.
Replaces the reference's pointer-heavy maps (totalVariantInfo / edgeList /
mergeReadMap, PhasingGraph.cpp:793-888) with arrays:

* site table: sorted positions, variant types
* banded pair counts ``counts_hi/lo[S, W, 4]`` — for site-rank i and rank
  distance d<=W, the number of read-pair observations per allele combo
  (rr, ra, ar, aa), split into full-weight (both baseQ pass) and low-weight
  contributions. Counts are exact integers; the engine evaluates the
  reference's float thresholds in exact decimal (x10) arithmetic.
* per-alignment CSR arrays for read-correction scoring.

The reference stores a pair (i, j) whenever j is among the next W variants on
a read, but only ever *reads* pairs whose global site-rank distance is <= W
(edgeConnectResult walks the next W sites, PhasingGraph.cpp:360-417). Since
rank distance >= read-local distance, packing only pairs with
1 <= rank_j - rank_i <= W is lossless.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alleles import ReadAln
from .phase_algo import PhaseParams, T_DANGER, T_INDEL, T_MOD, T_SNP, T_SV


@dataclass
class PackedChromosome:
    positions: np.ndarray      # int64[S] site positions (sorted)
    vtype: np.ndarray          # int8[S]
    counts_hi: np.ndarray      # int32[S, W, 4]
    counts_lo: np.ndarray      # int32[S, W, 4]
    # per-alignment CSR (readCorrection input)
    aln_offsets: np.ndarray    # int32[A+1]
    aln_rank: np.ndarray       # int32[nnz] site rank per observation
    aln_allele: np.ndarray     # int8[nnz]
    aln_names: list[str]       # A read names (per alignment)
    window: int


def _remap_qual(allele: np.ndarray, qual: np.ndarray):
    """Sentinel-quality remap + variant typing (PhasingGraph.cpp:800-832)."""
    vtype = np.full(qual.shape, T_SNP, dtype=np.int8)
    out_q = qual.astype(np.int32).copy()
    mod = (qual == -2) | (qual == -3)
    vtype[mod] = T_MOD
    out_q[mod] = 60
    sv = qual == -1
    vtype[sv] = T_SV
    out_q[sv & (allele == 1)] = 60
    out_q[sv & (allele != 1)] = 30
    ind = qual == -4
    vtype[ind] = T_INDEL
    out_q[ind] = 60
    dang = qual == -5
    vtype[dang] = T_DANGER
    out_q[dang] = 60
    return vtype, out_q


def pack_chromosome(alns: list[ReadAln], params: PhaseParams) -> PackedChromosome | None:
    if not alns:
        return None
    W = params.connect_adjacent

    # --- flatten all observations, with per-alignment ids -----------------
    n_obs = sum(len(a.positions) for a in alns)
    if n_obs == 0:
        return None
    flat_pos = np.empty(n_obs, dtype=np.int64)
    flat_allele = np.empty(n_obs, dtype=np.int8)
    flat_qual = np.empty(n_obs, dtype=np.int32)
    aln_offsets = np.zeros(len(alns) + 1, dtype=np.int64)
    cursor = 0
    for i, a in enumerate(alns):
        k = len(a.positions)
        flat_pos[cursor:cursor + k] = a.positions
        flat_allele[cursor:cursor + k] = a.alleles
        flat_qual[cursor:cursor + k] = a.quals
        cursor += k
        aln_offsets[i + 1] = cursor

    obs_vtype, obs_q = _remap_qual(flat_allele, flat_qual)

    # --- site table -------------------------------------------------------
    positions = np.unique(flat_pos)
    S = len(positions)
    rank = np.searchsorted(positions, flat_pos).astype(np.int32)
    vtype = np.zeros(S, dtype=np.int8)
    vtype[rank] = obs_vtype  # same type per site across observations

    # --- merged reads (by name, variants sorted by position) -------------
    name_per_aln = [a.read_name for a in alns]
    order_names = sorted(set(name_per_aln))
    name_id = {n: i for i, n in enumerate(order_names)}
    obs_read = np.repeat(
        np.fromiter((name_id[n] for n in name_per_aln), dtype=np.int64, count=len(alns)),
        np.diff(aln_offsets))
    # sort observations by (read, position); stable keeps alignment order for
    # duplicate positions (matches the reference's stable-on-equal merge well
    # enough; std::sort order for equal keys is unspecified there)
    merge_order = np.lexsort((flat_pos, obs_read))
    m_read = obs_read[merge_order]
    m_rank = rank[merge_order]
    m_allele = flat_allele[merge_order].astype(np.int32)
    m_qok = (obs_q[merge_order] >= params.base_quality)

    # --- banded pair enumeration -----------------------------------------
    # pairs (k, k+m) for m=1..W within each merged read
    counts_hi = np.zeros(S * W * 4, dtype=np.int32)
    counts_lo = np.zeros(S * W * 4, dtype=np.int32)
    N = len(m_rank)
    for m in range(1, W + 1):
        if m >= N:
            break
        i1 = slice(0, N - m)
        i2 = slice(m, N)
        same_read = m_read[i1] == m_read[i2]
        d = m_rank[i2] - m_rank[i1]
        keep = same_read & (d >= 1) & (d <= W)
        if not keep.any():
            continue
        r1 = m_rank[i1][keep].astype(np.int64)
        dd = d[keep].astype(np.int64)
        combo = m_allele[i1][keep] * 2 + m_allele[i2][keep]
        hi = m_qok[i1][keep] & m_qok[i2][keep]
        lin = r1 * (W * 4) + (dd - 1) * 4 + combo
        np.add.at(counts_hi, lin[hi], 1)
        np.add.at(counts_lo, lin[~hi], 1)

    counts_hi = counts_hi.reshape(S, W, 4)
    counts_lo = counts_lo.reshape(S, W, 4)

    return PackedChromosome(
        positions=positions, vtype=vtype,
        counts_hi=counts_hi, counts_lo=counts_lo,
        aln_offsets=aln_offsets.astype(np.int32), aln_rank=rank,
        aln_allele=flat_allele, aln_names=name_per_aln, window=W)
