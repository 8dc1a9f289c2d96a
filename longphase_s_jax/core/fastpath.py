"""Flat-array phase pipeline: native ingest arrays -> device tensors without
materializing per-read Python objects.

Stages mirror phase_chromosome (and are golden-verified against it):
overlap-alignment filter -> ONT erasure -> banded pair counting -> vote scan
-> read correction. CNV intervals run the object pipeline's exact filter
over lightweight per-alignment views (_cnv_filter_flat).
"""

from __future__ import annotations

import numpy as np

from .matrix import PackedChromosome, _remap_qual
from .phase_algo import PhaseParams


def filter_overlap_flat(names: list[str], first_pos, last_pos,
                        overlap_threshold: float):
    """filter_overlap_alignments on per-alignment summaries
    (PhasingGraph.cpp:707-781 incl. the range.first==0 quirk).
    Returns a keep mask (bool[A])."""
    A = len(names)
    if A > 512:
        from .. import native

        if native.available():
            keep = native.filter_overlap(names, first_pos, last_pos,
                                         overlap_threshold)
            if keep is not None:
                return keep
    keep = np.ones(A, dtype=bool)
    align_range: dict[str, list[int]] = {}
    read_idx_vec: dict[str, list[int]] = {}
    for i in range(A):
        name = names[i]
        first = int(first_pos[i])
        last = int(last_pos[i])
        rng = align_range.setdefault(name, [0, 0])
        idxv = read_idx_vec.setdefault(name, [])
        to_delete = False
        while rng[0] <= first <= rng[1]:
            if last < rng[1]:
                to_delete = True
                keep[i] = False
                break
            pre = len(idxv) - 1
            if pre < 0:
                break
            prev = idxv[pre]
            prev_start = int(first_pos[prev])
            prev_end = int(last_pos[prev])
            overlap_start = max(prev_start, first)
            overlap_end = min(prev_end, last)
            if overlap_start > overlap_end:
                break
            overlap_len = overlap_end - overlap_start + 1
            align_span = max(prev_end, last) - min(prev_start, first) + 1
            if overlap_len / align_span >= overlap_threshold:
                len1 = prev_end - prev_start + 1
                len2 = last - first + 1
                if len2 <= len1:
                    to_delete = True
                    keep[i] = False
                    break
                else:
                    keep[idxv[pre]] = False
                    idxv.pop()
                    rng[1] = (int(last_pos[idxv[pre - 1]]) if pre > 0 else first)
            else:
                break
        rng[1] = last
        if not to_delete:
            idxv.append(i)
    return keep


def merge_observations(obs_pos, obs_allele, obs_qual, aln_offsets, names,
                       params: PhaseParams):
    """Merged-read observation stream shared by the host bincount packer and
    the fused device packer: returns (positions, vtype, rank, m_read, m_rank,
    m_allele, m_qok, m_aln). The m_* arrays are the observation stream sorted
    by (read name id, position); m_aln carries the source alignment index so
    the device read-correction can segment-sum per alignment without a second
    upload of the unsorted stream."""
    sizes = np.diff(aln_offsets)
    obs_vtype, obs_q = _remap_qual(obs_allele, obs_qual)

    merged = None
    if len(obs_pos) > 8192:
        from .. import native

        if native.available():
            merged = native.merge_obs(obs_pos, aln_offsets, names)
    if merged is not None:
        positions, rank, order, obs_read, obs_aln = merged
        S = len(positions)
        vtype = np.zeros(S, dtype=np.int8)
        vtype[rank] = obs_vtype
        m_read = obs_read[order]
        m_rank = rank[order]
        m_allele = obs_allele[order].astype(np.int64)
        m_qok = obs_q[order] >= params.base_quality
        m_aln = obs_aln[order]
        return positions, vtype, rank, m_read, m_rank, m_allele, m_qok, m_aln

    positions = np.unique(obs_pos)
    S = len(positions)
    rank = np.searchsorted(positions, obs_pos).astype(np.int32)
    vtype = np.zeros(S, dtype=np.int8)
    vtype[rank] = obs_vtype

    # merged reads: group by read name (id by unique name)
    name_arr = np.asarray(names)
    _uniq, read_id = np.unique(name_arr, return_inverse=True)
    obs_read = np.repeat(read_id, sizes)
    order = np.lexsort((obs_pos, obs_read))
    m_read = obs_read[order].astype(np.int32)
    m_rank = rank[order]
    m_allele = obs_allele[order].astype(np.int64)
    m_qok = obs_q[order] >= params.base_quality
    m_aln = np.repeat(np.arange(len(sizes), dtype=np.int32),
                      sizes)[order]
    return positions, vtype, rank, m_read, m_rank, m_allele, m_qok, m_aln


def pack_flat(obs_pos, obs_allele, obs_qual, aln_offsets, names: list[str],
              params: PhaseParams) -> PackedChromosome | None:
    """pack_chromosome from flat arrays (vectorized; bincount accumulation)."""
    if len(obs_pos) == 0:
        return None
    W = params.connect_adjacent
    positions, vtype, rank, m_read, m_rank, m_allele, m_qok, _m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, aln_offsets, names,
                           params)
    S = len(positions)

    N = len(m_rank)
    lin_parts_hi = []
    lin_parts_lo = []
    for m in range(1, W + 1):
        if m >= N:
            break
        same = m_read[:N - m] == m_read[m:]
        d = m_rank[m:] - m_rank[:N - m]
        keep = same & (d >= 1) & (d <= W)
        if not keep.any():
            continue
        r1 = m_rank[:N - m][keep].astype(np.int64)
        dd = d[keep].astype(np.int64)
        combo = m_allele[:N - m][keep] * 2 + m_allele[m:][keep]
        hi = m_qok[:N - m][keep] & m_qok[m:][keep]
        lin = r1 * (W * 4) + (dd - 1) * 4 + combo
        lin_parts_hi.append(lin[hi])
        lin_parts_lo.append(lin[~hi])

    size = S * W * 4
    if lin_parts_hi:
        counts_hi = np.bincount(np.concatenate(lin_parts_hi), minlength=size)
    else:
        counts_hi = np.zeros(size, np.int64)
    if lin_parts_lo:
        counts_lo = np.bincount(np.concatenate(lin_parts_lo), minlength=size)
    else:
        counts_lo = np.zeros(size, np.int64)

    return PackedChromosome(
        positions=positions, vtype=vtype,
        counts_hi=counts_hi.reshape(S, W, 4).astype(np.int32),
        counts_lo=counts_lo.reshape(S, W, 4).astype(np.int32),
        aln_offsets=np.asarray(aln_offsets, np.int64),
        aln_rank=rank, aln_allele=np.asarray(obs_allele, np.int8),
        aln_names=names, window=W)


class _AlnLite:
    __slots__ = ("positions", "alleles", "quals")


def _cnv_filter_flat(obs_pos, obs_allele, obs_qual, aln_offsets, cnv_vec):
    """CNV high-mismatch erasure on the CSR observation arrays. Runs the
    exact object-pipeline filter (phase_algo.cnv_mismatch_filter,
    PhasingGraph.cpp:520-692) over lightweight per-alignment views, then
    rebuilds the flat arrays — CNV intervals are rare enough that the
    list round-trip is negligible next to ingest."""
    from .phase_algo import cnv_mismatch_filter

    A = len(aln_offsets) - 1
    alns = []
    for i in range(A):
        a, b = int(aln_offsets[i]), int(aln_offsets[i + 1])
        al = _AlnLite()
        al.positions = obs_pos[a:b].tolist()
        al.alleles = obs_allele[a:b].tolist()
        al.quals = obs_qual[a:b].tolist()
        alns.append(al)
    cnv_mismatch_filter(alns, cnv_vec)
    sizes = np.fromiter((len(al.positions) for al in alns), np.int64, A)
    new_off = np.concatenate([[0], np.cumsum(sizes)])
    if len(alns):
        new_pos = np.concatenate(
            [np.asarray(al.positions, np.int64) for al in alns])
        new_allele = np.concatenate(
            [np.asarray(al.alleles, np.int8) for al in alns])
        new_qual = np.concatenate(
            [np.asarray(al.quals, np.int16) for al in alns])
    else:
        new_pos = np.zeros(0, np.int64)
        new_allele = np.zeros(0, np.int8)
        new_qual = np.zeros(0, np.int16)
    return new_pos, new_allele, new_qual, new_off


def phase_chromosome_flat(flat: dict, cnv_vec, chrom: str, params: PhaseParams,
                          erased_positions=None, defer_sink=None):
    """Fast path over the native ingest dict. Returns (result, read_hp, packed)
    or None when a fallback to the object pipeline is required.

    With ``defer_sink`` (a list), the prepared merged observation stream is
    appended to the sink and the string ``"deferred"`` is returned instead of
    running the device phase — run_phase batches the collected chromosomes
    across the device mesh (parallel/multichip.py)."""
    from ..ops.read_correction import read_correction_packed
    from ..ops.vote_scan import device_platform, run_vote_scan, scan_engine

    obs_pos = flat["obs_pos"]
    obs_allele = flat["obs_allele"]
    obs_qual = flat["obs_qual"]
    aln_offsets = flat["aln_offsets"]
    name_offsets = flat["name_offsets"]
    names_blob = flat["names"]
    A = len(aln_offsets) - 1
    if A == 0:
        return {}, {}, None
    names = [names_blob[name_offsets[i]:name_offsets[i + 1]] for i in range(A)]

    # ONT erasure of error-prone SNPs from observations
    if erased_positions:
        mask = ~np.isin(obs_pos, np.fromiter(erased_positions, np.int64,
                                             len(erased_positions)))
        sizes = np.diff(aln_offsets)
        kept_per_aln = np.add.reduceat(mask.astype(np.int64), aln_offsets[:-1]) \
            if len(mask) else np.zeros(A, np.int64)
        obs_pos = obs_pos[mask]
        obs_allele = obs_allele[mask]
        obs_qual = obs_qual[mask]
        aln_offsets = np.concatenate([[0], np.cumsum(kept_per_aln)])
        # alignments that lost all observations remain as inert entries
        # (reference keeps empty ReadVariant entries in the vector)

    sizes = np.diff(aln_offsets)
    nonempty = sizes > 0
    first_pos = np.zeros(A, np.int64)
    last_pos_arr = np.zeros(A, np.int64)
    ne_idx = np.nonzero(nonempty)[0]
    first_pos[ne_idx] = obs_pos[aln_offsets[:-1][ne_idx]]
    last_pos_arr[ne_idx] = obs_pos[aln_offsets[1:][ne_idx] - 1]

    # overlap filter skips empty alignments (matches the guarded oracle)
    keep = np.ones(A, dtype=bool)
    if len(ne_idx):
        sub_keep = filter_overlap_flat(
            [names[i] for i in ne_idx], first_pos[ne_idx], last_pos_arr[ne_idx],
            params.overlap_threshold)
        keep[ne_idx] = sub_keep

    if not keep.all():
        obs_keep = np.repeat(keep, sizes)
        obs_pos = obs_pos[obs_keep]
        obs_allele = obs_allele[obs_keep]
        obs_qual = obs_qual[obs_keep]
        kept_sizes = sizes[keep]
        aln_offsets = np.concatenate([[0], np.cumsum(kept_sizes)])
        names = [n for n, k in zip(names, keep) if k]
        A = len(names)

    # CNV high-mismatch erasure (after the overlap filter, matching
    # phase_chromosome's order: filter_overlap -> cnv_mismatch_filter)
    if cnv_vec:
        obs_pos, obs_allele, obs_qual, aln_offsets = _cnv_filter_flat(
            obs_pos, obs_allele, obs_qual, aln_offsets, cnv_vec)

    if defer_sink is not None and len(obs_pos):
        positions, vtype, _rank, m_read, m_rank, m_allele, m_qok, m_aln = \
            merge_observations(obs_pos, obs_allele, obs_qual, aln_offsets,
                               names, params)
        defer_sink.append({
            "chrom": chrom, "positions": positions, "vtype": vtype,
            "m_read": m_read, "m_rank": m_rank, "m_allele": m_allele,
            "m_qok": m_qok, "m_aln": m_aln,
            "n_aln": len(aln_offsets) - 1,
        })
        return "deferred"

    # on the GPU the merged observations go straight to the device: pair
    # counts, vote scan, block assembly and read correction run in ONE jit
    # call; the CPU keeps the host packer + lax.scan
    if len(obs_pos) and device_platform() == "gpu":
        from ..ops.fused import run_fused_phase

        positions, vtype, rank, m_read, m_rank, m_allele, m_qok, m_aln = \
            merge_observations(obs_pos, obs_allele, obs_qual, aln_offsets,
                               names, params)
        ps, ori = run_fused_phase(
            m_read, m_rank, m_allele, m_qok, m_aln, positions, vtype,
            len(aln_offsets) - 1, params, scan_engine())
        read_hp = {}
        packed = PackedChromosome(
            positions=positions, vtype=vtype, counts_hi=None,
            counts_lo=None, aln_offsets=np.asarray(aln_offsets, np.int64),
            aln_rank=rank, aln_allele=np.asarray(obs_allele, np.int8),
            aln_names=names, window=params.connect_adjacent)
    else:
        packed = pack_flat(obs_pos, obs_allele, obs_qual, aln_offsets, names,
                           params)
        if packed is None:
            return {}, {}, None
        ps, ori = run_vote_scan(packed, params)
        ps, ori, read_hp = read_correction_packed(packed, ps, ori, params)
        positions = packed.positions

    result: dict[str, tuple[str, int]] = {}
    for i in np.nonzero(ps)[0]:
        o = int(ori[i])
        result[f"{chrom}_{int(positions[i])}"] = (f"{o}|{1 - o}", int(ps[i]))
    return result, read_hp, packed
