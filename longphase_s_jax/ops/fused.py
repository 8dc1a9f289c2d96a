"""Fused pair-packing + vote scan on device.

The classic path materializes the banded pair counts [S, W, 4] on host
(`core/fastpath.pack_flat`) and uploads them. This path uploads the merged
per-observation arrays instead and builds the counts ON DEVICE with one
scatter-add, feeding them straight into the vote-scan engine — one
dispatch, no host-side bincount, no counts tensor on the host at all
(ARCHITECTURE.md "device-side pair packing" lever).

``engine`` (static) names the scan engine: 'kernel', 'lax' or 'interpret'
(ops/vote_scan.vote_scan); callers pass ops.vote_scan.scan_engine().

Pair semantics are identical to pack_flat (same shifted-window compares over
the merged-read observation stream); `tests/test_fused_pack.py` proves
element equality of both the counts and the full scan outputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .vote_scan import pair_sums, vote_scan

I32 = jnp.int32


def device_pair_counts(m_read, m_rank, m_allele, m_qok, S_pad: int,
                       window: int):
    """Banded pair counts [S_pad, W, 4] (hi, lo) from merged observation
    arrays. Padding rows must carry m_read == -1 (never pairs)."""
    W = window
    No = m_read.shape[0]
    size = S_pad * W * 4
    idx_parts = []
    val_parts = []
    for m in range(1, W + 1):
        p_read = jnp.roll(m_read, -m)
        p_rank = jnp.roll(m_rank, -m)
        p_allele = jnp.roll(m_allele, -m)
        p_qok = jnp.roll(m_qok, -m)
        tail = jnp.arange(No) >= No - m      # rolled-over partners
        same = (m_read == p_read) & (m_read >= 0) & jnp.logical_not(tail)
        d = p_rank - m_rank
        keep = same & (d >= 1) & (d <= W)
        combo = m_allele.astype(I32) * 2 + p_allele.astype(I32)
        lin = m_rank.astype(I32) * (W * 4) + (d - 1) * 4 + combo
        both = m_qok & p_qok
        # hi plane at [0, size), lo plane at [size, 2*size), dump at 2*size
        lin = lin + jnp.where(both, 0, size)
        lin = jnp.where(keep, lin, 2 * size)
        idx_parts.append(lin)
        val_parts.append(keep.astype(I32))
    idx = jnp.concatenate(idx_parts)
    val = jnp.concatenate(val_parts)
    buf = jnp.zeros(2 * size + 1, I32).at[idx].add(val)
    counts_hi = buf[:size].reshape(S_pad, W, 4)
    counts_lo = buf[size:2 * size].reshape(S_pad, W, 4)
    return counts_hi, counts_lo


def pack_and_scan(m_read, m_rank, m_allele, m_qok, gap, vtype, vtype_band,
                  valid_band, S_pad, window, distance, edge_threshold_x10,
                  engine):
    """Scatter pair pack + vote scan (traced): (assigned, hp, bstart)."""
    counts_hi, counts_lo = device_pair_counts(m_read, m_rank, m_allele,
                                              m_qok, S_pad, window)
    s_para, s_cross = pair_sums(counts_hi, counts_lo)
    return vote_scan(s_para, s_cross, gap, vtype, vtype_band, valid_band,
                     window=window, distance=distance,
                     edge_threshold_x10=edge_threshold_x10, engine=engine)


def _fused_pack_scan(m_read, m_rank, m_allele, m_qok, gap, vtype, vtype_band,
                     valid_band, S_pad, window, distance, edge_threshold_x10,
                     engine):
    assigned, hp, bstart = pack_and_scan(
        m_read, m_rank, m_allele, m_qok, gap, vtype, vtype_band, valid_band,
        S_pad, window, distance, edge_threshold_x10, engine)
    return jnp.stack([assigned.astype(I32), hp, bstart])


fused_pack_scan_jit = jax.jit(
    _fused_pack_scan,
    static_argnames=("S_pad", "window", "distance", "edge_threshold_x10",
                     "engine"))


def device_assemble_blocks(assigned, hp, bstart, positions, S: int):
    """Block assembly on device (vectorized assemble_blocks,
    PhasingGraph.cpp:423-467): contiguous member runs sharing a block start,
    single-member runs dropped, orientation = parity of hp flips within the
    run. Element-exact vs ops.vote_scan.assemble_blocks."""
    S_pad = assigned.shape[0]
    idx = jnp.arange(S_pad, dtype=I32)
    member = assigned & (idx != S - 1) & (idx < S)
    # Gather-free neighbor lookups: the previous
    # member's hp rides a cummax of (idx << 2 | hp), strictly increasing
    # over members so cummax = most recent; bstart is non-decreasing over
    # members (the scan's block_start carry only moves forward), so its
    # masked cummax IS the previous member's value.
    packed = jnp.where(member, (idx << 2) | hp, -1)
    prev_incl = jax.lax.cummax(packed)
    prev_excl = jnp.concatenate([jnp.full((1,), -1, I32), prev_incl[:-1]])
    has_prev = prev_excl >= 0
    hp_prev = prev_excl & 3
    pb_incl = jax.lax.cummax(jnp.where(member, bstart, -1))
    pb_excl = jnp.concatenate([jnp.full((1,), -1, I32), pb_incl[:-1]])
    same_run = member & has_prev & (pb_excl == bstart)
    flip = same_run & (hp_prev != hp)
    run_start = member & ~same_run
    cums = jnp.cumsum(flip.astype(I32))
    # cums is non-decreasing, so forward-filling its run-start samples is
    # again a masked cummax; every member has a run start at or before it
    ffc = jax.lax.cummax(jnp.where(run_start, cums, -1))
    ori = jnp.where(member, (cums - jnp.maximum(ffc, 0)) % 2, 0)
    # next member's same_run flag decides whether a run start survives:
    # reversed masked cummax of ((S_pad - idx) << 1 | same_run) finds the
    # nearest member after i and carries its flag in the low bit
    npacked = jnp.where(member, ((S_pad - idx) << 1) | same_run.astype(I32),
                        -1)
    rev = jax.lax.cummax(npacked[::-1])[::-1]
    next_excl = jnp.concatenate([rev[1:], jnp.full((1,), -1, I32)])
    next_same = (next_excl >= 0) & ((next_excl & 1) == 1)
    keep = member & (same_run | next_same)
    ps = jnp.where(keep, positions[jnp.maximum(bstart, 0)] + 1, 0)
    return ps.astype(I32), ori.astype(jnp.int8)


def device_read_correction(ps, ori, vtype, obs_rank, obs_allele, obs_aln,
                           A_pad: int, read_confidence, snp_confidence):
    """readCorrection on device (PhasingGraph.cpp:891-1029): per-alignment
    haplotype scoring (x10 integer weights), confident-read re-vote of every
    site. Counts stay integral; ratio compares run in f32 (count granularity
    ~5e-7 over these totals keeps boundary behavior identical to f64).

    All three obs arrays may be any permutation of the observation stream
    (everything here is a segment sum) — run_fused_phase passes the merged
    stream plus a per-observation alignment id to avoid a second upload."""
    S_pad = ps.shape[0]
    vt = vtype[obs_rank]
    from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP, T_SV

    valid = obs_aln >= 0
    aln = jnp.where(valid, obs_aln, 0)
    phased = ps[obs_rank] != 0
    w10 = jnp.zeros(obs_rank.shape[0], I32)
    w10 = jnp.where((vt == T_SNP) | (vt == T_SV), 10, w10)
    w10 = jnp.where((vt == T_INDEL) | (vt == T_DANGER), 1, w10)
    w10 = jnp.where(vt == T_MOD, 0, w10)
    w10 = jnp.where(phased & valid, w10, 0)
    obs_hap = jnp.where(obs_allele == 0, ori[obs_rank],
                        1 - ori[obs_rank]).astype(I32)
    ref10 = jnp.zeros(A_pad, I32).at[aln].add(w10 * (obs_hap == 0))
    alt10 = jnp.zeros(A_pad, I32).at[aln].add(w10 * (obs_hap == 1))
    total10 = ref10 + alt10
    mx = jnp.maximum(ref10, alt10).astype(jnp.float32)
    ratio = jnp.where(total10 > 0, mx / jnp.maximum(total10, 1).astype(jnp.float32),
                      0.0)
    confident = (total10 > 0) & (ratio > read_confidence) & (total10 > 10)
    belong = jnp.where(ref10 > alt10, 0, 1).astype(I32)

    sel = confident[aln] & valid & ((obs_allele == 0) | (obs_allele == 1))
    lin = (belong[aln] * 2 + obs_allele.astype(I32)) * S_pad + obs_rank
    counts = jnp.zeros(4 * S_pad, I32).at[lin].add(sel.astype(I32))
    counts = counts.reshape(4, S_pad)
    result1 = counts[0] + counts[3]
    result2 = counts[2] + counts[1]
    total = result1 + result2
    conf = jnp.where(total > 0,
                     jnp.maximum(result1, result2).astype(jnp.float32)
                     / jnp.maximum(total, 1).astype(jnp.float32), 0.0)
    keep = (total > 0) & (conf > snp_confidence) & (result1 != result2)
    new_ps = jnp.where(keep, ps, 0)
    new_ori = jnp.where(result1 > result2, 0, 1).astype(jnp.int8)
    return new_ps, new_ori


def _fused_phase(m_read, m_rank, m_allele, m_qok, m_aln, gap, vtype,
                 vtype_band, valid_band, positions,
                 S, S_pad, A_pad, window, distance, edge_threshold_x10,
                 read_confidence, snp_confidence, engine):
    assigned, hp, bstart = pack_and_scan(
        m_read, m_rank, m_allele, m_qok, gap, vtype, vtype_band, valid_band,
        S_pad, window, distance, edge_threshold_x10, engine)
    ps, ori = device_assemble_blocks(assigned.astype(bool), hp.astype(I32),
                                     bstart.astype(I32), positions, S)
    new_ps, new_ori = device_read_correction(
        ps, ori, vtype, m_rank, m_allele, m_aln, A_pad,
        read_confidence, snp_confidence)
    return jnp.stack([new_ps, new_ori.astype(I32)])


fused_phase_jit = jax.jit(
    _fused_phase,
    static_argnames=("S", "S_pad", "A_pad", "window", "distance",
                     "edge_threshold_x10", "read_confidence", "snp_confidence",
                     "engine"))


def _mxu_phase(bits_nib, vtype, positions, S, window, distance,
               edge_threshold_x10, engine):
    """Gram-pack variant of _fused_phase up to block assembly (read
    correction runs on host from the merged stream — the whole observation
    stream never ships to the device on this path).

    ``bits_nib`` is the [T, R, ceil(L/2)] nibble-packed tile plane (two
    3-bit entries per byte, half the upload); the site gap and the
    vtype/valid bands are derived on device from positions/vtype rather
    than shipped."""
    from .mxu_pack import mxu_pc_counts

    # unpack nibbles -> [T, R, L] (entry 2i in the high nibble)
    L = 128 + window
    bits = jnp.stack([bits_nib >> 4, bits_nib & 0xF],
                     axis=-1).reshape(*bits_nib.shape[:-1], -1)[..., :L]

    S_pad = positions.shape[0]
    gap = jnp.where(
        jnp.arange(S_pad) < S - 1,
        jnp.concatenate([positions[1:] - positions[:-1],
                         jnp.zeros(1, positions.dtype)]),
        jnp.int32(np.iinfo(np.int32).max)).astype(jnp.int32)
    tgt = jnp.arange(S_pad, dtype=I32)[:, None] + \
        jnp.arange(1, window + 1, dtype=I32)[None, :]
    valid_band = tgt < S
    # banded vtype lookup as W static shifted slices (no gather)
    vpad = jnp.concatenate([vtype, jnp.zeros(window, jnp.int8)])
    vtype_band = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(vpad, d, S_pad) for d in
         range(1, window + 1)], axis=1)
    vtype_band = jnp.where(valid_band, vtype_band, jnp.int8(0))

    s_para10, s_cross10 = mxu_pc_counts(bits, window)
    assigned, hp, bstart = vote_scan(
        s_para10, s_cross10, gap, vtype, vtype_band, valid_band,
        window=window, distance=distance,
        edge_threshold_x10=edge_threshold_x10, engine=engine)
    ps, ori = device_assemble_blocks(assigned.astype(bool), hp.astype(I32),
                                     bstart.astype(I32), positions, S)
    return jnp.stack([ps, ori.astype(I32)])


mxu_phase_jit = jax.jit(
    _mxu_phase,
    static_argnames=("S", "window", "distance", "edge_threshold_x10",
                     "engine"))


def mxu_pack_min() -> int:
    """Observation count above which the Gram tile pack replaces the
    scatter pack. The Gram path also uploads ~4-5x fewer bytes (the uint8
    bit plane instead of the observation stream). The 2^18 default is
    unmeasured on the H100 (ROADMAP A8 measures the crossover);
    LPS_MXU_PACK_MIN overrides it."""
    import os

    return int(os.environ.get("LPS_MXU_PACK_MIN", str(1 << 18)))


# the pack and scan engine of the last run_fused_phase call, for reports
# (chip_smoke.py prints which path a phase run took)
last_route: dict = {}


def run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln, positions, vtype,
                    n_aln: int, params, engine: str):
    """One-dispatch phase compute: pair pack + vote scan + block assembly + read
    correction on device. Returns (ps, ori) numpy arrays of length S.

    The merged observation stream (m_*) drives BOTH the pair packer and the
    read-correction segment sums — read correction is permutation-invariant,
    so the sorted stream plus its per-observation alignment id (m_aln) avoids
    a second upload of the unsorted stream."""
    W = params.connect_adjacent
    S = len(positions)
    S_pad = max(256, 1 << int(np.ceil(np.log2(S))))
    No = len(m_read)
    No_pad = max(1024, 1 << int(np.ceil(np.log2(max(No, 1)))))
    A_pad = max(256, 1 << int(np.ceil(np.log2(max(n_aln, 1)))))

    if No >= mxu_pack_min():
        out = _run_mxu_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                             positions, vtype, n_aln, params, S, S_pad,
                             engine)
        if out is not None:
            last_route.update(pack="gram", scan=engine, S_pad=S_pad, No=No)
            return out
    last_route.update(pack="scatter", scan=engine, S_pad=S_pad, No=No)

    def pad_to(a, n, fill, dtype):
        out = np.full(n, fill, dtype)
        out[:len(a)] = a
        return out

    m_read_p = pad_to(m_read, No_pad, -1, np.int32)
    m_rank_p = pad_to(m_rank, No_pad, 0, np.int32)
    m_allele_p = pad_to(m_allele, No_pad, 0, np.int8)
    m_qok_p = pad_to(m_qok, No_pad, False, bool)
    m_aln_p = pad_to(m_aln, No_pad, -1, np.int32)

    gap = np.full(S_pad, np.iinfo(np.int32).max, dtype=np.int32)
    if S > 1:
        gap[:S - 1] = np.minimum(np.diff(positions),
                                 np.iinfo(np.int32).max).astype(np.int32)
    ranks = np.arange(S)
    tgt = ranks[:, None] + np.arange(1, W + 1)[None, :]
    valid_band = np.zeros((S_pad, W), dtype=bool)
    valid_band[:S] = tgt < S
    vtype_band = np.zeros((S_pad, W), dtype=np.int8)
    vtype_band[:S] = np.where(tgt < S, vtype[np.minimum(tgt, S - 1)], 0)
    vtype_p = np.zeros(S_pad, dtype=np.int8)
    vtype_p[:S] = vtype
    positions_p = np.zeros(S_pad, dtype=np.int32)
    positions_p[:S] = positions

    out = np.array(fused_phase_jit(
        jnp.asarray(m_read_p), jnp.asarray(m_rank_p), jnp.asarray(m_allele_p),
        jnp.asarray(m_qok_p), jnp.asarray(m_aln_p), jnp.asarray(gap),
        jnp.asarray(vtype_p), jnp.asarray(vtype_band),
        jnp.asarray(valid_band), jnp.asarray(positions_p),
        S=S, S_pad=S_pad, A_pad=A_pad, window=W, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0,
        read_confidence=float(params.read_confidence),
        snp_confidence=float(params.snp_confidence), engine=engine))
    return out[0, :S].astype(np.int64), out[1, :S].astype(np.int8)


def _run_mxu_phase(m_read, m_rank, m_allele, m_qok, m_aln, positions, vtype,
                   n_aln, params, S, S_pad, engine):
    """WGS-scale path: Gram tile pack + scan + assembly on device, read
    correction on host. Returns (ps, ori) or None when the stream violates
    the tile-pack assumptions (caller uses the scatter pack)."""
    import os as _os
    import time as _time

    from .mxu_pack import build_tiles, host_read_correction_merged
    _timing = bool(_os.environ.get("LPS_TIMING"))
    _marks = [("t0", _time.perf_counter())]

    W = params.connect_adjacent
    bits = build_tiles(m_read, m_rank, m_allele, m_qok, S_pad, W)
    if bits is None:
        return None
    _marks.append(("tiles", _time.perf_counter()))

    # nibble-pack the tile plane (two 3-bit entries per byte): half the
    # upload for two elementwise ops of device unpack
    L = bits.shape[-1]
    if L % 2:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], 1), np.uint8)], axis=-1)
    bits_nib = (bits[..., 0::2] << 4) | bits[..., 1::2]

    vtype_p = np.zeros(S_pad, dtype=np.int8)
    vtype_p[:S] = vtype
    positions_p = np.zeros(S_pad, dtype=np.int32)
    positions_p[:S] = positions

    _marks.append(("bands", _time.perf_counter()))
    dev_in = [jnp.asarray(bits_nib), jnp.asarray(vtype_p),
              jnp.asarray(positions_p)]
    if _timing:
        jax.block_until_ready(dev_in)
        _marks.append(("upload", _time.perf_counter()))
    dev = mxu_phase_jit(
        *dev_in,
        S=S, window=W, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0,
        engine=engine)
    _marks.append(("dispatch", _time.perf_counter()))
    out = np.array(dev)
    _marks.append(("device+download", _time.perf_counter()))
    ps = out[0, :S].astype(np.int64)
    ori = out[1, :S].astype(np.int8)
    new_ps, new_ori = host_read_correction_merged(
        ps, ori, vtype, m_rank, m_allele, m_aln, n_aln,
        params.read_confidence, params.snp_confidence)
    _marks.append(("read_correction", _time.perf_counter()))
    if _timing:
        import sys as _sys
        parts = " ".join(
            f"{name}={1000 * (t - _marks[i][1]):.0f}ms"
            for i, (name, t) in enumerate(_marks[1:]))
        print(f"[lps_timing] mxu_phase: {parts}", file=_sys.stderr)
    return new_ps.astype(np.int64), new_ori.astype(np.int8)


def run_fused_pack_scan(m_read, m_rank, m_allele, m_qok, positions, vtype,
                        params, engine: str):
    """Host wrapper: pad the observation stream and site axis to power-of-2
    buckets, run the fused jit, return (assigned, hp, bstart) numpy arrays
    truncated to S."""
    W = params.connect_adjacent
    S = len(positions)
    S_pad = max(256, 1 << int(np.ceil(np.log2(S))))
    No = len(m_read)
    No_pad = max(1024, 1 << int(np.ceil(np.log2(max(No, 1)))))

    def pad_obs(a, fill, dtype):
        out = np.full(No_pad, fill, dtype)
        out[:No] = a
        return out

    m_read_p = pad_obs(m_read, -1, np.int32)
    m_rank_p = pad_obs(m_rank, 0, np.int32)
    m_allele_p = pad_obs(m_allele, 0, np.int8)
    m_qok_p = pad_obs(m_qok, False, bool)

    gap = np.full(S_pad, np.iinfo(np.int32).max, dtype=np.int32)
    if S > 1:
        gap[:S - 1] = np.minimum(np.diff(positions),
                                 np.iinfo(np.int32).max).astype(np.int32)
    ranks = np.arange(S)
    tgt = ranks[:, None] + np.arange(1, W + 1)[None, :]
    valid_band = np.zeros((S_pad, W), dtype=bool)
    valid_band[:S] = tgt < S
    vtype_band = np.zeros((S_pad, W), dtype=np.int8)
    vtype_band[:S] = np.where(tgt < S, vtype[np.minimum(tgt, S - 1)], 0)
    vtype_p = np.zeros(S_pad, dtype=np.int8)
    vtype_p[:S] = vtype

    out = np.array(fused_pack_scan_jit(
        jnp.asarray(m_read_p), jnp.asarray(m_rank_p), jnp.asarray(m_allele_p),
        jnp.asarray(m_qok_p), jnp.asarray(gap), jnp.asarray(vtype_p),
        jnp.asarray(vtype_band), jnp.asarray(valid_band),
        S_pad=S_pad, window=W, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0,
        engine=engine))
    return out[0, :S].astype(bool), out[1, :S], out[2, :S]
