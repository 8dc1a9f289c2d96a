"""Matmul (Gram) formulation of the banded pair-pack for WGS-scale streams.

`ops.fused.device_pair_counts` builds the [S, W, 4] hi/lo count planes with
one scatter-add of W*No updates and needs the whole observation stream on
the device. This module recasts the pack as batched integer matrix
products:

- tile the site-rank axis into 128-rank tiles; each merged read occupies one
  row per tile it touches (reads cover contiguous rank ranges, so the
  (read, tile) row map is a couple of cumsums on host);
- build ONE dense uint8 plane [tiles, rows, 128+W] holding
  (covered | allele<<1 | qok<<2) bits — built with numpy fancy indexing on
  host and shipped as a single upload (~T*R*L bytes, typically 4-5x smaller
  than the observation stream it replaces);
- on device, slice the bit plane into allele/qok masks and compute
  G[a1,a2] = einsum('trl,trm->tlm') as batched int8 matmuls with int32
  accumulation (exact — counts are small integers);
- the banded pair counts are the +1..+W diagonals of G:
  counts[t*128+c, d-1, a1*2+a2] = G[t, c, c+d]; hi = both-qok product,
  lo = all-product minus hi.

Semantics are element-identical to the scatter pack whenever the merged
stream has unique (read, rank) pairs and alleles in {0, 1}; `build_tiles`
verifies both on host and returns None otherwise (caller falls back to the
scatter pack). Pairing in the stream-shift packers reduces to "all same-read
rank pairs with 1 <= d <= W" exactly under that uniqueness, which is what
the matmul computes.

Reference semantics covered: SubEdge::addSubEdge / VariantEdge accumulation
(PhasingGraph.cpp:25-70, 694-889).
"""

from __future__ import annotations

import numpy as np

TILE = 128


def _pow2(n: int, lo: int) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def build_tiles(m_read, m_rank, m_allele, m_qok, S_pad: int, window: int):
    """Host-side dense tile builder.

    Returns (bits uint8 [T, R_pad, L]) or None when the stream violates
    the uniqueness/allele-domain assumptions of the matmul formulation.
    T = S_pad // TILE, L = TILE + window.
    """
    No = len(m_read)
    if No == 0:
        return None
    if No > 1 and ((m_read[1:] == m_read[:-1])
                   & (m_rank[1:] == m_rank[:-1])).any():
        return None
    if m_allele.min(initial=0) < 0 or m_allele.max(initial=0) > 1:
        return None
    W = window
    L = TILE + W
    T = S_pad // TILE

    # read segments over the (read, rank)-sorted stream
    starts = np.flatnonzero(np.diff(m_read, prepend=-2) != 0)
    ends = np.append(starts[1:], No)
    r0 = m_rank[starts].astype(np.int64)
    r1 = m_rank[ends - 1].astype(np.int64)
    tile_lo = np.maximum((r0 - W) // TILE, 0)
    tile_hi = r1 // TILE
    nt = tile_hi - tile_lo + 1
    slot_start = np.concatenate(([0], np.cumsum(nt)))
    total_rows = int(slot_start[-1])

    # dense per-tile row index for each (read, tile) slot
    tile_of_row = np.repeat(tile_lo, nt) + (
        np.arange(total_rows) - np.repeat(slot_start[:-1], nt))
    rows_per_tile = np.bincount(tile_of_row, minlength=T)
    R_pad = _pow2(int(rows_per_tile.max(initial=1)), 8)
    order = np.argsort(tile_of_row, kind="stable")
    tile_starts = np.concatenate(([0], np.cumsum(rows_per_tile)))
    row_in_tile = np.empty(total_rows, np.int64)
    row_in_tile[order] = np.arange(total_rows) - tile_starts[
        tile_of_row[order]]

    # per-observation bits and targets
    seg = np.repeat(np.arange(len(starts)), ends - starts)
    rank = m_rank.astype(np.int64)
    bits = (1 + (m_allele.astype(np.uint8) << 1)
            + (m_qok.astype(np.uint8) << 2))
    t_own = rank // TILE
    slot_own = slot_start[seg] + (t_own - tile_lo[seg])
    idx_own = (t_own * R_pad + row_in_tile[slot_own]) * L + (rank % TILE)

    buf = np.zeros(T * R_pad * L, np.uint8)
    buf[idx_own] = bits
    # partner copy into the previous tile's extension columns
    prev = ((rank % TILE) < W) & (t_own > tile_lo[seg])
    if prev.any():
        t_prev = t_own[prev] - 1
        slot_prev = slot_start[seg[prev]] + (t_prev - tile_lo[seg[prev]])
        idx_prev = (t_prev * R_pad + row_in_tile[slot_prev]) * L + \
            (TILE + rank[prev] % TILE)
        buf[idx_prev] = bits[prev]
    return buf.reshape(T, R_pad, L)


def mxu_pair_counts(bits, window: int):
    """Device: [S_pad, W, 4] hi/lo pair-count planes from the bit tiles.
    Traced code (jnp); call inside a jit."""
    import jax
    import jax.numpy as jnp

    W = window
    T, R, L = bits.shape
    cov = (bits & 1).astype(jnp.int8)
    alt = ((bits >> 1) & 1).astype(jnp.int8)
    qok = ((bits >> 2) & 1).astype(jnp.int8)
    x = [(cov * (1 - alt)), (cov * alt)]          # allele == 0 / 1
    xq = [(x[0] * qok), (x[1] * qok)]

    def gram(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)

    # Band diagonals d = 1..W of each Gram matrix via the reshape-skew
    # trick: in the row-major flat view of g[t], element (c, c+d) sits at
    # offset c*L + c + d = c*(L+1) + d, so re-viewing the flat buffer with
    # row width L+1 turns the band into the contiguous column slice
    # [:, 1:W+1] without a gather. Fits for every W >= 1:
    # TILE*(L+1) <= L*L.
    def band(g):
        # g: [T, L, L] -> [T, TILE, W]
        flat = g.reshape(T, L * L)[:, :TILE * (L + 1)]
        return flat.reshape(T, TILE, L + 1)[:, :, 1:W + 1]

    combos = []
    for a1 in (0, 1):
        for a2 in (0, 1):
            g_all = band(gram(x[a1], x[a2]))
            g_hi = band(gram(xq[a1], xq[a2]))
            combos.append((g_hi, g_all - g_hi))
    # combos order: (a1,a2) = (0,0),(0,1),(1,0),(1,1) = combo index a1*2+a2
    hi = jnp.stack([c[0] for c in combos], axis=-1)   # [T, TILE, W, 4]
    lo = jnp.stack([c[1] for c in combos], axis=-1)
    S_pad = T * TILE
    return hi.reshape(S_pad, W, 4), lo.reshape(S_pad, W, 4)


def mxu_pc_counts(bits, window: int):
    """Device: x10-scaled (s_para, s_cross) [S_pad, W] i32 pair sums from
    the bit tiles with FOUR Gram matmuls instead of eight.

    For per-rank indicator rows a (allele 0) and b (allele 1):
      gram(a+b, a+b) = para + cross        (a+b = covered)
      gram(a-b, a-b) = para - cross
    so para = (gc + gd) / 2, cross = (gc - gd) / 2 — exactly, in integers
    (gc and gd have equal parity). With the quality-tier split
    (hi = both-qok, lo = rest) the vote-scan inputs are
      s_para10 = 10*para_hi + para_lo = (9*(gch + gdh) + gca + gda) / 2
      s_cross10 =                       (9*(gch - gdh) + gca - gda) / 2.
    Both scan engines (ops/vote_scan.vote_scan) consume only these two
    arrays, so the [S, W, 4] hi/lo combo planes (8 grams + 8 band
    extractions) are never built on this path. The products are exact in
    any precision: operands are in {-1, 0, 1} and int32 accumulates.
    Traced code (jnp); call inside a jit."""
    import jax
    import jax.numpy as jnp

    W = window
    T, R, L = bits.shape
    cov = (bits & 1).astype(jnp.int8)
    alt = ((bits >> 1) & 1).astype(jnp.int8)
    qok = ((bits >> 2) & 1).astype(jnp.int8)
    diff = cov * (1 - 2 * alt)       # a - b in {-1, 0, 1}
    covq = cov * qok
    diffq = diff * qok

    def gram(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)

    def band(g):
        flat = g.reshape(T, L * L)[:, :TILE * (L + 1)]
        return flat.reshape(T, TILE, L + 1)[:, :, 1:W + 1]

    gca = band(gram(cov, cov))
    gda = band(gram(diff, diff))
    gch = band(gram(covq, covq))
    gdh = band(gram(diffq, diffq))
    s_para10 = (9 * (gch + gdh) + gca + gda) // 2
    s_cross10 = (9 * (gch - gdh) + gca - gda) // 2
    S_pad = T * TILE
    return s_para10.reshape(S_pad, W), s_cross10.reshape(S_pad, W)


def host_read_correction_merged(ps, ori, vtype, m_rank, m_allele, m_aln,
                                A: int, read_confidence, snp_confidence):
    """Read correction over the merged stream (PhasingGraph.cpp:891-1029
    semantics) — float64 ratio compares exactly like the reference and the
    host packer path. The Gram path runs this on host so the observation
    stream never ships to the device. Dispatches to the native
    two-pass kernel (lps_ingest.cpp:lps_read_correction, ~6x the numpy
    mirror below, element-identical) when the library is available."""
    from .. import native
    nat = native.read_correction_merged(ps, ori, vtype, m_rank, m_allele,
                                        m_aln, A, read_confidence,
                                        snp_confidence)
    if nat is not None:
        return nat

    from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP, T_SV

    rank = m_rank.astype(np.int64)
    allele = m_allele.astype(np.int64)
    aln = m_aln.astype(np.int64)
    vt = vtype[rank]
    phased = ps[rank] != 0
    w10 = np.zeros(len(rank), np.int64)
    w10[(vt == T_SNP) | (vt == T_SV)] = 10
    w10[(vt == T_INDEL) | (vt == T_DANGER)] = 1
    w10[vt == T_MOD] = 0
    w10[~phased] = 0
    obs_hap = np.where(allele == 0, ori[rank], 1 - ori[rank]).astype(np.int64)
    # integer bincounts (weights force a float64 path that is ~3x slower):
    # weights are only ever 0/1/10, so count each weight class separately
    w10_is10 = w10 == 10
    w10_is1 = w10 == 1
    hap0 = obs_hap == 0
    ref10 = (10 * np.bincount(aln[w10_is10 & hap0], minlength=A)
             + np.bincount(aln[w10_is1 & hap0], minlength=A)).astype(np.int64)
    hap1 = ~hap0
    alt10 = (10 * np.bincount(aln[w10_is10 & hap1], minlength=A)
             + np.bincount(aln[w10_is1 & hap1], minlength=A)).astype(np.int64)
    total10 = ref10 + alt10
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(ref10, alt10) / total10
    confident = (total10 > 0) & (ratio > read_confidence) & (total10 > 10)
    belong = np.where(ref10 > alt10, 0, 1)

    S = len(ps)
    sel = confident[aln] & ((allele == 0) | (allele == 1))
    lin = (belong[aln][sel] * 2 + allele[sel]) * S + rank[sel]
    counts = np.bincount(lin, minlength=4 * S).reshape(4, S)
    result1 = counts[0] + counts[3]
    result2 = counts[2] + counts[1]
    total = result1 + result2
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.maximum(result1, result2) / total
    keep = (total > 0) & (conf > snp_confidence) & (result1 != result2)
    new_ps = np.where(keep, ps, 0)
    new_ori = np.where(result1 > result2, 0, 1).astype(np.int8)
    return new_ps, new_ori
