"""Haplotype vote scan: the ``lax.scan`` reference engine and the dispatch.

Device formulation of edgeConnectResult (PhasingGraph.cpp:286-474): a
``lax.scan`` over site ranks whose carry is a W-deep ring of pending vote
accumulators — the votes previous sites cast for the next W sites. All
arithmetic is exact decimal (weights x10 in int32), which matches the
reference's float accumulation everywhere except exact-tie corner cases
(documented in core/phase_algo.py; the float path is the host oracle).

Per step t (site rank t):
  1. consume slot 0 of the ring: h1/h2 vote totals + Onelongcase aggregates
     for site t,
  2. block logic: distance gap skip / already-connected skip / new block /
     haplotype assignment,
  3. cast votes to sites t+1..t+W from the banded pair counts
     (counts[t, d-1, combo]), with the reference's edge-similarity rejection,
     weight boosting (x20), danger-indel damping (x0.1), and MOD-SNP
     threshold override,
  4. shift the ring.

Outputs per site: assigned flag, haplotype (1|2), block-start rank.

On the GPU the same recurrence runs as one Pallas program per chromosome
(ops/scan_kernel.py). The ``lax.scan`` here is the CPU engine, the
reference that kernel is compared with, and the carry-chained form the
site-sharded mesh scan (parallel/sharded_scan.py) is built on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP

I32 = jnp.int32


def device_platform() -> str:
    """The platform of JAX's default device: 'gpu' or 'cpu'. Any other
    platform is an error, not a silent fallback."""
    platform = jax.devices()[0].platform
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: the device path runs on "
            "an NVIDIA GPU ('gpu') or, for tests, on the CPU ('cpu')")
    return platform


def scan_engine() -> str:
    """Vote-scan engine for the default device: the Pallas kernel
    (ops/scan_kernel.py) on the GPU, ``lax.scan`` on the CPU."""
    return "kernel" if device_platform() == "gpu" else "lax"


def init_scan_carry(window: int):
    """Zero carry: W-deep vote ring + last-connect/block-start ranks."""
    W = window
    return (jnp.zeros((W, 2), I32), jnp.zeros((W,), I32), jnp.zeros((W,), I32),
            jnp.zeros((W,), I32), jnp.asarray(-1, I32), jnp.asarray(-1, I32))


def pair_sums(counts_hi, counts_lo):
    """x10-scaled (parallel, cross) pair sums [..., W] from the banded
    combo counts [..., W, 4] (combo = a1*2+a2): the vote logic only ever
    consumes rr+aa and ra+ar."""
    c = counts_hi.astype(I32) * 10 + counts_lo.astype(I32)
    return c[..., 0] + c[..., 3], c[..., 1] + c[..., 2]


def vote_scan_core(counts_hi, counts_lo, gap, vtype, vtype_band, valid_band,
                   window: int, distance: int, edge_threshold_x10: float,
                   init_carry=None, t_offset=0, return_carry: bool = False):
    """Run the scan.

    Args:
      counts_hi/lo: int32[S, W, 4] banded pair counts (combo = a1*2+a2).
      gap: int32[S] position gap to the *next* site (huge for the last).
      vtype: int8[S] variant type per site.
      vtype_band: int8[S, W] variant type of site t+d (d=1..W).
      valid_band: bool[S, W] whether t+d < S.
      edge_threshold_x10: edge similarity threshold x10 (default 7.0).

    Returns:
      assigned: bool[S], hp: int32[S] (1|2), bstart: int32[S] (rank, -1 none).
    """
    s_para, s_cross = pair_sums(counts_hi, counts_lo)
    return vote_scan_pc(s_para, s_cross, gap, vtype, vtype_band, valid_band,
                        window=window, distance=distance,
                        edge_threshold_x10=edge_threshold_x10,
                        init_carry=init_carry, t_offset=t_offset,
                        return_carry=return_carry)


def vote_scan_pc(s_para10, s_cross10, gap, vtype, vtype_band, valid_band,
                 window: int, distance: int, edge_threshold_x10: float,
                 init_carry=None, t_offset=0, return_carry: bool = False):
    """vote_scan_core from the x10 pair sums [S, W] (see pair_sums)."""
    S, W = s_para10.shape
    d_idx = jnp.arange(W, dtype=I32)

    def step(carry, xs):
        (hpc, counter, wh1, wh2, last_connect, block_start) = carry
        (s_para, s_cross, g, vt, tvt, vmask, t) = xs

        # --- consume slot 0 -------------------------------------------------
        h1 = hpc[0, 0]
        h2 = hpc[0, 1]
        cnt = counter[0]
        oh1 = wh1[0]
        oh2 = wh2[0]
        use_special = (cnt > 3) & jnp.logical_not((oh1 == 0) & (oh2 == 0))
        H1 = jnp.where(use_special, oh1, h1)
        H2 = jnp.where(use_special, oh2, h2)

        skip_distance = g > distance
        eq = H1 == H2
        skip_connected = eq & (t < last_connect)
        new_block = eq & jnp.logical_not(skip_connected) & jnp.logical_not(skip_distance)
        assigned = jnp.logical_not(skip_distance) & jnp.logical_not(skip_connected)
        hp = jnp.where(eq, 1, jnp.where(H1 > H2, 1, 2)).astype(I32)
        block_start = jnp.where(new_block, t, block_start)
        bstart_out = jnp.where(assigned, block_start, -1)

        # --- cast votes (vectorized over d = 1..W) --------------------------
        total = s_para + s_cross
        mn = jnp.minimum(s_para, s_cross)
        mx = jnp.maximum(s_para, s_cross)
        # edge similarity rejection: esr > threshold  <=>  10*mn > thr10*mx
        # thresholds: default edge_threshold; 3.0 for SNP<->MOD pairs; -10
        # (always reject) for SNP<->MOD with total < 1
        modsnp = ((vt == T_SNP) & (tvt == T_MOD)) | ((vt == T_MOD) & (tvt == T_SNP))
        thr10 = jnp.where(modsnp,
                          jnp.where(total < 10, -10.0, 3.0),
                          edge_threshold_x10)
        esr_reject = (mx > 0) & (10.0 * mn.astype(jnp.float32)
                                 > thr10 * mx.astype(jnp.float32))

        decided = s_para != s_cross
        connect = decided & jnp.logical_not(esr_reject) & vmask & assigned

        big = ((10 * mn <= mx) & (total >= 10)) | \
              ((s_para < 10) & (s_cross >= 10)) | ((s_para >= 10) & (s_cross < 10))
        weight = jnp.where(big, 200, 10).astype(I32)
        weight = jnp.where(vt == T_DANGER, 1, weight)

        same = s_para > s_cross  # ref allele stays on same haplotype
        # mapped hap: hp==1 ? (same?1:2) : (same?2:1)
        mapped1 = jnp.where(hp == 1, same, jnp.logical_not(same))  # vote goes to hap1?

        add_h1 = jnp.where(connect & mapped1, weight, 0)
        add_h2 = jnp.where(connect & jnp.logical_not(mapped1), weight, 0)
        add_cnt = jnp.where(connect & (total <= 10), 1, 0).astype(I32)
        # Onelongcase aggregation (PhasingGraph.cpp:258-273): small-total
        # votes feed the counter ONLY (else-if), never the h1/h2 sums.
        eligible = (total > 10) & (5 * mn < mx) & (weight >= 10) & (vt != T_INDEL)
        add_w1 = jnp.where(connect & eligible & mapped1, weight, 0)
        add_w2 = jnp.where(connect & eligible & jnp.logical_not(mapped1), weight, 0)

        # last connect: largest connected target rank this step
        any_conn = jnp.any(connect)
        d_max = jnp.max(jnp.where(connect, d_idx + 1, 0))
        last_connect = jnp.where(any_conn, t + d_max, last_connect)

        # --- shift ring and add votes --------------------------------------
        zpad2 = jnp.zeros((1, 2), I32)
        zpad = jnp.zeros((1,), I32)
        hpc = jnp.concatenate([hpc[1:], zpad2]) + jnp.stack([add_h1, add_h2], axis=1)
        counter = jnp.concatenate([counter[1:], zpad]) + add_cnt
        wh1 = jnp.concatenate([wh1[1:], zpad]) + add_w1
        wh2 = jnp.concatenate([wh2[1:], zpad]) + add_w2

        return (hpc, counter, wh1, wh2, last_connect, block_start), \
            (assigned, hp, bstart_out)

    init = init_carry if init_carry is not None else init_scan_carry(W)
    xs = (s_para10, s_cross10, gap, vtype.astype(I32), vtype_band.astype(I32),
          valid_band, jnp.arange(S, dtype=I32) + t_offset)
    carry, (assigned, hp, bstart) = jax.lax.scan(step, init, xs)
    if return_carry:
        return carry, (assigned, hp, bstart)
    return assigned, hp, bstart


vote_scan_jax = jax.jit(
    vote_scan_core, static_argnames=("window", "distance", "edge_threshold_x10"))


def vote_scan(s_para10, s_cross10, gap, vtype, vtype_band, valid_band, *,
              window: int, distance: int, edge_threshold_x10: float,
              engine: str):
    """Traced scan dispatch over the x10 pair sums, [S, W] or a chromosome
    batch [B, S, W]. ``engine``: 'kernel' (ops/scan_kernel.py compiled for
    the GPU), 'lax' (vote_scan_pc), or 'interpret' (the kernel under the
    Pallas interpreter; tests only). Returns (assigned, hp, bstart)."""
    kw = dict(window=window, distance=distance,
              edge_threshold_x10=edge_threshold_x10)
    if engine in ("kernel", "interpret"):
        from .scan_kernel import vote_scan_kernel_pc

        return vote_scan_kernel_pc(s_para10, s_cross10, gap, vtype,
                                   vtype_band, valid_band,
                                   interpret=engine == "interpret", **kw)
    if engine != "lax":
        raise ValueError(f"unknown scan engine {engine!r}")
    if s_para10.ndim == 3:
        return jax.vmap(lambda *a: vote_scan_pc(*a, **kw))(
            s_para10, s_cross10, gap, vtype, vtype_band, valid_band)
    return vote_scan_pc(s_para10, s_cross10, gap, vtype, vtype_band,
                        valid_band, **kw)


def _vote_scan_packed(counts_hi16, counts_lo16, gap, vtype, vtype_band,
                      valid_band, window, distance, edge_threshold_x10,
                      engine):
    """Host-packed entry: counts travel as int16 (half the upload) and the
    three outputs come back as one stacked int32 array."""
    s_para, s_cross = pair_sums(counts_hi16, counts_lo16)
    assigned, hp, bstart = vote_scan(
        s_para, s_cross, gap, vtype, vtype_band, valid_band, window=window,
        distance=distance, edge_threshold_x10=edge_threshold_x10,
        engine=engine)
    return jnp.stack([assigned.astype(I32), hp, bstart])


vote_scan_packed_jax = jax.jit(
    _vote_scan_packed,
    static_argnames=("window", "distance", "edge_threshold_x10", "engine"))


def run_vote_scan(packed, params):
    """Host wrapper: prepare band metadata, run the jitted scan, and apply the
    reference's 'last site never processed' rule + block assembly.

    Returns (ps, ori): int64[S] phase-set value (0 = unphased) and int8[S]
    orientation (0: ref on hap1) matching vote_scan + block assembly of the
    oracle (PhasingGraph.cpp:423-467).
    """
    S = len(packed.positions)
    W = packed.window
    if S == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int8)

    # pad the site axis to a bucket size so XLA compiles once per bucket, not
    # once per chromosome; padded steps are inert (huge gap -> distance skip,
    # no valid targets)
    Sp = max(256, 1 << int(np.ceil(np.log2(S))))
    gap = np.full(Sp, np.iinfo(np.int32).max, dtype=np.int32)
    if S > 1:
        gap[:S - 1] = np.minimum(np.diff(packed.positions),
                                 np.iinfo(np.int32).max).astype(np.int32)
    # band lookups
    ranks = np.arange(S)
    tgt = ranks[:, None] + np.arange(1, W + 1)[None, :]
    valid_band = np.zeros((Sp, W), dtype=bool)
    valid_band[:S] = tgt < S
    vtype_band = np.zeros((Sp, W), dtype=np.int8)
    vtype_band[:S] = np.where(tgt < S, packed.vtype[np.minimum(tgt, S - 1)], 0)
    counts_hi = np.zeros((Sp, W, 4), dtype=np.int16)
    np.clip(packed.counts_hi, 0, 32767, out=counts_hi[:S])
    counts_lo = np.zeros((Sp, W, 4), dtype=np.int16)
    np.clip(packed.counts_lo, 0, 32767, out=counts_lo[:S])
    vtype = np.zeros(Sp, dtype=np.int8)
    vtype[:S] = packed.vtype

    out = np.array(vote_scan_packed_jax(
        jnp.asarray(counts_hi), jnp.asarray(counts_lo),
        jnp.asarray(gap), jnp.asarray(vtype),
        jnp.asarray(vtype_band), jnp.asarray(valid_band),
        window=W, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0,
        engine=scan_engine()))
    assigned = out[0, :S].astype(bool)
    hp = out[1, :S]
    bstart = out[2, :S]
    return assemble_blocks(packed.positions, assigned, hp, bstart)


def assemble_blocks(positions, assigned, hp, bstart):
    """Block assembly from raw scan outputs (PhasingGraph.cpp:423-467),
    including the reference's "last site never processed" rule."""
    S = len(positions)
    assigned = assigned.copy()
    assigned[S - 1] = False
    ps = np.zeros(S, dtype=np.int64)
    ori = np.zeros(S, dtype=np.int8)
    members = np.nonzero(assigned)[0]
    if len(members) == 0:
        return ps, ori
    mb = bstart[members]
    # contiguous runs with the same block start
    run_breaks = np.nonzero(np.diff(mb) != 0)[0] + 1
    run_starts = np.concatenate([[0], run_breaks])
    run_ends = np.concatenate([run_breaks, [len(members)]])
    for rs, re in zip(run_starts, run_ends):
        if re - rs <= 1:
            continue
        idx = members[rs:re]
        block_ps = positions[mb[rs]] + 1
        ps[idx] = block_ps
        flips = (hp[idx][1:] != hp[idx][:-1]).astype(np.int8)
        o = np.concatenate([[0], np.cumsum(flips) % 2]).astype(np.int8)
        ori[idx] = o
    return ps, ori
