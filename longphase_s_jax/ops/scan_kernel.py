"""Haplotype vote scan as one GPU program per chromosome (Pallas, Triton).

The scan (edgeConnectResult, PhasingGraph.cpp:286-474) is a true sequential
recurrence over site ranks, so ``lax.scan`` (ops/vote_scan.vote_scan_core)
compiles to a device while-loop that pays at least one kernel launch per
site. Here one program walks all sites of its chromosome in a loop; a grid
axis over the chromosome batch lets the single-chromosome call and the
mesh's per-device batch (parallel/multichip.py) share the kernel.

Only the *direction* of each cast vote depends on the carry (the site's
haplotype decision); edge-similarity rejection, vote weights, Onelongcase
eligibility and the small-total counter are carry-independent. They are
computed in bulk by XLA (``kernel_inputs``) into three int32 planes per
site, laid out in ring-slot coordinates:

  p[t, j]: votes   (h1 << 16) | h2 cast to the site in slot j if t decides
           hp == 1 (the hp == 2 image is the 16-bit field swap)
  q[t, j]: special (oh1 << 16) | oh2, same convention
  c[t, j]: small-total counter increment (independent of hp)

Slot j holds the pending votes of site rank t' with t' mod R == j, where
the ring size R is a power of two above the window (64 for the default
W = 35). Site t reads its totals from slot t mod R with a masked
reduction, clears it, and adds its own casts (which never touch that
slot, since 1 <= d <= W < R): circular indexing in place of a ring shift.
The ring stays in registers as three R-vectors; the next site's planes
are loaded one step ahead, so the loop's critical path is the reduction
and ~20 scalar ops.

Numerics are the exact x10 integer arithmetic of vote_scan_core; the
f32 edge-similarity compare only ever sees products of small integers,
which f32 represents exactly, so results are equal, not close.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.phase_algo import T_DANGER, T_INDEL, T_MOD, T_SNP

I32 = jnp.int32

# each 16-bit ring field sums at most W casts of weight <= 200 (x10 scale)
MAX_WINDOW = (1 << 16) // 200 - 1


def ring_size(window: int) -> int:
    """Ring length: the next power of two above the window, at least 64."""
    return max(64, 1 << window.bit_length())


def check_window(window: int) -> None:
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(
            f"connectAdjacent={window} is outside the GPU vote-scan kernel's "
            f"range 1..{MAX_WINDOW} (16-bit packed vote fields)")


def kernel_inputs(s_para, s_cross, gap, vtype, vtype_band, valid_band,
                  distance: int, edge_threshold_x10: float):
    """Carry-independent kernel inputs from the x10 parallel/cross pair sums
    [..., S, W] i32. Returns (p, q, c) [..., S, R] i32 planes in ring-slot
    coordinates and sdm [..., S] i32 = (dmax << 1) | (gap > distance),
    where dmax is the largest offset d this site would connect to."""
    S, W = s_para.shape[-2:]
    R = ring_size(W)
    total = s_para + s_cross
    mn = jnp.minimum(s_para, s_cross)
    mx = jnp.maximum(s_para, s_cross)

    vt = vtype.astype(I32)[..., None]
    tvt = vtype_band.astype(I32)
    modsnp = ((vt == T_SNP) & (tvt == T_MOD)) | ((vt == T_MOD) & (tvt == T_SNP))
    thr10 = jnp.where(modsnp, jnp.where(total < 10, -10.0, 3.0),
                      edge_threshold_x10)
    esr_reject = (mx > 0) & (10.0 * mn.astype(jnp.float32)
                             > thr10 * mx.astype(jnp.float32))
    conn_ok = (s_para != s_cross) & jnp.logical_not(esr_reject) & valid_band

    big = ((10 * mn <= mx) & (total >= 10)) | \
          ((s_para < 10) & (s_cross >= 10)) | ((s_para >= 10) & (s_cross < 10))
    weight = jnp.where(vt == T_DANGER, 1, jnp.where(big, 200, 10)).astype(I32)
    elig = conn_ok & (total > 10) & (5 * mn < mx) & (weight >= 10) & \
        (vt != T_INDEL)
    same = s_para > s_cross
    w_conn = jnp.where(conn_ok, weight, 0)
    w_elig = jnp.where(elig, weight, 0)
    p = jnp.where(same, w_conn << 16, w_conn)
    q = jnp.where(same, w_elig << 16, w_elig)
    c = (conn_ok & (total <= 10)).astype(I32)

    # offset d = k + 1 of band column k lands in slot (t + d) mod R, so
    # slot j of site t reads column (j - t - 1) mod R; columns >= W are 0
    t = jnp.arange(S, dtype=I32)[:, None]
    col = (jnp.arange(R, dtype=I32)[None, :] - t - 1) & (R - 1)
    col = jnp.broadcast_to(col, (*s_para.shape[:-2], S, R))
    pad = [(0, 0)] * (s_para.ndim - 1) + [(0, R - W)]

    def to_slots(x):
        return jnp.take_along_axis(jnp.pad(x, pad), col, axis=-1)

    d = jnp.arange(1, W + 1, dtype=I32)
    dmax = jnp.max(jnp.where(conn_ok, d, 0), axis=-1)
    sdm = (dmax << 1) | (gap > distance).astype(I32)
    return to_slots(p), to_slots(q), to_slots(c), sdm


def _swap16(x):
    return (x << 16) | jax.lax.shift_right_logical(x, 16)


def _scan_kernel(p_ref, q_ref, c_ref, sdm_ref, out_ref, *, S: int, R: int):
    """One chromosome per program. out[t] = (bstart + 1) * 8 + hp * 2 +
    assigned."""
    from jax.experimental import pallas as pl

    b = pl.program_id(0)
    slot = jax.lax.broadcasted_iota(I32, (R,), 0)

    def load(t):
        return p_ref[b, t, :], q_ref[b, t, :], c_ref[b, t, :], sdm_ref[b, t]

    def step(t, carry):
        votes, spec, cnt_ring, last_connect, block_start, nxt = carry
        p, q, c, sdm = nxt
        nxt = load(jnp.minimum(t + 1, S - 1))

        here = slot == (t & (R - 1))
        v = jnp.sum(jnp.where(here, votes, 0))
        o = jnp.sum(jnp.where(here, spec, 0))
        cnt = jnp.sum(jnp.where(here, cnt_ring, 0))
        h1 = jax.lax.shift_right_logical(v, 16)
        h2 = v & 0xFFFF
        oh1 = jax.lax.shift_right_logical(o, 16)
        oh2 = o & 0xFFFF
        use_special = (cnt > 3) & jnp.logical_not((oh1 == 0) & (oh2 == 0))
        H1 = jnp.where(use_special, oh1, h1)
        H2 = jnp.where(use_special, oh2, h2)

        skip_distance = (sdm & 1) == 1
        eq = H1 == H2
        skip_connected = eq & (t < last_connect)
        assigned = jnp.logical_not(skip_distance) & \
            jnp.logical_not(skip_connected)
        new_block = eq & assigned
        hp = 2 - (eq | (H1 > H2)).astype(I32)
        block_start = jnp.where(new_block, t, block_start)
        dmax = jax.lax.shift_right_logical(sdm, 1)
        last_connect = jnp.where(assigned & (dmax > 0), t + dmax,
                                 last_connect)
        ai = assigned.astype(I32)
        out_ref[b, t] = (jnp.where(assigned, block_start, -1) + 1) * 8 + \
            hp * 2 + ai

        one = hp == 1
        votes = jnp.where(here, 0, votes) + \
            jnp.where(one, p, _swap16(p)) * ai
        spec = jnp.where(here, 0, spec) + jnp.where(one, q, _swap16(q)) * ai
        cnt_ring = jnp.where(here, 0, cnt_ring) + c * ai
        return votes, spec, cnt_ring, last_connect, block_start, nxt

    zero = jnp.zeros((R,), I32)
    jax.lax.fori_loop(0, S, step,
                      (zero, zero, zero, jnp.int32(-1), jnp.int32(-1),
                       load(0)))


def scan_from_inputs(p, q, c, sdm, interpret: bool = False):
    """Run the kernel over a [B, S, R] batch; returns packed out [B, S]."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    B, S, R = p.shape
    return pl.pallas_call(
        partial(_scan_kernel, S=S, R=R),
        out_shape=jax.ShapeDtypeStruct((B, S), I32),
        grid=(B,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="vote_scan",
    )(p, q, c, sdm)


def unpack(out):
    """Packed kernel output -> (assigned bool, hp i32, bstart i32)."""
    return (out & 1).astype(bool), (out >> 1) & 3, (out >> 3) - 1


def vote_scan_kernel_pc(s_para10, s_cross10, gap, vtype, vtype_band,
                        valid_band, window: int, distance: int,
                        edge_threshold_x10: float, interpret: bool = False):
    """Kernel engine from the x10 pair sums [S, W] or a batch [B, S, W];
    returns (assigned, hp, bstart) shaped like ``gap``."""
    check_window(window)
    batched = s_para10.ndim == 3
    p, q, c, sdm = kernel_inputs(s_para10, s_cross10, gap.astype(I32), vtype,
                                 vtype_band, valid_band, distance,
                                 edge_threshold_x10)
    if not batched:
        p, q, c, sdm = p[None], q[None], c[None], sdm[None]
    out = scan_from_inputs(p, q, c, sdm, interpret=interpret)
    return unpack(out if batched else out[0])
