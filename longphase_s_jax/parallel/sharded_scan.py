"""Site-axis sharded vote scan: sequential-dependency pipeline over a device
mesh.

The vote scan is a true sequential dependency along the site axis (votes flow
forward through a W-site band). Sharding the axis over N devices turns it
into a carry chain: shard k scans its block starting from shard k-1's final
carry (the W-deep vote ring + last-connect/block-start ranks), passed to
the next device with ``lax.ppermute``.

Two schedules:

- ``sharded_vote_scan`` — ONE chromosome across the mesh. All shards step
  through N rounds; in round j only shard j's output is kept (the redundant
  compute keeps the program SPMD-uniform; with a single carry chain there is
  no independent work to overlap).
- ``wavefront_vote_scan`` — C chromosomes across the mesh, pipelined: at
  global round r device k scans block k of chromosome r-k, so after an
  N-1-round ramp-up every device does useful work each round (C+N-1 rounds
  total vs C*N for the naive schedule). Device 0 starts a fresh carry each
  round; every other device consumes the carry ppermuted from its left
  neighbour — which is exactly the same chromosome one block earlier.
  This is the production schedule for the few-giant-chromosomes regime:
  ``run_phase`` routes deferred chromosomes through
  ``parallel.multichip.run_fused_phase_wavefront`` whenever fewer
  chromosomes than devices are in flight (LPS_WAVEFRONT=1/0 overrides).

The band inputs are "self-haloed": counts[t], vtype_band[t] and valid_band[t]
describe targets t+1..t+W regardless of which shard owns them, so only the
scan carry crosses shard boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.vote_scan import init_scan_carry, vote_scan_core

SITE_AXIS = "site"


def make_site_mesh(devices=None) -> Mesh:
    if devices is None:
        # under jax.distributed each process scans a DIFFERENT contig shard,
        # so the site mesh must be local-only (same rule as mesh.make_mesh):
        # a global mesh would span non-addressable devices and the two
        # processes — holding different contig batches, hence different
        # padded shapes — would launch divergent global programs and
        # deadlock in the collectives
        devices = (jax.local_devices() if jax.process_count() > 1
                   else jax.devices())
    return Mesh(np.array(devices), (SITE_AXIS,))


def sharded_vote_scan(mesh: Mesh, counts_hi, counts_lo, gap, vtype,
                      vtype_band, valid_band, window: int, distance: int,
                      edge_threshold_x10: float):
    """Run the scan with the site axis sharded across ``mesh``.

    S must be divisible by the mesh size. Returns (assigned, hp, bstart)
    identical to the single-device scan.
    """
    n = mesh.devices.size
    S = counts_hi.shape[0]
    assert S % n == 0, (S, n)
    block = S // n

    def local_fn(c_hi, c_lo, g, vt, vtb, vb):
        my = jax.lax.axis_index(SITE_AXIS)
        t0 = my * block
        # mark the zero carry as device-varying so the scan carry types match
        carry = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (SITE_AXIS,), to="varying"),
            init_scan_carry(window))

        def round_body(j, state):
            carry_in, outs = state
            new_carry, (a, h, b) = vote_scan_core(
                c_hi, c_lo, g, vt, vtb, vb,
                window=window, distance=distance,
                edge_threshold_x10=edge_threshold_x10,
                init_carry=carry_in, t_offset=t0, return_carry=True)
            mine = my == j
            outs = (jnp.where(mine, a, outs[0]),
                    jnp.where(mine, h, outs[1]),
                    jnp.where(mine, b, outs[2]))
            # pass my final carry to the next shard; shards > j keep waiting
            passed = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(
                    x, SITE_AXIS, [(k, (k + 1) % n) for k in range(n)]),
                new_carry)
            carry_next = jax.tree_util.tree_map(
                lambda old, new: jnp.where(my == j + 1, new, old),
                carry_in, passed)
            return carry_next, outs

        outs0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (SITE_AXIS,), to="varying"),
            (jnp.zeros(block, bool), jnp.zeros(block, jnp.int32),
             jnp.zeros(block, jnp.int32)))
        _, outs = jax.lax.fori_loop(0, n, round_body, (carry, outs0))
        return outs

    spec = P(SITE_AXIS)
    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(SITE_AXIS, None, None), P(SITE_AXIS, None, None),
                  spec, spec, P(SITE_AXIS, None), P(SITE_AXIS, None)),
        out_specs=(spec, spec, spec))
    # reshape to [n, block, ...] blocks: shard_map slices the leading axis
    return jax.jit(fn)(counts_hi, counts_lo, gap, vtype.astype(jnp.int32),
                       vtype_band.astype(jnp.int32), valid_band)


def wavefront_vote_scan(mesh: Mesh, counts_hi, counts_lo, gap, vtype,
                        vtype_band, valid_band, window: int, distance: int,
                        edge_threshold_x10: float):
    """Pipelined site-sharded scan over C stacked chromosomes.

    Inputs carry a leading chromosome axis [C, S, ...]; the site axis S is
    sharded over ``mesh`` and the C carry chains wavefront across devices
    (device k works on chromosome r-k at round r). Returns (assigned, hp,
    bstart) shaped [C, S], identical to per-chromosome single-device scans.
    """
    n = mesh.devices.size
    C, S = counts_hi.shape[0], counts_hi.shape[1]
    assert S % n == 0, (S, n)
    block = S // n

    def local_fn(c_hi, c_lo, g, vt, vtb, vb):
        my = jax.lax.axis_index(SITE_AXIS)
        t0 = my * block

        def pvary(x):
            return jax.tree_util.tree_map(
                lambda a: jax.lax.pcast(a, (SITE_AXIS,), to="varying"), x)

        def round_body(r, state):
            carry_in, outs = state
            chrom = r - my
            c_idx = jnp.clip(chrom, 0, C - 1)
            args = [jnp.take(a, c_idx, axis=0)
                    for a in (c_hi, c_lo, g, vt, vtb, vb)]
            fresh = pvary(init_scan_carry(window))
            carry_use = jax.tree_util.tree_map(
                lambda f, c: jnp.where(my == 0, f, c), fresh, carry_in)
            new_carry, (a, h, b) = vote_scan_core(
                *args, window=window, distance=distance,
                edge_threshold_x10=edge_threshold_x10,
                init_carry=carry_use, t_offset=t0, return_carry=True)
            valid = (chrom >= 0) & (chrom < C)
            oa, oh, ob = outs
            oa = oa.at[c_idx].set(jnp.where(valid, a, oa[c_idx]))
            oh = oh.at[c_idx].set(jnp.where(valid, h, oh[c_idx]))
            ob = ob.at[c_idx].set(jnp.where(valid, b, ob[c_idx]))
            passed = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(
                    x, SITE_AXIS, [(k, (k + 1) % n) for k in range(n)]),
                new_carry)
            return passed, (oa, oh, ob)

        outs0 = pvary((jnp.zeros((C, block), bool),
                       jnp.zeros((C, block), jnp.int32),
                       jnp.zeros((C, block), jnp.int32)))
        _, outs = jax.lax.fori_loop(0, C + n - 1, round_body,
                                    (pvary(init_scan_carry(window)), outs0))
        return outs

    spec = P(None, SITE_AXIS)
    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, SITE_AXIS, None, None),
                  P(None, SITE_AXIS, None, None),
                  spec, spec, P(None, SITE_AXIS, None),
                  P(None, SITE_AXIS, None)),
        out_specs=(spec, spec, spec))
    return jax.jit(fn)(counts_hi, counts_lo, gap, vtype.astype(jnp.int32),
                       vtype_band.astype(jnp.int32), valid_band)
