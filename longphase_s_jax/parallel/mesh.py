"""Multi-chip execution: genome data parallelism over a device mesh.

The reference's only coarse parallelism is an OpenMP parallel-for over
chromosomes (PhasingProcess.cpp:113); the device equivalent shards a
batch of packed chromosome blocks across a 1-D ``jax.sharding.Mesh`` and runs
the vote-scan kernel per shard, with XLA collectives (psum) merging global
statistics. Position-block sharding with banded halo exchange along the site
axis is the planned second axis (SURVEY.md §2.6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.vote_scan import vote_scan_core

CHROM_AXIS = "chrom"


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        # under jax.distributed each process phases a DIFFERENT contig
        # shard, so the per-process mesh must be local-only — a global mesh
        # would make the processes trace divergent collectives and deadlock
        devices = (jax.local_devices() if jax.process_count() > 1
                   else jax.devices())
    return Mesh(np.array(devices), (CHROM_AXIS,))


def batched_vote_scan(counts_hi, counts_lo, gap, vtype, vtype_band, valid_band,
                      window: int, distance: int, edge_threshold_x10: float):
    """vmapped scan over a [B, S, ...] batch of chromosome blocks, plus a
    psum-style global reduction (total assigned sites) that exercises the
    collective path when sharded."""
    assigned, hp, bstart = jax.vmap(
        lambda ch, cl, g, vt, vtb, vb: vote_scan_core(
            ch, cl, g, vt, vtb, vb, window=window, distance=distance,
            edge_threshold_x10=edge_threshold_x10)
    )(counts_hi, counts_lo, gap, vtype, vtype_band, valid_band)
    total_assigned = jnp.sum(assigned.astype(jnp.int32))
    return assigned, hp, bstart, total_assigned


def make_sharded_phase_step(mesh: Mesh, window: int, distance: int,
                            edge_threshold_x10: float):
    """jit the batched scan with the batch axis sharded across the mesh."""
    batch3 = NamedSharding(mesh, P(CHROM_AXIS, None, None))
    batch2 = NamedSharding(mesh, P(CHROM_AXIS, None))
    replicated = NamedSharding(mesh, P())

    fn = jax.jit(
        lambda ch, cl, g, vt, vtb, vb: batched_vote_scan(
            ch, cl, g, vt, vtb, vb, window=window, distance=distance,
            edge_threshold_x10=edge_threshold_x10),
        in_shardings=(batch3, batch3, batch2, batch2, batch2, batch2),
        out_shardings=(batch2, batch2, batch2, replicated),
    )
    return fn
