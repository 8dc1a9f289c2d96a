"""Production multi-chip phase execution: chromosome data parallelism.

The reference's only coarse-grain scaling axis is an OpenMP parallel-for
over contigs (PhasingProcess.cpp:113). The device analog batches the
per-chromosome fused phase tensors (ops/fused.py: device pair-pack -> vote
scan -> block assembly -> read correction) to a common padded shape, shards
the batch axis over a 1-D ``jax.sharding.Mesh``, and runs the whole pipeline
under one jit: each device runs its local chromosomes through one batched
scan (the kernel's grid axis), and a ``psum`` across the mesh merges the
global assigned-site statistic. The mesh assumes no topology; NVLink joins
every card to every other at the same rate.

run_phase engages this path automatically when more than one device is
visible (models/phase.py); tests/test_multichip_phase.py proves VCF
equality against the single-device pipeline on the 8-device CPU mesh, and
__graft_entry__.dryrun_multichip drives the same path end-to-end.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import CHROM_AXIS, make_mesh

I32 = jnp.int32
INT32_MAX = np.iinfo(np.int32).max


_FN_CACHE: dict = {}


def make_multichip_phase_fn(mesh, S_pad, No_pad, A_pad, window, distance,
                            edge_threshold_x10, read_confidence,
                            snp_confidence, engine):
    """jit a sharded batched phase step: [B, ...] batch sharded over the
    chrom axis; per shard, the pair pack and the assembly/read-correction
    tail sweep the local chromosomes with lax.map around ONE batched scan
    (the kernel's grid runs the local chromosomes side by side), and a
    psum merges the global assigned-site statistic."""
    key = (id(mesh), S_pad, No_pad, A_pad, window, distance,
           edge_threshold_x10, read_confidence, snp_confidence, engine)
    if key in _FN_CACHE:
        return _FN_CACHE[key]

    from ..ops.fused import (device_assemble_blocks, device_pair_counts,
                             device_read_correction)
    from ..ops.vote_scan import pair_sums, vote_scan

    def pack(a):
        return pair_sums(*device_pair_counts(*a, S_pad, window))

    def tail(a):
        assigned, hp, bstart, positions, s_live, vtype, m_rank, m_allele, \
            m_aln = a
        ps, ori = device_assemble_blocks(assigned, hp.astype(I32),
                                         bstart.astype(I32), positions,
                                         s_live)
        new_ps, new_ori = device_read_correction(
            ps, ori, vtype, m_rank, m_allele, m_aln, A_pad,
            read_confidence, snp_confidence)
        return jnp.stack([new_ps, new_ori.astype(I32)])

    def local_sweep(m_read, m_rank, m_allele, m_qok, m_aln, gap, vtype,
                    vtype_band, valid_band, positions, s_live):
        s_para, s_cross = jax.lax.map(pack, (m_read, m_rank, m_allele, m_qok))
        assigned, hp, bstart = vote_scan(
            s_para, s_cross, gap, vtype, vtype_band, valid_band,
            window=window, distance=distance,
            edge_threshold_x10=edge_threshold_x10, engine=engine)
        out = jax.lax.map(tail, (assigned, hp, bstart, positions, s_live,
                                 vtype, m_rank, m_allele, m_aln))
        total = jax.lax.psum(jnp.sum((out[:, 0, :] != 0).astype(I32)),
                             CHROM_AXIS)
        return out, total

    b1 = P(CHROM_AXIS)
    b2 = P(CHROM_AXIS, None)
    fn = jax.jit(jax.shard_map(
        local_sweep, mesh=mesh,
        in_specs=(b2, b2, b2, b2, b2, b2, b2,
                  P(CHROM_AXIS, None, None), P(CHROM_AXIS, None, None),
                  b2, b1),
        out_specs=(P(CHROM_AXIS, None, None), P()),
        check_vma=False))
    _FN_CACHE[key] = fn
    return fn


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _batch_entries(entries, window, B=None):
    """Pad prepared chromosome entries to a common [B, ...] shape; rows past
    the entries (B > len(entries) rounds the batch up to the mesh) hold
    inert filler chromosomes."""
    W = window
    S_pad = _pow2(max(len(e["positions"]) for e in entries), 256)
    No_pad = _pow2(max(len(e["m_read"]) for e in entries), 1024)
    A_pad = _pow2(max(e["n_aln"] for e in entries), 256)
    B = len(entries) if B is None else B

    m_read = np.full((B, No_pad), -1, np.int32)
    m_rank = np.zeros((B, No_pad), np.int32)
    m_allele = np.zeros((B, No_pad), np.int8)
    m_qok = np.zeros((B, No_pad), bool)
    m_aln = np.full((B, No_pad), -1, np.int32)
    gap = np.full((B, S_pad), INT32_MAX, np.int32)
    vtype = np.zeros((B, S_pad), np.int8)
    vtype_band = np.zeros((B, S_pad, W), np.int8)
    valid_band = np.zeros((B, S_pad, W), bool)
    positions = np.zeros((B, S_pad), np.int32)
    s_live = np.zeros(B, np.int32)

    for b, e in enumerate(entries):
        S = len(e["positions"])
        No = len(e["m_read"])
        m_read[b, :No] = e["m_read"]
        m_rank[b, :No] = e["m_rank"]
        m_allele[b, :No] = e["m_allele"]
        m_qok[b, :No] = e["m_qok"]
        m_aln[b, :No] = e["m_aln"]
        if S > 1:
            gap[b, :S - 1] = np.minimum(np.diff(e["positions"]),
                                        INT32_MAX).astype(np.int32)
        vtype[b, :S] = e["vtype"]
        tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
        valid_band[b, :S] = tgt < S
        vtype_band[b, :S] = np.where(
            tgt < S, np.asarray(e["vtype"])[np.minimum(tgt, S - 1)], 0)
        positions[b, :S] = e["positions"]
        s_live[b] = S
    return dict(m_read=m_read, m_rank=m_rank, m_allele=m_allele, m_qok=m_qok,
                m_aln=m_aln, gap=gap, vtype=vtype, vtype_band=vtype_band,
                valid_band=valid_band, positions=positions, s_live=s_live,
                S_pad=S_pad, No_pad=No_pad, A_pad=A_pad)


def run_fused_phase_wavefront(entries, params, mesh=None):
    """Site-axis-sharded production phase: the few-giant-chromosomes regime.

    When chromosomes are FEWER than devices, the chromosome-batch mesh
    leaves devices idle; here the site axis of every chromosome is sharded
    over the mesh and the C sequential carry chains wavefront-pipeline
    across devices (parallel/sharded_scan.wavefront_vote_scan — device k
    scans block k of chromosome r-k at round r, so after an N-1-round
    ramp-up every device does useful work each round). Pair packing and the
    assembly/read-correction tail run as batched device programs around the
    sharded scan. Results are identical to the single-device fused path.

    The device analog of the reference's contig OpenMP loop
    (PhasingProcess.cpp:113) for workloads the loop cannot scale: fewer
    contigs than compute units.
    """
    from ..ops.fused import (device_assemble_blocks, device_pair_counts,
                             device_read_correction)
    from .sharded_scan import make_site_mesh, wavefront_vote_scan

    site_mesh = mesh if mesh is not None else make_site_mesh()
    W = params.connect_adjacent
    b = _batch_entries(entries, W)
    S_pad, A_pad = b["S_pad"], b["A_pad"]
    n = int(site_mesh.devices.size)
    if S_pad % n:  # S_pad is a pow2 >= 256; non-pow2 meshes fall back
        raise ValueError(f"site axis {S_pad} not divisible by mesh {n}")

    @jax.jit
    def pack(m_read, m_rank, m_allele, m_qok):
        return jax.lax.map(
            lambda a: device_pair_counts(*a, S_pad, W),
            (m_read, m_rank, m_allele, m_qok))

    counts_hi, counts_lo = pack(b["m_read"], b["m_rank"], b["m_allele"],
                                b["m_qok"])

    assigned, hp, bstart = wavefront_vote_scan(
        site_mesh, counts_hi, counts_lo, b["gap"], b["vtype"],
        b["vtype_band"], b["valid_band"], window=W, distance=params.distance,
        edge_threshold_x10=float(params.edge_threshold) * 10.0)

    rc, sc = float(params.read_confidence), float(params.snp_confidence)

    @jax.jit
    def tail(assigned, hp, bstart, positions, s_live, vtype, m_rank,
             m_allele, m_aln):
        def one(a):
            asg, h, bs, pos, s, vt, mr, ma, mal = a
            ps, ori = device_assemble_blocks(asg.astype(bool), h.astype(I32),
                                             bs.astype(I32), pos, s)
            new_ps, new_ori = device_read_correction(
                ps, ori, vt, mr, ma, mal, A_pad, rc, sc)
            return jnp.stack([new_ps, new_ori.astype(I32)])

        return jax.lax.map(one, (assigned, hp, bstart, positions, s_live,
                                 vtype, m_rank, m_allele, m_aln))

    out = np.asarray(tail(assigned, hp, bstart, b["positions"], b["s_live"],
                          b["vtype"], b["m_rank"], b["m_allele"], b["m_aln"]))
    results = []
    for i, e in enumerate(entries):
        S = len(e["positions"])
        results.append((out[i, 0, :S].astype(np.int64),
                        out[i, 1, :S].astype(np.int8)))
    return results


def run_fused_phase_multichip(entries, params, engine: str, mesh=None):
    """Batched multi-device fused phase over prepared chromosome entries.

    Each entry is a dict with the merged observation stream
    (m_read/m_rank/m_allele/m_qok/m_aln), positions, vtype, n_aln (see
    core/fastpath.merge_observations). Returns a list of (ps, ori) numpy
    array pairs, one per entry, each truncated to that entry's S.
    """
    mesh = mesh if mesh is not None else make_mesh()
    D = int(mesh.devices.size)
    W = params.connect_adjacent
    B = -(-len(entries) // D) * D  # round up to a multiple of the mesh
    b = _batch_entries(entries, W, B)

    fn = make_multichip_phase_fn(
        mesh, b["S_pad"], b["No_pad"], b["A_pad"], W, params.distance,
        float(params.edge_threshold) * 10.0, float(params.read_confidence),
        float(params.snp_confidence), engine)

    def put(name, spec):
        return jax.device_put(b[name], NamedSharding(mesh, spec))

    b1, b2, b3 = P(CHROM_AXIS), P(CHROM_AXIS, None), P(CHROM_AXIS, None, None)
    out, _total = fn(put("m_read", b2), put("m_rank", b2),
                     put("m_allele", b2), put("m_qok", b2), put("m_aln", b2),
                     put("gap", b2), put("vtype", b2), put("vtype_band", b3),
                     put("valid_band", b3), put("positions", b2),
                     put("s_live", b1))
    out = np.asarray(out)
    results = []
    for i, e in enumerate(entries):
        S = len(e["positions"])
        results.append((out[i, 0, :S].astype(np.int64),
                        out[i, 1, :S].astype(np.int8)))
    return results
