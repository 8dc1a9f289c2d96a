"""Site-axis sharded scan over the virtual 8-device CPU mesh must reproduce
the single-device scan exactly (carry chain over ppermute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longphase_s_jax.ops.vote_scan import vote_scan_jax
from longphase_s_jax.parallel.sharded_scan import (make_site_mesh,
                                                   sharded_vote_scan)


@pytest.mark.parametrize("seed,S", [(0, 1024), (1, 2048)])
def test_sharded_scan_matches_single(seed, S):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    W = 35
    rng = np.random.default_rng(seed)
    ch = rng.integers(0, 15, size=(S, W, 4)).astype(np.int32)
    # sparsify so ties/blocks occur
    ch[rng.random(ch.shape) < 0.8] = 0
    cl = rng.integers(0, 2, size=(S, W, 4)).astype(np.int32)
    cl[rng.random(cl.shape) < 0.9] = 0
    gap = rng.integers(50, 4000, size=S).astype(np.int32)
    gap[rng.random(S) < 0.02] = 10 ** 6  # distance gaps
    vt = rng.choice([0, 0, 0, 3, 4], size=S).astype(np.int8)
    tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
    vb = tgt < S
    vtb = np.where(vb, vt[np.minimum(tgt, S - 1)], 0).astype(np.int8)

    args = [jnp.asarray(x) for x in (ch, cl, gap, vt, vtb, vb)]
    a1, h1, b1 = vote_scan_jax(*args, window=W, distance=300000,
                               edge_threshold_x10=7.0)

    mesh = make_site_mesh(jax.devices()[:8])
    a2, h2, b2 = sharded_vote_scan(mesh, *args, window=W, distance=300000,
                                   edge_threshold_x10=7.0)
    np.testing.assert_array_equal(np.array(a1), np.array(a2))
    np.testing.assert_array_equal(np.array(h1), np.array(h2))
    np.testing.assert_array_equal(np.array(b1), np.array(b2))


def test_chrom_mesh_matches_per_chromosome():
    """Chromosome-data-parallel step (jit + NamedSharding over the 8-device
    mesh) is element-equal to running each chromosome block alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from longphase_s_jax.ops.vote_scan import vote_scan_jax
    from longphase_s_jax.parallel.mesh import make_mesh, make_sharded_phase_step

    B, S, W = 8, 128, 35
    rng = np.random.default_rng(7)
    ch = rng.integers(0, 25, (B, S, W, 4)).astype(np.int32)
    cl = rng.integers(0, 6, (B, S, W, 4)).astype(np.int32)
    gap = rng.integers(1, 400000, (B, S)).astype(np.int32)
    vt = rng.integers(0, 5, (B, S)).astype(np.int8)
    tvt = rng.integers(0, 5, (B, S, W)).astype(np.int8)
    vb = np.broadcast_to(
        (np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]) < S,
        (B, S, W)).copy()

    mesh = make_mesh(jax.devices()[:B])
    step = make_sharded_phase_step(mesh, window=W, distance=300000,
                                   edge_threshold_x10=7.0)
    assigned, hp, bstart, total = step(ch, cl, gap, vt, tvt, vb)

    total_single = 0
    for b in range(B):
        a1, h1, s1 = vote_scan_jax(
            jnp.asarray(ch[b]), jnp.asarray(cl[b]), jnp.asarray(gap[b]),
            jnp.asarray(vt[b]), jnp.asarray(tvt[b]), jnp.asarray(vb[b]),
            window=W, distance=300000, edge_threshold_x10=7.0)
        assert (np.array(assigned[b]) == np.array(a1)).all()
        assert (np.array(hp[b]) == np.array(h1)).all()
        assert (np.array(bstart[b]) == np.array(s1)).all()
        total_single += int(np.array(a1).sum())
    assert int(total) == total_single


@pytest.mark.parametrize("C", [3, 10])
def test_wavefront_scan_matches_per_chromosome(C):
    """The cross-chromosome wavefront schedule (device k scans chromosome
    r-k at round r) must equal per-chromosome single-device scans."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from longphase_s_jax.parallel.sharded_scan import wavefront_vote_scan

    W, S = 35, 512
    rng = np.random.default_rng(7)
    ch = rng.integers(0, 15, size=(C, S, W, 4)).astype(np.int32)
    ch[rng.random(ch.shape) < 0.8] = 0
    cl = rng.integers(0, 2, size=(C, S, W, 4)).astype(np.int32)
    cl[rng.random(cl.shape) < 0.9] = 0
    gap = rng.integers(50, 4000, size=(C, S)).astype(np.int32)
    gap[rng.random((C, S)) < 0.02] = 10 ** 6
    vt = rng.choice([0, 0, 0, 3, 4], size=(C, S)).astype(np.int8)
    tgt = np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]
    vb = np.broadcast_to(tgt < S, (C, S, W))
    vtb = np.stack([np.where(tgt < S, vt[c][np.minimum(tgt, S - 1)], 0)
                    for c in range(C)]).astype(np.int8)

    singles = [vote_scan_jax(*[jnp.asarray(x[c]) for x in
                               (ch, cl, gap, vt, vtb, vb)],
                             window=W, distance=300000,
                             edge_threshold_x10=7.0) for c in range(C)]

    mesh = make_site_mesh(jax.devices()[:8])
    wa, wh, wb = wavefront_vote_scan(
        mesh, *[jnp.asarray(x) for x in (ch, cl, gap, vt, vtb, vb)],
        window=W, distance=300000, edge_threshold_x10=7.0)
    for c in range(C):
        np.testing.assert_array_equal(np.array(singles[c][0]), np.array(wa[c]))
        np.testing.assert_array_equal(np.array(singles[c][1]), np.array(wh[c]))
        np.testing.assert_array_equal(np.array(singles[c][2]), np.array(wb[c]))
