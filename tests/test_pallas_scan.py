"""Vote-scan kernel (ops/scan_kernel.py) equality vs the lax.scan engine,
under the Pallas interpreter on the CPU; chip_smoke.py runs the same
comparison compiled for the GPU at S_pad 16384 and 2^19.

Every value is a small integer or an f32 product of small integers, so the
comparison is exact equality: a mismatch is a bug, not rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longphase_s_jax.ops.scan_kernel import (MAX_WINDOW, check_window,
                                             ring_size, vote_scan_kernel_pc)
from longphase_s_jax.ops.vote_scan import pair_sums, vote_scan_core

_core = jax.jit(vote_scan_core,
                static_argnames=("window", "distance", "edge_threshold_x10"))


def _inputs(seed, S, W, lead=()):
    rng = np.random.default_rng(seed)
    ch = rng.integers(0, 30, (*lead, S, W, 4)).astype(np.int32)
    cl = rng.integers(0, 8, (*lead, S, W, 4)).astype(np.int32)
    gap = rng.integers(1, 400000, (*lead, S)).astype(np.int32)
    vt = rng.integers(0, 5, (*lead, S)).astype(np.int8)
    tvt = rng.integers(0, 5, (*lead, S, W)).astype(np.int8)
    vb = (np.arange(S)[:, None] + np.arange(1, W + 1)[None, :]) < S
    vb = np.broadcast_to(vb, (*lead, S, W))
    return tuple(jnp.asarray(x) for x in (ch, cl, gap, vt, tvt, vb))


def _kernel(args, **kw):
    ch, cl, *rest = args
    return vote_scan_kernel_pc(*pair_sums(ch, cl), *rest, interpret=True,
                               **kw)


@pytest.mark.parametrize("seed,S", [(1, 256), (2, 512), (3, 300)])
def test_pallas_scan_matches_lax_scan(seed, S):
    W = 35
    args = _inputs(seed, S, W)
    kw = dict(window=W, distance=300000, edge_threshold_x10=7.0)
    ref = _core(*args, **kw)
    got = _kernel(args, **kw)
    for a, b in zip(ref, got):
        assert (np.array(a) == np.array(b)).all()


@pytest.mark.parametrize("seed,S,W", [(5, 256, 63), (6, 384, 7)])
def test_blocked_pallas_scan_matches_lax_scan(seed, S, W):
    """The kernel's grid runs a chromosome batch [B, S, W] (the mesh's
    per-device batch), at windows on both sides of the default: W = 63 is
    the largest with a 64-slot ring, W = 7 leaves most slots empty."""
    B = 3
    args = _inputs(seed, S, W, lead=(B,))
    kw = dict(window=W, distance=300000, edge_threshold_x10=7.0)
    got = _kernel(args, **kw)
    for b in range(B):
        ref = _core(*(a[b] for a in args), **kw)
        for r, g in zip(ref, got):
            assert (np.array(r) == np.array(g[b])).all()


def test_ring_size_and_window_range():
    """The ring is the next power of two above W (>= 64); windows whose
    16-bit vote fields could overflow are refused with an error."""
    assert ring_size(35) == 64
    assert ring_size(63) == 64
    assert ring_size(64) == 128
    check_window(35)
    check_window(MAX_WINDOW)
    for bad in (0, MAX_WINDOW + 1):
        with pytest.raises(ValueError, match="connectAdjacent"):
            check_window(bad)
