"""Device-side pair packing equality: fused counts vs the host bincount
packer, and the full fused pack+scan vs the classic two-stage path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longphase_s_jax.core.fastpath import merge_observations, pack_flat
from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.ops.fused import device_pair_counts, run_fused_pack_scan
from longphase_s_jax.ops.vote_scan import assemble_blocks, run_vote_scan


def _random_flat(seed, n_reads=40, max_obs=60, n_sites=300):
    rng = np.random.default_rng(seed)
    positions = np.sort(rng.choice(np.arange(1000, 400000, 7), n_sites,
                                   replace=False))
    obs_pos = []
    offsets = [0]
    names = []
    for r in range(n_reads):
        k = int(rng.integers(1, max_obs))
        lo = int(rng.integers(0, n_sites - 1))
        hi = min(n_sites, lo + int(rng.integers(1, 80)))
        sites = np.sort(rng.choice(np.arange(lo, hi),
                                   min(k, hi - lo), replace=False))
        obs_pos.extend(positions[sites])
        offsets.append(len(obs_pos))
        # a few split alignments share a name (merged-read semantics)
        names.append(f"read_{r if rng.random() > 0.15 else max(0, r - 1)}")
    n = len(obs_pos)
    obs_pos = np.array(obs_pos, np.int64)
    obs_allele = rng.integers(0, 2, n).astype(np.int8)
    obs_qual = rng.integers(0, 40, n).astype(np.int16)
    return obs_pos, obs_allele, obs_qual, np.array(offsets, np.int64), names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_counts_match_host(seed):
    params = PhaseParams()
    obs_pos, obs_allele, obs_qual, offsets, names = _random_flat(seed)
    packed = pack_flat(obs_pos, obs_allele, obs_qual, offsets, names, params)
    positions, vtype, rank, m_read, m_rank, m_allele, m_qok, _m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, offsets, names,
                           params)
    S = len(positions)
    S_pad = max(256, 1 << int(np.ceil(np.log2(S))))
    hi, lo = jax.jit(device_pair_counts, static_argnums=(4, 5))(
        jnp.asarray(m_read.astype(np.int32)), jnp.asarray(m_rank),
        jnp.asarray(m_allele.astype(np.int8)), jnp.asarray(m_qok),
        S_pad, params.connect_adjacent)
    hi = np.array(hi)[:S]
    lo = np.array(lo)[:S]
    assert (hi == packed.counts_hi).all()
    assert (lo == packed.counts_lo).all()


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_mxu_pack_matches_scatter_pack(seed):
    """The Gram tile-matmul pair pack (ops/mxu_pack.py, WGS-scale path) must
    reproduce the scatter pack's count planes element-exactly on
    unique-(read,rank) streams."""
    from functools import partial

    from longphase_s_jax.ops.mxu_pack import build_tiles, mxu_pair_counts

    params = PhaseParams()
    obs_pos, obs_allele, obs_qual, offsets, names = _random_flat(seed)
    names = [f"uniq_{i}" for i in range(len(names))]  # no split alignments
    packed = pack_flat(obs_pos, obs_allele, obs_qual, offsets, names, params)
    positions, vtype, rank, m_read, m_rank, m_allele, m_qok, _m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, offsets, names,
                           params)
    S = len(positions)
    S_pad = max(256, 1 << int(np.ceil(np.log2(S))))
    W = params.connect_adjacent
    bits = build_tiles(m_read, m_rank, m_allele, m_qok, S_pad, W)
    assert bits is not None
    hi, lo = jax.jit(partial(mxu_pair_counts, window=W))(jnp.asarray(bits))
    assert (np.asarray(hi)[:S] == packed.counts_hi).all()
    assert (np.asarray(lo)[:S] == packed.counts_lo).all()


def test_mxu_full_phase_matches_scatter_path(monkeypatch):
    """End-to-end run_fused_phase parity: Gram path (forced) vs scatter path,
    including the host read-correction mirror, with the scan kernel under
    the Pallas interpreter."""
    from longphase_s_jax.ops.fused import run_fused_phase

    params = PhaseParams()
    obs_pos, obs_allele, obs_qual, offsets, names = _random_flat(8)
    names = [f"uniq_{i}" for i in range(len(names))]
    positions, vtype, rank, m_read, m_rank, m_allele, m_qok, m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, offsets, names,
                           params)
    n_aln = len(offsets) - 1
    monkeypatch.setenv("LPS_MXU_PACK_MIN", str(1 << 40))
    ps0, ori0 = run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                                positions, vtype, n_aln, params,
                                engine="interpret")
    monkeypatch.setenv("LPS_MXU_PACK_MIN", "1")
    ps1, ori1 = run_fused_phase(m_read, m_rank, m_allele, m_qok, m_aln,
                                positions, vtype, n_aln, params,
                                engine="interpret")
    assert (ps0 == ps1).all()
    assert (ori0[ps0 != 0] == ori1[ps1 != 0]).all()


def test_mxu_pack_falls_back_on_duplicates():
    """Streams with duplicate (read, rank) — overlapping split alignments —
    must refuse the tile pack (caller then uses the scatter pack)."""
    from longphase_s_jax.ops.mxu_pack import build_tiles

    m_read = np.array([0, 0, 0, 1], np.int32)
    m_rank = np.array([3, 3, 5, 2], np.int32)
    m_allele = np.array([0, 1, 0, 1], np.int64)
    m_qok = np.ones(4, bool)
    assert build_tiles(m_read, m_rank, m_allele, m_qok, 256, 35) is None
    m_allele2 = np.array([0, 2, 0, 1], np.int64)  # out-of-domain allele
    m_rank2 = np.array([3, 4, 5, 2], np.int32)
    assert build_tiles(m_read, m_rank2, m_allele2, m_qok, 256, 35) is None


@pytest.mark.parametrize("seed", [3, 4])
def test_fused_scan_matches_classic(seed):
    params = PhaseParams()
    obs_pos, obs_allele, obs_qual, offsets, names = _random_flat(seed)
    packed = pack_flat(obs_pos, obs_allele, obs_qual, offsets, names, params)
    ps0, ori0 = run_vote_scan(packed, params)
    positions, vtype, rank, m_read, m_rank, m_allele, m_qok, _m_aln = \
        merge_observations(obs_pos, obs_allele, obs_qual, offsets, names,
                           params)
    assigned, hp, bstart = run_fused_pack_scan(
        m_read, m_rank, m_allele, m_qok, positions, vtype, params,
        engine="interpret")
    ps1, ori1 = assemble_blocks(positions, assigned, hp, bstart)
    assert (ps0 == ps1).all()
    assert (ori0 == ori1).all()
