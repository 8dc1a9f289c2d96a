"""run_fused_phase (device pack+scan+assemble+read-correction in one jit)
must be element-exact vs the host pipeline (pack_flat -> run_vote_scan ->
assemble_blocks -> read_correction_packed)."""

import numpy as np
import pytest

from longphase_s_jax.core import fastpath
from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.ops.fused import run_fused_phase
from longphase_s_jax.ops.read_correction import read_correction_packed
from longphase_s_jax.ops.vote_scan import run_vote_scan


@pytest.mark.parametrize("seed", range(6))
def test_fused_phase_matches_host(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(5, 500))
    A = int(rng.integers(3, 250))
    positions = np.sort(rng.choice(np.arange(S * 120), size=S,
                                   replace=False)).astype(np.int64)
    params = PhaseParams()
    chunks = []
    names = []
    for _ in range(A):
        start = int(rng.integers(0, S))
        ln = int(rng.integers(1, min(60, S - start) + 1))
        idx = np.arange(start, start + ln)
        chunks.append((idx, rng.integers(0, 2, size=ln),
                       rng.choice([30, 5, -4, -5, -1, -2], size=ln)))
        names.append(f"r{int(rng.integers(0, A))}")
    obs_pos = np.concatenate([positions[i] for i, _, _ in chunks])
    obs_allele = np.concatenate([a for _, a, _ in chunks]).astype(np.int8)
    obs_qual = np.concatenate([q for _, _, q in chunks]).astype(np.int16)
    aln_offsets = np.concatenate(
        [[0], np.cumsum([len(i) for i, _, _ in chunks])]).astype(np.int64)

    positions_u, vtype, rank, m_read, m_rank, m_allele, m_qok, m_aln = \
        fastpath.merge_observations(obs_pos, obs_allele, obs_qual,
                                    aln_offsets, names, params)
    packed = fastpath.pack_flat(obs_pos, obs_allele, obs_qual, aln_offsets,
                                names, params)
    ps0, ori0 = run_vote_scan(packed, params)
    ps1, ori1, _ = read_correction_packed(packed, ps0, ori0, params)

    ps2, ori2 = run_fused_phase(
        m_read, m_rank, m_allele, m_qok, m_aln, positions_u, vtype,
        len(aln_offsets) - 1, params, engine="lax")
    assert np.array_equal(ps1, ps2)
    phased = ps1 != 0
    assert np.array_equal(ori1[phased], ori2[phased])


def test_flat_path_covers_cnv_intervals(tmp_path, monkeypatch):
    """The flat fast path must no longer bail out on CNV intervals: a
    clip-heavy fixture that yields getCNVInterval hits runs through
    _cnv_filter_flat and matches the oracle engine exactly."""
    import longphase_s_jax.core.fastpath as fp
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=4, length=200000,
                      coverage=60, read_len=6000, snp_rate=0.002,
                      error_rate=0.05, qual=20)
    used = {}
    orig = fp._cnv_filter_flat

    def spy(*a):
        used["cnv_flat"] = True
        return orig(*a)

    monkeypatch.setattr(fp, "_cnv_filter_flat", spy)

    def cfg(out, engine):
        return PhaseConfig(snp_file=fx["vcf"], bam_files=[fx["bam"]],
                           fasta_file=fx["fasta"],
                           result_prefix=str(tmp_path / out),
                           num_threads=1, is_pb=True, engine=engine)

    device = run_phase(cfg("device", "device"))
    oracle = run_phase(cfg("oracle", "oracle"))
    assert used.get("cnv_flat"), "fixture produced no CNV intervals"
    assert device == oracle


def test_flat_path_covers_svmod(tmp_path, monkeypatch):
    """SV/MOD co-phasing rides the native flat fast path (no object-pipeline
    fallback) and matches the oracle engine."""
    import longphase_s_jax.core.fastpath as fp
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=55, length=150000,
                      coverage=20, read_len=8000, snp_rate=0.0015,
                      n_svs=4, n_mods=5)
    used = {}
    orig = fp.phase_chromosome_flat

    def spy(*a, **kw):
        r = orig(*a, **kw)
        if r is not None:
            used["flat"] = True
        return r

    monkeypatch.setattr(fp, "phase_chromosome_flat", spy)
    import longphase_s_jax.models.phase as pm
    monkeypatch.setattr(pm, "phase_chromosome_flat", spy, raising=False)

    def cfg(out, engine):
        return PhaseConfig(snp_file=fx["vcf"], bam_files=[fx["bam"]],
                           fasta_file=fx["fasta"], sv_file=fx["sv_vcf"],
                           mod_file=fx["mod_vcf"],
                           result_prefix=str(tmp_path / out),
                           num_threads=1, is_pb=True, engine=engine)

    device = run_phase(cfg("device", "device"))
    oracle = run_phase(cfg("oracle", "oracle"))
    assert used.get("flat"), "SV/MOD run fell back off the flat fast path"
    assert device == oracle
    for suffix in (".vcf", "_SV.vcf", "_mod.vcf"):
        a = (tmp_path / f"device{suffix}").read_text().splitlines()
        b = (tmp_path / f"oracle{suffix}").read_text().splitlines()
        assert [l for l in a if not l.startswith("##")] == \
            [l for l in b if not l.startswith("##")]


def test_streaming_extraction_under_memory_cap(tmp_path, monkeypatch):
    """With LPS_MAX_INMEM_BAM below the file size, extraction streams
    bounded windows through the native scanner/walk and the phase output
    must equal the whole-file-handle run (both engines)."""
    from longphase_s_jax import native
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=12, length=150000,
                      coverage=20, read_len=9000, snp_rate=0.0015,
                      n_svs=3, n_mods=4)

    def cfg(out):
        return PhaseConfig(snp_file=fx["vcf"], bam_files=[fx["bam"]],
                           fasta_file=fx["fasta"], sv_file=fx["sv_vcf"],
                           mod_file=fx["mod_vcf"],
                           result_prefix=str(tmp_path / out),
                           num_threads=1, is_pb=True, engine="device")

    normal = run_phase(cfg("normal"))

    used = {}
    orig = native.extract_phase_streaming

    def spy(*a, **kw):
        used["stream"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(native, "extract_phase_streaming", spy)
    monkeypatch.setenv("LPS_MAX_INMEM_BAM", "1000")
    native._bam_cache.clear()
    capped = run_phase(cfg("capped"))
    monkeypatch.delenv("LPS_MAX_INMEM_BAM")
    native._bam_cache.clear()
    assert used.get("stream"), "memory cap did not engage the streaming path"
    assert capped == normal
