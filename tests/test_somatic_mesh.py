"""Somatic tag-kernel reductions on the device mesh: batching the
per-chromosome walks across an 8-device mesh (the device analog of the
reference's contig parallel-for, SomaticVarCaller.cpp:822) must produce
results bit-identical to per-chromosome single-device calls, for all three
kernel modes (normal extract / tumor extract / tumor tag)."""

import numpy as np
import pytest


def _rand_item(rng):
    """A random but internally consistent (walk, tables) chromosome:
    indices in range, PS values non-negative (a negative PS at a matched
    SNP observation is the reference's hard-exit path, not a parity
    case)."""
    S = int(rng.integers(40, 300))
    A = int(rng.integers(30, 200))
    No = int(rng.integers(500, 3000))
    walk = {
        "obs_var": rng.integers(0, S, No).astype(np.int64),
        "obs_aln": rng.integers(0, A, No).astype(np.int64),
        "obs_aux": rng.integers(0, max(A // 2, 1), No).astype(np.int64),
        "obs_base": rng.integers(0, 6, No).astype(np.uint8),
        "obs_flags": rng.integers(0, 16, No).astype(np.uint8),
        "obs_kind": rng.integers(0, 3, No).astype(np.uint8),
        "category": np.zeros(A, np.uint8),
    }
    t = {"pos": np.arange(S, dtype=np.int64) * 50}
    for key in ("nor_has", "alt_eq_hp1", "alt_eq_hp2", "ref_eq_hp1",
                "ref_eq_hp2", "hp1_long", "hp2_long", "tum_has",
                "tum_ref_is1", "tum_alt_is1"):
        t[key] = rng.integers(0, 2, S).astype(bool)
    for key in ("nor_vt", "tum_vt"):
        t[key] = rng.integers(0, 4, S).astype(np.int32)
    for key in ("nor_gt", "tum_gt"):
        t[key] = rng.integers(-1, 2, S).astype(np.int32)
    for key in ("nor_ps", "tum_ps"):
        t[key] = rng.integers(0, 1000, S).astype(np.int64)
    for key in ("nor_ref0", "nor_alt0", "tum_ref0", "tum_alt0",
                "nor_hp1c", "nor_hp2c"):
        t[key] = rng.integers(0, 4, S).astype(np.int32)
    return {
        "walk": walk, "t": t,
        "is_som": rng.integers(0, 2, S).astype(bool),
        "derive": rng.integers(0, 3, S).astype(np.int8),
        "gate": rng.integers(0, 2, No).astype(np.uint8),
    }


@pytest.mark.parametrize("mode,want_posbase,want_derive", [
    ("normal", True, False),
    ("extract", True, False),
    ("haplotag", False, True),
])
def test_somatic_mesh_matches_single_device(mode, want_posbase, want_derive):
    from longphase_s_jax.ops import tag_kernels as tk
    from longphase_s_jax.parallel.mesh import make_mesh

    rng = np.random.default_rng(71)
    # 5 chromosomes on an 8-device mesh: exercises filler-chromosome batch
    # padding as well as the sharded axis
    items = [_rand_item(rng) for _ in range(5)]
    mesh = make_mesh()
    got = tk.somatic_counts_device_mesh(
        mesh, items, mode, want_posbase=want_posbase,
        want_derive=want_derive, ref_nonempty=(mode == "normal"))
    assert len(got) == len(items)
    for it, g in zip(items, got):
        ref = tk.somatic_counts_device(
            it["walk"], it["t"], mode, is_som=it["is_som"],
            derive=it["derive"], gate=it["gate"],
            want_posbase=want_posbase, want_derive=want_derive,
            ref_nonempty=(mode == "normal"))
        assert set(g) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(g[k], ref[k], err_msg=f"{mode}/{k}")


def test_somatic_pipeline_on_mesh(tmp_path, monkeypatch):
    """Full somatic_haplotag with LPS_MULTICHIP=1 + the device engine on
    the virtual 8-device CPU mesh: extraction AND tag reductions run
    through somatic_counts_device_mesh, and every output must equal the
    plain host run (contig parallelism parity)."""
    from longphase_s_jax.core.phase_algo import PhaseParams
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_somatic_haplotag)
    from longphase_s_jax.testing.simulate import make_multichrom_somatic_fixture

    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=23,
                                          n_chroms=3, base_length=120000)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle", params=PhaseParams()))

    def go(prefix, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        try:
            run_somatic_haplotag(SomaticConfig(
                snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
                bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
                fasta_file=fix["fasta"], result_prefix=prefix,
                write_somatic_vcf=True))
        finally:
            for k in env:
                monkeypatch.delenv(k, raising=False)
        with open(prefix + "_sc.vcf") as f:
            sc = [l for l in f if not l.startswith("##commandline")]
        tags = [(r.qname, r.flag, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(prefix + ".bam")]
        return sc, tags

    host = go(str(tmp_path / "host"), {"LPS_TAG_ENGINE": "host"})
    mesh = go(str(tmp_path / "mesh"),
              {"LPS_TAG_ENGINE": "device", "LPS_MULTICHIP": "1"})
    assert host[0] == mesh[0]
    assert host[1] == mesh[1]
    assert any(t[3] is not None for t in host[1])
