"""Per-contig checkpoint/resume (utils/checkpoint.py; SURVEY.md §5).

A killed WGS phase run must resume from its completed contigs and produce a
final VCF identical to an uninterrupted run; stale checkpoints (different
inputs/params) must be ignored."""

import pytest

from longphase_s_jax.models import phase as phase_mod
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import make_multichrom_fixture


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_fix")
    return make_multichrom_fixture(str(d / "fix"), seed=41, n_chroms=4,
                                   base_length=50000)


def _cfg(fix, tmp_path, out, ckpt="", engine="oracle", **kw):
    return PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                       fasta_file=fix["fasta"],
                       result_prefix=str(tmp_path / out),
                       num_threads=1, is_pb=True, engine=engine,
                       checkpoint_dir=ckpt, **kw)


def _vcf(tmp_path, out):
    lines = (tmp_path / f"{out}.vcf").read_text().splitlines()
    return [l for l in lines if not l.startswith("##commandline")]


def test_kill_and_resume_identical_vcf(fix, tmp_path, monkeypatch):
    straight = run_phase(_cfg(fix, tmp_path, "straight"))

    # "kill" the run after two contigs complete: the third phase call dies
    ckpt_dir = str(tmp_path / "ckpt")
    real = phase_mod.phase_chromosome
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(phase_mod, "phase_chromosome", dying)
    with pytest.raises(KeyboardInterrupt):
        run_phase(_cfg(fix, tmp_path, "killed", ckpt=ckpt_dir))
    monkeypatch.setattr(phase_mod, "phase_chromosome", real)

    # resume: the two completed contigs load from the checkpoint, the rest
    # compute; final results and VCF identical to the uninterrupted run
    calls2 = {"n": 0}

    def counting(*a, **kw):
        calls2["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(phase_mod, "phase_chromosome", counting)
    resumed = run_phase(_cfg(fix, tmp_path, "resumed", ckpt=ckpt_dir))
    assert resumed == straight
    assert calls2["n"] == 2  # only the two unfinished contigs recomputed
    assert _vcf(tmp_path, "resumed") == _vcf(tmp_path, "straight")


def test_stale_checkpoint_ignored(fix, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt2")
    first = run_phase(_cfg(fix, tmp_path, "first", ckpt=ckpt_dir))
    # different params -> different fingerprint -> full recompute, same VCF
    from longphase_s_jax.core.phase_algo import PhaseParams

    other = run_phase(_cfg(fix, tmp_path, "other", ckpt=ckpt_dir,
                           params=PhaseParams(distance=299999)))
    assert set(other) == set(first)
    # same params again -> resumes everything, zero recompute, same output
    resumed = run_phase(_cfg(fix, tmp_path, "again", ckpt=ckpt_dir))
    assert resumed == first
    assert _vcf(tmp_path, "again") == _vcf(tmp_path, "first")


def test_somatic_kill_and_resume(tmp_path, monkeypatch):
    """A somatic run killed mid-extraction resumes from the completed
    per-contig pass checkpoints and produces byte-identical _sc.vcf +
    tagged BAM (three BAM passes dominate WGS runtime)."""
    from longphase_s_jax.core import somatic_fast
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_somatic_haplotag)
    from longphase_s_jax.testing.simulate import \
        make_multichrom_somatic_fixture

    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=19,
                                          n_chroms=3, base_length=120000)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle"))

    def cfg(out, ckpt=""):
        return SomaticConfig(
            snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
            bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
            fasta_file=fix["fasta"], result_prefix=str(tmp_path / out),
            write_somatic_vcf=True, checkpoint_dir=ckpt)

    run_somatic_haplotag(cfg("straight"))

    # "kill" during the tumor pass: first chromosome extracts, second dies
    ckpt_dir = str(tmp_path / "ckpt")
    real = somatic_fast.extract_tumor_chromosome_fast
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(somatic_fast, "extract_tumor_chromosome_fast", dying)
    with pytest.raises(KeyboardInterrupt):
        run_somatic_haplotag(cfg("killed", ckpt=ckpt_dir))
    monkeypatch.setattr(somatic_fast, "extract_tumor_chromosome_fast", real)

    # resume: normal pass + 1 tumor contig load from checkpoint; the rest
    # compute; outputs byte-identical to the uninterrupted run
    nor_calls = {"n": 0}
    real_nor = somatic_fast.extract_normal_chromosome_fast

    def counting_nor(*a, **kw):
        nor_calls["n"] += 1
        return real_nor(*a, **kw)

    tum_calls = {"n": 0}

    def counting_tum(*a, **kw):
        tum_calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(somatic_fast, "extract_normal_chromosome_fast",
                        counting_nor)
    monkeypatch.setattr(somatic_fast, "extract_tumor_chromosome_fast",
                        counting_tum)
    run_somatic_haplotag(cfg("resumed", ckpt=ckpt_dir))
    assert nor_calls["n"] == 0  # all normal-pass contigs checkpointed
    assert tum_calls["n"] == 2  # only the unfinished tumor contigs rewalk

    def strip(p):
        return [l for l in open(p) if not l.startswith("##commandline")]
    assert strip(str(tmp_path / "straight_sc.vcf")) == \
        strip(str(tmp_path / "resumed_sc.vcf"))

    def tags(p):
        r = BamReader(p)
        out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
        r.close()
        return out
    assert tags(str(tmp_path / "straight.bam")) == \
        tags(str(tmp_path / "resumed.bam"))


def test_modcall_kill_and_resume(tmp_path, monkeypatch):
    """A modcall run killed mid-loop resumes from the per-contig line
    checkpoints with a byte-identical VCF."""
    from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
    from longphase_s_jax.testing.simulate import make_multichrom_meth_fixture

    fix = make_multichrom_meth_fixture(str(tmp_path / "fix"), seed=23,
                                       n_chroms=3, base_length=100000)

    def cfg(out, ckpt=""):
        return ModCallConfig(bam_files=[fix["bam"]],
                             fasta_file=fix["fasta"], snp_file=fix["vcf"],
                             result_prefix=str(tmp_path / out),
                             checkpoint_dir=ckpt)

    run_modcall(cfg("straight"))

    from longphase_s_jax.models import modcall_fast
    real = modcall_fast.run_chrom_fast
    # patch the name run_modcall imports (module-local import inside loop)
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    ckpt_dir = str(tmp_path / "ckpt")
    monkeypatch.setattr(modcall_fast, "run_chrom_fast", dying)
    with pytest.raises(KeyboardInterrupt):
        run_modcall(cfg("killed", ckpt=ckpt_dir))
    monkeypatch.setattr(modcall_fast, "run_chrom_fast", real)

    calls2 = {"n": 0}

    def counting(*a, **kw):
        calls2["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(modcall_fast, "run_chrom_fast", counting)
    run_modcall(cfg("resumed", ckpt=ckpt_dir))
    assert calls2["n"] == 2  # only the two unfinished contigs recomputed

    def strip(p):
        return [l for l in open(p) if not l.startswith("##commandline")]
    assert strip(str(tmp_path / "straight.vcf")) == \
        strip(str(tmp_path / "resumed.vcf"))


def test_checkpoint_with_device_engine_multichip(fix, tmp_path, monkeypatch):
    """The mesh-batched path checkpoints through the same record() hook."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    monkeypatch.setenv("LPS_MULTICHIP", "1")
    ckpt_dir = str(tmp_path / "ckpt3")
    a = run_phase(_cfg(fix, tmp_path, "dev_a", ckpt=ckpt_dir, engine="device"))
    b = run_phase(_cfg(fix, tmp_path, "dev_b", ckpt=ckpt_dir, engine="device"))
    assert a == b
    assert _vcf(tmp_path, "dev_a") == _vcf(tmp_path, "dev_b")
