"""Device tag-kernel parity: the JAX reductions in ops/tag_kernels.py must
produce byte-identical pipeline output to the host NumPy fast path, for the
germline haplotag judge (HaplotagStrategy.cpp:20-300), both somatic extract
passes (SomaticVarCaller.cpp:112-759), and the somatic tag pass
(SomaticHaplotagProcess.cpp:310-536). Hermetic: runs our CLI twice
(LPS_TAG_ENGINE=host vs =device on the CPU backend) and diffs outputs."""

import pytest

from longphase_s_jax.io.bam import BamReader
from longphase_s_jax.testing.simulate import make_fixture, make_somatic_fixture


def _tags(bam_path, hp_tag="HP"):
    out = []
    r = BamReader(bam_path)
    for rec in r:
        out.append((rec.qname, rec.flag, rec.pos, rec.get_tag(hp_tag),
                    rec.get_tag("PS"), rec.get_tag("PQ")))
    r.close()
    return out


@pytest.fixture()
def engine_env(monkeypatch):
    def set_engine(name):
        monkeypatch.setenv("LPS_TAG_ENGINE", name)
    return set_engine


def test_germline_device_parity(tmp_path, engine_env):
    from longphase_s_jax.core.phase_algo import PhaseParams
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
    from longphase_s_jax.models.phase import PhaseConfig, run_phase

    fix = make_fixture(str(tmp_path / "fix"), seed=11, length=150000,
                       coverage=22, read_len=9000, snp_rate=0.0015,
                       error_rate=0.04, qual=22, indel_rate=0.0004)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle", phase_indel=True,
                          params=PhaseParams()))
    outs = {}
    for eng in ("host", "device"):
        engine_env(eng)
        prefix = str(tmp_path / f"tag_{eng}")
        run_haplotag(HaplotagConfig(snp_file=phased + ".vcf",
                                    bam_file=fix["bam"],
                                    fasta_file=fix["fasta"],
                                    result_prefix=prefix))
        outs[eng] = _tags(prefix + ".bam")
    assert outs["host"] == outs["device"]
    assert any(t[3] is not None for t in outs["host"])  # really tagged


def test_somatic_device_parity(tmp_path, engine_env):
    from longphase_s_jax.core.phase_algo import PhaseParams
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_somatic_haplotag)

    fix = make_somatic_fixture(str(tmp_path / "fix"), seed=13, length=220000,
                               normal_coverage=22, tumor_coverage=26,
                               purity=0.55, n_somatic=20, n_artifacts=5)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          engine="oracle", params=PhaseParams()))
    outs = {}
    for eng in ("host", "device"):
        engine_env(eng)
        prefix = str(tmp_path / f"som_{eng}")
        run_somatic_haplotag(SomaticConfig(
            snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
            bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
            fasta_file=fix["fasta"], result_prefix=prefix,
            write_somatic_vcf=True))
        with open(prefix + "_sc.vcf") as f:
            sc = [l for l in f if not l.startswith("##commandline")]
        with open(prefix + "_purity.out") as f:
            purity = f.read()
        outs[eng] = (_tags(prefix + ".bam"), sc, purity)
    assert outs["host"][0] == outs["device"][0]
    assert outs["host"][1] == outs["device"][1]
    assert outs["host"][2] == outs["device"][2]
    assert any(t[3] == "3" or (t[3] or "").startswith("1-")
               for t in outs["host"][0])  # somatic tags present


def test_modcall_device_parity(tmp_path, engine_env):
    from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
    from longphase_s_jax.testing.simulate import make_meth_fixture

    fix = make_meth_fixture(str(tmp_path / "fix"), seed=17, length=200000,
                            coverage=20, n_asm=20, n_homo_mod=10)
    outs = {}
    for eng in ("host", "device"):
        engine_env(eng)
        prefix = str(tmp_path / f"mod_{eng}")
        run_modcall(ModCallConfig(bam_files=[fix["bam"]],
                                  fasta_file=fix["fasta"],
                                  snp_file=fix["vcf"],
                                  result_prefix=prefix))
        with open(prefix + ".vcf") as f:
            outs[eng] = [l for l in f if not l.startswith("##commandline")]
    assert outs["host"] == outs["device"]
    assert len(outs["host"]) > 20  # non-trivial output


def test_engine_selection_and_strictness(monkeypatch):
    """The device offload is work-size gated (per-call dispatch/transfer
    cost must amortize); LPS_TAG_ENGINE forces either engine outright.
    There is no strict mode left to switch: a selected device path either
    runs or raises, and only inputs outside the int32 domain return None
    (host path)."""
    monkeypatch.delenv("LPS_TAG_ENGINE", raising=False)
    monkeypatch.delenv("LPS_TAG_DEVICE_MIN", raising=False)
    from longphase_s_jax.ops import tag_kernels
    assert tag_kernels.engine() == "host"                 # no size: host
    assert tag_kernels.engine(100) == "host"              # tiny walk
    assert tag_kernels.engine(tag_kernels.device_min()) == "device"
    monkeypatch.setenv("LPS_TAG_DEVICE_MIN", "50")
    assert tag_kernels.engine(100) == "device"
    monkeypatch.setenv("LPS_TAG_ENGINE", "host")
    assert tag_kernels.engine(1 << 40) == "host"          # forced host
    monkeypatch.setenv("LPS_TAG_ENGINE", "device")
    assert tag_kernels.engine(1) == "device"              # forced device
    monkeypatch.delenv("LPS_TAG_DEVICE_MIN")
    assert tag_kernels.device_min() == 4_000_000
    assert not hasattr(tag_kernels, "strict")
    import numpy as np
    big_ps = {"pos": np.arange(3), "ps": np.array([1, 2, 1 << 40])}
    walk = {"category": np.zeros(1, np.uint8),
            "obs_var": np.zeros(1, np.int64)}
    assert tag_kernels.germline_counts_device(walk, big_ps, False) is None
