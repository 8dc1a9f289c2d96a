"""Golden tests: phase with SV and methylation co-phasing (--sv-file,
--mod-file) producing three annotated VCFs identical to the reference."""

import subprocess

import pytest

from longphase_s_jax.core.phase_algo import PhaseParams
from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import make_fixture
from tests.test_golden_phase import assert_vcfs_match


@pytest.fixture(scope="module")
def svmod_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("fix_svmod")
    return make_fixture(str(out), seed=55, length=200000, coverage=25,
                        read_len=12000, snp_rate=0.0012, error_rate=0.03,
                        qual=25, n_svs=6, n_mods=8)


@pytest.mark.parametrize("engine", ["oracle", "device"])
def test_phase_sv_mod(reference_binary, svmod_fixture, tmp_path, engine):
    fix = svmod_fixture
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "phase", "--pb",
                    "-s", fix["vcf"], "--sv-file", fix["sv_vcf"],
                    "--mod-file", fix["mod_vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    cfg = PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                      fasta_file=fix["fasta"], result_prefix=ours,
                      sv_file=fix["sv_vcf"], mod_file=fix["mod_vcf"],
                      engine=engine, params=PhaseParams())
    run_phase(cfg)
    assert_vcfs_match(golden + ".vcf", ours + ".vcf")
    assert_vcfs_match(golden + "_SV.vcf", ours + "_SV.vcf")
    assert_vcfs_match(golden + "_mod.vcf", ours + "_mod.vcf")


def test_haplotag_sv_mod(reference_binary, svmod_fixture, tmp_path):
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag

    fix = svmod_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb",
                    "-s", fix["vcf"], "--sv-file", fix["sv_vcf"],
                    "--mod-file", fix["mod_vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    golden = str(tmp_path / "golden")
    subprocess.run([reference_binary, "haplotag", "-s", phased + ".vcf",
                    "--sv-file", phased + "_SV.vcf",
                    "--mod-file", phased + "_mod.vcf",
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                   check=True, capture_output=True)
    ours = str(tmp_path / "ours")
    run_haplotag(HaplotagConfig(
        snp_file=phased + ".vcf", sv_file=phased + "_SV.vcf",
        mod_file=phased + "_mod.vcf", bam_file=fix["bam"],
        fasta_file=fix["fasta"], result_prefix=ours))

    def tags(p):
        r = BamReader(p)
        out = [(x.qname, x.flag, x.pos, x.get_tag("HP"), x.get_tag("PS"),
                x.get_tag("PQ")) for x in r]
        r.close()
        return out

    g = tags(golden + ".bam")
    o = tags(ours + ".bam")
    assert len(g) == len(o)
    mism = [(a, b) for a, b in zip(g, o) if a != b]
    assert not mism, f"{len(mism)} differing records; first: {mism[0]}"


def test_guard_mod_end_flag(tmp_path, monkeypatch):
    """LPS_GUARD_MOD_END=1 selects the guarded (correct) behavior for mods
    past the last SNP instead of the reference's libstdc++ *map::end()
    quirk; the native and pure-Python walkers must agree under either
    setting."""
    import importlib

    import pytest

    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.testing.simulate import make_fixture

    fx = make_fixture(str(tmp_path / "fix"), seed=66, length=120000,
                      coverage=18, read_len=8000, snp_rate=0.0015,
                      n_svs=2, n_mods=8)

    def run(tag, engine):
        import longphase_s_jax.core.alleles as al
        importlib.reload(al) if False else None  # flag read at call site
        return run_phase(PhaseConfig(
            snp_file=fx["vcf"], bam_files=[fx["bam"]],
            fasta_file=fx["fasta"], sv_file=fx["sv_vcf"],
            mod_file=fx["mod_vcf"], result_prefix=str(tmp_path / tag),
            num_threads=1, is_pb=True, engine=engine))

    import longphase_s_jax.core.alleles as al
    from longphase_s_jax import native as nat

    def python_walker_only():
        # force the pure-Python AlleleExtractor for the oracle run so the
        # flag is exercised in BOTH implementations
        return pytest.MonkeyPatch()

    quirk_dev = run("q_dev", "device")          # native walk, quirk on
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nat, "extract_phase", lambda *a, **k: None)
        quirk_oracle = run("q_oracle", "oracle")  # python walk, quirk on
    assert quirk_dev == quirk_oracle

    monkeypatch.setenv("LPS_GUARD_MOD_END", "1")
    monkeypatch.setattr(al, "_GUARD_MOD_END", True)
    guarded_dev = run("g_dev", "device")        # native walk, guarded
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nat, "extract_phase", lambda *a, **k: None)
        guarded_oracle = run("g_oracle", "oracle")  # python walk, guarded
    assert guarded_dev == guarded_oracle
