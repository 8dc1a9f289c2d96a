"""Multi-host scaffold (parallel/distributed.py; SURVEY.md §2.6).

A 2-process CPU run — each process phasing its contig shard, results merged
via Gloo all-gather — must produce a VCF byte-identical (modulo the recorded
commandline) to the single-process run on a multi-chromosome fixture."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from longphase_s_jax.models.phase import PhaseConfig, run_phase
from longphase_s_jax.testing.simulate import make_multichrom_fixture


@pytest.fixture(scope="module")
def fix(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_fix")
    return make_multichrom_fixture(str(d / "fix"), seed=43, n_chroms=5,
                                   base_length=40000)



def _communicate_all(procs, timeout=600):
    """communicate() on every worker; on timeout, kill the pair first so a
    stuck run can't leave orphans holding the coordinator port/CPU."""
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tails = [p.communicate()[1].decode()[-500:] for p in procs]
        raise AssertionError(f"distributed workers timed out; stderr tails: {tails}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    cfg = PhaseConfig(**json.loads(cfg_json), dist=spec)
    run_phase(cfg)
""")


def _vcf_body(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("##commandline")]


def test_two_process_run_matches_single(fix, tmp_path):
    single = tmp_path / "single"
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=str(single),
                          num_threads=2, is_pb=True, engine="oracle"))

    port = _free_port()
    cfg = dict(snp_file=fix["vcf"], bam_files=[fix["bam"]],
               fasta_file=fix["fasta"],
               result_prefix=str(tmp_path / "dist"),
               num_threads=1, is_pb=True, engine="oracle")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)  # children don't need the 8-device mesh
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(cfg),
             f"127.0.0.1:{port},2,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = _communicate_all(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]

    assert _vcf_body(tmp_path / "dist.vcf") == _vcf_body(f"{single}.vcf")


def test_four_process_run_matches_single(fix, tmp_path):
    """nprocs=4: four contig-sharded processes, one writer
    gather — VCF must still match the single-process run byte-for-byte."""
    single = tmp_path / "single4"
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=str(single),
                          num_threads=2, is_pb=True, engine="oracle"))

    port = _free_port()
    cfg = dict(snp_file=fix["vcf"], bam_files=[fix["bam"]],
               fasta_file=fix["fasta"],
               result_prefix=str(tmp_path / "dist4"),
               num_threads=1, is_pb=True, engine="oracle")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(cfg),
             f"127.0.0.1:{port},4,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(4)
    ]
    outs = _communicate_all(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]

    assert _vcf_body(tmp_path / "dist4.vcf") == _vcf_body(f"{single}.vcf")


def test_shard_contigs_single_process_is_identity():
    from longphase_s_jax.parallel import distributed as dist

    contigs = ["chr1", "chr2", "chr3"]
    assert dist.shard_contigs(contigs) == contigs  # process_count() == 1
    assert dist.is_writer()


WORKER_PURITY = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.somatic import SomaticConfig, run_estimate_purity
    cfg = SomaticConfig(**json.loads(cfg_json), dist=spec)
    p = run_estimate_purity(cfg)
    print(f"PURITY={p!r}")
""")


def test_two_process_estimate_purity_matches_single(tmp_path):
    """estimate_purity with contig-sharded extraction + all-gathered purity
    feature points must reproduce the single-process purity and report."""
    from longphase_s_jax.models.somatic import SomaticConfig, run_estimate_purity
    from longphase_s_jax.testing.simulate import make_multichrom_somatic_fixture

    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=81,
                                          n_chroms=3)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          num_threads=2, is_pb=True, engine="oracle"))
    base = dict(snp_file=phased + ".vcf",
                tumor_snv_file=fix["tumor_vcf"],
                bam_file=fix["normal_bam"],
                tumor_bam_file=fix["tumor_bam"],
                fasta_file=fix["fasta"], quality_threshold=20,
                tag_supplementary=True)
    single = run_estimate_purity(SomaticConfig(
        **base, result_prefix=str(tmp_path / "single")))

    port = _free_port()
    cfg = dict(base, result_prefix=str(tmp_path / "dist"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER_PURITY, json.dumps(cfg),
             f"127.0.0.1:{port},2,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = _communicate_all(procs)
    purities = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
        line = [l for l in out.decode().splitlines() if l.startswith("PURITY=")]
        purities.append(eval(line[0][7:]))
    assert purities[0] == purities[1] == single
    a = (tmp_path / "single_purity.out").read_text()
    b = (tmp_path / "dist_purity.out").read_text()
    assert a == b


WORKER_COMBO = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["LPS_MULTICHIP"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    cfg = PhaseConfig(**json.loads(cfg_json), dist=spec)
    run_phase(cfg)
""")


def test_distributed_multichip_checkpointed_phase(fix, tmp_path):
    """All three scaling/robustness features at once: 2 jax.distributed
    processes, each running the mesh-batched multichip engine over 4 local
    virtual devices, writing per-contig checkpoints — output must match a
    plain single-process oracle run, and a re-run must resume everything
    from the checkpoints."""
    single = tmp_path / "single"
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=str(single),
                          num_threads=2, is_pb=True, engine="oracle"))

    ckpt = str(tmp_path / "ckpt")
    cfg = dict(snp_file=fix["vcf"], bam_files=[fix["bam"]],
               fasta_file=fix["fasta"],
               result_prefix=str(tmp_path / "combo"),
               num_threads=1, is_pb=True, engine="device",
               checkpoint_dir=ckpt)

    def run_pair():
        port = _free_port()
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", WORKER_COMBO, json.dumps(cfg),
                 f"127.0.0.1:{port},2,{pid}"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in (0, 1)
        ]
        outs = _communicate_all(procs)
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err.decode()[-2000:]
        return outs

    run_pair()
    assert _vcf_body(tmp_path / "combo.vcf") == _vcf_body(f"{single}.vcf")
    # second run resumes every contig from the checkpoints
    outs = run_pair()
    assert any(b"checkpoint: resumed" in err for _o, err in outs)
    assert _vcf_body(tmp_path / "combo.vcf") == _vcf_body(f"{single}.vcf")


WORKER_SOMATIC = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.somatic import SomaticConfig, run_somatic_haplotag
    cfg = SomaticConfig(**json.loads(cfg_json), dist=spec)
    run_somatic_haplotag(cfg)
""")


def test_two_process_somatic_haplotag_matches_single(tmp_path):
    """Distributed somatic_haplotag: contig-sharded extraction/calling/
    tagging with purity-point, flag and tag-segment all-gathers must
    reproduce the single-process tagged BAM and _sc.vcf exactly."""
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.somatic import SomaticConfig, run_somatic_haplotag
    from longphase_s_jax.testing.simulate import make_multichrom_somatic_fixture

    fix = make_multichrom_somatic_fixture(str(tmp_path / "fix"), seed=82,
                                          n_chroms=3)
    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["normal_vcf"],
                          bam_files=[fix["normal_bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          num_threads=2, is_pb=True, engine="oracle"))
    base = dict(snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
                bam_file=fix["normal_bam"],
                tumor_bam_file=fix["tumor_bam"],
                fasta_file=fix["fasta"], write_somatic_vcf=True)
    run_somatic_haplotag(SomaticConfig(
        **base, result_prefix=str(tmp_path / "single")))

    port = _free_port()
    cfg = dict(base, result_prefix=str(tmp_path / "dist"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER_SOMATIC, json.dumps(cfg),
             f"127.0.0.1:{port},2,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = _communicate_all(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]

    def tags(path):
        return [(r.qname, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(path)]

    assert tags(str(tmp_path / "dist.bam")) == \
        tags(str(tmp_path / "single.bam"))
    a = [l for l in open(tmp_path / "single_sc.vcf")
         if not l.startswith("##commandline")]
    b = [l for l in open(tmp_path / "dist_sc.vcf")
         if not l.startswith("##commandline")]
    assert a == b


WORKER_HAPLOTAG = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
    cfg = HaplotagConfig(**json.loads(cfg_json), dist=spec)
    run_haplotag(cfg)
""")


def test_two_process_haplotag_matches_single(fix, tmp_path):
    """Distributed germline haplotag: sharded tag walks, gathered segments,
    process-0 write — tagged BAM identical to single-process."""
    from longphase_s_jax.io.bam import BamReader
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag

    phased = str(tmp_path / "phased")
    run_phase(PhaseConfig(snp_file=fix["vcf"], bam_files=[fix["bam"]],
                          fasta_file=fix["fasta"], result_prefix=phased,
                          num_threads=2, is_pb=True, engine="oracle"))
    base = dict(snp_file=phased + ".vcf", bam_file=fix["bam"],
                fasta_file=fix["fasta"])
    run_haplotag(HaplotagConfig(**base,
                                result_prefix=str(tmp_path / "single")))

    port = _free_port()
    cfg = dict(base, result_prefix=str(tmp_path / "dist"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER_HAPLOTAG, json.dumps(cfg),
             f"127.0.0.1:{port},2,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = _communicate_all(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]

    def tags(path):
        return [(r.qname, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(path)]

    assert tags(str(tmp_path / "dist.bam")) == \
        tags(str(tmp_path / "single.bam"))


WORKER_MODCALL = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "/root/repo")
    import jax
    jax.config.update("jax_platforms", "cpu")
    cfg_json, spec = sys.argv[1], sys.argv[2]
    from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
    cfg = ModCallConfig(**json.loads(cfg_json), dist=spec)
    run_modcall(cfg)
""")


def test_two_process_modcall_matches_single(tmp_path):
    """Distributed modcall: sharded per-chromosome calling, gathered
    result lines, process-0 VCF — identical to single-process."""
    from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
    from longphase_s_jax.testing.simulate import make_multichrom_meth_fixture

    try:
        fix = make_multichrom_meth_fixture(str(tmp_path / "fix"), seed=5,
                                           n_chroms=3)
    except (ImportError, AttributeError):
        from longphase_s_jax.testing.simulate import make_meth_fixture

        fix = make_meth_fixture(str(tmp_path / "fix"), seed=5)
    base = dict(bam_files=[fix["bam"]], fasta_file=fix["fasta"],
                snp_file=fix.get("vcf", ""))
    run_modcall(ModCallConfig(**base,
                              result_prefix=str(tmp_path / "single")))

    port = _free_port()
    cfg = dict(base, result_prefix=str(tmp_path / "dist"))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER_MODCALL, json.dumps(cfg),
             f"127.0.0.1:{port},2,{pid}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)
    ]
    outs = _communicate_all(procs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]

    a = [l for l in open(tmp_path / "single.vcf")
         if not l.startswith("##commandline")]
    b = [l for l in open(tmp_path / "dist.vcf")
         if not l.startswith("##commandline")]
    assert a == b and len(a) > 10
