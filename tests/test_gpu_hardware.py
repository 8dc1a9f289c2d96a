"""Device-path test on a real NVIDIA card (marker ``gpu``).

The hermetic CPU suite runs the vote-scan kernel only under the Pallas
interpreter; this test runs the fused device phase compiled for the GPU, in
a subprocess (the suite's conftest pins this process to the CPU), and
compares the VCF with the host oracle. It skips where JAX finds no GPU.
On a machine with a card: ``python -m pytest tests/test_gpu_hardware.py``.
chip_smoke.py runs the same checks at larger sizes."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[3])
    import jax
    if jax.devices()[0].platform != "gpu":
        sys.exit(42)  # no card: skip
    os.environ["LPS_MULTICHIP"] = "0"
    fix = json.loads(sys.argv[1])
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    def go(engine):
        return run_phase(PhaseConfig(
            snp_file=fix["vcf"], bam_files=[fix["bam"]],
            fasta_file=fix["fasta"], result_prefix=sys.argv[2] + "/" + engine,
            num_threads=1, is_pb=True, engine=engine))
    device, oracle = go("device"), go("oracle")
    assert device == oracle, "device phase != oracle"
    print(f"DEVICE_OK sites={len(device)}")
""")


@pytest.mark.gpu
def test_fused_device_phase_on_gpu(small_fixture, tmp_path):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    fix = {k: small_fixture[k] for k in ("vcf", "bam", "fasta")}
    r = subprocess.run(
        [sys.executable, "-c", WORKER, json.dumps(fix), str(tmp_path), ROOT],
        env=env, capture_output=True, timeout=600)
    if r.returncode == 42 or b"Unable to initialize backend" in r.stderr:
        pytest.skip("no NVIDIA GPU visible to JAX")
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert b"DEVICE_OK" in r.stdout
