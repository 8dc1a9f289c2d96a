#!/usr/bin/env python
"""WGS-scale soak: chr20-like chromosome through phase + haplotag.

Builds a >=64 Mbp single-chromosome fixture with >=300k het sites
(chr20-scale: ~1 het / 200 bp at snp_rate 0.005), then drives:

  1. our `phase` on the device path — power-of-two bucketing puts the
     site axis at S_pad = 2^19;
  2. the reference binary `phase` (all cores) — VCF must be identical;
  3. our `haplotag` whole-file path, then the bounded-memory streaming
     path (LPS_MAX_INMEM_BAM) — tagged records must be identical;
  4. the wavefront site-sharded scan on a virtual 8-device CPU mesh —
     VCF must equal the device run.

Each step runs in a subprocess that reports its own wall time and peak
RSS. Results land in <workdir>/wgs_soak.md.

Usage: python tools/wgs_soak.py [workdir] [--skip-wavefront]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_BIN = os.path.join(ROOT, ".refbuild", "longphase-s")

CFG = dict(seed=33, length=64_000_000, coverage=20, read_len=12000,
           snp_rate=0.005, error_rate=0.04, qual=22)

CHILD = textwrap.dedent("""
    import json, resource, sys, time
    sys.path.insert(0, %r)
    spec = json.loads(sys.argv[1])
    from longphase_s_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import importlib
    mod = importlib.import_module(spec["module"])
    fn = getattr(mod, spec["fn"])
    cfg_cls = getattr(mod, spec["cfg_cls"])
    # warm-up run: page cache, jit compile(+cache load) — the timed number
    # is the steady-state wall, like bench.py's warm-up + best-of protocol
    fn(cfg_cls(**spec["cfg"]))
    t0 = time.monotonic()
    fn(cfg_cls(**spec["cfg"]))
    wall = time.monotonic() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps({"wall_s": round(wall, 2),
                      "peak_rss_gb": round(rss, 2)}))
""" % ROOT)


def run_child(spec, env_extra=None, timeout=7200):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, "-c", CHILD, json.dumps(spec)],
                       env=env, capture_output=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"child failed: {r.stderr.decode()[-3000:]}")
    return json.loads(r.stdout.decode().splitlines()[-1])


def get_fixture(work):
    marker = os.path.join(work, "fixture.json")
    if os.path.exists(marker):
        with open(marker) as f:
            meta = json.load(f)
        if meta.get("cfg") == {k: str(v) for k, v in CFG.items()} and all(
                os.path.exists(meta[k]) for k in ("bam", "vcf", "fasta")):
            return meta
    print("simulating 64 Mbp fixture (~15 min)...", flush=True)
    from longphase_s_jax.testing.simulate import make_fixture
    fix = make_fixture(os.path.join(work, "fix"), **CFG)
    meta = {"bam": fix["bam"], "vcf": fix["vcf"], "fasta": fix["fasta"],
            "chrom": fix["chrom"], "n_reads": len(fix["reads"]),
            "n_sites": len(fix["variants"]),
            "cfg": {k: str(v) for k, v in CFG.items()}}
    with open(marker, "w") as f:
        json.dump(meta, f)
    return meta


def strip_vcf(path):
    with open(path) as f:
        return [l for l in f
                if not l.startswith("##longphase")
                and not l.startswith("##commandline")]


def tags_digest(path):
    import hashlib

    from longphase_s_jax.io.bam import BamReader
    h = hashlib.sha256()
    r = BamReader(path)
    for rec in r:
        h.update(repr((rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                       rec.get_tag("PS"), rec.get_tag("PQ"))).encode())
    r.close()
    return h.hexdigest()


PHASEMEM_CFG = dict(seed=53, length=250_000_000, coverage=20,
                    read_len=12000, snp_rate=0.001, error_rate=0.03,
                    qual=22)


def get_phasemem_fixture(work):
    """250 Mbp single chromosome — real-chr1 scale."""
    marker = os.path.join(work, "fixture_phasemem.json")
    if os.path.exists(marker):
        with open(marker) as f:
            meta = json.load(f)
        if meta.get("cfg") == {k: str(v) for k, v in PHASEMEM_CFG.items()}:
            return meta
    print("simulating 250 Mbp fixture (~1-2 h)...", flush=True)
    from longphase_s_jax.testing.simulate import make_fixture
    fix = make_fixture(os.path.join(work, "fix_pm"), **PHASEMEM_CFG)
    meta = {"bam": fix["bam"], "vcf": fix["vcf"], "fasta": fix["fasta"],
            "chrom": fix["chrom"], "n_reads": len(fix["reads"]),
            "n_sites": len(fix["variants"]),
            "cfg": {k: str(v) for k, v in PHASEMEM_CFG.items()}}
    with open(marker, "w") as f:
        json.dump(meta, f)
    return meta


def run_phase_mem_soak(work, rows):
    """Phase at real-chromosome scale with the RAM budget forced down:
    the streaming path must stay under 8 GB peak RSS with
    a VCF identical to the whole-file path and the reference binary."""
    import time

    fix = get_phasemem_fixture(work)
    spec = {"module": "longphase_s_jax.models.phase", "fn": "run_phase",
            "cfg_cls": "PhaseConfig",
            "cfg": {"snp_file": fix["vcf"], "bam_files": [fix["bam"]],
                    "fasta_file": fix["fasta"], "is_pb": True,
                    "engine": "device"}}
    whole = os.path.join(work, "pm_whole")
    spec["cfg"]["result_prefix"] = whole
    rows["phasemem_whole"] = run_child(
        dict(spec))
    print("phasemem_whole:", rows["phasemem_whole"], flush=True)
    stream = os.path.join(work, "pm_stream")
    spec["cfg"]["result_prefix"] = stream
    rows["phasemem_stream"] = run_child(
        dict(spec), env_extra={"LPS_MAX_INMEM_BAM": str(256 << 20)})
    print("phasemem_stream:", rows["phasemem_stream"], flush=True)
    rows["phasemem_stream_rss_under_8gb"] = (
        rows["phasemem_stream"]["peak_rss_gb"] < 8.0)
    if os.path.exists(REF_BIN):
        golden = os.path.join(work, "pm_golden")
        t0 = time.monotonic()
        subprocess.run([REF_BIN, "phase", "--pb", "-s", fix["vcf"],
                        "-b", fix["bam"], "-r", fix["fasta"], "-o", golden,
                        "-t", str(os.cpu_count())],
                       check=True, capture_output=True, timeout=14400)
        rows["phasemem_ref"] = {"wall_s": round(time.monotonic() - t0, 2)}
        rows["phasemem_ref_identical"] = (
            strip_vcf(golden + ".vcf") == strip_vcf(stream + ".vcf"))
        print("phasemem_ref:", rows["phasemem_ref"], flush=True)
    rows["phasemem_stream_identical"] = (
        strip_vcf(whole + ".vcf") == strip_vcf(stream + ".vcf"))
    print("phasemem identical:", rows["phasemem_stream_identical"],
          flush=True)


SOMATIC_CFG = dict(seed=37, length=32_000_000, normal_coverage=25,
                   tumor_coverage=30, purity=0.6, n_somatic=2500,
                   n_artifacts=600, read_len=12000, snp_rate=0.0012,
                   error_rate=0.02, qual=25)


def get_somatic_fixture(work):
    marker = os.path.join(work, "fixture_somatic.json")
    if os.path.exists(marker):
        with open(marker) as f:
            meta = json.load(f)
        if meta.get("cfg") == {k: str(v) for k, v in SOMATIC_CFG.items()}:
            return meta
    print("simulating 32 Mbp tumor/normal pair (~30 min)...", flush=True)
    from longphase_s_jax.testing.simulate import make_somatic_fixture
    fix = make_somatic_fixture(os.path.join(work, "fix_som"), **SOMATIC_CFG)
    meta = {k: fix[k] for k in ("normal_bam", "tumor_bam", "normal_vcf",
                                "tumor_vcf", "fasta", "chrom")}
    meta["cfg"] = {k: str(v) for k, v in SOMATIC_CFG.items()}
    with open(marker, "w") as f:
        json.dump(meta, f)
    return meta


def run_somatic_soak(work, rows):
    """somatic_haplotag at WGS scale (HCC1395-chr20-like pair): ours vs the
    reference binary, _sc.vcf + tagged records must be identical."""
    import time

    fix = get_somatic_fixture(work)
    phased = os.path.join(work, "som_phased")
    if not os.path.exists(phased + ".vcf"):
        subprocess.run([REF_BIN, "phase", "--pb", "-s", fix["normal_vcf"],
                        "-b", fix["normal_bam"], "-r", fix["fasta"],
                        "-o", phased, "-t", str(os.cpu_count())],
                       check=True, capture_output=True, timeout=7200)
    golden = os.path.join(work, "som_golden")
    t0 = time.monotonic()
    subprocess.run([REF_BIN, "somatic_haplotag", "-s", phased + ".vcf",
                    "--tumor-snv-file", fix["tumor_vcf"],
                    "-b", fix["normal_bam"],
                    "--tumor-bam-file", fix["tumor_bam"],
                    "-r", fix["fasta"], "--output-somatic-vcf",
                    "-o", golden, "-t", str(os.cpu_count())],
                   check=True, capture_output=True, timeout=7200)
    rows["somatic_ref"] = {"wall_s": round(time.monotonic() - t0, 2)}
    ours = os.path.join(work, "som_ours")
    rows["somatic_ours"] = run_child(
        {"module": "longphase_s_jax.models.somatic",
         "fn": "run_somatic_haplotag", "cfg_cls": "SomaticConfig",
         "cfg": {"snp_file": phased + ".vcf",
                 "tumor_snv_file": fix["tumor_vcf"],
                 "bam_file": fix["normal_bam"],
                 "tumor_bam_file": fix["tumor_bam"],
                 "fasta_file": fix["fasta"], "result_prefix": ours,
                 "write_somatic_vcf": True}})
    rows["somatic_speedup"] = round(
        rows["somatic_ref"]["wall_s"] / rows["somatic_ours"]["wall_s"], 2)
    rows["somatic_sc_vcf_identical"] = (
        strip_vcf(golden + "_sc.vcf") == strip_vcf(ours + "_sc.vcf"))
    rows["somatic_tags_identical"] = (tags_digest(golden + ".bam")
                                      == tags_digest(ours + ".bam"))
    print("somatic:", {k: rows[k] for k in
                       ("somatic_ref", "somatic_ours", "somatic_speedup",
                        "somatic_sc_vcf_identical",
                        "somatic_tags_identical")}, flush=True)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    skip_wave = "--skip-wavefront" in sys.argv
    work = args[0] if args else os.path.join(ROOT, ".bench_cache", "wgs_soak")
    os.makedirs(work, exist_ok=True)
    if "--phase-mem" in sys.argv:
        rows = {}
        run_phase_mem_soak(work, rows)
        md_path = os.path.join(work, "wgs_soak.md")
        with open(md_path) as f:
            body = f.read()
        body += ("\n## Phase memory proof (250 Mbp chromosome)\n\n```json\n"
                 + json.dumps(rows, indent=2) + "\n```\n")
        with open(md_path, "w") as f:
            f.write(body)
        print("appended phase-mem soak to wgs_soak.md")
        return 0 if rows["phasemem_stream_identical"] else 1
    if "--somatic-only" in sys.argv:
        rows = {}
        run_somatic_soak(work, rows)
        md_path = os.path.join(work, "wgs_soak.md")
        with open(md_path) as f:
            body = f.read()
        body += ("\n## Somatic soak (32 Mbp tumor/normal pair)\n\n```json\n"
                 + json.dumps(rows, indent=2) + "\n```\n")
        with open(md_path, "w") as f:
            f.write(body)
        print("appended somatic soak to wgs_soak.md")
        return 0 if (rows["somatic_sc_vcf_identical"]
                     and rows["somatic_tags_identical"]) else 1
    fix = get_fixture(work)
    rows = {}

    # --- 1. our phase, device engine ---
    ours_phase = os.path.join(work, "ours_phase")
    rows["phase_device"] = run_child(
        {"module": "longphase_s_jax.models.phase", "fn": "run_phase",
         "cfg_cls": "PhaseConfig",
         "cfg": {"snp_file": fix["vcf"], "bam_files": [fix["bam"]],
                 "fasta_file": fix["fasta"], "result_prefix": ours_phase,
                 "is_pb": True, "engine": "device"}})
    rows["phase_device"]["sites_per_s"] = round(
        fix["n_sites"] / rows["phase_device"]["wall_s"], 1)
    print("phase_device:", rows["phase_device"], flush=True)

    # --- 2. reference phase ---
    if os.path.exists(REF_BIN):
        import time
        golden = os.path.join(work, "golden_phase")
        t0 = time.monotonic()
        subprocess.run([REF_BIN, "phase", "--pb", "-s", fix["vcf"],
                        "-b", fix["bam"], "-r", fix["fasta"], "-o", golden,
                        "-t", str(os.cpu_count())],
                       check=True, capture_output=True, timeout=7200)
        rows["phase_ref"] = {"wall_s": round(time.monotonic() - t0, 2)}
        rows["phase_ref"]["sites_per_s"] = round(
            fix["n_sites"] / rows["phase_ref"]["wall_s"], 1)
        identical = strip_vcf(golden + ".vcf") == strip_vcf(
            ours_phase + ".vcf")
        rows["phase_vcf_identical"] = identical
        print("phase_ref:", rows["phase_ref"], "identical:", identical,
              flush=True)

    # --- 3. haplotag: whole-file, then bounded-memory streaming ---
    phased_vcf = ours_phase + ".vcf"
    tag_whole = os.path.join(work, "tag_whole")
    rows["haplotag_whole"] = run_child(
        {"module": "longphase_s_jax.models.haplotag", "fn": "run_haplotag",
         "cfg_cls": "HaplotagConfig",
         "cfg": {"snp_file": phased_vcf, "bam_file": fix["bam"],
                 "fasta_file": fix["fasta"], "result_prefix": tag_whole}})
    rows["haplotag_whole"]["reads_per_s"] = round(
        fix["n_reads"] / rows["haplotag_whole"]["wall_s"], 1)
    print("haplotag_whole:", rows["haplotag_whole"], flush=True)

    tag_stream = os.path.join(work, "tag_stream")
    rows["haplotag_stream"] = run_child(
        {"module": "longphase_s_jax.models.haplotag", "fn": "run_haplotag",
         "cfg_cls": "HaplotagConfig",
         "cfg": {"snp_file": phased_vcf, "bam_file": fix["bam"],
                 "fasta_file": fix["fasta"], "result_prefix": tag_stream}},
        env_extra={"LPS_MAX_INMEM_BAM": str(64 << 20)})
    rows["haplotag_stream"]["reads_per_s"] = round(
        fix["n_reads"] / rows["haplotag_stream"]["wall_s"], 1)
    rows["stream_tags_identical"] = (tags_digest(tag_whole + ".bam")
                                     == tags_digest(tag_stream + ".bam"))
    print("haplotag_stream:", rows["haplotag_stream"], "identical:",
          rows["stream_tags_identical"], flush=True)

    # --- 4. wavefront on the virtual 8-device CPU mesh ---
    if not skip_wave:
        wave = os.path.join(work, "ours_wave")
        rows["phase_wavefront_cpu8"] = run_child(
            {"module": "longphase_s_jax.models.phase", "fn": "run_phase",
             "cfg_cls": "PhaseConfig",
             "cfg": {"snp_file": fix["vcf"], "bam_files": [fix["bam"]],
                     "fasta_file": fix["fasta"], "result_prefix": wave,
                     "is_pb": True, "engine": "device"}},
            env_extra={"JAX_PLATFORMS": "cpu", "LPS_WAVEFRONT": "1",
                       "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
        rows["wavefront_vcf_identical"] = (
            strip_vcf(wave + ".vcf") == strip_vcf(ours_phase + ".vcf"))
        print("wavefront:", rows["phase_wavefront_cpu8"], "identical:",
              rows["wavefront_vcf_identical"], flush=True)

    md = ["# WGS-scale soak (64 Mbp / "
          f"{fix['n_sites']:,} het sites / {fix['n_reads']:,} reads)",
          "",
          "`tools/wgs_soak.py` — chr20-scale single chromosome, "
          "S_pad = 2^19 (128x the 4096-site Pallas block; carry-chained "
          "block sequence), whole-file and bounded-memory streaming paths.",
          "", "```json", json.dumps(rows, indent=2), "```", ""]
    with open(os.path.join(work, "wgs_soak.md"), "w") as f:
        f.write("\n".join(md))
    print("wrote wgs_soak.md")
    ok = rows.get("phase_vcf_identical", True) and \
        rows.get("stream_tags_identical", True) and \
        rows.get("wavefront_vcf_identical", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
