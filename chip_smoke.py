#!/usr/bin/env python
"""Smoke test of the whole system on an NVIDIA GPU.

    python chip_smoke.py              # one card, phases 0-4
    python chip_smoke.py --cards 4    # four cards: the multi-card paths only

Drives all five subcommands through ``cli.main`` with every device kernel
compiled for the card, and compares each with the repository's own
references. Every comparison is exact equality: the device code works in
small integers, or in f32 products of small integers that f32 represents
exactly, so there is no tolerance to state.

  0. identity: device, nvidia-smi name and power limit, JAX version, the
     native host library (and whether it links libdeflate);
  1. phase at bench scale (bench.PHASE_CFG: 12 Mbp, 30x, Gram pair pack):
     device engine = oracle, and the scan kernel against the lax.scan
     engine end to end;
  2. phase on the 120 kbp test fixture (scatter pack, read correction on
     the device) = oracle;
  3. tag-family reductions, LPS_TAG_ENGINE=device against =host: haplotag,
     somatic_haplotag, estimate_purity, modcall;
  4. the scan kernel against vote_scan_core at S_pad 16384 and 2^19, the
     GEMM route XLA chose for the int8 Gram, and the phase step's memory.

With ``--cards 4``: run_phase on a multi-chromosome fixture over the
chromosome mesh, the site-sharded wavefront and one card (identical), and
the somatic reductions on the mesh against one device.

Fixtures are simulated from seeds into .bench_cache/ (gitignored), in
worker processes that never touch the card. The last line of standard
output is one JSON object with "ok" and the device; the script exits
non-zero, with no such line, where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SMALL_CFG = dict(seed=7, length=120_000, coverage=20, read_len=12000,
                 snp_rate=0.001)  # tests/conftest.py small_fixture
# bench.SOMATIC_CFG / METH_CFG cut from 5 and 6 Mbp to 2 Mbp each (the
# somatic and ASM site counts scaled alike) to fit the run's time limit
SOMATIC_CFG = dict(seed=21, length=2_000_000, normal_coverage=25,
                   tumor_coverage=30, purity=0.6, n_somatic=160,
                   n_artifacts=40, read_len=12000, snp_rate=0.0012,
                   error_rate=0.02, qual=25)
METH_CFG = dict(seed=22, length=2_000_000, coverage=25, read_len=10000,
                snp_rate=0.0012, n_asm=160, n_homo_mod=80, qual=30)
MULTI_CFG = dict(seed=13, n_chroms=6, base_length=1_000_000, coverage=20,
                 read_len=12000)
SCAN_SIZES = ((16384, 3), (1 << 19, 1))  # (S_pad, timed repetitions)


def _mbp(cfg) -> str:
    return f"{cfg['length'] / 1e6:g} Mbp"


# ---------------------------------------------------------------------------
# worker-process jobs (no JAX): fixtures and the native library build
# ---------------------------------------------------------------------------

def _fixture(kind: str) -> dict:
    import bench
    from longphase_s_jax.testing import simulate

    maker, cfg = {
        "phase": (simulate.make_fixture, bench.PHASE_CFG),
        "small": (simulate.make_fixture, SMALL_CFG),
        "somatic": (simulate.make_somatic_fixture, SOMATIC_CFG),
        "meth": (simulate.make_meth_fixture, METH_CFG),
        "multi": (simulate.make_multichrom_fixture, MULTI_CFG),
    }[kind]
    return bench._cached_fixture(f"smoke_{kind}", cfg, maker)


def _build_native():
    from longphase_s_jax import native

    return native.available(), native.with_libdeflate()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.out = os.path.join(ROOT, ".bench_cache", "chip_smoke_out")
        os.makedirs(self.out, exist_ok=True)

    def check(self, name: str, ok: bool) -> bool:
        print(f"    {name}: {'identical' if ok else 'DIFFERENT'}", flush=True)
        if not ok:
            self.failed.append(name)
        return ok

    def path(self, name: str) -> str:
        return os.path.join(self.out, name)


def _phase_line(phase, what, t0):
    print(f"[phase {phase}] {what} ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def _text(path):
    """A text output without the lines that name the command or prefix."""
    with open(path) as f:
        return [line for line in f if not line.startswith(
            ("##commandline", "##resultPrefix"))]


def _tags(bam_path):
    from longphase_s_jax.io.bam import BamReader

    r = BamReader(bam_path)
    out = [(rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
            rec.get_tag("PS"), rec.get_tag("PQ")) for rec in r]
    r.close()
    return out


def _cli(*argv):
    from longphase_s_jax import cli

    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    if rc:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def _phase(fix, prefix, *extra):
    return _cli("phase", "--pb", "-s", fix["vcf"], "-b", fix["bam"],
                "-r", fix["fasta"], "-o", prefix, *extra)


def _n_phased(vcf_path):
    n = 0
    with open(vcf_path) as f:
        for line in f:
            if not line.startswith("#") and "|" in line.split("\t")[9]:
                n += 1
    return n


def _nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def _best(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase4_kernel(smoke: Smoke):
    """Scan kernel vs vote_scan_core at real widths; the Gram's GEMM
    route; the phase step's compiled memory."""
    import jax
    import numpy as np

    from longphase_s_jax.ops.fused import mxu_phase_jit
    from longphase_s_jax.ops.scan_kernel import vote_scan_kernel_pc
    from longphase_s_jax.ops.vote_scan import pair_sums, vote_scan_core

    t0 = time.perf_counter()
    W = 35
    kw = dict(window=W, distance=300000, edge_threshold_x10=7.0)
    def kernel(ch, cl, *rest, window, distance, edge_threshold_x10):
        return vote_scan_kernel_pc(*pair_sums(ch, cl), *rest, window=window,
                                   distance=distance,
                                   edge_threshold_x10=edge_threshold_x10)

    ref_j = jax.jit(vote_scan_core, static_argnames=tuple(kw))
    ker_j = jax.jit(kernel, static_argnames=tuple(kw))
    for S, reps in SCAN_SIZES:
        rng = np.random.default_rng(S)
        args = [jax.device_put(x) for x in (
            rng.integers(0, 30, (S, W, 4)).astype(np.int32),
            rng.integers(0, 8, (S, W, 4)).astype(np.int32),
            rng.integers(1, 400000, S).astype(np.int32),
            rng.integers(0, 5, S).astype(np.int8),
            rng.integers(0, 5, (S, W)).astype(np.int8),
            (np.arange(S)[:, None] + np.arange(1, W + 1)) < S - 3)]
        t_k = _best(lambda: ker_j(*args, **kw), reps)
        t_r = _best(lambda: ref_j(*args, **kw), reps)
        got, ref = ker_j(*args, **kw), ref_j(*args, **kw)
        same = all(bool((np.asarray(a) == np.asarray(b)).all())
                   for a, b in zip(got, ref))
        print(f"    S_pad={S}: kernel {t_k * 1e3:.3f} ms, lax.scan "
              f"vote_scan_core {t_r * 1e3:.3f} ms "
              f"({t_r / t_k:.1f}x), assigned "
              f"{int(np.asarray(ref[0]).sum())}", flush=True)
        smoke.check(f"scan kernel = vote_scan_core at S_pad={S}", same)

    # the production phase step at bench scale (S_pad 16384, ~30x)
    S_pad, T, R = 16384, 16384 // 128, 64
    rng = np.random.default_rng(3)
    bits = jax.device_put(rng.integers(0, 256, (T, R, (128 + W + 1) // 2))
                          .astype(np.uint8) & 0x77)
    vtype = jax.device_put(np.zeros(S_pad, np.int8))
    pos = jax.device_put((np.arange(S_pad) * 150).astype(np.int32))
    step_kw = dict(S=S_pad - 7, window=W, distance=300000,
                   edge_threshold_x10=7.0, engine="kernel")
    compiled = mxu_phase_jit.lower(bits, vtype, pos, **step_kw).compile()
    txt = compiled.as_text()
    routes = sorted(set(re.findall(r'"kind":"(__[A-Za-z_$]+)"', txt))
                    | set(re.findall(r'custom_call_target="([^"]+)"', txt)))
    print(f"    Gram GEMM route (int8 [T,{R},{128 + W}] batched dot): "
          f"{', '.join(routes) or 'no library or Triton GEMM'}", flush=True)
    print(f"    phase step memory: {compiled.memory_analysis()}", flush=True)
    t_step = _best(lambda: mxu_phase_jit(bits, vtype, pos, **step_kw), 3)
    print(f"    phase step (Gram pack + kernel scan + assembly) at S_pad="
          f"{S_pad}: {t_step * 1e3:.3f} ms", flush=True)
    _phase_line(4, "kernel against reference at real widths", t0)


def phase2_small(smoke: Smoke, fix):
    from longphase_s_jax.ops import fused

    t0 = time.perf_counter()
    _phase(fix, smoke.path("small_device"))
    route = dict(fused.last_route)
    _phase(fix, smoke.path("small_oracle"), "--engine", "oracle")
    smoke.check("120 kbp phase: device VCF = oracle VCF",
                _text(smoke.path("small_device.vcf"))
                == _text(smoke.path("small_oracle.vcf")))
    print(f"    route: pack={route.get('pack')} scan={route.get('scan')}, "
          f"{_n_phased(smoke.path('small_device.vcf'))} phased sites",
          flush=True)
    _phase_line(2, "phase on the 120 kbp test fixture", t0)


def phase1_bench(smoke: Smoke, fix):
    from longphase_s_jax.ops import fused, vote_scan

    t0 = time.perf_counter()
    dev = smoke.path("bench_device")
    cold = _phase(fix, dev)
    warm = _phase(fix, dev)
    route = dict(fused.last_route)
    print(f"    device engine: cold {cold:.2f} s, warm {warm:.2f} s; route "
          f"pack={route.get('pack')} scan={route.get('scan')} "
          f"S_pad={route.get('S_pad')} observations={route.get('No')}; "
          f"{_n_phased(dev + '.vcf')} phased sites", flush=True)

    # the same run with the lax.scan engine on the card: the measurement
    # that keeps (or removes) the scan kernel
    lax = smoke.path("bench_lax")
    saved = vote_scan.scan_engine
    vote_scan.scan_engine = lambda: "lax"
    try:
        cold_l = _phase(fix, lax)
        warm_l = _phase(fix, lax)
    finally:
        vote_scan.scan_engine = saved
    print(f"    lax.scan engine: cold {cold_l:.2f} s, warm {warm_l:.2f} s "
          f"(kernel engine warm {warm:.2f} s)", flush=True)
    smoke.check("bench phase: lax.scan engine VCF = kernel engine VCF",
                _text(lax + ".vcf") == _text(dev + ".vcf"))

    orc = smoke.path("bench_oracle")
    t_o = _phase(fix, orc, "--engine", "oracle")
    print(f"    oracle: {t_o:.2f} s", flush=True)
    smoke.check("bench phase: device VCF = oracle VCF",
                _text(dev + ".vcf") == _text(orc + ".vcf"))
    import bench

    _phase_line(1, f"phase at bench scale ({_mbp(bench.PHASE_CFG)}, "
                f"{bench.PHASE_CFG['coverage']}x)", t0)


def _both_tag_engines(run):
    out = {}
    for eng in ("device", "host"):
        os.environ["LPS_TAG_ENGINE"] = eng
        try:
            out[eng] = run(eng)
        finally:
            os.environ.pop("LPS_TAG_ENGINE", None)
    return out


def phase3_tags(smoke: Smoke, bench_fix, som, meth):
    t0 = time.perf_counter()
    phased = smoke.path("bench_device.vcf")

    def haplotag(eng):
        prefix = smoke.path(f"hap_{eng}")
        secs = _cli("haplotag", "-s", phased, "-b", bench_fix["bam"],
                    "-r", bench_fix["fasta"], "-o", prefix)
        return secs, _tags(prefix + ".bam")

    r = _both_tag_engines(haplotag)
    import bench

    print(f"    haplotag ({_mbp(bench.PHASE_CFG)}, {len(r['host'][1])} "
          f"records): device "
          f"{r['device'][0]:.2f} s, host {r['host'][0]:.2f} s", flush=True)
    smoke.check("haplotag tags: device = host",
                r["device"][1] == r["host"][1])

    som_vcf = smoke.path("som_normal_phased")
    _cli("phase", "--pb", "-s", som["normal_vcf"], "-b", som["normal_bam"],
         "-r", som["fasta"], "-o", som_vcf)
    pair = ("-s", som_vcf + ".vcf", "--tumor-snv-file", som["tumor_vcf"],
            "-b", som["normal_bam"], "--tumor-bam-file", som["tumor_bam"],
            "-r", som["fasta"])

    def somatic(eng):
        prefix = smoke.path(f"som_{eng}")
        secs = _cli("somatic_haplotag", *pair, "-o", prefix,
                    "--output-somatic-vcf")
        return secs, _text(prefix + "_sc.vcf"), _tags(prefix + ".bam")

    r = _both_tag_engines(somatic)
    print(f"    somatic_haplotag ({_mbp(SOMATIC_CFG)}, "
          f"{SOMATIC_CFG['normal_coverage']}x normal / "
          f"{SOMATIC_CFG['tumor_coverage']}x tumor): device "
          f"{r['device'][0]:.2f} s, host {r['host'][0]:.2f} s", flush=True)
    smoke.check("somatic_haplotag _sc.vcf and tags: device = host",
                r["device"][1:] == r["host"][1:])

    def purity(eng):
        prefix = smoke.path(f"pur_{eng}")
        secs = _cli("estimate_purity", *pair, "-o", prefix)
        return secs, _text(prefix + "_purity.out")

    r = _both_tag_engines(purity)
    print(f"    estimate_purity (same pair): device {r['device'][0]:.2f} s, "
          f"host {r['host'][0]:.2f} s", flush=True)
    smoke.check("estimate_purity _purity.out: device = host",
                r["device"][1] == r["host"][1])

    def modcall(eng):
        prefix = smoke.path(f"mod_{eng}")
        secs = _cli("modcall", "-b", meth["bam"], "-r", meth["fasta"],
                    "-s", meth["vcf"], "-o", prefix)
        return secs, _text(prefix + ".vcf")

    r = _both_tag_engines(modcall)
    print(f"    modcall ({_mbp(METH_CFG)}, {METH_CFG['coverage']}x, "
          f"{len(r['host'][1])} VCF lines): device "
          f"{r['device'][0]:.2f} s, host {r['host'][0]:.2f} s", flush=True)
    smoke.check("modcall VCF: device = host", r["device"][1] == r["host"][1])
    _phase_line(3, "tag-family reductions on the device", t0)


def cards4(smoke: Smoke, fix):
    """Multi-card phase three ways, and the somatic reductions on the mesh
    against one device."""
    import jax
    import numpy as np

    from longphase_s_jax.ops import tag_kernels as tk
    from longphase_s_jax.parallel.mesh import make_mesh
    from longphase_s_jax.testing.simulate import random_somatic_items

    t0 = time.perf_counter()
    runs = {}
    for name, env in (("mesh", {"LPS_MULTICHIP": "1", "LPS_WAVEFRONT": "0"}),
                      ("wavefront", {"LPS_MULTICHIP": "1",
                                     "LPS_WAVEFRONT": "1"}),
                      ("one_card", {"LPS_MULTICHIP": "0"})):
        os.environ.update(env)
        try:
            prefix = smoke.path(f"multi_{name}")
            _phase(fix, prefix)
            secs = _phase(fix, prefix)
        finally:
            for k in env:
                os.environ.pop(k, None)
        runs[name] = _text(prefix + ".vcf")
        print(f"    {name}: warm {secs:.2f} s, "
              f"{_n_phased(prefix + '.vcf')} phased sites", flush=True)
    smoke.check("4 cards: chromosome mesh VCF = one card VCF",
                runs["mesh"] == runs["one_card"])
    smoke.check("4 cards: site-sharded wavefront VCF = one card VCF",
                runs["wavefront"] == runs["one_card"])

    mesh = make_mesh(jax.devices())
    items = random_somatic_items(29, len(jax.devices()) + 1, S=4096,
                                 A=2048, No=1 << 18)
    got = tk.somatic_counts_device_mesh(mesh, items, "extract",
                                        want_posbase=True)
    same = True
    for it, g in zip(items, got):
        ref = tk.somatic_counts_device(
            it["walk"], it["t"], "extract", is_som=it["is_som"],
            derive=it["derive"], gate=it["gate"], want_posbase=True)
        same &= all(np.array_equal(g[k], ref[k]) for k in ref)
    smoke.check(f"4 cards: somatic reductions on the mesh = one device "
                f"({len(items)} chromosomes)", same)
    _phase_line("4-card", "multi-card paths", t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    from longphase_s_jax.utils.compile_cache import enable_compile_cache

    t0 = time.perf_counter()
    import jax

    enable_compile_cache()
    devs = jax.devices()
    d = devs[0]
    print(f"[phase 0] JAX {jax.__version__}: platform={d.platform} "
          f"kind={d.device_kind} count={len(devs)}", flush=True)
    if d.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX's default device is "
              f"{d.platform!r}", file=sys.stderr)
        return 1
    if len(devs) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs, JAX finds "
              f"{len(devs)}", file=sys.stderr)
        return 1
    smi = _nvidia_smi()
    print(f"    nvidia-smi: {smi}", flush=True)

    import multiprocessing

    smoke = Smoke()
    pool = multiprocessing.get_context("spawn").Pool(5)
    try:
        native_job = pool.apply_async(_build_native)
        kinds = ("multi",) if args.cards == 4 else (
            "small", "phase", "somatic", "meth")
        jobs = {k: pool.apply_async(_fixture, (k,)) for k in kinds}
        built, deflate = native_job.get()
        print(f"    native/liblps.so built: {built}, with libdeflate: "
              f"{deflate}", flush=True)
        _phase_line(0, "identity", t0)

        if args.cards == 4:
            cards4(smoke, jobs["multi"].get())
        else:
            phase4_kernel(smoke)
            phase2_small(smoke, jobs["small"].get())
            bench_fix = jobs["phase"].get()
            phase1_bench(smoke, bench_fix)
            phase3_tags(smoke, bench_fix, jobs["somatic"].get(),
                        jobs["meth"].get())
    finally:
        pool.terminate()
        pool.join()

    ok = not smoke.failed
    if smoke.failed:
        print(f"FAILED: {'; '.join(smoke.failed)}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": ok, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
