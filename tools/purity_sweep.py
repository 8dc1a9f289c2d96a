#!/usr/bin/env python
"""Tumor-purity sweep harness (BASELINE config 5).

Simulates tumor/normal mixtures at 10-100% purity (fixed 50x tumor / 25x
normal, the reference README's mixture setup), runs `estimate_purity` with
BOTH the reference binary and our CLI on identical inputs, and records the
curve. Output: PURITY_SWEEP.md (committed artifact) — ours must match the
reference estimate at every point (both run the same regression,
TumorPurityEstimator.cpp:65; ours is the bit-parity reimplementation).

Usage: python tools/purity_sweep.py [outdir]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_BIN = os.path.join(ROOT, ".refbuild", "longphase-s")

SWEEP = [round(0.1 * i, 1) for i in range(1, 11)]
CFG = dict(length=1_000_000, normal_coverage=25, tumor_coverage=50,
           n_somatic=80, n_artifacts=20, read_len=12000,
           snp_rate=0.0012, error_rate=0.02, qual=25)


def run_point(purity: float, work: str):
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_estimate_purity)
    from longphase_s_jax.testing.simulate import make_somatic_fixture

    fix = make_somatic_fixture(os.path.join(work, f"p{purity:0.1f}"),
                               seed=int(purity * 10) + 100, purity=purity,
                               **CFG)
    phased = os.path.join(work, f"phased_{purity:0.1f}")
    subprocess.run([REF_BIN, "phase", "--pb", "-s", fix["normal_vcf"],
                    "-b", fix["normal_bam"], "-r", fix["fasta"],
                    "-o", phased, "-t", "4"],
                   check=True, capture_output=True, timeout=1200)

    ref_prefix = os.path.join(work, f"ref_{purity:0.1f}")
    r = subprocess.run([REF_BIN, "estimate_purity", "-s", phased + ".vcf",
                        "--tumor-snv-file", fix["tumor_vcf"],
                        "-b", fix["normal_bam"],
                        "--tumor-bam-file", fix["tumor_bam"],
                        "-r", fix["fasta"], "-o", ref_prefix, "-t", "4"],
                       check=True, capture_output=True, timeout=1200)
    ref_stderr_est = None
    for line in r.stderr.decode().splitlines():
        if line.startswith("estimated tumor purity:"):
            ref_stderr_est = float(line.split(":")[1])

    ours_prefix = os.path.join(work, f"ours_{purity:0.1f}")
    t0 = time.monotonic()
    ours_est = run_estimate_purity(SomaticConfig(
        snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
        bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
        fasta_file=fix["fasta"], result_prefix=ours_prefix,
        quality_threshold=20, tag_supplementary=True))
    ours_s = time.monotonic() - t0

    def read_report(prefix):
        # the estimator degrades gracefully (purity -> 0.0, NO report file)
        # when the model fails, e.g. very low true purity
        # (TumorPurityEstimator.cpp:77-81)
        try:
            with open(prefix + "_purity.out") as f:
                return f.read()
        except OSError:
            return None

    ref_report = read_report(ref_prefix)
    ours_report = read_report(ours_prefix)
    return {"purity": purity, "ref": ref_stderr_est, "ours": float(ours_est),
            "report_identical": ref_report == ours_report,
            "ours_s": round(ours_s, 2)}


def main():
    from longphase_s_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if not os.path.exists(REF_BIN):
        subprocess.run([os.path.join(ROOT, "tools", "build_refbuild.sh")],
                       check=True, timeout=1200)
    outdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="purity_sweep_")
    os.makedirs(outdir, exist_ok=True)
    rows = []
    for p in SWEEP:
        row = run_point(p, outdir)
        rows.append(row)
        print(json.dumps(row), flush=True)

    md = [
        "# Tumor-purity sweep (BASELINE config 5)",
        "",
        f"Simulated mixtures, {CFG['tumor_coverage']}x tumor / "
        f"{CFG['normal_coverage']}x normal, {CFG['length'] // 1000} kbp, "
        f"{CFG['n_somatic']} somatic SNVs; `estimate_purity` run with the "
        "reference binary and our CLI on identical inputs "
        "(`tools/purity_sweep.py`).",
        "",
        "| true purity | reference estimate | ours | full report identical |",
        "|---|---|---|---|",
    ]
    all_match = True
    for row in rows:
        match = (row["ref"] is not None
                 and abs(row["ref"] - row["ours"]) < 5e-7
                 and row["report_identical"])
        all_match &= match
        ref_s = f"{row['ref']:.6f}" if row["ref"] is not None else "n/a"
        md.append(f"| {row['purity']:.1f} | {ref_s} | "
                  f"{row['ours']:.6f} | {'yes' if match else 'NO'} |")
    md += [
        "",
        "Ours matches the reference at every sweep point."
        if all_match else "MISMATCHES PRESENT — investigate.",
        "",
        "The estimator is the reference's quadratic regression over the "
        "germline-imbalance feature distribution "
        "(TumorPurityEstimator.cpp:65); its absolute accuracy against true "
        "purity follows the reference's published behavior (README.md "
        "ASCAT comparison) — the parity claim here is ours == reference "
        "on identical inputs across the full 10-100% operating range.",
    ]
    with open(os.path.join(ROOT, "PURITY_SWEEP.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"wrote PURITY_SWEEP.md ({'all match' if all_match else 'MISMATCH'})")
    return 0 if all_match else 1


if __name__ == "__main__":
    sys.exit(main())
