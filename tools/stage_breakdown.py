#!/usr/bin/env python
"""Per-pipeline stage-time breakdown.

Runs each of the five pipelines on the bench fixtures (warm: second run in
the same process), captures the StageTimer stderr lines, and writes the
breakdowns to .bench_cache/stage_breakdown.md.

Usage: python tools/stage_breakdown.py
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, ".bench_cache")

STAGE_RE = re.compile(r"^(.*\S)\s*\.\.\.\s*([0-9.]+)s\s*$")


def capture(fn):
    fn()  # warm-up
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        fn()
    stages = []
    for line in buf.getvalue().splitlines():
        m = STAGE_RE.match(line.strip())
        if m:
            stages.append((m.group(1), float(m.group(2))))
        elif line.strip().endswith("s") and line.strip()[:-1].replace(
                ".", "").isdigit():
            # bare per-loop total (e.g. the phasing chromosomes line)
            stages.append(("(loop body)", float(line.strip()[:-1])))
    return stages


def main():
    import bench
    from longphase_s_jax.utils.compile_cache import enable_compile_cache
    from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag
    from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
    from longphase_s_jax.models.phase import PhaseConfig, run_phase
    from longphase_s_jax.models.somatic import (SomaticConfig,
                                                run_estimate_purity,
                                                run_somatic_haplotag)

    enable_compile_cache()
    phase_meta = bench.get_phase_fixture()
    phased = bench.get_phased_vcf(phase_meta)
    som_meta = bench.get_somatic_fixture()
    som_phased = bench.get_phased_somatic_vcf(som_meta)
    meth_meta = bench.get_meth_fixture()
    out = {}

    cfg = PhaseConfig(snp_file=phase_meta["vcf"],
                      bam_files=[phase_meta["bam"]],
                      fasta_file=phase_meta["fasta"],
                      result_prefix=os.path.join(OUT, "sb_phase"), engine="device")
    out[f"phase ({bench.PHASE_CFG['length'] // 1_000_000} Mbp, "
        f"{bench.PHASE_CFG['coverage']}x, device engine)"] = capture(lambda: run_phase(cfg))

    hcfg = HaplotagConfig(snp_file=phased, bam_file=phase_meta["bam"],
                          fasta_file=phase_meta["fasta"],
                          result_prefix=os.path.join(OUT, "sb_hap"))
    out["haplotag (same BAM)"] = capture(lambda: run_haplotag(hcfg))

    scfg = SomaticConfig(snp_file=som_phased,
                         tumor_snv_file=som_meta["tumor_vcf"],
                         bam_file=som_meta["normal_bam"],
                         tumor_bam_file=som_meta["tumor_bam"],
                         fasta_file=som_meta["fasta"],
                         result_prefix=os.path.join(OUT, "sb_som"))
    out[f"somatic_haplotag ({bench.SOMATIC_CFG['length'] // 1_000_000} Mbp pair)"] = capture(
        lambda: run_somatic_haplotag(scfg))

    pcfg = SomaticConfig(snp_file=som_phased,
                         tumor_snv_file=som_meta["tumor_vcf"],
                         bam_file=som_meta["normal_bam"],
                         tumor_bam_file=som_meta["tumor_bam"],
                         fasta_file=som_meta["fasta"],
                         result_prefix=os.path.join(OUT, "sb_pur"), quality_threshold=20,
                         tag_supplementary=True)
    out["estimate_purity"] = capture(lambda: run_estimate_purity(pcfg))

    mcfg = ModCallConfig(bam_files=[meth_meta["bam"]],
                         fasta_file=meth_meta["fasta"],
                         snp_file=meth_meta["vcf"],
                         result_prefix=os.path.join(OUT, "sb_mod"))
    out[f"modcall ({bench.METH_CFG['length'] // 1_000_000} Mbp MM/ML)"] = capture(lambda: run_modcall(mcfg))

    md = ["# Per-pipeline stage breakdown (bench fixtures, warm)",
          "",
          "Captured from the pipelines' stage timers "
          "(`tools/stage_breakdown.py`); the same format the reference "
          "prints to stderr.", ""]
    for name, stages in out.items():
        total = sum(s for _, s in stages)
        md.append(f"## {name} — total {total:.1f}s")
        md.append("")
        md.append("| stage | seconds |")
        md.append("|---|---|")
        for stage, secs in stages:
            md.append(f"| {stage} | {secs:.2f} |")
        md.append("")
    with open(os.path.join(OUT, "stage_breakdown.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print("wrote .bench_cache/stage_breakdown.md")


if __name__ == "__main__":
    main()
