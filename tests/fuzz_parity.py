#!/usr/bin/env python
"""Randomized golden-parity fuzzer (not collected by pytest).

Sweeps seeds across pipeline modes, comparing our output against the
reference binary record-for-record. Any mismatch is written to
FAIL_<mode>_<seed>.txt in the working directory; progress goes to stdout.

Usage: python tests/fuzz_parity.py <workdir> [n_seeds]
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from longphase_s_jax.core.phase_algo import PhaseParams  # noqa: E402
from longphase_s_jax.models.haplotag import HaplotagConfig, run_haplotag  # noqa: E402
from longphase_s_jax.models.phase import PhaseConfig, run_phase  # noqa: E402
from longphase_s_jax.models.somatic import SomaticConfig, run_somatic_haplotag  # noqa: E402
from longphase_s_jax.testing.simulate import (make_fixture,  # noqa: E402
                                              make_somatic_fixture)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   ".refbuild", "longphase-s")

# --realism: run every fixture under testing.simulate.REALISM_PROFILE
# (homopolymer-conditioned indel errors, SV-breakpoint split/supplementary
# reads, chimeras) — the closest reachable proxy for real
# read-error structure. modcall keeps the plain profile (its MM/ML fixture
# builder is position-anchored).
REALISM = "--realism" in sys.argv


def vcf_rows(path):
    return [l for l in open(path) if not l.startswith("##")]


def bam_tags(path):
    from longphase_s_jax.io.bam import BamReader
    out = []
    for rec in BamReader(path):
        out.append((rec.qname, rec.flag, rec.pos, rec.get_tag("HP"),
                    rec.get_tag("PS"), rec.get_tag("PQ")))
    return out


def run_case(mode, seed, work):
    os.makedirs(work, exist_ok=True)
    rng_bits = (seed * 2654435761) & 0xFFFF
    if mode in ("pb", "ont", "indels"):
        fix = make_fixture(
            os.path.join(work, "fix"), seed=seed, realism=REALISM,
            length=100000 + (rng_bits % 7) * 30000,
            coverage=8 + seed % 12, read_len=4000 + (rng_bits % 5) * 2500,
            snp_rate=0.0008 + (seed % 5) * 0.0004,
            indel_rate=0.0004 if mode == "indels" else 0.0,
            error_rate=0.01 + (seed % 4) * 0.02, qual=15 + (seed % 4) * 8)
        mode_flag = "--ont" if mode == "ont" else "--pb"
        extra = ["--indels"] if mode == "indels" else []
        golden = os.path.join(work, "golden")
        subprocess.run([REF, "phase", mode_flag, *extra, "-s", fix["vcf"],
                        "-b", fix["bam"], "-r", fix["fasta"], "-o", golden],
                       check=True, capture_output=True, timeout=300)
        ours = os.path.join(work, "ours")
        run_phase(PhaseConfig(
            snp_file=fix["vcf"], bam_files=[fix["bam"]],
            fasta_file=fix["fasta"], result_prefix=ours, engine="device",
            is_ont=(mode == "ont"), is_pb=(mode != "ont"),
            phase_indel=(mode == "indels"),
            params=PhaseParams(is_ont=(mode == "ont"),
                               phase_indel=(mode == "indels"))))
        g, o = vcf_rows(golden + ".vcf"), vcf_rows(ours + ".vcf")
        if g != o:
            return f"phase VCF rows differ ({sum(1 for a, b in zip(g, o) if a != b)} of {len(g)}/{len(o)})"
        # haplotag on top
        gh = os.path.join(work, "gh")
        subprocess.run([REF, "haplotag", "-s", golden + ".vcf", "-b",
                        fix["bam"], "-r", fix["fasta"], "-o", gh],
                       check=True, capture_output=True, timeout=300)
        oh = os.path.join(work, "oh")
        run_haplotag(HaplotagConfig(snp_file=golden + ".vcf",
                                    bam_file=fix["bam"],
                                    fasta_file=fix["fasta"],
                                    result_prefix=oh))
        if bam_tags(gh + ".bam") != bam_tags(oh + ".bam"):
            return "haplotag tags differ"
        return None
    if mode == "svmod":
        fix = make_fixture(
            os.path.join(work, "fix"), seed=seed, realism=REALISM,
            length=120000 + (rng_bits % 5) * 30000,
            coverage=12 + seed % 10, read_len=6000 + (rng_bits % 4) * 2500,
            snp_rate=0.001 + (seed % 4) * 0.0004,
            error_rate=0.01 + (seed % 3) * 0.02, qual=18 + (seed % 3) * 8,
            n_svs=2 + seed % 7, n_mods=2 + (seed >> 2) % 8)
        golden = os.path.join(work, "golden")
        subprocess.run([REF, "phase", "--pb", "-s", fix["vcf"],
                        "--sv-file", fix["sv_vcf"], "--mod-file",
                        fix["mod_vcf"], "-b", fix["bam"], "-r", fix["fasta"],
                        "-o", golden], check=True, capture_output=True,
                       timeout=300)
        ours = os.path.join(work, "ours")
        run_phase(PhaseConfig(
            snp_file=fix["vcf"], bam_files=[fix["bam"]],
            fasta_file=fix["fasta"], result_prefix=ours,
            sv_file=fix["sv_vcf"], mod_file=fix["mod_vcf"], engine="device",
            params=PhaseParams()))
        for suffix in (".vcf", "_SV.vcf", "_mod.vcf"):
            if vcf_rows(golden + suffix) != vcf_rows(ours + suffix):
                return f"phase{suffix} differs"
        gh = os.path.join(work, "gh")
        subprocess.run([REF, "haplotag", "-s", golden + ".vcf",
                        "--sv-file", golden + "_SV.vcf",
                        "--mod-file", golden + "_mod.vcf",
                        "-b", fix["bam"], "-r", fix["fasta"], "-o", gh],
                       check=True, capture_output=True, timeout=300)
        oh = os.path.join(work, "oh")
        run_haplotag(HaplotagConfig(
            snp_file=golden + ".vcf", sv_file=golden + "_SV.vcf",
            mod_file=golden + "_mod.vcf", bam_file=fix["bam"],
            fasta_file=fix["fasta"], result_prefix=oh))
        if bam_tags(gh + ".bam") != bam_tags(oh + ".bam"):
            return "haplotag svmod tags differ"
        return None
    if mode == "modcall":
        from longphase_s_jax.models.modcall import ModCallConfig, run_modcall
        from longphase_s_jax.testing.simulate import make_meth_fixture

        fix = make_meth_fixture(
            os.path.join(work, "fix"), seed=seed,
            length=100000 + (rng_bits % 4) * 40000,
            coverage=10 + seed % 16, read_len=5000 + (rng_bits % 4) * 2500,
            n_asm=4 + seed % 12, n_homo_mod=2 + (seed >> 3) % 8)
        golden = os.path.join(work, "golden")
        subprocess.run([REF, "modcall", "-b", fix["bam"], "-r", fix["fasta"],
                        "-o", golden], check=True, capture_output=True,
                       timeout=300)
        ours = os.path.join(work, "ours")
        run_modcall(ModCallConfig(bam_files=[fix["bam"]],
                                  fasta_file=fix["fasta"], snp_file="",
                                  result_prefix=ours))
        if vcf_rows(golden + ".vcf") != vcf_rows(ours + ".vcf"):
            return "modcall VCF differs"
        return None
    if mode == "somatic":
        purity = 0.15 + (seed % 8) * 0.1
        fix = make_somatic_fixture(
            os.path.join(work, "fix"), seed=seed, realism=REALISM,
            length=120000 + (rng_bits % 5) * 30000, purity=purity,
            n_somatic=8 + seed % 20, n_artifacts=seed % 8)
        phased = os.path.join(work, "phased")
        subprocess.run([REF, "phase", "--pb", "-s", fix["normal_vcf"],
                        "-b", fix["normal_bam"], "-r", fix["fasta"],
                        "-o", phased], check=True, capture_output=True,
                       timeout=300)
        golden = os.path.join(work, "golden")
        subprocess.run([REF, "somatic_haplotag", "-s", phased + ".vcf",
                        "--tumor-snv-file", fix["tumor_vcf"],
                        "-b", fix["normal_bam"],
                        "--tumor-bam-file", fix["tumor_bam"],
                        "-r", fix["fasta"], "--output-somatic-vcf",
                        "--somatic-calling-log",
                        "-o", golden], check=True, capture_output=True,
                       timeout=600)
        ours = os.path.join(work, "ours")
        run_somatic_haplotag(SomaticConfig(
            snp_file=phased + ".vcf", tumor_snv_file=fix["tumor_vcf"],
            bam_file=fix["normal_bam"], tumor_bam_file=fix["tumor_bam"],
            fasta_file=fix["fasta"], result_prefix=ours,
            write_somatic_vcf=True, write_calling_log=True))
        # the calling logs carry the full float surface (VAFs, z-scores,
        # ratios) — byte-compare them all
        for sfx in ("_somatic_var.out", "_dense_tumor_snp_interval.log",
                    "_somatic_filter.log", "_read_count_filter.log",
                    "_messy_read_filter.log",
                    "_read_distri_scaller.out",
                    "_germlineReadHpCountInNorBam_histogram.out"):
            g, o = golden + sfx, ours + sfx
            if os.path.exists(g) != os.path.exists(o):
                return f"{sfx} presence differs"
            if os.path.exists(g):
                gl = [l.replace(golden, "P") for l in open(g)]
                ol = [l.replace(ours, "P") for l in open(o)]
                if gl != ol:
                    return f"{sfx} differs"
        g_has = os.path.exists(golden + "_purity.out")
        o_has = os.path.exists(ours + "_purity.out")
        if g_has != o_has:
            return f"purity report presence differs (ref={g_has} ours={o_has})"
        if g_has and open(golden + "_purity.out").read() != \
                open(ours + "_purity.out").read():
            return "purity report differs"
        if vcf_rows(golden + "_sc.vcf") != vcf_rows(ours + "_sc.vcf"):
            return "_sc.vcf differs"
        if bam_tags(golden + ".bam") != bam_tags(ours + ".bam"):
            return "somatic tags differ"
        return None
    raise ValueError(mode)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    workdir = args[0]
    n_seeds = int(args[1]) if len(args) > 1 else 50
    os.makedirs(workdir, exist_ok=True)
    modes = ["pb", "ont", "indels", "somatic", "svmod", "modcall"]
    fails = 0
    base = int(os.environ.get('FUZZ_BASE', '1000'))
    for seed in range(base, base + n_seeds):
        for mode in modes:
            tag = f"{mode}_{seed}"
            case_dir = os.path.join(workdir, tag)
            try:
                msg = run_case(mode, seed, case_dir)
            except Exception as e:  # noqa: BLE001
                msg = f"exception: {e!r}"
            if msg:
                fails += 1
                with open(os.path.join(workdir, f"FAIL_{tag}.txt"), "w") as f:
                    f.write(msg + "\n")
                print(f"[FAIL] {tag}: {msg}", flush=True)
            else:
                print(f"[ok] {tag}", flush=True)
                subprocess.run(["rm", "-rf", case_dir])
    print(f"done: {fails} failures over {n_seeds} seeds x {len(modes)} modes",
          flush=True)


if __name__ == "__main__":
    main()
