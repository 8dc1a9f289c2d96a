"""Somatic haplotagging pipeline (SomaticHaplotagProcess.{h,cpp}) and the
shared somatic variant calling driver.

Flow: parse normal phased VCF + tumor VCF -> two-BAM extraction ->
purity estimation -> purity-tiered feature filters -> read-HP calibration ->
somatic flags -> optional _sc.vcf -> tag tumor BAM with HP:Z/PS:i/PQ:i.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, field

import numpy as np

from .. import REFERENCE_VERSION
from ..core.cigar_walk import CigarWalk
from ..core.purity import PurityEstimator
from ..core.somatic_caller import (FilterParams, calculate_read_set_hp,
                                   calibrate_read_hp, extract_normal_chromosome,
                                   extract_tumor_chromosome,
                                   get_dense_tumor_snp_interval,
                                   iter_somatic_reads, somatic_feature_filter,
                                   statistic_somatic_pos_read_hp)
from ..core.somatic_judge import judge_somatic_read_hap, judge_somatic_snp_hap
from ..core.somatic_types import (GERMLINE_H1, GERMLINE_H2, NONE_SNP,
                                  PosHpRecord, READ_HP_STR, RH_H1, RH_H1_1,
                                  RH_H2, RH_H2_1, RH_H3, RH_UNTAG, SOMATIC_H3)
from ..io.bam import BamWriter
from ..io.bgzf import open_maybe_bgzf
from ..io.fasta import FastaFile
from ..io.phased_vcf import (NORMAL, PHASED_HETERO, TUMOR, PhasedVcfReader,
                             VcfInfo, VT_DELETION, VT_INSERTION, VT_SNP,
                             NONE_PHASED_SET)
from ..utils import StageTimer
from .haplotag import ReadStatistics


@dataclass
class SomaticConfig:
    snp_file: str                 # phased normal VCF
    tumor_snv_file: str
    bam_file: str                 # normal BAM
    tumor_bam_file: str
    fasta_file: str
    result_prefix: str = "result"
    sv_file: str = ""
    mod_file: str = ""
    num_threads: int = 1
    quality_threshold: int = 1
    percentage_threshold: float = 0.6
    tag_supplementary: bool = False
    region: str = ""
    write_read_log: bool = False
    tumor_purity: float = 0.2
    estimate_tumor_purity: bool = True
    enable_filter: bool = True
    write_somatic_vcf: bool = False
    write_calling_log: bool = False
    truth_vcf: str = ""
    truth_bed: str = ""
    write_benchmark_log: bool = False
    output_cram: bool = False
    command: str = ""
    checkpoint_dir: str = ""  # per-contig extraction resume (SURVEY §5)
    dist: str = ""  # "host:port,nprocs,pid" multi-host spec (SURVEY §2.6)
    # estimate_purity never consumes the +-100bp offset windows (they feed
    # only the DenseAlt filter in the calling stage), so its extraction
    # skips collecting them; outputs are unaffected
    collect_offset_windows: bool = True
    # estimate_purity reads only nor_base + somatic_info; the per-read
    # ReadVarHpCount set and pos->read->hp map feed the calling stage
    # filters, so its extraction skips building them too
    collect_read_sets: bool = True


def _last_var_pos(variants_sorted, variants, genome_sample):
    """HaplotagBamParser::getLastVarPos (HaplotagParsingBam.cpp:336-374)."""
    for pos in reversed(variants_sorted):
        entry = variants[pos]
        nor = entry.get(NORMAL)
        if genome_sample == NORMAL:
            if nor is not None and nor.has_ps:
                return pos
        else:
            if TUMOR in entry or (nor is not None and nor.has_ps):
                return pos
    return 0


def _native_bams(cfg):
    """Native handles for the normal/tumor BAMs, or (None, None) entries when
    the native path is unavailable (CRAM input, no compiler, opt-out)."""
    import os

    from .. import native
    from ..io.cram import is_cram

    if os.environ.get("LPS_NO_NATIVE_TAG"):
        return None, None

    from ..parallel import distributed as dist

    def open_one(path, allow_stream):
        # container-streaming CRAM handle first (bounded memory, no
        # whole-file BAM image); streaming is single-host only — the
        # distributed tag gather assumes handle record indices
        if (allow_stream and not dist.is_active() and native.available()
                and is_cram(path)):
            try:
                return native.CramStreamingBam(path, cfg.fasta_file)
            except Exception:  # noqa: BLE001 — exotic layout: handle path
                pass
        nb = native.open_native_bam(path, cfg.fasta_file)
        if nb is not None:
            return nb
        # past the RAM budget: stream plain BAMs through windowed handles
        try:
            if (allow_stream and not dist.is_active() and native.available()
                    and not is_cram(path)
                    and os.path.getsize(path) > native._inmem_budget()):
                return native.StreamingBam(path)
        except OSError:
            pass
        return None

    # CRAM output needs the whole-file writer; streaming covers BAM output
    nor = open_one(cfg.bam_file, True)
    tum = open_one(cfg.tumor_bam_file, not cfg.output_cram)
    return nor, tum


class SomaticCallState:
    """Holds per-chromosome caller outputs shared between stages."""

    def __init__(self):
        self.nor_base = {}        # chr -> {pos: PosBase}
        self.somatic_info = {}    # chr -> {pos: SomaticData}
        self.read_hp_sets = {}    # chr -> {read_id: ReadVarHpCount}
        self.pos_read_corr = {}   # chr -> {pos: {read_id: baseHP}}
        self.dense_intervals = {}  # chr -> {start: interval data}
        self.caller_distri = {}   # chr -> {pos: PosHpRecord} (callerReadHpDistri)
        self.tumor_purity = 0.0
        self.params = FilterParams()
        self.tables = {}          # chr -> build_somatic_tables result
                                  # (shared by both extract passes + tag)


def _mesh_devices():
    """Local devices when the somatic mesh batch is allowed (LPS_MULTICHIP
    gate, mirrors models.phase._make_multichip_sink): >=2 local devices,
    or LPS_MULTICHIP=1 forcing; LPS_MULTICHIP=0 disables."""
    if os.environ.get("LPS_MULTICHIP", "") == "0":
        return None
    import jax

    devs = (jax.local_devices() if jax.process_count() > 1
            else jax.devices())
    if len(devs) > 1 or os.environ.get("LPS_MULTICHIP", "") == "1":
        return devs
    return None


def _mesh_precompute(cfg, nor_nb, tum_nb, loop_chroms, chr_multi,
                     chr_length, state, nor_refs, tum_refs, need_nor,
                     need_tum):
    """Batch every chromosome's normal/tumor extract reductions across the
    device mesh (ops.tag_kernels.somatic_counts_device_mesh) — the
    device analog of the reference's contig parallel-for over the
    extraction passes (SomaticVarCaller.cpp:822/907-935). Returns two
    dicts chrom -> (walk, dev_result_or_None); walks are reused by the
    per-chromosome extract calls even when the reductions stay on host."""
    import numpy as np

    from ..core.somatic_fast import tumor_want_window
    from ..io.bam import region_bounds
    from ..ops import tag_kernels

    devs = _mesh_devices()
    if devs is None or nor_nb is None or tum_nb is None:
        return {}, {}
    pre_n: dict[str, tuple] = {}
    pre_t: dict[str, tuple] = {}
    items_n: list[tuple[str, dict]] = []
    items_t: list[tuple[str, dict]] = []
    total = 0
    for chrom in loop_chroms:
        variants = chr_multi.get(chrom, {})
        positions = sorted(variants)
        t = state.tables.get(chrom)
        if t is None:
            continue
        chrom_len = chr_length.get(chrom)
        beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
            else (0, chrom_len)
        last_var = positions[-1] if positions else None
        if need_nor.get(chrom) and nor_nb.tid(chrom) >= 0:
            w = nor_nb.tag_walk(chrom, beg, end, positions, last_var,
                                nor_refs[chrom], cfg.quality_threshold,
                                False, cfg.tag_supplementary)
            if w is not None and len(w["category"]):
                gate = (w["mapq"] >= cfg.quality_threshold)[w["obs_aln"]]
                items_n.append((chrom, {"walk": w, "t": t,
                                        "gate": gate.astype(np.uint8)},
                                bool(nor_refs[chrom])))
                total += len(w["obs_var"])
                pre_n[chrom] = (w, None)
        if need_tum.get(chrom) and tum_nb.tid(chrom) >= 0:
            w = tum_nb.tag_walk(chrom, beg, end, positions, last_var,
                                tum_refs[chrom], cfg.quality_threshold,
                                False, cfg.tag_supplementary,
                                want_window=tumor_want_window(cfg, t),
                                window=100)
            if w is not None and len(w["category"]):
                gate = (w["mapq"] >= cfg.quality_threshold)[w["obs_aln"]]
                items_t.append((chrom, {"walk": w, "t": t,
                                        "gate": gate.astype(np.uint8)}))
                total += len(w["obs_var"])
                pre_t[chrom] = (w, None)
    if tag_kernels.engine(total) != "device":
        return pre_n, pre_t  # walks reused; reductions stay per-chromosome
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(devs)
    # the 'normal' kernel specializes on ref_nonempty (static arg): batch
    # each group separately. A None result (PS beyond int32) leaves the
    # group's reductions to the per-chromosome path.
    for refflag in (False, True):
        grp = [(c, it) for c, it, rf in items_n if rf == refflag]
        if not grp:
            continue
        res = tag_kernels.somatic_counts_device_mesh(
            mesh, [it for _c, it in grp], "normal", want_posbase=True,
            ref_nonempty=refflag)
        for (c, _it), r in zip(grp, res or ()):
            pre_n[c] = (pre_n[c][0], r)
    if items_t:
        res = tag_kernels.somatic_counts_device_mesh(
            mesh, [it for _c, it in items_t], "extract", want_posbase=True)
        for (c, _it), r in zip(items_t, res or ()):
            pre_t[c] = (pre_t[c][0], r)
    return pre_n, pre_t


def _run_extraction(cfg, state, loop_chroms, chr_multi, chr_length, fasta,
                    sv_counts, timer):
    """Both extraction BAM passes (SomaticVarCaller.cpp:907-935), with
    optional per-contig checkpoint/resume (--checkpoint, ours-only): each
    chromosome's pass output is pickled as it completes, so a killed WGS
    run resumes after the passes already done instead of re-walking both
    BAMs (SURVEY §5 checkpoint mapping; the reference has none)."""
    ckpt = None
    if cfg.checkpoint_dir:
        from ..utils.checkpoint import (PickleContigCheckpoint,
                                        somatic_fingerprint)
        ckpt = PickleContigCheckpoint(cfg.checkpoint_dir,
                                      somatic_fingerprint(cfg), "somatic")

    nor_stored = {c: ckpt.load(c, "nor") for c in loop_chroms} \
        if ckpt is not None else {}
    tum_stored = {c: ckpt.load(c, "tum") for c in loop_chroms} \
        if ckpt is not None else {}
    nor_nb = tum_nb = None
    if (any(nor_stored.get(c) is None for c in loop_chroms)
            or any(tum_stored.get(c) is None for c in loop_chroms)):
        nor_nb, tum_nb = _native_bams(cfg)

    # Prefetch reference windows serially: FastaFile shares one file handle,
    # so the overlapped passes below must not call fetch() concurrently.
    # The per-variant judge tables are also built here, once, and shared by
    # the normal pass, the tumor pass, and later the tag pass (read-only in
    # all three; rebuilding them per pass costs more than a whole calling
    # stage at WGS scale).
    from ..core.somatic_fast import build_somatic_tables

    nor_refs: dict[str, str] = {}
    tum_refs: dict[str, str] = {}
    for chrom in loop_chroms:
        variants = chr_multi.get(chrom, {})
        positions = sorted(variants)
        if positions:
            state.tables[chrom] = build_somatic_tables(positions, variants)
        if chrom in fasta.index and positions:
            nor_refs[chrom] = fasta.fetch(
                chrom, 0, _last_var_pos(positions, variants, NORMAL) + 6)
            tum_refs[chrom] = fasta.fetch(
                chrom, 0, _last_var_pos(positions, variants, TUMOR) + 6)
        else:
            nor_refs[chrom] = tum_refs[chrom] = ""

    # device-mesh batch of the extract reductions across chromosomes
    # (no-op on a single chip; see _mesh_precompute)
    pre_nor, pre_tum = _mesh_precompute(
        cfg, nor_nb, tum_nb, loop_chroms, chr_multi, chr_length, state,
        nor_refs, tum_refs,
        {c: nor_stored.get(c) is None for c in loop_chroms},
        {c: tum_stored.get(c) is None for c in loop_chroms})

    def run_normal():
        for chrom in loop_chroms:
            stored = nor_stored.get(chrom)
            if stored is not None:
                state.nor_base[chrom] = stored
                continue
            variants = chr_multi.get(chrom, {})
            positions = sorted(variants)
            if nor_nb is not None:
                from ..core.somatic_fast import extract_normal_chromosome_fast
                state.nor_base[chrom] = extract_normal_chromosome_fast(
                    nor_nb, chrom, chr_length.get(chrom), positions,
                    variants, nor_refs[chrom], sv_counts, cfg,
                    tables=state.tables.get(chrom),
                    precomputed=pre_nor.get(chrom))
            else:
                state.nor_base[chrom] = extract_normal_chromosome(
                    cfg.bam_file, chrom, chr_length.get(chrom), positions,
                    variants, nor_refs[chrom], sv_counts, cfg, fasta=fasta)
            if ckpt is not None:
                ckpt.save(chrom, "nor", state.nor_base[chrom])

    def run_tumor():
        for chrom in loop_chroms:
            stored = tum_stored.get(chrom)
            if stored is not None:
                (state.somatic_info[chrom], state.read_hp_sets[chrom],
                 state.pos_read_corr[chrom]) = stored
                continue
            variants = chr_multi.get(chrom, {})
            positions = sorted(variants)
            if tum_nb is not None:
                from ..core.somatic_fast import extract_tumor_chromosome_fast
                (state.somatic_info[chrom], state.read_hp_sets[chrom],
                 state.pos_read_corr[chrom]) = extract_tumor_chromosome_fast(
                    tum_nb, chrom, chr_length.get(chrom), positions,
                    variants, tum_refs[chrom], cfg,
                    tables=state.tables.get(chrom),
                    precomputed=pre_tum.get(chrom))
            else:
                (state.somatic_info[chrom], state.read_hp_sets[chrom],
                 state.pos_read_corr[chrom]) = extract_tumor_chromosome(
                    cfg.tumor_bam_file, chrom, chr_length.get(chrom),
                    positions, variants, tum_refs[chrom], cfg, fasta=fasta)
            if ckpt is not None:
                ckpt.save(chrom, "tum", (state.somatic_info[chrom],
                                         state.read_hp_sets[chrom],
                                         state.pos_read_corr[chrom]))

    # The two passes touch disjoint state and different BAM handles, so with
    # native handles they overlap: the tumor pass (the longer one — case
    # classification + offset windows) runs on a worker thread while the
    # normal pass runs here. Native walks drop the GIL; the big NumPy
    # reductions mostly do too. The object fallback shares pysam-less
    # readers/fasta in ways that are not thread-safe — keep it sequential.
    overlap = nor_nb is not None and tum_nb is not None \
        and not os.environ.get("LPS_NO_OVERLAP_EXTRACT")
    if overlap:
        import threading
        errs: list[BaseException] = []

        def guarded():
            try:
                run_tumor()
            except BaseException as e:  # noqa: BLE001 — re-raised on main
                errs.append(e)

        th = threading.Thread(target=guarded, name="lps-extract-tumor")
        th.start()
        with timer("extracting data from normal BAM"):
            run_normal()
        with timer("extracting data from tumor BAM"):
            th.join()
        if errs:
            raise errs[0]
    else:
        with timer("extracting data from normal BAM"):
            run_normal()
        with timer("extracting data from tumor BAM"):
            run_tumor()


def run_somatic_calling(cfg: SomaticConfig, chr_vec, chr_length, chr_multi,
                        sv_counts, fasta: FastaFile, timer: StageTimer,
                        loop_chroms=None) -> SomaticCallState:
    """SomaticVarCaller::variantCalling (SomaticVarCaller.cpp:796-905).

    ``loop_chroms`` restricts the extraction/calling loops to this process's
    contig shard (multi-host mode); the purity estimator still receives the
    global chr_vec ordering and merges feature points across hosts."""
    state = SomaticCallState()
    if loop_chroms is None:
        loop_chroms = chr_vec

    _run_extraction(cfg, state, loop_chroms, chr_multi, chr_length, fasta,
                    sv_counts, timer)

    if cfg.estimate_tumor_purity:
        est = PurityEstimator(chr_vec, state.nor_base, state.somatic_info,
                              cfg.write_calling_log, cfg.result_prefix)
        state.tumor_purity = est.estimate()
        est.mark_statistic_flag()
    else:
        state.tumor_purity = cfg.tumor_purity

    state.params.set_with_purity(state.tumor_purity)
    tier = state.params
    print(f"setting filter params with tumor purity: {state.tumor_purity}",
          file=sys.stderr)

    with timer("calling somatic variants"):
        for chrom in loop_chroms:
            variants = chr_multi.get(chrom, {})
            si = state.somatic_info[chrom]
            rs = state.read_hp_sets[chrom]
            corr = state.pos_read_corr[chrom]
            state.dense_intervals[chrom] = get_dense_tumor_snp_interval(si, rs, corr)
            somatic_feature_filter(tier, variants, si,
                                   state.nor_base[chrom], cfg.enable_filter)
            calibrate_read_hp(si, rs, corr)
            calculate_read_set_hp(rs, cfg.percentage_threshold)
            distri = None
            if cfg.write_calling_log:
                distri = state.caller_distri.setdefault(chrom, {})
            statistic_somatic_pos_read_hp(si, corr, rs, distri)
    return state


def write_somatic_var_log(cfg: SomaticConfig, state: SomaticCallState,
                          chr_vec, chr_multi):
    """writeSomaticVarCallingLog -> _somatic_var.out
    (SomaticVarCaller.cpp:1576-1927, 65 columns)."""
    from ..core.somatic_types import PosBase
    from .haplotag import cpp_double as d

    p = state.params
    total = sum(1 for chrom in chr_vec
                for sd in state.somatic_info.get(chrom, {}).values()
                if sd.is_high_con)
    with open(cfg.result_prefix + "_somatic_var.out", "w") as f:
        f.write("####################################\n")
        f.write("#   Somatic Variants Calling Log   #\n")
        f.write("####################################\n")
        f.write(f"##normalSnpFile:{cfg.snp_file}\n")
        f.write(f"##tumorSnvFile:{cfg.tumor_snv_file}\n")
        f.write(f"##bamFile:{cfg.bam_file}\n")
        f.write(f"##tumorBamFile:{cfg.tumor_bam_file}\n")
        f.write(f"##resultPrefix:{cfg.result_prefix}\n")
        f.write(f"##numThreads:{cfg.num_threads}\n")
        f.write(f"##region:{cfg.region}\n")
        f.write(f"##qualityThreshold:{cfg.quality_threshold}\n")
        f.write(f"##percentageThreshold:{d(cfg.percentage_threshold)}\n")
        f.write(f"##tagSupplementary:{int(cfg.tag_supplementary)}\n")
        f.write("##\n")
        f.write("##======== Filter Parameters =========\n")
        f.write(f"##Enable filter : {int(cfg.enable_filter)}\n")
        f.write(f"##Calling mapping quality :{cfg.quality_threshold}\n")
        f.write(f"##Tumor purity : {d(p.tumor_purity)}\n")
        f.write(f"##Normal VAF maximum threshold : {d(p.nor_vaf_max)}\n")
        f.write(f"##Normal depth minimum threshold : {p.nor_depth_min}\n")
        f.write(f"##Messy read ratio threshold : {d(p.messy_ratio_thr)}\n")
        f.write(f"##Somatic read count minimum threshold : {d(p.read_count_min)}\n")
        f.write(f"##Haplotag consistency filter VAF threshold : {d(p.hapcon_vaf_max)}\n")
        f.write(f"##Haplotag consistency filter read count threshold : {d(p.hapcon_read_count_max)}\n")
        f.write(f"##Haplotag consistency somatic read count minimum threshold : {d(p.hapcon_somatic_read_min)}\n")
        f.write(f"##Interval SNP count filter threshold : {d(p.interval_vaf_max)}\n")
        f.write(f"##Interval SNP count filter read count threshold : {d(p.interval_read_count_max)}\n")
        f.write(f"##Interval SNP count minimum threshold : {d(p.interval_snp_count_min)}\n")
        f.write(f"##Z-score maximum threshold : {d(p.zscore_max)}\n")
        f.write(f"##DenseAlt filter condition1 threshold : {d(p.densealt_cond1)}\n")
        f.write(f"##DenseAlt filter condition2 threshold : {d(p.densealt_cond2)}\n")
        f.write(f"##DenseAlt filter minimum same count threshold : {p.densealt_same_count_min}\n")
        f.write("##==================================== \n")
        f.write("##\n")
        f.write(f"##Total Somatic SNPs: {total}\n")
        f.write("##\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tAltCount\tReadCount\tNorAltCount\t"
                "PureH1-1\tPureH2-1\tPureH3\tMixedHpRead\tUnTag\t"
                "PureH1-1ratio\tPureH2-1ratio\tPureH3ratio\tMixedHpReadRatio\t"
                "NorVAF\tTumVAF\tNorMpqVAF\tTumMpqVAF\tNorVAF_substract\t"
                "TumVAF_substract\tNorDepth\tTumDepth\tSubtract_Depth\t"
                "NorDeletionCount\tTumDeletionCount\tNorDeletionRatio\t"
                "TumDeletionRatio\tNorMpqReadRatio\tTumMpqReadRatio\t"
                "ShannonEntropy\tHomopolymerLength\tH1readCount\tH2readCount\t"
                "H1_1readCount\tH2_1readCount\tH3readCount\t"
                "GermlineReadHpCount\tGermlineReadHpImbalanceRatio\t"
                "SomaticReadHpImbalanceRatio\t"
                "BaseGermlineReadHpImbalanceRatio\tPercentageOfGermlineHp\t"
                "H1readCountInNorBam\tH2readCountInNorBam\t"
                "GermlineReadHpCountInNorBam\t"
                "GermlineReadHpImbalanceRatioInNorBam\t"
                "PercentageOfGermlineHpInNorBam\t"
                "GermlineReadHpImbalanceRatioDifference\t"
                "PercentageOfGermlineHpDifference\tSomaticRead_H1-1\t"
                "SomaticRead_H2-1\tSomaticRead_H3\tSomaticRead_unTag\t"
                "AltMeanCountPerVarRead\tzScore\tIntervalSnpCount\t"
                "IntervalMinDistance\tExistNorSnp\tStatisticPurity\t"
                "isFilterOut\tNorNonDelAF\tTumNonDelAF\tGT\n")
        for chrom in chr_vec:
            for pos in sorted(state.somatic_info.get(chrom, {})):
                sd = state.somatic_info[chrom][pos]
                if not sd.is_high_con:
                    continue
                nb = state.nor_base.get(chrom, {}).get(pos, PosBase())
                entry = chr_multi.get(chrom, {}).get(pos, {})
                tum = entry.get(TUMOR)
                srl = sd.somatic_read_hp_count
                bhp = sd.base.read_hp_count
                h1 = bhp.get(RH_H1, 0)
                h2 = bhp.get(RH_H2, 0)
                h1_1 = bhp.get(RH_H1_1, 0)
                h2_1 = bhp.get(RH_H2_1, 0)
                h3 = bhp.get(RH_H3, 0)
                nh1 = nb.read_hp_count.get(RH_H1, 0)
                nh2 = nb.read_hp_count.get(RH_H2, 0)
                z = sd.z_score if sd.in_dense_interval else -1.0
                f.write(
                    f"{chrom} \t{pos + 1}\t.\t{tum.ref}\t{tum.alt}\t"
                    f"{sd.base.alt_count}\t{sd.case_read_count}\t\t"
                    f"{nb.alt_count}\t{sd.pure_h1_1_read}\t{sd.pure_h2_1_read}\t"
                    f"{sd.pure_h3_read}\t{sd.mixed_hp_read}\t{sd.untag}\t\t"
                    f"{d(sd.pure_h1_1_ratio)}\t{d(sd.pure_h2_1_ratio)}\t"
                    f"{d(sd.pure_h3_ratio)}\t{d(sd.mixed_hp_ratio)}\t\t"
                    f"{d(nb.vaf)}\t{d(sd.base.vaf)}\t\t"
                    f"{d(nb.mpq_vaf)}\t{d(sd.base.mpq_vaf)}\t\t"
                    f"{d(_f32sub(nb.mpq_vaf, nb.vaf))}\t"
                    f"{d(_f32sub(sd.base.mpq_vaf, sd.base.vaf))}\t\t"
                    f"{nb.depth}\t{sd.base.depth}\t{sd.base.depth - nb.depth}\t"
                    f"{nb.del_count}\t{sd.base.del_count}\t"
                    f"{d(nb.del_ratio)}\t{d(sd.base.del_ratio)}\t"
                    f"{d(nb.low_mpq_read_ratio)}\t{d(sd.base.low_mpq_read_ratio)}\t"
                    f"0\t0\t\t"
                    f"{h1}\t{h2}\t{h1_1}\t{h2_1}\t{h3}\t{h1 + h2}\t"
                    f"{d(sd.base.germline_hp_imbalance)}\t"
                    f"{d(sd.somatic_hp_imbalance)}\t"
                    f"{d(sd.allelic_imbalance)}\t"
                    f"{d(sd.base.pct_germline_hp)}\t"
                    f"{nh1}\t{nh2}\t{nh1 + nh2}\t"
                    f"{d(nb.germline_hp_imbalance)}\t{d(nb.pct_germline_hp)}\t"
                    f"{d(sd.base.germline_hp_imbalance - nb.germline_hp_imbalance)}\t"
                    f"{d(sd.base.pct_germline_hp - nb.pct_germline_hp)}\t"
                    f"{srl.get(RH_H1_1, 0)}\t{srl.get(RH_H2_1, 0)}\t"
                    f"{srl.get(RH_H3, 0)}\t{srl.get(RH_UNTAG, 0)}\t"
                    f"{d(sd.mean_alt_per_var_read)}\t{d(z)}\t"
                    f"{sd.interval_snp_count}\t{sd.min_distance}\t"
                    f"{int(NORMAL in entry)}\t{int(sd.statistic_purity)}\t"
                    f"{int(sd.is_filter_out)}\t"
                    f"{d(nb.non_del_vaf)}\t{d(sd.base.non_del_vaf)}\t"
                    f"{sd.gt_type}\n")


def write_dense_interval_log(cfg, state, chr_vec):
    """writeDenseTumorSnpIntervalLog (SomaticVarCaller.cpp:1990-2043)."""
    from .haplotag import cpp_double as d

    total = sum(len(state.dense_intervals.get(c, {})) for c in chr_vec)
    with open(cfg.result_prefix + "_dense_tumor_snp_interval.log", "w") as f:
        f.write("################################\n")
        f.write("# Dense Tumor SNP Interval Log #\n")
        f.write("################################\n")
        f.write(f"##Tatal intervals:{total}\n")
        f.write("#CHROM\tstartPos-endPos\tsnpCount\ttotalAltMean\tstdDev\tzScore\n")
        for chrom in chr_vec:
            for start in sorted(state.dense_intervals.get(chrom, {})):
                end, alt_means, count, mdist, mean, std, zscores = \
                    state.dense_intervals[chrom][start]
                f.write(f"{chrom}:{start + 1}-{end + 1}\t{count}\t"
                        f"{d(mean)}\t{d(std)}\n")
                for pos in sorted(alt_means):
                    f.write(f"#snp:altMean:zScore:minDistance=>  {pos + 1} : "
                            f"{d(alt_means[pos])} : {d(zscores[pos])} : "
                            f"{mdist.get(pos, 0)}\n")
                f.write("#\n")


def write_somatic_filter_log(cfg, state, chr_vec):
    """writeSomaticFilterLog (SomaticVarCaller.cpp:2045-2107)."""
    from ..core.somatic_types import PosBase
    from .haplotag import cpp_double as d

    with open(cfg.result_prefix + "_somatic_filter.log", "w") as f:
        f.write("######################################\n")
        f.write("# Somatic Filter Evaluation Per-Pos   #\n")
        f.write("######################################\n")
        f.write("#CHROM\tPOS\tNorVAF\tNorDepth\tMixedHpReadRatio\t"
                "CaseReadCount\tTumVAF\tIntervalSnpCount\tzScore\t"
                "DenseAltSameCount\tFilteredByTINC\tFilteredByMessyRead\t"
                "FilteredByReadCount\tFilteredByHapConsistency\t"
                "FilteredByVariantCluster\tFilteredByDenseAlt\tisFilterOut\n")
        for chrom in chr_vec:
            for pos in sorted(state.somatic_info.get(chrom, {})):
                sd = state.somatic_info[chrom][pos]
                nb = state.nor_base.get(chrom, {}).get(pos, PosBase())
                f.write(f"{chrom}\t{pos + 1}\t{d(nb.vaf)}\t{nb.depth}\t"
                        f"{d(sd.mixed_hp_ratio)}\t{sd.case_read_count}\t"
                        f"{d(sd.base.vaf)}\t{sd.interval_snp_count}\t"
                        f"{d(sd.z_score)}\t{sd.dense_alt_same_count}\t"
                        f"{int(sd.filtered_by_tinc)}\t"
                        f"{int(sd.filtered_by_messy)}\t"
                        f"{int(sd.filtered_by_read_count)}\t"
                        f"{int(sd.filtered_by_hap_consistency)}\t"
                        f"{int(sd.filtered_by_variant_cluster)}\t"
                        f"{int(sd.filtered_by_dense_alt)}\t"
                        f"{int(sd.is_filter_out)}\n")


def write_read_count_filter_log(cfg, state, chr_vec):
    """writeReadCountFilterLog (SomaticVarCaller.cpp:2109-2147)."""
    from .haplotag import cpp_double as d

    p = state.params
    with open(cfg.result_prefix + "_read_count_filter.log", "w") as f:
        f.write("########################################\n")
        f.write("# Read Count Filter Detailed Log      #\n")
        f.write("########################################\n")
        f.write(f"##ReadCount_minThr: {d(p.read_count_min)}\n")
        f.write("#CHROM\tPOS\ttotalCleanHP3Read\tMixed_HP_read\t"
                "CaseReadCount\tReadCount_minThr\tFilteredByReadCount\n")
        for chrom in chr_vec:
            for pos in sorted(state.somatic_info.get(chrom, {})):
                sd = state.somatic_info[chrom][pos]
                f.write(f"{chrom}\t{pos + 1}\t{sd.total_clean_hp3_read}\t"
                        f"{sd.mixed_hp_read}\t{sd.case_read_count}\t"
                        f"{d(p.read_count_min)}\t"
                        f"{int(sd.filtered_by_read_count)}\n")


def _strip_read_suffix(read_id: str) -> str:
    dash = read_id.rfind("-")
    if dash != -1 and dash + 1 < len(read_id) and read_id[dash + 1:].isdigit():
        return read_id[:dash]
    return read_id


def write_messy_read_filter_log(cfg, state, chr_vec):
    """writeMessyReadFilterLog (SomaticVarCaller.cpp:2149-2294)."""
    from ..core.somatic_types import GERMLINE_H1, GERMLINE_H2
    from .haplotag import cpp_double as d

    p = state.params
    with open(cfg.result_prefix + "_messy_read_filter.log", "w") as f:
        f.write("########################################\n")
        f.write("# Messy Read Filter Detailed Log      #\n")
        f.write("########################################\n")
        f.write(f"##MessyReadRatioThreshold: {d(p.messy_ratio_thr)}\n")
        f.write("#CHROM\tPOS\ttotalCleanHP3Read\tMixed_HP_read\t"
                "CaseReadCount\tMixed_HP_readRatio\tMessyReadRatioThreshold\t"
                "pure_H1_1_read\tpure_H2_1_read\tpure_H3_read\t"
                "pure_H1_1_readRatio\tpure_H2_1_readRatio\tpure_H3_readRatio\t"
                "FilteredByMessyRead\tMixedHp1PhaseSites\tMixedHp2PhaseSites\n")
        for chrom in chr_vec:
            corr = state.pos_read_corr.get(chrom, {})
            read_set = state.read_hp_sets.get(chrom, {})
            for pos in sorted(state.somatic_info.get(chrom, {})):
                sd = state.somatic_info[chrom][pos]
                top1 = "-"
                top2 = "-"
                if sd.filtered_by_messy and pos in corr:
                    hp1_count: dict[int, int] = {}
                    hp2_count: dict[int, int] = {}
                    seen = set()
                    for read_id in sorted(corr[pos]):
                        base_hp = corr[pos][read_id]
                        if base_hp != SOMATIC_H3:
                            continue
                        orig = _strip_read_suffix(read_id)
                        if orig in seen:
                            continue
                        seen.add(orig)
                        r = read_set.get(read_id)
                        if r is None:
                            continue
                        h1_sites = [pp for pp, hp in r.pos_hp_pairs
                                    if hp == GERMLINE_H1]
                        h2_sites = [pp for pp, hp in r.pos_hp_pairs
                                    if hp == GERMLINE_H2]
                        if h1_sites and h2_sites:
                            if len(h1_sites) < len(h2_sites):
                                for s in h1_sites:
                                    hp1_count[s] = hp1_count.get(s, 0) + 1
                            elif len(h2_sites) < len(h1_sites):
                                for s in h2_sites:
                                    hp2_count[s] = hp2_count.get(s, 0) + 1

                    def build_top(m):
                        items = sorted(m.items(), key=lambda kv: (-kv[1], kv[0]))
                        out = ";".join(f"{k}:{v}" for k, v in items[:10])
                        return out or "-"

                    top1 = build_top(hp1_count)
                    top2 = build_top(hp2_count)
                f.write(f"{chrom}\t{pos + 1}\t{sd.total_clean_hp3_read}\t"
                        f"{sd.mixed_hp_read}\t{sd.case_read_count}\t"
                        f"{d(sd.mixed_hp_ratio)}\t{d(p.messy_ratio_thr)}\t"
                        f"{sd.pure_h1_1_read}\t{sd.pure_h2_1_read}\t"
                        f"{sd.pure_h3_read}\t{d(sd.pure_h1_1_ratio)}\t"
                        f"{d(sd.pure_h2_1_ratio)}\t{d(sd.pure_h3_ratio)}\t"
                        f"{int(sd.filtered_by_messy)}\t{top1}\t{top2}\n")


def write_read_hp_detail_log(cfg, state, chr_vec):
    """writeReadHpLog (SomaticVarCaller.cpp:2308-2386)."""
    snp_str = {0: "hp0", 1: "hp1", 2: "hp2", 3: "hp3", 4: "hp4", 5: "hp5"}
    read_str = {RH_H1_1: "H1_1", RH_H2_1: "H2_1", RH_H3: "H3", RH_H1: "H1",
                RH_H2: "H2", 6: "H1_2", 8: "H2_2", 4: "H4", RH_UNTAG: "unTag"}
    with open(cfg.result_prefix + "_read_hp_detail.log", "w") as f:
        f.write("##Read HP detail log\n")
        f.write("##Format: chr\treadID\thpResult\tpositions_and_baseHP\n")
        f.write("#Chr\tReadID\tReadHP\tVariants\n")
        for chrom in chr_vec:
            read_set = state.read_hp_sets.get(chrom, {})
            for read_id in sorted(read_set):
                r = read_set[read_id]
                if not r.pos_hp_pairs:
                    continue
                f.write(f"{chrom}\t{read_id}\t"
                        f"{read_str.get(r.hp_result, 'unknown')}\t")
                first = True
                for pp, hp in r.pos_hp_pairs:
                    if not first:
                        f.write("    ")
                    f.write(f"{pp},{snp_str.get(hp, 'hp?')}")
                    first = False
                f.write("\n")


# ---------------------------------------------------------------------------
# ReadHpDistriLog family (haplotag/HaplotagLogging.{h,cpp})
# ---------------------------------------------------------------------------

def _f32sub(a, b):
    """float - float in float32 (the reference's substract locals,
    SomaticVarCaller.cpp:1767,1772)."""
    return float(np.float32(a) - np.float32(b))


def _f3(x):
    """C++ fixed<<setprecision(3) rendering of a float, including NaN."""
    x = float(x)
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return f"{x:.3f}"


def _i32(x):
    """Wrapping int32 arithmetic (C++ int overflow on sentinel regions)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def write_read_hp_distri_log(path, chr_vec, distri_by_chr):
    """ReadHpDistriLog::writeReadHpDistriLog (HaplotagLogging.cpp:157-280).

    The data rows put a double tab after HP2read while the header has a
    single tab there -- reproduced verbatim. Ratios over zero tagged reads
    are float 0/0, which glibc prints as "-nan"."""
    total = sum(len(distri_by_chr.get(c, {})) for c in chr_vec)
    with open(path, "w") as f:
        f.write("###################################################\n")
        f.write("# Distribution of Read Haplotypes at Somatic SNPs #\n")
        f.write("###################################################\n")
        f.write(f"##SomaticSNP: {total}\n")
        f.write("#Chr\tPos\tDeriveHP\tDeriveHPsimilarity\t\tAltCount\t"
                "somaticBase_H1-1\tsomaticBase_H2-1\tsomaticBase_H3\t\t"
                "HP1read\tHP2read\tHP1-1read\tHP2-1read\tHP3read\tuntagRead\t"
                "HP1ratio\tHP2ratio\tHP1-1ratio\tHP2-1ratio\tHP3ratio\n")
        for chrom in chr_vec:
            d = distri_by_chr.get(chrom, {})
            for pos in sorted(d):
                rec = d[pos]
                c = rec.read_hp_counter
                hp1 = c.get(RH_H1, 0)
                hp1_1 = c.get(RH_H1_1, 0)
                hp2 = c.get(RH_H2, 0)
                hp2_1 = c.get(RH_H2_1, 0)
                hp3 = c.get(RH_H3, 0)
                tagged = hp1 + hp2 + hp3 + hp1_1 + hp2_1
                with np.errstate(invalid="ignore", divide="ignore"):
                    ft = np.float32(tagged)
                    r1 = np.float32(hp1) / ft
                    r2 = np.float32(hp2) / ft
                    r1_1 = np.float32(hp1_1) / ft
                    r2_1 = np.float32(hp2_1) / ft
                    r3 = np.float32(hp3) / ft
                mean = np.float32(0.0)
                if rec.derive_sims:
                    for s in rec.derive_sims:
                        mean += s
                    mean = mean / np.float32(len(rec.derive_sims))
                sb = rec.somatic_base_counter
                f.write(f"{chrom}\t{pos + 1}\tH{rec.derive_hp}\t{_f3(mean)}\t\t"
                        f"{rec.somatic_h3_count}\t{sb.get(RH_H1_1, 0)}\t"
                        f"{sb.get(RH_H2_1, 0)}\t{sb.get(RH_H3, 0)}\t\t"
                        f"{hp1}\t{hp2}\t\t{hp1_1}\t{hp2_1}\t{hp3}\t"
                        f"{c.get(RH_UNTAG, 0)}\t{_f3(r1)}\t{_f3(r2)}\t"
                        f"{_f3(r1_1)}\t{_f3(r2_1)}\t{_f3(r3)}\n")


def remove_not_derive_by_h1h2(chr_vec, distri_by_chr):
    """ReadHpDistriLog::removeNotDeriveByH1andH2pos (HaplotagLogging.cpp:473-484)."""
    for chrom in chr_vec:
        d = distri_by_chr.get(chrom)
        if not d:
            continue
        for pos in [p for p, r in d.items() if not r.exist_derive_h1h2]:
            del d[pos]


def write_densealt_filter_log(path, chr_vec, somatic_info_by_chr):
    """ReadHpDistriLog::writeDenseAltFilterLog (HaplotagLogging.cpp:492-529).
    Positions print as stored (0-based) -- the reference does not add 1."""
    with open(path, "w") as f:
        f.write("###################################################\n")
        f.write("# DenseAlt filter log #\n")
        f.write("###################################################\n")
        f.write("Chr\tPos\tDenseAltSameCount\n")
        for chrom in chr_vec:
            si = somatic_info_by_chr.get(chrom)
            if si is None:
                continue
            for pos in sorted(si):
                f.write(f"{chrom}\t{pos}\t{si[pos].dense_alt_same_count}\n")


def write_pos_cover_region_log(path, chr_vec, distri_by_chr):
    """ReadHpDistriLog::writePosCoverRegionLog (HaplotagLogging.cpp:291-341).
    Never-recorded positions print the INT_MAX/INT_MIN sentinels."""
    total = sum(len(distri_by_chr.get(c, {})) for c in chr_vec)
    with open(path, "w") as f:
        f.write("############################\n")
        f.write("# Somatic SNP cover region #\n")
        f.write("############################\n")
        f.write(f"##SomaticSNP: {total}\n")
        f.write("#Chr\tPos\tType\tStartPos\tEndPos\n")
        for chrom in chr_vec:
            d = distri_by_chr.get(chrom, {})
            for pos in sorted(d):
                rec = d[pos]
                f.write(f"{chrom}\t{pos + 1}\tsomatic\t"
                        f"{rec.cover_start}\t{rec.cover_end}\n")


def write_tag_read_cover_region_log(path, chr_vec, distri_by_chr, chr_length):
    """ReadHpDistriLog::writeTagReadCoverRegionLog (HaplotagLogging.cpp:352-463).

    The merge walks positions in map order without sorting the region
    bounds; untag-only positions contribute INT_MAX/INT_MIN sentinel
    regions whose lengths wrap in int32, exactly as the C++ does."""
    from .haplotag import cpp_double
    cover = {}
    for chrom in chr_vec:
        d = distri_by_chr.get(chrom, {})
        poss = sorted(d)
        if not poss:
            continue
        regions = []
        cur_start = d[poss[0]].cover_start
        cur_end = d[poss[0]].cover_end
        for i in range(len(poss)):
            if i + 1 < len(poss):
                nxt = d[poss[i + 1]]
                if cur_end < nxt.cover_start:
                    regions.append((cur_start, cur_end,
                                    _i32(cur_end - cur_start + 1)))
                    cur_start, cur_end = nxt.cover_start, nxt.cover_end
                else:
                    cur_start = min(cur_start, nxt.cover_start)
                    cur_end = max(cur_end, nxt.cover_end)
            else:
                regions.append((cur_start, cur_end,
                                _i32(cur_end - cur_start + 1)))
        cover[chrom] = regions
    ratio = {}
    total_len = 0
    total_cover = 0
    with np.errstate(invalid="ignore", divide="ignore"):
        for chrom in chr_vec:
            tot = 0
            for _s, _e, ln in cover.get(chrom, []):
                tot = _i32(tot + ln)
            ratio[chrom] = float(np.float32(tot)
                                 / np.float32(chr_length.get(chrom, 0)))
            total_len += chr_length.get(chrom, 0)
            total_cover += tot
        total_ratio = float(np.float64(total_cover) / np.float64(total_len))
    with open(path, "w") as f:
        f.write("##################################\n")
        f.write("# Somatic reads cover region bed #\n")
        f.write("##################################\n")
        f.write("##----Chr coverage ratio----\n")
        f.write(f"##Total chr coverage ratio: {cpp_double(total_ratio)}\n")
        for chrom in chr_vec:
            f.write(f"##{chrom}:{cpp_double(ratio[chrom])}\n")
        f.write("#Chr\tStartPos\tEndPos\n")
        for chrom in chr_vec:
            for s, e, _ln in cover.get(chrom, []):
                f.write(f"{chrom}\t{s}\t{e}\n")


def apply_somatic_flags(state: SomaticCallState, chr_vec):
    """getSomaticFlag (SomaticVarCaller.cpp:2397-2412).

    Returns chr -> {pos: derive_by_hp} for flagged somatic variants."""
    flags: dict[str, dict[int, int]] = {}
    count = 0
    for chrom in chr_vec:
        for pos, sd in state.somatic_info.get(chrom, {}).items():
            if sd.is_high_con:
                flags.setdefault(chrom, {})[pos] = sd.somatic_read_derive_by_hp
                count += 1
    print(f"somatic variant count(Flag): {count}", file=sys.stderr)
    return flags


def write_somatic_vcf(tumor_snv_file, out_path, chr_multi, somatic_flags,
                      version, command):
    """VcfParser::writeProcess -> _sc.vcf (HaplotagVcfParser.cpp:548-614)."""
    wrote_command = False
    with open_maybe_bgzf(tumor_snv_file) as fin, open(out_path, "w") as fout:
        for line in fin:
            line = line.rstrip("\n")
            if len(line) >= 2 and line.startswith("##"):
                fout.write(line + "\n")
            elif len(line) >= 6 and (line.startswith("#CHROM")
                                     or line.startswith("#chrom")):
                if not wrote_command:
                    fout.write(f"##longphase_s_version={version}\n")
                    fout.write(f"##commandline={command}\n")
                    wrote_command = True
                fout.write(line + "\n")
            elif line.startswith("#") or not line:
                continue
            else:
                f = line.split()
                if len(f) < 7:
                    raise SystemExit(f"VCF file format error: {line}")
                pos0 = int(f[1]) - 1
                chrom = f[0]
                entry = chr_multi.get(chrom, {}).get(pos0)
                if entry is None:
                    continue
                tum = entry.get(TUMOR)
                if tum is None or tum.variant_type not in (
                        VT_SNP, VT_INSERTION, VT_DELETION):
                    continue
                is_somatic = pos0 in somatic_flags.get(chrom, {})
                if is_somatic:
                    if f[6] != "PASS":
                        f[6] = "PASS"
                else:
                    if f[6] == "PASS":
                        f[6] = "LowQual"
                fout.write("\t".join(f) + "\n")


# ---------------------------------------------------------------------------
# Somatic tagging pass
# ---------------------------------------------------------------------------

def _gather_tag_segments(segs, all_rec, all_mode, all_ps, all_pq, hp_strs,
                         stats):
    """Multi-host merge of the per-chromosome tag decisions: all-gather each
    process's (chr_vec-indexed) record/mode/PS/PQ/HP:Z segments plus the
    tag-statistics counters; every process returns the full set in chr_vec
    order (record indices refer to the shared tumor BAM, identical on every
    host). The stats counters are psum-merged in place."""
    import io as _io

    from ..parallel import distributed as dist

    buf = _io.BytesIO()
    hp_blob = "".join(hp_strs).encode("ascii")
    hp_off = np.zeros(len(hp_strs) + 1, np.int64)
    np.cumsum([len(s) for s in hp_strs], out=hp_off[1:])
    np.savez(buf, segs=np.asarray(segs, np.int64).reshape(-1, 2),
             rec=np.concatenate(all_rec) if all_rec else np.zeros(0, np.int64),
             mode=np.concatenate(all_mode) if all_mode
             else np.zeros(0, np.uint8),
             ps=np.concatenate(all_ps) if all_ps else np.zeros(0, np.int64),
             pq=np.concatenate(all_pq) if all_pq else np.zeros(0, np.int32),
             hp_blob=np.frombuffer(hp_blob, np.uint8), hp_off=hp_off)
    entries = []
    for blob in dist.allgather_bytes(buf.getvalue()):
        z = np.load(_io.BytesIO(blob))
        off = 0
        for ci, n in z["segs"].reshape(-1, 2):
            sl = slice(off, off + int(n))
            hb, ho = z["hp_blob"].tobytes(), z["hp_off"]
            entries.append((int(ci), z["rec"][sl], z["mode"][sl], z["ps"][sl],
                            z["pq"][sl],
                            [hb[ho[k]:ho[k + 1]].decode("ascii")
                             for k in range(sl.start, sl.stop)]))
            off += int(n)
    entries.sort(key=lambda e: e[0])
    counters = {f.name: getattr(stats, f.name)
                for f in stats.__dataclass_fields__.values()
                if f.name != "hp_count"}
    counters.update({f"hp_{k}": v for k, v in stats.hp_count.items()})
    merged = dist.psum_counters(counters)
    for k, v in merged.items():
        if k.startswith("hp_"):
            stats.hp_count[int(k[3:])] = v
        else:
            setattr(stats, k, v)
    return ([e[1] for e in entries], [e[2] for e in entries],
            [e[3] for e in entries], [e[4] for e in entries],
            [s for e in entries for s in e[5]])


def _somatic_tag_fast(cfg, tum_nb, chr_vec, chr_length, chr_multi,
                      somatic_flags, nor_info, fasta, stats, my_chroms=None,
                      tables=None):
    """Vectorized tumor-BAM tagging (SomaticHaplotagChrProcessor +
    SomaticHaplotagStrategy, SomaticHaplotagProcess.cpp:310-536) over the
    native walk; writes HP:Z/PS:i/PQ:i with the native tag writer."""
    from .. import native
    from ..core.somatic_fast import (build_somatic_tables, judge_somatic_reads,
                                     nor_ps_aggregate, obs_is_alt,
                                     somatic_match_votes)
    from ..io.bam import region_bounds

    from ..io.cram import open_alignment as _open_aln
    hdr_reader = _open_aln(cfg.tumor_bam_file)  # header only (BAM or CRAM)
    header = hdr_reader.header_text
    if header and not header.endswith("\n"):
        header += "\n"
    header += (f"@PG\tID:longphase-s\tPN:longphase-s\tVN:{REFERENCE_VERSION}"
               f"\tCL:{cfg.command}\n")
    ref_ids = hdr_reader.ref_id
    hdr_reader.close()
    sv_counts = nor_info.read_sv_hap_count

    all_rec, all_mode, all_ps, all_pq = [], [], [], []
    all_hp: list[np.ndarray] = []
    hp_strs: list[str] = []  # sharded mode only (string gather)
    segs: list[tuple[int, int]] = []  # (chr_vec index, n records) per chrom
    loop = chr_vec if my_chroms is None else my_chroms

    from ..ops import tag_kernels

    # pass 1: walk every chromosome and stage the kernel inputs, so the
    # reductions can batch across the device mesh (contig parallelism —
    # the tag-pass analog of _mesh_precompute)
    ctxs = []
    total_obs = 0
    for chrom in loop:
        if chrom not in ref_ids:
            continue
        variants = chr_multi.get(chrom, {})
        positions = sorted(variants)
        last = _last_var_pos(positions, variants, TUMOR)
        ref_string = (fasta.fetch(chrom, 0, last + 6)
                      if chrom in fasta.index and positions else "")
        chrom_len = chr_length.get(chrom)
        beg, end = region_bounds(cfg.region, chrom_len) if cfg.region \
            else (0, chrom_len)
        last_var = positions[-1] if positions else None
        walk = tum_nb.tag_walk(chrom, beg, end, positions, last_var,
                               ref_string, cfg.quality_threshold, True,
                               cfg.tag_supplementary)
        if walk is None:
            continue
        t = tables.get(chrom) if tables else None
        if t is None:
            t = build_somatic_tables(positions, variants)
        flags = somatic_flags.get(chrom, {})
        n_var = len(positions)
        is_som = np.zeros(n_var, bool)
        derive = np.zeros(n_var, np.int8)
        for i, p in enumerate(positions):
            if p in flags:
                is_som[i] = True
                derive[i] = flags[p]
        ctxs.append({"chrom": chrom, "walk": walk, "t": t, "is_som": is_som,
                     "derive": derive, "dev": None})
        total_obs += len(walk["obs_var"])

    if _mesh_devices() is not None and ctxs \
            and tag_kernels.engine(total_obs) == "device":
        from ..parallel.mesh import make_mesh

        res = tag_kernels.somatic_counts_device_mesh(
            make_mesh(_mesh_devices()), ctxs, "haplotag", want_derive=True)
        for c, r in zip(ctxs, res or ()):
            c["dev"] = r

    for ctx in ctxs:
        chrom = ctx["chrom"]
        walk, t = ctx["walk"], ctx["t"]
        is_som, derive = ctx["is_som"], ctx["derive"]
        vi = walk["obs_var"]
        al = walk["obs_aln"]
        A = len(walk["category"])
        dev = ctx["dev"]
        if dev is None and tag_kernels.engine(len(walk["obs_var"])) \
                == "device":
            dev = tag_kernels.somatic_counts_device(
                walk, t, "haplotag", is_som=is_som, derive=derive,
                want_derive=True)
        if dev is not None:
            h1_cnt, h2_cnt, h3_cnt = (dev["h1_cnt"], dev["h2_cnt"],
                                      dev["h3_cnt"])
            n_ps, min_ps = dev["n_ps"], dev["min_ps"]
            d1, d2 = dev["d1_cnt"], dev["d2_cnt"]
        else:
            is_alt = obs_is_alt(walk, t)
            votes = somatic_match_votes(walk, t, is_alt, "haplotag",
                                        is_somatic=is_som)
            h1_cnt = np.bincount(al[votes["h1"]],
                                 minlength=A).astype(np.int64)
            h2_cnt = np.bincount(al[votes["h2"]],
                                 minlength=A).astype(np.int64)
            h3_cnt = np.bincount(al[votes["h3"]],
                                 minlength=A).astype(np.int64)
            n_ps, min_ps, _triples = nor_ps_aggregate(walk, t,
                                                      votes["cps_nor"])
            # inheritHaplotype derive counts
            # (SomaticHaplotagProcess.cpp:461-527)
            h3_idx = np.flatnonzero(votes["h3"])
            dv = derive[vi[h3_idx]]
            d1 = np.bincount(al[h3_idx[dv == GERMLINE_H1]],
                             minlength=A).astype(np.int64)
            d2 = np.bincount(al[h3_idx[dv == GERMLINE_H2]],
                             minlength=A).astype(np.int64)

        if sv_counts:
            names = walk["names"]
            noff = walk["name_off"]
            for a in np.flatnonzero(walk["category"] == 0):
                entry = sv_counts.get(names[noff[a]:noff[a + 1]])
                if entry is not None:
                    h1_cnt[a] += entry[0]
                    h2_cnt[a] += entry[1]

        hp, pq, _nsim, high_sim, cross, without = judge_somatic_reads(
            h1_cnt, h2_cnt, h3_cnt, n_ps, cfg.percentage_threshold)
        mx = np.maximum(d1, d2).astype(np.float32)
        mn = np.minimum(d1, d2).astype(np.float32)
        with np.errstate(invalid="ignore"):
            sim = np.where(mx > 0, mx / (mx + mn), np.float32(0.0))
        inherit = (hp == RH_H3) & (sim >= cfg.percentage_threshold)
        hp[inherit & (d1 > d2)] = RH_H1_1
        hp[inherit & ~(d1 > d2)] = RH_H2_1

        cat = walk["category"]
        flag = walk["flag"]
        stats.total_alignment += A
        cat_counts = np.bincount(cat, minlength=7)
        stats.total_lower_quality += int(cat_counts[1])
        stats.total_unmapped += int(cat_counts[2])
        stats.total_secondary += int(cat_counts[3])
        stats.total_supplementary += int(cat_counts[4])
        stats.total_empty_variant += int(cat_counts[5])
        stats.total_other_case += int(cat_counts[6])
        proc = cat == 0
        stats.total_supplementary += int(
            np.count_nonzero(proc & ((flag & 0x800) != 0)))
        stats.total_high_similarity += int(np.count_nonzero(high_sim[proc]))
        stats.total_cross_two_block += int(np.count_nonzero(cross[proc]))
        stats.total_without_variant += int(np.count_nonzero(without[proc]))
        tagged = proc & (hp != RH_UNTAG)
        n_tag = int(np.count_nonzero(tagged))
        stats.total_tag_count += n_tag
        stats.total_untag_count += A - n_tag
        for cls in (RH_H1, RH_H2, RH_H1_1, RH_H2_1, RH_H3):
            n = int(np.count_nonzero(tagged & (hp == cls)))
            if n:
                stats.hp_count[cls] = stats.hp_count.get(cls, 0) + n
        n_untag_proc = int(np.count_nonzero(proc)) - n_tag
        if n_untag_proc:
            stats.hp_count[RH_UNTAG] = \
                stats.hp_count.get(RH_UNTAG, 0) + n_untag_proc

        # PS value (SomaticHaplotagProcess.cpp:409-430)
        ps = min_ps.copy()
        germline_tag = tagged & ((hp == RH_H1) | (hp == RH_H2))
        somatic_tag = tagged & ~germline_tag
        ps[germline_tag & (n_ps == 0)] = 0
        ps[somatic_tag & (n_ps == 0)] = native.PS_OMIT

        mode = np.zeros(A, np.uint8)
        mode[proc] = 1
        mode[tagged] = 3
        all_rec.append(walk["rec_idx"])
        all_mode.append(mode)
        all_ps.append(ps)
        all_pq.append(pq)
        all_hp.append(hp)
        if my_chroms is not None:
            hp_strs.extend(READ_HP_STR[int(h)] if m == 3 else ""
                           for h, m in zip(hp, mode))
        segs.append((chr_vec.index(chrom), len(walk["rec_idx"])))

    if my_chroms is not None:
        all_rec, all_mode, all_ps, all_pq, hp_strs = _gather_tag_segments(
            segs, all_rec, all_mode, all_ps, all_pq, hp_strs, stats)
        from ..parallel import distributed as dist

        if not dist.is_writer():
            return

    writer = tum_nb.tag_write_cram if cfg.output_cram else tum_nb.tag_write
    out_path = cfg.result_prefix + (".cram" if cfg.output_cram else ".bam")
    if all_rec:
        rec = np.concatenate(all_rec)
        mode_all = np.concatenate(all_mode)
        if my_chroms is None:
            # vectorized HP:Z blob: per-record string = READ_HP_STR[hp]
            # when mode == 3, else empty (a python per-read loop here costs
            # more than the whole native write dispatch)
            hp_all = np.concatenate(all_hp).astype(np.int64)
            lut_len = np.zeros(16, np.int64)
            lut_chr = np.zeros((16, 4), np.uint8)
            for k, s in READ_HP_STR.items():
                lut_len[k] = len(s)
                lut_chr[k, :len(s)] = np.frombuffer(s.encode(), np.uint8)
            # mask before indexing: non-somatic records (mode != 3) carry
            # whatever hp the judge left, which need not be a valid LUT key
            hp_all = np.where(mode_all == 3, hp_all, 0)
            sel_len = np.where(mode_all == 3, lut_len[hp_all], 0)
            off = np.zeros(len(rec) + 1, np.int64)
            np.cumsum(sel_len, out=off[1:])
            rep_cls = np.repeat(hp_all, sel_len)
            pos_in = np.arange(int(off[-1]), dtype=np.int64) - \
                np.repeat(off[:-1], sel_len)
            hp_payload = (lut_chr[rep_cls, pos_in].tobytes(), off)
        else:
            hp_payload = hp_strs
        ok = writer(header, rec, mode_all,
                    np.zeros(len(rec), np.int32),
                    np.concatenate(all_ps), np.concatenate(all_pq),
                    hp_payload, out_path)
    else:
        ok = writer(header, np.zeros(0, np.int64),
                    np.zeros(0, np.uint8), np.zeros(0, np.int32),
                    np.zeros(0, np.int64), np.zeros(0, np.int32),
                    [], out_path)
    if not ok:
        raise RuntimeError("native tag write failed")


class SomaticTagWalker(CigarWalk):
    """SomaticHaplotagCigarParser (SomaticHaplotagProcess.cpp:538-579)."""

    def __init__(self, positions, variants, ref_string, somatic_flags,
                 benchmark=None, chrom=""):
        super().__init__(positions, variants, ref_string)
        self.somatic_flags = somatic_flags  # pos -> derive_by_hp
        self.benchmark = benchmark
        self.chrom = chrom
        self.hp_count = None
        self.variants_hp = None
        self.nor_count_ps = None
        self.tum_count_ps = None
        self.derive_hp = None

    def begin_read(self):
        self.hp_count = {1: 0, 2: 0, 3: 0, 4: 0}
        self.variants_hp = {}
        self.nor_count_ps = {}
        self.tum_count_ps = {}
        self.derive_hp = {}   # pos -> (baseHP, deriveHP)

    def process_match(self, pos, entry, base, is_alt, op_len, ci):
        is_somatic = pos in self.somatic_flags
        judge_somatic_snp_hap(pos, entry, base, is_alt, self.hp_count,
                              self.nor_count_ps, self.tum_count_ps,
                              self.variants_hp, None, "haplotag",
                              is_somatic=is_somatic)
        if is_somatic:
            base_hp = NONE_SNP
            if self.variants_hp.get(pos) == SOMATIC_H3:
                base_hp = SOMATIC_H3
            self.derive_hp[pos] = (base_hp, self.somatic_flags[pos])
        if self.benchmark is not None:
            self.benchmark.record_ref_alt(self.chrom, pos, entry, base)

    def process_deletion(self, pos, entry, op_len, ci, state):
        if self.benchmark is not None:
            self.benchmark.record_del(self.chrom, pos, entry)


def inherit_haplotype(derive_hp, percentage_threshold):
    """SomaticHaplotagChrProcessor::inheritHaplotype
    (SomaticHaplotagProcess.cpp:461-527). Returns (new_hp or None, similarity)."""
    d1 = 0
    d2 = 0
    for base_hp, derive in derive_hp.values():
        if base_hp == SOMATIC_H3:
            if derive == GERMLINE_H1:
                d1 += 1
            elif derive == GERMLINE_H2:
                d2 += 1
    if d1 > d2:
        mx, mn, max_hp = d1, d2, GERMLINE_H1
    else:
        mx, mn, max_hp = d2, d1, GERMLINE_H2
    # C++ computes the similarity in float: (float)max/((float)max+(float)min)
    sim = 0.0 if mx == 0 else float(np.float32(mx)
                                    / (np.float32(mx) + np.float32(mn)))
    if sim >= percentage_threshold:
        return (RH_H1_1 if max_hp == GERMLINE_H1 else RH_H2_1), sim
    return None, sim


def _write_somatic_log_header(f, cfg: SomaticConfig):
    """SomaticTagLog header (SomaticHaplotagProcess.cpp:581-612)."""
    from .haplotag import cpp_double

    f.write(f"##normalSnpFile:{cfg.snp_file}\n")
    f.write(f"##tumorSnvFile:{cfg.tumor_snv_file}\n")
    f.write(f"##svFile:{cfg.sv_file}\n")
    f.write(f"##tumorBamFile:{cfg.tumor_bam_file}\n")
    f.write(f"##bamFile:{cfg.bam_file}\n")
    f.write(f"##resultPrefix:{cfg.result_prefix}\n")
    f.write(f"##numThreads:{cfg.num_threads}\n")
    f.write(f"##region:{cfg.region}\n")
    f.write(f"##qualityThreshold:{cfg.quality_threshold}\n")
    f.write(f"##somaticCallingThreshold:{cfg.quality_threshold}\n")
    f.write(f"##percentageThreshold:{cpp_double(cfg.percentage_threshold)}\n")
    f.write(f"##tagSupplementary:{int(cfg.tag_supplementary)}\n")
    f.write("#ReadID\tCHROM\tReadStart\tConfidnet(%)\tderiveByHpSimilarity\t"
            "Haplotype\tPhaseSet\tTotalAllele\tHP1Allele\tHP2Allele\t"
            "HP3Allele\tHP4Allele\tphasingQuality(PQ)\t(Variant,HP)\t"
            "(PhaseSet,Variantcount)\n")


def _write_somatic_log_row(f, rec, chrom, walker, hp, pq, nor_sim, derive_sim,
                           hp_str, ps_str):
    """SomaticTagLog::writeTagReadLog (SomaticHaplotagProcess.cpp:614-654)."""
    from .haplotag import cpp_double

    hc = walker.hp_count
    f.write(f"{rec.qname}\t{chrom}\t{rec.pos}\t{cpp_double(nor_sim)}\t"
            f"{cpp_double(derive_sim)}\tH{hp_str}\t{ps_str}\t"
            f"{hc[1] + hc[2] + hc[3] + hc[4]}\t{hc[1]}\t{hc[2]}\t{hc[3]}\t"
            f"{hc[4]}\t{pq}\t\t")
    for pos in sorted(walker.variants_hp):
        f.write(f" {pos + 1},{walker.variants_hp[pos]}")
    f.write("\t")
    f.write("NorPS:")
    for ps in sorted(walker.nor_count_ps):
        f.write(f" {ps},{walker.nor_count_ps[ps]}")
    f.write(" TumPS:")
    for ps in sorted(walker.tum_count_ps):
        f.write(f" {ps},{walker.tum_count_ps[ps]}")
    f.write("\n")


def run_somatic_haplotag(cfg: SomaticConfig) -> ReadStatistics:
    from ..parallel import distributed as dist

    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    timer = StageTimer()
    stats = ReadStatistics()

    chr_multi: dict[str, dict[int, dict[int, object]]] = {}
    nor_info = VcfInfo(sample=NORMAL)
    tum_info = VcfInfo(sample=TUMOR)
    reader = PhasedVcfReader(NORMAL)
    with timer("parsing normal phased SNP VCF"):
        reader.parse(cfg.snp_file, nor_info, chr_multi, mode="snp")
    if cfg.sv_file:
        with timer("parsing SV VCF"):
            reader.parse(cfg.sv_file, nor_info, chr_multi, mode="sv")
    if cfg.mod_file:
        with timer("parsing MOD VCF"):
            reader.parse(cfg.mod_file, nor_info, chr_multi, mode="mod")
    with timer("parsing tumor SNP VCF"):
        tum_reader = PhasedVcfReader(TUMOR)
        tum_reader.parse(cfg.tumor_snv_file, tum_info, chr_multi, mode="snp")

    from ..core.somatic_benchmark import SomaticReadBenchmark

    benchmark = SomaticReadBenchmark(cfg.truth_vcf, cfg.truth_bed,
                                     cfg.quality_threshold)
    truth_info = VcfInfo(sample=2)
    in_bed_flags: dict[str, dict[int, bool]] = {}
    if cfg.truth_vcf:
        benchmark.enabled = True
        with timer("[Benchmark] parsing truth VCF"):
            benchmark.load_truth_vcf(chr_multi, truth_info)
        if cfg.truth_bed:
            with timer("[Benchmark] parsing truth BED file"):
                benchmark.parse_bed()
            benchmark.mark_variants_in_bed(tum_info.chr_vec, chr_multi,
                                           in_bed_flags)

    # setChrVecAndChrLength (SomaticHaplotagProcess.cpp:149-194)
    for chrom, length in tum_info.chr_length.items():
        if chrom in nor_info.chr_length:
            if length != nor_info.chr_length[chrom]:
                print("[ERROR] tumor & normal VCFs chromosome length differ",
                      file=sys.stderr)
                break
    chr_vec = tum_info.chr_vec if tum_info.chr_vec else nor_info.chr_vec
    chr_length = tum_info.chr_length if tum_info.chr_length else nor_info.chr_length

    if cfg.region:
        region_chr = cfg.region.split(":")[0]
        if region_chr not in chr_vec:
            print(f"[ERROR] Incorrect chromosome for input region: {region_chr}",
                  file=sys.stderr)
            sys.exit(1)
        chr_vec = [region_chr]
    for chrom in list(chr_multi):
        if chrom not in chr_vec:
            del chr_multi[chrom]

    fasta = FastaFile(cfg.fasta_file)

    # multi-host: shard extraction/calling/tagging by contig; the log and
    # benchmark paths stay unsharded (every process computes everything and
    # only process 0 writes)
    shard = dist.is_active() and not (cfg.write_read_log
                                      or cfg.write_calling_log
                                      or benchmark.enabled)
    my_chroms = dist.shard_contigs(chr_vec) if shard else chr_vec

    state = run_somatic_calling(cfg, chr_vec, chr_length, chr_multi,
                                nor_info.read_sv_hap_count, fasta, timer,
                                loop_chroms=my_chroms)
    if cfg.write_calling_log and dist.is_writer():
        with timer("writing somatic variants calling log"):
            write_somatic_var_log(cfg, state, chr_vec, chr_multi)
            write_dense_interval_log(cfg, state, chr_vec)
            write_read_hp_distri_log(
                cfg.result_prefix + "_read_distri_scaller.out",
                chr_vec, state.caller_distri)
            remove_not_derive_by_h1h2(chr_vec, state.caller_distri)
            write_read_hp_distri_log(
                cfg.result_prefix + "_read_distri_scaller_derive_by_H1_H2.out",
                chr_vec, state.caller_distri)
            write_densealt_filter_log(
                cfg.result_prefix + "_densealt_filter.log",
                chr_vec, state.somatic_info)
            write_somatic_filter_log(cfg, state, chr_vec)
            write_read_count_filter_log(cfg, state, chr_vec)
            write_messy_read_filter_log(cfg, state, chr_vec)
            write_read_hp_detail_log(cfg, state, chr_vec)
    somatic_flags = apply_somatic_flags(state, chr_vec)
    if shard:
        import json as _json

        merged_flags: dict[str, dict[int, int]] = {}
        for blob in dist.allgather_bytes(_json.dumps(
                {c: {str(p): v for p, v in d.items()}
                 for c, d in somatic_flags.items()}).encode()):
            for c, d in _json.loads(blob).items():
                merged_flags.setdefault(c, {}).update(
                    {int(p): v for p, v in d.items()})
        somatic_flags = merged_flags

    if cfg.write_somatic_vcf and dist.is_writer():
        with timer("writing somatic variants to vcf file"):
            write_somatic_vcf(cfg.tumor_snv_file,
                              cfg.result_prefix + "_sc.vcf", chr_multi,
                              somatic_flags, REFERENCE_VERSION, cfg.command)

    if benchmark.loaded_bed and benchmark.enabled:
        with timer("[Benchmark] removing tumor & truth somatic variants "
                   "outside bed regions"):
            benchmark.remove_variants_out_bed(chr_multi, in_bed_flags)

    # ---- tag tumor BAM (SINGLE_THREAD + output) --------------------------
    _nor_nb, tum_nb = _native_bams(cfg)
    if tum_nb is not None and not (cfg.write_read_log or cfg.write_calling_log
                                   or benchmark.enabled):
        with timer("tag read"):
            _somatic_tag_fast(cfg, tum_nb, chr_vec, chr_length, chr_multi,
                              somatic_flags, nor_info, fasta, stats,
                              my_chroms=my_chroms if shard else None,
                              tables=state.tables)
        _print_somatic_report(stats)
        return stats

    if dist.is_active() and not dist.is_writer():
        # unsharded (log/benchmark) object path: calling ran everywhere for
        # the shared statistics, but only process 0 tags and writes files
        return stats

    from ..io.cram import CramWriter, open_alignment
    bam = open_alignment(cfg.tumor_bam_file, fasta)
    header = bam.header_text
    if header and not header.endswith("\n"):
        header += "\n"
    header += (f"@PG\tID:longphase-s\tPN:longphase-s\tVN:{REFERENCE_VERSION}"
               f"\tCL:{cfg.command}\n")
    if cfg.output_cram:
        out = CramWriter(cfg.result_prefix + ".cram", header, bam.references,
                         bam.lengths, fasta_path=cfg.fasta_file)
    else:
        out = BamWriter(cfg.result_prefix + ".bam", header, bam.references,
                        bam.lengths)

    log_f = None
    if cfg.write_read_log:
        log_f = open(cfg.result_prefix + ".out", "w")
        _write_somatic_log_header(log_f, cfg)

    # hpBeforeInheritance / hpAfterInheritance ReadHpDistriLog state
    hp_before: dict[str, dict[int, PosHpRecord]] = {}
    hp_after: dict[str, dict[int, PosHpRecord]] = {}

    with timer("tag read"):
        for chrom in chr_vec:
            if chrom not in bam.ref_id:
                continue
            before_d = hp_before.setdefault(chrom, {})
            after_d = hp_after.setdefault(chrom, {})
            variants = chr_multi.get(chrom, {})
            positions = sorted(variants)
            last = _last_var_pos(positions, variants, TUMOR)
            ref_string = (fasta.fetch(chrom, 0, last + 6)
                          if chrom in fasta.index and positions else "")
            walker = SomaticTagWalker(positions, variants, ref_string,
                                      somatic_flags.get(chrom, {}),
                                      benchmark=benchmark, chrom=chrom)
            bam2 = open_alignment(cfg.tumor_bam_file, fasta)
            for rec, cat in iter_somatic_reads(
                    bam2, chrom, chr_length.get(chrom), positions,
                    cfg.quality_threshold, cfg.tag_supplementary,
                    mapping_quality_filter=True, region=cfg.region):
                stats.total_alignment += 1
                if cat == "low_quality":
                    stats.total_lower_quality += 1
                    stats.total_untag_count += 1
                elif cat == "unmapped":
                    stats.total_unmapped += 1
                    stats.total_untag_count += 1
                elif cat == "secondary":
                    stats.total_secondary += 1
                    stats.total_untag_count += 1
                elif cat == "supplementary":
                    stats.total_supplementary += 1
                    stats.total_untag_count += 1
                elif cat == "empty_variants":
                    stats.total_empty_variant += 1
                    stats.total_untag_count += 1
                elif cat == "other":
                    stats.total_other_case += 1
                    stats.total_untag_count += 1
                else:
                    if rec.flag & 0x800:
                        stats.total_supplementary += 1
                    walker.begin_read()
                    walker.walk(rec)
                    entry = nor_info.read_sv_hap_count.get(rec.qname)
                    if entry is not None:
                        walker.hp_count[1] += entry[0]
                        walker.hp_count[2] += entry[1]
                    hp, pq, nor_sim, _ts = judge_somatic_read_hap(
                        walker.hp_count, walker.nor_count_ps,
                        cfg.percentage_threshold, stats)
                    hp_before_inh = hp
                    derive_sim = 0.0
                    if hp == RH_H3:
                        new_hp, derive_sim = inherit_haplotype(
                            walker.derive_hp, cfg.percentage_threshold)
                        if new_hp is not None:
                            hp = new_hp
                    if cfg.write_calling_log and walker.derive_hp:
                        # SomaticHaplotagProcess.cpp:377-395: record the read
                        # HP before/after inheritance at every somatic pos on
                        # the read; cover region only for tagged reads.
                        start_pos = rec.pos + 1
                        end_pos = walker.ref_pos
                        for pp, (bhp, dhp) in walker.derive_hp.items():
                            rb = before_d.get(pp)
                            if rb is None:
                                rb = before_d[pp] = PosHpRecord()
                            rb.record_read_hp(hp_before_inh, bhp)
                            rb.record_derive_hp(dhp, 0.0)
                            ra = after_d.get(pp)
                            if ra is None:
                                ra = after_d[pp] = PosHpRecord()
                            ra.record_read_hp(hp, bhp)
                            ra.record_derive_hp(dhp, derive_sim)
                            if hp != RH_UNTAG:
                                ra.record_cover_region(start_pos, end_pos)
                    if benchmark.enabled:
                        benchmark.record_tagged_read(
                            chrom, rec.qname, hp, walker.variants_hp,
                            walker.hp_count, nor_sim, derive_sim, variants)
                        benchmark.record_crossing_read(
                            chrom, rec.qname, hp, walker.variants_hp,
                            walker.hp_count, nor_sim, derive_sim, variants)
                    if (walker.hp_count[1] == 0 and walker.hp_count[2] == 0
                            and walker.hp_count[3] != 0 and hp == RH_H3):
                        pass  # totalreadOnlyH3Snp counter (report only)

                    # PS value (SomaticHaplotagProcess.cpp:409-430)
                    ps = 0
                    ps_str = "."
                    if hp != RH_UNTAG:
                        if hp not in (RH_H1, RH_H2):
                            if walker.nor_count_ps:
                                ps = min(walker.nor_count_ps)
                                ps_str = str(ps)
                            else:
                                ps = NONE_PHASED_SET
                                ps_str = "*"
                        else:
                            ps = min(walker.nor_count_ps) if walker.nor_count_ps else 0
                            ps_str = str(ps)

                    if log_f is not None:
                        _write_somatic_log_row(
                            log_f, rec, chrom, walker, hp, pq, nor_sim,
                            derive_sim, READ_HP_STR[hp], ps_str)

                    rec.strip_tags({"HP", "PS", "PQ"})
                    if hp != RH_UNTAG:
                        stats.bump_hp(hp)
                        stats.total_tag_count += 1
                        rec.append_tag_str("HP", READ_HP_STR[hp])
                        if ps != NONE_PHASED_SET:
                            rec.append_tag_int("PS", ps)
                        rec.append_tag_int("PQ", pq)
                    else:
                        stats.bump_hp(RH_UNTAG)
                        stats.total_untag_count += 1
                out.write(rec)
            bam2.close()
    out.close()
    if log_f is not None:
        log_f.close()

    if benchmark.enabled:
        with timer("[Benchmark] writing somatic haplotagging metrics report"):
            benchmark.write_metrics_report(
                chr_vec, cfg.result_prefix + "_somatic_haplotag.metrics")

    if cfg.write_calling_log:
        # SomaticHaplotagProcess::postprocessForHaplotag (.cpp:232-243)
        write_read_hp_distri_log(
            cfg.result_prefix + "_read_distri_before_inheritance.out",
            chr_vec, hp_before)
        write_read_hp_distri_log(
            cfg.result_prefix + "_read_distri_after_inheritance.out",
            chr_vec, hp_after)
        write_pos_cover_region_log(
            cfg.result_prefix + "_snp_cover_region.out", chr_vec, hp_after)
        write_tag_read_cover_region_log(
            cfg.result_prefix + "_read_cover_region.bed", chr_vec, hp_after,
            chr_length)

    if cfg.write_benchmark_log and benchmark.enabled:
        # SomaticHaplotagProcess::postprocessForHaplotag (.cpp:245-251)
        benchmark.write_total_truth_report(
            chr_vec, cfg.result_prefix + "_total_truth_somatic_read.out")
        benchmark.write_tagged_read_report(
            chr_vec, cfg.result_prefix + "_total_tagged_read.out")
        benchmark.write_pos_allele_count_log(
            chr_vec, cfg.result_prefix + "_allele_count.out", chr_multi)
        benchmark.write_bed_region_log(chr_vec, chr_multi, in_bed_flags,
                                       cfg.result_prefix)

    _print_somatic_report(stats)
    return stats


def _print_somatic_report(stats):
    print("-------------------------------------------", file=sys.stderr)
    print(f"total alignment           : {stats.total_alignment}", file=sys.stderr)
    print(f"total tagged alignments   : {stats.total_tag_count}", file=sys.stderr)
    for hp in (RH_H1, RH_H2, RH_H1_1, RH_H2_1, RH_H3):
        print(f"    L----total HP{READ_HP_STR[hp]}     : "
              f"{stats.hp_count.get(hp, 0)}", file=sys.stderr)
    print(f"total untagged            : {stats.total_untag_count}", file=sys.stderr)


def run_estimate_purity(cfg: SomaticConfig) -> float:
    """estimate_purity pipeline (PurityEstimationProcess.cpp:34-71).

    Multi-host: each process extracts its contig shard, then the purity
    estimator all-gathers the per-shard feature points and filter tallies
    so the global statistics match a single-process run exactly."""
    from ..parallel import distributed as dist

    cfg.collect_offset_windows = False  # purity never reads offset_bases
    cfg.collect_read_sets = False       # ...nor the per-read hp record set
    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    timer = StageTimer()
    chr_multi: dict[str, dict[int, dict[int, object]]] = {}
    nor_info = VcfInfo(sample=NORMAL)
    tum_info = VcfInfo(sample=TUMOR)
    reader = PhasedVcfReader(NORMAL)
    with timer("parsing normal phased SNP VCF"):
        reader.parse(cfg.snp_file, nor_info, chr_multi, mode="snp")
    with timer("parsing tumor SNP VCF"):
        PhasedVcfReader(TUMOR).parse(cfg.tumor_snv_file, tum_info, chr_multi,
                                     mode="snp")
    chr_vec = tum_info.chr_vec if tum_info.chr_vec else nor_info.chr_vec
    chr_length = tum_info.chr_length if tum_info.chr_length else nor_info.chr_length
    for chrom in list(chr_multi):
        if chrom not in chr_vec:
            del chr_multi[chrom]
    fasta = FastaFile(cfg.fasta_file)

    state = SomaticCallState()
    my_chroms = dist.shard_contigs(chr_vec) if dist.is_active() else chr_vec
    _run_extraction(cfg, state, my_chroms, chr_multi, chr_length, fasta,
                    nor_info.read_sv_hap_count, timer)

    est = PurityEstimator(chr_vec, state.nor_base, state.somatic_info,
                          cfg.write_calling_log, cfg.result_prefix)
    purity = est.estimate()
    est.mark_statistic_flag()
    print(f"Tumor purity: {purity:.6g}", file=sys.stderr)
    return purity
