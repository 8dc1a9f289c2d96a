"""Germline phasing pipeline (reference: PhasingProcess.cpp:5-208).

Flow: parse SNP (+SV +METH) VCFs -> load reference windows -> per chromosome:
BAM allele extraction -> ONT SNP filter -> clip/CNV intervals -> graph phasing
-> merge results -> rewrite annotated VCF(s).

The per-chromosome compute body dispatches to either the host oracle
(``core.phase_algo``, exact reference semantics) or the device engine
(``core.fastpath`` / ``ops.engine``) which must produce identical results
and is the performance path.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .. import REFERENCE_VERSION
from ..core import phase_algo
from ..core.alleles import extract_chromosome
from ..core.clip import get_cnv_intervals
from ..core.phase_algo import PhaseParams, phase_chromosome
from ..core.snp_filter import filter_ont_snps
from ..io import vcf as vcf_io
from ..io.fasta import FastaFile
from ..utils import StageTimer


@dataclass
class PhaseConfig:
    snp_file: str
    bam_files: list[str]
    fasta_file: str
    result_prefix: str = "result"
    sv_file: str = ""
    mod_file: str = ""
    num_threads: int = 1
    is_ont: bool = False
    is_pb: bool = False
    phase_indel: bool = False
    indel_quality: int = 0
    dot: bool = False
    deepsomatic_output: bool = False
    command: str = ""
    engine: str = "oracle"  # "oracle" (host, exact) | "device" (kernels)
    checkpoint_dir: str = ""  # per-contig resume (SURVEY §5; ours-only)
    dist: str = ""  # "host:port,nprocs,pid" multi-host spec (SURVEY §2.6)
    params: PhaseParams = field(default_factory=PhaseParams)


def _local_device_count() -> int:
    import jax

    # per-process local devices: under jax.distributed each process
    # meshes only its own devices (contig shards are disjoint)
    return len(jax.local_devices() if jax.process_count() > 1
               else jax.devices())


def _make_multichip_sink(cfg):
    """A list to collect deferred chromosome tensors when more than one
    device is visible (LPS_MULTICHIP=0 disables, =1 forces), else None."""
    import os

    if cfg.engine != "device" or os.environ.get("LPS_MULTICHIP", "") == "0":
        return None
    if os.environ.get("LPS_MULTICHIP", "") == "1":
        return []
    return [] if _local_device_count() > 1 else None


def _drain_multichip(sink, cfg, record):
    """Run the batched mesh phase over the deferred chromosomes and convert
    the device outputs to per-chromosome result dicts (same conversion as
    core/fastpath.phase_chromosome_flat's tail)."""
    import os

    import numpy as np

    from ..ops.vote_scan import scan_engine
    from ..parallel.multichip import (run_fused_phase_multichip,
                                      run_fused_phase_wavefront)

    wf = os.environ.get("LPS_WAVEFRONT", "")
    # Fewer chromosomes than devices: the chromosome-batch mesh would
    # idle devices — wavefront-pipeline the site-sharded scan instead.
    if wf == "1" or (wf != "0" and len(sink) < _local_device_count()):
        outs = run_fused_phase_wavefront(sink, cfg.params)
    else:
        outs = run_fused_phase_multichip(sink, cfg.params, scan_engine())
    for e, (ps, ori) in zip(sink, outs):
        positions = e["positions"]
        result: dict[str, tuple[str, int]] = {}
        for i in np.nonzero(ps)[0]:
            o = int(ori[i])
            result[f"{e['chrom']}_{int(positions[i])}"] = \
                (f"{o}|{1 - o}", int(ps[i]))
        record(e["chrom"], result)


def run_phase(cfg: PhaseConfig) -> dict:
    from ..parallel import distributed as dist

    dist.init_from_spec(cfg.dist)
    dist.maybe_init_from_env()
    timer = StageTimer()
    cfg.params.is_ont = cfg.is_ont
    cfg.params.phase_indel = cfg.phase_indel
    cfg.params.indel_quality = cfg.indel_quality

    if getattr(cfg, "deepsomatic_output", False):
        with timer("preprocessing DeepSomatic VCF (filter GERMLINE, adjust GT by VAF)"):
            pre = cfg.result_prefix + "_preprocessed.vcf"
            if not dist.is_writer():  # avoid cross-process write races
                pre += f".p{dist.process_id()}"
            vcf_io.preprocess_deepsomatic_vcf(cfg.snp_file, pre)
            cfg.snp_file = pre

    with timer("parsing VCF"):
        het = vcf_io.read_het_variants(cfg.snp_file, cfg.phase_indel, cfg.indel_quality)
        if cfg.phase_indel and cfg.indel_quality > 0 and dist.is_writer():
            with open(cfg.result_prefix + "_removed_indels.log", "w") as f:
                f.write("#CHROM\tPOS\tREF\tALT\tQUAL\n")
                for line in het.removed_indel_log:
                    f.write(line + "\n")

    sv_set = None
    meth_set = None
    if cfg.sv_file:
        with timer("parsing SV VCF"):
            sv_set = vcf_io.read_sv_variants(cfg.sv_file, het)
    if cfg.mod_file:
        with timer("parsing Meth VCF"):
            meth_set = vcf_io.read_meth_variants(
                cfg.mod_file, het, sv_set or vcf_io.SVVariantSet())

    with timer("reading reference"):
        fasta = FastaFile(cfg.fasta_file)

    chr_results: dict[str, dict] = {}
    multichip_sink = _make_multichip_sink(cfg)

    ckpt = None
    if cfg.checkpoint_dir:
        from ..utils.checkpoint import ContigCheckpoint, phase_fingerprint

        ckpt = ContigCheckpoint(cfg.checkpoint_dir, phase_fingerprint(cfg))
        resumed = ckpt.load()
        chr_results.update(resumed)
        if resumed:
            print(f"checkpoint: resumed {len(resumed)} contig(s) from "
                  f"{cfg.checkpoint_dir}", file=sys.stderr)

    def record(chrom: str, result: dict):
        chr_results[chrom] = result
        if ckpt is not None:
            ckpt.save(chrom, result)
        print(f"({chrom})", end="", file=sys.stderr, flush=True)

    def process_chrom(chrom: str):
        if chrom in chr_results:  # checkpoint-resumed
            return
        last_snp = het.last_snp(chrom)
        if last_snp == -1:
            return
        # reference fetches [0, lastSNP+5] (ParsingBam.cpp:47)
        ref_string = fasta.fetch(chrom, 0, last_snp + 6) if chrom in fasta.index else ""
        variants = het.by_chrom[chrom]
        vcf_io.mark_danger_indels(variants, ref_string)
        positions = sorted(variants)
        infos = [variants[p] for p in positions]

        sv_entries = None
        if sv_set is not None:
            sv_entries = sorted(sv_set.by_chrom.get(chrom, {}).items())
        mod_entries = None
        if meth_set is not None:
            mod_entries = sorted(meth_set.by_chrom.get(chrom, {}).items())

        # flat fast path: native ingest arrays straight to the device tensors
        if cfg.engine == "device" and not cfg.dot:
            from .. import native

            if native.available():
                flats = []
                clip_count = {}
                ok = True
                for path in cfg.bam_files:
                    f = native.extract_phase(path, chrom, last_snp, positions,
                                             infos, ref_string,
                                             cfg.params.mapping_quality,
                                             fasta_path=cfg.fasta_file,
                                             sv_entries=sv_entries,
                                             mod_entries=mod_entries,
                                             sv_window=cfg.params.sv_window,
                                             sv_threshold=cfg.params.sv_threshold)
                    if f is None:
                        ok = False
                        break
                    flats.append(f)
                if ok:
                    import numpy as _np

                    flat = flats[0]
                    if len(flats) > 1:
                        offs = [flats[0]["aln_offsets"]]
                        noffs = [flats[0]["name_offsets"]]
                        for g in flats[1:]:
                            offs.append(g["aln_offsets"][1:] + offs[-1][-1])
                            noffs.append(g["name_offsets"][1:] + noffs[-1][-1])
                        flat = {
                            "obs_pos": _np.concatenate([g["obs_pos"] for g in flats]),
                            "obs_allele": _np.concatenate([g["obs_allele"] for g in flats]),
                            "obs_qual": _np.concatenate([g["obs_qual"] for g in flats]),
                            "aln_offsets": _np.concatenate(offs),
                            "aln_start": _np.concatenate([g["aln_start"] for g in flats]),
                            "name_offsets": _np.concatenate(noffs),
                            "names": "".join(g["names"] for g in flats),
                            "clip_pos": _np.concatenate([g["clip_pos"] for g in flats]),
                            "clip_side": _np.concatenate([g["clip_side"] for g in flats]),
                        }
                    for pos, side in zip(flat["clip_pos"].tolist(),
                                         flat["clip_side"].tolist()):
                        entry = clip_count.setdefault(pos, [0, 0])
                        entry[side] += 1
                    intervals = get_cnv_intervals(clip_count)
                    if len(flat["aln_start"]) == 0:
                        return
                    erased = None
                    if cfg.is_ont:
                        from ..core.snp_filter import compute_ont_erasures

                        erased = compute_ont_erasures(variants, ref_string)
                    from ..core.fastpath import phase_chromosome_flat

                    # duplicated interval list (Clip ctor + explicit call,
                    # PhasingProcess.cpp:147-148)
                    r = phase_chromosome_flat(flat, intervals + intervals,
                                              chrom, cfg.params, erased,
                                              defer_sink=multichip_sink)
                    if r == "deferred":
                        return
                    if r is not None:
                        record(chrom, r[0])
                        return

        alns, clip_count = extract_chromosome(
            cfg.bam_files, chrom, last_snp, positions, infos, ref_string,
            mapping_quality=cfg.params.mapping_quality,
            sv_entries=sv_entries, mod_entries=mod_entries,
            sv_window=cfg.params.sv_window, sv_threshold=cfg.params.sv_threshold,
            fasta=fasta)

        if cfg.is_ont:
            filter_ont_snps(variants, alns, ref_string)

        if not alns:
            return
        # Clip ctor + the explicit second call duplicate every interval
        # (PhasingProcess.cpp:147-148); downstream ratios are invariant but we
        # preserve the doubled list for walk parity.
        intervals = get_cnv_intervals(clip_count)
        cnv_vec = intervals + intervals

        if cfg.engine == "device" and not cfg.dot:
            from ..ops.engine import phase_chromosome_device
            result, _read_hp, _g = phase_chromosome_device(alns, cnv_vec,
                                                           chrom, cfg.params)
        else:
            result, _read_hp, _g = phase_chromosome(alns, cnv_vec, chrom,
                                                    cfg.params,
                                                    generate_dot=cfg.dot)
        record(chrom, result)

    with timer("phasing chromosomes"):
        chroms = [c for c in het.contigs]
        if dist.is_active():
            chroms = dist.shard_contigs(chroms)
        if cfg.num_threads > 1:
            with ThreadPoolExecutor(max_workers=cfg.num_threads) as pool:
                list(pool.map(process_chrom, chroms))
        else:
            for c in chroms:
                process_chrom(c)
        if multichip_sink:
            _drain_multichip(multichip_sink, cfg, record)
        print("", file=sys.stderr)

    if dist.is_active():
        with timer("allgather shard results"):
            chr_results = dist.merge_chr_results(chr_results)

    with timer("merge results"):
        merged: dict[str, tuple[str, int]] = {}
        for chrom in chr_results:
            merged.update(chr_results[chrom])

    if dist.is_writer():
        with timer("writeResult SNP"):
            vcf_io.rewrite_result_vcf(
                cfg.snp_file, cfg.result_prefix + ".vcf", merged, het,
                REFERENCE_VERSION, cfg.command,
                phase_indel=cfg.phase_indel, indel_quality=cfg.indel_quality)

        if sv_set is not None:
            with timer("write SV Result"):
                vcf_io.rewrite_sv_vcf(
                    cfg.sv_file, cfg.result_prefix + "_SV.vcf",
                    merged, sv_set, REFERENCE_VERSION, cfg.command)
        if meth_set is not None:
            with timer("write mod Result"):
                vcf_io.rewrite_meth_vcf(
                    cfg.mod_file, cfg.result_prefix + "_mod.vcf",
                    merged, meth_set, REFERENCE_VERSION, cfg.command)

    return merged
