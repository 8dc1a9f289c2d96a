"""Device phasing engine over the object pipeline: packed tensors -> phased
sites.

Pipeline body equivalent to VairiantGraph::phasingProcess + exportResult,
with host pre-filters shared with the oracle (they are cheap, stateful, and
I/O-adjacent; the banded counting, vote scan and read scoring are the compute
hot spots and run as kernels).
"""

from __future__ import annotations

import numpy as np

from ..core import phase_algo
from ..core.matrix import pack_chromosome
from ..core.phase_algo import PhaseParams
from .read_correction import read_correction_packed
from .vote_scan import run_vote_scan


def phase_chromosome_device(alns, cnv_vec, chrom: str, params: PhaseParams):
    alns = phase_algo.filter_overlap_alignments(alns, params.overlap_threshold)
    phase_algo.cnv_mismatch_filter(alns, cnv_vec)
    packed = pack_chromosome(alns, params)
    if packed is None:
        return {}, {}, None

    ps, ori = run_vote_scan(packed, params)
    ps, ori, read_hp = read_correction_packed(packed, ps, ori, params)

    result: dict[str, tuple[str, int]] = {}
    phased_idx = np.nonzero(ps)[0]
    for i in phased_idx:
        o = int(ori[i])
        result[f"{chrom}_{int(packed.positions[i])}"] = (f"{o}|{1 - o}", int(ps[i]))
    return result, read_hp, packed
