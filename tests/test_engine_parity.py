"""Device engine vs host oracle: identical phasing output on varied fixtures."""

import numpy as np
import pytest

from longphase_s_jax.core.alleles import extract_chromosome
from longphase_s_jax.core.clip import get_cnv_intervals
from longphase_s_jax.core.phase_algo import PhaseParams, phase_chromosome
from longphase_s_jax.ops.engine import phase_chromosome_device
from longphase_s_jax.testing.simulate import make_fixture


def _phase_both(fix, params):
    from longphase_s_jax.io import vcf as vcf_io

    het = vcf_io.read_het_variants(fix["vcf"])
    chrom = fix["chrom"]
    variants = het.by_chrom[chrom]
    positions = sorted(variants)
    infos = [variants[p] for p in positions]
    last = het.last_snp(chrom)
    alns, clip_count = extract_chromosome(
        [fix["bam"]], chrom, last, positions, infos, fix["ref_seq"][:last + 6])
    cnv = get_cnv_intervals(clip_count)
    cnv = cnv + cnv
    import copy

    r_oracle, hp_oracle, _ = phase_chromosome(copy.deepcopy(alns), list(cnv), chrom, params)
    r_dev, hp_dev, _ = phase_chromosome_device(copy.deepcopy(alns), list(cnv), chrom, params)
    return r_oracle, r_dev, hp_oracle, hp_dev


@pytest.mark.parametrize("seed,error,qual", [
    (1, 0.0, 40),
    (2, 0.05, 25),
    (3, 0.10, 15),
    (4, 0.08, 9),   # low qual -> 0.1-weight edges exercise decimal arithmetic
])
def test_engine_matches_oracle(tmp_path, seed, error, qual):
    fix = make_fixture(str(tmp_path / f"f{seed}"), seed=seed, length=100000,
                       coverage=25, read_len=8000, snp_rate=0.002,
                       error_rate=error, qual=qual)
    params = PhaseParams()
    r_oracle, r_dev, hp_o, hp_t = _phase_both(fix, params)
    assert r_oracle == r_dev
    assert hp_o == hp_t
