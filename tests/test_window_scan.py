"""Equivalence of the vectorized +-window mismatch scan against the scalar
reference-semantics oracle (getOrderWindowsDiffRef), over randomized CIGARs."""

import numpy as np

from longphase_s_jax.core.somatic_caller import (
    _SEQ_NT16_ASCII, _get_order_windows_diff_ref, _order_windows_diff_fast,
    get_windows_diff_ref)
from longphase_s_jax.io.bam import SEQ_NT16


def _ascii_to_nibbles(seq_ascii):
    lut = {c: i for i, c in enumerate(SEQ_NT16)}
    return np.array([lut[chr(b)] for b in seq_ascii], dtype=np.uint8)


def test_window_scan_equivalence():
    rng = np.random.default_rng(123)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for trial in range(300):
        read_len = int(rng.integers(50, 600))
        seq_ascii = bases[rng.integers(0, 4, read_len)]
        ref_len = int(rng.integers(read_len, read_len + 400))
        ref_arr = bases[rng.integers(0, 4, ref_len)]
        # random cigar covering the read
        cigars = []
        q = 0
        while q < read_len:
            op = int(rng.choice([0, 0, 0, 1, 2, 3, 4, 7, 8],
                                p=[.5, .1, .1, .05, .05, .05, .05, .05, .05]))
            ln = int(rng.integers(1, 80))
            if op in (0, 1, 4, 7, 8):
                ln = min(ln, read_len - q)
                q += ln
            cigars.append((op, ln))
        m_ops = [i for i, (op, _l) in enumerate(cigars)
                 if op in (0, 7, 8)]
        if not m_ops:
            continue
        ci = int(rng.choice(m_ops))
        oplen = cigars[ci][1]
        read_offset = int(rng.integers(0, oplen))
        # query_pos = read position at start of op ci
        query_pos = sum(ln for op, ln in cigars[:ci] if op in (0, 1, 4, 7, 8))
        ref_pos = int(rng.integers(0, ref_len))
        seq_nib = _ascii_to_nibbles(seq_ascii)
        ref_str = ref_arr.tobytes().decode("ascii")

        for direction in (-1, 1):
            if direction == 1:
                remaining = max(oplen - read_offset, 0)
            else:
                remaining = max(read_offset, 0)
            slow = _get_order_windows_diff_ref(
                cigars, ci, seq_nib, read_len, ref_str,
                query_pos + read_offset, remaining, ref_pos, direction)
            fast = _order_windows_diff_fast(
                cigars, ci, seq_ascii, read_len, ref_arr,
                query_pos + read_offset, remaining, ref_pos, direction)
            assert slow == fast, (trial, direction, cigars, ci, read_offset,
                                  ref_pos, slow[:5], fast[:5])

        # combined entry point (may take the single-M fast path)
        combined = get_windows_diff_ref(cigars, ci, seq_ascii, read_len,
                                        ref_arr, query_pos, read_offset,
                                        ref_pos)
        slow_both = _get_order_windows_diff_ref(
            cigars, ci, seq_nib, read_len, ref_str, query_pos + read_offset,
            max(read_offset, 0) if cigars[ci][0] != 1 else 0, ref_pos, -1)
        slow_both += _get_order_windows_diff_ref(
            cigars, ci, seq_nib, read_len, ref_str, query_pos + read_offset,
            max(oplen - read_offset, 0) if cigars[ci][0] != 1 else 0,
            ref_pos, 1)
        assert combined == slow_both
