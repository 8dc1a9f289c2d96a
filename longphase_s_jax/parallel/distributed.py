"""Multi-host scaffold: ``jax.distributed`` contig sharding + collective merges.

SURVEY.md §2.6 "Communication backend": the reference scales only within one
host (OpenMP over contigs, PhasingProcess.cpp:113); WGS-scale runs want to
spread contigs across hosts. Design:

- every process ingests and phases only its contig shard (round-robin over
  the VCF contig order — contig sizes are long-tailed, round-robin balances
  the big ones across hosts),
- per-contig results are tiny (position -> (hap, PS)) next to the BAMs, so
  the merge is an all-gather of serialized result blobs over the
  collective fabric (merge semantics: plain union, the analog of
  /root/reference/src/shared/Util.cpp:7-12's map merge — contigs are disjoint),
- every process ends with the full merged result; file outputs are written
  by process 0 only.

Activation: ``LPS_DIST=coordinator:port,num_processes,process_id`` in the
environment, or the ``--dist`` CLI flag on the phase/somatic subcommands.
Tested with a 2-process CPU mesh (tests/test_distributed.py) which must
golden-match the single-process run byte-for-byte.
"""

from __future__ import annotations

import json
import os

import numpy as np

_initialized = False


def parse_spec(spec: str):
    """``"host:port,nprocs,pid"`` -> (coordinator, nprocs, pid)."""
    coord, nprocs, pid = spec.rsplit(",", 2)
    return coord, int(nprocs), int(pid)


def init_from_spec(spec: str) -> None:
    """Initialize jax.distributed once from an LPS_DIST-style spec."""
    global _initialized
    if _initialized or not spec:
        return
    import jax

    coord, nprocs, pid = parse_spec(spec)
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nprocs, process_id=pid,
                               local_device_ids=_local_card(pid))
    _initialized = True


def _local_card(pid: int):
    """One NVIDIA card per process: process ``pid`` of a one-host run takes
    card pid mod the host's card count, so processes do not each reserve
    most of every card's memory. None (no restriction) where nvidia-smi
    finds no card."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    n = len(out.split())
    return [pid % n] if n else None


def maybe_init_from_env() -> None:
    init_from_spec(os.environ.get("LPS_DIST", ""))


def _dist_state():
    """jax.distributed's global state WITHOUT initializing an XLA backend:
    every pipeline asks is_active(), even plain single-process CPU-only
    runs, and the distributed service state answers without starting one."""
    from jax._src import distributed

    return distributed.global_state


def is_active() -> bool:
    state = _dist_state()
    if state.client is None:
        return False
    return (state.num_processes or 1) > 1


def process_id() -> int:
    state = _dist_state()
    return state.process_id or 0


def is_writer() -> bool:
    """Only one process writes output files (they land on a shared FS)."""
    return not is_active() or process_id() == 0


def shard_contigs(contigs):
    """Round-robin contig shard for this process (stable across processes:
    everyone shards the same VCF-ordered contig list)."""
    state = _dist_state()
    n, p = (state.num_processes or 1), (state.process_id or 0)
    return [c for i, c in enumerate(contigs) if i % n == p]


def allgather_bytes(blob: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process (two rounds:
    lengths, then right-padded payloads)."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    lens = np.asarray(multihost_utils.process_allgather(
        jnp.asarray([len(blob)], jnp.int32))).reshape(-1)
    width = max(int(lens.max()), 1)
    arr = np.zeros(width, np.uint8)
    arr[:len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(jnp.asarray(arr)))
    return [gathered[i, :int(lens[i])].tobytes() for i in range(len(lens))]


def allgather_f64(values) -> np.ndarray:
    """All-gather variable-length float64 vectors (purity VAF pools: the
    global median/IQR/histogram of TumorPurityEstimator.cpp:31-84 need the
    full cross-host value set, not a summary)."""
    blobs = allgather_bytes(np.asarray(values, np.float64).tobytes())
    return np.concatenate([np.frombuffer(b, np.float64) for b in blobs]) \
        if blobs else np.asarray([], np.float64)


def psum_counters(counters: dict) -> dict:
    """Sum integer counter dicts (benchmark tallies) across processes."""
    merged: dict = {}
    for blob in allgather_bytes(json.dumps(
            {k: int(v) for k, v in counters.items()}).encode()):
        for k, v in json.loads(blob).items():
            merged[k] = merged.get(k, 0) + v
    return merged


def merge_chr_results(chr_results: dict) -> dict:
    """Union per-contig phase results across processes. Contig shards are
    disjoint so the union is exact; ties cannot occur."""
    blob = json.dumps({
        chrom: {k: [v[0], v[1]] for k, v in result.items()}
        for chrom, result in chr_results.items()}).encode()
    merged: dict = {}
    for b in allgather_bytes(blob):
        for chrom, result in json.loads(b).items():
            merged[chrom] = {k: (v[0], int(v[1])) for k, v in result.items()}
    return merged
