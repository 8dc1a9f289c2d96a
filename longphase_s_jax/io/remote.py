"""Remote input support: http(s) URLs accepted for every input-file CLI
argument, like the reference binary's htslib hfile stack
(/root/reference/htslib/hfile_libcurl.c, hfile_s3.c).

Design divergence (documented in PARITY.md): htslib streams remote files
with ranged reads; here remote inputs are fetched once into a local cache
(streamed to disk in bounded chunks, atomic rename) and the local copy is
opened by the ordinary readers. The flat-array runtimes want whole files
anyway (ARCHITECTURE.md memory model), and the fetch-once cache makes the
multi-pass pipelines (normal+tumor extract, tag) pay the network exactly
once. Companion indexes (.bai/.crai/.fai/.tbi/.gzi) are fetched
best-effort next to the data file under the derived names readers expect.

S3: public/presigned URLs expressed as https work through the same path;
AWS signature generation (hfile_s3.c) is out of scope in this zero-egress
build environment.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import urllib.request

CACHE_ENV = "LPS_REMOTE_CACHE"
_COMPANIONS = (".bai", ".crai", ".fai", ".tbi", ".gzi")


def is_remote(path) -> bool:
    return isinstance(path, str) and path.startswith(("http://", "https://"))


def _cache_dir() -> str:
    d = os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "longphase_s_jax", "remote")
    os.makedirs(d, exist_ok=True)
    return d


def _download(url: str, dst: str) -> None:
    """Stream ``url`` to ``dst`` in bounded chunks, atomically."""
    tmp = f"{dst}.part.{os.getpid()}"
    req = urllib.request.Request(
        url, headers={"User-Agent": "longphase-s-jax"})
    with urllib.request.urlopen(req) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f, length=4 << 20)
    os.replace(tmp, dst)


def fetch(url: str) -> str:
    """Local path for ``url``: downloaded once, cached by URL hash."""
    h = hashlib.sha256(url.encode()).hexdigest()[:24]
    base = os.path.basename(url.split("?", 1)[0]) or "remote"
    local = os.path.join(_cache_dir(), f"{h}_{base}")
    if not os.path.exists(local):
        print(f"fetching {url} ...", file=sys.stderr)
        _download(url, local)
    return local


def localize(path):
    """fetch() for remote paths plus best-effort companion indexes;
    identity for local paths (and None/empty)."""
    if not is_remote(path):
        return path
    local = fetch(path)
    for sfx in _COMPANIONS:
        dst = local + sfx
        if os.path.exists(dst):
            continue
        try:
            _download(path + sfx, dst)
        except Exception:  # noqa: BLE001 — no index remotely: fine
            continue
    return local
