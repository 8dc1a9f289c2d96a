"""Remote-input CLI parity: http(s) URLs must be
accepted for input files like the reference's htslib hfile stack accepts
them. Hermetic — a localhost http.server plays the remote side (zero
egress), and the URL-driven run must produce output identical to the
plain local-path run."""

import http.server
import os
import socketserver
import threading

import pytest


@pytest.fixture()
def http_root(small_fixture, tmp_path, monkeypatch):
    fixdir = os.path.dirname(small_fixture["bam"])

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=fixdir, **kw)

        def log_message(self, *a):
            pass

    httpd = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    monkeypatch.setenv("LPS_REMOTE_CACHE", str(tmp_path / "cache"))
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def test_remote_bam_input_cli(reference_binary, small_fixture, http_root,
                              tmp_path):
    import subprocess
    import sys

    from longphase_s_jax.io.bam import BamReader

    fix = small_fixture
    phased = str(tmp_path / "phased")
    subprocess.run([reference_binary, "phase", "--pb", "-s", fix["vcf"],
                    "-b", fix["bam"], "-r", fix["fasta"], "-o", phased],
                   check=True, capture_output=True)
    env = dict(os.environ, LPS_REMOTE_CACHE=str(tmp_path / "cache"),
               JAX_PLATFORMS="cpu")

    def tags(p):
        return [(r.qname, r.flag, r.pos, r.get_tag("HP"), r.get_tag("PS"),
                 r.get_tag("PQ")) for r in BamReader(p)]

    # local run
    local = str(tmp_path / "local")
    subprocess.run([sys.executable, "-m", "longphase_s_jax.cli", "haplotag",
                    "-s", phased + ".vcf", "-b", fix["bam"],
                    "-r", fix["fasta"], "-o", local],
                   check=True, capture_output=True, env=env, timeout=600)
    # URL run: BAM, VCF and fasta all served over http (the phased VCF
    # lives outside the served dir — copy it in first)
    import shutil

    url = str(tmp_path / "url")
    fixdir = os.path.dirname(fix["bam"])
    shutil.copy(phased + ".vcf", os.path.join(fixdir, "phased.vcf"))
    r = subprocess.run(
        [sys.executable, "-m", "longphase_s_jax.cli", "haplotag",
         "-s", f"{http_root}/phased.vcf", "-b", f"{http_root}/reads.bam",
         "-r", f"{http_root}/ref.fa", "-o", url],
        capture_output=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    assert tags(url + ".bam") == tags(local + ".bam")
    assert len(tags(url + ".bam")) > 0
    # second run hits the cache (no re-fetch): still succeeds
    url2 = str(tmp_path / "url2")
    r = subprocess.run(
        [sys.executable, "-m", "longphase_s_jax.cli", "haplotag",
         "-s", f"{http_root}/phased.vcf", "-b", f"{http_root}/reads.bam",
         "-r", f"{http_root}/ref.fa", "-o", url2],
        capture_output=True, env=env, timeout=600)
    assert r.returncode == 0
    assert tags(url2 + ".bam") == tags(local + ".bam")
