"""Resident-genome serving: tables identical to fresh CLI runs, JSON
protocol, degradation."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.serve import ResidentSearcher, serve_stdio

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
GUIDE2 = "ACGGATCGATTGCATGAAGGtgg"


def _strip_ts(text: str) -> list[str]:
    rows = text.splitlines()
    if not rows:
        return rows
    header = rows[0].split("\t")
    ts = header.index("time_stamp")
    return [
        "\t".join(c for i, c in enumerate(r.split("\t")) if i != ts)
        for r in rows
    ]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(29)
    b = ReferenceSetBuilder(assembly="serve")
    planted = ("TTTT" + GUIDE[:20] + "TGG" + "CC"
               + GUIDE2[:20].lower())  # one hit for each guide region
    for name, n in (("chr1", 60000), ("chr2", 40000)):
        seq = "".join(rng.choice(list("ACGT"), n))
        seq = seq[:5000] + planted.upper() + seq[5000 + len(planted):]
        b.add(name).add(seq)
    ref = b.to_file(tmp / "ref.fa")
    vcf = tmp / "v.vcf"
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("chr1\t5007\trs1\tT\tG\t.\tPASS\tAF=0.3\n")
        fh.write("chr2\t9000\trs2\tA\tC\t.\tPASS\tAF=0.1\n")
    return ref, vcf


def test_resident_searches_match_fresh_runs(genome, tmp_path):
    from calitas_tpu.tools import search_reference

    ref, vcf = genome
    server = ResidentSearcher(ref, vcf, threads=1, engine="device")
    # two sequential searches on the same resident genome
    t1 = server.search(GUIDE, "g1")
    t2 = server.search(GUIDE2, "g2", max_guide_diffs=4)

    f1 = tmp_path / "f1.tsv"
    search_reference.run(guide=GUIDE, guide_id="g1", ref=ref, variants=vcf,
                         output=f1, threads=1, engine="device")
    f2 = tmp_path / "f2.tsv"
    search_reference.run(guide=GUIDE2, guide_id="g2", ref=ref, variants=vcf,
                         output=f2, threads=1, engine="device",
                         max_guide_diffs=4)
    assert _strip_ts(t1) == _strip_ts(f1.read_text())
    assert _strip_ts(t2) == _strip_ts(f2.read_text())
    assert len(t1.splitlines()) > 1


def test_resident_host_engine_identical(genome):
    ref, vcf = genome
    dev = ResidentSearcher(ref, vcf, threads=1, engine="device")
    host = ResidentSearcher(ref, vcf, threads=1, engine="host")
    a = dev.search(GUIDE, "g1")
    b = host.search(GUIDE, "g1")
    assert _strip_ts(a) == _strip_ts(b)


@pytest.mark.parametrize(
    "error, degrades", [(RuntimeError, True), (TypeError, False)]
)
def test_staging_failure_policy(genome, monkeypatch, error, degrades):
    """A device failure while staging degrades that contig to the host
    (counted); a programming error propagates instead of hiding."""
    from calitas_tpu.ops.genome_screen import GenomeScreen
    from calitas_tpu.utils import degradations, reset_degradations

    def stage(self, bases):
        raise error("injected")

    monkeypatch.setattr(GenomeScreen, "stage", stage)
    ref, vcf = genome
    reset_degradations()
    if not degrades:
        with pytest.raises(error):
            ResidentSearcher(ref, vcf, threads=1, engine="device")
        return
    server = ResidentSearcher(ref, vcf, threads=1, engine="device")
    assert degradations() == {"staging": 2}
    host = ResidentSearcher(ref, vcf, threads=1, engine="host")
    assert _strip_ts(server.search(GUIDE, "g1")) == _strip_ts(
        host.search(GUIDE, "g1"))


def test_serve_stdio_protocol(genome, tmp_path):
    import io

    ref, vcf = genome
    server = ResidentSearcher(ref, vcf, threads=1, engine="host")
    out_path = tmp_path / "req.tsv"
    requests = "\n".join([
        json.dumps({"cmd": "ping"}),
        json.dumps({"guide": GUIDE, "guide_id": "g1",
                    "output": str(out_path)}),
        json.dumps({"guide": "acgtacgt", "guide_id": "bad"}),  # all-lowercase: parse error
        json.dumps({"guide": GUIDE, "guide_id": "g1", "bogus_kw": 1}),
        # '-' would dump the TSV into this JSON protocol stream; the
        # server must reject it as a bad request, not die on open('-')
        json.dumps({"guide": GUIDE, "guide_id": "g1", "output": "-"}),
        json.dumps({"cmd": "shutdown"}),
    ]) + "\n"
    out = io.StringIO()
    serve_stdio(server, stdin=io.StringIO(requests), stdout=out)
    replies = [json.loads(l) for l in out.getvalue().splitlines()]
    assert replies[0]["ready"] and replies[0]["ok"]
    assert replies[1]["ok"]  # ping
    assert replies[2]["ok"] and replies[2]["rows"] >= 1
    assert out_path.exists()
    assert not replies[3]["ok"]  # bad guide reported, server kept running
    assert not replies[4]["ok"] and "bad request" in replies[4]["error"]
    assert not replies[5]["ok"] and "bad request" in replies[5]["error"]
    assert replies[6]["ok"] and replies[6].get("bye")


def test_serve_cli_subprocess(genome, tmp_path):
    """The Serve sub-command end-to-end over pipes."""
    ref, vcf = genome
    proc = subprocess.Popen(
        [sys.executable, "-m", "calitas_tpu", "Serve", "-r", str(ref),
         "-v", str(vcf), "-t", "1", "--engine", "host"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ok"] and ready["ready"]
        proc.stdin.write(json.dumps({"guide": GUIDE, "guide_id": "g1"}) + "\n")
        proc.stdin.flush()
        resp = json.loads(proc.stdout.readline())
        assert resp["ok"] and resp["rows"] >= 1
        assert resp["table"].startswith("guide_id\t")
        proc.stdin.write(json.dumps({"cmd": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline()).get("bye")
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_warmup_runs_and_requests_stay_identical(genome, tmp_path):
    """warmup() must leave the searcher fully functional with identical
    output to a fresh CLI run."""
    fa, _vcf = genome
    guide = GUIDE
    from calitas_tpu.serve import ResidentSearcher
    from calitas_tpu.tools import search_reference

    s = ResidentSearcher(fa, threads=1, engine="host")
    s.warmup()
    table = s.search(guide=guide, guide_id="g")
    out = tmp_path / "cli.tsv"
    search_reference.run(guide=guide, guide_id="g", ref=fa, output=out,
                         engine="host", threads=1)
    def strip(text):
        lines = text.splitlines()
        ts = lines[0].split("\t").index("time_stamp")
        return [
            tuple(c for j, c in enumerate(l.split("\t")) if j != ts)
            for l in lines[1:]
        ]
    assert strip(table) == strip(out.read_text())
