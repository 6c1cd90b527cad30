"""CPU tests of the benchmark's pieces: the generator, the feeder and
digester over real pipes, the trace arithmetic, the metric readers, the
cell lookup and what the harness and the reference import."""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest

from benchmark import devtrace, traffic
from benchmark.cells import ROOT, load_cell


def _pool(cell="rbk114_96.ends", seed=7, n=512):
    c = load_cell(cell)
    c.traffic["pool_reads"] = n
    return c, traffic.make_pool(c.config, c.traffic, seed)


@pytest.mark.parametrize("cell", ["rbk114_96.ends", "nbd114_96.ends", "rbk114_96.full_scan"])
def test_generator_is_the_traffic_file(cell):
    c, p = _pool(cell)
    _c, q = _pool(cell)
    assert p.records == q.records and (p.sample == q.sample).all()
    _c, r = _pool(cell, seed=8)
    assert p.records != r.records
    n = len(p)
    body = c.traffic["body"]
    none = sum(lab is None for lab in p.labels)
    assert none == int(n * c.traffic["no_construct_share"])
    labels = [lab for t in c.config["templates"] for lab in t["constructs"]]
    assert {lab for lab in p.labels if lab is not None} <= set(labels)
    lens = np.array([len(s) for s in p.seqs])
    edits = c.traffic["edits"]["max"]
    constructs = {lab: len(t["constructs"][lab]) for t in c.config["templates"]
                  for lab in t["constructs"]}
    extra = max(constructs.values()) * (2 if c.config["pattern_class"] == "double" else 1)
    trim = c.traffic["front_trim"]["max"]
    assert lens.min() >= body["min"] - edits and lens.max() <= body["max"] + extra + edits
    # the same multiset of lengths for every seed, within the edits and front cuts
    assert abs(np.sort(lens) - np.sort([len(s) for s in r.seqs])).max() <= 2 * edits + 1 + trim
    # half of the construct reads are reverse complemented: their
    # construct's reverse complement ends... their read
    fwd = rc = cut = 0
    for s, lab in zip(p.seqs, p.labels):
        if lab is None:
            continue
        con = next(t["constructs"][lab] for t in c.config["templates"]).encode()
        fwd += s[:20] == con[:20]
        cut += any(s[:20] == con[k:k + 20] for k in range(1, trim + 1))
        rc += s[-20:] == traffic.revcomp(con)[-20:]
    total = n - none
    assert abs(fwd + cut - rc) < 0.2 * total  # edits blur a few ends
    # GroupIII: the traffic file's share of the construct reads has its front cut
    share = c.traffic["front_trim"]["share"]
    assert 0.5 * share < cut / (fwd + cut) < 1.5 * share
    assert len(p.sample) == min(n, c.traffic["reference_sample"])
    assert all(q[1:].startswith(b"%08x" % 3) for q in [traffic.record(p, 3, 0)])


def test_read_ids_round_trip():
    for pass_no, idx in [(0, 0), (5, 32767), (0x7FFFFFFF, 70000)]:
        assert traffic.parse_id(traffic.read_id(pass_no, idx, "abcd-0123456789ab")) == (pass_no, idx)


def _tiny_cell_root(tmp_path, pool=64):
    import shutil

    root = tmp_path / "co"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    tr = json.loads((root / "benchmark/traffic/ends_ref_sim.json").read_text())
    tr["pool_reads"] = pool
    (root / "benchmark/traffic/ends_ref_sim.json").write_text(json.dumps(tr))
    return root


def test_feeder_pipe_keeps_every_byte(tmp_path):
    root = _tiny_cell_root(tmp_path)
    fifo = str(tmp_path / "in.fastq")
    os.mkfifo(fifo)
    p = subprocess.Popen([sys.executable, "-m", "benchmark.feeder", "rbk114_96.ends", "99", fifo],
                         cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    assert p.stdout.readline().strip() == b"ready"
    import time

    p.stdin.write(f"{time.monotonic() + 1.0!r}\n".encode())
    p.stdin.flush()
    got = bytearray()
    with open(fifo, "rb") as fh:
        while True:
            b = fh.read(1 << 16)
            if not b:
                break
            got += b
            time.sleep(0.001)  # a slow reader: back-pressure
    stats = json.loads(p.stdout.readline())
    p.wait(timeout=30)
    cell = load_cell("rbk114_96.ends", root)
    pool = traffic.make_pool(cell.config, cell.traffic, 99)
    want = b"".join(traffic.record(pool, k // len(pool), k % len(pool)) for k in range(stats["reads"]))
    assert stats["reads"] > len(pool) and bytes(got) == want and stats["bytes"] == len(want)
    assert 0 <= stats["waited_s"] <= stats["ran_s"]


def test_digester_keeps_sampled_records(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    names = ["annotation.tsv", "A.trimmed.fastq", "B.trimmed.fastq"]
    for n in names:
        os.mkfifo(out / n)
    p = subprocess.Popen([sys.executable, "-m", "benchmark.digester"], cwd=ROOT,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    p.stdin.write((json.dumps({"dir": str(out), "fifos": names, "sample": [1, 3]}) + "\n").encode())
    p.stdin.flush()
    assert p.stdout.readline().strip() == b"ready"
    from benchmark.reference.records import TSV_HEADER

    rid = [traffic.read_id(0, i, "abcd-0123456789ab") for i in range(5)]
    tsv = TSV_HEADER + "\n" + "".join(f"{r}\t1\tx\n{r}\t2\ty\n" for r in rid)
    fq = "".join(f"@{r} d=1\nACGT\n+\nIIII\n@{r}_1 d=1\nAC\n+\nII\n" for r in rid)

    def write(name, text):
        with open(out / name, "w") as fh:
            for k in range(0, len(text), 7):  # records split across writes
                fh.write(text[k:k + 7])
                fh.flush()

    threads = [threading.Thread(target=write, args=a) for a in
               [("annotation.tsv", tsv), ("A.trimmed.fastq", fq)]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (out / "extra.tsv").write_text(f"{rid[3]}\tz\n")  # an output nobody foresaw
    p.stdin.write(b"done\n")
    p.stdin.flush()
    res = pickle.loads(p.stdout.read())
    p.wait(timeout=30)
    f = res["files"]
    assert f["annotation.tsv"]["records"] == 10 and f["A.trimmed.fastq"]["records"] == 10
    assert f["B.trimmed.fastq"]["records"] == 0 and res["unforeseen"] == ["extra.tsv"]
    assert all(v["bad_header"] == v["unparsed"] == v["out_of_order"] == 0 for v in f.values())
    assert res["kept"][("annotation.tsv", 0, 3)] == [f"{rid[3]}\t1\tx", f"{rid[3]}\t2\ty"]
    assert res["kept"][("A.trimmed.fastq", 0, 1)] == [f"@{rid[1]} d=1\nACGT\n+\nIIII",
                                                    f"@{rid[1]}_1 d=1\nAC\n+\nII"]
    assert res["kept"][("extra.tsv", 0, 3)] == [f"{rid[3]}\tz"]
    assert not (out / "extra.tsv").exists()
    assert ("annotation.tsv", 0, 2) not in res["kept"]


def test_trace_arithmetic():
    assert devtrace.union_seconds([(0, 1), (0.5, 2), (3, 4)]) == 3
    assert devtrace.gaps_between([(0, 1), (0.5, 2), (3, 4)]) == [(2, 3)]
    tr = devtrace.reduce_events(
        [("void (anonymous namespace)::rank_kernel<4>(unsigned char const*)", 0.0, 0.5),
         ("window_kernel(int)", 0.25, 1.0), ("Memcpy HtoD (Pageable -> Device)", 3.0, 3.5)],
        [("aten::copy_", 0.9, 2.5), ("cudaGraphLaunch", 2.6, 2.7)])
    assert tr.busy_s == 1.5
    assert tr.device_s["rank_kernel"] == 0.5 and tr.device_s["window_kernel"] == 0.75
    assert tr.gaps == [("aten::copy_", 2.0)]
    assert tr.runtime == {"cudaGraphLaunch": [1, pytest.approx(0.1)]}


def test_metric_readers():
    from benchmark.cells import load_reader

    tr = devtrace.Trace(busy_s=0.5, device_s={"rank_kernel": 0.2, "window_kernel": 0.1,
                                              "myers_kernel": 0.05, "Memcpy HtoD": 1.0})
    ctx = {"reads": 2000, "window_s": 10.0, "cpu_s": 30.0, "trace": tr, "first_output_s": 1.5,
           "timings": {"encode": [1.0, 5], "pack_upload": [0.5, 5], "assemble.host": [0.5, 5],
                       "demux_call.dispatch": [0.02, 4]}}
    got = {n: load_reader(n)(ctx) for n in (
        "host.cpu_s_per_kread", "engine.host_s_per_kread", "engine.dispatch_ms_per_call",
        "engine.first_output_s", "device.idle_share", "kernels.ms_per_kread",
        "kernel.rank.ms_per_kread")}
    assert got == pytest.approx({"host.cpu_s_per_kread": 15.0, "engine.host_s_per_kread": 1.0,
                                 "engine.dispatch_ms_per_call": 5.0, "engine.first_output_s": 1.5,
                                 "device.idle_share": 95.0, "kernels.ms_per_kread": 175.0,
                                 "kernel.rank.ms_per_kread": 100.0})
    empty = dict(ctx, trace=None, timings={}, first_output_s=None)
    assert all(load_reader(n)(empty) is None for n in got if n != "host.cpu_s_per_kread")


def test_a_cell_added_as_files_is_found(tiny_root):
    cell = load_cell("dummy.tiny", tiny_root)
    assert cell.config["name"] == "dummy" and cell.traffic["pool_reads"] == 24
    assert [m.name for m in cell.end_to_end] == ["reads_per_s", "setup_s"]
    assert cell.per_layer[-1].name == "dummy.reads" and cell.per_layer[-1].read({"reads": 3}) == 3.0
    assert "dummy.reads" not in [m.name for m in load_cell("rbk114_96.ends", tiny_root).per_layer]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_imports():
    forbidden = {"jax", "jaxlib", "flax", "barbell_tpu"}
    ref = _loaded("import benchmark.reference.kit, benchmark.compare, benchmark.traffic")
    assert not ref & (forbidden | {"barbell_tpu_torch", "torch"})
    harness = _loaded("import benchmark.run, benchmark.feeder, benchmark.digester, "
                      "benchmark.devtrace, benchmark.control")
    assert not harness & forbidden
    from benchmark.run import FORBIDDEN

    assert "barbell_tpu" in FORBIDDEN  # compared whole: barbell_tpu_torch is allowed


def test_compare_counts_each_fault_once():
    from benchmark import compare as cmp
    from benchmark.reference.kit import ID

    c, pool = _pool(n=64)
    pool.sample = pool.sample[:3]
    a, b, d = (int(i) for i in pool.sample)
    expected = {a: {"annotation.tsv": [ID + "\tx"]}, b: {}, d: {"annotation.tsv": [ID + "\ty"]}}

    def rid(p, i):
        return traffic.read_id(p, i, "abcd-0123456789ab")

    kept = {("annotation.tsv", p, i): [rid(p, i) + t] for p in (0, 1)
            for i, t in ((a, "\tx"), (d, "\ty"))}
    fed = 2 * 64
    order = [(0, a), (0, d), (1, a), (1, d)]
    assert cmp.compare(pool, expected, kept, fed, rid, [order])["mismatched"] == 0
    assert cmp.compare(pool, expected, kept, fed, rid, [[(0, d), (0, a), (1, a), (1, d)]])["mismatched"] == 1
    wrong = dict(kept)
    wrong[("annotation.tsv", 1, d)] = [rid(1, d) + "\tz"]
    assert cmp.compare(pool, expected, wrong, fed, rid, [order])["mismatched"] == 1
    missing = {k: v for k, v in kept.items() if k[1] == 0}
    assert cmp.compare(pool, expected, missing, fed, rid, [order[:2]])["mismatched"] == 2
    extra = dict(kept)
    extra[("annotation.tsv", 2, a)] = [rid(2, a) + "\tx"]  # never fed
    assert cmp.compare(pool, expected, extra, fed, rid, [order])["mismatched"] == 1
