"""The read generator: one traffic file and one configuration file make a
pool of FASTQ records from a seed.

The read model is barbell's own simulation (`benchmarks/src/simulations/
sim_data.rs:403-447`, its classes GroupI, GroupII and GroupIII): a
random body, one random kit barcode's construct at every end the kit's
templates put one, half of the reads reverse complemented, a few random
edits, a share of reads with no construct at all (GroupI), and a share
of the construct reads whose front construct lost its first bases
(GroupIII, `mutate.rs:33-54`).  Every seed gets the same multiset of
body lengths, edit counts, strands, front cuts and construct-free reads
(stratified quantiles of the traffic file's distributions, in a seeded
order), so seeds change the bases and the barcodes but not the amount of
work.

Vectorised NumPy except the few edits a read takes; a pool of 32768
reads takes about a second.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import List

import numpy as np

_BASE_OF_BYTE = bytes(b"ACGT"[b & 3] for b in range(256))
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMPLEMENT)[::-1]


@dataclass
class Pool:
    """``records[i]`` is read i's FASTQ record without its leading ``@``
    and the first id field, which carries the pass: ``b"-<idx>-<tail>
    <desc>\\n<seq>\\n+\\n<qual>\\n"``.  ``seqs``, ``quals``, ``descs`` and
    ``labels`` (the true barcode, or ``None``) are read i's parts."""

    records: List[bytes]
    seqs: List[bytes]
    quals: List[bytes]
    descs: List[str]
    labels: list
    sample: np.ndarray  # pool indices the comparison checks

    def __len__(self) -> int:
        return len(self.records)


def read_id(pass_no: int, idx: int, tail: str) -> str:
    """A UUID-shaped read id: pass in the first field, pool index in the
    next two, a per-read tail."""
    return f"{pass_no:08x}-{idx >> 16:04x}-{idx & 0xFFFF:04x}-{tail}"


def parse_id(rid) -> tuple:
    """(pass, pool index) of a :func:`read_id` (str or bytes)."""
    if isinstance(rid, bytes):
        rid = rid.decode("ascii")
    return int(rid[:8], 16), int(rid[9:13] + rid[14:18], 16)


def _lengths(body: dict, q: np.ndarray) -> np.ndarray:
    if body["dist"] == "uniform":
        return (body["min"] + np.floor(q * (body["max"] - body["min"]))).astype(np.int64)
    if body["dist"] == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(float(x)) for x in q])
        x = np.exp(np.log(body["median"]) + body["sigma"] * z)
        return np.clip(np.rint(x), body["min"], body["max"]).astype(np.int64)
    raise ValueError(f"unknown body length distribution {body['dist']!r}")


def _constructs(config: dict):
    """(labels, {label: front bytes}, {label: rear bytes}): the left
    templates' constructs at the read's start, the right templates'
    reverse complemented at its end; a double kit with left templates
    only carries its construct at both ends."""
    left = [t["constructs"] for t in config["templates"] if t["side"] == "left"]
    right = [t["constructs"] for t in config["templates"] if t["side"] == "right"]
    labels = list((left or right)[0])
    front = {lab: b"".join(c[lab].encode() for c in left) for lab in labels}
    rear = {lab: b"".join(revcomp(c[lab].encode()) for c in right) for lab in labels}
    if config["pattern_class"] == "double" and not right:
        rear = {lab: revcomp(front[lab]) for lab in labels}
    return labels, front, rear


def make_pool(config: dict, traffic: dict, seed: int) -> Pool:
    rng = np.random.default_rng(int(seed) % 2**64)
    n = int(traffic["pool_reads"])
    q = (np.arange(n) + 0.5) / n

    def shuffled(x):
        return x[rng.permutation(n)]

    # construct-free reads spread evenly over the length quantiles, so
    # every seed has the same (length, construct) pairs in another order
    share = traffic["no_construct_share"]
    order = rng.permutation(n)
    body_len = _lengths(traffic["body"], q)[order]
    no_construct = (np.floor((np.arange(n) + 1) * share) > np.floor(np.arange(n) * share))[order]
    is_rc = shuffled(np.arange(n) < round(n * traffic["rc_share"]))
    e = traffic["edits"]
    n_edits = shuffled((e["min"] + np.floor(q * (e["max"] - e["min"] + 1))).astype(np.int64))
    labels, front, rear = _constructs(config)
    label_idx = rng.integers(0, len(labels), n)
    bodies = rng.bytes(int(body_len.sum())).translate(_BASE_OF_BYTE)
    offs = np.concatenate([[0], np.cumsum(body_len)])
    # every edit's position (as a fraction of the current length), kind
    # (substitution, deletion, insertion) and base offset
    total_edits = int(n_edits.sum())
    e_pos = rng.random(total_edits)
    e_kind = rng.integers(0, 3, total_edits)
    e_base = rng.integers(0, 4, total_edits)
    tails = rng.integers(0, 16, (n, 16), dtype=np.uint8)
    hexd = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    runid = hexd[rng.integers(0, 16, 40)].tobytes().decode()
    q_lo, q_hi = traffic["quality"]["min"], traffic["quality"]["max"]

    # the reference's GroupIII: the front construct's start trimmed by
    # 1..max bases, in a share of the construct reads
    trim = np.zeros(n, dtype=np.int64)
    tr = traffic.get("front_trim")
    if tr:
        has = np.flatnonzero(~no_construct)
        h = int(len(has) * tr["share"])
        cut = 1 + np.floor((np.arange(h) + 0.5) / h * tr["max"]).astype(np.int64)
        trim[has[rng.permutation(len(has))[:h]]] = cut
    trim_l = trim.tolist()

    seqs, labs = [], []
    k = 0
    offs_l, nc_l, rc_l = offs.tolist(), no_construct.tolist(), is_rc.tolist()
    ne_l, li_l = n_edits.tolist(), label_idx.tolist()
    pos_l, kind_l, base_l = e_pos.tolist(), e_kind.tolist(), e_base.tolist()
    code = {b: c for c, b in enumerate(b"ACGT")}
    for i in range(n):
        body = bodies[offs_l[i]:offs_l[i + 1]]
        if nc_l[i]:
            seq, lab = body, None
        else:
            lab = labels[li_l[i]]
            seq = front[lab][trim_l[i]:] + body + rear[lab]
        if rc_l[i]:
            seq = revcomp(seq)
        s = bytearray(seq)
        for _ in range(ne_l[i]):
            at = int(pos_l[k] * len(s))
            kind = kind_l[k]
            if kind == 0:  # substitution by another base
                s[at] = b"ACGT"[(code[s[at]] + 1 + base_l[k] % 3) % 4]
            elif kind == 1 and len(s) > 1:
                del s[at]
            elif kind == 2:
                s.insert(at, b"ACGT"[base_l[k]])
            k += 1
        seqs.append(bytes(s))
        labs.append(lab)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    # random bytes mapped evenly onto the quality range
    span = q_hi - q_lo
    qmap = bytes(33 + q_lo + (b * span >> 8) for b in range(256))
    qual_all = rng.bytes(int(lens.sum())).translate(qmap)
    qoffs = np.concatenate([[0], np.cumsum(lens)]).tolist()
    quals = [qual_all[qoffs[i]:qoffs[i + 1]] for i in range(n)]
    tail_hex = hexd[tails]
    descs, records = [], []
    for i in range(n):
        th = tail_hex[i].tobytes().decode()
        tail = f"{th[:4]}-{th[4:]}"
        desc = traffic["desc"].format(runid=runid, read=i + 1, ch=1 + i % 512)
        descs.append(desc)
        idpart = read_id(0, i, tail)[8:]
        records.append(f"{idpart} {desc}\n".encode() + seqs[i] + b"\n+\n" + quals[i] + b"\n")
    sample = np.sort(rng.choice(n, size=min(n, int(traffic["reference_sample"])), replace=False))
    return Pool(records, seqs, quals, descs, labs, sample)


def record(pool: Pool, pass_no: int, idx: int) -> bytes:
    return b"@%08x" % pass_no + pool.records[idx]


def bytes_written() -> int:
    """Bytes this process has caused to be written to storage so far."""
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0
