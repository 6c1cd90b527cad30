"""Synthetic Nanopore read generator with ground truth.

Six read classes mirroring the reference benchmark harness
(`benchmarks/src/simulations/sim_data.rs:403-411`):

* Group I   — random sequence, no construct (expect: rejected)
* Group II  — valid barcode+adapter at the front (expect: recovered)
* Group III — Group II with the construct's left end randomly trimmed
* Group IV  — two different-barcode constructs stacked at the front (reject)
* Group V   — construct at the front plus one mid-read (reject)
* Group VI  — different barcodes at both ends (reject)

Reads are 600-4000bp, up to 6 random edits, optional reverse-complement
fraction; truth tables are ``read_id\\tlabel`` TSVs.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..kits.database import RBK4_FRONT, RBK4_REAR
from ..utils import dna

READ_MIN_LEN = 600
READ_MAX_LEN = 4000
MAX_TRIM = 20
MIN_DOUBLE_SPACE = 10
MAX_EDITS = 6

GROUPS = ("GroupI", "GroupII", "GroupIII", "GroupIV", "GroupV", "GroupVI")


def rapid_adapter(barcode_seq: bytes) -> bytes:
    return RBK4_FRONT.encode() + barcode_seq + RBK4_REAR.encode()


def random_sequence(rng: random.Random, length: int) -> bytearray:
    return bytearray(rng.choice(b"ACGT") for _ in range(length))


def random_quality(rng: random.Random, length: int) -> bytes:
    return bytes(rng.randrange(0, 40) + 33 for _ in range(length))


def mutate_sequence(
    rng: random.Random, seq: bytes, min_edits: int, max_edits: int
) -> bytes:
    s = bytearray(seq)
    for _ in range(rng.randint(min_edits, max_edits)):
        idx = rng.randrange(len(s))
        op = rng.randrange(3)
        if op == 0:
            cur = s[idx]
            new = cur
            while new == cur:
                new = rng.choice(b"ACGT")
            s[idx] = new
        elif op == 1 and len(s) > 1:
            del s[idx]
        elif op == 2:
            s.insert(idx, rng.choice(b"ACGT"))
    return bytes(s)


def noise_sequence(rng: random.Random, seq: bytes, error_rate: float) -> bytes:
    """Per-base error model at realistic Nanopore rates: every base
    independently suffers an error with probability ``error_rate``,
    split 50% substitution / 25% insertion / 25% deletion — the
    documented R10.4 simplex regime is ~5-8% mixed errors.  The
    reference's mutator (`benchmarks/src/simulations/mutate.rs:5-31`)
    draws a bounded COUNT of edits instead, which cannot express a
    per-base rate on variable-length reads; this generator exists for
    the `rbk114_96_noisy` bench config and the elevated-noise accuracy
    contract.  Vectorized (numpy): a python per-base loop costs ~15s
    per 16k-read dataset on the 1-core bench host."""
    if not seq or error_rate <= 0.0:
        return seq
    a = np.frombuffer(seq, dtype=np.uint8)
    n = a.size
    gen = np.random.default_rng(rng.getrandbits(64))
    r = gen.random(n)
    is_err = r < error_rate
    kind = gen.random(n)  # <.5 sub, <.75 ins (after base), else del
    is_sub = is_err & (kind < 0.5)
    is_ins = is_err & (kind >= 0.5) & (kind < 0.75)
    is_del = is_err & (kind >= 0.75)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    # substitutions: shift to a uniformly random DIFFERENT base
    idx = np.searchsorted(bases, a)  # ACGT are sorted byte values
    idx = np.clip(idx, 0, 3)
    known = bases[idx] == a  # leave N/IUPAC bytes alone
    sub_idx = (idx + gen.integers(1, 4, size=n)) % 4
    out = np.where(is_sub & known, bases[sub_idx], a)
    # repeat counts: 0 = deleted, 2 = kept + inserted base after
    counts = np.ones(n, dtype=np.int64)
    counts[is_del] = 0
    counts[is_ins] = 2
    rep = np.repeat(out, counts)
    if is_ins.any():
        # positions of the inserted copies within the repeated array
        ends = np.cumsum(counts)
        ins_pos = ends[is_ins] - 1
        rep[ins_pos] = bases[gen.integers(0, 4, size=ins_pos.size)]
    return rep.tobytes()


def random_trim_side(
    rng: random.Random, seq: bytes, max_trim: int, allow_front: bool, allow_back: bool
) -> bytes:
    # The trim coins are flipped INDEPENDENTLY of the allow flags —
    # reference parity (`mutate.rs:42-51`): ~half of GroupIII reads end
    # up untrimmed, by the reference's own design.
    s = bytearray(seq)
    trim_length = rng.randint(1, max_trim)
    trim_front = rng.random() < 0.5
    trim_back = rng.random() < 0.5
    if trim_front and allow_front:
        del s[:trim_length]
    if trim_back and allow_back:
        del s[len(s) - trim_length :]
    return bytes(s)


class _Collection:
    def __init__(self):
        self.reads: List[Tuple[str, bytes, Optional[str]]] = []

    def add(self, read_id: str, seq: bytes, truth: Optional[str]):
        self.reads.append((read_id, seq, truth))

    def dump(self, rng: random.Random, fastq_out: str, truth_out: str, rc_frac: float):
        with open(fastq_out, "w") as ffh, open(truth_out, "w") as tfh:
            for read_id, seq, truth in self.reads:
                if rng.random() < rc_frac:
                    seq = dna.reverse_complement_bytes(seq)
                seq = mutate_sequence(rng, seq, 0, MAX_EDITS)
                qual = random_quality(rng, len(seq))
                ffh.write(f"@{read_id}\n{seq.decode()}\n+\n{qual.decode()}\n")
                if truth is not None:
                    tfh.write(f"{read_id}\t{truth}\n")


def _rand_read(rng: random.Random) -> bytearray:
    return random_sequence(rng, rng.randrange(READ_MIN_LEN, READ_MAX_LEN))


def _gen_group(
    group: str,
    rng: random.Random,
    n: int,
    barcodes: Sequence[Tuple[str, bytes]],
) -> _Collection:
    col = _Collection()
    if group in ("GroupIV", "GroupV", "GroupVI") and len(barcodes) < 2:
        raise ValueError(
            f"{group} needs >= 2 barcodes (it pairs two distinct barcodes per read); "
            f"got {len(barcodes)}"
        )
    for i in range(n):
        # Group-prefixed ids so multiple group files can be mixed in one run.
        read_id = f"{group}_seq_{i}"
        body = _rand_read(rng)
        if group == "GroupI":
            col.add(read_id, bytes(body), None)
            continue

        first_idx = rng.randrange(len(barcodes))
        name1, seq1 = barcodes[first_idx]
        adapter1 = rapid_adapter(seq1)

        if group == "GroupII":
            col.add(read_id, adapter1 + bytes(body), name1)
        elif group == "GroupIII":
            trimmed = random_trim_side(rng, adapter1, MAX_TRIM, True, False)
            col.add(read_id, trimmed + bytes(body), name1)
        else:
            others = [j for j in range(len(barcodes)) if j != first_idx]
            name2, seq2 = barcodes[rng.choice(others)]
            adapter2 = rapid_adapter(seq2)
            if group == "GroupIV":
                spacer = bytes(random_sequence(rng, MIN_DOUBLE_SPACE))
                col.add(
                    read_id,
                    adapter1 + spacer + adapter2 + bytes(body),
                    f"{name1}_{name2}_double_front",
                )
            elif group == "GroupV":
                mid = max(0, len(body) // 2 - len(adapter1))
                combined = adapter1 + bytes(body[:mid]) + adapter2 + bytes(body[mid:])
                col.add(read_id, combined, f"{name1}_{name2}_mid_insert")
            elif group == "GroupVI":
                combined = (
                    adapter1 + bytes(body) + dna.reverse_complement_bytes(adapter2)
                )
                col.add(read_id, combined, f"{name1}_{name2}_front_back")
            else:
                raise ValueError(group)
    return col


def default_barcodes(count: int = 96) -> List[Tuple[str, bytes]]:
    """RBK96 rapid-kit barcode set; labels match the kit's output labels."""
    from ..kits.database import get_barcodes, lookup_barcode_seq

    labels = get_barcodes("RBK01", f"RBK{count:02d}", False)
    return [(label, lookup_barcode_seq(label).encode()) for label in labels]


def create_testdata(
    n: int,
    sim_out_dir: str,
    barcodes: Optional[Sequence[Tuple[str, bytes]]] = None,
    rc_frac: float = 0.5,
    seed: int = 0,
    groups: Sequence[str] = GROUPS,
) -> None:
    os.makedirs(sim_out_dir, exist_ok=True)
    if barcodes is None:
        barcodes = default_barcodes()
    rng = random.Random(seed)
    for group in groups:
        col = _gen_group(group, rng, n, barcodes)
        col.dump(
            rng,
            os.path.join(sim_out_dir, f"{group}.fastq"),
            os.path.join(sim_out_dir, f"{group}_truth.txt"),
            rc_frac,
        )
