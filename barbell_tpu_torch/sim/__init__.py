"""Simulated reads with their true labels, for driving the port.

The read model of ``bench.py``'s ``rbk114_96`` workload, on the
simulator :mod:`.simulate`: a rapid adapter with a random one of the 96
default barcodes, then a random body; 600-4000 bp in all, half of the
reads reverse complemented, up to 6 random edits.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from ..utils import dna
from .simulate import (
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)


def make_reads_rbk(
    n: int, seed: int = 0, long_every: int = 0
) -> List[Tuple[str, bytes, str]]:
    """``n`` SQK-RBK114-96 reads as (read_id, sequence, true label);
    with ``long_every`` > 0, reads ``long_every - 1``, ``2 * long_every
    - 1``, ... get 9000-20000 bp bodies (the other reads are unchanged)."""
    rng = random.Random(seed)
    barcodes = default_barcodes(96)
    reads = []
    for i in range(n):
        label, bseq = barcodes[rng.randrange(96)]
        n_body = rng.randrange(600, 4000)
        if long_every and i % long_every == long_every - 1:
            n_body = rng.randrange(9000, 20000)
        body = bytes(random_sequence(rng, n_body))
        seq = rapid_adapter(bseq) + body
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        seq = mutate_sequence(rng, seq, 0, 6)
        reads.append((f"seq_{i}", seq, label))
    return reads


def write_fastq(path: str, reads) -> None:
    """(read_id, sequence, ...) tuples as a FASTQ with constant quality."""
    with open(path, "w") as fh:
        for rid, seq, *_ in reads:
            s = seq.decode()
            fh.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
