"""Simulated reads with their true labels, for driving the port.

:func:`make_reads_rbk` is the read model of ``bench.py``'s
``rbk114_96`` workload, on the simulator :mod:`.simulate`: a rapid
adapter with a random one of the 96 default barcodes, then a random
body; 600-4000 bp in all, half of the reads reverse complemented, up to
6 random edits.  :func:`make_reads_kit` is the same model for any
registered kit's constructs (``bench.py``'s ``nbd114_96`` reads for
``SQK-NBD114-96``).
"""

from __future__ import annotations

import random
from typing import List, Tuple

from ..kits.database import expand_template, get_kit_info
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


def make_reads_kit(kit_name: str, n: int,
                   seed: int = 0) -> List[Tuple[str, bytes, str]]:
    """``n`` reads of kit ``kit_name`` as (read_id, sequence, true
    label): each read carries one random barcode of the kit at every
    end a construct template puts it, the ``left`` templates' constructs
    at the read's start and the ``right`` ones' reverse complemented at
    its end; a ``double`` kit with no ``right`` template carries its
    construct at both ends (``construct + body + rc(construct)``, the
    model of ``bench.py``'s native-barcoding reads, which this equals
    for ``SQK-NBD114-96``).  The extended (fusion) templates are left
    out.  Bodies of 600-4000 bp, half of the reads reverse complemented,
    up to 6 random edits, as :func:`make_reads_rbk`."""
    spec = get_kit_info(kit_name)
    sides = {"left": [], "right": []}
    for tmpl in spec.templates:
        if not tmpl.extended:
            labels, seqs = expand_template(tmpl)
            sides[tmpl.side].append(dict(zip(labels, (s.encode() for s in seqs))))
    labels = list((sides["left"] or sides["right"])[0])
    both_ends = spec.pattern_class == "double" and not sides["right"]
    rng = random.Random(seed)
    reads = []
    for i in range(n):
        label = labels[rng.randrange(len(labels))]
        front = b"".join(c[label] for c in sides["left"])
        rear = b"".join(dna.reverse_complement_bytes(c[label]) for c in sides["right"])
        if both_ends:
            rear = dna.reverse_complement_bytes(front)
        body = bytes(random_sequence(rng, rng.randrange(600, 4000)))
        seq = front + body + rear
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
