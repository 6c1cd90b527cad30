"""FASTA/FASTQ input, transparently gzip-aware, plus header helpers.

Host-side IO layer.  A native (C++) accelerated reader can be slotted
in behind :func:`iter_fastq` later; this pure-Python path is the
portable fallback and the correctness reference.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Sequence, Tuple


def _open_maybe_gzip(path: str) -> io.BufferedReader:
    fh = open(path, "rb")
    magic = fh.peek(2)[:2] if hasattr(fh, "peek") else fh.read(2)
    if magic == b"\x1f\x8b":
        fh.seek(0)
        gz = gzip.GzipFile(fileobj=fh)
        # GzipFile(fileobj=...) does not own the fd; hand it ownership
        # (myfileobj is closed by GzipFile.close) so closing the reader
        # deterministically releases the descriptor instead of waiting
        # for GC.
        gz.myfileobj = fh  # type: ignore[assignment]
        return io.BufferedReader(gz)  # type: ignore[arg-type]
    fh.seek(0)
    return io.BufferedReader(fh)


def split_fastq_header(header: str) -> Tuple[str, str]:
    """Split a record header into (read_id, description).

    Reference `src/io/io.rs:6-16`: split at the first whitespace, strip
    leading whitespace from the description.
    """
    for i, ch in enumerate(header):
        if ch.isspace():
            return header[:i], header[i:].lstrip()
    return header, ""


def validate_fastq_paths(paths: Sequence[str]) -> None:
    if not paths:
        raise ValueError("No FASTQ input files provided")
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"FASTQ input not found: {p}")


def read_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence_bytes); name = first whitespace-split token."""
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gzip(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                parts = line[1:].split(None, 1)
                if not parts:
                    raise ValueError(f"FASTA header with no name in {path}")
                name = parts[0].decode("ascii")
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def iter_fastq_file(path: str) -> Iterator[Tuple[str, bytes, bytes]]:
    """Yield (header, seq, qual) per record from one FASTQ(.gz) file."""
    with _open_maybe_gzip(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip(b"\r\n")
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError(f"Malformed FASTQ record header in {path}: {header!r}")
            seq = fh.readline().rstrip(b"\r\n")
            plus = fh.readline()
            if not plus.startswith(b"+"):
                raise ValueError(f"Malformed FASTQ separator in {path}")
            qual = fh.readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise ValueError(
                    f"FASTQ quality length mismatch in {path} for {header!r}"
                )
            yield header[1:].decode("ascii"), seq, qual


def iter_fastq(paths: Sequence[str]) -> Iterator[Tuple[str, bytes, bytes]]:
    """Stream records from a collection of FASTQ files, in path order."""
    validate_fastq_paths(paths)
    for path in paths:
        yield from iter_fastq_file(path)


def iter_fastq_batches(
    paths: Sequence[str], batch_size: int
) -> Iterator[List[Tuple[str, bytes, bytes]]]:
    batch: List[Tuple[str, bytes, bytes]] = []
    for rec in iter_fastq(paths):
        batch.append(rec)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
