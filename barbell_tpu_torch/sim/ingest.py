"""External tool-output ingestion for the comparison harness.

The reference's benchmark crate normalizes every tool's output to one
wire format — ``read_id\\tbarcode\\tlen\\tn_flank_matches`` plus a
trimmed FASTA — so different demultiplexers can be scored by the same
downstream analysis (`benchmarks/src/compare/compare.rs:76-97`).  The
tool *runner* half of that harness shells out to installed binaries and
cannot exist here; this module is the *importer* half: given a tool's
already-produced output, normalize it and score it against ground
truth.

Supported layouts (reference ``parse_output`` impls):

* ``dorado``     — folder of per-barcode FASTQs; label = last ``_`` part
  of the file stem; ``unclassified`` skipped (`compare.rs:160-212`).
* ``barbell``    — folder of per-label FASTQs; label = first ``_`` part
  of the file stem (`compare.rs:255-303`).
* ``flexiplex``  — single ``classified_reads.fastq``; read headers are
  ``<barcode_seq>_#<read_id>_-1of1`` and a ``seq\\tlabel`` map file
  resolves barcode sequences to labels (`compare.rs:352-421`).
* ``tsv``        — generic ``read_id\\tlabel`` table (e.g. a Dorado
  barcoding summary reduced to two columns), for tools not listed.

``n_flank_matches`` is re-derived with an independent searcher exactly
like the reference's ``check_flanks_and_bars`` (`compare.rs:51-73`):
count flank hits (IUPAC, both strands, overhang alpha 0.5, <=15 edits)
whose window contains *some* barcode at <=4 edits on the same strand.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..kits.database import RBK4_FRONT, RBK4_REAR
from ..ops import oracle
from ..utils import dna
from ..utils.fastx import iter_fastq, split_fastq_header

# Reference `compare.rs:13-17`.
MAX_FLANK_EDITS = 15
MAX_BAR_EDITS = 4
FLANK_SEQ = (RBK4_FRONT + "N" * 24 + RBK4_REAR).encode()
OVERHANG_ALPHA = 0.5

IMPORT_TOOLS = ("dorado", "barbell", "flexiplex", "tsv")

Record = Tuple[str, str, Optional[bytes]]  # (read_id, label, seq or None)


def _iter_fastx_records(path: str) -> Iterator[Tuple[str, bytes]]:
    for header, seq, _q in iter_fastq([path]):
        yield split_fastq_header(header)[0], seq


def iter_dorado_folder(folder: str) -> Iterator[Record]:
    """Per-barcode FASTQs; label = last ``_`` part of the file stem,
    ``unclassified`` skipped (reference `compare.rs:176-212`)."""
    for path in sorted(glob(os.path.join(folder, "*.fastq"))):
        stem = os.path.basename(path)[: -len(".fastq")]
        label = stem.split("_")[-1]
        if label == "unclassified":
            continue
        for rid, seq in _iter_fastx_records(path):
            yield rid, label, seq


def iter_barbell_folder(folder: str) -> Iterator[Record]:
    """Per-label FASTQs; label = first ``_`` part of the file stem
    (reference `compare.rs:275-303`)."""
    for path in sorted(glob(os.path.join(folder, "*.fastq"))):
        stem = os.path.basename(path)[: -len(".fastq")]
        label = stem.split("_")[0]
        for rid, seq in _iter_fastx_records(path):
            yield rid, label, seq


def iter_flexiplex_output(path: str, barcode_map: Dict[str, str]) -> Iterator[Record]:
    """``classified_reads.fastq`` with ``<barseq>_#<read_id>_...`` headers
    (reference `compare.rs:382-421`).  ``path`` may be the file or its
    containing folder."""
    if os.path.isdir(path):
        path = os.path.join(path, "classified_reads.fastq")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Flexiplex output not found: {path}")
    for rid_raw, seq in _iter_fastx_records(path):
        bar_seq = rid_raw.split("_")[0]
        label = barcode_map.get(bar_seq)
        if label is None:
            raise ValueError(
                f"Barcode sequence {bar_seq!r} not in the barcode map "
                f"(flexiplex import needs --bar-file with seq\\tlabel rows)"
            )
        _, _, after = rid_raw.partition("#")
        if not after:
            raise ValueError(f"Unparseable flexiplex read header: {rid_raw!r}")
        yield after.split("_")[0], label, seq


def iter_generic_tsv(path: str, reads: Optional[Dict[str, bytes]] = None) -> Iterator[Record]:
    """Generic ``read_id\\tlabel`` rows; extra columns ignored, a header
    row whose first field is ``read_id`` is skipped."""
    with open(path) as fh:
        for lineno, line in enumerate(fh):
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) < 2:
                raise ValueError(
                    f"{path}:{lineno + 1}: expected >=2 tab-separated "
                    f"fields, got {line!r}"
                )
            rid, label = fields[0], fields[1]
            if lineno == 0 and rid == "read_id":
                continue
            yield rid, label, reads.get(rid) if reads is not None else None


def read_barcode_map(path: str) -> Dict[str, str]:
    """``seq\\tlabel`` rows (reference `compare.rs:369-380`)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def iter_tool_output(
    tool: str,
    path: str,
    bar_file: Optional[str] = None,
    reads: Optional[Dict[str, bytes]] = None,
) -> Iterator[Record]:
    if tool == "dorado":
        return iter_dorado_folder(path)
    if tool == "barbell":
        return iter_barbell_folder(path)
    if tool == "flexiplex":
        if bar_file is None:
            raise ValueError("flexiplex import needs --bar-file (seq\\tlabel map)")
        return iter_flexiplex_output(path, read_barcode_map(bar_file))
    if tool == "tsv":
        return iter_generic_tsv(path, reads)
    raise ValueError(f"Unknown import tool {tool!r}; use one of {IMPORT_TOOLS}")


# ---------------------------------------------------------------------------
# Independent construct counting (reference check_flanks_and_bars)
# ---------------------------------------------------------------------------


class ConstructCounter:
    """Counts intact flank+barcode constructs in a read, independent of
    whatever tool produced the assignment (reference `compare.rs:51-73`).

    ``bars`` is the candidate barcode sequence set (any hit counts —
    the reference checks all 96, not the assigned one)."""

    def __init__(self, bars: Iterable[bytes], flank: bytes = FLANK_SEQ):
        self.flank_masks = dna.encode(flank)
        self.bar_masks = [dna.encode(b) for b in bars]

    def count(self, seq: bytes) -> int:
        text = dna.encode(seq)
        n = 0
        for masks in (text, dna.reverse_complement_masks(text)):
            hits = oracle.search(
                self.flank_masks, masks, MAX_FLANK_EDITS, alpha=OVERHANG_ALPHA
            )
            for m in hits:
                lo = max(0, m.text_start)
                hi = min(len(masks), m.text_end)
                window = masks[lo:hi]
                if len(window) == 0:
                    continue
                # Window and barcode share the search orientation, which
                # is the reference's same-strand retain (`compare.rs:66`).
                if any(
                    oracle.search(bm, window, MAX_BAR_EDITS)
                    for bm in self.bar_masks
                ):
                    n += 1
                    break
        return n


def default_bars() -> List[bytes]:
    from .simulate import default_barcodes

    return [seq for _label, seq in default_barcodes(96)]


def write_normalized(
    records: Iterable[Record],
    anno_out: str,
    trimmed_out: Optional[str] = None,
    counter: Optional[ConstructCounter] = None,
) -> Dict[str, str]:
    """Write the reference's normalized annotation table
    (``read_id\\tbarcode\\tlen\\tn_flank_matches``, `compare.rs:80-97`)
    and optional trimmed FASTA; returns the read_id -> label dict.

    Records without sequences (generic TSV import without --reads) get
    ``len``/``n_flank_matches`` of -1 — explicitly unknown, never fake."""
    assigned: Dict[str, str] = {}
    trimmed_fh = open(trimmed_out, "w") if trimmed_out else None
    try:
        with open(anno_out, "w") as fh:
            for rid, label, seq in records:
                assigned[rid] = label
                if seq is None:
                    fh.write(f"{rid}\t{label}\t-1\t-1\n")
                    continue
                n_flank = counter.count(seq) if counter is not None else -1
                fh.write(f"{rid}\t{label}\t{len(seq)}\t{n_flank}\n")
                if trimmed_fh is not None:
                    trimmed_fh.write(f">{rid}\n{seq.decode()}\n")
    finally:
        if trimmed_fh is not None:
            trimmed_fh.close()
    return assigned
