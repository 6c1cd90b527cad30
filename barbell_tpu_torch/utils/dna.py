"""IUPAC nucleotide encoding for device-side approximate matching.

Design: every base maps to a 4-bit membership mask over {A, C, G, T}
(A=1, C=2, G=4, T=8).  Two bases *match* iff their masks intersect —
this reproduces the IUPAC semantics of the reference's search profile
(flank masks use ``N`` = matches anything; degenerate codes match their
sets; see reference `src/annotate/barcodes.rs:394-441` for the
complement table it relies on).  The mask form is what the TPU kernels
consume: match(p, t) = (mask[p] & mask[t]) != 0 is a single vectorized
AND+compare over u8 lanes, and reverse-complementing a mask is a pure
bit permutation (A<->T, C<->G = reversing the nibble's bit order).
"""

from __future__ import annotations

import numpy as np

# 4-bit membership masks.
_A, _C, _G, _T = 1, 2, 4, 8

IUPAC_MASK = {
    "A": _A, "C": _C, "G": _G, "T": _T,
    "U": _T,
    "R": _A | _G, "Y": _C | _T, "S": _C | _G, "W": _A | _T,
    "K": _G | _T, "M": _A | _C,
    "B": _C | _G | _T, "D": _A | _G | _T, "H": _A | _C | _T, "V": _A | _C | _G,
    "N": _A | _C | _G | _T,
    "X": 0,  # matches nothing
}

IUPAC_COMPLEMENT = {
    "A": "T", "C": "G", "G": "C", "T": "A", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "D": "H", "H": "D", "V": "B", "N": "N", "X": "X",
}

# byte -> 4-bit mask lookup (uppercase + lowercase); invalid bytes -> 255.
ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _m in IUPAC_MASK.items():
    ENCODE_LUT[ord(_ch)] = _m
    ENCODE_LUT[ord(_ch.lower())] = _m

# byte -> 2-bit base code (A=0 C=1 G=2 T=3); anything whose mask is not
# a single base (N, degenerate IUPAC, junk) -> 255 and must ride the
# exception list of the 2-bit device upload path.
CODE2_LUT = np.full(256, 255, dtype=np.uint8)
# 4-bit mask -> 2-bit code, same convention (255 = not a single base).
MASK_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _code, _mask in enumerate((1, 2, 4, 8)):
    MASK_CODE_LUT[_mask] = _code
    CODE2_LUT[np.nonzero(ENCODE_LUT == _mask)[0]] = _code

# byte -> complement byte (identity for unknown bytes, mirrors the
# reference's RC table which leaves unknown bytes unchanged).
COMPLEMENT_LUT = np.arange(256, dtype=np.uint8)
for _ch, _cc in IUPAC_COMPLEMENT.items():
    COMPLEMENT_LUT[ord(_ch)] = ord(_cc)
    COMPLEMENT_LUT[ord(_ch.lower())] = ord(_cc.lower())

# 4-bit mask -> complement mask: complementing A<->T, C<->G reverses the
# bit order of the nibble.
MASK_COMPLEMENT_LUT = np.zeros(16, dtype=np.uint8)
for _m in range(16):
    _out = 0
    if _m & _A:
        _out |= _T
    if _m & _C:
        _out |= _G
    if _m & _G:
        _out |= _C
    if _m & _T:
        _out |= _A
    MASK_COMPLEMENT_LUT[_m] = _out

# byte -> complement 4-bit mask / 2-bit code, for the native rc chunk
# encoder: byte-level composition of the numpy path's
# MASK_COMPLEMENT_LUT[ENCODE_LUT[b] & 0xF] (invalid bytes keep the
# N-like 15 mask) and MASK_CODE_LUT of that.
MASKC_LUT = MASK_COMPLEMENT_LUT[ENCODE_LUT & 0xF]
CODE2C_LUT = MASK_CODE_LUT[MASKC_LUT]


def seq_to_bytes(seq) -> np.ndarray:
    """Coerce str/bytes/ndarray sequence to a uint8 byte array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    arr = np.asarray(seq, dtype=np.uint8)
    return arr


def encode(seq) -> np.ndarray:
    """Encode a sequence into 4-bit IUPAC masks (uint8). Invalid bytes -> 255."""
    return ENCODE_LUT[seq_to_bytes(seq)]


def is_valid_iupac(seq) -> bool:
    """True iff every byte is a recognised IUPAC code (either case)."""
    return bool((ENCODE_LUT[seq_to_bytes(seq)] != 255).all())


def reverse_complement_bytes(seq) -> bytes:
    """Reverse complement at the byte level (IUPAC-aware, case preserved)."""
    arr = seq_to_bytes(seq)
    return COMPLEMENT_LUT[arr[::-1]].tobytes()


def reverse_complement_str(seq: str) -> str:
    return reverse_complement_bytes(seq).decode("ascii")


def reverse_complement_masks(masks: np.ndarray) -> np.ndarray:
    """Reverse complement an encoded 4-bit mask array.

    Invalid bytes encode to 255; degrade them to N (mask 15, matches
    everything — complement likewise) instead of indexing out of the
    16-entry LUT.  The device path does the same via nibble packing."""
    return MASK_COMPLEMENT_LUT[masks[::-1] & 0xF]


def upper_bytes(seq) -> bytes:
    """Uppercase a sequence (normalization used on FASTA query ingest)."""
    arr = seq_to_bytes(seq).copy()
    lower = (arr >= ord("a")) & (arr <= ord("z"))
    arr[lower] -= 32
    return arr.tobytes()
