"""Oxford Nanopore kit database: flanks, barcode sequences, templates.

Sequence data is the public Dorado-derived constant set the reference
ships (`src/kits/kits.rs:8-47,819-1103`; upstream provenance
nanoporetech/dorado `barcode_kits.cpp`).  Layout here is ours: a kit is
a name -> :class:`KitSpec` mapping; each template expands to a query
group of ``front + {BAR} + rear`` constructs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Flank constants
# ---------------------------------------------------------------------------

RAB_1ST_FRONT = "CCGTGAC"
RAB_1ST_REAR = "AGAGTTTGATCATGGCTCAG"
RAB_2ND_FRONT = "CCGTGAC"
RAB_2ND_REAR = "CGGTTACCTTGTTACGACTT"

RBK_FRONT = "TATTGCT"
RBK_REAR = "GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA"

RBK4_FRONT = "GCTTGGGTGTTTAACC"
RBK4_REAR = "GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA"
# Suffix of the RBK4 template for direct-concatenation fusion constructs.
RBK4_FRONT_FUSION = "TTCGTGCGCCGCTTCA"

RBK4_KIT14_FRONT = "GCTTGGGTGTTTAACC"
RBK4_KIT14_REAR = "GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA"

RLB_FRONT = "CCGTGAC"
RLB_REAR = "CGTTTTTCGTGCGCCGCTTC"

BC_1ST_FRONT = "GGTGCTG"
BC_1ST_REAR = "TTAACCTTTCTGTTGGTGCTGATATTGC"
BC_2ND_FRONT = "GGTGCTG"
BC_2ND_REAR = "TTAACCTACTTGCCTGTCGCTCTATCTTC"

NB_1ST_FRONT = "ATTGCTAAGGTTAA"
NB_1ST_REAR = "CAGCACCT"

LWB_1ST_FRONT = "CCGTGAC"
LWB_1ST_REAR = "ACTTGCCTGTCGCTCTATCTTC"
LWB_2ND_FRONT = "CCGTGAC"
LWB_2ND_REAR = "TTTCTGTTGGTGCTGATATTGC"

MAB_FRONT = "TTTAACC"
MAB_REAR = "CCATATCCGTGTC"

# ---------------------------------------------------------------------------
# Label tables
# ---------------------------------------------------------------------------

ALL_BARS: List[str] = [f"BC{i:02d}" for i in range(1, 97)]
ALL_AMPLICON_BARS: List[str] = [f"AB{i:02d}" for i in range(1, 25)]

# ---------------------------------------------------------------------------
# Barcode sequences
# ---------------------------------------------------------------------------

BC_SEQS: List[str] = [
    "AAGAAAGTTGTCGGTGTCTTTGTG", "TCGATTCCGTTTGTAGTCGTCTGT",
    "GAGTCTTGTGTCCCAGTTACCAGG", "TTCGGATTCTATCGTGTTTCCCTA",
    "CTTGTCCAGGGTTTGTGTAACCTT", "TTCTCGCAAAGGCAGAAAGTAGTC",
    "GTGTTACCGTGGGAATGAATCCTT", "TTCAGGGAACAAACCAAGTTACGT",
    "AACTAGGCACAGCGAGTCTTGGTT", "AAGCGTTGAAACCTTTGTCCTCTC",
    "GTTTCATCTATCGGAGGGAATGGA", "CAGGTAGAAAGAAGCAGAATCGGA",
    "AGAACGACTTCCATACTCGTGTGA", "AACGAGTCTCTTGGGACCCATAGA",
    "AGGTCTACCTCGCTAACACCACTG", "CGTCAACTGACAGTGGTTCGTACT",
    "ACCCTCCAGGAAAGTACCTCTGAT", "CCAAACCCAACAACCTAGATAGGC",
    "GTTCCTCGTGCAGTGTCAAGAGAT", "TTGCGTCCTGTTACGAGAACTCAT",
    "GAGCCTCTCATTGTCCGTTCTCTA", "ACCACTGCCATGTATCAAAGTACG",
    "CTTACTACCCAGTGAACCTCCTCG", "GCATAGTTCTGCATGATGGGTTAG",
    "GTAAGTTGGGTATGCAACGCAATG", "CATACAGCGACTACGCATTCTCAT",
    "CGACGGTTAGATTCACCTCTTACA", "TGAAACCTAAGAAGGCACCGTATC",
    "CTAGACACCTTGGGTTGACAGACC", "TCAGTGAGGATCTACTTCGACCCA",
    "TGCGTACAGCAATCAGTTACATTG", "CCAGTAGAAGTCCGACAACGTCAT",
    "CAGACTTGGTACGGTTGGGTAACT", "GGACGAAGAACTCAAGTCAAAGGC",
    "CTACTTACGAAGCTGAGGGACTGC", "ATGTCCCAGTTAGAGGAGGAAACA",
    "GCTTGCGATTGATGCTTAGTATCA", "ACCACAGGAGGACGATACAGAGAA",
    "CCACAGTGTCAACTAGAGCCTCTC", "TAGTTTGGATGACCAAGGATAGCC",
    "GGAGTTCGTCCAGAGAAGTACACG", "CTACGTGTAAGGCATACCTGCCAG",
    "CTTTCGTTGTTGACTCGACGGTAG", "AGTAGAAAGGGTTCCTTCCCACTC",
    "GATCCAACAGAGATGCCTTCAGTG", "GCTGTGTTCCACTTCATTCTCCTG",
    "GTGCAACTTTCCCACAGGTAGTTC", "CATCTGGAACGTGGTACACCTGTA",
    "ACTGGTGCAGCTTTGAACATCTAG", "ATGGACTTTGGTAACTTCCTGCGT",
    "GTTGAATGAGCCTACTGGGTCCTC", "TGAGAGACAAGATTGTTCGTGGAC",
    "AGATTCAGACCGTCTCATGCAAAG", "CAAGAGCTTTGACTAAGGAGCATG",
    "TGGAAGATGAGACCCTGATCTACG", "TCACTACTCAACAGGTGGCATGAA",
    "GCTAGGTCAATCTCCTTCGGAAGT", "CAGGTTACTCCTCCGTGAGTCTGA",
    "TCAATCAAGAAGGGAAAGCAAGGT", "CATGTTCAACCAAGGCTTCTATGG",
    "AGAGGGTACTATGTGCCTCAGCAC", "CACCCACACTTACTTCAGGACGTA",
    "TTCTGAAGTTCCTGGGTCTTGAAC", "GACAGACACCGTTCATCGACTTTC",
    "TTCTCAGTCTTCCTCCAGACAAGG", "CCGATCCTTGTGGCTTCTAACTTC",
    "GTTTGTCATACTCGTGTGCTCACC", "GAATCTAAGCAAACACGAAGGTGG",
    "TACAGTCCGAGCCTCATGTGATCT", "ACCGAGATCCTACGAATGGAGTGT",
    "CCTGGGAGCATCAGGTAGTAACAG", "TAGCTGACTGTCTTCCATACCGAC",
    "AAGAAACAGGATGACAGAACCCTC", "TACAAGCATCCCAACACTTCCACT",
    "GACCATTGTGATGAACCCTGTTGT", "ATGCTTGTTACATCAACCCTGGAC",
    "CGACCTGTTTCTCAGGGATACAAC", "AACAACCGAACCTTTGAATCAGAA",
    "TCTCGGAGATAGTTCTCACTGCTG", "CGGATGAACATAGGATAGCGATTC",
    "CCTCATCTTGTGAAGTTGTTTCGG", "ACGGTATGTCGAGTTCCAGGACTA",
    "TGGCTTGATCTAGGTAAGGTCGAA", "GTAGTGGACCTAGAACCTGTGCCA",
    "AACGGAGGAGTTAGTTGGATGATC", "AGGTGATCCCAACAAGCGTAAGTA",
    "TACATGCTCCTGTTGTTAGGGAGG", "TCTTCTACTACCGATCCGAAGCAG",
    "ACAGCATCAATGTTTGGCTAGTTG", "GATGTAGAGGGTACGGTTTGAGGC",
    "GGCTCCATAGGAACTCACGCTACT", "TTGTGAGTGGAAAGATACAGGACC",
    "AGTTTCCATCACTTCAGACTTGGG", "GATTGTCCTCAAACTGCCACCTAC",
    "CCTGTCTGGAAGAAGAATGGACTT", "CTGAACGGTCATAGAGTCCACCAT",
]

BP_SEQS: List[str] = [
    "CAAGAAAGTTGTCGGTGTCTTTGTGAC", "CTCGATTCCGTTTGTAGTCGTCTGTAC",
    "CGAGTCTTGTGTCCCAGTTACCAGGAC", "CTTCGGATTCTATCGTGTTTCCCTAAC",
    "CCTTGTCCAGGGTTTGTGTAACCTTAC", "CTTCTCGCAAAGGCAGAAAGTAGTCAC",
    "CGTGTTACCGTGGGAATGAATCCTTAC", "CTTCAGGGAACAAACCAAGTTACGTAC",
    "CAACTAGGCACAGCGAGTCTTGGTTAC", "CAAGCGTTGAAACCTTTGTCCTCTCAC",
    "CGTTTCATCTATCGGAGGGAATGGAAC", "CCAGGTAGAAAGAAGCAGAATCGGAAC",
    "CAGAACGACTTCCATACTCGTGTGAAC", "CAACGAGTCTCTTGGGACCCATAGAAC",
    "CAGGTCTACCTCGCTAACACCACTGAC", "CCGTCAACTGACAGTGGTTCGTACTAC",
    "CACCCTCCAGGAAAGTACCTCTGATAC", "CCCAAACCCAACAACCTAGATAGGCAC",
    "CGTTCCTCGTGCAGTGTCAAGAGATAC", "CTTGCGTCCTGTTACGAGAACTCATAC",
    "CGAGCCTCTCATTGTCCGTTCTCTAAC", "CACCACTGCCATGTATCAAAGTACGAC",
    "CCTTACTACCCAGTGAACCTCCTCGAC", "CGCATAGTTCTGCATGATGGGTTAGAC",
]

NB_SEQS: List[str] = [
    "CACAAAGACACCGACAACTTTCTT", "ACAGACGACTACAAACGGAATCGA",
    "CCTGGTAACTGGGACACAAGACTC", "TAGGGAAACACGATAGAATCCGAA",
    "AAGGTTACACAAACCCTGGACAAG", "GACTACTTTCTGCCTTTGCGAGAA",
    "AAGGATTCATTCCCACGGTAACAC", "ACGTAACTTGGTTTGTTCCCTGAA",
    "AACCAAGACTCGCTGTGCCTAGTT", "GAGAGGACAAAGGTTTCAACGCTT",
    "TCCATTCCCTCCGATAGATGAAAC", "TCCGATTCTGCTTCTTTCTACCTG",
] + BC_SEQS[12:]

AB_SEQS: List[str] = [
    "GCACCTGGAACTTGTGCCTTCCAC", "CCGAAATAGGTTATCTGTTGTTGT",
    "ATCAATCGCTGGACGATGGATTAG", "CCACCCGCTCCTGCCGGTGGGCGT",
    "AGACTCTTGGGCTCGCCACGTCCC", "TCTGTATCCGGAGACGGGATGGAC",
    "TTTCGGATCAATCGACCGCAAACG", "ACTCAAACATTCTGTTAGATCGCG",
    "AAATGGAACCCGGATATGTTTACT", "TAAATCGACCTATGATGAACACAG",
    "ACATGTTGGAGTGAAAGTCGGGTA", "CCTGGACCACGATCATTGTAACAT",
    "TATGGTGGATCTCCCTCTATCTTC", "AAGTAAATGGGACGCCCACTCCGA",
    "TGTTCGCGGCTTGATCTAATATTA", "AGAGAGCTTCCCGGGAGGGTGGTC",
    "TTGTGAATATCTGTCACAAACACC", "CAATCGTACCAGGGAACATAAAGT",
    "CACACCCAAACAATATGGACCCGT", "AATAACCACATCCGCCCTCCGCAC",
    "TCCTAATAATGTGTAGATCGGTCC", "AGTCGATGGAACAAGAGAAGTTAT",
    "AAACTCACTGTATGTCGTTTCTAT", "TGACATCACTGATCGAGGAAGATC",
]

# The 12A special (RLB kit; BC12A/NB12A when requested).
BC12A_SEQ = "GTTGAGTTACAAAGCACCGATCAG"

# RBK-specific replacements for six indices (RBK labels diverge from BC).
RBK_SPECIAL_SEQS: Dict[int, str] = {
    26: "ACTATGCCTTTCCGTGAAACAGTT",
    39: "TCTGCCACACACTCGTAAGTCCTT",
    40: "GTCGATACTGGACCTATCCCTTGG",
    48: "GAGTCCGTGACAACTTCTGAAAGC",
    54: "GGGTGCCAACTACATACCAAACCT",
    60: "GAACCCTACTTTGGACAGACACCT",
}
RBK_SPECIAL_IDS = tuple(sorted(RBK_SPECIAL_SEQS))

# ---------------------------------------------------------------------------
# Label parsing / range expansion
# ---------------------------------------------------------------------------


def parse_label(label: str) -> Tuple[str, int, bool]:
    """Split e.g. 'BC12A' -> ('BC', 12, True); case-insensitive."""
    upper = label.upper()
    i = 0
    while i < len(upper) and upper[i].isalpha():
        i += 1
    prefix = upper[:i]
    j = i
    while j < len(upper) and upper[j].isdigit():
        j += 1
    if j == i:
        raise ValueError(f"Invalid numeric part in label: {label!r}")
    number = int(upper[i:j])
    a_flag = j < len(upper) and upper[j] == "A"
    return prefix, number, a_flag


def get_barcodes(from_label: str, to_label: str, use_12a_flag: bool) -> List[str]:
    """Expand a label range with the kit-specific relabeling rules.

    Mirrors reference `src/kits/kits.rs:741-816`: BC12 -> BC12A when the
    12A flag is set (explicitly or via an 'A'-suffixed boundary label),
    NB kits relabel BC->NB, AB kits use the amplicon table, RBK kits
    relabel the six special indices BC->RBK.
    """
    pf_from, from_num, from_a = parse_label(from_label)
    pf_to, to_num, to_a = parse_label(to_label)
    if pf_from != pf_to:
        raise ValueError(f"Mismatched label prefixes: {pf_from} vs {pf_to}")

    start, end = (from_num, to_num) if from_num <= to_num else (to_num, from_num)
    table = ALL_AMPLICON_BARS if pf_from == "AB" else ALL_BARS
    if start < 1 or end > len(table):
        # the reference's `ALL_BARS[from..to]` slice panics out of range
        # (`src/kits/kits.rs:761-770`); never clip silently
        raise ValueError(
            f"Barcode label range {from_label}..{to_label} outside "
            f"1..{len(table)}"
        )
    labels = list(table[start - 1 : end])

    use_12a = use_12a_flag or ((from_a or to_a) and start <= 12 <= end)
    if use_12a:
        labels = ["BC12A" if lbl == "BC12" else lbl for lbl in labels]

    if pf_from == "NB":
        labels = [("NB" + lbl[2:]) if lbl.startswith("BC") else lbl for lbl in labels]

    if pf_from == "RBK":
        out = []
        for lbl in labels:
            if lbl.startswith("BC") and len(lbl) >= 4 and lbl[2:4].isdigit():
                n = int(lbl[2:4])
                if n in RBK_SPECIAL_IDS:
                    lbl = "RBK" + lbl[2:]
            out.append(lbl)
        labels = out
    return labels


def lookup_barcode_seq(label: str) -> Optional[str]:
    """Barcode sequence for a label (reference `src/kits/kits.rs:1074-1103`)."""
    prefix, number, is_a = parse_label(label)
    if prefix == "BC":
        if is_a and number == 12:
            return BC12A_SEQ
        return BC_SEQS[number - 1] if 1 <= number <= len(BC_SEQS) else None
    if prefix == "NB":
        if is_a and number == 12:
            return BC12A_SEQ
        return NB_SEQS[number - 1] if 1 <= number <= len(NB_SEQS) else None
    if prefix == "AB":
        return AB_SEQS[number - 1] if 1 <= number <= len(AB_SEQS) else None
    if prefix == "BP":
        return BP_SEQS[number - 1] if 1 <= number <= len(BP_SEQS) else None
    if prefix == "RBK":
        if number in RBK_SPECIAL_SEQS:
            return RBK_SPECIAL_SEQS[number]
        return BC_SEQS[number - 1] if 1 <= number <= len(BC_SEQS) else None
    return None


# ---------------------------------------------------------------------------
# Templates and kit registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LabelRange:
    from_label: str
    to_label: str
    use_12a: bool = False


@dataclass(frozen=True)
class TemplateSpec:
    """A construct template: parts with '{BAR}' substituted per barcode.

    ``side`` 'left' -> Ftag group, 'right' -> Rtag group.  ``extended``
    templates (fusion/artefact constructs) are only expanded with
    ``use_extended`` (reference `src/kits/kits.rs:100-104`).
    """

    parts: Tuple[str, ...]
    barcodes: LabelRange
    side: str  # 'left' | 'right'
    extended: bool = False


@dataclass(frozen=True)
class KitSpec:
    name: str
    templates: Tuple[TemplateSpec, ...]
    # 'single' kits use single-end filter presets; 'double' kits expect
    # constructs on both ends (reference pattern-set choice per kit).
    pattern_class: str  # 'single' | 'double'


def _tmpl(front: str, rear: str, rng: LabelRange, side: str, extended: bool = False) -> TemplateSpec:
    return TemplateSpec(parts=(front, "{BAR}", rear), barcodes=rng, side=side, extended=extended)


_KITS: Dict[str, KitSpec] = {}


def _register(spec: KitSpec, *aliases: str) -> None:
    for alias in aliases:
        _KITS[alias] = spec


_register(
    KitSpec(
        "16S",
        (
            _tmpl(RAB_1ST_FRONT, RAB_1ST_REAR, LabelRange("BC01", "BC24"), "left"),
            _tmpl(RAB_2ND_FRONT, RAB_2ND_REAR, LabelRange("BC01", "BC24"), "right"),
        ),
        "double",
    ),
    "SQK-16S024",
    "SQK-16S114-24",
)

_register(
    KitSpec(
        "LWB",
        (
            _tmpl(LWB_1ST_FRONT, LWB_1ST_REAR, LabelRange("BC01", "BC12"), "left"),
            _tmpl(LWB_2ND_FRONT, LWB_2ND_REAR, LabelRange("BC01", "BC12"), "right"),
        ),
        "double",
    ),
    "SQK-LWB001",
    "SQK-PBK004",
    "SQK-PCB109",
    "SQK-PCB110",
)

_register(
    KitSpec(
        "LWB24",
        (
            _tmpl(LWB_1ST_FRONT, LWB_1ST_REAR, LabelRange("BC01", "BC24"), "left"),
            _tmpl(LWB_2ND_FRONT, LWB_2ND_REAR, LabelRange("BC01", "BC24"), "right"),
        ),
        "double",
    ),
    "SQK-PCB111-24",
    "SQK-PCB114-24",
)

_register(
    KitSpec(
        "NB12",
        (_tmpl(NB_1ST_FRONT, NB_1ST_REAR, LabelRange("NB01", "NB12"), "left"),),
        "single",
    ),
    "EXP-NBD103",
    "EXP-NBD104",
)

_register(
    KitSpec(
        "NB13-24",
        (_tmpl(NB_1ST_FRONT, NB_1ST_REAR, LabelRange("NB13", "NB24"), "left"),),
        "single",
    ),
    "EXP-NBD114",
)

# NB24/NB96 use the double pattern presets in the reference even though
# they carry a single-side template (native kits can have inner pairs).
_register(
    KitSpec(
        "NB24",
        (_tmpl(NB_1ST_FRONT, NB_1ST_REAR, LabelRange("NB01", "NB24"), "left"),),
        "double",
    ),
    "SQK-NBD111-24",
    "SQK-NBD114-24",
    "EXP-NBD114-24",
)

_register(
    KitSpec(
        "NB96",
        (_tmpl(NB_1ST_FRONT, NB_1ST_REAR, LabelRange("NB01", "NB96"), "left"),),
        "double",
    ),
    "SQK-HTB114-96",
    "EXP-NBD196",
    "SQK-MLK111-96-XL",
    "SQK-NBD111-96",
    "SQK-NBD114-96",
    "SQK-MLK114-96-XL",
)

_register(
    KitSpec(
        "PCR12",
        (
            _tmpl(BC_1ST_FRONT, BC_1ST_REAR, LabelRange("BC01", "BC12"), "left"),
            _tmpl(BC_2ND_FRONT, BC_2ND_REAR, LabelRange("BC01", "BC12"), "right"),
        ),
        "double",
    ),
    "EXP-PBC001",
)

_register(
    KitSpec(
        "PCR96",
        (
            _tmpl(BC_1ST_FRONT, BC_1ST_REAR, LabelRange("BC01", "BC96"), "left"),
            _tmpl(BC_2ND_FRONT, BC_2ND_REAR, LabelRange("BC01", "BC96"), "right"),
        ),
        "double",
    ),
    "EXP-PBC096",
)

_register(
    KitSpec(
        "RAB",
        (
            _tmpl(RAB_1ST_FRONT, RAB_1ST_REAR, LabelRange("BC01", "BC12"), "left"),
            _tmpl(RAB_2ND_FRONT, RAB_2ND_REAR, LabelRange("BC01", "BC12"), "right"),
        ),
        "double",
    ),
    "SQK-RAB204",
    "SQK-RAB201",
)

_register(
    KitSpec(
        "RBK",
        (_tmpl(RBK_FRONT, RBK_REAR, LabelRange("BC01", "BC12"), "left"),),
        "single",
    ),
    "SQK-RBK001",
)

_register(
    KitSpec(
        "RBK96",
        (_tmpl(RBK4_FRONT, RBK4_REAR, LabelRange("RBK01", "RBK96"), "left"),),
        "single",
    ),
    "SQK-RBK110-96",
    "SQK-RBK111-96",
)

_register(
    KitSpec(
        "RBK096_kit14",
        (
            _tmpl(RBK4_KIT14_FRONT, RBK4_KIT14_REAR, LabelRange("RBK01", "RBK96"), "left"),
            # Fusion constructs: rear..bar..rear concatenations.
            _tmpl(RBK4_FRONT_FUSION, RBK4_REAR, LabelRange("RBK01", "RBK96"), "left", extended=True),
        ),
        "single",
    ),
    "SQK-RBK114-96",
)

_register(
    KitSpec(
        "RBK24",
        (_tmpl(RBK4_FRONT, RBK4_REAR, LabelRange("RBK01", "RBK24"), "left"),),
        "single",
    ),
    "SQK-RBK111-24",
)

_register(
    KitSpec(
        "RBK24_kit14",
        (_tmpl(RBK4_KIT14_FRONT, RBK4_KIT14_REAR, LabelRange("RBK01", "RBK24"), "left"),),
        "single",
    ),
    "SQK-RBK114-24",
)

_register(
    KitSpec(
        "RBK4",
        (_tmpl(RBK4_FRONT, RBK4_REAR, LabelRange("BC01", "BC12"), "left"),),
        "single",
    ),
    "SQK-RBK004",
    "VSK-PTC001",
    "VSK-VPS001",
)

_register(
    KitSpec(
        "RLB",
        (_tmpl(RLB_FRONT, RLB_REAR, LabelRange("BC01", "BC12", use_12a=True), "left"),),
        "single",
    ),
    "SQK-RPB004",
    "SQK-RLB001",
)

_register(
    KitSpec(
        "RPB24-Kit14",
        (_tmpl(RLB_FRONT, RLB_REAR, LabelRange("BC01", "BC24", use_12a=True), "left"),),
        "double",
    ),
    "SQK-RPB114-24",
)

_register(
    KitSpec(
        "VMK",
        (_tmpl(RBK_FRONT, RBK_REAR, LabelRange("BC01", "BC04"), "left"),),
        "single",
    ),
    "VSK-VMK001",
)

_register(
    KitSpec(
        "VMK4",
        (_tmpl(RBK4_FRONT, RBK4_REAR, LabelRange("BC01", "BC10"), "left"),),
        "single",
    ),
    "VSK-VMK004",
)

_register(
    KitSpec(
        "MAB",
        (_tmpl(MAB_FRONT, MAB_REAR, LabelRange("AB01", "AB24"), "left"),),
        "single",
    ),
    "SQK-MAB114-24",
)


def supported_kits() -> List[str]:
    return sorted(_KITS)


def get_kit_info(kit: str) -> KitSpec:
    """Look up a kit by alias; '.'-separated names are retried with '-'."""
    spec = _KITS.get(kit)
    if spec is not None:
        return spec
    if "." in kit:
        fixed = kit.replace(".", "-")
        print(
            f"Your kit name used '.' ({kit}) instead of '-'; "
            f"replaced it with {fixed} and trying again"
        )
        return get_kit_info(fixed)
    raise KeyError(f"Unknown or unsupported kit: {kit}, please raise an issue")


def expand_template(tmpl: TemplateSpec) -> Tuple[List[str], List[str]]:
    """(labels, sequences) for one template's barcode range."""
    labels = get_barcodes(tmpl.barcodes.from_label, tmpl.barcodes.to_label, tmpl.barcodes.use_12a)
    seqs = []
    for label in labels:
        seq = lookup_barcode_seq(label)
        if seq is None:
            raise KeyError(f"Barcode not found for label {label!r}")
        parts = [
            seq if part in ("{BAR}", "**") else part for part in tmpl.parts
        ]
        seqs.append("".join(parts))
    return labels, seqs
