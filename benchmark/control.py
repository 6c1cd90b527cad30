"""The control of the comparison: the plain reference put in the program's
place with one stated precision lowered, judged by a run's own comparison
(``compare.judge``): ``int16`` edit-cost tables (below the configuration's
int32), or ``bfloat16`` Lodhi scores (below its float32).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--passes P] [--sample N]

For each seed it makes the cell's pool, computes the control's output
records for the seed's sample (its first ``--sample`` reads, where
given) and hands them to the comparison as the digester hands a run's:
every record of every sampled read in each of ``--passes`` passes, in
feed order.  It prints one JSON line per seed and precision, with
``correct`` and each compared number beside its limit, as a run's
result line has them.  No card needed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare as cmp  # noqa: E402
from benchmark import traffic  # noqa: E402
from benchmark.cells import load_cell  # noqa: E402
from benchmark.reference.kit import ID  # noqa: E402


def as_digested(pool, outputs: dict, passes: int):
    """(kept, orders, reads fed): ``outputs`` (pool index -> {file: records})
    written for ``passes`` whole passes of the pool, as the digester keeps
    them."""
    kept, orders = {}, {}
    for p in range(passes):
        for i in sorted(outputs):
            rid = cmp.record_id(pool, p, i)
            for f, recs in outputs[i].items():
                kept[(f, p, i)] = [r.replace(ID, rid) for r in recs]
                orders.setdefault(f, []).append((p, i))
    return kept, list(orders.values()), passes * len(pool)


def control_reading(cell, seed: int, precision: str, workers: int = 0, sample=None,
                    passes: int = 1) -> dict:
    pool = traffic.make_pool(cell.config, cell.traffic, seed)
    if sample is not None:
        pool.sample = pool.sample[:sample]
    full = bool(cell.run_options.get("full_scan"))
    w = workers or cmp.default_workers()
    t = time.monotonic()
    low = cmp.reference_outputs(pool, cell.config, full, precision, w)
    kept, orders, fed = as_digested(pool, low, passes)
    j = cmp.judge(pool, cell.config, full, kept, orders, fed, w)
    return {"workload": cell.name, "seed": seed, "precision": precision,
            "sample_reads": len(pool.sample), "passes": passes,
            "correct": j["correct"], "compared_read_instances": j["compared"],
            "seconds": time.monotonic() - t,
            "compared": {k: {"value": v, "limit": lim} for k, (v, lim) in j["numbers"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--sample", type=int, default=None,
                    help="compare only the first N reads of the seed's sample")
    ap.add_argument("--precision", choices=("bfloat16", "int16"), nargs="+",
                    default=["int16", "bfloat16"])
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    for prec in a.precision:
        for seed in a.seeds:
            r = control_reading(cell, seed, prec, sample=a.sample, passes=a.passes)
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
