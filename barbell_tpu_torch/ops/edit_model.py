"""Automatic flank edit-distance threshold.

Paper formula on the combined flank (prefix+suffix) length L:
``k = ceil(0.5100 * L - 1.7312 * sqrt(L))``, clamped at 0.
Reference `src/annotate/edit_model.rs:1-11`.
"""

import math


def get_edit_cut_off(length: int) -> int:
    value = 0.5100 * length - 1.7312 * math.sqrt(length)
    ceil_value = math.ceil(value)
    return ceil_value if ceil_value > 0 else 0
