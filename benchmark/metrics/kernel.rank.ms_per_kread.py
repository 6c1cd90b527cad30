"""Device milliseconds of the barcode rank kernel (csrc/rank.cu,
``rank_kernel``) per 1000 reads fed, from the profiler trace."""

import re

KERNEL = re.compile(r"^rank_kernel$")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["reads"]:
        return None
    ms = 1000 * sum(s for name, s in tr.device_s.items() if KERNEL.match(name))
    return ms / (ctx["reads"] / 1000) if ms > 0 else None
