"""Device milliseconds of the port's own kernels (the Myers flank scan,
the window DP in its three modes and the barcode rank; csrc/myers.cu,
window.cu, rank.cu) per 1000 reads fed, from the profiler trace; the
kernels are matched by the names the trace prints."""

import re

KERNEL = re.compile(r"^(myers_kernel|window_kernel|rank_kernel)$")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx["reads"]:
        return None
    ms = 1000 * sum(s for name, s in tr.device_s.items() if KERNEL.match(name))
    return ms / (ctx["reads"] / 1000) if ms > 0 else None
