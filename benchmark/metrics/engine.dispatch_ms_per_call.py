"""Milliseconds of host time a fused device call's dispatch takes
(``BARBELL_TIMING=1`` phase ``demux_call.dispatch``: its seconds over its
count): the upload into the captured graph's inputs and its replay."""


def read(ctx):
    acc = ctx["timings"].get("demux_call.dispatch")
    if not acc or not acc[1]:
        return None
    return 1000 * acc[0] / acc[1]
