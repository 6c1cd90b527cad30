"""Seconds from the start of the timed call to the first byte of
``annotation.tsv``: the engine's construction, its deep-tier warm-up, the
first batch and its graph captures."""


def read(ctx):
    return ctx.get("first_output_s")
