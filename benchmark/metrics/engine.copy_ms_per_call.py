"""Wall milliseconds of the engine's copies a device call: the span
``upload.copy`` (the host-to-device copies alone) plus
``demux_call.fetch`` (the copy back, which waits for the device), over
the count of ``demux_call.dispatch`` (``BARBELL_TIMING=1``)."""


def read(ctx):
    t = ctx["timings"]
    up, disp = t.get("upload.copy"), t.get("demux_call.dispatch")
    if not up or not disp or not disp[1]:
        return None
    fetch = t.get("demux_call.fetch", (0.0,))[0]
    return 1000 * (up[0] + fetch) / disp[1]
