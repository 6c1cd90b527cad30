"""Wall seconds of CUDA graph captures inside the timed call (the span
``graph.capture``: a capture's eager call and the capture,
``BARBELL_TIMING=1``); 0.0 where device calls ran and none captured."""


def read(ctx):
    t = ctx["timings"]
    acc = t.get("graph.capture")
    if acc:
        return acc[0]
    disp = t.get("demux_call.dispatch")
    # the recorder that times captures gives its spans thread CPU
    if disp and len(disp) > 2 and disp[1]:
        return 0.0
    return None
