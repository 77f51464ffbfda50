"""Device ms per call of the kernels that ran in the 'encode' stage (the
front end's FPS and both encodes), from the profiler."""


def read(ctx):
    st = ctx.trace.stage("encode")
    return None if st is None or not st["device_s"] else st["device_s"] / ctx.calls * 1e3
