"""Device launches per call of the 'register' stage, from the profiler
(whose kernel counts the traced run holds to the launch counters)."""


def read(ctx):
    st = ctx.trace.stage("register")
    return None if st is None or not st["launches"] else st["launches"] / ctx.calls
