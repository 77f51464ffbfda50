"""Host ms per call of the 'register' stage (matcher, Kabsch, ICP and its
acceptance), the card synchronised at both ends."""


def read(ctx):
    st = ctx.trace.stage("register")
    return None if st is None else st["host_s"] / ctx.calls * 1e3
