"""The 'encode' stage's share of its roofline, %: the least time of the
stage's operations and bytes (counted from the configuration's shapes by
counts/encoder.py) over the device time its kernels took."""


def read(ctx):
    st = ctx.trace.stage("encode")
    if st is None or not st["device_s"]:
        return None
    return 100.0 * ctx.encode_least_s * ctx.calls / st["device_s"]
