"""Card ms a call from the stream reaching the program's span
"pipeline.encode" (the front end's FPS and both encodes) to its finishing
it, idle time inside included, from the program's own CUDA events, which
add no sync."""
from portbench.bench import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None:
        return None
    own = spans.named(snap, "pipeline.encode")
    if not own or any(s["device_end_ms"] is None for s in own):
        return None
    return sum(s["device_end_ms"] - s["device_start_ms"] for s in own) / ctx.calls
