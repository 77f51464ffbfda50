"""Card ms a call from the stream reaching the program's span
"solver.match" to its finishing "solver.register" (matcher, Kabsch, ICP
and its acceptance), from the program's own events."""
from portbench.bench import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None:
        return None
    starts = {s["call"]: s["device_start_ms"] for s in spans.named(snap, "solver.match")}
    ends = {s["call"]: s["device_end_ms"] for s in spans.named(snap, "solver.register")}
    if not starts or set(starts) != set(ends) or None in (*starts.values(), *ends.values()):
        return None
    return sum(ends[c] - starts[c] for c in starts) / ctx.calls
