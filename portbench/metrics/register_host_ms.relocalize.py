"""Host ms a call inside the program's spans "solver.match" and
"solver.register": the cost of issuing registration's work. Where it is
close to register_wall_ms, the host paces the stage."""
from portbench.bench import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None:
        return None
    own = spans.named(snap, "solver.match") + spans.named(snap, "solver.register")
    if not own or any(s["host_end_ms"] is None for s in own):
        return None
    return sum(s["host_end_ms"] - s["host_start_ms"] for s in own) / ctx.calls
