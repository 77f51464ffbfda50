"""The mean over ICP calls of the iteration after which no pair of the
call was active, from the program's ICP counters: below the iterations
run, stopping once every pair is frozen (`early_exit`) has that much to
save, with the same answer."""
from portbench.bench import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None or not snap["counters"].get("icp.calls"):
        return None
    return snap["counters"]["icp.iters_needed"] / snap["counters"]["icp.calls"]
