"""Share, %, of the ICP pair-iterations run in which the pair was not yet
frozen: the ICP statistics' work spent on pairs still moving, from the
program's ICP counters (a frozen pair is carried through every later
iteration unchanged)."""
from portbench.bench import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None or not snap["counters"].get("icp.pair_iterations"):
        return None
    c = snap["counters"]
    return 100.0 * c["icp.active_pair_iterations"] / c["icp.pair_iterations"]
