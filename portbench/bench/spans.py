"""The program's own trace of a traced run (livingscenes_tpu_torch/tracing.py),
for the per-layer metrics that read its spans and counters. The program
records while torch.profiler runs, so the traced calls are its spans.

`snapshot()` is None where the program has no recorder (a checkout older
than it) or recorded no span, so that those metrics are left out of the
line rather than raise.
"""
from __future__ import annotations


def snapshot():
    try:
        from livingscenes_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    return snap if snap["spans"] else None


def named(snap: dict, name: str) -> list:
    return [s for s in snap["spans"] if s["name"] == name]

