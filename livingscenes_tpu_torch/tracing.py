"""The port's program trace: named spans at the layer boundaries of a call
and host counters, kept in memory.

    with tracing.recording():
        out = pipeline(ref_pc, rescan_pc, ref_mask, rescan_mask)
    snap = tracing.snapshot()   # {"spans": [...], "counters": {...}}

The recorder is on inside `recording()` and while a torch profiler is
recording (torch's module-level flag
`torch.autograd.profiler._is_profiler_enabled`), so a profiled run gets the
spans without asking for them. Off, `span` returns one shared no-op context
and `count` returns at once: no allocation, no CUDA call, no sync.

On, a span appends a record: its name, the enclosing span (a thread-local
stack), the id of its top-level call, which every span inside one call
shares, and its host start and end on `time.perf_counter_ns()`. On a CUDA
device it also records two timing events on the current stream, one at
enter and one at exit, and never waits on them. `snapshot()` synchronises
once and maps every event onto the host clock through one reference event,
so that host and device times are on one clock.

A span is not a profiler range: a `record_function` range leaves a span of
its own on the device timeline, around the kernels launched inside it,
which a reader of the profiler's device events would count as device work.
Only `recording(ranges=True)` opens one per span, for a chrome trace that
shows the spans on the profiler's own clock (utils/debugging.profile_trace).

The spans of a scene-pair pipeline call (solver/pipeline.py):

    pipeline.call                 one call of the pipeline
      pipeline.encode             the front end and the encoder
        pipeline.fps              the front end's FPS launch (encode_fps)
      solver.match                solver/matcher.py sequential_matcher
      solver.register             solver/registration.py solve_pairwise_registration
        register.kabsch, register.refine (optim), register.icp, register.accept
      pipeline.recon              the grids (recon)

Counters. ICP (ops/icp.py) counts "icp.iterations" and "icp.pair_iterations"
(pairs x iterations run) on the host, and hands the recorder the `frozen`
flags that each iteration starts with (`icp_frozen_log`), which the loop
makes anyway. From those the snapshot derives "icp.calls",
"icp.active_pair_iterations" (the pair-iterations of pairs not yet frozen)
and "icp.iters_needed": summed over ICP calls, the iteration after which
no pair of the call was active, which is the largest number of active
iterations of a pair, since a frozen pair never thaws.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_NOOP = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.depth = 0  # open recording() blocks
        self.ranges = 0  # of which asked for profiler ranges
        self.clear()

    def clear(self):
        self.spans = []  # span records, in the order they were entered
        self.counters = {}
        self.icp = []  # per ICP call, the frozen flags (B,) of each iteration
        self.call_ids = itertools.count()
        self.changes = 0  # records made, for snapshot()'s cache
        self.cached = None  # (changes, snapshot)


_state = _State()
_lock = threading.Lock()  # over the counters and `changes`
_local = threading.local()


def on() -> bool:
    """Whether spans and counts are being recorded."""
    return bool(_state.depth) or _profiler._is_profiler_enabled


def _changed():
    with _lock:
        _state.changes += 1


class _Span:
    __slots__ = ("rec", "range")

    def __init__(self, name, device):
        self.rec = {"name": name, "device": device}
        self.range = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        parent = stack[-1] if stack else None
        rec["parent"] = parent
        rec["call"] = next(_state.call_ids) if parent is None else parent["call"]
        if rec["device"] is not None:
            rec["device"] = torch.device(rec["device"])
        elif parent is not None:
            rec["device"] = parent["device"]
        if _state.ranges:
            self.range = torch.profiler.record_function(rec["name"])
            self.range.__enter__()
        rec["host"] = [time.perf_counter_ns(), None]
        rec["events"] = [_marker(rec["device"]), None]
        stack.append(rec)
        _state.spans.append(rec)
        _changed()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["events"][1] = _marker(rec["device"])
        rec["host"][1] = time.perf_counter_ns()
        _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        _changed()
        return False


def _marker(device):
    """A timing event recorded now on the device's current stream; None
    off a CUDA device."""
    if device is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def span(name: str, device=None):
    """A context that records the block as the span `name`; `device` (the
    enclosing span's when None) is where its work runs, timed by events
    when it is a CUDA device."""
    if not on():
        return _NOOP
    return _Span(name, device)


def count(name: str, n: int = 1):
    """Add n to the host counter `name`."""
    if on():
        with _lock:
            _state.counters[name] = _state.counters.get(name, 0) + int(n)
            _state.changes += 1


def icp_frozen_log():
    """A list, kept by the recorder, to which an ICP call appends the
    `frozen` flags (B,) that each of its iterations starts with; None
    when the recorder is off."""
    if not on():
        return None
    log = []
    _state.icp.append(log)
    _changed()
    return log


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record inside the block; with `ranges` also open a profiler range
    named after each span."""
    _state.depth += 1
    _state.ranges += int(ranges)
    try:
        yield
    finally:
        _state.depth -= 1
        _state.ranges -= int(ranges)


def reset():
    """Drop every span, counter and ICP log recorded."""
    with _lock:
        _state.clear()


def _device_clock(spans) -> dict:
    """Per CUDA device of the spans, (reference event, its host time in
    ns): the device synchronised, then one event recorded on its idle
    current stream, with the middle of the host clock's readings around
    the record."""
    refs = {}
    for dev in {r["device"] for r in spans if r["events"][0] is not None}:
        torch.cuda.synchronize(dev)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(torch.cuda.current_stream(dev))
        t1 = time.perf_counter_ns()
        ev.synchronize()
        refs[dev] = (ev, (t0 + t1) / 2)
    return refs


def snapshot() -> dict:
    """The spans and counters recorded so far:

      spans     [{name, parent (index into spans, or None), call,
                  host_start_ms, host_end_ms, device_start_ms,
                  device_end_ms}], every time in ms on the host's
                  perf_counter clock; the device's are when the stream
                  reached the span's enter and exit (None off a CUDA
                  device, and the ends None while a span is open)
      counters  {name: int}, with the ICP figures derived from the logs

    Synchronises each CUDA device that the spans ran on; the same dict is
    returned until something new is recorded."""
    with _lock:
        changes = _state.changes
        if _state.cached is not None and _state.cached[0] == changes:
            return _state.cached[1]
        spans, counters, logs = list(_state.spans), dict(_state.counters), list(_state.icp)
    refs = _device_clock(spans)
    index = {id(r): i for i, r in enumerate(spans)}

    def on_host(ev, dev):
        if ev is None:
            return None
        ref, host_ns = refs[dev]
        return (host_ns - ev.elapsed_time(ref) * 1e6) / 1e6

    out = []
    for r in spans:
        h0, h1 = r["host"]
        e0, e1 = r["events"]
        out.append({"name": r["name"],
                    "parent": None if r["parent"] is None else index.get(id(r["parent"])),
                    "call": r["call"],
                    "host_start_ms": h0 / 1e6,
                    "host_end_ms": None if h1 is None else h1 / 1e6,
                    "device_start_ms": on_host(e0, r["device"]),
                    "device_end_ms": on_host(e1, r["device"])})
    counters["icp.calls"] = len(logs)
    counters["icp.active_pair_iterations"] = 0
    counters["icp.iters_needed"] = 0
    for log in logs:
        if log:
            active = torch.logical_not(torch.stack(log)).sum(0)  # (B,)
            counters["icp.active_pair_iterations"] += int(active.sum())
            counters["icp.iters_needed"] += int(active.max())
    snap = {"spans": out, "counters": counters}
    with _lock:
        _state.cached = (changes, snap)
    return snap
