"""The traced run: the benchmark's own stage spans around the calls into
the program's layers, and what torch.profiler saw on the card under them.

A stage is a `record_function` range named "portbench.<stage>" that the
driver opens and closes around a call into a layer, with the card
synchronised at both ends; so every kernel that ran between its ends is
the stage's, and its host duration is the stage's wall time. The whole
traced window is the range "portbench.window".
"""
from __future__ import annotations

import bisect
import collections

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


class Stage:
    """An open stage span: enter() syncs the card and opens the range,
    exit() syncs and closes it."""

    def __init__(self, name: str):
        self.name = PREFIX + name
        self.rf = None

    def enter(self):
        torch.cuda.synchronize()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()

    def exit(self):
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.rf = None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Trace:
    """What one profiled window holds: the window's length, the device's
    busy time, and per stage its host seconds, device seconds, launches
    and kernel names; `breakdown` for the result line."""

    def __init__(self, prof, calls: int):
        self.calls = calls
        events = list(prof.events())
        dev = torch.autograd.DeviceType.CUDA
        host = [e for e in events if e.device_type != dev]
        window = [e for e in host if e.name == WINDOW]
        if len(window) != 1:
            raise RuntimeError(f"the trace holds {len(window)} window spans, not one")
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        self.window_s = (w1 - w0) / 1e6
        self.device = [e for e in events if e.device_type == dev
                       and not e.name.startswith(PREFIX)
                       and w0 <= e.time_range.start and e.time_range.end <= w1]
        if not self.device:
            raise RuntimeError("the profiler saw no device activity in the window")
        spans = [e for e in host if e.name.startswith(PREFIX) and e.name != WINDOW]
        self.stages = {}
        starts = sorted(e.time_range.start for e in self.device)
        by_start = sorted(self.device, key=lambda e: e.time_range.start)
        for span in spans:
            name = span.name[len(PREFIX):]
            st = self.stages.setdefault(name, {"host_s": 0.0, "device_s": 0.0,
                                               "launches": 0, "spans": 0,
                                               "kernels": collections.Counter()})
            lo = bisect.bisect_left(starts, span.time_range.start)
            hi = bisect.bisect_right(starts, span.time_range.end)
            st["host_s"] += span.time_range.elapsed_us() / 1e6
            st["spans"] += 1
            for e in by_start[lo:hi]:
                st["device_s"] += e.time_range.elapsed_us() / 1e6
                if not is_copy(e.name):
                    st["launches"] += 1
                    st["kernels"][e.name] += 1
        self.kernel_counts = collections.Counter(
            e.name for e in self.device if not is_copy(e.name))
        self.busy_s, gaps = _busy_and_gaps(self.device, w0, w1)
        self.breakdown = {"device_ops": self._top_ops(),
                          "idle_gaps": _label_gaps(gaps, host, spans)}

    def _top_ops(self):
        total = collections.Counter()
        for e in self.device:
            total[e.name] += e.time_range.elapsed_us() / 1e6
        return [[name[:120], s] for name, s in total.most_common(10)]

    def stage(self, name: str):
        return self.stages.get(name)

    def count_kernels(self, part: str) -> int:
        """Launches in the window of kernels whose name holds `part`."""
        return sum(n for k, n in self.kernel_counts.items() if part in k)


def _busy_and_gaps(device, w0, w1):
    """Seconds in which some device activity ran, and the idle gaps
    [(start_us, end_us)] between activities inside [w0, w1]."""
    busy, gaps, edge = 0.0, [], w0
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if s > edge:
            gaps.append((edge, s))
        if t > edge:
            busy += t - max(s, edge)
            edge = t
    if w1 > edge:
        gaps.append((edge, w1))
    return busy / 1e6, gaps


def _label_gaps(gaps, host, spans, longest: int = 400):
    """The idle time of the `longest` gaps, summed by what the host was
    doing at each gap's middle ("<stage>: <innermost host op>"), the ten
    largest sums as [[label, seconds], ...]."""
    ops = sorted((e for e in host if not e.name.startswith(PREFIX)),
                 key=lambda e: e.time_range.start)
    op_starts = [e.time_range.start for e in ops]
    totals = collections.Counter()
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = (s + t) / 2
        stage = next((sp.name[len(PREFIX):] for sp in spans
                      if sp.time_range.start <= mid <= sp.time_range.end), "between stages")
        inner, width = "idle host", float("inf")
        i = bisect.bisect_right(op_starts, mid)
        for e in ops[max(0, i - 2000):i]:
            if e.time_range.end >= mid and e.time_range.end - e.time_range.start < width:
                inner, width = e.name, e.time_range.end - e.time_range.start
        totals[f"{stage}: {inner[:80]}"] += (t - s) / 1e6
    return [[k, v] for k, v in totals.most_common(10)]
