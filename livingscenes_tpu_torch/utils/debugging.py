"""Finite-value checks and profiling helpers.

Counterpart of livingscenes_tpu/utils/debugging.py in PyTorch's idiom:

* `locate_nonfinite_modules` names the submodules whose forward gives a
  NaN or Inf, by forward hooks on every named submodule, the mechanism of
  the reference's --anomaly mode (core/solver_utils.py:5-54), where JAX
  uses a flax method interceptor; `nonfinite_parameters` names the
  parameters that hold one;
* `checkify_nan` wraps a function so that a non-finite output raises;
* `assert_finite` logs the non-finite leaves of a nest of tensors;
* `profile_trace` runs a block under torch.profiler (a chrome trace in a
  directory, with the program trace's spans as profiler ranges and written
  out beside it) or times it;
* `device_memory_stats` reads torch.cuda.memory_stats per card.

Named phases are timed by the program trace's spans (tracing.py).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, Dict, List

import torch

from .. import tracing

log = logging.getLogger(__name__)


def _tensor_leaves(tree, path: str = ""):
    """(path, tensor) of each floating-point tensor in a nest of dicts,
    lists and tuples."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() or tree.is_complex():
            yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, f"{path}/{i}" if path else str(i))


def _all_finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for _, t in _tensor_leaves(tree))


def locate_nonfinite_modules(module: torch.nn.Module, *args, **kwargs):
    """Run module(*args, **kwargs) with a forward hook on every named
    submodule; returns (output, bad), bad listing "path:Type" for each
    submodule whose output holds a NaN or Inf, in the order they returned
    (a module after the submodules it called; the root is "<root>"). A
    submodule whose parameters are read by a function rather than called
    (the fused edge layers' weights) has no output to check: see
    `nonfinite_parameters`. Debug only: each check reads the device."""
    bad: List[str] = []

    def hook(name):
        def check(mod, inputs, output):
            if not _all_finite(output):
                bad.append(f"{name or '<root>'}:{type(mod).__name__}")
        return check

    handles = [m.register_forward_hook(hook(name)) for name, m in module.named_modules()]
    try:
        out = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, bad


def nonfinite_parameters(module: torch.nn.Module) -> List[str]:
    """The names of the module's parameters that hold a NaN or Inf."""
    return [name for name, p in module.named_parameters()
            if not bool(torch.isfinite(p).all())]


def checkify_nan(fn: Callable) -> Callable:
    """fn wrapped so that a NaN or Inf in any floating-point tensor of its
    output raises FloatingPointError naming where it lies:

        safe_step = checkify_nan(step)
        out = safe_step(batch)   # raises on a non-finite output
    """
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [p or "<output>" for p, t in _tensor_leaves(out)
               if not bool(torch.isfinite(t).all())]
        if bad:
            raise FloatingPointError(
                f"{getattr(fn, '__name__', 'function')}: non-finite values in {bad}")
        return out

    return wrapper


def assert_finite(tree, name: str = "tree") -> List[str]:
    """Log an error for each non-finite tensor of a nest of tensors;
    returns their paths."""
    bad = [p for p, t in _tensor_leaves(tree) if not bool(torch.isfinite(t).all())]
    for p in bad:
        log.error("non-finite values in %s/%s", name, p)
    return bad


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None, label: str = "trace"):
    """With a log_dir, the block runs under torch.profiler (CPU, and the
    card when there is one) with the program trace recording and each of
    its spans opened as a profiler range (tracing.recording(ranges=True),
    after a tracing.reset()); the chrome trace is written to
    <log_dir>/<label>.json and tracing.snapshot() to
    <log_dir>/<label>.spans.json. Either way its wall time is logged."""
    t0 = time.perf_counter()
    if log_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        tracing.reset()
        with tracing.recording(ranges=True), profile(activities=activities) as prof:
            yield
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{label}.json"))
        with open(os.path.join(log_dir, f"{label}.spans.json"), "w") as f:
            json.dump(tracing.snapshot(), f)
    else:
        yield
    log.info("[profile] %s: %.3fs", label, time.perf_counter() - t0)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per card: the bytes the allocator holds for tensors, their peak
    (torch.cuda.memory_stats) and the card's memory; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out

