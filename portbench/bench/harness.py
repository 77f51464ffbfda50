"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration's file, its traffic mix in traffic/<mix>.json (whose
"driver" names the module of bench/ that drives that kind of traffic), its
limits in limits/<cell>.json, and each per-layer metric's reader in
metrics/<metric>.py.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
PROGRAM = "livingscenes_tpu_torch"
# top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package the port was made from
FORBIDDEN = {"jax", "jaxlib", "flax", "livingscenes_tpu"}


def fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name, compared whole, is
    forbidden."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_parts(manifest: dict, name: str) -> dict:
    """The cell's entry, its configuration's entry and file, its traffic
    mix and its limits."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json", 2)
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return {"cell": cell, "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def end_to_end(manifest: dict, name: str) -> list:
    return [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]


def per_layer(manifest: dict, name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, name)}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def read_metric(name: str, ctx):
    """The value of per-layer metric `name` from its reader, or None."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds. The port builds its kernels
    into livingscenes_tpu_torch/_build/ by itself."""
    cache = BENCH / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None, t0: float | None = None):
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / PROGRAM / "__init__.py").is_file():
        fail(f"the program {PROGRAM}/ is not in {ROOT}", 3)
    manifest = load_json(ROOT / "BENCHMARK.json")
    parts = cell_parts(manifest, args.workload)
    cell = parts["cell"]
    cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", 2)
    torch.backends.cuda.matmul.allow_tf32 = bool(parts["config"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(parts["config"]["tf32"])
    ctx = SimpleNamespace(root=ROOT, config=parts["config"], traffic=parts["traffic"],
                          seed=args.seed, device=torch.device("cuda", 0))
    line, numbers = execute(manifest, parts, ctx, args.seconds, args.trace, t0)
    found = forbidden_modules(sys.modules)
    if found:
        fail(f"forbidden modules loaded in this run: {', '.join(found)}", 4)
    print(f"portbench: card {power_limit()}; setup_s {line['setup_s']:.3f}; "
          f"other numbers {json.dumps(numbers)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    del line["setup_s"]
    print(json.dumps(line), flush=True)


def execute(manifest: dict, parts: dict, ctx, seconds: float, trace: int, t0: float):
    """Set-up, the window (trace 0) or the traced calls (trace 1), and the
    comparison, on ctx.device: (the result line, with "setup_s" beside it,
    and every number the comparison made)."""
    import torch

    cell = parts["cell"]
    cuda = ctx.device.type == "cuda"
    driver = importlib.import_module(f"portbench.bench.{parts['traffic']['driver']}")
    run = driver.Cell(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    device = {"platform": "gpu" if cuda else ctx.device.type,
              "kind": torch.cuda.get_device_name(0) if cuda else ctx.device.type,
              "count": cell["chips"]}
    result = {}
    if trace:
        tctx = run.traced()
        metrics = {}
        for m in per_layer(manifest, cell["name"]):
            value = read_metric(m["name"], tctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=tctx.trace.busy_s, window_s=tctx.trace.window_s)
        result["breakdown"] = tctx.trace.breakdown
    else:
        values = dict(run.window(seconds), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end(manifest, cell["name"])}
        print(f"portbench: window {json.dumps(values)}", file=sys.stderr)
    device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(0) if cuda else 0

    numbers = run.check()
    compared = {k: {"value": numbers[k], "limit": limit}
                for k, limit in parts["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    line = {"correct": correct, "attempted": run.attempted, "failed": 0,
            "metrics": metrics, "device": device, **result, "checks": compared}
    return dict(line, setup_s=setup_s), numbers
