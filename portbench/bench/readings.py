"""The readings that a cell's limits are set from, many seeds in one
process: for each seed the program's numbers after a short window at the
cell's own load (as many calls as the pool has batches, so that every
sampled batch is one the window drove), and with --control the same
numbers of the control, the reference in TF32 in the program's place;
with --faults, those of one call on the pool's first batch with each
fault of bench/faults.py planted in the program; with --witness, those of
the reference in float32 (TF32 off), on one sampled batch.

    python3 portbench/bench/readings.py --workload <cell> --seeds 1,2,3 [--control]
        [--faults answer,match,unchanged,half]

One JSON line per seed and side; the card is required.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.bench import faults as faults_mod  # noqa: E402
from portbench.bench import harness  # noqa: E402


def readings(workload: str, seeds, control: bool, faults=(), witness: bool = False,
             out=sys.stdout):
    import importlib

    import torch

    if not torch.cuda.is_available():
        harness.fail("readings need the card", 2)
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    parts = harness.cell_parts(manifest, workload)
    harness.cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = bool(parts["config"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(parts["config"]["tf32"])
    driver = importlib.import_module(f"portbench.bench.{parts['traffic']['driver']}")
    rows = []
    for seed in seeds:
        ctx = SimpleNamespace(root=harness.ROOT, config=parts["config"],
                              traffic=parts["traffic"], seed=seed,
                              device=torch.device("cuda", 0))
        t0 = time.perf_counter()
        cell = driver.Cell(ctx)
        for i in range(parts["traffic"]["pool"]):
            cell.call(i)
        planted = {}
        for name in faults:
            with faults_mod.planted(name):
                cell.call(0)
            _, answers, codes = cell.outs.pop()
            planted[name] = driver.program_view(answers, codes)
        row = {"workload": workload, "seed": seed, "side": "program",
               **cell.check(), "seconds": time.perf_counter() - t0}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        if planted:
            want = cell.reference(0, dtype=torch.float64)
            for name, got in planted.items():
                row = {"workload": workload, "seed": seed, "side": f"fault:{name}",
                       **driver.compare([(got, want)])}
                print(json.dumps(row), file=out, flush=True)
                rows.append(row)
        if witness:
            # the reference in float32 against the float64 one: what float32
            # itself loses on these weights and scenes
            b, answers, codes = cell.sample()[0]
            exact = cell.reference(b, dtype=torch.float64)
            for side, got in (("witness:reference32", cell.reference(b)),):
                row = {"workload": workload, "seed": seed, "side": side,
                       **driver.compare([(got, exact)])}
                print(json.dumps(row), file=out, flush=True)
                rows.append(row)
        if control:
            t0 = time.perf_counter()
            row = {"workload": workload, "seed": seed, "side": "control",
                   **cell.control(), "seconds": time.perf_counter() - t0}
            print(json.dumps(row), file=out, flush=True)
            rows.append(row)
        del cell
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="", help="comma-separated names of bench/faults.py")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference in float32 in the program's place")
    a = ap.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.control,
             [f for f in a.faults.split(",") if f], a.witness)
