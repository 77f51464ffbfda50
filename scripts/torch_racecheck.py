#!/usr/bin/env python3
"""Run compute-sanitizer's racecheck and synccheck over the port's CUDA
kernels at the small shapes of chip_smoke.py's phase_small_shapes, on one
card.

    python3 scripts/torch_racecheck.py [--out REPORT.json]
        [--tools racecheck synccheck] [--timeout 900]

The kernels are built first in a process of their own (the library is
cached under livingscenes_tpu_torch/_build/), then phase_small_shapes runs
once under each tool in a child process. For each tool the report keeps
the exit code, the seconds, the lines that name a hazard or an error (with
the kernel each names) and the tool's summary line, and the last 4 KB of
its output. Exits 3 when compute-sanitizer is not found or refuses the
device ("Device not supported"), 1 when a tool reported a hazard or did
not run to its end, else 0.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_PHASE = (
    "import sys, torch\n"
    f"sys.path.insert(0, {ROOT!r})\n"
    "import chip_smoke\n"
    "chip_smoke.phase_small_shapes(torch, {})\n"
    "torch.cuda.synchronize()\n"
    "print('phase_small_shapes done')\n"
)
# a kernel's name as compute-sanitizer prints it: "in name(args)" or
# "in void name<...>(args)"
KERNEL = re.compile(r"\bin (?:void )?([A-Za-z_][\w:]*)(?:<[^>]*>)?\(")


def sanitizer() -> str | None:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for c in (shutil.which("compute-sanitizer"),
              os.path.join(home, "bin", "compute-sanitizer"),
              os.path.join(home, "compute-sanitizer", "compute-sanitizer")):
        if c and os.path.exists(c):
            return c
    return None


def run_tool(exe: str, tool: str, timeout: int) -> dict:
    cmd = [exe, "--tool", tool, "--print-limit", "200", sys.executable, "-c", RUN_PHASE]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=timeout)
        text, rc = out.stdout, out.returncode
    except subprocess.TimeoutExpired as e:
        text = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        rc = "timeout"
    seconds = time.perf_counter() - t0
    lines = [ln.strip() for ln in text.splitlines() if ln.startswith("=========")]
    hazards = [ln for ln in lines
               if re.search(r"(Race|Error|error|Barrier|Invalid|hazard)", ln)
               and "SUMMARY" not in ln]
    kernels = sorted({m.group(1) for ln in lines for m in KERNEL.finditer(ln)})
    summary = [ln for ln in lines if "SUMMARY" in ln]
    return {"tool": tool, "rc": rc, "seconds": seconds,
            "finished": "phase_small_shapes done" in text,
            "device_not_supported": "Device not supported" in text,
            "hazard_lines": hazards[:200], "kernels_named": kernels,
            "summary": summary, "tail": text[-4096:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the report here as JSON")
    ap.add_argument("--tools", nargs="+", default=["racecheck", "synccheck"])
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds each tool's run may take")
    args = ap.parse_args()

    exe = sanitizer()
    report = {"compute_sanitizer": exe, "runs": []}
    if exe is not None:
        ver = subprocess.run([exe, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        report["version"] = ver.stdout.strip().splitlines()[-1:] or [ver.stdout]
        build = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r)\n"
             "from livingscenes_tpu_torch.ops import _cuda; print(_cuda.lib())" % ROOT],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if build.returncode != 0:
            print(build.stdout[-4096:], file=sys.stderr)
            raise RuntimeError("building the kernels failed")
        for tool in args.tools:
            r = run_tool(exe, tool, args.timeout)
            report["runs"].append(r)
            print(f"{tool}: rc {r['rc']} in {r['seconds']:.1f} s, finished "
                  f"{r['finished']}, device not supported "
                  f"{r['device_not_supported']}, {len(r['hazard_lines'])} hazard/error lines, "
                  f"kernels named {r['kernels_named']}; summary {r['summary']}",
                  flush=True)
            for ln in r["hazard_lines"][:10]:
                print("  " + ln, flush=True)
            if not r["finished"]:
                print(r["tail"][-1500:], flush=True)
    else:
        print("compute-sanitizer: not found in this CUDA toolkit", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if exe is None or any(r["device_not_supported"] for r in report["runs"]):
        return 3
    bad = [r for r in report["runs"] if r["hazard_lines"] or not r["finished"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
