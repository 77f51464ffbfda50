#!/usr/bin/env python3
"""Time the PyTorch port's Sinkhorn kernels (kernel-table rows 9, 10 and
11) of one checkout on an NVIDIA card, at the refinement's shapes.

    python3 scripts/torch_sinkhorn_ab.py [--root CHECKOUT] [--out FILE]

Imports `livingscenes_tpu_torch` from CHECKOUT (default: this one), builds
its kernels, and prints one JSON line (also appended to FILE) with, for
B = 64 pairs of 1024 x 1024 points and the refinement's schedule of 8
temperatures (`eps_annealing_schedule(0.05, 2.0)`, the last 0.0025):

- row 9, `extrapolated_forward_cuda`; row 11, `sinkhorn_iterates_cuda`;
- row 10, `extrapolated_backward_cuda` with both cotangents (1 / N each,
  as the divergence's xy term gives them) and with f alone (its xx term);
- each against its f32 plain version (the largest error; for the backward
  over the largest entry of autograd of the plain forward), and a sha256
  digest of each output's bytes;
- where the checkout has `forward_plan`, the launch shape it takes;
- under "small", the accuracy of rows 9 and 10 at the shape of the emulated
  test `test_sinkhorn_bwd_kernel` (2 pairs of 50 x 50 points, seed 9, both
  cotangents): the forward's largest error against its f32 plain version,
  and the backward's against autograd of the plain forward in f32 and in
  f64, as the largest error over the test's bound (rtol 1e-4 plus 1e-6;
  above 1 the test fails) and over the largest entry.

The clouds are the bench scenes' kind (`chip_smoke.py make_scenes`): boxes
of 0.3-1 a side, offset by up to 3 from the origin, the targets a copy
moved by a small rotation and shift, made from a seed. Each time is device
time from calls captured in a CUDA graph and replayed (no host work between
calls). To compare two checkouts, run both on one card in turns (parent,
change, change, parent).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

B, N = 64, 1024


def graph_ms(torch, fn, per_graph=10, replays=5):
    """Device ms of one fn() with no host work between calls: `per_graph`
    calls captured into one CUDA graph, replayed `replays` times."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def clouds(torch, rng):
    """(x, y) (B, N, 3): boxes offset from the origin, y a moved copy."""
    from scipy.spatial.transform import Rotation

    box = rng.uniform(-0.5, 0.5, (B, N, 3)) * rng.uniform(0.3, 1.0, (B, 1, 3))
    x = box + rng.uniform(-3, 3, (B, 1, 3))
    R = Rotation.from_rotvec(rng.normal(size=(B, 3)) * 0.05).as_matrix()
    y = np.einsum("bij,bnj->bni", R, box) + x.mean(1, keepdims=True)
    y = y + rng.normal(size=(B, 1, 3)) * 0.02
    return (torch.as_tensor(a.astype(np.float32), device="cuda") for a in (x, y))


def small_accuracy(torch, cs, schedule):
    """Rows 9 and 10 on the emulated backward test's inputs (see above)."""
    rng = np.random.default_rng(9)

    def f32(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32),
                               device="cuda")

    x, y = f32(2, 50, 3, scale=0.3), f32(2, 50, 3, scale=0.3) + 0.1
    cf, cg = f32(2, 50), f32(2, 50)
    with torch.no_grad():
        got = cs.extrapolated_forward_cuda(x, y, schedule)
        want = cs.ot_extrapolated_potentials_plain(x, y, schedule)
        want += cs.sinkhorn_iterates_plain(x, y, schedule)
        d = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
    out = {"forward_max_abs_err": max(float((g - w).abs().max())
                                      for g, w in zip(got, want))}
    for dtype in (torch.float32, torch.float64):
        xv = x.to(dtype).requires_grad_(True)
        yv = y.to(dtype).requires_grad_(True)
        f, g = cs.ot_extrapolated_potentials_plain(xv, yv, schedule)
        w = torch.autograd.grad(torch.sum(cf.to(dtype) * f) + torch.sum(cg.to(dtype) * g),
                                (xv, yv))
        err = [(a.double() - b.double()).abs() for a, b in zip(d, w)]
        out[f"backward_vs_{str(dtype)[6:]}"] = {
            "over_test_bound": [float((e / (1e-6 + 1e-4 * b.double().abs())).max())
                                for e, b in zip(err, w)],
            "of_largest": [float(e.max() / b.abs().max()) for e, b in zip(err, w)]}
    return out


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--out", help="also append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sinkhorn_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from livingscenes_tpu_torch.ops import _cuda
    from livingscenes_tpu_torch.ops import cuda_sinkhorn as cs
    from livingscenes_tpu_torch.ops.sinkhorn import eps_annealing_schedule

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    ptxas, source = [], None
    for ln in _cuda.ptxas_report.splitlines():
        if ln.startswith("=="):
            source = ln[3:].strip()
        elif source == "sinkhorn.cu" and any(
                w in ln for w in ("entry function", "registers", "spill")):
            ptxas.append(ln.strip())
    schedule = tuple(eps_annealing_schedule(0.05, 2.0))
    x, y = clouds(torch, np.random.default_rng(11))
    mean_f = torch.full((B, N), 1.0 / N, device="cuda")
    mean_g = torch.full((B, N), 1.0 / N, device="cuda")
    out = {"root": args.root, "card": card, "build_s": _cuda.build_seconds,
           "shape": [B, N, N, len(schedule)], "ptxas": ptxas}

    with torch.no_grad():
        got = cs.extrapolated_forward_cuda(x, y, schedule)
        it = cs.sinkhorn_iterates_cuda(x, y, schedule)
        want = cs.ot_extrapolated_potentials_plain(x, y, schedule)
        want += cs.sinkhorn_iterates_plain(x, y, schedule)
        out["forward"] = {
            "graph_ms": graph_ms(torch, lambda: cs.extrapolated_forward_cuda(x, y, schedule)),
            "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
            "digest": [digest(g) for g in got]}
        out["iterates"] = {
            "graph_ms": graph_ms(torch, lambda: cs.sinkhorn_iterates_cuda(x, y, schedule)),
            "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(it, want[2:])),
            "digest": [digest(g) for g in it]}
        if hasattr(cs, "forward_plan"):
            out["plan"] = cs.forward_plan(B, N, N)
    for name, cf, cg in (("both", mean_f, mean_g), ("f_only", mean_f, None)):
        with torch.no_grad():
            d = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
            again = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
            ms = graph_ms(torch, lambda: cs.extrapolated_backward_cuda(
                x, y, *got, cf, cg, schedule[-1]))
        xv, yv = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        f, g = cs.ot_extrapolated_potentials_plain(xv, yv, schedule)
        total = sum(torch.sum(c * p) for c, p in ((cf, f), (cg, g)) if c is not None)
        w = torch.autograd.grad(total, (xv, yv))
        out[f"backward_{name}"] = {
            "graph_ms": ms,
            "max_err_of_largest": [float((a - b).abs().max() / b.abs().max())
                                   for a, b in zip(d, w)],
            "repeats": all(torch.equal(a, b) for a, b in zip(d, again)),
            "digest": [digest(a) for a in d]}
        del w, f, g, total
    out["backward_step_ms"] = (out["backward_both"]["graph_ms"]
                               + out["backward_f_only"]["graph_ms"])
    out["small"] = small_accuracy(torch, cs, eps_annealing_schedule(0.05))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
