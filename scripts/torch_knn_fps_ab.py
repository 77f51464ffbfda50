#!/usr/bin/env python3
"""Time the PyTorch port's kNN and FPS kernels (kernel-table rows 1 and 2)
of one checkout on an NVIDIA card, at the main path's shapes.

    python3 scripts/torch_knn_fps_ab.py [--root CHECKOUT] [--out FILE]

Imports `livingscenes_tpu_torch` from CHECKOUT (default: this one), builds
its kernels, and prints one JSON line (also written to FILE):

- kNN at the seven layer shapes of the encoder (B = 64, k = 16; queries a
  subset of the sources, random normal features): the kernel's ms at the
  layer's D and at D = 16 (one feature chunk: the products nearly gone, so
  that time is the selection, the staging and the launch; the difference
  is the rest of the products), the number of indices that differ from
  the plain version, and, where the checkout's wrapper takes a `form`, the
  ms of each of its tilings.
- FPS at the front end's shape (64 x 4096 -> 1024, masked), the same two
  batches stacked in one launch (128 clouds) against two launches, and the
  encoder's three shapes: the kernel's ms, ns a round (of graph_ms), indices equal to the
  plain version or not; where the wrapper takes `warps`, the ms of each
  form (warps a cloud).

To compare two checkouts, run both on one card in turns (parent, change,
change, parent). `ms`: CUDA events around back-to-back calls
of the wrapper after a warm-up (host-paced where the kernel is shorter
than the wrapper's host time); `graph_ms`: the kernel's device time, from
20 calls captured in a CUDA graph and replayed.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np

B = 64
K = 16
# (Nq, Np, C_in) of the kNN graph of encoder layers 0-6; D = 3 C_in.
KNN_LAYERS = [(1024, 1024, 1), (1024, 1024, 32), (512, 1024, 32),
              (512, 512, 64), (128, 512, 64), (32, 128, 128), (32, 32, 256)]
# (clouds, N, k, masked): the front end, stacked, and the encoder's FPS.
FPS_SHAPES = [(B, 4096, 1024, True), (2 * B, 4096, 1024, True),
              (B, 1024, 512, False), (B, 512, 128, False), (B, 128, 32, False)]


def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, per_graph=20, replays=10):
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


def time_knn(torch, cuda_knn, knn):
    rng = np.random.default_rng(2)
    forms = "form" in inspect.signature(cuda_knn.knn_cuda).parameters
    rows = []
    for nq, np_, c in KNN_LAYERS:
        D = 3 * c
        p = torch.as_tensor(rng.normal(size=(B, np_, D)).astype(np.float32),
                            device="cuda")
        q = p[:, :nq].contiguous()
        p16 = torch.as_tensor(rng.normal(size=(B, np_, 16)).astype(np.float32),
                              device="cuda")
        q16 = p16[:, :nq].contiguous()
        ik = cuda_knn.knn_cuda(q, p, K)[1].long()
        ip = knn(q, p, K)[1]
        row = {"shape": [B, nq, np_, D],
               "ms": cuda_ms(torch, lambda: cuda_knn.knn_cuda(q, p, K)),
               "graph_ms": graph_ms(torch, lambda: cuda_knn.knn_cuda(q, p, K)),
               "ms_d16": cuda_ms(torch, lambda: cuda_knn.knn_cuda(q16, p16, K)),
               "index_differences": int((ik != ip).sum())}
        if forms:
            for form in (1, 2, 3):
                row[f"ms_form{form}"] = cuda_ms(
                    torch, lambda: cuda_knn.knn_cuda(q, p, K, form))
        rows.append(row)
    return rows


def time_fps(torch, cuda_fps, fps):
    rng = np.random.default_rng(1)
    forms = "warps" in inspect.signature(cuda_fps.fps_cuda).parameters
    rows = []
    for clouds, n, k, masked in FPS_SHAPES:
        pts = torch.as_tensor(rng.uniform(-1, 1, (clouds, n, 3)).astype(np.float32),
                              device="cuda")
        mask = None
        if masked:
            m = rng.random((clouds, n)) > 0.3
            m[1, n // 2:] = False
            mask = torch.as_tensor(m, device="cuda")
        got = cuda_fps.fps_cuda(pts, k, mask).long()
        equal = bool(torch.equal(got, fps(pts, k, mask)[1]))
        ms = cuda_ms(torch, lambda: cuda_fps.fps_cuda(pts, k, mask))
        gms = graph_ms(torch, lambda: cuda_fps.fps_cuda(pts, k, mask))
        row = {"shape": [clouds, n, k], "masked": masked, "ms": ms,
               "graph_ms": gms, "ns_a_round": gms * 1e6 / (k - 1), "equal": equal}
        if clouds == 2 * B:
            half = [(pts[:B].contiguous(), mask[:B].contiguous()),
                    (pts[B:].contiguous(), mask[B:].contiguous())]
            row["ms_two_launches"] = cuda_ms(
                torch, lambda: [cuda_fps.fps_cuda(x, k, m) for x, m in half])
        if forms:
            for warps in (1, 2, 4, 8, 16):
                if warps == 1 and n > 1024:
                    continue
                row[f"ms_warps{warps}"] = cuda_ms(
                    torch, lambda: cuda_fps.fps_cuda(pts, k, mask, warps=warps))
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_knn_fps_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from livingscenes_tpu_torch.ops import _cuda, cuda_fps, cuda_knn
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
    from livingscenes_tpu_torch.ops.knn import knn

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    # ptxas -v of the two sources: each entry, its registers and spills
    ptxas, source = [], None
    for ln in _cuda.ptxas_report.splitlines():
        if ln.startswith("=="):
            source = ln[3:].strip()
        elif source in ("knn.cu", "fps.cu") and any(
                w in ln for w in ("entry function", "registers", "spill")):
            ptxas.append(ln.strip())
    with torch.inference_mode():
        out = {"root": args.root, "card": card, "build_s": _cuda.build_seconds,
               "knn": time_knn(torch, cuda_knn, knn),
               "fps": time_fps(torch, cuda_fps, farthest_point_sampling)}
    out["ptxas"] = ptxas
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
