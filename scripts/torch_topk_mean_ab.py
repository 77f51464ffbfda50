#!/usr/bin/env python3
"""Time the PyTorch port's kNN + scale, mean-edge and scale kernels
(kernel-table rows 4, 6 and 8) of one checkout on an NVIDIA card, at the
main path's shapes.

    python3 scripts/torch_topk_mean_ab.py [--root CHECKOUT] [--out FILE]

Imports `livingscenes_tpu_torch` from CHECKOUT (default: this one), builds
its kernels, and prints one JSON line (also appended to FILE):

- row 4, `knn_with_topk_scale_cuda` at the front end's shape (64 clouds of
  1024 points, k = 16, the five largest distances) and at 4 x 4352 and
  4 x 8192 points (past the 4096 that earlier checkouts refuse: then
  "refused" and the error);
- row 6, `fused_edge_mean_cuda` at layer 1's shape (B = 64, 1024 source
  and destination points, C = O = 32, K = 16; random features, weights
  and graph), and, where the checkout
  has them, its per-point products alone (`mean_point_products_cuda`);
- row 8, `top_k_mean_pairwise_distance_cuda` at 64 clouds of 1000 points
  and at 4 x 5000 (or "refused").

- row 2, `knn_cuda` at the encoder's seven layer shapes (B = 64, k = 16,
  random normal features, as `scripts/torch_knn_fps_ab.py` makes them): a
  SHA-256 digest of its distances and indices, so that two checkouts can
  be shown to give the same bits.

Each time is the kernel's device time, from 20 calls captured in a CUDA
graph and replayed 10 times; each result is held against the plain
version (`equal` for the graph, `max_abs_err` otherwise). To compare two
checkouts, run both on one card in turns (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

B = 64


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


def clouds(torch, rng, n_clouds, n):
    return torch.as_tensor(rng.uniform(-0.5, 0.5, (n_clouds, n, 3)).astype(np.float32),
                           device="cuda")


def time_knn_topk(torch, cuda_knn, rng):
    rows = []
    for n_clouds, n in ((B, 1024), (4, 4352), (4, 8192)):
        pc = clouds(torch, rng, n_clouds, n)
        row = {"shape": [n_clouds, n, 3]}
        try:
            ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, 16)
        except (ValueError, RuntimeError) as e:
            rows.append({**row, "refused": str(e)})
            continue
        ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, 16)
        row.update(
            graph_ms=graph_ms(torch, lambda: cuda_knn.knn_with_topk_scale_cuda(pc, 16)),
            equal=bool(torch.equal(ik.long(), ip)),
            scale_max_rel_err=float(((sk - sp).abs() / sp).max()))
        rows.append(row)
    return rows


def time_mean_edge(torch, cuda_attention, rng):
    Ns = Nd = 1024
    C, O, K = 32, 32, 16

    def f32(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32),
                               device="cuda")

    src, dst = f32(B, Ns, C, 3), f32(B, Nd, C, 3)
    idx = torch.as_tensor(rng.integers(0, Ns, (B, Nd, K)).astype(np.int32),
                          device="cuda")
    W, D = f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2)
    got = cuda_attention.fused_edge_mean_cuda(src, dst, idx, W, D)
    want = cuda_attention.fused_edge_mean_plain(src, dst, idx, W, D)
    row = {"shape": {"B": B, "Ns": Ns, "Nd": Nd, "C": C, "O": O, "K": K},
           "graph_ms": graph_ms(
               torch, lambda: cuda_attention.fused_edge_mean_cuda(src, dst, idx, W, D)),
           "max_abs_err": float((got - want).abs().max()),
           "max_abs_want": float(want.abs().max())}
    if hasattr(cuda_attention, "mean_point_products_cuda"):
        W_l = W[:, :C].contiguous()
        W_delta = W[:, C:] - W_l
        row["products_graph_ms"] = graph_ms(
            torch, lambda: cuda_attention.mean_point_products_cuda(
                src, dst, W_l, W_delta, D))
    return row


def time_scale(torch, cuda_scale, rng):
    rows = []
    for n_clouds, n in ((B, 1000), (4, 5000)):
        pc = clouds(torch, rng, n_clouds, n)
        row = {"shape": [n_clouds, n, 3]}
        try:
            got = cuda_scale.top_k_mean_pairwise_distance_cuda(pc, 5)
        except (ValueError, RuntimeError) as e:
            rows.append({**row, "refused": str(e)})
            continue
        want = cuda_scale.top_k_mean_pairwise_distance_plain(pc, 5)
        row.update(
            graph_ms=graph_ms(
                torch, lambda: cuda_scale.top_k_mean_pairwise_distance_cuda(pc, 5)),
            max_rel_err=float(((got - want).abs() / want).max()))
        rows.append(row)
    return rows


# (Nq, Np, C_in) of the kNN graph of encoder layers 0-6; D = 3 C_in.
KNN_LAYERS = [(1024, 1024, 1), (1024, 1024, 32), (512, 1024, 32),
              (512, 512, 64), (128, 512, 64), (32, 128, 128), (32, 32, 256)]


def knn_digest(torch, cuda_knn):
    """SHA-256 of the kNN kernel's (distances, indices) at the seven layer
    shapes, from inputs made by a fixed seed."""
    import hashlib

    rng = np.random.default_rng(2)
    h = hashlib.sha256()
    for nq, np_, c in KNN_LAYERS:
        p = torch.as_tensor(rng.normal(size=(B, np_, 3 * c)).astype(np.float32),
                            device="cuda")
        d, i = cuda_knn.knn_cuda(p[:, :nq].contiguous(), p, 16)
        h.update(d.cpu().numpy().tobytes())
        h.update(i.cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--out", help="also append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_topk_mean_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from livingscenes_tpu_torch.nn import cuda_attention
    from livingscenes_tpu_torch.ops import _cuda, cuda_knn, cuda_scale

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    # ptxas -v of the three sources: each entry, its registers and spills
    ptxas, source = [], None
    for ln in _cuda.ptxas_report.splitlines():
        if ln.startswith("=="):
            source = ln[3:].strip()
        elif source in ("knn_topk.cu", "mean_edge.cu", "scale.cu") and any(
                w in ln for w in ("entry function", "registers", "spill")):
            ptxas.append(f"{source}: {ln.strip()}")
    rng = np.random.default_rng(3)
    with torch.inference_mode():
        out = {"root": args.root, "card": card, "build_s": _cuda.build_seconds,
               "knn_topk": time_knn_topk(torch, cuda_knn, rng),
               "edge_mean": time_mean_edge(torch, cuda_attention, rng),
               "scale": time_scale(torch, cuda_scale, rng),
               "knn_digest": knn_digest(torch, cuda_knn)}
    out["ptxas"] = ptxas
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
