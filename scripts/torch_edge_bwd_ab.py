#!/usr/bin/env python3
"""Time the PyTorch port's layer-0 backward and mean-edge backward
(kernel-table rows 12 and 13) of one checkout on an NVIDIA card, at the
training step's shapes.

    python3 scripts/torch_edge_bwd_ab.py [--root CHECKOUT] [--out FILE]

Imports `livingscenes_tpu_torch` from CHECKOUT (default: this one), builds
its kernels, and prints one JSON line (also appended to FILE):

- row 12, `fused_layer0_edge_mean_bwd_cuda` at the encoder's layer 0 in a
  training step at batch 64 (B = 64 clouds of 1024 points, O = 32,
  K = 16; random points, weights, graph and cotangent), against the f32
  plain VJP (`fused_layer0_edge_mean_bwd_plain`): the largest error of
  each gradient over its largest entry, and whether two calls give the
  same bits of d_W and d_D; and at two widths whose points span several
  warps (2 clouds; N, K, O = 266, 5, 512 and 530, 4, 132) the count of 50
  calls whose d_W or d_D differ from the first's;
- row 13, `fused_edge_mean_bwd_cuda` at layer 1 of that step (B = 64,
  Ns = Nd = 1024, C = O = 32, K = 16), against
  `fused_edge_mean_bwd_plain` the same way. Where the checkout has them,
  its stages alone: the per-point rows (`mean_point_products_cuda`), the
  edge pass with the zeroing of the sources' buffer
  (`lstpu_edge_mean_bwd`) and the products and reductions after it
  (`lstpu_mean_bwd_products`).

Each time is device time from calls captured in a CUDA graph and replayed
(no host work between calls). To compare two checkouts, run both on one
card in turns (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

B = 64
N = 1024
K = 16
O0 = 32           # layer 0's width
C1, O1 = 32, 32   # layer 1's


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


def errors(got, want):
    return [float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want)]


def time_layer0_bwd(torch, cuda_layer0, f32, graph):
    args = (f32(B, N, 3), graph(N, N), f32(O0, 3, scale=0.5),
            f32(O0, O0, scale=O0 ** -0.5), f32(B, N, O0, 3))
    kernel = cuda_layer0.fused_layer0_edge_mean_bwd_cuda
    got = kernel(*args)
    again = kernel(*args)
    want = cuda_layer0.fused_layer0_edge_mean_bwd_plain(*args)
    row = {"shape": {"B": B, "N": N, "O": O0, "K": K},
           "graph_ms": graph_ms(torch, lambda: kernel(*args)),
           "max_err_of_largest": errors(got, want),
           "weights_repeat": bool(torch.equal(got[1], again[1])
                                  and torch.equal(got[2], again[2]))}
    del got, again, want
    for n, k, o in ((266, 5, 512), (530, 4, 132)):
        wide = (f32(2, n, 3), graph(n, n)[:2, :, :k].contiguous(),
                f32(o, 3, scale=0.5), f32(o, o, scale=0.2), f32(2, n, o, 3))
        first = kernel(*wide)
        row[f"wide_differ_of_50_N{n}_K{k}_O{o}"] = sum(
            not (torch.equal(first[1], r[1]) and torch.equal(first[2], r[2]))
            for r in (kernel(*wide) for _ in range(50)))
    return row


def mean_stages(torch, cuda_attention, _cuda, args, g):
    """This tree's row 13 split into its three stages, each alone."""
    src, dst, idx, W, D = args
    Bn, Ns, C, _ = src.shape
    Nd, O = dst.shape[1], W.shape[0]
    W_l = W[:, :C].contiguous()
    W_delta = W[:, C:] - W_l
    lib = _cuda.lib()
    stream = lambda: _cuda.stream_ptr(src)  # noqa: E731 (the capture stream)
    n_src = Bn * Ns
    rows = torch.empty((Bn * (Ns + Nd), 3, 2 * O), dtype=torch.float32,
                       device="cuda")
    cuda_attention._launch_mean_products(src, dst, W_l, W_delta, D,
                                         rows[:n_src], rows[n_src:])
    grows = torch.empty_like(rows)
    idx32 = idx.to(torch.int32)
    size = 2 * C * O + O * O
    # the entry's name before the attention backward shared it
    splits_of = getattr(lib, "lstpu_edge_bwd_splits", None) or getattr(
        lib, "lstpu_attention_bwd_splits")
    part = torch.empty((splits_of(Bn, Ns, Nd), size),
                       dtype=torch.float32, device="cuda")
    out = torch.empty(size, dtype=torch.float32, device="cuda")
    src3 = src.transpose(2, 3).contiguous()
    dst3 = dst.transpose(2, 3).contiguous()
    d_src3, d_dst3 = torch.empty_like(src3), torch.empty_like(dst3)

    def edges():
        grows[:n_src].zero_()
        _cuda.check(lib.lstpu_edge_mean_bwd(
            rows.data_ptr(), rows[n_src:].data_ptr(), idx32.data_ptr(),
            g.data_ptr(), grows.data_ptr(), grows[n_src:].data_ptr(), Bn, Ns,
            Nd, O, K, 0.2, stream()), "edges")

    def rest():
        _cuda.check(lib.lstpu_mean_bwd_products(
            grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
            W_l.data_ptr(), W_delta.data_ptr(), D.data_ptr(), d_src3.data_ptr(),
            d_dst3.data_ptr(), part.data_ptr(), out.data_ptr(), Bn, Ns, Nd, C,
            O, stream()), "rest")

    return {
        "products_graph_ms": graph_ms(
            torch, lambda: cuda_attention.mean_point_products_cuda(
                src, dst, W_l, W_delta, D), 10, 5),
        "edge_pass_graph_ms": graph_ms(torch, edges, 10, 5),
        "linear_rest_graph_ms": graph_ms(torch, rest, 10, 5),
        "splits": splits_of(Bn, Ns, Nd)}


def time_mean_bwd(torch, cuda_attention, _cuda, f32, graph):
    # trained-like magnitudes: unit-scale features, weights of 1/sqrt(C)
    args = (f32(B, N, C1, 3), f32(B, N, C1, 3), graph(N, N),
            f32(O1, 2 * C1, scale=C1 ** -0.5), f32(O1, O1, scale=O1 ** -0.5))
    g = f32(B, N, O1, 3)
    kernel = cuda_attention.fused_edge_mean_bwd_cuda
    got = kernel(*args, g)
    want = cuda_attention.fused_edge_mean_bwd_plain(*args, g)
    row = {"shape": {"B": B, "Ns": N, "Nd": N, "C": C1, "O": O1, "K": K},
           "graph_ms": graph_ms(torch, lambda: kernel(*args, g), 10, 5),
           "max_err_of_largest": errors(got, want)}
    del got, want
    if hasattr(cuda_attention, "mean_bwd_products_launches"):
        row.update(mean_stages(torch, cuda_attention, _cuda, args, g))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--out", help="also append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_edge_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.ops import _cuda

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    # ptxas -v of the two sources: each entry, its registers and spills
    ptxas, source = [], None
    for ln in _cuda.ptxas_report.splitlines():
        if ln.startswith("=="):
            source = ln[3:].strip()
        elif source in ("layer0_bwd.cu", "mean_edge_bwd.cu") and any(
                w in ln for w in ("entry function", "registers", "spill")):
            ptxas.append(f"{source}: {ln.strip()}")
    rng = np.random.default_rng(4)

    def f32(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32),
                               device="cuda")

    def graph(n_src, n_dst):
        return torch.as_tensor(rng.integers(0, n_src, (B, n_dst, K)).astype(np.int32),
                               device="cuda")

    out = {"root": args.root, "card": card, "build_s": _cuda.build_seconds,
           "layer0_bwd": time_layer0_bwd(torch, cuda_layer0, f32, graph)}
    torch.cuda.empty_cache()
    out["mean_edge_bwd"] = time_mean_bwd(torch, cuda_attention, _cuda, f32, graph)
    out["ptxas"] = ptxas
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
