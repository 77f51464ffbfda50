#!/usr/bin/env python3
"""Time the PyTorch port's layer-0 kernel and its attention backward
(kernel-table rows 5 and 14) of one checkout on an NVIDIA card, at the
main path's and the training step's shapes.

    python3 scripts/torch_layer0_attn_bwd_ab.py [--root CHECKOUT] [--out FILE]

Imports `livingscenes_tpu_torch` from CHECKOUT (default: this one), builds
its kernels, and prints one JSON line (also appended to FILE):

- row 5, `fused_layer0_edge_mean_cuda` at the encoder's layer 0 (B = 64
  clouds of 1024 points, O = 32, K = 16; random points, weights and
  graph), against `fused_layer0_edge_mean_plain`;
- row 14, `fused_edge_attention_bwd_cuda` at each attention layer of a
  training step at batch 64, (Ns, Nd, C, O) = (1024, 512, 32, 64),
  (512, 512, 64, 64), (512, 128, 64, 128), (128, 32, 128, 256),
  (32, 32, 256, 512), K = 16, head_c = 16 (random features, weights, graph
  and cotangent), against the f32 plain VJP
  (`fused_edge_attention_bwd_plain`): the largest error of each gradient
  over its largest entry. Where the checkout has them, its stages alone:
  the per-point rows (`attention_point_products_cuda`), the edge pass
  (`lstpu_edge_attention_bwd`) and the products and reductions after it
  (`lstpu_attention_bwd_products`).

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
ATTN_LAYERS = [(1024, 512, 32, 64), (512, 512, 64, 64), (512, 128, 64, 128),
               (128, 32, 128, 256), (32, 32, 256, 512)]
K = 16
HEAD_C = 16


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


def time_layer0(torch, cuda_layer0, f32, rng):
    N, O = 1024, 32
    xyz = f32(B, N, 3)
    idx = torch.as_tensor(rng.integers(0, N, (B, N, K)).astype(np.int32),
                          device="cuda")
    W, D = f32(O, 3, scale=0.5), f32(O, O, scale=0.2)
    got = cuda_layer0.fused_layer0_edge_mean_cuda(xyz, idx, W, D)
    want = cuda_layer0.fused_layer0_edge_mean_plain(xyz, idx, W, D)
    return {"shape": {"B": B, "N": N, "O": O, "K": K},
            "graph_ms": graph_ms(
                torch, lambda: cuda_layer0.fused_layer0_edge_mean_cuda(xyz, idx, W, D)),
            "max_abs_err": float((got - want).abs().max()),
            "max_abs_want": float(want.abs().max())}


def stages(torch, cuda_attention, _cuda, args, g):
    """This tree's row 14 split into its three stages, each alone."""
    src, dst, idx, q_n, W_K, D_K, W_V, D_V = args
    Bn, Ns, C, _ = src.shape
    Nd, O = dst.shape[1], W_K.shape[0]
    W_l = torch.cat([W_K[:, :C], W_V[:, :C]], dim=0)
    W_delta = torch.cat([W_K[:, C:], W_V[:, C:]], dim=0) - W_l
    lib = _cuda.lib()
    stream = lambda: _cuda.stream_ptr(src)  # noqa: E731 (the capture stream)
    rows = torch.empty((Bn * (Ns + Nd), 3, 4 * O), dtype=torch.float32,
                       device="cuda")
    n_src = Bn * Ns
    cuda_attention._launch_attention_products(
        src, dst, W_l, W_delta, D_K, D_V, rows[:n_src], rows[n_src:])
    grows = torch.zeros_like(rows)
    d_qn = torch.empty((Bn, Nd, O, 3), dtype=torch.float32, device="cuda")
    idx32 = idx.to(torch.int32)
    size = 4 * C * O + 2 * O * O
    # the entry's name before the mean-edge backward shared it
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
        _cuda.check(lib.lstpu_edge_attention_bwd(
            rows.data_ptr(), rows[n_src:].data_ptr(), q_n.data_ptr(),
            idx32.data_ptr(), g.data_ptr(), grows.data_ptr(),
            grows[n_src:].data_ptr(), d_qn.data_ptr(), Bn, Ns, Nd, O, K,
            HEAD_C, 0.2, stream()), "edges")

    def rest():
        _cuda.check(lib.lstpu_attention_bwd_products(
            grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
            W_l.data_ptr(), W_delta.data_ptr(), D_K.data_ptr(), D_V.data_ptr(),
            d_src3.data_ptr(), d_dst3.data_ptr(), part.data_ptr(),
            out.data_ptr(), Bn, Ns, Nd, C, O, stream()), "rest")

    return {
        "products_graph_ms": graph_ms(
            torch, lambda: cuda_attention.attention_point_products_cuda(
                src, dst, W_l, W_delta, D_K, D_V), 5, 5),
        "edge_pass_graph_ms": graph_ms(torch, edges, 5, 5),
        "linear_rest_graph_ms": graph_ms(torch, rest, 5, 5),
        "splits": splits_of(Bn, Ns, Nd)}


def time_attention_bwd(torch, cuda_attention, _cuda, f32, rng):
    from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize

    rows = []
    for Ns, Nd, C, O in ATTN_LAYERS:
        # trained-like magnitudes: unit-scale features, weights of 1/sqrt(C)
        args = (f32(B, Ns, C, 3), f32(B, Nd, C, 3),
                torch.as_tensor(rng.integers(0, Ns, (B, Nd, K)).astype(np.int32),
                                device="cuda"),
                channel_equi_vec_normalize(f32(B, Nd, O, 3)),
                f32(O, 2 * C, scale=C ** -0.5), f32(O, O, scale=O ** -0.5),
                f32(O, 2 * C, scale=C ** -0.5), f32(O, O, scale=O ** -0.5))
        g = f32(B, Nd, O, 3)
        got = cuda_attention.fused_edge_attention_bwd_cuda(*args, g, HEAD_C)
        want = cuda_attention.fused_edge_attention_bwd_plain(*args, g, HEAD_C)
        errs = [float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want)]
        del got, want
        row = {"shape": {"B": B, "Ns": Ns, "Nd": Nd, "C": C, "O": O, "K": K},
               "graph_ms": graph_ms(
                   torch, lambda: cuda_attention.fused_edge_attention_bwd_cuda(
                       *args, g, HEAD_C), 5, 5),
               "max_err_of_largest": errs}
        if hasattr(cuda_attention, "attention_bwd_products_launches"):
            row.update(stages(torch, cuda_attention, _cuda, args, g))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--out", help="also append the JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_layer0_attn_bwd_ab: no CUDA device is available", file=sys.stderr)
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
    # ptxas -v of the two sources (and the products they share): each
    # entry, its registers and spills
    ptxas, source = [], None
    for ln in _cuda.ptxas_report.splitlines():
        if ln.startswith("=="):
            source = ln[3:].strip()
        elif source in ("layer0.cu", "attention_bwd.cu") and any(
                w in ln for w in ("entry function", "registers", "spill")):
            ptxas.append(f"{source}: {ln.strip()}")
    rng = np.random.default_rng(4)

    def f32(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32),
                               device="cuda")

    with torch.inference_mode():
        out = {"root": args.root, "card": card, "build_s": _cuda.build_seconds,
               "layer0": time_layer0(torch, cuda_layer0, f32, rng)}
    out["attention_bwd"] = time_attention_bwd(torch, cuda_attention, _cuda, f32, rng)
    out["attention_bwd_step_ms"] = sum(r["graph_ms"] for r in out["attention_bwd"])
    out["ptxas"] = ptxas
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
