#!/usr/bin/env python3
"""Smoke run of the PyTorch port (livingscenes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit; TF32 is switched off for matmuls and cuDNN.
2. Builds the CUDA kernels from livingscenes_tpu_torch/csrc with nvcc.
3. Holds each of the seven kernels against its plain PyTorch version on
   the card at the shapes the scene-pair pipeline gives it, and times the
   kernel, the plain version, one PyTorch library call where one computes
   the same function, and the least time the card could take (the bound).
   The fused edge layers (layer 0, mean edge, attention at its five layer
   shapes) get the trained weights and the activations of a plain forward
   of the trained model. The four kernels of the fused encoder are also
   checked, untimed, at small ragged shapes (K < 16, partial tiles).
4. Runs the fused-encoder pipeline (ShapePriorConfig(pallas_attention=True):
   FPS -> kNN+scale -> fused encoder -> match -> Kabsch -> ICP) at full
   width with the trained checkpoint weights/production_r5_selected.ckpt
   on 8 scenes x 8 objects x 4096 points, checks that its outputs are
   finite, that the launch counts show every kernel ran and that no plain
   version ran, times it, and reruns scenes 0-1 on the CPU with the plain
   versions to compare. Then runs the default-config pipeline
   (pallas_attention=False) on the same scenes with the same checks and
   fewer timed calls, and holds the two configurations against each other.
5. Prints a `kernels` JSON line, the card line, and as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "weights", "production_r5_selected.ckpt")

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_SCENES = 8
N_OBJ = 8
N_FULL = 4096
N_PCL = 1024
B = N_SCENES * N_OBJ  # instances per encoder call
ICP_ITERS = 100
# (Nq, Np, C_in) of the kNN graph of encoder layers 0-6; D = 3 C_in.
KNN_LAYERS = [(1024, 1024, 1), (1024, 1024, 32), (512, 1024, 32),
              (512, 512, 64), (128, 512, 64), (32, 128, 128), (32, 32, 256)]
# (N, k) of the encoder's FPS downsampling at layers 2, 4 and 5.
FPS_ENCODER = [(1024, 512), (512, 128), (128, 32)]
# Operations per (edge, output channel) that the fused edge layers need,
# for their bounds (see phase_fused_layers). The so3 activation of one
# channel: y and its direction d from the two halves (3 + 3 adds), y.d and
# d.d (5 + 5), the rsqrt and the unit direction (4), the leaky slope (2),
# y + dir * (acted - y.dir) (7): 29. Mean edge adds the sum over K (3).
# Attention runs it twice and adds, for K, |k|^2 (5) and the two clamped
# divisions (4), q.k (5) and the head's sum (1), a share of the softmax (1),
# and for V the weighted sum over K (6).
ACT_FLOPS = 29
MEAN_EDGE_CHANNEL_FLOPS = ACT_FLOPS + 3
ATTN_EDGE_CHANNEL_FLOPS = 2 * ACT_FLOPS + 16 + 6
# Layer 0: per edge the unit dst, the cross product and nn - dst (about
# 24); per channel the pre-activation row and its direction as (O, 3) times
# the three vectors (15 each) instead of the two adds each, the rest of the
# activation and the sum over K.
L0_EDGE_FLOPS = 24
L0_EDGE_CHANNEL_FLOPS = 2 * 15 + (ACT_FLOPS - 6) + 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls."""
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


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_scenes(rng, n_scenes=N_SCENES, n_pts=N_FULL):
    """Scene pairs of uniform-box objects (bench.py:122 make_scenes, in
    numpy): the rescan moves every object by its own rigid transform and
    permutes the objects."""
    from scipy.spatial.transform import Rotation

    objs = rng.uniform(-0.5, 0.5, (n_scenes, N_OBJ, n_pts, 3)).astype(
        np.float32
    ) * rng.uniform(0.3, 1.0, (n_scenes, N_OBJ, 1, 3)).astype(np.float32)
    offsets = rng.uniform(-3, 3, (n_scenes, N_OBJ, 1, 3)).astype(np.float32)
    ref = objs + offsets
    Rm = Rotation.random(n_scenes * N_OBJ, random_state=0).as_matrix()
    Rm = Rm.reshape(n_scenes, N_OBJ, 3, 3).astype(np.float32)
    tm = rng.normal(size=(n_scenes, N_OBJ, 1, 3)).astype(np.float32) * 0.5
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + tm
    perm = np.stack([rng.permutation(N_OBJ) for _ in range(n_scenes)])
    rescan = np.stack([rescan[s][perm[s]] for s in range(n_scenes)])
    return ref, rescan.astype(np.float32)


def phase_fps(torch, report):
    from livingscenes_tpu_torch.ops import cuda_fps
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling

    rng = np.random.default_rng(1)
    shapes = [(N_FULL, N_PCL, True)] + [(n, k, False) for n, k in FPS_ENCODER]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    rows = []
    for n, k, masked in shapes:
        pts = torch.as_tensor(
            rng.uniform(-1, 1, (B, n, 3)).astype(np.float32), device="cuda"
        )
        mask = None
        if masked:
            m = np.ones((B, n), bool)
            m[1, n // 2:] = False  # half the points padded
            m[2, k // 2:] = False  # fewer valid points than k
            m[3] = rng.random(n) > 0.3
            mask = torch.as_tensor(m, device="cuda")
        got = cuda_fps.fps_cuda(pts, k, mask).long()
        want = farthest_point_sampling(pts, k, mask)[1]
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"fps {B}x{n}->{k}: {bad} indices differ")
        ms = cuda_ms(torch, lambda: cuda_fps.fps_cuda(pts, k, mask), 10)
        plain = cuda_ms(
            torch, lambda: farthest_point_sampling(pts, k, mask), 2, 1)
        flops = 8.0 * B * n * (k - 1)
        nbytes = B * n * 12 + (B * n if masked else 0) + B * k * 4
        bms, by = bound_ms(flops, nbytes)
        calls = 2  # ref and rescan
        total["ms"] += calls * ms
        total["plain_ms"] += calls * plain
        total["bound_ms"] += calls * bms
        rows.append({"shape": [B, n, k], "masked": masked, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by})
        log(f"fps {B}x{n}->{k} masked={masked}: exact; kernel {ms:.3f} ms, "
            f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by})")
    report["fps"] = {"shapes": rows, **total, "max_abs_err": 0.0,
                     "library_ms": None, "bound_by": "operations"}


def check_graph(torch, name, q, p, ik, ip):
    """Hold the kernel's kNN graph ik against the plain version's ip, both
    (B, Nq, k) int64 of queries q among points p. The two may differ only
    by a swap between neighbours whose f64 distances agree within 1e-5 of
    |q|^2 + d, and no row may repeat an index. Returns the mask of entries
    that differ."""
    swapped = ik != ip
    if bool(swapped.any()):
        Bn, nq, k = ik.shape
        D = p.shape[-1]

        def exact(idx):
            nb = torch.gather(
                p.double(), 1, idx.reshape(Bn, -1, 1).expand(-1, -1, D)
            ).reshape(Bn, nq, k, D)
            return torch.sum((q.double()[:, :, None] - nb) ** 2, -1)

        q2 = torch.sum(q.double() ** 2, -1, keepdim=True)
        rows_sw = swapped.any(-1)
        de, dq = exact(ik)[rows_sw], exact(ip)[rows_sw]
        if bool(((de - dq).abs() > 1e-5 * (q2[rows_sw] + dq)).any()):
            raise AssertionError(f"{name}: bad index swap")
    if bool((torch.sort(ik, -1).values.diff(dim=-1) == 0).any()):
        raise AssertionError(f"{name}: repeated index")
    return swapped


def phase_knn(torch, report):
    from livingscenes_tpu_torch.ops import cuda_knn
    from livingscenes_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(2)
    k = 16
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    # the fused-encoder path gets layer 0's graph from the kNN + scale
    # kernel, so its launches of this kernel are those of layers 1-6
    fused = dict(total)
    rows, max_err = [], 0.0
    for layer, (nq, np_, c) in enumerate(KNN_LAYERS):
        D = 3 * c
        p = torch.as_tensor(
            rng.normal(size=(B, np_, D)).astype(np.float32), device="cuda"
        )
        q = p[:, :nq].contiguous()  # queries are a subset of the sources
        dk, ik = cuda_knn.knn_cuda(q, p, k)
        dp, ip = knn(q, p, k)
        torch.cuda.synchronize()
        ik = ik.long()
        q2 = torch.sum(q.double() ** 2, -1, keepdim=True)
        tol = 1e-5 * (q2 + dp.double())
        err = (dk.double() - dp.double()).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"knn {nq}x{np_}x{D}: distances differ")
        swapped = check_graph(torch, f"knn {nq}x{np_}x{D}", q, p, ik, ip)
        max_err = max(max_err, float(err.max()))
        ms = cuda_ms(torch, lambda: cuda_knn.knn_cuda(q, p, k), 20)
        plain = cuda_ms(torch, lambda: knn(q, p, k), 5)
        lib = cuda_ms(torch, lambda: torch.topk(
            torch.cdist(q, p) ** 2, k, dim=-1, largest=False), 5)
        flops = 2.0 * B * nq * np_ * D + 3.0 * B * nq * np_
        nbytes = 4.0 * B * (nq + np_) * D + 8.0 * B * nq * k
        bms, by = bound_ms(flops, nbytes)
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms),
                       ("library_ms", lib)):
            total[key] += 2 * v  # ref and rescan encodes
            fused[key] += 2 * v if layer else 0.0
        rows.append({"shape": [B, nq, np_, D], "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "swapped": int(swapped.sum()),
                     "max_abs_err": float(err.max())})
        log(f"knn {B}x{nq}x{np_}x{D}: ok ({int(swapped.sum())} swaps); "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms, cdist+topk {lib:.3f}"
            f" ms, bound {bms:.4f} ms ({by})")
    report["knn"] = {"shapes": rows, **total, "max_abs_err": max_err,
                     "bound_by": "operations", "fused_path": fused}


TIE_PAIRS = (1, 2)  # pairs of the ICP-stats check with exact ties


def icp_clouds(rng):
    """(x, src, tgt) float32 numpy for the ICP-stats check at the main
    path's shapes. Most pairs are random box clouds, like the pipeline's
    objects. In TIE_PAIRS the targets are an integer lattice and the
    sources sit at half-integer offsets from it: every distance is exact in
    f32 on both sides, and 7 sources in 8 are equally near 2, 4 or 8
    targets, whose mean is the nearest target."""
    from scipy.spatial.transform import Rotation

    n = m = N_PCL
    scale = rng.uniform(0.3, 1.0, (B, 1, 3))
    tgt = rng.uniform(-0.5, 0.5, (B, m, 3)) * scale
    x = rng.uniform(-0.5, 0.5, (B, n, 3)) * scale
    lattice = np.stack(np.meshgrid(np.arange(16), np.arange(8), np.arange(8),
                                   indexing="ij"), -1).reshape(-1, 3)
    assert lattice.shape[0] == m
    for b in TIE_PAIRS:
        tgt[b] = rng.permutation(lattice) - (7, 3, 3)
        cell = rng.integers(0, (15, 7, 7), (n, 3)) - (7, 3, 3)
        x[b] = cell + 0.5 * rng.integers(0, 2, (n, 3))
    Rm = Rotation.random(B, random_state=3).as_matrix()
    src = np.einsum("bji,bnj->bni", Rm, x)  # x moved back by R^T
    return tuple(a.astype(np.float32) for a in (x, src, tgt))


def icp_allowance(torch, x, src, tgt, exact):
    """What the f64 distances allow the two sides of the ICP-stats check.

    A source's candidates are the targets within 2e-6 (|x|^2 + |t|^2 +
    |t*|^2) of its nearest t*: twice the f32 rounding of either side's
    |x|^2 - 2 x.t + |t|^2. Either side's nn_i is the mean of some of its
    candidates, so where a source has more than one, the two may differ by
    the candidates' spread in each coordinate; pairs whose distances are
    `exact` get no such allowance. Returns the allowance of S and nn_sum,
    the rounding allowance of dmin_sum, the count of ambiguous and of
    tied sources, and nn_sum with each source's first nearest target (what
    a kernel that did not average ties would give)."""
    x, src, tgt = (a.double() for a in (x, src, tgt))
    xx = torch.sum(x * x, -1, keepdim=True)
    tt = torch.sum(tgt * tgt, -1)
    d = xx - 2.0 * torch.matmul(x, tgt.transpose(1, 2)) + tt[:, None]
    dmin, jmin = torch.min(d, -1, keepdim=True)
    tstar = torch.gather(tt, 1, jmin[..., 0])[..., None]
    cand = d <= dmin + 2e-6 * (xx + tt[:, None] + tstar)
    multi = torch.sum(cand, -1) > 1
    b, i = torch.nonzero(multi & ~exact[:, None], as_tuple=True)
    C, T = cand[b, i][..., None], tgt[b]
    spread = (torch.where(C, T, -np.inf).amax(1)
              - torch.where(C, T, np.inf).amin(1))
    allow_nn = torch.zeros_like(tgt[:, 0]).index_add_(0, b, spread)
    allow_S = torch.zeros_like(tgt[:, :3]).index_add_(
        0, b, src[b, i].abs()[:, :, None] * spread[:, None, :])
    first = torch.gather(tgt, 1, jmin.expand(-1, -1, 3)).sum(1)
    return ({"S": allow_S, "nn_sum": allow_nn,
             "dmin_sum": 2e-6 * torch.sum(xx + tstar, dim=(1, 2))},
            int(b.numel()), int(torch.sum(multi[exact])), first)


def check_icp_stats(torch, got, want, x, src, tgt, active):
    """Raise unless the kernel's (S, nn_sum, dmin_sum) agree with the plain
    version's on every active pair; returns (max error, ambiguous sources,
    tied sources). The tolerance is rtol 1e-4 of the entry plus the pair's
    largest entry, 1e-6 of sum |x_i| for nn_sum (a centred cloud sums to
    about 0), and the allowance of icp_allowance."""
    exact = torch.zeros_like(active)
    exact[list(TIE_PAIRS)] = True
    allow, n_amb, n_tied, first = icp_allowance(torch, x, src, tgt, exact)
    allow["nn_sum"] = allow["nn_sum"] + 1e-6 * torch.sum(x.abs(), 1).double()
    if bool((got[0][~active] != 0).any()):
        raise AssertionError("icp stats: inactive pairs not zero")
    max_err, tol_nn = 0.0, None
    for g, w, name in zip(got, want, ("S", "nn_sum", "dmin_sum")):
        g, w = g.double(), w.double()
        big = w.abs().reshape(w.shape[0], -1).amax(-1)
        big = big.reshape((-1,) + (1,) * (w.dim() - 1))
        tol = 1e-4 * (w.abs() + big) + allow[name]
        err = (g - w).abs()
        if bool((err > tol)[active].any()):
            raise AssertionError(
                f"icp stats {name}: max err {float(err[active].max())}")
        max_err = max(max_err, float(err[active].max()))
        tol_nn = tol if name == "nn_sum" else tol_nn
    # the check has the power to see a kernel that did not average ties
    tie = list(TIE_PAIRS)
    gap = (first[tie] - want[1][tie].double()).abs().amax(-1)
    if not bool((gap > 10 * tol_nn[tie].amax(-1)).all()):
        raise AssertionError("icp stats: the tie pairs do not tell a mean "
                             "of tied targets from the first one")
    return max_err, n_amb, n_tied


def phase_icp(torch, report):
    from livingscenes_tpu_torch.ops import cuda_icp

    n = m = N_PCL
    x, src, tgt = (torch.as_tensor(a, device="cuda")
                   for a in icp_clouds(np.random.default_rng(3)))
    active = torch.as_tensor(np.arange(B) % 5 != 0, device="cuda")
    got = cuda_icp.icp_stats_cuda(x, src, tgt, active)
    want = cuda_icp.icp_stats_plain(x, src, tgt, active)
    max_err, n_amb, n_tied = check_icp_stats(
        torch, got, want, x, src, tgt, active)
    all_on = torch.ones_like(active)
    # a launch takes about 0.1 ms: time many, after a long warm-up
    ms = cuda_ms(torch, lambda: cuda_icp.icp_stats_cuda(x, src, tgt, all_on),
                 200, warmup=20)
    plain = cuda_ms(torch, lambda: cuda_icp.icp_stats_plain(x, src, tgt, all_on), 5)
    lib = cuda_ms(torch, lambda: torch.min(torch.cdist(x, tgt), dim=-1), 5)
    flops = 8.0 * B * n * m + 30.0 * B * n
    nbytes = 4.0 * B * (2 * n + m) * 3 + B + 4.0 * 13 * B
    bms, by = bound_ms(flops, nbytes)
    log(f"icp stats {B}x{n}x{m}: ok (max err {max_err:.3g}; {n_amb} sources"
        f" nearest to several targets within rounding, {n_tied} exactly "
        f"tied sources averaged); kernel {ms:.4f}"
        f" ms, plain {plain:.3f} ms, cdist+min {lib:.3f} ms, bound "
        f"{bms:.4f} ms ({by}) per launch, all pairs active")
    report["icp_stats"] = {
        "per_launch": {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bms},
        "ms": ICP_ITERS * ms, "plain_ms": ICP_ITERS * plain,
        "library_ms": ICP_ITERS * lib, "bound_ms": ICP_ITERS * bms,
        "bound_by": by, "max_abs_err": max_err,
        "ambiguous_sources": n_amb, "tied_sources": n_tied,
    }


def check_close(name, got, want):
    """Raise unless got is finite and within rtol 2e-4 of want plus atol
    2e-5 times want's largest magnitude (the tolerance the JAX package
    holds its fused kernels to against their XLA branches, with the atol
    scaled to the trained features' size). Returns the max abs error."""
    err = (got - want).abs()
    tol = 2e-5 * want.abs().max() + 2e-4 * want.abs()
    if not bool(got.isfinite().all()) or bool((err > tol).any()):
        raise AssertionError(
            f"{name}: max err {float(err.max()):.3g} against max |want| "
            f"{float(want.abs().max()):.3g}")
    return float(err.max())


def phase_knn_topk(torch, report, pc):
    """Row 4 at the main path's shape: pc is the centred (B, 1024, 3)
    input of one encode. Cloud 1 is replaced by a permuted 16 x 8 x 8
    lattice, centred, whose squared distances are exact in f32 and full
    of ties: there the graph must equal the plain version's exactly."""
    from livingscenes_tpu_torch.ops import cuda_knn

    k, k_top = 16, 5
    Bn, n, _ = pc.shape
    rng = np.random.default_rng(4)
    lattice = np.stack(np.meshgrid(np.arange(16), np.arange(8), np.arange(8),
                                   indexing="ij"), -1).reshape(-1, 3)
    pc = pc.clone()
    pc[1] = torch.as_tensor(
        (rng.permutation(lattice) - (7.5, 3.5, 3.5)).astype(np.float32),
        device="cuda")
    ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, k, k_top)
    ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, k, k_top)
    torch.cuda.synchronize()
    ik = ik.long()
    scale_err = float(((sk - sp).abs() / sp).max())
    if not scale_err <= 1e-5:
        raise AssertionError(f"knn_topk: scale differs by {scale_err} rel")
    if not torch.equal(ik[1], ip[1]):
        raise AssertionError("knn_topk: lattice cloud's graph differs")
    if not bool((ik[..., 0] == torch.arange(n, device="cuda")).all()):
        raise AssertionError("knn_topk: a point is not its own neighbour 0")
    swapped = check_graph(torch, "knn_topk", pc, pc, ik, ip)
    ms = cuda_ms(torch, lambda: cuda_knn.knn_with_topk_scale_cuda(pc, k, k_top), 20)
    plain = cuda_ms(
        torch, lambda: cuda_knn.knn_with_topk_scale_plain(pc, k, k_top), 5)

    def library():
        d = torch.cdist(pc, pc)
        torch.topk(d, k, dim=-1, largest=False)
        torch.topk(d.reshape(Bn, -1), k_top, dim=-1)

    lib = cuda_ms(torch, library, 5)
    flops = 8.0 * Bn * n * n + 2.0 * Bn * n * n
    nbytes = 12.0 * Bn * n + 4.0 * Bn * n * k + 4.0 * Bn
    bms, by = bound_ms(flops, nbytes)
    log(f"knn_topk {Bn}x{n}x3: ok ({int(swapped.sum())} swaps, scale rel err "
        f"{scale_err:.2g}); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"cdist+topk x2 {lib:.3f} ms, bound {bms:.4f} ms ({by})")
    calls = 2  # ref and rescan encodes
    report["knn_topk"] = {
        "shape": [Bn, n, 3], "per_launch": {
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms},
        "ms": calls * ms, "plain_ms": calls * plain,
        "library_ms": calls * lib, "bound_ms": calls * bms, "bound_by": by,
        "max_abs_err": float((sk - sp).abs().max()),
        "swapped": int(swapped.sum()),
    }


def record_layer_calls(torch, model, pc):
    """The arguments the encoder's seven layer functions get in one plain
    encode of pc by the trained model: [(kind, args), ...] in layer order."""
    from livingscenes_tpu_torch.nn import vec_dgcnn_attn as vda

    names = {"layer0": "fused_layer0_edge_mean_plain",
             "edge_mean": "fused_edge_mean_plain",
             "edge_attention": "fused_edge_attention_plain"}
    calls, saved = [], {}

    def recorder(kind, fn):
        def wrapped(*args):
            calls.append((kind, args))
            return fn(*args)
        return wrapped

    for kind, name in names.items():
        saved[name] = getattr(vda, name)
        setattr(vda, name, recorder(kind, saved[name]))
    try:
        with torch.inference_mode():
            model.encode(pc)
    finally:
        for name, fn in saved.items():
            setattr(vda, name, fn)
    return calls


def phase_fused_layers(torch, report, calls):
    """Rows 5-7: each fused kernel against its plain version on the inputs
    `record_layer_calls` took from the trained model (layer 0, layer 1 and
    the five attention layers).

    The bound counts what the function needs, not what the kernels do. The
    edge convolution and the direction product are linear in the gathered
    rows, y[e] = (W_l src)[idx[e]] + ((W_r - W_l) dst)[n] and
    D y[e] = (D W_l src)[idx[e]] + (D (W_r - W_l) dst)[n], so both are needed
    once per source and per destination point and branch, not once per edge
    (the kernels, like the TPU kernels, do them per edge); at layer 0 the
    pre-activation row is W (O, 3) times three vectors of the edge, so its
    direction is (D W) times the same three. Only the sum of the two
    halves, the activation, the softmax and the reduction over K are per
    edge. Bytes: every argument read once, the output written once."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0

    fns = {
        "layer0": (cuda_layer0.fused_layer0_edge_mean_cuda,
                   cuda_layer0.fused_layer0_edge_mean_plain),
        "edge_mean": (cuda_attention.fused_edge_mean_cuda,
                      cuda_attention.fused_edge_mean_plain),
        "edge_attention": (cuda_attention.fused_edge_attention_cuda,
                           cuda_attention.fused_edge_attention_plain),
    }
    for kind in fns:
        report[kind] = {"shapes": [], "ms": 0.0, "plain_ms": 0.0,
                        "bound_ms": 0.0, "max_abs_err": 0.0,
                        "library_ms": None}
    with torch.inference_mode():
        for kind, args in calls:
            kernel, plain_fn = fns[kind]
            args = tuple(a.contiguous() if torch.is_tensor(a) else a
                         for a in args)
            idx = args[1 if kind == "layer0" else 2]
            Bn, nd, K = idx.shape
            edges = float(Bn * nd * K)
            if kind == "layer0":
                C, O = 1, args[2].shape[0]
                ns = nd
                flops = (2.0 * O * O * 3
                         + edges * (L0_EDGE_FLOPS + O * L0_EDGE_CHANNEL_FLOPS))
                floats = Bn * ns * 3 + O * 3 + O * O
            else:
                ns, C = args[0].shape[1], args[0].shape[2]
                attn = kind == "edge_attention"
                branches = 2 if attn else 1
                O = args[4 if attn else 3].shape[0]
                per_point = 3 * C * O * 2 + 3 * O * O * 2  # W y, then D (W y)
                flops = (branches * Bn * (ns + nd) * per_point + edges * O * (
                    ATTN_EDGE_CHANNEL_FLOPS if attn else MEAN_EDGE_CHANNEL_FLOPS))
                floats = (Bn * (ns + nd) * C * 3 + branches * (2 * C * O + O * O)
                          + (Bn * nd * O * 3 if attn else 0))
            nbytes = 4.0 * (floats + edges + Bn * nd * O * 3)
            want = plain_fn(*args)
            got = kernel(*args)
            torch.cuda.synchronize()
            shape = f"{kind} B={Bn} Ns={ns} Nd={nd} C={C} O={O} K={K}"
            err = check_close(shape, got, want)
            del got
            ms = cuda_ms(torch, lambda: kernel(*args), 10)
            plain = cuda_ms(torch, lambda: plain_fn(*args), 3, 1)
            bms, by = bound_ms(flops, nbytes)
            r = report[kind]
            r["shapes"].append({
                "shape": {"B": Bn, "Ns": ns, "Nd": nd, "C": C, "O": O, "K": K},
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "max_abs_err": err, "max_abs_want": float(want.abs().max())})
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms)):
                r[key] += 2 * v  # ref and rescan encodes
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"{shape}: ok (max err {err:.3g}, max |want| "
                f"{float(want.abs().max()):.3g}); kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, bound {bms:.4f} ms ({by})")
            del want
    for kind in fns:
        largest = max(report[kind]["shapes"], key=lambda row: row["bound_ms"])
        report[kind]["bound_by"] = largest["bound_by"]


def phase_small_shapes(torch, report):
    """Rows 4-7 against their plain versions at shapes the main path never
    gives them: K < 16, point counts and widths that fill no whole tile,
    N_dst != N_src, one head and many, and the largest cloud the kNN +
    scale kernel takes. Random inputs from a seed; checked, not timed."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
    from livingscenes_tpu_torch.ops import cuda_knn

    rng = np.random.default_rng(5)

    def f32(*shape, scale=1.0):
        return torch.as_tensor(
            (rng.normal(size=shape) * scale).astype(np.float32), device="cuda")

    def graph(n_src, n_dst, K):
        return torch.as_tensor(rng.integers(0, n_src, (2, n_dst, K)),
                               device="cuda")

    done = []
    with torch.inference_mode():
        for n, k in ((20, 5), (100, 16), (333, 7), (4096, 16)):
            pc = f32(2, n, 3)
            ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, k)
            ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, k)
            name = f"knn_topk small N={n} k={k}"
            if not float(((sk - sp).abs() / sp).max()) <= 1e-5:
                raise AssertionError(f"{name}: scale differs")
            check_graph(torch, name, pc, pc, ik.long(), ip)
            done.append(name)
        for n, K, O in ((40, 16, 32), (33, 8, 48), (18, 16, 132)):
            args = (f32(2, n, 3), graph(n, n, K), f32(O, 3, scale=0.5),
                    f32(O, O, scale=0.2))
            name = f"layer0 small N={n} K={K} O={O}"
            check_close(name, cuda_layer0.fused_layer0_edge_mean_cuda(*args),
                        cuda_layer0.fused_layer0_edge_mean_plain(*args))
            done.append(name)
        for ns, nd, C, O, K in ((50, 50, 32, 32, 16), (40, 21, 16, 48, 8),
                                (30, 5, 36, 140, 7)):
            args = (f32(2, ns, C, 3), f32(2, nd, C, 3), graph(ns, nd, K),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2))
            name = f"edge_mean small Ns={ns} Nd={nd} C={C} O={O} K={K}"
            check_close(name, cuda_attention.fused_edge_mean_cuda(*args),
                        cuda_attention.fused_edge_mean_plain(*args))
            done.append(name)
        for ns, nd, C, O, K, head_c in ((40, 7, 16, 32, 8, 16),
                                        (30, 9, 12, 16, 3, 16),
                                        (24, 3, 20, 144, 5, 8),
                                        (20, 3, 128, 256, 11, 16)):
            args = (f32(2, ns, C, 3), f32(2, nd, C, 3), graph(ns, nd, K),
                    channel_equi_vec_normalize(f32(2, nd, O, 3)),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2), head_c)
            name = (f"edge_attention small Ns={ns} Nd={nd} C={C} O={O} K={K} "
                    f"head_c={head_c}")
            check_close(name, cuda_attention.fused_edge_attention_cuda(*args),
                        cuda_attention.fused_edge_attention_plain(*args))
            done.append(name)
    torch.cuda.synchronize()
    log(f"small shapes: {len(done)} checks ok (" + "; ".join(done) + ")")
    report["small_shapes"] = done


def counters():
    """name -> (module, attribute) of every kernel wrapper's launch count."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.ops import cuda_fps, cuda_icp, cuda_knn

    return {"fps": (cuda_fps, "launches"), "knn": (cuda_knn, "launches"),
            "icp_stats": (cuda_icp, "launches"),
            "knn_topk": (cuda_knn, "topk_launches"),
            "layer0": (cuda_layer0, "launches"),
            "edge_mean": (cuda_attention, "mean_launches"),
            "edge_attention": (cuda_attention, "attention_launches")}


class forbid_plain:
    """While active, every kernel's plain version raises: a run that gets
    through launched kernels only."""

    def __enter__(self):
        from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
        from livingscenes_tpu_torch.ops import cuda_fps, cuda_icp, cuda_knn

        self.saved = []
        for mod, name in (
                (cuda_fps, "farthest_point_sampling"), (cuda_knn, "knn"),
                (cuda_icp, "icp_stats_plain"),
                (cuda_knn, "knn_with_topk_scale_plain"),
                (cuda_layer0, "fused_layer0_edge_mean_plain"),
                (cuda_attention, "fused_edge_mean_plain"),
                (cuda_attention, "fused_edge_attention_plain")):
            self.saved.append((mod, name, getattr(mod, name)))

            def refuse(*a, _name=name, **k):
                raise AssertionError(f"plain version {_name} ran on the card")

            setattr(mod, name, refuse)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def run_config(torch, state, scenes, fused: bool, want: dict, n_timed: int,
               profile: bool):
    """Drive the pipeline of one encoder configuration on the card: a
    warm-up call, one call between setting the launch counts to 0 and
    reading them (held against `want`; with `fused` the plain versions are
    forbidden meanwhile), the output checks, `n_timed` timed calls, the
    stage times, and scenes 0-1 again on the CPU through the plain
    versions (matches0 equal, R within 1e-3)."""
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline)

    tag = f"pallas_attention={fused}"
    cfg = ShapePriorConfig(pallas_attention=fused)
    model = ShapePrior(cfg, device="cuda")
    model.load_state_dict(state)
    pipe = build_scene_pair_pipeline(model, PipelineConfig(encode_fps=True))
    ref_np, res_np, mask_np = scenes
    ref, res = (torch.as_tensor(a, device="cuda") for a in (ref_np, res_np))
    mask = torch.as_tensor(mask_np, device="cuda")

    pipe(ref, res, mask, mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count = counters()
    for mod, attr in count.values():
        setattr(mod, attr, 0)
    if fused:
        with forbid_plain():
            out = pipe(ref, res, mask, mask)
            torch.cuda.synchronize()
    else:
        out = pipe(ref, res, mask, mask)
        torch.cuda.synchronize()
    launches = {k: getattr(mod, attr) for k, (mod, attr) in count.items()}
    log(f"{tag}: pipeline launches {launches}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")

    R, t, m0 = out["R"], out["t"], out["matches0"]
    if not (bool(torch.isfinite(R).all()) and bool(torch.isfinite(t).all())):
        raise AssertionError(f"{tag}: non-finite R or t")
    for s in range(N_SCENES):
        if sorted(m0[s].tolist()) != list(range(N_OBJ)):
            raise AssertionError(f"{tag}: scene {s}: matches0 "
                                 f"{m0[s].tolist()} is not a permutation")

    samples = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(ref, res, mask, mask)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    call_ms = float(np.median(samples))
    pairs_per_s = N_SCENES / (call_ms / 1e3)
    log(f"{tag}: pipeline {N_SCENES}x{N_OBJ}x{N_FULL}: median {call_ms:.2f} "
        f"ms per call over {len(samples)} calls (min {min(samples):.2f}, max "
        f"{max(samples):.2f}), {pairs_per_s:.3f} scene-pairs/s")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    stages = stage_times(torch, model, ref, res, mask)
    log(f"{tag}: stages (ms, host clock with sync): " + json.dumps(stages))
    result = {
        "scenes": N_SCENES, "objects": N_OBJ, "points": N_FULL,
        "ms_per_call": call_ms, "call_ms_samples": samples,
        "scene_pairs_per_s": pairs_per_s, "launches": launches,
        "stages_ms": stages, "peak_mem_gb": peak_gb,
    }
    if profile:
        result["profile"] = stage_times(torch, model, ref, res, mask, profile=True)
        for name, st in result["profile"].items():
            log(f"{tag}: profile {name}: wall {st['wall_ms']:.2f} ms, device "
                f"{st['device_ms']:.2f} ms ({st['busy']:.1%} busy), "
                f"{st['kernels']} kernel launches; top: "
                + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in st["top"][:6]))

    # scenes 0-1 again on the CPU, through the plain versions
    cpu_model = ShapePrior(cfg, device="cpu")
    cpu_model.load_state_dict(state)
    cpu_pipe = build_scene_pair_pipeline(cpu_model, PipelineConfig(encode_fps=True))
    t0 = time.perf_counter()
    cpu_out = cpu_pipe(ref_np[:2], res_np[:2], mask_np[:2], mask_np[:2])
    cpu_s = time.perf_counter() - t0
    m_cpu = cpu_out["matches0"]
    if not torch.equal(m_cpu, m0[:2].cpu()):
        raise AssertionError(f"{tag}: matches0 card {m0[:2].tolist()} vs cpu "
                             f"{m_cpu.tolist()}")
    dR = float((R[:2].cpu() - cpu_out["R"]).abs().max())
    dt = float((t[:2].cpu() - cpu_out["t"]).abs().max())
    log(f"{tag}: card vs cpu on scenes 0-1: matches0 equal, max|dR| {dR:.3g}, "
        f"max|dt| {dt:.3g} (cpu run {cpu_s:.1f} s)")
    if dR > 1e-3:
        raise AssertionError(f"{tag}: R differs from the CPU run by {dR}")
    result["cpu_check"] = {"max_abs_dR": dR, "max_abs_dt": dt}
    return result, out


def phase_pipeline(torch, report, state, scenes, profile: bool):
    """This slice's path (the fused encoder) with the full timing protocol,
    then the default-config path with fewer timed calls, then the two held
    against each other. Returns the fused path's launch counts."""
    per_encode = {"knn_topk": 1, "layer0": 1, "edge_mean": 1,
                  "edge_attention": len(KNN_LAYERS) - 2}
    fused_want = {"fps": 8, "knn": 2 * (len(KNN_LAYERS) - 1),
                  "icp_stats": ICP_ITERS,
                  **{k: 2 * v for k, v in per_encode.items()}}
    plain_want = {"fps": 8, "knn": 2 * len(KNN_LAYERS), "icp_stats": ICP_ITERS,
                  **{k: 0 for k in per_encode}}
    fused, out_f = run_config(torch, state, scenes, True, fused_want, 11, profile)
    plain, out_p = run_config(torch, state, scenes, False, plain_want, 3, profile)
    if not torch.equal(out_f["matches0"], out_p["matches0"]):
        raise AssertionError("the two configurations disagree on matches0")
    dR = float((out_f["R"] - out_p["R"]).abs().max())
    dt = float((out_f["t"] - out_p["t"]).abs().max())
    log(f"pallas_attention True vs False on the card: matches0 equal, "
        f"max|dR| {dR:.3g}, max|dt| {dt:.3g}")
    if dR > 1e-3:
        raise AssertionError(f"the two configurations differ in R by {dR}")
    report["pipeline"] = fused
    report["pipeline_default_config"] = plain
    report["config_check"] = {"max_abs_dR": dR, "max_abs_dt": dt}
    return fused["launches"]


def stage_times(torch, model, ref, res, mask, profile=False):
    """Host-clock ms of each stage of one call, each ended by a sync. With
    `profile`, each stage runs under torch.profiler instead and the result
    is its wall ms, the device ms its kernels took, the busy share, and the
    kernels that took the most device time."""
    from livingscenes_tpu_torch.ops.cuda_fps import fps_auto
    from livingscenes_tpu_torch.solver.matcher import sequential_matcher
    from livingscenes_tpu_torch.solver.registration import (
        RegistrationConfig, solve_pairwise_registration)

    S, O, N, _ = ref.shape
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        if profile:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if not profile:
            out[name] = wall
            return r
        prof.stop()
        # kernel events only: the CPU op that launched a kernel also
        # reports its time, which would count it twice
        by_name = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        rows = sorted(((k[:60], ms, n) for k, (ms, n) in by_name.items()),
                      key=lambda row: -row[1])
        dev = sum(row[1] for row in rows)
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "busy": dev / wall if wall else 0.0,
                     "kernels": sum(row[2] for row in rows), "top": rows[:12]}
        return r

    with torch.inference_mode():
        fm = mask.reshape(S * O, N)
        a = timed("fps_front", lambda: (
            fps_auto(ref.reshape(S * O, N, 3), N_PCL, fm)[0],
            fps_auto(res.reshape(S * O, N, 3), N_PCL, fm)[0]))
        codes = timed("encode", lambda: (model.encode(a[0]), model.encode(a[1])))
        m = timed("match", lambda: sequential_matcher(
            codes[0]["z_inv"].reshape(S, O, -1),
            codes[1]["z_inv"].reshape(S, O, -1))["matches0"])
        part = (m.clamp_min(0) + torch.arange(S, device=m.device)[:, None] * O
                ).reshape(-1)
        c2 = {k: v[part] for k, v in codes[1].items()}
        timed("register", lambda: solve_pairwise_registration(
            model, a[0], a[1][part], codes[0], c2, cfg=RegistrationConfig()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each pipeline stage with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from livingscenes_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds})")
    ptxas = [ln.strip() for ln in _cuda.ptxas_report.splitlines()
             if "registers" in ln or ln.startswith("==")]
    log("ptxas: " + " | ".join(ptxas))

    from livingscenes_tpu_torch.models.convert import (
        load_flax_checkpoint, params_from_jax)
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior
    from livingscenes_tpu_torch.ops.cuda_fps import fps_auto

    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    phase_fps(torch, report)
    phase_knn(torch, report)
    phase_icp(torch, report)

    state = params_from_jax(load_flax_checkpoint(CKPT))
    ref_np, res_np = make_scenes(np.random.default_rng(0))
    scenes = (ref_np, res_np, np.ones(ref_np.shape[:3], bool))
    # one encode's input: the reference instances, FPS-sampled
    model = ShapePrior(device="cuda")
    model.load_state_dict(state)
    pc = fps_auto(torch.as_tensor(ref_np, device="cuda").reshape(B, N_FULL, 3),
                  N_PCL)[0]
    phase_knn_topk(torch, report, pc - pc.mean(dim=1, keepdim=True))
    phase_fused_layers(torch, report, record_layer_calls(torch, model, pc))
    del model
    phase_small_shapes(torch, report)
    launches = phase_pipeline(torch, report, state, scenes, args.profile)

    sources = {
        "fps": ("livingscenes_tpu_torch/csrc/fps.cu",
                "livingscenes_tpu/ops/pallas_fps.py:33"),
        "knn": ("livingscenes_tpu_torch/csrc/knn.cu",
                "livingscenes_tpu/ops/pallas_knn.py:29"),
        "icp_stats": ("livingscenes_tpu_torch/csrc/icp_stats.cu",
                      "livingscenes_tpu/ops/pallas_icp.py:69"),
        "knn_topk": ("livingscenes_tpu_torch/csrc/knn_topk.cu",
                     "livingscenes_tpu/ops/pallas_knn.py:113"),
        "layer0": ("livingscenes_tpu_torch/csrc/layer0.cu",
                   "livingscenes_tpu/nn/pallas_layer0.py:90"),
        "edge_mean": ("livingscenes_tpu_torch/csrc/mean_edge.cu",
                      "livingscenes_tpu/nn/pallas_attention.py:229"),
        "edge_attention": ("livingscenes_tpu_torch/csrc/attention.cu",
                           "livingscenes_tpu/nn/pallas_attention.py:135"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        # times of the launches that `launches` counts: the fused path's
        r = {**r, **r.get("fused_path", {})}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
