#!/usr/bin/env python3
"""Smoke run of the PyTorch port (livingscenes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit; TF32 is switched off for matmuls and cuDNN.
2. Builds the CUDA kernels from livingscenes_tpu_torch/csrc with nvcc.
3. Holds each of the eleven kernels against its plain PyTorch version on
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
   one timed call, and holds the two configurations against each other.
5. The scale kernel: against its plain version at 64 x 1000 points (one
   cloud a lattice full of exact ties), then one encode of 64 x 1000 points
   with pallas_attention=True (N no multiple of 256: the scale kernel and
   the encoder's own layer-0 kNN) against the CPU on the first 16 clouds.
6. The refinement path, PipelineConfig(optim=True) on 8 scenes x 8 objects x
   1024 points with the fused encoder, the 8 x 768 decoder and the trained
   checkpoint: a warm-up call of 3 steps, whose first Sinkhorn inputs (the
   moved sources and their targets) the three Sinkhorn kernels are then
   held against their plain versions on (forward, iterates, and the
   backward against autograd of the plain forward); one timed call at
   n_steps=400 with the launch counts checked (801 Sinkhorn forwards, 800
   backwards) and every plain version forbidden; stage times; scene 0 at
   n_steps=10 against the CPU.
7. Prints a `kernels` JSON line, the card line, and as its last line
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
# Exponentials: 132 SMs x 16 special-function lanes x 1.98 GHz boost clock,
# one ex2 per lane and clock (Hopper architecture white paper).
PEAK_EXP = 132 * 16 * 1.98e9

N_SCENES = 8
N_OBJ = 8
N_FULL = 4096
N_PCL = 1024
B = N_SCENES * N_OBJ  # instances per encoder call
ICP_ITERS = 100
N_RAGGED = 1000  # a cloud size that is no multiple of 256
REFINE_STEPS = 400
REFINE_WARMUP_STEPS = 3
REFINE_CPU_STEPS = 10  # steps of the card-against-CPU refinement check
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


def bound_ms(flops: float, nbytes: float, exps: float = 0.0):
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate, where operations
    are f32 flops or, if they take longer, exponentials."""
    t_ops = max(flops / PEAK_F32_FLOPS, exps / PEAK_EXP) * 1e3
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
    """Rows 4-11 against their plain versions at shapes the main path never
    gives them: K < 16, point counts and widths that fill no whole tile,
    N_dst != N_src, one head and many, the largest cloud the kNN + scale
    and scale kernels take, Sinkhorn clouds with N != M that fill no whole
    warp. Random inputs from a seed; checked, not timed."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
    from livingscenes_tpu_torch.ops import cuda_knn, cuda_scale, cuda_sinkhorn
    from livingscenes_tpu_torch.ops.sinkhorn import eps_annealing_schedule

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
        for n, k in ((7, 5), (37, 5), (333, 8), (4096, 5)):
            pc = f32(2, n, 3)
            name = f"scale small N={n} k={k}"
            torch.testing.assert_close(
                cuda_scale.top_k_mean_pairwise_distance_cuda(pc, k),
                cuda_scale.top_k_mean_pairwise_distance_plain(pc, k),
                rtol=1e-6, atol=0, msg=lambda m, name=name: f"{name}: {m}")
            done.append(name)
    for n, m, schedule in ((50, 50, eps_annealing_schedule(0.05)),
                           (70, 33, eps_annealing_schedule(0.1)),
                           (20, 45, [0.01] * 5), (1500, 700, [0.02] * 3)):
        x, y = f32(2, n, 3, scale=0.3), f32(2, m, 3, scale=0.3) + 0.1
        name = f"sinkhorn small N={n} M={m} S={len(schedule)}"
        with torch.no_grad():
            got = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
            want = cuda_sinkhorn.ot_extrapolated_potentials_plain(x, y, schedule)
            want += cuda_sinkhorn.sinkhorn_iterates_plain(x, y, schedule)
            got += cuda_sinkhorn.sinkhorn_iterates_cuda(x, y, schedule)
        for g, w in zip(got, want + want[2:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")
        done.append(name)
        for cf, cg in ((f32(2, n), f32(2, m)), (f32(2, n), None), (None, f32(2, m))):
            dx, dy = cuda_sinkhorn.extrapolated_backward_cuda(
                x, y, *got[:4], cf, cg, schedule[-1])
            xv, yv = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
            f, g = cuda_sinkhorn.ot_extrapolated_potentials_plain(xv, yv, schedule)
            total = sum(torch.sum(c * p) for c, p in ((cf, f), (cg, g)) if c is not None)
            wx, wy = torch.autograd.grad(total, (xv, yv))
            for got_d, want_d in ((dx, wx), (dy, wy)):
                torch.testing.assert_close(
                    got_d, want_d, rtol=1e-4, atol=1e-4 * float(want_d.abs().max()),
                    msg=lambda m, name=name: f"{name} backward: {m}")
        done.append(name + " backward x3")
    torch.cuda.synchronize()
    log(f"small shapes: {len(done)} checks ok (" + "; ".join(done) + ")")
    report["small_shapes"] = done


def counters():
    """name -> (module, attribute) of every kernel wrapper's launch count."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.ops import (
        cuda_fps, cuda_icp, cuda_knn, cuda_scale, cuda_sinkhorn)

    return {"fps": (cuda_fps, "launches"), "knn": (cuda_knn, "launches"),
            "icp_stats": (cuda_icp, "launches"),
            "knn_topk": (cuda_knn, "topk_launches"),
            "layer0": (cuda_layer0, "launches"),
            "edge_mean": (cuda_attention, "mean_launches"),
            "edge_attention": (cuda_attention, "attention_launches"),
            "scale": (cuda_scale, "launches"),
            "sinkhorn": (cuda_sinkhorn, "launches"),
            "sinkhorn_bwd": (cuda_sinkhorn, "bwd_launches"),
            "sinkhorn_iterates": (cuda_sinkhorn, "iterates_launches")}


def counted(fn):
    """Run fn() between setting every launch count to 0 and reading them:
    (fn's result, name -> launches)."""
    count = counters()
    for mod, attr in count.values():
        setattr(mod, attr, 0)
    out = fn()
    return out, {k: getattr(mod, attr) for k, (mod, attr) in count.items()}


class forbid_plain:
    """While active, every kernel's plain version raises: a run that gets
    through launched kernels only."""

    def __enter__(self):
        from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
        from livingscenes_tpu_torch.ops import (
            cuda_fps, cuda_icp, cuda_knn, cuda_scale, cuda_sinkhorn, sinkhorn)

        self.saved = []
        for mod, name in (
                (cuda_fps, "farthest_point_sampling"), (cuda_knn, "knn"),
                (cuda_icp, "icp_stats_plain"),
                (cuda_knn, "knn_with_topk_scale_plain"),
                (cuda_layer0, "fused_layer0_edge_mean_plain"),
                (cuda_attention, "fused_edge_mean_plain"),
                (cuda_attention, "fused_edge_attention_plain"),
                (cuda_scale, "top_k_mean_pairwise_distance_plain"),
                (cuda_sinkhorn, "ot_extrapolated_potentials_plain"),
                (cuda_sinkhorn, "sinkhorn_iterates_plain"),
                (sinkhorn, "_sym_potentials")):
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

    def one_call():
        out = pipe(ref, res, mask, mask)
        torch.cuda.synchronize()
        return out

    if fused:
        with forbid_plain():
            out, launches = counted(one_call)
    else:
        out, launches = counted(one_call)
    launches = {k: v for k, v in launches.items() if v or k in want}
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
    plain, out_p = run_config(torch, state, scenes, False, plain_want, 1, profile)
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


def phase_scale(torch, report, state, pc):
    """Row 8: the scale kernel against its plain version on centred clouds
    of N_RAGGED points (pc, the first N_RAGGED points of each FPS-sampled
    instance; cloud 1 is replaced by a permuted 10 x 10 x 10 lattice, whose
    squared distances are exact in f32 and whose largest ones tie many
    times), then one encode of the same clouds through the fused
    configuration, counted, against the CPU on the first 16 clouds."""
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.ops import cuda_scale
    from livingscenes_tpu_torch.solver.matcher import sequential_matcher
    from livingscenes_tpu_torch.solver.registration import kabsch_from_codes

    Bn, n, _ = pc.shape
    rng = np.random.default_rng(6)
    lattice = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    assert lattice.shape[0] == n
    centred = pc - pc.mean(dim=1, keepdim=True)
    centred[1] = torch.as_tensor(
        (rng.permutation(lattice) - 4.5).astype(np.float32), device="cuda")
    got = cuda_scale.top_k_mean_pairwise_distance_cuda(centred, 5)
    want = cuda_scale.top_k_mean_pairwise_distance_plain(centred, 5)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want).max())
    if not rel <= 1e-6 or float(got[1]) != float(want[1]):
        raise AssertionError(f"scale: differs by {rel} rel; lattice "
                             f"{float(got[1])} vs {float(want[1])}")
    ms = cuda_ms(torch, lambda: cuda_scale.top_k_mean_pairwise_distance_cuda(centred, 5), 20)
    plain = cuda_ms(
        torch, lambda: cuda_scale.top_k_mean_pairwise_distance_plain(centred, 5), 5)
    lib = cuda_ms(torch, lambda: torch.topk(
        torch.cdist(centred, centred).reshape(Bn, -1), 5, dim=-1), 5)
    # the matrix is symmetric: the statistic needs only the n (n - 1) / 2
    # distinct distances, each 8 flops and one compare
    bms, by = bound_ms(9.0 * Bn * n * (n - 1) / 2, 12.0 * Bn * n + 4.0 * Bn)
    log(f"scale {Bn}x{n}x3: ok (rel err {rel:.2g}, lattice equal); kernel "
        f"{ms:.4f} ms, plain {plain:.3f} ms, cdist+topk {lib:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")

    # the entry point that needs it: encode at a cloud size the fused front
    # end does not take
    cfg = ShapePriorConfig(pallas_attention=True)
    model = ShapePrior(cfg, device="cuda")
    model.load_state_dict(state)
    with torch.inference_mode(), forbid_plain():
        codes, launches = counted(lambda: model.encode(pc))
        torch.cuda.synchronize()
    launches = {k: v for k, v in launches.items() if v}
    want_launches = {"scale": 1, "knn": len(KNN_LAYERS), "fps": len(FPS_ENCODER),
                     "layer0": 1, "edge_mean": 1,
                     "edge_attention": len(KNN_LAYERS) - 2}
    log(f"encode {Bn}x{n}, pallas_attention=True: launches {launches}")
    if launches != want_launches:
        raise AssertionError(f"encode at N={n}: launches {launches}, expected "
                             f"{want_launches}")
    cpu_model = ShapePrior(cfg, device="cpu")
    cpu_model.load_state_dict(state)
    n_cpu = 16
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_codes = cpu_model.encode(pc[:n_cpu].cpu())
    cpu_s = time.perf_counter() - t0
    card_codes = {k: v[:n_cpu].cpu() for k, v in codes.items()}
    diffs = {}
    for key, val in codes.items():
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"encode at N={n}: non-finite {key}")
        ref = cpu_codes[key]
        diffs[key] = float((card_codes[key] - ref).abs().max() / ref.abs().max())
    # The codes as their consumers read them. On most clouds the card and
    # the CPU agree to 1e-4, but in about one cloud in sixteen, at any N and
    # in either configuration, a neighbour or a sampled point that ties
    # within rounding is picked differently (phase_knn counts such swaps) and
    # the codes turn by up to 1e-2; ICP later pulls such a pair together
    # (the pipeline's card-against-CPU check holds R to 1e-3). So: each card
    # code matches its own CPU code, the rotation between the two is the
    # identity within 1e-4 in the median and 5e-2 at worst, the scales agree
    # to 1 %.
    Rc, _, _ = kabsch_from_codes(card_codes, cpu_codes)
    dR = (Rc - torch.eye(3)).abs().amax(dim=(1, 2))
    matched = sequential_matcher(card_codes["z_inv"][None],
                                 cpu_codes["z_inv"][None])["matches0"][0]
    worst, median = float(dR.max()), float(dR.median())
    log(f"encode {Bn}x{n}: card vs cpu on clouds 0-{n_cpu - 1}: rotation between "
        f"the codes max|R - I| median {median:.3g}, worst {worst:.3g}, "
        f"{int((dR > 1e-3).sum())} clouds above 1e-3; max |diff| over max |value|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (cpu run {cpu_s:.1f} s)")
    if (matched.tolist() != list(range(n_cpu)) or median > 1e-4 or worst > 5e-2
            or diffs["s"] > 1e-2):
        raise AssertionError(f"encode at N={n}: card and CPU codes differ: matches "
                             f"{matched.tolist()}, dR {dR.tolist()}, {diffs}")
    diffs.update(median_abs_dR=median, max_abs_dR=worst)
    report["scale"] = {
        "shape": [Bn, n, 3], "launches": launches["scale"], "ms": ms,
        "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by,
        "max_abs_err": float((got - want).abs().max()),
        "encode_cpu_check": diffs,
    }


def sinkhorn_work(Bn, n, m, steps, n_exp_matrices):
    """(flops, bytes, exps) that a pass over `steps` log-sum-exp pairs (or
    one backward pass that needs `n_exp_matrices` matrices of weights) over
    Bn pairs of n x m needs: the cost entry once (8 flops), then 5 flops and
    one exponential per entry and reduction."""
    entries = float(Bn) * n * m
    if steps:
        return (entries * (8 + 2 * steps * 5), 4.0 * Bn * (n + m) * (3 + 2),
                entries * 2 * steps)
    # backward: per weight an exponential and 4 flops, then the 2 x 4
    # weighted sums (8 multiply-adds) per entry
    return (entries * (8 + 4 * n_exp_matrices + 16),
            4.0 * Bn * (n + m) * (3 + 3 + 3), entries * n_exp_matrices)


def phase_sinkhorn(torch, report, x, y, schedule):
    """Rows 9-11 at the refinement's shapes: x the moved sources and y the
    targets (Bn, 1024, 3) of the first refine step. Forward and iterates
    against the plain version (rtol and atol 1e-5); the backward against
    autograd of the plain forward in f64, with the loss's own cotangents
    (1 / N) and with random ones, both potentials and f alone. Its
    tolerance, rtol 2e-3 plus 1e-3 of the largest entry, is 2.5 times the
    f32 rounding of the cost, which both sides share: the clouds lie up to 5
    from the origin, so |x|^2/2 + |y|^2/2 - x.y is right to about 1e-6,
    which over eps = 0.0025 moves a softmax weight by 4e-4 of itself, in the
    saved potentials and again in the backward. The f32 plain version's own
    error against the same f64 gradient is logged beside the kernel's."""
    from livingscenes_tpu_torch.ops import cuda_sinkhorn as cs

    Bn, n, _ = x.shape
    m = y.shape[1]
    S = len(schedule)
    rng = np.random.default_rng(7)

    def close(name, got, want, rtol, atol):
        err = (got - want).abs()
        if not bool(got.isfinite().all()) or bool((err > atol + rtol * want.abs()).any()):
            raise AssertionError(f"{name}: max err {float(err.max()):.3g} against "
                                 f"max |want| {float(want.abs().max()):.3g}")
        return float(err.max())

    with torch.no_grad():
        got = cs.extrapolated_forward_cuda(x, y, schedule)
        want = cs.ot_extrapolated_potentials_plain(x, y, schedule)
        want += cs.sinkhorn_iterates_plain(x, y, schedule)
        it = cs.sinkhorn_iterates_cuda(x, y, schedule)
        torch.cuda.synchronize()
        err_fwd = max(close(f"sinkhorn {k}", g, w, 1e-5, 1e-5)
                      for k, g, w in zip(("f_out", "g_out", "f_it", "g_it"), got, want))
        err_it = max(close(f"sinkhorn_iterates {k}", g, w, 1e-5, 1e-5)
                     for k, g, w in zip(("f", "g"), it, want[2:]))

    def plain_grad(cf, cg, dtype=torch.float32):
        xv = x.to(dtype).requires_grad_(True)
        yv = y.to(dtype).requires_grad_(True)
        f, g = cs.ot_extrapolated_potentials_plain(xv, yv, schedule)
        total = sum(torch.sum(c.to(dtype) * p) for c, p in ((cf, f), (cg, g))
                    if c is not None)
        return torch.autograd.grad(total, (xv, yv))

    mean_f = torch.full((Bn, n), 1.0 / n, device="cuda")
    mean_g = torch.full((Bn, m), 1.0 / m, device="cuda")
    rand_f = torch.as_tensor(rng.normal(size=(Bn, n)).astype(np.float32), device="cuda")
    rand_g = torch.as_tensor(rng.normal(size=(Bn, m)).astype(np.float32), device="cuda")
    err_bwd, rel_bwd, rel_plain = 0.0, 0.0, 0.0
    for name, cf, cg in (("mean", mean_f, mean_g), ("random", rand_f, rand_g),
                         ("f only", mean_f, None), ("g only", None, rand_g)):
        dx, dy = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
        wx, wy = plain_grad(cf, cg, torch.float64)
        px, py = plain_grad(cf, cg)
        torch.cuda.synchronize()
        for label, g, w, pl in (("dx", dx, wx, px), ("dy", dy, wy, py)):
            top = float(w.abs().max())
            err = close(f"sinkhorn_bwd {name} {label}", g.double(), w, 2e-3, 1e-3 * top)
            err_bwd = max(err_bwd, err)
            rel_bwd = max(rel_bwd, err / top)
            rel_plain = max(rel_plain, float((pl.double() - w).abs().max()) / top)
        del wx, wy, px, py
    # through autograd, as the divergence calls it: the self term of a cloud
    # uses f alone and the cloud is both arguments, so its gradient is dx + dy
    xv = x.clone().requires_grad_(True)
    f_xx, _ = cs.ot_extrapolated_potentials(xv, xv, schedule)
    (g_kernel,) = torch.autograd.grad(torch.sum(f_xx) / n, xv)
    xw = x.double().requires_grad_(True)
    f_pl, _ = cs.ot_extrapolated_potentials_plain(xw, xw, schedule)
    (g_plain,) = torch.autograd.grad(torch.sum(f_pl) / n, xw)
    err_bwd = max(err_bwd, close("sinkhorn_bwd self term", g_kernel.double(), g_plain,
                                 2e-3, 1e-3 * float(g_plain.abs().max())))
    del g_plain, f_pl

    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: cs.extrapolated_forward_cuda(x, y, schedule), 10)
        it_ms = cuda_ms(torch, lambda: cs.sinkhorn_iterates_cuda(x, y, schedule), 10)
        bwd2_ms = cuda_ms(torch, lambda: cs.extrapolated_backward_cuda(
            x, y, *got, mean_f, mean_g, schedule[-1]), 10)
        bwd1_ms = cuda_ms(torch, lambda: cs.extrapolated_backward_cuda(
            x, y, *got, mean_f, None, schedule[-1]), 10)
        fwd_plain = cuda_ms(torch, lambda: cs.ot_extrapolated_potentials_plain(
            x, y, schedule), 3, 1)
        it_plain = cuda_ms(torch, lambda: cs.sinkhorn_iterates_plain(x, y, schedule), 3, 1)
    bwd2_plain = cuda_ms(torch, lambda: plain_grad(mean_f, mean_g), 3, 1) - fwd_plain
    bwd1_plain = cuda_ms(torch, lambda: plain_grad(mean_f, None), 3, 1) - fwd_plain
    fwd_b, fwd_by = bound_ms(*sinkhorn_work(Bn, n, m, S + 1, 0))
    it_b, it_by = bound_ms(*sinkhorn_work(Bn, n, m, S, 0))
    bwd2_b, bwd_by = bound_ms(*sinkhorn_work(Bn, n, m, 0, 2))
    bwd1_b, _ = bound_ms(*sinkhorn_work(Bn, n, m, 0, 1))
    log(f"sinkhorn {Bn}x{n}x{m}, {S} temperatures: forward ok (max err "
        f"{err_fwd:.3g}); kernel {fwd_ms:.3f} ms, plain {fwd_plain:.3f} ms, bound "
        f"{fwd_b:.4f} ms ({fwd_by}, the exponentials)")
    log(f"sinkhorn_iterates: ok (max err {err_it:.3g}); kernel {it_ms:.3f} ms, "
        f"plain {it_plain:.3f} ms, bound {it_b:.4f} ms ({it_by})")
    log(f"sinkhorn_bwd: ok against the f64 gradient (max err {err_bwd:.3g}, "
        f"{rel_bwd:.2g} of the largest entry; the f32 plain version {rel_plain:.2g}); "
        f"both cotangents: kernel "
        f"{bwd2_ms:.3f} ms, plain autograd {bwd2_plain:.3f} ms, bound {bwd2_b:.4f} "
        f"ms; f alone: kernel {bwd1_ms:.3f} ms, plain {bwd1_plain:.3f} ms, bound "
        f"{bwd1_b:.4f} ms ({bwd_by})")
    # row 11 has no caller on the pipeline: its entry point is driven once
    # here, counted
    _, launches = counted(lambda: cs.sinkhorn_iterates(x, y, schedule))
    torch.cuda.synchronize()
    per_launch = {
        "sinkhorn": {"ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_b},
        "sinkhorn_bwd_both": {"ms": bwd2_ms, "plain_ms": bwd2_plain, "bound_ms": bwd2_b},
        "sinkhorn_bwd_f_only": {"ms": bwd1_ms, "plain_ms": bwd1_plain, "bound_ms": bwd1_b},
        "sinkhorn_iterates": {"ms": it_ms, "plain_ms": it_plain, "bound_ms": it_b},
    }
    report["sinkhorn_per_launch"] = per_launch
    report["sinkhorn_iterates"] = {
        "shape": [Bn, n, m, S], "launches": launches["sinkhorn_iterates"],
        **per_launch["sinkhorn_iterates"], "bound_by": it_by,
        "max_abs_err": err_it, "library_ms": None}
    return per_launch, {"sinkhorn": err_fwd, "sinkhorn_bwd": err_bwd}, (fwd_by, bwd_by)


def phase_optim(torch, report, state, profile: bool):
    """The refinement path at full width: PipelineConfig(optim=True) on 8
    scenes x 8 objects x 1024 points (no FPS front end), the fused encoder
    and the 8 x 768 decoder with the trained weights."""
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.ops import sinkhorn
    from livingscenes_tpu_torch.solver.matcher import sequential_matcher
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline)
    from livingscenes_tpu_torch.solver.registration import (
        RegistrationConfig, solve_pairwise_registration)

    tag = "optim"
    cfg = ShapePriorConfig(pallas_attention=True)
    model = ShapePrior(cfg, device="cuda")
    model.load_state_dict(state)
    ref_np, res_np = make_scenes(np.random.default_rng(0), n_pts=N_PCL)
    ref, res = (torch.as_tensor(a, device="cuda") for a in (ref_np, res_np))

    def pipeline(m, n_steps, **reg):
        return build_scene_pair_pipeline(m, PipelineConfig(
            optim=True, registration=RegistrationConfig(n_steps=n_steps, **reg)))

    # warm-up, which also records the first step's Sinkhorn inputs
    seen = []
    real = sinkhorn.ot_extrapolated_potentials

    def recorder(x, y, schedule):
        if x is not y and not seen:
            seen.append((x.detach().clone(), y.detach().clone(), tuple(schedule)))
        return real(x, y, schedule)

    sinkhorn.ot_extrapolated_potentials = recorder
    try:
        pipeline(model, REFINE_WARMUP_STEPS)(ref, res)
    finally:
        sinkhorn.ot_extrapolated_potentials = real
    torch.cuda.synchronize()
    x, y, schedule = seen[0]
    log(f"{tag}: Sinkhorn schedule of the refinement: {len(schedule)} temperatures "
        f"{schedule[0]:.4g} .. {schedule[-1]:.4g}")
    per_launch, errs, (fwd_by, bwd_by) = phase_sinkhorn(torch, report, x, y, schedule)
    del x, y, seen

    # the timed call
    torch.cuda.reset_peak_memory_stats()
    pipe = pipeline(model, REFINE_STEPS)

    def one_call():
        t0 = time.perf_counter()
        out = pipe(ref, res)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with forbid_plain():
        (out, call_ms), launches = counted(one_call)
    launches = {k: v for k, v in launches.items() if v}
    n_enc = len(KNN_LAYERS)
    want = {"fps": 2 * len(FPS_ENCODER), "knn": 2 * (n_enc - 1),
            "icp_stats": ICP_ITERS, "knn_topk": 2, "layer0": 2, "edge_mean": 2,
            "edge_attention": 2 * (n_enc - 2),
            "sinkhorn": 1 + 2 * REFINE_STEPS, "sinkhorn_bwd": 2 * REFINE_STEPS}
    log(f"{tag}: pipeline launches {launches}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    R, t, m0 = out["R"], out["t"], out["matches0"]
    if not (bool(torch.isfinite(R).all()) and bool(torch.isfinite(t).all())):
        raise AssertionError(f"{tag}: non-finite R or t")
    for s in range(N_SCENES):
        if sorted(m0[s].tolist()) != list(range(N_OBJ)):
            raise AssertionError(f"{tag}: scene {s}: matches0 {m0[s].tolist()} "
                                 "is not a permutation")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: pipeline {N_SCENES}x{N_OBJ}x{N_PCL}, n_steps={REFINE_STEPS}: "
        f"{call_ms:.1f} ms the call, {N_SCENES / (call_ms / 1e3):.4f} scene-pairs/s, "
        f"peak memory {peak_gb:.2f} GB")

    # stage times: host clock, each ended by a sync
    S, O = N_SCENES, N_OBJ
    flat_ref, flat_res = ref.reshape(S * O, N_PCL, 3), res.reshape(S * O, N_PCL, 3)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    with torch.no_grad():
        codes = timed("encode", lambda: (model.encode(flat_ref), model.encode(flat_res)))
        m = timed("match", lambda: sequential_matcher(
            codes[0]["z_inv"].reshape(S, O, -1),
            codes[1]["z_inv"].reshape(S, O, -1))["matches0"])
        part = (m.clamp_min(0) + torch.arange(S, device=m.device)[:, None] * O).reshape(-1)
        pc2 = flat_res[part]
        c2 = {k: v[part] for k, v in codes[1].items()}
        timed("refine", lambda: solve_pairwise_registration(
            model, flat_ref, pc2, codes[0], c2, optim=True,
            cfg=RegistrationConfig(n_steps=REFINE_STEPS, icp_iterations=0)))
        timed("icp", lambda: solve_pairwise_registration(
            model, flat_ref, pc2, codes[0], c2, cfg=RegistrationConfig()))
    stages["refine_ms_per_step"] = stages["refine"] / REFINE_STEPS
    log(f"{tag}: stages (ms, host clock with sync; refine = direction pick + "
        f"{REFINE_STEPS} steps, no ICP): " + json.dumps(stages))
    result = {"scenes": S, "objects": O, "points": N_PCL, "n_steps": REFINE_STEPS,
              "ms_per_call": call_ms, "scene_pairs_per_s": S / (call_ms / 1e3),
              "launches": launches, "stages_ms": stages, "peak_mem_gb": peak_gb}

    if profile:
        from torch.profiler import ProfilerActivity

        n_prof = 20
        reg = RegistrationConfig(n_steps=n_prof, icp_iterations=0)
        with torch.no_grad():
            solve_pairwise_registration(model, flat_ref, pc2, codes[0], c2, optim=True, cfg=reg)
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solve_pairwise_registration(
                    model, flat_ref, pc2, codes[0], c2, optim=True, cfg=reg)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        st = kernel_summary(torch, prof, wall)
        result["profile_refine"] = {"n_steps": n_prof, **st}
        log(f"{tag}: profile of {n_prof} refine steps: wall {wall:.1f} ms, device "
            f"{st['device_ms']:.1f} ms ({st['busy']:.1%} busy), {st['kernels']} kernel "
            "launches; top: "
            + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in st["top"][:8]))

    # scene 0 at a few steps, card against CPU through the plain versions
    cpu_model = ShapePrior(cfg, device="cpu")
    cpu_model.load_state_dict(state)
    checks = {}
    for name, reg in (("refine only", dict(icp_iterations=0)), ("refine + icp", {})):
        card = pipeline(model, REFINE_CPU_STEPS, **reg)(ref[:1], res[:1])
        t0 = time.perf_counter()
        cpu = pipeline(cpu_model, REFINE_CPU_STEPS, **reg)(ref_np[:1], res_np[:1])
        cpu_s = time.perf_counter() - t0
        if not torch.equal(card["matches0"].cpu(), cpu["matches0"]):
            raise AssertionError(f"{tag}: matches0 differs between card and CPU")
        dR = float((card["R"].cpu() - cpu["R"]).abs().max())
        dt = float((card["t"].cpu() - cpu["t"]).abs().max())
        checks[name] = {"max_abs_dR": dR, "max_abs_dt": dt}
        log(f"{tag}: card vs cpu on scene 0, n_steps={REFINE_CPU_STEPS}, {name}: "
            f"matches0 equal, max|dR| {dR:.3g}, max|dt| {dt:.3g} (cpu run {cpu_s:.1f} s)")
        # f32 rounding carried through Adam steps, whose normalized update
        # amplifies it: 1e-4 measured after the refinement alone, 4.9e-4
        # after ICP as well (NVIDIA H100 80GB HBM3); the bound is four times
        # the larger
        if dR > 2e-3:
            raise AssertionError(f"{tag}: {name}: R differs from the CPU run by {dR}")
    # does the direction pick ever differ between card and CPU?
    with torch.no_grad():
        flips = 0
        picks = []
        for mdl, dev in ((model, "cuda"), (cpu_model, "cpu")):
            a = torch.as_tensor(ref_np[0], device=dev)
            b = torch.as_tensor(res_np[0], device=dev)
            ca, cb = mdl.encode(a), mdl.encode(b)
            mm = sequential_matcher(ca["z_inv"][None], cb["z_inv"][None])["matches0"][0]
            cb = {k: v[mm.clamp_min(0)] for k, v in cb.items()}
            e1 = mdl.decode_sdf(a, ca).abs().mean(-1)
            e2 = mdl.decode_sdf(b[mm.clamp_min(0)], cb).abs().mean(-1)
            picks.append(((e1 >= e2).cpu(), (e1 - e2).cpu()))
        flips = int((picks[0][0] != picks[1][0]).sum())
        margin = float(picks[1][1].abs().min())
    log(f"{tag}: direction pick on scene 0: {picks[0][0].tolist()} on the card, "
        f"{flips} of {N_OBJ} differ from the CPU (smallest |err1 - err2| {margin:.3g})")
    result["cpu_check"] = {**checks, "steps": REFINE_CPU_STEPS,
                           "direction_pick_flips": flips,
                           "direction_pick_margin": margin}
    report["pipeline_optim"] = result

    n_fwd, n_bwd = launches["sinkhorn"], launches["sinkhorn_bwd"]
    fwd = per_launch["sinkhorn"]
    report["sinkhorn"] = {
        "launches": n_fwd, "bound_by": fwd_by, "max_abs_err": errs["sinkhorn"],
        "library_ms": None, **{k: n_fwd * v for k, v in fwd.items()}}
    # each step runs one backward with both cotangents (xy) and one with f
    # alone (xx)
    both, f_only = per_launch["sinkhorn_bwd_both"], per_launch["sinkhorn_bwd_f_only"]
    report["sinkhorn_bwd"] = {
        "launches": n_bwd, "bound_by": bwd_by, "max_abs_err": errs["sinkhorn_bwd"],
        "library_ms": None,
        **{k: n_bwd / 2 * (both[k] + f_only[k]) for k in both}}


def kernel_summary(torch, prof, wall_ms: float) -> dict:
    """What a finished torch.profiler run saw on the card during `wall_ms`
    of host time: the device ms its kernels took, the busy share, the count
    of kernel launches, and the kernels that took the most device time.
    Kernel events only: the CPU op that launched a kernel also reports its
    time, which would count it twice."""
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k[:60], ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda row: -row[1])
    dev = sum(row[1] for row in rows)
    return {"wall_ms": wall_ms, "device_ms": dev,
            "busy": dev / wall_ms if wall_ms else 0.0,
            "kernels": sum(row[2] for row in rows), "top": rows[:12]}


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
        out[name] = kernel_summary(torch, prof, wall)
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

    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "build": {"nvcc_seconds": _cuda.build_seconds, "ptxas": ptxas}}
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
    phase_scale(torch, report, state, pc[:, :N_RAGGED].contiguous())
    phase_optim(torch, report, state, args.profile)

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
        "scale": ("livingscenes_tpu_torch/csrc/scale.cu",
                  "livingscenes_tpu/ops/pallas_scale.py:31"),
        "sinkhorn": ("livingscenes_tpu_torch/csrc/sinkhorn.cu",
                     "livingscenes_tpu/ops/pallas_sinkhorn.py:119"),
        "sinkhorn_bwd": ("livingscenes_tpu_torch/csrc/sinkhorn.cu",
                         "livingscenes_tpu/ops/pallas_sinkhorn.py:149"),
        "sinkhorn_iterates": ("livingscenes_tpu_torch/csrc/sinkhorn.cu",
                              "livingscenes_tpu/ops/pallas_sinkhorn.py:48"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        # times of the launches that `launches` counts: the fused path's
        r = {**r, **r.get("fused_path", {})}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            # rows 1-7: the fused-encoder pipeline's count; the later rows
            # carry the count of the path that runs them
            "replaces": replaces, "launches": r.get("launches", launches.get(name)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels that their path never launched: {idle}")
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
