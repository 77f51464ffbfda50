#!/usr/bin/env python3
"""Smoke run of the PyTorch port (livingscenes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit; TF32 is switched off for matmuls and cuDNN.
2. Builds the CUDA kernels from livingscenes_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes the default-config scene-pair pipeline gives it, and times the
   kernel, the plain version, one PyTorch library call where one computes
   the same function, and the least time the card could take (the bound).
4. Runs the default-config pipeline (FPS -> encode -> match -> Kabsch ->
   ICP) at full width with the trained checkpoint
   weights/production_r5_selected.ckpt on 8 scenes x 8 objects x 4096
   points, checks that its outputs are finite and that the launch counts
   show every kernel ran, times it, and reruns scenes 0-1 on the CPU with
   the plain versions to compare.
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


def phase_knn(torch, report):
    from livingscenes_tpu_torch.ops import cuda_knn
    from livingscenes_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(2)
    k = 16
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    rows, max_err = [], 0.0
    for nq, np_, c in KNN_LAYERS:
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
        swapped = ik != ip
        if bool(swapped.any()):
            # a swap is allowed only between near-equal true distances
            def exact(idx):
                nb = torch.gather(
                    p.double(), 1, idx.reshape(B, -1, 1).expand(-1, -1, D)
                ).reshape(B, nq, k, D)
                return torch.sum((q.double()[:, :, None] - nb) ** 2, -1)

            rows_sw = swapped.any(-1)
            de, dq = exact(ik)[rows_sw], exact(ip)[rows_sw]
            if bool(((de - dq).abs() > 1e-5 * (q2[rows_sw] + dq)).any()):
                raise AssertionError(f"knn {nq}x{np_}x{D}: bad index swap")
        if bool((torch.sort(ik, -1).values.diff(dim=-1) == 0).any()):
            raise AssertionError(f"knn {nq}x{np_}x{D}: repeated index")
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
        rows.append({"shape": [B, nq, np_, D], "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "swapped": int(swapped.sum()),
                     "max_abs_err": float(err.max())})
        log(f"knn {B}x{nq}x{np_}x{D}: ok ({int(swapped.sum())} swaps); "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms, cdist+topk {lib:.3f}"
            f" ms, bound {bms:.4f} ms ({by})")
    report["knn"] = {"shapes": rows, **total, "max_abs_err": max_err,
                     "bound_by": "operations"}


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


def phase_pipeline(torch, report, profile: bool):
    from livingscenes_tpu_torch.models.convert import (
        load_flax_checkpoint, params_from_jax)
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior
    from livingscenes_tpu_torch.ops import cuda_fps, cuda_icp, cuda_knn
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline)

    state = params_from_jax(load_flax_checkpoint(CKPT))
    model = ShapePrior(device="cuda")
    model.load_state_dict(state)
    pipe = build_scene_pair_pipeline(model, PipelineConfig(encode_fps=True))
    ref_np, res_np = make_scenes(np.random.default_rng(0))
    mask_np = np.ones(ref_np.shape[:3], bool)
    ref, res = (torch.as_tensor(a, device="cuda") for a in (ref_np, res_np))
    mask = torch.as_tensor(mask_np, device="cuda")

    pipe(ref, res, mask, mask)  # warm-up
    torch.cuda.synchronize()
    for mod in (cuda_fps, cuda_knn, cuda_icp):
        mod.launches = 0
    out = pipe(ref, res, mask, mask)
    torch.cuda.synchronize()
    launches = {"fps": cuda_fps.launches, "knn": cuda_knn.launches,
                "icp_stats": cuda_icp.launches}
    log(f"pipeline launches: {launches}")
    want = {"fps": 8, "knn": 14, "icp_stats": ICP_ITERS}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    R, t, m0 = out["R"], out["t"], out["matches0"]
    if not (bool(torch.isfinite(R).all()) and bool(torch.isfinite(t).all())):
        raise AssertionError("non-finite R or t")
    for s in range(N_SCENES):
        if sorted(m0[s].tolist()) != list(range(N_OBJ)):
            raise AssertionError(f"scene {s}: matches0 {m0[s].tolist()} "
                                 "is not a permutation")

    samples = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(ref, res, mask, mask)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    call_ms = float(np.median(samples))
    pairs_per_s = N_SCENES / (call_ms / 1e3)
    log(f"pipeline {N_SCENES}x{N_OBJ}x{N_FULL}: median {call_ms:.2f} ms per "
        f"call over {len(samples)} calls (min {min(samples):.2f}, max "
        f"{max(samples):.2f}), {pairs_per_s:.3f} scene-pairs/s")

    stages = stage_times(torch, model, ref, res, mask)
    log("stages (ms, host clock with sync): " + json.dumps(stages))
    if profile:
        report["profile"] = stage_times(torch, model, ref, res, mask, profile=True)
        for name, st in report["profile"].items():
            log(f"profile {name}: wall {st['wall_ms']:.2f} ms, device "
                f"{st['device_ms']:.2f} ms ({st['busy']:.1%} busy), "
                f"{st['kernels']} kernel launches; top: "
                + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in st["top"][:6]))

    # scenes 0-1 again on the CPU, through the plain versions
    cpu_model = ShapePrior(device="cpu")
    cpu_model.load_state_dict(state)
    cpu_pipe = build_scene_pair_pipeline(cpu_model, PipelineConfig(encode_fps=True))
    t0 = time.perf_counter()
    cpu_out = cpu_pipe(ref_np[:2], res_np[:2], mask_np[:2], mask_np[:2])
    cpu_s = time.perf_counter() - t0
    m_cpu = cpu_out["matches0"]
    if not torch.equal(m_cpu, m0[:2].cpu()):
        raise AssertionError(f"matches0 card {m0[:2].tolist()} vs cpu "
                             f"{m_cpu.tolist()}")
    dR = float((R[:2].cpu() - cpu_out["R"]).abs().max())
    dt = float((t[:2].cpu() - cpu_out["t"]).abs().max())
    log(f"card vs cpu on scenes 0-1: matches0 equal, max|dR| {dR:.3g}, "
        f"max|dt| {dt:.3g} (cpu run {cpu_s:.1f} s)")
    if dR > 1e-3:
        raise AssertionError(f"R differs from the CPU run by {dR}")
    report["pipeline"] = {
        "scenes": N_SCENES, "objects": N_OBJ, "points": N_FULL,
        "ms_per_call": call_ms, "call_ms_samples": samples,
        "scene_pairs_per_s": pairs_per_s,
        "launches": launches, "stages_ms": stages,
        "cpu_check": {"max_abs_dR": dR, "max_abs_dt": dt},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return launches


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

    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    phase_fps(torch, report)
    phase_knn(torch, report)
    phase_icp(torch, report)
    launches = phase_pipeline(torch, report, args.profile)

    sources = {
        "fps": ("livingscenes_tpu_torch/csrc/fps.cu",
                "livingscenes_tpu/ops/pallas_fps.py:33"),
        "knn": ("livingscenes_tpu_torch/csrc/knn.cu",
                "livingscenes_tpu/ops/pallas_knn.py:29"),
        "icp_stats": ("livingscenes_tpu_torch/csrc/icp_stats.cu",
                      "livingscenes_tpu/ops/pallas_icp.py:69"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
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
