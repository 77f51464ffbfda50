#!/usr/bin/env python3
"""Smoke run of the PyTorch port (livingscenes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json] [--profile]

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit; TF32 is switched off for matmuls and cuDNN.
2. Builds the CUDA kernels from livingscenes_tpu_torch/csrc with nvcc.
3. Holds each of the first eleven kernels against its plain PyTorch version on
   the card at the shapes the scene-pair pipeline gives it, and times the
   kernel, the plain version, one PyTorch library call where one computes
   the same function, and the least time the card could take (the bound).
   The fused edge layers (layer 0, mean edge, attention at its five layer
   shapes) get the trained weights and the activations of a plain forward
   of the trained model; the mean edge and attention layers are timed
   whole and their per-point products alone, beside the bytes their edge
   passes gather. The kNN + scale, layer 0, mean edge, ICP statistics, kNN
   and FPS kernels are timed by CUDA graph replays (their wrappers' host time
   would show), and the ICP statistics must give the same bits on a
   second launch. The kNN + scale kernel's graph must equal the plain
   version's exactly (the same distance bits), also past the 4096 points
   it once refused (4352 and 8192), and an encode of 8 x 8192 points
   through it must give the codes of the plain front end. FPS
   runs the front end's two batches as one stacked launch (timed beside the
   two launches it replaces) and is also checked from a random start index.
   Every kernel is also checked, untimed, at small ragged shapes (K < 16,
   partial tiles, repeated sources, exact ties; kNN at each query tile, FPS
   in each form, from a start index, stacked, and past its registers at
   12288 points, and through ops/fps.py fps_subsample_with_features; the
   kNN + scale and scale kernels past one column chunk and past 4096
   points).
4. Runs the fused-encoder pipeline (ShapePriorConfig(pallas_attention=True):
   FPS -> kNN+scale -> fused encoder -> match -> Kabsch -> ICP) at full
   width with the trained checkpoint weights/production_r5_selected.ckpt
   on 8 scenes x 8 objects x 4096 points, checks that its outputs are
   finite, that the launch counts show every kernel ran and that no plain
   version ran, times it, and reruns scenes 0-1 on the CPU with the plain
   versions to compare. Then runs the default-config pipeline
   (pallas_attention=False) on the same scenes with the same checks and
   one timed call, and holds the two configurations against each other.
   Then the reconstruction leg (phase_recon): PipelineConfig(encode_fps=
   True, recon=True) with every recon default (res0 32 -> 129^3 grids,
   packsort, dedup, host merge, f32) on 2 scene pairs x 8 procedural shapes
   x 4096 points with the trained checkpoint and the fused encoder: a
   warm-up call and 3 timed calls (the first with the launch counts held to
   the fused main path's and every plain version forbidden), the stages'
   host ms and, under torch.profiler, device ms and launches (the grid
   stage split into level-0 decode, selection, refine decodes and
   scatter), peak memory, the decoder's f32 flops and their share of 67
   TFLOP/s, extract_scene_meshes with its stats (at least 90 % of the
   matched instances must give a mesh), scene-pairs/s with and without
   the host stage, scene 0's first two matched instances against the CPU
   from the same codes (overflow equal, selection equal or each difference
   witnessed by a corner near the threshold, values within 1e-4 of the
   grid's magnitude, unsimplified meshes within 0.5 voxel), and one
   recon_bf16 call whose unsimplified meshes must lie within half a voxel
   of a 33^3 grid of the f32 ones (tests/test_recon.py's bound as a
   length: 2 voxels at 129^3), with that test's own check, 33^3 grids
   within 0.5 voxel, run on the card from the same codes.
5. The scale kernel: against its plain version at 64 x 1000 points (one
   cloud a lattice full of exact ties), then one encode of 64 x 1000 points
   with pallas_attention=True (N no multiple of 256: the scale kernel and
   the encoder's own layer-0 kNN) against the CPU on the first 16 clouds,
   with the kNN graphs and FPS picks of every layer compared: clouds whose
   graphs are equal on both sides are held to 1e-4, the others are named
   with the first layer that differs, and that difference must be a
   near-tie by an f64 witness (knn_tie_witness, fps_tie_witness).
6. The refinement path, PipelineConfig(optim=True) on 8 scenes x 8 objects x
   1024 points with the fused encoder, the 8 x 768 decoder and the trained
   checkpoint: a warm-up call of 3 steps, whose first Sinkhorn inputs (the
   moved sources and their targets) the three Sinkhorn kernels are then
   held against their plain versions on (forward, iterates, and the
   backward against autograd of the plain forward, repeated bit for bit;
   the forward runs each pair on a thread-block cluster, whose size is
   logged), also past the N + M <= 8192 they once refused (2 x 6144 x 4096
   and 1 x 12288 x 8192, the sides in tiles of 4096); one timed call at
   n_steps=400 with the launch counts checked (801 Sinkhorn forwards, 800
   backwards) and every plain version forbidden; stage times; one call and
   the refine stage with refine_bf16 (R and t finite, ms a step and the
   largest R deviation against f32); scene 0 at
   n_steps=10 against the CPU (objects whose clouds' kNN graphs or FPS
   picks differ between the two are named, their first difference must be
   a near-tie by the f64 witness, and they are held to 5e-2 after the
   refinement alone, like every object to 2e-3 after ICP).
7. The MORE solver (phase_more): MoreSolver and accumulate_and_optimize
   through their own entry points at full width with the r5 checkpoint and
   MoreSolverConfig() defaults: solve_end2end on each of the 8 scenes
   (launch counts checked, plain versions forbidden, timed), scene 0
   against the CPU and all 8 against the batched pipeline; the default
   encoder config; n_init=4 restarts; optim=True at 400 steps (801 and 800
   Sinkhorn launches) and at 10 steps against the CPU; meshes, 200 steps
   of optimize_code, and 20 against the CPU, on procedural shapes; the
   joint optimisation of 3 scans (FPS at 12288 points). Its bounds are
   in its docstring. Then the port's end-to-end demo (phase_demo,
   scripts/torch_demo_end2end.py at its defaults: 4 boxes x 1024 points,
   129^3 meshes), with and without --optim, held to a CPU solve, its
   artifacts checked.
8. The training path (kernel rows 12-14, the backward kernels of layer 0,
   the mean edge layer and vector attention). Each backward kernel is held
   against the plain VJP (autograd of its plain forward, in f64) on the
   trained model's activations at the encoder's seven layer shapes with a
   random cotangent that leaves out the activations whose slope f32 cannot
   decide, timed, and at small ragged shapes (in 3.). Then
   livingscenes_tpu_torch.train.run.main runs configs/production_r5.yaml
   (full width, batch 64) from the r5 checkpoint for 20 steps with the
   launch counts checked (the mean-edge and attention backwards' edge
   passes and, apart, the five launches of per-point products and
   reductions of each), every plain
   version forbidden and the backward kernels' launches timed as they run;
   from its state
   the step is timed (data, forward, backward, optimizer; peak memory), one
   step at batch 8 is held against the CPU, a checkpoint makes a round
   trip, and 30 steps from a fresh init must lower the loss.
9. The evaluation suite (phase_eval): the port's FlyingShape drivers on
   the capstone benchmark of scripts/torch_demo_trained_eval.py (24
   scenes x 4 procedural shapes x 1024 points, analytic ground-truth
   meshes) with the r5 checkpoint: matching, relocalization, the refined
   relocalization on the first 12 scenes, and reconstruction, with exact
   launch counts, every plain version forbidden, and the metrics held to
   the JAX package's scores within the bounds of its docstring: the
   float32 record docs/demo_trained_eval_r5_96inst_jax_cpu.json, and for
   the refined relocalization its recall and float32's floors.
10. Training on the production ShapeNet configuration and the mesh-vertex
   refinement (phase_shapenet): a tree of 14 procedural objects made with
   the port's tools/preprocess.py, train.run.main on
   configs/production_shapenet.yaml from the r5 checkpoint for 10 steps
   (exact launch counts, no plain version), the step timed and split, one
   step against the CPU as trained and with rot_aug, decoder_bf16 and the
   class head, a visualize_sample firing, the anomaly mode naming a
   poisoned module, and 30 refinement steps on r5 meshes (card against
   CPU). Its bounds are in its docstring.
11. The rest of the model zoo (phase_variants): the attention encoder's
   options (center_pred=False, center_pred_scale=False, z_so3_as_Omtx with
   the fused kernels; mixed_precision without), the five ablation encoders
   under both values of pallas_attention (row 2's launches counted: 1, 5,
   3, 0, 0 an encode), each card against CPU; train.run.main with
   center_pred: false and decoder_type: inner from a fresh init (launches
   a step as TRAIN_STEP_LAUNCHES, timed), decoder_type deepsdf's step equal
   to inner_deepsdf's bit for bit; the ONet decoders and
   extract_surface_points, card against CPU. Its bounds are in its
   docstring.
12. Data parallelism over torch.distributed (phase_sharded): two gloo
   ranks on the one card (two nccl ranks must be refused) run the
   scene-sharded pipeline at full width against phase_pipeline's output,
   optim=True and recon=True at reduced depth, a qp-sharded MeshExtractor
   grid and two data-parallel training steps at batch 64, each against the
   unsharded run; then one nccl rank runs the pipeline through a mesh of
   size 1. Its bounds are in its docstring.
13. Prints a `kernels` JSON line (all 14 kernels), a line of headline
   figures, the card line, and as its last line {"ok": true, "device":
   {...}}.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
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
RECON_SCENES = 2  # scene pairs of the recon leg: bench.py:405's 16 grids
RECON_TIMED = 3  # timed recon calls after one warm-up
RECON_CPU_INSTANCES = 2  # scene 0's matched instances held against the CPU
RECON_SAMPLES = 20000  # surface samples a mesh for the chamfer
# recon/grid.py's profiler ranges
RECON_RANGES = ("recon.decode_level0", "recon.select", "recon.decode_refine",
                "recon.scatter")
REFINE_STEPS = 400
REFINE_WARMUP_STEPS = 3
REFINE_CPU_STEPS = 10  # steps of the card-against-CPU refinement check
EVAL_SCENES = 24  # the capstone benchmark: 24 scenes x 4 shapes x 1024 points
EVAL_OPTIM_SCENES = 12  # the refined relocalization on the first 12 (48 instances)
EVAL_RECORDS = {n: os.path.join(ROOT, "docs", f"demo_trained_eval_r5_{n}inst.json")
                for n in (96, 48)}
# the JAX package's scores of the same benchmark on the CPU, in float32
# (scripts/capstone_jax_cpu_reference.py)
EVAL_RECORD_F32 = os.path.join(ROOT, "docs", "demo_trained_eval_r5_96inst_jax_cpu.json")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "production_r5.yaml")
TRAIN_STEPS = 20  # steps of train.run.main from the trained checkpoint
TRAIN_ITEMS = 128  # synthetic training items (the config has 8192)
TRAIN_TIMED_STEPS = 10  # timed steps after 3 of warm-up
TRAIN_FRESH_STEPS = 30  # steps from a fresh init whose loss must fall
TRAIN_CPU_BATCH = 8  # batch of the card-against-CPU step
# the card-against-CPU step's bounds: loss rtol, each component's gradient
# norm rtol, the smallest cosine of a parameter's gradient
CPU_CHECK_TOL = (1e-4, 1e-3, 0.999)
# decoder_bf16 rounds each of the decoder's nine layers to bfloat16 (8 bits
# of mantissa, 3.9e-3 a step): cuBLAS and the CPU sum in other orders, and
# an output that rounds the other way moves by one such step
CPU_CHECK_TOL_BF16 = (1e-2, 5e-2, 0.99)
SHAPENET_CONFIG = os.path.join(ROOT, "configs", "production_shapenet.yaml")
SHAPENET_STEPS = 10  # steps of train.run.main on the ShapeNet tree
# Rows of each category's one train and one val object in the split CSV: a
# training batch is 64 items and a validation batch 8, and the batch
# iterator drops a short batch (7 items would never make one).
SHAPENET_TRAIN_ROWS = 10
SHAPENET_VAL_ROWS = 2
SHAPENET_VIEWS = 12  # depth views an object (the config's dep_total_view)
# uniform and near-surface samples an object: tools/preprocess.py writes
# 100,000 of each; cut for the phase's time (the tree's build and the
# batches' reads)
SHAPENET_SAMPLES = 20000
SHAPENET_TIMED_STEPS = 5  # timed steps (and split steps) after 3 of warm-up
SHAPENET_GRID = 64  # isosurface grid of a procedural mesh
REFINE_MESH_STEPS = 30  # refinement_step of the mesh-vertex refinement check
REFINE_MESHES = 4  # procedural shapes meshed and refined on the card
# the card's refined vertices against the CPU's from the same mesh and draws,
# the largest difference over the box size (1.1): each step moves a vertex
# by at most sqrt(10) lr = 3.2e-4 a coordinate, 9.5e-3 in 30 steps
REFINE_TOL = 1e-4
VARIANT_CPU_CLOUDS = 4  # clouds of each encode's card-against-CPU check
ABLATION_CPU_CLOUDS = 2  # the same for the ablation encoders (float64 too)
VARIANT_TOL = 1e-4  # max|R - I| between card and CPU codes, equal graphs
VARIANT_SWAP_TOL = 5e-2  # the same after a witnessed near-tie swap
# mixed_precision: layers 0 and 1 round their operands to bfloat16 on both
# sides, so a float32 rounding difference of an operand that lies on a
# bfloat16 rounding boundary moves that operand by 2^-8 of itself. On the
# CPU alone, clouds moved by 1e-7 of themselves turn the r5 codes with
# mixed_precision by up to 2.8e-2 (max|R - I|; cpu_spread measures it each
# run): the card is held to the CPU within 5e-2, and the later layers'
# inputs differ by a few
# bfloat16 steps (1.4e-2 measured), not by float32 rounding, so a graph
# difference is backed by each side's pick being right on its own inputs
# with the inputs within 8 x 2^-8
MIXED_TOL = 5e-2
MIXED_INPUT_TOL = 8 * 2.0 ** -8
# row 2's launches an encode of each ablation encoder: VecDGCNN reuses its
# layer-0 graph, VecDGCNNV2 builds one a layer, DGCNN one a layer of three
ABLATION_KNN = {"vecdgcnn": 1, "vecdgcnn2": 5, "dgcnn": 3, "pointnet": 0, "pcnet": 0}
VARIANT_TRAIN_ITEMS = 64  # one batch of the center_pred: false / inner run
VARIANT_TRAIN_STEPS = 5  # steps of that run's train.run.main, counted
VARIANT_TIMED_STEPS = 5  # its timed (and split) steps after 3 of warm-up
ONET_POINTS = 2048  # queries a code of the ONet decoders' check
ONET_CPU_CODES = 8  # codes of it held against the CPU
UDF_POINTS = 20000  # extract_surface_points on the card (its default)
UDF_CPU_POINTS = 1000  # the decoder's field against the CPU at this size
# kernel launches of one training step: FPS at layers 2, 4, 5, a kNN graph
# per layer, each fused layer forward and backward (the layer-0 backward's
# edge pass and its fold; the mean-edge and the attention backward's edge
# passes each after two launches of per-point rows and before three of
# products and reductions, at layer 1 and at each of the five attention
# layers)
TRAIN_STEP_LAUNCHES = {"fps": 3, "knn": 7, "layer0": 1, "edge_mean": 1,
                       "edge_mean_products": 2,
                       "edge_attention": 5, "edge_attention_products": 10,
                       "layer0_bwd": 1, "layer0_bwd_fold": 1,
                       "edge_mean_bwd": 1,
                       "edge_mean_bwd_products": 5,
                       "edge_attention_bwd": 5,
                       "edge_attention_bwd_products": 25}
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
# Their VJPs (rows 12-14, see edge_work): the activation's VJP per edge and
# channel, the unit direction again (9), the cotangents of y.d and of the
# leaky part (12), of y (6), of the direction through its norm (30); the
# channel normalisation of K and the softmax (about 40 per channel, V's
# weighting included); at layer 0 the cross product's VJP and the dst^
# normalisation (about 60 per edge).
ACT_BWD_FLOPS = 57
ATTN_BWD_EXTRA_FLOPS = 40
L0_BWD_EDGE_FLOPS = L0_EDGE_FLOPS + 60


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


def graph_ms(torch, fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device milliseconds of one fn() call with no host work between calls:
    `per_graph` calls captured into one CUDA graph (after a warm-up on the
    capturing stream), the graph replayed `replays` times between events.
    For a kernel shorter than its wrapper's host time, which cuda_ms would
    measure instead."""
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
    """Row 1 at the fused call's shapes: the front end's two batches stacked
    in one launch (2B x 4096 -> 1024, masked: half a cloud padded, fewer
    valid points than k, a random mask), timed beside the two launches of B
    it replaces, and the encoder's three shapes (two launches each, one an
    encode). Indices bit-equal to the plain version, from index 0 and from
    a random start index per cloud."""
    from livingscenes_tpu_torch.ops import cuda_fps
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling

    rng = np.random.default_rng(1)
    shapes = ([(2 * B, N_FULL, N_PCL, True, 1)]
              + [(B, n, k, False, 2) for n, k in FPS_ENCODER])
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    rows = []
    for clouds, n, k, masked, calls in shapes:
        pts = torch.as_tensor(
            rng.uniform(-1, 1, (clouds, n, 3)).astype(np.float32), device="cuda"
        )
        mask = None
        if masked:
            m = np.ones((clouds, n), bool)
            m[1, n // 2:] = False  # half the points padded
            m[2, k // 2:] = False  # fewer valid points than k
            m[3] = rng.random(n) > 0.3
            mask = torch.as_tensor(m, device="cuda")
        start = torch.as_tensor(rng.integers(0, n, clouds), dtype=torch.int32,
                                device="cuda")
        for s in (None, start):
            got = cuda_fps.fps_cuda(pts, k, mask, s).long()
            want = farthest_point_sampling(
                pts, k, mask, start_idx=0 if s is None else s)[1]
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            if bad:
                raise AssertionError(f"fps {clouds}x{n}->{k} (start "
                                     f"{'random' if s is not None else 0}): "
                                     f"{bad} indices differ")
        # the kernel's device time (CUDA graph replays: at 32 picks the
        # wrapper's host time outlasts the kernel), and the wrapper's
        ms = graph_ms(torch, lambda: cuda_fps.fps_cuda(pts, k, mask))
        wrapper = cuda_ms(torch, lambda: cuda_fps.fps_cuda(pts, k, mask), 10)
        plain = cuda_ms(
            torch, lambda: farthest_point_sampling(pts, k, mask), 2, 1)
        flops = 8.0 * clouds * n * (k - 1)
        nbytes = clouds * n * 12 + (clouds * n if masked else 0) + clouds * k * 4
        bms, by = bound_ms(flops, nbytes)
        total["ms"] += calls * ms
        total["plain_ms"] += calls * plain
        total["bound_ms"] += calls * bms
        row = {"shape": [clouds, n, k], "masked": masked, "launches": calls,
               "ms": ms, "ns_a_round": ms * 1e6 / (k - 1), "wrapper_ms": wrapper,
               "plain_ms": plain, "bound_ms": bms, "bound_by": by}
        extra = ""
        if clouds == 2 * B:
            # the same work as two launches of B clouds, as the front end
            # made them before it stacked its batches
            halves = [(pts[:B].contiguous(), mask[:B].contiguous()),
                      (pts[B:].contiguous(), mask[B:].contiguous())]
            row["ms_two_launches"] = graph_ms(
                torch, lambda: [cuda_fps.fps_cuda(x, k, mm) for x, mm in halves])
            extra = f" (two launches of {B}: {row['ms_two_launches']:.4f} ms)"
        rows.append(row)
        log(f"fps {clouds}x{n}->{k} masked={masked}: exact from 0 and from a "
            f"random start; kernel {ms:.4f} ms{extra}, {row['ns_a_round']:.1f} "
            f"ns a round (the wrapper {wrapper:.4f} ms), plain {plain:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")
    report["fps"] = {"shapes": rows, **total, "max_abs_err": 0.0,
                     "library_ms": None, "bound_by": "operations",
                     "subsample_with_features": fps_subsample_check(torch, rng)}


def fps_subsample_check(torch, rng):
    """ops/fps.py fps_subsample_with_features at the encoder's first
    down-sampling (B x 1024 points, factor 2, features B x 1024 x 32 x 3):
    one FPS launch and no other by the counters; the indices those of the plain
    version, or each cloud's first difference a near-tie by
    fps_tie_witness; the points and features the gathers at the card's
    indices, bit for bit."""
    from livingscenes_tpu_torch.ops.fps import (
        farthest_point_sampling, fps_subsample_with_features)

    pts = torch.as_tensor(rng.uniform(-1, 1, (B, N_PCL, 3)).astype(np.float32),
                          device="cuda")
    feats = torch.as_tensor(rng.normal(size=(B, N_PCL, 32, 3)).astype(np.float32),
                            device="cuda")
    (sampled, got, idx), launches = counted(
        lambda: fps_subsample_with_features(pts, feats, 2))
    launches = {k: v for k, v in launches.items() if v}
    if launches != {"fps": 1}:
        raise AssertionError(f"fps_subsample_with_features: launches {launches}")
    want = farthest_point_sampling(pts, N_PCL // 2)[1]
    witnessed = []
    for b in torch.nonzero((idx != want).any(dim=1)).flatten().tolist():
        w = fps_tie_witness(torch, (idx, (pts,)), (want, (pts,)), b)
        log_witness(f"fps_subsample_with_features cloud {b}", "FPS", w)
        if not w["near_tie"]:
            raise AssertionError(f"fps_subsample_with_features: cloud {b} picks "
                                 "differ from the plain version's with no near-tie")
        witnessed.append(b)
    rows = torch.arange(B, device="cuda")[:, None]
    if not (torch.equal(sampled, pts[rows, idx]) and torch.equal(got, feats[rows, idx])):
        raise AssertionError("fps_subsample_with_features: the gathers differ")
    log(f"fps_subsample_with_features {B}x{N_PCL} -> {N_PCL // 2}, features 32x3: "
        f"1 FPS launch; indices equal to the plain version's"
        + (f" but for witnessed near-ties in clouds {witnessed}" if witnessed else "")
        + "; gathers equal")
    return {"launches": launches, "witnessed_clouds": witnessed}


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
        # the kernel's device time (CUDA graph replays) and the wrapper's
        ms = graph_ms(torch, lambda: cuda_knn.knn_cuda(q, p, k))
        wrapper = cuda_ms(torch, lambda: cuda_knn.knn_cuda(q, p, k), 20)
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
        rows.append({"shape": [B, nq, np_, D], "ms": ms, "wrapper_ms": wrapper,
                     "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "swapped": int(swapped.sum()),
                     "max_abs_err": float(err.max())})
        log(f"knn {B}x{nq}x{np_}x{D}: ok ({int(swapped.sum())} swaps); "
            f"kernel {ms:.4f} ms (the wrapper {wrapper:.4f}), plain {plain:.3f} "
            f"ms, cdist+topk {lib:.3f} ms, bound {bms:.4f} ms ({by})")
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
    # fixed-order sums: a second launch gives the same bits
    again = cuda_icp.icp_stats_cuda(x, src, tgt, active)
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        raise AssertionError("icp stats: a second launch differs")
    all_on = torch.ones_like(active)
    # the kernel is shorter than its wrapper's host time: its own time from
    # CUDA graph replays; the wrapper's, paced by the host, beside it
    ms = graph_ms(torch, lambda: cuda_icp.icp_stats_cuda(x, src, tgt, all_on),
                  50, 20)
    wrapper = cuda_ms(
        torch, lambda: cuda_icp.icp_stats_cuda(x, src, tgt, all_on), 200,
        warmup=20)
    plain = cuda_ms(torch, lambda: cuda_icp.icp_stats_plain(x, src, tgt, all_on), 5)
    lib = cuda_ms(torch, lambda: torch.min(torch.cdist(x, tgt), dim=-1), 5)
    flops = 8.0 * B * n * m + 30.0 * B * n
    nbytes = 4.0 * B * (2 * n + m) * 3 + B + 4.0 * 13 * B
    bms, by = bound_ms(flops, nbytes)
    log(f"icp stats {B}x{n}x{m}: ok (max err {max_err:.3g}; {n_amb} sources"
        f" nearest to several targets within rounding, {n_tied} exactly "
        f"tied sources averaged; a second launch bit-equal); kernel {ms:.5f}"
        f" ms (CUDA graph; the wrapper paced by the host {wrapper:.5f} ms), "
        f"plain {plain:.3f} ms, cdist+min {lib:.3f} ms, bound "
        f"{bms:.5f} ms ({by}) per launch, all pairs active")
    report["icp_stats"] = {
        "per_launch": {"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bms},
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


def lattice_cloud(torch, rng, dims):
    """A permuted, centred lattice of prod(dims) points on the card: its
    squared distances are exact in f32 and full of ties."""
    g = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                 -1).reshape(-1, 3)
    g = rng.permutation(g) - (np.asarray(dims) - 1) / 2
    return torch.as_tensor(g.astype(np.float32), device="cuda")


def check_knn_topk(torch, name, pc, k, k_top):
    """Row 4 against its plain version on the card: the graphs equal (the
    kernel computes the plain version's distance bits and orders by
    (distance, index), as the plain version's stable sort does), a point
    its own neighbour 0 where no other point coincides with it, the scale
    within 1e-5 rel. Returns (scale of the kernel, of the plain version)."""
    from livingscenes_tpu_torch.ops import cuda_knn

    Bn, n, _ = pc.shape
    ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, k, k_top)
    ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, k, k_top)
    torch.cuda.synchronize()
    scale_err = float(((sk - sp).abs() / sp).max())
    if not scale_err <= 1e-5:
        raise AssertionError(f"{name}: scale differs by {scale_err} rel")
    if not torch.equal(ik.long(), ip):
        rows = int((ik.long() != ip).any(-1).sum())
        raise AssertionError(f"{name}: the graph differs in {rows} rows")
    if not bool((ik[..., 0] == torch.arange(n, device="cuda")).all()):
        raise AssertionError(f"{name}: a point is not its own neighbour 0")
    return sk, sp


def phase_knn_topk(torch, report, pc, state):
    """Row 4 at the main path's shape: pc is the centred (B, 1024, 3)
    input of one encode. Cloud 1 is replaced by a permuted 16 x 8 x 8
    lattice, centred, whose squared distances are exact in f32 and full of
    ties; every cloud's graph must equal the plain version's exactly
    (check_knn_topk). Timed by CUDA graph replays. Then past the 4096
    points the kernel once refused: 4 clouds of 4352 points (ragged
    against the 512-column chunk) and of 8192, each with a lattice cloud,
    checked the same way; and one encode of 8 clouds of 8192 points with
    pallas_attention=True, whose codes must agree with those of the same
    encode through the plain front end on the card (held to 1e-4 of each
    code's largest magnitude, the scale to 1e-5 rel)."""
    from livingscenes_tpu_torch.models import shape_prior as sp
    from livingscenes_tpu_torch.ops import cuda_knn

    k, k_top = 16, 5
    Bn, n, _ = pc.shape
    rng = np.random.default_rng(4)
    pc = pc.clone()
    pc[1] = lattice_cloud(torch, rng, (16, 8, 8))
    sk, sp_ = check_knn_topk(torch, "knn_topk", pc, k, k_top)
    ms = graph_ms(torch, lambda: cuda_knn.knn_with_topk_scale_cuda(pc, k, k_top))
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
    log(f"knn_topk {Bn}x{n}x3: ok (graphs equal, scale rel err "
        f"{float(((sk - sp_).abs() / sp_).max()):.2g}); kernel {ms:.4f} ms "
        f"(graph replays), plain {plain:.3f} ms, cdist+topk x2 {lib:.3f} ms, "
        f"bound {bms:.4f} ms ({by})")
    calls = 2  # ref and rescan encodes
    report["knn_topk"] = {
        "shape": [Bn, n, 3], "per_launch": {
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms},
        "ms": calls * ms, "plain_ms": calls * plain,
        "library_ms": calls * lib, "bound_ms": calls * bms, "bound_by": by,
        "max_abs_err": float((sk - sp_).abs().max()), "past_old_cap": {},
    }

    # past the old cap of 4096 points
    for big, dims in ((4352, (17, 16, 16)), (8192, (32, 16, 16))):
        clouds = torch.as_tensor(
            rng.uniform(-0.5, 0.5, (4, big, 3)).astype(np.float32), device="cuda")
        clouds[2] = lattice_cloud(torch, rng, dims)
        check_knn_topk(torch, f"knn_topk N={big}", clouds, k, k_top)
        big_ms = graph_ms(
            torch, lambda: cuda_knn.knn_with_topk_scale_cuda(clouds, k, k_top),
            per_graph=5, replays=4)
        report["knn_topk"]["past_old_cap"][str(big)] = {
            "shape": [4, big, 3], "ms": big_ms}
        log(f"knn_topk 4x{big}x3: ok (graphs equal, a lattice cloud among "
            f"them); kernel {big_ms:.4f} ms (graph replays)")
        del clouds

    # an encode at 8192 points through the fused front end, against the
    # same encode through the plain front end on the card
    big = 8192
    ref_np, _ = make_scenes(np.random.default_rng(7), n_scenes=1, n_pts=big)
    x = torch.as_tensor(ref_np[0], device="cuda")
    model = sp.ShapePrior(sp.ShapePriorConfig(pallas_attention=True), device="cuda")
    model.load_state_dict(state)
    with torch.inference_mode():
        codes, launches = counted(lambda: model.encode(x))
        real = sp.knn_with_topk_scale
        sp.knn_with_topk_scale = cuda_knn.knn_with_topk_scale_plain
        try:
            plain_codes = model.encode(x)
        finally:
            sp.knn_with_topk_scale = real
        torch.cuda.synchronize()
    if launches["knn_topk"] != 1:
        raise AssertionError(f"encode at N={big}: launches {launches}")
    diffs = {}
    for key, val in codes.items():
        ref = plain_codes[key]
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"encode at N={big}: non-finite {key}")
        diffs[key] = float((val - ref).abs().max() / ref.abs().max())
    s_rel = float(((codes["s"] - plain_codes["s"]).abs() / plain_codes["s"]).max())
    log(f"encode {x.shape[0]}x{big}, pallas_attention=True: the kernel's front "
        f"end against the plain one on the card: max |diff| over max |value| "
        + ", ".join(f"{k_} {v:.3g}" for k_, v in diffs.items())
        + f"; s rel {s_rel:.3g}")
    if max(diffs.values()) > 1e-4 or s_rel > 1e-5:
        raise AssertionError(f"encode at N={big}: codes differ {diffs}, s {s_rel}")
    report["knn_topk"]["encode_8192"] = {"max_rel_diff": diffs, "s_rel": s_rel}
    del model, codes, plain_codes
    torch.cuda.empty_cache()


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


def edge_work(kind, args, backward=False, w_then_d=False):
    """(flops, bytes, (B, Ns, Nd, C, O, K)) that one call of a fused edge
    layer needs (see phase_fused_layers), or with `backward` its VJP: the
    forward again (the recompute), and by the same linearity, per source and
    destination point and branch, D^T on the direction cotangent summed over
    the point's edges and d_D's outer product of that sum with the point's
    half of y (D is linear: two O x O products, the recompute of D y being
    the forward's), and per source point the products of d_W_l and of d_src,
    and per destination point those of d_dst and the W_r - W_l half of d_W;
    per edge and channel the activation's VJP
    and, for attention, the channel normalisation's and the softmax's; at
    layer 0 the per-edge sums against W and D W (O x 3) and the cross
    product's VJP. Bytes: every argument (and the cotangent) read once,
    every result written once. The forward's products of a point's rows
    cost 6 C O + 6 O^2 flops a branch as W, then D, or 12 C O as one product
    by [W | D W] after D W (2 C O^2, once a call for each side's half of W):
    each side counts the cheaper, or with `w_then_d` the first (the earlier
    count, kept to compare)."""
    idx = args[1 if kind == "layer0" else 2]
    Bn, nd, K = idx.shape
    edges = float(Bn * nd * K)
    if kind == "layer0":
        C, O = 1, args[2].shape[0]
        ns = nd
        flops = (2.0 * O * O * 3
                 + edges * (L0_EDGE_FLOPS + O * L0_EDGE_CHANNEL_FLOPS))
        floats = Bn * ns * 3 + O * 3 + O * O
        if backward:
            flops += 2.0 * O * O * 3 * 2 + edges * (
                L0_BWD_EDGE_FLOPS + O * (ACT_BWD_FLOPS + 4 * 18))
        grads = Bn * ns * 3 + O * 3 + O * O
    else:
        ns, C = args[0].shape[1], args[0].shape[2]
        attn = kind == "edge_attention"
        branches = 2 if attn else 1
        O = args[4 if attn else 3].shape[0]
        w_d = 6.0 * C * O + 6.0 * O * O  # W y, then D (W y)
        stacked = 12.0 * C * O  # y [W | D W]
        products = sum(
            Bn * n * w_d if w_then_d
            else min(Bn * n * w_d, Bn * n * stacked + 2.0 * C * O * O)
            for n in (ns, nd))
        flops = (branches * products + edges * O * (
            ATTN_EDGE_CHANNEL_FLOPS if attn else MEAN_EDGE_CHANNEL_FLOPS))
        floats = (Bn * (ns + nd) * C * 3 + branches * (2 * C * O + O * O)
                  + (Bn * nd * O * 3 if attn else 0))
        if backward:
            # per point and branch: D^T d_kd and d_D's outer product; d_W_l
            # and d_src per source, d_dst and d_W_delta per destination point
            flops += (branches * Bn * (ns + nd) * (3 * O * O * 2 * 2
                                                  + 3 * C * O * 2 * 2)
                      + edges * O * (2 * ACT_BWD_FLOPS + ATTN_BWD_EXTRA_FLOPS
                                     if attn else ACT_BWD_FLOPS + 6))
        grads = floats
    out = Bn * nd * O * 3
    if backward:
        return flops, 4.0 * (floats + edges + out + grads), (Bn, ns, nd, C, O, K)
    return flops, 4.0 * (floats + edges + out), (Bn, ns, nd, C, O, K)


def phase_fused_layers(torch, report, calls):
    """Rows 5-7: each fused kernel against its plain version on the inputs
    `record_layer_calls` took from the trained model (layer 0, layer 1 and
    the five attention layers).

    The bound counts what the function needs, not what the kernels do. The
    edge convolution and the direction product are linear in the gathered
    rows, y[e] = (W_l src)[idx[e]] + ((W_r - W_l) dst)[n] and
    D y[e] = (D W_l src)[idx[e]] + (D (W_r - W_l) dst)[n], so both are needed
    once per source and per destination point and branch, not once per edge
    (the TPU kernels do them per edge; the mean-edge and attention kernels
    once per point, edge_stages), and where C < O more cheaply as one
    product by [W | D W] (edge_work); at layer 0 the pre-activation row is
    W (O, 3) times three vectors of the edge, so its direction is (D W)
    times the same three. Only the sum of the two halves, the activation,
    the softmax and the reduction over K are per edge. Bytes: every
    argument read once, the output written once. Each shape also keeps the
    bound that counts W, then D at every point (`bound_ms_w_then_d`, the
    earlier count)."""
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
                        "bound_ms": 0.0, "bound_ms_w_then_d": 0.0,
                        "max_abs_err": 0.0, "library_ms": None}
    with torch.inference_mode():
        for kind, args in calls:
            kernel, plain_fn = fns[kind]
            args = tuple(a.contiguous() if torch.is_tensor(a) else a
                         for a in args)
            flops, nbytes, (Bn, ns, nd, C, O, K) = edge_work(kind, args)
            want = plain_fn(*args)
            got = kernel(*args)
            torch.cuda.synchronize()
            shape = f"{kind} B={Bn} Ns={ns} Nd={nd} C={C} O={O} K={K}"
            err = check_close(shape, got, want)
            del got
            # rows 5 and 6 by graph replays (their launches are short enough
            # for the wrappers' host time to show), row 7 as before
            ms = (cuda_ms(torch, lambda: kernel(*args), 10)
                  if kind == "edge_attention"
                  else graph_ms(torch, lambda: kernel(*args), 10, 5))
            plain = cuda_ms(torch, lambda: plain_fn(*args), 3, 1)
            bms, by = bound_ms(flops, nbytes)
            bms_wd = bound_ms(edge_work(kind, args, w_then_d=True)[0], nbytes)[0]
            stages = (edge_stages(torch, kind, args, ms)
                      if kind != "layer0" else {})
            r = report[kind]
            r["shapes"].append({
                "shape": {"B": Bn, "Ns": ns, "Nd": nd, "C": C, "O": O, "K": K},
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "bound_ms_w_then_d": bms_wd, "bound_flops": flops,
                "bound_bytes": nbytes, "max_abs_err": err,
                "max_abs_want": float(want.abs().max()), **stages})
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms),
                           ("bound_ms_w_then_d", bms_wd)):
                r[key] += 2 * v  # ref and rescan encodes
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"{shape}: ok (max err {err:.3g}, max |want| "
                f"{float(want.abs().max()):.3g}); kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} "
                f"GFLOP, {nbytes / 1e6:.1f} MB; W, then D at every point "
                f"{bms_wd:.4f} ms)" + (
                    f"; products {stages['products_ms']:.3f} ms "
                    f"({stages['products_gflop']:.2f} GFLOP, "
                    f"{stages['products_bytes'] / 1e6:.0f} MB), edge pass and "
                    f"glue {stages['edges_ms']:.3f} ms "
                    f"({stages['edges_gathered_bytes'] / 1e9:.3f} GB gathered, "
                    f"{stages['edges_distinct_bytes'] / 1e6:.0f} MB distinct)"
                    if stages else ""))
            del want
    for kind in fns:
        largest = max(report[kind]["shapes"], key=lambda row: row["bound_ms"])
        report[kind]["bound_by"] = largest["bound_by"]


def edge_stages(torch, kind, args, total_ms):
    """The two stages of row 6 or 7 at one layer's inputs: the per-point
    products (mean_point_products_cuda or attention_point_products_cuda,
    timed alone the way the layer is timed; their flops, and their bytes:
    each operand read once, each product written once), and the rest of the
    wrapper's time (the edge pass and the wrapper's glue), with the bytes
    the edge pass gathers (the Y and Kd rows of each branch of each edge's
    source: 24 O bytes a branch) and the distinct bytes of the rows it
    reads."""
    from livingscenes_tpu_torch.nn import cuda_attention

    src, dst, idx = args[:3]
    Bn, ns, C, _ = src.shape
    nd, K = idx.shape[1], idx.shape[2]
    if kind == "edge_mean":
        W, D = args[3:5]
        O, branches = W.shape[0], 1
        W_l = W[:, :C].contiguous()
        W_delta = W[:, C:] - W_l
        ms = graph_ms(torch, lambda: cuda_attention.mean_point_products_cuda(
            src, dst, W_l, W_delta, D), 10, 5)
    else:
        W_K, D_K, W_V, D_V = args[4:8]
        O, branches = W_K.shape[0], 2
        W_l = torch.cat([W_K[:, :C], W_V[:, :C]], dim=0)
        W_delta = torch.cat([W_K[:, C:], W_V[:, C:]], dim=0) - W_l
        ms = cuda_ms(torch, lambda: cuda_attention.attention_point_products_cuda(
            src, dst, W_l, W_delta, D_K, D_V), 10)
    rows = 3.0 * Bn * (ns + nd)
    width = 2 * branches * O  # [Y | Kd] of each branch
    # D W for both halves of W and each branch, then every row times [W | D W]
    flops = 2.0 * (2 * branches * C * O * O + rows * C * width)
    floats = (rows * C + 2 * branches * C * O + branches * O * O
              + rows * width)
    return {"products_ms": ms, "products_gflop": flops / 1e9,
            "products_bytes": 4.0 * floats, "edges_ms": total_ms - ms,
            "edges_gathered_bytes": 24.0 * branches * O * Bn * nd * K,
            "edges_distinct_bytes": 4.0 * rows * width}


BWD = {"layer0": "layer0_bwd", "edge_mean": "edge_mean_bwd",
       "edge_attention": "edge_attention_bwd"}
BWD_TENSORS = {"layer0": 4, "edge_mean": 5, "edge_attention": 8}
BWD_CUDA = {"layer0": "fused_layer0_edge_mean_bwd_cuda",
            "edge_mean": "fused_edge_mean_bwd_cuda",
            "edge_attention": "fused_edge_attention_bwd_cuda"}


def bwd_fns():
    """kind -> (kernel, plain VJP) of rows 12-14."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0

    return {
        "layer0": (cuda_layer0.fused_layer0_edge_mean_bwd_cuda,
                   cuda_layer0.fused_layer0_edge_mean_bwd_plain),
        "edge_mean": (cuda_attention.fused_edge_mean_bwd_cuda,
                      cuda_attention.fused_edge_mean_bwd_plain),
        "edge_attention": (cuda_attention.fused_edge_attention_bwd_cuda,
                           cuda_attention.fused_edge_attention_bwd_plain),
    }


# An activation argument y.k^ within KINK_TAU of its rounding scale of 0 may
# take either side of the kink in f32 (see activation_kinks).
KINK_TAU = 1e-7


def activation_kinks(torch, kind, args):
    """[(B, N_dst, O) bool] per branch (K, then V for attention): the
    (destination, channel) pairs with an edge at which the so3 activation's
    argument y.k^ lies within f32 rounding of 0, from the layer's forward
    recomputed in f64. There the slope that f32 picks is a coin toss, and
    it moves the VJP by (1 - slope) times the activation's cotangent along
    k^: an O(1) change of the edge's rows that no tolerance separates from a
    fault. Rounding scale of y.k^: that of y (|W| times the norms of the
    vectors it sums, as the plain version forms the edge and as the kernels
    split it into the neighbour's and the destination's halves) plus |y|
    times the relative one of k^ (|D| times y's scale, over |k|). On the r5
    checkpoint's activations torch's f32 forward stays within 3e-8 of this
    scale (layer 0 1e-7); KINK_TAU leaves room for the kernels' own order
    of sums."""
    from livingscenes_tpu_torch.nn.cuda_layer0 import layer0_edge
    from livingscenes_tpu_torch.ops.knn import gather_neighbors

    a = [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
         for t in args]
    if kind == "layer0":
        xyz, idx = a[0], a[1]
        edge = layer0_edge(xyz[:, :, None], xyz[:, :, None], idx)
        nn_n = (edge[..., 1, :] + edge[..., 2, :]).norm(dim=-1)
        dst_n = edge[..., 2, :].norm(dim=-1)
        # cross(dst^, nn), nn - dst, dst
        size = torch.stack([nn_n, nn_n + dst_n, dst_n], dim=-1)
        pairs = [(a[2], a[3], lambda W: size @ W.abs().t())]
    else:
        src, dst, idx = a[:3]
        nn = gather_neighbors(src, idx.long())
        dst_pad = dst[:, :, None].expand_as(nn)
        edge = torch.cat([nn - dst_pad, dst_pad], dim=-2)
        nn_n, dst_n = nn.norm(dim=-1), dst_pad.norm(dim=-1)

        def y_scale(W):
            C = W.shape[1] // 2
            W_l, W_r = W[:, :C].abs(), W[:, C:].abs()
            return (nn_n @ (2 * W_l).t()
                    + dst_n @ (W_l + W_r + (W[:, C:] - W[:, :C]).abs()).t())

        weights = [a[3:5]] if kind == "edge_mean" else [a[4:6], a[6:8]]
        pairs = [(W, D, y_scale) for W, D in weights]
    masks = []
    for W, D, scale_of in pairs:
        y = torch.einsum("oc,...ci->...oi", W, edge)
        k = torch.einsum("oc,...ci->...oi", D, y)
        k_norm = k.norm(dim=-1).clamp_min(1e-300)
        arg = (y * k).sum(dim=-1) / k_norm
        ys = scale_of(W)
        scale = ys + y.norm(dim=-1) * (ys @ D.abs().t()) / k_norm
        del y, k
        masks.append((arg.abs() <= KINK_TAU * scale).any(dim=2))
    return masks


def neutralise_kinks(torch, kind, args, g):
    """(args, g, count): the inputs and cotangent of a backward check with
    no activation kink left in play (activation_kinks). The cotangent of a
    (destination, channel) whose activation sits at a kink is set to 0,
    which leaves that activation's VJP out of every gradient: at layer 0 and
    the mean-edge layer the channel's output is the mean of its edges, and
    in attention V's channel enters only the same output channel. K's
    channels all feed the softmax through the channel normalisation, so a
    kink in K sets the destination's query q_n to 0 instead: its attention
    is then uniform, and K receives no cotangent there. count: the
    (destination, channel) pairs of g and the destinations of q_n so
    set."""
    masks = activation_kinks(torch, kind, args)
    g = g.clone()
    g[masks[-1]] = 0.0
    count = int(masks[-1].sum())
    if kind == "edge_attention":
        rows = masks[0].any(dim=-1)
        q_n = args[3].clone()
        q_n[rows] = 0.0
        args = args[:3] + (q_n,) + args[4:]
        count += int(rows.sum())
    return args, g, count


def check_grads(torch, name, got, want, plain):
    """Raise unless every gradient in got (the kernel's) is finite and each
    entry lies, relative to the largest entry of want (the f64 plain VJP),
    within 1e-4 of want or of plain (the f32 plain VJP); an entry of a
    per-point gradient (one row a point) may instead lie within 1e-4 plus 8
    times plain's largest error in the same row. The caller takes the
    activation kinks out of play (neutralise_kinks). 1e-4 is a few times
    f32 rounding of sums of up to a million terms that cancel, in no fixed
    order (atomics). The row term: where a direction k = D y cancels to a
    small part of its terms, f32 loses digits in every VJP of the edges that
    reach the row, the kernel's and the plain version's alike, in different
    orders. Returns the largest errors of the kernel and of the f32 plain
    VJP, and the largest ratio of an entry's distance from both references
    to what it is allowed."""
    worst, worst_plain, worst_share = 0.0, 0.0, 0.0
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        w = w.double()
        top = max(float(w.abs().max()), 1e-30)
        err = (g.double() - w).abs() / top
        err_p = (p.double() - w).abs() / top
        gap = torch.minimum(err, (g.double() - p.double()).abs() / top)
        allowed = torch.full_like(gap, 1e-4)
        if w.dim() >= 3:
            row = err_p.flatten(2).amax(dim=-1)
            allowed = allowed + 8.0 * row.reshape(row.shape + (1,) * (w.dim() - 2))
        share = float((gap / allowed).max())
        if not bool(g.isfinite().all()) or share > 1.0:
            raise AssertionError(
                f"{name}: gradient {i}: max err {float(err.max()):.3g} of the largest "
                f"entry {top:.3g} (the f32 plain VJP {float(err_p.max()):.3g}), "
                f"{int((gap > allowed).sum())} entries past their allowance, up to "
                f"{share:.3g} times it")
        worst = max(worst, float(err.max()))
        worst_plain = max(worst_plain, float(err_p.max()))
        worst_share = max(worst_share, share)
    return worst, worst_plain, worst_share


def bwd_call(fn, kind, args, g, dtype=None):
    """fn(tensors..., g, rest...) with the tensors cast to dtype."""
    n = BWD_TENSORS[kind]
    tensors = [a.to(dtype) if dtype is not None and a.is_floating_point() else a
               for a in args[:n]]
    return fn(*tensors, g if dtype is None else g.to(dtype), *args[n:])


def phase_fused_layers_bwd(torch, report, calls):
    """Rows 12-14: each backward kernel against the plain VJP (autograd of
    the plain forward) on the inputs `record_layer_calls` took from the
    trained model, at a random cotangent the size of the layer's output,
    set to 0 at the destinations whose edges sit at an activation's kink
    (activation_kinks). Held to the f64 plain VJP as check_grads says, with
    the f32 plain VJP's own error beside the kernel's. Timed: the kernel
    wrapper (its glue included) and the plain VJP, which runs the plain
    forward again. The bound: edge_work(..., backward=True). Per step: one
    launch per layer."""
    fns = bwd_fns()
    rng = np.random.default_rng(11)
    for kind in fns:
        report[BWD[kind]] = {"shapes": [], "ms": 0.0, "plain_ms": 0.0,
                             "bound_ms": 0.0, "max_abs_err": 0.0,
                             "library_ms": None}
    for kind, args in calls:
        kernel, plain_fn = fns[kind]
        # contiguous clones: the recorded inputs are inference tensors, and
        # the weights among them the model's parameters
        args = tuple(a.detach().clone(memory_format=torch.contiguous_format)
                     if torch.is_tensor(a) else a for a in args)
        flops, nbytes, (Bn, ns, nd, C, O, K) = edge_work(kind, args, backward=True)
        g = torch.as_tensor(rng.normal(size=(Bn, nd, O, 3)).astype(np.float32),
                            device="cuda")
        held, g_held, n_kinks = neutralise_kinks(torch, kind, args, g)
        want = bwd_call(plain_fn, kind, held, g_held, torch.float64)
        got = bwd_call(kernel, kind, held, g_held)
        plain32 = bwd_call(plain_fn, kind, held, g_held)
        torch.cuda.synchronize()
        shape = f"{BWD[kind]} B={Bn} Ns={ns} Nd={nd} C={C} O={O} K={K}"
        err, err_plain, share = check_grads(torch, shape, got, want, plain32)
        max_abs = max(float((a.double() - w).abs().max()) for a, w in zip(got, want))
        del got, want, plain32
        ms = cuda_ms(torch, lambda: bwd_call(kernel, kind, args, g), 5)
        plain = cuda_ms(torch, lambda: bwd_call(plain_fn, kind, args, g), 2, 1)
        bms, by = bound_ms(flops, nbytes)
        r = report[BWD[kind]]
        r["shapes"].append({
            "shape": {"B": Bn, "Ns": ns, "Nd": nd, "C": C, "O": O, "K": K},
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "max_err_of_largest": err, "plain_f32_max_err_of_largest": err_plain,
            "largest_share_of_allowance": share, "kinks_neutralised": n_kinks})
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms)):
            r[key] += v  # one backward per layer and training step
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        log(f"{shape}: ok (max err {err:.3g} of the largest entry, the f32 plain "
            f"VJP {err_plain:.3g}, at most {share:.3g} of the allowance; {n_kinks} "
            f"kinks out of play); kernel {ms:.3f} ms, plain VJP {plain:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")
        torch.cuda.empty_cache()
    for kind in fns:
        largest = max(report[BWD[kind]]["shapes"], key=lambda row: row["bound_ms"])
        report[BWD[kind]]["bound_by"] = largest["bound_by"]


def phase_small_shapes(torch, report):
    """Rows 1-14 against their plain versions at shapes the main path never
    gives them: kNN at ragged query and source counts and widths, k < 16,
    each tiling (form); FPS at ragged N, masked tails, a start index, each
    form (warps a cloud), the stacked front end, and 12288 points (past the
    kernel's registers); K < 16, point counts and widths that fill no whole tile,
    ICP clouds with fewer targets than a block's warps or more than one
    target tile (exact distances, many ties),
    N_dst != N_src, one head and many, the kNN + scale and scale kernels
    past the 4096 points they once refused (4352, 8192; 5000), Sinkhorn
    clouds with N != M that fill no whole warp, on clusters of 1, 2, 4 and
    8 blocks (67, 40, 20 and 2 pairs) that split them raggedly, backward kernels on graphs with repeated sources and at the widest
    O they take (512). Random inputs from a seed; checked, not timed."""
    from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
    from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
    from livingscenes_tpu_torch.ops import (
        cuda_fps, cuda_icp, cuda_knn, cuda_scale, cuda_sinkhorn)
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
    from livingscenes_tpu_torch.ops.knn import knn
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
        # row 2: random reals (distances within 1e-5 of |q|^2 + d, index
        # swaps only at f64 near-ties) and small integers (exact: equal)
        for nq, np_, D, k in ((70, 300, 50, 16), (40, 12, 21, 10),
                              (1000, 1000, 3, 16), (33, 129, 96, 5),
                              (128, 200, 24, 16), (32, 32, 768, 16)):
            for ints in (False, True):
                if ints:
                    q, p = (torch.as_tensor(rng.integers(-2, 3, (2, n, D)),
                                            dtype=torch.float32, device="cuda")
                            for n in (nq, np_))
                else:
                    q, p = f32(2, nq, D), f32(2, np_, D)
                dp, ip = knn(q, p, k)
                for form in range(4):
                    name = (f"knn small Nq={nq} Np={np_} D={D} k={k} form={form}"
                            + (" integers" if ints else ""))
                    dk, ik = cuda_knn.knn_cuda(q, p, k, form)
                    if ints:
                        if not (torch.equal(ik.long(), ip) and torch.equal(dk, dp)):
                            raise AssertionError(f"{name}: differs")
                    else:
                        tol = 1e-5 * (torch.sum(q.double() ** 2, -1, keepdim=True)
                                      + dp.double())
                        if bool(((dk.double() - dp.double()).abs() > tol).any()):
                            raise AssertionError(f"{name}: distances differ")
                        check_graph(torch, name, q, p, ik.long(), ip)
                done.append(f"knn small Nq={nq} Np={np_} D={D} k={k} "
                            f"{'integers' if ints else 'reals'} x4")
        # row 1: bit-equal indices
        for Bn, n, k, warps in ((6, 1000, 200, 0), (6, 37, 50, 1), (5, 333, 64, 2),
                                (3, 777, 100, 4), (2, 4096, 300, 16),
                                (2, 12288, 256, 0), (1, 12288, 64, 16)):
            pts = f32(Bn, n, 3)
            mask = torch.as_tensor(rng.random((Bn, n)) > 0.3, device="cuda")
            mask[0, k // 3:] = False  # fewer valid points than k
            mask[-1, n - n // 5:] = False  # a padded tail
            start = torch.as_tensor(rng.integers(0, n, Bn), dtype=torch.int32,
                                    device="cuda")
            for m, st in ((None, None), (mask, None), (mask, start)):
                got = cuda_fps.fps_cuda(pts, k, m, st, warps=warps).long()
                want = farthest_point_sampling(
                    pts, k, m, start_idx=0 if st is None else st)[1]
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"fps small B={Bn} N={n} k={k} warps={warps}: "
                        f"{int((got != want).sum())} indices differ")
            done.append(f"fps small B={Bn} N={n} k={k} warps={warps} x3")
        # the front end's stacked launch against two launches
        ref, res = f32(3, 500, 3), f32(3, 500, 3)
        m_ref = torch.as_tensor(rng.random((3, 500)) > 0.4, device="cuda")
        both = cuda_fps.fps_cuda(torch.cat([ref, res]), 100,
                                 torch.cat([m_ref, torch.ones_like(m_ref)]))
        if not torch.equal(both, torch.cat([cuda_fps.fps_cuda(ref, 100, m_ref),
                                            cuda_fps.fps_cuda(res, 100)])):
            raise AssertionError("fps small: the stacked launch differs from two")
        done.append("fps small stacked front end")
        # row 4 past one column chunk and past the old cap of 4096 points
        for n, k in ((20, 5), (100, 16), (333, 7), (4096, 16), (4352, 16),
                     (8192, 9)):
            name = f"knn_topk small N={n} k={k}"
            check_knn_topk(torch, name, f32(2, n, 3), k, 5)
            done.append(name)
        # layer 0 also past the 48 KB of points it keeps in shared memory
        for n, K, O in ((40, 16, 32), (33, 8, 48), (18, 16, 132),
                        (5000, 16, 32)):
            args = (f32(2, n, 3), graph(n, n, K), f32(O, 3, scale=0.5),
                    f32(O, O, scale=0.2))
            name = f"layer0 small N={n} K={K} O={O}"
            check_close(name, cuda_layer0.fused_layer0_edge_mean_cuda(*args),
                        cuda_layer0.fused_layer0_edge_mean_plain(*args))
            done.append(name)
        for ns, nd, C, O, K in ((50, 50, 32, 32, 16), (40, 21, 16, 48, 8),
                                (30, 5, 36, 140, 7), (60, 50, 8, 24, 16),
                                (30, 70, 6, 4, 3), (20, 3, 128, 256, 11)):
            args = (f32(2, ns, C, 3), f32(2, nd, C, 3), graph(ns, nd, K),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2))
            name = f"edge_mean small Ns={ns} Nd={nd} C={C} O={O} K={K}"
            check_close(name, cuda_attention.fused_edge_mean_cuda(*args),
                        cuda_attention.fused_edge_mean_plain(*args))
            done.append(name)
        for ns, nd, C, O, K, head_c in ((40, 7, 16, 32, 8, 16),
                                        (30, 9, 12, 16, 3, 16),
                                        (24, 3, 20, 144, 5, 8),
                                        (20, 3, 128, 256, 11, 16),
                                        (30, 11, 12, 8, 5, 4),
                                        (60, 50, 8, 24, 16, 8),
                                        (300, 70, 36, 64, 16, 16)):
            args = (f32(2, ns, C, 3), f32(2, nd, C, 3), graph(ns, nd, K),
                    channel_equi_vec_normalize(f32(2, nd, O, 3)),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2),
                    f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2), head_c)
            name = (f"edge_attention small Ns={ns} Nd={nd} C={C} O={O} K={K} "
                    f"head_c={head_c}")
            check_close(name, cuda_attention.fused_edge_attention_cuda(*args),
                        cuda_attention.fused_edge_attention_plain(*args))
            done.append(name)
        # ICP stats on half-integer sources and integer targets: every
        # distance is exact on both sides, and ties are many
        for n, m in ((300, 130), (129, 1100), (1000, 3), (64, 2048)):
            tgt = torch.as_tensor(rng.integers(-4, 5, (3, m, 3)),
                                  dtype=torch.float32, device="cuda")
            x = torch.as_tensor(rng.integers(-8, 9, (3, n, 3)) / 2,
                                dtype=torch.float32, device="cuda")
            src = f32(3, n, 3)
            active = torch.tensor([True, False, True], device="cuda")
            name = f"icp_stats small n={n} m={m}"
            got = cuda_icp.icp_stats_cuda(x, src, tgt, active)
            want = cuda_icp.icp_stats_plain(x, src, tgt, active)
            for g, w in zip(got, want):
                torch.testing.assert_close(
                    g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()),
                    msg=lambda msg, name=name: f"{name}: {msg}")
            done.append(name)
        # row 8 past one column chunk and past the old cap of 4096 points
        for n, k in ((7, 5), (37, 5), (333, 8), (4096, 5), (5000, 5)):
            pc = f32(2, n, 3)
            name = f"scale small N={n} k={k}"
            torch.testing.assert_close(
                cuda_scale.top_k_mean_pairwise_distance_cuda(pc, k),
                cuda_scale.top_k_mean_pairwise_distance_plain(pc, k),
                rtol=1e-6, atol=0, msg=lambda m, name=name: f"{name}: {m}")
            done.append(name)
    # rows 12-14 on graphs whose sources repeat (one source in every row, a
    # row that names a source twice), against the f64 plain VJP
    fns = bwd_fns()

    def repeated(n_src, n_dst, K):
        idx = rng.integers(0, n_src, (2, n_dst, K))
        idx[:, :, 0] = 0
        idx[:, 1::3, 1] = idx[:, 1::3, 2]
        return torch.as_tensor(idx, device="cuda")

    # layer 0 at O = 132 and 512: a point's threads span several warps
    cases = [("layer0", (f32(2, n, 3), repeated(n, n, K), f32(O, 3, scale=0.5),
                         f32(O, O, scale=0.2), 0.2), n, O)
             for n, K, O in ((40, 16, 32), (33, 8, 48), (18, 16, 132), (7, 11, 512))]
    cases += [("edge_mean", (f32(2, ns, C, 3), f32(2, nd, C, 3), repeated(ns, nd, K),
                             f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2), 0.2), nd, O)
              for ns, nd, C, O, K in ((50, 50, 32, 32, 16), (40, 21, 16, 48, 8),
                                      (30, 5, 36, 140, 7), (14, 5, 8, 512, 9))]
    cases += [("edge_attention", (
        f32(2, ns, C, 3), f32(2, nd, C, 3), repeated(ns, nd, K),
        channel_equi_vec_normalize(f32(2, nd, O, 3)), f32(O, 2 * C, scale=0.2),
        f32(O, O, scale=0.2), f32(O, 2 * C, scale=0.2), f32(O, O, scale=0.2),
        head_c, 0.2), nd, O)
        for ns, nd, C, O, K, head_c in ((40, 7, 16, 32, 8, 16), (30, 9, 12, 16, 3, 16),
                                        (24, 3, 20, 144, 5, 8), (20, 3, 128, 256, 11, 16),
                                        (12, 2, 256, 512, 16, 16))]
    for kind, args, nd, O in cases:
        kernel, plain_fn = fns[kind]
        args, g, _ = neutralise_kinks(torch, kind, args, f32(2, nd, O, 3))
        name = f"{BWD[kind]} small " + " ".join(
            str(tuple(a.shape)) for a in args[:3] if torch.is_tensor(a))
        check_grads(torch, name, bwd_call(kernel, kind, args, g),
                    bwd_call(plain_fn, kind, args, g, torch.float64),
                    bwd_call(plain_fn, kind, args, g))
        done.append(name)
    # layer 0 past 64 channels, two groups of points a block, K odd and
    # even: each edge's sums over a point's channels and the destination's
    # that follows meet in shared memory; d_W and d_D repeat bit for bit
    for n, K, O in ((266, 5, 512), (530, 4, 132)):
        args = (f32(2, n, 3), repeated(n, n, K), f32(O, 3, scale=0.5),
                f32(O, O, scale=0.2), f32(2, n, O, 3))
        name = f"layer0_bwd small repeat N={n} K={K} O={O}"
        first = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
        for _ in range(20):
            again = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
            if not (torch.equal(first[1], again[1])
                    and torch.equal(first[2], again[2])):
                raise AssertionError(f"{name}: d_W or d_D differ between calls")
        done.append(f"{name} x21")
    # B pairs take clusters of the size the plan gives them on the H100's
    # 132 SMs: 8 for up to 16 pairs, 4, 2 and 1 for 20, 40 and 67, each
    # splitting its clouds raggedly
    for B, n, m, schedule, cluster in (
            (2, 50, 50, eps_annealing_schedule(0.05), 8),
            (2, 70, 33, eps_annealing_schedule(0.1), 8),
            (2, 20, 45, [0.01] * 5, 8), (2, 1500, 700, [0.02] * 3, 8),
            (40, 77, 45, eps_annealing_schedule(0.05), 2),
            (20, 150, 97, eps_annealing_schedule(0.05), 4),
            (2, 25, 70, eps_annealing_schedule(0.05), 8),
            (67, 60, 50, eps_annealing_schedule(0.05), 1)):
        x, y = f32(B, n, 3, scale=0.3), f32(B, m, 3, scale=0.3) + 0.1
        plan = cuda_sinkhorn.forward_plan(B, n, m)
        name = f"sinkhorn small B={B} N={n} M={m} S={len(schedule)} CL={plan['cluster']}"
        if plan["cluster"] != cluster:
            raise AssertionError(f"{name}: expected clusters of {cluster}")
        with torch.no_grad():
            got = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
            want = cuda_sinkhorn.ot_extrapolated_potentials_plain(x, y, schedule)
            want += cuda_sinkhorn.sinkhorn_iterates_plain(x, y, schedule)
            got += cuda_sinkhorn.sinkhorn_iterates_cuda(x, y, schedule)
        for g, w in zip(got, want + want[2:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")
        done.append(name)
        for cf, cg in ((f32(B, n), f32(B, m)), (f32(B, n), None), (None, f32(B, m))):
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
            # row 6's per-point products: two launches before each edge pass
            "edge_mean_products": (cuda_attention, "mean_products_launches"),
            "edge_attention": (cuda_attention, "attention_launches"),
            # row 7's per-point products: two launches before each edge pass
            "edge_attention_products": (cuda_attention, "products_launches"),
            "layer0_bwd": (cuda_layer0, "bwd_launches"),
            # row 12's fold of its per-block partials: one a backward
            "layer0_bwd_fold": (cuda_layer0, "bwd_fold_launches"),
            "edge_mean_bwd": (cuda_attention, "mean_bwd_launches"),
            # row 13's per-point products and reductions: five a backward
            "edge_mean_bwd_products": (cuda_attention,
                                       "mean_bwd_products_launches"),
            "edge_attention_bwd": (cuda_attention, "attention_bwd_launches"),
            # row 14's per-point products and reductions: five a backward
            "edge_attention_bwd_products": (cuda_attention,
                                            "attention_bwd_products_launches"),
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
                (cuda_attention, "mean_point_products_plain"),
                (cuda_attention, "fused_edge_attention_plain"),
                (cuda_layer0, "fused_layer0_edge_mean_bwd_plain"),
                (cuda_attention, "fused_edge_mean_bwd_plain"),
                (cuda_attention, "fused_edge_attention_bwd_plain"),
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


class timed_bwd_launches:
    """While active, every call of the wrappers of rows 12-14 is bracketed by
    CUDA events on its stream, and a copy of its arguments is kept (after
    the closing event), so that the launches of a run are timed as they
    ran and their plain VJPs can be timed on the same inputs afterwards.
    calls[kind]: [(start, end, args), ...]."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = {kind: [] for kind in BWD}

    def __enter__(self):
        from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0

        torch = self.torch
        self.saved = []
        for kind, mod in (("layer0", cuda_layer0), ("edge_mean", cuda_attention),
                          ("edge_attention", cuda_attention)):
            name = BWD_CUDA[kind]
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*args, _fn=fn, _kind=kind):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                kept = tuple(a.detach().clone() if torch.is_tensor(a) else a
                             for a in args)
                self.calls[_kind].append((start, end, kept))
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def totals(self, torch, fns):
        """kind -> the kernel ms of the recorded launches (their events),
        the plain VJP's ms on the same inputs (each call timed once, after
        one warm-up call), and the sum of their bounds (edge_work)."""
        torch.cuda.synchronize()
        out = {}
        for kind, calls in self.calls.items():
            plain_fn = fns[kind][1]
            plain_fn(*calls[0][2])
            ms = plain = bound = 0.0
            by = {}
            for start, end, args in calls:
                ms += start.elapsed_time(end)
                plain += cuda_ms(torch, lambda: plain_fn(*args), 1, 0)
                b, why = bound_ms(*edge_work(kind, args, backward=True)[:2])
                bound += b
                by[why] = by.get(why, 0.0) + b
            out[BWD[kind]] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                              "bound_by": max(by, key=by.get)}
        return out


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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: pipeline {N_SCENES}x{N_OBJ}x{N_FULL}: median {call_ms:.2f} "
        f"ms per call over {len(samples)} calls (min {min(samples):.2f}, max "
        f"{max(samples):.2f}), {pairs_per_s:.3f} scene-pairs/s, peak memory "
        f"{peak_gb:.3f} GB")

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
        reg = result["profile"]["register"]
        icp_ms, icp_n = reg["named"]["icp_stats_kernel"]
        pairs = reg["active_pairs"]
        log(f"{tag}: profile register: icp_stats_kernel {icp_ms:.4f} ms in "
            f"{icp_n} launches ({icp_ms / max(icp_n, 1):.5f} a launch); active "
            f"pairs a launch: mean {np.mean(pairs):.2f} of {N_SCENES * N_OBJ}, "
            f"first {pairs[0]}, last {pairs[-1]}; "
            f"{sum(p == N_SCENES * N_OBJ for p in pairs)} of {len(pairs)} "
            "launches with every pair active")

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
    against each other. Returns the fused path's launch counts and the
    output of its counted call."""
    per_encode = {"knn_topk": 1, "layer0": 1, "edge_mean": 1,
                  "edge_mean_products": 2,
                  "edge_attention": len(KNN_LAYERS) - 2,
                  "edge_attention_products": 2 * (len(KNN_LAYERS) - 2)}
    # FPS: the front end's one stacked launch, then three an encode
    n_fps = 1 + 2 * len(FPS_ENCODER)
    fused_want = {"fps": n_fps, "knn": 2 * (len(KNN_LAYERS) - 1),
                  "icp_stats": ICP_ITERS,
                  **{k: 2 * v for k, v in per_encode.items()}}
    plain_want = {"fps": n_fps, "knn": 2 * len(KNN_LAYERS), "icp_stats": ICP_ITERS,
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
    return fused["launches"], out_f


def make_shape_scenes(rng, n_scenes, n_pts=N_FULL):
    """Scene pairs of procedural shapes (bench.py:139 make_shape_scenes, in
    numpy, with the port's train/data.py SyntheticShapeDataset): with the
    trained checkpoint their codes have real surfaces. The rescan moves
    every object by its own rigid transform and permutes the objects."""
    from scipy.spatial.transform import Rotation

    from livingscenes_tpu_torch.train.data import SyntheticShapeDataset

    ds = SyntheticShapeDataset(n_items=1, n_pcl=n_pts, ram_cache=False)
    objs = np.zeros((n_scenes, N_OBJ, n_pts, 3), np.float32)
    for s in range(n_scenes):
        for o in range(N_OBJ):
            objs[s, o] = ds._surface_points(ds._shape_sdf(rng), rng, n_pts)
    offsets = rng.uniform(-3, 3, (n_scenes, N_OBJ, 1, 3)).astype(np.float32)
    ref = objs + offsets
    Rm = Rotation.random(n_scenes * N_OBJ, random_state=1).as_matrix()
    Rm = Rm.reshape(n_scenes, N_OBJ, 3, 3).astype(np.float32)
    tm = rng.normal(size=(n_scenes, N_OBJ, 1, 3)).astype(np.float32) * 0.5
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + tm
    perm = np.stack([rng.permutation(N_OBJ) for _ in range(n_scenes)])
    rescan = np.stack([rescan[s][perm[s]] for s in range(n_scenes)])
    return ref, rescan.astype(np.float32)


def decoder_flops(model, cfg, batch: int) -> dict:
    """The decoder MLP's f32 flops of one recon call: 2 x in x out a query
    and layer (from the layer widths), times the queries each level decodes
    for each of `batch` instances: (res0 + 1)^3, then cap = min(cap_factor
    x n^2, n^3) a refine level, whatever the content."""
    per_query = 0
    for lin in model.decoder.lin:
        w = lin.v if hasattr(lin, "v") else lin.kernel
        per_query += 2 * w.shape[0] * w.shape[1]
    res = cfg.recon_resolution0
    queries = [(res + 1) ** 3]
    for _ in range(cfg.recon_upsampling_steps):
        res *= 2
        n = res + 1
        queries.append(min(cfg.recon_cap_factor * n * n, n ** 3))
    return {"per_query": per_query, "queries_per_instance": queries,
            "per_call": per_query * sum(queries) * batch}


def mesh_chamfer(a, b) -> float:
    """Symmetric mean surface distance of two meshes: RECON_SAMPLES points
    drawn on each (seed 0), each side's mean distance to the other's
    samples by scipy's cKDTree, averaged."""
    from scipy.spatial import cKDTree

    pa = a.sample_surface(RECON_SAMPLES, seed=0)
    pb = b.sample_surface(RECON_SAMPLES, seed=0)
    return 0.5 * float(cKDTree(pb).query(pa)[0].mean()
                       + cKDTree(pa).query(pb)[0].mean())


class record_recon_codes:
    """While active, the canonical codes that the pipeline's recon leg hands
    to the grid evaluation are kept (detached copies): codes[i] of call i."""

    def __enter__(self):
        from livingscenes_tpu_torch.solver import pipeline as pl

        self.pl, self.real, self.codes = pl, pl.batched_hierarchical_grid_values, []

        def keep(logits_fn, codes, **kw):
            self.codes.append({k: v.detach().clone() for k, v in codes.items()})
            return self.real(logits_fn, codes, **kw)

        pl.batched_hierarchical_grid_values = keep
        return self

    def __exit__(self, *exc):
        self.pl.batched_hierarchical_grid_values = self.real


def selection_witness(card_pre, cpu_pre, flat_idx, thr, tol):
    """Why fine point `flat_idx` of the last level is selected on one side
    only: a corner of the level-1 grid (every second point of the premerge
    grid) within two cells of it, or of the level-0 grid (every fourth)
    within three, whose side of the threshold differs between the card and
    the CPU and whose value lies within `tol` of the threshold on both (a
    cell's activity, and so the selection near it, follows its corners'
    sides). None if there is no such corner."""
    n = card_pre.shape[0]
    pos = np.array(np.unravel_index(int(flat_idx), (n, n, n)))
    for level, step, reach in ((1, 2, 2), (0, 4, 3)):
        a = card_pre[::step, ::step, ::step]
        b = cpu_pre[::step, ::step, ::step]
        c = pos // step
        lo = np.maximum(c - reach, 0)
        box = tuple(slice(l, h) for l, h in zip(lo, c + reach + 1))
        hit = (((a[box] > thr) != (b[box] > thr))
               & (np.abs(a[box] - thr) <= tol) & (np.abs(b[box] - thr) <= tol))
        if hit.any():
            corner = np.argwhere(hit)[0]
            at = tuple(corner + lo)
            return {"point": pos.tolist(), "level": level,
                    "corner": [int(x) for x in at],
                    "card": float(a[at]), "cpu": float(b[at]), "threshold": thr}
    return None


def recon_cpu_check(torch, state, out, codes, cfg) -> dict:
    """Scene 0's first RECON_CPU_INSTANCES matched instances again on the
    CPU at the production resolution, from the card's canonical codes
    copied to the host: grid_overflow equal; the last level's selected
    points equal, or each point selected on one side only backed by a
    corner near the threshold (selection_witness); the refined values at
    the points both selected within 1e-4 of the grid's largest magnitude;
    the two meshes within 0.5 voxel (mesh_chamfer, in the canonical
    frame, unsimplified: the quadric simplification's greedy order turns
    a 1e-6 change of the grid into about 0.3 voxel, and the bound is
    tests/test_recon.py's, set on unsimplified meshes)."""
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.recon.extractor import (
        MeshExtractorConfig, extract_mesh_from_grid)
    from livingscenes_tpu_torch.recon.grid import (
        apply_final_merge, batched_hierarchical_grid_values)

    m0 = out["matches0"][0].cpu().numpy()
    picked = [j for j in range(N_OBJ) if m0[j] >= 0][:RECON_CPU_INSTANCES]
    cpu_model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cpu")
    cpu_model.load_state_dict(state)
    cpu_codes = {k: v[picked].cpu() for k, v in codes.items()}
    thr = float(np.log(cfg.recon_threshold) - np.log(1.0 - cfg.recon_threshold))
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre, overflow, fidx, fvals = (x.numpy() for x in batched_hierarchical_grid_values(
            lambda q, c: cpu_model.occupancy_logits(q, c), cpu_codes,
            resolution0=cfg.recon_resolution0,
            upsampling_steps=cfg.recon_upsampling_steps, threshold=thr,
            box_size=cfg.recon_box_size, chunk_size=cfg.recon_chunk,
            refine_cap_factor=cfg.recon_cap_factor,
            select_mode=cfg.recon_select_mode, dedup=cfg.recon_dedup,
            final_merge="host"))
    cpu_s = time.perf_counter() - t0
    ext = MeshExtractorConfig(simplify_nfaces=None)
    voxel = cfg.recon_box_size / (cfg.recon_resolution0 * 2 ** cfg.recon_upsampling_steps)
    rows = []
    for i, j in enumerate(picked):
        c_pre = out["grids_premerge"][0, j].cpu().numpy()
        c_idx = out["grid_fidx"][0, j].cpu().numpy()
        c_val = out["grid_fvals"][0, j].cpu().numpy()
        c_over = out["grid_overflow"][0, j].cpu().numpy()
        big = c_pre.size
        if not np.array_equal(c_over, overflow[i]):
            raise AssertionError(f"recon: instance {j}: grid_overflow card "
                                 f"{c_over.tolist()} vs cpu {overflow[i].tolist()}")
        card_grid = apply_final_merge(c_pre, c_idx, c_val)
        cpu_grid = apply_final_merge(pre[i], fidx[i], fvals[i])
        scale = float(np.abs(card_grid).max())
        tol = 1e-4 * scale
        sel_card = c_idx[c_idx < big]
        sel_cpu = fidx[i][fidx[i] < big]
        only = np.setxor1d(sel_card, sel_cpu)
        witnesses = []
        for p in only:
            w = selection_witness(c_pre, pre[i], p, thr, tol)
            if w is None:
                raise AssertionError(
                    f"recon: instance {j}: point {int(p)} is selected on one side "
                    "only and no corner near the threshold explains it")
            witnesses.append(w)
        both, ia, ib = np.intersect1d(c_idx, fidx[i], return_indices=True)
        keep = both < big
        dval = float(np.abs(c_val[ia[keep]] - fvals[i][ib[keep]]).max())
        if dval > tol:
            raise AssertionError(f"recon: instance {j}: refined values differ from "
                                 f"the CPU by {dval} (bound {tol})")
        mesh_card = extract_mesh_from_grid(card_grid, ext)
        mesh_cpu = extract_mesh_from_grid(cpu_grid, ext)
        if mesh_card.is_empty or mesh_cpu.is_empty:
            raise AssertionError(f"recon: instance {j}: an empty mesh "
                                 f"(card {mesh_card.is_empty}, cpu {mesh_cpu.is_empty})")
        ch = mesh_chamfer(mesh_card, mesh_cpu)
        if ch >= 0.5 * voxel:
            raise AssertionError(f"recon: instance {j}: chamfer to the CPU mesh "
                                 f"{ch} >= half a voxel {0.5 * voxel}")
        rows.append({"instance": j, "overflow": c_over.tolist(),
                     "selected": int(len(sel_card)), "selected_one_side": int(len(only)),
                     "witness": witnesses[:4], "max_abs_dval": dval,
                     "value_bound": tol, "chamfer": ch, "voxel": voxel,
                     "max_abs_dgrid": float(np.abs(card_grid - cpu_grid).max())})
        log(f"recon: card vs cpu, instance {j}: overflow {c_over.tolist()} equal, "
            f"{len(sel_card)} selected, {len(only)} on one side only"
            + (f" (first witness {witnesses[0]})" if witnesses else "")
            + f", max|dval| {dval:.3g} (bound {tol:.3g}), chamfer {ch:.3g} "
            f"({ch / voxel:.3f} voxel)")
    return {"instances": rows, "cpu_s": cpu_s}


def recon_meshes(torch, out):
    """extract_scene_meshes(..., with_stats=True) timed on the host, with
    its stats summed up; fails as bench.py:501-508 does when fewer than
    90 % of the matched instances give a non-empty mesh."""
    from livingscenes_tpu_torch.recon.extractor import MeshExtractorConfig
    from livingscenes_tpu_torch.solver.pipeline import extract_scene_meshes

    t0 = time.perf_counter()
    meshes, stats = extract_scene_meshes(out, MeshExtractorConfig(), with_stats=True)
    host_ms = (time.perf_counter() - t0) * 1e3
    n_matched = len(stats)
    n_nonempty = sum(not st["empty"] for st in stats)
    if n_matched == 0 or n_nonempty < 0.9 * n_matched:
        raise AssertionError(f"recon leg degenerate: only {n_nonempty}/{n_matched} "
                             "matched instances gave a non-empty mesh")

    def col(key):
        return [st.get(key, 0) for st in stats]

    summary = {"host_ms": host_ms, "n_matched": n_matched, "n_nonempty": n_nonempty,
               "workers": min(n_matched, os.cpu_count() or 4),
               **{f"{k}_mean": float(np.mean(col(k)))
                  for k in ("total_ms", "iso_ms", "simplify_ms", "faces_raw", "faces")},
               "faces_raw_max": int(max(col("faces_raw"))),
               "grid_overflow_max": int(out["grid_overflow"].max())}
    return meshes, summary


def bf16_chamfers(meshes32, meshes16, recon_s, voxel) -> list:
    """mesh_chamfer of each f32 mesh to its recon_bf16 twin, in voxels of
    the grid (the meshes carry their code's scale, so the voxel does)."""
    out = []
    for s, row in enumerate(meshes32):
        for o, a in enumerate(row):
            if a is None or a.is_empty:
                continue
            b = meshes16[s][o]
            if b is None or b.is_empty:
                raise AssertionError(f"recon: recon_bf16 mesh {s},{o} is empty")
            out.append(mesh_chamfer(a, b) / (voxel * float(recon_s[s, o])))
    return out


def bf16_coarse_check(torch, model, codes, cfg) -> list:
    """tests/test_recon.py test_bf16_grid_mesh_accuracy on the card: the
    grids of the canonical `codes` at res0 16 with one step (33^3), f32
    and bfloat16, meshed unsimplified; each pair's mesh_chamfer in voxels
    of 33^3."""
    from livingscenes_tpu_torch.recon.extractor import (
        MeshExtractorConfig, extract_mesh_from_grid)
    from livingscenes_tpu_torch.recon.grid import batched_hierarchical_grid_values

    ext = MeshExtractorConfig(resolution0=16, upsampling_steps=1, simplify_nfaces=None)
    grids = []
    with torch.inference_mode():
        for mm in (None, torch.bfloat16):
            g = batched_hierarchical_grid_values(
                lambda q, c: model.occupancy_logits(q, c, matmul_dtype=mm), codes,
                resolution0=16, upsampling_steps=1, threshold=ext.logit_threshold,
                box_size=cfg.recon_box_size, chunk_size=cfg.recon_chunk,
                refine_cap_factor=cfg.recon_cap_factor)[0]
            grids.append(g.float().cpu().numpy())
    voxel = cfg.recon_box_size / 32
    out = []
    for a, b in zip(*grids):
        ma, mb = extract_mesh_from_grid(a, ext), extract_mesh_from_grid(b, ext)
        if ma.is_empty != mb.is_empty:
            raise AssertionError("recon: a 33^3 recon_bf16 mesh is empty and its "
                                 "f32 twin is not, or the other way")
        if not ma.is_empty:
            out.append(mesh_chamfer(ma, mb) / voxel)
    return out


def phase_recon(torch, report, state, want: dict):
    """The reconstruction leg at production resolution:
    PipelineConfig(encode_fps=True, recon=True) with every recon default
    (res0 32 -> 129^3, packsort, dedup, host merge, f32) on RECON_SCENES
    scene pairs x 8 procedural shapes x 4096 points with the trained
    checkpoint and the fused encoder. A warm-up call, RECON_TIMED timed
    calls (the first between setting the launch counts to 0 and reading
    them, held to the fused main path's `want`, every plain version
    forbidden), peak memory, the stages (host ms with a sync each, then
    device ms and launches under torch.profiler, the grid stage split by
    grid.py's ranges), the decoder's flops and their rate, the host
    meshing, scene 0 against the CPU (recon_cpu_check), and one
    recon_bf16 call, its unsimplified meshes (see recon_cpu_check) held
    to tests/test_recon.py's bound, half a voxel of its 33^3 grid, as a
    length: the bfloat16 decode moves the surface by a length, not by a
    share of a voxel (with the r5 checkpoint on an NVIDIA H100, 0.13 of a
    33^3 voxel on average and 0.57 of a 129^3 one); that test's own check
    at 33^3 runs beside it (bf16_coarse_check). The host meshing's
    library is built before it is timed."""
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.recon.extractor import MeshExtractorConfig
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline, extract_scene_meshes)

    tag = "recon"
    S = RECON_SCENES
    model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cuda")
    model.load_state_dict(state)
    cfg = PipelineConfig(encode_fps=True, recon=True)
    ref_np, res_np = make_shape_scenes(np.random.default_rng(5), S)
    ref, res = (torch.as_tensor(a, device="cuda") for a in (ref_np, res_np))
    mask = torch.ones(ref.shape[:3], dtype=torch.bool, device="cuda")
    pipe = build_scene_pair_pipeline(model, cfg)

    pipe(ref, res, mask, mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def one_call():
        t0 = time.perf_counter()
        out = pipe(ref, res, mask, mask)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with forbid_plain(), record_recon_codes() as rec:
        (out, first_ms), launches = counted(one_call)
    launches = {k: v for k, v in launches.items() if v or k in want}
    log(f"{tag}: pipeline launches {launches}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    samples = [first_ms] + [one_call()[1] for _ in range(RECON_TIMED - 1)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    call_ms = float(np.median(samples))
    n = cfg.recon_resolution0 * 2 ** cfg.recon_upsampling_steps + 1
    for key, shape in (("grids_premerge", (S, N_OBJ, n, n, n)),
                       ("grid_overflow", (S, N_OBJ, cfg.recon_upsampling_steps))):
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{tag}: {key} has shape {tuple(out[key].shape)}")
    for key in ("grids_premerge", "grid_fvals", "recon_s", "recon_t", "R", "t"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{tag}: non-finite {key}")
    m0 = out["matches0"]
    for s in range(S):
        if sorted(m0[s].tolist()) != list(range(N_OBJ)):
            raise AssertionError(f"{tag}: scene {s}: matches0 {m0[s].tolist()} "
                                 "is not a permutation")

    stages = stage_times(torch, model, ref, res, mask, recon=cfg)
    prof = stage_times(torch, model, ref, res, mask, profile=True, recon=cfg)
    flops = decoder_flops(model, cfg, S * N_OBJ)
    grid_dev = prof["grid"]["device_ms"]
    if not grid_dev:
        raise AssertionError(f"{tag}: the profiler saw no device time in the grid stage")
    rate = {"tflops_per_s_call": flops["per_call"] / (call_ms / 1e3) / 1e12,
            "tflops_per_s_grid_device": flops["per_call"] / (grid_dev / 1e3) / 1e12}
    rate["share_of_67_call"] = rate["tflops_per_s_call"] * 1e12 / PEAK_F32_FLOPS
    rate["share_of_67_grid_device"] = rate["tflops_per_s_grid_device"] * 1e12 / PEAK_F32_FLOPS
    log(f"{tag}: pipeline {S}x{N_OBJ}x{N_FULL} with recon: median {call_ms:.1f} ms a "
        f"call over {len(samples)} calls ({', '.join(f'{x:.1f}' for x in samples)}), "
        f"peak memory {peak_gb:.2f} GB; stages (host ms with sync) "
        + json.dumps({k: round(v, 2) for k, v in stages.items()}))
    log(f"{tag}: stages on the card: "
        + "; ".join(f"{k} device {v['device_ms']:.2f} ms of wall {v['wall_ms']:.2f} "
                    f"({v['busy']:.1%} busy), {v['kernels']} launches"
                    for k, v in prof.items()))
    ranges = prof["grid"]["ranges"]
    rest = {"device_ms": grid_dev - sum(v["device_ms"] for v in ranges.values()),
            "launches": prof["grid"]["kernels"] - sum(v["launches"] for v in ranges.values())}
    if rest["launches"] < 0:
        raise AssertionError(f"{tag}: the grid ranges hold more launches than the stage")
    prof["grid"]["outside_ranges"] = rest
    log(f"{tag}: grid ranges (device ms, launches): "
        + "; ".join(f"{k} {v['device_ms']:.2f} ms x{v['launches']}"
                    for k, v in ranges.items())
        + f"; outside them (the code transport, the chunks' concatenation) "
        f"{rest['device_ms']:.2f} ms x{rest['launches']}")
    log(f"{tag}: decoder {flops['per_call'] / 1e12:.2f} TFLOP a call "
        f"({flops['per_query'] / 1e6:.3f} MFLOP a query, queries a level "
        f"{flops['queries_per_instance']} x {S * N_OBJ} instances): "
        f"{rate['tflops_per_s_grid_device']:.2f} TFLOP/s over the grid stage's "
        f"device time ({rate['share_of_67_grid_device']:.1%} of 67), "
        f"{rate['tflops_per_s_call']:.2f} over the call")

    from livingscenes_tpu_torch.native import bindings

    t0 = time.perf_counter()
    bindings.get_lib()  # set-up: the host meshing library's g++ build
    native_build_s = time.perf_counter() - t0
    meshes, mesh_stats = recon_meshes(torch, out)
    mesh_stats["library_build_s"] = native_build_s
    host_s = mesh_stats["host_ms"] / 1e3
    pairs = {"device_only": S / (call_ms / 1e3),
             "with_host_meshing": S / (call_ms / 1e3 + host_s)}
    log(f"{tag}: host meshing {json.dumps({k: round(v, 2) if isinstance(v, float) else v for k, v in mesh_stats.items()})}; "
        f"scene-pairs/s {pairs['device_only']:.4f} without the host stage, "
        f"{pairs['with_host_meshing']:.4f} with it")

    cpu_check = recon_cpu_check(torch, state, out, rec.codes[0], cfg)

    # recon_bf16: one warm-up and one timed call, meshes against f32
    pipe16 = build_scene_pair_pipeline(
        model, dataclasses.replace(cfg, recon_bf16=True))
    pipe16(ref, res, mask, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out16 = pipe16(ref, res, mask, mask)
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t0) * 1e3
    # unsimplified, as in recon_cpu_check
    raw = MeshExtractorConfig(simplify_nfaces=None)
    fine = bf16_chamfers(extract_scene_meshes(out, raw), extract_scene_meshes(out16, raw),
                         out["recon_s"], cfg.recon_box_size / (n - 1))
    # the repo's own check (tests/test_recon.py test_bf16_grid_mesh_accuracy):
    # res0 16 with one step, 33^3, from the same canonical codes
    coarse = bf16_coarse_check(torch, model, rec.codes[0], cfg)
    # the bound: half a voxel of the 33^3 grid that tests/test_recon.py sets
    # it at, in length; in voxels of the finer grid that is 0.5 x 128 / 32
    bound_fine = 0.5 * (n - 1) / 32
    log(f"{tag}: recon_bf16 call {bf16_ms:.1f} ms (f32 {call_ms:.1f}); chamfer to the "
        f"f32 meshes at {n}^3 up to {max(fine):.4f} voxel (mean {np.mean(fine):.4f}, "
        f"each: {', '.join(f'{r:.3f}' for r in fine)}; bound {bound_fine} voxel, "
        f"half a 33^3 voxel); at 33^3 up to {max(coarse):.4f} voxel (mean "
        f"{np.mean(coarse):.4f}; bound 0.5)")
    if max(fine) >= bound_fine or max(coarse) >= 0.5:
        raise AssertionError(f"{tag}: recon_bf16 meshes up to {max(fine):.3f} voxel "
                             f"at {n}^3 and {max(coarse):.3f} at 33^3 from the f32 ones")

    report["recon"] = {
        "scenes": S, "objects": N_OBJ, "points": N_FULL,
        "config": {k: getattr(cfg, k) for k in (
            "recon_resolution0", "recon_upsampling_steps", "recon_cap_factor",
            "recon_select_mode", "recon_dedup", "recon_final_merge", "recon_chunk")},
        "ms_per_call": call_ms, "call_ms_samples": samples, "peak_mem_gb": peak_gb,
        "launches": launches, "stages_ms": stages, "stages_device": prof,
        "decoder_flops": flops, **rate, "host_meshing": mesh_stats,
        "scene_pairs_per_s": pairs, "cpu_check": cpu_check,
        "bf16": {"ms_per_call": bf16_ms, "chamfer_voxels": fine,
                 "max_chamfer_voxels": max(fine), "bound_voxels": bound_fine,
                 "chamfer_voxels_33": coarse},
    }


class record_graphs:
    """While active, the kNN graphs and FPS picks the encoder builds
    (vec_dgcnn_attn's knn_auto and fps_subsample_with_features, the ablation encoders'
    knn_auto, and the fused front end's layer-0 graph, shape_prior's
    knn_with_topk_scale) are kept on the host
    in call order, as ("knn", layer, idx (B, Nd, K)) and ("fps", layer, idx
    (B, n)). `layer` counts the kNN graphs recorded before: the encoder
    layer, whichever way its layer-0 graph is built. With `keep_inputs`,
    inputs[i] holds the float32 inputs of call i on the host: (query,
    points) of a kNN call, (points,) of an FPS call."""

    def __init__(self, keep_inputs=False):
        self.keep_inputs, self.inputs = keep_inputs, []

    def kept(self, *tensors):
        self.inputs.append(tuple(t.detach().float().cpu() for t in tensors)
                           if self.keep_inputs and tensors else None)

    def __enter__(self):
        from livingscenes_tpu_torch.models import shape_prior as sp
        from livingscenes_tpu_torch.nn import encoders
        from livingscenes_tpu_torch.nn import vec_dgcnn_attn as vda

        self.vda, self.calls = vda, []
        self.saved = (vda.knn_auto, vda.fps_subsample_with_features)
        self.encoders = encoders
        self.sp, self.front = sp, sp.knn_with_topk_scale
        knn_real, fps_real = self.saved

        def front(pc, *a, **k):
            out = self.front(pc, *a, **k)
            layer = sum(c[0] == "knn" for c in self.calls)
            self.calls.append(("knn", layer, out[0].long().cpu()))
            self.kept(pc, pc)
            return out

        sp.knn_with_topk_scale = front

        def knn(q, p, k):
            out = knn_real(q, p, k)
            layer = sum(c[0] == "knn" for c in self.calls)
            self.calls.append(("knn", layer, out[1].long().cpu()))
            self.kept(q, p)
            return out

        def fps(x, features, factor):
            out = fps_real(x, features, factor)
            layer = sum(c[0] == "knn" for c in self.calls)
            self.calls.append(("fps", layer, out[2].long().cpu()))
            self.kept(x)
            return out

        vda.knn_auto, vda.fps_subsample_with_features = knn, fps
        encoders.knn_auto = knn
        return self

    def __exit__(self, *exc):
        self.vda.knn_auto, self.vda.fps_subsample_with_features = self.saved
        self.encoders.knn_auto = self.saved[0]
        self.sp.knn_with_topk_scale = self.front


def graph_differences(card_calls, cpu_calls, n):
    """Per cloud b < n, the first (kind, layer) where the card's and the
    CPU's graphs differ (None if nowhere), and per (kind, layer) the rows
    (kNN: destination points whose neighbour set differs; FPS: positions
    whose pick differs, since the picks' order is the next layer's order of
    points) that differ over the n clouds."""
    import torch

    first = [None] * n
    per_layer = {}
    for (kind, layer, a), (kind2, layer2, b) in zip(card_calls, cpu_calls):
        if (kind, layer) != (kind2, layer2):
            raise AssertionError("the card and the CPU built different graph sequences")
        a, b = a[:n], b[:n]
        if kind == "knn":
            diff = (torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1).sum(-1)
        else:
            diff = (a != b).sum(-1)
        per_layer[f"{kind} layer {layer}"] = int(diff.sum())
        for c in range(n):
            if first[c] is None and int(diff[c]):
                first[c] = f"{kind} layer {layer}"
    return first, per_layer


def knn_tie_witness(torch, card, cpu, b):
    """Why cloud b's kNN graph differs between the card and the CPU, from
    the first call that differs (card, cpu: (idx, (query, points)) of that
    call on each side): its first differing row, a neighbour that only the
    card picked and one that only the CPU picked, and the two squared
    distances on each side's own inputs, in f32 (the plain version's
    expansion) and in f64. Each side's pick is right on its own inputs when
    its f64 distance is not larger than the other's by more than 2e-6
    (|q|^2 + |p_a|^2 + |p_b|^2), twice the f32 rounding of either
    distance, and when the three rows (the query and both points) agree on
    the two sides within 1e-3 of their largest entry: then the kNN kernel
    is not at fault, and the swap comes from inputs that differ by the
    rounding of the layers before. Returns the numbers and that verdict."""
    (ia, (qa, pa)), (ib, (qb, pb)) = card, cpu
    rows = (torch.sort(ia[b], -1).values != torch.sort(ib[b], -1).values).any(-1)
    i = int(torch.nonzero(rows)[0])
    only_card = sorted(set(ia[b, i].tolist()) - set(ib[b, i].tolist()))[0]
    only_cpu = sorted(set(ib[b, i].tolist()) - set(ia[b, i].tolist()))[0]
    out = {"row": i, "only_card": only_card, "only_cpu": only_cpu}
    rows_a = torch.cat([qa[b, i:i + 1], pa[b, [only_card, only_cpu]]])
    rows_b = torch.cat([qb[b, i:i + 1], pb[b, [only_card, only_cpu]]])
    out["inputs_rel_diff"] = float((rows_a - rows_b).abs().max()
                                   / rows_b.abs().max())
    ok = out["inputs_rel_diff"] <= 1e-3
    for side, q, p, mine, other in (("card", qa, pa, only_card, only_cpu),
                                    ("cpu", qb, pb, only_cpu, only_card)):
        qi, pj = q[b, i], p[b, [mine, other]]
        d32 = (torch.sum(qi * qi) - 2.0 * (pj @ qi) + torch.sum(pj * pj, -1))
        q64, p64 = qi.double(), pj.double()
        d64 = torch.sum((p64 - q64) ** 2, -1)
        slack = 2e-6 * float(torch.sum(q64 * q64) + torch.sum(p64 * p64))
        right = float(d64[0]) <= float(d64[1]) + slack
        ok &= right
        out[side] = {"f32": d32.tolist(), "f64": d64.tolist(),
                     "rel_gap_f64": float((d64[1] - d64[0]) / d64.max()),
                     "slack": slack, "pick_right": right}
    out["near_tie"] = ok
    return out


def fps_tie_witness(torch, card, cpu, b):
    """Why cloud b's FPS picks differ between the card and the CPU, from the
    first FPS call that differs (card, cpu: (idx (B, k), (points,)) of that
    call on each side): the first position whose pick differs, the two
    picks, and on each side's own inputs in f64 the running minimum after
    that side's own earlier picks. The difference is backed when, on each
    side, (1) the side's pick is the argmax of that running minimum within
    f32 rounding (not below the largest by more than 1e-6 of it: the
    difference form rounds each distance to about 2.4e-7 of itself), and
    (2) the two picks' values are a near-tie: within 4 sqrt(3) delta
    (sqrt(v_a) + sqrt(v_b)) plus that rounding, where delta is the largest
    coordinate difference between the two sides' points, the most the
    inputs' difference can move a squared distance |x - s|^2 = v; and when
    the two sides' points agree within 1e-3 of their largest coordinate.
    Then the FPS kernel is not at fault: the picks swap on inputs that
    differ by the rounding of the layers before. Returns the numbers and
    that verdict."""
    (ia, (xa,)), (ib, (xb,)) = card, cpu
    pos = int(torch.nonzero(ia[b] != ib[b])[0])
    pick_card, pick_cpu = int(ia[b, pos]), int(ib[b, pos])
    delta = float((xa[b].double() - xb[b].double()).abs().max())
    out = {"position": pos, "pick_card": pick_card, "pick_cpu": pick_cpu,
           "inputs_abs_diff": delta,
           "inputs_rel_diff": delta / float(xb[b].abs().max())}
    ok = out["inputs_rel_diff"] <= 1e-3
    for side, x, idx, mine, other in (("card", xa, ia, pick_card, pick_cpu),
                                      ("cpu", xb, ib, pick_cpu, pick_card)):
        x64 = x[b].double()
        earlier = x64[idx[b, :pos]]
        v = torch.sum((x64[:, None, :] - earlier[None]) ** 2, -1).min(-1).values
        top = float(v.max())
        vm, vo = float(v[mine]), float(v[other])
        rounding = 1e-6 * top
        allow = 4 * 3 ** 0.5 * delta * (vm ** 0.5 + vo ** 0.5) + rounding
        right = vm >= top - rounding
        tie = abs(vm - vo) <= allow
        ok &= right and tie
        out[side] = {"v_mine": vm, "v_other": vo, "v_max": top,
                     "gap": vm - vo, "allowed_gap": allow,
                     "pick_right": right, "near_tie": tie}
    out["near_tie"] = ok
    return out


def witness_first_difference(torch, card_graphs, cpu_graphs, where, c,
                             start=0, shift=0, end=None):
    """The tie witness (knn_tie_witness or fps_tie_witness) of cloud c at
    its first difference `where` ("knn layer 2", ...), from the calls
    [start, end) of two record_graphs(keep_inputs=True) runs whose layers
    are counted from `shift`."""
    kind, _, layer = where.split()
    end = len(card_graphs.calls) if end is None else end
    j = next(j for j in range(start, end)
             if card_graphs.calls[j][:2] == (kind, int(layer) + shift))
    witness = knn_tie_witness if kind == "knn" else fps_tie_witness
    return witness(torch, *((g.calls[j][2], g.inputs[j])
                            for g in (card_graphs, cpu_graphs)), c)


def pair_graph_witnesses(torch, card_graphs, cpu_graphs, m0):
    """For a run that encoded the reference objects, then the rescan's
    (two record_graphs(keep_inputs=True) runs, card and CPU), and matched
    reference object o to rescan cloud m0[o]: for each object whose own or
    partner's cloud got a different kNN graph or FPS pick on the two sides,
    where the first difference lies ({o: "side cloud c: kind layer l"}) and
    its tie witness ({o: witness})."""
    half = len(card_graphs.calls) // 2
    n_ref = sum(c[0] == "knn" for c in card_graphs.calls[:half])
    first, sides = {}, {"reference": (0, 0), "rescan": (half, n_ref)}
    for side, (start, shift) in sides.items():
        first[side] = graph_differences(
            *([(k, layer - shift, a) for k, layer, a in g.calls[start:start + half]]
              for g in (card_graphs, cpu_graphs)), len(m0))[0]
    swapped, witness = {}, {}
    for o in range(len(m0)):
        side, c = (("reference", o) if first["reference"][o]
                   else ("rescan", int(m0[o])))
        where = first[side][c]
        if not where:
            continue
        swapped[o] = f"{side} cloud {c}: {where}"
        start, shift = sides[side]
        witness[o] = witness_first_difference(
            torch, card_graphs, cpu_graphs, where, c, start, shift, start + half)
    return swapped, witness


def log_witness(tag, what, w):
    """One line that says what a tie witness found."""
    if "pick_card" in w:
        log(f"{tag}: {what}, the first FPS pick that differs: position "
            f"{w['position']}, point {w['pick_card']} on the card, "
            f"{w['pick_cpu']} on the CPU, the inputs {w['inputs_abs_diff']:.3g} "
            f"apart ({w['inputs_rel_diff']:.3g} rel); running minimum [own "
            "pick, other's pick] "
            + "; ".join(f"on the {side}'s inputs {w[side]['v_mine']:.9g}, "
                        f"{w[side]['v_other']:.9g} (gap {w[side]['gap']:.3g}, "
                        f"allowed {w[side]['allowed_gap']:.3g}; largest "
                        f"{w[side]['v_max']:.9g}: its pick "
                        f"{'right' if w[side]['pick_right'] else 'WRONG'})"
                        for side in ("card", "cpu")))
        return
    log(f"{tag}: {what}, the first kNN row that differs: row {w['row']}, "
        f"point {w['only_card']} only on the card, {w['only_cpu']} only on "
        f"the CPU, the inputs of these rows {w['inputs_rel_diff']:.3g} apart "
        "(rel); their squared distances [card's pick, CPU's pick] "
        + "; ".join(f"on the {side}'s inputs f32 {w[side]['f32']}, f64 "
                    f"{w[side]['f64']} (f64 gap {w[side]['rel_gap_f64']:.3g} "
                    f"rel, its pick {'right' if w[side]['pick_right'] else 'WRONG'} "
                    f"within {w[side]['slack']:.3g})"
                    for side in ("card", "cpu")))


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
    with (torch.inference_mode(), forbid_plain(),
          record_graphs(keep_inputs=True) as card_graphs):
        codes, launches = counted(lambda: model.encode(pc))
        torch.cuda.synchronize()
    launches = {k: v for k, v in launches.items() if v}
    want_launches = {"scale": 1, "knn": len(KNN_LAYERS), "fps": len(FPS_ENCODER),
                     "layer0": 1, "edge_mean": 1, "edge_mean_products": 2,
                     "edge_attention": len(KNN_LAYERS) - 2,
                     "edge_attention_products": 2 * (len(KNN_LAYERS) - 2)}
    log(f"encode {Bn}x{n}, pallas_attention=True: launches {launches}")
    if launches != want_launches:
        raise AssertionError(f"encode at N={n}: launches {launches}, expected "
                             f"{want_launches}")
    cpu_model = ShapePrior(cfg, device="cpu")
    cpu_model.load_state_dict(state)
    n_cpu = 16
    t0 = time.perf_counter()
    with torch.inference_mode(), record_graphs(keep_inputs=True) as cpu_graphs:
        cpu_codes = cpu_model.encode(pc[:n_cpu].cpu())
    cpu_s = time.perf_counter() - t0
    card_codes = {k: v[:n_cpu].cpu() for k, v in codes.items()}
    diffs = {}
    for key, val in codes.items():
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"encode at N={n}: non-finite {key}")
        ref = cpu_codes[key]
        diffs[key] = float((card_codes[key] - ref).abs().max() / ref.abs().max())
    # The codes as their consumers read them, cloud by cloud. Where the card
    # and the CPU built the same kNN graphs and FPS picks in every layer,
    # the codes differ by rounding only: the rotation between them is the
    # identity within 1e-4. Where a neighbour or a pick that ties within
    # rounding went the other way (phase_knn counts such swaps), the codes
    # may turn further; those clouds are named with the first layer that
    # differs and held to 5e-2 (ICP later pulls such a pair together: the
    # pipeline's card-against-CPU check holds R to 1e-3), and their first
    # difference must be a near-tie that each side decided rightly on its
    # own inputs (knn_tie_witness, fps_tie_witness). The scales agree to
    # 1 %.
    Rc, _, _ = kabsch_from_codes(card_codes, cpu_codes)
    dR = (Rc - torch.eye(3)).abs().amax(dim=(1, 2))
    first, per_layer = graph_differences(card_graphs.calls, cpu_graphs.calls, n_cpu)
    same = torch.as_tensor([f is None for f in first])
    matched = sequential_matcher(card_codes["z_inv"][None],
                                 cpu_codes["z_inv"][None])["matches0"][0]
    worst, median = float(dR.max()), float(dR.median())
    worst_same = float(dR[same].max()) if bool(same.any()) else 0.0
    diverged = {c: {"first_difference": first[c], "max_abs_dR": float(dR[c]),
                    "tie_witness": witness_first_difference(
                        torch, card_graphs, cpu_graphs, first[c], c)}
                for c in range(n_cpu) if first[c] is not None}
    for c, v in diverged.items():
        log_witness(f"encode {Bn}x{n}", f"cloud {c}", v["tie_witness"])
    unbacked = [c for c, v in diverged.items() if not v["tie_witness"]["near_tie"]]
    log(f"encode {Bn}x{n}: card vs cpu on clouds 0-{n_cpu - 1}: rotation between "
        f"the codes max|R - I| median {median:.3g}, worst {worst:.3g}; "
        f"{int(same.sum())} clouds with equal graphs in every layer, worst of "
        f"them {worst_same:.3g}; the others, by the first layer that differs: "
        + (", ".join(f"cloud {c}: {v['first_difference']} ({v['max_abs_dR']:.3g})"
                     for c, v in diverged.items()) or "none")
        + "; rows that differ per layer: " + json.dumps(per_layer)
        + "; max |diff| over max |value|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (cpu run {cpu_s:.1f} s)")
    if (matched.tolist() != list(range(n_cpu)) or worst_same > 1e-4 or worst > 5e-2
            or diffs["s"] > 1e-2 or unbacked):
        raise AssertionError(f"encode at N={n}: card and CPU codes differ: matches "
                             f"{matched.tolist()}, dR {dR.tolist()}, first "
                             f"differences {first}, {diffs}; differences that "
                             f"no witness backs: clouds {unbacked}")
    diffs.update(equal_graph_clouds=int(same.sum()), max_abs_dR_equal_graphs=worst_same,
                 diverged_clouds=diverged, graph_rows_differing=per_layer)
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
    error against the same f64 gradient is logged beside the kernel's. The
    backward must give the same bits on a second launch, and the cluster
    size each shape takes is logged. Then, past the N + M <= 8192 the
    kernels once refused, 2 pairs of 6144 x 4096 points (on clusters of 8,
    in tiles of 4096 points) and 1 pair of 12288 x 8192 against the plain
    versions: forward and iterates as above, the backward with both
    cotangents and with f alone against the f64 plain gradient at the same
    tolerance."""
    from livingscenes_tpu_torch.ops import cuda_sinkhorn as cs

    Bn, n, _ = x.shape
    m = y.shape[1]
    S = len(schedule)
    plan = cs.forward_plan(Bn, n, m)
    log(f"sinkhorn: {Bn} pairs of {n} x {m} take clusters of {plan['cluster']} "
        f"blocks of {plan['threads']} threads, "
        f"each side streamed in tiles of {plan['tile']} points")
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
        again = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
        if not (torch.equal(dx, again[0]) and torch.equal(dy, again[1])):
            raise AssertionError(f"sinkhorn_bwd {name}: a second launch gave other bits")
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
    past_cap = sinkhorn_past_old_cap(torch, cs, schedule)

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
    report["sinkhorn_plan"] = {"refinement": plan, **past_cap}
    report["sinkhorn_iterates"] = {
        "shape": [Bn, n, m, S], "launches": launches["sinkhorn_iterates"],
        **per_launch["sinkhorn_iterates"], "bound_by": it_by,
        "max_abs_err": err_it, "library_ms": None}
    return per_launch, {"sinkhorn": err_fwd, "sinkhorn_bwd": err_bwd}, (fwd_by, bwd_by)


def sinkhorn_past_old_cap(torch, cs, schedule):
    """Rows 9-11 past the N + M <= 8192 the kernels once refused: 2 pairs of
    6144 x 4096 points and 1 of 12288 x 8192 (random boxes offset from the
    origin as the refinement's are, the targets a jittered copy), forward
    and iterates against the plain versions (rtol and atol 1e-5), the
    backward (both cotangents, f alone) against autograd of the plain
    forward in f64 (rtol 2e-3 plus 1e-3 of the largest entry, as
    phase_sinkhorn holds it) and repeated bit for bit. Returns each shape's
    launch plan."""
    rng = np.random.default_rng(9)
    plans = {}
    for Bn, n, m in ((2, 6144, 4096), (1, 12288, 8192)):
        box = rng.uniform(-0.5, 0.5, (Bn, max(n, m), 3)) + rng.uniform(-3, 3, (Bn, 1, 3))
        x = torch.as_tensor(box[:, :n].astype(np.float32), device="cuda")
        y = torch.as_tensor((box[:, :m] + rng.normal(size=(Bn, m, 3)) * 0.01).astype(
            np.float32), device="cuda")
        name = f"sinkhorn {Bn}x{n}x{m}"
        plans[name] = cs.forward_plan(Bn, n, m)
        with torch.no_grad():
            got = cs.extrapolated_forward_cuda(x, y, schedule)
            it = cs.sinkhorn_iterates_cuda(x, y, schedule)
            want = cs.ot_extrapolated_potentials_plain(x, y, schedule)
            want += cs.sinkhorn_iterates_plain(x, y, schedule)
        for g, w in zip(list(got) + list(it), list(want) + list(want[2:])):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                       msg=lambda msg, name=name: f"{name}: {msg}")
        del want
        errs = []
        for cf, cg in ((torch.full((Bn, n), 1.0 / n, device="cuda"),
                        torch.full((Bn, m), 1.0 / m, device="cuda")),
                       (torch.full((Bn, n), 1.0 / n, device="cuda"), None)):
            with torch.no_grad():
                d = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
                again = cs.extrapolated_backward_cuda(x, y, *got, cf, cg, schedule[-1])
            if not all(torch.equal(a, b) for a, b in zip(d, again)):
                raise AssertionError(f"{name} backward: a second launch gave other bits")
            xv, yv = x.double().requires_grad_(True), y.double().requires_grad_(True)
            f, g = cs.ot_extrapolated_potentials_plain(xv, yv, schedule)
            total = sum(torch.sum(c.double() * p) for c, p in ((cf, f), (cg, g))
                        if c is not None)
            w = torch.autograd.grad(total, (xv, yv))
            for a, b in zip(d, w):
                top = float(b.abs().max())
                torch.testing.assert_close(a.double(), b, rtol=2e-3, atol=1e-3 * top,
                                           msg=lambda msg, name=name: f"{name} backward: {msg}")
                errs.append(float((a.double() - b).abs().max()) / top)
            del w, f, g, total
        torch.cuda.empty_cache()
        log(f"{name}: forward, iterates and backward ok (backward {max(errs):.2g} of the "
            f"largest entry from the f64 plain gradient; repeats bit for bit); clusters of "
            f"{plans[name]['cluster']} blocks of {plans[name]['threads']} threads, "
            f"each side streamed in tiles of {plans[name]['tile']} points")
    return plans


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
            "edge_mean_products": 4,
            "edge_attention": 2 * (n_enc - 2),
            "edge_attention_products": 4 * (n_enc - 2),
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
        R_refine = timed("refine", lambda: solve_pairwise_registration(
            model, flat_ref, pc2, codes[0], c2, optim=True,
            cfg=RegistrationConfig(n_steps=REFINE_STEPS, icp_iterations=0)))[0]
        timed("icp", lambda: solve_pairwise_registration(
            model, flat_ref, pc2, codes[0], c2, cfg=RegistrationConfig()))
        # refine_bf16: one call (R and t finite, R against the f32 call's),
        # and its refine stage timed as the f32 one is
        t0 = time.perf_counter()
        out16 = pipeline(model, REFINE_STEPS, refine_bf16=True)(ref, res)
        torch.cuda.synchronize()
        bf16_call_ms = (time.perf_counter() - t0) * 1e3
        R_refine16 = timed("refine_bf16", lambda: solve_pairwise_registration(
            model, flat_ref, pc2, codes[0], c2, optim=True,
            cfg=RegistrationConfig(n_steps=REFINE_STEPS, icp_iterations=0,
                                   refine_bf16=True)))[0]
    if not (bool(torch.isfinite(out16["R"]).all())
            and bool(torch.isfinite(out16["t"]).all())):
        raise AssertionError(f"{tag}: refine_bf16: non-finite R or t")
    bf16_dR = float((out16["R"] - R).abs().max())
    # the refinement alone (no ICP after it, which pulls both to one pose)
    bf16_dR_refine = float((R_refine16 - R_refine).abs().max())
    stages["refine_ms_per_step"] = stages["refine"] / REFINE_STEPS
    stages["refine_bf16_ms_per_step"] = stages["refine_bf16"] / REFINE_STEPS
    log(f"{tag}: refine_bf16 call {bf16_call_ms:.1f} ms (f32 {call_ms:.1f}); refine "
        f"{stages['refine_bf16_ms_per_step']:.2f} ms a step (f32 "
        f"{stages['refine_ms_per_step']:.2f}); largest |R - R_f32| {bf16_dR:.3g} "
        f"after ICP, {bf16_dR_refine:.3g} after the refinement alone")
    log(f"{tag}: stages (ms, host clock with sync; refine = direction pick + "
        f"{REFINE_STEPS} steps, no ICP): " + json.dumps(stages))
    result = {"scenes": S, "objects": O, "points": N_PCL, "n_steps": REFINE_STEPS,
              "ms_per_call": call_ms, "scene_pairs_per_s": S / (call_ms / 1e3),
              "launches": launches, "stages_ms": stages, "peak_mem_gb": peak_gb,
              "refine_bf16": {"ms_per_call": bf16_call_ms, "max_abs_dR_f32": bf16_dR,
                              "max_abs_dR_f32_refine_only": bf16_dR_refine}}

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
        with record_graphs(keep_inputs=True) as card_graphs:
            card = pipeline(model, REFINE_CPU_STEPS, **reg)(ref[:1], res[:1])
        t0 = time.perf_counter()
        with record_graphs(keep_inputs=True) as cpu_graphs:
            cpu = pipeline(cpu_model, REFINE_CPU_STEPS, **reg)(ref_np[:1], res_np[:1])
        cpu_s = time.perf_counter() - t0
        if not torch.equal(card["matches0"].cpu(), cpu["matches0"]):
            raise AssertionError(f"{tag}: matches0 differs between card and CPU")
        swapped, witness = pair_graph_witnesses(
            torch, card_graphs, cpu_graphs, cpu["matches0"][0])
        dR_obj = (card["R"].cpu() - cpu["R"]).abs().amax((-1, -2))[0]
        dR = float(dR_obj.max())
        dt = float((card["t"].cpu() - cpu["t"]).abs().max())
        held = [o for o in range(N_OBJ) if o not in swapped or name != "refine only"]
        dR_held = float(dR_obj[held].max()) if held else 0.0
        dR_swapped = max((float(dR_obj[o]) for o in swapped), default=0.0)
        checks[name] = {"max_abs_dR": dR, "max_abs_dt": dt,
                        "max_abs_dR_held": dR_held, "graph_differs": swapped,
                        "max_abs_dR_graph_differs": dR_swapped,
                        "tie_witness": witness}
        log(f"{tag}: card vs cpu on scene 0, n_steps={REFINE_CPU_STEPS}, {name}: "
            f"matches0 equal, max|dR| {dR:.3g} (objects held: {dR_held:.3g}), "
            f"max|dt| {dt:.3g}; objects whose clouds' graphs differ, by the "
            f"first layer that does: "
            + (", ".join(f"{o}: {w} (|dR| {float(dR_obj[o]):.3g})"
                         for o, w in swapped.items()) or "none")
            + f" (cpu run {cpu_s:.1f} s)")
        for o, w in witness.items():
            log_witness(tag, f"object {o}", w)
        # f32 rounding carried through Adam steps, whose normalized update
        # amplifies it: 1e-4 measured after the refinement alone, 4.9e-4
        # after ICP as well (NVIDIA H100 80GB HBM3); the bound is four times
        # the larger. An object whose clouds got a different kNN graph or
        # FPS pick on the two sides starts the refinement from other codes
        # (ROADMAP Queue C): after the refinement alone it is held to 5e-2,
        # the bound of such clouds' codes in phase_scale, and a kNN or FPS
        # swap must be a near-tie that each side picked rightly on its own
        # inputs (knn_tie_witness, fps_tie_witness); after ICP every object
        # is held to 2e-3.
        bad = [o for o, w in witness.items() if not w["near_tie"]]
        if dR_held > 2e-3 or dR_swapped > 5e-2 or bad:
            raise AssertionError(
                f"{tag}: {name}: R differs from the CPU run by {dR_held} "
                f"(objects whose graphs differ: {dR_swapped}); kNN or FPS "
                f"swaps that are no near-tie: {bad}")
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


def encode_want(n_encodes: int) -> dict:
    """The launch counts of n_encodes calls of the fused encoder on clouds
    of 1024 points: three FPS, the kNN graphs of layers 1-6, the layer-0
    graph with the scale, and the fused layers."""
    per_encode = {"fps": len(FPS_ENCODER), "knn": len(KNN_LAYERS) - 1,
                  "knn_topk": 1, "layer0": 1, "edge_mean": 1,
                  "edge_mean_products": 2, "edge_attention": len(KNN_LAYERS) - 2,
                  "edge_attention_products": 2 * (len(KNN_LAYERS) - 2)}
    return {k: n_encodes * v for k, v in per_encode.items()}


def more_want(n_calls: int) -> dict:
    """The launch counts of n_calls solve_end2end calls of one scene with
    the fused encoder: the front end's FPS of each side, then two encodes
    (encode_want), and 100 ICP-stats launches a call."""
    want = encode_want(2)
    want["fps"] += 2
    want["icp_stats"] = ICP_ITERS
    return {k: n_calls * v for k, v in want.items()}


def check_launches(tag, launches, want):
    launches = {k: v for k, v in launches.items() if v or k in want}
    log(f"{tag}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    return launches


def code_delta(torch, codes, base):
    """(B, D): each instance's change of z_inv, z_so3 and t, flattened."""
    return torch.cat([(codes[k] - base[k]).reshape(base[k].shape[0], -1)
                      for k in ("z_inv", "z_so3", "t")], dim=1)


def symmetry_gap(torch, ref, pts):
    """(the reference cloud's largest nearest-neighbour gap, the largest
    distance from a point of `pts` to the reference cloud), in f64 on the
    host: a cloud moved by a symmetry of the object lies on its surface,
    as close to the reference samples as they lie to each other."""
    x = torch.as_tensor(ref, dtype=torch.float64)
    d = torch.cdist(x, x)
    d.fill_diagonal_(float("inf"))
    y = torch.as_tensor(pts, dtype=torch.float64)
    return (float(d.min(1).values.max()),
            float(torch.cdist(y, x).min(1).values.max()))


def phase_more(torch, report, state, scenes, profile: bool):
    """The MORE solver (solver/more.py MoreSolver, solver/joint.py
    accumulate_and_optimize) at full width with the r5 checkpoint, the
    production encoder and MoreSolverConfig() defaults, through the
    solver's own entry points. Checks, with the bounds fixed before the
    first run on the card:

    1. solve_end2end (fused encoder, optim=False, extract_meshes=False) on
       each of the 8 scenes of make_scenes (8 objects x 4096 points, every
       point valid): one warm-up call, then the 8 scenes timed one call
       each, between setting the launch counts to 0 and reading them
       (rows 1-7: more_want(8) exactly) with every plain version
       forbidden. matches0 a permutation and the registrations finite.
       Scene 0 again on the CPU through the plain versions: matches0
       equal, every object's R within 1e-3, and every kNN graph or FPS
       pick that differs between the two a near-tie by the f64 witness
       (knn_tie_witness, fps_tie_witness). The port's batched pipeline
       (build_scene_pair_pipeline, encode_fps=True) on the same 8 scenes:
       matches0 equal, R within 1e-3; its median of 3 calls is timed beside.
    2. pallas_attention=False on scene 0, one timed call after a warm-up:
       matches0 equal to the fused config's.
    3. n_init=4 restarts on scene 0's matched pairs (4096 points each),
       start points from the solver's generator: the chosen candidate is
       the one whose Kabsch residual, recomputed from the same start
       points, is the smallest of the four (first among ties): its codes
       equal those recomputed, bit for bit.
    4. optim=True on scene 0 with n_steps=400 (the default): rows 1-7 as
       in 1. for one call plus 801 Sinkhorn forwards and 800 backwards,
       every plain version forbidden, R and t finite. Scene 0 at
       n_steps=10 on the card and the CPU: R within 2e-3, or 5e-2 for an
       object whose clouds got a different kNN graph or FPS pick, each
       such difference a near-tie by the witness (PERF.md section 2).
    5. Scene 0 of make_shape_scenes (8 procedural shapes x 4096 points):
       solve_end2end(extract_meshes=True): at least 90 % of the matched
       instances give a non-empty mesh with finite vertices; ms per mesh
       from the call with meshes less the call without. optimize_code with
       the defaults (200 steps): each instance's loss (the mean squared SDF
       at its FPS-sampled points) at the returned codes no higher than at
       the input codes. The same codes and points at 20 steps on the card
       and on the CPU: each instance's change of (z_inv, z_so3, t) from
       the input agrees within 5 % of the CPU's change, in norm.
    6. accumulate_and_optimize on 3 scans: scene 0 of make_shape_scenes
       and two rigid moves of it (a rotation and translation per object,
       the objects permuted): matches equal the known permutations; every
       accumulated rescan point valid in the mask lies within 1e-2 of its
       object's extent (the diagonal of its bounding box) of its true
       reference position, unless the object's registration is off by a
       symmetry of the object: then each of its accumulated points must
       lie no farther from the reference cloud than the largest gap
       between a reference point and its nearest neighbour (symmetry_gap),
       and the object is logged with its pose error. (This scene holds
       one: an object with two equal principal axes registers 179.9 deg
       off, its points up to 0.83 of the extent from their true places;
       its codes cannot tell the two poses apart.) Row 1 launched at
       3 x 4096 = 12288 points (the joint FPS); the optimized codes
       finite.
    """
    from scipy.spatial.transform import Rotation

    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig)
    from livingscenes_tpu_torch.native.bindings import get_lib
    from livingscenes_tpu_torch.ops import cuda_fps
    from livingscenes_tpu_torch.solver import (
        CodeOptimConfig, MoreSolver, MoreSolverConfig, RegistrationConfig,
        accumulate_and_optimize, kabsch_from_codes, optimize_codes)
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline)

    tag = "more"
    result = {}

    def model_for(fused, device):
        m = ShapePrior(ShapePriorConfig(pallas_attention=fused), device=device)
        m.load_state_dict(state)
        return m

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model, cpu_model = model_for(True, "cuda"), model_for(True, "cpu")
    solver = MoreSolver(model)
    ref_np, res_np, mask_np = scenes
    ref, res = (torch.as_tensor(a, device="cuda") for a in (ref_np, res_np))
    mask = torch.as_tensor(mask_np, device="cuda")

    def end2end(slv, s, **kw):
        return slv.solve_end2end(ref[s], mask[s], res[s], mask[s],
                                 extract_meshes=False, **kw)

    # 1. the fused config on the 8 scenes
    end2end(solver, 0)  # warm-up

    def all_scenes():
        return [sync_ms(lambda s=s: end2end(solver, s)) for s in range(N_SCENES)]

    with forbid_plain():
        runs, launches = counted(all_scenes)
    check_launches(f"{tag}: solve_end2end x {N_SCENES}", launches, more_want(N_SCENES))
    outs, samples = [r[0] for r in runs], [r[1] for r in runs]
    for s, out in enumerate(outs):
        if sorted(out["matches0"].tolist()) != list(range(N_OBJ)):
            raise AssertionError(f"{tag}: scene {s}: matches0 "
                                 f"{out['matches0'].tolist()} is not a permutation")
        if not bool(torch.isfinite(out["registration"]).all()):
            raise AssertionError(f"{tag}: scene {s}: non-finite registration")
    call_ms = float(np.median(samples))
    result["end2end"] = {"ms_samples": samples, "median_ms": call_ms,
                         "scene_pairs_per_s": 1e3 / call_ms}
    log(f"{tag}: solve_end2end {N_OBJ}x{N_FULL} a scene pair, fused: median "
        f"{call_ms:.2f} ms over {N_SCENES} scenes (min {min(samples):.2f}, max "
        f"{max(samples):.2f}), {1e3 / call_ms:.3f} scene-pairs/s")
    if profile:
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = sync_ms(lambda: end2end(solver, 0))
        st = kernel_summary(torch, prof, wall)
        result["end2end"]["profile"] = st
        log(f"{tag}: profile of one solve_end2end: wall {wall:.2f} ms, device "
            f"{st['device_ms']:.2f} ms ({st['busy']:.1%} busy), {st['kernels']} "
            "kernel launches; top: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in st["top"][:6]))

    # scene 0 against the CPU
    R0 = outs[0]["registration"][:, :3, :3]
    with record_graphs(keep_inputs=True) as card_graphs:
        card = end2end(solver, 0)
    if not torch.equal(card["matches0"], outs[0]["matches0"]):
        raise AssertionError(f"{tag}: scene 0 gave other matches on a second call")
    t0 = time.perf_counter()
    with record_graphs(keep_inputs=True) as cpu_graphs:
        cpu = MoreSolver(cpu_model).solve_end2end(
            ref_np[0], mask_np[0], res_np[0], mask_np[0], extract_meshes=False)
    cpu_s = time.perf_counter() - t0
    if not torch.equal(cpu["matches0"], card["matches0"].cpu()):
        raise AssertionError(f"{tag}: matches0 card {card['matches0'].tolist()} vs "
                             f"cpu {cpu['matches0'].tolist()}")
    swapped, witness = pair_graph_witnesses(torch, card_graphs, cpu_graphs,
                                            cpu["matches0"])
    dR = float((card["registration"][:, :3, :3].cpu()
                - cpu["registration"][:, :3, :3]).abs().max())
    log(f"{tag}: card vs cpu on scene 0: matches0 equal, max|dR| {dR:.3g}; graphs "
        "that differ: " + (", ".join(f"{o}: {w}" for o, w in swapped.items()) or "none")
        + f" (cpu run {cpu_s:.1f} s)")
    for o, w in witness.items():
        log_witness(tag, f"object {o}", w)
    bad = [o for o, w in witness.items() if not w["near_tie"]]
    if dR > 1e-3 or bad:
        raise AssertionError(f"{tag}: R differs from the CPU run by {dR}; kNN or FPS "
                             f"swaps that are no near-tie: {bad}")
    result["cpu_check"] = {"max_abs_dR": dR, "graph_differs": swapped,
                           "tie_witness": witness}

    # the batched pipeline on the same scenes
    pipe = build_scene_pair_pipeline(model, PipelineConfig(encode_fps=True))
    pipe(ref, res, mask, mask)
    pipe_samples = []
    for _ in range(3):
        pout, ms = sync_ms(lambda: pipe(ref, res, mask, mask))
        pipe_samples.append(ms)
    m_solver = torch.stack([o["matches0"] for o in outs])
    if not torch.equal(pout["matches0"], m_solver):
        raise AssertionError(f"{tag}: the pipeline's matches0 {pout['matches0'].tolist()} "
                             f"differ from the solver's {m_solver.tolist()}")
    R_solver = torch.stack([o["registration"][:, :3, :3] for o in outs])
    dR_pipe = float((pout["R"] - R_solver).abs().max())
    pipe_ms = float(np.median(pipe_samples))
    log(f"{tag}: the pipeline on the same {N_SCENES} scenes: median {pipe_ms:.2f} ms a "
        f"call, {N_SCENES / (pipe_ms / 1e3):.3f} scene-pairs/s; matches0 equal, "
        f"max|dR| against the solver {dR_pipe:.3g}")
    if dR_pipe > 1e-3:
        raise AssertionError(f"{tag}: R differs from the pipeline's by {dR_pipe}")
    result["pipeline"] = {"ms_samples": pipe_samples, "median_ms": pipe_ms,
                          "scene_pairs_per_s": N_SCENES / (pipe_ms / 1e3),
                          "max_abs_dR_solver": dR_pipe}

    # 2. the default config on scene 0
    plain_solver = MoreSolver(model_for(False, "cuda"))
    end2end(plain_solver, 0)
    out_p, plain_ms = sync_ms(lambda: end2end(plain_solver, 0))
    if not torch.equal(out_p["matches0"], outs[0]["matches0"]):
        raise AssertionError(f"{tag}: pallas_attention=False matches0 "
                             f"{out_p['matches0'].tolist()} vs {outs[0]['matches0'].tolist()}")
    log(f"{tag}: solve_end2end scene 0, pallas_attention=False: {plain_ms:.2f} ms, "
        "matches0 equal to the fused config's")
    result["default_config"] = {"ms": plain_ms}

    # 3. restarts
    n_init = 4
    restart = MoreSolver(model, MoreSolverConfig(n_init=n_init))
    partner = outs[0]["matches0"].long()
    pc1, pc2 = ref[0], res[0][partner]
    gen_state = restart.generator.get_state()
    _, restart_ms = sync_ms(lambda: restart.solve_pairwise_registration(pc1, pc2))
    restart.generator.set_state(gen_state)
    starts = restart.restart_starts(N_OBJ, N_FULL)
    with torch.no_grad():
        picked = restart._best_fps_restart(pc1, pc2, starts)
        cands = []
        for st in starts:
            c1, c2 = (model.encode(restart._sample(p, start_idx=st)) for p in (pc1, pc2))
            cands.append((c1, c2, kabsch_from_codes(c1, c2).residual))
    res4 = torch.stack([c[2] for c in cands])  # (n_init, pairs)
    best = res4.argmin(0)
    rows = torch.arange(N_OBJ, device=best.device)
    same = all(torch.equal(picked[2 + side][k],
                           torch.stack([c[side][k] for c in cands])[best, rows])
               for side in (0, 1) for k in picked[2])
    if not same:
        raise AssertionError(f"{tag}: the restarts' chosen codes are not those of the "
                             f"candidates with the smallest residuals {best.tolist()}")
    log(f"{tag}: n_init={n_init} restarts on scene 0's {N_OBJ} pairs: {restart_ms:.2f} "
        f"ms; chosen candidate per pair {best.tolist()} (residuals "
        f"{res4.min(0).values.tolist()}), equal to the smallest of the four recomputed")
    result["restarts"] = {"n_init": n_init, "ms": restart_ms, "chosen": best.tolist(),
                          "residuals": res4.tolist()}

    # 4. the refinement
    with forbid_plain():
        (out_o, optim_ms), launches = counted(lambda: sync_ms(
            lambda: end2end(solver, 0, optim=True)))
    want = dict(more_want(1), sinkhorn=1 + 2 * REFINE_STEPS, sinkhorn_bwd=2 * REFINE_STEPS)
    check_launches(f"{tag}: solve_end2end(optim=True)", launches, want)
    if not bool(torch.isfinite(out_o["registration"]).all()):
        raise AssertionError(f"{tag}: optim=True: non-finite registration")
    log(f"{tag}: solve_end2end(optim=True) scene 0, n_steps={REFINE_STEPS}: "
        f"{optim_ms:.1f} ms")
    reg10 = MoreSolverConfig(registration=RegistrationConfig(n_steps=REFINE_CPU_STEPS))
    with record_graphs(keep_inputs=True) as card_graphs:
        card = end2end(MoreSolver(model, reg10), 0, optim=True)
    t0 = time.perf_counter()
    with record_graphs(keep_inputs=True) as cpu_graphs:
        cpu = MoreSolver(cpu_model, reg10).solve_end2end(
            ref_np[0], mask_np[0], res_np[0], mask_np[0], optim=True, extract_meshes=False)
    cpu_s = time.perf_counter() - t0
    if not torch.equal(cpu["matches0"], card["matches0"].cpu()):
        raise AssertionError(f"{tag}: optim: matches0 differs between card and CPU")
    swapped, witness = pair_graph_witnesses(torch, card_graphs, cpu_graphs,
                                            cpu["matches0"])
    dR_obj = (card["registration"][:, :3, :3].cpu()
              - cpu["registration"][:, :3, :3]).abs().amax((-1, -2))
    held = [o for o in range(N_OBJ) if o not in swapped]
    dR_held = float(dR_obj[held].max()) if held else 0.0
    dR_swapped = max((float(dR_obj[o]) for o in swapped), default=0.0)
    log(f"{tag}: optim card vs cpu on scene 0, n_steps={REFINE_CPU_STEPS}: matches0 "
        f"equal, max|dR| {dR_held:.3g} (objects whose graphs differ: "
        + (", ".join(f"{o}: {w} (|dR| {float(dR_obj[o]):.3g})" for o, w in swapped.items())
           or "none") + f"; cpu run {cpu_s:.1f} s)")
    for o, w in witness.items():
        log_witness(tag, f"optim object {o}", w)
    bad = [o for o, w in witness.items() if not w["near_tie"]]
    if dR_held > 2e-3 or dR_swapped > 5e-2 or bad:
        raise AssertionError(f"{tag}: optim: R differs from the CPU run by {dR_held} "
                             f"(objects whose graphs differ: {dR_swapped}); kNN or FPS "
                             f"swaps that are no near-tie: {bad}")
    result["optim"] = {"n_steps": REFINE_STEPS, "ms": optim_ms,
                       "launches": launches,
                       "cpu_check": {"steps": REFINE_CPU_STEPS, "max_abs_dR_held": dR_held,
                                     "graph_differs": swapped,
                                     "max_abs_dR_graph_differs": dR_swapped,
                                     "tie_witness": witness}}

    # 5. meshes and code optimisation on procedural shapes
    get_lib()  # the host meshing's library, built (at first use) before it is timed
    shape_ref_np, shape_res_np = make_shape_scenes(np.random.default_rng(2), 1)
    sref, sres = (torch.as_tensor(a[0], device="cuda") for a in (shape_ref_np, shape_res_np))
    solver.solve_end2end(sref, None, sres, None, extract_meshes=False)
    out_s, no_mesh_ms = sync_ms(lambda: solver.solve_end2end(
        sref, None, sres, None, extract_meshes=False))
    out_m, mesh_call_ms = sync_ms(lambda: solver.solve_end2end(sref, None, sres, None))
    matched = [i for i, m in enumerate(out_m["matches0"].tolist()) if m >= 0]
    good = [i for i in matched if not out_m["mesh_list"][i].is_empty
            and bool(np.isfinite(out_m["mesh_list"][i].vertices).all())]
    ms_per_mesh = (mesh_call_ms - no_mesh_ms) / max(len(matched), 1)
    faces = [len(out_m["mesh_list"][i].faces) for i in good]
    log(f"{tag}: solve_end2end with meshes on {N_OBJ} shapes: {mesh_call_ms:.1f} ms "
        f"({no_mesh_ms:.1f} without), {ms_per_mesh:.1f} ms a mesh; {len(good)}/"
        f"{len(matched)} matched instances give a finite mesh ({faces} faces)")
    if len(good) < 0.9 * len(matched):
        raise AssertionError(f"{tag}: only {len(good)} of {len(matched)} matched "
                             "instances gave a finite mesh")
    codes = out_s["ref_codes"]
    pc_in = solver._sample(sref)

    def code_loss(m, c, p):
        with torch.no_grad():
            return torch.mean(m.decode_sdf(p, c) ** 2, dim=-1)

    opt_codes, code_ms = sync_ms(lambda: solver.optimize_code(codes, sref))
    loss_in, loss_out = code_loss(model, codes, pc_in), code_loss(model, opt_codes, pc_in)
    log(f"{tag}: optimize_code, {solver.cfg.code_optim.n_steps} steps on {N_OBJ} "
        f"instances: {code_ms:.1f} ms; loss {loss_in.tolist()} -> {loss_out.tolist()}")
    if not bool((loss_out <= loss_in).all()):
        raise AssertionError(f"{tag}: optimize_code raised a loss: {loss_in.tolist()} -> "
                             f"{loss_out.tolist()}")
    cfg20 = CodeOptimConfig(n_steps=20)
    card20, code20_ms = sync_ms(lambda: optimize_codes(model.decode_sdf, codes, pc_in, cfg20))
    codes_cpu = {k: v.cpu() for k, v in codes.items()}
    t0 = time.perf_counter()
    cpu20 = optimize_codes(cpu_model.decode_sdf, codes_cpu, pc_in.cpu(), cfg20)
    cpu_s = time.perf_counter() - t0
    d_card = code_delta(torch, {k: v.cpu() for k, v in card20.items()}, codes_cpu)
    d_cpu = code_delta(torch, cpu20, codes_cpu)
    rel = (torch.linalg.norm(d_card - d_cpu, dim=1) / torch.linalg.norm(d_cpu, dim=1))
    log(f"{tag}: optimize_codes 20 steps, card {code20_ms:.1f} ms, cpu {cpu_s:.1f} s: "
        f"the change from the input differs by {rel.tolist()} of the CPU's, in norm")
    if not bool((rel <= 0.05).all()):
        raise AssertionError(f"{tag}: code optimisation differs from the CPU's by "
                             f"{rel.tolist()} of its change")
    result["meshes"] = {"call_ms": mesh_call_ms, "call_ms_without": no_mesh_ms,
                        "ms_per_mesh": ms_per_mesh, "n_matched": len(matched),
                        "n_finite": len(good), "faces": faces}
    result["code_optim"] = {"n_steps": solver.cfg.code_optim.n_steps, "ms": code_ms,
                            "loss_in": loss_in.tolist(), "loss_out": loss_out.tolist(),
                            "ms_20_steps": code20_ms, "rel_diff_cpu_20": rel.tolist()}

    # 6. joint optimisation over three scans
    rng = np.random.default_rng(3)
    base = shape_ref_np[0]
    scans, perms, moves = [(base, None)], [], []
    for i in range(2):
        Rm = Rotation.random(N_OBJ, random_state=10 + i).as_matrix().astype(np.float32)
        tm = rng.normal(size=(N_OBJ, 1, 3)).astype(np.float32)
        perm = rng.permutation(N_OBJ)
        scans.append(((np.einsum("oij,onj->oni", Rm, base) + tm)[perm], None))
        perms.append(perm)
        moves.append((Rm, tm))
    fps_shapes = []
    real_fps = cuda_fps.fps_cuda

    def fps_seen(points, k, *a, **kw):
        fps_shapes.append((tuple(points.shape), k))
        return real_fps(points, k, *a, **kw)

    cuda_fps.fps_cuda = fps_seen
    try:
        with forbid_plain():
            (joint, joint_ms), launches = counted(lambda: sync_ms(
                lambda: accumulate_and_optimize(solver, scans)))
    finally:
        cuda_fps.fps_cuda = real_fps
    for i, perm in enumerate(perms):
        if not np.array_equal(joint.matches[i], np.argsort(perm)):
            raise AssertionError(f"{tag}: joint: scan {i + 1} matches {joint.matches[i]}, "
                                 f"expected {np.argsort(perm)}")
    acc = joint.accumulated_pc.cpu().numpy()
    acc_mask = joint.accumulated_mask.cpu().numpy()
    extent = np.linalg.norm(base.max(1) - base.min(1), axis=-1)  # (O,)
    worst, symmetric = 0.0, {}
    for i, (Rm, _) in enumerate(moves):
        part = acc[:, (i + 1) * N_FULL:(i + 2) * N_FULL]
        valid = acc_mask[:, (i + 1) * N_FULL:(i + 2) * N_FULL]
        err = np.linalg.norm(part - base, axis=-1) / extent[:, None]
        R_est = joint.transforms[i][:, :3, :3].cpu().double().numpy()
        for o in range(N_OBJ):
            e = float(err[o][valid[o]].max())
            if e <= 1e-2:
                worst = max(worst, e)
                continue
            # the pose is off: it must differ from the truth by a rotation
            # under which the reference object maps onto itself
            off = float(np.degrees(np.arccos(np.clip(
                (np.trace(R_est[o].T @ Rm[o].astype(np.float64)) - 1) / 2, -1, 1))))
            gap, on_surface = symmetry_gap(torch, base[o], part[o][valid[o]])
            symmetric[f"scan {i + 1} object {o}"] = {
                "max_point_error_of_extent": e, "pose_error_deg": off,
                "max_distance_to_reference_cloud": on_surface,
                "reference_sampling_gap": gap}
            log(f"{tag}: joint: scan {i + 1} object {o} registered {off:.2f} deg off the "
                f"truth (points up to {e:.3g} of the extent from their true places); its "
                f"points lie within {on_surface:.4g} of the reference cloud, whose own "
                f"largest nearest-neighbour gap is {gap:.4g}")
            if on_surface > gap:
                raise AssertionError(
                    f"{tag}: joint: scan {i + 1} object {o}: an accumulated point lies "
                    f"{e} of its object's extent from its reference position, and the "
                    "pose error is no symmetry of the reference cloud")
    joint_fps = [sh for sh in fps_shapes if sh[0][1] == 3 * N_FULL]
    launches = {k: v for k, v in launches.items() if v}
    log(f"{tag}: accumulate_and_optimize over 3 scans: {joint_ms:.1f} ms; matches "
        f"equal to the permutations; largest accumulated point error {worst:.3g} of "
        f"the object's extent ({len(symmetric)} object registrations off by a "
        f"symmetry of the object); FPS launches (shape, k) {fps_shapes}; launches "
        f"{launches}")
    if not joint_fps:
        raise AssertionError(f"{tag}: joint: no FPS launch at {3 * N_FULL} points")
    if not all(bool(torch.isfinite(v).all()) for v in joint.codes.values()):
        raise AssertionError(f"{tag}: joint: non-finite codes")
    result["joint"] = {"ms": joint_ms, "max_point_error_of_extent": worst,
                       "off_by_a_symmetry": symmetric,
                       "fps_launches_12288": len(joint_fps), "launches": launches}
    report["more"] = result


# A registered reference box's chamfer to its rescan, of the rescan's mean
# nearest-neighbour spacing, at most: registered as the CPU registers it
# (the exact pose gives about 1e-4; a turn of 0.5 degree about the box's
# centre 0.065-0.080), and on another of the box's half turns than the
# CPU's (0.95-1.07: the points lie between the rescan's samples). phase_demo
# logs both readings for the demo's boxes.
DEMO_CHAMFER = 0.05
DEMO_CHAMFER_TURN = 1.2
# A box's symmetries that keep its surface in place: the identity, then the
# half turns about its three axes through its centre.
BOX_TURNS = [np.eye(3)] + [np.diag(d) for d in ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
                                                (-1.0, -1.0, 1.0))]


def box_turn(tsfm, cpu_tsfm, box):
    """Which of BOX_TURNS, composed with the CPU's registration `cpu_tsfm`
    of the (N, 3) reference `box` (an axis-aligned box), gives the card's
    `tsfm` within the tolerance that tests/test_torch_port_pipeline.py holds
    a registration to after ICP (rotation 0.5 degree, translation 1e-2):
    its index, 0 for the CPU's pose itself, or None."""
    R, t, Rc, tc = tsfm[:3, :3], tsfm[:3, 3], cpu_tsfm[:3, :3], cpu_tsfm[:3, 3]
    c = 0.5 * (box.min(0) + box.max(0))
    for k, H in enumerate(BOX_TURNS):
        cos = 0.5 * (np.trace((Rc @ H).T @ R) - 1.0)
        if np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) < 0.5 and \
                np.abs(t - (tc + Rc @ (c - H @ c))).max() < 1e-2:
            return k
    return None


def cloud_chamfer(torch, a, b) -> float:
    """Symmetric chamfer of two (N, 3) clouds in f64 on the host: the mean
    nearest-neighbour distance of each to the other, averaged."""
    d = torch.cdist(torch.as_tensor(a, dtype=torch.float64),
                    torch.as_tensor(b, dtype=torch.float64))
    return 0.5 * float(d.min(1).values.mean() + d.min(0).values.mean())


def phase_demo(torch, report):
    """The port's end-to-end demo, scripts/torch_demo_end2end.py main, at
    its defaults on the card (4 boxes x 1024 points, the fused encoder,
    129^3 grids and meshes) with the r5 checkpoint, into a temporary
    directory: once as is and once with --optim. Checks, with the bounds
    fixed before the first run on the card:

    - launch counts: more_want(1), and with --optim 801 Sinkhorn forwards
      and 800 backwards more; no plain version ran;
    - matches0 equal to the same solve on the CPU (device="cpu",
      extract_meshes=False), and every box matched to its own rescan;
    - each box's registration the CPU's within 0.5 degree and 1e-2, or the
      CPU's composed with one of the box's half turns about its centre
      (box_turn): the two solves sum in other orders, and a box's half turns
      leave it where it was;
    - each reference box moved by its registration lies on its rescan: their
      chamfer at most DEMO_CHAMFER times the rescan's mean nearest-neighbour
      spacing, or DEMO_CHAMFER_TURN for a box on another half turn than the
      CPU's;
    - matching.png, registration.png and a non-empty recon_<i>.obj for each
      matched box were written.
    The match count and each box's RRE and RTE are logged as the JAX demo
    prints them."""
    import tempfile

    demo = load_script("torch_demo_end2end")
    from livingscenes_tpu_torch.eval.run_flyingshape import load_solver

    tag = "demo"
    phase_t0 = time.perf_counter()
    objs, rescan, _, _, perm = demo.make_scene()
    t0 = time.perf_counter()
    cpu = demo.solve(load_solver(CKPT, device="cpu"), objs, rescan, extract_meshes=False)
    result = {"cpu_ms": (time.perf_counter() - t0) * 1e3,
              "cpu_matches0": cpu["matches0"].tolist()}
    spacing = []
    for r in rescan:
        d = torch.cdist(torch.as_tensor(r, dtype=torch.float64),
                        torch.as_tensor(r, dtype=torch.float64))
        d.fill_diagonal_(float("inf"))
        spacing.append(float(d.min(1).values.mean()))
    # what the bounds stand against: each box against itself turned about
    # its centre by a half turn and by 0.5 degree, of its spacing
    cos, sin = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
    tilt = np.array([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]])
    readings = {"half_turn": [], "half_degree": []}
    for i, j in enumerate(perm.argsort()):
        box = objs[i].astype(np.float64)
        mid = 0.5 * (box.min(0) + box.max(0))
        for key, turns in (("half_turn", BOX_TURNS[1:]), ("half_degree", [tilt])):
            readings[key] += [cloud_chamfer(torch, (box - mid) @ H.T + mid, box)
                              / spacing[j] for H in turns]
    result["chamfer_of"] = {k: [min(v), max(v)] for k, v in readings.items()}
    log(f"{tag}: chamfer / spacing of a box against itself turned about its "
        f"centre: half turns {min(readings['half_turn']):.3f}-"
        f"{max(readings['half_turn']):.3f}, 0.5 degree "
        f"{min(readings['half_degree']):.3f}-{max(readings['half_degree']):.3f} "
        f"(bounds {DEMO_CHAMFER_TURN}, {DEMO_CHAMFER})")
    for optim in (False, True):
        name = "optim" if optim else "plain"
        with tempfile.TemporaryDirectory() as out_dir:
            argv = ["--out", out_dir, "--ckpt", CKPT] + (["--optim"] if optim else [])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with forbid_plain():
                run, launches = counted(lambda: demo.main(argv))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = more_want(1)
            if optim:
                want.update(sinkhorn=2 * REFINE_STEPS + 1, sinkhorn_bwd=2 * REFINE_STEPS)
            check_launches(f"{tag} ({name})", launches, want)
            out = run["solution"]
            m0 = out["matches0"].tolist()
            if m0 != result["cpu_matches0"] or not all(run["correct"]):
                raise AssertionError(f"{tag} ({name}): matches0 {m0}, the CPU's "
                                     f"{result['cpu_matches0']}, correct {run['correct']}")
            tsfm = out["registration"].cpu().double().numpy()
            cpu_tsfm = cpu["registration"].cpu().double().numpy()
            chamfers, turns = [], []
            for i, j in enumerate(m0):
                box = objs[i].astype(np.float64)
                turns.append(box_turn(tsfm[i], cpu_tsfm[i], box))
                moved = box @ tsfm[i, :3, :3].T + tsfm[i, :3, 3]
                chamfers.append(cloud_chamfer(torch, moved, rescan[j]) / spacing[j])
            if None in turns:
                raise AssertionError(f"{tag} ({name}): registrations {turns} (None: "
                                     "neither the CPU's nor a half turn of it)")
            bounds = [DEMO_CHAMFER if k == 0 else DEMO_CHAMFER_TURN for k in turns]
            if any(c > b for c, b in zip(chamfers, bounds)):
                raise AssertionError(f"{tag} ({name}): registered boxes off their "
                                     f"rescans, chamfer / spacing {chamfers}, bounds "
                                     f"{bounds}")
            names = sorted(os.path.basename(p) for p in run["paths"])
            objs_written = [f"recon_{i}.obj" for i in range(len(m0))]
            if names != sorted(["matching.png", "registration.png"] + objs_written) or \
                    min(os.path.getsize(p) for p in run["paths"]) == 0:
                raise AssertionError(f"{tag} ({name}): artifacts {names}")
        log(f"{tag} ({name}): matching: {sum(run['correct'])}/{len(m0)} correct -> "
            f"{m0} (the CPU's equal); "
            + "; ".join(f"object {i}: RRE {run['rre'][i]:.3f} deg  RTE "
                        f"{run['rte'][i]:.4f} m" for i in range(len(m0)))
            + f"; half turns from the CPU's registrations {turns} (0: none); chamfer "
            f"/ spacing {max(chamfers):.3g} at most; {len(names)} artifacts; {ms:.0f} ms")
        result[name] = {"ms": ms, "launches": launches, "matches0": m0,
                        "rre": run["rre"], "rte": run["rte"], "half_turns": turns,
                        "chamfer_over_spacing": chamfers, "artifacts": names}
    result["phase_s"] = time.perf_counter() - phase_t0
    log(f"{tag}: the CPU's solve {result['cpu_ms']:.0f} ms; phase {result['phase_s']:.1f} s")
    report["demo"] = result


def load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class record_calls:
    """While active, module.name is wrapped so that each call's result is
    appended to `calls`."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*a, **k):
            out = self.fn(*a, **k)
            self.calls.append(out)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def check_eval_metrics(tag, got, record, n_inst, bounds, failures):
    """Log each metric of `got` beside the record's; append to `failures`
    the bounds broken. bounds: key -> "equal", ("instances", k) (recall
    within k instances), ("relative", r[, floor]) (within r of the record, or both
    at most floor), ("below", x) (at most x, whatever the record), or
    ("points", p)."""
    rows = []
    for key, bound in bounds.items():
        g, r = got[key], record[key]
        if bound == "equal":
            ok, allowed = g == r, "equal"
        elif bound[0] == "instances":
            allowed = bound[1] * 100.0 / n_inst
            ok = abs(g - r) <= allowed + 1e-9
            allowed = f"+-{allowed:.4g} ({bound[1]} instances)"
        elif bound[0] == "relative":
            floor = bound[2] if len(bound) > 2 else 0.0
            ok = g is not None and (abs(g - r) <= bound[1] * abs(r)
                                    or max(g, r) <= floor)
            allowed = f"+-{bound[1]:.0%}" + (f", or both below {floor:g}" if floor else "")
        elif bound[0] == "below":
            ok = g is not None and g <= bound[1]
            allowed = f"<= {bound[1]:g}"
        else:
            ok = abs(g - r) <= bound[1]
            allowed = f"+-{bound[1]} points"
        rows.append({"metric": key, "got": g, "record": r, "allowed": allowed, "ok": ok})
        log(f"eval: {tag}: {key} {g!r} (record {r!r}, allowed {allowed}) "
            f"{'ok' if ok else 'BROKEN'}")
        if not ok:
            failures.append(f"{tag}.{key} {g!r} against {r!r} ({allowed})")
    return rows


def optim_record_f32(rec_f32):
    """What float32 gives the refined relocalization of the first
    EVAL_OPTIM_SCENES scenes: the f32 record's recall on those instances
    (the refinement starts from its poses) and, for the medians, the f32
    record's whole-run values, logged beside the floors they are held to."""
    rre = np.concatenate(rec_f32["relocalization_rre_per_instance"][:EVAL_OPTIM_SCENES])
    rel = rec_f32["relocalization"]
    return {"recall_rre5": 100.0 * float(np.mean(rre < 5.0)),
            "recall_rre10": 100.0 * float(np.mean(rre < 10.0)),
            "median_chamfer": rel["median_chamfer"], "median_te_cm": rel["median_te_cm"]}


def near_thresholds(errs, thresholds=(5.0, 10.0), width=1.0):
    """Instances whose rotation error lies within `width` degrees of a
    recall threshold: (scene, object, rre), sorted by rre."""
    out = []
    for s, e in enumerate(errs):
        for o, rre in enumerate(e["rre"].tolist()):
            if any(abs(rre - t) <= width for t in thresholds):
                out.append((s, o, round(rre, 4)))
    return sorted(out, key=lambda x: x[2])


def phase_eval(torch, report):
    """The evaluation suite (livingscenes_tpu_torch/eval) on the capstone
    benchmark of scripts/torch_demo_trained_eval.py, with the r5 checkpoint
    and its solver settings (the production model through load_solver,
    fast=True; 1024 points an instance; meshes from a 32^3 grid refined
    once, simplified to 5000 faces; ICP acceptance "symch"):

    1. build_benchmark into a temporary directory: 24 scenes x 4
       procedural shapes x 1024 points (96 instances; seed 7, rotations
       from the stream 100 + scene) with their analytic ground-truth
       meshes.
    2. eval_matching, eval_relocalization(optim=False) and
       eval_reconstruction on all 24 scenes, and
       eval_relocalization(optim=True) (400 steps) on the first 12
       (48 instances: the first 12 scenes of the same generator, those of
       docs/demo_trained_eval_r5_48inst.json), each between setting the
       launch counts to 0 and reading them, every plain version forbidden.
       The counts must be exact: 48 encodes for matching; 48 encodes and
       24 x 100 ICP statistics for relocalization; with optim=True also
       12 x 801 Sinkhorn forwards and 12 x 800 backwards; 24 encodes for
       reconstruction. Rows 1-7 (and 9-10 with optim) launch; row 8 does
       not (1024 points take the kNN + scale kernel).
    3. The results are held to what the JAX package scored with the same
       checkpoint on the same benchmark:
       - matching: all five recalls equal to both records below (100.0);
       - against the JAX package on the CPU in float32
         (docs/demo_trained_eval_r5_96inst_jax_cpu.json, made by
         scripts/capstone_jax_cpu_reference.py): relocalization recall at
         RRE 5 and 10 deg within 3 instances (3.125 points) and
         median_chamfer and median_te_cm within 15 % or, where the record
         is at float32 round-off (the rescans are exact rigid copies, which
         f32 registers to within 1e-9 in chamfer and 1e-3 cm), below those
         floors; reconstruction viou_sampled_mean within 1.5 points,
         sdf_recall within 3 instances, chamfer_mean within 10 %;
       - the refined relocalization (48 instances) against what float32
         does on these scenes: the f32 record's unrefined poses of the
         first 12 scenes are all within 0.07 deg, and the refinement
         starts from them on exact rigid copies, where its transport loss
         is least at the exact pose. So recall at RRE 5 and 10 deg within
         3 instances (6.25 points) of the f32 record's recall on those 48
         instances (100), and median_chamfer and median_te_cm below the
         same float32 floors as the unrefined run (1e-9, 1e-3 cm). The
         only record of the refinement, docs/demo_trained_eval_r5_48inst.json,
         was made on a TPU, whose float32 matmuls are single bf16 passes
         (docs/ROUND5_NOTES.md section 1; the ICP statistics too): its
         median RRE of 2 deg is bf16 arithmetic's, so it is logged, not
         held.
       Bounds and not equality: the card and the CPU order near-ties of
       kNN and FPS differently (the f32 sums of distances differ in their
       last bits), and register shapes with a half-turn symmetry
       differently (either pose fits the points, ROADMAP.md Queue C), so
       single instances may cross a threshold or move a median. The TPU
       records' numbers are logged beside each metric, not held. Every
       broken bound fails the phase, after all are logged.

    Logs each metric beside its record, the instances within 1 deg of a
    recall threshold, each part's time, and the card with its power limit.
    """
    import shutil
    import tempfile

    from livingscenes_tpu_torch.eval import flyingshape as fs

    with open(EVAL_RECORDS[96]) as f:
        rec96 = json.load(f)
    with open(EVAL_RECORDS[48]) as f:
        rec48 = json.load(f)
    capstone = load_script("torch_demo_trained_eval")
    card = card_line()
    root = tempfile.mkdtemp(prefix="lstpu_eval_")
    times, launches, failures = {}, {}, []
    try:
        t0 = time.perf_counter()
        gt_meshes = capstone.build_benchmark(root, n_scenes=EVAL_SCENES, n_pts=N_PCL)
        times["build_benchmark_s"] = time.perf_counter() - t0
        solver = capstone.capstone_solver(CKPT, N_PCL, device="cuda")
        dataset = fs.FlyingShapeDataset(root)
        scenes = [dataset[i] for i in range(len(dataset))]
        if len(scenes) != EVAL_SCENES or len(gt_meshes) != 4 * EVAL_SCENES:
            raise AssertionError(f"eval: {len(scenes)} scenes, {len(gt_meshes)} meshes")

        def run(name, fn, want):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with forbid_plain():
                out, got = counted(fn)
            torch.cuda.synchronize()
            times[f"{name}_s"] = time.perf_counter() - t0
            launches[name] = check_launches(f"eval: {name}", got, want)
            return out

        results = {}
        results["matching"] = run(
            "matching", lambda: fs.eval_matching(scenes, solver),
            encode_want(2 * EVAL_SCENES))
        reloc_want = encode_want(2 * EVAL_SCENES)
        reloc_want["icp_stats"] = ICP_ITERS * EVAL_SCENES
        with record_calls(fs, "relocalization_errors") as errs:
            results["relocalization"] = run(
                "relocalization", lambda: fs.eval_relocalization(scenes, solver),
                reloc_want)
        optim_want = encode_want(2 * EVAL_OPTIM_SCENES)
        optim_want.update(icp_stats=ICP_ITERS * EVAL_OPTIM_SCENES,
                          sinkhorn=(1 + 2 * REFINE_STEPS) * EVAL_OPTIM_SCENES,
                          sinkhorn_bwd=2 * REFINE_STEPS * EVAL_OPTIM_SCENES)
        with record_calls(fs, "relocalization_errors") as errs_optim:
            results["relocalization_optim"] = run(
                "relocalization_optim",
                lambda: fs.eval_relocalization(scenes[:EVAL_OPTIM_SCENES], solver,
                                               optim=True), optim_want)
        with record_calls(fs, "reconstruction_scores") as scores:
            results["reconstruction"] = run(
                "reconstruction", lambda: fs.eval_reconstruction(
                    scenes, solver, gt_mesh_loader=lambda c, o: gt_meshes.get((c, o))),
                encode_want(EVAL_SCENES))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    with open(EVAL_RECORD_F32) as f:
        rec_f32 = json.load(f)
    checks = {}
    checks["matching"] = check_eval_metrics(
        "matching", results["matching"], rec96["matching"], 96,
        {k: "equal" for k in rec96["matching"]}, failures)
    checks["matching_f32"] = check_eval_metrics(
        "matching (f32)", results["matching"], rec_f32["matching"], 96,
        {k: "equal" for k in rec_f32["matching"]}, failures)
    checks["relocalization"] = check_eval_metrics(
        "relocalization (f32)", results["relocalization"], rec_f32["relocalization"],
        96, {"recall_rre5": ("instances", 3), "recall_rre10": ("instances", 3),
             "median_chamfer": ("relative", 0.15, 1e-9),
             "median_te_cm": ("relative", 0.15, 1e-3)}, failures)
    rec_f32_optim = optim_record_f32(rec_f32)
    checks["relocalization_optim"] = check_eval_metrics(
        "relocalization_optim (48, f32)", results["relocalization_optim"],
        rec_f32_optim, 48,
        {"recall_rre5": ("instances", 3), "recall_rre10": ("instances", 3),
         "median_chamfer": ("below", 1e-9), "median_te_cm": ("below", 1e-3)},
        failures)
    checks["reconstruction"] = check_eval_metrics(
        "reconstruction (f32)", results["reconstruction"], rec_f32["reconstruction"],
        96, {"viou_sampled_mean": ("points", 1.5), "sdf_recall": ("instances", 3),
             "chamfer_mean": ("relative", 0.10)}, failures)
    for name, rec, tpu in (
            ("relocalization", rec_f32["relocalization"], rec96["relocalization"]),
            ("relocalization_optim", rec_f32_optim, rec48["relocalization_optim"]),
            ("reconstruction", rec_f32["reconstruction"], rec96["reconstruction"])):
        for key, val in results[name].items():
            log(f"eval: {name}: {key} {val!r} (f32 record {rec.get(key)!r}, "
                f"TPU record {tpu.get(key)!r})")
    near = {"relocalization": near_thresholds(errs.calls),
            "relocalization_optim": near_thresholds(errs_optim.calls)}
    for name, rows in near.items():
        log(f"eval: {name}: instances within 1 deg of 5 or 10 deg (scene, object, "
            f"rre): {rows}")
    crossed = [(sc, o, round(card_rre, 4), round(cpu_rre, 4))
               for sc, (e, cpu) in enumerate(zip(errs.calls,
                                                 rec_f32["relocalization_rre_per_instance"]))
               for o, (card_rre, cpu_rre) in enumerate(zip(e["rre"].tolist(), cpu))
               if any((card_rre < th) != (cpu_rre < th) for th in (5.0, 10.0))]
    near["crossed_against_f32_record"] = crossed
    log(f"eval: relocalization: instances on the other side of 5 or 10 deg than in "
        f"the f32 record (scene, object, card rre, record rre): {crossed}")
    recon_scores = [s for scan in scores.calls for s in scan]
    low = [(i // 4, i % 4, round(s["iou_sampled"], 4), round(s["sdf_recall"], 4))
           for i, s in enumerate(recon_scores)
           if s["sdf_recall"] <= 0.7 or s["iou_sampled"] <= 0.5]
    log(f"eval: reconstruction: instances with sdf_recall <= 0.7 or sampled IoU "
        f"<= 0.5 (scene, object, iou, sdf recall): {low}")
    total = sum(v for k, v in times.items())
    log(f"eval: times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f"; phase {total:.1f} s on {card}")
    report["eval"] = {"results": results, "checks": checks, "launches": launches,
                      "times_s": times, "phase_s": total, "card": card,
                      "near_thresholds": near, "recon_low": low,
                      "per_instance": {
                          "relocalization": [{k: v.tolist() for k, v in e.items()}
                                             for e in errs.calls],
                          "relocalization_optim": [{k: v.tolist() for k, v in e.items()}
                                                   for e in errs_optim.calls],
                          "reconstruction": recon_scores}}
    if failures:
        raise AssertionError(f"eval: bounds broken: {failures}")


def phase_training(torch, report, profile: bool):
    """The training path through its entry point: train.run.main with the
    production config (configs/production_r5.yaml: the full-width encoder
    and decoder, batch 64, 1024 points, 1024 + 1024 queries), warm-started
    from the r5 checkpoint, TRAIN_STEPS steps, only the synthetic dataset
    shrunk to TRAIN_ITEMS items; counted, with every plain version
    forbidden and the launches of rows 12-14 timed as they ran (their plain
    VJPs then timed on the same inputs: the `kernels` line's numbers for
    those rows). Then from that state: the step timed (whole, and split into
    data, forward, backward, optimizer) with its peak memory, a profile
    with --profile, one step at batch TRAIN_CPU_BATCH against the CPU
    (dropout and the centre jitter off), a checkpoint round trip, and
    TRAIN_FRESH_STEPS steps from a fresh init whose loss must fall."""
    import shutil
    import tempfile

    from livingscenes_tpu_torch.train import run as train_run
    from livingscenes_tpu_torch.train.config import apply_overrides, load_config
    from livingscenes_tpu_torch.train.data import batch_iterator
    from livingscenes_tpu_torch.train.trainer import Trainer

    log_dir = tempfile.mkdtemp(prefix="lstpu_train_")
    overrides = [f"dataset.n_train_items={TRAIN_ITEMS}", "dataset.n_val_items=8",
                 f"logging.log_dir={log_dir}/run"]
    argv = ["--config", TRAIN_CONFIG, "--init-from", CKPT,
            "--total-iter", str(TRAIN_STEPS)]
    for ov in overrides:
        argv += ["--override", ov]
    try:
        t0 = time.perf_counter()
        with forbid_plain(), timed_bwd_launches(torch) as timed:
            (trainer, state), launches = counted(lambda: train_run.main(argv))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k: v for k, v in launches.items() if v}
        want = {k: TRAIN_STEPS * v for k, v in TRAIN_STEP_LAUNCHES.items()}
        log(f"training: train.run.main, {TRAIN_STEPS} steps from the r5 checkpoint "
            f"in {main_s:.1f} s (data cache included): launches {launches}")
        if launches != want:
            raise AssertionError(f"training: launches {launches}, expected {want}")
        run_times = timed.totals(torch, bwd_fns())
        del timed
        torch.cuda.empty_cache()
        with open(os.path.join(log_dir, "run", "metrics.jsonl")) as f:
            last = [json.loads(line) for line in f][-1]
        if last["step"] != TRAIN_STEPS or not all(
                np.isfinite(last[k]) for k in ("batch_loss", "grad_norm")):
            raise AssertionError(f"training: last log {last}")
        log(f"training: step {last['step']}: batch_loss {last['batch_loss']:.5g}, "
            f"grad_norm {last['grad_norm']:.5g}, lr {last['lr']:.3g}")
        result = {"config": os.path.relpath(TRAIN_CONFIG, ROOT), "steps": TRAIN_STEPS,
                  "main_s": main_s, "launches": launches, "last_log": last}

        cfg = apply_overrides(load_config(TRAIN_CONFIG), overrides)
        train_ds, _ = train_run.build_datasets(cfg)
        batches = batch_iterator(train_ds, trainer.cfg.batch_size, seed=1)
        result.update(time_training_steps(torch, trainer, state, batches, profile))
        result["cpu_check"] = training_cpu_check(torch, trainer.model, next(batches))

        # checkpoint round trip on the card
        trainer.save_checkpoint(state, "roundtrip")
        other = Trainer(train_run.build_model(cfg, device="cuda"), trainer.cfg)
        back = other.load_checkpoint(other.init_state(), "roundtrip")
        same = back.step == state.step and all(
            torch.equal(a, b) for a, b in zip(
                list(other.model.prior.state_dict().values())
                + back.opt_state["mu"] + back.opt_state["nu"],
                list(trainer.model.prior.state_dict().values())
                + state.opt_state["mu"] + state.opt_state["nu"]))
        if not same:
            raise AssertionError("training: the checkpoint round trip changed the state")
        log(f"training: checkpoint round trip at step {back.step}: equal")
        del other, back

        # a fresh init must learn
        fresh = Trainer(train_run.build_model(cfg, device="cuda"), trainer.cfg)
        fs = fresh.init_state()
        losses = [float(fresh.train_step(fs, next(batches))["batch_loss"])
                  for _ in range(TRAIN_FRESH_STEPS)]
        first, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"training: {TRAIN_FRESH_STEPS} steps from a fresh init: mean loss of "
            f"the first 5 {first:.5g}, of the last 5 {last5:.5g}")
        if not (all(np.isfinite(losses)) and last5 < first):
            raise AssertionError(f"training: the loss did not fall: {losses}")
        result["fresh"] = {"steps": TRAIN_FRESH_STEPS, "losses": losses}
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    report["training"] = result
    for name, times in run_times.items():
        r = report[name]
        r["per_step"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
        r.update(times, launches=launches[name])
        log(f"training: {name}: {launches[name]} launches in {TRAIN_STEPS} steps, "
            f"kernel {times['ms']:.3f} ms, plain VJP on the same inputs "
            f"{times['plain_ms']:.3f} ms, bound {times['bound_ms']:.4f} ms "
            f"({times['bound_by']})")


def time_training_steps(torch, trainer, state, batches, profile: bool,
                        n_timed=TRAIN_TIMED_STEPS):
    """Median ms of a training step over n_timed steps after 3 of warm-up
    (host clock, ended by a sync; the batch made before) and of its parts
    over n_timed more, each ended by a sync: the batch (made on the host
    and moved to the card), the forward (loss), the backward
    (autograd.grad), the optimizer (clip and Adam); peak memory over the
    timed steps. With `profile`, three steps under torch.profiler."""
    whole, parts = [], {"data": [], "forward": [], "backward": [], "optimizer": []}

    def split_step():
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        batch = trainer.place_batch(next(batches))
        mark()
        objective, _ = trainer.forward(batch, trainer.generator(state.step))
        mark()
        grads = torch.autograd.grad(objective, trainer.params)
        mark()
        trainer.apply_gradients(state, list(grads))
        state.step += 1
        mark()
        return np.diff(marks) * 1e3

    for i in range(3 + n_timed):
        b = next(batches)
        torch.cuda.synchronize()
        if i == 3:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train_step(state, b)
        torch.cuda.synchronize()
        if i >= 3:
            whole.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(n_timed):
        for key, ms in zip(parts, split_step()):
            parts[key].append(float(ms))
    step_ms = float(np.median(whole))
    split = {k: float(np.median(v)) for k, v in parts.items()}
    log(f"training: step at batch {trainer.cfg.batch_size}: median {step_ms:.2f} ms over "
        f"{len(whole)} steps (min {min(whole):.2f}, max {max(whole):.2f}); parts "
        "(median ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"; peak memory {peak_gb:.2f} GB")
    out = {"step_ms": step_ms, "step_ms_samples": whole, "split_ms": split,
           "peak_mem_gb": peak_gb}
    if profile:
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(state, next(batches))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        st = kernel_summary(torch, prof, wall)
        out["profile_3_steps"] = st
        log(f"training: profile of 3 steps: wall {wall:.1f} ms, device "
            f"{st['device_ms']:.1f} ms ({st['busy']:.1%} busy), {st['kernels']} kernel "
            "launches; top: "
            + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in st["top"][:10]))
    return out


def training_cpu_check(torch, model, batch, tag="training", rotations=None,
                       tol=CPU_CHECK_TOL, rows=None):
    """One step's loss and gradients at batch TRAIN_CPU_BATCH, card against
    CPU from the same parameters and batch (numpy arrays), dropout and the
    centre jitter off (the loss in eval mode, no generator), on clouds whose
    kNN graphs and FPS picks come out equal on both sides; with `rotations`
    (B, 3, 3) the same rotations on both sides (rot_aug). A cloud whose
    graph swaps a near-tie turns its codes by up to 1e-2 (ROADMAP.md Queue
    C, "Codes at a tie"), which moves the decoder's gradient past any
    rounding tolerance: such a cloud is named with the first layer that
    differs and replaced by the next cloud of the batch. Held, by `tol`
    (CPU_CHECK_TOL): the loss to rtol 1e-4, each component's gradient norm
    to rtol 1e-3, and the cosine between the card's and the CPU's gradient
    of every parameter to 0.999 (parameters whose gradient is under 1e-6 of
    their component's norm, whose direction is rounding, are left out).
    `rows`: the clouds to start from (default the first TRAIN_CPU_BATCH),
    e.g. those an earlier check on the same batch kept."""
    from livingscenes_tpu_torch.models.sim3recon import SIM3Recon

    cpu = SIM3Recon(model.config, model.loss_cfg, device="cpu")
    cpu.prior.load_state_dict(model.prior.state_dict())

    def loss_and_grads(m, dev, rows):
        b = {k: torch.as_tensor(v[rows], device=dev) for k, v in batch.items()}
        rot = None if rotations is None else torch.as_tensor(rotations[rows], device=dev)
        with record_graphs() as graphs:
            loss, _ = m.loss(b, None, train=False, rotations=rot)
        named = [(k, p) for k, p in m.prior.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return (float(loss.detach()),
                {k: g.double().cpu() for (k, _), g in zip(named, grads)}, graphs.calls)

    rows = list(range(TRAIN_CPU_BATCH)) if rows is None else list(rows)
    spare, swapped = max(rows) + 1, {}
    for _ in range(4):
        t0 = time.perf_counter()
        loss_cpu, g_cpu, graphs_cpu = loss_and_grads(cpu, "cpu", rows)
        cpu_s = time.perf_counter() - t0
        loss_card, g_card, graphs_card = loss_and_grads(model, model.prior.device, rows)
        first, _ = graph_differences(graphs_card, graphs_cpu, len(rows))
        if all(f is None for f in first):
            break
        swapped.update({rows[i]: f for i, f in enumerate(first) if f is not None})
        kept = [r for r, f in zip(rows, first) if f is None]
        n_new = len(rows) - len(kept)
        rows, spare = kept + list(range(spare, spare + n_new)), spare + n_new
    else:
        raise AssertionError(f"{tag}: no batch of equal graphs; swaps {swapped}")
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    norms, worst_cos, worst_name = {}, 1.0, None
    for comp in sorted({k.split(".")[0] for k in g_cpu}):
        keys = [k for k in g_cpu if k.startswith(comp + ".")]
        n_cpu = float(torch.sqrt(sum(torch.sum(g_cpu[k] ** 2) for k in keys)))
        n_card = float(torch.sqrt(sum(torch.sum(g_card[k] ** 2) for k in keys)))
        norms[comp] = {"card": n_card, "cpu": n_cpu, "rel": abs(n_card - n_cpu) / n_cpu}
        for k in keys:
            a, b = g_card[k].ravel(), g_cpu[k].ravel()
            if float(b.norm()) < 1e-6 * n_cpu:
                continue
            cos = float(a @ b / (a.norm() * b.norm()))
            if cos < worst_cos:
                worst_cos, worst_name = cos, k
    log(f"{tag}: card vs cpu, one step at batch {TRAIN_CPU_BATCH} (clouds {rows}; "
        "replaced for a graph that differs: "
        + (", ".join(f"cloud {r} at {f}" for r, f in swapped.items()) or "none")
        + f"): loss {loss_card:.7g} vs {loss_cpu:.7g} (rel {rel_loss:.3g}); gradient norms "
        + ", ".join(f"{c} {v['card']:.6g} vs {v['cpu']:.6g} (rel {v['rel']:.3g})"
                    for c, v in norms.items())
        + f"; smallest cosine {worst_cos:.6f} ({worst_name}) (cpu run {cpu_s:.1f} s)")
    loss_rtol, norm_rtol, min_cos = tol
    if (rel_loss > loss_rtol or any(v["rel"] > norm_rtol for v in norms.values())
            or worst_cos < min_cos):
        raise AssertionError(f"{tag}: card and CPU gradients differ beyond {tol}")
    return {"batch": TRAIN_CPU_BATCH, "clouds": rows, "replaced": swapped, "tol": tol,
            "loss_rel": rel_loss, "grad_norms": norms, "min_cosine": worst_cos,
            "min_cosine_param": worst_name}


def procedural_mesh(kind: int, rng):
    """A watertight mesh of one of train/data.py's analytic SDFs (0 box, 1
    ellipsoid, 2 capsule, 3 torus; sizes from rng), extracted with the
    port's isosurface on a SHAPENET_GRID^3 grid over [-0.6, 0.6]^3."""
    from livingscenes_tpu_torch.native.bindings import marching_isosurface
    from livingscenes_tpu_torch.recon.mesh import Mesh
    from livingscenes_tpu_torch.train import data

    n = SHAPENET_GRID
    g = np.linspace(-0.6, 0.6, n)
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    if kind == 0:
        sdf = data._sdf_box(p, rng.uniform(0.15, 0.45, 3))
    elif kind == 1:
        sdf = data._sdf_ellipsoid(p, rng.uniform(0.2, 0.45, 3))
    elif kind == 2:
        a = rng.uniform(-0.3, 0.3, 3)
        sdf = data._sdf_capsule(p, a, -a, rng.uniform(0.08, 0.2))
    else:
        sdf = data._sdf_torus(p, rng.uniform(0.25, 0.35), rng.uniform(0.06, 0.12))
    verts, faces = marching_isosurface(-sdf.reshape(n, n, n).astype(np.float32), 0.0)
    return Mesh((verts / (n - 1) * 1.2 - 0.6).astype(np.float32), faces)


def build_shapenet_tree(root, categories):
    """Two procedural objects for each category, object j of category c a
    mesh of kind (c + j) % 4, preprocessed in turn by the port's
    tools/preprocess.py (30,000 surface samples, SHAPENET_SAMPLES uniform and
    SHAPENET_SAMPLES near-surface ones, SHAPENET_VIEWS depth views of 240 x
    240); and the split CSV: the first object of each category in train
    (SHAPENET_TRAIN_ROWS rows), the second in val (SHAPENET_VAL_ROWS rows).
    Returns (split CSV path, objects). (Worker processes were slower: the
    kd-tree and containment queries already take every core.)"""
    from livingscenes_tpu_torch.tools.preprocess import preprocess_mesh

    n_obj = 0
    for c, cat in enumerate(categories):
        for j in range(2):
            rng = np.random.default_rng(1000 + 2 * c + j)
            preprocess_mesh(procedural_mesh((c + j) % 4, rng),
                            os.path.join(root, cat, f"obj{j}"), n_uni=SHAPENET_SAMPLES,
                            n_nss=SHAPENET_SAMPLES, n_views=SHAPENET_VIEWS, seed=2 * c + j)
            n_obj += 1
    rows = [f"{cat},obj0,train" for cat in categories for _ in range(SHAPENET_TRAIN_ROWS)]
    rows += [f"{cat},obj1,val" for cat in categories for _ in range(SHAPENET_VAL_ROWS)]
    split_csv = os.path.join(root, "split.csv")
    with open(split_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return split_csv, n_obj


def labelled_batch(ds, categories, idx):
    """The items idx of a ShapeNet dataset stacked, with "class" the index
    of each item's category in `categories`."""
    items = [ds[int(i)] for i in idx]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    batch["class"] = np.array([categories.index(ds.items[int(i)][0]) for i in idx],
                              np.float32)
    return batch


def phase_shapenet(torch, report):
    """Training on the production ShapeNet configuration
    (configs/production_shapenet.yaml: shapenet_new2, input_mode dep with 2-8
    of 12 depth views, seven categories, the full-width model, batch 64,
    1024 points, 1024 + 1024 queries) and the mesh-vertex refinement, on the
    card. The repository holds no ShapeNet data, so a tree is built on the
    host first (build_shapenet_tree; its seconds are logged).
    1. train.run.main from the r5 checkpoint for SHAPENET_STEPS steps with
       only data_root, shapenet_split_fn and log_dir overridden, under
       forbid_plain: launches exactly SHAPENET_STEPS x TRAIN_STEP_LAUNCHES,
       a finite last loss. Then the step timed and split (data: the items
       read from disk and stacked, and the batch moved to the card;
       forward; backward; optimizer), with its peak memory.
    2. One step at TRAIN_CPU_BATCH on a ShapeNet batch, card against CPU
       (training_cpu_check): as trained, with rot_aug (the same rotations
       on both sides), with decoder_bf16 (CPU_CHECK_TOL_BF16), and with the
       class head (use_cls, seven categories; labels the items' category
       index).
    3. One visualize_sample firing (viz_iter_interval 1) must write its OBJ
       and PNG files; in anomaly mode a NaN planted in the encoder's conv_c
       weight must raise an error naming that module and parameter (conv_c
       runs after the last kNN and FPS, so no kernel indexes by a NaN).
    4. The refinement: REFINE_MESHES shapes of make_shape_scenes encoded
       with the r5 checkpoint, meshed at the shipped MeshExtractorConfig and
       refined for REFINE_MESH_STEPS steps (draws from a generator on the
       card): ms a step and faces a mesh; the mean |sigmoid(logit) -
       threshold| at the face centroids must fall against the unrefined
       mesh; the first mesh's refined vertices against the CPU port's from
       the same mesh and draws within REFINE_TOL of the box size; and
       MeshExtractor(refinement_step=...).generate_from_codes, the entry
       point, under torch.no_grad() gives those vertices scaled and moved by
       the code's s and t."""
    import shutil
    import tempfile

    from livingscenes_tpu_torch.models.sim3recon import SIM3Recon
    from livingscenes_tpu_torch.se3 import random_rotation
    from livingscenes_tpu_torch.train import run as train_run
    from livingscenes_tpu_torch.train.config import apply_overrides, load_config
    from livingscenes_tpu_torch.train.data import batch_iterator
    from livingscenes_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lstpu_shapenet_")
    result = {}
    try:
        categories = list(load_config(SHAPENET_CONFIG)["dataset"]["categories"])
        t0 = time.perf_counter()
        split_csv, n_obj = build_shapenet_tree(os.path.join(tmp, "data"), categories)
        tree_s = time.perf_counter() - t0
        log(f"shapenet: {n_obj} procedural objects preprocessed in {tree_s:.1f} s "
            f"(30000 surface, {SHAPENET_SAMPLES} uniform, {SHAPENET_SAMPLES} near-surface "
            f"samples, cut from 100000 each for time; {SHAPENET_VIEWS} views each)")
        overrides = [f"dataset.data_root={tmp}/data", f"dataset.shapenet_split_fn={split_csv}",
                     f"logging.log_dir={tmp}/run"]
        argv = ["--config", SHAPENET_CONFIG, "--init-from", CKPT,
                "--total-iter", str(SHAPENET_STEPS)]
        for ov in overrides:
            argv += ["--override", ov]
        t0 = time.perf_counter()
        with forbid_plain():
            (trainer, state), launches = counted(lambda: train_run.main(argv))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k: v for k, v in launches.items() if v}
        want = {k: SHAPENET_STEPS * v for k, v in TRAIN_STEP_LAUNCHES.items()}
        if launches != want:
            raise AssertionError(f"shapenet: launches {launches}, expected {want}")
        with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
            last = [json.loads(line) for line in f][-1]
        if last["step"] != SHAPENET_STEPS or not all(
                np.isfinite(last[k]) for k in ("batch_loss", "grad_norm")):
            raise AssertionError(f"shapenet: last log {last}")
        log(f"shapenet: train.run.main, {SHAPENET_STEPS} steps from the r5 checkpoint in "
            f"{main_s:.1f} s: launches as expected; step {last['step']}: batch_loss "
            f"{last['batch_loss']:.5g}, grad_norm {last['grad_norm']:.5g}")
        cfg = apply_overrides(load_config(SHAPENET_CONFIG), overrides)
        train_ds, val_ds = train_run.build_datasets(cfg)
        result.update(tree_s=tree_s, objects=n_obj, train_items=len(train_ds),
                      val_items=len(val_ds), main_s=main_s, launches=launches,
                      last_log=last)
        batches = batch_iterator(train_ds, trainer.cfg.batch_size, seed=1)
        result.update(time_training_steps(torch, trainer, state, batches, False,
                                          n_timed=SHAPENET_TIMED_STEPS))

        # card against CPU, as trained and with each option
        model = trainer.model
        idx = np.random.default_rng(5).permutation(len(train_ds))[:3 * TRAIN_CPU_BATCH]
        batch = labelled_batch(train_ds, categories, idx)
        plain = {k: v for k, v in batch.items() if k != "class"}
        checks = {"trained": training_cpu_check(torch, model, plain, "shapenet")}
        rot = random_rotation(torch.Generator().manual_seed(11), (len(idx),)).numpy()
        replace = dataclasses.replace
        variants = (("rot_aug", model.config, replace(model.loss_cfg, rot_aug=True)),
                    ("decoder_bf16", model.config,
                     replace(model.loss_cfg, decoder_bf16=True)),
                    ("cls_head", replace(model.config, use_cls=True,
                                         num_cates=len(categories)), model.loss_cfg))
        for name, prior_cfg, loss_cfg in variants:
            other = SIM3Recon(prior_cfg, loss_cfg, device="cuda")
            other.prior.load_state_dict(model.prior.state_dict(), strict=name != "cls_head")
            checks[name] = training_cpu_check(
                torch, other, batch if name == "cls_head" else plain, f"shapenet {name}",
                rotations=rot if name == "rot_aug" else None,
                tol=CPU_CHECK_TOL_BF16 if name == "decoder_bf16" else CPU_CHECK_TOL,
                rows=checks["trained"]["clouds"])
            del other
        result["cpu_checks"] = checks

        # one visualize_sample firing, then the anomaly mode
        viz_cfg = replace(trainer.cfg, viz_iter_interval=1, log_dir=f"{tmp}/viz",
                          checkpoint_iter=0)
        val_factory = lambda: batch_iterator(val_ds, max(2, trainer.cfg.batch_size // 8),
                                             seed=1)
        step = state.step + 1
        Trainer(model, viz_cfg).run(state, batches, val_factory, total_iter=step)
        viz = sorted(os.listdir(f"{tmp}/viz/viz"))
        if viz != [f"input_{step}.png", f"recon_{step}.obj", f"recon_{step}.png"]:
            raise AssertionError(f"shapenet: visualize_sample wrote {viz}")
        log(f"shapenet: visualize_sample at step {step} wrote {viz}")
        name = "encoder.conv_c.lin.weight"
        param = dict(model.prior.named_parameters())[name]
        saved = param.detach().clone()
        anomaly = Trainer(model, replace(trainer.cfg, anomaly=True, log_dir=f"{tmp}/anomaly"))
        with torch.no_grad():
            param.view(-1)[0] = float("nan")
        try:
            anomaly.train_step(anomaly.init_state(), next(batches))
            raise AssertionError("shapenet: anomaly mode let a NaN parameter through")
        except RuntimeError as e:
            message = str(e)
        finally:
            with torch.no_grad():
                param.copy_(saved)
        if "conv_c.lin:VecLinear" not in message or name not in message:
            raise AssertionError(f"shapenet: the anomaly report names no module: {message}")
        log(f"shapenet: {message[:300]}")
        result["viz_files"], result["anomaly"] = viz, message
        del trainer, state, model, anomaly
        torch.cuda.empty_cache()

        result["refinement"] = refinement_check(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"shapenet: phase {result['phase_s']:.1f} s")
    report["shapenet"] = result


def refinement_check(torch):
    """Part 4 of phase_shapenet: the mesh-vertex refinement on the card."""
    from livingscenes_tpu_torch.models.convert import load_flax_checkpoint, params_from_jax
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig, slice_codes)
    from livingscenes_tpu_torch.ops.cuda_fps import fps_auto
    from livingscenes_tpu_torch.recon.extractor import (
        MeshExtractor, MeshExtractorConfig, dirichlet_draws, refine_mesh_vertices)

    state = params_from_jax(load_flax_checkpoint(CKPT))
    model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cuda")
    model.load_state_dict(state)
    ref, _ = make_shape_scenes(np.random.default_rng(3), 1)
    pc = fps_auto(torch.as_tensor(ref[0, :REFINE_MESHES], device="cuda"), N_PCL)[0]
    with torch.no_grad():
        codes = model.encode(pc)
    cfg = MeshExtractorConfig(refinement_step=REFINE_MESH_STEPS)
    plain_ext = MeshExtractor(model.occupancy_logits, dataclasses.replace(cfg, refinement_step=0))

    def deviation(field, codes, verts, faces):
        p = torch.as_tensor(verts[faces].mean(axis=1), dtype=torch.float32,
                            device=codes["s"].device)
        with torch.no_grad():
            return float(torch.mean(torch.abs(
                torch.sigmoid(field(p[None], codes)[0]) - cfg.threshold)))

    rows = []
    for i in range(REFINE_MESHES):
        c = slice_codes(codes, i)
        can = dict(c, s=torch.ones_like(c["s"]), t=torch.zeros_like(c["t"]))
        grid, _ = plain_ext.compute_grid(can)
        mesh = plain_ext.extract_from_grid(grid.cpu().numpy())
        if mesh.is_empty:
            raise AssertionError(f"refinement: shape {i} gave no mesh")
        eps = dirichlet_draws(torch.Generator(device="cuda").manual_seed(i),
                              REFINE_MESH_STEPS, len(mesh.faces))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined = refine_mesh_vertices(model.occupancy_logits, can, mesh.vertices,
                                       mesh.faces, REFINE_MESH_STEPS, cfg.threshold,
                                       cfg.refinement_lr, eps=eps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / REFINE_MESH_STEPS
        refined = refined.cpu().numpy()
        before = deviation(model.occupancy_logits, can, mesh.vertices, mesh.faces)
        after = deviation(model.occupancy_logits, can, refined, mesh.faces)
        row = {"faces": len(mesh.faces), "ms_per_step": ms, "dev_before": before,
               "dev_after": after,
               "moved_max": float(np.abs(refined - mesh.vertices).max())}
        if not (np.isfinite(refined).all() and after < before):
            raise AssertionError(f"refinement: shape {i}: {row}")
        if i == 0:
            cpu = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cpu")
            cpu.load_state_dict(state)
            t0 = time.perf_counter()
            on_cpu = refine_mesh_vertices(
                cpu.occupancy_logits, {k: v.cpu() for k, v in can.items()}, mesh.vertices,
                mesh.faces, REFINE_MESH_STEPS, cfg.threshold, cfg.refinement_lr,
                eps=eps.cpu()).numpy()
            row["cpu_s"] = time.perf_counter() - t0
            row["cpu_max_diff_over_box"] = float(np.abs(refined - on_cpu).max()) / cfg.box_size
            # the entry point, under no_grad, as the solver calls it
            with torch.no_grad():
                entry = MeshExtractor(model.occupancy_logits, cfg).generate_from_codes(
                    c, refine_eps=eps)
            s, t = float(c["s"].reshape(-1)[0]), c["t"].reshape(3).cpu().numpy()
            row["entry_point_diff"] = float(np.abs(entry.vertices - (refined * s + t)).max())
            if (row["cpu_max_diff_over_box"] > REFINE_TOL
                    or not np.array_equal(entry.faces, mesh.faces)
                    or row["entry_point_diff"] > 1e-5 * max(abs(s), 1.0)):
                raise AssertionError(f"refinement: shape 0 against the CPU: {row}")
        log(f"refinement: shape {i}: {row['faces']} faces, {ms:.2f} ms a step, mean "
            f"|p - {cfg.threshold}| at the face centroids {before:.6g} -> {after:.6g}, "
            f"moved up to {row['moved_max']:.3g}"
            + (f"; against the CPU up to {row['cpu_max_diff_over_box']:.3g} of the box "
               f"(CPU {row['cpu_s']:.1f} s), entry point {row['entry_point_diff']:.3g}"
               if i == 0 else ""))
        rows.append(row)
    return {"steps": REFINE_MESH_STEPS, "meshes": rows,
            "ms_per_step": float(np.median([r["ms_per_step"] for r in rows])),
            "faces": float(np.mean([r["faces"] for r in rows]))}


class count_plain_scale:
    """While active, shape_prior's plain scale statistic (what
    normalize_input takes with pallas_attention off) counts its calls in
    `calls`; every other plain version is left to forbid_plain."""

    def __enter__(self):
        from livingscenes_tpu_torch.models import shape_prior as sp

        self.sp, self.real, self.calls = sp, sp.top_k_mean_pairwise_distance_plain, 0

        def counted_plain(*a, **k):
            self.calls += 1
            return self.real(*a, **k)

        sp.top_k_mean_pairwise_distance_plain = counted_plain
        return self

    def __exit__(self, *exc):
        self.sp.top_k_mean_pairwise_distance_plain = self.real


def variant_state(model, state):
    """The model's state dict with each entry the r5 checkpoint has taken
    from it: a head r5 lacks (fc_O) keeps the model's seeded init, and an
    r5 head the variant lacks (fc_center without center_pred) is left out."""
    own = model.state_dict()
    return {k: state[k] if k in state else own[k] for k in own}


def backed(w, input_tol=1e-3):
    """Whether a tie witness (knn_tie_witness, fps_tie_witness) backs its
    difference: each side's pick right (for FPS also a near-tie) on its own
    inputs, and the two sides' inputs within input_tol of their largest
    entry; at 1e-3 (float32 rounding through the layers before) this is the
    witness's own `near_tie`."""
    return w["inputs_rel_diff"] <= input_tol and all(
        w[side]["pick_right"] and w[side].get("near_tie", True)
        for side in ("card", "cpu"))


def code_gaps(torch, a, b, equivariant):
    """Per cloud: max|R - I| of the rotation between codes a and b (Kabsch on
    z_so3 + t; 0 without `equivariant`), z_inv's largest difference over
    b's largest entry, and s's relative difference."""
    from livingscenes_tpu_torch.solver.registration import kabsch_from_codes

    n = b["s"].shape[0]
    dR = (torch.zeros(n, dtype=torch.float64) if not equivariant else
          (kabsch_from_codes(a, b).R - torch.eye(3, dtype=b["s"].dtype))
          .abs().amax(dim=(1, 2)).double())
    zi = ((a["z_inv"] - b["z_inv"]).abs().amax(-1) / b["z_inv"].abs().amax(-1)).double()
    s_rel = ((a["s"] - b["s"]).abs() / b["s"].abs()).double()
    return dR, zi, s_rel


def hold_codes(torch, tag, card, cpu, card_graphs, cpu_graphs, equivariant, tol,
               input_tol=1e-3, ref64=None):
    """Card codes against CPU codes of the first len(cpu["s"]) clouds. With
    `equivariant` the codes' rotation (code_gaps) must be the identity
    within `tol` where the two sides built the same kNN graphs and FPS picks
    in every layer, within VARIANT_SWAP_TOL elsewhere, and each such first
    difference must be backed by its f64 witness (`backed` with input_tol);
    z_inv within `tol` of each cloud's largest entry (VARIANT_SWAP_TOL after
    a swap), s within 1e-2 relative, matches0 of z_inv the identity. With
    `ref64`, the codes of a float64 CPU run on the same sampled points, an
    equal-graph cloud is held instead to the card being as close to it as
    the float32 CPU run is: each gap at most 4 times the CPU's plus 1e-6
    (for weights, such as a seeded init, whose products cancel more than
    r5's). Returns the figures."""
    from livingscenes_tpu_torch.solver.matcher import sequential_matcher

    n = cpu["s"].shape[0]
    card = {k: v[:n].float().cpu() for k, v in card.items()}
    cpu = {k: v.float() for k, v in cpu.items()}
    for key, val in card.items():
        if not bool(torch.isfinite(val).all()):
            raise AssertionError(f"{tag}: non-finite {key} on the card")
    first, per_layer = graph_differences(card_graphs.calls, cpu_graphs.calls, n)
    same = [f is None for f in first]
    dR, zi, s_rel = code_gaps(torch, card, cpu, equivariant)
    witnesses = {c: witness_first_difference(torch, card_graphs, cpu_graphs, first[c], c)
                 for c in range(n) if first[c] is not None}
    for c, w in witnesses.items():
        log_witness(tag, f"cloud {c}", w)
    matched = sequential_matcher(card["z_inv"][None], cpu["z_inv"][None])["matches0"][0]
    close = [max(float(dR[c]), float(zi[c])) <= tol for c in range(n)]
    out = {"clouds": n, "max_abs_dR": float(dR.max()), "max_z_inv_rel": float(zi.max()),
           "max_s_rel": float(s_rel.max()), "equal_graph_clouds": int(sum(same)),
           "first_differences": {c: first[c] for c in witnesses},
           "graph_rows_differing": per_layer, "tol": tol}
    if ref64 is not None:
        ref64 = {k: v.double() for k, v in ref64.items()}
        g_card = code_gaps(torch, {k: v.double() for k, v in card.items()}, ref64,
                           equivariant)
        g_cpu = code_gaps(torch, {k: v.double() for k, v in cpu.items()}, ref64,
                          equivariant)
        close = [all(float(gc[c]) <= 4 * float(gp[c]) + 1e-6
                     for gc, gp in zip(g_card, g_cpu)) for c in range(n)]
        out["vs_float64"] = {
            side: {name: float(g.max()) for name, g in zip(("dR", "z_inv", "s"), gaps)}
            for side, gaps in (("card", g_card), ("cpu", g_cpu))}
    bad = [c for c in range(n)
           if not (close[c] if same[c] else
                   max(float(dR[c]), float(zi[c])) <= VARIANT_SWAP_TOL
                   and backed(witnesses[c], input_tol))]
    log(f"{tag}: card vs cpu on clouds 0-{n - 1}: max|R - I| {out['max_abs_dR']:.3g}, "
        f"z_inv {out['max_z_inv_rel']:.3g}, s {out['max_s_rel']:.3g} (rel)"
        + ("" if ref64 is None else "; against the float64 CPU run, card / cpu: "
           + ", ".join(f"{k} {out['vs_float64']['card'][k]:.3g} / "
                       f"{out['vs_float64']['cpu'][k]:.3g}" for k in ("dR", "z_inv", "s")))
        + f"; {out['equal_graph_clouds']} clouds with equal graphs; the others: "
        + (", ".join(f"cloud {c}: {f}" for c, f in out["first_differences"].items())
           or "none"))
    if bad or float(s_rel.max()) > 1e-2 or matched.tolist() != list(range(n)):
        raise AssertionError(f"{tag}: card and CPU codes differ: clouds {bad}, {out}, "
                             f"matches {matched.tolist()}")
    return out


def encode_variant(torch, tag, cfg, state, ref, want, equivariant=True,
                   tol=VARIANT_TOL, forbid=True, cpu_run=None, input_tol=1e-3,
                   f64=False, n_cpu=VARIANT_CPU_CLOUDS, profile=False):
    """encode_fps of the (B, N_FULL, 3) clouds `ref` (on the card) through
    ShapePrior(cfg) with the weights `state` (variant_state): counted (held
    to `want`) with the plain scale statistic counted as "plain_scale" and,
    with `forbid`, every other plain version forbidden (without it, as
    phase_pipeline runs the default config, the encoder's own plain layers
    run); timed (median of 5 calls after one); then the first n_cpu clouds
    through the same model on the CPU, or
    `cpu_run` from an earlier call with the same weights (hold_codes with
    `tol` and `input_tol`; with `f64` also against a float64 CPU encode of
    the CPU's sampled points). With `profile`, one more encode under
    torch.profiler: its device ms, busy share and heaviest kernels
    (kernel_summary). Returns (figures, cpu_run)."""
    import contextlib

    from livingscenes_tpu_torch.models.shape_prior import ShapePrior
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling as fps_plain

    model = ShapePrior(cfg, device="cuda")
    model.load_state_dict(variant_state(model, state))
    with torch.inference_mode():
        model.encode_fps(ref)  # warm-up
        torch.cuda.synchronize()
        with (forbid_plain() if forbid else contextlib.nullcontext(),
              count_plain_scale() as plain,
              record_graphs(keep_inputs=True) as card_graphs):
            codes, launches = counted(lambda: model.encode_fps(ref))
            torch.cuda.synchronize()
        launches = {k: v for k, v in launches.items() if v}
        if plain.calls:
            launches["plain_scale"] = plain.calls
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode_fps(ref)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        split = None
        if profile:
            from torch.profiler import ProfilerActivity

            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.encode_fps(ref)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            split = kernel_summary(torch, prof, wall)
            log(f"{tag}: profile of one encode: wall {wall:.1f} ms, device "
                f"{split['device_ms']:.1f} ms ({split['busy']:.1%} busy), "
                f"{split['kernels']} kernel launches; top: "
                + "; ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in split["top"][:8]))
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    cpu_s = 0.0
    if cpu_run is None:
        cpu_state = {k: v.cpu() for k, v in model.state_dict().items()}
        cpu_model = ShapePrior(cfg, device="cpu")
        cpu_model.load_state_dict(cpu_state)
        t0 = time.perf_counter()
        with torch.inference_mode(), record_graphs(keep_inputs=True) as cpu_graphs:
            sampled = fps_plain(ref[:n_cpu].cpu(), cfg.n_pcl)[0]
            cpu_codes = cpu_model.encode(sampled)
        codes64 = None
        if f64:
            model64 = ShapePrior(cfg, device="cpu", dtype=torch.float64)
            model64.load_state_dict(cpu_state)
            with torch.inference_mode():
                codes64 = model64.encode(sampled.double())
        cpu_s = time.perf_counter() - t0
        cpu_run = (cpu_codes, cpu_graphs, codes64)
    cpu_codes, cpu_graphs, codes64 = cpu_run
    ms = float(np.median(samples))
    log(f"{tag}: encode_fps {ref.shape[0]}x{ref.shape[1]} -> {cfg.n_pcl}: launches "
        f"{launches}, median {ms:.2f} ms over 5 calls (cpu check {cpu_s:.1f} s)")
    held = hold_codes(torch, tag, codes, cpu_codes, card_graphs, cpu_graphs,
                      equivariant, tol, input_tol, codes64)
    figures = {"launches": launches, "ms": ms, "ms_samples": samples, "cpu_s": cpu_s,
               "cpu_check": held}
    if split is not None:
        figures["profile"] = split
    return figures, cpu_run


def cpu_spread(torch, cfg, state, ref, rel=1e-7):
    """How far a float32 rounding of the input moves the codes on the CPU
    alone: the first VARIANT_CPU_CLOUDS clouds of `ref` FPS-sampled to
    n_pcl, encoded as they are and moved by `rel` of themselves (a seeded
    normal draw); max|R - I| (Kabsch on z_so3 + t) and z_inv's change over
    its largest entry, the largest over the clouds."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior
    from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
    from livingscenes_tpu_torch.solver.registration import kabsch_from_codes

    model = ShapePrior(cfg, device="cpu")
    model.load_state_dict(variant_state(model, state))
    with torch.inference_mode():
        pts = farthest_point_sampling(ref[:VARIANT_CPU_CLOUDS].cpu(), cfg.n_pcl)[0]
        noise = torch.randn(pts.shape, generator=torch.Generator().manual_seed(3))
        a, b = model.encode(pts), model.encode(pts * (1 + rel * noise))
    dR = (kabsch_from_codes(a, b).R - torch.eye(3)).abs().amax(dim=(1, 2))
    zi = (a["z_inv"] - b["z_inv"]).abs().amax(-1) / a["z_inv"].abs().amax(-1)
    return {"rel": rel, "max_abs_dR": float(dR.max()), "max_z_inv_rel": float(zi.max())}


def variant_training(torch, report_v):
    """(c): train.run.main on configs/production_r5.yaml with
    model.encoder.center_pred=false and model.decoder_type=inner (no centre
    head, DecoderCat), from a fresh init, VARIANT_TRAIN_STEPS steps at batch
    64 on VARIANT_TRAIN_ITEMS synthetic items, counted (launches a step
    exactly TRAIN_STEP_LAUNCHES, every plain version forbidden), then the
    step timed and split. Then one step from r5 with decoder_type deepsdf
    and one with inner_deepsdf on the same batch and seeds: the same
    batch_loss bits."""
    import shutil
    import tempfile

    from livingscenes_tpu_torch.train import run as train_run
    from livingscenes_tpu_torch.train.config import apply_overrides, load_config
    from livingscenes_tpu_torch.train.data import batch_iterator
    from livingscenes_tpu_torch.train.trainer import Trainer

    log_dir = tempfile.mkdtemp(prefix="lstpu_variants_")
    overrides = [f"dataset.n_train_items={VARIANT_TRAIN_ITEMS}", "dataset.n_val_items=8",
                 f"logging.log_dir={log_dir}/run", "model.encoder.center_pred=false",
                 "model.decoder_type=inner"]
    argv = ["--config", TRAIN_CONFIG, "--total-iter", str(VARIANT_TRAIN_STEPS)]
    for ov in overrides:
        argv += ["--override", ov]
    try:
        t0 = time.perf_counter()
        with forbid_plain():
            (trainer, state), launches = counted(lambda: train_run.main(argv))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {k: v for k, v in launches.items() if v}
        want = {k: VARIANT_TRAIN_STEPS * v for k, v in TRAIN_STEP_LAUNCHES.items()}
        prior = trainer.model.prior
        if (hasattr(prior.encoder, "fc_center")
                or type(prior.decoder).__name__ != "DecoderCat"):
            raise AssertionError("variants: the YAML's options did not reach the model")
        log(f"variants: train.run.main center_pred=false, decoder_type=inner, "
            f"{VARIANT_TRAIN_STEPS} steps from a fresh init in {main_s:.1f} s: "
            f"launches {launches}")
        if launches != want:
            raise AssertionError(f"variants training: launches {launches}, expected {want}")
        with open(os.path.join(log_dir, "run", "metrics.jsonl")) as f:
            last = [r for r in map(json.loads, f) if "grad_norm" in r][-1]
        if not all(np.isfinite(last[k]) for k in ("batch_loss", "grad_norm")):
            raise AssertionError(f"variants training: last log {last}")
        cfg = apply_overrides(load_config(TRAIN_CONFIG), overrides)
        train_ds, _ = train_run.build_datasets(cfg)
        batches = batch_iterator(train_ds, trainer.cfg.batch_size, seed=1)
        timed = time_training_steps(torch, trainer, state, batches, False,
                                    n_timed=VARIANT_TIMED_STEPS)
        result = {"steps": VARIANT_TRAIN_STEPS, "main_s": main_s, "launches": launches,
                  "last_log": last, **timed}

        # decoder_type deepsdf is inner_deepsdf: one step from r5, bit for bit
        batch = next(batches)
        losses = {}
        for decoder_type in ("inner_deepsdf", "deepsdf"):
            dcfg = apply_overrides(load_config(TRAIN_CONFIG), [
                f"logging.log_dir={log_dir}/{decoder_type}",
                f"model.decoder_type={decoder_type}"])
            model = train_run.build_model(dcfg, device="cuda")
            model.prior.load_state_dict(train_run.load_init_params(CKPT))
            tr = Trainer(model, train_run.build_trainer_cfg(dcfg))
            metrics = tr.train_step(tr.init_state(), batch)
            losses[decoder_type] = float(metrics["batch_loss"])
        log(f"variants: one step from r5 on the same batch and seeds: batch_loss "
            f"inner_deepsdf {losses['inner_deepsdf']!r}, deepsdf {losses['deepsdf']!r}")
        if losses["inner_deepsdf"] != losses["deepsdf"]:
            raise AssertionError(f"variants: deepsdf and inner_deepsdf differ: {losses}")
        result["deepsdf_step_loss"] = losses
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    report_v["training"] = result


def variant_decoders(torch, report_v, state, ref):
    """(d): the ONet decoders (JAX's default widths, parameters from a
    seeded init moved by 0.05 so that the zero-initialized layers condition)
    on 64 codes x ONET_POINTS queries, the first ONET_CPU_CODES codes
    against the CPU (within 1e-4 of the largest value); then
    extract_surface_points at UDF_POINTS points on the analytic sphere
    (radius 0.4) and on |SDF| of the r5 decoder at the codes of cloud 0 in
    the codes' canonical frame, each card against CPU from the same draws (the decoder's field on the
    CPU at UDF_CPU_POINTS points, also run on the card from those draws):
    the masks equal, the points within 1e-4 of the box; the card's own runs
    accept most points, the sphere's on it within 0.02."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior
    from livingscenes_tpu_torch.nn import onet_decoder
    from livingscenes_tpu_torch.recon.udf import (
        UDFExtractorConfig, extract_surface_points, udf_draws)

    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=(B, ONET_POINTS, 3)) * 0.5, dtype=torch.float32)
    c = torch.as_tensor(rng.normal(size=(B, 128)), dtype=torch.float32)
    onet = {}
    for name in ("Decoder", "DecoderCBatchNorm"):
        dec = onet_decoder.init_parameters(getattr(onet_decoder, name)(),
                                           torch.Generator().manual_seed(0))
        with torch.no_grad():
            for prm in dec.parameters():
                prm.add_(0.05)
        card_dec = getattr(onet_decoder, name)().cuda()
        card_dec.load_state_dict(dec.state_dict())
        with torch.inference_mode():
            out = card_dec(p.cuda(), c.cuda())
            ms = cuda_ms(torch, lambda: card_dec(p.cuda(), c.cuda()), 5)
            want = dec(p[:ONET_CPU_CODES], c[:ONET_CPU_CODES])
        got = out[:ONET_CPU_CODES].cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"variants: {name} {B}x{ONET_POINTS}: {ms:.3f} ms, card vs cpu on "
            f"{ONET_CPU_CODES} codes {rel:.3g} of the largest value")
        if not (bool(torch.isfinite(out).all()) and rel <= 1e-4):
            raise AssertionError(f"variants: {name} card and CPU differ by {rel}")
        onet[name] = {"ms": ms, "cpu_rel": rel}

    sphere = lambda q: torch.abs(torch.linalg.norm(q, dim=-1) - 0.4)
    model = ShapePrior(device="cuda")
    model.load_state_dict(state)
    with torch.no_grad():
        codes = model.encode_fps(ref[:1])
    cpu_model = ShapePrior(device="cpu")
    cpu_model.load_state_dict(state)

    def canonical_udf(m, c):
        """|SDF| of the decoder at the codes c, at points of the code's
        canonical frame (world = t + s q), where the extraction box lies."""
        return lambda q: torch.abs(m.decode_sdf((c["t"][0] + c["s"][0] * q)[None], c)[0])

    fields = {
        "sphere": (sphere, sphere, UDF_POINTS),
        "r5_decoder": (canonical_udf(model, codes), canonical_udf(
            cpu_model, {k: v.cpu() for k, v in codes.items()}), UDF_CPU_POINTS),
    }
    udf = {}
    for name, (f_card, f_cpu, n_cpu) in fields.items():
        cfg = UDFExtractorConfig(num_points=UDF_POINTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts, mask = extract_surface_points(f_card, cfg, torch.Generator(
            device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        small = UDFExtractorConfig(num_points=n_cpu)
        draws = udf_draws(small, torch.Generator().manual_seed(2))
        card_pts, card_mask = extract_surface_points(f_card, small, draws=draws, device="cuda")
        t0 = time.perf_counter()
        cpu_pts, cpu_mask = extract_surface_points(f_cpu, small, draws=draws, device="cpu")
        cpu_s = time.perf_counter() - t0
        gap = float((card_pts.cpu() - cpu_pts).abs().max()) / small.box_size
        same_mask = bool(torch.equal(card_mask.cpu(), cpu_mask))
        accepted = float(mask.float().mean())
        res = {"points": UDF_POINTS, "ms": ms, "accepted": accepted,
               "cpu_points": n_cpu, "cpu_max_diff_over_box": gap,
               "masks_equal": same_mask, "cpu_s": cpu_s}
        if name == "sphere":
            r = torch.linalg.norm(pts[mask], dim=-1).cpu()
            res["radius_err"] = float((r - 0.4).abs().max())
        log(f"variants: extract_surface_points {name}: {UDF_POINTS} points in {ms:.1f} ms, "
            f"{accepted:.1%} accepted" + (f", radius within {res['radius_err']:.3g}"
                                          if "radius_err" in res else "")
            + f"; card vs cpu at {n_cpu} points: masks "
            f"{'equal' if same_mask else 'DIFFER'}, points within {gap:.3g} of the box "
            f"(cpu {cpu_s:.1f} s)")
        if (not same_mask or gap > 1e-4 or not bool(torch.isfinite(pts).all())
                or accepted < 0.5 or res.get("radius_err", 0.0) > 0.02):
            raise AssertionError(f"variants: extract_surface_points {name}: {res}")
        udf[name] = res
    report_v["onet"], report_v["udf"] = onet, udf


def phase_variants(torch, report, state, ref_np):
    """The rest of the model zoo on the card, each path counted with the
    launch counts set to 0 just before it. ref_np: make_scenes' reference
    clouds (8 x 8 x N_FULL); encodes take all 64 through encode_fps
    (N_FULL -> N_PCL points), and the first few of them go through the CPU
    as well (encode_variant, hold_codes).
    (a) The attention encoder's options with the r5 weights (fc_O from the
        seeded init): center_pred=False, center_pred_scale=False and
        z_so3_as_Omtx, each with pallas_attention=True (rows 1, 2, 4-7 as in
        one encode of the fused pipeline, every plain version forbidden;
        card vs CPU within VARIANT_TOL), and mixed_precision with
        pallas_attention=False (rows 1 and 2, the plain scale statistic once;
        within MIXED_TOL, its graph differences backed within
        MIXED_INPUT_TOL).
    (b) The five ablation encoders through ShapePrior(ShapePriorConfig(
        encoder_type=..., c_dim=256)) at JAX's default widths from the
        seeded init, under both values of pallas_attention: row 2 launched
        ABLATION_KNN times an encode, row 1 once (the front end's FPS), row
        8 once with pallas_attention=True and the plain scale statistic once
        without, row 4 never, no other plain version; card against CPU
        codes on ABLATION_CPU_CLOUDS clouds (the CPU run once an encoder: it
        does not depend on the flag), the seeded weights' equal-graph clouds
        held by the float64 CPU run (hold_codes ref64); the two VN encoders'
        fused encode also profiled once (its kernel split).
    (c) Training with center_pred: false and decoder_type: inner, and the
        deepsdf decoder type's step (variant_training).
    (d) The ONet decoders and extract_surface_points (variant_decoders)."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig

    t_phase = time.perf_counter()
    ref = torch.as_tensor(ref_np, device="cuda").reshape(B, N_FULL, 3)
    per_encode = {"fps": 1 + len(FPS_ENCODER), "knn": len(KNN_LAYERS) - 1,
                  "knn_topk": 1, "layer0": 1, "edge_mean": 1, "edge_mean_products": 2,
                  "edge_attention": len(KNN_LAYERS) - 2,
                  "edge_attention_products": 2 * (len(KNN_LAYERS) - 2)}
    out = {"options": {}, "ablation": {}}
    for name, opt in (("center_pred_false", dict(center_pred=False)),
                      ("center_pred_scale_false", dict(center_pred_scale=False)),
                      ("z_so3_as_Omtx", dict(z_so3_as_Omtx=True))):
        out["options"][name], _ = encode_variant(
            torch, f"variants {name}", ShapePriorConfig(pallas_attention=True, **opt),
            state, ref, per_encode)
    mixed = ShapePriorConfig(mixed_precision=True)
    out["options"]["mixed_precision"], _ = encode_variant(
        torch, "variants mixed_precision", mixed, state, ref,
        {"fps": 1 + len(FPS_ENCODER), "knn": len(KNN_LAYERS), "plain_scale": 1},
        tol=MIXED_TOL, forbid=False, input_tol=MIXED_INPUT_TOL)
    spread = out["options"]["mixed_precision"]["cpu_spread"] = cpu_spread(
        torch, mixed, state, ref)
    log(f"variants mixed_precision: the CPU's own spread, clouds moved by 1e-7 of "
        f"themselves: max|R - I| {spread['max_abs_dR']:.3g}, z_inv "
        f"{spread['max_z_inv_rel']:.3g}")
    torch.cuda.empty_cache()

    for etype, n_knn in ABLATION_KNN.items():
        seeded = ShapePrior(ShapePriorConfig(encoder_type=etype, c_dim=256),
                            device="cpu").state_dict()
        runs, cpu_run = {}, None
        for fused in (True, False):
            want = {"fps": 1, "knn": n_knn, "scale" if fused else "plain_scale": 1}
            want = {k: v for k, v in want.items() if v}
            runs[fused], cpu_run = encode_variant(
                torch, f"variants {etype} pallas_attention={fused}",
                ShapePriorConfig(encoder_type=etype, c_dim=256, pallas_attention=fused),
                seeded, ref, want, equivariant=etype.startswith("vecdgcnn"),
                cpu_run=cpu_run, f64=True, n_cpu=ABLATION_CPU_CLOUDS,
                profile=fused and etype.startswith("vecdgcnn"))
            torch.cuda.empty_cache()
        out["ablation"][etype] = {f"pallas_attention={k}": v for k, v in runs.items()}

    variant_training(torch, out)
    torch.cuda.empty_cache()
    variant_decoders(torch, out, state, ref)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"variants: phase {out['phase_s']:.1f} s")
    report["variants"] = out


# --- data parallelism over torch.distributed (phase_sharded) ---------------

SHARDED_RANKS = 2  # gloo ranks on the one card
SHARDED_OPTIM_STEPS = 20  # refinement steps of the optim=True check
SHARDED_RECON = dict(recon_resolution0=16, recon_upsampling_steps=1)  # 33^3 grids
SHARDED_OPTIM_TOL = 2e-3  # phase_optim's card-against-CPU bound after ICP
SHARDED_TIMED = 3  # timed calls of each pipeline measurement
SHARDED_DEADLINE_S = 400  # the ranks are killed past this


def sharded_fail(msg):
    raise AssertionError(f"sharded: {msg}")


def on_card(torch, tag, tensors):
    """Fail unless every tensor lies on a CUDA device."""
    bad = [k for k, v in tensors.items() if torch.is_tensor(v) and v.device.type != "cuda"]
    if bad:
        sharded_fail(f"{tag}: tensors off the card: {bad}")


def median_ms(torch, fn, n=SHARDED_TIMED):
    """fn() once to warm up, then the median host ms of n calls, each ended
    by a sync; returns (last result, ms)."""
    out = fn()
    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(samples))


def host_arrays(out) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def sharded_train_step(torch, trainer, state, batches):
    """One step split open (loss_and_grads, apply_gradients) on batches[0],
    then train_step on batches[1] with its launches counted and the plain
    versions forbidden: (the first step's loss, gradients (numpy) and
    grad_norm, the second step's loss and grad_norm, its launches)."""
    placed = trainer.place_batch(batches[0])
    metrics, grads = trainer.loss_and_grads(
        placed, trainer.step_generator(state.step, len(batches[0]["inputs"])))
    norm = trainer.apply_gradients(state, grads)
    state.step += 1
    with forbid_plain():
        m2, launches = counted(lambda: trainer.train_step(state, batches[1]))
    torch.cuda.synchronize()
    return {"loss": float(metrics["batch_loss"]), "grad_norm": float(norm),
            "grads": [g.detach().double().cpu().numpy() for g in grads],
            "loss2": float(m2["batch_loss"]), "grad_norm2": float(m2["grad_norm"]),
            "launches": {k: v for k, v in launches.items() if v}}


def sharded_rank(rank, world, tmp, spec):
    """One rank of phase_sharded (started by torch.multiprocessing.spawn
    after the parent built the kernels): two ranks asking for nccl on the
    one card must be refused; then under gloo, on the card, the scene-pair
    pipeline at full width (launches counted, plain versions forbidden),
    at reduced depth with optim=True and with recon=True, a qp-sharded
    MeshExtractor grid, and two data-parallel training steps at batch 64.
    Writes its outputs and times under tmp for the parent to hold."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig, slice_codes)
    from livingscenes_tpu_torch.ops import _cuda
    from livingscenes_tpu_torch.parallel import (
        gather_batch, initialize_distributed, make_mesh, shard_batch)
    from livingscenes_tpu_torch.recon.extractor import MeshExtractor
    from livingscenes_tpu_torch.solver.pipeline import build_scene_pair_pipeline
    from livingscenes_tpu_torch.train import run as train_run
    from livingscenes_tpu_torch.train.trainer import Trainer

    _cuda.lib()
    result = {"rank": rank}
    try:
        initialize_distributed(backend="nccl", init_method=f"file://{tmp}/nccl_{world}",
                               world_size=world, rank=rank)
    except RuntimeError as e:
        result["nccl_refusal"] = str(e)
    else:
        sharded_fail(f"rank {rank}: {world} nccl ranks on one card were not refused")
    if dist.is_initialized():
        sharded_fail(f"rank {rank}: the refused nccl group is initialized")
    initialize_distributed(backend="gloo", init_method=f"file://{tmp}/gloo",
                           world_size=world, rank=rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    dp, qp = make_mesh(axis_names=("dp",)), make_mesh(axis_names=("qp",))
    log(f"sharded: rank {rank} of {world}: device {dev} "
        f"({torch.cuda.get_device_name(dev)}), backend {dist.get_backend()}, mesh {dp}")
    result["device"] = str(dev)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    state, cfgs = inputs["state"], spec["configs"]

    model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cuda")
    model.load_state_dict(state)
    on_card(torch, f"rank {rank} weights", dict(model.state_dict()))
    outs = {}
    # the full-width pipeline: gathered, local (this rank's scenes alone),
    # and the gather alone
    ref, res, mask = (torch.as_tensor(a, device="cuda") for a in inputs["scenes"])
    args = (ref, res, mask, mask)
    pipe = build_scene_pair_pipeline(model, cfgs["pipeline"], mesh=dp)
    pipe(*args)
    torch.cuda.synchronize()
    with forbid_plain():
        out, launches = counted(lambda: pipe(*args))
    torch.cuda.synchronize()
    on_card(torch, f"rank {rank} pipeline", out)
    result["launches"] = {k: v for k, v in launches.items() if v}
    _, result["gathered_ms"] = median_ms(torch, lambda: pipe(*args))
    local_pipe = build_scene_pair_pipeline(model, cfgs["pipeline"])
    local_args = [shard_batch(a, dp) for a in args]
    local, result["local_ms"] = median_ms(torch, lambda: local_pipe(*local_args))
    _, result["gather_ms"] = median_ms(torch, lambda: gather_batch(local, dp))
    outs["pipeline"] = host_arrays(out)
    # reduced depth: the refinement, and the recon grids of shape scenes
    t0 = time.perf_counter()
    optim = build_scene_pair_pipeline(model, cfgs["optim"], mesh=dp)(*args)
    torch.cuda.synchronize()
    result["optim_s"] = time.perf_counter() - t0
    on_card(torch, f"rank {rank} optim", optim)
    outs["optim"] = host_arrays(optim)
    sref, sres = (torch.as_tensor(a, device="cuda") for a in inputs["shapes"])
    smask = torch.ones(sref.shape[:3], dtype=torch.bool, device="cuda")
    recon_pipe = build_scene_pair_pipeline(model, cfgs["recon"], mesh=dp)
    recon, result["recon_ms"] = median_ms(torch, lambda: recon_pipe(sref, sres, smask, smask))
    on_card(torch, f"rank {rank} recon", recon)
    outs["recon"] = host_arrays(recon)
    # the qp-sharded extractor on the first shape's canonical code
    with torch.no_grad():
        one = slice_codes(model.encode_fps(sref[0], smask[0]), 0)
    canonical = dict(one, s=torch.ones_like(one["s"]), t=torch.zeros_like(one["t"]))
    ext = MeshExtractor(model.occupancy_logits, spec["extractor"], mesh=qp)
    (grid, overflow), result["extractor_ms"] = median_ms(
        torch, lambda: ext.compute_grid(canonical))
    on_card(torch, f"rank {rank} extractor", {"grid": grid})
    outs["extractor"] = {"grid": grid.cpu().numpy(), "overflow": overflow.cpu().numpy()}
    del model, pipe, local_pipe, recon_pipe, ext
    torch.cuda.empty_cache()
    # two data-parallel training steps from r5
    tmodel = train_run.build_model(spec["train_cfg"], device="cuda")
    tmodel.prior.load_state_dict(state)
    trainer = Trainer(tmodel, spec["trainer_cfg"], mesh=dp)
    tstate = trainer.init_state()
    t0 = time.perf_counter()
    train = sharded_train_step(torch, trainer, tstate, inputs["batches"])
    result["train_s"] = time.perf_counter() - t0
    on_card(torch, f"rank {rank} training", dict(tmodel.prior.state_dict()))
    outs["train"] = train
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"result": result, "outs": outs}, f)
    dist.barrier()
    dist.destroy_process_group()


def step_graphs(torch, trainer, batch, step, rows=None):
    """The kNN graphs and FPS picks of one training forward of a numpy
    batch (train mode, step `step`'s draws) through an unsharded trainer;
    with `rows`, of those rows alone with the whole batch's draws, as the
    rank that holds them makes it."""
    from livingscenes_tpu_torch.parallel import RowDraws

    generator = trainer.generator(step)
    if rows is not None:
        generator = RowDraws(generator, rows, len(batch["inputs"]))
        batch = {k: v[rows] for k, v in batch.items()}
    with torch.no_grad(), record_graphs() as graphs:
        trainer.model.loss(trainer.place_batch(batch), generator, train=True)
    return graphs.calls


def shard_equal_batch(torch, trainer, batch, spare, step, world):
    """`batch` (numpy) with each cloud whose kNN graphs or FPS picks differ
    between the whole batch's forward and its rank's rows' forward (the
    encoder's products round by batch size) replaced by the next cloud of
    `spare`: training_cpu_check's rule, since a near-tie swapped there turns
    a cloud's codes by up to 1e-2 and its gradient past any rounding
    tolerance. Returns (batch, [(cloud, first difference)])."""
    B = len(batch["inputs"])
    per = B // world
    batch = {k: np.array(v) for k, v in batch.items()}
    replaced, nxt = [], 0
    for _ in range(4):
        full = step_graphs(torch, trainer, batch, step)
        first = [None] * B
        for r in range(world):
            rows = slice(r * per, (r + 1) * per)
            part = step_graphs(torch, trainer, batch, step, rows)
            first[rows] = graph_differences([(k, layer, a[rows]) for k, layer, a in full],
                                            part, per)[0]
        bad = [i for i, f in enumerate(first) if f]
        if not bad:
            return batch, replaced
        for i in bad:
            replaced.append((i, first[i]))
            for k in batch:
                batch[k][i] = spare[k][nxt]
            nxt += 1
    sharded_fail(f"training: no batch whose graphs agree at both batch sizes; {replaced}")


def hold_grids(tag, a, b, thr):
    """Grid a against grid b ((n, n, n) numpy, merged): every entry within
    1e-4 of b's largest magnitude, or where they differ by more, a corner
    near the threshold whose side differs between them (selection_witness:
    the refine levels selected another point there)."""
    scale = float(np.abs(b).max())
    tol = 1e-4 * scale
    diff = np.abs(a - b)
    bad = np.flatnonzero(diff.reshape(-1) > tol)
    witnesses = []
    for p in bad[:64]:
        w = selection_witness(a, b, p, thr, tol)
        if w is None:
            sharded_fail(f"{tag}: grid entry {int(p)} differs by {float(diff.flat[p])} "
                         f"(bound {tol}) and no corner near the threshold explains it")
        witnesses.append(w)
    return {"max_abs_diff": float(diff.max()), "bound": tol,
            "entries_past_bound": int(len(bad)), "witnessed": len(witnesses)}


def hold_pipeline(torch, tag, got, want, r_tol, graphs_fn=None):
    """A gathered pipeline output against the unsharded one (numpy dicts):
    matches0 equal; R and t within r_tol, or, for the objects past it, a
    kNN or FPS near-tie between the two runs backed by its witness
    (graphs_fn(objects) -> {object: witness} runs them again, recording)."""
    if not np.array_equal(got["matches0"], want["matches0"]):
        sharded_fail(f"{tag}: matches0 {got['matches0'].tolist()} vs unsharded "
                     f"{want['matches0'].tolist()}")
    dR = np.abs(got["R"] - want["R"]).reshape(got["R"].shape[0], -1, 9).max(-1)
    dt = np.abs(got["t"] - want["t"]).reshape(got["t"].shape[0], -1, 3).max(-1)
    past = [tuple(int(i) for i in ix) for ix in np.argwhere((dR > r_tol) | (dt > 10 * r_tol))]
    row = {"max_abs_dR": float(dR.max()), "max_abs_dt": float(dt.max()), "tol": r_tol,
           "bit_equal": all(np.array_equal(got[k], want[k]) for k in want),
           "past_tol": past}
    if past:
        if graphs_fn is None:
            sharded_fail(f"{tag}: R or t past {r_tol} at {past}")
        witness = graphs_fn(past)
        row["tie_witness"] = {str(k): w for k, w in witness.items()}
        for o, w in witness.items():
            log_witness(f"sharded {tag}", f"scene, object {o}", w)
        bad = [o for o in past if o not in witness or not witness[o]["near_tie"]]
        if bad:
            sharded_fail(f"{tag}: R or t past {r_tol} at {bad} with no near-tie witness")
    log(f"sharded: {tag}: gathered vs unsharded: matches0 equal, max|dR| "
        f"{row['max_abs_dR']:.3g}, max|dt| {row['max_abs_dt']:.3g} (bound {r_tol}; "
        f"bit-equal: {row['bit_equal']}; past the bound: {past or 'none'})")
    return row


def shard_graph_witness(torch, model, cfg, args, world):
    """graphs_fn for hold_pipeline: the unsharded run and each rank's own
    scenes run alone (what that rank computed), both recording their kNN
    graphs and FPS picks with inputs, and for each object (scene, o) past
    the bound the tie witness of its first difference."""
    from livingscenes_tpu_torch.solver.pipeline import build_scene_pair_pipeline

    def fn(past):
        S = args[0].shape[0]
        per = S // world
        pipe = build_scene_pair_pipeline(model, cfg)
        with record_graphs(keep_inputs=True) as full:
            out = pipe(*args)
        found = {}
        for r in range(world):
            rows = [(s, o) for s, o in past if s // per == r]
            if not rows:
                continue
            lo, hi = r * per * N_OBJ, (r + 1) * per * N_OBJ
            with record_graphs(keep_inputs=True) as part:
                pipe(*(a[r * per:(r + 1) * per] for a in args))
            sliced = type("Sliced", (), {})()
            sliced.calls = [(k, layer, a[lo:hi]) for k, layer, a in full.calls]
            sliced.inputs = [tuple(t[lo:hi] for t in x) for x in full.inputs]
            m = out["matches0"][r * per:(r + 1) * per].cpu()
            flat = (torch.where(m >= 0, m, 0)
                    + torch.arange(per)[:, None] * N_OBJ).reshape(-1)
            _, witness = pair_graph_witnesses(torch, part, sliced, flat)
            for s, o in rows:
                j = (s - r * per) * N_OBJ + o
                if j in witness:
                    found[(s, o)] = witness[j]
        return found

    return fn


def phase_sharded(torch, report, state, scenes, pipe_out, want_launches):
    """Data parallelism over torch.distributed on the one card.

    SHARDED_RANKS processes (torch.multiprocessing spawn, after the kernels
    are built), each on the card: first each asks for a group of
    SHARDED_RANKS nccl ranks and must be refused (NCCL cannot put two ranks
    on one device); then under gloo (named explicitly, file:// rendezvous)
    they run, through ("dp",) and ("qp",) meshes:

    * the fused-encoder scene-pair pipeline at full width, r5 checkpoint,
      8 x 8 x 4096 (phase_pipeline's scenes): each rank's launches counted
      with every plain version forbidden (the unsharded call's counts:
      every kernel of rows 1-7 ran on each rank's share); its gathered
      output against phase_pipeline's unsharded one, matches0 equal, R
      within 1e-3 and t within 1e-2 (phase_pipeline's bound between card
      runs), or the object's kNN or FPS difference between the unsharded
      run and the rank's own scenes run alone a near-tie by its witness;
      the gathered call, the local call (the rank's scenes alone) and the
      gather alone timed;
    * at reduced depth: optim=True with SHARDED_OPTIM_STEPS steps (R within
      2e-3) and recon=True at 33^3 on 2 pairs of shape scenes (R within
      1e-3, every matched instance's merged grid as hold_grids holds it);
    * a qp-sharded MeshExtractor grid (32^3 and two refine levels) against
      the unsharded one (hold_grids);
    * two training steps from r5 at batch 64 (configs/production_r5.yaml,
      dropout and the centre jitter on: drawn for the global batch) against
      the unsharded steps on the same batches: the first step's loss,
      gradient norms per component and smallest cosine as phase_training
      holds card against CPU (CPU_CHECK_TOL), the second's loss and
      grad_norm to the same rtols, and its launches TRAIN_STEP_LAUNCHES
      (rows 12-14 ran). As in phase_training's CPU check, a cloud whose
      kNN graph or FPS picks differ between the whole batch's forward and
      its rank's rows' forward is named and replaced by the next cloud of
      the stream first (shard_equal_batch).

    Every rank's tensors must lie on the card and every rank must return
    the same gathered outputs. Then one rank under nccl, in this process:
    the pipeline through a mesh of size 1 equal bit for bit to the run
    without one, and an all_reduce through the nccl group."""
    import pickle
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from livingscenes_tpu_torch.models.shape_prior import (
        ShapePrior, ShapePriorConfig, slice_codes)
    from livingscenes_tpu_torch.parallel import initialize_distributed, make_mesh
    from livingscenes_tpu_torch.recon.extractor import MeshExtractor, MeshExtractorConfig
    from livingscenes_tpu_torch.recon.grid import apply_final_merge
    from livingscenes_tpu_torch.solver.pipeline import (
        PipelineConfig, build_scene_pair_pipeline)
    from livingscenes_tpu_torch.solver.registration import RegistrationConfig
    from livingscenes_tpu_torch.train import run as train_run
    from livingscenes_tpu_torch.train.config import apply_overrides, load_config
    from livingscenes_tpu_torch.train.data import batch_iterator
    from livingscenes_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    world = SHARDED_RANKS
    tmp = tempfile.mkdtemp(prefix="lstpu_sharded_")
    rng = np.random.default_rng(3)
    shapes = make_shape_scenes(rng, world)
    train_cfg = apply_overrides(load_config(TRAIN_CONFIG), [
        "dataset.n_train_items=128", "dataset.n_val_items=2", "dataset.ram_cache=false",
        f"logging.log_dir={tmp}/run"])
    trainer_cfg = train_run.build_trainer_cfg(train_cfg)
    train_ds, _ = train_run.build_datasets(train_cfg)
    it = batch_iterator(train_ds, trainer_cfg.batch_size, seed=1)
    tmodel = train_run.build_model(train_cfg, device="cuda")
    tmodel.prior.load_state_dict(state)
    trainer = Trainer(tmodel, trainer_cfg)
    batches, replaced = [], []
    for step in range(2):
        batch, swaps = shard_equal_batch(torch, trainer, next(it), next(it), step, world)
        batches.append(batch)
        replaced.append(swaps)
    log("sharded: training batches: clouds replaced for a graph that differs between "
        "the whole batch and a rank's rows: "
        + "; ".join(f"step {i}: " + (", ".join(f"cloud {c} at {f}" for c, f in sw) or "none")
                    for i, sw in enumerate(replaced)))
    del trainer, tmodel
    torch.cuda.empty_cache()
    configs = {
        "pipeline": PipelineConfig(encode_fps=True),
        "optim": PipelineConfig(encode_fps=True, optim=True, registration=RegistrationConfig(
            n_steps=SHARDED_OPTIM_STEPS)),
        "recon": PipelineConfig(encode_fps=True, recon=True, **SHARDED_RECON),
    }
    ext_cfg = MeshExtractorConfig()
    spec = {"configs": configs, "extractor": ext_cfg, "train_cfg": train_cfg,
            "trainer_cfg": trainer_cfg}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"state": state, "scenes": scenes, "shapes": shapes,
                     "batches": batches}, f)
    torch.cuda.empty_cache()
    result = {"ranks": world, "backend": "gloo"}
    try:
        t0 = time.perf_counter()
        ctx = mp.spawn(sharded_rank, args=(world, tmp, spec), nprocs=world, join=False)
        try:
            while not ctx.join(timeout=5):  # raises if a rank failed
                if time.perf_counter() - t0 > SHARDED_DEADLINE_S:
                    sharded_fail(f"the ranks ran past {SHARDED_DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        result["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        log(f"sharded: {world} gloo ranks ran in {result['ranks_s']:.1f} s "
            "(process start, kernel load and CUDA init included)")
        for rk in ranks:
            res = rk["result"]
            if not res["device"].startswith("cuda"):
                sharded_fail(f"rank {res['rank']} ran on {res['device']}")
            if "NVIDIA" not in res["nccl_refusal"] or "gloo" not in res["nccl_refusal"]:
                sharded_fail(f"rank {res['rank']}: refusal {res['nccl_refusal']!r}")
            if res["launches"] != want_launches:
                sharded_fail(f"rank {res['rank']}: pipeline launches {res['launches']}, "
                             f"the unsharded call's {want_launches}")
            if rk["outs"]["train"]["launches"] != TRAIN_STEP_LAUNCHES:
                sharded_fail(f"rank {res['rank']}: training step launches "
                             f"{rk['outs']['train']['launches']}, expected "
                             f"{TRAIN_STEP_LAUNCHES}")
        for key in ("pipeline", "optim", "recon", "extractor"):
            for rk in ranks[1:]:
                for k, v in ranks[0]["outs"][key].items():
                    if not np.array_equal(v, rk["outs"][key][k]):
                        sharded_fail(f"ranks 0 and {rk['result']['rank']} returned "
                                     f"different {key} {k}")
        r0 = ranks[0]["result"]
        result["nccl_refusal"] = r0["nccl_refusal"]
        result["per_rank"] = [rk["result"] for rk in ranks]
        log("sharded: two nccl ranks on one card refused: " + r0["nccl_refusal"])
        log("sharded: pipeline 8x8x4096 (ms, median of 3): "
            + "; ".join(f"rank {rk['result']['rank']}: gathered "
                        f"{rk['result']['gathered_ms']:.2f}, local (its "
                        f"{N_SCENES // world} scenes alone) {rk['result']['local_ms']:.2f}, "
                        f"gather {rk['result']['gather_ms']:.3f}" for rk in ranks)
            + f"; unsharded {report['pipeline']['ms_per_call']:.2f}")

        model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cuda")
        model.load_state_dict(state)
        ref, res, mask = (torch.as_tensor(a, device="cuda") for a in scenes)
        args = (ref, res, mask, mask)
        want = {k: v.cpu().numpy() for k, v in pipe_out.items()}
        result["pipeline"] = hold_pipeline(
            torch, "pipeline", ranks[0]["outs"]["pipeline"], want, 1e-3,
            shard_graph_witness(torch, model, configs["pipeline"], args, world))
        optim_want = host_arrays(build_scene_pair_pipeline(model, configs["optim"])(*args))
        result["optim"] = hold_pipeline(
            torch, f"optim=True ({SHARDED_OPTIM_STEPS} steps)", ranks[0]["outs"]["optim"],
            optim_want, SHARDED_OPTIM_TOL,
            shard_graph_witness(torch, model, configs["optim"], args, world))
        sref, sres = (torch.as_tensor(a, device="cuda") for a in shapes)
        smask = torch.ones(sref.shape[:3], dtype=torch.bool, device="cuda")
        rcfg = configs["recon"]
        recon_want = host_arrays(build_scene_pair_pipeline(model, rcfg)(
            sref, sres, smask, smask))
        got = ranks[0]["outs"]["recon"]
        result["recon"] = hold_pipeline(torch, "recon=True", got, recon_want, 1e-3)
        thr = float(np.log(rcfg.recon_threshold) - np.log(1.0 - rcfg.recon_threshold))
        if not np.array_equal(got["grid_overflow"], recon_want["grid_overflow"]):
            sharded_fail("recon: grid_overflow differs from the unsharded run")
        held = []
        for s, o in np.argwhere(recon_want["matches0"] >= 0):
            merged = [apply_final_merge(d["grids_premerge"][s, o], d["grid_fidx"][s, o],
                                        d["grid_fvals"][s, o]) for d in (got, recon_want)]
            held.append(hold_grids(f"recon scene {s} instance {o}", *merged, thr))
        result["recon"]["grids"] = {
            "instances": len(held), "max_abs_diff": max(h["max_abs_diff"] for h in held),
            "entries_past_bound": sum(h["entries_past_bound"] for h in held)}
        log(f"sharded: recon grids ({len(held)} instances, 33^3): max|d| "
            f"{result['recon']['grids']['max_abs_diff']:.3g}, entries past 1e-4 of "
            f"the scale {result['recon']['grids']['entries_past_bound']} (witnessed)")
        with torch.no_grad():
            one = slice_codes(model.encode_fps(sref[0], smask[0]), 0)
        canonical = dict(one, s=torch.ones_like(one["s"]), t=torch.zeros_like(one["t"]))
        (grid, overflow), ext_ms = median_ms(
            torch, lambda: MeshExtractor(model.occupancy_logits, ext_cfg).compute_grid(
                canonical))
        ext_got = ranks[0]["outs"]["extractor"]
        if not np.array_equal(ext_got["overflow"], overflow.cpu().numpy()):
            sharded_fail("extractor: overflow differs from the unsharded grid")
        result["extractor"] = hold_grids("qp extractor", ext_got["grid"],
                                         grid.cpu().numpy(), ext_cfg.logit_threshold)
        result["extractor"].update(ms=r0["extractor_ms"], unsharded_ms=ext_ms)
        log(f"sharded: qp MeshExtractor grid {grid.shape[0]}^3: max|d| "
            f"{result['extractor']['max_abs_diff']:.3g} (entries past 1e-4 of the "
            f"scale: {result['extractor']['entries_past_bound']}, witnessed); "
            f"{r0['extractor_ms']:.2f} ms sharded, {ext_ms:.2f} ms unsharded")
        del model
        torch.cuda.empty_cache()

        tmodel = train_run.build_model(train_cfg, device="cuda")
        tmodel.prior.load_state_dict(state)
        trainer = Trainer(tmodel, trainer_cfg)
        train_want = sharded_train_step(torch, trainer, trainer.init_state(), batches)
        train_got = ranks[0]["outs"]["train"]
        # the gradients come in the order of trainer.params
        name_of = {id(p): k for k, p in tmodel.prior.named_parameters()}
        names = [name_of[id(p)] for p in trainer.params]
        by_name = dict(zip(names, range(len(names))))
        comps = {}
        worst_cos, worst_name = 1.0, None
        for comp in sorted({k.split(".")[0] for k in names}):
            keys = [k for k in names if k.startswith(comp + ".")]
            n_a = float(np.sqrt(sum(np.sum(train_got["grads"][by_name[k]] ** 2) for k in keys)))
            n_b = float(np.sqrt(sum(np.sum(train_want["grads"][by_name[k]] ** 2)
                                    for k in keys)))
            comps[comp] = {"sharded": n_a, "unsharded": n_b, "rel": abs(n_a - n_b) / n_b}
            for k in keys:
                a = train_got["grads"][by_name[k]].ravel()
                b = train_want["grads"][by_name[k]].ravel()
                if np.linalg.norm(b) < 1e-6 * n_b:
                    continue
                cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
                if cos < worst_cos:
                    worst_cos, worst_name = cos, k
        rel = lambda k: abs(train_got[k] - train_want[k]) / abs(train_want[k])
        row = {"loss_rel": rel("loss"), "grad_norms": comps, "min_cosine": worst_cos,
               "min_cosine_param": worst_name, "loss2_rel": rel("loss2"),
               "replaced": [[[c, f] for c, f in sw] for sw in replaced],
               "grad_norm2_rel": rel("grad_norm2"), "launches": train_got["launches"],
               "sharded_s": r0["train_s"]}
        log(f"sharded: training, 2 steps at batch {trainer_cfg.batch_size} from r5, "
            f"{world} ranks vs unsharded: step 1 loss {train_got['loss']:.7g} vs "
            f"{train_want['loss']:.7g} (rel {row['loss_rel']:.3g}), gradient norms "
            + ", ".join(f"{c} rel {v['rel']:.3g}" for c, v in comps.items())
            + f", smallest cosine {worst_cos:.6f} ({worst_name}); step 2 loss rel "
            f"{row['loss2_rel']:.3g}, grad_norm rel {row['grad_norm2_rel']:.3g}; "
            f"launches a step {train_got['launches']}")
        loss_rtol, norm_rtol, min_cos = CPU_CHECK_TOL
        if (row["loss_rel"] > loss_rtol or row["loss2_rel"] > loss_rtol
                or row["grad_norm2_rel"] > norm_rtol or worst_cos < min_cos
                or any(v["rel"] > norm_rtol for v in comps.values())):
            sharded_fail(f"training: sharded and unsharded steps differ beyond "
                         f"{CPU_CHECK_TOL}")
        result["training"] = row
        del trainer, tmodel
        torch.cuda.empty_cache()

        # one rank under nccl: a mesh of size 1 runs unsharded
        initialize_distributed(backend="nccl", init_method=f"file://{tmp}/nccl_1",
                               world_size=1, rank=0)
        try:
            mesh = make_mesh(axis_names=("dp",))
            model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cuda")
            model.load_state_dict(state)
            a = build_scene_pair_pipeline(model, configs["pipeline"], mesh=mesh)(*args)
            b = build_scene_pair_pipeline(model, configs["pipeline"])(*args)
            if not all(torch.equal(a[k], b[k]) for k in b):
                sharded_fail("nccl: the size-1 mesh's pipeline differs from the unsharded")
            x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
            probe = x.clone()
            group = mesh.get_group("dp")
            _, nccl_ms = median_ms(torch, lambda: dist.all_reduce(probe, group=group))
            if not torch.equal(probe, x):
                sharded_fail("nccl: a one-rank all_reduce changed its input")
            result["nccl_1_rank"] = {"bit_equal": True, "all_reduce_4MB_ms": nccl_ms,
                                     "backend": dist.get_backend()}
            log(f"sharded: one nccl rank: the pipeline through a size-1 mesh equals "
                f"the unsharded run bit for bit; all_reduce of 4 MB {nccl_ms:.3f} ms")
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded: phase took {result['phase_s']:.1f} s")
    report["sharded"] = result


def kernel_summary(torch, prof, wall_ms: float, named=()) -> dict:
    """What a finished torch.profiler run saw on the card during `wall_ms`
    of host time: the device ms its kernels took, the busy share, the count
    of kernel launches, the kernels that took the most device time, and
    (ms, launches) of the kernels whose names contain one of `named`,
    however small. Kernel events only: the CPU op that launched a kernel
    also reports its time, which would count it twice."""
    by_name = {}
    for e in prof.events():
        # a record_function range also shows as a span on the device
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name in RECON_RANGES):
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k[:60], ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda row: -row[1])
    dev = sum(row[1] for row in rows)
    picked = {part: [sum(v[i] for k, v in by_name.items() if part in k)
                     for i in (0, 1)] for part in named}
    return {"wall_ms": wall_ms, "device_ms": dev,
            "busy": dev / wall_ms if wall_ms else 0.0,
            "kernels": sum(row[2] for row in rows), "top": rows[:12],
            "named": picked}


def icp_active_pairs(torch, run):
    """run() with the pairs still active at each ICP-stats launch counted:
    [pairs, ...] in launch order (counted on the card, read after run)."""
    from livingscenes_tpu_torch.ops import cuda_icp

    real, kept = cuda_icp.icp_stats_cuda, []

    def keep(x, src, tgt, active=None):
        kept.append(x.shape[0] if active is None else active.sum())
        return real(x, src, tgt, active)

    cuda_icp.icp_stats_cuda = keep
    try:
        run()
    finally:
        cuda_icp.icp_stats_cuda = real
    return [int(a) for a in kept]


def stage_times(torch, model, ref, res, mask, profile=False, recon=None):
    """Host-clock ms of each stage of one call, each ended by a sync. With
    `profile`, each stage runs under torch.profiler instead and the result
    is its wall ms, the device ms its kernels took, the busy share, and the
    kernels that took the most device time; for the register stage also
    the ICP-stats kernel's ms and launches, and from one more run of the
    stage, outside the profiler, the pairs active at each of its launches.
    With `recon` (a PipelineConfig with recon=True) a last stage, "grid",
    transports the codes and evaluates the grids; profiled, it also gets
    the device ms and kernel launches of each of grid.py's ranges
    (range_summary)."""
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
        out[name] = kernel_summary(torch, prof, wall, ("icp_stats_kernel",))
        if name == "grid":
            out[name]["ranges"] = range_summary(torch, prof)
        return r

    with torch.inference_mode():
        fm = mask.reshape(S * O, N)
        # as the pipeline runs it: both sides in one launch
        both = timed("fps_front", lambda: fps_auto(
            torch.cat([ref.reshape(S * O, N, 3), res.reshape(S * O, N, 3)]),
            N_PCL, torch.cat([fm, fm]))[0])
        a = both[:S * O], both[S * O:]
        codes = timed("encode", lambda: (model.encode(a[0]), model.encode(a[1])))
        m = timed("match", lambda: sequential_matcher(
            codes[0]["z_inv"].reshape(S, O, -1),
            codes[1]["z_inv"].reshape(S, O, -1))["matches0"])
        part = (m.clamp_min(0) + torch.arange(S, device=m.device)[:, None] * O
                ).reshape(-1)
        c2 = {k: v[part] for k, v in codes[1].items()}
        def register():
            return solve_pairwise_registration(
                model, a[0], a[1][part], codes[0], c2, cfg=RegistrationConfig())

        R, t = timed("register", register)
        if profile and recon is None:
            out["register"]["active_pairs"] = icp_active_pairs(torch, register)
        if recon is not None:
            from livingscenes_tpu_torch.solver.pipeline import _reconstruct

            timed("grid", lambda: _reconstruct(model, recon, recon.recon_final_merge,
                                               c2, R, t, S, O))
    return out


def range_summary(torch, prof) -> dict:
    """name -> {"device_ms", "launches"} of the kernels inside each of
    recon/grid.py's profiler ranges (RECON_RANGES): each range leaves a
    span on the device's timeline around its kernels, and a kernel counts
    for the span its start lies in."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == cuda and e.name in RECON_RANGES)
    if not spans:
        raise AssertionError("the profiler kept no device span of grid.py's ranges")
    starts = [sp[0] for sp in spans]
    out = {name: {"device_ms": 0.0, "launches": 0} for name in RECON_RANGES}
    for e in prof.events():
        if e.device_type != cuda or e.name in RECON_RANGES:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            row = out[spans[i][2]]
            row["device_ms"] += e.time_range.elapsed_us() / 1e3
            row["launches"] += 1
    return out


def summary_line(report) -> str:
    """The run's headline figures on one short line of text, printed after
    the `kernels` line so that a tail of the output keeps them."""
    tr = report["training"]
    split = ", ".join(f"{k} {v:.2f}" for k, v in tr["split_ms"].items())
    rows = "; ".join(
        f"{name} {report[name]['launches']} launches {report[name]['ms']:.2f} ms "
        f"(plain {report[name]['plain_ms']:.2f}, bound {report[name]['bound_ms']:.3f})"
        for name in BWD.values())
    attn = "/".join(f"{row['ms']:.3f}" for row in report["edge_attention"]["shapes"])
    mean = report["edge_mean"]["shapes"][0]
    knn = "/".join(f"{row['ms']:.3f}" for row in report["knn"]["shapes"][1:])
    fps = "/".join(f"{row['ms']:.3f}" for row in report["fps"]["shapes"])
    attn_bwd = "/".join(f"{row['ms']:.3f}"
                        for row in report["edge_attention_bwd"]["shapes"])
    sink = report["sinkhorn_per_launch"]
    heads = (f"row 5 {report['layer0']['ms']:.4f} ms in 2, row 14 layers 2-6 "
             f"{attn_bwd} ms a step, "
             f"row 2 {report['knn']['fused_path']['ms']:.3f} ms in 12 launches "
             f"(layers 1-6 {knn}), row 1 {report['fps']['ms']:.3f} ms in 7 "
             f"({fps}), "
             f"row 7 {report['edge_attention']['ms']:.3f} ms in 10 launches "
             f"(layers 2-6 {attn}), row 6 {report['edge_mean']['ms']:.4f} ms "
             f"in 2 (products {mean['products_ms']:.4f} a launch), row 4 "
             f"{report['knn_topk']['ms']:.4f} ms in 2, row 3 "
             f"{report['icp_stats']['per_launch']['ms']:.5f} ms a launch, row 9 "
             f"{sink['sinkhorn']['ms']:.4f} ms a launch, row 10 "
             f"{sink['sinkhorn_bwd_both']['ms']:.4f}/{sink['sinkhorn_bwd_f_only']['ms']:.4f}, "
             f"row 11 {sink['sinkhorn_iterates']['ms']:.4f}; "
             f"fused call peak {report['pipeline']['peak_mem_gb']:.3f} GB; ")
    rc = report["recon"]
    hm = rc["host_meshing"]
    ranges = ", ".join(f"{k.split('.')[1]} {v['device_ms']:.1f}"
                       for k, v in rc["stages_device"]["grid"]["ranges"].items())
    opt = report["pipeline_optim"]["stages_ms"]
    recon = (f"recon {rc['scenes']}x{rc['objects']}: {rc['ms_per_call']:.1f} ms a call "
             f"(grid device {rc['stages_device']['grid']['device_ms']:.1f} ms: {ranges}; "
             f"decoder {rc['decoder_flops']['per_call'] / 1e12:.1f} TFLOP, "
             f"{rc['share_of_67_grid_device']:.1%} of 67 TFLOP/s), peak "
             f"{rc['peak_mem_gb']:.2f} GB, host meshing {hm['host_ms']:.0f} ms "
             f"({hm['n_nonempty']}/{hm['n_matched']} meshes, {hm['faces_raw_mean']:.0f} "
             f"raw faces a grid), scene-pairs/s {rc['scene_pairs_per_s']['device_only']:.3f} "
             f"/ {rc['scene_pairs_per_s']['with_host_meshing']:.3f} with meshing, bf16 "
             f"{rc['bf16']['ms_per_call']:.1f} ms ({rc['bf16']['max_chamfer_voxels']:.3f} "
             f"voxel); refine_bf16 {opt['refine_bf16_ms_per_step']:.2f} ms a step "
             f"(f32 {opt['refine_ms_per_step']:.2f}); ")
    mo = report["more"]
    more = (f"MoreSolver: solve_end2end {mo['end2end']['median_ms']:.1f} ms a scene pair "
            f"({mo['end2end']['scene_pairs_per_s']:.3f} scene-pairs/s; the pipeline "
            f"{mo['pipeline']['scene_pairs_per_s']:.3f}), optim {mo['optim']['ms']:.0f} ms, "
            f"{mo['meshes']['ms_per_mesh']:.0f} ms a mesh, optimize_code "
            f"{mo['code_optim']['ms']:.0f} ms, joint {mo['joint']['ms']:.0f} ms; ")
    ev = report["eval"]
    res = ev["results"]
    evals = (f"eval {EVAL_SCENES} scenes: matching {res['matching']['object_recall']:.2f}, "
             f"RRE5/10 {res['relocalization']['recall_rre5']:.2f}/"
             f"{res['relocalization']['recall_rre10']:.2f} (optim, {EVAL_OPTIM_SCENES} "
             f"scenes, {res['relocalization_optim']['recall_rre5']:.2f}/"
             f"{res['relocalization_optim']['recall_rre10']:.2f}), viou_sampled "
             f"{res['reconstruction']['viou_sampled_mean']:.2f}, sdf_recall "
             f"{res['reconstruction']['sdf_recall']:.2f}, phase {ev['phase_s']:.0f} s; ")
    sn = report["shapenet"]
    sn_split = ", ".join(f"{k} {v:.2f}" for k, v in sn["split_ms"].items())
    rf = sn["refinement"]
    shapenet = (f"shapenet: tree {sn['tree_s']:.1f} s, step {sn['step_ms']:.2f} ms "
                f"({sn_split}), peak {sn['peak_mem_gb']:.2f} GB; refinement "
                f"{rf['ms_per_step']:.2f} ms a step at {rf['faces']:.0f} faces, card vs cpu "
                f"{rf['meshes'][0]['cpu_max_diff_over_box']:.3g} of the box, phase "
                f"{sn['phase_s']:.0f} s; ")
    va = report["variants"]
    abl = ", ".join(f"{k} {v['pallas_attention=True']['ms']:.2f}/"
                    f"{v['pallas_attention=False']['ms']:.2f}"
                    for k, v in va["ablation"].items())
    opts = ", ".join(f"{k} {v['ms']:.2f}" for k, v in va["options"].items())
    vt = va["training"]
    variants = (f"variants: encode_fps ms {opts}; ablation (fused/default) {abl}; "
                f"center_pred false + inner step {vt['step_ms']:.2f} ms; udf "
                f"{va['udf']['r5_decoder']['ms']:.0f} ms; phase {va['phase_s']:.0f} s; ")
    sh = report["sharded"]
    r0 = sh["per_rank"][0]
    sharded = (f"sharded ({sh['ranks']} gloo ranks on the card): pipeline gathered "
               f"{r0['gathered_ms']:.2f} ms, local {r0['local_ms']:.2f}, gather "
               f"{r0['gather_ms']:.3f}; max|dR| {sh['pipeline']['max_abs_dR']:.3g}, optim "
               f"{sh['optim']['max_abs_dR']:.3g}; training loss rel "
               f"{sh['training']['loss_rel']:.3g}, min cos "
               f"{sh['training']['min_cosine']:.6f}; phase {sh['phase_s']:.0f} s; ")
    return (f"summary: {heads}{recon}{more}{evals}{shapenet}{variants}{sharded}"
            f"scene-pairs/s fused {report['pipeline']['scene_pairs_per_s']:.4f}, "
            f"default {report['pipeline_default_config']['scene_pairs_per_s']:.4f}, "
            f"optim {report['pipeline_optim']['scene_pairs_per_s']:.4f}; training step "
            f"{tr['step_ms']:.2f} ms ({split}), peak {tr['peak_mem_gb']:.2f} GB; "
            f"in the {TRAIN_STEPS} counted steps: {rows}")


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
             if "registers" in ln or ln.startswith("==")
             or ("spill" in ln and " 0 bytes spill stores" not in ln)]
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
    phase_knn_topk(torch, report, pc - pc.mean(dim=1, keepdim=True), state)
    calls = record_layer_calls(torch, model, pc)
    phase_fused_layers(torch, report, calls)
    phase_fused_layers_bwd(torch, report, calls)
    del model, calls
    torch.cuda.empty_cache()
    phase_small_shapes(torch, report)
    launches, pipe_out = phase_pipeline(torch, report, state, scenes, args.profile)
    phase_recon(torch, report, state, launches)
    phase_scale(torch, report, state, pc[:, :N_RAGGED].contiguous())
    phase_optim(torch, report, state, args.profile)
    phase_more(torch, report, state, scenes, args.profile)
    phase_demo(torch, report)
    phase_eval(torch, report)
    phase_training(torch, report, args.profile)
    phase_shapenet(torch, report)
    phase_variants(torch, report, state, ref_np)
    phase_sharded(torch, report, state, scenes, pipe_out, launches)

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
        "layer0_bwd": ("livingscenes_tpu_torch/csrc/layer0_bwd.cu",
                       "livingscenes_tpu/nn/pallas_layer0.py:112"),
        "edge_mean_bwd": ("livingscenes_tpu_torch/csrc/mean_edge_bwd.cu",
                          "livingscenes_tpu/nn/pallas_attention.py:272"),
        "edge_attention_bwd": ("livingscenes_tpu_torch/csrc/attention_bwd.cu",
                               "livingscenes_tpu/nn/pallas_attention.py:598"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        # times of the launches that `launches` counts: the fused path's
        r = {**r, **r.get("fused_path", {})}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            # rows 1-7: the fused-encoder pipeline's count; the later rows
            # carry the count of the path that runs them (rows 12-14: the
            # training run's TRAIN_STEPS steps, with the times of those
            # launches and of the plain VJP on their inputs)
            "replaces": replaces, "launches": r.get("launches", launches.get(name)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # rows 6 and 7 are three launches a layer: the edge pass, which
    # `launches` counts, after the two of its per-point products, counted
    # apart; rows 13 and 14 six: the edge pass and five of products and
    # reductions; row 12 two: the edge pass and the fold of its partials
    idle = [k["name"] for k in kernels if not k["launches"]]
    row = next(k for k in kernels if k["name"] == "layer0_bwd")
    row["fold_launches"] = report["training"]["launches"].get(
        "layer0_bwd_fold", 0)
    if not row["fold_launches"]:
        idle.append("layer0_bwd_fold")
    for name in ("edge_mean_bwd", "edge_attention_bwd"):
        row = next(k for k in kernels if k["name"] == name)
        row["products_launches"] = report["training"]["launches"].get(
            f"{name}_products", 0)
        if not row["products_launches"]:
            idle.append(f"{name}_products")
    for name in ("edge_mean", "edge_attention"):
        row = next(k for k in kernels if k["name"] == name)
        row["products_launches"] = launches[f"{name}_products"]
        if not row["products_launches"]:
            idle.append(f"{name}_products")
    if idle:
        raise AssertionError(f"kernels that their path never launched: {idle}")
    report["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(summary_line(report))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
