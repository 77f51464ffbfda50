"""The JAX package's scores on the capstone benchmark, computed on the CPU
in float32.

    JAX_PLATFORMS=cpu python scripts/capstone_jax_cpu_reference.py \
        --ckpt weights/production_r5_selected.ckpt --n-scenes 24 \
        --out docs/demo_trained_eval_r5_96inst_jax_cpu.json

docs/demo_trained_eval_r5_96inst.json and _48inst.json were made on a TPU,
where JAX's default matmul precision runs float32 matmuls as single bf16
passes (docs/ROUND5_NOTES.md section 1), and the fused ICP statistics
kernel too (livingscenes_tpu/ops/pallas_icp.py:37). This script runs the
same benchmark (scripts/demo_trained_eval.py build_benchmark: seed 7,
rotations 100 + scene, 1024 points) and solver settings through the JAX
package on the CPU, where matmuls are float32: matching, relocalization
without the refinement (with each instance's rotation error) and
reconstruction. The refinement (400 steps a scene) is left out: on the CPU
it takes hours. It runs the JAX reference only, on the CPU; the PyTorch
port's own capstone is scripts/torch_demo_trained_eval.py.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--n-scenes", type=int, default=24)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()

    from demo_trained_eval import build_benchmark
    from livingscenes_tpu import se3
    from livingscenes_tpu.eval.flyingshape import (
        FlyingShapeDataset,
        eval_matching,
        eval_reconstruction,
        eval_relocalization,
    )
    from livingscenes_tpu.eval.run_flyingshape import load_solver
    from livingscenes_tpu.recon.extractor import MeshExtractorConfig
    from livingscenes_tpu.solver import MoreSolver, MoreSolverConfig

    root = tempfile.mkdtemp(prefix="lstpu_capstone_cpu_")
    gt_meshes = build_benchmark(root, n_scenes=args.n_scenes, n_pts=1024)
    base = load_solver(args.ckpt)
    solver = MoreSolver(base.model, base.params, MoreSolverConfig(
        n_input_point=1024,
        mesh_extractor=MeshExtractorConfig(resolution0=32, upsampling_steps=1,
                                           simplify_nfaces=5000)))
    dataset = FlyingShapeDataset(root)
    out = {"platform": f"JAX {jax.__version__} on {jax.devices()[0].platform} "
                       f"({platform.processor() or platform.machine()})",
           "n_scenes": args.n_scenes, "seconds": {}}
    t0 = time.perf_counter()
    out["matching"] = eval_matching(dataset, solver)
    out["seconds"]["matching"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["relocalization"] = eval_relocalization(dataset, solver, optim=False)
    out["seconds"]["relocalization"] = time.perf_counter() - t0
    rre = []
    for i in range(len(dataset)):
        ref, rescan = dataset[i][:2]
        gt = se3.concatenate(jnp.asarray(rescan["transform"]),
                             se3.inverse(jnp.asarray(ref["transform"])))
        R, _ = solver.solve_pairwise_registration(jnp.asarray(ref["pc"]),
                                                  jnp.asarray(rescan["pc"]))
        e = np.asarray(se3.rotation_error(R, gt[..., :3, :3]))
        rre.append(np.minimum.reduce([e, np.abs(180 - e), np.abs(90 - e)]).tolist())
    out["relocalization_rre_per_instance"] = rre
    t0 = time.perf_counter()
    out["reconstruction"] = eval_reconstruction(
        dataset, solver, gt_mesh_loader=lambda c, o: gt_meshes.get((c, o)))
    out["seconds"]["reconstruction"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps({k: v for k, v in out.items()
                      if k != "relocalization_rre_per_instance"}, indent=1, default=float))


if __name__ == "__main__":
    main()
