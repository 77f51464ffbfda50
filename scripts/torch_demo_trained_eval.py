"""The capstone on the PyTorch port: a trained checkpoint scored on the
procedural FlyingShape benchmark.

    python scripts/torch_demo_trained_eval.py \
        --ckpt weights/production_r5_selected.ckpt --n-scenes 24 --optim \
        [--out results.json] [--device cpu]

Builds the benchmark of scripts/demo_trained_eval.py (the same seeds,
rotation streams and analytic ground-truth meshes: n_scenes scenes of 4
procedural shapes, each scene a reference scan and a rescan that moves
every shape) and runs the port's eval drivers on it: matching,
relocalization (and with --optim the 400-step refinement) and
reconstruction with chamfer, volumetric IoU and SDF recall. The JAX
package's scores of weights/production_r5_selected.ckpt on this benchmark
are docs/demo_trained_eval_r5_96inst.json (24 scenes) and
docs/demo_trained_eval_r5_48inst.json (12 scenes). Runs on the card unless
--device names another device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
from scipy.spatial.transform import Rotation

GT_RES = 64  # the ground-truth meshes' marching grid over [-0.6, 0.6]^3


def build_benchmark(root: str, n_scenes: int = 4, n_obj: int = 4, n_pts: int = 512,
                    seed: int = 7, rot_seed=None, shape_kinds=(0, 1, 2)):
    """Write the procedural FlyingShape tree under `root` and return the
    analytic ground-truth meshes {(class_id, obj_id): Mesh} in the
    reference scan's frame.

    `seed` drives the shapes and translations, `rot_seed` (None: the
    stream 100 + scene) the rescan's rotations; scenes are drawn in order
    from one generator, so the first n scenes of a larger build are those
    of an n-scene build. Scene directories of an earlier, larger build in
    the same root are removed: the dataset reads every scene directory,
    and their instances would have no ground truth here."""
    from livingscenes_tpu_torch.native.bindings import marching_isosurface
    from livingscenes_tpu_torch.recon.mesh import Mesh
    from livingscenes_tpu_torch.train.data import SyntheticShapeDataset

    ds = SyntheticShapeDataset(n_items=1, n_pcl=n_pts, shape_kinds=shape_kinds)
    rng = np.random.default_rng(seed)
    gt_meshes = {}
    for stale in glob.glob(os.path.join(root, f"shape_{n_obj}", "scene_*")):
        if int(os.path.basename(stale).split("_")[1]) >= n_scenes:
            shutil.rmtree(stale)

    axis = np.linspace(-0.6, 0.6, GT_RES)
    grid_pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    for s in range(n_scenes):
        scene_dir = os.path.join(root, f"shape_{n_obj}", f"scene_{s:03d}")
        os.makedirs(scene_dir, exist_ok=True)
        pcs, class_ids, obj_ids = [], [], []
        for o in range(n_obj):
            sdf = ds._shape_sdf(rng)
            surf = ds._surface_points(sdf, rng, n_pts)
            offset = rng.uniform(-2.0, 2.0, 3)
            pcs.append(surf + offset)
            class_ids.append("proc")
            obj_ids.append(f"s{s}_o{o}")
            grid = sdf(grid_pts).reshape(GT_RES, GT_RES, GT_RES)
            v, f = marching_isosurface(grid.astype(np.float32), 0.0)
            v = v / (GT_RES - 1) * 1.2 - 0.6 + offset
            gt_meshes[("proc", f"s{s}_o{o}")] = Mesh(v.astype(np.float32),
                                                      f.astype(np.int64))

        pcs = np.stack(pcs).astype(np.float32)
        rot_state = (100 + s) if rot_seed is None else (rot_seed + s)
        Rm = Rotation.random(n_obj, random_state=rot_state).as_matrix()
        tm = rng.normal(size=(n_obj, 3)) * 0.4
        moved = np.einsum("bij,bnj->bni", Rm, pcs) + tm[:, None]
        t0 = np.tile(np.eye(4), (n_obj, 1, 1)).astype(np.float32)
        t1 = np.tile(np.eye(4), (n_obj, 1, 1)).astype(np.float32)
        t1[:, :3, :3] = Rm
        t1[:, :3, 3] = tm
        common = dict(class_id=np.array(class_ids), obj_id=np.array(obj_ids))
        np.savez(os.path.join(scene_dir, "scan_000.npz"),
                 pc=pcs.transpose(0, 2, 1), transform=t0, **common)
        np.savez(os.path.join(scene_dir, "scan_001.npz"),
                 pc=moved.astype(np.float32).transpose(0, 2, 1), transform=t1,
                 **common)
    return gt_meshes


def capstone_solver(ckpt, n_pts: int, recon_upsample: int = 1, icp_accept=None,
                    device=None):
    """The production model with `ckpt`'s weights (eval/run_flyingshape.py
    load_solver, fast=True) under the capstone's solver settings: encoder
    input n_pts, meshes from a 32^3 grid refined `recon_upsample` times and
    simplified to 5000 faces."""
    from livingscenes_tpu_torch.eval.run_flyingshape import load_solver
    from livingscenes_tpu_torch.recon.extractor import MeshExtractorConfig
    from livingscenes_tpu_torch.solver import MoreSolverConfig
    from livingscenes_tpu_torch.solver.registration import RegistrationConfig

    reg = RegistrationConfig(icp_accept=icp_accept) if icp_accept else RegistrationConfig()
    cfg = MoreSolverConfig(
        n_input_point=n_pts, registration=reg,
        mesh_extractor=MeshExtractorConfig(resolution0=32,
                                           upsampling_steps=recon_upsample,
                                           simplify_nfaces=5000))
    return load_solver(ckpt, device=device, config=cfg)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--root", default=None,
                        help="where to build the benchmark (default: a temporary "
                        "directory, removed at the end)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--n-pts", type=int, default=1024,
                        help="points an instance (1024: the production model's input)")
    parser.add_argument("--recon-upsample", type=int, default=1,
                        help="mesh extractor upsampling steps (1: a 64^3 grid)")
    parser.add_argument("--optim", action="store_true",
                        help="also run the 400-step refined relocalization")
    parser.add_argument("--n-scenes", type=int, default=4,
                        help="benchmark size (n_scenes x 4 objects)")
    parser.add_argument("--seed", type=int, default=7,
                        help="shape/translation seed (7: the standard capstone)")
    parser.add_argument("--rot-seed", type=int, default=None,
                        help="rotation stream base (None: 100 + scene)")
    parser.add_argument("--icp-accept", default=None,
                        choices=["symch", "always", "sdf"],
                        help="ICP acceptance (None: the default 'symch'; "
                        "'always': the reference's unconditional polish)")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the card)")
    args = parser.parse_args(argv)

    from livingscenes_tpu_torch.eval.flyingshape import (
        FlyingShapeDataset,
        eval_matching,
        eval_reconstruction,
        eval_relocalization,
    )

    solver = capstone_solver(args.ckpt, args.n_pts, args.recon_upsample,
                             args.icp_accept, args.device)
    root = args.root or tempfile.mkdtemp(prefix="lstpu_torch_capstone_")
    try:
        gt_meshes = build_benchmark(root, n_scenes=args.n_scenes, n_pts=args.n_pts,
                                    seed=args.seed, rot_seed=args.rot_seed)
        dataset = FlyingShapeDataset(root)
        runs = [("matching", lambda: eval_matching(dataset, solver)),
                ("relocalization",
                 lambda: eval_relocalization(dataset, solver, optim=False))]
        if args.optim:
            runs.append(("relocalization_optim",
                         lambda: eval_relocalization(dataset, solver, optim=True)))
        runs.append(("reconstruction", lambda: eval_reconstruction(
            dataset, solver, gt_mesh_loader=lambda c, o: gt_meshes.get((c, o)))))
        results = {}
        for name, run in runs:
            t0 = time.perf_counter()
            results[name] = run()
            print(f"[{name} done {time.perf_counter() - t0:.0f}s]", flush=True)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(results, indent=1, default=float))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    return results


if __name__ == "__main__":
    main()
