"""Runnable end-to-end demo on the PyTorch port: a synthetic two-scan scene
through the whole MORE pipeline (encode -> match -> register -> transport
-> mesh), with its scores and visualization artifacts.

    python scripts/torch_demo_end2end.py [--out DIR] \
        [--ckpt weights/production_r5_selected.ckpt] [--objects 4] [--optim] \
        [--device cpu]

Counterpart of scripts/demo_end2end.py, with the same arguments and
defaults and the same scene (make_scene: the same draws in the same order).
Runs on the card unless --device names another device; without a card and
without --device cpu it raises. Without a checkpoint the prior has random
(but equivariant) weights from seed 0: matching and registration still
follow from equivariance; reconstruction quality needs trained weights.
Writes matching.png, registration.png and recon_<i>.obj (each matched
instance's mesh) into --out.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
from scipy.spatial.transform import Rotation

N_POINTS = 1024  # points an object


def make_scene(objects: int = 4):
    """`objects` boxes of N_POINTS points at random sizes and places, and
    their rescan: each box rotated by Rm and moved by tm, the instances
    permuted by perm. Returns (objs, rescan, Rm, tm, perm): float32 (O, N,
    3), (O, N, 3), (O, 3, 3), (O, 1, 3) and the permutation (rescan = the
    moved objs[perm])."""
    rng = np.random.default_rng(0)
    O, N = objects, N_POINTS
    objs = rng.uniform(-0.5, 0.5, (O, N, 3)).astype(np.float32) * rng.uniform(
        0.3, 1.0, (O, 1, 3)
    ).astype(np.float32)
    objs += rng.uniform(-3, 3, (O, 1, 3)).astype(np.float32)
    Rm = Rotation.random(O, random_state=1).as_matrix().astype(np.float32)
    tm = rng.normal(size=(O, 1, 3)).astype(np.float32) * 0.5
    rescan = np.einsum("oij,onj->oni", Rm, objs) + tm
    perm = rng.permutation(O)
    return objs, rescan[perm], Rm, tm, perm


def solve(solver, objs, rescan, optim: bool = False, extract_meshes: bool = True):
    """solve_end2end on the scene (every point valid): matches0,
    registration (O, 4, 4), the codes and, with extract_meshes, mesh_list."""
    return solver.solve_end2end(objs, None, rescan, None, optim=optim,
                                extract_meshes=extract_meshes)


def scores(out, Rm, tm, perm):
    """(correct, rre, rte): whether each reference instance matched its
    rescan, and the rotation error (degrees) and translation error of its
    registration against its true motion."""
    import torch

    from livingscenes_tpu_torch import se3

    m0 = out["matches0"].cpu().numpy()
    correct = [bool(m0[i] == int(np.flatnonzero(perm == i)[0])) for i in range(len(perm))]
    tsfm = out["registration"].cpu()
    rre = se3.rotation_error(tsfm[:, :3, :3], torch.as_tensor(Rm, dtype=tsfm.dtype))
    rte = torch.linalg.norm(tsfm[:, :3, 3] - torch.as_tensor(tm[:, 0], dtype=tsfm.dtype),
                            dim=-1)
    return correct, rre.tolist(), rte.tolist()


def write_artifacts(out_dir: str, out, objs, rescan, perm) -> list:
    """matching.png (the two scans side by side, matched instances in one
    colour), registration.png (instance 0 before and after its
    registration onto its rescan) and recon_<i>.obj for each non-empty
    mesh of out["mesh_list"]. Returns the paths written."""
    from livingscenes_tpu_torch.utils.viz import (
        visualize_registration, visualize_shape_matching, write_png)

    m0 = out["matches0"].cpu().numpy()
    tsfm = out["registration"].cpu().numpy()
    paths = [os.path.join(out_dir, "matching.png"),
             os.path.join(out_dir, "registration.png")]
    write_png(paths[0], visualize_shape_matching(list(objs), list(rescan), m0))
    partner = int(np.flatnonzero(perm == 0)[0])
    write_png(paths[1], visualize_registration(objs[0], rescan[partner], tsfm[0]))
    for i, mesh in enumerate(out.get("mesh_list") or []):
        if mesh is not None and not mesh.is_empty:
            paths.append(os.path.join(out_dir, f"recon_{i}.obj"))
            mesh.export_obj(paths[-1])
    return paths


def main(argv=None, config=None) -> dict:
    """The demo; `config` (a MoreSolverConfig, None for the defaults) lets
    a caller set the solver, e.g. a coarser mesh. Returns the solution,
    the scores and the paths written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "lstpu_demo"))
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--objects", type=int, default=4)
    parser.add_argument("--optim", action="store_true")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the card)")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from livingscenes_tpu_torch.eval.run_flyingshape import load_solver

    solver = load_solver(args.ckpt, device=args.device, config=config)
    objs, rescan, Rm, tm, perm = make_scene(args.objects)
    out = solve(solver, objs, rescan, optim=args.optim)
    correct, rre, rte = scores(out, Rm, tm, perm)
    print(f"matching: {sum(correct)}/{len(correct)} correct -> "
          f"{out['matches0'].tolist()}")
    for i in range(len(correct)):
        print(f"object {i}: RRE {rre[i]:.3f} deg  RTE {rte[i]:.4f} m")
    paths = write_artifacts(args.out, out, objs, rescan, perm)
    print(f"artifacts in {args.out}")
    return {"solution": out, "correct": correct, "rre": rre, "rte": rte,
            "paths": paths}


if __name__ == "__main__":
    main()
