"""Score inference-time acceptance rules for the ICP after the SE(3)
refinement, on the PyTorch port (the counterpart of
scripts/probe_icp_accept.py, with its arguments and JSON keys).

ICP has its own fixed point per instance and can overwrite a good
refinement, so the solver keeps the ICP pose only where a proxy says it
improved the alignment (RegistrationConfig.icp_accept). For every instance
this records the ground-truth rotation error and two proxies,

  symch   mean nearest-neighbour distance, both ways, between T(pc1) and pc2
  sdf     mean |decoder sdf| of T(pc1) under the target's code

for four poses: kab (Kabsch from the codes), kab_icp (Kabsch then ICP),
ref (Kabsch then the 400-step refinement, no ICP) and ref_icp (refinement
then ICP), and scores the rules over {ref, ref_icp}: always, never, the
proxies' argmin and the oracle.

    python scripts/torch_probe_icp_accept.py --ckpt weights/production_r5_selected.ckpt \\
        --n-scenes 24 --n-pts 1024 --seed 1234 --rot-seed 999 \\
        --out docs/probe_icp_accept_r5_heldout_torch.json [--device cpu]

The benchmark is scripts/torch_demo_trained_eval.py build_benchmark's.
Runs on the card unless --device names another device; the output names
the card and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from torch_demo_trained_eval import build_benchmark

POSES = ("kab", "kab_icp", "ref", "ref_icp")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or what stands
    in for it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def symm_chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B,) symmetric mean nearest-neighbour
    distance."""
    d = torch.linalg.norm(a[:, :, None] - b[:, None], dim=-1)
    return d.min(dim=2).values.mean(dim=1) + d.min(dim=1).values.mean(dim=1)


def gt_rotation_error(R: torch.Tensor, gt: torch.Tensor) -> np.ndarray:
    """Degrees, the smallest over the half- and quarter-turn symmetries."""
    from livingscenes_tpu_torch import se3

    rre = se3.rotation_error(R, gt[..., :3, :3]).cpu().numpy()
    return np.minimum.reduce([rre, np.abs(180 - rre), np.abs(90 - rre)])


@torch.no_grad()
def probe_scene(solver, ref: dict, rescan: dict, icp_iterations: int = 100,
                fused_stats=None) -> dict:
    """One scene's instances: {pose: {"rre", "symch", "sdf"}} for the four
    poses. `solver` registers without ICP (use_icp=False); the ICP runs
    (ops/icp.py, `fused_stats` as there) start from the Kabsch and the
    refined poses."""
    from livingscenes_tpu_torch import se3
    from livingscenes_tpu_torch.ops.icp import iterative_closest_point

    model = solver.model
    gt = se3.concatenate(torch.as_tensor(rescan["transform"]),
                         se3.inverse(torch.as_tensor(ref["transform"]))
                         ).to(model.device, model.dtype)
    pc1, pc2 = solver._points(ref["pc"]), solver._points(rescan["pc"])
    codes1, codes2 = solver.encode_instances(pc1), solver.encode_instances(pc2)
    poses = {}
    for name, optim in (("kab", False), ("ref", True)):
        poses[name] = solver.solve_pairwise_registration(
            pc1, pc2, optim=optim, codes1=codes1, codes2=codes2)
    for src, dst in (("kab", "kab_icp"), ("ref", "ref_icp")):
        R0, t0 = poses[src]
        res = iterative_closest_point(pc1, pc2, init_R=R0, init_t=t0[..., 0],
                                      max_iterations=icp_iterations,
                                      fused_stats=fused_stats)
        poses[dst] = (res.R, res.t[..., None])
    row = {}
    for name in POSES:
        R, t = poses[name]
        moved = torch.einsum("bij,bnj->bni", R, pc1) + t[..., 0][:, None]
        sdf = torch.abs(model.decode_sdf(moved, codes2)).mean(dim=-1)
        row[name] = {"rre": gt_rotation_error(R, gt).tolist(),
                     "symch": symm_chamfer(moved, pc2).cpu().numpy().tolist(),
                     "sdf": sdf.cpu().numpy().tolist()}
    return row


def recall_row(rre: np.ndarray) -> dict:
    return {"recall_rre10": round(float((rre < 10).mean() * 100), 2),
            "recall_rre5": round(float((rre < 5).mean() * 100), 2),
            "median_rre": round(float(np.median(rre)), 3)}


def score(records) -> dict:
    """The summary of probe_icp_accept.py: each pose's recalls and median
    rotation error, and the rules over {ref, ref_icp}."""
    def flat(name, key):
        return np.concatenate([np.asarray(r[name][key]) for r in records])

    rre = {k: flat(k, "rre") for k in POSES}
    out = {"n": int(rre["ref"].size)}
    out.update({k: recall_row(v) for k, v in rre.items()})
    rules = {}
    for proxy in ("symch", "sdf"):
        take_icp = flat("ref_icp", proxy) < flat("ref", proxy)
        rules[f"accept_by_{proxy}"] = dict(
            recall_row(np.where(take_icp, rre["ref_icp"], rre["ref"])),
            icp_taken_frac=round(float(take_icp.mean()), 3))
    rules["oracle"] = recall_row(np.minimum(rre["ref"], rre["ref_icp"]))
    out["rules"] = rules
    return out


def noicp_solver(ckpt, n_pts: int, device=None):
    """The production model with `ckpt`'s weights and a solver that
    registers without ICP (eval/run_flyingshape.py load_solver)."""
    from livingscenes_tpu_torch.eval.run_flyingshape import load_solver
    from livingscenes_tpu_torch.solver import MoreSolverConfig
    from livingscenes_tpu_torch.solver.registration import RegistrationConfig

    noicp = dataclasses.replace(RegistrationConfig(), use_icp=False)
    return load_solver(ckpt, device=device,
                       config=MoreSolverConfig(n_input_point=n_pts, registration=noicp))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="weights/plateau_r4_selected.ckpt")
    ap.add_argument("--root", default=None,
                    help="where to build the benchmark (default: a temporary directory)")
    ap.add_argument("--n-scenes", type=int, default=12)
    ap.add_argument("--n-pts", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7,
                    help="benchmark shape/translation seed (7 = the standard "
                    "capstone set; a fresh value gives a held-out set)")
    ap.add_argument("--rot-seed", type=int, default=None,
                    help="rotation stream base (None = 100 + scene)")
    ap.add_argument("--family", default="train", choices=["train", "torus"],
                    help="'train': the box, ellipsoid and capsule kinds the "
                    "checkpoint saw; 'torus': the genus-1 family it never saw")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from livingscenes_tpu_torch.eval.flyingshape import FlyingShapeDataset, _iter_scenes

    shape_kinds = (0, 1, 2) if args.family == "train" else (3,)
    root = args.root or tempfile.mkdtemp(prefix="lstpu_torch_probe_icp_")
    try:
        build_benchmark(root, n_scenes=args.n_scenes, n_pts=args.n_pts, seed=args.seed,
                        rot_seed=args.rot_seed, shape_kinds=shape_kinds)
        solver = noicp_solver(args.ckpt, args.n_pts, args.device)
        records = []
        for i_scene, scene in enumerate(_iter_scenes(FlyingShapeDataset(root))):
            records.append(dict(scene=i_scene, **probe_scene(solver, scene[0], scene[1])))
            print(f"scene {i_scene} done", flush=True)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    out = score(records)
    out["device"] = str(solver.model.device)
    out["card"] = card_line() if solver.model.device.type == "cuda" else "cpu"
    out["args"] = vars(args)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": out, "records": records}, f, indent=1)
    return out


if __name__ == "__main__":
    main()
