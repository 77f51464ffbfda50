"""Ablations of the SE(3) refinement's mechanisms on the PyTorch port (the
counterpart of scripts/ablate_optim.py, with its arguments and JSON keys).

Reruns the relocalization of the procedural benchmark (the seeds of
scripts/torch_demo_trained_eval.py build_benchmark) under each variant:

  base           Kabsch + ICP only (no refinement)
  optim          the production refinement
  nodir          direction pick off (always pc1 -> pc2)
  nobest         the last iterate instead of the best-loss one
  stop5/stop20   early-stop drift threshold 5 / 20 degrees
  blur02/blur001 Sinkhorn blur 0.2 / 0.01
  noicp          the refinement without the ICP after it

and writes per-instance (scene, obj, rre, rte, chamfer) records per
variant, with the instances whose RRE < 10 verdict flips between base and
optim.

    python scripts/torch_ablate_optim.py --ckpt weights/plateau_r4_selected.ckpt \\
        --n-scenes 12 --out docs/ablate_optim_r4_torch.json [--device cpu]

Runs on the card unless --device names another device; the output names
the card and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

from torch_demo_trained_eval import build_benchmark
from torch_probe_icp_accept import card_line, gt_rotation_error


def variants(prod) -> dict:
    """name -> (RegistrationConfig, optim) of every ablation of `prod`."""
    rep = dataclasses.replace
    return {
        "base": (prod, False),
        "optim": (prod, True),
        "nodir": (rep(prod, direction_pick=False), True),
        "nobest": (rep(prod, track_best=False), True),
        "stop5": (rep(prod, early_stop_deg=5.0), True),
        "stop20": (rep(prod, early_stop_deg=20.0), True),
        "blur02": (rep(prod, sinkhorn_blur=0.2), True),
        "blur001": (rep(prod, sinkhorn_blur=0.01), True),
        "noicp": (rep(prod, use_icp=False), True),
    }


@torch.no_grad()
def run_variant(dataset, solver, optim: bool) -> list:
    """Per-instance relocalization records of the first rescan of every
    scene: scene, obj, rre (degrees, the smallest over the half- and
    quarter-turn symmetries), rte and the registration chamfer."""
    from livingscenes_tpu_torch import se3
    from livingscenes_tpu_torch.eval.flyingshape import _iter_scenes

    model = solver.model
    records = []
    for i_scene, scene in enumerate(_iter_scenes(dataset)):
        ref = scene[0]
        for rescan in scene[1:2]:
            gt = se3.concatenate(torch.as_tensor(rescan["transform"]),
                                 se3.inverse(torch.as_tensor(ref["transform"]))
                                 ).to(model.device, model.dtype)
            pc1, pc2 = solver._points(ref["pc"]), solver._points(rescan["pc"])
            R, t = solver.solve_pairwise_registration(pc1, pc2, optim=optim)
            rre = gt_rotation_error(R, gt)
            rte = se3.translation_error(t, gt[..., :3, 3:]).cpu().numpy()
            pred = se3.rt_to_se3(R, t)
            for i in range(pc1.shape[0]):
                one = slice(i, i + 1)
                cd = se3.chamfer_distance_under_transforms(pc1[one], pc2[one],
                                                           pred[one], gt[one])
                records.append({"scene": i_scene, "obj": i, "rre": float(rre[i]),
                                "rte": float(rte[i]), "chamfer": float(cd[0])})
    return records


def summarize(records) -> dict:
    rre = np.array([r["rre"] for r in records])
    cd = np.array([r["chamfer"] for r in records])
    return {"recall_rre10": round(float((rre < 10).mean() * 100), 2),
            "recall_rre5": round(float((rre < 5).mean() * 100), 2),
            "median_rre": round(float(np.median(rre)), 3),
            "median_chamfer": float(np.median(cd)), "n": len(records)}


def flips(base, optim) -> list:
    """The instances whose RRE < 10 verdict differs between two variants."""
    return [{"scene": rb["scene"], "obj": rb["obj"], "rre_base": round(rb["rre"], 2),
             "rre_optim": round(ro["rre"], 2)}
            for rb, ro in zip(base, optim) if (rb["rre"] < 10) != (ro["rre"] < 10)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="weights/plateau_r4_selected.ckpt")
    ap.add_argument("--root", default=None,
                    help="where to build the benchmark (default: a temporary directory)")
    ap.add_argument("--n-scenes", type=int, default=12)
    ap.add_argument("--n-pts", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=None, help="comma list; default: all")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from livingscenes_tpu_torch.eval.flyingshape import FlyingShapeDataset
    from livingscenes_tpu_torch.eval.run_flyingshape import load_solver
    from livingscenes_tpu_torch.solver import MoreSolver, MoreSolverConfig
    from livingscenes_tpu_torch.solver.registration import RegistrationConfig

    chosen = variants(RegistrationConfig())
    if args.variants:
        keep = args.variants.split(",")
        chosen = {k: v for k, v in chosen.items() if k in keep}
    root = args.root or tempfile.mkdtemp(prefix="lstpu_torch_ablate_optim_")
    results, all_records = {}, {}
    try:
        build_benchmark(root, n_scenes=args.n_scenes, n_pts=args.n_pts)
        dataset = FlyingShapeDataset(root)
        model = load_solver(args.ckpt, device=args.device).model
        for name, (reg_cfg, optim) in chosen.items():
            solver = MoreSolver(model, MoreSolverConfig(n_input_point=args.n_pts,
                                                        registration=reg_cfg))
            all_records[name] = run_variant(dataset, solver, optim=optim)
            results[name] = summarize(all_records[name])
            print(name, json.dumps(results[name]), flush=True)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    if "base" in all_records and "optim" in all_records:
        results["flips_base_vs_optim"] = flips(all_records["base"], all_records["optim"])
        print("flips:", json.dumps(results["flips_base_vs_optim"]), flush=True)
    results["device"] = str(model.device)
    results["card"] = card_line() if model.device.type == "cuda" else "cpu"
    results["args"] = vars(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": results, "records": all_records}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
