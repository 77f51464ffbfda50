"""The FlyingShape benchmark: matching, relocalization and reconstruction
over synthetic multi-scan scenes.

Counterpart of livingscenes_tpu/eval/flyingshape.py. A scene is a directory
of .npz files, one per scan (keys: pc (O, 3, N) or (O, N, 3), transform
(O, 4, 4), class_id, obj_id). Every instance of a scan goes through the
solver in one batch; each scan's arrays move to the solver's device once.
The ground-truth transforms are composed in the file's own precision and
then carried in the model's.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from .. import se3
from ..models.shape_prior import slice_codes
from ..solver.more import MoreSolver
from .metrics import (
    compute_chamfer_distance,
    compute_sdf_recall,
    compute_volumetric_iou,
    volumetric_iou_sampled,
)

log = logging.getLogger(__name__)


class FlyingShapeDataset:
    """Scenes root/<n_shape dir>/<scene dir>/*.npz, each .npz a scan."""

    def __init__(self, path: str):
        self.path = path
        self.scene_dirs: List[str] = []
        for n_shape in sorted(os.listdir(path)):
            sub = os.path.join(path, n_shape)
            if not os.path.isdir(sub):
                continue
            for scene in sorted(os.listdir(sub)):
                self.scene_dirs.append(os.path.join(sub, scene))

    def __len__(self):
        return len(self.scene_dirs)

    def __getitem__(self, idx: int) -> List[Dict[str, np.ndarray]]:
        scans = []
        for fp in sorted(glob.glob(os.path.join(self.scene_dirs[idx], "*.npz"))):
            data = dict(np.load(fp, allow_pickle=True))
            pc = np.asarray(data["pc"], np.float32)
            if pc.shape[1] == 3 and pc.shape[-1] != 3:
                pc = pc.transpose(0, 2, 1)  # (O, 3, N) -> (O, N, 3)
            data["pc"] = pc
            scans.append(data)
        return scans


def eval_matching(dataset, solver: MoreSolver, method: str = "sequential"):
    """Object recall and scene recall at 25/50/75/100 % of a scene's
    objects matched."""
    n_correct_total = n_match_total = 0
    ratio_lst = []
    for scene in _iter_scenes(dataset):
        ref_code = solver.encode_instances(scene[0]["pc"])
        for rescan in scene[1:]:
            rescan_code = solver.encode_instances(rescan["pc"])
            n_obj = rescan["pc"].shape[0]
            matches = solver.solve_object_matching(ref_code, rescan_code, method)
            pred = matches["matches0"].cpu().numpy()
            n_correct = int((pred == np.arange(n_obj)).sum())
            n_correct_total += n_correct
            n_match_total += n_obj
            ratio_lst.append(n_correct / n_obj)
    ratios = np.asarray(ratio_lst) * 100
    result = {"object_recall": 100.0 * n_correct_total / max(n_match_total, 1)}
    for pct in (25, 50, 75, 100):
        result[f"scene_recall@{pct}"] = float((ratios >= pct).mean() * 100)
    log.info("FlyingShape matching: %s", result)
    return result


def relocalization_errors(solver: MoreSolver, ref: dict, rescan: dict,
                          optim: bool = False) -> Dict[str, np.ndarray]:
    """Register every object of `ref` to the same object of `rescan` in one
    batch: per object, the rotation error (degrees, the smallest over the
    half- and quarter-turn symmetries), the translation error, the
    transformation RMSE and the registration chamfer."""
    device, dtype = solver.model.device, solver.model.dtype
    tsfm_ref = torch.as_tensor(ref["transform"])
    tsfm_rescan = torch.as_tensor(rescan["transform"])
    gt = se3.concatenate(tsfm_rescan, se3.inverse(tsfm_ref)).to(device, dtype)
    pc1, pc2 = solver._points(ref["pc"]), solver._points(rescan["pc"])
    R, t = solver.solve_pairwise_registration(pc1, pc2, optim=optim)
    rre = se3.rotation_error(R, gt[..., :3, :3]).cpu().numpy()
    rte = se3.translation_error(t, gt[..., :3, 3:]).cpu().numpy()
    rre = np.minimum.reduce([rre, np.abs(180 - rre), np.abs(90 - rre)])
    pred = se3.rt_to_se3(R, t)
    tsfm_err, cd = [], []
    for i in range(pc1.shape[0]):
        one = slice(i, i + 1)
        tsfm_err.append(se3.compute_transformation_error(
            pc1[one], pc2[one], pred[one], gt[one]))
        cd.append(se3.chamfer_distance_under_transforms(
            pc1[one], pc2[one], pred[one], gt[one])[0])
    return {"rre": rre, "rte": rte,
            "tsfm_err": torch.stack(tsfm_err).cpu().numpy(),
            "chamfer": torch.stack(cd).cpu().numpy()}


def eval_relocalization(dataset, solver: MoreSolver, optim: bool = False):
    """Recall at RRE 5 and 10 degrees, the median errors of the objects
    within each, the median registration chamfer, and the median
    transformation RMSE (cm) within 5 degrees; of each scene's first rescan
    against its reference."""
    errs = {"rre": [], "rte": [], "tsfm_err": [], "chamfer": []}
    for scene in _iter_scenes(dataset):
        for rescan in scene[1:2]:
            for k, v in relocalization_errors(solver, scene[0], rescan, optim).items():
                errs[k].extend(v.tolist())
    rre_a, rte_a = np.asarray(errs["rre"]), np.asarray(errs["rte"])
    tsfm_a, cd_a = np.asarray(errs["tsfm_err"]), np.asarray(errs["chamfer"])
    sel5, sel10 = rre_a < 5, rre_a < 10

    def median(a, sel):
        return float(np.median(a[sel])) if sel.any() else None

    result = {
        "recall_rre5": float(sel5.mean() * 100),
        "median_rre_rre5": median(rre_a, sel5),
        "median_rte_rre5": median(rte_a, sel5),
        "recall_rre10": float(sel10.mean() * 100),
        "median_rre_rre10": median(rre_a, sel10),
        "median_rte_rre10": median(rte_a, sel10),
        "median_chamfer": float(np.median(cd_a)),
        "median_te_cm": float(100 * np.median(tsfm_a[sel5])) if sel5.any() else None,
    }
    log.info("FlyingShape relocalization: %s", result)
    return result


def reconstruction_scores(solver: MoreSolver, scan: dict, gt_mesh_loader=None
                          ) -> List[Dict[str, float]]:
    """Mesh every object of a scan from its codes, carried back to the
    object's canonical pose, and score each against its ground-truth mesh
    (gt_mesh_loader(class_id, obj_id) -> Mesh or None): chamfer (the sum
    of the two ways), containment ratio, sampled volumetric IoU and SDF
    recall at 0.05. An empty mesh or a missing ground truth scores 0 and no
    chamfer; without a loader nothing is scored."""
    codes = solver.encode_instances(scan["pc"])
    poses = torch.as_tensor(scan["transform"])
    scores = []
    for i in range(scan["pc"].shape[0]):
        mesh = solver.mesh_from_latent(slice_codes(codes, i))
        tsfm = np.eye(4)
        tsfm[:3, :4] = se3.inverse(poses[i]).numpy()
        if not mesh.is_empty:
            mesh.apply_transform(tsfm)
        if gt_mesh_loader is None:
            continue
        gt_mesh = gt_mesh_loader(str(scan["class_id"][i]), str(scan["obj_id"][i]))
        if mesh.is_empty or gt_mesh is None:
            scores.append({"iou": 0.0, "iou_sampled": 0.0, "sdf_recall": 0.0})
            continue
        cd1, cd2 = compute_chamfer_distance(gt_mesh.sample_surface(30000), mesh)
        scores.append({
            "chamfer": cd1 + cd2,
            "sdf_recall": compute_sdf_recall(mesh, gt_mesh, 0.05),
            # the reference's "iou" is the share of ground-truth vertices
            # inside the prediction: on a near-exact mesh they sit on the
            # surface, where the test is a coin flip, so the sampled
            # volumetric IoU is reported beside it
            "iou": compute_volumetric_iou(mesh, gt_mesh),
            "iou_sampled": volumetric_iou_sampled(mesh, gt_mesh),
        })
    return scores


def eval_reconstruction(dataset, solver: MoreSolver, gt_mesh_loader=None):
    """Reconstruction of each scene's first scan: mean chamfer, SDF recall
    (share of objects with recall > 0.7), and the containment ratio and the
    sampled volumetric IoU (share > 0.5, mean and median, in %)."""
    scores = []
    for scene in _iter_scenes(dataset):
        scores += reconstruction_scores(solver, scene[0], gt_mesh_loader)
    cd = [s["chamfer"] for s in scores if "chamfer" in s]
    sdf = np.asarray([s["sdf_recall"] for s in scores])
    iou = np.asarray([s["iou"] for s in scores])
    iou_s = np.asarray([s["iou_sampled"] for s in scores])
    have = len(scores) > 0
    result = {
        "chamfer_mean": float(np.mean(cd)) if cd else None,
        "sdf_recall": float((sdf > 0.7).mean() * 100) if have else None,
        "viou_recall": float((iou > 0.5).mean() * 100) if have else None,
        "viou_mean": float(np.mean(iou) * 100) if have else None,
        "viou_median": float(np.median(iou) * 100) if have else None,
        "viou_sampled_recall": float((iou_s > 0.5).mean() * 100) if have else None,
        "viou_sampled_mean": float(np.mean(iou_s) * 100) if have else None,
        "viou_sampled_median": float(np.median(iou_s) * 100) if have else None,
    }
    log.info("FlyingShape reconstruction: %s", result)
    return result


def _iter_scenes(dataset):
    if isinstance(dataset, (list, tuple)):
        yield from dataset
    else:
        for i in range(len(dataset)):
            yield dataset[i]
