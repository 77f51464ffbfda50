"""The mesh evaluator of training validation.

Counterpart of livingscenes_tpu/eval/mesh_eval.py (`MeshEvaluator`,
`distance_p2p_with_normals`): completeness and accuracy (and their
squares), normal consistency, chamfer L1 and L2, the F-score at a
threshold, and the occupancy IoU on evaluation points, on the port's native
kd-tree.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..native.bindings import KDTree, check_mesh_contains
from ..recon.mesh import Mesh

_KEYS = ("completeness", "accuracy", "completeness2", "accuracy2",
         "normals_completeness", "normals_accuracy", "normals", "chamfer_l1",
         "chamfer_l2", "fscore")


def distance_p2p_with_normals(points_src: np.ndarray, normals_src: Optional[np.ndarray],
                              points_tgt: np.ndarray, normals_tgt: Optional[np.ndarray]):
    """Each source point's distance to its nearest target point, and the
    |cos| of the angle between their normals (NaN without normals)."""
    dist, idx = KDTree(points_tgt).query(points_src)
    if normals_src is not None and normals_tgt is not None:
        ns = normals_src / np.maximum(
            np.linalg.norm(normals_src, axis=-1, keepdims=True), 1e-12)
        nt = normals_tgt / np.maximum(
            np.linalg.norm(normals_tgt, axis=-1, keepdims=True), 1e-12)
        dot = np.abs((nt[idx] * ns).sum(-1))
    else:
        dot = np.full(len(points_src), np.nan, np.float32)
    return dist, dot


class MeshEvaluator:
    """Scores a mesh by `n_points` samples of its surface."""

    def __init__(self, n_points: int = 100000, fscore_threshold: float = 0.01):
        self.n_points = n_points
        self.fscore_threshold = fscore_threshold

    def eval_mesh(self, mesh: Mesh, pointcloud_tgt: np.ndarray,
                  normals_tgt: Optional[np.ndarray] = None,
                  points_iou: Optional[np.ndarray] = None,
                  occ_tgt: Optional[np.ndarray] = None, seed: int = 0) -> Dict[str, float]:
        if mesh.is_empty or len(pointcloud_tgt) == 0:
            out = {k: float("nan") for k in _KEYS}
            if points_iou is not None:
                out["iou"] = 0.0
            return out
        pc, nrm = mesh.sample_surface(self.n_points, seed=seed, return_normals=True)
        return self.eval_pointcloud(pc, pointcloud_tgt, nrm, normals_tgt,
                                    points_iou=points_iou, occ_tgt=occ_tgt, mesh=mesh)

    def eval_pointcloud(self, pointcloud: np.ndarray, pointcloud_tgt: np.ndarray,
                        normals: Optional[np.ndarray] = None,
                        normals_tgt: Optional[np.ndarray] = None,
                        points_iou: Optional[np.ndarray] = None,
                        occ_tgt: Optional[np.ndarray] = None,
                        mesh: Optional[Mesh] = None) -> Dict[str, float]:
        # completeness: target -> prediction; accuracy: prediction -> target
        completeness, comp_n = distance_p2p_with_normals(
            pointcloud_tgt, normals_tgt, pointcloud, normals)
        accuracy, acc_n = distance_p2p_with_normals(
            pointcloud, normals, pointcloud_tgt, normals_tgt)
        comp2, acc2 = completeness ** 2, accuracy ** 2
        th = self.fscore_threshold
        recall = float((completeness <= th).mean())
        precision = float((accuracy <= th).mean())
        fscore = (2 * recall * precision / (recall + precision)
                  if recall + precision > 0 else 0.0)
        have_normals = not np.all(np.isnan(comp_n))
        n_comp = float(np.nanmean(comp_n)) if have_normals else float("nan")
        n_acc = float(np.nanmean(acc_n)) if have_normals else float("nan")
        out = {
            "completeness": float(completeness.mean()),
            "accuracy": float(accuracy.mean()),
            "completeness2": float(comp2.mean()),
            "accuracy2": float(acc2.mean()),
            "normals_completeness": n_comp,
            "normals_accuracy": n_acc,
            "normals": 0.5 * (n_comp + n_acc),
            "chamfer_l1": float(0.5 * (completeness.mean() + accuracy.mean())),
            "chamfer_l2": float(0.5 * (comp2.mean() + acc2.mean())),
            "fscore": float(fscore),
        }
        if points_iou is not None and occ_tgt is not None and mesh is not None:
            occ_pred = check_mesh_contains(mesh.vertices, mesh.faces, points_iou)
            gt = np.asarray(occ_tgt) > 0.5
            union = np.logical_or(occ_pred, gt).sum()
            out["iou"] = float(np.logical_and(occ_pred, gt).sum() / max(union, 1))
        return out
