"""The evaluation metrics, on the host.

Counterpart of livingscenes_tpu/eval/metrics.py, on the port's native
kd-tree and point-in-mesh tests (native/bindings.py) and numpy:

* chamfer distance between ground-truth points and a generated mesh (30k
  surface samples, squared nearest-neighbour distances both ways);
* the reference's "volumetric IoU", a containment ratio: the share of one
  mesh's vertices inside the other;
* the sampled volumetric IoU over uniform points of the union's box;
* SDF recall: the share of one mesh's vertices within a distance of the
  other's surface;
* point-to-point distances and the F-score;
* the registration chamfer under predicted and true transforms, from
  se3.chamfer_distance_under_transforms (on the transforms' device).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..native.bindings import KDTree, check_mesh_contains
from ..recon.mesh import Mesh
from ..se3 import chamfer_distance_under_transforms  # noqa: F401 (re-export)


def compute_chamfer_distance(gt_points: np.ndarray, gen_mesh: Mesh, offset=0.0,
                             scale=1.0, num_mesh_samples: int = 30000,
                             seed: int = 0) -> Tuple[float, float]:
    """The two one-way squared chamfer means (gt -> gen, gen -> gt)."""
    gen_points = gen_mesh.sample_surface(num_mesh_samples, seed=seed)
    gen_points = (gen_points / scale - offset).astype(np.float32)
    gt = np.asarray(gt_points, np.float32).reshape(-1, 3)
    d1, _ = KDTree(gen_points).query(gt)
    d2, _ = KDTree(gt).query(gen_points)
    return float(np.mean(np.square(d1))), float(np.mean(np.square(d2)))


def compute_volumetric_iou(mesh1: Mesh, mesh2: Mesh) -> float:
    """The share of mesh2's vertices inside mesh1."""
    if mesh1.is_empty or mesh2.is_empty:
        return 0.0
    inside = check_mesh_contains(mesh1.vertices, mesh1.faces, mesh2.vertices)
    return float(inside.mean())


def volumetric_iou_sampled(mesh1: Mesh, mesh2: Mesh, n_samples: int = 100000,
                           seed: int = 0) -> float:
    """Volumetric IoU over n_samples uniform points of the box around both
    meshes."""
    if mesh1.is_empty or mesh2.is_empty:
        return 0.0
    lo = np.minimum(mesh1.vertices.min(0), mesh2.vertices.min(0))
    hi = np.maximum(mesh1.vertices.max(0), mesh2.vertices.max(0))
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, size=(n_samples, 3)).astype(np.float32)
    in1 = check_mesh_contains(mesh1.vertices, mesh1.faces, pts)
    in2 = check_mesh_contains(mesh2.vertices, mesh2.faces, pts)
    union = np.logical_or(in1, in2).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(in1, in2).sum() / union)


def compute_sdf_recall(mesh1: Mesh, mesh2: Mesh, thres: float = 0.1) -> float:
    """The share of mesh2's vertices within `thres` of mesh1's surface (30k
    samples of it)."""
    if mesh1.is_empty or mesh2.is_empty:
        return 0.0
    surf = mesh1.sample_surface(30000, seed=0).astype(np.float32)
    d, _ = KDTree(surf).query(mesh2.vertices)
    return float((np.abs(d) < thres).mean())


def distance_p2p(points_src: np.ndarray, points_tgt: np.ndarray) -> np.ndarray:
    """The distance from each source point to its nearest target point."""
    return KDTree(points_tgt).query(points_src)[0]


def f_score(points_src: np.ndarray, points_tgt: np.ndarray, threshold: float) -> float:
    """Harmonic mean of precision (sources near a target) and recall
    (targets near a source) at `threshold`."""
    recall = float((distance_p2p(points_tgt, points_src) <= threshold).mean())
    precision = float((distance_p2p(points_src, points_tgt) <= threshold).mean())
    if recall + precision == 0:
        return 0.0
    return 2 * recall * precision / (recall + precision)
