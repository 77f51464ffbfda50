"""The evaluation suite of the PyTorch port (see
livingscenes_tpu_torch/__init__.py): metrics, the mesh evaluator, and the
FlyingShape and 3RScan benchmark drivers."""
from .metrics import (
    compute_chamfer_distance,
    compute_volumetric_iou,
    volumetric_iou_sampled,
    compute_sdf_recall,
    distance_p2p,
    f_score,
    chamfer_distance_under_transforms,
)

__all__ = [
    "compute_chamfer_distance",
    "compute_volumetric_iou",
    "volumetric_iou_sampled",
    "compute_sdf_recall",
    "distance_p2p",
    "f_score",
    "chamfer_distance_under_transforms",
]
