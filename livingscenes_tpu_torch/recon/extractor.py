"""From codes to meshes: occupancy-logit grids on the device, then the host
meshing (isosurface extraction and quadric simplification in C++,
native/bindings.py).

Counterpart of livingscenes_tpu/recon/extractor.py (`MeshExtractorConfig`,
`MeshExtractor`, `extract_mesh_from_grid`), without the gradient-based
vertex refinement (`refinement_step`, 0 in every shipped configuration).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..native.bindings import marching_isosurface, simplify_mesh
from .grid import dense_grid_values, hierarchical_grid_values
from .mesh import Mesh

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MeshExtractorConfig:
    """Defaults mirror configs/more_3rscan.yaml:20-27."""

    threshold: float = 0.5  # occupancy probability threshold
    resolution0: int = 32
    upsampling_steps: int = 2
    padding: float = 0.1
    simplify_nfaces: Optional[int] = 5000
    points_batch_size: int = 65536
    use_hierarchical: bool = True
    refine_cap_factor: int = 20
    # "packsort" or "topk"; see recon/grid.hierarchical_grid_values
    select_mode: str = "packsort"
    dedup: bool = True
    # Gradient-based vertex refinement: not ported, MeshExtractor raises
    # on a value above 0.
    refinement_step: int = 0
    refinement_lr: float = 1e-4

    @property
    def logit_threshold(self) -> float:
        return math.log(self.threshold) - math.log(1.0 - self.threshold)

    @property
    def final_resolution(self) -> int:
        return self.resolution0 * (2**self.upsampling_steps)

    @property
    def box_size(self) -> float:
        return 1.0 + self.padding


class MeshExtractor:
    """Meshes from codes through a field `occupancy_logits_fn(query
    (B, M, 3), codes) -> (B, M)` (e.g. model.occupancy_logits); the grids
    are evaluated on the codes' device."""

    def __init__(self, occupancy_logits_fn: Callable[[torch.Tensor, Codes], torch.Tensor],
                 config: MeshExtractorConfig = MeshExtractorConfig()):
        if config.refinement_step > 0:
            raise NotImplementedError(
                "refinement_step > 0 (refine_mesh_vertices) is not ported")
        self.config = config
        self._logits_fn = occupancy_logits_fn

    @torch.no_grad()
    def compute_grid(self, codes: Codes):
        """The (n, n, n) value grid of one instance's codes and the refine
        levels' overflow (steps,)."""
        cfg = self.config
        device = codes["s"].device

        def decode_one(pts):
            return self._logits_fn(pts[None], codes)[0]

        if cfg.use_hierarchical:
            values, stats = hierarchical_grid_values(
                decode_one,
                resolution0=cfg.resolution0,
                upsampling_steps=cfg.upsampling_steps,
                threshold=cfg.logit_threshold,
                box_size=cfg.box_size,
                chunk_size=cfg.points_batch_size,
                refine_cap_factor=cfg.refine_cap_factor,
                return_stats=True,
                select_mode=cfg.select_mode,
                dedup=cfg.dedup,
                device=device,
            )
            return values, stats["overflow"]
        values = dense_grid_values(
            decode_one, resolution=cfg.final_resolution, box_size=cfg.box_size,
            chunk_size=cfg.points_batch_size, device=device)
        return values, torch.zeros((0,), dtype=torch.int32, device=device)

    def extract_from_grid(self, value_grid: np.ndarray) -> Mesh:
        """Host: padded isosurface extraction, rescale, simplification."""
        return extract_mesh_from_grid(value_grid, self.config)

    def generate_from_codes(self, codes: Codes) -> Mesh:
        """Mesh one instance: the grid of its canonical code (s = 1,
        t = 0), then its scale and translation applied to the mesh."""
        scale = float(codes["s"].reshape(-1)[0])
        center = codes["t"].reshape(3).cpu().numpy()
        canonical = dict(codes, s=torch.ones_like(codes["s"]),
                         t=torch.zeros_like(codes["t"]))
        grid, overflow = self.compute_grid(canonical)
        overflow = overflow.cpu().numpy()
        if overflow.size and overflow.max() > 0:
            logging.getLogger(__name__).warning(
                "hierarchical grid refinement cap overflow: %s active "
                "points dropped per level %s — mesh accuracy degraded "
                "(raise refine_cap_factor or check for a noisy code)",
                overflow.tolist(), list(range(1, overflow.size + 1)),
            )
        mesh = self.extract_from_grid(grid.cpu().numpy())
        if not mesh.is_empty:
            mesh.apply_scale_translation(scale, center)
        return mesh

    def generate_batch(self, codes: Codes) -> List[Mesh]:
        """Mesh every instance of a batch of codes, one after another."""
        from ..models.shape_prior import slice_codes

        return [self.generate_from_codes(slice_codes(codes, i))
                for i in range(codes["s"].shape[0])]


def extract_mesh_from_grid(value_grid: np.ndarray,
                           cfg: MeshExtractorConfig = MeshExtractorConfig(),
                           stats: Optional[dict] = None) -> Mesh:
    """Host: padded isosurface extraction, rescale to the box, and
    simplification of an (n, n, n) occupancy-logit grid.

    A grid wholly on one side of the threshold gives an empty mesh (and a
    warning) rather than the box its padding would close. With `stats` (a
    dict), writes faces_raw (the extraction's faces), faces (after
    simplification), iso_ms and simplify_ms into it."""
    n = value_grid.shape[0]
    thr = cfg.logit_threshold
    above = (value_grid > thr).all()
    if above or (value_grid <= thr).all():
        logging.getLogger(__name__).warning(
            "value grid is uniformly %s the iso-threshold — returning "
            "an empty mesh (degenerate code?)", "above" if above else "below")
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    t0 = time.perf_counter()
    padded = np.pad(value_grid.astype(np.float32), 1, constant_values=-1e6)
    verts, faces = marching_isosurface(padded, thr)
    t1 = time.perf_counter()
    if stats is not None:
        stats["faces_raw"] = len(faces)
        stats["iso_ms"] = (t1 - t0) * 1e3
    if len(verts) == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    verts = verts - 1.0  # undo the padding
    verts = verts / (n - 1)
    verts = cfg.box_size * (verts - 0.5)
    if cfg.simplify_nfaces is not None and len(faces) > cfg.simplify_nfaces:
        verts, faces = simplify_mesh(verts, faces, cfg.simplify_nfaces)
    if stats is not None:
        stats["faces"] = len(faces)
        stats["simplify_ms"] = (time.perf_counter() - t1) * 1e3
    return Mesh(verts, faces)
