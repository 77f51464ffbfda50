"""From codes to meshes: occupancy-logit grids on the device, then the host
meshing (isosurface extraction and quadric simplification in C++,
native/bindings.py).

Counterpart of livingscenes_tpu/recon/extractor.py (`MeshExtractorConfig`,
`MeshExtractor`, `refine_mesh_vertices`, `extract_mesh_from_grid`). With
`refinement_step > 0` (0 in every shipped configuration) each mesh's
vertices are refined by gradient steps in the canonical frame, before its
scale and translation are applied.
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
    # gradient steps of vertex refinement a mesh (refine_mesh_vertices)
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
    are evaluated on the codes' device. With `mesh` (a DeviceMesh,
    parallel/sharding.py) the grid queries are sharded over its
    `shard_axis`: each rank decodes 1/n of every level's points, and every
    rank gets the whole grid (a mesh of size 1 runs unsharded)."""

    def __init__(self, occupancy_logits_fn: Callable[[torch.Tensor, Codes], torch.Tensor],
                 config: MeshExtractorConfig = MeshExtractorConfig(),
                 mesh=None, shard_axis: str = "qp"):
        self.config = config
        self.mesh = mesh
        self.shard_axis = shard_axis
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
                mesh=self.mesh,
                shard_axis=self.shard_axis,
            )
            return values, stats["overflow"]
        values = dense_grid_values(
            decode_one, resolution=cfg.final_resolution, box_size=cfg.box_size,
            chunk_size=cfg.points_batch_size, device=device, mesh=self.mesh,
            shard_axis=self.shard_axis)
        return values, torch.zeros((0,), dtype=torch.int32, device=device)

    def extract_from_grid(self, value_grid: np.ndarray) -> Mesh:
        """Host: padded isosurface extraction, rescale, simplification."""
        return extract_mesh_from_grid(value_grid, self.config)

    def generate_from_codes(self, codes: Codes,
                            refine_eps: Optional[torch.Tensor] = None) -> Mesh:
        """Mesh one instance: the grid of its canonical code (s = 1,
        t = 0), with `refinement_step > 0` its vertices refined against the
        same code (`refine_eps`: the barycentric draws, see
        refine_mesh_vertices), then its scale and translation applied to
        the mesh."""
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
        if mesh.is_empty:
            return mesh
        cfg = self.config
        if cfg.refinement_step > 0:
            mesh.vertices = refine_mesh_vertices(
                self._logits_fn, canonical, mesh.vertices, mesh.faces,
                n_steps=cfg.refinement_step, threshold=cfg.threshold,
                lr=cfg.refinement_lr, eps=refine_eps).cpu().numpy()
        mesh.apply_scale_translation(scale, center)
        return mesh

    def generate_batch(self, codes: Codes) -> List[Mesh]:
        """Mesh every instance of a batch of codes, one after another."""
        from ..models.shape_prior import slice_codes

        return [self.generate_from_codes(slice_codes(codes, i))
                for i in range(codes["s"].shape[0])]


RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8


def dirichlet_draws(generator: torch.Generator, n_steps: int, n_faces: int
                    ) -> torch.Tensor:
    """(n_steps, n_faces, 3) float32 draws of Dirichlet(0.5, 0.5, 0.5), on
    the generator's device. A Gamma(1/2) variate is Z^2 / 2 for a standard
    normal Z, and the Dirichlet normalises three of them, so each draw is
    Z_i^2 / (Z_1^2 + Z_2^2 + Z_3^2)."""
    z2 = torch.randn((n_steps, n_faces, 3), generator=generator,
                     device=generator.device) ** 2
    return z2 / torch.sum(z2, dim=-1, keepdim=True)


def refinement_loss(value_of, v: torch.Tensor, faces: torch.Tensor,
                    eps: torch.Tensor, threshold: float) -> torch.Tensor:
    """The refinement's objective at vertices v (V, 3): one barycentric
    point p per face (eps (F, 3)), mean((value_of(p) - threshold)^2) +
    0.01 * mean(|n - t|^2), n the unit face normal and t the unit negated
    gradient of value_of at p, which is not detached: differentiating the
    objective differentiates through the field's gradient."""
    face_vertex = v[faces]  # (F, 3, 3)
    face_point = torch.sum(face_vertex * eps[:, :, None], dim=1)
    normal = torch.cross(face_vertex[:, 1] - face_vertex[:, 0],
                         face_vertex[:, 2] - face_vertex[:, 1], dim=-1)
    normal = normal / (torch.linalg.norm(normal, dim=1, keepdim=True) + 1e-10)
    face_value = value_of(face_point)
    (grad_p,) = torch.autograd.grad(face_value.sum(), face_point, create_graph=True)
    target = -grad_p / (torch.linalg.norm(grad_p, dim=1, keepdim=True) + 1e-10)
    return (torch.mean((face_value - threshold) ** 2)
            + 0.01 * torch.mean(torch.sum((normal - target) ** 2, dim=1)))


def rmsprop_step(v: torch.Tensor, g: torch.Tensor, nu: torch.Tensor, lr: float):
    """One step of optax 0.2.6's rmsprop(lr) (decay 0.9, eps 1e-8 inside
    the square root, no momentum, no bias correction): returns (v, nu)."""
    nu = (1.0 - RMSPROP_DECAY) * g ** 2 + RMSPROP_DECAY * nu
    return v + -lr * (torch.rsqrt(nu + RMSPROP_EPS) * g), nu


def refine_mesh_vertices(occupancy_logits_fn, codes: Codes, vertices, faces,
                         n_steps: int, threshold: float = 0.5, lr: float = 1e-4,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Gradient-based vertex refinement (the reference's
    mesh_extractor2.py:245-302); returns the refined (V, 3) float32
    vertices on the codes' device.

    Each step pulls the occupancy probability sigmoid(logit) at one
    barycentric point per face toward `threshold` and aligns the face
    normals with the field's (refinement_loss), with the draws eps[step]
    (F, 3); the gradient is taken with respect to the vertices only, so no
    parameter collects a .grad, and the vertices move by rmsprop_step from
    nu = 0.

    The draws: `eps` (n_steps, F, 3), e.g. JAX's own; else all drawn up
    front from `generator` (dirichlet_draws); with neither, from a new CPU
    generator seeded with 0 (not JAX's PRNGKey(0) stream). Grad mode is
    switched on here, so callers may run under torch.no_grad(); codes made
    under inference mode are cloned out of it."""
    device = codes["s"].device
    f = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)
    if eps is None:
        generator = generator or torch.Generator().manual_seed(0)
        eps = dirichlet_draws(generator, n_steps, f.shape[0])
    eps = torch.as_tensor(eps, dtype=torch.float32).to(device)
    with torch.inference_mode(False):
        codes = {k: v.detach().clone() for k, v in codes.items()}
        v = torch.as_tensor(np.asarray(vertices), dtype=torch.float32).to(device)
    nu = torch.zeros_like(v)

    def value_of(p):
        return torch.sigmoid(occupancy_logits_fn(p[None], codes)[0])

    with torch.enable_grad():
        for step in range(n_steps):
            v = v.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                refinement_loss(value_of, v, f, eps[step], threshold), v)
            with torch.no_grad():
                v, nu = rmsprop_step(v, g, nu, lr)
    return v.detach()


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
