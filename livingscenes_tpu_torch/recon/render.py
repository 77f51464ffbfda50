"""Depth rendering and back-projection, for making training data.

Counterpart of livingscenes_tpu/recon/render.py (`Camera`, `look_at`,
`render_depth`, `backproject_depth`, `render_partial_clouds`): host code in
numpy over the port's build of the same z-buffer rasterizer
(native/src/rasterize.cpp). It renders depth maps of a mesh from sampled
viewpoints and back-projects them into partial point clouds, the dep_pcl_*
inputs of the production training config (`input_mode: dep`). The same
inputs and seed give the JAX module's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..native.bindings import get_lib
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int = 240
    height: int = 240
    fx: float = 240.0
    fy: float = 240.0

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """World-to-camera (R, t) of a camera at `eye` looking at `target`; the
    camera looks down -z with y up."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    R_w2c = np.stack([right, true_up, -fwd])  # rows
    t_w2c = -R_w2c @ eye
    return R_w2c, t_w2c


def render_depth(mesh: Mesh, R_w2c: np.ndarray, t_w2c: np.ndarray,
                 camera: Camera = Camera()) -> np.ndarray:
    """Depth image (h, w) float32 of the mesh seen from (R_w2c, t_w2c); 0
    where no surface is hit."""
    cam_verts = (mesh.vertices @ R_w2c.T + t_w2c).astype(np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int64)
    depth = np.empty((camera.height, camera.width), np.float32)
    get_lib().rasterize_depth(
        np.ascontiguousarray(cam_verts), len(cam_verts), faces, len(faces),
        camera.fx, camera.fy, camera.cx, camera.cy,
        camera.width, camera.height, depth,
    )
    return depth


def backproject_depth(depth: np.ndarray, R_w2c: np.ndarray, t_w2c: np.ndarray,
                      camera: Camera = Camera()) -> np.ndarray:
    """The world-space points (N, 3) of a depth image's hit pixels."""
    v, u = np.nonzero(depth > 0)
    z = depth[v, u]
    x = (u + 0.5 - camera.cx) / camera.fx * z
    y = (camera.cy - (v + 0.5)) / camera.fy * z
    cam_pts = np.stack([x, y, -z], axis=-1)
    return (cam_pts - t_w2c) @ R_w2c


def render_partial_clouds(mesh: Mesh, n_views: int = 12, camera: Camera = Camera(),
                          radius_range: Tuple[float, float] = (1.6, 2.4),
                          seed: int = 0,
                          max_points_per_view: Optional[int] = 4096
                          ) -> List[np.ndarray]:
    """One partial cloud (float32) per view: viewpoints on a sphere around
    the mesh's vertex mean at a radius in `radius_range`, drawn from numpy's
    generator seeded with `seed`; each view's depth is rendered and
    back-projected, and a view of more than `max_points_per_view` points is
    subsampled without replacement."""
    rng = np.random.default_rng(seed)
    center = mesh.vertices.mean(0)
    clouds = []
    for _ in range(n_views):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        r = rng.uniform(*radius_range)
        R, t = look_at(center + d * r, center)
        pts = backproject_depth(render_depth(mesh, R, t, camera), R, t, camera)
        if max_points_per_view and len(pts) > max_points_per_view:
            pts = pts[rng.choice(len(pts), max_points_per_view, replace=False)]
        clouds.append(pts.astype(np.float32))
    return clouds
