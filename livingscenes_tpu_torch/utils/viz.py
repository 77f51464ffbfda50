"""Visualization without a plotting library: PNG encoding and point-cloud,
mesh, matching and registration renders.

Counterpart of livingscenes_tpu/utils/viz.py (`write_png`,
`render_pointcloud_image`, `render_mesh_image`,
`visualize_shape_matching`, `visualize_registration`), in numpy over the
port's depth rasterizer (recon/render.py) and a minimal zlib PNG encoder;
the same inputs give the same bytes.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from ..recon.mesh import Mesh
from ..recon.render import Camera, look_at, render_depth

# A categorical palette (tab10-like) for instance coloring.
PALETTE = np.array(
    [
        [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
        [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
        [188, 189, 34], [23, 190, 207],
    ],
    np.uint8,
)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a (H, W) grayscale or (H, W, 3) RGB image as an 8-bit RGB PNG
    (other dtypes clipped to [0, 255])."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _auto_camera(points: np.ndarray, size: int = 400):
    center = points.mean(0)
    radius = max(float(np.linalg.norm(points - center, axis=-1).max()), 1e-6)
    eye = center + np.array([1.2, -1.6, 1.0]) / np.linalg.norm(
        [1.2, -1.6, 1.0]
    ) * radius * 2.6
    R, t = look_at(eye, center)
    cam = Camera(width=size, height=size, fx=size * 1.2, fy=size * 1.2)
    return R, t, cam


def render_pointcloud_image(
    points_list: Sequence[np.ndarray],
    colors: Optional[Sequence] = None,
    size: int = 400,
    point_px: int = 2,
) -> np.ndarray:
    """Z-buffered point splatting of one or more clouds (each its colour,
    default the palette's) -> (H, W, 3) uint8, white background."""
    all_pts = np.concatenate([np.asarray(p).reshape(-1, 3) for p in points_list])
    R, t, cam = _auto_camera(all_pts, size)
    img = np.full((cam.height, cam.width, 3), 255, np.uint8)
    zbuf = np.full((cam.height, cam.width), np.inf, np.float32)
    for i, pts in enumerate(points_list):
        color = (
            np.asarray(colors[i], np.uint8)
            if colors is not None
            else PALETTE[i % len(PALETTE)]
        )
        cpts = np.asarray(pts).reshape(-1, 3) @ R.T + t
        d = -cpts[:, 2]
        ok = d > 1e-6
        u = (cam.fx * cpts[ok, 0] / d[ok] + cam.cx).astype(int)
        v = (cam.cy - cam.fy * cpts[ok, 1] / d[ok]).astype(int)
        dd = d[ok]
        for du in range(point_px):
            for dv in range(point_px):
                uu = np.clip(u + du, 0, cam.width - 1)
                vv = np.clip(v + dv, 0, cam.height - 1)
                closer = dd < zbuf[vv, uu]
                zbuf[vv[closer], uu[closer]] = dd[closer]
                img[vv[closer], uu[closer]] = color
    return img


def render_mesh_image(mesh: Mesh, size: int = 400) -> np.ndarray:
    """Depth-shaded mesh render -> (H, W, 3) uint8."""
    if mesh.is_empty:
        return np.full((size, size, 3), 255, np.uint8)
    R, t, cam = _auto_camera(mesh.vertices, size)
    depth = render_depth(mesh, R, t, cam)
    img = np.full((size, size), 255, np.float32)
    hit = depth > 0
    if hit.any():
        d = depth[hit]
        lo, hi = d.min(), max(d.max(), d.min() + 1e-6)
        img[hit] = 60 + 160 * (d - lo) / (hi - lo)
    return np.repeat(img[..., None], 3, axis=-1).astype(np.uint8)


def visualize_shape_matching(
    ref_instances: List[np.ndarray],
    rescan_instances: List[np.ndarray],
    matches0: np.ndarray,
    size: int = 400,
) -> np.ndarray:
    """Side-by-side renders of two scenes' instances, matched ones sharing
    a colour and unmatched rescan instances grey."""
    gray = np.array([180, 180, 180], np.uint8)
    ref_colors = [PALETTE[i % len(PALETTE)] for i in range(len(ref_instances))]
    rescan_colors = [gray] * len(rescan_instances)
    for i, m in enumerate(np.asarray(matches0)):
        if 0 <= m < len(rescan_instances):
            rescan_colors[int(m)] = ref_colors[i]
    left = render_pointcloud_image(ref_instances, ref_colors, size)
    right = render_pointcloud_image(rescan_instances, rescan_colors, size)
    return np.concatenate([left, right], axis=1)


def visualize_registration(
    pc_src: np.ndarray,
    pc_tgt: np.ndarray,
    pred_tsfm: np.ndarray,
    gt_tsfm: Optional[np.ndarray] = None,
    size: int = 400,
) -> np.ndarray:
    """Registration panels side by side: [src | tgt], [pred(src) | tgt],
    and with gt_tsfm [gt(src) | tgt]."""
    src = np.asarray(pc_src).reshape(-1, 3)
    tgt = np.asarray(pc_tgt).reshape(-1, 3)

    def apply(tsfm, pts):
        t = np.asarray(tsfm)
        return pts @ t[:3, :3].T + t[:3, 3]

    panels = [
        render_pointcloud_image([src, tgt], size=size),
        render_pointcloud_image([apply(pred_tsfm, src), tgt], size=size),
    ]
    if gt_tsfm is not None:
        panels.append(
            render_pointcloud_image([apply(gt_tsfm, src), tgt], size=size)
        )
    return np.concatenate(panels, axis=1)
