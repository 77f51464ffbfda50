"""A host-side triangle mesh: vertices and faces as numpy arrays.

Counterpart of livingscenes_tpu/recon/mesh.py (`Mesh`), in numpy only: the
currency between extraction, simplification and export.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32/64
    faces: np.ndarray  # (F, 3) int

    @property
    def is_empty(self) -> bool:
        return len(self.vertices) == 0

    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy())

    def apply_transform(self, tsfm: np.ndarray) -> "Mesh":
        """In place, a 4 x 4 homogeneous transform."""
        self.vertices = self.vertices @ tsfm[:3, :3].T + tsfm[:3, 3]
        return self

    def apply_scale_translation(self, scale: float, translation) -> "Mesh":
        self.vertices = self.vertices * scale + np.asarray(translation)
        return self

    def face_areas(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def face_normals(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    def sample_surface(self, n: int, seed: int = 0, return_normals: bool = False):
        """n points drawn uniformly over the surface (faces by area, then a
        uniform barycentric point), from numpy's generator seeded with
        `seed`; with `return_normals` also each point's face normal."""
        if self.is_empty:
            pts = np.zeros((n, 3), self.vertices.dtype)
            if return_normals:
                return pts, np.zeros((n, 3), self.vertices.dtype)
            return pts
        rng = np.random.default_rng(seed)
        areas = self.face_areas()
        total = areas.sum()
        if total <= 0:
            probs = np.full(len(areas), 1.0 / len(areas))
        else:
            probs = areas / total
        fidx = rng.choice(len(self.faces), size=n, p=probs)
        u = rng.random((n, 1))
        v = rng.random((n, 1))
        flip = (u + v) > 1.0
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        tri = self.vertices[self.faces[fidx]]
        pts = tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])
        if return_normals:
            return pts, self.face_normals()[fidx]
        return pts

    def export_obj(self, path: str) -> None:
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in self.faces:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")

    def export_ply(self, path: str) -> None:
        """Binary little-endian PLY: float32 vertices, int32 faces."""
        with open(path, "wb") as f:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(self.vertices)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(self.faces)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            )
            f.write(header.encode())
            f.write(self.vertices.astype("<f4").tobytes())
            packed = np.empty(len(self.faces),
                              dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            packed["n"] = 3
            packed["idx"] = self.faces.astype("<i4")
            f.write(packed.tobytes())

    @staticmethod
    def placeholder_box(extent: float = 1.0) -> "Mesh":
        """A box of side `extent` around the origin, the stand-in for a
        failed extraction."""
        h = extent / 2.0
        verts = np.array(
            [[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
             [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],
            np.float32,
        )
        faces = np.array(
            [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
             [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
             [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
            np.int64,
        )
        return Mesh(verts, faces)
