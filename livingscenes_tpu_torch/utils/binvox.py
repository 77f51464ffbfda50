"""The binvox voxel-grid format (ShapeNet's voxelizations), read and
written in numpy.

Counterpart of livingscenes_tpu/utils/binvox.py (`VoxelGrid`,
`read_binvox`, `write_binvox`), byte for byte: a text header (dim,
translate, scale), then run-length (value, count) byte pairs in x-major
order, z before y within an x slab, runs of at most 255.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VoxelGrid:
    data: np.ndarray  # (nx, ny, nz) bool
    translate: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0

    @property
    def resolution(self):
        return self.data.shape


def read_binvox(path: str) -> VoxelGrid:
    with open(path, "rb") as f:
        if not f.readline().strip().startswith(b"#binvox"):
            raise ValueError(f"{path}: not a binvox file")
        dims, translate, scale = None, (0.0, 0.0, 0.0), 1.0
        while True:
            line = f.readline().strip()
            if line.startswith(b"data"):
                break
            tok = line.split()
            if tok[0] == b"dim":
                dims = tuple(int(x) for x in tok[1:4])
            elif tok[0] == b"translate":
                translate = tuple(float(x) for x in tok[1:4])
            elif tok[0] == b"scale":
                scale = float(tok[1])
        raw = np.frombuffer(f.read(), np.uint8)
    flat = np.repeat(raw[0::2].astype(bool), raw[1::2])
    # the stored order: index = x * (nz * ny) + z * ny + y
    nx, ny, nz = dims
    grid = flat.reshape(nx, nz, ny).transpose(0, 2, 1)
    return VoxelGrid(np.ascontiguousarray(grid), translate, scale)


def write_binvox(path: str, grid: VoxelGrid) -> None:
    nx, ny, nz = grid.data.shape
    flat = np.ascontiguousarray(grid.data.transpose(0, 2, 1)).reshape(-1).astype(np.uint8)
    # (value, run) pairs: a run ends where the value changes or at 255
    out = bytearray()
    if len(flat):
        change = np.flatnonzero(np.diff(flat)) + 1
        starts = np.concatenate([[0], change])
        lengths = np.diff(np.concatenate([starts, [len(flat)]]))
        for value, length in zip(flat[starts].tolist(), lengths.tolist()):
            while length > 0:
                run = min(length, 255)
                out += bytes((value, run))
                length -= run
    with open(path, "wb") as f:
        f.write(b"#binvox 1\n")
        f.write(f"dim {nx} {ny} {nz}\n".encode())
        f.write(("translate %g %g %g\n" % tuple(grid.translate)).encode())
        f.write(f"scale {grid.scale:g}\n".encode())
        f.write(b"data\n")
        f.write(bytes(out))
