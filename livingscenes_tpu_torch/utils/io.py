"""Host IO: PLY points and meshes, JSON, YAML and list files.

Counterpart of livingscenes_tpu/utils/io.py. The PLY reader takes ascii and
binary little-endian files with scalar vertex properties and uchar-count
face lists (3RScan's pointcloud.instances.align.ply, mesh ground truths).
YAML goes through the port's own reader of the subset configs use
(train/config.py `parse_yaml`; PyYAML is not a dependency).
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from ..train.config import parse_yaml

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_header(f):
    """(format, [(element name, count, properties)]) of a PLY header; a
    property is (name, dtype) or ("__list__", count dtype, index dtype,
    name)."""
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header has no end_header line")
        parts = line.decode("ascii", errors="replace").split()
        if parts == ["end_header"]:
            return fmt, elements
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("__list__", _PLY_DTYPES[parts[2]],
                                        _PLY_DTYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Vertices (V, 3) float32 and faces (F, 3) int64, or None without a
    face element."""
    verts = faces = None
    with open(path, "rb") as f:
        fmt, elements = _read_header(f)
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[0] for p in props]
                    arr = np.array(rows, dtype=np.float64)
                    verts = arr[:, [names.index(c) for c in "xyz"]].astype(np.float32)
                elif name == "face":
                    faces = np.array([r[1:4] for r in rows], dtype=np.int64)
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if name == "face":
                    cdt, idt = (np.dtype("<" + t) for t in props[0][1:3])
                    out = np.empty((count, 3), np.int64)
                    for i in range(count):
                        n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                        out[i] = np.frombuffer(f.read(idt.itemsize * n), idt)[:3]
                    faces = out
                    continue
                dtype = np.dtype([(p[0], "<" + p[1]) for p in props
                                  if p[0] != "__list__"])
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype)
                if name == "vertex":
                    verts = np.stack([data["x"], data["y"], data["z"]],
                                     axis=-1).astype(np.float32)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return verts, faces


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_yaml(path: str):
    with open(path) as f:
        return parse_yaml(f.read())


def read_list_from_txt(path: str) -> List[str]:
    """The file's non-empty lines, stripped."""
    with open(path) as f:
        return [line.strip() for line in f.read().splitlines() if line.strip()]
