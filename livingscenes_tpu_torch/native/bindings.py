"""ctypes bindings of the port's host geometry library.

Counterpart of livingscenes_tpu/native/bindings.py (`marching_isosurface`,
`simplify_mesh`, `KDTree`, `check_mesh_contains`, `voxelize_mesh`, and the
depth rasterizer that recon/render.py calls), from
copies of its C++ sources in `src/`, which use the standard library only.
The library is compiled with `g++` at the first call into
`livingscenes_tpu_torch/_build/` (listed in `.gitignore`), under a name
that carries a hash of the sources, the flags and the host (the flags
include `-march=native`); it is written to a temporary name and moved into
place, so that processes that build at once do not read a half-written
file. Importing this module builds and loads nothing. Without `g++` the
first call raises.

The flags are the JAX package's Makefile's less `-fopenmp`, which a g++
without libgomp refuses: the kd-tree and point-in-mesh queries, whose loops
carry OpenMP directives, are instead split into contiguous chunks that
Python threads pass to the library at once (ctypes lets go of the GIL
during a call). Each query is independent of the others, so the results
are those of one call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = _PKG / "_build"
SOURCES = ("isosurface.cpp", "simplify.cpp", "kdtree.cpp", "inside_mesh.cpp",
           "voxelize.cpp", "rasterize.cpp")
FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
QUERY_CHUNK = 2048  # queries a thread takes at a time, at the least


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host meshing library is built "
                           "with it (set CXX or put g++ on PATH)")
    return cxx


def library_path() -> Path:
    """Where the library of the present sources, flags and host is built."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"liblstpu_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library; returns its path. A
    library already built from the same sources on this host is reused."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *FLAGS, "-shared", "-o", str(tmp),
           *(str(SRC / name) for name in SOURCES)]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host meshing library failed:\n"
                           f"{' '.join(cmd)}\n{out.stdout}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

            lib.isosurface_extract.restype = ctypes.c_void_p
            lib.isosurface_extract.argtypes = [f32p, i64, i64, i64, ctypes.c_float]
            lib.iso_num_vertices.restype = i64
            lib.iso_num_vertices.argtypes = [ctypes.c_void_p]
            lib.iso_num_triangles.restype = i64
            lib.iso_num_triangles.argtypes = [ctypes.c_void_p]
            lib.iso_copy.restype = None
            lib.iso_copy.argtypes = [ctypes.c_void_p, f32p, i64p]
            lib.iso_free.restype = None
            lib.iso_free.argtypes = [ctypes.c_void_p]

            lib.simplify_mesh.restype = ctypes.c_void_p
            lib.simplify_mesh.argtypes = [f32p, i64, i64p, i64, i64, ctypes.c_double]
            lib.simplify_num_vertices.restype = i64
            lib.simplify_num_vertices.argtypes = [ctypes.c_void_p]
            lib.simplify_num_triangles.restype = i64
            lib.simplify_num_triangles.argtypes = [ctypes.c_void_p]
            lib.simplify_copy.restype = None
            lib.simplify_copy.argtypes = [ctypes.c_void_p, f32p, i64p]
            lib.simplify_free.restype = None
            lib.simplify_free.argtypes = [ctypes.c_void_p]

            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.kdtree_build.restype = ctypes.c_void_p
            lib.kdtree_build.argtypes = [f32p, i64]
            lib.kdtree_query.restype = None
            lib.kdtree_query.argtypes = [ctypes.c_void_p, f32p, i64, f32p, i32p]
            lib.kdtree_query_k.restype = None
            lib.kdtree_query_k.argtypes = [ctypes.c_void_p, f32p, i64,
                                           ctypes.c_int32, f32p, i32p]
            lib.kdtree_free.restype = None
            lib.kdtree_free.argtypes = [ctypes.c_void_p]

            lib.voxelize_mesh.restype = None
            lib.voxelize_mesh.argtypes = [f32p, i64, i64p, i64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, u8p]

            lib.inside_mesh_build.restype = ctypes.c_void_p
            lib.inside_mesh_build.argtypes = [f32p, i64, i64p, i64, ctypes.c_int]
            lib.inside_mesh_query.restype = None
            lib.inside_mesh_query.argtypes = [ctypes.c_void_p, f32p, i64, u8p]
            lib.inside_mesh_free.restype = None
            lib.inside_mesh_free.argtypes = [ctypes.c_void_p]

            c_float, c_int = ctypes.c_float, ctypes.c_int
            lib.rasterize_depth.restype = None
            lib.rasterize_depth.argtypes = [f32p, i64, i64p, i64, c_float, c_float,
                                            c_float, c_float, c_int, c_int, f32p]
            _lib = lib
    return _lib


def marching_isosurface(values: np.ndarray, isovalue: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The isosurface of a dense (nx, ny, nz) grid: (verts (V, 3) float32 in
    grid-index coordinates, faces (F, 3) int64)."""
    lib = get_lib()
    v = np.ascontiguousarray(values, np.float32)
    if v.ndim != 3:
        raise ValueError(f"marching_isosurface: expected a 3-D grid, got {v.shape}")
    handle = lib.isosurface_extract(v, *v.shape, float(isovalue))
    try:
        nv = lib.iso_num_vertices(handle)
        nt = lib.iso_num_triangles(handle)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int64)
        if nv:
            lib.iso_copy(handle, verts, tris)
        return verts, tris
    finally:
        lib.iso_free(handle)


def simplify_mesh(verts: np.ndarray, faces: np.ndarray, target_faces: int,
                  aggressiveness: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse simplification to about `target_faces`.
    `aggressiveness` sets where the quantile-threshold sweeps hand over to
    the exact greedy heap, at (1 + 15 / aggressiveness) x target_faces."""
    lib = get_lib()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"simplify_mesh: expected (V, 3) and (F, 3), got "
                         f"{v.shape} and {f.shape}")
    handle = lib.simplify_mesh(v, len(v), f, len(f), int(target_faces),
                               float(aggressiveness))
    try:
        nv = lib.simplify_num_vertices(handle)
        nt = lib.simplify_num_triangles(handle)
        out_v = np.empty((nv, 3), np.float32)
        out_f = np.empty((nt, 3), np.int64)
        if nv:
            lib.simplify_copy(handle, out_v, out_f)
        return out_v, out_f
    finally:
        lib.simplify_free(handle)


def _in_chunks(fn, n: int) -> None:
    """fn(a, b) over contiguous chunks [a, b) of range(n), on threads."""
    workers = min(len(os.sched_getaffinity(0)), max(1, n // QUERY_CHUNK))
    if workers <= 1:
        fn(0, n)
        return
    bounds = [n * i // workers for i in range(workers + 1)]
    with ThreadPoolExecutor(workers, thread_name_prefix="lstpu-native") as pool:
        list(pool.map(fn, bounds[:-1], bounds[1:]))


class KDTree:
    """Nearest-neighbour queries against a fixed set of 3-D points."""

    def __init__(self, points: np.ndarray):
        self._lib = get_lib()
        self._pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        self._handle = self._lib.kdtree_build(self._pts, len(self._pts))

    def query(self, queries: np.ndarray, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(dist, idx) of the k nearest points of each query, ascending:
        (m,) arrays for k = 1, (m, k) otherwise (slots past the point count
        hold inf and -1)."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        if k == 1:
            dist = np.empty(len(q), np.float32)
            idx = np.empty(len(q), np.int32)
            _in_chunks(lambda a, b: self._lib.kdtree_query(
                self._handle, q[a:b], b - a, dist[a:b], idx[a:b]), len(q))
            return dist, idx
        dist = np.empty((len(q), k), np.float32)
        idx = np.empty((len(q), k), np.int32)
        _in_chunks(lambda a, b: self._lib.kdtree_query_k(
            self._handle, q[a:b], b - a, int(k), dist[a:b], idx[a:b]), len(q))
        return dist, idx

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None


def check_mesh_contains(verts: np.ndarray, faces: np.ndarray, queries: np.ndarray,
                        resolution: int = 128) -> np.ndarray:
    """(m,) bool: whether each query point lies inside the closed mesh (the
    parity of a +z ray's crossings, over a `resolution`^2 bucket grid of the
    triangles)."""
    lib = get_lib()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    q = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
    handle = lib.inside_mesh_build(v, len(v), f, len(f), int(resolution))
    try:
        out = np.empty(len(q), np.uint8)
        _in_chunks(lambda a, b: lib.inside_mesh_query(handle, q[a:b], b - a, out[a:b]),
                   len(q))
        return out.astype(bool)
    finally:
        lib.inside_mesh_free(handle)


def voxelize_mesh(verts: np.ndarray, faces: np.ndarray, resolution: int) -> np.ndarray:
    """(res, res, res) bool surface voxelization by triangle-box overlap,
    the vertices mapped onto the grid over their bounding box."""
    lib = get_lib()
    v = np.asarray(verts, np.float32)
    lo = v.min(0)
    extent = max(float((v.max(0) - lo).max()), 1e-9)
    grid_v = np.ascontiguousarray((v - lo) / extent * resolution, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    occ = np.zeros((resolution, resolution, resolution), np.uint8)
    lib.voxelize_mesh(grid_v, len(grid_v), f, len(f), resolution, resolution,
                      resolution, occ)
    return occ.astype(bool)
