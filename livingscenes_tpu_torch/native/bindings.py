"""ctypes bindings of the port's host meshing library.

Counterpart of livingscenes_tpu/native/bindings.py (`marching_isosurface`,
`simplify_mesh`), from copies of its two C++ sources in `src/`, which use
the standard library only. The library is compiled with `g++` at the first
call into `livingscenes_tpu_torch/_build/` (listed in `.gitignore`), under a
name that carries a hash of the sources, the flags and the host (the flags
include `-march=native`); it is written to a temporary name and moved into
place, so that processes that build at once do not read a half-written
file. Importing this module builds and loads nothing. Without `g++` the
first call raises.

The flags are the JAX package's Makefile's less `-fopenmp`: the two
sources have no OpenMP directive, so it changes no code, and a g++ without
libgomp refuses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = _PKG / "_build"
SOURCES = ("isosurface.cpp", "simplify.cpp")
FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


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
