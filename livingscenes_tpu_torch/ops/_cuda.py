"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `.cu` source in `livingscenes_tpu_torch/csrc` is compiled by its own
`nvcc` process, all started together, for `sm_90a`; the objects are linked
into one shared library with a plain C interface under
`livingscenes_tpu_torch/_build/` (listed in `.gitignore`). The library's name
carries a hash of every file under `csrc/` (the shared `.cuh` headers
included) and of the flags, so an edited source or header is rebuilt.
Nothing here runs at import time: the CPU tests import every module without
`nvcc`.

Each C entry launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fps.cu", "knn.cu", "icp_stats.cu", "knn_topk.cu", "layer0.cu",
           "mean_edge.cu", "attention.cu", "scale.cu", "sinkhorn.cu",
           "layer0_bwd.cu", "mean_edge_bwd.cu", "attention_bwd.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# FPS indices must equal the CPU's bit for bit: no fused multiply-add.
EXTRA = {"fps.cu": ["--fmad=false"]}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None
ptxas_report: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "lstpu_fps": [_P] * 5 + [_I] * 4 + [_P],
    "lstpu_knn": [_P] * 4 + [_I] * 6 + [_P],
    "lstpu_icp_stats": [_P] * 7 + [_I] * 3 + [_P],
    "lstpu_knn_topk": [_P, _P, _P, _I, _I, _I, _I, _P],
    "lstpu_layer0_edge_mean": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "lstpu_mean_products": [_P] * 7 + [_I] * 5 + [_P],
    "lstpu_edge_mean": [_P] * 4 + [_I] * 5 + [_F, _P],
    "lstpu_attention_products": [_P] * 8 + [_I] * 5 + [_P],
    "lstpu_edge_attention": [_P] * 5 + [_I] * 6 + [_F, _P],
    "lstpu_scale": [_P, _P, _I, _I, _I, _P],
    "lstpu_sinkhorn_plan": [_I] * 3 + [_P],
    "lstpu_sinkhorn": [_P] * 8 + [_I] * 4 + [_P],
    "lstpu_sinkhorn_bwd": [_P] * 12 + [_F] + [_I] * 3 + [_P],
    "lstpu_layer0_edge_mean_bwd": [_P] * 8 + [_I] * 4 + [_F, _P],
    "lstpu_layer0_bwd_blocks": [_I] * 3,
    "lstpu_edge_mean_bwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    "lstpu_mean_bwd_products": [_P] * 11 + [_I] * 5 + [_P],
    "lstpu_edge_attention_bwd": [_P] * 8 + [_I] * 6 + [_F, _P],
    "lstpu_attention_bwd_products": [_P] * 12 + [_I] * 5 + [_P],
    "lstpu_edge_bwd_splits": [_I] * 3,
    "lstpu_fps_tail_points": [_I, _I],
    "lstpu_knn_max_k": [],
    "lstpu_icp_stats_block": [],
    "lstpu_knn_topk_tile": [],
    "lstpu_knn_topk_max_top": [],
    "lstpu_scale_tile": [],
    "lstpu_scale_max_top": [],
    "lstpu_sinkhorn_bwd_rows": [],
    "lstpu_sinkhorn_max_schedule": [],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        name = path.relative_to(CSRC).as_posix()
        h.update(name.encode())
        h.update(path.read_bytes())
        h.update(" ".join(EXTRA.get(name, [])).encode())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the present sources and flags is built."""
    return BUILD_DIR / f"liblstpu_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. A library already built from the same sources is reused."""
    global build_seconds, ptxas_report
    so = library_path()
    if so.exists():
        return so
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{os.getpid()}.o"
        objs.append(obj)
        cmd = [nvcc, *ARCH, *FLAGS, *EXTRA.get(name, []), "-Xptxas", "-v",
               "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    reports, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        reports.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    ptxas_report = "\n".join(reports)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n{ptxas_report}"
        )
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, dtype=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype`."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
