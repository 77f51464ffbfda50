"""Phase profile of the host mesh simplification on analytic 129^3 grids
(host only: no card needed).

    python scripts/torch_profile_simplify.py [--n 8] [--target 5000] [--chamfer]

Counterpart of scripts/profile_simplify.py. Builds procedural shapes
(train/data.py SyntheticShapeDataset SDFs, the family the benchmark's
reconstructions mesh) as dense occupancy-logit-like 129^3 grids on the
host, extracts each through the port's native build (native/src/*.cpp) at
the production settings (MeshExtractorConfig: threshold 0.5, padding 0.1,
`--target` faces), and prints for each grid the isosurface and
simplification times, then their means. With LSTPU_SIMPLIFY_PROFILE=1 (set
unless the environment sets it) native/src/simplify.cpp writes each
simplification's phase split to stderr (init, run = prepass + seed + heap,
output). --chamfer adds each simplified mesh's chamfer to its raw mesh
(the quality gate of a simplifier change).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def make_grid(seed: int, n: int = 129, box: float = 1.1) -> np.ndarray:
    """An (n, n, n) float32 grid of -SDF (positive inside, like the
    decoder's logits) of the procedural shape of `seed`, over the cube of
    side `box` centred at the origin."""
    from livingscenes_tpu_torch.train.data import SyntheticShapeDataset

    ds = SyntheticShapeDataset(n_items=1, n_pcl=64)
    sdf = ds._shape_sdf(np.random.default_rng(seed))
    idx = np.linspace(-0.5 * box, 0.5 * box, n).astype(np.float32)
    pts = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), axis=-1).reshape(-1, 3)
    return (-sdf(pts)).astype(np.float32).reshape(n, n, n)


def chamfer_to_raw(mesh, raw_mesh, n: int = 30000, seed: int = 0) -> float:
    """Symmetric chamfer (the mean nearest-neighbour distance both ways)
    between surface samples of the simplified and the raw mesh."""
    from scipy.spatial import cKDTree

    a = mesh.sample_surface(n, seed=seed)
    b = raw_mesh.sample_surface(n, seed=seed + 1)
    return float(cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()) / 2


def profile_grid(grid: np.ndarray, target: int, chamfer: bool = False) -> dict:
    """The production extraction of one grid (extract_mesh_from_grid: the
    isosurface, then the simplification to `target` faces), timed: iso_ms,
    simplify_ms, total_ms, faces_raw, faces, mesh and, with `chamfer`, the
    chamfer of the mesh to the grid's raw (unsimplified) mesh."""
    from livingscenes_tpu_torch.recon.extractor import (
        MeshExtractorConfig, extract_mesh_from_grid)

    st = {}
    t0 = time.perf_counter()
    st["mesh"] = extract_mesh_from_grid(
        grid, MeshExtractorConfig(simplify_nfaces=target), stats=st)
    st["total_ms"] = (time.perf_counter() - t0) * 1e3
    if chamfer:
        raw = extract_mesh_from_grid(grid, MeshExtractorConfig(simplify_nfaces=None))
        st["chamfer"] = chamfer_to_raw(st["mesh"], raw)
    return st


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8, help="grids (seeds 100, 101, ...)")
    ap.add_argument("--target", type=int, default=5000, help="faces after simplification")
    ap.add_argument("--chamfer", action="store_true",
                    help="also report chamfer(simplified, raw) per grid")
    args = ap.parse_args(argv)
    # read once, at the native library's first simplification
    os.environ.setdefault("LSTPU_SIMPLIFY_PROFILE", "1")

    stats = []
    for i in range(args.n):
        st = profile_grid(make_grid(100 + i), args.target, args.chamfer)
        line = (f"grid {i}: total {st['total_ms']:.1f} ms (iso {st['iso_ms']:.1f}, "
                f"simplify {st['simplify_ms']:.1f}) "
                f"faces_raw {st['faces_raw']} -> {st['faces']}")
        if args.chamfer:
            line += f" chamfer {st['chamfer']:.5f}"
        print(line, flush=True)
        stats.append(st)

    def mean(key):
        return float(np.mean([s[key] for s in stats]))

    out = (f"\nmean: total {mean('total_ms'):.1f} ms, iso {mean('iso_ms'):.1f}, "
           f"simplify {mean('simplify_ms'):.1f}, faces_raw {mean('faces_raw'):.0f}")
    if args.chamfer:
        out += f", chamfer {mean('chamfer'):.5f}"
    print(out)
    return stats


if __name__ == "__main__":
    main()
