"""Training data from watertight meshes: the on-disk layout that
train/data.py ShapeNetSDFDataset reads.

Counterpart of livingscenes_tpu/tools/preprocess.py (`normalize_mesh`,
`compute_sdf`, `preprocess_mesh`, `main`), in numpy over the port's native
library. For one mesh, normalized into the extraction cube, it writes

* pointcloud.npz: surface samples (`points`);
* points_uni.npz: uniform samples of the box and their signed distances
  (`points`, `sdf`): the distance to surface samples by the kd-tree, the
  sign by the point-in-mesh test, negative inside;
* points_nss.npz: near-surface samples and their signed distances;
* dep_pcl_<i>.npz: one depth-rendered partial cloud a view (`pcl`).

The same mesh and seed give the JAX tool's arrays. Usage:

    python -m livingscenes_tpu_torch.tools.preprocess --mesh chair.ply \\
        --out data/shapenet/03001627/chair0 --views 12
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..native.bindings import KDTree, check_mesh_contains
from ..recon.mesh import Mesh
from ..recon.render import Camera, render_partial_clouds
from ..utils.io import load_ply


def normalize_mesh(mesh: Mesh, padding: float = 0.1) -> Mesh:
    """A copy of the mesh centred on its bounding box and scaled so that
    its longest side is 1 / (1 + padding): inside [-0.5, 0.5], the
    canonical frame the decoder is trained in."""
    lo = mesh.vertices.min(0)
    hi = mesh.vertices.max(0)
    center = (lo + hi) / 2.0
    scale = (hi - lo).max() * (1.0 + padding)
    out = mesh.copy()
    out.vertices = (out.vertices - center) / scale
    return out


def compute_sdf(mesh: Mesh, queries: np.ndarray, n_surface: int = 100000,
                seed: int = 0) -> np.ndarray:
    """Signed distances (float32) of the queries: the distance to the
    nearest of `n_surface` surface samples, negative inside the mesh."""
    surf = mesh.sample_surface(n_surface, seed=seed).astype(np.float32)
    dist, _ = KDTree(surf).query(queries.astype(np.float32))
    inside = check_mesh_contains(mesh.vertices.astype(np.float32),
                                 mesh.faces.astype(np.int64),
                                 queries.astype(np.float32))
    return np.where(inside, -dist, dist).astype(np.float32)


def preprocess_mesh(mesh: Mesh, out_dir: str, n_pointcloud: int = 30000,
                    n_uni: int = 100000, n_nss: int = 100000, nss_std: float = 0.05,
                    n_views: int = 12, camera: Optional[Camera] = None,
                    seed: int = 0, normalize: bool = True) -> None:
    """Write one object's directory of the training layout (see the module
    docstring); every draw comes from numpy generators seeded with `seed`."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    if normalize:
        mesh = normalize_mesh(mesh)

    surface = mesh.sample_surface(n_pointcloud, seed=seed).astype(np.float32)
    np.savez(os.path.join(out_dir, "pointcloud.npz"), points=surface)

    uni = rng.uniform(-0.55, 0.55, (n_uni, 3)).astype(np.float32)
    np.savez(os.path.join(out_dir, "points_uni.npz"), points=uni,
             sdf=compute_sdf(mesh, uni, seed=seed))

    nss = surface[rng.choice(len(surface), n_nss)] + rng.normal(
        0, nss_std, (n_nss, 3)).astype(np.float32)
    nss = nss.astype(np.float32)
    np.savez(os.path.join(out_dir, "points_nss.npz"), points=nss,
             sdf=compute_sdf(mesh, nss, seed=seed + 1))

    clouds = render_partial_clouds(mesh, n_views=n_views,
                                   camera=camera or Camera(), seed=seed)
    for i, pcl in enumerate(clouds):
        np.savez(os.path.join(out_dir, f"dep_pcl_{i}.npz"), pcl=pcl)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh", required=True, help="watertight PLY mesh")
    parser.add_argument("--out", required=True, help="the object's directory")
    parser.add_argument("--views", type=int, default=12)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    v, f = load_ply(args.mesh)
    if f is None:
        raise ValueError(f"{args.mesh}: the PLY file holds no faces")
    preprocess_mesh(Mesh(v, f), args.out, n_views=args.views, seed=args.seed)


if __name__ == "__main__":
    main()
