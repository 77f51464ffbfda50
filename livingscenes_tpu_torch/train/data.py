"""Training data: the procedural shape dataset, the preprocessed ShapeNet
layout, their augmentations, and the host batch iterators.

A copy of livingscenes_tpu/train/data.py (numpy only; the port imports
nothing of the JAX package): `AugmentConfig`, `SamplingAugConfig`,
`sampling_with_aug_s1`, the scene-simulation and SIM(3) augmentations, the
SDF primitives, `SyntheticShapeDataset`, `ShapeNetSDFDataset` and
`batch_iterator` / `prefetch_iterator`. Every random draw is the JAX
module's, in the same order, so the same seed gives bit-equal arrays
(tests/test_torch_port_data.py, tests/test_torch_train_shapenet.py). The
synthetic RAM cache builds items in worker processes started with `spawn`;
the ShapeNet one loads the npz payloads on threads.
"""
from __future__ import annotations

import csv
import dataclasses
import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Augmentations (shapenet_new2.py:555-844 re-designed in vectorized numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Knobs mirror configs/3rscan/dgcnn_attn_inner.yaml:83-103."""

    use_augmentation: bool = True
    aug_ratio: float = 0.6

    random_object_prob: float = 0.7
    random_object_radius: float = 0.15
    random_object_radius_std: float = 0.07
    random_object_center_near_surface: bool = True
    random_object_center_L: float = 0.15
    random_object_scale: tuple = (0.5, 1.5)

    random_plane_prob: float = 0.5
    random_plane_vertical_prob: float = 0.5
    random_plane_vertical_scale: tuple = (0.05, 0.5)
    random_plane_vertical_height_range: tuple = (0.4, 1.0)
    random_plane_vertical_horizon_range: tuple = (0.4, 0.5)
    random_plane_ground_scale: tuple = (0.4, 1.0)
    random_plane_ground_range: float = 0.2

    random_ball_removal_prob: float = 0.6
    random_ball_removal_max_k: int = 50
    random_ball_removal_noise_std: float = 0.05


@dataclasses.dataclass(frozen=True)
class SamplingAugConfig:
    """s1 sampling-density augmentation (shapenet_new2.py:433-549):
    resample the input cloud with spatially non-uniform density — mixed
    uniform / gaussian-hole / half-space modes — then randomly shrink and
    re-duplicate. The reference gates this behind
    `use_sampling_augmentation` (off in every shipped config, no published
    values); defaults here are moderate versions of its knobs."""

    mixing_prob: float = 0.5
    mixing_mode_ratio: tuple = (1.0, 1.0, 1.0)  # uniform/gaussian/halfspace
    single_mode_ratio: tuple = (1.0, 1.0, 1.0)
    sampling_range: tuple = (0.3, 1.0)  # shrink-then-duplicate fraction
    gaussian_num_range: tuple = (1, 4)
    gaussian_std_range: tuple = (0.05, 0.25)
    gaussian_nss_range: tuple = (0.0, 0.15)
    halfspace_num_range: tuple = (1, 3)
    halfspace_difference_range: tuple = (0.3, 1.0)


def _uniform_sampling(pcl, n, rng):
    return pcl[rng.choice(len(pcl), n, replace=True)]


def _weighted_sampling(pcl, weight, n, rng):
    s = weight.sum()
    if s <= 0:
        return _uniform_sampling(pcl, n, rng)
    p = weight / s
    # torch.multinomial samples WITHOUT replacement by default
    # (shapenet_new2.py weighted_sampling) — mirror that whenever enough
    # positive-weight points exist, else fall back to replacement.
    if n <= np.count_nonzero(p):
        return pcl[rng.choice(len(pcl), n, replace=False, p=p)]
    return pcl[rng.choice(len(pcl), n, replace=True, p=p)]


def _gaussian_hole_sampling(pcl, n, rng, cfg: SamplingAugConfig):
    """Density holes around random anchors (shapenet_new2.py:503-532)."""
    k = rng.integers(cfg.gaussian_num_range[0], cfg.gaussian_num_range[1] + 1)
    anchor = _uniform_sampling(pcl, k, rng)
    direction = rng.normal(size=(k, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True) + 1e-8
    mu = anchor + rng.uniform(*cfg.gaussian_nss_range, k)[:, None] * direction
    std = rng.uniform(*cfg.gaussian_std_range, k)
    var = std**2
    dist = np.linalg.norm(pcl[None] - mu[:, None], axis=-1)  # (K, N)
    prob = np.exp(-(dist**2) / (2 * var[:, None])) / np.sqrt(
        2 * np.pi * var[:, None]
    )
    weight = np.clip(1.0 - prob.sum(0), 0.0, 1.0)
    return _weighted_sampling(pcl, weight, n, rng)


def _half_space_sampling(pcl, n, rng, cfg: SamplingAugConfig):
    """Density drop on random half-spaces (shapenet_new2.py:534-549)."""
    k = rng.integers(
        cfg.halfspace_num_range[0], cfg.halfspace_num_range[1] + 1
    )
    anchor = _uniform_sampling(pcl, k, rng)
    direction = rng.normal(size=(k, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True) + 1e-8
    inner = np.einsum("knj,kj->kn", pcl[None] - anchor[:, None], direction)
    reduce = rng.uniform(*cfg.halfspace_difference_range, k)
    decrease = ((inner < 0) * reduce[:, None]).sum(0)
    weight = np.clip(1.0 - decrease, 0.0, 1.0)
    return _weighted_sampling(pcl, weight, n, rng)


def sampling_with_aug_s1(
    pcl: np.ndarray, n: int, rng: np.random.Generator, cfg: SamplingAugConfig
) -> np.ndarray:
    """Select n input points with the s1 density augmentation
    (shapenet_new2.py:452-485)."""
    if rng.random() < cfg.mixing_prob:
        seed = rng.random(3) * np.asarray(cfg.mixing_mode_ratio)
        ratio = seed / (seed.sum() + 1e-8)
        n_uni = int(n * ratio[0])
        n_gauss = int(n * ratio[1])
        n_half = n - n_uni - n_gauss
        parts = []
        if n_uni > 0:
            parts.append(_uniform_sampling(pcl, n_uni, rng))
        if n_gauss > 0:
            parts.append(_gaussian_hole_sampling(pcl, n_gauss, rng, cfg))
        if n_half > 0:
            parts.append(_half_space_sampling(pcl, n_half, rng, cfg))
        sampled = np.concatenate([np.atleast_2d(p) for p in parts], 0)
    else:
        cum = np.cumsum(
            np.asarray(cfg.single_mode_ratio)
            / np.sum(cfg.single_mode_ratio)
        )
        seed = rng.random()
        if seed < cum[0]:
            sampled = _uniform_sampling(pcl, n, rng)
        elif seed > cum[1]:
            sampled = _half_space_sampling(pcl, n, rng, cfg)
        else:
            sampled = _gaussian_hole_sampling(pcl, n, rng, cfg)
    # shrink then re-duplicate (simulates low-res scans / repeated points)
    m = min(int(rng.uniform(*cfg.sampling_range) * n), n)
    sampled = _uniform_sampling(sampled, max(m, 1), rng)
    return _uniform_sampling(sampled, n, rng)


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def augment_scene_sim(
    pcl: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig
) -> np.ndarray:
    """Clutter simulation on an input cloud (N, 3): replaces a subset of the
    points with outlier blobs / planes, removes balls of points (keeping N
    fixed by resampling survivors)."""
    n = len(pcl)
    out = pcl.copy()

    # --- ball removal: delete points near a few random centers, then pad by
    # resampling survivors with jitter (shapenet_new2.py ball removal aug)
    if rng.random() < cfg.random_ball_removal_prob:
        k = rng.integers(1, 4)
        keep = np.ones(n, bool)
        for _ in range(k):
            center = out[rng.integers(0, n)]
            r = abs(rng.normal(0, cfg.random_ball_removal_noise_std)) + 0.02
            keep &= np.linalg.norm(out - center, axis=-1) > r
        if keep.sum() >= 32:
            survivors = out[keep]
            pad_idx = rng.integers(0, len(survivors), n - len(survivors))
            pad = survivors[pad_idx] + rng.normal(
                0, 0.002, (n - len(survivors), 3)
            )
            out = np.concatenate([survivors, pad])

    # --- outlier object: a random blob overwrite of a point subset
    if rng.random() < cfg.random_object_prob:
        m = int(n * rng.uniform(0.02, 0.1))
        radius = abs(
            rng.normal(cfg.random_object_radius, cfg.random_object_radius_std)
        )
        if cfg.random_object_center_near_surface:
            center = out[rng.integers(0, n)] + rng.uniform(
                -cfg.random_object_center_L, cfg.random_object_center_L, 3
            )
        else:
            center = rng.uniform(-0.5, 0.5, 3)
        blob = center + rng.normal(0, radius / 2, (m, 3)) * rng.uniform(
            *cfg.random_object_scale
        )
        idx = rng.choice(n, m, replace=False)
        out[idx] = blob

    # --- plane injection: ground or vertical wall patch
    if rng.random() < cfg.random_plane_prob:
        m = int(n * rng.uniform(0.05, 0.15))
        if rng.random() < cfg.random_plane_vertical_prob:
            s = rng.uniform(*cfg.random_plane_vertical_scale)
            h = rng.uniform(*cfg.random_plane_vertical_height_range)
            d = rng.uniform(*cfg.random_plane_vertical_horizon_range)
            normal_dir = rng.integers(0, 2)  # x or y facing wall
            plane = np.empty((m, 3))
            plane[:, normal_dir] = d * rng.choice([-1.0, 1.0])
            plane[:, 1 - normal_dir] = rng.uniform(-s, s, m)
            plane[:, 2] = rng.uniform(-h / 2, h / 2, m)
        else:
            s = rng.uniform(*cfg.random_plane_ground_scale)
            z = out[:, 2].min() + rng.uniform(
                -cfg.random_plane_ground_range, 0.02
            )
            plane = np.stack(
                [
                    rng.uniform(-s, s, m),
                    rng.uniform(-s, s, m),
                    np.full(m, z),
                ],
                axis=-1,
            )
        idx = rng.choice(n, m, replace=False)
        out[idx] = plane
    return out


def augment_sim3(
    pcl: np.ndarray,
    queries: List[np.ndarray],
    rng: np.random.Generator,
    rot: bool = True,
    scale_range: tuple = (0.8, 1.25),
    trans_std: float = 0.1,
):
    """Random SIM(3) applied consistently to the input and query sets
    (shapenet_new2.py aug v2)."""
    R = _random_rotation(rng) if rot else np.eye(3)
    s = rng.uniform(*scale_range)
    t = rng.normal(0, trans_std, 3)
    apply = lambda x: (x * s) @ R.T + t
    return apply(pcl), [apply(q) for q in queries], (R, s, t)


# ---------------------------------------------------------------------------
# Synthetic procedural dataset
# ---------------------------------------------------------------------------

def _sdf_box(p, half):
    q = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def _sdf_ellipsoid(p, radii):
    # approximate SDF (exact enough for training targets)
    k0 = np.linalg.norm(p / radii, axis=-1)
    k1 = np.linalg.norm(p / (radii**2), axis=-1)
    return k0 * (k0 - 1.0) / np.maximum(k1, 1e-9)


def _sdf_capsule(p, a, b, r):
    pa = p - a
    ba = b - a
    h = np.clip((pa @ ba) / (ba @ ba), 0.0, 1.0)
    return np.linalg.norm(pa - h[:, None] * ba, axis=-1) - r


def _sdf_torus(p, R, r):
    # exact torus SDF, axis = y; genus-1 — a held-out family the training
    # kinds (0-2, all genus-0 convex-ish) never produce
    q = np.stack(
        [np.linalg.norm(p[..., [0, 2]], axis=-1) - R, p[..., 1]], axis=-1
    )
    return np.linalg.norm(q, axis=-1) - r


class SyntheticShapeDataset:
    """Procedural shapes with analytic SDF supervision.

    Each item provides the same keys the reference dataset produces
    (shapenet_new2.py:299-354): inputs (noisy surface points), uniform and
    near-surface SDF queries with values, and occupancy eval points.
    """

    def __init__(
        self,
        n_items: int = 256,
        n_pcl: int = 1024,
        n_uni: int = 1024,
        n_nss: int = 1024,
        n_eval: int = 2048,
        noise_std: float = 0.005,
        aug: Optional[AugmentConfig] = None,
        sampling_aug: Optional[SamplingAugConfig] = None,
        seed: int = 0,
        ram_cache: bool = False,
        cache_workers: int = 8,
        shape_kinds: tuple = (0, 1, 2),
    ):
        # shape_kinds indexes the SDF families in _shape_sdf. The default
        # (0, 1, 2) draws identically to the historical stream, so every
        # seeded benchmark reproduces bit-for-bit. Held-out evaluation
        # passes e.g. (3,) for the torus family (out-of-family validation
        # of the ICP-acceptance rule).
        self.shape_kinds = tuple(shape_kinds)
        self.n_items = n_items
        self.n_pcl = n_pcl
        self.n_uni = n_uni
        self.n_nss = n_nss
        self.n_eval = n_eval
        self.noise_std = noise_std
        self.aug = aug
        self.sampling_aug = sampling_aug
        self.seed = seed
        # Items are deterministic per (seed, idx) — see __getitem__ — so a
        # RAM cache is semantics-preserving: same bytes, assembled once,
        # instead of synthesizing each item between device steps.
        self._cache: Optional[List[Batch]] = None
        if ram_cache:
            self._cache = self._build_cache(cache_workers)

    def _build_cache(self, workers: int) -> List[Batch]:
        if workers <= 1:
            return [self._build_item(i) for i in range(self.n_items)]
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            return list(
                ex.map(self._build_item, range(self.n_items), chunksize=16)
            )

    def __len__(self):
        return self.n_items

    def _shape_sdf(self, rng: np.random.Generator):
        # With the default shape_kinds=(0, 1, 2) this consumes exactly one
        # integers(0, 3) draw — the historical stream.
        kind = self.shape_kinds[int(rng.integers(0, len(self.shape_kinds)))]
        if kind == 0:
            half = rng.uniform(0.15, 0.4, 3)
            return lambda p: _sdf_box(p, half)
        if kind == 1:
            radii = rng.uniform(0.15, 0.45, 3)
            return lambda p: _sdf_ellipsoid(p, radii)
        if kind == 2:
            a = rng.uniform(-0.3, 0.0, 3)
            b = rng.uniform(0.0, 0.3, 3)
            r = rng.uniform(0.08, 0.2)
            return lambda p: _sdf_capsule(p, a, b, r)
        if kind == 3:
            R = rng.uniform(0.22, 0.38)
            r = rng.uniform(0.08, 0.16)
            return lambda p: _sdf_torus(p, R, r)
        raise ValueError(f"unknown shape kind {kind!r}")

    def _surface_points(self, sdf, rng, n):
        """Rejection + projection sampling of near-surface points."""
        pts = rng.uniform(-0.55, 0.55, (n * 8, 3))
        d = sdf(pts)
        order = np.argsort(np.abs(d))
        pts = pts[order[: n * 2]]
        # project with a numeric gradient step (2 iterations)
        for _ in range(2):
            d = sdf(pts)
            eps = 1e-4
            g = np.stack(
                [
                    (sdf(pts + [eps, 0, 0]) - d) / eps,
                    (sdf(pts + [0, eps, 0]) - d) / eps,
                    (sdf(pts + [0, 0, eps]) - d) / eps,
                ],
                axis=-1,
            )
            g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-9)
            pts = pts - d[:, None] * g
        return pts[rng.choice(len(pts), n, replace=False)]

    def __getitem__(self, idx: int) -> Batch:
        if self._cache is not None:
            return self._cache[idx]
        return self._build_item(idx)

    def _build_item(self, idx: int) -> Batch:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        sdf = self._shape_sdf(rng)

        surface = self._surface_points(sdf, rng, self.n_pcl)
        if self.sampling_aug is not None:
            surface = sampling_with_aug_s1(
                surface, self.n_pcl, rng, self.sampling_aug
            )
        inputs = surface + rng.normal(0, self.noise_std, surface.shape)
        if self.aug is not None and self.aug.use_augmentation:
            if rng.random() < self.aug.aug_ratio:
                inputs = augment_scene_sim(inputs, rng, self.aug)

        uni = rng.uniform(-0.55, 0.55, (self.n_uni, 3))
        nss = self._surface_points(sdf, rng, self.n_nss) + rng.normal(
            0, 0.03, (self.n_nss, 3)
        )
        ev = rng.uniform(-0.55, 0.55, (self.n_eval, 3))
        return {
            "inputs": inputs.astype(np.float32),
            "points_uni": uni.astype(np.float32),
            "points_uni_value": sdf(uni).astype(np.float32),
            "points_nss": nss.astype(np.float32),
            "points_nss_value": sdf(nss).astype(np.float32),
            "eval_points": ev.astype(np.float32),
            "eval_points_occ": (sdf(ev) < 0).astype(np.float32),
        }


# ---------------------------------------------------------------------------
# ShapeNet preprocessed layout reader
# ---------------------------------------------------------------------------

class ShapeNetSDFDataset:
    """Reader of the preprocessed ShapeNet layout (the reference's
    shapenet_new2.py:126-165, 278-307; tools/preprocess.py writes it):
    data_root/<category>/<object_id>/{pointcloud.npz, points_uni.npz,
    points_nss.npz[, dep_pcl_0.npz ...]}, or points.npz with packed
    occupancies for `dataset_mode="occ"`; the split CSV has rows
    (category, object_id, split), and without one every object directory
    under the categories is taken.

    `input_mode` "pcl" samples the inputs from pointcloud.npz, "dep" from a
    random 2-8 (dep_min_use_view to dep_max_use_view) of the depth views
    fused. `field_mode` "occ" binarizes the supervision (sdf <= 0).
    Objects whose files are missing are dropped; `proportion` keeps a
    random share; `class_balanced` resamples every category to the size
    of the largest. Item idx draws from numpy's generator seeded with
    seed * 7919 + idx.
    """

    def __init__(
        self,
        data_root: str,
        split: str = "train",
        split_csv: Optional[str] = None,
        categories: Optional[Sequence[str]] = None,
        n_pcl: int = 1024,
        n_uni: int = 1024,
        n_nss: int = 1024,
        n_eval: int = 10000,
        noise_std: float = 0.005,
        input_mode: str = "pcl",
        dataset_mode: str = "hybrid",
        field_mode: str = "sdf",
        dep_min_use_view: int = 2,
        dep_max_use_view: int = 8,
        aug: Optional[AugmentConfig] = None,
        sampling_aug: Optional[SamplingAugConfig] = None,
        class_balanced: bool = True,
        proportion: float = 1.0,
        ram_cache: bool = False,
        cache_workers: int = 8,
        seed: int = 0,
    ):
        if input_mode not in ("pcl", "dep"):
            raise ValueError(f"input_mode {input_mode!r}: 'pcl' or 'dep'")
        if dataset_mode not in ("hybrid", "occ"):
            raise ValueError(f"dataset_mode {dataset_mode!r}: 'hybrid' or 'occ'")
        if field_mode not in ("sdf", "occ"):
            raise ValueError(f"field_mode {field_mode!r}: 'sdf' or 'occ'")
        if dataset_mode == "occ" and field_mode != "occ":
            # the occupancy layout carries binary occupancies only
            raise ValueError("dataset_mode 'occ' supports only field_mode 'occ'")
        self.root = data_root
        self.n_pcl, self.n_uni, self.n_nss, self.n_eval = n_pcl, n_uni, n_nss, n_eval
        self.noise_std = noise_std
        self.input_mode = input_mode
        self.dataset_mode = dataset_mode
        self.field_mode = field_mode
        self.dep_min_use_view = dep_min_use_view
        self.dep_max_use_view = dep_max_use_view
        self.aug = aug
        self.sampling_aug = sampling_aug
        self.seed = seed

        if not os.path.isdir(data_root):
            raise FileNotFoundError(
                f"ShapeNet data root '{data_root}' not found. Preprocess "
                "watertight meshes into it with "
                "`python -m livingscenes_tpu_torch.tools.preprocess` (or use "
                "dataset_name: synthetic for procedural training data).")
        items: List[tuple] = []
        if split_csv and os.path.exists(split_csv):
            with open(split_csv) as f:
                for row in csv.reader(f):
                    if len(row) < 3:
                        continue
                    cat, oid, sp = row[0], row[1], row[2]
                    if sp != split:
                        continue
                    if categories and cat not in categories:
                        continue
                    items.append((cat, oid))
        else:
            cats = categories or sorted(
                d for d in os.listdir(data_root)
                if os.path.isdir(os.path.join(data_root, d)))
            for cat in cats:
                for oid in sorted(os.listdir(os.path.join(data_root, cat))):
                    items.append((cat, oid))

        required = "points_uni.npz" if dataset_mode == "hybrid" else "points.npz"
        items = [it for it in items
                 if os.path.exists(os.path.join(data_root, it[0], it[1], required))]
        if proportion < 1.0:
            rng = np.random.default_rng(seed)
            keep = max(1, int(len(items) * proportion))
            items = [items[i] for i in rng.permutation(len(items))[:keep]]

        if class_balanced and items:
            by_cat: Dict[str, List[tuple]] = {}
            for it in items:
                by_cat.setdefault(it[0], []).append(it)
            most = max(len(v) for v in by_cat.values())
            rng = np.random.default_rng(seed + 1)
            balanced = []
            for v in by_cat.values():
                reps = list(v) * (most // len(v))
                extra = rng.choice(len(v), most - len(reps), replace=True)
                balanced.extend(reps + [v[i] for i in extra])
            items = balanced
        self.items = items

        # the npz payloads of every object, loaded on threads
        self._cache: Optional[Dict[str, Dict[str, Dict[str, np.ndarray]]]] = None
        if ram_cache and items:
            from concurrent.futures import ThreadPoolExecutor

            dirs = sorted({os.path.join(data_root, c, o) for c, o in items})
            with ThreadPoolExecutor(max_workers=cache_workers) as ex:
                self._cache = dict(ex.map(_load_npz_dir, dirs))

    def _npz(self, d: str, name: str) -> Dict[str, np.ndarray]:
        """{key: array} of d/name, each member read once (an NpzFile reads
        a member anew on every access)."""
        if self._cache is not None:
            return self._cache[d][name]
        return _load_npz(os.path.join(d, name))

    def __len__(self):
        return len(self.items)

    def _load_input_cloud(self, d: str, rng) -> np.ndarray:
        if self.input_mode == "dep":
            if self._cache is not None:
                views = sorted(f for f in self._cache[d] if f.startswith("dep_pcl_"))
            else:
                views = sorted(os.path.basename(v)
                               for v in glob.glob(os.path.join(d, "dep_pcl_*.npz")))
            if views:
                k = rng.integers(self.dep_min_use_view,
                                 min(self.dep_max_use_view, len(views)) + 1)
                sel = rng.choice(len(views), k, replace=False)
                return np.concatenate([self._npz(d, views[i])["pcl"] for i in sel])
        return self._npz(d, "pointcloud.npz")["points"]

    def __getitem__(self, idx: int) -> Batch:
        cat, oid = self.items[idx]
        d = os.path.join(self.root, cat, oid)
        rng = np.random.default_rng(self.seed * 7919 + idx)

        cloud = self._load_input_cloud(d, rng)
        if self.sampling_aug is not None:
            inputs = sampling_with_aug_s1(cloud, self.n_pcl, rng, self.sampling_aug)
        else:
            inputs = _uniform_sampling(cloud, self.n_pcl, rng)
        inputs = inputs + rng.normal(0, self.noise_std, (self.n_pcl, 3))
        if self.aug is not None and self.aug.use_augmentation:
            if rng.random() < self.aug.aug_ratio:
                inputs = augment_scene_sim(inputs, rng, self.aug)

        if self.dataset_mode == "occ":
            # packed binary occupancies and no near-surface set: the nss
            # arrays are width 0, and the loss skips them
            occ_data = self._npz(d, "points.npz")
            pts = occ_data["points"]
            occ = np.unpackbits(occ_data["occupancies"])[: len(pts)]
            ui = rng.choice(len(pts), self.n_uni)
            ei = rng.choice(len(pts), self.n_eval)
            return {
                "inputs": inputs.astype(np.float32),
                "points_uni": pts[ui].astype(np.float32),
                "points_uni_value": occ[ui].astype(np.float32),
                "points_nss": np.zeros((0, 3), np.float32),
                "points_nss_value": np.zeros((0,), np.float32),
                "eval_points": pts[ei].astype(np.float32),
                "eval_points_occ": occ[ei].astype(np.float32),
            }

        uni_data = self._npz(d, "points_uni.npz")
        nss_data = self._npz(d, "points_nss.npz")
        ui = rng.choice(len(uni_data["points"]), self.n_uni)
        ni = rng.choice(len(nss_data["points"]), self.n_nss)
        ei = rng.choice(len(uni_data["points"]), self.n_eval)
        uni_sdf = uni_data["sdf"] if "sdf" in uni_data else uni_data["value"]
        nss_sdf = nss_data["sdf"] if "sdf" in nss_data else nss_data["value"]
        uni_val, nss_val = uni_sdf[ui], nss_sdf[ni]
        if self.field_mode == "occ":
            uni_val = (uni_val <= 0).astype(np.float32)
            nss_val = (nss_val <= 0).astype(np.float32)
        return {
            "inputs": inputs.astype(np.float32),
            "points_uni": uni_data["points"][ui].astype(np.float32),
            "points_uni_value": uni_val.astype(np.float32),
            "points_nss": nss_data["points"][ni].astype(np.float32),
            "points_nss_value": nss_val.astype(np.float32),
            "eval_points": uni_data["points"][ei].astype(np.float32),
            "eval_points_occ": (uni_sdf[ei] < 0).astype(np.float32),
        }


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _load_npz_dir(d: str):
    """(d, {file name: {key: array}}) of every npz file in directory d."""
    return d, {name: _load_npz(os.path.join(d, name))
               for name in os.listdir(d) if name.endswith(".npz")}


# ---------------------------------------------------------------------------
# Batch iterators
# ---------------------------------------------------------------------------

def batch_iterator(
    dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
    drop_last: bool = True, loop: bool = True,
) -> Iterator[Batch]:
    """Epoch-looping host batcher: items stacked into numpy dicts."""
    rng = np.random.default_rng(seed)
    while True:
        order = (
            rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
        )
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                continue
            items = [dataset[int(i)] for i in idx]
            yield {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }
        if not loop:
            return


def prefetch_iterator(it: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run `it` in a daemon thread, keeping `depth` batches ready.

    Overlaps host batch assembly with device compute without changing
    iteration order or values.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for batch in it:
                q.put(batch)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        batch = q.get()
        if batch is _END:
            return
        yield batch
