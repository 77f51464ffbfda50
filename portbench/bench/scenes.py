"""Scene pairs of procedural shapes, made on the device from a seed.

The shapes are those of the port's synthetic training set (boxes,
ellipsoids and capsules with analytic signed distances; a copy of the
sampler of livingscenes_tpu_torch/train/data.py SyntheticShapeDataset,
batched): candidates drawn uniformly in the box [-0.55, 0.55]^3, the
twice-n nearest the surface kept, projected onto it by two steps along a
numeric gradient, and n of them picked at random. A scene places each of
its objects at an offset; its rescan samples every object's surface
again, independently, moves each object by its own rigid transform and
permutes the objects. Both scans carry Gaussian noise and a mask whose
number of valid points is drawn per instance.

Every draw comes from one torch.Generator on the device, so one seed
gives the same scenes on the same kind of device.
"""
from __future__ import annotations

import torch

SDF_EPS = 1e-4  # the numeric gradient's step


def _draw_shapes(gen, B: int, kinds, device):
    """Per instance: its kind and the parameters of every kind (only its
    own kind's are used)."""
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device)  # noqa: E731
    kind = torch.as_tensor(kinds, device=device)[
        torch.randint(len(kinds), (B,), generator=gen, device=device)]
    return {"kind": kind,
            "half": 0.15 + 0.25 * u(B, 3),
            "radii": 0.15 + 0.30 * u(B, 3),
            "a": -0.3 + 0.3 * u(B, 3),
            "b": 0.3 * u(B, 3),
            "r": 0.08 + 0.12 * u(B)}


def sdf(p: torch.Tensor, shape: dict) -> torch.Tensor:
    """Signed distance (B, M) of points (B, M, 3) to each instance's shape."""
    q = p.abs() - shape["half"][:, None]
    box = torch.linalg.norm(q.clamp_min(0.0), dim=-1) + q.amax(-1).clamp_max(0.0)
    radii = shape["radii"][:, None]
    k0 = torch.linalg.norm(p / radii, dim=-1)
    k1 = torch.linalg.norm(p / radii ** 2, dim=-1)
    ellipsoid = k0 * (k0 - 1.0) / k1.clamp_min(1e-9)
    a, b = shape["a"][:, None], shape["b"][:, None]
    pa, ba = p - a, b - a
    h = ((pa * ba).sum(-1) / (ba * ba).sum(-1)).clamp(0.0, 1.0)
    capsule = torch.linalg.norm(pa - h[..., None] * ba, dim=-1) - shape["r"][:, None]
    kind = shape["kind"][:, None]
    return torch.where(kind == 0, box, torch.where(kind == 1, ellipsoid, capsule))


def surface_points(gen, shape: dict, n: int) -> torch.Tensor:
    """(B, n, 3) points on each instance's surface."""
    B, dev = shape["kind"].shape[0], shape["kind"].device
    pts = (torch.rand(B, 8 * n, 3, generator=gen, device=dev) - 0.5) * 1.1
    near = torch.topk(-sdf(pts, shape).abs(), 2 * n, dim=-1).indices
    pts = torch.gather(pts, 1, near[..., None].expand(B, 2 * n, 3))
    steps = torch.eye(3, device=dev) * SDF_EPS
    for _ in range(2):
        d = sdf(pts, shape)
        g = torch.stack([(sdf(pts + steps[i], shape) - d) / SDF_EPS for i in range(3)], -1)
        g = g / torch.linalg.norm(g, dim=-1, keepdim=True).clamp_min(1e-9)
        pts = pts - d[..., None] * g
    pick = torch.argsort(torch.rand(B, 2 * n, generator=gen, device=dev), dim=-1)[:, :n]
    return torch.gather(pts, 1, pick[..., None].expand(B, n, 3))


def random_rotations(gen, B: int, device) -> torch.Tensor:
    """(B, 3, 3) rotations uniform on SO(3), from normalised Gaussian
    quaternions."""
    q = torch.randn(B, 4, generator=gen, device=device)
    w, x, y, z = (q / torch.linalg.norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _masked(gen, pts: torch.Tensor, lo: int):
    """Each instance keeps a uniform number of valid points in [lo, N] at
    its front; the padding repeats its first point."""
    B, N, _ = pts.shape
    valid = torch.randint(lo, N + 1, (B,), generator=gen, device=pts.device)
    mask = torch.arange(N, device=pts.device)[None] < valid[:, None]
    return torch.where(mask[..., None], pts, pts[:, :1]), mask


def scene_pairs(gen, mix: dict, device):
    """One batch of the mix: (ref, rescan) (S, O, N, 3) float32 and their
    masks (S, O, N)."""
    S, O, N = mix["scene_pairs"], mix["objects"], mix["points"]
    B = S * O
    shape = _draw_shapes(gen, B, mix["shape_kinds"], device)
    noise = mix["noise"]
    ref = surface_points(gen, shape, N) + noise * torch.randn(B, N, 3, generator=gen, device=device)
    res = surface_points(gen, shape, N) + noise * torch.randn(B, N, 3, generator=gen, device=device)
    offset = mix["offset"] * (2.0 * torch.rand(B, 1, 3, generator=gen, device=device) - 1.0)
    ref = ref + offset
    R = random_rotations(gen, B, device)
    t = mix["rescan_translation_std"] * torch.randn(B, 1, 3, generator=gen, device=device)
    res = (res + offset) @ R.transpose(-1, -2) + t
    ref, ref_mask = _masked(gen, ref, mix["min_points"])
    res, res_mask = _masked(gen, res, mix["min_points"])
    perm = torch.argsort(torch.rand(S, O, generator=gen, device=device), dim=-1)
    perm = (perm + O * torch.arange(S, device=device)[:, None]).reshape(-1)
    res, res_mask = res[perm], res_mask[perm]
    return (ref.reshape(S, O, N, 3).contiguous(), res.reshape(S, O, N, 3).contiguous(),
            ref_mask.reshape(S, O, N), res_mask.reshape(S, O, N))
