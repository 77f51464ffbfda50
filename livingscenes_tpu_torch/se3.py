"""Batched SE(3) math: transforms, the so(3)/se(3) exponential and
logarithm maps, Kabsch and Horn rotation fits, registration errors, and
the robust (Huber) weights.

Counterpart of livingscenes_tpu/se3.py.
Conventions: points are right-multiplied by R^T; an SE(3) transform is a
(B, 3 or 4, 4) matrix; `kabsch` returns R (B, 3, 3) and t (B, 3, 1).
"""
from __future__ import annotations

import torch

from .parallel.sharding import batch_draw


def identity(batch_size: int, dtype: torch.dtype = torch.float32,
             device=None) -> torch.Tensor:
    """(B, 3, 4) identity transforms."""
    eye = torch.eye(3, 4, dtype=dtype, device=device)
    return eye.expand(batch_size, 3, 4)


def inverse(g: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3/4, 4) transforms, as (..., 3, 4)."""
    rot_t = g[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.matmul(rot_t, g[..., :3, 3:])
    return torch.cat([rot_t, t_inv], dim=-1)


def concatenate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The composition a . b of (..., 3/4, 4) transforms, as (..., 3, 4)."""
    rot1, t1 = a[..., :3, :3], a[..., :3, 3:]
    rot2, t2 = b[..., :3, :3], b[..., :3, 3:]
    return torch.cat([torch.matmul(rot1, rot2),
                      torch.matmul(rot1, t2) + t1], dim=-1)


def transform(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3/4, 4) transforms to points (..., N, 3)."""
    return torch.matmul(a, g[..., :3, :3].transpose(-1, -2)) + g[..., None, :3, 3]


def rt_to_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R (B, 3, 3) and t (B, 3, 1) -> (B, 4, 4)."""
    B = R.shape[0]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t.reshape(B, 3, 1)], dim=-1)
    return torch.cat([top, bottom.expand(B, 1, 4)], dim=1)


def to_4x4(g: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4); a (..., 4, 4) input is returned as is."""
    if g.shape[-2] == 4:
        return g
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    return torch.cat([g, bottom.expand(g.shape[:-2] + (1, 4))], dim=-2)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _sincos_coeffs(theta_sq: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with their Taylor
    series below t^2 = 1e-12. The square root and the divisions see 1
    there, not theta_sq: `torch.where` alone would still pass the untaken
    branch's NaN gradient backward at t = 0."""
    small = theta_sq < 1e-12
    safe_sq = torch.where(small, 1.0, theta_sq)
    t = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(t)) / safe_sq)
    c = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (t - torch.sin(t)) / (safe_sq * t)
    )
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, with finite gradients at 0: (..., 3) ->
    (..., 3, 3)."""
    W = hat(w)
    a, b, _ = _sincos_coeffs(torch.sum(w * w, dim=-1))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * torch.matmul(W, W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential: xi (..., 6) = [rho | omega] -> (..., 3, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = torch.matmul(W, W)
    _, b, c = _sincos_coeffs(torch.sum(w * w, dim=-1))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.matmul(V, rho[..., None])
    return torch.cat([so3_exp(w), t], dim=-1)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm of SO(3): (..., 3, 3) -> (..., 3); stable away from pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    near_zero = cos_theta > 1.0 - 1e-9
    safe_theta = torch.where(near_zero, 1.0, theta)
    # theta / (2 sin theta) = 1/2 + (1 - cos theta) / 6 + ... near zero
    scale = torch.where(
        near_zero,
        0.5 + (1.0 - cos_theta) / 6.0,
        safe_theta / (2.0 * torch.sin(safe_theta)),
    )
    return scale[..., None] * vee


def rotation_from_covariance(cov: torch.Tensor) -> torch.Tensor:
    """Proper rotation maximizing tr(R cov) from a (..., 3, 3) covariance:
    SVD, with a reflection fixed through the sign of det(V U^T)."""
    U, _, Vh = torch.linalg.svd(cov)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(V, Ut))
    ones = torch.ones_like(det)
    diag = torch.stack([ones, ones, det], dim=-1)
    return torch.matmul(V * diag[..., None, :], Ut)


def quat_wxyz_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z): of Shepperd's four
    candidates, the one with the largest diagonal term."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + R00 + R11 + R22
    t1 = 1.0 + R00 - R11 - R22
    t2 = 1.0 - R00 + R11 - R22
    t3 = 1.0 - R00 - R11 + R22
    t = torch.stack([t0, t1, t2, t3], dim=-1)
    cand = torch.stack(
        [
            torch.stack([t0, R21 - R12, R02 - R20, R10 - R01], dim=-1),
            torch.stack([R21 - R12, t1, R01 + R10, R02 + R20], dim=-1),
            torch.stack([R02 - R20, R01 + R10, t2, R12 + R21], dim=-1),
            torch.stack([R10 - R01, R02 + R20, R12 + R21, t3], dim=-1),
        ],
        dim=-2,
    )
    idx = torch.argmax(t, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    tmax = torch.take_along_dim(t, idx[..., None], dim=-1)
    q = q / (2.0 * torch.sqrt(torch.clamp_min(tmax, 1e-12)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def matrix_from_quat_wxyz(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rotation_from_covariance_horn(
    cov: torch.Tensor, q0: torch.Tensor | None = None, iters: int = 8
):
    """Proper rotation maximizing tr(R cov) without an SVD: Horn's
    quaternion eigenproblem, solved by `iters` power iterations on the
    4x4 matrix shifted by 2 |cov|_F + 1e-12 (so the wanted eigenvalue is
    the largest), warm-started from `q0` (w first). Returns (R, q)."""
    Sxx, Sxy, Sxz = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    Syx, Syy, Syz = cov[..., 1, 0], cov[..., 1, 1], cov[..., 1, 2]
    Szx, Szy, Szz = cov[..., 2, 0], cov[..., 2, 1], cov[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    s = 2.0 * torch.sqrt(torch.sum(cov * cov, dim=(-2, -1))) + 1e-12
    if q0 is None:
        q = torch.zeros(cov.shape[:-2] + (4,), dtype=cov.dtype, device=cov.device)
        q[..., 0] = 1.0
    else:
        q = q0
    for _ in range(iters):
        q = torch.matmul(N, q[..., None])[..., 0] + s[..., None] * q
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return matrix_from_quat_wxyz(q), q


def solve_rotation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Orthogonal Procrustes with the reflection fixed: R (B, 3, 3) with
    R f1 ~ f2 in the least-squares sense, for corresponding (B, N, 3)
    vectors."""
    return rotation_from_covariance(torch.matmul(f1.transpose(-1, -2), f2))


def transformation_residuals(x1, x2, R, t) -> torch.Tensor:
    """Euclidean residuals of x2 ~ R x1 + t; (B, N)."""
    x2_hat = torch.matmul(R, x1.transpose(-1, -2)) + t
    return torch.linalg.norm(x2_hat.transpose(-1, -2) - x2, dim=-1)


def kabsch(x1, x2, weights=None, normalize_w: bool = True, eps: float = 1e-7):
    """Weighted Kabsch of corresponding (B, N, 3) sets, x2 ~ R x1 + t.

    Returns R (B, 3, 3), t (B, 3, 1), res (B, N) pointwise residuals.
    """
    B, N, _ = x1.shape
    if weights is None:
        weights = torch.ones((B, N), dtype=x1.dtype, device=x1.device)
    if normalize_w:
        weights = weights / (torch.sum(weights, dim=1, keepdim=True) + eps)
    w = weights[..., None]
    denom = torch.sum(w, dim=1, keepdim=True) + eps
    x1_mean = torch.sum(w * x1, dim=1, keepdim=True) / denom
    x2_mean = torch.sum(w * x2, dim=1, keepdim=True) / denom
    cov = torch.matmul((x1 - x1_mean).transpose(-1, -2), w * (x2 - x2_mean))
    R = rotation_from_covariance(cov)
    t = x2_mean.transpose(-1, -2) - torch.matmul(R, x1_mean.transpose(-1, -2))
    return R, t, transformation_residuals(x1, x2, R, t)


def solve_transform_from_latent(code1: dict, code2: dict) -> torch.Tensor:
    """The (B, 4, 4) transform carrying code1's frame onto code2's: R from
    the equivariant features z_so3 (B, C, 3), t from the centres (B, 1, 3)."""
    R = solve_rotation(code1["z_so3"], code2["z_so3"])
    t = code2["t"] - torch.matmul(code1["t"], R.transpose(-1, -2))
    return to_4x4(torch.cat([R, t.transpose(-1, -2)], dim=-1))


def rotation_error(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error in degrees; (B,)."""
    R_ = torch.matmul(R1.transpose(-1, -2), R2)
    trace = R_[..., 0, 0] + R_[..., 1, 1] + R_[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def translation_error(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Norm of the translation difference; (B,)."""
    return torch.linalg.norm((t1 - t2).reshape(t1.shape[0], -1), dim=-1)


def compute_transformation_error(pc1: torch.Tensor, pc2: torch.Tensor,
                                 pred_tsfm: torch.Tensor,
                                 gt_tsfm: torch.Tensor) -> torch.Tensor:
    """Endpoint RMSE of a predicted transform against the true one, both
    ways: pc1 (B, N, 3) moved forward and pc2 (B, M, 3) moved back; a
    scalar over the whole batch."""
    e12 = transform(pred_tsfm, pc1) - transform(gt_tsfm, pc1)
    e21 = transform(inverse(pred_tsfm), pc2) - transform(inverse(gt_tsfm), pc2)
    err = torch.cat([e12, e21], dim=1)
    return torch.sqrt(torch.mean(err ** 2))


def chamfer_distance_under_transforms(src: torch.Tensor, ref: torch.Tensor,
                                      pred_tsfm: torch.Tensor,
                                      gt_tsfm: torch.Tensor) -> torch.Tensor:
    """Registration chamfer; (B,): the mean squared nearest-neighbour
    distance from pred(src) to ref, plus that from ref to
    pred(gt^-1(ref)). The distances are formed from coordinate
    differences, not from the norms' expansion."""
    src_t = transform(pred_tsfm, src)
    ref_it = transform(concatenate(pred_tsfm, inverse(gt_tsfm)), ref)

    def sq_nearest(a, b):
        d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")
        return torch.min(d, dim=-1).values ** 2

    return (torch.mean(sq_nearest(src_t, ref), dim=1)
            + torch.mean(sq_nearest(ref, ref_it), dim=1))


def from_xyzquat(xyzquat: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x y z qx qy qz qw] -> (..., 3, 4); the quaternion is
    normalised first."""
    t = xyzquat[..., :3]
    x, y, z, w = xyzquat[..., 3:7].unbind(-1)
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    R = matrix_from_quat_wxyz(torch.stack([w / n, x / n, y / n, z / n], dim=-1))
    return torch.cat([R, t[..., None]], dim=-1)


def random_rotation(generator: torch.Generator, batch_shape=(),
                    dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Uniform random rotations (..., 3, 3) from normalised Gaussian
    quaternions drawn from `generator` (on the generator's device, then
    moved to `device`)."""
    q = batch_draw(torch.randn, tuple(batch_shape) + (4,), generator, dtype=dtype,
                   device=generator.device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    xyzquat = torch.cat([torch.zeros_like(q[..., :3]), q], dim=-1)
    return from_xyzquat(xyzquat)[..., :3, :3].to(device)


def huber_norm_weights(x: torch.Tensor, b: float = 0.02) -> torch.Tensor:
    """IRLS Huber weights of residual norms x >= 0: 1 up to b, then
    sqrt(2 b x - b^2) / x."""
    res_norm = torch.where(x <= b, x ** 2, 2.0 * b * x - b ** 2)
    safe_x = torch.where(x == 0, 1.0, x)
    return torch.sqrt(res_norm) / safe_x


def get_robust_res(res: torch.Tensor, b: float):
    """Huber-weighted residuals (..., 1, 1) and the squared weights."""
    res = res.reshape(-1, 1, 1)
    w = huber_norm_weights(torch.abs(res), b=b)
    return w * res, w ** 2
