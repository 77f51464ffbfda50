"""The fused ICP correspondence step: plain version and the wrapper of
csrc/icp_stats.cu.

Counterpart of livingscenes_tpu/ops/pallas_icp.py (`icp_iteration_stats`).
Both versions return, per pair, the sufficient statistics of the rigid
refit of the moved source x against the target:

    S        (B, 3, 3)  sum_i src_i nn_i^T
    nn_sum   (B, 3)     sum_i nn_i
    dmin_sum (B,)       sum_i max(min_j d_ij, 0)

with d_ij = |x_i|^2 - 2 x_i.t_j + |t_j|^2 (unclamped for the minimum and the
tie test) and nn_i the mean of the targets at that minimum. Pairs whose
`active` flag is False get zeros (the TPU kernel left them undefined; every
consumer masks them).
"""
from __future__ import annotations

import torch

from . import _cuda

launches = 0  # kernel launches since the count was last set to 0
_counters = {}  # (device, stream) -> the kernel's per-pair arrival counters


def pair_counters(x, B):
    """The kernel's (>= B,) int32 per-pair arrival counters for the device
    and stream of x: zeros when made, and left at zero by every launch (the
    last block of each pair resets its own), so no call fills them. One
    buffer per stream, as launches on one stream never overlap."""
    key = (x.device, _cuda.stream_ptr(x))
    buf = _counters.get(key)
    if buf is None or buf.numel() < B:
        buf = torch.zeros((B,), dtype=torch.int32, device=x.device)
        _counters[key] = buf
    return buf


def icp_stats_plain(x, src, tgt, active=None):
    """The plain version: one (B, N, M) distance matrix per call."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    t2 = torch.sum(tgt * tgt, dim=-1)
    d = x2 - 2.0 * torch.matmul(x, tgt.transpose(-1, -2)) + t2[:, None, :]
    dmin = torch.amin(d, dim=-1, keepdim=True)
    mask = (d <= dmin).to(x.dtype)
    ones = torch.ones_like(tgt[..., :1])
    acc = torch.matmul(mask, torch.cat([tgt, ones], dim=-1))  # (B, N, 4)
    nn = acc[..., :3] / acc[..., 3:]
    S = torch.matmul(src.transpose(-1, -2), nn)
    nn_sum = torch.sum(nn, dim=1)
    dmin_sum = torch.sum(torch.clamp_min(dmin[..., 0], 0.0), dim=-1)
    if active is not None:
        keep = active.to(torch.bool)
        S = torch.where(keep[:, None, None], S, 0.0)
        nn_sum = torch.where(keep[:, None], nn_sum, 0.0)
        dmin_sum = torch.where(keep, dmin_sum, 0.0)
    return S, nn_sum, dmin_sum


def icp_stats_cuda(x, src, tgt, active=None):
    """The kernel: float32 (B, N, 3), (B, N, 3), (B, M, 3) on the card and
    an optional (B,) bool `active`."""
    global launches
    _cuda.require_cuda("icp_stats", x, src, tgt, dtype=torch.float32)
    B, N, _ = x.shape
    M = tgt.shape[1]
    if src.shape != x.shape or tgt.shape != (B, M, 3) or x.shape[-1] != 3:
        raise ValueError("icp_stats: x, src (B, N, 3) and tgt (B, M, 3)")
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=x.device)
    _cuda.require_cuda("icp_stats", x, active, dtype=None)
    if active.dtype != torch.bool or active.shape != (B,):
        raise TypeError("icp_stats: active must be a (B,) bool tensor")
    lib = _cuda.lib()
    block = lib.lstpu_icp_stats_block()
    partial = torch.empty(
        (B, -(-N // block), 13), dtype=torch.float32, device=x.device
    )
    arrived = pair_counters(x, B)
    out = torch.empty((B, 13), dtype=torch.float32, device=x.device)
    err = lib.lstpu_icp_stats(
        x.data_ptr(), src.data_ptr(), tgt.data_ptr(), active.data_ptr(),
        partial.data_ptr(), arrived.data_ptr(), out.data_ptr(), B, N, M,
        _cuda.stream_ptr(x),
    )
    _cuda.check(err, "icp_stats")
    launches += 1
    return out[:, :9].reshape(B, 3, 3), out[:, 9:12], out[:, 12]


def icp_iteration_stats(x, src, tgt, active=None):
    """(S, nn_sum, dmin_sum) in float32: the plain version on the CPU, the
    kernel on the card. As in the JAX wrapper, the clouds are cast to
    float32 whatever their dtype."""
    x, src, tgt = (a.to(torch.float32).contiguous() for a in (x, src, tgt))
    if x.device.type == "cpu":
        return icp_stats_plain(x, src, tgt, active)
    return icp_stats_cuda(
        x, src, tgt, None if active is None else active.contiguous()
    )
