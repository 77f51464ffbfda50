"""Sinkhorn potentials of uniform-weight optimal transport between point
clouds: plain versions and the wrappers of csrc/sinkhorn.cu.

Counterpart of livingscenes_tpu/ops/pallas_sinkhorn.py
(`sinkhorn_iterates`, `ot_extrapolated_potentials`). For clouds x (B, N, 3)
and y (B, M, 3) the cost is C_ij = |x_i|^2/2 + |y_j|^2/2 - x_i.y_j, the
weights log a = -log N, log b = -log M, and along a schedule of
temperatures eps the potentials start at 0 and take damped parallel updates

    ft_i = -eps logsumexp_j(log b + (g_j - C_ij) / eps)
    gt_j = -eps logsumexp_i(log a + (f_i - C_ij) / eps)
    f, g = (f + ft) / 2, (g + gt) / 2          (both from the old f, g)

`sinkhorn_iterates` returns these iterates. `ot_extrapolated_potentials`
adds one undamped pair at the last eps, (f_out, g_out) = (ft, gt), and is
differentiable in x and y through that pair alone: the iterates count as
constants (the gradient at the converged potentials). On the card neither
function writes a matrix to device memory; the backward is a kernel too.
Both kernels take any N and M: the forward runs each pair on a cluster of
blocks (`forward_plan` says how many) and streams each side through shared
memory, the backward sums its column terms in a fixed order through a
scratch buffer.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _cuda
from .cuda_icp import pair_counters

launches = 0  # forward launches (iterates + final pair) since last set to 0
bwd_launches = 0  # backward launches since last set to 0
iterates_launches = 0  # iterates-only launches since last set to 0


def cost_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C (..., N, M) = |x|^2/2 + |y|^2/2 - x.y, the expanded form the kernel
    rebuilds entry by entry."""
    x2 = 0.5 * torch.sum(x * x, dim=-1)
    y2 = 0.5 * torch.sum(y * y, dim=-1)
    return x2[..., :, None] + y2[..., None, :] - torch.matmul(x, y.transpose(-1, -2))


def softmin_rows(C, g, eps: float):
    """ft_i = -eps logsumexp_j(log b + (g_j - C_ij) / eps), log b = -log M."""
    log_b = -math.log(C.shape[-1])
    return -eps * torch.logsumexp(log_b + (g[..., None, :] - C) / eps, dim=-1)


def softmin_cols(C, f, eps: float):
    """gt_j = -eps logsumexp_i(log a + (f_i - C_ij) / eps), log a = -log N."""
    log_a = -math.log(C.shape[-2])
    return -eps * torch.logsumexp(log_a + (f[..., :, None] - C) / eps, dim=-2)


def damped_iterates(C: torch.Tensor, schedule: Sequence[float]):
    """The damped parallel updates on a cost matrix C (..., N, M), from
    f = g = 0, one per temperature; autograd follows them."""
    f = torch.zeros(C.shape[:-1], dtype=C.dtype, device=C.device)
    g = torch.zeros(C.shape[:-2] + C.shape[-1:], dtype=C.dtype, device=C.device)
    for eps in schedule:
        ft = softmin_rows(C, g, eps)
        gt = softmin_cols(C, f, eps)
        f, g = 0.5 * (f + ft), 0.5 * (g + gt)
    return f, g


def sinkhorn_iterates_plain(x, y, schedule: Sequence[float]):
    """The plain version: the materialised cost matrix and one pair of
    `torch.logsumexp` per temperature. Returns detached (f (B, N), g (B, M))."""
    with torch.no_grad():
        return damped_iterates(cost_matrix(x, y), schedule)


def ot_extrapolated_potentials_plain(x, y, schedule: Sequence[float]):
    """The plain version: detached iterates, then the final pair on a cost
    matrix that autograd follows back to x and y, so its gradient is the
    yardstick of the backward kernel."""
    f, g = sinkhorn_iterates_plain(x, y, schedule)
    C = cost_matrix(x, y)
    return softmin_rows(C, g, schedule[-1]), softmin_cols(C, f, schedule[-1])


@functools.lru_cache(maxsize=64)
def _reciprocals(schedule: Tuple[float, ...]):
    """1 / eps of each temperature as a C float array, rounded once from the
    double, as a compile-time constant would be."""
    return (ctypes.c_float * len(schedule))(*[1.0 / e for e in schedule])


def _check_pair(name: str, x, y):
    """Raise unless x (B, N, 3), y (B, M, 3) are float32 on the card;
    returns the kernel library."""
    _cuda.require_cuda(name, x, y, dtype=torch.float32)
    if x.dim() != 3 or y.dim() != 3 or x.shape[-1] != 3 or y.shape[-1] != 3 \
            or x.shape[0] != y.shape[0]:
        raise ValueError(f"{name}: x (B, N, 3) and y (B, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    return _cuda.lib()


def forward_plan(B: int, N: int, M: int) -> dict:
    """The launch shape the forward kernel takes for B pairs of N x M:
    `cluster` blocks a pair (a thread-block cluster), `threads` a block,
    `tile`, the points of a side streamed through shared memory at once,
    and the `scratch` floats a pair that hold its potentials."""
    out = (ctypes.c_int * 4)()
    _cuda.check(_cuda.lib().lstpu_sinkhorn_plan(B, N, M, out), "sinkhorn_plan")
    return {"cluster": out[0], "threads": out[1], "tile": out[2], "scratch": out[3]}


def _forward_cuda(name: str, x, y, schedule, final: bool):
    lib = _check_pair(name, x, y)
    schedule = tuple(float(e) for e in schedule)
    if not 1 <= len(schedule) <= lib.lstpu_sinkhorn_max_schedule():
        raise ValueError(f"{name}: schedule of {len(schedule)} temperatures")
    if min(schedule) <= 0.0:
        raise ValueError(f"{name}: temperatures must be positive")
    B, N, _ = x.shape
    M = y.shape[1]
    plan = forward_plan(B, N, M)
    outs = [torch.empty((B, n), dtype=torch.float32, device=x.device)
            for n in ((N, M, N, M) if final else (N, M))]
    # the potentials' double buffer in device memory
    pot = torch.empty((B, plan["scratch"]), dtype=torch.float32, device=x.device)
    # the C entry takes f_out, g_out, f_it, g_it; without the first two it
    # stops before the final pair
    ptrs = ([] if final else [None, None]) + [o.data_ptr() for o in outs]
    err = lib.lstpu_sinkhorn(
        x.data_ptr(), y.data_ptr(), *ptrs, pot.data_ptr(),
        _reciprocals(schedule), len(schedule), B, N, M, _cuda.stream_ptr(x))
    _cuda.check(err, name)
    return outs


def sinkhorn_iterates_cuda(x, y, schedule: Sequence[float]):
    """The kernel stopped before the final pair: x (B, N, 3), y (B, M, 3)
    float32 on the card -> (f (B, N), g (B, M))."""
    global iterates_launches
    f, g = _forward_cuda("sinkhorn_iterates", x.detach(), y.detach(), schedule,
                         final=False)
    iterates_launches += 1
    return f, g


def extrapolated_forward_cuda(x, y, schedule: Sequence[float]):
    """The forward kernel: (f_out, g_out, f_it, g_it), no autograd."""
    global launches
    outs = _forward_cuda("sinkhorn", x, y, schedule, final=True)
    launches += 1
    return outs


def extrapolated_backward_cuda(x, y, f_out, g_out, f_it, g_it, cf, cg, eps: float):
    """The backward kernel: cotangents cf (B, N) of f_out and cg (B, M) of
    g_out, either of which may be None, -> (dx (B, N, 3), dy (B, M, 3)).
    With W_ij = exp(log b + (f_out_i + g_it_j - C_ij) / eps) and
    V_ij = exp(log a + (f_it_i + g_out_j - C_ij) / eps), the softmax weights
    of the final pair (the saved outputs are its log-sum-exps), and
    Q = cf W + V cg: dx_i = sum_j Q_ij (x_i - y_j), dy_j = sum_i Q_ij
    (y_j - x_i), each summed in a fixed order."""
    global bwd_launches
    lib = _check_pair("sinkhorn_bwd", x, y)
    given = [t for t in (f_out, g_out, f_it, g_it, cf, cg) if t is not None]
    _cuda.require_cuda("sinkhorn_bwd", x, *given, dtype=torch.float32)
    B, N, _ = x.shape
    M = y.shape[1]
    for t, n in ((f_out, N), (g_out, M), (f_it, N), (g_it, M), (cf, N), (cg, M)):
        if t is not None and t.shape != (B, n):
            raise ValueError(f"sinkhorn_bwd: expected {(B, n)}, got {tuple(t.shape)}")
    if cf is None and cg is None:
        raise ValueError("sinkhorn_bwd: at least one of cf and cg is needed")
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    # the row tiles' column sums, folded in tile order by the last block of
    # each pair
    tiles = -(-N // lib.lstpu_sinkhorn_bwd_rows())
    partial = torch.empty((B, tiles, 3, M), dtype=torch.float32, device=x.device)
    err = lib.lstpu_sinkhorn_bwd(
        x.data_ptr(), y.data_ptr(), f_out.data_ptr(), g_out.data_ptr(),
        f_it.data_ptr(), g_it.data_ptr(),
        None if cf is None else cf.data_ptr(),
        None if cg is None else cg.data_ptr(),
        dx.data_ptr(), dy.data_ptr(), partial.data_ptr(),
        pair_counters(x, B).data_ptr(), 1.0 / eps, B, N, M,
        _cuda.stream_ptr(x))
    _cuda.check(err, "sinkhorn_bwd")
    bwd_launches += 1
    return dx, dy


class _ExtrapolatedPotentials(torch.autograd.Function):
    """(x, y) -> (f_out, g_out) through the forward kernel; the backward is
    the closed-form kernel, so it cannot be differentiated again."""

    @staticmethod
    def forward(ctx, x, y, schedule):
        ctx.set_materialize_grads(False)  # an unused output's cotangent: None
        f_out, g_out, f_it, g_it = extrapolated_forward_cuda(x, y, schedule)
        ctx.save_for_backward(x, y, f_out, g_out, f_it, g_it)
        ctx.eps = schedule[-1]
        return f_out, g_out

    @staticmethod
    @once_differentiable
    def backward(ctx, cf, cg):
        x, y, f_out, g_out, f_it, g_it = ctx.saved_tensors
        if cf is None and cg is None:
            return torch.zeros_like(x), torch.zeros_like(y), None
        dx, dy = extrapolated_backward_cuda(
            x, y, f_out, g_out, f_it, g_it,
            None if cf is None else cf.contiguous(),
            None if cg is None else cg.contiguous(), ctx.eps)
        return dx, dy, None


def sinkhorn_iterates(x, y, schedule: Sequence[float]):
    """Damped Sinkhorn iterates (f (B, N), g (B, M)) along `schedule`,
    detached: the plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return sinkhorn_iterates_plain(x, y, schedule)
    return sinkhorn_iterates_cuda(x.contiguous(), y.contiguous(), schedule)


def ot_extrapolated_potentials(x, y, schedule: Sequence[float]):
    """Extrapolated potentials (f (B, N), g (B, M)) of OT(x, y),
    differentiable in x and y through the final pair: the plain version on
    the CPU, the forward and backward kernels on the card."""
    if x.device.type == "cpu":
        return ot_extrapolated_potentials_plain(x, y, schedule)
    return _ExtrapolatedPotentials.apply(
        x.contiguous(), y.contiguous(), tuple(float(e) for e in schedule))
