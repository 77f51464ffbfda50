"""Occupancy grids of a decoded field: dense, and coarse to fine.

Counterpart of livingscenes_tpu/recon/grid.py (`grid_coordinates`,
`dense_grid_values`, `sharded_dense_grid_values`, `hierarchical_grid_values`,
`batched_hierarchical_grid_values`, `apply_final_merge`). The decoder is the
only large product: each level decodes its points in chunks of `chunk_size`
per instance, and the batched function decodes the chunk of all B instances
in one decoder call (JAX vmaps the one-instance function instead). With a
`mesh` (parallel/sharding.py) the one-instance functions shard the query
points over its `shard_axis`: each rank decodes its 1/n of every level's
points and every rank gets the whole grid.

The coarse-to-fine evaluation keeps every shape static, so that nothing is
read back to the host between levels: each refine level decodes exactly
`cap = min(refine_cap_factor * n^2, n^3)` points per instance, the first
`cap` active points in lattice order ("packsort") or the `cap` closest to
the threshold ("topk"), and counts what the cap dropped (`overflow`). The
compaction is a prefix sum and a binary search rather than JAX's sort of
int32 keys; the selected points, their order and the layout of the unused
slots (`n^3 + slot`) are JAX's. The profiler ranges `recon.decode_level0`,
`recon.select`, `recon.decode_refine` and `recon.scatter` name the stages.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..parallel.sharding import (active_mesh, gather_batch, mesh_size,
                                 pad_to_multiple, shard_rows)

_SELECT_MODES = ("packsort", "topk")
_MERGES = ("device", "host")


def grid_coordinates(resolution: int, box_size: float,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The (res+1)^3 corner points of the extraction cube, flattened to
    (N, 3) in lattice order: p = box_size * (idx / res - 0.5)."""
    n = resolution + 1
    idx = torch.arange(n, dtype=dtype, device=resolve_device(device))
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return box_size * (pts / resolution - 0.5)


def _chunked_eval(decode: Callable[[torch.Tensor], torch.Tensor],
                  pts: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """decode over (B, M, 3) points, `chunk_size` points of every instance
    in each call: (B, M)."""
    M = pts.shape[1]
    return torch.cat([decode(pts[:, i:i + chunk_size])
                      for i in range(0, M, chunk_size)], dim=1)


def _eval_points(decode: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor,
                 chunk_size: int, mesh=None, axis: str = "qp") -> torch.Tensor:
    """decode over (B, M, 3) points, query-sharded with a mesh: the points
    are padded (with zeros) to a multiple of the ranks along `axis`, each
    rank decodes its 1/n slice in chunks, and the slices are gathered in
    rank order, so that every rank returns the whole (B, M)."""
    mesh = active_mesh(mesh, axis)
    if mesh is None:
        return _chunked_eval(decode, pts, chunk_size)
    B, M, _ = pts.shape
    padded = pad_to_multiple(M, mesh_size(mesh, axis))
    pts = torch.cat([pts, pts.new_zeros((B, padded - M, 3))], dim=1)
    local = _chunked_eval(decode, pts[:, shard_rows(padded, mesh, axis)], chunk_size)
    vals = gather_batch(local.transpose(0, 1).contiguous(), mesh, axis)
    return vals.transpose(0, 1)[:, :M]


def dense_grid_values(decode: Callable[[torch.Tensor], torch.Tensor],
                      resolution: int, box_size: float = 1.1,
                      chunk_size: int = 65536, dtype: torch.dtype = torch.float32,
                      device=None, mesh=None, shard_axis: str = "qp") -> torch.Tensor:
    """The dense (res+1)^3 value grid of `decode`: (M, 3) -> (M,); with
    `mesh`, the query points sharded over its `shard_axis`."""
    pts = grid_coordinates(resolution, box_size, dtype, device)
    vals = _eval_points(lambda p: decode(p[0])[None], pts[None], chunk_size,
                        mesh, shard_axis)
    n = resolution + 1
    return vals.reshape(n, n, n)


def sharded_dense_grid_values(decode: Callable[[torch.Tensor], torch.Tensor],
                              resolution: int, mesh, box_size: float = 1.1,
                              axis: str = "qp", dtype: torch.dtype = torch.float32,
                              device=None) -> torch.Tensor:
    """The dense (res+1)^3 grid with the query points sharded over `axis`
    of `mesh`: each rank decodes its 1/n of the padded corner points in one
    call, and every rank returns the assembled grid (dense_grid_values'
    values)."""
    pts = grid_coordinates(resolution, box_size, dtype, device)
    n_pts = pts.shape[0]
    chunk = pad_to_multiple(n_pts, mesh_size(mesh, axis))
    vals = _eval_points(lambda p: decode(p[0])[None], pts[None], chunk, mesh, axis)
    n = resolution + 1
    return vals.reshape(n, n, n)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a (L along dim), b (L - 1) -> (2L - 1): a0 b0 a1 b1 ... a_{L-1}."""
    shape = list(a.shape)
    shape[dim] = 2 * a.shape[dim] - 1
    out = a.new_empty(shape)
    o = out.movedim(dim, 0)
    o[0::2] = a.movedim(dim, 0)
    o[1::2] = b.movedim(dim, 0)
    return out


def _double_resolution(v: torch.Tensor) -> torch.Tensor:
    """Trilinear x2 upsampling of (B, n, n, n) corner grids to 2n - 1 per
    axis, exact at the existing corners: each axis in turn (1, 2, 3) gets
    the midpoints 0.5 * (a[:-1] + a[1:])."""
    for dim in (1, 2, 3):
        L = v.shape[dim]
        mid = 0.5 * (v.narrow(dim, 0, L - 1) + v.narrow(dim, 1, L - 1))
        v = _interleave(v, mid, dim)
    return v


def _active_cells(values: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, r, r, r) mask of the cells whose eight corners are not all on one
    side of the threshold, dilated by one cell along each axis."""
    occ = values > threshold
    all_in = any_in = occ
    for dim in (1, 2, 3):
        L = all_in.shape[dim]
        all_in = all_in.narrow(dim, 0, L - 1) & all_in.narrow(dim, 1, L - 1)
        any_in = any_in.narrow(dim, 0, L - 1) | any_in.narrow(dim, 1, L - 1)
    active = any_in & ~all_in
    for dim in (1, 2, 3):
        L = active.shape[dim]
        out = active.clone()
        out.narrow(dim, 1, L - 1).logical_or_(active.narrow(dim, 0, L - 1))
        out.narrow(dim, 0, L - 1).logical_or_(active.narrow(dim, 1, L - 1))
        active = out
    return active


def _points_touching_active(active: torch.Tensor) -> torch.Tensor:
    """(B, 2r+1, 2r+1, 2r+1) mask of the fine points in or on an active
    coarse cell: along each axis fine point 2c touches cells c - 1 and c,
    fine point 2c + 1 cell c."""
    for dim in (1, 2, 3):
        L = active.shape[dim]
        shape = list(active.shape)
        shape[dim] = L + 1
        even = active.new_zeros(shape)
        even.narrow(dim, 0, L).logical_or_(active)
        even.narrow(dim, 1, L).logical_or_(active)
        active = _interleave(even, active, dim)
    return active


def _first_active(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap) lattice indices of the first `cap` true entries of each row
    of the (B, big) mask, in order, then `big` in the slots left over: the
    first `cap` keys of JAX's sort of where(mask, index, big). Slot s takes
    the first index whose running count of true entries reaches s + 1."""
    count = torch.cumsum(mask, dim=1)
    want = torch.arange(1, cap + 1, device=mask.device).expand(mask.shape[0], cap)
    return torch.searchsorted(count, want.contiguous())


def _scatter(flat_up: torch.Tensor, idx_sel: torch.Tensor, src) -> torch.Tensor:
    """flat_up (B, big) with src written at idx_sel (B, cap); the unused
    slots' indices big + slot land in a tail that is cut off."""
    B, big = flat_up.shape
    out = torch.cat([flat_up, flat_up.new_empty((B, idx_sel.shape[1]))], dim=1)
    out.scatter_(1, idx_sel, src)
    return out[:, :big]


def _hierarchical(decode, B: int, device, resolution0: int, upsampling_steps: int,
                  threshold: float, box_size: float, chunk_size: int,
                  refine_cap_factor: int, dtype, select_mode: str, dedup: bool,
                  final_merge: str, mesh=None, shard_axis: str = "qp"):
    """The coarse-to-fine levels for B instances; decode: (B, M, 3) ->
    (B, M). Returns (values (B, n, n, n), stats) with stats["overflow"] and
    stats["n_active"] (B, steps) int32 and, with the host merge,
    stats["final_idx"] (B, cap) int32 and stats["final_vals"] (B, cap)."""
    with record_function("recon.decode_level0"):
        pts = grid_coordinates(resolution0, box_size, dtype, device)
        n = resolution0 + 1
        values = _eval_points(decode, pts.expand(B, -1, -1), chunk_size, mesh,
                              shard_axis)
        values = values.reshape(B, n, n, n)
    res = resolution0
    # dedup: the level-0 corners and every refined point are exact decodes,
    # which a later level does not spend its cap on again
    exact = torch.ones_like(values, dtype=torch.bool) if dedup else None
    overflow, active_counts = [], []
    final_idx = final_vals = None
    for step in range(upsampling_steps):
        last = step == upsampling_steps - 1
        with record_function("recon.select"):
            fine_mask = _points_touching_active(_active_cells(values, threshold))
            v_up = _double_resolution(values)
            res *= 2
            n = res + 1
            big = n * n * n
            cap = min(refine_cap_factor * n * n, big)
            if dedup:
                e_up = torch.zeros_like(fine_mask)
                e_up[:, 0::2, 0::2, 0::2] = exact
                flat_mask = (fine_mask & ~e_up).reshape(B, big)
            else:
                flat_mask = fine_mask.reshape(B, big)
            n_active = flat_mask.sum(dim=1, dtype=torch.int32)
            active_counts.append(n_active)
            overflow.append(torch.clamp_min(n_active - cap, 0))
            if select_mode == "packsort":
                top_idx = _first_active(flat_mask, cap)
                selected = top_idx < big
                idx_c = torch.clamp_max(top_idx, big - 1)
            else:
                closeness = -torch.abs(v_up.reshape(B, big) - threshold)
                score = torch.where(flat_mask, closeness,
                                    torch.full((), -float("inf"), dtype=closeness.dtype,
                                               device=device))
                # stable: among equal scores the lower index first, as
                # lax.top_k orders them
                top_score, top_idx = torch.sort(score, dim=1, descending=True,
                                                stable=True)
                top_score, idx_c = top_score[:, :cap], top_idx[:, :cap]
                selected = torch.isfinite(top_score)
            ijk = torch.stack([idx_c // (n * n), (idx_c // n) % n, idx_c % n], dim=-1)
            pts = (ijk.to(dtype) / res - 0.5) * box_size
            idx_sel = torch.where(
                selected, idx_c,
                big + torch.arange(cap, device=device, dtype=idx_c.dtype))
        with record_function("recon.decode_refine"):
            vals = _eval_points(decode, pts, chunk_size, mesh, shard_axis)
        if final_merge == "host" and last:
            values = v_up
            final_idx, final_vals = idx_sel.to(torch.int32), vals
            break
        with record_function("recon.scatter"):
            values = _scatter(v_up.reshape(B, big), idx_sel, vals).reshape(B, n, n, n)
            if dedup:
                exact = _scatter(e_up.reshape(B, big), idx_sel, True).reshape(B, n, n, n)

    def stacked(rows):
        if rows:
            return torch.stack(rows, dim=1)
        return torch.zeros((B, 0), dtype=torch.int32, device=device)

    stats = {"overflow": stacked(overflow), "n_active": stacked(active_counts)}
    if final_idx is not None:
        stats["final_idx"] = final_idx
        stats["final_vals"] = final_vals
    return values.contiguous(), stats


def _check_args(select_mode: str, final_merge: str, upsampling_steps: int) -> None:
    if select_mode not in _SELECT_MODES:
        raise ValueError(f"unknown select_mode {select_mode!r}")
    if final_merge not in _MERGES:
        raise ValueError(f"unknown final_merge {final_merge!r}")
    if final_merge == "host" and upsampling_steps == 0:
        raise ValueError(
            "final_merge='host' requires upsampling_steps >= 1 "
            "(with 0 steps there is no refine scatter to defer; "
            "use final_merge='device')"
        )


def hierarchical_grid_values(
    decode: Callable[[torch.Tensor], torch.Tensor],
    resolution0: int = 32,
    upsampling_steps: int = 2,
    threshold: float = 0.0,
    box_size: float = 1.1,
    chunk_size: int = 65536,
    refine_cap_factor: int = 20,
    dtype: torch.dtype = torch.float32,
    return_stats: bool = False,
    select_mode: str = "packsort",
    dedup: bool = True,
    final_merge: str = "device",
    device=None,
    mesh=None,
    shard_axis: str = "qp",
):
    """Coarse-to-fine value grid of one field, decode: (M, 3) -> (M,).

    Returns the (res_final+1)^3 grid, res_final = res0 * 2^steps: the dense
    grid at res0, then per step the trilinear x2 upsample with the points
    that touch a cell crossing the threshold (dilated by one cell) decoded
    anew, at most `cap = min(refine_cap_factor * n^2, n^3)` of them.
    `select_mode` "packsort" keeps the first `cap` active points in lattice
    order, "topk" the `cap` closest to the threshold (lower index first
    among ties); they select the same set while the cap does not bind.
    With `dedup` the points whose value is already a decode are not
    selected again. With `return_stats` also returns {"overflow": (steps,),
    "n_active": (steps,)} (active points dropped past the cap, active
    points before it); with `final_merge="host"` (which needs
    `return_stats`) the last level's scatter is left to the caller, and the
    grid is the unmerged upsample with stats["final_idx"] / ["final_vals"]
    for `apply_final_merge`. With `mesh`, every level's points (the dense
    level 0, then each refine level's `cap` points) are sharded over its
    `shard_axis`.
    """
    _check_args(select_mode, final_merge, upsampling_steps)
    if final_merge == "host" and not return_stats:
        raise ValueError("final_merge='host' requires return_stats=True "
                         "(the merge payload travels in stats)")
    values, stats = _hierarchical(
        lambda p: decode(p[0])[None], 1, resolve_device(device), resolution0,
        upsampling_steps, threshold, box_size, chunk_size, refine_cap_factor,
        dtype, select_mode, dedup, final_merge, mesh, shard_axis)
    if return_stats:
        return values[0], {k: v[0] for k, v in stats.items()}
    return values[0]


def batched_hierarchical_grid_values(
    logits_fn: Callable[[torch.Tensor, dict], torch.Tensor],
    codes: dict,
    resolution0: int = 32,
    upsampling_steps: int = 2,
    threshold: float = 0.0,
    box_size: float = 1.1,
    chunk_size: int = 65536,
    refine_cap_factor: int = 20,
    dtype: torch.dtype = torch.float32,
    select_mode: str = "packsort",
    dedup: bool = True,
    final_merge: str = "device",
):
    """Coarse-to-fine grids of a batch of B instances on the codes' device:
    `logits_fn(query (B, M, 3), codes) -> (B, M)`, `codes` with leading
    batch axis B. Returns (values (B, n, n, n), overflow (B, steps)) and,
    with `final_merge="host"`, also final_idx (B, cap) and final_vals
    (B, cap): per instance what `hierarchical_grid_values` returns, with
    every level's chunk of all instances decoded in one call."""
    _check_args(select_mode, final_merge, upsampling_steps)
    values, stats = _hierarchical(
        lambda q: logits_fn(q, codes), codes["s"].shape[0], codes["s"].device,
        resolution0, upsampling_steps, threshold, box_size, chunk_size,
        refine_cap_factor, dtype, select_mode, dedup, final_merge)
    if final_merge == "host":
        return values, stats["overflow"], stats["final_idx"], stats["final_vals"]
    return values, stats["overflow"]


def apply_final_merge(grid, final_idx, final_vals) -> np.ndarray:
    """Host side of final_merge="host": the (n, n, n) grid with the last
    level's values written at their indices; indices >= n^3 are unused
    slots and are dropped."""
    grid, idx, vals = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                       for x in (grid, final_idx, final_vals))
    flat = grid.reshape(-1).copy()
    m = idx < flat.size
    flat[idx[m]] = vals[m]
    return flat.reshape(grid.shape)
