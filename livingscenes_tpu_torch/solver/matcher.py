"""Greedy instance matching on SIM(3)-invariant embeddings.

Counterpart of livingscenes_tpu/solver/matcher.py (`_l2_normalize`,
`_greedy_assign`, `sequential_matcher`), batched over scenes: each round
takes the first occurrence of the flat argmax of the cosine scores and masks
its row and column out. Unmatched entries are -1.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

_NEG = -1e30


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), 1e-12)


def _greedy_assign(
    score: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """score (P, S, T) for P scenes; masks (P, S), (P, T) bool or None."""
    P, S, T = score.shape
    dev = score.device
    if src_mask is None:
        src_mask = torch.ones((P, S), dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones((P, T), dtype=torch.bool, device=dev)
    n_iter = torch.minimum(src_mask.sum(-1), tgt_mask.sum(-1))  # (P,)
    masked = torch.where(src_mask[:, :, None] & tgt_mask[:, None, :], score, _NEG)
    m0 = torch.full((P, S), -1, dtype=torch.long, device=dev)
    m1 = torch.full((P, T), -1, dtype=torch.long, device=dev)
    scenes = torch.arange(P, device=dev)
    for i in range(min(S, T)):
        flat = torch.argmax(masked.reshape(P, S * T), dim=-1)
        row, col = flat // T, flat % T
        active = i < n_iter
        m0[scenes, row] = torch.where(active, col, m0[scenes, row])
        m1[scenes, col] = torch.where(active, row, m1[scenes, col])
        row_hit = torch.arange(S, device=dev)[None, :] == row[:, None]
        col_hit = torch.arange(T, device=dev)[None, :] == col[:, None]
        hit = (row_hit[:, :, None] | col_hit[:, None, :]) & active[:, None, None]
        masked = torch.where(hit, _NEG, masked)
    return {"matches0": m0, "matches1": m1}


def sequential_matcher(
    z_inv_src: torch.Tensor,
    z_inv_tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy cosine-similarity matcher. z_inv_* (S, C) / (T, C), or with a
    leading scene axis (P, S, C) / (P, T, C) (masks likewise)."""
    batched = z_inv_src.dim() == 3
    if not batched:
        z_inv_src, z_inv_tgt = z_inv_src[None], z_inv_tgt[None]
        src_mask = None if src_mask is None else src_mask[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
    score = torch.matmul(_l2_normalize(z_inv_src), _l2_normalize(z_inv_tgt).transpose(-1, -2))
    out = _greedy_assign(score, src_mask, tgt_mask)
    if not batched:
        out = {k: v[0] for k, v in out.items()}
    return out
