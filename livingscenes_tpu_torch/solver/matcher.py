"""Instance matching on SIM(3)-invariant embeddings.

Counterpart of livingscenes_tpu/solver/matcher.py: the greedy
`sequential_matcher` (also batched over scenes: each round takes the first
occurrence of the flat argmax of the scores and masks its row and column
out), the mutual nearest neighbour `nn_matcher`, the dustbin transport
`sinkhorn_matcher`, the greedy `sim3_seq_matcher` and `eq_seq_matcher` on
Kabsch residuals of the SO(3) features, and `solve_object_matching` over the
five. Every matcher returns {"matches0": (S,), "matches1": (T,)} int32, -1
where unmatched; an argmax takes the first index among ties.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import se3
from ..ops.sinkhorn import log_optimal_transport

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
    m0 = torch.full((P, S), -1, dtype=torch.int32, device=dev)
    m1 = torch.full((P, T), -1, dtype=torch.int32, device=dev)
    scenes = torch.arange(P, device=dev)
    for i in range(min(S, T)):
        flat = torch.argmax(masked.reshape(P, S * T), dim=-1)
        row, col = flat // T, flat % T
        active = i < n_iter
        m0[scenes, row] = torch.where(active, col.int(), m0[scenes, row])
        m1[scenes, col] = torch.where(active, row.int(), m1[scenes, col])
        row_hit = torch.arange(S, device=dev)[None, :] == row[:, None]
        col_hit = torch.arange(T, device=dev)[None, :] == col[:, None]
        hit = (row_hit[:, :, None] | col_hit[:, None, :]) & active[:, None, None]
        masked = torch.where(hit, _NEG, masked)
    return {"matches0": m0, "matches1": m1}


def _greedy_one(score, src_mask, tgt_mask) -> Dict[str, torch.Tensor]:
    """_greedy_assign of one scene's (S, T) scores."""
    out = _greedy_assign(score[None], None if src_mask is None else src_mask[None],
                         None if tgt_mask is None else tgt_mask[None])
    return {k: v[0] for k, v in out.items()}


def sequential_matcher(
    z_inv_src: torch.Tensor,
    z_inv_tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy cosine-similarity matcher. z_inv_* (S, C) / (T, C), or with a
    leading scene axis (P, S, C) / (P, T, C) (masks likewise)."""
    score = torch.matmul(_l2_normalize(z_inv_src), _l2_normalize(z_inv_tgt).transpose(-1, -2))
    if score.dim() == 3:
        return _greedy_assign(score, src_mask, tgt_mask)
    return _greedy_one(score, src_mask, tgt_mask)


def _mutual_check(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """-1 where a match of m0 is not matched back by m1."""
    inds = torch.arange(m0.shape[0], device=m0.device)
    loop = m1[torch.where(m0 > -1, m0, 0).long()]
    return torch.where((m0 > -1) & (inds == loop), m0, -1)


def nn_matcher(
    z_inv_src: torch.Tensor,
    z_inv_tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Mutual nearest neighbours by cosine similarity; z_inv_* (S, C),
    (T, C), masks (S,), (T,) bool or None."""
    sim = _l2_normalize(z_inv_src) @ _l2_normalize(z_inv_tgt).T
    if src_mask is not None:
        sim = torch.where(src_mask[:, None], sim, _NEG)
    if tgt_mask is not None:
        sim = torch.where(tgt_mask[None, :], sim, _NEG)
    m0 = torch.argmax(sim, dim=1).int()
    m1 = torch.argmax(sim, dim=0).int()
    if src_mask is not None:
        m0 = torch.where(src_mask, m0, -1)
    if tgt_mask is not None:
        m1 = torch.where(tgt_mask, m1, -1)
    m0c = _mutual_check(m0, m1)
    return {"matches0": m0c, "matches1": _mutual_check(m1, m0c)}


def sinkhorn_matcher(
    z_inv_src: torch.Tensor,
    z_inv_tgt: torch.Tensor,
    desc_dim: int = 256,
    match_threshold: float = 0.0,
    iters: int = 100,
) -> Dict[str, torch.Tensor]:
    """Mutual argmax of a dustbin transport (log_optimal_transport, dustbin
    score 1) of the cosine scores over sqrt(desc_dim), kept where the
    coupling's exponent exceeds `match_threshold`."""
    src, tgt = _l2_normalize(z_inv_src), _l2_normalize(z_inv_tgt)
    scale = torch.sqrt(torch.tensor(desc_dim, dtype=src.dtype, device=src.device))
    Z = log_optimal_transport((src @ tgt.T)[None] / scale, 1.0, iters)
    core = Z[:, :-1, :-1]
    max0, indices0 = core.amax(dim=2), torch.argmax(core, dim=2)
    indices1 = torch.argmax(core, dim=1)
    S, T = core.shape[1], core.shape[2]
    mutual0 = torch.arange(S, device=src.device)[None] == torch.gather(indices1, 1, indices0)
    mutual1 = torch.arange(T, device=src.device)[None] == torch.gather(indices0, 1, indices1)
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    valid0 = mutual0 & (mscores0 > match_threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    return {"matches0": torch.where(valid0, indices0, -1)[0].int(),
            "matches1": torch.where(valid1, indices1, -1)[0].int()}


def _kabsch_residual_matrix(z_so3_src: torch.Tensor, z_so3_tgt: torch.Tensor) -> torch.Tensor:
    """The mean Kabsch residual of every (src, tgt) pair of SO(3) features
    (S, C, 3), (T, C, 3) -> (S, T), from one batched fit of the S * T
    pairs."""
    S, T = z_so3_src.shape[0], z_so3_tgt.shape[0]
    a = z_so3_src[:, None].expand(S, T, *z_so3_src.shape[1:])
    b = z_so3_tgt[None].expand(S, T, *z_so3_tgt.shape[1:])
    _, _, res = se3.kabsch(a.reshape(S * T, *a.shape[2:]), b.reshape(S * T, *b.shape[2:]))
    return torch.mean(res, dim=-1).reshape(S, T)


def sim3_seq_matcher(
    src_codes: Dict[str, torch.Tensor],
    tgt_codes: Dict[str, torch.Tensor],
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy matching on cosine similarity over (Kabsch residual + 1e-5)."""
    sim = _l2_normalize(src_codes["z_inv"]) @ _l2_normalize(tgt_codes["z_inv"]).T
    res = _kabsch_residual_matrix(src_codes["z_so3"], tgt_codes["z_so3"])
    return _greedy_one(sim / (res + 1e-5), src_mask, tgt_mask)


def eq_seq_matcher(
    src_codes: Dict[str, torch.Tensor],
    tgt_codes: Dict[str, torch.Tensor],
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy matching on 1 / (Kabsch residual + 1e-5)."""
    res = _kabsch_residual_matrix(src_codes["z_so3"], tgt_codes["z_so3"])
    return _greedy_one(1.0 / (res + 1e-5), src_mask, tgt_mask)


def solve_object_matching(
    src_codes: Dict[str, torch.Tensor],
    tgt_codes: Dict[str, torch.Tensor],
    method: str = "sequential",
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One scene's matching by `method`: "sequential", "nn", "sinkhorn" (no
    masks), "sim3_seq" or "eq_seq"."""
    if method == "sequential":
        return sequential_matcher(src_codes["z_inv"], tgt_codes["z_inv"], src_mask, tgt_mask)
    if method == "nn":
        return nn_matcher(src_codes["z_inv"], tgt_codes["z_inv"], src_mask, tgt_mask)
    if method == "sinkhorn":
        return sinkhorn_matcher(src_codes["z_inv"], tgt_codes["z_inv"])
    if method == "sim3_seq":
        return sim3_seq_matcher(src_codes, tgt_codes, src_mask, tgt_mask)
    if method == "eq_seq":
        return eq_seq_matcher(src_codes, tgt_codes, src_mask, tgt_mask)
    raise ValueError(f"unknown matching method: {method}")
