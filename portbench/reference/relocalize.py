"""The scene-pair relocalization of MORE (Living Scenes, Zhu et al. CVPR
2024; the reference code's configs/more_3rscan.yaml), in plain PyTorch:
every padded instance is cut to the encoder's input size by masked FPS,
encoded, the instances of each scene pair are matched greedily on their
invariant codes, each ref instance is registered to its partner by
Kabsch on (z_so3 + t), then by ICP, and the ICP pose is kept only where
it lowers the symmetric chamfer distance to the partner.

The encoder runs in blocks of `block` clouds so that its edge tensors fit.
"""
from __future__ import annotations

import torch

from . import geometry as geo
from .encoders import encode


def encode_blocks(w, clouds, cfg, block: int) -> dict:
    parts = [encode(w, clouds[i:i + block], cfg) for i in range(0, len(clouds), block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def relocalize(w: dict, cfg: dict, ref, res, ref_mask, res_mask, block: int = 32,
               icp_iterations: int = 100) -> dict:
    """ref, res (S, O, N, 3) with masks (S, O, N) -> {"matches0" (S, O),
    "R" (S, O, 3, 3), "t" (S, O, 3, 1), "codes_ref", "codes_res" (flat over
    S * O), "ref_pc", "res_pc" ((S * O, n_pcl, 3), the sampled clouds)}."""
    S, O, N, _ = ref.shape
    n = cfg["n_pcl"]
    flat = torch.cat([ref.reshape(S * O, N, 3), res.reshape(S * O, N, 3)])
    mask = torch.cat([ref_mask.reshape(S * O, N), res_mask.reshape(S * O, N)])
    sampled = geo.gather(flat, geo.fps(flat, n, mask))
    ref_pc, res_pc = sampled[:S * O], sampled[S * O:]
    c_ref = encode_blocks(w, ref_pc, cfg, block)
    c_res = encode_blocks(w, res_pc, cfg, block)
    matches = geo.greedy_match(c_ref["z_inv"].reshape(S, O, -1),
                               c_res["z_inv"].reshape(S, O, -1))
    partner = (matches.clamp_min(0)
               + O * torch.arange(S, device=ref.device)[:, None]).reshape(-1)
    tgt = res_pc[partner]
    R0, t0 = geo.kabsch(c_ref["z_so3"] + c_ref["t"],
                        c_res["z_so3"][partner] + c_res["t"][partner])
    R1, t1 = geo.icp(ref_pc, tgt, R0, t0, icp_iterations)
    take = (geo.chamfer(geo.move(R1, t1, ref_pc), tgt)
            < geo.chamfer(geo.move(R0, t0, ref_pc), tgt))[:, None, None]
    R, t = torch.where(take, R1, R0), torch.where(take, t1, t0)
    return {"matches0": matches, "R": R.reshape(S, O, 3, 3),
            "t": t.reshape(S, O, 3, 1), "codes_ref": c_ref, "codes_res": c_res,
            "ref_pc": ref_pc, "res_pc": res_pc}
