"""The scene-pair pipeline: FPS -> encode -> match -> Kabsch -> (SE(3)
refinement with `optim`) -> ICP.

Counterpart of livingscenes_tpu/solver/pipeline.py
(`build_scene_pair_pipeline`) with `recon=False`, on one device. Scene
pairs are independent, so every instance of every scene goes through each
stage in one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.cuda_fps import fps_auto
from .matcher import sequential_matcher
from .registration import RegistrationConfig, solve_pairwise_registration


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    optim: bool = False  # run the SE(3) refinement of every pair
    registration: RegistrationConfig = RegistrationConfig()
    # Inputs are padded per-instance clouds with validity masks, each
    # FPS-downsampled to the encoder's input size first.
    encode_fps: bool = False
    recon: bool = False  # the reconstruction leg: a later slice


def build_scene_pair_pipeline(model, cfg: PipelineConfig = PipelineConfig()):
    """Return `pipeline(ref_pc, rescan_pc[, ref_mask, rescan_mask]) -> dict`
    running on the model's device, with

      matches0 (S, O)          ref -> rescan instance matching, -1 unmatched
      R (S, O, 3, 3), t (S, O, 3, 1)   registration of every ref instance
        to its matched partner (unmatched rows use partner 0)

    ref_pc / rescan_pc are (S, O, N, 3); with `encode_fps` the masks are
    (S, O, N) and N may exceed the encoder's input size. Inputs may be
    numpy arrays or tensors; they are moved to the model's device.
    """
    if cfg.recon:
        raise NotImplementedError("recon=True is the recon slice of the port")

    # The refinement differentiates its loss with respect to the pose, on
    # tensors made here, which inference mode would not let it save.
    grad_mode = torch.no_grad if cfg.optim else torch.inference_mode

    @grad_mode()
    def pipeline(ref_pc, rescan_pc, ref_mask=None, rescan_mask=None):
        dev, dtype = model.device, model.dtype
        ref_pc = torch.as_tensor(ref_pc, device=dev, dtype=dtype)
        rescan_pc = torch.as_tensor(rescan_pc, device=dev, dtype=dtype)
        S, O, N, _ = ref_pc.shape
        flat_ref = ref_pc.reshape(S * O, N, 3)
        flat_res = rescan_pc.reshape(S * O, N, 3)
        if cfg.encode_fps:
            # both sides in one batch: one FPS launch over twice the clouds
            masks = [_flat_mask(m, dev, S * O, N) for m in (ref_mask, rescan_mask)]
            mask = None if all(m is None for m in masks) else torch.cat([
                torch.ones((S * O, N), dtype=torch.bool, device=dev) if m is None
                else m for m in masks])
            sampled, _ = fps_auto(torch.cat([flat_ref, flat_res]),
                                  model.config.n_pcl, mask=mask)
            flat_ref, flat_res = sampled[:S * O], sampled[S * O:]
        codes_ref = model.encode(flat_ref)
        codes_res = model.encode(flat_res)

        matches = sequential_matcher(
            codes_ref["z_inv"].reshape(S, O, -1),
            codes_res["z_inv"].reshape(S, O, -1),
        )["matches0"]
        partner = torch.where(matches >= 0, matches, 0)
        flat_partner = (partner + torch.arange(S, device=dev)[:, None] * O).reshape(-1)
        pc2 = flat_res[flat_partner]
        c2 = {k: v[flat_partner] for k, v in codes_res.items()}
        R, t = solve_pairwise_registration(
            model, flat_ref, pc2, codes_ref, c2, optim=cfg.optim,
            cfg=cfg.registration,
        )
        return {
            "matches0": matches,
            "R": R.reshape(S, O, 3, 3),
            "t": t.reshape(S, O, 3, 1),
        }

    return pipeline


def _flat_mask(mask, dev, B: int, N: int) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return torch.as_tensor(mask, device=dev, dtype=torch.bool).reshape(B, N)
