"""The training model: the SIM(3) shape prior's reconstruction losses.

Counterpart of livingscenes_tpu/models/sim3recon.py (`TrainLossConfig`,
`SIM3Recon`). The training data is canonically normalized by the dataset,
so the encoder sees the centroid-subtracted (optionally centre-jittered)
cloud, with no top-5 scale normalization, and its scale head is regressed
toward 1:

  batch_loss = w_uni L1_near/far(uni) + w_nss L1_near/far(nss)
             + w_s |pred_scale - 1| + w_t ||pred_center||_1

where errors below loss_th weigh loss_near_lambda and the others
loss_far_lambda. `val_iou` is the occupancy IoU on eval points, the
model-selection metric. Randomness (with `rot_aug` the rotations, then the
centre jitter, then the decoder's dropout) comes from one `torch.Generator`
the caller passes; with none, the loss is deterministic.

The model's options (ShapePriorConfig: center_pred, the decoder types,
use_pe, the encoder types) reach the loss through the encoder's outputs
and decode_sdf. Options of the loss, each off in every shipped config:
- `rot_aug`: one uniform random rotation per cloud, applied to the inputs
  and to the queries alike (the decoder reads the queries through the
  rotation-invariant <q, z_so3>, so a query left unrotated would be
  supervised at the wrong place); from the generator, or passed in.
- `decoder_bf16`: the decoder's products in bfloat16 (decode_sdf's
  matmul_dtype), the gradient reaching the float32 parameters.
- the class head (ShapePriorConfig.use_cls) with a batch's "class"
  labels: w_cls times the cross entropy of softmax(logits), the reference's
  double softmax (sim3sdf_vanilla.py:340-347), with its accuracy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import se3
from ..parallel.sharding import batch_draw
from .shape_prior import ShapePrior, ShapePriorConfig

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainLossConfig:
    """Defaults mirror configs/3rscan/dgcnn_attn_inner.yaml:9-27."""

    w_uni: float = 0.5
    w_nss: float = 0.5
    w_s: float = 0.001
    w_t: float = 0.2
    loss_th: float = 0.1
    loss_near_lambda: float = 1.0
    loss_far_lambda: float = 0.5
    center_aug_std: float = 0.05
    rot_aug: bool = False
    iou_threshold: float = 0.5
    w_cls: float = 1.0
    decoder_bf16: bool = False


class SIM3Recon:
    """The loss and the validation metric around a ShapePrior (`prior`, an
    nn.Module holding the encoder and the decoder)."""

    def __init__(self, config: ShapePriorConfig | None = None,
                 loss_config: TrainLossConfig = TrainLossConfig(),
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 0):
        self.prior = ShapePrior(config, device=device, dtype=dtype, seed=seed)
        self.loss_cfg = loss_config

    @property
    def config(self) -> ShapePriorConfig:
        return self.prior.config

    def _encode_training(self, inputs: torch.Tensor,
                         generator: Optional[torch.Generator], train: bool):
        """Centroid split, optional centre jitter, the raw encoder call.
        Returns (codes, pred_scale, centroid + predicted centre); an encoder
        of three outputs (no centre head) leaves the centroid as it is."""
        centroid = torch.mean(inputs, dim=1)  # (B, 3)
        std = self.loss_cfg.center_aug_std
        if train and std > 0 and generator is not None:
            noise = batch_draw(torch.randn, centroid.shape, generator,
                               device=centroid.device, dtype=centroid.dtype)
            centroid = centroid + std * noise
        out = self.prior.encoder(inputs - centroid[:, None, :])
        if len(out) == 4:
            center, pred_scale, z_so3, z_inv = out
            centroid = center[:, 0, :] + centroid
        else:
            pred_scale, z_so3, z_inv = out
        codes = {"z_so3": z_so3, "z_inv": z_inv, "s": pred_scale,
                 "t": centroid[:, None, :]}
        return codes, pred_scale, centroid

    def loss(self, batch: Batch, generator: Optional[torch.Generator] = None,
             train: bool = True, rotations: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(batch_loss, metrics) of a batch of tensors on the model's device:
        inputs (B, N, 3); points_uni (B, Qu, 3), points_uni_value (B, Qu);
        points_nss (B, Qn, 3), points_nss_value (B, Qn); with the class head
        optionally "class" (B,). With `train` and a generator the centre is
        jittered and the decoder drops out; the decoder's mode is set to
        `train`. With `rot_aug` the clouds and queries are rotated by
        `rotations` (B, 3, 3), or else by rotations drawn from the generator
        first; with neither, they are not rotated."""
        cfg = self.loss_cfg
        self.prior.train(train)
        inputs = batch["inputs"]
        query = torch.cat([batch["points_uni"], batch["points_nss"]], dim=1)
        if cfg.rot_aug and (rotations is not None or generator is not None):
            if rotations is None:
                rotations = se3.random_rotation(
                    generator, (inputs.shape[0],), dtype=inputs.dtype,
                    device=inputs.device)
            R = rotations.to(inputs.dtype)
            inputs = torch.einsum("bij,bnj->bni", R, inputs)
            query = torch.einsum("bij,bnj->bni", R, query)
        codes, pred_scale, centroid = self._encode_training(inputs, generator, train)
        loss_scale = torch.mean(torch.abs(pred_scale - 1.0))
        loss_center = torch.mean(torch.sum(torch.abs(centroid), dim=-1))
        error_center = torch.linalg.norm(centroid, dim=-1)
        sdf_gt = torch.cat([batch["points_uni_value"], batch["points_nss_value"]],
                           dim=1)
        sdf_hat = self.prior.decode_sdf(
            query, codes, generator if train else None,
            matmul_dtype=torch.bfloat16 if cfg.decoder_bf16 else None)

        err = torch.abs(sdf_hat - sdf_gt)
        near = (err < cfg.loss_th).to(err.dtype).detach()
        loss_i = err * (near * cfg.loss_near_lambda
                        + (1.0 - near) * cfg.loss_far_lambda)
        n_uni = batch["points_uni"].shape[1]
        n_nss = batch["points_nss"].shape[1]
        zero = torch.zeros((), dtype=err.dtype, device=err.device)
        uni_loss = torch.mean(loss_i[:, :n_uni])
        nss_loss = torch.mean(loss_i[:, n_uni:]) if n_nss > 0 else zero
        batch_loss = (cfg.w_uni * uni_loss + cfg.w_nss * nss_loss
                      + cfg.w_s * loss_scale + cfg.w_t * loss_center)
        cls_metrics = {}
        if self.prior.cls_head is not None and "class" in batch:
            probs = torch.softmax(self.prior.classify(codes), dim=-1)
            logp = torch.log_softmax(probs, dim=-1)  # the double softmax
            gt = batch["class"].long()
            loss_cls = -torch.mean(torch.gather(logp, 1, gt[:, None]))
            acc = torch.mean((torch.argmax(probs, dim=-1) == gt).to(err.dtype))
            batch_loss = batch_loss + cfg.w_cls * loss_cls
            cls_metrics = {"loss_cls": loss_cls, "metric_bs_cls_acc": acc}
        metrics = {
            "batch_loss": batch_loss,
            "loss_recon_uni": uni_loss,
            "loss_recon_nss": nss_loss,
            "loss_s": loss_scale,
            "loss_t": loss_center,
            "metric_t": torch.mean(error_center),
            "metric_recon_uni_error": torch.mean(err[:, :n_uni]),
            "metric_recon_nss_error": (torch.mean(err[:, n_uni:])
                                       if n_nss > 0 else zero),
            "scale_mean": torch.mean(pred_scale),
            **cls_metrics,
        }
        return batch_loss, metrics

    def val_iou(self, batch: Batch) -> torch.Tensor:
        """Per-instance occupancy IoU on eval_points (B, E, 3) against
        eval_points_occ (B, E)."""
        self.prior.eval()
        codes, _, _ = self._encode_training(batch["inputs"], None, train=False)
        logits = self.prior.occupancy_logits(batch["eval_points"], codes)
        occ_pred = torch.sigmoid(logits) >= self.loss_cfg.iou_threshold
        occ_gt = batch["eval_points_occ"] > 0.5
        inter = torch.sum(occ_pred & occ_gt, dim=-1)
        union = torch.sum(occ_pred | occ_gt, dim=-1)
        return inter / torch.clamp_min(union, 1)
