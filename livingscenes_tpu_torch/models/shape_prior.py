"""The shape prior: SIM(3) pre-normalization, the encoder, the invariant
SDF field, and code transport.

Counterpart of livingscenes_tpu/models/shape_prior.py (`ShapePriorConfig`
with its encoder and decoder registries, `ShapePrior.normalize_input`,
`encode`, `encode_fps`, `invariant_query` with the positional-encoding
tail, `decode_sdf`, `occupancy_logits`, `classify` with `ClsHead`,
`slice_codes`, `transform_codes`). Codes are the dict {"z_so3": (B, C, 3),
"z_inv": (B, C), "s": (B,), "t": (B, 1, 3)}. Two behaviours of the
reference stay: a cloud of identical points gives NaN codes (its scale
statistic is 0), and `t` is SE(3)-equivariant but not SIM(3)-equivariant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..nn.deepsdf import DecoderCat, DeepSDFDecoder, Dense, WNDense
from ..nn.encoders import DGCNN, LayerNorm, PCNet, PointNet, VecDGCNN, VecDGCNNV2
from ..nn.vec_dgcnn_attn import VecDGCNNAttn
from ..nn.vec_layers import VecLinear
from ..ops.cuda_fps import fps_auto
from ..ops.cuda_knn import knn_with_topk_scale
from ..ops.cuda_scale import (
    top_k_mean_pairwise_distance,
    top_k_mean_pairwise_distance_plain,
)

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ShapePriorConfig:
    """The production hyperparameters of encoder and decoder
    (configs/3rscan/dgcnn_attn_inner.yaml), and JAX's options, each with
    its JAX name and default."""

    c_dim: int = 256
    num_layers: int = 7
    feat_dim: tuple = (32, 32, 64, 64, 128, 256, 512)
    down_sample_layers: tuple = (2, 4, 5)
    down_sample_factor: tuple = (2, 4, 4)
    atten_start_layer: int = 2
    atten_multi_head_c: int = 16
    num_knn: int = 16
    scale_factor: float = 64000.0
    # the attention encoder's centre head, and its scaling by scale_factor
    center_pred: bool = True
    center_pred_scale: bool = True
    # JAX's approximate top-k on the TPU; the port's kNN is exact on every
    # device, as JAX's is off the TPU, so this field changes nothing
    approx_knn: bool = True
    # bfloat16 operands in the attention encoder's unfused layers 0 and 1
    # (with pallas_attention off; see nn/vec_dgcnn_attn.py)
    mixed_precision: bool = False
    # "vecdgcnn_atten" (VecDGCNNAttn) or an ablation encoder of
    # nn/encoders.py: "vecdgcnn", "vecdgcnn2", "dgcnn", "pointnet", "pcnet"
    encoder_type: str = "vecdgcnn_atten"
    # "inner_deepsdf" or "deepsdf" (DeepSDFDecoder), "inner" or "inv_mlp"
    # (DecoderCat)
    decoder_type: str = "inner_deepsdf"
    decoder_dims: tuple = (768,) * 8
    decoder_dropout_prob: float = 0.2
    decoder_latent_in: tuple = (4,)
    sdf2occ_factor: float = -1.0
    n_pcl: int = 1024  # encoder input size
    # the category classifier on z_inv (ClsHead)
    use_cls: bool = False
    num_cates: int = 7
    # the positional encoding of the query: z_so3 projected to pe_src
    # equivariant axes (pe_projector, an se3 VecLinear), <q, axes> encoded
    # with sin and cos at pe_pow octaves and appended to the decoder input
    use_pe: bool = False
    pe_src: int = 32
    pe_pow: int = 4
    # the O(3)-frame head: z_so3 becomes a (B, 3, 3) orthogonal matrix
    z_so3_as_Omtx: bool = False
    # The fused path (the JAX field's name): on the card the encoder's
    # layers run as fused CUDA kernels and `encode` takes the scale (and,
    # for the attention encoder at N a multiple of min(256, N), the layer-0
    # graph) from a kernel; on the CPU the plain versions of the same
    # functions run. The parameters do not depend on it.
    pallas_attention: bool = False
    # JAX's parity mode: turns pallas_attention and mixed_precision off
    parity: bool = False

    @property
    def fused(self) -> bool:
        """Whether the fused path is on: pallas_attention without parity."""
        return self.pallas_attention and not self.parity

    def build_encoder(self) -> nn.Module:
        """The encoder registry; an unknown encoder_type raises."""
        if self.encoder_type == "vecdgcnn_atten":
            return VecDGCNNAttn(
                c_dim=self.c_dim,
                num_layers=self.num_layers,
                feat_dim=self.feat_dim,
                down_sample_layers=self.down_sample_layers,
                down_sample_factor=self.down_sample_factor,
                atten_start_layer=self.atten_start_layer,
                atten_multi_head_c=self.atten_multi_head_c,
                num_knn=self.num_knn,
                scale_factor=self.scale_factor,
                center_pred=self.center_pred,
                center_pred_scale=self.center_pred_scale,
                mixed_precision=self.mixed_precision and not self.parity,
                z_so3_as_Omtx=self.z_so3_as_Omtx,
                pallas_attention=self.fused,
            )
        if self.encoder_type == "vecdgcnn":
            return VecDGCNN(c_dim=self.c_dim, first_layer_knn=self.num_knn,
                            scale_factor=self.scale_factor)
        if self.encoder_type == "vecdgcnn2":
            return VecDGCNNV2(c_dim=self.c_dim, num_knn=self.num_knn,
                              scale_factor=self.scale_factor)
        if self.encoder_type == "dgcnn":
            return DGCNN(c_dim=self.c_dim, num_knn=self.num_knn)
        if self.encoder_type == "pointnet":
            return PointNet(c_dim=self.c_dim)
        if self.encoder_type == "pcnet":
            return PCNet(output_dim=self.c_dim)
        raise ValueError(f"unknown encoder_type {self.encoder_type}")

    def build_decoder(self) -> nn.Module:
        """The decoder registry; an unknown decoder_type raises."""
        if self.decoder_type in ("inner_deepsdf", "deepsdf"):
            return DeepSDFDecoder(
                latent_size=self.c_dim,
                dims=self.decoder_dims,
                dropout_prob=self.decoder_dropout_prob,
                latent_in=self.decoder_latent_in,
                pe_dim=self.c_dim + 1 + self.pe_channels,
            )
        if self.decoder_type in ("inner", "inv_mlp"):
            return DecoderCat(input_dim=2 * self.c_dim + 1 + self.pe_channels)
        raise ValueError(f"unknown decoder_type {self.decoder_type}")

    @property
    def pe_channels(self) -> int:
        """The invariant query's channels added by the positional encoding."""
        return self.pe_src * (1 + 2 * self.pe_pow) if self.use_pe else 0


class ClsHead(nn.Module):
    """The category classifier on the invariant embedding: Linear, Sigmoid,
    Linear, Sigmoid, Linear (the reference's model_utils.py:131-146);
    (B, c_dim) -> (B, num_cates) logits. The layers keep flax's names and
    (in, out) kernels."""

    def __init__(self, c_dim: int = 256, num_cates: int = 7):
        super().__init__()
        self.lin0 = Dense(c_dim, c_dim)
        self.lin1 = Dense(c_dim, c_dim)
        self.lin2 = Dense(c_dim, num_cates)

    def forward(self, z_inv: torch.Tensor) -> torch.Tensor:
        h = torch.sigmoid(self.lin0(z_inv))
        h = torch.sigmoid(self.lin1(h))
        return self.lin2(h)


class ShapePrior(nn.Module):
    """Encoder and decoder (with `use_cls` the category head `cls_head`,
    with `use_pe` the projector `pe_projector`) with their parameters, on
    one device.

    `device` defaults to the card and raises without one; pass
    `device="cpu"` to run on the CPU. Weights start uniform in
    +-1/sqrt(fan_in), drawn from a `torch.Generator` seeded with `seed`;
    load trained ones with `load_state_dict(params_from_jax(...))`.
    """

    def __init__(self, config: ShapePriorConfig | None = None, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config or ShapePriorConfig()
        device = resolve_device(device)
        c = self.config
        self.encoder = c.build_encoder()
        self.decoder = c.build_decoder()
        self.cls_head = ClsHead(c.c_dim, c.num_cates) if c.use_cls else None
        # the reference's VecLinear(c_dim, pe_src) in its default se3 mode
        self.pe_projector = (VecLinear(c.c_dim, c.pe_src, mode="se3")
                             if c.use_pe else None)
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (VecLinear, WNDense, Dense, LayerNorm)):
                module.reset_parameters(gen)
        self.eval()
        self.to(device=device, dtype=dtype)
        # matmul dtype -> (the parameters' (pointer, version) pairs, the
        # decoder's parameters cast to it); see _cast_decoder_state
        self._cast_decoder = {}

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def normalize_input(self, pc: torch.Tensor):
        """Centre each (B, N, 3) cloud and divide by the mean of the five
        largest entries of its full N x N distance matrix (symmetric
        duplicates included). Returns (normalized, centroid (B, 3),
        scale0 (B,)). With `pallas_attention` (and not `parity`) the
        statistic comes from ops/cuda_scale.py (the scale kernel on the
        card) and carries no gradient."""
        centroid = torch.mean(pc, dim=1)
        centered = pc - centroid[:, None, :]
        if self.config.fused:
            scale0 = top_k_mean_pairwise_distance(centered, 5)
        else:
            scale0 = top_k_mean_pairwise_distance_plain(centered, 5)
        return centered / scale0[:, None, None], centroid, scale0

    def encode(self, pc: torch.Tensor) -> Codes:
        """Encode (B, N, 3) clouds into codes.

        With `pallas_attention`, the attention encoder's clouds whose N the
        fused front end takes (N a multiple of min(256, N), the JAX
        condition) get their scale and their layer-0 graph from one pass
        over the centred cloud: dividing by the scale does not change the
        order of the neighbours. Any other N, and every other encoder, goes
        through `normalize_input` (the scale kernel on the card) and the
        encoder's own graphs. An encoder's three outputs (scale, z_so3,
        z_inv) leave the centroid as `t`; four add the predicted centre."""
        N = pc.shape[1]
        if (self.config.fused and isinstance(self.encoder, VecDGCNNAttn)
                and N % min(256, N) == 0):
            centroid = torch.mean(pc, dim=1)
            centered = pc - centroid[:, None, :]
            idx0, scale0 = knn_with_topk_scale(
                centered.detach(), min(self.config.num_knn, N))
            out = self.encoder(centered / scale0[:, None, None],
                               first_knn_idx=idx0)
        else:
            normalized, centroid, scale0 = self.normalize_input(pc)
            out = self.encoder(normalized)
        if len(out) == 4:
            center, pred_scale, z_so3, z_inv = out
            centroid = center[:, 0, :] + centroid
        else:
            pred_scale, z_so3, z_inv = out
        return {
            "z_so3": z_so3,
            "z_inv": z_inv,
            "s": scale0 * pred_scale,
            "t": centroid[:, None, :],
        }

    def encode_fps(self, pc: torch.Tensor, mask: torch.Tensor | None = None,
                   n_fps: int = 1, generator: torch.Generator | None = None,
                   starts: torch.Tensor | None = None) -> Codes:
        """FPS-downsample each padded (B, N, 3) cloud with its (B, N)
        validity mask to `n_pcl` points, then encode. With n_fps = 1 the FPS
        starts at index 0. With n_fps > 1 it restarts n_fps times, each from
        a random valid point of each cloud, and the codes are averaged:
        `starts` (n_fps, B) gives the start points, else they are drawn
        uniformly among each cloud's valid points from `generator` (a new
        one seeded with 0 when None)."""
        k = self.config.n_pcl
        if n_fps <= 1:
            sampled, _ = fps_auto(pc, k, mask=mask)
            return self.encode(sampled)
        B, N, _ = pc.shape
        if starts is None:
            valid = (torch.ones((B, N)) if mask is None
                     else mask.detach().to("cpu", torch.float32))
            generator = generator or torch.Generator().manual_seed(0)
            starts = torch.stack([
                torch.multinomial(valid, 1, generator=generator)[:, 0]
                for _ in range(n_fps)])
        starts = torch.as_tensor(starts, device=pc.device)
        codes = [self.encode(fps_auto(pc, k, mask=mask, start_idx=start)[0])
                 for start in starts]
        return {key: torch.mean(torch.stack([c[key] for c in codes]), dim=0)
                for key in codes[0]}

    def invariant_query(self, query: torch.Tensor, codes: Codes) -> torch.Tensor:
        """The decoder's input for world-space points (B, M, 3):
        (B, M, 2C + 1) = [z_inv | <q, z_so3> | |q|] with q = (query - t) / s;
        with `use_pe` followed by (B, M, pe_src (1 + 2 pe_pow)): for each
        axis a = pe_projector(z_so3), <q, a> and its sin and cos at
        pi 2^j, j < pe_pow."""
        q = (query - codes["t"]) / codes["s"][:, None, None]
        inner = torch.matmul(q, codes["z_so3"].transpose(-1, -2))
        length = torch.linalg.norm(q, dim=-1, keepdim=True)
        z = codes["z_inv"][:, None, :].expand(-1, query.shape[1], -1)
        parts = [z, inner, length]
        if self.pe_projector is not None:
            axes = self.pe_projector(codes["z_so3"])  # (B, pe_src, 3)
            pe_inner = torch.matmul(q, axes.transpose(-1, -2))  # (B, M, pe_src)
            sigma = torch.pi * 2.0 ** torch.arange(
                self.config.pe_pow, dtype=q.dtype, device=q.device)
            ang = pe_inner[..., None] * sigma
            pe = torch.cat([pe_inner[..., None], torch.sin(ang), torch.cos(ang)], dim=-1)
            parts.append(pe.reshape(*pe.shape[:2], -1))
        return torch.cat(parts, dim=-1)

    def _cast_decoder_state(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The decoder's parameters with each float32 one cast to `dtype`
        (the others stay as they are, as JAX casts float32 leaves only),
        detached. Made once per dtype and made again when a parameter is
        replaced or changed in place (its pointer or version counter
        moves); the model's own parameters are never cast. The copy is made
        outside inference mode, so that a later autograd pass (the
        refinement's) may save it."""
        params = dict(self.decoder.named_parameters())
        key = tuple((p.data_ptr(), p._version) for p in params.values())
        cached = self._cast_decoder.get(dtype)
        if cached is None or cached[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                cast = {k: p.detach().to(dtype) if p.dtype == torch.float32
                        else p.detach() for k, p in params.items()}
            cached = self._cast_decoder[dtype] = (key, cast)
        return cached[1]

    def decode_sdf(self, query: torch.Tensor, codes: Codes,
                   generator: torch.Generator | None = None,
                   matmul_dtype: torch.dtype | None = None) -> torch.Tensor:
        """SDF at world-space points (B, M, 3) -> (B, M). Dropout follows
        the module's train/eval mode (eval after construction); in train
        mode its masks come from `generator`.

        `matmul_dtype` (e.g. torch.bfloat16): the invariant query is formed
        in the dtype of the query and codes, then it and the decoder's
        float32 parameters are cast to `matmul_dtype` (the weight norm is
        taken of the cast copy) and the output is cast back to the query's
        dtype. Parameters of another dtype stay as they are, and the input
        is then promoted to theirs after its cast. Under grad mode, with
        parameters that require a gradient, the cast is part of the graph
        (training's decoder_bf16: the gradient reaches the float32
        parameters); otherwise it is a cached detached copy (see
        _cast_decoder_state)."""
        x = self.invariant_query(query, codes)
        if matmul_dtype is None:
            return self.decoder(x, generator)
        params = dict(self.decoder.named_parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params.values()):
            state = {k: p.to(matmul_dtype) if p.dtype == torch.float32 else p
                     for k, p in params.items()}
        else:
            state = self._cast_decoder_state(matmul_dtype)
        h = x.to(matmul_dtype)
        param_dtype = next(iter(state.values())).dtype
        if param_dtype != matmul_dtype:
            h = h.to(param_dtype)
        return functional_call(self.decoder, state, (h, generator)).to(x.dtype)

    def occupancy_logits(self, query: torch.Tensor, codes: Codes,
                         matmul_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Bernoulli occupancy logits, sdf2occ_factor * sdf; (B, M).
        `matmul_dtype`: see decode_sdf."""
        return self.config.sdf2occ_factor * self.decode_sdf(
            query, codes, matmul_dtype=matmul_dtype)

    def classify(self, codes: Codes) -> torch.Tensor:
        """Category logits (B, num_cates) of the codes' z_inv."""
        if self.cls_head is None:
            raise ValueError("the model was built without use_cls=True")
        return self.cls_head(codes["z_inv"])


def slice_codes(codes: Codes, index) -> Codes:
    """A sub-batch of codes: each entry indexed by `index` along its batch
    axis; an int keeps the axis (a batch of one)."""
    if isinstance(index, int):
        index = [index]
    return {k: v[index] for k, v in codes.items()}


def concat_codes(code_list) -> Codes:
    """Codes of several batches joined along the batch axis, entry by
    entry: the inverse of slice_codes."""
    return {k: torch.cat([codes[k] for codes in code_list]) for k in code_list[0]}


def transform_codes(codes: Codes, tsfm: torch.Tensor) -> Codes:
    """Carry codes through (B, 3/4, 4) transforms: z_so3 -> z_so3 R^T,
    t -> t R^T + p; z_inv and s are invariant."""
    Rt = tsfm[..., :3, :3].transpose(-1, -2)
    p = tsfm[..., :3, 3]
    return {
        "z_so3": torch.matmul(codes["z_so3"], Rt),
        "z_inv": codes["z_inv"],
        "s": codes["s"],
        "t": torch.matmul(codes["t"], Rt) + p[..., None, :],
    }
