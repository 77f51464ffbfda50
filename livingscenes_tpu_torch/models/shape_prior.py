"""The shape prior: SIM(3) pre-normalization, the equivariant encoder, the
invariant SDF field, and code transport.

Counterpart of livingscenes_tpu/models/shape_prior.py (`ShapePriorConfig`,
`ShapePrior.normalize_input`, `encode`, `encode_fps`, `invariant_query`,
`decode_sdf`, `occupancy_logits`, `classify` with `ClsHead`, `slice_codes`,
`transform_codes`), without the positional-encoding tail of the query.
Codes are the dict {"z_so3": (B, C, 3), "z_inv": (B, C), "s": (B,),
"t": (B, 1, 3)}. Two behaviours of the reference stay: a cloud of identical
points gives NaN codes (its scale statistic is 0), and `t` is
SE(3)-equivariant but not SIM(3)-equivariant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..nn.deepsdf import DeepSDFDecoder, Dense, WNDense
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
    (configs/3rscan/dgcnn_attn_inner.yaml)."""

    c_dim: int = 256
    num_layers: int = 7
    feat_dim: tuple = (32, 32, 64, 64, 128, 256, 512)
    down_sample_layers: tuple = (2, 4, 5)
    down_sample_factor: tuple = (2, 4, 4)
    atten_start_layer: int = 2
    atten_multi_head_c: int = 16
    num_knn: int = 16
    scale_factor: float = 64000.0
    decoder_dims: tuple = (768,) * 8
    decoder_dropout_prob: float = 0.2
    decoder_latent_in: tuple = (4,)
    sdf2occ_factor: float = -1.0
    n_pcl: int = 1024  # encoder input size
    # the category classifier on z_inv (ClsHead)
    use_cls: bool = False
    num_cates: int = 7
    # The fused path (the JAX field's name): on the card the encoder's
    # layers run as fused CUDA kernels and `encode` takes the scale (and,
    # for N a multiple of min(256, N), the layer-0 graph) from a kernel; on
    # the CPU the plain versions of the same functions run. The parameters
    # do not depend on it.
    pallas_attention: bool = False


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
    """Encoder and decoder (and with `use_cls` the category head
    `cls_head`) with their parameters, on one device.

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
        self.encoder = VecDGCNNAttn(
            c_dim=c.c_dim,
            num_layers=c.num_layers,
            feat_dim=c.feat_dim,
            down_sample_layers=c.down_sample_layers,
            down_sample_factor=c.down_sample_factor,
            atten_start_layer=c.atten_start_layer,
            atten_multi_head_c=c.atten_multi_head_c,
            num_knn=c.num_knn,
            scale_factor=c.scale_factor,
            pallas_attention=c.pallas_attention,
        )
        self.decoder = DeepSDFDecoder(
            latent_size=c.c_dim,
            dims=c.decoder_dims,
            dropout_prob=c.decoder_dropout_prob,
            latent_in=c.decoder_latent_in,
            pe_dim=c.c_dim + 1,
        )
        self.cls_head = ClsHead(c.c_dim, c.num_cates) if c.use_cls else None
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (VecLinear, WNDense, Dense)):
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
        scale0 (B,)). With `pallas_attention` the statistic comes from
        ops/cuda_scale.py (the scale kernel on the card) and carries no
        gradient."""
        centroid = torch.mean(pc, dim=1)
        centered = pc - centroid[:, None, :]
        if self.config.pallas_attention:
            scale0 = top_k_mean_pairwise_distance(centered, 5)
        else:
            scale0 = top_k_mean_pairwise_distance_plain(centered, 5)
        return centered / scale0[:, None, None], centroid, scale0

    def encode(self, pc: torch.Tensor) -> Codes:
        """Encode (B, N, 3) clouds into codes.

        With `pallas_attention`, clouds whose N the fused front end takes
        (N a multiple of min(256, N), the JAX condition) get their scale and
        their layer-0 graph from one pass over the centred cloud: dividing
        by the scale does not change the order of the neighbours. Any
        other N goes through `normalize_input` (the scale kernel on the
        card) and the encoder's own layer-0 kNN."""
        N = pc.shape[1]
        if self.config.pallas_attention and N % min(256, N) == 0:
            centroid = torch.mean(pc, dim=1)
            centered = pc - centroid[:, None, :]
            idx0, scale0 = knn_with_topk_scale(
                centered.detach(), min(self.config.num_knn, N))
            out = self.encoder(centered / scale0[:, None, None],
                               first_knn_idx=idx0)
        else:
            normalized, centroid, scale0 = self.normalize_input(pc)
            out = self.encoder(normalized)
        center, pred_scale, z_so3, z_inv = out
        return {
            "z_so3": z_so3,
            "z_inv": z_inv,
            "s": scale0 * pred_scale,
            "t": (center[:, 0, :] + centroid)[:, None, :],
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
        (B, M, 2C + 1) = [z_inv | <q, z_so3> | |q|] with q = (query - t) / s."""
        q = (query - codes["t"]) / codes["s"][:, None, None]
        inner = torch.matmul(q, codes["z_so3"].transpose(-1, -2))
        length = torch.linalg.norm(q, dim=-1, keepdim=True)
        z = codes["z_inv"][:, None, :].expand(-1, query.shape[1], -1)
        return torch.cat([z, inner, length], dim=-1)

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
