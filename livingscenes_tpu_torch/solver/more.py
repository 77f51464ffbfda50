"""The MORE solver: scene-level matching, relocalization and reconstruction
over a shape prior.

Counterpart of livingscenes_tpu/solver/more.py (`MoreSolverConfig`,
`MoreSolver`). Every instance of a scan goes through each stage in one
batch: encode both scans, match, register every matched pair in one call,
carry the codes into the reference frame, and mesh each instance (its grid
on the model's device, the isosurface and simplification on the host).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .. import se3
from ..models.shape_prior import slice_codes, transform_codes
from ..ops.cuda_fps import fps_auto
from ..recon.extractor import MeshExtractor, MeshExtractorConfig
from ..recon.mesh import Mesh
from .code_optim import CodeOptimConfig, optimize_codes
from .matcher import solve_object_matching
from .registration import (
    RegistrationConfig,
    kabsch_from_codes,
    solve_pairwise_registration,
)

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoreSolverConfig:
    n_input_point: int = 1024  # the encoder's input size
    # FPS restarts of each registration pair from random start points; the
    # candidate with the lowest Kabsch residual wins (configs/
    # more_3rscan.yaml:10).
    n_init: int = 1
    seed: int = 0  # seeds the generator of the restarts' start points
    registration: RegistrationConfig = RegistrationConfig()
    mesh_extractor: MeshExtractorConfig = MeshExtractorConfig()
    code_optim: CodeOptimConfig = CodeOptimConfig()
    matching_method: str = "sequential"


class MoreSolver:
    """Scene-level tasks over `model`, a ShapePrior holding its weights.

    Everything runs on the model's device (the card unless the model was
    built with `device="cpu"`); inputs may be numpy arrays or tensors and
    are moved there. Clouds are padded per-instance batches (B, N, 3) with
    (B, N) bool validity masks or None. With `mesh` (a DeviceMesh with a
    "qp" axis, parallel/sharding.py) the reconstruction grids' queries are
    sharded over its ranks, each rank running the solver on the same
    inputs.
    """

    def __init__(self, model, config: MoreSolverConfig = MoreSolverConfig(),
                 mesh=None):
        self.model = model
        self.cfg = config
        # the restarts' start points, advanced by each draw
        self.generator = torch.Generator().manual_seed(config.seed)
        self.mesh_extractor = MeshExtractor(model.occupancy_logits,
                                            config.mesh_extractor, mesh=mesh)

    # ------------------------------------------------------------------
    def _points(self, pc) -> torch.Tensor:
        return torch.as_tensor(pc, device=self.model.device, dtype=self.model.dtype)

    def _mask(self, mask) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return torch.as_tensor(mask, device=self.model.device, dtype=torch.bool)

    def _sample(self, pc, mask=None, start_idx=0) -> torch.Tensor:
        """FPS of each cloud down to n_input_point points."""
        return fps_auto(self._points(pc), self.cfg.n_input_point,
                        mask=self._mask(mask), start_idx=start_idx)[0]

    @torch.no_grad()
    def encode_instances(self, pc, mask=None) -> Codes:
        """Encode (B, N, 3) clouds; with a mask, FPS them to the encoder's
        input size first (model.encode_fps)."""
        if mask is None:
            return self.model.encode(self._points(pc))
        return self.model.encode_fps(self._points(pc), self._mask(mask))

    @torch.no_grad()
    def solve_object_matching(self, src_codes: Codes, tgt_codes: Codes,
                              method: Optional[str] = None, src_mask=None,
                              tgt_mask=None) -> Dict[str, torch.Tensor]:
        """Match one scene's instances (matcher.solve_object_matching)."""
        return solve_object_matching(
            src_codes, tgt_codes, method or self.cfg.matching_method,
            self._mask(src_mask), self._mask(tgt_mask))

    @torch.no_grad()
    def solve_pairwise_registration(self, pc1, pc2, optim: bool = False,
                                    codes1: Optional[Codes] = None,
                                    codes2: Optional[Codes] = None,
                                    starts: Optional[torch.Tensor] = None):
        """Register (B, N, 3) pairs pc1 -> pc2: (R (B, 3, 3), t (B, 3, 1)).

        With n_init > 1 each pair first gets n_init FPS restarts (whatever
        N is) and the candidate with the lowest Kabsch residual wins, with
        its codes. `starts` (n_init, B) gives the restarts' first points;
        by default they are drawn from `self.generator`. Clouds that are
        not n_input_point long are then FPS-sampled to it, and missing codes
        encoded.
        """
        pc1, pc2 = self._points(pc1), self._points(pc2)
        k = self.cfg.n_input_point
        if self.cfg.n_init > 1:
            pc1, pc2, codes1, codes2 = self._best_fps_restart(pc1, pc2, starts)
        if pc1.shape[1] != k:
            pc1 = self._sample(pc1)
        if pc2.shape[1] != k:
            pc2 = self._sample(pc2)
        if codes1 is None:
            codes1 = self.model.encode(pc1)
        if codes2 is None:
            codes2 = self.model.encode(pc2)
        return solve_pairwise_registration(
            self.model, pc1, pc2, codes1, codes2, optim=optim,
            cfg=self.cfg.registration)

    def restart_starts(self, B: int, N: int) -> torch.Tensor:
        """(n_init, B) start points in [0, N), drawn from the generator."""
        return torch.randint(0, N, (self.cfg.n_init, B), generator=self.generator)

    @torch.no_grad()
    def _best_fps_restart(self, pc1, pc2, starts: Optional[torch.Tensor] = None):
        """n_init FPS restarts of each pair from `starts` (n_init, B) (drawn
        in [0, min(N1, N2)) when None); returns the sampled clouds and the
        codes of each pair's candidate with the lowest Kabsch residual, the
        first among ties."""
        pc1, pc2 = self._points(pc1), self._points(pc2)
        B = pc1.shape[0]
        if starts is None:
            starts = self.restart_starts(B, min(pc1.shape[1], pc2.shape[1]))
        starts = torch.as_tensor(starts, device=pc1.device)
        cands = []
        for start in starts:
            s1 = self._sample(pc1, start_idx=start)
            s2 = self._sample(pc2, start_idx=start)
            c1, c2 = self.model.encode(s1), self.model.encode(s2)
            cands.append((s1, s2, c1, c2, kabsch_from_codes(c1, c2).residual))
        best = torch.argmin(torch.stack([c[4] for c in cands]), dim=0)  # (B,)
        rows = torch.arange(B, device=pc1.device)

        def pick(xs):
            return torch.stack(xs)[best, rows]

        codes1 = {k: pick([c[2][k] for c in cands]) for k in cands[0][2]}
        codes2 = {k: pick([c[3][k] for c in cands]) for k in cands[0][3]}
        return pick([c[0] for c in cands]), pick([c[1] for c in cands]), codes1, codes2

    @torch.no_grad()
    def optimize_code(self, codes: Codes, pc, mask=None) -> Codes:
        """Refine codes against their observed (B, N, 3) clouds, FPS-sampled
        to the encoder's input size (code_optim.optimize_codes)."""
        return optimize_codes(self.model.decode_sdf, codes, self._sample(pc, mask),
                              self.cfg.code_optim)

    def transform_latent(self, codes: Codes, tsfm: torch.Tensor) -> Codes:
        """Carry codes through (B, 3/4, 4) transforms."""
        return transform_codes(codes, tsfm)

    def mesh_from_latent(self, codes: Codes) -> Mesh:
        """The mesh of one instance's codes."""
        return self.mesh_extractor.generate_from_codes(codes)

    @torch.no_grad()
    def mesh_from_pc(self, pc) -> Mesh:
        """FPS, encode and mesh the first cloud of a (B, N, 3) batch."""
        codes = self.model.encode(self._sample(pc))
        return self.mesh_from_latent(slice_codes(codes, 0))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def solve_end2end(self, ref_pc, ref_mask, rescan_pc, rescan_mask,
                      optim: bool = False, extract_meshes: bool = True) -> dict:
        """One scene pair: ref_pc (S, N, 3) and rescan_pc (T, N, 3) padded
        per-instance clouds with their masks (or None).

        Returns matches0 (S,) and matches1 (T,), registration (S, 4, 4) ref
        -> rescan of each ref instance (the identity where unmatched),
        ref_codes, rescan_codes, transported_codes (each matched rescan code
        carried into the ref frame) and, with `extract_meshes`, mesh_list:
        a Mesh per ref instance, None where unmatched.
        """
        ref_in = self._sample(ref_pc, ref_mask)
        rescan_in = self._sample(rescan_pc, rescan_mask)
        ref_codes = self.model.encode(ref_in)
        rescan_codes = self.model.encode(rescan_in)

        matches = self.solve_object_matching(ref_codes, rescan_codes)
        m0 = matches["matches0"]
        # every ref instance is registered to its partner (0 where
        # unmatched) in one batch; unmatched rows become the identity
        partner = torch.where(m0 >= 0, m0, 0).long()
        codes2 = {k: v[partner] for k, v in rescan_codes.items()}
        R, t = self.solve_pairwise_registration(
            ref_in, rescan_in[partner], optim=optim, codes1=ref_codes, codes2=codes2)
        matched = m0 >= 0
        R = torch.where(matched[:, None, None], R,
                        torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R))
        t = torch.where(matched[:, None, None], t, torch.zeros_like(t))
        tsfm = se3.rt_to_se3(R, t)
        transported = transform_codes(codes2, se3.inverse(tsfm))
        out = {
            "matches0": m0,
            "matches1": matches["matches1"],
            "registration": tsfm,
            "ref_codes": ref_codes,
            "rescan_codes": rescan_codes,
            "transported_codes": transported,
        }
        if extract_meshes:
            meshes: List[Optional[Mesh]] = []
            for i, m in enumerate(m0.tolist()):
                meshes.append(None if m < 0 else
                              self.mesh_from_latent(slice_codes(transported, i)))
            out["mesh_list"] = meshes
        return out
