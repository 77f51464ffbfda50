"""Multi-scan joint optimization.

Counterpart of livingscenes_tpu/solver/joint.py (`JointResult`,
`accumulate_and_optimize`): the instances of T scans are matched to the
reference scan and registered into its frame, their observations are
accumulated, and one code per reference instance is optimized against the
union of its observations, all instances in one `optimize_codes` call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import se3
from .code_optim import CodeOptimConfig, optimize_codes

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass
class JointResult:
    codes: Codes  # the optimized code of each reference instance
    accumulated_pc: torch.Tensor  # (S, T * N, 3) observations in the ref frame
    accumulated_mask: torch.Tensor  # (S, T * N)
    matches: List[np.ndarray]  # per rescan: matches0 into that rescan
    transforms: List[torch.Tensor]  # per rescan: (S, 4, 4) ref -> rescan


@torch.no_grad()
def accumulate_and_optimize(
    solver,
    scans: Sequence[Tuple[object, Optional[object]]],
    optim_registration: bool = False,
    code_cfg: Optional[CodeOptimConfig] = None,
) -> JointResult:
    """The joint multi-scan pipeline of a MoreSolver.

    scans: [(pc (S_t, N, 3), mask (S_t, N) or None), ...], scans[0] the
    reference scan; every scan has the same N. Each rescan's instances are
    matched to the reference's and registered (with the refinement where
    `optim_registration`); the rescan clouds of matched instances are moved
    into the reference frame, and the accumulated clouds, FPS-sampled to the
    encoder's input size, refine the reference codes (`code_cfg`, else the
    solver's).
    """
    ref_pc, ref_mask = solver._points(scans[0][0]), solver._mask(scans[0][1])
    ref_in = solver._sample(ref_pc, ref_mask)
    ref_codes = solver.encode_instances(ref_in)

    obs_pc = [ref_pc]
    obs_mask = [ref_mask if ref_mask is not None
                else torch.ones(ref_pc.shape[:2], dtype=torch.bool, device=ref_pc.device)]
    matches_out: List[np.ndarray] = []
    transforms_out: List[torch.Tensor] = []
    for pc_t, mask_t in scans[1:]:
        pc_t, mask_t = solver._points(pc_t), solver._mask(mask_t)
        in_t = solver._sample(pc_t, mask_t)
        codes_t = solver.encode_instances(in_t)
        m0 = solver.solve_object_matching(ref_codes, codes_t)["matches0"]
        partner = torch.where(m0 >= 0, m0, 0).long()
        R, t = solver.solve_pairwise_registration(
            ref_in, in_t[partner], optim=optim_registration, codes1=ref_codes,
            codes2={k: v[partner] for k, v in codes_t.items()})
        tsfm = se3.rt_to_se3(R, t)  # ref -> rescan of each ref instance

        # the rescan observations of each matched instance in the ref
        # frame; unmatched rows add only masked-out points
        full2 = pc_t[partner]
        full2_mask = (mask_t[partner] if mask_t is not None
                      else torch.ones(full2.shape[:2], dtype=torch.bool, device=full2.device))
        obs_pc.append(se3.transform(se3.inverse(tsfm), full2))
        obs_mask.append((m0 >= 0)[:, None] & full2_mask)
        matches_out.append(m0.cpu().numpy())
        transforms_out.append(tsfm)

    acc_pc = torch.cat(obs_pc, dim=1)
    acc_mask = torch.cat(obs_mask, dim=1)
    best = optimize_codes(solver.model.decode_sdf, ref_codes,
                          solver._sample(acc_pc, acc_mask),
                          code_cfg or solver.cfg.code_optim)
    return JointResult(codes=best, accumulated_pc=acc_pc, accumulated_mask=acc_mask,
                       matches=matches_out, transforms=transforms_out)
