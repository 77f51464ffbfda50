"""Subpackage of the PyTorch port (see livingscenes_tpu_torch/__init__.py):
matching, registration, code optimization, the MORE solver, multi-scan
joint optimization and the scene-pair pipeline."""
from .matcher import (
    sequential_matcher,
    nn_matcher,
    sinkhorn_matcher,
    sim3_seq_matcher,
    eq_seq_matcher,
    solve_object_matching,
)
from .registration import (
    RegistrationConfig,
    kabsch_from_codes,
    refine_se3,
    solve_pairwise_registration,
)
from .code_optim import CodeOptimConfig, optimize_codes
from .more import MoreSolver, MoreSolverConfig
from .joint import JointResult, accumulate_and_optimize

__all__ = [
    "sequential_matcher",
    "nn_matcher",
    "sinkhorn_matcher",
    "sim3_seq_matcher",
    "eq_seq_matcher",
    "solve_object_matching",
    "RegistrationConfig",
    "kabsch_from_codes",
    "refine_se3",
    "solve_pairwise_registration",
    "CodeOptimConfig",
    "optimize_codes",
    "MoreSolver",
    "MoreSolverConfig",
    "JointResult",
    "accumulate_and_optimize",
]
