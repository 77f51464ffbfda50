"""FlyingShape benchmark command line.

    python -m livingscenes_tpu_torch.eval.run_flyingshape --data DIR \
        [--ckpt weights/production_r5_selected.ckpt] \
        [--tasks matching,reloc,recon] [--optim] [--out RESULTS.json] \
        [--device cpu]

Counterpart of livingscenes_tpu/eval/run_flyingshape.py. Runs on the card
unless `--device` names another device; without a card and without
`--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import torch

from ..models.convert import load_flax_checkpoint, params_from_jax, state_dict_from_torch
from ..models.shape_prior import ShapePrior, ShapePriorConfig
from ..solver import MoreSolver, MoreSolverConfig
from ..train.logger import configure_logging
from .flyingshape import (
    FlyingShapeDataset,
    eval_matching,
    eval_reconstruction,
    eval_relocalization,
)

log = logging.getLogger(__name__)


def load_torch_state(path: str):
    """The state dict of a reference torch checkpoint (.pt: a
    "model_state_dict" entry or the dict itself), keys without "module."."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw)
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_solver(ckpt: str | None, fast: bool = True, parity: bool = False,
                device=None, config: MoreSolverConfig | None = None) -> MoreSolver:
    """The production model, its weights and a MoreSolver over it.

    fast: ShapePriorConfig(pallas_attention=True), the fused encoder
    kernels on the card (their plain versions on the CPU). ckpt: a flax
    msgpack checkpoint (weights/*.ckpt, the JAX package's or the port
    trainer's), a reference torch .pt (loaded strictly after its decoder's
    layout is mapped, models/convert.py state_dict_from_torch), or None for
    random weights from seed 0. parity: the reference's unconditional ICP
    polish after the refinement (icp_accept="always") instead of the
    per-instance acceptance, so that a parity run measures the port's
    fidelity, not its improvements. config: the solver's settings
    (MoreSolverConfig() by default)."""
    model = ShapePrior(ShapePriorConfig(pallas_attention=fast), device=device)
    if ckpt and ckpt.endswith(".pt"):
        model.load_state_dict(state_dict_from_torch(load_torch_state(ckpt)), strict=True)
    elif ckpt:
        model.load_state_dict(params_from_jax(load_flax_checkpoint(ckpt)), strict=True)
    else:
        log.warning("no checkpoint given: random weights from seed 0")
    cfg = config or MoreSolverConfig()
    if parity:
        cfg = dataclasses.replace(cfg, registration=dataclasses.replace(
            cfg.registration, icp_accept="always"))
    return MoreSolver(model, cfg)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--tasks", default="matching,reloc")
    parser.add_argument("--optim", action="store_true",
                        help="SE(3) refinement during relocalization")
    parser.add_argument("--out", default=None, help="write results json")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the card)")
    args = parser.parse_args(argv)

    configure_logging()
    dataset = FlyingShapeDataset(args.data)
    log.info("FlyingShape: %d scenes", len(dataset))
    solver = load_solver(args.ckpt, device=args.device)

    results = {}
    tasks = args.tasks.split(",")
    if "matching" in tasks:
        results["matching"] = eval_matching(dataset, solver)
    if "reloc" in tasks:
        results["relocalization"] = eval_relocalization(dataset, solver,
                                                        optim=args.optim)
    if "recon" in tasks:
        results["reconstruction"] = eval_reconstruction(dataset, solver)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
