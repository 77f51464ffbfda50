"""3RScan benchmark command line.

    python -m livingscenes_tpu_torch.eval.run_3rscan --data <3RScan data dir> \
        [--ckpt ...] [--tasks matching,reloc,recon] [--mask-name pred.npz] \
        [--device cpu]

Counterpart of livingscenes_tpu/eval/run_3rscan.py. The parity run

    python -m livingscenes_tpu_torch.eval.run_3rscan \
        --parity LivingScenes_latest.pt --data <3RScan data dir>

checks that the reference's torch checkpoint maps onto the port's layout
and back key for key and bit for bit, runs matching, relocalization with
and without the 400-step refinement, and reconstruction, and prints the
reference's metric table. Runs on the card unless `--device` names another
device.
"""
from __future__ import annotations

import argparse
import json
import logging

import torch

from ..train.logger import configure_logging
from .rescan3r import (
    Dataset3RScan,
    eval_matching,
    eval_reconstruction,
    eval_relocalization,
)
from .run_flyingshape import load_solver, load_torch_state

log = logging.getLogger(__name__)


def verify_conversion(ckpt_path: str) -> int:
    """Map a reference torch checkpoint onto the port's state dict and back
    (models/convert.py) and check that the round trip gives the source:
    the same keys both ways (a dropped tensor fails; counters of batch
    norms, which carry no weights, are the only keys allowed to go) and
    the same bits. Returns the number of tensors checked."""
    from ..models import convert

    sd = load_torch_state(ckpt_path)
    kept = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    try:
        back = convert.state_dict_to_torch(convert.state_dict_from_torch(kept))
    except ValueError as e:
        raise RuntimeError(f"conversion round-trip key mismatch: {e}") from e
    dropped = sorted(k for k in kept if k not in back)
    extra = sorted(k for k in back if k not in kept)
    if dropped or extra:
        raise RuntimeError(
            "conversion round-trip key mismatch: "
            f"dropped from re-export {dropped[:8]}{'...' if len(dropped) > 8 else ''}, "
            f"not in source {extra[:8]}{'...' if len(extra) > 8 else ''}")
    n_checked = 0
    for key, val in back.items():
        src = torch.as_tensor(kept[key]).detach().cpu().to(torch.float32)
        got = torch.as_tensor(val).detach().cpu().to(torch.float32)
        if src.shape != got.shape or not torch.equal(src, got):
            raise RuntimeError(f"conversion round-trip mismatch at {key}: "
                               f"{tuple(src.shape)} vs {tuple(got.shape)}")
        n_checked += 1
    if n_checked == 0:
        raise RuntimeError("conversion round-trip checked 0 tensors")
    log.info("checkpoint conversion verified: %d tensors round-trip bit for bit",
             n_checked)
    return n_checked


def parity_table(results: dict) -> str:
    """The reference's metric table, a line for each published row."""
    def fmt(v):
        return "-" if v is None else f"{v:.2f}"

    m = results.get("matching", {})
    lines = [
        "=== 3RScan parity table (reference format) ===",
        "Object-level matching recall: (all) {} | (static) {} | (dynamic) {}".format(
            fmt(m.get("object_recall")), fmt(m.get("static_recall")),
            fmt(m.get("dynamic_recall"))),
        "Scene-level Hits Recall: @75 {} | K@50 {} | K@25 {}".format(
            fmt(m.get("scene_recall@75")), fmt(m.get("scene_recall@50")),
            fmt(m.get("scene_recall@25"))),
    ]
    for tag, key in (
        ("reloc (Kabsch+ICP)", "relocalization"),
        ("reloc (+400-step optim)", "relocalization_optim"),
        ("reloc [NON-PARITY: symch ICP accept]", "relocalization_symch"),
        ("reloc+optim [NON-PARITY: symch ICP accept]", "relocalization_optim_symch"),
    ):
        r = results.get(key)
        if not r:
            continue
        chamfer = r.get("median_chamfer")
        lines.append(
            "{}: recall(RMSE<0.1) {} | median RRE {} | median RTE {} |"
            " recall(RRE<10) {} | median chamfer {}".format(
                tag, fmt(r.get("recall_T0.1")), fmt(r.get("median_rre")),
                fmt(r.get("median_rte")), fmt(r.get("recall_rre10")),
                "-" if chamfer is None else f"{chamfer:.4f}"))
    rc = results.get("reconstruction")
    if rc:
        chamfer = rc.get("chamfer_1way_mean")
        lines.append("Reconstruction: chamfer(1-way) {} | SDF recall {}".format(
            "-" if chamfer is None else f"{chamfer:.5f}", fmt(rc.get("sdf_recall"))))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True)
    parser.add_argument("--split", default="val")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--tasks", default="matching,reloc")
    parser.add_argument(
        "--parity", metavar="TORCH_CKPT", default=None,
        help="parity run: verify this torch checkpoint's conversion, run every"
        " eval loop (relocalization with and without the 400-step refinement)"
        " and print the reference's metric table")
    parser.add_argument("--mask-name", default=None,
                        help="predicted-instance mask npz; ground-truth masks if omitted")
    parser.add_argument("--recon-gt", default=None)
    parser.add_argument("--no-optim", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="device to run on (default: the card)")
    args = parser.parse_args(argv)

    configure_logging()
    dataset = Dataset3RScan(args.data, split=args.split,
                            use_gt_mask=args.mask_name is None,
                            mask_name=args.mask_name)
    log.info("3RScan: %d scenes", len(dataset))

    if args.parity:
        if args.parity.endswith(".pt"):
            verify_conversion(args.parity)
        # the reference's unconditional ICP polish for the parity rows; the
        # per-instance acceptance in rows of their own
        solver = load_solver(args.parity, parity=True, device=args.device)
        solver_improved = load_solver(args.parity, device=args.device)
        tasks = ["matching", "reloc", "recon"]
    else:
        solver = load_solver(args.ckpt, device=args.device)
        tasks = args.tasks.split(",")

    results = {}
    if "matching" in tasks:
        results["matching"] = eval_matching(dataset, solver)
    if "reloc" in tasks:
        if args.parity:
            results["relocalization"] = eval_relocalization(dataset, solver, optim=False)
            results["relocalization_optim"] = eval_relocalization(dataset, solver,
                                                                  optim=True)
            results["relocalization_symch"] = eval_relocalization(
                dataset, solver_improved, optim=False)
            results["relocalization_optim_symch"] = eval_relocalization(
                dataset, solver_improved, optim=True)
        else:
            results["relocalization"] = eval_relocalization(
                dataset, solver, optim=not args.no_optim)
    if "recon" in tasks:
        results["reconstruction"] = eval_reconstruction(dataset, solver,
                                                        recon_gt_dir=args.recon_gt)
    print(json.dumps(results, indent=2))
    if args.parity:
        print(parity_table(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
