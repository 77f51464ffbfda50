"""Training entry point: config -> datasets -> model -> trainer.run().

Counterpart of livingscenes_tpu/train/run.py (the card unless --device
names another). Usage:

    python -m livingscenes_tpu_torch.train.run --config configs/production_r5.yaml \\
        [--override training.batch_size=32] [--resume latest | <step>] \\
        [--init-from CKPT] [--total-iter N] [--device cpu]

Data-parallel over N ranks (one per card; batch_size must divide by N):

    torchrun --nproc-per-node N -m livingscenes_tpu_torch.train.run --config ...

--init-from restores the parameters only (fresh Adam state, step 0, so the
schedule restarts) from a flax checkpoint of the JAX package (its `params`
tree; `opt_state` is ignored) or from a checkpoint of this trainer.
The datasets are the synthetic one (`dataset_name: synthetic`) and the
preprocessed ShapeNet layout (`shapenet_new2` or `shapenet`: `data_root`,
`shapenet_split_fn`, `categories`, `input_mode`, ...; make a tree with
`python -m livingscenes_tpu_torch.tools.preprocess`). Under torchrun with
WORLD_SIZE > 1 every rank joins the process group (nccl on the cards, gloo
with --device cpu), the trainer gets a ("dp",) mesh, every rank reads the
same seeded batch stream and keeps its rows, and only rank 0 writes the log
directory.
"""
from __future__ import annotations

import argparse
import logging

import torch

from ..models.convert import load_flax_checkpoint, params_from_jax
from ..models.shape_prior import ShapePriorConfig
from ..models.sim3recon import SIM3Recon, TrainLossConfig
from ..parallel.sharding import initialize_distributed, make_mesh
from .config import (apply_overrides, cfg_with_default, load_config,
                     prepare_log_dir)
from .data import (AugmentConfig, SamplingAugConfig, ShapeNetSDFDataset,
                   SyntheticShapeDataset, batch_iterator, prefetch_iterator)
from .logger import configure_logging
from .trainer import Trainer, TrainerConfig

log = logging.getLogger(__name__)


def build_model(cfg: dict, device=None) -> SIM3Recon:
    m = cfg.get("model", {})
    enc = m.get("encoder", {})
    dec = m.get("decoder", {})
    prior_cfg = ShapePriorConfig(
        c_dim=enc.get("c_dim", 256),
        num_layers=enc.get("num_layers", 7),
        feat_dim=tuple(enc.get("feat_dim", (32, 32, 64, 64, 128, 256, 512))),
        down_sample_layers=tuple(enc.get("down_sample_layers", (2, 4, 5))),
        down_sample_factor=tuple(enc.get("down_sample_factor", (2, 4, 4))),
        atten_start_layer=enc.get("atten_start_layer", 2),
        atten_multi_head_c=enc.get("atten_multi_head_c", 16),
        num_knn=enc.get("num_knn", 16),
        scale_factor=enc.get("scale_factor", 64000.0),
        center_pred=enc.get("center_pred", True),
        center_pred_scale=enc.get("center_pred_scale", True),
        decoder_type=m.get("decoder_type", "inner_deepsdf"),
        decoder_dims=tuple(dec.get("dims", (768,) * 8)),
        decoder_dropout_prob=dec.get("dropout_prob", 0.2),
        decoder_latent_in=tuple(dec.get("latent_in", (4,))),
        sdf2occ_factor=m.get("sdf2occ_factor", -1.0),
        n_pcl=cfg.get("dataset", {}).get("n_pcl", 1024),
        # the fused kernels have backward kernels: training takes them
        pallas_attention=enc.get("pallas_attention", True),
    )
    loss_cfg = TrainLossConfig(
        w_uni=m.get("w_uni", 0.5),
        w_nss=m.get("w_nss", 0.5),
        w_s=m.get("w_s", 0.001),
        w_t=m.get("w_t", 0.2),
        loss_th=m.get("loss_th", 0.1),
        loss_near_lambda=m.get("loss_near_lambda", 1.0),
        loss_far_lambda=m.get("loss_far_lambda", 0.5),
        center_aug_std=m.get("center_aug_std", 0.05),
        rot_aug=m.get("rot_aug", False),
        iou_threshold=cfg_with_default(cfg, ["evaluation", "iou_threshold"], 0.5),
        decoder_bf16=m.get("decoder_bf16", False),
    )
    return SIM3Recon(prior_cfg, loss_cfg, device=device,
                     seed=cfg.get("seed", 12345))


def build_datasets(cfg: dict):
    """(train, val) datasets of the config: ShapeNetSDFDataset's train and
    val splits for dataset_name shapenet_new2 or shapenet, else synthetic
    ones (seeds 0 and 1). Only the training set augments."""
    d = cfg.get("dataset", {})
    shapenet = d.get("dataset_name", "synthetic") in ("shapenet_new2", "shapenet")
    aug = AugmentConfig(use_augmentation=d.get("use_augmentation", True),
                        aug_ratio=d.get("aug_ratio", 0.6))
    sampling_aug = None
    if d.get("use_sampling_augmentation", False):
        sampling_aug = SamplingAugConfig(
            mixing_prob=d.get("s1_mixing_sampling_prob", 0.5),
            mixing_mode_ratio=tuple(
                d.get("s1_mixing_mode_selection_ratio", (1.0, 1.0, 1.0))),
            single_mode_ratio=tuple(
                d.get("s1_single_mode_selection_ratio", (1.0, 1.0, 1.0))),
            sampling_range=tuple(d.get("s1_sampling_range", (0.3, 1.0))),
            gaussian_num_range=tuple(d.get("s1_gaussian_num_range", (1, 4))),
            gaussian_std_range=tuple(d.get("s1_gaussian_std_range", (0.05, 0.25))),
            gaussian_nss_range=tuple(d.get("s1_gaussian_nss_range", (0.0, 0.15))),
            halfspace_num_range=tuple(d.get("s1_halfspace_num_range", (1, 3))),
            halfspace_difference_range=tuple(
                d.get("s1_halfspace_difference_range", (0.3, 1.0))),
        )

    sizes = dict(n_pcl=d.get("n_pcl", 1024), n_uni=d.get("n_query_uni", 1024),
                 n_nss=d.get("n_query_nss", 1024), noise_std=d.get("noise_std", 0.005))
    if shapenet:
        def make_shapenet(split, use_aug):
            return ShapeNetSDFDataset(
                data_root=d["data_root"], split=split,
                split_csv=d.get("shapenet_split_fn"),
                categories=d.get("categories"),
                input_mode=d.get("input_mode", "pcl"),
                dataset_mode=d.get("dataset_mode", "hybrid"),
                field_mode=d.get("field_mode", "sdf"),
                dep_min_use_view=d.get("dep_min_use_view", 2),
                dep_max_use_view=d.get("dep_max_use_view", 8),
                aug=aug if use_aug else None,
                sampling_aug=sampling_aug if use_aug else None,
                n_eval=d.get("n_query_eval", 10000), **sizes)

        return make_shapenet("train", True), make_shapenet("val", False)

    def make(n, seed, use_aug):
        return SyntheticShapeDataset(
            n_items=n, seed=seed, aug=aug if use_aug else None,
            sampling_aug=sampling_aug if use_aug else None,
            n_eval=d.get("n_query_eval", 2048),
            ram_cache=d.get("ram_cache", True),
            cache_workers=d.get("cache_workers", 8), **sizes)

    return (make(d.get("n_train_items", 512), 0, True),
            make(d.get("n_val_items", 64), 1, False))


def build_trainer_cfg(cfg: dict) -> TrainerConfig:
    t = cfg.get("training", {})
    optim = cfg_with_default(cfg, ["training", "optim", "all"], {})
    e = cfg.get("evaluation", {})
    lg = cfg.get("logging", {})
    return TrainerConfig(
        total_iter=t.get("total_iter", 200_000),
        batch_size=t.get("batch_size", 64),
        lr=optim.get("lr", 1e-4),
        decay_schedule=tuple(optim.get("decay_schedule", (120_000, 150_000, 180_000))),
        decay_factor=tuple(optim.get("decay_factor", (0.3, 0.3, 0.3))),
        lr_min=optim.get("lr_min", 1e-8),
        grad_clip=t.get("grad_clip", 4.0),
        loss_clip=t.get("loss_clip", 4.0),
        eval_every_iter=e.get("eval_every_iter", 1000),
        eval_batches=e.get("eval_batches", 4),
        checkpoint_iter=lg.get("checkpoint_iter", 1000),
        log_every=lg.get("log_every", 50),
        log_dir=lg.get("log_dir", "log/run"),
        seed=cfg.get("seed", 12345),
        select_metric=lg.get("model_select_metric", "iou"),
        select_larger=lg.get("model_select_larger", True),
    )


def load_init_params(path: str):
    """The parameters of a checkpoint file, as the port's state dict: a
    trainer checkpoint of this package (a torch zip archive) or a flax
    checkpoint of the JAX package."""
    with open(path, "rb") as f:
        is_torch = f.read(2) == b"PK"
    if is_torch:
        return torch.load(path, map_location="cpu", weights_only=True)["params"]
    return params_from_jax(load_flax_checkpoint(path))


def main(argv=None):
    """Train as the config says; returns (trainer, final state)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--override", action="append", default=[],
                        help="a.b.c=value")
    parser.add_argument("--resume", default=None, help="latest | <step>")
    parser.add_argument(
        "--init-from", default=None, metavar="CKPT",
        help="warm-start the parameters from this checkpoint file (fresh "
        "optimizer and schedule; use --resume for exact continuation)")
    parser.add_argument("--total-iter", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="where to train (default: the card)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    apply_overrides(cfg, args.override)
    trainer_cfg = build_trainer_cfg(cfg)
    mesh = None
    if initialize_distributed(device=args.device):
        world = torch.distributed.get_world_size()
        if trainer_cfg.batch_size % world:
            raise ValueError(f"batch_size {trainer_cfg.batch_size} does not "
                             f"divide over {world} ranks")
        mesh = make_mesh(axis_names=("dp",))
    main_rank = mesh is None or torch.distributed.get_rank() == 0
    if args.resume is None and main_rank:
        prepare_log_dir(cfg, args.config)
    configure_logging(cfg_with_default(cfg, ["logging", "log_dir"], None)
                      if main_rank else None)
    if mesh is not None:
        log.info("data-parallel mesh over %d ranks", mesh.size())

    model = build_model(cfg, device=args.device)
    train_ds, val_ds = build_datasets(cfg)
    trainer = Trainer(model, trainer_cfg, mesh=mesh)
    state = trainer.init_state()
    if args.resume:
        state = trainer.load_checkpoint(state, args.resume)
        log.info("resumed from %s at step %d", args.resume, state.step)
    elif args.init_from:
        model.prior.load_state_dict(load_init_params(args.init_from))
        log.info("warm-started the parameters from %s (optimizer state and "
                 "schedule reset)", args.init_from)

    train_it = prefetch_iterator(
        batch_iterator(train_ds, trainer_cfg.batch_size, seed=trainer_cfg.seed))
    val_factory = lambda: batch_iterator(
        val_ds, max(2, trainer_cfg.batch_size // 8), seed=1)
    state = trainer.run(state, train_it, val_factory, total_iter=args.total_iter)
    return trainer, state


if __name__ == "__main__":
    main()
