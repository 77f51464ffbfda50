"""Iteration-oriented trainer.

Counterpart of livingscenes_tpu/train/trainer.py:

* a total_iter budget with eval_every_iter / checkpoint_iter / log_every,
* the learning rate of optax's piecewise_constant_schedule (the factor of a
  boundary applies from that step on) with a floor lr_min,
* loss clamping: the objective is clip(loss, -loss_clip, loss_clip), so its
  gradient is 0 when the loss saturates,
* gradient clipping to grad_clip by global norm, each top-level component
  (encoder, decoder, and the class head when the model has one) on its
  own,
* Adam as optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
  written out on the parameter tensors,
* `grad_norm`, the global norm of the gradients before clipping,
* checkpoints <tag>.ckpt (the step), latest.ckpt, and selected.ckpt with
  selected.metric for the best validation metric, in the port's own format
  (torch.save of the parameters, the Adam state and the step).

* every viz_iter_interval steps, `visualize_sample`: the first sample of a
  validation batch meshed and rendered into <log_dir>/viz (OBJ, PNGs),
  with a histogram of z_inv and a turntable GIF through the logger,
* `anomaly`: after the backward, a non-finite loss or gradient norm raises
  before the update, naming the encoder's submodules whose forward goes
  non-finite on the batch (forward hooks, utils/debugging.py) and the
  model's parameters that hold a NaN or Inf.

A step draws its randomness (the rotations of rot_aug, the centre jitter,
the dropout masks) from a generator seeded from (seed, step), as JAX's
fold_in(PRNGKey(seed), step): a resumed run draws what the uninterrupted
one does. A step reads nothing back to the host unless it is a log step or
`anomaly` is set.

With a mesh (a DeviceMesh with a "dp" axis, parallel/sharding.py) the step
is data-parallel and equals the unsharded step, as JAX's SPMD step does:
every rank reads the same global batch and keeps its rows (`place_batch`),
the random draws are made for the global batch and each rank keeps its
rows (RowDraws), the loss clamp is decided on the mean loss over the ranks,
the gradients are averaged over the ranks in one flattened all_reduce
before the clipping, and the metrics are means over the ranks. The weights
start from rank 0's (`init_state`); only rank 0 writes checkpoints, logs
and visualizations.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..models.sim3recon import SIM3Recon
from ..parallel.sharding import (RowDraws, active_mesh, all_reduce_mean, replicate,
                                 shard_batch, shard_rows)
from .logger import TrainLogger

log = logging.getLogger(__name__)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Defaults mirror configs/3rscan/dgcnn_attn_inner.yaml:106-132."""

    total_iter: int = 200_000
    batch_size: int = 64
    lr: float = 1e-4
    decay_schedule: tuple = (120_000, 150_000, 180_000)
    decay_factor: tuple = (0.3, 0.3, 0.3)
    lr_min: float = 1e-8
    grad_clip: float = 4.0
    loss_clip: float = 4.0
    eval_every_iter: int = 1000
    eval_batches: int = 4
    checkpoint_iter: int = 1000
    log_every: int = 50
    log_dir: str = "log/run"
    seed: int = 12345
    select_metric: str = "iou"
    select_larger: bool = True
    # visualize one validation sample every N steps (0: never), meshed at
    # this resolution
    viz_iter_interval: int = 0
    viz_mesh_resolution: int = 32
    # check loss and grad_norm on the host after every backward and raise on
    # a non-finite value, naming the modules that produce it
    anomaly: bool = False


def make_lr_schedule(cfg: TrainerConfig):
    """step -> learning rate: lr times the factor of every boundary <= step,
    at least lr_min."""
    pairs = sorted(zip(map(int, cfg.decay_schedule), map(float, cfg.decay_factor)))

    def schedule(step: int) -> float:
        value = cfg.lr
        for boundary, factor in pairs:
            if step >= boundary:
                value *= factor
        return max(value, cfg.lr_min)

    return schedule


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator: a function of (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


class TrainState:
    """The optimizer state and the step count; the parameters live in the
    model (model.prior)."""

    def __init__(self, opt_state: Dict[str, Any], step: int):
        self.opt_state = opt_state
        self.step = step


class _NoLogger:
    """The logger of a rank other than 0: writes nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Trainer:
    def __init__(self, model: SIM3Recon, cfg: TrainerConfig = TrainerConfig(),
                 mesh=None):
        self.model = model
        self.cfg = cfg
        self.mesh = active_mesh(mesh, "dp")
        self.is_main = self.mesh is None or self.mesh.get_local_rank("dp") == 0
        self.schedule = make_lr_schedule(cfg)
        self.logger = TrainLogger(cfg.log_dir) if self.is_main else _NoLogger()
        prior = model.prior
        # the top-level components, each clipped on its own
        self.components = {"encoder": list(prior.encoder.parameters()),
                           "decoder": list(prior.decoder.parameters())}
        if prior.cls_head is not None:
            self.components["cls_head"] = list(prior.cls_head.parameters())
        if prior.pe_projector is not None:
            self.components["pe_projector"] = list(prior.pe_projector.parameters())
        self.params: List[torch.Tensor] = [
            p for ps in self.components.values() for p in ps]

    @property
    def device(self) -> torch.device:
        return self.model.prior.device

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh Adam state at step 0 (the parameters are the model's;
        with a mesh, rank 0's are broadcast)."""
        replicate(self.model.prior, self.mesh)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        return TrainState({"mu": zeros(), "nu": zeros(), "count": 0}, 0)

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch of numpy arrays (all of them
        without a mesh), on the model's device."""
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        return self._to_device(batch)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dtype = self.model.prior.dtype
        return {k: torch.as_tensor(np.asarray(v), device=self.device).to(dtype)
                for k, v in batch.items()}

    def step_generator(self, step: int, batch_size: int):
        """The generator of step `step` for a global batch of `batch_size`
        rows: with a mesh, a RowDraws that keeps this rank's rows of each
        draw."""
        generator = self.generator(step)
        if self.mesh is None:
            return generator
        return RowDraws(generator, shard_rows(batch_size, self.mesh), batch_size)

    def _global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the ranks."""
        return dict(zip(metrics, all_reduce_mean(list(metrics.values()), self.mesh)))

    def generator(self, step: int) -> torch.Generator:
        """The generator of step `step`, on the model's device."""
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.cfg.seed, step))

    def forward(self, batch: Dict[str, torch.Tensor], generator):
        """The forward of one step: (objective, metrics). The objective is
        the loss clamped to loss_clip, whose gradient is 0 once the loss
        saturates; with a mesh, once the mean loss over the ranks does, and
        the metrics are means over the ranks."""
        loss, metrics = self.model.loss(batch, generator, train=True)
        metrics = self._global_metrics({k: v.detach() for k, v in metrics.items()})
        c = self.cfg.loss_clip
        if c <= 0:
            return loss, metrics
        mean = metrics["batch_loss"]
        objective = torch.where((mean >= -c) & (mean <= c), loss,
                                torch.clamp(loss.detach(), -c, c))
        return objective, metrics

    def loss_and_grads(self, batch: Dict[str, torch.Tensor], generator):
        """The forward and backward of one step: (metrics, grads), the
        gradients of the clamped loss in the order of self.params (zeros for
        a parameter the loss does not reach, such as the class head's on a
        batch without labels); with a mesh, averaged over the ranks."""
        objective, metrics = self.forward(batch, generator)
        grads = list(torch.autograd.grad(
            objective, self.params, allow_unused=True, materialize_grads=True))
        return metrics, all_reduce_mean(grads, self.mesh)

    @torch.no_grad()
    def apply_gradients(self, state: TrainState, grads: List[torch.Tensor]):
        """Clip per component, one Adam step at the schedule's rate for
        state.step; returns the global norm of the unclipped gradients."""
        squares, start = [], 0
        clipped = []
        for ps in self.components.values():
            part = grads[start:start + len(ps)]
            start += len(ps)
            sq = torch.stack([torch.sum(g * g) for g in part]).sum()
            squares.append(sq)
            scale = torch.clamp(
                self.cfg.grad_clip / torch.clamp_min(torch.sqrt(sq), 1e-12),
                max=1.0)
            clipped += torch._foreach_mul(part, scale)
        grad_norm = torch.sqrt(sum(squares))

        opt = state.opt_state
        count = opt["count"] + 1
        mu, nu = opt["mu"], opt["nu"]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, clipped, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, clipped, clipped, value=1.0 - ADAM_B2)
        mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** count)
        nu_hat = torch._foreach_div(nu, 1.0 - ADAM_B2 ** count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -self.schedule(state.step))
        torch._foreach_add_(self.params, updates)
        opt["count"] = count
        return grad_norm

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One step on a batch of numpy arrays; returns the metrics as
        tensors on the device (and grad_norm). With `anomaly`, a non-finite
        loss or gradient norm raises before the update (see
        anomaly_report)."""
        placed = self.place_batch(batch)
        generator = self.step_generator(state.step, len(batch["inputs"]))
        metrics, grads = self.loss_and_grads(placed, generator)
        if self.cfg.anomaly:
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
            bad = [k for k, v in (("batch_loss", metrics["batch_loss"]),
                                  ("grad_norm", norm))
                   if not math.isfinite(float(v))]
            if bad:
                raise RuntimeError(self.anomaly_report(bad, state.step + 1, placed))
        metrics["grad_norm"] = self.apply_gradients(state, grads)
        state.step += 1
        return metrics

    @torch.no_grad()
    def anomaly_report(self, bad: List[str], step: int, batch) -> str:
        """The anomaly mode's message: what went non-finite at `step`, the
        encoder's submodules whose forward is non-finite on the batch's
        centred inputs (innermost first), and the parameters holding a NaN
        or Inf."""
        from ..utils.debugging import locate_nonfinite_modules, nonfinite_parameters

        prior = self.model.prior
        inputs = batch["inputs"]
        was_training = prior.training
        prior.eval()
        try:
            _, located = locate_nonfinite_modules(
                prior.encoder, inputs - torch.mean(inputs, dim=1, keepdim=True))
        finally:
            prior.train(was_training)
        return (f"anomaly mode: non-finite {bad} at step {step}; offending "
                f"submodules: {located or 'none located in encoder (check decoder/loss)'}"
                f"; non-finite parameters: {nonfinite_parameters(prior) or 'none'}")

    @torch.no_grad()
    def val_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = self.place_batch(batch)
        _, metrics = self.model.loss(batch, None, train=False)
        if "eval_points" in batch:
            metrics["iou"] = torch.mean(self.model.val_iou(batch))
        return self._global_metrics(metrics)

    # ------------------------------------------------------------------
    def run(self, state: TrainState, train_iter: Iterator[Dict[str, np.ndarray]],
            val_iter_factory=None, total_iter: Optional[int] = None) -> TrainState:
        """The main loop: train to `total_iter` (default cfg.total_iter),
        logging, evaluating and checkpointing on their cadences."""
        cfg = self.cfg
        total = total_iter if total_iter is not None else cfg.total_iter
        t_last = time.time()
        while state.step < total:
            metrics = self.train_step(state, next(train_iter))
            step = state.step
            if step % cfg.log_every == 0 or step == total:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr"] = float(self.schedule(step))
                m["it_per_sec"] = cfg.log_every / max(time.time() - t_last, 1e-9)
                t_last = time.time()
                self.logger.log_metrics("train", step, m)
            if val_iter_factory is not None and step % cfg.eval_every_iter == 0:
                vals = []
                vit = val_iter_factory()
                for _ in range(cfg.eval_batches):
                    try:
                        vb = next(vit)
                    except StopIteration:
                        break
                    vals.append({k: float(v)
                                 for k, v in self.val_step(state, vb).items()})
                if vals:
                    mean = {k: float(np.mean([v[k] for v in vals]))
                            for k in vals[0]}
                    self.logger.log_metrics("val", step, mean)
                    self._maybe_select(state, mean)
            if (cfg.viz_iter_interval > 0 and step % cfg.viz_iter_interval == 0
                    and val_iter_factory is not None and self.is_main):
                try:
                    self.visualize_sample(state, next(val_iter_factory()), step)
                except Exception:  # visualization never stops training
                    log.exception("visualization failed at step %d", step)
                    self.logger.log_metrics("viz_error", step, {})
            if cfg.checkpoint_iter > 0 and step % cfg.checkpoint_iter == 0:
                self.save_checkpoint(state, tag=str(step))
                self.save_checkpoint(state, tag="latest")
        self.save_checkpoint(state, tag="latest")
        return state

    def run_epochs(self, state: TrainState, dataset, epochs: int,
                   val_dataset=None, shuffle_seed: int = 0) -> TrainState:
        """`epochs` passes over `dataset`."""
        from .data import batch_iterator

        steps_per_epoch = max(1, len(dataset) // self.cfg.batch_size)
        total = state.step + epochs * steps_per_epoch
        train_it = batch_iterator(dataset, self.cfg.batch_size, seed=shuffle_seed)
        val_factory = (
            (lambda: batch_iterator(val_dataset, self.cfg.batch_size, seed=1))
            if val_dataset is not None else None)
        return self.run(state, train_it, val_factory, total_iter=total)

    @torch.no_grad()
    def visualize_sample(self, state: TrainState, batch, step: int):
        """Mesh and render the first sample of a validation batch (numpy
        arrays) into <log_dir>/viz: recon_<step>.obj and .png (when the mesh
        is not empty) and input_<step>.png; log a histogram of its z_inv
        and a turntable GIF of the mesh."""
        from ..models.shape_prior import slice_codes
        from ..recon.extractor import MeshExtractor, MeshExtractorConfig
        from ..recon.mesh import Mesh
        from ..utils.viz import render_mesh_image, render_pointcloud_image, write_png

        prior = self.model.prior
        inputs = self._to_device({"inputs": batch["inputs"][:1]})["inputs"]
        was_training = prior.training
        prior.eval()
        try:
            codes, _, _ = self.model._encode_training(inputs, None, train=False)
            extractor = MeshExtractor(prior.occupancy_logits, MeshExtractorConfig(
                resolution0=self.cfg.viz_mesh_resolution, upsampling_steps=0,
                simplify_nfaces=None))
            mesh = extractor.generate_from_codes(slice_codes(codes, 0))
        finally:
            prior.train(was_training)
        viz_dir = os.path.join(self.cfg.log_dir, "viz")
        os.makedirs(viz_dir, exist_ok=True)
        if not mesh.is_empty:
            mesh.export_obj(os.path.join(viz_dir, f"recon_{step}.obj"))
            write_png(os.path.join(viz_dir, f"recon_{step}.png"),
                      render_mesh_image(mesh, size=256))
        write_png(os.path.join(viz_dir, f"input_{step}.png"),
                  render_pointcloud_image([np.asarray(batch["inputs"][0])], size=256))
        self.logger.log_histogram("val", step, "z_inv",
                                  codes["z_inv"].cpu().numpy())
        if not mesh.is_empty:
            frames = []
            for ang in np.linspace(0, 2 * np.pi, 12, endpoint=False):
                c, s = np.cos(ang), np.sin(ang)
                Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                frames.append(render_mesh_image(Mesh(mesh.vertices @ Rz.T, mesh.faces),
                                                size=192))
            self.logger.log_video("recon_turntable", step, frames)

    # ------------------------------------------------------------------
    def _ckpt_dir(self) -> str:
        d = os.path.join(self.cfg.log_dir, "checkpoint")
        os.makedirs(d, exist_ok=True)
        return d

    def save_checkpoint(self, state: TrainState, tag: str):
        """Write <tag>.ckpt (rank 0 only)."""
        if not self.is_main:
            return
        opt = state.opt_state
        payload = {
            "params": {k: v.detach().cpu() for k, v in
                       self.model.prior.state_dict().items()},
            "opt_state": {"mu": [t.cpu() for t in opt["mu"]],
                          "nu": [t.cpu() for t in opt["nu"]],
                          "count": opt["count"]},
            "step": state.step,
        }
        path = os.path.join(self._ckpt_dir(), f"{tag}.ckpt")
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def load_checkpoint(self, state: TrainState, tag: str = "latest") -> TrainState:
        """Load <tag>.ckpt of this run: the parameters into the model, and
        the Adam state and the step into the returned state."""
        path = os.path.join(self._ckpt_dir(), f"{tag}.ckpt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.model.prior.load_state_dict(payload["params"])
        opt = payload["opt_state"]
        dev = lambda ts: [t.to(self.device) for t in ts]
        return TrainState({"mu": dev(opt["mu"]), "nu": dev(opt["nu"]),
                           "count": int(opt["count"])}, int(payload["step"]))

    def _maybe_select(self, state: TrainState, val_metrics: Dict[str, float]):
        """Save selected.ckpt when the validation metric beats the best
        so far (selected.metric)."""
        key = self.cfg.select_metric
        if key not in val_metrics or not self.is_main:
            return
        value = val_metrics[key]
        best_path = os.path.join(self._ckpt_dir(), "selected.metric")
        best = None
        if os.path.exists(best_path):
            with open(best_path) as f:
                best = float(f.read().strip())
        better = best is None or (
            value > best if self.cfg.select_larger else value < best)
        if better:
            self.save_checkpoint(state, tag="selected")
            with open(best_path, "w") as f:
                f.write(str(value))
            self.logger.log_metrics("select", state.step, {key: value})
