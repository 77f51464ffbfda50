"""Iteration-oriented trainer.

Counterpart of livingscenes_tpu/train/trainer.py, on one device:

* a total_iter budget with eval_every_iter / checkpoint_iter / log_every,
* the learning rate of optax's piecewise_constant_schedule (the factor of a
  boundary applies from that step on) with a floor lr_min,
* loss clamping: the objective is clip(loss, -loss_clip, loss_clip), so its
  gradient is 0 when the loss saturates,
* gradient clipping to grad_clip by global norm, each top-level component
  (encoder, decoder) on its own,
* Adam as optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
  written out on the parameter tensors,
* `grad_norm`, the global norm of the gradients before clipping,
* checkpoints <tag>.ckpt (the step), latest.ckpt, and selected.ckpt with
  selected.metric for the best validation metric, in the port's own format
  (torch.save of the parameters, the Adam state and the step).

A step draws its randomness (the centre jitter, the dropout masks) from a
generator seeded from (seed, step), as JAX's fold_in(PRNGKey(seed), step):
a resumed run draws what the uninterrupted one does. A step reads nothing
back to the host unless it is a log step or `anomaly` is set.
Not ported: visualize_sample (needs the reconstruction leg) and the anomaly
check's search for the module that went non-finite.
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
    viz_iter_interval: int = 0  # must stay 0: visualization is not ported
    # check loss and grad_norm on the host after every step and raise on a
    # non-finite value
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


class Trainer:
    def __init__(self, model: SIM3Recon, cfg: TrainerConfig = TrainerConfig()):
        if cfg.viz_iter_interval > 0:
            raise NotImplementedError("visualize_sample is not ported: "
                                      "set viz_iter_interval to 0")
        self.model = model
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.logger = TrainLogger(cfg.log_dir)
        prior = model.prior
        # the top-level components, each clipped on its own
        self.components = {"encoder": list(prior.encoder.parameters()),
                           "decoder": list(prior.decoder.parameters())}
        self.params: List[torch.Tensor] = [
            p for ps in self.components.values() for p in ps]

    @property
    def device(self) -> torch.device:
        return self.model.prior.device

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """A fresh Adam state at step 0 (the parameters are the model's)."""
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        return TrainState({"mu": zeros(), "nu": zeros(), "count": 0}, 0)

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dtype = self.model.prior.dtype
        return {k: torch.as_tensor(np.asarray(v), device=self.device).to(dtype)
                for k, v in batch.items()}

    def generator(self, step: int) -> torch.Generator:
        """The generator of step `step`, on the model's device."""
        return torch.Generator(device=self.device).manual_seed(
            step_seed(self.cfg.seed, step))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        """The forward of one step: (objective, metrics); the objective is
        the loss clamped to loss_clip."""
        loss, metrics = self.model.loss(batch, generator, train=True)
        c = self.cfg.loss_clip
        objective = torch.clamp(loss, -c, c) if c > 0 else loss
        return objective, {k: v.detach() for k, v in metrics.items()}

    def loss_and_grads(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator]):
        """The forward and backward of one step: (metrics, grads), the
        gradients of the clamped loss in the order of self.params."""
        objective, metrics = self.forward(batch, generator)
        return metrics, list(torch.autograd.grad(objective, self.params))

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
        tensors on the device (and grad_norm)."""
        metrics, grads = self.loss_and_grads(
            self.place_batch(batch), self.generator(state.step))
        metrics["grad_norm"] = self.apply_gradients(state, grads)
        state.step += 1
        if self.cfg.anomaly:
            bad = [k for k in ("batch_loss", "grad_norm")
                   if not math.isfinite(float(metrics[k]))]
            if bad:
                raise RuntimeError(
                    f"anomaly mode: non-finite {bad} at step {state.step}")
        return metrics

    @torch.no_grad()
    def val_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = self.place_batch(batch)
        _, metrics = self.model.loss(batch, None, train=False)
        if "eval_points" in batch:
            metrics["iou"] = torch.mean(self.model.val_iou(batch))
        return metrics

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

    # ------------------------------------------------------------------
    def _ckpt_dir(self) -> str:
        d = os.path.join(self.cfg.log_dir, "checkpoint")
        os.makedirs(d, exist_ok=True)
        return d

    def save_checkpoint(self, state: TrainState, tag: str):
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
        if key not in val_metrics:
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
