"""The port's data-parallel train step (Trainer(mesh=...)) on 2 and 4 gloo
ranks on the CPU, held against the port's unsharded step and JAX's steps
on one device and on its 8-device virtual CPU mesh
(tests/test_train.py::test_sharded_matches_unsharded).

The model is tests/test_torch_port_train.py's TINY SIM3Recon in float64,
the JAX init carried over, on batches of 8 from the synthetic dataset; two
steps (lr 1e-3, grad_clip 0.5). Only rank 0 holds the weights before
init_state broadcasts them.

* Without random draws (dropout and centre jitter off): the loss rtol 1e-5
  and the parameters after each run within JAX's 1e-3 of JAX's sharded
  and unsharded steps; against the port's unsharded step, loss and
  grad_norm rtol 1e-10, the validation metrics after the steps rtol 1e-10
  (iou, a float32 ratio, 1e-6), and the parameters within 1e-10 (float64
  rounding of the all_reduce).
* With rot_aug, dropout 0.2 and the centre jitter on: the draws are made
  for the global batch and each rank keeps its rows, so the sharded steps
  equal the unsharded ones to the same 1e-10.
* The loss clamp is decided on the mean loss over the ranks: with the
  batch's first half made far off (one rank's loss past loss_clip, the mean
  under it) the step updates as the unsharded one does; with loss_clip
  between the other rank's loss and the mean, no parameter moves.
* train.run.main under torchrun's environment (2 ranks, gloo, float32,
  tests/test_torch_port_train.py's tiny YAML, 2 steps with a validation):
  both ranks end with the same parameters, within JAX's 1e-3 of the
  single-process run's, the two steps' update within 1e-4 of its norm
  (float32 rounding through Adam: about 3e-6 seen), and only rank 0 wrote
  the log directory (one metrics line a step).
"""
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.parallel.sharding import make_mesh as jax_make_mesh
from livingscenes_tpu.parallel.sharding import replicate as jax_replicate
from livingscenes_tpu.train import trainer as jtrainer
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.train.data import SyntheticShapeDataset, batch_iterator
from test_torch_port_train import TINY, jax_model, tiny_config
from torch_parallel_children import (load, port_trainer, run_main, spawn, train_child,
                                     train_steps)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

B = 8
TRAINER = dict(batch_size=B, lr=1e-3, grad_clip=0.5, log_every=1, checkpoint_iter=0)
MODEL = dict(TINY, pallas_attention=True)


def spec(batches="batches", dropout=0.0, loss=None, **trainer):
    return {"model": dict(MODEL, decoder_dropout_prob=dropout),
            "loss": loss or dict(center_aug_std=0.0),
            "trainer": dict(TRAINER, **trainer), "batches": batches}


def save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jax.jit(jax_model().init_params)(jax.random.PRNGKey(0)))
    torch.save(params_from_jax(params), tmp / "weights.pt")
    ds = SyntheticShapeDataset(n_items=16, n_pcl=64, n_uni=64, n_nss=64, n_eval=128,
                               seed=0)
    it = batch_iterator(ds, B, seed=5)
    batches = [{k: v.astype(np.float64) for k, v in next(it).items()} for _ in range(2)]
    save_batches(tmp / "batches.npz", batches)
    # the first half of the batch far off: its loss past the clip, the
    # mean's under it (or, with the lower clip, the other half's under it)
    far = {k: v.copy() for k, v in batches[0].items()}
    far["points_uni_value"][:B // 2] += 3.0
    save_batches(tmp / "far.npz", [far])
    trainer = port_trainer(str(tmp), spec(), str(tmp / "probe"))
    with torch.no_grad():
        losses = [float(trainer.model.loss(trainer._to_device(
            {k: v[rows] for k, v in far.items()}), None, train=True)[0])
            for rows in (slice(0, B // 2), slice(B // 2, B), slice(0, B))]
    first, second, mean = losses
    assert first > mean > second
    cases = {
        "plain": spec(),
        "draws": spec(dropout=0.2, loss=dict(center_aug_std=0.05, rot_aug=True)),
        "clip_shard": spec("far", loss_clip=(first + mean) / 2),
        "clip_global": spec("far", loss_clip=(second + mean) / 2),
    }
    spawn(train_child, 2, tmp, cases)
    spawn(train_child, 4, tmp, {"plain": cases["plain"]})
    return tmp, params, batches, cases


def unsharded(setup, case):
    tmp, _, batches, cases = setup
    spec_ = cases[case]
    with np.load(tmp / f"{spec_['batches']}.npz") as f:
        flat = dict(f)
    steps = [{k.split("/")[1]: v for k, v in flat.items() if k.startswith(f"{i}/")}
             for i in range(len({k.split('/')[0] for k in flat}))]
    trainer = port_trainer(str(tmp), spec_, str(tmp / f"unsharded_{case}"))
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in train_steps(trainer, steps).items()}


def assert_same_run(got, want, rtol=1e-10, atol=1e-10):
    assert got.keys() == want.keys()
    assert {"val_batch_loss", "val_iou", "step0_grad_norm"} <= set(want)
    for k in want:
        if k.startswith("param_"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
        else:  # iou is a float32 mean of float32 ratios on both sides
            np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k,
                                       rtol=1e-6 if k == "val_iou" else rtol)


def ranks(setup, case, world):
    out = [load(setup[0], f"train_{case}_{world}", r) for r in range(world)]
    for other in out[1:]:
        for k in out[0]:
            np.testing.assert_array_equal(other[k], out[0][k], err_msg=k)
    return out[0]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_equals_unsharded(setup, world):
    assert_same_run(ranks(setup, "plain", world), unsharded(setup, "plain"))


def test_sharded_step_matches_jax(setup):
    _, params, batches, _ = setup
    port = ranks(setup, "plain", 2)
    for mesh in (None, jax_make_mesh(jax.devices()[:8], axis_names=("dp",))):
        jt = jtrainer.Trainer(jax_model(), jtrainer.TrainerConfig(log_dir=str(
            setup[0] / f"jax_{mesh is None}"), **TRAINER), mesh=mesh)
        p = jax.tree.map(jnp.asarray, params)
        if mesh is not None:
            p = jax_replicate(p, mesh)
        state = jtrainer.TrainState(p, jt.optimizer.init(p), 0)
        for i, batch in enumerate(batches):
            m = jt.train_step(state, batch)
            np.testing.assert_allclose(port[f"step{i}_batch_loss"], float(m["batch_loss"]),
                                       rtol=1e-5)
        want = params_from_jax(jax.tree.map(np.asarray, state.params))
        for k, v in want.items():
            np.testing.assert_allclose(port[f"param_{k}"], v.numpy(), atol=1e-3, err_msg=k)


def test_draws_are_taken_over_the_global_batch(setup):
    got, want = ranks(setup, "draws", 2), unsharded(setup, "draws")
    assert_same_run(got, want)
    # the draws reached the step: it differs from the one without them
    plain = unsharded(setup, "plain")
    assert abs(want["step0_batch_loss"] - plain["step0_batch_loss"]) > 1e-6


def test_clamp_is_decided_on_the_global_loss(setup):
    shard, want = ranks(setup, "clip_shard", 2), unsharded(setup, "clip_shard")
    assert_same_run(shard, want)
    assert want["step0_grad_norm"] > 0.0
    clamped, want = ranks(setup, "clip_global", 2), unsharded(setup, "clip_global")
    assert_same_run(clamped, want)
    assert clamped["step0_grad_norm"] == 0.0
    start = params_from_jax(setup[1])
    for k, v in start.items():
        np.testing.assert_array_equal(clamped[f"param_{k}"], v.numpy(), err_msg=k)


def test_run_main_under_torchrun_environment(tmp_path):
    config = tiny_config(tmp_path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    run_main(tmp_path, config, 2, port, 2)
    ranks = [load(tmp_path, "run_main", r) for r in range(2)]
    assert int(ranks[0]["world"]) == 2 and int(ranks[0]["step"]) == 2
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    log_dir = tmp_path / "run"
    with open(log_dir / "metrics.jsonl") as f:
        train_lines = [r for r in map(json.loads, f) if r.get("phase") == "train"]
    assert [r["step"] for r in train_lines] == [1, 2]
    assert {"2.ckpt", "latest.ckpt"} <= set(os.listdir(log_dir / "checkpoint"))
    from livingscenes_tpu_torch.train import run as prun

    os.rename(log_dir, tmp_path / "run_sharded")
    start = {k: v.clone() for k, v in prun.build_model(
        prun.load_config(config), device="cpu").prior.state_dict().items()}
    trainer, state = prun.main(["--config", config, "--device", "cpu",
                                "--total-iter", "2"])
    got, want = [], []
    for k, v in trainer.model.prior.state_dict().items():
        np.testing.assert_allclose(ranks[0][f"param_{k}"], v.numpy(), atol=1e-3, err_msg=k)
        got.append((ranks[0][f"param_{k}"] - start[k].numpy()).ravel())
        want.append((v - start[k]).numpy().ravel())
    got, want = np.concatenate(got), np.concatenate(want)
    # the two steps' update itself, not only the parameters (lr 1e-4)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)

