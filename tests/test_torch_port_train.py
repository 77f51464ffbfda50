"""The port's training path (models/sim3recon.py, train/trainer.py,
train/run.py) held against the JAX package on the CPU, at the small TINY
configuration of tests/test_train.py (4 layers, feat_dim (16, 16, 32, 32),
heads of 8, K 8, decoder 8 x 96, 64 points). The same parameters (the JAX
init, through params_from_jax) and the same batches (the synthetic dataset)
go into both sides, with the fused-layer configuration on the port (its
autograd Functions; plain VJPs on the CPU) and JAX's parity path.

Tolerances (f64, dropout and centre jitter off): the loss and its metrics
rtol 1e-9; the gradients rtol 1e-8 of each tensor's largest entry; after
each of three Trainer steps the parameters within 1e-10 (updates are about
1e-4) and grad_norm rtol 1e-8; the learning rate rtol 1e-6 (JAX computes
it in f32). The resumed run equals the uninterrupted one exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.models import sim3recon as jsim
from livingscenes_tpu.train import trainer as jtrainer
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig
from livingscenes_tpu_torch.models.sim3recon import SIM3Recon, TrainLossConfig
from livingscenes_tpu_torch.train import run as prun
from livingscenes_tpu_torch.train.data import SyntheticShapeDataset, batch_iterator
from livingscenes_tpu_torch.train.trainer import (
    Trainer, TrainerConfig, make_lr_schedule)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

TINY = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
            down_sample_layers=(2,), down_sample_factor=(2,),
            atten_start_layer=2, atten_multi_head_c=8, num_knn=8,
            scale_factor=10.0, decoder_dims=(96,) * 8, n_pcl=64)
B = 4


def jax_model(dropout=0.0, center_aug_std=0.0):
    cfg = jsp.ShapePriorConfig(**TINY, decoder_dropout_prob=dropout,
                               pallas_attention=True, parity=True)
    return jsim.SIM3Recon(cfg, jsim.TrainLossConfig(center_aug_std=center_aug_std))


def port_model(params, dtype=torch.float64, dropout=0.0, center_aug_std=0.0):
    cfg = ShapePriorConfig(**TINY, decoder_dropout_prob=dropout,
                           pallas_attention=True)
    m = SIM3Recon(cfg, TrainLossConfig(center_aug_std=center_aug_std),
                  device="cpu", dtype=dtype)
    m.prior.load_state_dict(params_from_jax(params))
    return m


@pytest.fixture(scope="module")
def params():
    """The JAX init of TINY, as f64 numpy."""
    p = jax.jit(jax_model().init_params)(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), p)


def batches(n, seed=0):
    ds = SyntheticShapeDataset(n_items=8, n_pcl=64, n_uni=64, n_nss=64,
                               n_eval=128, seed=seed)
    it = batch_iterator(ds, B, seed=seed)
    return [{k: v.astype(np.float64) for k, v in next(it).items()} for _ in range(n)]


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def grads_by_key(model):
    return {k: p.grad for k, p in model.prior.named_parameters()}


def test_loss_metrics_and_grads_match_jax(params):
    batch = batches(1)[0]
    jm = jax_model()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, None, train=False), has_aux=True))(params, jb)
    m = port_model(params)
    loss, metrics = m.loss(to_torch(batch), None, train=False)
    loss.backward()
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-9)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = grads_by_key(m)
    assert set(got) == set(want)
    # a tensor whose gradient is 0 up to rounding (the 1 x 1 direction of a
    # scale-invariant activation) is held to the largest entry overall
    overall = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-9 * overall)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-8 * top, err_msg=k)


def test_val_iou_matches_jax(params):
    batch = batches(1, seed=3)[0]
    jm = jax_model()
    want = np.asarray(jax.jit(jm.val_iou)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port_model(params).val_iou(to_torch(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def make_trainers(params, tmp_path, **kw):
    cfg = dict(batch_size=B, log_every=1, checkpoint_iter=0, **kw)
    jt = jtrainer.Trainer(jax_model(), jtrainer.TrainerConfig(
        log_dir=str(tmp_path / "jax"), **cfg))
    pt = Trainer(port_model(params), TrainerConfig(
        log_dir=str(tmp_path / "port"), **cfg))
    return jt, pt


def test_three_trainer_steps_match_jax(params, tmp_path):
    jt, pt = make_trainers(params, tmp_path, lr=1e-3, grad_clip=0.5)
    jstate = jtrainer.TrainState(params, jt.optimizer.init(params), 0)
    pstate = pt.init_state()
    for step, batch in enumerate(batches(3, seed=5)):
        jm = jt.train_step(jstate, batch)
        pm = pt.train_step(pstate, batch)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-8)
        np.testing.assert_allclose(float(pm["batch_loss"]), float(jm["batch_loss"]),
                                   rtol=1e-9)
        want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
        for k, p in pt.model.prior.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-10, err_msg=f"step {step} {k}")
    assert pstate.step == jstate.step == 3


def test_lr_schedule_matches_optax():
    cfg = dict(lr=1e-4, decay_schedule=(24000, 30000, 36000),
               decay_factor=(0.3, 0.3, 0.3), lr_min=1e-8)
    want = jtrainer.make_lr_schedule(jtrainer.TrainerConfig(**cfg))
    got = make_lr_schedule(TrainerConfig(**cfg))
    for b in (0, 24000, 30000, 36000):
        for step in (b - 1, b, b + 1):
            if step >= 0:
                np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    floor = TrainerConfig(lr=1e-4, decay_schedule=(1, 2), decay_factor=(1e-3, 1e-3),
                          lr_min=1e-9)
    assert make_lr_schedule(floor)(5) == 1e-9


def test_loss_clamp_zeroes_the_gradient(params, tmp_path):
    trainer = Trainer(port_model(params), TrainerConfig(
        batch_size=B, log_dir=str(tmp_path), loss_clip=1e-9))
    state = trainer.init_state()
    before = {k: v.clone() for k, v in trainer.model.prior.state_dict().items()}
    metrics = trainer.train_step(state, batches(1)[0])
    assert float(metrics["grad_norm"]) == 0.0 and float(metrics["batch_loss"]) > 1e-9
    for k, v in trainer.model.prior.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_per_component_clip_matches_jax(params, tmp_path):
    """Encoder and decoder gradients are clipped to grad_clip each: Adam's
    first moment after one step is (1 - b1) times the clipped gradient."""
    trainer = Trainer(port_model(params), TrainerConfig(
        batch_size=B, log_dir=str(tmp_path), grad_clip=1.0))
    rng = np.random.default_rng(0)
    grads = [torch.as_tensor(rng.normal(size=p.shape)) for p in trainer.params]
    n_enc = len(trainer.components["encoder"])
    grads = ([g * 0.01 for g in grads[:n_enc]] + [g * 10.0 for g in grads[n_enc:]])
    state = trainer.init_state()
    grad_norm = trainer.apply_gradients(state, grads)
    clipped = [m / 0.1 for m in state.opt_state["mu"]]

    names = [k for k, _ in trainer.model.prior.named_parameters()]
    tree = {"encoder": {}, "decoder": {}}
    for name, g in zip(names, grads):
        tree[name.split(".")[0]][name] = jnp.asarray(g.numpy())
    clip = jtrainer._clip_by_global_norm_per_component(1.0)
    want, _ = clip.update(tree, clip.init(tree))
    for name, c in zip(names, clipped):
        np.testing.assert_allclose(c.numpy(), np.asarray(want[name.split(".")[0]][name]),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(float(grad_norm), float(jnp.sqrt(sum(
        jnp.sum(jnp.asarray(g.numpy()) ** 2) for g in grads))), rtol=1e-9)


def test_resume_equals_uninterrupted_run(params, tmp_path):
    """With dropout and the centre jitter on, a run resumed from `latest` at
    step 2 draws what the uninterrupted run draws at step 3."""
    data = batches(3, seed=7)

    def trainer(log_dir):
        return Trainer(port_model(params, dropout=0.2, center_aug_std=0.05),
                       TrainerConfig(batch_size=B, log_dir=str(log_dir)))

    a = trainer(tmp_path / "a")
    sa = a.init_state()
    for batch in data:
        a.train_step(sa, batch)

    b = trainer(tmp_path / "b")
    sb = b.init_state()
    for batch in data[:2]:
        b.train_step(sb, batch)
    b.save_checkpoint(sb, "latest")
    c = trainer(tmp_path / "b")
    sc = c.load_checkpoint(c.init_state(), "latest")
    assert sc.step == 2
    c.train_step(sc, data[2])
    for (k, v), w in zip(c.model.prior.state_dict().items(),
                         a.model.prior.state_dict().values()):
        assert torch.equal(v, w), k
    for u, w in zip(sc.opt_state["mu"] + sc.opt_state["nu"],
                    sa.opt_state["mu"] + sa.opt_state["nu"]):
        assert torch.equal(u, w)


def tiny_config(tmp_path):
    text = """inherit_from: {root}/configs/default.yaml
model:
  encoder:
    c_dim: 32
    num_layers: 4
    feat_dim: [16, 16, 32, 32]
    down_sample_layers: [2]
    down_sample_factor: [2]
    atten_multi_head_c: 8
    num_knn: 8
    scale_factor: 10.0
  decoder:
    dims: [96, 96, 96, 96, 96, 96, 96, 96]
dataset:
  n_train_items: 8
  n_val_items: 4
  n_pcl: 64
  n_query_uni: 64
  n_query_nss: 64
  n_query_eval: 128
  cache_workers: 1
training:
  batch_size: 4
evaluation:
  eval_every_iter: 2
  eval_batches: 1
logging:
  log_dir: {log}
  checkpoint_iter: 2
  log_every: 1
""".format(root=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
           log=tmp_path / "run")
    path = tmp_path / "tiny.yaml"
    path.write_text(text)
    return str(path)


def test_init_from_jax_checkpoint_loads_params_only(params, tmp_path):
    """--init-from a checkpoint that JAX's Trainer wrote (params, a non-zero
    opt_state, step 5): the port takes the parameters and starts its
    optimizer and schedule afresh."""
    jt = jtrainer.Trainer(jax_model(), jtrainer.TrainerConfig(
        batch_size=B, log_dir=str(tmp_path / "jax"), checkpoint_iter=0))
    jstate = jt.init_state()
    jstate.opt_state = jax.tree.map(lambda a: a + 1, jstate.opt_state)
    jstate.step = 5
    jt.save_checkpoint(jstate, "latest")
    path = str(tmp_path / "jax" / "checkpoint" / "latest.ckpt")
    trainer, state = prun.main(["--config", tiny_config(tmp_path), "--device", "cpu",
                                "--init-from", path, "--total-iter", "0"])
    assert state.step == 0 and state.opt_state["count"] == 0
    assert all(not bool(m.any()) for m in state.opt_state["mu"])
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in trainer.model.prior.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)

    # and from a checkpoint of the port's own trainer, then resume
    trainer, state = prun.main(["--config", tiny_config(tmp_path), "--device", "cpu",
                                "--total-iter", "2"])
    ckpt = os.path.join(trainer.cfg.log_dir, "checkpoint")
    assert {"2.ckpt", "latest.ckpt", "selected.ckpt", "selected.metric"} <= set(
        os.listdir(ckpt))
    own = prun.load_init_params(os.path.join(ckpt, "latest.ckpt"))
    for k, v in trainer.model.prior.state_dict().items():
        assert torch.equal(own[k], v), k
    trainer, state = prun.main(["--config", tiny_config(tmp_path), "--device", "cpu",
                                "--resume", "latest", "--total-iter", "3"])
    assert state.step == 3


def test_run_epochs_takes_whole_passes(params, tmp_path):
    """Two passes over 8 items at batch 4 are 4 steps, then `latest`."""
    trainer = Trainer(port_model(params, dtype=torch.float32), TrainerConfig(
        batch_size=B, log_dir=str(tmp_path), checkpoint_iter=0))
    ds = SyntheticShapeDataset(n_items=8, n_pcl=64, n_uni=64, n_nss=64, n_eval=128)
    state = trainer.run_epochs(trainer.init_state(), ds, epochs=2)
    assert state.step == 4
    assert os.listdir(os.path.join(str(tmp_path), "checkpoint")) == ["latest.ckpt"]


def test_unported_options_raise(tmp_path):
    """build_model raises what JAX's raises: an unknown decoder_type (onet)
    and an unknown encoder_type give ValueError; center_pred: false,
    center_pred_scale: false and the decoder types deepsdf, inner and
    inv_mlp build; the other ported options (rot_aug, decoder_bf16,
    viz_iter_interval) build too."""
    with pytest.raises(ValueError, match="unknown decoder_type onet"):
        prun.build_model({"model": {"decoder_type": "onet"}}, device="cpu")
    with pytest.raises(ValueError, match="unknown encoder_type"):
        SIM3Recon(ShapePriorConfig(**TINY, encoder_type="pointnet2"), device="cpu")
    for key, value in (("center_pred", False), ("center_pred_scale", False),
                       ("decoder_type", "deepsdf"), ("decoder_type", "inner"),
                       ("decoder_type", "inv_mlp")):
        cfg = {"model": {"encoder": {}}}
        (cfg["model"] if key == "decoder_type" else cfg["model"]["encoder"])[key] = value
        model = prun.build_model(cfg, device="cpu")
        assert getattr(model.config, key) == value
    cfg = {"model": {"encoder": {"center_pred": False}}}
    assert not hasattr(prun.build_model(cfg, device="cpu").prior.encoder, "fc_center")
    cfg = {"model": {"rot_aug": True, "decoder_bf16": True}}
    loss_cfg = prun.build_model(cfg, device="cpu").loss_cfg
    assert loss_cfg.rot_aug and loss_cfg.decoder_bf16
    model = SIM3Recon(ShapePriorConfig(**TINY), TrainLossConfig(rot_aug=True,
                      decoder_bf16=True), device="cpu")
    trainer = Trainer(model, TrainerConfig(log_dir=str(tmp_path), viz_iter_interval=5))
    assert trainer.cfg.viz_iter_interval == 5


def test_deepsdf_decoder_type_is_inner_deepsdf(tmp_path):
    """decoder_type: deepsdf builds the DeepSDF decoder of inner_deepsdf
    (JAX models/shape_prior.py:125): the same parameters from the same seed
    and the same loss on the same batch, bit for bit."""
    models = []
    for decoder_type in ("inner_deepsdf", "deepsdf"):
        cfg = prun.apply_overrides(prun.load_config(tiny_config(tmp_path)),
                                   [f"model.decoder_type={decoder_type}"])
        models.append(prun.build_model(cfg, device="cpu"))
    a, b = (m.prior.state_dict() for m in models)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    batch = to_torch({k: v.astype(np.float32) for k, v in batches(1)[0].items()})
    losses = [m.loss(batch, torch.Generator().manual_seed(3), train=True)[0]
              for m in models]
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("override", ["model.decoder_type=inner",
                                      "model.decoder_type=inv_mlp",
                                      "model.decoder_type=deepsdf",
                                      "model.encoder.center_pred=false"])
def test_model_variants_train_from_yaml(tmp_path, override):
    """A YAML with each of these options trains through train.run.main on
    the CPU: two steps, a finite loss, the option in the model."""
    trainer, state = prun.main(["--config", tiny_config(tmp_path), "--device", "cpu",
                                "--total-iter", "2", "--override", override])
    assert state.step == 2
    key, value = override.rsplit(".", 1)[1].split("=")
    want = {"false": False}.get(value, value)
    assert getattr(trainer.model.config, key) == want
    with open(os.path.join(trainer.cfg.log_dir, "metrics.jsonl")) as f:
        last = [r for r in map(json.loads, f) if "grad_norm" in r][-1]
    assert last["step"] == 2
    assert np.isfinite(last["batch_loss"]) and np.isfinite(last["grad_norm"])


def test_anomaly_mode_raises_on_nan(params, tmp_path):
    trainer = Trainer(port_model(params), TrainerConfig(
        batch_size=B, log_dir=str(tmp_path), anomaly=True))
    state = trainer.init_state()
    batch = batches(1)[0]
    trainer.train_step(state, batch)
    batch["inputs"][0, 0, 0] = np.nan
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train_step(state, batch)


def test_dropout_follows_flax_semantics():
    """Train mode drops with probability p and scales the rest by 1/(1-p),
    from the generator given; eval mode is the identity; train mode without
    a generator refuses."""
    from livingscenes_tpu_torch.nn.deepsdf import DeepSDFDecoder, dropout

    h = torch.ones((200, 500), dtype=torch.float64)
    g = torch.Generator().manual_seed(3)
    out = dropout(h, 0.2, g)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1.25))
    assert abs(float(kept.double().mean()) - 0.8) < 0.01
    again = dropout(h, 0.2, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    dec = DeepSDFDecoder(latent_size=2, dims=(8,) * 8, pe_dim=2).double()
    for mod in dec.lin:
        mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((3, 4), dtype=torch.float64)
    dec.train()
    with pytest.raises(ValueError, match="generator"):
        dec(x)
    dec.eval()
    assert torch.equal(dec(x), dec(x, torch.Generator()))
