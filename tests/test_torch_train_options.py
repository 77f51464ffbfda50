"""The port's training options and training-side tooling held against the
JAX package on the CPU, at the TINY configuration of
tests/test_torch_port_train.py with weights made with numpy and carried
across by params_from_jax:

- `rot_aug` (the rotations JAX draws from its "rot" key, passed to the
  port), the class head (`use_cls`, labels from the category index) and
  `decoder_bf16`, each: the loss, its metrics and the gradients of every
  parameter. In f64 (dropout and the centre jitter off): rtol 1e-9, each
  gradient to 1e-8 of its largest entry. decoder_bf16 rounds every layer to
  bfloat16 (8 bits of mantissa) on both sides, and XLA and PyTorch round
  different sums: the loss within 1e-2 relative, each tensor's gradient
  within 5e-2 of its largest entry in norm of the difference, and cosine
  above 0.999 overall (with f32 decode the difference is 1e-9);
- the class head as a third clipped component of the trainer;
- `Trainer.visualize_sample` (its PNG, OBJ, histogram and GIF) and the
  viz renderers, `write_png` byte for byte;
- `locate_nonfinite_modules` naming a poisoned module, the anomaly mode's
  report, and the other utils/debugging.py helpers (`profile_trace`'s
  spans file among them);
- the logger's histogram, mesh and video records.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu import se3 as jse3
from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.models import sim3recon as jsim
from livingscenes_tpu.recon.mesh import Mesh as JMesh
from livingscenes_tpu.train import logger as jlogger
from livingscenes_tpu.train import trainer as jtrainer
from livingscenes_tpu.utils import viz as jviz
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig
from livingscenes_tpu_torch.models.sim3recon import SIM3Recon, TrainLossConfig
from livingscenes_tpu_torch.recon.mesh import Mesh as TMesh
from livingscenes_tpu_torch.train import logger as tlogger
from livingscenes_tpu_torch.train.trainer import Trainer, TrainerConfig
from livingscenes_tpu_torch import tracing
from livingscenes_tpu_torch.utils import debugging as tdebug
from livingscenes_tpu_torch.utils import viz as tviz
from test_torch_port_train import TINY, B, batches, to_torch
from test_torch_solver_more import numpy_params
from torch_threads import intra_op_share  # noqa: F401 (autouse)

N_CATES = 5


def models(params, dtype=torch.float64, **loss):
    """The JAX and the port's SIM3Recon, TINY with the class head, the fused
    path, dropout and the centre jitter off; `loss`: TrainLossConfig
    fields."""
    common = dict(TINY, decoder_dropout_prob=0.0, use_cls=True, num_cates=N_CATES,
                  pallas_attention=True)
    jm = jsim.SIM3Recon(jsp.ShapePriorConfig(**common, parity=True),
                        jsim.TrainLossConfig(center_aug_std=0.0, **loss))
    tm = SIM3Recon(ShapePriorConfig(**common), TrainLossConfig(center_aug_std=0.0, **loss),
                   device="cpu", dtype=dtype)
    tm.prior.load_state_dict(params_from_jax(params))
    return jm, tm


@pytest.fixture(scope="module")
def params():
    cfg = jsp.ShapePriorConfig(**TINY, use_cls=True, num_cates=N_CATES)
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        numpy_params(jsp.ShapePrior(cfg), 5))


def class_batch(seed):
    batch = batches(1, seed=seed)[0]
    batch["class"] = (np.arange(B) % N_CATES).astype(np.float64)
    return batch


def loss_and_grads(jm, tm, params, batch, rng=None, rotations=None):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b, r: jm.loss(p, b, r, train=False), has_aux=True))(params, jb, rng)
    loss, metrics = tm.loss(to_torch(batch), None, train=False, rotations=rotations)
    names = [k for k, _ in tm.prior.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.prior.parameters()))))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(metrics) == set(jmetrics) and set(grads) == set(want)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads,
            float(jloss), {k: float(v) for k, v in jmetrics.items()}, want)


def assert_grads_close(grads, want, rtol=1e-8):
    overall = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-9 * overall)
        np.testing.assert_allclose(grads[k].double().numpy(), w.numpy(), rtol=0,
                                   atol=rtol * top, err_msg=k)


def test_rot_aug_matches_jax(params):
    """JAX rotates the clouds and the queries by se3.random_rotation of the
    third of split(rng, 3); the port gets those rotations."""
    jm, tm = models(params, rot_aug=True)
    batch = class_batch(2)
    rng = jax.random.PRNGKey(7)
    R = np.array(jse3.random_rotation(jax.random.split(rng, 3)[2], (B,)), np.float64)
    loss, metrics, grads, jloss, jmetrics, want = loss_and_grads(
        jm, tm, params, batch, rng, torch.from_numpy(R))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    assert_grads_close(grads, want)
    # the rotation is applied: without it the loss moves
    with torch.no_grad():
        plain, _ = tm.loss(to_torch(batch), None, train=False)
    assert abs(float(plain) - loss) > 1e-6 * abs(loss)
    # drawn from a generator when none is passed, inputs and queries alike
    from livingscenes_tpu_torch import se3 as tse3

    with torch.no_grad():
        drawn, _ = tm.loss(to_torch(batch), torch.Generator().manual_seed(0), train=False)
        Rg = tse3.random_rotation(torch.Generator().manual_seed(0), (B,),
                                  dtype=torch.float64)
        again, _ = tm.loss(to_torch(batch), None, train=False, rotations=Rg)
    assert float(drawn) == float(again)


def test_class_head_matches_jax(params):
    """The double softmax of the reference (softmax, then cross entropy's
    own log-softmax), w_cls 0.7, and its accuracy metric."""
    jm, tm = models(params, w_cls=0.7)
    loss, metrics, grads, jloss, jmetrics, want = loss_and_grads(
        jm, tm, params, class_batch(4))
    assert "loss_cls" in metrics and "metric_bs_cls_acc" in metrics
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    assert_grads_close(grads, want)
    assert float(grads["cls_head.lin2.kernel"].abs().max()) > 0
    jlogits = jm.prior.classify(params, jm._encode_training(
        params, jnp.asarray(class_batch(4)["inputs"]), None, False)[0])
    with torch.no_grad():
        codes = tm._encode_training(to_torch(class_batch(4))["inputs"], None, False)[0]
        np.testing.assert_allclose(tm.prior.classify(codes).numpy(), np.asarray(jlogits),
                                   rtol=1e-9, atol=1e-12)
    # without labels the head adds nothing
    batch = class_batch(4)
    del batch["class"]
    _, m = tm.loss(to_torch(batch), None, train=False)
    assert "loss_cls" not in m


def test_decoder_bf16_matches_jax(params):
    """JAX's decode in bfloat16 against the port's, in an f32 model; the
    gradient reaches the float32 decoder parameters."""
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    jm, tm = models(p32, dtype=torch.float32, decoder_bf16=True)
    batch = {k: v.astype(np.float32) for k, v in class_batch(6).items()}
    loss, metrics, grads, jloss, jmetrics, want = loss_and_grads(jm, tm, p32, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    for k in ("loss_recon_uni", "loss_recon_nss", "loss_cls"):
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-2, err_msg=k)
    dot = sum(float((grads[k].double() * want[k].double()).sum()) for k in want)
    norm = lambda d: np.sqrt(sum(float((v.double() ** 2).sum()) for v in d.values()))
    assert dot / (norm(grads) * norm(want)) > 0.999
    for k, w in want.items():
        if k.startswith("decoder."):
            assert grads[k].dtype == torch.float32
            diff = float((grads[k].double() - w.double()).norm())
            assert diff <= 5e-2 * float(w.double().norm()) + 1e-12, k
    # the same model in f32 decode is JAX's f32 decode to rounding
    jm32, tm32 = models(p32, dtype=torch.float32)
    loss32, _, _, jloss32, _, _ = loss_and_grads(jm32, tm32, p32, batch)
    np.testing.assert_allclose(loss32, jloss32, rtol=1e-5)
    assert abs(loss - loss32) > 1e-6 * abs(loss32)


def test_cls_head_is_a_third_clip_component(params, tmp_path):
    _, tm = models(params)
    trainer = Trainer(tm, TrainerConfig(batch_size=B, log_dir=str(tmp_path), grad_clip=1.0))
    assert list(trainer.components) == ["encoder", "decoder", "cls_head"]
    rng = np.random.default_rng(0)
    scales = {"encoder": 0.01, "decoder": 10.0, "cls_head": 5.0}
    names = [k for k, _ in tm.prior.named_parameters()]
    grads = [torch.as_tensor(rng.normal(size=p.shape)) * scales[n.split(".")[0]]
             for n, p in zip(names, trainer.params)]
    assert [n.split(".")[0] for n in names] == (
        ["encoder"] * len(trainer.components["encoder"])
        + ["decoder"] * len(trainer.components["decoder"])
        + ["cls_head"] * len(trainer.components["cls_head"]))
    state = trainer.init_state()
    trainer.apply_gradients(state, grads)
    clipped = [m / 0.1 for m in state.opt_state["mu"]]
    tree = {"encoder": {}, "decoder": {}, "cls_head": {}}
    for name, g in zip(names, grads):
        tree[name.split(".")[0]][name] = jnp.asarray(g.numpy())
    clip = jtrainer._clip_by_global_norm_per_component(1.0)
    want, _ = clip.update(tree, clip.init(tree))
    for name, c in zip(names, clipped):
        np.testing.assert_allclose(c.numpy(), np.asarray(want[name.split(".")[0]][name]),
                                   rtol=1e-9, err_msg=name)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_visualize_sample_writes_jax_files(params, tmp_path):
    """The same weights (f64) and validation batch: the input render's PNG
    equal byte for byte, the mesh's faces equal and its vertices within
    1e-6, the z_inv histogram record to rtol 1e-9 but for its time, a GIF of the
    turntable; then the viz cadence of Trainer.run writes them too."""
    jm, tm = models(params)
    batch = class_batch(8)
    cfg = dict(batch_size=B, viz_mesh_resolution=16, checkpoint_iter=0)
    jt = jtrainer.Trainer(jm, jtrainer.TrainerConfig(log_dir=str(tmp_path / "jax"), **cfg))
    jstate = jtrainer.TrainState(jax.tree.map(jnp.asarray, params), None, 0)
    jt.visualize_sample(jstate, batch, 3)
    pt = Trainer(tm, TrainerConfig(log_dir=str(tmp_path / "port"), **cfg))
    pt.visualize_sample(pt.init_state(), batch, 3)
    jdir, tdir = tmp_path / "jax" / "viz", tmp_path / "port" / "viz"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "input_3.png", "recon_3.obj", "recon_3.png"]
    assert (tdir / "input_3.png").read_bytes() == (jdir / "input_3.png").read_bytes()

    def obj(path):
        rows = path.read_text().split("\n")
        v = np.array([[float(x) for x in r.split()[1:]] for r in rows if r.startswith("v ")])
        f = np.array([[int(x) for x in r.split()[1:]] for r in rows if r.startswith("f ")])
        return v, f

    (vt, ft), (vj, fj) = obj(tdir / "recon_3.obj"), obj(jdir / "recon_3.obj")
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    ht, hj = read_jsonl(tmp_path / "port" / "metrics.jsonl"), read_jsonl(
        tmp_path / "jax" / "metrics.jsonl")
    for rec in ht + hj:
        rec.pop("time")
    assert [r["hist"] for r in ht] == ["z_inv"]
    assert ht[0].keys() == hj[0].keys()
    for k, v in hj[0].items():
        if isinstance(v, float):
            np.testing.assert_allclose(ht[0][k], v, rtol=1e-9, err_msg=k)
        else:
            assert ht[0][k] == v, k
    assert (tmp_path / "port" / "videos" / "recon_turntable_3.gif").exists()

    # Trainer.run fires it every viz_iter_interval steps
    run_dir = tmp_path / "run"
    trainer = Trainer(models(params)[1], TrainerConfig(
        log_dir=str(run_dir), viz_iter_interval=2, log_every=100, eval_every_iter=100,
        **cfg))
    data = batches(3, seed=9)
    trainer.run(trainer.init_state(), iter(data), lambda: iter(data), total_iter=2)
    assert sorted(os.listdir(run_dir / "viz")) == ["input_2.png", "recon_2.obj",
                                                   "recon_2.png"]


def test_write_png_and_renders_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (17, 23, 3), dtype=np.uint8),
              rng.integers(0, 256, (9, 12), dtype=np.uint8),
              rng.normal(100, 120, (8, 5, 3))]
    for i, img in enumerate(images):
        pj, pt = tmp_path / f"j{i}.png", tmp_path / f"t{i}.png"
        jviz.write_png(str(pj), img)
        tviz.write_png(str(pt), img)
        assert pt.read_bytes() == pj.read_bytes()
        assert pt.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    clouds = [rng.normal(size=(300, 3)), rng.normal(size=(200, 3)) + 2.0]
    np.testing.assert_array_equal(tviz.render_pointcloud_image(clouds, size=64),
                                  jviz.render_pointcloud_image(clouds, size=64))
    g = np.linspace(-1, 1, 17)
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    from livingscenes_tpu.native.bindings import marching_isosurface

    verts, faces = marching_isosurface((0.6 - np.linalg.norm(p, axis=-1)).astype(np.float32), 0.0)
    np.testing.assert_array_equal(tviz.render_mesh_image(TMesh(verts, faces), size=48),
                                  jviz.render_mesh_image(JMesh(verts, faces), size=48))
    empty = TMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert (tviz.render_mesh_image(empty, size=8) == 255).all()
    m0 = np.array([1, -1])
    np.testing.assert_array_equal(
        tviz.visualize_shape_matching(clouds, clouds[::-1], m0, size=48),
        jviz.visualize_shape_matching(clouds, clouds[::-1], m0, size=48))
    T = np.eye(4)
    T[:3, 3] = [0.1, 0.2, 0.3]
    np.testing.assert_array_equal(
        tviz.visualize_registration(clouds[0], clouds[1], T, T, size=48),
        jviz.visualize_registration(clouds[0], clouds[1], T, T, size=48))


def test_logger_records_equal_jax(tmp_path):
    jl, tl = jlogger.TrainLogger(str(tmp_path / "jax")), tlogger.TrainLogger(str(tmp_path / "port"))
    values = np.random.default_rng(2).normal(size=(4, 50))
    for lg in (jl, tl):
        lg.log_histogram("val", 5, "z", values)
        lg.log_histogram("val", 6, "empty", np.zeros(0))
    ht, hj = (read_jsonl(tmp_path / d / "metrics.jsonl") for d in ("port", "jax"))
    for rec in ht + hj:
        rec.pop("time")
    assert ht == hj and len(ht) == 1
    verts = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    jl.log_mesh("m", 2, JMesh(verts, faces))
    tl.log_mesh("m", 2, TMesh(verts, faces))
    assert ((tmp_path / "port" / "meshes" / "m_2.obj").read_bytes()
            == (tmp_path / "jax" / "meshes" / "m_2.obj").read_bytes())
    frames = np.random.default_rng(4).random((3, 1, 10, 12))
    pj, pt = jl.log_video("v", 1, frames, fps=5), tl.log_video("v", 1, frames, fps=5)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    with pytest.raises(ValueError):
        tl.log_video("bad", 1, np.zeros((4, 4)))


def poisoned(params, name):
    _, tm = models(params)
    with torch.no_grad():
        dict(tm.prior.named_parameters())[name].view(-1)[0] = float("nan")
    return tm


def test_locate_nonfinite_modules_names_the_poisoned_module(params):
    batch = to_torch(class_batch(1))
    x = batch["inputs"] - batch["inputs"].mean(dim=1, keepdim=True)
    tm = poisoned(params, "encoder.Q_list.3.lin.weight")
    _, bad = tdebug.locate_nonfinite_modules(tm.prior.encoder, x)
    # innermost first: the poisoned layer, its activation, then the block
    assert bad[0] == "Q_list.3.lin:VecLinear"
    assert bad.index("Q_list.3:VecLNA") < bad.index("global_conv_list.1:VecLNA")
    assert bad[-1] == "<root>:VecDGCNNAttn"
    assert not any(b.startswith(("Q_list.2", "global_conv_list.0")) for b in bad)
    assert tdebug.nonfinite_parameters(tm.prior) == ["encoder.Q_list.3.lin.weight"]
    clean = poisoned(params, "encoder.Q_list.3.lin.weight")
    clean.prior.load_state_dict(params_from_jax(params))
    out, bad = tdebug.locate_nonfinite_modules(clean.prior.encoder, x)
    assert bad == [] and all(torch.isfinite(o).all() for o in out)


def test_anomaly_mode_names_the_module(params, tmp_path):
    """A NaN in one encoder parameter: the step raises before the update,
    naming the modules whose forward goes non-finite and the parameter; a
    weight that the fused layers read without calling its module is named
    among the parameters."""
    for name, module in (("encoder.conv_c.lin.weight", "conv_c.lin:VecLinear"),
                         ("encoder.V_list.0.lin.weight", "Q_list.2.lin:VecLinear")):
        tm = poisoned(params, name)
        trainer = Trainer(tm, TrainerConfig(batch_size=B, log_dir=str(tmp_path),
                                            anomaly=True))
        state = trainer.init_state()
        before = {k: v.clone() for k, v in tm.prior.state_dict().items()}
        with pytest.raises(RuntimeError, match="non-finite") as err:
            trainer.train_step(state, class_batch(3))
        msg = str(err.value)
        assert module in msg and name in msg and "at step 1" in msg
        assert state.step == 0 and state.opt_state["count"] == 0
        for k, v in tm.prior.state_dict().items():
            assert torch.equal(v, before[k]) or k == name, k


def test_debugging_helpers(tmp_path, caplog):
    def step(x):
        return {"loss": x.sum(), "parts": [x, torch.ones(2, dtype=torch.long)]}

    safe = tdebug.checkify_nan(step)
    assert float(safe(torch.ones(3))["loss"]) == 3.0
    with pytest.raises(FloatingPointError, match="loss"):
        safe(torch.tensor([1.0, float("nan")]))
    with pytest.raises(FloatingPointError, match="parts/0"):
        safe(torch.tensor([float("inf")]))
    with pytest.raises(FloatingPointError, match=r"\['0'\]"):
        tdebug.checkify_nan(lambda x: [x])(torch.tensor([float("inf")]))
    with caplog.at_level("ERROR"):
        bad = tdebug.assert_finite({"a": torch.ones(2), "b": {"c": torch.tensor([np.nan])}},
                                   name="grads")
    assert bad == ["b/c"] and "grads/b/c" in caplog.text
    with tdebug.profile_trace(str(tmp_path), label="mm"):
        for _ in range(2):
            with tracing.span("a"):
                torch.randn(64, 64) @ torch.randn(64, 64)
        with pytest.raises(KeyError):
            with tracing.span("b"):
                raise KeyError("x")
    assert json.load(open(tmp_path / "mm.json"))
    spans = json.load(open(tmp_path / "mm.spans.json"))["spans"]
    assert [s["name"] for s in spans] == ["a", "a", "b"]
    assert all(s["host_end_ms"] >= s["host_start_ms"] and s["parent"] is None
               and s["device_start_ms"] is None for s in spans)
    assert len({s["call"] for s in spans}) == 3
    with tdebug.profile_trace(None, label="plain"):
        pass
    assert tdebug.device_memory_stats() == {}
