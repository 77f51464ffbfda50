"""The port's model options held against the JAX package on the CPU: the
ShapePriorConfig fields and registries, the positional-encoding query and
its converter round trip, DecoderCat through decode_sdf (also with
bfloat16 products), the SIM3Recon loss and gradient of four variants, and
the UDF surface extraction with JAX's draws.

Tolerances (float64): codes, queries, SDF values, losses and metrics rtol
1e-9; gradients within 1e-8 of each tensor's largest entry (as
tests/test_torch_port_train.py), and a gradient that is zero up to rounding
(the 1 x 1 direction weight of a scale-invariant activation, 1e-17) within
1e-16 of the largest entry of all, float64's rounding; UDF points within 1e-9 and the masks
equal, then JAX's own sphere check (tests/test_aux.py:77). decode_sdf with
bfloat16 products against float32: within 3e-2 (bfloat16's 2^-8 through
six layers), and against JAX's bfloat16 decode within 3e-2 too (both cast
the same weights; the products' roundings differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import convert as jconvert
from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.models import sim3recon as jsim
from livingscenes_tpu.recon import udf as judf
from livingscenes_tpu_torch.models import convert
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.models.sim3recon import SIM3Recon, TrainLossConfig
from livingscenes_tpu_torch.recon.udf import (
    UDFDraws, UDFExtractorConfig, extract_surface_points)
from livingscenes_tpu_torch.train.data import SyntheticShapeDataset, batch_iterator
from torch_threads import intra_op_share  # noqa: F401 (autouse)

TINY = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
            down_sample_layers=(2,), down_sample_factor=(2,),
            atten_start_layer=2, atten_multi_head_c=8, num_knn=8,
            scale_factor=10.0, decoder_dims=(96,) * 8, n_pcl=64)


def random_params(jcfg, seed=0):
    """Parameters of JAX's tree for jcfg, drawn with numpy (a jitted init
    costs seconds a configuration): normal / sqrt(fan in)."""
    shapes = jax.eval_shape(jsp.ShapePrior(jcfg).init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape) / np.sqrt(s.shape[0] if s.shape else 1),
        shapes)


def port_prior(cfg_kw, params, dtype=torch.float64):
    m = ShapePrior(ShapePriorConfig(**cfg_kw), device="cpu", dtype=dtype)
    m.load_state_dict(convert.params_from_jax(params))
    return m


def test_config_has_every_jax_field_with_its_default():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jsp.ShapePriorConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(ShapePriorConfig)}
    assert set(jax_fields) <= set(port_fields)
    for name, default in jax_fields.items():
        assert port_fields[name] == default, name
    assert ShapePriorConfig(**TINY, use_pe=True, pe_src=8, pe_pow=3).pe_channels == \
        jsp.ShapePriorConfig(**TINY, use_pe=True, pe_src=8, pe_pow=3).pe_channels == 56
    cfg = ShapePriorConfig(pallas_attention=True, mixed_precision=True, parity=True)
    assert not cfg.fused
    enc = cfg.build_encoder()
    assert not enc.pallas_attention and not enc.mixed_precision


@pytest.mark.parametrize("field,value", [("encoder_type", "pointnet2"),
                                         ("decoder_type", "onet")])
def test_unknown_types_raise_as_jax(field, value):
    with pytest.raises(ValueError, match=f"unknown {field}"):
        getattr(jsp.ShapePriorConfig(**{field: value}),
                f"build_{field.split('_')[0]}")()
    with pytest.raises(ValueError, match=f"unknown {field}"):
        ShapePrior(ShapePriorConfig(**{field: value}), device="cpu")


PE = dict(TINY, decoder_dims=(192,) * 8, use_pe=True, pe_src=8, pe_pow=3)


def test_pe_query_and_decode_match_jax():
    """tests/test_model_surface.py:163: the PE tail of the invariant query
    and the decode, against JAX; the SDF is invariant under a rotation of
    the cloud and the queries."""
    jcfg = jsp.ShapePriorConfig(**PE, parity=True)
    jm = jsp.ShapePrior(jcfg)
    params = random_params(jcfg)
    rng = np.random.default_rng(0)
    pc, query = rng.normal(size=(2, 64, 3)), rng.normal(size=(2, 16, 3))
    codes = jax.jit(jm.encode)(params, jnp.asarray(pc))
    want_x = jax.jit(lambda q, c, p: jm.invariant_query(q, c, params=p))(
        jnp.asarray(query), codes, params)
    want = jax.jit(jm.decode_sdf)(params, jnp.asarray(query), codes)
    m = port_prior(PE, params)
    with torch.no_grad():
        c = m.encode(torch.from_numpy(pc))
        x = m.invariant_query(torch.from_numpy(query), c)
        sdf = m.decode_sdf(torch.from_numpy(query), c)
        assert x.shape[-1] == 2 * 32 + 1 + 8 * (1 + 2 * 3)
        np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sdf.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
        R = torch.from_numpy(Rotation.random(2, random_state=1).as_matrix())
        rot = lambda a: torch.einsum("bij,bnj->bni", R, torch.from_numpy(a))
        sdf_rot = m.decode_sdf(rot(query), m.encode(rot(pc)))
    np.testing.assert_allclose(sdf_rot.numpy(), sdf.numpy(), atol=1e-8)


def test_pe_projector_round_trips_through_the_converters():
    """tests/test_model_surface.py:196: the reference layout's
    network_dict.pe_projector.weight, JAX's export read by the port and the
    port's export equal to JAX's; params_to_jax inverts params_from_jax."""
    jcfg = jsp.ShapePriorConfig(**PE)
    params = random_params(jcfg, seed=1)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in jconvert.params_to_torch_state_dict(params).items()}
    assert "network_dict.pe_projector.weight" in sd
    state = convert.state_dict_from_torch(sd)
    m = port_prior(PE, params)
    assert set(state) == set(m.state_dict())
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy(), err_msg=k)
    back = convert.state_dict_to_torch(state)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    tree = convert.params_to_jax(convert.params_from_jax(params))
    flat = lambda t: {"/".join(map(str, p)): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(params), flat(tree)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["inner", "inv_mlp"])
def test_decoder_cat_decode_matches_jax(dtype):
    kw = dict(TINY, decoder_type=dtype)
    jcfg = jsp.ShapePriorConfig(**kw, parity=True)
    jm = jsp.ShapePrior(jcfg)
    params = random_params(jcfg, seed=2)
    assert set(params["decoder"]) == {"fc_in", "fc_out"} | {
        f"block{i}_fc{j}" for i in range(5) for j in (0, 1)}
    rng = np.random.default_rng(3)
    pc, query = rng.normal(size=(2, 64, 3)), rng.normal(size=(2, 20, 3))
    codes = jax.jit(jm.encode)(params, jnp.asarray(pc))
    want = np.asarray(jax.jit(jm.decode_sdf)(params, jnp.asarray(query), codes))
    want16 = np.asarray(jm.decode_sdf(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params),
        jnp.asarray(query, jnp.float32),
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), codes),
        matmul_dtype=jnp.bfloat16))
    m = port_prior(kw, params)
    with torch.no_grad():
        c = m.encode(torch.from_numpy(pc))
        got = m.decode_sdf(torch.from_numpy(query), c).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        m32 = port_prior(kw, params, torch.float32)
        c32 = {k: v.float() for k, v in c.items()}
        got16 = m32.decode_sdf(torch.from_numpy(query).float(), c32,
                               matmul_dtype=torch.bfloat16)
    cast = m32._cast_decoder_state(torch.bfloat16)
    assert set(cast) == set(dict(m32.decoder.named_parameters()))
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    assert got16.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got16.numpy(), want, rtol=0, atol=3e-2 * scale)
    np.testing.assert_allclose(got16.numpy(), want16, rtol=0, atol=3e-2 * scale)
    assert float(np.abs(got16.numpy() - got).max()) > 0


def batch(seed=0, B=4):
    ds = SyntheticShapeDataset(n_items=8, n_pcl=64, n_uni=64, n_nss=64, n_eval=128,
                               seed=seed)
    return {k: v.astype(np.float64) for k, v in next(batch_iterator(ds, B, seed=seed)).items()}


VARIANTS = {
    "center_pred_false": dict(center_pred=False),
    "inner": dict(decoder_type="inner"),
    "deepsdf": dict(decoder_type="deepsdf"),
    "use_pe": dict(use_pe=True, pe_src=8, pe_pow=3, decoder_dims=(192,) * 8),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_sim3recon_loss_and_gradient_match_jax(name):
    """One loss and gradient (eval mode: no dropout, no jitter) against
    JAX's parity path, and for the three-output encoder and DecoderCat the
    validation IoU too."""
    kw = dict(TINY, **VARIANTS[name])
    jcfg = jsp.ShapePriorConfig(**kw, pallas_attention=True, parity=True)
    jm = jsim.SIM3Recon(jcfg, jsim.TrainLossConfig(center_aug_std=0.0))
    params = random_params(jcfg, seed=4)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jm.loss(p, x, None, train=False), has_aux=True))(params, jb)
    m = SIM3Recon(ShapePriorConfig(**kw, pallas_attention=True),
                  TrainLossConfig(center_aug_std=0.0), device="cpu", dtype=torch.float64)
    m.prior.load_state_dict(convert.params_from_jax(params))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, metrics = m.loss(tb, None, train=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-9)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-9,
                                   atol=1e-15, err_msg=k)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in m.prior.named_parameters()}
    assert set(got) == set(want)
    overall = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-8 * overall)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-8 * top,
                                   err_msg=k)
    vb = batch(seed=3)
    jiou = np.asarray(jax.jit(jm.val_iou)(params, {k: jnp.asarray(v) for k, v in vb.items()}))
    with torch.no_grad():
        iou = m.val_iou({k: torch.from_numpy(v) for k, v in vb.items()}).numpy()
    # a ratio of counts, the port's in float32
    np.testing.assert_allclose(iou, jiou, rtol=1e-7)


def jax_udf_draws(cfg, key):
    """JAX's own draws of extract_surface_points(udf, cfg, key), in its
    order: the initial uniforms, then each round's choice uniforms (float32,
    the weights' dtype) and jitters."""
    k0, rng = jax.random.split(key)
    init = np.asarray(jax.random.uniform(k0, (cfg.num_points, 3)))
    choice, jitter = [], []
    for _ in range(cfg.num_rounds):
        rng, k1, k2 = jax.random.split(rng, 3)
        choice.append(np.asarray(jax.random.uniform(k1, (cfg.num_points,), jnp.float32)))
        jitter.append(np.asarray(jax.random.normal(k2, (cfg.num_points, 3))))
    return UDFDraws(torch.from_numpy(init.copy()), torch.from_numpy(np.stack(choice)),
                    torch.from_numpy(np.stack(jitter)))


def test_udf_extraction_matches_jax_on_the_sphere():
    """tests/test_aux.py:77's sphere (radius 0.4, 2000 points, 6 steps, 2
    rounds) with JAX's draws: points and mask equal to JAX's; a second
    field, |SDF| of an off-centre ellipsoid-like shape, exercises the
    resampling (part of its candidates are rejected in each round)."""
    key = jax.random.PRNGKey(0)
    fields = {
        "sphere": (lambda p: jnp.abs(jnp.linalg.norm(p, axis=-1) - 0.4),
                   lambda p: torch.abs(torch.linalg.norm(p, dim=-1) - 0.4),
                   judf.UDFExtractorConfig(num_points=2000, num_steps=6, num_rounds=2)),
        "squashed": (
            lambda p: jnp.abs(jnp.linalg.norm(p * jnp.asarray([1.0, 2.5, 0.7])
                                              - 0.05, axis=-1) - 0.3),
            lambda p: torch.abs(torch.linalg.norm(
                p * torch.tensor([1.0, 2.5, 0.7], dtype=p.dtype) - 0.05, dim=-1) - 0.3),
            judf.UDFExtractorConfig(num_points=2000, num_steps=2, num_rounds=3,
                                    threshold=0.002)),
    }
    for name, (jf, tf, jcfg) in fields.items():
        want_pts, want_mask = judf.extract_surface_points(jf, jcfg, key)
        cfg = UDFExtractorConfig(**dataclasses.asdict(jcfg))
        pts, mask = extract_surface_points(tf, cfg, draws=jax_udf_draws(jcfg, key),
                                           device="cpu", dtype=torch.float64)
        assert pts.shape == (jcfg.num_points, 3)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask), err_msg=name)
        np.testing.assert_allclose(pts.numpy(), np.asarray(want_pts), rtol=0, atol=1e-9,
                                   err_msg=name)
        if name == "squashed":
            assert 0 < int(mask.sum()) < jcfg.num_points
        else:
            accepted = pts.numpy()[mask.numpy()]
            assert len(accepted) > 1500
            np.testing.assert_allclose(np.linalg.norm(accepted, axis=-1), 0.4, atol=0.02)


def test_udf_draws_come_from_the_generator():
    udf = lambda p: torch.abs(torch.linalg.norm(p, dim=-1) - 0.4)
    cfg = UDFExtractorConfig(num_points=300, num_steps=3, num_rounds=1)
    run = lambda seed: extract_surface_points(
        udf, cfg, torch.Generator().manual_seed(seed), device="cpu")
    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    with torch.inference_mode():
        d = run(5)
    assert torch.equal(a[0], d[0])


def test_udf_extraction_defaults_to_the_card():
    """With no device the walk goes to the card, even for a field with no
    device of its own and draws from a CPU generator; without a card that
    raises instead of running on the host."""
    udf = lambda p: torch.abs(torch.linalg.norm(p, dim=-1) - 0.4)
    cfg = UDFExtractorConfig(num_points=50, num_steps=1, num_rounds=1)
    if torch.cuda.is_available():
        pts, mask = extract_surface_points(udf, cfg, torch.Generator().manual_seed(0))
        assert pts.device.type == "cuda" and mask.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_surface_points(udf, cfg, torch.Generator().manual_seed(0))
