"""The options of the port's attention encoder held against the JAX
package on the CPU: the same numpy clouds from a seed, the JAX init carried
over by the converter.

* VecDGCNNAttn through ShapePrior.encode at the small width of
  tests/test_torch_port_encoder.py (feat_dim (8, 8, 16, 16, 16, 32, 32),
  c_dim 32, K 8, 256 points) with center_pred=False (three outputs),
  center_pred_scale=False and z_so3_as_Omtx (the orthogonal frame, compared
  directly: U Vh does not depend on the SVD's signs): float64 against JAX's
  parity config, rtol 1e-9.
* mixed_precision with pallas_attention=False in float32, the encoder alone
  on the same normalized cloud as JAX's default config (the bfloat16
  operands of layers 0 and 1): within 1e-4 of each output's largest entry
  (at least 1), float32 rounding: both sides round the same operands to
  bfloat16 and multiply them exactly (7.6e-6 measured); the float32 run
  without bfloat16 is more than 1e-3 away (0.10 measured), so the bound
  tells the two apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.nn.vec_dgcnn_attn import VecDGCNNAttn as JVecDGCNNAttn
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.nn.vec_dgcnn_attn import VecDGCNNAttn
from torch_threads import intra_op_share  # noqa: F401 (autouse)

SMALL = dict(c_dim=32, feat_dim=(8, 8, 16, 16, 16, 32, 32), num_knn=8, n_pcl=256)


@pytest.fixture(scope="module")
def params():
    """The JAX init of the widest option set (fc_O and fc_center); an
    option without a head leaves its weights out."""
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, z_so3_as_Omtx=True))
    init = jax.jit(model.init_params, static_argnames="n_points")
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        init(jax.random.PRNGKey(0), n_points=64))


def clouds(seed, B=3, N=256):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * rng.uniform(0.3, 1.0, size=(B, 1, 3))
    return pts + rng.uniform(-2, 2, size=(B, 1, 3))


@pytest.mark.parametrize("option", [
    dict(center_pred=False),
    dict(center_pred_scale=False),
    dict(z_so3_as_Omtx=True),
    dict(z_so3_as_Omtx=True, center_pred=False),
])
def test_attention_encoder_options_match_jax(params, option):
    jcfg = jsp.ShapePriorConfig(**SMALL, **option, parity=True)
    enc = dict(params["encoder"])
    if not option.get("z_so3_as_Omtx"):
        del enc["fc_O"]
    if option.get("center_pred") is False:
        del enc["fc_center"]
    params = {**params, "encoder": enc}
    pc = clouds(0)
    want = jax.jit(jsp.ShapePrior(jcfg).encode)(params, jnp.asarray(pc))
    m = ShapePrior(ShapePriorConfig(**SMALL, **option), device="cpu", dtype=torch.float64)
    m.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = m.encode(torch.from_numpy(pc))
    for k in ("z_so3", "z_inv", "s", "t"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    if option.get("z_so3_as_Omtx"):
        z = got["z_so3"]
        np.testing.assert_allclose(torch.einsum("bij,bkj->bik", z, z).numpy(),
                                   np.broadcast_to(np.eye(3), (3, 3, 3)), atol=1e-12)
    with torch.no_grad():
        out = m.encoder(torch.from_numpy(pc) - torch.from_numpy(pc).mean(1, keepdim=True))
    assert len(out) == (3 if option.get("center_pred") is False else 4)


def test_mixed_precision_matches_jax():
    """Layers 0 and 1 take bfloat16 operands (JAX's mm_bf16 on the unfused
    layers); the rest of the encoder is float32."""
    kw = dict(c_dim=32, feat_dim=(8, 8, 16, 16, 16, 32, 32), num_knn=8)
    x = np.random.default_rng(1).normal(size=(3, 256, 3)).astype(np.float32) * 0.3
    jenc_mp = JVecDGCNNAttn(**kw, mixed_precision=True)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(jenc_mp.init)(
        jax.random.PRNGKey(0), x[:, :64])["params"])
    want = jax.jit(jenc_mp.apply)({"params": params}, x)
    state = {k.split(".", 1)[1]: v
             for k, v in params_from_jax({"encoder": params}).items()}
    with torch.no_grad():
        outs = []
        for mp in (True, False):
            enc = VecDGCNNAttn(**kw, mixed_precision=mp)
            enc.load_state_dict(state)
            outs.append(enc(torch.from_numpy(x)))
    got, plain = outs
    assert VecDGCNNAttn(**kw, mixed_precision=True).V_list["1"].lin.mm_bf16
    assert not VecDGCNNAttn(**kw, mixed_precision=True).V_list["2"].lin.mm_bf16
    assert not VecDGCNNAttn(**kw, mixed_precision=True,
                            pallas_attention=True).V_list["0"].lin.mm_bf16
    worst_plain = 0.0
    for a, p, w in zip(got, plain, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a.numpy() / scale, w / scale, rtol=0, atol=1e-4)
        worst_plain = max(worst_plain, float(np.abs(p.numpy() - w).max()) / scale)
    assert worst_plain > 1e-3


