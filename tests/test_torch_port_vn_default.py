"""The port's vector-neuron layers built with no `mode`, against JAX's built
with no `mode`: both default to se3, so the same numpy weights (JAX's init
at PRNGKey(0), carried over by the converter) give the same outputs on the
same numpy inputs. Float64, rtol 1e-9 (atol 1e-12): rounding only."""
import numpy as np
import pytest
import torch

from livingscenes_tpu.nn import vec_layers as jvl
from livingscenes_tpu_torch.nn import vec_layers as vl
from test_torch_variants_layers import (ACT_J, ACT_T, B, C, N, assert_same, jax_init,
                                        port, vec_input)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

LAYERS = {
    "linear": lambda: (jvl.VecLinear(C, 24), vl.VecLinear(C, 24)),
    "linear_scalars": lambda: (jvl.VecLinear(C, 24, s_in=8, s_out=6),
                               vl.VecLinear(C, 24, s_in=8, s_out=6)),
    "activation": lambda: (jvl.VecActivation(C, ACT_J), vl.VecActivation(C, ACT_T)),
    "lna": lambda: (jvl.VecLNA(C, 20, ACT_J), vl.VecLNA(C, 20, ACT_T)),
    "resblock": lambda: (jvl.VecResBlock(C, 20, 12, ACT_J),
                         vl.VecResBlock(C, 20, 12, ACT_T)),
    "maxpool_soft": lambda: (jvl.VecMaxPool(in_features=C, softmax_factor=1.0),
                             vl.VecMaxPool(C, softmax_factor=1.0)),
    "maxpool_hard": lambda: (jvl.VecMaxPool(in_features=C, softmax_factor=-1.0),
                             vl.VecMaxPool(C, softmax_factor=-1.0)),
    "maxpool_v2": lambda: (jvl.VecMaxPoolV2(in_features=C, softmax_factor=1.0),
                           vl.VecMaxPoolV2(C, softmax_factor=1.0)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_default_mode_is_jaxs(name):
    jmod, tmod = LAYERS[name]()
    # the port's VecLNA keeps its mode in its two parts
    assert jmod.mode == "se3" and getattr(tmod, "mode", None) in ("se3", None)
    assert {m.mode for m in tmod.modules() if hasattr(m, "mode")} >= {"se3"}
    x = vec_input(11)
    args = (x, np.random.default_rng(12).normal(size=(B, N, 8))) \
        if name == "linear_scalars" else (x,)
    params = jax_init(jmod, *args)
    tmod = port(tmod, params)
    want = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in args))
    assert_same(want, got)
    # se3: a common translation of the input carries through
    if name in ("linear", "lna", "resblock"):
        t = torch.tensor([0.4, -1.2, 0.7], dtype=torch.float64)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            np.testing.assert_allclose((tmod(xt + t) - tmod(xt) - t).abs().max().item(),
                                       0.0, atol=1e-9)


def test_encoders_still_so3():
    """Every layer of the production encoder names so3: no se3 origin map
    (`lin_ori`) or se3 weight layout appears in its state dict."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig

    cfg = ShapePriorConfig(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
                           down_sample_layers=(2,), down_sample_factor=(2,),
                           atten_start_layer=2, atten_multi_head_c=8, num_knn=8,
                           decoder_dims=(96,) * 8, n_pcl=64)
    model = ShapePrior(cfg, device="cpu")
    modes = {m.mode for m in model.encoder.modules() if hasattr(m, "mode")}
    assert modes == {"so3"}
    assert not any("lin_ori" in k for k in model.encoder.state_dict())
