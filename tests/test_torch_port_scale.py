"""The PyTorch port's scale statistic (ops/cuda_scale.py, the plain version
of csrc/scale.cu) held against the JAX package on the CPU: the Pallas kernel
in interpret mode and `ShapePrior.normalize_input`, on the same numpy clouds.

Tolerances: f32 rtol 1e-5 against the Pallas kernel (the port takes squared
differences, the kernel expands |p|^2 - 2 p.q + |q|^2: rounding only; the
duplicate case is exact to rtol 1e-6); f64 rtol 1e-12 against
`normalize_input`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.ops.pallas_scale import top_k_mean_pairwise_distance as j_scale
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.ops import cuda_scale
from torch_threads import intra_op_share  # noqa: F401 (autouse)

NARROW = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
              down_sample_layers=(2,), down_sample_factor=(2,),
              atten_start_layer=2, atten_multi_head_c=8, num_knn=8, n_pcl=128,
              decoder_dims=(96,) * 4, decoder_latent_in=(2,))


@pytest.mark.parametrize("B,N", [(2, 64), (3, 100), (5, 37)])
def test_plain_scale_matches_pallas_interpret(B, N):
    rng = np.random.default_rng(0)
    pc = rng.normal(size=(B, N, 3)).astype(np.float32)
    want = j_scale(jnp.asarray(pc), 5, interpret=True)
    got = cuda_scale.top_k_mean_pairwise_distance(torch.from_numpy(pc), 5)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_symmetric_duplicates_are_counted():
    """Three points: the five largest entries are [dmax, dmax, d2, d2, d3]."""
    pc = np.array([[[0.0, 0, 0], [3.0, 0, 0], [0.0, 1.0, 0]]], np.float32)
    expected = (2 * np.sqrt(10.0) + 2 * 3.0 + 1.0) / 5
    got = cuda_scale.top_k_mean_pairwise_distance(torch.from_numpy(pc), 5)
    np.testing.assert_allclose(float(got[0]), expected, rtol=1e-6)
    want = j_scale(jnp.asarray(pc), 5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_scale_carries_no_gradient():
    pc = torch.randn((2, 16, 3), generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    assert not cuda_scale.top_k_mean_pairwise_distance(pc).requires_grad


@pytest.mark.parametrize("fused", [False, True])
def test_normalize_input_matches_jax(fused):
    """Both configurations of the port against JAX's normalize_input: with
    pallas_attention the statistic comes from ops/cuda_scale.py."""
    rng = np.random.default_rng(1)
    pc = rng.uniform(-0.5, 0.5, size=(3, 150, 3)) * [1.0, 0.6, 0.3] + 2.0
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW))
    want = jm.normalize_input(jnp.asarray(pc))
    m = ShapePrior(ShapePriorConfig(**NARROW, pallas_attention=fused), device="cpu",
                   dtype=torch.float64)
    with torch.no_grad():
        got = m.normalize_input(torch.from_numpy(pc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)


def test_encode_at_ragged_n_matches_jax():
    """N = 150 is no multiple of min(256, N): the fused configuration takes
    normalize_input (the scale statistic) and the encoder's own layer-0 kNN,
    and agrees with the JAX parity path in f64 to rtol 1e-9."""
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW, parity=True))
    init = jax.jit(jm.init_params, static_argnames="n_points")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), n_points=64))
    rng = np.random.default_rng(3)
    pc = rng.uniform(-0.5, 0.5, size=(2, 150, 3)) * [1.0, 0.6, 0.3] - 1.0
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    want = jm.encode(jp, jnp.asarray(pc))
    m = ShapePrior(ShapePriorConfig(**NARROW, pallas_attention=True), device="cpu",
                   dtype=torch.float64)
    m.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = m.encode(torch.from_numpy(pc))
    for k in ("z_so3", "z_inv", "s", "t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def test_cuda_wrapper_refuses_cpu_tensors_and_large_k():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scale.top_k_mean_pairwise_distance_cuda(torch.zeros((1, 8, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scale.top_k_mean_pairwise_distance(torch.zeros((1, 8, 3), device="meta"))
