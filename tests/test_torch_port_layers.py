"""The PyTorch port's vector-neuron layers, fused edge convs and matcher
held against the JAX package on the CPU, and the layers' equivariance.

Weights come from the JAX modules' own init (numpy), loaded into the port
by key. Tolerances, all in f64: 1e-10 for outputs against JAX (rounding
only), 1e-10 for equivariance f(sRx) = sRf(x).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.nn import edge_conv as jedge
from livingscenes_tpu.nn import vec_layers as jvl
from livingscenes_tpu.solver.matcher import sequential_matcher as jmatch
from livingscenes_tpu_torch.nn import vec_layers as vl
from livingscenes_tpu_torch.nn.edge_conv import fused_edge_kv
from livingscenes_tpu_torch.solver.matcher import sequential_matcher
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ACT_J = lambda x: jax.nn.leaky_relu(x, 0.2)
ACT_T = vl.leaky_relu(0.2)


def flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_params(v, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(v, dtype=np.float64))
    return out


def port_like(jmod, tmod, x):
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))["params"]
    tmod.load_state_dict(flat_params(params))
    tmod.double()
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    return lambda v: np.asarray(jmod.apply({"params": params64}, jnp.asarray(v)))


CASES = [
    ("linear", lambda: (jvl.VecLinear(16, 8, mode="so3"), vl.VecLinear(16, 8, mode="so3"))),
    ("activation", lambda: (jvl.VecActivation(16, ACT_J, mode="so3"),
                            vl.VecActivation(16, ACT_T, mode="so3"))),
    ("lna", lambda: (jvl.VecLNA(16, 8, ACT_J, mode="so3"), vl.VecLNA(16, 8, ACT_T, mode="so3"))),
    ("lna_shared", lambda: (
        jvl.VecLNA(16, 8, ACT_J, mode="so3", shared_nonlinearity=True),
        vl.VecLNA(16, 8, ACT_T, mode="so3", shared_nonlinearity=True))),
    ("resblock", lambda: (jvl.VecResBlock(16, 1, 8, ACT_J, mode="so3"),
                          vl.VecResBlock(16, 1, 8, ACT_T, mode="so3"))),
    ("resblock_same", lambda: (jvl.VecResBlock(16, 16, 8, ACT_J, mode="so3"),
                               vl.VecResBlock(16, 16, 8, ACT_T, mode="so3"))),
]


@pytest.mark.parametrize("name,make", CASES, ids=[c[0] for c in CASES])
def test_layers_match_jax_and_are_equivariant(rng, name, make):
    jmod, tmod = make()
    x = rng.normal(size=(2, 33, 16, 3))
    jfn = port_like(jmod, tmod, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, jfn(x), rtol=1e-10, atol=1e-10)
        R = Rotation.random(2, random_state=7).as_matrix()
        s = rng.uniform(0.5, 2.0, size=(2, 1, 1, 1))
        xr = np.einsum("bij,bncj->bnci", R, x * s)
        out_r = tmod(torch.from_numpy(xr)).numpy()
    np.testing.assert_allclose(
        out_r, np.einsum("bij,bncj->bnci", R, out * s), rtol=1e-10, atol=1e-10)


def test_channel_equi_vec_normalize(rng):
    x = rng.normal(size=(3, 7, 12, 3))
    got = vl.channel_equi_vec_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jvl.channel_equi_vec_normalize(jnp.asarray(x))), atol=1e-14)
    # scale-invariant
    got2 = vl.channel_equi_vec_normalize(torch.from_numpy(3.5 * x)).numpy()
    np.testing.assert_allclose(got2, got, atol=1e-12)


def test_fused_edge_kv_matches_jax(rng):
    B, N, K, C, O = 2, 20, 5, 8, 16
    nn_f = rng.normal(size=(B, N, K, C, 3))
    dst = rng.normal(size=(B, N, C, 3))
    W_K, W_V = rng.normal(size=(O, 2 * C)), rng.normal(size=(O, 2 * C))
    D_K, D_V = rng.normal(size=(O, O)), rng.normal(size=(O, O))
    jk, jv = jedge.fused_edge_kv(*(jnp.asarray(a) for a in (nn_f, dst, W_K, D_K, W_V, D_V)), ACT_J)
    tk, tv = fused_edge_kv(*(torch.from_numpy(a) for a in (nn_f, dst, W_K, D_K, W_V, D_V)), ACT_T)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    # equals the unfused VecLNA on the materialized [nn - dst, dst] edge
    lna = vl.VecLNA(2 * C, O, ACT_T, mode="so3").double()
    with torch.no_grad():
        lna.lin.weight.copy_(torch.from_numpy(W_K))
        lna.act.lin_dir.weight.copy_(torch.from_numpy(D_K))
        d = torch.from_numpy(dst)[:, :, None].expand(B, N, K, C, 3)
        edge = torch.cat([torch.from_numpy(nn_f) - d, d], dim=-2)
        np.testing.assert_allclose(lna(edge).numpy(), tk.numpy(), rtol=1e-10, atol=1e-10)


def test_matcher_matches_jax_batched_and_masked(rng):
    P, S, T, C = 4, 6, 5, 16
    a = rng.normal(size=(P, S, C))
    b = rng.normal(size=(P, T, C))
    sm = rng.random((P, S)) > 0.2
    tm = rng.random((P, T)) > 0.2
    out = sequential_matcher(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(sm), torch.from_numpy(tm))
    for p in range(P):
        j = jmatch(jnp.asarray(a[p]), jnp.asarray(b[p]), jnp.asarray(sm[p]), jnp.asarray(tm[p]))
        np.testing.assert_array_equal(out["matches0"][p].numpy(), np.asarray(j["matches0"]))
        np.testing.assert_array_equal(out["matches1"][p].numpy(), np.asarray(j["matches1"]))
    # unbatched call, and a permuted copy is matched back exactly
    perm = rng.permutation(S)
    one = sequential_matcher(torch.from_numpy(a[0]), torch.from_numpy(a[0][perm]))
    np.testing.assert_array_equal(one["matches0"].numpy(), np.argsort(perm))
