"""The PyTorch port's SE(3) refinement (solver/registration.py `refine_se3`,
the `optim` branch of `solve_pairwise_registration`, `icp_accept="sdf"`)
and the slice as a whole, `build_scene_pair_pipeline(PipelineConfig(optim=
True))`, held against the JAX package on the CPU in f64: a narrow encoder
and decoder with the JAX init carried over, a handful of pairs of 64-96
points, tens of steps.

Tolerances: the loss and its gradient rtol 1e-9; after 24-30 Adam steps R,
t and best_loss to atol 1e-7 (f64 rounding carried through the steps: the
port's Sinkhorn route expands the cost where JAX's CPU path takes squared
differences), `stopped` equal; the whole pipeline matches0 equal and R, t
to 1e-6, with the Kabsch ICP refit on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.solver import registration as treg
from livingscenes_tpu_torch.solver.pipeline import PipelineConfig, build_scene_pair_pipeline
from torch_threads import intra_op_share  # noqa: F401 (autouse)

NARROW = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
              down_sample_layers=(2,), down_sample_factor=(2,),
              atten_start_layer=2, atten_multi_head_c=8, num_knn=8, n_pcl=64,
              decoder_dims=(96,) * 4, decoder_latent_in=(2,))
FIELDS = ("n_steps", "lr", "lr_milestones", "lr_decay", "early_stop_deg",
          "sinkhorn_blur", "sinkhorn_iters", "sinkhorn_anneal", "sinkhorn_diameter",
          "sinkhorn_implicit_grad", "icp_iterations", "direction_pick",
          "track_best", "icp_accept")


@pytest.fixture(scope="module")
def params():
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW))
    init = jax.jit(model.init_params, static_argnames="n_points")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), n_points=64))


def models(params):
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW, parity=True))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    tm = ShapePrior(ShapePriorConfig(**NARROW), device="cpu", dtype=torch.float64)
    tm.load_state_dict(params_from_jax(params))
    return jm, jp, tm


def configs(**kwargs):
    """The same settings on both sides, both on the Kabsch ICP refit."""
    tcfg = treg.RegistrationConfig(icp_fused=False, **kwargs)
    jcfg = jreg.RegistrationConfig(
        icp_fused=False, **{k: getattr(tcfg, k) for k in FIELDS})
    return tcfg, jcfg


def pairs(seed, B=4, N=64, noise_deg=4.0, jitter=0.005):
    """Clouds, their moved and jittered copies, and a noisy initial
    transform."""
    rng = np.random.default_rng(seed)
    pc1 = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * rng.uniform(0.4, 1.0, size=(B, 1, 3))
    R = Rotation.random(B, random_state=seed).as_matrix()
    t = 0.3 * rng.normal(size=(B, 3, 1))
    pc2 = np.einsum("bij,bnj->bni", R, pc1) + t[:, None, :, 0]
    pc2 = pc2 + jitter * rng.normal(size=pc2.shape)
    dR = Rotation.from_rotvec(np.deg2rad(noise_deg) * rng.normal(size=(B, 3))).as_matrix()
    return pc1, pc2, dR @ R, t + 0.03 * rng.normal(size=t.shape)


def jnp_codes(codes):
    return {k: jnp.asarray(v.numpy()) for k, v in codes.items()}


def refine_both(params, cfg_kwargs, seed=0, **pair_kwargs):
    jm, jp, tm = models(params)
    tcfg, jcfg = configs(**cfg_kwargs)
    pc1, pc2, R0, t0 = pairs(seed, **pair_kwargs)
    with torch.no_grad():
        codes2 = tm.encode(torch.from_numpy(pc2))
    got = treg.refine_se3(
        tm.decode_sdf, torch.from_numpy(pc1),
        torch.from_numpy(pc2), codes2, torch.from_numpy(R0), torch.from_numpy(t0), tcfg)
    want = jax.jit(lambda a, b, c, r, t: jreg.refine_se3(
        lambda q, cc: jm.decode_sdf(jp, q, cc), a, b, c, r, t, jcfg))(
        jnp.asarray(pc1), jnp.asarray(pc2), jnp_codes(codes2), jnp.asarray(R0), jnp.asarray(t0))
    return got, want


def assert_refine_equal(got, want, atol=1e-7):
    (R, t, info), (Rj, tj, infoj) = got, want
    assert R.shape == Rj.shape and t.shape == tj.shape
    np.testing.assert_array_equal(info["stopped"].numpy(), np.asarray(infoj["stopped"]))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=atol)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=atol)
    np.testing.assert_allclose(info["best_loss"].numpy(), np.asarray(infoj["best_loss"]), atol=atol)


@pytest.mark.parametrize("step", [0, 1, 299, 300, 301, 339, 340, 379, 380, 399])
def test_learning_rate_matches_optax_around_the_milestones(step):
    cfg = treg.RegistrationConfig()
    sched = optax.piecewise_constant_schedule(
        cfg.lr, {m: cfg.lr_decay for m in cfg.lr_milestones})
    np.testing.assert_allclose(treg.refine_learning_rate(cfg, step), float(sched(step)), rtol=1e-12)


def test_smooth_l1_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 50)) * 2.0
    want = jax.vmap(jreg._smooth_l1)(jnp.asarray(x))
    np.testing.assert_allclose(treg._smooth_l1(torch.from_numpy(x)).numpy(), np.asarray(want),
                               rtol=1e-14)


def test_refine_loss_and_gradient_match_jax(params):
    jm, jp, tm = models(params)
    tcfg, jcfg = configs()
    pc1, pc2, R0, t0 = pairs(1)
    xi = 0.05 * np.random.default_rng(2).normal(size=(4, 6))
    xi[0] = 0.0  # the first step's gradient is taken at the origin
    with torch.no_grad():
        codes2 = tm.encode(torch.from_numpy(pc2))
    _, loss_t = treg.make_refine_loss(
        tm.decode_sdf, torch.from_numpy(pc1),
        torch.from_numpy(pc2), codes2, torch.from_numpy(R0), torch.from_numpy(t0), tcfg)
    _, loss_j = jreg.make_refine_loss(
        lambda q, c: jm.decode_sdf(jp, q, c), jnp.asarray(pc1), jnp.asarray(pc2),
        jnp_codes(codes2), jnp.asarray(R0), jnp.asarray(t0), jcfg)
    xt = torch.tensor(xi, requires_grad=True)
    total, per_item = loss_t(xt)
    (grad,) = torch.autograd.grad(total, xt)
    (_, want_items), want_grad = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(xi))
    assert bool(torch.isfinite(grad).all())
    np.testing.assert_allclose(per_item.detach().numpy(), np.asarray(want_items), rtol=1e-9)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-9, atol=1e-12)
    # only the pose is differentiated: the decoder's parameters stay out
    assert all(p.grad is None for p in tm.parameters())


@pytest.mark.parametrize("cfg_kwargs", [
    dict(n_steps=30, lr_milestones=(10, 20)),
    dict(n_steps=24, lr_milestones=(10, 20), track_best=False),
    dict(n_steps=24, sinkhorn_anneal=False, sinkhorn_iters=6, sinkhorn_blur=0.1),
    dict(n_steps=24, sinkhorn_implicit_grad=False),
])
def test_refine_se3_matches_jax(params, cfg_kwargs):
    got, want = refine_both(params, cfg_kwargs)
    assert_refine_equal(got, want)
    assert not bool(got[2]["stopped"].any())


def test_refine_se3_early_stop_freezes(params):
    """A huge rate drives every rotation past the threshold at the first
    step: each pair stops, keeps the iterate its loss was evaluated at (the
    init), and stays finite."""
    got, want = refine_both(params, dict(n_steps=20, lr=5.0))
    assert bool(got[2]["stopped"].all())
    assert_refine_equal(got, want)
    _, _, R0, t0 = pairs(0)
    np.testing.assert_allclose(got[0].numpy(), R0, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), t0, atol=1e-12)


def test_refine_se3_freezes_pair_by_pair(params):
    """A tight threshold stops some pairs and not others; the stopped ones
    keep their iterate and Adam moments while the step count runs on."""
    got, want = refine_both(params, dict(n_steps=30, lr=0.01, early_stop_deg=8.0), seed=3)
    stopped = got[2]["stopped"].numpy()
    assert stopped.any() and not stopped.all()
    assert_refine_equal(got, want)


REGISTRATION_CASES = [
    dict(),
    dict(direction_pick=False),
    dict(track_best=False),
    dict(icp_accept="sdf"),
    dict(icp_accept="always", direction_pick=False),
]


@pytest.mark.parametrize("cfg_kwargs", REGISTRATION_CASES)
def test_solve_pairwise_registration_optim_matches_jax(params, cfg_kwargs):
    jm, jp, tm = models(params)
    # A small jitter and a small rate keep the poses near the truth: the
    # untrained encoder's codes turn with the kNN graph, and from a pose far
    # off ICP's refit on 64 points is rank-deficient, where the two SVDs may
    # pick different rotations.
    tcfg, jcfg = configs(n_steps=12, lr=0.005, lr_milestones=(6,), icp_iterations=4,
                         **cfg_kwargs)
    pc1, pc2, _, _ = pairs(4, B=5, jitter=1e-5)
    with torch.no_grad():
        c1, c2 = tm.encode(torch.from_numpy(pc1)), tm.encode(torch.from_numpy(pc2))
        R, t = treg.solve_pairwise_registration(
            tm, torch.from_numpy(pc1), torch.from_numpy(pc2), c1, c2, optim=True, cfg=tcfg)
    Rj, tj = jax.jit(lambda a, b, ca, cb: jreg.solve_pairwise_registration(
        jm, jp, a, b, ca, cb, optim=True, cfg=jcfg))(
        jnp.asarray(pc1), jnp.asarray(pc2), jnp_codes(c1), jnp_codes(c2))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-7)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-7)
    if cfg_kwargs.get("direction_pick", True):
        # the case has pairs refined in both directions
        with torch.no_grad():
            e1 = tm.decode_sdf(torch.from_numpy(pc1), c1).abs().mean(-1)
            e2 = tm.decode_sdf(torch.from_numpy(pc2), c2).abs().mean(-1)
        assert bool((e1 >= e2).any()) and bool((e1 < e2).any())


def test_icp_accept_sdf_without_optim_matches_jax(params):
    jm, jp, tm = models(params)
    tcfg, jcfg = configs(icp_iterations=6, icp_accept="sdf")
    pc1, pc2, _, _ = pairs(5, B=5, jitter=1e-5)
    with torch.no_grad():
        R, t = treg.solve_pairwise_registration(
            tm, torch.from_numpy(pc1), torch.from_numpy(pc2), cfg=tcfg)
    Rj, tj = jreg.solve_pairwise_registration(
        jm, jp, jnp.asarray(pc1), jnp.asarray(pc2), cfg=jcfg)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-8)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-8)


def test_optim_pipeline_matches_jax(params):
    """The slice as a whole, through the pipeline's own grad mode: FPS ->
    encode -> match -> Kabsch -> refinement -> ICP -> symch."""
    S, O, N = 2, 3, 96
    rng = np.random.default_rng(6)
    objs = rng.uniform(-0.5, 0.5, (S, O, N, 3)) * rng.uniform(0.3, 1.0, (S, O, 1, 3))
    ref = objs + rng.uniform(-3, 3, (S, O, 1, 3))
    Rm = Rotation.random(S * O, random_state=1).as_matrix().reshape(S, O, 3, 3)
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + 0.5 * rng.normal(size=(S, O, 1, 3))
    perm = np.stack([rng.permutation(O) for _ in range(S)])
    rescan = np.stack([rescan[s][perm[s]] for s in range(S)])
    # one padding pattern for every instance: an object and its moved copy
    # are sampled at the same points, so the Kabsch init is near the truth
    mask = np.ones((S, O, N), bool)
    mask[:, :, 80:] = rng.random(N - 80) > 0.5
    jm, jp, tm = models(params)
    tcfg, jcfg = configs(n_steps=10, lr=0.005, lr_milestones=(5,), icp_iterations=5)
    out_t = build_scene_pair_pipeline(
        tm, PipelineConfig(optim=True, encode_fps=True, registration=tcfg))(
        ref, rescan, mask, mask)
    out_j = jpipe.build_scene_pair_pipeline(
        jm, jpipe.PipelineConfig(optim=True, encode_fps=True, registration=jcfg))(
        jp, jnp.asarray(ref), jnp.asarray(rescan), jnp.asarray(mask), jnp.asarray(mask))
    np.testing.assert_array_equal(out_t["matches0"].numpy(), np.asarray(out_j["matches0"]))
    assert not out_t["R"].requires_grad
    np.testing.assert_allclose(out_t["R"].numpy(), np.asarray(out_j["R"]), atol=1e-6)
    np.testing.assert_allclose(out_t["t"].numpy(), np.asarray(out_j["t"]), atol=1e-6)
    # the refinement does move the poses: without ICP after it, and keeping
    # the last iterate (the exact init has the best loss here), the pipeline
    # with and without it differ
    no_icp, _ = configs(n_steps=10, lr=0.005, lr_milestones=(5,), icp_iterations=0,
                        track_best=False)
    outs = [build_scene_pair_pipeline(
        tm, PipelineConfig(optim=optim, encode_fps=True, registration=no_icp))(
        ref, rescan, mask, mask) for optim in (False, True)]
    assert float((outs[0]["R"] - outs[1]["R"]).abs().max()) > 1e-4
