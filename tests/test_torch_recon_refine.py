"""The port's mesh-vertex refinement (recon/extractor.py
`refine_mesh_vertices`, `refinement_loss`, `rmsprop_step`, and
`MeshExtractor` with `refinement_step > 0`) held against the JAX package's
(livingscenes_tpu/recon/extractor.py:182) on the CPU, with JAX's own
Dirichlet draws (jax.random.split(PRNGKey(0), n) and one
jax.random.dirichlet per key) passed to the port.

Two fields: the analytic sphere of tests/test_refine_and_probe.py:14
(logits 20 (0.4 - |q|), its mesh's vertices jittered by 0.02), and the
small decoder of tests/test_torch_solver_more.py in f64 (weights made with
numpy) at the code of an encoded box, meshed from its own grid. Vertices
are float32 on both sides, as in JAX.

Tolerances:
- one step's gradient (JAX's, read out of the JAX function itself with
  optax's rmsprop and apply_updates replaced by the identity): within 1e-5
  of its largest entry. Detaching the normal target moves it by more than
  ten times that, and the test asserts it.
- the vertices after 5 steps: within 1e-4 (the steps move them by 2e-2;
  RMSprop divides each gradient by its own running norm, so f32 rounding
  grows from 4e-8 after one step to 1e-5 after five). RMSprop with its eps
  outside the square root moves them by more than ten times that.
- RMSprop against optax.rmsprop on a gradient of 1e-5: within 1e-6
  relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.recon.grid import dense_grid_values
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.recon import extractor as text
from test_torch_solver_more import SMALL, make_objects, numpy_params
from torch_threads import intra_op_share  # noqa: F401 (autouse)

R0, SHARP = 0.4, 20.0
LR = 2e-3
STEPS = 5
GRAD_RTOL = 1e-5
VERTEX_ATOL = 1e-4


def jax_draws(n_steps, n_faces):
    """The Dirichlet(0.5) draws of JAX's refine_mesh_vertices with its
    default key, (n_steps, F, 3) float32."""
    keys = jax.random.split(jax.random.PRNGKey(0), n_steps)
    return np.stack([np.asarray(jax.random.dirichlet(k, jnp.full((3,), 0.5), (n_faces,)))
                     for k in keys]).astype(np.float32)


def sphere_case():
    jfield = lambda q, c: SHARP * (R0 - jnp.linalg.norm(q, axis=-1))
    tfield = lambda q, c: SHARP * (R0 - torch.linalg.norm(q, dim=-1))
    cfg = jext.MeshExtractorConfig(resolution0=16, upsampling_steps=0,
                                   simplify_nfaces=None)
    grid = dense_grid_values(lambda p: jfield(p[None], None)[0], 16,
                             box_size=cfg.box_size)
    mesh = jext.extract_mesh_from_grid(np.asarray(grid), cfg)
    rng = np.random.default_rng(0)
    verts = (mesh.vertices + rng.normal(0, 0.02, mesh.vertices.shape)).astype(np.float32)
    return jfield, {}, tfield, {"s": torch.ones(1)}, verts, mesh.faces


def decoder_case():
    """The small decoder at the canonical code of an encoded box."""
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          numpy_params(jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL)), 0))
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, parity=True))
    box = make_objects(np.random.default_rng(12))[:1, :64]
    codes = jm.encode(params, jnp.asarray(box))
    codes = dict(codes, s=jnp.ones_like(codes["s"]), t=jnp.zeros_like(codes["t"]))
    jfield = lambda q, c: jm.occupancy_logits(params, q, c)
    tm = ShapePrior(ShapePriorConfig(**SMALL), device="cpu", dtype=torch.float64)
    tm.load_state_dict(params_from_jax(params))
    tcodes = {k: torch.from_numpy(np.array(v)) for k, v in codes.items()}
    cfg = jext.MeshExtractorConfig(resolution0=12, upsampling_steps=0,
                                   simplify_nfaces=None)
    grid = dense_grid_values(lambda p: jfield(p[None], codes)[0], 12,
                             box_size=cfg.box_size)
    mesh = jext.extract_mesh_from_grid(np.asarray(grid), cfg)
    assert len(mesh.faces) > 50
    # the extraction leaves zero-area faces, where JAX's gradient of the
    # normal's norm is NaN (test_zero_area_faces): jitter them away
    rng = np.random.default_rng(1)
    verts = (mesh.vertices + rng.normal(0, 0.005, mesh.vertices.shape)).astype(np.float32)
    return jfield, codes, tm.occupancy_logits, tcodes, verts, mesh.faces


CASES = {"sphere": sphere_case, "decoder": decoder_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return CASES[request.param]()


def jax_gradient(monkeypatch, jfield, jcodes, verts, faces):
    """The gradient of JAX's own refinement loss at `verts` with its first
    draws: one step of the JAX function with rmsprop and apply_updates
    replaced by the identity returns it."""
    with monkeypatch.context() as m:
        m.setattr(optax, "rmsprop", lambda lr: optax.identity())
        m.setattr(optax, "apply_updates", lambda p, u: u)
        return np.asarray(jext.refine_mesh_vertices(jfield, jcodes, verts, faces, n_steps=1))


def port_gradient(tfield, tcodes, verts, faces, eps):
    v = torch.tensor(verts, dtype=torch.float32, requires_grad=True)
    f = torch.as_tensor(faces, dtype=torch.long)
    value_of = lambda p: torch.sigmoid(tfield(p[None], tcodes)[0])
    loss = text.refinement_loss(value_of, v, f, torch.from_numpy(eps), 0.5)
    return torch.autograd.grad(loss, v)[0].numpy()


def test_refinement_gradient_matches_jax(case, monkeypatch):
    jfield, jcodes, tfield, tcodes, verts, faces = case
    eps = jax_draws(1, len(faces))[0]
    want = jax_gradient(monkeypatch, jfield, jcodes, verts, faces)
    got = port_gradient(tfield, tcodes, verts, faces, eps)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= GRAD_RTOL * scale, (err, scale)

    # with the normal target detached (the inner gradient taken without its
    # graph) the gradient leaves the tolerance: the test sees the second
    # derivative
    real_grad = torch.autograd.grad

    def detached_inner(outputs, inputs, **kw):
        if kw.pop("create_graph", False):
            kw["retain_graph"] = True
        return real_grad(outputs, inputs, **kw)

    monkeypatch.setattr(text.torch.autograd, "grad", detached_inner)
    detached = port_gradient(tfield, tcodes, verts, faces, eps)
    monkeypatch.undo()
    assert np.abs(detached - want).max() > 10 * GRAD_RTOL * scale


def test_refined_vertices_match_jax(case, monkeypatch):
    jfield, jcodes, tfield, tcodes, verts, faces = case
    want = np.asarray(jext.refine_mesh_vertices(jfield, jcodes, verts, faces,
                                                n_steps=STEPS, lr=LR))
    eps = jax_draws(STEPS, len(faces))
    got = text.refine_mesh_vertices(tfield, tcodes, verts, faces, n_steps=STEPS,
                                    lr=LR, eps=torch.from_numpy(eps))
    assert got.dtype == torch.float32
    moved = np.abs(want - verts).max()
    assert moved > 100 * VERTEX_ATOL
    assert np.abs(got.numpy() - want).max() <= VERTEX_ATOL

    # RMSprop with eps outside the square root lands elsewhere
    def eps_outside(v, g, nu, lr):
        nu = 0.1 * g ** 2 + 0.9 * nu
        return v - lr * g / (torch.sqrt(nu) + 1e-8), nu

    monkeypatch.setattr(text, "rmsprop_step", eps_outside)
    wrong = text.refine_mesh_vertices(tfield, tcodes, verts, faces, n_steps=STEPS,
                                      lr=LR, eps=torch.from_numpy(eps))
    assert np.abs(wrong.numpy() - want).max() > 10 * VERTEX_ATOL


def test_rmsprop_step_matches_optax():
    """optax 0.2.6's rmsprop: eps inside the square root, nu from 0. One
    update of g = 1e-5 from a zero state at lr 1 is -0.09995 (-3.15 with
    eps outside)."""
    lr = 0.1
    rng = np.random.default_rng(3)
    g = np.concatenate([[1e-5, -1e-5], rng.normal(0, 1e-4, 30), rng.normal(0, 1.0, 30)])
    g = g.astype(np.float32)
    opt = optax.rmsprop(lr)
    p_j = jnp.zeros(g.shape, jnp.float32)
    state = opt.init(p_j)
    p_t, nu = torch.zeros(g.shape), torch.zeros(g.shape)
    for k in range(3):
        gk = g * (k + 1)
        u, state = opt.update(jnp.asarray(gk), state)
        p_j = optax.apply_updates(p_j, u)
        p_t, nu = text.rmsprop_step(p_t, torch.from_numpy(gk), nu, lr)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6, atol=0)
    first, _ = text.rmsprop_step(torch.zeros(1), torch.tensor([1e-5]), torch.zeros(1), 1.0)
    assert abs(float(first) + 0.09995) < 1e-6


def test_mesh_extractor_refines_under_no_grad():
    """MeshExtractor(refinement_step=5) end to end, called under
    torch.no_grad() as the solver calls it. On the sphere field of JAX's
    own test (tests/test_refine_and_probe.py:55, its radius times the code's
    s) with a wiggle 3 sin(8 x) that puts the extracted vertices off the
    level set, at 8^3: faces equal, vertices within VERTEX_ATOL of JAX's
    after the code's scale and translation. (A vertex that lies on the
    level set has a gradient of rounding noise, which RMSprop scales up to
    a step: the plain sphere at 12^3 moves such vertices by up to 1e-3
    apart on the two sides.) On the decoder field, whose extracted mesh has
    zero-area faces: the port's refined vertices are finite and no
    parameter collects a gradient, where JAX's hold NaNs (its gradient of the
    face normal's norm at 0; torch's is 0, as in the reference)."""
    s, t = 1.3, np.array([[[0.2, -0.1, 0.4]]])
    common = dict(resolution0=8, upsampling_steps=0, simplify_nfaces=None,
                  refinement_lr=LR)
    jfield = lambda q, c: (SHARP * (R0 * c["s"][:, None] - jnp.linalg.norm(q, axis=-1))
                           + 3.0 * jnp.sin(8.0 * q[..., 0]))
    tfield = lambda q, c: (SHARP * (R0 * c["s"][:, None] - torch.linalg.norm(q, dim=-1))
                           + 3.0 * torch.sin(8.0 * q[..., 0]))
    jcodes = {"s": jnp.full((1,), s), "t": jnp.asarray(t)}
    tcodes = {"s": torch.full((1,), s, dtype=torch.float64), "t": torch.from_numpy(t)}
    want = jext.MeshExtractor(jfield, jext.MeshExtractorConfig(
        **common, refinement_step=STEPS)).generate_from_codes(jcodes)
    unrefined = text.MeshExtractor(tfield, text.MeshExtractorConfig(**common)
                                   ).generate_from_codes(tcodes)
    ext = text.MeshExtractor(tfield, text.MeshExtractorConfig(
        **common, refinement_step=STEPS))
    eps = torch.from_numpy(jax_draws(STEPS, len(unrefined.faces)))
    with torch.no_grad():
        got = ext.generate_from_codes(tcodes, refine_eps=eps)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert np.abs(got.vertices - unrefined.vertices).max() > 100 * VERTEX_ATOL
    assert np.abs(got.vertices - want.vertices).max() <= VERTEX_ATOL * s

    jfield, jcodes, tfield, tcodes, _, _ = decoder_case()
    model = tfield.__self__
    cfg = dict(resolution0=8, upsampling_steps=1, simplify_nfaces=None,
               refinement_lr=LR)
    unrefined = text.MeshExtractor(tfield, text.MeshExtractorConfig(**cfg)
                                   ).generate_from_codes(tcodes)
    cfg["refinement_step"] = STEPS
    with torch.no_grad():
        got = text.MeshExtractor(tfield, text.MeshExtractorConfig(**cfg)
                                 ).generate_from_codes(tcodes)
    assert not got.is_empty and np.isfinite(got.vertices).all()
    assert np.abs(got.vertices - unrefined.vertices).max() > 10 * VERTEX_ATOL
    assert all(p.grad is None for p in model.parameters())
    want = jext.MeshExtractor(jfield, jext.MeshExtractorConfig(**cfg)
                              ).generate_from_codes(jcodes)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert np.isnan(want.vertices).any()
