"""The PyTorch port's occupancy grids (livingscenes_tpu_torch/recon/grid.py)
held against livingscenes_tpu/recon/grid.py on the CPU, on analytic fields:
an off-centre ellipsoid, a sphere at the centre of the lattice (whose
mirror-image points tie exactly, so topk's order among equal scores shows)
and two blobs, in f32, at res0 = 8 with 0-2 refine levels.

Both sides decode through the same numpy function (JAX through
`pure_callback`), so a field value depends only on its point's bits; the
lattice coordinates and the upsampling are formed in the same order on
both sides, and the grids come out bit-equal. Held: values within 1e-6,
overflow, n_active and final_idx equal, final_vals equal at the selected
slots, apply_final_merge equal, and the batched function equal to JAX's
vmap at B = 3. Every lattice value and every upsampled value that enters
a sign test is at least 1e-4 from the threshold in f64, so that the
selections do not hang on a rounding (test_fields_keep_clear_of_the_threshold).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.recon import grid as jg
from livingscenes_tpu_torch.recon import grid as tg
from torch_threads import intra_op_share  # noqa: F401 (autouse)

THRESHOLD = 0.02
RES0 = 8
BOX = 1.1
CHUNK = 1000
# (centre, semi-axes) of each blob; the field is the largest 1 - |(p - c) / a|
FIELDS = {
    "ellipsoid": [((0.07, -0.05, 0.03), (0.325, 0.22, 0.27))],
    "sphere": [((0.0, 0.0, 0.0), (0.3137, 0.3137, 0.3137))],
    "two_blobs": [((-0.18, 0.02, 0.05), (0.14, 0.17, 0.12)),
                  ((0.2, -0.04, -0.06), (0.12, 0.1, 0.15))],
}


def field64(p, blobs):
    p = np.asarray(p, np.float64)
    out = None
    for c, a in blobs:
        d = (p - np.asarray(c)) / np.asarray(a)
        v = 1.0 - np.sqrt(np.sum(d * d, axis=-1))
        out = v if out is None else np.maximum(out, v)
    return out


def field32(p, blobs):
    return field64(p, blobs).astype(np.float32)


def jax_decode(blobs):
    def decode(p):
        return jax.pure_callback(
            lambda q: field32(q, blobs),
            jax.ShapeDtypeStruct(p.shape[:-1], jnp.float32), p,
            vmap_method="sequential")
    return decode


def torch_decode(blobs):
    return lambda p: torch.from_numpy(field32(p.numpy(), blobs))


def run_both(name, **kw):
    kw = dict(resolution0=RES0, threshold=THRESHOLD, box_size=BOX,
              chunk_size=CHUNK, return_stats=True, **kw)
    vj, sj = jg.hierarchical_grid_values(jax_decode(FIELDS[name]), **kw)
    vt, st = tg.hierarchical_grid_values(torch_decode(FIELDS[name]), device="cpu", **kw)
    return (np.asarray(vj), {k: np.asarray(v) for k, v in sj.items()},
            vt.numpy(), {k: v.numpy() for k, v in st.items()})


def assert_stats_equal(sj, st):
    assert sorted(sj) == sorted(st)
    for key in ("overflow", "n_active"):
        np.testing.assert_array_equal(st[key], sj[key], err_msg=key)
        assert st[key].dtype == np.int32
    if "final_idx" in sj:
        np.testing.assert_array_equal(st["final_idx"], sj["final_idx"])
        sel = sj["final_idx"] < (RES0 * 4 + 1) ** 3
        np.testing.assert_array_equal(st["final_vals"][sel], sj["final_vals"][sel])


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fields_keep_clear_of_the_threshold(name):
    """In f64: the values at every lattice point of the final resolution
    (the coarser lattices are subsets) and at every midpoint of the level-0
    grid's upsample (the only interpolated values a later sign test sees)
    lie at least 1e-4 from the threshold."""
    blobs = FIELDS[name]
    final = field64(tg.grid_coordinates(RES0 * 4, BOX, torch.float64, "cpu").numpy(), blobs)
    n0 = RES0 + 1
    coarse = field64(tg.grid_coordinates(RES0, BOX, torch.float64, "cpu").numpy(), blobs)
    up = tg._double_resolution(torch.from_numpy(coarse.reshape(1, n0, n0, n0))).numpy()
    for vals in (final, up):
        assert np.abs(vals - THRESHOLD).min() >= 1e-4
    assert (final > THRESHOLD).any() and (final < THRESHOLD).any()


@pytest.mark.parametrize("cap_factor", [20, 1])
@pytest.mark.parametrize("final_merge", ["device", "host"])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("select_mode", ["packsort", "topk"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_hierarchical_matches_jax(name, select_mode, dedup, final_merge, cap_factor):
    vj, sj, vt, st = run_both(name, upsampling_steps=2, refine_cap_factor=cap_factor,
                              select_mode=select_mode, dedup=dedup,
                              final_merge=final_merge)
    assert vt.shape == vj.shape == (33, 33, 33) and vt.dtype == np.float32
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    assert_stats_equal(sj, st)
    # cap factor 1 binds at both levels, 20 at neither
    assert (sj["overflow"] > 0).all() == (cap_factor == 1)
    assert (sj["overflow"] > 0).any() == (cap_factor == 1)
    if final_merge == "host":
        np.testing.assert_allclose(
            tg.apply_final_merge(torch.from_numpy(vt), torch.from_numpy(st["final_idx"]),
                                 torch.from_numpy(st["final_vals"])),
            jg.apply_final_merge(vj, sj["final_idx"], sj["final_vals"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [0, 1])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fewer_levels_match_jax(name, steps):
    vj, sj, vt, st = run_both(name, upsampling_steps=steps)
    n = RES0 * 2 ** steps + 1
    assert vt.shape == (n, n, n)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    assert_stats_equal(sj, st)
    assert st["overflow"].shape == (steps,)


def test_dense_grid_and_coordinates_match_jax():
    np.testing.assert_array_equal(
        tg.grid_coordinates(16, BOX, device="cpu").numpy(),
        np.asarray(jg.grid_coordinates(16, BOX)))
    blobs = FIELDS["two_blobs"]
    vj = jg.dense_grid_values(jax_decode(blobs), 16, BOX, chunk_size=CHUNK)
    vt = tg.dense_grid_values(torch_decode(blobs), 16, BOX, chunk_size=CHUNK, device="cpu")
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-6)


def batch_params():
    """Per-instance blobs of the three fields, padded to two blobs (the
    single-blob fields repeat theirs)."""
    c = np.zeros((3, 2, 3), np.float32)
    a = np.zeros((3, 2, 3), np.float32)
    for i, name in enumerate(sorted(FIELDS)):
        blobs = FIELDS[name] * (2 // len(FIELDS[name]))
        for k, (ck, ak) in enumerate(blobs):
            c[i, k], a[i, k] = ck, ak
    return c, a


def batched_field(q, c, a):
    """(B, M, 3) queries of instances with blobs c, a (B, 2, 3) -> (B, M)."""
    out = [field32(q[b], [(c[b, k], a[b, k]) for k in range(2)]) for b in range(len(q))]
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("final_merge", ["device", "host"])
@pytest.mark.parametrize("select_mode", ["packsort", "topk"])
def test_batched_matches_jax_vmap(select_mode, final_merge):
    c, a = batch_params()

    def jax_logits(q, codes):
        return jax.pure_callback(
            lambda *x: batched_field(*x),
            jax.ShapeDtypeStruct(q.shape[:-1], jnp.float32), q, codes["c"], codes["a"],
            vmap_method="sequential")

    def torch_logits(q, codes):
        return torch.from_numpy(batched_field(q.numpy(), codes["c"].numpy(), codes["a"].numpy()))

    kw = dict(resolution0=RES0, upsampling_steps=2, threshold=THRESHOLD, box_size=BOX,
              chunk_size=CHUNK, refine_cap_factor=3, select_mode=select_mode,
              final_merge=final_merge)
    jcodes = {"c": jnp.asarray(c), "a": jnp.asarray(a), "s": jnp.ones(3, jnp.float32)}
    tcodes = {"c": torch.from_numpy(c), "a": torch.from_numpy(a), "s": torch.ones(3)}
    out_j = [np.asarray(x) for x in jg.batched_hierarchical_grid_values(jax_logits, jcodes, **kw)]
    out_t = [x.numpy() for x in tg.batched_hierarchical_grid_values(torch_logits, tcodes, **kw)]
    assert len(out_t) == len(out_j) == (4 if final_merge == "host" else 2)
    assert out_t[0].shape == (3, 33, 33, 33)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out_t[1], out_j[1])
    assert out_j[1].shape == (3, 2) and out_j[1].any()  # cap factor 3 binds somewhere
    if final_merge == "host":
        np.testing.assert_array_equal(out_t[2], out_j[2])
        sel = out_j[2] < 33 ** 3
        np.testing.assert_array_equal(out_t[3][sel], out_j[3][sel])
        for b in range(3):
            np.testing.assert_allclose(
                tg.apply_final_merge(out_t[0][b], out_t[2][b], out_t[3][b]),
                jg.apply_final_merge(out_j[0][b], out_j[2][b], out_j[3][b]), rtol=0, atol=1e-6)


def test_argument_checks_match_jax():
    decode = torch_decode(FIELDS["sphere"])
    kw = dict(resolution0=4, device="cpu")
    for bad, match in ((dict(select_mode="bogus"), "select_mode"),
                       (dict(final_merge="bogus"), "final_merge"),
                       (dict(final_merge="host"), "return_stats"),
                       (dict(final_merge="host", return_stats=True, upsampling_steps=0),
                        "upsampling_steps")):
        with pytest.raises(ValueError, match=match):
            tg.hierarchical_grid_values(decode, **kw, **bad)
        with pytest.raises(ValueError, match=match):
            jg.hierarchical_grid_values(jax_decode(FIELDS["sphere"]), resolution0=4, **bad)
    with pytest.raises(ValueError, match="upsampling_steps"):
        tg.batched_hierarchical_grid_values(
            lambda q, c: q[..., 0], {"s": torch.ones(2)}, resolution0=4,
            upsampling_steps=0, final_merge="host")
