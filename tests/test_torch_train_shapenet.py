"""The port's ShapeNet data path held against the JAX package on the CPU:
the depth rasterizer and back-projection (recon/render.py over
native/src/rasterize.cpp), mesh preprocessing (tools/preprocess.py), the
binvox reader and writer (utils/binvox.py), ShapeNetSDFDataset in every
mode (train/data.py), build_datasets on configs/production_shapenet.yaml
(train/run.py), and one training step of the TINY model on a ShapeNet
batch.

The trees are built by the tests from watertight meshes extracted from
analytic SDFs (a sphere, a box, a capsule), as tests/test_render_preprocess.py
does: the repository holds no ShapeNet data. Both sides run numpy (and the
same C++) on the same inputs, so depth images, npz arrays, dataset items
and binvox bytes are held bit for bit. The training step (f64, dropout and
the centre jitter off) is held as tests/test_torch_port_train.py holds the
synthetic one: the loss and metrics to rtol 1e-9, each gradient to 1e-8 of
its largest entry.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.native import bindings as jnative
from livingscenes_tpu.recon import render as jrender
from livingscenes_tpu.recon.mesh import Mesh as JMesh
from livingscenes_tpu.tools import preprocess as jpre
from livingscenes_tpu.train import config as jconfig
from livingscenes_tpu.train import data as jdata
from livingscenes_tpu.train import run as jrun
from livingscenes_tpu.utils import binvox as jbinvox
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.recon import render as trender
from livingscenes_tpu_torch.recon.mesh import Mesh as TMesh
from livingscenes_tpu_torch.tools import preprocess as tpre
from livingscenes_tpu_torch.train import config as tconfig
from livingscenes_tpu_torch.train import data as tdata
from livingscenes_tpu_torch.train import run as trun
from livingscenes_tpu_torch.utils import binvox as tbinvox
from test_torch_port_train import B, jax_model, port_model, to_torch
from test_torch_solver_more import numpy_params
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "production_shapenet.yaml")
# two of the config's seven categories
CATS = ("03001627", "04379243")
CAMERA = dict(width=48, height=48, fx=48.0, fy=48.0)
SIZES = dict(n_pointcloud=600, n_uni=800, n_nss=800, n_views=4)


def analytic_mesh(kind, n=33):
    """A watertight mesh (float32 vertices) of an analytic SDF, extracted
    on an n^3 grid over [-1, 1]^3."""
    g = np.linspace(-1, 1, n)
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    if kind == "sphere":
        sdf = np.linalg.norm(p, axis=-1) - 0.4
    elif kind == "box":
        sdf = jdata._sdf_box(p.reshape(-1, 3), np.array([0.5, 0.3, 0.2])).reshape(p.shape[:3])
    else:
        sdf = jdata._sdf_capsule(p.reshape(-1, 3), np.array([-0.4, 0.0, 0.0]),
                                 np.array([0.4, 0.1, 0.0]), 0.2).reshape(p.shape[:3])
    verts, faces = jnative.marching_isosurface((-sdf).astype(np.float32), 0.0)
    return (verts / (n - 1) * 2 - 1).astype(np.float32), faces


def write_tree(root, preprocess, mesh_type):
    """root/<cat>/<oid>: CATS[0] with a sphere and a box, CATS[1] with a
    capsule; each also with points.npz (packed occupancies of its uniform
    samples) for dataset_mode occ; and split.csv."""
    objects = [(CATS[0], "sphere0", "sphere"), (CATS[0], "box0", "box"),
               (CATS[1], "capsule0", "capsule")]
    for i, (cat, oid, kind) in enumerate(objects):
        d = os.path.join(root, cat, oid)
        preprocess(mesh_type(*analytic_mesh(kind)), d,
                   camera=(jrender.Camera if mesh_type is JMesh else trender.Camera)(**CAMERA),
                   seed=i, **SIZES)
        uni = np.load(os.path.join(d, "points_uni.npz"))
        np.savez(os.path.join(d, "points.npz"), points=uni["points"],
                 occupancies=np.packbits(uni["sdf"] <= 0))
    # a listed object without files, a short row and another split
    rows = ["03001627,sphere0,train", "03001627,box0,train", "04379243,capsule0,train",
            "03001627,missing0,train", "03001627,sphere0,val", "04379243,capsule0,val",
            "bad_row"]
    with open(os.path.join(root, "split.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return os.path.join(root, "split.csv")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    return root, write_tree(root, tpre.preprocess_mesh, TMesh)


def test_render_depth_and_partial_clouds_equal_jax():
    verts, faces = analytic_mesh("box")
    jm, tm = JMesh(verts, faces), TMesh(verts, faces)
    eye = np.array([1.7, -0.6, 0.9])
    R, t = jrender.look_at(eye, np.zeros(3))
    R2, t2 = trender.look_at(eye, np.zeros(3))
    np.testing.assert_array_equal(R, R2)
    np.testing.assert_array_equal(t, t2)
    cam_j, cam_t = jrender.Camera(**CAMERA), trender.Camera(**CAMERA)
    dj = jrender.render_depth(jm, R, t, cam_j)
    dt = trender.render_depth(tm, R, t, cam_t)
    assert (dj > 0).sum() > 200
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(trender.backproject_depth(dt, R, t, cam_t),
                                  jrender.backproject_depth(dj, R, t, cam_j))
    # a view straight down +z takes the look_at fallback for `right`
    Rz, tz = trender.look_at(np.array([0.0, 0.0, 2.0]), np.zeros(3))
    np.testing.assert_array_equal(
        Rz, jrender.look_at(np.array([0.0, 0.0, 2.0]), np.zeros(3))[0])
    for kw in (dict(n_views=3, seed=4, max_points_per_view=200),
               dict(n_views=2, seed=1, max_points_per_view=None)):
        cj = jrender.render_partial_clouds(jm, camera=cam_j, **kw)
        ct = trender.render_partial_clouds(tm, camera=cam_t, **kw)
        assert len(cj) == len(ct) == kw["n_views"]
        for a, b in zip(ct, cj):
            assert a.dtype == np.float32 and len(a) > 0
            np.testing.assert_array_equal(a, b)


def test_preprocess_trees_equal_jax(tmp_path, tree):
    """The same meshes give the same npz arrays, key by key, through both
    tools; normalize_mesh and compute_sdf alone too; and the port's
    command line writes the tree of one PLY."""
    jroot = str(tmp_path / "jax")
    write_tree(jroot, jpre.preprocess_mesh, JMesh)
    troot = tree[0]
    for dirpath, _, names in os.walk(jroot):
        for name in names:
            if not name.endswith(".npz"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jroot)
            with np.load(os.path.join(jroot, rel)) as a, np.load(os.path.join(troot, rel)) as b:
                assert sorted(a.files) == sorted(b.files), rel
                for k in a.files:
                    assert a[k].dtype == b[k].dtype, (rel, k)
                    np.testing.assert_array_equal(b[k], a[k], err_msg=f"{rel} {k}")
    verts, faces = analytic_mesh("capsule")
    nj = jpre.normalize_mesh(JMesh(verts * 3 + 1, faces), padding=0.2)
    nt = tpre.normalize_mesh(TMesh(verts * 3 + 1, faces), padding=0.2)
    np.testing.assert_array_equal(nt.vertices, nj.vertices)
    q = np.random.default_rng(0).uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tpre.compute_sdf(nt, q, n_surface=5000, seed=3),
        jpre.compute_sdf(nj, q, n_surface=5000, seed=3))

    ply = str(tmp_path / "capsule.ply")
    TMesh(verts, faces).export_ply(ply)
    tpre.main(["--mesh", ply, "--out", str(tmp_path / "cli"), "--views", "2"])
    names = sorted(os.listdir(tmp_path / "cli"))
    assert names == ["dep_pcl_0.npz", "dep_pcl_1.npz", "pointcloud.npz",
                     "points_nss.npz", "points_uni.npz"]


MODES = {
    "pcl": dict(input_mode="pcl"),
    "dep": dict(input_mode="dep"),
    "dep_occ_field": dict(input_mode="dep", field_mode="occ"),
    "occ_layout": dict(dataset_mode="occ", field_mode="occ"),
    "val_split": dict(split="val", input_mode="dep"),
    "no_csv": dict(split_csv=None, input_mode="dep", dep_min_use_view=1,
                   dep_max_use_view=3),
    "one_category": dict(categories=[CATS[1]], split_csv=None),
    "unbalanced_proportion": dict(class_balanced=False, proportion=0.5, seed=3),
    "ram_cache": dict(input_mode="dep", ram_cache=True, cache_workers=2),
    "augmented": dict(input_mode="dep", aug="aug", sampling_aug="sampling"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_shapenet_dataset_items_equal_jax(tree, mode):
    root, split_csv = tree
    kw = dict(split_csv=split_csv, n_pcl=96, n_uni=40, n_nss=24, n_eval=50, seed=1)
    kw.update(MODES[mode])

    def make(module):
        args = dict(kw)
        if args.get("aug"):
            args["aug"] = module.AugmentConfig(aug_ratio=1.0)
            args["sampling_aug"] = module.SamplingAugConfig()
        return module.ShapeNetSDFDataset(root, **args)

    dj, dt = make(jdata), make(tdata)
    assert dt.items == dj.items and len(dt) == len(dj) > 0
    for i in range(len(dj)):
        a, b = dj[i], dt[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"item {i} {k}")
    if mode == "occ_layout":
        assert dt[0]["points_nss"].shape == (0, 3)


def test_shapenet_dataset_refuses_bad_modes(tree, tmp_path):
    root, split_csv = tree
    with pytest.raises(ValueError):
        tdata.ShapeNetSDFDataset(root, dataset_mode="occ", field_mode="sdf")
    with pytest.raises(ValueError):
        tdata.ShapeNetSDFDataset(root, input_mode="depth")
    with pytest.raises(FileNotFoundError, match="livingscenes_tpu_torch.tools.preprocess"):
        tdata.ShapeNetSDFDataset(str(tmp_path / "absent"))


def shapenet_config(module, root, split_csv, **dataset):
    cfg = module.load_config(CONFIG)
    module.apply_overrides(cfg, [f"dataset.data_root={root}",
                                 f"dataset.shapenet_split_fn={split_csv}"]
                           + [f"dataset.{k}={v}" for k, v in dataset.items()])
    return cfg


def test_build_datasets_on_production_shapenet(tree):
    """configs/production_shapenet.yaml with only data_root and
    shapenet_split_fn overridden: the same train and val sets (depth views,
    augmentation on the training set) on both sides, a full-size item."""
    root, split_csv = tree
    cfg_t = shapenet_config(tconfig, root, split_csv)
    cfg_j = shapenet_config(jconfig, root, split_csv)
    assert cfg_t["dataset"] == cfg_j["dataset"]
    (tt, tv), (jt, jv) = trun.build_datasets(cfg_t), jrun.build_datasets(cfg_j)
    for a, b in ((tt, jt), (tv, jv)):
        assert isinstance(a, tdata.ShapeNetSDFDataset)
        assert a.items == b.items and a.input_mode == "dep"
        assert (a.dep_min_use_view, a.dep_max_use_view) == (2, 8)
        for k, v in b[0].items():
            np.testing.assert_array_equal(a[0][k], v, err_msg=k)
    assert tt.aug is not None and tt.aug.use_augmentation and tv.aug is None
    assert tt[0]["inputs"].shape == (1024, 3)
    assert tt[0]["points_uni"].shape == (1024, 3) and tt[0]["eval_points"].shape == (10000, 3)
    # the synthetic branch stays the default
    synth = trun.build_datasets({"dataset": {"n_train_items": 2, "n_val_items": 2,
                                             "ram_cache": False}})
    assert isinstance(synth[0], tdata.SyntheticShapeDataset)


def test_training_step_on_shapenet_batch_matches_jax(tree):
    """One TINY loss and its gradients (f64, JAX's init through
    params_from_jax) on a batch of depth-view ShapeNet items."""
    root, split_csv = tree
    ds = tdata.ShapeNetSDFDataset(root, split_csv=split_csv, input_mode="dep",
                                  n_pcl=64, n_uni=64, n_nss=64, n_eval=128)
    batch = next(tdata.batch_iterator(ds, B, seed=2))
    batch = {k: v.astype(np.float64) for k, v in batch.items()}
    jm = jax_model()
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          numpy_params(jm.prior, 4))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, None, train=False), has_aux=True))(params, jb)
    m = port_model(params)
    loss, metrics = m.loss(to_torch(batch), None, train=False)
    names = [k for k, _ in m.prior.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(m.prior.parameters()))))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-9, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    overall = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-9 * overall)
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-8 * top, err_msg=k)


def test_binvox_round_trips_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    grids = [rng.random((7, 5, 6)) > 0.6,
             np.ones((20, 20, 20), bool),  # runs longer than 255
             np.zeros((3, 4, 2), bool)]
    grids[1][3:5, :, 7] = False
    for i, data in enumerate(grids):
        kw = dict(translate=(0.5, -0.25, 1.0), scale=1.5 + i)
        pj, pt = str(tmp_path / f"j{i}.binvox"), str(tmp_path / f"t{i}.binvox")
        jbinvox.write_binvox(pj, jbinvox.VoxelGrid(data, **kw))
        tbinvox.write_binvox(pt, tbinvox.VoxelGrid(data, **kw))
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read()
        gt, gj = tbinvox.read_binvox(pj), jbinvox.read_binvox(pj)
        np.testing.assert_array_equal(gt.data, data)
        np.testing.assert_array_equal(gt.data, gj.data)
        assert gt.translate == gj.translate and gt.scale == gj.scale
        assert gt.resolution == data.shape
    bad = tmp_path / "bad.binvox"
    bad.write_bytes(b"#notbinvox\n")
    with pytest.raises(ValueError):
        tbinvox.read_binvox(str(bad))
