"""The port's training data and configs held against the JAX package.

* livingscenes_tpu_torch/train/data.py keeps the JAX module's random
  streams: the same seeds give bit-equal arrays, with the scene-simulation
  and s1 sampling augmentations on, for the default shape families and the
  torus (shape_kinds=(3,)), item by item, through batch_iterator and through
  prefetch_iterator.
* livingscenes_tpu_torch/train/config.py reads every configs/*.yaml as
  PyYAML's safe_load does, resolves `inherit_from` as the JAX package's
  load_config does, applies overrides alike, writes a run directory's
  resolved config that it reads back equal, and refuses YAML outside its
  subset rather than reading it differently.
"""
import glob
import os

import numpy as np
import pytest
import yaml

from livingscenes_tpu.train import config as jconfig
from livingscenes_tpu.train import data as jdata
from livingscenes_tpu_torch.train import config as pconfig
from livingscenes_tpu_torch.train import data as pdata
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def dataset(mod, **kw):
    args = dict(n_items=6, n_pcl=96, n_uni=40, n_nss=40, n_eval=64, seed=4,
                aug=mod.AugmentConfig(aug_ratio=1.0),
                sampling_aug=mod.SamplingAugConfig(mixing_prob=0.5))
    args.update(kw)
    return mod.SyntheticShapeDataset(**args)


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kinds", [(0, 1, 2), (3,)])
def test_synthetic_items_bit_equal(kinds):
    jd, pd = dataset(jdata, shape_kinds=kinds), dataset(pdata, shape_kinds=kinds)
    for i in range(len(jd)):
        assert_items_equal(pd[i], jd[i])


def test_batches_bit_equal_and_cache():
    jd = dataset(jdata, aug=None)
    pd = dataset(pdata, aug=None, ram_cache=True, cache_workers=1)
    ji = jdata.batch_iterator(jd, 4, seed=9)
    pi = pdata.prefetch_iterator(pdata.batch_iterator(pd, 4, seed=9))
    for _ in range(4):  # past the end of the first epoch
        assert_items_equal(next(pi), next(ji))


def test_augmentations_bit_equal():
    rng = np.random.default_rng(0)
    pcl = rng.normal(size=(200, 3))
    q = [rng.normal(size=(30, 3))]
    for fn in ("augment_scene_sim",):
        a = getattr(pdata, fn)(pcl, np.random.default_rng(1), pdata.AugmentConfig())
        b = getattr(jdata, fn)(pcl, np.random.default_rng(1), jdata.AugmentConfig())
        np.testing.assert_array_equal(a, b)
    a = pdata.augment_sim3(pcl, q, np.random.default_rng(2))
    b = jdata.augment_sim3(pcl, q, np.random.default_rng(2))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][0], b[1][0])
    a = pdata.sampling_with_aug_s1(pcl, 150, np.random.default_rng(3),
                                   pdata.SamplingAugConfig(mixing_prob=1.0))
    b = jdata.sampling_with_aug_s1(pcl, 150, np.random.default_rng(3),
                                   jdata.SamplingAugConfig(mixing_prob=1.0))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_pyyaml(path):
    text = open(path).read()
    assert pconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path, tmp_path):
    cfg = pconfig.load_config(path)
    assert cfg == jconfig.load_config(path)
    # the run directory's copy reads back equal
    cfg = pconfig.apply_overrides(cfg, [f"logging.log_dir={tmp_path / 'run'}"])
    log_dir = pconfig.prepare_log_dir(cfg, path)
    with open(os.path.join(log_dir, "files_backup", "resolved_config.yaml")) as f:
        text = f.read()
    assert pconfig.parse_yaml(text) == cfg
    assert yaml.safe_load(text) == cfg


def test_overrides_match_jax():
    overrides = ["training.batch_size=8", "dataset.n_train_items=32",
                 "a.b.c=hello", "model.w_s=0.25", "x.flag=true",
                 "x.list=[1, 2.5, 'a']", "x.none=null", "x.small=0.00000001"]
    base = pconfig.load_config(os.path.join(ROOT, "configs", "production_r5.yaml"))
    got = pconfig.apply_overrides(base, overrides)
    want = jconfig.apply_overrides(
        jconfig.load_config(os.path.join(ROOT, "configs", "production_r5.yaml")),
        overrides)
    assert got == want


@pytest.mark.parametrize("text", [
    "a:\n  - b: 1\n",              # block sequence of mappings
    "a: &x 1\nb: *x\n",            # anchors
    "a: {b: 1}\n",                 # flow mapping
    "a: [1, [2]]\n",               # nested flow list
    "a:\n\tb: 1\n",                # tab
    "a: 0x10\n",                   # hexadecimal
    "a: 010\n",                    # octal
    "a: 1\n a2: 2\n",              # bad indentation
    "a: 1\na: 2\n",                # duplicate key
    "a: |\n  text\n",              # block scalar
])
def test_yaml_reader_refuses_outside_its_subset(text):
    with pytest.raises(ValueError):
        pconfig.parse_yaml(text)
