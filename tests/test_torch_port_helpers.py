"""The port's counterparts of three helpers of the JAX package's surface,
held against JAX's on the CPU:

- ops/fps.py fps_subsample_with_features (livingscenes_tpu/ops/fps.py):
  2 clouds x 256 points, factor 4, 5 feature channels: indices equal,
  features equal bit for bit (both gather the same rows).
- models/shape_prior.py concat_codes: the codes of two batches joined,
  from each package's encoder (the small model of test_torch_solver_more.py
  on the same weights), by each package's concat_codes: equal bit for bit
  (a concatenation rounds nothing); slice_codes takes the batches back.
- train/config.py load_run_config on configs/production_r5.yaml: the port
  reads the run directory that JAX's prepare_log_dir wrote (PyYAML's
  block sequences), JAX reads the one the port's wrote (flow lists), and
  both give the resolved config.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.ops.fps import fps_subsample_with_features as jax_fps_subsample
from livingscenes_tpu.train import config as jconfig
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import (
    ShapePrior, ShapePriorConfig, concat_codes, slice_codes)
from livingscenes_tpu_torch.ops.fps import fps_subsample_with_features
from livingscenes_tpu_torch.train import config as pconfig
from test_torch_solver_more import SMALL, numpy_params
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "production_r5.yaml")


def test_fps_subsample_with_features_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 5)).astype(np.float32)
    sampled, got, idx = fps_subsample_with_features(
        torch.from_numpy(pts), torch.from_numpy(feats), 4)
    j_sampled, want, j_idx = jax_fps_subsample(jnp.asarray(pts), jnp.asarray(feats), 4)
    assert idx.shape == (2, 64) and got.shape == (2, 64, 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(j_sampled))
    # the encoder's features (B, N, C, 3) gather the same rows
    vec = torch.from_numpy(rng.normal(size=(2, 256, 4, 3)).astype(np.float32))
    _, vec_got, _ = fps_subsample_with_features(torch.from_numpy(pts), vec, 4)
    assert torch.equal(vec_got, vec[torch.arange(2)[:, None], idx])


def test_concat_codes_matches_jax():
    params = numpy_params(jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL)), 0)
    jmodel = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL))
    model = ShapePrior(ShapePriorConfig(**SMALL), device="cpu", dtype=torch.float64)
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(1)
    clouds = [rng.normal(size=(b, 64, 3)) for b in (2, 3)]
    with torch.no_grad():
        port_codes = [model.encode(torch.from_numpy(c)) for c in clouds]
    encode = jax.jit(jmodel.encode)
    jax_codes = [encode(params, jnp.asarray(c)) for c in clouds]
    for codes_list in (port_codes, jax_codes):
        as_torch = [{k: torch.as_tensor(np.asarray(v)) for k, v in c.items()}
                    for c in codes_list]
        as_jax = [{k: jnp.asarray(np.asarray(v)) for k, v in c.items()}
                  for c in codes_list]
        got = concat_codes(as_torch)
        want = jsp.concat_codes(as_jax)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        for part, rows in zip(as_torch, ([0, 1], [2, 3, 4])):
            back = slice_codes(got, rows)
            assert all(torch.equal(back[k], part[k]) for k in part)


def test_load_run_config_both_ways(tmp_path):
    # JAX writes the run directory (PyYAML), the port reads it
    jcfg = jconfig.apply_overrides(jconfig.load_config(CONFIG),
                                   [f"logging.log_dir={tmp_path / 'jax_run'}"])
    jdir = jconfig.prepare_log_dir(jcfg, CONFIG)
    text = open(os.path.join(jdir, "files_backup", "resolved_config.yaml")).read()
    assert re.search(r"\n *- ", text)  # PyYAML writes lists as block sequences
    assert pconfig.load_run_config(jdir) == jcfg
    # the port writes it, JAX and the port read it
    pcfg = pconfig.apply_overrides(pconfig.load_config(CONFIG),
                                   [f"logging.log_dir={tmp_path / 'port_run'}"])
    pdir = pconfig.prepare_log_dir(pcfg, CONFIG)
    assert jconfig.load_run_config(pdir) == pcfg
    assert pconfig.load_run_config(pdir) == pcfg
    assert {**jcfg, "logging": None} == {**pcfg, "logging": None}


@pytest.mark.parametrize("text", [
    "a:\n- 1\n- 2.5\n- x\nb: 2\n",        # at the key's indentation (PyYAML's)
    "a:\n  b:\n    - null\n    - 'q'\n  c: 1\n",  # indented
    "a:\n  b:\n  -\n  - 3\n",             # an empty item: null
])
def test_yaml_reader_reads_block_sequences(text):
    import yaml

    assert pconfig.parse_yaml(text) == yaml.safe_load(text)
