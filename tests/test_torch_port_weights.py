"""The PyTorch port's checkpoint reader, trained-weight encode, device rule
and import isolation.

Tolerances: the reader is exact (leaf for leaf, bit for bit). The trained
encode runs the production config in f32 on 2 clouds x 512 points against
the JAX default config: atol 1e-4 on z_so3 and z_inv, rtol 1e-4 on s and
t (matmul summation order only).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu_torch import device as port_device
from livingscenes_tpu_torch.models import convert
from livingscenes_tpu_torch.models.shape_prior import ShapePrior

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "weights", "production_r5_selected.ckpt")


@pytest.fixture(scope="module")
def trained():
    return convert.load_flax_checkpoint(CKPT)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_reader_equals_flax_msgpack_restore(trained):
    with open(CKPT, "rb") as f:
        want = serialization.msgpack_restore(f.read())["params"]
    got, ref = dict(_leaves(trained)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))


def test_reader_scalars_and_rejected_extensions():
    data = {"a": [1, -3, 300, -70000, 2 ** 40, 1.5, None, True, "x" * 40, b"\x00\x01"],
            "arr": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = convert.msgpack_restore(serialization.msgpack_serialize(data))
    assert out["a"] == data["a"]
    np.testing.assert_array_equal(out["arr"], data["arr"])
    for code in (2, 3):
        blob = msgpack.packb({"z": msgpack.ExtType(code, b"\x00")})
        with pytest.raises(ValueError, match="not supported"):
            convert.msgpack_restore(blob)


def test_params_from_jax_fills_every_parameter(trained):
    state = convert.params_from_jax(trained)
    m = ShapePrior(device="cpu")
    m.load_state_dict(state, strict=True)
    assert len(state) == len(list(_leaves(trained)))
    assert sum(k.startswith("decoder.") for k in state) == 8 * 3 + 2


def test_trained_encode_matches_jax(trained):
    rng = np.random.default_rng(0)
    pc = (rng.uniform(-0.5, 0.5, size=(2, 512, 3)) * [1.0, 0.6, 0.3]).astype(np.float32)
    jm = jsp.ShapePrior(jsp.ShapePriorConfig())
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), trained)
    cj = jax.jit(jm.encode)(jp, jnp.asarray(pc))
    m = ShapePrior(device="cpu")
    m.load_state_dict(convert.params_from_jax(trained))
    with torch.no_grad():
        ct = m.encode(torch.from_numpy(pc))
    np.testing.assert_allclose(ct["z_so3"].numpy(), np.asarray(cj["z_so3"]), atol=1e-4)
    np.testing.assert_allclose(ct["z_inv"].numpy(), np.asarray(cj["z_inv"]), atol=1e-4)
    np.testing.assert_allclose(ct["s"].numpy(), np.asarray(cj["s"]), rtol=1e-4)
    np.testing.assert_allclose(ct["t"].numpy(), np.asarray(cj["t"]), rtol=1e-4, atol=1e-5)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShapePrior()
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_cuda_wrappers_refuse_cpu_tensors():
    from livingscenes_tpu_torch.ops import cuda_fps, cuda_icp, cuda_knn

    x = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fps.fps_cuda(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_cuda(x, x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_icp.icp_stats_cuda(x, x, x)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import livingscenes_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'yaml', 'livingscenes_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
