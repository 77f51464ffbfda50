"""Weights carried across from the JAX package.

`load_flax_checkpoint` reads a flax msgpack checkpoint (weights/*.ckpt) with
the standard library and numpy alone, and `params_from_jax` maps the flax
parameter tree onto the port's state-dict keys (those of the reference
model, as livingscenes_tpu/models/convert.py:177 exports them, for the
attention encoder; the flax path joined by dots for the ablation encoders,
DecoderCat, the ONet decoders and the positional-encoding projector, whose
modules keep flax's names; "decoder.lin.<i>.{v,g,b}" and, for a plain dense
layer, "decoder.lin.<i>.{kernel,bias}" for the DeepSDF decoder). Matrices
keep the flax orientation. `params_to_jax` is its inverse.
"""
from __future__ import annotations

import struct
from typing import Dict

import numpy as np
import torch

from ..nn.vec_dgcnn_attn import RES_GLOBAL_START_LAYER

# flax.serialization's msgpack extension types
_EXT_NDARRAY = 1
_EXT_NATIVE_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    """A minimal msgpack decoder: nil, bool, int, float, str, bin, array,
    map, and flax's ndarray extension."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(self._unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(self._unpack(">b"), 1 << (b - 0xD4))
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self._unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int):
        return [self.read() for _ in range(n)]

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            shape, dtype_name, buf = _Reader(payload).read()
            if isinstance(dtype_name, bytes):
                dtype_name = dtype_name.decode()
            return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        if code in (_EXT_NATIVE_COMPLEX, _EXT_NPSCALAR):
            raise ValueError(
                f"msgpack extension type {code} (complex or numpy scalar) "
                "is not supported in a weights checkpoint"
            )
        raise ValueError(f"unknown msgpack extension type {code}")


def msgpack_restore(data: bytes):
    """Decode a flax msgpack payload into dicts, lists and numpy arrays."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    if isinstance(out, dict) and "__msgpack_chunked_array__" in out:
        raise ValueError("chunked msgpack arrays are not supported")
    return out


def load_flax_checkpoint(path: str) -> Dict:
    """The `params` tree of a flax checkpoint file, as numpy arrays."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return payload["params"]


def _leaves(node, path=()):
    """(path, array) of every leaf of a nested dict."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def _port_name(comp: str, name: str) -> str:
    """The port's module name of a flax top-level entry of a component:
    V_i -> V_list.i (Q_, K_ likewise), global_conv_j -> global_conv_list.
    (j - 2) in the attention encoder; lin<i> -> lin.<i> in the DeepSDF
    decoder; any other name is kept."""
    if comp == "encoder":
        if name[:2] in ("V_", "Q_", "K_") and name[2:].isdigit():
            return f"{name[0]}_list.{name[2:]}"
        if name.startswith("global_conv_"):
            j = int(name.rsplit("_", 1)[1]) - RES_GLOBAL_START_LAYER
            return f"global_conv_list.{j}"
    if comp == "decoder" and name.startswith("lin") and name[3:].isdigit():
        return f"lin.{name[3:]}"
    return name


def _flax_name(comp: str, parts) -> tuple:
    """The inverse of _port_name on a state-dict key's parts after the
    component: (flax top-level name, the rest of the path)."""
    if comp == "encoder" and parts[0] in ("V_list", "Q_list", "K_list"):
        return (f"{parts[0][0]}_{parts[1]}",) + tuple(parts[2:])
    if comp == "encoder" and parts[0] == "global_conv_list":
        return (f"global_conv_{int(parts[1]) + RES_GLOBAL_START_LAYER}",) + tuple(parts[2:])
    if comp == "decoder" and parts[0] == "lin" and parts[1].isdigit():
        return (f"lin{parts[1]}",) + tuple(parts[2:])
    return tuple(parts)


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """Map the flax tree {"encoder": {...}, "decoder": {...}[, "cls_head":
    {...}][, "pe_projector": {...}]} to the port's state dict (keys
    "encoder.V_list.0.lin.weight", "encoder.conv1.lin.weight",
    "decoder.lin.0.v", "decoder.block0_fc0.kernel", "cls_head.lin0.kernel",
    "pe_projector.weight", ...). No tensor is transposed: VecLinear weights are stored (out, in) on both
    sides and dense matrices (in, out) on both sides."""
    out: Dict[str, torch.Tensor] = {}
    for comp, tree in params.items():
        for path, value in _leaves(tree):
            key = [_port_name(comp, path[0])] + list(path[1:])
            out[".".join([comp] + key)] = torch.from_numpy(np.array(value))
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of `params_from_jax`: the port's state dict as a flax
    tree of numpy arrays, {component: {name: {...}}}."""
    out: Dict = {}
    for key, value in state.items():
        comp, *parts = key.split(".")
        node = out.setdefault(comp, {})
        path = _flax_name(comp, parts)
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.detach().cpu().numpy()
    return out


def module_params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax tree of one module (an encoder or decoder on its own, an ONet
    decoder, a layer) as that module's state dict: the flax paths joined by
    dots."""
    return {".".join(path): torch.from_numpy(np.array(value))
            for path, value in _leaves(tree)}


def _decoder_layer(name: str) -> str:
    """"lin3" -> "3"; raises on any other decoder entry."""
    if not (name.startswith("lin") and name[3:].isdigit()):
        raise ValueError(f"unexpected decoder entry {name!r}")
    return name[3:]


def state_dict_from_torch(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict (keys
    "network_dict.{encoder,decoder}.<module path>", a "module." prefix
    dropped) in the port's layout. The encoder's keys are the reference's;
    a weight-normed decoder layer "lin<i>.weight_v" (out, in),
    "lin<i>.weight_g" (out, 1) and "lin<i>.bias" becomes "decoder.lin.<i>.v"
    (in, out), ".g" (out,) and ".b", in either torch layout of weight norm;
    a plain one "lin<i>.weight" and ".bias" becomes ".kernel" (in, out) and
    ".bias". The positional-encoding projector's "pe_projector.weight"
    keeps its (out, in - 1) layout. Keys of no part (the reference's
    classification head among them) raise."""
    out: Dict[str, torch.Tensor] = {}
    decoder: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in sd.items():
        parts = key.replace("module.", "").split(".")
        if "encoder" in parts:
            rest = parts[parts.index("encoder") + 1:]
            out[".".join(["encoder"] + rest)] = value.detach().cpu()
        elif "decoder" in parts:
            rest = parts[parts.index("decoder") + 1:]
            decoder.setdefault(_decoder_layer(rest[0]), {})[".".join(rest[1:])] = (
                value.detach().cpu())
        elif "pe_projector" in parts:
            rest = parts[parts.index("pe_projector") + 1:]
            out[".".join(["pe_projector"] + rest)] = value.detach().cpu()
        else:
            raise ValueError(f"checkpoint key {key!r} belongs to no part of the "
                             "port's model")
    for i, leaves in decoder.items():
        v = leaves.pop("weight_v", leaves.pop("parametrizations.weight.original1", None))
        g = leaves.pop("weight_g", leaves.pop("parametrizations.weight.original0", None))
        prefix = f"decoder.lin.{i}"
        if v is not None:
            out[f"{prefix}.v"] = v.T.contiguous()
            out[f"{prefix}.g"] = g.reshape(-1)
            out[f"{prefix}.b"] = leaves.pop("bias")
        else:
            out[f"{prefix}.kernel"] = leaves.pop("weight").T.contiguous()
            out[f"{prefix}.bias"] = leaves.pop("bias")
        if leaves:
            raise ValueError(f"unexpected entries of decoder layer lin{i}: "
                             f"{sorted(leaves)}")
    return out


def state_dict_to_torch(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state dict in the reference checkpoint's layout: the
    inverse of `state_dict_from_torch` (weight norm as weight_v and
    weight_g)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        comp, rest = key.split(".", 1)
        if comp in ("encoder", "pe_projector"):
            out[f"network_dict.{comp}.{rest}"] = value
            continue
        _, i, leaf = rest.split(".")
        name = f"network_dict.decoder.lin{i}"
        if leaf == "v":
            out[f"{name}.weight_v"] = value.T.contiguous()
        elif leaf == "g":
            out[f"{name}.weight_g"] = value.reshape(-1, 1)
        elif leaf in ("b", "bias"):
            out[f"{name}.bias"] = value
        elif leaf == "kernel":
            out[f"{name}.weight"] = value.T.contiguous()
        else:
            raise ValueError(f"unexpected state-dict key {key!r}")
    return out
