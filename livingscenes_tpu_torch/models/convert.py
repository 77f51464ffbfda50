"""Weights carried across from the JAX package.

`load_flax_checkpoint` reads a flax msgpack checkpoint (weights/*.ckpt) with
the standard library and numpy alone, and `params_from_jax` maps the flax
parameter tree onto the port's state-dict keys (those of the reference
model, as livingscenes_tpu/models/convert.py:177 exports them, for the
encoder; "decoder.lin.<i>.{v,g,b}" and, for a plain dense layer,
"decoder.lin.<i>.{kernel,bias}" for the DeepSDF decoder, whose matrices keep
the flax (in, out) orientation).
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


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """Map the flax tree {"encoder": {...}, "decoder": {...}[, "cls_head":
    {...}]} to the port's state dict (keys "encoder.V_list.0.lin.weight",
    "decoder.lin.0.v", "cls_head.lin0.kernel", ...).
    No tensor is transposed: VecLinear weights are stored (out, in) on both
    sides and the decoder's matrices (in, out) on both sides."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        name, rest = path[0], path[1:]
        if name[:2] in ("V_", "Q_", "K_") and name[2:].isdigit():
            key = f"{name[0]}_list.{name[2:]}"
        elif name.startswith("global_conv_"):
            j = int(name.rsplit("_", 1)[1]) - RES_GLOBAL_START_LAYER
            key = f"global_conv_list.{j}"
        else:
            key = name
        out[".".join(["encoder", key] + rest)] = torch.from_numpy(np.array(node))

    walk(params["encoder"], [])
    for name, layer in params["decoder"].items():
        if not (name.startswith("lin") and name[3:].isdigit()):
            raise ValueError(f"unexpected decoder entry {name!r}")
        for leaf, value in layer.items():
            out[f"decoder.lin.{name[3:]}.{leaf}"] = torch.from_numpy(np.array(value))
    for name, layer in params.get("cls_head", {}).items():
        for leaf, value in layer.items():
            out[f"cls_head.{name}.{leaf}"] = torch.from_numpy(np.array(value))
    return out


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
    ".bias". Keys of neither part (the reference's classification head or
    positional-encoding projector, which the port has not) raise."""
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
        if comp == "encoder":
            out[f"network_dict.encoder.{rest}"] = value
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
