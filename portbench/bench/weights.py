"""Weights for both sides of a cell: read from a flax msgpack checkpoint,
or drawn on the device from the seed. Both give one flat dict keyed by the
reference model's state-dict names, which the program loads with
`load_state_dict` and the reference reads as it is.
"""
from __future__ import annotations

import struct

import numpy as np
import torch


class _Reader:
    """A msgpack decoder for what flax writes: nil, bool, int, float, str,
    bin, array, map, and flax's ndarray extension (type 1)."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return {self.read(): self.read() for _ in range(n)}
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code != 1:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(payload).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def _name(comp: str, top: str) -> str:
    """The state-dict module name of a flax top-level entry: V_i -> V_list.i
    (Q_, K_ too), global_conv_j -> global_conv_list.(j - 2) in the
    attention encoder, lin<i> -> lin.<i> in the DeepSDF decoder."""
    if comp == "encoder":
        if top[:2] in ("V_", "Q_", "K_") and top[2:].isdigit():
            return f"{top[0]}_list.{top[2:]}"
        if top.startswith("global_conv_"):
            return f"global_conv_list.{int(top.rsplit('_', 1)[1]) - 2}"
    if comp == "decoder" and top.startswith("lin") and top[3:].isdigit():
        return f"lin.{top[3:]}"
    return top


def read_checkpoint(path: str, device) -> dict:
    """The `params` tree of a flax checkpoint as {state-dict name: float32
    tensor on `device`}."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()["params"]
    out = {}
    for comp, sub in tree.items():
        for path, value in _leaves(sub):
            key = ".".join([comp, _name(comp, path[0]), *path[1:]])
            out[key] = torch.from_numpy(np.array(value, np.float32)).to(device)
    return out


def seeded(shapes: dict, seed: int, device) -> dict:
    """Weights for {name: shape}, uniform in +-1/sqrt(fan_in) with fan_in
    the last axis of each (out, in) matrix (1 for a vector), drawn in one
    call on `device` from `seed`."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        shape = tuple(shapes[name])
        out[name] = (part / np.sqrt(shape[-1] if len(shape) > 1 else 1)).reshape(shape)
    return out
