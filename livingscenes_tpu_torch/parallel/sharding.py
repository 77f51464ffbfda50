"""Data parallelism over torch.distributed.

Counterpart of livingscenes_tpu/parallel/sharding.py. JAX runs one SPMD
program over a `jax.sharding.Mesh`; here every rank is a process of its own
that runs the program on its share of the rows, and the collectives below
put the shares back together:

* axis "dp": scenes of the scene-pair pipeline (solver/pipeline.py) and the
  training batch (train/trainer.py: the gradients are averaged over the
  ranks before the clipping).
* axis "qp": the query points of a grid evaluation (recon/grid.py,
  recon/extractor.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the world with
JAX's axis names (`make_mesh`). None, or a mesh of size 1, runs unsharded,
as in JAX. Every rank passes the whole input and gets the whole output.

JAX's `batch_sharding` and `replicated` return XLA sharding annotations,
which mean nothing to torch. Their roles are taken by `shard_batch` (this
rank's rows of the leading axis) and `replicate` (a broadcast from rank 0).

Collectives are the ones torch 2.11 and 2.13 both have (broadcast,
all_reduce and the list form of all_gather). Under the gloo backend a CUDA
tensor goes through the host.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device=None) -> bool:
    """Join the process group of a multi-process run; True once joined.

    Arguments left out are read from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK; init_method "env://", which reads MASTER_ADDR
    and MASTER_PORT). In a single process with no `init_method` this is a
    logged no-op that returns False, as JAX's is on one host.

    Each rank runs on cuda:(LOCAL_RANK % device_count) unless `device`
    names "cpu"; with no card and no device named it raises
    (device.resolve_device's rule). The backend defaults to "nccl" on the
    card and "gloo" on the CPU. NCCL cannot run two ranks on one card:
    asked to, this raises and names the card; pass backend="gloo" there.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    world = world_size if world_size is not None else int(env.get("WORLD_SIZE", 1))
    rank = rank if rank is not None else int(env.get("RANK", 0))
    if init_method is None and world <= 1:
        log.info("single process: skipping torch.distributed.init_process_group")
        return False
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the ranks on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        count = torch.cuda.device_count()
        if local_world > count:
            raise RuntimeError(
                f"{local_world} ranks under nccl on {count} card(s): rank "
                f"{rank} would share cuda:{dev.index} "
                f"({torch.cuda.get_device_name(dev.index)}) with another rank, "
                "which NCCL refuses; pass backend='gloo' to run several ranks "
                "on one card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    log.info("rank %d of %d on %s (%s)", rank, world, dev, backend)
    return True


def make_mesh(device_type: Optional[str] = None,
              axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over every rank of the initialized world, default 1-D
    "dp" (further axes of size 1). `device_type` defaults to where the
    backend's collectives run: "cuda" under nccl, "cpu" under gloo (whose
    collectives go through the host, CUDA tensors included)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(initialize_distributed); run unsharded with mesh=None")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    ranks = torch.arange(world).reshape(tuple(shape))
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_size(mesh, axis: Optional[str] = None) -> int:
    """The number of ranks along `axis` (all of them with no axis); 1
    without a mesh."""
    if mesh is None:
        return 1
    return mesh.size() if axis is None else mesh.size(_dim(mesh, axis))


def active_mesh(mesh, axis: Optional[str] = None):
    """The mesh, or None where it has one rank along `axis`: a mesh of size 1
    runs unsharded."""
    return mesh if mesh_size(mesh, axis) > 1 else None


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def shard_rows(n: int, mesh, axis: str = "dp") -> slice:
    """This rank's rows of a leading axis of n rows, which the axis must
    divide."""
    size = mesh_size(mesh, axis)
    if n % size:
        raise ValueError(f"a leading axis of {n} rows does not divide over "
                         f"the {size} ranks of mesh axis {axis!r}")
    per = n // size
    r = mesh.get_local_rank(axis) if size > 1 else 0
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh, axis: str = "dp"):
    """This rank's rows of the leading axis of a tensor, a numpy array or a
    dict of them (all of one length)."""
    if isinstance(batch, dict):
        lengths = {len(v) for v in batch.values()}
        if len(lengths) > 1:
            raise ValueError(f"batch entries of different lengths {sorted(lengths)}")
        rows = shard_rows(lengths.pop(), mesh, axis) if batch else slice(None)
        return {k: v[rows] for k, v in batch.items()}
    return batch[shard_rows(len(batch), mesh, axis)]


def _group(mesh, axis: Optional[str]):
    return mesh.get_group(axis if axis is not None else 0)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective sends: under gloo a CUDA tensor is copied to
    the host; bool goes as uint8."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous()


def replicate(module_or_tensors, mesh, axis: Optional[str] = None):
    """Broadcast rank 0's parameters and buffers (a module) or tensors (a
    tensor, a list or a dict of them) to every rank, in place; returns the
    argument."""
    if active_mesh(mesh) is None:
        return module_or_tensors
    group = _group(mesh, axis)
    src = dist.get_global_rank(group, 0)
    x = module_or_tensors
    if isinstance(x, torch.nn.Module):
        tensors = list(x.parameters()) + list(x.buffers())
    elif isinstance(x, dict):
        tensors = list(x.values())
    elif torch.is_tensor(x):
        tensors = [x]
    else:
        tensors = list(x)
    with torch.no_grad():
        for t in tensors:
            wire = _wire(t.detach(), group)
            dist.broadcast(wire, src=src, group=group)
            if wire is not t:
                t.copy_(wire.to(t.device, t.dtype))
    return module_or_tensors


def gather_batch(x, mesh, axis: str = "dp"):
    """Every rank's rows of a tensor (or a dict of them) concatenated on the
    leading axis in rank order: the global array of JAX's sharded output.
    The shards must have one shape."""
    if isinstance(x, dict):
        return {k: gather_batch(v, mesh, axis) for k, v in x.items()}
    if active_mesh(mesh, axis) is None:
        return x
    group = _group(mesh, axis)
    wire = _wire(x, group)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).to(x.device, x.dtype)


def all_reduce_mean(tensors, mesh, axis: str = "dp"):
    """The mean over the ranks of each tensor of a list, as one flattened
    buffer in one all_reduce (the tensors themselves without a mesh)."""
    if active_mesh(mesh, axis) is None:
        return list(tensors)
    group = _group(mesh, axis)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    wire = _wire(flat, group)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    flat = wire.to(flat.device) / dist.get_world_size(group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


class RowDraws:
    """A generator whose draws are made for a global batch of `total` rows,
    of which this rank keeps rows [start, stop): every rank draws what the
    unsharded run draws, in the same order, and the generator advances as
    it would there. Pass it where a generator is taken; the random sites
    draw through `batch_draw`."""

    def __init__(self, generator: torch.Generator, rows: slice, total: int):
        self.generator, self.rows, self.total = generator, rows, total

    @property
    def device(self) -> torch.device:
        return self.generator.device


def batch_draw(fn, shape, generator, **kwargs) -> torch.Tensor:
    """fn(shape, generator=generator, **kwargs) for a draw whose leading
    axis is the batch (torch.rand, torch.randn); with RowDraws the whole
    batch is drawn and this rank's rows kept."""
    shape = tuple(shape)
    if isinstance(generator, RowDraws):
        rows = generator.rows
        if shape[0] != rows.stop - rows.start:
            raise ValueError(f"a draw of {shape[0]} rows from RowDraws of rows "
                             f"{rows.start}:{rows.stop}")
        full = fn((generator.total,) + shape[1:], generator=generator.generator,
                  **kwargs)
        return full[rows]
    return fn(shape, generator=generator, **kwargs)
