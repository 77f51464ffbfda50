"""Rank processes for the port's data-parallel tests (test_torch_parallel_*).

`spawn(fn, world, tmp_path, *args)` starts `world` processes with
torch.multiprocessing (spawn), each joining a gloo group through a file
under tmp_path, on the CPU, with one intra-op thread; `fn(rank, world,
tmp_path, *args)` runs in each and writes its results under tmp_path,
which the parent reads. This module imports torch and the port only, so
that the children start without JAX.
"""
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from livingscenes_tpu_torch.parallel import initialize_distributed, make_mesh


def spawn(fn, world: int, tmp_path, *args) -> None:
    init = "file://" + os.path.join(str(tmp_path), f"rendezvous_{fn.__name__}_{world}")
    mp.spawn(_entry, args=(fn, world, init, str(tmp_path), args), nprocs=world,
             join=True)


def _entry(rank, fn, world, init, tmp, args):
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=init, world_size=world,
                           rank=rank, device="cpu")
    try:
        fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()


def save(tmp, name: str, rank: int, out: dict) -> None:
    np.savez(os.path.join(tmp, f"{name}_rank{rank}.npz"),
             **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in out.items()})


def load(tmp, name: str, rank: int) -> dict:
    with np.load(os.path.join(str(tmp), f"{name}_rank{rank}.npz")) as f:
        return dict(f)


# --- the scene-pair pipeline -------------------------------------------------

def port_model(tmp, config_fields: dict, load_weights: bool = True):
    from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig

    model = ShapePrior(ShapePriorConfig(**config_fields), device="cpu",
                       dtype=torch.float64)
    if load_weights:
        model.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    return model


def pipeline_child(rank, world, tmp, config_fields, cases):
    """Rank 0 loads the weights and `replicate` broadcasts them; every rank
    runs each case's pipeline through a ("dp",) mesh and saves what it
    returns."""
    from livingscenes_tpu_torch.parallel import replicate
    from livingscenes_tpu_torch.solver.pipeline import build_scene_pair_pipeline

    mesh = make_mesh(axis_names=("dp",))
    model = port_model(tmp, config_fields, load_weights=rank == 0)
    replicate(model, mesh)
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        inputs = dict(f)
    encode, rows = model.encode, []
    model.encode = lambda pc: rows.append(pc.shape[0]) or encode(pc)
    for name, cfg in cases.items():
        rows.clear()
        args = (inputs["ref"], inputs["rescan"])
        if cfg.encode_fps:
            args += (inputs["mask"], inputs["mask"])
        out = build_scene_pair_pipeline(model, cfg, mesh=mesh)(*args)
        save(tmp, f"{name}_{world}", rank, dict(out, encode_rows=np.asarray(rows)))


# --- query-sharded grids ----------------------------------------------------

def sphere(pts):
    return torch.linalg.norm(pts, dim=-1) - 0.4


def grid_child(rank, world, tmp, config_fields, ext_fields):
    """The sphere's dense grid through sharded_dense_grid_values and
    dense_grid_values(mesh=), and the first instance's canonical grid
    through a qp-sharded MeshExtractor and MoreSolver, on a ("qp",) mesh;
    then the refusals of an indivisible leading axis."""
    from livingscenes_tpu_torch.models.shape_prior import slice_codes
    from livingscenes_tpu_torch.parallel import shard_batch
    from livingscenes_tpu_torch.recon.extractor import MeshExtractor, MeshExtractorConfig
    from livingscenes_tpu_torch.recon.grid import (dense_grid_values,
                                                   hierarchical_grid_values,
                                                   sharded_dense_grid_values)
    from livingscenes_tpu_torch.solver.more import MoreSolver, MoreSolverConfig
    from livingscenes_tpu_torch.solver.pipeline import (PipelineConfig,
                                                        build_scene_pair_pipeline)

    qp = make_mesh(axis_names=("qp",))
    out = {
        "sphere_sharded": sharded_dense_grid_values(sphere, 24, qp, box_size=1.1,
                                                    device="cpu"),
        "sphere_dense_mesh": dense_grid_values(sphere, 24, 1.1, chunk_size=1000,
                                               device="cpu", mesh=qp),
        "sphere_hier_mesh": hierarchical_grid_values(
            sphere, resolution0=8, upsampling_steps=2, chunk_size=300, device="cpu",
            mesh=qp),
    }
    model = port_model(tmp, config_fields)
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        ref0 = torch.from_numpy(f["ref"][0])
    with torch.no_grad():
        one = slice_codes(model.encode(ref0), 0)
    canonical = dict(one, s=torch.ones_like(one["s"]), t=torch.zeros_like(one["t"]))
    ext_cfg = MeshExtractorConfig(**ext_fields)
    extractor = MeshExtractor(model.occupancy_logits, ext_cfg, mesh=qp)
    out["extractor_grid"] = extractor.compute_grid(canonical)[0]
    solver = MoreSolver(model, MoreSolverConfig(mesh_extractor=ext_cfg), mesh=qp)
    assert solver.mesh_extractor.mesh is qp
    out["solver_grid"] = solver.mesh_extractor.compute_grid(canonical)[0]
    dp = make_mesh(axis_names=("dp",))
    refusals = []
    for call in (lambda: shard_batch(np.zeros((world + 1, 2)), dp),
                 lambda: shard_batch({"inputs": np.zeros((world + 1, 2))}, dp),
                 lambda: build_scene_pair_pipeline(model, PipelineConfig(), mesh=dp)(
                     np.zeros((world + 1, 1, 8, 3)), np.zeros((world + 1, 1, 8, 3)))):
        try:
            call()
            refusals.append("")
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = np.asarray(refusals)
    save(tmp, f"grid_{world}", rank, out)


def size1_child(rank, world, tmp, config_fields, cfg):
    """A mesh of one rank runs unsharded: the pipeline's and a grid's
    outputs through it, beside those without a mesh."""
    from livingscenes_tpu_torch.recon.grid import hierarchical_grid_values
    from livingscenes_tpu_torch.solver.pipeline import build_scene_pair_pipeline

    mesh = make_mesh(axis_names=("dp",))
    model = port_model(tmp, config_fields)
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        ref, rescan = f["ref"][:2], f["rescan"][:2]
    out = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        res = build_scene_pair_pipeline(model, cfg, mesh=m)(ref, rescan)
        out.update({f"{tag}_{k}": v for k, v in res.items()})
        out[f"{tag}_grid"] = hierarchical_grid_values(
            sphere, resolution0=8, upsampling_steps=1, device="cpu",
            mesh=make_mesh(axis_names=("qp",)) if m is not None else None)
    save(tmp, "size1", rank, out)


# --- the data-parallel train step -------------------------------------------

def port_trainer(tmp, spec: dict, log_dir: str, mesh=None, load_weights: bool = True):
    """A Trainer of the float64 TINY SIM3Recon that `spec` describes
    ("model": ShapePriorConfig fields, "loss": TrainLossConfig fields,
    "trainer": TrainerConfig fields), with the weights of tmp/weights.pt."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig
    from livingscenes_tpu_torch.models.sim3recon import SIM3Recon, TrainLossConfig
    from livingscenes_tpu_torch.train.trainer import Trainer, TrainerConfig

    model = SIM3Recon(ShapePriorConfig(**spec["model"]), TrainLossConfig(**spec["loss"]),
                      device="cpu", dtype=torch.float64)
    if load_weights:
        model.prior.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    return Trainer(model, TrainerConfig(log_dir=log_dir, **spec["trainer"]), mesh=mesh)


def train_steps(trainer, batches) -> dict:
    """init_state, then a step on each batch: the metrics of every step, the
    validation metrics of the first batch after them, and the parameters
    after the last step."""
    state = trainer.init_state()
    out = {}
    for i, batch in enumerate(batches):
        for k, v in trainer.train_step(state, batch).items():
            out[f"step{i}_{k}"] = float(v)
    for k, v in trainer.val_step(state, batches[0]).items():
        out[f"val_{k}"] = float(v)
    out.update({f"param_{k}": v for k, v in trainer.model.prior.state_dict().items()})
    return out


def train_child(rank, world, tmp, cases):
    """Each case's steps through a ("dp",) mesh; only rank 0 holds the
    weights before init_state broadcasts them."""
    mesh = make_mesh(axis_names=("dp",))
    for name, spec in cases.items():
        with np.load(os.path.join(tmp, f"{spec['batches']}.npz")) as f:
            flat = dict(f)
        n = len({k.split("/")[0] for k in flat})
        batches = [{k.split("/")[1]: v for k, v in flat.items() if k.startswith(f"{i}/")}
                   for i in range(n)]
        trainer = port_trainer(tmp, spec, os.path.join(tmp, f"log_{name}_{world}"),
                               mesh=mesh, load_weights=rank == 0)
        save(tmp, f"train_{name}_{world}", rank, train_steps(trainer, batches))


# --- train.run under torchrun's environment ----------------------------------

def run_main(tmp, config_path, world: int, port: int, total_iter: int) -> None:
    """train.run.main in `world` processes with torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on localhost),
    on the CPU; each rank saves its final state under tmp."""
    mp.spawn(_run_main_rank, args=(tmp, config_path, world, port, total_iter),
             nprocs=world, join=True)


def _run_main_rank(rank, tmp, config_path, world, port, total_iter):
    from livingscenes_tpu_torch.train import run as prun

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        trainer, state = prun.main(["--config", config_path, "--device", "cpu",
                                    "--total-iter", str(total_iter)])
        out = {f"param_{k}": v for k, v in trainer.model.prior.state_dict().items()}
        out["step"] = state.step
        out["world"] = dist.get_world_size()
        save(tmp, "run_main", rank, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
