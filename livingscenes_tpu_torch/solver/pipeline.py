"""The scene-pair pipeline: FPS -> encode -> match -> Kabsch -> (SE(3)
refinement with `optim`) -> ICP -> (with `recon`: code transport and the
canonical-frame occupancy grid of every matched instance), and the host
meshing of those grids (`extract_scene_meshes`).

Counterpart of livingscenes_tpu/solver/pipeline.py
(`build_scene_pair_pipeline`, `extract_scene_meshes`). Scene pairs are
independent, so every instance of every scene goes through each stage in
one batch; with a mesh (parallel/sharding.py) each rank runs its share of
the scenes through the whole program and the outputs are gathered.

While the program trace records (tracing.py), a call is the span
"pipeline.call", with "pipeline.encode" (holding "pipeline.fps"),
"solver.match", "solver.register" and "pipeline.recon" inside. fps_auto,
model.encode, sequential_matcher and solve_pairwise_registration are looked
up at each call, so that a caller may wrap them.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import se3, tracing
from ..models.shape_prior import transform_codes
from ..native.bindings import get_lib
from ..ops.cuda_fps import fps_auto
from ..parallel.sharding import active_mesh, gather_batch, shard_batch
from ..recon.extractor import MeshExtractorConfig, extract_mesh_from_grid
from ..recon.grid import apply_final_merge, batched_hierarchical_grid_values
from .matcher import sequential_matcher
from .registration import RegistrationConfig, solve_pairwise_registration


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    optim: bool = False  # run the SE(3) refinement of every pair
    registration: RegistrationConfig = RegistrationConfig()
    # Inputs are padded per-instance clouds with validity masks, each
    # FPS-downsampled to the encoder's input size first.
    encode_fps: bool = False
    # The reconstruction leg: each matched rescan code is carried into the
    # ref frame and its occupancy-logit grid evaluated in its canonical
    # frame (s = 1, t = 0), coarse to fine (recon/grid.py).
    recon: bool = False
    recon_resolution0: int = 32  # configs/more_3rscan.yaml:22
    recon_upsampling_steps: int = 2  # configs/more_3rscan.yaml:23
    recon_threshold: float = 0.5
    recon_box_size: float = 1.1
    recon_cap_factor: int = 20
    recon_select_mode: str = "packsort"  # or "topk"
    recon_dedup: bool = True
    # "host": the last refine level's values travel as (grid_fidx,
    # grid_fvals) beside the unmerged "grids_premerge", and
    # extract_scene_meshes merges them; "device": the merged "grids".
    recon_final_merge: str = "host"
    # points of each instance per decoder call; with 16 instances one
    # 768-wide activation of a chunk is 16 x 4096 x 768 x 4 B = 201 MB
    recon_chunk: int = 4096
    # the grid decoder's products in bfloat16 (decode_sdf matmul_dtype)
    recon_bf16: bool = False


def build_scene_pair_pipeline(model, cfg: PipelineConfig = PipelineConfig(),
                              mesh=None, axis: str = "dp"):
    """Return `pipeline(ref_pc, rescan_pc[, ref_mask, rescan_mask]) -> dict`
    running on the model's device, with

      matches0 (S, O)          ref -> rescan instance matching, -1 unmatched
      R (S, O, 3, 3), t (S, O, 3, 1)   registration of every ref instance
        to its matched partner (unmatched rows use partner 0)

    and with `cfg.recon`:

      grids_premerge (S, O, n, n, n) + grid_fidx, grid_fvals (S, O, cap)
        with recon_final_merge "host" (apply_final_merge gives the grid),
        or grids (S, O, n, n, n) with "device": the canonical-frame
        occupancy-logit grids of the transported rescan codes,
        n = res0 * 2^steps + 1
      grid_overflow (S, O, steps)  active points the cap dropped per level
      recon_s (S, O), recon_t (S, O, 3)  the scale and translation to put
        back on each extracted mesh

    ref_pc / rescan_pc are (S, O, N, 3); with `encode_fps` the masks are
    (S, O, N) and N may exceed the encoder's input size. Inputs may be
    numpy arrays or tensors; they are moved to the model's device. Nothing
    is read back to the host.

    With `mesh` (a DeviceMesh, parallel/sharding.py) every rank passes the
    same inputs; S must be divisible by the ranks along `axis`, each rank
    runs its S/n scenes through the whole program, and every output is
    gathered on the scene axis, so that every rank returns the whole dict.
    The model's weights must be the same on every rank (replicate(model,
    mesh) once, or load one checkpoint); a mesh of size 1 runs unsharded.
    """
    mesh = active_mesh(mesh, axis)
    # with no refine level there is no final scatter to defer
    final_merge = ("device" if cfg.recon_upsampling_steps == 0
                   else cfg.recon_final_merge)

    # The refinement differentiates its loss with respect to the pose, on
    # tensors made here, which inference mode would not let it save.
    grad_mode = torch.no_grad if cfg.optim else torch.inference_mode

    @grad_mode()
    def pipeline(ref_pc, rescan_pc, ref_mask=None, rescan_mask=None):
        with tracing.span("pipeline.call", model.device):
            if mesh is None:
                return local(ref_pc, rescan_pc, ref_mask, rescan_mask)
            shards = [None if x is None else shard_batch(x, mesh, axis)
                      for x in (ref_pc, rescan_pc, ref_mask, rescan_mask)]
            return gather_batch(local(*shards), mesh, axis)

    def local(ref_pc, rescan_pc, ref_mask, rescan_mask):
        dev, dtype = model.device, model.dtype
        ref_pc = torch.as_tensor(ref_pc, device=dev, dtype=dtype)
        rescan_pc = torch.as_tensor(rescan_pc, device=dev, dtype=dtype)
        S, O, N, _ = ref_pc.shape
        flat_ref = ref_pc.reshape(S * O, N, 3)
        flat_res = rescan_pc.reshape(S * O, N, 3)
        with tracing.span("pipeline.encode"):
            if cfg.encode_fps:
                # both sides in one batch: one FPS launch over twice the clouds
                masks = [_flat_mask(m, dev, S * O, N) for m in (ref_mask, rescan_mask)]
                mask = None if all(m is None for m in masks) else torch.cat([
                    torch.ones((S * O, N), dtype=torch.bool, device=dev) if m is None
                    else m for m in masks])
                with tracing.span("pipeline.fps"):
                    sampled, _ = fps_auto(torch.cat([flat_ref, flat_res]),
                                          model.config.n_pcl, mask=mask)
                flat_ref, flat_res = sampled[:S * O], sampled[S * O:]
            codes_ref = model.encode(flat_ref)
            codes_res = model.encode(flat_res)

        matches = sequential_matcher(
            codes_ref["z_inv"].reshape(S, O, -1),
            codes_res["z_inv"].reshape(S, O, -1),
        )["matches0"]
        partner = torch.where(matches >= 0, matches, 0)
        flat_partner = (partner + torch.arange(S, device=dev)[:, None] * O).reshape(-1)
        pc2 = flat_res[flat_partner]
        c2 = {k: v[flat_partner] for k, v in codes_res.items()}
        R, t = solve_pairwise_registration(
            model, flat_ref, pc2, codes_ref, c2, optim=cfg.optim,
            cfg=cfg.registration,
        )
        out = {
            "matches0": matches,
            "R": R.reshape(S, O, 3, 3),
            "t": t.reshape(S, O, 3, 1),
        }
        if cfg.recon:
            with tracing.span("pipeline.recon"):
                out.update(_reconstruct(model, cfg, final_merge, c2, R, t, S, O))
        return out

    return pipeline


def _reconstruct(model, cfg: PipelineConfig, final_merge: str, c2, R, t,
                 S: int, O: int) -> dict:
    """The recon keys of the pipeline's output: each matched rescan code
    carried into the ref frame by the inverse of its registration, and the
    grid of its canonical code."""
    transported = transform_codes(c2, se3.inverse(se3.rt_to_se3(R, t)))
    canonical = dict(transported, s=torch.ones_like(transported["s"]),
                     t=torch.zeros_like(transported["t"]))
    thr = cfg.recon_threshold
    matmul_dtype = torch.bfloat16 if cfg.recon_bf16 else None
    res = batched_hierarchical_grid_values(
        lambda q, c: model.occupancy_logits(q, c, matmul_dtype=matmul_dtype),
        canonical,
        resolution0=cfg.recon_resolution0,
        upsampling_steps=cfg.recon_upsampling_steps,
        threshold=math.log(thr) - math.log(1.0 - thr),
        box_size=cfg.recon_box_size,
        chunk_size=cfg.recon_chunk,
        refine_cap_factor=cfg.recon_cap_factor,
        select_mode=cfg.recon_select_mode,
        dedup=cfg.recon_dedup,
        final_merge=final_merge,
    )
    grids = res[0]
    n = grids.shape[-1]
    out = {"grid_overflow": res[1].reshape(S, O, -1)}
    if final_merge == "host":
        # not "grids": the last level is still to be merged on the host
        out["grids_premerge"] = grids.reshape(S, O, n, n, n)
        out["grid_fidx"] = res[2].reshape(S, O, -1)
        out["grid_fvals"] = res[3].reshape(S, O, -1)
    else:
        out["grids"] = grids.reshape(S, O, n, n, n)
    out["recon_s"] = transported["s"].reshape(S, O)
    out["recon_t"] = transported["t"].reshape(S, O, 3)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def extract_scene_meshes(out: dict, extractor_config: Optional[MeshExtractorConfig] = None,
                         max_workers: Optional[int] = None, with_stats: bool = False):
    """Host stage: the mesh of every matched instance of a recon=True
    pipeline output, [scene][instance] -> Mesh, or None where unmatched.

    Each grid is merged (with the host merge), meshed (isosurface
    extraction and simplification, extract_mesh_from_grid) and given its
    transported code's scale and translation back. The grids are meshed
    in a thread pool: the C++ calls release the interpreter lock. A cap
    overflow is logged as a warning. With `with_stats` returns (meshes,
    stats), stats a list with a dict per matched grid: faces_raw, faces,
    iso_ms, simplify_ms, total_ms and empty.
    """
    cfg = extractor_config or MeshExtractorConfig()
    matches = _host(out["matches0"])
    grids = _host(out["grids_premerge"] if "grids_premerge" in out else out["grids"])
    s = _host(out["recon_s"])
    t = _host(out["recon_t"])
    fidx = _host(out["grid_fidx"]) if "grid_fidx" in out else None
    fvals = _host(out["grid_fvals"]) if "grid_fvals" in out else None
    S, O = matches.shape
    overflow = _host(out["grid_overflow"]) if "grid_overflow" in out else np.zeros((S, O, 0))
    if (overflow > 0).any():
        bad = int((overflow.max(axis=-1) > 0).sum())
        logging.getLogger(__name__).warning(
            "grid refine cap overflowed on %d/%d instances "
            "(max %d dropped points); meshes for those instances are "
            "degraded — raise PipelineConfig.recon_cap_factor or use "
            "recon_select_mode='topk'",
            bad, S * O, int(overflow.max()),
        )

    def one(ij):
        i, j = ij
        if matches[i, j] < 0:
            return None, None
        stats = {} if with_stats else None
        t0 = time.perf_counter()
        grid = grids[i, j]
        if fidx is not None:
            grid = apply_final_merge(grid, fidx[i, j], fvals[i, j])
        mesh = extract_mesh_from_grid(grid, cfg, stats=stats)
        if not mesh.is_empty:
            mesh.apply_scale_translation(float(s[i, j]), t[i, j].reshape(3))
        if stats is not None:
            stats["total_ms"] = (time.perf_counter() - t0) * 1e3
            stats["empty"] = mesh.is_empty
        return mesh, stats

    # built (at first use) before the pool starts, so that no grid's
    # iso_ms holds the build
    get_lib()
    jobs = [(i, j) for i in range(S) for j in range(O)]
    workers = max_workers or min(len(jobs), os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(one, jobs))
    meshes = [[results[i * O + j][0] for j in range(O)] for i in range(S)]
    if with_stats:
        return meshes, [st for _, st in results if st is not None]
    return meshes


def _flat_mask(mask, dev, B: int, N: int) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return torch.as_tensor(mask, device=dev, dtype=torch.bool).reshape(B, N)
