"""The 3RScan benchmark: scene loader, padded instance batches, and the
matching, relocalization and reconstruction loops.

Counterpart of livingscenes_tpu/eval/rescan3r.py. A scan is an aligned
instance PLY, a semseg json, per-point instance labels (.npz) and its entry
in 3RScan.json; instances of variable size are padded into one batch with
validity masks, and each loop runs a scan's instances through the solver
in one call, on the solver's device.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import se3
from ..ops.cuda_fps import fps_auto
from ..recon.mesh import Mesh
from ..solver.more import MoreSolver
from ..utils.io import load_json, load_ply, read_list_from_txt
from .metrics import compute_chamfer_distance, compute_sdf_recall

log = logging.getLogger(__name__)

# RIO label -> ShapeNet training category
SHAPENET_CATE = ["chair", "table", "bench", "sofa", "pillow", "bed", "trash_bin"]
RIO_CATE = [
    ["dinning chair", "rocking chair", "armchair", "chair"],
    ["couching table", "dining table", "computer desk", "round table",
     "side table", "stand", "desk", "coffee table"],
    ["bench"],
    ["sofa", "sofa chair", "couch", "ottoman", "footstool"],
    ["cushion", "pillow"],
    ["bed"],
    ["trash can"],
]
_RIO_TO_SHAPENET = {
    rio: cate for cate, rios in zip(SHAPENET_CATE, RIO_CATE) for rio in rios
}


def get_shapenet_category(rio_label: str) -> str:
    return _RIO_TO_SHAPENET.get(rio_label, "others")


def heterogeneous_batching(pc_list: List[np.ndarray], point_bucket: int = 1,
                           batch_bucket: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pad clouds (Ni, 3) into (B', Nmax', 3) float32 with a (B', Nmax')
    bool mask; Nmax and B are rounded up to multiples of the buckets, so
    that a dataset gives few distinct shapes. Padded rows are all False."""
    max_n = max(len(pc) for pc in pc_list)
    max_n = -(-max_n // point_bucket) * point_bucket
    B = -(-len(pc_list) // batch_bucket) * batch_bucket
    out = np.zeros((B, max_n, 3), np.float32)
    mask = np.zeros((B, max_n), bool)
    for i, pc in enumerate(pc_list):
        out[i, : len(pc)] = pc
        mask[i, : len(pc)] = True
    return out, mask


@dataclasses.dataclass
class ScanInstances:
    pc: np.ndarray  # (B', Nmax', 3), bucket-padded; see heterogeneous_batching
    pc_mask: np.ndarray  # (B', Nmax')
    object_id: np.ndarray  # (n_valid,)
    full_object_id: np.ndarray  # ids including the instances too small to use
    id_label: List[Tuple[int, str, str]]
    moving_ids: Optional[np.ndarray] = None
    static_ids: Optional[np.ndarray] = None
    rescan2ref_tsfm: Optional[np.ndarray] = None

    @property
    def n_valid(self) -> int:
        return len(self.object_id)

    @property
    def row_mask(self) -> np.ndarray:
        m = np.zeros(self.pc.shape[0], bool)
        m[: self.n_valid] = True
        return m


def _json_transform(values) -> np.ndarray:
    """A 3RScan.json transform: row-major, for row vectors; returned as a
    4 x 4 matrix for column vectors."""
    return np.asarray(values, np.float64).reshape(4, 4).T


class Dataset3RScan:
    """Reference scans and their rescans from root/<split>_set/<scan id>/."""

    def __init__(self, root_path: str, split: str = "val",
                 category_list: Optional[List[str]] = None,
                 n_point_per_instance: int = 1024, use_gt_mask: bool = True,
                 mask_name: Optional[str] = None, min_points: int = 1024,
                 point_bucket: int = 4096, batch_bucket: int = 4):
        self.root = root_path
        self.split = split
        self.data_path = osp.join(root_path, f"{split}_set")
        self.categories = set(category_list or list(_RIO_TO_SHAPENET))
        self.n_point_per_instance = n_point_per_instance
        self.use_gt_mask = use_gt_mask
        self.mask_name = mask_name
        self.min_points = min_points
        self.point_bucket = point_bucket
        self.batch_bucket = batch_bucket

        split_file = osp.join(root_path, "..", f"splits/{split}.txt")
        if osp.exists(split_file):
            split_ids = set(read_list_from_txt(split_file))
        else:
            split_ids = set(os.listdir(self.data_path))
        scene_json = load_json(osp.join(root_path, "3RScan.json"))
        self.scene_list = [s for s in scene_json if s["reference"] in split_ids]

    def __len__(self):
        return len(self.scene_list)

    def _load_scan(self, scan_id: str) -> Optional[ScanInstances]:
        scan_path = osp.join(self.data_path, scan_id)
        semseg = load_json(osp.join(scan_path, "semseg.v2.json"))["segGroups"]
        verts, _ = load_ply(osp.join(scan_path, "pointcloud.instances.align.ply"))
        label_file = "pointcloud.labels.npz" if self.use_gt_mask else self.mask_name
        labels = np.load(osp.join(scan_path, label_file), allow_pickle=True)
        obj_ids_per_point = labels["objectId"]

        pc_list, id_list, label_list, full_ids = [], [], [], []
        for inst in semseg:
            if inst["label"] not in self.categories:
                continue
            oid = int(inst["objectId"])
            full_ids.append(oid)
            pts = verts[obj_ids_per_point == oid]
            if len(pts) == 0 or len(pts) < self.min_points:
                continue
            pc_list.append(pts)
            id_list.append(oid)
            label_list.append((oid, inst["label"], get_shapenet_category(inst["label"])))
        if not pc_list:
            return None
        pc, mask = heterogeneous_batching(pc_list, self.point_bucket, self.batch_bucket)
        return ScanInstances(pc=pc, pc_mask=mask, object_id=np.asarray(id_list),
                             full_object_id=np.asarray(full_ids), id_label=label_list)

    def get_scene(self, idx: int):
        """(reference, [(rescan, its scene-graph entry)]); each rescan
        carries its moving and static instance ids and its transform to the
        reference."""
        scene = self.scene_list[idx]
        reference = self._load_scan(scene["reference"])
        rescans = []
        for scan in scene.get("scans", []):
            rescan = self._load_scan(scan["reference"])
            if rescan is None:
                continue
            scene_tsfm = _json_transform(scan["transform"])
            moving, static = [], []
            for rigid in scan.get("rigid", []):
                obj_inv = se3.inverse(torch.as_tensor(_json_transform(rigid["transform"])))
                rot_diff = float(se3.rotation_error(
                    obj_inv[None, :3, :3], torch.as_tensor(scene_tsfm[None, :3, :3]))[0])
                t_diff = float(np.linalg.norm(obj_inv[:3, 3].numpy() - scene_tsfm[:3, 3]))
                if rot_diff > 1 or t_diff > 0.05:
                    moving.append(rigid["instance_reference"])
                else:
                    static.append(rigid["instance_reference"])
            rescan.moving_ids = np.asarray(moving)
            rescan.static_ids = np.asarray(static)
            rescan.rescan2ref_tsfm = scene_tsfm
            rescans.append((rescan, scan))
        return reference, rescans


def disambiguate(pred: np.ndarray, gt: np.ndarray, ambiguity: list) -> np.ndarray:
    """Accept a prediction that the benchmark's ambiguity chains connect to
    the true id."""
    pairs = []
    for group in ambiguity:
        pairs += [(p["instance_source"], p["instance_target"]) for p in group]
    out = pred.copy()
    for i in range(len(gt)):
        chain = [tgt for src, tgt in pairs if src == out[i]]
        it = 0
        while chain and it < 200:
            nxt = next((t for s, t in pairs if s == chain[-1]), None)
            if nxt is None or nxt == out[i]:
                break
            chain.append(nxt)
            it += 1
        if gt[i] in chain:
            out[i] = gt[i]
    return out


# ---------------------------------------------------------------------------
# Evaluation loops
# ---------------------------------------------------------------------------

def eval_matching(dataset: Dataset3RScan, solver: MoreSolver,
                  method: str = "sequential") -> Dict[str, float]:
    """Object, static and dynamic matching recall, and scene recall at 25,
    50 and 75 % of a scene's instances matched."""
    n_total = n_correct = scene_total = 0
    scene_count = np.zeros(3)
    n_tot_dyn = n_cor_dyn = n_tot_sta = n_cor_sta = 0

    for i_s in range(len(dataset)):
        ref, rescans = dataset.get_scene(i_s)
        scene = dataset.scene_list[i_s]
        if ref is None or not rescans:
            continue
        ref_codes = solver.encode_instances(ref.pc, ref.pc_mask)
        for rescan, _ in rescans:
            rescan_codes = solver.encode_instances(rescan.pc, rescan.pc_mask)
            matches = solver.solve_object_matching(
                ref_codes, rescan_codes, method, src_mask=ref.row_mask,
                tgt_mask=rescan.row_mask)
            m0 = matches["matches0"].cpu().numpy()[: ref.n_valid]
            m0 = np.where(m0 < rescan.n_valid, m0, -1)
            matched_ids = rescan.object_id[np.where(m0 >= 0, m0, 0)]
            matched_ids = np.where(m0 >= 0, matched_ids, -1)

            valid = np.isin(ref.object_id, rescan.object_id)
            if scene.get("ambiguity"):
                matched_ids = disambiguate(matched_ids, ref.object_id, scene["ambiguity"])
                matched_ids[m0 < 0] = -1

            correct = matched_ids == ref.object_id
            n_match = int(valid.sum())
            if n_match == 0:
                continue
            n_correct += int(correct[valid].sum())
            n_total += n_match

            scene_total += 1
            ratio = correct[valid].sum() / n_match
            if ratio >= 0.75:
                scene_count[:] += 1
            elif ratio >= 0.5:
                scene_count[1:] += 1
            elif ratio >= 0.25:
                scene_count[2:] += 1

            moving = np.isin(ref.object_id, rescan.moving_ids)
            static = ~moving
            n_tot_dyn += int((valid & moving).sum())
            n_tot_sta += int((valid & static).sum())
            n_cor_dyn += int(correct[valid & moving].sum())
            n_cor_sta += int(correct[valid & static].sum())

    result = {
        "object_recall": 100.0 * n_correct / max(n_total, 1),
        "static_recall": 100.0 * n_cor_sta / max(n_tot_sta, 1),
        "dynamic_recall": 100.0 * n_cor_dyn / max(n_tot_dyn, 1),
        "scene_recall@75": 100.0 * scene_count[0] / max(scene_total, 1),
        "scene_recall@50": 100.0 * scene_count[1] / max(scene_total, 1),
        "scene_recall@25": 100.0 * scene_count[2] / max(scene_total, 1),
    }
    log.info("3RScan matching: %s", result)
    return result


def eval_relocalization(dataset: Dataset3RScan, solver: MoreSolver,
                        optim: bool = True) -> Dict[str, float]:
    """Instance relocalization errors: the rigid pairs of a scan pair are
    FPS-sampled to the encoder's input size and registered in one call."""
    rre_list, rte_list, tsfm_err_list, cd_lst = [], [], [], []
    k = solver.cfg.n_input_point
    for i_s in range(len(dataset)):
        ref, rescans = dataset.get_scene(i_s)
        if ref is None:
            continue
        for rescan, sg in rescans:
            # the rescan in its own frame, before the scene alignment
            inv = se3.inverse(torch.as_tensor(rescan.rescan2ref_tsfm[None]))[0].numpy()
            pc_t = rescan.pc @ inv[:3, :3].T + inv[:3, 3]

            pairs = []  # (ref points, rescan points, gt 4 x 4, symmetry)
            for rigid in sg.get("rigid", []):
                if (rigid["instance_reference"] not in ref.object_id
                        or rigid["instance_rescan"] not in rescan.object_id):
                    continue
                ri = int(np.where(ref.object_id == rigid["instance_reference"])[0][0])
                si = int(np.where(rescan.object_id == rigid["instance_rescan"])[0][0])
                pairs.append((ref.pc[ri][ref.pc_mask[ri]], pc_t[si][rescan.pc_mask[si]],
                              _json_transform(rigid["transform"]),
                              rigid.get("symmetry", 0)))
            if not pairs:
                continue

            # no padded rows: a row with no valid point has no registration
            pc1_pad, m1 = heterogeneous_batching([p[0] for p in pairs],
                                                 dataset.point_bucket)
            pc2_pad, m2 = heterogeneous_batching([p[1] for p in pairs],
                                                 dataset.point_bucket)
            pc1s = fps_auto(solver._points(pc1_pad), k, mask=solver._mask(m1))[0]
            pc2s = fps_auto(solver._points(pc2_pad), k, mask=solver._mask(m2))[0]
            R, t = solver.solve_pairwise_registration(pc1s, pc2s, optim=optim)
            gt_all = torch.as_tensor(np.stack([p[2] for p in pairs]).astype(np.float32))
            gt_all = gt_all.to(R.device, R.dtype)
            P = len(pairs)
            rre_all = se3.rotation_error(R, gt_all[:, :3, :3]).cpu().numpy()
            t_np = t.cpu().numpy()
            pred_all = se3.rt_to_se3(R, t)
            tsfm_err, cd = [], []
            for i in range(P):
                one = slice(i, i + 1)
                tsfm_err.append(se3.compute_transformation_error(
                    pc1s[one], pc2s[one], pred_all[one], gt_all[one]))
                cd.append(se3.chamfer_distance_under_transforms(
                    pc1s[one, ::10], pc2s[one, ::10], pred_all[one], gt_all[one])[0])
            tsfm_err = torch.stack(tsfm_err).cpu().numpy()
            cd = torch.stack(cd).cpu().numpy()
            for i, (_, _, gt, sym) in enumerate(pairs):
                rre = float(rre_all[i])
                if sym == 1:
                    rre = min(rre, abs(180 - rre))
                elif sym == 2:
                    rre = min(rre, abs(180 - rre), abs(90 - rre))
                rre_list.append(rre)
                rte_list.append(float(np.linalg.norm(t_np[i, :, 0] - gt[:3, 3])))
                tsfm_err_list.append(float(tsfm_err[i]))
                cd_lst.append(float(cd[i]))

    rre_a, rte_a = np.asarray(rre_list), np.asarray(rte_list)
    tsfm_a, cd_a = np.asarray(tsfm_err_list), np.asarray(cd_lst)
    selT, sel10 = tsfm_a < 0.2, rre_a < 10
    result = {
        "recall_T0.1": float((tsfm_a < 0.1).mean() * 100) if len(tsfm_a) else None,
        "median_rre_T": float(np.median(rre_a[selT])) if selT.any() else None,
        "median_rte_T": float(np.median(rte_a[selT])) if selT.any() else None,
        "recall_rre10": float(sel10.mean() * 100) if len(rre_a) else None,
        "median_rre": float(np.median(rre_a[sel10])) if sel10.any() else None,
        "median_rte": float(np.median(rte_a[sel10])) if sel10.any() else None,
        "median_chamfer": float(np.median(cd_a)) if len(cd_a) else None,
    }
    log.info("3RScan relocalization: %s", result)
    return result


def eval_reconstruction(dataset: Dataset3RScan, solver: MoreSolver,
                        recon_gt_dir: Optional[str] = None) -> Dict[str, float]:
    """Instance reconstruction: encode, optimise the codes against the
    observed points, mesh, and score against per-instance ground-truth
    meshes (recon_gt_dir/<scan id>/objectId_<id>.ply) where there are
    any."""
    cd_lst, sdf_recall_lst = [], []
    for i_s in range(len(dataset)):
        scene = dataset.scene_list[i_s]
        ref, _ = dataset.get_scene(i_s)
        if ref is None:
            continue
        pc_all, mask_all = solver._points(ref.pc), solver._mask(ref.pc_mask)
        for i in range(len(ref.object_id)):
            gt_mesh = None
            if recon_gt_dir:
                gp = osp.join(recon_gt_dir, scene["reference"],
                              f"objectId_{ref.object_id[i]}.ply")
                if osp.exists(gp):
                    v, f = load_ply(gp)
                    gt_mesh = Mesh(v, f if f is not None else np.zeros((0, 3), np.int64))
            pc, mask = pc_all[i:i + 1], mask_all[i:i + 1]
            codes = solver.encode_instances(pc, mask)
            codes = solver.optimize_code(codes, pc, mask)
            mesh = solver.mesh_from_latent(codes)
            if mesh.is_empty:
                sdf_recall_lst.append(0.0)
                continue
            if gt_mesh is not None and not gt_mesh.is_empty:
                cd1, _ = compute_chamfer_distance(gt_mesh.sample_surface(30000), mesh)
                cd_lst.append(cd1)
                sdf_recall_lst.append(compute_sdf_recall(mesh, gt_mesh, 0.05))
    result = {
        "chamfer_1way_mean": float(np.mean(cd_lst)) if cd_lst else None,
        "sdf_recall": float((np.asarray(sdf_recall_lst) > 0.7).mean() * 100)
        if sdf_recall_lst else None,
    }
    log.info("3RScan reconstruction: %s", result)
    return result
