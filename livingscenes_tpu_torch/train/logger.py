"""Training logs: metric streams to JSONL and the console (and TensorBoard
when tensorboardX is installed; it is optional), histogram summaries,
per-sample reports to CSV, meshes to OBJ files and frame sequences to
animated GIFs (with PIL, when it is installed).

Counterpart of livingscenes_tpu/train/logger.py.
"""
from __future__ import annotations

import csv
import json
import logging
import os
import socket
import time
from typing import Dict, Optional

import numpy as np

log = logging.getLogger("livingscenes_tpu_torch")


def configure_logging(log_dir: Optional[str] = None, level=logging.INFO):
    """Hostname-tagged stream logging, and a train.log file in log_dir."""
    fmt = logging.Formatter(
        f"%(asctime)s|{socket.gethostname()}|%(levelname)s| %(message)s"
    )
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
        fh.setFormatter(fmt)
        root.addHandler(fh)


class TrainLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._metrics_path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        try:  # optional dependency
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def log_metrics(self, phase: str, step: int, metrics: Dict[str, float]):
        rec = {"phase": phase, "step": step, "time": time.time(), **metrics}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{phase}/{k}", v, step)
        parts = " ".join(
            f"{k}={v:.5g}" for k, v in metrics.items() if isinstance(v, float)
        )
        log.info("[%s %d] %s", phase, step, parts)

    def log_histogram(self, phase: str, step: int, name: str, values):
        """A percentile summary (0, 5, 25, 50, 75, 95, 100) and the mean of
        `values` as a JSONL record (and the histogram to TensorBoard)."""
        v = np.asarray(values).ravel()
        if v.size == 0:
            return
        qs = np.percentile(v, [0, 5, 25, 50, 75, 95, 100]).tolist()
        rec = {"phase": phase, "step": step, "hist": name, "time": time.time(),
               "mean": float(v.mean()),
               **{f"p{p}": q for p, q in zip((0, 5, 25, 50, 75, 95, 100), qs)}}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_histogram(f"{phase}/{name}", v, step)

    def log_mesh(self, name: str, step: int, mesh):
        """<log_dir>/meshes/<name>_<step>.obj"""
        d = os.path.join(self.log_dir, "meshes")
        os.makedirs(d, exist_ok=True)
        mesh.export_obj(os.path.join(d, f"{name}_{step}.obj"))

    def log_video(self, name: str, step: int, frames, fps: int = 10):
        """An animated GIF <log_dir>/videos/<name>_<step>.gif of frames
        (T, H, W, 3) or channel-first (T, C, H, W), C 1 or 3, uint8 or
        floats in [0, 1]; also to TensorBoard. Returns the path, or None
        without PIL (the GIF encoder), after a warning."""
        v = np.asarray(frames)
        if v.ndim != 4:
            raise ValueError(f"expected (T,H,W,3) or (T,C,H,W), got {v.shape}")
        if v.shape[1] in (1, 3) and v.shape[-1] not in (1, 3):
            v = v.transpose(0, 2, 3, 1)  # channel-first -> channel-last
        if v.shape[-1] == 1:
            v = np.repeat(v, 3, axis=-1)
        if v.dtype != np.uint8:
            v = (np.clip(v, 0.0, 1.0) * 255).astype(np.uint8)
        try:
            from PIL import Image
        except ImportError:
            log.warning("PIL is not installed: video %s not written", name)
            return None
        d = os.path.join(self.log_dir, "videos")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}_{step}.gif")
        imgs = [Image.fromarray(fr) for fr in v]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=max(int(1000 / fps), 1), loop=0)
        if self._tb is not None:
            self._tb.add_video(name, v.transpose(0, 3, 1, 2)[None], step, fps=fps)
        return path

    def log_report(self, name: str, step: int, rows, mean_row=None):
        """Per-sample CSV report with a mean row first."""
        if not rows:
            return
        path = os.path.join(self.log_dir, f"{name}_{step}.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            if mean_row is not None:
                w.writerow(mean_row)
            for r in rows:
                w.writerow(r)
