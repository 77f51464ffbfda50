"""Training logs: metric streams to JSONL and the console (and TensorBoard
when tensorboardX is installed; it is optional), per-sample reports to CSV.

Counterpart of livingscenes_tpu/train/logger.py without the histogram, mesh
and video loggers, which serve the visualization the port does not have
yet.
"""
from __future__ import annotations

import csv
import json
import logging
import os
import socket
import time
from typing import Dict, Optional

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
