"""The driver of relocalization traffic: closed-loop calls of the port's
scene-pair pipeline (FPS, encoder, matcher, Kabsch, ICP), one client, each
call one batch of scene pairs from a pool made on the device in set-up.

The window, the traced run and the comparison with the reference all use
the same pipeline object and the same pool.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..counts import encoder as encoder_counts
from ..counts.peaks import least_seconds
from ..reference import geometry as geo
from ..reference.relocalize import relocalize as reference_relocalize
from . import scenes, weights
from .trace import WINDOW, Stage, Trace

KEYS = ("matches0", "R", "t")
# the name of a hand-written kernel -> the (module, attribute) launch counters
# that count it, for the traced run's check that the profiler saw every launch
COUNTED = {
    "fps_kernel": [("livingscenes_tpu_torch.ops.cuda_fps", "launches")],
    "knn_kernel": [("livingscenes_tpu_torch.ops.cuda_knn", "launches")],
    "icp_stats_kernel": [("livingscenes_tpu_torch.ops.cuda_icp", "launches")],
    "pair_scan_kernel": [("livingscenes_tpu_torch.ops.cuda_knn", "topk_launches"),
                         ("livingscenes_tpu_torch.ops.cuda_scale", "launches")],
    "layer0_kernel": [("livingscenes_tpu_torch.nn.cuda_layer0", "launches")],
    "mean_edges_kernel": [("livingscenes_tpu_torch.nn.cuda_attention", "mean_launches")],
    "attention_edges_kernel": [("livingscenes_tpu_torch.nn.cuda_attention",
                                "attention_launches")],
}


def model_config(config: dict):
    """The program's ShapePriorConfig from the configuration file's keys
    that name its fields."""
    from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig

    names = {f.name for f in dataclasses.fields(ShapePriorConfig)}
    return ShapePriorConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in config.items() if k in names})


def make_weights(config: dict, shapes: dict, root, seed: int, device) -> dict:
    spec = config["weights"]
    if spec == "seeded":
        return weights.seeded(shapes, (seed + 1) % 2 ** 63, device)
    return weights.read_checkpoint(str(root / spec), device)


def counters() -> dict:
    import importlib

    return {kernel: sum(getattr(importlib.import_module(m), a) for m, a in pairs)
            for kernel, pairs in COUNTED.items()}


class Cell:
    """Set-up: the model with its weights, the pipeline, the pool of
    batches, and the warm-up calls."""

    def __init__(self, ctx):
        from livingscenes_tpu_torch.models.shape_prior import ShapePrior
        from livingscenes_tpu_torch.solver.pipeline import (
            PipelineConfig, build_scene_pair_pipeline)

        self.ctx, self.mix, self.config = ctx, ctx.traffic, ctx.config
        dev = ctx.device
        self.model = ShapePrior(model_config(self.config), device=dev)
        shapes = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        self.weights = make_weights(self.config, shapes, ctx.root, ctx.seed, dev)
        self.model.load_state_dict(self.weights)
        self.weight_bytes = float(sum(v.numel() * 4 for k, v in self.weights.items()
                                      if k.startswith("encoder.")))
        self.pipe = build_scene_pair_pipeline(
            self.model, PipelineConfig(**self.mix.get("pipeline", {})))
        real_encode = self.model.encode

        def encode(pc):
            codes = real_encode(pc)
            self._codes.append(codes)
            return codes

        self.model.encode = encode
        self._codes = []
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.pool = [scenes.scene_pairs(gen, self.mix, dev) for _ in range(self.mix["pool"])]
        self.outs = []  # (pool index, answers on the host, codes) of every call
        for i in range(self.mix["warmup_calls"]):
            self.call(i)
        self.outs.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def call(self, i: int):
        """One call on batch i of the pool: the answers come back to the
        host, as a caller reads them."""
        b = i % len(self.pool)
        self._codes = []
        out = self.pipe(*self.pool[b])
        answers = {k: out[k].cpu() for k in KEYS}
        self.outs.append((b, answers, self._codes))

    @property
    def pairs_per_call(self) -> int:
        """Scene pairs a call relocalizes."""
        return self.mix["scene_pairs"]

    def window(self, seconds: float) -> dict:
        """Calls until the first that ends after `seconds`; every call
        counts. Returns the end-to-end values."""
        lat = []
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.call(len(lat))
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if t1 - start >= seconds:
                break
        window_s = t1 - start
        self.attempted = self.pairs_per_call * len(lat)
        ms = np.array(lat) * 1e3
        return {"pairs_per_s": self.attempted / window_s,
                "call_p90_ms": float(np.percentile(ms, 90)),
                "window_s": window_s, "calls": len(lat), "call_min_ms": float(ms.min()),
                "call_p50_ms": float(np.median(ms))}

    def traced(self):
        """`trace_calls` calls under torch.profiler with the stages
        'encode' (front end and encoder) and 'register' (matcher, Kabsch,
        ICP and its acceptance); the context the per-layer readers get."""
        from livingscenes_tpu_torch.solver import pipeline as mod

        enc, reg = Stage("encode"), Stage("register")
        saved = mod.fps_auto, mod.sequential_matcher, mod.solve_pairwise_registration

        def fps_hook(*a, **k):
            enc.enter()
            return saved[0](*a, **k)

        def match_hook(*a, **k):
            enc.exit()
            reg.enter()
            return saved[1](*a, **k)

        def register_hook(*a, **k):
            out = saved[2](*a, **k)
            reg.exit()
            return out

        calls = self.mix["trace_calls"]
        before = counters()
        mod.fps_auto, mod.sequential_matcher, mod.solve_pairwise_registration = (
            fps_hook, match_hook, register_hook)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        try:
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW):
                    for i in range(calls):
                        self.call(i)
                    torch.cuda.synchronize()
        finally:
            mod.fps_auto, mod.sequential_matcher, mod.solve_pairwise_registration = saved
        launched = {k: v - before[k] for k, v in counters().items()}
        tr = Trace(prof, calls)
        seen = {k: tr.count_kernels(k) for k in launched}
        if seen != launched:
            raise RuntimeError(f"the profiler's kernel counts {seen} differ from the "
                               f"launch counters {launched}: its split is not trusted")
        self.attempted = self.pairs_per_call * calls
        clouds = 2 * self.mix["scene_pairs"] * self.mix["objects"]
        flops, nbytes = encoder_counts.encode_stage(
            self.config, clouds, self.mix["points"], self.weight_bytes)
        return SimpleNamespace(trace=tr, calls=calls, encode_flops=flops,
                               encode_bytes=nbytes,
                               encode_least_s=least_seconds(flops, nbytes))

    def release_program(self):
        """Free the program's state before the reference runs."""
        self.pipe = self.model = None
        self._codes = []
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The calls to compare: `check_calls` of the window's, drawn from
        the seed, each on another batch of the pool."""
        gen = torch.Generator().manual_seed(self.ctx.seed)
        picks = {}
        for i in torch.randperm(len(self.outs), generator=gen).tolist():
            picks.setdefault(self.outs[i][0], self.outs[i])
        return list(picks.values())[:self.mix["check_calls"]]

    def reference(self, b: int, tf32: bool = False, dtype=torch.float32) -> dict:
        """The reference's answers for pool batch b, in float32 (with tf32,
        its products on the tensor cores in TF32: the control; with dtype
        float64, a witness of what float32 itself loses)."""
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        w = {k: v.to(dtype) for k, v in self.weights.items()}
        ref, res, ref_mask, res_mask = self.pool[b]
        try:
            return reference_relocalize(w, self.config, ref.to(dtype), res.to(dtype),
                                        ref_mask, res_mask, block=self.mix["reference_block"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def check(self) -> dict:
        """The numbers compared, over the sampled calls, against the
        reference in float64."""
        self.release_program()
        return compare([(program_view(a, c), self.reference(b, dtype=torch.float64))
                        for b, a, c in self.sample()])

    def control(self) -> dict:
        """The same numbers with the reference in float32 with TF32 on (its
        products on the tensor cores) in the program's place."""
        self.release_program()
        return compare([(self.reference(b, tf32=True), self.reference(b, dtype=torch.float64))
                        for b, _, _ in self.sample()])


def program_view(answers: dict, codes: list) -> dict:
    """The program's answers and the codes its two encodes returned."""
    return dict(answers, codes_ref=codes[0], codes_res=codes[1])


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / |b| per row, over all but the first axis, in float64."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return torch.linalg.norm(a - b, dim=1) / torch.linalg.norm(b, dim=1).clamp_min(1e-30)


def compare(pairs) -> dict:
    """Numbers of (candidate, reference) answer pairs, each judged by what
    it says rather than by agreement with one reference answer where the
    task has near-equal answers:

    code_gap_p50   the median over clouds of the larger relative gap of
                   z_inv and z_so3 to the reference's codes (a near-tie in
                   a kNN graph moves some clouds' codes by 1e-2; the
                   median is the typical cloud's)
    match_slack    how far the candidate's matching is from a greedy one
                   under the reference's cosine similarities: taking its
                   pairs in the greedy order, the largest gap, over the
                   steps and scenes, between the best pair still open and
                   the best of its pairs still open (0 for the reference's
                   own matching; a near-tie taken the other way costs about
                   its margin, and so do the choices that follow it)
    pose_step      the largest drop of the symmetric chamfer distance,
                   over pairs, that one step of the reference's ICP makes
                   from the candidate's pose on the candidate's partner:
                   small at a pose ICP has converged to, large for a pose
                   that is no registration
    pose_gap_p50   the median over pairs matched alike of the candidate's
                   chamfer distance above that of the reference's pose
    and, not compared: match_gap (the largest shortfall, over ref
    instances, of the similarity of the candidate's partner below that of
    the reference's: one near-tie taken otherwise can cost a later
    instance a whole other partner), match_diff (instances matched
    otherwise) and pose_gap (the largest chamfer excess: another ICP basin
    reached from a code moved by a near-tie reads up to some 0.07).
    Distances are in the clouds' units, in float64, on the reference's
    sampled clouds.
    """
    gaps, short, slack, step, excess, diff = [], [], [], [], [], 0
    for got, want in pairs:
        dev = want["R"].device
        for side in ("codes_ref", "codes_res"):
            g, w = got[side], want[side]
            gaps.append(torch.maximum(_rel_gap(g["z_inv"].to(dev), w["z_inv"]),
                                      _rel_gap(g["z_so3"].to(dev), w["z_so3"])))
        m_got, m_want = got["matches0"].to(dev).long(), want["matches0"]
        S, O = m_want.shape
        diff += int((m_got != m_want).sum())
        z_ref = want["codes_ref"]["z_inv"].double().reshape(S, O, -1)
        z_res = want["codes_res"]["z_inv"].double().reshape(S, O, -1)
        score = geo.normalize_rows(z_ref) @ geo.normalize_rows(z_res).transpose(-1, -2)
        pick = lambda m: torch.gather(score, 2, m.clamp_min(0)[..., None])[..., 0]  # noqa: E731
        short.append((pick(m_want) - pick(m_got)).reshape(-1))
        slack.append(greedy_slack(score, m_got))
        base = O * torch.arange(S, device=dev)[:, None]
        src = want["ref_pc"].double()
        R_g = got["R"].to(dev).double().reshape(-1, 3, 3)
        t_g = got["t"].to(dev).double().reshape(-1, 3, 1)
        tgt_g = want["res_pc"].double()[(m_got.clamp_min(0) + base).reshape(-1)]
        at = geo.chamfer(geo.move(R_g, t_g, src), tgt_g)
        R_i, t_i = geo.icp(src, tgt_g, R_g, t_g, 1)
        step.append(at - geo.chamfer(geo.move(R_i, t_i, src), tgt_g))
        same = (m_got == m_want).reshape(-1)
        R_w = want["R"].double().reshape(-1, 3, 3)[same]
        t_w = want["t"].double().reshape(-1, 3, 1)[same]
        excess.append(at[same] - geo.chamfer(geo.move(R_w, t_w, src[same]), tgt_g[same]))
    gaps, short, slack, step, excess = (torch.cat(x) for x in (gaps, short, slack, step, excess))
    inf = math.inf
    return {"code_gap_p50": float(gaps.median()),
            "match_slack": float(slack.max()),
            "pose_step": float(step.max()),
            "pose_gap_p50": float(excess.median()) if len(excess) else inf,
            "match_gap": float(short.max()),
            "match_diff": float(diff),
            "pose_gap": float(excess.max()) if len(excess) else inf}


def greedy_slack(score: torch.Tensor, matches: torch.Tensor) -> torch.Tensor:
    """Per scene (S,): how far `matches` (S, O) is from a greedy matching
    of `score` (S, O, T). Its pairs are taken best first among those whose
    row and column are both still open; at each step the gap between the
    best open entry of `score` and that pair's is recorded, and the largest
    gap is returned (inf where a row is unmatched or two rows share a
    column)."""
    S, O, T = score.shape
    rows = torch.ones(S, O, dtype=torch.bool, device=score.device)
    cols = torch.ones(S, T, dtype=torch.bool, device=score.device)
    scenes = torch.arange(S, device=score.device)
    partner = matches.clamp_min(0)
    own = torch.where(matches >= 0, torch.gather(score, 2, partner[..., None])[..., 0],
                      -math.inf)
    slack = torch.zeros(S, dtype=score.dtype, device=score.device)
    for _ in range(min(O, T)):
        open_ = torch.where(rows[:, :, None] & cols[:, None, :], score, -math.inf)
        best = open_.flatten(1).amax(-1)
        mine = torch.where(rows & torch.gather(cols, 1, partner), own, -math.inf)
        take = mine.argmax(-1)
        slack = torch.maximum(slack, best - mine.amax(-1))
        rows[scenes, take] = False
        cols[scenes, partner[scenes, take]] = False
    return slack
