"""The least f32 operations and bytes of the relocalization's front end
and encoder, counted from shapes.

Each count is what the mathematics needs, whatever implements it: a
product that is linear in gathered rows is counted once per point, not
once per edge; a distance of two points in D dimensions is 2 D + 2
operations (a dot product and the two squared norms' sum); each FPS round
is 9 operations a point (a squared distance and a running minimum). The
fused edge layers' counts are those the port's smoke test has held its
kernels to since the kernels' redesign (chip_smoke.py edge_work). Bytes
count the stage's inputs (the padded clouds and their masks, the weights)
read once and its codes written once.
"""
from __future__ import annotations

# The so3 activation of one (edge, channel): y and its direction from the
# two halves (3 + 3 adds), y.d and d.d (5 + 5), the rsqrt and the unit
# direction (4), the leaky slope (2), y + dir * (acted - y.dir) (7).
ACT = 29
MEAN_EDGE_CHANNEL = ACT + 3  # and the sum over K
# attention runs it for K and V, then |k|^2, two clamped divisions, q.k,
# the head's sum, a share of the softmax, V's weighting
ATTN_EDGE_CHANNEL = 2 * ACT + 16 + 6
# layer 0 per edge: the unit dst, the cross product, nn - dst; per channel
# the pre-activation and its direction as (O, 3) times the three vectors
# (15 each), the rest of the activation, the sum over K
L0_EDGE = 24
L0_EDGE_CHANNEL = 2 * 15 + (ACT - 6) + 3
FPS_ROUND = 9
NORMALIZE_CHANNEL = 10  # a channel-equivariant normalisation, per channel


def fps(clouds: int, n: int, k: int) -> float:
    return float(clouds) * (k - 1) * n * FPS_ROUND


def knn(clouds: int, nq: int, np_: int, d: int) -> float:
    return float(clouds) * nq * np_ * (2 * d + 2)


def lna(points: float, c: int, o: int, shared: bool = False) -> float:
    """A VecLNA from c to o channels at `points` points: W, the direction
    map D (one row when shared), the activation."""
    return points * (6.0 * c * o + 6.0 * o * (1 if shared else o) + ACT * o)


def edge_layer(kind: str, B: int, ns: int, nd: int, c: int, o: int, k: int) -> float:
    """A fused edge layer: "layer0", "mean" or "attention" (K and V)."""
    edges = float(B) * nd * k
    if kind == "layer0":
        return 2.0 * o * o * 3 + edges * (L0_EDGE + o * L0_EDGE_CHANNEL)
    w_d = 6.0 * c * o + 6.0 * o * o  # W y, then D (W y)
    stacked = 12.0 * c * o  # y [W | D W], after D W once a call
    products = sum(min(B * n * w_d, B * n * stacked + 2.0 * c * o * o) for n in (ns, nd))
    if kind == "mean":
        return products + edges * o * MEAN_EDGE_CHANNEL
    return 2.0 * products + edges * o * ATTN_EDGE_CHANNEL


def global_conv(B: int, n: int, o: int) -> float:
    """VecLNA(2 o -> o) on [f, mean f]: the mean's half once a cloud."""
    return (B * n * (6.0 * o * o + 6.0 * o * o + ACT * o + 3 * o)
            + B * 6.0 * o * o)


def attention_encoder(cfg: dict, B: int) -> float:
    n, k = cfg["n_pcl"], cfg["num_knn"]
    down = dict(zip(cfg["down_sample_layers"], cfg["down_sample_factor"]))
    flops, ns, c = 0.0, n, 1
    for i, o in enumerate(cfg["feat_dim"]):
        nd = ns // down[i] if i in down else ns
        if i in down:
            flops += fps(B, ns, nd)
        if i > 0:  # layer 0's graph comes with the scale (front_end)
            flops += knn(B, nd, ns, 3 * c)
        if i == 0:
            flops += edge_layer("layer0", B, ns, nd, 1, o, k)
        elif i < cfg["atten_start_layer"]:
            flops += edge_layer("mean", B, ns, nd, c, o, k)
        else:
            flops += edge_layer("attention", B, ns, nd, c, o, k)
            flops += lna(B * nd, c, o) + B * nd * o * NORMALIZE_CHANNEL
        if i >= 2:
            flops += global_conv(B, nd, o)
        ns, c = nd, o
    return flops + heads(cfg, B, ns, c)


def vecdgcnn_encoder(cfg: dict, B: int) -> float:
    n, k, h = cfg["n_pcl"], cfg["num_knn"], cfg["hidden_dim"]
    flops, c = 0.0, 1
    for _ in range(4):  # on the layer-0 graph (front_end)
        flops += edge_layer("mean", B, n, n, c, h, k)
        c = h
    return flops + heads(cfg, B, n, 4 * h)


def heads(cfg: dict, B: int, n: int, c: int) -> float:
    """conv_c (shared direction) on every point, its mean, the invariant
    head; the centre head where the encoder has one."""
    cd = cfg["c_dim"]
    flops = lna(B * n, c, cd, shared=True) + B * (6.0 * cd * cd + 3 * NORMALIZE_CHANNEL * cd)
    if cfg.get("center_pred"):
        flops += lna(B, cd, cd // 2) + B * 6.0 * (cd // 2 + cd)
    return flops


ENCODERS = {"vecdgcnn_atten": attention_encoder, "vecdgcnn": vecdgcnn_encoder}


def front_end(cfg: dict, B: int, n_full: int) -> float:
    """Masked FPS of the padded clouds down to n_pcl, then the scale
    statistic over all n_pcl^2 pairs of each cloud (which yields the
    layer-0 graph too)."""
    n = cfg["n_pcl"]
    return fps(B, n_full, n) + knn(B, n, n, 3)


def encode_stage(cfg: dict, clouds: int, n_full: int, weight_bytes: float):
    """(flops, bytes) of the front end and encoder over `clouds` padded
    clouds of n_full points."""
    flops = front_end(cfg, clouds, n_full) + ENCODERS[cfg["encoder_type"]](cfg, clouds)
    cd = cfg["c_dim"]
    nbytes = clouds * n_full * (3 * 4 + 1) + weight_bytes + clouds * 4 * (4 * cd + 4)
    return flops, nbytes
