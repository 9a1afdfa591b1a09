"""Seeded cases of the port's registered ops, one or more per op name,
shared by `tests/test_torch_ops.py` (the port against the JAX package on
the CPU) and `chip_smoke.py`'s eager phase (the port on the card against
the port on the CPU). Each case is `fn(n, *tensors)` over a namespace `n`
of one package's op modules (`n.P` the package, `n.math`, `n.manip`,
...), its numpy inputs, and the indices of the inputs to differentiate;
`op` names the registered op when the case name is not it. Imports
numpy only.
"""
import functools
import zlib

import numpy as np


class NS:
    """One package's op modules, as the cases address them: `F` is its
    `nn.functional`, `dispatch` its `ops.dispatch` (the registered ops
    that have no function of their own are run through its `apply`)."""

    def __init__(self, P, creation, math, manip, logic, linalg, seq, flash,
                 F, dispatch, legacy=None):
        self.P, self.creation, self.math, self.manip = P, creation, math, manip
        self.logic, self.linalg, self.seq, self.flash = logic, linalg, seq, \
            flash
        self.F, self.dispatch, self.legacy = F, dispatch, legacy


def port_namespace():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional
    from paddle_tpu_torch.ops import (creation, dispatch, flash_attention,
                                      legacy, linalg, logic, manipulation,
                                      math, sequence)
    return NS(pt, creation, math, manipulation, logic, linalg, sequence,
              flash_attention, functional, dispatch, legacy)


@functools.lru_cache(maxsize=None)
def arr(kind, shape=(3, 4), seed=0):
    """Seeded inputs, one array per (kind, shape, seed)."""
    r = np.random.RandomState(seed + 7 * len(kind))
    if kind == "x":
        return r.uniform(-1, 1, shape).astype("f4")
    if kind == "pos":
        return r.uniform(0.5, 2.0, shape).astype("f4")
    if kind == "unit":
        return r.uniform(-0.9, 0.9, shape).astype("f4")
    if kind == "gt1":
        return r.uniform(1.5, 3.0, shape).astype("f4")
    if kind == "p01":
        return r.uniform(0.1, 0.9, shape).astype("f4")
    if kind == "int":
        return r.randint(-5, 6, shape).astype("int32")
    if kind == "ipos":
        return r.randint(1, 10, shape).astype("int32")
    if kind == "bool":
        return r.rand(*shape) > 0.5
    if kind == "special":
        a = r.uniform(-1, 1, shape).astype("f4")
        a.flat[1], a.flat[4], a.flat[7] = np.nan, np.inf, -np.inf
        return a
    if kind == "nan":
        a = r.uniform(-1, 1, shape).astype("f4")
        a.flat[2] = a.flat[9] = np.nan
        return a
    if kind == "spd":
        a = r.uniform(-1, 1, shape).astype("f4")
        return (a @ a.T + shape[0] * np.eye(shape[0])).astype("f4")
    if kind == "lower":
        a = np.tril(r.uniform(-1, 1, shape)) + 3 * np.eye(shape[0])
        return a.astype("f4")
    if kind == "complex":
        return (r.uniform(-1, 1, shape) + 1j * r.uniform(-1, 1, shape)
                ).astype("c8")
    if kind == "small":
        return r.randint(0, 3, shape).astype("f4")
    raise KeyError(kind)


def I(*v):
    return np.asarray(v, dtype="int32")


X, Y = arr("x"), arr("x", seed=1)
LENS = I(5, 3)
SEQ = arr("x", (2, 5, 3))
SEQ2 = arr("x", (2, 5), seed=2)
IDS = np.random.RandomState(3).randint(1, 6, (2, 5)).astype("int32")


def case(fn, inputs, diff=(), **kw):
    return dict(fn=fn, inputs=inputs, diff=tuple(diff), **kw)


def unary(name, kind="x"):
    return case(lambda n, x: getattr(n.math, name)(x), [arr(kind)], [0])


def binary(name, kx="x", ky="x", diff=(0, 1)):
    return case(lambda n, x, y: getattr(n.math, name)(x, y),
                [arr(kx), arr(ky, seed=1)], diff)


def cmp(name, kx="x", ky="x"):
    return case(lambda n, x, y: getattr(n.logic, name)(x, y),
                [arr(kx), arr(ky, seed=1)])


def abs_all(n, outs):
    return tuple(n.math.abs(o) for o in outs)


# ------------------------------------------------------ nn.functional cases

def rs(seed):
    return np.random.RandomState(1000 + seed)


def uni(shape, lo=-1.0, hi=1.0, seed=0):
    return rs(seed).uniform(lo, hi, shape).astype("f4")


def ints(shape, lo, hi, seed=0):
    return rs(seed).randint(lo, hi, shape).astype("int32")


def signs(shape, seed=0):
    return np.where(rs(seed).rand(*shape) > 0.5, 1.0, -1.0).astype("f4")


def act(name, scale=1.0, **kw):
    return case(lambda n, x: getattr(n.F, name)(x, **kw),
                [scale * arr("x")], [0])


def run_op(n, name, tensors, **attrs):
    """Registered op `name` through the package's dispatcher (ops with no
    function of their own)."""
    d = n.dispatch
    return d.apply(d.OP_REGISTRY[name], tuple(tensors), attrs, name=name)


def dropped(n, y, x, scale):
    """A dropout's output with each dropped cell replaced by what the
    kept ones hold (x * scale): the same in every package and on every
    draw, and its gradient the op's."""
    return n.manip.where(y == 0, x * scale, y)


_ALPHA_P = -1.6732632423543772 * 1.0507009873554805
_COEF_A = (0.5 + _ALPHA_P ** 2 * 0.5 * 0.5) ** -0.5
_COEF_B = -_COEF_A * _ALPHA_P * 0.5


def alpha_dropped(n, x):
    """alpha_dropout(p=0.5) with each dropped cell (the constant
    coef_a * alpha_p + coef_b) replaced by the kept form coef_a x +
    coef_b."""
    y = n.F.alpha_dropout(x, p=0.5)
    kept = x * _COEF_A + _COEF_B
    c0 = _COEF_A * _ALPHA_P + _COEF_B
    return n.manip.where(n.math.abs(y - c0) < 1e-4, kept, y)


def gumbel(n, x):
    y = n.F.gumbel_softmax(x, temperature=0.5)
    h = n.F.gumbel_softmax(x, hard=True, axis=0)
    # the hard sample's max is 1 wherever it falls; its gradient would be
    # the drawn cell's
    return (n.math.sum(y, axis=-1), n.math.sum(h, axis=0),
            n.math.max(h, axis=0).detach())


def batch_norm(n, x, rm, rv, w, b, x2):
    y = n.F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.8)
    ev = n.F.batch_norm(x, rm, rv, w, b, training=False)
    y2 = n.F.batch_norm(x2, rm, rv, None, b, training=True,
                        data_format="NHWC")
    return y, ev, y2, rm, rv


def rope_np(seq, hd):
    inv = 1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))
    f = np.outer(np.arange(seq), inv)
    return np.cos(f).astype("f4"), np.sin(f).astype("f4")


COS, SIN = rope_np(128, 64)
CTC_LOGITS = uni((6, 2, 4), seed=40)
CTC_LABELS = np.array([[1, 2, 2], [3, 1, 0]], "int32")
CE_LABELS = np.array([1, 4, -100, 0], "int32")

NN_CASES = {
    # activations
    **{k: act(k) for k in ("relu", "silu", "mish", "tanhshrink", "softsign",
                           "log_sigmoid", "selu")},
    **{k: act(k, 4.0) for k in ("relu6", "hardswish", "hardsigmoid")},
    "gelu": case(lambda n, x: (n.F.gelu(x), n.F.gelu(x, approximate=True)),
                 [2 * arr("x")], [0]),
    "leaky_relu": act("leaky_relu", negative_slope=0.1),
    "elu": act("elu", 2.0, alpha=0.7),
    "celu": act("celu", 2.0, alpha=0.5),
    "prelu": case(lambda n, x, w, x2, w1: (n.F.prelu(x, w),
                                           n.F.prelu(x2, w, "NHWC"),
                                           n.F.prelu(x, w1)),
                  [uni((2, 3, 4)), uni((3,), 0.1, 0.5, 1), uni((2, 4, 3), seed=2),
                   uni((1,), 0.1, 0.5, 3)], [0, 1, 2, 3]),
    "hardtanh": act("hardtanh", min=-0.5, max=0.4),
    "hardshrink": act("hardshrink", threshold=0.3),
    "softshrink": act("softshrink", threshold=0.3),
    "softplus": act("softplus", 2.0, beta=2.0, threshold=1.5),
    "thresholded_relu": act("thresholded_relu", threshold=0.2),
    "maxout": case(lambda n, x: (n.F.maxout(x, 2), n.F.maxout(x, 3, axis=2)),
                   [uni((2, 4, 6))], [0]),
    "softmax": case(lambda n, x: (n.F.softmax(x), n.F.softmax(x, axis=0),
                                  n.F.softmax(x, dtype="float32")),
                    [2 * arr("x")], [0]),
    "log_softmax": case(lambda n, x: (n.F.log_softmax(x, axis=0),
                                      n.F.log_softmax(x)),
                        [2 * arr("x")], [0]),
    "gumbel_softmax": case(gumbel, [arr("x")], [0]),
    # linear, embedding, dropout
    "linear": case(lambda n, x, w, b: (n.F.linear(x, w, b), n.F.linear(x, w)),
                   [uni((2, 3, 4)), uni((4, 5), seed=1), uni((5,), seed=2)],
                   [0, 1, 2]),
    "embedding": case(lambda n, i, w: (n.F.embedding(i, w),
                                       n.F.embedding(i, w, padding_idx=-2)),
                      [ints((2, 3), 0, 6), uni((6, 4), seed=1)], [1]),
    "dropout": case(lambda n, x: (dropped(n, n.F.dropout(x, 0.5), x, 2.0),
                                  dropped(n, n.F.dropout(x, 0.5, axis=[0]),
                                          x, 2.0),
                                  dropped(n, n.F.dropout(
                                      x, 0.5, mode="downscale_in_infer"),
                                      x, 1.0),
                                  n.F.dropout(x, 0.5, training=False)),
                    [arr("x")], [0]),
    "alpha_dropout": case(alpha_dropped, [arr("x")], [0]),
    # conv and pooling
    "conv1d": case(lambda n, x, w, b: n.F.conv1d(x, w, b, stride=2,
                                                 padding=[1, 2]),
                   [uni((2, 3, 8)), uni((4, 3, 3), seed=1), uni((4,), seed=2)],
                   [0, 1, 2]),
    "conv2d": case(lambda n, x, w, b, x2, w2: (
        n.F.conv2d(x, w, b, stride=2, padding="SAME"),
        n.F.conv2d(n.manip.transpose(x, [0, 2, 3, 1]), w, b, padding=1,
                   data_format="NHWC"),
        n.F.conv2d(x2, w2, groups=2, dilation=2,
                   padding=[[1, 0], [0, 1]])),
        [uni((2, 3, 6, 6)), uni((4, 3, 3, 3), seed=1), uni((4,), seed=2),
         uni((2, 4, 6, 6), seed=3), uni((6, 2, 3, 3), seed=4)],
        [0, 1, 2, 3, 4]),
    "conv3d": case(lambda n, x, w, b: n.F.conv3d(x, w, b, padding=1),
                   [uni((1, 2, 4, 4, 4)), uni((3, 2, 2, 2, 2), seed=1),
                    uni((3,), seed=2)], [0, 1, 2]),
    "conv2d_transpose": case(lambda n, x, w, b: (
        n.F.conv2d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
        n.F.conv2d_transpose(n.manip.transpose(x, [0, 2, 3, 1]), w, b,
                             stride=2, padding=[0, 1], data_format="NHWC")),
        [uni((2, 3, 4, 4)), uni((3, 2, 3, 3), seed=1), uni((2,), seed=2)],
        [0, 1, 2]),
    "conv1d_transpose": case(lambda n, x, w, b: n.F.conv1d_transpose(
        x, w, b, stride=2, padding=[1, 0], output_padding=1),
        [uni((2, 4, 5)), uni((4, 3, 3), seed=1), uni((3,), seed=2)],
        [0, 1, 2]),
    "conv3d_transpose": case(lambda n, x, w: n.F.conv3d_transpose(
        x, w, stride=2, padding=1),
        [uni((1, 2, 3, 3, 3)), uni((2, 2, 2, 2, 2), seed=1)], [0, 1]),
    "max_pool2d": case(lambda n, x: (
        n.F.max_pool2d(x, 3, 2, padding=1, ceil_mode=True),
        n.F.max_pool2d(n.manip.transpose(x, [0, 2, 3, 1]), 2, 3,
                       padding="SAME", data_format="NHWC"),
        n.F.max_pool1d(n.manip.reshape(x, [2, 3, 49]), 4, 3, padding=1)),
        [uni((2, 3, 7, 7))], [0]),
    "avg_pool2d": case(lambda n, x: (
        n.F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True),
        n.F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True,
                       count_include_pad=False),
        n.F.avg_pool2d(x, [2, 3], padding="SAME", count_include_pad=False),
        n.F.avg_pool1d(n.manip.reshape(x, [2, 3, 49]), 5, 4, padding=2)),
        [uni((2, 3, 7, 7))], [0]),
    "max_pool3d": case(lambda n, x: n.F.max_pool3d(x, 2, 2, ceil_mode=True),
                       [uni((1, 2, 5, 5, 5))], [0]),
    "avg_pool3d": case(lambda n, x: (
        n.F.avg_pool3d(x, 2, 2, ceil_mode=True),
        n.F.avg_pool3d(x, 3, 2, padding=1, count_include_pad=False)),
        [uni((1, 2, 5, 5, 5))], [0]),
    "adaptive_avg_pool2d": case(lambda n, x: (
        n.F.adaptive_avg_pool2d(x, [3, 2]), n.F.adaptive_avg_pool2d(x, 1),
        n.F.adaptive_avg_pool2d(n.manip.transpose(x, [0, 2, 3, 1]), [2, 3],
                                data_format="NHWC")),
        [uni((2, 3, 7, 6))], [0]),
    "adaptive_max_pool2d": case(lambda n, x: (
        n.F.adaptive_max_pool2d(x, [3, 2]), n.F.adaptive_max_pool2d(x, 2)),
        [uni((2, 3, 7, 6))], [0]),
    "adaptive_avg_pool1d": case(lambda n, x: n.F.adaptive_avg_pool1d(x, 4),
                                [uni((2, 3, 8))], [0]),
    "adaptive_max_pool1d": case(lambda n, x: n.F.adaptive_max_pool1d(x, 2),
                                [uni((2, 3, 8))], [0]),
    "adaptive_avg_pool3d": case(lambda n, x: n.F.adaptive_avg_pool3d(x, 2),
                                [uni((1, 2, 4, 4, 4))], [0]),
    "adaptive_max_pool3d": case(
        lambda n, x: n.F.adaptive_max_pool3d(x, [2, 1, 2]),
        [uni((1, 2, 4, 4, 4))], [0]),
    # norms
    "batch_norm": case(batch_norm,
                       [uni((4, 3, 2, 2)), uni((3,), -0.1, 0.1, 1),
                        uni((3,), 0.5, 1.5, 2), uni((3,), 0.5, 1.5, 3),
                        uni((3,), seed=4), uni((2, 2, 2, 3), seed=5)],
                       [0, 3, 4, 5]),
    "layer_norm": case(lambda n, x, w, b: (
        n.F.layer_norm(x, [3, 4], w, b), n.F.layer_norm(x, 4, epsilon=1e-3)),
        [uni((2, 3, 4)), uni((3, 4), 0.5, 1.5, 1), uni((3, 4), seed=2)],
        [0, 1, 2]),
    "instance_norm": case(lambda n, x, w, b: (
        n.F.instance_norm(x, weight=w, bias=b), n.F.instance_norm(x)),
        [uni((2, 3, 4, 4)), uni((3,), 0.5, 1.5, 1), uni((3,), seed=2)],
        [0, 1, 2]),
    "group_norm": case(lambda n, x, w, b: n.F.group_norm(x, 2, weight=w,
                                                         bias=b),
                       [uni((2, 4, 3, 3)), uni((4,), 0.5, 1.5, 1),
                        uni((4,), seed=2)], [0, 1, 2]),
    "normalize": case(lambda n, x: (n.F.normalize(x),
                                    n.F.normalize(x, p=1, axis=0)),
                      [arr("x")], [0]),
    "local_response_norm": case(lambda n, x: n.F.local_response_norm(
        x, 3, alpha=0.1, beta=0.75, k=1.5), [uni((2, 6, 3, 3))], [0]),
    # losses
    "cross_entropy": case(lambda n, x, lab, w, soft, p, x3, lab3: (
        n.F.cross_entropy(x, lab), n.F.cross_entropy(x, lab, weight=w),
        n.F.cross_entropy(x, n.manip.unsqueeze(lab, -1), reduction="sum"),
        n.F.cross_entropy(x, lab, reduction="none"),
        n.F.cross_entropy(x, soft, soft_label=True),
        n.F.cross_entropy(p, lab, use_softmax=False),
        n.F.cross_entropy(x, lab * 0 - 100),
        n.F.cross_entropy(x3, lab3, axis=1)),
        [uni((4, 5), -2, 2), CE_LABELS, uni((5,), 0.5, 1.5, 1),
         rs(2).dirichlet(np.ones(5), 4).astype("f4"),
         rs(3).dirichlet(np.ones(5), 4).astype("f4"), uni((2, 5, 3), seed=4),
         ints((2, 3), 0, 5, 5)], [0, 2, 4, 5]),
    "nll_loss": case(lambda n, lp, lab, w: (
        n.F.nll_loss(lp, lab), n.F.nll_loss(lp, lab, weight=w),
        n.F.nll_loss(lp, lab, reduction="none")),
        [np.log(rs(6).dirichlet(np.ones(5), 4)).astype("f4"), CE_LABELS,
         uni((5,), 0.5, 1.5, 7)], [0, 2]),
    "mse_loss": case(lambda n, a, b: (n.F.mse_loss(a, b),
                                      n.F.mse_loss(a, b, "none")),
                     [X, Y], [0, 1]),
    "l1_loss": case(lambda n, a, b: n.F.l1_loss(a, b, "sum"), [X, Y], [0, 1]),
    "smooth_l1_loss": case(lambda n, a, b: (
        n.F.smooth_l1_loss(a, b, delta=0.5),
        n.F.smooth_l1_loss(a, b, "none")), [2 * X, Y], [0, 1]),
    "binary_cross_entropy": case(lambda n, p, y, w: (
        n.F.binary_cross_entropy(p, y),
        n.F.binary_cross_entropy(p, y, w, "none")),
        [arr("p01"), (arr("x", seed=2) > 0).astype("f4"),
         uni((3, 4), 0.5, 1.5, 8)], [0, 2]),
    "bce_with_logits": case(lambda n, z, y, w, pw: (
        n.F.binary_cross_entropy_with_logits(z, y),
        n.F.binary_cross_entropy_with_logits(z, y, w, "sum", pos_weight=pw)),
        [2 * X, (arr("x", seed=2) > 0).astype("f4"),
         uni((3, 4), 0.5, 1.5, 8), uni((4,), 0.5, 2.0, 9)], [0, 2, 3]),
    "kl_div": case(lambda n, lp, y: (n.F.kl_div(lp, y),
                                     n.F.kl_div(lp, y, "batchmean"),
                                     n.F.kl_div(lp, y, "none")),
                   [np.log(arr("p01")), arr("p01", seed=3)], [0, 1]),
    "margin_ranking_loss": case(lambda n, a, b, y: n.F.margin_ranking_loss(
        a, b, y, margin=0.1), [X, Y, signs((3, 4))], [0, 1]),
    "hinge_embedding_loss": case(lambda n, a, y: n.F.hinge_embedding_loss(
        a, y, margin=0.5, reduction="none"), [X, signs((3, 4))], [0]),
    "cosine_similarity": case(lambda n, a, b: (
        n.F.cosine_similarity(a, b), n.F.cosine_similarity(a, b, axis=0)),
        [X, Y], [0, 1]),
    "square_error_cost": case(lambda n, a, b: n.F.square_error_cost(a, b),
                              [X, Y], [0, 1]),
    "sigmoid_focal_loss": case(lambda n, z, y, nz: (
        n.F.sigmoid_focal_loss(z, y),
        n.F.sigmoid_focal_loss(z, y, nz, reduction="mean")),
        [2 * X, (arr("x", seed=2) > 0).astype("f4"),
         np.array([3.0], "f4")], [0]),
    "hsigmoid_loss": case(lambda n, x, lab, w, b: (
        n.F.hsigmoid_loss(x, lab, 5, w, b), n.F.hsigmoid_loss(x, lab, 5, w)),
        [uni((4, 3)), I(0, 4, 2, 3), uni((4, 3), seed=1),
         uni((4, 1), seed=2)], [0, 2, 3]),
    "ctc_loss": case(lambda n, lp, lab, il, ll: (
        n.F.ctc_loss(lp, lab, il, ll), n.F.ctc_loss(lp, lab, il, ll,
                                                    reduction="sum"),
        n.F.ctc_loss(lp, lab, il, ll, reduction="none", norm_by_times=True)),
        [CTC_LOGITS, CTC_LABELS, I(6, 5), I(3, 2)], [0]),
    "npair_loss": case(lambda n, a, p, y: n.F.npair_loss(a, p, y),
                       [uni((4, 3)), uni((4, 3), seed=1), I(0, 1, 0, 2)],
                       [0, 1]),
    # padding, resampling, vision helpers
    "pad": case(lambda n, x: (
        n.F.pad(x, [1, 2, 0, 1]), n.F.pad(x, [2, 1, 1, 3], mode="reflect"),
        n.F.pad(x, [1, 2, 3, 0], mode="replicate"),
        n.F.pad(x, [2, 1, 1, 2], mode="circular"),
        n.F.pad(x, [0, 0, 1, 0, 1, 1, 0, 2], value=0.5),
        n.F.pad(x, [1, 1, 2, 0], data_format="NHWC")),
        [uni((2, 3, 4, 4))], [0]),
    "unfold": case(lambda n, x: (n.F.unfold(x, 2, paddings=1),
                                 n.F.unfold(x, [3, 2], strides=2,
                                            dilations=[1, 2])),
                   [uni((2, 3, 5, 5))], [0]),
    "interpolate": case(lambda n, x, x1, x3: (
        n.F.interpolate(x, size=[6, 7], mode="bilinear"),
        n.F.interpolate(x, size=[6, 7], mode="bilinear", align_corners=True),
        n.F.interpolate(x, size=[3, 8], mode="bilinear", align_mode=1),
        n.F.interpolate(x, scale_factor=2, mode="nearest"),
        n.F.interpolate(x, size=[7, 3], mode="nearest", align_corners=True),
        n.F.interpolate(x, size=[6, 9], mode="bicubic"),
        n.F.interpolate(x, size=[5, 4], mode="bicubic", align_corners=True),
        n.F.interpolate(x, size=[2, 3], mode="area"),
        n.F.interpolate(x, size=[7, 3], mode="area"),
        n.F.interpolate(x1, size=8, mode="linear", data_format="NCW"),
        n.F.interpolate(x3, size=[5, 4, 2], mode="trilinear",
                        data_format="NCDHW"),
        n.F.upsample(n.manip.transpose(x, [0, 2, 3, 1]), size=[3, 7],
                     mode="bilinear", data_format="NHWC")),
        [uni((1, 2, 4, 5)), uni((1, 2, 5), seed=1),
         uni((1, 1, 3, 3, 3), seed=2)], [0, 1, 2]),
    "pixel_shuffle": case(lambda n, x: n.F.pixel_shuffle(x, 2),
                          [uni((1, 8, 2, 3))], [0]),
    "temporal_shift": case(lambda n, x: n.F.temporal_shift(x, 2, 0.25),
                           [uni((4, 4, 2, 2))], [0]),
    "grid_sample": case(lambda n, x, g: (
        n.F.grid_sample(x, g), n.F.grid_sample(x, g, padding_mode="border",
                                               align_corners=False)),
        [uni((1, 2, 4, 5)), uni((1, 3, 3, 2), -1.2, 1.2, 1)], [0, 1]),
    "affine_grid": case(lambda n, t: (
        n.F.affine_grid(t, [2, 1, 3, 4]),
        n.F.affine_grid(t, [2, 1, 2, 3], align_corners=False)),
        [uni((2, 2, 3))], [0]),
    "label_smooth": case(lambda n, y, p: (n.F.label_smooth(y),
                                          n.F.label_smooth(y, p, 0.2)),
                         [arr("p01"), uni((4,), 0.1, 0.4, 1)], [0, 1]),
    "diag_embed": case(lambda n, x: n.F.diag_embed(x), [uni((2, 3))], [0]),
    "sequence_mask": case(lambda n, ln: (n.F.sequence_mask(ln, 6),
                                         n.F.sequence_mask(ln),
                                         n.F.sequence_mask(ln, 4, "float32")),
                          [I(3, 0, 5)]),
    "pairwise_distance": case(lambda n, a, b: (
        n.F.pairwise_distance(a, b),
        n.F.pairwise_distance(a, b, p=1.0, keepdim=True)), [X, Y], [0, 1]),
    "gather_tree": case(lambda n, i, p: n.F.gather_tree(i, p),
                        [ints((4, 2, 3), 0, 9), ints((4, 2, 3), 0, 3, 1)]),
    "deform_conv2d": case(lambda n, x, off, w, m, b: (
        n.F.deform_conv2d(x, off, w, b, padding=1, mask=m),
        n.F.deform_conv2d(x, off[:, :, ::2, ::2], w, stride=2, padding=1)),
        [uni((1, 2, 5, 5)), uni((1, 18, 5, 5), -0.7, 0.7, 1),
         uni((3, 2, 3, 3), seed=2), uni((1, 9, 5, 5), 0.1, 0.9, 3),
         uni((3,), seed=4)], [0, 1, 2, 3, 4]),
    "bilinear": case(lambda n, a, b, w, bias: n.F.bilinear(a, b, w, bias),
                     [uni((3, 2)), uni((3, 4), seed=1),
                      uni((5, 2, 4), seed=2), uni((1, 5), seed=3)],
                     [0, 1, 2, 3]),
    # the LLaMA ops: RMSNorm, and the fused GQA attention (K1-K3's route:
    # the port's plain blocks on the CPU, JAX's Pallas kernels in
    # interpret mode)
    "rms_norm": case(lambda n, x, w: run_op(n, "rms_norm", (x, w), eps=1e-5),
                     [uni((2, 3, 8)), uni((8,), 0.5, 1.5, 1)], [0, 1]),
    "llama_attention": case(lambda n, x, w, c, s: tuple(
        run_op(n, "llama_attention", (x, w, c, s), num_heads=2,
               num_kv_heads=1, head_dim=64, attn_layout=lay)
        for lay in ("bshd", "bhsd")),
        [uni((1, 128, 32)), uni((32, 256), -0.2, 0.2, 1), COS, SIN],
        [0, 1]),
}


# ------------------------------------------------------------ legacy cases
# the fluid-era ops of ops/legacy.py (`n.legacy`); the random creators
# are held by their shapes and moments, as draws differ between packages
# and devices

def elementwise(name, kx="x", ky="x"):
    return case(lambda n, x, y, y2: (
        run_op(n, name, (x, y), axis=1), run_op(n, name, (x, y2))),
        [uni((2, 3, 4), seed=60) if kx == "x" else uni((2, 3, 4), 0.5, 2.0,
                                                       60),
         uni((3, 1), seed=61) if ky == "x" else uni((3, 1), 0.5, 2.0, 61),
         uni((4,), seed=62) if ky == "x" else uni((4,), 0.5, 2.0, 62)],
        [0, 1, 2])


def moments_ok(n, z, mean, std, lo=None, hi=None):
    """Whether a draw's mean and standard deviation lie within about 5
    standard errors of `mean` and `std` (and its values within [lo,
    hi]): a bool Tensor."""
    m, s = n.math.mean(z), n.math.std(z)
    se = std / z.shape[0] ** 0.5
    ok = n.logic.logical_and(n.math.abs(m - mean) < 5 * se,
                             n.math.abs(s - std) < 6 * se)
    if lo is not None:
        ok = n.logic.logical_and(ok, n.math.min(z) >= lo)
        ok = n.logic.logical_and(ok, n.math.max(z) <= hi)
    return ok


def chunk_tags(seed, hi):
    tags = ints((3, 7), 0, hi, seed)
    lab = tags.copy()
    flip = rs(seed + 1).rand(3, 7) < 0.3
    lab[flip] = ints((3, 7), 0, hi, seed + 2)[flip]
    return tags, lab


def chunk_all(n, lens, *tags):
    out = ()
    for (inf, lab), (scheme, types) in zip(
            zip(tags[::2], tags[1::2]),
            (("IOB", 2), ("IOE", 2), ("IOBES", 2), ("plain", 3))):
        out += tuple(n.legacy.chunk_eval(inf, lab, lens,
                                         num_chunk_types=types,
                                         chunk_scheme=scheme))
    return out


TREE_EDGES = np.array([[1, 2], [1, 3], [2, 4], [2, 5], [3, 6], [0, 0]],
                      "int32")
HASH_IDS = np.array([[3], [-7], [2147483647], [123456]], "int32")
_BS_IDS = ints((2, 3), 1, 5, 70)
_BS_IDS[0, 1] = 0

LEGACY_CASES = {
    "huber_loss": case(lambda n, x, y: n.legacy.huber_loss(x, y, delta=0.5),
                       [X, Y], [0, 1]),
    "rank_loss": case(lambda n, lab, a, b: n.legacy.rank_loss(lab, a, b),
                      [np.array([[0.0], [0.5], [1.0], [1.0]], "f4"),
                       uni((4, 1), seed=1), uni((4, 1), seed=2)], [1, 2]),
    "bpr_loss": case(lambda n, x, lab: n.legacy.bpr_loss(x, lab),
                     [uni((4, 5)), ints((4,), 0, 5, 3)], [0]),
    "hinge_loss": case(lambda n, x, lab: n.legacy.hinge_loss(x, lab),
                       [uni((4, 1), -2, 2), np.array([[0], [1], [1], [0]],
                                                     "f4")], [0]),
    "center_loss": case(lambda n, x, lab, c: (
        *n.legacy.center_loss(x, lab, c, alpha=0.2),
        n.legacy.center_loss(x, lab, c, need_update=False)[0]),
        [uni((4, 3)), I(0, 2, 0, 1), uni((3, 3), seed=4)], [0, 2]),
    "cos_sim": case(lambda n, x, y, y1: (n.legacy.cos_sim(x, y),
                                         n.legacy.cos_sim(x, y1)),
                    [X, Y, arr("x", (1, 4), 5)], [0, 1, 2]),
    "squared_l2_norm": case(lambda n, x: n.legacy.squared_l2_norm(x), [X],
                            [0]),
    "l1_norm": case(lambda n, x: n.legacy.l1_norm(x), [X], [0]),
    "frobenius_norm": case(lambda n, x: (
        n.legacy.frobenius_norm(x, axis=[1, 2], keepdim=True),
        n.legacy.frobenius_norm(x)), [uni((2, 3, 4), seed=6)], [0]),
    "p_norm": case(lambda n, x: (
        n.legacy.p_norm(x, porder=3.0, axis=1),
        n.legacy.p_norm(x, porder=1.0, axis=0, keepdim=True),
        n.legacy.p_norm(x, porder=float("inf")),
        n.legacy.p_norm(x, porder=float("-inf"), axis=0)), [X], [0]),
    "nce_loss": case(lambda n, x, w, b, lab, s: n.legacy.nce_loss(
        x, w, b, lab, s),
        [uni((3, 4)), uni((6, 4), seed=1), uni((6,), seed=2), I(1, 4, 1),
         I(0, 5, 4, 2)], [0, 1, 2]),
    "linear_chain_crf": case(
        lambda n, e, t, lab, ln: n.legacy.linear_chain_crf(e, t, lab, ln),
        [uni((2, 5, 3), seed=7), uni((5, 3), seed=8), ints((2, 5), 0, 3, 9),
         I(5, 3)], [0, 1]),
    "mul": case(lambda n, x, y, y2: (
        n.legacy.mul(x, y), n.legacy.mul(x, y2, x_num_col_dims=2)),
        [uni((2, 3, 4), seed=10), uni((12, 5), seed=11),
         uni((4, 5), seed=12)], [0, 1, 2]),
    "multiplex": case(lambda n, a, b, c, i: n.legacy.multiplex([a, b, c], i),
                      [uni((4, 3), seed=13), uni((4, 3), seed=14),
                       uni((4, 3), seed=15), np.array([[2], [0], [1], [2]],
                                                      "int32")], [0, 1, 2]),
    "segment_pool": case(lambda n, x, ids: tuple(
        n.legacy.segment_pool(x, ids, pool_type=p, num_segments=4)
        for p in ("SUM", "MEAN", "MAX", "MIN")) + (
        n.legacy.segment_pool(x, ids),),
        [uni((5, 3), seed=16), I(0, 0, 1, 3, 3)], [0]),
    "cvm": case(lambda n, x, c: (n.legacy.cvm(x, c),
                                 n.legacy.cvm(x, c, use_cvm=False)),
                [uni((3, 5), seed=17), uni((3, 2), 0.5, 3.0, 18)], [0, 1]),
    "data_norm": case(lambda n, x, bs, s, sq: n.legacy.data_norm(x, bs, s,
                                                                 sq),
                      [uni((3, 4), seed=19), uni((4,), 5, 10, 20),
                       uni((4,), seed=21), uni((4,), 1, 3, 22)],
                      [0, 1, 2, 3]),
    "shuffle_batch": case(lambda n, x: (
        n.math.sum(n.legacy.shuffle_batch(x), axis=0),
        n.math.sum(n.legacy.shuffle_batch(x, seed=5), axis=0)),
        [uni((6, 3), seed=23)], [0]),
    "im2sequence": case(lambda n, x: (
        n.legacy.im2sequence(x, kernels=(2, 3), strides=(2, 1),
                             paddings=(1, 0, 1, 1)),
        n.legacy.im2sequence(x, kernels=(3, 2), paddings=(0, 1))),
        [uni((2, 2, 5, 5), seed=24)], [0]),
    "row_conv": case(lambda n, x, w: n.legacy.row_conv(x, w),
                     [uni((2, 5, 3), seed=25), uni((3, 3), seed=26)],
                     [0, 1]),
    "conv_shift": case(lambda n, x, y: n.legacy.conv_shift(x, y),
                       [uni((2, 5), seed=27), uni((2, 3), seed=28)], [0, 1]),
    "fsp": case(lambda n, x, y: n.legacy.fsp(x, y),
                [uni((2, 3, 4, 4), seed=29), uni((2, 2, 4, 4), seed=30)],
                [0, 1]),
    "increment": case(lambda n, x, i: (n.legacy.increment(x, value=2.0),
                                       n.legacy.increment(i)),
                      [X, arr("int")], [0]),
    "expand_as_v2": case(lambda n, x, y: n.legacy.expand_as_v2(x, y),
                         [uni((1, 4), seed=31), uni((3, 4), seed=32)], [0]),
    "reverse": case(lambda n, x: (n.legacy.reverse(x, axis=[0, 1]),
                                  n.legacy.reverse(x, axis=1)), [X], [0]),
    **{k: elementwise(k) for k in ("elementwise_add", "elementwise_sub",
                                   "elementwise_mul", "elementwise_max",
                                   "elementwise_min")},
    "elementwise_div": elementwise("elementwise_div", ky="pos"),
    "elementwise_pow": elementwise("elementwise_pow", kx="pos"),
    "elementwise_mod": elementwise("elementwise_mod", ky="pos"),
    "crf_decoding": case(lambda n, e, t, ln: n.legacy.crf_decoding(e, t, ln),
                         [uni((2, 5, 3), seed=33), uni((5, 3), seed=34),
                          I(5, 3)]),
    "beam_search": case(lambda n, i, s, p: n.legacy.beam_search(
        i, s, p, beam_size=3, end_id=0),
        [_BS_IDS, uni((2, 3), -3, 0, 35), uni((2, 3, 5), 0.05, 1.0, 36)]),
    "sample_logits": case(lambda n, x, lab, s: n.legacy.sample_logits(
        x, lab, s), [uni((3, 6), seed=37), np.array([[1], [4], [0]], "int32"),
                     I(1, 4, 2)]),
    "auc": case(lambda n, p, lab, sp, sn: n.legacy.auc(p, lab, sp, sn,
                                                       num_thresholds=10),
                [uni((8, 2), 0.0, 1.0, 38), ints((8, 1), 0, 2, 39),
                 np.arange(11, dtype="f4"), np.ones(11, "f4")]),
    "chunk_eval": case(chunk_all, [I(7, 5, 6), *chunk_tags(40, 5),
                                   *chunk_tags(43, 5),
                                   *chunk_tags(46, 9), *chunk_tags(49, 4)]),
    "positive_negative_pair": case(
        lambda n, s, lab, q: n.legacy.positive_negative_pair(s, lab, q),
        [np.array([0.3, 0.1, 0.3, 0.9, -0.2, 0.5, 0.5, 0.0], "f4"),
         ints((8,), 0, 3, 52), ints((8,), 0, 2, 53)]),
    "partial_sum": case(lambda n, a, b, c: (
        n.legacy._partial_sum_impl(a, b, c, start_index=1, length=3),
        n.legacy._partial_sum_impl(a, b, start_index=2)),
        [uni((3, 5), seed=54), uni((3, 5), seed=55), uni((3, 5), seed=56)],
        [0, 1, 2]),
    "partial_concat": case(lambda n, a, b, c: (
        n.legacy._partial_concat_impl(a, b, c, start_index=1, length=3),
        n.legacy._partial_concat_impl(a, b, start_index=2)),
        [uni((3, 5), seed=54), uni((3, 5), seed=55), uni((3, 5), seed=56)],
        [0, 1, 2]),
    "batch_fc": case(lambda n, x, w, b: n.legacy.batch_fc(x, w, b),
                     [uni((2, 3, 4), seed=57), uni((2, 4, 5), seed=58),
                      uni((2, 1, 5), seed=59)], [0, 1, 2]),
    "spectral_norm_op": case(lambda n, w, u, v, u1, v1: (
        *n.legacy.spectral_norm_op(w, u, v, dim=0, power_iters=2),
        *n.legacy.spectral_norm_op(w, u1, v1, dim=1)),
        [uni((4, 3, 2), seed=63), uni((4,), seed=64), uni((6,), seed=65),
         uni((3,), seed=66), uni((8,), seed=67)], [0]),
    "fill_zeros_like": case(lambda n, x: n.legacy.fill_zeros_like(x), [X]),
    "lod_reset": case(lambda n, x, ln: n.legacy.lod_reset(x, ln),
                      [uni((3, 2), seed=68), I(1, 2)]),
    "gaussian_random": case(lambda n: (
        n.legacy.gaussian_random([4000], mean=1.0, std=2.0) * 0,
        moments_ok(n, n.legacy.gaussian_random([4000], mean=1.0, std=2.0),
                   1.0, 2.0)), []),
    "uniform_random": case(lambda n: (
        n.legacy.uniform_random([4000], min=-1.0, max=3.0) * 0,
        moments_ok(n, n.legacy.uniform_random([4000], min=-1.0, max=3.0),
                   1.0, 4.0 / 12 ** 0.5, -1.0, 3.0)), []),
    "truncated_gaussian_random": case(lambda n: (
        n.legacy.truncated_gaussian_random([4000], mean=1.0, std=2.0) * 0,
        moments_ok(n, n.legacy.truncated_gaussian_random(
            [4000], mean=1.0, std=2.0), 1.0, 2.0 * 0.87962566, -3.0,
            5.0)), []),
    "inplace_abn": case(lambda n, x, m, v, s, b: tuple(
        n.legacy.inplace_abn(x, m, v, s, b, activation=a, alpha=0.2)
        for a in ("identity", "leaky_relu", "elu")),
        [uni((2, 3, 4), -2, 2, 69), uni((3,), seed=70),
         uni((3,), 0.5, 2, 71), uni((3,), seed=72), uni((3,), seed=73)],
        [0, 1, 2, 3, 4]),
    "hash_op": case(lambda n, x, x2: (
        n.legacy.hash_op(x, num_hash=3, mod_by=1000),
        n.legacy.hash_op(x2, num_hash=2, mod_by=97)),
        [HASH_IDS, np.concatenate([HASH_IDS, HASH_IDS[::-1] * 3 - 1], 1)]),
    "edit_distance": case(lambda n, h, r, hl, rl: (
        n.legacy.edit_distance(h, r, hl, rl),
        n.legacy.edit_distance(h, r, hl, rl, normalized=False)),
        [ints((3, 6), 0, 4, 74), ints((3, 5), 0, 4, 75), I(6, 4, 0),
         I(5, 5, 3)]),
    "ctc_align": case(lambda n, x, ln: (
        *n.legacy.ctc_align(x, ln),
        *n.legacy.ctc_align(x, ln, blank=2, merge_repeated=False)),
        [np.array([[1, 1, 0, 2, 2, 0, 0, 3], [0, 3, 3, 3, 1, 0, 1, 1],
                   [2, 2, 1, 0, 0, 0, 0, 0]], "int32"), I(8, 5, 0)]),
    "mean_iou": case(lambda n, p, lab: n.legacy.mean_iou(p, lab,
                                                         num_classes=4),
                     [ints((10,), 0, 3, 76), ints((10,), 0, 3, 77)]),
    "spp": case(lambda n, x: (n.legacy.spp(x, pyramid_height=3),
                              n.legacy.spp(x, pool_type="avg")),
                [uni((2, 2, 4, 4), seed=78)], [0]),
    "add_position_encoding": case(lambda n, x, x5: (
        n.legacy.add_position_encoding(x, alpha=0.5, beta=2.0),
        n.legacy.add_position_encoding(x5)),
        [uni((2, 5, 6), seed=79), uni((2, 3, 5), seed=80)], [0, 1]),
    "dequantize_abs_max": case(lambda n, x, s: n.legacy.dequantize_abs_max(
        x, s), [ints((3, 4), -127, 128, 81), np.array([2.5], "f4")]),
    "dequantize_log": case(lambda n, x, d: n.legacy.dequantize_log(x, d),
                           [ints((3, 4), -128, 256, 82),
                            uni((128,), seed=83)]),
    "match_matrix_tensor": case(
        lambda n, x, y, w: n.legacy.match_matrix_tensor(x, y, w),
        [uni((2, 3, 4), seed=84), uni((2, 5, 3), seed=85),
         uni((4, 2, 3), seed=86)], [0, 1, 2]),
    "tree_conv": case(lambda n, x, e, f: (
        n.legacy.tree_conv(x, e, f), n.legacy.tree_conv(x, e, f,
                                                         max_depth=3)),
        [uni((6, 4), seed=87), TREE_EDGES, uni((4, 3, 2, 3), seed=88)],
        [0, 2]),
    "var_conv_2d": case(lambda n, x, r, c, f: (
        n.legacy.var_conv_2d(x, r, c, f),
        n.legacy.var_conv_2d(x, r, c, f, stride=(2, 2))),
        [uni((2, 2, 5, 5), seed=89), I(5, 3), I(4, 5),
         uni((3, 2, 3, 3), seed=90)], [0, 3]),
    "pyramid_hash": case(lambda n, i, e: (
        n.legacy.pyramid_hash(i, e), n.legacy.pyramid_hash(
            i, e, min_win=1, max_win=4, mod_by=37)),
        [ints((2, 6), 0, 1000, 91), uni((50, 4), seed=92)], [1]),
    "bilateral_slice": case(lambda n, g, g2, gd, x: (
        n.legacy.bilateral_slice(g, gd, x),
        n.legacy.bilateral_slice(g2, gd, x, has_offset=True)),
        [uni((1, 6, 3, 4, 4), seed=93), uni((1, 9, 3, 4, 4), seed=94),
         uni((1, 5, 6), 0.1, 0.9, 95), uni((1, 2, 5, 6), seed=96)],
        [0, 1, 2, 3]),
}


CASES = {
    # creation
    "tril": case(lambda n, x: n.creation.tril(x, diagonal=1), [X], [0]),
    "triu": case(lambda n, x: n.creation.triu(x, diagonal=-1), [X], [0]),
    "assign": case(lambda n, x: n.creation.assign(x), [X], [0]),
    "meshgrid": case(lambda n, a, b: n.creation.meshgrid(a, b),
                     [arr("x", (3,)), arr("x", (4,), seed=1)], [0, 1]),
    "unbind": case(lambda n, x: n.manip.unbind(x, axis=1), [X], [0]),
    # unregistered ops whose output size depends on the data
    "nonzero": case(lambda n, i: (n.manip.nonzero(i),)
                    + tuple(n.manip.nonzero(i, as_tuple=True)),
                    [arr("int")], op=None),
    "masked_select": case(lambda n, x, m: n.manip.masked_select(x, m),
                          [X, arr("bool")], op=None),
    "unique": case(lambda n, i: n.math.unique(i, return_index=True,
                                              return_inverse=True,
                                              return_counts=True),
                   [arr("int")], op=None),
    "bincount": case(lambda n, i, w: (n.linalg.bincount(i),
                                      n.linalg.bincount(i, weights=w)),
                     [arr("ipos", (12,)), arr("x", (12,))], op=None),
    # math: binary
    **{k: binary(k) for k in ("add", "subtract", "multiply", "maximum",
                              "minimum", "fmax", "fmin", "atan2", "hypot",
                              "logaddexp")},
    "divide": binary("divide", "x", "pos"),
    "pow": binary("pow", "pos", "x"),
    "floor_divide": binary("floor_divide", "int", "ipos", ()),
    "remainder": binary("remainder", "int", "ipos", ()),
    "xlogy": binary("xlogy", "pos", "pos"),
    "copysign": binary("copysign", diff=()),
    "nextafter": binary("nextafter", diff=()),
    "gcd": binary("gcd", "ipos", "ipos", ()),
    "lcm": binary("lcm", "ipos", "ipos", ()),
    "heaviside": case(lambda n, x, y: n.math.heaviside(x, y),
                      [arr("small") - 1, Y]),
    "scale": case(lambda n, x: n.math.scale(x, scale=2.0, bias=0.5), [X],
                  [0]),
    "scale_act": case(lambda n, x: (n.math.scale(x, 2.0, 0.5, act="tanh"),
                                    n.math.scale(x, 3.0, -1.0, False,
                                                 act="relu")),
                      [X], [0], op="scale"),
    # math: unary
    **{k: unary(k) for k in ("abs", "neg", "exp", "expm1", "square", "sin",
                             "cos", "tan", "atan", "sinh", "cosh", "tanh",
                             "asinh", "erf", "sigmoid", "floor", "ceil",
                             "round", "trunc", "sign", "frac", "sinc", "exp2",
                             "rad2deg", "deg2rad")},
    **{k: unary(k, "pos") for k in ("log", "log2", "log10", "log1p", "sqrt",
                                    "rsqrt", "reciprocal", "digamma",
                                    "lgamma")},
    **{k: unary(k, "unit") for k in ("asin", "acos", "atanh", "erfinv")},
    "acosh": unary("acosh", "gt1"),
    "logit": case(lambda n, x: n.math.logit(x), [arr("p01")], [0]),
    "clip": case(lambda n, x: n.math.clip(x, min=-0.5, max=0.5), [X], [0]),
    **{k: case(lambda n, x, k=k: getattr(n.math, k)(x), [arr("special")])
       for k in ("isnan", "isinf", "isfinite")},
    "nan_to_num": case(lambda n, x: n.math.nan_to_num(x, posinf=9.0),
                       [arr("special")], [0]),
    # math: reductions
    "sum": case(lambda n, x: n.math.sum(x, axis=1), [X], [0]),
    "mean": case(lambda n, x: n.math.mean(x, axis=[0, 1], keepdim=True), [X],
                 [0]),
    "prod": case(lambda n, x: n.math.prod(x, axis=0), [arr("pos")], [0]),
    "max": case(lambda n, x: n.math.max(x, axis=1), [X], [0]),
    "min": case(lambda n, x: n.math.min(x, axis=-1, keepdim=True), [X], [0]),
    "amax": case(lambda n, x: n.math.amax(x), [X], [0]),
    "amin": case(lambda n, x: n.math.amin(x, axis=0), [X], [0]),
    "nansum": case(lambda n, x: n.math.nansum(x, axis=1), [arr("nan")], [0]),
    "nanmean": case(lambda n, x: n.math.nanmean(x, axis=1), [arr("nan")],
                    [0]),
    "logsumexp": case(lambda n, x: n.math.logsumexp(x, axis=1), [X], [0]),
    "std": case(lambda n, x: n.math.std(x, axis=1), [X], [0]),
    "var": case(lambda n, x: n.math.var(x, unbiased=False), [X], [0]),
    "median": case(lambda n, x: (n.math.median(x, axis=1),
                                 n.math.median(x, keepdim=True)), [X], [0]),
    "argmax": case(lambda n, x: (n.math.argmax(x, axis=1),
                                 n.math.argmax(x)), [X]),
    "argmin": case(lambda n, x: n.math.argmin(x, axis=0, keepdim=True), [X]),
    "cumsum": case(lambda n, x, i: (n.math.cumsum(x, axis=1),
                                    n.math.cumsum(i)), [X, arr("int")], [0]),
    "cumprod": case(lambda n, x: n.math.cumprod(x, dim=1), [arr("pos")],
                    [0]),
    "count_nonzero": case(lambda n, i: n.math.count_nonzero(i, axis=1),
                          [arr("int")]),
    # math: products
    "matmul": case(lambda n, x, w: n.math.matmul(x, w, transpose_y=True),
                   [X, arr("x", (5, 4))], [0, 1]),
    "dot": binary("dot"),
    "bmm": case(lambda n, a, b: n.math.bmm(a, b),
                [arr("x", (2, 3, 4)), arr("x", (2, 4, 5))], [0, 1]),
    "inner": binary("inner"),
    "outer": case(lambda n, a, b: n.math.outer(a, b),
                  [arr("x", (3,)), arr("x", (4,))], [0, 1]),
    "addmm": case(lambda n, i, a, b: n.math.addmm(i, a, b, beta=0.5,
                                                  alpha=2.0),
                  [arr("x", (3, 5)), X, arr("x", (4, 5))], [0, 1, 2]),
    "kron": case(lambda n, a, b: n.math.kron(a, b),
                 [arr("x", (2, 2)), arr("x", (2, 3))], [0, 1]),
    "trace": case(lambda n, x: n.math.trace(x, offset=1), [X], [0]),
    "diagonal": case(lambda n, x: n.math.diagonal(x, offset=-1), [X], [0]),
    "mv": case(lambda n, a, v: n.math.mv(a, v), [X, arr("x", (4,))],
               [0, 1]),
    # math: sort/search
    "topk": case(lambda n, x: n.math.topk(x, 2, axis=1), [X], [0]),
    "sort": case(lambda n, x: n.math.sort(x, axis=1, descending=True), [X],
                 [0]),
    "argsort": case(lambda n, x, s: (n.math.argsort(x, axis=0,
                                                    descending=True),
                                     n.math.argsort(s, descending=True)),
                    [X, arr("small")]),
    "kthvalue": case(lambda n, x: n.math.kthvalue(x, 2, axis=1), [X], [0]),
    "mode": case(lambda n, x: n.math.mode(x, axis=1), [arr("small", (3, 7))]),
    "lerp": case(lambda n, x, y, w: n.math.lerp(x, y, w),
                 [X, Y, arr("p01")], [0, 1, 2]),
    "diff": case(lambda n, x: n.math.diff(x, axis=1), [X], [0]),
    "trapezoid": case(lambda n, x: n.math.trapezoid(x, dx=0.5), [X], [0]),
    "cummax": case(lambda n, x: n.math.cummax(x, axis=1), [X], [0]),
    "cummin": case(lambda n, x: n.math.cummin(x), [X], [0]),
    "logcumsumexp": case(lambda n, x: n.math.logcumsumexp(x, axis=1), [X],
                         [0]),
    "searchsorted": case(
        lambda n, s, v, s2, v2: (n.math.searchsorted(s, v),
                                 n.math.searchsorted(s, v, right=True),
                                 n.math.searchsorted(s2, v2)),
        [np.sort(arr("x", (6,))), X, np.sort(arr("x", (3, 5)), 1),
         arr("x", (3, 2), seed=4)]),
    "bucketize": case(lambda n, x, b: n.math.bucketize(x, b),
                      [X, np.sort(arr("x", (5,), seed=2))]),
    "renorm": case(lambda n, x: n.math.renorm(x, 2.0, 0, 1.0),
                   [2 * arr("x")], [0]),
    "quantile": case(lambda n, x: (n.math.quantile(x, [0.25, 0.5], axis=1),
                                   n.math.nanquantile(x, 0.3)), [X], [0]),
    "dist": binary("dist"),
    "angle": case(lambda n, x: n.math.angle(x), [X]),
    "conj": case(lambda n, c: n.math.conj(c), [arr("complex")], [0]),
    "real": case(lambda n, c: n.math.real(c), [arr("complex")], [0]),
    "imag": case(lambda n, c: n.math.imag(c), [arr("complex")], [0]),
    "complex": binary("complex"),
    "polar": binary("polar", "pos", "x"),
    "sgn": case(lambda n, c, x: (n.math.sgn(c), n.math.sgn(x)),
                [arr("complex"), X]),
    "signbit": case(lambda n, x: n.math.signbit(x), [X]),
    "ldexp": case(lambda n, x, i: n.math.ldexp(x, i), [X, arr("int")]),
    # manipulation
    "cast": case(lambda n, x: (n.manip.cast(x, "float16"),
                               n.manip.cast(x * 4, "int64")), [X], [0]),
    "reshape": case(lambda n, x: n.manip.reshape(x, [2, -1]), [X], [0]),
    "flatten": case(lambda n, x: n.manip.flatten(x, 1, 2),
                    [arr("x", (2, 3, 4))], [0]),
    "transpose": case(lambda n, x: n.manip.transpose(x, [2, 0, 1]),
                      [arr("x", (2, 3, 4))], [0]),
    "moveaxis": case(lambda n, x: n.manip.moveaxis(x, 0, 2),
                     [arr("x", (2, 3, 4))], [0]),
    "swapaxes": case(lambda n, x: n.manip.swapaxes(x, 0, 2),
                     [arr("x", (2, 3, 4))], [0]),
    "t": case(lambda n, x: n.manip.t(x), [X], [0]),
    "concat": case(lambda n, x, y: n.manip.concat([x, y], axis=1), [X, Y],
                   [0, 1]),
    "stack": case(lambda n, x, y: n.manip.stack([x, y], axis=1), [X, Y],
                  [0, 1]),
    "unstack": case(lambda n, x: n.manip.unstack(x, axis=1), [X], [0]),
    "split": case(lambda n, x: n.manip.split(x, [1, -1, 1], axis=1) +
                  n.manip.split(x, 3), [X], [0]),
    "squeeze": case(lambda n, x: (n.manip.squeeze(x, axis=[0, 1]),
                                  n.manip.squeeze(x)),
                    [arr("x", (1, 3, 1))], [0]),
    "unsqueeze": case(lambda n, x: n.manip.unsqueeze(x, [0, -1]), [X], [0]),
    "expand": case(lambda n, x: n.manip.expand(x, [2, 3, 4]),
                   [arr("x", (3, 1))], [0]),
    "tile": case(lambda n, x: n.manip.tile(x, [2, 1]), [X], [0]),
    "repeat_interleave": case(
        lambda n, x: (n.manip.repeat_interleave(x, 2, axis=1),
                      n.manip.repeat_interleave(x, 3)),
        [X], [0]),
    "flip": case(lambda n, x: n.manip.flip(x, [0, 1]), [X], [0]),
    "roll": case(lambda n, x: (n.manip.roll(x, 1, axis=1),
                               n.manip.roll(x, 2)), [X], [0]),
    "rot90": case(lambda n, x: n.manip.rot90(x, 1, [0, 1]), [X], [0]),
    "getitem": case(lambda n, x: (x[1:, ::-2], x[..., 1], x[None, -1],
                                  x[::-1, 2:0:-1]), [X], [0]),
    "slice": case(lambda n, x: n.manip.slice(x, [1], [1], [9]), [X], [0]),
    "strided_slice": case(
        lambda n, x: n.manip.strided_slice(x, [0, 1], [0, 3], [3, 0],
                                           [2, -2]), [X], [0]),
    "gather": case(lambda n, x, i: n.manip.gather(x, i, axis=1),
                   [X, I(3, 0, 3)], [0]),
    "take_along_axis": case(
        lambda n, x, i: n.manip.take_along_axis(x, i, axis=1),
        [X, np.array([[0, 3], [1, 1], [2, 0]], "int32")], [0]),
    "put_along_axis": case(
        lambda n, x, i, v: (n.manip.put_along_axis(x, i, v, 1, "add"),
                            n.manip.put_along_axis(x, i, 0.5, 1)),
        [X, np.array([[0, 3], [1, 2], [2, 0]], "int32"),
         arr("x", (3, 2))], [0, 2]),
    "gather_nd": case(lambda n, x, i: n.manip.gather_nd(x, i),
                      [X, np.array([[0, 1], [2, 3]], "int32")], [0]),
    "scatter": case(
        lambda n, x, i, u: (n.manip.scatter(x, i, u),
                            n.manip.scatter(x, i, u, overwrite=False)),
        [arr("x", (4, 3)), I(2, 0), arr("x", (2, 3), seed=1)], [0, 2]),
    "scatter_nd_add": case(
        lambda n, x, i, u: n.manip.scatter_nd_add(x, i, u),
        [X, np.array([[0, 1], [2, 3], [0, 1]], "int32"), arr("x", (3,))],
        [0, 2]),
    "index_select": case(lambda n, x, i: n.manip.index_select(x, i, axis=1),
                         [X, I(2, 2, 0)], [0]),
    "index_sample": case(lambda n, x, i: n.manip.index_sample(x, i),
                         [X, np.array([[0, 3], [1, 1], [2, 0]], "int32")],
                         [0]),
    "where": case(lambda n, c, x, y: n.manip.where(c, x, y),
                  [arr("bool"), X, Y], [1, 2]),
    "masked_fill": case(lambda n, x, m: n.manip.masked_fill(x, m, 0.5),
                        [X, arr("bool")], [0]),
    "fill_diagonal": case(lambda n, x: n.manip.fill_diagonal(x, 2.0, 1), [X],
                          [0]),
    "shard_index": case(lambda n, i: n.manip.shard_index(i, 20, 2, 1),
                        [np.arange(0, 20, 2, dtype="int32")]),
    "one_hot": case(lambda n, i: n.manip.one_hot(i, 5), [I(0, 4, 5, -1)]),
    "tensordot": case(lambda n, a, b: (n.manip.tensordot(a, b, 1),
                                       n.manip.tensordot(a, b, [[1], [0]])),
                      [X, arr("x", (4, 5))], [0, 1]),
    "as_complex": case(lambda n, x: n.manip.as_complex(x),
                       [arr("x", (3, 2))], [0]),
    "as_real": case(lambda n, c: n.manip.as_real(c), [arr("complex")], [0]),
    "crop": case(lambda n, x: (n.manip.crop(x, [2, 2], [1, 1]),
                               n.manip.crop(x, [2, -1], [2, 3])), [X], [0]),
    "take": case(lambda n, x, i: (n.manip.take(x, i),
                                  n.manip.take(x, i + 20, mode="wrap"),
                                  n.manip.take(x, i + 20, mode="clip")),
                 [X, I(-1, 3, 5)], [0]),
    "index_add": case(lambda n, x, i, v: n.manip.index_add(x, i, 0, v),
                      [X, I(2, 0), arr("x", (2, 4), seed=5)], [0, 2]),
    "index_put": case(lambda n, x, i, j, v: n.manip.index_put(x, (i, j), v),
                      [X, I(0, 2), I(1, 3), arr("x", (2,))], [0, 3]),
    "masked_scatter": case(
        lambda n, x, m, v: n.manip.masked_scatter(x, m, v),
        [X, arr("bool"), arr("x", (12,), seed=6)], [0, 2]),
    "unflatten": case(lambda n, x: n.manip.unflatten(x, 1, [2, -1]), [X],
                      [0]),
    # logic
    **{k: cmp(k) for k in ("greater_than", "greater_equal", "less_than",
                           "less_equal")},
    **{k: cmp(k, "int", "int") for k in ("equal", "not_equal", "bitwise_and",
                                         "bitwise_or", "bitwise_xor")},
    **{k: cmp(k, "bool", "bool") for k in ("logical_and", "logical_or",
                                           "logical_xor")},
    "logical_not": case(lambda n, b: n.logic.logical_not(b), [arr("bool")]),
    "bitwise_not": case(lambda n, i: n.logic.bitwise_not(i), [arr("int")]),
    "all": case(lambda n, b: (n.logic.all(b, axis=1), n.logic.all(b)),
                [arr("bool")]),
    "any": case(lambda n, b: (n.logic.any(b, axis=0, keepdim=True),
                              n.logic.any(b)), [arr("bool")]),
    "isclose": case(lambda n, x, y: n.logic.isclose(x, y, atol=0.3),
                    [X, Y]),
    "allclose": case(lambda n, x, y: (n.logic.allclose(x, y),
                                      n.logic.allclose(x, x)), [X, Y]),
    "equal_all": case(lambda n, i, j: (n.logic.equal_all(i, i),
                                       n.logic.equal_all(i, j)),
                      [arr("int"), arr("int", seed=1)]),
    # linalg
    "norm": case(lambda n, x: (n.linalg.norm(x), n.linalg.norm(x, p=1,
                                                               axis=1),
                               n.linalg.norm(x, p=float("inf"), axis=0)),
                 [X], [0]),
    "cholesky": case(lambda n, a: n.linalg.cholesky(a, upper=True),
                     [arr("spd", (4, 4))], [0]),
    "inverse": case(lambda n, a: n.linalg.inverse(a), [arr("spd", (4, 4))],
                    [0]),
    "pinv": case(lambda n, a: n.linalg.pinv(a), [X], [0]),
    "det": case(lambda n, a: n.linalg.det(a), [arr("spd", (3, 3)) / 3], [0]),
    "slogdet": case(lambda n, a: n.linalg.slogdet(a), [arr("spd", (4, 4))],
                    [0]),
    "matrix_power": case(lambda n, a: n.linalg.matrix_power(a, 3),
                         [arr("spd", (3, 3)) / 4], [0]),
    "matrix_rank": case(lambda n, a: n.linalg.matrix_rank(a),
                        [X @ np.diag([1, 1, 1, 0]).astype("f4")]),
    "svd": case(lambda n, a: abs_all(n, n.linalg.svd(a)), [X], [0]),
    "qr": case(lambda n, a: abs_all(n, n.linalg.qr(a)), [arr("x", (4, 3))],
               [0]),
    "eigh": case(lambda n, a: abs_all(n, n.linalg.eigh(a)),
                 [arr("spd", (4, 4))], [0]),
    "eigvalsh": case(lambda n, a: n.linalg.eigvalsh(a), [arr("spd", (4, 4))],
                     [0]),
    "solve": case(lambda n, a, b: n.linalg.solve(a, b),
                  [arr("spd", (4, 4)), arr("x", (4, 2))], [0, 1]),
    "triangular_solve": case(
        lambda n, a, b: (n.linalg.triangular_solve(a, b, upper=False),
                         n.linalg.triangular_solve(a, b, upper=False,
                                                   transpose=True)),
        [arr("lower", (4, 4)), arr("x", (4, 2))], [0, 1]),
    "cholesky_solve": case(
        lambda n, b, lo: n.linalg.cholesky_solve(b, lo),
        [arr("x", (4, 2)), np.linalg.cholesky(arr("spd", (4, 4)))
         .astype("f4")], [0, 1]),
    "lstsq": case(lambda n, a, b: n.linalg.lstsq(a, b),
                  [arr("x", (5, 3)), arr("x", (5, 2))], [0, 1]),
    "cross": case(lambda n, a, b: n.linalg.cross(a, b),
                  [arr("x", (2, 3)), arr("x", (2, 3), seed=1)], [0, 1]),
    "histogram": case(lambda n, x: n.linalg.histogram(x, bins=5, min=-1,
                                                      max=1), [X]),
    # sequence ops ([B, T, ...] padded, [B] lengths)
    **{f"sequence_pool_{p}": case(
        lambda n, x, lens, p=p: n.seq.sequence_pool(x, lens, pool_type=p),
        [SEQ, LENS], [0], op="sequence_pool")
       for p in ("sum", "average", "sqrt", "max", "first", "last")},
    "sequence_reverse": case(lambda n, x, lens: n.seq.sequence_reverse(
        x, lens), [SEQ, LENS], [0]),
    "sequence_softmax": case(lambda n, x, lens: n.seq.sequence_softmax(
        x, lens), [SEQ2, LENS], [0]),
    "sequence_expand": case(lambda n, x: n.seq.sequence_expand(
        x, repeats=(2, 0, 1)), [X], [0]),
    "sequence_first_step": case(
        lambda n, x: n.seq.sequence_first_step(x), [SEQ], [0]),
    "sequence_last_step": case(
        lambda n, x, lens: n.seq.sequence_last_step(x, lens), [SEQ, LENS],
        [0]),
    "sequence_conv": case(
        lambda n, x, lens, w: n.seq.sequence_conv(x, lens, w,
                                                  context_length=3),
        [SEQ, LENS, arr("x", (9, 2))], [0, 2]),
    "sequence_slice": case(
        lambda n, x, lens, o, ln: n.seq.sequence_slice(x, lens, o, ln),
        [SEQ, LENS, I(1, 0), I(3, 2)], [0]),
    "sequence_concat": case(
        lambda n, a, la, b, lb: n.seq.sequence_concat(a, la, b, lb),
        [SEQ, LENS, arr("x", (2, 4, 3), seed=3), I(2, 4)], [0, 2]),
    "sequence_erase": case(
        lambda n, x, lens: n.seq.sequence_erase(x, lens, tokens=(2, 3)),
        [IDS, LENS]),
    "sequence_enumerate": case(
        lambda n, x, lens: n.seq.sequence_enumerate(x, lens, win_size=3,
                                                    pad_value=-1),
        [IDS, LENS]),
    "sequence_topk_avg_pooling": case(
        lambda n, x, lens: n.seq.sequence_topk_avg_pooling(x, lens,
                                                           topks=(1, 3)),
        [SEQ2, LENS], [0]),
    "sequence_pad": case(
        lambda n, x, lens: n.seq.sequence_pad_op(x, lens, 0.5, maxlen=7),
        [SEQ, LENS], [0]),
    "sequence_unpad": case(
        lambda n, x, lens: n.seq.sequence_unpad_op(x, lens), [SEQ, LENS],
        [0]),
    "sequence_reshape": case(
        lambda n, x, lens: n.seq.sequence_reshape(x, lens, new_dim=1),
        [SEQ, LENS], [0]),
    "sequence_scatter": case(
        lambda n, x, i, u, lens: n.seq.sequence_scatter(x, i, u, lens),
        [arr("x", (2, 6)), np.array([[0, 2, 5], [1, 1, 3]], "int32"),
         arr("x", (2, 3), seed=2), I(3, 2)]),
    "sequence_expand_as": case(
        lambda n, x, lens: n.seq.sequence_expand_as(x, lens, maxlen=6),
        [arr("x", (2, 3)), LENS], [0]),
    # the registered attention op: K1-K3's route (`plain` on the CPU,
    # JAX's Pallas kernels in interpret mode)
    "flash_attention": case(
        lambda n, q, k, v: n.flash.flash_attention(q, k, v, causal=True,
                                                   layout="bshd"),
        [arr("x", (1, 128, 2, 64), s) for s in (0, 1, 2)], [0, 1, 2]),
    **NN_CASES,
    **LEGACY_CASES,
}


def op_name(case_name):
    """The registered op a case exercises."""
    return CASES[case_name].get("op", case_name)


# ---------------------------------------------------------------- runner

def cotangent(name, i, shape):
    """The fixed random weights of output i in a case's loss."""
    r = np.random.RandomState(zlib.crc32(f"{name}/{i}".encode()))
    return r.uniform(-1, 1, shape).astype("f4")


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def host(t):
    a = np.asarray(t.numpy())
    return a.astype("f4") if a.dtype.name == "bfloat16" else a


def inputs(n, name):
    """The case's input Tensors on the current place (the differentiated
    ones with stop_gradient=False)."""
    c = CASES[name]
    return [n.P.to_tensor(a, stop_gradient=i not in c["diff"])
            for i, a in enumerate(c["inputs"])]


def call(n, name, ts):
    """The case's op(s) on input Tensors `ts`: a tuple of output Tensors."""
    out = CASES[name]["fn"](n, *ts)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def grads(n, name, ts, outs):
    """Backward from the sum of each float output times its `cotangent`
    (real and imaginary parts weighted apart for a complex one): the
    differentiated inputs' `.grad` Tensors (or None)."""
    loss = None
    for i, o in enumerate(outs):
        kind = dtype_name(o)
        if o.stop_gradient or not ("float" in kind or "complex" in kind):
            continue
        w = n.P.to_tensor(cotangent(name, i, o.shape))
        if "complex" in kind:
            term = (n.math.real(o) * w).sum() + \
                (n.math.imag(o) * w * 0.5).sum()
        else:
            term = (n.manip.cast(o, "float32") * w).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [ts[i].grad for i in CASES[name]["diff"]]


def run(n, name):
    """Case `name` through namespace `n` on its package's current place:
    ([(dtype name, numpy value)] of the outputs, [numpy gradient or None]
    of the differentiated inputs, or None when there are none)."""
    ts = inputs(n, name)
    outs = call(n, name, ts)
    fwd = [(dtype_name(o), host(o)) for o in outs]
    if not CASES[name]["diff"]:
        return fwd, None
    return fwd, [None if g is None else host(g)
                 for g in grads(n, name, ts, outs)]
