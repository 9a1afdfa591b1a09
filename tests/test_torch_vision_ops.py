"""The port's detection ops (`vision/ops.py`) against the JAX package's
on the CPU.

The 37 registered ops of `vision/ops.py` and `quantization.py`'s
`fake_quantize_dequantize` (the `VISION_CASES` of
`tests/torch_op_cases.py`, through `test_torch_ops.check_case`: forward
values, dtypes and the gradients of a seeded projection; a third of
them here, two thirds in `tests/test_torch_vision_ops_2.py`, so that
another test worker takes them and each file runs in about a minute
alone). Then YOLOv3's
loss and its gradient at two head scales of a small model, `yolo_box`
and `multiclass_nms` over the decoded heads, `nms` through its wrappers,
the sampling host ops under their seeds, the RoI family's refusal of
multi-image batches, and the top-level exports.

Tolerances (f32): forward values within 1e-5 x max(1, |ref|), gradients
within 1e-4 x max(1, max|g|) (`check_case`'s); the YOLOv3 loss within
1e-5 relative and its gradient within 1e-4 x max(1, max|g|); integer
outputs, the host ops' outputs (`multiclass_nms`, the samplers) and the
kept indices exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops
from test_torch_ops import check_case
from torch_op_cases import VISION_CASES

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.mark.parametrize("name", sorted(VISION_CASES)[0::3])
def test_op_matches_jax(name):
    check_case(name)


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_RTOL * scale, f"{what}: {err} > {GRAD_RTOL} x {scale}"


# a small YOLOv3: 6 anchors over two heads, 4 classes, 7 gt rows an image
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
YOLO_HEADS = (([3, 4, 5], 16, 4), ([0, 1, 2], 8, 8))   # (mask, stride, H)
YOLO_C = 4


def _yolo_inputs(seed=0):
    r = np.random.RandomState(seed)
    heads = [r.uniform(-3, 3, (2, 3 * (5 + YOLO_C), h, h)).astype("f4")
             for _, _, h in YOLO_HEADS]
    box = np.concatenate([r.uniform(0.05, 0.95, (2, 7, 2)),
                          r.uniform(0.05, 0.8, (2, 7, 2))], 2).astype("f4")
    box[0, 5:] = 0.0                      # padding rows
    label = r.randint(0, YOLO_C, (2, 7)).astype("int32")
    score = r.uniform(0.3, 1.0, (2, 7)).astype("f4")
    return heads, box, label, score


def _yolo_loss(P, heads, box, label, score, label_smooth):
    """The two heads' losses summed, and each head's gradient."""
    xs = [P.to_tensor(h, stop_gradient=False) for h in heads]
    total = None
    for x, (mask, stride, _) in zip(xs, YOLO_HEADS):
        loss = P.vision.ops.yolov3_loss(
            x, P.to_tensor(box), P.to_tensor(label), YOLO_ANCHORS, mask,
            YOLO_C, 0.6, stride, gt_score=P.to_tensor(score),
            use_label_smooth=label_smooth)
        total = loss if total is None else total + loss
    total.sum().backward()
    return total.numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("label_smooth", [True, False])
def test_yolov3_loss_and_gradient_at_two_scales_match_jax(label_smooth):
    heads, box, label, score = _yolo_inputs()
    jl, jg = _yolo_loss(pj, heads, box, label, score, label_smooth)
    tl, tg = _yolo_loss(pt, heads, box, label, score, label_smooth)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (jl > 0).all()
    for k, (t, j) in enumerate(zip(tg, jg)):
        assert np.abs(j).max() > 0
        _grad_close(t, j, f"head {k}")


def test_yolo_box_then_multiclass_nms_match_jax():
    """Both heads decoded by yolo_box (within 1e-5 x max(1, |ref|)), then
    the JAX decode's boxes and scores through both packages'
    multiclass_nms: the kept rows and counts equal."""
    heads, _, _, _ = _yolo_inputs(1)
    size = np.array([[64, 64], [48, 80]], "int32")
    decoded = {}
    for name, P in (("jax", pj), ("port", pt)):
        outs = [P.vision.ops.yolo_box(P.to_tensor(h), P.to_tensor(size),
                                      [YOLO_ANCHORS[2 * m + i] for m in mask
                                       for i in (0, 1)], YOLO_C,
                                      conf_thresh=0.2,
                                      downsample_ratio=stride)
                for h, (mask, stride, _) in zip(heads, YOLO_HEADS)]
        decoded[name] = [np.concatenate([o[k].numpy() for o in outs], 1)
                         for k in (0, 1)]
    for t, j in zip(decoded["port"], decoded["jax"]):
        err = np.abs(t - j) / np.maximum(1.0, np.abs(j))
        assert err.max() <= 1e-5
    boxes, scores = decoded["jax"]
    scores = np.ascontiguousarray(scores.transpose(0, 2, 1))
    assert (scores > 0.05).sum() > 20
    got = {}
    for name, P in (("jax", pj), ("port", pt)):
        out, count = P.vision.ops.multiclass_nms(
            P.to_tensor(boxes), P.to_tensor(scores), score_threshold=0.05,
            nms_top_k=40, keep_top_k=12, nms_threshold=0.45,
            normalized=False, background_label=-1)
        got[name] = (out.numpy(), count.numpy())
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    assert (got["jax"][1] > 0).all()


def test_nms_keeps_jax_indices_on_a_larger_set():
    r = np.random.RandomState(3)
    xy = r.uniform(0, 40, (64, 2))
    boxes = np.concatenate([xy, xy + r.uniform(4, 12, (64, 2))], 1) \
        .astype("f4")
    scores = r.permutation(64).astype("f4") / 64
    for kw in ({"iou_threshold": 0.4}, {"iou_threshold": 0.6, "top_k": 20},
               {"iou_threshold": 0.5, "score_threshold": 0.3}):
        want = jops.nms(pj.to_tensor(boxes), pj.to_tensor(scores), **kw)
        got = tops.nms(pt.to_tensor(boxes), pt.to_tensor(scores), **kw)
        assert str(got.numpy().dtype) == "int32"
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_sampling_host_ops_draw_jax_samples(seed):
    """The seeded host samplers (RandomState(seed) draws) give JAX's
    anchors, RoIs and tree nodes exactly."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, 80, (60, 2))
    anchors = np.concatenate([xy, xy + r.uniform(8, 24, (60, 2))], 1) \
        .astype("f4")
    gxy = r.uniform(0, 70, (4, 2))
    gt = np.concatenate([gxy, gxy + r.uniform(10, 30, (4, 2))], 1) \
        .astype("f4")
    classes = r.randint(1, 5, (4,)).astype("int32")
    travel = np.array([[1, 3], [1, 4], [2, 5], [2, 6]], "int32")
    layers = np.array([[1, 2, 0, 0], [3, 4, 5, 6]], "int32")
    leaves = r.randint(0, 4, (6,)).astype("int32")
    calls = [("rpn_target_assign", (anchors, gt),
              {"rpn_batch_size_per_im": 16, "seed": seed,
               "rpn_positive_overlap": 0.5}),
             ("generate_proposal_labels", (anchors, gt, classes),
              {"batch_size_per_im": 16, "fg_fraction": 0.25, "seed": seed,
               "fg_thresh": 0.3, "bg_thresh_hi": 0.3}),
             ("tdm_sampler", (leaves, travel, layers),
              {"neg_samples_list": (1, 2), "seed": seed})]
    for op, arrays, attrs in calls:
        outs = {}
        for name, d in (("jax", pj.ops.dispatch), ("port",
                                                   pt.ops.dispatch)):
            res = d.apply(d.OP_REGISTRY[op], tuple(arrays), attrs, name=op)
            outs[name] = [o.numpy() for o in res]
        for t, j in zip(outs["port"], outs["jax"]):
            assert t.dtype == j.dtype, op
            np.testing.assert_array_equal(t, j, err_msg=op)


@pytest.mark.parametrize("op", ["roi_align", "roi_pool", "psroi_pool",
                                "prroi_pool"])
def test_roi_ops_take_one_image_like_jax(op):
    x = np.zeros((2, 4, 6, 6), "f4")
    boxes = np.array([[0, 0, 3, 3]], "f4")
    for P in (pj, pt):
        fn = getattr(P.vision.ops, op)
        with pytest.raises(NotImplementedError) as batch:
            fn(P.to_tensor(x), P.to_tensor(boxes), output_size=2)
        with pytest.raises(NotImplementedError) as counted:
            fn(P.to_tensor(x[:1]), P.to_tensor(boxes),
               boxes_num=P.to_tensor(np.array([1], "int32")),
               output_size=2)
        msgs = (str(batch.value), str(counted.value))
        if P is pj:
            want = msgs
        else:
            assert msgs == want


def test_pool_then_unpool_gradient_reaches_the_input():
    """The port's gradient from max_unpool2d back through
    max_pool2d_with_index is the chain rule of the JAX package's two
    vjps; the JAX tape itself loses it (x.grad stays None: ROADMAP Queue
    3, reference caveats)."""
    x = np.random.RandomState(4).uniform(-1, 1, (2, 3, 6, 8)).astype("f4")
    cot = np.random.RandomState(5).uniform(-1, 1, (2, 3, 6, 8)) \
        .astype("f4")
    # JAX, one op at a time: the unpool's gradient in its pooled input,
    # then the pool's gradient under that cotangent
    jx = pj.to_tensor(x, stop_gradient=False)
    pooled, idx = jops.max_pool2d_with_index(jx, 2)
    jv = pj.to_tensor(pooled.numpy(), stop_gradient=False)
    (jops.max_unpool2d(jv, idx, 2) * pj.to_tensor(cot)).sum().backward()
    (pooled * pj.to_tensor(jv.grad.numpy())).sum().backward()
    want = jx.grad.numpy()
    # the chained JAX call leaves x without a gradient
    jx2 = pj.to_tensor(x, stop_gradient=False)
    (jops.max_unpool2d(*jops.max_pool2d_with_index(jx2, 2), 2)
     * pj.to_tensor(cot)).sum().backward()
    assert jx2.grad is None
    tx = pt.to_tensor(x, stop_gradient=False)
    (tops.max_unpool2d(*tops.max_pool2d_with_index(tx, 2), 2)
     * pt.to_tensor(cot)).sum().backward()
    _grad_close(tx.grad.numpy(), want, "pool -> unpool")
    assert np.abs(want).max() > 0


def test_public_names_match_jax():
    """Every public name of the JAX module is the port's, and neither has
    `deform_conv2d`, which `paddle_tpu/fluid/layers.py:1207` imports
    (ROADMAP Queue 3, reference caveats)."""
    def public(mod):
        return {k for k, v in vars(mod).items()
                if not k.startswith("_") and callable(v)
                and getattr(v, "__module__", "") == mod.__name__}
    assert public(jops) - {"Tensor"} <= public(tops) | {"Tensor"}
    assert not hasattr(jops, "deform_conv2d")
    assert not hasattr(tops, "deform_conv2d")
    assert pt.vision.ops is tops
    assert tops.iou_similarity is tops.box_iou


def test_prior_box_matches_jax_and_stays_on_the_input_device():
    feat = np.zeros((1, 8, 3, 4), "f4")
    image = np.zeros((1, 3, 24, 32), "f4")
    kw = dict(min_sizes=[4.0, 8.0], max_sizes=[6.0, 12.0],
              aspect_ratios=(1.0, 2.0), flip=True, clip=True)
    want = jops.prior_box(pj.to_tensor(feat), pj.to_tensor(image), **kw)
    got = tops.prior_box(pt.to_tensor(feat), pt.to_tensor(image), **kw)
    for t, j in zip(got, want):
        assert t._data.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), j.numpy())
