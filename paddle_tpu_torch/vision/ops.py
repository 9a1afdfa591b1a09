"""paddle.vision.ops — the detection operator set (the port of
`paddle_tpu/vision/ops.py`; ref python/paddle/vision/ops.py and
paddle/fluid/operators/detection/).

Every op is a raw torch form in OP_REGISTRY, run by the eager dispatcher
where its inputs are, with the JAX package's fixed-shape contracts:

  * the dense device ops (box geometry, `yolo_box`, `yolov3_loss`, the
    RoI family, the layout ops) are torch ops on the inputs' device, and
    torch autograd gives the gradients the JAX package's `jax.vjp` does.
    `nms` is the JAX package's fixed-shape keep mask: N rounds of
    vectorised suppression on the device, no host read inside the loop,
    so a CUDA graph can capture it; its wrapper reads the kept count
    back only when `top_k` is None, as the JAX wrapper does.
    `yolov3_loss` and `yolo_box` build their anchor constants with fill
    kernels, not host copies, so they capture too;
  * the RoI ops take one image (`x` of batch 1, no `boxes_num`), and
    refuse anything else with the JAX package's error;
  * the host ops (`multiclass_nms`, `bipartite_match`,
    `generate_proposals`, the target assigners, `detection_map`,
    `similarity_focus`, `tdm_sampler`, `generate_mask_labels`) run in
    numpy as the JAX package runs them: a CUDA input is copied to the
    host, and the results come back to its device. The seeded
    `np.random.RandomState(seed)` draws are the JAX package's, so both
    sample the same anchors, RoIs and tree nodes.
"""
import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.tensor import Tensor
from ..ops.dispatch import apply, as_array, register_op


def _np(t):
    """A raw input (a torch tensor) as a host numpy array, bf16 and f16
    widened to f32 (numpy has no bf16)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _back(a, like):
    """Numpy `a` as a torch tensor on the device of tensor `like`."""
    return torch.from_numpy(np.array(a)).to(like.device)


def _consts(vals, like):
    """A [len(vals)] tensor of `like`'s dtype and device, built by fill
    kernels (no host copy, so a CUDA graph may capture it)."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype,
                                   device=like.device) for v in vals])


def _div(t, n):
    """t / n, a true division on every device: torch multiplies a CUDA
    tensor divided by a Python number by the number's rounded
    reciprocal, an ulp off the CPU's quotient, which moves a RoI's
    sample positions and bin edges off the CPU's (and the JAX
    package's)."""
    return t / torch.full((), float(n), dtype=t.dtype, device=t.device)


def _arange(n, like):
    return torch.arange(n, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------------- iou

def _box_iou_raw(a, b):
    """a: [N, 4], b: [M, 4] (x1, y1, x2, y2) -> [N, M] IoU."""
    area_a = torch.clamp(a[:, 2] - a[:, 0], min=0) * \
        torch.clamp(a[:, 3] - a[:, 1], min=0)
    area_b = torch.clamp(b[:, 2] - b[:, 0], min=0) * \
        torch.clamp(b[:, 3] - b[:, 1], min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


register_op("box_iou", _box_iou_raw)


def box_iou(boxes1, boxes2, name=None):
    return apply(_box_iou_raw, (boxes1, boxes2), name="box_iou")


iou_similarity = box_iou        # ref detection/iou_similarity_op.cc


# ------------------------------------------------------------------- nms

def _nms_raw(boxes, scores, iou_threshold=0.5, score_threshold=None):
    """Greedy NMS as a fixed-shape suppression mask (1 = kept): N rounds,
    each suppressing against the best live box, all on the device."""
    n = boxes.shape[0]
    iou = _box_iou_raw(boxes, boxes)
    live = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    if score_threshold is not None:
        live = live & (scores > score_threshold)
    kept = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    idx = torch.arange(n, device=boxes.device)
    neg = torch.full_like(scores, -float("inf"))
    for _ in range(n):
        # the best live box as a [1] tensor, never a host integer: each
        # round is device work only
        best = torch.argmax(torch.where(live, scores, neg)).view(1)
        is_best = idx == best
        take = (live & is_best).any()
        kept = kept | (is_best & take)
        # suppress neighbours of the chosen box (and itself)
        suppress = (torch.index_select(iou, 0, best)[0] >= iou_threshold) \
            | is_best
        live = live & ~(suppress & take)
    return kept


register_op("nms", _nms_raw)


def nms(boxes, scores, iou_threshold=0.5, score_threshold=None, top_k=None,
        name=None):
    """ref python/paddle/vision/ops.py nms — returns kept indices sorted by
    score (fixed count when top_k given; else a dynamic-size host slice)."""
    kept = apply(_nms_raw, (boxes, scores),
                 {"iou_threshold": float(iou_threshold),
                  "score_threshold": None if score_threshold is None
                  else float(score_threshold)},
                 differentiable=False, name="nms")
    k = as_array(kept)
    s = as_array(scores).detach()
    ranked = torch.argsort(torch.where(k, s, torch.full_like(
        s, -float("inf"))), stable=True).flip(0).to(torch.int32)
    n_kept = k.sum()
    if top_k is not None:
        # fixed shape: positions past the kept count are -1, never a
        # suppressed box's real index
        pos = torch.arange(int(top_k), device=k.device)
        return Tensor._wrap(torch.where(pos < n_kept, ranked[:top_k],
                                        torch.full_like(ranked[:top_k], -1)))
    n_keep = int(n_kept)                        # host sync: dynamic count
    return Tensor._wrap(ranked[:n_keep])


# --------------------------------------------------------------- box_coder

def _box_coder_raw(prior_box, prior_box_var, target_box,
                   code_type="encode_center_size", box_normalized=True,
                   axis=0):
    """ref detection/box_coder_op.h: encode/decode between corner boxes and
    center-size offsets."""
    norm = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + norm
    ph = prior_box[:, 3] - prior_box[:, 1] + norm
    px = prior_box[:, 0] + pw * 0.5
    py = prior_box[:, 1] + ph * 0.5
    if prior_box_var is None:
        var = torch.ones((4,), dtype=target_box.dtype,
                         device=target_box.device)
    else:
        var = prior_box_var
    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0] + norm
        th = target_box[:, 3] - target_box[:, 1] + norm
        tx = target_box[:, 0] + tw * 0.5
        ty = target_box[:, 1] + th * 0.5
        out = torch.stack([
            (tx - px) / pw, (ty - py) / ph,
            torch.log(torch.clamp(tw / pw, min=1e-10)),
            torch.log(torch.clamp(th / ph, min=1e-10))], dim=1)
        return out / var
    # decode: target_box holds offsets [N, 4]
    off = target_box * var
    ox = off[:, 0] * pw + px
    oy = off[:, 1] * ph + py
    ow = torch.exp(off[:, 2]) * pw
    oh = torch.exp(off[:, 3]) * ph
    return torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                        ox + ow * 0.5 - norm, oy + oh * 0.5 - norm], dim=1)


register_op("box_coder", _box_coder_raw)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    if prior_box_var is None:
        return apply(lambda p, t, **kw: _box_coder_raw(p, None, t, **kw),
                     (prior_box, target_box),
                     {"code_type": code_type,
                      "box_normalized": bool(box_normalized)},
                     name="box_coder")
    return apply(_box_coder_raw, (prior_box, prior_box_var, target_box),
                 {"code_type": code_type,
                  "box_normalized": bool(box_normalized)}, name="box_coder")


# --------------------------------------------------------------- prior_box

def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """SSD prior boxes (ref detection/prior_box_op.cc), made on the host in
    numpy (data-independent constants per feature-map shape) and placed
    on `input`'s device."""
    feat = as_array(input)
    in_h, in_w = feat.shape[-2:]
    img_h, img_w = as_array(image).shape[-2:]
    step_w = steps[0] or img_w / in_w
    step_h = steps[1] or img_h / in_h
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    boxes = []
    for y in range(in_h):
        for x in range(in_w):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for k, ms in enumerate(min_sizes):
                for ar in ars:
                    bw = ms * np.sqrt(ar) * 0.5
                    bh = ms / np.sqrt(ar) * 0.5
                    boxes.append([(cx - bw) / img_w, (cy - bh) / img_h,
                                  (cx + bw) / img_w, (cy + bh) / img_h])
                if max_sizes:
                    s = np.sqrt(ms * max_sizes[k]) * 0.5
                    boxes.append([(cx - s) / img_w, (cy - s) / img_h,
                                  (cx + s) / img_w, (cy + s) / img_h])
    out = np.asarray(boxes, np.float32).reshape(in_h, in_w, -1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          out.shape).copy()
    return Tensor._wrap(_back(out, feat)), Tensor._wrap(_back(var, feat))


# --------------------------------------------------------------- yolo_box

def _yolo_box_raw(x, img_size, anchors=(), class_num=1, conf_thresh=0.01,
                  downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    """ref detection/yolo_box_op.h — decode YOLOv3 head output [N, C, H, W]
    into boxes [N, H*W*na, 4] + scores [N, H*W*na, class_num]."""
    n, c, h, w = x.shape
    na = len(anchors) // 2
    an = _consts(anchors, x).reshape(na, 2)
    x = x.reshape(n, na, 5 + class_num, h, w)
    gx = _arange(w, x)[None, None, None, :]
    gy = _arange(h, x)[None, None, :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(x[:, :, 0]) * alpha + beta + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) * alpha + beta + gy) / h
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / \
        (w * downsample_ratio)
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / \
        (h * downsample_ratio)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img_h = img_size[:, 0].to(x.dtype)[:, None, None, None]
    img_w = img_size[:, 1].to(x.dtype)[:, None, None, None]
    x1 = (bx - bw * 0.5) * img_w
    y1 = (by - bh * 0.5) * img_h
    x2 = (bx + bw * 0.5) * img_w
    y2 = (by + bh * 0.5) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    mask = (conf > conf_thresh)[..., None]
    probs = probs.permute(0, 1, 3, 4, 2)
    scores = torch.where(mask, probs, torch.zeros_like(probs)).reshape(
        n, -1, class_num)
    return boxes, scores


register_op("yolo_box", _yolo_box_raw)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None,
             scale_x_y=1.0):
    boxes, scores = apply(
        _yolo_box_raw, (x, img_size),
        {"anchors": tuple(int(a) for a in anchors),
         "class_num": int(class_num), "conf_thresh": float(conf_thresh),
         "downsample_ratio": int(downsample_ratio),
         "clip_bbox": bool(clip_bbox), "scale_x_y": float(scale_x_y)},
        name="yolo_box")
    return boxes, scores


# ------------------------------------------------------------ RoI helpers

# the JAX package's refusal of multi-image RoI batches, by op
_ONE_IMAGE = {
    "roi_align": "multi-image batches (boxes_num) not supported yet — pass "
                 "one image per call (vmap over images for batches)",
    "roi_pool": "pass one image per call (vmap over images for batches)",
    "psroi_pool": "pass one image per call",
    "prroi_pool": "pass one image per call",
}


def _one_image(op, x, boxes_num):
    if boxes_num is not None or as_array(x).shape[0] != 1:
        raise NotImplementedError(f"{op}: {_ONE_IMAGE[op]}")


def _bilinear(img, yy, xx, h, w):
    """Bilinear samples of `img` [C, H*W] at every (yy, xx) pair of the
    broadcast shapes of `yy` and `xx` (the JAX package's clamped corner
    rule): [C, *shape]."""
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(yy - y0, 0, 1)
    wx = torch.clamp(xx - x0, 0, 1)
    y0i, x0i, y1i, x1i = (y0.long(), x0.long(), y1.long(), x1.long())
    v00 = img[:, y0i * w + x0i]
    v01 = img[:, y0i * w + x1i]
    v10 = img[:, y1i * w + x0i]
    v11 = img[:, y1i * w + x1i]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx)


# --------------------------------------------------------------- roi_align

def _roi_align_raw(x, boxes, boxes_num=None, output_size=(1, 1),
                   spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    """ref roi_align_op.h: bilinear-sampled average pooling per RoI.
    x: [N, C, H, W]; boxes: [R, 4] in input coords; boxes are all on image 0
    (the single-image path). Returns [R, C, ph, pw]."""
    n, c, h, w = x.shape
    ph, pw = output_size
    off = 0.5 if aligned else 0.0
    img = x[0].reshape(c, h * w)
    b = boxes * spatial_scale
    x1, y1 = b[:, 0] - off, b[:, 1] - off
    x2, y2 = b[:, 2] - off, b[:, 3] - off
    rw = torch.clamp(x2 - x1, min=1.0 if not aligned else 1e-3)
    rh = torch.clamp(y2 - y1, min=1.0 if not aligned else 1e-3)
    bin_w = _div(rw, pw)[:, None, None]
    bin_h = _div(rh, ph)[:, None, None]
    s = sampling_ratio if sampling_ratio > 0 else 2
    # sample grid: rows [R, ph, s], columns [R, pw, s]
    iy = (_arange(ph, b)[None, :, None] * bin_h + y1[:, None, None] +
          _div((_arange(s, b)[None, None, :] + 0.5) * bin_h, s))
    ix = (_arange(pw, b)[None, :, None] * bin_w + x1[:, None, None] +
          _div((_arange(s, b)[None, None, :] + 0.5) * bin_w, s))
    r = boxes.shape[0]
    vals = _bilinear(img, iy.reshape(r, ph * s, 1),
                     ix.reshape(r, 1, pw * s), h, w)   # [C, R, ph*s, pw*s]
    # average over the s*s samples in each bin
    vals = vals.reshape(c, r, ph, s, pw, s).mean(dim=(3, 5))
    return vals.permute(1, 0, 2, 3)


register_op("roi_align", _roi_align_raw)


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    _one_image("roi_align", x, boxes_num)
    return apply(_roi_align_raw, (x, boxes),
                 {"output_size": tuple(output_size),
                  "spatial_scale": float(spatial_scale),
                  "sampling_ratio": int(sampling_ratio),
                  "aligned": bool(aligned)}, name="roi_align")


# --------------------------------------------------------- roi pool family

def _bin_masks(lo, size, n_bins, extent, like):
    """[R, n_bins, extent] masks of the pixels in each quantised bin
    [floor(lo + i*size), ceil(lo + (i+1)*size)) (the JAX package's bin
    rule), lo and size [R]."""
    i = _arange(n_bins, like)[None, :]
    start = torch.floor(lo[:, None] + i * size[:, None])
    end = torch.ceil(lo[:, None] + (i + 1) * size[:, None])
    px = torch.arange(extent, device=like.device)[None, None, :]
    return (px >= start[..., None]) & (px < end[..., None])


def _roi_pool_raw(x, boxes, output_size=(1, 1), spatial_scale=1.0):
    """Quantized max-pool ROI pooling (ref operators/roi_pool_op.cc): bin
    boundaries floor/ceil'd to integer pixels, max over each bin, 0 for an
    empty bin. The bin mask is rows x columns, so the max is taken over
    each bin's columns, then over its rows. x: [1, C, H, W],
    boxes: [R, 4] -> [R, C, ph, pw]."""
    ph, pw = output_size
    img = x[0]
    c, h, w = img.shape
    x1 = torch.round(boxes[:, 0] * spatial_scale)
    y1 = torch.round(boxes[:, 1] * spatial_scale)
    x2 = torch.round(boxes[:, 2] * spatial_scale)
    y2 = torch.round(boxes[:, 3] * spatial_scale)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    my = _bin_masks(y1, _div(rh, ph), ph, h, boxes)       # [R, ph, H]
    mx = _bin_masks(x1, _div(rw, pw), pw, w, boxes)       # [R, pw, W]
    neg = torch.full((), torch.finfo(img.dtype).min, dtype=img.dtype,
                     device=img.device)
    cols = torch.where(mx[:, :, None, None, :], img[None, None], neg) \
        .amax(dim=-1)                                     # [R, pw, C, H]
    out = torch.where(my[:, :, None, None, :], cols[:, None], neg) \
        .amax(dim=-1)                                     # [R, ph, pw, C]
    any_m = my.any(-1)[:, :, None] & mx.any(-1)[:, None, :]
    out = torch.where(any_m[..., None], out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2)


register_op("roi_pool", _roi_pool_raw)


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    _one_image("roi_pool", x, boxes_num)
    return apply(_roi_pool_raw, (x, boxes),
                 {"output_size": tuple(output_size),
                  "spatial_scale": float(spatial_scale)}, name="roi_pool")


def _psroi_pool_raw(x, boxes, output_size=(1, 1), spatial_scale=1.0,
                    output_channels=1):
    """Position-sensitive ROI average pooling (ref operators/psroi_pool_op.cc):
    input channels C = output_channels*ph*pw; bin (i,j) of output channel k
    averages input channel k*ph*pw + i*pw + j over the bin's pixels."""
    ph, pw = output_size
    img = x[0]
    c, h, w = img.shape
    x1 = torch.round(boxes[:, 0]) * spatial_scale
    y1 = torch.round(boxes[:, 1]) * spatial_scale
    x2 = torch.round(boxes[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(boxes[:, 3] + 1.0) * spatial_scale
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    my = _bin_masks(y1, _div(rh, ph), ph, h, boxes).to(img.dtype)
    mx = _bin_masks(x1, _div(rw, pw), pw, w, boxes).to(img.dtype)
    planes = img.reshape(output_channels, ph, pw, h, w)
    s = torch.einsum("rih,kijhw,rjw->rkij", my, planes, mx)
    n = (my.sum(-1)[:, None, :, None] * mx.sum(-1)[:, None, None, :])
    return torch.where(n > 0, s / torch.clamp(n, min=1),
                       torch.zeros_like(s))


register_op("psroi_pool", _psroi_pool_raw)


def psroi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
               name=None):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    xa = as_array(x)
    _one_image("psroi_pool", x, boxes_num)
    ph, pw = output_size
    if xa.shape[1] % (ph * pw) != 0:
        raise ValueError(
            f"psroi_pool: input channels ({xa.shape[1]}) must be divisible "
            f"by output_size h*w ({ph}*{pw}) — ref psroi_pool_op enforces "
            f"input_channels == output_channels * ph * pw")
    oc = xa.shape[1] // (ph * pw)
    return apply(_psroi_pool_raw, (x, boxes),
                 {"output_size": tuple(output_size),
                  "spatial_scale": float(spatial_scale),
                  "output_channels": int(oc)}, name="psroi_pool")


# ------------------------------------------------- channel/space reshapes

def _affine_channel_raw(x, scale, bias, data_layout="NCHW"):
    """ref operators/affine_channel_op.cc: y = x * scale[c] + bias[c]."""
    if data_layout == "NCHW":
        shape = (1, -1) + (1,) * (x.ndim - 2)
    else:
        shape = (1,) * (x.ndim - 1) + (-1,)
    return x * scale.reshape(shape) + bias.reshape(shape)


register_op("affine_channel", _affine_channel_raw)


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    return apply(_affine_channel_raw, (x, scale, bias),
                 {"data_layout": data_layout}, name="affine_channel")


def _channel_shuffle_raw(x, groups=1, data_format="NCHW"):
    """ref operators/shuffle_channel_op.cc / paddle 2.x channel_shuffle."""
    if data_format == "NCHW":
        b, c, h, w = x.shape
        return (x.reshape(b, groups, c // groups, h, w)
                 .permute(0, 2, 1, 3, 4).reshape(b, c, h, w))
    b, h, w, c = x.shape
    return (x.reshape(b, h, w, groups, c // groups)
             .permute(0, 1, 2, 4, 3).reshape(b, h, w, c))


register_op("channel_shuffle", _channel_shuffle_raw)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return apply(_channel_shuffle_raw, (x,),
                 {"groups": int(groups), "data_format": data_format},
                 name="channel_shuffle")


def _pixel_unshuffle_raw(x, downscale_factor=1, data_format="NCHW"):
    """Inverse of pixel_shuffle (ref operators/pixel_unshuffle_op.cc)."""
    r = downscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        return (x.reshape(b, c, h // r, r, w // r, r)
                 .permute(0, 1, 3, 5, 2, 4)
                 .reshape(b, c * r * r, h // r, w // r))
    b, h, w, c = x.shape
    return (x.reshape(b, h // r, r, w // r, r, c)
             .permute(0, 1, 3, 2, 4, 5)
             .reshape(b, h // r, w // r, c * r * r))


register_op("pixel_unshuffle", _pixel_unshuffle_raw)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply(_pixel_unshuffle_raw, (x,),
                 {"downscale_factor": int(downscale_factor),
                  "data_format": data_format}, name="pixel_unshuffle")


def _space_to_depth_raw(x, blocksize=1):
    """ref operators/space_to_depth_op.cc (NCHW; block-major channel order,
    which matches the reference kernel's (c*bs + offset) layout rather than
    pixel_unshuffle's channel-major)."""
    bs = blocksize
    b, c, h, w = x.shape
    return (x.reshape(b, c, h // bs, bs, w // bs, bs)
             .permute(0, 3, 5, 1, 2, 4)
             .reshape(b, c * bs * bs, h // bs, w // bs))


register_op("space_to_depth", _space_to_depth_raw)


def space_to_depth(x, blocksize, name=None):
    return apply(_space_to_depth_raw, (x,), {"blocksize": int(blocksize)},
                 name="space_to_depth")


# ------------------------------------------------- pooling with indices

def _pool_with_index(x, kernel, stride, padding):
    """Max pooling over the last len(kernel) dims with the argmax's flat
    index into the unpadded map (int32): padded positions never win."""
    nd = len(kernel)
    stride = tuple(kernel) if stride is None else tuple(stride)
    spatial = x.shape[2:]
    pad = []
    for p in reversed(padding):
        pad += [p, p]
    patches = TF.pad(x, pad)
    for d in range(nd):
        patches = patches.unfold(2 + d, kernel[d], stride[d])
    outs = patches.shape[2:2 + nd]
    patches = patches.reshape(*x.shape[:2], *outs, -1)
    # the source position of window entry (o, k) along each dim
    valid = torch.ones((), dtype=torch.bool, device=x.device)
    flat = torch.zeros((), dtype=torch.int64, device=x.device)
    for d in range(nd):
        o = torch.arange(outs[d], device=x.device) * stride[d] - padding[d]
        pos = o[:, None] + torch.arange(kernel[d], device=x.device)[None, :]
        shape = [1] * (2 * nd)
        shape[d], shape[nd + d] = outs[d], kernel[d]
        pos = pos.reshape(shape)
        valid = valid & (pos >= 0) & (pos < spatial[d])
        flat = flat * spatial[d] + pos
    valid = valid.reshape(*outs, -1)
    flat = flat.reshape(*outs, -1)
    neg = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    vals = torch.where(valid, patches, neg)
    arg = torch.argmax(vals, dim=-1)
    out = torch.amax(vals, dim=-1)
    idx = torch.gather(flat.expand(*vals.shape), -1, arg[..., None])[..., 0]
    return out, idx.to(torch.int32)


def _max_pool2d_with_index_raw(x, kernel_size=(2, 2), stride=None,
                               padding=(0, 0)):
    """ref operators/max_pool2d_with_index_op (pool2d max + argmax over the
    flattened H*W map). Returns (out, flat_indices) — the indices feed
    max_unpool2d, exactly the reference pairing."""
    return _pool_with_index(x, kernel_size, stride, padding)


register_op("max_pool2d_with_index", _max_pool2d_with_index_raw)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0, name=None):
    ks = (kernel_size,) * 2 if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = None if stride is None else (
        (stride,) * 2 if isinstance(stride, int) else tuple(stride))
    pd = (padding,) * 2 if isinstance(padding, int) else tuple(padding)
    return apply(_max_pool2d_with_index_raw, (x,),
                 {"kernel_size": ks, "stride": st, "padding": pd},
                 name="max_pool2d_with_index")


def _max_unpool2d_raw(x, indices, output_hw=(1, 1)):
    """ref operators/unpool_op.cc: scatter pooled values back to the flat
    positions recorded by max_pool2d_with_index. A scatter-max over a
    lowest-value init (overlapping windows can record one position twice),
    then a scattered mask zero-fills the untouched positions."""
    b, c, oh, ow = x.shape
    H, W = output_hw
    src = x.reshape(b, c, oh * ow)
    idx = indices.reshape(b, c, oh * ow).long()
    lo = -float("inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    flat = torch.full((b, c, H * W), lo, dtype=x.dtype, device=x.device)
    flat = flat.scatter_reduce(2, idx, src, reduce="amax", include_self=True)
    touched = torch.zeros((b, c, H * W), dtype=torch.bool,
                          device=x.device).scatter(2, idx, True)
    flat = torch.where(touched, flat, torch.zeros_like(flat))
    return flat.reshape(b, c, H, W)


register_op("max_unpool2d", _max_unpool2d_raw)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, name=None):
    xa = as_array(x)
    ks = (kernel_size,) * 2 if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = ks if stride is None else (
        (stride,) * 2 if isinstance(stride, int) else tuple(stride))
    if output_size is None:
        oh, ow = xa.shape[-2:]
        output_size = ((oh - 1) * st[0] + ks[0], (ow - 1) * st[1] + ks[1])
    return apply(_max_unpool2d_raw, (x, indices),
                 {"output_hw": tuple(int(v) for v in output_size[-2:])},
                 name="max_unpool2d")


# ----------------------------------------------------------- yolov3 loss

def _bce(logit, target):
    return torch.clamp(logit, min=0) - logit * target + torch.log1p(
        torch.exp(-torch.abs(logit)))


def _yolov3_loss_raw(x, gt_box, gt_label, gt_score=None, anchors=(),
                     anchor_mask=(), class_num=1, ignore_thresh=0.7,
                     downsample_ratio=32, use_label_smooth=True):
    """YOLOv3 training loss (ref operators/detection/yolov3_loss_op.cc).

    x: [B, A*(5+C), H, W] raw head output for this scale (A =
    len(anchor_mask)),
    gt_box: [B, N, 4] normalised (cx, cy, w, h), gt_label: [B, N] int
    (rows with w<=0 are padding), gt_score: [B, N] optional per-gt mixup
    weight (scales that gt's loc/cls losses and is the objectness target).
    Sigmoid-CE on x/y, L1 on w/h (scaled by 2 - gw*gh), sigmoid-CE
    objectness with ignore zone (pred IoU vs any gt > ignore_thresh), and
    per-class sigmoid-CE at positive cells. The responsible anchor for a gt
    is the best whole-anchor-set wh-IoU match, positive only when that
    anchor belongs to this scale's mask. Returns [B] loss; torch autograd
    differentiates the same arithmetic the JAX package's vjp does.
    """
    B, _, H, W = x.shape
    A = len(anchor_mask)
    C = class_num
    f32 = torch.float32
    like = torch.zeros((), dtype=f32, device=x.device)
    an = _consts(anchors, like).reshape(-1, 2)                # [An, 2] pixels
    mask = torch.stack([torch.full((), int(m), device=x.device)
                        for m in anchor_mask])
    in_h, in_w = H * downsample_ratio, W * downsample_ratio

    p = x.reshape(B, A, 5 + C, H, W)
    tx, ty, tw, th = p[:, :, 0], p[:, :, 1], p[:, :, 2], p[:, :, 3]
    tobj, tcls = p[:, :, 4], p[:, :, 5:]        # [B,A,H,W], [B,A,C,H,W]

    # ---- decoded pred boxes (normalised) for the ignore-zone IoU test
    gx = (_arange(W, like)[None, None, None, :] + torch.sigmoid(tx)) / W
    gy = (_arange(H, like)[None, None, :, None] + torch.sigmoid(ty)) / H
    aw = an[mask, 0][None, :, None, None]
    ah = an[mask, 1][None, :, None, None]
    pw = torch.exp(tw) * aw / in_w
    phh = torch.exp(th) * ah / in_h

    def iou_cwh(ax_, ay_, aw_, ah_, bx, by, bw, bh):
        x1 = torch.maximum(ax_ - aw_ / 2, bx - bw / 2)
        x2 = torch.minimum(ax_ + aw_ / 2, bx + bw / 2)
        y1 = torch.maximum(ay_ - ah_ / 2, by - bh / 2)
        y2 = torch.minimum(ay_ + ah_ / 2, by + bh / 2)
        inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
        return inter / torch.clamp(aw_ * ah_ + bw * bh - inter, min=1e-10)

    gb = gt_box.to(f32)                                       # [B, N, 4]
    gvalid = gb[:, :, 2] > 0                                  # [B, N]
    iou = iou_cwh(gx[..., None], gy[..., None], pw[..., None], phh[..., None],
                  gb[:, None, None, None, :, 0], gb[:, None, None, None, :, 1],
                  gb[:, None, None, None, :, 2], gb[:, None, None, None, :, 3])
    iou = torch.where(gvalid[:, None, None, None, :], iou,
                      torch.zeros_like(iou))
    ignore = torch.amax(iou, dim=-1) > ignore_thresh          # [B,A,H,W]

    # ---- responsible-anchor assignment per gt (wh IoU over ALL anchors)
    gw_pix, gh_pix = gb[:, :, 2] * in_w, gb[:, :, 3] * in_h   # [B, N]
    inter = (torch.minimum(gw_pix[:, :, None], an[None, None, :, 0]) *
             torch.minimum(gh_pix[:, :, None], an[None, None, :, 1]))
    union = (gw_pix * gh_pix)[:, :, None] + \
        (an[:, 0] * an[:, 1])[None, None] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=2)
    # map best whole-set anchor -> slot in this scale's mask (or -1)
    hit = best[:, :, None] == mask[None, None, :]
    slot = torch.argmax(hit.to(torch.int32), dim=2)
    resp = gvalid & hit.any(dim=2)                            # [B, N]

    gi = torch.clamp((gb[:, :, 0] * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gb[:, :, 1] * H).to(torch.int32), 0, H - 1).long()
    # per-gt targets
    t_x = gb[:, :, 0] * W - gi
    t_y = gb[:, :, 1] * H - gj
    t_w = torch.log(torch.clamp(
        gw_pix / torch.clamp(an[:, 0][best], min=1e-10), min=1e-10))
    t_h = torch.log(torch.clamp(
        gh_pix / torch.clamp(an[:, 1][best], min=1e-10), min=1e-10))
    scale = 2.0 - gb[:, :, 2] * gb[:, :, 3]                   # [B, N]

    bi = torch.arange(B, device=x.device)[:, None].expand(resp.shape)
    # gather predictions at each gt's assigned location
    px_g = tx[bi, slot, gj, gi]
    py_g = ty[bi, slot, gj, gi]
    pw_g = tw[bi, slot, gj, gi]
    ph_g = th[bi, slot, gj, gi]
    score = (torch.ones_like(gb[:, :, 0]) if gt_score is None
             else gt_score.to(f32))                           # [B, N]
    zero = torch.zeros_like(score)
    loc = (_bce(px_g, t_x) + _bce(py_g, t_y)
           + torch.abs(pw_g - t_w) + torch.abs(ph_g - t_h)) * scale * score
    loc_loss = torch.sum(torch.where(resp, loc, zero), dim=1)  # [B]

    # ---- objectness: positives at responsible cells (target = gt_score),
    # negatives elsewhere. A scatter-max: a padding/non-responsible row
    # writing 0 at a duplicate index must not clobber a positive.
    flat = ((bi * A + slot) * H + gj) * W + gi
    posw = torch.zeros(B * A * H * W, dtype=f32, device=x.device) \
        .scatter_reduce(0, flat.reshape(-1),
                        torch.where(resp, score, zero).reshape(-1),
                        reduce="amax", include_self=True) \
        .reshape(B, A, H, W)
    pos = posw > 0
    obj_zero = torch.zeros_like(tobj)
    obj_pos = torch.where(pos, _bce(tobj, posw), obj_zero)
    obj_neg = torch.where((~pos) & (~ignore), _bce(tobj, obj_zero),
                          obj_zero)
    obj_loss = torch.sum(obj_pos + obj_neg, dim=(1, 2, 3))

    # ---- classification at positive cells (ref label_smooth: positives
    # 1 - sw, negatives sw, sw = min(1/C, 1/40))
    sw = min(1.0 / C, 1.0 / 40.0) if (use_label_smooth and C > 1) else 0.0
    onehot = (gt_label.long()[..., None] ==
              torch.arange(C, device=x.device)).to(f32)       # [B, N, C]
    tgt = onehot * (1.0 - sw) + (1.0 - onehot) * sw
    pcls_g = tcls.permute(0, 1, 3, 4, 2)[bi, slot, gj, gi]   # [B,N,C]
    cls = torch.sum(_bce(pcls_g, tgt), dim=2) * score
    cls_loss = torch.sum(torch.where(resp, cls, zero), dim=1)

    return loc_loss + obj_loss + cls_loss


register_op("yolov3_loss", _yolov3_loss_raw)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    attrs = {"anchors": [int(a) for a in anchors],
             "anchor_mask": [int(a) for a in anchor_mask],
             "class_num": int(class_num),
             "ignore_thresh": float(ignore_thresh),
             "downsample_ratio": int(downsample_ratio),
             "use_label_smooth": bool(use_label_smooth)}
    if gt_score is not None:
        return apply(_yolov3_loss_raw, (x, gt_box, gt_label, gt_score),
                     attrs, name="yolov3_loss")
    return apply(_yolov3_loss_raw, (x, gt_box, gt_label), attrs,
                 name="yolov3_loss")


# ------------------------------------------------------- precise roi pool

def _tri_int(t, p):
    """∫_{-inf}^{t} max(0, 1-|s-p|) ds, elementwise."""
    u = t - p
    left = 0.5 * torch.square(torch.clamp(u + 1.0, 0.0, 1.0))
    right = 0.5 - 0.5 * torch.square(torch.clamp(1.0 - u, 0.0, 1.0)) + 0.5
    return torch.where(u <= 0, left, right)


def _prroi_pool_raw(x, boxes, output_size=(1, 1), spatial_scale=1.0):
    """Precise ROI pooling (ref operators/prroi_pool_op.cc, PrRoIPool):
    each output bin is the exact integral of the bilinearly-interpolated
    feature surface over the bin, divided by bin area: one [pixels x bins]
    weighted sum, differentiable w.r.t. both features and box
    coordinates. x: [1, C, H, W], boxes: [R, 4] -> [R, C, ph, pw]."""
    ph, pw = output_size
    img = x[0]
    c, h, w = img.shape
    px = torch.arange(w, dtype=torch.float32, device=x.device)
    py = torch.arange(h, dtype=torch.float32, device=x.device)
    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    x2 = boxes[:, 2] * spatial_scale
    y2 = boxes[:, 3] * spatial_scale
    bw = _div(torch.clamp(x2 - x1, min=1e-6), pw)[:, None]
    bh = _div(torch.clamp(y2 - y1, min=1e-6), ph)[:, None]
    j = _arange(pw, boxes)[None, :]
    i = _arange(ph, boxes)[None, :]
    ax, bx_ = x1[:, None] + j * bw, x1[:, None] + (j + 1) * bw   # [R, pw]
    ay, by_ = y1[:, None] + i * bh, y1[:, None] + (i + 1) * bh   # [R, ph]
    wx = _tri_int(bx_[..., None], px) - _tri_int(ax[..., None], px)
    wy = _tri_int(by_[..., None], py) - _tri_int(ay[..., None], py)
    area = torch.clamp((bx_ - ax)[:, None, :] * (by_ - ay)[:, :, None],
                       min=1e-6)                              # [R, ph, pw]
    out = torch.einsum("chw,rih,rjw->rcij", img, wy, wx)
    return out / area[:, None]


register_op("prroi_pool", _prroi_pool_raw)


def prroi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
               name=None):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    _one_image("prroi_pool", x, boxes_num)
    return apply(_prroi_pool_raw, (x, boxes),
                 {"output_size": tuple(output_size),
                  "spatial_scale": float(spatial_scale)}, name="prroi_pool")


# ----------------------------------------------------------- correlation

def _correlation_raw(x1, x2, max_displacement=1, stride2=1, pad_size=None):
    """Optical-flow correlation layer (ref operators/correlation_op.cc,
    FlowNet; kernel_size=1, stride1=1 — the shapes FlowNetC uses):
    out[b, k, i, j] = mean_c x1[b, c, i, j] * x2[b, c, i+dy, j+dx] over the
    displacement window dy,dx in [-d, d] step stride2; k indexes (dy, dx)
    row-major."""
    d = max_displacement
    if pad_size is None:
        pad_size = d
    b, c, h, w = x1.shape
    x2p = TF.pad(x2, (pad_size, pad_size, pad_size, pad_size))
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            sh = x2p[:, :, pad_size + dy:pad_size + dy + h,
                     pad_size + dx:pad_size + dx + w]
            outs.append(torch.mean(x1 * sh, dim=1))
    return torch.stack(outs, dim=1)


register_op("correlation", _correlation_raw)


def correlation(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1, name=None):
    if kernel_size != 1 or stride1 != 1:
        raise NotImplementedError(
            "correlation: kernel_size=1, stride1=1 supported (FlowNetC "
            "shapes); ref correlation_op.cc general case")
    if pad_size < max_displacement:
        raise ValueError(
            f"correlation: pad_size ({pad_size}) must be >= "
            f"max_displacement ({max_displacement}) or the displacement "
            f"window reads out of bounds")
    return apply(_correlation_raw, (x1, x2),
                 {"max_displacement": int(max_displacement),
                  "stride2": int(stride2), "pad_size": int(pad_size)},
                 name="correlation")


def _max_pool3d_with_index_raw(x, kernel_size=(2, 2, 2), stride=None,
                               padding=(0, 0, 0)):
    """ref operators/max_pool3d_with_index (NCDHW; flat D*H*W indices)."""
    return _pool_with_index(x, kernel_size, stride, padding)


register_op("max_pool3d_with_index", _max_pool3d_with_index_raw)


# ------------------------------------------------ detection assembly tail

def _box_clip_raw(boxes, im_shape):
    """ref operators/detection/box_clip_op.cc: clamp corner boxes into
    [0, H-1] x [0, W-1]. boxes: [..., 4], im_shape: [2] (H, W)."""
    h = im_shape[0].to(boxes.dtype)
    w = im_shape[1].to(boxes.dtype)

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0), hi - 1)
    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
                       dim=-1)


register_op("box_clip", _box_clip_raw)


def box_clip(input, im_shape, name=None):
    return apply(_box_clip_raw, (input, im_shape), name="box_clip")


def _bipartite_match_raw(dist_mat, match_type="bipartite",
                         overlap_threshold=0.5):
    """Greedy bipartite matching (ref operators/detection/
    bipartite_match_op.cc): repeatedly take the globally largest entry,
    pairing its row (gt) to its column (prior); with
    match_type='per_prediction', unmatched columns whose best row overlap
    exceeds the threshold also match. Host numpy. Returns (col_to_row [M]
    int32, col_dist [M])."""
    d = _np(dist_mat).copy()
    n, m = d.shape
    match = np.full((m,), -1, np.int32)
    mdist = np.zeros((m,), np.float32)
    live = d.copy()
    for _ in range(min(n, m)):
        idx = np.unravel_index(np.argmax(live), live.shape)
        if live[idx] <= 0:
            break
        r, c = idx
        match[c] = r
        mdist[c] = d[r, c]
        live[r, :] = -1.0
        live[:, c] = -1.0
    if match_type == "per_prediction":
        for c in range(m):
            if match[c] == -1:
                r = int(np.argmax(d[:, c]))
                if d[r, c] >= overlap_threshold:
                    match[c] = r
                    mdist[c] = d[r, c]
    return _back(match, dist_mat), _back(mdist, dist_mat)


register_op("bipartite_match", _bipartite_match_raw)


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    return apply(_bipartite_match_raw, (dist_matrix,),
                 {"match_type": match_type,
                  "overlap_threshold": float(dist_threshold)},
                 differentiable=False, name="bipartite_match")


def _target_assign_raw(x, match_indices, fill_value=0.0):
    """ref operators/detection/target_assign_op.cc: out[i, j] =
    x[match[i, j]] rows gathered per batch, negatives filled.
    x: [N, K, D] (entity table per image), match_indices: [N, M]."""
    idx = torch.clamp(match_indices, min=0).long()
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    out = x[bi, idx]                                          # [N, M, D]
    neg = (match_indices < 0)[:, :, None]
    out = torch.where(neg, torch.full((), fill_value, dtype=x.dtype,
                                      device=x.device), out)
    wt = (match_indices >= 0).to(torch.float32)[:, :, None]
    return out, wt


register_op("target_assign", _target_assign_raw)


def target_assign(input, matched_indices, mismatch_value=0.0, name=None):
    return apply(_target_assign_raw, (input, matched_indices),
                 {"fill_value": float(mismatch_value)},
                 differentiable=False, name="target_assign")


def _greedy_nms_host(boxes, order, thresh, shift=0.0, max_keep=None):
    """Vectorized host greedy NMS: one precomputed IoU matrix + O(len)
    rounds of boolean suppression (no nested python IoU loops)."""
    if order.size == 0:
        return []
    b = boxes[order]
    area = (b[:, 2] - b[:, 0] + shift) * (b[:, 3] - b[:, 1] + shift)
    x1 = np.maximum(b[:, None, 0], b[None, :, 0])
    y1 = np.maximum(b[:, None, 1], b[None, :, 1])
    x2 = np.minimum(b[:, None, 2], b[None, :, 2])
    y2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1 + shift, 0) * np.maximum(y2 - y1 + shift, 0)
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-10)
    live = np.ones(order.size, bool)
    kept = []
    for i in range(order.size):
        if not live[i]:
            continue
        kept.append(order[i])
        if max_keep is not None and len(kept) >= max_keep:
            break
        live &= iou[i] <= thresh
        live[i] = False
    return kept


def _nms_host_single(bx, sc, score_threshold, nms_top_k, keep_top_k,
                     nms_threshold, background_label, shift):
    C, M = sc.shape
    cand = []
    for c in range(C):
        if c == background_label:
            continue
        keep = np.where(sc[c] > score_threshold)[0]
        if keep.size == 0:
            continue
        order = keep[np.argsort(-sc[c][keep])][:nms_top_k]
        for k in _greedy_nms_host(bx, order, nms_threshold, shift):
            cand.append((c, float(sc[c][k]), bx[k]))
    cand.sort(key=lambda t: -t[1])
    cand = cand[:keep_top_k]
    out = np.full((keep_top_k, 6), -1.0, np.float32)
    for i, (c, s, b) in enumerate(cand):
        out[i] = [c, s, b[0], b[1], b[2], b[3]]
    return out, np.int32(len(cand))


def _multiclass_nms_raw(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                        keep_top_k=16, nms_threshold=0.3, background_label=0,
                        normalized=True):
    """Per-class NMS + cross-class top-k (ref operators/detection/
    multiclass_nms_op.cc). bboxes: [M, 4], scores: [C, M] — or the
    batched reference layout [N, M, 4] / [N, C, M]. The reference emits
    a LoD list; the dense form is a fixed [(N,) keep_top_k, 6] tensor of
    (label, score, x1, y1, x2, y2) rows padded with label=-1, plus the
    valid count(s). The sequential greedy suppression runs on the host
    in numpy, as the JAX package runs it; the results come back to the
    inputs' device."""
    shift = 0.0 if normalized else 1.0
    bx, sc = _np(bboxes), _np(scores)
    if bx.ndim == 3:
        outs, counts = zip(*[
            _nms_host_single(b, s, score_threshold, nms_top_k, keep_top_k,
                             nms_threshold, background_label, shift)
            for b, s in zip(bx, sc)])
        out, count = np.stack(outs), np.asarray(counts, np.int32)
    else:
        out, count = _nms_host_single(bx, sc, score_threshold, nms_top_k,
                                      keep_top_k, nms_threshold,
                                      background_label, shift)
    return _back(out, bboxes), _back(np.asarray(count), bboxes)


register_op("multiclass_nms", _multiclass_nms_raw)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                   keep_top_k=16, nms_threshold=0.3, normalized=True,
                   background_label=0, name=None):
    return apply(_multiclass_nms_raw, (bboxes, scores),
                 {"score_threshold": float(score_threshold),
                  "nms_top_k": int(nms_top_k),
                  "keep_top_k": int(keep_top_k),
                  "nms_threshold": float(nms_threshold),
                  "background_label": int(background_label),
                  "normalized": bool(normalized)},
                 differentiable=False, name="multiclass_nms")


def _generate_proposals_raw(scores, bbox_deltas, im_shape, anchors,
                            variances, pre_nms_top_n=128, post_nms_top_n=32,
                            nms_thresh=0.5, min_size=0.1):
    """RPN proposal generation (ref operators/detection/
    generate_proposals_op.cc): decode anchor deltas, clip to image, drop
    tiny boxes, pre-NMS top-N by score, greedy NMS, post-NMS top-N, on the
    host. Single image: scores [A], bbox_deltas [A, 4], anchors [A, 4],
    variances [A, 4]. Dense output: ([post_nms_top_n, 4] padded rois,
    count)."""
    sc = _np(scores).reshape(-1)
    dl = _np(bbox_deltas).reshape(-1, 4)
    an = _np(anchors).reshape(-1, 4)
    vr = _np(variances).reshape(-1, 4)
    ims = _np(im_shape)
    h, w = float(ims[0]), float(ims[1])
    # decode (center-size, like box_coder decode)
    aw = an[:, 2] - an[:, 0] + 1.0
    ah = an[:, 3] - an[:, 1] + 1.0
    ax = an[:, 0] + aw * 0.5
    ay = an[:, 1] + ah * 0.5
    cx = vr[:, 0] * dl[:, 0] * aw + ax
    cy = vr[:, 1] * dl[:, 1] * ah + ay
    bw = np.exp(np.minimum(vr[:, 2] * dl[:, 2], 10.0)) * aw
    bh = np.exp(np.minimum(vr[:, 3] * dl[:, 3], 10.0)) * ah
    boxes = np.stack([cx - bw / 2, cy - bh / 2,
                      cx + bw / 2 - 1, cy + bh / 2 - 1], axis=1)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w - 1)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h - 1)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    keep = np.where((ws >= min_size) & (hs >= min_size))[0]
    order = keep[np.argsort(-sc[keep])][:pre_nms_top_n]
    kept = _greedy_nms_host(boxes, order, nms_thresh, shift=1.0,
                            max_keep=post_nms_top_n)
    out = np.zeros((post_nms_top_n, 4), np.float32)
    for i, k in enumerate(kept):
        out[i] = boxes[k]
    return _back(out, scores), _back(np.asarray(len(kept), np.int32), scores)


register_op("generate_proposals", _generate_proposals_raw)


def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, name=None):
    return apply(_generate_proposals_raw,
                 (scores, bbox_deltas, im_shape, anchors, variances),
                 {"pre_nms_top_n": int(pre_nms_top_n),
                  "post_nms_top_n": int(post_nms_top_n),
                  "nms_thresh": float(nms_thresh),
                  "min_size": float(min_size)},
                 differentiable=False, name="generate_proposals")


def _distribute_fpn_proposals_raw(rois, min_level=2, max_level=5,
                                  refer_level=4, refer_scale=224):
    """ref operators/detection/distribute_fpn_proposals_op.cc: assign each
    roi to level floor(refer_level + log2(sqrt(area)/refer_scale)),
    clamped. Dense output: (level_ids [N] int32, restore_index [N]) — the
    per-level splits are boolean masks over level_ids."""
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(torch.clamp(w * h, min=1e-10))
    lvl = torch.floor(refer_level + torch.log2(scale / refer_scale + 1e-10))
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    order = torch.argsort(lvl, stable=True)
    restore = torch.argsort(order, stable=True).to(torch.int32)
    return lvl, restore


register_op("distribute_fpn_proposals", _distribute_fpn_proposals_raw)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    return apply(_distribute_fpn_proposals_raw, (fpn_rois,),
                 {"min_level": int(min_level), "max_level": int(max_level),
                  "refer_level": int(refer_level),
                  "refer_scale": int(refer_scale)},
                 differentiable=False, name="distribute_fpn_proposals")


def _polygon_box_transform_raw(x):
    """ref operators/detection/polygon_box_transform_op.cc (EAST OCR):
    input [B, 8, H, W] of per-pixel quad offsets; output absolute quad
    coordinates: out[:, 2k] = 4*j - x[:, 2k], out[:, 2k+1] = 4*i - x."""
    b, c, h, w = x.shape
    jj = _arange(w, x)[None, None, None, :] * 4.0
    ii = _arange(h, x)[None, None, :, None] * 4.0
    even = jj - x[:, 0::2]
    odd = ii - x[:, 1::2]
    return torch.stack([even, odd], dim=2).reshape(b, c, h, w)


register_op("polygon_box_transform", _polygon_box_transform_raw)


def polygon_box_transform(input, name=None):
    return apply(_polygon_box_transform_raw, (input,),
                 differentiable=False, name="polygon_box_transform")


def _collect_fpn_proposals_raw(*args, post_nms_top_n=16):
    """ref operators/detection/collect_fpn_proposals_op.cc: concat
    per-level (rois, scores) pairs and keep the global top-N by score.
    args = L roi tensors [Ni, 4] then L score tensors [Ni]."""
    L = len(args) // 2
    rois = torch.cat(args[:L], dim=0)
    scores = torch.cat(args[L:], dim=0)
    k = min(post_nms_top_n, scores.shape[0])
    _, idx = torch.topk(scores, k)
    out = torch.zeros((post_nms_top_n, 4), dtype=rois.dtype,
                      device=rois.device)
    out[:k] = rois[idx]
    return out, torch.full((), k, dtype=torch.int32, device=rois.device)


register_op("collect_fpn_proposals", _collect_fpn_proposals_raw)


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    return apply(_collect_fpn_proposals_raw,
                 tuple(multi_rois) + tuple(multi_scores),
                 {"post_nms_top_n": int(post_nms_top_n)},
                 differentiable=False, name="collect_fpn_proposals")


def _box_decoder_and_assign_raw(prior_box, prior_box_var, target_box,
                                box_score, box_clip=4.135):
    """ref operators/detection/box_decoder_and_assign_op.cc: decode
    per-class box deltas against priors, then assign each roi its
    best-scoring non-background class's box.
    prior_box [N,4], target_box [N, C*4], box_score [N, C]."""
    N, C = box_score.shape
    pw = prior_box[:, 2] - prior_box[:, 0] + 1.0
    ph = prior_box[:, 3] - prior_box[:, 1] + 1.0
    px = prior_box[:, 0] + pw * 0.5
    py = prior_box[:, 1] + ph * 0.5
    var = prior_box_var.reshape(1, 1, 4) if prior_box_var.ndim == 1 \
        else prior_box_var[:, None, :]
    d = target_box.reshape(N, C, 4) * var
    cx = d[:, :, 0] * pw[:, None] + px[:, None]
    cy = d[:, :, 1] * ph[:, None] + py[:, None]
    bw = torch.exp(torch.clamp(d[:, :, 2], max=box_clip)) * pw[:, None]
    bh = torch.exp(torch.clamp(d[:, :, 3], max=box_clip)) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2,
                           cx + bw / 2 - 1, cy + bh / 2 - 1],
                          dim=2)                    # [N, C, 4]
    best = torch.argmax(box_score[:, 1:], dim=1) + 1  # skip background 0
    assigned = torch.gather(decoded, 1,
                            best[:, None, None].expand(N, 1, 4))[:, 0]
    return decoded.reshape(N, C * 4), assigned


register_op("box_decoder_and_assign", _box_decoder_and_assign_raw)


def _mine_hard_examples_raw(cls_loss, match_indices, neg_pos_ratio=3.0,
                            mining_type="max_negative"):
    """OHEM negative mining (ref operators/detection/
    mine_hard_examples_op.cc, max_negative mode): per row, keep the
    neg_pos_ratio * num_pos highest-loss negatives. Returns a [B, M]
    int32 mask (1 = selected negative)."""
    if mining_type != "max_negative":
        raise NotImplementedError(
            "mine_hard_examples: only max_negative mining implemented "
            "(ref hard_example mode keeps a global sample_size)")
    neg = match_indices < 0                              # [B, M]
    n_pos = torch.sum(~neg, dim=1, dtype=torch.int32)    # [B]
    n_keep = torch.minimum((n_pos * neg_pos_ratio).to(torch.int32),
                           torch.sum(neg, dim=1, dtype=torch.int32))
    loss_neg = torch.where(neg, cls_loss, torch.full_like(
        cls_loss, -float("inf")))
    order = torch.argsort(-loss_neg, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)      # rank of each col
    return (rank < n_keep[:, None]).to(torch.int32)


register_op("mine_hard_examples", _mine_hard_examples_raw)


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       name=None):
    return apply(_mine_hard_examples_raw, (cls_loss, match_indices),
                 {"neg_pos_ratio": float(neg_pos_ratio)},
                 differentiable=False, name="mine_hard_examples")


def _tdm_child_raw(x, tree_info, child_nums=2):
    """ref operators/tdm_child_op.cc: look up each node id's children in
    the TDM tree table. tree_info: [total_nodes, 3 + child_nums] rows of
    (item_id, layer_id, parent_id, child_ids...). Returns (child ids
    [..., child_nums], leaf mask)."""
    ids = x.long()
    children = tree_info[ids][..., 3:3 + child_nums].to(torch.int32)
    item = tree_info[children.long()][..., 0]
    leaf_mask = ((children != 0) & (item != 0)).to(torch.int32)
    return children, leaf_mask


register_op("tdm_child", _tdm_child_raw)


# ------------------------------------------------- training target assign

def _iou_corner_np(a, b):
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
        a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-10)


def _encode_center_np(anchors, gts):
    """box_coder encode_center_size, numpy (targets for matched pairs)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    gw = gts[:, 2] - gts[:, 0] + 1.0
    gh = gts[:, 3] - gts[:, 1] + 1.0
    gx = gts[:, 0] + gw * 0.5
    gy = gts[:, 1] + gh * 0.5
    return np.stack([(gx - ax) / aw, (gy - ay) / ah,
                     np.log(np.maximum(gw / aw, 1e-10)),
                     np.log(np.maximum(gh / ah, 1e-10))], axis=1)


def _rpn_target_assign_raw(anchors, gt_boxes, rpn_batch_size_per_im=256,
                           rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                           rpn_negative_overlap=0.3, seed=0):
    """RPN anchor sampling (ref operators/detection/rpn_target_assign_op.cc):
    positives = best anchor per gt + anchors with IoU > positive_overlap;
    negatives = IoU < negative_overlap; seeded random subsample to the
    fg-fraction budget. Dense outputs: labels [A] int32 (1 pos / 0 neg /
    -1 ignore) and bbox targets [A, 4] (zero rows for non-positives)."""
    an = _np(anchors)
    gt = _np(gt_boxes)
    A = an.shape[0]
    rng = np.random.RandomState(seed)
    labels = np.full((A,), -1, np.int32)
    tgt = np.zeros((A, 4), np.float32)
    if gt.shape[0]:
        iou = _iou_corner_np(an, gt)                 # [A, G]
        best_gt = iou.argmax(axis=1)
        best_iou = iou.max(axis=1)
        labels[best_iou < rpn_negative_overlap] = 0
        labels[iou.argmax(axis=0)] = 1               # best anchor per gt
        labels[best_iou >= rpn_positive_overlap] = 1
        n_fg = int(rpn_batch_size_per_im * rpn_fg_fraction)
        fg = np.where(labels == 1)[0]
        if fg.size > n_fg:
            labels[rng.choice(fg, fg.size - n_fg, replace=False)] = -1
        n_bg = rpn_batch_size_per_im - min(fg.size, n_fg)
        bg = np.where(labels == 0)[0]
        if bg.size > n_bg:
            labels[rng.choice(bg, bg.size - n_bg, replace=False)] = -1
        pos = np.where(labels == 1)[0]
        tgt[pos] = _encode_center_np(an[pos], gt[best_gt[pos]])
    else:
        labels[:] = 0
    return _back(labels, anchors), _back(tgt, anchors)


register_op("rpn_target_assign", _rpn_target_assign_raw)


def _retinanet_target_assign_raw(anchors, gt_boxes, positive_overlap=0.5,
                                 negative_overlap=0.4):
    """RetinaNet assignment (ref operators/detection/retinanet_target_
    assign_op.cc): like RPN but with no subsampling (focal loss consumes
    all anchors). Returns (labels [A] with gt class slot 1 for matched,
    bbox targets [A, 4])."""
    an = _np(anchors)
    gt = _np(gt_boxes)
    A = an.shape[0]
    labels = np.full((A,), -1, np.int32)
    tgt = np.zeros((A, 4), np.float32)
    if gt.shape[0]:
        iou = _iou_corner_np(an, gt)
        best_gt = iou.argmax(axis=1)
        best_iou = iou.max(axis=1)
        labels[best_iou < negative_overlap] = 0
        labels[best_iou >= positive_overlap] = 1
        labels[iou.argmax(axis=0)] = 1
        pos = np.where(labels == 1)[0]
        tgt[pos] = _encode_center_np(an[pos], gt[best_gt[pos]])
    else:
        labels[:] = 0
    return _back(labels, anchors), _back(tgt, anchors)


register_op("retinanet_target_assign", _retinanet_target_assign_raw)


def _generate_proposal_labels_raw(rois, gt_boxes, gt_classes,
                                  batch_size_per_im=64, fg_fraction=0.25,
                                  fg_thresh=0.5, bg_thresh_hi=0.5,
                                  bg_thresh_lo=0.0, seed=0):
    """Second-stage RoI sampling (ref operators/detection/
    generate_proposal_labels_op.cc): label rois by IoU against gt, seeded
    fg/bg subsample, regression targets for foregrounds. Dense outputs:
    (sampled rois [S, 4], labels [S] int32 (-1 pad), bbox targets [S, 4])
    with S = batch_size_per_im."""
    r = _np(rois)
    gt = _np(gt_boxes)
    gc = _np(gt_classes).reshape(-1)
    rng = np.random.RandomState(seed)
    S = batch_size_per_im
    all_rois = np.concatenate([r, gt], axis=0) if gt.size else r
    iou = _iou_corner_np(all_rois, gt) if gt.size else np.zeros(
        (all_rois.shape[0], 0))
    best = iou.max(axis=1) if gt.size else np.zeros(all_rois.shape[0])
    best_gt = iou.argmax(axis=1) if gt.size else np.zeros(
        all_rois.shape[0], np.int64)
    fg = np.where(best >= fg_thresh)[0]
    bg = np.where((best < bg_thresh_hi) & (best >= bg_thresh_lo))[0]
    n_fg = min(int(S * fg_fraction), fg.size)
    n_bg = min(S - n_fg, bg.size)
    fg = rng.choice(fg, n_fg, replace=False) if fg.size > n_fg else fg
    bg = rng.choice(bg, n_bg, replace=False) if bg.size > n_bg else bg
    keep = np.concatenate([fg, bg]).astype(np.int64)
    out_rois = np.zeros((S, 4), np.float32)
    out_lab = np.full((S,), -1, np.int32)
    out_tgt = np.zeros((S, 4), np.float32)
    k = keep.size
    out_rois[:k] = all_rois[keep]
    out_lab[:len(fg)] = gc[best_gt[fg]] if gt.size else 0
    out_lab[len(fg):k] = 0
    if gt.size and len(fg):
        out_tgt[:len(fg)] = _encode_center_np(all_rois[fg], gt[best_gt[fg]])
    return (_back(out_rois, rois), _back(out_lab, rois),
            _back(out_tgt, rois))


register_op("generate_proposal_labels", _generate_proposal_labels_raw)


def _detection_map_raw(detections, det_count, gt_boxes, gt_labels,
                       overlap_threshold=0.5, class_num=2,
                       ap_type="integral"):
    """VOC-style mAP (ref operators/detection/detection_map_op.cc) for one
    image batch in the dense contract: detections [D, 6] rows of (label,
    score, x1, y1, x2, y2) with det_count valid, gt_boxes [G, 4],
    gt_labels [G] (-1 pads). Host numpy; returns scalar mAP."""
    det = _np(detections)[:int(_np(det_count))]
    gtb = _np(gt_boxes)
    gtl = _np(gt_labels).reshape(-1)
    valid = gtl >= 0
    gtb, gtl = gtb[valid], gtl[valid]
    aps = []
    for c in range(class_num):
        gt_c = gtb[gtl == c]
        det_c = det[det[:, 0] == c]
        if gt_c.shape[0] == 0:
            continue
        order = np.argsort(-det_c[:, 1])
        det_c = det_c[order]
        used = np.zeros(gt_c.shape[0], bool)
        tp = np.zeros(det_c.shape[0])
        fp = np.zeros(det_c.shape[0])
        iou_all = _iou_corner_np(det_c[:, 2:6], gt_c) if det_c.size else \
            np.zeros((0, gt_c.shape[0]))
        for i in range(det_c.shape[0]):
            j = iou_all[i].argmax() if gt_c.shape[0] else 0
            if gt_c.shape[0] and iou_all[i, j] >= overlap_threshold \
                    and not used[j]:
                tp[i] = 1
                used[j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / gt_c.shape[0]
        prec = ctp / np.maximum(ctp + cfp, 1e-10)
        if ap_type == "11point":
            ap = np.mean([prec[rec >= t].max() if (rec >= t).any() else 0.0
                          for t in np.linspace(0, 1, 11)])
        else:  # integral
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mpre = np.concatenate([[0.0], prec, [0.0]])
            for i in range(mpre.size - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap = np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])
        aps.append(ap)
    return _back(np.asarray(np.mean(aps) if aps else 0.0, np.float32),
                 detections)


register_op("detection_map", _detection_map_raw)


def detection_map(detect_res, det_count, gt_boxes, gt_labels,
                  class_num, overlap_threshold=0.5, ap_type="integral",
                  name=None):
    return apply(_detection_map_raw,
                 (detect_res, det_count, gt_boxes, gt_labels),
                 {"overlap_threshold": float(overlap_threshold),
                  "class_num": int(class_num), "ap_type": str(ap_type)},
                 differentiable=False, name="detection_map")


def _deformable_psroi_pooling_raw(x, boxes, trans, output_size=(3, 3),
                                  spatial_scale=1.0, trans_std=0.1,
                                  sample_per_part=2):
    """Deformable position-sensitive RoI pooling (ref operators/
    deformable_psroi_pooling_op.cc, Deformable R-FCN): each bin's sample
    grid is shifted by a learned offset (trans [R, 2, ph, pw], scaled by
    trans_std and roi size), values bilinearly sampled from the bin's
    position-sensitive channel group and averaged.
    x: [1, C, H, W] with C = oc*ph*pw, boxes: [R, 4] -> [R, oc, ph, pw].
    Differentiable w.r.t. x, boxes and trans."""
    ph, pw = output_size
    img = x[0]
    c, h, w = img.shape
    oc = c // (ph * pw)
    s = sample_per_part
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    x2 = (boxes[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (boxes[:, 3] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bw, bh = _div(rw, pw), _div(rh, ph)
    dx = trans[:, 0] * trans_std * rw[:, None, None]          # [R, ph, pw]
    dy = trans[:, 1] * trans_std * rh[:, None, None]
    i = _arange(ph, boxes)[None, :, None, None]
    j = _arange(pw, boxes)[None, None, :, None]
    a = _div(_arange(s, boxes) + 0.5, s)[None, None, None, :]
    gy = (y1[:, None, None, None] + i * bh[:, None, None, None]
          + dy[..., None] + a * bh[:, None, None, None])      # [R, ph, pw, s]
    gx = (x1[:, None, None, None] + j * bw[:, None, None, None]
          + dx[..., None] + a * bw[:, None, None, None])
    chan = ((torch.arange(oc, device=x.device)[:, None, None] * ph
             + torch.arange(ph, device=x.device)[None, :, None]) * pw
            + torch.arange(pw, device=x.device)[None, None, :])
    yy = gy[:, None, :, :, :, None]                           # [R,1,ph,pw,s,1]
    xx = gx[:, None, :, :, None, :]                           # [R,1,ph,pw,1,s]
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1_ = torch.clamp(y0 + 1, 0, h - 1)
    x1_ = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(yy - y0, 0.0, 1.0)
    wx = torch.clamp(xx - x0, 0.0, 1.0)
    flat = img.reshape(c, h * w)
    ch = chan[None, :, :, :, None, None]

    def at(yi, xi):                               # [R, oc, ph, pw, s, s]
        return flat[ch, yi.long() * w + xi.long()]
    vals = (at(y0, x0) * (1 - wy) * (1 - wx)
            + at(y0, x1_) * (1 - wy) * wx
            + at(y1_, x0) * wy * (1 - wx)
            + at(y1_, x1_) * wy * wx)
    return vals.mean(dim=(4, 5))


register_op("deformable_psroi_pooling", _deformable_psroi_pooling_raw)


def _roi_perspective_transform_raw(x, rois, transformed_height=4,
                                   transformed_width=4, spatial_scale=1.0):
    """Perspective-warp RoI quads to a fixed rectangle (ref operators/
    detection/roi_perspective_transform_op.cc, OCR text-line
    rectification). rois: [R, 8] quad corners (x1 y1 ... x4 y4 in
    clockwise order); each output pixel samples the input bilinearly
    through the quad->rect homography, an 8x8 solve per RoI. x: [1, C, H,
    W] -> [R, C, TH, TW]."""
    img = x[0]
    c, h, w = img.shape
    TH, TW = transformed_height, transformed_width
    q = rois.reshape(-1, 4, 2) * spatial_scale
    r = q.shape[0]
    one = torch.ones_like(q[:, 0, 0])
    zero = torch.zeros_like(one)
    src = ((0.0, 0.0), (TW - 1.0, 0.0), (TW - 1.0, TH - 1.0),
           (0.0, TH - 1.0))
    rows, rhs = [], []
    for k, (u, v) in enumerate(src):
        X, Y = q[:, k, 0], q[:, k, 1]
        rows.append(torch.stack([u * one, v * one, one, zero, zero, zero,
                                 -u * X, -v * X], dim=1))
        rhs.append(X)
        rows.append(torch.stack([zero, zero, zero, u * one, v * one, one,
                                 -u * Y, -v * Y], dim=1))
        rhs.append(Y)
    A = torch.stack(rows, dim=1)                              # [R, 8, 8]
    b = torch.stack(rhs, dim=1)                               # [R, 8]
    # degenerate quads (zero/collinear rows, e.g. zero-padded rois) make A
    # singular: regularise and zero the output instead of a NaN solve
    degenerate = torch.abs(torch.linalg.det(A)) < 1e-6
    A = torch.where(degenerate[:, None, None],
                    A + torch.eye(8, dtype=A.dtype, device=A.device), A)
    hvec = torch.linalg.solve(A, b)
    H3 = torch.cat([hvec, torch.ones_like(hvec[:, :1])], dim=1) \
        .reshape(r, 3, 3)
    vv, uu = torch.meshgrid(_arange(TH, q), _arange(TW, q), indexing="ij")
    pts = torch.stack([uu, vv, torch.ones_like(uu)], dim=0).reshape(3, -1)
    mapped = H3 @ pts                                         # [R, 3, TH*TW]
    den = torch.clamp(torch.abs(mapped[:, 2]), min=1e-8)
    xs = mapped[:, 0] / den * torch.sign(mapped[:, 2])
    ys = mapped[:, 1] / den * torch.sign(mapped[:, 2])
    vals = _bilinear(img.reshape(c, h * w), ys, xs, h, w)     # [C, R, P]
    inside = (xs >= -1) & (xs <= w) & (ys >= -1) & (ys <= h)
    keep = (inside & ~degenerate[:, None])[None]
    vals = torch.where(keep, vals, torch.zeros_like(vals))
    return vals.permute(1, 0, 2).reshape(r, c, TH, TW)


register_op("roi_perspective_transform", _roi_perspective_transform_raw)


def _tdm_sampler_raw(leaf_ids, travel_list, layer_list, neg_samples_list=(),
                     seed=0, output_positive=True):
    """TDM layer-wise sampling (ref operators/tdm_sampler_op.cc): for each
    positive leaf, emit its ancestor per tree layer (travel_list row) plus
    `neg_samples_list[l]` seeded negatives drawn from that layer's node
    set (layer_list row, 0-padded). Host numpy. Returns (out ids
    [B, sum(1+neg_l)], labels same shape)."""
    ids = _np(leaf_ids).reshape(-1)
    travel = _np(travel_list)                  # [num_leaves, L]
    layers = _np(layer_list)                   # [L, max_layer_nodes]
    L = travel.shape[1]
    neg = list(neg_samples_list) or [1] * L
    if len(neg) != L:
        raise ValueError(
            f"tdm_sampler: neg_samples_list has {len(neg)} entries but the "
            f"travel table has {L} layers (ref requires equal length)")
    rng = np.random.RandomState(seed)
    width = sum((1 if output_positive else 0) + n for n in neg)
    out = np.zeros((ids.size, width), np.int32)
    lab = np.zeros((ids.size, width), np.int32)
    for bi, leaf in enumerate(ids):
        k = 0
        for li in range(L):
            pos = travel[leaf, li]
            if pos == 0:        # 0-padded layer (unbalanced tree): skip,
                k += (1 if output_positive else 0) + neg[li]  # label 0
                continue
            if output_positive:
                out[bi, k] = pos
                lab[bi, k] = 1
                k += 1
            nodes = layers[li][layers[li] > 0]
            nodes = nodes[nodes != pos]
            n = min(neg[li], nodes.size)
            if n:
                out[bi, k:k + n] = rng.choice(nodes, n, replace=False)
            k += neg[li]
    return _back(out, leaf_ids), _back(lab, leaf_ids)


register_op("tdm_sampler", _tdm_sampler_raw)


def _similarity_focus_raw(x, axis=1, indexes=(0,)):
    """ref operators/similarity_focus_op.h: for each selected index along
    `axis`, greedily pick cells of the remaining 2D plane in descending
    value order with no repeated row/col (an assignment-style focus), and
    set those positions to 1 across the whole `axis` dimension. Host numpy
    (sorting-based mask synthesis, non-differentiable)."""
    if axis not in (1, 2, 3):
        raise ValueError(
            f"similarity_focus: axis must be 1, 2 or 3 (got {axis}) — "
            "ref similarity_focus_op.h enforces the same")
    a = _np(x)
    B, d1, d2, d3 = a.shape
    out = np.zeros_like(a)
    for b in range(B):
        for index in indexes:
            if axis == 1:
                plane = a[b, index]                     # [d2, d3]
                n1, n2 = d2, d3
            elif axis == 2:
                plane = a[b, :, index]                  # [d1, d3]
                n1, n2 = d1, d3
            else:
                plane = a[b, :, :, index]               # [d1, d2]
                n1, n2 = d1, d2
            order = np.argsort(-plane.ravel())
            tag1 = np.zeros(n1, bool)
            tag2 = np.zeros(n2, bool)
            picked = 0
            for f in order:
                i1, i2 = divmod(int(f), n2)
                if tag1[i1] or tag2[i2]:
                    continue
                tag1[i1] = tag2[i2] = True
                picked += 1
                if axis == 1:
                    out[b, :, i1, i2] = 1
                elif axis == 2:
                    out[b, i1, :, i2] = 1
                else:
                    out[b, i1, i2, :] = 1
                if picked == min(n1, n2):
                    break
    return _back(out, x)


register_op("similarity_focus", _similarity_focus_raw)


def similarity_focus(input, axis, indexes, name=None):
    return apply(_similarity_focus_raw, (input,),
                 {"axis": int(axis), "indexes": [int(i) for i in indexes]},
                 differentiable=False, name="similarity_focus")


def _rasterize_polygon_np(poly, x0, y0, x1, y1, M):
    """Point-in-polygon (crossing number) over an M x M grid spanning the
    box [x0,x1] x [y0,y1] — numpy-vectorized over the grid."""
    xs = x0 + (np.arange(M) + 0.5) * max(x1 - x0, 1e-6) / M
    ys = y0 + (np.arange(M) + 0.5) * max(y1 - y0, 1e-6) / M
    gx, gy = np.meshgrid(xs, ys)                        # [M, M]
    inside = np.zeros((M, M), bool)
    n = poly.shape[0]
    for i in range(n):
        xa, ya = poly[i]
        xb, yb = poly[(i + 1) % n]
        cond = ((ya > gy) != (yb > gy))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = xa + (gy - ya) * (xb - xa) / (yb - ya + 1e-12)
        inside ^= cond & (gx < xint)
    return inside


def _generate_mask_labels_raw(rois, roi_labels, gt_polys, poly_lens,
                              gt_classes, resolution=14):
    """Mask R-CNN mask targets (ref operators/detection/
    generate_mask_labels_op.cc, which rasterises COCO polygons per fg
    roi): each fg roi takes the gt polygon of its class whose bounding box
    overlaps it most and rasterises the polygon restricted to the roi into
    an M x M binary grid. Dense contract: gt_polys [G, P, 2] zero-padded
    with poly_lens [G]; outputs (mask_int32 [R, M, M], roi_has_mask [R]).
    Background rois (label <= 0) produce zero masks."""
    r = _np(rois)
    lab = _np(roi_labels).reshape(-1)
    polys = _np(gt_polys)
    plens = _np(poly_lens).reshape(-1)
    gcls = _np(gt_classes).reshape(-1)
    R = r.shape[0]
    M = resolution
    masks = np.zeros((R, M, M), np.int32)
    has = np.zeros((R,), np.int32)
    if polys.shape[0]:
        # gt bbox per polygon
        boxes = np.zeros((polys.shape[0], 4), np.float32)
        for g in range(polys.shape[0]):
            p = polys[g, :max(int(plens[g]), 1)]
            boxes[g] = [p[:, 0].min(), p[:, 1].min(),
                        p[:, 0].max(), p[:, 1].max()]
        iou = _iou_corner_np(r, boxes)
        # a roi may only take a mask from a gt of its class
        same_cls = gcls[None, :] == lab[:, None]
        iou = np.where(same_cls, iou, 0.0)
        best = iou.argmax(axis=1)
        for i in range(R):
            if lab[i] <= 0 or iou[i, best[i]] <= 0:
                continue
            g = best[i]
            poly = polys[g, :int(plens[g])]
            m = _rasterize_polygon_np(poly, r[i, 0], r[i, 1],
                                      r[i, 2], r[i, 3], M)
            masks[i] = m.astype(np.int32)
            has[i] = 1
    return _back(masks, rois), _back(has, rois)


register_op("generate_mask_labels", _generate_mask_labels_raw)
