"""nn.functional — activations, linear and embedding, dropout, conv and
pooling, norms, losses and the vision helpers (the port of
`paddle_tpu/nn/functional.py`; ref python/paddle/nn/functional/*).

Every op is a raw torch form registered under the JAX package's name and
run by the dispatcher (`ops/dispatch.py`), so the dtype rule, the AMP
lists and autograd are the op library's. Where torch has the fused form
of an op (`layer_norm`, `gelu`, `softmax`, `log_softmax`, the cross
entropy, the convolutions, `batch_norm`, `group_norm`, `instance_norm`,
`pixel_shuffle`, `unfold`, the pools) the raw form calls it; where the
JAX package's semantics part from torch's default the raw form keeps
the JAX package's:

  - `linear`'s weight is [in_features, out_features] (torch's is
    [out, in]);
  - `batch_norm`'s running statistics update as momentum * running +
    (1 - momentum) * batch with the biased variance, computed here (torch
    takes the other momentum and the unbiased variance);
  - `cross_entropy`'s mean divides by max(#valid, 1), so it is 0, not
    NaN, when every label is `ignore_index`; [N, 1] labels are
    squeezed; `soft_label` and `use_softmax=False` are their own
    branches;
  - `embedding` zeroes the rows of `padding_idx` in the output (torch
    only stops their gradient), and a negative index counts from the
    end;
  - `interpolate` computes its source coordinates as the JAX package
    does (`align_mode=1`, the cubic kernel, "area" as `jax.image.resize`'s
    antialiased linear filter), and pooling pads explicitly, so
    `ceil_mode` windows and exclusive averages count as the JAX
    package's do;
  - `binary_cross_entropy`, `bce_with_logits` (`pos_weight` scales the
    whole term), `kl_div`, `nll_loss` (classes on the last axis),
    `local_response_norm` (alpha times the window's sum) and `ctc_loss`
    (its own forward in f32 with `norm_by_times`) are the JAX package's
    formulas.

Dropout, `alpha_dropout` and `gumbel_softmax` draw from the framework
generator on the input's device (`paddle.seed` replays them); the JAX
package draws from JAX keys, so the masks differ from its.

The JAX package's `PT_LN_SINGLE_PASS` experiment is not ported.
"""
import functools
import math
import numbers

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework import state
from ..framework.dtype import convert_dtype, dtype_name
from ..framework.tensor import Tensor
from ..ops import math as _math
from ..ops.dispatch import OP_REGISTRY, apply, as_array, register_op

# ----------------------------------------------------------------- activations


def _unary(fn, name):
    register_op(name, fn)

    def op(x, name=None, _opname=name):
        return apply(fn, (x,), name=_opname)
    op.__name__ = name
    op.raw = fn
    return op


relu = _unary(torch.relu, "relu")
relu6 = _unary(TF.relu6, "relu6")
sigmoid = _unary(_math.sigmoid.raw, "sigmoid")
tanh = _unary(_math.tanh.raw, "tanh")
silu = _unary(TF.silu, "silu")
swish = silu
mish = _unary(TF.mish, "mish")
hardswish = _unary(TF.hardswish, "hardswish")
hardsigmoid = _unary(lambda a: torch.clamp(a / 6.0 + 0.5, 0.0, 1.0),
                     "hardsigmoid")
tanhshrink = _unary(lambda a: a - torch.tanh(a), "tanhshrink")


def _gelu_raw(a, approximate=False):
    return TF.gelu(a, approximate="tanh" if approximate else "none")


register_op("gelu", _gelu_raw)


def gelu(x, approximate=False, name=None):
    return apply(_gelu_raw, (x,), {"approximate": bool(approximate)},
                 name="gelu")


def _leaky_relu_raw(a, negative_slope=0.01):
    return torch.where(a >= 0, a, a * negative_slope)


register_op("leaky_relu", _leaky_relu_raw)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(_leaky_relu_raw, (x,),
                 {"negative_slope": float(negative_slope)}, name="leaky_relu")


def _elu_raw(a, alpha=1.0):
    return TF.elu(a, alpha)


def _celu_raw(a, alpha=1.0):
    return TF.celu(a, alpha)


def _selu_raw(a, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(a > 0, a, alpha * torch.expm1(a))


def _prelu_raw(a, w, data_format="NCHW"):
    if w.numel() == 1:
        return torch.where(a > 0, a, w.reshape(()) * a)
    ch_axis = 1 if data_format == "NCHW" else a.dim() - 1
    shape = [1] * a.dim()
    shape[ch_axis] = w.numel()
    return torch.where(a > 0, a, w.reshape(shape) * a)


def _hardtanh_raw(a, lo=-1.0, hi=1.0):
    return torch.clamp(a, lo, hi)


def _hardshrink_raw(a, threshold=0.5):
    return torch.where(torch.abs(a) > threshold, a, torch.zeros_like(a))


def _softshrink_raw(a, threshold=0.5):
    zero = torch.zeros_like(a)
    return torch.where(a > threshold, a - threshold,
                       torch.where(a < -threshold, a + threshold, zero))


def _softplus_raw(a, beta=1.0, threshold=20.0):
    return TF.softplus(a, beta, threshold)


def _softsign_raw(a):
    return a / (1 + torch.abs(a))


def _maxout_raw(a, groups=1, axis=1):
    axis = axis % a.dim()
    shape = list(a.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(a.reshape(shape), dim=axis + 1)


register_op("elu", _elu_raw)
register_op("celu", _celu_raw)
register_op("selu", _selu_raw)
register_op("prelu", _prelu_raw)
register_op("hardtanh", _hardtanh_raw)
register_op("hardshrink", _hardshrink_raw)
register_op("softshrink", _softshrink_raw)
register_op("softplus", _softplus_raw)
register_op("softsign", _softsign_raw)
register_op("maxout", _maxout_raw)


def elu(x, alpha=1.0, name=None):
    return apply(_elu_raw, (x,), {"alpha": float(alpha)}, name="elu")


def celu(x, alpha=1.0, name=None):
    return apply(_celu_raw, (x,), {"alpha": float(alpha)}, name="celu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply(_selu_raw, (x,),
                 {"scale": float(scale), "alpha": float(alpha)}, name="selu")


def prelu(x, weight, data_format="NCHW", name=None):
    return apply(_prelu_raw, (x, weight), {"data_format": str(data_format)},
                 name="prelu")


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(_hardtanh_raw, (x,), {"lo": float(min), "hi": float(max)},
                 name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply(_hardshrink_raw, (x,), {"threshold": float(threshold)},
                 name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply(_softshrink_raw, (x,), {"threshold": float(threshold)},
                 name="softshrink")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply(_softplus_raw, (x,),
                 {"beta": float(beta), "threshold": float(threshold)},
                 name="softplus")


def softsign(x, name=None):
    return apply(_softsign_raw, (x,), name="softsign")


def maxout(x, groups, axis=1, name=None):
    return apply(_maxout_raw, (x,),
                 {"groups": int(groups), "axis": int(axis)}, name="maxout")


def _to_dtype_attr(dtype):
    return None if dtype is None else dtype_name(convert_dtype(dtype))


def _softmax_raw(a, axis=-1, to_dtype=None):
    if to_dtype is not None:
        a = a.to(convert_dtype(to_dtype))
    return torch.softmax(a, dim=axis)


register_op("softmax", _softmax_raw)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply(_softmax_raw, (x,),
                 {"axis": int(axis), "to_dtype": _to_dtype_attr(dtype)},
                 name="softmax")


def _log_softmax_raw(a, axis=-1, to_dtype=None):
    if to_dtype is not None:
        a = a.to(convert_dtype(to_dtype))
    return torch.log_softmax(a, dim=axis)


register_op("log_softmax", _log_softmax_raw)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply(_log_softmax_raw, (x,),
                 {"axis": int(axis), "to_dtype": _to_dtype_attr(dtype)},
                 name="log_softmax")


def _gumbel_softmax_raw(a, temperature=1.0, hard=False, axis=-1,
                        generator=None):
    u = torch.rand(a.shape, generator=generator, device=a.device)
    g = -torch.log(-torch.log(u + 1e-20)).to(a.dtype)
    y = torch.softmax((a + g) / temperature, dim=axis)
    if hard:
        # straight-through: one-hot forward, soft gradient
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = onehot + y - y.detach()
    return y


register_op("gumbel_softmax", _gumbel_softmax_raw)


def _generator_of(x):
    d = x._data.device if isinstance(x, Tensor) else state.current_device()
    return state.rng_generator(d)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return apply(_gumbel_softmax_raw, (x,),
                 {"temperature": float(temperature), "hard": bool(hard),
                  "axis": int(axis), "generator": _generator_of(x)},
                 name="gumbel_softmax")


# ----------------------------------------------------------------- linear / emb

def _linear_raw(a, w, b=None):
    return TF.linear(a, w.t(), b)


register_op("linear", _linear_raw)


def linear(x, weight, bias=None, name=None):
    """Paddle's weight layout: [in_features, out_features] (ref
    nn/functional/common.py:1419)."""
    if bias is None:
        return apply(_linear_raw, (x, weight), name="linear")
    return apply(_linear_raw, (x, weight, bias), name="linear")


def _embedding_raw(idx, w, padding_idx=None, sparse=False):
    out = TF.embedding(idx, w, padding_idx=padding_idx, sparse=sparse)
    if padding_idx is not None:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


register_op("embedding", _embedding_raw)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """A gather of the table's rows. `sparse=True` on a trainable leaf
    table (a Parameter, with grad enabled) gives the table a row-sparse
    gradient, which its `.grad` presents as a `SelectedRows` (ref
    lookup_table_v2_op is_sparse)."""
    if padding_idx is not None and padding_idx < 0:
        # paddle semantics: a negative pad indexes from the end
        padding_idx = int(as_array(weight).shape[0]) + int(padding_idx)
    w = as_array(weight)
    sparse = bool(sparse) and torch.is_grad_enabled() and isinstance(
        w, torch.Tensor) and w.requires_grad and w.grad_fn is None
    return apply(_embedding_raw, (x, weight),
                 {"padding_idx": None if padding_idx is None
                  else int(padding_idx), "sparse": sparse},
                 name="embedding")


def one_hot(x, num_classes, name=None):
    from ..ops.manipulation import _one_hot_raw
    return apply(_one_hot_raw, (x,), {"num_classes": int(num_classes)},
                 differentiable=False, name="one_hot")


# ----------------------------------------------------------------- dropout

def _dropout_raw(v, p=0.5, axis=None, mode="upscale_in_train",
                 training=True, generator=None):
    if not training or p == 0.0:
        return v
    shape = tuple(v.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = tuple(s if i in axes else 1 for i, s in enumerate(v.shape))
    keep = torch.empty(shape, device=v.device).bernoulli_(
        1.0 - p, generator=generator).bool()
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    if mode == "upscale_in_train":
        return torch.where(keep, v / (1.0 - p), zero)
    return torch.where(keep, v, zero)


register_op("dropout", _dropout_raw)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else Tensor(x)
    if isinstance(axis, (list, tuple)):
        axis = [int(a) for a in axis]
    elif axis is not None:
        axis = int(axis)
    return apply(_dropout_raw, (x,),
                 {"p": float(p), "axis": axis, "mode": mode,
                  "training": bool(training), "generator": _generator_of(x)},
                 name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def _alpha_dropout_raw(v, p=0.5, generator=None):
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = torch.empty(v.shape, device=v.device).bernoulli_(
        1.0 - p, generator=generator).bool()
    q = 1.0 - p
    coef_a = (q + alpha_p ** 2 * q * p) ** -0.5
    coef_b = -coef_a * alpha_p * p
    return coef_a * torch.where(keep, v, torch.full_like(v, alpha_p)) + \
        coef_b


register_op("alpha_dropout", _alpha_dropout_raw)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return apply(_alpha_dropout_raw, (x,),
                 {"p": float(p), "generator": _generator_of(x)},
                 name="alpha_dropout")


# ----------------------------------------------------------------- conv / pool

def _norm_tuple(v, n):
    if isinstance(v, numbers.Number):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    return v


def _conv_padding(padding, n):
    """A paddle padding spec -> "SAME", "VALID" or n (lo, hi) pairs: an
    int, n ints, n pairs, or 2n ints [before0, after0, ...]."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, numbers.Number):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(int(i) for i in p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _pads(padding, n, spatial, ksize, strides, dilations):
    """(lo, hi) per spatial axis; "SAME" and "VALID" as XLA resolves
    them (SAME: out = ceil(in / stride), the extra cell on the high
    side)."""
    pad = _conv_padding(padding, n)
    if pad == "VALID":
        return [(0, 0)] * n
    if pad == "SAME":
        out = []
        for size, k, s, d in zip(spatial, ksize, strides, dilations):
            keff = (k - 1) * d + 1
            total = max((-(-size // s) - 1) * s + keff - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pad, str):
        raise ValueError(f"bad padding {padding}")
    return pad


def _torch_pad(pads):
    """(lo, hi) pairs of the leading-to-last spatial axes as torch's
    F.pad list (last axis first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _to_channels_first(a, n, channels_last):
    if not channels_last:
        return a
    return a.permute(0, a.dim() - 1, *range(1, a.dim() - 1))


def _from_channels_first(a, n, channels_last):
    if not channels_last:
        return a
    return a.permute(0, *range(2, a.dim()), 1)


_TORCH_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _convnd_raw(a, w, *maybe_b, n=2, stride=1, padding=0, dilation=1,
                groups=1, channels_last=False):
    """Shared N-d conv (ref conv_op.cc): weight [out_c, in_c/g, *k];
    torch's convolution, an asymmetric padding applied before it."""
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    x = _to_channels_first(a, n, channels_last)
    pads = _pads(padding, n, x.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        x = TF.pad(x, _torch_pad(pads))
        sym = 0
    out = _TORCH_CONV[n](x, w, maybe_b[0] if maybe_b else None,
                         stride=strides, padding=sym, dilation=dilations,
                         groups=groups)
    return _from_channels_first(out, n, channels_last)


def _conv1d_raw(a, w, *maybe_b, stride=1, padding=0, dilation=1, groups=1,
                channels_last=False):
    return _convnd_raw(a, w, *maybe_b, n=1, stride=stride, padding=padding,
                       dilation=dilation, groups=groups,
                       channels_last=channels_last)


def _conv2d_raw(a, w, *maybe_b, stride=1, padding=0, dilation=1, groups=1,
                channels_last=False):
    return _convnd_raw(a, w, *maybe_b, n=2, stride=stride, padding=padding,
                       dilation=dilation, groups=groups,
                       channels_last=channels_last)


def _conv3d_raw(a, w, *maybe_b, stride=1, padding=0, dilation=1, groups=1,
                channels_last=False):
    return _convnd_raw(a, w, *maybe_b, n=3, stride=stride, padding=padding,
                       dilation=dilation, groups=groups,
                       channels_last=channels_last)


register_op("conv1d", _conv1d_raw)
register_op("conv2d", _conv2d_raw)
register_op("conv3d", _conv3d_raw)


def _pad_attr(padding):
    if isinstance(padding, str):
        return padding
    if isinstance(padding, numbers.Number):
        return int(padding)
    return [list(int(i) for i in p) if isinstance(p, (list, tuple))
            else int(p) for p in padding]


def _stride_attr(v):
    if isinstance(v, numbers.Number):
        return int(v)
    return [int(i) for i in v]


def _conv(name, x, weight, bias, stride, padding, dilation, groups,
          channels_last):
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply(OP_REGISTRY[name], args,
                 {"stride": _stride_attr(stride), "padding": _pad_attr(padding),
                  "dilation": _stride_attr(dilation), "groups": int(groups),
                  "channels_last": channels_last}, name=name)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """weight layout: [out_c, in_c/groups, kh, kw] (ref conv_op.cc)."""
    return _conv("conv2d", x, weight, bias, stride, padding, dilation, groups,
                 data_format != "NCHW")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv("conv1d", x, weight, bias, stride, padding, dilation, groups,
                 data_format != "NCL")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation, groups,
                 data_format != "NCDHW")


_TORCH_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
                 3: TF.conv_transpose3d}


def _convnd_transpose_raw(a, w, *maybe_b, n=2, stride=1, padding=0,
                          output_padding=0, dilation=1, groups=1):
    """N-d transposed conv, NCX layout, weight [in_c, out_c/g, *k] (ref
    conv_transpose_op.cc): torch's full transposed convolution, then
    each axis cropped by its (lo, hi) padding and extended by
    `output_padding` at its high end, the bias added after."""
    strides = _norm_tuple(stride, n)
    dilations = _norm_tuple(dilation, n)
    out_pad = _norm_tuple(output_padding, n)
    pad = _conv_padding(padding, n)
    if isinstance(pad, str):
        if pad != "VALID":
            raise ValueError("SAME padding unsupported for conv_transpose")
        pad = [(0, 0)] * n
    out = _TORCH_CONV_T[n](a, w, None, stride=strides, padding=0,
                           output_padding=0, groups=groups,
                           dilation=dilations)
    for i in range(n):
        ax = 2 + i
        full = out.shape[ax]
        lo, hi = pad[i]
        end = full - hi + out_pad[i]
        out = out.narrow(ax, lo, min(end, full) - lo)
        if end > full:
            shape = list(out.shape)
            shape[ax] = end - full
            out = torch.cat([out, out.new_zeros(shape)], dim=ax)
    if maybe_b:
        out = out + maybe_b[0].reshape((1, -1) + (1,) * n)
    return out


def _conv2d_transpose_raw(a, w, *maybe_b, stride=1, padding=0,
                          output_padding=0, dilation=1, groups=1,
                          channels_last=False):
    """weight layout: [in_c, out_c/groups, kh, kw]."""
    x = _to_channels_first(a, 2, channels_last)
    out = _convnd_transpose_raw(x, w, *maybe_b, n=2, stride=stride,
                                padding=padding,
                                output_padding=output_padding,
                                dilation=dilation, groups=groups)
    return _from_channels_first(out, 2, channels_last)


register_op("conv2d_transpose", _conv2d_transpose_raw)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1, output_size=None,
                     data_format="NCHW", name=None):
    """weight layout: [in_c, out_c/groups, kh, kw] (ref
    conv_transpose_op.cc)."""
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply(_conv2d_transpose_raw, args,
                 {"stride": _stride_attr(stride), "padding": _pad_attr(padding),
                  "output_padding": _stride_attr(output_padding),
                  "dilation": _stride_attr(dilation), "groups": int(groups),
                  "channels_last": data_format != "NCHW"},
                 name="conv2d_transpose")


_TORCH_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_TORCH_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _poolnd_raw(a, n=2, ksize=1, strides=None, padding=0,
                channels_last=False, average=False, count_include_pad=True,
                ceil_mode=False):
    """Shared 1/2/3-d pooling over NCX or NXC: the padding (and
    ceil_mode's extension of the high edge, ref pooling.cc) applied
    explicitly (-inf for max, 0 for an average), then torch's pool
    without padding. An average divides by the window's size, or, with
    count_include_pad=False and a padding, by the count of real
    cells."""
    ksize = _norm_tuple(ksize, n)
    strides = _norm_tuple(strides or ksize, n)
    x = _to_channels_first(a, n, channels_last)
    spatial = x.shape[2:]
    pads = [list(p) for p in _pads(padding, n, spatial, ksize, strides,
                                   (1,) * n)]
    if ceil_mode and not isinstance(padding, str):
        for i in range(n):
            size, (pl, ph) = spatial[i], pads[i]
            total = size + pl + ph
            out = -(-(total - ksize[i]) // strides[i]) + 1     # ceil count
            # a window starting entirely in the high pad is not a window
            if (out - 1) * strides[i] >= size + pl:
                out -= 1
            needed = (out - 1) * strides[i] + ksize[i]
            if needed > total:
                pads[i][1] += needed - total
    tp = _torch_pad(pads)
    padded = any(tp)
    if average:
        xp = TF.pad(x, tp) if padded else x
        out = _TORCH_AVG_POOL[n](xp, ksize, strides)
        if padded and not count_include_pad and padding != "VALID":
            ones = TF.pad(torch.ones_like(x[:1, :1]), tp)
            out = out / _TORCH_AVG_POOL[n](ones, ksize, strides)
    else:
        xp = TF.pad(x, tp, value=-math.inf) if padded else x
        out = _TORCH_MAX_POOL[n](xp, ksize, strides)
    return _from_channels_first(out, n, channels_last)


register_op("max_pool2d", functools.partial(_poolnd_raw, n=2, average=False))
register_op("avg_pool2d", functools.partial(_poolnd_raw, n=2, average=True))


def _pool(x, ksize, strides, padding, data_format, name,
          ceil_mode=False, count_include_pad=True, average=False):
    attrs = {"ksize": _stride_attr(ksize),
             "strides": None if strides is None else _stride_attr(strides),
             "padding": _pad_attr(padding),
             "channels_last": data_format != "NCHW"}
    if ceil_mode:
        attrs["ceil_mode"] = True
    if average:
        attrs["count_include_pad"] = bool(count_include_pad)
    return apply(OP_REGISTRY[name], (x,), attrs, name=name)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, data_format,
                 "max_pool2d", ceil_mode=ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, divisor_override=None,
               data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, data_format,
                 "avg_pool2d", ceil_mode=ceil_mode,
                 count_include_pad=count_include_pad, average=True)


def _adaptive_avg_pool2d_raw(a, output_size=1, channels_last=False):
    """Bins [floor(i * I / O), ceil((i + 1) * I / O)) (ref pooling.cc
    AdaptStartIndex/EndIndex), torch's adaptive pool."""
    x = _to_channels_first(a, 2, channels_last)
    out = TF.adaptive_avg_pool2d(x, _norm_tuple(output_size, 2))
    return _from_channels_first(out, 2, channels_last)


def _adaptive_max_pool2d_raw(a, output_size=1):
    return TF.adaptive_max_pool2d(a, _norm_tuple(output_size, 2))


register_op("adaptive_avg_pool2d", _adaptive_avg_pool2d_raw)
register_op("adaptive_max_pool2d", _adaptive_max_pool2d_raw)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return apply(_adaptive_avg_pool2d_raw, (x,),
                 {"output_size": _stride_attr(output_size),
                  "channels_last": data_format != "NCHW"},
                 name="adaptive_avg_pool2d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return apply(_adaptive_max_pool2d_raw, (x,),
                 {"output_size": _stride_attr(output_size)},
                 name="adaptive_max_pool2d")


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    t = x.unsqueeze(-1) if isinstance(x, Tensor) else Tensor(x).unsqueeze(-1)
    out = max_pool2d(t, (int(kernel_size) if isinstance(kernel_size, int)
                         else kernel_size[0], 1),
                     (int(stride) if isinstance(stride, (int, type(None)))
                      and stride else (stride[0] if stride else None), 1)
                     if stride else None,
                     padding=(padding if isinstance(padding, int)
                              else padding[0], 0), ceil_mode=ceil_mode)
    return out.squeeze(-1)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, name=None):
    t = x.unsqueeze(-1)
    out = avg_pool2d(t, (kernel_size if isinstance(kernel_size, int)
                         else kernel_size[0], 1),
                     (stride if isinstance(stride, int) else None, 1)
                     if stride else None,
                     padding=(padding if isinstance(padding, int)
                              else padding[0], 0), ceil_mode=ceil_mode,
                     count_include_pad=count_include_pad)
    return out.squeeze(-1)


# ----------------------------------------------------------------- norm

def _batch_norm_raw(v, rm, rv, *wb, ch_axis=1, momentum=0.9, epsilon=1e-5,
                    training=False):
    """One batch_norm op: y and the updated running statistics as
    outputs (ref operators/batch_norm_op.cc MeanOut/VarianceOut); eval
    mode passes the statistics through. y is torch's batch_norm; the
    statistics are momentum * running + (1 - momentum) * batch, with the
    biased batch variance, in f32."""
    ch = ch_axis % v.dim()
    x = v.movedim(ch, 1) if ch != 1 else v
    w = wb[0] if wb else None
    b = wb[1] if len(wb) > 1 else None
    if training:
        y = TF.batch_norm(x, None, None, w, b, training=True, eps=epsilon)
        with torch.no_grad():
            dims = [i for i in range(x.dim()) if i != 1]
            xs = x if x.dtype == torch.float64 else x.float()
            var, mean = torch.var_mean(xs, dim=dims, unbiased=False)
            new_rm = momentum * rm + (1 - momentum) * mean.to(rm.dtype)
            new_rv = momentum * rv + (1 - momentum) * var.to(rv.dtype)
    else:
        # copies: a later training call writes the buffers in place,
        # and this call's backward must not see it
        new_rm, new_rv = rm.detach().clone(), rv.detach().clone()
        y = TF.batch_norm(x, new_rm, new_rv, w, b, training=False,
                          eps=epsilon)
    if ch != 1:
        y = y.movedim(1, ch)
    return y, new_rm, new_rv


register_op("batch_norm", _batch_norm_raw)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """ref operators/batch_norm_op.cc. In training the running statistics
    are written into `running_mean` and `running_var` in place (a layer's
    buffers, which a captured CUDA graph keeps reading)."""
    ch_axis = 1 if data_format in ("NCHW", "NCL", "NCDHW") else -1
    use_batch_stats = training and not use_global_stats
    args = [x, running_mean, running_var]
    if weight is None and bias is not None:
        weight = Tensor._wrap(torch.ones_like(as_array(bias)))
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    y, new_rm, new_rv = apply(
        _batch_norm_raw, tuple(args),
        {"ch_axis": int(ch_axis), "momentum": float(momentum),
         "epsilon": float(epsilon), "training": bool(use_batch_stats)},
        name="batch_norm")
    if use_batch_stats:
        with torch.no_grad():
            running_mean._data.copy_(new_rm._data)
            running_var._data.copy_(new_rv._data)
    return y


def _layer_norm_raw(a, *wb, nd=1, epsilon=1e-5):
    w = wb[0] if wb else None
    b = wb[1] if len(wb) > 1 else None
    return TF.layer_norm(a, tuple(a.shape[a.dim() - nd:]), w, b, epsilon)


register_op("layer_norm", _layer_norm_raw)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, numbers.Number):
        normalized_shape = (normalized_shape,)
    args = [x]
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    return apply(_layer_norm_raw, tuple(args),
                 {"nd": len(tuple(normalized_shape)),
                  "epsilon": float(epsilon)}, name="layer_norm")


def _instance_norm_raw(a, *wb, eps=1e-5):
    w = wb[0] if wb else None
    b = wb[1] if len(wb) > 1 else None
    return TF.instance_norm(a, weight=w, bias=b, eps=eps)


register_op("instance_norm", _instance_norm_raw)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    args = [x]
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    return apply(_instance_norm_raw, tuple(args), {"eps": float(eps)},
                 name="instance_norm")


def _group_norm_raw(a, *wb, num_groups=1, epsilon=1e-5):
    w = wb[0] if wb else None
    b = wb[1] if len(wb) > 1 else None
    return TF.group_norm(a, num_groups, w, b, epsilon)


register_op("group_norm", _group_norm_raw)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    args = [x]
    if weight is not None:
        args.append(weight)
        if bias is not None:
            args.append(bias)
    return apply(_group_norm_raw, tuple(args),
                 {"num_groups": int(num_groups), "epsilon": float(epsilon)},
                 name="group_norm")


def _normalize_raw(a, p=2, axis=1, epsilon=1e-12):
    nrm = torch.linalg.vector_norm(a, ord=p, dim=axis, keepdim=True)
    return a / torch.clamp_min(nrm, epsilon)


register_op("normalize", _normalize_raw)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return apply(_normalize_raw, (x,),
                 {"p": float(p), "axis": int(axis), "epsilon": float(epsilon)},
                 name="normalize")


def _local_response_norm_raw(a, size=5, alpha=1e-4, beta=0.75, k=1.0):
    """a / (k + alpha * sum of the squares over `size` channels)^beta
    (the JAX package's: alpha times the window's sum)."""
    half = size // 2
    sq = TF.pad(torch.square(a).movedim(1, -1), (half, size - 1 - half))
    c = a.shape[1]
    window = sum(sq[..., i:i + c] for i in range(size)).movedim(-1, 1)
    return a / torch.pow(k + alpha * window, beta)


register_op("local_response_norm", _local_response_norm_raw)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return apply(_local_response_norm_raw, (x,),
                 {"size": int(size), "alpha": float(alpha),
                  "beta": float(beta), "k": float(k)},
                 name="local_response_norm")


# ----------------------------------------------------------------- losses

def _reduce_loss(per, reduction):
    if reduction == "mean":
        return torch.mean(per)
    if reduction == "sum":
        return torch.sum(per)
    return per


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """ref operators/softmax_with_cross_entropy_op.cc: fused log_softmax
    + NLL (torch's cross entropy)."""
    args = (input, label) if weight is None else (input, label, weight)
    return apply(_cross_entropy_raw, args,
                 {"ignore_index": int(ignore_index), "reduction": reduction,
                  "soft_label": bool(soft_label), "axis": int(axis),
                  "use_softmax": bool(use_softmax)}, name="cross_entropy")


def _cross_entropy_raw(logits, lab, *maybe_w, ignore_index=-100,
                       reduction="mean", soft_label=False, axis=-1,
                       use_softmax=True):
    axis = axis % logits.dim()
    if soft_label:
        logp = torch.log_softmax(logits, dim=axis) if use_softmax else \
            torch.log(torch.clamp_min(logits, 1e-30))
        return _reduce_loss(-torch.sum(lab * logp, dim=axis), reduction)
    lab_i = lab.long()
    if lab_i.dim() == logits.dim():              # [N, 1] style labels
        lab_i = lab_i.squeeze(axis)
    valid = lab_i != ignore_index
    safe = torch.where(valid, lab_i, 0)
    w = maybe_w[0] if maybe_w else None
    if use_softmax:
        x = logits.movedim(axis, 1) if logits.dim() > 1 else logits
        per = TF.cross_entropy(x, lab_i, ignore_index=ignore_index,
                               reduction="none")
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-30))
        per = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
        per = torch.where(valid, per, torch.zeros_like(per))
    if w is not None:
        # the class weights multiply here (torch's weight= takes no
        # gradient)
        per = per * torch.where(valid, w[safe], 0.0)
    if reduction == "mean":
        if w is not None:
            denom = torch.sum(torch.where(valid, w[safe], 0.0))
        else:
            denom = torch.clamp_min(valid.sum().to(per.dtype), 1.0)
        return torch.sum(per) / denom
    return _reduce_loss(per, reduction)


register_op("cross_entropy", _cross_entropy_raw)


softmax_with_cross_entropy = cross_entropy


def _nll_loss_raw(logp, lab, *maybe_w, ignore_index=-100, reduction="mean"):
    """Classes on the last axis (the JAX package's layout)."""
    lab_i = lab.long()
    valid = lab_i != ignore_index
    safe = torch.where(valid, lab_i, 0)
    per = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if maybe_w:
        per = per * maybe_w[0][safe]
    per = torch.where(valid, per, torch.zeros_like(per))
    if reduction == "mean":
        denom = (torch.sum(maybe_w[0][safe] * valid) if maybe_w
                 else torch.clamp_min(valid.sum().to(per.dtype), 1.0))
        return torch.sum(per) / denom
    return _reduce_loss(per, reduction)


register_op("nll_loss", _nll_loss_raw)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    args = (input, label) if weight is None else (input, label, weight)
    return apply(_nll_loss_raw, args,
                 {"ignore_index": int(ignore_index),
                  "reduction": str(reduction)}, name="nll_loss")


def _mse_loss_raw(a, b, reduction="mean"):
    return _reduce_loss(torch.square(a - b), reduction)


def _l1_loss_raw(a, b, reduction="mean"):
    return _reduce_loss(torch.abs(a - b), reduction)


def _smooth_l1_loss_raw(a, b, reduction="mean", delta=1.0):
    d = torch.abs(a - b)
    per = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(per, reduction)


register_op("mse_loss", _mse_loss_raw)
register_op("l1_loss", _l1_loss_raw)
register_op("smooth_l1_loss", _smooth_l1_loss_raw)


def mse_loss(input, label, reduction="mean", name=None):
    return apply(_mse_loss_raw, (input, label),
                 {"reduction": str(reduction)}, name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply(_l1_loss_raw, (input, label),
                 {"reduction": str(reduction)}, name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return apply(_smooth_l1_loss_raw, (input, label),
                 {"reduction": str(reduction), "delta": float(delta)},
                 name="smooth_l1_loss")


def _binary_cross_entropy_raw(p, y, *maybe_w, reduction="mean"):
    per = -(y * torch.log(torch.clamp_min(p, 1e-12))
            + (1 - y) * torch.log(torch.clamp_min(1 - p, 1e-12)))
    if maybe_w:
        per = per * maybe_w[0]
    return _reduce_loss(per, reduction)


register_op("binary_cross_entropy", _binary_cross_entropy_raw)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    args = (input, label) if weight is None else (input, label, weight)
    return apply(_binary_cross_entropy_raw, args,
                 {"reduction": str(reduction)}, name="binary_cross_entropy")


def _logit_bce(z, y):
    """max(z, 0) - z y + log(1 + exp(-|z|)), stable."""
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))


def _bce_with_logits_raw(z, y, *rest, has_weight=False, has_pos_weight=False,
                         reduction="mean"):
    w = rest[0] if has_weight else None
    pw = rest[1 if has_weight else 0] if has_pos_weight else None
    per = _logit_bce(z, y)
    if pw is not None:
        per = per * ((pw - 1) * y + 1)
    if w is not None:
        per = per * w
    return _reduce_loss(per, reduction)


register_op("bce_with_logits", _bce_with_logits_raw)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    args = [logit, label]
    if weight is not None:
        args.append(weight)
    if pos_weight is not None:
        args.append(pos_weight)
    return apply(_bce_with_logits_raw, tuple(args),
                 {"has_weight": weight is not None,
                  "has_pos_weight": pos_weight is not None,
                  "reduction": str(reduction)}, name="bce_with_logits")


def _kl_div_raw(logp, y, reduction="mean"):
    per = y * (torch.log(torch.clamp_min(y, 1e-12)) - logp)
    if reduction == "batchmean":
        return torch.sum(per) / logp.shape[0]
    return _reduce_loss(per, reduction)


register_op("kl_div", _kl_div_raw)


def kl_div(input, label, reduction="mean", name=None):
    return apply(_kl_div_raw, (input, label),
                 {"reduction": str(reduction)}, name="kl_div")


def _margin_ranking_loss_raw(a, b, y, margin=0.0, reduction="mean"):
    return _reduce_loss(torch.clamp_min(-y * (a - b) + margin, 0.0),
                        reduction)


register_op("margin_ranking_loss", _margin_ranking_loss_raw)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply(_margin_ranking_loss_raw, (input, other, label),
                 {"margin": float(margin), "reduction": str(reduction)},
                 name="margin_ranking_loss")


def _hinge_embedding_loss_raw(a, y, margin=1.0, reduction="mean"):
    per = torch.where(y == 1, a, torch.clamp_min(margin - a, 0.0))
    return _reduce_loss(per, reduction)


register_op("hinge_embedding_loss", _hinge_embedding_loss_raw)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply(_hinge_embedding_loss_raw, (input, label),
                 {"margin": float(margin), "reduction": str(reduction)},
                 name="hinge_embedding_loss")


def _cosine_similarity_raw(a, b, axis=1, eps=1e-8):
    num = torch.sum(a * b, dim=axis)
    den = torch.clamp_min(torch.linalg.vector_norm(a, dim=axis)
                          * torch.linalg.vector_norm(b, dim=axis), eps)
    return num / den


register_op("cosine_similarity", _cosine_similarity_raw)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    return apply(_cosine_similarity_raw, (x1, x2),
                 {"axis": int(axis), "eps": float(eps)},
                 name="cosine_similarity")


def _square_error_cost_raw(a, b):
    return torch.square(a - b)


register_op("square_error_cost", _square_error_cost_raw)


def square_error_cost(input, label):
    return apply(_square_error_cost_raw, (input, label),
                 name="square_error_cost")


def _sigmoid_focal_loss_raw(z, y, *maybe_n, alpha=0.25, gamma=2.0,
                            reduction="sum"):
    p = torch.sigmoid(z)
    ce = _logit_bce(z, y)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    per = a_t * torch.pow(1 - p_t, gamma) * ce
    if maybe_n:
        per = per / maybe_n[0]
    return _reduce_loss(per, reduction)


register_op("sigmoid_focal_loss", _sigmoid_focal_loss_raw)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    args = (logit, label) if normalizer is None else (logit, label,
                                                      normalizer)
    return apply(_sigmoid_focal_loss_raw, args,
                 {"alpha": float(alpha), "gamma": float(gamma),
                  "reduction": str(reduction)}, name="sigmoid_focal_loss")


# ----------------------------------------------------------------- padding etc.

def _pad_index(n, lo, hi, mode, device):
    """Source index of each cell of an axis of size n padded by (lo, hi)
    in a non-constant mode (jnp.pad's reflect, edge and wrap)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return torch.clamp(i, 0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def _pad_raw(a, pad=(), mode="constant", value=0.0, channels_first=True):
    p = [int(v) for v in pad]
    if len(p) == 2 * a.dim():
        cfg = [(p[2 * i], p[2 * i + 1]) for i in range(a.dim())]
    else:
        # paddle: pad applies to the last len(p) // 2 spatial dims, the
        # innermost first
        n_spatial = len(p) // 2
        cfg = [(0, 0)] * a.dim()
        dims = list(range(a.dim() - n_spatial, a.dim())) if channels_first \
            else list(range(1, 1 + n_spatial))
        for i, d in enumerate(reversed(dims)):
            cfg[d] = (p[2 * i], p[2 * i + 1])
    if mode == "constant":
        return TF.pad(a, _torch_pad(cfg), value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    out = a
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            out = torch.index_select(out, d, _pad_index(a.shape[d], lo, hi,
                                                        mode, a.device))
    return out


register_op("pad", _pad_raw)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return apply(_pad_raw, (x,),
                 {"pad": [int(v) for v in pad], "mode": str(mode),
                  "value": float(value),
                  "channels_first": data_format.startswith("NC")}, name="pad")


def _unfold_raw(a, k=(1, 1), s=(1, 1), p=(0, 0), d=(1, 1)):
    return TF.unfold(a, tuple(k), dilation=tuple(d), padding=tuple(p),
                     stride=tuple(s))


register_op("unfold", _unfold_raw)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return apply(_unfold_raw, (x,),
                 {"k": list(_norm_tuple(kernel_sizes, 2)),
                  "s": list(_norm_tuple(strides, 2)),
                  "p": list(_norm_tuple(paddings, 2)),
                  "d": list(_norm_tuple(dilations, 2))}, name="unfold")


def _arange(n, device):
    return torch.arange(n, dtype=torch.float32, device=device)


def _interp_axis_coords(out_n, in_n, align_corners, align_mode, device):
    """Source coordinates for each output index along one axis:
    endpoints to endpoints with align_corners, half-pixel centers
    (clamped at 0) with align_mode 0, src = i * in / out with align_mode
    1 (ref interpolate_op.h)."""
    if align_corners:
        ratio = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
        return _arange(out_n, device) * ratio
    scale = in_n / out_n
    if align_mode == 1:
        return _arange(out_n, device) * scale
    return torch.clamp_min((_arange(out_n, device) + 0.5) * scale - 0.5,
                           0.0)


def _axis_shape(a, axis, n):
    shape = [1] * a.dim()
    shape[axis] = n
    return shape


def _interp_linear_1axis(a, axis, out_n, align_corners, align_mode=0):
    in_n = a.shape[axis]
    c = _interp_axis_coords(out_n, in_n, align_corners, align_mode, a.device)
    lo = torch.clamp(torch.floor(c).long(), 0, in_n - 1)
    hi = torch.clamp(lo + 1, 0, in_n - 1)
    w = (c - lo).to(a.dtype).reshape(_axis_shape(a, axis, out_n))
    return torch.index_select(a, axis, lo) * (1.0 - w) + \
        torch.index_select(a, axis, hi) * w


def _interp_nearest_1axis(a, axis, out_n, align_corners):
    """floor(i * in / out) without align, floor(i * ratio + 0.5) with
    align_corners (ref NearestNeighborInterpolate)."""
    in_n = a.shape[axis]
    i = _arange(out_n, a.device)
    if align_corners:
        ratio = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
        idx = torch.floor(i * ratio + 0.5)
    else:
        idx = torch.floor(i * (in_n / out_n))
    return torch.index_select(a, axis, torch.clamp(idx.long(), 0, in_n - 1))


def _interp_cubic_1axis(a, axis, out_n, align_corners):
    """Keys cubic (a = -0.75) with 4-tap gathers; the half-pixel
    coordinates are not clamped (ref bicubic_interp)."""
    in_n = a.shape[axis]
    if align_corners:
        ratio = (in_n - 1) / (out_n - 1) if out_n > 1 else 0.0
        c = _arange(out_n, a.device) * ratio
    else:
        c = (_arange(out_n, a.device) + 0.5) * (in_n / out_n) - 0.5
    base = torch.floor(c).long()
    t = (c - base).to(a.dtype)
    A = -0.75

    def k1(x):      # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k2(x):      # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    ws = [k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)]
    shape = _axis_shape(a, axis, out_n)
    out = None
    for tap, w in zip((-1, 0, 1, 2), ws):
        v = torch.index_select(a, axis, torch.clamp(base + tap, 0, in_n - 1))
        term = v * w.reshape(shape)
        out = term if out is None else out + term
    return out


def _area_weights(in_n, out_n, device):
    """jax.image.resize's antialiased linear filter ("area") as an
    [in, out] matrix: a triangle kernel widened by in / out when
    shrinking, each column normalised, zero outside the input."""
    inv = in_n / out_n
    kscale = max(inv, 1.0)
    f32 = torch.float32
    sample = (torch.arange(out_n, dtype=f32, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_n, dtype=f32,
                                                 device=device)[:, None])
    w = torch.clamp_min(1.0 - x / kscale, 0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_n - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _interpolate_raw(a, size=None, scale_factor=None, mode="nearest",
                     channels_last=False, align_corners=False,
                     align_mode=0):
    """Every interp op family (ref operators/interpolate_op.cc +
    interpolate_v2): linear [NCW], bilinear/nearest/bicubic/area [NCHW],
    trilinear [NCDHW], each spatial axis resampled in turn."""
    n_spatial = a.dim() - 2
    sp_axes = tuple(range(1, 1 + n_spatial)) if channels_last \
        else tuple(range(2, 2 + n_spatial))
    spatial = tuple(a.shape[ax] for ax in sp_axes)
    if size is not None:
        out_sp = tuple(int(v) for v in (
            size if isinstance(size, (list, tuple)) else [size] * n_spatial))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * n_spatial
        out_sp = tuple(int(s * f) for s, f in zip(spatial, sf))
    out = a
    for ax, o in zip(sp_axes, out_sp):
        if mode in ("linear", "bilinear", "trilinear"):
            out = _interp_linear_1axis(out, ax, o, align_corners, align_mode)
        elif mode == "nearest":
            out = _interp_nearest_1axis(out, ax, o, align_corners)
        elif mode == "bicubic":
            out = _interp_cubic_1axis(out, ax, o, align_corners)
        elif out.shape[ax] != o:
            w = _area_weights(out.shape[ax], o, a.device).to(a.dtype)
            out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


register_op("interpolate", _interpolate_raw)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    nd = as_array(x).dim() - 2
    if size is not None:
        size = [int(v) for v in
                (size.tolist() if isinstance(size, Tensor) else size)] \
            if not isinstance(size, numbers.Number) else [int(size)] * nd
    if isinstance(scale_factor, (list, tuple)):
        scale_factor = [float(v) for v in scale_factor]
    elif scale_factor is not None:
        scale_factor = float(scale_factor)
    return apply(_interpolate_raw, (x,),
                 {"size": size, "scale_factor": scale_factor,
                  "mode": str(mode),
                  "channels_last": data_format in ("NHWC", "NWC", "NDHWC"),
                  "align_corners": bool(align_corners),
                  "align_mode": int(align_mode)},
                 name="interpolate")


upsample = interpolate


def _pixel_shuffle_raw(a, r=1):
    return TF.pixel_shuffle(a, r)


register_op("pixel_shuffle", _pixel_shuffle_raw)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply(_pixel_shuffle_raw, (x,), {"r": int(upscale_factor)},
                 name="pixel_shuffle")


def _temporal_shift_raw(a, seg_num=1, shift_ratio=0.25):
    nt, c, h, w = a.shape
    r = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([r[:, 1:, :fold], torch.zeros_like(r[:, -1:, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(r[:, :1, fold:2 * fold]),
                       r[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, r[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


register_op("temporal_shift", _temporal_shift_raw)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return apply(_temporal_shift_raw, (x,),
                 {"seg_num": int(seg_num), "shift_ratio": float(shift_ratio)},
                 name="temporal_shift")


def _grid_sample_raw(a, g, padding_mode="zeros", align_corners=True):
    """Bilinear sampling of a [N, C, H, W] at grid g [N, Hg, Wg, 2] (x, y
    in [-1, 1]); out-of-range corners give 0 ("zeros") or the clamped
    edge."""
    n, c, h, w = a.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        gx, gy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        gx, gy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    x1, y1 = x0 + 1, y0 + 1
    bidx = torch.arange(n, device=a.device)[:, None, None]

    def sample(yy, xx):
        v = a[bidx, :, torch.clamp(yy, 0, h - 1),
              torch.clamp(xx, 0, w - 1)]                   # [N, Hg, Wg, C]
        if padding_mode == "zeros":
            inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            v = torch.where(inb, v, torch.zeros_like(v))
        return v

    wa = ((x1 - gx) * (y1 - gy))[..., None]
    wb = ((x1 - gx) * (gy - y0))[..., None]
    wc = ((gx - x0) * (y1 - gy))[..., None]
    wd = ((gx - x0) * (gy - y0))[..., None]
    out = (sample(y0, x0) * wa + sample(y1, x0) * wb
           + sample(y0, x1) * wc + sample(y1, x1) * wd)
    return out.permute(0, 3, 1, 2)


register_op("grid_sample", _grid_sample_raw)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return apply(_grid_sample_raw, (x, grid),
                 {"padding_mode": str(padding_mode),
                  "align_corners": bool(align_corners)}, name="grid_sample")


def _affine_grid_raw(th, out_shape=(), align_corners=True):
    n, _, h, w = [int(v) for v in out_shape]
    dev, dt = th.device, th.dtype
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=dev, dtype=dt)
    else:
        ys = (torch.arange(h, device=dev, dtype=dt) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev, dtype=dt) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return torch.einsum("nij,hwj->nhwi", th, base)


register_op("affine_grid", _affine_grid_raw)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    shape = [int(v) for v in (out_shape.tolist()
                              if isinstance(out_shape, Tensor) else out_shape)]
    return apply(_affine_grid_raw, (theta,),
                 {"out_shape": shape, "align_corners": bool(align_corners)},
                 name="affine_grid")


def _label_smooth_raw(y, *maybe_p, epsilon=0.1):
    if maybe_p:
        return (1 - epsilon) * y + epsilon * maybe_p[0]
    return (1 - epsilon) * y + epsilon / y.shape[-1]


register_op("label_smooth", _label_smooth_raw)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    args = (label,) if prior_dist is None else (label, prior_dist)
    return apply(_label_smooth_raw, args, {"epsilon": float(epsilon)},
                 name="label_smooth")


def _npair_loss_raw(a, p, y, l2_reg=0.002):
    sim = a @ p.T
    same = (y[:, None] == y[None, :]).to(a.dtype)
    same = same / torch.sum(same, dim=1, keepdim=True)
    ce = torch.mean(-torch.sum(same * torch.log_softmax(sim, dim=1), dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(a), 1))
                    + torch.mean(torch.sum(torch.square(p), 1))) * 0.25
    return ce + reg


register_op("npair_loss", _npair_loss_raw)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return apply(_npair_loss_raw, (anchor, positive, labels),
                 {"l2_reg": float(l2_reg)}, name="npair_loss")


def _diag_embed_raw(a):
    return torch.diag_embed(a)


register_op("diag_embed", _diag_embed_raw)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply(_diag_embed_raw, (x,), name="diag_embed")


def _sequence_mask_raw(lengths, maxlen=1, out_dtype="int64"):
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(convert_dtype(out_dtype))


register_op("sequence_mask", _sequence_mask_raw)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    ml = int(maxlen) if maxlen is not None else int(as_array(lengths).max())
    return apply(_sequence_mask_raw, (lengths,),
                 {"maxlen": ml, "out_dtype": str(dtype)},
                 differentiable=False, name="sequence_mask")


def _pairwise_distance_raw(x_, y_, p=2.0, keepdim=False):
    return torch.linalg.vector_norm(x_ - y_, ord=p, dim=-1, keepdim=keepdim)


register_op("pairwise_distance", _pairwise_distance_raw)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """ref nn/functional/distance.py: the p-norm of (x - y) over the last
    axis; `epsilon` is kept for the signature (the reference uses it
    only in the gradient's denominator)."""
    return apply(_pairwise_distance_raw, (x, y),
                 {"p": float(p), "keepdim": bool(keepdim)},
                 name="pairwise_distance")


def _ctc_loss_raw(lp, lab, in_len, lab_len, blank=0, reduction="mean",
                  norm_by_times=False):
    """The CTC forward (alpha) recursion in log space, in f32, one step a
    time step; finished samples (t >= input_length) are frozen.
    Gradients by autograd through the recursion."""
    T, B, _ = lp.shape
    lmax = lab.shape[1]
    S = 2 * lmax + 1
    dev = lp.device
    logp = torch.log_softmax(lp.float(), dim=-1)
    neg_inf = -1e30
    lab_len = lab_len.long()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab.long()
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    fill = torch.full((B, 2), neg_inf, device=dev)

    def emit(t):
        return torch.gather(logp[t], 1, ext)

    e0 = emit(0)
    cols = [e0[:, :1]]
    if S > 1:       # lmax 0 (all-blank targets) has only position 0
        cols.append(torch.where(lab_len[:, None] > 0, e0[:, 1:2], neg_inf))
        cols.append(fill[:, :1].expand(B, S - 2))
    alpha = torch.cat(cols, dim=1)
    for t in range(1, T):
        if S > 1:
            prev1 = torch.cat([fill[:, :1], alpha[:, :-1]], dim=1)
            prev2 = torch.cat([fill, alpha[:, :max(S - 2, 0)]], dim=1)[:, :S]
            prev2 = torch.where(can_skip, prev2, neg_inf)
            merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        else:
            merged = alpha
        alpha = torch.where((t < in_len)[:, None], merged + emit(t), alpha)
    s_last = 2 * lab_len                      # the last blank
    a_last = torch.gather(alpha, 1, s_last[:, None])[:, 0]
    s_lab = torch.clamp_min(s_last - 1, 0)
    a_lab = torch.where(lab_len > 0,
                        torch.gather(alpha, 1, s_lab[:, None])[:, 0],
                        neg_inf)
    nll = -torch.logaddexp(a_last, a_lab)
    if norm_by_times:
        nll = nll / torch.clamp_min(in_len.float(), 1.0)
    if reduction == "mean":
        # paddle's mean: each sample's loss over its label length first
        return torch.mean(nll / torch.clamp_min(lab_len.float(), 1.0))
    if reduction == "sum":
        return torch.sum(nll)
    return nll


register_op("ctc_loss", _ctc_loss_raw)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss (ref operators/warpctc_op.cc): log_probs [T, B, C] raw
    logits (log_softmax applied inside), labels [B, Lmax] padded,
    input_lengths and label_lengths [B]."""
    return apply(_ctc_loss_raw,
                 (log_probs, labels, input_lengths, label_lengths),
                 {"blank": int(blank), "reduction": str(reduction),
                  "norm_by_times": bool(norm_by_times)}, name="ctc_loss")


def _gather_tree_raw(ids_, par_):
    T, B, K = ids_.shape
    beams = torch.arange(K, device=ids_.device).expand(B, K)
    outs = [None] * T
    for t in reversed(range(T)):
        outs[t] = torch.take_along_dim(ids_[t], beams, dim=-1)
        beams = torch.take_along_dim(par_[t].long(), beams, dim=-1)
    return torch.stack(outs)


register_op("gather_tree", _gather_tree_raw)


def gather_tree(ids, parents):
    """Full beam-search sequences from per-step ids and parent beams
    (ref operators/gather_tree_op.cc; both [T, B, K]), walking the
    parent chain back from the last step."""
    return apply(_gather_tree_raw, (ids, parents), differentiable=False,
                 name="gather_tree")


# --------------------------------------------------------------- the rest
# (1d/3d pools, 1d/3d transposed convs, log_sigmoid/thresholded_relu,
# hsigmoid_loss, in-place variants)

def _log_sigmoid_raw(a):
    return TF.logsigmoid(a)


def _thresholded_relu_raw(a, threshold=1.0):
    return torch.where(a > threshold, a, torch.zeros_like(a))


register_op("log_sigmoid", _log_sigmoid_raw)
register_op("thresholded_relu", _thresholded_relu_raw)


def log_sigmoid(x, name=None):
    return apply(_log_sigmoid_raw, (x,), name="log_sigmoid")


def thresholded_relu(x, threshold=1.0, name=None):
    return apply(_thresholded_relu_raw, (x,),
                 {"threshold": float(threshold)}, name="thresholded_relu")


def _inplace(x, out):
    x._data = out._data
    return x


def relu_(x, name=None):
    return _inplace(x, relu(x))


def elu_(x, alpha=1.0, name=None):
    return _inplace(x, elu(x, alpha=alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _inplace(x, softmax(x, axis=axis, dtype=dtype))


register_op("max_pool3d", functools.partial(_poolnd_raw, n=3, average=False))
register_op("avg_pool3d", functools.partial(_poolnd_raw, n=3, average=True))


def _reject_pool_extras(data_format, canonical):
    if data_format not in (None, canonical):
        raise NotImplementedError(
            f"pooling: only {canonical} layout supported, got {data_format}")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    _reject_pool_extras(data_format, "NCDHW")
    return _pool(x, kernel_size, stride, padding, "NCHW", "max_pool3d",
                 ceil_mode=ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, divisor_override=None,
               data_format="NCDHW", name=None):
    _reject_pool_extras(data_format, "NCDHW")
    if divisor_override is not None:
        raise NotImplementedError("avg_pool3d: divisor_override unsupported")
    return _pool(x, kernel_size, stride, padding, "NCHW", "avg_pool3d",
                 ceil_mode=ceil_mode, count_include_pad=count_include_pad,
                 average=True)


_TORCH_ADAPTIVE = {(1, True): TF.adaptive_avg_pool1d,
                   (1, False): TF.adaptive_max_pool1d,
                   (3, True): TF.adaptive_avg_pool3d,
                   (3, False): TF.adaptive_max_pool3d}


def _adaptive_poolnd_raw(a, output_size=1, n=2, average=True):
    """Adaptive pool over the last n axes (torch's bins, those of the 2-d
    form)."""
    lead = a.shape[:a.dim() - n]
    x = a.reshape((-1,) + tuple(a.shape[a.dim() - n:]))[:, None]
    out = _TORCH_ADAPTIVE[(n, average)](x, _norm_tuple(output_size, n))
    return out.reshape(tuple(lead) + tuple(out.shape[2:]))


register_op("adaptive_avg_pool1d",
            functools.partial(_adaptive_poolnd_raw, n=1, average=True))
register_op("adaptive_max_pool1d",
            functools.partial(_adaptive_poolnd_raw, n=1, average=False))
register_op("adaptive_avg_pool3d",
            functools.partial(_adaptive_poolnd_raw, n=3, average=True))
register_op("adaptive_max_pool3d",
            functools.partial(_adaptive_poolnd_raw, n=3, average=False))


def _adaptive_pool_fn(opname):
    def fn(x, output_size, name=None, return_mask=False,
           data_format=None):
        if data_format not in (None, "NCL", "NCHW", "NCDHW"):
            raise NotImplementedError(
                f"{opname}: only channels-first layouts supported, "
                f"got {data_format}")
        return apply(OP_REGISTRY[opname], (x,),
                     {"output_size": _stride_attr(output_size)},
                     name=opname)
    fn.__name__ = opname
    return fn


adaptive_avg_pool1d = _adaptive_pool_fn("adaptive_avg_pool1d")
adaptive_max_pool1d = _adaptive_pool_fn("adaptive_max_pool1d")
adaptive_avg_pool3d = _adaptive_pool_fn("adaptive_avg_pool3d")
adaptive_max_pool3d = _adaptive_pool_fn("adaptive_max_pool3d")


register_op("conv1d_transpose",
            functools.partial(_convnd_transpose_raw, n=1))
register_op("conv3d_transpose",
            functools.partial(_convnd_transpose_raw, n=3))


def _conv_t(name, layout, x, weight, bias, stride, padding, output_padding,
            dilation, groups, data_format):
    if data_format != layout:
        raise NotImplementedError(
            f"{name}: only {layout} supported, got {data_format}")
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply(OP_REGISTRY[name], args,
                 {"stride": _stride_attr(stride), "padding": _pad_attr(padding),
                  "output_padding": _stride_attr(output_padding),
                  "dilation": _stride_attr(dilation), "groups": int(groups)},
                 name=name)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_t("conv1d_transpose", "NCL", x, weight, bias, stride,
                   padding, output_padding, dilation, groups, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_t("conv3d_transpose", "NCDHW", x, weight, bias, stride,
                   padding, output_padding, dilation, groups, data_format)


def bilinear(x1, x2, weight, bias=None, name=None):
    """ref nn/functional/common.py bilinear: out[b, o] = x1 W_o x2 + b."""
    from .layers_common import _bilinear_raw
    args = (x1, x2, weight) if bias is None else (x1, x2, weight, bias)
    return apply(_bilinear_raw, args, name="bilinear")


def _hsigmoid_loss_raw(x, lab, w, *maybe_b, num_classes=2):
    """Hierarchical sigmoid over the default complete binary tree (ref
    hierarchical_sigmoid_op.cc without custom paths): internal nodes
    1..C-1 heap-style, class c at leaf c + (C - 1), the loss the sum of
    the binary cross entropies along the root-to-leaf path, each path
    padded to ceil(log2(C)) steps of weight 0."""
    C = num_classes
    depth = max(int(np.ceil(np.log2(max(C, 2)))), 1)
    node = lab.reshape(-1).long() + (C - 1)        # accepts [N] or [N, 1]
    losses = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(depth):
        parent = torch.div(node - 1, 2, rounding_mode="floor")
        is_right = (node % 2 == 0) & (node > 0)
        row = torch.clamp(parent, 0, C - 2)
        z = torch.einsum("nd,nd->n", x, w[row])
        if maybe_b:
            z = z + maybe_b[0].reshape(-1)[row]
        bce = _logit_bce(z, is_right.float())
        losses = losses + torch.where(node > 0, bce, torch.zeros_like(bce))
        node = parent
    return losses[:, None]


register_op("hsigmoid_loss", _hsigmoid_loss_raw)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss: custom path tables not supported (default "
            "complete-binary-tree only)")
    args = (input, label, weight) if bias is None \
        else (input, label, weight, bias)
    return apply(_hsigmoid_loss_raw, args, {"num_classes": int(num_classes)},
                 name="hsigmoid_loss")


def _deform_conv2d_raw(x, offset, w, *rest, stride=1, padding=0, dilation=1,
                       has_mask=False, has_bias=False):
    """Deformable conv v1/v2 (ref operators/deformable_conv_op.h),
    deformable_groups = groups = 1. x [N, C, H, W]; offset [N, 2 kh kw,
    H', W'] as (dy, dx) pairs; w [Co, C, kh, kw]; an optional mask [N,
    kh kw, H', W'] (v2) and bias [Co]. Each kernel tap is sampled
    bilinearly at its offset position (four gathers), then one
    contraction with the weight."""
    mask = rest[0] if has_mask else None
    b = rest[-1] if has_bias else None
    n_, c, h, w_in = x.shape
    co, _, kh, kw = w.shape
    sh, sw = _norm_tuple(stride, 2)
    ph, pw = _norm_tuple(padding, 2)
    dh, dw = _norm_tuple(dilation, 2)
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w_in + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    dev = x.device
    oi = torch.arange(ho, device=dev)[:, None]
    oj = torch.arange(wo, device=dev)[None, :]
    ku, kv = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    base_y = (oi * sh - ph)[None] + (ku.reshape(-1) * dh)[:, None, None]
    base_x = (oj * sw - pw)[None] + (kv.reshape(-1) * dw)[:, None, None]
    off = offset.reshape(n_, K, 2, ho, wo)
    ys = base_y[None].to(off.dtype) + off[:, :, 0]        # [N, K, H', W']
    xs = base_x[None].to(off.dtype) + off[:, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    flat_x = x.reshape(n_, c, h * w_in)

    def gather(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w_in)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w_in - 1).long()
        idx = (yc * w_in + xc).reshape(n_, 1, -1).expand(n_, c, -1)
        got = torch.gather(flat_x, 2, idx).reshape(n_, c, K, ho, wo)
        return torch.where(inb[:, None], got, torch.zeros_like(got))

    sampled = ((1 - wy) * (1 - wx))[:, None] * gather(y0, x0) \
        + ((1 - wy) * wx)[:, None] * gather(y0, x0 + 1) \
        + (wy * (1 - wx))[:, None] * gather(y0 + 1, x0) \
        + (wy * wx)[:, None] * gather(y0 + 1, x0 + 1)     # [N,C,K,H',W']
    if mask is not None:
        sampled = sampled * mask[:, None]
    out = torch.einsum("nckij,ock->noij", sampled.float(),
                       w.reshape(co, c, K).float()).to(x.dtype)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    return out


register_op("deform_conv2d", _deform_conv2d_raw)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    if deformable_groups != 1 or groups != 1:
        raise NotImplementedError(
            "deform_conv2d: deformable_groups/groups > 1 unsupported")
    args = [x, offset, weight]
    if mask is not None:
        args.append(mask)
    if bias is not None:
        args.append(bias)
    return apply(_deform_conv2d_raw, tuple(args),
                 {"stride": _stride_attr(stride), "padding": _pad_attr(padding),
                  "dilation": _stride_attr(dilation),
                  "has_mask": mask is not None, "has_bias": bias is not None},
                 name="deform_conv2d")
