"""Common layers: Linear, Embedding, Dropout, Flatten, padding, upsampling
(the port of `paddle_tpu/nn/layers_common.py`; ref
python/paddle/nn/layer/common.py)."""
import torch

from ..ops.dispatch import apply, register_op
from . import functional as F
from . import initializer as I
from .layer import Layer


def _bilinear_raw(a, b, w, *maybe_bias):
    out = torch.einsum("bi,oij,bj->bo", a, w, b)
    return out + maybe_bias[0] if maybe_bias else out


register_op("bilinear", _bilinear_raw)


class Linear(Layer):
    """weight [in_features, out_features], the reference's layout (torch's
    is [out, in])."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A table [num_embeddings, embedding_dim], N(0, 1) by default; the
    row of `padding_idx` (negative counts from the end) starts at 0 and
    reads as 0."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._data[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ..ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _PadNd(Layer):
    _layout = "NCHW"

    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format or self._layout

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    _layout = "NCL"


class Pad2D(_PadNd):
    _layout = "NCHW"


class Pad3D(_PadNd):
    _layout = "NCDHW"


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             align_mode=self.align_mode,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size=size, scale_factor=scale_factor,
                         mode="bilinear", align_corners=True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size=size, scale_factor=scale_factor, mode="nearest",
                         data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        args = (x1, x2, self.weight) if self.bias is None else \
            (x1, x2, self.weight, self.bias)
        return apply(_bilinear_raw, args, name="bilinear")


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, p=self.p, epsilon=self.epsilon,
                                   keepdim=self.keepdim)


class Unfold(Layer):
    """im2col as a layer."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, strides=self.strides,
                        paddings=self.paddings, dilations=self.dilations)
