"""Conv layers (the port of `paddle_tpu/nn/conv.py`; ref
python/paddle/nn/layer/conv.py). Weights are [out_c, in_c / groups, *k],
[in_c, out_c / groups, *k] for the transposed ones, Kaiming-uniform over
the fan-in by default."""
import numpy as np

from . import functional as F
from . import initializer as I
from .layer import Layer


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, ndim,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * ndim
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            w_shape = [in_channels, out_channels // groups, *kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *kernel_size]
        fan_in = (in_channels // groups) * int(np.prod(kernel_size))
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={self._stride}"
                + (f", padding={self._padding}" if self._padding else ""))


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups,
            output_size=output_size, data_format=self._data_format)


def _first(v):
    return v if isinstance(v, int) else v[0]


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        out = F.conv2d_transpose(
            x.unsqueeze(-1), self.weight.unsqueeze(-1), self.bias,
            stride=(_first(self._stride), 1),
            padding=(_first(self._padding), 0),
            output_padding=(self._output_padding, 0),
            dilation=(_first(self._dilation), 1), groups=self._groups)
        return out.squeeze(-1)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, stride=self._stride,
            padding=self._padding, output_padding=self._output_padding,
            dilation=self._dilation, groups=self._groups)
