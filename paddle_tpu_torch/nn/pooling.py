"""Pooling layers (the port of `paddle_tpu/nn/pooling.py`; ref
python/paddle/nn/layer/pooling.py)."""
from . import functional as F
from .layer import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.ceil_mode, self.data_format = ceil_mode, data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 count_include_pad=True, divisor_override=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.ceil_mode, self.count_include_pad = ceil_mode, count_include_pad
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            count_include_pad=self.count_include_pad,
                            data_format=self.data_format)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        size = self.output_size if isinstance(self.output_size, int) \
            else self.output_size[0]
        return F.adaptive_avg_pool2d(x.unsqueeze(-1), (size, 1)).squeeze(-1)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 count_include_pad=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            count_include_pad=self.count_include_pad)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)
