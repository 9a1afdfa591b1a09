"""Activation layers (the port of `paddle_tpu/nn/activation.py`; ref
python/paddle/nn/layer/activation.py)."""
from . import functional as F
from . import initializer as I
from .layer import Layer


def _simple(fname, cls_name):
    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return getattr(F, fname)(x)

    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
Silu = _simple("silu", "Silu")
Swish = _simple("swish", "Swish")
Mish = _simple("mish", "Mish")
Hardswish = _simple("hardswish", "Hardswish")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
Softsign = _simple("softsign", "Softsign")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)
