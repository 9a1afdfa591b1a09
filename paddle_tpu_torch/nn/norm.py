"""Norm layers (the port of `paddle_tpu/nn/norm.py`; ref
python/paddle/nn/layer/norm.py): BatchNorm1D/2D/3D, LayerNorm, GroupNorm,
InstanceNorm, LocalResponseNorm, SpectralNorm. SyncBatchNorm is
BatchNorm on one card (the cross-card reduction comes with ROADMAP Queue
1 item 5)."""
import numbers

import numpy as np
import torch

from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..ops.dispatch import apply
from . import functional as F
from . import initializer as I
from .layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        dev = state.current_device()
        self.register_buffer("_mean", Tensor._wrap(
            torch.zeros(num_features, device=dev)))
        self.register_buffer("_variance", Tensor._wrap(
            torch.ones(num_features, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, weight=self.weight, bias=self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (ref fluid/dygraph/nn.py BatchNorm): the 2.0
    BatchNorm with an `act`."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, use_global_stats=False,
                 trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN; on one card the batch statistics are the global
    ones."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon, data_format=layer._data_format)
            if layer.weight is not None:
                new.weight.set_value(layer.weight)
            if layer.bias is not None:
                new.bias.set_value(layer.bias)
            new.set_state_dict({"_mean": layer._mean,
                                "_variance": layer._variance})
            return new
        for name, sub in list(layer._sub_layers.items()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Number):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, weight=self.weight,
                            bias=self.bias, epsilon=self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, epsilon=self._epsilon,
                            weight=self.weight, bias=self.bias)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


def _power_iteration(wm, u, v, iters, eps):
    for _ in range(iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u, v


def _matricize(w, dim):
    return torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)


class SpectralNorm(Layer):
    """weight / sigma, sigma from `power_iters` steps of the power
    iteration on the weight matricized along `dim`. Every call advances
    the persisted u and v (ref spectral_norm_op), so sigma converges
    across steps; the gradient flows through the iteration that starts
    from them."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], default_initializer=I.Normal(0, 1))
        self.weight_v = self.create_parameter(
            [w], default_initializer=I.Normal(0, 1))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._eps
        warr = unwrap(weight)
        with torch.no_grad():
            u, v = _power_iteration(_matricize(warr.detach(), dim),
                                    self.weight_u._data, self.weight_v._data,
                                    iters, eps)
            self.weight_u._data.copy_(u)
            self.weight_v._data.copy_(v)
        u0, v0 = u.clone(), v.clone()

        def f(w):
            wm = _matricize(w, dim)
            u, v = _power_iteration(wm, u0, v0, iters, eps)
            return w / (u @ wm @ v)
        return apply(f, (weight,), name="spectral_norm")
