"""Weight initializers (the port of `paddle_tpu/nn/initializer.py`; ref
python/paddle/fluid/initializer.py: Constant, Uniform, Normal,
TruncatedNormal, Xavier, MSRA/Kaiming, Bilinear, Assign).

Each initializer is a callable (shape, dtype) -> torch tensor on the
current place (`framework.state.current_device()`, the card unless
`set_device("cpu")` was called), drawing from the framework generator
(`framework.state.default_generator()`), so `paddle.seed` replays it.
Random draws are made in f32 and cast to the requested dtype. The JAX
package draws from JAX keys, so the port's random values are not the
JAX package's: their distributions are (fans, gains, bounds and
moments), and the deterministic initializers agree exactly.
"""
import math

import numpy as np
import torch

from ..framework import state
from ..framework.dtype import convert_dtype


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *spatial] (NCHW weights)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Subclasses implement `_generate(shape, dtype, device)`; `__call__`
    places the result on the current place in `dtype`."""

    def __call__(self, shape, dtype="float32"):
        dev = state.current_device()
        return self._generate(tuple(int(s) for s in shape),
                              convert_dtype(dtype) or torch.float32, dev)

    def _generate(self, shape, dtype, device):
        raise NotImplementedError


def _gen(device):
    return state.rng_generator(device)


def _uniform(shape, low, high, dtype, device):
    u = torch.rand(shape, generator=_gen(device), device=device)
    return (u * (high - low) + low).to(dtype)


def _normal(shape, dtype, device):
    return torch.randn(shape, generator=_gen(device), device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device):
        return _uniform(shape, self.low, self.high, dtype, device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device):
        return (_normal(shape, dtype, device) * self.std
                + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """The standard normal truncated to [-2, 2], scaled and shifted (by
    the inverse CDF of a uniform draw over the window)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device):
        lo, hi = (0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (-2, 2))
        u = torch.rand(shape, generator=_gen(device), device=device,
                       dtype=torch.float64) * (hi - lo) + lo
        z = (torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp_(-2.0, 2.0)
        return (z * self.std + self.mean).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (_normal(shape, dtype, device) * std).to(dtype)


class KaimingUniform(Initializer):
    """limit sqrt(6 / fan_in), whatever the nonlinearity (the JAX
    package's rule)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in

    def _generate(self, shape, dtype, device):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = math.sqrt(6.0 / fi)
        return _uniform(shape, -limit, limit, dtype, device)


class KaimingNormal(Initializer):
    """std sqrt(2 / fan_in), whatever the nonlinearity (the JAX
    package's rule)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in = fan_in

    def _generate(self, shape, dtype, device):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = math.sqrt(2.0 / fi)
        return (_normal(shape, dtype, device) * std).to(dtype)


MSRAInitializer = KaimingNormal


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _generate(self, shape, dtype, device):
        v = self.value
        if hasattr(v, "_data"):
            v = v._data
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=dtype).reshape(
                shape).clone()
        return torch.as_tensor(np.asarray(v)).to(
            device=device, dtype=dtype).reshape(shape)


class Orthogonal(Initializer):
    """jax.nn.initializers.orthogonal: the Q of a normal matrix's QR,
    its columns' signs set by R's diagonal, over the last axis."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, dtype, device):
        if len(shape) < 2:
            raise ValueError("orthogonal initializer requires at least a "
                             "2D shape")
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        q, r = torch.linalg.qr(_normal(mshape, dtype, device))
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, shape, dtype, device):
        out = np.zeros(shape, dtype=np.float32)
        centers = [s // 2 for s in shape[2:]]
        for i in range(min(shape[0], shape[1])):
            out[(i, i) + tuple(centers)] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


# reference-compat aliases (fluid.initializer names)
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierNormal
NumpyArrayInitializer = Assign


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 0.75}
    return gains[nonlinearity]


class Bilinear(Initializer):
    """Transposed-conv upsampling kernels: every channel pair of the 4-D
    weight gets the separable bilinear interpolation filter."""

    def _generate(self, shape, dtype, device):
        if len(shape) != 4:
            raise ValueError("Bilinear expects a 4-D conv weight shape")
        kh, kw = shape[2], shape[3]

        def filt(k):
            f = (k + 1) // 2
            center = f - 1 if k % 2 == 1 else f - 0.5
            return 1 - np.abs(np.arange(k) - center) / f

        w = np.broadcast_to(np.outer(filt(kh), filt(kw)), shape)
        return torch.from_numpy(np.ascontiguousarray(w)).to(device=device,
                                                            dtype=dtype)
