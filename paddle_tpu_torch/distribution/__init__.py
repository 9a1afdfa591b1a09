"""paddle_tpu_torch.distribution — probability distributions (the port of
`paddle_tpu/distribution/__init__.py`; ref
python/paddle/fluid/layers/distributions.py:30,115,260,425,531 —
Distribution/Uniform/Normal/Categorical/MultivariateNormalDiag, and the
paddle 2.x paddle.distribution namespace).

Sampling draws from the framework generator of the parameters' device
(`framework.state.rng_generator`, which `paddle.seed` seeds) instead of a
JAX key, so one seed gives one sequence of samples per device, and a
captured CUDA graph that registers the generator draws afresh on every
replay. Densities, entropies and KL divergences are the JAX package's
closed forms in torch ops.
"""
import math

import torch

from ..framework import state
from ..framework.tensor import Tensor, to_torch


def _arr(x, dtype=None):
    if isinstance(x, Tensor):
        a = x._data
    elif isinstance(x, (int, float, list, tuple)):
        a = to_torch(x, dtype or "float32")
    else:
        a = to_torch(x)
    if dtype is not None and a.dtype != dtype:
        a = a.to(dtype)
    return a


def _shape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


class Distribution:
    """ref distributions.py:30."""

    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return Tensor._wrap(torch.exp(self.log_prob(value)._data))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (ref distributions.py:115)."""

    def __init__(self, low, high, name=None):
        self.low = _arr(low)
        self.high = _arr(high)

    def sample(self, shape=()):
        shape = tuple(shape) + _shape(self.low, self.high)
        u = torch.rand(shape, dtype=self.low.dtype, device=self.low.device,
                       generator=state.rng_generator(self.low.device))
        return Tensor._wrap(self.low + u * (self.high - self.low))

    def log_prob(self, value):
        v = _arr(value)
        inside = torch.logical_and(v >= self.low, v < self.high)
        lp = torch.where(inside, -torch.log(self.high - self.low),
                         -math.inf)
        return Tensor._wrap(lp)

    def entropy(self):
        return Tensor._wrap(torch.log(self.high - self.low))


class Normal(Distribution):
    """N(loc, scale^2) (ref distributions.py:260)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale)

    def sample(self, shape=()):
        shape = tuple(shape) + _shape(self.loc, self.scale)
        z = torch.randn(shape, dtype=self.loc.dtype, device=self.loc.device,
                        generator=state.rng_generator(self.loc.device))
        return Tensor._wrap(self.loc + z * self.scale)

    def log_prob(self, value):
        v = _arr(value)
        var = self.scale * self.scale
        lp = (-((v - self.loc) ** 2) / (2 * var)
              - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))
        return Tensor._wrap(lp)

    def entropy(self):
        return Tensor._wrap(0.5 + 0.5 * math.log(2 * math.pi)
                            + torch.log(self.scale)
                            + torch.zeros_like(self.loc))

    def kl_divergence(self, other):
        """KL(self || other), other Normal (ref distributions.py
        kl_divergence)."""
        var_a = self.scale ** 2
        var_b = other.scale ** 2
        kl = (torch.log(other.scale / self.scale)
              + (var_a + (self.loc - other.loc) ** 2) / (2 * var_b) - 0.5)
        return Tensor._wrap(kl)


def _take_last(p, v):
    """p[..., v] along the last axis (p 1-D: p[v])."""
    if p.ndim == 1:
        return p[v]
    return torch.gather(p, -1, v[..., None]).squeeze(-1)


class Categorical(Distribution):
    """Categorical over the last axis of `logits` (ref
    distributions.py:425). `sample` takes the Gumbel-max of the logits."""

    def __init__(self, logits, name=None):
        self.logits = _arr(logits)
        self._log_p = torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape=()):
        lg = self.logits
        u = torch.rand(tuple(shape) + tuple(lg.shape), dtype=lg.dtype,
                       device=lg.device,
                       generator=state.rng_generator(lg.device))
        tiny = torch.finfo(lg.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return Tensor._wrap(torch.argmax(lg + gumbel, dim=-1)
                            .to(torch.int32))

    def log_prob(self, value):
        return Tensor._wrap(_take_last(self._log_p, _arr(value).long()))

    def probs(self, value=None):
        p = torch.exp(self._log_p)
        if value is None:
            return Tensor._wrap(p)
        return Tensor._wrap(_take_last(p, _arr(value).long()))

    def entropy(self):
        p = torch.exp(self._log_p)
        return Tensor._wrap(-torch.sum(p * self._log_p, dim=-1))

    def kl_divergence(self, other):
        p = torch.exp(self._log_p)
        return Tensor._wrap(torch.sum(p * (self._log_p - other._log_p),
                                      dim=-1))


class MultivariateNormalDiag(Distribution):
    """Diagonal-covariance MVN (ref distributions.py:531)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _arr(loc)
        self.scale = _arr(scale)  # diagonal std

    @property
    def _dim(self):
        return self.loc.shape[-1]

    def sample(self, shape=()):
        z = torch.randn(tuple(shape) + tuple(self.loc.shape),
                        dtype=self.loc.dtype, device=self.loc.device,
                        generator=state.rng_generator(self.loc.device))
        return Tensor._wrap(self.loc + z * self.scale)

    def log_prob(self, value):
        v = _arr(value)
        lp = (-0.5 * torch.sum(((v - self.loc) / self.scale) ** 2, dim=-1)
              - torch.sum(torch.log(self.scale), dim=-1)
              - 0.5 * self._dim * math.log(2 * math.pi))
        return Tensor._wrap(lp)

    def entropy(self):
        return Tensor._wrap(0.5 * self._dim * (1 + math.log(2 * math.pi))
                            + torch.sum(torch.log(self.scale), dim=-1))

    def kl_divergence(self, other):
        var_a = self.scale ** 2
        var_b = other.scale ** 2
        kl = 0.5 * torch.sum(
            var_a / var_b + ((self.loc - other.loc) ** 2) / var_b
            - 1.0 + torch.log(var_b) - torch.log(var_a), dim=-1)
        return Tensor._wrap(kl)


def kl_divergence(p, q):
    """paddle.distribution.kl_divergence dispatch."""
    return p.kl_divergence(q)
