"""Tensor creation ops (the port of `paddle_tpu/ops/creation.py`; ref
python/paddle/tensor/creation.py + random.py API surface).

Tensors are created on the current place (`framework.state`); the
`*_like` ops on their input's device. Random ops draw from the framework
generator's explicit `torch.Generator` on that device (`paddle.seed`
replays them); their draws are not the JAX package's.
"""
import numpy as np
import torch

from ..framework import state
from ..framework.dtype import convert_dtype
from ..framework import tensor as _tensor
from ..framework.tensor import Tensor, to_torch, unwrap
from .dispatch import apply, register_op


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    if d is None:
        d = default or state.get_default_dtype()
    return d


def _dev():
    return state.current_device()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    return _tensor.to_tensor(data, dtype=dtype, place=place,
                             stop_gradient=stop_gradient)


def zeros(shape, dtype=None, name=None):
    return Tensor._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                    device=_dev()))


def ones(shape, dtype=None, name=None):
    return Tensor._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                   device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor._wrap(torch.full(_shape(shape), fill_value,
                                   dtype=_dt(dtype), device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.zeros_like(x._data, dtype=convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return Tensor._wrap(torch.ones_like(x._data, dtype=convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return Tensor._wrap(torch.full_like(x._data, fill_value,
                                        dtype=convert_dtype(dtype)))


empty_like = zeros_like


def arange(start=0, end=None, step=1, dtype=None, name=None):
    def _v(x):
        return x.item() if isinstance(x, Tensor) else x
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    ints = all(isinstance(v, (int, np.integer)) for v in (start, end, step))
    d = convert_dtype(dtype) or (torch.int32 if ints
                                 else state.get_default_dtype())
    return Tensor._wrap(torch.arange(start, end, step, dtype=d,
                                     device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor._wrap(torch.linspace(start, stop, int(num),
                                       dtype=_dt(dtype), device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor._wrap(torch.logspace(start, stop, int(num), base=base,
                                       dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = num_rows if num_columns is None else num_columns
    return Tensor._wrap(torch.eye(num_rows, m, dtype=_dt(dtype),
                                  device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    a = to_torch(x)
    out = torch.diag(a, offset)
    if padding_value != 0 and a.dim() == 1:
        mask = torch.ones(a.shape[0], dtype=torch.bool,
                          device=a.device).diag(offset)
        out = torch.where(mask, out, torch.full((), padding_value,
                                                dtype=out.dtype,
                                                device=a.device))
    return Tensor._wrap(out)


def diagflat(x, offset=0, name=None):
    return Tensor._wrap(torch.diagflat(to_torch(x), offset))


def _tril_raw(a, diagonal=0):
    return torch.tril(a, diagonal)


def _triu_raw(a, diagonal=0):
    return torch.triu(a, diagonal)


register_op("tril", _tril_raw)
register_op("triu", _triu_raw)


def tril(x, diagonal=0, name=None):
    return apply(_tril_raw, (x,), {"diagonal": int(diagonal)}, name="tril")


def triu(x, diagonal=0, name=None):
    return apply(_triu_raw, (x,), {"diagonal": int(diagonal)}, name="triu")


def _meshgrid_raw(*arrays):
    return tuple(torch.meshgrid(*arrays, indexing="ij"))


register_op("meshgrid", _meshgrid_raw)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply(_meshgrid_raw, args, name="meshgrid"))


def _assign_raw(v):
    return v + 0


register_op("assign", _assign_raw)


def assign(x, output=None):
    if output is not None:
        output.set_value(x)
        return output
    if isinstance(x, Tensor):
        return apply(_assign_raw, (x,), name="assign")
    return Tensor(x)


def clone(x, name=None):
    return assign(x)


# ----------------------------------------------------------------- random ops

def _gen(device=None):
    return state.rng_generator(device or _dev())


def rand(shape, dtype=None, name=None):
    dev = _dev()
    return Tensor._wrap(torch.rand(_shape(shape), generator=_gen(dev),
                                   dtype=_dt(dtype), device=dev))


def randn(shape, dtype=None, name=None):
    dev = _dev()
    return Tensor._wrap(torch.randn(_shape(shape), generator=_gen(dev),
                                    dtype=_dt(dtype), device=dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = unwrap(mean)
        s = unwrap(std)
        dev = (m if isinstance(m, torch.Tensor) else s).device
        shp = torch.broadcast_shapes(getattr(m, "shape", ()),
                                     getattr(s, "shape", ()))
        z = torch.randn(shp, generator=_gen(dev), device=dev)
        return Tensor._wrap(z * s + m)
    dev = _dev()
    z = torch.randn(_shape(shape), generator=_gen(dev), device=dev)
    return Tensor._wrap(z * std + mean)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _dev()
    gen = _gen(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return Tensor._wrap(out.uniform_(min, max, generator=gen))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return Tensor._wrap(torch.randint(low, high, _shape(shape),
                                      generator=_gen(dev),
                                      dtype=convert_dtype(dtype or "int64"),
                                      device=dev))


def randperm(n, dtype=None, name=None):
    dev = _dev()
    p = torch.randperm(int(n), generator=_gen(dev), device=dev)
    return Tensor._wrap(p.to(convert_dtype(dtype or "int64")))


def bernoulli(x, name=None):
    a = to_torch(x)
    return Tensor._wrap(torch.bernoulli(a, generator=_gen(a.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Draws category indices by the weights in `x` ([C] or [B, C]).
    `replacement=False` draws without replacement (Paddle's meaning; the
    JAX package always draws with replacement)."""
    a = to_torch(x)
    out = torch.multinomial(a.float(), int(num_samples),
                            replacement=bool(replacement),
                            generator=_gen(a.device))
    return Tensor._wrap(out.to(torch.int32))


def shuffle(x, name=None):
    a = to_torch(x)
    perm = torch.randperm(a.shape[0], generator=_gen(a.device),
                          device=a.device)
    return Tensor._wrap(a[perm])
