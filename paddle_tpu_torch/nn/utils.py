"""paddle.nn.utils (the port of `paddle_tpu/nn/utils.py`; ref
python/paddle/nn/utils/weight_norm_hook.py, spectral_norm_hook.py,
transform_parameters.py): reparametrization hooks and the
parameter/vector converters."""
import numpy as np
import torch

from ..framework.tensor import Parameter, Tensor, to_torch
from ..ops.dispatch import apply


def _norm_except(v, dim):
    """||v|| over every axis except `dim` (None: the whole tensor),
    shaped to broadcast against v."""
    if dim is None:
        return torch.sqrt(torch.sum(v * v))
    dim = dim % v.dim()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparametrize layer.<name> as g * v / ||v|| (ref
    weight_norm_hook): the parameter is replaced by `<name>_g` and
    `<name>_v`, and a forward-pre-hook composes the weight every call,
    so the optimizer trains g and v."""
    if getattr(layer, f"__wn_{name}", None):
        raise ValueError(f"weight_norm already applied to {name!r}")
    w = getattr(layer, name)
    warr = w._data.detach()
    g = Parameter(_norm_except(warr, dim), name=(w.name or name) + "_g")
    v = Parameter(warr.clone(), name=(w.name or name) + "_v")
    delattr(layer, name)
    setattr(layer, name + "_g", g)
    setattr(layer, name + "_v", v)

    def compose():
        def f(v_, g_):
            return v_ * (g_ / _norm_except(v_, dim))
        return apply(f, (getattr(layer, name + "_v"),
                         getattr(layer, name + "_g")), name="weight_norm")

    def pre_hook(lyr, inputs):
        setattr(lyr, name, compose())
        return inputs

    handle = layer.register_forward_pre_hook(pre_hook)
    object.__setattr__(layer, f"__wn_{name}", (handle, dim))
    setattr(layer, name, compose())             # usable before a forward
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into one parameter."""
    st = getattr(layer, f"__wn_{name}", None)
    if not st:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    handle, dim = st
    handle.remove()
    g = getattr(layer, name + "_g")
    v = getattr(layer, name + "_v")
    delattr(layer, name + "_g")
    delattr(layer, name + "_v")
    with torch.no_grad():
        composed = v._data * (g._data / _norm_except(v._data, dim))
    layer.__dict__.pop(name, None)   # the composed Tensor's attribute
    setattr(layer, name, Parameter(composed,
                                   name=v.name[:-2] if v.name else name))
    object.__setattr__(layer, f"__wn_{name}", None)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide layer.<name> by its spectral norm every forward (ref
    spectral_norm_hook; the power iteration's state is a SpectralNorm
    sublayer's, advanced every call)."""
    from .norm import SpectralNorm
    if getattr(layer, f"__sn_{name}", None):
        raise ValueError(f"spectral_norm already applied to {name!r}")
    w = getattr(layer, name)
    if dim is None:
        # Linear and the transposed convs matricize along dim 1 (their
        # output axis is the second)
        cls = type(layer).__name__
        dim = 1 if (("Linear" in cls or "Transpose" in cls)
                    and len(w.shape) > 1) else 0
    sn = SpectralNorm(tuple(w.shape), dim=dim,
                      power_iters=n_power_iterations, eps=eps)
    layer.add_sublayer(f"_spectral_norm_{name}", sn)
    orig = w

    def pre_hook(lyr, inputs):
        lyr.__dict__[name] = sn(orig)       # shadows the parameter
        return inputs

    handle = layer.register_forward_pre_hook(pre_hook)
    object.__setattr__(layer, f"__sn_{name}", (handle, dim))
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one new Tensor."""
    arrs = [p._data.detach().reshape(-1) for p in parameters]
    return Tensor._wrap(torch.cat(arrs) if arrs else torch.zeros(0))


def vector_to_parameters(vec, parameters):
    """Write a flat vector back into the parameters, in place."""
    data = vec._data if isinstance(vec, Tensor) else to_torch(vec)
    total = sum(int(np.prod(p.shape)) for p in parameters)
    if total != data.numel():
        raise ValueError(f"vector has {data.numel()} elements but "
                         f"parameters need {total}")
    off = 0
    for p in parameters:
        k = int(np.prod(p.shape))
        p.set_value(data[off:off + k].reshape(tuple(p.shape)))
        off += k
