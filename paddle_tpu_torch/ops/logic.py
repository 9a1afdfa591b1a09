"""Comparison / logical ops (the port of `paddle_tpu/ops/logic.py`; ref
operators/controlflow/compare_op.cc, logical_op.cc;
python/paddle/tensor/logic.py surface). All non-differentiable."""
import torch

from ..framework.tensor import Tensor
from .dispatch import apply, as_array, axis_arg, register_op
from .dispatch import axis_attr as _axis_attr
from .math import _common_type, _dims, _pair


def _cmp(fn, name):
    register_op(name, fn)

    def op(x, y, name=None, _opname=name):
        return apply(fn, (x, y), differentiable=False, name=_opname)
    op.__name__ = name
    op.raw = fn
    return op


def _equal_raw(a, b):
    return a == b


def _not_equal_raw(a, b):
    return a != b


def _greater_than_raw(a, b):
    return a > b


def _greater_equal_raw(a, b):
    return a >= b


def _less_than_raw(a, b):
    return a < b


def _less_equal_raw(a, b):
    return a <= b


equal = _cmp(_equal_raw, "equal")
not_equal = _cmp(_not_equal_raw, "not_equal")
greater_than = _cmp(_greater_than_raw, "greater_than")
greater_equal = _cmp(_greater_equal_raw, "greater_equal")
less_than = _cmp(_less_than_raw, "less_than")
less_equal = _cmp(_less_equal_raw, "less_equal")

logical_and = _cmp(_pair(torch.logical_and), "logical_and")
logical_or = _cmp(_pair(torch.logical_or), "logical_or")
logical_xor = _cmp(_pair(torch.logical_xor), "logical_xor")
bitwise_and = _cmp(_pair(torch.bitwise_and), "bitwise_and")
bitwise_or = _cmp(_pair(torch.bitwise_or), "bitwise_or")
bitwise_xor = _cmp(_pair(torch.bitwise_xor), "bitwise_xor")

register_op("logical_not", torch.logical_not)
register_op("bitwise_not", torch.bitwise_not)


def logical_not(x, name=None):
    return apply(torch.logical_not, (x,), differentiable=False,
                 name="logical_not")


def bitwise_not(x, name=None):
    return apply(torch.bitwise_not, (x,), differentiable=False,
                 name="bitwise_not")


def _all_raw(a, axis=None, keepdim=False):
    dims = _dims(axis_arg(axis), a.dim())
    if not dims:
        return a.bool().clone()
    return torch.all(a.bool(), dim=dims, keepdim=keepdim)


def _any_raw(a, axis=None, keepdim=False):
    dims = _dims(axis_arg(axis), a.dim())
    if not dims:
        return a.bool().clone()
    return torch.any(a.bool(), dim=dims, keepdim=keepdim)


register_op("all", _all_raw)
register_op("any", _any_raw)


def all(x, axis=None, keepdim=False, name=None):
    return apply(_all_raw, (x,),
                 {"axis": _axis_attr(axis), "keepdim": bool(keepdim)},
                 differentiable=False, name="all")


def any(x, axis=None, keepdim=False, name=None):
    return apply(_any_raw, (x,),
                 {"axis": _axis_attr(axis), "keepdim": bool(keepdim)},
                 differentiable=False, name="any")


def _isclose_raw(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _common_type(a, b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _allclose_raw(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose_raw(a, b, rtol, atol, equal_nan).all()


def _equal_all_raw(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return (a == b).all()


register_op("isclose", _isclose_raw)
register_op("allclose", _allclose_raw)
register_op("equal_all", _equal_all_raw)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_isclose_raw, (x, y),
                 {"rtol": float(rtol), "atol": float(atol),
                  "equal_nan": bool(equal_nan)},
                 differentiable=False, name="isclose")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_allclose_raw, (x, y),
                 {"rtol": float(rtol), "atol": float(atol),
                  "equal_nan": bool(equal_nan)},
                 differentiable=False, name="allclose")


def equal_all(x, y, name=None):
    return apply(_equal_all_raw, (x, y), differentiable=False,
                 name="equal_all")


def is_empty(x, name=None):
    a = as_array(x)
    return Tensor._wrap(torch.full((), a.numel() == 0, dtype=torch.bool,
                                   device=a.device))


def is_tensor(x):
    return isinstance(x, Tensor)

