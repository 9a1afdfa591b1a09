"""Math ops: elementwise, reductions, products, sort/search (the port of
`paddle_tpu/ops/math.py`; ref paddle/fluid/operators/elementwise/,
reduce_ops/, matmul_v2_op; python/paddle/tensor/math.py API surface).

Every op is a raw torch form behind the dispatcher (`ops/dispatch.py`).
Python scalars mix in as the JAX package's weakly typed scalars do: they
take the other operand's dtype within its kind.
"""
import builtins

import numpy as np
import torch

from ..framework.dtype import NARROW, convert_dtype, dtype_name
from ..framework.tensor import Tensor, to_torch
from .dispatch import apply, as_array, axis_arg, register_op
from .dispatch import axis_attr as _axis_attr


def _t(x, like):
    """A Python scalar as a 0-d tensor on `like`'s device (a torch op
    that takes no scalar); a 0-d tensor defers to a sized operand's dtype
    in torch's promotion, as a weak scalar does in the JAX package's."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, device=like.device)


def _pair(fn):
    def raw(a, b):
        if not isinstance(a, torch.Tensor):
            a = _t(a, b)
        elif not isinstance(b, torch.Tensor):
            b = _t(b, a)
        return fn(a, b)
    raw.__name__ = getattr(fn, "__name__", "binop")
    return raw


def _float(a):
    """Integer and bool inputs promoted to the default float, as jnp's
    transcendental functions promote them."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(torch.get_default_dtype())


def _binop(fn, name):
    register_op(name, fn)

    def op(x, y, name=None, _opname=name):
        return apply(fn, (x, y), name=_opname)
    op.__name__ = name
    op.raw = fn
    return op


add = _binop(lambda x, y: x + y, "add")
subtract = _binop(lambda x, y: x - y, "subtract")
multiply = _binop(lambda x, y: x * y, "multiply")
divide = _binop(lambda x, y: x / y, "divide")
floor_divide = _binop(_pair(torch.floor_divide), "floor_divide")
remainder = _binop(_pair(torch.remainder), "remainder")
mod = remainder
floor_mod = remainder
maximum = _binop(_pair(torch.maximum), "maximum")
minimum = _binop(_pair(torch.minimum), "minimum")
fmax = _binop(_pair(torch.fmax), "fmax")
fmin = _binop(_pair(torch.fmin), "fmin")
atan2 = _binop(_pair(lambda a, b: torch.atan2(_float(a), _float(b))),
               "atan2")
hypot = _binop(_pair(lambda a, b: torch.hypot(_float(a), _float(b))),
               "hypot")


def _pow_raw(a, b):
    return torch.pow(a, b)


register_op("pow", _pow_raw)


def pow(x, y, name=None):
    return apply(_pow_raw, (x, y), name="pow")


def _scale_raw(a, s, b, bias_after_scale=True):
    return a * s + b if bias_after_scale else (a + b) * s


register_op("scale", _scale_raw)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """x * scale + bias (or (x + bias) * scale), then the `nn.functional`
    activation named `act`, if any."""
    out = apply(_scale_raw, (x, scale, bias),
                {"bias_after_scale": bool(bias_after_scale)}, name="scale")
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def _unary(fn, name, promote=False):
    if promote:
        def raw(a):
            return fn(_float(a))
        raw.__name__ = name
    else:
        raw = fn
    register_op(name, raw)

    def op(x, name=None, _opname=name):
        return apply(raw, (x,), name=_opname)
    op.__name__ = name
    op.raw = raw
    return op


abs = _unary(torch.abs, "abs")
neg = _unary(torch.neg, "neg")
exp = _unary(torch.exp, "exp", True)
expm1 = _unary(torch.expm1, "expm1", True)
log = _unary(torch.log, "log", True)
log2 = _unary(torch.log2, "log2", True)
log10 = _unary(torch.log10, "log10", True)
log1p = _unary(torch.log1p, "log1p", True)
sqrt = _unary(torch.sqrt, "sqrt", True)
rsqrt = _unary(torch.rsqrt, "rsqrt", True)
square = _unary(torch.square, "square")
reciprocal = _unary(torch.reciprocal, "reciprocal", True)
sin = _unary(torch.sin, "sin", True)
cos = _unary(torch.cos, "cos", True)
tan = _unary(torch.tan, "tan", True)
asin = _unary(torch.asin, "asin", True)
acos = _unary(torch.acos, "acos", True)
atan = _unary(torch.atan, "atan", True)
sinh = _unary(torch.sinh, "sinh", True)
cosh = _unary(torch.cosh, "cosh", True)
tanh = _unary(torch.tanh, "tanh", True)
asinh = _unary(torch.asinh, "asinh", True)
acosh = _unary(torch.acosh, "acosh", True)
atanh = _unary(torch.atanh, "atanh", True)
erf = _unary(torch.erf, "erf", True)
erfinv = _unary(torch.erfinv, "erfinv", True)
sigmoid = _unary(torch.sigmoid, "sigmoid", True)
digamma = _unary(torch.digamma, "digamma", True)
lgamma = _unary(torch.lgamma, "lgamma", True)

floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")
trunc = _unary(torch.trunc, "trunc")
frac = _unary(lambda a: a - torch.trunc(a), "frac")
sign = _unary(torch.sign, "sign")


def _clip_raw(a, lo=None, hi=None):
    if lo is None and hi is None:
        return a.clone()
    return torch.clamp(a, lo, hi)


register_op("clip", _clip_raw)
register_op("isnan", torch.isnan)
register_op("isinf", torch.isinf)
register_op("isfinite", torch.isfinite)


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    return apply(_clip_raw, (x,), {"lo": lo, "hi": hi}, name="clip")


def isnan(x, name=None):
    return apply(torch.isnan, (x,), differentiable=False, name="isnan")


def isinf(x, name=None):
    return apply(torch.isinf, (x,), differentiable=False, name="isinf")


def isfinite(x, name=None):
    return apply(torch.isfinite, (x,), differentiable=False, name="isfinite")


def _nan_to_num_raw(a, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


register_op("nan_to_num", _nan_to_num_raw)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(_nan_to_num_raw, (x,),
                 {"nan": float(nan),
                  "posinf": None if posinf is None else float(posinf),
                  "neginf": None if neginf is None else float(neginf)},
                 name="nan_to_num")


# ----------------------------------------------------------------- reductions

def _dims(axis, nd):
    """An axis argument as a tuple of dims (all of them for None)."""
    if axis is None:
        return tuple(range(nd))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _keep_all(out, a, keepdim):
    """A full reduction with keepdim: every dim kept at 1."""
    return out.reshape((1,) * a.dim()) if keepdim else out


def _sum(a, dims, keepdim):
    return torch.sum(a, dim=dims, keepdim=keepdim) if dims else a.clone()


def _mean(a, dims, keepdim):
    a = _float(a)
    return torch.mean(a, dim=dims, keepdim=keepdim) if dims else a.clone()


def _prod(a, dims, keepdim):
    out = a
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out.clone() if out is a else out


def _amax(a, dims, keepdim):
    return torch.amax(a, dim=dims, keepdim=keepdim) if dims else a.clone()


def _amin(a, dims, keepdim):
    return torch.amin(a, dim=dims, keepdim=keepdim) if dims else a.clone()


def _nansum(a, dims, keepdim):
    return torch.nansum(a, dim=dims, keepdim=keepdim) if dims else \
        torch.nan_to_num(a, nan=0.0)


def _nanmean(a, dims, keepdim):
    return torch.nanmean(_float(a), dim=dims, keepdim=keepdim) if dims \
        else a.clone()


def _dtype_attr(dtype):
    return None if dtype is None else dtype_name(convert_dtype(dtype))


def _reduce(fn, name, int_result=False):
    def raw(a, axis=None, keepdim=False, out_dtype=None):
        out = fn(a, _dims(axis, a.dim()), keepdim)
        if out_dtype is not None:
            out = out.to(convert_dtype(out_dtype))
        return out
    raw.__name__ = name
    register_op(name, raw)

    def op(x, axis=None, keepdim=False, name=None, dtype=None, _opname=name):
        if isinstance(axis, (list, tuple)):
            axis = tuple(int(a) for a in axis)
        elif axis is not None and not isinstance(axis, int):
            axis = int(axis)
        return apply(raw, (x,),
                     {"axis": axis, "keepdim": bool(keepdim),
                      "out_dtype": _dtype_attr(dtype)},
                     differentiable=not int_result, name=_opname)
    op.__name__ = name
    return op


sum = _reduce(_sum, "sum")
mean = _reduce(_mean, "mean")
prod = _reduce(_prod, "prod")
max = _reduce(_amax, "max")
min = _reduce(_amin, "min")
amax = _reduce(_amax, "amax")
amin = _reduce(_amin, "amin")
nansum = _reduce(_nansum, "nansum")
nanmean = _reduce(_nanmean, "nanmean")


def _logsumexp_raw(a, axis=None, keepdim=False):
    dims = _dims(axis_arg(axis), a.dim())
    a = _float(a)
    return torch.logsumexp(a, dim=dims, keepdim=keepdim) if dims \
        else a.clone()


def _std_raw(a, axis=None, ddof=1, keepdim=False):
    return torch.std(_float(a), dim=_dims(axis_arg(axis), a.dim()),
                     correction=ddof, keepdim=keepdim)


def _var_raw(a, axis=None, ddof=1, keepdim=False):
    return torch.var(_float(a), dim=_dims(axis_arg(axis), a.dim()),
                     correction=ddof, keepdim=keepdim)


def _quantile(a, q, axis, keepdim, ignore_nan):
    """jnp.quantile's convention: linear interpolation over the reduced
    dims (flattened together), a leading dim for a sequence of q."""
    a = _float(a)
    nd = a.dim()
    dims = sorted(d % nd for d in _dims(axis, nd)) if nd else []
    keep = [d for d in range(nd) if d not in dims]
    flat = a.permute(keep + dims).reshape(
        [a.shape[d] for d in keep] + [-1])
    qs = torch.as_tensor(q, dtype=a.dtype, device=a.device) \
        if isinstance(q, (list, tuple)) else float(q)
    fn = torch.nanquantile if ignore_nan else torch.quantile
    out = fn(flat, qs, dim=-1)
    if keepdim:
        lead = list(out.shape[:1]) if isinstance(qs, torch.Tensor) else []
        out = out.reshape(lead + [1 if d in dims else a.shape[d]
                                  for d in range(nd)])
    return out


def _median_raw(a, axis=None, keepdim=False):
    return _quantile(a, 0.5, axis_arg(axis), keepdim, False)


def _argmax_raw(a, axis=None, keepdim=False, out_dtype="int64"):
    out = torch.argmax(a, dim=axis, keepdim=keepdim and axis is not None)
    if axis is None:
        out = _keep_all(out, a, keepdim)
    return out.to(convert_dtype(out_dtype))


def _argmin_raw(a, axis=None, keepdim=False, out_dtype="int64"):
    out = torch.argmin(a, dim=axis, keepdim=keepdim and axis is not None)
    if axis is None:
        out = _keep_all(out, a, keepdim)
    return out.to(convert_dtype(out_dtype))


def _cumsum_raw(a, axis=None, out_dtype=None):
    dt = convert_dtype(out_dtype) if out_dtype is not None else None
    if axis is None:
        return torch.cumsum(a.reshape(-1), 0, dtype=dt)
    return torch.cumsum(a, axis, dtype=dt)


def _cumprod_raw(a, axis=None, out_dtype=None):
    dt = convert_dtype(out_dtype) if out_dtype is not None else None
    if axis is None:
        return torch.cumprod(a.reshape(-1), 0, dtype=dt)
    return torch.cumprod(a, axis, dtype=dt)


def _count_nonzero_raw(a, axis=None, keepdim=False):
    dims = _dims(axis_arg(axis), a.dim())
    out = torch.count_nonzero(a, dim=dims) if dims else (a != 0).long()
    if keepdim:
        out = out.reshape([1 if d in [x % a.dim() for x in dims]
                           else a.shape[d] for d in range(a.dim())])
    return out.to(torch.int32)


register_op("logsumexp", _logsumexp_raw)
register_op("std", _std_raw)
register_op("var", _var_raw)
register_op("median", _median_raw)
register_op("argmax", _argmax_raw)
register_op("argmin", _argmin_raw)
register_op("cumsum", _cumsum_raw)
register_op("cumprod", _cumprod_raw)
register_op("count_nonzero", _count_nonzero_raw)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply(_logsumexp_raw, (x,),
                 {"axis": _axis_attr(axis), "keepdim": bool(keepdim)},
                 name="logsumexp")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_std_raw, (x,),
                 {"axis": _axis_attr(axis), "ddof": 1 if unbiased else 0,
                  "keepdim": bool(keepdim)}, name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_var_raw, (x,),
                 {"axis": _axis_attr(axis), "ddof": 1 if unbiased else 0,
                  "keepdim": bool(keepdim)}, name="var")


def median(x, axis=None, keepdim=False, name=None):
    return apply(_median_raw, (x,),
                 {"axis": _axis_attr(axis), "keepdim": bool(keepdim)},
                 name="median")


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_argmax_raw, (x,),
                 {"axis": None if axis is None else int(axis),
                  "keepdim": bool(keepdim), "out_dtype": str(dtype)},
                 differentiable=False, name="argmax")


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_argmin_raw, (x,),
                 {"axis": None if axis is None else int(axis),
                  "keepdim": bool(keepdim), "out_dtype": str(dtype)},
                 differentiable=False, name="argmin")


def cumsum(x, axis=None, dtype=None, name=None):
    return apply(_cumsum_raw, (x,),
                 {"axis": None if axis is None else int(axis),
                  "out_dtype": _dtype_attr(dtype)}, name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    return apply(_cumprod_raw, (x,),
                 {"axis": None if dim is None else int(dim),
                  "out_dtype": _dtype_attr(dtype)}, name="cumprod")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply(_count_nonzero_raw, (x,),
                 {"axis": _axis_attr(axis), "keepdim": bool(keepdim)},
                 differentiable=False, name="count_nonzero")


# ----------------------------------------------------------------- linalg-ish

def _matmul_raw(a, b, transpose_x=False, transpose_y=False):
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


register_op("matmul", _matmul_raw)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """torch.matmul; f32 runs in full f32 unless the caller turned TF32
    on (`torch.backends.cuda.matmul.allow_tf32`)."""
    return apply(_matmul_raw, (x, y),
                 {"transpose_x": bool(transpose_x),
                  "transpose_y": bool(transpose_y)}, name="matmul")


mm = matmul


def _dot_raw(a, b):
    return torch.sum(a * b, dim=-1)


def _bmm_raw(a, b):
    return torch.matmul(a, b)


def _outer_raw(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _addmm_raw(i, a, b, beta=1.0, alpha=1.0):
    return beta * i + alpha * torch.matmul(a, b)


register_op("dot", _dot_raw)
register_op("bmm", _bmm_raw)
register_op("inner", torch.inner)
register_op("outer", _outer_raw)
register_op("addmm", _addmm_raw)


def dot(x, y, name=None):
    return apply(_dot_raw, (x, y), name="dot")


def bmm(x, y, name=None):
    return apply(_bmm_raw, (x, y), name="bmm")


def inner(x, y, name=None):
    return apply(torch.inner, (x, y), name="inner")


def outer(x, y, name=None):
    return apply(_outer_raw, (x, y), name="outer")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(_addmm_raw, (input, x, y),
                 {"beta": float(beta), "alpha": float(alpha)}, name="addmm")


def multiplex(inputs, index, name=None):
    stacked = torch.stack([to_torch(t) for t in inputs], dim=0)
    idx = to_torch(index).reshape(-1).long()
    rows = torch.arange(idx.shape[0], device=idx.device)
    return Tensor._wrap(stacked[idx, rows])


def _trace_raw(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2).sum(-1)


def _diagonal_raw(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2)


register_op("kron", torch.kron)
register_op("trace", _trace_raw)
register_op("diagonal", _diagonal_raw)


def kron(x, y, name=None):
    return apply(torch.kron, (x, y), name="kron")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(_trace_raw, (x,),
                 {"offset": int(offset), "axis1": int(axis1),
                  "axis2": int(axis2)}, name="trace")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(_diagonal_raw, (x,),
                 {"offset": int(offset), "axis1": int(axis1),
                  "axis2": int(axis2)}, name="diagonal")


# ----------------------------------------------------------------- sort / topk

def _topk_raw(a, k=1, axis=-1, largest=True):
    vals, idxs = torch.topk(a, k, dim=-1 if axis is None else axis,
                            largest=largest, sorted=True)
    return vals, idxs.to(torch.int32)


def _sort_raw(a, axis=-1, descending=False):
    out = torch.sort(a, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def _argsort_raw(a, axis=-1, descending=False):
    # the ascending stable order, reversed for descending (ties then come
    # last index first, as the JAX package's flip gives them)
    out = torch.argsort(a, dim=axis, stable=True)
    if descending:
        out = torch.flip(out, (axis,))
    return out.to(torch.int32)


register_op("topk", _topk_raw)
register_op("sort", _sort_raw)
register_op("argsort", _argsort_raw)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, Tensor):
        k = int(k.item())
    return apply(_topk_raw, (x,),
                 {"k": int(k), "axis": None if axis is None else int(axis),
                  "largest": bool(largest)}, name="topk")


def sort(x, axis=-1, descending=False, name=None):
    return apply(_sort_raw, (x,),
                 {"axis": int(axis), "descending": bool(descending)},
                 name="sort")


def argsort(x, axis=-1, descending=False, name=None):
    return apply(_argsort_raw, (x,),
                 {"axis": int(axis), "descending": bool(descending)},
                 differentiable=False, name="argsort")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """np.unique's outputs (sorted unique values, then first-occurrence
    indices, inverse and counts as asked), computed on the tensor's
    device; the output size depends on the data, so this synchronises."""
    a = to_torch(x)
    dim = None if axis is None else int(axis)
    # with axis=None the inverse has the input's shape (numpy 2's rule)
    uniq, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    res = [uniq]
    if return_index:
        flat_inv = inv.reshape(-1)
        n = flat_inv.shape[0]
        first = torch.full((uniq.shape[0 if dim is None else dim],), n,
                           dtype=torch.long, device=a.device)
        res.append(first.scatter_reduce(0, flat_inv, torch.arange(
            n, device=a.device), "amin"))
    if return_inverse:
        res.append(inv)
    if return_counts:
        res.append(counts)
    res = [Tensor._wrap(r.to(NARROW.get(r.dtype, r.dtype))) for r in res]
    return res[0] if len(res) == 1 else tuple(res)



def _kthvalue_raw(a, k=1, axis=-1, keepdim=False):
    s, idx = torch.sort(a, dim=axis, stable=True)
    vals = s.select(axis, k - 1)
    ind = idx.select(axis, k - 1)
    if keepdim:
        vals, ind = vals.unsqueeze(axis), ind.unsqueeze(axis)
    return vals, ind.to(torch.int32)


register_op("kthvalue", _kthvalue_raw)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply(_kthvalue_raw, (x,),
                 {"k": int(k), "axis": int(axis), "keepdim": bool(keepdim)},
                 name="kthvalue")


def _mode_raw(a, axis=-1, keepdim=False):
    """ref operators/mode_op (torch-compatible tie rules: smallest modal
    VALUE, LAST index of it along the axis), by pairwise counting on the
    mode axis, on the device."""
    ax = axis % a.dim()
    m = torch.movedim(a, ax, -1)
    counts = (m[..., :, None] == m[..., None, :]).sum(-1)
    modal = counts == counts.amax(-1, keepdim=True)
    big = torch.amax(m, dim=-1, keepdim=True).expand_as(m)
    mode_val = torch.amin(torch.where(modal, m, big), dim=-1)
    pos = torch.arange(m.shape[-1], device=a.device)
    hit = m == mode_val[..., None]
    idx = torch.amax(torch.where(hit, pos, -1), dim=-1).to(torch.int32)
    if keepdim:
        mode_val, idx = mode_val.unsqueeze(ax), idx.unsqueeze(ax)
    return mode_val, idx


register_op("mode", _mode_raw)


def mode(x, axis=-1, keepdim=False, name=None):
    return apply(_mode_raw, (x,), {"axis": int(axis),
                                   "keepdim": bool(keepdim)}, name="mode")


def assign(x, output=None):
    from .creation import assign as _assign
    return _assign(x, output)


def increment(x, value=1.0, name=None):
    return x._assign((x._data.detach() + value).to(x.dtype))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    a = to_torch(input)
    lab = to_torch(label).reshape(-1)
    order = torch.flip(torch.argsort(a, dim=-1, stable=True), (-1,))
    hit = (order[:, :k] == lab[:, None]).any(dim=-1)
    return Tensor._wrap(hit.float().mean())


# --------------------------------------------------------------- round-3 tail
# (python/paddle/tensor/math.py lerp/heaviside/diff/..., search.py
# searchsorted/bucketize, stat.py quantile)

def _lerp_raw(a, b, w):
    return a + w * (b - a)


def _heaviside_raw(a, b):
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(a > 0, one, torch.where(a < 0, zero,
                                               _t(b, a).to(a.dtype)))


def _logit_raw(a, eps=None):
    x = a if eps is None else torch.clamp(a, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def _logaddexp_raw(a, b):
    return torch.logaddexp(_float(a), _float(b))


def _xlogy_raw(a, b):
    return torch.xlogy(a, b)


class _Sinc(torch.autograd.Function):
    """sinc(x) = sin(t) / t at t = pi x, with a derivative that stays
    accurate near 0: torch's, pi (t cos t - sin t) / t^2, cancels there
    (1e-4 relative at |x| ~ 2e-4 in f32, differently on the card and on
    the host); below |t| = 0.5 its Maclaurin series to t^7 (truncation
    under 2e-7)."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return torch.sinc(a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        t = np.pi * a
        t2 = t * t
        small = t.abs() < 0.5
        series = t * (-1 / 3 + t2 * (1 / 30 + t2 * (-1 / 840 + t2 / 45360)))
        safe = torch.where(small, torch.ones_like(t), t)
        direct = (safe * torch.cos(safe) - torch.sin(safe)) / (safe * safe)
        return g * np.pi * torch.where(small, series, direct)


def _sinc_raw(a):
    return _Sinc.apply(_float(a))


def _exp2_raw(a):
    return torch.exp2(_float(a))


def _rad2deg_raw(a):
    return torch.rad2deg(_float(a))


def _deg2rad_raw(a):
    return torch.deg2rad(_float(a))


def _copysign_raw(a, b):
    return torch.copysign(a, b)


def _nextafter_raw(a, b):
    return torch.nextafter(a, b)


def _gcd_raw(a, b):
    return torch.gcd(a, b)


def _lcm_raw(a, b):
    return torch.lcm(a, b)


def _diff_raw(a, n=1, axis=-1):
    return torch.diff(a, n=n, dim=axis)


def _trapezoid_raw(y, dx=1.0, axis=-1):
    return torch.trapezoid(y, dx=dx, dim=axis)


def _flat_axis(a, axis):
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def _cummax_raw(a, axis=-1):
    a, axis = _flat_axis(a, axis)
    vals, idx = torch.cummax(a, dim=axis)
    return vals, idx.to(torch.int32)


def _cummin_raw(a, axis=-1):
    a, axis = _flat_axis(a, axis)
    vals, idx = torch.cummin(a, dim=axis)
    return vals, idx.to(torch.int32)


def _logcumsumexp_raw(a, axis=-1):
    a, axis = _flat_axis(a, axis)
    return torch.logcumsumexp(_float(a), dim=axis)


def _common_type(a, b):
    """a and b in their promoted dtype (torch ops that take one)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _searchsorted_raw(sorted_seq, values, right=False):
    seq, vals = _common_type(sorted_seq, values)
    if seq.dim() == 1:
        return torch.searchsorted(seq, vals, right=right).to(torch.int32)
    # N-D: the leading dims of the sequence and the values match (paddle
    # searchsorted); row by row over the flattened leading dims
    ss2 = seq.reshape(-1, seq.shape[-1])
    vv2 = vals.reshape(ss2.shape[0], -1)
    out = torch.searchsorted(ss2.contiguous(), vv2.contiguous(), right=right)
    return out.reshape(values.shape).to(torch.int32)


def _bucketize_raw(a, bins, right=False):
    seq, vals = _common_type(bins, a)
    return torch.searchsorted(seq, vals, right=right).to(torch.int32)


def _renorm_raw(a, p=2.0, axis=0, max_norm=1.0):
    moved = torch.movedim(a, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.pow(torch.sum(torch.pow(torch.abs(flat), p), dim=1),
                      1.0 / p)
    scale_f = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                          torch.ones((), dtype=norms.dtype,
                                     device=norms.device))
    out = flat * scale_f[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


def _quantile_raw(a, q=0.5, axis=None, keepdim=False, ignore_nan=False):
    return _quantile(a, q, axis_arg(axis), keepdim, ignore_nan)


def _dist_raw(a, b, p=2.0):
    d = (a - b).reshape(-1)
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.sum(d != 0).to(a.dtype)
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


def _angle_raw(a):
    return torch.angle(_float(a))


def _conj_raw(a):
    return torch.conj(a).resolve_conj() if a.is_complex() else a


def _real_raw(a):
    return torch.real(a) if a.is_complex() else a


def _imag_raw(a):
    return torch.imag(a) if a.is_complex() else torch.zeros_like(a)


def _complex_raw(a, b):
    return torch.complex(a, b)


def _polar_raw(r, theta):
    return torch.complex(r * torch.cos(theta), r * torch.sin(theta))


def _sgn_raw(a):
    return torch.sgn(a)


def _signbit_raw(a):
    return torch.signbit(a)


def _ldexp_raw(a, b):
    return a * torch.exp2(b.float()).to(a.dtype)


register_op("lerp", _lerp_raw)
register_op("heaviside", _heaviside_raw)
register_op("logit", _logit_raw)
register_op("logaddexp", _logaddexp_raw)
register_op("xlogy", _xlogy_raw)
register_op("sinc", _sinc_raw)
register_op("exp2", _exp2_raw)
register_op("rad2deg", _rad2deg_raw)
register_op("deg2rad", _deg2rad_raw)
register_op("copysign", _copysign_raw)
register_op("nextafter", _nextafter_raw)
register_op("gcd", _gcd_raw)
register_op("lcm", _lcm_raw)
register_op("diff", _diff_raw)
register_op("trapezoid", _trapezoid_raw)
register_op("cummax", _cummax_raw)
register_op("cummin", _cummin_raw)
register_op("logcumsumexp", _logcumsumexp_raw)
register_op("searchsorted", _searchsorted_raw)
register_op("bucketize", _bucketize_raw)
register_op("renorm", _renorm_raw)
register_op("quantile", _quantile_raw)
register_op("dist", _dist_raw)
register_op("angle", _angle_raw)
register_op("conj", _conj_raw)
register_op("real", _real_raw)
register_op("imag", _imag_raw)
register_op("complex", _complex_raw)
register_op("polar", _polar_raw)
register_op("sgn", _sgn_raw)
register_op("signbit", _signbit_raw)
register_op("ldexp", _ldexp_raw)


def lerp(x, y, weight, name=None):
    return apply(_lerp_raw, (x, y, weight), name="lerp")


def heaviside(x, y, name=None):
    return apply(_heaviside_raw, (x, y), differentiable=False,
                 name="heaviside")


def logit(x, eps=None, name=None):
    return apply(_logit_raw, (x,),
                 {"eps": None if eps is None else float(eps)}, name="logit")


def logaddexp(x, y, name=None):
    return apply(_logaddexp_raw, (x, y), name="logaddexp")


def xlogy(x, y, name=None):
    return apply(_xlogy_raw, (x, y), name="xlogy")


def sinc(x, name=None):
    return apply(_sinc_raw, (x,), name="sinc")


def exp2(x, name=None):
    return apply(_exp2_raw, (x,), name="exp2")


def rad2deg(x, name=None):
    return apply(_rad2deg_raw, (x,), name="rad2deg")


def deg2rad(x, name=None):
    return apply(_deg2rad_raw, (x,), name="deg2rad")


def copysign(x, y, name=None):
    return apply(_copysign_raw, (x, y), differentiable=False,
                 name="copysign")


def nextafter(x, y, name=None):
    return apply(_nextafter_raw, (x, y), differentiable=False,
                 name="nextafter")


def gcd(x, y, name=None):
    return apply(_gcd_raw, (x, y), differentiable=False, name="gcd")


def lcm(x, y, name=None):
    return apply(_lcm_raw, (x, y), differentiable=False, name="lcm")


def diff(x, n=1, axis=-1, name=None):
    return apply(_diff_raw, (x,), {"n": int(n), "axis": int(axis)},
                 name="diff")


def trapezoid(y, x=None, dx=1.0, axis=-1, name=None):
    if x is not None:
        raise NotImplementedError("trapezoid: sample-point x unsupported; "
                                  "pass dx")
    return apply(_trapezoid_raw, (y,),
                 {"dx": float(dx), "axis": int(axis)}, name="trapezoid")


def cummax(x, axis=None, name=None):
    return apply(_cummax_raw, (x,),
                 {"axis": None if axis is None else int(axis)},
                 name="cummax")


def cummin(x, axis=None, name=None):
    return apply(_cummin_raw, (x,),
                 {"axis": None if axis is None else int(axis)},
                 name="cummin")


def logcumsumexp(x, axis=None, name=None):
    return apply(_logcumsumexp_raw, (x,),
                 {"axis": None if axis is None else int(axis)},
                 name="logcumsumexp")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply(_searchsorted_raw, (sorted_sequence, values),
                 {"right": bool(right)}, differentiable=False,
                 name="searchsorted")


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply(_bucketize_raw, (x, sorted_sequence),
                 {"right": bool(right)}, differentiable=False,
                 name="bucketize")


def renorm(x, p, axis, max_norm, name=None):
    return apply(_renorm_raw, (x,),
                 {"p": float(p), "axis": int(axis),
                  "max_norm": float(max_norm)}, name="renorm")


def quantile(x, q, axis=None, keepdim=False, name=None):
    return apply(_quantile_raw, (x,),
                 {"q": q if isinstance(q, (int, float)) else list(q),
                  "axis": _axis_attr(axis), "keepdim": bool(keepdim),
                  "ignore_nan": False}, name="quantile")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return apply(_quantile_raw, (x,),
                 {"q": q if isinstance(q, (int, float)) else list(q),
                  "axis": _axis_attr(axis), "keepdim": bool(keepdim),
                  "ignore_nan": True}, name="quantile")


def dist(x, y, p=2.0, name=None):
    return apply(_dist_raw, (x, y), {"p": float(p)}, name="dist")


def angle(x, name=None):
    return apply(_angle_raw, (x,), differentiable=False, name="angle")


def conj(x, name=None):
    return apply(_conj_raw, (x,), name="conj")


def real(x, name=None):
    return apply(_real_raw, (x,), name="real")


def imag(x, name=None):
    return apply(_imag_raw, (x,), name="imag")


def complex(real_t, imag_t, name=None):
    return apply(_complex_raw, (real_t, imag_t), name="complex")


def polar(abs_t, angle_t, name=None):
    return apply(_polar_raw, (abs_t, angle_t), name="polar")


def sgn(x, name=None):
    return apply(_sgn_raw, (x,), differentiable=False, name="sgn")


def signbit(x, name=None):
    return apply(_signbit_raw, (x,), differentiable=False, name="signbit")


def ldexp(x, y, name=None):
    return apply(_ldexp_raw, (x, y), differentiable=False, name="ldexp")


def add_n(inputs, name=None):
    """ref sum_op: elementwise sum of a tensor list."""
    if isinstance(inputs, Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = add(out, t)
    return out


def _mv_raw(a, v):
    return torch.matmul(a, v)


register_op("mv", _mv_raw)


def mv(x, vec, name=None):
    return apply(_mv_raw, (x, vec), name="mv")


def numel(x, name=None):
    d = as_array(x)
    return Tensor._wrap(torch.full((), builtins.int(np.prod(x.shape)),
                                   dtype=torch.int32, device=d.device))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
