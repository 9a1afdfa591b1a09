"""Linear algebra ops (the port of `paddle_tpu/ops/linalg.py`; ref
operators/norm_op, cholesky_op, svd; python/paddle/tensor/linalg.py
surface), on `torch.linalg`."""
import torch

from ..framework.tensor import Tensor, to_torch
from .dispatch import apply, register_op


def _norm_raw(a, p="fro", axis=None, keepdim=False):
    axis = tuple(axis) if isinstance(axis, list) else axis
    if p == "fro" and (axis is None or isinstance(axis, tuple)):
        dims = tuple(range(a.dim())) if axis is None else axis
        return torch.sqrt(torch.sum(torch.square(a), dim=dims,
                                    keepdim=keepdim))
    dims = tuple(range(a.dim())) if axis is None else axis
    if p == float("inf"):
        return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
    pw = float(p)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), pw), dim=dims,
                               keepdim=keepdim), 1.0 / pw)


register_op("norm", _norm_raw)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = [int(a) for a in axis]
    elif axis is not None:
        axis = int(axis)
    return apply(_norm_raw, (x,),
                 {"p": p if isinstance(p, str) else float(p), "axis": axis,
                  "keepdim": bool(keepdim)}, name="norm")


def _cholesky_raw(a, upper=False):
    lo = torch.linalg.cholesky(a)
    return lo.transpose(-1, -2) if upper else lo


register_op("cholesky", _cholesky_raw)


def cholesky(x, upper=False, name=None):
    return apply(_cholesky_raw, (x,), {"upper": bool(upper)}, name="cholesky")


register_op("inverse", torch.linalg.inv)


def inverse(x, name=None):
    return apply(torch.linalg.inv, (x,), name="inverse")


inv = inverse


def _pinv_raw(a, rcond=1e-15):
    return torch.linalg.pinv(a, rtol=rcond)


register_op("pinv", _pinv_raw)


def pinv(x, rcond=1e-15, name=None):
    return apply(_pinv_raw, (x,), {"rcond": float(rcond)}, name="pinv")


register_op("det", torch.linalg.det)


def det(x, name=None):
    return apply(torch.linalg.det, (x,), name="det")


def _slogdet_raw(a):
    sign, logdet = torch.linalg.slogdet(a)
    return torch.stack([sign, logdet])


register_op("slogdet", _slogdet_raw)


def slogdet(x, name=None):
    return apply(_slogdet_raw, (x,), name="slogdet")


def _matrix_power_raw(a, n=1):
    return torch.linalg.matrix_power(a, n)


register_op("matrix_power", _matrix_power_raw)


def matrix_power(x, n, name=None):
    return apply(_matrix_power_raw, (x,), {"n": int(n)}, name="matrix_power")


def _matrix_rank_raw(a, tol=None):
    # jnp's tol is absolute; its default is max(M, N) * eps * S.max(),
    # torch's default rtol
    if tol is None:
        return torch.linalg.matrix_rank(a).to(torch.int32)
    return torch.linalg.matrix_rank(a, atol=tol, rtol=0.0).to(torch.int32)


register_op("matrix_rank", _matrix_rank_raw)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(_matrix_rank_raw, (x,),
                 {"tol": None if tol is None else float(tol)},
                 differentiable=False, name="matrix_rank")


def _svd_raw(a, full_matrices=False):
    u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


register_op("svd", _svd_raw)


def svd(x, full_matrices=False, name=None):
    return apply(_svd_raw, (x,), {"full_matrices": bool(full_matrices)},
                 name="svd")


def _qr_raw(a, mode="reduced"):
    q, r = torch.linalg.qr(a, mode=mode)
    return q, r


register_op("qr", _qr_raw)


def qr(x, mode="reduced", name=None):
    return apply(_qr_raw, (x,), {"mode": str(mode)}, name="qr")


def _eigh_raw(a, UPLO="L"):
    w, v = torch.linalg.eigh(a, UPLO=UPLO)
    return w, v


register_op("eigh", _eigh_raw)


def eigh(x, UPLO="L", name=None):
    return apply(_eigh_raw, (x,), {"UPLO": str(UPLO)}, name="eigh")


def _eigvalsh_raw(a, UPLO="L"):
    return torch.linalg.eigvalsh(a, UPLO=UPLO)


register_op("eigvalsh", _eigvalsh_raw)


def eigvalsh(x, UPLO="L", name=None):
    return apply(_eigvalsh_raw, (x,), {"UPLO": str(UPLO)}, name="eigvalsh")


register_op("solve", torch.linalg.solve)


def solve(x, y, name=None):
    return apply(torch.linalg.solve, (x, y), name="solve")


def _as_matrix(b):
    """A right-hand side as a matrix (torch's triangular solves take no
    vector), and the function that undoes it."""
    if b.dim() == 1:
        return b[:, None], lambda x: x[:, 0]
    return b, lambda x: x


def _triangular_solve_raw(a, b, upper=True, transpose=False,
                          unitriangular=False):
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    b, back = _as_matrix(b)
    return back(torch.linalg.solve_triangular(a, b, upper=upper,
                                              unitriangular=unitriangular))


register_op("triangular_solve", _triangular_solve_raw)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return apply(_triangular_solve_raw, (x, y),
                 {"upper": bool(upper), "transpose": bool(transpose),
                  "unitriangular": bool(unitriangular)},
                 name="triangular_solve")


def _cholesky_solve_raw(b, lo, upper=False):
    # two triangular solves, so that the factor's other triangle, which
    # the function never reads, gets no gradient (as in jax's cho_solve)
    b, back = _as_matrix(b)
    lower = lo.transpose(-1, -2) if upper else lo
    y = torch.linalg.solve_triangular(lower, b, upper=False)
    return back(torch.linalg.solve_triangular(lower.transpose(-1, -2), y,
                                              upper=True))


register_op("cholesky_solve", _cholesky_solve_raw)


def cholesky_solve(x, y, upper=False, name=None):
    return apply(_cholesky_solve_raw, (x, y), {"upper": bool(upper)},
                 name="cholesky_solve")


def _lstsq_raw(a, b, rcond=None):
    # the least-squares solution through the pseudo-inverse, with jnp's
    # cutoff (singular values below rcond * the largest dropped; rcond
    # defaults to eps * max(M, N)): one formula on every device, and
    # differentiable
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(a.shape[-2:])
    return torch.linalg.pinv(a, rtol=rcond) @ b


register_op("lstsq", _lstsq_raw)


def lstsq(x, y, rcond=None, name=None):
    return apply(_lstsq_raw, (x, y),
                 {"rcond": None if rcond is None else float(rcond)},
                 name="lstsq")


def _cross_raw(a, b, axis=-1):
    return torch.linalg.cross(a, b, dim=axis)


register_op("cross", _cross_raw)


def cross(x, y, axis=None, name=None):
    return apply(_cross_raw, (x, y),
                 {"axis": -1 if axis is None else int(axis)}, name="cross")


def _histogram_raw(a, bins=100, lo=0, hi=0):
    # lo == hi == 0: the data's own range (torch.histc's convention too)
    return torch.histc(a.float(), bins=bins, min=lo, max=hi).to(torch.int32)


register_op("histogram", _histogram_raw)


def histogram(input, bins=100, min=0, max=0, name=None):
    return apply(_histogram_raw, (input,),
                 {"bins": int(bins), "lo": float(min), "hi": float(max)},
                 differentiable=False, name="histogram")


def bincount(x, weights=None, minlength=0, name=None):
    a = to_torch(x).long()
    w = None if weights is None else to_torch(weights)
    out = torch.bincount(a, weights=w, minlength=int(minlength))
    return Tensor._wrap(out.float() if w is not None
                        else out.to(torch.int32))
