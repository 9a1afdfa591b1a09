"""Seeded cases of the port's registered ops, one or more per op name,
shared by `tests/test_torch_ops.py` (the port against the JAX package on
the CPU) and `chip_smoke.py`'s eager phase (the port on the card against
the port on the CPU). Each case is `fn(n, *tensors)` over a namespace `n`
of one package's op modules (`n.P` the package, `n.math`, `n.manip`,
...), its numpy inputs, and the indices of the inputs to differentiate;
`op` names the registered op when the case name is not it. Imports
numpy only.
"""
import functools
import zlib

import numpy as np


class NS:
    """One package's op modules, as the cases address them."""

    def __init__(self, P, creation, math, manip, logic, linalg, seq, flash):
        self.P, self.creation, self.math, self.manip = P, creation, math, manip
        self.logic, self.linalg, self.seq, self.flash = logic, linalg, seq, \
            flash


def port_namespace():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import (creation, flash_attention, linalg,
                                      logic, manipulation, math, sequence)
    return NS(pt, creation, math, manipulation, logic, linalg, sequence,
              flash_attention)


@functools.lru_cache(maxsize=None)
def arr(kind, shape=(3, 4), seed=0):
    """Seeded inputs, one array per (kind, shape, seed)."""
    r = np.random.RandomState(seed + 7 * len(kind))
    if kind == "x":
        return r.uniform(-1, 1, shape).astype("f4")
    if kind == "pos":
        return r.uniform(0.5, 2.0, shape).astype("f4")
    if kind == "unit":
        return r.uniform(-0.9, 0.9, shape).astype("f4")
    if kind == "gt1":
        return r.uniform(1.5, 3.0, shape).astype("f4")
    if kind == "p01":
        return r.uniform(0.1, 0.9, shape).astype("f4")
    if kind == "int":
        return r.randint(-5, 6, shape).astype("int32")
    if kind == "ipos":
        return r.randint(1, 10, shape).astype("int32")
    if kind == "bool":
        return r.rand(*shape) > 0.5
    if kind == "special":
        a = r.uniform(-1, 1, shape).astype("f4")
        a.flat[1], a.flat[4], a.flat[7] = np.nan, np.inf, -np.inf
        return a
    if kind == "nan":
        a = r.uniform(-1, 1, shape).astype("f4")
        a.flat[2] = a.flat[9] = np.nan
        return a
    if kind == "spd":
        a = r.uniform(-1, 1, shape).astype("f4")
        return (a @ a.T + shape[0] * np.eye(shape[0])).astype("f4")
    if kind == "lower":
        a = np.tril(r.uniform(-1, 1, shape)) + 3 * np.eye(shape[0])
        return a.astype("f4")
    if kind == "complex":
        return (r.uniform(-1, 1, shape) + 1j * r.uniform(-1, 1, shape)
                ).astype("c8")
    if kind == "small":
        return r.randint(0, 3, shape).astype("f4")
    raise KeyError(kind)


def I(*v):
    return np.asarray(v, dtype="int32")


X, Y = arr("x"), arr("x", seed=1)
LENS = I(5, 3)
SEQ = arr("x", (2, 5, 3))
SEQ2 = arr("x", (2, 5), seed=2)
IDS = np.random.RandomState(3).randint(1, 6, (2, 5)).astype("int32")


def case(fn, inputs, diff=(), **kw):
    return dict(fn=fn, inputs=inputs, diff=tuple(diff), **kw)


def unary(name, kind="x"):
    return case(lambda n, x: getattr(n.math, name)(x), [arr(kind)], [0])


def binary(name, kx="x", ky="x", diff=(0, 1)):
    return case(lambda n, x, y: getattr(n.math, name)(x, y),
                [arr(kx), arr(ky, seed=1)], diff)


def cmp(name, kx="x", ky="x"):
    return case(lambda n, x, y: getattr(n.logic, name)(x, y),
                [arr(kx), arr(ky, seed=1)])


def abs_all(n, outs):
    return tuple(n.math.abs(o) for o in outs)


CASES = {
    # creation
    "tril": case(lambda n, x: n.creation.tril(x, diagonal=1), [X], [0]),
    "triu": case(lambda n, x: n.creation.triu(x, diagonal=-1), [X], [0]),
    "assign": case(lambda n, x: n.creation.assign(x), [X], [0]),
    "meshgrid": case(lambda n, a, b: n.creation.meshgrid(a, b),
                     [arr("x", (3,)), arr("x", (4,), seed=1)], [0, 1]),
    "unbind": case(lambda n, x: n.manip.unbind(x, axis=1), [X], [0]),
    # unregistered ops whose output size depends on the data
    "nonzero": case(lambda n, i: (n.manip.nonzero(i),)
                    + tuple(n.manip.nonzero(i, as_tuple=True)),
                    [arr("int")], op=None),
    "masked_select": case(lambda n, x, m: n.manip.masked_select(x, m),
                          [X, arr("bool")], op=None),
    "unique": case(lambda n, i: n.math.unique(i, return_index=True,
                                              return_inverse=True,
                                              return_counts=True),
                   [arr("int")], op=None),
    "bincount": case(lambda n, i, w: (n.linalg.bincount(i),
                                      n.linalg.bincount(i, weights=w)),
                     [arr("ipos", (12,)), arr("x", (12,))], op=None),
    # math: binary
    **{k: binary(k) for k in ("add", "subtract", "multiply", "maximum",
                              "minimum", "fmax", "fmin", "atan2", "hypot",
                              "logaddexp")},
    "divide": binary("divide", "x", "pos"),
    "pow": binary("pow", "pos", "x"),
    "floor_divide": binary("floor_divide", "int", "ipos", ()),
    "remainder": binary("remainder", "int", "ipos", ()),
    "xlogy": binary("xlogy", "pos", "pos"),
    "copysign": binary("copysign", diff=()),
    "nextafter": binary("nextafter", diff=()),
    "gcd": binary("gcd", "ipos", "ipos", ()),
    "lcm": binary("lcm", "ipos", "ipos", ()),
    "heaviside": case(lambda n, x, y: n.math.heaviside(x, y),
                      [arr("small") - 1, Y]),
    "scale": case(lambda n, x: n.math.scale(x, scale=2.0, bias=0.5), [X],
                  [0]),
    # math: unary
    **{k: unary(k) for k in ("abs", "neg", "exp", "expm1", "square", "sin",
                             "cos", "tan", "atan", "sinh", "cosh", "tanh",
                             "asinh", "erf", "sigmoid", "floor", "ceil",
                             "round", "trunc", "sign", "frac", "sinc", "exp2",
                             "rad2deg", "deg2rad")},
    **{k: unary(k, "pos") for k in ("log", "log2", "log10", "log1p", "sqrt",
                                    "rsqrt", "reciprocal", "digamma",
                                    "lgamma")},
    **{k: unary(k, "unit") for k in ("asin", "acos", "atanh", "erfinv")},
    "acosh": unary("acosh", "gt1"),
    "logit": case(lambda n, x: n.math.logit(x), [arr("p01")], [0]),
    "clip": case(lambda n, x: n.math.clip(x, min=-0.5, max=0.5), [X], [0]),
    **{k: case(lambda n, x, k=k: getattr(n.math, k)(x), [arr("special")])
       for k in ("isnan", "isinf", "isfinite")},
    "nan_to_num": case(lambda n, x: n.math.nan_to_num(x, posinf=9.0),
                       [arr("special")], [0]),
    # math: reductions
    "sum": case(lambda n, x: n.math.sum(x, axis=1), [X], [0]),
    "mean": case(lambda n, x: n.math.mean(x, axis=[0, 1], keepdim=True), [X],
                 [0]),
    "prod": case(lambda n, x: n.math.prod(x, axis=0), [arr("pos")], [0]),
    "max": case(lambda n, x: n.math.max(x, axis=1), [X], [0]),
    "min": case(lambda n, x: n.math.min(x, axis=-1, keepdim=True), [X], [0]),
    "amax": case(lambda n, x: n.math.amax(x), [X], [0]),
    "amin": case(lambda n, x: n.math.amin(x, axis=0), [X], [0]),
    "nansum": case(lambda n, x: n.math.nansum(x, axis=1), [arr("nan")], [0]),
    "nanmean": case(lambda n, x: n.math.nanmean(x, axis=1), [arr("nan")],
                    [0]),
    "logsumexp": case(lambda n, x: n.math.logsumexp(x, axis=1), [X], [0]),
    "std": case(lambda n, x: n.math.std(x, axis=1), [X], [0]),
    "var": case(lambda n, x: n.math.var(x, unbiased=False), [X], [0]),
    "median": case(lambda n, x: (n.math.median(x, axis=1),
                                 n.math.median(x, keepdim=True)), [X], [0]),
    "argmax": case(lambda n, x: (n.math.argmax(x, axis=1),
                                 n.math.argmax(x)), [X]),
    "argmin": case(lambda n, x: n.math.argmin(x, axis=0, keepdim=True), [X]),
    "cumsum": case(lambda n, x, i: (n.math.cumsum(x, axis=1),
                                    n.math.cumsum(i)), [X, arr("int")], [0]),
    "cumprod": case(lambda n, x: n.math.cumprod(x, dim=1), [arr("pos")],
                    [0]),
    "count_nonzero": case(lambda n, i: n.math.count_nonzero(i, axis=1),
                          [arr("int")]),
    # math: products
    "matmul": case(lambda n, x, w: n.math.matmul(x, w, transpose_y=True),
                   [X, arr("x", (5, 4))], [0, 1]),
    "dot": binary("dot"),
    "bmm": case(lambda n, a, b: n.math.bmm(a, b),
                [arr("x", (2, 3, 4)), arr("x", (2, 4, 5))], [0, 1]),
    "inner": binary("inner"),
    "outer": case(lambda n, a, b: n.math.outer(a, b),
                  [arr("x", (3,)), arr("x", (4,))], [0, 1]),
    "addmm": case(lambda n, i, a, b: n.math.addmm(i, a, b, beta=0.5,
                                                  alpha=2.0),
                  [arr("x", (3, 5)), X, arr("x", (4, 5))], [0, 1, 2]),
    "kron": case(lambda n, a, b: n.math.kron(a, b),
                 [arr("x", (2, 2)), arr("x", (2, 3))], [0, 1]),
    "trace": case(lambda n, x: n.math.trace(x, offset=1), [X], [0]),
    "diagonal": case(lambda n, x: n.math.diagonal(x, offset=-1), [X], [0]),
    "mv": case(lambda n, a, v: n.math.mv(a, v), [X, arr("x", (4,))],
               [0, 1]),
    # math: sort/search
    "topk": case(lambda n, x: n.math.topk(x, 2, axis=1), [X], [0]),
    "sort": case(lambda n, x: n.math.sort(x, axis=1, descending=True), [X],
                 [0]),
    "argsort": case(lambda n, x, s: (n.math.argsort(x, axis=0,
                                                    descending=True),
                                     n.math.argsort(s, descending=True)),
                    [X, arr("small")]),
    "kthvalue": case(lambda n, x: n.math.kthvalue(x, 2, axis=1), [X], [0]),
    "mode": case(lambda n, x: n.math.mode(x, axis=1), [arr("small", (3, 7))]),
    "lerp": case(lambda n, x, y, w: n.math.lerp(x, y, w),
                 [X, Y, arr("p01")], [0, 1, 2]),
    "diff": case(lambda n, x: n.math.diff(x, axis=1), [X], [0]),
    "trapezoid": case(lambda n, x: n.math.trapezoid(x, dx=0.5), [X], [0]),
    "cummax": case(lambda n, x: n.math.cummax(x, axis=1), [X], [0]),
    "cummin": case(lambda n, x: n.math.cummin(x), [X], [0]),
    "logcumsumexp": case(lambda n, x: n.math.logcumsumexp(x, axis=1), [X],
                         [0]),
    "searchsorted": case(
        lambda n, s, v, s2, v2: (n.math.searchsorted(s, v),
                                 n.math.searchsorted(s, v, right=True),
                                 n.math.searchsorted(s2, v2)),
        [np.sort(arr("x", (6,))), X, np.sort(arr("x", (3, 5)), 1),
         arr("x", (3, 2), seed=4)]),
    "bucketize": case(lambda n, x, b: n.math.bucketize(x, b),
                      [X, np.sort(arr("x", (5,), seed=2))]),
    "renorm": case(lambda n, x: n.math.renorm(x, 2.0, 0, 1.0),
                   [2 * arr("x")], [0]),
    "quantile": case(lambda n, x: (n.math.quantile(x, [0.25, 0.5], axis=1),
                                   n.math.nanquantile(x, 0.3)), [X], [0]),
    "dist": binary("dist"),
    "angle": case(lambda n, x: n.math.angle(x), [X]),
    "conj": case(lambda n, c: n.math.conj(c), [arr("complex")], [0]),
    "real": case(lambda n, c: n.math.real(c), [arr("complex")], [0]),
    "imag": case(lambda n, c: n.math.imag(c), [arr("complex")], [0]),
    "complex": binary("complex"),
    "polar": binary("polar", "pos", "x"),
    "sgn": case(lambda n, c, x: (n.math.sgn(c), n.math.sgn(x)),
                [arr("complex"), X]),
    "signbit": case(lambda n, x: n.math.signbit(x), [X]),
    "ldexp": case(lambda n, x, i: n.math.ldexp(x, i), [X, arr("int")]),
    # manipulation
    "cast": case(lambda n, x: (n.manip.cast(x, "float16"),
                               n.manip.cast(x * 4, "int64")), [X], [0]),
    "reshape": case(lambda n, x: n.manip.reshape(x, [2, -1]), [X], [0]),
    "flatten": case(lambda n, x: n.manip.flatten(x, 1, 2),
                    [arr("x", (2, 3, 4))], [0]),
    "transpose": case(lambda n, x: n.manip.transpose(x, [2, 0, 1]),
                      [arr("x", (2, 3, 4))], [0]),
    "moveaxis": case(lambda n, x: n.manip.moveaxis(x, 0, 2),
                     [arr("x", (2, 3, 4))], [0]),
    "swapaxes": case(lambda n, x: n.manip.swapaxes(x, 0, 2),
                     [arr("x", (2, 3, 4))], [0]),
    "t": case(lambda n, x: n.manip.t(x), [X], [0]),
    "concat": case(lambda n, x, y: n.manip.concat([x, y], axis=1), [X, Y],
                   [0, 1]),
    "stack": case(lambda n, x, y: n.manip.stack([x, y], axis=1), [X, Y],
                  [0, 1]),
    "unstack": case(lambda n, x: n.manip.unstack(x, axis=1), [X], [0]),
    "split": case(lambda n, x: n.manip.split(x, [1, -1, 1], axis=1) +
                  n.manip.split(x, 3), [X], [0]),
    "squeeze": case(lambda n, x: (n.manip.squeeze(x, axis=[0, 1]),
                                  n.manip.squeeze(x)),
                    [arr("x", (1, 3, 1))], [0]),
    "unsqueeze": case(lambda n, x: n.manip.unsqueeze(x, [0, -1]), [X], [0]),
    "expand": case(lambda n, x: n.manip.expand(x, [2, 3, 4]),
                   [arr("x", (3, 1))], [0]),
    "tile": case(lambda n, x: n.manip.tile(x, [2, 1]), [X], [0]),
    "repeat_interleave": case(
        lambda n, x: (n.manip.repeat_interleave(x, 2, axis=1),
                      n.manip.repeat_interleave(x, 3)),
        [X], [0]),
    "flip": case(lambda n, x: n.manip.flip(x, [0, 1]), [X], [0]),
    "roll": case(lambda n, x: (n.manip.roll(x, 1, axis=1),
                               n.manip.roll(x, 2)), [X], [0]),
    "rot90": case(lambda n, x: n.manip.rot90(x, 1, [0, 1]), [X], [0]),
    "getitem": case(lambda n, x: (x[1:, ::-2], x[..., 1], x[None, -1],
                                  x[::-1, 2:0:-1]), [X], [0]),
    "slice": case(lambda n, x: n.manip.slice(x, [1], [1], [9]), [X], [0]),
    "strided_slice": case(
        lambda n, x: n.manip.strided_slice(x, [0, 1], [0, 3], [3, 0],
                                           [2, -2]), [X], [0]),
    "gather": case(lambda n, x, i: n.manip.gather(x, i, axis=1),
                   [X, I(3, 0, 3)], [0]),
    "take_along_axis": case(
        lambda n, x, i: n.manip.take_along_axis(x, i, axis=1),
        [X, np.array([[0, 3], [1, 1], [2, 0]], "int32")], [0]),
    "put_along_axis": case(
        lambda n, x, i, v: (n.manip.put_along_axis(x, i, v, 1, "add"),
                            n.manip.put_along_axis(x, i, 0.5, 1)),
        [X, np.array([[0, 3], [1, 2], [2, 0]], "int32"),
         arr("x", (3, 2))], [0, 2]),
    "gather_nd": case(lambda n, x, i: n.manip.gather_nd(x, i),
                      [X, np.array([[0, 1], [2, 3]], "int32")], [0]),
    "scatter": case(
        lambda n, x, i, u: (n.manip.scatter(x, i, u),
                            n.manip.scatter(x, i, u, overwrite=False)),
        [arr("x", (4, 3)), I(2, 0), arr("x", (2, 3), seed=1)], [0, 2]),
    "scatter_nd_add": case(
        lambda n, x, i, u: n.manip.scatter_nd_add(x, i, u),
        [X, np.array([[0, 1], [2, 3], [0, 1]], "int32"), arr("x", (3,))],
        [0, 2]),
    "index_select": case(lambda n, x, i: n.manip.index_select(x, i, axis=1),
                         [X, I(2, 2, 0)], [0]),
    "index_sample": case(lambda n, x, i: n.manip.index_sample(x, i),
                         [X, np.array([[0, 3], [1, 1], [2, 0]], "int32")],
                         [0]),
    "where": case(lambda n, c, x, y: n.manip.where(c, x, y),
                  [arr("bool"), X, Y], [1, 2]),
    "masked_fill": case(lambda n, x, m: n.manip.masked_fill(x, m, 0.5),
                        [X, arr("bool")], [0]),
    "fill_diagonal": case(lambda n, x: n.manip.fill_diagonal(x, 2.0, 1), [X],
                          [0]),
    "shard_index": case(lambda n, i: n.manip.shard_index(i, 20, 2, 1),
                        [np.arange(0, 20, 2, dtype="int32")]),
    "one_hot": case(lambda n, i: n.manip.one_hot(i, 5), [I(0, 4, 5, -1)]),
    "tensordot": case(lambda n, a, b: (n.manip.tensordot(a, b, 1),
                                       n.manip.tensordot(a, b, [[1], [0]])),
                      [X, arr("x", (4, 5))], [0, 1]),
    "as_complex": case(lambda n, x: n.manip.as_complex(x),
                       [arr("x", (3, 2))], [0]),
    "as_real": case(lambda n, c: n.manip.as_real(c), [arr("complex")], [0]),
    "crop": case(lambda n, x: (n.manip.crop(x, [2, 2], [1, 1]),
                               n.manip.crop(x, [2, -1], [2, 3])), [X], [0]),
    "take": case(lambda n, x, i: (n.manip.take(x, i),
                                  n.manip.take(x, i + 20, mode="wrap"),
                                  n.manip.take(x, i + 20, mode="clip")),
                 [X, I(-1, 3, 5)], [0]),
    "index_add": case(lambda n, x, i, v: n.manip.index_add(x, i, 0, v),
                      [X, I(2, 0), arr("x", (2, 4), seed=5)], [0, 2]),
    "index_put": case(lambda n, x, i, j, v: n.manip.index_put(x, (i, j), v),
                      [X, I(0, 2), I(1, 3), arr("x", (2,))], [0, 3]),
    "masked_scatter": case(
        lambda n, x, m, v: n.manip.masked_scatter(x, m, v),
        [X, arr("bool"), arr("x", (12,), seed=6)], [0, 2]),
    "unflatten": case(lambda n, x: n.manip.unflatten(x, 1, [2, -1]), [X],
                      [0]),
    # logic
    **{k: cmp(k) for k in ("greater_than", "greater_equal", "less_than",
                           "less_equal")},
    **{k: cmp(k, "int", "int") for k in ("equal", "not_equal", "bitwise_and",
                                         "bitwise_or", "bitwise_xor")},
    **{k: cmp(k, "bool", "bool") for k in ("logical_and", "logical_or",
                                           "logical_xor")},
    "logical_not": case(lambda n, b: n.logic.logical_not(b), [arr("bool")]),
    "bitwise_not": case(lambda n, i: n.logic.bitwise_not(i), [arr("int")]),
    "all": case(lambda n, b: (n.logic.all(b, axis=1), n.logic.all(b)),
                [arr("bool")]),
    "any": case(lambda n, b: (n.logic.any(b, axis=0, keepdim=True),
                              n.logic.any(b)), [arr("bool")]),
    "isclose": case(lambda n, x, y: n.logic.isclose(x, y, atol=0.3),
                    [X, Y]),
    "allclose": case(lambda n, x, y: (n.logic.allclose(x, y),
                                      n.logic.allclose(x, x)), [X, Y]),
    "equal_all": case(lambda n, i, j: (n.logic.equal_all(i, i),
                                       n.logic.equal_all(i, j)),
                      [arr("int"), arr("int", seed=1)]),
    # linalg
    "norm": case(lambda n, x: (n.linalg.norm(x), n.linalg.norm(x, p=1,
                                                               axis=1),
                               n.linalg.norm(x, p=float("inf"), axis=0)),
                 [X], [0]),
    "cholesky": case(lambda n, a: n.linalg.cholesky(a, upper=True),
                     [arr("spd", (4, 4))], [0]),
    "inverse": case(lambda n, a: n.linalg.inverse(a), [arr("spd", (4, 4))],
                    [0]),
    "pinv": case(lambda n, a: n.linalg.pinv(a), [X], [0]),
    "det": case(lambda n, a: n.linalg.det(a), [arr("spd", (3, 3)) / 3], [0]),
    "slogdet": case(lambda n, a: n.linalg.slogdet(a), [arr("spd", (4, 4))],
                    [0]),
    "matrix_power": case(lambda n, a: n.linalg.matrix_power(a, 3),
                         [arr("spd", (3, 3)) / 4], [0]),
    "matrix_rank": case(lambda n, a: n.linalg.matrix_rank(a),
                        [X @ np.diag([1, 1, 1, 0]).astype("f4")]),
    "svd": case(lambda n, a: abs_all(n, n.linalg.svd(a)), [X], [0]),
    "qr": case(lambda n, a: abs_all(n, n.linalg.qr(a)), [arr("x", (4, 3))],
               [0]),
    "eigh": case(lambda n, a: abs_all(n, n.linalg.eigh(a)),
                 [arr("spd", (4, 4))], [0]),
    "eigvalsh": case(lambda n, a: n.linalg.eigvalsh(a), [arr("spd", (4, 4))],
                     [0]),
    "solve": case(lambda n, a, b: n.linalg.solve(a, b),
                  [arr("spd", (4, 4)), arr("x", (4, 2))], [0, 1]),
    "triangular_solve": case(
        lambda n, a, b: (n.linalg.triangular_solve(a, b, upper=False),
                         n.linalg.triangular_solve(a, b, upper=False,
                                                   transpose=True)),
        [arr("lower", (4, 4)), arr("x", (4, 2))], [0, 1]),
    "cholesky_solve": case(
        lambda n, b, lo: n.linalg.cholesky_solve(b, lo),
        [arr("x", (4, 2)), np.linalg.cholesky(arr("spd", (4, 4)))
         .astype("f4")], [0, 1]),
    "lstsq": case(lambda n, a, b: n.linalg.lstsq(a, b),
                  [arr("x", (5, 3)), arr("x", (5, 2))], [0, 1]),
    "cross": case(lambda n, a, b: n.linalg.cross(a, b),
                  [arr("x", (2, 3)), arr("x", (2, 3), seed=1)], [0, 1]),
    "histogram": case(lambda n, x: n.linalg.histogram(x, bins=5, min=-1,
                                                      max=1), [X]),
    # sequence ops ([B, T, ...] padded, [B] lengths)
    **{f"sequence_pool_{p}": case(
        lambda n, x, lens, p=p: n.seq.sequence_pool(x, lens, pool_type=p),
        [SEQ, LENS], [0], op="sequence_pool")
       for p in ("sum", "average", "sqrt", "max", "first", "last")},
    "sequence_reverse": case(lambda n, x, lens: n.seq.sequence_reverse(
        x, lens), [SEQ, LENS], [0]),
    "sequence_softmax": case(lambda n, x, lens: n.seq.sequence_softmax(
        x, lens), [SEQ2, LENS], [0]),
    "sequence_expand": case(lambda n, x: n.seq.sequence_expand(
        x, repeats=(2, 0, 1)), [X], [0]),
    "sequence_first_step": case(
        lambda n, x: n.seq.sequence_first_step(x), [SEQ], [0]),
    "sequence_last_step": case(
        lambda n, x, lens: n.seq.sequence_last_step(x, lens), [SEQ, LENS],
        [0]),
    "sequence_conv": case(
        lambda n, x, lens, w: n.seq.sequence_conv(x, lens, w,
                                                  context_length=3),
        [SEQ, LENS, arr("x", (9, 2))], [0, 2]),
    "sequence_slice": case(
        lambda n, x, lens, o, ln: n.seq.sequence_slice(x, lens, o, ln),
        [SEQ, LENS, I(1, 0), I(3, 2)], [0]),
    "sequence_concat": case(
        lambda n, a, la, b, lb: n.seq.sequence_concat(a, la, b, lb),
        [SEQ, LENS, arr("x", (2, 4, 3), seed=3), I(2, 4)], [0, 2]),
    "sequence_erase": case(
        lambda n, x, lens: n.seq.sequence_erase(x, lens, tokens=(2, 3)),
        [IDS, LENS]),
    "sequence_enumerate": case(
        lambda n, x, lens: n.seq.sequence_enumerate(x, lens, win_size=3,
                                                    pad_value=-1),
        [IDS, LENS]),
    "sequence_topk_avg_pooling": case(
        lambda n, x, lens: n.seq.sequence_topk_avg_pooling(x, lens,
                                                           topks=(1, 3)),
        [SEQ2, LENS], [0]),
    "sequence_pad": case(
        lambda n, x, lens: n.seq.sequence_pad_op(x, lens, 0.5, maxlen=7),
        [SEQ, LENS], [0]),
    "sequence_unpad": case(
        lambda n, x, lens: n.seq.sequence_unpad_op(x, lens), [SEQ, LENS],
        [0]),
    "sequence_reshape": case(
        lambda n, x, lens: n.seq.sequence_reshape(x, lens, new_dim=1),
        [SEQ, LENS], [0]),
    "sequence_scatter": case(
        lambda n, x, i, u, lens: n.seq.sequence_scatter(x, i, u, lens),
        [arr("x", (2, 6)), np.array([[0, 2, 5], [1, 1, 3]], "int32"),
         arr("x", (2, 3), seed=2), I(3, 2)]),
    "sequence_expand_as": case(
        lambda n, x, lens: n.seq.sequence_expand_as(x, lens, maxlen=6),
        [arr("x", (2, 3)), LENS], [0]),
    # the registered attention op: K1-K3's route (`plain` on the CPU,
    # JAX's Pallas kernels in interpret mode)
    "flash_attention": case(
        lambda n, q, k, v: n.flash.flash_attention(q, k, v, causal=True,
                                                   layout="bshd"),
        [arr("x", (1, 128, 2, 64), s) for s in (0, 1, 2)], [0, 1, 2]),
}


def op_name(case_name):
    """The registered op a case exercises."""
    return CASES[case_name].get("op", case_name)


# ---------------------------------------------------------------- runner

def cotangent(name, i, shape):
    """The fixed random weights of output i in a case's loss."""
    r = np.random.RandomState(zlib.crc32(f"{name}/{i}".encode()))
    return r.uniform(-1, 1, shape).astype("f4")


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def host(t):
    a = np.asarray(t.numpy())
    return a.astype("f4") if a.dtype.name == "bfloat16" else a


def inputs(n, name):
    """The case's input Tensors on the current place (the differentiated
    ones with stop_gradient=False)."""
    c = CASES[name]
    return [n.P.to_tensor(a, stop_gradient=i not in c["diff"])
            for i, a in enumerate(c["inputs"])]


def call(n, name, ts):
    """The case's op(s) on input Tensors `ts`: a tuple of output Tensors."""
    out = CASES[name]["fn"](n, *ts)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def grads(n, name, ts, outs):
    """Backward from the sum of each float output times its `cotangent`
    (real and imaginary parts weighted apart for a complex one): the
    differentiated inputs' `.grad` Tensors (or None)."""
    loss = None
    for i, o in enumerate(outs):
        kind = dtype_name(o)
        if o.stop_gradient or not ("float" in kind or "complex" in kind):
            continue
        w = n.P.to_tensor(cotangent(name, i, o.shape))
        if "complex" in kind:
            term = (n.math.real(o) * w).sum() + \
                (n.math.imag(o) * w * 0.5).sum()
        else:
            term = (n.manip.cast(o, "float32") * w).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [ts[i].grad for i in CASES[name]["diff"]]


def run(n, name):
    """Case `name` through namespace `n` on its package's current place:
    ([(dtype name, numpy value)] of the outputs, [numpy gradient or None]
    of the differentiated inputs, or None when there are none)."""
    ts = inputs(n, name)
    outs = call(n, name, ts)
    fwd = [(dtype_name(o), host(o)) for o in outs]
    if not CASES[name]["diff"]:
        return fwd, None
    return fwd, [None if g is None else host(g)
                 for g in grads(n, name, ts, outs)]
