"""PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays in the repository as the reference;
this package is its counterpart for NVIDIA Hopper cards. It mirrors the
JAX package's layout (`nn/paged_attention.py`, `nlp/gpt.py`,
`serving/...`, `inference/`) and imports neither `jax` nor anything
under `paddle_tpu`. Kernels the JAX package wrote in Pallas are CUDA C++
sources under `csrc/`, built with nvcc at first use.

Serving: `inference.Config().enable_llm_engine(...)` ->
`inference.create_llm_predictor` -> `serving.Scheduler` over the dense
`serving.ServingEngine` (the default: `nlp.GPTForPretraining.prefill`
on flash-attention kernel K1, dense `decode_step`) or
`serving.PagedServingEngine` (`paged=True`: `decode_step` /
`prefill_chunk` -> `nn.paged_attention`, kernel K4). Training:
`jit.TrainStep` over `nlp.GPTForPretraining` and the optimizers, on
K1-K3 and the fused Adam kernel.

Eager (Paddle's dygraph surface, `paddle_tpu/__init__.py`): `to_tensor`,
`Tensor` and `Parameter` (`framework/`), the op library (`ops/`:
creation, math, manipulation, logic, linalg, sequence) and autograd on
torch autograd (`Tensor.backward`, `grad`, `autograd.PyLayer`); tensors
live on the CUDA card unless `set_device("cpu")` was called. The
registered `flash_attention` op (`ops.flash_attention`) runs K1 forward
and K2, K3 and dd in `loss.backward()`, and the optimizers take
`Parameter`s. `nn` holds `Layer` (a `torch.nn.Module` under Paddle's
names), `nn.functional` and the layers. `hapi.Model` fits a Layer
through `jit.TrainStep` on batches of `io.DataLoader` (forked
shared-memory workers with `num_workers`), with `metric`'s metrics and
`vision`'s models, transforms and datasets. `nn`'s recurrent layers
(`nn.rnn`: SimpleRNN, LSTM, GRU, their cells, RNN and BiRNN) run each
(layer, direction) pass as one sequence op, in torch's cuDNN RNN or a
plain loop over time; `text` holds the text datasets and Viterbi
decoding, `distribution` the probability distributions. `vision.ops`
holds the detection ops (box geometry, NMS, the YOLOv3 loss and decode,
the RoI family, the host-side target assigners), `quantization` QAT,
PTQ and int8 conversion, and `rec` the Wide&Deep and DeepFM models.
`distributed` runs ranks as processes over `torch.distributed`: the
launcher, meshes, the collectives, `DataParallel`, `ShardedTrainStep`
(data and sequence parallel, ZeRO-1), ring and Ulysses attention and
`fleet`.
`incubate` holds recompute (`incubate.recompute`), the epoch-range
auto-checkpoint (`incubate.checkpoint`), the segment reductions and
the MoE layer (`incubate.moe`, which `GPTConfig(moe_experts=)`
puts in every block); `utils.cpp_extension` registers custom ops
and builds C++ host kernels.
Importing the package builds and launches nothing.
"""
__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
from .framework import (  # noqa: F401
    Tensor, Parameter, to_tensor, create_parameter,
    float16, bfloat16, float32, float64, int8, int16, int32, int64, uint8,
    bool_, complex64, complex128,
    CPUPlace, TPUPlace, CUDAPlace, XPUPlace,
    set_device, get_device, get_place, seed, set_flags, get_flags, no_grad,
    set_default_dtype, get_default_dtype, is_grad_enabled,
)
from . import framework  # noqa: F401
from .framework import errors  # noqa: F401  (paddle.errors taxonomy)
from . import ops  # noqa: F401
from .ops.creation import (  # noqa: F401
    zeros, ones, full, empty, zeros_like, ones_like, full_like, empty_like,
    arange, linspace, logspace, eye, diag, diagflat, tril, triu, meshgrid,
    assign, clone, rand, randn, normal, uniform, randint, randperm, bernoulli,
    multinomial, standard_normal,
)
from .ops.math import (  # noqa: F401
    add, subtract, multiply, divide, floor_divide, remainder, mod, pow,
    maximum, minimum, fmax, fmin, abs, neg, exp, expm1, log, log2, log10,
    log1p, sqrt, rsqrt, square, reciprocal, sin, cos, tan, asin, acos, atan,
    sinh, cosh, tanh, asinh, acosh, atanh, erf, floor, ceil, round, trunc,
    sign, clip, isnan, isinf, isfinite, nan_to_num, sum, mean, prod, max, min,
    amax, amin, logsumexp, std, var, median, argmax, argmin, cumsum, cumprod,
    count_nonzero, matmul, mm, dot, bmm, inner, outer, addmm, kron, trace,
    diagonal, topk, sort, argsort, unique, kthvalue, mode, scale, increment,
    multiplex, atan2, sigmoid, lgamma, digamma, erfinv,
    lerp, heaviside, logit, logaddexp, xlogy, sinc, exp2, rad2deg, deg2rad,
    copysign, nextafter, gcd, lcm, diff, trapezoid, cummax, cummin,
    logcumsumexp, searchsorted, bucketize, renorm, quantile, nanquantile,
    dist, angle, conj, real, imag, complex, polar, sgn, signbit, ldexp,
    hypot, frac, nansum, nanmean, add_n, mv, numel, broadcast_shape,
)
from .ops.linalg import (  # noqa: F401  (also under paddle.linalg)
    cholesky, cross, inverse, norm, histogram, bincount,
)
from .ops.manipulation import (  # noqa: F401
    cast, reshape, reshape_, flatten, transpose, moveaxis, swapaxes, t, concat,
    stack, unstack, split, chunk, unbind, squeeze, unsqueeze, expand,
    broadcast_to, expand_as, tile, repeat_interleave, flip, roll, rot90,
    slice, strided_slice, gather, gather_nd, scatter, scatter_nd,
    scatter_nd_add, index_select, index_sample, where, nonzero, masked_select,
    masked_fill, take_along_axis, put_along_axis, shard_index, one_hot,
    tensordot, as_complex, as_real, crop,
    take, index_add, index_put, masked_scatter, unflatten,
)
from .ops.logic import (  # noqa: F401
    equal, not_equal, greater_than, greater_equal, less_than, less_equal,
    logical_and, logical_or, logical_xor, logical_not, bitwise_and, bitwise_or,
    bitwise_xor, bitwise_not, all, any, isclose, allclose, equal_all,
    is_empty, is_tensor,
)
from .ops import linalg  # noqa: F401
from . import autograd  # noqa: F401
from . import tensor  # noqa: F401
from .autograd import grad  # noqa: F401
from .framework.serialization import save, load  # noqa: F401
from . import nn  # noqa: F401,E402
# the registry holds every op once the package is imported: nlp.llama
# registers llama_attention and rms_norm
from . import nlp  # noqa: F401,E402
from . import optimizer, jit, amp  # noqa: F401,E402
from . import io, metric, reader, dataset, vision, hapi  # noqa: F401,E402
# text registers viterbi_decode
from . import text, distribution  # noqa: F401,E402
# vision.ops registers the detection ops, quantization
# fake_quantize_dequantize
from . import quantization, rec  # noqa: F401,E402
from .hapi import Model, summary  # noqa: F401,E402
# incubate (recompute, auto-checkpoint, the segment ops; MoE on first
# use), the py2/3 helpers and the package's directories
from . import incubate, compat, sysconfig, utils  # noqa: F401,E402
# the collective half of paddle.distributed (ranks over torch.distributed)
from . import distributed  # noqa: F401,E402


def _inplace(x, out):
    """x takes out's value and graph (the Tensor-method in-place ops)."""
    x._data = out._data
    return x


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite=overwrite))


def squeeze_(x, axis=None, name=None):
    return _inplace(x, squeeze(x, axis=axis))


def unsqueeze_(x, axis, name=None):
    return _inplace(x, unsqueeze(x, axis))


def tanh_(x, name=None):
    return _inplace(x, tanh(x))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    """ref tensor/random.py gaussian."""
    return normal(mean=mean, std=std, shape=shape)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """ref tensor/to_string.py set_printoptions: Tensor.__repr__ prints
    through numpy, so numpy's printoptions are the framework's."""
    import numpy as _np
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def to_string(x, prefix="Tensor"):
    import numpy as _np
    a = x.numpy() if hasattr(x, "numpy") else _np.asarray(x)
    return (f"{prefix}(shape={list(a.shape)}, dtype={a.dtype}, "
            f"stop_gradient={getattr(x, 'stop_gradient', True)},\n"
            f"       {_np.array2string(a, prefix='       ')})")


def in_dynamic_mode():
    """Always true: the port runs eagerly (the static graph is ROADMAP
    Queue 1 item 7)."""
    return True


in_dygraph_mode = in_dynamic_mode


def disable_static(place=None):
    return None
