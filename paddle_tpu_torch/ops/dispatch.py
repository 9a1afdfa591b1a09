"""Eager op dispatch (the port of `paddle_tpu/ops/dispatch.py`).

An op's raw form is a function on torch tensors. `apply` unwraps the
Tensor inputs, casts them by the AMP lists when auto_cast is on, calls
the raw form and wraps its outputs; torch autograd records the graph, so
an output's `stop_gradient` is `not (grad enabled and an input requires
grad)`. An op registered as non-differentiable runs under
`torch.no_grad()`. Outputs follow the dtype rule of `framework/dtype.py`:
an int64, float64 or complex128 result of a torch op is narrowed to
int32, float32 or complex64, as the JAX package's ops never return a
64-bit type.

Every op runs where its inputs are: there is no host fallback (the JAX
package moves complex ops to the host because the TPU cannot run them;
the card can) and no op moves data to the host quietly. Ops with
data-dependent output shapes (`nonzero`, `masked_select`, `unique`, ...)
synchronise with the host to size their outputs.

The static recorder of the JAX package's dispatcher is not ported
(ROADMAP Queue 1 item 7).
"""
import functools

import numpy as np
import torch

from ..framework import state
from ..framework.dtype import NARROW
from ..framework.tensor import Tensor, to_torch

# op-name -> raw torch form
OP_REGISTRY = {}


def register_op(name, fn):
    """Make `fn` the canonical raw form of op `name`."""
    OP_REGISTRY[name] = fn
    return fn


def axis_attr(axis):
    """Normalize an axis argument to its JSON-able attr form (list or
    int); raw forms convert back with axis_arg."""
    if isinstance(axis, (list, tuple)):
        return [int(a) for a in axis]
    return None if axis is None else int(axis)


def axis_arg(axis):
    """Inverse of axis_attr inside raw forms: a list -> a tuple."""
    return tuple(axis) if isinstance(axis, list) else axis


# AMP op lists (ref python/paddle/fluid/contrib/mixed_precision/fp16_lists.py):
# white = compute-bound ops run in low precision; black = numerically
# sensitive ops kept f32. Everything else follows its inputs.
AMP_WHITE_LIST = {
    "matmul", "mm", "bmm", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "addmm", "flash_attention",
}
AMP_BLACK_LIST = {
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "exp", "log",
    "log2", "log10", "log1p", "mean", "sum", "logsumexp", "layer_norm",
    "batch_norm", "group_norm", "instance_norm", "norm", "cumsum", "prod",
    "sigmoid_focal_loss", "bce_with_logits", "binary_cross_entropy", "erf",
    "erfinv", "pow", "square", "std", "var", "kl_div",
}


def _amp_cast(arrays, name, amp):
    low = amp["dtype"]
    if name in AMP_WHITE_LIST:
        return tuple(a.to(low) if isinstance(a, torch.Tensor)
                     and a.dtype == torch.float32 else a for a in arrays)
    if name in AMP_BLACK_LIST:
        return tuple(a.float() if isinstance(a, torch.Tensor)
                     and a.dtype == low else a for a in arrays)
    # gray ops: follow inputs (no cast)
    return arrays


def as_array(x):
    if isinstance(x, Tensor):
        return x._data
    return x


def _check_nan_inf(name, outs):
    """Per-op non-finite scan (ref platform/flags.cc:44
    FLAGS_check_nan_inf): reads one flag per output back to the host."""
    for i, o in enumerate(outs):
        if (o.is_floating_point() or o.is_complex()) and \
                not bool(torch.isfinite(o).all()):
            from ..framework.errors import PreconditionNotMetError
            raise PreconditionNotMetError(
                f"Operator {name} output {i} contains NaN/Inf "
                f"(FLAGS_check_nan_inf is on)")


def _input(x, device):
    """A raw form's argument: a Tensor's torch tensor; numpy arrays and
    lists become torch tensors on `device`; scalars stay scalars."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (np.ndarray, list, np.generic)):
        return to_torch(x, place=device)
    return x


def _output(o, inputs):
    """A raw form's output as the op's: 64-bit types narrowed, and never
    the very object of an input (a wrapper must own its tensor)."""
    n = NARROW.get(o.dtype)
    if n is not None:
        return o.to(n)
    for a in inputs:
        if o is a:
            return o.view_as(o)
    return o


def apply(fn, tensors, attrs=None, name=None, differentiable=True):
    """Run op `fn(*arrays, **attrs)` on tensor inputs; torch autograd
    records it when an input requires grad."""
    if name is None:
        name = getattr(fn, "__name__", "op")
    dev = None
    for t in tensors:
        if isinstance(t, Tensor):
            dev = t._data.device
            break
    arrays = tuple([_input(t, dev) for t in tensors])
    amp = state.get_amp_state()
    if amp is not None:
        arrays = _amp_cast(arrays, name, amp)
    kw = attrs or {}
    try:
        if not differentiable and torch.is_grad_enabled():
            with torch.no_grad():
                outs = fn(*arrays, **kw)
        else:
            outs = fn(*arrays, **kw)
    except Exception as e:
        # attach the op name/inputs/attrs IN PLACE (type preserved): the
        # eager analog of ref framework/op_call_stack.cc
        if not getattr(e, "_pt_op_ctx", False):
            from ..framework.errors import attach_op_context
            attach_op_context(e, name, arrays, attrs)
            e._pt_op_ctx = True
        raise
    if isinstance(outs, (tuple, list)):
        outs = tuple(_output(o, arrays) for o in outs)
        if state.get_flag("FLAGS_check_nan_inf"):
            _check_nan_inf(name, outs)
        return tuple(Tensor._wrap(o) for o in outs)
    outs = _output(outs, arrays)
    if state.get_flag("FLAGS_check_nan_inf"):
        _check_nan_inf(name, (outs,))
    return Tensor._wrap(outs)


def def_op(name=None, differentiable=True, n_tensor_args=None):
    """Register + wrap a raw torch form as an eager op.

    The wrapped function accepts Tensors/arrays for its first `n_tensor_args`
    positional args (default: all positional) and keyword attrs after that.
    """

    def deco(fn):
        opname = name or fn.__name__
        OP_REGISTRY[opname] = fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if n_tensor_args is None:
                tensors = args
                attrs = kwargs
            else:
                tensors = args[:n_tensor_args]
                attrs = dict(kwargs)
                if len(args) > n_tensor_args:
                    raise TypeError(
                        f"{opname}: pass attrs as keywords (got extra "
                        f"positionals)")
            return apply(fn, tensors, attrs, name=opname,
                         differentiable=differentiable)

        wrapper.raw = fn
        return wrapper

    return deco
