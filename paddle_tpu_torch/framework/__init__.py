"""The port's framework core: dtypes, places and process state, the eager
`Tensor` on torch autograd, backward, errors and serialization (the port
of `paddle_tpu/framework/`)."""
from .dtype import (float16, bfloat16, float32, float64, int8, int16, int32,
                    int64, uint8, bool_, complex64, complex128, convert_dtype,
                    dtype_name, is_floating_point, is_integer)
from .state import (Place, CPUPlace, CUDAPlace, TPUPlace, XPUPlace,
                    set_device, get_device, get_place, seed,
                    default_generator, rng_generator, set_flags, get_flags,
                    get_flag, no_grad, no_grad_ctx, enable_grad_ctx,
                    is_grad_enabled, set_default_dtype, get_default_dtype)
from .tensor import Tensor, Parameter, to_tensor
from . import state, tape
from . import errors
from .errors import enforce, enforce_eq, enforce_shape


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a fresh trainable Parameter on the current
    place from `default_initializer` (or `attr.initializer`), called as
    `init(shape, dtype)`; by default zeros when `is_bias`, else
    Xavier-normal (`nn.initializer`)."""
    from ..nn import initializer as I
    init = default_initializer
    if init is None and attr is not None:
        init = getattr(attr, "initializer", None)
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    shape = tuple(int(s) for s in shape)
    p = Parameter(init(shape, dtype), dtype=dtype,
                  name=name or (getattr(attr, "name", None) if attr else None))
    if attr is not None and getattr(attr, "regularizer", None) is not None:
        p.regularizer = attr.regularizer
    return p
