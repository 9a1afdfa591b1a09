"""Dtype taxonomy (the port of `paddle_tpu/framework/dtype.py`).

The canonical dtype objects are torch dtypes. The visible rule is the JAX
package's with x64 off (JAX's default): a request for int64, float64 or
complex128 gives int32, float32 or complex64, and no op of the port
returns a 64-bit type. So `to_tensor([1, 2])`, `arange(4)` and `argmax`
give int32, as they do in the JAX package; ops whose torch form needs
int64 indices cast inside the op.
"""
import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGER = {int8, int16, int32, int64, uint8}
#: the x64-off rule: what a 64-bit request becomes
NARROW = {float64: float32, int64: int32, complex128: complex64}


def _lookup(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _STR2DTYPE[dtype]
        except KeyError:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
    name = np.dtype(dtype).name          # numpy dtypes and scalar types
    try:
        return _STR2DTYPE[name]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype!r}")


def convert_dtype(dtype):
    """Normalise a dtype spec (str / torch.dtype / numpy dtype) to a torch
    dtype, with int64/float64/complex128 mapped to their 32-bit
    counterparts (the JAX package's x64-off rule)."""
    if dtype is None:
        return None
    d = _lookup(dtype)
    return NARROW.get(d, d)


def dtype_name(dtype):
    """'float32', 'bfloat16', 'bool', ... (numpy's names)."""
    return str(_lookup(dtype)).replace("torch.", "")


def is_floating_point(dtype):
    return _lookup(dtype) in _FLOATING


def is_integer(dtype):
    return _lookup(dtype) in _INTEGER


def default_dtype():
    from . import state
    return state.get_default_dtype()
