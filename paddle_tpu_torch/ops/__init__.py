"""The port's op library (`paddle_tpu/ops`): creation, math, manipulation,
logic, linalg and sequence ops and the fluid-era tail (`legacy`) behind
the eager dispatcher, and the
operators that hold a kernel — flash attention (K1-K3, registered as the
`flash_attention` op) and the chunked LM head (`chunked_ce`).

Importing it wires the op functions onto `Tensor` as methods and dunders
(ref pybind/op_function_generator.cc:488, the reference's generated
`core.ops` methods); nothing is built or launched at import.
"""
from . import creation, math, manipulation, logic, linalg, sequence, legacy
from . import flash_attention
from .dispatch import OP_REGISTRY, apply, def_op, as_array
from ..framework.tensor import Tensor

__all__ = ["flash_attention", "OP_REGISTRY", "apply", "def_op", "as_array"]


def _attach_methods():
    # arithmetic dunders
    Tensor.__add__ = lambda s, o: math.add(s, o)
    Tensor.__radd__ = lambda s, o: math.add(o, s)
    Tensor.__sub__ = lambda s, o: math.subtract(s, o)
    Tensor.__rsub__ = lambda s, o: math.subtract(o, s)
    Tensor.__mul__ = lambda s, o: math.multiply(s, o)
    Tensor.__rmul__ = lambda s, o: math.multiply(o, s)
    Tensor.__truediv__ = lambda s, o: math.divide(s, o)
    Tensor.__rtruediv__ = lambda s, o: math.divide(o, s)
    Tensor.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    Tensor.__mod__ = lambda s, o: math.mod(s, o)
    Tensor.__pow__ = lambda s, o: math.pow(s, o)
    Tensor.__rpow__ = lambda s, o: math.pow(o, s)
    Tensor.__neg__ = lambda s: math.neg(s)
    Tensor.__abs__ = lambda s: math.abs(s)
    Tensor.__matmul__ = lambda s, o: math.matmul(s, o)
    Tensor.__rmatmul__ = lambda s, o: math.matmul(o, s)
    # comparisons (note: __eq__ returns a Tensor, like paddle/torch)
    Tensor.__eq__ = lambda s, o: logic.equal(s, o)
    Tensor.__ne__ = lambda s, o: logic.not_equal(s, o)
    Tensor.__lt__ = lambda s, o: logic.less_than(s, o)
    Tensor.__le__ = lambda s, o: logic.less_equal(s, o)
    Tensor.__gt__ = lambda s, o: logic.greater_than(s, o)
    Tensor.__ge__ = lambda s, o: logic.greater_equal(s, o)
    Tensor.__invert__ = lambda s: logic.logical_not(s)
    Tensor.__and__ = lambda s, o: logic.bitwise_and(s, o)
    Tensor.__or__ = lambda s, o: logic.bitwise_or(s, o)
    Tensor.__xor__ = lambda s, o: logic.bitwise_xor(s, o)

    # named methods from the op modules (paddle Tensor method surface)
    for mod in (math, manipulation, logic, creation):
        for name in dir(mod):
            if name.startswith("_"):
                continue
            fn = getattr(mod, name)
            if not callable(fn) or isinstance(fn, type) or \
                    getattr(fn, "__module__", None) != mod.__name__:
                continue
            if not hasattr(Tensor, name):
                setattr(Tensor, name, fn)

    # in-demand aliases
    Tensor.mm = math.matmul
    Tensor.matmul = math.matmul
    Tensor.pow = math.pow
    Tensor.abs = math.abs
    Tensor.sum = math.sum
    Tensor.mean = math.mean
    Tensor.max = math.max
    Tensor.min = math.min
    Tensor.reshape = manipulation.reshape
    Tensor.transpose = manipulation.transpose
    Tensor.flatten = manipulation.flatten
    Tensor.squeeze = manipulation.squeeze
    Tensor.unsqueeze = manipulation.unsqueeze
    Tensor.cast = manipulation.cast
    Tensor.astype = manipulation.cast
    Tensor.split = manipulation.split
    Tensor.chunk = manipulation.chunk
    Tensor.expand = manipulation.expand
    Tensor.tile = manipulation.tile
    Tensor.gather = manipulation.gather
    Tensor.argmax = math.argmax
    Tensor.argmin = math.argmin
    Tensor.clip = math.clip
    Tensor.norm = linalg.norm


_attach_methods()
