"""paddle_tpu_torch.Tensor — the eager tensor (the port of
`paddle_tpu/framework/tensor.py`), a thin wrapper holding `_data`, a
`torch.Tensor`, as the JAX package's holds a `jax.Array`.

It is not a `torch.Tensor` subclass: Paddle's `shape` (a list),
`transpose(perm)`, `sum(axis=)` and `astype` clash with torch's own
methods. Torch autograd is the tape: an op's output is a non-leaf torch
tensor with a `grad_fn`, and the Paddle attributes map onto torch's:

  - `stop_gradient=False` on a leaf is `_data.requires_grad_(True)`; set
    True on a non-leaf, it cuts the lineage by rebinding `_data` to
    `_data.detach()` (torch cannot clear `requires_grad` on a non-leaf).
    Integer and bool tensors cannot require grad in torch; their
    `stop_gradient=False` is recorded and changes nothing, as in the JAX
    package, whose integer cotangents are dropped.
  - `.grad` reads and writes `_data.grad`, so torch's accumulation across
    `backward()` calls is Paddle's, and `clear_grad` sets it to None.
  - `Parameter._data` is a `torch.nn.Parameter`.

In-place methods (`set_value`, `copy_`, `fill_`, `zero_`, `scale_`,
`add_`, `__setitem__`) keep the JAX package's value semantics, where they
rebind `_data` and record nothing: on a trainable leaf (a Parameter, or
a tensor with stop_gradient=False) they write into the same storage under
`torch.no_grad()`, so an optimizer or a layer holding it sees the new
value; on any other leaf they rebind `_data` to a new tensor, so views
and detached copies that share its storage keep their values; on a
non-leaf they rebind `_data` to the new value with the old one's graph:
the gradient flows as if the write had not happened, as in the JAX
package.

Arithmetic dunders and the op methods are attached by `paddle_tpu_torch.ops`
at import. `place` is the tensor's real device; `cuda()` and `cpu()` move
it. `numpy()` of a bfloat16 tensor returns float32 (the card's machine
has no `ml_dtypes`; the JAX package returns an `ml_dtypes.bfloat16`
array).
"""
import numpy as np
import torch

from . import state
from .dtype import NARROW, convert_dtype, dtype_name


def _narrowed(dt):
    """The dtype a host value of torch dtype `dt` takes when no dtype is
    asked for: float64 -> the default dtype, int64 -> int32, complex128
    -> complex64 (the JAX package's rule)."""
    if dt == torch.float64:
        return state.get_default_dtype()
    return NARROW.get(dt, dt)


def _device_of(place):
    if place is None:
        return None
    if isinstance(place, state.Place):
        return place.torch_device()
    if isinstance(place, torch.device):
        return place
    return state.parse_place(place).torch_device()


def to_torch(data, dtype=None, place=None):
    """A torch tensor (no graph) of `data`: a Tensor, a torch tensor, a
    numpy array, a list or a scalar. Host data lands on `place` (default:
    the current place); a tensor stays on its device unless `place` is
    given. With no `dtype`, float64 data takes the default dtype and
    int64/complex128 their 32-bit counterparts."""
    if isinstance(data, Tensor):
        data = data._data
    dev = _device_of(place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
        dt = dt or _narrowed(t.dtype)
        if (dev is not None and t.device != dev) or t.dtype != dt:
            t = t.to(device=dev, dtype=dt)
        return t
    arr = np.array(data)
    if arr.dtype == object:
        raise TypeError(f"cannot make a tensor of {type(data).__name__} "
                        f"(object array)")
    if arr.dtype.name == "bfloat16":        # an ml_dtypes array
        arr, dt = arr.astype(np.float32), dt or torch.bfloat16
    host = torch.from_numpy(arr)
    dt = dt or _narrowed(host.dtype)
    return host.to(device=dev or state.current_device(), dtype=dt)


class _KeepGrad(torch.autograd.Function):
    """Forward: the new value; backward: the gradient passes to the old
    value unchanged (an in-place write on a non-leaf)."""

    @staticmethod
    def forward(ctx, old, new):
        return new.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class Tensor:
    __slots__ = ("_data", "__dict__", "__weakref__")
    name = None
    persistable = False
    trainable = False

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None):
        self._data = to_torch(data, dtype, place)
        if name is not None:
            self.name = name
        self.trainable = not stop_gradient
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, data):
        """A Tensor over the torch tensor `data` as it is (the
        dispatcher's outputs)."""
        t = object.__new__(cls)
        t._data = data
        return t

    # ------------------------------------------------------------- autograd state
    @property
    def stop_gradient(self):
        if self._data.requires_grad:
            return False
        return self.__dict__.get("_nondiff_sg", True)

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        if value:
            self.__dict__.pop("_nondiff_sg", None)
            if d.requires_grad:
                if d.grad_fn is None:
                    d.requires_grad_(False)
                else:
                    self._data = d.detach()
        elif d.is_floating_point() or d.is_complex():
            if not d.requires_grad:
                d.requires_grad_(True)
        else:
            self._nondiff_sg = False

    @property
    def grad(self):
        """The gradient as a Tensor, or a `SelectedRows` when it is
        row-sparse (a table read by `F.embedding(sparse=True)`)."""
        d = self._data
        if d.grad_fn is not None or d.grad is None:
            return None
        if d.grad.is_sparse:
            from .selected_rows import SelectedRows
            return SelectedRows.from_sparse(d.grad)
        return Tensor._wrap(d.grad)

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else to_torch(value)

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    # ------------------------------------------------------------- properties
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self):
        return state.place_of(self._data.device)

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.transpose(self, list(range(self.ndim))[::-1])

    def dim(self):
        return self._data.dim()

    def rank(self):
        return self._data.dim()

    def numel(self):
        return self.size

    # ------------------------------------------------------------- conversion
    def numpy(self):
        """A host numpy array of the value (float32 for bfloat16); for a
        tensor on the CPU, a read-only view of its storage, as the JAX
        package's `np.asarray` of an array is read-only."""
        d = self._data.detach().resolve_conj().resolve_neg()
        if d.dtype == torch.bfloat16:
            d = d.float()
        a = d.cpu().numpy()
        if d.device.type == "cpu":
            a = a.view()
            a.flags.writeable = False
        return a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        from ..ops import manipulation
        return manipulation.cast(self, dtype)

    cast = astype

    def to(self, *args, **kwargs):
        """Moves (a Place, 'cpu', 'gpu[:N]', a torch.device) and casts (a
        dtype), in any order; keeps the graph."""
        out = self
        for a in list(args) + [kwargs.get("device"), kwargs.get("dtype")]:
            if a is None:
                continue
            if isinstance(a, (state.Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0] in (
                        "cpu", "gpu", "cuda", "tpu", "xpu")):
                dev = _device_of(a)
                if dev != out._data.device:
                    out = Tensor._wrap(out._data.to(dev))
            else:
                out = out.astype(a)
        return out

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=None, blocking=True):
        return self.to(state.CUDAPlace(0 if device_id is None
                                       else int(device_id)))

    def pin_memory(self):
        return self

    # ------------------------------------------------------------- autograd
    def backward(self, grad_tensor=None, retain_graph=False):
        from . import tape
        tape.backward(self, grad_tensor=grad_tensor,
                      retain_graph=retain_graph)

    def detach(self):
        t = Tensor._wrap(self._data.detach())
        if self.name is not None:
            t.name = self.name
        return t

    def detach_(self):
        self.stop_gradient = True
        return self

    def clone(self):
        from ..ops import creation
        return creation.assign(self)

    def clear_grad(self):
        self._data.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """`hook(grad)` runs when the gradient of this tensor is computed;
        a Tensor it returns replaces the gradient. Returns a handle with
        `remove()` (torch's `register_hook`)."""
        def run(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else to_torch(out)
        return self._data.register_hook(run)

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    # ------------------------------------------------------------- in place
    def _assign(self, new):
        """Make `new` (a torch tensor of this shape and dtype, no graph)
        the value: see the module docstring for the three cases."""
        d = self._data
        if d.grad_fn is not None:
            self._data = _KeepGrad.apply(d, new)
        elif isinstance(d, torch.nn.Parameter) or d.requires_grad:
            with torch.no_grad():
                d.copy_(new)
        else:
            self._data = new
        return self

    def set_value(self, value):
        """In-place value replacement (optimizer updates, state loading)."""
        d = self._data
        value = to_torch(value, d.dtype, state.place_of(d.device))
        if tuple(value.shape) != tuple(d.shape):
            raise ValueError(f"set_value shape mismatch: "
                             f"{tuple(value.shape)} vs {tuple(d.shape)}")
        return self._assign(value)

    def copy_(self, other):
        return self.set_value(other)

    def fill_(self, v):
        return self._assign(torch.full_like(self._data.detach(), v))

    def zero_(self):
        return self.fill_(0)

    def scale_(self, v):
        return self._assign(self._data.detach() * v)

    def add_(self, other):
        d = self._data.detach()
        o = other._data.detach() if isinstance(other, Tensor) else other
        if isinstance(o, torch.Tensor):
            o = o.to(d.dtype)
        return self._assign((d + o).to(d.dtype))

    # ------------------------------------------------------------- indexing
    def __getitem__(self, idx):
        from ..ops import manipulation
        return manipulation.getitem(self, idx)

    def __setitem__(self, idx, value):
        from ..ops.manipulation import _neg_steps_as_indices, _torch_index
        d = self._data
        idx = _neg_steps_as_indices(_torch_index(idx, d.device), d.shape)
        if isinstance(value, Tensor):
            value = value._data.detach()
        elif not isinstance(value, (int, float, bool, complex)):
            value = to_torch(value, d.dtype, state.place_of(d.device))
        if d.grad_fn is None and (isinstance(d, torch.nn.Parameter)
                                  or d.requires_grad):
            with torch.no_grad():
                d[idx] = value
            return
        new = d.detach().clone(memory_format=torch.contiguous_format)
        new[idx] = value
        self._assign(new)

    def __len__(self):
        if not self._data.dim():
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ------------------------------------------------------------- misc
    def __repr__(self):
        grad_txt = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}"
                f", place={self.place}{grad_txt},\n       "
                f"{self.numpy()!r})")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __index__(self):
        return int(self._data.detach())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, *a, **k):
        return self._data.detach().__dlpack__(*a, **k)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()


def unwrap(x):
    """The torch tensor under a Tensor; anything else as it is."""
    return x._data if isinstance(x, Tensor) else x


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new leaf holding a copy of `data` on `place`
    (default: the current place, the CUDA card unless `set_device("cpu")`
    was called; raises when that is the card and there is none)."""
    if isinstance(data, (Tensor, torch.Tensor)):
        data = unwrap(data).detach().clone()
        if place is None:
            place = state.get_place()
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


class Parameter(Tensor):
    """Trainable leaf (ref python/paddle/fluid/framework.py:5416
    ParamBase); `_data` is a `torch.nn.Parameter`."""

    def __init__(self, data, dtype=None, name=None, trainable=True):
        if isinstance(data, (Tensor, torch.Tensor)):
            src = data._data if isinstance(data, Tensor) else data
            data = src.detach().clone()
        t = to_torch(data, dtype)
        self._data = torch.nn.Parameter(
            t, requires_grad=bool(trainable) and (t.is_floating_point()
                                                  or t.is_complex()))
        if name is not None:
            self.name = name
        self.persistable = True
        self.trainable = trainable

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()
