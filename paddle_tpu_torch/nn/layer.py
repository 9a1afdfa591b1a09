"""nn.Layer — the module base class (the port of `paddle_tpu/nn/layer.py`;
ref python/paddle/fluid/dygraph/layers.py:76).

`Layer` subclasses `torch.nn.Module`, so torch's registry holds the
layer tree: sublayers in `_modules`, each parameter's torch leaf (the
`torch.nn.Parameter` that is the port `Parameter`'s `_data`) in
`_parameters`, each buffer's torch tensor in `_buffers`. The Paddle
objects sit beside them: `_pt_params` and `_pt_buffers` map the same
names onto the port's `Parameter` and `Tensor` wrappers, whose `_data`
is the very object torch holds (the wrappers are also instance
attributes, so reading one costs a dict lookup). So `set_value`, an optimizer's in-place
step and a running statistic's update are seen by both, and torch's own
`cuda()`, `float()`, `half()` and `bfloat16()` move or cast the layer
through `_apply`, which rebinds the wrappers to what torch now holds.

Where the two APIs clash the Paddle names and signatures win:
`parameters(include_sublayers)` and `named_parameters(prefix,
include_sublayers)` yield the port's `Parameter`s, `buffers` and
`named_buffers` its `Tensor`s, `state_dict` maps the JAX package's keys
onto them and `set_state_dict` copies numpy arrays (a JAX model's
`state_dict()` values), `Tensor`s or torch tensors into them in place;
`train()`/`eval()`, `to(device, dtype)`, `apply(fn)` (this layer first,
then its sublayers, as the JAX package orders them),
`register_forward_pre_hook`/`register_forward_post_hook` (a
`HookRemoveHelper` back) and `__call__` (the Paddle hooks around torch's
call). torch's remain: `children`, `named_children`, `modules`,
`named_modules`, `add_module`, `register_forward_hook`, `zero_grad`,
`cuda`, `cpu`, `float`, `half`, `bfloat16` and `extra_repr`. torch's
methods that call the overridden ones with torch's arguments
(`state_dict(prefix=...)`, `parameters(recurse=...)`,
`requires_grad_`, `load_state_dict`'s key check) do not apply to a
Layer.

A layer built the same way in both packages gives the same state-dict
keys and shapes. `functional_state` returns the torch tensors under the
JAX package's names, `_use_state` swaps others in (in torch's registry
and in the wrappers, restored on exit) and `functional_call` runs the
layer over them, returning (outputs, new buffers) as the JAX package's
does.
"""
import collections
import contextlib

import numpy as np
import torch
from torch.nn.modules import module as _tm

from ..framework import state
from ..framework.dtype import convert_dtype
from ..framework.tensor import Parameter, Tensor, to_torch, unwrap
from . import initializer as I


class HookRemoveHelper:
    def __init__(self, hooks, key):
        self._hooks, self._key = hooks, key

    def remove(self):
        self._hooks.pop(self._key, None)


def _wrap_parameter(p):
    """A port Parameter over the torch Parameter `p` itself (no copy)."""
    w = object.__new__(Parameter)
    w._data = p
    w.persistable = True
    w.trainable = p.requires_grad
    return w


def _write(t, value):
    """Copy `value` (a Tensor, torch tensor, numpy array or anything with
    `numpy()`) into the tensor `t` in place, cast to its dtype."""
    d = t._data
    if isinstance(value, (Tensor, torch.Tensor)):
        src = unwrap(value)
    else:
        src = value.numpy() if hasattr(value, "numpy") and \
            not isinstance(value, np.ndarray) else value
    src = to_torch(src, d.dtype, state.place_of(d.device))
    if tuple(src.shape) != tuple(d.shape):
        raise ValueError(f"set_state_dict: shape {tuple(src.shape)} for a "
                         f"tensor of shape {tuple(d.shape)}")
    with torch.no_grad():
        d.copy_(src)


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        torch.nn.Module.__init__(self)
        d = self.__dict__
        d["_pt_params"] = collections.OrderedDict()
        d["_pt_buffers"] = collections.OrderedDict()
        d["_non_persistable_buffer_names"] = set()
        d["_pd_pre_hooks"] = collections.OrderedDict()
        d["_pd_post_hooks"] = collections.OrderedDict()
        d["_pd_hook_key"] = 0
        d["_dtype"] = dtype
        d["_name_scope"] = name_scope or self.__class__.__name__.lower()

    # ------------------------------------------------------------ registration
    @property
    def _sub_layers(self):
        return self._modules

    def __setattr__(self, name, value):
        d = self.__dict__
        params = d.get("_pt_params")
        if params is None:
            return torch.nn.Module.__setattr__(self, name, value)
        bufs = d["_pt_buffers"]
        if isinstance(value, torch.nn.Parameter):
            value = _wrap_parameter(value)
        if isinstance(value, Parameter):
            bufs.pop(name, None)
            self._buffers.pop(name, None)
            self._modules.pop(name, None)
            self._parameters[name] = value._data
            params[name] = value
            d[name] = value     # a plain attribute read finds it
            return
        if name in bufs and isinstance(value, (Tensor, torch.Tensor)):
            if isinstance(value, torch.Tensor):
                value = Tensor._wrap(value)
            bufs[name] = value
            self._buffers[name] = value._data
            d[name] = value
            return
        if name in params:
            del params[name]
            del self._parameters[name]
            d.pop(name, None)
        if name in bufs:
            del bufs[name]
            del self._buffers[name]
            d.pop(name, None)
        torch.nn.Module.__setattr__(self, name, value)

    def __delattr__(self, name):
        d = self.__dict__
        if name in d.get("_pt_params", ()):
            del d["_pt_params"][name]
            del self._parameters[name]
            d.pop(name, None)
        elif name in d.get("_pt_buffers", ()):
            del d["_pt_buffers"][name]
            del self._buffers[name]
            d.pop(name, None)
        else:
            torch.nn.Module.__delattr__(self, name)

    def _apply(self, fn, *args, **kwargs):
        """torch's `_apply` (moves and casts), then each wrapper rebound
        onto what torch's registry now holds."""
        torch.nn.Module._apply(self, fn, *args, **kwargs)
        for n, p in self._pt_params.items():
            p._data = self._parameters[n]
        for n, b in self._pt_buffers.items():
            b._data = self._buffers[n]
        return self

    def add_sublayer(self, name, sublayer):
        setattr(self, str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        setattr(self, str(name), parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True):
        name = str(name)
        if not isinstance(tensor, Tensor):
            tensor = Tensor._wrap(to_torch(tensor))
        self.__dict__.pop(name, None)
        torch.nn.Module.register_buffer(self, name, tensor._data,
                                        persistent=persistable)
        self._pt_buffers[name] = tensor
        self.__dict__[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        else:
            tensor.persistable = True
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter on the current place (ref dygraph/layers.py
        create_parameter + ParamAttr handling): from `attr.initializer`,
        else `default_initializer`, else zeros for a bias and
        Xavier-normal otherwise; None when `attr` is False."""
        from .param_attr import ParamAttr
        dtype = dtype or self._dtype or "float32"
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = I.Constant(0.0)
        else:
            init = I.XavierNormal()
        p = Parameter(init(shape, dtype), name=(attr.name if attr else None),
                      trainable=(attr.trainable if attr else True))
        p.regularizer = attr.regularizer if attr else None
        p.learning_rate = attr.learning_rate if attr else 1.0
        return p

    def create_tensor(self, name=None, persistable=False, dtype=None):
        return Tensor(torch.zeros([], dtype=convert_dtype(dtype)
                                  or state.get_default_dtype(),
                                  device=state.current_device()))

    # ------------------------------------------------------------ iteration
    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, p in self._pt_params.items():
            if id(p) not in seen:
                seen.add(id(p))
                yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, layer in self._modules.items():
                if not isinstance(layer, Layer):
                    continue
                sub = f"{prefix}.{lname}" if prefix else lname
                for n, p in layer.named_parameters(prefix=sub):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b in self._pt_buffers.items():
            yield (f"{prefix}.{name}" if prefix else name), b
        if include_sublayers:
            for lname, layer in self._modules.items():
                if not isinstance(layer, Layer):
                    continue
                sub = f"{prefix}.{lname}" if prefix else lname
                yield from layer.named_buffers(prefix=sub)

    def _persistent_buffers(self, prefix=""):
        for name, b in self._pt_buffers.items():
            if name not in self._non_persistable_buffer_names:
                yield (f"{prefix}.{name}" if prefix else name), b
        for lname, layer in self._modules.items():
            if isinstance(layer, Layer):
                yield from layer._persistent_buffers(
                    f"{prefix}.{lname}" if prefix else lname)

    def sublayers(self, include_self=False):
        out = [self] if include_self else []
        for layer in self._modules.values():
            if isinstance(layer, Layer):
                out.extend(layer.sublayers(include_self=True))
        return out

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if not isinstance(layer, Layer):
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(prefix=sub, include_self=True)

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ------------------------------------------------------------ modes
    def train(self, mode=True):
        for layer in self.sublayers(include_self=True):
            layer.training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # ------------------------------------------------------------ hooks
    def _add_hook(self, hooks, hook):
        key = self._pd_hook_key
        self.__dict__["_pd_hook_key"] = key + 1
        hooks[key] = hook
        return HookRemoveHelper(hooks, key)

    def register_forward_pre_hook(self, hook):
        """hook(layer, inputs) runs before forward; what it returns (a
        tuple, or one value) replaces the inputs."""
        return self._add_hook(self._pd_pre_hooks, hook)

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) runs after forward; what it
        returns replaces the outputs."""
        return self._add_hook(self._pd_post_hooks, hook)

    # ------------------------------------------------------------ call
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        if self._pd_pre_hooks:
            for hook in list(self._pd_pre_hooks.values()):
                out = hook(self, inputs)
                if out is not None:
                    inputs = out if isinstance(out, tuple) else (out,)
        if self._forward_hooks or self._forward_pre_hooks or \
                self._backward_hooks or self._backward_pre_hooks or \
                _tm._global_forward_hooks or \
                _tm._global_forward_pre_hooks or \
                _tm._global_backward_hooks or \
                _tm._global_backward_pre_hooks:
            outputs = torch.nn.Module.__call__(self, *inputs, **kwargs)
        else:       # torch's own fast path, without its call frames
            outputs = self.forward(*inputs, **kwargs)
        if self._pd_post_hooks:
            for hook in list(self._pd_post_hooks.values()):
                out = hook(self, inputs, outputs)
                if out is not None:
                    outputs = out
        return outputs

    # ------------------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        """name -> the Parameters, then the persistable buffers (the JAX
        package's keys and order). Raises for a parameter whose full
        weight a sharded or pipelined step released on this rank (it
        holds only its part): the step's `sync()` gathers it back."""
        dest = destination if destination is not None else \
            collections.OrderedDict()
        prefix = structured_name_prefix.rstrip(".")
        for n, p in self.named_parameters(
                prefix=prefix, include_sublayers=include_sublayers):
            # distributed.parallel_layers.release marks the leaf
            if getattr(p._data, "_full_shape", None) is not None:
                raise RuntimeError(
                    f"state_dict: parameter {n!r} holds only this rank's "
                    f"part (a sharded or pipelined train step released its "
                    f"full weight): call the step's sync() first")
            dest[n] = p
        if include_sublayers:
            bufs = self._persistent_buffers(prefix)
        else:
            bufs = ((f"{prefix}.{n}" if prefix else n, b)
                    for n, b in self._pt_buffers.items()
                    if n not in self._non_persistable_buffer_names)
        for n, b in bufs:
            dest[n] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of `state_dict` into the tensor of the same
        key, in place and in its dtype. Returns (missing, unexpected)
        keys."""
        own = self.state_dict()
        unexpected = []
        for k, v in state_dict.items():
            if k in own:
                _write(own[k], v)
            else:
                unexpected.append(k)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def to(self, device=None, dtype=None, blocking=None):
        """Move to `device` (a Place or a name) and cast the floating
        parameters and buffers to `dtype`."""
        dev = None if device is None else state.parse_place(
            device).torch_device()
        dt = convert_dtype(dtype)

        def fn(t):
            return t.to(device=dev, dtype=dt if dt is not None
                        and t.is_floating_point() else None)
        return self._apply(fn)

    # ------------------------------------------------------------ functional
    def functional_state(self):
        """(params, buffers): flat name -> torch tensor dicts (the
        tensors torch's registry holds), under the JAX package's names."""
        params = {n: p._data for n, p in self.named_parameters()}
        buffers = {n: b._data for n, b in self.named_buffers()}
        return params, buffers

    def _owners(self, kind):
        """id(wrapper) -> [(layer, attribute)] of every layer that holds
        the wrapper, for `kind` "params" or "buffers" (a shared
        Parameter sits in more than one layer)."""
        owners = {}
        for _, layer in self.named_sublayers(include_self=True):
            d = layer._pt_params if kind == "params" else layer._pt_buffers
            for attr, w in d.items():
                owners.setdefault(id(w), []).append((layer, attr))
        return owners

    @contextlib.contextmanager
    def _use_state(self, params=None, buffers=None):
        """Swap the torch tensors of `params` and `buffers` (name ->
        tensor, the names of `functional_state`) in for the layer's own,
        in the wrappers' `_data` and in torch's registry; every swapped
        tensor is put back on exit, also when the body raises. Yields
        (named parameters, named buffers): name -> the port wrappers."""
        named_p = dict(self.named_parameters())
        named_b = dict(self.named_buffers())
        saved = []

        def swap(named, values, kind):
            owners = self._owners(kind)
            for n, arr in values.items():
                w = named[n]
                if isinstance(arr, Tensor):
                    arr = arr._data
                regs = [(layer._parameters if kind == "params"
                         else layer._buffers, attr)
                        for layer, attr in owners.get(id(w), ())]
                saved.append((w, w._data, [(r, a, r[a]) for r, a in regs]))
                w._data = arr
                for r, a in regs:
                    r[a] = arr
        try:
            if params is not None:
                swap(named_p, params, "params")
            if buffers is not None:
                swap(named_b, buffers, "buffers")
            yield named_p, named_b
        finally:
            for w, data, regs in reversed(saved):
                w._data = data
                for r, a, old in regs:
                    r[a] = old

    def functional_call(self, params, buffers, *inputs, method=None,
                        **kwargs):
        """The layer (or its `method`) over `params` and `buffers`
        instead of its own state: returns (outputs, new_buffers), the
        buffers as the call left them. Torch tensors and numpy arrays
        among `inputs` are wrapped as Tensors; anything else (a cache
        tuple, a scalar) passes through untouched. Gradients reach the
        tensors of `params` that require grad."""
        def wrap(i):
            if isinstance(i, torch.Tensor):
                return Tensor._wrap(i)
            if isinstance(i, np.ndarray):
                return Tensor(i)
            return i

        # the buffers the call updates in place (running statistics) are
        # copies: the caller's tensors stay as they were
        if buffers is not None:
            buffers = {n: unwrap(b).clone() for n, b in buffers.items()}
        with self._use_state(params, buffers) as (_, named_b):
            fn = getattr(self, method) if method else self
            out = fn(*[wrap(i) for i in inputs], **kwargs)
            new_buffers = {n: named_b[n]._data for n in (buffers or {})}
        return out, new_buffers

    def __repr__(self):
        lines = []
        for name, layer in self._modules.items():
            rep = repr(layer).split("\n")
            rep = [rep[0]] + ["  " + r for r in rep[1:]]
            lines.append(f"  ({name}): " + "\n".join(rep))
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    def extra_repr(self):
        return ""


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        if idx < 0:
            idx += len(self)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], (list, tuple)):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __len__(self):
        return len(self._pt_params)

    def __getitem__(self, idx):
        return self._pt_params[str(idx)]

    def __iter__(self):
        return iter(self._pt_params.values())

    def append(self, p):
        self.add_parameter(str(len(self)), p)
        return self
