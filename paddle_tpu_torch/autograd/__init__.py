"""paddle.autograd (the port of `paddle_tpu/autograd/__init__.py`):
user-defined differentiable functions and the grad API (ref
python/paddle/autograd/py_layer.py PyLayer/PyLayerContext).

A `PyLayer` subclass runs as a `torch.autograd.Function` built once per
subclass: its `forward` and `backward` see and return port Tensors, and
torch autograd calls the backward during the sweep. As in the JAX
package, the backward runs once: asked for a differentiable gradient
(`create_graph=True`), it raises.
"""
import torch

from ..framework.tensor import Tensor, to_torch

__all__ = ["PyLayer", "PyLayerContext", "backward", "grad"]


class PyLayerContext:
    """Passed as ctx to forward/backward (ref py_layer.py PyLayerContext)."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


def _function(cls):
    """The torch.autograd.Function of PyLayer subclass `cls` (made once)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(tctx, spec, kwargs, *raw):
        ctx = PyLayerContext()
        args = [Tensor._wrap(r) if is_t else r
                for is_t, r in zip(spec, raw)]
        out = cls.forward(ctx, *args, **kwargs)
        multi = isinstance(out, (tuple, list))
        outs = tuple(out) if multi else (out,)
        for o in outs:
            if not isinstance(o, Tensor):
                raise TypeError(f"{cls.__name__}.forward must return "
                                f"Tensor(s), got {type(o).__name__}")
        tctx.pl_ctx, tctx.spec = ctx, spec
        tctx.outs = [o._data.shape for o in outs]
        res = tuple(o._data for o in outs)
        return res if multi else res[0]

    def backward(tctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"create_graph: PyLayer {cls.__name__} does not support "
                "double backward")
        gs = cls.backward(tctx.pl_ctx, *[Tensor._wrap(g) for g in grads])
        gs = gs if isinstance(gs, (tuple, list)) else (gs,)
        n_tensors = sum(tctx.spec)
        if len(gs) != n_tensors:
            raise ValueError(f"{cls.__name__}.backward returned {len(gs)} "
                             f"grads for {n_tensors} tensor inputs")
        it = iter(gs)
        out = []
        for is_t in tctx.spec:
            g = next(it) if is_t else None
            out.append(None if g is None else to_torch(g))
        return (None, None) + tuple(out)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """Custom autograd op:

        class Cube(PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x * x

            @staticmethod
            def backward(ctx, grad_out):
                (x,) = ctx.saved_tensor()
                return 3 * x * x * grad_out

        y = Cube.apply(x)

    backward returns one grad per TENSOR input of forward (None allowed
    for non-differentiable ones), like the reference.
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, Tensor) and not v.stop_gradient:
                raise TypeError(
                    f"{cls.__name__}.apply: differentiable Tensor passed "
                    f"as keyword {k!r}; tensors must be positional so "
                    "backward grads align with them")
        spec = tuple(isinstance(a, Tensor) for a in args)
        raw = [a._data if t else a for a, t in zip(args, spec)]
        out = _function(cls).apply(spec, kwargs, *raw)
        if isinstance(out, tuple):
            return tuple(Tensor._wrap(o) for o in out)
        return Tensor._wrap(out)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: reverse sweeps from one or more tensors.
    Shared subgraphs survive across the per-tensor sweeps (every sweep
    but the last retains the graph regardless of `retain_graph`)."""
    from ..framework import tape
    ts = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if isinstance(grad_tensors, (list, tuple)):
        if len(grad_tensors) != len(ts):
            raise ValueError(
                f"backward: {len(ts)} tensors but {len(grad_tensors)} "
                "grad_tensors")
        gs = list(grad_tensors)
    else:
        gs = [grad_tensors] * len(ts)
    for i, (t, g) in enumerate(zip(ts, gs)):
        keep = retain_graph or i < len(ts) - 1
        tape.backward(t, g, retain_graph=keep)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad (ref imperative/partial_grad_engine.cc): the gradients
    of `outputs` with respect to `inputs`, as Tensors, without touching
    any `.grad`. `grad_outputs` seeds each output (None: ones, for a
    scalar output); `no_grad_vars` are treated as constants — no gradient
    flows through them; `create_graph=True` makes the gradients
    differentiable (and retains the graph unless `retain_graph` says
    otherwise); an input the outputs do not reach raises unless
    `allow_unused`, which gives None for it."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None or isinstance(grad_outputs, Tensor):
        gos = [grad_outputs] * len(outs)
    else:
        gos = list(grad_outputs)
    pairs = []
    for o, go in zip(outs, gos):
        d = o._data
        if not d.requires_grad:
            continue
        if go is None:
            if d.numel() != 1:
                raise RuntimeError(
                    "grad: a non-scalar output needs its grad_outputs")
            go = torch.ones_like(d)
        else:
            go = to_torch(go, d.dtype, o.place)
        pairs.append((d, go))
    rg = create_graph if retain_graph is None else retain_graph
    grads = [None] * len(ins)
    wanted = [i for i, t in enumerate(ins) if t._data.requires_grad]
    if pairs and wanted:
        handles = [v._data.register_hook(torch.zeros_like)
                   for v in (no_grad_vars or ()) if v._data.requires_grad]
        try:
            got = torch.autograd.grad(
                [d for d, _ in pairs], [ins[i]._data for i in wanted],
                grad_outputs=[g for _, g in pairs], retain_graph=bool(rg),
                create_graph=bool(create_graph), allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        for i, g in zip(wanted, got):
            grads[i] = None if g is None else Tensor._wrap(g)
    for g, t in zip(grads, ins):
        if g is None and not allow_unused:
            raise RuntimeError(f"grad: input {t.name} unused in graph "
                               "(pass allow_unused=True to get None)")
    return grads
