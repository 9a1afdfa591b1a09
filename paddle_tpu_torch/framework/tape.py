"""Eager backward (the port of `paddle_tpu/framework/tape.py`).

Torch autograd is the tape: every op's output carries its `grad_fn`, and
`backward` is `torch.autograd.backward` from the root with Paddle's
checks around it. Leaf gradients accumulate in `.grad` across calls until
`clear_grad`, as in Paddle; `retain_graph=False` frees the graph, so a
second backward through it raises; `create_graph=True` records the
backward itself, so the gradients are differentiable (second and higher
order). Hooks registered with `Tensor.register_hook` are torch's and run
during the sweep.
"""
import torch


def backward(tensor, grad_tensor=None, retain_graph=False,
             create_graph=False, only_accumulate=None):
    """Reverse sweep from `tensor`, accumulating into the leaves' `.grad`.
    `only_accumulate` (a list of Tensors) restricts accumulation to those
    leaves — paddle.grad's only_inputs semantics: other leaves' `.grad`
    is left untouched."""
    from .tensor import Tensor, to_torch

    d = tensor._data
    if grad_tensor is None:
        if d.numel() != 1:
            raise RuntimeError(
                "backward() on a non-scalar tensor requires an explicit "
                "grad_tensor")
        seed = torch.ones_like(d)
    else:
        seed = (grad_tensor._data if isinstance(grad_tensor, Tensor)
                else to_torch(grad_tensor, d.dtype, tensor.place))
    if not d.requires_grad:
        return
    inputs = None
    if only_accumulate is not None:
        inputs = [t._data for t in only_accumulate if t._data.requires_grad]
        if not inputs:
            return
    torch.autograd.backward(d, seed, retain_graph=retain_graph or
                            create_graph, create_graph=create_graph,
                            inputs=inputs)
