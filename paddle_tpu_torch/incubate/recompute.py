"""Recompute / activation checkpointing (the port of
`paddle_tpu/incubate/recompute.py`; ref fluid/optimizer.py:4549
RecomputeOptimizer).

`recompute(function, *args)` runs `function` under the non-reentrant
`torch.utils.checkpoint`: its activations are dropped after the forward
and recomputed in the backward, trading operations for memory as the
JAX package's `jax.checkpoint` does. The arguments may mix port
`Tensor`s, torch tensors and other values; the result is a Tensor (or a
torch tensor) or a tuple of them, as `function` returns it.

Random draws: the JAX package's recompute replays the same RNG keys. A
stateful generator cannot be rewound inside a CUDA-graph capture (the
CUDA generator refuses `get_state`/`set_state` while capturing), so with
`preserve_rng_state` the forward records what each random op drew
(`_DrawTape`, a dispatch mode over the ops tagged
`nondeterministic_seeded`: dropout's bernoulli, rand, randn, ...) and
the recompute is handed those values instead of drawing again. The masks
are the forward's, the generators advance once, as they would without
recompute, and the same code runs eagerly and in a captured
`jit.TrainStep`. The recorded draws are kept until the backward (a
bernoulli mask as bool). `preserve_rng_state=False` lets the recompute
draw afresh.

Unlike the JAX package, whose eager recompute is a no-op, the port
checkpoints whenever autograd records (`torch.is_grad_enabled()`): the
eager tape is torch autograd, the same as a TrainStep's.
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..framework.tensor import Tensor

_SEEDED = torch.Tag.nondeterministic_seeded


class _DrawTape:
    """The random draws of one recomputed call: recorded by its first
    run, handed back in order to the later runs (the recompute)."""

    def __init__(self):
        self.draws = []
        self.runs = 0

    @contextlib.contextmanager
    def run(self):
        mode = _TapeMode(self, replay=self.runs > 0)
        self.runs += 1
        with mode:
            yield
        if mode.replay and mode.i != len(self.draws):
            raise RuntimeError(
                f"recompute: the recompute made {mode.i} random draws, "
                f"the forward {len(self.draws)}")


class _TapeMode(TorchDispatchMode):
    def __init__(self, tape, replay):
        super().__init__()
        self.tape, self.replay, self.i = tape, replay, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _SEEDED not in func.tags:
            return func(*args, **kwargs)
        if not self.replay:
            out = func(*args, **kwargs)
            # a bernoulli draw is 0 or 1: kept as bool, restored exactly
            if func._schema.name in ("aten::bernoulli", "aten::bernoulli_"):
                kept = (out.bool(), out.dtype)
            else:
                kept = (tree_map(torch.clone, out), None)
            self.tape.draws.append((func, kept))
            return out
        if self.i >= len(self.tape.draws):
            raise RuntimeError(f"recompute: the recompute drew {func} "
                               "more often than the forward")
        want, (kept, dtype) = self.tape.draws[self.i]
        self.i += 1
        if want is not func:
            raise RuntimeError(f"recompute: the recompute drew {func} "
                               f"where the forward drew {want}")
        if dtype is not None:
            kept = kept.to(dtype)
        if func._schema.name.endswith("_"):      # in place: into args[0]
            args[0].copy_(kept)
            return args[0]
        return kept


def _is_tensor(a):
    return isinstance(a, (Tensor, torch.Tensor))


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in the
    backward. Tensor arguments (port Tensors or torch tensors) are the
    checkpoint's inputs; other arguments and `kwargs` pass through. With
    autograd off this is a plain call."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    slots = [i for i, a in enumerate(args) if _is_tensor(a)]
    wrapped = [isinstance(args[i], Tensor) for i in slots]
    tape = _DrawTape() if preserve_rng_state else None
    kinds = []

    def run(*arrays):
        full = list(args)
        for i, a, wrap in zip(slots, arrays, wrapped):
            full[i] = Tensor._wrap(a) if wrap else a
        with tape.run() if tape is not None else contextlib.nullcontext():
            out = function(*full, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        kinds[:] = [isinstance(o, Tensor) for o in outs]
        raw = tuple(o._data if isinstance(o, Tensor) else o for o in outs)
        return raw if isinstance(out, (tuple, list)) else raw[0]

    # torch's own RNG stash reads the CUDA generator, which a capture
    # refuses: the tape above covers every draw
    out = checkpoint(run, *(args[i]._data if wrapped[j] else args[i]
                            for j, i in enumerate(slots)),
                     use_reentrant=False, preserve_rng_state=False)
    if isinstance(out, tuple):
        return tuple(Tensor._wrap(o) if k else o
                     for o, k in zip(out, kinds))
    return Tensor._wrap(out) if kinds[0] else out


def recompute_sequential(functions, x, segments=1):
    """Checkpoint a sequence of layers in `segments` chunks of
    len // segments layers (the last chunk takes the remainder in chunks
    of the same size), as the JAX package chunks it."""
    layers = list(functions)
    n = len(layers)
    seg_size = max(1, n // max(segments, 1))
    i = 0
    while i < n:
        chunk = layers[i:i + seg_size]

        def seg_fn(inp, chunk=chunk):
            for layer in chunk:
                inp = layer(inp)
            return inp

        x = recompute(seg_fn, x)
        i += seg_size
    return x
