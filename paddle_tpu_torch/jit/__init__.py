"""The train step of the port (the counterpart of
`paddle_tpu/jit/__init__.py`'s `TrainStep`).

The JAX package compiles forward, backward and the optimizer into one
donated XLA program that takes the learning rate and the step index as
device scalars. Here, for a model on a CUDA device, `TrainStep` captures
the same sequence — forward and loss, `backward()`, the grad-norm
sentinel, the optimizer's clip and in-place update — as a
`graphs.Program`: one `torch.cuda.CUDAGraph` per input signature
(shapes, dtypes, devices), all sharing one memory pool, as `jax.jit`
keeps one program per signature:

  * the first call with a signature copies the inputs into static
    buffers and runs the sequence eagerly on a side stream, a real step
    that initialises the optimizer state, the kernel libraries, cuBLAS
    and autograd;
  * the second copies the inputs into place, captures the sequence with
    every grad unset (so the graph's backward writes them) and replays
    it once: also exactly one step;
  * every later call copies the inputs and the optimizer's [lr, step]
    pair into place and replays.

The model is a `torch.nn.Module` over torch tensors (the GPT and LLaMA
models) or an `nn.Layer`, whose forward takes and returns port
`Tensor`s and whose `parameters()` are port `Parameter`s: inputs and
labels may be Tensors or torch tensors either way, and the loss comes
back as the model's kind of tensor. The device is that of the model's
first torch leaf.

The model's dropout generator (`model.generator`), the optimizer's noise
generator where it has one (`Dpsgd`) and the framework generator of the
model's device (`framework.state.rng_generator`, which `nn.Dropout`,
`F.dropout` and the registered ops draw from) are registered with each
graph, so every replay draws fresh masks and noise. (`seed()` replaces
the framework's generators: a step captured before it keeps drawing
from the old one; build a new `TrainStep` after reseeding.) Nothing the
step runs may read device memory from the host: build masks and other
constants outside it. The optimizer's learning rate is read on the host
before each replay (`_advance`), so a schedule (`optimizer.lr`) moves it
without a new capture. The optimizer must be an `optimizer.Optimizer`:
the wrappers (EMA, ModelAverage, Lookahead, GradientMerge) branch on the
host every k steps and are refused, as the JAX TrainStep takes only an
optimizer's functional update. A replay returns a clone of the graph's
loss (and of its outputs, when `return_outputs`); the grads stay the
graph's own tensors, which the program keeps, and `p.grad` is left unset
between steps as in the eager sequence. A capture that fails raises with
its reason: nothing falls back to the eager sequence. The graph replays
on the addresses it captured: the kernels' TMA descriptors are encoded
from them, so its buffers are never swapped.

On the CPU, or with `cuda_graph=False`, the sequence runs eagerly on
every call, on the caller's tensors, and the grads are cleared after
the update. `donate=True` is accepted: the updates are in place anyway.
The flight-recorder instrumentation of the JAX TrainStep is not ported
(ROADMAP Queue 1).
"""
import torch

from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..graphs import Program
from ..optimizer import Optimizer


def grad_norm_sentinel(loss, grads):
    """(global grad norm, non-finite flag) as device tensors: the f32 L2
    norm over every grad, and whether the loss or that norm is not
    finite. Nothing is read back to the host here."""
    if grads:
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        gsq = torch.sum(torch.stack(norms) ** 2)
    else:
        gsq = torch.zeros((), device=loss.device)
    nonfinite = torch.logical_not(torch.all(torch.isfinite(loss.detach()))
                                  & torch.isfinite(gsq))
    return torch.sqrt(gsq), nonfinite


def _signature(args):
    return tuple((tuple(a.shape), a.dtype, a.device)
                 if isinstance(a, torch.Tensor) else ("value", repr(a))
                 for a in args)


def _leaf_device(model):
    """The device of the model's first torch leaf (a Layer's parameters
    are port Parameters over torch leaves)."""
    for p in model.parameters():
        return unwrap(p).device
    raise ValueError("TrainStep: the model has no parameters")


class TrainStep:
    """One training step per call: `loss = step(inputs, labels)`.

        step = TrainStep(model, gpt_pretrain_loss, AdamW(1e-4, parameters=
                         model.parameters()))
        loss = step(ids, ids)

    The model is put in training mode. `inputs` and `labels` are tensors
    or tuples of them; the model is called on the inputs and `loss_fn`
    on (outputs..., labels...). Returns the loss tensor (and the outputs
    when `return_outputs`). With `cuda_graph` (the default) a model on a
    CUDA device runs as CUDA graphs; `cuda_graph=False`, or a model on
    the CPU, runs the eager sequence. `graphs` maps each input signature
    to its captured graph (`graphs._Graph`: its `launches` and
    `replays`; None after its eager first call)."""

    def __init__(self, model, loss_fn, optimizer, donate=True,
                 return_outputs=False, cuda_graph=True):
        if not isinstance(optimizer, Optimizer):
            raise TypeError(
                f"TrainStep takes an optimizer.Optimizer, got "
                f"{type(optimizer).__name__}: the optimizer wrappers (EMA, "
                f"ModelAverage, Lookahead, GradientMerge) run eagerly; call "
                f"their step() after backward() yourself")
        from ..nn import Layer
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.return_outputs = return_outputs
        self._layer = isinstance(model, Layer)
        self._last_grad_norm = None
        self._last_nonfinite = None
        self._device = _leaf_device(model)
        self._graphed = bool(cuda_graph) and self._device.type == "cuda"
        self._args = {}
        gens = []
        if self._graphed:
            for owner in (model, optimizer):
                gen = getattr(owner, "generator", None)
                if isinstance(gen, torch.Generator) and \
                        gen.device.type == "cuda":
                    gens.append(gen)
            gens.append(state.rng_generator(self._device))
        self.program = Program("jit.TrainStep", self._program, self._device,
                               self._graphed, gens)
        model.train()

    @property
    def graphs(self):
        return self.program.graphs

    def _run(self, inputs, labels):
        """Forward, loss, backward, sentinel and the optimizer's update
        on torch tensors: device work only, no host reads. Returns the
        loss and the outputs (detached, as the model's kind of tensor)."""
        if self._layer:
            inputs = tuple(Tensor._wrap(a) if isinstance(a, torch.Tensor)
                           else a for a in inputs)
            labels = tuple(Tensor._wrap(a) if isinstance(a, torch.Tensor)
                           else a for a in labels)
        out = self.model(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = self.loss_fn(*outs, *labels)
        unwrap(loss).backward()
        grads = [p.grad for p in self.optimizer._parameters
                 if p.grad is not None]
        self._last_grad_norm, self._last_nonfinite = \
            grad_norm_sentinel(unwrap(loss), grads)
        self.optimizer.step()
        # the outputs are read only when asked for: detaching the fused
        # head's logits would compute the dense head product
        return loss.detach(), (tuple(o.detach() for o in outs)
                               if self.return_outputs else ())

    def _program(self, key):
        """The step over the static buffers of signature `key`."""
        return self._step(*self._args[key])

    def _step(self, args, n_in):
        """One step over `args` (the inputs, then the labels), every grad
        unset before and after. The grads the step wrote are returned
        with the loss, so a captured graph keeps them (the addresses its
        backward writes and its optimizer reads)."""
        self.optimizer.clear_grad()
        loss, outs = self._run(args[:n_in], args[n_in:])
        grads = [p.grad for p in self.optimizer._parameters]
        self.optimizer.clear_grad()
        return (loss, outs, self._last_grad_norm, self._last_nonfinite,
                grads)

    def __call__(self, inputs, labels):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        args = tuple(unwrap(a) for a in inputs + labels)
        key = _signature(args)
        if not self._graphed:
            step = self._step(args, len(inputs))
        elif key not in self._args:
            # the static buffers of this signature: its graph replays on
            # their addresses
            self._args[key] = (tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args), len(inputs))
        else:
            for dst, src in zip(self._args[key][0], args):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src, non_blocking=True)
            # a capture's step() does not advance the optimizer: its
            # replays read [lr, step] from the device pair written here
            self.optimizer._advance()
        if self._graphed:
            step = self.program(key)
        loss, outs, norm, nonfinite, _ = step
        self._last_grad_norm, self._last_nonfinite = norm, nonfinite
        if self._graphed and self.graphs[key] is not None:
            loss = loss.clone()
            outs = tuple(o.clone() for o in outs)
        if self.return_outputs:
            return loss, outs
        return loss

    def eval_fn(self, fn=None):
        """An eval forward over the live state: `run(*inputs)` puts the
        model in eval mode, calls it under `torch.no_grad()` and puts
        the training mode back. Inputs may be Tensors or torch tensors;
        the output is the model's kind of tensor. It runs eagerly, on
        the card too (no CUDA graph). `fn` is accepted for the JAX
        signature and not used: the forward is the model's."""
        model = self.model
        layer = self._layer

        def run(*inputs):
            inputs = tuple(
                Tensor._wrap(a) if layer and isinstance(a, torch.Tensor)
                else (a if layer else unwrap(a)) for a in inputs)
            was_training = model.training
            model.eval()
            try:
                with torch.no_grad():
                    return model(*inputs)
            finally:
                if was_training:
                    model.train()
        return run

    def sync(self):
        """No-op: the model and the optimizer already hold the state."""

    def last_grad_norm(self):
        """Global f32 grad norm of the latest step (host sync)."""
        return None if self._last_grad_norm is None \
            else float(self._last_grad_norm)

    def last_nonfinite(self):
        """Whether the latest step's loss or grad norm was non-finite
        (host sync)."""
        return None if self._last_nonfinite is None \
            else bool(self._last_nonfinite)
