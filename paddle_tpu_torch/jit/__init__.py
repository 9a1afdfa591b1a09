"""The train step of the port (the counterpart of
`paddle_tpu/jit/__init__.py`'s `TrainStep`).

The JAX package compiles forward, backward and the optimizer into one
donated XLA program that takes the learning rate and the step index as
device scalars. Here, for a model on a CUDA device, `TrainStep` captures
the same sequence — forward and loss, `backward()`, the grad-norm
sentinel, the optimizer's clip and in-place update — into one
`torch.cuda.CUDAGraph` per input signature (shapes, dtypes, devices),
all sharing one memory pool, as `jax.jit` keeps one program per
signature:

  * the first call with a signature runs the sequence eagerly on a side
    stream, a real step that initialises the optimizer state, the kernel
    libraries, cuBLAS and autograd;
  * the second copies the inputs into static buffers, captures the
    sequence with every grad unset (so the graph's backward writes them)
    and replays it once: also exactly one step;
  * every later call copies the inputs and the optimizer's [lr, step]
    pair into place and replays.

The model's dropout generator, and the optimizer's noise generator
where it has one (`Dpsgd`), are registered with each graph, so every
replay draws fresh masks and noise. The optimizer's learning rate is
read on the host before each replay (`_advance`), so a schedule
(`optimizer.lr`) moves it without a new capture. The optimizer must be
an `optimizer.Optimizer`: the wrappers (EMA, ModelAverage, Lookahead,
GradientMerge) branch on the host every k steps and are refused, as the
JAX TrainStep takes only an optimizer's functional update. A replay
returns a clone of the graph's loss
(and of its outputs, when `return_outputs`); the grads stay the graph's
own tensors, which the step keeps, and `p.grad` is left unset between
steps as in the eager sequence. A capture that fails raises with its
reason: nothing falls back to the eager sequence. The graph replays on
the addresses it captured: the kernels' TMA descriptors are encoded from
them, so its buffers are never swapped.

On the CPU, or with `cuda_graph=False`, the sequence runs eagerly on
every call and the grads are cleared after the update. `donate=True` is
accepted: the updates are in place anyway. The flight-recorder
instrumentation of the JAX TrainStep is not ported (ROADMAP Queue 1).
"""
import torch

from .. import kernels
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


class _Graph:
    """One captured step: the graph, its static inputs and outputs, the
    grads its backward writes, the kernel launches it holds (by
    `kernels.launch_counts` key) and how often it was replayed."""

    def __init__(self, graph, inputs, loss, outs, grad_norm, nonfinite,
                 grads, launches):
        self.graph = graph
        self.inputs = inputs
        self.loss = loss
        self.outs = outs
        self.grad_norm = grad_norm
        self.nonfinite = nonfinite
        self.grads = grads
        self.launches = launches
        self.replays = 0


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
    to its `_Graph` once captured (None after its eager first call)."""

    def __init__(self, model, loss_fn, optimizer, donate=True,
                 return_outputs=False, cuda_graph=True):
        if not isinstance(optimizer, Optimizer):
            raise TypeError(
                f"TrainStep takes an optimizer.Optimizer, got "
                f"{type(optimizer).__name__}: the optimizer wrappers (EMA, "
                f"ModelAverage, Lookahead, GradientMerge) run eagerly; call "
                f"their step() after backward() yourself")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.return_outputs = return_outputs
        self._last_grad_norm = None
        self._last_nonfinite = None
        self._device = next(model.parameters()).device
        self._graphed = bool(cuda_graph) and self._device.type == "cuda"
        self.graphs = {}
        self._pool = None
        model.train()

    def _run(self, inputs, labels):
        """Forward, loss, backward, sentinel and the optimizer's update:
        device work only, no host reads."""
        out = self.model(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        grads = [p.grad for p in self.optimizer._parameters
                 if p.grad is not None]
        self._last_grad_norm, self._last_nonfinite = \
            grad_norm_sentinel(loss, grads)
        self.optimizer.step()
        # the outputs are read only when asked for: detaching the fused
        # head's logits would compute the dense head product
        return loss.detach(), (tuple(o.detach() for o in outs)
                               if self.return_outputs else ())

    def __call__(self, inputs, labels):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        if not self._graphed:
            loss, outs = self._run(inputs, labels)
            self.optimizer.clear_grad()
        else:
            key = _signature(inputs + labels)
            if key not in self.graphs:
                loss, outs = self._warm_up(inputs, labels)
                self.graphs[key] = None
            else:
                if self.graphs[key] is None:
                    self.graphs[key] = self._capture(inputs, labels)
                loss, outs = self._replay(self.graphs[key], inputs + labels)
        if self.return_outputs:
            return loss, outs
        return loss

    def _warm_up(self, inputs, labels):
        """The eager step on a side stream (PyTorch's recipe before a
        whole-network capture)."""
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss, outs = self._run(inputs, labels)
            self.optimizer.clear_grad()
        current.wait_stream(side)
        return loss, outs

    def _capture(self, inputs, labels):
        static = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                       for a in inputs + labels)
        n_in = len(inputs)
        params = self.optimizer._parameters
        self.optimizer.clear_grad()
        graph = torch.cuda.CUDAGraph()
        for owner in (self.model, self.optimizer):
            gen = getattr(owner, "generator", None)
            if isinstance(gen, torch.Generator) and \
                    gen.device.type == "cuda":
                graph.register_generator_state(gen)
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                loss, outs = self._run(static[:n_in], static[n_in:])
        except Exception as exc:
            raise RuntimeError(f"TrainStep: CUDA-graph capture of the train "
                               f"step failed: {exc}") from exc
        after = kernels.launch_counts()
        if self._pool is None:
            self._pool = graph.pool()
        grads = [p.grad for p in params]
        self.optimizer.clear_grad()
        return _Graph(graph, static, loss, outs,
                      self._last_grad_norm, self._last_nonfinite, grads,
                      {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)})

    def _replay(self, g, args):
        for dst, src in zip(g.inputs, args):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src, non_blocking=True)
        self.optimizer._advance()
        g.graph.replay()
        g.replays += 1
        self._last_grad_norm, self._last_nonfinite = g.grad_norm, g.nonfinite
        return g.loss.clone(), tuple(o.clone() for o in g.outs)

    def eval_fn(self, fn=None):
        """An eval forward over the live state: `run(*inputs)` puts the
        model in eval mode, calls it under `torch.no_grad()` and puts
        the training mode back. It runs eagerly, on the card too (no
        CUDA graph). `fn` is accepted for the JAX signature and not
        used: the forward is the model's."""
        model = self.model

        def run(*inputs):
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
