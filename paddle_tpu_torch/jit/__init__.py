"""The train step of the port (the counterpart of
`paddle_tpu/jit/__init__.py`'s `TrainStep`).

The JAX package compiles forward, backward and the optimizer into one
donated XLA program. PyTorch runs eagerly, so `TrainStep` here is the
same sequence of calls made one after another: forward and loss,
`backward()`, the grad-norm sentinel, the optimizer's clip and in-place
update, and clearing the grads. `donate=True` is accepted: the updates
are in place anyway. The flight-recorder instrumentation of the JAX
TrainStep is not ported (ROADMAP Queue 1).
"""
import torch


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


class TrainStep:
    """One training step per call: `loss = step(inputs, labels)`.

        step = TrainStep(model, gpt_pretrain_loss, AdamW(1e-4, parameters=
                         model.parameters()))
        loss = step(ids, ids)

    The model is put in training mode. `inputs` and `labels` are tensors
    or tuples of them; the model is called on the inputs and `loss_fn`
    on (outputs..., labels...). Returns the loss tensor (and the outputs
    when `return_outputs`)."""

    def __init__(self, model, loss_fn, optimizer, donate=True,
                 return_outputs=False):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.return_outputs = return_outputs
        self._last_grad_norm = None
        self._last_nonfinite = None
        model.train()

    def __call__(self, inputs, labels):
        inputs = inputs if isinstance(inputs, (list, tuple)) else (inputs,)
        labels = labels if isinstance(labels, (list, tuple)) else (labels,)
        out = self.model(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        grads = [p.grad for p in self.optimizer._parameters
                 if p.grad is not None]
        self._last_grad_norm, self._last_nonfinite = \
            grad_norm_sentinel(loss, grads)
        self.optimizer.step()
        self.optimizer.clear_grad()
        loss = loss.detach()
        if self.return_outputs:
            return loss, tuple(o.detach() for o in outs)
        return loss

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
