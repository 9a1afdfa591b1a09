"""Optimizers (the port of `paddle_tpu/optimizer/optimizer.py`): the
`Optimizer` base with SGD, Adam and AdamW.

The update rules are written here, not taken from `torch.optim`, because
they differ from it where the JAX package does:
  * Adam and AdamW keep f32 moments for every parameter, bf16 ones too,
    and compute the update in f32 before casting it to the parameter's
    dtype;
  * AdamW decays every parameter (`apply_decay_param_fun` is accepted
    and, as in the JAX package, not consulted), as
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + coeff * p);
  * `multi_precision=True` keeps an f32 master copy of each bf16/fp16
    parameter, updates the master and casts it down.
The rules run over all parameters at once with torch's `_foreach_*` list
ops, so a step costs a few dozen launches rather than a dozen per
parameter; for CUDA tensors Adam and AdamW instead launch one fused
kernel per dtype group (`fused_adam`, csrc/optimizer.cu). Parameters are
updated in place.

The learning rate and the step index reach the update from device
memory, as the JAX package's compiled step takes them: each optimizer
keeps an f32 pair [lr, step] on its parameters' device, which `step()`
fills from the host through one pinned staging copy before the update
(`_advance`). The bias corrections are computed from it on the device,
and `step()` reads nothing back to the host, so a CUDA graph that
captured it replays with the pair's current values. Inside a capture
`step()` leaves the pair alone: the capturer (`jit.TrainStep`) advances
it before each replay.
"""
import torch

from . import fused_adam

_LOW = (torch.bfloat16, torch.float16)


def _f32(x):
    """x rounded to f32, as a Python float (the JAX package's f32
    scalars)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _capturing(params):
    """Whether the current CUDA stream is capturing a graph (never for
    parameters on the CPU)."""
    return bool(params) and params[0].is_cuda and \
        torch.cuda.is_current_stream_capturing()


class Optimizer:
    _state_names = ()          # per-parameter state slots, e.g. ("moment1",)

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP "
                "Queue 1: optimizer/lr.py); pass a float")
        self._lr = float(learning_rate)
        self._parameters = list(parameters) if parameters is not None else []
        self._grad_clip = grad_clip
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "regularizer objects are not ported yet; pass a float "
                "(L2 decay coefficient)")
        # L2 decay appended to the gradient: g + coeff * p
        self._weight_decay = float(weight_decay) if weight_decay else None
        self._state = {}           # parameter index -> {slot: tensor}
        self._global_step = 0
        self._multi_precision = False
        self._scalars = None       # device f32 [lr, step] (`_advance`)

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    # --------------------------------------------------------------- state
    def _mp_param(self, p):
        return self._multi_precision and p.dtype in _LOW

    def _init_state(self, p):
        return {n: torch.zeros_like(p) for n in self._state_names}

    def _ensure_state(self, i):
        if i not in self._state:
            self._state[i] = self._init_state(self._parameters[i])
        return self._state[i]

    def _update(self, bases, grads, states, lr, step):
        """Update the f32-or-parameter-dtype `bases` in place from
        `grads` (already in the bases' dtypes) and the per-parameter
        `states`; `lr` and `step` are 0-dim f32 device tensors."""
        raise NotImplementedError

    # ---------------------------------------------------------------- step
    def _advance(self):
        """Count one step on the host and write [lr, step] into the
        device pair: one copy from a pinned staging tensor (the caching
        host allocator keeps it until the copy has run)."""
        self._global_step += 1
        dev = self._parameters[0].device if self._parameters else \
            torch.device("cpu")
        if self._scalars is None or self._scalars.device != dev:
            self._scalars = torch.zeros(2, dtype=torch.float32, device=dev)
        host = torch.tensor([self.get_lr(), float(self._global_step)],
                            dtype=torch.float32,
                            pin_memory=dev.type == "cuda")
        self._scalars.copy_(host, non_blocking=True)

    @torch.no_grad()
    def step(self):
        if not _capturing(self._parameters):
            self._advance()
        elif self._scalars is None:
            raise RuntimeError("optimizer.step() inside a CUDA-graph "
                               "capture needs one eager step first (it "
                               "makes the device [lr, step] pair)")
        items = [(i, p, p.grad) for i, p in enumerate(self._parameters)
                 if p.requires_grad and p.grad is not None]
        if not items:
            return
        if self._grad_clip is not None:
            pairs = self._grad_clip([(p, g) for _, p, g in items])
            items = [(i, p, g) for (i, _, _), (p, g) in zip(items, pairs)]
        self._apply(items)

    def _apply(self, items):
        """The plain update of (index, param, grad) items: the L2 term
        in the base dtype, `_update` over every base, the masters cast
        down."""
        bases, grads, states, masters = [], [], [], []
        for i, p, g in items:
            st = self._ensure_state(i)
            base = st.get("master", p)
            g = g.to(base.dtype)
            if self._weight_decay is not None:
                g = g + self._weight_decay * base
            bases.append(base)
            grads.append(g)
            states.append(st)
            if "master" in st:
                masters.append((p, base))
        self._update(bases, grads, states, self._scalars[0],
                     self._scalars[1])
        for p, master in masters:
            p.copy_(master)

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None

    # ----------------------------------------------------------- save/load
    def state_dict(self):
        sd = {}
        for i, st in sorted(self._state.items()):
            for n, t in st.items():
                sd[f"param_{i}.{n}"] = t.detach().clone()
        sd["global_step"] = self._global_step
        return sd

    def set_state_dict(self, sd):
        self._global_step = int(sd.get("global_step", 0))
        for i, p in enumerate(self._parameters):
            st = self._ensure_state(i)
            for n in (*self._state_names, "master"):
                key = f"param_{i}.{n}"
                if key not in sd:
                    continue
                val = torch.as_tensor(sd[key]).to(
                    device=p.device,
                    dtype=st[n].dtype if n in st else torch.float32)
                if n in st and st[n].shape == val.shape:
                    st[n].copy_(val)    # in place: a captured graph holds it
                else:
                    st[n] = val.clone()
            if "master" in st and f"param_{i}.master" not in sd:
                # no master in the checkpoint: seed it from the weights
                st["master"].copy_(p.detach())


def _sub_cast(bases, upd):
    """bases -= upd cast to each base's dtype."""
    torch._foreach_sub_(bases, [u.to(b.dtype) for u, b in zip(upd, bases)])


class SGD(Optimizer):
    _state_names = ()

    def _update(self, bases, grads, states, lr, step):
        # p - lr.astype(p.dtype) * g: the product rounds in p's dtype
        lrs = {dt: lr.to(dt) for dt in {b.dtype for b in bases}}
        upd = [g * lrs[b.dtype] for g, b in zip(grads, bases)]
        torch._foreach_sub_(bases, upd)


class Adam(Optimizer):
    _state_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, kernel="auto"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if lazy_mode:
            raise NotImplementedError("Adam lazy_mode (row-sparse "
                                      "updates) is not ported yet")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = bool(multi_precision)
        # "auto" | "plain" | "cuda" (fused_adam.resolve_kernel)
        self._kernel = kernel
        fused_adam.resolve_kernel(kernel)

    def _init_state(self, p):
        # f32 moments for every parameter; the master copy of the
        # weights is opt-in (multi_precision)
        st = {n: torch.zeros_like(p, dtype=torch.float32)
              for n in self._state_names}
        if self._mp_param(p):
            st["master"] = p.detach().float().clone()
        return st

    def _moments(self, grads, states, step):
        """Advance the moments; returns (m_hat, sqrt(v_hat) + eps) as
        f32 lists."""
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        g32 = [g.float() for g in grads]
        # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g^2, in place
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=_f32(1 - self._beta1))
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=_f32(1 - self._beta2))
        bc1 = 1 - torch.pow(b1, step)
        bc2 = 1 - torch.pow(b2, step)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _f32(self._epsilon))
        return torch._foreach_div(m, bc1), den

    def _update(self, bases, grads, states, lr, step):
        mhat, den = self._moments(grads, states, step)
        upd = torch._foreach_mul(mhat, lr)           # lr * m_hat / den
        torch._foreach_div_(upd, den)
        _sub_cast(bases, upd)

    def _decay(self):
        """(mode, coefficient) of the fused kernel: Adam's L2 term."""
        if self._weight_decay is None:
            return None, 0.0
        return "l2", self._weight_decay

    def _apply(self, items):
        if fused_adam.resolve_kernel(self._kernel,
                                     items[0][1].device) == "plain":
            return super()._apply(items)
        # the fused kernel: one launch per (weight dtype, master) group
        groups = {}
        for i, p, g in items:
            st = self._ensure_state(i)
            groups.setdefault((p.dtype, "master" in st), []).append(
                (p, g, st))
        mode, decay = self._decay()
        for (_, mp), group in groups.items():
            fused_adam.cuda_adam(
                [p for p, _, _ in group], [g for _, g, _ in group],
                [st["moment1"] for _, _, st in group],
                [st["moment2"] for _, _, st in group],
                [st["master"] for _, _, st in group] if mp else None,
                self._scalars, self._beta1, self._beta2, self._epsilon,
                decay, mode)


class AdamW(Adam):
    """Decoupled weight decay, applied to every parameter:
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + coeff * p)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 kernel="auto"):
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, kernel=kernel)
        # apply_decay_param_fun is accepted for the Paddle signature; the
        # JAX package's AdamW does not consult it either
        self._coeff = float(weight_decay) if isinstance(
            weight_decay, (int, float)) else 0.01

    def _update(self, bases, grads, states, lr, step):
        mhat, den = self._moments(grads, states, step)
        upd = torch._foreach_div(mhat, den)
        torch._foreach_add_(upd, [b.float() for b in bases],
                            alpha=_f32(self._coeff))
        torch._foreach_mul_(upd, lr)
        _sub_cast(bases, upd)

    def _decay(self):
        return "decoupled", self._coeff
