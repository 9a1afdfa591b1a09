"""Optimizers (the port of `paddle_tpu/optimizer/optimizer.py`): the
`Optimizer` base with SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb, Lars, Ftrl and Dpsgd.

The update rules are written here, not taken from `torch.optim`, because
they differ from it where the JAX package does: Adam and AdamW keep f32
moments for every parameter, bf16 ones too, and compute the update in
f32 before casting it to the parameter's dtype; AdamW decays every
parameter, as p -= lr * (m_hat / (sqrt(v_hat) + eps) + coeff * p);
`multi_precision=True` (Adam, AdamW, Momentum) keeps an f32 master copy
of each bf16/fp16 parameter, updates the master and casts it down. Each
rule follows the JAX rule's roundings: the JAX package's eager `step()`
passes the hyperparameters into its compiled update as weakly typed f32
scalars, so a rule that computes in the weights' dtype rounds them to it
(`_weak`), and the scalars derived from them (1 - beta1, ...) are f32
arithmetic.

The rules run over all parameters at once with torch's `_foreach_*`
list ops, so a step costs a few dozen launches rather than a dozen per
parameter; for CUDA tensors Adam and AdamW instead launch one fused
kernel per group (`fused_adam`, csrc/optimizer.cu). Parameters are
updated in place.

Per step and per parameter, as the JAX package's eager `step()` does
(`paddle_tpu/optimizer/optimizer.py:112-127`): the gradient is cast to
the dtype of the weight the rule updates (the master, or the weight),
the regularizer is appended in that dtype — the parameter's own
`regularizer` attribute, else the optimizer's `weight_decay` (a float
means L2Decay) — and the learning rate is multiplied by the parameter's
`learning_rate` attribute (default 1.0). The port has one `step()` for
the eager and the graphed train step, so these attributes hold under
`jit.TrainStep` too (the JAX package's functional `apply_gradients_fn`
ignores them).

The learning rate and the step index reach the update from device
memory, as the JAX package's compiled step takes them: each optimizer
keeps an f32 pair [lr, step] on its parameters' device, which `step()`
fills from the host through one pinned staging copy before the update
(`_advance`). The learning rate is a float or an `lr.LRScheduler`, whose
current value `get_lr()` reads. The bias corrections and a parameter's
scaled learning rate are computed from the pair on the device, and
`step()` reads nothing back to the host, so a CUDA graph that captured
it replays with the pair's current values. Inside a capture `step()`
leaves the pair alone: the capturer (`jit.TrainStep`) advances it
before each replay.
"""
import numbers

import numpy as np
import torch

from ..regularizer import L2Decay, WeightDecayRegularizer
from . import fused_adam
from .lr import LRScheduler

_LOW = (torch.bfloat16, torch.float16)


def _f32(x):
    """x rounded to f32, as a Python float (the JAX package's f32
    scalars)."""
    return float(np.float32(x))


def _one_minus(x):
    """1 - x in f32 arithmetic, as the JAX rules compute it from their
    f32 hyperparameters."""
    return float(np.float32(1.0) - np.float32(x))


def _weak(x, dtype):
    """A hyperparameter as a JAX weakly typed f32 scalar enters
    arithmetic in `dtype`: rounded to f32, then to dtype."""
    return float(torch.tensor(_f32(x), dtype=torch.float32).to(dtype))


def _capturing(params):
    """Whether the current CUDA stream is capturing a graph (never for
    parameters on the CPU)."""
    return bool(params) and params[0].is_cuda and \
        torch.cuda.is_current_stream_capturing()


def _torch_param(p):
    """A parameter as the optimizer holds it: a torch tensor. A port
    `Tensor` (a `Parameter`, or a leaf with stop_gradient=False) is
    unwrapped to its `_data`, which it updates in place and whose `.grad`
    the wrapper reads, so `clear_grad` on either clears both; its
    `regularizer` and `learning_rate` attributes are carried over."""
    from ..framework.tensor import Tensor
    if not isinstance(p, Tensor):
        return p
    d = p._data
    for attr in ("regularizer", "learning_rate"):
        if attr in p.__dict__:
            setattr(d, attr, p.__dict__[attr])
    return d


def _regularizer(weight_decay):
    """An optimizer's `weight_decay` as a regularizer object or None: a
    nonzero number is L2Decay."""
    if weight_decay is None or isinstance(weight_decay,
                                          WeightDecayRegularizer):
        return weight_decay
    if isinstance(weight_decay, numbers.Real) and \
            not isinstance(weight_decay, bool):
        return L2Decay(float(weight_decay)) if weight_decay else None
    raise TypeError(f"weight_decay must be a float or a regularizer "
                    f"(L1Decay, L2Decay), got {type(weight_decay).__name__}")


def _lr_scale(p):
    """A parameter's learning-rate multiplier (its `learning_rate`
    attribute)."""
    return float(getattr(p, "learning_rate", 1.0))


def _floats(xs):
    return [x.float() for x in xs]


def _sub_cast(bases, upd):
    """bases -= upd cast to each base's dtype."""
    torch._foreach_sub_(bases, [u.to(b.dtype) for u, b in zip(upd, bases)])


def _ema(acc, rho, x, one_minus_rho):
    """acc = rho * acc + (1 - rho) * x in place, each product rounded,
    as the JAX rules write it."""
    torch._foreach_mul_(acc, rho)
    torch._foreach_add_(acc, torch._foreach_mul(x, one_minus_rho))


def _squares(xs):
    return torch._foreach_mul(xs, xs)


def _norms(xs):
    """Each f32 tensor's L2 norm, as one f32 tensor. The card's
    reduction sums in a tree; torch's CPU reduction of f32 sums in f32
    and drifts over millions of elements, so on the CPU the sum is taken
    in f64 and rounded once."""
    if xs[0].is_cuda:
        return torch.stack(torch._foreach_norm(xs))
    return torch.stack(torch._foreach_norm(xs, 2, dtype=torch.float64)
                       ).float()


class Optimizer:
    _state_names = ()          # per-parameter state slots, e.g. ("moment1",)
    _state_f32 = False         # slots in f32 whatever the weights' dtype

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(learning_rate, LRScheduler):
            self._lr = learning_rate
        elif isinstance(learning_rate, numbers.Real) and \
                not isinstance(learning_rate, bool):
            self._lr = float(learning_rate)
        else:
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got "
                            f"{type(learning_rate).__name__}")
        self._parameters = [_torch_param(p) for p in parameters] \
            if parameters is not None else []
        self._grad_clip = grad_clip
        self._weight_decay = _regularizer(weight_decay)
        self._state = {}           # parameter index -> {slot: tensor}
        self._global_step = 0
        self._multi_precision = False
        self._scalars = None       # device f32 [lr, step] (`_advance`)

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # --------------------------------------------------------------- state
    def _mp_param(self, p):
        return self._multi_precision and p.dtype in _LOW

    def _init_state(self, p):
        mp = self._mp_param(p)
        dtype = torch.float32 if mp or self._state_f32 else p.dtype
        st = {n: torch.zeros_like(p, dtype=dtype) for n in self._state_names}
        if mp:
            st["master"] = p.detach().float().clone()
        return st

    def _ensure_state(self, i):
        if i not in self._state:
            self._state[i] = self._init_state(self._parameters[i])
        return self._state[i]

    def _tensor_norms(self, xs):
        """Each tensor's L2 norm (the per-tensor rules: Lamb, Lars,
        Dpsgd). A ZeRO-1 step's optimizer over parameter chunks replaces
        it with the norms of the whole tensors."""
        return _norms(xs)

    def _regularizer_of(self, p):
        """The parameter's own regularizer, else the optimizer's."""
        reg = getattr(p, "regularizer", None)
        return reg if reg is not None else self._weight_decay

    def _update(self, bases, grads, states, lr, step):
        """Update `bases` (one dtype: f32 masters, or weights) in place
        from `grads` (in the bases' dtype, regularized) and the
        per-parameter `states`; `lr` and `step` are 0-dim f32 device
        tensors."""
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
            # clipping needs dense magnitudes: row-sparse grads densify
            items = [(i, p, g.to_dense() if g.is_sparse else g)
                     for i, p, g in items]
            pairs = self._grad_clip([(p, g) for _, p, g in items])
            items = [(i, p, g) for (i, _, _), (p, g) in zip(items, pairs)]
        sparse = [it for it in items if it[2].is_sparse]
        if sparse:
            items = [it for it in items if not it[2].is_sparse]
            if self._can_row_update():
                for i, p, g in sparse:
                    self._sparse_step(i, p, g)
            else:
                # a stateful rule without lazy_mode decays its state on
                # every row: the dense update
                items += [(i, p, g.to_dense()) for i, p, g in sparse]
        if items:
            self._apply(items)

    def _can_row_update(self):
        """Whether a row-sparse gradient updates only its rows: exact for
        a stateless rule (SGD), `lazy_mode`'s semantics for a stateful
        one, and never under multi_precision (the rows would move behind
        the f32 master's back)."""
        if self._multi_precision:
            return False
        return not self._state_names or getattr(self, "_lazy_mode", False)

    def _sparse_step(self, i, p, g):
        """The rule on the touched rows alone (ref sgd_op.h
        SparseSGDFunctor, adam lazy_mode): the rows of the weight and of
        each state slot gathered, updated by `_update`, scattered back.
        Duplicate rows are summed first."""
        g = g.coalesce()
        rows = g.indices()[0]
        vals = g.values().to(p.dtype)
        st = self._ensure_state(i)
        p_rows = p[rows]
        reg = self._regularizer_of(p)
        if reg is not None:
            vals = reg.append(p_rows, vals)
        st_rows = {n: st[n][rows] for n in self._state_names}
        lr, step = self._scalars[0], self._scalars[1]
        scale = _lr_scale(p)
        self._update([p_rows], [vals], [st_rows],
                     lr if scale == 1.0 else lr * scale, step)
        p.index_copy_(0, rows, p_rows)
        for n, v in st_rows.items():
            st[n].index_copy_(0, rows, v)

    def _apply(self, items):
        """The plain update of (index, param, grad) items: the gradient
        in the base dtype with its regularizer, then `_update` once per
        (learning-rate multiplier, base dtype) group, the masters cast
        down."""
        groups, masters = {}, []
        for i, p, g in items:
            st = self._ensure_state(i)
            base = st.get("master", p)
            g = g.to(base.dtype)
            reg = self._regularizer_of(p)
            if reg is not None:
                g = reg.append(base, g)
            group = groups.setdefault((_lr_scale(p), base.dtype),
                                      ([], [], []))
            for lst, x in zip(group, (base, g, st)):
                lst.append(x)
            if "master" in st:
                masters.append((p, base))
        lr, step = self._scalars[0], self._scalars[1]
        for (scale, _), (bases, grads, states) in groups.items():
            self._update(bases, grads, states,
                         lr if scale == 1.0 else lr * scale, step)
        for p, master in masters:
            p.copy_(master)

    def clear_grad(self):
        for p in self._parameters:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """backward() then step() (the dygraph form of the JAX
        package's `minimize`)."""
        loss.backward()
        self.step()
        return [], []

    # ----------------------------------------------------------- save/load
    def state_dict(self):
        sd = {}
        for i, st in sorted(self._state.items()):
            for n, t in st.items():
                sd[f"param_{i}.{n}"] = t.detach().clone()
        sd["global_step"] = self._global_step
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, sd):
        self._global_step = int(sd.get("global_step", 0))
        if "LR_Scheduler" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["LR_Scheduler"])
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

    set_dict = set_state_dict


# --------------------------------------------------------------------- rules


class SGD(Optimizer):
    _state_names = ()

    def _update(self, bases, grads, states, lr, step):
        # p - lr.astype(p.dtype) * g: the product rounds in p's dtype
        torch._foreach_sub_(bases, torch._foreach_mul(
            grads, lr.to(bases[0].dtype)))


class Momentum(Optimizer):
    """v = mu v + g; p -= lr (v, or g + mu v with `use_nesterov`), in the
    weights' dtype (the master's under `multi_precision`), the learning
    rate rounded to it."""
    _state_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        self._multi_precision = bool(multi_precision)

    def _update(self, bases, grads, states, lr, step):
        dtype = bases[0].dtype
        mu = _weak(self._momentum, dtype)
        v = [st["velocity"] for st in states]
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, grads)
        delta = v
        if self._use_nesterov:
            delta = torch._foreach_mul(v, mu)
            torch._foreach_add_(delta, grads)
        torch._foreach_sub_(bases, torch._foreach_mul(delta, lr.to(dtype)))


class Adam(Optimizer):
    """Adam with f32 moments. `lazy_mode` changes only the update of a
    row-sparse gradient (a table read by `F.embedding(sparse=True)`):
    with it the touched rows alone are updated, their moments and
    weights (`_sparse_step`); without it the gradient is densified and
    every row's moments decay. Dense gradients take the same update
    either way."""
    _state_names = ("moment1", "moment2")
    _state_f32 = True
    _decoupled = False     # AdamW: the decoupled weight decay

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, kernel="auto"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)
        self._multi_precision = bool(multi_precision)
        self._coeff = 0.0
        # "auto" | "plain" | "cuda" (fused_adam.resolve_kernel)
        self._kernel = kernel
        fused_adam.resolve_kernel(kernel)

    def _moments(self, grads, states, step):
        """Advance the moments; returns (m_hat, sqrt(v_hat) + eps) as
        f32 lists."""
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        g32 = _floats(grads)
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
        if self._decoupled:
            upd = torch._foreach_div(mhat, den)
            torch._foreach_add_(upd, _floats(bases), alpha=_f32(self._coeff))
            torch._foreach_mul_(upd, lr)
        else:
            upd = torch._foreach_mul(mhat, lr)           # lr * m_hat / den
            torch._foreach_div_(upd, den)
        _sub_cast(bases, upd)

    def _apply(self, items):
        if fused_adam.resolve_kernel(self._kernel,
                                     items[0][1].device) == "plain":
            return super()._apply(items)
        # the fused kernel: one launch per (weight dtype, master, lr
        # multiplier, gradient term) group
        groups = {}
        for i, p, g in items:
            st = self._ensure_state(i)
            mp = "master" in st
            reg = self._regularizer_of(p)
            term = (None, 0.0) if reg is None else (
                reg.mode, reg.coeff_in(torch.float32 if mp else p.dtype))
            groups.setdefault((p.dtype, mp, _lr_scale(p), term), []).append(
                (p, g, st))
        for (_, mp, scale, (mode, coeff)), group in groups.items():
            fused_adam.cuda_adam(
                [p for p, _, _ in group], [g for _, g, _ in group],
                [st["moment1"] for _, _, st in group],
                [st["moment2"] for _, _, st in group],
                [st["master"] for _, _, st in group] if mp else None,
                self._scalars, self._beta1, self._beta2, self._epsilon,
                grad_mode=mode, grad_coeff=coeff,
                decoupled=self._decoupled, decay=self._coeff,
                lr_scale=scale)


class AdamW(Adam):
    """Decoupled weight decay, applied to every parameter:
    p -= lr * (m_hat / (sqrt(v_hat) + eps) + coeff * p). A parameter's
    own `regularizer` is still appended to its gradient.

    `apply_decay_param_fun` and `lr_ratio` are accepted for the Paddle
    signature and, as in the JAX package's AdamW, neither is consulted:
    every parameter is decayed and takes the same learning rate (times
    its own `learning_rate` attribute). `lazy_mode` is Adam's."""
    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 kernel="auto"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, kernel=kernel)
        self._coeff = float(weight_decay) if isinstance(
            weight_decay, (int, float)) else 0.01
        self._apply_decay_param_fun = apply_decay_param_fun


class Adamax(Optimizer):
    """m = b1 m + (1 - b1) g, u = max(b2 u, |g|) in the weights' dtype;
    p -= lr / (1 - b1^t) * m / (u + eps), computed in f32."""
    _state_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, bases, grads, states, lr, step):
        dtype = bases[0].dtype
        m = [st["moment"] for st in states]
        u = [st["inf_norm"] for st in states]
        _ema(m, _weak(self._beta1, dtype), grads,
             _weak(_one_minus(self._beta1), dtype))
        torch._foreach_mul_(u, _weak(self._beta2, dtype))
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        lr_t = lr / (1 - torch.pow(_f32(self._beta1), step))
        upd = torch._foreach_mul(_floats(m), lr_t)
        torch._foreach_div_(upd, _floats(torch._foreach_add(
            u, _weak(self._epsilon, dtype))))
        _sub_cast(bases, upd)


class Adagrad(Optimizer):
    """acc += g^2 (f32, from `initial_accumulator_value`);
    p -= lr g / (sqrt(acc) + eps)."""
    _state_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, _f32(self._init_value),
                                          dtype=torch.float32)}

    def _update(self, bases, grads, states, lr, step):
        mom = [st["moment"] for st in states]
        g32 = _floats(grads)
        torch._foreach_add_(mom, _squares(g32))
        upd = torch._foreach_mul(g32, lr)
        den = torch._foreach_sqrt(mom)
        torch._foreach_add_(den, _f32(self._epsilon))
        torch._foreach_div_(upd, den)
        _sub_cast(bases, upd)


class Adadelta(Optimizer):
    """E[g^2] and E[dx^2] running averages (f32);
    dx = sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) g; p -= lr dx."""
    _state_names = ("avg_squared_grad", "avg_squared_update")
    _state_f32 = True

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, bases, grads, states, lr, step):
        eps, rho, rest = (_f32(self._epsilon), _f32(self._rho),
                          _one_minus(self._rho))
        sq_g = [st["avg_squared_grad"] for st in states]
        sq_u = [st["avg_squared_update"] for st in states]
        g32 = _floats(grads)
        _ema(sq_g, rho, _squares(g32), rest)
        upd = torch._foreach_add(sq_u, eps)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(sq_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, g32)
        _ema(sq_u, rho, _squares(upd), rest)
        _sub_cast(bases, torch._foreach_mul(upd, lr))


class RMSProp(Optimizer):
    """E[g^2] (and E[g] when `centered`) running averages (f32);
    acc = momentum acc + lr g / sqrt(E[g^2] (- E[g]^2) + eps); p -= acc."""
    _state_names = ("mean_square", "mean_grad", "momentum_acc")
    _state_f32 = True

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, bases, grads, states, lr, step):
        rho, rest = _f32(self._rho), _one_minus(self._rho)
        ms = [st["mean_square"] for st in states]
        mg = [st["mean_grad"] for st in states]
        acc = [st["momentum_acc"] for st in states]
        g32 = _floats(grads)
        _ema(ms, rho, _squares(g32), rest)
        den = ms
        if self._centered:
            _ema(mg, rho, g32, rest)
            den = torch._foreach_sub(ms, _squares(mg))
        den = torch._foreach_add(den, _f32(self._epsilon))
        torch._foreach_sqrt_(den)
        upd = torch._foreach_mul(g32, lr)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(acc, _f32(self._momentum))
        torch._foreach_add_(acc, upd)
        _sub_cast(bases, acc)


def _trust_ratio(num, den, num_norms, den_norms):
    """Per tensor: num / den where both norms are positive, else 1."""
    ok = (num_norms > 0) & (den_norms > 0)
    return torch.where(ok, num / den, 1.0)


class Lamb(Optimizer):
    """Layer-wise adaptive Adam (ref lamb_op): r = m_hat / (sqrt(v_hat) +
    eps) + wd p; p -= lr (|p| / |r|) r, the norms per tensor
    (`_foreach_norm`), the ratio 1 where either is 0.

    `exclude_from_weight_decay_fn` is accepted for the Paddle signature
    and, as in the JAX package, not consulted: every parameter takes
    `lamb_weight_decay`."""
    _state_names = ("moment1", "moment2")
    _state_f32 = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, bases, grads, states, lr, step):
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        m = [st["moment1"] for st in states]
        v = [st["moment2"] for st in states]
        g32, p32 = _floats(grads), _floats(bases)
        _ema(m, b1, g32, _one_minus(b1))
        _ema(v, b2, _squares(g32), _one_minus(b2))
        r = torch._foreach_div(m, 1 - torch.pow(b1, step))
        den = torch._foreach_div(v, 1 - torch.pow(b2, step))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _f32(self._epsilon))
        torch._foreach_div_(r, den)
        torch._foreach_add_(r, torch._foreach_mul(p32, _f32(self._lamb_wd)))
        w_norm, r_norm = self._tensor_norms(p32), self._tensor_norms(r)
        scale = lr * _trust_ratio(w_norm, r_norm, w_norm, r_norm)
        torch._foreach_mul_(r, list(scale.unbind()))
        _sub_cast(bases, r)


class Lars(Momentum):
    """LARS momentum (ref lars_momentum_op): local_lr = coeff |p| / (|g|
    + wd |p| + 1e-12) per tensor (1 where either norm is 0);
    v = mu v + lr local_lr (g + wd p) (f32); p -= v.

    `exclude_from_weight_decay` and `epsilon` are accepted for the Paddle
    signature and, as in the JAX package, not consulted: every parameter
    takes `lars_weight_decay`, and the denominator's guard is 1e-12."""
    _state_f32 = True

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _update(self, bases, grads, states, lr, step):
        mu, coeff, wd = (_f32(self._momentum), _f32(self._lars_coeff),
                         _f32(self._lars_wd))
        v = [st["velocity"] for st in states]
        g32, p32 = _floats(grads), _floats(bases)
        w_norm, g_norm = self._tensor_norms(p32), self._tensor_norms(g32)
        local = _trust_ratio(coeff * w_norm, g_norm + wd * w_norm + 1e-12,
                             w_norm, g_norm)
        upd = torch._foreach_add(g32, torch._foreach_mul(p32, wd))
        torch._foreach_mul_(upd, list((lr * local).unbind()))
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, upd)
        _sub_cast(bases, v)


class Ftrl(Optimizer):
    """FTRL-proximal (ref ftrl_op.h), its accumulators f32 whatever the
    weights' dtype: n' = n + g^2; sigma = (n'^-power - n^-power) / lr;
    z += g - sigma p; p = (clip(z, -l1, l1) - z) / (n'^-power / lr +
    2 l2) where |z| > l1, else 0."""
    _state_names = ("squared", "linear")
    _state_f32 = True

    def __init__(self, learning_rate=0.05, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1 = float(l1)
        self._l2 = float(l2)
        self._lr_power = float(lr_power)

    def _update(self, bases, grads, states, lr, step):
        l1, power = _f32(self._l1), -_f32(self._lr_power)
        sq = [st["squared"] for st in states]
        lin = [st["linear"] for st in states]
        g32, p32 = _floats(grads), _floats(bases)
        new_sq = torch._foreach_add(sq, _squares(g32))
        new_pow = torch._foreach_pow(new_sq, power)
        sigma = torch._foreach_sub(new_pow, torch._foreach_pow(sq, power))
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(lin, g32)
        torch._foreach_sub_(lin, torch._foreach_mul(sigma, p32))
        quad = torch._foreach_div(new_pow, lr)
        torch._foreach_add_(quad, _f32(2.0 * np.float32(self._l2)))
        for s, n in zip(sq, new_sq):
            s.copy_(n)
        for b, z, q in zip(bases, lin, quad):
            pre = torch.clamp(z, -l1, l1) - z
            b.copy_(torch.where(z.abs() > l1, pre / q, 0.0))


class Dpsgd(Optimizer):
    """Differentially private SGD (ref dpsgd_op): each gradient clipped
    to L2 norm `clip` (per tensor), Gaussian noise of std clip * sigma /
    batch_size added, p -= lr (g + noise) in the weights' dtype.

    The noise comes from this optimizer's own `torch.Generator` on the
    parameters' device, seeded with `seed` (`generator`); `jit.TrainStep`
    registers it with its CUDA graphs, so every replay draws fresh noise.
    The JAX package draws from `jax.random` (a key taken once when its
    TrainStep compiles), whose bits torch cannot reproduce: with sigma 0
    the two agree, and with sigma > 0 the noise has the same law."""
    _state_names = ()

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, seed=0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._clip = float(clip)
        self._batch_size = float(batch_size)
        self._sigma = float(sigma)
        dev = self._parameters[0].device if self._parameters else \
            torch.device("cpu")
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))

    def _update(self, bases, grads, states, lr, step):
        clip = np.float32(self._clip)
        std = float(clip * np.float32(self._sigma)
                    / np.float32(self._batch_size))
        norms = self._tensor_norms(_floats(grads))
        factor = torch.clamp(float(clip) / torch.clamp(norms, min=1e-12),
                             max=1.0)
        # out of place: an f32 grad's `.float()` is the grad itself
        g32 = torch._foreach_mul(_floats(grads), list(factor.unbind()))
        noise = [torch.randn(g.shape, generator=self.generator,
                             device=g.device, dtype=torch.float32)
                 for g in g32]
        torch._foreach_mul_(noise, std)
        torch._foreach_add_(g32, noise)
        # (g + noise) in the weights' dtype, times the f32 lr; the
        # difference in f32, rounded once
        upd = torch._foreach_mul(_floats([x.to(bases[0].dtype)
                                          for x in g32]), lr)
        new = torch._foreach_sub(_floats(bases), upd)
        for b, n in zip(bases, new):
            b.copy_(n)
