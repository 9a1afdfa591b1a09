"""Optimizer wrappers (the port of `paddle_tpu/optimizer/wrappers.py`):
ExponentialMovingAverage, ModelAverage, LookaheadOptimizer and
GradientMergeOptimizer (ref python/paddle/fluid/optimizer.py).

Each keeps its accumulators as tensors on the parameters' device and
has the JAX package's surface: `update()` / `apply()` / `restore()` for
the averages, `step()` / `clear_grad()` / `minimize()` / `get_lr()` for
the optimizer wrappers. They are eager: their `% k` branches run on the
host, and `jit.TrainStep` refuses them (the JAX TrainStep takes only an
optimizer's functional update too). Weights are written in place
(`copy_`), so tensors that other code holds — a captured graph, an
optimizer's state — keep pointing at them.
"""
import contextlib

import torch


def _trainable(parameters):
    if parameters is None:
        raise ValueError("pass parameters=model.parameters()")
    from .optimizer import _torch_param
    params = [_torch_param(p) for p in parameters]
    return [p for p in params if p.requires_grad]


@contextlib.contextmanager
def _restoring(owner, need_restore):
    try:
        yield
    finally:
        if need_restore:
            owner.restore()


class _Swap:
    """apply()/restore() of averaged weights: the live weights are
    copied aside, the averages copied in, and copied back on restore."""

    def _averaged(self):
        raise NotImplementedError

    @torch.no_grad()
    def _swap_in(self, need_restore):
        self._backup = [p.detach().clone() for p in self._params]
        for p, avg in zip(self._params, self._averaged()):
            p.copy_(avg)
        return _restoring(self, need_restore)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p, b in zip(self._params, self._backup):
            p.copy_(b)
        self._backup = None


class ExponentialMovingAverage(_Swap):
    """EMA of the parameters' values: call update() after each
    optimizer step; apply() swaps the bias-corrected averages
    (ema / (1 - decay^t)) in for evaluation, restore() swaps the weights
    back. `with ema.apply(): evaluate()` restores on exit."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None,
                 name=None):
        self._decay = decay
        self._params = _trainable(parameters)
        # EMA_0 = 0: the bias correction below is only valid for a
        # zero-initialized accumulator
        self._ema = [torch.zeros_like(p) for p in self._params]
        self._step = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        for i, p in enumerate(self._params):
            self._ema[i] = d * self._ema[i] + (1.0 - d) * p.detach()

    def _averaged(self):
        if self._step == 0:
            return [p.detach() for p in self._params]  # no update yet
        corr = 1.0 - self._decay ** self._step
        return [e / corr for e in self._ema]

    def apply(self, need_restore=True):
        return self._swap_in(need_restore)

    def state_dict(self):
        return {**{f"ema_{i}": e.clone() for i, e in enumerate(self._ema)},
                "step": self._step}

    def set_state_dict(self, sd):
        self._step = int(sd.get("step", 0))
        for i, p in enumerate(self._params):
            v = sd.get(f"ema_{i}")
            if v is not None:
                self._ema[i] = torch.as_tensor(v).to(p.device, p.dtype)


class ModelAverage(_Swap):
    """Running average of the parameters over a sliding window
    (geometric, of `average_window_rate` x steps bounded by the min and
    max windows): update() each step; apply()/restore() for evaluation."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._params = _trainable(parameters)
        self._sum = [torch.zeros_like(p) for p in self._params]
        self._count = 0
        self._backup = None

    def _window_decay(self):
        window = max(self._min_w, min(
            self._max_w, int(self._count * self._rate) or 1))
        return max(0.0, 1.0 - 1.0 / window)

    @torch.no_grad()
    def update(self):
        self._count += 1
        decay = self._window_decay()
        for i, p in enumerate(self._params):
            self._sum[i] = self._sum[i] * decay + p.detach()

    def _averaged(self):
        # the effective count of the geometric window
        decay = self._window_decay()
        n_eff = (1.0 - decay ** max(self._count, 1)) / (1.0 - decay) \
            if decay < 1.0 else max(self._count, 1)
        return [s / n_eff for s in self._sum]

    def apply(self, executor=None, need_restore=True):
        return self._swap_in(need_restore)


class LookaheadOptimizer:
    """Lookahead: the inner (fast) optimizer steps k times, then the
    slow weights move toward the fast ones, slow += alpha (fast - slow),
    and the fast weights restart from them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._params = inner_optimizer._parameters
        self._slow = [p.detach().clone() for p in self._params]
        self._steps = 0

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for p, slow in zip(self._params, self._slow):
                slow.copy_(slow + self.alpha * (p - slow))
                p.copy_(slow)

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()


class GradientMergeOptimizer:
    """k-step gradient accumulation before one real update: each step()
    adds the grads to an accumulator and clears them; every k-th hands
    the sum (the mean with `avg`) to the inner optimizer's step()."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg
        self._params = inner_optimizer._parameters
        self._acc = None
        self._steps = 0

    @torch.no_grad()
    def step(self):
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in self._params]
        for i, p in enumerate(self._params):
            if p.grad is not None:
                self._acc[i] = self._acc[i] + p.grad
        self._steps += 1
        if self._steps % self.k_steps == 0:
            scale = 1.0 / self.k_steps if self.avg else 1.0
            for p, acc in zip(self._params, self._acc):
                p.grad = acc * scale
            self.inner_optimizer.step()
            self._acc = None
        self.clear_grad()           # grads consumed either way

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    def get_lr(self):
        return self.inner_optimizer.get_lr()
