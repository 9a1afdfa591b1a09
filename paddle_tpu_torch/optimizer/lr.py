"""Learning-rate schedulers (the port of `paddle_tpu/optimizer/lr.py`,
ref python/paddle/optimizer/lr.py — the LRScheduler family).

Pure Python on the host, as in the JAX package: an optimizer built with
a scheduler reads `float(scheduler())` in `get_lr()` before each step
and writes it into its device [lr, step] pair, so a captured train step
replays with the schedule's current value. The arithmetic is the JAX
module's, line for line, so both packages give the same floats.
"""
import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        # None included: ReduceOnPlateau's `best=None` must round-trip
        # (a resume that silently kept a stale `best` would change the
        # plateau decisions, and with them the LR trajectory)
        return {k: v for k, v in self.__dict__.items()
                if v is None or isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, sd):
        self.__dict__.update(sd)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr)
                * (1 - step / decay_steps) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = (learning_rate
                         if isinstance(learning_rate, LRScheduler) else None)
        self.target_lr = (learning_rate if not self.lr_sched else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched.last_lr
        return self.target_lr

    def state_dict(self):
        sd = super().state_dict()
        if self.lr_sched is not None:
            # nested under its own key (the wrapped LRScheduler object
            # is not base-serializable); restored explicitly below so
            # the base __dict__.update can never replace the scheduler
            # object with a plain dict
            sd["_wrapped_sched"] = self.lr_sched.state_dict()
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        nested = sd.pop("_wrapped_sched", None)
        super().set_state_dict(sd)
        if nested is not None and self.lr_sched is not None:
            self.lr_sched.set_state_dict(nested)

    set_dict = set_state_dict


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            self.last_lr = getattr(self, "last_lr", self.base_lr)
            return
        cur = float(metrics.item() if hasattr(metrics, "item") else metrics)
        if self.best is None:
            self.best = cur
        else:
            better = (cur < self.best - abs(self.best) * self.threshold
                      if self.mode == "min"
                      else cur > self.best + abs(self.best) * self.threshold) \
                if self.threshold_mode == "rel" else \
                (cur < self.best - self.threshold if self.mode == "min"
                 else cur > self.best + self.threshold)
            if better:
                self.best = cur
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = (step - up) / max(self.total_steps - up, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (
            1 + math.cos(math.pi * pct)) / 2


class MultiplicativeDecay(LRScheduler):
    """ref lr.py MultiplicativeDecay: lr_{t} = lr_{t-1} * lam(t)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        lr = self.base_lr
        for e in range(1, self.last_epoch + 1):
            lr = lr * self.lr_lambda(e)
        return lr


class CyclicLR(LRScheduler):
    """ref lr.py CyclicLR (triangular policies over a base/max band)."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = float(max_learning_rate)
        self.up = int(step_size_up)
        self.down = int(step_size_down
                        if step_size_down is not None else step_size_up)
        if self.up <= 0 or self.down <= 0:
            raise ValueError("CyclicLR step sizes must be positive")
        self.mode = mode
        self.exp_gamma = exp_gamma
        if scale_fn is not None:
            self.scale_fn, self.scale_mode = scale_fn, scale_mode
        elif mode == "triangular":
            self.scale_fn, self.scale_mode = (lambda x: 1.0), "cycle"
        elif mode == "triangular2":
            self.scale_fn = lambda x: 1.0 / (2.0 ** (x - 1))
            self.scale_mode = "cycle"
        elif mode == "exp_range":
            self.scale_fn = lambda x: exp_gamma ** x
            self.scale_mode = "iterations"
        else:
            raise ValueError(f"unknown CyclicLR mode {mode!r}")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        it = max(self.last_epoch, 0)
        cycle = it // total + 1
        pos = it % total
        frac = pos / self.up if pos < self.up \
            else 1.0 - (pos - self.up) / self.down
        span = (self.max_lr - self.base_lr) * frac
        x = cycle if self.scale_mode == "cycle" else it
        return self.base_lr + span * self.scale_fn(x)


class CosineAnnealingWarmRestarts(LRScheduler):
    """ref lr.py CosineAnnealingWarmRestarts (SGDR): cosine anneal over
    T_i, restart, T_{i+1} = T_i * T_mult."""

    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0,
                 last_epoch=-1, verbose=False):
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("T_0 must be > 0 and T_mult >= 1")
        self.T_0 = int(T_0)
        self.T_mult = int(T_mult)
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        e = max(self.last_epoch, 0)
        t_i = self.T_0
        if self.T_mult == 1:
            e = e % self.T_0            # O(1); the loop would be O(e/T_0)
        else:
            while e >= t_i:
                e -= t_i
                t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) \
            * (1 + math.cos(math.pi * e / t_i)) / 2
