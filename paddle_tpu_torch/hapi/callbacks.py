"""hapi callbacks (the port of `paddle_tpu/hapi/callbacks.py`; ref
python/paddle/hapi/callbacks.py: Callback, ProgBarLogger, ModelCheckpoint,
LRScheduler, EarlyStopping, ReduceLROnPlateau, VisualDL). Host-side
Python over the logs `Model.fit` hands them. `TelemetryCallback` feeds
the telemetry gauges, which are ROADMAP Queue 1 item 6: it raises."""
import numbers
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def on_begin(self, mode, logs=None):
        self.set_params(logs)
        for cb in self.callbacks:
            cb.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for cb in self.callbacks:
            cb.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for cb in self.callbacks:
            cb.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for cb in self.callbacks:
            cb.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = []
            for k, v in (logs or {}).items():
                if isinstance(v, numbers.Number):
                    items.append(f"{k}: {v:.4f}")
            print(f"step {step}: " + ", ".join(items))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = [f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                     if isinstance(v, numbers.Number)]
            dt = time.time() - getattr(self, "_t0", time.time())
            print(f"Epoch {epoch}: " + ", ".join(items) + f" ({dt:.1f}s)")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:                     # explicit: 0.0 is a real value
            cur = logs.get(f"eval_{self.monitor}")
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class ReduceLROnPlateau(Callback):
    """ref hapi/callbacks.py ReduceLROnPlateau: scale the optimizer lr by
    `factor` after `patience` epochs without `monitor` improvement."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:                     # explicit: 0.0 is a real value
            cur = logs.get(f"eval_{self.monitor}")
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.cooldown_counter > 0:
            # in cooldown: no patience counting at all (ref semantics)
            self.cooldown_counter -= 1
            self.wait = 0
            return
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = self.model._optimizer
            try:
                new_lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(new_lr)
            except (RuntimeError, TypeError) as e:
                # an LRScheduler owns the lr: warn once and stand down
                import warnings
                warnings.warn(f"ReduceLROnPlateau: cannot adjust lr "
                              f"({e}); disable the scheduler to use this "
                              "callback")
                self.patience = float("inf")
                return
            if self.verbose:
                print(f"ReduceLROnPlateau: epoch {epoch}: lr -> {new_lr}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class TelemetryCallback(Callback):
    """The JAX package's unified-telemetry training callback (step-time
    histogram, loss gauge, device-memory gauges, anomaly alerts). The
    port has no telemetry registry yet: ROADMAP Queue 1 item 6."""

    def __init__(self, memory_freq=10, device=None, sampler=None,
                 alerts=None):
        raise NotImplementedError(
            "hapi.callbacks.TelemetryCallback: the telemetry, timeseries "
            "and anomaly utilities are not ported yet (ROADMAP Queue 1 "
            "item 6)")


class VisualDL(Callback):
    """Stub writer: VisualDL isn't installed in this image; logs to a jsonl."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def on_train_begin(self, logs=None):
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(f"{self.log_dir}/scalars.jsonl", "a")

    def on_train_batch_end(self, step, logs=None):
        if self._f:
            import json
            clean = {k: float(v) for k, v in (logs or {}).items()
                     if isinstance(v, numbers.Number)}
            self._f.write(json.dumps({"step": step, **clean}) + "\n")

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
