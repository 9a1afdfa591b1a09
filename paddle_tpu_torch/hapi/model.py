"""hapi Model: Keras-like fit/evaluate/predict (the port of
`paddle_tpu/hapi/model.py`; ref python/paddle/hapi/model.py:810 fit,
:1299 predict).

`fit` streams DataLoader batches into one `jit.TrainStep` (forward,
loss, backward and the optimizer's update; on the card one CUDA graph
replay per batch after the eager first call and the capture) and reads
the loss back to the host every step (`float(loss)`), as the JAX
package does; so does a metric's `update`. `evaluate` and `predict` run
the network eagerly under `no_grad`, batch by batch, as the JAX
package's do. `_timed_iter` measures how long each batch kept the loop
waiting; `fit` returns those waits in its history (`"data_wait_s"`)
beside the losses.

The step is built, as the JAX package builds it, through
`distributed.fleet.base.build_train_step`: a `jit.TrainStep`, or a
`ShardedTrainStep` when the current mesh holds more than one rank. The
flight recorder,
the training watchdog, the resume and reshard journal events and the
data-load chaos hook are ROADMAP Queue 1 item 6: `flight_recorder=` and
`watchdog=` raise. Full-state checkpoints (`save`, `load_latest`,
`fit(resume=True)`) are ported: `.pdparams`, `.pdopt` and `.pdtrain`
under the `latest.json` manifest of `framework.serialization`.
"""
import os
import time

import numpy as np
import torch

from ..framework import serialization
from ..framework import state
from ..framework.tensor import Tensor, to_tensor, unwrap
from ..utils import resume as resume_mod
from . import callbacks as cbks


def _timed_iter(loader, skip=0):
    """Yield (batch_idx, data_wait_seconds, batch): the epoch-relative
    batch index (the resume fast-forward included, so the wait and the
    resume cursor count batches alike) and how long the input pipeline
    kept the train loop waiting for each batch.

    `skip` fast-forwards a resumed epoch: a reader with `iter_from`
    (DataLoader has it) seeks, the sampler's draws replayed and the
    dataset's fetches skipped; anything else is fetched and discarded.
    The skipped batches' wall time counts in the first yielded batch's
    wait."""
    skip = max(0, int(skip))
    pending = 0.0
    if skip:
        t0 = time.perf_counter()
        if hasattr(loader, "iter_from"):
            it = loader.iter_from(skip)
        else:
            it = iter(loader)
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    return
        pending = time.perf_counter() - t0
    else:
        it = iter(loader)
    idx = skip
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        yield idx, pending + (time.perf_counter() - t0), batch
        pending = 0.0
        idx += 1


def _as_tensor(x):
    """A Tensor or torch tensor as it is; host data as a Tensor on the
    current place."""
    return x if isinstance(x, (Tensor, torch.Tensor)) else to_tensor(x)


def _not_ported(option):
    return NotImplementedError(
        f"Model.fit({option}=...): the flight recorder and the training "
        f"watchdog are not ported yet (ROADMAP Queue 1 item 6)")


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self.mode = "train"       # ref hapi Model.mode: train|eval|test
        self._metrics = []
        self._train_step = None
        self._scaler = None
        self._fit_cursor = None       # {"epoch","batch","epoch_numpy_rng"}
        self._resume_state = None     # stashed by load_latest for fit(resume=)
        self.stop_training = False

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        self._amp_configs = amp_configs
        # a GradScaler handed in through amp_configs (the instance
        # itself, or {"scaler": scaler}) joins the full-state
        # checkpoint: save() captures its scale and counters and
        # load_latest restores them (utils/resume.py)
        from ..amp import GradScaler
        self._scaler = None
        if isinstance(amp_configs, GradScaler):
            self._scaler = amp_configs
        elif isinstance(amp_configs, dict) and \
                isinstance(amp_configs.get("scaler"), GradScaler):
            self._scaler = amp_configs["scaler"]

    def _loss_fn(self, *args):
        # split model outputs from labels by loss arity: loss(out..., label...)
        return self._loss(*args)

    # ------------------------------------------------------------- training
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, flight_recorder=None,
            resume=False, save_steps=None, watchdog=None):
        """Train. Returns the history: the loss of every step
        (`"loss"`) and the time each step waited for its batch
        (`"data_wait_s"`). Beyond the reference surface:

        * `save_dir`/`save_freq`: per-epoch checkpoints
          (`{save_dir}/{epoch}` and `final`, via ModelCheckpoint);
          `save_steps=N` instead checkpoints every N global steps to
          `{save_dir}/step{n}` prefixes.
        * `resume=True`: continue the run a prior `load_latest`
          restored: the data cursor fast-forwards to the checkpoint's
          (epoch, batch) with the epoch-start numpy RNG replayed (the
          same shuffle permutation), and the step counter, the random
          streams, the LR schedule and the scaler continue.
        """
        if flight_recorder is not None:
            raise _not_ported("flight_recorder")
        if watchdog is not None and watchdog is not False:
            raise _not_ported("watchdog")
        from ..io import DataLoader, Dataset
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        auto_cbs = []
        if save_dir and not save_steps:
            auto_cbs.append(cbks.ModelCheckpoint(save_freq, save_dir))
        cb_list = cbks.CallbackList(list(callbacks or []) + auto_cbs)
        cb_list.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        # resume target (stashed by load_latest; consumed exactly once)
        resume_info = None
        # only this fit's resume may arm the drift check
        self._resume_sharding = None
        if resume:
            resume_info, self._resume_state = self._resume_state, None
        if resume_info is not None:
            # the first step built is checked against the checkpoint's
            # sharding record (train_batch_parts)
            self._resume_sharding = resume_info.get("sharding")
        start_epoch, start_batch, epoch_rng_snapshot = 0, 0, None
        if resume_info and resume_info.get("cursor"):
            cur = resume_info["cursor"]
            start_epoch = max(0, int(cur.get("epoch") or 0))
            start_batch = max(0, int(cur.get("batch") or 0))
            epoch_rng_snapshot = cur.get("epoch_numpy_rng")
        history = {"loss": [], "data_wait_s": []}
        it_count = 0
        logs = {}
        cb_list.on_begin("train", {"epochs": epochs, "steps": steps,
                                   "verbose": verbose,
                                   "metrics": self._metric_names()})
        completed = True
        for epoch in range(epochs):
            if epoch < start_epoch:
                continue
            skip = start_batch if epoch == start_epoch else 0
            if skip and epoch_rng_snapshot is not None:
                # replay the in-progress epoch's data order: the shuffle
                # permutation (and any numpy transform draws the
                # fast-forward replays) redraw from the epoch-start
                # state the original run had
                state.set_numpy_rng_state(epoch_rng_snapshot)
            epoch_rng = state.numpy_rng_state()
            cb_list.on_epoch_begin(epoch)
            self.network.train()
            for bidx, data_s, batch in _timed_iter(train_loader, skip=skip):
                cb_list.on_batch_begin("train", bidx, logs)
                loss, metrics = self.train_batch_parts(batch)
                logs = {"loss": loss, **metrics, "batch_size": batch_size}
                history["loss"].append(loss)
                history["data_wait_s"].append(data_s)
                # the cursor a checkpoint records: `batch` counts batches
                # CONSUMED this epoch, the fast-forward target of a resume
                self._fit_cursor = {"epoch": epoch, "batch": bidx + 1,
                                    "epoch_numpy_rng": epoch_rng}
                if save_steps and save_dir:
                    gstep = self._optimizer._global_step
                    if gstep % int(save_steps) == 0:
                        self.save(os.path.join(save_dir, f"step{gstep}"))
                cb_list.on_batch_end("train", bidx, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            for m in self._metrics:
                logs[self._name_of(m)] = m.accumulate()
                m.reset()
            cb_list.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                completed = False
                break
        if completed:
            # end-of-training cursor: a final save resumes to "nothing
            # left" instead of replaying the last epoch
            self._fit_cursor = {"epoch": int(epochs), "batch": 0,
                                "epoch_numpy_rng": state.numpy_rng_state()}
        cb_list.on_end("train", logs)
        self._sync_step()
        return history

    def train_batch_parts(self, batch):
        """One step on a loader batch: (loss, {metric name: value})."""
        from ..distributed.fleet.base import build_train_step
        from ..optimizer.lr import LRScheduler
        inputs, labels = self._split_batch(batch)
        if self._train_step is None:
            self._train_step = build_train_step(
                self.network, self._loss_fn, self._optimizer,
                return_outputs=bool(self._metrics))
        shard_doc = getattr(self, "_resume_sharding", None)
        if shard_doc:
            self._resume_sharding = None
            self._warn_resume_sharding_drift(shard_doc)
        result = self._train_step(inputs, labels)
        if self._metrics and self._train_step.return_outputs:
            loss_t, outs = result
            metric_logs = {}
            for m in self._metrics:
                res = m.compute(*outs, *labels)
                val = m.update(*res) if isinstance(res, tuple) \
                    else m.update(res)
                metric_logs[self._name_of(m)] = val
        else:
            loss_t = result[0] if isinstance(result, tuple) else result
            metric_logs = {}
        loss = float(unwrap(loss_t))
        if isinstance(self._optimizer._lr, LRScheduler):
            self._optimizer._lr.step()
        return loss, metric_logs

    def _warn_resume_sharding_drift(self, shard_doc):
        """The checkpoint's sharding record against the step this resume
        built: a resume that lost the sharded step, its `zero_stage` or
        its `exact_reshard` still runs, but off the checkpointed run's
        layout and parity contract, so it warns (the JAX package's
        message). The JAX package also journals a flight-recorder
        `fault`; the flight recorder is ROADMAP Queue 1 item 6."""
        step = self._train_step
        drift = {}
        state_fn = getattr(step, "sharding_state", None)
        if state_fn is None:
            drift["step"] = (f"sharded ({shard_doc.get('mesh')})",
                             type(step).__name__)
        else:
            now = state_fn()
            for key in ("zero_stage", "exact_reshard"):
                want = shard_doc.get(key)
                if want is not None and now.get(key) != want:
                    drift[key] = (want, now.get(key))
        if not drift:
            return
        import warnings
        desc = "; ".join(f"{k}: checkpoint={a!r} resumed={b!r}"
                         for k, (a, b) in sorted(drift.items()))
        warnings.warn(
            f"resume dropped the checkpoint's sharding configuration "
            f"({desc}) — the resumed run will not follow the "
            "checkpointed run's layout/parity contract (re-apply the "
            "fleet sharding strategy before fit(resume=True))",
            stacklevel=3)

    def train_batch(self, inputs, labels=None):
        """Single train step (ref hapi/model.py train_batch)."""
        from ..distributed.fleet.base import build_train_step
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else (
            [labels] if labels is not None else [])
        if self._train_step is None:
            self._train_step = build_train_step(self.network, self._loss_fn,
                                                self._optimizer)
        result = self._train_step(tuple(_as_tensor(i) for i in inputs),
                                  tuple(_as_tensor(lab) for lab in labels))
        loss = result[0] if isinstance(result, tuple) else result
        return [float(unwrap(loss))]

    # ------------------------------------------------------------- eval/pred
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader, Dataset
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size)
        else:
            loader = eval_data
        self._sync_step()
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        with state.no_grad_ctx():
            for batch in loader:
                inputs, labels = self._split_batch(batch)
                outs = self.network(*[_as_tensor(b) for b in inputs])
                outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
                if self._loss is not None:
                    losses.append(float(unwrap(
                        self._loss_fn(*outs_t, *labels))))
                for m in self._metrics:
                    res = m.compute(*outs_t, *labels)
                    m.update(*res) if isinstance(res, tuple) else m.update(res)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[self._name_of(m)] = m.accumulate()
        self.network.train()
        return logs

    def summary(self, input_size=None, dtype=None):
        """ref hapi Model.summary -> the module-level summary() printer."""
        return summary(self.network, input_size=input_size)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size)
        else:
            loader = test_data
        self._sync_step()
        self.network.eval()
        outputs = []
        with state.no_grad_ctx():
            for batch in loader:
                inputs, _ = self._split_batch(batch, allow_no_label=True)
                outs = self.network(*[_as_tensor(b) for b in inputs])
                outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
                outputs.append([o.numpy() for o in outs_t])
        self.network.train()
        n_out = len(outputs[0])
        grouped = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g) for g in grouped]
        return grouped

    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.network.eval()
        with state.no_grad_ctx():
            outs = self.network(*[_as_tensor(i) for i in inputs])
        self.network.train()
        outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
        return [o.numpy() for o in outs_t]

    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        self.network.eval()
        with state.no_grad_ctx():
            outs = self.network(*[_as_tensor(i) for i in inputs])
            outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
            loss = self._loss_fn(*outs_t, *[_as_tensor(lab)
                                            for lab in labels])
        self.network.train()
        return [float(unwrap(loss))]

    # ------------------------------------------------------------- save/load
    def save(self, path, training=True):
        """Crash-safe full-state checkpoint: each file is written
        atomically (framework.serialization: temp + fsync + os.replace),
        and the directory's `latest.json` manifest, which records each
        file's sha256, is updated only after every file landed. A
        training save writes `.pdparams` (parameters and buffers),
        `.pdopt` (the optimizer's accumulators, global step and
        LR-scheduler state) and `.pdtrain` (utils/resume.py: the random
        streams, the numpy RNG, the data cursor, the GradScaler's state),
        everything `load_latest` + `fit(resume=True)` need to continue
        the run. A params-only save removes a stale `.pdopt`/`.pdtrain`
        of the same prefix. A sharded step's state is gathered first
        (`sync`), and its placement record (`sharding_state`) goes into
        `.pdtrain`."""
        self._sync_step()
        step = None if self._optimizer is None else (
            self._optimizer._global_step or None)
        base = os.path.basename(path)
        files = {base + ".pdparams":
                 serialization.save(dict(self.network.state_dict()),
                                    path + ".pdparams")}
        if training and self._optimizer is not None:
            files[base + ".pdopt"] = serialization.save(
                self._optimizer.state_dict(), path + ".pdopt")
        elif os.path.exists(path + ".pdopt"):
            os.unlink(path + ".pdopt")
        if training:
            sharding_fn = getattr(self._train_step, "sharding_state", None)
            doc = resume_mod.capture_train_state(
                cursor=self._fit_cursor, step=step, scaler=self._scaler,
                sharding=None if sharding_fn is None else sharding_fn())
            files[base + ".pdtrain"] = serialization.save(
                doc, path + ".pdtrain")
        elif os.path.exists(path + ".pdtrain"):
            os.unlink(path + ".pdtrain")
        serialization.write_manifest(path, step=step, files=files)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        sd = serialization.load(path + ".pdparams")
        self.network.set_state_dict(sd)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(
                serialization.load(path + ".pdopt"))
        self._train_step = None  # a new step over the restored state

    def load_latest(self, directory, restore_train_state=True, **kw):
        """Resume from the newest complete checkpoint in `directory`
        (the `latest.json` manifest `save` keeps; its sha256 digests are
        checked against the files before loading). Returns the prefix
        loaded, or None when the directory has no manifest or its files
        are torn. With a `.pdtrain` file and `restore_train_state`, the
        random streams and the Model's GradScaler are restored in place
        and the data cursor is kept for the next `fit(resume=True)`."""
        prefix = serialization.latest_checkpoint(directory)
        if prefix is None:
            return None
        doc = serialization.read_manifest(directory)
        listed = set((doc or {}).get("files") or {})
        base = os.path.basename(prefix)
        if base + ".pdopt" not in listed:
            # an on-disk .pdopt the manifest does not list belongs to
            # some other save: never pair it with these params
            kw["reset_optimizer"] = True
        self.load(prefix, **kw)
        self._resume_state = None
        state_path = prefix + ".pdtrain"
        if restore_train_state and base + ".pdtrain" in listed \
                and os.path.exists(state_path):
            state_doc = serialization.load(state_path)
            self._resume_state = resume_mod.apply_train_state(
                state_doc, scaler=self._scaler)
        return prefix

    def parameters(self):
        return self.network.parameters()

    # ------------------------------------------------------------- helpers
    def _sync_step(self):
        """The step's state into the network and the optimizer (a ZeRO-1
        step gathers its moment chunks; collective: every rank calls it
        at the same points)."""
        if self._train_step is not None:
            self._train_step.sync()

    def _split_batch(self, batch, allow_no_label=False):
        if isinstance(batch, dict):
            batch = list(batch.values())
        batch = list(batch)
        n_labels = len(self._labels) if self._labels else 1
        if allow_no_label and len(batch) == 1:
            return batch, []
        inputs = batch[:-n_labels] if len(batch) > n_labels else batch[:1]
        labels = batch[len(inputs):]
        return inputs, labels

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            names.append(self._name_of(m))
        return names

    @staticmethod
    def _name_of(m):
        n = m.name()
        return n if isinstance(n, str) else n[0]


def summary(net, input_size=None, dtypes=None, input=None):
    """paddle.summary analog: prints each parameter's name, shape and
    size; returns the total and trainable counts."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(p.shape)) if p.shape else 1
        total += n
        if p.trainable:
            trainable += n
        rows.append((name, p.shape, n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = ["-" * (width + 30)]
    for name, shp, n in rows:
        lines.append(f"{name:<{width}}{str(shp):<20}{n:>10,}")
    lines.append("-" * (width + 30))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
