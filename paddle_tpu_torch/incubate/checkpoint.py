"""Auto-checkpoint: epoch-range snapshot and restore for jobs that may be
killed and relaunched (the port of `paddle_tpu/incubate/checkpoint.py`;
ref python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py:71
AutoCheckpointChecker, :265 TrainEpochRange).

    for epoch in train_epoch_range(10, save_dir, model=m, optimizer=o):
        train_one_epoch(...)

A relaunch with the same job id skips the completed epochs, after the
model's and the optimizer's state were restored from the newest
snapshot. The layout is the JAX package's, and so are the files (the
port's `save`, which the JAX package reads):

    <save_dir or PADDLE_CKPT_DIR>/<job id>/range_meta.json
    <...>/<job id>/epoch_<n>/model.pdparams, opt.pdopt

A snapshot is written into a `.saving_*` directory and renamed into
place, then the meta file is replaced; only the newest snapshot is
kept, a constructor sweeps the temp directories a kill left behind, and
a torn meta file means a fresh start. The optimizer's tensors are saved
as the port's Tensors, so both packages read the file.

The restore writes every parameter, buffer and optimizer slot in place
(`Layer.set_state_dict`, `Optimizer.set_state_dict`), and the step count
and learning rate live on the host, copied to the device before each
step, so a `jit.TrainStep` captured before or after the restore trains
on from the restored state.
"""
import json
import os
import shutil
import tempfile

import torch

from ..framework.serialization import load as _load, save as _save
from ..framework.tensor import Tensor


class AutoCheckpointChecker:
    """The job's environment (ref auto_checkpoint.py:71): PADDLE_JOB_ID
    names the checkpoint namespace; PADDLE_CKPT_DIR overrides the
    directory."""

    def __init__(self):
        self.job_id = os.environ.get("PADDLE_JOB_ID", "default_job")
        self.ckpt_dir = os.environ.get("PADDLE_CKPT_DIR")

    @property
    def valid(self):
        return True


def _meta_path(root):
    return os.path.join(root, "range_meta.json")


def _as_tensors(obj):
    """torch tensors of a state dict as port Tensors (the file format
    both packages read)."""
    if isinstance(obj, torch.Tensor):
        return Tensor._wrap(obj.detach())
    if isinstance(obj, dict):
        return {k: _as_tensors(v) for k, v in obj.items()}
    return obj


class TrainEpochRange:
    """ref auto_checkpoint.py:265. Iterates [start, max_epoch_num);
    snapshots the model and the optimizer after every
    `save_checkpoint_inter`-th epoch and after the last; `restored_from`
    is the epoch the state came from (None on a fresh start)."""

    def __init__(self, max_epoch_num, save_dir, model=None, optimizer=None,
                 name=None, save_checkpoint_inter=1):
        checker = AutoCheckpointChecker()
        self.name = name or checker.job_id
        self.root = os.path.join(checker.ckpt_dir or save_dir, self.name)
        self.max_epoch_num = max_epoch_num
        self.model = model
        self.optimizer = optimizer
        self.inter = max(1, save_checkpoint_inter)
        self._start = 0
        os.makedirs(self.root, exist_ok=True)
        # sweep .saving_* directories orphaned by a kill mid-save
        for d in os.listdir(self.root):
            if d.startswith(".saving_"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
        self._restore()

    def _restore(self):
        meta = _meta_path(self.root)
        if not os.path.exists(meta):
            return
        try:
            with open(meta) as f:
                info = json.load(f)
        except (ValueError, OSError):
            return                  # a torn meta write: start over
        epoch = info.get("last_completed_epoch", -1)
        if epoch < 0:
            return
        snap = os.path.join(self.root, f"epoch_{epoch}")
        if self.model is not None:
            self.model.set_state_dict(
                _load(os.path.join(snap, "model.pdparams")))
        opt_file = os.path.join(snap, "opt.pdopt")
        if self.optimizer is not None and os.path.exists(opt_file):
            self.optimizer.set_state_dict(_load(opt_file))
        self._start = epoch + 1

    def _snapshot(self, epoch):
        # a temp directory renamed into place, then the meta file
        # replaced: a kill mid-save never spoils the newest usable
        # snapshot
        final = os.path.join(self.root, f"epoch_{epoch}")
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".saving_")
        try:
            if self.model is not None:
                _save(dict(self.model.state_dict()),
                      os.path.join(tmp, "model.pdparams"))
            if self.optimizer is not None and hasattr(
                    self.optimizer, "state_dict"):
                _save(_as_tensors(self.optimizer.state_dict()),
                      os.path.join(tmp, "opt.pdopt"))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with open(_meta_path(self.root) + ".tmp", "w") as f:
            json.dump({"last_completed_epoch": epoch,
                       "max_epoch_num": self.max_epoch_num}, f)
        os.replace(_meta_path(self.root) + ".tmp", _meta_path(self.root))
        # only the newest snapshot is kept (ref checkpoint_saver max_num)
        for d in os.listdir(self.root):
            if d.startswith("epoch_") and d != f"epoch_{epoch}":
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)

    def get(self):
        for epoch in range(self._start, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.inter == 0 or \
                    epoch == self.max_epoch_num - 1:
                self._snapshot(epoch)

    def __iter__(self):
        return self.get()

    @property
    def restored_from(self):
        return self._start - 1 if self._start > 0 else None


def train_epoch_range(max_epoch_num, save_dir, model=None, optimizer=None,
                      **kwargs):
    """ref auto_checkpoint.py train_epoch_range."""
    return TrainEpochRange(max_epoch_num, save_dir, model=model,
                           optimizer=optimizer, **kwargs)
