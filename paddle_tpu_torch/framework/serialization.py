"""paddle.save/load (the port of `paddle_tpu/framework/serialization.py`;
ref python/paddle/framework/io.py:202,292 — pickled nested containers of
tensors, each tensor serialised as a numpy payload).

The file format is the JAX package's, in both directions. Each tensor is
pickled as a payload object under the JAX package's global
`paddle_tpu.framework.serialization _TensorPayload`, in its layout
(`is_bf16`, `dtype`, `data` as numpy, a uint16 view for bfloat16, and
`shape`), so the JAX package's `load` reads the port's files as tensors.
`_Pickler` writes that global itself: the stock pickler's `save_global`
would import the named module to check the class, and that is the JAX
package. `_Unpickler` maps the same name back onto this module's class,
so `load` reads the port's files and the JAX package's alike, without
importing the JAX package; bfloat16 payloads come back as
`torch.bfloat16`.

Writes are ATOMIC: the payload streams into a temp file in the
destination directory, is fsync'd, and lands via `os.replace`, so a
crash mid-write leaves the previous file intact. The `latest.json`
manifest marks the newest COMPLETE checkpoint prefix in a directory and
records each file's sha256, so `latest_checkpoint(verify=True)` refuses a
params/optimizer pair torn across files (see the JAX module's docstring).
The JAX package's checkpoint-write fault point (`utils.chaos`) is not
ported (ROADMAP Queue 1 item 6).
"""
import hashlib
import json
import os
import pickle
import time

import numpy as np
import torch

from .tensor import Tensor, to_tensor

MANIFEST_NAME = "latest.json"
#: manifest schema version, the JAX package's (3): readers accept older
#: manifests (missing version == 1)
MANIFEST_VERSION = 3
#: module of the JAX package's payload class, as its pickles name it
_JAX_MODULE = "paddle_tpu.framework.serialization"


class _TensorPayload:
    """Pickle-stable wrapper recording dtype/shape + raw bytes (the JAX
    package's layout: `is_bf16`, `dtype`, `data`, `shape`)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().cpu()
        # bfloat16 has no numpy dtype: stored as a uint16 view
        self.is_bf16 = t.dtype == torch.bfloat16
        if self.is_bf16:
            self.dtype = "bfloat16"
            self.data = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.resolve_conj().numpy()
            self.dtype = arr.dtype.str
            self.data = arr
        self.shape = tuple(t.shape)

    def restore(self):
        """The payload as a CPU torch tensor."""
        data = np.ascontiguousarray(self.data)
        if self.is_bf16:
            return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(data)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing `_TensorPayload` under the JAX
    package's global without importing it."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_JAX_MODULE)
            self.save("_TensorPayload")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_JAX_MODULE}\n_TensorPayload\n"
                       .encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX_MODULE and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, Tensor):
        return _TensorPayload(obj._data)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        t = obj.restore()
        if return_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return to_tensor(t)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_unpack(v, return_numpy) for v in obj)
    return obj


class _CheckpointSink:
    """File wrapper that accumulates the payload's sha256 while the
    pickle streams through (recorded in the manifest)."""

    def __init__(self, f):
        self._f = f
        self._sha = hashlib.sha256()

    def write(self, data):
        n = self._f.write(data)
        self._sha.update(data)
        return n

    def hexdigest(self):
        return self._sha.hexdigest()


def _tmp_path(path):
    return f"{path}.tmp.{os.getpid()}"


def _makedirs_for(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _atomic_write(target, write_fn):
    """The one crash-atomic write path (checkpoints AND the manifest):
    `write_fn(f)` streams the payload into a temp file in the target's
    directory, then flush + fsync + `os.replace` — the target is either
    its old bytes or the new ones, never a prefix, and a failure leaves
    no `.tmp` litter. Returns write_fn's result."""
    tmp = _tmp_path(target)
    try:
        with open(tmp, "wb") as f:
            out = write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return out


def save(obj, path, protocol=4, **configs):
    """Atomic paddle.save: the pickle STREAMS into a temp file (no
    second in-memory copy of the checkpoint), then fsync + os.replace —
    the destination is either the old bytes or the new bytes, never a
    prefix of the new ones. Returns the payload's sha256 hexdigest
    (for the checkpoint manifest)."""
    path = os.fspath(path)
    _makedirs_for(path)

    def _write(f):
        sink = _CheckpointSink(f)
        _Pickler(sink, protocol=protocol).dump(_pack(obj))
        return sink.hexdigest()

    return _atomic_write(path, _write)


def load(path, return_numpy=False, **configs):
    """Tensors land on the current place; `return_numpy=True` gives numpy
    arrays (float32 for bfloat16). Unpickling runs code: load only files
    this program or the JAX package wrote."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy)


# ---------------------------------------------------------------------------
# latest-checkpoint manifest
# ---------------------------------------------------------------------------

def write_manifest(path, step=None, files=None):
    """Atomically mark checkpoint prefix `path` as the newest COMPLETE
    checkpoint of its directory (call only after every file of the
    checkpoint landed). `files` maps basename -> sha256 hexdigest as
    returned by `save` (a bare iterable of names is accepted, recorded
    without digests — those files get an existence check only at
    verify time). Returns the manifest dict written."""
    path = os.fspath(path)
    if files is None:
        files = {}
    elif not isinstance(files, dict):
        files = {name: None for name in files}
    doc = {"version": MANIFEST_VERSION,
           "path": os.path.basename(path),
           "step": None if step is None else int(step),
           "time_unix": round(time.time(), 3),
           "files": {name: files[name] for name in sorted(files)}}
    d = os.path.dirname(os.path.abspath(path))
    target = os.path.join(d, MANIFEST_NAME)
    _atomic_write(target, lambda f: f.write(
        (json.dumps(doc, indent=1) + "\n").encode()))
    return doc


def read_manifest(directory):
    """The directory's manifest dict, or None (missing/unparseable —
    an unparseable manifest means no complete checkpoint is KNOWN,
    which is the safe answer after a torn legacy write)."""
    try:
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and doc.get("path") else None


def _file_sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def verify_checkpoint(directory, doc):
    """True when every file the manifest lists is present and (where a
    digest was recorded) byte-identical to what the manifest's save
    wrote — i.e. the params/optimizer pair on disk really is the pair
    the manifest promised. False on any missing/mismatched file: the
    classic cause is a crash while RE-saving to the same prefix (new
    `.pdparams` already replaced in place, manifest + `.pdopt` still
    the old save's)."""
    files = doc.get("files") or {}
    if not isinstance(files, dict):          # legacy list-form manifest
        files = {name: None for name in files}
    for name, digest in files.items():
        p = os.path.join(directory, name)
        try:
            if digest is None:
                if not os.path.exists(p):
                    return False
            elif _file_sha256(p) != digest:
                return False
        except OSError:
            return False
    return True


def latest_checkpoint(directory, verify=True):
    """Prefix (joined onto `directory`) of the newest complete
    checkpoint, or None when the directory has no manifest — or when
    `verify` (the default) finds the files on disk torn relative to
    the manifest's recorded digests (see `verify_checkpoint`)."""
    doc = read_manifest(directory)
    if doc is None:
        return None
    if verify and not verify_checkpoint(directory, doc):
        return None
    return os.path.join(directory, doc["path"])
