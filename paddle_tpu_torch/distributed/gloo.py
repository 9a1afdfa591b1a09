"""Host-side collectives and their key-value stores (the port of
`paddle_tpu/distributed/gloo.py`, the GlooWrapper analog; ref
framework/fleet/gloo_wrapper.h:113, fleet/base/role_maker.py:33).

The launcher's rendezvous and `fleet.util`'s barriers and gathers
synchronise outside the accelerator, over a key-value store:

  - KVStore / KVClient — torch's `TCPStore` (set, get with a wait, add,
                         delete): the store's master and a client;
  - FileKVStore        — one file per key on a shared filesystem (the
                         file-store analog);
  - HostCollective     — barrier, all_gather, broadcast and a small numpy
                         all_reduce over either store, with the JAX
                         package's generation keys: each call uses fresh
                         keys, and completing generation g lets rank 0
                         delete generation g-1's.

Values are bytes; nothing is unpickled.
"""
import base64
import datetime
import os
import time

import numpy as np
from torch.distributed import TCPStore


def _delta(seconds):
    return datetime.timedelta(seconds=float(seconds))


class KVClient:
    """A client of a KVStore at host:port."""

    def __init__(self, host="127.0.0.1", port=None, _store=None):
        self._store = _store if _store is not None else TCPStore(
            host, int(port), is_master=False, timeout=_delta(120))

    def set(self, key, val: bytes):
        self._store.set(key, val)

    def get(self, key, timeout=60) -> bytes:
        try:
            self._store.wait([key], _delta(timeout))
        except RuntimeError as e:       # torch's DistStoreError
            raise RuntimeError(f"kv store: timeout on {key!r}") from e
        return self._store.get(key)

    def add(self, key, delta=1) -> int:
        return int(self._store.add(key, int(delta)))

    def delete(self, key):
        self._store.delete_key(key)

    def close(self):
        self._store = None


class KVStore(KVClient):
    """The store's master: a TCPStore server on `port` (0 = a free one,
    read back as `.port`), itself a client. Start it on rank 0 (or the
    launcher); every rank connects with KVClient."""

    def __init__(self, port=0, host="0.0.0.0"):
        store = TCPStore(host, int(port), is_master=True,
                         wait_for_workers=False, timeout=_delta(120))
        super().__init__(_store=store)
        self.port = store.port

    def stop(self):
        self._store = None


class FileKVStore:
    """Shared-filesystem store (ref role_maker file-store rendezvous):
    one file per key under `root`; works across hosts on NFS-like FS."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        safe = base64.urlsafe_b64encode(key.encode()).decode()
        return os.path.join(self.root, safe)

    def set(self, key, val: bytes):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(val)
        os.replace(tmp, self._path(key))

    def get(self, key, timeout=60) -> bytes:
        deadline = time.time() + timeout
        p = self._path(key)
        while time.time() < deadline:
            try:
                with open(p, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                time.sleep(0.02)
        raise RuntimeError(f"kv store: timeout on {key!r}")

    def add(self, key, delta=1) -> int:
        # cross-process atomicity via a lock file
        lock = self._path(key) + ".lock"
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.005)
        try:
            try:
                cur = int(self.get(key, timeout=0.01))
            except RuntimeError:
                cur = 0
            cur += delta
            self.set(key, str(cur).encode())
            return cur
        finally:
            os.close(fd)
            os.unlink(lock)

    def delete(self, key):
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def close(self):
        pass


class HostCollective:
    """Rank/world collectives over a kv store (GlooWrapper analog).
    Generation counters make the primitives reusable (each call uses a
    fresh key namespace), and each completed generation deletes the
    previous generation's keys: completing gen g proves every rank
    finished gen g-1, so the store stays O(world) keys per primitive."""

    def __init__(self, rank, world, store, scope="default"):
        self.rank = int(rank)
        self.world = int(world)
        self.store = store
        self.scope = scope
        self._gen = {}
        self._prev_keys = {}   # kind -> keys of the previous generation

    def _key(self, kind):
        g = self._gen.get(kind, 0)
        self._gen[kind] = g + 1
        return f"{self.scope}/{kind}/{g}"

    def _cleanup(self, kind, keys):
        """On completing a generation: rank 0 deletes the previous
        generation's keys and remembers this one's for next time."""
        if self.rank == 0:
            for k in self._prev_keys.get(kind, ()):
                self.store.delete(k)
        self._prev_keys[kind] = keys

    def barrier(self, timeout=120):
        key = self._key("barrier")
        n = self.store.add(key, 1)
        done = f"{key}/done"
        if n == self.world:
            self.store.set(done, b"1")
        self.store.get(done, timeout=timeout)
        self._cleanup("barrier", [key, done])

    def all_gather(self, data: bytes, timeout=120):
        """Every rank's bytes, in rank order."""
        base = self._key("allgather")
        self.store.set(f"{base}/{self.rank}", data)
        out = [self.store.get(f"{base}/{r}", timeout=timeout)
               for r in range(self.world)]
        self._cleanup("allgather",
                      [f"{base}/{r}" for r in range(self.world)])
        return out

    def broadcast(self, data, src=0, timeout=120):
        base = self._key("bcast")
        if self.rank == src:
            self.store.set(base, data)
        else:
            data = self.store.get(base, timeout=timeout)
        self._cleanup("bcast", [base])
        return data

    def all_reduce(self, arr, op="sum", timeout=120):
        """Small-array host allreduce (metrics, role bookkeeping)."""
        a = np.asarray(arr)
        parts = self.all_gather(a.tobytes(), timeout=timeout)
        stack = np.stack([np.frombuffer(p, dtype=a.dtype).reshape(a.shape)
                          for p in parts])
        if op == "sum":
            return stack.sum(axis=0)
        if op == "max":
            return stack.max(axis=0)
        if op == "min":
            return stack.min(axis=0)
        raise ValueError(f"unknown op {op!r}")


def collective_from_env():
    """A HostCollective from the launcher's environment, or None outside
    a distributed run. Honors PADDLE_GLOO_HTTP_ENDPOINT (a KVStore's
    host:port) and PADDLE_GLOO_FS_PATH (a shared-filesystem store) like
    the reference role_maker."""
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if world <= 1:
        return None
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    ep = os.environ.get("PADDLE_GLOO_HTTP_ENDPOINT")
    if ep:
        host, port = ep.rsplit(":", 1)
        return HostCollective(rank, world, KVClient(host, port))
    fs = os.environ.get("PADDLE_GLOO_FS_PATH")
    if fs:
        return HostCollective(rank, world, FileKVStore(fs))
    return None
