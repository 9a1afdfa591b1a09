"""Multiprocess DataLoader workers with shared-memory batch transport
(the port of `paddle_tpu/io/multiprocess.py`; ref
python/paddle/fluid/dataloader/dataloader_iter.py:469
_DataLoaderIterMultiProcess + paddle/fluid/memory/allocation/
mmap_allocator.h).

Forked workers fetch and collate index batches and write each numpy
array of a batch into one POSIX shared-memory segment; only the segment
name and the array headers cross the result queue. The parent maps the
segment, copies each array out (straight into pinned host memory when
the loader feeds the card) and unlinks it. The parent starts its
multiprocessing resource tracker before it forks, so the workers
register their segments with it: a worker that exits keeps the segments
the parent has not read yet (in the JAX package a worker forked before
the parent had a tracker starts its own, which unlinks them when the
worker exits, and a consumer slower than the workers' last batches
finds one gone), and the tracker unlinks what is left when the parent
exits. Segment names carry the parent's pid and the epoch's iterator
(`ptt<pid>_<n>_<seq>`), so `close()` unlinks every segment of the epoch
nobody read, the ones a terminated worker made included. A watchdog in
the parent's receive loop stands in for the reference's SIGCHLD
handler: a dead worker is found by polling exit codes and tears the
loader down naming the worker, instead of hanging on the queue. Batches
are re-ordered by sequence id, so a shuffled epoch comes out in the
single-process loader's order.

The workers are forked after the parent may have initialised CUDA, so
they never touch it: they build no `Tensor` (the parent's `_wrap` does)
and run torch's CPU ops (a transform's resize) on one intra-op thread.
"""
import itertools
import multiprocessing as mp
import os
import queue as pyqueue
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

_FORK = mp.get_context("fork")
# numbers the epochs (MultiprocessLoaderIter) of this process: part of
# their segments' names
_EPOCHS = itertools.count()
# where POSIX shared memory lives on Linux
_SHM_DIR = "/dev/shm"


def segment_prefix(pid, epoch):
    """The name prefix of an epoch's segments."""
    return f"ptt{pid}_{epoch}_"


def _unlink(name):
    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    seg.unlink()


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a worker: (id, num_workers, dataset); None in the parent
    (ref dataloader/worker.py get_worker_info)."""
    return _worker_info


def _pack(seq, batch, name):
    """Collated batch (list/tuple/dict of np arrays) -> the shm segment
    `name` + meta."""
    if isinstance(batch, dict):
        keys = list(batch.keys())
        arrays = [np.ascontiguousarray(np.asarray(batch[k])) for k in keys]
    else:
        keys = None
        arrays = [np.ascontiguousarray(np.asarray(a)) for a in
                  (batch if isinstance(batch, (list, tuple)) else [batch])]
    total = sum(a.nbytes for a in arrays) or 1
    shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    metas = []
    off = 0
    for a in arrays:
        np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)[...] = a
        metas.append((str(a.dtype), a.shape, off))
        off += a.nbytes
    name = shm.name
    shm.close()
    return {"seq": seq, "shm": name, "metas": metas, "keys": keys}


def _torch_dtype(dtype):
    """The torch dtype of a numpy dtype, or None where torch has none."""
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None


def _unpack(msg, pin=False):
    """The batch of a worker's message, its segment unlinked: numpy
    arrays, or with `pin` pinned torch host tensors (arrays torch cannot
    hold stay numpy)."""
    shm = shared_memory.SharedMemory(name=msg["shm"])
    out = []
    for dtype, shape, off in msg["metas"]:
        src = np.ndarray(shape, dtype, buffer=shm.buf, offset=off)
        tdt = _torch_dtype(src.dtype) if pin else None
        if tdt is not None:
            dst = torch.empty(shape, dtype=tdt, pin_memory=True)
            dst.numpy()[...] = src
        else:
            dst = src.copy()
        del src             # no view of the segment may outlive close()
        out.append(dst)
    shm.close()
    shm.unlink()
    if msg["keys"] is not None:
        return dict(zip(msg["keys"], out))
    return out


def _worker_loop(worker_id, num_workers, dataset, collate_fn, index_queue,
                 out_queue, iterable_mode, batch_size, drop_last,
                 worker_init_fn, prefix):
    global _worker_info
    _worker_info = _WorkerInfo(worker_id, num_workers, dataset)
    # the workers share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    try:
        if iterable_mode:
            # each worker owns a strided shard of the stream
            it = iter(dataset)
            seq = worker_id
            stream = itertools.islice(it, worker_id, None, num_workers)
            while True:
                batch = list(itertools.islice(stream, batch_size))
                if not batch or (len(batch) < batch_size and drop_last):
                    break
                out_queue.put(_pack(seq, collate_fn(batch), prefix + str(seq)))
                seq += num_workers
            out_queue.put({"done": worker_id})
            return
        while True:
            item = index_queue.get()
            if item is None:
                out_queue.put({"done": worker_id})
                return
            seq, idxs = item
            out_queue.put(_pack(seq, collate_fn([dataset[i] for i in idxs]),
                                prefix + str(seq)))
    except KeyboardInterrupt:
        pass
    except BaseException as e:  # surface the traceback in the parent
        import traceback
        out_queue.put({"error": f"{type(e).__name__}: {e}",
                       "tb": traceback.format_exc(), "worker": worker_id})


class MultiprocessLoaderIter:
    """One epoch of forked-worker loading. Iterate to exhaustion or
    close(). `pin` unpacks into pinned host memory (`_unpack`)."""

    def __init__(self, loader, pin=False):
        self.loader = loader
        self._pin = pin
        n = loader.num_workers
        self.n = n
        self._iterable = loader._iterable_mode
        self._window = max(2, n * loader.prefetch_factor)
        # bounded out queue = the backpressure that stops workers from
        # materialising the whole epoch into /dev/shm
        self._out = _FORK.Queue(maxsize=self._window)
        self._index_queues = []
        self._workers = []
        self._timeout = float(loader.timeout) if loader.timeout else None
        self._prefix = segment_prefix(os.getpid(), next(_EPOCHS))
        # the workers inherit the running tracker: see the module's doc
        resource_tracker.ensure_running()
        for w in range(n):
            iq = _FORK.Queue() if not self._iterable else None
            p = _FORK.Process(
                target=_worker_loop,
                args=(w, n, loader.dataset, loader.collate_fn, iq, self._out,
                      self._iterable, loader.batch_size
                      if self._iterable else 0,
                      loader.drop_last if self._iterable else False,
                      loader.worker_init_fn, self._prefix),
                daemon=True)
            p.start()
            self._workers.append(p)
            self._index_queues.append(iq)

    def _check_workers(self, done=()):
        for w, p in enumerate(self._workers):
            if p.exitcode is not None and w not in done:
                # exit 0 without the 'done' sentinel (sys.exit in a
                # transform, swallowed KeyboardInterrupt) is just as dead
                self.close()
                raise RuntimeError(
                    f"DataLoader worker {w} (pid {p.pid}) exited "
                    f"(code {p.exitcode}) before finishing its batches — "
                    f"the SIGCHLD watchdog analog "
                    f"(ref dataloader_iter.py _on_child_exit)")

    def __iter__(self):
        import time as _time
        try:
            done = set()
            buffered = {}
            next_seq = 0
            expect = None
            dispatched = 0
            index_iter = None
            closed_queues = False
            if not self._iterable:
                index_iter = enumerate(iter(self.loader.batch_sampler))
                expect = len(self.loader.batch_sampler)
                if expect == 0:
                    return
            received = 0
            last_progress = _time.monotonic()
            while True:
                # incremental dispatch: keep at most `window` index batches
                # outstanding (dispatched - received); the rest wait here
                if index_iter is not None and not closed_queues:
                    while dispatched - received < self._window:
                        try:
                            seq, idxs = next(index_iter)
                        except StopIteration:
                            for iq in self._index_queues:
                                iq.put(None)
                            closed_queues = True
                            break
                        self._index_queues[seq % self.n].put(
                            (seq, list(idxs)))
                        dispatched += 1
                if len(done) == self.n and (
                        expect is None or received >= expect):
                    break
                try:
                    msg = self._out.get(timeout=1.0)
                except pyqueue.Empty:
                    self._check_workers(done)
                    if self._timeout and \
                            _time.monotonic() - last_progress > self._timeout:
                        self.close()
                        raise RuntimeError(
                            f"DataLoader timed out: no batch for "
                            f"{self._timeout:.0f}s (workers alive but "
                            f"stuck?)")
                    continue
                last_progress = _time.monotonic()
                if "error" in msg:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker {msg['worker']} raised:\n"
                        f"{msg['tb']}")
                if "done" in msg:
                    done.add(msg["done"])
                    continue
                received += 1
                if self._iterable:
                    # stream shards end at different times; arrival order
                    # (like the reference's mp iterable loader)
                    yield _unpack(msg, self._pin)
                    continue
                buffered[msg["seq"]] = msg
                while next_seq in buffered:
                    yield _unpack(buffered.pop(next_seq), self._pin)
                    next_seq += 1
        finally:
            self.close()

    def close(self):
        """Stop the workers and unlink every segment of the epoch that
        was not read (an early-exiting consumer must not leak
        /dev/shm)."""
        for iq in self._index_queues:
            if iq is not None:
                try:
                    iq.cancel_join_thread()
                    iq.close()
                except (OSError, ValueError):
                    pass
        for p in self._workers:
            if p.is_alive():
                p.terminate()
        for p in self._workers:
            p.join(timeout=5)
        try:
            self._out.cancel_join_thread()
            self._out.close()
        except (OSError, ValueError):
            pass
        try:
            names = os.listdir(_SHM_DIR)
        except OSError:         # no /dev/shm: the tracker unlinks at exit
            names = ()
        for name in names:
            if name.startswith(self._prefix):
                _unlink(name)
