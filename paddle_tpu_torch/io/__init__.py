"""paddle.io (the port of `paddle_tpu/io/__init__.py`; ref
python/paddle/io/__init__.py, fluid/dataloader/*): datasets, samplers,
`default_collate_fn` and `DataLoader`.

Batches are collated in numpy on the host, as in the JAX package, and
become `Tensor`s on the loader's place in the consuming thread
(`_wrap`): each array is cast to the framework's dtype (int64 -> int32,
float64 -> the default dtype), pinned, and copied to the card with
`non_blocking=True`. The place is `places` (a Place, a name, a
`torch.device` or a list of them, the first taken), else the current
place when the loader is built: the card unless `set_device("cpu")` was
called (raising when there is none).

No thread but the consumer's touches CUDA: a helper thread issuing
copies while `jit.TrainStep` captures a CUDA graph would break the
capture. So the double buffer (`_buffered_iter`) and the thread pool
prefetch numpy batches, and the forked workers of `io.multiprocess`
never build a `Tensor`. `_buffered_iter` joins its producer thread when
the consumer stops, early or not. The samplers draw from the global
numpy RNG, as the JAX package's do: one `np.random.seed` gives the same
batch order in both packages. The native feed datasets
(`dataset_native.py`) come with ROADMAP Queue 1 item 5.
"""
import collections
import itertools
import queue
import threading

import numpy as np
import torch

from ..framework import state
from ..framework.tensor import Tensor, _device_of, _narrowed


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [t.numpy() if isinstance(t, Tensor) else
                        Tensor._wrap(t).numpy() if isinstance(
                            t, torch.Tensor) else np.asarray(t)
                        for t in tensors]
        if any(t.shape[0] != self.tensors[0].shape[0]
               for t in self.tensors):
            raise ValueError("TensorDataset: the tensors differ in their "
                             "first dimension")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"random_split: lengths sum to {total}, the "
                         f"dataset holds {len(dataset)}")
    perm = np.random.permutation(total)
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """ref fluid/dataloader/batch_sampler.py."""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """ref python/paddle/io/DistributedBatchSampler: shards indices per
    rank. Without `num_replicas`/`rank` it asks `torch.distributed`
    (one replica when no process group is up; the port's `distributed`
    is ROADMAP Queue 1 item 5)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.nranks = num_replicas if num_replicas is not None else (
            dist.get_world_size() if up else 1)
        self.local_rank = rank if rank is not None else (
            dist.get_rank() if up else 0)
        self.shuffle = shuffle
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack samples -> numpy batch arrays (ref fluid/dataloader/collate.py)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, Tensor):
        return np.stack([s.numpy() for s in batch])
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return np.asarray(batch)


def _loader_device(places):
    """The torch device a loader's batches land on (`places`, else the
    current place)."""
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    return _device_of(places) if places is not None else \
        state.current_device()


class DataLoader:
    """ref fluid/reader.py:149 DataLoader. return_list=True semantics (2.0)."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, use_shared_memory=False, timeout=0,
                 worker_init_fn=None, prefetch_factor=2):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.device = _loader_device(places)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle,
                batch_size=batch_size if batch_size is not None else 1,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _raw_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _to_place(self, arr):
        """One collated array (or host torch tensor) as a Tensor on the
        loader's device: cast on the host, pinned, copied without
        blocking the host."""
        if self.device.type != "cuda":
            return Tensor(arr, place=self.device)
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        dt = _narrowed(t.dtype)
        if t.dtype != dt:
            t = t.to(dt)
        if not t.is_pinned():
            t = t.pin_memory()
        return Tensor._wrap(t.to(self.device, non_blocking=True))

    def _wrap(self, batch):
        if isinstance(batch, (tuple, list)):
            return [self._to_place(b) for b in batch]
        if isinstance(batch, dict):
            return {k: self._to_place(v) for k, v in batch.items()}
        return [self._to_place(batch)]

    def __iter__(self):
        if self.num_workers <= 0:
            if self.use_buffer_reader:
                yield from self._buffered_iter(self._raw_batches())
            else:
                for batch in self._raw_batches():
                    yield self._wrap(batch)
            return
        if self.use_shared_memory:
            # forked workers + shared-memory transport + watchdog
            # (ref dataloader_iter.py:469 _DataLoaderIterMultiProcess)
            from .multiprocess import MultiprocessLoaderIter
            for batch in MultiprocessLoaderIter(
                    self, pin=self.device.type == "cuda"):
                yield self._wrap(batch)
            return
        yield from self._worker_iter()

    def _buffered_iter(self, gen, depth=2):
        """Double buffer: a producer thread collates `depth` numpy
        batches ahead; the consumer wraps them. When the consumer stops
        (exhausted, an error, or a `break`), the cancel event retires
        the producer and the consumer joins it."""
        q = queue.Queue(maxsize=depth)
        stop = object()
        err = []
        cancel = threading.Event()

        def put(item):
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in gen:
                    if not put(b):
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                yield self._wrap(item)
        finally:
            cancel.set()
            t.join()

    def _worker_iter(self):
        """Thread-pool prefetch (multiprocess DataLoader analog,
        ref fluid/dataloader/dataloader_iter.py:469)."""
        from concurrent.futures import ThreadPoolExecutor
        if self._iterable_mode:
            yield from self._buffered_iter(self._raw_batches(),
                                           depth=self.prefetch_factor)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def fetch(idxs):
                return self.collate_fn([self.dataset[i] for i in idxs])

            pending = collections.deque()
            depth = self.num_workers * self.prefetch_factor
            try:
                for idxs in self.batch_sampler:
                    pending.append(pool.submit(fetch, idxs))
                    if len(pending) >= depth:
                        yield self._wrap(pending.popleft().result())
                while pending:
                    yield self._wrap(pending.popleft().result())
            finally:
                for f in pending:
                    f.cancel()

    def iter_from(self, start_batch):
        """Resume-seek: iterate this epoch from batch `start_batch`
        without fetching or collating the skipped batches. The batch
        sampler still draws their indices, so a shuffled epoch's
        permutation (and the global numpy RNG) advance as in the
        original run; `dataset[i]` is never called for them. Per-item
        transforms that draw from the global numpy RNG are not replayed
        by the seek: `Model.fit`'s fetch-and-discard is the exact path
        for those. Iterable datasets and worker pools fetch and discard
        (their readers have no index to seek)."""
        start = max(0, int(start_batch))
        if start == 0:
            yield from self
            return
        if self._iterable_mode or self.num_workers > 0:
            it = iter(self)
            consumed = 0
            for _ in it:
                consumed += 1
                if consumed >= start:
                    break
            yield from it
            return

        def seeked():
            for i, idxs in enumerate(self.batch_sampler):
                if i < start:
                    continue
                yield self.collate_fn([self.dataset[j] for j in idxs])

        if self.use_buffer_reader:
            yield from self._buffered_iter(seeked())
        else:
            for batch in seeked():
                yield self._wrap(batch)

    @staticmethod
    def from_generator(feed_list=None, capacity=2, use_double_buffer=True,
                       iterable=True, return_list=False, use_multiprocess=False,
                       drop_last=True):
        raise NotImplementedError(
            "legacy DataLoader.from_generator: wrap the generator in an "
            "IterableDataset instead")


def get_worker_info():
    """In a multiprocess DataLoader worker: shard info; else None."""
    from .multiprocess import get_worker_info as _gwi
    return _gwi()


def __getattr__(name):
    if name in ("DatasetFactory", "InMemoryDataset", "QueueDataset"):
        raise NotImplementedError(
            f"io.{name}: the native feed datasets (paddle_tpu/io/"
            f"dataset_native.py) feed the parameter server and come with "
            f"ROADMAP Queue 1 item 5")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
