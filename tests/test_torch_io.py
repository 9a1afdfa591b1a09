"""The port's `io` and `reader` against the JAX package's: the samplers'
index orders and every `DataLoader` batch under one numpy seed (shuffled
and not, `drop_last`, an `IterableDataset`, thread workers and forked
shared-memory workers), the batches' values and dtypes (int64 labels
narrowed to int32 in both); `iter_from`; `worker_init_fn` and
`get_worker_info` in forked workers; the reader decorators; the double
buffer's producer thread joined when the consumer stops early; a worker
that raises or dies failing the loop with its name; a consumer slower
than the workers still reading every batch; no shared-memory segment
left behind by an epoch left early or failed.

Every comparison is exact.
"""
import os
import random
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import io as jio
from paddle_tpu import reader as jreader
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import reader as treader

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def make_dataset(io, n=37):
    """(image f32 [3, 4], label int64, weight float) samples, the same
    numbers in either package's Dataset."""
    rng = np.random.RandomState(0)
    x = rng.rand(n, 3, 4).astype("f4")
    y = rng.randint(0, 10, n).astype("int64")

    class Samples(io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i], float(i) / n

    return Samples()


def make_stream(io, n=23):
    class Stream(io.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.full((2,), i, dtype="f4"), np.int64(i)

    return Stream()


def batches(loader):
    return [[np.asarray(t.numpy()) for t in b] for b in loader]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def both(kw, seed=3, n=37):
    """The port's and the JAX package's batches of one loader config,
    each drawn after np.random.seed(seed)."""
    out = []
    for io in (tio, jio):
        np.random.seed(seed)
        out.append(batches(io.DataLoader(make_dataset(io, n), **kw)))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=8),
    dict(batch_size=8, shuffle=True),
    dict(batch_size=8, shuffle=True, drop_last=True),
    dict(batch_size=5, shuffle=True, use_buffer_reader=False),
    dict(batch_size=8, shuffle=True, num_workers=2),
    dict(batch_size=8, shuffle=True, num_workers=2, use_shared_memory=True),
], ids=["seq", "shuffle", "drop_last", "unbuffered", "threads", "forked"])
def test_loader_batches_equal_jax(kw):
    got, want = both(kw)
    assert_same_batches(got, want)
    # int64 labels become int32 tensors, the weights float32
    assert got[0][1].dtype == np.int32 and got[0][2].dtype == np.float32


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=4, num_workers=2)])
def test_iterable_dataset_equal_jax(kw):
    got = batches(tio.DataLoader(make_stream(tio), **kw))
    want = batches(jio.DataLoader(make_stream(jio), **kw))
    assert_same_batches(got, want)
    with pytest.raises(TypeError):
        len(tio.DataLoader(make_stream(tio), batch_size=4))


def test_forked_iterable_covers_the_stream():
    vals = []
    for b in tio.DataLoader(make_stream(tio), batch_size=5, num_workers=2,
                            use_shared_memory=True):
        vals.extend(int(v[0]) for v in b[0].numpy())
    assert sorted(vals) == list(range(23))


def test_samplers_equal_jax():
    ds_t, ds_j = make_dataset(tio), make_dataset(jio)
    pairs = [
        (lambda io, ds: io.RandomSampler(ds)),
        (lambda io, ds: io.RandomSampler(ds, replacement=True,
                                         num_samples=50)),
        (lambda io, ds: io.WeightedRandomSampler(np.arange(1, 38), 20)),
        (lambda io, ds: io.SequenceSampler(ds)),
        (lambda io, ds: io.BatchSampler(ds, shuffle=True, batch_size=6,
                                        drop_last=True)),
        (lambda io, ds: io.DistributedBatchSampler(
            ds, 4, num_replicas=3, rank=1, shuffle=True)),
    ]
    for make in pairs:
        got_s, want_s = make(tio, ds_t), make(jio, ds_j)
        np.random.seed(11)
        got = list(got_s)
        np.random.seed(11)
        want = list(want_s)
        assert got == want
        assert len(got_s) == len(want_s)
    np.random.seed(12)
    got = [list(s.indices) for s in tio.random_split(ds_t, [30, 7])]
    np.random.seed(12)
    want = [list(s.indices) for s in jio.random_split(ds_j, [30, 7])]
    assert got == want


def test_datasets_and_collate_equal_jax():
    x = np.arange(24, dtype="f4").reshape(6, 4)
    y = np.arange(6)
    td_t = tio.TensorDataset([pt.to_tensor(x), y])
    td_j = jio.TensorDataset([pj.to_tensor(x), y])
    for i in range(6):
        for a, b in zip(td_t[i], td_j[i]):
            np.testing.assert_array_equal(a, b)
    comp = tio.ComposeDataset([td_t, td_t])
    assert len(comp) == 6 and len(comp[2]) == 4
    chain = [s for s in tio.ChainDataset([make_stream(tio, 3),
                                          make_stream(tio, 2)])]
    assert [int(s[1]) for s in chain] == [0, 1, 2, 0, 1]
    sample = [{"a": np.ones(2, "f4"), "b": 3}, {"a": np.zeros(2, "f4"),
                                                "b": 4}]
    got = tio.default_collate_fn(sample)
    want = jio.default_collate_fn(sample)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    d = tio.DataLoader([s for s in sample], batch_size=2)
    (b,) = list(d)
    assert sorted(b) == ["a", "b"] and b["b"].numpy().dtype == np.int32


def test_iter_from_equals_the_tail_and_jax():
    for io in (tio, jio):
        ds = make_dataset(io)
        np.random.seed(5)
        full = batches(io.DataLoader(ds, batch_size=4, shuffle=True))
        np.random.seed(5)
        tail = batches(io.DataLoader(ds, batch_size=4,
                                     shuffle=True).iter_from(3))
        assert_same_batches(tail, full[3:])
        if io is tio:
            port_tail = tail
    assert_same_batches(port_tail, tail)
    np.random.seed(5)
    threads = tio.DataLoader(make_dataset(tio), batch_size=4, shuffle=True,
                             num_workers=2)
    assert_same_batches(batches(threads.iter_from(3)), tail)


class _Probe:
    def __init__(self, io):
        self.io = io

    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = self.io.get_worker_info()
        return np.asarray([i, info.id, info.num_workers,
                           np.random.randint(1000)], dtype="i8")


def _seed_worker(wid):
    np.random.seed(100 + wid)


def test_worker_init_fn_and_worker_info_equal_jax():
    rows = {}
    for io in (tio, jio):
        probe = type("P", (_Probe, io.Dataset), {})(io)
        loader = io.DataLoader(probe, batch_size=2, num_workers=2,
                               use_shared_memory=True,
                               worker_init_fn=_seed_worker)
        rows[io] = np.concatenate([b[0].numpy() for b in loader])
    np.testing.assert_array_equal(rows[tio], rows[jio])
    assert set(rows[tio][:, 2]) == {2} and set(rows[tio][:, 1]) == {0, 1}
    assert tio.get_worker_info() is None


def _reader(n):
    def r():
        for i in range(n):
            yield (i, i * i)
    return r


def test_reader_decorators_equal_jax():
    cases = [
        lambda R: R.batch(_reader(10), 3),
        lambda R: R.batch(_reader(10), 3, drop_last=True),
        lambda R: R.shuffle(_reader(20), 7),
        lambda R: R.buffered(_reader(10), 2),
        lambda R: R.compose(_reader(4), _reader(4)),
        lambda R: R.chain(_reader(3), _reader(2)),
        lambda R: R.map_readers(lambda a, b: a[0] + b[1], _reader(5),
                                _reader(5)),
        lambda R: R.firstn(_reader(10), 4),
        lambda R: R.cache(_reader(5)),
    ]
    for make in cases:
        random.seed(9)
        got = list(make(treader)())
        random.seed(9)
        want = list(make(jreader)())
        assert got == want
    with pytest.raises(ValueError):
        list(treader.compose(_reader(3), _reader(4))())


def test_buffered_producer_is_joined_when_the_consumer_breaks():
    before = set(threading.enumerate())
    ds = make_dataset(tio, 64)
    it = iter(tio.DataLoader(ds, batch_size=1))
    first = next(it)
    assert first[0].shape == [1, 3, 4]
    # the producer has filled its queue and waits on it: a break closes
    # the generator, which must retire and join the producer
    it.close()
    assert set(threading.enumerate()) - before == set()
    for _ in tio.DataLoader(ds, batch_size=4):
        break
    assert set(threading.enumerate()) - before == set()


class _Raises:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i == 17:
            raise ValueError("boom at 17")
        return np.zeros(2, dtype="f4")


class _Dies:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        if i == 9:
            os._exit(3)
        return np.zeros(2, dtype="f4")


def test_a_raising_or_dead_worker_fails_the_loop():
    raises = type("R", (_Raises, tio.Dataset), {})()
    with pytest.raises(RuntimeError, match="boom at 17"):
        for _ in tio.DataLoader(raises, batch_size=4, num_workers=2,
                                use_shared_memory=True):
            pass
    dies = type("D", (_Dies, tio.Dataset), {})()
    with pytest.raises(RuntimeError, match="exited"):
        for _ in tio.DataLoader(dies, batch_size=4, num_workers=2,
                                use_shared_memory=True):
            pass
    # the single-process loaders pass the error on
    with pytest.raises(ValueError, match="boom at 17"):
        for _ in tio.DataLoader(raises, batch_size=4):
            pass


def test_a_slow_consumer_gets_every_batch_after_the_workers_exit():
    """Workers that finish their batches and exit while the consumer is
    still busy leave their unread segments to it."""
    import time
    ds = make_dataset(tio, 24)
    got = []
    for b in tio.DataLoader(ds, batch_size=4, num_workers=3,
                            use_shared_memory=True):
        time.sleep(0.2)
        got.append(b[1].numpy())
    np.testing.assert_array_equal(np.concatenate(got),
                                  [ds[i][1] for i in range(24)])


class _Slow:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        import time
        time.sleep(0.01)
        return np.full(4, i, dtype="f4")


def _segments_left():
    """This process's loader segments still in /dev/shm."""
    prefix = f"ptt{os.getpid()}_"
    return [n for n in os.listdir("/dev/shm") if n.startswith(prefix)]


def test_no_segment_outlives_an_epoch():
    """An epoch left early, one whose worker raises and one whose worker
    dies leave no shared-memory segment of theirs behind."""
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm to list the segments in")
    slow = type("S", (_Slow, tio.Dataset), {})()
    for b in tio.DataLoader(slow, batch_size=4, num_workers=3,
                            use_shared_memory=True):
        break
    assert _segments_left() == []
    for broken, err in ((_Raises, RuntimeError), (_Dies, RuntimeError)):
        ds = type("B", (broken, tio.Dataset), {})()
        with pytest.raises(err):
            for _ in tio.DataLoader(ds, batch_size=4, num_workers=2,
                                    use_shared_memory=True):
                pass
        assert _segments_left() == []


def test_places_and_native_datasets():
    ds = make_dataset(tio)
    assert tio.DataLoader(ds).device == torch.device("cpu")
    assert tio.DataLoader(ds, places=[pt.CPUPlace()]).device.type == "cpu"
    (x, y, w) = next(iter(tio.DataLoader(ds, batch_size=2,
                                         places="cpu")))
    assert isinstance(x, pt.Tensor) and x.place == pt.CPUPlace()
    with pytest.raises(NotImplementedError, match="item 5"):
        tio.InMemoryDataset
    with pytest.raises(NotImplementedError):
        tio.DataLoader.from_generator()
