"""paddle.reader / fluid.io reader decorators (the port of
`paddle_tpu/reader.py`; ref python/paddle/reader/decorator.py):
generator combinators for the legacy reader pipeline. Pure Python: they
touch neither torch nor a device."""
import itertools
import random as _random


def batch(reader, batch_size, drop_last=False):
    """ref paddle.batch: group a sample reader into lists of samples."""
    def batched():
        it = reader()
        while True:
            chunk = list(itertools.islice(it, batch_size))
            if not chunk:
                return
            if len(chunk) < batch_size and drop_last:
                return
            yield chunk
    return batched


def shuffle(reader, buf_size):
    """ref decorator.shuffle: buffered shuffling."""
    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf
    return shuffled


def buffered(reader, size):
    """ref decorator.buffered: thread-backed prefetch buffer. Reader
    exceptions propagate to the consumer (a swallowed error would look
    like a clean, shorter stream)."""
    import queue
    import threading

    def buffered_reader():
        q = queue.Queue(maxsize=size)
        end = object()
        err = []

        def fill():
            try:
                for s in reader():
                    q.put(s)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is end:
                if err:
                    raise err[0]
                return
            yield s
    return buffered_reader


def compose(*readers, check_alignment=True):
    """ref decorator.compose: zip readers into joined samples."""
    def composed():
        its = [r() for r in readers]
        for samples in (zip(*its) if not check_alignment
                        else itertools.zip_longest(*its)):
            if check_alignment and any(s is None for s in samples):
                raise ValueError("compose: readers of different lengths")
            out = []
            for s in samples:
                out.extend(s if isinstance(s, tuple) else (s,))
            yield tuple(out)
    return composed


def chain(*readers):
    def chained():
        for r in readers:
            yield from r()
    return chained


def map_readers(func, *readers):
    def mapped():
        for samples in zip(*[r() for r in readers]):
            yield func(*samples)
    return mapped


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def cache(reader):
    """Materialize once; a mid-iteration reader failure caches NOTHING
    (a partial prefix would silently truncate every later epoch)."""
    data = []

    def cached():
        if not data:
            data.extend(list(reader()))   # all-or-nothing
        return iter(data)
    return cached
