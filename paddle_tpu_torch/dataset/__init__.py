"""paddle.dataset legacy namespace (the port of
`paddle_tpu/dataset/__init__.py`; ref python/paddle/dataset): reader-style
wrappers over the dataset zoo, synthetic-backed as the vision datasets
are (real files load when they are present); `imdb` reads `text.Imdb`."""


def _reader_from(ds):
    def reader():
        for i in range(len(ds)):
            yield tuple(x for x in ds[i])
    return reader


class mnist:
    @staticmethod
    def train():
        from ..vision.datasets import MNIST
        return _reader_from(MNIST(mode="train"))

    @staticmethod
    def test():
        from ..vision.datasets import MNIST
        return _reader_from(MNIST(mode="test"))


def _housing_reader(seed, n):
    import numpy as np
    w = np.random.RandomState(0).randn(13).astype("f4")

    def reader():
        r = np.random.RandomState(seed)
        for _ in range(n):
            x = r.randn(13).astype("f4")
            yield x, np.asarray([x @ w + 0.1 * r.randn()], "f4")
    return reader


class uci_housing:
    @staticmethod
    def train():
        return _housing_reader(1, 404)

    @staticmethod
    def test():
        return _housing_reader(2, 102)


class imdb:
    @staticmethod
    def train(word_idx=None):
        from ..text import Imdb
        return _reader_from(Imdb(mode="train"))

    @staticmethod
    def test(word_idx=None):
        from ..text import Imdb
        return _reader_from(Imdb(mode="test"))
