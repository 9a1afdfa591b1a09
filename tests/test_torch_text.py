"""The port's `text` (datasets, Viterbi decoding), `distribution` and
`dataset.imdb` against the JAX package's on the CPU.

Every dataset yields the same items as its JAX twin: the synthetic
defaults item for item at small sizes, and each real-format parser over
a small archive in the real layout written to `tmp_path` (nothing is
downloaded). `viterbi_decode` matches JAX's scores and paths and a
brute-force search, with lengths and with ties (the first index wins).
Distributions: `log_prob`, `probs`, `entropy` and `kl_divergence` within
1e-6 x max(1, |ref|) of JAX's; samples, which come from another
generator than JAX's, by their moments.
"""
import gzip
import io
import itertools
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu import distribution as jD
from paddle_tpu import text as jtext
from paddle_tpu_torch import distribution as tD
from paddle_tpu_torch import text as ttext

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def same_items(a, b, n=None):
    """Datasets `a` (JAX) and `b` (port) hold the same items."""
    assert len(a) == len(b)
    for i in range(len(a) if n is None else min(n, len(a))):
        x, y = a[i], b[i]
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        assert len(x) == len(y), i
        for p, q in zip(x, y):
            p, q = np.asarray(p), np.asarray(q)
            assert p.dtype == q.dtype and p.shape == q.shape, (i, p, q)
            np.testing.assert_array_equal(p, q)


# ------------------------------------------------------------ synthetic

SYNTHETIC = {
    "Imdb": lambda m, mode: m.Imdb(mode=mode, num_samples=12, seq_len=9,
                                   vocab_size=40),
    "Imikolov-NGRAM": lambda m, mode: m.Imikolov(
        mode=mode, vocab_size=30, num_samples=20, window_size=4),
    "Imikolov-SEQ": lambda m, mode: m.Imikolov(
        mode=mode, data_type="SEQ", vocab_size=30, num_samples=20),
    "Movielens": lambda m, mode: m.Movielens(mode=mode, num_samples=30,
                                             num_users=9, num_movies=11),
    "UCIHousing": lambda m, mode: m.UCIHousing(mode=mode, num_samples=15),
    "WMT14": lambda m, mode: m.WMT14(mode=mode, dict_size=30, seq_len=6,
                                     num_samples=10),
    "WMT16": lambda m, mode: m.WMT16(mode=mode, src_dict_size=20,
                                     trg_dict_size=25, seq_len=5,
                                     num_samples=10),
    "Conll05st": lambda m, mode: m.Conll05st(mode=mode, vocab_size=50,
                                             seq_len=7, num_samples=10),
}


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_dataset_matches_jax_item_for_item(name, mode):
    same_items(SYNTHETIC[name](jtext, mode), SYNTHETIC[name](ttext, mode))


def test_dataset_imdb_reads_text_imdb():
    for split in ("train", "test"):
        want = getattr(pj.dataset.imdb, split)()
        got = getattr(pt.dataset.imdb, split)()
        for a, b in itertools.islice(zip(want(), got()), 20):
            assert len(a) == len(b)
            for p, q in zip(a, b):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


# ------------------------------------------------------------ real formats

def add_member(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


WORDS = ("the cat sat on a mat , and the dog ran to the cat ; the end of "
         "it all was a big mat").split()


def sentences(seed, n, lo=3, hi=9):
    r = np.random.RandomState(seed)
    return [" ".join(r.choice(WORDS, r.randint(lo, hi))) for _ in range(n)]


def test_imdb_real_format(tmp_path):
    path = tmp_path / "aclImdb_v1.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        k = 0
        for split in ("train", "test"):
            for sub in ("pos", "neg"):
                for s in sentences(k, 4):
                    add_member(tar, f"aclImdb/{split}/{sub}/{k}_7.txt",
                               (s.upper() + "!\n").encode())
                    k += 1
    for mode in ("train", "test"):
        a = jtext.Imdb(data_file=str(path), mode=mode, cutoff=2)
        b = ttext.Imdb(data_file=str(path), mode=mode, cutoff=2)
        assert a.word_idx == b.word_idx and len(a.word_idx) > 3
        same_items(a, b)


def test_imikolov_real_format(tmp_path):
    path = tmp_path / "simple-examples.tgz"
    with tarfile.open(path, "w:gz") as tar:
        for i, split in enumerate(("train", "valid", "test")):
            text = "\n".join(sentences(10 + i, 12)) + "\n"
            add_member(tar, f"./simple-examples/data/ptb.{split}.txt",
                       text.encode())
    for kw in (dict(data_type="NGRAM", window_size=3),
               dict(data_type="SEQ", window_size=8)):
        for mode in ("train", "valid", "test"):
            a = jtext.Imikolov(data_file=str(path), mode=mode,
                               min_word_freq=3, **kw)
            b = ttext.Imikolov(data_file=str(path), mode=mode,
                               min_word_freq=3, **kw)
            assert a.word_idx == b.word_idx and len(a) > 0
            same_items(a, b)


def test_movielens_real_format(tmp_path):
    path = tmp_path / "ml-1m.zip"
    r = np.random.RandomState(3)
    movies = [f"{m}::Movie {WORDS[m]} Title ({1990 + m})::"
              f"{'|'.join(r.choice(['Drama', 'Comedy', 'War'], 2))}"
              for m in range(1, 9)]
    users = [f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35][u % 4]}::{u % 5}::0000"
             for u in range(1, 7)]
    ratings = [f"{r.randint(1, 7)}::{r.randint(1, 9)}::{r.randint(1, 6)}::0"
               for _ in range(60)]
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat", "\n".join(movies) + "\n")
        z.writestr("ml-1m/users.dat", "\n".join(users) + "\n")
        z.writestr("ml-1m/ratings.dat", "\n".join(ratings) + "\n")
    for mode in ("train", "test"):
        a = jtext.Movielens(data_file=str(path), mode=mode, test_ratio=0.3)
        b = ttext.Movielens(data_file=str(path), mode=mode, test_ratio=0.3)
        assert a.movie_title_dict == b.movie_title_dict
        assert a.categories_dict == b.categories_dict and len(a) > 0
        same_items(a, b)


def test_uci_housing_real_format(tmp_path):
    path = tmp_path / "housing.data"
    rows = np.random.RandomState(4).uniform(0, 50, (20, 14))
    path.write_text("\n".join(" ".join(f"{v:.4f}" for v in row)
                              for row in rows) + "\n")
    for mode in ("train", "test"):
        same_items(jtext.UCIHousing(data_file=str(path), mode=mode),
                   ttext.UCIHousing(data_file=str(path), mode=mode))


def test_wmt14_real_format(tmp_path):
    path = tmp_path / "wmt14.tgz"
    vocab = ["<s>", "<e>", "<unk>"] + sorted(set(WORDS))
    with tarfile.open(path, "w:gz") as tar:
        add_member(tar, "wmt14/src.dict", "\n".join(vocab).encode())
        add_member(tar, "wmt14/trg.dict",
                   "\n".join(vocab[:3] + vocab[:2:-1]).encode())
        for mode in ("train", "test", "gen"):
            pairs = zip(sentences(20, 8), sentences(21, 8))
            add_member(tar, f"wmt14/{mode}/{mode}",
                       "\n".join(f"{s}\t{t}" for s, t in pairs).encode())
    for mode in ("train", "test", "gen"):
        a = jtext.WMT14(data_file=str(path), mode=mode, dict_size=12)
        b = ttext.WMT14(data_file=str(path), mode=mode, dict_size=12)
        assert a.get_dict() == b.get_dict() and len(a) == 8
        same_items(a, b)


def test_wmt16_real_format(tmp_path):
    path = tmp_path / "wmt16.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for i, mode in enumerate(("train", "test", "val")):
            pairs = zip(sentences(30 + i, 10), sentences(40 + i, 10))
            add_member(tar, f"wmt16/{mode}",
                       "\n".join(f"{s}\t{t}" for s, t in pairs).encode())
    for lang in ("en", "de"):
        for mode in ("train", "test", "val"):
            a = jtext.WMT16(data_file=str(path), mode=mode, lang=lang,
                            src_dict_size=10, trg_dict_size=12)
            b = ttext.WMT16(data_file=str(path), mode=mode, lang=lang,
                            src_dict_size=10, trg_dict_size=12)
            assert a.get_dict(lang) == b.get_dict(lang)
            same_items(a, b)


def test_conll05st_real_format(tmp_path):
    # two sentences of one predicate each, a blank line after each
    sents = [
        (["The", "cat", "ate", "the", "fish", "today"],
         [["-", "(A0*"], ["-", "*)"], ["eat", "(V*)"], ["-", "(A1*"],
          ["-", "*)"], ["-", "(AM-TMP*)"]]),
        (["A", "dog", "ran"],
         [["-", "(A0*"], ["-", "*)"], ["run", "(V*)"]])]

    def gz(col):
        lines = []
        for words, props in sents:
            lines += [col(w, p) for w, p in zip(words, props)] + [""]
        return gzip.compress(("\n".join(lines) + "\n").encode())
    path = tmp_path / "conll05st-tests.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        add_member(tar, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                   gz(lambda w, p: w))
        add_member(tar, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                   gz(lambda w, p: " ".join(p)))
    (tmp_path / "word.dict").write_text("\n".join(
        ["<unk>", "bos", "eos"] + sents[0][0] + sents[1][0]) + "\n")
    (tmp_path / "verb.dict").write_text("eat\nrun\n")
    (tmp_path / "target.dict").write_text(
        "B-A0\nI-A0\nB-A1\nI-A1\nB-V\nI-V\nB-AM-TMP\nI-AM-TMP\nO\n")
    files = dict(word_dict_file=str(tmp_path / "word.dict"),
                 verb_dict_file=str(tmp_path / "verb.dict"),
                 target_dict_file=str(tmp_path / "target.dict"))
    a = jtext.Conll05st(data_file=str(path), **files)
    b = ttext.Conll05st(data_file=str(path), **files)
    assert a.get_dict() == b.get_dict() and len(a) == 2
    same_items(a, b)


# ------------------------------------------------------------ viterbi

def brute_force(pot, trans, length):
    T, N = length, pot.shape[1]
    best, best_path = -np.inf, None
    for seq in itertools.product(range(N), repeat=T):
        s = pot[0, seq[0]] + sum(trans[seq[t - 1], seq[t]] + pot[t, seq[t]]
                                 for t in range(1, T))
        if s > best:        # strict: the first path in order wins a tie
            best, best_path = s, seq
    return best, best_path


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_viterbi_decode_matches_jax_and_brute_force(with_lengths, ties):
    r = np.random.RandomState(5 + ties)
    B, T, N = 4, 5, 3
    if ties:
        pot = r.randint(0, 2, (B, T, N)).astype("f4")
        trans = r.randint(0, 2, (N, N)).astype("f4")
    else:
        pot = r.randn(B, T, N).astype("f4")
        trans = r.randn(N, N).astype("f4")
    lens = np.array([5, 3, 1, 4], "int32")
    res = {}
    for P, m in ((pj, jtext), (pt, ttext)):
        args = [P.to_tensor(pot), P.to_tensor(trans)]
        if with_lengths:
            args.append(P.to_tensor(lens))
        s, p = m.viterbi_decode(*args)
        res[P] = (s.numpy(), p.numpy())
    (js, jp), (ts, tp) = res[pj], res[pt]
    assert tp.dtype == jp.dtype and ts.dtype == js.dtype
    np.testing.assert_array_equal(tp, jp)
    assert (np.abs(ts - js) <= RTOL * np.maximum(1, np.abs(js))).all()
    for b in range(B):
        L = lens[b] if with_lengths else T
        best, path = brute_force(pot[b], trans, L)
        np.testing.assert_allclose(ts[b], best, rtol=1e-5)
        if not ties:
            assert tuple(tp[b, :L]) == path
        assert (tp[b, L:] == 0).all()
    dec = ttext.ViterbiDecoder(pt.to_tensor(trans))
    s2, p2 = dec(pt.to_tensor(pot),
                 pt.to_tensor(lens) if with_lengths else None)
    np.testing.assert_array_equal(p2.numpy(), tp)


# ------------------------------------------------------------ distributions

def close(got, want):
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    assert (err <= RTOL * np.maximum(1, np.abs(want[fin]))).all(), err.max()


def both(fn):
    """fn(P, D) over both packages: (JAX's, port's) numpy results."""
    return [tuple(np.asarray(v.numpy()) for v in fn(P, D))
            for P, D in ((pj, jD), (pt, tD))]


DENSITY_CASES = {
    "Uniform": lambda P, D: (
        D.Uniform([-1.0, 0.5], [2.0, 3.0]).log_prob(
            P.to_tensor([[0.0, 4.0], [-2.0, 1.0]])),
        D.Uniform(-2.0, 3.0).entropy(),
        D.Uniform(-2.0, 3.0).probs(P.to_tensor([0.5]))),
    "Normal": lambda P, D: (
        D.Normal([1.0, -0.5], [2.0, 0.7]).log_prob(
            P.to_tensor([[1.0, 0.3], [-1.0, 2.0]])),
        D.Normal([1.0, -0.5], [2.0, 0.7]).entropy(),
        D.Normal([1.0, -0.5], [2.0, 0.7]).kl_divergence(
            D.Normal([0.0, 0.5], [1.0, 1.5])),
        D.kl_divergence(D.Normal(0.0, 1.0), D.Normal(0.3, 2.0))),
    "Categorical": lambda P, D: (
        D.Categorical(np.log(np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]],
                                      "f4"))).log_prob(P.to_tensor([2, 0])),
        D.Categorical(np.array([0.1, -0.4, 1.2], "f4")).probs(),
        D.Categorical(np.array([0.1, -0.4, 1.2], "f4")).probs(
            P.to_tensor([1])),
        D.Categorical(np.array([0.1, -0.4, 1.2], "f4")).entropy(),
        D.Categorical(np.array([0.1, -0.4, 1.2], "f4")).kl_divergence(
            D.Categorical(np.array([0.5, 0.2, -0.3], "f4")))),
    "MultivariateNormalDiag": lambda P, D: (
        D.MultivariateNormalDiag([0.0, 1.0], [1.0, 2.0]).log_prob(
            P.to_tensor([[0.5, 1.0], [-1.0, 3.0]])),
        D.MultivariateNormalDiag([0.0, 1.0], [1.0, 2.0]).entropy(),
        D.MultivariateNormalDiag([0.0, 1.0], [1.0, 2.0]).kl_divergence(
            D.MultivariateNormalDiag([0.5, 0.0], [2.0, 1.0]))),
}


@pytest.mark.parametrize("name", sorted(DENSITY_CASES))
def test_distribution_densities_match_jax(name):
    want, got = both(DENSITY_CASES[name])
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        close(g, w)


def test_distribution_samples_by_moments_on_the_framework_generator():
    pt.seed(0)
    s = tD.Normal(1.0, 2.0).sample([20000]).numpy()
    assert abs(s.mean() - 1.0) < 0.05 and abs(s.std() - 2.0) < 0.05
    u = tD.Uniform(-2.0, 3.0).sample([20000]).numpy()
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.05 and abs(u.var() - 25 / 12) < 0.1
    c = tD.Categorical(np.log(np.array([0.2, 0.3, 0.5], "f4"))).sample(
        [30000]).numpy()
    assert c.dtype == np.int32
    np.testing.assert_allclose(np.bincount(c, minlength=3) / c.size,
                               [0.2, 0.3, 0.5], atol=0.01)
    m = tD.MultivariateNormalDiag([0.0, 1.0], [1.0, 2.0]).sample(
        [20000]).numpy()
    assert m.shape == (20000, 2)
    np.testing.assert_allclose(m.mean(0), [0.0, 1.0], atol=0.05)
    np.testing.assert_allclose(m.std(0), [1.0, 2.0], atol=0.05)
    # the framework generator: one seed, one draw; the next draw differs
    pt.seed(3)
    a = tD.Normal(0.0, 1.0).sample([5]).numpy()
    b = tD.Normal(0.0, 1.0).sample([5]).numpy()
    pt.seed(3)
    np.testing.assert_array_equal(tD.Normal(0.0, 1.0).sample([5]).numpy(), a)
    assert not np.array_equal(a, b)
