"""paddle_tpu_torch.text — the text dataset zoo and Viterbi decoding (the
port of `paddle_tpu/text/__init__.py`; ref python/paddle/text/datasets:
imdb.py, imikolov.py, movielens.py, uci_housing.py, wmt14.py, wmt16.py,
conll05.py).

The reference downloads corpora at first use; this environment has zero
egress, so every dataset mirrors the vision zoo's design: deterministic
synthetic data with learnable signal by default, real files when a local
copy exists at `data_file`. Shapes/vocab APIs match the reference so
training scripts port unchanged. The synthetic data comes from the same
numpy `RandomState` seeds as the JAX package's, so both yield the same
samples item for item. (The synthetic `Imikolov` builds a dense
vocab x vocab float64 transition matrix before its first sample: 800 MB
at vocab 10000.)
"""
import numpy as np
import torch

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16",
           "Conll05st", "ViterbiDecoder", "viterbi_decode"]


class _SyntheticTextDataset(Dataset):
    """Token sequences with class-dependent unigram distributions, so
    sentiment/LM models actually learn (same philosophy as the vision
    zoo's pattern-based images)."""

    def __init__(self, num_samples, seq_len, vocab_size, num_classes,
                 seed, pattern_seed=4321):
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        rng_p = np.random.RandomState(pattern_seed)
        # per-class token-preference logits (shared across splits)
        self._logits = rng_p.randn(num_classes, vocab_size).astype("f4")
        rng = np.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes, num_samples)
        self._seed = seed * 7919
        self.num_samples = num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx + 1)
        y = self._labels[idx]
        p = np.exp(2.0 * self._logits[y])
        p /= p.sum()
        toks = rng.choice(self.vocab_size, size=self.seq_len, p=p)
        return toks.astype("int64"), np.int64(y)

    def __len__(self):
        return self.num_samples


class Imdb(_SyntheticTextDataset):
    """Sentiment classification (ref text/datasets/imdb.py). With a
    `data_file`, parses the REAL aclImdb_v1.tar.gz format exactly as the
    reference does (tar members aclImdb/{split}/{pos,neg}/*.txt,
    punctuation-stripped lowercase tokenization, frequency-cutoff vocab
    sorted by (-freq, word), '<unk>' appended; pos label 0, neg 1,
    variable-length docs). Without one (zero-egress default), synthetic
    sequences with the same API."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 seq_len=128, vocab_size=5000, num_samples=2000):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        if data_file is not None:
            self.data_file = data_file
            self.word_idx = self._build_word_dict(cutoff)
            self._load_anno()
            self.num_samples = len(self.docs)
            return
        super().__init__(num_samples, seq_len, vocab_size, 2,
                         seed=0 if mode == "train" else 1)
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}

    # ---- real-format path (ref imdb.py:95-140)
    def _tokenize(self, pattern):
        import re
        import string
        import tarfile
        table = bytes.maketrans(b"", b"")
        strip = string.punctuation.encode()
        docs = []
        with tarfile.open(self.data_file) as tarf:
            tf = tarf.next()
            while tf is not None:
                if pattern.match(tf.name):
                    raw = tarf.extractfile(tf).read().rstrip(b"\n\r")
                    docs.append(
                        raw.translate(table, strip).lower().split())
                tf = tarf.next()
        return docs

    def _build_word_dict(self, cutoff):
        import collections
        import re
        freq = collections.defaultdict(int)
        pat = re.compile(
            r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
        for doc in self._tokenize(pat):
            for w in doc:
                freq[w] += 1
        kept = [x for x in freq.items() if x[1] > cutoff]
        kept.sort(key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx['<unk>'] = len(kept)   # str key like the reference
        return word_idx

    def _load_anno(self):
        import re
        unk = self.word_idx['<unk>']
        self.docs, self.labels = [], []
        for label, sub in ((0, "pos"), (1, "neg")):
            pat = re.compile(
                r"aclImdb/{}/{}/.*\.txt$".format(self.mode, sub))
            for doc in self._tokenize(pat):
                self.docs.append(
                    [self.word_idx.get(w, unk) for w in doc])
                self.labels.append(label)

    def __getitem__(self, idx):
        if hasattr(self, "docs"):
            return (np.array(self.docs[idx]),
                    np.array([self.labels[idx]]))
        return super().__getitem__(idx)

    def __len__(self):
        return self.num_samples


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset (ref text/datasets/imikolov.py:
    data_type NGRAM/SEQ, window_size). With a `data_file`, parses the
    REAL simple-examples.tgz layout the way the reference does
    (./simple-examples/data/ptb.{mode}.txt members, frequency-cutoff
    vocab over train+valid with <s>/<e> counted per line and <unk>
    appended last, byte tokens; NGRAM sliding windows or SEQ pairs).
    Synthetic markov-chain default otherwise."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, vocab_size=2000,
                 num_samples=5000):
        self.window_size = window_size
        self.data_type = data_type
        self.vocab_size = vocab_size
        if data_file is not None:
            assert mode.lower() in ("train", "valid", "test"), mode
            self.mode = mode.lower()
            self.data_file = data_file
            self.min_word_freq = min_word_freq
            self.word_idx = self._build_word_dict()
            self._load_anno()
            self.num_samples = len(self.data)
            return
        rng = np.random.RandomState(0 if mode == "train" else 1)
        # markov-chain corpus: next token depends on previous (learnable)
        trans = np.random.RandomState(99).dirichlet(
            np.ones(vocab_size) * 0.05, size=vocab_size)
        toks = [int(rng.randint(vocab_size))]
        for _ in range(num_samples + window_size):
            toks.append(int(rng.choice(vocab_size, p=trans[toks[-1]])))
        self._toks = np.asarray(toks, dtype="int64")
        self.num_samples = num_samples

    # ---- real-format path (ref imikolov.py:106-170)
    def _word_count(self, f, freq):
        for line in f:
            for w in line.strip().split():
                freq[w] += 1
            freq["<s>"] += 1
            freq["<e>"] += 1
        return freq

    def _build_word_dict(self):
        import collections
        import tarfile
        with tarfile.open(self.data_file) as tf:
            freq = collections.defaultdict(int)
            self._word_count(
                tf.extractfile("./simple-examples/data/ptb.train.txt"),
                freq)
            self._word_count(
                tf.extractfile("./simple-examples/data/ptb.valid.txt"),
                freq)
        freq.pop(b"<unk>", None)
        kept = [x for x in freq.items() if x[1] > self.min_word_freq]
        kept.sort(key=lambda x: (-x[1], x[0] if isinstance(x[0], bytes)
                                 else x[0].encode()))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(kept)
        return word_idx

    def _load_anno(self):
        import tarfile
        self.data = []
        unk = self.word_idx["<unk>"]
        with tarfile.open(self.data_file) as tf:
            f = tf.extractfile(
                f"./simple-examples/data/ptb.{self.mode}.txt")
            for line in f:
                if self.data_type == "NGRAM":
                    toks = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(toks) >= self.window_size:
                        ids = [self.word_idx.get(w, unk) for w in toks]
                        for i in range(self.window_size, len(ids) + 1):
                            self.data.append(
                                tuple(ids[i - self.window_size:i]))
                elif self.data_type == "SEQ":
                    ids = [self.word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src = [self.word_idx["<s>"]] + ids
                    trg = ids + [self.word_idx["<e>"]]
                    if self.window_size > 0 \
                            and len(src) > self.window_size:
                        continue
                    self.data.append((src, trg))
                else:
                    raise ValueError(f"unknown data_type {self.data_type}")

    def __getitem__(self, idx):
        if hasattr(self, "data"):
            return tuple(np.array(d) for d in self.data[idx])
        w = self._toks[idx: idx + self.window_size]
        if self.data_type == "NGRAM":
            return tuple(w[:-1]) + (w[-1],)
        return w[:-1], w[1:]

    def __len__(self):
        return self.num_samples


AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


class Movielens(Dataset):
    """Rating prediction (ref text/datasets/movielens.py). With a
    `data_file`, parses the REAL ml-1m.zip layout the way the reference
    does (movies/users/ratings .dat with '::' separators, latin-1;
    title words + categories dicts; the np.random test split with
    rating*2-5 scaling; per-sample tuple = user.value() + movie.value()
    + [[rating]]). Synthetic learnable default otherwise."""

    def __init__(self, data_file=None, mode="train", num_samples=4000,
                 num_users=500, num_movies=800, test_ratio=0.1,
                 rand_seed=0):
        if data_file is not None:
            self.mode = mode.lower()
            self.data_file = data_file
            self.test_ratio = test_ratio
            # private RNG: same MT19937 sequence as the reference's global
            # np.random.seed(rand_seed), without clobbering global state
            self._rng = np.random.RandomState(rand_seed)
            self._load_real()
            self.num_samples = len(self._data)
            return
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.num_users, self.num_movies = num_users, num_movies
        lat = np.random.RandomState(7)
        u = lat.randn(num_users, 8)
        m = lat.randn(num_movies, 8)
        self._users = rng.randint(0, num_users, num_samples)
        self._movies = rng.randint(0, num_movies, num_samples)
        scores = (u[self._users] * m[self._movies]).sum(1)
        self._ratings = np.clip(
            np.digitize(scores, np.quantile(scores, [0.2, 0.4, 0.6, 0.8]))
            + 1, 1, 5)
        self.num_samples = num_samples

    # ---- real-format path (ref movielens.py:157-212)
    def _load_real(self):
        import re
        import zipfile
        pattern = re.compile(r"^(.*)\((\d+)\)$")
        movie_info, user_info = {}, {}
        title_words, categories = set(), set()
        with zipfile.ZipFile(self.data_file) as pkg:
            with pkg.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = line.decode(
                        "latin-1").strip().split("::")
                    cats = cats.split("|")
                    categories.update(cats)
                    title = pattern.match(title).group(1)
                    movie_info[int(mid)] = (int(mid), cats, title)
                    title_words.update(w.lower() for w in title.split())
            self.movie_title_dict = {w: i
                                     for i, w in enumerate(title_words)}
            self.categories_dict = {c: i
                                    for i, c in enumerate(categories)}
            with pkg.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _ = line.decode(
                        "latin-1").strip().split("::")
                    user_info[int(uid)] = (
                        int(uid), 0 if gender == "M" else 1,
                        AGE_TABLE.index(int(age)), int(job))
            self._data = []
            is_test = self.mode == "test"
            with pkg.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (self._rng.random() < self.test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.decode(
                        "latin-1").strip().split("::")
                    rating = float(rating) * 2 - 5.0
                    u = user_info[int(uid)]
                    midx, cats, title = movie_info[int(mid)]
                    self._data.append(
                        [[u[0]], [u[1]], [u[2]], [u[3]],
                         [midx],
                         [self.categories_dict[c] for c in cats],
                         [self.movie_title_dict[w.lower()]
                          for w in title.split()],
                         [rating]])

    def __getitem__(self, idx):
        if hasattr(self, "_data"):
            return tuple(np.array(d) for d in self._data[idx])
        return (np.int64(self._users[idx]), np.int64(self._movies[idx]),
                np.float32(self._ratings[idx]))

    def __len__(self):
        return self.num_samples


class UCIHousing(Dataset):
    """Boston housing regression (ref text/datasets/uci_housing.py).
    With a `data_file`, parses the REAL housing.data layout (whitespace-
    separated 14-column rows) with the reference's mean/range feature
    normalization and 80/20 front/back split. Synthetic default
    otherwise."""

    FEATURES = 13

    def __init__(self, data_file=None, mode="train", num_samples=400):
        if data_file is not None:
            assert mode.lower() in ("train", "test"), mode
            self.mode = mode.lower()
            self._load_real(data_file)
            self.num_samples = len(self._x)
            return
        rng = np.random.RandomState(0 if mode == "train" else 1)
        w = np.random.RandomState(13).randn(self.FEATURES).astype("f4")
        self._x = rng.randn(num_samples, self.FEATURES).astype("f4")
        noise = 0.1 * rng.randn(num_samples).astype("f4")
        self._y = (self._x @ w + noise).astype("f4")[:, None]
        self.num_samples = num_samples

    # ---- real-format path (ref uci_housing.py:94-105)
    def _load_real(self, data_file, feature_num=14, ratio=0.8):
        data = np.fromfile(data_file, sep=" ")
        data = data.reshape(data.shape[0] // feature_num, feature_num)
        maxs, mins = data.max(axis=0), data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
        offset = int(data.shape[0] * ratio)
        part = data[:offset] if self.mode == "train" else data[offset:]
        self._x = part[:, :-1].astype("f4")
        self._y = part[:, -1:].astype("f4")

    def __getitem__(self, idx):
        return self._x[idx], self._y[idx]

    def __len__(self):
        return self.num_samples


class _SyntheticTranslationDataset(Dataset):
    """(src, trg, trg_next) triples where trg is a deterministic function
    of src (a fixed token permutation) — seq2seq models can learn it."""

    def __init__(self, mode, src_vocab, trg_vocab, seq_len, num_samples):
        rng = np.random.RandomState(0 if mode in ("train",) else 1)
        perm = np.random.RandomState(5).permutation(trg_vocab)
        self._src = rng.randint(3, src_vocab, (num_samples, seq_len))
        self._trg = perm[self._src % trg_vocab]
        self.src_vocab, self.trg_vocab = src_vocab, trg_vocab
        self.num_samples = num_samples

    def _real_item(self, idx):
        """Shared accessor for the real-format (src, trg, trg_next)
        triples both WMT loaders build."""
        return (np.array(self.src_ids[idx]),
                np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __getitem__(self, idx):
        src = self._src[idx].astype("int64")
        trg = self._trg[idx].astype("int64")
        # <s> trg as input, trg </s> as label (reference wmt convention)
        trg_in = np.concatenate([[1], trg[:-1]]).astype("int64")
        return src, trg_in, trg

    def __len__(self):
        return self.num_samples


class WMT14(_SyntheticTranslationDataset):
    """ref text/datasets/wmt14.py. With a `data_file`, parses the REAL
    wmt14 tarball format exactly as the reference does: `*src.dict` /
    `*trg.dict` members (one token per line, first dict_size lines),
    `{mode}/{mode}` members of tab-separated src/trg sentence pairs,
    <s>/<e> wrapping, UNK_IDX=2, >80-token pairs dropped. Without one,
    synthetic permutation translation with the same API."""

    START, END, UNK = "<s>", "<e>", "<unk>"
    UNK_IDX = 2

    def __init__(self, data_file=None, mode="train", dict_size=1000,
                 seq_len=16, num_samples=2000):
        assert mode.lower() in ("train", "test", "gen"), mode
        if data_file is not None:
            self.mode = mode.lower()
            self.data_file = data_file
            self.dict_size = int(dict_size)
            assert self.dict_size > 0, "dict_size should be positive"
            self._load_real()
            self.num_samples = len(self.src_ids)
            return
        super().__init__(mode, dict_size, dict_size, seq_len, num_samples)

    # ---- real-format path (ref wmt14.py:106-165)
    def _load_real(self):
        import tarfile

        def to_dict(fd, size):
            out = {}
            for i, line in enumerate(fd):
                if i >= size:
                    break
                out[line.decode().strip()] = i
            return out

        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file, mode="r") as f:
            names = [m.name for m in f if m.name.endswith("src.dict")]
            assert len(names) == 1, names
            self.src_dict = to_dict(f.extractfile(names[0]), self.dict_size)
            names = [m.name for m in f if m.name.endswith("trg.dict")]
            assert len(names) == 1, names
            self.trg_dict = to_dict(f.extractfile(names[0]), self.dict_size)
            suffix = "{}/{}".format(self.mode, self.mode)
            for name in [m.name for m in f if m.name.endswith(suffix)]:
                for line in f.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, self.UNK_IDX)
                           for w in ([self.START] + parts[0].split()
                                     + [self.END])]
                    trg = [self.trg_dict.get(w, self.UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.trg_ids_next.append(trg + [self.trg_dict[self.END]])
                    self.trg_ids.append([self.trg_dict[self.START]] + trg)
                    self.src_ids.append(src)

    def get_dict(self, reverse=False):
        src, trg = self.src_dict, self.trg_dict
        if reverse:
            src = {v: k for k, v in src.items()}
            trg = {v: k for k, v in trg.items()}
        return src, trg

    def __getitem__(self, idx):
        if hasattr(self, "src_ids"):
            return self._real_item(idx)
        return super().__getitem__(idx)

    def __len__(self):
        return self.num_samples


class WMT16(_SyntheticTranslationDataset):
    """ref text/datasets/wmt16.py. With a `data_file`, parses the REAL
    wmt16 tarball: member `wmt16/{mode}` of tab-separated en\\tde pairs;
    vocabularies are BUILT from the train corpus by frequency with
    <s>/<e>/<unk> reserved at 0/1/2 (the reference caches them as dict
    files under DATA_HOME — here they're built in memory, same content);
    `lang` selects the source column. Synthetic default otherwise."""

    START, END, UNK = "<s>", "<e>", "<unk>"

    def __init__(self, data_file=None, mode="train", src_dict_size=1000,
                 trg_dict_size=1000, lang="en", seq_len=16,
                 num_samples=2000):
        assert mode.lower() in ("train", "test", "val"), mode
        if data_file is not None:
            self.mode = mode.lower()
            self.data_file = data_file
            self.lang = lang
            en_dict, de_dict = self._build_dicts(
                int(src_dict_size) if lang == "en" else int(trg_dict_size),
                int(trg_dict_size) if lang == "en" else int(src_dict_size))
            self.src_dict = en_dict if lang == "en" else de_dict
            self.trg_dict = de_dict if lang == "en" else en_dict
            self._load_real()
            self.num_samples = len(self.src_ids)
            return
        super().__init__(mode, src_dict_size, trg_dict_size, seq_len,
                         num_samples)

    # ---- real-format path (ref wmt16.py:139-215)
    def _build_dicts(self, en_size, de_size):
        """BOTH language vocabularies in one pass over the train member
        (the reference re-reads the tarball per dict; the content is
        identical)."""
        import collections
        import tarfile
        en_freq = collections.defaultdict(int)
        de_freq = collections.defaultdict(int)
        with tarfile.open(self.data_file, mode="r") as f:
            for line in f.extractfile("wmt16/train"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                for w in parts[0].split():
                    en_freq[w] += 1
                for w in parts[1].split():
                    de_freq[w] += 1

        def mk(freq, size):
            words = [self.START, self.END, self.UNK]
            for w, _ in sorted(freq.items(), key=lambda x: x[1],
                               reverse=True):
                if len(words) == size:
                    break
                words.append(w)
            return {w: i for i, w in enumerate(words)}

        return mk(en_freq, en_size), mk(de_freq, de_size)

    def _load_real(self):
        import tarfile
        start_id = self.src_dict[self.START]
        end_id = self.src_dict[self.END]
        unk_id = self.src_dict[self.UNK]
        src_col = 0 if self.lang == "en" else 1
        trg_col = 1 - src_col
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file, mode="r") as f:
            for line in f.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [start_id] + [self.src_dict.get(w, unk_id)
                                    for w in parts[src_col].split()] \
                    + [end_id]
                trg = [self.trg_dict.get(w, unk_id)
                       for w in parts[trg_col].split()]
                self.trg_ids_next.append(trg + [end_id])
                self.trg_ids.append([start_id] + trg)
                self.src_ids.append(src)

    def get_dict(self, lang, reverse=False):
        """ref wmt16 get_dict(lang): the built vocabulary for `lang`."""
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d

    def __getitem__(self, idx):
        if hasattr(self, "src_ids"):
            return self._real_item(idx)
        return super().__getitem__(idx)

    def __len__(self):
        return self.num_samples


class Conll05st(Dataset):
    """SRL dataset (ref text/datasets/conll05.py). With `data_file` (+
    the three dict files), parses the REAL conll05st-release layout:
    test.wsj words.gz/props.gz members, the bracket-format proposition
    labels expanded to BIO tags, and the reference's 9-feature samples
    (words, 5 predicate-context columns, predicate, mark, labels).
    Divergence: the label dict enumerates tags in SORTED order (the
    reference iterates a python set — hash order). Synthetic default
    otherwise."""

    NUM_LABELS = 9
    UNK_IDX = 0

    def __init__(self, data_file=None, mode="train", vocab_size=2000,
                 seq_len=32, num_samples=1000, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None):
        if data_file is not None:
            if not (word_dict_file and verb_dict_file
                    and target_dict_file):
                raise ValueError(
                    "real-format Conll05st needs word_dict_file, "
                    "verb_dict_file and target_dict_file")
            # the public conll05st release (and the reference loader)
            # ships ONLY the test.wsj split; mode is a synthetic-path
            # parameter and is ignored here like in the reference
            self.mode = "test"
            self.data_file = data_file
            self.word_dict = self._load_dict(word_dict_file)
            self.predicate_dict = self._load_dict(verb_dict_file)
            self.label_dict = self._load_label_dict(target_dict_file)
            self._load_anno()
            self.num_samples = len(self.sentences)
            return
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.vocab_size = vocab_size
        self._words = rng.randint(0, vocab_size, (num_samples, seq_len))
        lab = np.random.RandomState(3).randint(
            0, self.NUM_LABELS, vocab_size)
        self._labels = lab[self._words]
        self._preds = rng.randint(0, vocab_size, num_samples)
        self.num_samples = num_samples

    # ---- real-format path (ref conll05.py:146-292)
    @staticmethod
    def _load_dict(filename):
        with open(filename) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(filename):
        tags = set()
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("B-", "I-")):
                    tags.add(line[2:])
        d, index = {}, 0
        for tag in sorted(tags):           # deterministic (see docstring)
            d["B-" + tag] = index
            d["I-" + tag] = index + 1
            index += 2
        d["O"] = index
        return d

    def _load_anno(self):
        import gzip
        import tarfile
        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                sentences, labels, one_seg = [], [], []
                for word, label in zip(words_file, props_file):
                    word = word.strip().decode()
                    label = label.strip().decode().split()
                    if label:                        # inside a sentence
                        sentences.append(word)
                        one_seg.append(label)
                        continue
                    # end of sentence: transpose the per-token columns
                    for i in range(len(one_seg[0]) if one_seg else 0):
                        labels.append([x[i] for x in one_seg])
                    if labels:
                        verb_list = [x for x in labels[0] if x != "-"]
                        for i, lbl in enumerate(labels[1:]):
                            self.sentences.append(sentences)
                            self.predicates.append(verb_list[i])
                            self.labels.append(self._expand_bio(lbl))
                    sentences, labels, one_seg = [], [], []

    @staticmethod
    def _expand_bio(lbl):
        """Bracket props column -> BIO tags (ref conll05.py:204-224)."""
        cur_tag, in_bracket, out = "O", False, []
        for l in lbl:
            if l == "*" and not in_bracket:
                out.append("O")
            elif l == "*" and in_bracket:
                out.append("I-" + cur_tag)
            elif l == "*)":
                out.append("I-" + cur_tag)
                in_bracket = False
            elif "(" in l and ")" in l:
                cur_tag = l[1:l.find("*")]
                out.append("B-" + cur_tag)
                in_bracket = False
            elif "(" in l:
                cur_tag = l[1:l.find("*")]
                out.append("B-" + cur_tag)
                in_bracket = True
            else:
                raise RuntimeError(f"Unexpected label: {l}")
        return out

    def _real_item(self, idx):
        sentence = self.sentences[idx]
        predicate = self.predicates[idx]
        labels = self.labels[idx]
        sen_len = len(sentence)
        verb_index = labels.index("B-V")
        mark = [0] * len(labels)

        def ctx(off, fallback):
            i = verb_index + off
            if 0 <= i < len(labels):
                mark[i] = 1
                return sentence[i]
            return fallback

        ctx_n2 = ctx(-2, "bos")
        ctx_n1 = ctx(-1, "bos")
        ctx_0 = ctx(0, "bos")
        ctx_p1 = ctx(1, "eos")
        ctx_p2 = ctx(2, "eos")
        wd = self.word_dict
        word_idx = [wd.get(w, self.UNK_IDX) for w in sentence]
        cols = [[wd.get(c, self.UNK_IDX)] * sen_len
                for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
        try:
            pred_idx = [self.predicate_dict[predicate]] * sen_len
            label_idx = [self.label_dict[w] for w in labels]
        except KeyError as e:
            raise KeyError(
                f"Conll05st: {e.args[0]!r} missing from the verb/target "
                "dict files (real props files can contain tags like 'C-V' "
                "beyond the basic BIO set)") from None
        return (np.array(word_idx), np.array(cols[0]), np.array(cols[1]),
                np.array(cols[2]), np.array(cols[3]), np.array(cols[4]),
                np.array(pred_idx), np.array(mark), np.array(label_idx))

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def __getitem__(self, idx):
        if hasattr(self, "sentences"):
            return self._real_item(idx)
        return (self._words[idx].astype("int64"),
                np.int64(self._preds[idx]),
                self._labels[idx].astype("int64"))

    def __len__(self):
        return self.num_samples


# --------------------------------------------------------------------------- #
# ViterbiDecoder (paddle.text.ViterbiDecoder in later 2.x; included for the  #
# sequence-labeling zoo) — a max-plus loop over time and a backtrace          #
# --------------------------------------------------------------------------- #

from ..ops.dispatch import apply, register_op  # noqa: E402


def _viterbi_decode_raw(pot, trans, *maybe_lens):
    """pot [B, T, N], trans [N, N] (, lens [B]) -> (best scores [B], paths
    [B, T]). Rows past their length stay frozen: the score unchanged and
    identity back-pointers, so the backtrace passes straight through;
    their padded path steps read 0. Ties take the first index."""
    lens = maybe_lens[0] if maybe_lens else None
    B, T, N = pot.shape
    score = pot[:, 0]
    ident = torch.arange(N, device=pot.device).expand(B, N)
    backs = []
    for t in range(1, T):
        cand = score[:, :, None] + trans[None]       # [B, N, N]
        best, idx = torch.max(cand, dim=1)           # first index on ties
        best = best + pot[:, t]
        if lens is not None:
            active = (t < lens)[:, None]
            best = torch.where(active, best, score)
            idx = torch.where(active, idx, ident)
        score = best
        backs.append(idx)
    cur = torch.argmax(score, dim=-1)
    path = [cur]
    for idx in reversed(backs):
        cur = torch.gather(idx, 1, cur[:, None])[:, 0]
        path.append(cur)
    paths = torch.stack(path[::-1], dim=1)
    if lens is not None:
        paths = torch.where(torch.arange(T, device=pot.device)[None, :]
                            < lens[:, None], paths, 0)
    return torch.max(score, dim=-1).values, paths


register_op("viterbi_decode", _viterbi_decode_raw)


def viterbi_decode(potentials, transitions, lengths=None,
                   include_bos_eos_tag=False):
    """Batched Viterbi: potentials [B, T, N], transitions [N, N] ->
    (scores [B], paths [B, T]). `include_bos_eos_tag` is accepted and
    ignored, as in the JAX package."""
    args = ((potentials, transitions) if lengths is None
            else (potentials, transitions, lengths))
    return apply(_viterbi_decode_raw, args, name="viterbi_decode",
                 differentiable=False)


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=False, name=None):
        self.transitions = transitions

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths)
