"""Dataset zoo (the port of `paddle_tpu/vision/datasets.py`; ref
python/paddle/vision/datasets: MNIST, FashionMNIST, Cifar10/100,
DatasetFolder, ImageFolder, Flowers, VOC2012).

Real data when it is present: each dataset probes the cache home
(`$PADDLE_TPU_DATA_HOME`, default ~/.cache/paddle_tpu/dataset) for the
canonical files (idx-ubyte[.gz] for the MNIST family,
cifar-10-batches-bin for CIFAR) and parses them as the reference's
readers do. Nothing is downloaded: with no files the loaders fall back
to deterministic synthetic data with learnable class signal, bit for bit
the JAX package's (`_SyntheticImageDataset`). The folder datasets read
`.npy` arrays with numpy and other images with PIL, imported only when
such a file is read. Samples are numpy arrays; the DataLoader makes them
Tensors.
"""
import gzip
import os
import struct
import tarfile

import numpy as np

from ..io import Dataset


def data_home():
    return os.path.expanduser(os.environ.get(
        "PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


class _SyntheticImageDataset(Dataset):
    """Deterministic fake data with learnable signal: class-dependent mean
    patterns so convergence tests exercise real learning."""

    def __init__(self, num_samples, image_shape, num_classes, transform=None,
                 seed=0, pattern_seed=1234):
        self.num_samples = num_samples
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.transform = transform
        # class patterns are split-independent (train and test must share the
        # underlying "digit shapes"); `seed` only varies the noise + labels
        self._patterns = np.random.RandomState(pattern_seed).rand(
            num_classes, *image_shape).astype(np.float32)
        rng = np.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes, num_samples)
        self._seed = seed * 1_000_003

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seed + idx + 1)
        label = self._labels[idx]
        img = (self._patterns[label]
               + 0.3 * rng.randn(*self.image_shape).astype(np.float32))
        if self.transform is not None:
            img = self.transform(img)
        return img.astype(np.float32), np.int64(label)

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """ref python/paddle/vision/datasets/mnist.py. Reads idx/gz files when
    `image_path`/`label_path` given; otherwise synthetic 28x28."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path or label_path:
            # explicit paths are authoritative: fail loudly, never silently
            # substitute cache/synthetic data for what the user asked for
            if not (image_path and label_path):
                raise ValueError(
                    "MNIST: give BOTH image_path and label_path (or "
                    "neither, to probe the dataset cache home)")
            for pth in (image_path, label_path):
                if not os.path.exists(pth):
                    raise FileNotFoundError(f"MNIST: {pth} does not exist")
        else:
            # canonical filenames in the standard cache home (what the
            # reference's downloader leaves behind)
            stem = "train" if mode == "train" else "t10k"
            base = os.path.join(data_home(), self.NAME)
            for suff in (".gz", ""):
                ip = os.path.join(base, f"{stem}-images-idx3-ubyte{suff}")
                lp = os.path.join(base, f"{stem}-labels-idx1-ubyte{suff}")
                if os.path.exists(ip) and os.path.exists(lp):
                    image_path, label_path = ip, lp
                    break
        if image_path and label_path:
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            n = 60000 if mode == "train" else 10000
            n = min(n, 4096)  # synthetic: keep small
            synth = _SyntheticImageDataset(n, (1, 28, 28), 10,
                                           seed=0 if mode == "train" else 1)
            self.images = np.stack([synth[i][0] for i in range(n)])
            self.labels = np.asarray([synth[i][1] for i in range(n)])

    @staticmethod
    def _read_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return (data.reshape(n, 1, rows, cols).astype(np.float32) / 255.0)

    @staticmethod
    def _read_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """ref python/paddle/dataset/cifar.py: the binary-batches format —
    per record 1 label byte (2 for cifar-100: coarse+fine) + 3072 image
    bytes (RGB planes, 32x32). Reads extracted *-batches-bin dirs or the
    distribution tar.gz; synthetic fallback when neither exists."""

    NUM_CLASSES = 10
    DIRNAME = "cifar-10-batches-bin"
    TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
    TEST_FILES = ["test_batch.bin"]
    LABEL_BYTES = 1

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        imgs, labels = self._load_real(data_file, mode)
        if imgs is None:
            synth = _SyntheticImageDataset(
                1024, (3, 32, 32), self.NUM_CLASSES,
                seed=0 if mode == "train" else 1)
            imgs = np.stack([synth[i][0] for i in range(len(synth))])
            labels = np.asarray([synth[i][1] for i in range(len(synth))])
        self.images, self.labels = imgs, labels

    # ------------------------------------------------------------- real IO
    def _load_real(self, data_file, mode):
        names = self.TRAIN_FILES if mode == "train" else self.TEST_FILES
        base = os.path.join(data_home(), "cifar", self.DIRNAME)
        if data_file:
            # explicit file is authoritative: fail loudly rather than
            # silently training on cache/synthetic data
            if not os.path.exists(data_file):
                raise FileNotFoundError(
                    f"Cifar: {data_file} does not exist")
            if not data_file.endswith((".tar.gz", ".tgz")):
                raise ValueError(
                    f"Cifar: expected a .tar.gz distribution archive, "
                    f"got {data_file}")
            blobs = []
            with tarfile.open(data_file, "r:gz") as tf:
                for m in tf.getmembers():
                    if os.path.basename(m.name) in names:
                        blobs.append(tf.extractfile(m).read())
            if not blobs:
                raise ValueError(
                    f"Cifar: no {names} members inside {data_file}")
            return self._parse(b"".join(blobs))
        paths = [os.path.join(base, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            return self._parse(b"".join(open(p, "rb").read()
                                        for p in paths))
        return None, None

    def _parse(self, blob):
        rec = self.LABEL_BYTES + 3072
        n = len(blob) // rec
        arr = np.frombuffer(blob[:n * rec], np.uint8).reshape(n, rec)
        labels = arr[:, self.LABEL_BYTES - 1].astype(np.int64)  # fine label
        # keep uint8 resident (a real CIFAR train split is ~150MB; float32
        # would 4x it) — items convert on access
        imgs = arr[:, self.LABEL_BYTES:].reshape(n, 3, 32, 32).copy()
        return imgs, labels

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
    DIRNAME = "cifar-100-binary"
    TRAIN_FILES = ["train.bin"]
    TEST_FILES = ["test.bin"]
    LABEL_BYTES = 2     # coarse + fine; fine is authoritative


# --------------------------------------------------------------------------
# folder datasets (ref python/paddle/vision/datasets/folder.py): REAL image
# decoding via PIL over class-per-directory trees — the generic "bring your
# own images" path that needs no downloads
# --------------------------------------------------------------------------

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


class DatasetFolder(Dataset):
    """class-per-subdirectory image tree -> (image, class_index) samples
    (ref folder.py DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions or IMG_EXTENSIONS)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"DatasetFolder: no class dirs under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    path = os.path.join(dirpath, fn)
                    ok = (is_valid_file(path) if is_valid_file
                          else fn.lower().endswith(extensions))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"DatasetFolder: no images under {root}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """flat (recursive) image list, no labels (ref folder.py ImageFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = tuple(extensions or IMG_EXTENSIONS)
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                path = os.path.join(dirpath, fn)
                ok = (is_valid_file(path) if is_valid_file
                      else fn.lower().endswith(extensions))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise ValueError(f"ImageFolder: no images under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """ref datasets/flowers.py (102-category). Three real-data paths:
    the REAL archive triplet (102flowers.tgz + imagelabels.mat +
    setid.mat — parsed exactly like the reference, including its
    train<->tstid flag swap), a class-per-dir tree in the cache home,
    or the synthetic 3x64x64 fallback (zero-egress)."""

    # ref flowers.py MODE_FLAG_MAP: "test data is more than train data"
    MODE_FLAG_MAP = {"train": "tstid", "test": "trnid", "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        self.backend = backend
        if data_file or label_file or setid_file:
            if not (data_file and label_file and setid_file):
                raise ValueError(
                    "Flowers real-archive mode needs ALL of data_file "
                    "(102flowers.tgz), label_file (imagelabels.mat) and "
                    "setid_file (setid.mat) — the zero-egress build "
                    "cannot download the missing pieces")
            self._init_real_archives(data_file, label_file, setid_file,
                                     mode)
            return
        root = os.path.join(data_home(), "flowers")
        if os.path.isdir(root) and any(
                os.path.isdir(os.path.join(root, d))
                for d in os.listdir(root) if not d.startswith(".")):
            folder = DatasetFolder(root, transform=transform)
            # deterministic 80/20 split by sample index (the reference
            # splits via setid.mat; without it train/test must still be
            # DISJOINT or evaluation leaks the training set)
            keep = (0, 1, 2, 3) if mode == "train" else (4,)
            folder.samples = [sm for i, sm in enumerate(folder.samples)
                              if i % 5 in keep]
            self._folder = folder
            self.images = self.labels = None
        else:
            self._folder = None
            synth = _SyntheticImageDataset(
                512, (3, 64, 64), 102, seed=0 if mode == "train" else 1)
            self.images = np.stack([synth[i][0] for i in range(len(synth))])
            self.labels = np.asarray([synth[i][1]
                                      for i in range(len(synth))])

    # ---- real-archive path (ref flowers.py:122-160)
    def _init_real_archives(self, data_file, label_file, setid_file, mode):
        import tarfile
        import scipy.io as scio
        self._folder = None
        self.images = self.labels = None
        self._tar = tarfile.open(data_file)
        self._name2mem = {m.name: m for m in self._tar.getmembers()}
        self._mat_labels = scio.loadmat(label_file)["labels"][0]
        self._indexes = scio.loadmat(setid_file)[
            self.MODE_FLAG_MAP[mode.lower()]][0]

    def _real_archive_item(self, idx):
        import io as _io
        from PIL import Image
        index = int(self._indexes[idx])
        label = np.array([self._mat_labels[index - 1]])
        raw = self._tar.extractfile(
            self._name2mem["jpg/image_%05d.jpg" % index]).read()
        image = Image.open(_io.BytesIO(raw))
        if self.backend != "pil":
            image = np.array(image)
        if self.transform is not None:
            image = self.transform(image)
        if self.backend == "pil":
            return image, label.astype("int64")
        return np.asarray(image, dtype="float32"), label.astype("int64")

    def __getitem__(self, idx):
        if getattr(self, "_indexes", None) is not None:
            return self._real_archive_item(idx)
        if self._folder is not None:
            return self._folder[idx]
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        if getattr(self, "_indexes", None) is not None:
            return len(self._indexes)
        return (len(self._folder) if self._folder is not None
                else len(self.images))


class VOC2012(Dataset):
    """ref datasets/voc2012.py (segmentation pairs). Real VOCdevkit layout
    when present in the cache home; synthetic (image, mask) fallback."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        base = os.path.join(data_home(), "voc2012", "VOCdevkit", "VOC2012")
        lst = os.path.join(base, "ImageSets", "Segmentation",
                           ("train" if mode == "train" else "val") + ".txt")
        if os.path.exists(lst):
            names = [l.strip() for l in open(lst) if l.strip()]
            self._pairs = [
                (os.path.join(base, "JPEGImages", n + ".jpg"),
                 os.path.join(base, "SegmentationClass", n + ".png"))
                for n in names]
        else:
            self._pairs = None
            rng = np.random.RandomState(0 if mode == "train" else 1)
            self._imgs = rng.rand(64, 3, 32, 32).astype("f4")
            self._masks = rng.randint(0, 21, (64, 32, 32)).astype("i8")

    def __getitem__(self, idx):
        if self._pairs is not None:
            img_p, mask_p = self._pairs[idx]
            img = _default_loader(img_p)
            from PIL import Image
            with Image.open(mask_p) as m:
                mask = np.asarray(m, dtype=np.int64)
        else:
            img, mask = self._imgs[idx], self._masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return (len(self._pairs) if self._pairs is not None
                else len(self._imgs))
