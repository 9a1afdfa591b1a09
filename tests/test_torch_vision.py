"""The port's `vision` against the JAX package's: every transform on the
same images under the same numpy RNG state; the synthetic datasets
sample for sample; `DatasetFolder` and `ImageFolder` over `.npy` trees;
LeNet (1 x 28 x 28), resnet18 (3 x 64 x 64), vgg11's batch-normed
features (3 x 32 x 32) and MobileNet V1/V2 at scale 0.25 (3 x 128 x
128), batch 2, the port in f32 from the JAX models' weights
(`set_state_dict` of their `state_dict()` arrays): the forward, every
gradient, the BatchNorm running statistics and the weights after one
training step (forward, backward, SGD) against the JAX models run in
float64 (tests/torch_vision_ref.py, which says why the inputs are that
large); resnet50's and vgg16's state-dict keys and shapes, and
resnet50's eval-mode forward against the JAX model's in float64.

Tolerances: `Resize` and `RandomResizedCrop` within one uint8 level
(JAX truncates a float32 resize back to uint8; the two resizes agree to
float32 rounding) and float images within 1e-4 x max(1, |ref|); every
other transform and every dataset sample exactly; model outputs, the
running statistics, the stepped weights and the gradients within 1e-4 x
max(1, max|ref|) per tensor; a conv bias that feeds a training-mode
BatchNorm (vgg11's) has a zero gradient in exact arithmetic, and is held
within 1e-4 x max(1, max|its conv weight's gradient|).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.vision import datasets as jd
from paddle_tpu.vision import transforms as jt
from paddle_tpu_torch.vision import datasets as td
from paddle_tpu_torch.vision import models as tmod
from paddle_tpu_torch.vision import transforms as tt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_vision_ref as vision_ref  # noqa: E402

# one intra-op thread: parallel test workers share the host's cores
torch.set_num_threads(1)

RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.fixture(autouse=True)
def _no_data_home(tmp_path, monkeypatch):
    # an empty cache home: every zoo dataset takes its synthetic path
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path / "home"))


IMG = np.random.RandomState(0).randint(0, 256, (37, 45, 3)).astype("uint8")
IMGF = np.random.RandomState(1).rand(37, 45, 3).astype("f4")
CHW = np.random.RandomState(2).rand(3, 20, 24).astype("f4")

# (name, transform of a package's transforms module, image)
TRANSFORMS = [
    ("ToTensor", lambda T: T.ToTensor(), IMG),
    ("ToTensor_hwc", lambda T: T.ToTensor("HWC"), IMGF),
    ("Normalize", lambda T: T.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.1]),
     CHW),
    ("Normalize_hwc", lambda T: T.Normalize(0.5, 0.25, "HWC"), IMGF),
    ("CenterCrop", lambda T: T.CenterCrop(20), IMG),
    ("RandomCrop", lambda T: T.RandomCrop((24, 30), padding=3), IMG),
    ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(0.5), IMG),
    ("RandomVerticalFlip", lambda T: T.RandomVerticalFlip(0.5), IMG),
    ("Transpose", lambda T: T.Transpose(), IMG),
    ("BrightnessTransform", lambda T: T.BrightnessTransform(0.4), IMG),
    ("ContrastTransform", lambda T: T.ContrastTransform(0.4), IMG),
    ("SaturationTransform", lambda T: T.SaturationTransform(0.4), IMG),
    ("HueTransform", lambda T: T.HueTransform(0.1), IMG),
    ("ColorJitter", lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1), IMG),
    ("Grayscale", lambda T: T.Grayscale(3), IMG),
    ("Pad", lambda T: T.Pad((1, 2, 3, 4), fill=7), IMG),
    ("Pad_reflect", lambda T: T.Pad(2, padding_mode="reflect"), IMG),
    ("RandomRotation", lambda T: T.RandomRotation(30, fill=1), IMG),
    ("RandomErasing", lambda T: T.RandomErasing(prob=1.0, value=5), CHW),
    ("Compose", lambda T: T.Compose([T.RandomHorizontalFlip(),
                                     T.CenterCrop(30), T.ToTensor(),
                                     T.Normalize(0.5, 0.5)]), IMG),
]

# resizing transforms: within one uint8 level / 1e-4 for floats
RESIZES = [
    ("Resize_down", lambda T: T.Resize((16, 24)), IMG),
    ("Resize_up", lambda T: T.Resize(64), IMG),
    ("Resize_mixed_float", lambda T: T.Resize((20, 90)), IMGF),
    ("Resize_gray", lambda T: T.Resize((11, 13)), IMG[..., 0]),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(24), IMG),
    ("RandomResizedCrop_up", lambda T: T.RandomResizedCrop(
        (50, 60), scale=(0.2, 0.5)), IMGF),
    ("resize", lambda T: (lambda im: T.resize(im, (30, 20))), IMG),
]

FUNCTIONAL = [
    ("to_tensor", lambda T: lambda im: T.to_tensor(im), IMG),
    ("normalize", lambda T: lambda im: T.normalize(im, 0.2, 0.5), CHW),
    ("hflip", lambda T: T.hflip, IMG),
    ("vflip", lambda T: T.vflip, IMG),
    ("adjust_brightness", lambda T: lambda im: T.adjust_brightness(im, 1.3),
     IMG),
    ("adjust_contrast", lambda T: lambda im: T.adjust_contrast(im, 0.7),
     IMG),
    ("adjust_saturation", lambda T: lambda im: T.adjust_saturation(im, 1.4),
     IMG),
    ("adjust_hue", lambda T: lambda im: T.adjust_hue(im, -0.2), IMGF),
    ("to_grayscale", lambda T: lambda im: T.to_grayscale(im), IMG),
    ("rotate", lambda T: lambda im: T.rotate(im, 17.0), IMG),
    ("crop", lambda T: lambda im: T.crop(im, 3, 4, 10, 12), CHW),
    ("center_crop", lambda T: lambda im: T.center_crop(im, 9), IMG),
    ("pad", lambda T: lambda im: T.pad(im, (1, 2), padding_mode="edge"),
     IMG),
]


def apply(T, make, img, seed):
    np.random.seed(seed)
    return np.asarray(make(T)(img.copy()))


@pytest.mark.parametrize("name,make,img", TRANSFORMS + FUNCTIONAL,
                         ids=[c[0] for c in TRANSFORMS + FUNCTIONAL])
def test_transform_equals_jax(name, make, img):
    for seed in (0, 1, 2):
        want = apply(jt, make, img, seed)
        got = apply(tt, make, img, seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,make,img", RESIZES,
                         ids=[c[0] for c in RESIZES])
def test_resize_within_tolerance_of_jax(name, make, img):
    for seed in (0, 1, 2):
        want = apply(jt, make, img, seed)
        got = apply(tt, make, img, seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        err = np.abs(got.astype("f8") - want.astype("f8"))
        if want.dtype == np.uint8:
            assert err.max() <= 1, err.max()
        else:
            assert (err <= RTOL * np.maximum(1, np.abs(want))).all(), \
                err.max()


@pytest.mark.parametrize("name,index,modes", [
    ("MNIST", (0, 17, 4095), ("train", "test")),
    ("FashionMNIST", (3,), ("test",)),
    ("Cifar10", (0, 511, 1023), ("train", "test")),
    ("Cifar100", (5,), ("train",)), ("Flowers", (0, 99), ("train", "test")),
    ("VOC2012", (0, 63), ("train", "test"))])
def test_synthetic_datasets_equal_jax(name, index, modes):
    for mode in modes:
        j = getattr(jd, name)(mode=mode)
        t = getattr(td, name)(mode=mode)
        assert len(t) == len(j)
        for i in index:
            for a, b in zip(t[i], j[i]):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_folder_datasets_over_npy_files(tmp_path):
    rng = np.random.RandomState(3)
    for c in ("cat", "dog", "emu"):
        os.makedirs(tmp_path / c / "sub")
        for k in range(3):
            np.save(tmp_path / c / f"{k}.npy",
                    rng.randint(0, 256, (9, 7, 3)).astype("uint8"))
        np.save(tmp_path / c / "sub" / "x.npy", rng.rand(4, 4).astype("f4"))
    (tmp_path / "cat" / "notes.txt").write_text("not an image")
    tf = [lambda T: T.Compose([T.RandomResizedCrop(5), T.ToTensor()]),
          lambda T: None]
    for make in tf:
        j = jd.DatasetFolder(str(tmp_path), transform=make(jt))
        t = td.DatasetFolder(str(tmp_path), transform=make(tt))
        assert t.classes == j.classes == ["cat", "dog", "emu"]
        assert t.samples == j.samples and len(t) == 12
        for i in range(len(t)):
            np.random.seed(i)
            want = j[i]
            np.random.seed(i)
            got = t[i]
            assert got[1] == want[1]
            err = np.abs(np.asarray(got[0], "f8") - np.asarray(want[0], "f8"))
            assert err.max() <= (RTOL if make(tt) else 0)
    jf = jd.ImageFolder(str(tmp_path))
    tfo = td.ImageFolder(str(tmp_path))
    assert tfo.samples == jf.samples
    np.testing.assert_array_equal(tfo[4][0], jf[4][0])
    with pytest.raises(ValueError):
        td.DatasetFolder(str(tmp_path / "cat" / "sub"))


def close(got, want, what, scale=None):
    """Within RTOL x max(1, max|want|), or RTOL x max(1, `scale`)."""
    got, want = np.asarray(got, "f8"), np.asarray(want, "f8")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if scale is None else scale)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (what, err, scale)


@pytest.fixture(scope="module")
def f64_refs(tmp_path_factory):
    """The JAX models' float64 references (tests/torch_vision_ref.py,
    run in a process of its own: x64 is process-wide in JAX)."""
    out = tmp_path_factory.mktemp("vision_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "torch_vision_ref.py"), str(out)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as blobs:
        return dict(blobs)


def refs_of(blobs, name, kind):
    pre = f"{name}/{kind}/"
    return {k[len(pre):]: v for k, v in blobs.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", sorted(vision_ref.MODELS))
def test_model_train_step_against_jax_f64(name, f64_refs):
    """The port in f32 from the JAX model's weights: one training step
    (forward in training mode, backward of sum(out * cot), SGD at 0.1)
    against the JAX model's float64 forward and gradients."""
    sd = refs_of(f64_refs, name, "sd")
    tm = vision_ref.build(tmod, name)
    tsd = tm.state_dict()
    assert list(tsd) == list(sd)
    assert [tuple(v.shape) for v in tsd.values()] == \
        [v.shape for v in sd.values()]
    assert tm.set_state_dict(sd) == ([], [])
    tm.train()
    out = tm(pt.to_tensor(f64_refs[f"{name}/x"]))
    (out * pt.to_tensor(f64_refs[f"{name}/cot"])).sum().backward()
    close(out.numpy(), f64_refs[f"{name}/out"], "out")
    grads = refs_of(f64_refs, name, "grad")
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(grads)
    for k, g in grads.items():
        if k.endswith("bias") and np.abs(g).max() <= 1e-9:
            # a conv bias feeding a training-mode BatchNorm: its gradient
            # is 0 in exact arithmetic and f32 round-off of its conv's
            # output gradients in either package, so it is held on the
            # scale of its conv weight's gradient
            close(named[k].grad.numpy(), g, f"grad {k}",
                  scale=float(np.abs(grads[k[:-4] + "weight"]).max()))
            continue
        close(named[k].grad.numpy(), g, f"grad {k}")
    bufs = refs_of(f64_refs, name, "buffer")
    assert sorted(dict(tm.named_buffers())) == sorted(bufs)
    for k, b in tm.named_buffers():
        close(b.numpy(), bufs[k], f"buffer {k}")
    assert any(k.endswith("_mean") for k in bufs) or name == "lenet"
    pt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters()).step()
    for k, p in named.items():
        close(p.numpy(), sd[k].astype("f8") - 0.1 * grads[k], f"weight {k}")


def test_large_models_against_jax(f64_refs):
    """resnet50: the JAX model's state-dict keys and shapes, and its
    eval-mode forward in float64 from the same weights; vgg16 with its
    classifier: the keys and shapes."""
    sd = refs_of(f64_refs, "resnet50", "sd")
    tm = tmod.resnet50()
    tsd = tm.state_dict()
    assert list(tsd) == list(sd)
    assert [tuple(v.shape) for v in tsd.values()] == \
        [v.shape for v in sd.values()]
    assert tm.set_state_dict(sd) == ([], [])
    tm.eval()
    with pt.no_grad():
        out = tm(pt.to_tensor(f64_refs["resnet50/x"])).numpy()
    close(out, f64_refs["resnet50/out"], "resnet50 out")
    want = json.loads(str(f64_refs["vgg16/shapes"]))
    got = [(k, list(v.shape)) for k, v in tmod.vgg16().state_dict().items()]
    assert got == [tuple(kv) for kv in want]
