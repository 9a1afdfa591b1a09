"""Vision transforms (the port of `paddle_tpu/vision/transforms.py`; ref
python/paddle/vision/transforms): host-side, compose-based, on HWC numpy
images (uint8 or float). They draw from the global numpy RNG, as the JAX
package's do, so one numpy seed gives the same crops and flips in both.

`Resize` (and `RandomResizedCrop` through it) resizes with torch on the
CPU where the JAX package calls `jax.image.resize(..., "linear")`: both
are bilinear over half-pixel centres in float32, antialiased with a
triangle kernel widened by the scale when they shrink, their weights
renormalised at the borders. A uint8 image is resized in float32 and
truncated back (`astype`), as the JAX package does. The two agree to
float32 rounding, so a truncated uint8 pixel may differ by one level.
"""
import numbers

import numpy as np
import torch
import torch.nn.functional as TF


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    """HWC uint8 -> CHW float32 in [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if self.data_format == "CHW":
            arr = np.transpose(arr, (2, 0, 1))
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        n = arr.shape[0 if self.data_format == "CHW" else -1]
        mean = self.mean[:n]
        std = self.std[:n]
        if self.data_format == "CHW":
            return (arr - mean[:, None, None]) / std[:, None, None]
        return (arr - mean) / std


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        x = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        hwc = arr.ndim == 3
        x = x.permute(2, 0, 1)[None] if hwc else x[None, None]
        out = TF.interpolate(x, size=self.size, mode="bilinear",
                             align_corners=False, antialias=True)
        out = (out[0].permute(1, 2, 0) if hwc else out[0, 0]).numpy()
        return out.astype(arr.dtype) if arr.dtype == np.uint8 else out


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pad = ((p, p), (p, p)) + (((0, 0),) if arr.ndim == 3 else ())
            arr = np.pad(arr, pad)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self.scale) * area
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * aspect)))
            th = int(round(np.sqrt(target_area / aspect)))
            if 0 < tw <= w and 0 < th <= h:
                i = np.random.randint(0, h - th + 1)
                j = np.random.randint(0, w - tw + 1)
                return self._resize(arr[i:i + th, j:j + tw])
        return self._resize(CenterCrop(min(h, w))(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(arr * alpha, 0, 255).astype(np.asarray(img).dtype)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


# ------------------------------------------------------------ functional tail
# (ref python/paddle/vision/transforms/functional.py — host-side numpy)

def adjust_brightness(img, factor):
    """Blend with black: out = img * factor (clipped for uint8)."""
    arr = np.asarray(img)
    out = arr.astype(np.float32) * float(factor)
    return (np.clip(out, 0, 255).astype(np.uint8)
            if arr.dtype == np.uint8 else out)


def adjust_contrast(img, factor):
    """Blend with the GRAYSCALE mean of the image (0.299/0.587/0.114
    weights, matching the reference/PIL), not the raw channel mean."""
    arr = np.asarray(img)
    f = arr.astype(np.float32)
    if f.ndim == 3 and f.shape[-1] >= 3:
        gray = (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2])
        mean = gray.mean()
    else:
        mean = f.mean()
    out = mean + (f - mean) * float(factor)
    return (np.clip(np.round(out), 0, 255).astype(np.uint8)
            if arr.dtype == np.uint8 else out)


def adjust_saturation(img, factor):
    """Blend with the grayscale version (HWC, 3 channels)."""
    arr = np.asarray(img)
    f = arr.astype(np.float32)
    gray = (0.299 * f[..., 0] + 0.587 * f[..., 1]
            + 0.114 * f[..., 2])[..., None]
    out = gray + (f - gray) * float(factor)
    return (np.clip(out, 0, 255).astype(np.uint8)
            if arr.dtype == np.uint8 else out)


def adjust_hue(img, factor):
    """Rotate hue by factor in [-0.5, 0.5] (HWC uint8/float RGB)."""
    arr = np.asarray(img)
    f = arr.astype(np.float32) / (255.0 if arr.dtype == np.uint8 else 1.0)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = f[..., :3].max(-1)
    minc = f[..., :3].min(-1)
    v = maxc
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(c > 0, (maxc - r) / np.maximum(c, 1e-12), 0.0)
    gc = np.where(c > 0, (maxc - g) / np.maximum(c, 1e-12), 0.0)
    bc = np.where(c > 0, (maxc - b) / np.maximum(c, 1e-12), 0.0)
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)) / 6.0
    h = (h + float(factor)) % 1.0
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    if arr.dtype == np.uint8:
        return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
    return out


def to_grayscale(img, num_output_channels=1):
    arr = np.asarray(img)
    f = arr.astype(np.float32)
    gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return (np.clip(np.round(out), 0, 255).astype(np.uint8)
            if arr.dtype == np.uint8 else out)


def rotate(img, angle, center=None, fill=0):
    """Rotate counter-clockwise by `angle` degrees about the center
    (nearest-neighbor, same output size — ref F.rotate defaults)."""
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    yy, xx = np.mgrid[0:h, 0:w]
    # inverse map: output pixel -> source pixel
    xs = cos * (xx - cx) + sin * (yy - cy) + cx
    ys = -sin * (xx - cx) + cos * (yy - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(arr, fill)
    out[valid] = arr[yi[valid], xi[valid]]
    return out


class ContrastTransform(BaseTransform):
    """ref transforms.ContrastTransform: random contrast in
    [1-value, 1+value]."""

    def __init__(self, value=0.4):
        self.value = float(value)

    def _apply_image(self, img):
        f = 1.0 + np.random.uniform(-self.value, self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value=0.4):
        self.value = float(value)

    def _apply_image(self, img):
        f = 1.0 + np.random.uniform(-self.value, self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value=0.1):
        self.value = float(value)

    def _apply_image(self, img):
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """ref transforms.ColorJitter: composes the per-property random
    transforms (Brightness/Contrast/Saturation/Hue) in random order —
    one place owns each property's jitter convention."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self._ops = []
        if brightness:
            self._ops.append(BrightnessTransform(float(brightness)))
        if contrast:
            self._ops.append(ContrastTransform(float(contrast)))
        if saturation:
            self._ops.append(SaturationTransform(float(saturation)))
        if hue:
            self._ops.append(HueTransform(float(hue)))

    def _apply_image(self, img):
        order = np.random.permutation(len(self._ops))
        for i in order:
            img = self._ops[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    """ref transforms.Pad: constant pad on HWC images."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, numbers.Number):
            padding = (padding,) * 4
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding            # left, top, right, bottom
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        arr = np.asarray(img)
        l, t, r, b = self.padding
        spec = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
        if self.padding_mode == "constant":
            return np.pad(arr, spec, constant_values=self.fill)
        return np.pad(arr, spec, mode=self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, fill=0):
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.fill = fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, fill=self.fill)


class RandomErasing(BaseTransform):
    """ref transforms.RandomErasing over CHW/HWC float or uint8."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        arr = np.asarray(img)
        if np.random.rand() > self.prob:
            return arr
        # layout: HWC when the last dim looks like channels, else CHW
        hwc = arr.ndim == 2 or arr.shape[-1] in (1, 3, 4)
        h, w = arr.shape[:2] if hwc else arr.shape[1:3]
        arr = arr.copy()
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                y = np.random.randint(0, h - eh)
                x = np.random.randint(0, w - ew)
                if hwc:
                    arr[y:y + eh, x:x + ew] = self.value
                else:
                    arr[:, y:y + eh, x:x + ew] = self.value
                return arr
        return arr


def crop(img, top, left, height, width):
    """ref transforms/functional.py crop: CHW or HWC numpy image."""
    import numpy as _np
    img = _np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3):     # CHW
        return img[:, top:top + height, left:left + width]
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    import numpy as _np
    img = _np.asarray(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    th, tw = output_size
    if img.ndim == 3 and img.shape[0] in (1, 3):
        h, w = img.shape[1], img.shape[2]
    else:
        h, w = img.shape[0], img.shape[1]
    return crop(img, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    """ref transforms/functional.py pad: int | (pl,pt) | (pl,pt,pr,pb)."""
    import numpy as _np
    img = _np.asarray(img)
    if isinstance(padding, int):
        pl = pt_ = pr = pb = padding
    elif len(padding) == 2:
        pl, pt_ = padding
        pr, pb = padding
    else:
        pl, pt_, pr, pb = padding
    chw = img.ndim == 3 and img.shape[0] in (1, 3)
    if chw:
        cfg = [(0, 0), (pt_, pb), (pl, pr)]
    elif img.ndim == 3:
        cfg = [(pt_, pb), (pl, pr), (0, 0)]
    else:
        cfg = [(pt_, pb), (pl, pr)]
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    if mode == "constant":
        return _np.pad(img, cfg, mode=mode, constant_values=fill)
    return _np.pad(img, cfg, mode=mode)
