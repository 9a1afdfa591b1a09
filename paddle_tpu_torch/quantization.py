"""Quantization: QAT fake-quant and PTQ calibration (the port of
`paddle_tpu/quantization.py`; a slim analog, ref
python/paddle/fluid/contrib/slim/quantization/).

QAT wraps Linear and Conv layers (`ImperativeQuantAware.quantize`) so
their weights, and their input activations, pass through a
straight-through fake quant: `fake_quantize_dequantize` computes
`x + (qdq(x) - x).detach()`, the scale inside the detach, all arithmetic
in `x.dtype`, so the forward is quantized and the gradient is the
identity. A `FakeQuantWrapper` runs the wrapped layer's own forward with
its weight swapped for the fake-quantized one through `Layer._use_state`
(in the wrapper's `_data` and in torch's registry, put back on exit): the
gradient reaches the real weight, which `parameters()` lists once, and
the swap is host-side only, so a `jit.TrainStep` captures it in its CUDA
graph. PTQ (`PostTrainingQuantization`) observes each quantizable
layer's input range over calibration batches (abs_max, avg, hist, KL;
the histograms in numpy as the JAX package bins them) and freezes it;
`convert_to_int8` turns Linear weights into int8 with per-output-channel
scales (`QuantizedLinear`, whose product dequantizes and runs
`torch.matmul`, as the JAX package's runs in XLA).

`save_quantized_model` needs `static.export`, which is not ported
(ROADMAP Queue 1 item 7).
"""
import itertools

import numpy as np
import torch

from .framework.tensor import Tensor
from .ops.dispatch import def_op
from . import nn


@def_op("fake_quantize_dequantize", n_tensor_args=1)
def fake_quantize_dequantize(x, bits=8, symmetric=True, scale=None):
    """Straight-through fake quant (ref fake_quantize_op.cc
    FakeQuantizeDequantizeAbsMax): quantize to `bits` then dequantize;
    gradient passes through unchanged. `scale=None` uses the dynamic
    range (QAT); a float scale is the PTQ-calibrated fixed abs-max.
    symmetric=False quantizes to the [min, max] range with a zero point.
    All arithmetic stays in x.dtype (a frozen scale must not promote a
    bf16 AMP program to f32)."""
    v = x.detach()
    if symmetric:
        qmax = 2.0 ** (bits - 1) - 1
        s = (torch.clamp(torch.amax(torch.abs(v)), min=1e-8) / qmax
             if scale is None else
             torch.full((), scale, dtype=v.dtype, device=v.device) / qmax)
        q = (torch.clamp(torch.round(v / s), -qmax, qmax) * s).to(v.dtype)
    else:
        # asymmetric: affine map of [lo, hi] onto [0, 2^bits - 1]
        qmax = 2.0 ** bits - 1
        if scale is None:
            lo, hi = torch.amin(v), torch.amax(v)
        else:
            lo = torch.zeros((), dtype=v.dtype, device=v.device)
            hi = torch.full((), scale, dtype=v.dtype, device=v.device)
        s = torch.clamp(hi - lo, min=1e-8) / qmax
        zp = torch.round(-lo / s)
        q = torch.clamp(torch.round(v / s) + zp, 0, qmax)
        q = ((q - zp) * s).to(v.dtype)
    # straight-through estimator: forward quantized, backward identity
    return x + (q - v)


class FakeQuantWrapper(nn.Layer):
    """Wraps one layer; fake-quants its weight (and input activations when
    activation_quantize=True) before the wrapped forward. act_scale=None
    is the dynamic QAT range; a float is a PTQ-calibrated frozen range."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 activation_quantize=True, act_scale=None):
        super().__init__()
        self.wrapped = layer
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize = activation_quantize
        self.act_scale = act_scale

    def forward(self, x, *args, **kwargs):
        if self.activation_quantize:
            x = fake_quantize_dequantize(x, bits=self.activation_bits,
                                         scale=self.act_scale)
        w = fake_quantize_dequantize(self.wrapped.weight,
                                     bits=self.weight_bits)
        with self.wrapped._use_state({"weight": w._data}):
            return self.wrapped(x, *args, **kwargs)


_QUANTIZABLE = (nn.Linear, nn.Conv2D, nn.Conv1D, nn.Conv3D)


class ImperativeQuantAware:
    """ref slim ImperativeQuantAware: quantize(model) swaps quantizable
    sublayers for fake-quant wrappers in place."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_layer_type=None):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.types = tuple(quantizable_layer_type or _QUANTIZABLE)

    def quantize(self, model):
        for holder in model.sublayers(include_self=True) \
                if hasattr(model, "sublayers") else [model]:
            subs = getattr(holder, "_sub_layers", {})
            for name, sub in list(subs.items()):
                if isinstance(sub, self.types):
                    subs[name] = FakeQuantWrapper(
                        sub, self.weight_bits, self.activation_bits)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        raise NotImplementedError(
            "save_quantized_model: static.export is not ported yet "
            "(ROADMAP Queue 1 item 7)")


class ScaleObserver:
    """Per-tensor activation-range observer (ref slim
    post_training_quantization.py:121 PostTrainingQuantization's
    sampling): abs_max / avg need one pass; hist / KL need the abs-max
    pass first (it fixes the histogram domain), then a histogram pass.
    Every max is read back to the host, as the JAX package's is."""

    BINS = 2048

    def __init__(self, algo="abs_max", bits=8):
        if algo not in ("abs_max", "avg", "hist", "KL"):
            raise ValueError(
                f"unknown PTQ algo {algo!r} (abs_max | avg | hist | KL)")
        self.algo = algo
        self.bits = bits
        self.abs_max = 0.0
        self._batch_maxes = []
        self.hist = np.zeros(self.BINS, "f8") if algo in ("hist", "KL") \
            else None

    @staticmethod
    def _torch(x):
        """x (a Tensor, a torch tensor or an array) as a torch tensor."""
        return (x._data if isinstance(x, Tensor) else
                torch.as_tensor(x)).detach()

    def update_max(self, x):
        m = float(torch.amax(torch.abs(self._torch(x))))
        self.abs_max = max(self.abs_max, m)
        self._batch_maxes.append(m)

    def update_hist(self, x):
        if self.hist is None or self.abs_max <= 0:
            return
        t = self._torch(x)
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()       # exact; numpy has no bf16
        a = np.abs(t.cpu().numpy()).ravel()
        h, _ = np.histogram(a, bins=self.BINS, range=(0.0, self.abs_max))
        self.hist += h

    def scale(self):
        """The frozen activation range for this tensor."""
        if self.abs_max <= 0:
            return 0.0
        if self.algo == "abs_max":
            return self.abs_max
        if self.algo == "avg":                   # ref 'avg': mean of
            return float(np.mean(self._batch_maxes))  # per-batch maxes
        if self.algo == "hist":                  # ref hist_percent
            c = np.cumsum(self.hist)
            if c[-1] <= 0:
                return self.abs_max
            idx = int(np.searchsorted(c, 0.99999 * c[-1]))
            return self.abs_max * (idx + 1) / self.BINS
        return self._kl_scale()                  # "KL"

    def _kl_scale(self):
        """TensorRT-style KL threshold search (ref slim cal_kl_threshold):
        pick the clip point whose 2^(bits-1)-level quantization of the
        clipped distribution minimizes KL divergence, among the thresholds
        that keep at least 99% of the mass (at t == target the
        quantization is exact, so an unconstrained search always clips
        the most)."""
        target = 2 ** (self.bits - 1)            # 128 for int8
        h = self.hist
        if h.sum() <= 0:
            return self.abs_max
        c = np.cumsum(h)
        t99 = int(np.searchsorted(c, 0.99 * c[-1])) + 1
        start = max(target, t99)
        best_t, best_kl = self.BINS, np.inf
        for t in range(start, self.BINS + 1, 16):
            p = h[:t].astype("f8").copy()
            p[-1] += h[t:].sum()                 # clip outliers into edge
            if p.sum() <= 0:
                continue
            # quantize the t bins down to `target` levels and expand back
            chunk = t / target
            q = np.zeros(t, "f8")
            for k in range(target):
                lo, hi = int(np.floor(k * chunk)), int(np.ceil((k + 1)
                                                              * chunk))
                hi = min(hi, t)
                seg = p[lo:hi]
                nz = seg > 0
                if nz.any():
                    # spread the segment's mass over its nonzero bins
                    q[lo:hi][nz] = seg.sum() / int(nz.sum())
            pn = p / p.sum()
            qs = q.sum()
            if qs <= 0:
                continue
            qn = q / qs
            mask = pn > 0
            kl = float(np.sum(pn[mask] * np.log(
                pn[mask] / np.maximum(qn[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_t = kl, t
        return self.abs_max * best_t / self.BINS


class PostTrainingQuantization:
    """PTQ calibration (ref slim post_training_quantization.py:121): run
    representative batches through the model, observe per-layer input
    activation ranges (abs_max / avg / hist / KL), then convert() wraps
    the quantizable sublayers with the frozen scales and fake-quant
    weights — the deploy-path half of slim (QAT is the training half)."""

    def __init__(self, model, algo="hist", weight_bits=8,
                 activation_bits=8):
        self.model = model
        self.algo = algo
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.observers = {}
        self.scales = {}

    def _run(self, data_iter, max_batches, update):
        hooks = []

        def mk_hook(name):
            def hook(layer, inputs, outputs=None):
                update(name, inputs[0])
            return hook

        for name, sub in self.model.named_sublayers():
            if isinstance(sub, _QUANTIZABLE):
                self.observers.setdefault(
                    name, ScaleObserver(self.algo, self.activation_bits))
                hooks.append(sub.register_forward_pre_hook(mk_hook(name)))
        try:
            for i, batch in enumerate(data_iter):
                if i >= max_batches:
                    break
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                if not isinstance(x, Tensor):
                    x = Tensor._wrap(x) if isinstance(x, torch.Tensor) \
                        else Tensor(x)
                self.model(x)
        finally:
            for h in hooks:
                h.remove()

    def calibrate(self, data, max_batches=16):
        """`data`: any iterable of batches (only the first max_batches
        are drawn — an endless/streaming loader is fine); histogram
        algos replay the drawn batches twice (pass 1 fixes the ranges,
        pass 2 bins)."""
        if not isinstance(data, (list, tuple)):
            data = list(itertools.islice(iter(data), max_batches))
        self._run(iter(data), max_batches,
                  lambda n, x: self.observers[n].update_max(x))
        if self.algo in ("hist", "KL"):
            self._run(iter(data), max_batches,
                      lambda n, x: self.observers[n].update_hist(x))
        self.scales = {n: ob.scale() for n, ob in self.observers.items()}
        return self.scales

    def convert(self):
        """Swap quantizable sublayers for wrappers with the calibrated
        frozen activation scales (ref slim's save_quantized_model
        output: q/dq at fixed ranges)."""
        if not self.scales:
            raise RuntimeError("call calibrate() before convert()")
        for prefix, holder in self.model.named_sublayers(
                include_self=True):
            subs = getattr(holder, "_sub_layers", {})
            for name, sub in list(subs.items()):
                full = f"{prefix}.{name}" if prefix else name
                if isinstance(sub, _QUANTIZABLE) and full in self.scales \
                        and self.scales[full] > 0:
                    subs[name] = FakeQuantWrapper(
                        sub, self.weight_bits, self.activation_bits,
                        act_scale=float(self.scales[full]))
        return self.model


# ---------------------------------------------------------------------------
# inference-side conversion (ref slim/quantization quant2_int8 convert pass:
# the trained/calibrated model's weights become int8 + scales; activations
# dequantize on the fly)
# ---------------------------------------------------------------------------

class QuantizedLinear(nn.Layer):
    """Weight-only int8 Linear: stores the weight as int8 with per-output-
    channel symmetric scales (buffers `w_int8` and `w_scale`, in the state
    dict) and dequantizes into the activation dtype at use, before a
    `torch.matmul`."""

    def __init__(self, linear, weight_bits=8):
        super().__init__()
        w = linear.weight._data.detach()             # [in, out]
        qmax = 2 ** (weight_bits - 1) - 1
        scale = torch.amax(torch.abs(w), dim=0) / qmax   # per out-channel
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        self.register_buffer("w_int8", Tensor._wrap(
            torch.clamp(torch.round(w / scale), -qmax, qmax)
            .to(torch.int8)))
        self.register_buffer("w_scale", Tensor._wrap(scale))
        self.bias = getattr(linear, "bias", None)
        self.weight_bits = weight_bits

    def forward(self, x):
        a = x._data if isinstance(x, Tensor) else x
        w = (self.w_int8._data.to(a.dtype)
             * self.w_scale._data.to(a.dtype))
        out = torch.matmul(a, w)
        if self.bias is not None:
            out = out + self.bias._data.to(a.dtype)
        return Tensor._wrap(out)


def convert_to_int8(model, weight_bits=8, quantizable=None):
    """Replace every quantizable sublayer's weights with int8 + scales
    (in place on the Layer tree). Returns the model and the count of
    converted layers (ref save_quantized_model's convert step)."""
    quantizable = quantizable or (nn.Linear,)
    converted = 0

    def visit(layer):
        nonlocal converted
        for name, sub in list(layer._sub_layers.items()):
            if isinstance(sub, quantizable):
                layer._sub_layers[name] = QuantizedLinear(sub, weight_bits)
                converted += 1
            else:
                visit(sub)

    visit(model)
    return model, converted
