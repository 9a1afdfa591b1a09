"""Process-global framework state (the port of `paddle_tpu/framework/state.py`):
the place, the default dtype, flags, grad mode, the AMP state and the
random generators.

  - Place: `CPUPlace()` or `CUDAPlace(i)`. The default place is the CUDA
    card, resolved at first use (`import paddle_tpu_torch` touches no
    device); with no card, creating a tensor raises unless the caller
    chose `set_device("cpu")`. Nothing falls back to the host quietly,
    as the JAX package does when it finds no accelerator. The place and
    the default dtype are module globals, as in the JAX package: code
    that sets them restores them itself.
  - Flags: the reference's gflags (platform/flags.cc) as a dict, read from
    FLAGS_* environment variables at import.
  - Grad mode: torch's (`torch.set_grad_enabled`): `no_grad` is torch's
    no-grad mode, so the port's ops and torch's own agree on it.
  - AMP: a context variable holding the active auto_cast config, read by
    the dispatcher's white and black lists.
  - RNG: `default_generator()` holds one seed and an explicit
    `torch.Generator` per device, made at first draw; the random ops and
    attention dropout draw from it.

Not ported: the static recorder (`static_recorder_ctx`, ROADMAP Queue 1
item 7) and the traced RNG and functional mode of the JAX package's
jit tracing (`functional_rng_ctx`, `functional_mode_ctx`), which the
port's eager ops, on torch autograd, do not need.
"""
import contextlib
import contextvars
import threading

import numpy as np
import torch

from .. import device as _device
from .dtype import float32, convert_dtype

# --------------------------------------------------------------------------- places


class Place:
    """Device placement descriptor: kind "cpu" or "gpu" and an index."""

    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.kind}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.kind, self.device_id))

    def torch_device(self):
        """The `torch.device`; raises RuntimeError for a CUDA place when no
        card is present."""
        if self.kind == "cpu":
            return torch.device("cpu")
        return _device.resolve_device(f"cuda:{self.device_id}")

    def is_cpu_place(self):
        return self.kind == "cpu"

    def is_gpu_place(self):
        return self.kind != "cpu"


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(device_id=0):
    return Place("gpu", device_id)


# Scripts written for the TPU package name its accelerator place; on this
# port it is the card's.
TPUPlace = CUDAPlace
XPUPlace = CUDAPlace


def place_of(device):
    """The Place of a `torch.device`."""
    if device.type == "cpu":
        return CPUPlace()
    return Place("gpu", device.index or 0)


_current_place = None
_current_device = None      # the resolved torch.device of _current_place
_default_dtype = float32


def parse_place(device):
    """The Place of 'cpu', 'gpu', 'gpu:1' ('cuda', 'tpu', 'xpu' and 'npu'
    name the card too) or a Place."""
    if isinstance(device, Place):
        return device
    device = str(device)
    kind, _, idx = device.partition(":")
    idx = int(idx) if idx else 0
    if kind in ("gpu", "cuda", "xpu", "npu", "tpu"):
        return Place("gpu", idx)
    if kind == "cpu":
        return Place("cpu", 0)
    raise ValueError(f"unknown device {device!r}: expected 'cpu' or "
                     f"'gpu[:N]'")


def set_device(device):
    """paddle.set_device (`parse_place`'s names). Returns the Place."""
    global _current_place, _current_device
    _current_place = parse_place(device)
    _current_device = None
    return _current_place


def get_device():
    p = get_place()
    return f"{p.kind}:{p.device_id}"


def get_place():
    """The current Place: the one set by `set_device`, else the CUDA card
    (whether or not one is present: using it raises when none is)."""
    global _current_place
    if _current_place is None:
        _current_place = CUDAPlace(0)
    return _current_place


def current_device():
    """The current place's `torch.device`, resolved once per
    `set_device`; raises RuntimeError on the default place when no card
    is present."""
    global _current_device
    if _current_device is None:
        _current_device = get_place().torch_device()
    return _current_device


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


# --------------------------------------------------------------------------- RNG


class Generator:
    """The framework generator (ref framework/generator.h:93): one seed
    and an explicit `torch.Generator` per device, each seeded with it at
    its first draw."""

    def __init__(self, seed=0):
        self._seed = int(seed)
        self._lock = threading.Lock()
        self._gens = {}

    def manual_seed(self, seed):
        with self._lock:
            self._seed = int(seed)
            self._gens.clear()
        return self

    def generator(self, device):
        """The `torch.Generator` that draws on `device`."""
        device = torch.device(device)
        key = str(device)
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(self._seed)
                self._gens[key] = gen
            return gen

    @property
    def initial_seed(self):
        return self._seed


_default_generator = Generator(0)


def rng_state():
    """Snapshot of the default generator: its seed and the state of each
    device's generator drawn from so far (host uint8 arrays)."""
    g = _default_generator
    with g._lock:
        return {"seed": g._seed,
                "states": {k: gen.get_state().numpy().copy()
                           for k, gen in g._gens.items()}}


def set_rng_state(st):
    """Restore a `rng_state()` snapshot into the default generator."""
    g = _default_generator
    g.manual_seed(st["seed"])
    for key, arr in st.get("states", {}).items():
        g.generator(key).set_state(torch.from_numpy(np.asarray(arr)))


def numpy_rng_state():
    """The global numpy RNG (MT19937) state as a picklable dict."""
    alg, keys, pos, has_gauss, cached = np.random.get_state()
    return {"alg": str(alg), "keys": np.asarray(keys).copy(),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def set_numpy_rng_state(st):
    """Restore a `numpy_rng_state()` snapshot into the global numpy RNG."""
    np.random.set_state((st["alg"], np.asarray(st["keys"]), int(st["pos"]),
                         int(st["has_gauss"]), float(st["cached_gaussian"])))


def seed(s):
    """paddle.seed: the default generator, and Python's, numpy's and
    torch's global generators (`device.seed`)."""
    _device.seed(s)
    return _default_generator.manual_seed(int(s))


def default_generator():
    return _default_generator


def rng_generator(device):
    """The default generator's `torch.Generator` on `device` (the port's
    `next_rng_key`)."""
    return _default_generator.generator(device)


@contextlib.contextmanager
def host_init_ctx(seed):
    """Parameters made inside the block are drawn on the CPU from a
    framework generator seeded with `seed`, so one seed gives the same
    weights whatever device the model moves to afterwards. The current
    place and the framework generator are put back on exit."""
    global _current_place, _current_device, _default_generator
    saved = _current_place, _current_device, _default_generator
    _current_place, _current_device = CPUPlace(), None
    _default_generator = Generator(seed)
    try:
        yield
    finally:
        _current_place, _current_device, _default_generator = saved


# --------------------------------------------------------------------------- flags

_FLAGS = {
    "FLAGS_check_nan_inf": False,           # ref platform/flags.cc:44
    "FLAGS_unused_var_check": False,        # ref framework/unused_var_check.cc
    "FLAGS_sort_sum_gradient": False,       # ref platform/flags.cc:527
    "FLAGS_cudnn_deterministic": True,
    "FLAGS_matmul_precision": "default",
    "FLAGS_eager_op_cache": True,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_use_donated_buffers": True,
}


def _bootstrap_env_flags():
    """Parse FLAGS_* env vars at import (ref python/paddle/fluid/__init__.py
    __bootstrap__ passing env gflags to core.init_gflags)."""
    import os
    for key, default in list(_FLAGS.items()):
        raw = os.environ.get(key)
        if raw is None:
            continue
        try:
            if isinstance(default, bool):
                _FLAGS[key] = raw.lower() in ("1", "true", "yes", "on")
            elif isinstance(default, int):
                _FLAGS[key] = int(raw)
            elif isinstance(default, float):
                _FLAGS[key] = float(raw)
            else:
                _FLAGS[key] = raw
        except ValueError:
            import warnings
            warnings.warn(
                f"ignoring malformed env var {key}={raw!r}; keeping "
                f"default {default!r}")


_bootstrap_env_flags()


def set_flags(flags: dict):
    for k, v in flags.items():
        _FLAGS[k] = v


def get_flags(keys=None):
    if keys is None:
        return dict(_FLAGS)
    if isinstance(keys, str):
        keys = [keys]
    return {k: _FLAGS.get(k) for k in keys}


def get_flag(key, default=None):
    return _FLAGS.get(key, default)


# --------------------------------------------------------------------------- modes


def is_grad_enabled():
    return torch.is_grad_enabled()


@contextlib.contextmanager
def no_grad_ctx():
    with torch.no_grad():
        yield


@contextlib.contextmanager
def enable_grad_ctx():
    with torch.enable_grad():
        yield


_amp_state = contextvars.ContextVar("amp_state", default=None)


def get_amp_state():
    return _amp_state.get()


@contextlib.contextmanager
def amp_guard_ctx(cfg):
    """Run the block under the AMP config `cfg` ({"dtype": torch dtype}),
    which the dispatcher's white and black lists read."""
    tok = _amp_state.set(cfg)
    try:
        yield
    finally:
        _amp_state.reset(tok)


class no_grad(torch.no_grad):
    """paddle.no_grad: a context manager and a decorator (torch's
    no-grad mode)."""
