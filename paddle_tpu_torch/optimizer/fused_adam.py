"""The fused multi-tensor Adam/AdamW kernel (csrc/optimizer.cu) and its
dispatch.

Two implementations of one Adam/AdamW step sit behind `resolve_kernel`,
the pattern of `ops/flash_attention.py`:

  kernel="plain"  the `_foreach_*` update of `optimizer.Adam` and
                  `optimizer.AdamW` (torch list ops); used for CPU
                  tensors and to check the kernel on the card;
  kernel="cuda"   `cuda_adam`: one launch of the hand-written sm_90a
                  kernel per group of parameters that share a dtype, a
                  master or none, a learning-rate multiplier and a
                  regularizer term (up to 256 tensors a launch),
                  reading lr and the step from the optimizer's device
                  pair. It launches for CUDA tensors and raises for
                  anything else — CPU tensors, a dtype it does not take,
                  a pointer that is not 16-byte aligned — and never
                  falls back;
  kernel="auto"   "cuda" for CUDA tensors, "plain" for CPU tensors
                  (the default).
"""
import ctypes

import numpy as np
import torch

from .. import kernels

KERNELS = ("auto", "plain", "cuda")

#: launches of the kernel since the last reset — a plain integer,
#: incremented where the wrapper launches and nowhere else
launches = {"adam": 0}
kernels.COUNTERS["optimizer"] = launches

# the gradient term: none, L2 (g + c * base) or L1 (g + c * sign(base))
GRAD_MODES = {None: 0, "l2": 1, "l1": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_kernel(kernel="auto", device=None):
    """Resolve to "plain" | "cuda"; "auto" picks by the tensors'
    device."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown optimizer kernel {kernel!r}: expected "
                         f"one of {KERNELS}")
    if kernel != "auto":
        return kernel
    dev = torch.device("cpu" if device is None else device)
    return "cuda" if dev.type == "cuda" else "plain"


def _check(params, grads, moment1, moment2, masters, scalars):
    """Raise for anything the kernel does not take, naming the tensor."""
    dev, dtype = params[0].device, params[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"optimizer kernel takes float32 or bfloat16 "
                        f"weights, got {dtype}")
    if masters is not None and dtype != torch.bfloat16:
        raise TypeError("optimizer kernel: a master copy goes with "
                        "bfloat16 weights only")
    named = []
    for i, p in enumerate(params):
        n = p.numel()
        named += [(f"param {i}", p, dtype, n),
                  (f"grad {i}", grads[i], dtype, n),
                  (f"moment1 {i}", moment1[i], torch.float32, n),
                  (f"moment2 {i}", moment2[i], torch.float32, n)]
        if masters is not None:
            named.append((f"master {i}", masters[i], torch.float32, n))
    named.append(("scalars", scalars, torch.float32, 2))
    for name, t, want, n in named:
        if t.device.type != "cuda":
            raise RuntimeError(f"optimizer kernel 'cuda' needs CUDA "
                               f"tensors; {name} is on {t.device}")
        if t.device != dev:
            raise RuntimeError("optimizer kernel: tensors must be on one "
                               "device")
        if t.dtype != want:
            raise TypeError(f"optimizer kernel: {name} is {t.dtype}, "
                            f"needs {want}")
        if t.numel() != n:
            raise ValueError(f"optimizer kernel: {name} has {t.numel()} "
                             f"elements, needs {n}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"optimizer kernel: {name} needs to be contiguous with a "
                f"16-byte aligned base; got address {t.data_ptr():#x}, "
                f"strides {t.stride()}")


def cuda_adam(params, grads, moment1, moment2, masters, scalars, beta1,
              beta2, epsilon, grad_mode=None, grad_coeff=0.0,
              decoupled=False, decay=0.0, lr_scale=1.0):
    """One fused Adam/AdamW step, in place, over parameters of one dtype
    (f32 or bf16) on one card: grads in the params' dtype, f32 moments,
    f32 `masters` (a list, or None) for bf16 weights under
    multi_precision, and `scalars` the device f32 [lr, step].

    grad_mode: the regularizer's term, appended to the gradient in the
    base dtype (the master's, else the weights'): None, "l2" (g +
    grad_coeff * base) or "l1" (g + grad_coeff * sign(base)); grad_coeff
    is taken as given (the caller rounds it to the base dtype).
    decoupled: AdamW's rule, with `decay` its coefficient (0 included);
    else Adam's. lr_scale: the group's learning-rate multiplier, applied
    on the device as lr * f32(lr_scale). Launches once per 256 tensors on
    the current stream."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"optimizer kernel: grad_mode {grad_mode!r} is not "
                         f"one of {tuple(GRAD_MODES)}")
    _check(params, grads, moment1, moment2, masters, scalars)
    keep = [i for i, p in enumerate(params) if p.numel()]
    if not keep:
        return
    lib = kernels.load("optimizer")
    per_launch = lib.optimizer_adam_max_tensors()
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    hyper = tuple(float(np.float32(x)) for x in
                  (beta1, beta2, 1 - beta1, 1 - beta2, epsilon, grad_coeff,
                   decay, lr_scale))
    for lo in range(0, len(keep), per_launch):
        idx = keep[lo:lo + per_launch]
        ptrs = []
        for i in idx:
            ptrs += [params[i].data_ptr(), grads[i].data_ptr(),
                     moment1[i].data_ptr(), moment2[i].data_ptr(),
                     masters[i].data_ptr() if masters is not None else None]
        numels = [params[i].numel() for i in idx]
        rc = lib.optimizer_adam_step(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(numels))(*numels), len(idx),
            scalars.data_ptr(), *hyper, GRAD_MODES[grad_mode],
            int(bool(decoupled)), _DTYPES[params[0].dtype],
            int(masters is not None), stream)
        if rc != 0:
            raise RuntimeError(f"optimizer kernel launch failed: CUDA "
                               f"error {rc}")
        launches["adam"] += 1
