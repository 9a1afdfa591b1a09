"""Custom ops: Python ops with an optional backward, and C++ host
kernels built with g++ (the port of `paddle_tpu/utils/cpp_extension.py`;
ref paddle/fluid/extension/include/op_meta_info.h:360 PD_BUILD_OP,
framework/custom_operator.cc, python/paddle/utils/cpp_extension/).

- `register_op(name, forward, backward=None)`: forward on torch tensors
  goes into the port's op registry and dispatcher, as a builtin op; a
  `backward(inputs, grad)` installs a `torch.autograd.Function`.
- `load(name, sources, ...)`: builds C++ sources into lib<name>.so with
  `g++ -O3 -fPIC -shared -std=c++17` and returns the `ctypes.CDLL`.
- `host_op(name, lib, symbol)`: registers an extern-C f32 kernel
  `symbol(float* out, const float* in, int64 n)` as an op. A CUDA input
  is copied to the host, the kernel runs there, and the result is copied
  back to the input's device. The copies synchronise with the host, so
  a host op cannot run inside a CUDA graph: under a capture (a
  `jit.TrainStep` or any `graphs.Program`) it raises, naming the op,
  before it enqueues anything. The JAX package's host op also runs
  under `jax.jit` (through `pure_callback`); ROADMAP Queue 3 logs the
  difference.
"""
import ctypes
import os
import subprocess
import tempfile

import torch

from ..ops.dispatch import OP_REGISTRY, def_op


def register_op(name, forward, backward=None, differentiable=True):
    """PD_BUILD_OP analog: register `forward(*tensors, **attrs)` as op
    `name` and return the op. `backward(inputs, grad)` -> the inputs'
    grads (a tensor or a tuple) makes it a `torch.autograd.Function`
    (ref op_meta_info SetKernelFn/SetBackwardFn)."""
    if backward is not None:
        class _Custom(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                ctx.save_for_backward(*args)
                return forward(*args)

            @staticmethod
            def backward(ctx, grad):
                out = backward(ctx.saved_tensors, grad)
                return tuple(out) if isinstance(out, (tuple, list)) \
                    else (out,)

        def fn(*args):
            return _Custom.apply(*args)
        fn.__name__ = name
    else:
        fn = forward
    return def_op(name, differentiable=differentiable)(fn)


def get_op(name):
    return OP_REGISTRY.get(name)


_DEFAULT_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def load(name, sources, extra_cxx_cflags=None, build_directory=None,
         verbose=False):
    """Compile C++ `sources` into lib{name}.so and dlopen it (ref
    python/paddle/utils/cpp_extension/cpp_extension.py load). Returns the
    ctypes.CDLL; pair it with `host_op` to expose an extern-C kernel as
    an op."""
    build_dir = build_directory or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_extensions")
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"lib{name}.so")
    srcs = [sources] if isinstance(sources, str) else list(sources)
    cmd = ["g++"] + _DEFAULT_FLAGS + (extra_cxx_cflags or []) + \
        srcs + ["-o", out]
    if verbose:
        print("cpp_extension build:", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"cpp_extension build failed for {name}:\n{res.stderr}")
    return ctypes.CDLL(out)


def host_op(name, lib, symbol, out_like=None, differentiable=False):
    """Register extern-C `symbol(float* out, const float* in, int64 n)`
    from `lib` as op `name`: f32 in, f32 out on the input's device, the
    kernel on the host (the CPU-kernel path of custom_operator.cc)."""
    cfn = getattr(lib, symbol)
    cfn.restype = None
    cfn.argtypes = [ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64]

    def op(x):
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"host op {name!r} runs its kernel on the host and cannot "
                "be captured in a CUDA graph: call it outside the graph "
                "(jit.TrainStep(..., cuda_graph=False) runs eagerly)")
        src = x.detach().to("cpu", torch.float32).contiguous()
        out = torch.empty_like(src)
        cfn(ctypes.cast(out.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            ctypes.cast(src.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(src.numel()))
        return out.to(x.device)

    op.__name__ = name
    return def_op(name, differentiable=differentiable)(op)
