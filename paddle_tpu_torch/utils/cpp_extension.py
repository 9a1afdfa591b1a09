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
  `symbol(float* out, const float* in, int64 n)` as an op. On a CPU
  tensor it runs on a contiguous f32 copy. On a CUDA tensor it is three
  steps on the current stream, none of which waits on the host: a copy
  of the input into pinned host memory, a host function
  (`cuLaunchHostFunc`, through ctypes) that runs the kernel from that
  buffer into a second pinned buffer, and a copy of that back to a new
  device tensor. So it runs inside a CUDA graph as well (a
  `jit.TrainStep`'s): the capture records a copy, a host node and a
  copy, and every replay runs the kernel again on the replay's input,
  as the JAX host op runs under `jax.jit` through `pure_callback`. The
  host function is a Python callback: it takes the interpreter lock, so
  no thread may hold the lock while it waits on that stream (torch's
  waits — synchronize, an event's or a stream's, `.item()`, `.cpu()` —
  release it); it calls no CUDA. The pinned buffers are kept per op and
  input size, reused in stream order.
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


_HOST_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_LIBCUDA = None


def _libcuda():
    """libcuda's entry points the host node needs, declared once."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuLaunchHostFunc.argtypes = [ctypes.c_void_p, _HOST_FN,
                                         ctypes.c_void_p]
        lib.cuMemHostAlloc.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.c_size_t, ctypes.c_uint]
        lib.cuMemcpyDtoHAsync_v2.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t,
            ctypes.c_void_p]
        lib.cuMemcpyHtoDAsync_v2.argtypes = [
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p]
        for fn in (lib.cuLaunchHostFunc, lib.cuMemHostAlloc,
                   lib.cuMemcpyDtoHAsync_v2, lib.cuMemcpyHtoDAsync_v2):
            fn.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def _check_cu(rc, what):
    if rc != 0:
        raise RuntimeError(f"host op: {what} failed with CUDA error {rc}")


class _HostNode:
    """The CUDA path of one host op: pinned in/out buffers per input
    size and the host function that runs the kernel between them."""

    _PORTABLE = 1          # CU_MEMHOSTALLOC_PORTABLE

    def __init__(self, cfn):
        self._cfn = cfn
        self._bufs = {}            # numel -> (in address, out address)
        # userData is the numel: the callback finds its buffers by it
        self._fn = _HOST_FN(self._run)

    def _run(self, user):
        n = int(user or 0)
        src, dst = self._bufs[n]
        f32p = ctypes.POINTER(ctypes.c_float)
        self._cfn(ctypes.cast(dst, f32p), ctypes.cast(src, f32p),
                  ctypes.c_int64(n))

    def _buffers(self, n):
        if n not in self._bufs:
            cu = _libcuda()
            pair = []
            for _ in range(2):
                ptr = ctypes.c_void_p()
                _check_cu(cu.cuMemHostAlloc(ctypes.byref(ptr), max(n, 1) * 4,
                                            self._PORTABLE),
                          "cuMemHostAlloc")
                pair.append(ptr.value)
            self._bufs[n] = tuple(pair)
        return self._bufs[n]

    def __call__(self, x):
        """f32 `x` on the card -> kernel(x) on the card, enqueued on the
        current stream (capturable)."""
        src = x.detach().to(torch.float32).contiguous()
        out = torch.empty_like(src)
        n = src.numel()
        pin_in, pin_out = self._buffers(n)
        cu = _libcuda()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check_cu(cu.cuMemcpyDtoHAsync_v2(pin_in, src.data_ptr(), n * 4,
                                          stream), "the copy to the host")
        _check_cu(cu.cuLaunchHostFunc(stream, self._fn, n),
                  "cuLaunchHostFunc")
        _check_cu(cu.cuMemcpyHtoDAsync_v2(out.data_ptr(), pin_out, n * 4,
                                          stream), "the copy to the card")
        return out


def host_op(name, lib, symbol, out_like=None, differentiable=False):
    """Register extern-C `symbol(float* out, const float* in, int64 n)`
    from `lib` as op `name`: f32 in, f32 out on the input's device, the
    kernel on the host (the CPU-kernel path of custom_operator.cc); on a
    CUDA tensor through a host node, capturable in a CUDA graph."""
    cfn = getattr(lib, symbol)
    cfn.restype = None
    cfn.argtypes = [ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    node = _HostNode(cfn)

    def op(x):
        if x.is_cuda:
            return node(x)
        src = x.detach().to(torch.float32).contiguous()
        out = torch.empty_like(src)
        cfn(ctypes.cast(out.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            ctypes.cast(src.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(src.numel()))
        return out

    op.__name__ = name
    op.host_node = node
    return def_op(name, differentiable=differentiable)(op)
