"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source has a plain C interface. It is compiled with
nvcc for sm_90a into `build/paddle_tpu_torch/lib<name>.so` at first use
and loaded with ctypes: pointers come from `tensor.data_ptr()`, the
stream from `torch.cuda.current_stream().cuda_stream`. Nothing is built
or loaded when this module is imported — the CPU tests import it on
machines with no nvcc.
"""
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "paddle_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# C signature of every exported entry point, by library name
SIGNATURES = {
    "paged_attention": {
        "paged_attention_fwd": (
            [_P, _STRIDES, _I,                   # q, its strides, q dtype
             _P, _P, _P,                         # pk pv tables
             _P, ctypes.c_longlong, _I, _I,      # start: ptr scalar elt stride
             _P, _P,                             # out work
             _I, _I, _I, _I, _I, _I, _I, _I,     # b h hkv c d bs nblk nb
             _I, _F, _I, _I, _I, _P],            # split scale use_window
            ctypes.c_int),                       # window pool dtype stream
    },
    "flash_attention": {
        "flash_attention_fwd": (
            [_P, _P, _P, _P, _P,                 # q k v out lse
             _STRIDES, _I, _I, _I, _I, _I,       # strides b h sq sk d
             _F, _I, _I, _I, _P],                # scale causal window
            ctypes.c_int),                       # dtype stream
        "flash_attention_bwd_dkv": (
            [_P, _P, _P, _P, _P, _P, _P, _P,     # q k v dout lse dd dk dv
             _STRIDES, _I, _I, _I, _I, _I,
             _F, _I, _I, _I, _P],
            ctypes.c_int),
        "flash_attention_fwd_smem_bytes": ([], ctypes.c_int),
        "flash_attention_bwd_dkv_smem_bytes": ([], ctypes.c_int),
        "flash_attention_bwd_dq": (
            [_P, _P, _P, _P, _P, _P, _P,         # q k v dout lse dd dq
             _STRIDES, _I, _I, _I, _I, _I,
             _F, _I, _I, _I, _P],
            ctypes.c_int),
        "flash_attention_bwd_dq_smem_bytes": ([], ctypes.c_int),
        "flash_attention_row_dot": (
            [_P, _P, _P, _STRIDES,               # dout out dd strides
             _I, _I, _I, _I, _I, _P],            # b h sq d dtype stream
            ctypes.c_int),
    },
    "optimizer": {
        "optimizer_adam_step": (
            [_PTRS, _STRIDES, _I, _P,            # ptrs numels count scalars
             _F, _F, _F, _F, _F,                 # b1 b2 1-b1 1-b2 eps
             _F, _F, _F,                         # grad_coeff decay lr_scale
             _I, _I, _I, _I, _P],                # grad_mode decoupled dtype
            ctypes.c_int),                       # master stream
        "optimizer_adam_max_tensors": ([], ctypes.c_int),
    },
}

#: every kernel wrapper module's dict of launch counts, by library name.
#: Each module registers its own `launches` here when it is imported and
#: increments it where it launches and nowhere else; `launch_counts`
#: reads them all (jit.TrainStep records what a CUDA graph captured).
COUNTERS = {}


def launch_counts():
    """{"<library>.<kernel>": launches so far} over every registered
    counter."""
    return {f"{lib}.{key}": n for lib, counts in COUNTERS.items()
            for key, n in counts.items()}

_loaded = {}
_fresh = {}      # report of each library this process compiled


def nvcc_path():
    """The nvcc to build with: the CUDA toolkit's, else the one on PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def build(name):
    """Compile csrc/<name>.cu unless an up-to-date library exists.
    Returns {"path", "seconds", "built", "ptxas"} — `ptxas` holds the
    compiler's register/shared-memory report of the build, kept beside
    the library so that a later process that finds it built reads the
    same report."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    report = lib.with_suffix(".ptxas")
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return dict(_fresh.get(name) or {
            "path": str(lib), "seconds": 0.0, "built": False,
            "ptxas": report.read_text() if report.exists() else ""})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, lib)
    _fresh[name] = {"path": str(lib), "seconds": seconds, "built": True,
                    "ptxas": proc.stderr}
    return dict(_fresh[name])


def load(name):
    """The ctypes handle of lib<name>.so, built on first use, with every
    entry point's argtypes/restype declared."""
    if name not in _loaded:
        info = build(name)
        handle = ctypes.CDLL(info["path"])
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[name] = (handle, info)
    return _loaded[name][0]


def build_info(name):
    """The build report of a loaded library (see `build`)."""
    load(name)
    return dict(_loaded[name][1])
