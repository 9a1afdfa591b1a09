"""Fused paged attention: gather + attend over the block pools in one
pass (the port of `paddle_tpu/nn/paged_attention.py`).

Three implementations sit behind one dispatch point:

  kernel="reference"  gather_block_kv + cached_decode_attention /
                      chunk_attention — the gather-then-attend parity
                      oracle;
  kernel="plain"      the online-softmax loop over pool blocks in plain
                      PyTorch (the port of `_lax_core`): the plain
                      version beside the CUDA kernel, used for CPU
                      tensors and to check the kernel on the card;
  kernel="cuda"       the hand-written sm_90a kernel
                      (csrc/paged_attention.cu, the port of the Pallas
                      `_paged_attn_kernel`). Launches for CUDA tensors
                      and raises for anything else — there is no
                      fallback;
  kernel="auto"       "cuda" for CUDA tensors, "plain" for CPU tensors.

Masking contract: masked scores are -inf before the max/exp, fully
masked rows renormalise to exactly 0 through a guarded
`where(l == 0, 0, acc / l)`, V rows no query keeps are zeroed, so
scratch-block garbage never reaches the engines' isfinite sentinel,
while a non-finite value at an ATTENDED position still propagates.

Resolution order for kernel=None: the innermost `kernel_scope(...)` >
the `PT_PAGED_KERNEL` environment variable > `set_paged_kernel` >
"auto".
"""
import contextlib
import os

import torch

from .transformer import (cached_decode_attention, chunk_attention,
                          gather_block_kv)

KERNELS = ("auto", "reference", "plain", "cuda")

_DEFAULT_KERNEL = "auto"
_SCOPE_STACK = []           # innermost kernel_scope override, LIFO

#: launches of the CUDA kernel by form since the last reset — plain
#: integers, incremented by the wrapper where it launches and nowhere
#: else (chip_smoke.py zeroes them before driving the serving path and
#: reads them after)
launches = {"decode": 0, "chunk": 0}


def set_paged_kernel(kernel):
    """Set the process-wide default paged-attention kernel."""
    global _DEFAULT_KERNEL
    _DEFAULT_KERNEL = _check(kernel)


def _check(kernel):
    if kernel not in KERNELS:
        raise ValueError(f"unknown paged kernel {kernel!r}: "
                         f"expected one of {KERNELS}")
    return kernel


@contextlib.contextmanager
def kernel_scope(kernel):
    """Pin the kernel inside a `with` block (the serving engines run
    their waves inside the scope of the kernel they were built with)."""
    _SCOPE_STACK.append(_check(kernel))
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


def resolve_kernel(kernel=None, device=None):
    """Resolve to "reference" | "plain" | "cuda". Order: explicit
    argument > innermost kernel_scope > PT_PAGED_KERNEL > the
    set_paged_kernel default; "auto" at any level resolves by the
    tensors' device: "cuda" on a CUDA device, "plain" elsewhere."""
    if kernel is not None:
        choice = _check(kernel)
    elif _SCOPE_STACK:
        choice = _SCOPE_STACK[-1]
    else:
        env = os.environ.get("PT_PAGED_KERNEL", "").strip().lower()
        choice = _check(env) if env else _DEFAULT_KERNEL
    if choice != "auto":
        return choice
    dev = torch.device("cpu" if device is None else device)
    return "cuda" if dev.type == "cuda" else "plain"


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def paged_decode_attention(q, pk, pv, tables, pos, scale, window=None,
                           kernel=None):
    """Fused decode attention over the block pool. q: [B, H, 1, D];
    pk/pv: [NB, Hkv, BS, D] pools; tables: [B, nblk] int32; pos a scalar
    or [B] vector of each lane's current position (keys at ks <= pos are
    attended, banded to the last `window`). Returns [B, H, 1, D] in
    pv.dtype."""
    k = resolve_kernel(kernel, q.device)
    if k == "reference":
        return cached_decode_attention(q, gather_block_kv(pk, tables),
                                       gather_block_kv(pv, tables), pos,
                                       scale, window=window, sanitize=True)
    if k == "cuda":
        return cuda_core(q, pk, pv, tables, pos, scale, window,
                         form="decode")
    return plain_core(q, pk, pv, tables, pos, scale, window)


def paged_chunk_attention(q, pk, pv, tables, start, scale, window=None,
                          kernel=None):
    """Fused chunk attention over the block pool: C queries per lane at
    absolute positions start + i (start: scalar or [B]). q: [B, H, C, D].
    Query row i masks ks <= start + i (banded to the last `window`).
    Returns [B, H, C, D] in pv.dtype. The decode form is C == 1."""
    k = resolve_kernel(kernel, q.device)
    if k == "reference":
        return chunk_attention(q, gather_block_kv(pk, tables),
                               gather_block_kv(pv, tables), start, scale,
                               window=window, sanitize=True)
    if k == "cuda":
        return cuda_core(q, pk, pv, tables, start, scale, window,
                         form="chunk")
    return plain_core(q, pk, pv, tables, start, scale, window)


def query_positions(start, b, c, device):
    """[B, C] int32 absolute position of every query row from a scalar
    or [B] start."""
    s = torch.as_tensor(start, device=device).reshape(-1, 1)
    qpos = s.to(torch.int32) + torch.arange(c, dtype=torch.int32,
                                            device=device)
    return qpos.expand(b, c)


# ---------------------------------------------------------------------------
# plain PyTorch: loop over pool blocks, flash-attention recurrence
# ---------------------------------------------------------------------------

def plain_core(q, pk, pv, tables, start, scale, window=None):
    """Online-softmax attention streamed block by block out of the pool
    (the port of `_lax_core`). Carries (m, l, acc) across the nblk
    steps: block j of every lane is fetched ([B, Hkv, BS, D], the only
    gathered working set), scored, masked with -inf at ks > qpos (and
    outside the window) and folded in with alpha = exp(m_old - m_new).
    Fully masked rows finish with l == 0 and renormalise to exactly 0."""
    b, h, c, d = q.shape
    hkv, bs = pk.shape[1], pk.shape[2]
    nblk = tables.shape[1]
    rep = h // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, rep, c, d)
    qpos = query_positions(start, b, c, dev).long()        # [B, C]
    tables = tables.long()
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    m = torch.full((b, hkv, rep, c), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, rep, c), device=dev)
    acc = torch.zeros((b, hkv, rep, c, d), device=dev)
    for j in range(nblk):
        blk = tables[:, j]
        kblk = pk[blk].float()                              # [B,Hkv,BS,D]
        vblk = pv[blk].float()
        s = torch.einsum("bkrcd,bksd->bkrcs", qf, kblk) * scale
        ks = j * bs + torch.arange(bs, device=dev)
        keep = ks[None, None, :] <= qpos[:, :, None]        # [B, C, BS]
        if window is not None:
            keep &= ks[None, None, :] > qpos[:, :, None] - window
        # 0 * nan == nan: zero the V rows no query of the lane keeps
        vblk = torch.where(keep.any(dim=1)[:, None, :, None], vblk, zero)
        s = torch.where(keep[:, None, None], s, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows masked so far carry m == -inf: shift by 0, never inf - inf
        shift = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - shift[..., None])
        alpha = torch.exp(m - shift)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + \
            torch.einsum("bkrcs,bksd->bkrcd", p, vblk)
        m = m_new
    # == 0, not > 0: a nan denominator must propagate
    out = torch.where(l[..., None] == 0, zero, acc / l[..., None])
    return out.reshape(b, h, c, d).to(pv.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is built for the serving path's shapes only: GPT-2 small's
# head_dim and pool blocks of at most 16 keys
_HEAD_DIM = 64
_MAX_BLOCK_SIZE = 16


def cuda_core(q, pk, pv, tables, start, scale, window=None, form="chunk"):
    """Launch csrc/paged_attention.cu on CUDA tensors (the port of
    `_pallas_core`). Checks device, dtype, shape and contiguity, raises
    on anything the kernel does not take, and raises if the launch
    reports an error. q is cast to f32 and viewed as
    [B, Hkv, rep * C, D] (group-major, query-minor rows); the kernel
    writes f32, cast here to the pool dtype. `form` ("decode" or
    "chunk") names the launch counter to advance."""
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("tables", tables)):
        if t.device.type != "cuda":
            raise RuntimeError(f"paged attention kernel 'cuda' needs CUDA "
                               f"tensors; {name} is on {t.device}")
    dev = q.device
    if any(t.device != dev for t in (pk, pv, tables)):
        raise RuntimeError("paged attention: q, pools and tables must be "
                           "on one device")
    if pk.dtype not in _POOL_DTYPES or pv.dtype != pk.dtype:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"pools of one dtype, got {pk.dtype}/{pv.dtype}")
    if tables.dtype != torch.int32:
        raise TypeError(f"block tables must be int32, got {tables.dtype}")
    if q.dim() != 4 or pk.dim() != 4 or pk.shape != pv.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pk.shape)}/{tuple(pv.shape)}")
    b, h, c, d = q.shape
    nb, hkv, bs, dk = pk.shape
    if dk != d or h % hkv or d != _HEAD_DIM \
            or not 1 <= bs <= _MAX_BLOCK_SIZE or tables.dim() != 2 \
            or tables.shape[0] != b:
        raise ValueError(
            f"paged attention kernel: unsupported shapes q {tuple(q.shape)}"
            f", pools {tuple(pk.shape)}, tables {tuple(tables.shape)} "
            f"(head_dim {_HEAD_DIM}, block_size <= {_MAX_BLOCK_SIZE})")
    if not (pk.is_contiguous() and pv.is_contiguous()
            and tables.is_contiguous()):
        raise ValueError("paged attention kernel needs contiguous pools "
                         "and tables")
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("paged attention kernel reads the pools in "
                         "16-byte vectors: they must be 16-byte aligned")
    rep = h // hkv
    nblk = tables.shape[1]
    qr = q.float().reshape(b, hkv, rep * c, d).contiguous()
    qpos = query_positions(start, b, c, dev).contiguous()
    out = torch.empty((b, hkv, rep * c, d), dtype=torch.float32,
                      device=dev)
    from .. import kernels
    lib = kernels.load("paged_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.paged_attention_fwd(
        qr.data_ptr(), pk.data_ptr(), pv.data_ptr(), tables.data_ptr(),
        qpos.data_ptr(), out.data_ptr(), b, hkv, rep * c, c, d, bs, nblk,
        nb, float(scale), 0 if window is None else 1,
        0 if window is None else int(window), _POOL_DTYPES[pk.dtype],
        stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches[form] += 1
    return out.reshape(b, h, c, d).to(pv.dtype)
