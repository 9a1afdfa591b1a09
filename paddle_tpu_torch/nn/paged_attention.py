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
import ctypes
import os

import torch

from .. import kernels
from .transformer import (cached_decode_attention, chunk_attention,
                          gather_block_kv)

KERNELS = ("auto", "reference", "plain", "cuda")

_DEFAULT_KERNEL = "auto"
_SCOPE_STACK = []           # innermost kernel_scope override, LIFO

#: launches of the CUDA kernel by form since the last reset — plain
#: integers, incremented by the wrapper where it launches and nowhere
#: else (chip_smoke.py zeroes them before driving the serving path and
#: reads them after). A CUDA-graph replay runs no Python and advances
#: nothing: the serving engines' programs record the launches each graph
#: captured and count its replays
launches = {"decode": 0, "chunk": 0}
kernels.COUNTERS["paged_attention"] = launches


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

def plain_core(q, pk, pv, tables, start, scale, window=None,
               split_blocks=None):
    """Online-softmax attention streamed block by block out of the pool
    (the port of `_lax_core`). Carries (m, l, acc) across the nblk
    steps: block j of every lane is fetched ([B, Hkv, BS, D], the only
    gathered working set), scored, masked with -inf at ks > qpos (and
    outside the window) and folded in with alpha = exp(m_old - m_new).
    Fully masked rows finish with l == 0 and renormalise to exactly 0.

    split_blocks=P walks the pool blocks in splits of P from a fresh
    state each and merges the splits' states as the CUDA kernel's
    combine does (`merge_states`); None walks them in one pass."""
    b, h, c, d = q.shape
    hkv = pk.shape[1]
    nblk = tables.shape[1]
    rep = h // hkv
    qf = q.float().reshape(b, hkv, rep, c, d)
    qpos = query_positions(start, b, c, q.device).long()    # [B, C]
    tables = tables.long()
    step = nblk if split_blocks is None else int(split_blocks)
    states = [_walk(qf, pk, pv, tables, qpos, scale, window,
                    range(j, min(j + step, nblk)))
              for j in range(0, nblk, step)]
    out = merge_states(*zip(*states))
    return out.reshape(b, h, c, d).to(pv.dtype)


def _walk(qf, pk, pv, tables, qpos, scale, window, blocks):
    """(m, l, acc) of the online softmax over pool blocks `blocks`,
    from the empty state (m = -inf, l = 0, acc = 0)."""
    b, hkv, rep, c, d = qf.shape
    bs = pk.shape[2]
    dev = qf.device
    neg_inf = torch.full((), float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    m = torch.full((b, hkv, rep, c), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, rep, c), device=dev)
    acc = torch.zeros((b, hkv, rep, c, d), device=dev)
    for j in blocks:
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
    return m, l, acc


def merge_states(ms, ls, accs):
    """Output rows from the (m, l, acc) states of disjoint key ranges:
    each state rescaled against the common max (NaN-propagating; shift 0
    while it is -inf), then out = (l == 0) ? 0 : acc / l."""
    m = torch.stack(ms)
    mx = m.amax(dim=0)                    # amax propagates NaN
    shift = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    wt = torch.exp(m - shift)
    l = (wt * torch.stack(ls)).sum(dim=0)
    acc = (wt[..., None] * torch.stack(accs)).sum(dim=0)
    # == 0, not > 0: a nan denominator must propagate
    return torch.where(l[..., None] == 0, torch.zeros_like(acc),
                       acc / l[..., None])


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is built for the serving path's shapes only: GPT-2 small's
# head_dim and pool blocks of at most 16 keys
_HEAD_DIM = 64
_MAX_BLOCK_SIZE = 16
# the split kernel's positions are int32 (see csrc/paged_attention.cu)
_MAX_WINDOW = 1 << 29
#: pool blocks per split of the CUDA kernel, by the rows a (lane,
#: kv-head) holds, rep * C: 8 (128 keys of 16-key blocks) up to 8 rows —
#: decode, and the speculative verify at C = k + 1 — and 4 (64 keys)
#: past that, whose 64-row tiles fill fewer CUDA blocks (the fastest on
#: the card over 4, 8, 16 and 64, PERF.md)
SPLIT_BLOCKS = {"few_rows": 8, "row_tiles": 4}


def default_split_blocks(rows):
    """Pool blocks per split for `rows` rows a (lane, kv-head)."""
    return SPLIT_BLOCKS["few_rows" if rows <= 8 else "row_tiles"]


def _start_arg(start, b, dev):
    """(pointer, scalar, element bytes, stride) of the lanes' start
    positions as the kernel reads them: a device int32/int64 tensor of
    one or B values in place, anything else as one host integer."""
    if isinstance(start, torch.Tensor):
        if start.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"paged attention: start must be int32 or "
                            f"int64, got {start.dtype}")
        if start.numel() not in (1, b):
            raise ValueError(f"paged attention: start holds "
                             f"{start.numel()} values for {b} lanes")
        if start.device.type != "cuda":
            if start.numel() != 1:
                raise RuntimeError("paged attention kernel 'cuda': a "
                                   "per-lane start must be on the device")
            return None, int(start), 4, 0
        if start.device != dev:
            raise RuntimeError("paged attention: start is on "
                               f"{start.device}, q on {dev}")
        flat = start.reshape(-1)
        if flat.numel() > 1 and flat.stride(0) != 1:
            raise ValueError("paged attention kernel: start must be "
                             "contiguous")
        return (flat.data_ptr(), 0, flat.element_size(),
                1 if flat.numel() > 1 else 0)
    return None, int(start), 4, 0


def cuda_core(q, pk, pv, tables, start, scale, window=None, form="chunk",
              split_blocks=None):
    """Launch csrc/paged_attention.cu on CUDA tensors (the port of
    `_pallas_core`): its split kernel and its combine kernel, and no
    other device work. Checks device, dtype, shape and layout, raises on
    anything the kernel does not take, and raises if a launch reports an
    error. q (f32 or bf16, any strides with a contiguous head dim) and
    start (a scalar, or a device int32/int64 tensor of 1 or B values)
    are read in place; the kernel writes the output in the pool dtype
    into a [B, C, H, D] buffer, returned as its [B, H, C, D] view, and
    the splits' states into an f32 workspace allocated here.
    `split_blocks` pool blocks per split (default
    `default_split_blocks(rep * C)`). `form`
    ("decode" or "chunk") names the launch counter to advance."""
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("tables", tables)):
        if t.device.type != "cuda":
            raise RuntimeError(f"paged attention kernel 'cuda' needs CUDA "
                               f"tensors; {name} is on {t.device}")
    dev = q.device
    if any(t.device != dev for t in (pk, pv, tables)):
        raise RuntimeError("paged attention: q, pools and tables must be "
                           "on one device")
    if pk.dtype not in _DTYPES or pv.dtype != pk.dtype:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"pools of one dtype, got {pk.dtype}/{pv.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"q, got {q.dtype}")
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
    if q.stride(3) != 1:
        raise ValueError("paged attention kernel reads q with a contiguous "
                         "head dim")
    if not (pk.is_contiguous() and pv.is_contiguous()
            and tables.is_contiguous()):
        raise ValueError("paged attention kernel needs contiguous pools "
                         "and tables")
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("paged attention kernel reads the pools in "
                         "16-byte vectors: they must be 16-byte aligned")
    if window is not None and window > _MAX_WINDOW:
        raise ValueError(f"paged attention kernel takes a window of at "
                         f"most {_MAX_WINDOW}, got {window}")
    split = (default_split_blocks(h // hkv * c) if split_blocks is None
             else int(split_blocks))
    start_ptr, start_val, start_elt, start_stride = _start_arg(start, b, dev)
    nblk = tables.shape[1]
    nsplit = -(-nblk // split)
    out = torch.empty((b, c, h, d), dtype=pv.dtype, device=dev)
    work = torch.empty((b, hkv, nsplit, h // hkv * c, d + 2),
                       dtype=torch.float32, device=dev)
    lib = kernels.load("paged_attention")
    strides = (ctypes.c_longlong * 3)(*q.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.paged_attention_fwd(
        q.data_ptr(), strides, _DTYPES[q.dtype], pk.data_ptr(),
        pv.data_ptr(), tables.data_ptr(), start_ptr, start_val, start_elt,
        start_stride, out.data_ptr(), work.data_ptr(), b, h, hkv, c, d, bs,
        nblk, nb, split, float(scale), 0 if window is None else 1,
        0 if window is None else int(window), _DTYPES[pk.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches[form] += 1
    return out.permute(0, 2, 1, 3)
