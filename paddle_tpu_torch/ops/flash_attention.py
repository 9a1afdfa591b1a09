"""Flash attention (the port of `paddle_tpu/ops/pallas/flash_attention.py`).

Three implementations sit behind one dispatch point, the pattern of
`nn/paged_attention.py`:

  kernel="reference"  `_sdpa_reference` under torch autograd: dense f32
                      logits, softmax, p cast to V's dtype — the parity
                      oracle;
  kernel="plain"      the kernels' arithmetic in torch ops: a blockwise
                      online-softmax forward that returns (out, lse), and
                      blockwise dK/dV and dQ loops that recompute P from
                      the saved lse. Used for CPU tensors and to check the
                      kernels on the card;
  kernel="cuda"       the hand-written sm_90a kernels of
                      csrc/flash_attention.cu (K1 forward, K2 dK/dV, K3
                      dQ, and dd = rowsum(dO * O)). They launch for
                      CUDA tensors and raise for anything else — there
                      is no fallback. bf16
                      operands must meet `tma_aligned` (16-byte base
                      and strides; every view of the qkv projection
                      does); the wrappers raise a ValueError naming the
                      tensor that does not;
  kernel="auto"       "cuda" for CUDA tensors, "plain" for CPU tensors.

The Tensor surface reaches the same code through the registered
`flash_attention` op (`_flash_attention_raw`, dispatched by `apply`):
`flash_attention` given port `Tensor`s goes through the dispatcher, so
the eager path runs K1 on the card and `loss.backward()` runs dd, K2 and
K3; given torch tensors (the GPT and LLaMA models, the engines) it runs
directly.

"plain" and "cuda" run inside one `torch.autograd.Function` that saves
(q, k, v, out, lse); its backward computes dd = rowsum(dO * O) in f32
(`row_dot`: torch ops, or a kernel of its own) and then runs dK/dV and
dQ, as `_flash_core`'s custom_vjp does. A mask, attention dropout, or
sequence lengths that are not multiples of 128 take the dense path, as
`_flash_array` does.

Layouts: "bhsd" ([B, H, S, D]) and "bshd" ([B, S, H, D], the GPT
default). The kernels read both through (batch, seq, head) strides, so
q/k/v may be strided views of the fused qkv projection.

Masking contract (that of the Pallas kernels): causal masking counts
absolute query positions from kv_len - q_len; `window` keeps the last W
keys of each query; masked scores are -inf before the max; the shift is
0 while the running max is -inf; lse = (m if finite else 0) +
log(max(l, 1e-30)) and out = acc / max(l, 1e-30), so a fully masked row
is exactly 0; the max and the clamp propagate NaN.

Resolution order for kernel=None: the innermost `kernel_scope(...)` >
the `PT_FLASH_KERNEL` environment variable > `set_flash_kernel` >
"auto".
"""
import contextlib
import ctypes
import math
import os

import torch

from .. import kernels
from ..framework import state
from ..framework.tensor import Tensor
from .dispatch import apply, register_op

KERNELS = ("auto", "reference", "plain", "cuda")

_DEFAULT_KERNEL = "auto"
_SCOPE_STACK = []           # innermost kernel_scope override, LIFO

#: launches of the CUDA kernels since the last reset — plain integers,
#: incremented by the wrappers where they launch and nowhere else
#: (chip_smoke.py zeroes them before driving the training path and
#: reads them after); "dd" counts the rowsum(dO * O) kernel
launches = {"fwd": 0, "dkv": 0, "dq": 0, "dd": 0}
kernels.COUNTERS["flash_attention"] = launches
#: calls of `flash_attention` by route: "kernel" (the autograd Function
#: over plain or cuda) and "dense" (a mask, dropout or an ineligible
#: shape); chip_smoke.py checks that the training path never went dense
routes = {"kernel": 0, "dense": 0}


def set_flash_kernel(kernel):
    """Set the process-wide default flash-attention kernel."""
    global _DEFAULT_KERNEL
    _DEFAULT_KERNEL = _check(kernel)


def _check(kernel):
    if kernel not in KERNELS:
        raise ValueError(f"unknown flash kernel {kernel!r}: "
                         f"expected one of {KERNELS}")
    return kernel


@contextlib.contextmanager
def kernel_scope(kernel):
    """Pin the kernel inside a `with` block."""
    _SCOPE_STACK.append(_check(kernel))
    try:
        yield
    finally:
        _SCOPE_STACK.pop()


def resolve_kernel(kernel=None, device=None):
    """Resolve to "reference" | "plain" | "cuda". Order: explicit
    argument > innermost kernel_scope > PT_FLASH_KERNEL > the
    set_flash_kernel default; "auto" at any level resolves by the
    tensors' device: "cuda" on a CUDA device, "plain" elsewhere."""
    if kernel is not None:
        choice = _check(kernel)
    elif _SCOPE_STACK:
        choice = _SCOPE_STACK[-1]
    else:
        env = os.environ.get("PT_FLASH_KERNEL", "").strip().lower()
        choice = _check(env) if env else _DEFAULT_KERNEL
    if choice != "auto":
        return choice
    dev = torch.device("cpu" if device is None else device)
    return "cuda" if dev.type == "cuda" else "plain"


# ---------------------------------------------------------------------------
# masks and loop bounds (own copies of the JAX package's helpers)
# ---------------------------------------------------------------------------

def _band_keep(q_idx, k_idx, window):
    """Causal(+sliding-window) mask — one definition for every path."""
    keep = k_idx <= q_idx
    if window is not None:
        keep = keep & (k_idx > q_idx - window)
    return keep


def _causal_block_bounds(off, qblk, bq, bk, nblocks, window):
    """KV-block loop bounds [lower, upper) for one q block under
    causal(+window) masking: every block the q block sees (the outer
    bounds of the Pallas helper; its edge/interior split is an
    optimisation the port's loops do not make)."""
    qlo = off + qblk * bq
    upper = min(nblocks, (off + (qblk + 1) * bq + bk - 1) // bk)
    lower = 0 if window is None else max(0, (qlo - window + 1) // bk)
    return lower, upper


def _dkv_block_bounds(off, kb, bq, bk, nqb, window):
    """Q-block loop bounds [start, end) for one k block under causal
    (+window) masking. Unlike the Pallas `_bwd_dkv_kernel` (whose bounds
    are not clamped to `start`, ROADMAP Queue 3), `end` never falls below
    `start`: with a window and q_len < kv_len no negative block is
    visited."""
    start = min(max(0, (kb * bk - off) // bq), nqb)
    end = nqb
    if window is not None:
        last = kb * bk + bk - 1 + window - 1 - off   # last q row seeing it
        end = min(nqb, last // bq + 1)
    return start, max(end, start)


def _tile_straddles(off, q0, k0, bq, bk, window):
    """Whether the causal(+window) band cuts the tile of q rows [q0, q0 +
    bq) (counted from the start of q) and keys [k0, k0 + bk): the bf16
    kernels mask only such tiles, since every other tile keeps all of
    its pairs."""
    qa = off + q0
    return k0 + bk - 1 > qa or (window is not None
                                and k0 <= qa + bq - 1 - window)


# ---------------------------------------------------------------------------
# reference and dense paths (torch autograd)
# ---------------------------------------------------------------------------

def _dense_logits(q, k, scale):
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    # f32 logits from the input dtype: products of bf16 values are exact
    # in f32, as preferred_element_type=f32 gives them
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * s
    return logits


def _causal_mask(logits, window):
    qlen, klen = logits.shape[-2], logits.shape[-1]
    dev = logits.device
    qi = torch.arange(qlen, device=dev)[:, None] + (klen - qlen)
    ki = torch.arange(klen, device=dev)[None, :]
    # a fill, not a host-to-device copy: a CUDA graph can capture it
    return torch.where(_band_keep(qi, ki, window), logits,
                       torch.full((), float("-inf"), device=dev))


def _apply_mask(logits, mask):
    if mask.dtype == torch.bool:
        return torch.where(mask, logits, torch.full(
            (), float("-inf"), device=logits.device))
    return logits + mask.float()


def _pv(p, v):
    """p (f32) cast to V's dtype, times V with f32 accumulation, out in
    V's dtype."""
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _sdpa_reference(q, k, v, mask, causal, scale, window=None):
    """Dense attention, [B, H, S, D]: f32 logits and softmax whatever the
    input dtype; window=W keeps the last W keys per query."""
    logits = _dense_logits(q, k, scale)
    if causal:
        logits = _causal_mask(logits, window)
    if mask is not None:
        logits = _apply_mask(logits, mask)
    return _pv(torch.softmax(logits, dim=-1), v)


def _dense(q, k, v, mask, causal, dropout_p, scale, window, generator):
    """`_flash_array`'s dense path, [B, H, S, D], with attention dropout
    drawn from `generator`."""
    logits = _dense_logits(q, k, scale)
    if causal:
        logits = _causal_mask(logits, window)
    if mask is not None:
        logits = _apply_mask(logits, mask)
    p = torch.softmax(logits, dim=-1)
    if dropout_p:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit "
                             "torch.Generator: pass generator=")
        keep = torch.bernoulli(torch.full_like(p, 1.0 - dropout_p),
                               generator=generator).bool()
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    return _pv(p, v)


def kernel_len(n):
    """The length the kernel route takes for a sequence of n tokens: n
    rounded up to a multiple of 128, at least 128. A length equal to its
    own `kernel_len` is one the kernels take."""
    return max(128, -(-int(n) // 128) * 128)


def _kernel_eligible(q, k, mask, dropout_p, bshd):
    if mask is not None or dropout_p:
        return False
    seq_ax = 1 if bshd else 2
    sq, sk = q.shape[seq_ax], k.shape[seq_ax]
    return sq == kernel_len(sq) and sk == kernel_len(sk)


# ---------------------------------------------------------------------------
# plain PyTorch: the kernels' arithmetic, block by block
# ---------------------------------------------------------------------------

_PLAIN_BLOCK = 128


def _bhsd(t, bshd):
    return t.transpose(1, 2) if bshd else t


def _keep_tile(off, q0, k0, bq, bk, window, device):
    qi = off + q0 + torch.arange(bq, device=device)[:, None]
    ki = k0 + torch.arange(bk, device=device)[None, :]
    return _band_keep(qi, ki, window)


def plain_fwd(q, k, v, causal, scale, bshd=False, window=None):
    """Online-softmax forward over K/V blocks (K1's arithmetic). Returns
    (out in q's layout and dtype, lse [B, H, Sq] f32)."""
    q, k, v = (_bhsd(t, bshd) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    off = sk - sq
    blk = _PLAIN_BLOCK
    dev = q.device
    zero = torch.zeros((), device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    for qb in range(sq // blk):
        qt = q[:, :, qb * blk:(qb + 1) * blk].float()
        lower, upper = 0, sk // blk
        if causal:
            lower, upper = _causal_block_bounds(off, qb, blk, blk,
                                                sk // blk, window)
        m = torch.full((b, h, blk), float("-inf"), device=dev)
        l = torch.zeros((b, h, blk), device=dev)
        acc = torch.zeros((b, h, blk, d), device=dev)
        for j in range(lower, upper):
            kt = k[:, :, j * blk:(j + 1) * blk].float()
            vt = v[:, :, j * blk:(j + 1) * blk]
            s = qt @ kt.transpose(-1, -2) * scale
            if causal:
                s = torch.where(_keep_tile(off, qb * blk, j * blk, blk, blk,
                                           window, dev), s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # rows masked so far carry m == -inf: shift by 0
            shift = torch.where(torch.isfinite(m_new), m_new, zero)
            p = torch.exp(s - shift[..., None])
            alpha = torch.exp(torch.where(torch.isfinite(m), m - shift,
                                          neg_inf))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(vt.dtype).float() @ vt.float()
            m = m_new
        den = torch.clamp(l, min=1e-30)          # clamp keeps a NaN
        out[:, :, qb * blk:(qb + 1) * blk] = (acc / den[..., None]).to(
            q.dtype)
        lse[:, :, qb * blk:(qb + 1) * blk] = \
            torch.where(torch.isfinite(m), m, zero) + torch.log(den)
    return (out.transpose(1, 2).contiguous() if bshd else out), lse


def plain_bwd_dkv(q, k, v, do, lse, dd, causal, scale, bshd=False,
                  window=None, bq=_PLAIN_BLOCK, bk=_PLAIN_BLOCK):
    """dK and dV over q blocks, P recomputed from the saved lse (K2's
    arithmetic). lse and dd are [B, H, Sq] f32. `bq` x `bk` is the
    schedule of q tiles against k blocks (the bf16 kernel walks 64-row q
    tiles over 128-key blocks): it decides which masked pairs are
    visited, and so where a NaN in dd spreads. Returns (dk, dv) in k's
    and v's layout and dtype."""
    q, k, v, do = (_bhsd(t, bshd) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    off = sk - sq
    dev = q.device
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=dev)
    for kb in range(sk // bk):
        k0 = kb * bk
        kt = k[:, :, k0:k0 + bk].float()
        vt = v[:, :, k0:k0 + bk].float()
        start, end = 0, sq // bq
        if causal:
            start, end = _dkv_block_bounds(off, kb, bq, bk, sq // bq, window)
        dk_acc = torch.zeros((b, h, bk, d), device=dev)
        dv_acc = torch.zeros((b, h, bk, d), device=dev)
        for i in range(start, end):
            rows = slice(i * bq, (i + 1) * bq)
            qt = q[:, :, rows]
            dot = do[:, :, rows]
            s = qt.float() @ kt.transpose(-1, -2) * scale
            p = torch.exp(s - lse[:, :, rows, None])
            if causal and _tile_straddles(off, i * bq, k0, bq, bk, window):
                p = torch.where(_keep_tile(off, i * bq, k0, bq, bk, window,
                                           dev), p,
                                torch.zeros((), device=dev))
            dv_acc = dv_acc + p.to(dot.dtype).float().transpose(-1, -2) \
                @ dot.float()
            dp = dot.float() @ vt.transpose(-1, -2)
            ds = p * (dp - dd[:, :, rows, None]) * scale
            dk_acc = dk_acc + ds.to(qt.dtype).float().transpose(-1, -2) \
                @ qt.float()
        dk[:, :, k0:k0 + bk] = dk_acc.to(k.dtype)
        dv[:, :, k0:k0 + bk] = dv_acc.to(v.dtype)
    if bshd:
        return dk.transpose(1, 2).contiguous(), dv.transpose(1, 2).contiguous()
    return dk, dv


def plain_bwd_dq(q, k, v, do, lse, dd, causal, scale, bshd=False,
                 window=None, bq=_PLAIN_BLOCK, bk=_PLAIN_BLOCK):
    """dQ over k blocks with K1's bounds (K3's arithmetic). `bq` x `bk` is
    the schedule of q blocks against k tiles (the bf16 kernel walks
    128-row q blocks over 64-key tiles): it decides which masked pairs
    are visited, and so which dQ rows a NaN in K reaches. Returns dq in
    q's layout and dtype."""
    q, k, v, do = (_bhsd(t, bshd) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    off = sk - sq
    dev = q.device
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    for qb in range(sq // bq):
        q0 = qb * bq
        rows = slice(q0, q0 + bq)
        qt = q[:, :, rows].float()
        dot = do[:, :, rows].float()
        lse_t = lse[:, :, rows, None]
        dd_t = dd[:, :, rows, None]
        lower, upper = 0, sk // bk
        if causal:
            lower, upper = _causal_block_bounds(off, qb, bq, bk, sk // bk,
                                                window)
        acc = torch.zeros((b, h, bq, d), device=dev)
        for j in range(lower, upper):
            kt = k[:, :, j * bk:(j + 1) * bk]
            vt = v[:, :, j * bk:(j + 1) * bk].float()
            p = torch.exp(qt @ kt.float().transpose(-1, -2) * scale - lse_t)
            if causal and _tile_straddles(off, q0, j * bk, bq, bk, window):
                p = torch.where(_keep_tile(off, q0, j * bk, bq, bk, window,
                                           dev), p,
                                torch.zeros((), device=dev))
            dp = dot @ vt.transpose(-1, -2)
            ds = p * (dp - dd_t) * scale
            acc = acc + ds.to(kt.dtype).float() @ kt.float()
        dq[:, :, rows] = acc.to(q.dtype)
    return dq.transpose(1, 2).contiguous() if bshd else dq


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# built for GPT-2 small's head_dim; the kernels tile 64 rows, the
# wrapper keeps `_kernel_eligible`'s multiples of 128
_HEAD_DIM = 64


def _strides(t, bshd):
    """(batch, seq, head) element strides of a [B,S,H,D] or [B,H,S,D]
    tensor."""
    return (t.stride(0), t.stride(1), t.stride(2)) if bshd else \
        (t.stride(0), t.stride(2), t.stride(1))


def _check_cuda(what, tensors, bshd):
    """Device, dtype and shape checks common to the three wrappers.
    Returns (b, h, sq, sk, d)."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise RuntimeError(f"flash attention kernel 'cuda' ({what}) "
                               f"needs CUDA tensors; {name} is on "
                               f"{t.device}")
    q, k, v = tensors["q"], tensors["k"], tensors["v"]
    dev = q.device
    if any(t.device != dev for t in tensors.values()):
        raise RuntimeError("flash attention: inputs must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if bshd:
        b, sq, h, d = q.shape
        sk = k.shape[1]
        kb, kh = k.shape[0], k.shape[2]
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
        kb, kh = k.shape[0], k.shape[1]
    if (kb, kh, k.shape[3]) != (b, h, d) or d != _HEAD_DIM \
            or sq != kernel_len(sq) or sk != kernel_len(sk):
        raise ValueError(
            f"flash attention kernel: unsupported shapes q "
            f"{tuple(q.shape)}, k {tuple(k.shape)} (head_dim {_HEAD_DIM}, "
            f"sequence lengths multiples of 128)")
    for name in ("q", "k", "v", "do"):
        if name in tensors and tensors[name].stride(-1) != 1:
            raise ValueError(f"flash attention kernel: {name} needs a "
                             f"contiguous last dimension")
    return b, h, sq, sk, d


def tma_aligned(data_ptr, strides, element_size):
    """Whether an operand meets the kernels' alignment rule: TMA (bf16
    K1-K3) and the 16-byte loads (the dd kernel, f32 or bf16) need a
    16-byte-aligned base address and (batch, seq, head) strides of whole
    16 bytes."""
    return data_ptr % 16 == 0 and all(s * element_size % 16 == 0
                                      for s in strides)


def _check_aligned(tensors, bshd):
    """Raise for a bf16 operand that breaks `tma_aligned`, naming it."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and not tma_aligned(
                t.data_ptr(), _strides(t, bshd), t.element_size()):
            raise ValueError(
                f"flash attention kernel: bf16 {name} needs a 16-byte "
                f"aligned base and (batch, seq, head) strides of whole 16 "
                f"bytes; got address {t.data_ptr():#x}, strides "
                f"{_strides(t, bshd)}")


def _launch(fn, what, *args):
    lib = kernels.load("flash_attention")
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {rc}")
    launches[what] += 1


def _stride_array(tensors, bshd):
    vals = [s for t in tensors for s in _strides(t, bshd)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _window_arg(causal, window):
    return int(window) if causal and window is not None else 0


def cuda_fwd(q, k, v, causal, scale, bshd=False, window=None):
    """Launch K1 (csrc/flash_attention.cu) on CUDA tensors. Returns (out
    in q's layout and dtype, lse [B, H, Sq] f32)."""
    b, h, sq, sk, d = _check_cuda("fwd", {"q": q, "k": k, "v": v}, bshd)
    _check_aligned({"q": q, "k": k, "v": v}, bshd)
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash attention kernel: bf16 K1 takes a "
                         f"positive scale, got {scale}")
    shape = (b, sq, h, d) if bshd else (b, h, sq, d)
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((q, k, v, out), bshd), b, h, sq, sk, d,
            float(scale), int(bool(causal)), _window_arg(causal, window),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def _check_stats(lse, dd, b, h, sq):
    for name, t in (("lse", lse), ("dd", dd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq) \
                or not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous "
                             f"f32 [{b}, {h}, {sq}]")


def cuda_bwd_dkv(q, k, v, do, lse, dd, causal, scale, bshd=False,
                 window=None):
    """Launch K2: dK and dV (k's and v's layout and dtype)."""
    b, h, sq, sk, d = _check_cuda(
        "dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "dd": dd},
        bshd)
    _check_stats(lse, dd, b, h, sq)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention: dO must match q")
    _check_aligned({"q": q, "k": k, "v": v, "do": do}, bshd)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_attention_bwd_dkv", "dkv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            _stride_array((q, k, v, do, dk, dv), bshd), b, h, sq, sk, d,
            float(scale), int(bool(causal)), _window_arg(causal, window),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def cuda_bwd_dq(q, k, v, do, lse, dd, causal, scale, bshd=False,
                window=None):
    """Launch K3: dQ (q's layout and dtype)."""
    b, h, sq, sk, d = _check_cuda(
        "dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "dd": dd},
        bshd)
    _check_stats(lse, dd, b, h, sq)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention: dO must match q")
    _check_aligned({"q": q, "k": k, "v": v, "do": do}, bshd)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_attention_bwd_dq", "dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), _stride_array((q, k, v, do, dq), bshd), b, h, sq,
            sk, d, float(scale), int(bool(causal)),
            _window_arg(causal, window), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def plain_row_dot(do, out, bshd):
    """dd = rowsum(dO * O) in f32, [B, H, Sq] contiguous."""
    dd = (do.float() * out.float()).sum(dim=-1)
    return (dd.transpose(1, 2) if bshd else dd).contiguous()


def cuda_row_dot(do, out, bshd):
    """Launch the dd kernel (csrc/flash_attention.cu): rowsum(dO * O) in
    f32, [B, H, Sq] contiguous, from f32 or bf16 dO and O in the same
    layout. Both need a contiguous last dimension of 64, a 16-byte-aligned
    base and strides of whole 16 bytes."""
    for name, t in (("do", do), ("out", out)):
        if t.device.type != "cuda":
            raise RuntimeError(f"flash attention kernel 'cuda' (dd) needs "
                               f"CUDA tensors; {name} is on {t.device}")
    if do.device != out.device:
        raise RuntimeError("flash attention: inputs must be on one device")
    if do.dtype not in _DTYPES or out.dtype != do.dtype:
        raise TypeError(f"flash attention dd kernel takes float32 or "
                        f"bfloat16 dO and O of one dtype, got {do.dtype}/"
                        f"{out.dtype}")
    if do.dim() != 4 or do.shape != out.shape or do.shape[-1] != _HEAD_DIM:
        raise ValueError(f"flash attention dd kernel: unsupported shapes dO "
                         f"{tuple(do.shape)}, O {tuple(out.shape)} "
                         f"(head_dim {_HEAD_DIM})")
    for name, t in (("do", do), ("out", out)):
        if t.stride(-1) != 1 or not tma_aligned(
                t.data_ptr(), _strides(t, bshd), t.element_size()):
            raise ValueError(
                f"flash attention dd kernel: {name} needs a contiguous "
                f"last dimension, a 16-byte aligned base and (batch, seq, "
                f"head) strides of whole 16 bytes; got address "
                f"{t.data_ptr():#x}, strides {t.stride()}")
    b, sq, h, d = do.shape if bshd else (do.shape[0], do.shape[2],
                                         do.shape[1], do.shape[3])
    dd = torch.empty((b, h, sq), dtype=torch.float32, device=do.device)
    _launch("flash_attention_row_dot", "dd", do.data_ptr(), out.data_ptr(),
            dd.data_ptr(), _stride_array((do, out), bshd), b, h, sq, d,
            _DTYPES[do.dtype],
            torch.cuda.current_stream(do.device).cuda_stream)
    return dd


_IMPLS = {"plain": (plain_fwd, plain_bwd_dkv, plain_bwd_dq),
          "cuda": (cuda_fwd, cuda_bwd_dkv, cuda_bwd_dq)}
_ROW_DOTS = {"plain": plain_row_dot, "cuda": cuda_row_dot}


def row_dot(do, out, bshd, impl):
    """dd = rowsum(dO * O) in f32, [B, H, Sq], by `impl` ("plain" or
    "cuda")."""
    return _ROW_DOTS[impl](do, out, bshd)


class _FlashCore(torch.autograd.Function):
    """Forward K1, backward dd, K2 then K3 (or their plain versions): the
    counterpart of `_flash_core`'s custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bshd, window, impl):
        fwd = _IMPLS[impl][0]
        out, lse = fwd(q, k, v, causal, scale, bshd, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, bshd, window, impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, bshd, window, impl = ctx.args
        _, dkv, dq = _IMPLS[impl]
        if g.stride(-1) != 1 or not tma_aligned(
                g.data_ptr(), _strides(g, bshd), g.element_size()):
            g = g.clone(memory_format=torch.contiguous_format)
        dd = row_dot(g, out, bshd, impl)
        dk, dv = dkv(q, k, v, g, lse, dd, causal, scale, bshd, window)
        dqv = dq(q, k, v, g, lse, dd, causal, scale, bshd, window)
        return dqv, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, attn_mask=None, causal=False, dropout_p=0.0,
                    scale=None, layout="bhsd", window=None, generator=None,
                    kernel=None):
    """Attention over q/k/v in `layout` ("bhsd": [B, H, S, D]; "bshd":
    [B, S, H, D], returned in the same layout). window=W (requires
    causal) keeps the last W keys per query. Attention dropout draws
    from `generator` (a torch.Generator on q's device). `kernel` picks
    the implementation (see the module docstring). Given port Tensors,
    it is the registered op (`_flash_attention_raw` through the
    dispatcher), with attention dropout drawn from the framework
    generator, as the JAX package draws `next_rng_key()`."""
    if isinstance(q, Tensor):
        args = (q, k, v) if attn_mask is None else (q, k, v, attn_mask)
        attrs = {"causal": bool(causal),
                 "scale": None if scale is None else float(scale),
                 "layout": str(layout),
                 "window": None if window is None else int(window),
                 "kernel": kernel}
        if dropout_p:
            attrs["dropout_p"] = float(dropout_p)
            attrs["generator"] = generator or state.rng_generator(
                q._data.device)
        return apply(_flash_attention_raw, args, attrs,
                     name="flash_attention")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding-window "
                             "attention is a causal mask refinement)")
        window = int(window)
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
    bshd = layout == "bshd"
    impl = resolve_kernel(kernel, q.device)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "reference" and not dropout_p:
        out = _sdpa_reference(_bhsd(q, bshd), _bhsd(k, bshd), _bhsd(v, bshd),
                              attn_mask, causal, s, window)
        return _bhsd(out, bshd)
    if impl != "reference" and _kernel_eligible(q, k, attn_mask, dropout_p,
                                                bshd):
        routes["kernel"] += 1
        return _FlashCore.apply(q, k, v, bool(causal), float(s), bshd,
                                window, impl)
    routes["dense"] += 1
    out = _dense(_bhsd(q, bshd), _bhsd(k, bshd), _bhsd(v, bshd), attn_mask,
                 causal, dropout_p, s, window, generator)
    return _bhsd(out, bshd)


def _flash_attention_raw(q, k, v, *maybe_mask, causal=False, scale=None,
                         layout="bhsd", window=None, dropout_p=0.0,
                         generator=None, kernel=None):
    """The registered form of the `flash_attention` op (the JAX package's
    `_flash_attention_raw`): torch tensors in and out, through
    `_FlashCore` when the shapes are the kernels' (K1 forward; dd, K2
    and K3 in the backward, on the card), else the dense path."""
    m = maybe_mask[0] if maybe_mask else None
    return flash_attention(q, k, v, attn_mask=m, causal=causal,
                           dropout_p=dropout_p, scale=scale, layout=layout,
                           window=window, generator=generator, kernel=kernel)


register_op("flash_attention", _flash_attention_raw)
