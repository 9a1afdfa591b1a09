"""Sequence ops on dense padded tensors + explicit lengths (the port of
`paddle_tpu/ops/sequence.py`; ref paddle/fluid/operators/sequence_ops/).

Every op takes `[B, T, ...]` padded data plus a `[B]` lengths vector and
is masked dense compute on the tensor's device. The `lod` concept
survives only at the Python edge: `sequence_pad`/`sequence_unpad` convert
between Python lists of variable-length arrays and the dense form.
"""
import numpy as np
import torch

from ..framework.tensor import Tensor
from .dispatch import def_op


def _mask(lengths, T, dtype=torch.float32):
    # [B, T] 1 where t < length
    t = torch.arange(T, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def _tail(x, m):
    """m [B, T] reshaped to broadcast over x's trailing dims."""
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


def _lowest(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point \
        else torch.iinfo(dtype).min


@def_op("sequence_pool", n_tensor_args=2)
def sequence_pool(x, lengths, pool_type="sum"):
    """Pool over the time axis honouring lengths (ref
    sequence_ops/sequence_pool_op.cc; pool types average/sum/sqrt/max/
    first/last). x: [B, T, ...], lengths: [B] int. Returns [B, ...]."""
    T = x.shape[1]
    pt = pool_type.lower()
    if pt == "first":
        return x[:, 0]
    if lengths is None:
        lengths = torch.full((x.shape[0],), T, dtype=torch.int32,
                             device=x.device)
    m = _tail(x, _mask(lengths, T, x.dtype))
    if pt in ("sum", "average", "sqrt"):
        s = torch.sum(x * m, dim=1)
        denom = torch.clamp(lengths, min=1).to(x.dtype)
        if pt == "sqrt":
            denom = torch.sqrt(denom)
        if pt != "sum":
            return s / denom.reshape(denom.shape + (1,) * (x.dim() - 2))
        return s
    if pt == "max":
        low = torch.full((), _lowest(x.dtype), dtype=x.dtype,
                         device=x.device)
        return torch.amax(torch.where(m > 0, x, low), dim=1)
    if pt == "last":
        idx = torch.clamp(lengths - 1, min=0).long()
        return torch.take_along_dim(
            x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1).squeeze(1)
    raise ValueError(f"unknown pool_type {pool_type}")


@def_op("sequence_reverse", n_tensor_args=2)
def sequence_reverse(x, lengths):
    """Reverse each sequence's valid prefix, keep padding in place
    (ref sequence_ops/sequence_reverse_op.h). x: [B, T, ...]."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    lens = lengths[:, None].long()
    src = torch.where(t < lens, lens - 1 - t, t)
    return torch.take_along_dim(
        x, src.reshape(src.shape + (1,) * (x.dim() - 2)), dim=1)


@def_op("sequence_softmax", n_tensor_args=2)
def sequence_softmax(x, lengths):
    """Softmax over the valid prefix of the time axis
    (ref sequence_ops/sequence_softmax_op.cc). x: [B, T]."""
    m = _mask(lengths, x.shape[1], x.dtype)
    low = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    z = torch.where(m > 0, x, low)
    z = z - torch.amax(z, dim=1, keepdim=True)
    e = torch.exp(z) * m
    return e / torch.clamp(torch.sum(e, dim=1, keepdim=True), min=1e-30)


@def_op("sequence_expand", n_tensor_args=1)
def sequence_expand(x, repeats=()):
    """Repeat each row i `repeats[i]` times — the dense analog of LoD-driven
    sequence_expand (ref sequence_ops/sequence_expand_op.cc). `repeats` is
    an attr (a host int vector), never a tensor."""
    reps = np.asarray(repeats)
    idx = torch.from_numpy(np.repeat(np.arange(reps.shape[0]), reps))
    return torch.index_select(x, 0, idx.to(x.device))


def sequence_pad(sequences, pad_value=0.0, maxlen=None, dtype=None):
    """python list of [Ti, ...] arrays -> (padded [B, T, ...], lengths [B])
    (ref sequence_ops/sequence_pad_op.cc). Host-side edge op."""
    arrs = [s.numpy() if isinstance(s, Tensor) else np.asarray(s)
            for s in sequences]
    lens = np.array([a.shape[0] for a in arrs], dtype=np.int32)
    T = int(maxlen) if maxlen is not None else int(lens.max(initial=0))
    lens = np.minimum(lens, T)  # truncation must be reflected in lengths
    tail = arrs[0].shape[1:] if arrs else ()
    out = np.full((len(arrs), T) + tail, pad_value,
                  dtype=dtype or (arrs[0].dtype if arrs else np.float32))
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a[:T]
    return Tensor(out), Tensor(lens)


def sequence_unpad(x, lengths):
    """Dense (x, lengths) -> python list of variable-length Tensors
    (ref sequence_ops/sequence_unpad_op.cc). Host-side edge op."""
    data = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    lens = lengths.numpy() if isinstance(lengths, Tensor) \
        else np.asarray(lengths)
    return [Tensor(data[i, :int(n)]) for i, n in enumerate(lens)]


@def_op("sequence_first_step", n_tensor_args=1)
def sequence_first_step(x):
    return sequence_pool.raw(x, None, pool_type="first")


@def_op("sequence_last_step", n_tensor_args=2)
def sequence_last_step(x, lengths):
    return sequence_pool.raw(x, lengths, pool_type="last")


@def_op("sequence_conv", n_tensor_args=3)
def sequence_conv(x, lengths, filter, context_length=3, context_start=None):
    """Context-window conv over the time axis (ref
    sequence_ops/sequence_conv_op.cc): each step attends a window of
    `context_length` steps starting at `context_start` (default centred),
    zero-padded at sequence edges AND beyond each row's length. x: [B,T,D],
    filter: [context_length*D, out]. Returns [B,T,out] (padding rows zero).
    Shift-and-stack the window into [B,T,ctx*D], then one matmul."""
    B, T, D = x.shape
    start = (-((context_length - 1) // 2) if context_start is None
             else context_start)
    m = _mask(lengths, T, x.dtype)[..., None]                 # [B,T,1]
    xm = x * m
    cols = []
    for k in range(context_length):
        off = start + k
        if off < 0:
            shifted = torch.nn.functional.pad(xm, (0, 0, -off, 0))[:, :T]
        elif off > 0:
            shifted = torch.nn.functional.pad(xm, (0, 0, 0, off))[:, off:]
        else:
            shifted = xm
        cols.append(shifted)
    window = torch.cat(cols, dim=-1)                          # [B,T,ctx*D]
    return torch.matmul(window, filter) * m                   # [B,T,out]


@def_op("sequence_slice", n_tensor_args=4)
def sequence_slice(x, lengths, offset, length):
    """Per-row slice [offset[i] : offset[i]+length[i]] (ref
    sequence_ops/sequence_slice_op.cc), front-packed with new lengths =
    length (padding zeroed). Returns (sliced [B,T,...], new_lengths [B])."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = torch.clamp(offset[:, None].long() + t, 0, T - 1)
    out = torch.take_along_dim(
        x, src.reshape(src.shape + (1,) * (x.dim() - 2)), dim=1)
    valid = t < length[:, None]
    out = out * _tail(x, valid).to(x.dtype)
    return out, length.to(torch.int32)


@def_op("sequence_concat", n_tensor_args=4)
def sequence_concat(x1, len1, x2, len2):
    """Concatenate two batched sequences row-wise along time (ref
    sequence_ops/sequence_concat_op.cc): row i = x1[i,:len1[i]] ++
    x2[i,:len2[i]], front-packed into [B, T1+T2, ...] with zero padding.
    Returns (concat, new_lengths)."""
    B, T1 = x1.shape[0], x1.shape[1]
    T2 = x2.shape[1]
    Tout = T1 + T2
    tail = tuple(x1.shape[2:])
    dev = x1.device
    out = torch.zeros((B, Tout) + tail, dtype=x1.dtype, device=dev)
    t1 = torch.arange(T1, device=dev)[None, :]
    t2 = torch.arange(T2, device=dev)[None, :]
    b1 = torch.arange(B, device=dev)[:, None].expand(B, T1)
    b2 = torch.arange(B, device=dev)[:, None].expand(B, T2)
    l1, l2 = len1[:, None].long(), len2[:, None].long()
    # invalid entries all land on slot Tout-1, zeroed by the lengths below
    pos1 = torch.where(t1 < l1, t1, Tout - 1)
    pos2 = torch.where(t2 < l2, l1 + t2, Tout - 1)
    m1 = (t1 < l1).reshape((B, T1) + (1,) * len(tail))
    m2 = (t2 < l2).reshape((B, T2) + (1,) * len(tail))
    zero = torch.zeros((), dtype=x1.dtype, device=dev)
    out = torch.index_put(out, (b1, pos1), torch.where(m1, x1, zero))
    out = torch.index_put(out, (b2, pos2), torch.where(m2, x2, zero),
                          accumulate=True)
    new_len = (len1 + len2).to(torch.int32)
    tt = torch.arange(Tout, device=dev)[None, :]
    keep = (tt < new_len[:, None]).reshape((B, Tout) + (1,) * len(tail))
    return torch.where(keep, out, zero), new_len


@def_op("sequence_erase", n_tensor_args=2, differentiable=False)
def sequence_erase(x, lengths, tokens=()):
    """Remove the given token ids from each row, front-packing survivors
    (ref sequence_ops/sequence_erase_op.cc). x: [B,T] int ids. Returns
    (erased [B,T] zero-padded, new_lengths [B])."""
    B, T = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    keep = t < lengths[:, None]
    for tok in tokens:
        keep = keep & (x != tok)
    new_pos = torch.cumsum(keep.long(), dim=1) - 1
    dest = torch.where(keep, new_pos, T - 1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.zeros_like(x).scatter_reduce(
        1, dest, torch.where(keep, x, zero), "amax")
    new_len = keep.sum(dim=1).to(torch.int32)
    return torch.where(t < new_len[:, None], out, zero), new_len


@def_op("sequence_enumerate", n_tensor_args=2, differentiable=False)
def sequence_enumerate(x, lengths, win_size=2, pad_value=0):
    """Sliding-window id enumeration (ref
    sequence_ops/sequence_enumerate_op.cc): out[b,t,k] = x[b,t+k] while
    t+k < length[b], else pad_value. x: [B,T] ids -> [B,T,win_size]."""
    B, T = x.shape
    t = torch.arange(T, device=x.device)[:, None]
    k = torch.arange(win_size, device=x.device)[None, :]
    src = torch.clamp(t + k, 0, T - 1)
    gathered = x[:, src]
    inb = (t + k)[None] < lengths[:, None, None]
    return torch.where(inb, gathered, torch.full(
        (), pad_value, dtype=x.dtype, device=x.device))


@def_op("sequence_topk_avg_pooling", n_tensor_args=2)
def sequence_topk_avg_pooling(x, lengths, topks=(1,)):
    """Average of the top-k values over each row's valid prefix, one output
    channel per k (ref sequence_ops/sequence_topk_avg_pooling_op.cc,
    simplified to the dense [B,T] case). Returns [B, len(topks)]."""
    T = x.shape[1]
    m = _mask(lengths, T, x.dtype)
    low = torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                     device=x.device)
    srt = torch.flip(torch.sort(torch.where(m > 0, x, low), dim=1).values,
                     (1,))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    t = torch.arange(T, device=x.device)[None, :]
    outs = []
    for k in topks:
        kk = torch.clamp(lengths, max=int(k)).to(x.dtype)
        s = torch.sum(torch.where(t < kk[:, None], srt, zero), dim=1)
        outs.append(s / torch.clamp(kk, min=1.0))
    return torch.stack(outs, dim=1)


@def_op("sequence_pad", n_tensor_args=3)
def sequence_pad_op(x, lengths, pad_value, maxlen=None):
    """ref sequence_ops/sequence_pad_op.cc: positions beyond each row's
    length become pad_value (T clipped or extended to maxlen). Returns
    (padded, lengths) like the ref op's (Out, Length)."""
    T = x.shape[1]
    if maxlen is not None and maxlen != T:
        if maxlen < T:
            x = x[:, :maxlen]
        else:
            pad = [0, 0] * (x.dim() - 2) + [0, maxlen - T]
            x = torch.nn.functional.pad(x, pad)
        T = maxlen
    m = _tail(x, _mask(lengths, T, x.dtype))
    pv = pad_value.to(x.dtype) if isinstance(pad_value, torch.Tensor) \
        else torch.full((), pad_value, dtype=x.dtype, device=x.device)
    return torch.where(m > 0, x, pv), lengths


@def_op("sequence_unpad", n_tensor_args=2)
def sequence_unpad_op(x, lengths):
    """ref sequence_ops/sequence_unpad_op.cc: the dense canonical form —
    data zeroed past each length."""
    return x * _tail(x, _mask(lengths, x.shape[1], x.dtype))


@def_op("sequence_reshape", n_tensor_args=2)
def sequence_reshape(x, lengths, new_dim=1):
    """ref sequence_ops/sequence_reshape_op.cc: refold each timestep row so
    the trailing dim becomes new_dim; lengths scale by D/new_dim."""
    B, T, D = x.shape
    out = x.reshape(B, T * D // new_dim, new_dim)
    return out, (lengths * D) // new_dim


@def_op("sequence_scatter", n_tensor_args=4, differentiable=False)
def sequence_scatter(x, index, updates, lengths):
    """ref sequence_ops/sequence_scatter_op.cc: per row b, add
    updates[b, j] into x[b, index[b, j]] for j < lengths[b]."""
    m = torch.arange(index.shape[1], device=x.device)[None, :] < \
        lengths[:, None]
    upd = torch.where(m.reshape(m.shape + (1,) * (updates.dim() - 2)),
                      updates, torch.zeros((), dtype=updates.dtype,
                                           device=x.device))
    bi = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        index.shape)
    return torch.index_put(x, (bi, index.long()), upd.to(x.dtype),
                           accumulate=True)


@def_op("sequence_expand_as", n_tensor_args=2)
def sequence_expand_as(x, lengths, maxlen=None):
    """ref sequence_ops/sequence_expand_as_op.cc: repeat row b of x
    lengths[b] times — [B, D] -> [B, Tmax, D], rows beyond the length
    zeroed. Without `maxlen`, Tmax is read from the lengths (a sync)."""
    T = int(maxlen) if maxlen is not None else int(lengths.max())
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    m = _mask(lengths, T, x.dtype).reshape(
        (x.shape[0], T) + (1,) * (x.dim() - 1))
    return out * m
