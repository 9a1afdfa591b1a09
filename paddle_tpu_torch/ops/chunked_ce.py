"""Vocab-chunked fused LM head + softmax cross entropy (the port of
`paddle_tpu/ops/chunked_ce.py`).

The dense chain `logits = h @ w.T; cross_entropy(logits, labels)` holds
an [N, V] logits tensor in device memory, and its f32 softmax chain
beside it: 1.65 GB of bf16 logits at GPT-2 small's vocab 50304, batch 16
and seq 1024. `chunked_lm_loss` streams the vocab rows of `w` in chunks
of C instead: per chunk one [N, H] x [H, C] product feeds an online
max and sum of exponentials and the gather of each label's logit, so
only [N, C] ever exists. The backward recomputes each chunk's logits
from the saved h and lse (one more product per chunk, traded for never
holding a V-wide tensor), the JAX custom VJP's arithmetic:

  forward   m, l = online max / sum of exp over the chunks' f32 logits;
            lse = m + log(max(l, 1e-30));
            loss = sum over valid rows of (lse - label logit)
                   / max(#valid, 1)
  backward  dl = (exp(logits - lse) - onehot) * g / denom on valid rows;
            dh += dl @ w_chunk (f32); dw_chunk = dl^T @ h;
            dh cast to h's dtype, dw to w's; labels get none.

The ragged last chunk is a slice of `w`; the JAX version pads `w` and
masks the padded columns with -inf, which contributes nothing to the
max, the sum or the gather, so the two agree.

Precision. The chunk logits are f32: the product takes h and w in their
dtype and accumulates and returns f32, as the JAX `dot_general(...,
preferred_element_type=float32)` does. On the card that is one cuBLAS
product with an f32 output (`torch.mm(..., out_dtype=torch.float32)`);
on the CPU the operands are upcast to f32 first, which gives the same
exact products and f32 sums. A bf16 `matmul` would round the logits to
bf16 before the softmax, and an f32 product of bf16 operands runs on
the card's CUDA cores, about 10x slower. In the backward the f32
`dl` is rounded to h's dtype before its two products, so a bf16 model's
head gradient takes the same bf16 products as its dense backward; an
f32 model keeps f32 throughout.

These products are plain matrix products: the JAX package computes them
outside any Pallas kernel, so here they stay library products, and the
elementwise chunk pass stays torch ops. The extra memory is O(N C): a
few [N, C] f32 chunk buffers (268 MB each at N = 16384 and C = 4096).
Nothing is read back to the host (the denominator stays a device
tensor), so a CUDA graph captures the loss with its forward and
backward.

Over a vocabulary split on 'mp' (`vocab_parallel_chunked_lm_loss`: the
JAX package computes `chunked_lm_loss` on the tied table carrying its
Megatron vocab hint and GSPMD partitions it), each rank streams the
rows of its own vocab shard. Its running max is all-reduced (MAX over
the slice), then its sum of exponentials, rescaled to that max, and its
label logits (a label's logit is taken on the rank whose rows hold it,
zero elsewhere) in one SUM. The backward writes (softmax - onehot) x
scale for the rank's own columns and all-reduces dh over the slice: the
conjugate of `copy_to_mp`, so h comes in replicated. Neither the [N, V]
logits nor their V / mp shard ever exists.
"""
import torch

__all__ = ["chunked_lm_loss", "vocab_parallel_chunked_lm_loss"]


def _product(a, b):
    """a @ b with the operands in their dtype and an f32 result."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunks(v, chunk):
    return [(lo, min(lo + chunk, v)) for lo in range(0, v, chunk)]


class _ChunkedLMLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, chunk):
        labels = labels.long()
        m, s, lab_logit, _ = _local_pass(h, w, labels, chunk, 0)
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        valid = labels != ignore_index
        per = torch.where(valid, lse - lab_logit, 0.0)
        denom = torch.clamp(valid.sum().to(torch.float32), min=1.0)
        ctx.save_for_backward(h, w, labels, lse, denom)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return per.sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse, denom = ctx.saved_tensors
        valid = labels != ctx.ignore_index
        scale = (g / denom) * valid.to(torch.float32)           # [N]
        dh, dw = _local_grads(h, w, labels, lse, scale, ctx.chunk, 0)
        return dh.to(h.dtype), dw, None, None, None


def _local_pass(h, w, labels, chunk, start):
    """The chunked pass over vocab rows [start, start + V) held in `w`:
    (running max, sum of exp relative to it, each label's logit where
    the label lies in these rows (0 elsewhere), whether it does)."""
    n = h.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=h.device)
    s = torch.zeros(n, dtype=torch.float32, device=h.device)
    lab_logit = torch.zeros(n, dtype=torch.float32, device=h.device)
    for lo, hi in _chunks(w.shape[0], chunk):
        logits = _product(h, w[lo:hi].t())                  # [N, C] f32
        loc = labels - (start + lo)
        in_c = (loc >= 0) & (loc < hi - lo)
        got = logits.gather(1, loc.clamp(0, hi - lo - 1)[:, None])[:, 0]
        lab_logit = torch.where(in_c, got, lab_logit)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + \
            logits.sub_(m_new[:, None]).exp_().sum(dim=1)
        m = m_new
    loc = labels - start
    return m, s, lab_logit, (loc >= 0) & (loc < w.shape[0])


def _local_grads(h, w, labels, lse, scale, chunk, start):
    """dh (f32, this shard's part) and dw of the shard's rows: (softmax -
    onehot) x scale over its columns."""
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    for lo, hi in _chunks(w.shape[0], chunk):
        wc = w[lo:hi]
        dl = _product(h, wc.t()).sub_(lse[:, None]).exp_()      # softmax
        loc = labels - (start + lo)
        in_c = (loc >= 0) & (loc < hi - lo)
        col = loc.clamp(0, hi - lo - 1)[:, None]
        at = dl.gather(1, col)
        dl.mul_(scale[:, None])
        dl.scatter_(1, col, torch.where(in_c[:, None], at - 1.0, at)
                    * scale[:, None])
        dl = dl.to(h.dtype)
        dh += _product(dl, wc)
        dw[lo:hi] = _product(dl.t(), h)
    return dh, dw


class _VocabParallelChunkedLMLoss(torch.autograd.Function):
    """`_ChunkedLMLoss` over the rank's vocab shard `w` (rows [rank V_l,
    (rank + 1) V_l) of the table) of an 'mp' slice (`group`, an
    `MPGroup`)."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, chunk, group):
        from ..distributed.collective import ReduceOp, all_reduce_
        labels = labels.long()
        start = group.rank * w.shape[0]
        m, s, lab_logit, mine = _local_pass(h, w, labels, chunk, start)
        big = m.clone()
        all_reduce_(big, ReduceOp.MAX, group.pg)
        both = torch.stack([s * torch.exp(m - big),
                            torch.where(mine, lab_logit, 0.0)])
        all_reduce_(both, ReduceOp.SUM, group.pg)
        lse = big + torch.log(torch.clamp(both[0], min=1e-30))
        valid = labels != ignore_index
        per = torch.where(valid, lse - both[1], 0.0)
        denom = torch.clamp(valid.sum().to(torch.float32), min=1.0)
        ctx.save_for_backward(h, w, labels, lse, denom)
        ctx.ignore_index, ctx.chunk, ctx.group = ignore_index, chunk, group
        return per.sum() / denom

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import ReduceOp, all_reduce_
        h, w, labels, lse, denom = ctx.saved_tensors
        group = ctx.group
        valid = labels != ctx.ignore_index
        scale = (g / denom) * valid.to(torch.float32)
        dh, dw = _local_grads(h, w, labels, lse, scale, ctx.chunk,
                              group.rank * w.shape[0])
        all_reduce_(dh, ReduceOp.SUM, group.pg)
        return dh.to(h.dtype), dw, None, None, None, None


def vocab_parallel_chunked_lm_loss(h, w, labels, group, ignore_index=-1,
                                   chunk=4096):
    """`chunked_lm_loss` over a vocabulary split on 'mp': `w` [V / mp, H]
    is this rank's rows of the table (rank r holds rows [r V / mp, (r +
    1) V / mp)), `labels` index the whole vocabulary, `h` is the same on
    every rank of `group` (an `MPGroup`). Returns the mean cross entropy
    over the whole vocabulary on every rank; dh is summed over the slice
    in the backward."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"vocab_parallel_chunked_lm_loss: h "
                         f"{tuple(h.shape)} and w {tuple(w.shape)} need to "
                         f"be [N, H] and [V / mp, H]")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"vocab_parallel_chunked_lm_loss: labels "
                         f"{tuple(labels.shape)} need to be [{h.shape[0]}]")
    if chunk < 1:
        raise ValueError(f"vocab_parallel_chunked_lm_loss: chunk {chunk} < 1")
    return _VocabParallelChunkedLMLoss.apply(h, w, labels, int(ignore_index),
                                             int(chunk), group)


def chunked_lm_loss(h, w, labels, ignore_index=-1, chunk=4096):
    """Mean cross entropy of softmax(h @ w.T) against `labels`, streaming
    the rows of `w` in chunks of `chunk`.

    h: [N, H] hidden states; w: [V, H] (the tied embedding's layout);
    labels: [N] integers, rows equal to `ignore_index` left out of the
    mean. Differentiable in h and w."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"chunked_lm_loss: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)} need to be [N, H] and [V, H]")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"chunked_lm_loss: labels {tuple(labels.shape)} "
                         f"need to be [{h.shape[0]}]")
    if chunk < 1:
        raise ValueError(f"chunked_lm_loss: chunk {chunk} < 1")
    return _ChunkedLMLoss.apply(h, w, labels, int(ignore_index), int(chunk))
