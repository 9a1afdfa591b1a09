"""Sampling for generation and serving: the port's own copy of
`top_k_top_p_filtering` from `paddle_tpu/nn/decode.py`, and the Gumbel
noise the samplers add to filtered logits."""
import torch

_NEG_INF = -1e9


def top_k_top_p_filtering(logits, top_k=0, top_p=1.0):
    """Mask logits outside top-k / nucleus top-p to -1e9, in f32. Top-k
    keeps every logit >= the kth largest; top-p keeps the smallest
    prefix of the sorted row whose cumulative probability reaches p (the
    best token always kept)."""
    a = logits.float()
    neg = torch.full((), _NEG_INF, device=a.device)
    if top_k and top_k > 0:
        kth = torch.topk(a, min(int(top_k), a.shape[-1]), dim=-1).values
        a = torch.where(a < kth[..., -1:], neg, a)
    if top_p is not None and top_p < 1.0:
        sort_idx = torch.argsort(-a, dim=-1, stable=True)
        sorted_a = torch.gather(a, -1, sort_idx)
        probs = torch.softmax(sorted_a, dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        keep_sorted[..., 0] = True
        keep = torch.gather(keep_sorted, -1,
                            torch.argsort(sort_idx, dim=-1))
        a = torch.where(keep, a, neg)
    return a


def gumbel_(buf, gen):
    """Fill `buf` in place with Gumbel(0, 1) noise from `gen`: torch.rand's
    uniform draw, then -log(-log(u))."""
    buf.uniform_(0, 1, generator=gen)
    tiny = torch.finfo(torch.float32).tiny
    return buf.clamp_(min=tiny).log_().neg_().log_().neg_()
