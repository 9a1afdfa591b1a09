"""Ulysses sequence parallelism, all-to-all head redistribution (the
port of `paddle_tpu/distributed/ulysses.py`; PAPERS.md DeepSpeed-Ulysses,
arXiv:2309.14509).

Every rank holds its shard of the sequence, q, k, v [B, H, S/n, D]. One
all-to-all over the 'sp' group turns the three, stacked, into
[B, H/n, S, D] (the rank's group of heads over the whole sequence), K1
runs on that head shard (`ops.flash_attention`, with dd, K2 and K3 in
the backward), and a second all-to-all turns the output back into
[B, H, S/n, D]. Each all-to-all is a `torch.autograd.Function` whose
backward is the reverse all-to-all. Two collectives a call instead of
the ring's n hops, for holding S x H/n activations; the head count must
divide over the group. Without an 'sp' axis it is `flash_attention`
itself.
"""
import torch

from ..framework.tensor import Tensor, unwrap
from ..ops import flash_attention as fa
from . import collective
from . import mesh as mesh_mod


def _seq_to_head(x, pg):
    """[..., H, S/n, D] -> [..., H/n, S, D]: rank i keeps head group i of
    every rank's sequence shard."""
    n = collective.group_size(pg)
    *lead, h, s, d = x.shape
    nl = len(lead)
    xs = x.reshape(*lead, n, h // n, s, d).movedim(nl, 0).contiguous()
    out = torch.empty_like(xs)
    collective.all_to_all_into(out, xs, pg)
    return out.movedim(0, nl + 1).reshape(*lead, h // n, n * s, d)


def _head_to_seq(y, pg):
    """[..., H/n, S, D] -> [..., H, S/n, D], the inverse of
    `_seq_to_head`."""
    n = collective.group_size(pg)
    *lead, hn, big_s, d = y.shape
    nl = len(lead)
    s = big_s // n
    ys = y.reshape(*lead, hn, n, s, d).movedim(nl + 1, 0).contiguous()
    out = torch.empty_like(ys)
    collective.all_to_all_into(out, ys, pg)
    return out.movedim(0, nl).reshape(*lead, n * hn, s, d)


class _SeqToHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _seq_to_head(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g.contiguous(), ctx.pg), None


class _HeadToSeq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, pg):
        ctx.pg = pg
        return _head_to_seq(y, pg)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g.contiguous(), ctx.pg), None


def ulysses_attention_shard(q, k, v, *, axis_name, causal, scale,
                            mesh=None):
    """Ulysses over this rank's shards q, k, v [B, H, S/n, D] (torch
    tensors) along `axis_name`; H must divide by n."""
    mesh = mesh or mesh_mod.get_mesh()
    pg = mesh.group(axis_name)
    n = collective.group_size(pg)
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(f"num_heads {h} not divisible by sp={n} (use ring "
                         "attention for head counts below the sp degree)")
    qkv = _SeqToHead.apply(torch.stack([q, k, v]), pg)
    out = fa.flash_attention(qkv[0], qkv[1], qkv[2], causal=causal,
                             scale=scale)
    return _HeadToSeq.apply(out, pg)


def ulysses_attention(q, k, v, causal=False, scale=None,
                      axis_name=mesh_mod.SP_AXIS, mesh=None):
    """Ulysses attention over this rank's shards [B, H, S/n, D] (torch
    tensors) of the current mesh's `axis_name`; flash attention itself
    without such an axis."""
    mesh = mesh or mesh_mod.get_mesh()
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return ulysses_attention_shard(q, k, v, axis_name=axis_name,
                                   causal=causal, scale=scale, mesh=mesh)


def ulysses_flash_attention(q, k, v, causal=False, scale=None,
                            axis_name=mesh_mod.SP_AXIS, mesh=None):
    """`ulysses_attention` on port Tensors (or torch tensors): the
    autograd of the result reaches q, k and v."""
    out = ulysses_attention(unwrap(q), unwrap(k), unwrap(v), causal=causal,
                            scale=scale, axis_name=axis_name, mesh=mesh)
    return Tensor._wrap(out) if isinstance(q, Tensor) else out
