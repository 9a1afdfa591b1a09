"""Ring attention, sequence parallelism over the 'sp' mesh axis (the
port of `paddle_tpu/distributed/ring_attention.py`; PAPERS.md Ring
Attention, arXiv:2310.01889).

Every rank holds its shard of the sequence: q, k, v [B, H, S/n, D] (a
rank's part; the JAX functions take the global arrays and shard them
inside a shard_map). The forward keeps q and passes the K/V shards
around the group's ring (`collective.ring_exchange`: send to the next
rank, receive from the previous one, n - 1 hops); each block it holds is
one launch of K1 (`ops.flash_attention`'s forward: the hand-written
kernel on the card, its plain version on the CPU), and the blocks'
normalised outputs are merged by their logsumexp (`_merge`, the JAX
rule). Under `causal`, a past shard's block is unmasked, the diagonal
block is causal, and a future shard's block is skipped: rank r launches
r + 1 K1 a call.

The backward is a second ring pass, as in the JAX package: dd =
rowsum(dO * O) once (the dd kernel), then for every block K3 adds the
block's dQ and K2 computes its dK and dV from the GLOBAL lse and dd, so
each block's probabilities are the full softmax's. The dK/dV
accumulators (f32) travel with their K/V shards and are home after n
hops. Residuals are the rank's own q, k, v, out and lse.

Each shard must be a length the kernels take (`kernel_len`: a multiple
of 128); the CUDA kernels also take only head_dim 64 and raise for
anything else. Without an 'sp' axis (or one of size 1) it is
`flash_attention` itself (K1, and dd, K2, K3 in the backward).
"""
import math

import torch

from ..framework.tensor import Tensor, unwrap
from ..ops import flash_attention as fa
from . import collective
from . import mesh as mesh_mod


def _merge(o1, lse1, o2, lse2):
    """Combine two partial softmax results by their logsumexp (f32)."""
    if o1 is None:
        return o2.float(), lse2
    lse = torch.logaddexp(lse1, lse2)
    zero = torch.zeros((), device=lse.device)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - lse), zero)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - lse), zero)
    return o1 * w1[..., None] + o2.float() * w2[..., None], lse


def _impl(device):
    impl = fa.resolve_kernel(None, device)
    return "plain" if impl == "reference" else impl


def _check_shard(q, k):
    s = q.shape[-2]
    if s != fa.kernel_len(s) or k.shape[-2] != s:
        raise ValueError(
            f"ring attention: every block is one flash-attention kernel "
            f"call, which takes sequence shards of a multiple of 128; got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}")


def _sees(causal, src, me):
    """Whether the rank at `me` attends to shard `src` at all."""
    return not causal or src <= me


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, pg):
        n = collective.group_size(pg)
        me = collective.group_index(pg)
        impl = _impl(q.device)
        fwd = fa._IMPLS[impl][0]
        kv = torch.stack([k, v])
        o = lse = None
        for t in range(n):
            src = (me - t) % n
            if _sees(causal, src, me):
                ob, lb = fwd(q, kv[0], kv[1], causal and src == me, scale)
                o, lse = _merge(o, lse, ob, lb)
            if t < n - 1:
                kv = collective.ring_exchange([kv], [torch.empty_like(kv)],
                                              pg)[0]
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, pg, impl)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, pg, impl = ctx.args
        n = collective.group_size(pg)
        me = collective.group_index(pg)
        _, dkv_fn, dq_fn = fa._IMPLS[impl]
        if g.stride(-1) != 1 or not fa.tma_aligned(
                g.data_ptr(), fa._strides(g, False), g.element_size()):
            g = g.contiguous()
        dd = fa.row_dot(g, out, False, impl)
        kv = torch.stack([k, v])
        acc = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for t in range(n):
            src = (me - t) % n
            if _sees(causal, src, me):
                blk = causal and src == me
                dk, dv = dkv_fn(q, kv[0], kv[1], g, lse, dd, blk, scale)
                dq += dq_fn(q, kv[0], kv[1], g, lse, dd, blk, scale)
                acc[0] += dk
                acc[1] += dv
            # the accumulators travel with their shard: n hops home
            if t < n - 1:
                kv, acc = collective.ring_exchange(
                    [kv, acc], [torch.empty_like(kv), torch.empty_like(acc)],
                    pg)
            else:
                acc = collective.ring_exchange(
                    [acc], [torch.empty_like(acc)], pg)[0]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None)


def _group(axis_name, mesh):
    mesh = mesh or mesh_mod.get_mesh()
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return None
    return mesh.group(axis_name)


def ring_attention_shard(q, k, v, *, axis_name, causal, scale, mesh=None):
    """The ring over this rank's shards q, k, v [B, H, S/n, D] (torch
    tensors) along `axis_name`."""
    _check_shard(q, k)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    pg = _group(axis_name, mesh)
    if pg is None:
        return fa.flash_attention(q, k, v, causal=causal, scale=sc)
    return _Ring.apply(q, k, v, bool(causal), float(sc), pg)


def ring_attention(q, k, v, causal=False, scale=None,
                   axis_name=mesh_mod.SP_AXIS, mesh=None):
    """Ring attention over this rank's shards [B, H, S/n, D] (torch
    tensors) of the current mesh's `axis_name`; flash attention itself
    without such an axis."""
    if _group(axis_name, mesh) is None:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return ring_attention_shard(q, k, v, axis_name=axis_name,
                                causal=causal, scale=scale, mesh=mesh)


def ring_flash_attention(q, k, v, causal=False, scale=None,
                         axis_name=mesh_mod.SP_AXIS, mesh=None):
    """`ring_attention` on port Tensors (or torch tensors): the autograd
    of the result reaches q, k and v."""
    out = ring_attention(unwrap(q), unwrap(k), unwrap(v), causal=causal,
                         scale=scale, axis_name=axis_name, mesh=mesh)
    return Tensor._wrap(out) if isinstance(q, Tensor) else out
