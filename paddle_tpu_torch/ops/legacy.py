"""The legacy operator tail (the port of `paddle_tpu/ops/legacy.py`):
registered op types of the reference's fluid-era surface that have no
paddle-2.x wrapper but are real, distinct computations (ref
paddle/fluid/operators/*.cc; per-op citations below).

Every op is a raw torch form in OP_REGISTRY, run by the eager dispatcher
where its inputs are. The ops that loop over a sequence or a tree
(`linear_chain_crf`, `crf_decoding`, `edit_distance`, `chunk_eval`,
`ctc_align`, `tree_conv`) are loops of whole-batch tensor ops: none
reads the device from the host, where the JAX package runs `chunk_eval`,
`ctc_align` and `tree_conv`'s patch weights in numpy. `segment_pool`
without `num_segments` reads the last id to size its output, as the JAX
package does. The hashes (`hash_op`, `pyramid_hash`) compute the JAX
package's uint32 mix in int64 masked to 32 bits, so their bucket ids
are the JAX package's bit for bit. The random creators draw from the
framework generator (`framework.state.rng_generator`), so their values
differ from the JAX package's draws.

Left out: `spectral_norm_op`'s desc migration (op version 2; the JAX
package's `register_op_migration`): the port has no static desc until
ROADMAP Queue 1 item 7.
"""
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework import state
from ..framework.tensor import Tensor
from .dispatch import apply, def_op, register_op

_MASK32 = 0xFFFFFFFF


def _long(i):
    return i.reshape(-1).long()


# ------------------------------------------------------------------ losses

@def_op("huber_loss", n_tensor_args=2)
def huber_loss(x, y, delta=1.0):
    """True Huber loss (ref operators/huber_loss_op.cc HuberLossForward):
    0.5 z^2 for |z| <= delta else delta*(|z| - 0.5 delta)."""
    z = torch.abs(y - x)
    return torch.where(z <= delta, 0.5 * z * z, delta * (z - 0.5 * delta))


@def_op("rank_loss", n_tensor_args=3)
def rank_loss(label, left, right):
    """Pairwise RankNet loss (ref operators/rank_loss_op.cc): the sigmoid
    cross-entropy on the score difference, computed stably."""
    d = left - right
    return torch.clamp(d, min=0) - label * d + \
        torch.log1p(torch.exp(-torch.abs(d)))


@def_op("bpr_loss", n_tensor_args=2)
def bpr_loss(x, label):
    """Bayesian Personalized Ranking loss (ref operators/bpr_loss_op.cc):
    per row, -mean_{j != label} log sigmoid(x[label] - x[j]). x: [B, C],
    label: [B] int. Returns [B, 1]."""
    B, C = x.shape
    lab = _long(label)
    pos = torch.gather(x, 1, lab[:, None])
    lose = TF.softplus(-(pos - x))
    mask = torch.arange(C, device=x.device)[None, :] != lab[:, None]
    s = torch.sum(torch.where(mask, lose, torch.zeros_like(lose)), dim=1,
                  keepdim=True)
    return s / max(C - 1, 1)


@def_op("hinge_loss", n_tensor_args=2)
def hinge_loss(logits, labels):
    """ref operators/hinge_loss_op.cc: max(0, 1 - (2*label - 1) * pred)."""
    return torch.clamp(1.0 - (2.0 * labels - 1.0) * logits, min=0.0)


@def_op("center_loss", n_tensor_args=3, differentiable=True)
def center_loss(x, label, centers, alpha=0.1, need_update=True):
    """Center loss (ref operators/center_loss_op.cc): per-sample squared
    distance to its class center, and the alpha-step center update
    (class-count normalised). Returns (loss [B, 1], centers_out); the
    update carries no gradient."""
    lab = _long(label)
    diff = x - centers[lab]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if not need_update:
        return loss, centers
    n = centers.shape[0]
    counts = torch.zeros((n,), dtype=x.dtype, device=x.device).index_add(
        0, lab, torch.ones_like(lab, dtype=x.dtype))
    delta = torch.zeros_like(centers).index_add(0, lab, diff)
    centers_out = centers + alpha * delta / (1.0 + counts)[:, None]
    return loss, centers_out.detach()


@def_op("cos_sim", n_tensor_args=2)
def cos_sim(x, y, eps=1e-8):
    """Row-wise cosine similarity with a batch-1 y broadcast (ref
    operators/cos_sim_op.cc). x: [B, D], y: [B, D] or [1, D] -> [B, 1]."""
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    num = torch.sum(x * y, dim=1, keepdim=True)
    return num / torch.clamp(xn * yn, min=eps)


@def_op("squared_l2_norm")
def squared_l2_norm(x):
    """ref operators/squared_l2_norm_op.cc; shape [1]."""
    return torch.sum(x * x).reshape(1)


@def_op("l1_norm")
def l1_norm(x):
    """ref operators/l1_norm_op.cc; shape [1]."""
    return torch.sum(torch.abs(x)).reshape(1)


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


@def_op("frobenius_norm")
def frobenius_norm(x, axis=None, keepdim=False):
    """ref operators/reduce_ops/frobenius_norm_op.cc."""
    return torch.sqrt(torch.sum(x * x, dim=_dims(axis, x.dim()),
                                keepdim=keepdim))


@def_op("p_norm")
def p_norm(x, porder=2.0, axis=-1, keepdim=False, epsilon=1e-12):
    """ref operators/p_norm_op.cc: vector p-norm along one axis, with
    epsilon inside the root."""
    if porder == float("inf"):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if porder == float("-inf"):
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    s = torch.sum(torch.abs(x) ** porder, dim=axis, keepdim=keepdim)
    return (s + epsilon) ** (1.0 / porder)


@def_op("nce_loss", n_tensor_args=5)
def nce_loss(x, weight, bias, label, sample_ids):
    """Noise-contrastive estimation with caller-supplied negatives (ref
    operators/nce_op.cc, CustomDist path). x: [B, D], weight: [V, D],
    bias: [V], label: [B], sample_ids: [K]. Returns [B, 1]."""
    lab, ids = _long(label), _long(sample_ids)
    s_pos = torch.sum(x * weight[lab], dim=1) + bias[lab]
    s_neg = x @ weight[ids].T + bias[ids][None, :]
    loss = TF.softplus(-s_pos) + torch.sum(TF.softplus(s_neg), dim=1)
    return loss[:, None]


@def_op("linear_chain_crf", n_tensor_args=4)
def linear_chain_crf(emission, transition, label, lengths):
    """Linear-chain CRF negative log-likelihood over padded batches (ref
    operators/linear_chain_crf_op.cc, the forward algorithm): one loop
    over the time axis, the whole batch a step, a length mask.

    emission: [B, T, N]; transition: [N+2, N] (row 0 start, row 1 stop,
    rows 2.. w[from, to]); label: [B, T] int; lengths: [B].
    Returns nll [B, 1] = log Z - score(gold path)."""
    B, T, N = emission.shape
    start, stop, w = transition[0], transition[1], transition[2:]
    lab = label.long()
    lengths = lengths.reshape(-1).long()
    alpha = start[None, :] + emission[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) + \
            emission[:, t]
        alpha = torch.where((t < lengths)[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    t_idx = torch.arange(T, device=emission.device)[None, :]
    valid = t_idx < lengths[:, None]
    em = torch.gather(emission, 2, lab[:, :, None])[..., 0]
    em_score = torch.sum(torch.where(valid, em, torch.zeros_like(em)), 1)
    trans = w[lab[:, :-1], lab[:, 1:]]
    pair_valid = t_idx[:, 1:] < lengths[:, None]
    tr_score = torch.sum(torch.where(pair_valid, trans,
                                     torch.zeros_like(trans)), 1)
    last = torch.gather(lab, 1, torch.clamp(lengths - 1, min=0)[:, None])
    gold = start[lab[:, 0]] + em_score + tr_score + stop[last[:, 0]]
    return (log_z - gold)[:, None]


# ------------------------------------------------------- legacy tensor ops

@def_op("mul", n_tensor_args=2)
def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The fluid-era `mul` op (ref operators/mul_op.cc): x flattened to
    [prod(front dims), prod(back)], y likewise, matmul, the front/back
    dims restored."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    xm = x.reshape(int(np.prod(xs[:x_num_col_dims])), -1)
    ym = y.reshape(int(np.prod(ys[:y_num_col_dims])), -1)
    return (xm @ ym).reshape(xs[:x_num_col_dims] + ys[y_num_col_dims:])


def _multiplex_raw(index, *candidates):
    """ref operators/multiplex_op.cc: out[i] = candidates[index[i]][i]."""
    stacked = torch.stack(candidates, dim=0)                # [K, B, ...]
    idx = _long(index).reshape((1, -1) + (1,) * (stacked.dim() - 2))
    return torch.gather(stacked, 0, idx.expand(
        (1,) + tuple(stacked.shape[1:])))[0]


register_op("multiplex", _multiplex_raw)


def multiplex(inputs, index, name=None):
    return apply(_multiplex_raw, (index, *inputs), name="multiplex")


@def_op("segment_pool", n_tensor_args=2)
def segment_pool(x, segment_ids, pool_type="SUM", num_segments=None):
    """ref operators/segment_pool_op.cc: pool rows of x by non-decreasing
    segment_ids. Without num_segments it is ids[-1] + 1, read from the
    device. Empty segments are 0."""
    if num_segments is None:
        num_segments = int(segment_ids[-1]) + 1
    pt = pool_type.upper()
    ids = segment_ids.reshape(-1).long()
    shape = (num_segments,) + tuple(x.shape[1:])
    counts = torch.zeros((num_segments,), dtype=x.dtype,
                         device=x.device).index_add(
        0, ids, torch.ones(ids.shape, dtype=x.dtype, device=x.device))
    bshape = (num_segments,) + (1,) * (x.dim() - 1)
    if pt in ("SUM", "MEAN"):
        s = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add(
            0, ids, x)
        if pt == "SUM":
            return s
        return s / torch.clamp(counts, min=1.0).reshape(bshape)
    if pt in ("MAX", "MIN"):
        idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out = out.scatter_reduce(0, idx, x, "amax" if pt == "MAX" else "amin",
                                 include_self=False)
        return torch.where((counts > 0).reshape(bshape), out,
                           torch.zeros_like(out))
    raise ValueError(f"unknown pool_type {pool_type}")


@def_op("cvm", n_tensor_args=2)
def cvm(x, cvm_in, use_cvm=True):
    """Continuous-value-model feature op (ref operators/cvm_op.cc): the
    first two columns (show, click) become (log(show+1),
    log(click+1) - log(show+1)) with use_cvm, else are stripped."""
    show = torch.log(cvm_in[:, 0:1] + 1.0)
    click = torch.log(cvm_in[:, 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, x[:, 2:]], dim=1)
    return x[:, 2:]


@def_op("data_norm", n_tensor_args=4)
def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """ref operators/data_norm_op.cc: normalise with accumulated global
    statistics: mean = sum/size, scale = sqrt(size/square_sum)."""
    mean = batch_sum / batch_size
    scale = torch.sqrt(batch_size / (batch_square_sum + epsilon))
    return (x - mean[None, :]) * scale[None, :]


@def_op("shuffle_batch", n_tensor_args=1, differentiable=True)
def shuffle_batch(x, seed=0):
    """ref operators/shuffle_batch_op.cc: a batch permutation; seed 0
    draws from the framework generator, another seed from a generator
    seeded with it."""
    if seed:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
    else:
        gen = state.rng_generator(x.device)
    perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
    return x[perm]


@def_op("im2sequence", n_tensor_args=1)
def im2sequence(x, kernels=(1, 1), strides=(1, 1), paddings=(0, 0)):
    """ref operators/im2sequence_op.cc: one row per kernel position over
    NCHW images -> [B*OH*OW, C*kh*kw]."""
    kh, kw = kernels
    if len(paddings) == 4:                     # (up, left, down, right)
        pu, pl, pd_, pr = paddings
    else:
        pu, pl = paddings
        pd_, pr = pu, pl
    xp = TF.pad(x, (pl, pr, pu, pd_))
    cols = TF.unfold(xp, (kh, kw), stride=tuple(strides))  # [B, F, L]
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


@def_op("row_conv", n_tensor_args=2)
def row_conv(x, wt):
    """Lookahead row convolution (ref operators/row_conv_op.cc):
    y[b, t] = sum_{i<k} x[b, t+i] * wt[i], zero past the end.
    x: [B, T, D], wt: [k, D]."""
    k, T = wt.shape[0], x.shape[1]
    xp = TF.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + T] * wt[i][None, None, :]
    return out


@def_op("conv_shift", n_tensor_args=2)
def conv_shift(x, y):
    """Circular correlation (ref operators/conv_shift_op.cc):
    out[b, i] = sum_j x[b, (i + j - M//2) mod N] * y[b, j]."""
    N, M = x.shape[1], y.shape[1]
    dev = x.device
    idx = (torch.arange(N, device=dev)[:, None]
           + torch.arange(M, device=dev)[None, :] - M // 2) % N
    return torch.sum(x[:, idx] * y[:, None, :], dim=2)


@def_op("fsp", n_tensor_args=2)
def fsp(x, y):
    """FSP matrix for distillation (ref operators/fsp_op.cc):
    [B,C1,H,W] x [B,C2,H,W] -> [B,C1,C2] over H*W."""
    h, w = x.shape[2], x.shape[3]
    return torch.einsum("bchw,bdhw->bcd", x, y) / (h * w)


def _increment_raw(x, step=1.0):
    """ref operators/increment_op.cc (the loop-counter op): `step` cast
    to x's dtype first."""
    return x + torch.tensor(step, dtype=x.dtype).item()


register_op("increment", _increment_raw)


def increment(x, value=1.0):
    return apply(_increment_raw, (x,), {"step": float(value)},
                 name="increment")


@def_op("expand_as_v2", n_tensor_args=2)
def expand_as_v2(x, y):
    """ref operators/expand_as_v2_op.cc: x broadcast to y's shape."""
    return torch.broadcast_to(x, y.shape)


@def_op("reverse")
def reverse(x, axis=0):
    """ref operators/reverse_op.cc (a flip over a list of axes)."""
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, dims=[int(a) for a in axes])


# -------------------------------------------- 1.x elementwise w/ axis attr

def _axis_broadcast(x, y, axis):
    """Paddle 1.x elementwise broadcast (ref operators/elementwise/
    elementwise_op_function.h GetMidDims): y's dims align to x from
    `axis` (-1: trailing alignment), y's trailing size-1 dims trimmed."""
    if axis == -1 or axis is None:
        return y
    shape = tuple(y.shape)
    while shape and shape[-1] == 1:
        shape = shape[:-1]
    trail = x.dim() - axis - len(shape)
    if trail < 0:
        raise ValueError(
            f"elementwise axis={axis} invalid for x.ndim={x.dim()}, "
            f"y.ndim={len(shape)} (after trailing-1 trim)")
    return y.reshape((1,) * axis + shape + (1,) * trail)


def _make_elementwise(opname, fn):
    def raw(x, y, axis=-1):
        return fn(x, _axis_broadcast(x, y, axis))
    raw.__name__ = opname
    raw.__doc__ = (f"ref operators/elementwise/{opname}_op.cc: a binary op "
                   "with the 1.x mid-dim `axis` broadcast attr.")
    register_op(opname, raw)
    return raw


elementwise_add = _make_elementwise("elementwise_add", lambda a, b: a + b)
elementwise_sub = _make_elementwise("elementwise_sub", lambda a, b: a - b)
elementwise_mul = _make_elementwise("elementwise_mul", lambda a, b: a * b)
elementwise_div = _make_elementwise("elementwise_div", lambda a, b: a / b)
elementwise_max = _make_elementwise("elementwise_max", torch.maximum)
elementwise_min = _make_elementwise("elementwise_min", torch.minimum)
elementwise_pow = _make_elementwise("elementwise_pow", lambda a, b: a ** b)
elementwise_mod = _make_elementwise("elementwise_mod", torch.remainder)


# ------------------------------------------------------- search / decode

@def_op("crf_decoding", n_tensor_args=3, differentiable=False)
def crf_decoding(emission, transition, lengths):
    """Viterbi decode over linear_chain_crf's transition layout (ref
    operators/crf_decoding_op.h): rows 0/1 start/stop, 2.. the pairwise
    matrix. emission: [B, T, N], lengths: [B]. Returns the best path
    [B, T] int32 (0 past each length)."""
    B, T, N = emission.shape
    start, stop, w = transition[0], transition[1], transition[2:]
    lengths = lengths.reshape(-1).long()
    dev = emission.device
    ident = torch.arange(N, device=dev)[None, :].expand(B, N)
    alpha = start[None, :] + emission[:, 0]
    back = []
    for t in range(1, T):
        best, arg = torch.max(alpha[:, :, None] + w[None, :, :], dim=1)
        live = (t < lengths)[:, None]
        alpha = torch.where(live, best + emission[:, t], alpha)
        back.append(torch.where(live, arg, ident))
    cur = torch.argmax(alpha + stop[None, :], dim=1)
    path = [cur]
    for bp in reversed(back):
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)                       # [B, T]
    t_idx = torch.arange(T, device=dev)[None, :]
    return torch.where(t_idx < lengths[:, None], path,
                       torch.zeros_like(path)).to(torch.int32)


@def_op("beam_search", n_tensor_args=3, differentiable=False)
def beam_search(pre_ids, pre_scores, probs, beam_size=4, end_id=0):
    """One beam-search step on dense [B, W, V] scores (ref
    operators/beam_search_op.h): the top `beam_size` continuations per
    row from W*V candidates; a finished beam (pre_id == end_id) continues
    only with end_id at its old score. Returns (selected_ids [B, W'],
    selected_scores [B, W'], parent_idx [B, W'])."""
    B, W, V = probs.shape
    total = pre_scores[:, :, None] + torch.log(torch.clamp(probs,
                                                           min=1e-20))
    finished = pre_ids == end_id
    neg = torch.finfo(total.dtype).min
    keep_end = torch.arange(V, device=probs.device) == end_id
    held = torch.where(keep_end[None, None, :],
                       pre_scores[:, :, None].expand(B, W, V),
                       torch.full_like(total, neg))
    total = torch.where(finished[:, :, None], held, total)
    top_scores, top_idx = torch.topk(total.reshape(B, W * V), beam_size,
                                     dim=1)
    parent = torch.div(top_idx, V, rounding_mode="floor").to(torch.int32)
    return (top_idx % V).to(torch.int32), top_scores, parent


@def_op("sample_logits", n_tensor_args=3, differentiable=False)
def sample_logits(logits, labels, samples, remove_accidental_hits=True):
    """The true and the sampled-negative logits (ref
    operators/sample_logits_op.cc, caller-supplied samples). logits:
    [B, V], labels: [B, 1], samples: [S] -> [B, 1+S]; a sampled id equal
    to the row's label is pushed to -1e20."""
    lab = _long(labels)
    samples = samples.reshape(-1).long()
    true_logit = torch.gather(logits, 1, lab[:, None])
    samp = logits[:, samples]
    if remove_accidental_hits:
        hit = samples[None, :] == lab[:, None]
        samp = torch.where(hit, torch.full_like(samp, -1e20), samp)
    return torch.cat([true_logit, samp], dim=1)


# ------------------------------------------------------------- metric ops

@def_op("auc", n_tensor_args=4, differentiable=False)
def auc(predict, label, stat_pos, stat_neg, num_thresholds=4095):
    """Streaming AUC (ref operators/metrics/auc_op.cc): bucket the
    positive-class probability, add the pos/neg histograms to the running
    stats. Returns (auc, stat_pos_out, stat_neg_out)."""
    p = predict[:, -1] if predict.dim() == 2 else predict.reshape(-1)
    buck = torch.clamp((p * num_thresholds).to(torch.int32), 0,
                       num_thresholds).long()
    y = label.reshape(-1).to(torch.int32)
    pos = stat_pos + torch.zeros_like(stat_pos).index_add(
        0, buck, (y == 1).to(stat_pos.dtype))
    neg = stat_neg + torch.zeros_like(stat_neg).index_add(
        0, buck, (y == 0).to(stat_neg.dtype))
    total = torch.sum(pos)
    area = torch.sum(neg * (total - torch.cumsum(pos, 0) + 0.5 * pos))
    denom = torch.clamp(total * torch.sum(neg), min=1.0)
    return area / denom, pos, neg


_ARITY = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _chunk_bounds(tags, lengths, num_chunk_types, scheme):
    """(starts, ends-of-each-start, types) of the chunks of every row,
    [B, T] each: starts[b, t] whether a chunk starts at t, next_end its
    last position, types the chunk type there. The rules of the
    reference's sequential walk, as whole-row tensor ops: a chunk is open
    entering t when t - 1 was in a chunk that did not close there (E or
    S); it starts at t on B (IOB, IOBES) or S, when none is open, or
    when the type changes; it ends where it closes or the next position
    does not continue it."""
    arity = _ARITY[scheme]
    B, T = tags.shape
    dev = tags.device
    t_idx = torch.arange(T, device=dev)[None, :]
    tags = tags.long()
    valid = (t_idx < lengths[:, None]) & (tags >= 0) & \
        (tags < num_chunk_types * arity)
    ty = torch.where(valid, torch.div(tags, arity, rounding_mode="floor"),
                     torch.full_like(tags, -1))
    kind = tags % arity
    if scheme == "IOE":
        closes = valid & (kind == 1)
    elif scheme == "IOBES":
        closes = valid & ((kind == 2) | (kind == 3))
    else:
        closes = torch.zeros_like(valid)
    false = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    open_prev = torch.cat([false, (valid & ~closes)[:, :-1]], dim=1)
    ty_prev = torch.cat([torch.full((B, 1), -1, device=dev,
                                    dtype=ty.dtype), ty[:, :-1]], dim=1)
    new = ~open_prev | (ty_prev != ty)
    if scheme == "IOB":
        new = new | (kind == 0)
    elif scheme == "IOBES":
        new = new | (kind == 0) | (kind == 3)
    starts = valid & new
    after = torch.cat([starts[:, 1:], false], dim=1)
    valid_next = torch.cat([valid[:, 1:], false], dim=1)
    ends = valid & (closes | ~valid_next | after)
    end_at = torch.where(ends, t_idx.expand(B, T), torch.full_like(tags, T))
    next_end = torch.flip(torch.cummin(torch.flip(end_at, [1]), 1).values,
                          [1])
    return starts, next_end, ty


@def_op("chunk_eval", n_tensor_args=3, differentiable=False)
def chunk_eval(inference, label, lengths, num_chunk_types=1,
               chunk_scheme="IOB"):
    """Chunking precision/recall/F1 (ref operators/metrics/chunk_eval_op.cc).
    Tags follow the reference's encoding: IOB tag = type*2 + {B:0, I:1};
    IOE {I:0, E:1}; IOBES type*4 + {B,I,E,S}; plain tag = type; a tag
    >= num_chunk_types * arity is 'outside'. A predicted chunk is correct
    when a label chunk has its start, end and type. Returns (precision,
    recall, f1, num_infer, num_label, num_correct)."""
    lens = lengths.reshape(-1).long()
    si, ei, ti = _chunk_bounds(inference, lens, num_chunk_types,
                               chunk_scheme)
    sl, el, tl = _chunk_bounds(label, lens, num_chunk_types, chunk_scheme)
    n_inf = si.sum()
    n_lab = sl.sum()
    n_cor = (si & sl & (ei == el) & (ti == tl)).sum()
    fi, fl, fc = (n.double() for n in (n_inf, n_lab, n_cor))
    zero = torch.zeros((), dtype=torch.float64, device=fi.device)
    prec = torch.where(fi > 0, fc / torch.clamp(fi, min=1), zero)
    rec = torch.where(fl > 0, fc / torch.clamp(fl, min=1), zero)
    both = prec + rec
    f1 = torch.where(both > 0, 2 * prec * rec / torch.clamp(both,
                                                            min=1e-300),
                     zero)
    f = torch.float32
    return (prec.to(f), rec.to(f), f1.to(f), n_inf.to(torch.int32),
            n_lab.to(torch.int32), n_cor.to(torch.int32))


@def_op("positive_negative_pair", n_tensor_args=3, differentiable=False)
def positive_negative_pair(score, label, query_id):
    """Ranking pair statistics per query (ref operators/
    positive_negative_pair_op.cc): over same-query pairs with different
    labels, the concordant, discordant and tied score pairs. Returns
    (positive, negative, neutral) f32 scalars."""
    s, l, q = score.reshape(-1), label.reshape(-1), query_id.reshape(-1)
    n = s.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    valid = (q[:, None] == q[None, :]) & upper & (l[:, None] != l[None, :])
    s_diff = s[:, None] - s[None, :]
    concord = torch.where(l[:, None] > l[None, :], s_diff > 0, s_diff < 0)
    tied = s_diff == 0
    f = torch.float32
    return ((valid & ~tied & concord).sum().to(f),
            (valid & ~tied & ~concord).sum().to(f), (valid & tied).sum().to(f))


# ------------------------------------------------------------ misc tensor

@def_op("partial_sum", n_tensor_args=None)
def _partial_sum_impl(*inputs, start_index=0, length=-1):
    """ref operators/partial_sum_op.cc: the sum of each input's
    [:, start:start+length]."""
    L = inputs[0].shape[1] - start_index if length == -1 else length
    acc = None
    for t in inputs:
        sl = t[:, start_index:start_index + L]
        acc = sl if acc is None else acc + sl
    return acc


@def_op("partial_concat", n_tensor_args=None)
def _partial_concat_impl(*inputs, start_index=0, length=-1):
    """ref operators/partial_concat_op.cc."""
    L = inputs[0].shape[1] - start_index if length == -1 else length
    return torch.cat([t[:, start_index:start_index + L] for t in inputs],
                     dim=1)


@def_op("batch_fc", n_tensor_args=3)
def batch_fc(x, w, bias):
    """Per-slot fully-connected (ref operators/batch_fc_op.cc):
    x [S, B, I] @ w [S, I, O] + bias [S, 1, O]."""
    return torch.einsum("sbi,sio->sbo", x, w) + bias


@def_op("spectral_norm_op", n_tensor_args=3)
def spectral_norm_op(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """Spectral weight normalisation as the reference op computes it
    (ref operators/spectral_norm_op.h): `dim` to the front, power_iters
    u/v updates without gradient, divide by sigma. Returns (out, u_new,
    v_new), the power-iteration state the reference advances in place."""
    perm = (dim,) + tuple(i for i in range(weight.dim()) if i != dim)
    wm = weight.permute(perm).reshape(weight.shape[dim], -1)
    uu, vv = u.reshape(-1), v.reshape(-1)
    with torch.no_grad():
        for _ in range(max(power_iters, 0)):
            vv = wm.T @ uu
            vv = vv / torch.clamp(torch.linalg.vector_norm(vv), min=eps)
            uu = wm @ vv
            uu = uu / torch.clamp(torch.linalg.vector_norm(uu), min=eps)
    uu, vv = uu.detach(), vv.detach()
    sigma = uu @ wm @ vv
    out = wm / torch.clamp(sigma, min=eps)
    inv = tuple(int(i) for i in np.argsort(perm))
    out = out.reshape(tuple(weight.shape[d] for d in perm)).permute(inv)
    return out, uu.reshape(u.shape), vv.reshape(v.shape)


# ----------------------------------------------- selected-rows / creation

def merge_selected_rows(x, name=None):
    """ref operators/merge_selected_rows_op.cc: a SelectedRows with its
    duplicate rows summed."""
    from ..framework.selected_rows import SelectedRows
    if not isinstance(x, SelectedRows):
        raise TypeError("merge_selected_rows expects a SelectedRows")
    return x.merge()


def get_tensor_from_selected_rows(x, name=None):
    """ref operators/get_tensor_from_selected_rows_op.cc: densify."""
    from ..framework.selected_rows import SelectedRows
    if not isinstance(x, SelectedRows):
        raise TypeError("get_tensor_from_selected_rows expects "
                        "SelectedRows")
    return Tensor._wrap(x.to_dense())


@def_op("fill_zeros_like")
def fill_zeros_like(x):
    """ref operators/fill_zeros_like_op.cc (the backward-init op)."""
    return torch.zeros_like(x)


@def_op("lod_reset", n_tensor_args=2, differentiable=False)
def lod_reset(x, target_lengths):
    """ref operators/lod_reset_op.cc: in the dense-plus-lengths form, the
    same data with new lengths: (x, lengths)."""
    return x, target_lengths


def _gaussian_random_raw(shape=(1,), mean=0.0, std=1.0, generator=None,
                         device=None):
    """ref operators/gaussian_random_op.cc."""
    z = torch.randn(tuple(shape), generator=generator, device=device)
    return mean + std * z


def _uniform_random_raw(shape=(1,), min=-1.0, max=1.0, generator=None,
                        device=None):
    """ref operators/uniform_random_op.cc."""
    out = torch.empty(tuple(shape), device=device)
    return out.uniform_(min, max, generator=generator)


def _truncated_gaussian_random_raw(shape=(1,), mean=0.0, std=1.0,
                                   generator=None, device=None):
    """ref operators/truncated_gaussian_random_op.cc: a normal truncated
    to two standard deviations, by the inverse CDF of a uniform draw
    between Phi(-2) and Phi(2)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(tuple(shape), device=device).uniform_(
        lo, 1.0 - lo, generator=generator)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return mean + std * torch.clamp(z, -2.0, 2.0)


register_op("gaussian_random", _gaussian_random_raw)
register_op("uniform_random", _uniform_random_raw)
register_op("truncated_gaussian_random", _truncated_gaussian_random_raw)


def _rng_creation(raw, name, shape, kwargs):
    dev = state.current_device()
    return apply(raw, (), dict(kwargs, shape=[int(s) for s in shape],
                               generator=state.rng_generator(dev),
                               device=dev), name=name)


def gaussian_random(shape, mean=0.0, std=1.0, name=None):
    return _rng_creation(_gaussian_random_raw, "gaussian_random", shape,
                         {"mean": float(mean), "std": float(std)})


def uniform_random(shape, min=-1.0, max=1.0, name=None):
    return _rng_creation(_uniform_random_raw, "uniform_random", shape,
                         {"min": float(min), "max": float(max)})


def truncated_gaussian_random(shape, mean=0.0, std=1.0, name=None):
    return _rng_creation(_truncated_gaussian_random_raw,
                         "truncated_gaussian_random", shape,
                         {"mean": float(mean), "std": float(std)})


@def_op("inplace_abn", n_tensor_args=5)
def inplace_abn(x, mean, var, scale, bias, epsilon=1e-5,
                activation="identity", alpha=0.01):
    """Activated batch norm (ref operators/inplace_abn_op.cc): the BN
    inference transform, then identity, elu or leaky_relu."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + epsilon)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, alpha * y)
    if activation == "elu":
        return torch.where(y >= 0, y, alpha * (torch.exp(y) - 1.0))
    return y


def _mul32(h, mult):
    """(h * mult) mod 2^32 for int64 h in [0, 2^32) and a 32-bit mult,
    in two 16-bit halves so no product leaves int64."""
    lo = (h & 0xFFFF) * mult
    hi = ((h >> 16) * mult) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix(h):
    """The JAX package's uint32 integer mix, on int64 values in
    [0, 2^32)."""
    for shift, mult in ((15, 0x85EBCA6B), (13, 0xC2B2AE35)):
        h = h ^ (h >> shift)
        h = _mul32(h, mult)
    return h ^ (h >> 16)


@def_op("hash_op", n_tensor_args=1, differentiable=False)
def hash_op(x, num_hash=1, mod_by=100000):
    """Feature hashing (ref operators/hash_op.cc contract: ids [B, 1] ->
    [B, num_hash, 1] bucket ids, `num_hash` independent hashes mod
    `mod_by`). The JAX package's splitmix-style mix, not the
    reference's XXH64: the bucket ids are the JAX package's."""
    v = x.reshape(x.shape[0], -1).long() & _MASK32
    outs = []
    for k in range(num_hash):
        h = torch.full((v.shape[0],), (0x9E3779B9 * (k + 1)) & _MASK32,
                       dtype=torch.int64, device=x.device)
        for j in range(v.shape[1]):
            h = _mix(h ^ v[:, j])
        outs.append(h % mod_by)
    return torch.stack(outs, dim=1).to(torch.int32)[:, :, None]


# ----------------------------------------------- ASR / seg / misc metrics

@def_op("edit_distance", n_tensor_args=4, differentiable=False)
def edit_distance(hyp, ref, hyp_lens, ref_lens, normalized=True):
    """Levenshtein distance over padded id batches (ref
    operators/edit_distance_op.cc): the DP row [B, T2+1] advanced one
    hypothesis position at a time, the whole batch a step. Returns [B, 1]
    (over the reference length when `normalized`)."""
    B, T1 = hyp.shape
    T2 = ref.shape[1]
    hyp_lens = hyp_lens.reshape(-1).long()
    ref_lens = ref_lens.reshape(-1).long()
    row = torch.arange(T2 + 1, device=hyp.device, dtype=torch.float32
                       )[None, :].expand(B, T2 + 1)
    for t in range(T1):
        sub = row[:, :-1] + (hyp[:, t][:, None] != ref).float()
        dele = row[:, 1:] + 1.0
        cur = row[:, 0] + 1.0
        cols = [cur]
        for j in range(T2):
            cur = torch.minimum(torch.minimum(sub[:, j], dele[:, j]),
                                cur + 1.0)
            cols.append(cur)
        new = torch.stack(cols, dim=1)
        row = torch.where((t < hyp_lens)[:, None], new, row)
    dist = torch.gather(row, 1, ref_lens[:, None])
    if normalized:
        dist = dist / torch.clamp(ref_lens[:, None], min=1).float()
    return dist


@def_op("ctc_align", n_tensor_args=2, differentiable=False)
def ctc_align(x, lengths, blank=0, merge_repeated=True):
    """CTC greedy-decode alignment (ref operators/ctc_align_op.cc): merge
    repeats, drop blanks, left-align each row. Returns (ids padded with
    0, new lengths)."""
    B, T = x.shape
    lengths = lengths.reshape(-1).long()
    t_idx = torch.arange(T, device=x.device)[None, :]
    keep = (t_idx < lengths[:, None]) & (x != blank)
    if merge_repeated:
        same = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                      device=x.device),
                          x[:, 1:] == x[:, :-1]], dim=1)
        keep = keep & ~same
    pos = torch.where(keep, torch.cumsum(keep.long(), 1) - 1,
                      torch.full_like(t_idx.expand(B, T), T))
    out = torch.zeros((B, T + 1), dtype=x.dtype, device=x.device)
    out.scatter_(1, pos, torch.where(keep, x, torch.zeros_like(x)))
    return out[:, :T], keep.sum(1).to(torch.int32)


@def_op("mean_iou", n_tensor_args=2, differentiable=False)
def mean_iou(pred, label, num_classes=2):
    """Segmentation mean IoU (ref operators/mean_iou_op.cc). Returns
    (mean_iou, out_wrong [C], out_correct [C])."""
    p = pred.reshape(-1).long()
    l = label.reshape(-1).long()
    zeros = torch.zeros((num_classes,), dtype=torch.int32, device=p.device)
    correct = zeros.index_add(0, l, (p == l).to(torch.int32))
    pred_cnt = zeros.index_add(0, p, torch.ones_like(p, dtype=torch.int32))
    lab_cnt = zeros.index_add(0, l, torch.ones_like(l, dtype=torch.int32))
    union = pred_cnt + lab_cnt - correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp(union, min=1),
                      torch.zeros((), device=p.device))
    miou = torch.sum(iou) / torch.clamp(torch.sum(present), min=1)
    return miou.to(torch.float32), lab_cnt - correct, correct


@def_op("spp")
def spp(x, pyramid_height=2, pool_type="max"):
    """Spatial pyramid pooling (ref operators/spp_op.cc): adaptive pools
    at 1x1, 2x2, ... 2^(h-1) bins, flattened and concatenated."""
    B = x.shape[0]
    pool = TF.adaptive_max_pool2d if pool_type == "max" \
        else TF.adaptive_avg_pool2d
    return torch.cat([pool(x, (2 ** lv, 2 ** lv)).reshape(B, -1)
                      for lv in range(pyramid_height)], dim=1)


@def_op("add_position_encoding")
def add_position_encoding(x, alpha=1.0, beta=1.0):
    """Sinusoidal position encoding mix (ref
    operators/add_position_encoding_op.h): alpha*x + beta*PE,
    PE[pos, i] = sin(pos / 10000^(i/(half-1))) for the first half of the
    channels and the matching cos for the second. x: [B, T, D]."""
    B, T, D = x.shape
    half = D // 2
    dev = x.device
    i = torch.arange(half, dtype=torch.float32, device=dev)
    denom = torch.pow(10000.0, i / max(half - 1, 1))
    pos = torch.arange(T, dtype=torch.float32, device=dev)[:, None]
    ang = pos / denom[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if pe.shape[1] < D:                                       # odd D
        pe = TF.pad(pe, (0, D - pe.shape[1]))
    return alpha * x + beta * pe[None].to(x.dtype)


@def_op("dequantize_abs_max", n_tensor_args=2, differentiable=False)
def dequantize_abs_max(x, scale, max_range=127.0):
    """ref operators/dequantize_abs_max_op.cc: int8 -> float by a
    per-tensor abs-max scale."""
    return x.float() * (scale.reshape(-1)[0] / max_range)


@def_op("dequantize_log", n_tensor_args=2, differentiable=False)
def dequantize_log(x, dict_table):
    """ref operators/dequantize_log_op.cc: log-quantized codes decoded
    through a lookup table; negative codes (and uint8-style codes >= 128)
    carry the sign."""
    ids = x.long()
    neg = (ids < 0) | (ids >= 128)
    vals = dict_table[torch.where(ids < 0, ids + 128,
                                  torch.where(ids >= 128, ids - 128, ids))]
    return torch.where(neg, -vals, vals)


# ------------------------------------------------ niche text/vision tail

@def_op("match_matrix_tensor", n_tensor_args=3)
def match_matrix_tensor(x, y, w):
    """Text-matching tensor product (ref operators/match_matrix_tensor_op.cc):
    out[b, t, i, j] = x[b, i] . W[t] . y[b, j]. x: [B, Lx, D1],
    y: [B, Ly, D2], w: [D1, T, D2] -> [B, T, Lx, Ly]."""
    return torch.einsum("bid,dte,bje->btij", x, w, y)


@def_op("tree_conv", n_tensor_args=3)
def tree_conv(nodes_vector, edge_set, filter, max_depth=2):
    """TBCNN tree convolution (ref operators/tree_conv_op.cc +
    math/tree2col.cc). Each node's patch is itself (depth 0) and its
    descendants while depth + 1 < max_depth; a member at depth d whose
    parent has pclen children, it the index-th, contributes through
    eta_t = (fd - d)/fd, eta_l = (1 - eta_t)*((index-1)/(pclen-1) | 0.5),
    eta_r = (1 - eta_t)*(1 - eta_l), in the filter's (l, r, t) order.
    The patch weights [N, N, 3] are built on the device from the edges'
    adjacency (a child's index and its parent's child count counted over
    the valid edges in order, the descendants at depth d by d products
    of the adjacency), with no host read; the edges form a tree (each
    node has one parent). nodes_vector: [N, F] (edge ids 1-based),
    edge_set: [E, 2] (parent, child; rows with a 0 pad),
    filter: [F, 3, out_size, num_filters] -> [N, out_size, num_filters]."""
    N = nodes_vector.shape[0]
    dev = nodes_vector.device
    f = nodes_vector.dtype
    par, ch = edge_set[:, 0].long(), edge_set[:, 1].long()
    valid = (par > 0) & (ch > 0)
    E = par.shape[0]
    same = (par[:, None] == par[None, :]) & valid[None, :]
    index = (same & torch.tril(torch.ones((E, E), dtype=torch.bool,
                                          device=dev))).sum(1)
    pclen = same.sum(1)
    # per child node: its index among its parent's children, the count
    node_ok = valid & (par <= N) & (ch <= N)
    tgt = torch.where(node_ok, ch - 1, torch.full_like(ch, N))
    idx_of = torch.ones((N + 1,), dtype=f, device=dev).scatter(
        0, tgt, index.to(f))[:N]
    plen_of = torch.ones((N + 1,), dtype=f, device=dev).scatter(
        0, tgt, pclen.to(f))[:N]
    adj = torch.zeros((N + 1, N + 1), dtype=f, device=dev).index_put_(
        (torch.where(node_ok, par - 1, torch.full_like(par, N)), tgt),
        torch.ones((), dtype=f, device=dev))[:N, :N]
    fd = float(max_depth)
    temp = torch.where(plen_of == 1, torch.full_like(idx_of, 0.5),
                       (idx_of - 1.0) / torch.clamp(plen_of - 1.0, min=1.0))
    # depth 0: the root itself, eta = (0, 0, 1)
    eye = torch.eye(N, dtype=f, device=dev)
    w = torch.stack([0 * eye, 0 * eye, eye], dim=-1)
    reach = eye
    for depth in range(1, max_depth):
        reach = (reach @ adj > 0).to(f)
        eta_t = (fd - depth) / fd
        eta_l = (1.0 - eta_t) * temp
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        w = w + reach[:, :, None] * torch.stack(
            [eta_l, eta_r, torch.full_like(eta_l, eta_t)], dim=-1)[None]
    return torch.einsum("nvk,vf,fkom->nom", w, nodes_vector, filter)


@def_op("var_conv_2d", n_tensor_args=4)
def var_conv_2d(x, row_lengths, col_lengths, filter, output_channels=1,
                input_channels=1, stride=(1, 1), kernel=(3, 3)):
    """Variable-size 2D conv (ref operators/var_conv_2d_op.cc): a
    same-padded conv over the padded batch, each sample's output masked
    to its (rows, cols) region. x: [B, C, H, W], filter: [OC, C, kh, kw]."""
    pads = (kernel[0] // 2, kernel[1] // 2)
    out = TF.conv2d(x, filter, stride=tuple(stride), padding=pads)
    H, W = out.shape[2], out.shape[3]
    out_rows = torch.div(row_lengths + stride[0] - 1, stride[0],
                         rounding_mode="floor")
    out_cols = torch.div(col_lengths + stride[1] - 1, stride[1],
                         rounding_mode="floor")
    rmask = torch.arange(H, device=x.device)[None, :] < out_rows[:, None]
    cmask = torch.arange(W, device=x.device)[None, :] < out_cols[:, None]
    m = rmask[:, None, :, None] & cmask[:, None, None, :]
    return torch.where(m, out, torch.zeros_like(out))


@def_op("pyramid_hash", n_tensor_args=2, differentiable=True)
def pyramid_hash(ids, emb_table, min_win=2, max_win=3, mod_by=None):
    """Pyramid hashing embedding (ref operators/pyramid_hash_op.cc):
    every n-gram window of sizes [min_win, max_win] hashed (hash_op's
    mix) into the table, the vectors summed per position. ids: [B, T],
    emb_table: [space, D] -> [B, T, D]."""
    space = emb_table.shape[0] if mod_by is None else mod_by
    B, T = ids.shape
    v = ids.long() & _MASK32
    out = torch.zeros((B, T, emb_table.shape[1]), dtype=emb_table.dtype,
                      device=emb_table.device)
    for win in range(min_win, max_win + 1):
        if win > T:
            break
        h = torch.full((B, T - win + 1), 0x9E3779B9 & _MASK32,
                       dtype=torch.int64, device=ids.device)
        for j in range(win):
            h = _mix(h ^ v[:, j:T - win + 1 + j])
        emb = emb_table[h % space]
        out = torch.cat([out[:, :T - win + 1] + emb,
                         out[:, T - win + 1:]], dim=1)
    return out


@def_op("bilateral_slice", n_tensor_args=3)
def bilateral_slice(grid, guide, x, has_offset=False):
    """HDRNet bilateral-grid slicing (ref operators/bilateral_slice_op.cc):
    a trilinear lookup of affine coefficients at (x/W, y/H, guide(x, y))
    per pixel, applied to the input. grid: [B, coeffs, gd, gh, gw],
    guide: [B, H, W], x: [B, Cin, H, W]; coeffs = Cout*(Cin+1) with an
    offset, Cout*Cin without."""
    B, C, gd, gh, gw = grid.shape
    H, W = guide.shape[1], guide.shape[2]
    cin = x.shape[1]
    cout = C // (cin + 1) if has_offset else C // cin
    dev = grid.device
    gx = (torch.arange(W, device=dev) + 0.5) / W * gw - 0.5
    gy = (torch.arange(H, device=dev) + 0.5) / H * gh - 0.5
    gz = guide * gd - 0.5

    def axis_idx(c, n):
        lo = torch.clamp(torch.floor(c).long(), 0, n - 1)
        hi = torch.clamp(lo + 1, 0, n - 1)
        return lo, hi, torch.clamp(c - lo, 0.0, 1.0)

    x0, x1, wx = axis_idx(gx, gw)
    y0, y1, wy = axis_idx(gy, gh)
    z0, z1, wz = axis_idx(gz, gd)
    bi = torch.arange(B, device=dev)[:, None, None]
    coeff = 0.0
    for zz, wz_ in ((z0, 1.0 - wz), (z1, wz)):
        for yy, wy_ in ((y0, 1.0 - wy), (y1, wy)):
            for xx, wx_ in ((x0, 1.0 - wx), (x1, wx)):
                # grid[b, :, zz[b,h,w], yy[h], xx[w]] -> [B, H, W, C]
                g = grid[bi, :, zz, yy[None, :, None], xx[None, None, :]]
                weight = (wz_ * wy_[None, :, None] * wx_[None, None, :]
                          )[..., None]
                coeff = coeff + g * weight
    coeff = torch.movedim(coeff, -1, 1)               # [B, C, H, W]
    A = coeff[:, :cout * cin].reshape(B, cout, cin, H, W)
    out = torch.einsum("boihw,bihw->bohw", A, x)
    if has_offset:
        out = out + coeff[:, cout * cin:cout * (cin + 1)]
    return out
