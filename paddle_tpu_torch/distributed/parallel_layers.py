"""Tensor-parallel layers (the port of `paddle_tpu/distributed/
parallel_layers.py`; ref python/paddle/distributed/collective.py:492-620
`_parallel_linear` / `_parallel_embedding`, Megatron-LM's layers).

The JAX package's layers hold the full logical weight with a
PartitionSpec hint and let GSPMD split it, or issue lax collectives when
traced inside shard_map with the 'mp' axis bound. Here every rank is a
process holding its own shard of each split weight, and the collectives
are written out as `torch.autograd.Function`s over the 'mp' slice's
process group (the conjugate pairs of Megatron-LM, arXiv 1909.08053):

  copy_to_mp       identity forward, all-reduce backward   (Paddle's
                   c_identity: the input of a column-parallel product)
  reduce_from_mp   all-reduce forward, identity backward   (mp_allreduce:
                   the output of a row-parallel product)
  gather_from_mp   all-gather of the last dim forward, the rank's slice
                   backward                                 (c_concat)
  scatter_to_mp    the rank's slice of the last dim forward, all-gather
                   backward                                 (c_split)

The model's Layer tree is the JAX layout (`save` writes it). A train
step over a mesh with 'mp' > 1 holds the rank's shards (`LocalShards`)
and runs the model with them swapped in and an mp scope installed
(`mp_scope`), the counterpart of the JAX package's bound axis: inside it
the layers below, GPT's and LLaMA's attention, MLP, vocab-parallel
embedding and head compute on the shards. The full weight of a split
parameter is released once its shard exists (`release`: the torch leaf
keeps its identity, dtype and device, its data an empty tensor), as the
JAX step's placement puts only a device's shard on the device; the
step's `sync()` gathers it back (`LocalShards.gather`, collective), and
outside a scope the model then computes on the full weights, as a single
rank would. A model holding a released weight refuses `state_dict()`
(so `save`), naming `sync()`.

A parameter is split when its `sharding` hint names 'mp' on a dim and it
carries the split's layout (`shard_hint`): the dim is cut into sections
(GPT's fused QKV: q, k and v, each a number of heads of `unit` columns)
and every section is cut evenly over the slice, so each rank holds whole
heads of each of q, k and v. A hint without the layout (BERT's word
embedding, which feeds a tied MLM head the port has no sharded form of)
leaves the parameter replicated over 'mp': under GSPMD a hint changes
only storage, so the results are the same either way. A section that
does not divide over the slice leaves the parameter replicated, as the
JAX package's `_valid_spec` does, unless the layout is strict (a head
count: GPT's and LLaMA's attention), which raises.

Dropout: a replicated region (after a row-parallel all-reduce) draws the
same mask on every rank of the slice from the framework generator, which
the ranks keep in step; a sharded region (attention over the rank's
heads) draws from the slice's own generator (`sharded_rng`), one stream
per rank.
"""
import contextlib

import torch
from torch.nn import functional as TF

from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Layer
from ..ops.dispatch import apply
from . import collective
from . import mesh as mesh_mod
from .collective import ReduceOp, all_reduce_

P = mesh_mod.PartitionSpec
MP_AXIS = mesh_mod.MP_AXIS

# seed offset of a slice's sharded-region generator (per rank)
_SHARDED_SEED = 2718281


class MPGroup:
    """The 'mp' slice a rank computes on: its process group (None in a
    world of one process), the rank's index and the slice's size, and
    the generator of the sharded regions (seeded per rank)."""

    def __init__(self, pg, rank, size, seed=None):
        self.pg = pg
        self.rank = int(rank)
        self.size = int(size)
        base = state.default_generator().initial_seed if seed is None \
            else int(seed)
        self.generator = state.Generator(
            (base + _SHARDED_SEED * (self.rank + 1)) % (1 << 62))

    def __repr__(self):
        return f"MPGroup(rank={self.rank}, size={self.size})"


def mp_group(mesh=None, seed=None):
    """The mesh's 'mp' slice of this rank (None when the mesh has no
    'mp' axis above 1)."""
    m = mesh or mesh_mod.get_mesh()
    if m is None or m.axis_size(MP_AXIS) <= 1:
        return None
    return MPGroup(m.group(MP_AXIS), m.axis_index(MP_AXIS),
                   m.axis_size(MP_AXIS), seed)


_SCOPES = []


@contextlib.contextmanager
def mp_scope(group):
    """Inside the block the layers treat their split parameters as the
    rank's shards over `group` (an `MPGroup`; None: no scope)."""
    _SCOPES.append(group)
    try:
        yield group
    finally:
        _SCOPES.pop()


def current_mp():
    """The innermost scope's `MPGroup` (None outside one)."""
    return _SCOPES[-1] if _SCOPES else None


@contextlib.contextmanager
def sharded_rng(group):
    """Random draws inside the block come from the slice's per-rank
    generator (nothing changes without a group)."""
    if group is None:
        yield
        return
    with state.use_generator(group.generator):
        yield


# ------------------------------------------------ split parameters

def _mp_dim(spec):
    dims = [i for i, a in enumerate(spec or ())
            if a == MP_AXIS or (isinstance(a, tuple) and MP_AXIS in a)]
    return dims[0] if dims else None


def shard_hint(param, spec, sections=None, unit=1, strict=False):
    """Mark `param` split over 'mp' as `spec` says (the JAX package's
    `Parameter.sharding`), each of `sections` (counts of `unit` elements
    along the split dim; None: the dim whole) cut evenly over the slice.
    `strict`: a section that does not divide raises instead of leaving
    the parameter replicated. The layout is read from the full logical
    parameter, here, once."""
    param.sharding = spec
    d = _mp_dim(spec)
    if sections is None:
        sections, unit = (unwrap(param).shape[d],), 1
    param._mp_split = (tuple(int(s) for s in sections), int(unit),
                       bool(strict))
    return param


def split_dim(param, size, name=None):
    """The dim `param` is split on over an 'mp' slice of `size` ranks, or
    None (replicated)."""
    split = getattr(param, "_mp_split", None)
    if size <= 1 or split is None:
        return None
    sections, unit, strict = split
    if any(s % size for s in sections):
        if strict:
            raise ValueError(
                f"{name or 'parameter'}: sections {sections} of {unit} "
                f"do not divide over mp = {size}")
        return None
    return _mp_dim(param.sharding)


def _layout(param, d):
    sections, unit, _ = param._mp_split
    return [s * unit for s in sections]


def is_split(param, group):
    return group is not None and split_dim(param, group.size) is not None


def shard_tensor(full, param, rank, size):
    """The rank's shard (a contiguous copy) of `full`, laid out as
    `param` (`shard_hint`)."""
    d = split_dim(param, size)
    parts = full.split(_layout(param, d), dim=d)
    return torch.cat([q.chunk(size, dim=d)[rank] for q in parts],
                     dim=d).contiguous()


def gather_tensor(local, param, group):
    """The full logical tensor of every rank's `local` shard (collective
    over the slice)."""
    d = split_dim(param, group.size)
    every = local.new_empty((group.size,) + tuple(local.shape))
    collective.all_gather_into(every, local.contiguous(), group.pg)
    sizes = [n // group.size for n in _layout(param, d)]
    pieces = [e.split(sizes, dim=d) for e in every.unbind(0)]
    return torch.cat([pieces[r][i] for i in range(len(sizes))
                      for r in range(group.size)], dim=d)


# ------------------------------------------------ residency

def release(leaf):
    """Free the data of torch leaf `leaf` (a weight this rank keeps only
    a part of): it becomes an empty tensor of the leaf's dtype and
    device, the leaf object and its full shape (`full_shape`) kept, so
    optimizers, wrappers and hooks that hold the leaf still do. Reading
    it fails on its shape; `restore` gives it its data back. Idempotent."""
    if getattr(leaf, "_full_shape", None) is None:
        leaf._full_shape = tuple(leaf.shape)
        leaf.data = leaf.data.new_empty(0)


def is_released(leaf):
    return getattr(leaf, "_full_shape", None) is not None


def full_shape(leaf):
    """A leaf's logical shape, released or not."""
    s = getattr(leaf, "_full_shape", None)
    return tuple(leaf.shape) if s is None else s


@torch.no_grad()
def restore(leaf, full):
    """`full` (the whole logical tensor) into `leaf`, in place; a released
    leaf gets new storage first."""
    if is_released(leaf):
        leaf.data = torch.empty(leaf._full_shape, dtype=leaf.dtype,
                                device=leaf.device)
        leaf._full_shape = None
    leaf.copy_(full)


def resident_nbytes(leaves):
    """Bytes of the data the torch tensors `leaves` hold (a released
    leaf holds none; a view counts its own elements)."""
    return int(sum(t.numel() * t.element_size() for t in leaves))


class LocalShards:
    """The rank's shards of a model's split parameters over `group`: one
    new torch leaf each, drawn from the model's full weight, which is
    then released (`release`). `names` restricts them to some parameters
    (a pipeline stage's). `scope()` runs the model on them; `gather()`
    writes every shard's full logical tensor back into the model
    (collective); `release()` frees those full weights again."""

    def __init__(self, model, group, names=None):
        self.model = model
        self.group = group
        self.named = dict(model.named_parameters())
        self.local = {}
        for n, w in self.named.items():
            if names is not None and n not in names:
                continue
            if split_dim(w, group.size, n) is None:
                continue
            full = w._data
            leaf = torch.nn.Parameter(
                shard_tensor(full.detach(), w, group.rank, group.size),
                requires_grad=full.requires_grad)
            for attr in ("regularizer", "learning_rate"):
                if hasattr(full, attr):
                    setattr(leaf, attr, getattr(full, attr))
            self.local[n] = leaf
        self._by_full = {id(self.named[n]._data): n for n in self.local}
        self.release()

    def working(self, leaf):
        """The leaf the rank trains for the model's torch leaf `leaf`:
        its shard when split, else itself."""
        n = self._by_full.get(id(leaf))
        return leaf if n is None else self.local[n]

    def name_of(self, leaf):
        """The parameter name of a shard (None for any other leaf)."""
        return self._by_full.get(id(leaf))

    def wrapper(self, name):
        return self.named[name]

    @contextlib.contextmanager
    def scope(self):
        swap = self.model._use_state(self.local) if self.local \
            else contextlib.nullcontext()
        with swap, mp_scope(self.group):
            yield

    @torch.no_grad()
    def gather(self, shards=None):
        """Every shard's full logical tensor into the model's weight
        (collective over the slice). `shards`: name -> the rank's shard
        to gather instead of the leaf's data (ZeRO-3's, whose leaves are
        released too)."""
        for n, leaf in self.local.items():
            w = self.named[n]
            part = leaf.detach() if shards is None else shards[n]
            restore(w._data, gather_tensor(part, w, self.group))

    def release(self):
        """Free the model's full weight of every split parameter."""
        for n in self.local:
            release(self.named[n]._data)


# ------------------------------------------------ the conjugate pairs

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ReduceOp.SUM, ctx.pg)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        out = x.contiguous().clone()
        all_reduce_(out, ReduceOp.SUM, pg)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    every = x.new_empty((group.size,) + tuple(x.shape))
    collective.all_gather_into(every, x.contiguous(), group.pg)
    return torch.cat(every.unbind(0), dim=-1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size, -1)[ctx.group.rank].contiguous(), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.size, -1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def _conj(fn, x, name):
    if isinstance(x, Tensor):
        return apply(fn, (x,), name=name)
    return fn(x)


def copy_to_mp(x, group):
    """Identity forward, the gradient all-reduced over the slice."""
    if group is None:
        return x
    return _conj(lambda a: _Copy.apply(a, group.pg), x, "c_identity")


def reduce_from_mp(x, group):
    """x summed over the slice forward, the gradient passed through."""
    if group is None:
        return x
    return _conj(lambda a: _Reduce.apply(a, group.pg), x, "mp_allreduce")


def gather_from_mp(x, group):
    """Every rank's x concatenated on the last dim (rank order); the
    gradient's slice of the rank back."""
    if group is None:
        return x
    return _conj(lambda a: _Gather.apply(a, group), x, "c_concat")


def scatter_to_mp(x, group):
    """The rank's slice of x's last dim; the gradient all-gathered."""
    if group is None:
        return x
    return _conj(lambda a: _Scatter.apply(a, group), x, "c_split")


# ------------------------------------------------ sharded arithmetic

def row_linear(layer, x, group):
    """A row-parallel product with a Linear's shard: x (the rank's part
    of the input features) @ W_shard, summed over the slice, then the
    replicated bias."""
    out = reduce_from_mp(F.linear(x, layer.weight, None), group)
    return out if layer.bias is None else out + layer.bias


def _vocab_embedding_raw(ids, w, start=0):
    local = ids.long() - start
    valid = (local >= 0) & (local < w.shape[0])
    out = TF.embedding(torch.where(valid, local, torch.zeros_like(local)),
                       w)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def vocab_parallel_embedding(ids, weight, group):
    """Rows of a vocab-split table: each rank looks up the ids in its
    rows (zeros elsewhere) and the slice sums them."""
    start = group.rank * unwrap(weight).shape[0]
    part = apply(_vocab_embedding_raw, (ids, weight), {"start": start},
                 name="c_embedding")
    return reduce_from_mp(part, group)


def mark_vocab_parallel(logits, group):
    """Tag logits whose last dim is the rank's vocab shard (the loss then
    takes `parallel_cross_entropy`'s arithmetic)."""
    unwrap(logits)._mp_vocab = group
    return logits


def vocab_parallel_of(logits):
    return getattr(unwrap(logits), "_mp_vocab", None)


def _parallel_ce_rows(z, y, group):
    """Per row, the cross entropy of vocab-split logits z [N, Vl] against
    global labels y [N] (the JAX package's ParallelCrossEntropy
    arithmetic, parallel_layers.py:141-160): the slice's max, its sum of
    exponentials and the label's logit summed over the slice. A label
    outside every shard (-1) gives log(sum) alone."""
    z = z.float()
    with torch.no_grad():
        m = z.max(dim=-1, keepdim=True).values
        all_reduce_(m, ReduceOp.MAX, group.pg)
    zs = z - m
    denom = _Reduce.apply(torch.exp(zs).sum(-1), group.pg)
    local = y.long() - group.rank * z.shape[-1]
    valid = (local >= 0) & (local < z.shape[-1])
    picked = zs.gather(-1, torch.where(valid, local, torch.zeros_like(
        local))[:, None])[:, 0]
    picked = _Reduce.apply(torch.where(valid, picked,
                                       torch.zeros_like(picked)), group.pg)
    return torch.log(denom) - picked


def _parallel_ce_raw(z, y, group=None):
    v = z.shape[-1]
    return _parallel_ce_rows(z.reshape(-1, v), y.reshape(-1), group).mean()


def parallel_lm_loss_raw(z, shifted, group=None, ignore_index=-1):
    """The mean over the valid rows (at least one) of the vocab-split
    logits' cross entropy."""
    rows = _parallel_ce_rows(z.reshape(-1, z.shape[-1]), shifted, group)
    keep = shifted != ignore_index
    total = torch.where(keep, rows, torch.zeros_like(rows)).sum()
    return total / keep.sum().clamp(min=1).to(total.dtype)


# ------------------------------------------------ the layers

class ColumnParallelLinear(Layer):
    """Y = X @ [W_1 | ... | W_p]: the weight (and bias) split on the
    output features over 'mp' (ref collective.py `_parallel_linear`
    axis=1). With `gather_output` the slice's outputs are concatenated,
    else each rank keeps its features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        shard_hint(self.weight, P(None, MP_AXIS))
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self.bias is not None:
            shard_hint(self.bias, P(MP_AXIS))

    def forward(self, x):
        mp = current_mp()
        if not is_split(self.weight, mp):
            return F.linear(x, self.weight, self.bias)
        out = F.linear(copy_to_mp(x, mp), self.weight, self.bias)
        return gather_from_mp(out, mp) if self.gather_output else out


class RowParallelLinear(Layer):
    """Y = sum_p X_p @ W_p: the weight split on the input features, the
    output summed over 'mp' and the (replicated) bias added after (ref
    collective.py `_parallel_linear` axis=0). `input_is_parallel`: x is
    already the rank's part of the features; else the rank takes it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        shard_hint(self.weight, P(MP_AXIS, None))
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    def forward(self, x):
        mp = current_mp()
        if not is_split(self.weight, mp):
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_mp(x, mp)
        return row_linear(self, x, mp)


class VocabParallelEmbedding(Layer):
    """An embedding table split by rows (vocabulary) over 'mp': each rank
    looks up the ids in its rows and the slice sums the results (ref
    collective.py:566 `_parallel_embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        shard_hint(self.weight, P(MP_AXIS, None))

    def forward(self, x):
        mp = current_mp()
        if not is_split(self.weight, mp):
            return F.embedding(x, self.weight)
        return vocab_parallel_embedding(x, self.weight, mp)


class ParallelCrossEntropy(Layer):
    """The mean softmax cross entropy of logits whose last dim is split
    over 'mp' (each rank holding its vocab shard), against global labels;
    the plain mean cross entropy outside an mp scope."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, logits, label):
        mp = current_mp()
        if mp is None:
            return apply(lambda z, y: TF.cross_entropy(
                z.float().reshape(-1, z.shape[-1]), y.long().reshape(-1)),
                (logits, label), name="parallel_cross_entropy")
        return apply(_parallel_ce_raw, (logits, label), {"group": mp},
                     name="parallel_cross_entropy")
