"""ShardedTrainStep, the data-, sequence- and tensor-parallel train step
(the port of `paddle_tpu/distributed/sharded.py`).

The JAX package compiles one SPMD program over the mesh and lets XLA
insert the collectives. Here every rank is a process running the same
step on its part of the batch, with the collectives written out:

  * every rank is given the GLOBAL batch, as the JAX step is, and takes
    its part (`shard_batch`, the JAX `_shard_batch` rule): dim 0 over
    'dp' and, with `shard_seq`, dim 1 over 'sp'; a dim that does not
    divide stays whole ('sp' refuses it: a sequence-parallel model
    computes on its shard);
  * the loss is this rank's share of the global loss. A loss function
    that averages over a data-dependent count says so through
    `global_mean(mean, count)` (the port's `gpt_pretrain_loss` and
    `bert_pretrain_loss` do): its share is mean * count / (the count
    summed over every rank). Any other loss is taken as a mean over
    equal parts and its share is loss / (dp x sp). Either way the shares
    sum to the JAX step's loss, which the step returns, and the summed
    gradients are its gradients;
  * ZeRO stage 0: the grads, packed into one flat bucket per dtype,
    are summed over 'sp' and 'dp' with all-reduces and the optimizer
    steps on views of the bucket;
  * ZeRO stage 1 (2 is folded into 1, as in the JAX package): every
    parameter is cut into dp chunks of ceil(numel / dp) elements
    (rounded up to 16 for the kernels' alignment), the bucket laid out
    rank-major ([dp, C], row r holding chunk r of every parameter).
    One reduce-scatter leaves rank r the summed chunk r of every grad;
    the optimizer runs over the rank's chunks only, so each rank holds
    1/dp of every moment (and master); one all-gather of the updated
    chunks rebuilds the parameters. `sync()` gathers the moments into
    the optimizer's own state (checkpoints), and a step built over an
    optimizer holding state takes the rank's chunk of it;
  * ZeRO stage 3: the parameters are cut as the moments are, and the
    rank's chunks are the only copy of the weights it holds (the
    model's full weights are released, `parallel_layers.release`). The
    model is cut into units: every block of its LayerLists (GPT's and
    LLaMA's), else every direct sublayer holding parameters; the rest
    (embeddings, final norm, a tied head) is the root unit. Each unit
    has its own rank-major buckets (the same chunk of every parameter
    as ZeRO-1's). A unit's forward all-gathers its full parameters
    (`_GatherUnit`), runs on them and drops them; its forward runs
    under `incubate.recompute` (unless the model already recomputes its
    blocks, `cfg.use_recompute`), so the gathered weights are never
    saved for the backward: the recompute gathers again, and the
    gather's backward sums the unit's gradients over 'sp' and
    reduce-scatters them over 'dp' into the rank's chunk grads. The
    root unit is gathered for the whole forward and backward. The
    gathering forwards are installed on the units' layers for the
    step's forward and backward and taken off after, so the model
    holds no reference to the step. Nothing gathers the whole model in
    a step, so the peak holds the root and about one block's full
    parameters. The update is ZeRO-1's on the chunks; `sync()` gathers
    the parameters back into the model too;
  * `exact_reshard` (the constructor's, or fleet's `sharding_configs=
    {"stage": n, "exact_reshard": True}`): storage stays sharded, the
    math does not depend on dp. A batch that 'dp' does not divide stays
    whole on every rank (`shard_batch`), so each rank's loss and
    gradient are already the whole batch's: nothing is summed over
    'dp', and the rank takes its chunk of the gradient as it is. The
    update is the chunks' (every rule is elementwise given its
    scalars, and the fused Adam kernel rounds each element the same
    way wherever it lies), and what reads a whole tensor (the clips,
    the grad-norm sentinel, the trust ratios) takes its squares from
    the whole tensor, all-gathered from the chunks, instead of summing
    the chunks' squares over 'dp'. All-gathers and slices are exact, so
    for such a batch the loss, the grad norm, the parameters and the
    moments of every step are bit for bit the same at any dp count,
    and a checkpoint written at one dp count resumes bit for bit at
    another. With a batch 'dp' divides, the rows are cut and the
    gradients summed over 'dp', and that sum's order depends on dp:
    those runs agree across dp counts only to rounding, as the JAX
    package's do.

The optimizer API. The JAX step takes a functional optimizer
(`init_opt_state` / `apply_gradients_fn`, paddle_tpu/optimizer/
optimizer.py:197, 222). The port's optimizers update in place, and the
port keeps that form: ZeRO-1 runs the same optimizer class over the
rank's chunks, as a shallow copy whose parameters are the chunks (leaf
views into the rank's flat shard, their grads views into the
reduce-scattered bucket) and whose per-parameter state starts empty.
Its own step() and fused Adam kernel do the update, so nothing of the
update rule is written twice. The copy reads its learning rate from the
optimizer (`set_lr` and schedules reach it) and writes its step count
back after every step. What needs a whole tensor sums its squares over
'dp': global-norm and per-tensor clipping (`_sharded_clip`), and the
per-tensor norms of Lamb's and Lars's trust ratios and Dpsgd's clip
(`Optimizer._tensor_norms`). Dpsgd's noise with sigma > 0 is refused:
each rank would draw the same noise for its chunks.

`fp16_allreduce` reduces the bucket in f16 (or the configured dtype)
and casts back; it is ignored, with a warning, when dp == 1 or with
`return_outputs`, as in the JAX package. `gradient_merge` is
`jit.TrainStep`'s: each call's grads are added into the accumulators,
and every k-th call packs their sum (or mean) into the bucket, reduces
and updates (two programs). `recompute` and `amp` wrap the forward as in
`jit.TrainStep`.

Tensor parallelism ('mp' > 1, `parallel_layers`): the batch is
replicated over 'mp' and the rank holds its shard of every split
parameter (`parallel_layers.LocalShards`: a leaf each; the model's full
weight of it is released); the forward and backward run with the shards
swapped into the model and an mp scope installed, so GPT's and LLaMA's
Megatron layers compute on them. The optimizer steps a shallow copy
over the rank's leaves (its shards and the replicated parameters); with
ZeRO the chunks over 'dp' are cut from those (the JAX `_zero_spec` over
the base spec). Gradients are summed over 'dp' and 'sp' only: a
replicated parameter's gradient is the same on every rank of the slice
(the conjugate collectives see to it). A whole tensor's norm (the
clips, the grad-norm sentinel, Lamb's and Lars's trust ratios) sums a
split parameter's squares over 'mp' and counts a replicated one once.
`sync()` gathers every shard's full tensor (and its moments) back into
the model and the optimizer, so `save` writes the JAX layout; the next
call releases the full weights again.

On a card whose groups are NCCL, the step is one CUDA graph per input
signature (`graphs.Program`, as `jit.TrainStep`), collectives included;
with a gloo group it runs eagerly. Each rank's model is built from the
same seed; the step broadcasts rank 0's parameters over the mesh at
construction all the same. Buffers (BatchNorm's statistics) stay the
rank's own: cross-card BatchNorm is ROADMAP Queue 1 item 5c. An axis
other than 'dp', 'sp' and 'mp' ('pp', ...) is the batch axis when the
mesh has no 'dp' (the JAX rule), else the step is replicated over it:
pipelines are `pipeline.PipelineTrainStep` and
`pipeline_1f1b.OneF1BTrainStep`.

The flight-recorder instrumentation and the chaos points wait for
ROADMAP Queue 1 item 6.
"""
import contextlib
import copy
import functools
import warnings
import weakref

import numpy as np
import torch

from ..framework.tensor import Tensor, unwrap
from ..incubate.recompute import recompute
from ..jit import TrainStep, transforms as tfm
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from ..optimizer import Dpsgd
from . import collective
from . import mesh as mesh_mod
from . import parallel_layers as tp
from .collective import ReduceOp, all_reduce_

#: elements a ZeRO chunk and a bucket slot are rounded up to (64 bytes
#: of f32): every view the fused Adam kernel reads is 16-byte aligned
_ALIGN = 16

_SCOPES = []         # the innermost ShardedTrainStep's batch scope


class _BatchScope:
    """What a loss function inside a sharded step needs: the groups the
    batch is cut over (summed over for global counts) and the 'sp'
    group, this rank's place in it and its size."""

    def __init__(self, groups, sp_group, sp_index, sp_size):
        self.groups = groups
        self.sp_group = sp_group
        self.sp_index = sp_index
        self.sp_size = sp_size
        self.declared = False


@contextlib.contextmanager
def loss_scope(mesh=None, cut_dp=True):
    """The loss functions inside the block give this rank's share of the
    global loss over the mesh's 'dp' and 'sp' (as inside a
    ShardedTrainStep): for a forward and backward of one's own, e.g.

        with loss_scope():
            share = gpt_pretrain_loss(model(ids_shard), ids_shard)
        share.backward()     # then sum the loss and the grads over the
                             # mesh: they are the global batch's

    Yields the scope; its `declared` says whether the loss called
    `global_mean` (else its share is loss / (dp x sp)). ShardedTrainStep
    runs its forward in one. `cut_dp=False`: the batch is whole on every
    rank of 'dp' (an exact_reshard step's undivided batch), so the share
    is taken over 'sp' alone."""
    m = mesh or mesh_mod.get_mesh()
    groups = [m.group(a) for a in (mesh_mod.DP_AXIS, mesh_mod.SP_AXIS)
              if a in m.axis_names and m.axis_size(a) > 1
              and (cut_dp or a != mesh_mod.DP_AXIS)]
    sp = m.axis_size(mesh_mod.SP_AXIS)
    _SCOPES.append(_BatchScope(
        groups, m.group(mesh_mod.SP_AXIS) if sp > 1 else None,
        m.axis_index(mesh_mod.SP_AXIS) if sp > 1 else 0, sp))
    try:
        yield _SCOPES[-1]
    finally:
        _SCOPES.pop()


def _current():
    return _SCOPES[-1] if _SCOPES else None


def global_mean(mean, count):
    """A loss `mean` over `count` (a device tensor or a number) of this
    rank's rows, as this rank's share of the mean over every rank's rows:
    mean * count / (count summed over the batch's groups). Outside a
    sharded step, `mean` itself."""
    scope = _current()
    if scope is None:
        return mean
    m = unwrap(mean)
    if isinstance(count, (int, float)):       # a fill: capturable
        c = torch.full((), float(count), dtype=m.dtype, device=m.device)
    else:
        c = unwrap(count).detach().to(m.dtype).reshape(())
    total = c.clone()
    for pg in scope.groups:
        all_reduce_(total, ReduceOp.SUM, pg)
    scope.declared = True
    share = torch.where(c > 0, m * (c / total), torch.zeros_like(m))
    return Tensor._wrap(share) if isinstance(mean, Tensor) else share


def sharded_parts():
    """The ranks the innermost sharded step's batch is cut over (1
    outside one)."""
    scope = _current()
    if scope is None:
        return 1
    return int(np.prod([collective.group_size(g) for g in scope.groups]))


def sp_next_first(labels):
    """[B, 1]: the first column of the next sequence shard's `labels`
    (-1 on the last shard), the label that follows this shard's last
    position. None outside a sequence-parallel step."""
    scope = _current()
    if scope is None or scope.sp_size == 1:
        return None
    lab = unwrap(labels)
    first = lab[:, :1].contiguous()
    every = torch.empty((scope.sp_size,) + tuple(first.shape),
                        dtype=first.dtype, device=first.device)
    collective.all_gather_into(every, first, scope.sp_group)
    if scope.sp_index == scope.sp_size - 1:
        return torch.full_like(first, -1)
    return every[scope.sp_index + 1]


def _roundup(n, m):
    return -(-int(n) // m) * m


class _Masks:
    """Device masks of split flags, made at a step's first (eager) call
    and reused, so a capture makes none."""

    def __init__(self):
        self._made = {}

    def __call__(self, flags, device):
        key = (flags, str(device))
        m = self._made.get(key)
        if m is None:
            m = self._made[key] = torch.tensor(flags, device=device)
        return m


def _whole_sq(sq, flags, chunks_pg, mp_pg, masks):
    """Per tensor, the squares of the whole logical tensor from this
    rank's part: summed over 'dp' when the parts are ZeRO chunks
    (`chunks_pg`), then, for the tensors split over 'mp' (`flags`), over
    the mp slice."""
    all_reduce_(sq, ReduceOp.SUM, chunks_pg)
    if mp_pg is None or not any(flags):
        return sq
    m = masks(flags, sq.device)
    part = torch.where(m, sq, torch.zeros_like(sq))
    all_reduce_(part, ReduceOp.SUM, mp_pg)
    return torch.where(m, part, sq)


class _Bucket:
    """The flat gradient bucket of the parameters of one dtype, laid
    out rank-major over `dp` chunks (ZeRO-1) or as the parameters
    end to end (`dp` = 1 layout: every slot 16-element aligned)."""

    def __init__(self, params, dp, flat=True):
        self.params = params
        self.dp = dp
        self.numels = [p.numel() for p in params]
        self.chunks = [_roundup(-(-n // dp), _ALIGN) for n in self.numels]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.chunks)[:-1]]).astype(int).tolist()
        self.width = int(sum(self.chunks))         # C, one rank's chunks
        p0 = params[0]
        self.dtype, self.device = p0.dtype, p0.device
        # ZeRO-3 packs into buffers of its own: no flat bucket
        self.flat = torch.zeros((dp, self.width), dtype=p0.dtype,
                                device=p0.device) if flat else None

    def regions(self, i, full):
        """(dst views of `full` ([dp, C]), src slices of a flat tensor of
        parameter i's numel) that cover its elements."""
        n, c, off = self.numels[i], self.chunks[i], self.offsets[i]
        rows, rem = divmod(n, c)
        out = []
        if rows:
            out.append((full[:rows, off:off + c], slice(0, rows * c),
                        (rows, c)))
        if rem:
            out.append((full[rows, off:off + rem], slice(rows * c, n),
                        (rem,)))
        return out

    def pack(self, grads, into=None):
        """Each grad (or zeros for None) into its chunks of the bucket
        (or of `into`, a [dp, C] tensor whose padding is zero)."""
        for i, g in enumerate(grads):
            for dst, src, shape in self.regions(
                    i, self.flat if into is None else into):
                if g is None:
                    dst.zero_()
                else:
                    dst.copy_(g.reshape(-1)[src].view(shape))

    def unpack(self, full, outs):
        """The elements of `full` ([dp, C]) into the flat views of
        `outs` (tensors shaped like the parameters)."""
        for i, o in enumerate(outs):
            flat = o.view(-1)
            for src, dst, shape in self.regions(i, full):
                flat[dst].view(shape).copy_(src)

    def views(self, row_tensor):
        """Per parameter, the slice of a [C] tensor that is its chunk."""
        return [row_tensor[off:off + c]
                for off, c in zip(self.offsets, self.chunks)]


class _Parts:
    """How the stepper's leaves make whole tensors: ZeRO chunks over
    'dp' (`chunks_pg`, else None) and which leaves are split over 'mp'
    (`split`, their ids; `mp_pg`); and, in a pipeline, how the stages'
    tensors make the whole model: summed over the 'pp' slice (`pp_pg`),
    a leaf whose tensor another stage also holds (`dup`, ids: the last
    stage's copy of a tied weight) left out of the sum. `gather`
    (exact_reshard's): the leaves' whole tensors from their ZeRO chunks,
    whose squares are taken instead of the chunks' (`chunks_pg` None)."""

    def __init__(self, chunks_pg, mp_pg, split, pp_pg=None, dup=(),
                 gather=None):
        self.chunks_pg = chunks_pg
        self.mp_pg = mp_pg
        self.split = split
        self.pp_pg = pp_pg
        self.dup = set(dup)
        self.gather = gather
        self.masks = _Masks()

    def tensors(self, xs, leaves):
        """What the squares of `leaves`' tensors `xs` are taken of: the
        rank's parts, or under exact_reshard the whole tensors."""
        return xs if self.gather is None else self.gather(xs, leaves)

    def whole_sq(self, sq, leaves):
        flags = tuple(id(p) in self.split for p in leaves)
        return _whole_sq(sq, flags, self.chunks_pg, self.mp_pg, self.masks)

    def global_sq(self, sq, leaves):
        """The squares of the model's whole tensors summed (a torch
        scalar): `leaves`' (`whole_sq`), then every stage's, each tensor
        counted once."""
        sq = self.whole_sq(sq, leaves)
        if self.dup:
            keep = self.masks(tuple(id(p) not in self.dup for p in leaves),
                              sq.device)
            sq = torch.where(keep, sq, torch.zeros_like(sq))
        return all_reduce_(sq.sum(), ReduceOp.SUM, self.pp_pg)


class _ShardedGlobalNorm(ClipGradByGlobalNorm):
    """Global-norm clipping over the rank's parts of the tensors (ZeRO
    chunks, mp shards, pipeline stages): each tensor's squares made
    whole, then summed over the model (`_Parts.global_sq`)."""

    def __init__(self, clip, parts):
        super().__init__(clip.clip_norm, clip.group_name)
        self._parts = parts

    def __call__(self, params_grads):
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        leaves = [p for p, _ in live]
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in
                          self._parts.tensors([g for _, g in live], leaves)])
        sq = self._parts.global_sq(sq, leaves)
        scale = self.clip_norm / torch.clamp(torch.sqrt(sq),
                                             min=self.clip_norm)
        return [(p, g if g is None else g * scale.to(g.dtype))
                for p, g in params_grads]


class _ShardedNorm(ClipGradByNorm):
    """Per-tensor clipping over the rank's parts of the tensors: each
    tensor's squares made whole (one all-reduce of the vector a group)."""

    def __init__(self, clip, parts):
        super().__init__(clip.clip_norm)
        self._parts = parts

    def __call__(self, params_grads):
        live = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        if not live:
            return params_grads
        leaves = [params_grads[i][0] for i in live]
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in
                          self._parts.tensors(
                              [params_grads[i][1] for i in live], leaves)])
        sq = self._parts.whole_sq(sq, leaves)
        scale = torch.clamp(self.clip_norm / torch.clamp(torch.sqrt(sq),
                                                         min=1e-12), max=1.0)
        out = list(params_grads)
        for j, i in enumerate(live):
            p, g = out[i]
            out[i] = (p, g * scale[j].to(g.dtype))
        return out


def grad_sentinel(parts, loss, grads, leaves):
    """(the global grad norm, non-finite) of the reduced grads of
    `leaves`: each tensor's squares made whole over its ZeRO chunks and
    mp shards, summed over the model (`_Parts.global_sq`)."""
    if grads:
        sq = torch.stack(torch._foreach_norm(
            parts.tensors(grads, leaves), 2, dtype=torch.float32)).square()
        gsq = parts.global_sq(sq, leaves)
    else:
        gsq = all_reduce_(torch.zeros((), device=loss.device),
                          ReduceOp.SUM, parts.pp_pg)
    return torch.sqrt(gsq), torch.logical_not(
        torch.isfinite(loss) & torch.isfinite(gsq))


def _sharded_clip(clip, parts):
    if clip is None or isinstance(clip, ClipGradByValue):
        return clip
    if isinstance(clip, ClipGradByGlobalNorm):
        return _ShardedGlobalNorm(clip, parts)
    if isinstance(clip, ClipGradByNorm):
        return _ShardedNorm(clip, parts)
    raise NotImplementedError(f"a sharded step with grad_clip "
                              f"{type(clip).__name__}")


def _whole_norms(opt, parts, xs):
    """Per tensor, the L2 norm of the whole tensor from this rank's part
    of it (the stepper's `_tensor_norms`; `opt._norm_leaves` are the
    leaves `xs` belong to), in f64 on the CPU as `optimizer._norms`
    sums."""
    leaves = opt._norm_leaves
    xs = parts.tensors(xs, leaves)
    if xs[0].is_cuda:
        sq = torch.stack(torch._foreach_norm(xs)).square()
    else:
        sq = torch.stack(torch._foreach_norm(
            xs, 2, dtype=torch.float64)).square()
    return torch.sqrt(parts.whole_sq(sq, leaves)).float()


def _note_leaves(opt):
    """Wrap the stepper's `_update` so `_tensor_norms` knows which leaves
    a group's tensors belong to: by their state dicts, which are the
    stepper's parameters'."""
    update = opt._update

    def _update(bases, grads, states, lr, step):
        by_state = {id(st): opt._parameters[i]
                    for i, st in opt._state.items()}
        opt._norm_leaves = [by_state[id(st)] for st in states]
        return update(bases, grads, states, lr, step)
    opt._update = _update


def _zero_spec(shape, dp, dp_axis, base_spec):
    """The JAX package's ZeRO-1 placement of a state slot: the largest
    dim that divides over dp (a record for `sharding_state`)."""
    if dp == 1 or not shape:
        return base_spec
    parts = list(base_spec) + [None] * (len(shape) - len(base_spec))
    for i in np.argsort([-s for s in shape]):
        if parts[i] is None and shape[i] % dp == 0:
            parts[i] = dp_axis
            return mesh_mod.PartitionSpec(*parts)
    return base_spec


def make_stepper(base, leaves, parts):
    """A shallow copy of the optimizer `base` over `leaves` (a rank's
    ZeRO chunks or mp shards), its state empty, reading `base`'s lr; its
    clip and per-tensor norms take whole tensors (`parts`, a `_Parts`)."""
    opt = copy.copy(base)
    opt._parameters = list(leaves)
    opt._state = {}
    opt._scalars = None
    opt._grad_clip = _sharded_clip(base._grad_clip, parts)
    # one learning rate: set_lr, a schedule or fleet.set_lr on the
    # optimizer reach the copy
    opt.get_lr, opt.set_lr = base.get_lr, base.set_lr
    if parts.chunks_pg is not None or parts.mp_pg is not None \
            or parts.gather is not None:
        opt._tensor_norms = functools.partial(_whole_norms, opt, parts)
        opt._norm_leaves = []
        _note_leaves(opt)
    return opt


def _spec_doc(spec):
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


# ------------------------------------------------------------- ZeRO-3

class _Unit:
    """A part of the model ZeRO-3 gathers at once: a layer and the
    trained parameters it holds (`names`, relative to the layer; `keys`,
    the ids of their working leaves), with their buckets (indices into
    the step's). `recomputed`: the model already checkpoints the
    layer's forward (GPT's and LLaMA's `cfg.use_recompute`)."""

    def __init__(self, layer, prefix, recomputed):
        self.layer, self.prefix, self.recomputed = layer, prefix, recomputed
        self.names, self.keys, self.buckets = [], [], []
        self.written = False


def _unit_layers(model):
    """[(layer, name prefix, recomputed)]: every item of each outermost
    LayerList (GPT's and LLaMA's blocks, which the model recomputes under
    `cfg.use_recompute`), else every direct sublayer holding
    parameters."""
    from ..nn.layer import Layer, LayerList
    remat = bool(getattr(getattr(model, "cfg", None), "use_recompute",
                         False))
    out, lists = [], []
    for name, sub in model.named_sublayers():
        if any(name == c or name.startswith(c + ".") for c in lists):
            continue
        if isinstance(sub, LayerList):
            lists.append(name)
            out += [(blk, f"{name}.{i}", remat)
                    for i, blk in sub._modules.items()]
    if not out:
        out = [(sub, n, False) for n, sub in model._modules.items()
               if isinstance(sub, Layer) and sub.parameters()]
    return out


class _GatherUnit(torch.autograd.Function):
    """ZeRO-3's gather on use. Forward: a unit's full parameters from
    every rank's chunks (one all-gather a bucket). Backward: their
    gradients summed over 'sp' and reduce-scattered over 'dp' into the
    rank's chunk grads (`ShardedTrainStep._z3_scatter`). `anchor` is a
    leaf that requires grad, so the node is recorded."""

    @staticmethod
    def forward(ctx, anchor, step, unit):
        ctx.step, ctx.unit = step, unit
        return tuple(step._z3_gather(unit))

    @staticmethod
    def backward(ctx, *grads):
        ctx.step._z3_scatter(ctx.unit, grads)
        return None, None, None


class ShardedTrainStep(TrainStep):
    """Data-, sequence- and tensor-parallel train step over the current
    mesh:

        make_mesh({'dp': 2, 'mp': 2})
        step = ShardedTrainStep(model, loss_fn, opt, zero_stage=1)
        loss = step(batch_inputs, batch_labels)   # the global batch

    Returns the global loss (the mean over every rank's rows), as the
    JAX step does; with `return_outputs`, this rank's outputs beside
    it."""

    def __init__(self, model, loss_fn, optimizer, mesh=None, dp_axis=None,
                 zero_stage=0, donate=True, remat=False, shard_seq=True,
                 return_outputs=False, exact_reshard=False, cuda_graph=True):
        transforms = tfm.resolve(optimizer)
        zero_stage = tfm.zero_stage_of(transforms, zero_stage)
        sh_cfg = transforms.get("sharding") or {}
        if "exact_reshard" in sh_cfg:
            exact_reshard = bool(sh_cfg["exact_reshard"])
        self.mesh = mesh or mesh_mod.get_mesh() or mesh_mod.default_mesh()
        m = self.mesh
        # the batch axis: 'dp', else the mesh's first axis that is
        # neither 'sp' nor 'mp' (a mesh of 'sp' or 'mp' alone has no
        # data parallelism)
        self.dp_axis = dp_axis or next(
            (a for a in (mesh_mod.DP_AXIS,) + m.axis_names
             if a in m.axis_names
             and a not in (mesh_mod.SP_AXIS, mesh_mod.MP_AXIS)), None)
        if remat and transforms.get("recompute") is None:
            transforms["recompute"] = {}
        self.dp = m.axis_size(self.dp_axis) if self.dp_axis else 1
        # a world of one rank keeps its group: its collectives run (and
        # are captured) on one card
        self._dp_group = m.group(self.dp_axis) if self.dp_axis else None
        self.sp = m.axis_size(mesh_mod.SP_AXIS)
        self._sp_group = m.group(mesh_mod.SP_AXIS) if self.sp > 1 else None
        # the groups the batch is cut over (the loss and grads are
        # summed over them), and the mp slice
        self._groups = [g for g in (self._dp_group, self._sp_group)
                        if g is not None]
        self._mp = tp.mp_group(m)
        self.mp = self._mp.size if self._mp is not None else 1
        every = self._groups + ([self._mp.pg] if self._mp is not None
                                and self._mp.pg is not None else [])
        # one CUDA graph a signature when every group is NCCL; a gloo
        # collective cannot be captured
        nccl = all(torch.distributed.get_backend(g) == "nccl"
                   for g in every)
        super().__init__(model, loss_fn, optimizer, donate=donate,
                         return_outputs=return_outputs,
                         cuda_graph=cuda_graph and nccl)
        if self._mp is not None and self.program.graphed:
            # the sharded regions' masks draw afresh on every replay
            self.program._generators.append(
                self._mp.generator.generator(self._device))
        if zero_stage >= 3 and not hasattr(model, "_use_state"):
            raise TypeError("ZeRO-3 gathers a Layer's parameters a unit at "
                            "a time: the model must be an nn.Layer")
        self.transforms = transforms
        self.zero_stage = zero_stage
        self.exact_reshard = bool(exact_reshard)
        self.shard_seq = shard_seq
        self._cut = True
        if self.sp > 1:
            if not shard_seq:
                raise ValueError("a mesh with 'sp' > 1 needs shard_seq=True")
            if not getattr(getattr(model, "cfg", None),
                           "sequence_parallel", False):
                raise ValueError(
                    "a mesh with 'sp' > 1 cuts the sequence: the model "
                    "must be sequence parallel (GPTConfig("
                    "sequence_parallel=True | 'ring' | 'ulysses'))")

        fp16 = transforms.get("fp16_allreduce")
        if fp16 and (self.dp == 1 or return_outputs or zero_stage >= 3):
            warnings.warn("fp16_allreduce ignored: needs dp>1 and is "
                          "incompatible with ZeRO-3 / return_outputs")
            fp16 = None
        self.fp16_allreduce = bool(fp16)
        self._red_dtype = tfm.reduced_dtype(fp16.get("dtype")) \
            if fp16 else None

        params = [p for p in self.optimizer._parameters if p.requires_grad]
        self._broadcast_state(params, every)
        # the leaves this rank trains: its shard of each split parameter
        # (over 'mp'), the model's own leaf of every other
        self._shards_mp = tp.LocalShards(model, self._mp) \
            if self._mp is not None else None
        work = [self._shards_mp.working(p) for p in params] \
            if self._shards_mp is not None else params
        self._base_of = {id(w): p for w, p in zip(work, params)}
        self._split = {id(w) for w, p in zip(work, params) if w is not p}
        self._params = work
        mp_pg = self._mp.pg if self._mp is not None else None
        lay_dp = self.dp if zero_stage >= 1 else 1
        by_dtype = {}
        for p in work:
            by_dtype.setdefault(p.dtype, []).append(p)
        self._order = {id(p): (list(by_dtype).index(p.dtype), i)
                       for i, p in enumerate(work)}
        self._units = []
        if zero_stage >= 3:
            self._buckets = self._unit_buckets(model, work, lay_dp)
        else:
            self._buckets = [_Bucket(ps, lay_dp) for ps in by_dtype.values()]
        if zero_stage >= 1:
            self._build_shards()
        else:
            # the optimizer steps on views of the reduced bucket
            self._grad_views = {}
            for b in self._buckets:
                for p, v in zip(b.params, b.views(b.flat[0])):
                    self._grad_views[id(p)] = v[:p.numel()].view(p.shape)
            self._parts = _Parts(None, mp_pg, self._split)
            if self._shards_mp is not None:
                self._stepper = make_stepper(self.optimizer, work,
                                             self._parts)
                self._seed_state()
        # the gradient-merge accumulators, like the grads they merge: the
        # working leaves', or ZeRO-3's chunks
        like = self._chunk_leaves if zero_stage >= 3 else work
        self._acc = tfm.init_grad_acc([t.detach() for t in like],
                                      self._k_merge)
        self._record_specs(model)
        self._whole = False
        if zero_stage >= 3:
            self._anchor = torch.zeros((), device=self._device,
                                       requires_grad=True)
            self._z3_live = self.z3_peak_units = 0
        self._release()

    # ---------------------------------------------------------- set-up
    @torch.no_grad()
    def _broadcast_state(self, params, groups):
        """Rank 0's parameters and buffers on every rank of the mesh."""
        bufs = [unwrap(b) for _, b in self.model.named_buffers()] \
            if hasattr(self.model, "named_buffers") else []
        for pg in groups:
            for t in list(params) + [b for b in bufs if b is not None]:
                collective.broadcast_(t.data, 0, pg)

    def _unit_buckets(self, model, work, dp):
        """ZeRO-3's units (`_unit_layers` and the root, the model itself,
        holding every parameter no single unit holds) and their buckets,
        one a (unit, dtype)."""
        names = {id(unwrap(w)): n for n, w in model.named_parameters()}
        layers = _unit_layers(model)
        seen = {}
        for layer, _, _ in layers:
            for p in layer.parameters():
                seen[id(p)] = seen.get(id(p), 0) + 1
        units = [_Unit(layer, pre, rc) for layer, pre, rc in layers]
        root = _Unit(model, "", False)
        held, wrappers = {}, dict(model.named_parameters())
        for w in work:
            n = names[id(self._base_of[id(w)])]
            u = next((u for u in units if n.startswith(u.prefix + ".")),
                     None)
            if u is None or seen.get(id(wrappers[n]), 0) != 1:
                u = root
            held.setdefault(id(u), []).append(w)
            u.names.append(n[len(u.prefix) + 1:] if u.prefix else n)
            u.keys.append(id(w))
        buckets = []
        for u in [root] + units:
            by_dtype = {}
            for w in held.get(id(u), ()):
                by_dtype.setdefault(w.dtype, []).append(w)
            for ps in by_dtype.values():
                u.buckets.append(len(buckets))
                buckets.append(_Bucket(ps, dp, flat=False))
            if u.keys:
                self._units.append(u)
        self._root = root if root.keys else None
        return buckets

    def _build_shards(self):
        """The rank's flat shard of every bucket, its leaf chunks (in
        ZeRO-1's order: by dtype, then the model's) and the copy of the
        optimizer that steps on them."""
        base = self.optimizer
        r = self._dp_index()
        z3 = self.zero_stage >= 3
        self._shards, entries = [], []
        for bi, b in enumerate(self._buckets):
            shard = torch.zeros(b.width, dtype=b.dtype, device=b.device)
            full = torch.zeros((b.dp, b.width), dtype=b.dtype,
                               device=b.device)
            b.pack([p.detach() for p in b.params], into=full)
            shard.copy_(full[r])
            if z3:
                full = None     # ZeRO-3 gathers into buffers of its own
            else:
                full.zero_()
            gshard = torch.zeros_like(shard)
            self._shards.append((shard, full, gshard))
            for k, (p, v, g) in enumerate(zip(b.params, b.views(shard),
                                              b.views(gshard))):
                leaf = v.detach().requires_grad_(True)
                for attr in ("regularizer", "learning_rate"):
                    if hasattr(p, attr):
                        setattr(leaf, attr, getattr(p, attr))
                leaf.grad = g
                entries.append((self._order[id(p)], bi, k, p, leaf, g))
        entries.sort(key=lambda e: e[0])
        self._entries = [e[1:] for e in entries]
        self._chunk_leaves = [e[4] for e in entries]
        self._shard_grads = [e[5] for e in entries]
        self._numels = {id(e[4]): self._buckets[e[1]].numels[e[2]]
                        for e in entries}
        split = {id(e[4]) for e in entries if id(e[3]) in self._split}
        if self.dp > 1 and isinstance(base, Dpsgd) and base._sigma:
            raise NotImplementedError(
                f"ZeRO-{self.zero_stage} over dp > 1 with Dpsgd(sigma > "
                f"0): every rank would draw the same noise for its chunks")
        mp_pg = self._mp.pg if self._mp is not None else None
        if self.exact_reshard:
            self._parts = _Parts(None, mp_pg, split,
                                 gather=self._gather_chunks)
        else:
            self._parts = _Parts(self._dp_group if self.dp > 1 else None,
                                 mp_pg, split)
        self._stepper = make_stepper(self.optimizer, self._chunk_leaves,
                                     self._parts)
        self._seed_state()

    def _local(self, w, full_t):
        """The rank's part over 'mp' of a full tensor laid out as the
        working leaf `w`'s parameter."""
        if id(w) not in self._split:
            return full_t
        name = self._shards_mp.name_of(self._base_of[id(w)])
        return tp.shard_tensor(full_t, self._shards_mp.wrapper(name),
                               self._mp.rank, self._mp.size)

    @torch.no_grad()
    def _seed_state(self):
        """The rank's part (its mp shard; its ZeRO chunk of that) of
        every state slot the optimizer already holds (a resumed run)."""
        base, opt = self.optimizer, self._stepper
        index = {id(p): i for i, p in enumerate(base._parameters)}
        if self.zero_stage < 1:
            for j, w in enumerate(self._params):
                st = base._state.get(index[id(self._base_of[id(w)])])
                if st:
                    mine = opt._ensure_state(j)
                    for name, full_t in st.items():
                        mine[name].copy_(self._local(w, full_t))
            opt._global_step = base._global_step
            return
        r = self._dp_index()
        for j, (bi, k, p, _, _) in enumerate(self._entries):
            b = self._buckets[bi]
            st = base._state.get(index[id(self._base_of[id(p)])])
            if st:
                mine = opt._ensure_state(j)
                for name, full_t in st.items():
                    part = self._local(p, full_t)
                    tmp = torch.zeros((b.dp, b.width), dtype=part.dtype,
                                      device=b.device)
                    for dst, src, shape in b.regions(k, tmp):
                        dst.copy_(part.reshape(-1)[src].view(shape))
                    off = b.offsets[k]
                    mine[name].copy_(tmp[r, off:off + b.chunks[k]])
        opt._global_step = base._global_step

    def _dp_index(self):
        return self.mesh.axis_index(self.dp_axis) if self.dp > 1 else 0

    def _record_specs(self, model):
        named = dict(model.named_parameters()) \
            if hasattr(model, "named_parameters") else {}
        self.param_specs, self.opt_specs = {}, {}
        for n, w in named.items():
            leaf = unwrap(w)
            shape = tp.full_shape(leaf)
            hint = getattr(w, "sharding", None)
            spec = mesh_mod.PartitionSpec(*[
                a if a in self.mesh.axis_names and i < len(shape)
                and shape[i] % self.mesh.axis_size(a) == 0 else None
                for i, a in enumerate(hint or ())])
            if not any(spec):
                spec = mesh_mod.PartitionSpec()
            slots = self.optimizer._state_names + (
                ("master",) if self.optimizer._mp_param(leaf) else ())
            zspec = _zero_spec(shape, self.dp, self.dp_axis, spec) \
                if self.zero_stage >= 1 else spec
            self.param_specs[n] = zspec if self.zero_stage >= 3 else spec
            self.opt_specs[n] = {s: zspec for s in slots}

    def _release(self):
        """Free the full weights this rank holds only a part of: the
        split parameters' (over 'mp'); under ZeRO-3 every trained one,
        whose chunks are the rank's copy (again after a `sync()`)."""
        if self._shards_mp is not None:
            self._shards_mp.release()
        if self.zero_stage >= 3:
            for w in self._params:
                tp.release(w)
                tp.release(self._base_of[id(w)])

    def param_nbytes(self):
        """Bytes of parameter data this rank holds: the model's resident
        weights, its mp shards and its ZeRO chunks."""
        leaves = [unwrap(p) for p in self.model.parameters()]
        if self._shards_mp is not None:
            leaves += list(self._shards_mp.local.values())
        if self.zero_stage >= 1:
            leaves += [shard for shard, _, _ in self._shards]
        return tp.resident_nbytes(leaves)

    # ---------------------------------------------------------- ZeRO-3
    def _unit_forward(self, unit, orig):
        """The unit's forward inside this step (`_z3_scope` installs it):
        its full parameters gathered and swapped in, under
        `incubate.recompute` unless the model recomputes the unit
        itself."""
        def run(*args, **kwargs):
            full = _GatherUnit.apply(self._anchor, self, unit)
            with unit.layer._use_state(dict(zip(unit.names, full))):
                return orig(*args, **kwargs)

        def forward(*args, **kwargs):
            if unit.recomputed or not torch.is_grad_enabled():
                return run(*args, **kwargs)
            return recompute(functools.partial(run, **kwargs), *args)
        return forward

    @torch.no_grad()
    def _gather_row(self, bi, row):
        """Bucket `bi`'s full tensors, one a parameter, from every rank's
        [C] `row` (its shard of the weights, of the grads or of a state
        slot; collective over 'dp')."""
        b = self._buckets[bi]
        every = row.new_empty((b.dp, b.width))
        collective.all_gather_into(every, row, self._dp_group)
        outs = [row.new_empty(tp.full_shape(p)) for p in b.params]
        b.unpack(every, outs)
        return outs

    def _gather_full(self, bi):
        """Bucket `bi`'s full parameters, from every rank's shard."""
        return self._gather_row(bi, self._shards[bi][0])

    def _gather_chunks(self, xs, leaves):
        """exact_reshard's whole tensors (flat) of chunk leaves `leaves`
        from each rank's `xs` (their grads, weights or updates): one
        all-gather over 'dp' a dtype, exact, so what is computed from
        them does not depend on dp."""
        if self.dp == 1:
            return [x.reshape(-1)[:self._numels[id(p)]]
                    for x, p in zip(xs, leaves)]
        out, by = [None] * len(xs), {}
        for i, x in enumerate(xs):
            by.setdefault(x.dtype, []).append(i)
        for idx in by.values():
            row = torch.cat([xs[i].reshape(-1) for i in idx])
            every = row.new_empty((self.dp, row.numel()))
            collective.all_gather_into(every, row, self._dp_group)
            off = 0
            for i in idx:
                c = xs[i].numel()
                out[i] = every[:, off:off + c].reshape(-1)[
                    :self._numels[id(leaves[i])]]
                off += c
        return out

    def _z3_gather(self, unit):
        got = {}
        for bi in unit.buckets:
            for p, t in zip(self._buckets[bi].params, self._gather_full(bi)):
                got[id(p)] = t
        outs = [got[k] for k in unit.keys]
        # how many units' full parameters are alive at once (the most
        # since construction: `z3_peak_units`)
        self._z3_live += 1
        self.z3_peak_units = max(self.z3_peak_units, self._z3_live)
        weakref.finalize(outs[0], self._z3_freed)
        return outs

    def _z3_freed(self):
        self._z3_live -= 1

    @torch.no_grad()
    def _z3_scatter(self, unit, grads):
        by = dict(zip(unit.keys, grads))
        for bi in unit.buckets:
            b = self._buckets[bi]
            flat = torch.zeros((b.dp, b.width), dtype=b.dtype,
                               device=b.device)
            b.pack([by[id(p)] for p in b.params], into=flat)
            if self._sp_group is not None:
                all_reduce_(flat, ReduceOp.SUM, self._sp_group)
            gshard = self._shards[bi][2]
            if self._whole:
                # exact_reshard's whole batch: the rank's chunk as it is
                part = flat[self._dp_index()]
            else:
                part = torch.empty_like(gshard) if unit.written else gshard
                collective.reduce_scatter_into(part, flat.view(-1),
                                               self._dp_group)
            if unit.written:            # a unit run twice in one step
                gshard.add_(part)
            elif part is not gshard:
                gshard.copy_(part)
        unit.written = True

    @contextlib.contextmanager
    def _z3_scope(self):
        """The step's forward and backward under ZeRO-3: the units'
        gathering forwards installed on their layers (and taken off
        after: the model keeps no reference to the step), the root unit
        gathered and swapped in for both."""
        if self.zero_stage < 3:
            yield
            return
        units = [u for u in self._units if u.layer is not self.model]
        own = [vars(u.layer).get("forward") for u in units]
        for u in self._units:
            u.written = False
        for u in units:
            u.layer.forward = self._unit_forward(u, u.layer.forward)
        try:
            root = self._root
            if root is None:
                yield
            else:
                full = _GatherUnit.apply(self._anchor, self, root)
                with self.model._use_state(dict(zip(root.names, full))):
                    yield
        finally:
            for u, f in zip(units, own):
                if f is None:
                    del u.layer.forward
                else:
                    u.layer.forward = f

    # ------------------------------------------------------------- step
    def shard_batch(self, arrs):
        """This rank's part of each global-batch tensor (views). A tensor
        whose dim 0 'dp' does not divide stays whole."""
        m = self.mesh
        dpi = self._dp_index()
        spi = m.axis_index(mesh_mod.SP_AXIS) if self.sp > 1 else 0
        out = []
        for a in arrs:
            t = unwrap(a)
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                out.append(a)
                continue
            if t.shape[0] % self.dp == 0 and self.dp > 1:
                n = t.shape[0] // self.dp
                t = t[dpi * n:(dpi + 1) * n]
            elif self.dp > 1:
                self._cut = False
            if self.sp > 1 and t.dim() >= 2:
                if t.shape[1] % self.sp:
                    raise ValueError(
                        f"sequence dim {t.shape[1]} of a {tuple(t.shape)} "
                        f"input does not divide over sp={self.sp}")
                n = t.shape[1] // self.sp
                t = t[:, spi * n:(spi + 1) * n]
            out.append(Tensor._wrap(t) if isinstance(a, Tensor) else t)
        return tuple(out)

    def __call__(self, inputs, labels):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        self._release()
        self._cut = True
        args = self.shard_batch(inputs), self.shard_batch(labels)
        out = super().__call__(*args)
        # the step count lives on the optimizer (save_steps, checkpoints)
        self.optimizer._global_step = self._stepper._global_step
        return out

    def _reduce(self, bucket, gshard=None, dp=True):
        """Sum the bucket over 'sp' and 'dp' (ZeRO-0: all-reduces, in
        place) or over 'sp' and then reduce-scatter it over 'dp' into
        `gshard` (ZeRO-1), in the fp16_allreduce dtype when asked.
        `dp=False`: over 'sp' alone (an exact_reshard step's whole
        batch: ZeRO-1 takes the rank's row as it is)."""
        t = bucket.flat
        low = self._red_dtype
        work = t.to(low) if low is not None else t
        if self._sp_group is not None:
            all_reduce_(work, ReduceOp.SUM, self._sp_group)
        if gshard is not None:
            out = gshard
            if not dp:
                out.copy_(work[self._dp_index()])
                return
            dst = out.to(low) if low is not None else out
            collective.reduce_scatter_into(dst, work.view(-1),
                                           self._dp_group)
            if low is not None:
                out.copy_(dst)
        else:
            if dp:
                all_reduce_(work, ReduceOp.SUM, self._dp_group)
            if low is not None:
                t.copy_(work)

    def _scope(self):
        """The model on the rank's mp shards (nothing without 'mp')."""
        if self._shards_mp is None:
            return contextlib.nullcontext()
        return self._shards_mp.scope()

    def _step(self, args, n_in, apply=True):
        # the rank's shards hold grads the optimizer's own leaves do not
        for p in self._params:
            p.grad = None
        out = super()._step(args, n_in, apply)
        for p in self._params:
            p.grad = None
        return out

    def _merge_grads(self, apply):
        leaves = self._chunk_leaves if self.zero_stage >= 3 \
            else self._params
        live = [(a, p) for a, p in zip(self._acc, leaves)
                if p.grad is not None]
        merged = tfm.merged_update([a for a, _ in live],
                                   [p.grad for _, p in live], self._k_merge,
                                   self._merge_avg, apply)
        if merged is None:
            return False
        for (_, p), g in zip(live, merged):
            if self.zero_stage >= 3:
                p.grad.copy_(g)         # the chunk grads are the bucket's
            else:
                p.grad = g
        return True

    def _run(self, inputs, labels, apply=True):
        # an exact_reshard step's undivided batch: whole on every rank,
        # its loss and gradients already the global ones
        whole = self._whole = self.exact_reshard and self.dp > 1 \
            and not self._cut
        # the backward runs in the scopes too: a recomputed block reads
        # the shards (and gathers its unit) again
        with self._scope(), self._z3_scope():
            with loss_scope(self.mesh, cut_dp=not whole) as scope:
                loss, outs = self._forward_loss(inputs, labels)
                share = unwrap(loss)
                if not scope.declared:
                    share = share / ((1 if whole else self.dp) * self.sp)
            share.backward()
        total = share.detach().clone()
        for pg in self._groups:
            if not (whole and pg is self._dp_group):
                all_reduce_(total, ReduceOp.SUM, pg)
        if self.zero_stage >= 3:
            for u in self._units:
                if not u.written:        # a unit the step did not run
                    for bi in u.buckets:
                        self._shards[bi][2].zero_()
            if self._k_merge > 1 and not self._merge_grads(apply):
                self._sentinel(total)
            else:
                self._sentinel(total, self._shard_grads,
                               self._chunk_leaves)
                self._stepper.step()
        else:
            if self._k_merge > 1 and not self._merge_grads(apply):
                self._sentinel(total)
                return self._kind(loss, total), tuple(o.detach()
                                                      for o in outs)
            self._update_zero01(total, whole)
        return self._kind(loss, total), tuple(o.detach() for o in outs)

    def _update_zero01(self, total, whole):
        for b in self._buckets:
            b.pack([p.grad for p in b.params])
        if self.zero_stage >= 1:
            for b, (_, _, gshard) in zip(self._buckets, self._shards):
                self._reduce(b, gshard, dp=not whole)
            self._sentinel(total, self._shard_grads, self._chunk_leaves)
            self._stepper.step()
            for b, (shard, full, gshard) in zip(self._buckets, self._shards):
                collective.all_gather_into(full, shard, self._dp_group)
                with torch.no_grad():
                    b.unpack(full, [p.detach() for p in b.params])
        else:
            for b in self._buckets:
                self._reduce(b, dp=not whole)
            for p in self._params:
                p.grad = self._grad_views[id(p)]
            self._sentinel(total, [p.grad for p in self._params],
                           self._params)
            self._stepper.step()

    @staticmethod
    def _kind(loss, total):
        return Tensor._wrap(total) if isinstance(loss, Tensor) else total

    def _sentinel(self, loss, grads=None, leaves=None):
        self._last_grad_norm, self._last_nonfinite = grad_sentinel(
            self._parts, loss, grads, leaves)

    # -------------------------------------------------------- state
    def _full(self, w, t):
        """A working leaf's tensor `t` as the full logical tensor (every
        mp shard gathered; collective over the slice)."""
        if id(w) not in self._split:
            return t
        name = self._shards_mp.name_of(self._base_of[id(w)])
        return tp.gather_tensor(t, self._shards_mp.wrapper(name), self._mp)

    def _working_states(self):
        """id(working leaf) -> {slot: its state, the working leaf's
        shape} (under ZeRO >= 1 gathered from the ranks' chunks over
        'dp')."""
        opt = self._stepper
        if self.zero_stage < 1:
            return {id(w): dict(opt._state.get(j, {}))
                    for j, w in enumerate(self._params)}
        slot = {(bi, k): j for j, (bi, k, _, _, _) in enumerate(self._entries)}
        out = {}
        for bi, (b, (shard, _, _)) in enumerate(zip(self._buckets,
                                                    self._shards)):
            slots = {}
            for k in range(len(b.params)):
                for name, t in opt._state.get(slot[(bi, k)], {}).items():
                    slots.setdefault(name, t.dtype)
            for p in b.params:
                out.setdefault(id(p), {})
            for name, dtype in slots.items():
                row = torch.zeros(b.width, dtype=dtype, device=shard.device)
                for k, v in enumerate(b.views(row)):
                    st = opt._state.get(slot[(bi, k)])
                    if st and name in st:
                        v.copy_(st[name])
                for p, t in zip(b.params, self._gather_row(bi, row)):
                    out[id(p)][name] = t
        return out

    @torch.no_grad()
    def sync(self):
        """Write the state back into the model and the optimizer: every
        mp shard's full tensor into the model's parameter (under ZeRO-3,
        every parameter, gathered from the chunks; a released weight
        gets its storage back until the next call), and every moment
        (and master) of the rank's chunks and shards, gathered, into the
        optimizer's own state, with its step count (collective: every
        rank calls it). Without 'mp' and ZeRO the model and the
        optimizer hold the state already."""
        if self.zero_stage >= 3:
            shards = {}
            for bi, b in enumerate(self._buckets):
                for p, t in zip(b.params, self._gather_full(bi)):
                    if id(p) in self._split:
                        shards[self._shards_mp.name_of(
                            self._base_of[id(p)])] = t
                    else:
                        tp.restore(self._base_of[id(p)], t)
            if self._shards_mp is not None:
                self._shards_mp.gather(shards)
        elif self._shards_mp is not None:
            self._shards_mp.gather()
        base = self.optimizer
        if self._stepper is base:
            return
        index = {id(p): i for i, p in enumerate(base._parameters)}
        states = self._working_states()
        for w in self._params:
            dst = base._ensure_state(index[id(self._base_of[id(w)])])
            for name, t in states[id(w)].items():
                t = self._full(w, t)
                if name in dst and dst[name].shape == t.shape:
                    dst[name].copy_(t)      # a captured graph holds it
                else:
                    dst[name] = t.clone()
        base._global_step = self._stepper._global_step

    @torch.no_grad()
    def last_grads(self):
        """name -> the full logical gradient of the latest update, summed
        over the batch's groups (before any clip): gathered from the
        ranks' ZeRO chunks and mp shards (collective: every rank calls
        it)."""
        names = {id(unwrap(w)): n for n, w in self.model.named_parameters()}
        out = {}
        for i, b in enumerate(self._buckets):
            if self.zero_stage >= 1:
                parts = self._gather_row(i, self._shards[i][2])
            else:
                parts = [torch.empty_like(p) for p in b.params]
                b.unpack(b.flat, parts)
            for w, t in zip(b.params, parts):
                out[names[id(self._base_of[id(w)])]] = self._full(w, t)
        return out

    def shard_nbytes(self):
        """Bytes of optimizer state this rank holds (its chunks under
        ZeRO >= 1, its mp shards; all of it under ZeRO-0 without
        'mp')."""
        return int(sum(t.numel() * t.element_size()
                       for st in self._stepper._state.values()
                       for t in st.values()))

    def sharding_state(self):
        """The placement record (`Model.save`'s .pdtrain provenance): the
        mesh, the dp axis, the ZeRO stage, exact_reshard and the
        per-leaf specs (the JAX package's placements: under ZeRO-3 the
        parameters' specs carry 'dp' as the moments' do; the port's ZeRO
        layout is the flat rank-major chunks, its 'mp' shards each
        rank's part of the split parameters; `save` after `sync()`
        writes full tensors)."""
        return {
            "mesh": dict(self.mesh.shape),
            "dp_axis": self.dp_axis,
            "zero_stage": int(self.zero_stage),
            "exact_reshard": bool(self.exact_reshard),
            "layout": "flat rank-major chunks" if self.zero_stage >= 1
            else "replicated",
            "mp_split": sorted(self._shards_mp.local)
            if self._shards_mp is not None else [],
            "param_specs": {n: _spec_doc(s)
                            for n, s in self.param_specs.items()},
            "opt_specs": {n: {sn: _spec_doc(s) for sn, s in slots.items()}
                          for n, slots in self.opt_specs.items()},
        }
