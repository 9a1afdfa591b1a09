"""ShardedTrainStep, the data- and sequence-parallel train step (the
port of `paddle_tpu/distributed/sharded.py`).

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
    optimizer holding state takes the rank's chunk of it.

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

On a card whose groups are NCCL, the step is one CUDA graph per input
signature (`graphs.Program`, as `jit.TrainStep`), collectives included;
with a gloo group it runs eagerly. Each rank's model is built from the
same seed; the step broadcasts rank 0's parameters over the mesh at
construction all the same. Buffers (BatchNorm's statistics) stay the
rank's own: cross-card BatchNorm is ROADMAP Queue 1 item 5c.

Refused, naming ROADMAP Queue 1 item 5b: zero_stage 3, exact_reshard,
and a mesh with 'mp' or 'pp' (or any axis but 'dp' and 'sp') above 1.
The flight-recorder instrumentation and the chaos points wait for item
6.
"""
import contextlib
import copy
import functools
import warnings

import numpy as np
import torch

from ..framework.tensor import Tensor, unwrap
from ..jit import TrainStep, transforms as tfm
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from ..optimizer import Dpsgd
from . import collective
from . import mesh as mesh_mod
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
def loss_scope(mesh=None):
    """The loss functions inside the block give this rank's share of the
    global loss over the mesh's 'dp' and 'sp' (as inside a
    ShardedTrainStep): for a forward and backward of one's own, e.g.

        with loss_scope():
            share = gpt_pretrain_loss(model(ids_shard), ids_shard)
        share.backward()     # then sum the loss and the grads over the
                             # mesh: they are the global batch's

    Yields the scope; its `declared` says whether the loss called
    `global_mean` (else its share is loss / (dp x sp)). ShardedTrainStep
    runs its forward in one."""
    m = mesh or mesh_mod.get_mesh()
    groups = [m.group(a) for a in (mesh_mod.DP_AXIS, mesh_mod.SP_AXIS)
              if a in m.axis_names and m.axis_size(a) > 1]
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


def _refuse(what):
    raise NotImplementedError(
        f"ShardedTrainStep: {what} is not ported yet (ROADMAP Queue 1 "
        f"item 5b)")


class _Bucket:
    """The flat gradient bucket of the parameters of one dtype, laid
    out rank-major over `dp` chunks (ZeRO-1) or as the parameters
    end to end (`dp` = 1 layout: every slot 16-element aligned)."""

    def __init__(self, params, dp):
        self.params = params
        self.dp = dp
        self.numels = [p.numel() for p in params]
        self.chunks = [_roundup(-(-n // dp), _ALIGN) for n in self.numels]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.chunks)[:-1]]).astype(int).tolist()
        self.width = int(sum(self.chunks))         # C, one rank's chunks
        p0 = params[0]
        self.flat = torch.zeros((dp, self.width), dtype=p0.dtype,
                                device=p0.device)

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

    def pack(self, grads):
        """Each grad (or zeros for None) into its chunks of the bucket."""
        for i, g in enumerate(grads):
            for dst, src, shape in self.regions(i, self.flat):
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


class _ShardedGlobalNorm(ClipGradByGlobalNorm):
    """Global-norm clipping over ZeRO chunks: the squares summed over
    the rank's chunks, then over 'dp'."""

    def __init__(self, clip, pg):
        super().__init__(clip.clip_norm, clip.group_name)
        self._pg = pg

    def _scale(self, grads):
        sq = torch.stack([torch.sum(torch.square(g.float()))
                          for g in grads]).sum()
        all_reduce_(sq, ReduceOp.SUM, self._pg)
        return self.clip_norm / torch.clamp(torch.sqrt(sq),
                                            min=self.clip_norm)


class _ShardedNorm(ClipGradByNorm):
    """Per-tensor clipping over ZeRO chunks: each chunk's squares summed
    over 'dp' (one all-reduce of the vector)."""

    def __init__(self, clip, pg):
        super().__init__(clip.clip_norm)
        self._pg = pg

    def __call__(self, params_grads):
        live = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        if not live:
            return params_grads
        sq = torch.stack([torch.sum(torch.square(params_grads[i][1].float()))
                          for i in live])
        all_reduce_(sq, ReduceOp.SUM, self._pg)
        scale = torch.clamp(self.clip_norm / torch.clamp(torch.sqrt(sq),
                                                         min=1e-12), max=1.0)
        out = list(params_grads)
        for j, i in enumerate(live):
            p, g = out[i]
            out[i] = (p, g * scale[j].to(g.dtype))
        return out


def _sharded_clip(clip, pg):
    if clip is None or isinstance(clip, ClipGradByValue):
        return clip
    if isinstance(clip, ClipGradByGlobalNorm):
        return _ShardedGlobalNorm(clip, pg)
    if isinstance(clip, ClipGradByNorm):
        return _ShardedNorm(clip, pg)
    raise NotImplementedError(f"ZeRO-1 with grad_clip "
                              f"{type(clip).__name__}")


def _dp_norms(pg, xs):
    """Per tensor, the L2 norm of the whole tensor from this rank's
    chunks of it: the chunks' squares summed over 'dp' (one all-reduce
    of the vector), in f64 on the CPU as `optimizer._norms` sums."""
    if xs[0].is_cuda:
        sq = torch.stack(torch._foreach_norm(xs)).square()
    else:
        sq = torch.stack(torch._foreach_norm(
            xs, 2, dtype=torch.float64)).square()
    all_reduce_(sq, ReduceOp.SUM, pg)
    return torch.sqrt(sq).float()


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


def _spec_doc(spec):
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


class ShardedTrainStep(TrainStep):
    """Data- (and sequence-) parallel train step over the current mesh:

        make_mesh({'dp': 2})
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
        if zero_stage >= 3:
            _refuse("zero_stage=3 (parameter sharding)")
        if exact_reshard:
            _refuse("exact_reshard")
        self.mesh = mesh or mesh_mod.get_mesh() or mesh_mod.default_mesh()
        m = self.mesh
        for ax, size in m.shape.items():
            if size > 1 and ax not in (mesh_mod.DP_AXIS, mesh_mod.SP_AXIS):
                _refuse(f"a mesh with {ax!r} = {size} (tensor, pipeline "
                        f"or other model parallelism)")
        # the batch axis: 'dp', else the mesh's first axis that is not
        # 'sp' (a mesh of 'sp' alone has no data parallelism)
        self.dp_axis = dp_axis or next(
            (a for a in (mesh_mod.DP_AXIS,) + m.axis_names
             if a in m.axis_names and a != mesh_mod.SP_AXIS), None)
        if remat and transforms.get("recompute") is None:
            transforms["recompute"] = {}
        self.dp = m.axis_size(self.dp_axis) if self.dp_axis else 1
        # a world of one rank keeps its group: its collectives run (and
        # are captured) on one card
        self._dp_group = m.group(self.dp_axis) if self.dp_axis else None
        self.sp = m.axis_size(mesh_mod.SP_AXIS)
        self._sp_group = m.group(mesh_mod.SP_AXIS) if self.sp > 1 else None
        self._groups = [g for g in (self._dp_group, self._sp_group)
                        if g is not None]
        # one CUDA graph a signature when every group is NCCL; a gloo
        # collective cannot be captured
        nccl = all(torch.distributed.get_backend(g) == "nccl"
                   for g in self._groups)
        super().__init__(model, loss_fn, optimizer, donate=donate,
                         return_outputs=return_outputs,
                         cuda_graph=cuda_graph and nccl)
        self.transforms = transforms
        self.zero_stage = zero_stage
        self.exact_reshard = False
        self.shard_seq = shard_seq
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
        if fp16 and (self.dp == 1 or return_outputs):
            warnings.warn("fp16_allreduce ignored: needs dp>1 and is "
                          "incompatible with return_outputs")
            fp16 = None
        self.fp16_allreduce = bool(fp16)
        self._red_dtype = tfm.reduced_dtype(fp16.get("dtype")) \
            if fp16 else None

        params = [p for p in self.optimizer._parameters if p.requires_grad]
        self._params = params
        self._broadcast_state(params)
        lay_dp = self.dp if zero_stage >= 1 else 1
        by_dtype = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        self._buckets = [_Bucket(ps, lay_dp) for ps in by_dtype.values()]
        if zero_stage >= 1:
            self._build_shards()
        else:
            # the optimizer steps on views of the reduced bucket
            self._grad_views = {}
            for b in self._buckets:
                for p, v in zip(b.params, b.views(b.flat[0])):
                    self._grad_views[id(p)] = v[:p.numel()].view(p.shape)
        self._record_specs(model)

    # ---------------------------------------------------------- set-up
    @torch.no_grad()
    def _broadcast_state(self, params):
        """Rank 0's parameters and buffers on every rank of the mesh."""
        bufs = [unwrap(b) for _, b in self.model.named_buffers()] \
            if hasattr(self.model, "named_buffers") else []
        for pg in self._groups:
            for t in list(params) + [b for b in bufs if b is not None]:
                collective.broadcast_(t.data, 0, pg)

    def _build_shards(self):
        """The rank's flat shard of every bucket, its leaf chunks and the
        copy of the optimizer that steps on them."""
        base = self.optimizer
        r = self._dp_index()
        self._shards, leaves, grads = [], [], []
        for b in self._buckets:
            shard = b.flat.new_zeros(b.width)
            full = b.flat.new_zeros((b.dp, b.width))
            b.pack([p.detach() for p in b.params])
            full.copy_(b.flat)
            shard.copy_(full[r])
            b.flat.zero_()
            gshard = b.flat.new_zeros(b.width)
            self._shards.append((shard, full, gshard))
            for p, v, g in zip(b.params, b.views(shard), b.views(gshard)):
                leaf = v.detach().requires_grad_(True)
                for attr in ("regularizer", "learning_rate"):
                    if hasattr(p, attr):
                        setattr(leaf, attr, getattr(p, attr))
                leaf.grad = g
                leaves.append(leaf)
                grads.append(g)
        self._shard_grads = grads
        if self.dp > 1 and isinstance(base, Dpsgd) and base._sigma:
            raise NotImplementedError(
                "ZeRO-1 over dp > 1 with Dpsgd(sigma > 0): every rank "
                "would draw the same noise for its chunks")
        opt = copy.copy(base)
        opt._parameters = leaves
        opt._state = {}
        opt._scalars = None
        opt._grad_clip = _sharded_clip(base._grad_clip, self._dp_group)
        # one learning rate: set_lr, a schedule or fleet.set_lr on the
        # optimizer reach the copy
        opt.get_lr, opt.set_lr = base.get_lr, base.set_lr
        if self.dp > 1:
            opt._tensor_norms = functools.partial(_dp_norms, self._dp_group)
        self._stepper = opt
        self._seed_state()

    @torch.no_grad()
    def _seed_state(self):
        """The rank's chunk of every state slot the optimizer already
        holds (a resumed run)."""
        base, opt = self.optimizer, self._stepper
        index = {id(p): i for i, p in enumerate(base._parameters)}
        r = self._dp_index()
        j = 0
        for b in self._buckets:
            for k, p in enumerate(b.params):
                st = base._state.get(index[id(p)])
                if st:
                    mine = opt._ensure_state(j)
                    for name, full_t in st.items():
                        tmp = b.flat.new_zeros((b.dp, b.width),
                                               dtype=full_t.dtype)
                        for dst, src, shape in b.regions(k, tmp):
                            dst.copy_(full_t.reshape(-1)[src].view(shape))
                        off = b.offsets[k]
                        mine[name].copy_(tmp[r, off:off + b.chunks[k]])
                j += 1
        opt._global_step = base._global_step

    def _dp_index(self):
        return self.mesh.axis_index(self.dp_axis) if self.dp > 1 else 0

    def _record_specs(self, model):
        named = dict(model.named_parameters()) \
            if hasattr(model, "named_parameters") else {}
        self.param_specs, self.opt_specs = {}, {}
        for n, w in named.items():
            leaf = unwrap(w)
            hint = getattr(w, "sharding", None)
            spec = mesh_mod.PartitionSpec(*[
                a if a in self.mesh.axis_names and i < leaf.dim()
                and leaf.shape[i] % self.mesh.axis_size(a) == 0 else None
                for i, a in enumerate(hint or ())])
            if not any(spec):
                spec = mesh_mod.PartitionSpec()
            self.param_specs[n] = spec
            slots = self.optimizer._state_names + (
                ("master",) if self.optimizer._mp_param(leaf) else ())
            zspec = _zero_spec(tuple(leaf.shape), self.dp, self.dp_axis,
                               spec) if self.zero_stage >= 1 else spec
            self.opt_specs[n] = {s: zspec for s in slots}

    # ------------------------------------------------------------- step
    def shard_batch(self, arrs):
        """This rank's part of each global-batch tensor (views)."""
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
        out = super().__call__(self.shard_batch(inputs),
                               self.shard_batch(labels))
        # the step count lives on the optimizer (save_steps, checkpoints)
        self.optimizer._global_step = self._stepper._global_step
        return out

    def _reduce(self, bucket, gshard=None):
        """Sum the bucket over 'sp' and 'dp' (ZeRO-0: all-reduces, in
        place) or over 'sp' and then reduce-scatter it over 'dp' into
        `gshard` (ZeRO-1), in the fp16_allreduce dtype when asked."""
        t = bucket.flat
        low = self._red_dtype
        work = t.to(low) if low is not None else t
        if self._sp_group is not None:
            all_reduce_(work, ReduceOp.SUM, self._sp_group)
        if gshard is not None:
            out = gshard
            dst = out.to(low) if low is not None else out
            collective.reduce_scatter_into(dst, work.view(-1),
                                           self._dp_group)
            if low is not None:
                out.copy_(dst)
        else:
            all_reduce_(work, ReduceOp.SUM, self._dp_group)
            if low is not None:
                t.copy_(work)

    def _run(self, inputs, labels, apply=True):
        with loss_scope(self.mesh) as scope:
            loss, outs = self._forward_loss(inputs, labels)
            share = unwrap(loss)
            if not scope.declared:
                share = share / (self.dp * self.sp)
        share.backward()
        total = share.detach().clone()
        for pg in self._groups:
            all_reduce_(total, ReduceOp.SUM, pg)
        if self._k_merge > 1 and not self._merge_grads(apply):
            self._sentinel(total)
            return self._kind(loss, total), tuple(o.detach() for o in outs)
        for b in self._buckets:
            b.pack([p.grad for p in b.params])
        if self.zero_stage >= 1:
            for b, (_, _, gshard) in zip(self._buckets, self._shards):
                self._reduce(b, gshard)
            self._sentinel(total, self._shard_grads, self._dp_group)
            self._stepper.step()
            for b, (shard, full, gshard) in zip(self._buckets, self._shards):
                collective.all_gather_into(full, shard, self._dp_group)
                with torch.no_grad():
                    b.unpack(full, [p.detach() for p in b.params])
        else:
            for b in self._buckets:
                self._reduce(b)
            for p in self._params:
                p.grad = self._grad_views[id(p)]
            self._sentinel(total, [p.grad for p in self._params])
            self.optimizer.step()
        return self._kind(loss, total), tuple(o.detach() for o in outs)

    @staticmethod
    def _kind(loss, total):
        return Tensor._wrap(total) if isinstance(loss, Tensor) else total

    def _sentinel(self, loss, grads=None, pg=None):
        """(grad norm, non-finite) of the reduced grads (of the shards,
        summed over 'dp', under ZeRO-1)."""
        if grads:
            gsq = torch.stack(torch._foreach_norm(
                grads, 2, dtype=torch.float32)).square().sum()
            all_reduce_(gsq, ReduceOp.SUM, pg)
        else:
            gsq = torch.zeros((), device=loss.device)
        self._last_grad_norm = torch.sqrt(gsq)
        self._last_nonfinite = torch.logical_not(
            torch.isfinite(loss) & torch.isfinite(gsq))

    # -------------------------------------------------------- state
    @torch.no_grad()
    def sync(self):
        """Write the state back into the optimizer: under ZeRO-1 every
        moment (and master) gathered from the ranks' chunks into the
        optimizer's own state, and its step count (collective: every
        rank calls it). The parameters are the model's own already."""
        if self.zero_stage < 1:
            return
        base, opt = self.optimizer, self._stepper
        index = {id(p): i for i, p in enumerate(base._parameters)}
        j = 0
        for b, (shard, _, _) in zip(self._buckets, self._shards):
            slots = {}
            for k in range(len(b.params)):
                for name, t in opt._state.get(j + k, {}).items():
                    slots.setdefault(name, t.dtype)
            for name, dtype in slots.items():
                row = torch.zeros(b.width, dtype=dtype, device=shard.device)
                for k, v in enumerate(b.views(row)):
                    st = opt._state.get(j + k)
                    if st and name in st:
                        v.copy_(st[name])
                every = row.new_zeros((b.dp, b.width))
                collective.all_gather_into(every, row, self._dp_group)
                for k, p in enumerate(b.params):
                    dst = base._ensure_state(index[id(p)])
                    t = torch.empty(p.shape, dtype=dtype, device=p.device)
                    flat = t.view(-1)
                    for src, sl, shape in b.regions(k, every):
                        flat[sl].view(shape).copy_(src)
                    if name in dst and dst[name].shape == t.shape:
                        dst[name].copy_(t)      # a captured graph holds it
                    else:
                        dst[name] = t
            j += len(b.params)
        base._global_step = opt._global_step

    def shard_nbytes(self):
        """Bytes of optimizer state this rank holds (its chunks under
        ZeRO-1; all of it under ZeRO-0)."""
        return int(sum(t.numel() * t.element_size()
                       for st in self._stepper._state.values()
                       for t in st.values()))

    def sharding_state(self):
        """The placement record (`Model.save`'s .pdtrain provenance): the
        mesh, the dp axis, the ZeRO stage and the per-leaf specs (the
        JAX package's placements; the port's ZeRO-1 layout is the flat
        rank-major chunks)."""
        return {
            "mesh": dict(self.mesh.shape),
            "dp_axis": self.dp_axis,
            "zero_stage": int(self.zero_stage),
            "exact_reshard": False,
            "layout": "flat rank-major chunks" if self.zero_stage >= 1
            else "replicated",
            "param_specs": {n: _spec_doc(s)
                            for n, s in self.param_specs.items()},
            "opt_specs": {n: {sn: _spec_doc(s) for sn, s in slots.items()}
                          for n, slots in self.opt_specs.items()},
        }
