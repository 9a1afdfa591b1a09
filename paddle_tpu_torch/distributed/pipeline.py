"""Pipeline parallelism (the port of `paddle_tpu/distributed/pipeline.py`;
ref fluid/optimizer.py:3718 PipelineOptimizer, framework/section_worker.cc
and pipeline_trainer.cc, fluid.device_guard).

The JAX package runs every stage in one SPMD program: the blocks'
parameters stacked [S, L/S, ...] over the 'pp' axis, one `lax.scan` over
ticks whose `jnp.roll` XLA lowers to a collective permute, the backward
by autodiff. Here, as in the reference's section workers, one process
is one stage: the rank at 'pp' coordinate r owns blocks [r L/S, (r + 1)
L/S) of the model (and `pre` on the first stage, `post` and the head on
the last), and runs a table of ticks (`_tables`): at the start of a tick
the activations computed on the previous tick go one stage on and the
cotangents one stage back, every send and receive of the tick paired in
one `batch_isend_irecv` over the 'pp' slice (`collective.p2p_exchange`);
then the stage runs the tick's forward or backward of one microbatch.

`PipelineTrainStep` runs GPipe: every microbatch's forward (the stage's
blocks under autograd, each block recomputed in the backward with
`remat`), then every backward, in microbatch order, each stage's as
soon as its cotangent arrives. `pipeline_1f1b.OneF1BTrainStep` runs the
1F1B table on the same engine. The loss is the mean of the microbatch
losses (each the rank's share of the global microbatch's, as
`sharded.loss_scope` gives it), as the JAX step's; the last stage
broadcasts it over the slice, so every rank returns it.

Residency: a stage's rank keeps only what it trains. The step releases
(`parallel_layers.release`) the weights of every other stage's blocks,
of `pre` off the first stage (the last keeps the tied ones its head
reads) and of `post` off the last, and over 'mp' the full weight of
each split parameter it holds a shard of. `sync()` gathers the whole
model back onto every rank (so `save` writes the JAX layout), and the
next call releases it again.

Composition: over 'dp' the global batch is cut as the JAX step cuts it
(microbatch m, then the rank's rows of it) and after the last backward
each stage's gradients are summed over the 'dp' slice (one flat bucket
a dtype); over 'mp' the stage's blocks are the Megatron layers on the
rank's shards (`parallel_layers.LocalShards`). A head that reads
`pre`'s parameters (GPT's tied word embedding: `PipelineParts.tied`)
makes the last stage hold them too; the first and the last stage of
each ('dp', 'mp') slice swap their two gradients (point to point) and
each adds the other's.
Dropout: each stage past the first draws from its own generator (seeded
from the framework's and the stage), so no two (stage, layer) pairs
repeat a mask; every tick draws afresh.

One process a stage makes the reference's heterogeneous stages possible
(each rank builds what it runs), but the port keeps the JAX package's
rule that the trunk is homogeneous: every block maps an activation of
one shape to the same shape (`pre`'s output, probed on the first call of
each input shape and broadcast from the first stage).

On a card whose groups are all NCCL the step is one CUDA graph per input
signature (as `jit.TrainStep`), its point-to-point sends included; with
a gloo group (ranks sharing a card, CPU ranks) it runs eagerly, CUDA
tensors crossing gloo's send and receive through the host (counted in
`collective.stats["host_staged"]`).
"""
import contextlib
import contextvars

import numpy as np
import torch
import torch.distributed as dist

from ..framework import state
from ..framework.tensor import Tensor, unwrap
from ..incubate.recompute import recompute
from ..jit import TrainStep
from . import collective
from . import mesh as mesh_mod
from . import parallel_layers as tp
from .collective import ReduceOp, all_reduce_
from .sharded import (_Bucket, _Parts, grad_sentinel, loss_scope,
                      make_stepper)

_CURRENT_STAGE = contextvars.ContextVar("pp_stage", default=None)

# seed offset of a stage's generator
_STAGE_SEED = 1000003


def current_stage():
    return _CURRENT_STAGE.get()


class device_guard:
    """ref fluid.device_guard('gpu:k') placement marker: records the
    pipeline stage for layers built inside. Kept for API parity; the
    engine places blocks by their order."""

    def __init__(self, device=None):
        self.stage = None
        if device is not None and ":" in str(device):
            self.stage = int(str(device).split(":")[1])

    def __enter__(self):
        self._tok = _CURRENT_STAGE.set(self.stage)
        return self

    def __exit__(self, *exc):
        _CURRENT_STAGE.reset(self._tok)
        return False


# --------------------------------------------------------------------------
# parameter stacking helpers
# --------------------------------------------------------------------------

def stack_block_params(blocks):
    """The parameters of a homogeneous list of blocks as one dict of
    [L, ...] tensors (copies; leading dim = layer)."""
    per = [{n: p._data.detach() for n, p in blk.named_parameters()}
           for blk in blocks]
    return {n: torch.stack([d[n] for d in per]) for n in per[0]}


@torch.no_grad()
def unstack_block_params(blocks, stacked):
    """Row i of every [L, ...] tensor of `stacked` into block i's
    parameter of that name (in place)."""
    for i, blk in enumerate(blocks):
        named = dict(blk.named_parameters())
        for n, arr in stacked.items():
            named[n]._data.copy_(arr[i])


# --------------------------------------------------------------------------
# model partitioning spec
# --------------------------------------------------------------------------

class PipelineParts:
    """How a model maps onto pipeline stages:

      pre:    Layer: model inputs -> first-stage activations (embeddings)
      blocks: homogeneous list of Layers (the pipelined trunk)
      post:   Layer or None applied after the last stage (final norm)
      head_call(post_params, pre_params, h, labels) -> loss (defaults to
              post -> loss_fn); the params are name -> torch tensor dicts
              of the live leaves, h and labels port Tensors
      tied:   names of `pre`'s parameters head_call reads (None: all of
              them; () for a head that reads none): the last stage holds
              them too and their gradients are summed with the first's
    """

    def __init__(self, pre, blocks, post=None, head_call=None, tied=None):
        self.pre = pre
        self.blocks = list(blocks)
        self.post = post
        self.head_call = head_call
        self.tied = None if tied is None else tuple(tied)


def resolve_parts(model, loss_fn):
    """PipelineParts for `model`: model.pipeline_parts(loss_fn) if it
    defines one, else the GPTForPretraining shape (embeddings, blocks,
    ln_f and the head tied to the word embedding), else an actionable
    error."""
    if hasattr(model, "pipeline_parts"):
        return model.pipeline_parts(loss_fn)
    gpt = getattr(model, "gpt", None)
    if gpt is not None and hasattr(gpt, "blocks"):
        from ..nlp.gpt import tied_head
        ln_f, emb, cfg = gpt.ln_f, gpt.embeddings, model.cfg

        def head_call(post_p, pre_p, h, labels):
            with emb._use_state(pre_p):
                out, _ = ln_f.functional_call(post_p, {}, h)
                logits = tied_head(cfg, out, emb.word_embeddings.weight)
                return loss_fn(logits, labels)

        return PipelineParts(gpt.embeddings, list(gpt.blocks), gpt.ln_f,
                             head_call, tied=("word_embeddings.weight",))
    raise ValueError(
        "cannot infer pipeline stages: give the model a "
        "pipeline_parts(loss_fn) -> PipelineParts method, or pass "
        "parts= explicitly (pre/blocks/post/head_call)")


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def _arrivals(do_f, f_m, do_b, b_m):
    """The receive tables of a compute table: what a neighbour computed
    on tick t - 1 arrives on tick t (activations from r - 1, cotangents
    from r + 1)."""
    T, S = len(do_f), len(do_f[0]) if do_f else 0
    recv_f = [[False] * S for _ in range(T)]
    f_rm = [[0] * S for _ in range(T)]
    recv_b = [[False] * S for _ in range(T)]
    b_rm = [[0] * S for _ in range(T)]
    for t in range(1, T):
        for r in range(1, S):
            if do_f[t - 1][r - 1]:
                recv_f[t][r], f_rm[t][r] = True, f_m[t - 1][r - 1]
        for r in range(S - 1):
            if do_b[t - 1][r + 1]:
                recv_b[t][r], b_rm[t][r] = True, b_m[t - 1][r + 1]
    return recv_f, f_rm, recv_b, b_rm


def simulate_gpipe(S, M):
    """The GPipe table in `simulate_1f1b`'s form: stage r runs the
    forward of microbatch m on tick r + m, and after all M + S - 1
    forward ticks the backward of m on tick (M + S - 1) + (S - 1 - r) +
    m."""
    T = 2 * (M + S - 1)
    do_f = [[False] * S for _ in range(T)]
    f_m = [[0] * S for _ in range(T)]
    do_b = [[False] * S for _ in range(T)]
    b_m = [[0] * S for _ in range(T)]
    for r in range(S):
        for m in range(M):
            do_f[r + m][r], f_m[r + m][r] = True, m
            t = (M + S - 1) + (S - 1 - r) + m
            do_b[t][r], b_m[t][r] = True, m
    recv_f, f_rm, recv_b, b_rm = _arrivals(do_f, f_m, do_b, b_m)
    busy = 2 * S * M
    return {"DO_F": np.asarray(do_f), "F_M": np.asarray(f_m, np.int32),
            "DO_B": np.asarray(do_b), "B_M": np.asarray(b_m, np.int32),
            "RECV_F": np.asarray(recv_f), "F_RM": np.asarray(f_rm, np.int32),
            "RECV_B": np.asarray(recv_b), "B_RM": np.asarray(b_rm, np.int32),
            "T": T, "max_inflight": [M] * S,
            "bubble_fraction": 1.0 - busy / float(T * S)}


def _tables(sched):
    """A schedule's tables as Python lists (host values: the tick loop
    reads nothing from a device)."""
    return {k: np.asarray(sched[k]).tolist()
            for k in ("DO_F", "F_M", "DO_B", "B_M", "RECV_F", "F_RM",
                      "RECV_B", "B_RM")}


def _microbatch(a, M, dp, dpi):
    """Microbatch m of the global batch `a` is rows [m B/M, (m + 1)
    B/M); the rank takes its dp part of each: [M, B / (M dp), ...]."""
    b = a.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    a = a.reshape((M, b // M) + tuple(a.shape[1:]))
    if dp > 1:
        if (b // M) % dp:
            raise ValueError(f"microbatch {b // M} not divisible over "
                             f"dp = {dp}")
        n = b // M // dp
        a = a[:, dpi * n:(dpi + 1) * n]
    return a


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def run_schedule(t_, r, S, pg, shape, dtype, device, forward, backward):
    """Stage r's column of a schedule's tables `t_` (`_tables`). Each
    tick first exchanges over the 'pp' slice `pg` what the stage computed
    on the previous tick (activations to r + 1, cotangents to r - 1)
    against what its neighbours did (received into new [shape] buffers,
    banked by microbatch), in one batch; then runs `forward(m, x)` (x:
    the banked activation, None on the first stage) -> the activation to
    send (None on the last), or `backward(m, cot)` (cot: the banked
    cotangent, None on the last stage) -> the input's cotangent to send
    (None on the first)."""
    acts, cots = {}, {}
    send_f = send_b = None
    for t in range(len(t_["DO_F"])):
        sends, recvs = [], []
        if send_f is not None:
            sends.append((send_f, r + 1))
        if send_b is not None:
            sends.append((send_b, r - 1))
        if t_["RECV_F"][t][r]:
            buf = torch.empty(shape, dtype=dtype, device=device)
            acts[t_["F_RM"][t][r]] = buf
            recvs.append((buf, r - 1))
        if t_["RECV_B"][t][r]:
            buf = torch.empty(shape, dtype=dtype, device=device)
            cots[t_["B_RM"][t][r]] = buf
            recvs.append((buf, r + 1))
        collective.p2p_exchange(sends, recvs, pg)
        send_f = send_b = None
        if t_["DO_F"][t][r]:
            m = t_["F_M"][t][r]
            y = forward(m, acts.pop(m, None))
            send_f = y if r < S - 1 else None
        elif t_["DO_B"][t][r]:
            m = t_["B_M"][t][r]
            dx = backward(m, cots.pop(m, None))
            send_b = dx if r > 0 else None
    if send_f is not None or send_b is not None or acts or cots:
        raise RuntimeError("the pipeline schedule ended with a transfer "
                           "due")


def pipeline_apply(block_call, blocks_p, x_micro, num_stages, mesh=None,
                   pp_axis=None, dp_axis=None, remat=True, key=None):
    """Run the GPipe forward over the 'pp' slice.

    block_call(layer_params, x, key) -> x : ONE block; `key` is None
    (the port's generators are stateful: every call draws afresh).
    blocks_p: dict of [S, L/S, ...] stacked tensors (the JAX form); the
    rank runs its row.
    x_micro:  [M, mb, ...] first-stage inputs (read on the first stage).
    Returns [M, mb, ...] last-stage outputs on every rank of the slice.
    A forward: its activations cross ranks without autograd."""
    mesh = mesh or mesh_mod.get_mesh()
    pp_axis = pp_axis or mesh_mod.PP_AXIS
    S = num_stages
    if mesh.axis_size(pp_axis) != S:
        raise ValueError(f"{S} stages over a 'pp' axis of "
                         f"{mesh.axis_size(pp_axis)} ranks: one rank a stage")
    r, pg = mesh.axis_index(pp_axis), mesh.group(pp_axis)
    blocks_p = {n: a[r] for n, a in blocks_p.items()}
    lps = next(iter(blocks_p.values())).shape[0]
    M = x_micro.shape[0]
    outs = torch.empty_like(x_micro)

    def forward(m, x):
        x = x_micro[m] if r == 0 else x
        for i in range(lps):
            x = block_call({n: a[i] for n, a in blocks_p.items()}, x, key)
        if r == S - 1:
            outs[m] = x
            return None
        return x.detach().contiguous()

    # GPipe's forward ticks: every arrival lands within them
    t_ = {k: v[:M + S - 1] for k, v in _tables(simulate_gpipe(S, M)).items()}
    run_schedule(t_, r, S, pg, tuple(x_micro.shape[1:]), x_micro.dtype,
                 x_micro.device, forward, None)
    collective.broadcast_(outs, S - 1, pg)
    return outs


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

class PipelineTrainStep(TrainStep):
    """The pp (+ dp + mp) training step for a model shaped like
    GPTForPretraining (embeddings -> homogeneous blocks -> final norm ->
    tied head), or any `PipelineParts` model; GPipe, one process a stage.
    The analog of fleet PipelineOptimizer.minimize + PipelineTrainer /
    SectionWorker.

        make_mesh({'dp': 2, 'pp': 4})
        step = PipelineTrainStep(model, gpt_pretrain_loss, opt, num_micro=8)
        loss = step(input_ids, labels)        # the global batch

    Every rank is given the global batch and takes its microbatches."""

    schedule = "gpipe"

    def __init__(self, model, loss_fn, optimizer, mesh=None, num_micro=4,
                 num_stages=None, remat=True, donate=True, parts=None,
                 cuda_graph=True):
        self.mesh = mesh or mesh_mod.get_mesh() or mesh_mod.default_mesh()
        m = self.mesh
        pp = mesh_mod.PP_AXIS
        if pp not in m.axis_names:
            raise ValueError("a pipeline step needs a mesh with a 'pp' axis")
        S = int(m.shape[pp])
        if num_stages is not None and int(num_stages) != S:
            raise ValueError(f"num_stages={num_stages} over a 'pp' axis of "
                             f"{S} ranks: one rank is one stage")
        self.num_stages, self.num_micro = S, int(num_micro)
        self.stage = m.axis_index(pp)
        self._pp = m.group(pp)
        self.first, self.last = self.stage == 0, self.stage == S - 1
        self.dp_axis = mesh_mod.DP_AXIS \
            if mesh_mod.DP_AXIS in m.axis_names else None
        self.dp = m.axis_size(self.dp_axis) if self.dp_axis else 1
        self._dp_group = m.group(self.dp_axis) if self.dp > 1 else None
        for ax, size in m.shape.items():
            if size > 1 and ax not in (pp, mesh_mod.DP_AXIS,
                                       mesh_mod.MP_AXIS):
                raise NotImplementedError(
                    f"a pipeline over a mesh with {ax!r} = {size}: the "
                    f"pipeline composes with 'dp' and 'mp'")
        seed = state.default_generator().initial_seed
        self._stage_seed = (seed + _STAGE_SEED * self.stage) % (1 << 62)
        self._mp = tp.mp_group(m, seed=self._stage_seed)
        self.parts = parts or resolve_parts(model, loss_fn)
        self._prefixes = {id(sub): (n + "." if n else "") for n, sub in
                          model.named_sublayers(include_self=True)}
        blocks = self.parts.blocks
        L = len(blocks)
        if L % S:
            raise ValueError(f"{L} layers not divisible by {S} stages")
        self.lps = L // S
        self.remat = bool(remat)
        self._blocks = blocks[self.stage * self.lps:
                              (self.stage + 1) * self.lps]
        groups = [g for g in (self._pp, self._dp_group,
                              self._mp.pg if self._mp else None)
                  if g is not None]
        nccl = all(dist.get_backend(g) == "nccl" for g in groups)
        super().__init__(model, loss_fn, optimizer, donate=donate,
                         cuda_graph=cuda_graph and nccl)
        if self._k_merge > 1:
            raise NotImplementedError(
                "gradient_merge on a pipeline: its microbatches are the "
                "accumulation (pipeline_configs accumulate_steps)")
        if self.transforms.get("recompute") is not None:
            self.remat = True
        self._own = self._owned_names(model)
        self._shards_mp = tp.LocalShards(model, self._mp,
                                         names=set(self._own)) \
            if self._mp is not None else None
        named = dict(model.named_parameters())
        self._named = named
        # every other stage's parameters leave this rank
        own = set(self._own)
        self._away = [n for n, w in named.items()
                      if n not in own and w._data.requires_grad]
        self._release()
        work = []
        for n in self._own:
            leaf = named[n]._data
            if self._shards_mp is not None:
                leaf = self._shards_mp.working(leaf)
            work.append(leaf)
        self._params = [p for p in work if p.requires_grad]
        self._names = {id(p): n for n, p in zip(self._own, work)}
        self._split = {id(p) for n, p in zip(self._own, work)
                       if p is not named[n]._data}
        self._tied = [p for p in self._params
                      if self._names[id(p)] in self._tied_names()]
        by_dtype = {}
        for p in self._params:
            by_dtype.setdefault(p.dtype, []).append(p)
        self._buckets = [_Bucket(ps, 1) for ps in by_dtype.values()]
        self._grad_views = {}
        for b in self._buckets:
            for p, v in zip(b.params, b.views(b.flat[0])):
                self._grad_views[id(p)] = v[:p.numel()].view(p.shape)
        # the global norm (clip, sentinel) sums every stage's squares,
        # the tied weight's once (the first stage's)
        self._parts = _Parts(None, self._mp.pg if self._mp else None,
                             self._split, pp_pg=self._pp if S > 1 else None,
                             dup={id(p) for p in self._tied})
        self._stepper = make_stepper(self.optimizer, self._params,
                                     self._parts)
        self._seed_state()
        self._gen = state.Generator(self._stage_seed) if self.stage else None
        if self.program.graphed:
            for g in (self._gen, self._mp.generator if self._mp else None):
                if g is not None:
                    self.program._generators.append(g.generator(
                        self._device))
        self._t = _tables((simulate_gpipe if self.schedule == "gpipe"
                           else _simulate_1f1b())(S, self.num_micro))
        self._meta = {}

    # ---------------------------------------------------------- set-up
    def _prefix(self, layer):
        """The model-level name prefix of a sublayer."""
        if id(layer) not in self._prefixes:
            raise ValueError(f"{type(layer).__name__} is not a sublayer of "
                             f"the model")
        return self._prefixes[id(layer)]

    def _tied_names(self):
        if self.first or not self.last:
            return set()
        pre = self._prefix(self.parts.pre)
        tied = self.parts.tied
        names = [n for n, _ in self.parts.pre.named_parameters()]
        return {pre + n for n in (names if tied is None else tied)}

    def _owned_names(self, model):
        """The model-level names of the parameters this stage trains."""
        own = []
        if self.first:
            pre = self._prefix(self.parts.pre)
            own += [pre + n for n, _ in self.parts.pre.named_parameters()]
        for blk in self._blocks:
            pre = self._prefix(blk)
            own += [pre + n for n, _ in blk.named_parameters()]
        if self.last:
            if self.parts.post is not None:
                pre = self._prefix(self.parts.post)
                own += [pre + n for n, _ in
                        self.parts.post.named_parameters()]
            own += sorted(self._tied_names())
        seen = set()
        return [n for n in own if not (n in seen or seen.add(n))]

    @torch.no_grad()
    def _seed_state(self):
        """The rank's part of every state slot the optimizer already
        holds for this stage's parameters (a resumed run)."""
        base, opt = self.optimizer, self._stepper
        index = {id(p): i for i, p in enumerate(base._parameters)}
        for j, w in enumerate(self._params):
            n = self._names[id(w)]
            full = self._named[n]._data
            st = base._state.get(index.get(id(full), -1))
            if not st:
                continue
            mine = opt._ensure_state(j)
            for slot, t in st.items():
                if id(w) in self._split:
                    t = tp.shard_tensor(t, self._named[n], self._mp.rank,
                                        self._mp.size)
                mine[slot].copy_(t)
        opt._global_step = base._global_step

    def _release(self):
        """Free the weights this rank does not train (again after a
        `sync()`)."""
        for n in self._away:
            tp.release(self._named[n]._data)
        if self._shards_mp is not None:
            self._shards_mp.release()

    def param_nbytes(self):
        """Bytes of parameter data this rank holds: the model's resident
        weights and its mp shards."""
        leaves = [p._data for p in self._named.values()]
        if self._shards_mp is not None:
            leaves += list(self._shards_mp.local.values())
        return tp.resident_nbytes(leaves)

    # ------------------------------------------------------------- step
    def __call__(self, inputs, labels):
        inputs = tuple(inputs) if isinstance(inputs, (list, tuple)) \
            else (inputs,)
        labels = tuple(labels) if isinstance(labels, (list, tuple)) \
            else (labels,)
        if len(inputs) != 1 or len(labels) != 1:
            raise ValueError("a pipeline step takes one input tensor and "
                             "one label tensor")
        self._release()
        loss = super().__call__(inputs, labels)
        self.optimizer._global_step = self._stepper._global_step
        return Tensor._wrap(unwrap(loss))

    def _step(self, args, n_in, apply=True):
        for p in self._params:
            p.grad = None
        loss = self._run(args[:n_in], args[n_in:], apply)[0]
        grads = [p.grad for p in self._params]
        for p in self._params:
            p.grad = None
        return (loss, (), self._last_grad_norm, self._last_nonfinite, grads)

    def _scope(self):
        stack = contextlib.ExitStack()
        if self._shards_mp is not None:
            stack.enter_context(self._shards_mp.scope())
        if self._gen is not None:
            stack.enter_context(state.use_generator(self._gen))
        return stack

    def _act_meta(self, ids):
        """(shape, dtype) of a microbatch's activation: `pre`'s output,
        probed on the first stage (eval mode, no grad) at the first call
        of each input shape and broadcast over the slice."""
        key = (tuple(ids.shape), ids.dtype)
        if key not in self._meta:
            meta = torch.zeros(8, dtype=torch.int64, device=ids.device)
            if self.first:
                pre = self.parts.pre
                was = pre.training
                pre.eval()
                with torch.no_grad(), self._scope():
                    a = unwrap(pre(Tensor._wrap(ids[0])))
                pre.train(was)
                meta[0], meta[1] = a.dim(), _DTYPES.index(a.dtype)
                meta[2:2 + a.dim()] = torch.tensor(a.shape)
            collective.broadcast_(meta, 0, self._pp)
            v = meta.tolist()
            self._meta[key] = (tuple(v[2:2 + v[0]]), _DTYPES[v[1]])
        return self._meta[key]

    def _pre(self, ids):
        return unwrap(self.parts.pre(Tensor._wrap(ids)))

    def _trunk(self, x, remat):
        h = Tensor._wrap(x)
        for blk in self._blocks:
            h = recompute(blk, h) if remat and torch.is_grad_enabled() \
                else blk(h)
            if isinstance(h, tuple):
                raise NotImplementedError(
                    "a pipelined block returning a tuple (an MoE block's "
                    "aux loss): expert parallelism is ROADMAP Queue 1 "
                    "item 5c")
        return unwrap(h)

    def _head(self, y, labels):
        """This rank's share of microbatch m's loss (a torch scalar)."""
        post = self.parts.post
        with loss_scope(self.mesh) as scope:
            h, lab = Tensor._wrap(y), Tensor._wrap(labels)
            if self.parts.head_call is not None:
                post_p = {n: p._data for n, p in post.named_parameters()} \
                    if post is not None else {}
                pre_p = {n: p._data for n, p in
                         self.parts.pre.named_parameters()}
                loss = self.parts.head_call(post_p, pre_p, h, lab)
            else:
                if post is not None:
                    h = post(h)
                loss = self.loss_fn(h, lab)
            share = unwrap(loss)
            if not scope.declared:
                share = share / self.dp
        return share

    def _run(self, inputs, labels, apply=True):
        ids, lab = unwrap(inputs[0]), unwrap(labels[0])
        M = self.num_micro
        dpi = self.mesh.axis_index(self.dp_axis) if self.dp > 1 else 0
        ids_m = _microbatch(ids, M, self.dp, dpi)
        lab_m = _microbatch(lab, M, self.dp, dpi)
        shape, dtype = self._act_meta(ids_m)
        self._loss_acc = torch.zeros((), dtype=torch.float32,
                                     device=ids.device)
        self._ids_m, self._lab_m, self._keep = ids_m, lab_m, {}
        try:
            with self._scope():
                run_schedule(self._t, self.stage, self.num_stages, self._pp,
                             shape, dtype, ids.device, *self._callbacks())
        finally:
            self._ids_m = self._lab_m = self._keep = None
        self._reduce_and_update()
        loss = self._loss_acc / M
        all_reduce_(loss, ReduceOp.SUM, self._dp_group)
        collective.broadcast_(loss, self.num_stages - 1, self._pp)
        return loss, ()

    def _callbacks(self):
        """The (forward, backward) of this stage's ticks (`run_schedule`),
        for one call."""
        return self._forward, self._backward

    def _forward(self, m, x):
        """GPipe: microbatch m through the stage under autograd (the head
        and loss on the last stage); returns the activation to send."""
        if self.first:
            x = self._pre(self._ids_m[m])
        else:
            x.requires_grad_(True)
        y = self._trunk(x, self.remat)
        if self.last:
            share = self._head(y, self._lab_m[m])
            self._loss_acc += share.detach().float()
            self._keep[m] = (x, share / self.num_micro)
            return None
        self._keep[m] = (x, y)
        return y.detach()

    def _backward(self, m, cot):
        x, y = self._keep.pop(m)
        if self.last:
            y.backward()
        else:
            torch.autograd.backward(y, cot)
        return None if self.first else x.grad

    @torch.no_grad()
    def _reduce_and_update(self):
        """The tied parameters' grads summed between the first and the
        last stage, every grad over 'dp' (one bucket a dtype), then the
        sentinel and the update."""
        tied = self._tied_or_pre()
        if tied:
            # the first and the last stage swap their grads of the tied
            # parameters (one batch of p2p ops) and each adds the other's
            peer = self.num_stages - 1 if self.first else 0
            for p in tied:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            theirs = [torch.empty_like(p.grad) for p in tied]
            collective.p2p_exchange([(p.grad, peer) for p in tied],
                                    [(t, peer) for t in theirs], self._pp)
            for p, t in zip(tied, theirs):
                p.grad.add_(t)
        for b in self._buckets:
            b.pack([p.grad for p in b.params])
            all_reduce_(b.flat, ReduceOp.SUM, self._dp_group)
        for p in self._params:
            p.grad = self._grad_views[id(p)]
        self._last_grad_norm, self._last_nonfinite = grad_sentinel(
            self._parts, self._loss_acc, [p.grad for p in self._params],
            self._params)
        self._stepper.step()

    def _tied_or_pre(self):
        """The parameters whose grads the first and the last stage sum:
        on the last stage its copies of the tied ones, on the first the
        originals (in the same order)."""
        if self.num_stages == 1 or not (self.first or self.last):
            return []
        if self.last:
            return self._tied
        pre = self._prefix(self.parts.pre)
        tied = self.parts.tied
        names = [n for n, _ in self.parts.pre.named_parameters()] \
            if tied is None else list(tied)
        want = sorted(pre + n for n in names)
        by_name = {self._names[id(p)]: p for p in self._params}
        return [by_name[n] for n in want if n in by_name]

    # -------------------------------------------------------- state
    @torch.no_grad()
    def _broadcast_model(self, value):
        """name -> the full tensor `value(name, leaf)` gives on the stage
        that owns it (its mp shards gathered; `pre`'s parameters the
        first stage's, a block's its stage's, the rest the last's),
        broadcast over the 'pp' slice; every rank gets every name
        (collective)."""
        owners = {}
        for i, blk in enumerate(self.parts.blocks):
            pre = self._prefix(blk)
            owners.update({pre + n: i // self.lps
                           for n, _ in blk.named_parameters()})
        pre = self._prefix(self.parts.pre)
        owners.update({pre + n: 0
                       for n, _ in self.parts.pre.named_parameters()})
        mine = {self._names[id(p)]: p for p in self._params}
        out = {}
        for n, w in self._named.items():
            if not w._data.requires_grad:
                continue
            owner = owners.get(n, self.num_stages - 1)
            if owner == self.stage:
                leaf = mine[n]
                t = value(n, leaf)
                if id(leaf) in self._split:
                    t = tp.gather_tensor(t, w, self._mp)
                t = t.contiguous()
            else:
                t = torch.empty(tp.full_shape(w._data), dtype=w._data.dtype,
                                device=w._data.device)
            collective.broadcast_(t, owner, self._pp)
            out[n] = t
        return out

    @torch.no_grad()
    def sync(self):
        """Rebuild the whole model on every rank: each block's parameters
        from the stage that owns it (`pre`'s from the first, `post`'s
        from the last), gathered over 'mp' first, into the model's
        weights (a released one gets its storage back until the next
        call); the step count into the optimizer (collective: every rank
        calls it). The moments stay in the step, as the JAX step keeps
        them."""
        full = self._broadcast_model(lambda n, leaf: leaf.detach())
        for n, t in full.items():
            tp.restore(self._named[n]._data, t)
        self.optimizer._global_step = self._stepper._global_step

    def last_grads(self):
        """name -> the full logical gradient of the latest step (summed
        over 'dp', the tied pair summed; collective)."""
        return self._broadcast_model(
            lambda n, leaf: self._grad_views[id(leaf)])


def _simulate_1f1b():
    from .pipeline_1f1b import simulate_1f1b
    return simulate_1f1b
