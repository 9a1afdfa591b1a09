"""The collective API (the port of `paddle_tpu/distributed/collective.py`;
ref python/paddle/distributed/collective.py:101-457 and the c_* kernels).

The JAX package lowers each collective to an XLA one over a mesh axis
inside a traced program, and treats an eager call as the identity (one
controller holds the whole world). Here every rank is a process, so
each call is a real `torch.distributed` collective over the process
group of the group's mesh axis (`mesh.Mesh.group`), on the tensor in
place:

  all_reduce      -> dist.all_reduce (AVG on gloo: a sum, then / n)
  all_gather      -> dist.all_gather_into_tensor
  reduce_scatter  -> dist.reduce_scatter_tensor over the inputs
                     concatenated on dim 0
  broadcast       -> dist.broadcast from the group's rank `src`
  reduce          -> all_reduce (SPMD: every rank holds the result, as
                     in the JAX package)
  scatter         -> dist.scatter from the group's rank `src`
  alltoall        -> dist.all_to_all_single over the stacked inputs
  send / recv     -> dist.send / dist.recv with group ranks
  barrier, wait   -> dist.barrier; a wait on the tensor's stream

Ranks, `src` and `dst` are indices in the group. A group of one rank
(or no process group at all: a single process) makes every collective
the identity. On NCCL the calls enqueue on the current stream and may be
captured in a CUDA graph (`distributed.sharded.ShardedTrainStep` does).

gloo takes CUDA tensors for some ops only (`GLOO_CUDA_OPS`, found on the
card's torch). For the others, a gloo group given CUDA tensors copies
them to the host, runs the op there and copies the results back: an
explicit, synchronising round trip, counted in `stats["host_staged"]`,
as the JAX package's eager DataParallel stages through host numpy. It
is never taken for an NCCL group.

Retries: an eager call outside a CUDA-graph capture runs behind the
JAX package's bounded exponential backoff (`configure_retries`:
`retries` extra attempts, `backoff_s` doubling, `deadline_s` a budget
on the whole window), each retry counted in `stats["retries"]`; the
last failure is raised. Only transport failures (torch's
DistNetworkError and DistStoreError) are retried, and a captured call is
not. The JAX
package's telemetry counters, chaos point and flight-recorder journal
around each call wait for ROADMAP Queue 1 item 6.
"""
import functools
import time

import torch
import torch.distributed as dist

from ..framework.tensor import Tensor, unwrap
from . import mesh as mesh_mod


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}

#: ops a gloo process group runs on CUDA tensors itself (torch 2.11 and
#: gloo on the card; chip_smoke.py's dist phase holds each against its
#: expected values). Its p2p ops are not among them: a CUDA tensor given
#: to gloo's send aborts the process ("writev ... Bad address"), so
#: send, recv and the ring's batched p2p are staged through the host
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast",
                           "all_gather_into_tensor", "reduce_scatter_tensor",
                           "all_to_all_single", "scatter"})

#: host round trips of gloo collectives on CUDA tensors, and retried
#: eager calls — plain integers, set to 0 by whoever reads them
stats = {"host_staged": 0, "retries": 0}

# torch 2.13 renamed these two (the old names warn); the card's 2.11 has
# only the old ones
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)

_RETRY_POLICY = {"retries": 2, "backoff_s": 0.05, "deadline_s": None}
# transport failures are retried; a usage error (a bad shape) is raised
# at once: its peers would wait forever for the repeat
_TRANSIENT = (dist.DistNetworkError, dist.DistStoreError)
_UNSET = object()


def configure_retries(retries=None, backoff_s=None, deadline_s=_UNSET):
    """Tune (or disable, retries=0) the eager collective retry barrier.
    Returns the previous policy dict. The deadline_s default sentinel
    means "leave unchanged"; pass None explicitly to clear it."""
    prev = dict(_RETRY_POLICY)
    if retries is not None:
        _RETRY_POLICY["retries"] = max(0, int(retries))
    if backoff_s is not None:
        _RETRY_POLICY["backoff_s"] = float(backoff_s)
    if deadline_s is not _UNSET:
        _RETRY_POLICY["deadline_s"] = (None if deadline_s is None
                                       else float(deadline_s))
    return prev


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _eager_retry(fn):
    """Run an eager collective behind the bounded backoff barrier; a
    call inside a CUDA-graph capture runs once."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _capturing():
            return fn(*args, **kwargs)
        policy = dict(_RETRY_POLICY)
        delay = policy["backoff_s"]
        deadline = None if policy["deadline_s"] is None \
            else time.monotonic() + policy["deadline_s"]
        for attempt in range(policy["retries"] + 1):
            try:
                return fn(*args, **kwargs)
            except _TRANSIENT:
                if attempt >= policy["retries"] or (
                        deadline is not None
                        and time.monotonic() + delay > deadline):
                    raise
                stats["retries"] += 1
                time.sleep(delay)
                delay *= 2
    return wrapper


# ----------------------------------------------------------- primitives
# torch tensors in, written in place; `pg` a process group or None (one
# rank: the identity). sharded.py, ring_attention.py and ulysses.py call
# these directly.

def _staged(pg, op, *tensors):
    """Whether `op` over `pg` runs on host copies of CUDA `tensors`."""
    return any(t.is_cuda for t in tensors) and \
        dist.get_backend(pg) == "gloo" and op not in GLOO_CUDA_OPS


def _on_host(pg, op, outs, ins, run):
    """run(outs, ins) on the tensors, or on host copies of them (the
    outputs copied back) when `_staged`."""
    if not _staged(pg, op, *outs, *ins):
        run(outs, ins)
        return
    host_outs = [t.cpu() for t in outs]
    run(host_outs, [t.cpu() for t in ins])
    for t, h in zip(outs, host_outs):
        t.copy_(h)
    stats["host_staged"] += 1


def group_size(pg):
    return 1 if pg is None else dist.get_world_size(pg)


def group_index(pg):
    """This rank's index in the group (0 without one)."""
    return 0 if pg is None else dist.get_group_rank(pg, dist.get_rank())


def global_rank(pg, index):
    """The world rank of the group's rank `index`."""
    return index if pg is None else dist.get_global_rank(pg, index)


def all_reduce_(t, op=ReduceOp.SUM, pg=None):
    """t reduced over the group, in place."""
    if pg is None:
        return t
    avg = op == ReduceOp.AVG
    if avg and dist.get_backend(pg) == "gloo":
        red = dist.ReduceOp.SUM
    else:
        red = dist.ReduceOp.AVG if avg else _TORCH_OPS[op]

    def run(outs, ins):
        dist.all_reduce(outs[0], op=red, group=pg)
    _on_host(pg, "all_reduce", [t], [], run)
    if avg and red == dist.ReduceOp.SUM:
        t.div_(group_size(pg))
    return t


def all_gather_into(out, t, pg=None):
    """out [n * t.shape[0], ...] or [n, ...] = every rank's t, in rank
    order."""
    if pg is None:
        out.copy_(t.reshape(out.shape))
        return out

    def run(outs, ins):
        # gloo takes the concatenated form only: [n * rows, ...]
        src = ins[0].reshape((-1,) + tuple(ins[0].shape[1:]))
        _all_gather_single(
            outs[0].view((-1,) + tuple(src.shape[1:])), src, group=pg)
    _on_host(pg, "all_gather_into_tensor", [out], [t], run)
    return out


def reduce_scatter_into(out, t, pg=None, op=ReduceOp.SUM):
    """out = the group's reduction of t, rank i keeping slice i of dim 0
    (out has t.shape[0] / n rows)."""
    if pg is None:
        out.copy_(t.reshape(out.shape))
        return out
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN):
        raise ValueError(f"reduce_scatter takes SUM, MAX or MIN, got {op}")

    def run(outs, ins):
        _reduce_scatter_single(outs[0], ins[0], op=_TORCH_OPS[op],
                               group=pg)
    _on_host(pg, "reduce_scatter_tensor", [out], [t], run)
    return out


def all_to_all_into(out, t, pg=None):
    """Rank i's out[j-th block of dim 0] = rank j's t[i-th block]."""
    if pg is None:
        out.copy_(t)
        return out

    def run(outs, ins):
        dist.all_to_all_single(outs[0], ins[0], group=pg)
    _on_host(pg, "all_to_all_single", [out], [t], run)
    return out


def broadcast_(t, src=0, pg=None):
    """t from the group's rank `src`, in place."""
    if pg is None:
        return t

    def run(outs, ins):
        dist.broadcast(outs[0], src=global_rank(pg, src), group=pg)
    _on_host(pg, "broadcast", [t], [], run)
    return t


def ring_exchange(send, recv, pg=None):
    """Each tensor of `send` to the group's next rank and the previous
    rank's into `recv` (equal shapes), in one batch of p2p ops."""
    n = group_size(pg)
    if n == 1:
        for r, s in zip(recv, send):
            r.copy_(s)
        return recv
    me = group_index(pg)
    nxt, prv = global_rank(pg, (me + 1) % n), global_rank(pg, (me - 1) % n)

    def run(outs, ins):
        ops = []
        for s, r in zip(ins, outs):
            ops.append(dist.P2POp(dist.isend, s, nxt, group=pg))
            ops.append(dist.P2POp(dist.irecv, r, prv, group=pg))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    _on_host(pg, "batch_isend_irecv", list(recv), list(send), run)
    return recv


def p2p_exchange(sends, recvs, pg=None):
    """One batch of point-to-point ops over the group: each (tensor,
    group rank) of `sends` sent there, each (tensor, group rank) of
    `recvs` received into, all posted together (`batch_isend_irecv`) and
    waited for, so neighbours exchanging both ways never deadlock. gloo
    with CUDA tensors goes through host copies (counted)."""
    if not sends and not recvs:
        return
    if pg is None:
        raise ValueError("p2p_exchange between ranks needs a group")
    s_peers = [global_rank(pg, i) for _, i in sends]
    r_peers = [global_rank(pg, i) for _, i in recvs]

    def run(outs, ins):
        ops = [dist.P2POp(dist.isend, t.contiguous(), p, group=pg)
               for t, p in zip(ins, s_peers)]
        ops += [dist.P2POp(dist.irecv, t, p, group=pg)
                for t, p in zip(outs, r_peers)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    _on_host(pg, "batch_isend_irecv", [t for t, _ in recvs],
             [t for t, _ in sends], run)


# ----------------------------------------------------------- public API

def _pg(group):
    return mesh_mod.get_group(group).process_group


def _index(group):
    return mesh_mod.get_group(group).rank


def _ret(x, t):
    """The caller's kind of tensor over t: x itself when it was written
    in place."""
    if isinstance(x, Tensor):
        if x._data is not t:
            x._data = t
        return x
    return t


@_eager_retry
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=True):
    t = unwrap(tensor)
    all_reduce_(t, op, _pg(group))
    return _ret(tensor, t)


@_eager_retry
def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's tensor, in rank order, as a list (and into
    `tensor_list` when given)."""
    t = unwrap(tensor)
    pg = _pg(group)
    out = torch.empty((group_size(pg),) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    all_gather_into(out, t.contiguous(), pg)
    kind = Tensor._wrap if isinstance(tensor, Tensor) else (lambda a: a)
    outs = [kind(o) for o in out.unbind(0)]
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(outs)
    return outs


@_eager_retry
def reduce_scatter(tensor, tensor_or_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """The group's reduction of the input (a list is concatenated on dim
    0), rank i keeping slice i, written into `tensor` (or a new tensor
    when it is None)."""
    src = tensor_or_list
    if isinstance(src, (list, tuple)):
        a = torch.cat([unwrap(x) for x in src], dim=0)
        wrap = isinstance(src[0], Tensor)
    else:
        a = unwrap(src)
        wrap = isinstance(src, Tensor)
    pg = _pg(group)
    n = group_size(pg)
    if a.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(a.shape)} does "
                         f"not divide over {n} ranks")
    if tensor is None:
        out = torch.empty((a.shape[0] // n,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=a.device)
        reduce_scatter_into(out, a.contiguous(), pg, op)
        return Tensor._wrap(out) if wrap else out
    t = unwrap(tensor)
    reduce_scatter_into(t, a.contiguous(), pg, op)
    return _ret(tensor, t)


@_eager_retry
def broadcast(tensor, src=0, group=None, sync_op=True):
    t = unwrap(tensor)
    broadcast_(t, src, _pg(group))
    return _ret(tensor, t)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """SPMD: reduce == all_reduce (every rank holds the result; the dst
    distinction only matters for MPMD runtimes), as in the JAX package."""
    return all_reduce(tensor, op=op, group=group)


@_eager_retry
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank i of the group receives `tensor_list[i]` of the group's rank
    `src` into `tensor` (only `src` needs the list)."""
    t = unwrap(tensor)
    pg = _pg(group)
    if pg is None:
        if tensor_list:
            t.copy_(unwrap(tensor_list[src]))
        return _ret(tensor, t)
    parts = None
    if _index(group) == src:
        if not tensor_list:
            raise ValueError("scatter: the source rank passes tensor_list")
        parts = [unwrap(x).contiguous() for x in tensor_list]

    def run(outs, ins):
        dist.scatter(outs[0], ins if ins else None,
                     src=global_rank(pg, src), group=pg)
    _on_host(pg, "scatter", [t], parts or [], run)
    return _ret(tensor, t)


@_eager_retry
def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank i's output j is rank j's input i."""
    arrays = [unwrap(x) for x in in_tensor_list]
    pg = _pg(group)
    stacked = torch.stack(arrays)
    out = torch.empty_like(stacked)
    all_to_all_into(out, stacked, pg)
    kind = Tensor._wrap if isinstance(in_tensor_list[0], Tensor) \
        else (lambda a: a)
    outs = [kind(o) for o in out.unbind(0)]
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(outs)
    return outs


@_eager_retry
def send(tensor, dst=0, group=None, sync_op=True):
    """p2p to the group's rank `dst` (ref send_v2_op.cc)."""
    t = unwrap(tensor)
    pg = _pg(group)
    if pg is None:
        return tensor

    def run(outs, ins):
        dist.send(ins[0], dst=global_rank(pg, dst), group=pg)
    _on_host(pg, "send", [], [t.contiguous()], run)
    return tensor


@_eager_retry
def recv(tensor, src=0, group=None, sync_op=True):
    """p2p from the group's rank `src`, into `tensor`."""
    t = unwrap(tensor)
    pg = _pg(group)
    if pg is None:
        return tensor

    def run(outs, ins):
        dist.recv(outs[0], src=global_rank(pg, src), group=pg)
    _on_host(pg, "recv", [t], [], run)
    return _ret(tensor, t)


def barrier(group=None):
    """Every rank of the group waits for the others (nothing without a
    process group)."""
    if not dist.is_initialized():
        return
    pg = _pg(group) if group is not None else dist.group.WORLD
    if pg is None:
        return
    if dist.get_backend(pg) == "nccl":
        dist.barrier(group=pg, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    """The host waits for the work queued on the tensor's stream (a
    no-op for CPU tensors and inside a CUDA-graph capture)."""
    t = unwrap(tensor)
    if t.is_cuda and not _capturing():
        torch.cuda.current_stream(t.device).synchronize()
    return tensor


def new_group(ranks=None, backend=None, timeout=None):
    """A group handle: over `ranks` (world ranks; every rank calls this,
    as `torch.distributed.new_group` needs), else bound to the innermost
    axis of the current mesh."""
    axes = mesh_mod.mesh_axes() or (mesh_mod.DP_AXIS,)
    if ranks is None:
        return mesh_mod.register_group(axes[-1])
    ranks = [int(r) for r in ranks]
    pg = None
    if dist.is_initialized() and len(ranks) > 1:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    return mesh_mod.register_group(axes[-1], ranks, pg)


def get_group(gid=0):
    return mesh_mod.get_group(gid)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """ref collective.py:492 paddle.distributed.split, Megatron-style
    parallel linear/embedding, built from `parallel_layers.py` as the
    JAX package builds it: a new layer of the full logical `size`, drawn
    from the framework generator (the same on every rank), run on this
    rank's shard of it over the current mesh's 'mp' slice (the whole
    layer without one). `operation` "linear" with axis 0 is row-parallel
    (the input cut by the rank), axis 1 column-parallel (`gather_out`
    concatenates the outputs); "embedding" is vocab-parallel."""
    from .parallel_layers import (ColumnParallelLinear, LocalShards,
                                  RowParallelLinear, VocabParallelEmbedding,
                                  mp_group)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
    elif operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
    else:
        raise ValueError(f"unknown split operation {operation!r}")
    group = mp_group()
    if group is None:
        return layer(x)
    with LocalShards(layer, group).scope():
        return layer(x)
