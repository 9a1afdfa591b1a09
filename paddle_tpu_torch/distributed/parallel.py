"""DataParallel (the port of `paddle_tpu/distributed/parallel.py`; ref
python/paddle/fluid/dygraph/parallel.py:322 and the bucketed Reducer of
imperative/reducer.cc).

The wrapper marks a model data parallel and keeps the Paddle surface:
`scale_loss` returns the loss as it is, and `apply_collective_grads`,
called after `backward()`, is the mean of every gradient over the
data-parallel group: one flat bucket of the grads of one dtype,
all-reduced on the device and divided by the group's size, then copied
back (row-sparse grads are densified first). With one rank it does
nothing. The compiled training path is `sharded.ShardedTrainStep`,
which reduces inside its step.
"""
import torch

from ..framework.tensor import unwrap
from ..nn.layer import Layer
from . import collective
from . import mesh as mesh_mod


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.comm_buffer_size = comm_buffer_size
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        mesh_mod.default_mesh()
        self._data_parallel = True

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """ref parallel.py:506: the mean is taken in
        apply_collective_grads, so the loss is not pre-scaled."""
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Every gradient replaced by its mean over the data-parallel
        group (ref parallel.py:515 + imperative/reducer.cc): one flat
        bucket per dtype, one all-reduce each, on the grads' device."""
        pg = mesh_mod.get_group(self._group).process_group
        n = collective.group_size(pg)
        if n <= 1:
            return
        leaves = [unwrap(p) for p in self._layers.parameters()]
        leaves = [p for p in leaves if p.grad is not None]
        for p in leaves:
            if p.grad.is_sparse:
                p.grad = p.grad.to_dense()
        by_dtype = {}
        for p in leaves:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for group in by_dtype.values():
            grads = [p.grad for p in group]
            flat = torch.cat([g.reshape(-1) for g in grads])
            collective.all_reduce_(flat, collective.ReduceOp.SUM, pg)
            flat.div_(n)
            torch._foreach_copy_(grads, [
                v.view_as(g) for v, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])

    # the wrapped layer's state
    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, sd, *args, **kwargs):
        return self._layers.set_state_dict(sd, *args, **kwargs)

    set_dict = set_state_dict
