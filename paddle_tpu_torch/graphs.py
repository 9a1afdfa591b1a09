"""CUDA-graph programs over static device buffers, shared by the
serving engines, `nlp.generate` and `jit.TrainStep`.

`StaticInputs` holds a program's inputs in one device byte buffer that
is never replaced, written through one pinned host buffer and one copy
per run. `Program` runs a function over such buffers eagerly on the CPU
(or with `cuda_graph=False`) and, on the card, as one CUDA graph per
key: call 1 eager on a side stream, call 2 captured, then replays.
"""
import gc

import numpy as np
import torch

from . import kernels

_NUMPY = {torch.int64: np.int64, torch.int32: np.int32,
          torch.float32: np.float32, torch.bool: np.bool_}


class StaticInputs:
    """The input buffers of one engine program, allocated once and never
    replaced: a CUDA graph replays on the addresses it captured.

    `fields` [(name, dtype, shape)] are typed views (`tensors[name]`) of
    one device byte buffer, written through numpy views (`host[name]`)
    of one pinned host byte buffer and moved by one copy per run:
    `stage()` returns the host views once the previous run's copy has
    read them (a run that ends without a sync may still be queued behind
    it), `upload()` enqueues the copy. `add` registers a device buffer
    the program reads that moves by other means (the logit bias, the
    Gumbel noise the program draws)."""

    def __init__(self, fields, device):
        spans, size = {}, 0
        for name, dtype, shape in fields:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            spans[name] = (size, size + nbytes)
            size += -(-nbytes // 16) * 16
        self.device = device
        self._dev = torch.empty(size, dtype=torch.uint8, device=device)
        self._host = torch.empty(size, dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        raw = self._host.numpy()
        self.host, self.tensors = {}, {}
        for name, dtype, shape in fields:
            a, b = spans[name]
            self.host[name] = raw[a:b].view(_NUMPY[dtype]).reshape(shape)
            self.tensors[name] = self._dev[a:b].view(dtype).reshape(shape)
        self._copied = None

    def add(self, name, tensor):
        self.tensors[name] = tensor

    def stage(self):
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        return self.host

    def upload(self):
        self._dev.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()


class _Graph:
    """One captured program: the graph, its output tensors, the kernel
    launches it holds (by `kernels.launch_counts` key) and its replays."""

    def __init__(self, graph, outs, launches):
        self.graph = graph
        self.outs = outs
        self.launches = launches
        self.replays = 0


class Program:
    """One program, `fn(key)` over the engine's static buffers,
    returning its output tensors. Eager on the CPU or with
    `cuda_graph=False`. Otherwise one CUDA graph per key, captured as
    the first call with a key runs `fn` eagerly on a side stream (a real
    run that initialises the kernel libraries, cuBLAS and any state `fn`
    creates), the second captures it (every generator of `generators`
    registered, so each replay draws fresh noise) and replays, every
    later call replays and returns the graph's own output tensors, which
    the next replay overwrites. `graphs` maps each key to its `_Graph`
    (None after its eager first call). The graphs of one program share a
    memory pool; each program has its own."""

    def __init__(self, name, fn, device, cuda_graph, generators):
        self.name = name
        self._fn = fn
        self._device = device
        self._generators = list(generators)
        self.graphed = bool(cuda_graph) and device.type == "cuda"
        self.graphs = {}
        self._pool = None

    @property
    def compiles(self):
        return sum(g is not None for g in self.graphs.values())

    @property
    def replays(self):
        return sum(g.replays for g in self.graphs.values() if g is not None)

    def __call__(self, key):
        with torch.profiler.record_function(self.name):
            if not self.graphed:
                return self._fn(key)
            if key not in self.graphs:
                self.graphs[key] = None
                return self._warm_up(key)
            g = self.graphs[key]
            if g is None:
                g = self.graphs[key] = self._capture(key)
            g.graph.replay()
            g.replays += 1
            return g.outs

    def _warm_up(self, key):
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outs = self._fn(key)
        current.wait_stream(side)
        return outs

    def _capture(self, key):
        # a dead reference cycle may hold another program's graph (an
        # engine and its scheduler's health probe form one): collected
        # during this capture, that graph could not be reset, so collect
        # it now (torch.cuda.graph no longer does)
        gc.collect()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        before = kernels.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outs = self._fn(key)
        except Exception as exc:
            raise RuntimeError(f"{self.name}: CUDA-graph capture failed: "
                               f"{exc}") from exc
        after = kernels.launch_counts()
        if self._pool is None:
            self._pool = graph.pool()
        return _Graph(graph, outs,
                      {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)})
