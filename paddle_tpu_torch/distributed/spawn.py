"""paddle.distributed.spawn (the port of `paddle_tpu/distributed/spawn.py`;
ref python/paddle/distributed/spawn.py:276).

`nprocs` processes started with `torch.multiprocessing`'s "spawn" method
(a fresh interpreter each: no CUDA state crosses a fork), each calling
`func(*args)` with the launcher's per-rank environment set:
PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT (rank 0's endpoint is the rendezvous address
`env.init_parallel_env` uses), PADDLE_LOCAL_RANK and PADDLE_LOCAL_SIZE.
`func` must be importable by name (the spawned interpreter unpickles
it). nprocs <= 1 runs `func` in this process.
"""
import os
import sys
import traceback

import torch.multiprocessing as mp

from .utils import find_free_ports


class _SpawnContext:
    def __init__(self, procs, error_queues):
        self.processes = procs
        self.error_queues = error_queues

    def join(self, timeout=None):
        """Wait for every rank; a rank that failed (or outlived
        `timeout` seconds) stops the others and raises its traceback."""
        for i, p in enumerate(self.processes):
            p.join(timeout)
            failed = p.exitcode not in (0, None) or p.is_alive()
            if failed:
                for q in self.processes:
                    if q.is_alive():
                        q.terminate()
                for q in self.processes:
                    q.join(10)
                eq = self.error_queues[i]
                msg = eq.get() if not eq.empty() else (
                    f"exitcode {p.exitcode}" if p.exitcode is not None
                    else f"still running after {timeout} s")
                raise RuntimeError(f"spawned rank {i} failed:\n{msg}")
        return True


def _worker(func, args, error_queue, env):
    try:
        os.environ.update(env)
        func(*args)
    except Exception:
        error_queue.put(traceback.format_exc())
        sys.exit(1)


def rank_env(rank, nprocs, endpoints):
    """The per-rank environment `spawn` sets (also used by callers that
    start their own rank processes)."""
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_LOCAL_SIZE": str(nprocs),
    }


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """Run func(*args) in `nprocs` rank processes. `started_port` fixes
    the endpoints' first port (else free ports are taken). Returns None
    after joining, or the context to `join()` when join=False."""
    if nprocs <= 1:
        func(*args)
        return None
    ctx = mp.get_context("spawn")
    if "started_port" in options:
        base = int(options["started_port"])
        ports = [base + i for i in range(nprocs)]
    else:
        ports = sorted(find_free_ports(nprocs))
    endpoints = [f"127.0.0.1:{p}" for p in ports]
    procs, eqs = [], []
    for rank in range(nprocs):
        eq = ctx.SimpleQueue()
        p = ctx.Process(target=_worker,
                        args=(func, args, eq,
                              rank_env(rank, nprocs, endpoints)),
                        daemon=daemon)
        p.start()
        procs.append(p)
        eqs.append(eq)
    context = _SpawnContext(procs, eqs)
    if join:
        context.join()
        return None
    return context
