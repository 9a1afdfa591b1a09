"""The distributed environment (the port of `paddle_tpu/distributed/
env.py`; ref python/paddle/distributed/parallel.py:57 init_parallel_env
and ParallelEnv).

The JAX package runs one process per host that drives every local chip;
here, as PyTorch does it, every rank is a process of its own over
`torch.distributed`. `init_parallel_env` reads the launcher's contract
(`launch._rank_env`: PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_TRAINER_ENDPOINTS and the JAX package's COORDINATOR_ADDRESS,
PROCESS_ID, NUM_PROCESSES) and turns it into a TCP store on the
coordinator's address, hosted by rank 0.

backend=None means NCCL, each rank on its own card `cuda:<device_id>`:
it raises when there is no card, when there are fewer cards than ranks
on this host (PADDLE_LOCAL_SIZE) or when the rank's card is missing.
NCCL refuses two ranks of one communicator on one card, so ranks that
share a card, or run on the CPU, ask for backend="gloo". Nothing falls
back from one backend to the other.
"""
import datetime
import os

import torch
import torch.distributed as dist

_initialized = False


def _env_int(*names, default=0):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v.split(",")[0])
    return int(default)


class ParallelEnv:
    """ref fluid/dygraph/parallel.py ParallelEnv — the env-var cluster
    spec. `device_id` is the rank's card: FLAGS_selected_gpus, else
    PADDLE_LOCAL_RANK, else 0."""

    def __init__(self):
        self._rank = _env_int("PADDLE_TRAINER_ID", "RANK")
        self._world_size = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                    default=1)
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._device_id = _env_int("FLAGS_selected_gpus", "PADDLE_LOCAL_RANK",
                                   "LOCAL_RANK")
        self._local_size = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                                    default=1)

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    local_rank = rank
    nranks = world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def local_size(self):
        return self._local_size

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_cards(env):
    """The card of this rank under NCCL, or a RuntimeError."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_parallel_env: the NCCL backend needs a CUDA card and none "
            "is available; pass backend='gloo' to run ranks on the CPU")
    count = torch.cuda.device_count()
    if count < env.local_size or env.device_id >= count:
        raise RuntimeError(
            f"init_parallel_env: {env.local_size} ranks on this host (this "
            f"one on card {env.device_id}) but {count} CUDA card(s): NCCL "
            f"takes one card a rank; ranks that share a card use "
            f"backend='gloo'")
    return torch.device("cuda", env.device_id)


def init_parallel_env(backend=None, timeout=None):
    """Join this process to the job: the default process group over the
    launcher's TCP store, and the 1-D data-parallel mesh over every rank.
    A second call returns the environment. `timeout` (seconds) bounds
    each collective's wait (torch's default otherwise)."""
    global _initialized
    env = ParallelEnv()
    if _initialized:
        return env
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be None, 'nccl' or 'gloo', got "
                         f"{backend!r}")
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    num_procs = _env_int("NUM_PROCESSES", default=env.world_size)
    proc_id = _env_int("PROCESS_ID", default=env.rank)
    if coordinator is None and num_procs > 1 and env.trainer_endpoints:
        coordinator = env.trainer_endpoints[0]
    if coordinator is None:
        if num_procs > 1:
            raise RuntimeError(
                "init_parallel_env: a world of more than one rank needs "
                "COORDINATOR_ADDRESS or PADDLE_TRAINER_ENDPOINTS (the "
                "launcher's contract)")
        coordinator = f"127.0.0.1:{_free_port()}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if backend in (None, "nccl"):
        dev = _check_cards(env)
        torch.cuda.set_device(dev)
        # bound to its card, the communicator is made here, outside any
        # CUDA-graph capture
        kw["device_id"] = dev
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_procs, rank=proc_id, **kw)
    from .mesh import default_mesh
    default_mesh()
    _initialized = True
    return env


def is_initialized():
    return _initialized


def get_rank():
    if dist.is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def get_world_size():
    if dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size


def destroy():
    """Leave the job: the process group and the mesh registry are
    dropped (a rank calls it before it exits)."""
    global _initialized
    from . import mesh
    mesh.reset()
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
