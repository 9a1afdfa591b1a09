"""paddle_tpu_torch.distributed (the port of `paddle_tpu/distributed`;
ref python/paddle/distributed): the collective half.

Every rank is a process over `torch.distributed` (NCCL with one card a
rank, gloo when asked for: CPU ranks or ranks sharing a card). `env`
joins a job from the launcher's environment (`launch`, `spawn`); `mesh`
names the axes of a grid of ranks, with one process group per axis
slice; `collective` holds the Paddle collectives over those groups;
`DataParallel` (`parallel`) and `ShardedTrainStep` (`sharded`: dp, sp
and ZeRO-1) train over them; `ring_attention` and `ulysses` are the two
sequence-parallel attentions on the flash kernels; `fleet` is the
strategy front door; `gloo` holds the host-side stores and collectives.
Tensor and pipeline parallelism, ZeRO-3 and the parameter server are
ROADMAP Queue 1 items 5b and 5c.
"""
from .env import (init_parallel_env, get_rank, get_world_size, ParallelEnv,
                  is_initialized)
from .mesh import (MeshContext, get_mesh, set_mesh, mesh_axes, default_mesh)
from .collective import (all_reduce, all_gather, broadcast, reduce, scatter,
                         barrier, send, recv, split, ReduceOp, new_group,
                         wait, reduce_scatter, alltoall)
from .parallel import DataParallel
from .ring_attention import ring_attention, ring_flash_attention
from . import fleet
from .spawn import spawn
from . import utils
from .utils import (find_free_ports, get_host_name_ip, get_logger,
                    get_cluster, add_arguments)
