"""paddle_tpu_torch.distributed (the port of `paddle_tpu/distributed`;
ref python/paddle/distributed): collectives, data, sequence, tensor and
pipeline parallelism.

Every rank is a process over `torch.distributed` (NCCL with one card a
rank, gloo when asked for: CPU ranks or ranks sharing a card). `env`
joins a job from the launcher's environment (`launch`, `spawn`); `mesh`
names the axes of a grid of ranks, with one process group per axis
slice; `collective` holds the Paddle collectives over those groups;
`DataParallel` (`parallel`) and `ShardedTrainStep` (`sharded`: dp, sp,
mp, ZeRO-1 and ZeRO-3, `exact_reshard`) train over them;
`parallel_layers` holds the Megatron layers, their conjugate
collectives over the 'mp' slice and the release of the weights a rank
holds only a part of; `PipelineTrainStep` (`pipeline`, GPipe) and
`OneF1BTrainStep` (`pipeline_1f1b`) run one stage a process over 'pp',
composed with 'dp' and 'mp', each rank holding its stage alone;
`ring_attention` and `ulysses` are the two sequence-parallel attentions
on the flash kernels; `fleet` is the strategy front door; `gloo` holds
the host-side stores and collectives. The parameter server and
cross-card BatchNorm are ROADMAP Queue 1 item 5c.
"""
from .env import (init_parallel_env, get_rank, get_world_size, ParallelEnv,
                  is_initialized)
from .mesh import (MeshContext, get_mesh, set_mesh, mesh_axes, default_mesh)
from .collective import (all_reduce, all_gather, broadcast, reduce, scatter,
                         barrier, send, recv, split, ReduceOp, new_group,
                         wait, reduce_scatter, alltoall)
from .parallel import DataParallel
from .parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding, ParallelCrossEntropy)
from .pipeline import (PipelineTrainStep, PipelineParts, device_guard,
                       pipeline_apply)
from .pipeline_1f1b import OneF1BTrainStep, simulate_1f1b
from .sharded import ShardedTrainStep
from .ring_attention import ring_attention, ring_flash_attention
from . import fleet
from .spawn import spawn
from . import utils
from .utils import (find_free_ports, get_host_name_ip, get_logger,
                    get_cluster, add_arguments)
