"""Fleet base, the collective half (the port of `paddle_tpu/distributed/
fleet/base.py`; ref fleet/base/fleet_base.py:63,130,598,643,
base/role_maker.py:528, base/distributed_strategy.py and
framework/distributed_strategy.proto:122).

The role makers, `DistributedStrategy` (the reference's strategy bag,
its defaults the JAX package's), `init` (which builds the mesh from
`hybrid_configs`), the worker queries, `distributed_model`,
`distributed_optimizer` (the meta-optimizer chain, meta_optimizers.py)
and `build_train_step`, which turns the chain's transforms into a
`ShardedTrainStep` over a mesh of more than one rank or a
`jit.TrainStep` otherwise; `UtilBase` runs its host collectives over
`gloo.py`'s stores. The optimizer passthroughs (`minimize`, `step`,
`clear_grad`, `get_lr`/`set_lr`, `state_dict`/`set_state_dict`) reach
the latest distributed optimizer.

Not ported here: the parameter-server lifecycle (`init_server`,
`run_server`, `init_worker`, `stop_worker`, `shrink`,
`save_persistables`: ROADMAP Queue 1 item 5c), the static-graph
`save_inference_model` (item 7), and the steps of DGC and LocalSGD
(item 5c), which `build_train_step` refuses by name.
"""
import os

from ..env import ParallelEnv, get_rank, get_world_size
from .. import mesh as mesh_mod


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = []
        self._server_endpoints = []

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class UserDefinedRoleMaker(RoleMakerBase):
    """ref role_maker.py:875 — an explicit cluster spec (tests)."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=0, worker_endpoints=None, server_endpoints=None,
                 **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = worker_endpoints or \
            [f"127.0.0.1:{36000 + i}" for i in range(worker_num)]
        self._server_endpoints = server_endpoints or []


class PaddleCloudRoleMaker(RoleMakerBase):
    """ref role_maker.py:861 — the PADDLE_* environment."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        env = ParallelEnv()
        self._current_id = env.rank
        self._worker_endpoints = env.trainer_endpoints or ["127.0.0.1:36000"]
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = eps.split(",") if eps else []
        if training_role == "PSERVER":
            self._role = Role.SERVER
            self._current_id = int(os.environ.get("PADDLE_PSERVER_ID", 0))
        else:
            self._role = Role.WORKER


class DistributedStrategy:
    """ref distributed_strategy.proto:122 — feature flags and their
    configs, with the JAX package's defaults."""

    def __init__(self):
        # collective features
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_bf16": False}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {"fuse_broadcast_MB": 32,
                                 "sharding_degree": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                               "sharding_degree": 1, "sp_degree": 1}
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1,
                                          "begin_step": 1}
        self.fp16_allreduce = False
        self.fp16_allreduce_configs = {"dtype": "float16"}
        self.find_unused_parameters = False
        # async PS
        self.a_sync = False
        self.a_sync_configs = {"k_steps": 0, "launch_barrier": True}
        # misc mirrors
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = True
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.auto = False
        self.elastic = False
        self.build_strategy = None
        self.execution_strategy = None

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"


class UtilBase:
    """ref fleet/utils/fleet_util.py + base/util_factory.py: host-side
    collectives over the launcher's store (`gloo.collective_from_env`),
    the single-process identity without one."""

    def _host(self):
        if not hasattr(self, "_host_coll"):
            from ..gloo import collective_from_env
            self._host_coll = collective_from_env()
        return self._host_coll

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        hc = self._host()
        if hc is None:
            return input
        import numpy as np
        out = hc.all_reduce(np.asarray(input), op=mode)
        return out if hasattr(input, "shape") else type(input)(out)

    def barrier(self, comm_world="worker"):
        hc = self._host()
        if hc is not None:
            hc.barrier()
            return
        from ..collective import barrier as _barrier
        _barrier()

    def all_gather(self, input, comm_world="worker"):
        hc = self._host()
        if hc is None:
            return [input]
        import json as _json
        parts = hc.all_gather(_json.dumps(input).encode())
        return [_json.loads(p) for p in parts]

    def print_on_rank(self, message, rank_id=0):
        """ref util_factory.py print_on_rank."""
        if worker_index() == rank_id:
            print(message, flush=True)

    def get_file_shard(self, files):
        idx = worker_index()
        n = worker_num()
        return [f for i, f in enumerate(files) if i % n == idx]


class _FleetState:
    def __init__(self):
        self.role_maker = None
        self.strategy = None
        self.initialized = False
        self.latest_opt = None
        self.util = UtilBase()


_fleet = _FleetState()


def init(role_maker=None, is_collective=False, strategy=None):
    """ref fleet_base.py:130: the role maker and strategy, and the mesh
    `hybrid_configs` asks for (its degrees above 1, in the order dp, pp,
    sharding, mp, sp), made when the world has enough ranks; else the
    1-D data-parallel mesh. `strategy.tensor_parallel` is the non-hybrid
    spelling of an mp degree. Making a mesh is collective (every rank
    calls init)."""
    _fleet.role_maker = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    _fleet.strategy = strategy or DistributedStrategy()
    _fleet.initialized = True
    # a re-init starts a fresh job: no stale optimizer handle
    _fleet.latest_opt = None
    hc = dict(_fleet.strategy.hybrid_configs)
    if getattr(_fleet.strategy, "tensor_parallel", False):
        tp = int(getattr(_fleet.strategy, "tensor_parallel_configs", {})
                 .get("tensor_parallel_degree", 1) or 1)
        if tp > 1 and int(hc.get("mp_degree", 1) or 1) <= 1:
            hc["mp_degree"] = tp
    axes = {}
    for key, name in (("dp_degree", mesh_mod.DP_AXIS),
                      ("pp_degree", mesh_mod.PP_AXIS),
                      ("sharding_degree", "sharding"),
                      ("mp_degree", mesh_mod.MP_AXIS),
                      ("sp_degree", mesh_mod.SP_AXIS)):
        d = int(hc.get(key, 1) or 1)
        if d > 1:
            axes[name] = d
    if axes:
        total = 1
        for v in axes.values():
            total *= v
        if total <= get_world_size():
            mesh_mod.make_mesh(axes)
    else:
        mesh_mod.default_mesh()
    return _fleet


def is_first_worker():
    return _fleet.role_maker is None or _fleet.role_maker.is_first_worker()


def worker_index():
    return _fleet.role_maker.worker_index() if _fleet.role_maker else get_rank()


def worker_num():
    return _fleet.role_maker.worker_num() if _fleet.role_maker \
        else get_world_size()


def is_worker():
    return _fleet.role_maker is None or _fleet.role_maker.is_worker()


def worker_endpoints(to_string=False):
    eps = _fleet.role_maker.get_trainer_endpoints() if _fleet.role_maker else []
    return ",".join(eps) if to_string else eps


def server_num():
    return _fleet.role_maker.server_num() if _fleet.role_maker else 0


def server_index():
    return _fleet.role_maker.server_index() if _fleet.role_maker else 0


def server_endpoints(to_string=False):
    eps = _fleet.role_maker.get_pserver_endpoints() if _fleet.role_maker else []
    return ",".join(eps) if to_string else eps


def is_server():
    return _fleet.role_maker is not None and _fleet.role_maker.is_server()


def barrier_worker():
    from ..collective import barrier
    barrier()


def distributed_model(model):
    """ref fleet_base.py:643 — wrapped for data parallelism."""
    from ..parallel import DataParallel
    if isinstance(model, DataParallel):
        return model
    return DataParallel(model)


def distributed_optimizer(optimizer, strategy=None):
    """ref fleet_base.py:598 — the meta-optimizer chain of the strategy
    (meta_optimizers.py)."""
    from .meta_optimizers import build_distributed_optimizer
    strat = strategy or _fleet.strategy or DistributedStrategy()
    _fleet.strategy = strat
    _fleet.latest_opt = build_distributed_optimizer(optimizer, strat)
    return _fleet.latest_opt


def _not_ported(feature, item):
    raise NotImplementedError(
        f"fleet.build_train_step: the {feature} step is not ported yet "
        f"(ROADMAP Queue 1 item {item})")


def build_train_step(model, loss_fn, optimizer, **kwargs):
    """The train step the chain's transforms imply (ref fleet_base.py:
    1070 minimize -> strategy_compiler -> the meta-optimizers): a
    `pipeline.PipelineTrainStep` for the pipeline transform on a mesh
    with 'pp' (its microbatches `accumulate_steps`), a `ShardedTrainStep`
    over a mesh of more than one rank, else a `jit.TrainStep`, the last
    two reading amp, recompute, sharding, gradient_merge and
    fp16_allreduce. A DGC or LocalSGD transform raises (over more than
    one rank).

    One departure from the JAX package: on a mesh of one rank, sharding
    with `exact_reshard` still builds a `ShardedTrainStep` (the JAX one
    builds a TrainStep), so a checkpoint an exact_reshard run wrote over
    more ranks resumes on one under the same contract, bit for bit."""
    from ...jit import TrainStep, transforms as tfm
    from ..parallel import DataParallel
    if isinstance(model, DataParallel):
        model = model._layers
    tf = tfm.resolve(optimizer)
    mesh = mesh_mod.get_mesh()
    ndev = mesh.size if mesh is not None else 1
    ro = bool(kwargs.pop("return_outputs", False))
    if tf.get("pipeline") is not None and mesh is not None and \
            mesh_mod.PP_AXIS in mesh.axis_names:
        from ..pipeline import PipelineTrainStep
        cfg = tf["pipeline"]
        return PipelineTrainStep(
            model, loss_fn, optimizer,
            num_micro=max(1, int(cfg.get("accumulate_steps", 1) or 1)),
            **kwargs)
    if tf.get("dgc") is not None and ndev > 1:
        _not_ported("DGC (DGCTrainStep)", "5c")
    if tf.get("localsgd") is not None and ndev > 1:
        _not_ported("LocalSGD (LocalSGDTrainStep)", "5c")
    exact = (tf.get("sharding") or {}).get("exact_reshard")
    if ndev > 1 or (mesh is not None and exact):
        from ..sharded import ShardedTrainStep
        return ShardedTrainStep(model, loss_fn, optimizer,
                                return_outputs=ro, **kwargs)
    return TrainStep(model, loss_fn, optimizer, return_outputs=ro,
                     **kwargs)


def _last_opt():
    opt = _fleet.latest_opt
    if opt is None:
        raise RuntimeError(
            "no distributed optimizer yet — call "
            "fleet.distributed_optimizer(opt) first")
    return opt


def minimize(loss, startup_program=None, parameter_list=None,
             no_grad_set=None):
    return _last_opt().minimize(loss, startup_program, parameter_list,
                                no_grad_set)


def step():
    return _last_opt().inner_opt.step()


def clear_grad():
    return _last_opt().inner_opt.clear_grad()


def get_lr():
    return _last_opt().inner_opt.get_lr()


def set_lr(value):
    return _last_opt().inner_opt.set_lr(value)


def state_dict():
    return _last_opt().inner_opt.state_dict()


def set_state_dict(state):
    return _last_opt().inner_opt.set_state_dict(state)


def amp_init(place=None, scope=None, test_program=None, use_fp16_test=False):
    """ref fleet_base.py amp_init: the AMP transform keeps f32 weights
    for the update, so there is nothing to set up."""
    return None


def _ps(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"fleet.{name}: the parameter-server mode is not ported yet "
            f"(ROADMAP Queue 1 item 5c, fleet/{{ps,heter,runtime,"
            f"trainers}}.py)")
    fn.__name__ = name
    return fn


init_server = _ps("init_server")
run_server = _ps("run_server")
init_worker = _ps("init_worker")
stop_worker = _ps("stop_worker")
shrink = _ps("shrink")
save_persistables = _ps("save_persistables")


def save_inference_model(executor, dirname, feeded_var_names, target_vars,
                         main_program=None, export_for_deployment=True,
                         mode=0):
    """ref fleet_base.py save_inference_model: a static program's export,
    ROADMAP Queue 1 item 7 (the static graph)."""
    raise NotImplementedError(
        "fleet.save_inference_model exports a static program: the static "
        "graph is not ported yet (ROADMAP Queue 1 item 7)")


class _FleetModule:
    """Attribute-style facade: fleet.init(...), fleet.worker_num()..."""
    init = staticmethod(init)
    is_first_worker = staticmethod(is_first_worker)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_worker = staticmethod(is_worker)
    worker_endpoints = staticmethod(worker_endpoints)
    server_num = staticmethod(server_num)
    server_index = staticmethod(server_index)
    server_endpoints = staticmethod(server_endpoints)
    is_server = staticmethod(is_server)
    barrier_worker = staticmethod(barrier_worker)
    distributed_optimizer = staticmethod(distributed_optimizer)
    distributed_model = staticmethod(distributed_model)
    build_train_step = staticmethod(build_train_step)

    @property
    def util(self):
        return _fleet.util


fleet = _FleetModule()

# the fleet OBJECT mirrors the reference singleton: every facade function
# is reachable as fleet.<name> too
for _fn in (init_server, run_server, init_worker, stop_worker, shrink,
            minimize, step, clear_grad, get_lr, set_lr, state_dict,
            set_state_dict, amp_init, save_persistables,
            save_inference_model):
    setattr(_FleetModule, _fn.__name__, staticmethod(_fn))
del _fn
