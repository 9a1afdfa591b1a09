"""The port's fleet (paddle_tpu_torch.distributed.fleet) and the strategy
transforms of its train steps (paddle_tpu_torch.jit.transforms) against
the JAX package's.

In this process: `DistributedStrategy`'s defaults; the meta-optimizer
chain each strategy builds (its links and its transforms dict); and
amp (O1, O2), recompute and gradient merge changing a `jit.TrainStep`
over a small MLP as they change the JAX one (4 steps; losses within the
AMP tolerance of tests/test_torch_amp.py under bf16, 2e-2 x max(1,
|ref|), 5e-2 at O2, and 1e-6 x max(1, |ref|) in f32, the recompute
tolerance of tests/test_torch_incubate.py). In one world of 2 gloo
ranks started through the port's launcher (`tests/torch_dist_ranks.py`):
the meshes `fleet.init` builds from `hybrid_configs`, the step
`build_train_step` picks (a PipelineTrainStep for the pipeline
strategy, as the JAX one; the refusals of the DGC and LocalSGD steps
name ROADMAP item 5c), and the port twin of
examples/dist_mnist.py, converging at the JAX test's bar
(tests/test_examples.py:30-34: the last losses under half the first).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.fleet as tfleet
import torch_dist_ranks as ranks
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch.jit import TrainStep

torch.set_num_threads(1)

N = 2
HYBRID = [{"dp_degree": 2}, {"mp_degree": 2}, {"pp_degree": 2},
          {"sp_degree": 2}, {"sharding_degree": 2},
          {"tensor_parallel": True, "tp": 2},
          {"dp_degree": 4, "mp_degree": 4}]
STRATEGIES = {"plain": {}, "sharding": {"sharding": True},
              "amp": {"amp": True}, "pipeline": {"pipeline": True},
              "dgc": {"dgc": True}, "localsgd": {"localsgd": True}}
CHAINS = {
    "default": {}, "amp": {"amp": True},
    "amp_o2": {"amp": True, "amp_configs": {"use_pure_bf16": True}},
    "recompute": {"recompute": True},
    "gradient_merge": {"gradient_merge": True,
                       "gradient_merge_configs": {"k_steps": 2,
                                                  "avg": True}},
    "sharding": {"sharding": True, "sharding_configs": {"stage": 1}},
    "fp16_allreduce": {"fp16_allreduce": True}, "lamb": {"lamb": True},
    "lars": {"lars": True}, "localsgd": {"localsgd": True},
    "adaptive_localsgd": {"adaptive_localsgd": True}, "dgc": {"dgc": True},
    "pipeline": {"pipeline": True}, "auto": {"auto": True},
    "stacked": {"amp": True, "recompute": True, "sharding": True,
                "gradient_merge": True},
}
# sharding on a mesh of one rank
ONE_RANK = {"one_rank_sharding": {"stage": 1},
            "one_rank_exact": {"stage": 1, "exact_reshard": True}}
RNG = np.random.RandomState(0)
MLP_X = RNG.randn(8, 16).astype("f4")
MLP_Y = RNG.randn(8, 4).astype("f4")


@pytest.fixture(autouse=True)
def reset_mesh():
    yield
    jmesh._current_mesh = None


# autouse: the ranks start with the module's first test and run while
# the in-process tests compute
@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    inputs = {"hybrid": np.array(json.dumps(HYBRID)),
              "strategies": np.array(json.dumps(STRATEGIES)),
              "one_rank": np.array(json.dumps(ONE_RANK))}
    return ranks.World(tmp_path_factory.mktemp("fleet"), N,
                       ("fleet_meshes", "build_step", "dist_mnist"), inputs)


def _strategy(mod, flags):
    s = mod.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    return s


def test_strategy_defaults_equal_jax():
    assert vars(tfleet.DistributedStrategy()) == \
        vars(jfleet.DistributedStrategy())


def _chain(opt):
    names = []
    while hasattr(opt, "inner_opt"):
        names.append(type(opt).__name__)
        opt = opt.inner_opt
    return names + [type(opt).__name__]


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_meta_optimizer_chain_records_the_jax_transforms(name):
    flags = CHAINS[name]
    jnet = pj.nn.Linear(4, 4)
    jopt = jfleet.distributed_optimizer(
        pj.optimizer.Momentum(0.1, parameters=jnet.parameters()),
        _strategy(jfleet, flags))
    tnet = torch.nn.Linear(4, 4)
    topt = tfleet.distributed_optimizer(
        pt.optimizer.Momentum(0.1, parameters=list(tnet.parameters())),
        _strategy(tfleet, flags))
    assert _chain(topt) == _chain(jopt)
    assert topt.transforms == jopt.transforms


def _mlp(mod, seed):
    mod.seed(seed)
    nn = mod.nn
    return nn.Sequential(nn.Linear(16, 32), nn.GELU(), nn.Linear(32, 4))


@pytest.mark.parametrize("name,tol", [("amp", 2e-2), ("amp_o2", 5e-2),
                                      ("recompute", 1e-6),
                                      ("gradient_merge", 1e-6)])
def test_transforms_change_the_train_step_as_in_jax(name, tol):
    flags = CHAINS[name]
    jm = _mlp(pj, 4)
    init = {k: v.numpy() for k, v in jm.state_dict().items()}
    jstep = JTrainStep(jm, pj.nn.functional.mse_loss,
                       jfleet.distributed_optimizer(
                           pj.optimizer.AdamW(
                               1e-2, parameters=jm.parameters()),
                           _strategy(jfleet, flags)))
    want = [float(jstep(MLP_X, MLP_Y).numpy()) for _ in range(4)]
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        tm = _mlp(pt, 4)
        tm.set_state_dict(init)
        tstep = TrainStep(tm, pt.nn.functional.mse_loss,
                          tfleet.distributed_optimizer(
                              pt.optimizer.AdamW(1e-2,
                                                 parameters=tm.parameters()),
                              _strategy(tfleet, flags)))
        got = [float(tstep(torch.tensor(MLP_X), torch.tensor(MLP_Y)))
               for _ in range(4)]
    finally:
        pt.set_device(old)
    assert tstep.transforms == jstep.transforms
    for g, w in zip(got, want):
        assert abs(g - w) <= tol * max(1.0, abs(w)), (got, want)
    if name == "gradient_merge":
        # k = 2: the first update lands after the second call
        assert got[0] == got[1] and got[2] != got[1]


def test_fleet_init_builds_the_jax_meshes(world):
    want = []
    for hc in HYBRID:
        hc = dict(hc)
        jmesh._current_mesh = None
        s = jfleet.DistributedStrategy()
        if hc.pop("tensor_parallel", None):
            s.tensor_parallel = True
            s.tensor_parallel_configs = {"tensor_parallel_degree":
                                         hc.pop("tp")}
        s.hybrid_configs = dict(s.hybrid_configs, **hc)
        jfleet.init(is_collective=True, strategy=s)
        m = jmesh.get_mesh()
        want.append(None if m is None else dict(m.shape))
    for res in world.job("fleet_meshes"):
        got = [json.loads(str(res[str(i)])) for i in range(len(HYBRID))]
        assert got == want


class _Picked:
    """Stands for a JAX step class in build_train_step: records which
    one the strategy picked, builds nothing."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args, **kwargs):
        return self.name


def test_build_train_step_picks_the_jax_step(world, monkeypatch):
    import paddle_tpu.distributed.dgc as jdgc
    import paddle_tpu.distributed.localsgd as jlocal
    import paddle_tpu.distributed.pipeline as jpipe
    import paddle_tpu.distributed.sharded as jsharded
    import paddle_tpu.jit as jjit
    for mod, name in ((jpipe, "PipelineTrainStep"), (jdgc, "DGCTrainStep"),
                      (jlocal, "LocalSGDTrainStep"),
                      (jsharded, "ShardedTrainStep"), (jjit, "TrainStep")):
        monkeypatch.setattr(mod, name, _Picked(name))
    want = {}
    for name, flags in STRATEGIES.items():
        s = _strategy(jfleet, flags)
        axis = "pp_degree" if flags.get("pipeline") else "dp_degree"
        s.hybrid_configs = dict(s.hybrid_configs, **{axis: N})
        jfleet.init(is_collective=True, strategy=s)
        net = pj.nn.Linear(4, 4)
        opt = jfleet.distributed_optimizer(
            pj.optimizer.SGD(0.1, parameters=net.parameters()), s)
        want[name] = jfleet.build_train_step(net, pj.nn.functional.mse_loss,
                                             opt)
    item = {"DGCTrainStep": "5c", "LocalSGDTrainStep": "5c"}
    for res in world.job("build_step"):
        for name, jax_step in want.items():
            got = str(res[name])
            if jax_step in item:
                assert got.startswith("refused") and jax_step in got \
                    and f"item {item[jax_step]}" in got, (name, got)
            else:
                assert got == jax_step, (name, got, jax_step)


def test_build_train_step_on_one_rank_departs_only_for_exact_reshard(
        world, monkeypatch):
    """On a mesh of one rank the JAX fleet builds a TrainStep under
    sharding. The port does too, except with `exact_reshard`, where it
    builds a ShardedTrainStep, so a checkpoint written over more ranks
    resumes on one bit for bit (the port's one departure)."""
    import paddle_tpu.distributed.sharded as jsharded
    import paddle_tpu.jit as jjit
    for mod, name in ((jsharded, "ShardedTrainStep"), (jjit, "TrainStep")):
        monkeypatch.setattr(mod, name, _Picked(name))
    want = {}
    for name, cfg in ONE_RANK.items():
        s = _strategy(jfleet, {"sharding": True, "sharding_configs": cfg})
        jmesh.make_mesh({"dp": 1})
        net = pj.nn.Linear(4, 4)
        opt = jfleet.distributed_optimizer(
            pj.optimizer.SGD(0.1, parameters=net.parameters()), s)
        want[name] = jfleet.build_train_step(net, pj.nn.functional.mse_loss,
                                             opt)
    assert want == {"one_rank_sharding": "TrainStep",
                    "one_rank_exact": "TrainStep"}
    got = world.job("build_step")[0]
    assert str(got["one_rank_sharding"]) == "TrainStep"
    assert str(got["one_rank_exact"]) == "ShardedTrainStep"


def test_dist_mnist_twin_converges_over_two_ranks(world):
    """examples/dist_mnist.py's bar: the mean of the last 5 losses under
    half the mean of the first 5, both ranks seeing the same global
    losses through ShardedTrainStep."""
    res = world.job("dist_mnist")
    assert res[0]["losses"].tolist() == res[1]["losses"].tolist()
    losses = res[0]["losses"]
    assert str(res[0]["step"]) == "ShardedTrainStep"
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert np.isfinite(losses).all() and last < first * 0.5, (first, last)
