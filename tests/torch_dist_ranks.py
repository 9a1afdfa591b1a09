"""Rank processes of the port's distributed tests.

`World` starts one world of gloo ranks on the CPU through the port's
launcher (`python -m paddle_tpu_torch.distributed.launch
--nproc_per_node n tests/torch_dist_ranks.py <spec>`), in the
background, so the test process computes the JAX package's side while
the ranks run. Each rank runs `main`: it joins the world
(`init_parallel_env(backend="gloo")`), runs the spec's jobs (`JOBS`, the
rank bodies below) on the inputs the test wrote (numpy, seeded; JAX
weights carried as arrays) and saves its results as
`<out>.<rank>.npz`. A rank imports torch, numpy and the port only, and
runs one intra-op thread.

Each test file starts one world (a module-scoped fixture) and reads the
results of its jobs by name.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_pair():
    """A port p with p + 1 free too (the launcher's coordinator and its
    host-collective store)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
        return p
    raise RuntimeError("no free pair of ports")


def rank_env():
    """The environment of a rank process (and of the launcher)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    return env


class World:
    """`n` gloo ranks running `jobs` on `inputs` (name -> array), started
    at once; `results()` waits for them."""

    def __init__(self, tmp, n, jobs, inputs, timeout=240):
        self.tmp = str(tmp)
        self.n = n
        self.timeout = timeout
        os.makedirs(self.tmp, exist_ok=True)
        np.savez(os.path.join(self.tmp, "inputs.npz"), **inputs)
        self.spec = {"jobs": list(jobs), "inputs": os.path.join(
            self.tmp, "inputs.npz"), "out": os.path.join(self.tmp, "out")}
        spec_path = os.path.join(self.tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(self.spec, f)
        port = _port_pair()
        self.log_dir = os.path.join(self.tmp, "logs")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(n), "--start_port", str(port + 1),
             "--log_dir", self.log_dir, os.path.abspath(__file__),
             spec_path],
            cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._res = None

    def results(self):
        """Every rank's results: [{"job/key": array}], by rank."""
        if self._res is None:
            try:
                out, _ = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                logs = []
                for r in range(self.n):
                    path = os.path.join(self.log_dir, f"workerlog.{r}")
                    if os.path.exists(path):
                        with open(path) as f:
                            logs.append(f"rank {r}:\n{f.read()[-4000:]}")
                raise RuntimeError(
                    f"world of {self.n} ranks ended with "
                    f"{self.proc.returncode}:\n{out[-2000:]}\n"
                    + "\n".join(logs))
            self.seconds = time.perf_counter() - self.t0
            self._res = [dict(np.load(f"{self.spec['out']}.{r}.npz",
                                      allow_pickle=False))
                         for r in range(self.n)]
        return self._res

    def job(self, name):
        """One job's results, by rank: [{key: array}]."""
        pre = name + "/"
        return [{k[len(pre):]: v for k, v in res.items()
                 if k.startswith(pre)} for res in self.results()]


# ------------------------------------------------------------ rank bodies
# each takes (inputs, rank, world size) and returns {key: array-like}

def _t(a):
    import torch
    return torch.tensor(np.asarray(a))


def job_collectives(inp, r, n):
    """Every collective of the Paddle surface on rank-dependent inputs
    (x_r = base + r)."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    base = inp["coll_base"]
    out = {}
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                     ("avg", C.ReduceOp.AVG)):
        x = _t(base + r)
        dist.all_reduce(x, op=op)
        out[f"all_reduce_{name}"] = x.numpy()
    t = pt.to_tensor(base + r, place="cpu")
    same = dist.all_reduce(t)
    out["all_reduce_tensor_in_place"] = np.array(
        [same is t, np.array_equal(t.numpy(), n * base + sum(range(n)))])
    lst = []
    got = dist.all_gather(lst, _t(base + r))
    out["all_gather"] = np.stack([g.numpy() for g in got])
    out["all_gather_list_filled"] = np.array(len(lst) == n)
    rows = inp["coll_rows"] + 10 * r                     # [2n, 3]
    dst = torch.zeros(2, 3)
    dist.reduce_scatter(dst, _t(rows))
    out["reduce_scatter"] = dst.numpy()
    halves = [_t(rows[2 * j:2 * j + 2]) for j in range(n)]
    out["reduce_scatter_list"] = dist.reduce_scatter(None, halves).numpy()
    b = _t(base + r)
    dist.broadcast(b, src=1)
    out["broadcast"] = b.numpy()
    red = _t(base + r)
    dist.reduce(red, dst=0)
    out["reduce"] = red.numpy()
    sc = torch.zeros(base.shape)
    dist.scatter(sc, [_t(base * (j + 1)) for j in range(n)]
                 if r == 0 else None, src=0)
    out["scatter"] = sc.numpy()
    a2a = dist.alltoall([_t(base + 10 * r + j) for j in range(n)])
    out["alltoall"] = np.stack([a.numpy() for a in a2a])
    p2p = _t(base * 0)
    if r == 0:
        dist.send(_t(base * 7), dst=1)
    elif r == 1:
        dist.recv(p2p, src=0)
    out["send_recv"] = p2p.numpy()
    g = dist.new_group(ranks=list(range(n)))
    x = _t(base + r)
    dist.all_reduce(x, group=g)
    out["new_group_all_reduce"] = x.numpy()
    dist.barrier()
    out["wait_returns_its_tensor"] = np.array(dist.wait(x) is x)
    out["host_staged"] = np.array(C.stats["host_staged"])
    # the host collectives over the launcher's store
    from paddle_tpu_torch.distributed import gloo
    hc = gloo.collective_from_env()
    hc.barrier()
    out["host_all_gather"] = np.array(hc.all_gather(f"r{r}".encode()))
    out["host_all_reduce"] = hc.all_reduce(np.array([r, r + 1]))
    return out


def job_data_parallel(inp, r, n):
    """DataParallel.apply_collective_grads after each rank's backward
    over its half of the batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import DataParallel
    pt.seed(3)
    net = DataParallel(nn.Linear(8, 4))
    x, y = inp["dp_x"], inp["dp_y"]
    m = x.shape[0] // n
    sl = slice(r * m, (r + 1) * m)
    loss = nn.functional.mse_loss(net(pt.to_tensor(x[sl])),
                                  pt.to_tensor(y[sl]))
    loss.backward()
    net.apply_collective_grads()
    return {k: p.grad.numpy() for k, p in net._layers.named_parameters()}


#: the optimizers of the sharded-Linear cases (the same class and
#: arguments in both packages): Lamb's and Lars's trust ratios and
#: Dpsgd's clip (bound here: the grads' norms are above 0.05) take
#: per-tensor norms, which ZeRO-1 sums over the ranks' chunks
LINEAR_OPTS = {"sgd": ("SGD", {"learning_rate": 0.1}),
               "adamw": ("AdamW", {"learning_rate": 0.01}),
               "lamb": ("Lamb", {"learning_rate": 0.01}),
               "lars": ("Lars", {"learning_rate": 0.1, "lars_coeff": 0.01}),
               "dpsgd": ("Dpsgd", {"learning_rate": 0.1, "clip": 0.05,
                                   "sigma": 0.0})}
#: (case, ZeRO stage): "adamw_merge" is AdamW under fleet's
#: gradient_merge (k_steps 2, avg) with sharding at that stage
LINEAR_CASES = (("sgd", 0), ("sgd", 1), ("adamw", 1), ("lamb", 1),
                ("lars", 1), ("dpsgd", 1), ("adamw_merge", 1), ("adamw", 3),
                ("adamw_merge", 3))


def merge_strategy(fleet, stage=1):
    """The gradient_merge + sharding strategy of "adamw_merge"."""
    s = fleet.DistributedStrategy()
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    s.sharding = True
    s.sharding_configs = {"stage": stage}
    return s


def _linear(inp, opt_name):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    net = nn.Linear(8, 4)
    net.set_state_dict({"weight": inp["lin_w"], "bias": inp["lin_b"]})
    cls, kw = LINEAR_OPTS[opt_name]
    return net, getattr(pt.optimizer, cls)(parameters=net.parameters(),
                                           **kw)


def job_sharded_linear(inp, r, n):
    """A Linear under MSE through ShardedTrainStep over {'dp': n}, each
    of LINEAR_CASES: 3 steps (4 calls, 2 updates, under gradient merge);
    the losses, the weights and (stateful rules) the moments after
    sync()."""
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    mesh.make_mesh({"dp": n})
    out = {}
    x, y = inp["lin_x"], inp["lin_y"]
    for case, zero in LINEAR_CASES:
        merge = case == "adamw_merge"
        net, opt = _linear(inp, "adamw" if merge else case)
        step = ShardedTrainStep(
            net, nn.functional.mse_loss,
            fleet.distributed_optimizer(opt, merge_strategy(fleet, zero))
            if merge else opt, zero_stage=zero)
        key = f"{case}_zero{zero}"
        out[key + "_losses"] = [float(step(_t(x), _t(y)))
                                for _ in range(4 if merge else 3)]
        step.sync()
        out[key + "_weight"] = net.weight.numpy()
        out[key + "_step"] = opt._global_step
        for slot, t in opt._state.get(0, {}).items():
            out[f"{key}_{slot}"] = t.numpy()
        if case == "adamw":
            out[key + "_moment_bytes"] = [step.shard_nbytes(),
                                          sum(p.numel() for p in
                                              net.parameters()) * 8]
    return out


def job_hapi_zero1(inp, r, n):
    """hapi.Model over the Linear, AdamW under fleet's sharding stage 1
    on {'dp': n}: fit an epoch, set_lr, fit another, save (each rank
    into its own directory); a new Model load_latest's it and fits a
    third epoch. The losses, the restored moments and step count, the
    .pdtrain's sharding record and the final weight."""
    import os
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.framework import serialization
    mesh.make_mesh({"dp": n})
    ds = pt.io.TensorDataset([inp["lin_x"], inp["lin_y"]])
    s = fleet.DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": 1}

    def model():
        net, opt = _linear(inp, "adamw")
        m = pt.Model(net)
        m.prepare(fleet.distributed_optimizer(opt, s), nn.MSELoss())
        return m, net, opt

    def fit(m):
        return m.fit(ds, batch_size=8, epochs=1, shuffle=False,
                     verbose=0)["loss"]

    m, _, opt = model()
    losses = fit(m)
    opt.set_lr(0.003)
    losses += fit(m)
    ckpt = os.path.join(str(inp["ckpt_dir"]), f"rank{r}")
    m.save(os.path.join(ckpt, "ckpt"))
    m2, net2, opt2 = model()
    prefix = m2.load_latest(ckpt)
    # copies: the third epoch's sync() writes into the same tensors
    out = {"moment1": opt2._state[0]["moment1"].numpy().copy(),
           "moment2": opt2._state[0]["moment2"].numpy().copy(),
           "step": opt2._global_step,
           "zero_stage": serialization.load(
               prefix + ".pdtrain")["sharding"]["zero_stage"]}
    out["losses"] = losses + fit(m2)
    out["weight"] = net2.weight.numpy()
    return out


def job_sharded_models(inp, r, n):
    """The tiny GPT and BERT of the test from the JAX weights, AdamW at
    ZeRO-1 over {'dp': n}, 3 steps each."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    from paddle_tpu_torch.nlp import bert as tbert, gpt as tgpt
    mesh.make_mesh({"dp": n})
    out = {}
    gcfg = json.loads(str(inp["gpt_cfg"]))
    gm = tgpt.GPTForPretraining(tgpt.GPTConfig(**gcfg), device="cpu")
    tgpt.load_jax_state(gm, {k[4:]: v for k, v in inp.items()
                             if k.startswith("gpt:")})
    step = ShardedTrainStep(gm, tgpt.gpt_pretrain_loss, pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=gm.parameters()), zero_stage=1)
    ids = _t(inp["gpt_ids"])
    out["gpt_losses"] = [float(step(ids, ids)) for _ in range(3)]
    bcfg = json.loads(str(inp["bert_cfg"]))
    bm = tbert.BertForPretraining(tbert.BertConfig(**bcfg), device="cpu")
    bm.set_state_dict({k[5:]: v for k, v in inp.items()
                       if k.startswith("bert:")})
    step = ShardedTrainStep(bm, tbert.bert_pretrain_loss, pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=bm.parameters()), zero_stage=1)
    ids, mlm, nsp = (_t(inp[k]) for k in ("bert_ids", "bert_mlm",
                                         "bert_nsp"))
    out["bert_losses"] = [float(step(ids, (mlm, nsp))) for _ in range(3)]
    return out


def job_refusals(inp, r, n):
    """ZeRO-3, exact_reshard and 'mp' / 'pp' meshes accepted (each step
    built and run once); Dpsgd's noise under ZeRO-1 and ZeRO-3 refused;
    fp16_allreduce with ZeRO-3 warned about and ignored, as the JAX step
    does."""
    import warnings
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    out = {}
    x = _t(np.ones((4, 4), "f4"))
    for name, shape, kw in (("zero3", {"dp": n}, {"zero_stage": 3}),
                            ("exact", {"dp": n}, {"exact_reshard": True}),
                            ("mp", {"mp": n}, {}), ("pp", {"pp": n}, {})):
        mesh.make_mesh(shape)
        net = nn.Linear(4, 4)
        try:
            step = ShardedTrainStep(net, nn.functional.mse_loss,
                                    pt.optimizer.SGD(
                                        0.1, parameters=net.parameters()),
                                    **kw)
            step(x, x)
            out[name] = "accepted"
        except NotImplementedError as e:
            out[name] = str(e)
    for stage in (1, 3):
        mesh.make_mesh({"dp": n})
        net = nn.Linear(4, 4)
        try:
            ShardedTrainStep(net, nn.functional.mse_loss, pt.optimizer.Dpsgd(
                0.1, sigma=1.0, parameters=net.parameters()),
                zero_stage=stage)
            out[f"dpsgd_noise_zero{stage}"] = "accepted"
        except NotImplementedError as e:
            out[f"dpsgd_noise_zero{stage}"] = str(e)
    s = fleet.DistributedStrategy()
    s.fp16_allreduce = True
    s.sharding = True
    s.sharding_configs = {"stage": 3}
    net = nn.Linear(4, 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = ShardedTrainStep(net, nn.functional.mse_loss,
                                fleet.distributed_optimizer(pt.optimizer.SGD(
                                    0.1, parameters=net.parameters()), s))
    out["fp16_zero3"] = [str(w.message) for w in caught
                         if "fp16_allreduce" in str(w.message)]
    out["fp16_zero3_state"] = [step.zero_stage, int(step.fp16_allreduce)]
    return out


# ------------------------------------------------ ZeRO-3, exact_reshard

class _ZeroMLP:
    """tests/test_zero3.py's MLP (3 Linears, 64 -> 128 -> 128 -> 8)."""

    @staticmethod
    def make(pt):
        from paddle_tpu_torch import nn

        class MLP(nn.Layer):
            def __init__(self, d=64, h=128):
                super().__init__()
                self.fc1 = nn.Linear(d, h)
                self.fc2 = nn.Linear(h, h)
                self.fc3 = nn.Linear(h, 8)

            def forward(self, x):
                x = nn.functional.relu(self.fc1(x))
                x = nn.functional.relu(self.fc2(x))
                return self.fc3(x)
        return MLP()


def _zero_mlp(inp):
    import paddle_tpu_torch as pt
    net = _ZeroMLP.make(pt)
    net.set_state_dict({k[4:]: v for k, v in inp.items()
                        if k.startswith("z3m:")})
    return net


def job_zero3(inp, r, n):
    """ZeRO-3 over {'dp': n}: tests/test_zero3.py's MLP (Adam 1e-3, 5
    steps on its 32-row batch) and the tiny GPT (AdamW 1e-3, 3 steps),
    each beside the same run at ZeRO-1: losses, the synced parameters
    and moments; the parameter bytes each rank holds (`param_nbytes`)
    against its chunks'; state_dict refused before sync()."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    mesh.make_mesh({"dp": n})
    out = {}
    x, y = _t(inp["z3_x"]), _t(inp["z3_y"])
    ids = _t(inp["gpt_ids"])
    gcfg = json.loads(str(inp["gpt_cfg"]))
    for stage in (1, 3):
        net = _zero_mlp(inp)
        opt = pt.optimizer.Adam(learning_rate=1e-3,
                                parameters=net.parameters())
        step = ShardedTrainStep(net, nn.CrossEntropyLoss(), opt,
                                zero_stage=stage)
        chunks = sum(sh.numel() * sh.element_size()
                     for sh, _, _ in step._shards)
        out[f"mlp{stage}_bytes"] = [step.param_nbytes(), chunks]
        out[f"mlp{stage}_losses"] = [float(step(x, y)) for _ in range(5)]
        try:
            net.state_dict()
            out[f"mlp{stage}_state_dict"] = "allowed"
        except RuntimeError as e:
            out[f"mlp{stage}_state_dict"] = str(e)
        step.sync()
        out.update({f"mlp{stage}_p:{k}": p.numpy().copy()
                    for k, p in net.named_parameters()})
        out.update({f"mlp{stage}_m:{i}:{k}": v.numpy().copy()
                    for i, st in opt._state.items() for k, v in st.items()})
        gm = tgpt.GPTForPretraining(tgpt.GPTConfig(**gcfg), device="cpu")
        tgpt.load_jax_state(gm, {k[4:]: v for k, v in inp.items()
                                 if k.startswith("gpt:")})
        step = ShardedTrainStep(gm, tgpt.gpt_pretrain_loss,
                                pt.optimizer.AdamW(
                                    learning_rate=1e-3,
                                    parameters=gm.parameters()),
                                zero_stage=stage)
        out[f"gpt{stage}_units"] = len(step._units)
        out[f"gpt{stage}_losses"] = [float(step(ids, ids))
                                     for _ in range(3)]
        # the layers whose forward is the step's, between calls
        out[f"gpt{stage}_patched"] = [n for n, sub in gm.named_sublayers()
                                      if "forward" in vars(sub)]
        step.sync()
        out.update({f"gpt{stage}_p:{k}": p.numpy().copy()
                    for k, p in gm.named_parameters()})
    return out


def _exact_run(inp, r, dp, stage, steps=3):
    """The tiny GPT through an exact_reshard step over {'dp': dp} (fleet's
    sharding_configs; stage None: the plain jit.TrainStep, no mesh) on
    the 3-sequence batch, AdamW under a global-norm clip: losses, grad
    norms, the synced parameters and moments (None off the mesh)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    m = mesh.make_mesh({"dp": dp})
    if m.coords is None:
        return None
    gcfg = json.loads(str(inp["gpt_cfg"]))
    gm = tgpt.GPTForPretraining(tgpt.GPTConfig(**gcfg), device="cpu")
    tgpt.load_jax_state(gm, {k[4:]: v for k, v in inp.items()
                             if k.startswith("gpt:")})
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=gm.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    if stage is None:
        mesh.set_mesh(None)
        step = TrainStep(gm, tgpt.gpt_pretrain_loss, opt)
    else:
        s = fleet.DistributedStrategy()
        s.sharding = True
        s.sharding_configs = {"stage": stage, "exact_reshard": True}
        step = fleet.build_train_step(gm, tgpt.gpt_pretrain_loss,
                                      fleet.distributed_optimizer(opt, s))
    ids = _t(inp["gpt_ids"][:3])
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(step(ids, ids)))
        norms.append(step.last_grad_norm())
    step.sync()
    res = {"losses": losses, "norms": norms,
           "state": [getattr(step, "zero_stage", -1),
                     int(getattr(step, "exact_reshard", False))]}
    res.update({f"p:{k}": p.numpy().copy()
                for k, p in gm.named_parameters()})
    res.update({f"m:{i}:{k}": v.numpy().copy()
                for i, st in opt._state.items() for k, v in st.items()})
    return res


def job_exact(inp, r, n):
    """exact_reshard on a batch 'dp' cannot divide (3 sequences): the
    tiny GPT at ZeRO-1 and ZeRO-3 over {'dp': n} and, on rank 0, over
    {'dp': 1} and through the plain TrainStep; then hapi.Model fits the MLP under fleet's sharding
    stage 3 with exact_reshard on {'dp': n} one epoch of 3-row batches,
    saves, and rank 0 resumes it on {'dp': 1} for a second epoch beside
    the uninterrupted run there; a resume without the strategy warns."""
    import os
    import warnings
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import mesh
    out = {}
    for stage in (1, 3):
        for dp in (n, 1):
            res = _exact_run(inp, r, dp, stage)
            if res is not None:
                _cases(out, f"gpt{stage}_dp{dp}", res)
    res = _exact_run(inp, r, 1, None)
    if res is not None:
        _cases(out, "gpt_plain", res)
    ds = pt.io.TensorDataset([inp["z3_x"][:12], inp["z3_y"][:12]])

    def model(exact=True):
        net = _zero_mlp(inp)
        opt = pt.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        if exact:
            s = fleet.DistributedStrategy()
            s.sharding = True
            s.sharding_configs = {"stage": 3, "exact_reshard": True}
            opt = fleet.distributed_optimizer(opt, s)
        m = pt.Model(net)
        m.prepare(opt, nn.CrossEntropyLoss())
        return m, net

    def fit(m, epochs, resume=False):
        return m.fit(ds, batch_size=3, epochs=epochs, shuffle=False,
                     verbose=0, resume=resume)["loss"]

    mesh.make_mesh({"dp": n})
    m, _ = model()
    out["hapi_first"] = fit(m, 1)
    ckpt = os.path.join(str(inp["ckpt_dir"]), f"exact{r}")
    m.save(os.path.join(ckpt, "ckpt"))
    if mesh.make_mesh({"dp": 1}).coords is not None:
        m, net = model()
        out["hapi_plain"] = fit(m, 2)
        out.update({f"hapi_plain_p:{k}": p.numpy().copy()
                    for k, p in net.named_parameters()})
        m, net = model()
        m.load_latest(ckpt)
        out["hapi_resumed"] = fit(m, 2, resume=True)
        out.update({f"hapi_resumed_p:{k}": p.numpy().copy()
                    for k, p in net.named_parameters()})
        m, _ = model(exact=False)
        m.load_latest(ckpt)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fit(m, 2, resume=True)
        out["drift"] = [str(w.message) for w in caught
                        if "sharding configuration" in str(w.message)]
    mesh.make_mesh({"dp": n})       # the world's groups for what follows
    return out


def job_attention(inp, r, n):
    """Ring and Ulysses attention over {'dp': 2, 'sp': n / 2} and
    {'sp': n}, causal and not, on the rank's shard of the global q, k,
    v: the output and the gradients of sum(out ** 2)."""
    import torch
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.ring_attention import ring_attention
    from paddle_tpu_torch.distributed.ulysses import ulysses_attention
    q, k, v = (inp[x] for x in ("q", "k", "v"))
    out = {}
    for mname, shape in (("dp2sp", {"dp": 2, "sp": n // 2}),
                         ("sp", {"sp": n})):
        m = mesh.make_mesh(shape)
        dp = m.axis_size("dp")
        sp = m.axis_size("sp")
        bi = m.axis_index("dp") if dp > 1 else 0
        bn = q.shape[0] // dp
        sn = q.shape[2] // sp
        si = m.axis_index("sp")
        sl = (slice(bi * bn, (bi + 1) * bn), slice(None),
              slice(si * sn, (si + 1) * sn))
        out[f"{mname}_slice"] = [bi * bn, bn, si * sn, sn]
        for causal in (False, True):
            for fname, fn in (("ring", ring_attention),
                              ("ulysses", ulysses_attention)):
                a = [torch.tensor(x[sl]).requires_grad_() for x in (q, k, v)]
                o = fn(*a, causal=causal)
                (o ** 2).sum().backward()
                key = f"{mname}_{fname}_{int(causal)}"
                out[key + "_out"] = o.detach().numpy()
                for name, t in zip("qkv", a):
                    out[f"{key}_d{name}"] = t.grad.numpy()
    return out


def job_gpt_sp(inp, r, n):
    """The tiny sequence-parallel GPT ("ring", "ulysses") from the JAX
    weights through ShardedTrainStep over {'dp': 2, 'sp': n / 2}, AdamW,
    3 steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    mesh.make_mesh({"dp": 2, "sp": n // 2})
    cfg = json.loads(str(inp["sp_cfg"]))
    ids = _t(inp["sp_ids"])
    out = {}
    for mode in ("ring", "ulysses"):
        m = tgpt.GPTForPretraining(tgpt.GPTConfig(
            sequence_parallel=mode, **cfg), device="cpu")
        tgpt.load_jax_state(m, {k[3:]: v for k, v in inp.items()
                                if k.startswith("sp:")})
        step = ShardedTrainStep(m, tgpt.gpt_pretrain_loss,
                                pt.optimizer.AdamW(
                                    learning_rate=1e-3,
                                    parameters=m.parameters()))
        out[mode] = [float(step(ids, ids)) for _ in range(3)]
    return out


def job_fleet_meshes(inp, r, n):
    """The mesh fleet.init makes from each hybrid config of the test."""
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.distributed import mesh
    out = {}
    for i, hc in enumerate(json.loads(str(inp["hybrid"]))):
        mesh.reset()
        s = fleet.DistributedStrategy()
        if hc.pop("tensor_parallel", None):
            s.tensor_parallel = True
            s.tensor_parallel_configs = {"tensor_parallel_degree":
                                         hc.pop("tp")}
        s.hybrid_configs = dict(s.hybrid_configs, **hc)
        fleet.init(is_collective=True, strategy=s)
        m = mesh.get_mesh()
        out[str(i)] = json.dumps(None if m is None else m.shape)
    return out


def job_build_step(inp, r, n):
    """The step `fleet.build_train_step` builds (or its refusal) for
    each strategy of the test, on {'dp': n} (a pipeline on {'pp': n},
    over the non-GPT PipelineParts model)."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    out = {}
    for name, flags in json.loads(str(inp["strategies"])).items():
        s = fleet.DistributedStrategy()
        for k, v in flags.items():
            setattr(s, k, v)
        axis = "pp_degree" if flags.get("pipeline") else "dp_degree"
        s.hybrid_configs = dict(s.hybrid_configs, **{axis: n})
        fleet.init(is_collective=True, strategy=s)
        # a pipeline needs stages: the non-GPT PipelineParts model
        net = _mlp_regressor(pt, d_in=4) if flags.get("pipeline") \
            else nn.Linear(4, 4)
        opt = fleet.distributed_optimizer(
            pt.optimizer.SGD(0.1, parameters=net.parameters()), s)
        try:
            out[name] = type(fleet.build_train_step(
                net, nn.functional.mse_loss, opt)).__name__
        except NotImplementedError as e:
            out[name] = f"refused: {e}"
    # a mesh of one rank (rank 0's): sharding, with and without
    # exact_reshard
    from paddle_tpu_torch.distributed import mesh
    prev = mesh.get_mesh()
    if mesh.make_mesh({"dp": 1}).coords is not None:
        for name, cfg in json.loads(str(inp["one_rank"])).items():
            s = fleet.DistributedStrategy()
            s.sharding = True
            s.sharding_configs = cfg
            net = nn.Linear(4, 4)
            opt = fleet.distributed_optimizer(
                pt.optimizer.SGD(0.1, parameters=net.parameters()), s)
            out[name] = type(fleet.build_train_step(
                net, nn.functional.mse_loss, opt)).__name__
    mesh.set_mesh(prev)
    return out


def job_dist_mnist(inp, r, n):
    """The twin of examples/dist_mnist.py: its CNN (two conv-pool blocks
    and an fc head, Momentum 0.01) on the port's synthetic MNIST through
    fleet.init / distributed_optimizer / build_train_step over {'dp':
    n}, every rank reading the same shuffled global batches of 64; 40
    steps."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    strategy = fleet.DistributedStrategy()
    fleet.init(is_collective=True, strategy=strategy)
    pt.seed(1)
    model = nn.Sequential(
        nn.Conv2D(1, 20, 5), nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(20, 50, 5), nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Flatten(), nn.Linear(50 * 4 * 4, 10))
    opt = fleet.distributed_optimizer(
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                              parameters=model.parameters()), strategy)
    step = fleet.build_train_step(model, nn.functional.cross_entropy, opt)
    np.random.seed(0)
    loader = pt.io.DataLoader(pt.vision.datasets.MNIST(mode="train"),
                              batch_size=64, shuffle=True, drop_last=True)
    losses, it = [], iter(loader)
    for _ in range(40):
        img, label = next(it)
        losses.append(float(step(img, label.reshape([-1]))))
    return {"losses": losses, "step": type(step).__name__}


# ------------------------------------------------ tensor and pipeline
# parallelism: the model's state after steps, the step-1 gradients (full
# logical tensors, gathered), losses and the step count

def _tiny_model(inp, kind, **over):
    """The test's tiny GPT or LLaMA (config and JAX weights from the
    inputs), f32 on the CPU."""
    from paddle_tpu_torch.nlp import gpt as tgpt, llama as tllama
    cfg = dict(json.loads(str(inp[f"{kind}_cfg"])), **over)
    if kind == "gpt":
        m = tgpt.GPTForPretraining(tgpt.GPTConfig(**cfg), device="cpu")
    else:
        m = tllama.LlamaForCausalLM(tllama.LlamaConfig(**cfg), device="cpu")
    tgpt.load_jax_state(m, {k[len(kind) + 1:]: v for k, v in inp.items()
                            if k.startswith(kind + ":")})
    return m


def _adamw(model, clip=None):
    import paddle_tpu_torch as pt
    kw = {} if clip is None else {
        "grad_clip": pt.nn.ClipGradByGlobalNorm(clip)}
    return pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters(), **kw)


def _trajectory(step, model, x, y, steps=2, r=0, report=True, holds=False):
    """`steps` calls: the losses, the global grad norms, the first call's
    gradients, the synced parameters and the step count (rank 0 reports
    the tensors); with `holds`, what the rank holds after the first
    call: the names of the model's parameters whose weights it keeps
    whole, and `param_nbytes()`."""
    from paddle_tpu_torch.distributed import parallel_layers as tpl
    losses, grads, norms, held = [], {}, [], {}
    for i in range(steps):
        losses.append(float(step(x, y)))
        norms.append(step.last_grad_norm())
        if i == 0 and holds:
            held = {"resident": sorted(
                k for k, p in model.named_parameters()
                if not tpl.is_released(p._data)),
                "param_nbytes": step.param_nbytes()}
        if i == 0:
            grads = {k: v.numpy().copy() for k, v in
                     step.last_grads().items()}
    step.sync()
    out = {"losses": losses, "grad_norms": norms,
           "step": step.optimizer._global_step, **held}
    if report and r == 0:
        out.update({f"g:{k}": v for k, v in grads.items()})
        out.update({f"p:{n}": p.numpy().copy()
                    for n, p in model.named_parameters()})
    return out


def _cases(out, case, res):
    out.update({f"{case}/{k}": v for k, v in res.items()})


TP_MESHES = {"mp2": {"mp": 2}, "dp2mp2": {"dp": 2, "mp": 2}}


def job_tp_layers(inp, r, n):
    """The four parallel layers and `split` over {'mp': n} from the JAX
    layers' weights: outputs (a column layer without gather_output: the
    rank's columns) and, for sum(out * cot), the input's gradient and
    every weight's (gathered to its full logical tensor)."""
    import paddle_tpu_torch as pt
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh, parallel_layers as tp
    m = mesh.make_mesh({"mp": n})
    group = tp.mp_group(m)
    x = inp["tpl_x"]
    out = {}
    layers = {
        "col_gather": lambda: tp.ColumnParallelLinear(16, 32),
        "col_local": lambda: tp.ColumnParallelLinear(16, 32,
                                                     gather_output=False),
        "row": lambda: tp.RowParallelLinear(32, 16),
        "row_parallel_in": lambda: tp.RowParallelLinear(
            32, 16, input_is_parallel=True),
        "emb": lambda: tp.VocabParallelEmbedding(64, 16)}
    for name, make in layers.items():
        layer = make()
        layer.set_state_dict({k[len(name) + 5:]: v for k, v in inp.items()
                              if k.startswith(f"tpl:{name}.")})
        shards = tp.LocalShards(layer, group)
        if name == "emb":
            xin = _t(inp["tpl_ids"])
        elif name == "row_parallel_in":
            xin = _t(inp["tpl_x32"]).chunk(n, -1)[r].contiguous() \
                .requires_grad_(True)
        else:
            xin = _t(x if name.startswith("col") else inp["tpl_x32"]) \
                .requires_grad_(True)
        with shards.scope():
            y = layer(pt.Tensor._wrap(xin))._data
        cot = _t(inp[f"tpl_cot_{name}"])
        if name == "col_local":
            cot = cot.chunk(n, -1)[r]
        (y * cot).sum().backward()
        out[f"{name}_out"] = y.detach().numpy()
        if xin.requires_grad:
            out[f"{name}_dx"] = xin.grad.numpy()
        for pn, w in layer.named_parameters():
            leaf = shards.local.get(pn, w._data)
            g = leaf.grad
            if pn in shards.local:
                g = tp.gather_tensor(g, w, group)
            out[f"{name}_d:{pn}"] = g.numpy()
    # ParallelCrossEntropy over the rank's vocab shard of the logits
    z = _t(inp["tpl_logits"]).chunk(n, -1)[r].contiguous()
    z.requires_grad_(True)
    with tp.mp_scope(group):
        ce = tp.ParallelCrossEntropy()(pt.Tensor._wrap(z),
                                       pt.Tensor._wrap(_t(inp["tpl_lab"])))
    ce._data.backward()
    out["pce_loss"] = float(ce)
    grad = torch.empty((n,) + tuple(z.shape))
    C.all_gather_into(grad, z.grad.contiguous(), group.pg)
    out["pce_dz"] = torch.cat(grad.unbind(0), -1).numpy()
    # split: a column-parallel linear (gathered) and a vocab-parallel
    # embedding, drawn from the framework generator
    import paddle_tpu_torch.distributed as dist
    pt.seed(5)
    out["split_linear"] = dist.split(pt.to_tensor(x), (16, 32), "linear",
                                     axis=1).numpy()
    pt.seed(5)
    out["split_linear_ref"] = tp.ColumnParallelLinear(16, 32)(
        pt.to_tensor(x)).numpy()
    pt.seed(6)
    out["split_emb"] = dist.split(pt.to_tensor(inp["tpl_ids"]), (64, 16),
                                  "embedding").numpy()
    pt.seed(6)
    out["split_emb_ref"] = tp.VocabParallelEmbedding(64, 16)(
        pt.to_tensor(inp["tpl_ids"])).numpy()
    return out


def job_tp_steps(inp, r, n):
    """GPT and LLaMA through ShardedTrainStep over {'mp': 2} (ZeRO-0) and
    {'dp': 2, 'mp': 2} (ZeRO-1), AdamW with a global-norm clip at 1.0, 2
    steps; LLaMA over {'mp': 4} (2 KV heads) refused."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    ids = _t(inp["tp_ids"])
    out = {}
    for kind in ("gpt", "llama"):
        for mname, shape in TP_MESHES.items():
            m = mesh.make_mesh(shape)
            if m.coords is None:
                continue
            model = _tiny_model(inp, kind)
            step = ShardedTrainStep(model, tgpt.gpt_pretrain_loss,
                                    _adamw(model, 1.0),
                                    zero_stage=int(mname == "dp2mp2"))
            _cases(out, f"{kind}_{mname}", _trajectory(step, model, ids,
                                                       ids, r=r))
    # whole-tensor norms over {'mp': 2} against the plain TrainStep on
    # one rank: Lamb's trust ratios, and per-tensor clipping (SGD)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    opts = {"lamb": lambda ps: pt.optimizer.Lamb(learning_rate=1e-2,
                                                 parameters=ps),
            "clipnorm": lambda ps: pt.optimizer.SGD(
                learning_rate=0.5, parameters=ps,
                grad_clip=pt.nn.ClipGradByNorm(0.05))}
    for name, make in opts.items():
        for kind in ("sharded", "plain"):
            m = mesh.make_mesh({"mp": 2})
            if m.coords is None:
                continue
            model = _tiny_model(inp, "gpt")
            opt = make(model.parameters())
            step = ShardedTrainStep(model, tgpt.gpt_pretrain_loss, opt) \
                if kind == "sharded" else TrainStep(
                    model, tgpt.gpt_pretrain_loss, opt)
            case = f"{name}_{kind}"
            out[f"{case}/losses"] = [float(step(ids, ids))
                                     for _ in range(2)]
            step.sync()
            out.update({f"{case}/p:{k}": p.numpy().copy()
                        for k, p in model.named_parameters()})
    # the fused head over the vocab split on 'mp' (ZeRO-0 over {'mp':
    # 2}; ZeRO-3 over {'dp': 2, 'mp': 2}); what each rank holds
    for case, shape, zero in (("gpt_fused_mp2", {"mp": 2}, 0),
                              ("gpt_z3fused_dp2mp2", {"dp": 2, "mp": 2}, 3)):
        m = mesh.make_mesh(shape)
        if m.coords is None:
            continue
        model = _tiny_model(inp, "gpt", fused_head_loss=True)
        step = ShardedTrainStep(model, tgpt.gpt_pretrain_loss,
                                _adamw(model, 1.0), zero_stage=zero)
        _cases(out, case, _trajectory(step, model, ids, ids, r=r,
                                      holds=True))
    mesh.make_mesh({"mp": n})
    model = _tiny_model(inp, "llama")
    try:
        ShardedTrainStep(model, tgpt.gpt_pretrain_loss, _adamw(model))
        out["llama_mp4"] = "accepted"
    except ValueError as e:
        out["llama_mp4"] = str(e)
    return out


def job_tp_fused_head(inp, r, n):
    """`vocab_parallel_chunked_lm_loss` over {'dp': 2, 'mp': 2}: each
    rank's half of the table's rows, chunks of 16: the loss, dh and the
    whole table's dw (the slice's rows gathered)."""
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh, parallel_layers as tp
    from paddle_tpu_torch.ops.chunked_ce import \
        vocab_parallel_chunked_lm_loss
    m = mesh.make_mesh({"dp": 2, "mp": n // 2})
    group = tp.mp_group(m)
    h = _t(inp["fh_h"]).requires_grad_(True)
    w = _t(inp["fh_w"]).chunk(group.size, 0)[group.rank].contiguous()
    w.requires_grad_(True)
    loss = vocab_parallel_chunked_lm_loss(h, w, _t(inp["fh_lab"]), group,
                                          -1, 16)
    loss.backward()
    every = torch.empty((group.size,) + tuple(w.shape))
    C.all_gather_into(every, w.grad.contiguous(), group.pg)
    return {"loss": float(loss), "dh": h.grad.numpy(),
            "dw": torch.cat(every.unbind(0), 0).numpy()}


def job_tp_dropout(inp, r, n):
    """The GPT with dropout 0.1 and attention dropout 0.1 (the BHSD
    path: the rank's heads draw their own masks) over {'dp': 2, 'mp':
    2}, 3 steps: the losses, the replicated parameters as the rank holds
    them (every rank of an mp slice must hold the same), a sharded
    attention mask's draw on each rank."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import mesh, parallel_layers as tp
    from paddle_tpu_torch.distributed.sharded import ShardedTrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    m = mesh.make_mesh({"dp": 2, "mp": 2})
    pt.seed(11)
    model = _tiny_model(inp, "gpt", dropout=0.1, attn_dropout=0.1,
                        attn_layout="bhsd")
    step = ShardedTrainStep(model, tgpt.gpt_pretrain_loss, _adamw(model))
    ids = _t(inp["tp_ids"])
    losses = [float(step(ids, ids)) for _ in range(3)]
    rep = {n_: p._data.detach().numpy().copy()
           for n_, p in model.named_parameters()
           if n_ not in step._shards_mp.local}
    draw = step._mp.generator.generator("cpu").initial_seed()
    return {"losses": losses, "mp_rank": m.axis_index("mp"),
            "sharded_seed": draw,
            **{f"rep:{k}": v for k, v in rep.items()}}


PP_MESHES = {"pp2": {"pp": 2}, "pp4": {"pp": 4},
             "dp2pp2": {"dp": 2, "pp": 2}, "pp2mp2": {"pp": 2, "mp": 2}}


def job_pp_steps(inp, r, n):
    """The tiny GPT through PipelineTrainStep (GPipe, recompute) and
    OneF1BTrainStep over each of PP_MESHES, 4 microbatches, AdamW, 2
    steps; and over {'pp': 2} and {'pp': 2, 'mp': 2} with a global-norm
    clip at `pp_clip`."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.pipeline import PipelineTrainStep
    from paddle_tpu_torch.distributed.pipeline_1f1b import OneF1BTrainStep
    from paddle_tpu_torch.nlp import gpt as tgpt
    ids = _t(inp["tp_ids"])
    out = {}
    for mname, shape in PP_MESHES.items():
        for sched, cls in (("gpipe", PipelineTrainStep),
                           ("1f1b", OneF1BTrainStep)):
            m = mesh.make_mesh(shape)
            if m.coords is None:
                continue
            model = _tiny_model(inp, "gpt")
            step = cls(model, tgpt.gpt_pretrain_loss, _adamw(model),
                       num_micro=4)
            case = f"{sched}_{mname}"
            out[f"{case}/stage"] = m.axis_index("pp")
            _cases(out, case, _trajectory(step, model, ids, ids, r=r,
                                          holds=True))
    for mname in ("pp2", "pp2mp2"):
        for sched, cls in (("gpipe", PipelineTrainStep),
                           ("1f1b", OneF1BTrainStep)):
            m = mesh.make_mesh(PP_MESHES[mname])
            if m.coords is None:
                continue
            model = _tiny_model(inp, "gpt")
            step = cls(model, tgpt.gpt_pretrain_loss,
                       _adamw(model, float(inp["pp_clip"])), num_micro=4)
            _cases(out, f"{sched}_{mname}_clip",
                   _trajectory(step, model, ids, ids, r=r))
    return out


def _mlp_regressor(pt, d_in=8, h=16, depth=4):
    """The non-GPT model of tests/test_pipeline_1f1b.py:103-153 (a linear
    embedding, a tanh trunk, a linear head), pipelined through its
    pipeline_parts()."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.pipeline import PipelineParts

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(h, h)

        def forward(self, x):
            return nn.functional.tanh(self.fc(x))

    class Fc(nn.Layer):
        def __init__(self, a, b):
            super().__init__()
            self.fc = nn.Linear(a, b)

        def forward(self, x):
            return self.fc(x)

    class Regressor(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = Fc(d_in, h)
            self.trunk = nn.LayerList([Block() for _ in range(depth)])
            self.head = Fc(h, 1)

        def pipeline_parts(self, loss_fn):
            head = self.head

            def head_call(post_p, pre_p, x, labels):
                out, _ = head.functional_call(post_p, {}, x)
                return loss_fn(out, labels)

            return PipelineParts(self.embed, list(self.trunk), self.head,
                                 head_call, tied=())

    return Regressor()


def job_pp_parts(inp, r, n):
    """The non-GPT PipelineParts model from the JAX weights through both
    schedules over {'pp': 2} and {'pp': 4}, SGD 0.05 on MSE, 8
    microbatches of 4, 3 steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.pipeline import PipelineTrainStep
    from paddle_tpu_torch.distributed.pipeline_1f1b import OneF1BTrainStep
    x, y = _t(inp["mlp_x"]), _t(inp["mlp_y"])
    out = {}
    for mname in ("pp2", "pp4"):
        for sched, cls in (("gpipe", PipelineTrainStep),
                           ("1f1b", OneF1BTrainStep)):
            m = mesh.make_mesh(PP_MESHES[mname])
            if m.coords is None:
                continue
            model = _mlp_regressor(pt)
            model.set_state_dict({k[4:]: v for k, v in inp.items()
                                  if k.startswith("mlp:")})
            step = cls(model, pt.nn.MSELoss(), pt.optimizer.SGD(
                learning_rate=0.05, parameters=model.parameters()),
                num_micro=8)
            _cases(out, f"{sched}_{mname}",
                   _trajectory(step, model, x, y, steps=3, r=r))
    return out


def job_pp_hapi(inp, r, n):
    """hapi.Model over fleet's pipeline step: the non-GPT parts model on
    {'dp': 2, 'pp': 2} (4 microbatches), SGD on MSE, 2 epochs of 2
    batches of 16, then `save` (each rank into its own directory): the
    losses, the saved parameters, the model's and its initial ones."""
    import os
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.framework import serialization
    s = fleet.DistributedStrategy()
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": 4}
    s.hybrid_configs = dict(s.hybrid_configs, dp_degree=2, pp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    model = _mlp_regressor(pt)
    model.set_state_dict({k[4:]: v for k, v in inp.items()
                          if k.startswith("mlp:")})
    m = pt.Model(model)
    m.prepare(fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.05, parameters=model.parameters()), s),
        pt.nn.MSELoss())
    ds = pt.io.TensorDataset([inp["mlp_x"], inp["mlp_y"]])
    losses = m.fit(ds, batch_size=16, epochs=2, shuffle=False,
                   verbose=0)["loss"]
    path = os.path.join(str(inp["ckpt_dir"]), f"rank{r}", "ckpt")
    m.save(path)
    saved = serialization.load(path + ".pdparams")
    return {"losses": losses, "step": type(m._train_step).__name__,
            "global_step": m._optimizer._global_step,
            **{f"saved:{k}": np.asarray(v.numpy() if hasattr(v, "numpy")
                                        else v) for k, v in saved.items()},
            **{f"model:{k}": p.numpy().copy()
               for k, p in model.named_parameters()}}


def job_pp_apply(inp, r, n):
    """pipeline_apply and pipeline_1f1b over {'pp': n}: a toy tanh block
    a stage."""
    import torch
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.distributed.pipeline import pipeline_apply
    mesh.make_mesh({"pp": n})
    w = _t(inp["ppa_w"])                       # [S, 1, h, h]

    def block(p, a, key):
        return torch.tanh(a @ p["w"])
    got = pipeline_apply(block, {"w": w}, _t(inp["ppa_x"]), n, remat=False)
    out = {"out": got.numpy()}
    # pipeline_1f1b on the JAX test's toy (tests/test_pipeline_1f1b.py:
    # 60-100): a tanh stage a rank, a linear head and MSE on the last;
    # against torch autograd of the serial composition on every rank
    from paddle_tpu_torch.distributed.pipeline_1f1b import pipeline_1f1b
    W, head = _t(inp["f1_w"]), _t(inp["f1_head"])
    x, lab = _t(inp["f1_x"]), _t(inp["f1_lab"])
    r = mesh.get_mesh().axis_index("pp")

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"])

    def last_loss_fn(p, post, a, labm):
        return ((stage_fn(p, a) @ post["w"] - labm) ** 2).mean()

    loss, gb, gpost, dx = pipeline_1f1b(stage_fn, last_loss_fn,
                                        {"w": W[r]}, {"w": head}, x, lab)
    Wr, hr, xr = (t.clone().requires_grad_(True) for t in (W, head, x))
    total = 0.0
    for m in range(x.shape[0]):
        h = xr[m]
        for s in range(n - 1):
            h = torch.tanh(h @ Wr[s])
        total = total + last_loss_fn({"w": Wr[n - 1]}, {"w": hr}, h, lab[m])
    ref = total / x.shape[0]
    ref.backward()
    out.update(f1_loss=[float(loss), float(ref)],
               f1_gw=[gb["w"].numpy(), Wr.grad[r].numpy()],
               f1_ghead=[gpost["w"].numpy(),
                         hr.grad.numpy() if r == n - 1
                         else np.zeros_like(hr.grad.numpy())],
               f1_dx=[dx.numpy(), xr.grad.numpy() if r == 0
                      else np.zeros_like(xr.grad.numpy())])
    return out


def job_pp_mnist(inp, r, n):
    """The twin of examples/pipeline_mnist.py: its MLP (a 784 -> 128
    stem, four 128 blocks, a 10-way head) from the JAX example's initial
    weights (paddle_tpu.seed(1)) on the port's synthetic MNIST through
    fleet's pipeline strategy (accumulate_steps 4) over {'dp': 2, 'pp':
    2}, Momentum 0.05, global batches of 64, 30 steps."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.pipeline import PipelineParts
    strategy = fleet.DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 4}
    strategy.hybrid_configs = {"dp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)

    class Stem(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(784, 128)

        def forward(self, x):
            return nn.functional.relu(self.fc(x.reshape([x.shape[0], -1])))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(128, 128)

        def forward(self, x):
            return nn.functional.relu(self.fc(x))

    class Head(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(128, 10)

        def forward(self, x):
            return self.fc(x)

    class PipelinedMLP(nn.Layer):
        def __init__(self, depth=4):
            super().__init__()
            self.stem = Stem()
            self.trunk = nn.LayerList([Block() for _ in range(depth)])
            self.head = Head()

        def forward(self, x):
            x = self.stem(x)
            for blk in self.trunk:
                x = blk(x)
            return self.head(x)

        def pipeline_parts(self, loss_fn):
            head = self.head

            def head_call(post_p, pre_p, h, labels):
                out, _ = head.functional_call(post_p, {}, h)
                return loss_fn(out, labels)

            return PipelineParts(self.stem, list(self.trunk), self.head,
                                 head_call, tied=())

    model = PipelinedMLP()
    model.set_state_dict({k[6:]: v for k, v in inp.items()
                          if k.startswith("mnist:")})
    opt = fleet.distributed_optimizer(
        pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=model.parameters()), strategy)
    step = fleet.build_train_step(model, nn.functional.cross_entropy, opt)
    np.random.seed(0)
    loader = pt.io.DataLoader(pt.vision.datasets.MNIST(mode="train"),
                              batch_size=64, shuffle=True, drop_last=True)
    losses, it = [], iter(loader)
    for _ in range(30):
        img, label = next(it)
        losses.append(float(step(img, label.reshape([-1]))))
    return {"losses": losses, "step": type(step).__name__,
            "mesh": json.dumps(step.mesh.shape)}

JOBS = {"collectives": job_collectives,
        "data_parallel": job_data_parallel,
        "sharded_linear": job_sharded_linear,
        "sharded_models": job_sharded_models, "hapi_zero1": job_hapi_zero1,
        "refusals": job_refusals, "zero3": job_zero3, "exact": job_exact,
        "attention": job_attention,
        "gpt_sp": job_gpt_sp, "fleet_meshes": job_fleet_meshes,
        "build_step": job_build_step, "dist_mnist": job_dist_mnist,
        "tp_layers": job_tp_layers, "tp_steps": job_tp_steps,
        "tp_dropout": job_tp_dropout, "tp_fused_head": job_tp_fused_head,
        "pp_steps": job_pp_steps,
        "pp_parts": job_pp_parts, "pp_apply": job_pp_apply,
        "pp_hapi": job_pp_hapi,
        "pp_mnist": job_pp_mnist}


def spawn_target(out):
    """`distributed.spawn`'s test body: join the world, all-reduce the
    rank and write it."""
    import torch
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    torch.set_num_threads(1)
    pt.set_device("cpu")
    dist.init_parallel_env(backend="gloo", timeout=60)
    x = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(x)
    with open(f"{out}.{dist.get_rank()}", "w") as f:
        json.dump({"rank": dist.get_rank(), "world": dist.get_world_size(),
                   "sum": float(x)}, f)
    dist.env.destroy()


def main(spec_path):
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    with open(spec_path) as f:
        spec = json.load(f)
    inp = dict(np.load(spec["inputs"], allow_pickle=False))
    pt.set_device("cpu")
    dist.init_parallel_env(backend="gloo", timeout=120)
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    for job in spec["jobs"]:
        for k, v in JOBS[job](inp, r, n).items():
            out[f"{job}/{k}"] = np.asarray(v)
        dist.barrier()
    np.savez(f"{spec['out']}.{r}.npz", **out)
    dist.env.destroy()


if __name__ == "__main__":
    main(sys.argv[1])
