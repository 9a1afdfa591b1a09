"""The port's distributed/ (paddle_tpu_torch.distributed) against numpy
and the JAX package (paddle_tpu.distributed).

The port's side runs in one world of 2 gloo ranks on the CPU, started
through the port's launcher (`tests/torch_dist_ranks.py`) while this
process computes the JAX side on its 8-device virtual mesh: every
collective against numpy; `DataParallel.apply_collective_grads` against
the global batch's gradient; `ShardedTrainStep` over {'dp': 2} against
the JAX one on `make_mesh({'dp': 2})` (a Linear under MSE at ZeRO 0 and
1, SGD and AdamW, and at ZeRO-1 the per-tensor-norm rules Lamb, Lars
and Dpsgd and AdamW under gradient merge: losses, weights and moments
after sync() within rtol 1e-5, as tests/test_distributed.py:86-105; a
tiny GPT and a tiny BERT, AdamW at ZeRO-1, 3 steps: losses within rtol
2e-4, as tests/test_distributed.py:261); `hapi.Model` fitting,
saving and resuming a ZeRO-1 run with an lr change, against the JAX
Model; ZeRO-3 on tests/test_zero3.py's MLP and the tiny GPT against the
JAX ZeRO-3 step (rtol 2e-4, atol 2e-5, that test's own) and bit for bit
against the port's ZeRO-1, each rank holding its chunks alone;
exact_reshard on a 3-sequence batch bit for bit at dp=1 and dp=2, both
against the JAX exact_reshard step and the port's plain TrainStep, and
a hapi run saved at dp=2 resumed at dp=1 bit for bit, a resume without
the strategy warning; ZeRO-3, exact_reshard, 'mp' and 'pp' meshes
accepted. In this process: the
launcher's cluster model and per-rank environment against the JAX
ones, `spawn`, and `init_parallel_env` refusing NCCL without a card.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.distributed.fleet as jfleet
import torch_dist_ranks as ranks
from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.distributed.mesh import make_mesh
from paddle_tpu.distributed.sharded import ShardedTrainStep as JSharded
from paddle_tpu.nlp import bert as jbert, gpt as jgpt
from paddle_tpu_torch import nn as tnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import launch as tlaunch

torch.set_num_threads(1)

N = 2
RNG = np.random.RandomState(0)
COLL_BASE = RNG.randn(3, 2).astype("f4")
COLL_ROWS = RNG.randn(2 * N, 3).astype("f4")
DP_X = RNG.randn(8, 8).astype("f4")
DP_Y = RNG.randn(8, 4).astype("f4")
LIN_X = RNG.randn(16, 8).astype("f4")
LIN_Y = RNG.randn(16, 4).astype("f4")
GPT_CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
               max_seq_len=128, dropout=0.0, attn_dropout=0.0)
GPT_IDS = RNG.randint(0, 256, (4, 128)).astype("int32")
BERT_CFG = dict(vocab_size=1000, hidden_size=128, num_layers=2,
                num_heads=2, intermediate_size=256, max_seq_len=128,
                dropout=0.0, attn_dropout=0.0)
BERT_IDS = RNG.randint(0, 1000, (4, 128)).astype("int32")
BERT_MLM = np.where(RNG.rand(4, 128) < 0.15,
                    RNG.randint(0, 1000, (4, 128)), -100).astype("int32")
BERT_NSP = RNG.randint(0, 2, (4,)).astype("int32")
# tests/test_zero3.py's batch (`_batch(seed=2)`)
_Z3 = np.random.RandomState(2)
Z3_X = _Z3.randn(32, 64).astype("f4")
Z3_Y = _Z3.randint(0, 8, 32).astype("int64")


class _ZeroMLP(pj.nn.Layer):
    """tests/test_zero3.py's MLP."""

    def __init__(self, d=64, h=128):
        super().__init__()
        self.fc1 = pj.nn.Linear(d, h)
        self.fc2 = pj.nn.Linear(h, h)
        self.fc3 = pj.nn.Linear(h, 8)

    def forward(self, x):
        x = pj.nn.functional.relu(self.fc1(x))
        x = pj.nn.functional.relu(self.fc2(x))
        return self.fc3(x)


@pytest.fixture(autouse=True)
def reset_mesh():
    yield
    import paddle_tpu.distributed.mesh as mesh_mod
    mesh_mod._current_mesh = None


@pytest.fixture(scope="module")
def jax_models():
    pj.seed(5)
    lin = pj.nn.Linear(8, 4)
    gm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    bm = jbert.BertForPretraining(jbert.BertConfig(**BERT_CFG))
    pj.seed(0)
    return lin, gm, bm, _ZeroMLP()


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_models):
    lin, gm, bm, mlp = jax_models
    inputs = {"coll_base": COLL_BASE, "coll_rows": COLL_ROWS,
              "dp_x": DP_X, "dp_y": DP_Y, "lin_x": LIN_X, "lin_y": LIN_Y,
              "lin_w": lin.weight.numpy(), "lin_b": lin.bias.numpy(),
              "gpt_cfg": np.array(json.dumps(GPT_CFG)), "gpt_ids": GPT_IDS,
              "bert_cfg": np.array(json.dumps(BERT_CFG)),
              "bert_ids": BERT_IDS, "bert_mlm": BERT_MLM,
              "bert_nsp": BERT_NSP, "z3_x": Z3_X, "z3_y": Z3_Y}
    inputs.update({f"gpt:{k}": np.asarray(v.numpy(), "f4")
                   for k, v in gm.state_dict().items()})
    inputs.update({f"bert:{k}": np.asarray(v.numpy(), "f4")
                   for k, v in bm.state_dict().items()})
    inputs.update({f"z3m:{k}": np.asarray(v.numpy(), "f4")
                   for k, v in mlp.state_dict().items()})
    tmp = tmp_path_factory.mktemp("dist")
    inputs["ckpt_dir"] = np.array(str(tmp / "ckpt"))
    return ranks.World(tmp, N, ("sharded_linear", "hapi_zero1",
                                "sharded_models", "zero3", "exact",
                                "collectives", "data_parallel", "refusals"),
                       inputs)


# the rank world runs while the first tests compute the JAX side: the
# slowest of them comes first
def test_sharded_gpt_and_bert_match_jax(world, jax_models):
    _, gm, bm, _ = jax_models
    make_mesh({"dp": N})
    step = JSharded(gm, jgpt.gpt_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=1e-3, parameters=gm.parameters()), zero_stage=1)
    gl = [float(step(GPT_IDS, GPT_IDS).numpy()) for _ in range(3)]
    step = JSharded(bm, jbert.bert_pretrain_loss, pj.optimizer.AdamW(
        learning_rate=1e-3, parameters=bm.parameters()), zero_stage=1)
    bl = [float(step(BERT_IDS, (BERT_MLM, BERT_NSP)).numpy())
          for _ in range(3)]
    for res in world.job("sharded_models"):
        np.testing.assert_allclose(res["gpt_losses"], gl, rtol=2e-4)
        np.testing.assert_allclose(res["bert_losses"], bl, rtol=2e-4)


@pytest.mark.parametrize("case,zero", ranks.LINEAR_CASES)
def test_sharded_linear_matches_jax(world, jax_models, case, zero):
    lin, _, _, _ = jax_models
    net = pj.nn.Linear(8, 4)
    net.set_state_dict({k: v.numpy() for k, v in lin.state_dict().items()})
    merge = case == "adamw_merge"
    cls, kw = ranks.LINEAR_OPTS["adamw" if merge else case]
    opt = getattr(pj.optimizer, cls)(parameters=net.parameters(), **kw)
    make_mesh({"dp": N})
    # the JAX ZeRO-1 step cannot place Dpsgd's scalar `noise_idx` slot
    # over 'dp'; its ZeRO-0 step makes the same update (sigma 0)
    step = JSharded(net, pj.nn.functional.mse_loss,
                    jfleet.distributed_optimizer(
                        opt, ranks.merge_strategy(jfleet, zero))
                    if merge else opt,
                    zero_stage=0 if case == "dpsgd" else zero)
    losses = [float(step(LIN_X, LIN_Y).numpy())
              for _ in range(4 if merge else 3)]
    step.sync()
    key = f"{case}_zero{zero}"
    st = opt._accumulators.get(id(net.weight), {})
    for res in world.job("sharded_linear"):
        np.testing.assert_allclose(res[key + "_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res[key + "_weight"], net.weight.numpy(),
                                   rtol=1e-5, atol=1e-7)
        # the JAX step counts calls, the port's updates (the JAX update
        # takes its count // k_steps)
        assert int(res[key + "_step"]) == opt._global_step // (
            2 if merge else 1)
        slots = [k[len(key) + 1:] for k in res
                 if k.startswith(key + "_") and k[len(key) + 1:] in st]
        assert len(slots) == len(opt._state_names) - (case == "dpsgd")
        for slot in slots:
            got, want = res[f"{key}_{slot}"], np.asarray(st[slot])
            if slot == "moment2" and case != "adamw":
                # squared grads, which agree within 1e-5: held at the
                # grads' scale through their roots
                got, want = np.sqrt(got), np.sqrt(want)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                       err_msg=slot)
    if case == "adamw":
        # ZeRO-1: each rank holds its chunk of every moment: the
        # weight's 32 and the bias's 4 elements halved and rounded up
        # to 16, two f32 moments each
        for res in world.job("sharded_linear"):
            have, full = res[key + "_moment_bytes"]
            assert (have, full) == ((16 + 16) * 8, (32 + 4) * 8)


def test_hapi_model_saves_and_resumes_a_zero1_run_as_jax(world, jax_models,
                                                         tmp_path):
    """Model.fit under ZeRO-1 on {'dp': 2}, set_lr between two epochs,
    save, load_latest into a new Model and a third epoch: the losses,
    the checkpoint's moments and step count and the final weight
    against the JAX Model's."""
    lin, _, _, _ = jax_models
    make_mesh({"dp": N})
    ds = pj.io.TensorDataset([LIN_X, LIN_Y])
    s = jfleet.DistributedStrategy()
    s.sharding = True
    s.sharding_configs = {"stage": 1}

    def model():
        net = pj.nn.Linear(8, 4)
        net.set_state_dict({k: v.numpy()
                            for k, v in lin.state_dict().items()})
        opt = pj.optimizer.AdamW(learning_rate=0.01,
                                 parameters=net.parameters())
        m = pj.Model(net)
        m.prepare(jfleet.distributed_optimizer(opt, s), pj.nn.MSELoss())
        return m, net, opt

    def fit(m):
        return m.fit(ds, batch_size=8, epochs=1, shuffle=False,
                     verbose=0)["loss"]

    m, _, opt = model()
    losses = fit(m)
    opt.set_lr(0.003)
    losses += fit(m)
    m.save(str(tmp_path / "ckpt"))
    m2, net2, opt2 = model()
    m2.load_latest(str(tmp_path))
    st = {k: np.asarray(v)
          for k, v in opt2._accumulators[id(net2.weight)].items()}
    step = opt2._global_step
    losses += fit(m2)
    for res in world.job("hapi_zero1"):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        assert int(res["step"]) == step == 4
        assert int(res["zero_stage"]) == 1
        np.testing.assert_allclose(res["moment1"], st["moment1"],
                                   rtol=1e-5, atol=1e-9)
        # squared grads: held at the grads' scale through their roots
        np.testing.assert_allclose(np.sqrt(res["moment2"]),
                                   np.sqrt(st["moment2"]), rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_allclose(res["weight"], net2.weight.numpy(),
                                   rtol=1e-5, atol=1e-7)


def _expected_collectives():
    xs = [COLL_BASE + r for r in range(N)]
    rows = [COLL_ROWS + 10 * r for r in range(N)]
    summed_rows = sum(rows)
    want = {
        "all_reduce_sum": [sum(xs)] * N,
        "all_reduce_max": [np.maximum(*xs)] * N,
        "all_reduce_min": [np.minimum(*xs)] * N,
        "all_reduce_prod": [xs[0] * xs[1]] * N,
        "all_reduce_avg": [sum(xs) / N] * N,
        "all_gather": [np.stack(xs)] * N,
        "reduce_scatter": [summed_rows[2 * r:2 * r + 2] for r in range(N)],
        "reduce_scatter_list": [summed_rows[2 * r:2 * r + 2]
                                for r in range(N)],
        "broadcast": [xs[1]] * N,
        "reduce": [sum(xs)] * N,
        "scatter": [COLL_BASE * (r + 1) for r in range(N)],
        "alltoall": [np.stack([COLL_BASE + 10 * j + r for j in range(N)])
                     for r in range(N)],
        "send_recv": [COLL_BASE * 0, COLL_BASE * 7],
        "new_group_all_reduce": [sum(xs)] * N,
    }
    return want


@pytest.mark.parametrize("name", sorted(_expected_collectives()))
def test_collective_against_numpy(world, name):
    got = world.job("collectives")
    for r, want in enumerate(_expected_collectives()[name]):
        np.testing.assert_allclose(got[r][name], want, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_collectives_in_place_on_tensors_and_host_store(world):
    for res in world.job("collectives"):
        assert res["all_reduce_tensor_in_place"].all()
        assert res["all_gather_list_filled"]
        assert res["wait_returns_its_tensor"]
        assert int(res["host_staged"]) == 0       # CPU tensors: no staging
        assert res["host_all_gather"].tolist() == [b"r0", b"r1"]
        np.testing.assert_array_equal(res["host_all_reduce"], [1, 3])


def test_data_parallel_grads_are_the_global_batch_gradient(world):
    old = pt.get_device()
    pt.set_device("cpu")
    try:
        pt.seed(3)
        net = tnn.Linear(8, 4)
        loss = tnn.functional.mse_loss(net(pt.to_tensor(DP_X)),
                                       pt.to_tensor(DP_Y))
        loss.backward()
    finally:
        pt.set_device(old)
    for res in world.job("data_parallel"):
        for name, p in net.named_parameters():
            np.testing.assert_allclose(res[name], p.grad.numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_sharded_step_refuses_zero3_mp_and_pp_naming_5b(world):
    """ZeRO-3 and exact_reshard (ROADMAP item 5b(ii)) are accepted, as a
    mesh with 'mp' or 'pp' is (tensor parallelism; a 'pp' axis without
    'dp' is the batch axis, as in the JAX step): each step is built and
    runs a step. Dpsgd's noise stays refused under ZeRO-1 and ZeRO-3;
    fp16_allreduce under ZeRO-3 warns and is ignored (the JAX step's
    rule)."""
    for res in world.job("refusals"):
        for name in ("zero3", "exact", "mp", "pp"):
            assert str(res[name]) == "accepted", (name, res[name])
        for stage in (1, 3):
            assert "same noise" in str(res[f"dpsgd_noise_zero{stage}"])
        (msg,) = res["fp16_zero3"]
        assert "incompatible with ZeRO-3" in str(msg)
        assert list(res["fp16_zero3_state"]) == [3, 0]


def _jax_zero3(model, opt, x, y, steps, loss_fn):
    make_mesh({"dp": N})
    step = JSharded(model, loss_fn, opt, zero_stage=3)
    losses = [float(step(x, y).numpy()) for _ in range(steps)]
    step.sync()
    return losses, {k: np.asarray(v.numpy())
                    for k, v in model.state_dict().items()}


def test_zero3_mlp_matches_jax_and_zero1(world, jax_models):
    """tests/test_zero3.py's MLP (Adam 1e-3, 5 steps) at ZeRO-3 over
    {'dp': 2}: the synced parameters within that test's rtol 2e-4 and
    atol 2e-5 of the JAX ZeRO-3 step's, and the losses, parameters and
    moments bit for bit the port's ZeRO-1 run's. Each rank holds its
    chunks and nothing more (ZeRO-1 holds the full model beside them);
    state_dict() before sync() raises, naming it."""
    mlp = _ZeroMLP()
    mlp.set_state_dict({k: v.numpy()
                        for k, v in jax_models[3].state_dict().items()})
    losses, params = _jax_zero3(
        mlp, pj.optimizer.Adam(learning_rate=1e-3,
                               parameters=mlp.parameters()),
        Z3_X, Z3_Y, 5, pj.nn.CrossEntropyLoss())
    for res in world.job("zero3"):
        np.testing.assert_allclose(res["mlp3_losses"], losses, rtol=2e-4)
        for k, v in params.items():
            np.testing.assert_allclose(res[f"mlp3_p:{k}"], v, rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        np.testing.assert_array_equal(res["mlp3_losses"], res["mlp1_losses"])
        keys = [k[5:] for k in res if k.startswith("mlp1_p:")
                or k.startswith("mlp1_m:")]
        assert len(keys) == 6 + 12
        for k in keys:
            np.testing.assert_array_equal(res["mlp3_" + k], res["mlp1_" + k],
                                          err_msg=k)
        have, chunks = res["mlp3_bytes"]
        assert have == chunks
        have1, chunks1 = res["mlp1_bytes"]
        full = sum(v.size * 4 for v in params.values())
        assert chunks1 == chunks and have1 == chunks + full
        assert chunks < full * 0.6
        assert "sync()" in str(res["mlp3_state_dict"])


def test_zero3_gpt_matches_jax_and_zero1(world, jax_models):
    """The tiny GPT (2 layers, AdamW 1e-3, 3 steps) at ZeRO-3 over
    {'dp': 2}, a block gathered at a time (3 units: the 2 blocks and the
    root; no layer keeps the step's gathering forward between calls),
    against the JAX ZeRO-3 step and bit for bit the port's ZeRO-1. The losses within rtol 2e-4 (tests/test_zero3.py's); the
    parameters within the JAX package's own tolerance for a GPT's
    parameters after AdamW steps (tests/test_pipeline.py:96-97: rtol
    and atol 2e-4): AdamW's first steps move a weight whose gradient is
    near 0 by up to lr on the gradient's rounding."""
    gm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    gm.set_state_dict({k: v.numpy()
                       for k, v in jax_models[1].state_dict().items()})
    losses, params = _jax_zero3(
        gm, pj.optimizer.AdamW(learning_rate=1e-3,
                               parameters=gm.parameters()),
        GPT_IDS, GPT_IDS, 3, jgpt.gpt_pretrain_loss)
    for res in world.job("zero3"):
        assert int(res["gpt3_units"]) == GPT_CFG["num_layers"] + 1
        # the gathering forwards live only inside a step's call
        assert list(res["gpt3_patched"]) == []
        np.testing.assert_allclose(res["gpt3_losses"], losses, rtol=2e-4)
        for k, v in params.items():
            np.testing.assert_allclose(res[f"gpt3_p:{k}"], v, rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(res["gpt3_losses"], res["gpt1_losses"])
        for k in params:
            np.testing.assert_array_equal(res[f"gpt3_p:{k}"],
                                          res[f"gpt1_p:{k}"], err_msg=k)


@pytest.mark.parametrize("stage", [1, 3])
def test_exact_reshard_is_bitwise_across_dp(world, stage):
    """exact_reshard (through fleet's sharding_configs) on 3 sequences,
    which 'dp' = 2 cannot divide: the losses, the global grad norms
    (AdamW under a global-norm clip), the synced parameters and moments
    of 3 steps are bit for bit equal over {'dp': 2} and {'dp': 1}."""
    res = world.job("exact")
    one, two = f"gpt{stage}_dp1", f"gpt{stage}_dp{N}"
    keys = [k[len(one) + 1:] for k in res[0] if k.startswith(one + "/")]
    assert len(keys) > 60
    for k in keys:
        for r in range(N):
            np.testing.assert_array_equal(res[r][f"{two}/{k}"],
                                          res[0][f"{one}/{k}"], err_msg=k)
    assert list(res[0][f"{one}/state"]) == [stage, 1]


def _jax_exact(src, stage, steps=3):
    """The JAX exact_reshard step over {'dp': 2} (AdamW 1e-3 under a
    global-norm clip of 1) on the 3-sequence batch: losses, grad norms,
    the synced parameters and, by parameter index, the moments."""
    gm = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
    gm.set_state_dict({k: v.numpy() for k, v in src.state_dict().items()})
    opt = pj.optimizer.AdamW(learning_rate=1e-3, parameters=gm.parameters(),
                             grad_clip=pj.nn.ClipGradByGlobalNorm(1.0))
    make_mesh({"dp": N})
    step = JSharded(gm, jgpt.gpt_pretrain_loss, opt, zero_stage=stage,
                    exact_reshard=True)
    ids = GPT_IDS[:3]
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(step(ids, ids).numpy()))
        norms.append(step.last_grad_norm())
    step.sync()
    params = {k: np.asarray(v.numpy()) for k, v in gm.state_dict().items()}
    moments = {f"m:{i}:{slot}": np.asarray(v)
               for i, p in enumerate(gm.parameters())
               for slot, v in opt._accumulators.get(id(p), {}).items()}
    return losses, norms, params, moments


@pytest.mark.parametrize("stage", [1, 3])
def test_exact_reshard_matches_jax_and_the_plain_step(world, jax_models,
                                                      stage):
    """The exact_reshard trajectories at dp=1 and dp=2 (3 steps on 3
    sequences, AdamW under a global-norm clip) against the JAX
    exact_reshard step at the same stage over {'dp': 2}: losses and grad
    norms within rtol 2e-4, the first moments within rtol 2e-4 and atol
    2e-5 (tests/test_zero3.py's), the second moments (squared grads)
    through their roots at the same tolerance, the synced parameters
    within the JAX package's own tolerance for a GPT's parameters after
    AdamW steps (tests/test_pipeline.py:96-97: rtol and atol 2e-4; a
    weight whose gradient is near 0 moves by up to lr on its rounding,
    as in `test_zero3_gpt_matches_jax_and_zero1`); and against the port's plain TrainStep on the whole batch within
    rtol 1e-6, atol 1e-9: the same math, its sums taken in another
    order."""
    losses, norms, params, moments = _jax_exact(jax_models[1], stage)
    res = world.job("exact")
    plain = {k[len("gpt_plain/"):]: v for k, v in res[0].items()
             if k.startswith("gpt_plain/")}
    assert list(plain["state"]) == [-1, 0]
    assert len(moments) == 2 * len(params)
    for r in range(N):
        for case in (f"gpt{stage}_dp1", f"gpt{stage}_dp{N}"):
            if case.endswith("dp1") and r:
                continue
            got = {k[len(case) + 1:]: v for k, v in res[r].items()
                   if k.startswith(case + "/")}
            np.testing.assert_allclose(got["losses"], losses, rtol=2e-4)
            np.testing.assert_allclose(got["norms"], norms, rtol=2e-4)
            for k, v in params.items():
                np.testing.assert_allclose(got[f"p:{k}"], v, rtol=2e-4,
                                           atol=2e-4, err_msg=(case, k))
            for k, v in moments.items():
                g = got[k]
                if k.endswith("moment2"):
                    g, v = np.sqrt(g), np.sqrt(v)
                np.testing.assert_allclose(g, v, rtol=2e-4, atol=2e-5,
                                           err_msg=(case, k))
            for k, v in plain.items():
                if k != "state":
                    np.testing.assert_allclose(got[k], v, rtol=1e-6,
                                               atol=1e-9, err_msg=(case, k))


def test_exact_reshard_resumes_across_dp_through_hapi(world):
    """hapi.Model under fleet's sharding stage 3 with exact_reshard: an
    epoch of 3-row batches on {'dp': 2}, saved, then resumed on {'dp':
    1} for a second epoch, runs bit for bit as the uninterrupted run on
    {'dp': 1}: the losses of both epochs and the final parameters."""
    res = world.job("exact")
    plain = list(res[0]["hapi_plain"])
    assert len(plain) == 8
    for r in range(N):
        np.testing.assert_array_equal(res[r]["hapi_first"], plain[:4])
    np.testing.assert_array_equal(res[0]["hapi_resumed"], plain[4:])
    keys = [k.split(":", 1)[1] for k in res[0]
            if k.startswith("hapi_plain_p:")]
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_array_equal(res[0][f"hapi_resumed_p:{k}"],
                                      res[0][f"hapi_plain_p:{k}"], err_msg=k)


def test_resume_without_the_sharding_strategy_warns(world):
    """Resuming that checkpoint with a plain optimizer (no sharded step)
    warns with the JAX package's message."""
    (msg,) = world.job("exact")[0]["drift"]
    assert "resume dropped the checkpoint's sharding configuration" in \
        str(msg) and "step: checkpoint=" in str(msg)


@pytest.mark.parametrize("nproc,ips,nnodes", [(2, "127.0.0.1", None),
                                              (2, "127.0.0.1", 2),
                                              (1, "10.0.0.1,10.0.0.2",
                                               None)])
def test_cluster_and_rank_env_match_jax(nproc, ips, nnodes):
    jp = jlaunch.get_cluster(nproc, 40000, ips, nnodes=nnodes)
    tp = tlaunch.get_cluster(nproc, 40000, ips, nnodes=nnodes)
    assert tp.coordinator == jp.coordinator
    assert [(t.rank, t.endpoint, t.devices) for t in tp.trainers] == \
        [(t.rank, t.endpoint, t.devices) for t in jp.trainers]
    total = len(jp.trainers)
    for jt, tt in zip(jp.trainers, tp.trainers):
        je = jlaunch._rank_env(jp, jt, total, [])
        te = tlaunch._rank_env(tp, tt, total, [])
        assert {k: te[k] for k in je} == je
        assert te["FLAGS_selected_gpus"] == str(tt.devices[0])
        assert te["PADDLE_LOCAL_SIZE"] == str(nproc)


def test_spawn_runs_a_world_of_two(tmp_path):
    out = str(tmp_path / "spawn")
    tdist.spawn(ranks.spawn_target, args=(out,), nprocs=2)
    got = [json.load(open(f"{out}.{r}")) for r in range(2)]
    assert got == [{"rank": r, "world": 2, "sum": 1.0} for r in range(2)]


def test_init_parallel_env_needs_a_card_unless_gloo_is_asked(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tdist.init_parallel_env()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 ranks on this host"):
        tdist.init_parallel_env(backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        tdist.init_parallel_env(backend="mpi")
    assert not tdist.is_initialized()
    assert not torch.distributed.is_initialized()


def test_launch_refuses_the_parameter_server_mode():
    with pytest.raises(NotImplementedError, match="5c"):
        tlaunch.main(["--server_num", "1", "x.py"])
